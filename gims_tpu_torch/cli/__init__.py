"""Command-line entry points of the port (``python -m gims_tpu_torch.cli.<name>``)."""
