"""Descriptor engine: CAR-HyNet over batches of 32x32 patches.

Port of ``gims_tpu/carhynet/engine.py`` (reference: carhynet/models.py:
639-671, HyNetnetFeature2D, chunks of 512 patches under no_grad). A patch
set is padded to a bucket of PATCH_BUCKETS and run as one batch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gims_tpu_torch.carhynet.convert import load_variables as load_into
from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.core.bucketing import bucket_size
from gims_tpu_torch.core.checkpoint import unflatten_npz
from gims_tpu_torch.core.device import resolve_device

PATCH_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 24576, 32768)


class DescriptorEngine:
    """128-d CAR-HyNet descriptors of (N, 32, 32, C) patches in [0, 1].

    `variables` is a flax CAR-HyNet variables tree of numpy arrays (as
    ``load_variables`` returns); without it and without `weights_path` the
    network is randomly initialized from `seed`. Runs in f32 on `device`:
    ``cuda`` unless the caller passes another."""

    def __init__(self, variables=None, weights_path: Optional[str] = None,
                 dim_desc: int = 128, seed: int = 0, in_channels: int = 3,
                 device=None):
        self.dim_desc = dim_desc
        self.in_channels = in_channels
        self.device = resolve_device(device)
        if variables is None and weights_path is not None:
            variables = load_variables(weights_path, dim_desc)
        self.variables = variables
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = CARHyNet(dim_desc=dim_desc, in_channels=in_channels)
        if variables is not None:
            load_into(model, variables)
        self.model = model.to(self.device).eval()
        if self.device.type == "cuda":  # NHWC convolutions, as the fused path
            self.model = self.model.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def compute_device(self, patches: torch.Tensor) -> torch.Tensor:
        """Patches on the device, (Nb, 32, 32, C) or flat (Nb, 32*32*C)
        channels last, in [0, 1] -> (Nb, 128); padded rows give descriptors
        that downstream masks ignore."""
        x = patches.reshape(-1, 32, 32, self.in_channels).permute(0, 3, 1, 2).float()
        return self.model(x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x)

    def compute(self, patches: np.ndarray) -> np.ndarray:
        """patches (N, 32, 32, C) float32 in [0, 1] -> (N, 128) float32."""
        n = patches.shape[0]
        if n == 0:
            return np.zeros((0, self.dim_desc), np.float32)
        padded = np.zeros((bucket_size(n, PATCH_BUCKETS), 32, 32, self.in_channels),
                          np.float32)
        padded[:n] = patches
        out = self.compute_device(torch.from_numpy(padded).to(self.device))
        return out[:n].cpu().numpy()

    def compute_sift(self, patches, kps, color=True):
        """Reference-compatible surface (carhynet/models.py:667-670)."""
        if len(kps) == 0:
            return kps, []
        return kps, self.compute(np.asarray(patches, np.float32))


def load_variables(weights_path: str, dim_desc: int = 128):
    """CAR-HyNet variables (a flax tree of numpy arrays) from the reference's
    torch state_dict (``.pth``/``.pt``, through ``convert_carhynet_torch``)
    or a ``.npz`` of the JAX package."""
    if weights_path.endswith((".pth", ".pt")):
        from gims_tpu_torch.carhynet.convert import convert_carhynet_torch

        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        return convert_carhynet_torch(sd)
    if weights_path.endswith(".npz"):
        return unflatten_npz(weights_path)
    raise ValueError(f"unsupported weights format: {weights_path}")
