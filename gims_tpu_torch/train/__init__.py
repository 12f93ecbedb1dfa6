"""Training pieces of the port: so far the homography synthesis
(``data.py``) and ground-truth correspondence (``gt.py``) that the
evaluation shares with training."""
