"""Training: the fused end-to-end trainer (``loop.py``, ``fused_step.py``),
the optimizer, EMA and train step (``step.py``), the pair datasets and
homography synthesis (``data.py``) and ground-truth correspondence
(``gt.py``, shared with the evaluation)."""
