"""Homography by USAC's default pipeline, in torch on the caller's device.

The port's counterpart of ``cv2.findHomography(src, dst, cv2.USAC_DEFAULT)``
with OpenCV's defaults (threshold 3 px, ``maxIters`` 2000, confidence
0.995), which the JAX package counts inliers with
(``gims_tpu/eval/matches.py:114``, ``gims_tpu/tools/parameter_search.py:42``).
OpenCV documents USAC_DEFAULT as LO-RANSAC; its steps here, each on the
4-point normalized DLT, the float32 forward reprojection error and the
Levenberg-Marquardt of ``eval/ransac.py``:

1. uniform samples of 4 distinct correspondences, drawn from a seeded CPU
   ``torch.Generator`` and moved to the device, so that the card and the
   CPU evaluate the same hypotheses; degenerate samples are rejected as
   ``eval/ransac.py`` rejects them;
2. MSAC scoring: the sum over correspondences of min(e², thr²), e the
   forward reprojection error (lower is better); inliers have e² <= thr²;
3. each hypothesis that scores better than the best so far is kept and
   improved by the inner local optimisation: ``LO_ITERS`` least-squares
   fits (normalized DLT) on ``LO_SAMPLE`` of its inliers drawn at random,
   then ``LO_ITERATIVE`` fits on all inliers of the best model so far, each
   kept where it scores better;
4. the iteration bound log(1 - confidence) / log(1 - w⁴) from the best
   model's inlier share w, never above ``max_iters``;
5. the polish: the Levenberg-Marquardt on the best model's inliers, kept
   where it scores better, up to ``POLISH_ITERS`` times on the new
   inliers; the mask is the final model's inliers over every
   correspondence.

Measured against cv2 (``tests/test_torch_usac.py``): the same mask on
synthetic sets of 500 matches with 40% outliers and 0.5 px noise (a point
3.001 px off the true model is an inlier of both final models; one 3.01 px
off is an inlier of this one only: OpenCV's final fit leans less on points
near the threshold); counts within max(3, 2%) of cv2's on the matcher's
output, where OpenCV's own random samples pick other hypotheses.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.eval.ransac import (MODEL_POINTS, _dlt, _good_subsets, draw_samples,
                                        _levenberg_marquardt, _reproj_err, update_num_iters)

CHUNK = 256  # hypotheses drawn and scored per batch
MAX_ATTEMPTS = 10000  # draws per hypothesis before giving up
LO_SAMPLE = 24  # correspondences per least-squares fit of the inner optimisation
LO_ITERS = 10  # its random least-squares fits
LO_ITERATIVE = 1  # its fits on all inliers
POLISH_ITERS = 2  # Levenberg-Marquardt rounds of the polish
SEED = 0


def _scores(H, src, dst, thresh2):
    """(MSAC scores (B,) float64 on the host, inlier masks (B, N) on the
    device) of hypotheses H (B, 3, 3)."""
    err = _reproj_err(H, src, dst)
    msac = torch.clamp(err, max=thresh2).to(torch.float64).sum(1)
    return msac, err <= thresh2


def _fit(s64, d64, weights):
    """Normalized DLT on the weighted correspondences: (H, ok) batched."""
    return _dlt(s64.expand(weights.shape[0], -1, -1), d64.expand(weights.shape[0], -1, -1),
                weights)


class _Best:
    def __init__(self):
        self.H, self.score, self.inliers, self.count = None, float("inf"), None, 0

    def offer(self, H, score, inliers):
        if score < self.score:
            self.H, self.score, self.inliers = H, score, inliers
            self.count = int(inliers.sum())
            return True
        return False


def _local_optimisation(best, src, dst, s64, d64, thresh2, gen):
    """Inner LO of the best model: random least-squares fits on subsets of
    its inliers, then fits on all of them, each kept where it scores
    better."""
    inl = torch.nonzero(best.inliers)[:, 0]
    if len(inl) > LO_SAMPLE:
        keys = torch.rand((LO_ITERS, len(inl)), generator=gen).to(inl.device)
        pick = inl[torch.argsort(keys, dim=1)[:, :LO_SAMPLE]]
        w = torch.zeros((LO_ITERS, s64.shape[0]), dtype=torch.float64, device=s64.device)
        w.scatter_(1, pick, 1.0)
        H, ok = _fit(s64[None], d64[None], w)
        msac, inliers = _scores(H, src, dst, thresh2)
        for i, sc in enumerate(torch.where(ok, msac, float("inf")).cpu().tolist()):
            best.offer(H[i], sc, inliers[i])
    for _ in range(LO_ITERATIVE):
        H, ok = _fit(s64[None], d64[None], best.inliers.to(torch.float64)[None])
        if not bool(ok[0]):
            return
        msac, inliers = _scores(H, src, dst, thresh2)
        if not best.offer(H[0], float(msac[0]), inliers[0]):
            return


def find_homography_usac(src, dst, thresh: float = 3.0, max_iters: int = 2000,
                         confidence: float = 0.995, device: Optional[str] = None,
                         seed: int = SEED):
    """USAC_DEFAULT homography from (N, 2) `src` to (N, 2) `dst`.

    Returns (H, mask): H (3, 3) float64 with H[2, 2] = 1 and mask (N, 1)
    uint8, as ``cv2.findHomography`` returns them; or None where OpenCV
    raises or returns no matrix (fewer than 4 correspondences, no
    non-degenerate sample). Runs on `device` (``cuda`` unless the caller
    names another); the samples come from a CPU generator seeded `seed`.
    """
    dev = resolve_device(device)
    src32, dst32 = (torch.as_tensor(np.asarray(p, np.float32).reshape(-1, 2), device=dev)
                    for p in (src, dst))
    n = src32.shape[0]
    if n != dst32.shape[0]:
        raise ValueError(f"find_homography_usac: {n} source and {dst32.shape[0]} "
                         "destination points")
    if n < MODEL_POINTS:
        return None
    s64, d64 = src32.to(torch.float64), dst32.to(torch.float64)
    if n == MODEL_POINTS:
        H, ok = _dlt(s64[None], d64[None])
        return (H[0].cpu().numpy(), np.ones((n, 1), np.uint8)) if bool(ok[0]) else None
    gen = torch.Generator()
    gen.manual_seed(seed)
    thresh2 = float(thresh) * float(thresh)
    best = _Best()
    niters, it = max(int(max_iters), 1), 0
    while it < niters:
        want = min(CHUNK, niters - it)
        samples, found, attempts = [], 0, 0
        while found < want and attempts < want * MAX_ATTEMPTS:
            idx = draw_samples(n, want, gen, "cpu").to(dev)
            attempts += want
            idx = idx[_good_subsets(s64[idx], d64[idx])]
            samples.append(idx)
            found += len(idx)
        idx = torch.cat(samples)[:want]
        if len(idx) == 0:
            break
        H, ok = _dlt(s64[idx], d64[idx])
        msac, inliers = _scores(H, src32, dst32, thresh2)
        for i, sc in enumerate(torch.where(ok, msac, float("inf")).cpu().tolist()):
            if it >= niters:
                break
            it += 1
            if best.offer(H[i], sc, inliers[i]):
                _local_optimisation(best, src32, dst32, s64, d64, thresh2, gen)
                niters = min(niters, update_num_iters(confidence, (n - best.count) / n,
                                                      MODEL_POINTS, max_iters))
        if len(idx) < want:
            break
    if best.H is None or best.count < MODEL_POINTS:
        return None
    # the polish: Levenberg-Marquardt on the best model's inliers, repeated
    # on the new inliers while the score improves
    for _ in range(POLISH_ITERS):
        keep = torch.nonzero(best.inliers)[:, 0]
        x = _levenberg_marquardt(best.H.flatten()[:8].clone(), s64[keep], d64[keep])
        H = torch.cat([x, x.new_ones(1)]).reshape(3, 3)
        msac, inliers = _scores(H[None], src32, dst32, thresh2)
        if not best.offer(H, float(msac[0]), inliers[0]):
            break
    return best.H.cpu().numpy(), best.inliers.to(torch.uint8).cpu().numpy()[:, None]
