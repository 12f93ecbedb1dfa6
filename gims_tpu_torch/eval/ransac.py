"""Homography estimation by RANSAC, in torch on the caller's device.

The port's counterpart of ``cv2.findHomography(src, dst, cv2.RANSAC,
ransacReprojThreshold, maxIters=..., confidence=...)``, following
OpenCV's algorithm step by step:

1. hypotheses from 4 distinct correspondences, drawn from a seeded
   ``torch.Generator`` (OpenCV draws from its own fixed-seed RNG, so the
   samples differ; no bit equality with OpenCV's random stream is sought);
2. samples rejected as OpenCV's ``checkSubset`` rejects them: the fourth
   point collinear with two of the others (in either image), or the four
   points' orientations inconsistent between the images;
3. each hypothesis from the normalized DLT (the eigenvector of the
   smallest eigenvalue of LᵀL, float64), scored as a batch: a
   correspondence is an inlier where its squared forward reprojection
   error, in float32, is at most thresh²;
4. the hypotheses taken in order, each with more inliers than the best so
   far (and at least 4) becoming the best and lowering the iteration bound
   to log(1 - confidence) / log(1 - w⁴), w the inlier share, until the
   bound is reached;
5. the refinement: the normalized DLT on all inliers of the best
   hypothesis, then 10 Levenberg-Marquardt iterations on the forward
   reprojection error (OpenCV's solver, float64, on the 8 entries of H
   other than H[2, 2] = 1);
6. the inlier mask recomputed with the refined H over every
   correspondence, as OpenCV 4.5 and later do.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gims_tpu_torch.core.device import resolve_device

_FLT_EPSILON = float(np.finfo(np.float32).eps)
_DBL_EPSILON = float(np.finfo(np.float64).eps)
_DBL_MIN = float(np.finfo(np.float64).tiny)
MODEL_POINTS = 4
CHUNK = 1024  # hypotheses drawn and scored per batch
MAX_ATTEMPTS = 10000  # draws per hypothesis before giving up, as OpenCV
LM_ITERS = 10
SEED = 0  # of the generator the hypotheses are drawn from, one per call


def update_num_iters(p, ep, model_points, max_iters):
    """OpenCV's RANSACUpdateNumIters."""
    p = min(max(p, 0.0), 1.0)
    ep = min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, _DBL_MIN)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < _DBL_MIN:
        return 0
    num, denom = math.log(num), math.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(round(num / denom))


def draw_samples(n, count, gen, dev, size=MODEL_POINTS):
    """(count, size) indices, distinct within each row: the k-th draw is
    uniform over the n - k indices not drawn yet."""
    idx = torch.empty((count, size), dtype=torch.int64, device=dev)
    for k in range(size):
        x = torch.randint(0, n - k, (count,), generator=gen, device=dev)
        if k:
            # step past each index drawn before, in increasing order
            for p in torch.sort(idx[:, :k], dim=1).values.unbind(1):
                x = x + (x >= p).to(torch.int64)
        idx[:, k] = x
    return idx


def _collinear(p):
    """OpenCV's haveCollinearPoints for the last of 4 points: (B,) bool."""
    d = p[:, :3] - p[:, 3:4]  # (B, 3, 2): each earlier point from the last
    out = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    for j, k in ((1, 0), (2, 0), (2, 1)):
        dx1, dy1 = d[:, j, 0], d[:, j, 1]
        dx2, dy2 = d[:, k, 0], d[:, k, 1]
        cross = (dx2 * dy1 - dy2 * dx1).abs()
        out |= cross <= _FLT_EPSILON * (dx1.abs() + dy1.abs() + dx2.abs() + dy2.abs())
    return out


def _det3(p, t):
    a, b, c = p[:, t[0]], p[:, t[1]], p[:, t[2]]
    return ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
            - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))


def _good_subsets(s1, s2):
    """OpenCV's checkSubset for homographies on (B, 4, 2) float64 samples."""
    ok = ~(_collinear(s1) | _collinear(s2))
    negative = torch.zeros(s1.shape[0], dtype=torch.int64, device=s1.device)
    for t in ((0, 1, 2), (1, 2, 3), (0, 2, 3), (0, 1, 3)):
        negative += (_det3(s1, t) * _det3(s2, t) < 0).to(torch.int64)
    return ok & ((negative == 0) | (negative == 4))


def _dlt(src, dst, weights=None):
    """OpenCV's homography kernel on (B, K, 2) float64 correspondences
    (`weights`, (B, K) of 0/1, selects the ones to use): the normalized
    DLT, H scaled to H[2, 2] = 1. Returns (H (B, 3, 3), ok (B,))."""
    if weights is None:
        weights = torch.ones(src.shape[:2], dtype=src.dtype, device=src.device)
    cnt = weights.sum(1, keepdim=True)  # (B, 1)
    w = weights[..., None]
    cM = (src * w).sum(1) / cnt
    cm = (dst * w).sum(1) / cnt
    sM = ((src - cM[:, None]).abs() * w).sum(1)
    sm = ((dst - cm[:, None]).abs() * w).sum(1)
    ok = (sM.abs() >= _DBL_EPSILON).all(1) & (sm.abs() >= _DBL_EPSILON).all(1)
    sM = cnt / torch.where(ok[:, None], sM, 1.0)
    sm = cnt / torch.where(ok[:, None], sm, 1.0)
    X, Y = ((src - cM[:, None]) * sM[:, None]).unbind(-1)
    x, y = ((dst - cm[:, None]) * sm[:, None]).unbind(-1)
    one, zero = torch.ones_like(X), torch.zeros_like(X)
    Lx = torch.stack([X, Y, one, zero, zero, zero, -x * X, -x * Y, -x], -1) * w
    Ly = torch.stack([zero, zero, zero, X, Y, one, -y * X, -y * Y, -y], -1) * w
    LtL = Lx.transpose(1, 2) @ Lx + Ly.transpose(1, 2) @ Ly
    h0 = torch.linalg.eigh(LtL)[1][..., 0].reshape(-1, 3, 3)  # the smallest eigenvalue's
    b = src.shape[0]
    inv_hnorm = torch.zeros((b, 3, 3), dtype=src.dtype, device=src.device)
    inv_hnorm[:, 0, 0], inv_hnorm[:, 0, 2] = 1 / sm[:, 0], cm[:, 0]
    inv_hnorm[:, 1, 1], inv_hnorm[:, 1, 2] = 1 / sm[:, 1], cm[:, 1]
    inv_hnorm[:, 2, 2] = 1
    hnorm2 = torch.zeros_like(inv_hnorm)
    hnorm2[:, 0, 0], hnorm2[:, 0, 2] = sM[:, 0], -cM[:, 0] * sM[:, 0]
    hnorm2[:, 1, 1], hnorm2[:, 1, 2] = sM[:, 1], -cM[:, 1] * sM[:, 1]
    hnorm2[:, 2, 2] = 1
    H = inv_hnorm @ h0 @ hnorm2
    H = H / H[:, 2:3, 2:3]
    return H, ok & torch.isfinite(H).flatten(1).all(1)


def _reproj_err(H, src, dst):
    """OpenCV's computeError in float32: (B, N) squared forward errors."""
    h = H.to(torch.float32).flatten(1)[:, :, None]  # (B, 9, 1)
    x, y = src[None, :, 0], src[None, :, 1]
    ww = 1.0 / (h[:, 6] * x + h[:, 7] * y + 1.0)
    dx = (h[:, 0] * x + h[:, 1] * y + h[:, 2]) * ww - dst[None, :, 0]
    dy = (h[:, 3] * x + h[:, 4] * y + h[:, 5]) * ww - dst[None, :, 1]
    return dx * dx + dy * dy


def _refine_residuals(h, src, dst, jacobian=True):
    """OpenCV's HomographyRefineCallback: residuals (2K,) and Jacobian
    (2K, 8) of the forward error in the 8 free entries of H (float64)."""
    X, Y = src[:, 0], src[:, 1]
    ww = h[6] * X + h[7] * Y + 1.0
    ww = torch.where(ww.abs() > _DBL_EPSILON, 1.0 / ww, torch.zeros_like(ww))
    xi = (h[0] * X + h[1] * Y + h[2]) * ww
    yi = (h[3] * X + h[4] * Y + h[5]) * ww
    err = torch.stack([xi - dst[:, 0], yi - dst[:, 1]], 1).reshape(-1)
    if not jacobian:
        return err, None
    z = torch.zeros_like(X)
    jx = torch.stack([X * ww, Y * ww, ww, z, z, z, -X * ww * xi, -Y * ww * xi], 1)
    jy = torch.stack([z, z, z, X * ww, Y * ww, ww, -X * ww * yi, -Y * ww * yi], 1)
    return err, torch.stack([jx, jy], 1).reshape(-1, 8)


def _eig_solve(A, b):
    """cv::solve(A, b, DECOMP_EIG) for a symmetric A: eigenvalues not above
    2 DBL_EPSILON times the largest count as 0."""
    w, V = torch.linalg.eigh(A)
    inv = torch.where(w > 2 * _DBL_EPSILON * w.abs().max(), 1.0 / w, torch.zeros_like(w))
    return V @ (inv * (V.T @ b))


def _levenberg_marquardt(x, src, dst, max_iters=LM_ITERS, eps=_FLT_EPSILON):
    """OpenCV's LMSolver (calib3d) on the 8 free entries of H."""
    r, J = _refine_residuals(x, src, dst)
    S = float(r @ r)
    A, v = J.T @ J, J.T @ r
    D = A.diagonal().clone()
    r_lo, r_hi = 0.25, 0.75
    lam, lc = 1.0, 0.75
    it = 0
    while True:
        d = _eig_solve(A + torch.diag(lam * D), v)
        xd = x - d
        rd, _ = _refine_residuals(xd, src, dst, jacobian=False)
        Sd = float(rd @ rd)
        dS = float(d @ (2 * v - A @ d))
        R = (S - Sd) / (dS if abs(dS) > _DBL_EPSILON else 1.0)
        if R > r_hi:
            lam *= 0.5
            if lam < lc:
                lam = 0.0
        elif R < r_lo:
            t = float(d @ v)
            nu = (Sd - S) / (t if abs(t) > _DBL_EPSILON else 1.0) + 2
            nu = min(max(nu, 2.0), 10.0)
            if lam == 0:
                w, V = torch.linalg.eigh(A)
                inv = torch.where(w > 2 * _DBL_EPSILON * w.abs().max(), 1.0 / w,
                                  torch.zeros_like(w))
                lam = lc = 1.0 / float(((V * inv) @ V.T).diagonal().abs().max())
                nu *= 0.5
            lam *= nu
        if Sd < S:
            S, x = Sd, xd
            r, J = _refine_residuals(x, src, dst)
            A, v = J.T @ J, J.T @ r
        it += 1
        if not (it < max_iters and float(d.abs().max()) >= eps
                and float(r.abs().max()) >= eps):
            return x


def find_homography(src, dst, thresh: float = 3.0, max_iters: int = 3000,
                    confidence: float = 0.995, device: Optional[str] = None):
    """RANSAC homography from (N, 2) `src` to (N, 2) `dst` correspondences.

    Returns (H, mask): H (3, 3) float64 with H[2, 2] = 1 and mask (N, 1)
    uint8, the inliers of the refined H, as ``cv2.findHomography``
    returns them; or None where OpenCV returns no matrix (fewer than 4
    correspondences, no non-degenerate sample, no hypothesis with 4
    inliers). Runs on `device` (``cuda`` unless the caller names another).
    """
    dev = resolve_device(device)
    f32 = [torch.as_tensor(np.asarray(p, np.float32).reshape(-1, 2), device=dev)
           for p in (src, dst)]
    n = f32[0].shape[0]
    if n != f32[1].shape[0]:
        raise ValueError(f"find_homography: {n} source and {f32[1].shape[0]} destination points")
    if n < MODEL_POINTS:
        return None
    s64, d64 = (p.to(torch.float64) for p in f32)
    if n == MODEL_POINTS:
        H, ok = _dlt(s64[None], d64[None])
        if not bool(ok[0]):
            return None
        return H[0].cpu().numpy(), np.ones((n, 1), np.uint8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    thresh2 = thresh * thresh
    niters, it, max_good, best = max(max_iters, 1), 0, 0, None
    while it < niters:
        want = min(CHUNK, niters - it)
        # draw until `want` non-degenerate samples (or OpenCV's attempt limit)
        # (OpenCV gives up on an iteration after MAX_ATTEMPTS draws)
        samples, found, attempts = [], 0, 0
        while found < want and (found or attempts < MAX_ATTEMPTS) \
                and attempts < want * MAX_ATTEMPTS:
            idx = draw_samples(n, want, gen, dev)
            attempts += want
            idx = idx[_good_subsets(s64[idx], d64[idx])]
            samples.append(idx)
            found += len(idx)
        idx = torch.cat(samples)[:want]
        if len(idx) == 0:
            if it == 0:
                return None
            break
        H, ok = _dlt(s64[idx], d64[idx])
        err = _reproj_err(H, *f32)
        counts = torch.where(ok, (err <= thresh2).sum(1), -1).cpu().tolist()
        for i, c in enumerate(counts):
            if it >= niters:
                break
            it += 1
            if c > max(max_good, MODEL_POINTS - 1):
                max_good, best = c, H[i]
                niters = update_num_iters(confidence, (n - c) / n, MODEL_POINTS, niters)
        if len(idx) < want:  # the attempt limit was reached
            break
    if best is None:
        return None
    # the refinement on the best hypothesis' inliers: DLT, then
    # Levenberg-Marquardt; then the inliers of the refined H
    inl = _reproj_err(best[None], *f32)[0] <= thresh2
    H, ok = _dlt(s64[None], d64[None], inl.to(torch.float64)[None])
    H = H[0] if bool(ok[0]) else best
    keep = torch.nonzero(inl)[:, 0]
    x = _levenberg_marquardt(H.flatten()[:8].clone(), s64[keep], d64[keep])
    H = torch.cat([x, x.new_ones(1)]).reshape(3, 3)
    mask = (_reproj_err(H[None], *f32)[0] <= thresh2).to(torch.uint8)
    return H.cpu().numpy(), mask.cpu().numpy()[:, None]
