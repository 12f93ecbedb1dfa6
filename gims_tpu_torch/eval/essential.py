"""The essential matrix by RANSAC, and the relative pose it holds, in torch
on the caller's device.

The port's counterpart of ``cv2.findEssentialMat(p0, p1, I, method=
cv2.RANSAC, threshold=..., prob=...)`` and ``cv2.recoverPose(E, p0, p1, I,
distanceThresh, mask=mask)`` on points already in normalized camera
coordinates (the identity camera matrix, as ``geometry.estimate_pose``
calls them), following OpenCV's algorithm step by step, in float64:

1. hypotheses from 5 distinct correspondences, drawn from a seeded
   ``torch.Generator`` (OpenCV draws from its own fixed-seed RNG, so the
   samples differ; no bit equality with OpenCV's random stream is sought,
   as in ``ransac.py``);
2. each sample solved by the five-point method (``five_point``, OpenCV's
   ``EMEstimatorCallback::runKernel``, Nister's solver): the 4-d null space
   of the 5 x 9 epipolar constraints, the 10 cubic constraints det(E) = 0
   and 2 E E^T E - tr(E E^T) E = 0 on E = x E0 + y E1 + z E2 + E3 as a
   10 x 20 matrix over the monomials of degree 3 and less, Gauss-Jordan on
   OpenCV's 10 columns, the 3 x 3 matrix B(z) of polynomials in z with
   B(z) [x, y, 1]^T = 0, the real roots of its degree-10 determinant (by
   Aberth's iteration, where OpenCV runs ``solvePoly``), and [x, y, 1] from
   the null space of B(z) at each: up to 10 candidate E a sample, each of
   unit Frobenius norm;
3. the hypotheses scored as a batch by the Sampson distance, in float32
   as OpenCV stores it, an inlier where it is at most threshold^2;
4. taken in order, each with more inliers than the best so far (and at
   least 5) becoming the best and lowering the iteration bound as
   ``ransac.update_num_iters`` (OpenCV's RANSACUpdateNumIters) does: a
   chunk's scan runs on the device as prefix maxima and minima
   (``_scan_chunk``), and the host reads 3 numbers a chunk to know whether
   another chunk is due; with exactly 5 points the sample's whole stack of
   candidates is returned, as OpenCV returns it;
5. ``recover_pose``: the four (R, t) of E (``decomposeEssentialMat``:
   R = U W V^T or U W^T V^T, t = +-U[:, 2]), each point triangulated by the
   SVD of its 4 x 4 linear system, and the cheirality count (positive
   depth in both cameras, nearer than the distance threshold) over the
   given mask; the first candidate with the most points wins, and the mask
   becomes the given mask and that candidate's cheirality, as OpenCV
   writes it back into its mask argument.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.eval.ransac import _DBL_MIN, draw_samples

MODEL_POINTS = 5
CHUNK = 256  # samples drawn and scored per batch (up to 10 hypotheses each)
SEED = 0  # of the generator the samples are drawn from, one per call
REAL_IMAG = 1e-10  # a root with a smaller imaginary part is real (OpenCV's root test)
# recoverPose's distance threshold where the caller passes none (OpenCV's default)
DEFAULT_DISTANCE = 50.0

# the monomials x^a y^b z^c of degree 3 and less, by degree from 3 down
MONOMIALS = [m for deg in (3, 2, 1, 0)
             for m in sorted(((a, b, deg - a - b) for a in range(deg + 1)
                              for b in range(deg + 1 - a)), reverse=True)]
_INDEX = {m: i for i, m in enumerate(MONOMIALS)}
_X, _Y, _Z, _ONE = (_INDEX[m] for m in ((1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)))


def _product_table() -> np.ndarray:
    """(400, 20): the monomial of each product of two, where its degree is 3 or less."""
    table = np.zeros((20, 20, 20))
    for i, a in enumerate(MONOMIALS):
        for j, b in enumerate(MONOMIALS):
            m = tuple(p + q for p, q in zip(a, b))
            if sum(m) <= 3:
                table[i, j, _INDEX[m]] = 1.0
    return table.reshape(400, 20)


_TABLE = _product_table()


def _mul(p: torch.Tensor, q: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The product of polynomials (..., 20) of total degree 3 or less."""
    p, q = torch.broadcast_tensors(p, q)
    outer = (p[..., :, None] * q[..., None, :]).reshape(*p.shape[:-1], 400)
    return outer @ table


# the cubic columns that Gauss-Jordan eliminates, as OpenCV does: x^3, y^3,
# x^2 y, x y^2, x^2 z, x^2, y^2 z, y^2, x y z, x y; the other ten are x, y
# or 1 times a polynomial in z
_ELIM = [_INDEX[m] for m in ((3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1), (2, 0, 0),
                             (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0))]
_REST = [i for i in range(20) if i not in _ELIM]
# (m z, m) row pairs of the eliminated system: each row m z - z (row m) is
# free of the eliminated monomials, an equation in x, y and 1 over z
_PAIRS = [(_ELIM.index(_INDEX[hi]), _ELIM.index(_INDEX[lo]))
          for hi, lo in (((2, 0, 1), (2, 0, 0)), ((0, 2, 1), (0, 2, 0)), ((1, 1, 1), (1, 1, 0)))]
ROOT_ITERS = 48  # Aberth steps of the degree-10 polynomial's roots


def _z_tables() -> tuple[np.ndarray, np.ndarray]:
    """(10, 15) maps of a row over the remaining monomials to its (3, 5)
    polynomials in z (the factor x, y or 1, ascending powers of z): as it
    stands, and times z."""
    same, times_z = np.zeros((10, 3, 5)), np.zeros((10, 3, 5))
    for r, i in enumerate(_REST):
        a, b, c = MONOMIALS[i]
        part = 0 if a else 1 if b else 2
        same[r, part, c] = 1.0
        times_z[r, part, c + 1] = 1.0
    return same.reshape(10, 15), times_z.reshape(10, 15)


_Z_SAME, _Z_TIMES = _z_tables()


def _poly_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of polynomials (..., la) and (..., lb), ascending powers."""
    out = a.new_zeros(a.shape[:-1] + (a.shape[-1] + b.shape[-1] - 1,))
    for i in range(a.shape[-1]):
        out[..., i:i + b.shape[-1]] += a[..., i:i + 1] * b
    return out


def _real_roots(c: torch.Tensor):
    """The roots of polynomials (K, 11) (ascending powers, degree 10) by
    Aberth's simultaneous iteration on the device, a fixed ROOT_ITERS steps
    from a circle of the roots' geometric mean radius: (roots (K, 10)
    float64, real (K, 10) bool: an imaginary part of at most REAL_IMAG, as
    OpenCV's test of its solvePoly roots)."""
    n = c.shape[1] - 1
    lead = c[:, n:]
    ok = lead.abs() > torch.finfo(c.dtype).eps * c.abs().amax(1, keepdim=True)
    a = (c / torch.where(ok, lead, 1.0)).to(torch.complex128)       # monic
    da = a[:, 1:] * torch.arange(1, n + 1, dtype=c.dtype, device=c.device)
    radius = a[:, :1].abs().clamp(min=1e-300) ** (1.0 / n)
    angle = torch.arange(n, dtype=c.dtype, device=c.device) * (2 * math.pi / n) + 0.4
    z = radius * torch.polar(torch.ones_like(angle), angle)
    eye = torch.eye(n, dtype=torch.bool, device=c.device)
    for _ in range(ROOT_ITERS):
        powers = torch.cumprod(torch.cat([torch.ones_like(z[..., None]),
                                          z[..., None].expand(-1, -1, n)], 2), 2)
        w = (powers * a[:, None]).sum(2) / (powers[..., :n] * da[:, None]).sum(2)
        diff = z[:, :, None] - z[:, None, :]
        inv = torch.where(eye, 0.0, 1.0 / torch.where(eye, 1.0, diff))
        step = w / (1 - w * inv.sum(2))
        z = z - torch.where(torch.isfinite(step), step, 0.0)
    real = ok & (z.imag.abs() <= REAL_IMAG) & torch.isfinite(z.real)
    return z.real, real


def five_point(q0: torch.Tensor, q1: torch.Tensor):
    """The essential matrices of 5 correspondences, for a batch of samples.

    q0, q1 (K, 5, 2) float64 normalized points, q1^T E q0 = 0. Returns
    (E (K, 10, 3, 3), ok (K, 10) bool): each sample's real solutions, of
    unit Frobenius norm, in the order of the roots (the rest not ok)."""
    k = q0.shape[0]
    dev = q0.device
    x0, y0 = q0.unbind(-1)
    x1, y1 = q1.unbind(-1)
    one = torch.ones_like(x0)
    # a row per point: E's row-major entries in q1^T E q0
    Q = torch.stack([x0 * x1, y0 * x1, x1, x0 * y1, y0 * y1, y1, x0, y0, one], -1)
    null = torch.linalg.svd(Q, full_matrices=True)[2][:, 5:9]       # (K, 4, 9)
    table = torch.as_tensor(_TABLE, dtype=q0.dtype, device=dev)
    Ep = torch.zeros((k, 3, 3, 20), dtype=q0.dtype, device=dev)
    for var, basis in zip((_X, _Y, _Z, _ONE), null.unbind(1)):
        Ep[..., var] = basis.reshape(k, 3, 3)

    # det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0, as polynomials in x, y, z
    EEt = _mul(Ep[:, :, None], Ep[:, None], table).sum(3)           # (K, 3, 3, 20)
    trace = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]
    EEtE = _mul(EEt[:, :, :, None], Ep[:, None], table).sum(2)
    cons = 2.0 * EEtE - _mul(trace[:, None, None], Ep, table)
    e = Ep.reshape(k, 9, 20).unbind(1)

    def minor(a, b, c, d):
        return _mul(e[a], e[b], table) - _mul(e[c], e[d], table)

    det = (_mul(e[0], minor(4, 8, 5, 7), table) - _mul(e[1], minor(3, 8, 5, 6), table)
           + _mul(e[2], minor(3, 7, 4, 6), table))
    A = torch.cat([det[:, None], cons.reshape(k, 9, 20)], 1)         # (K, 10, 20)

    # Gauss-Jordan on the eliminated columns: elim_i = -C[i] . rest
    C, info = torch.linalg.solve_ex(A[:, :, _ELIM], A[:, :, _REST])
    same = torch.as_tensor(_Z_SAME, dtype=q0.dtype, device=dev)
    times_z = torch.as_tensor(_Z_TIMES, dtype=q0.dtype, device=dev)
    hi, lo = (torch.tensor(ix, device=dev) for ix in zip(*_PAIRS))
    # B(z) [x, y, 1]^T = 0: (K, 3, 3) polynomials of degree 4 in z
    B = (C[:, hi] @ same - C[:, lo] @ times_z).reshape(k, 3, 3, 5)
    b = [[B[:, i, j] for j in range(3)] for i in range(3)]
    cof = [_poly_mul(b[1][1], b[2][2]) - _poly_mul(b[1][2], b[2][1]),
           _poly_mul(b[1][2], b[2][0]) - _poly_mul(b[1][0], b[2][2]),
           _poly_mul(b[1][0], b[2][1]) - _poly_mul(b[1][1], b[2][0])]
    poly = sum(_poly_mul(b[0][j], cof[j]) for j in range(3))[:, :11]  # det B(z), degree 10
    good = (info == 0) & torch.isfinite(poly).all(1)
    z, ok = _real_roots(torch.where(good[:, None], poly, 1.0))
    ok &= good[:, None]

    # [x, y, 1] spans the null space of B(z): the cross product of the two
    # rows whose product is largest, of unit norm (OpenCV's SVD::solveZ)
    zp = z[..., None] ** torch.arange(5, dtype=z.dtype, device=dev)   # (K, 10, 5)
    Bz = (B[:, None] * zp[:, :, None, None]).sum(-1)                  # (K, 10, 3, 3)
    rows = [torch.linalg.cross(Bz[..., i, :], Bz[..., j, :]) for i, j in ((0, 1), (0, 2), (1, 2))]
    rows = torch.stack(rows, 2)                                       # (K, 10, 3, 3)
    norms = torch.linalg.vector_norm(rows, dim=-1)
    xy1 = torch.gather(rows, 2, norms.argmax(2)[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    xy1 = xy1 / torch.linalg.vector_norm(xy1, dim=-1, keepdim=True)
    ok &= xy1[..., 2].abs() >= REAL_IMAG
    w = torch.where(ok, xy1[..., 2], 1.0)
    E = ((xy1[..., 0] / w)[..., None] * null[:, None, 0] + (xy1[..., 1] / w)[..., None]
         * null[:, None, 1] + z[..., None] * null[:, None, 2] + null[:, None, 3])
    E = E / torch.linalg.vector_norm(E, dim=-1, keepdim=True)
    ok = ok & torch.isfinite(E).all(-1)
    return E.reshape(k, 10, 3, 3), ok


def sampson_errors(E: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """OpenCV's EMEstimatorCallback::computeError: (M, N) float32 Sampson
    distances of N correspondences (float64 (N, 2) each) to M matrices E."""
    e = E.reshape(-1, 9)[:, :, None]                    # (M, 9, 1)
    x0, y0 = p0[None, :, 0], p0[None, :, 1]
    x1, y1 = p1[None, :, 0], p1[None, :, 1]
    ex0 = e[:, 0] * x0 + e[:, 1] * y0 + e[:, 2]         # E x0
    ex1 = e[:, 3] * x0 + e[:, 4] * y0 + e[:, 5]
    ex2 = e[:, 6] * x0 + e[:, 7] * y0 + e[:, 8]
    et0 = e[:, 0] * x1 + e[:, 3] * y1 + e[:, 6]         # E^T x1
    et1 = e[:, 1] * x1 + e[:, 4] * y1 + e[:, 7]
    x1ex0 = x1 * ex0 + y1 * ex1 + ex2
    return (x1ex0 * x1ex0 / (ex0 * ex0 + ex1 * ex1 + et0 * et0 + et1 * et1)).to(torch.float32)


def find_essential_mat(pts0, pts1, threshold: float, prob: float = 0.999,
                       max_iters: int = 1000, device: Optional[str] = None):
    """RANSAC essential matrix of (N, 2) normalized correspondences.

    Returns (E (m, 3, 3) float64, mask (N, 1) uint8), as
    ``cv2.findEssentialMat`` with the identity camera matrix returns them
    (its (3m, 3) stack as m matrices: one, or the whole stack of a sample
    where N is 5), or None where OpenCV returns no matrix. Runs on `device`
    (``cuda`` unless the caller names another)."""
    dev = resolve_device(device)
    p0, p1 = (torch.as_tensor(np.asarray(p, np.float64).reshape(-1, 2), device=dev)
              for p in (pts0, pts1))
    n = p0.shape[0]
    if n != p1.shape[0]:
        raise ValueError(f"find_essential_mat: {n} and {p1.shape[0]} points")
    if n < MODEL_POINTS:
        return None
    if n == MODEL_POINTS:
        E, ok = five_point(p0[None], p1[None])
        E = E[0][ok[0]]
        if len(E) == 0:
            return None
        return E.cpu().numpy(), np.ones((n, 1), np.uint8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t2 = float(np.float32(threshold * threshold))
    niters, it, max_good = max(max_iters, 1), 0, 0
    best = torch.zeros((3, 3), dtype=torch.float64, device=dev)
    while it < niters:
        want = min(CHUNK, niters - it)
        idx = draw_samples(n, want, gen, dev, MODEL_POINTS)
        E, ok = five_point(p0[idx], p1[idx])
        counts = (sampson_errors(E.reshape(-1, 3, 3), p0, p1) <= t2).sum(1)
        counts = torch.where(ok.reshape(-1), counts, -1)
        state, at = _scan_chunk(counts, it, niters, max_good, n, prob)
        best = torch.where(at >= 0, E.reshape(-1, 3, 3)[at.clamp(min=0)], best)
        it, niters, max_good = state.tolist()
    if max_good == 0:
        return None
    mask = (sampson_errors(best[None], p0, p1)[0] <= t2).to(torch.uint8)
    return best[None].cpu().numpy(), mask.cpu().numpy()[:, None]


def _num_iters(prob: float, count: torch.Tensor, n: int) -> torch.Tensor:
    """``ransac.update_num_iters`` of a best count c (outlier share
    (n - c) / n) as a bound below any other: the iteration count it gives
    where that is below the bound it is passed, else a bound above every
    one (float64; 0 where every point is an inlier)."""
    p = min(max(prob, 0.0), 1.0)
    num = math.log(max(1.0 - p, _DBL_MIN))
    ep = ((n - count).to(torch.float64) / n).clamp(0.0, 1.0)
    denom = 1.0 - (1.0 - ep) ** MODEL_POINTS
    log_denom = torch.log(denom.clamp(min=_DBL_MIN))
    iters = torch.where(log_denom < 0, torch.round(num / log_denom), math.inf)
    return torch.where(denom < _DBL_MIN, 0.0, iters)


def _scan_chunk(counts: torch.Tensor, it: int, niters: int, max_good: int, n: int,
                prob: float):
    """OpenCV's RANSAC loop over a chunk of samples, on the device.

    counts (S * 10,) the inliers of each sample's candidates in order (-1
    where not a solution). A candidate becomes the best where it has more
    inliers than every one before it and at least MODEL_POINTS; each such
    lowers the bound to ``update_num_iters`` of its count, which only
    lowers it as counts grow (their minimum is the bound after it). Sample
    s is drawn where it + s is below the bound after sample s - 1: a
    prefix. Returns (state (3,) int64: it, niters, max_good after the
    chunk; the index of the chunk's best candidate, -1 where it has none)."""
    s = counts.numel() // 10
    before = torch.cat([counts.new_full((1,), max(max_good, MODEL_POINTS - 1)),
                        counts[:-1]]).cummax(0).values
    better = counts > before
    bound = torch.where(better, _num_iters(prob, counts, n), math.inf).cummin(0).values
    bound = bound.clamp(max=niters).reshape(s, 10)[:, -1]           # after each sample
    limit = torch.cat([bound.new_full((1,), niters), bound[:-1]])    # before each sample
    drawn = (it + torch.arange(s, device=counts.device) < limit).long().cumprod(0).bool()
    taken = drawn.repeat_interleave(10)
    last = torch.where(taken & better, torch.arange(counts.numel(), device=counts.device), -1)
    at = last.max()
    m = drawn.sum()
    after = torch.where(m > 0, bound[(m - 1).clamp(min=0)], float(niters))
    top = torch.where(at >= 0, counts[at.clamp(min=0)], max_good)
    return torch.stack([it + m, after.long(), top]), at


def decompose_essential_mat(E: torch.Tensor):
    """OpenCV's decomposeEssentialMat: (R1, R2, t) of a (3, 3) float64 E."""
    U, _, Vh = torch.linalg.svd(E)
    U = torch.where(torch.linalg.det(U) < 0, -U, U)
    Vh = torch.where(torch.linalg.det(Vh) < 0, -Vh, Vh)
    W = torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype,
                     device=E.device)
    return U @ W @ Vh, U @ W.T @ Vh, U[:, 2]


def _triangulate(P1: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """OpenCV's triangulatePoints with P0 = [I | 0]: (C, N, 4) homogeneous
    points, the null vector of each point's 4 x 4 system, for C camera
    matrices P1 (C, 3, 4)."""
    c, n = P1.shape[0], p0.shape[0]
    P0 = torch.eye(3, 4, dtype=p0.dtype, device=p0.device).expand(c, 3, 4)
    rows = []
    for P, p in ((P0, p0), (P1, p1)):
        x, y = p[None, :, 0, None], p[None, :, 1, None]       # (1, N, 1)
        rows += [x * P[:, None, 2] - P[:, None, 0], y * P[:, None, 2] - P[:, None, 1]]
    A = torch.stack(rows, 2)                                    # (C, N, 4, 4)
    return torch.linalg.svd(A)[2][..., 3, :]


def recover_pose(E, pts0, pts1, distance_thresh: float, mask=None,
                 device: Optional[str] = None):
    """``cv2.recoverPose(E, p0, p1, I, distance_thresh, mask=mask)`` on
    normalized points: (count, R (3, 3), t (3,), mask (N, 1) uint8), the
    mask the given one (all ones without it) and the chosen pose's
    cheirality. Runs on `device` (``cuda`` unless the caller names
    another)."""
    dev = resolve_device(device)
    E = torch.as_tensor(np.asarray(E, np.float64).reshape(3, 3), device=dev)
    p0, p1 = (torch.as_tensor(np.asarray(p, np.float64).reshape(-1, 2), device=dev)
              for p in (pts0, pts1))
    n = p0.shape[0]
    given = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
             else torch.as_tensor(np.asarray(mask).reshape(-1) != 0, device=dev))
    R1, R2, t = decompose_essential_mat(E)
    Rs = torch.stack([R1, R2, R1, R2])
    ts = torch.stack([t, t, -t, -t])
    P = torch.cat([Rs, ts[:, :, None]], 2)                      # (4, 3, 4)
    Q = _triangulate(P, p0, p1)                                 # (4, N, 4)
    ok = Q[..., 2] * Q[..., 3] > 0
    Q = Q / Q[..., 3:4]
    ok &= Q[..., 2] < distance_thresh
    depth = (Q @ P.transpose(1, 2))[..., 2]                     # z in the second camera
    ok &= (depth > 0) & (depth < distance_thresh) & given
    counts = ok.sum(1)
    best = int(torch.argmax(counts))  # the first of the largest counts, as OpenCV's cascade
    return (int(counts[best]), Rs[best].cpu().numpy(), ts[best].cpu().numpy(),
            ok[best].to(torch.uint8).cpu().numpy()[:, None])
