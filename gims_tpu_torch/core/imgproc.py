"""Host image operations the evaluation needs, with numpy only.

The port's counterparts of the OpenCV calls of the JAX package's
evaluation and pair generation (``gims_tpu/eval/homography.py``,
``gims_tpu/cli/generate_pairs_cli.py``, ``gims_tpu/train/data.py``):

- ``warp_perspective``: ``cv2.warpPerspective`` with INTER_LINEAR and a
  constant border of 0. Each output pixel samples the input bilinearly at
  H^-1 of its coordinates (float64 coordinates, float32 weights), a tap
  outside the image reads 0, and the result is rounded. OpenCV interpolates with 5-bit fixed-point
  weights, so a few pixels differ by one level.
- ``resize``: ``cv2.resize``, INTER_LINEAR (the default) or INTER_CUBIC,
  on uint8, with OpenCV's half-pixel centres, replicated borders and
  11-bit fixed-point weights. The same size returns a copy. Linear
  downscales and the cubic 4x upscale of the benchmark generator agree
  with OpenCV but for one level on a few pixels in 10^4; linear upscales
  differ by one level on up to ~1% of the pixels of a noise texture, and
  cubic resizes by other factors on up to ~5% (OpenCV 5 rounds those by
  rules not reproduced here).
- ``gaussian_blur``: ``cv2.GaussianBlur(img, (0, 0), sigma)`` on uint8,
  OpenCV's bit-exact fixed-point filter: a kernel of round(6 sigma + 1) | 1
  taps in 8 fractional bits, a horizontal then a vertical pass in
  integers, reflect-101 borders.
- ``bgr_to_gray``: ``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` on uint8.
- ``perspective_transform``: ``cv2.perspectiveTransform`` on float32
  points, float32 out.
- ``get_perspective_transform``: ``cv2.getPerspectiveTransform``, OpenCV's
  8x8 LU solve in float64. Where the 8x8 system is singular (three of the
  points collinear, or two equal), OpenCV 5 returns a unit vector of the
  null space of the 8x9 system [A | -b] as the matrix, not scaled to a 1 in
  the corner; so does this function. Where that null space has more than
  one dimension, which unit vector comes out is the SVD's choice, and it
  may differ from OpenCV's.
"""

from __future__ import annotations

import numpy as np

INTER_LINEAR = 1
INTER_CUBIC = 2
_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
_FLT_EPSILON = np.finfo(np.float32).eps
_DBL_EPSILON = np.finfo(np.float64).eps


def _as_hwc(img):
    img = np.asarray(img)
    return (img[..., None], True) if img.ndim == 2 else (img, False)


def warp_perspective(img, H, dsize):
    """``cv2.warpPerspective(img, H, (w, h))``: INTER_LINEAR, border 0."""
    src, flat = _as_hwc(img)
    h_in, w_in, c = src.shape
    w, h = dsize
    Hi = np.linalg.inv(np.asarray(H, np.float64))
    xs = np.arange(w, dtype=np.float64)[None]
    ys = np.arange(h, dtype=np.float64)[:, None]
    den = Hi[2, 0] * xs + Hi[2, 1] * ys + Hi[2, 2]
    den = np.where(np.abs(den) > _DBL_EPSILON, 1.0 / np.where(den == 0, 1.0, den), 0.0)
    sx = (Hi[0, 0] * xs + Hi[0, 1] * ys + Hi[0, 2]) * den
    sy = (Hi[1, 0] * xs + Hi[1, 1] * ys + Hi[1, 2]) * den
    # coordinates past the border clamp to where every tap reads the zero
    # padding (2 columns and rows before the image, 3 after it)
    x0 = np.floor(np.clip(sx, -2.0, w_in + 1.0))
    y0 = np.floor(np.clip(sy, -2.0, h_in + 1.0))
    # the fractions in float32: the blend's rounding error (~1e-5 of a
    # level) stays far below OpenCV's 5-bit weights
    fx = (sx - x0).reshape(-1, 1).astype(np.float32)
    fy = (sy - y0).reshape(-1, 1).astype(np.float32)
    gx, gy = 1 - fx, 1 - fy
    pw = w_in + 5
    padded = np.zeros((h_in + 5, pw, c), src.dtype)
    padded[2:2 + h_in, 2:2 + w_in] = src
    padded = padded.reshape(-1, c)
    i00 = ((y0.astype(np.int64) + 2) * pw + x0.astype(np.int64) + 2).reshape(-1)
    out = padded[i00] * (gx * gy)
    out += padded[i00 + 1] * (fx * gy)
    out += padded[i00 + pw] * (gx * fy)
    out += padded[i00 + pw + 1] * (fx * fy)
    out = _cast(out, src.dtype).reshape(h, w, c)
    return out[..., 0] if flat else out


def _cast(x, dtype):
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(x), info.min, info.max).astype(dtype)
    return x.astype(dtype)


def _cubic_weights(x):
    """OpenCV's interpolateCubic, A = -0.75, in float32."""
    a = np.float32(-0.75)
    x = x.astype(np.float32)
    one = np.float32(1)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], -1)


def _axis_taps(n_out, n_in, interpolation):
    """(indices, weights) of one axis: (n_out, k) source indices (replicated
    at the border) and float32 weights, OpenCV's resize geometry."""
    scale = n_in / n_out
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if interpolation == INTER_LINEAR:
        low = s < 0
        f[low], s[low] = 0, 0
        high = s >= n_in - 1
        f[high], s[high] = 0, n_in - 1
        idx = np.stack([s, s + 1], -1)
        w = np.stack([1 - f, f], -1)
    else:
        idx = s[:, None] + np.arange(-1, 3)
        w = _cubic_weights(f)
    return np.clip(idx, 0, n_in - 1), w


def resize(img, dsize, interpolation=INTER_LINEAR):
    """``cv2.resize(img, (w, h), interpolation=...)``."""
    src, flat = _as_hwc(img)
    w, h = dsize
    if (h, w) == src.shape[:2]:
        return np.array(img, copy=True)
    if interpolation not in (INTER_LINEAR, INTER_CUBIC):
        raise NotImplementedError(f"resize interpolation {interpolation}: only INTER_LINEAR "
                                  "and INTER_CUBIC are ported; others need OpenCV")
    if src.dtype != np.uint8:
        raise NotImplementedError(f"resize of {src.dtype}: only uint8 is ported")
    xi, xw = _axis_taps(w, src.shape[1], interpolation)
    yi, yw = _axis_taps(h, src.shape[0], interpolation)
    # 11-bit weights; the horizontal pass in integers, the vertical pass as
    # OpenCV's vector code does it
    ax = np.rint(xw * _COEF_SCALE).astype(np.int32)
    by = np.rint(yw * _COEF_SCALE).astype(np.int32)
    rows = src.astype(np.int32)[yi.min():yi.max() + 1]
    hsum = sum(rows[:, xi[:, k]] * ax[None, :, k, None]
               for k in range(xi.shape[1]))  # (rows, w, c)
    taps = hsum[yi - yi.min()]  # (h, k, w, c)
    if interpolation == INTER_LINEAR:
        # ((((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1) >> 16) + 2) >> 2
        parts = ((taps >> 4) * by[:, :, None, None]) >> 16
        out = (parts.sum(1) + 2) >> 2
    else:
        scaled = (by.astype(np.float32) / np.float32(_COEF_SCALE * _COEF_SCALE))
        acc = np.zeros(taps.shape[:1] + taps.shape[2:], np.float32)
        for k in range(3, -1, -1):
            acc = taps[:, k].astype(np.float32) * scaled[:, k, None, None] + acc
        out = np.rint(acc)
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out[..., 0] if flat else out


def gaussian_kernel_fixed(sigma, ksize):
    """OpenCV's 8-bit fixed-point Gaussian kernel: float64 weights, rounded
    from the ends inwards with the rounding error carried to the next tap,
    the centre the rest of 256."""
    x = np.arange(ksize) - (ksize - 1) / 2
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    k = t / t.sum()
    out = np.zeros(ksize, np.int64)
    err = 0.0
    for i in range(ksize // 2):
        v = k[i] * 256 + err
        out[i] = out[ksize - 1 - i] = int(np.floor(v + 0.5))
        err = v - out[i]
    out[ksize // 2] = 256 - 2 * out[: ksize // 2].sum()
    return out


def _reflect101(n, r):
    i = np.arange(-r, n + r)
    i = np.abs(i)
    return np.where(i >= n, 2 * (n - 1) - i, i)


def gaussian_blur(img, sigma):
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` on uint8 images."""
    src, flat = _as_hwc(img)
    if src.dtype != np.uint8:
        raise NotImplementedError(f"gaussian_blur of {src.dtype}: only uint8 is ported")
    ksize = int(np.floor(sigma * 6 + 1 + 0.5)) | 1
    k = gaussian_kernel_fixed(sigma, ksize)
    r = ksize // 2
    h, w = src.shape[:2]
    x = src.astype(np.int32)[:, _reflect101(w, r)]
    hs = sum(int(k[i]) * x[:, i:i + w] for i in range(ksize) if k[i])
    hs = hs[_reflect101(h, r)]
    vs = sum(int(k[i]) * hs[i:i + h] for i in range(ksize) if k[i])
    out = ((vs + (1 << 15)) >> 16).astype(np.uint8)
    return out[..., 0] if flat else out


def bgr_to_gray(img):
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` on (..., 3) uint8: OpenCV's
    15-bit weights, rounded."""
    x = np.asarray(img).astype(np.int32)
    g = (3735 * x[..., 0] + 19235 * x[..., 1] + 9798 * x[..., 2] + (1 << 14)) >> 15
    return g.astype(np.uint8)


def perspective_transform(points, H):
    """``cv2.perspectiveTransform``: (..., 2) points through the 3x3 H, in
    float64, cast back to the points' float type (float32 for integers);
    a point whose w is within FLT_EPSILON of 0 maps to (0, 0)."""
    p = np.asarray(points)
    out_dtype = p.dtype if p.dtype in (np.float32, np.float64) else np.float32
    eps = _FLT_EPSILON if out_dtype == np.float32 else _DBL_EPSILON
    m = np.asarray(H, np.float64).reshape(-1)
    x = p[..., 0].astype(np.float64)
    y = p[..., 1].astype(np.float64)
    w = x * m[6] + y * m[7] + m[8]
    ok = np.abs(w) > eps
    w = np.where(ok, 1.0 / np.where(ok, w, 1.0), 0.0)
    out = np.stack([(x * m[0] + y * m[1] + m[2]) * w, (x * m[3] + y * m[4] + m[5]) * w], -1)
    return out.astype(out_dtype)


def _lu_solve(a, b, eps=_DBL_EPSILON * 100):
    """OpenCV's LU (Gaussian elimination with partial pivoting) of a small
    system; None where a pivot falls under `eps`."""
    a, b = a.astype(np.float64).copy(), b.astype(np.float64).copy()
    m = a.shape[0]
    for i in range(m):
        k = i + int(np.argmax(np.abs(a[i:, i])))
        if abs(a[k, i]) < eps:
            return None
        if k != i:
            a[[i, k], i:] = a[[k, i], i:]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, m):
            alpha = a[j, i] * d
            a[j, i + 1:] += alpha * a[i, i + 1:]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, m):
            s -= a[i, k] * b[k]
        b[i] = s / a[i, i]
    return b


def get_perspective_transform(src, dst):
    """``cv2.getPerspectiveTransform(src, dst)`` of four float32 point pairs."""
    s = np.asarray(src, np.float32).reshape(4, 2)
    d = np.asarray(dst, np.float32).reshape(4, 2)
    a = np.zeros((8, 8), np.float64)
    b = np.zeros(8, np.float64)
    for i in range(4):
        a[i, 0] = a[i + 4, 3] = s[i, 0]
        a[i, 1] = a[i + 4, 4] = s[i, 1]
        a[i, 2] = a[i + 4, 5] = 1
        # float32 products, as OpenCV forms them from Point2f
        a[i, 6] = -s[i, 0] * d[i, 0]
        a[i, 7] = -s[i, 1] * d[i, 0]
        a[i + 4, 6] = -s[i, 0] * d[i, 1]
        a[i + 4, 7] = -s[i, 1] * d[i, 1]
        b[i], b[i + 4] = d[i, 0], d[i, 1]
    sv = np.linalg.svd(a, compute_uv=False)
    x = None if sv[-1] <= sv[0] * 8 * _DBL_EPSILON else _lu_solve(a, b)
    if x is None:
        return np.linalg.svd(np.hstack([a, -b[:, None]]))[2][-1].reshape(3, 3)
    return np.append(x, 1.0).reshape(3, 3)
