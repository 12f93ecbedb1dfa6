"""Host image operations the evaluation needs, with numpy only.

The port's counterparts of the OpenCV calls of the JAX package's
evaluation and pair generation (``gims_tpu/eval/homography.py``,
``gims_tpu/cli/generate_pairs_cli.py``, ``gims_tpu/train/data.py``):

- ``warp_perspective``: ``cv2.warpPerspective`` with INTER_LINEAR and a
  constant border of 0. Each output pixel samples the input bilinearly at
  H^-1 of its coordinates (float64 coordinates, float32 weights), a tap
  outside the image reads 0, and the result is rounded. OpenCV interpolates with 5-bit fixed-point
  weights, so a few pixels differ by one level.
- ``resize``: ``cv2.resize``, INTER_LINEAR (the default), INTER_CUBIC or
  INTER_AREA, on uint8, with OpenCV's half-pixel centres, replicated
  borders and 11-bit fixed-point weights. The same size returns a copy.
  On float32, INTER_LINEAR with OpenCV's float weights (a horizontal then a
  vertical pass, as OpenCV's float code sums them), and a shrink by exactly
  2 on both axes as the IPP build takes it, equal to the bit: a lerp by 1/2
  along x, then along y.
  INTER_AREA shrinks by OpenCV's area weights (the mean of each 2x2 block
  rounded half up at a factor of 2, other integer factors rounded to
  nearest even, fractional factors by OpenCV's float32 cell weights summed
  in its order) and enlarges by OpenCV's area-mode bilinear taps.
  INTER_LINEAR
  equals OpenCV at every factor: 11-bit weights, the horizontal pass in
  integers, the vertical pass as OpenCV's vector code does it
  (``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2 >> 2``), and
  along y the taps past the border keep both weights on the border row
  (OpenCV moves them onto the border with weights (1, 0) only along x).
  INTER_CUBIC on images of 4 x 4 and more goes, in the OpenCV build with
  Intel IPP, through IPP's float code (``_resize_cubic_float``): equal at
  the callers' power-of-two factors, off by one level on a few pixels in
  10^5 to 10^3 at other fractional factors; smaller images take OpenCV's
  11-bit fixed-point path.
- ``gaussian_blur``: ``cv2.GaussianBlur(img, (0, 0), sigma)`` on uint8,
  OpenCV's bit-exact fixed-point filter: a kernel of round(6 sigma + 1) | 1
  taps in 8 fractional bits, a horizontal then a vertical pass in
  integers, reflect-101 borders.
- ``filter2d``: ``cv2.filter2D(img, -1, kernel)`` on float32 images, the
  kernel anchored at its centre, reflect-101 borders; the nonzero taps are
  summed in float32 in row-major order, as OpenCV's direct filter sums them.
- ``warp_affine``: ``cv2.warpAffine(img, M, (w, h))`` on float32 images,
  INTER_LINEAR, BORDER_CONSTANT 0, as OpenCV 5 computes it for float: the
  inverse map in float32 (x M00 + (y M01 + M02) as one fused multiply-add),
  then two horizontal and one vertical lerp, each a fused multiply-add;
  equal to OpenCV's to the bit on the tested images.
- ``get_rotation_matrix_2d``: ``cv2.getRotationMatrix2D``, in float64.
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
import torch

INTER_LINEAR = 1
INTER_CUBIC = 2
INTER_AREA = 3
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


def _axis_taps(n_out, n_in, interpolation, area_mode=False, clip=True):
    """(indices, weights) of one axis: (n_out, k) source indices (replicated
    at the border) and float32 weights, OpenCV's resize geometry.
    area_mode: INTER_AREA's bilinear taps where it enlarges. clip: a
    bilinear tap past the border moves onto it with weights (1, 0), as
    OpenCV does along x; along y it keeps its two weights, and both taps
    read the border row."""
    scale = n_in / n_out
    if area_mode:
        dx = np.arange(n_out)
        s = np.floor(dx * scale).astype(np.int64)
        f = ((dx + 1) - (s + 1) * (n_out / n_in)).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = f - s.astype(np.float32)
    if interpolation == INTER_LINEAR and clip:
        low = s < 0
        f[low], s[low] = 0, 0
        high = s >= n_in - 1
        f[high], s[high] = 0, n_in - 1
        idx = np.stack([s, s + 1], -1)
        w = np.stack([1 - f, f], -1)
    elif interpolation == INTER_LINEAR:
        idx = np.stack([s, s + 1], -1)
        w = np.stack([1 - f, f], -1)
    else:
        idx = s[:, None] + np.arange(-1, 3)
        w = _cubic_weights(f)
    return np.clip(idx, 0, n_in - 1), w


def _area_tab(n_out, n_in):
    """OpenCV's computeResizeAreaTab as (n_out, K) source indices and float32
    weights, each cell's taps in ascending source order (weight 0 pads)."""
    scale = 1.0 / (n_out / n_in)
    cells = []
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx2 = min(int(np.floor(fsx2)), n_in - 1)
        sx1 = min(int(np.ceil(fsx1)), sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        taps += [(sx, np.float32(1.0 / cell)) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
        cells.append(taps)
    k = max(len(t) for t in cells)
    idx = np.zeros((n_out, k), np.int64)
    wts = np.zeros((n_out, k), np.float32)
    for dx, taps in enumerate(cells):
        for j, (sx, a) in enumerate(taps):
            idx[dx, j], wts[dx, j] = sx, a
    return idx, wts


def _resize_area(src, w, h):
    """INTER_AREA where both axes shrink; src (H, W, C) uint8."""
    h_in, w_in = src.shape[:2]
    sx, sy = w_in / w, h_in / h
    if sx == int(sx) and sy == int(sy):
        fx, fy = int(sx), int(sy)
        blocks = src[:h * fy, :w * fx].astype(np.int32).reshape(h, fy, w, fx, -1)
        total = blocks.sum(axis=(1, 3))
        if fx == fy == 2:  # OpenCV's vector path: (a + b + c + d + 2) >> 2
            return ((total + 2) >> 2).astype(np.uint8)
        return np.rint(total.astype(np.float32) * np.float32(1.0 / (fx * fy))).astype(np.uint8)
    # ResizeArea_Invoker in float32: each source row's cells summed tap by
    # tap, then each output row accumulates beta * row over its source rows
    xi, xw = _area_tab(w, w_in)
    yi, yw = _area_tab(h, h_in)
    s = src.astype(np.float32)
    rows = np.zeros((h_in, w, src.shape[2]), np.float32)
    for k in range(xi.shape[1]):
        rows = rows + s[:, xi[:, k]] * xw[None, :, k, None]
    out = yw[:, 0, None, None] * rows[yi[:, 0]]
    for k in range(1, yi.shape[1]):
        out = out + yw[:, k, None, None] * rows[yi[:, k]]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize(img, dsize, interpolation=INTER_LINEAR):
    """``cv2.resize(img, (w, h), interpolation=...)``."""
    src, flat = _as_hwc(img)
    w, h = dsize
    if (h, w) == src.shape[:2]:
        return np.array(img, copy=True)
    if interpolation not in (INTER_LINEAR, INTER_CUBIC, INTER_AREA):
        raise NotImplementedError(f"resize interpolation {interpolation}: only INTER_LINEAR, "
                                  "INTER_CUBIC and INTER_AREA are ported; others need OpenCV")
    if src.dtype == np.float32 and interpolation == INTER_LINEAR:
        out = _resize_linear_f32(src, w, h)
        return out[..., 0] if flat else out
    if src.dtype != np.uint8:
        raise NotImplementedError(f"resize of {src.dtype}: only uint8, and float32 with "
                                  "INTER_LINEAR, are ported")
    if interpolation == INTER_CUBIC and min(src.shape[:2]) >= 4:
        out = _resize_cubic_float(src, w, h)
        return out[..., 0] if flat else out
    area_mode = interpolation == INTER_AREA
    if area_mode:
        if w <= src.shape[1] and h <= src.shape[0]:
            out = _resize_area(src, w, h)
            return out[..., 0] if flat else out
        interpolation = INTER_LINEAR  # enlarging: bilinear taps of area mode
    xi, xw = _axis_taps(w, src.shape[1], interpolation, area_mode)
    yi, yw = _axis_taps(h, src.shape[0], interpolation, area_mode, clip=False)
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


def _cubic_taps_f64(n_out, n_in):
    """INTER_CUBIC's taps of one axis with the weights computed in float64
    (the source coordinate too), then rounded to float32."""
    fx = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(fx)
    f = fx - s
    a = -0.75
    c0 = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    c1 = ((a + 2) * f - (a + 3)) * f * f + 1
    c2 = ((a + 2) * (1 - f) - (a + 3)) * (1 - f) * (1 - f) + 1
    w = np.stack([c0, c1, c2, 1 - c0 - c1 - c2], -1).astype(np.float32)
    return np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, n_in - 1), w


def _pairwise4(t, c):
    """fma(t0, c0, t1 c1) + fma(t2, c2, t3 c3) in float32."""
    return _fmaf(t[0], c[0], t[1] * c[1]) + _fmaf(t[2], c[2], t[3] * c[3])


def _resize_cubic_float(src, w, h):
    """INTER_CUBIC of a uint8 (H, W, C) image, at least 4 x 4, as the
    OpenCV build with Intel IPP computes it: float32 weights rounded from
    float64, a horizontal then a vertical pass in float32, each summing its
    taps as fma(t0, c0, t1 c1) + fma(t2, c2, t3 c3), the result rounded
    half to even. Equal to cv2.resize at
    power-of-two factors (the 4x and 8x upscales of the synthetic textures,
    the 2x and 4x shrinks) and at 0.8; at factors whose weights are not
    dyadic, such as 1.25 and 1.31, a few pixels in 10^5 round the other way,
    and at 0.6 about 2 in 10^3 (IPP's weights there are not reproduced).
    Smaller images take OpenCV's own fixed-point path (``resize``)."""
    xi, xc = _cubic_taps_f64(w, src.shape[1])
    yi, yc = _cubic_taps_f64(h, src.shape[0])
    t = src.astype(np.float32)[:, xi]                                  # (H_in, w, 4, C)
    rows = _pairwise4([t[:, :, k] for k in range(4)], [xc[None, :, k, None] for k in range(4)])
    v = rows[yi]                                                       # (h, 4, w, C)
    out = _pairwise4([v[:, k] for k in range(4)], [yc[:, k, None, None] for k in range(4)])
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _resize_linear_f32(src, w, h):
    """INTER_LINEAR of a float32 (H, W, C) image."""
    h_in, w_in = src.shape[:2]
    fx, fy = w // w_in, h // h_in
    if (w, h) == (fx * w_in, fy * h_in) and all(f & (f - 1) == 0 for f in (fx, fy)):
        # the IPP build's upscale by powers of two: along x, then along y,
        # each tap pair as fma(x1 - x0, t, x0) with the fraction t
        xi, xw = _axis_taps(w, w_in, INTER_LINEAR)
        yi, yw = _axis_taps(h, h_in, INTER_LINEAR)

        def lerp(a, b, t):
            return ((b - a).astype(np.float64) * t + a).astype(np.float32)

        rows = lerp(src[:, xi[:, 0]], src[:, xi[:, 1]],
                    xw[None, :, 1, None].astype(np.float32).astype(np.float64))
        return lerp(rows[yi[:, 0]], rows[yi[:, 1]],
                    yw[:, 1, None, None].astype(np.float32).astype(np.float64))
    if w_in == 2 * w and h_in == 2 * h:
        # the IPP build's exact 2x shrink: a lerp by 1/2 along x, then along y
        s = src[:2 * h, :2 * w]
        tl, tr, bl, br = s[0::2, 0::2], s[0::2, 1::2], s[1::2, 0::2], s[1::2, 1::2]
        half = np.float32(0.5)
        top, bottom = tl + (tr - tl) * half, bl + (br - bl) * half
        return (top + (bottom - top) * half).astype(np.float32)
    xi, xw = _axis_taps(w, w_in, INTER_LINEAR)
    yi, yw = _axis_taps(h, h_in, INTER_LINEAR)
    rows = src[:, xi[:, 0]] * xw[None, :, 0, None] + src[:, xi[:, 1]] * xw[None, :, 1, None]
    out = rows[yi[:, 0]] * yw[:, 0, None, None] + rows[yi[:, 1]] * yw[:, 1, None, None]
    return out.astype(np.float32)


def get_rotation_matrix_2d(center, angle, scale):
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) float64."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _invert_affine(m):
    """``cv2.invertAffineTransform`` in float64."""
    m = np.asarray(m, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _fmaf(a, b, c):
    """fmaf of float32 arrays: the float32 product is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def warp_affine(img, M, dsize):
    """``cv2.warpAffine(img, M, (w, h))``: INTER_LINEAR, border 0, float32."""
    src, flat = _as_hwc(img)
    if src.dtype != np.float32:
        raise NotImplementedError(f"warp_affine of {src.dtype}: only float32 is ported")
    h_in, w_in, _ = src.shape
    w, h = dsize
    m = _invert_affine(M).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    sx = _fmaf(m[0, 0], xs, m[0, 1] * ys + m[0, 2])
    sy = _fmaf(m[1, 0], xs, m[1, 1] * ys + m[1, 2])
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h_in) & (xx >= 0) & (xx < w_in)
        v = src[np.clip(yy, 0, h_in - 1), np.clip(xx, 0, w_in - 1)]
        return np.where(ok[..., None], v, np.float32(0))

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    r0 = _fmaf(fx, p01 - p00, p00)
    r1 = _fmaf(fx, p11 - p10, p10)
    out = _fmaf(fy, r1 - r0, r0)
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


def _gaussian_blur_float(src, sigma):
    """``cv2.GaussianBlur`` of a float32 or float64 (H, W, C) image, as
    OpenCV's build computes it, REFLECT_101. float32: ``sift.gaussian_blur``
    (the fused multiply-add order of OpenCV's vector code) on the channels
    interleaved along a row. float64: rows as the chain k0 x0, then
    + k_i x_i; columns from the centre tap out, k_c x_c, then
    + k_i (x_{c+i} + x_{c-i}) (OpenCV fuses the rows' multiply-adds: a few
    ulps apart)."""
    from gims_tpu_torch.frontend.sift import gaussian_blur as blur_f32, gaussian_kernel

    h, w, cn = src.shape
    if src.dtype == np.float32:
        out = blur_f32(torch.from_numpy(np.ascontiguousarray(src).reshape(h, w * cn)), sigma, cn)
        return out.numpy().reshape(h, w, cn)
    k = gaussian_kernel(sigma, np.float64)
    n, half = len(k), len(k) // 2
    width = w * cn
    x = src[:, _reflect101(w, half)].reshape(h, -1)
    s = x[:, :width] * float(k[0])
    for i in range(1, n):
        s = s + float(k[i]) * x[:, i * cn:i * cn + width]
    y = s[_reflect101(h, half)]
    t = y[half:half + h] * float(k[half])
    for i in range(1, half + 1):
        t = t + float(k[half + i]) * (y[half + i:half + i + h] + y[half - i:half - i + h])
    return t.reshape(h, w, cn)


def gaussian_blur(img, sigma):
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` on uint8, float32 and float64
    images. uint8 and float32 equal OpenCV to the bit (float32 through
    ``_gaussian_blur_float``; a few pixels of the last columns of narrow
    one-channel images, whose width is not a multiple of 4, can differ by
    an ulp); float64 within a few ulps (1e-15 relative)."""
    src, flat = _as_hwc(img)
    if src.dtype in (np.float32, np.float64):
        out = _gaussian_blur_float(src, sigma)
        return out[..., 0] if flat else out
    if src.dtype != np.uint8:
        raise NotImplementedError(f"gaussian_blur of {src.dtype}: only uint8, float32 and "
                                  "float64 are ported")
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


def filter2d(img, kernel):
    """``cv2.filter2D(img, -1, kernel)`` on a float32 (H, W[, C]) image:
    correlation with the kernel anchored at its centre, reflect-101
    borders, the nonzero taps summed in float32 in row-major order."""
    src, flat = _as_hwc(img)
    if src.dtype != np.float32:
        raise NotImplementedError(f"filter2d of {src.dtype}: only float32 is ported")
    k = np.asarray(kernel, np.float32)
    kh, kw = k.shape
    ay, ax = kh // 2, kw // 2
    h, w = src.shape[:2]
    padded = src[_reflect101(h, max(ay, kh - 1 - ay))][:, _reflect101(w, max(ax, kw - 1 - ax))]
    oy, ox = max(ay, kh - 1 - ay) - ay, max(ax, kw - 1 - ax) - ax
    out = np.zeros_like(src)
    for i in range(kh):
        for j in range(kw):
            if k[i, j] != 0:
                out = out + k[i, j] * padded[oy + i:oy + i + h, ox + j:ox + j + w]
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
