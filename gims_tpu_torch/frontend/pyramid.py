"""Gaussian pyramid constants and helpers, OpenCV-SIFT-compatible.

Port of the parts of ``gims_tpu/frontend/pyramid.py`` that the device
detector needs (reference: utils/library.py:234-293): nOctaveLayers + 3 = 6
layers per octave, sigma 1.6, incremental blurs
sig_i = sqrt((1.6 k^i)^2 - (1.6 k^{i-1})^2) with k = 2^(1/3), and the 2x
bilinear upsample of OpenCV's firstOctave = -1.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

N_OCTAVE_LAYERS = 3
SIGMA = 1.6
FIRST_OCTAVE = -1


def blur_sigmas() -> List[float]:
    """Incremental blur sigmas for layers 1..5 (index 0 is SIGMA)."""
    k = 2.0 ** (1.0 / N_OCTAVE_LAYERS)
    sig = [SIGMA]
    for i in range(1, N_OCTAVE_LAYERS + 3):
        sig_prev = (k ** (i - 1)) * SIGMA
        sig_total = sig_prev * k
        sig.append(math.sqrt(sig_total**2 - sig_prev**2))
    return sig


def num_octaves(height: int, width: int) -> int:
    """Octave count for a 2x-upsampled base (reference: library.py:248-250)."""
    n = round(math.log(min(width, height)) / math.log(2.0) - 2.0)
    return int(n) - FIRST_OCTAVE


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel for float images: ksize = round(sigma*8+1)|1."""
    ksize = int(round(sigma * 8 + 1)) | 1
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    w = np.exp(-(x**2) / (2.0 * sigma * sigma))
    return (w / w.sum()).astype(np.float32)


def upsample2x(image: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of the last two axes, half-pixel centres.

    ``jax.image.resize(..., "linear")`` at scale 2: output pixel 2i samples
    input coordinate i - 1/4 (weights 1/4, 3/4 on pixels i-1, i) and 2i+1
    samples i + 1/4 (3/4, 1/4 on i, i+1). At the border the tap that falls
    outside the image is dropped and the other renormalised to 1, which is
    the edge pixel repeated.
    """
    def along(x, dim):
        n = x.shape[dim]
        prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
        even = 0.25 * prev + 0.75 * x
        odd = 0.75 * x + 0.25 * nxt
        out = torch.stack([even, odd], dim=dim + 1)
        shape = list(x.shape)
        shape[dim] = 2 * n
        return out.reshape(shape)

    return along(along(image.float(), image.dim() - 2), image.dim() - 1)


_CONSTANTS = {}


def device_constant(key, device, make):
    """A small host-made array as a tensor on `device`, copied once per
    process: a copy from the host waits for the whole stream, so the
    per-dispatch path must not make one."""
    key = (str(device),) + tuple(key)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.from_numpy(np.ascontiguousarray(make())).to(device)
    return _CONSTANTS[key]


def reflect101_index(n: int, half: int) -> np.ndarray:
    """Source index of every position of a row of n padded by `half` on
    each side with BORDER_REFLECT_101, folding as often as needed (a
    pyramid's last octaves can be narrower than the kernel)."""
    out = np.empty(n + 2 * half, np.int64)
    for j in range(n + 2 * half):
        src = j - half
        while n > 1 and (src < 0 or src >= n):
            src = -src if src < 0 else 2 * (n - 1) - src
        out[j] = src if n > 1 else 0
    return out


def sep_blur(x: torch.Tensor, kern: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W) f32 images, BORDER_REFLECT_101,
    as two single-channel convolutions.

    Full f32: TF32 is turned off around the convolutions, since 10 mantissa
    bits in the blur would move DoG extrema and contrast tests (a different
    keypoint set). The sums run in another order than the JAX package's
    banded matmuls (``frontend/blurmat.py``), the same function to f32
    rounding."""
    k = kern.shape[0]
    half = k // 2
    b, h, w = x.shape
    dev = x.device
    rows = device_constant(("reflect", h, half), dev, lambda: reflect101_index(h, half))
    cols = device_constant(("reflect", w, half), dev, lambda: reflect101_index(w, half))
    xp = x.index_select(1, rows).index_select(2, cols)[:, None]
    kt = device_constant(("kernel", kern.tobytes()), dev, lambda: kern)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        xp = F.conv2d(xp, kt.reshape(1, 1, k, 1))
        xp = F.conv2d(xp, kt.reshape(1, 1, 1, k))
    return xp[:, 0]
