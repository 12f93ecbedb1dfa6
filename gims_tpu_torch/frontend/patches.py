"""Affine patch warp: one 32x32 patch per keypoint, on the device.

Port of ``gims_tpu/frontend/patches.py`` (reference: utils/library.py:
84-110 ``ComputePatches``, a cv2.warpAffine per keypoint). For keypoint
(pt, size, angle, octave, layer, scale) the forward affine is
A = R(deg2rad(360 - angle)) / step with step = size * scale * 0.5,
translated so that the keypoint lands on the patch centre r = (64 - 1) / 2;
the source level is pyramid[octave + 1][layer]. cv2.warpAffine inverts A,
so the warp samples src = A^-1 dst directly.

Sampling reads "quad rows": row (l, qy, qx) of a level stack holds the 2x2
pixel block at (qy - 1, qx - 1), zero outside the level, so one gathered row
holds a bilinear tap block and two by two of them a bicubic one. Quads that
lie wholly outside the level are masked. Together that is cv2's
BORDER_CONSTANT zero border for every tap. The reference warps 64x64 with
Keys bicubic taps (A = -0.75, INTER_CUBIC), then averages 2x2 boxes
(INTER_AREA 64 -> 32), then divides by 255; ``fast_frontend`` samples the
32x32 grid directly with bilinear taps. The taps accumulate in the JAX
package's order (tap pair a, b, then dy, dx, then channel), in f32.

The JAX package's block-gather variant (``BLOCK_PATH_ENABLED = False``
there) is not ported (ROADMAP.md).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gims_tpu_torch.core.bucketing import bucket_size
from gims_tpu_torch.frontend.sift import KeypointArrays

WARP_SIZE = 64
OUT_SIZE = 32
FLT_EPSILON = 1.19209e-07
KP_BUCKETS = (64, 256, 1024, 4096, 8192, 16384, 32768)
# bytes of one gathered tap tensor (k, warp_size^2, 4C) f32 that a chunk of
# keypoints may take on the card: a chunk holds one of them at a time, plus
# the C accumulators and the coordinate maps, each (k, warp_size^2) f32
WARP_CHUNK_BYTES = 256 << 20


def inverse_affines(kp: KeypointArrays) -> np.ndarray:
    """(N, 2, 3) mapping dst patch pixel -> source pyramid-level pixel."""
    step = kp.size * kp.scale * 0.5
    ptf = kp.pt * kp.scale[:, None]
    angle = 360.0 - kp.angle
    angle = np.where(np.abs(angle - 360.0) < FLT_EPSILON, 0.0, angle)
    phi = np.deg2rad(angle)
    s, c = np.sin(phi), np.cos(phi)
    r = (WARP_SIZE - 1) / 2.0

    # forward: A = R/step, t = r - A @ ptf;  inverse: L = step*R^T
    # src = L @ (dst - t) = L @ dst + (ptf - L @ [r, r])
    L = np.empty((len(kp), 2, 2), np.float32)
    L[:, 0, 0] = c * step
    L[:, 0, 1] = s * step
    L[:, 1, 0] = -s * step
    L[:, 1, 1] = c * step
    t = ptf - np.einsum("nij,j->ni", L, np.array([r, r], np.float32))
    return np.concatenate([L, t[:, :, None]], axis=2).astype(np.float32)


def _cubic_weights(t):
    """OpenCV INTER_CUBIC (Keys, A=-0.75) weights for offsets -1, 0, 1, 2."""
    A = -0.75
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    w2 = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1.0 - w0 - w1 - w2
    return [w0, w1, w2, w3]


def _linear_weights(t):
    return [1.0 - t, t]


def _chunk_for(warp_size: int, channels: int = 3, device=None) -> int:
    """Keypoints per warp chunk: the JAX package's sizes on the CPU; on the
    card as many as keep one gathered tap tensor within WARP_CHUNK_BYTES
    (1024 at warp 64 and 4096 at warp 32 with 3 channels)."""
    small = 512 if warp_size <= 32 else 256
    if device is None or torch.device(device).type != "cuda":
        return small
    per_kp = warp_size * warp_size * 4 * channels * 4
    return max(small, 1 << int(math.log2(WARP_CHUNK_BYTES // per_kp)))


def quad_blocks_from_levels(levels: torch.Tensor) -> torch.Tensor:
    """(..., h, w, C) -> (..., h+1, w+1, 4C): entry (qy, qx) holds the 2x2
    block at original (qy - 1, qx - 1), zero-padded, taps in the order
    (dy, dx) = (0,0), (0,1), (1,0), (1,1), channels inner."""
    h, w = levels.shape[-3:-1]
    p = F.pad(levels, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[..., 0:h + 1, 0:w + 1, :], p[..., 0:h + 1, 1:w + 2, :],
                      p[..., 1:h + 2, 0:w + 1, :], p[..., 1:h + 2, 1:w + 2, :]], dim=-1)


def quad_rows_from_levels(levels: torch.Tensor) -> torch.Tensor:
    """(L, h, w, C) -> (L*(h+1)*(w+1), 4C) quad rows (a batch of level
    stacks folds into L)."""
    return quad_blocks_from_levels(levels).reshape(-1, 4 * levels.shape[-1])


def _warp_chunk(quad_rows, h: int, w: int, channels: int, level_idx, ainv,
                interpolation: str, warp_size: int = WARP_SIZE):
    """One chunk: level_idx (k,) into the quad rows' level stack, ainv
    (k, 2, 3) -> (k, 32*32*C) patches, 0..255, channels inner."""
    k = level_idx.shape[0]
    dev = ainv.device
    xs = torch.arange(warp_size, dtype=torch.float32, device=dev)
    if warp_size != WARP_SIZE:
        # direct low-res sampling: place the small grid at the area-average
        # centres of the full-size grid (x64 = 2*x32 + 0.5 for 32 vs 64)
        ratio = WARP_SIZE / warp_size
        xs = xs * ratio + (ratio - 1.0) / 2.0
    gx = xs.repeat(warp_size)[None, :]                 # x fastest
    gy = xs.repeat_interleave(warp_size)[None, :]
    sx = ainv[:, 0, 0, None] * gx + ainv[:, 0, 1, None] * gy + ainv[:, 0, 2, None]
    sy = ainv[:, 1, 0, None] * gx + ainv[:, 1, 1, None] * gy + ainv[:, 1, 2, None]

    fx = torch.floor(sx)
    fy = torch.floor(sy)
    tx = sx - fx
    ty = sy - fy
    ix = fx.long()
    iy = fy.long()
    if interpolation == "cubic":
        wx, wy = _cubic_weights(tx), _cubic_weights(ty)
        pair_off = (-1, 1)   # quads covering taps (-1, 0) and (1, 2)
    elif interpolation == "linear":
        wx, wy = _linear_weights(tx), _linear_weights(ty)
        pair_off = (0,)      # one quad covers taps (0, 1)
    else:
        raise ValueError(f"interpolation={interpolation!r}: 'cubic' or 'linear'")

    base = level_idx.long()[:, None] * ((h + 1) * (w + 1))
    accs = [torch.zeros_like(sx) for _ in range(channels)]
    for a, pa in enumerate(pair_off):
        qy = iy + (pa + 1)
        y_ok = (qy >= 0) & (qy <= h)
        qyc = qy.clamp(0, h)
        for b, pb in enumerate(pair_off):
            qx = ix + (pb + 1)
            # the 1-px zero ring handles taps one step outside the level;
            # quads wholly outside are masked (all four taps out of bounds)
            okf = (y_ok & (qx >= 0) & (qx <= w)).float()
            vals = quad_rows[base + qyc * (w + 1) + qx.clamp(0, w)]  # (k, npix, 4C)
            for dy in (0, 1):
                wyv = wy[2 * a + dy]
                for dx in (0, 1):
                    wgt = wyv * wx[2 * b + dx] * okf
                    slot = (dy * 2 + dx) * channels
                    for ch in range(channels):
                        accs[ch] = accs[ch] + vals[..., slot + ch] * wgt
            del vals

    if warp_size == 2 * OUT_SIZE:
        # INTER_AREA 64 -> 32 is an exact 2x2 box average, per channel
        outs = [acc.reshape(k, OUT_SIZE, 2, OUT_SIZE, 2).mean(dim=(2, 4)) for acc in accs]
    else:
        outs = [acc.reshape(k, OUT_SIZE, OUT_SIZE) for acc in accs]
    return torch.stack(outs, dim=-1).reshape(k, OUT_SIZE * OUT_SIZE * channels)


def warp_patches_chunk(levels, level_idx, ainv, interpolation: str = "cubic",
                       warp_size: int = WARP_SIZE):
    """levels (L, h, w, C) f32 -> (k, 32*32*C) patches of one chunk."""
    _, h, w, c = levels.shape
    return _warp_chunk(quad_rows_from_levels(levels), h, w, c, level_idx, ainv,
                       interpolation, warp_size)


def warp_patches_chunk_quads(quad_rows, h: int, w: int, level_idx, ainv,
                             interpolation: str = "cubic", warp_size: int = WARP_SIZE):
    """A chunk from prebuilt quad rows (built once per octave)."""
    return _warp_chunk(quad_rows, h, w, quad_rows.shape[1] // 4, level_idx, ainv,
                       interpolation, warp_size)


def warp_patches_level(levels, level_idx, ainv, interpolation: str = "cubic"):
    """levels (L, H, W, C) f32, level_idx (K,), ainv (K, 2, 3) ->
    (K, 32, 32, C) f32 in 0..255 (the caller normalizes), warped at 64x64
    in chunks."""
    kcount = level_idx.shape[0]
    _, h, w, c = levels.shape
    quads = quad_rows_from_levels(levels)
    chunk = _chunk_for(WARP_SIZE, c, levels.device)
    outs = [_warp_chunk(quads, h, w, c, level_idx[i:i + chunk], ainv[i:i + chunk],
                        interpolation)
            for i in range(0, kcount, chunk)]
    return torch.cat(outs).reshape(kcount, OUT_SIZE, OUT_SIZE, c)


def extract_patches_device(pyramid, kp: KeypointArrays, out_bucket: int,
                           interpolation: str = "cubic", warp_size: int = WARP_SIZE):
    """All keypoints of one image -> (out_bucket, 32*32*C) f32 patches in
    [0, 1] on the pyramid's device; rows past the keypoints, keypoints past
    out_bucket and keypoints of an octave the pyramid lacks stay 0.

    pyramid: a sequence of (6, H_o, W_o, C) octaves of one image. The host
    groups keypoints by octave; each octave's quad rows are built once and
    its keypoints warped in chunks, each written to its rows of the output
    (only the chunk's real rows: nothing is written out of range)."""
    n = len(kp)
    ch = int(pyramid[0].shape[-1]) if len(pyramid) else 3
    dev = pyramid[0].device if len(pyramid) else torch.device("cpu")
    out = torch.zeros((out_bucket, OUT_SIZE * OUT_SIZE * ch), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    ainv = inverse_affines(kp)
    oct_index = kp.octave + 1  # firstOctave = -1
    chunk = _chunk_for(warp_size, ch, dev)
    for o in range(len(pyramid)):
        sel = np.nonzero(oct_index == o)[0]
        sel = sel[sel < out_bucket]
        if sel.size == 0:
            continue
        lvh, lvw = int(pyramid[o].shape[1]), int(pyramid[o].shape[2])
        quads = quad_rows_from_levels(pyramid[o])
        lv = torch.from_numpy(kp.layer[sel].astype(np.int64)).to(dev)
        av = torch.from_numpy(ainv[sel]).to(dev)
        rows = torch.from_numpy(sel).to(dev)
        for i in range(0, sel.size, chunk):
            out[rows[i:i + chunk]] = warp_patches_chunk_quads(
                quads, lvh, lvw, lv[i:i + chunk], av[i:i + chunk], interpolation, warp_size)
    return out / 255.0


def extract_patches(pyramid, kp: KeypointArrays, interpolation: str = "cubic") -> np.ndarray:
    """Host-output variant of extract_patches_device: (N, 32, 32, C)."""
    n = len(kp)
    ch = int(pyramid[0].shape[-1]) if len(pyramid) else 3
    if n == 0:
        return np.zeros((0, OUT_SIZE, OUT_SIZE, ch), np.float32)
    dev = extract_patches_device(pyramid, kp, bucket_size(n, KP_BUCKETS), interpolation)
    return dev[:n].cpu().numpy().reshape(n, OUT_SIZE, OUT_SIZE, ch)
