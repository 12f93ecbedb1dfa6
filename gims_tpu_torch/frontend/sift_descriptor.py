"""SIFT descriptors on the device, for batches of keypoints.

Port of ``gims_tpu/frontend/sift_descriptor.py``: the fused devsift
path's chunks, and ``describe_device`` for the staged path's keypoints.
OpenCV's calcSIFTDescriptor walks every integer pixel within a rotated,
scale-proportional radius and votes gradient magnitudes trilinearly into a
4x4x8 histogram; a radius that depends on the keypoint is a shape that
depends on the data, so the walk becomes a fixed S x S grid of samples,
uniform in the rotated histogram frame:

  1. gradient maps of pyramid layers 1..3 (cv2's differences, zero on the
     border ring), stored as "quad blocks": entry (l, qy, qx) holds the 2x2
     pixel block at (qy - 1, qx - 1), zero outside the image, so one
     gathered row of 8 values holds a bilinear sample's four taps;
  2. per keypoint, S^2 sample positions px + 3 scl R(ori) grid over
     (-2.5, 2.5) histogram units, each sampled bilinearly;
  3. orientation bins (angle - ori) * 8/360 with wraparound, and a Gaussian
     weight fixed per grid position;
  4. the spatial trilinear vote is a constant (S^2, 16) matrix, so the
     histogram is one matrix product;
  5. cv2's finalization: clip at 0.2 of the norm, rescale to 512 / norm,
     round, clamp to [0, 255].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gims_tpu_torch.frontend.patches import quad_blocks_from_levels  # noqa: F401
from gims_tpu_torch.frontend.pyramid import device_constant

D = 4                 # SIFT_DESCR_WIDTH
NBINS = 8             # SIFT_DESCR_HIST_BINS
SCL_FCTR = 3.0        # SIFT_DESCR_SCL_FCTR
MAG_THR = 0.2         # SIFT_DESCR_MAG_THR
INT_FCTR = 512.0      # SIFT_INT_DESCR_FCTR
FLT_EPSILON = 1.19209e-07
SAMPLES = 16          # default sample-grid side S: S/5 samples per bin axis
DESC_CHUNK = 1024     # keypoints per chunk


def grad_levels(gauss: torch.Tensor) -> torch.Tensor:
    """(B, 6, H, W) gray octave -> (B, 3, H, W, 2) gradients of layers 1..3:
    dx = I(r, c+1) - I(r, c-1), dy = I(r-1, c) - I(r+1, c) (y up), on
    r, c in [1, rows - 2] only; the border ring is zero, so samples there
    add nothing (cv2 skips them)."""
    g = gauss[:, 1:4]
    dx = torch.zeros_like(g)
    dy = torch.zeros_like(g)
    dx[..., 1:-1] = g[..., 2:] - g[..., :-2]
    dy[..., 1:-1, :] = g[..., :-2, :] - g[..., 2:, :]
    dx[..., 0, :] = 0.0
    dx[..., -1, :] = 0.0
    dy[..., 0] = 0.0
    dy[..., -1] = 0.0
    return torch.stack([dx, dy], dim=-1)


@functools.lru_cache(maxsize=8)
def _grid_constants(s: int):
    """Per grid position: rotated-frame coordinates (x fastest), Gaussian
    weight, and the (S^2, 16) spatial trilinear vote matrix."""
    u = ((np.arange(s) + 0.5) * (2.0 * (D + 1) / 2.0 / s)
         - (D + 1) / 2.0).astype(np.float32)          # (-2.5, 2.5)
    c_rot = np.tile(u, s)
    r_rot = np.repeat(u, s)
    w = np.exp(-(c_rot**2 + r_rot**2) / (0.5 * D * D)).astype(np.float32)
    rbin = r_rot + D / 2 - 0.5
    cbin = c_rot + D / 2 - 0.5
    m = np.zeros((s * s, D * D), np.float32)
    for r in range(D):
        wr = np.maximum(0.0, 1.0 - np.abs(rbin - r))
        for c in range(D):
            wc = np.maximum(0.0, 1.0 - np.abs(cbin - c))
            m[:, r * D + c] = wr * wc
    return c_rot, r_rot, w, m


def _finalize(desc: torch.Tensor) -> torch.Tensor:
    """cv2's normalization: clip at 0.2 * ||v||, rescale to 512 / ||v'||,
    round half to even, clamp to [0, 255]."""
    nrm = torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True))
    desc = torch.minimum(desc, MAG_THR * nrm)
    nrm2 = torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True))
    sf = INT_FCTR / torch.clamp(nrm2, min=FLT_EPSILON)
    return torch.clamp(torch.round(desc * sf), 0.0, 255.0)


def _descr_chunk(grad_quads, h: int, w: int, level_idx, px, py, scl, angle, valid,
                 s: int = SAMPLES):
    """A chunk of keypoints of every image -> (B, k, 128) descriptors.

    grad_quads (B, 3, h+1, w+1, 8): quad blocks of a (B, 3, h, w, 2)
    gradient stack. level_idx, px, py, scl, angle, valid (B, k): layer - 1,
    octave pixel coordinates, the keypoint sigma in octave pixels
    (size * 0.5), cv2's angle in degrees, and 1.0 / 0.0."""
    b, k = px.shape
    dev = px.device
    c_rot, r_rot, gw, m = (device_constant(("sift_grid", s, i), dev,
                                           lambda i=i: _grid_constants(s)[i])
                           for i in range(4))
    ori = 360.0 - angle
    ori = torch.where((ori - 360.0).abs() < FLT_EPSILON, 0.0, ori)
    orad = torch.deg2rad(ori)
    cos_t = torch.cos(orad)[..., None]
    sin_t = torch.sin(orad)[..., None]
    hist_width = (SCL_FCTR * scl)[..., None]

    # sample positions: [x; y] = R(ori)^T [c_rot; r_rot] * hist_width
    sx = px[..., None] + hist_width * (cos_t * c_rot + sin_t * r_rot)
    sy = py[..., None] + hist_width * (-sin_t * c_rot + cos_t * r_rot)
    fx = torch.floor(sx)
    fy = torch.floor(sy)
    tx = sx - fx
    ty = sy - fy
    # one quad block holds the 2x2 bilinear taps
    qy = fy.int() + 1
    qx = fx.int() + 1
    ok = (qy >= 0) & (qy <= h) & (qx >= 0) & (qx <= w)
    rows = ((torch.arange(b, device=dev)[:, None, None] * grad_quads.shape[1]
             + level_idx[..., None]) * (h + 1) + qy.clamp(0, h)) * (w + 1) + qx.clamp(0, w)
    vals = grad_quads.reshape(-1, grad_quads.shape[-1])[rows.long()]  # (B, k, S^2, 8)
    okf = ok.float()
    w00 = (1.0 - ty) * (1.0 - tx) * okf
    w01 = (1.0 - ty) * tx * okf
    w10 = ty * (1.0 - tx) * okf
    w11 = ty * tx * okf
    gdx = vals[..., 0] * w00 + vals[..., 2] * w01 + vals[..., 4] * w10 + vals[..., 6] * w11
    gdy = vals[..., 1] * w00 + vals[..., 3] * w01 + vals[..., 5] * w10 + vals[..., 7] * w11

    mag = torch.sqrt(gdx * gdx + gdy * gdy)
    grad_deg = torch.remainder(torch.rad2deg(torch.atan2(gdy, gdx)), 360.0)
    obin = (grad_deg - ori[..., None]) * (NBINS / 360.0)
    o0 = torch.floor(obin)
    fo = obin - o0
    o0i = torch.remainder(o0.long(), NBINS)
    contrib = mag * gw
    # each sample votes into two adjacent orientation bins
    votes = torch.zeros(contrib.shape + (NBINS,), dtype=torch.float32, device=dev)
    votes.scatter_(-1, o0i[..., None], (contrib * (1.0 - fo))[..., None])
    votes.scatter_(-1, torch.remainder(o0i + 1, NBINS)[..., None], (contrib * fo)[..., None])
    desc = torch.matmul(votes.transpose(-1, -2), m)          # (B, k, 8, 16)
    desc = desc.transpose(-1, -2).reshape(b, k, D * D * NBINS)  # (r*4+c)*8+o, cv2's order
    return _finalize(desc) * valid[..., None]


def describe_device(pyramid_gray, kp, out_bucket: int, s: int = SAMPLES) -> torch.Tensor:
    """All keypoints of one image -> (out_bucket, 128) f32 SIFT descriptors
    (cv2's integer range) on the pyramid's device; rows past the keypoints
    stay 0.

    pyramid_gray: the (6, H_o, W_o) gray octaves of one image (the detection
    pyramid, firstOctave = -1: index = kp.octave + 1). The host groups the
    keypoints by octave; each octave's f32 gradient table is built once and
    its keypoints described in chunks of DESC_CHUNK, each written to its rows
    of the output."""
    n = len(kp)
    dev = pyramid_gray[0].device
    out = torch.zeros((out_bucket, D * D * NBINS), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    oct_index = kp.octave + 1
    cols = np.stack([kp.layer - 1.0, kp.pt[:, 0] * kp.scale, kp.pt[:, 1] * kp.scale,
                     kp.size * kp.scale * 0.5, kp.angle]).astype(np.float32)
    for o in range(len(pyramid_gray)):
        sel = np.nonzero(oct_index == o)[0]
        sel = sel[sel < out_bucket]
        if sel.size == 0:
            continue
        gauss = pyramid_gray[o][None]
        quads = quad_blocks_from_levels(grad_levels(gauss))
        lvh, lvw = gauss.shape[-2:]
        c = torch.from_numpy(cols[:, sel]).to(dev)
        lv = c[0].int()
        rows = torch.from_numpy(sel).to(dev)
        for i in range(0, sel.size, DESC_CHUNK):
            part = slice(i, i + DESC_CHUNK)
            px, py, scl, ang = (x[None, part] for x in c[1:])
            out[rows[part]] = _descr_chunk(quads, lvh, lvw, lv[None, part], px, py, scl, ang,
                                           torch.ones_like(px), s)[0]
    return out
