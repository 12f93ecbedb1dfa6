"""DoG keypoint detection on the device, for batches of images.

Port of ``gims_tpu/frontend/detect_device.py``, the fused paths' candidate
maps and the staged path's per-image detector (``detect_device``):

  1. gray base (BGR2GRAY weights, or an already-gray image), optional 2x
     bilinear upsample (OpenCV firstOctave = -1), initial blur to sigma 1.6;
  2. the Gaussian pyramid, 6 layers per octave, each octave seeded by the
     2x-subsampled layer 3 of the one before;
  3. DoG; 26-neighbour extrema by 3x3 max/min pooling over scale triplets;
  4. one dense Newton step of the 3x3x3 quadratic fit per pixel with
     OpenCV's contrast and edge tests;
  5. an orientation per pixel of detection layers 1..3 from
     Gaussian-smoothed central gradients (``_orientation_maps``);
  6. for the staged path, a top-k per octave by |contrast|, then a global
     top-k to the keypoint budget (``detect_device_padded``).

The blurs are separable f32 convolutions with REFLECT_101 borders
(``pyramid.sep_blur``, TF32 off). The JAX package runs them as banded
matmuls (``frontend/blurmat.py``): the same function to f32 rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.frontend.pyramid import (
    N_OCTAVE_LAYERS,
    SIGMA,
    blur_sigmas,
    gaussian_kernel_1d,
    num_octaves,
    sep_blur,
    upsample2x,
)

IMG_BORDER = 5  # OpenCV SIFT_IMG_BORDER


def gray_kernels(upsample: bool = True):
    """1-D kernels of the detection pyramid's blur chain: index 0 = the
    initial blur to sigma on the base grid (doubled when upsample, else
    the input grid with an assumed camera sigma of 0.5), 1..5 = the
    incremental sigmas."""
    base_var = 4 * 0.25 if upsample else 0.25
    sig_diff = math.sqrt(max(SIGMA**2 - base_var, 0.01))
    return [gaussian_kernel_1d(sig_diff)] + [
        gaussian_kernel_1d(s) for s in blur_sigmas()[1:]
    ]


def gray_pyramid(images_u8: torch.Tensor, upsample: bool = True):
    """uint8 (B, H, W) gray, or (B, H, W, 3) BGR -> list of (B, 6, Ho, Wo)
    f32 octaves (OpenCV SIFT's detection pyramid)."""
    if images_u8.dim() == 3:
        gray = images_u8.float()
    else:
        bgr = images_u8.float()
        gray = 0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2]
    base = upsample2x(gray) if upsample else gray
    kerns = gray_kernels(upsample)
    img = sep_blur(base, kerns[0])
    octaves = []
    for _ in range(num_octaves(*base.shape[1:])):
        layers = [img]
        for i in range(1, N_OCTAVE_LAYERS + 3):
            layers.append(sep_blur(layers[-1], kerns[i]))
        octaves.append(torch.stack(layers, dim=1))
        img = layers[N_OCTAVE_LAYERS][:, ::2, ::2]
    return octaves


def _pool3(x: torch.Tensor, op: str) -> torch.Tensor:
    """3x3 window max/min over the last two axes of (B, L, H, W); the
    window's outside counts as -inf for max and +inf for min (SAME)."""
    if op == "max":
        return F.max_pool2d(x, 3, stride=1, padding=1)
    return -F.max_pool2d(-x, 3, stride=1, padding=1)


def _octave_candidates(gauss: torch.Tensor, contrast_threshold: float,
                       edge_threshold: float, ori=None):
    """Dense per-pixel extrema fit for one octave of a batch.

    gauss (B, 6, H, W). Returns a dict of (B, 3, H, W) maps: score
    (|contrast|, -1 where rejected), offx, offy, offs, and "angle" = `ori`
    where the caller passes orientation maps. Derivatives wrap
    around the image edges (``torch.roll``, as ``jnp.roll``); the
    IMG_BORDER mask rejects every pixel the wrap reaches."""
    dog = gauss[:, 1:] - gauss[:, :-1]            # (B, 5, H, W)
    hh, wh = dog.shape[-2:]
    d0, d1, d2 = dog[:, :-2], dog[:, 1:-1], dog[:, 2:]
    nb_max = torch.maximum(torch.maximum(_pool3(d0, "max"), _pool3(d1, "max")),
                           _pool3(d2, "max"))
    nb_min = torch.minimum(torch.minimum(_pool3(d0, "min"), _pool3(d1, "min")),
                           _pool3(d2, "min"))
    # prefilter threshold (OpenCV: cvFloor(0.5*ct/nLayers*255))
    thr = float(np.floor(0.5 * contrast_threshold / N_OCTAVE_LAYERS * 255.0))
    is_ext = ((d1 >= nb_max) & (d1 > thr)) | ((d1 <= nb_min) & (d1 < -thr))

    def sh(x, dy, dx):
        return torch.roll(x, shifts=(-dy, -dx), dims=(-2, -1))

    dx = (sh(d1, 0, 1) - sh(d1, 0, -1)) * 0.5
    dy = (sh(d1, 1, 0) - sh(d1, -1, 0)) * 0.5
    ds = (d2 - d0) * 0.5
    dxx = sh(d1, 0, 1) + sh(d1, 0, -1) - 2 * d1
    dyy = sh(d1, 1, 0) + sh(d1, -1, 0) - 2 * d1
    dss = d2 + d0 - 2 * d1
    dxy = (sh(d1, 1, 1) - sh(d1, 1, -1) - sh(d1, -1, 1) + sh(d1, -1, -1)) * 0.25
    dxs = (sh(d2, 0, 1) - sh(d2, 0, -1) - sh(d0, 0, 1) + sh(d0, 0, -1)) * 0.25
    dys = (sh(d2, 1, 0) - sh(d2, -1, 0) - sh(d0, 1, 0) + sh(d0, -1, 0)) * 0.25

    # offset = -H^{-1} g by the adjugate (H symmetric 3x3)
    c00 = dyy * dss - dys * dys
    c01 = dxs * dys - dxy * dss
    c02 = dxy * dys - dxs * dyy
    c11 = dxx * dss - dxs * dxs
    c12 = dxy * dxs - dxx * dys
    c22 = dxx * dyy - dxy * dxy
    det = dxx * c00 + dxy * c01 + dxs * c02
    safe = torch.where(det.abs() > 1e-12, det, 1.0)
    offx = -(c00 * dx + c01 * dy + c02 * ds) / safe
    offy = -(c01 * dx + c11 * dy + c12 * ds) / safe
    offs = -(c02 * dx + c12 * dy + c22 * ds) / safe
    converged = ((offx.abs() < 0.5) & (offy.abs() < 0.5) & (offs.abs() < 0.5)
                 & (det.abs() > 1e-12))

    contr = (d1 + 0.5 * (dx * offx + dy * offy + ds * offs)) / 255.0
    contrast_ok = contr.abs() * N_OCTAVE_LAYERS >= contrast_threshold
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    e = edge_threshold
    edge_ok = (det2 > 0) & (tr * tr * e < (e + 1) * (e + 1) * det2)

    yy = torch.arange(hh, device=gauss.device)[:, None]
    xx = torch.arange(wh, device=gauss.device)[None, :]
    inside = ((yy >= IMG_BORDER) & (yy < hh - IMG_BORDER)
              & (xx >= IMG_BORDER) & (xx < wh - IMG_BORDER))

    ok = is_ext & converged & contrast_ok & edge_ok & inside
    score = torch.where(ok, contr.abs(), -1.0)
    out = {"score": score, "offx": offx, "offy": offy, "offs": offs}
    if ori is not None:
        out["angle"] = ori
    return out


def _orientation_maps(gauss: torch.Tensor) -> torch.Tensor:
    """(B, 6, H, W) octave -> (B, 3, H, W) angle per pixel of detection
    layers 1..3, in degrees.

    The mean gradient smoothed by a Gaussian of sigma 1.5 * 1.6 * 2^(l/3)
    (OpenCV's SIFT_ORI_SIG_FCTR times the layer's scale), with cv2's angle
    convention: 360 - atan2(-gy, gx), y up. Central differences wrap at the
    image edge (``torch.roll``, as ``jnp.roll``); the smoothing folds
    REFLECT_101 (``pyramid.sep_blur``), the function of the JAX package's
    band matrices. ``%`` is ``torch.remainder`` (jnp's sign rule)."""
    angles = []
    for layer in range(1, N_OCTAVE_LAYERS + 1):
        g = gauss[:, layer]
        gx = (torch.roll(g, -1, dims=-1) - torch.roll(g, 1, dims=-1)) * 0.5
        gy = (torch.roll(g, -1, dims=-2) - torch.roll(g, 1, dims=-2)) * 0.5
        kern = gaussian_kernel_1d(1.5 * SIGMA * 2.0 ** (layer / N_OCTAVE_LAYERS))
        ori = torch.rad2deg(torch.atan2(-sep_blur(gy, kern), sep_blur(gx, kern)))
        angles.append(torch.remainder(360.0 - torch.remainder(ori, 360.0), 360.0))
    return torch.stack(angles, dim=1)


def top_k_stable(score: torch.Tensor, k: int):
    """Top k of each row of (B, N), ties by lower index first, as
    ``jax.lax.top_k``: a stable descending sort, so the order of equal
    scores never depends on the device's selection algorithm. It also
    serves ``topk_impl="approx"``: ``jax.lax.approx_max_k`` has no PyTorch
    counterpart (XLA lowers it to an exact top-k off the TPU), so the port
    selects exactly and claims no recall figure for it."""
    vals, idx = torch.sort(score, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def detect_device_padded(images_u8: torch.Tensor, max_keypoints: int,
                         contrast_threshold: float = 0.001,
                         edge_threshold: float = 80.0):
    """Full detection of a batch, on the images' device. uint8 (B, H, W, 3)
    BGR or (B, H, W) gray -> dict of padded (B, K) tensors, K =
    max_keypoints: pt (B, K, 2) input-image xy, size, angle, response (f32),
    octave (unpacked, >= -1), layer (i32), scale (f32), valid (bool).

    Each octave keeps its top min(K, 3 H_o W_o) candidates by |contrast|,
    padded to K with score -1; a global top-K over all octaves follows. Both
    selections are ``top_k_stable`` (ties by lower index, as
    ``jax.lax.top_k``). The valid keypoints form a prefix; padded entries sit
    at 1e6 with size 1, angle 0, octave 0, layer 1 and scale 1."""
    octaves = gray_pyramid(images_u8, upsample=True)
    b = images_u8.shape[0]
    k_total = max_keypoints
    vals, attrs = [], []
    for o, gauss in enumerate(octaves):
        cand = _octave_candidates(gauss, contrast_threshold, edge_threshold,
                                  _orientation_maps(gauss))
        _, _, hh, wh = cand["score"].shape
        score = cand["score"].reshape(b, -1)
        k_o = min(k_total, score.shape[1])
        top_v, top_i = top_k_stable(score, k_o)
        li = top_i // (hh * wh)
        rem = top_i % (hh * wh)
        yi = rem // wh
        xi = rem % wh

        def g(name, top_i=top_i):
            return torch.gather(cand[name].reshape(b, -1), 1, top_i)

        layer = (li + 1).int()  # detection layers are dog[1..3]
        scale_mult = float(2 ** (o - 1))  # 2^o * 0.5 (firstOctave = -1)
        px = (xi.float() + g("offx")) * scale_mult
        py = (yi.float() + g("offy")) * scale_mult
        size = SIGMA * 2.0 ** ((layer.float() + g("offs")) / N_OCTAVE_LAYERS) * float(2 ** o)
        ang = g("angle")
        if k_o < k_total:
            pad = k_total - k_o

            def padded(x, fill=0):
                return torch.cat([x, x.new_full((b, pad), fill)], dim=1)

            top_v, px, py, size, ang, layer = (
                padded(top_v, -1.0), padded(px), padded(py), padded(size),
                padded(ang), padded(layer))
        vals.append(top_v)
        attrs.append({
            "px": px, "py": py, "size": size, "angle": ang, "layer": layer,
            "octave": layer.new_full((b, k_total), o - 1),
            "scale": px.new_full((b, k_total), float(2 ** (1 - o))),
        })

    top_v, top_i = top_k_stable(torch.cat(vals, dim=1), k_total)
    stacked = {k: torch.gather(torch.cat([a[k] for a in attrs], dim=1), 1, top_i)
               for k in attrs[0]}
    valid = top_v > 0
    pt = torch.stack([stacked["px"], stacked["py"]], dim=-1)
    return {
        "pt": torch.where(valid[..., None], pt, 1e6),
        "size": torch.where(valid, stacked["size"], 1.0),
        "angle": torch.where(valid, stacked["angle"], 0.0),
        "response": torch.where(valid, top_v, 0.0),
        "octave": torch.where(valid, stacked["octave"], 0),
        "layer": torch.where(valid, stacked["layer"], 1),
        "scale": torch.where(valid, stacked["scale"], 1.0),
        "valid": valid,
    }


# the padded fields read back by detect_device after pt, the mask last
_READBACK_COLUMNS = ("size", "angle", "response", "octave", "layer", "scale", "valid")


def detect_device(image_u8: np.ndarray, max_keypoints: int,
                  contrast_threshold: float = 0.001,
                  edge_threshold: float = 80.0, device=None):
    """One host image (H, W, 3) BGR or (H, W) gray uint8 -> (KeypointArrays
    of the valid prefix, the padded dict of ``detect_device_padded`` with
    batch 1, on `device`: ``cuda`` unless the caller passes another). Reads
    the padded result back to the host in one copy, as the JAX package's
    ``device_get`` does: the fields go as the columns of one f32 array
    (octave, layer and the mask are small integers, exact in f32)."""
    from gims_tpu_torch.frontend.sift import KeypointArrays

    dev = resolve_device(device)
    img = torch.from_numpy(np.ascontiguousarray(image_u8))[None].to(dev)
    out = detect_device_padded(img, int(max_keypoints), float(contrast_threshold),
                               float(edge_threshold))
    cols = [out["pt"][0]] + [out[k][0, :, None].float() for k in _READBACK_COLUMNS]
    host = torch.cat(cols, dim=1).cpu().numpy()
    m = host[:, -1] > 0
    f = {k: host[m, 2 + i] for i, k in enumerate(_READBACK_COLUMNS)}
    kp = KeypointArrays(pt=np.ascontiguousarray(host[m, :2]), size=f["size"],
                        angle=f["angle"], response=f["response"],
                        octave=f["octave"].astype(np.int32),
                        layer=f["layer"].astype(np.int32), scale=f["scale"])
    return kp, out
