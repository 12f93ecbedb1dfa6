"""Dense descriptors: CAR-HyNet run convolutionally over pyramid levels.

Port of ``gims_tpu/frontend/dense.py``. Instead of warping one patch per
keypoint, the same CAR-HyNet weights run over whole keypoint-bearing
pyramid levels, giving a stride-4 map of 128-d descriptors per (octave,
layer); each keypoint then samples its map bilinearly (4 gathered rows).

Geometry: a keypoint (pt, octave, layer, scale) reads level coordinates
p = pt * scale (as ``patches.inverse_affines``); the map is stride 4 with a
+2 px centre offset from the SAME-padded 8x8 head, so map coordinates are
m = (p - 2) / 4. Patch mode's rotation to the keypoint's angle is dropped:
the descriptors are trained rotation-robust.

``DenseDescriptorFrontend`` runs the colour model over layers 1..3 of the
colour pyramid in f32. ``DenseGrayDescriptorFrontend`` runs the
single-channel model over the gray detection pyramid (2x upsample and
initial blur) from octave 1 on, in ``dtype`` (bf16 by default, as the JAX
package), and octave-0 keypoints sample octave 1 at halved coordinates:
the geometry of the fused dense_gray path.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from gims_tpu_torch.carhynet.convert import load_variables as load_into
from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.frontend.sift import KeypointArrays

# keypoints live in layers 1..3 (OpenCV localizes extrema between layers 1
# and nOctaveLayers)
KP_LAYERS: Tuple[int, ...] = (1, 2, 3)
MIN_LEVEL_SIDE = 16  # octaves smaller than this get no maps
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def map_dims(h: int, w: int) -> Tuple[int, int]:
    """Output dims of the stride-4 dense map for an (h, w) level."""
    h2, w2 = -(-h // 2), -(-w // 2)
    return -(-h2 // 2), -(-w2 // 2)


def dense_meta(pyramid_shapes: Sequence[Tuple[int, int]]):
    """Row offsets of each (octave, layer) map inside the flat buffer.

    pyramid_shapes: [(H_o, W_o)] per octave, largest first. Returns
    (offsets (n_oct, len(KP_LAYERS)) int64, dims [(mh, mw)], total_rows)
    over the octaves up to the first smaller than MIN_LEVEL_SIDE."""
    offsets, dims, total = [], [], 0
    for (h, w) in pyramid_shapes:
        if min(h, w) < MIN_LEVEL_SIDE:
            break
        mh, mw = map_dims(h, w)
        row = []
        for _ in KP_LAYERS:
            row.append(total)
            total += mh * mw
        offsets.append(row)
        dims.append((mh, mw))
    return np.asarray(offsets, np.int64), dims, total


def dense_model(variables, in_channels: int, device: torch.device, dtype=torch.float32,
                weights_from=None) -> CARHyNet:
    """The dense CAR-HyNet with flax `variables` (numpy tree), or, without
    them, the weights of the module `weights_from` (a patch-mode CARHyNet)."""
    model = CARHyNet(dense=True, in_channels=in_channels)
    if variables is not None:
        load_into(model, variables)
    elif weights_from is not None:
        model.load_state_dict(weights_from.state_dict())
    model = model.to(device, dtype).eval()
    if device.type == "cuda":  # NHWC convolutions, as the fused path
        model = model.to(memory_format=torch.channels_last)
    return model


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """x in channels-last memory on the card (cuDNN's NHWC kernels)."""
    return x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x


@torch.no_grad()
def dense_feature_maps(pyramid, model: CARHyNet, dtype=torch.float32) -> torch.Tensor:
    """The dense model over layers 1..3 of every octave of one image, from
    the largest down to the first smaller than MIN_LEVEL_SIDE.

    pyramid: a sequence of (L >= 4, H_o, W_o, C) f32 level stacks in 0..255
    (``pyramid.pyramid_from_uint8``). Returns the flat (total_rows, D)
    descriptor-map buffer of ``dense_meta``'s layout."""
    chunks = []
    for lv in pyramid:
        if min(int(lv.shape[1]), int(lv.shape[2])) < MIN_LEVEL_SIDE:
            break
        levels = lv[KP_LAYERS[0]:KP_LAYERS[-1] + 1].to(dtype) / 255.0
        maps = model(_nhwc(levels.permute(0, 3, 1, 2)))     # (3, mh, mw, D)
        chunks.append(maps.reshape(-1, maps.shape[-1]))
    return torch.cat(chunks)


def _bilinear_plan(n, nb, base, mh, mw, p, ok=None):
    """(nb, 4) tap rows and weights of map coordinates (p - 2) / 4, taps
    clamped to the map; weights 0 where `ok` is False."""
    rows = np.zeros((nb, 4), np.int64)
    wts = np.zeros((nb, 4), np.float32)
    mx = (p[:, 0] - 2.0) / 4.0
    my = (p[:, 1] - 2.0) / 4.0
    x0 = np.floor(mx)
    y0 = np.floor(my)
    fx = (mx - x0).astype(np.float32)
    fy = (my - y0).astype(np.float32)
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)
    for t, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        xx = np.clip(x0 + dx, 0, mw - 1)
        yy = np.clip(y0 + dy, 0, mh - 1)
        rows[:n, t] = base + yy * mw + xx
        wx = (1.0 - fx) if dx == 0 else fx
        wy = (1.0 - fy) if dy == 0 else fy
        wts[:n, t] = wx * wy if ok is None else np.where(ok, wx * wy, 0.0)
    return rows.astype(np.int32), wts


def sample_plan(kp: KeypointArrays, offsets: np.ndarray,
                dims: List[Tuple[int, int]], nb: int):
    """Host-side gather plan: (nb, 4) int32 tap rows and (nb, 4) f32
    weights. Keypoints of an octave without maps get zero weights (their
    descriptor is 0)."""
    n = min(len(kp), nb)
    if n == 0:
        return np.zeros((nb, 4), np.int32), np.zeros((nb, 4), np.float32)
    o_idx = (kp.octave[:n] + 1).astype(np.int64)
    layer = np.clip(kp.layer[:n], KP_LAYERS[0], KP_LAYERS[-1]) - KP_LAYERS[0]
    ok = (o_idx >= 0) & (o_idx < len(dims))
    o_safe = np.clip(o_idx, 0, len(dims) - 1)
    mh = np.asarray([d[0] for d in dims], np.int64)[o_safe]
    mw = np.asarray([d[1] for d in dims], np.int64)[o_safe]
    p = kp.pt[:n] * kp.scale[:n, None]       # level coordinates
    return _bilinear_plan(n, nb, offsets[o_safe, layer], mh, mw, p, ok)


def sample_plan_gray(kp: KeypointArrays, offsets: np.ndarray,
                     dims: List[Tuple[int, int]], nb: int, first: int):
    """Gather plan of the dense_gray geometry: maps exist for octaves
    `first`..`first + len(dims) - 1`; a keypoint outside that range samples
    the nearest octave src that has maps, at p = pt * 2^(1 - src)."""
    n = min(len(kp), nb)
    if n == 0:
        return np.zeros((nb, 4), np.int32), np.zeros((nb, 4), np.float32)
    o_idx = (kp.octave[:n] + 1).astype(np.int64)
    layer = np.clip(kp.layer[:n], KP_LAYERS[0], KP_LAYERS[-1]) - KP_LAYERS[0]
    src = np.clip(o_idx, first, first + len(dims) - 1)
    mh = np.asarray([d[0] for d in dims], np.int64)[src - first]
    mw = np.asarray([d[1] for d in dims], np.int64)[src - first]
    p = kp.pt[:n] * (2.0 ** (1 - src))[:, None]   # octave-src level coordinates
    return _bilinear_plan(n, nb, offsets[src - first, layer], mh, mw, p)


def gather_descriptors(buffer: torch.Tensor, rows, wts) -> torch.Tensor:
    """(R, D) buffer + (nb, 4) host taps and weights -> (nb, D) descriptors,
    L2-normalized."""
    dev = buffer.device
    rows = torch.from_numpy(np.asarray(rows, np.int64)).to(dev)
    wts = torch.from_numpy(np.asarray(wts, np.float32)).to(dev)
    taps = buffer[rows.reshape(-1)].reshape(rows.shape[0], 4, -1).float()
    d = torch.sum(taps * wts[:, :, None], dim=1)
    return d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-10)


class DenseDescriptorFrontend:
    """Colour dense descriptors at given keypoints, in f32, on `device`
    (``cuda`` unless the caller passes another)."""

    def __init__(self, variables, dim_desc: int = 128, device=None, weights_from=None):
        self.dim_desc = dim_desc
        self.device = resolve_device(device)
        self.model = dense_model(variables, 3, self.device, torch.float32, weights_from)

    def compute(self, pyramid, kp: KeypointArrays, nb: int) -> torch.Tensor:
        """The colour pyramid of one image (on the device) + keypoints ->
        (nb, dim_desc) descriptors on the device."""
        shapes = [(int(p.shape[1]), int(p.shape[2])) for p in pyramid]
        offsets, dims, _ = dense_meta(shapes)
        buffer = dense_feature_maps(pyramid, self.model)
        return gather_descriptors(buffer, *sample_plan(kp, offsets, dims, nb))


class DenseGrayDescriptorFrontend:
    """dense_gray descriptors at given keypoints with the fused extractor's
    geometry: the in_channels=1 CAR-HyNet over layers 1..3 of the gray
    detection pyramid's octaves 1.. (octave 0 when there is only one),
    while an octave is at least 16 px on its short side. Runs on `device`
    (``cuda`` unless the caller passes another)."""

    def __init__(self, variables, dim_desc: int = 128, dtype: str = "bfloat16",
                 device=None, weights_from=None):
        self.dim_desc = dim_desc
        self.dtype = _DTYPES[dtype]
        self.device = resolve_device(device)
        self.model = dense_model(variables, 1, self.device, self.dtype, weights_from)

    @staticmethod
    def meta(h: int, w: int):
        """(offsets, dims, first) for an (h, w) input image."""
        from gims_tpu_torch.frontend.pyramid import num_octaves

        n_oct = num_octaves(2 * h, 2 * w)
        shapes = []
        hh, ww = 2 * h, 2 * w
        for _ in range(n_oct):
            shapes.append((hh, ww))
            # the next octave is this one at [::2, ::2] (ceil halving)
            hh, ww = (hh + 1) // 2, (ww + 1) // 2
        first = 1 if n_oct > 1 else 0
        offsets, dims, _ = dense_meta(shapes[first:])
        return offsets, dims, first

    @torch.no_grad()
    def maps(self, image_u8: torch.Tensor) -> torch.Tensor:
        """One uint8 (H, W, 3) BGR or (H, W) gray image on the device -> the
        flat descriptor-map buffer."""
        from gims_tpu_torch.frontend.detect_device import gray_pyramid

        octs = gray_pyramid(image_u8[None], upsample=True)
        first = 1 if len(octs) > 1 else 0
        chunks = []
        for g in octs[first:]:
            if min(int(g.shape[-2]), int(g.shape[-1])) < MIN_LEVEL_SIDE:
                break
            levels = g[0, 1:4, None].to(self.dtype) / 255.0
            m = self.model(_nhwc(levels))
            chunks.append(m.reshape(-1, m.shape[-1]))
        return torch.cat(chunks)

    def compute(self, image_u8, kp: KeypointArrays, nb: int) -> torch.Tensor:
        """One image (a host array or a tensor) + host keypoints ->
        (nb, dim_desc) descriptors on the model's device."""
        dev = next(self.model.parameters()).device
        image_u8 = torch.as_tensor(np.asarray(image_u8) if not torch.is_tensor(image_u8)
                                   else image_u8).to(dev)
        h, w = int(image_u8.shape[0]), int(image_u8.shape[1])
        offsets, dims, first = self.meta(h, w)
        return gather_descriptors(self.maps(image_u8),
                                  *sample_plan_gray(kp, offsets, dims, nb, first))
