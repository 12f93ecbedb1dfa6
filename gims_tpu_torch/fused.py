"""Fused pair matching: uint8 image pairs in, matches out.

Port of ``gims_tpu/fused.py``. A batch of pairs goes through each stage as
one batch:

  gray pyramid -> dense DoG candidates (frontend/detect_device.py)
  -> per-octave top-k keypoint budgets (static shapes, masks for validity)
  -> descriptors, by `descriptor_source`:
     "carhynet" (the default, the reference's frontend): orientation maps,
       the colour pyramid, the affine patch warp of every keypoint
       (frontend/patches.py), then CAR-HyNet over all the patches;
     "dense": the colour CAR-HyNet over layers 1..3 of every octave of the
       colour pyramid (4 layers per octave), fully convolutionally, and
       bilinear sampling at the keypoints;
     "dense_gray": the gray CAR-HyNet over the detection pyramid's layers
       1..3 of each octave, and bilinear sampling;
     "devsift": orientation maps, then SIFT descriptors from the
       pyramid's gradients (frontend/sift_descriptor.py), no CNN;
  -> AGC (dense or band build) -> trunk compaction to the kept keypoints
  -> GMatcher (K1 once per GNN layer) -> Sinkhorn (K2) -> mutual-max
  extraction.

Per-octave budgets replace a global response sort: octave o gets a fixed
share of the keypoint budget, its candidates are picked by within-octave
top-k, and downstream masks treat the concatenation as any padded keypoint
set. The colour sources take (B, H, W, 3) BGR images and need the
2x-upsampled base. The multi-device split is not ported yet and raises.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from gims_tpu_torch.carhynet.convert import load_variables as load_car_variables
from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.agc.graph import check_impls
from gims_tpu_torch.config import AGCConfig, FrontendConfig, MatcherConfig
from gims_tpu_torch.core.bucketing import compact_indices
from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.frontend.detect_device import (
    _octave_candidates,
    _orientation_maps,
    gray_pyramid,
    top_k_stable,
)
from gims_tpu_torch.frontend.patches import (
    FLT_EPSILON,
    WARP_SIZE,
    _chunk_for,
    _warp_chunk,
    quad_blocks_from_levels,
    quad_rows_from_levels,
)
from gims_tpu_torch.frontend.pyramid import (
    N_OCTAVE_LAYERS,
    SIGMA,
    num_octaves,
    pyramid_from_uint8,
)
from gims_tpu_torch.frontend.sift_descriptor import DESC_CHUNK, _descr_chunk, grad_levels
from gims_tpu_torch.matcher import pipeline
from gims_tpu_torch.matcher.convert import load_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SOURCES = ("carhynet", "dense", "dense_gray", "devsift")
COLOUR_SOURCES = ("carhynet", "dense")
# patches per call of the patch CAR-HyNet: one activation of its first
# layers is 32 channels x 32 x 32 f32, 128 KiB a patch, so a call's
# activations stay near 2 GiB whatever the batch and keypoint budget
PATCH_CNN_CHUNK = 16384
# level pixels per call of a dense CAR-HyNet: 2^25 pixels keep one 32-channel
# activation at 2 GiB in bf16 (the colour source runs it over the
# 2x-upsampled octave of every image: 24 levels of 1200x1600 per 4 pairs)
DENSE_CNN_PIXELS = 1 << 25


def octave_budgets(h: int, w: int, total: int,
                   upsample: bool = True) -> Tuple[int, ...]:
    """Static per-octave keypoint budgets: ~4x decay, 32 minimum, summing
    to exactly `total` (remainder to octave 0, where most detections are)."""
    bh, bw = (2 * h, 2 * w) if upsample else (h, w)
    n_oct = num_octaves(bh, bw)
    raw = [max(32, total // (2 * 4**o)) for o in range(n_oct)]
    # octave areas shrink 4x per level; never budget more than the plane
    raw = [min(b, 3 * (bh >> o) * (bw >> o)) for o, b in enumerate(raw)]
    raw[0] -= sum(raw) - total
    if raw[0] < 32:
        raise ValueError(f"budget {total} too small for {n_oct} octaves")
    return tuple(raw)


def _dense_sample(maps, px, py, layer, valid,
                  dense_layers: Tuple[int, ...] = (1, 2, 3)):
    """Bilinear descriptor sampling from (B, L, mh, mw, D) dense maps (one
    map per entry of `dense_layers`; a keypoint at another layer samples
    the nearest map). px, py (B, K) are octave pixel coordinates; the
    stride-4 SAME-padded map has a +2 px centre offset. Returns (B, K, D)
    L2-normalized descriptors, 0 where `valid` (B, K) f32 is 0."""
    b, nl, mh, mw, d = maps.shape
    flat = maps.reshape(-1, d)
    # nearest map per layer value 0..4, first on ties
    lc = layer.clamp(0, 4)
    lidx = torch.zeros_like(layer)
    best = (lc - dense_layers[0]).abs()
    for j, dl in enumerate(dense_layers[1:], start=1):
        dist = (lc - dl).abs()
        lidx = torch.where(dist < best, j, lidx)
        best = torch.minimum(best, dist)
    base = torch.arange(b, device=maps.device)[:, None] * (nl * mh * mw)
    mx = (px - 2.0) / 4.0
    my = (py - 2.0) / 4.0
    x0 = torch.floor(mx)
    y0 = torch.floor(my)
    fx = mx - x0
    fy = my - y0
    acc = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xx = (x0.int() + dx).clamp(0, mw - 1)
            yy = (y0.int() + dy).clamp(0, mh - 1)
            rows = base + lidx * (mh * mw) + yy * mw + xx
            wx = (1.0 - fx) if dx == 0 else fx
            wy = (1.0 - fy) if dy == 0 else fy
            acc = acc + flat[rows.long()] * (wx * wy * valid)[..., None]
    norm = torch.sqrt(torch.sum(acc * acc, dim=-1, keepdim=True) + 1e-10)
    return acc / norm


def _device_inverse_affines(px, py, size_oct, angle):
    """``patches.inverse_affines`` on the device in octave coordinates:
    px, py in octave pixels, size_oct the keypoint size at octave resolution
    (size * scale); any leading shape -> (..., 2, 3)."""
    step = size_oct * 0.5
    ang = 360.0 - angle
    ang = torch.where((ang - 360.0).abs() < FLT_EPSILON, 0.0, ang)
    phi = torch.deg2rad(ang)
    s, c = torch.sin(phi), torch.cos(phi)
    r = (WARP_SIZE - 1) / 2.0
    l00 = c * step
    l01 = s * step
    l10 = -s * step
    l11 = c * step
    tx = px - (l00 + l01) * r
    ty = py - (l10 + l11) * r
    row0 = torch.stack([l00, l01, tx], dim=-1)
    row1 = torch.stack([l10, l11, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _warp_octave(levels, px, py, layer, offs, angle, fe: FrontendConfig):
    """Patches of one octave's keypoints (B, K) -> (B, K, 32*32*C) in
    [0, 1]. levels (B, 6, H, W, C) is the octave of the colour pyramid; the
    batch folds into the level stack of one set of quad rows, and all B*K
    keypoints are warped in chunks (the rows are independent)."""
    b, nl, h, w, c = levels.shape
    k = px.shape[1]
    size_oct = SIGMA * 2.0 ** ((layer.float() + offs) / N_OCTAVE_LAYERS) * 2.0
    ainv = _device_inverse_affines(px, py, size_oct, angle).reshape(b * k, 2, 3)
    lidx = (torch.arange(b, device=px.device)[:, None] * nl + layer).reshape(-1)
    quads = quad_rows_from_levels(levels.reshape(b * nl, h, w, c))
    chunk = _chunk_for(fe.warp_size, c, px.device)
    out = torch.cat([_warp_chunk(quads, h, w, c, lidx[i:i + chunk], ainv[i:i + chunk],
                                 fe.interpolation, fe.warp_size)
                     for i in range(0, b * k, chunk)])
    return (out / 255.0).reshape(b, k, -1)


def _patch_descriptors(car_model: CARHyNet, patches):
    """(B, T, 32*32*C) patches -> (B, T, 128) patch-mode CAR-HyNet
    descriptors, in calls of PATCH_CNN_CHUNK patches (each patch's
    statistics are its own, so the split changes nothing)."""
    b, t, _ = patches.shape
    flat = patches.reshape(b * t, 32, 32, -1).permute(0, 3, 1, 2)
    return torch.cat([car_model(flat[i:i + PATCH_CNN_CHUNK])
                      for i in range(0, b * t, PATCH_CNN_CHUNK)]).reshape(b, t, -1)


def _devsift_describe(octs, o, fe: FrontendConfig, tables, px, py, layer, offs, angle,
                      valid):
    """SIFT descriptors of octave o's keypoints (B, K) -> (B, K, 128), unit
    norm. With `dense_first_map_oct` >= 1 and the upsampled base, octave 0's
    keypoints describe from octave 1's gradients at halved coordinates and
    support (the upsampled octave holds no image content octave 1 lacks).
    The gradient table is bf16 (0..255 images lose ~0.4% relative, under
    the descriptor's integer rounding) and built once per octave into
    `tables`. Keypoints go in chunks of DESC_CHUNK."""
    share = fe.upsample and o == 0 and fe.dense_first_map_oct >= 1 and len(octs) > 1
    src = 1 if share else o
    f_sh = 0.5 if share else 1.0
    if src not in tables:
        tables[src] = quad_blocks_from_levels(grad_levels(octs[src]).to(torch.bfloat16))
    gq = tables[src]
    lvh, lvw = octs[src].shape[-2:]
    size_oct = SIGMA * 2.0 ** ((layer.float() + offs) / N_OCTAVE_LAYERS) * 2.0
    cols = [(layer - 1).int(), px * f_sh, py * f_sh, size_oct * 0.5 * f_sh, angle,
            valid.float()]
    k = px.shape[1]
    pad = -k % DESC_CHUNK
    if pad:
        fills = (0, 0.0, 0.0, 1.0, 0.0, 0.0)
        cols = [torch.cat([c, c.new_full((c.shape[0], pad), f)], dim=1)
                for c, f in zip(cols, fills)]
    chunks = [_descr_chunk(gq, lvh, lvw, *(c[:, i:i + DESC_CHUNK] for c in cols),
                           s=fe.sift_samples)
              for i in range(0, k + pad, DESC_CHUNK)]
    raw = torch.cat(chunks, dim=1)[:, :k]
    # unit-norm 128-d, what the SIFT-trained matcher weights consume
    return raw / torch.sqrt(torch.sum(raw * raw, dim=-1, keepdim=True) + 1e-10)


def _extract_side(images_u8, budgets, fe: FrontendConfig, car_model: Optional[CARHyNet]):
    """(B, H, W) uint8 gray or (B, H, W, 3) BGR images -> keypoints (B, T, 2)
    in input pixels (1e6 where invalid), scores (B, T), valid (B, T),
    descriptors (B, T, 256), T = sum(budgets).

    dense_gray: the gray CAR-HyNet runs over the detection pyramid's layers
    `fe.dense_layers` of every octave from `first_map_oct` on while the
    octave is at least 16 px on its short side; an octave without maps
    samples the nearest one that has them at scaled coordinates. With the
    2x-upsampled base, octave 0 gets no maps of its own. dense: the colour
    CAR-HyNet over layers 1..3 of every octave of the colour pyramid.
    carhynet: every keypoint's patch warped from its octave and layer of the
    colour pyramid at its orientation (the range gims.frontend.warp), then
    the patch CAR-HyNet over all of them. devsift (`car_model` None):
    orientation maps per octave and SIFT descriptors from the pyramid's
    gradients."""
    source = fe.descriptor_source
    devsift = source == "devsift"
    oriented = source in ("devsift", "carhynet")
    b = images_u8.shape[0]
    with record_function("gims.frontend.pyramid"):
        octs = gray_pyramid(images_u8, fe.upsample)
        if source in COLOUR_SOURCES:
            # dense reads layers 1..3 only; layer 3 still seeds the next octave
            octs_colour = pyramid_from_uint8(
                images_u8, N_OCTAVE_LAYERS + (1 if source == "dense" else 3))
    maps = {}
    if source in ("dense_gray", "dense"):
        ddt = _DTYPES[fe.dense_dtype]
        gray = source == "dense_gray"
        if not gray:
            first_map_oct = 0
        elif fe.upsample:
            first_map_oct = 1 if len(octs) > 1 else 0
        else:
            first_map_oct = min(fe.dense_first_map_oct, len(octs) - 1)
        layers = list(fe.dense_layers) if gray else [1, 2, 3]
        with record_function("gims.frontend.cnn"):
            for o in range(first_map_oct, len(octs)):
                ho, wo = octs[o].shape[-2:]
                if gray and min(ho, wo) < 16:
                    break
                if gray:
                    levels = octs[o][:, layers].reshape(b * len(layers), 1, ho, wo)
                else:
                    levels = octs_colour[o][:, 1:4].reshape(b * 3, ho, wo, 3).permute(0, 3, 1, 2)
                step = max(1, DENSE_CNN_PIXELS // (ho * wo))
                parts = []
                for i in range(0, levels.shape[0], step):
                    x = levels[i:i + step].to(ddt) / 255.0
                    if x.is_cuda:
                        x = x.contiguous(memory_format=torch.channels_last)
                    parts.append(car_model(x))                   # (n, mh, mw, D)
                m = torch.cat(parts) if len(parts) > 1 else parts[0]
                maps[o] = m.reshape((b, len(layers)) + m.shape[1:])

    tables = {}
    kp_list, sc_list, va_list, de_list = [], [], [], []
    for o, gauss in enumerate(octs):
        k_o = budgets[o]
        if oriented:
            with record_function("gims.frontend.orientation"):
                ori = _orientation_maps(gauss)
        with record_function("gims.frontend.detect"):
            cand = _octave_candidates(gauss, fe.contrast_threshold, fe.edge_threshold,
                                      ori if oriented else None)
            _, _, hh, wh = cand["score"].shape
            score = cand["score"].reshape(b, -1)
            k_sel = min(k_o, score.shape[1])
            # topk_impl "approx" selects exactly too (top_k_stable)
            top_v, top_i = top_k_stable(score, k_sel)
            li = top_i // (hh * wh)
            rem = top_i % (hh * wh)
            yi = rem // wh
            xi = rem % wh

            def g(name):
                return torch.gather(cand[name].reshape(b, -1), 1, top_i)

            layer = (li + 1).int()
            px = xi.float() + g("offx")                   # octave coordinates
            py = yi.float() + g("offy")
            valid = top_v > 0
        if devsift:
            with record_function("gims.frontend.describe"):
                desc = _devsift_describe(octs, o, fe, tables, px, py, layer, g("offs"),
                                         g("angle"), valid)
        elif source == "carhynet":
            with record_function("gims.frontend.warp"):
                desc = _warp_octave(octs_colour[o], px, py, layer, g("offs"), g("angle"), fe)
        else:
            with record_function("gims.frontend.sample"):
                src = min(max(o, min(maps)), max(maps))
                f = 2.0 ** (o - src)  # octave-o coordinates -> octave-src coordinates
                desc = _dense_sample(maps[src], px * f, py * f, layer, valid.float(),
                                     tuple(layers))
        scale_mult = float(2 ** (o - 1)) if fe.upsample else float(2 ** o)
        kp = torch.stack([px * scale_mult, py * scale_mult], dim=-1)
        kp = torch.where(valid[..., None], kp, 1e6)
        sc = torch.where(valid, top_v, 0.0)
        if k_sel < k_o:
            pad = k_o - k_sel
            kp = torch.cat([kp, kp.new_full((b, pad, 2), 1e6)], dim=1)
            sc = torch.cat([sc, sc.new_zeros((b, pad))], dim=1)
            valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
            desc = torch.cat([desc, desc.new_zeros((b, pad, desc.shape[-1]))], dim=1)
        kp_list.append(kp)
        sc_list.append(sc)
        va_list.append(valid)
        de_list.append(desc)

    valid = torch.cat(va_list, dim=1)
    desc = torch.cat(de_list, dim=1)
    if source == "carhynet":
        with record_function("gims.frontend.cnn"):
            desc = _patch_descriptors(car_model, desc)
    desc = torch.where(valid[..., None], torch.cat([desc, desc], dim=-1), 0.0)
    return torch.cat(kp_list, dim=1), torch.cat(sc_list, dim=1), valid, desc


def _pack(out):
    """Outputs as the JAX package's compact transport carries them:
    keypoints as 1/16-px fixed point (uint16), match indices as int16,
    scores as float16; ``collect_batch`` decodes them."""
    for s in ("0", "1"):
        out["keypoints" + s] = torch.clamp(
            out["keypoints" + s] * 16.0, 0, 65535).to(torch.int32).to(torch.uint16)
        out["matches" + s] = out["matches" + s].to(torch.int16)
        out["matching_scores" + s] = out["matching_scores" + s].to(torch.float16)
        out["scores" + s] = out["scores" + s].to(torch.float16)
    return out


@torch.no_grad()
def fused_match_batch(model: GMatcher, car_model: Optional[CARHyNet], acfg: AGCConfig,
                      fe: FrontendConfig, budgets, imgs0_u8, imgs1_u8,
                      h: int, w: int, compact_transport: bool = False,
                      compact_to: Optional[int] = None):
    """B pairs through every stage at once. imgs0_u8/imgs1_u8 are
    (B, H, W) gray or (B, H, W, 3) BGR uint8 stacks on the model's device; both sides are
    extracted as one batch of 2B images."""
    b = imgs0_u8.shape[0]
    kp, sc, va, de = _extract_side(torch.cat([imgs0_u8, imgs1_u8]), budgets, fe,
                                   car_model)
    out = pipeline.forward_match(
        model, acfg, kp[:b], de[:b], va[:b], kp[b:], de[b:], va[b:],
        image_shape=(h, w), compact_to=compact_to,
        scores0=sc[:b], scores1=sc[b:])
    out.update(keypoints0=kp[:b], keypoints1=kp[b:], scores0=sc[:b], scores1=sc[b:])
    return _pack(out) if compact_transport else out


class FusedMatching:
    """Pair matcher over uint8 images: detection, descriptors and the
    matcher in one call per batch.

    config keys mirror the JAX package's ``FusedMatching``. On CUDA the
    defaults follow the JAX accelerator branch (``gims_tpu/fused.py``): the
    bf16 trunk, the Sinkhorn kernel, the bf16 CNN, the band AGC build
    (half-width 512) with the strided threshold (stride 4) and the centroid
    reconnect (1024 buckets), ``topk_impl="approx"`` (an exact stable
    selection here, see ``detect_device.top_k_stable``) and, above 3072
    keypoints, trunk compaction to half the budget rounded up to 1024. On
    the CPU the JAX CPU defaults apply (f32 trunk, plain Sinkhorn, the
    dense exact AGC, no compaction). ``fast_frontend`` (bilinear taps,
    direct 32x32 sampling of the patch warp) defaults to on on CUDA, as on
    the JAX package's accelerator. Every knob can be set in `config`.
    `descriptor_source` is "carhynet" (the default, as in the JAX package),
    "dense", "dense_gray" or "devsift" (no CNN; `car_variables` unused); the
    colour sources, carhynet and dense, take (B, H, W, 3) BGR images and
    need ``upsample=True``. Without `variables`, the ``init_scheme`` key
    ("default" or "identity") picks the matcher's start
    (``api.init_gmatcher_variables``).
    `variables` / `car_variables` are flax variables trees of numpy arrays
    (``matcher.convert.load_gims_checkpoint``,
    ``carhynet.convert.load_car_checkpoint``); without them the networks
    are randomly initialized from `seed`.

    devices: the data-parallel split of the JAX package's ``devices=`` (a 1-D
    ``data`` mesh): an int (the first N cards) or a list of torch devices of
    one type, which may repeat a device. One replica of the matcher and of
    the CNN is kept per distinct device; ``dispatch_batch`` cuts the pair
    batch into one contiguous chunk per entry and queues each chunk on its
    device with no host sync between them, and ``collect_batch`` returns the
    pairs in input order. A batch that does not divide the count raises
    ValueError. `device` defaults to the first entry.
    """

    def __init__(self, config=None, variables=None, car_variables=None,
                 seed: int = 0, total_keypoints: int = 12288, devices=None,
                 device: Optional[str] = None):
        if devices is not None:
            if isinstance(devices, int):
                devices = [torch.device("cuda", i) for i in range(devices)]
            devices = [resolve_device(d) for d in devices]
            if not devices or len({d.type for d in devices}) != 1:
                raise ValueError(f"devices={devices}: one or more devices of one type")
        self.device = resolve_device(device if device is not None or devices is None
                                     else devices[0])
        if devices is not None and self.device.type != devices[0].type:
            raise ValueError(f"device {self.device} and devices {devices} differ in type")
        self.devices = devices
        on_cuda = self.device.type == "cuda"
        config = dict(config or {})
        source = config.get("descriptor_source", "carhynet")
        if source not in SOURCES:
            raise ValueError(f"descriptor_source={source!r}: one of {SOURCES}")
        self.mcfg = MatcherConfig(
            sinkhorn_iterations=config.get("sinkhorn_iterations", 20),
            match_threshold=config.get("match_threshold", 0.02),
            attention_dtype=config.get(
                "attention_dtype", "bfloat16" if on_cuda else "float32"),
            attention_impl=config.get("attention_impl", "auto"),
            use_pallas_sinkhorn=config.get("use_pallas_sinkhorn", on_cuda),
        )
        self.acfg = AGCConfig(
            radius=float(config.get("radius", 15.0)),
            percentile=float(config.get("percentile", 2.0)),
            min_size=int(config.get("min_size", 7)),
            threshold_impl=config.get("threshold_impl", "approx" if on_cuda else "exact"),
            threshold_stride=int(config.get("threshold_stride", 4)),
            cc_impl=config.get("cc_impl", "dense"),
            cc_degree=int(config.get("cc_degree", 32)),
            reconnect_impl=config.get("reconnect_impl", "centroid" if on_cuda else "exact"),
            reconnect_buckets=int(config.get("reconnect_buckets", 1024 if on_cuda else 4096)),
            agc_impl=config.get("agc_impl", "band" if on_cuda else "dense"),
            band_halfwidth=int(config.get("band_halfwidth", 512)),
        )
        check_impls(agc_impl=self.acfg.agc_impl, threshold_impl=self.acfg.threshold_impl,
                    cc_impl=self.acfg.cc_impl, reconnect_impl=self.acfg.reconnect_impl)
        topk = config.get("topk_impl", "approx" if on_cuda else "exact")
        if topk not in ("exact", "approx"):
            raise ValueError(f"topk_impl={topk!r}: 'exact' or 'approx'")
        fast = config.get("fast_frontend", on_cuda)
        self.fe = FrontendConfig(
            interpolation="linear" if fast else "cubic",
            warp_size=32 if fast else 64,
            descriptor_source=source,
            dense_dtype=config.get("dense_dtype", "bfloat16"),
            topk_impl=topk,
            upsample=bool(config.get("upsample", True)),
            dense_layers=tuple(config.get("dense_layers", (1, 2, 3))),
            dense_first_map_oct=int(config.get("dense_first_map_oct", 0)),
            sift_samples=int(config.get("sift_samples", 16)),
        )
        if not self.fe.upsample and source in COLOUR_SOURCES:
            raise ValueError("upsample=False requires descriptor_source='dense_gray' or "
                             "'devsift' (the colour pyramid paths assume the "
                             "2x-upsampled octave geometry)")
        self.total = total_keypoints
        if variables is None and config.get("init_scheme", "default") != "default":
            from gims_tpu_torch.api import init_gmatcher_variables

            variables = init_gmatcher_variables(self.mcfg, seed, config["init_scheme"])
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = GMatcher(self.mcfg)
            # devsift describes from the pyramid's gradients: no CNN
            car_model = None if source == "devsift" else CARHyNet(
                dense=source != "carhynet", in_channels=1 if source == "dense_gray" else 3)
        if variables is not None:
            load_variables(model, variables)
        self.model = model.to(self.device).eval()
        self.car_model = None
        if car_model is not None:
            if car_variables is not None:
                load_car_variables(car_model, car_variables)
            # the dense sources run in dense_dtype, the patch CNN in f32
            cdt = torch.float32 if source == "carhynet" else _DTYPES[self.fe.dense_dtype]
            self.car_model = car_model.to(self.device, cdt).eval()
            if on_cuda:
                self.car_model = self.car_model.to(memory_format=torch.channels_last)
        self.replicas = {}
        if devices is not None:
            self.replicas = {d: (self.model if d == self.device else
                                 copy.deepcopy(self.model).to(d),
                                 self.car_model if d == self.device or self.car_model is None
                                 else copy.deepcopy(self.car_model).to(d))
                             for d in devices}
        self.compact_transport = bool(config.get("compact_transport", True))
        # trunk bucket after AGC kept-compaction (None = no compaction):
        # AGC keeps about half the detection budget at the eval knobs
        if "compact_to" in config:
            self.compact_to = config["compact_to"]
        elif on_cuda and total_keypoints > 3072:
            self.compact_to = ((total_keypoints // 2 + 1023) // 1024) * 1024
        else:
            self.compact_to = None
        self.timings = {}

    def resolved_config(self) -> dict:
        """The knob set this instance runs, every device default resolved."""
        return {
            "backend": self.device.type,
            "matcher": dataclasses.asdict(self.mcfg),
            "agc": dataclasses.asdict(self.acfg),
            "frontend": dataclasses.asdict(self.fe),
            "total_keypoints": self.total,
            "compact_to": self.compact_to,
            "compact_transport": self.compact_transport,
            "descriptor_in_channels": (self.car_model.in_channels
                                       if self.car_model is not None else None),
            "dense_model": self.fe.descriptor_source in ("dense", "dense_gray"),
        }

    def _upload(self, imgs, device=None):
        """(B, H, W, 3) BGR uint8 for the colour sources; (B, H, W) gray or
        (B, H, W, 3) BGR for dense_gray and devsift."""
        if not torch.is_tensor(imgs):
            if not hasattr(imgs, "shape"):
                imgs = np.stack(imgs)
            imgs = torch.from_numpy(np.ascontiguousarray(np.asarray(imgs)))
        colour = imgs.dim() == 4 and imgs.shape[-1] == 3
        if imgs.dtype != torch.uint8 or not (
                colour or (imgs.dim() == 3 and self.fe.descriptor_source not in COLOUR_SOURCES)):
            want = ("(B, H, W, 3) BGR" if self.fe.descriptor_source in COLOUR_SOURCES
                    else "(B, H, W) gray or (B, H, W, 3) BGR")
            raise ValueError(f"FusedMatching({self.fe.descriptor_source}) takes {want} uint8 "
                             f"images, got {imgs.dtype} {tuple(imgs.shape)}")
        return imgs.to(device or self.device)

    def dispatch(self, img0, img1):
        """Upload one pair and queue its work; returns device outputs."""
        return self.dispatch_batch([img0], [img1])

    def dispatch_batch(self, imgs0, imgs1):
        """Upload B same-shape pairs (sequences of (H, W[, 3]) uint8 images,
        or (B, H, W[, 3]) stacks) and queue their work as one batch; returns the
        device outputs (batch first); with ``devices``, a list of each
        chunk's device outputs, in order."""
        if self.devices is None:
            imgs0, imgs1 = self._upload(imgs0), self._upload(imgs1)
            return self._dispatch_on(self.model, self.car_model, imgs0, imgs1)
        imgs0, imgs1 = self._upload(imgs0, "cpu"), self._upload(imgs1, "cpu")
        n_dev = len(self.devices)
        if imgs0.shape[0] % n_dev:
            raise ValueError(f"batch {imgs0.shape[0]} not divisible by the "
                             f"{n_dev}-device mesh")
        per = imgs0.shape[0] // n_dev
        # every chunk is uploaded before any is queued: an upload from
        # pageable memory waits for its card's stream, so one made between
        # two chunks would hold the host until the first chunk had run
        chunks = [(dev, *(x[i * per:(i + 1) * per].to(dev) for x in (imgs0, imgs1)))
                  for i, dev in enumerate(self.devices)]
        outs = []
        for dev, chunk0, chunk1 in chunks:
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                outs.append(self._dispatch_on(*self.replicas[dev], chunk0, chunk1))
        return outs

    def _dispatch_on(self, model, car_model, imgs0, imgs1):
        h, w = int(imgs0.shape[1]), int(imgs0.shape[2])
        budgets = octave_budgets(h, w, self.total, self.fe.upsample)
        return fused_match_batch(
            model, car_model, self.acfg, self.fe, budgets,
            imgs0, imgs1, h, w, self.compact_transport, self.compact_to)

    def __call__(self, img0, img1):
        t0 = time.perf_counter()
        host = self.collect(self.dispatch(img0, img1))
        self.timings = {"total": time.perf_counter() - t0}
        return host

    def collect(self, out):
        """One readout of a single pair, compacted to the reference's dict."""
        return self.collect_batch(out)[0]

    def collect_batch(self, out):
        """One readout; returns a list of B per-pair dicts, each compacted
        to the reference contract (leading batch dim of 1). `out` is one
        dispatch's outputs, or a list of them (``devices``: one per chunk),
        whose pairs come back in order."""
        if isinstance(out, list):
            return [pred for chunk in out for pred in self.collect_batch(chunk)]
        keys = ["kept0", "kept1", "matches0", "matches1",
                "matching_scores0", "matching_scores1",
                "keypoints0", "keypoints1", "scores0", "scores1"]
        host = {k: out[k].cpu().numpy() for k in keys}
        if host["keypoints0"].dtype == np.uint16:  # compact transport
            for s in ("0", "1"):
                host["keypoints" + s] = host["keypoints" + s].astype(np.float32) / 16.0
                host["matching_scores" + s] = host["matching_scores" + s].astype(np.float32)
                host["scores" + s] = host["scores" + s].astype(np.float32)

        def remap(matches, new_other):
            m = matches.astype(np.int64)
            return np.where(m >= 0, new_other[np.clip(m, 0, None)], -1)

        preds = []
        for b in range(host["kept0"].shape[0]):
            new0, old0 = compact_indices(host["kept0"][b])
            new1, old1 = compact_indices(host["kept1"][b])
            preds.append({
                "keypoints0": host["keypoints0"][b][old0][None],
                "keypoints1": host["keypoints1"][b][old1][None],
                "scores0": host["scores0"][b][old0][None],
                "scores1": host["scores1"][b][old1][None],
                "matches0": remap(host["matches0"][b][old0], new1).astype(np.int32)[None],
                "matches1": remap(host["matches1"][b][old1], new0).astype(np.int32)[None],
                "matching_scores0": host["matching_scores0"][b][old0][None],
                "matching_scores1": host["matching_scores1"][b][old1][None],
            })
        return preds
