"""Public matching API: the reference's dict contract on keypoint requests.

Port of ``gims_tpu/api.py`` (reference: models/matching.py:8-30). A request
carries ``keypoints{0,1}`` (N, 2), ``descriptors{0,1}`` (N, C) or (C, N),
``scores{0,1}`` (N,), ``image0`` (whose shape sets the keypoint
normalization) and optional AGC knobs (``radius``, ``percentile``,
``min_size``). The answer holds, per side, the AGC-kept keypoints, their
scores and descriptors, matches indexed into the kept sets,
matching_scores and the projected descriptors ``mdesc``.

The image frontend (SIFT / CAR-HyNet) and the Delaunay variant are not
ported yet: requests that need them raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from gims_tpu_torch.config import GIMSConfig, MatcherConfig
from gims_tpu_torch.core.bucketing import compact_indices, pad_keypoint_set
from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.matcher import pipeline
from gims_tpu_torch.matcher.convert import load_gims_checkpoint, load_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher

FRONTEND_TODO = ("image requests need the staged image frontend (SIFT / "
                 "CAR-HyNet), which is not ported yet (ROADMAP.md, staged "
                 "image frontend); send keypoints{0,1}/descriptors{0,1}/"
                 "scores{0,1} instead")


def _as_hw3(img):
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return np.ascontiguousarray(img.astype(np.uint8))


def _desc_nd(d):
    d = np.asarray(d, np.float32)
    if d.ndim == 2 and d.shape[0] in (128, 256) and d.shape[0] < d.shape[1]:
        return d.T  # (C, N) -> (N, C)
    return d


class Matching:
    """Matching front API.

    config accepts the reference's keys (weights_path,
    sinkhorn_iterations, match_threshold, max_keypoints, plus
    attention_dtype / attention_impl / use_pallas_sinkhorn) or a full
    GIMSConfig. `variables` is a JAX-layout variables tree of numpy arrays
    (as ``load_gims_checkpoint`` returns); without it and without
    weights_path the model is randomly initialized from `seed`. Runs on
    ``cuda`` unless `device` says otherwise. On CUDA the defaults are the
    bf16 trunk and the Sinkhorn kernel; on the CPU f32 and the plain
    Sinkhorn.
    """

    def __init__(self, config=None, variables=None, seed: int = 0,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        on_cuda = self.device.type == "cuda"
        if isinstance(config, GIMSConfig):
            self.cfg = config
            self.max_keypoints = config.frontend.max_keypoints
        else:
            config = dict(config or {})
            mcfg = MatcherConfig(
                sinkhorn_iterations=config.get("sinkhorn_iterations", 100),
                match_threshold=config.get("match_threshold", 0.2),
                attention_dtype=config.get(
                    "attention_dtype", "bfloat16" if on_cuda else "float32"),
                attention_impl=config.get("attention_impl", "auto"),
                use_pallas_sinkhorn=config.get("use_pallas_sinkhorn", on_cuda),
            )
            self.cfg = GIMSConfig(matcher=mcfg)
            self.max_keypoints = config.get("max_keypoints", -1)
            weights_path = config.get("weights_path")
            if variables is None and weights_path:
                variables = load_gims_checkpoint(weights_path)
                print(f'Loaded GMatcher model ("{weights_path}" weights)')

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = GMatcher(self.cfg.matcher)
        if variables is not None:
            load_variables(model, variables)
        self.model = model.to(self.device).eval()
        self.timings = {}

    def __call__(self, data: dict) -> dict:
        acfg = dataclasses.replace(
            self.cfg.agc,
            radius=float(data.get("radius", self.cfg.agc.radius)),
            percentile=float(data.get("percentile", self.cfg.agc.percentile)),
            min_size=int(data.get("min_size", self.cfg.agc.min_size)),
            delaunay=bool(data.get("delaunay", self.cfg.agc.delaunay)),
        )
        if acfg.delaunay:
            raise NotImplementedError("delaunay=True (D-GIMS) is not ported "
                                      "yet; see ROADMAP.md")
        if data.get("features") is not None:
            raise NotImplementedError(FRONTEND_TODO)
        return_desc = bool(data.get("return_descriptors", True))

        t0 = time.perf_counter()
        feats = {}
        for side in ("0", "1"):
            if f"keypoints{side}" not in data:
                raise NotImplementedError(FRONTEND_TODO)
            kpts = np.asarray(data[f"keypoints{side}"])
            descs = _desc_nd(np.asarray(data[f"descriptors{side}"]))
            scores = np.asarray(data[f"scores{side}"], np.float32)
            kp_p, de_p, sc_p, msk = pad_keypoint_set(kpts, descs, scores)
            feats[side] = {"kpts_host": kp_p, "desc": de_p, "valid": msk,
                           "scores": sc_p, "n": len(kpts)}
        image_shape = tuple(_as_hw3(data["image0"]).shape[:2])
        f0, f1 = feats["0"], feats["1"]

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x))[None].to(self.device)

        valid0, valid1 = dev(f0["valid"]), dev(f1["valid"])
        # the exact percentile ranks, computed on the device from the masks
        k0 = pipeline.percentile_rank(valid0.sum(dim=1), acfg.percentile)
        k1 = pipeline.percentile_rank(valid1.sum(dim=1), acfg.percentile)
        t1 = time.perf_counter()
        out = pipeline.forward_match(
            self.model, acfg,
            dev(f0["kpts_host"]), dev(f0["desc"]), valid0,
            dev(f1["kpts_host"]), dev(f1["desc"]), valid1,
            image_shape, k0=k0, k1=k1,
            radius=acfg.radius, min_size=acfg.min_size,
        )
        keys = ["kept0", "kept1", "matches0", "matches1",
                "matching_scores0", "matching_scores1"]
        if return_desc:
            keys += ["mdesc0", "mdesc1"]
        host = {k: out[k].cpu().numpy() for k in keys}
        if return_desc:
            host["desc0"], host["desc1"] = f0["desc"], f1["desc"]
        t2 = time.perf_counter()
        self.timings = {"frontend": t1 - t0, "matcher": t2 - t1}
        return self._compact(host, f0, f1, return_desc)

    def _compact(self, out, f0, f1, return_desc):
        kept0 = out["kept0"][0]
        kept1 = out["kept1"][0]
        new0, old0 = compact_indices(kept0)
        new1, old1 = compact_indices(kept1)

        def remap(matches, new_other):
            m = matches.astype(np.int64)
            return np.where(m >= 0, new_other[np.clip(m, 0, None)], -1)

        matches0 = remap(out["matches0"][0][old0], new1)
        matches1 = remap(out["matches1"][0][old1], new0)
        pred = {
            "keypoints0": f0["kpts_host"][old0][None],
            "keypoints1": f1["kpts_host"][old1][None],
            "scores0": f0["scores"][old0][None],
            "scores1": f1["scores"][old1][None],
            "matches0": matches0.astype(np.int32)[None],
            "matches1": matches1.astype(np.int32)[None],
            "matching_scores0": out["matching_scores0"][0][old0][None],
            "matching_scores1": out["matching_scores1"][0][old1][None],
        }
        if return_desc:
            pred["descriptors0"] = out["desc0"][old0].T[None]
            pred["descriptors1"] = out["desc1"][old1].T[None]
            pred["mdesc0"] = out["mdesc0"][0][old0]
            pred["mdesc1"] = out["mdesc1"][0][old1]
        return pred
