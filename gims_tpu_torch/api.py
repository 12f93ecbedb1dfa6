"""Public matching API: the reference's dict contract.

Port of ``gims_tpu/api.py`` (reference: models/matching.py:8-30). A request
carries ``image0``/``image1`` ((1, H, W, 3) or (H, W, 3) uint8 BGR), or
precomputed ``keypoints{0,1}`` (N, 2), ``descriptors{0,1}`` (N, C) or (C, N)
and ``scores{0,1}`` (N,) (``image0`` still sets the keypoint
normalization), or ``features`` from ``prepare_features``; and optional AGC
knobs (``radius``, ``percentile``, ``min_size``, ``delaunay``). The answer
holds, per side, the AGC-kept keypoints, their scores and descriptors,
matches indexed into the kept sets, matching_scores and the projected
descriptors ``mdesc``. ``delaunay=True`` (D-GIMS) replaces AGC by a
Delaunay triangulation of each side's keypoints on the host (scipy) and
keeps every keypoint.

Images go through ``frontend/feature.py``'s ``FeatureFrontend``, one image
at a time, then one matcher call per pair.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from gims_tpu_torch.agc.graph import delaunay_adjacency_host
from gims_tpu_torch.config import GIMSConfig, MatcherConfig
from gims_tpu_torch.core.bucketing import compact_indices, pad_keypoint_set
from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.frontend.feature import FeatureFrontend
from gims_tpu_torch.matcher import pipeline
from gims_tpu_torch.matcher.convert import load_gims_checkpoint, load_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher

# request keys of Matching's config that replace fields of FrontendConfig
_FRONTEND_KEYS = ("descriptor_source", "detector", "sift_descriptor", "sift_samples")


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
    sinkhorn_iterations, match_threshold, max_keypoints), attention_dtype /
    attention_impl / use_pallas_sinkhorn, and the frontend's
    fast_frontend (bilinear taps, direct 32x32 sampling), descriptor_source
    ("carhynet", "dense", "dense_gray", "sift"), detector, sift_descriptor
    and sift_samples; or a full GIMSConfig. `variables` is a JAX-layout
    variables tree of numpy arrays (as ``load_gims_checkpoint`` returns);
    without it and without weights_path the model is randomly initialized
    from `seed`. `frontend` is a ready ``FeatureFrontend`` (for example one
    holding trained CAR-HyNet weights); without it one is built from the
    config, its CAR-HyNet randomly initialized. Runs on ``cuda`` unless
    `device` says otherwise. On CUDA the defaults are the bf16 trunk and the
    Sinkhorn kernel; on the CPU f32 and the plain Sinkhorn. A given
    `frontend` must run on the same device. After a call, ``timings`` holds
    the host seconds of the frontend and the matcher, and ``frontend_*``,
    the frontend's stages summed over this request's two images.

    The frontend defaults are the JAX package's: descriptor_source
    "carhynet" with detector "host", OpenCV's SIFT detector, which the port
    does not have. An image request with those defaults raises
    NotImplementedError; pass ``detector="device"`` (and, for
    ``descriptor_source="sift"``, ``sift_descriptor="device"``).
    """

    def __init__(self, config=None, variables=None,
                 frontend: Optional[FeatureFrontend] = None, seed: int = 0,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        on_cuda = self.device.type == "cuda"
        if isinstance(config, GIMSConfig):
            self.cfg = config
            self.max_keypoints = config.frontend.max_keypoints
            fe_cfg = config.frontend
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
            fe_cfg = self.cfg.frontend
            if config.get("fast_frontend"):
                # bilinear taps sampling the 32x32 grid directly: 12x fewer
                # gathered rows than 64x64 bicubic, a small loss of quality
                fe_cfg = dataclasses.replace(fe_cfg, interpolation="linear", warp_size=32)
            fe_cfg = dataclasses.replace(fe_cfg, **{
                k: (int(config[k]) if k == "sift_samples" else config[k])
                for k in _FRONTEND_KEYS if config.get(k)})

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = GMatcher(self.cfg.matcher)
        if variables is not None:
            load_variables(model, variables)
        self.model = model.to(self.device).eval()
        if frontend is not None and frontend.device != self.device:
            raise ValueError(f"frontend runs on {frontend.device}, Matching on {self.device}: "
                             "build the FeatureFrontend with the same device")
        self.frontend = frontend or FeatureFrontend(fe_cfg, device=self.device)
        self.timings = {}

    def _features(self, img):
        """One image through the frontend, with the host copy of its padded
        keypoints."""
        f = self.frontend.extract_padded(_as_hw3(img), max_keypoints=self.max_keypoints)
        nb = f["kpts"].shape[0]
        kp_p = np.full((nb, 2), 1e6, np.float32)
        kp_p[: f["n"]] = f["kp"].pt[: f["n"]]
        return {**f, "kpts_host": kp_p}

    def __call__(self, data: dict) -> dict:
        acfg = dataclasses.replace(
            self.cfg.agc,
            radius=float(data.get("radius", self.cfg.agc.radius)),
            percentile=float(data.get("percentile", self.cfg.agc.percentile)),
            min_size=int(data.get("min_size", self.cfg.agc.min_size)),
            delaunay=bool(data.get("delaunay", self.cfg.agc.delaunay)),
        )
        return_desc = bool(data.get("return_descriptors", True))

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        t0 = time.perf_counter()
        precomputed = data.get("features")
        feats = {}
        for side in ("0", "1"):
            if precomputed is not None:
                feats[side] = precomputed[side]
            elif f"keypoints{side}" in data:
                kpts = np.asarray(data[f"keypoints{side}"])
                descs = _desc_nd(np.asarray(data[f"descriptors{side}"]))
                scores = np.asarray(data[f"scores{side}"], np.float32)
                kp_p, de_p, sc_p, msk = pad_keypoint_set(kpts, descs, scores)
                feats[side] = {"kpts": dev(kp_p), "desc": dev(de_p), "valid": dev(msk),
                               "scores": sc_p, "kpts_host": kp_p, "n": len(kpts)}
            else:
                feats[side] = self._features(data[f"image{side}"])
        t1 = time.perf_counter()
        image_shape = tuple(_as_hw3(data["image0"]).shape[:2])
        f0, f1 = feats["0"], feats["1"]
        args = [x[None] for f in (f0, f1) for x in (f["kpts"], f["desc"], f["valid"])]
        if acfg.delaunay:
            adj = [dev(delaunay_adjacency_host(f["kpts_host"], f["valid"].cpu().numpy()))[None]
                   for f in (f0, f1)]
            out = pipeline.forward_match(self.model, acfg, *args, image_shape,
                                         adj0=adj[0], adj1=adj[1])
        else:
            # the exact percentile ranks, computed on the device from the masks
            k0, k1 = (pipeline.percentile_rank(f["valid"][None].sum(dim=1), acfg.percentile)
                      for f in (f0, f1))
            out = pipeline.forward_match(self.model, acfg, *args, image_shape, k0=k0, k1=k1,
                                         radius=acfg.radius, min_size=acfg.min_size)
        keys = ["kept0", "kept1", "matches0", "matches1",
                "matching_scores0", "matching_scores1"]
        if return_desc:
            keys += ["mdesc0", "mdesc1"]
        host = {k: out[k].cpu().numpy() for k in keys}
        if return_desc:
            host["desc0"], host["desc1"] = f0["desc"].cpu().numpy(), f1["desc"].cpu().numpy()
        t2 = time.perf_counter()
        # this request's two images, summed (none for keypoint requests)
        side_timings = [f["timings"] for f in (f0, f1) if "timings" in f]
        self.timings = {"frontend": t1 - t0, "matcher": t2 - t1,
                        **{f"frontend_{k}": sum(t[k] for t in side_timings)
                           for k in (side_timings[0] if side_timings else ())}}
        return self._compact(host, f0, f1, return_desc)

    def prepare_features(self, pair, agc=None):
        """The frontend for a pair ahead of its match (a pipelining hook):
        returns the dict to pass as data["features"]. The two sides run one
        after the other. The JAX package runs them on two threads so that
        one host OpenCV detection hides behind the other; the port detects
        on the card, where two threads only contend for the GIL and the one
        stream."""
        return {"0": self._features(pair[0]), "1": self._features(pair[1])}

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
