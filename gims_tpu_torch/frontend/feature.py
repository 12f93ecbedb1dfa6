"""Feature frontend: image -> keypoints + 256-d descriptors, staged.

Port of ``gims_tpu/frontend/feature.py`` (reference: utils/common.py:
837-893, sift_forward): keypoints, then descriptors by
``cfg.descriptor_source``, duplicated 128 -> 256 (reference:
utils/common.py:891, torch.cat([d, d], dim=1)):
  "carhynet": the colour pyramid, the affine patch warp
    (``frontend/patches.py``) and CAR-HyNet (``carhynet/engine.py``);
  "dense": the colour CAR-HyNet over pyramid levels, sampled at the
    keypoints (``frontend/dense.py``);
  "dense_gray": the gray CAR-HyNet over the detection pyramid;
  "sift" with ``sift_descriptor="device"``: SIFT descriptors from the
    detection pyramid's gradients (``frontend/sift_descriptor.py``).

The keypoints come from the device DoG detector (``detector="device"``).
The JAX package's defaults, ``detector="host"`` and
``sift_descriptor="host"``, run OpenCV's SIFT on the host; the port has no
OpenCV, so they raise (``frontend/sift.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from gims_tpu_torch.carhynet.engine import DescriptorEngine
from gims_tpu_torch.config import FrontendConfig
from gims_tpu_torch.core.bucketing import DEFAULT_BUCKETS, bucket_size
from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.frontend.sift import OPENCV_TODO
from gims_tpu_torch.frontend.patches import extract_patches_device
from gims_tpu_torch.frontend.pyramid import pyramid_from_uint8

SOURCES = ("carhynet", "dense", "dense_gray", "sift")


def _normalize_duplicate(raw: torch.Tensor) -> torch.Tensor:
    """(N, 128) raw descriptors -> (N, 256) f32 unit-norm duplicated
    descriptors (reference: utils/common.py:891)."""
    d = raw.float()
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-12)
    return torch.cat([d, d], dim=1)


class FeatureFrontend:
    """Holds the descriptor engine and runs the frontend on one image at a
    time, on `device`: the engine's device when an engine is given, else
    ``cuda`` unless the caller passes another.

    `variables` are flax CAR-HyNet variables (numpy tree) for the engine;
    without them and without `weights_path` it is randomly initialized.
    dense_gray uses the single-channel network, the other CNN sources the
    colour one; sift needs none."""

    def __init__(self, cfg: Optional[FrontendConfig] = None,
                 engine: Optional[DescriptorEngine] = None,
                 weights_path: Optional[str] = None, variables=None, device=None):
        self.cfg = cfg or FrontendConfig()
        source = self.cfg.descriptor_source
        if source not in SOURCES:
            raise ValueError(f"descriptor_source={source!r}: one of {SOURCES}")
        self.device = resolve_device(device) if engine is None else engine.device
        self.engine = self.dense = self.dense_gray = None
        if source != "sift":
            in_ch = 1 if source == "dense_gray" else 3
            self.engine = engine or DescriptorEngine(
                variables=variables, weights_path=weights_path, in_channels=in_ch,
                device=self.device)
        if source == "dense":
            from gims_tpu_torch.frontend.dense import DenseDescriptorFrontend

            self.dense = DenseDescriptorFrontend(
                self.engine.variables, device=self.device, weights_from=self.engine.model)
        elif source == "dense_gray":
            from gims_tpu_torch.frontend.dense import DenseGrayDescriptorFrontend

            self.dense_gray = DenseGrayDescriptorFrontend(
                self.engine.variables, dtype=self.cfg.dense_dtype, device=self.device,
                weights_from=self.engine.model)
        self.timings = {}

    def _check(self, train_topup: bool):
        if self.cfg.detector != "device":
            raise NotImplementedError(f"detector={self.cfg.detector!r} {OPENCV_TODO}")
        if train_topup:
            raise NotImplementedError(f"train_topup (random top-up keypoints) {OPENCV_TODO}")
        if self.cfg.descriptor_source == "sift" and self.cfg.sift_descriptor != "device":
            raise NotImplementedError(
                f"sift_descriptor={self.cfg.sift_descriptor!r} {OPENCV_TODO}")

    def extract(self, image_bgr: np.ndarray, max_keypoints: Optional[int] = None,
                train_topup: bool = False, rng=None):
        """image_bgr: (H, W, 3) uint8. Returns host arrays: keypoints (N, 2)
        f32, scores (N,), descriptors (N, 256) f32, and kp (KeypointArrays)."""
        f = self.extract_padded(image_bgr, max_keypoints, None, train_topup, rng)
        n = f["n"]
        return {"keypoints": f["kp"].pt.copy(), "scores": f["kp"].response.copy(),
                "descriptors": f["desc"][:n].cpu().numpy(), "kp": f["kp"]}

    @torch.no_grad()
    def extract_padded(self, image_bgr: np.ndarray, max_keypoints: Optional[int] = None,
                       bucket: Optional[int] = None, train_topup: bool = False, rng=None):
        """Device-resident frontend: detection reads back its keypoints (the
        host groups them by octave), everything else stays on the device.

        Returns kpts (Nb, 2), desc (Nb, 256), valid (Nb,) on the device,
        padded to `bucket` (default: the smallest of DEFAULT_BUCKETS that
        holds the keypoints; keypoints past it are dropped), the host's
        scores (Nb,), kp and n, and this image's ``timings``: detect,
        patches and descriptors, host seconds up to each stage's last launch
        (the device may still be working). ``self.timings`` keeps those of
        the last image, as in the JAX package."""
        from gims_tpu_torch.frontend.detect_device import detect_device, gray_pyramid

        self._check(train_topup)
        t0 = time.perf_counter()
        cfg = self.cfg
        mk = max_keypoints if max_keypoints and max_keypoints > 0 else (bucket or 12288)
        with record_function("gims.frontend.detect"):
            kp, _ = detect_device(image_bgr, mk, cfg.contrast_threshold, cfg.edge_threshold,
                                  device=self.device)
        n = len(kp)
        nb = bucket if bucket is not None else bucket_size(n, DEFAULT_BUCKETS)
        if n > nb:
            kp, n = kp.head(nb), nb
        img = torch.from_numpy(np.ascontiguousarray(image_bgr)).to(self.device)
        t1 = time.perf_counter()
        if cfg.descriptor_source == "sift":
            from gims_tpu_torch.frontend.sift_descriptor import describe_device

            with record_function("gims.frontend.pyramid"):
                pyr = [g[0] for g in gray_pyramid(img[None], upsample=True)]
            t2 = time.perf_counter()
            with record_function("gims.frontend.describe"):
                desc = describe_device(pyr, kp, nb, cfg.sift_samples)
        elif self.dense_gray is not None:
            t2 = time.perf_counter()
            with record_function("gims.frontend.cnn"):
                desc = self.dense_gray.compute(img, kp, nb)
        elif self.dense is not None:
            with record_function("gims.frontend.pyramid"):
                pyramid = [p[0] for p in pyramid_from_uint8(img[None])]
            t2 = time.perf_counter()
            with record_function("gims.frontend.cnn"):
                desc = self.dense.compute(pyramid, kp, nb)
        else:
            with record_function("gims.frontend.pyramid"):
                pyramid = [p[0] for p in pyramid_from_uint8(img[None])]
            with record_function("gims.frontend.warp"):
                patches = extract_patches_device(pyramid, kp, nb, cfg.interpolation,
                                                 cfg.warp_size)
            t2 = time.perf_counter()
            with record_function("gims.frontend.cnn"):
                desc = self.engine.compute_device(patches)
        # 128 -> 256 by duplication; SIFT's integer descriptors unit-normed first
        desc = (_normalize_duplicate(desc) if cfg.descriptor_source == "sift"
                else torch.cat([desc, desc], dim=1))
        t3 = time.perf_counter()

        kpts = np.full((nb, 2), 1e6, np.float32)
        kpts[:n] = kp.pt
        scores = np.zeros((nb,), np.float32)
        scores[:n] = kp.response
        valid = np.zeros((nb,), bool)
        valid[:n] = True
        timings = {"detect": t1 - t0, "patches": t2 - t1, "descriptors": t3 - t2}
        self.timings = timings
        return {
            "kpts": torch.from_numpy(kpts).to(self.device),
            "desc": desc,
            "valid": torch.from_numpy(valid).to(self.device),
            "scores": scores,
            "kp": kp,
            "n": n,
            "timings": timings,
        }
