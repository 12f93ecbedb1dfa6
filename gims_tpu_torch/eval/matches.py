"""Match-counting evaluation ("MN" metric) + timing/memory profile.

Port of ``gims_tpu/eval/matches.py`` (reference eval_matches.py): match one
image against one or many others, count the RANSAC-inlier matches, report
per-stage timings and peak device memory, and write result.txt. Also
carries the standalone NNDR / mutual-NN descriptor baselines (reference:
eval_matches.py:13-67) as plain-numpy utilities.

Inliers are counted, as the JAX package counts them with
``cv2.USAC_DEFAULT``, by the port's USAC (``eval/usac.py``: LO-RANSAC with
MSAC scoring, reprojection threshold 3 px), and ``save_match`` draws
them. Images are
read with the port's PNG and JPEG reader (``core/image_io.py``); the
drawings are ``eval/viz.py``'s.
"""

from __future__ import annotations

import os
import time
from glob import glob
from typing import Callable, Optional

import numpy as np

from gims_tpu_torch.core import image_io
from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.core.profiling import device_peak_memory_gb
from gims_tpu_torch.eval.usac import find_homography_usac
from gims_tpu_torch.eval.viz import draw_matches


def calculate_nndr(desc_a, desc_b, threshold=0.8):
    """Nearest-neighbor distance-ratio matcher ((C,N) or (N,C) inputs)."""
    a = _as_nc(desc_a)
    b = _as_nc(desc_b)
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    order = np.argsort(d, axis=1)
    nearest = d[np.arange(len(a)), order[:, 0]]
    second = d[np.arange(len(a)), order[:, 1]]
    ratios = nearest / np.maximum(second, 1e-12)
    sel = ratios < threshold
    match_indices = np.nonzero(sel)[0]
    good = order[match_indices, 0]
    return match_indices, good, ratios[sel]


def calculate_mnn(desc_a, desc_b, threshold=0.8):
    """Mutual nearest neighbors + ratio test."""
    a = _as_nc(desc_a)
    b = _as_nc(desc_b)
    d_ab = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    nearest_ab = d_ab.argmin(1)
    nearest_ba = d_ab.argmin(0)
    mutual = np.arange(len(a)) == nearest_ba[nearest_ab]
    order = np.sort(d_ab, axis=1)
    ratios = order[:, 0] / np.maximum(order[:, 1], 1e-12)
    sel = (ratios < threshold) & mutual
    match_indices = np.nonzero(sel)[0]
    return match_indices, nearest_ab[match_indices], ratios[sel]


def _as_nc(d):
    d = np.asarray(d, np.float32)
    if d.ndim == 2 and d.shape[0] < d.shape[1]:
        return d.T
    return d


def run_match_eval(
    image0_path: str,
    image1s_path: str,
    root_path: str = "output/match/",
    dgims: bool = False,
    save_match: bool = False,
    weights_path: Optional[str] = None,
    matcher: Optional[Callable] = None,
    agc=None,
    device=None,
):
    """Match `image0_path` against every image of the glob `image1s_path`
    (PNG or JPEG); inliers of the port's USAC per pair into
    ``result.txt``, and with `save_match` a drawing of them,
    ``{name}.jpg``. `device` runs the default ``Matching`` and USAC."""
    dev = resolve_device(device)
    agc = dict(agc or {"radius": 15, "percentile": 2, "min_size": 7})
    if dgims:
        agc["delaunay"] = True
    result_dir = os.path.join(root_path, "dgims" if dgims else "gims")
    os.makedirs(result_dir, exist_ok=True)
    if matcher is None:
        from gims_tpu_torch.api import Matching

        matcher = Matching({
            "weights_path": weights_path,
            "sinkhorn_iterations": 20,
            "match_threshold": 0.02,
            "max_keypoints": -1,
        }, device=dev)
    results_file = []
    image0 = image_io.imread(image0_path, image_io.IMREAD_COLOR)
    name0 = os.path.splitext(os.path.basename(image0_path))[0]
    for image1_path in sorted(glob(image1s_path)):
        name1 = os.path.splitext(os.path.basename(image1_path))[0]
        if name0 == name1:
            continue
        image1 = image_io.imread(image1_path, image_io.IMREAD_COLOR)
        t_start = time.time()
        pred = matcher({
            "image0": image0[None], "image1": image1[None], **agc,
        })
        kpts0 = pred["keypoints0"][0]
        kpts1 = pred["keypoints1"][0]
        matches = pred["matches0"][0]
        valid = matches > -1
        mkpts0 = kpts0[valid]
        mkpts1 = kpts1[matches[valid]]
        t1 = time.time()
        found = find_homography_usac(np.float32(mkpts0), np.float32(mkpts1), device=dev)
        if found is None:  # JAX: OpenCV raises or returns no matrix
            print("Too few points matched:", len(mkpts0))
            results_file.append(f"{name1} => 0")
            continue
        t_ransac = time.time() - t1
        t_total = time.time() - t_start
        inliers = int((found[1].ravel() == 1).sum())
        print(f">> RANSAC: {t_ransac:.3f}s | total: {t_total:.3f}s")
        print(f">> Peak device memory: {device_peak_memory_gb(dev):.2f} GB")
        print(f"{inliers}/{len(matches)}")
        results_file.append(f"{name1} => {inliers} [{t_total}]")
        if save_match:
            keep = found[1].ravel() == 1
            viz = draw_matches(image0, image1, mkpts0[keep], mkpts1[keep])
            image_io.imwrite(os.path.join(result_dir, name1 + ".jpg"), viz)
    with open(os.path.join(result_dir, "result.txt"), "w+") as f:
        f.write("\n".join(results_file))
    # completion ping (reference: eval_matches.py:181); no-op unless
    # GIMS_NOTIFY_URL is set
    from gims_tpu_torch.core.notify import send_notify

    send_notify("eval_matches done: " + "; ".join(results_file[-3:]))
    return results_file
