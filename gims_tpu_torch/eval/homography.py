"""Homography-benchmark evaluation harness.

Port of ``gims_tpu/eval/homography.py`` (reference eval_homography.py:107-268):
per pair — match, RANSAC homography + DLT from the top-4 confidence
matches, corner-projection pixel error vs GT, precision/recall vs
reprojection GT — then aggregate AUC@{5,10,25}. Writes the same
``{stem}_matches.npz`` / ``{stem}_evaluation.npz`` artifacts and
``result/results.txt``.

The JAX package's OpenCV calls are replaced by the port's own: PNG and
JPEG I/O (``core/image_io.py``), warps, resizes and blurs
(``core/imgproc.py``), RANSAC (``eval/ransac.py``), the drawings of
``save_viz`` (``eval/viz.py``, written as ``{stem}_bordered.jpg``).
Ground-truth matching (``train/gt.py``) and RANSAC run in torch on the harness's device (``cuda`` unless the caller
names another), so the matcher's host outputs go back to the card for
them. ``generate_benchmark`` makes the ``noise`` and ``structured`` styles
(and reads PNG or JPEG ``source_dir`` images); the structured scenes are
drawn with ``core/drawing.py``'s filled ellipses, polygons and rectangles,
which OpenCV draws as ``LINE_8`` on their float32 layers although the JAX
package asks for ``LINE_AA``.
"""

from __future__ import annotations

import os
import random
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from gims_tpu_torch.core import drawing, image_io, imgproc
from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.eval import metrics as M
from gims_tpu_torch.eval.ransac import find_homography
from gims_tpu_torch.eval.viz import draw_homography_boxes, draw_matches
from gims_tpu_torch.train.data import get_perspective_mat, scale_homography
from gims_tpu_torch.train.gt import find_matches

def read_image_with_homography(path, homo_matrix, resize, color=True):
    """Reference: utils/common.py:364-385 (color path)."""
    flag = image_io.IMREAD_COLOR if color else image_io.IMREAD_GRAYSCALE
    image = image_io.imread(str(path), flag)
    if image is None:
        return None, None, None
    w, h = image.shape[1], image.shape[0]
    warped = imgproc.warp_perspective(image.copy(), homo_matrix, (w, h))
    if len(resize) == 2:
        w_new, h_new = resize
    else:
        scale = resize[0] / max(h, w) if resize[0] > -1 else 1.0
        w_new, h_new = int(round(w * scale)), int(round(h * scale))
    image = imgproc.resize(image, (w_new, h_new))
    warped = imgproc.resize(warped, (w_new, h_new))
    scaled = scale_homography(homo_matrix, h, w, h_new, w_new).astype(np.float32)
    return image, warped, scaled


def gt_reprojection_matches(kpts0, kpts1, H, dist_thresh=3.0, n_iters=3, device=None):
    """Ground-truth matches of two keypoint sets under H: (ma_0, ma_1)
    host index arrays. Each side is padded to a multiple of 1024 with far
    sentinels, as the JAX package pads for its compile cache."""
    dev = resolve_device(device)
    n0, n1 = len(kpts0), len(kpts1)
    b0 = max(1024, -(-n0 // 1024) * 1024)
    b1 = max(1024, -(-n1 // 1024) * 1024)
    k0 = np.full((b0, 2), 1e7, np.float32)
    k1 = np.full((b1, 2), 2e7, np.float32)
    k0[:n0] = kpts0
    k1[:n1] = kpts1
    ar = torch.arange(max(b0, b1), device=dev)
    m0, _ = find_matches(
        torch.from_numpy(k0).to(dev), torch.from_numpy(k1).to(dev),
        torch.from_numpy(np.asarray(H, np.float32)).to(dev),
        ar[:b0] < n0, ar[:b1] < n1, dist_thresh, n_iters)
    m0 = m0[:n0].cpu().numpy()
    ma_0 = np.nonzero(m0 >= 0)[0]
    ma_1 = m0[ma_0]
    return ma_0, ma_1


def evaluate_pair(matcher: Callable, image0, image1, homo, min_matches=12,
                  agc=None, device=None):
    """Returns (record dict or None-if-skipped, artifacts dict).

    `matcher` takes the reference's data dict (``api.Matching`` or any
    callable with its contract). A pair is skipped (None) with fewer than
    `min_matches` matches or where RANSAC finds no homography; the JAX
    package also skips where OpenCV raises, which its estimators do not do
    on these inputs, and the port's never do."""
    # descriptors are unused here; skipping their readback saves traffic
    data = {"image0": image0[None], "image1": image1[None],
            "return_descriptors": False, **(agc or {})}
    pred = matcher(data)
    kpts0 = pred["keypoints0"][0]
    kpts1 = pred["keypoints1"][0]
    matches = pred["matches0"][0]
    conf = pred["matching_scores0"][0]
    valid = matches > -1
    mkpts0 = kpts0[valid]
    mkpts1 = kpts1[matches[valid]]
    mconf = conf[valid]
    artifacts = {
        "matches_npz": {
            "keypoints0": kpts0, "keypoints1": kpts1,
            "matches": matches, "match_confidence": conf,
        },
        "mkpts0": mkpts0, "mkpts1": mkpts1,
    }
    if len(mconf) < min_matches:
        return None, artifacts

    ma_0, ma_1 = gt_reprojection_matches(kpts0, kpts1, homo, device=device)
    gt_match_vec = np.full(len(matches), -1, np.int32)
    gt_match_vec[ma_0] = ma_1

    h, w = image0.shape[:2]
    corners = M.corner_points(h, w)
    sort_index = np.argsort(mconf)[::-1][:4]
    est_dlt = imgproc.get_perspective_transform(
        mkpts0[sort_index].astype(np.float32), mkpts1[sort_index].astype(np.float32))
    found = find_homography(mkpts0, mkpts1, 3.0, max_iters=3000, device=device)
    if found is None:
        return None, artifacts
    est_ransac = found[0]
    gt_corners = imgproc.perspective_transform(corners, homo)
    error_dlt = M.compute_pixel_error(imgproc.perspective_transform(corners, est_dlt),
                                      gt_corners)
    error_ransac = M.compute_pixel_error(imgproc.perspective_transform(corners, est_ransac),
                                         gt_corners)
    precision, recall = M.match_precision_recall(
        matches, gt_match_vec, valid, ma_0, ma_1
    )
    record = {
        "error_dlt": error_dlt, "error_ransac": error_ransac,
        "precision": precision, "recall": recall,
    }
    artifacts["est_ransac"] = est_ransac
    return record, artifacts


def aggregate(records, thresholds=(5, 10, 25)):
    errors_dlt = [r["error_dlt"] for r in records]
    errors_ransac = [r["error_ransac"] for r in records]
    aucs_dlt = [100.0 * a for a in M.pose_auc(errors_dlt, thresholds)]
    aucs_ransac = [100.0 * a for a in M.pose_auc(errors_ransac, thresholds)]
    prec = 100.0 * float(np.mean([r["precision"] for r in records]))
    rec = 100.0 * float(np.mean([r["recall"] for r in records]))
    results = {
        "dlt_auc": aucs_dlt, "ransac_auc": aucs_ransac,
        "precision": prec, "recall": rec,
        "thresholds": list(thresholds),
    }
    results["weight_score"] = M.weighted_score(results)
    return results


def run_benchmark(
    input_homography: str,
    input_dir: str,
    output_dir: str,
    weights_path: Optional[str] = None,
    variables=None,
    resize=(800, 600),
    sinkhorn_iterations=20,
    match_threshold=0.02,
    max_keypoints=-1,
    agc=None,
    max_length=-1,
    shuffle=True,
    min_matches=12,
    save_viz=False,
    matcher: Optional[Callable] = None,
    device=None,
):
    """The 199-pair benchmark (or any 'name h00..h22' list). `device`
    runs the default ``Matching``, ground-truth matching and RANSAC."""
    dev = resolve_device(device)
    agc = agc or {"radius": 15, "percentile": 2, "min_size": 7}
    with open(input_homography) as f:
        homo_pairs = [l for l in f.readlines() if l.strip()]
    if max_length > -1:
        homo_pairs = homo_pairs[: min(len(homo_pairs), max_length)]
    if shuffle:
        random.Random(0).shuffle(homo_pairs)

    if matcher is None:
        from gims_tpu_torch.api import Matching

        matcher = Matching({
            "weights_path": weights_path,
            "sinkhorn_iterations": sinkhorn_iterations,
            "match_threshold": match_threshold,
            "max_keypoints": max_keypoints,
        }, variables=variables, device=dev)

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    match_dir = out / "result" / "matches"
    match_dir.mkdir(parents=True, exist_ok=True)
    records = []
    results_lines = []
    for i, info in enumerate(homo_pairs):
        parts = info.strip().split(" ")
        name = parts[0]
        homo = np.array(list(map(float, parts[1:]))).reshape(3, 3).astype(np.float32)
        stem = Path(name).stem
        image0, image1, homo = read_image_with_homography(
            Path(input_dir) / name, homo, resize
        )
        if image0 is None:
            continue
        t0 = time.perf_counter()
        record, artifacts = evaluate_pair(
            matcher, image0, image1, homo, min_matches, agc, device=dev
        )
        dt = time.perf_counter() - t0
        np.savez(str(out / f"{stem}_matches.npz"), **artifacts["matches_npz"])
        if record is None:
            np.savez(str(out / f"{stem}_evaluation.npz"),
                     error_dlt=-1, error_ransac=-1, precision=-1, recall=-1)
            results_lines.append(f"{name} => 0")
            print(f"[{i+1}/{len(homo_pairs)}] {name}: skipped ({dt:.2f}s)")
            continue
        np.savez(str(out / f"{stem}_evaluation.npz"), **record)
        n_m = len(artifacts["mkpts0"])
        results_lines.append(f"{name} => {n_m}")
        print(
            f"[{i+1}/{len(homo_pairs)}] {name}: {n_m} matches, "
            f"err_ransac={record['error_ransac']:.2f} ({dt:.2f}s)"
        )
        if save_viz:
            viz = draw_matches(image0, image1, artifacts["mkpts0"], artifacts["mkpts1"])
            viz = draw_homography_boxes(
                viz, image0.shape[1], homo, artifacts.get("est_ransac"),
                f"error_ransac: {record['error_ransac']:.2f}",
            )
            image_io.imwrite(str(match_dir / f"{stem}_bordered.jpg"), viz)
        records.append(record)

    results = aggregate(records) if records else None
    with open(out / "result" / "results.txt", "w") as f:
        f.write("\n".join(results_lines))
    if results:
        print("For DLT results...")
        print("AUC@5\t AUC@10\t AUC@25\t Prec\t Recall\t")
        print("{:.2f}\t {:.2f}\t {:.2f}\t {:.2f}\t {:.2f}".format(
            *results["dlt_auc"], results["precision"], results["recall"]))
        print("For homography results...")
        print("AUC@5\t AUC@10\t AUC@25\t Prec\t Recall\t")
        print("{:.2f}\t {:.2f}\t {:.2f}\t {:.2f}\t {:.2f}".format(
            *results["ransac_auc"], results["precision"], results["recall"]))
    # completion ping (reference: eval_homography.py:268); no-op unless
    # GIMS_NOTIFY_URL is set
    from gims_tpu_torch.core.notify import send_notify

    send_notify("eval_homography done: " + (
        "auc {:.2f}/{:.2f}/{:.2f}".format(*results["ransac_auc"])
        if results else "no results"))
    return results


def make_structured_image(rng, height: int, width: int) -> np.ndarray:
    """Procedural scene with photographic keypoint statistics (layered
    shaded shapes, soft shadows, multi-scale texture, vignetting): the JAX
    package's ``make_structured_image``, the same draws from `rng` (a
    ``np.random.RandomState``) in the same order and the same float32
    arithmetic, so the same uint8 (H, W, 3) image."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    gx, gy = rng.uniform(-1, 1, 2)
    base = 110 + 60 * (gx * xx / width + gy * yy / height)
    img = np.repeat(base[:, :, None], 3, axis=2)
    img += rng.uniform(-18, 18, (1, 1, 3))
    img = img.astype(np.float32)

    for _ in range(rng.randint(25, 55)):
        layer = np.zeros((height, width, 3), np.float32)
        color = rng.uniform(30, 225, 3)
        kind = rng.randint(3)
        cx, cy = rng.randint(0, width), rng.randint(0, height)
        if kind == 0:
            ax_, bx_ = rng.randint(8, width // 3), rng.randint(8, height // 3)
            drawing.ellipse(layer, (cx, cy), (ax_, bx_), rng.uniform(0, 180), 0, 360,
                            color.tolist(), -1, drawing.LINE_AA)
        elif kind == 1:
            npts = rng.randint(3, 7)
            r = rng.randint(10, min(height, width) // 3)
            ang = rng.uniform(0, 2 * np.pi, npts)
            ang.sort()
            pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                           axis=1).astype(np.int32)
            drawing.fill_poly(layer, [pts], color.tolist(), drawing.LINE_AA)
        else:
            w2, h2 = rng.randint(10, width // 3), rng.randint(10, height // 3)
            drawing.rectangle(layer, (cx - w2 // 2, cy - h2 // 2), (cx + w2 // 2, cy + h2 // 2),
                              color.tolist(), -1, drawing.LINE_AA)
        mask = layer.sum(axis=2) > 0
        # per-shape linear shading + occasional fine texture
        shade = 1.0 + 0.35 * ((xx - cx) / width * rng.uniform(-1, 1)
                              + (yy - cy) / height * rng.uniform(-1, 1))
        layer *= shade[:, :, None]
        if rng.rand() < 0.4:
            tex = rng.randn(height // 4, width // 4, 1).astype(np.float32)
            tex = imgproc.resize(tex[:, :, 0], (width, height))[:, :, None]
            layer += 14.0 * tex * mask[:, :, None]
        # soft drop shadow: darken under a shifted copy of the mask
        sh = np.roll(mask.astype(np.float32),
                     (rng.randint(3, 9), rng.randint(3, 9)), (0, 1))
        sh = imgproc.gaussian_blur(sh, 3.0)
        img *= (1.0 - 0.25 * sh)[:, :, None]
        a = rng.uniform(0.75, 1.0)
        img = np.where(mask[:, :, None], (1 - a) * img + a * layer, img)

    # vignette + fine grain + mild blur (sensor-ish statistics)
    r2 = (((xx - width / 2) / width) ** 2 + ((yy - height / 2) / height) ** 2)
    img *= (1.0 - 0.35 * r2)[:, :, None]
    img += rng.randn(height, width, 3) * 2.0
    img = imgproc.gaussian_blur(img, 0.8)
    return np.clip(img, 0, 255).astype(np.uint8)


def _noise_image(low, height, width):
    img = imgproc.resize(low, (width, height), interpolation=imgproc.INTER_CUBIC)
    return imgproc.gaussian_blur(img, 1.2)


def _source_image(path, height, width):
    img = image_io.imread(str(path))
    if img is None:
        raise FileNotFoundError(path)
    return imgproc.resize(img, (width, height))


def generate_benchmark(out_dir: str, n_pairs=50, source_dir=None,
                       height=600, width=800, seed=3,
                       style: str = "noise"):
    """Create a deterministic benchmark set with the reference's file
    contract (reference: generate_pairs.py).

    Uses PNG or JPEG images from source_dir when given, else procedural textures
    (the ``noise`` style). The random draws are made in the JAX package's
    order, one pair after the other; the images are then made and written
    by a pool of threads (numpy and zlib release the interpreter lock).
    Returns (homo_txt_path, images_dir)."""
    out = Path(out_dir)
    images_dir = out / "images"
    images_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    source = None
    if source_dir is not None:
        source = [
            p for p in sorted(Path(source_dir).iterdir())
            if p.suffix.lower() in (".jpg", ".png", ".jpeg")
        ]
    jobs = []
    for i in range(n_pairs):
        name = f"pair_{i:04d}.png"
        if source:
            jobs.append((name, _source_image, (source[i % len(source)], height, width)))
        elif style == "structured":
            # made here: its draws come from rng between the pairs' homographies
            jobs.append((name, np.asarray, (make_structured_image(rng, height, width),)))
        else:
            low = rng.randint(0, 255, (height // 4, width // 4, 3)).astype(np.uint8)
            jobs.append((name, _noise_image, (low, height, width)))
        H = get_perspective_mat(
            0.85, width // 2, height // 2, 0.0008, 0.0008, 0.04, 10, 25,
            0.6, 0.6, rng,
        )
        lines.append(name + " " + " ".join(str(float(v)) for v in H.reshape(-1)))

    def make(job):
        name, fn, args = job
        image_io.imwrite(str(images_dir / name), fn(*args))

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(make, jobs))
    txt = out / "pairs_homo.txt"
    txt.write_text("\n".join(lines) + "\n")
    return str(txt), str(images_dir)
