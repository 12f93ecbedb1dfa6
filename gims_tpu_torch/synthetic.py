"""Synthetic keypoint requests with known ground truth, made with numpy.

A request of the staged ``Matching`` API (``api.py``) in which view 1 is a
known homography of view 0. The descriptors are SIFT-like: 128
non-negative values, L2-normed, then duplicated to 256 as the staged
frontend does for SIFT (``gims_tpu/frontend/feature.py``). Nothing here
needs an image library.
"""

from __future__ import annotations

import numpy as np

FRAME = (600, 800)  # (H, W)
EVAL_KNOBS = {"radius": 15, "percentile": 2, "min_size": 7}  # eval_homography.py


def sift_like(rng, n):
    """n raw SIFT-like descriptors: sparse, non-negative, 128 values."""
    raw = rng.gamma(0.5, 1.0, (n, 128)) * (rng.rand(n, 128) < 0.6)
    return raw.astype(np.float32)


def normalize_duplicate(raw):
    d = raw / np.maximum(np.linalg.norm(raw, axis=1, keepdims=True), 1e-12)
    return np.concatenate([d, d], axis=1).astype(np.float32)


def homography(rng, h, w):
    """A known mild homography about the frame centre."""
    ang = np.deg2rad(rng.uniform(-12, 12))
    s = rng.uniform(0.9, 1.1)
    c = np.array([[1, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1]], np.float64)
    a = np.array([[s * np.cos(ang), -s * np.sin(ang), rng.uniform(-20, 20)],
                  [s * np.sin(ang), s * np.cos(ang), rng.uniform(-20, 20)],
                  [rng.uniform(-2e-5, 2e-5), rng.uniform(-2e-5, 2e-5), 1]])
    return np.linalg.inv(c) @ a @ c


def warp(H, pts):
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ H.T
    return p[:, :2] / p[:, 2:3]


def synthetic_request(seed, n, frame=FRAME, outliers=0.25):
    """A keypoint request: view 1 is a known homography of view 0 with
    0.5 px jitter; view-0 points that leave the frame and a share of
    `outliers` are replaced in view 1 by random points with random
    descriptors. Returns (request dict, H)."""
    rng = np.random.RandomState(seed)
    h, w = frame
    H = homography(rng, h, w)
    kp0 = (rng.rand(n, 2) * [w, h]).astype(np.float32)
    raw0 = sift_like(rng, n)
    kp1 = warp(H, kp0) + rng.randn(n, 2) * 0.5
    raw1 = np.maximum(raw0 * (1 + 0.1 * rng.randn(n, 128)), 0)
    bad = ((kp1[:, 0] < 0) | (kp1[:, 0] >= w) | (kp1[:, 1] < 0) | (kp1[:, 1] >= h)
           | (rng.rand(n) < outliers))
    kp1[bad] = rng.rand(int(bad.sum()), 2) * [w, h]
    raw1[bad] = sift_like(rng, int(bad.sum()))
    perm = rng.permutation(n)
    image = np.zeros((h, w, 3), np.uint8)
    req = {
        "image0": image, "image1": image,
        "keypoints0": kp0, "descriptors0": normalize_duplicate(raw0),
        "scores0": rng.rand(n).astype(np.float32),
        "keypoints1": kp1[perm].astype(np.float32),
        "descriptors1": normalize_duplicate(raw1[perm]),
        "scores1": rng.rand(n).astype(np.float32),
        **EVAL_KNOBS,
    }
    return req, H


def correct_share(pred, H, px=3.0):
    """Share of matches that agree with the ground-truth homography."""
    m = pred["matches0"][0]
    i = np.nonzero(m >= 0)[0]
    if len(i) == 0:
        return 0.0
    err = np.linalg.norm(warp(H, pred["keypoints0"][0][i])
                         - pred["keypoints1"][0][m[i]], axis=1)
    return float(np.mean(err < px))
