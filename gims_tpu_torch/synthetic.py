"""Synthetic requests and image pairs with known ground truth, made with numpy.

A request of the staged ``Matching`` API (``api.py``) in which view 1 is a
known homography of view 0. The descriptors are SIFT-like: 128
non-negative values, L2-normed, then duplicated to 256 as the staged
frontend does for SIFT (``gims_tpu/frontend/feature.py``). And gray image
pairs for ``FusedMatching`` in which view 1 is view 0 warped by a known
homography (``synthetic_image_pair``). Nothing here needs an image library.
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


# ---------------------------------------------------------------- image pairs


def _resize_bilinear(img, h, w):
    """(h0, w0) f32 -> (h, w), bilinear with half-pixel centres."""
    h0, w0 = img.shape

    def axis(n_out, n_in):
        x = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
        i0 = np.floor(x).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, (x - i0).astype(np.float32)

    y0, y1, fy = axis(h, h0)
    x0, x1, fx = axis(w, w0)
    rows = img[y0] * (1 - fy)[:, None] + img[y1] * fy[:, None]
    return rows[:, x0] * (1 - fx) + rows[:, x1] * fx


def _gaussian_blur(img, sigma):
    """Separable Gaussian blur, reflect-101 borders, radius 4 sigma."""
    r = int(np.ceil(4 * sigma))
    t = np.arange(-r, r + 1)
    k = np.exp(-t**2 / (2 * sigma**2))
    k = (k / k.sum()).astype(np.float32)
    for axis in (0, 1):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        p = np.pad(img, pad, mode="reflect")
        n = img.shape[axis]
        img = sum(k[i] * np.take(p, np.arange(i, i + n), axis=axis)
                  for i in range(2 * r + 1))
    return img


def warp_image(img, H):
    """img (h, w) warped by the homography H (view-0 xy -> view-1 xy):
    every output pixel samples the input bilinearly at H^-1 of its
    coordinates; pixels that map outside the input are 0."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w]
    src = warp(np.linalg.inv(H), np.stack([xx.ravel(), yy.ravel()], 1).astype(np.float64))
    sx, sy = src[:, 0], src[:, 1]
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    x0 = np.clip(np.floor(sx).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(sy).astype(np.int64), 0, h - 2)
    fx, fy = sx - x0, sy - y0
    val = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
           + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    return np.where(inside, val, 0.0).reshape(h, w)


def synthetic_image_pair(seed, frame=FRAME, colour: bool = False):
    """Two (h, w) uint8 gray views with a known homography H, as the JAX
    package's bench makes its pairs, with numpy only: a random texture of
    a quarter of the resolution, upsampled, blurred (sigma 1.2), and a copy
    rotated by up to 15 degrees and scaled by 0.85-1.1 about the centre.
    With `colour`, (h, w, 3) views whose three channels are independent
    textures, as the bench's BGR images. Returns (img0, img1, H)."""
    rng = np.random.RandomState(1000 + seed)
    h, w = frame
    low = rng.randint(0, 255, (h // 4, w // 4, 3) if colour else (h // 4, w // 4))
    planes = low.astype(np.float32).reshape(h // 4, w // 4, -1)
    imgs = [_gaussian_blur(_resize_bilinear(planes[..., c], h, w), 1.2)
            for c in range(planes.shape[-1])]
    ang = np.deg2rad(rng.uniform(-15, 15))
    s = rng.uniform(0.85, 1.1)
    c = np.array([[1, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1]], np.float64)
    a = np.array([[s * np.cos(ang), s * np.sin(ang), 0],
                  [-s * np.sin(ang), s * np.cos(ang), 0], [0, 0, 1]])
    H = np.linalg.inv(c) @ a @ c
    img1 = [warp_image(img, H) for img in imgs]
    as_u8 = lambda x: np.clip(np.rint(np.stack(x, -1) if colour else x[0]),  # noqa: E731
                              0, 255).astype(np.uint8)
    return as_u8(imgs), as_u8(img1), H
