"""Pose/epipolar geometry utilities.

A copy of the numpy helpers of ``gims_tpu/eval/geometry.py``;
``estimate_pose``, OpenCV's five-point RANSAC and cheirality check there,
runs through ``eval/essential.py`` in torch on the caller's device.

Behavioral spec: the reference's geometry helpers
(reference: utils/common.py:389-512), which are themselves vendored from
the SuperGlue evaluation utilities (magicleap/SuperGluePretrainedNetwork,
models/utils.py — standard relative-pose math: RANSAC essential matrix +
cheirality disambiguation, intrinsics rotation/scaling, symmetric
epipolar distance, angular pose errors).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gims_tpu_torch.eval import essential


def _normalize_points(pts: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Pixel -> normalized camera coordinates: (p - c) / f per axis."""
    center = np.array([K[0, 2], K[1, 2]], dtype=np.float64)
    focal = np.array([K[0, 0], K[1, 1]], dtype=np.float64)
    return (pts - center) / focal


def estimate_pose(kpts0, kpts1, K0, K1, thresh, conf=0.99999,
                  device: Optional[str] = None):
    """RANSAC essential matrix -> (R, t, inlier_mask) or None.

    ``essential.find_essential_mat`` can return a stack of candidate 3x3
    matrices (from exactly 5 points); each is disambiguated with
    ``essential.recover_pose`` (cheirality check) and the candidate with the
    most points in front of both cameras wins. Each check narrows the mask
    it is given to its pose's cheirality, as ``cv2.recoverPose`` writes it
    back into the mask the JAX package passes. The pixel threshold is
    converted to normalized coordinates with the mean focal length of both
    cameras (the reference's convention, utils/common.py:392-399). Runs on
    `device` (``cuda`` unless the caller names another).
    """
    if len(kpts0) < 5:
        return None
    pts0 = _normalize_points(np.asarray(kpts0), K0)
    pts1 = _normalize_points(np.asarray(kpts1), K1)
    focals = (K0[0, 0], K0[1, 1], K1[0, 0], K1[1, 1])
    ransac_thresh = thresh / np.mean(focals)
    found = essential.find_essential_mat(pts0, pts1, ransac_thresh, prob=conf, device=device)
    if found is None:
        return None
    E_stack, mask = found
    best = None
    best_inliers = 0
    for E in E_stack:
        # JAX's call passes 1e9 positionally, and OpenCV's Python binding
        # takes it as the R output of the overload without a distance
        # threshold (it returns four values), so its cheirality check runs
        # at OpenCV's default distance of 50; so does the port's
        n, R, t, mask = essential.recover_pose(E, pts0, pts1, essential.DEFAULT_DISTANCE, mask,
                                               device=device)
        if n > best_inliers:
            best_inliers = n
            best = (R, t, mask.ravel() > 0)
    return best


def rotate_intrinsics(K, image_shape, rot):
    """Intrinsics after rotating the image by rot * 90 degrees CCW."""
    assert rot <= 3
    rot = rot % 4
    h, w = image_shape[:2]
    if rot % 2:
        h, w = w, h
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    if rot == 1:
        rows = [[fy, 0.0, cy], [0.0, fx, w - 1 - cx], [0.0, 0.0, 1.0]]
    elif rot == 2:
        rows = [[fx, 0.0, w - 1 - cx], [0.0, fy, h - 1 - cy],
                [0.0, 0.0, 1.0]]
    else:  # rot == 3 (and the rot == 0 caller never reaches here)
        rows = [[fy, 0.0, h - 1 - cy], [0.0, fx, cx], [0.0, 0.0, 1.0]]
    return np.array(rows, dtype=K.dtype)


def rotate_pose_inplane(i_T_w, rot):
    """Compose a 4x4 pose with an in-plane rotation of rot * 90 degrees."""
    angle = np.deg2rad((0, 270, 180, 90)[rot])
    c, s = np.cos(angle), np.sin(angle)
    R4 = np.array([
        [c, -s, 0.0, 0.0],
        [s, c, 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ], dtype=np.float32)
    return R4 @ i_T_w


def scale_intrinsics(K, scales):
    """Intrinsics after scaling the image by (sx, sy)."""
    return np.diag([1.0 / scales[0], 1.0 / scales[1], 1.0]) @ K


def to_homogeneous(points):
    return np.concatenate([points, np.ones_like(points[:, :1])], axis=-1)


def compute_epipolar_error(kpts0, kpts1, T_0to1, K0, K1):
    """Symmetric squared epipolar distance in normalized coordinates.

    E = [t]_x R from the relative pose; the per-match error is
    (p1^T E p0)^2 * (1/||E p0||_line^2 + 1/||E^T p1||_line^2).
    """
    p0 = to_homogeneous(_normalize_points(np.asarray(kpts0), K0))
    p1 = to_homogeneous(_normalize_points(np.asarray(kpts1), K1))
    t = T_0to1[:3, 3]
    t_skew = np.array([
        [0.0, -t[2], t[1]],
        [t[2], 0.0, -t[0]],
        [-t[1], t[0], 0.0],
    ])
    E = t_skew @ T_0to1[:3, :3]
    Ep0 = p0 @ E.T
    Etp1 = p1 @ E
    num = np.sum(p1 * Ep0, axis=-1) ** 2
    return num * (1.0 / (Ep0[:, 0] ** 2 + Ep0[:, 1] ** 2)
                  + 1.0 / (Etp1[:, 0] ** 2 + Etp1[:, 1] ** 2))


def angle_error_mat(R1, R2):
    cos = (np.trace(R1.T @ R2) - 1.0) / 2.0
    return np.rad2deg(np.abs(np.arccos(np.clip(cos, -1.0, 1.0))))


def angle_error_vec(v1, v2):
    n = np.linalg.norm(v1) * np.linalg.norm(v2)
    return np.rad2deg(np.arccos(np.clip(np.dot(v1, v2) / n, -1.0, 1.0)))


def compute_pose_error(T_0to1, R, t):
    """(translation angular error, rotation angular error) in degrees;
    translation direction is sign-ambiguous from an essential matrix, so
    the error folds at 90 degrees."""
    error_t = angle_error_vec(t, T_0to1[:3, 3])
    error_t = np.minimum(error_t, 180.0 - error_t)
    error_R = angle_error_mat(R, T_0to1[:3, :3])
    return error_t, error_R
