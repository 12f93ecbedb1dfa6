"""Pose/epipolar geometry utilities (host numpy).

A copy of the numpy helpers of ``gims_tpu/eval/geometry.py``;
``estimate_pose``, which needs OpenCV there, raises here.

Behavioral spec: the reference's geometry helpers
(reference: utils/common.py:389-512), which are themselves vendored from
the SuperGlue evaluation utilities (magicleap/SuperGluePretrainedNetwork,
models/utils.py — standard relative-pose math: RANSAC essential matrix +
cheirality disambiguation, intrinsics rotation/scaling, symmetric
epipolar distance, angular pose errors).
"""

from __future__ import annotations

import numpy as np


def _normalize_points(pts: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Pixel -> normalized camera coordinates: (p - c) / f per axis."""
    center = np.array([K[0, 2], K[1, 2]], dtype=np.float64)
    focal = np.array([K[0, 0], K[1, 1]], dtype=np.float64)
    return (pts - center) / focal


def estimate_pose(kpts0, kpts1, K0, K1, thresh, conf=0.99999):
    """RANSAC essential matrix -> (R, t, inlier_mask) or None.

    The JAX package calls OpenCV's five-point solver
    (``cv2.findEssentialMat``, then ``cv2.recoverPose`` for the cheirality
    check). The port has neither yet, so this raises.
    """
    raise NotImplementedError(
        "estimate_pose needs OpenCV's findEssentialMat / recoverPose (a five-point "
        "RANSAC solver), not ported yet (ROADMAP.md §1, estimate_pose)")


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
