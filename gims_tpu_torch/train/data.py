"""Homography synthesis for self-supervised pairs (numpy).

Port of the geometry of ``gims_tpu/train/data.py`` (reference:
utils/preprocess_utils.py:6-72 and 134-143): ``get_perspective_mat`` draws
from the caller's ``RandomState`` in the JAX package's order, so that one
seed gives the same homographies in both packages. The corner projection
uses the port's ``imgproc.perspective_transform`` in place of OpenCV's.
The photometric augmentation and the datasets wait for the training slice.
"""

from __future__ import annotations

import numpy as np

from gims_tpu_torch.core.imgproc import perspective_transform


def get_rotmat(angle, as_3d=False, scale=1.0, center_x=0.0, center_y=0.0):
    cos_a, sin_a = np.cos(angle) * scale, np.sin(angle) * scale
    rotation = np.reshape([cos_a, -sin_a, sin_a, cos_a], (2, 2)).T
    if as_3d:
        m = np.eye(3)
        m[:2, :2] = rotation
        m[0, 2] = (1 - cos_a) * center_x - sin_a * center_y
        m[1, 2] = sin_a * center_x + (1 - cos_a) * center_y
        return m
    return rotation


def get_translation_mat(image_height, image_width, trans, corners, rng):
    left_top_min = np.min(corners, axis=0)
    right_bottom_min = np.min(
        np.array([image_width, image_height]) - corners, axis=0
    )
    tx_val = int(rng.uniform(0, trans) * image_width)
    ty_val = int(rng.uniform(0, trans) * image_height)
    if rng.uniform() > 0.5:
        tx = tx_val if left_top_min[0] < 0 else -tx_val
    else:
        tx = tx_val if right_bottom_min[0] > 0 else -tx_val
    if rng.uniform() > 0.5:
        ty = ty_val if left_top_min[1] < 0 else -ty_val
    else:
        ty = ty_val if right_bottom_min[1] > 0 else -ty_val
    m = np.eye(3)
    m[0, 2] = tx
    m[1, 2] = ty
    return m


def get_perspective_mat(patch_ratio, center_x, center_y, pers_x, pers_y,
                        shear_ratio, shear_angle, rotation_angle, scale,
                        trans, rng=None):
    rng = rng or np.random
    shear_angle = np.deg2rad(shear_angle)
    rotation_angle = np.deg2rad(rotation_angle)
    image_height, image_width = center_y * 2, center_x * 2
    pbw, pbh = int(patch_ratio * image_width), int(patch_ratio * image_height)
    patch_corners = np.array(
        [[0, 0], [0, pbh], [pbw, pbh], [pbw, 0]], np.float32
    )
    pers_mat = np.array(
        [[1, 0, 0], [0, 1, 0],
         [rng.normal(0, pers_x / 2), rng.normal(0, pers_y / 2), 1]]
    )
    if rng.uniform() > 0.5:
        sr = rng.uniform(1, 1 + shear_ratio)
        shear_x, shear_y = 1, 1 / sr
    else:
        sr = rng.uniform(1 - shear_ratio, 1)
        shear_x, shear_y = sr, 1
    sa = rng.uniform(-shear_angle, shear_angle)
    shear_mat = (
        get_rotmat(-sa, True, 1.0, center_x, center_y)
        @ np.diag([shear_x, shear_y, 1])
        @ get_rotmat(sa, True, 1.0, center_x, center_y)
    )
    shear_pers = shear_mat @ pers_mat
    rot = rng.uniform(-rotation_angle, rotation_angle)
    sc = rng.uniform(1, 1 + 2 * scale)
    H = get_rotmat(rot, True, sc, center_x, center_y) @ shear_pers
    tc = perspective_transform(patch_corners, H)
    H = get_translation_mat(image_height, image_width, trans, tc, rng) @ H
    return H


def scale_homography(H, src_h, src_w, dst_h, dst_w):
    """Reference: preprocess_utils.py:134-143."""
    s = np.diag([dst_w / src_w, dst_h / src_h, 1.0])
    return s @ H @ np.linalg.inv(s)
