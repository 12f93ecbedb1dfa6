"""Training data: self-supervised homography pairs (numpy, on the host).

Port of ``gims_tpu/train/data.py`` (reference: utils/preprocess_utils.py:
6-72, 134-175, utils/dataset.py): ``get_perspective_mat`` draws from the
caller's ``RandomState`` in the JAX package's order, so that one seed gives
the same homographies, the same photometric draws and the same pairs in
both packages. OpenCV's calls are the port's ``core/imgproc.py``:
``perspective_transform``, ``warp_perspective`` (5-bit fixed-point
weights in OpenCV, so a few pixels of a warped image differ by one level),
``resize`` (INTER_CUBIC, INTER_LINEAR, INTER_AREA), ``gaussian_blur`` and
``filter2d``; the port reads PNG only (``core/image_io.py``), so
``CocoPairDataset``, ``ImageFolderPairDataset`` and
``FixedHomographyDataset`` raise on a JPEG, naming the ROADMAP item of its
decoder.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gims_tpu_torch.config import DatasetConfig
from gims_tpu_torch.core import imgproc
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


def resize_aspect_ratio(image, resize_h, resize_w, rng=None):
    """Reference: preprocess_utils.py:156-175 (cv2.resize's default,
    INTER_LINEAR)."""
    rng = rng or np.random
    h, w = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    max_size = max(h, w)
    nh, nw = int(resize_h * h / max_size), int(resize_w * w / max_size)
    resized = imgproc.resize(image, (nw, nh))
    fill = rng.randint(0, 127)
    shape = (resize_h, resize_w) if channels == 1 else (resize_h, resize_w, channels)
    template = np.full(shape, fill, np.uint8)
    sh, sw = (resize_h - nh) // 2, (resize_w - nw) // 2
    template[sh:sh + nh, sw:sw + nw] = resized
    return template


# --- photometric augmentation (the JAX package's replacement of
#     albumentations; reference: utils/dataset.py:25-29 distributions) ---

def apply_photometric(image, rng):
    """OneOf(brightness 0.4 | contrast 0.3) p=0.6, then
    OneOf(motion blur | gauss noise) p=0.5, wrapped at p=0.65."""
    if rng.uniform() > 0.65:
        return image
    img = image.astype(np.float32)
    if rng.uniform() < 0.6:
        if rng.uniform() < 0.6 / 1.3:
            img = img * (1.0 + rng.uniform(-0.4, 0.4))
        else:
            mean = img.mean()
            img = (img - mean) * (1.0 + rng.uniform(-0.3, 0.3)) + mean
    if rng.uniform() < 0.5:
        if rng.uniform() < 0.5:
            k = rng.choice([3, 5, 7])
            kernel = np.zeros((k, k), np.float32)
            if rng.uniform() < 0.5:
                kernel[k // 2, :] = 1.0 / k
            else:
                kernel[:, k // 2] = 1.0 / k
            img = imgproc.filter2d(img, kernel)
        else:
            img = img + rng.normal(0, rng.uniform(3, 7), img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# --- datasets ---

def _read_png(path, flags=None):
    from gims_tpu_torch.core.image_io import IMREAD_COLOR, imread

    if not path.lower().endswith(".png"):
        raise NotImplementedError(
            f"{os.path.basename(path)}: the port reads PNG only; a JPEG decoder is "
            "ROADMAP.md section 1 item 4")
    return imread(path, IMREAD_COLOR if flags is None else flags)


class CocoPairDataset:
    """COCO2017 self-supervised pairs (reference: utils/dataset.py:10-66).

    Parses annotations/instances_{split}2017.json directly (only file names
    are used), or lists the image directory when the json is absent. Each
    index draws its pair from its own RandomState, so sample i is the same
    pair in any order and in both packages."""

    def __init__(self, cfg: DatasetConfig, split="train", limit=-1, color=True, seed=0):
        self.cfg = cfg
        self.color = color
        self.images_path = os.path.join(cfg.dataset_path, f"{split}2017")
        json_path = os.path.join(cfg.dataset_path, "annotations",
                                 f"instances_{split}2017.json")
        if os.path.exists(json_path):
            with open(json_path) as f:
                files = [im["file_name"] for im in json.load(f)["images"]]
        else:
            files = sorted(os.listdir(self.images_path))
        if limit and limit > 0:
            files = files[:limit]
        self.files = files
        self.seed = seed

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        from gims_tpu_torch.core.image_io import IMREAD_COLOR, IMREAD_GRAYSCALE

        image = _read_png(os.path.join(self.images_path, self.files[index]),
                          IMREAD_COLOR if self.color else IMREAD_GRAYSCALE)
        rng = np.random.RandomState(self.seed * 100003 + 59 + index)
        return make_pair(image, self.cfg, rng)


class ImageFolderPairDataset:
    """Homography pairs from a small folder of source images: each index
    picks a source image (cycling) and a random crop of 55-100% of its area,
    resized with INTER_AREA."""

    def __init__(self, cfg: DatasetConfig, folder, length=1000, seed=0):
        self.cfg = cfg
        self.paths = sorted(p for p in os.listdir(folder)
                            if p.lower().endswith((".jpg", ".jpeg", ".png")))
        self.folder = folder
        self.length = length
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self._cache = {}

    def __len__(self):
        return self.length

    def _load(self, name):
        if name not in self._cache:
            self._cache[name] = _read_png(os.path.join(self.folder, name))
        return self._cache[name]

    def __getitem__(self, index):
        rng = np.random.RandomState(self.seed * 99991 + index)
        img = self._load(self.paths[index % len(self.paths)])
        h, w = img.shape[:2]
        f = rng.uniform(0.55, 1.0)
        ch, cw = max(int(h * f), 64), max(int(w * f), 64)
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        crop = img[y0:y0 + ch, x0:x0 + cw]
        crop = imgproc.resize(crop, (self.cfg.image_width, self.cfg.image_height),
                              imgproc.INTER_AREA)
        return make_pair(crop, self.cfg, rng)


class MixedPairDataset:
    """Round-robin mix of several pair datasets."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.length = sum(len(d) for d in self.datasets)

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        k = index % len(self.datasets)
        d = self.datasets[k]
        return d[(index // len(self.datasets)) % len(d)]


class SyntheticPairDataset:
    """Procedural textured images, so the train loop runs without a dataset
    on disk: uniform noise at a quarter of the frame, cubic 4x upscale,
    Gaussian blur of sigma 1, then ``make_pair``; one RandomState per index."""

    def __init__(self, cfg: DatasetConfig, length=1000, seed=0):
        self.cfg = cfg
        self.length = length
        self.seed = seed
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        rng = np.random.RandomState(self.seed * 100003 + index)
        h, w = self.cfg.image_height, self.cfg.image_width
        img = rng.randint(0, 255, (h // 4, w // 4, 3)).astype(np.uint8)
        img = imgproc.resize(img, (w, h), imgproc.INTER_CUBIC)
        img = imgproc.gaussian_blur(img, 1.0)
        return make_pair(img, self.cfg, rng)


def make_pair(image, cfg: DatasetConfig, rng):
    """image -> (orig, warped, H) at (image_height, image_width)."""
    if cfg.resize_aspect:
        image = resize_aspect_ratio(image, cfg.image_height, cfg.image_width, rng)
    height, width = image.shape[:2]
    H = get_perspective_mat(
        cfg.patch_ratio, width // 2, height // 2, cfg.perspective_x,
        cfg.perspective_y, cfg.shear_ratio, cfg.shear_angle,
        cfg.rotation_angle, cfg.scale, cfg.translation, rng,
    )
    warped = imgproc.warp_perspective(image.copy(), H, (width, height))
    if not cfg.resize_aspect:
        image = imgproc.resize(image, (cfg.image_width, cfg.image_height), imgproc.INTER_AREA)
        warped = imgproc.resize(warped, (cfg.image_width, cfg.image_height), imgproc.INTER_AREA)
    if cfg.apply_color_aug:
        image = apply_photometric(image, rng)
        warped = apply_photometric(warped, rng)
    H = scale_homography(H, height, width, cfg.image_height, cfg.image_width).astype(np.float32)
    return image, warped, H


class FixedHomographyDataset:
    """Validation pairs from a '<name> h00..h22' text file
    (reference: utils/dataset.py:68-101 + assets/coco_val_images_homo.txt)."""

    def __init__(self, cfg: DatasetConfig, txt_path, images_path):
        self.cfg = cfg
        self.images_path = images_path
        with open(txt_path) as f:
            self.entries = [line.strip().split(" ") for line in f if line.strip()]

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, index):
        parts = self.entries[index]
        H = np.array(list(map(float, parts[1:]))).reshape(3, 3).astype(np.float32)
        image = _read_png(os.path.join(self.images_path, parts[0]))
        height, width = image.shape[:2]
        warped = imgproc.warp_perspective(image.copy(), H, (width, height))
        size = (self.cfg.image_width, self.cfg.image_height)
        image = imgproc.resize(image, size, imgproc.INTER_AREA)
        warped = imgproc.resize(warped, size, imgproc.INTER_AREA)
        H = scale_homography(H, height, width, self.cfg.image_height,
                             self.cfg.image_width).astype(np.float32)
        return image, warped, H
