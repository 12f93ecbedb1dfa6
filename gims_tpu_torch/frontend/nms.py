"""Keypoint post-processing: DIoU-NMS, rootSIFT, an image-folder streamer.

Port of ``gims_tpu/frontend/nms.py`` (reference utils/common.py:698-807,
``rootSIFT``, ``diou_nms``, ``process_diou_nms``; the streamer after
common.py:177-314). ``diou_nms`` computes every pair's DIoU in float32 on
the caller's device, with the JAX package's arithmetic in its order, then
runs JAX's greedy walk over the suppression matrix on the host, so the
kept set is JAX's. ``nms_keypoints`` takes the port's keypoint arrays
(xy, size, response) in place of cv2 keypoints and returns the kept rows.
"""

from __future__ import annotations

import glob as globmod
from pathlib import Path

import numpy as np
import torch

from gims_tpu_torch.core import image_io, imgproc

IMAGE_SUFFIXES = (".jpg", ".png", ".jpeg")
VIDEO_SUFFIXES = (".mp4", ".avi", ".mkv")


def root_sift(descs, eps=1e-7, l2norm=False):
    """Hellinger-kernel normalization of SIFT descriptors (reference:
    common.py:698-708); numpy or torch, in the input's type."""
    sqrt = torch.sqrt if torch.is_tensor(descs) else np.sqrt
    descs = descs / (descs.sum(axis=1, keepdims=True) + eps)
    descs = sqrt(descs)
    if l2norm:
        descs = descs / sqrt((descs ** 2).sum(axis=1, keepdims=True) + 1e-10)
    return descs


def greedy_order(scores: torch.Tensor) -> torch.Tensor:
    """Highest score first, as ``scores.argsort()[::-1]``: ties in
    descending index (numpy's sort is stable on the short arrays where ties
    arise in its tests; distinct scores have one order)."""
    return torch.flip(torch.sort(scores, stable=True)[1], [0])


def suppression(dets: torch.Tensor, iou_thresh: float, beta: float = 1.0) -> torch.Tensor:
    """(N, N) bool: box j is dropped once box i is kept (DIoU(i, j) above
    the threshold), float32 in the JAX package's order of operations."""
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    i, j = (slice(None), None), (None, slice(None))
    w = torch.clamp(torch.minimum(x2[i], x2[j]) - torch.maximum(x1[i], x1[j]) + 1, min=0.0)
    h = torch.clamp(torch.minimum(y2[i], y2[j]) - torch.maximum(y1[i], y1[j]) + 1, min=0.0)
    inter = w * h
    iou = inter / (areas[i] + areas[j] - inter)
    diag2 = ((torch.maximum(x2[i], x2[j]) - torch.minimum(x1[i], x1[j])) ** 2
             + (torch.maximum(y2[i], y2[j]) - torch.minimum(y1[i], y1[j])) ** 2)
    cdist2 = (cx[i] - cx[j]) ** 2 + (cy[i] - cy[j]) ** 2
    diou = iou - torch.pow(cdist2 / (diag2 + 1e-10), beta)
    return ~(diou <= iou_thresh)


def diou_nms_indices(dets, scores, iou_thresh=None, beta=1.0) -> np.ndarray:
    """Rows of the kept boxes in the greedy walk's order."""
    iou_thresh = iou_thresh or 0.5
    dets = torch.as_tensor(dets, dtype=torch.float32)
    scores = torch.as_tensor(scores, dtype=torch.float32, device=dets.device)
    drop = suppression(dets, iou_thresh, beta).cpu().numpy()
    order = greedy_order(scores).cpu().numpy()
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        order = order[1:][~drop[i, order[1:]]]
    return np.asarray(keep, np.int64)


def diou_nms(dets, scores, iou_thresh=None, beta=1.0):
    """Distance-IoU NMS over [x1, y1, x2, y2] boxes; returns the kept boxes
    (reference: common.py:720-776), a tensor on `dets`' device."""
    dets = torch.as_tensor(dets, dtype=torch.float32)
    keep = diou_nms_indices(dets, scores, iou_thresh, beta)
    return dets[torch.as_tensor(keep, device=dets.device)]


def nms_keypoints(xy, size, response, radius=None, iou_thresh=0.3) -> np.ndarray:
    """DIoU-NMS over keypoints (reference: common.py:778-807): a box of side
    `radius` (the keypoint's size without one) around each. Returns the
    indices of the surviving keypoints in JAX's order: for each kept box,
    the first row with the same box."""
    xy = np.asarray(xy, np.float32).reshape(-1, 2)
    if radius == 0:
        return np.arange(len(xy))
    half = (np.float64(radius) / 2 if radius else
            np.asarray(size, np.float32).astype(np.float64) / 2)
    x, y = xy[:, 0].astype(np.float64), xy[:, 1].astype(np.float64)
    dets = np.stack([x - half, y - half, x + half, y + half], 1).astype(np.float32)
    keep = diou_nms_indices(dets, np.asarray(response, np.float32), iou_thresh)
    same = (dets[keep][:, None, :] == dets[None, :, :]).all(-1)
    return same.argmax(1)


class ImageStreamer:
    """Sequential frames from a directory or a glob of images, each resized
    with INTER_AREA (the reference's VideoStreamer capability,
    utils/common.py:177-314). Video files need a video decoder, which the
    port does not have: they raise NotImplementedError (ROADMAP.md)."""

    def __init__(self, source, resize=(640, 480), skip=1, max_length=10 ** 6):
        self.resize = resize
        self.i = 0
        path = Path(str(source))
        if path.is_dir():
            listing = sorted(p for p in path.iterdir() if p.suffix.lower() in IMAGE_SUFFIXES)
            self.listing = listing[::skip][:max_length]
        elif path.exists() and path.suffix.lower() in VIDEO_SUFFIXES:
            raise NotImplementedError(f"video source {source}: the port reads no video "
                                      "(ROADMAP.md, formats no JAX caller needs)")
        else:
            self.listing = sorted(globmod.glob(str(source)))[::skip][:max_length]
        if not self.listing:
            raise IOError(f"no frames found at {source}")

    def next_frame(self):
        if self.i >= len(self.listing):
            return None, False
        frame = image_io.imread(str(self.listing[self.i]), image_io.IMREAD_COLOR)
        if self.resize:
            frame = imgproc.resize(frame, self.resize, interpolation=imgproc.INTER_AREA)
        self.i += 1
        return frame, True
