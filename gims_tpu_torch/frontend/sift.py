"""Keypoints as arrays, and the host OpenCV SIFT detector that the port lacks.

Port of the parts of ``gims_tpu/frontend/sift.py`` that need no OpenCV:
``KeypointArrays``, the struct-of-arrays form of a keypoint set that the
patch warp, the dense samplers and the SIFT descriptor read, and
``unpack_octaves`` (reference: utils/library.py:16-35). The JAX package
detects and describes with ``cv2.SIFT`` on the host (``detect``,
``detect_and_describe``, ``make_sift``). The machine with the card has no
OpenCV, so those raise here: the port's detector is the device DoG detector
(``frontend/detect_device.py``, ``detector="device"``) and its SIFT
descriptor the device one (``frontend/sift_descriptor.py``,
``sift_descriptor="device"``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

OPENCV_TODO = ("needs host OpenCV SIFT (cv2), which the port does not have; "
               "use detector='device' and sift_descriptor='device' (ROADMAP.md "
               "queues a cv2-free host SIFT)")


@dataclass
class KeypointArrays:
    """Struct-of-arrays view of a keypoint set (numpy, on the host)."""

    pt: np.ndarray        # (N, 2) f32 xy in input-image coordinates
    size: np.ndarray      # (N,) f32
    angle: np.ndarray     # (N,) f32 degrees
    response: np.ndarray  # (N,) f32
    octave: np.ndarray    # (N,) i32 unpacked octave (>= -1)
    layer: np.ndarray     # (N,) i32 layer within octave
    scale: np.ndarray     # (N,) f32 1/2^octave

    def __len__(self):
        return self.pt.shape[0]

    def head(self, n: int) -> "KeypointArrays":
        """The first n keypoints."""
        return KeypointArrays(self.pt[:n], self.size[:n], self.angle[:n],
                              self.response[:n], self.octave[:n], self.layer[:n],
                              self.scale[:n])


def unpack_octaves(packed: np.ndarray):
    """Vectorized unpack of OpenCV's kp.octave field
    (reference: utils/library.py:16-35)."""
    packed = packed.astype(np.int64)
    octave = packed & 0xFF
    layer = (packed >> 8) & 0xFF
    octave = np.where(octave >= 128, octave | ~0xFF, octave)
    scale = np.where(
        octave >= 0, 1.0 / (1 << np.maximum(octave, 0)),
        (1 << np.maximum(-octave, 0)).astype(np.float64),
    ).astype(np.float32)
    return octave.astype(np.int32), layer.astype(np.int32), scale


def make_sift(cfg):
    raise NotImplementedError(f"make_sift {OPENCV_TODO}")


def detect(image_bgr, cfg, max_keypoints=None, train_topup=False, rng=None):
    raise NotImplementedError(f"host SIFT detection {OPENCV_TODO}")


def detect_and_describe(image_bgr, cfg, max_keypoints=None, train_topup=False, rng=None):
    raise NotImplementedError(f"host SIFT descriptors {OPENCV_TODO}")
