"""``core/imgproc.resize`` against ``cv2.resize`` on uint8 noise textures,
equal to the bit (no tolerance), at the sizes and factors of the JAX
package's callers:

- INTER_LINEAR: the server's resize to 800x600 (``cli/serve_cli.py:31``)
  from 640x480 and from 1024x768, the evaluation's read to 640x480 and
  320x240 (``eval/homography.py:49``), the viewer's 480x360 cell from
  800x600 and 160x120 (``tools/image_viewer.py:37``), the trainers'
  aspect-ratio resize (``train/data.py:110``) and the fractional factors
  of a 37x53 source;
- INTER_CUBIC: the synthetic textures' 4x upscales (``train/data.py:268``,
  ``eval/homography.py:351``), CAR-HyNet's 8x upscale to 1024x1024
  (``carhynet/train.py:95``) and a shrink;
- INTER_AREA: the trainers' crops and frames (``train/data.py:229, :287,
  :321``), shrinks and an enlargement;

in colour and in gray.
"""

import cv2
import numpy as np
import pytest

from gims_tpu_torch.core import imgproc
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

LINEAR = [((480, 640), (800, 600)), ((768, 1024), (800, 600)), ((600, 800), (640, 480)),
          ((600, 800), (320, 240)), ((600, 800), (480, 360)), ((120, 160), (480, 360)),
          ((480, 640), (213, 160)), ((37, 53), (91, 77)), ((37, 53), (20, 29)),
          ((60, 80), (240, 320))]
CUBIC = [((60, 80), (320, 240)), ((150, 200), (800, 600)), ((128, 128), (1024, 1024)),
         ((600, 800), (400, 300)), ((600, 800), (640, 480))]
AREA = [((600, 800), (320, 240)), ((517, 389), (320, 240)), ((600, 800), (400, 300)),
        ((20, 30), (45, 31))]


def _noise(shape, seed, colour):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, shape + ((3,) if colour else ())).astype(np.uint8)


@pytest.mark.parametrize("interpolation,cases", [(cv2.INTER_LINEAR, LINEAR),
                                                 (cv2.INTER_CUBIC, CUBIC),
                                                 (cv2.INTER_AREA, AREA)],
                         ids=["linear", "cubic", "area"])
@pytest.mark.parametrize("colour", [True, False], ids=["bgr", "gray"])
def test_resize_equals_opencv(interpolation, cases, colour):
    for i, (shape, size) in enumerate(cases):
        img = _noise(shape, i, colour)
        want = cv2.resize(img, size, interpolation=interpolation)
        got = imgproc.resize(img, size, interpolation=interpolation)
        assert got.shape == want.shape and np.array_equal(got, want), (shape, size)


def test_small_cubic_takes_opencv_fixed_point():
    """Sources under 4 pixels on a side take OpenCV's 11-bit path."""
    for shape, size in (((3, 8), (20, 10)), ((8, 3), (11, 17)), ((2, 8), (26, 5))):
        img = _noise(shape, 7, True)
        assert np.array_equal(imgproc.resize(img, size, interpolation=cv2.INTER_CUBIC),
                              cv2.resize(img, size, interpolation=cv2.INTER_CUBIC))
