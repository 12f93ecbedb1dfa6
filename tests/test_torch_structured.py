"""The ``structured`` benchmark images of the port
(``eval/homography.make_structured_image``) against the JAX package's, and
the drawing and blur calls they are made of against OpenCV, on the CPU.

- ``make_structured_image`` equals JAX's to the bit at 120x160 and 600x800
  for three seeds, and ``generate_benchmark(style="structured")`` writes
  JAX's images and homographies.
- On float32 images ``cv2.ellipse``, ``cv2.fillPoly`` and a filled
  ``cv2.rectangle`` with ``LINE_AA`` draw as ``LINE_8``; the port's
  ``drawing.ellipse``, ``fill_poly`` (convex and not, inside the image and
  across its borders) and ``rectangle`` equal them to the bit over random
  shapes.
- ``imgproc.gaussian_blur`` of float32 and float64 images within 1e-6
  relative of ``cv2.GaussianBlur`` (float32 is bit-equal on these shapes).
"""

import os

import cv2
import numpy as np
import pytest

from gims_tpu.eval import homography as jhomography
from gims_tpu_torch.core import drawing, image_io, imgproc
from gims_tpu_torch.eval import homography
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)


@pytest.mark.parametrize("size", [(120, 160), (600, 800)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_structured_image_equals_jax(size, seed):
    want = jhomography.make_structured_image(np.random.RandomState(seed), *size)
    got = homography.make_structured_image(np.random.RandomState(seed), *size)
    assert got.dtype == np.uint8 and got.shape == size + (3,)
    assert np.array_equal(got, want)


def test_generate_structured_benchmark_equals_jax(tmp_path):
    want_txt, want_dir = jhomography.generate_benchmark(str(tmp_path / "jax"), n_pairs=2,
                                                        height=120, width=160,
                                                        style="structured")
    got_txt, got_dir = homography.generate_benchmark(str(tmp_path / "port"), n_pairs=2,
                                                     height=120, width=160,
                                                     style="structured")
    assert open(got_txt).read() == open(want_txt).read()
    for name in sorted(os.listdir(want_dir)):
        assert np.array_equal(image_io.imread(os.path.join(got_dir, name)),
                              cv2.imread(os.path.join(want_dir, name)))


def random_shapes(seed, n=60, h=120, w=160):
    """n random shapes of each kind around and across the image."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        color = rng.uniform(30, 225, 3).tolist()
        cx, cy = rng.randint(-20, w + 20), rng.randint(-20, h + 20)
        axes = (rng.randint(1, w // 2), rng.randint(1, h // 2))
        angle = rng.uniform(0, 360)
        ang = rng.uniform(0, 2 * np.pi, rng.randint(3, 9))
        if rng.rand() < 0.5:
            ang.sort()  # convex-ish; else the polygon crosses itself
        r = rng.randint(5, h)
        pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1).astype(np.int32)
        half = (rng.randint(1, w) // 2, rng.randint(1, h) // 2)
        yield color, (cx, cy), axes, angle, pts, half


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["ellipse", "fill_poly", "rectangle"])
def test_float_shapes_equal_opencv(kind, seed):
    for color, (cx, cy), axes, angle, pts, (hw, hh) in random_shapes(seed):
        want = np.zeros((120, 160, 3), np.float32)
        got = want.copy()
        if kind == "ellipse":
            cv2.ellipse(want, (cx, cy), axes, angle, 0, 360, color, -1, cv2.LINE_AA)
            drawing.ellipse(got, (cx, cy), axes, angle, 0, 360, color, -1, drawing.LINE_AA)
        elif kind == "fill_poly":
            cv2.fillPoly(want, [pts], color, cv2.LINE_AA)
            drawing.fill_poly(got, [pts], color, drawing.LINE_AA)
        else:
            p1, p2 = (cx - hw, cy - hh), (cx + hw, cy + hh)
            cv2.rectangle(want, p1, p2, color, -1, cv2.LINE_AA)
            drawing.rectangle(got, p1, p2, color, -1, drawing.LINE_AA)
        assert np.array_equal(got, want), (kind, cx, cy, axes, angle, pts.tolist())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(61, 83), (120, 160, 3)])
def test_float_gaussian_blur_close_to_opencv(dtype, shape):
    img = (np.random.RandomState(7).rand(*shape) * 255).astype(dtype)
    for sigma in (0.8, 3.0):
        want = cv2.GaussianBlur(img, (0, 0), sigma)
        got = imgproc.gaussian_blur(img, sigma)
        assert got.dtype == dtype and got.shape == img.shape
        assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want))
