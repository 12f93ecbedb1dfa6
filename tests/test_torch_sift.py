"""The port's cv2-free SIFT (``gims_tpu_torch/frontend/sift.py``) against
OpenCV's, as the JAX package calls it (``gims_tpu/frontend/sift.py``), on
the CPU; and the port's float resize, ``warp_affine`` and BMP reader
against OpenCV.

Tolerances, and what was measured on synthetic images of 160x120 to
320x240 (``synthetic_image_pair``) and a 30-degree rotated copy:

- detection: at least 98% of each side's keypoints have a counterpart on
  the other side within 1e-3 px with the same packed octave and layer, the
  size within 1e-4 relative, the angle within 0.05 degrees (circular) and
  the response within 1e-4 relative. Measured: the same number of
  keypoints, in the same order, every point and packed octave equal to the
  bit; 100% within the tolerances, ~95.5% of the angles, ~99.6% of the
  responses and ~98.5% of the sizes equal to the bit.
- ``compute`` on OpenCV's own keypoints: at least 99% of the uint8 entries
  within one level of OpenCV's and every descriptor at cosine >= 0.99.
  Measured: 100% within one level, >= 99.998% equal.
- ``detect`` and ``detect_and_describe`` with ``train_topup`` from one
  ``RandomState``, under the same tolerances (the top-ups are compared
  index for index).
- ``compute`` on a keypoint set with an octave -1 keypoint and on the same
  set without it (OpenCV's compute then builds its pyramid without the 2x
  upsample): both within the descriptor tolerances.
- one image pair through ``Matching`` at host/host (SIFT descriptors,
  ``weights/gims_tpu_sift_last.npz``, 512 keypoints): at least 90% of the
  JAX package's matches are found by the port.
- ``resize`` of float32 images: the 2x shrink equal, two other sizes
  within 1e-4 on the 0..255 scale (the sums' order differs; measured
  7.6e-5); ``warp_affine``: equal; the cubic 8x upscale of uint8: equal;
  ``imread`` of 8- and 24-bit BMP: equal.
"""

import os

import cv2
import numpy as np
import pytest
from scipy.spatial import cKDTree

from gims_tpu.config import FrontendConfig as JFrontendConfig
from gims_tpu.frontend import sift as jsift
from gims_tpu_torch.config import FrontendConfig
from gims_tpu_torch.core import image_io, imgproc
from gims_tpu_torch.frontend import sift as tsift
from gims_tpu_torch.synthetic import synthetic_image_pair
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CV_ARGS = dict(nOctaveLayers=3, contrastThreshold=0.001, edgeThreshold=80, sigma=1.6)


def _cv_sift():
    return cv2.SIFT_create(**CV_ARGS)


def _port_sift():
    return tsift.SIFT(3, 0.001, 80, 1.6, device="cpu")


def _cv_arrays(kps):
    packed = np.array([k.octave for k in kps], np.int64)
    return (np.array([k.pt for k in kps], np.float32).reshape(-1, 2),
            np.array([k.size for k in kps], np.float32),
            np.array([k.angle for k in kps], np.float32),
            np.array([k.response for k in kps], np.float32), packed)


def _port_arrays(kp, packed=None):
    if packed is None:
        packed = (kp.octave.astype(np.int64) & 0xFF) | (kp.layer.astype(np.int64) << 8)
    return kp.pt, kp.size, kp.angle, kp.response, packed


def _share_within(a, b):
    """Share of a's keypoints with a counterpart in b under the tolerances."""
    pa, sa, aa, ra, oa = a
    pb, sb, ab, rb, ob = b
    if len(pa) == 0:
        return 1.0
    tree = cKDTree(pb.astype(np.float64))
    ok = 0
    for i, cand in enumerate(tree.query_ball_point(pa.astype(np.float64), 1e-3)):
        for j in cand:
            da = abs((float(aa[i]) - float(ab[j]) + 180.0) % 360.0 - 180.0)
            if ((oa[i] & 0xFFFF) == (ob[j] & 0xFFFF) and da <= 0.05
                    and abs(sb[j] / sa[i] - 1) <= 1e-4
                    and abs(rb[j] - ra[i]) <= 1e-4 * max(abs(ra[i]), 1e-12)):
                ok += 1
                break
    return ok / len(pa)


def _image(seed, hw, rotate=False):
    img = synthetic_image_pair(seed, hw, colour=True)[0]
    if rotate:
        h, w = hw
        img = cv2.warpAffine(img, cv2.getRotationMatrix2D((w / 2, h / 2), 30, 1.0), (w, h))
    return img


CASES = [(0, (120, 160), False), (1, (240, 320), False), (2, (200, 280), False),
         (3, (240, 320), True)]


@pytest.mark.parametrize("seed,hw,rotate", CASES)
def test_detect_matches_opencv(seed, hw, rotate):
    img = _image(seed, hw, rotate)
    want = _cv_arrays(_cv_sift().detect(img, None))
    kp, packed, _ = _port_sift().detect_raw(img)
    got = _port_arrays(kp, packed)
    assert len(want[0]) > 100
    assert _share_within(want, got) >= 0.98
    assert _share_within(got, want) >= 0.98


def _assert_desc_close(got, want):
    got, want = got.astype(np.int64), want.astype(np.int64)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1).mean() >= 0.99
    cos = (got * want).sum(1) / np.maximum(
        np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1), 1e-9)
    assert cos.min() >= 0.99


@pytest.mark.parametrize("seed,hw,rotate", CASES[:2] + CASES[3:])
def test_compute_on_opencv_keypoints(seed, hw, rotate):
    img = _image(seed, hw, rotate)
    sift = _cv_sift()
    kps = sift.detect(img, None)
    _, want = sift.compute(img, kps)
    kp = jsift.keypoints_to_arrays(kps)
    kp = tsift.KeypointArrays(kp.pt, kp.size, kp.angle, kp.response, kp.octave, kp.layer,
                              kp.scale)
    _assert_desc_close(_port_sift().compute(img, kp), want)


def test_compute_pyramid_with_and_without_octave_minus_one():
    """OpenCV's compute starts its pyramid at the lowest octave among the
    keypoints: with an octave -1 keypoint the 2x upsampled base, without it
    the image itself. Both sets must equal OpenCV's."""
    img = _image(1, (240, 320))
    sift = _cv_sift()
    kps = sorted(sift.detect(img, None), key=lambda k: -k.response)
    upper = [k for k in kps if (k.octave & 0xFF) != 0xFF][:300]
    lower = [k for k in kps if (k.octave & 0xFF) == 0xFF][:1]
    for kset in (upper, upper + lower):
        _, want = sift.compute(img, kset)
        kp = jsift.keypoints_to_arrays(kset)
        kp = tsift.KeypointArrays(kp.pt, kp.size, kp.angle, kp.response, kp.octave,
                                  kp.layer, kp.scale)
        _assert_desc_close(_port_sift().compute(img, kp), want)


@pytest.mark.parametrize("max_kp", [300, 4000])
def test_detect_and_describe_with_topup_matches_jax(max_kp):
    img = _image(2, (200, 280))
    jcfg, tcfg = JFrontendConfig(), FrontendConfig()
    jkp, jdesc = jsift.detect_and_describe(img, jcfg, max_kp, train_topup=True,
                                           rng=np.random.RandomState(9))
    tkp, tdesc = tsift.detect_and_describe(img, tcfg, max_kp, train_topup=True,
                                           rng=np.random.RandomState(9), device="cpu")
    assert len(tkp) == len(jkp) == max_kp and tdesc.dtype == np.uint8
    same = np.linalg.norm(tkp.pt - jkp.pt, axis=1) <= 1e-3
    assert same.mean() >= 0.98
    _assert_desc_close(tdesc[same], jdesc[same])
    jd = jsift.detect(img, jcfg, max_kp, train_topup=True, rng=np.random.RandomState(9))
    td = tsift.detect(img, tcfg, max_kp, train_topup=True, rng=np.random.RandomState(9),
                      device="cpu")
    assert len(td) == len(jd) == max_kp
    assert (np.linalg.norm(td.pt - jd.pt, axis=1) <= 1e-3).mean() >= 0.98
    for f in ("size", "angle", "response", "octave", "layer", "scale"):
        assert (getattr(td, f) == getattr(jd, f)).mean() >= 0.9, f
    topped = jd.response == 0
    if max_kp > 1000:
        assert topped.sum() > 0
        np.testing.assert_array_equal(td.pt[topped], jd.pt[topped])
        np.testing.assert_array_equal(td.angle[topped], -1.0)


def test_matching_host_sift_against_jax():
    from gims_tpu.api import Matching as JMatching
    from gims_tpu_torch.api import Matching

    weights = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")
    img0, img1, _ = synthetic_image_pair(7, (240, 320), colour=True)
    conf = {"weights_path": weights, "descriptor_source": "sift", "max_keypoints": 512}
    want = JMatching(conf)({"image0": img0, "image1": img1})
    got = Matching(conf, device="cpu")({"image0": img0, "image1": img1})

    def pairs(pred):
        k0, k1 = np.asarray(pred["keypoints0"])[0], np.asarray(pred["keypoints1"])[0]
        m = np.asarray(pred["matches0"])[0]
        i = np.nonzero(m >= 0)[0]
        return {(tuple(np.round(k0[a], 2)), tuple(np.round(k1[m[a]], 2))) for a in i}

    w, g = pairs(want), pairs(got)
    assert len(w) > 20
    assert len(w & g) >= 0.9 * len(w)


def test_imgproc_and_bmp_against_opencv(tmp_path):
    rng = np.random.RandomState(0)
    tex = rng.randint(0, 255, (128, 128, 3)).astype(np.uint8)
    want = cv2.resize(tex, (1024, 1024), interpolation=cv2.INTER_CUBIC)
    d = np.abs(imgproc.resize(tex, (1024, 1024), imgproc.INTER_CUBIC).astype(int) - want)
    assert d.max() == 0
    crop = want[100:164, 200:264].astype(np.float32) + np.float32(0.37)
    np.testing.assert_array_equal(imgproc.resize(crop, (32, 32)), cv2.resize(crop, (32, 32)))
    for size in ((32, 32), (40, 24), (100, 90)):
        np.testing.assert_allclose(imgproc.resize(crop, size), cv2.resize(crop, size),
                                   rtol=0, atol=1e-4)
    for ang, sc in ((13.3, 0.95), (-24.1, 1.07), (0.0, 1.0)):
        m = cv2.getRotationMatrix2D((32, 32), ang, sc)
        np.testing.assert_array_equal(imgproc.get_rotation_matrix_2d((32, 32), ang, sc), m)
        np.testing.assert_array_equal(imgproc.warp_affine(crop, m, (64, 64)),
                                      cv2.warpAffine(crop, m, (64, 64)))
    for shape in ((64, 66, 3), (65, 63)):
        img = rng.randint(0, 255, shape).astype(np.uint8)
        path = str(tmp_path / "m.bmp")
        cv2.imwrite(path, img)
        for flag in (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR):
            np.testing.assert_array_equal(image_io.imread(path, flag), cv2.imread(path, flag))
