"""``eval/usac.py`` against ``cv2.findHomography(src, dst, cv2.USAC_DEFAULT)``
(threshold 3, 2000 iterations, confidence 0.995), on the CPU.

- Five seeded synthetic sets of 500 correspondences, 40% of them outliers
  drawn anywhere in a 640x480 frame, the rest a random homography of the
  source with 0.5 px Gaussian noise: the inlier mask equal to OpenCV's.
- The threshold is on OpenCV's forward reprojection error: points 2.9 and
  3.001 px off the true model count as inliers of the final model, 3.5 px
  does not, as OpenCV decides. (A point 3.01 px off is an inlier of the
  port's final fit and not of OpenCV's, which leans less on points near
  the threshold.)
- The matches of the port's ``Matching`` (``weights/gims_tpu_sift_last.npz``)
  on synthetic keypoint requests: the inlier count within max(3, 2%) of
  OpenCV's (the two draw their samples from different generators, so the
  hypotheses differ).
- Degenerate inputs: fewer than 4 points and all points equal give None,
  where OpenCV raises or returns no matrix.
"""

import os

import cv2
import numpy as np
import pytest

from gims_tpu_torch.api import Matching
from gims_tpu_torch.eval.usac import find_homography_usac
from gims_tpu_torch.synthetic import synthetic_request
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")


def _project(H, p):
    q = np.c_[p, np.ones(len(p))] @ H.T
    return q[:, :2] / q[:, 2:]


def _synthetic(seed, n=500, outliers=0.4, noise=0.5):
    rng = np.random.RandomState(seed)
    H = np.eye(3)
    H[:2, :2] += rng.randn(2, 2) * 0.1
    H[:2, 2] = rng.randn(2) * 20
    H[2, :2] = rng.randn(2) * 2e-4
    src = rng.rand(n, 2) * [640, 480]
    dst = _project(H, src) + rng.randn(n, 2) * noise
    k = int(n * outliers)
    dst[:k] = rng.rand(k, 2) * [640, 480]
    return np.float32(src), np.float32(dst)


@pytest.mark.parametrize("seed", range(5))
def test_mask_equals_opencv_on_synthetic_sets(seed):
    src, dst = _synthetic(seed)
    _, want = cv2.findHomography(src, dst, cv2.USAC_DEFAULT)
    H, got = find_homography_usac(src, dst, device="cpu")
    assert got.shape == want.shape == (500, 1) and got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert H.shape == (3, 3) and H[2, 2] == 1.0


def test_threshold_is_opencv_forward_error():
    rng = np.random.RandomState(0)
    H = np.array([[1.1, 0.05, 10.0], [-0.04, 0.95, -5.0], [1e-4, -2e-5, 1.0]])
    src = rng.rand(300, 2) * 500
    probes = rng.rand(3, 2) * 500
    errs = np.array([[2.9, 0.0], [3.001, 0.0], [3.5, 0.0]])
    s = np.float32(np.r_[src, probes])
    d = np.float32(np.r_[_project(H, src), _project(H, probes) + errs])
    _, want = cv2.findHomography(s, d, cv2.USAC_DEFAULT)
    _, got = find_homography_usac(s, d, device="cpu")
    assert got[300:, 0].tolist() == want[300:, 0].tolist() == [1, 1, 0]


@pytest.mark.parametrize("seed,outliers", [(3, 0.25), (11, 0.5)])
def test_count_near_opencv_on_matcher_output(seed, outliers):
    req, _ = synthetic_request(seed, 900, frame=(480, 640), outliers=outliers)
    pred = Matching({"weights_path": WEIGHTS, "sinkhorn_iterations": 20}, device="cpu")(req)
    m = pred["matches0"][0]
    valid = m > -1
    mk0 = np.float32(pred["keypoints0"][0][valid])
    mk1 = np.float32(pred["keypoints1"][0][m[valid]])
    assert len(mk0) > 100
    _, want = cv2.findHomography(mk0, mk1, cv2.USAC_DEFAULT)
    _, got = find_homography_usac(mk0, mk1, device="cpu")
    assert abs(int(got.sum()) - int(want.sum())) <= max(3, 0.02 * int(want.sum()))


def test_degenerate_inputs():
    pts = np.float32(np.random.RandomState(0).rand(3, 2) * 100)
    assert find_homography_usac(pts, pts, device="cpu") is None
    same = np.zeros((20, 2), np.float32)
    assert find_homography_usac(same, same, device="cpu") is None
