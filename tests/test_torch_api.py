"""The staged Matching API on a keypoint request: the PyTorch port against
the JAX package, both on the CPU, with the staged checkpoint
``weights/gims_tpu_sift_last.npz`` at the eval knobs (radius 15,
percentile 2, min_size 7) in the 256 bucket.

Keypoints (the AGC-kept sets) and matches are integer-valued outputs and
must be equal; matching scores and mdesc agree within 1e-4 (f32 sums over
18 residual layers and 100 Sinkhorn iterations taken in another order).
"""

import os

import numpy as np
import pytest

from gims_tpu.api import Matching as JMatching
from gims_tpu_torch.api import Matching
from gims_tpu_torch.synthetic import synthetic_request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")


@pytest.fixture(scope="module")
def request_and_matchers():
    req, _ = synthetic_request(5, 230, frame=(120, 160))
    return req, JMatching({"weights_path": WEIGHTS}), Matching(
        {"weights_path": WEIGHTS}, device="cpu")


def test_matching_keypoint_request_matches_jax(request_and_matchers):
    req, jm, tm = request_and_matchers
    want, got = jm(req), tm(req)
    assert set(got) == set(want)
    for key in ("keypoints0", "keypoints1", "scores0", "scores1",
                "descriptors0", "descriptors1", "matches0", "matches1"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert 0 < got["keypoints0"].shape[1] < 230  # AGC pruned some
    assert (got["matches0"] >= 0).sum() > 0
    for key in ("matching_scores0", "matching_scores1", "mdesc0", "mdesc1"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_cpu_defaults_and_device():
    m = Matching({"sinkhorn_iterations": 3}, device="cpu")
    assert m.cfg.matcher.attention_dtype == "float32"
    assert not m.cfg.matcher.use_pallas_sinkhorn
    assert next(m.model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("kind", ["images_only", "delaunay", "features"])
def test_unported_requests_raise(request_and_matchers, kind):
    req, _, tm = request_and_matchers
    if kind == "images_only":
        bad = {"image0": req["image0"], "image1": req["image1"]}
    elif kind == "delaunay":
        bad = {**req, "delaunay": True}
    else:
        bad = {**req, "features": {"0": {}, "1": {}}}
    with pytest.raises(NotImplementedError):
        tm(bad)
