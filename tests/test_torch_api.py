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
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("kind", ["images_only"])
def test_unported_requests_raise(request_and_matchers, kind):
    """An image request at the JAX defaults (OpenCV's SIFT detector,
    detector="host") no longer raises: the port computes OpenCV's SIFT
    itself. The request's flat images hold no keypoint, so both packages
    answer with empty sets."""
    req, jm, tm = request_and_matchers
    images = {"image0": req["image0"], "image1": req["image1"]}
    got, want = tm(images), jm(images)
    assert got["keypoints0"].shape == np.asarray(want["keypoints0"]).shape == (1, 0, 2)
    assert got["matches0"].shape == (1, 0)


@pytest.mark.parametrize("kind", ["delaunay", "features"])
def test_ported_requests_accepted(request_and_matchers, kind):
    """A Delaunay request with the staged checkpoint keeps every keypoint
    and answers mutual matches (its parity with JAX:
    ``tests/test_torch_staged.py``); a features request of the request's
    flat images (no keypoint detected) answers with empty sets."""
    req, _, tm = request_and_matchers
    if kind == "delaunay":
        got = tm({**req, "delaunay": True})
        assert got["keypoints0"].shape == (1, 230, 2) and got["keypoints1"].shape == (1, 230, 2)
        np.testing.assert_array_equal(got["keypoints0"][0], req["keypoints0"])
        m0, m1 = got["matches0"][0], got["matches1"][0]
        i = np.nonzero(m0 >= 0)[0]
        assert len(i) > 0 and np.array_equal(m1[m0[i]], i)
        return
    m = Matching({"weights_path": WEIGHTS, "detector": "device", "descriptor_source": "sift",
                  "sift_descriptor": "device"}, device="cpu")
    images = {"image0": req["image0"], "image1": req["image1"]}
    feats = m.prepare_features((req["image0"], req["image1"]))
    assert feats["0"]["n"] == feats["1"]["n"] == 0
    got = m({**images, "features": feats})
    assert got["keypoints0"].shape == (1, 0, 2) and got["matches0"].shape == (1, 0)
    assert got["descriptors0"].shape == (1, 256, 0)


def test_matching_honours_every_agc_knob_where_jax_passes_defaults():
    """The port's Matching runs every GIMSConfig.agc knob; JAX's passes
    AGCConfig() to its forward (only radius, percentile and min_size reach
    its AGC). With cc_rounds=1 the port equals JAX's pipeline.forward_match
    called directly with the same AGCConfig (kept keypoints and matches
    equal, matching scores 1e-4), and that graph differs from the default
    one that JAX's Matching builds."""
    import jax
    import jax.numpy as jnp

    from gims_tpu.config import AGCConfig as JAGCConfig
    from gims_tpu.config import MatcherConfig as JMatcherConfig
    from gims_tpu.core.bucketing import compact_indices, pad_keypoint_set
    from gims_tpu.matcher import pipeline as jpipeline
    from gims_tpu_torch.config import AGCConfig, GIMSConfig, MatcherConfig
    from gims_tpu_torch.matcher.convert import load_gims_checkpoint

    req, _ = synthetic_request(7, 230, frame=(120, 160))
    knobs = dict(radius=15.0, percentile=2.0, min_size=7)
    variables = load_gims_checkpoint(WEIGHTS)
    port = Matching(GIMSConfig(agc=AGCConfig(cc_rounds=1, **knobs),
                               matcher=MatcherConfig(sinkhorn_iterations=20)),
                    variables=variables, device="cpu")
    got = port({**req, **knobs})
    sides = [pad_keypoint_set(np.asarray(req[f"keypoints{s}"]),
                              np.asarray(req[f"descriptors{s}"], np.float32),
                              np.asarray(req[f"scores{s}"], np.float32)) for s in "01"]
    ks = [jnp.asarray([jpipeline.percentile_rank(int(v.sum()), knobs["percentile"])], jnp.int32)
          for _, _, _, v in sides]
    args = [jnp.asarray(x)[None] for kp, de, _, v in sides for x in (kp, de, v)]
    mcfg = JMatcherConfig(sinkhorn_iterations=20)

    def run(acfg):
        return jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda *a: jpipeline.forward_match(variables, mcfg, acfg, *a, (120, 160),
                                               k0=ks[0], k1=ks[1]))(*args))

    want = run(JAGCConfig(cc_rounds=1, **knobs))
    default = run(JAGCConfig(**knobs))
    assert not np.array_equal(want["kept0"], default["kept0"]) or not np.array_equal(
        want["kept1"], default["kept1"])
    new0, old0 = compact_indices(want["kept0"][0])
    new1, old1 = compact_indices(want["kept1"][0])
    np.testing.assert_array_equal(got["keypoints0"][0], sides[0][0][old0])
    np.testing.assert_array_equal(got["keypoints1"][0], sides[1][0][old1])
    m0 = want["matches0"][0][old0]
    np.testing.assert_array_equal(got["matches0"][0], np.where(m0 >= 0, new1[np.clip(m0, 0, None)], -1))
    assert np.abs(got["matching_scores0"][0] - want["matching_scores0"][0][old0]).max() <= 1e-4
