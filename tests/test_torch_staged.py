"""The staged image path: the PyTorch port against the JAX package on the
CPU, on the same seeded numpy images.

``Matching`` on image requests with the device detector, each descriptor
source that needs no OpenCV, a 2-layer matcher (identity init, carried from
flax) and carried CAR-HyNet weights (a flax init for the colour network,
the joint end-to-end gray weights for dense_gray), f32, 96x128 colour
pairs, 140 keypoints per image. Tolerances:
- ``detect_device``: the keypoint set equal wherever a score lies more than
  1e-4 from the 140th; positions 1e-3 px, scores 1e-4 (JAX blurs by band
  matrices, the port by convolutions: the same function to f32 rounding);
- ``FeatureFrontend.extract_padded`` from the image: keypoints 1e-3 px;
  descriptors (unit 256-d) 1e-3 for the CNN sources (their pyramids agree
  to 1e-3 gray levels and, jitted, JAX's warp coordinates to an ulp; the
  modules alone are held to 1e-4 in ``tests/test_torch_patches.py``); the
  SIFT source: at least 99% of the elements within 1e-5 and the rest
  within 1/256 (one step of the finalized integer descriptor, as
  ``tests/test_torch_devsift.py``);
- ``Matching`` (each source; carhynet at the CPU default, the bicubic
  64x64 warp): keypoints 1e-3 px, kept and matches equal, matching scores
  1e-4 (1e-3 for the SIFT source, whose descriptors may differ by that
  integer step); ``features`` requests and ``prepare_features`` give the
  image request's dict exactly;
- ``delaunay_adjacency_host``: bit-equal; ``delaunay=True`` requests: kept
  and matches equal, scores 1e-4.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gims_tpu.agc import graph as jgraph
from gims_tpu.api import Matching as JMatching
from gims_tpu.api import init_gmatcher_variables
from gims_tpu.carhynet import model as jmodel
from gims_tpu.carhynet.engine import DescriptorEngine as JDescriptorEngine
from gims_tpu.config import FrontendConfig as JFrontendConfig
from gims_tpu.config import GIMSConfig as JGIMSConfig
from gims_tpu.config import MatcherConfig as JMatcherConfig
from gims_tpu.frontend import detect_device as jdetect
from gims_tpu.frontend.feature import FeatureFrontend as JFeatureFrontend
from gims_tpu_torch.agc import graph as tgraph
from gims_tpu_torch.api import Matching
from gims_tpu_torch.carhynet.convert import load_car_checkpoint
from gims_tpu_torch.config import FrontendConfig, GIMSConfig, MatcherConfig
from gims_tpu_torch.carhynet import engine as tengine
from gims_tpu_torch.frontend import dense as tdense
from gims_tpu_torch.frontend import detect_device as tdetect
from gims_tpu_torch.frontend import sift as tsift
from gims_tpu_torch.frontend.feature import FeatureFrontend
from gims_tpu_torch.synthetic import EVAL_KNOBS, synthetic_image_pair, synthetic_request
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E_CAR = os.path.join(REPO, "weights", "gims_tpu_dense_gray_e2e_car.npz")
FRAME = (96, 128)
MAX_KP = 140  # of ~160 detected per image: 140 in the 256 bucket
SOURCES = ("carhynet", "dense", "dense_gray", "sift")


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    img0, img1, _ = synthetic_image_pair(8, FRAME, colour=True)
    return img0, img1


@pytest.fixture(scope="module")
def weights():
    mcfg = JMatcherConfig(num_gnn_layers=2, sinkhorn_iterations=20, match_threshold=0.02)
    # jitted inits: the values of the eager ones, in a fraction of the time
    matcher = as_np(jax.jit(lambda: init_gmatcher_variables(mcfg, seed=0, scheme="identity"))())
    colour = as_np(jax.jit(jmodel.CARHyNet(in_channels=3).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    # the last entry caches the frontends built by `frontends`
    return mcfg, matcher, {"colour": colour, "gray": load_car_checkpoint(E2E_CAR)}, {}


def frontend_cfg(source, fast=False):
    kw = dict(descriptor_source=source, detector="device", sift_descriptor="device",
              max_keypoints=MAX_KP, dense_dtype="float32")
    if fast:
        kw.update(interpolation="linear", warp_size=32)
    return kw


def frontends(source, weights, fast=False):
    """The JAX and the port's FeatureFrontend of a source, same weights;
    one pair per source and warp for the module, so that the JAX side
    compiles its CNN programs once."""
    cache = weights[3]
    if (source, fast) not in cache:
        cache[(source, fast)] = _make_frontends(source, weights, fast)
    return cache[(source, fast)]


def _make_frontends(source, weights, fast):
    kw = frontend_cfg(source, fast)
    car = weights[2]["gray" if source == "dense_gray" else "colour"]
    in_ch = 1 if source == "dense_gray" else 3
    jeng = None if source == "sift" else JDescriptorEngine(
        variables=jax.tree_util.tree_map(jnp.asarray, car), in_channels=in_ch)
    jfe = JFeatureFrontend(JFrontendConfig(**kw), engine=jeng)
    tfe = FeatureFrontend(FrontendConfig(**kw), variables=None if source == "sift" else car,
                          device="cpu")
    return jfe, tfe


def matchers(source, weights, fast=False):
    mcfg, matcher = weights[:2]
    jfe, tfe = frontends(source, weights, fast)
    kw = frontend_cfg(source, fast)
    jm = JMatching(JGIMSConfig(matcher=mcfg, frontend=JFrontendConfig(**kw)),
                   variables=jax.tree_util.tree_map(jnp.asarray, matcher), frontend=jfe)
    tm = Matching(GIMSConfig(matcher=MatcherConfig(**dataclasses.asdict(mcfg)),
                             frontend=FrontendConfig(**kw)),
                  variables=matcher, frontend=tfe, device="cpu")
    return jm, tm


def request(pair, **extra):
    return {"image0": pair[0][None], "image1": pair[1][None], **EVAL_KNOBS, **extra}


def test_detect_device_matches_jax(pair):
    img = pair[0]
    jkp, jpad = jdetect.detect_device(img, MAX_KP)
    tkp, tpad = tdetect.detect_device(img, MAX_KP, device="cpu")
    assert tuple(tpad["pt"].shape) == (1, MAX_KP, 2) and len(jkp) == MAX_KP
    score = np.asarray(jpad["response"])
    kth = score[MAX_KP - 1]
    sure = np.abs(jkp.response - kth) > 1e-4
    tsure = np.abs(tkp.response - kth) > 1e-4
    a, b = jkp.pt[sure], tkp.pt[tsure]
    assert len(a) == len(b)
    assert np.abs(a[:, None] - b[None]).max(-1).min(1).max() <= 1e-3
    # the same keypoints in the same order up to where a near-tie could swap them
    n = int(np.argmin(sure)) if not sure.all() else len(jkp)
    np.testing.assert_allclose(tkp.pt[:n], jkp.pt[:n], atol=1e-3, rtol=0)
    np.testing.assert_allclose(tkp.response[:n], jkp.response[:n], atol=1e-4, rtol=0)
    for f in ("size", "angle"):
        np.testing.assert_allclose(getattr(tkp, f)[:n], getattr(jkp, f)[:n], rtol=1e-3,
                                   atol=1e-3 if f == "size" else 1e-2, err_msg=f)
    for f in ("octave", "layer", "scale"):
        np.testing.assert_array_equal(getattr(tkp, f)[:n], getattr(jkp, f)[:n], err_msg=f)
    # the padded tail as JAX pads it
    tail = ~tpad["valid"][0].numpy()
    assert (tpad["pt"][0].numpy()[tail] == 1e6).all()
    assert (tpad["layer"][0].numpy()[tail] == 1).all()


def test_detect_device_flat_image_is_empty():
    kp, pad = tdetect.detect_device(np.full((64, 64, 3), 128, np.uint8), 64, device="cpu")
    assert len(kp) == 0 and not pad["valid"].any()


def test_detect_device_reads_back_once(pair, monkeypatch):
    """One copy to the host per image, as the JAX package's device_get."""
    copies = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: copies.append(self.shape) or cpu(self, *a, **k))
    kp, _ = tdetect.detect_device(pair[0], MAX_KP, device="cpu")
    assert len(copies) == 1 and len(kp) == MAX_KP


@pytest.mark.parametrize("entry", ["FeatureFrontend", "DescriptorEngine", "DenseDescriptorFrontend",
                                   "DenseGrayDescriptorFrontend", "detect_device"])
def test_frontend_entry_points_default_to_cuda(monkeypatch, entry):
    """Without a device the frontend's entry points take the card, and
    where there is none they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {
        "FeatureFrontend": lambda: FeatureFrontend(FrontendConfig(**frontend_cfg("sift"))),
        "DescriptorEngine": lambda: tengine.DescriptorEngine(),
        "DenseDescriptorFrontend": lambda: tdense.DenseDescriptorFrontend(None),
        "DenseGrayDescriptorFrontend": lambda: tdense.DenseGrayDescriptorFrontend(None),
        "detect_device": lambda: tdetect.detect_device(np.zeros((32, 32, 3), np.uint8), 8),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def test_matching_refuses_frontend_on_another_device():
    fe = FeatureFrontend(FrontendConfig(**frontend_cfg("sift")), device="meta")
    with pytest.raises(ValueError, match="same device"):
        Matching({"sinkhorn_iterations": 3}, frontend=fe, device="cpu")


@pytest.mark.parametrize("source", SOURCES)
def test_extract_padded_matches_jax(pair, weights, source):
    jfe, tfe = frontends(source, weights)
    want = jfe.extract_padded(pair[0], max_keypoints=MAX_KP)
    got = tfe.extract_padded(pair[0], max_keypoints=MAX_KP)
    n = got["n"]
    assert n == want["n"] == MAX_KP and got["desc"].shape == (256, 256)
    np.testing.assert_allclose(got["kp"].pt, want["kp"].pt, atol=1e-3, rtol=0)
    gd, wd = got["desc"].numpy(), np.asarray(want["desc"])
    assert not gd[n:].any() and set(got) == set(want) | {"timings"}
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    if source == "sift":
        close = np.abs(gd - wd) <= 1e-5
        assert close.mean() >= 0.99
        np.testing.assert_allclose(gd, wd, atol=1 / 256, rtol=0)
    else:
        np.testing.assert_allclose(gd, wd, atol=1e-3, rtol=0)
    assert set(tfe.timings) == {"detect", "patches", "descriptors"}
    assert got["timings"].keys() == tfe.timings.keys()
    host = tfe.extract(pair[0], max_keypoints=MAX_KP)
    np.testing.assert_array_equal(host["descriptors"], gd[:n])


@pytest.mark.parametrize("source", SOURCES)
def test_matching_images_match_jax(pair, weights, source):
    jm, tm = matchers(source, weights)
    want, got = jm(request(pair)), tm(request(pair))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["keypoints0"], want["keypoints0"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["keypoints1"], want["keypoints1"], atol=1e-3, rtol=0)
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert (got["matches0"] >= 0).sum() > 5
    tol = 1e-3 if source == "sift" else 1e-4
    for key in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=tol, rtol=0)
    assert {k for k in tm.timings} == {k for k in jm.timings}


def test_features_requests_equal_image_requests(pair, weights):
    """``prepare_features`` and a ``features`` request give the image
    request's answer (the 32x32 bilinear warp); the request's frontend
    timings are its own two images'."""
    _, tm = matchers("carhynet", weights, fast=True)
    direct = tm(request(pair))
    feats = tm.prepare_features(pair)
    got = tm(request(pair, features=feats))
    assert set(got) == set(direct)
    for key in got:
        np.testing.assert_array_equal(got[key], direct[key], err_msg=key)
    assert (got["matches0"] >= 0).sum() > 5
    for k in ("detect", "patches", "descriptors"):
        assert tm.timings[f"frontend_{k}"] == feats["0"]["timings"][k] + feats["1"]["timings"][k]


def test_delaunay_adjacency_host_bit_equal():
    rng = np.random.RandomState(4)
    kpts = rng.uniform(0, 100, (300, 2)).astype(np.float32)
    valid = rng.rand(300) < 0.8
    kpts[~valid] = 1e6
    np.testing.assert_array_equal(tgraph.delaunay_adjacency_host(kpts, valid),
                                  jgraph.delaunay_adjacency_host(kpts, valid))
    two = np.zeros(300, bool)
    two[:2] = True
    assert not tgraph.delaunay_adjacency_host(kpts, two).any()


def test_delaunay_request_matches_jax(weights):
    """D-GIMS on a keypoint request: every valid keypoint kept, matches as
    JAX's (image requests share the rest of the path with the tests above)."""
    jm, tm = matchers("sift", weights)
    req, _ = synthetic_request(5, 230, frame=FRAME)
    req = {**req, "delaunay": True}
    want, got = jm(req), tm(req)
    for key in ("keypoints0", "keypoints1", "matches0", "matches1"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-3, rtol=0,
                                   err_msg=key)
    for key in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-4, rtol=0)
    assert got["keypoints0"].shape[1] == 230  # all kept
    assert (got["matches0"] >= 0).sum() > 5


@pytest.mark.parametrize("knob", [{"detector": "host"},
                                  {"descriptor_source": "sift", "sift_descriptor": "host"},
                                  {"train_topup": True}])
def test_host_opencv_settings_raise(pair, knob):
    cfg = {**frontend_cfg("sift" if "sift_descriptor" in knob else "carhynet"), **knob}
    topup = cfg.pop("train_topup", False)
    fe = FeatureFrontend(FrontendConfig(**cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="OpenCV"):
        fe.extract_padded(pair[0], train_topup=topup)
    with pytest.raises(NotImplementedError, match="OpenCV"):
        tsift.detect(pair[0], FrontendConfig())


def test_matching_defaults_follow_jax(pair):
    """The JAX package's defaults stay the defaults: CAR-HyNet patches
    behind the host detector, so a bare image request raises; the config
    keys replace the frontend's fields as in JAX."""
    m = Matching({"sinkhorn_iterations": 3}, device="cpu")
    assert m.frontend.cfg.descriptor_source == "carhynet"
    assert m.frontend.cfg.detector == "host"
    with pytest.raises(NotImplementedError, match="OpenCV"):
        m(request(pair))
    m = Matching({"fast_frontend": True, "descriptor_source": "sift", "detector": "device",
                  "sift_descriptor": "device", "sift_samples": 12}, device="cpu")
    cfg = m.frontend.cfg
    assert (cfg.interpolation, cfg.warp_size, cfg.descriptor_source, cfg.detector,
            cfg.sift_descriptor, cfg.sift_samples) == ("linear", 32, "sift", "device",
                                                       "device", 12)
    assert m.frontend.engine is None
