"""The fused image path: the PyTorch port against the JAX package on the CPU.

The same numpy images or keypoint sets go through ``gims_tpu.fused`` /
``gims_tpu.matcher.pipeline`` and their counterparts in ``gims_tpu_torch``.
Integer outputs (kept, matches) must be equal wherever both sides are fed
the same keypoints and descriptors; float outputs within the stated
tolerance:
- ``_dense_sample``: 1e-5 on the unit descriptors;
- trunk compaction (``forward_match(compact_to=...)``, the staged
  checkpoint's full width): kept and matches equal, matching scores 1e-4;
- the whole slice (2-layer matcher, e2e CAR-HyNet weights, f32, 96x128
  pairs, B = 2): the port's extraction against JAX's (keypoints 1e-3 px,
  scores 1e-4, descriptors 1e-4 where both select the same keypoint), then
  JAX's keypoints and descriptors through the port's matcher stages:
  kept and matches equal; then ``fused_match_batch`` on both sides from
  the images: kept and matches equal, keypoints 1e-3 px, scores 1e-4.
The colour sources' parity with JAX is in ``tests/test_torch_fused_colour.py``
(a file of its own, so that the test workers run it beside this one).
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gims_tpu import fused as jfused
from gims_tpu.api import init_gmatcher_variables
from gims_tpu.carhynet.model import CARHyNet as JCARHyNet
from gims_tpu.config import AGCConfig as JAGCConfig
from gims_tpu.config import FrontendConfig as JFrontendConfig
from gims_tpu.config import MatcherConfig as JMatcherConfig
from gims_tpu.core.bucketing import pad_keypoint_set
from gims_tpu.frontend.detect_device import build_gray_blur
from gims_tpu.matcher import pipeline as jpipeline
from gims_tpu_torch import fused as tfused
from gims_tpu_torch.carhynet import convert as tcconvert
from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.config import AGCConfig, FrontendConfig, MatcherConfig
from gims_tpu_torch.matcher import pipeline as tpipeline
from gims_tpu_torch.matcher.convert import load_gims_checkpoint, load_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.synthetic import synthetic_image_pair, synthetic_request, warp
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIFT_LAST = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")
E2E_CAR = os.path.join(REPO, "weights", "gims_tpu_dense_gray_e2e_car.npz")
FRAME = (96, 128)
KNOBS = dict(radius=15.0, percentile=2.0, min_size=7)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("dense_layers", [(1, 2, 3), (2,)])
def test_dense_sample_matches_jax(dense_layers):
    rng = np.random.RandomState(len(dense_layers))
    b, k, mh, mw = 2, 300, 10, 13
    maps = rng.randn(b, len(dense_layers), mh, mw, 128).astype(np.float32)
    px = rng.uniform(-6, 4 * mw + 6, (b, k)).astype(np.float32)  # clipped at the edges
    py = rng.uniform(-6, 4 * mh + 6, (b, k)).astype(np.float32)
    layer = rng.randint(0, 5, (b, k)).astype(np.int32)
    valid = (rng.rand(b, k) < 0.8).astype(np.float32)
    got = tfused._dense_sample(torch.from_numpy(maps), torch.from_numpy(px),
                               torch.from_numpy(py), torch.from_numpy(layer),
                               torch.from_numpy(valid), dense_layers).numpy()
    for i in range(b):
        want = np.asarray(jfused._dense_sample(
            jnp.asarray(maps[i]), jnp.asarray(px[i]), jnp.asarray(py[i]),
            jnp.asarray(layer[i]), jnp.asarray(valid[i]), dense_layers))
        np.testing.assert_allclose(got[i], want, atol=1e-5, rtol=0)


def padded_request(seed, n, frame):
    req, _ = synthetic_request(seed, n, frame)
    out = []
    for s in "01":
        kp, de, sc, va = pad_keypoint_set(req["keypoints" + s], req["descriptors" + s],
                                          req["scores" + s])
        out.append((kp[None], de[None], va[None], sc[None]))
    return out


@pytest.mark.parametrize("compact_to", [256, 1024])
def test_compact_to_matches_jax(compact_to):
    """The staged checkpoint (18 layers, 256-d) on a 512-bucket request
    of 450 keypoints in a 160x120 frame, most of them kept: compacted to
    256 (overflow drops the lowest-score kept keypoints) and not compacted
    (1024 is above the bucket)."""
    variables = load_gims_checkpoint(SIFT_LAST)
    frame = (120, 160)
    (kp0, de0, va0, sc0), (kp1, de1, va1, sc1) = padded_request(7, 450, frame)
    jmcfg = JMatcherConfig(sinkhorn_iterations=20, match_threshold=0.02)
    want = as_np(jpipeline.forward_match(
        jax.tree_util.tree_map(jnp.asarray, variables), jmcfg, JAGCConfig(**KNOBS),
        *(jnp.asarray(x) for x in (kp0, de0, va0, kp1, de1, va1)),
        image_shape=frame, compact_to=compact_to,
        scores0=jnp.asarray(sc0), scores1=jnp.asarray(sc1)))
    model = GMatcher(MatcherConfig(sinkhorn_iterations=20, match_threshold=0.02)).eval()
    load_variables(model, variables)
    got = tpipeline.forward_match(
        model, AGCConfig(**KNOBS), *(torch.from_numpy(x) for x in (kp0, de0, va0, kp1, de1, va1)),
        image_shape=frame, compact_to=compact_to,
        scores0=torch.from_numpy(sc0), scores1=torch.from_numpy(sc1))
    if compact_to < 512:
        assert int(want["kept0"].sum()) == compact_to  # overflow dropped some
    assert (want["matches0"] >= 0).sum() > 100
    for key in ("kept0", "kept1", "matches0", "matches1"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    for key in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-4, rtol=0)


def test_compact_side_order_and_overflow():
    """Kept first by score descending, ties by index; the kept mask of the
    compacted bucket covers only the kept keypoints that fit."""
    kept = torch.tensor([[True, False, True, True, True, False]])
    scores = torch.tensor([[0.5, 0.9, 0.7, 0.5, 0.1, 0.0]])
    kpts = torch.arange(12, dtype=torch.float32).view(1, 6, 2)
    adj = torch.eye(6, dtype=torch.bool)[None]
    idx, kp_c, _, adj_c, kept_c = tpipeline._compact_side(kpts, kpts, adj, kept, scores, 3)
    assert idx.tolist() == [[2, 0, 3]]
    assert kept_c.tolist() == [[True, True, True]]
    assert torch.equal(kp_c[0], kpts[0, [2, 0, 3]])
    assert torch.equal(adj_c[0], torch.eye(3, dtype=torch.bool))
    idx, *_, kept_c = tpipeline._compact_side(kpts, kpts, adj, kept, scores, 6)
    assert kept_c.tolist() == [[True, True, True, True, False, False]]


@pytest.fixture(scope="module")
def slice_inputs():
    pairs = [synthetic_image_pair(s, FRAME) for s in (5, 6)]
    imgs0 = np.stack([p[0] for p in pairs])
    imgs1 = np.stack([p[1] for p in pairs])
    jmcfg = JMatcherConfig(num_gnn_layers=2, sinkhorn_iterations=20, match_threshold=0.02)
    # jitted init: the values of the eager one, in a fraction of the time
    variables = as_np(jax.jit(lambda: init_gmatcher_variables(jmcfg, seed=0,
                                                              scheme="identity"))())
    car = tcconvert.load_car_checkpoint(E2E_CAR)
    return imgs0, imgs1, jmcfg, variables, car


@pytest.mark.parametrize("upsample", [False, True])
def test_whole_slice_matches_jax(slice_inputs, upsample):
    imgs0, imgs1, jmcfg, variables, car = slice_inputs
    h, w = FRAME
    budgets = jfused.octave_budgets(h, w, 256, upsample)
    jfe = JFrontendConfig(descriptor_source="dense_gray", dense_dtype="float32",
                          upsample=upsample)
    blur = build_gray_blur(h, w, upsample)
    jcar = jax.tree_util.tree_map(jnp.asarray, car)

    @jax.jit
    def extract(ims):
        return jax.vmap(lambda im: jfused._extract_side(
            im, h, w, budgets, jfe, jcar, JCARHyNet(in_channels=1),
            JCARHyNet(dense=True, in_channels=1), blur))(ims)

    jside = [as_np(extract(jnp.asarray(x))) for x in (imgs0, imgs1)]
    compact_to = 128
    want = as_np(jpipeline.forward_match(
        jax.tree_util.tree_map(jnp.asarray, variables), jmcfg, JAGCConfig(**KNOBS),
        jside[0][0], jside[0][3], jside[0][2], jside[1][0], jside[1][3], jside[1][2],
        image_shape=FRAME, compact_to=compact_to,
        scores0=jside[0][1], scores1=jside[1][1]))

    # the port's extraction against JAX's
    fe = FrontendConfig(descriptor_source="dense_gray", dense_dtype="float32",
                        upsample=upsample)
    car_model = CARHyNet(dense=True, in_channels=1).eval()
    tcconvert.load_variables(car_model, car)
    with torch.no_grad():
        tside = [[t.numpy() for t in tfused._extract_side(
            torch.from_numpy(x), budgets, fe, car_model)] for x in (imgs0, imgs1)]
    for (jk, js, jv, jd), (tk, ts, tv, td) in zip(jside, tside):
        assert jv.sum() > 50
        same = jv & tv & (np.abs(jk - tk).max(-1) < 1e-3)
        assert same.sum() >= 0.99 * jv.sum()
        np.testing.assert_allclose(ts[same], js[same], atol=1e-4, rtol=0)
        np.testing.assert_allclose(td[same], jd[same], atol=1e-4, rtol=0)

    # JAX's keypoints and descriptors through the port's matcher stages
    model = GMatcher(MatcherConfig(num_gnn_layers=2, sinkhorn_iterations=20,
                                   match_threshold=0.02)).eval()
    load_variables(model, variables)
    t = [[torch.from_numpy(np.array(x)) for x in side] for side in jside]
    got = tpipeline.forward_match(
        model, AGCConfig(**KNOBS), t[0][0], t[0][3], t[0][2], t[1][0], t[1][3], t[1][2],
        image_shape=FRAME, compact_to=compact_to, scores0=t[0][1], scores1=t[1][1])
    assert (want["matches0"] >= 0).sum() > 20
    for key in ("kept0", "kept1", "matches0", "matches1"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)

    # and the whole of fused_match_batch on both sides, images in
    jfmb = jax.jit(jfused.fused_match_batch, static_argnums=(2, 3, 4, 5, 6, 9, 10, 11, 12, 14))
    want = as_np(jfmb(
        jax.tree_util.tree_map(jnp.asarray, variables), jcar, JCARHyNet(in_channels=1),
        jmcfg, JAGCConfig(**KNOBS), jfe, budgets, jnp.asarray(imgs0), jnp.asarray(imgs1),
        h, w, JCARHyNet(dense=True, in_channels=1), False, blur, compact_to))
    got = tfused.fused_match_batch(
        model, car_model, AGCConfig(**KNOBS), fe, budgets, torch.from_numpy(imgs0),
        torch.from_numpy(imgs1), h, w, False, compact_to)
    for key in ("kept0", "kept1", "matches0", "matches1"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    for key in ("keypoints0", "keypoints1"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-3, rtol=0)
    for key in ("scores0", "scores1", "matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-4, rtol=0)


def test_fused_matching_contract_on_cpu(slice_inputs):
    """FusedMatching on the CPU: the JAX CPU defaults, the reference's
    per-pair dict, compact transport decoded to within 1/16 px."""
    imgs0, imgs1, _, _, car = slice_inputs
    cfg = {"descriptor_source": "dense_gray", "upsample": False, "dense_dtype": "float32",
           "compact_to": 128, **KNOBS}
    runs = {}
    for packed in (True, False):
        m = tfused.FusedMatching({**cfg, "compact_transport": packed}, car_variables=car,
                                 total_keypoints=256, device="cpu")
        rc = m.resolved_config()
        assert rc["backend"] == "cpu"
        assert rc["matcher"]["attention_dtype"] == "float32"
        assert not rc["matcher"]["use_pallas_sinkhorn"]
        runs[packed] = m.collect_batch(m.dispatch_batch(imgs0, imgs1))
    assert len(runs[True]) == 2
    for a, b in zip(runs[True], runs[False]):
        n0, n1 = b["keypoints0"].shape[1], b["keypoints1"].shape[1]
        assert b["matches0"].shape == (1, n0) and b["matches1"].shape == (1, n1)
        assert b["matches0"].max() < n1 and b["matches1"].max() < n0
        np.testing.assert_array_equal(a["matches0"], b["matches0"])
        assert np.abs(a["keypoints0"] - b["keypoints0"]).max() <= 1 / 16
    assert tfused.FusedMatching(device="cpu", total_keypoints=6144).compact_to is None


@pytest.mark.parametrize("knob", [{}, {"descriptor_source": "devsift"}])
def test_unported_knobs_raise(knob):
    """The multi-device split, refused here before, builds on a repeated
    CPU device: the config of the unsplit instance, one replica per distinct
    device. devices=N names N cards, and without CUDA raises (no fallback
    to the CPU)."""
    split = tfused.FusedMatching(knob, device="cpu", devices=["cpu", "cpu"])
    assert split.resolved_config() == tfused.FusedMatching(knob, device="cpu").resolved_config()
    assert split.devices == [torch.device("cpu")] * 2 and len(split.replicas) == 1
    assert split.replicas[torch.device("cpu")][0] is split.model
    with pytest.raises(RuntimeError, match="CUDA"):
        tfused.FusedMatching(knob, devices=2)


@pytest.mark.parametrize("knob", [
    {"init_scheme": "identity"},
    {"init_scheme": "identity", "descriptor_source": "devsift"}])
def test_identity_init_scheme_builds(knob):
    """Without variables, init_scheme="identity" starts the matcher from the
    zero-residual warm start: final_proj is s*I, s^2 * 2 / sqrt(256) = 10."""
    m = tfused.FusedMatching(knob, device="cpu")
    w = m.model.final_proj.weight.detach()
    s = np.float32(np.sqrt(10.0 * np.sqrt(256) / 2.0))
    np.testing.assert_array_equal(w.numpy(), np.eye(256, dtype=np.float32) * s)
    assert not m.model.gnn.layer_0.mlp.dense_1.weight.detach().any()


@pytest.mark.parametrize("knob", [
    {"topk_impl": "approx"}, {"threshold_impl": "approx"}, {"agc_impl": "band"},
    {"cc_impl": "sparse"}, {"cc_impl": "band", "agc_impl": "band"},
    {"reconnect_impl": "centroid"}, {"descriptor_source": "devsift"},
    {"descriptor_source": "carhynet"}, {"descriptor_source": "dense"}])
def test_ported_knobs_accepted(knob):
    """The knobs this port once refused resolve as asked on the CPU."""
    rc = tfused.FusedMatching(knob, device="cpu").resolved_config()
    section = {"topk_impl": "frontend", "descriptor_source": "frontend"}
    for key, value in knob.items():
        assert rc[section.get(key, "agc")][key] == value


def test_accelerator_knobs_on_cpu_match_jax(slice_inputs):
    """The knob set FusedMatching takes by default on the card, passed
    explicitly on the CPU (band AGC, half-width 512, strided threshold,
    centroid reconnect with 1024 buckets, approximate top-k, compaction),
    against JAX's fused_match_batch with the same knobs: kept and matches
    equal, keypoints 1e-3 px."""
    imgs0, imgs1, jmcfg, variables, car = slice_inputs
    h, w = FRAME
    knobs = dict(agc_impl="band", band_halfwidth=512, threshold_impl="approx",
                 threshold_stride=4, reconnect_impl="centroid", reconnect_buckets=1024,
                 cc_impl="dense", **KNOBS)
    m = tfused.FusedMatching({"descriptor_source": "dense_gray", "upsample": False,
                              "dense_dtype": "float32", "compact_to": 128,
                              "topk_impl": "approx", "compact_transport": False,
                              "sinkhorn_iterations": 20, **knobs},
                             car_variables=car, total_keypoints=256, device="cpu")
    model = GMatcher(MatcherConfig(num_gnn_layers=2, sinkhorn_iterations=20,
                                   match_threshold=0.02)).eval()
    load_variables(model, variables)
    m.model = model
    got = m.dispatch_batch(imgs0, imgs1)
    budgets = jfused.octave_budgets(h, w, 256, False)
    jfe = JFrontendConfig(descriptor_source="dense_gray", dense_dtype="float32",
                          upsample=False, topk_impl="approx")
    jfmb = jax.jit(jfused.fused_match_batch, static_argnums=(2, 3, 4, 5, 6, 9, 10, 11, 12, 14))
    want = as_np(jfmb(
        jax.tree_util.tree_map(jnp.asarray, variables),
        jax.tree_util.tree_map(jnp.asarray, car), JCARHyNet(in_channels=1), jmcfg,
        JAGCConfig(**knobs), jfe, budgets, jnp.asarray(imgs0), jnp.asarray(imgs1), h, w,
        JCARHyNet(dense=True, in_channels=1), False, build_gray_blur(h, w, False), 128))
    assert (want["matches0"] >= 0).sum() > 20
    for key in ("kept0", "kept1", "matches0", "matches1"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    for key in ("keypoints0", "keypoints1"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-3, rtol=0)


def test_devices_raise():
    """devices=N on a machine without CUDA raises, as does a split of an odd
    batch over two devices (JAX's ValueError) or devices of two types."""
    with pytest.raises(RuntimeError, match="CUDA"):
        tfused.FusedMatching(device="cpu", devices=2)
    split = tfused.FusedMatching({"descriptor_source": "devsift", "upsample": False},
                                 total_keypoints=256, devices=["cpu", "cpu"])
    imgs = np.zeros((3, 96, 128), np.uint8)
    with pytest.raises(ValueError, match="not divisible by the 2-device mesh"):
        split.dispatch_batch(imgs, imgs)
    with pytest.raises(ValueError, match="differ in type"):
        tfused.FusedMatching(device="meta", devices=["cpu"])


def test_synthetic_pair_follows_its_homography():
    img0, img1, H = synthetic_image_pair(1, FRAME)
    assert img0.dtype == img1.dtype == np.uint8 and img0.shape == FRAME
    rng = np.random.RandomState(0)
    p0 = rng.uniform([20, 20], [FRAME[1] - 20, FRAME[0] - 20], (200, 2))
    p1 = warp(H, p0)
    inside = (p1 >= 2).all(1) & (p1[:, 0] < FRAME[1] - 2) & (p1[:, 1] < FRAME[0] - 2)
    a = img0[np.rint(p0[inside, 1]).astype(int), np.rint(p0[inside, 0]).astype(int)]
    b = img1[np.rint(p1[inside, 1]).astype(int), np.rint(p1[inside, 0]).astype(int)]
    assert inside.sum() > 100
    assert np.median(np.abs(a.astype(int) - b.astype(int))) <= 8


def test_colour_fused_matching_contract(slice_inputs):
    """The default source is carhynet, as in JAX, at the bicubic 64x64 warp
    on the CPU unless fast_frontend; the colour sources take (B, H, W, 3)
    BGR (a flax init of the colour CAR-HyNet carried over, the 2-layer
    matcher), refuse gray stacks and refuse upsample=False."""
    _, _, _, variables, _ = slice_inputs
    img0, img1, _ = synthetic_image_pair(5, FRAME, colour=True)
    imgs0, imgs1 = img0[None], img1[None]
    car = as_np(jax.jit(JCARHyNet(in_channels=3).init)(jax.random.PRNGKey(3),
                                                       jnp.zeros((1, 32, 32, 3), jnp.float32)))
    assert tfused.FusedMatching(device="cpu").fe.descriptor_source == "carhynet"
    m = tfused.FusedMatching({"compact_transport": False, "fast_frontend": True, **KNOBS},
                             car_variables=car, total_keypoints=256, device="cpu")
    model = GMatcher(MatcherConfig(num_gnn_layers=2, sinkhorn_iterations=20,
                                   match_threshold=0.02)).eval()
    load_variables(model, variables)
    m.model = model
    rc = m.resolved_config()
    assert rc["descriptor_in_channels"] == 3 and not rc["dense_model"]
    assert (rc["frontend"]["interpolation"], rc["frontend"]["warp_size"]) == ("linear", 32)
    assert tfused.FusedMatching(device="cpu").fe.warp_size == 64  # bicubic 64 on the CPU
    preds = m.collect_batch(m.dispatch_batch(imgs0, imgs1))
    assert len(preds) == 1
    for p in preds:
        n0, n1 = p["keypoints0"].shape[1], p["keypoints1"].shape[1]
        assert p["matches0"].shape == (1, n0) and p["matches0"].max() < n1
    with pytest.raises(ValueError, match="BGR"):
        m.dispatch_batch(imgs0[..., 0], imgs1[..., 0])
    for source in ("carhynet", "dense"):
        with pytest.raises(ValueError, match="upsample"):
            tfused.FusedMatching({"descriptor_source": source, "upsample": False}, device="cpu")
