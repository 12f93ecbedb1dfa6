"""The devsift fused path: the PyTorch port against the JAX package on the CPU.

The same numpy images go through ``gims_tpu`` and ``gims_tpu_torch``; the
JAX side runs its fused path as ``FusedMatching`` does off the TPU (the
band-matrix blurs of ``build_gray_blur``, f32). Tolerances:
- ``grad_levels``: 1e-5 (differences of the same f32 pyramid);
- ``_descr_chunk``: at least 99.9% of the finalized descriptor elements
  equal, the rest within 1 (a vote that lands on a rounding boundary of
  cv2's integer quantization);
- orientation maps: 1e-3 degrees on the circle, at pixels whose smoothed
  gradient magnitude is at least 1e-2 (below it the angle of a near-zero
  vector flips on f32 rounding);
- ``_extract_side`` (96x128, upsample, B = 2): keypoints 1e-3 px, scores
  1e-4; the unit 128-d descriptors, duplicated to 256, element by element
  within 1e-5 for at least 99.9% of the elements and within 1/256 for the
  rest (one step of the finalized integer descriptor, whose norm is ~512);
- the whole slice (2-layer matcher, identity init): JAX's keypoints and
  descriptors through the port's matcher stages, then ``fused_match_batch``
  from the images on both sides: kept and matches equal.
"""

import functools
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gims_tpu import fused as jfused
from gims_tpu.api import init_gmatcher_variables
from gims_tpu.config import AGCConfig as JAGCConfig
from gims_tpu.config import FrontendConfig as JFrontendConfig
from gims_tpu.config import MatcherConfig as JMatcherConfig
from gims_tpu.frontend import detect_device as jdetect
from gims_tpu.frontend import sift_descriptor as jsift
from gims_tpu.frontend.detect_device import build_gray_blur
from gims_tpu.frontend.patches import quad_blocks_from_levels as jquad_blocks
from gims_tpu.matcher import pipeline as jpipeline
from gims_tpu_torch import fused as tfused
from gims_tpu_torch.config import AGCConfig, FrontendConfig, MatcherConfig
from gims_tpu_torch.frontend import detect_device as tdetect
from gims_tpu_torch.frontend import pyramid as tpyramid
from gims_tpu_torch.frontend import sift_descriptor as tsift
from gims_tpu_torch.matcher import pipeline as tpipeline
from gims_tpu_torch.matcher.convert import load_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.synthetic import synthetic_image_pair
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

FRAME = (96, 128)
KNOBS = dict(radius=15.0, percentile=2.0, min_size=7)
ANGLE_TOL = 1e-3
MAG_MARGIN = 1e-2


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def images():
    pairs = [synthetic_image_pair(s, FRAME) for s in (5, 6)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.fixture(scope="module")
def octaves(images):
    """The port's upsampled pyramid of two images, (B, 6, H, W) per octave."""
    return tdetect.gray_pyramid(torch.from_numpy(images[0]), True)


def test_grad_levels_match_jax(octaves):
    for g in octaves[:3]:
        got = tsift.grad_levels(g).numpy()
        for i in range(g.shape[0]):
            want = np.asarray(jsift.grad_levels(jnp.asarray(g[i].numpy())))
            np.testing.assert_allclose(got[i], want, atol=1e-5, rtol=0)


def assert_finalized_close(got, want):
    diff = np.abs(got - want)
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()
    assert diff.max() <= 1.0


@pytest.mark.parametrize("samples", [16, 12])
def test_descr_chunk_matches_jax(octaves, samples):
    """Random keypoints on octave 1's bf16 gradient table, every level and
    angle, some near and past the border: the 4-D gather path of JAX."""
    g = octaves[1]
    b, _, h, w = g.shape
    table = tsift.quad_blocks_from_levels(tsift.grad_levels(g).to(torch.bfloat16))
    rng = np.random.RandomState(samples)
    k = 300
    lv = rng.randint(0, 3, (b, k)).astype(np.int32)
    px = rng.uniform(-3, w + 3, (b, k)).astype(np.float32)
    py = rng.uniform(-3, h + 3, (b, k)).astype(np.float32)
    scl = rng.uniform(0.8, 4.0, (b, k)).astype(np.float32)
    ang = rng.uniform(0, 360, (b, k)).astype(np.float32)
    valid = (rng.rand(b, k) < 0.9).astype(np.float32)
    got = tsift._descr_chunk(table, h, w, *(torch.from_numpy(x) for x in
                                           (lv, px, py, scl, ang, valid)), s=samples).numpy()
    for i in range(b):
        jtable = jquad_blocks(jsift.grad_levels(jnp.asarray(g[i].numpy())).astype(jnp.bfloat16))
        want = np.asarray(jsift._descr_chunk(jtable, h, w, *(jnp.asarray(x[i]) for x in
                                                            (lv, px, py, scl, ang, valid)),
                                            samples))
        assert want.max() > 100  # real descriptors, not zeros
        assert_finalized_close(got[i], want)


def test_orientation_maps_match_jax(octaves):
    blur = build_gray_blur(*FRAME, True)
    for o, g in enumerate(octaves):
        got = tdetect._orientation_maps(g).numpy()
        mags = []
        for layer in range(1, 4):
            x = g[:, layer]
            gx = (torch.roll(x, -1, -1) - torch.roll(x, 1, -1)) * 0.5
            gy = (torch.roll(x, -1, -2) - torch.roll(x, 1, -2)) * 0.5
            kern = tpyramid.gaussian_kernel_1d(1.5 * 1.6 * 2 ** (layer / 3))
            mags.append(torch.hypot(tpyramid.sep_blur(gx, kern), tpyramid.sep_blur(gy, kern)))
        strong = torch.stack(mags, 1).numpy() >= MAG_MARGIN
        if min(g.shape[-2:]) >= 16:  # the last octaves are a few flat pixels
            assert strong.mean() > 0.9
        for i in range(g.shape[0]):
            want = np.asarray(jdetect._orientation_maps(jnp.asarray(g[i].numpy()),
                                                        blur["ori"][o]))
            d = np.abs(got[i] - want)
            d = np.minimum(d, 360.0 - d)
            assert d[strong[i]].max() <= ANGLE_TOL, (o, d[strong[i]].max())


@functools.lru_cache(maxsize=None)
def jax_extractor(first_map_oct):
    """JAX's devsift extraction (upsampled, 256 keypoints), compiled once
    per process for each `dense_first_map_oct`."""
    h, w = FRAME
    budgets = jfused.octave_budgets(h, w, 256, True)
    jfe = JFrontendConfig(descriptor_source="devsift", upsample=True,
                          dense_first_map_oct=first_map_oct)
    blur = build_gray_blur(h, w, True)
    fn = jax.jit(jax.vmap(lambda im: jfused._extract_side(im, h, w, budgets, jfe, {}, None,
                                                          None, blur)))
    return lambda imgs: as_np(fn(jnp.asarray(imgs)))


def assert_unit_descriptors_close(got, want):
    diff = np.abs(got - want)
    assert (diff <= 1e-5).mean() >= 0.999
    assert diff.max() <= 1.0 / 256


@pytest.mark.parametrize("first_map_oct", [0, 1])
def test_extract_side_devsift_matches_jax(images, first_map_oct):
    """Upsampled geometry, 256 keypoints per image; dense_first_map_oct 1
    describes octave 0's keypoints from octave 1's gradients."""
    budgets = jfused.octave_budgets(*FRAME, 256, True)
    fe = FrontendConfig(descriptor_source="devsift", upsample=True,
                        dense_first_map_oct=first_map_oct)
    for imgs in images:
        jk, js, jv, jd = jax_extractor(first_map_oct)(imgs)
        with torch.no_grad():
            tk, ts, tv, td = (t.numpy() for t in tfused._extract_side(
                torch.from_numpy(imgs), budgets, fe, None))
        assert jv.sum() > 100
        same = jv & tv & (np.abs(jk - tk).max(-1) < 1e-3)
        assert same.sum() >= 0.99 * jv.sum()
        np.testing.assert_allclose(ts[same], js[same], atol=1e-4, rtol=0)
        assert td.shape == jd.shape and td.shape[-1] == 256
        np.testing.assert_array_equal(td[..., :128], td[..., 128:])
        assert_unit_descriptors_close(td[same], jd[same])


def test_whole_devsift_slice_matches_jax(images):
    imgs0, imgs1 = images
    h, w = FRAME
    budgets = jfused.octave_budgets(h, w, 256, True)
    jfe = JFrontendConfig(descriptor_source="devsift", upsample=True)
    jmcfg = JMatcherConfig(num_gnn_layers=2, sinkhorn_iterations=20, match_threshold=0.02)
    variables = as_np(init_gmatcher_variables(jmcfg, seed=0, scheme="identity"))
    jside = [jax_extractor(0)(x) for x in (imgs0, imgs1)]
    compact_to = 128
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    want = as_np(jpipeline.forward_match(
        jvars, jmcfg, JAGCConfig(**KNOBS),
        jside[0][0], jside[0][3], jside[0][2], jside[1][0], jside[1][3], jside[1][2],
        image_shape=FRAME, compact_to=compact_to, scores0=jside[0][1], scores1=jside[1][1]))

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

    # the whole of fused_match_batch, images in
    blur = build_gray_blur(h, w, True)
    jfmb = jax.jit(jfused.fused_match_batch, static_argnums=(2, 3, 4, 5, 6, 9, 10, 11, 12, 14))
    want = as_np(jfmb(jvars, {}, None, jmcfg, JAGCConfig(**KNOBS), jfe, budgets,
                      jnp.asarray(imgs0), jnp.asarray(imgs1), h, w, None, False, blur,
                      compact_to))
    fe = FrontendConfig(descriptor_source="devsift", upsample=True)
    got = tfused.fused_match_batch(model, None, AGCConfig(**KNOBS), fe, budgets,
                                   torch.from_numpy(imgs0), torch.from_numpy(imgs1), h, w,
                                   False, compact_to)
    for key in ("kept0", "kept1", "matches0", "matches1"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    for key in ("keypoints0", "keypoints1"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-3, rtol=0)


def test_fused_matching_devsift_on_cpu(images):
    """FusedMatching(descriptor_source="devsift") with the staged
    checkpoint's matcher: no CNN, car_variables unused, the reference's
    per-pair dict."""
    from gims_tpu_torch.matcher.convert import load_gims_checkpoint

    weights = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "weights", "gims_tpu_sift_last.npz")
    m = tfused.FusedMatching({"descriptor_source": "devsift", "compact_to": 128,
                              "sift_samples": 12, **KNOBS},
                             variables=load_gims_checkpoint(weights),
                             car_variables={"unused": 1}, total_keypoints=256, device="cpu")
    rc = m.resolved_config()
    assert m.car_model is None and not rc["dense_model"]
    assert rc["frontend"]["descriptor_source"] == "devsift"
    assert rc["frontend"]["sift_samples"] == 12
    preds = m.collect_batch(m.dispatch_batch(*images))
    assert len(preds) == 2
    for p in preds:
        n1 = p["keypoints1"].shape[1]
        assert p["matches0"].max() < n1 and (p["matches0"] >= 0).sum() > 0
