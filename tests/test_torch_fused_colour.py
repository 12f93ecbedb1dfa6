"""The fused colour sources: the PyTorch port against the JAX package on
the CPU.

carhynet (at ``fast_frontend``, the bilinear 32x32 warp the card runs by
default; the bicubic warp is held to JAX in ``tests/test_torch_patches.py``
and, end to end, in ``tests/test_torch_staged.py``) and dense, a flax init of
the colour CAR-HyNet carried over, the 2-layer matcher (identity init), f32,
96x128 BGR pairs, B = 2, 256 keypoints, eval knobs. JAX runs
``fused_match_batch`` as its two stages, each jitted: ``_extract_side``
under ``vmap`` for each side (one compile serves both), then
``pipeline.forward_match``; the port runs its own ``fused_match_batch``,
whose ``_extract_side`` call is recorded. Tolerances: ``_extract_side``
keypoints 1e-3 px, scores 1e-4 where both select the same keypoint; the
unit descriptors 1e-4 on the first side and 1e-3 on the second, where the
carhynet source has two keypoints 4e-5 and 3e-4 px apart (f32 rounding of
the subpixel refinement) whose descriptors differ by 2.2e-4, the staged
path's tolerance for the same reason (``tests/test_torch_staged.py``); the
whole slice: kept and matches equal.
"""

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
from gims_tpu.frontend.detect_device import build_gray_blur
from gims_tpu.matcher import pipeline as jpipeline
from gims_tpu_torch import fused as tfused
from gims_tpu_torch.carhynet import convert as tcconvert
from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.config import AGCConfig, FrontendConfig, MatcherConfig
from gims_tpu_torch.matcher.convert import load_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.synthetic import synthetic_image_pair
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

FRAME = (96, 128)
KNOBS = dict(radius=15.0, percentile=2.0, min_size=7)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def colour_inputs():
    pairs = [synthetic_image_pair(s, FRAME, colour=True) for s in (5, 6)]
    imgs0 = np.stack([p[0] for p in pairs])
    imgs1 = np.stack([p[1] for p in pairs])
    jmcfg = JMatcherConfig(num_gnn_layers=2, sinkhorn_iterations=20, match_threshold=0.02)
    # jitted inits: the values of the eager ones, in a fraction of the time
    variables = as_np(jax.jit(lambda: init_gmatcher_variables(jmcfg, seed=0,
                                                              scheme="identity"))())
    car = as_np(jax.jit(JCARHyNet(in_channels=3).init)(jax.random.PRNGKey(3),
                                                       jnp.zeros((1, 32, 32, 3), jnp.float32)))
    return imgs0, imgs1, jmcfg, variables, car


@pytest.mark.parametrize("source", ["carhynet", "dense"])
def test_colour_sources_match_jax(colour_inputs, source, monkeypatch):
    imgs0, imgs1, jmcfg, variables, car = colour_inputs
    h, w = FRAME
    budgets = jfused.octave_budgets(h, w, 256, True)
    warp = dict(interpolation="linear", warp_size=32)
    jfe = JFrontendConfig(descriptor_source=source, dense_dtype="float32", **warp)
    blur = build_gray_blur(h, w, True)
    jcar = jax.tree_util.tree_map(jnp.asarray, car)
    dense = JCARHyNet(dense=True, in_channels=3) if source == "dense" else None

    @jax.jit
    def extract(ims):
        return jax.vmap(lambda im: jfused._extract_side(
            im, h, w, budgets, jfe, jcar, JCARHyNet(in_channels=3), dense, blur))(ims)

    jsides = [as_np(extract(jnp.asarray(ims))) for ims in (imgs0, imgs1)]
    forward = jax.jit(jpipeline.forward_match, static_argnums=(1, 2),
                      static_argnames=("image_shape", "compact_to"))
    (k0, s0, v0, d0), (k1, s1, v1, d1) = jsides
    want = as_np(forward(jax.tree_util.tree_map(jnp.asarray, variables), jmcfg,
                         JAGCConfig(**KNOBS), k0, d0, v0, k1, d1, v1, image_shape=(h, w),
                         compact_to=None, scores0=s0, scores1=s1))
    fe = FrontendConfig(descriptor_source=source, dense_dtype="float32", **warp)
    car_model = CARHyNet(dense=source == "dense", in_channels=3).eval()
    tcconvert.load_variables(car_model, car)
    model = GMatcher(MatcherConfig(num_gnn_layers=2, sinkhorn_iterations=20,
                                   match_threshold=0.02)).eval()
    load_variables(model, variables)
    sides = []
    extract_side = tfused._extract_side
    monkeypatch.setattr(tfused, "_extract_side",
                        lambda *a: sides.append(extract_side(*a)) or sides[-1])
    got = tfused.fused_match_batch(
        model, car_model, AGCConfig(**KNOBS), fe, budgets, torch.from_numpy(imgs0),
        torch.from_numpy(imgs1), h, w, False, None)
    b = len(imgs0)
    tboth = [t.numpy() for t in sides[0]]  # both sides, as one batch of 2B images
    for i, (jk, js, jv, jd) in enumerate(jsides):
        tk, ts, tv, td = (t[i * b:(i + 1) * b] for t in tboth)
        assert jv.sum() > 100
        same = jv & tv & (np.abs(jk - tk).max(-1) < 1e-3)
        assert same.sum() >= 0.99 * jv.sum()
        np.testing.assert_allclose(ts[same], js[same], atol=1e-4, rtol=0)
        np.testing.assert_allclose(td[same], jd[same], atol=1e-4 if i == 0 else 1e-3, rtol=0)
    assert (want["matches0"] >= 0).sum() > 10
    for key in ("kept0", "kept1", "matches0", "matches1"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
