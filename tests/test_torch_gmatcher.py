"""GMatcher trunk: the PyTorch port against the JAX package on the CPU, at
full width (18 GNN layers, 256-d, 4 heads, 3 SAGE layers) with the staged
checkpoint ``weights/gims_tpu_sift_last.npz`` on a 128-keypoint bucket.

Z agrees within 1e-3 and mdesc within 1e-4 in f32 (the bars of the JAX
package's own golden torch test: sums over 18 residual layers taken in
another order). With attention_dtype="bfloat16" both frameworks round the
trunk to bf16 at different places; Z agrees within 5e-2, the bf16 bar of
the JAX package's attention test.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax.core import unfreeze

from gims_tpu.config import MatcherConfig as JMatcherConfig
from gims_tpu.matcher.layers import MultiHeadedAttention as JMultiHeadedAttention
from gims_tpu.matcher.gmatcher import GMatcher as JGMatcher
from gims_tpu.matcher.gmatcher import normalize_keypoints as jnormalize
from gims_tpu_torch.config import MatcherConfig
from gims_tpu_torch.matcher import layers as tlayers
from gims_tpu_torch.matcher.convert import (head_major_perm, load_gims_checkpoint,
                                            load_variables, variables_to_state_dict)
from gims_tpu_torch.matcher.gmatcher import GMatcher, normalize_keypoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")
NB = 128


@pytest.fixture(scope="module")
def variables():
    return load_gims_checkpoint(WEIGHTS)


def test_checkpoint_loads_without_missing_or_unexpected_keys(variables):
    sd = variables_to_state_dict(variables)
    with np.load(WEIGHTS) as data:
        assert len(data.files) == 326 == len(sd)
    model = GMatcher(MatcherConfig())
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert missing == [] and unexpected == []
    # flax Dense kernels are (in, out): transposed into Linear.weight
    k = variables["params"]["gnn"]["layer_0"]["attn"]["proj_q"]["kernel"]
    np.testing.assert_array_equal(sd["gnn.layer_0.attn.proj_q.weight"].numpy(), k.T)
    np.testing.assert_array_equal(
        sd["kenc.encoder.norm_0.running_var"].numpy(),
        variables["batch_stats"]["kenc"]["encoder"]["norm_0"]["var"])


def pair_inputs(seed):
    """Both sides of a pair in the 128 bucket: padded keypoints at 1e6,
    SIFT-like duplicated descriptors, a random symmetric adjacency among
    kept nodes."""
    rng = np.random.RandomState(seed)
    out = []
    for n in (100, 90):
        kpts = np.full((1, NB, 2), 1e6, np.float32)
        kpts[0, :n] = rng.rand(n, 2) * [640, 480]
        d = np.abs(rng.randn(NB, 128)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        desc = np.concatenate([d, d], axis=1)[None]
        desc[0, n:] = 0
        kept = np.zeros((1, NB), bool)
        kept[0, :n] = rng.rand(n) < 0.9
        a = rng.rand(NB, NB) < 0.05
        adj = (a | a.T) & kept[0][:, None] & kept[0][None, :]
        np.fill_diagonal(adj, False)
        out.append((kpts, desc, adj[None], kept))
    return out


def run_pair(mcfg_kwargs, variables, seed=0, stack_sides=True):
    (k0, d0, a0, m0), (k1, d1, a1, m1) = pair_inputs(seed)
    jcfg = JMatcherConfig(**mcfg_kwargs)
    jk0 = jnormalize(jnp.asarray(k0), 480, 640)
    jk1 = jnormalize(jnp.asarray(k1), 480, 640)
    jout = JGMatcher(jcfg).apply(
        variables, jk0, jnp.asarray(d0), jnp.asarray(a0), jnp.asarray(m0),
        jk1, jnp.asarray(d1), jnp.asarray(a1), jnp.asarray(m1))
    model = GMatcher(MatcherConfig(**mcfg_kwargs, stack_sides=stack_sides))
    load_variables(model, variables)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    tk0 = normalize_keypoints(t(k0), 480, 640)
    tk1 = normalize_keypoints(t(k1), 480, 640)
    np.testing.assert_array_equal(tk0.numpy(), np.asarray(jk0))
    with torch.no_grad():
        tout = model(tk0, t(d0), t(a0), t(m0), tk1, t(d1), t(a1), t(m1))
    return jout, tout, (m0, m1)


def valid_z(z, m0, m1):
    rows = list(np.nonzero(m0[0])[0]) + [NB]
    cols = list(np.nonzero(m1[0])[0]) + [NB]
    return np.asarray(z)[0][np.ix_(rows, cols)]


@pytest.mark.parametrize("stack_sides", [True, False])
def test_gmatcher_f32_matches_jax(variables, stack_sides):
    jout, tout, (m0, m1) = run_pair({"sinkhorn_iterations": 100}, variables,
                                    stack_sides=stack_sides)
    np.testing.assert_allclose(valid_z(tout["Z"].numpy(), m0, m1),
                               valid_z(jout["Z"], m0, m1), rtol=1e-3, atol=1e-3)
    for side, m in (("mdesc0", m0), ("mdesc1", m1)):
        np.testing.assert_allclose(tout[side].numpy()[m], np.asarray(jout[side])[m],
                                   rtol=1e-4, atol=1e-4)


def test_gmatcher_bf16_matches_jax(variables):
    jout, tout, (m0, m1) = run_pair(
        {"sinkhorn_iterations": 100, "attention_dtype": "bfloat16"}, variables)
    np.testing.assert_allclose(valid_z(tout["Z"].numpy(), m0, m1),
                               valid_z(jout["Z"], m0, m1), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("mode", ["standard", "gims"])
def test_normalize_keypoints_modes(mode):
    kpts = np.random.RandomState(0).rand(5, 2).astype(np.float32) * 600
    want = np.asarray(jnormalize(jnp.asarray(kpts), 600, 800, mode))
    got = normalize_keypoints(torch.from_numpy(kpts), 600, 800, mode).numpy()
    np.testing.assert_array_equal(got, want)


def test_head_interleave():
    """Channel c = d*H + h of the reference becomes (h, d) in the port's
    head-major layout."""
    perm = head_major_perm(8, 2).tolist()
    assert perm == [0, 2, 4, 6, 1, 3, 5, 7]


def test_attention_heads_permuted_at_load():
    """One attention layer with random weights in the reference's layout:
    the port, which holds the heads head-major after load_variables, gives
    the JAX layer's output (f32, within 1e-5: sums in another order)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, 16).astype(np.float32)
    src = rng.randn(2, 12, 16).astype(np.float32)
    mask = rng.rand(2, 12) < 0.8
    mask[:, 0] = True
    jm = JMultiHeadedAttention(num_heads=4, d_model=16, attn_impl="direct")
    variables = unfreeze(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), x, src, src, mask)))
    want = np.asarray(jm.apply(variables, x, src, src, mask))
    tm = tlayers.MultiHeadedAttention(4, 16, attn_impl="direct")
    load_variables(tm, variables)
    t = torch.from_numpy
    with torch.no_grad():
        got = tm(t(x), t(src), t(src), t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sage_zero_degree_aggregates_zero():
    conv = tlayers.SAGEConv(3, 2)
    with torch.no_grad():
        conv.fc_neigh.weight.fill_(1.0)
        conv.fc_self.weight.zero_()
        conv.bias.zero_()
    h = torch.randn(1, 4, 3)
    adj = torch.zeros(1, 4, 4, dtype=torch.bool)
    adj[0, 0, 1] = adj[0, 1, 0] = True
    out = conv(h, adj)
    assert torch.all(out[0, 2:] == 0)
    torch.testing.assert_close(out[0, 0], h[0, 1].sum().expand(2))
