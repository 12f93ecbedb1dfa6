"""AGC, dense build: the PyTorch port against the JAX package on the CPU.

The same numpy inputs go through ``gims_tpu.agc.graph.build_graph`` and
``gims_tpu_torch.agc.graph.build_graph``. Adjacency and kept masks are
integer outputs and must be bit-equal; the threshold is one element of the
same similarity matrix and must be equal to f32 rounding of the matmul
(1e-6).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gims_tpu.agc import graph as jgraph
from gims_tpu.config import AGCConfig as JAGCConfig
from gims_tpu.matcher import pipeline as jpipeline
from gims_tpu_torch.agc import graph as tgraph
from gims_tpu_torch.config import AGCConfig
from gims_tpu_torch.matcher import pipeline as tpipeline


def make_set(seed, nb, n, radius=15.0, d=128):
    """n SIFT-like keypoints (non-negative descriptors) padded to nb rows
    the way pad_keypoint_set pads them; about 2.5 neighbours within
    `radius` per keypoint, so that both edges and pruning happen."""
    rng = np.random.RandomState(seed)
    side = radius * np.sqrt(np.pi * n / 2.5)
    kpts = np.full((nb, 2), 1e6, np.float32)
    kpts[:n] = rng.rand(n, 2) * side
    descs = np.zeros((nb, d), np.float32)
    descs[:n] = np.abs(rng.randn(n, d)) ** 2
    valid = np.zeros(nb, bool)
    valid[:n] = True
    return kpts, descs, valid


def assert_graph_equal(jout, tout):
    np.testing.assert_array_equal(np.asarray(jout.kept), tout.kept.numpy())
    np.testing.assert_array_equal(np.asarray(jout.adj), tout.adj.numpy())


KNOBS = [(15.0, 2.0, 7), (25.0, 7.0, 8)]


@pytest.mark.parametrize("nb,n", [(256, 200), (512, 460)])
@pytest.mark.parametrize("radius,percentile,min_size", KNOBS)
def test_build_graph_bit_equal(nb, n, radius, percentile, min_size):
    kpts, descs, valid = make_set(nb + int(radius), nb, n, radius)
    jout = jgraph.build_graph(jnp.asarray(kpts), jnp.asarray(descs),
                              jnp.asarray(valid), radius=radius,
                              percentile=percentile, min_size=min_size)
    tout = tgraph.build_graph(torch.from_numpy(kpts), torch.from_numpy(descs),
                              torch.from_numpy(valid), radius=radius,
                              percentile=percentile, min_size=min_size)
    assert 0 < int(tout.kept.sum()) < n  # pruning and edges both happen
    assert_graph_equal(jout, tout)
    np.testing.assert_allclose(float(tout.threshold), float(jout.threshold),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(jout.labels), tout.labels.numpy())


def test_build_graph_clusters_reconnect():
    """Far-apart clusters: small-component pruning and the component
    reconnect pass both change the graph."""
    rng = np.random.RandomState(42)
    pts = [rng.rand(c, 2).astype(np.float32) * 30 + [x, y]
           for x, y, c in [(0, 0, 30), (500, 0, 25), (0, 500, 12),
                           (500, 500, 4), (250, 250, 3)]]
    n = sum(len(p) for p in pts)
    kpts = np.full((128, 2), 1e6, np.float32)
    kpts[:n] = np.concatenate(pts)
    descs = np.zeros((128, 8), np.float32)
    descs[:n] = rng.randn(n, 8)
    valid = np.arange(128) < n
    jout = jgraph.build_graph(jnp.asarray(kpts), jnp.asarray(descs),
                              jnp.asarray(valid), radius=40.0,
                              percentile=5.0, min_size=6)
    tout = tgraph.build_graph(torch.from_numpy(kpts), torch.from_numpy(descs),
                              torch.from_numpy(valid), radius=40.0,
                              percentile=5.0, min_size=6)
    assert_graph_equal(jout, tout)


def test_run_agc_batched_with_host_rank():
    """The pipeline's batched AGC over both sides of a pair, with the
    exact percentile rank (JAX's host rule, the port's on the device),
    equals the JAX vmapped build."""
    sets = [make_set(s, 256, n) for s, n in ((3, 230), (4, 190))]
    kpts, descs, valid = (np.stack(x) for x in zip(*sets))
    ks = [jpipeline.percentile_rank(int(v.sum()), 2.0) for v in valid]
    assert ks == tpipeline.percentile_rank(torch.from_numpy(valid).sum(dim=1), 2.0).tolist()
    jadj, jkept, _ = jpipeline.run_agc(
        jnp.asarray(kpts), jnp.asarray(descs), jnp.asarray(valid),
        JAGCConfig(), jnp.asarray(ks, jnp.int32), radius=15.0, min_size=7)
    tadj, tkept, _ = tpipeline.run_agc(
        torch.from_numpy(kpts), torch.from_numpy(descs),
        torch.from_numpy(valid), AGCConfig(), torch.tensor(ks),
        radius=15.0, min_size=7)
    np.testing.assert_array_equal(np.asarray(jkept), tkept.numpy())
    np.testing.assert_array_equal(np.asarray(jadj), tadj.numpy())


def test_connected_components_path_graph():
    """A long path converges to one label within the round cap, as JAX."""
    n = 64
    adj = np.zeros((n, n), bool)
    i = np.arange(n - 1)
    adj[i, i + 1] = adj[i + 1, i] = True
    valid = np.ones(n, bool)
    valid[-3:] = False
    adj[:, -3:] = adj[-3:, :] = False
    want = np.asarray(jgraph.connected_components(
        jnp.asarray(adj), jnp.asarray(valid), 20))
    got = tgraph.connected_components(torch.from_numpy(adj)[None],
                                      torch.from_numpy(valid)[None], 20)[0]
    np.testing.assert_array_equal(want, got.numpy())


def test_kth_smallest_exact():
    rng = np.random.RandomState(1)
    vals = rng.rand(40, 40).astype(np.float32)
    mask = rng.rand(40, 40) < 0.5
    for k in (0, 17, int(mask.sum()) - 1):
        want = np.sort(vals[mask])[k]
        got = tgraph.kth_smallest_masked(torch.from_numpy(vals)[None],
                                         torch.from_numpy(mask)[None], torch.tensor([k]))
        assert float(got[0]) == want
        jgot = jgraph.kth_smallest_masked(jnp.asarray(vals), jnp.asarray(mask),
                                          jnp.int32(k), lo=-0.001, hi=1.001)
        assert float(jgot) == want


@pytest.mark.parametrize("knob", [dict(agc_impl="band"), dict(cc_impl="sparse"),
                                  dict(threshold_impl="approx"),
                                  dict(reconnect_impl="centroid")])
def test_unported_agc_impls_raise(knob):
    kpts, descs, valid = make_set(0, 128, 100)
    with pytest.raises(NotImplementedError):
        tpipeline.run_agc(torch.from_numpy(kpts)[None],
                          torch.from_numpy(descs)[None],
                          torch.from_numpy(valid)[None], AGCConfig(**knob))


def test_kth_smallest_batched_matches_per_item():
    """One sort per item with masked entries at +inf, read at each item's
    k (clipped to its count), equals the per-item order statistic; an
    empty mask gives 0."""
    rng = np.random.RandomState(2)
    vals = rng.randn(4, 30, 30).astype(np.float32)
    mask = rng.rand(4, 30, 30) < 0.3
    mask[2] = False
    ks = np.array([0, 111, 5, 10 ** 6])
    got = tgraph.kth_smallest_masked(torch.from_numpy(vals), torch.from_numpy(mask),
                                     torch.from_numpy(ks))
    for i in range(4):
        sel = np.sort(vals[i][mask[i]])
        want = 0.0 if sel.size == 0 else sel[min(ks[i], sel.size - 1)]
        assert float(got[i]) == want


def test_percentile_ranks_on_device_match_host_rules():
    """The device ranks equal JAX's host rule ``percentile_rank`` (float64)
    and JAX's in-graph f32 rule, also past 2**24 pairs where f32 rounds."""
    counts = np.array([0, 1, 2, 3, 50, 460, 1800, 6144, 7000, 16384, 24576])
    for pct in (2.0, 7.0, 0.5):
        dev = tpipeline.percentile_rank(torch.from_numpy(counts), pct)
        assert dev.tolist() == [jpipeline.percentile_rank(int(c), pct) for c in counts]
        got = tgraph.percentile_k(torch.from_numpy(counts), pct)
        for c, k in zip(counts, got.tolist()):
            nv = jnp.int32(c)
            count = (nv * (nv - 1)) // 2
            want = jnp.floor(count.astype(jnp.float32) * jnp.float32(pct / 100.0)).astype(jnp.int32)
            want = max(int(jnp.where(want >= count, count - 1, want)), 0)
            assert k == want, (c, pct)


@pytest.mark.parametrize("rounds", [0, 1, 2, 20])
def test_connected_components_fixed_rounds_equal_early_exit(rounds):
    """The port runs 1 + rounds rounds; JAX stops once a round changes no
    label, within the same cap. A long path does not converge in the
    smaller caps, a random graph converges early: equal labels either way."""
    n = 200
    path = np.zeros((n, n), bool)
    i = np.arange(n - 1)
    path[i, i + 1] = path[i + 1, i] = True
    rng = np.random.RandomState(rounds)
    rand = rng.rand(n, n) < 0.01
    rand = rand | rand.T
    np.fill_diagonal(rand, False)
    valid = rng.rand(n) < 0.9
    for adj in (path, rand):
        adj = adj & valid[:, None] & valid[None, :]
        want = np.asarray(jgraph.connected_components(
            jnp.asarray(adj), jnp.asarray(valid), rounds))
        got = tgraph.connected_components(torch.from_numpy(adj)[None],
                                          torch.from_numpy(valid)[None], rounds)[0]
        np.testing.assert_array_equal(got.numpy(), want)
