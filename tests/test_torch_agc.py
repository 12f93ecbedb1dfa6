"""AGC: the PyTorch port against the JAX package on the CPU.

The same numpy inputs go through ``gims_tpu.agc.graph`` and
``gims_tpu_torch.agc.graph``: the dense build (exact or strided threshold,
exact or centroid reconnect, dense or sparse components), the band build
and its helpers, the label rounds of all three layouts, ``band_coverage``
and the pipeline around them. Adjacency, kept masks, labels and the band
build's ``inv`` are integer outputs and must be bit-equal; the threshold
is one element of each side's own similarity matrix and must be equal to
f32 rounding of the row norms (1e-6).
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gims_tpu.agc import graph as jgraph
from gims_tpu.config import AGCConfig as JAGCConfig
from gims_tpu.matcher import pipeline as jpipeline
from gims_tpu_torch.agc import band as tband
from gims_tpu_torch.agc import graph as tgraph
from gims_tpu_torch.agc import labels as tlabels
from gims_tpu_torch.config import AGCConfig, MatcherConfig
from gims_tpu_torch.matcher import pipeline as tpipeline
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.synthetic import synthetic_request
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)


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


@pytest.mark.parametrize("case", ["shard_axis", "unknown_build"])
def test_unported_agc_impls_raise(case, tmp_path):
    """A build name the JAX package does not have raises. Keypoint-axis
    sharding is ported (tests/test_torch_sharded.py): the axis name "kp"
    without a group set by ``ring_attention.set_ring_group`` raises
    ValueError, and ``compact_to`` with a group (one gloo rank here) runs
    and returns the unsharded compacted call's matches and kept masks."""
    kpts, descs, valid = (torch.from_numpy(x)[None] for x in make_set(0, 128, 100))
    if case == "unknown_build":
        with pytest.raises(ValueError, match="agc_impl"):
            tpipeline.run_agc(kpts, descs, valid, AGCConfig(agc_impl="tiled"))
        return
    import torch.distributed as dist

    from gims_tpu_torch.matcher import ring_attention
    from gims_tpu_torch.train import multihost

    model = GMatcher(MatcherConfig(num_gnn_layers=2)).eval()
    ring_attention.set_ring_group(None)
    with pytest.raises(ValueError, match="set_ring_group"):
        tpipeline.forward_match(model, AGCConfig(), kpts, descs, valid, kpts, descs, valid,
                                image_shape=(600, 800), shard_axis="kp")
    kp0, de0, va0 = (torch.from_numpy(x)[None] for x in make_set(1, 128, 100, d=256))
    kp1, de1, va1 = (torch.from_numpy(x)[None] for x in make_set(2, 128, 90, d=256))
    args = (model, AGCConfig(radius=60.0, percentile=5.0, min_size=3), kp0, de0, va0, kp1, de1,
            va1)
    want = tpipeline.forward_match(*args, image_shape=(600, 800), compact_to=64)
    dist.init_process_group("gloo", init_method=multihost.local_init_method(str(tmp_path)),
                            world_size=1, rank=0)
    try:
        got = tpipeline.forward_match(*args, image_shape=(600, 800), compact_to=64,
                                      shard_axis=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    for key in ("matches0", "matches1", "kept0", "kept1"):
        assert torch.equal(got[key], want[key]), key
    assert want["kept0"].any()


@pytest.mark.parametrize("given", ["both", "side0"])
def test_forward_match_precomputed_adjacency_matches_jax(given):
    """A side given its adjacency (a Delaunay graph here) skips AGC and
    keeps every valid keypoint; the other side, without one, runs AGC
    (2-layer matcher, identity init): kept and matches equal to JAX's,
    matching scores 1e-4."""
    import jax

    from gims_tpu.api import init_gmatcher_variables
    from gims_tpu.config import MatcherConfig as JMatcherConfig
    from gims_tpu_torch.matcher.convert import load_variables

    jmcfg = JMatcherConfig(num_gnn_layers=2, sinkhorn_iterations=20, match_threshold=0.02)
    # jitted init: the values of the eager one, in a fraction of the time
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: init_gmatcher_variables(jmcfg, seed=0, scheme="identity"))())
    kp0, de0, va0 = make_set(11, 256, 200, d=256)
    kp1, de1, va1 = make_set(12, 256, 190, d=256)
    adj0 = tgraph.delaunay_adjacency_host(kp0, va0)[None]
    adj1 = tgraph.delaunay_adjacency_host(kp1, va1)[None] if given == "both" else None
    args = [x[None] for x in (kp0, de0, va0, kp1, de1, va1)]
    knobs = dict(radius=15.0, percentile=2.0, min_size=7)
    forward = jax.jit(jpipeline.forward_match, static_argnums=(1, 2),
                      static_argnames=("image_shape",))
    want = forward(
        jax.tree_util.tree_map(jnp.asarray, variables), jmcfg, JAGCConfig(**knobs),
        *(jnp.asarray(x) for x in args), image_shape=(600, 800), adj0=jnp.asarray(adj0),
        adj1=None if adj1 is None else jnp.asarray(adj1))
    model = GMatcher(MatcherConfig(num_gnn_layers=2, sinkhorn_iterations=20,
                                   match_threshold=0.02)).eval()
    load_variables(model, variables)
    got = tpipeline.forward_match(
        model, AGCConfig(**knobs), *(torch.from_numpy(x) for x in args), image_shape=(600, 800),
        adj0=torch.from_numpy(adj0), adj1=None if adj1 is None else torch.from_numpy(adj1))
    assert got["kept0"].numpy().sum() == 200
    assert (given == "both") == (got["kept1"].numpy().sum() == 190)
    for key in ("kept0", "kept1", "matches0", "matches1"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0)


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


def band_of(adj, wh):
    """Forward band (N, wh) of a symmetric adjacency whose edges lie within
    wh sorted positions: band[i, m] = adj[i, i + 1 + m]."""
    n = adj.shape[0]
    j = np.arange(n)[:, None] + 1 + np.arange(wh)[None, :]
    return np.where(j < n, adj[np.arange(n)[:, None], np.minimum(j, n - 1)], False)


def neighbour_list_of(adj, cap):
    """(nbr_idx, nbr_ok) (N, cap): each node's first `cap` neighbours by index;
    a node with more neighbours keeps only those (the push covers the rest
    where the other end kept the edge)."""
    n = adj.shape[0]
    key = np.where(adj, np.arange(n)[None, :], n + np.arange(n)[None, :])
    nbr = np.argsort(key, axis=1, kind="stable")[:, :cap].astype(np.int32)
    return nbr, np.take_along_axis(adj, nbr, axis=1)


@pytest.mark.parametrize("rounds", [0, 1, 2, 20])
def test_connected_components_fixed_rounds_equal_early_exit(rounds):
    """JAX stops once a round changes no label, within the cap of 1 + rounds
    rounds; so does the port, for the dense, band and sparse loops alike. A
    long path does not converge in the smaller caps, a random graph
    converges early: the labels are equal either way, capped or not."""
    n = 256
    path = np.zeros((n, n), bool)
    i = np.arange(n - 1)
    path[i, i + 1] = path[i + 1, i] = True
    rng = np.random.RandomState(rounds)
    rand = rng.rand(n, n) < 0.01
    rand = rand | rand.T
    np.fill_diagonal(rand, False)
    near = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) <= 64
    valid = rng.rand(n) < 0.9
    for adj in (path, rand, rand & near):
        adj = adj & valid[:, None] & valid[None, :]
        want = np.asarray(jgraph.connected_components(
            jnp.asarray(adj), jnp.asarray(valid), rounds))
        got = tgraph.connected_components(torch.from_numpy(adj)[None],
                                          torch.from_numpy(valid)[None], rounds)[0]
        np.testing.assert_array_equal(got.numpy(), want)
        nbr, ok = neighbour_list_of(adj, 4)
        want = np.asarray(jgraph.connected_components_sparse(
            jnp.asarray(nbr), jnp.asarray(ok), jnp.asarray(valid), rounds))
        got = tgraph.connected_components_sparse(
            torch.from_numpy(nbr)[None], torch.from_numpy(ok)[None],
            torch.from_numpy(valid)[None], rounds)[0]
        np.testing.assert_array_equal(got.numpy(), want)
        if adj is not rand:  # the band holds edges within 64 positions only
            band = band_of(adj, 128)
            want = np.asarray(jgraph.connected_components_band(
                jnp.asarray(band), jnp.asarray(valid), rounds))
            got = tgraph.connected_components_band(torch.from_numpy(band)[None],
                                                   torch.from_numpy(valid)[None], rounds)[0]
            np.testing.assert_array_equal(got.numpy(), want)


def test_label_rounds_stop_early(monkeypatch):
    """The rounds stop at the first round that changes no label, as JAX's
    loop does: on a path of 64 nodes, a few rounds of the cap of 21."""
    n = 64
    adj = np.zeros((1, n, n), bool)
    adj[0, np.arange(n - 1), np.arange(1, n)] = True
    adj = torch.from_numpy(adj | adj.transpose(0, 2, 1))
    valid = torch.ones((1, n), dtype=torch.bool)
    # the rounds to the fixpoint, one at a time
    one_round = tlabels._round_fn("dense", adj, valid, None)
    label, settle = torch.arange(n, dtype=torch.int32)[None], 0
    while True:
        new = one_round(label)
        settle += 1
        if torch.equal(new, label):
            break
        label = new
    calls = []
    real = tlabels._round_fn

    def counting(*args):
        fn = real(*args)
        return lambda lab: calls.append(1) or fn(lab)

    monkeypatch.setattr(tlabels, "_round_fn", counting)
    got = tlabels.propagate("dense", adj, valid, 20)
    assert (got == 0).all()
    assert len(calls) == settle < 21


def mixed_batch(n=256, seed=5):
    """(adj (5, N, N), valid (5, N)) numpy: graphs that settle at different
    rounds in one batch. A path over every node, a random graph and a random
    graph of near edges (they settle at 4 to 11 rounds, so the small caps
    cut them short), a graph with no valid node and one with a single valid
    node among edges (both settle at once)."""
    rng = np.random.RandomState(seed)
    idx = np.arange(n)
    adj = np.zeros((5, n, n), bool)
    valid = np.ones((5, n), bool)
    adj[0] = np.abs(idx[:, None] - idx[None, :]) == 1
    for k in (1, 2, 3, 4):
        rand = rng.rand(n, n) < 0.01
        adj[k] = (rand | rand.T) & ~np.eye(n, dtype=bool)
    adj[2] &= np.abs(idx[:, None] - idx[None, :]) <= 64
    valid[1:3] = rng.rand(2, n) < 0.9
    adj[1:3] &= valid[1:3, :, None] & valid[1:3, None, :]
    valid[3] = False
    valid[4] = idx == n // 2
    return adj, valid


# the JAX label loops, jitted once per layout; the cap is traced
_JAX_CC = {
    "dense": jax.jit(lambda adj, valid, r: jgraph.connected_components(adj, valid, r)),
    "band": jax.jit(lambda band, valid, r: jgraph.connected_components_band(band, valid, r)),
    "sparse": jax.jit(lambda nbr, ok, valid, r: jgraph.connected_components_sparse(
        nbr, ok, valid, r)),
}


def layout_inputs(mode, adj, valid):
    """Per graph: the JAX arguments; for the batch: the port's (edges,
    valid, nbr_idx), all from the same numpy arrays (band half-width 128,
    neighbour lists of 4)."""
    per_graph, edges, nbrs = [], [], []
    for a, v in zip(adj, valid):
        if mode == "dense":
            per_graph.append((a, v))
            edges.append(a)
        elif mode == "band":
            band = band_of(a, 128)
            per_graph.append((band, v))
            edges.append(band)
        else:
            nbr, ok = neighbour_list_of(a, 4)
            per_graph.append((nbr, ok, v))
            edges.append(ok)
            nbrs.append(nbr)
    nbr_idx = torch.from_numpy(np.stack(nbrs)) if nbrs else None
    return per_graph, (torch.from_numpy(np.stack(edges)), torch.from_numpy(valid), nbr_idx)


@pytest.mark.parametrize("mode", ["dense", "band", "sparse"])
def test_batched_labels_equal_per_graph_jax(mode):
    """The port labels a batch whose graphs settle at different rounds as JAX
    labels each graph alone, at caps that cut the path short and at the
    usual cap: what lets each graph of a batch stop at its own first
    unchanged round (JAX vmaps AGC over the batch, and a labelling that a
    round leaves unchanged is a fixed point of the round)."""
    adj, valid = mixed_batch()
    per_graph, (edges, tvalid, nbr_idx) = layout_inputs(mode, adj, valid)
    for rounds in (0, 1, 2, 3, 20):
        got = tlabels.propagate(mode, edges, tvalid, rounds, nbr_idx)
        for b, args in enumerate(per_graph):
            want = _JAX_CC[mode](*(jnp.asarray(x) for x in args), jnp.int32(rounds))
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def jax_rounds_run(mode, args, rounds):
    """The rounds JAX's loop runs on one graph: 1 + the first cap c whose
    labels equal those of cap c - 1 (the body round that changed nothing),
    at most 1 + rounds."""
    last = np.asarray(_JAX_CC[mode](*(jnp.asarray(x) for x in args), jnp.int32(0)))
    for c in range(1, rounds + 1):
        now = np.asarray(_JAX_CC[mode](*(jnp.asarray(x) for x in args), jnp.int32(c)))
        if np.array_equal(now, last):
            return 1 + c
        last = now
    return 1 + rounds


@pytest.mark.parametrize("mode", ["dense", "band", "sparse"])
def test_rounds_plain_per_graph(mode):
    """rounds_plain on a batch gives each graph the rounds it runs alone: the
    count of rounds_plain on that graph by itself and of JAX's loop on it."""
    adj, valid = mixed_batch()
    per_graph, (edges, tvalid, nbr_idx) = layout_inputs(mode, adj, valid)
    for rounds in (0, 2, 20):
        got = tlabels.rounds_plain(mode, edges, tvalid, rounds, nbr_idx)
        assert got.dtype == torch.int32 and got.shape == (len(per_graph),)
        alone = [int(tlabels.rounds_plain(mode, edges[b:b + 1], tvalid[b:b + 1], rounds,
                                          None if nbr_idx is None else nbr_idx[b:b + 1])[0])
                 for b in range(len(per_graph))]
        want = [jax_rounds_run(mode, args, rounds) for args in per_graph]
        assert got.tolist() == alone == want
        if rounds == 20:
            assert len(set(want)) >= 3  # the batch settles at mixed rounds


# ---------------------------------------------------------------- other builds
# Integer and bool outputs (adj, kept, labels, inv) must be bit-equal. The
# threshold is one element of each side's own similarity matrix: XLA and
# PyTorch sum the row norms in different orders, so it may differ by one
# f32 ulp (1e-6); the matrix products themselves agree bit for bit.
THR_TOL = 1e-6
SIFT_LAST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "weights", "gims_tpu_sift_last.npz")


def layout_set(kind, seed, nb, n, d=16):
    """n keypoints padded to nb. "full": spread over a 4000 px wide strip,
    so every radius pair lies within 128 x-sorted positions; "slab": a 20 px
    wide vertical slab, so at nb = 384 many pairs fall outside the window."""
    rng = np.random.RandomState(seed)
    kpts = np.full((nb, 2), 1e6, np.float32)
    if kind == "full":
        kpts[:n] = np.stack([rng.rand(n) * 4000, rng.rand(n) * 200], axis=1)
    else:
        kpts[:n] = np.stack([rng.rand(n) * 20, rng.rand(n) * 600], axis=1)
    descs = np.zeros((nb, d), np.float32)
    descs[:n] = rng.randn(n, d)
    valid = np.arange(nb) < n
    return kpts, descs, valid


def both_builds(fn_name, kpts, descs, valid, **kw):
    jout = getattr(jgraph, fn_name)(jnp.asarray(kpts), jnp.asarray(descs), jnp.asarray(valid),
                                    **kw)
    tout = getattr(tgraph, fn_name)(torch.from_numpy(kpts), torch.from_numpy(descs),
                                    torch.from_numpy(valid), **kw)
    return jout, tout


def assert_same_graph(jout, tout, inv=False):
    for key in ("adj", "kept", "labels") + (("inv",) if inv else ()):
        np.testing.assert_array_equal(getattr(tout, key).numpy(), np.asarray(getattr(jout, key)),
                                      err_msg=key)
    np.testing.assert_allclose(float(tout.threshold), float(jout.threshold),
                               rtol=0, atol=THR_TOL)


@pytest.mark.parametrize("seed,nb,n", [(3, 256, 230), (4, 512, 470)])
def test_approx_threshold_matches_jax(seed, nb, n):
    """threshold_impl="approx", stride 4: the order statistic of every 4th
    row's valid upper triangle, ranked by the subsample's own count."""
    kpts, descs, valid = make_set(seed, nb, n)
    jout, tout = both_builds("build_graph", kpts, descs, valid, radius=15.0, percentile=2.0,
                             min_size=7, threshold_impl="approx", threshold_stride=4)
    assert_same_graph(jout, tout)
    exact = tgraph.build_graph(torch.from_numpy(kpts), torch.from_numpy(descs),
                               torch.from_numpy(valid), radius=15.0, percentile=2.0, min_size=7)
    assert float(exact.threshold) != float(tout.threshold)  # the subsample is another set


@pytest.mark.parametrize("buckets", [1024, 3])
def test_centroid_reconnect_matches_jax(buckets):
    """reconnect_impl="centroid" on far-apart clusters, where the reconnect
    adds links; 3 buckets make overflow components share the last one."""
    rng = np.random.RandomState(42)
    pts = [rng.rand(c, 2).astype(np.float32) * 30 + [x, y]
           for x, y, c in [(0, 0, 30), (500, 0, 25), (0, 500, 12),
                           (500, 500, 9), (250, 250, 8)]]
    n = sum(len(p) for p in pts)
    kpts = np.full((128, 2), 1e6, np.float32)
    kpts[:n] = np.concatenate(pts)
    descs = np.zeros((128, 8), np.float32)
    descs[:n] = rng.randn(n, 8)
    valid = np.arange(128) < n
    kw = dict(radius=40.0, percentile=5.0, min_size=6, reconnect_buckets=buckets)
    jout, tout = both_builds("build_graph", kpts, descs, valid, reconnect_impl="centroid", **kw)
    assert_same_graph(jout, tout)
    d2 = ((kpts[:, None] - kpts[None]) ** 2).sum(-1)
    assert (tout.adj.numpy() & (d2 > 40.0 ** 2)).any()  # links between clusters


@pytest.mark.parametrize("nb,n", [(128, 110), (384, 350)])
def test_band_helpers_match_jax(nb, n):
    """The band views, bit-equal to the JAX package's reshape constructions;
    at 128 rows _band_to_dense takes JAX's fallback branch, at 384 its fast
    (128-row block) branch."""
    rng = np.random.RandomState(nb)
    wh = 128
    band = rng.rand(nb, wh) < 0.05
    band &= (np.arange(nb)[:, None] + 1 + np.arange(wh)[None, :]) < nb
    tb = torch.from_numpy(band)[None]
    np.testing.assert_array_equal(tband._band_to_dense(tb)[0].numpy(),
                                  np.asarray(jgraph._band_to_dense(jnp.asarray(band))))
    np.testing.assert_array_equal(tband._band_shear_bwd(tb)[0].numpy(),
                                  np.asarray(jgraph._band_shear_bwd(jnp.asarray(band))))
    vec = rng.randint(0, n, nb).astype(np.int32)
    for fn in ("_window_values_fwd", "_window_values_bwd"):
        want = np.asarray(getattr(jgraph, fn)(jnp.asarray(vec), nb, 128, wh, n))
        got = getattr(tband, fn)(torch.from_numpy(vec)[None], wh, n)[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=fn)
    blocks = rng.randn(nb // 128, 128, 128 + wh).astype(np.float32)
    np.testing.assert_array_equal(tband._diag_band(torch.from_numpy(blocks)[None])[0].numpy(),
                                  np.asarray(jgraph._diag_band(jnp.asarray(blocks))))


@pytest.mark.parametrize("cc_impl,defer,reconnect", [("band", True, "centroid"),
                                                     ("dense", False, "exact")])
@pytest.mark.parametrize("kind", ["full", "slab"])
@pytest.mark.parametrize("nb,n", [(128, 110), (384, 350)])
def test_build_graph_band_matches_jax(nb, n, kind, cc_impl, defer, reconnect):
    """build_graph_band at band_halfwidth 128: adj, kept, labels (and inv
    with defer_unpermute) bit-equal to JAX's, with the window covering every
    radius pair ("full") and not ("slab", coverage below 1 at 384 rows)."""
    kpts, descs, valid = layout_set(kind, nb + n, nb, n)
    cov = tgraph.band_coverage(torch.from_numpy(kpts), torch.from_numpy(valid), 15.0, 128)
    assert cov["pairs_in_radius"] > 0
    assert (cov["coverage"] == 1.0) == (kind == "full" or nb == 128)
    jout, tout = both_builds("build_graph_band", kpts, descs, valid, radius=15.0,
                             percentile=5.0, min_size=5, band_halfwidth=128,
                             reconnect_impl=reconnect, cc_impl=cc_impl,
                             defer_unpermute=defer)
    assert tout.kept.any() and tout.adj.any()
    assert_same_graph(jout, tout, inv=defer)


def test_band_equals_dense_approx_at_full_coverage():
    """Where the window covers every radius pair, the band build equals the
    dense build with the same strided threshold and reconnect (as
    tests/test_agc.py holds them in JAX)."""
    kpts, descs, valid = layout_set("full", 8, 384, 350)
    kw = dict(radius=15.0, percentile=5.0, min_size=5, reconnect_impl="centroid",
              reconnect_buckets=1024)
    t = [torch.from_numpy(x) for x in (kpts, descs, valid)]
    band = tgraph.build_graph_band(*t, band_halfwidth=128, threshold_stride=4, **kw)
    dense = tgraph.build_graph(*t, threshold_impl="approx", threshold_stride=4, **kw)
    jdense = jgraph.build_graph(*(jnp.asarray(x) for x in (kpts, descs, valid)),
                                threshold_impl="approx", threshold_stride=4, **kw)
    assert float(band.threshold) == float(dense.threshold)
    for key in ("adj", "kept", "labels"):
        np.testing.assert_array_equal(getattr(band, key).numpy(), getattr(dense, key).numpy())
        np.testing.assert_array_equal(getattr(band, key).numpy(), np.asarray(getattr(jdense, key)))


@pytest.mark.parametrize("kind", ["full", "slab"])
def test_band_coverage_matches_jax(kind):
    kpts, descs, valid = layout_set(kind, 21, 384, 350)
    for hw in (128, 383):
        want = jgraph.band_coverage(jnp.asarray(kpts), jnp.asarray(valid), 15.0, hw)
        got = tgraph.band_coverage(torch.from_numpy(kpts), torch.from_numpy(valid), 15.0, hw)
        assert got == want


@pytest.mark.parametrize("case", ["star_overflow", "random"])
def test_sparse_cc_matches_jax(case):
    """cc_impl="sparse": a hub of 40 spokes with cc_degree 8 (the push
    carries the edges the hub's list dropped, tests/test_agc.py), and a
    random set at the eval knobs."""
    if case == "star_overflow":
        n = 41
        kpts = np.zeros((n, 2), np.float32)
        ang = np.linspace(0, 2 * np.pi, n - 1, endpoint=False)
        kpts[1:, 0] = 10 * np.cos(ang)
        kpts[1:, 1] = 10 * np.sin(ang)
        descs = np.ones((n, 4), np.float32)
        valid = np.ones(n, bool)
        kw = dict(radius=11.0, percentile=2.0, min_size=2, cc_degree=8)
    else:
        kpts, descs, valid = make_set(9, 256, 230)
        kw = dict(radius=15.0, percentile=2.0, min_size=7, cc_degree=16)
    jout, tout = both_builds("build_graph", kpts, descs, valid, cc_impl="sparse", **kw)
    assert_same_graph(jout, tout)
    if case == "star_overflow":
        assert (tout.labels == 0).all() and tout.kept.all()


def test_forward_match_band_compaction_matches_jax():
    """The staged checkpoint (18 layers, 256-d) on a 512-bucket request,
    band AGC with the approximate threshold and the centroid reconnect,
    compacted to 256: the adjacency stays in sorted space and inv folds
    into the compaction gather. kept and matches equal to JAX's, matching
    scores 1e-4."""
    from gims_tpu.core.bucketing import pad_keypoint_set
    from gims_tpu.config import MatcherConfig as JMatcherConfig
    from gims_tpu_torch.matcher.convert import load_gims_checkpoint, load_variables
    import jax

    variables = load_gims_checkpoint(SIFT_LAST)
    frame = (120, 160)
    req, _ = synthetic_request(7, 450, frame)
    sides = []
    for s in "01":
        kp, de, sc, va = pad_keypoint_set(req["keypoints" + s], req["descriptors" + s],
                                          req["scores" + s])
        sides.append((kp[None], de[None], va[None], sc[None]))
    (kp0, de0, va0, sc0), (kp1, de1, va1, sc1) = sides
    knobs = dict(radius=15.0, percentile=2.0, min_size=7, agc_impl="band",
                 threshold_impl="approx", reconnect_impl="centroid", reconnect_buckets=1024)
    jmcfg = JMatcherConfig(sinkhorn_iterations=20, match_threshold=0.02)
    want = jpipeline.forward_match(
        jax.tree_util.tree_map(jnp.asarray, variables), jmcfg, JAGCConfig(**knobs),
        *(jnp.asarray(x) for x in (kp0, de0, va0, kp1, de1, va1)),
        image_shape=frame, compact_to=256, scores0=jnp.asarray(sc0), scores1=jnp.asarray(sc1))
    want = {k: np.asarray(v) for k, v in want.items()}
    model = GMatcher(MatcherConfig(sinkhorn_iterations=20, match_threshold=0.02)).eval()
    load_variables(model, variables)
    got = tpipeline.forward_match(
        model, AGCConfig(**knobs), *(torch.from_numpy(x) for x in (kp0, de0, va0, kp1, de1, va1)),
        image_shape=frame, compact_to=256, scores0=torch.from_numpy(sc0),
        scores1=torch.from_numpy(sc1))
    assert int(want["kept0"].sum()) == 256  # overflow dropped some
    assert (want["matches0"] >= 0).sum() > 100
    for key in ("kept0", "kept1", "matches0", "matches1"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    for key in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-4, rtol=0)
