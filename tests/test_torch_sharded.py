"""Keypoint-axis sharding of the PyTorch port (``matcher/sharded.py``,
``agc/sharded.py``) against the unsharded port and the JAX package, on the
CPU.

Ranks are processes started with the spawn method, joined over gloo by a
file rendezvous; one spawn for each of P = 2 and P = 4 runs every case
(``gims_tpu_torch/train/shard_check.py``, so no child imports JAX). The
inputs are tests/test_sharded.py's pairs at bucket 256 (side 0 200 valid
keypoints, side 1 180, true correspondences through shared nonnegative
descriptor halves), a 4-layer 64-d matcher from JAX's identity warm start
(tests/test_sharded.py's), and the same with every parameter moved by
0.02 N(0, 1), so that the trunk's ring attention moves the descriptors; 10
Sinkhorn iterations. Tolerances:

- (a) the sharded dense AGC (exact and approximate threshold, exact and
  centroid reconnect, a path graph cut by its round cap) against the
  unsharded ``build_graph``: threshold, labels, kept and adjacency equal.
  Measured on this CPU: each rank's similarity rows equal the rows of the
  whole product, so no pair sits at a threshold by rounding alone;
- (b) the row-block Sinkhorn and extraction against ``log_optimal_transport``
  and ``extract_matches``: Z within 1e-5 on the valid rows and columns and
  the dustbins, matches equal, matching scores within 1e-5 (exp of Z);
- (c) the whole sharded ``forward_match`` against JAX's
  ``make_forward_match_sharded`` on a 2-device mesh (the identity start)
  and against the unsharded port (both starts), JAX's own bars
  (tests/test_sharded.py): kept equal, matches0 agreement > 0.995,
  matching_scores0 within 2e-3; every rank bit-equal. (With the moved
  parameters JAX's sharded program itself flips two pairs of matches
  against JAX's unsharded one at couplings 4e-6 apart, below its own bar;
  the port's sharded and unsharded runs agree there);
- (d) the counterpart of ``test_sharded_memory_scales``: the largest tensor
  any op makes on a rank at P = 2 (and 4) holds under 0.6x the elements of the
  unsharded run's largest (measured: a ring step's (2B H, N/2, M/2) scores
  against the (2B H, N, M) scores of the direct attention, 0.25x);
- (e) the raises: buckets not divisible by P (JAX's ValueError text),
  ``cc_impl="sparse"``, ``agc_impl="band"``, ``compact_to``, and the ring
  without a group.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from gims_tpu.api import init_gmatcher_variables as jinit
from gims_tpu.config import AGCConfig as JAGCConfig
from gims_tpu.config import MatcherConfig as JMatcherConfig
from gims_tpu.matcher.sharded import make_forward_match_sharded as jsharded
from gims_tpu_torch.agc import graph as tgraph
from gims_tpu_torch.config import AGCConfig, MatcherConfig
from gims_tpu_torch.matcher import attention, pipeline, ring_attention, sinkhorn
from gims_tpu_torch.matcher.convert import load_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.matcher.sharded import sharded_memory_analysis
from gims_tpu_torch.train import dp_check, shard_check
from gims_tpu_torch.train import multihost as tmh
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

NB = 256
SHAPE = (240, 320)
MATCHER = dict(descriptor_dim=64, input_dim=64, keypoint_encoder=(32, 64), num_gnn_layers=4,
               sinkhorn_iterations=10, match_threshold=0.02)
AGC = dict(radius=60.0, percentile=5.0, min_size=3)
AGC_CASES = [dict(threshold_impl=t, reconnect_impl=r)
             for t in ("exact", "approx") for r in ("exact", "centroid")]
PATH_ROUNDS = 1
BLOCKED = {"jax", "jaxlib", "flax", "gims_tpu", "cv2"}


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_pair(rng, nb=NB, nv=200, base=None):
    """tests/test_sharded.py's _pair at 64-d descriptors."""
    kp = np.full((1, nb, 2), 1e6, np.float32)
    kp[:, :nv] = rng.rand(1, nv, 2).astype(np.float32) * [320, 240]
    half = np.abs(rng.randn(1, nb, 32)).astype(np.float32)
    if base is not None:
        half[:, :nv] = base[:, :nv]
    de = np.concatenate([half, half], axis=-1)
    va = np.zeros((1, nb), bool)
    va[:, :nv] = True
    return kp, de, va, half


def pair_inputs():
    rng = np.random.RandomState(0)
    kp0, de0, va0, half = make_pair(rng)
    kp1, de1, va1, _ = make_pair(rng, nv=180, base=half)
    return kp0, de0, va0, kp1, de1, va1


def variables():
    """JAX's identity warm start (tests/test_sharded.py's), and the same with
    every parameter moved by 0.02 N(0, 1), so that the trunk's attention
    moves the descriptors."""
    v = as_np(jinit(JMatcherConfig(**MATCHER), seed=0, scheme="identity"))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: (x + 0.02 * rng.randn(*x.shape)).astype(x.dtype), v["params"])
    return v, {**v, "params": params}


def path_inputs():
    """A path of 200 keypoints 10 px apart (radius 15: each links to its
    neighbours), equal descriptors: one component whose labels need ~25
    rounds, cut at 1 + PATH_ROUNDS."""
    kp = np.full((1, NB, 2), 1e6, np.float32)
    kp[0, :200, 0] = np.arange(200) * 10.0
    kp[0, :200, 1] = 50.0
    de = np.ones((1, NB, 16), np.float32)
    va = np.zeros((1, NB), bool)
    va[0, :200] = True
    return [torch.from_numpy(x) for x in (kp, de, va)]


def sinkhorn_inputs():
    rng = np.random.RandomState(3)
    scores = torch.from_numpy(2.0 * rng.randn(2, NB, 200).astype(np.float32))
    row_mask = torch.from_numpy(rng.rand(2, NB) < 0.8)
    col_mask = torch.from_numpy(rng.rand(2, 200) < 0.7)
    return scores, row_mask, col_mask


def port_model(v):
    model = GMatcher(MatcherConfig(**MATCHER))
    load_variables(model, v)
    return model.eval()


@pytest.fixture(scope="module")
def inputs():
    identity, moved = variables()
    return {"pair": [torch.from_numpy(x) for x in pair_inputs()], "variables": identity,
            "moved": moved}


def rank_jobs(inputs):
    kp0, de0, va0, kp1, de1, va1 = inputs["pair"]
    stacked = [torch.cat([kp0, kp1]), torch.cat([de0, de1]), torch.cat([va0, va1])]
    jobs = [{"kind": "agc", "inputs": stacked, "kwargs": {**AGC, **case}} for case in AGC_CASES]
    jobs.append({"kind": "agc", "inputs": path_inputs(),
                 "kwargs": dict(radius=15.0, percentile=5.0, min_size=3, cc_rounds=PATH_ROUNDS)})
    scores, row_mask, col_mask = sinkhorn_inputs()
    jobs.append({"kind": "sinkhorn", "scores": scores, "masks": [row_mask, col_mask],
                 "alpha": 1.0, "iters": 10, "threshold": 0.02})
    match = {"kind": "match", "mcfg": MatcherConfig(**MATCHER), "variables": inputs["variables"],
             "acfg": AGCConfig(**AGC), "inputs": inputs["pair"], "image_shape": SHAPE}
    jobs += [match, {**match, "kind": "axis"}, {**match, "variables": inputs["moved"]},
             {**match, "kind": "axis", "kwargs": {"adj0": delaunay_adj0(inputs)}},
             {**match, "largest": True}]
    return jobs


def delaunay_adj0(inputs):
    """Side 0's Delaunay adjacency (D-GIMS): the side skips AGC."""
    kp0, _, va0 = inputs["pair"][:3]
    adj = tgraph.delaunay_adjacency_host(kp0[0].numpy(), va0[0].numpy())
    return torch.from_numpy(adj)[None]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, inputs, tmp_path_factory):
    p = request.param
    results = dp_check.run(shard_check.shard_rank, ["cpu"] * p, "gloo",
                           {"jobs": rank_jobs(inputs)},
                           str(tmp_path_factory.mktemp(f"shard{p}")))
    return p, [r["jobs"] for r in results], [r["modules"] for r in results]


@pytest.fixture(scope="module")
def unsharded(inputs):
    out = {name: pipeline.forward_match(port_model(inputs[name]), AGCConfig(**AGC),
                                        *inputs["pair"], SHAPE)
           for name in ("variables", "moved")}
    out["delaunay"] = pipeline.forward_match(port_model(inputs["variables"]), AGCConfig(**AGC),
                                             *inputs["pair"], SHAPE, adj0=delaunay_adj0(inputs))
    return out


@pytest.fixture(scope="module")
def jax_sharded(inputs):
    mesh = Mesh(np.array(jax.devices()[:2]), ("kp",))
    call = jsharded(JMatcherConfig(**MATCHER), JAGCConfig(**AGC), mesh, SHAPE)
    out = call(inputs["variables"], *(jnp.asarray(x.numpy()) for x in inputs["pair"]))
    return as_np(out)


def test_children_import_no_jax(ranks):
    for modules in ranks[2]:
        assert not BLOCKED & set(modules), modules


@pytest.mark.parametrize("case", range(len(AGC_CASES) + 1))
def test_sharded_agc_equals_unsharded(ranks, inputs, case):
    p, jobs, _ = ranks
    if case < len(AGC_CASES):
        kp0, de0, va0, kp1, de1, va1 = inputs["pair"]
        args = (torch.cat([kp0, kp1]), torch.cat([de0, de1]), torch.cat([va0, va1]))
        kwargs = {**AGC, **AGC_CASES[case]}
    else:
        args, kwargs = path_inputs(), dict(radius=15.0, percentile=5.0, min_size=3,
                                           cc_rounds=PATH_ROUNDS)
    want = tgraph.build_graph(*args, **kwargs)
    got = [r[case] for r in jobs]
    assert torch.equal(torch.cat([g["adj"] for g in got], dim=1), want.adj)
    for g in got:
        for key in ("kept", "labels", "threshold"):
            assert torch.equal(g[key], getattr(want, key)), key
    assert want.adj.sum() > 0 and want.kept.any()
    if case == len(AGC_CASES):
        # the cap cut the path's labels: more than one label on one path
        assert len(set(want.labels[0, :200].tolist())) > 1


def test_sharded_sinkhorn_equals_unsharded(ranks):
    p, jobs, _ = ranks
    got = [r[len(AGC_CASES) + 1] for r in jobs]
    scores, row_mask, col_mask = sinkhorn_inputs()
    Z = sinkhorn.log_optimal_transport(scores, 1.0, 10, row_mask, col_mask)
    want = sinkhorn.extract_matches(Z, row_mask, col_mask, 0.02)
    z_sharded = torch.cat([g["Z"][:, :-1] for g in got] + [got[0]["Z"][:, -1:]], dim=1)
    for g in got:
        assert torch.equal(g["Z"][:, -1], got[0]["Z"][:, -1])
    for b in range(2):
        rows = torch.cat([torch.nonzero(row_mask[b])[:, 0], torch.tensor([NB])])
        cols = torch.cat([torch.nonzero(col_mask[b])[:, 0], torch.tensor([200])])
        err = (z_sharded[b][rows][:, cols] - Z[b][rows][:, cols]).abs().max().item()
        assert err <= 1e-5, err
    for g in got:
        for key in ("matches0", "matches1"):
            assert torch.equal(g[key], want[key]), key
        for key in ("matching_scores0", "matching_scores1"):
            assert (g[key] - want[key]).abs().max() <= 1e-5, key
            assert torch.equal(g[key], got[0][key]), key
    assert (want["matches0"] >= 0).sum() > 0


def check_match(out, want, name):
    for key in ("kept0", "kept1"):
        assert np.array_equal(np.asarray(out[key]), np.asarray(want[key])), (name, key)
    m_same = np.mean(np.asarray(out["matches0"]) == np.asarray(want["matches0"]))
    assert m_same > 0.995, (name, m_same)
    np.testing.assert_allclose(np.asarray(out["matching_scores0"]),
                               np.asarray(want["matching_scores0"]), atol=2e-3, err_msg=name)


KINDS = ["match", "axis", "moved", "delaunay"]


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_forward_match_matches_jax_and_unsharded(ranks, unsharded, jax_sharded, kind):
    """JAX's identity warm start against JAX's sharded program and the
    unsharded port, through make_forward_match_sharded ("match") and
    forward_match(shard_axis="kp") ("axis"); the moved parameters, and a
    Delaunay side 0 (its adjacency given, sliced by rows), against the
    unsharded port."""
    p, jobs, _ = ranks
    got = [r[len(AGC_CASES) + 2 + KINDS.index(kind)] for r in jobs]
    for g in got:
        for key, value in got[0]["out"].items():
            assert torch.equal(g["out"][key], value), key
        assert g["partial_launches"] == 0  # the plain partials on the CPU
    out = {k: v.numpy() for k, v in got[0]["out"].items()}
    want = unsharded[kind if kind in ("moved", "delaunay") else "variables"]
    if kind in ("match", "axis"):
        check_match(out, jax_sharded, "jax sharded")
    check_match(out, {k: v.numpy() for k, v in want.items()}, "port unsharded")
    assert (out["matches0"] >= 0).sum() > 50
    np.testing.assert_allclose(out["mdesc0"], want["mdesc0"].numpy(), atol=1e-4)


def test_sharded_largest_tensor_scales(ranks, inputs):
    p, jobs, _ = ranks
    largest = shard_check.LargestTensor()
    with largest:
        pipeline.forward_match(port_model(inputs["variables"]), AGCConfig(**AGC),
                               *inputs["pair"], SHAPE)
    for r in jobs:
        assert r[-1]["largest_numel"] < 0.6 * largest.numel, (r[-1]["largest_shape"],
                                                              largest.shape)


def test_sharded_raises(monkeypatch, inputs):
    model = port_model(inputs["variables"])
    kp, de, va = (x[:, :100] for x in inputs["pair"][:3])
    odd = [x[:, :101] for x in inputs["pair"][:3]] * 2
    mesh = Mesh(np.array(jax.devices()[:2]), ("kp",))
    with pytest.raises(ValueError) as jerr:
        jsharded(JMatcherConfig(**MATCHER), JAGCConfig(**AGC), mesh, SHAPE)(
            inputs["variables"], *(jnp.asarray(x.numpy()) for x in odd))
    monkeypatch.setattr(tmh, "world_size", lambda group=None: 2)
    with pytest.raises(ValueError) as err:
        pipeline.forward_match(model, AGCConfig(**AGC), *odd, SHAPE, shard_axis=object())
    assert str(err.value) == str(jerr.value)
    for acfg in (AGCConfig(**AGC, cc_impl="sparse"), AGCConfig(**AGC, agc_impl="band")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pipeline.forward_match(model, acfg, kp, de, va, kp, de, va, SHAPE,
                                   shard_axis=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipeline.forward_match(model, AGCConfig(**AGC), kp, de, va, kp, de, va, SHAPE,
                               shard_axis=object(), compact_to=64)
    monkeypatch.undo()
    ring_attention.set_ring_group(None)
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="set_ring_group"):
        attention.masked_attention(q, q, q, torch.ones(1, 8, dtype=torch.bool), impl="ring")
    with pytest.raises(ValueError, match="set_ring_group"):
        pipeline.forward_match(model, AGCConfig(**AGC), kp, de, va, kp, de, va, SHAPE,
                               shard_axis="kp")


def test_sharded_memory_analysis_is_none_on_the_cpu(inputs):
    """As JAX's returns None where the backend has no memory analysis: the
    CPU keeps no peak count (the card's is ``max_memory_allocated``,
    tests/test_torch_cuda.py)."""
    assert sharded_memory_analysis(port_model(inputs["variables"]), AGCConfig(**AGC), None,
                                   SHAPE, NB) is None
