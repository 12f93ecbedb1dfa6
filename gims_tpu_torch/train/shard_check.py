"""Keypoint-sharded matching run as spawned ranks, one process per rank.

The tests (on the CPU, over gloo) and ``chip_smoke.py`` (ranks sharing the
card over gloo) hold the sharded ``forward_match`` and its stages
(``matcher/sharded.py``, ``agc/sharded.py``) to the unsharded port through
these workers. They live in the port's package, so a child process imports
the port and torch only.

    results = dp_check.run(shard_rank, ["cpu", "cpu"], "gloo", {"jobs": [job]}, directory)

Each job is a dict; its "kind" names what the rank runs:

  * "agc": ``build_graph_sharded`` on ``job["inputs"]`` (kpts, descs,
    valid, whole) with ``job["kwargs"]`` (``build_graph_band_sharded`` where
    they hold ``agc_impl="band"``): this rank's adjacency rows, kept,
    labels and threshold; with ``job["acfg"]`` (an ``AGCConfig``) instead,
    ``pipeline.run_agc`` over the group: its adjacency rows and kept;
  * "sinkhorn": ``log_optimal_transport_rows`` and ``extract_matches_rows``
    on this rank's rows of ``job["scores"]`` (whole) with ``job["masks"]``,
    ``job["alpha"]``, ``job["iters"]``, ``job["threshold"]``;
  * "match": ``make_forward_match_sharded`` on a GMatcher of ``job["mcfg"]``
    holding ``job["variables"]``, with ``job["acfg"]`` on ``job["inputs"]``
    (kpts0, desc0, valid0, kpts1, desc1, valid1): the output dict, K1's
    partial-mode launches of the call, its ms (host clock around a synced
    call; with ``job["reps"]``, the mean of that many more calls), the
    card's peak memory in the call (``peak_bytes``) and the part of it
    above what was allocated before the call (``temp_bytes``); with ``job["largest"]`` the most
    elements of any tensor an op made in it (``LargestTensor``);
  * "axis": ``pipeline.forward_match(shard_axis="kp")`` after
    ``set_ring_group``, on the same fields as "match" and the tensors of
    ``job.get("kwargs")`` (a Delaunay side's ``adj0``, say);
  * "compact": ``matcher.sharded._compact_side_rows`` on ``job["inputs"]``
    (kpts, desc, adjacency, kept, scores, whole; the rank passes its rows
    of the adjacency) at bucket ``job["nc"]``: the index, this rank's rows
    of the compacted adjacency and the compacted kept mask.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from gims_tpu_torch.agc.sharded import build_graph_band_sharded, build_graph_sharded, row_block
from gims_tpu_torch.matcher import cuda_attention, pipeline, ring_attention, sinkhorn
from gims_tpu_torch.matcher.convert import load_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.matcher.sharded import _compact_side_rows, make_forward_match_sharded
from gims_tpu_torch.train import dp_check


class LargestTensor(TorchDispatchMode):
    """Within the block, the most elements (``numel``) and the shape of any
    tensor an operator returned; broadcast views (a zero stride) hold no
    elements of their own and are not counted."""

    def __init__(self):
        super().__init__()
        self.numel, self.shape = 0, None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.numel() > self.numel
                    and all(st or sz == 1 for st, sz in zip(t.stride(), t.shape))):
                self.numel, self.shape = t.numel(), tuple(t.shape)
        return out


def _cpu(tree):
    return {k: v.cpu() for k, v in tree.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def agc_job(job, device, group):
    kpts, descs, valid = (x.to(device) for x in job["inputs"])
    if "acfg" in job:
        adj, kept, _ = pipeline.run_agc(kpts, descs, valid, job["acfg"], group=group)
        return {"adj": adj.cpu(), "kept": kept.cpu()}
    kwargs = dict(job["kwargs"])
    build = build_graph_band_sharded if kwargs.pop("agc_impl", "dense") == "band" \
        else build_graph_sharded
    g = build(kpts, descs, valid, group=group, **kwargs)
    return {"adj": g.adj.cpu(), "kept": g.kept.cpu(), "labels": g.labels.cpu(),
            "threshold": g.threshold.cpu()}


def sinkhorn_job(job, device, group):
    scores = job["scores"].to(device)
    row_mask, col_mask = (m.to(device) for m in job["masks"])
    r0, rows = row_block(scores.shape[1], group)
    Z = sinkhorn.log_optimal_transport_rows(scores[:, r0:r0 + rows], job["alpha"], job["iters"],
                                            row_mask, col_mask, r0, group)
    ext = sinkhorn.extract_matches_rows(Z, row_mask, col_mask, job["threshold"], r0, group)
    return {"Z": Z.cpu(), **_cpu(ext)}


def build_matcher(job, device) -> GMatcher:
    model = GMatcher(job["mcfg"])
    load_variables(model, job["variables"])
    return model.to(device).eval()


def match_job(job, device, group):
    model = build_matcher(job, device)
    inputs = [x.to(device) for x in job["inputs"]]
    if job["kind"] == "axis":
        ring_attention.set_ring_group(group)
        extra = {k: v.to(device) if torch.is_tensor(v) else v
                 for k, v in job.get("kwargs", {}).items()}

        def call():
            return pipeline.forward_match(model, job["acfg"], *inputs, job["image_shape"],
                                          shard_axis="kp", **extra)
    else:
        sharded = make_forward_match_sharded(model, job["acfg"], group, job["image_shape"])

        def call():
            return sharded(*inputs)
    base = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    before = cuda_attention.partial_launches
    largest = LargestTensor() if job.get("largest") else None
    _sync(device)
    t = time.perf_counter()
    with largest or contextlib.nullcontext():
        out = call()
    _sync(device)
    res = {"out": _cpu(out), "ms": 1e3 * (time.perf_counter() - t),
           "partial_launches": cuda_attention.partial_launches - before,
           "peak_bytes": None, "temp_bytes": None}
    if device.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        res["temp_bytes"] = res["peak_bytes"] - base
    if largest is not None:
        res["largest_numel"], res["largest_shape"] = largest.numel, largest.shape
    if job.get("reps"):
        t = time.perf_counter()
        for _ in range(job["reps"]):
            call()
        _sync(device)
        res["ms_per_call"] = 1e3 * (time.perf_counter() - t) / job["reps"]
    return res


def compact_job(job, device, group):
    kpts, desc, adj, kept, scores = (x.to(device) for x in job["inputs"])
    r0, rows = row_block(adj.shape[1], group)
    idx, _, _, adj_c, kept_c = _compact_side_rows(kpts, desc, adj[:, r0:r0 + rows], kept, scores,
                                                  job["nc"], group)
    return {"idx": idx.cpu(), "adj": adj_c.cpu(), "kept": kept_c.cpu()}


JOBS = {"agc": agc_job, "sinkhorn": sinkhorn_job, "match": match_job, "axis": match_job,
        "compact": compact_job}


def run_job(job, device, group):
    """One job on `device` as a rank of `group` (see the module's docstring)."""
    return JOBS[job["kind"]](job, device, group)


def _jobs(spec, device, group):
    return {"jobs": [run_job(job, device, group) for job in spec["jobs"]]}


def shard_rank(rank, world, init_method, backend, devices, directory):
    """A rank of the keypoint-sharded jobs in the spec (``spec["jobs"]``)."""
    dp_check._rank_main(_jobs, rank, world, init_method, backend, devices, directory)
