"""Keypoint-axis scale-out: ``forward_match`` split over a group of ranks.

Port of ``gims_tpu/matcher/sharded.py``. The matcher's sequence length is
the keypoint count N. In JAX every O(N^2) tensor of the pipeline (pairwise
distances, similarities, adjacency, attention scores, the coupling) is
split over a 1-D ``kp`` mesh axis by XLA's partitioner, so P chips hold 1/P
of each. PyTorch has no partitioner: the port runs one process per rank
over a ``torch.distributed`` group, and each stage makes its own
collectives (``train/multihost.py``):

  * AGC: ``agc/sharded.py``, chosen by ``pipeline.run_agc`` with a group
    (the dense build: the threshold's radix select, the isolated-node fix,
    the dense or sparse label rounds, the reconnect; the band build: the
    whole band on every rank, its threshold and adjacency rows split);
  * trunk compaction (``compact_to``): the kept set and its order are whole
    on every rank, so each computes the index; each rank's block of the
    compacted bucket's rows (which must divide by the group's size) is
    joined from the ranks that hold them by an all-reduce; the matches are
    scattered back to the bucket;
  * GraphSAGE: each rank aggregates its adjacency rows, the rows are
    all-gathered (``layers.SAGEConv``);
  * the 18-layer trunk: ring attention (``ring_attention.py``, K1's partial
    mode once per ring step), the configuration JAX's ``_shard_cfg`` sets;
  * Sinkhorn and extraction on the rank's rows of the coupling
    (``sinkhorn.log_optimal_transport_rows``, ``extract_matches_rows``):
    the plain Sinkhorn, as ``_shard_cfg`` turns the single-chip kernel off.

Activations (B, N, d) stay whole on every rank; only O(N^2) tensors are
split. Every rank passes the same whole padded inputs and returns the same
whole output dict, bit for bit.

    call = make_forward_match_sharded(model, acfg, group, (h, w))
    out = call(kpts0, desc0, valid0, kpts1, desc1, valid1)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.profiler import record_function

from gims_tpu_torch.agc.sharded import row_block
from gims_tpu_torch.config import AGCConfig, MatcherConfig
from gims_tpu_torch.matcher import pipeline, ring_attention, sinkhorn
from gims_tpu_torch.matcher.gmatcher import GMatcher, normalize_keypoints
from gims_tpu_torch.train import multihost


def shard_config(mcfg: MatcherConfig) -> MatcherConfig:
    """The sharded trunk configuration (JAX's ``_shard_cfg``): ring attention
    over the group, the plain Sinkhorn (the kernel is single-card)."""
    return dataclasses.replace(mcfg, attention_impl="ring", use_pallas_sinkhorn=False)


def shard_model(model: GMatcher) -> GMatcher:
    """`model` under ``shard_config``: a GMatcher that holds the same
    parameter and buffer tensors (built on the meta device, then assigned
    them), or `model` itself where its configuration is already that."""
    cfg = shard_config(model.config)
    if cfg == model.config:
        return model
    with torch.device("meta"):
        twin = GMatcher(cfg)
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin.train(model.training)


def _compact_side_rows(kpts, desc, adj_rows, kept, scores, nc: int, group):
    """``pipeline._compact_side`` over row blocks: the index (B, nc), the
    compacted keypoints, descriptors and kept mask, whole, and this rank's
    rows (B, nc/P, nc) of the compacted adjacency. The compacted rows that
    a rank needs lie on any rank: for each rank's block of compacted rows
    in turn, every rank gives the compacted columns of the rows it holds
    (no rows elsewhere) and an all-reduce (max) joins them, so a rank holds
    (B, nc/P, nc) of it at a time."""
    idx, kept_c = pipeline.compact_order(kept, scores, nc)
    r0, rows = row_block(kpts.shape[1], group)
    _, crows = row_block(nc, group)
    cols = torch.gather(adj_rows, 2, idx[:, None, :].expand(-1, rows, -1))   # (B, N/P, nc)
    adj_c = None
    for t in range(multihost.world_size(group)):
        local = idx[:, t * crows:(t + 1) * crows] - r0
        held = (local >= 0) & (local < rows)
        part = pipeline.gather_rows(cols, local.clamp(0, rows - 1)) & held[..., None]
        part = multihost.all_reduce(part, "max", group)
        if t == multihost.rank(group):
            adj_c = part
    return (idx, pipeline.gather_rows(kpts, idx), pipeline.gather_rows(desc, idx), adj_c,
            kept_c)


@torch.no_grad()
def forward_match_sharded(model: GMatcher, acfg: AGCConfig,
                          kpts0, desc0, valid0, kpts1, desc1, valid1,
                          image_shape, group, k0=None, k1=None, adj0=None, adj1=None,
                          radius=None, min_size=None, compact_to: Optional[int] = None,
                          scores0=None, scores1=None) -> dict:
    """``pipeline.forward_match`` with the keypoint axis split over `group`.

    Every rank passes the same whole padded tensors; N and M must be
    divisible by the group's size, and so must `compact_to` where it
    compacts the trunk (below the larger bucket; ``scores0``/``scores1``
    order the kept keypoints, as ``pipeline._compact_side``). A side given
    its adjacency (B, N, N) takes its rows and keeps every valid keypoint.
    Returns the whole padded dict (matches0/1, matching_scores0/1, kept0/1,
    mdesc0/1) on every rank."""
    p = multihost.world_size(group)
    nb0, nb1 = kpts0.shape[1], kpts1.shape[1]
    if nb0 % p or nb1 % p:
        raise ValueError(f"buckets ({nb0}, {nb1}) must divide the {p}-way mesh axis")
    compact = compact_to is not None and compact_to < max(nb0, nb1)
    if compact and int(compact_to) % p:
        nc = int(compact_to)
        raise ValueError(f"buckets ({nc}, {nc}) must divide the {p}-way mesh axis")
    sharded = shard_model(model)
    radius = acfg.radius if radius is None else radius
    min_size = acfg.min_size if min_size is None else min_size
    previous = ring_attention._RING["group"]
    ring_attention.set_ring_group(group)
    try:
        with record_function("gims.agc"):
            if adj0 is None and adj1 is None and kpts0.shape == kpts1.shape:
                # same bucket on both sides: one batched AGC over the stacked pair
                b = kpts0.shape[0]
                kk = None
                if k0 is not None and k1 is not None:
                    kk = torch.cat([torch.as_tensor(k, device=kpts0.device).reshape(-1)
                                    for k in (k0, k1)])
                adj, kept, _ = pipeline.run_agc(
                    torch.cat([kpts0, kpts1]), torch.cat([desc0, desc1]),
                    torch.cat([valid0, valid1]), acfg, kk, radius, min_size, group=group)
                adj0, adj1, kept0, kept1 = adj[:b], adj[b:], kept[:b], kept[b:]
            else:
                sides = []
                for kp, de, va, k, adj in ((kpts0, desc0, valid0, k0, adj0),
                                           (kpts1, desc1, valid1, k1, adj1)):
                    if adj is None:
                        sides.append(pipeline.run_agc(kp, de, va, acfg, k, radius, min_size,
                                                      group=group)[:2])
                    else:
                        r0, rows = row_block(adj.shape[1], group)
                        sides.append((adj[:, r0:r0 + rows], va))
                (adj0, kept0), (adj1, kept1) = sides

        if compact:
            with record_function("gims.compact"):
                idx0, kpts0, desc0, adj0, kept0 = _compact_side_rows(
                    kpts0, desc0, adj0, kept0, scores0, int(compact_to), group)
                idx1, kpts1, desc1, adj1, kept1 = _compact_side_rows(
                    kpts1, desc1, adj1, kept1, scores1, int(compact_to), group)

        h, w = image_shape
        mcfg = sharded.config
        out = sharded(normalize_keypoints(kpts0, h, w, mcfg.normalization), desc0, adj0, kept0,
                      normalize_keypoints(kpts1, h, w, mcfg.normalization), desc1, adj1, kept1,
                      group=group)
        with record_function("gims.extract"):
            r0, _ = row_block(kpts0.shape[1], group)
            ext = sinkhorn.extract_matches_rows(out["Z"], kept0, kept1, mcfg.match_threshold,
                                                r0, group)
            if compact:
                return pipeline._scatter_back(ext, idx0, idx1, kept0, kept1, nb0, nb1,
                                              out["mdesc0"], out["mdesc1"])
    finally:
        ring_attention.set_ring_group(previous)
    return {**ext, "kept0": kept0, "kept1": kept1,
            "mdesc0": out["mdesc0"], "mdesc1": out["mdesc1"]}


def make_forward_match_sharded(model: GMatcher, acfg: AGCConfig, group, image_shape):
    """A forward_match whose keypoint axis is split over `group` (a
    ``torch.distributed`` group; this process is one of its ranks). Returns
    ``call(kpts0, desc0, valid0, kpts1, desc1, valid1, k0=None, k1=None)``
    -> the padded prediction dict of ``pipeline.forward_match``, whole on
    every rank. Inputs go to the model's device; `k0`/`k1` default to
    ``pipeline.percentile_rank`` of each row's valid count (per item, as
    JAX's wrapper computes them). N and M must be divisible by the group's
    size."""
    sharded = shard_model(model)
    dev = next(model.parameters()).device

    def call(kpts0, desc0, valid0, kpts1, desc1, valid1, k0=None, k1=None):
        args = [torch.as_tensor(a).to(dev) for a in (kpts0, desc0, valid0, kpts1, desc1, valid1)]
        if k0 is None:
            k0 = pipeline.percentile_rank(args[2].sum(dim=1), acfg.percentile)
        if k1 is None:
            k1 = pipeline.percentile_rank(args[5].sum(dim=1), acfg.percentile)
        # bound again at each call, as JAX re-binds its ring mesh: another
        # sharded matcher may have named another group since
        ring_attention.set_ring_group(group)
        return forward_match_sharded(sharded, acfg, *args, image_shape, group, k0=k0, k1=k1)

    call.group = group
    call.model = sharded
    return call


def sharded_memory_analysis(model: GMatcher, acfg: AGCConfig, group, image_shape, nb: int,
                            seed: int = 0) -> Optional[dict]:
    """One sharded call on a batch of one random pair at bucket `nb` (every
    keypoint valid, inside the image; descriptors from a normal law, both
    from `seed`), and this rank's device memory for it:
    ``torch.cuda.max_memory_allocated`` during the call (``peak_bytes``),
    less what was allocated before it (``temp_bytes``), and the inputs'
    bytes (``argument_bytes``). None on the CPU, which keeps no such count
    (as JAX returns None where the backend has no memory analysis)."""
    dev = next(model.parameters()).device
    if dev.type != "cuda":
        return None
    g = torch.Generator(device="cpu").manual_seed(seed)
    h, w = image_shape
    scale = torch.tensor([w, h], dtype=torch.float32)
    d = model.config.input_dim
    args = []
    for _ in range(2):
        args += [torch.rand((1, nb, 2), generator=g) * scale,
                 torch.randn((1, nb, d), generator=g), torch.ones((1, nb), dtype=torch.bool)]
    args = [a.to(dev) for a in args]
    call = make_forward_match_sharded(model, acfg, group, image_shape)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    call(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return {"peak_bytes": int(peak), "temp_bytes": int(peak - base),
            "argument_bytes": int(sum(a.numel() * a.element_size() for a in args))}
