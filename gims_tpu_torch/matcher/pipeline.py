"""Matcher pipeline: AGC -> GMatcher -> optimal transport -> matches.

Port of ``gims_tpu/matcher/pipeline.py`` (reference: models/gmatcher.py:
219-386): inference (``forward_match``) with the trunk compaction of the
fused path (``compact_to``), the band build's deferred un-permutation and
precomputed adjacency (D-GIMS: a side given its adjacency skips AGC and
keeps every valid keypoint); and the training loss (``training_forward``,
``remap_gt_to_dustbin``). With ``shard_axis`` the keypoint axis is split
over a group of ranks (``matcher/sharded.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from gims_tpu_torch.agc.graph import build_graph, build_graph_band, check_impls
from gims_tpu_torch.config import AGCConfig
from gims_tpu_torch.core.segsum import segment_sum_rows
from gims_tpu_torch.matcher import sinkhorn
from gims_tpu_torch.matcher.gmatcher import GMatcher, normalize_keypoints
from gims_tpu_torch.matcher.layers import batch_stat_updates


def run_agc(kpts, descs, valid, acfg: AGCConfig, k=None,
            radius=None, min_size=None, defer_unpermute=False, group=None):
    """Batched AGC. kpts (B,N,2), descs (B,N,D), valid (B,N); `k` the
    optional per-item exact percentile rank (B,), which the band build and
    the approximate threshold do not use. Returns (adj, kept, inv): inv is
    None except in band defer_unpermute mode, where adj stays in sorted-x
    space and adj_caller[b, i, j] == adj[b, inv[b, i], inv[b, j]].

    `group`: a ``torch.distributed`` group over which the keypoint axis is
    split (``agc/sharded.py``); adj is then this rank's caller-order rows
    (B, N/P, N), and defer_unpermute is not taken (an unsharded path)."""
    check_impls(agc_impl=acfg.agc_impl, threshold_impl=acfg.threshold_impl,
                cc_impl=acfg.cc_impl, reconnect_impl=acfg.reconnect_impl)
    radius = acfg.radius if radius is None else radius
    min_size = acfg.min_size if min_size is None else min_size
    common = dict(radius=radius, percentile=acfg.percentile, min_size=min_size,
                  cc_rounds=acfg.cc_rounds, threshold_stride=acfg.threshold_stride,
                  reconnect_impl=acfg.reconnect_impl, reconnect_buckets=acfg.reconnect_buckets)
    dense = dict(k=k, threshold_impl=acfg.threshold_impl, cc_impl=acfg.cc_impl,
                 cc_degree=acfg.cc_degree)
    if group is not None:
        from gims_tpu_torch.agc.sharded import build_graph_band_sharded, build_graph_sharded

        if acfg.agc_impl == "band":
            out = build_graph_band_sharded(kpts, descs, valid, group=group,
                                           band_halfwidth=acfg.band_halfwidth, **common)
        else:
            out = build_graph_sharded(kpts, descs, valid, group=group, **dense, **common)
        return out.adj, out.kept, None
    if acfg.agc_impl == "band":
        out = build_graph_band(
            kpts, descs, valid, band_halfwidth=acfg.band_halfwidth,
            defer_unpermute=defer_unpermute,
            cc_impl="band" if acfg.cc_impl == "band" else "dense", **common)
        return out.adj, out.kept, out.inv
    out = build_graph(kpts, descs, valid, **dense, **common)
    return out.adj, out.kept, None


def percentile_rank(num_valid: torch.Tensor, percentile: float) -> torch.Tensor:
    """Exact rank of the AGC percentile threshold for (B,) valid counts, on
    their device: int(count * percentile / 100) in float64, clipped below
    the count, 0 for an empty pair set (reference: models/agc.py:378-379).
    Returns (B,) int64."""
    nv = num_valid.long()
    count = nv * (nv - 1) // 2
    k = (count.double() * percentile / 100).long()
    k = torch.where(k >= count, count - 1, k)
    return torch.where(count <= 0, 0, k)


def _compact_side(kpts, desc, adj, kept, scores, nc: int, inv=None):
    """Gather the kept keypoints of one side into a static (B, nc) bucket.

    AGC keeps about half the detection budget at the eval knobs, so the
    trunk and the transport, whose cost is quadratic in the bucket, run on
    a bucket sized for the kept set. Order: kept keypoints first, by
    detection score descending, ties by index (a stable sort); overflow
    beyond nc drops the lowest-score kept keypoints. Returns
    (idx (B, nc), kpts_c, desc_c, adj_c, kept_c).

    inv (band defer_unpermute): adj is in sorted-x space with
    adj_caller[i, j] == adj[inv[i], inv[j]]; composing inv into the gather
    gives the same adj_c without the caller-order (N, N) matrix."""
    idx, kept_c = compact_order(kept, scores, nc)
    ci = idx if inv is None else torch.gather(inv, 1, idx)
    adj_rows = gather_rows(adj, ci)
    adj_c = torch.gather(adj_rows, 2, ci[:, None, :].expand(-1, ci.shape[1], -1))
    return idx, gather_rows(kpts, idx), gather_rows(desc, idx), adj_c, kept_c


def compact_order(kept, scores, nc: int):
    """The compacted bucket of ``_compact_side``: its index (B, nc), kept
    keypoints first by score descending, ties by index (a stable sort), and
    its kept mask."""
    sc = torch.zeros(kept.shape, dtype=torch.float32, device=kept.device) \
        if scores is None else scores
    key = torch.where(kept, sc, float("-inf"))
    idx = torch.argsort(-key, dim=1, stable=True)[:, :nc]          # (B, nc)
    ar = torch.arange(idx.shape[1], device=kept.device)[None, :]
    return idx, torch.gather(kept, 1, idx) & (ar < kept.sum(dim=1, keepdim=True))


def gather_rows(x, idx):
    """x (B, N, ...) at rows idx (B, K)."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


def _scatter_back(ext, idx0, idx1, kept0_c, kept1_c, nb0: int, nb1: int,
                  mdesc0, mdesc1):
    """Scatter the compacted trunk's outputs back to the padded index space."""
    b = idx0.shape[0]
    dev = idx0.device

    def scatter(idx_self, nb, src, fill):
        shape = (b, nb) + tuple(src.shape[2:])
        out = torch.full(shape, fill, dtype=src.dtype, device=dev)
        index = idx_self.reshape(idx_self.shape + (1,) * (src.dim() - 2)).expand_as(src)
        return out.scatter_(1, index, src)

    out = {}
    for s, idx_self, idx_other, kept_c, nb, md in (
            ("0", idx0, idx1, kept0_c, nb0, mdesc0),
            ("1", idx1, idx0, kept1_c, nb1, mdesc1)):
        m = ext["matches" + s]
        orig = torch.where(m >= 0, torch.gather(idx_other, 1, m.clamp(min=0).long()), -1)
        out["matches" + s] = scatter(idx_self, nb, orig.int(), -1)
        out["matching_scores" + s] = scatter(
            idx_self, nb, ext["matching_scores" + s].float(), 0.0)
        out["kept" + s] = scatter(idx_self, nb, kept_c, False)
        out["mdesc" + s] = scatter(idx_self, nb, md, 0.0)
    return out


@torch.no_grad()
def forward_match(
    model: GMatcher,
    acfg: AGCConfig,
    kpts0, desc0, valid0,
    kpts1, desc1, valid1,
    image_shape,
    k0=None, k1=None,
    adj0=None, adj1=None,
    radius=None, min_size=None,
    compact_to: Optional[int] = None,
    shard_axis=None,
    scores0=None, scores1=None,
):
    """Inference for a batch of pairs, all arrays padded to buckets.

    `model` is a GMatcher holding its weights and MatcherConfig. Returns
    padded matches0/1, matching_scores0/1, kept0/1, mdesc0/1 (host code
    compacts them to the reference's dict contract, see api.py). With
    `compact_to` below the bucket, the trunk and the transport run on the
    AGC-kept keypoints of each side only, ordered by `scores0`/`scores1`
    (``_compact_side``), and the outputs are scattered back. A side given
    its adjacency `adj0`/`adj1` (B, N, N) bool skips AGC; its kept mask is
    its valid mask.

    `shard_axis`: a ``torch.distributed`` group over which this process and
    its peers split the keypoint axis (``matcher/sharded.py``; every rank
    passes the same inputs and gets the same whole dict), or a name (JAX's
    axis name, "kp"), which takes the group of
    ``ring_attention.set_ring_group`` (ValueError if none is set). The trunk
    then runs as JAX's ``_shard_cfg`` has it: ring attention and the plain
    Sinkhorn, at `compact_to` where it compacts (which must then divide by
    the group's size). The band build's deferred un-permutation is an
    unsharded path, as in JAX.
    """
    if shard_axis is not None:
        from gims_tpu_torch.matcher import ring_attention
        from gims_tpu_torch.matcher.sharded import forward_match_sharded

        group = ring_attention.get_ring_group() if isinstance(shard_axis, str) else shard_axis
        return forward_match_sharded(model, acfg, kpts0, desc0, valid0, kpts1, desc1, valid1,
                                     image_shape, group, k0=k0, k1=k1, adj0=adj0, adj1=adj1,
                                     radius=radius, min_size=min_size, compact_to=compact_to,
                                     scores0=scores0, scores1=scores1)
    mcfg = model.config
    nb0, nb1 = kpts0.shape[1], kpts1.shape[1]
    compact = compact_to is not None and compact_to < max(nb0, nb1)
    # band + compaction: the adjacency stays in sorted-x space and its
    # un-permutation folds into the compaction gather (bit-identical; two
    # (N, N) passes fewer per side)
    defer = acfg.agc_impl == "band" and compact
    inv0 = inv1 = None
    with record_function("gims.agc"):
        if adj0 is None and adj1 is None and kpts0.shape == kpts1.shape:
            # same bucket on both sides: one batched AGC over the stacked pair
            b = kpts0.shape[0]
            kk = None
            if k0 is not None and k1 is not None:
                kk = torch.cat([torch.as_tensor(k, device=kpts0.device).reshape(-1)
                                for k in (k0, k1)])
            adj, kept, inv = run_agc(torch.cat([kpts0, kpts1]),
                                     torch.cat([desc0, desc1]),
                                     torch.cat([valid0, valid1]),
                                     acfg, kk, radius, min_size, defer_unpermute=defer)
            adj0, adj1, kept0, kept1 = adj[:b], adj[b:], kept[:b], kept[b:]
            if inv is not None:
                inv0, inv1 = inv[:b], inv[b:]
        else:
            if adj0 is None:
                adj0, kept0, inv0 = run_agc(kpts0, desc0, valid0, acfg, k0, radius, min_size,
                                            defer_unpermute=defer)
            else:
                kept0 = valid0
            if adj1 is None:
                adj1, kept1, inv1 = run_agc(kpts1, desc1, valid1, acfg, k1, radius, min_size,
                                            defer_unpermute=defer)
            else:
                kept1 = valid1

    if compact:
        with record_function("gims.compact"):
            idx0, kpts0, desc0, adj0, kept0 = _compact_side(
                kpts0, desc0, adj0, kept0, scores0, int(compact_to), inv0)
            idx1, kpts1, desc1, adj1, kept1 = _compact_side(
                kpts1, desc1, adj1, kept1, scores1, int(compact_to), inv1)

    h, w = image_shape
    kpts0n = normalize_keypoints(kpts0, h, w, mcfg.normalization)
    kpts1n = normalize_keypoints(kpts1, h, w, mcfg.normalization)
    out = model(kpts0n, desc0, adj0, kept0, kpts1n, desc1, adj1, kept1)
    with record_function("gims.extract"):
        ext = sinkhorn.extract_matches(out["Z"], kept0, kept1, mcfg.match_threshold)
        if compact:
            return _scatter_back(ext, idx0, idx1, kept0, kept1, nb0, nb1,
                                 out["mdesc0"], out["mdesc1"])
    return {**ext, "kept0": kept0, "kept1": kept1,
            "mdesc0": out["mdesc0"], "mdesc1": out["mdesc1"]}


def remap_gt_to_dustbin(gt_rows, gt_valid, kept0, kept1, nb0: int, nb1: int,
                        neg_cells: str = "corner"):
    """Reference: models/gmatcher.py:337-374.

    GT rows are (R, 3) = (batch, i0, i1) in the padded index space. A row
    with a -1, or with an endpoint that AGC pruned, is a negative.
    neg_cells="corner" reproduces the reference: every negative indexes the
    dustbin-dustbin corner (nb0, nb1), whose clamped score saturates at 0
    (no gradient, the reference's defect). neg_cells="dustbin" sends a bad
    side-0 endpoint to row nb0 and a bad side-1 endpoint to column nb1, so
    negatives supervise the real dustbin cells. Returns (b, i0, i1,
    negative, row_valid), the indices int64."""
    b = gt_rows[:, 0].long()
    i0 = gt_rows[:, 1].long()
    i1 = gt_rows[:, 2].long()
    i0c = i0.clamp(0, nb0 - 1)
    i1c = i1.clamp(0, nb1 - 1)
    bad0 = (i0 < 0) | (~kept0[b, i0c] & (i0 >= 0))
    bad1 = (i1 < 0) | (~kept1[b, i1c] & (i1 >= 0))
    neg_flag = bad0 | bad1
    if neg_cells == "dustbin":
        i0_eff = torch.where(bad0, nb0, i0c)
        i1_eff = torch.where(bad1, nb1, i1c)
    else:
        i0_eff = torch.where(neg_flag, nb0, i0c)
        i1_eff = torch.where(neg_flag, nb1, i1c)
    return b, i0_eff, i1_eff, neg_flag & gt_valid, gt_valid


def training_forward(model: GMatcher, acfg: AGCConfig,
                     kpts0, desc0, valid0, kpts1, desc1, valid1,
                     gt_rows, gt_valid, image_shape, k0=None, k1=None):
    """Train-mode forward: returns (total, (pos, neg, updates)).

    Loss parity with reference models/gmatcher.py:369-386: the couplings at
    the GT indices clamped to [-100, 0] and negated, averaged per batch
    item separately over positive and negative rows, weighted and averaged
    over the batch. AGC gives no gradient (its outputs are integer and
    bool), so it runs on detached descriptors without autograd. `updates`
    is ``{"batch_stats": {buffer name: tensor}}``, the running statistics
    after this forward, for the caller to write into `model`'s buffers, as
    flax returns its mutated ``batch_stats``."""
    batch = kpts0.shape[0]
    nb0, nb1 = kpts0.shape[1], kpts1.shape[1]
    with torch.no_grad(), record_function("gims.agc"):
        adj0, kept0, _ = run_agc(kpts0, desc0.detach(), valid0, acfg, k0)
        adj1, kept1, _ = run_agc(kpts1, desc1.detach(), valid1, acfg, k1)

    h, w = image_shape
    kpts0n = normalize_keypoints(kpts0, h, w, model.config.normalization)
    kpts1n = normalize_keypoints(kpts1, h, w, model.config.normalization)
    with batch_stat_updates() as stats:
        out = model(kpts0n, desc0, adj0, kept0, kpts1n, desc1, adj1, kept1, train=True)
    names = {mod: name for name, mod in model.named_modules()}
    updates = {"batch_stats": {}}
    for mod, (mean, var) in stats.items():
        updates["batch_stats"][names[mod] + ".running_mean"] = mean
        updates["batch_stats"][names[mod] + ".running_var"] = var
    Z = out["Z"]

    mcfg = model.config
    with record_function("gims.train.loss"):
        b, i0_eff, i1_eff, neg_flag, row_valid = remap_gt_to_dustbin(
            gt_rows, gt_valid, kept0, kept1, nb0, nb1, mcfg.neg_cells)
    loss_vec = -torch.clamp(Z[b, i0_eff, i1_eff], -100.0, 0.0)
    pos_w = (row_valid & ~neg_flag).float()
    neg_w = (row_valid & neg_flag).float()

    # the four per-pair sums in one launch, a row each over one slot list,
    # each in row order: the same bits on every run of the card
    sums = segment_sum_rows(torch.stack([loss_vec * pos_w, pos_w, loss_vec * neg_w, neg_w]),
                            b.to(torch.int32)[None].expand(4, -1), batch,
                            tag="train_loss_sums")
    batched_pos = sums[0] / torch.clamp(sums[1], min=1.0)
    batched_neg = sums[2] / torch.clamp(sums[3], min=1.0)
    pos_loss = mcfg.pos_loss_weight * batched_pos.mean()
    neg_loss = mcfg.neg_loss_weight * batched_neg.mean()
    return pos_loss + neg_loss, (pos_loss, neg_loss, updates)
