"""Matcher pipeline: AGC -> GMatcher -> optimal transport -> matches.

Port of ``gims_tpu/matcher/pipeline.py`` (reference: models/gmatcher.py:
219-307), inference only, with the trunk compaction of the fused path
(``compact_to``) and the band build's deferred un-permutation. The
keypoint-axis sharding and precomputed-adjacency (Delaunay) options are not
ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from gims_tpu_torch.agc.graph import build_graph, build_graph_band, check_impls
from gims_tpu_torch.config import AGCConfig
from gims_tpu_torch.matcher import sinkhorn
from gims_tpu_torch.matcher.gmatcher import GMatcher, normalize_keypoints


def run_agc(kpts, descs, valid, acfg: AGCConfig, k=None,
            radius=None, min_size=None, defer_unpermute=False):
    """Batched AGC. kpts (B,N,2), descs (B,N,D), valid (B,N); `k` the
    optional per-item exact percentile rank (B,), which the band build and
    the approximate threshold do not use. Returns (adj, kept, inv): inv is
    None except in band defer_unpermute mode, where adj stays in sorted-x
    space and adj_caller[b, i, j] == adj[b, inv[b, i], inv[b, j]]."""
    check_impls(agc_impl=acfg.agc_impl, threshold_impl=acfg.threshold_impl,
                cc_impl=acfg.cc_impl, reconnect_impl=acfg.reconnect_impl)
    radius = acfg.radius if radius is None else radius
    min_size = acfg.min_size if min_size is None else min_size
    if acfg.agc_impl == "band":
        out = build_graph_band(
            kpts, descs, valid, radius=radius, percentile=acfg.percentile,
            min_size=min_size, cc_rounds=acfg.cc_rounds,
            threshold_stride=acfg.threshold_stride,
            band_halfwidth=acfg.band_halfwidth,
            reconnect_impl=acfg.reconnect_impl,
            reconnect_buckets=acfg.reconnect_buckets,
            defer_unpermute=defer_unpermute,
            cc_impl="band" if acfg.cc_impl == "band" else "dense")
        return out.adj, out.kept, out.inv
    out = build_graph(
        kpts, descs, valid, radius=radius, percentile=acfg.percentile,
        min_size=min_size, cc_rounds=acfg.cc_rounds, k=k,
        threshold_impl=acfg.threshold_impl,
        threshold_stride=acfg.threshold_stride,
        cc_impl=acfg.cc_impl, cc_degree=acfg.cc_degree,
        reconnect_impl=acfg.reconnect_impl,
        reconnect_buckets=acfg.reconnect_buckets,
    )
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
    b, n = kept.shape
    sc = torch.zeros(kept.shape, dtype=torch.float32, device=kept.device) \
        if scores is None else scores
    key = torch.where(kept, sc, float("-inf"))
    idx = torch.argsort(-key, dim=1, stable=True)[:, :nc]          # (B, nc)
    ar = torch.arange(idx.shape[1], device=kept.device)[None, :]
    kept_c = torch.gather(kept, 1, idx) & (ar < kept.sum(dim=1, keepdim=True))

    def rows(x):
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    ci = idx if inv is None else torch.gather(inv, 1, idx)
    adj_rows = torch.gather(adj, 1, ci[..., None].expand(-1, -1, adj.shape[-1]))
    adj_c = torch.gather(adj_rows, 2, ci[:, None, :].expand(-1, ci.shape[1], -1))
    return idx, rows(kpts), rows(desc), adj_c, kept_c


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
    (``_compact_side``), and the outputs are scattered back.
    """
    if adj0 is not None or adj1 is not None:
        raise NotImplementedError("precomputed adjacency (Delaunay) is not "
                                  "ported yet; see ROADMAP.md")
    if shard_axis is not None:
        raise NotImplementedError("shard_axis (keypoint-axis sharding) is not "
                                  "ported yet; see ROADMAP.md")
    mcfg = model.config
    nb0, nb1 = kpts0.shape[1], kpts1.shape[1]
    compact = compact_to is not None and compact_to < max(nb0, nb1)
    # band + compaction: the adjacency stays in sorted-x space and its
    # un-permutation folds into the compaction gather (bit-identical; two
    # (N, N) passes fewer per side)
    defer = acfg.agc_impl == "band" and compact
    inv0 = inv1 = None
    with record_function("gims.agc"):
        if kpts0.shape == kpts1.shape:
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
            adj0, kept0, inv0 = run_agc(kpts0, desc0, valid0, acfg, k0, radius, min_size,
                                        defer_unpermute=defer)
            adj1, kept1, inv1 = run_agc(kpts1, desc1, valid1, acfg, k1, radius, min_size,
                                        defer_unpermute=defer)

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
