"""Matcher pipeline: AGC -> GMatcher -> optimal transport -> matches.

Port of ``gims_tpu/matcher/pipeline.py`` (reference: models/gmatcher.py:
219-307), inference only. The trunk-compaction, keypoint-axis sharding,
deferred-unpermute and precomputed-adjacency (Delaunay) options are not
ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from gims_tpu_torch.agc.graph import _check_impls, build_graph
from gims_tpu_torch.config import AGCConfig
from gims_tpu_torch.matcher import sinkhorn
from gims_tpu_torch.matcher.gmatcher import GMatcher, normalize_keypoints


def run_agc(kpts, descs, valid, acfg: AGCConfig, k=None,
            radius=None, min_size=None, defer_unpermute=False):
    """Batched dense AGC. kpts (B,N,2), descs (B,N,D), valid (B,N); `k` the
    optional per-item percentile rank (B,). Returns (adj, kept, None)."""
    _check_impls(acfg.threshold_impl, acfg.cc_impl, acfg.reconnect_impl,
                 acfg.agc_impl)
    if defer_unpermute:
        raise NotImplementedError("defer_unpermute belongs to the band AGC "
                                  "build, not ported yet; see ROADMAP.md")
    out = build_graph(
        kpts, descs, valid,
        radius=acfg.radius if radius is None else radius,
        percentile=acfg.percentile,
        min_size=acfg.min_size if min_size is None else min_size,
        cc_rounds=acfg.cc_rounds, k=k,
        threshold_impl=acfg.threshold_impl, cc_impl=acfg.cc_impl,
        reconnect_impl=acfg.reconnect_impl,
        reconnect_buckets=acfg.reconnect_buckets,
    )
    return out.adj, out.kept, None


def percentile_rank(num_valid: int, percentile: float) -> int:
    """Host-side exact rank of the AGC percentile threshold
    (reference: models/agc.py:378-379)."""
    count = num_valid * (num_valid - 1) // 2
    if count <= 0:
        return 0
    k = int(count * percentile / 100)
    if k >= count:
        k = count - 1
    return k


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
):
    """Inference for a batch of pairs, all arrays padded to buckets.

    `model` is a GMatcher holding its weights and MatcherConfig. Returns
    padded matches0/1, matching_scores0/1, kept0/1, mdesc0/1 (host code
    compacts them to the reference's dict contract, see api.py).
    """
    if adj0 is not None or adj1 is not None:
        raise NotImplementedError("precomputed adjacency (Delaunay) is not "
                                  "ported yet; see ROADMAP.md")
    if compact_to is not None:
        raise NotImplementedError("compact_to (trunk compaction) is not "
                                  "ported yet; see ROADMAP.md")
    if shard_axis is not None:
        raise NotImplementedError("shard_axis (keypoint-axis sharding) is not "
                                  "ported yet; see ROADMAP.md")
    mcfg = model.config
    with record_function("gims.agc"):
        if kpts0.shape == kpts1.shape:
            # same bucket on both sides: one batched AGC over the stacked pair
            b = kpts0.shape[0]
            kk = None
            if k0 is not None and k1 is not None:
                kk = torch.cat([torch.atleast_1d(torch.as_tensor(k0)),
                                torch.atleast_1d(torch.as_tensor(k1))])
            adj, kept, _ = run_agc(torch.cat([kpts0, kpts1]),
                                   torch.cat([desc0, desc1]),
                                   torch.cat([valid0, valid1]),
                                   acfg, kk, radius, min_size)
            adj0, adj1, kept0, kept1 = adj[:b], adj[b:], kept[:b], kept[b:]
        else:
            adj0, kept0, _ = run_agc(kpts0, desc0, valid0, acfg, k0, radius, min_size)
            adj1, kept1, _ = run_agc(kpts1, desc1, valid1, acfg, k1, radius, min_size)

    h, w = image_shape
    kpts0n = normalize_keypoints(kpts0, h, w, mcfg.normalization)
    kpts1n = normalize_keypoints(kpts1, h, w, mcfg.normalization)
    out = model(kpts0n, desc0, adj0, kept0, kpts1n, desc1, adj1, kept1)
    with record_function("gims.extract"):
        ext = sinkhorn.extract_matches(out["Z"], kept0, kept1, mcfg.match_threshold)
    return {**ext, "kept0": kept0, "kept1": kept1,
            "mdesc0": out["mdesc0"], "mdesc1": out["mdesc1"]}
