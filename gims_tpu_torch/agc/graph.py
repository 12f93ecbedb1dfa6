"""Adaptive Graph Construction (AGC): the dense, sparse and band builds.

Port of ``gims_tpu/agc/graph.py`` (reference: models/agc.py:682-709):

  1. spatial candidate edges: all pairs within `radius`;
  2. keep candidates whose descriptor cosine similarity >= the
     `percentile`-th order statistic of the valid upper-triangle
     similarities (``threshold_impl="exact"``), or of every
     `threshold_stride`-th row of them (``"approx"``);
  3. connect isolated nodes to their nearest spatial neighbor;
  4. mask out connected components smaller than `min_size`;
  5. one pass linking each surviving component to its nearest-centroid
     neighbor component, through the closest node pair
     (``reconnect_impl="exact"``) or through the target's node nearest to
     our centroid and our node nearest to it (``"centroid"``).

``build_graph`` builds (N, N) distance and similarity matrices; with
``cc_impl="sparse"`` its components run over a fixed-degree neighbour list.
``build_graph_band`` sorts the keypoints by x and keeps only a band of
`band_halfwidth` sorted neighbours per keypoint (``agc/band.py``); only the
bool adjacency is made dense. Component labels come from ``agc/labels.py``,
whose rounds stop at the first round that changes no label, on the card.

Every function takes a batch of keypoint sets with a leading batch axis
(the builds also take one set without it). Adjacency is a dense (B, N, N)
bool tensor. D-GIMS replaces the build by a Delaunay triangulation on the
host (``delaunay_adjacency_host``, scipy).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from gims_tpu_torch.agc import labels as label_rounds
from gims_tpu_torch.core.segsum import batched_segment_sum
from gims_tpu_torch.agc.band import (
    _band_shear_bwd,
    _band_to_dense,
    _diag_band,
    _window_values_bwd,
    _window_values_fwd,
)

BIG = 3.0e38
BAND_ROWS = 128  # the band build pads N to a multiple of this
IMPLS = {"agc_impl": ("dense", "band"), "threshold_impl": ("exact", "approx"),
         "cc_impl": ("dense", "sparse", "band"), "reconnect_impl": ("exact", "centroid")}


class AGCGraph(NamedTuple):
    adj: torch.Tensor        # (B, N, N) bool symmetric adjacency, no self loops
    kept: torch.Tensor       # (B, N) bool: valid AND survived min_size pruning
    labels: torch.Tensor     # (B, N) int32 component label (min node id; N = invalid)
    threshold: torch.Tensor  # (B,) f32 cosine threshold used
    # band defer_unpermute only: adj stays in sorted-x space (padded to a
    # multiple of 128) and adj_caller[b, i, j] == adj[b, inv[b, i], inv[b, j]]
    inv: Optional[torch.Tensor] = None


def check_impls(**impls):
    """Raise ValueError for an AGC build name the package does not have."""
    for name, value in impls.items():
        if value not in IMPLS[name]:
            raise ValueError(f"AGC {name}={value!r}: one of {IMPLS[name]}")


def pairwise_sq_dists(kpts: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) -> (..., N, N) squared distances, by explicit
    differencing (not |x|^2 - 2xy + |y|^2) for radius tests in f32."""
    d = kpts[..., :, None, :] - kpts[..., None, :, :]
    return torch.sum(d * d, dim=-1)


def _normalize_rows(descs: torch.Tensor) -> torch.Tensor:
    """Rows divided by max(||x||, 1e-12) (reference: agc.py:382-391)."""
    norm = torch.sqrt(torch.sum(descs * descs, dim=-1, keepdim=True))
    return descs / torch.clamp(norm, min=1e-12)


def cosine_similarity_matrix(descs: torch.Tensor) -> torch.Tensor:
    """(..., N, D) -> (..., N, N) cosine similarity of the normalized rows."""
    normed = _normalize_rows(descs)
    return torch.matmul(normed, normed.transpose(-1, -2))


def kth_smallest_masked(values: torch.Tensor, mask: torch.Tensor,
                        k: torch.Tensor) -> torch.Tensor:
    """Exact k-th (0-indexed) smallest of values[mask] per item; 0.0 where
    the mask is empty (reference: agc.py:367-380, np.partition).

    values, mask (B, ...) and k (B,) int. Each item is sorted whole with its masked entries at +inf and read at its
    k, clipped to its count: no per-item host loop or boolean gather, so
    the host never waits for the card here. A full sort, not
    torch.kthvalue: on CUDA kthvalue selects a single slice with one
    thread block, which takes hundreds of ms for the ~33M similarities of
    the 8192 bucket, while a device radix sort takes a few ms
    (scripts/profile_torch_matching.py)."""
    mask = mask.flatten(1)
    flat = torch.where(mask, values.flatten(1).float(), float("inf"))
    count = mask.sum(dim=1)
    k = torch.minimum(k.long().clamp(min=0), (count - 1).clamp(min=0))
    kth = torch.gather(torch.sort(flat, dim=1).values, 1, k[:, None])[:, 0]
    return torch.where(count > 0, kth, 0.0)


def _f32_rank(count: torch.Tensor, percentile: float) -> torch.Tensor:
    """floor(count * percentile / 100) in f32, as the JAX build's in-graph
    rank rules compute it."""
    pct = torch.full(count.shape, float(np.float32(percentile / 100.0)),
                     dtype=torch.float32, device=count.device)
    return torch.floor(count.float() * pct).long()


def percentile_k(num_valid: torch.Tensor, percentile: float) -> torch.Tensor:
    """In-graph rank rule of the JAX build when no rank is passed, on the
    device: the pair count times percentile/100 in f32, floored and
    clipped. num_valid (B,) int; returns (B,) int64."""
    nv = num_valid.long()
    count = nv * (nv - 1) // 2
    k = _f32_rank(count, percentile)
    k = torch.where(k >= count, count - 1, k)
    return k.clamp(min=0)


def strided_threshold(sub_sim: torch.Tensor, sub_mask: torch.Tensor,
                      percentile: float) -> torch.Tensor:
    """The approximate percentile threshold: the exact order statistic of
    a row subsample's masked similarities, its rank taken from the
    subsample's own pair count (reference rank rule, f32)."""
    cnt = sub_mask.flatten(1).sum(dim=1)
    k = torch.minimum(_f32_rank(cnt, percentile).clamp(min=0), (cnt - 1).clamp(min=0))
    return kth_smallest_masked(sub_sim, sub_mask, k)


def connected_components(adj: torch.Tensor, valid: torch.Tensor,
                         rounds: int) -> torch.Tensor:
    """Min-label propagation with pointer jumping over adj (B, N, N) bool,
    valid (B, N). Returns (B, N) int32 labels: each component is labeled by
    its minimum node index, invalid nodes by N. One round, then up to
    `rounds` more until a round changes no label (``agc/labels.py``)."""
    return label_rounds.propagate("dense", adj, valid, rounds)


def connected_components_band(band: torch.Tensor, valid: torch.Tensor,
                              rounds: int) -> torch.Tensor:
    """``connected_components`` of the symmetrized dense adjacency of a
    forward band (B, N, Wh), reading O(N Wh) per round."""
    return label_rounds.propagate("band", band, valid, rounds)


def connected_components_sparse(nbr_idx: torch.Tensor, nbr_ok: torch.Tensor,
                                valid: torch.Tensor, rounds: int) -> torch.Tensor:
    """``connected_components`` over a fixed-degree neighbour list (B, N, D):
    a pull from my listed neighbours, then a push to them, so the list
    need not be symmetric. Exact whenever every node's true degree <= D or
    its other endpoint kept the edge."""
    return label_rounds.propagate("sparse", nbr_ok, valid, rounds, nbr_idx)


def neighbor_list(d2: torch.Tensor, adj: torch.Tensor, pair_valid_od: torch.Tensor,
                  degree_cap: int):
    """One top-k pass -> a fixed-degree neighbour list and each node's
    spatial nearest neighbour (reference of the sparse build).

    Keyed by d2 + OFF * (1 - adj), every true neighbour ranks before every
    non-neighbour (edges need d2 <= radius^2 << OFF); entry 0 is the
    nearest valid node overall. The selection is stable (ties by lower
    index, as ``lax.top_k``). Returns (nbr_idx (B, N, D) int64, nbr_ok
    (B, N, D) bool, top_key (B, N, D) f32)."""
    n = d2.shape[-1]
    dcap = min(int(degree_cap), n)
    off = float(np.float32(1.0e7))
    key = torch.where(adj, d2, d2 + off)
    key = torch.where(pair_valid_od, key, BIG)
    top_key, nbr_idx = torch.sort(key, dim=-1, stable=True)
    top_key, nbr_idx = top_key[..., :dcap], nbr_idx[..., :dcap]
    return nbr_idx, top_key < off, top_key


def _first_min_index(values: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    """(min, first argmin) over a masked axis; sentinel = axis length."""
    n = values.shape[dim]
    mn = torch.where(mask, values, BIG).amin(dim=dim, keepdim=True)
    hit = mask & (values == mn)
    shape = [1] * values.dim()
    shape[dim] = n
    ar = torch.arange(n, device=values.device).reshape(shape)
    arg = torch.where(hit, ar, torch.full_like(ar, n)).amin(dim=dim)
    return mn.squeeze(dim), arg


def _segment_sum(data: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """Per-batch segment sum: out[b, s] = sum of data[b, i] with seg[b, i] == s.
    Integers add exactly in any order; floats add in ascending i, a row of
    ``core/segsum.py`` per b, so the card gives the same bits every run."""
    if data.is_floating_point():
        return batched_segment_sum(data, seg, num, tag="agc_centroid_sums")
    out = torch.zeros((data.shape[0], num), dtype=data.dtype, device=data.device)
    return out.scatter_add_(1, seg, data)


def _prune_small(labels: torch.Tensor, valid: torch.Tensor, min_size: int) -> torch.Tensor:
    """kept = valid and in a component of at least min_size valid nodes."""
    n = labels.shape[1]
    safe_labels = torch.clamp(labels, max=n - 1).long()
    sizes = _segment_sum(valid.long(), safe_labels, n)
    return valid & (torch.gather(sizes, 1, safe_labels) >= int(min_size))


def _nearest_component(cent, comp_ok, l0: int = 0, l1: Optional[int] = None):
    """nnc[b, l] for components l in [l0, l1) (all by default): the nearest
    other surviving component by centroid, the first among ties; sentinel
    C+1."""
    c1 = cent.shape[1]
    l1 = c1 if l1 is None else l1
    dx = cent[:, l0:l1, None, 0] - cent[:, None, :, 0]
    dy = cent[:, l0:l1, None, 1] - cent[:, None, :, 1]
    cd2 = dx * dx + dy * dy                              # (B, l1-l0, C+1)
    comp_ids = torch.arange(c1, device=cent.device)
    comp_pair_ok = (comp_ok[:, l0:l1, None] & comp_ok[:, None, :]
                    & (comp_ids[l0:l1, None] != comp_ids[None, :]))
    return _first_min_index(cd2, comp_pair_ok, dim=2)[1]


def _component_links_head(kpts, labels, kept, C, nearest=_nearest_component):
    """Rank-compacted component ids, centroids, each component's nearest
    component (``nearest(cent, comp_ok)``), and the link skip rule
    (reference: agc.py:518-565)."""
    b, n = kept.shape
    dev = kpts.device
    idx = torch.arange(n, device=dev)
    safe_labels = torch.clamp(labels, max=n - 1).long()
    is_rep = kept & (labels == idx)
    rank = torch.clamp(torch.cumsum(is_rep.long(), dim=1) - 1, 0, C - 1)
    lab = torch.where(kept, torch.gather(rank, 1, safe_labels),
                      torch.full_like(rank, C))  # component id in [0, C]

    cnt = _segment_sum(kept.long(), lab, C + 1).float()  # exact in any order
    comp_ok = cnt > 0
    comp_ok[:, C] = False
    num_comps = comp_ok.sum(dim=1)
    # a row per image and coordinate, x then y, into the C + 1 slots: one
    # launch, each slot in ascending node order
    xy = torch.where(kept[..., None], kpts[..., :2], 0.0)
    xy = xy.transpose(1, 2).contiguous().reshape(2 * b, n)
    lab2 = lab.to(torch.int32)[:, None].expand(b, 2, n).reshape(2 * b, n)
    sums = _segment_sum(xy, lab2, C + 1)
    cent = sums.reshape(b, 2, C + 1).transpose(1, 2) / torch.clamp(cnt, min=1.0)[..., None]

    comp_ids = torch.arange(C + 1, device=dev)
    nnc = nearest(cent, comp_ok)                         # sentinel C+1
    nnc_safe = torch.clamp(nnc, max=C)
    # pair (l, nnc[l]) is dropped iff nnc[l] < l and it already linked back
    back = torch.gather(nnc_safe, 1, nnc_safe)
    link_ok = comp_ok & (nnc <= C) & ~((nnc < comp_ids) & (back == comp_ids))
    link_ok = link_ok & (num_comps > 1)[:, None]
    return lab, comp_ids, cent, nnc_safe, link_ok


def _set_links(adj, u_l, v_l, ok, scatter_map=None):
    """Set both directions of every link (u_l[b, l], v_l[b, l]) where ok, by
    a max-scatter over all (B, C+1) slots, the skipped ones adding 0: no
    nonzero(), whose size the host would have to wait for. scatter_map
    routes caller ids into a sorted-space adj (band defer_unpermute)."""
    b, n = adj.shape[0], adj.shape[-1]
    if scatter_map is not None:
        u_l = torch.gather(scatter_map, 1, u_l)
        v_l = torch.gather(scatter_map, 1, v_l)
    base = torch.arange(b, device=adj.device)[:, None] * (n * n)
    lin = torch.cat([base + u_l * n + v_l, base + v_l * n + u_l]).reshape(-1)
    flat = adj.to(torch.uint8).reshape(-1)
    flat.scatter_reduce_(0, lin, torch.cat([ok, ok]).reshape(-1).to(torch.uint8), "amax")
    return flat.view(adj.shape).bool()


def _reconnect_components(adj, kpts, d2, labels, kept, buckets=4096, scatter_map=None):
    """Reference: agc.py:518-565 ``fast_connect_components``: each surviving
    component links to its nearest component (by centroid) through the
    closest node pair, in ascending label order, skipping a link whose
    reverse was already made."""
    b, n = kept.shape
    C = min(n, int(buckets))
    lab, comp_ids, _, nnc_safe, link_ok = _component_links_head(kpts, labels, kept, C)

    # md[b, c, v] = min over kept u of component c of d2[b, u, v]
    d2_rows = torch.where(kept[:, :, None], d2, BIG)
    md = torch.full((b * (C + 1), n), float("inf"), dtype=d2.dtype, device=d2.device)
    seg = (lab + torch.arange(b, device=d2.device)[:, None] * (C + 1)).reshape(-1)
    with warnings.catch_warnings():  # index_reduce_ is marked beta
        warnings.simplefilter("ignore", UserWarning)
        md.index_reduce_(0, seg, d2_rows.reshape(b * n, n), "amin",
                         include_self=True)
    md = md.view(b, C + 1, n)

    # v*(l): first argmin over kept v of component nnc[l] of md[l, v]
    tgt_mask = (lab[:, None, :] == nnc_safe[:, :, None]) & kept[:, None, :]
    _, v_l = _first_min_index(md, tgt_mask, dim=2)       # sentinel n
    v_l_safe = torch.clamp(v_l, max=n - 1)
    # u*(l): first argmin over kept u of component l of d2[u, v*(l)]
    dcols = torch.gather(d2, 2, v_l_safe[:, None, :].expand(b, n, C + 1))
    src_mask = (lab[:, :, None] == comp_ids[None, None, :]) & kept[:, :, None]
    _, u_l = _first_min_index(dcols, src_mask, dim=1)    # sentinel n
    u_l_safe = torch.clamp(u_l, max=n - 1)
    ok = link_ok & (v_l < n) & (u_l < n)
    return _set_links(adj, u_l_safe, v_l_safe, ok, scatter_map)


def _reconnect_components_centroid(adj, kpts, labels, kept, buckets=1024,
                                   scatter_map=None):
    """The same link topology as ``_reconnect_components`` (nearest
    component by centroid, ascending-label enumeration, reverse-link skip),
    with the link endpoints picked through centroids: v* = the target
    component's node nearest to our centroid, u* = our node nearest to v*.
    No (N, N) table: (C+1, N) distance tables from 2-D points, by f32
    matrix products as the JAX package computes them."""
    b, n = kept.shape
    C = min(n, int(buckets))
    lab, comp_ids, cent, nnc_safe, link_ok = _component_links_head(kpts, labels, kept, C)

    k2 = torch.sum(kpts * kpts, dim=-1)                             # (B, N)
    c2 = torch.sum(cent * cent, dim=-1)                             # (B, C+1)
    # dt[b, l, v] = ||cent[l] - kpts[v]||^2
    dt = c2[:, :, None] - 2.0 * torch.matmul(cent, kpts.transpose(1, 2)) + k2[:, None, :]
    tgt_mask = (lab[:, None, :] == nnc_safe[:, :, None]) & kept[:, None, :]
    _, v_l = _first_min_index(dt, tgt_mask, dim=2)                  # sentinel n
    v_l_safe = torch.clamp(v_l, max=n - 1)

    pv = torch.gather(kpts, 1, v_l_safe[..., None].expand(b, C + 1, 2))  # (B, C+1, 2)
    # du[b, u, l] = ||kpts[u] - kpts[v*(l)]||^2
    du = (k2[:, :, None] - 2.0 * torch.matmul(kpts, pv.transpose(1, 2))
          + torch.sum(pv * pv, dim=-1)[:, None, :])
    src_mask = (lab[:, :, None] == comp_ids[None, None, :]) & kept[:, :, None]
    _, u_l = _first_min_index(du, src_mask, dim=1)                  # sentinel n
    u_l_safe = torch.clamp(u_l, max=n - 1)
    ok = link_ok & (v_l < n) & (u_l < n)
    return _set_links(adj, u_l_safe, v_l_safe, ok, scatter_map)


def _reconnect(adj, kpts, labels, kept, reconnect_impl, buckets, d2=None,
               scatter_map=None):
    if reconnect_impl == "centroid":
        return _reconnect_components_centroid(adj, kpts, labels, kept, buckets, scatter_map)
    if d2 is None:
        d2 = pairwise_sq_dists(kpts)
    return _reconnect_components(adj, kpts, d2, labels, kept, buckets, scatter_map)


def _batched(kpts, descs, valid):
    single = kpts.dim() == 2
    if single:
        kpts, descs, valid = kpts[None], descs[None], valid[None]
    return single, kpts, descs, valid


def _unbatch(g: AGCGraph) -> AGCGraph:
    return AGCGraph(*(None if x is None else x[0] for x in g))


def _f32_square(radius: float) -> float:
    return float(np.float32(radius) * np.float32(radius))  # f32, as JAX squares it


def build_graph(
    kpts: torch.Tensor,
    descs: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    percentile: float,
    min_size: int,
    cc_rounds: int = 20,
    k: Optional[Union[int, Sequence[int], torch.Tensor]] = None,
    threshold_impl: str = "exact",
    threshold_stride: int = 4,
    cc_impl: str = "dense",
    cc_degree: int = 32,
    reconnect_impl: str = "exact",
    reconnect_buckets: int = 4096,
) -> AGCGraph:
    """Full AGC for padded keypoint sets, (N, N) matrices.

    kpts (B, N, 2) f32, descs (B, N, D) f32 (unnormalized), valid (B, N)
    bool; one set without the batch axis is accepted and returned without
    it. `k` is the optional rank of the exact percentile threshold per set
    (``pipeline.percentile_rank`` of the valid counts); without it the rank
    follows the JAX build's in-graph f32 rule. ``threshold_impl="approx"``
    ignores it. ``cc_impl`` other than "sparse" labels the dense adjacency.
    """
    check_impls(threshold_impl=threshold_impl, cc_impl=cc_impl,
                reconnect_impl=reconnect_impl)
    single, kpts, descs, valid = _batched(kpts, descs, valid)
    if single and k is not None:
        k = [k]
    bsz, n = valid.shape
    dev = kpts.device
    idx = torch.arange(n, device=dev)
    pair_valid = valid[:, :, None] & valid[:, None, :]
    off_diag = idx[:, None] != idx[None, :]

    d2 = pairwise_sq_dists(kpts)
    sim = cosine_similarity_matrix(descs)

    # --- percentile threshold over the valid upper triangle ---
    triu = pair_valid & (idx[:, None] < idx[None, :])
    if threshold_impl == "approx" and threshold_stride > 1:
        s = int(threshold_stride)
        threshold = strided_threshold(sim[:, ::s], triu[:, ::s], percentile)
    else:
        if k is None:
            k = percentile_k(valid.sum(dim=1), percentile)
        else:
            k = torch.as_tensor(k, device=dev).reshape(bsz)
        threshold = kth_smallest_masked(sim, triu, k)

    # --- candidate edges: within radius AND similarity >= threshold ---
    pvod = pair_valid & off_diag
    adj = pvod & (d2 <= _f32_square(radius)) & (sim >= threshold[:, None, None])

    if cc_impl == "sparse":
        # one top-k pass replaces the dense degree, the NN argmin and the
        # O(N^2) rounds of label propagation
        nbr_idx, nbr_ok, top_key = neighbor_list(d2, adj, pvod, cc_degree)
        has_any_edge = nbr_ok.flatten(1).any(dim=1)
        isolated = (valid & (nbr_ok.sum(dim=2) == 0) & has_any_edge[:, None]
                    & (top_key[..., 0] < BIG))
        nn_idx = torch.clamp(nbr_idx[..., 0], max=n - 1)
        # the fix edge rides the list: entry 0 of an isolated node is its
        # nearest neighbour (the push covers the reverse)
        nbr_ok_cc = nbr_ok.clone()
        nbr_ok_cc[..., 0] |= isolated
        labels = connected_components_sparse(nbr_idx, nbr_ok_cc, valid, cc_rounds)
        kept = _prune_small(labels, valid, min_size)
        fix = isolated[:, :, None] & (idx[None, None, :] == nn_idx[:, :, None])
        adj = (adj | fix | fix.transpose(1, 2)) & kept[:, :, None] & kept[:, None, :]
    else:
        # --- connect isolated nodes to the nearest spatial neighbor ---
        degree = adj.sum(dim=2)
        has_any_edge = adj.flatten(1).any(dim=1)  # the reference skips edgeless graphs
        isolated = valid & (degree == 0) & has_any_edge[:, None]
        _, nn_idx = _first_min_index(d2, pvod, dim=2)
        nn_idx = torch.clamp(nn_idx, max=n - 1)
        fix = torch.zeros_like(adj).scatter_(2, nn_idx[..., None], isolated[..., None])
        adj = adj | fix | fix.transpose(1, 2)

        # --- connected components + small-component pruning ---
        labels = connected_components(adj, valid, cc_rounds)
        kept = _prune_small(labels, valid, min_size)
        adj = adj & kept[:, :, None] & kept[:, None, :]

    # --- reconnect surviving components ---
    adj = _reconnect(adj, kpts, labels, kept, reconnect_impl, reconnect_buckets, d2=d2)
    out = AGCGraph(adj, kept, labels, threshold)
    return _unbatch(out) if single else out


def build_graph_band(
    kpts: torch.Tensor,
    descs: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    percentile: float,
    min_size: int,
    cc_rounds: int = 20,
    threshold_stride: int = 4,
    band_halfwidth: int = 512,
    reconnect_impl: str = "centroid",
    reconnect_buckets: int = 1024,
    defer_unpermute: bool = False,
    cc_impl: str = "dense",
) -> AGCGraph:
    """Band-limited AGC: the contract of ``build_graph``, O(N Wh) floats.

    The candidate graph is radius-bounded, so after a sort by x every
    candidate pair lies within a window of sorted indices: distances and
    similarities are kept as (B, N, Wh) forward bands (Wh = band_halfwidth
    rounded up to 128) and only the bool adjacency is made dense. Equal to
    ``build_graph(threshold_impl="approx")`` with the same stride whenever
    every radius pair lies within the window (``band_coverage``); the
    threshold subsample is taken in the caller's row order, before the
    sort. `cc_impl` "band" labels the band itself, anything else the dense
    adjacency. With `defer_unpermute` the adjacency stays in sorted space,
    padded to a multiple of 128, and ``inv`` maps caller rows into it.
    """
    check_impls(reconnect_impl=reconnect_impl, cc_impl=cc_impl)
    single, kpts, descs, valid = _batched(kpts, descs, valid)
    bsz, n_in = valid.shape
    dev = kpts.device
    br = BAND_ROWS
    n = -(-n_in // br) * br
    if n > n_in:
        pad = n - n_in
        kpts = torch.cat([kpts, kpts.new_full((bsz, pad, 2), 2.0e9)], dim=1)
        descs = torch.cat([descs, descs.new_zeros((bsz, pad, descs.shape[-1]))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((bsz, pad))], dim=1)
    wh = -(-min(int(band_halfwidth), n) // br) * br
    idx = torch.arange(n, device=dev)

    # --- the strided percentile threshold, in the caller's row order: a
    # (N/s, N) matrix product instead of rows of a full (N, N) one ---
    normed_u = _normalize_rows(descs)
    s = max(int(threshold_stride), 1)
    sub_sim = torch.matmul(normed_u[:, ::s], normed_u.transpose(1, 2))
    rows = idx[::s]
    sub_mask = valid[:, ::s, None] & valid[:, None, :] & (rows[:, None] < idx[None, :])
    threshold = strided_threshold(sub_sim, sub_mask, percentile)

    # --- sort by x (invalid rows last; stable) ---
    sort_key = torch.where(valid, kpts[..., 0], BIG)
    perm = torch.argsort(sort_key, dim=1, stable=True)
    inv = torch.argsort(perm, dim=1, stable=True)
    kp = torch.gather(kpts, 1, perm[..., None].expand(bsz, n, 2))
    va = torch.gather(valid, 1, perm)
    normed = torch.gather(normed_u, 1, perm[..., None].expand_as(normed_u))

    # --- banded d2 / sim over forward offsets j = i + 1 + m, m < wh ---
    nb = n // br
    c = br + wh
    # block b's forward columns: j in [b * br + 1, b * br + c]
    col_idx = (torch.arange(nb, device=dev) * br + 1)[:, None] + torch.arange(c, device=dev)
    nm_pad = torch.cat([normed, normed.new_zeros((bsz, wh + 1, normed.shape[-1]))], dim=1)
    sim_blocks = torch.matmul(normed.view(bsz, nb, br, -1),
                              nm_pad[:, col_idx].transpose(-1, -2))   # (B, nb, br, c)
    sim_b = _diag_band(sim_blocks)                                    # (B, n, wh)
    x, y = kp[..., 0], kp[..., 1]
    dx = x[..., None] - _window_values_fwd(x, wh, 2.0e9)
    dy = y[..., None] - _window_values_fwd(y, wh, 2.0e9)
    d2_b = dx * dx + dy * dy
    ok_b = _window_values_fwd(va, wh, False)
    j_fwd = idx[:, None] + 1 + torch.arange(wh, device=dev)[None, :]
    band = (ok_b & va[..., None] & (j_fwd < n) & (d2_b <= _f32_square(radius))
            & (sim_b >= threshold[:, None, None]))

    # --- isolated-node fix: nearest neighbour from the forward and backward
    # distance bands (exact when it lies within the window), smallest j
    # among ties as the dense build's first argmin ---
    degree = band.sum(dim=2) + _band_shear_bwd(band).sum(dim=2)
    has_any_edge = band.flatten(1).any(dim=1)
    isolated = va & (degree == 0) & has_any_edge[:, None]
    dxb = x[..., None] - _window_values_bwd(x, wh, 2.0e9)
    dyb = y[..., None] - _window_values_bwd(y, wh, 2.0e9)
    d2_bwd = dxb * dxb + dyb * dyb
    ok_bwd = _window_values_bwd(va, wh, False)
    j_bwd = idx[:, None] - 1 - torch.arange(wh, device=dev)[None, :]
    cand_d2 = torch.cat([torch.where(ok_bwd & (j_bwd >= 0), d2_bwd, BIG),
                         torch.where(ok_b & (j_fwd < n), d2_b, BIG)], dim=2)
    cand_j = torch.cat([j_bwd, j_fwd], dim=1).expand(bsz, n, 2 * wh)
    nn_d2 = cand_d2.amin(dim=2)
    nn_idx = torch.where(cand_d2 == nn_d2[..., None], cand_j, n).amin(dim=2)
    nn_ok = isolated & (nn_d2 < BIG) & (nn_idx < n)
    nn_safe = nn_idx.clamp(0, n - 1)
    # the fix edge rides the band: row min(i, nn), offset |i - nn| - 1
    r_fix = torch.minimum(idx, nn_safe)
    off_fix = (idx - nn_safe).abs() - 1
    ok_fix = nn_ok & (off_fix >= 0) & (off_fix < wh)
    lin = (torch.arange(bsz, device=dev)[:, None] * (n * wh) + r_fix * wh
           + off_fix.clamp(0, wh - 1)).reshape(-1)
    flat = band.to(torch.uint8).reshape(-1)
    flat.scatter_reduce_(0, lin, ok_fix.reshape(-1).to(torch.uint8), "amax")
    band = flat.view(bsz, n, wh).bool()

    # --- the dense bool adjacency, components and pruning, in sorted space ---
    adj_half = _band_to_dense(band)
    adj = adj_half | adj_half.transpose(1, 2)
    if cc_impl == "band":
        labels = connected_components_band(band, va, cc_rounds)
    else:
        labels = connected_components(adj, va, cc_rounds)
    kept = _prune_small(labels, va, min_size)
    adj = adj & kept[:, :, None] & kept[:, None, :]

    # --- back to the caller's order before the reconnect, which depends on
    # the enumeration order (ranks, centroid sums, argmin ties). kept and
    # the labels are row gathers; the (N, N) adjacency is gathered too
    # unless the caller composes inv into its own gather ---
    kept = torch.gather(kept, 1, inv)
    safe = labels.clamp(max=n - 1).long()
    rep_o = torch.where(labels < n, torch.gather(perm, 1, safe), n)  # original rep id
    lab_o = torch.gather(rep_o, 1, inv)                               # per caller row
    # canonical labels: the minimum caller id of each component
    min_id = torch.full((bsz, n), n, dtype=torch.long, device=dev)
    min_id.scatter_reduce_(1, lab_o.clamp(max=n - 1), torch.where(lab_o < n, idx, n),
                           "amin", include_self=True)
    labels = torch.where(lab_o < n, torch.gather(min_id, 1, lab_o.clamp(max=n - 1)),
                         n).int()
    if not defer_unpermute:
        rows_ = torch.gather(adj, 1, inv[..., None].expand(bsz, n, n))
        adj = torch.gather(rows_, 2, inv[:, None, :].expand(bsz, n, n))
    adj = _reconnect(adj, kpts, labels, kept, reconnect_impl, reconnect_buckets,
                     scatter_map=inv if defer_unpermute else None)

    kept_o = kept[:, :n_in]
    labels_o = torch.clamp(labels[:, :n_in], max=n_in)
    if defer_unpermute:
        # rows of invalid and pruned nodes are all False, so a composed
        # gather never needs clamping
        out = AGCGraph(adj, kept_o, labels_o, threshold, inv[:, :n_in])
    else:
        out = AGCGraph(adj[:, :n_in, :n_in], kept_o, labels_o, threshold)
    return _unbatch(out) if single else out


def band_coverage(kpts: torch.Tensor, valid: torch.Tensor, radius: float,
                  band_halfwidth: int) -> dict:
    """Audit the band build's window assumption on keypoint sets.

    Counts the within-`radius` candidate pairs (the dense build's edge
    candidates, reference: agc.py:436) and how many of them fall outside
    the sorted-x index window: the pairs ``build_graph_band`` drops. O(N^2)
    bool work, for tests and checks, not the hot path. kpts (N, 2) or
    (B, N, 2) summed over the batch. Returns {"pairs_in_radius",
    "pairs_outside_window", "coverage"}."""
    if kpts.dim() == 2:
        kpts, valid = kpts[None], valid[None]
    n = kpts.shape[1]
    idx = torch.arange(n, device=kpts.device)
    upper = valid[:, :, None] & valid[:, None, :] & (idx[:, None] < idx[None, :])
    in_radius = upper & (pairwise_sq_dists(kpts) <= _f32_square(radius))
    sort_key = torch.where(valid, kpts[..., 0], BIG)
    rank = torch.argsort(torch.argsort(sort_key, dim=1, stable=True), dim=1, stable=True)
    gap = (rank[:, :, None] - rank[:, None, :]).abs()
    total = int(in_radius.sum())
    out = int((in_radius & (gap > band_halfwidth)).sum())
    return {"pairs_in_radius": total, "pairs_outside_window": out,
            "coverage": float(1.0 - out / total) if total > 0 else 1.0}


def delaunay_adjacency_host(kpts, valid) -> np.ndarray:
    """Host-side Delaunay adjacency of one keypoint set (D-GIMS).

    Reference: agc.py:718-752. scipy's Delaunay over the valid keypoints;
    the simplex edges scattered into a dense (N, N) bool matrix. All nodes
    are kept (the reference's own Delaunay inference path raises a
    NameError at gmatcher.py:250)."""
    from scipy.spatial import Delaunay

    kpts = np.asarray(kpts)
    valid = np.asarray(valid, bool)
    n = kpts.shape[0]
    adj = np.zeros((n, n), dtype=bool)
    pts_idx = np.nonzero(valid)[0]
    if pts_idx.shape[0] >= 3:
        s = Delaunay(kpts[pts_idx]).simplices  # (T, 3) indices into pts_idx
        for a, b in ((0, 1), (0, 2), (1, 2)):
            ia, ib = pts_idx[s[:, a]], pts_idx[s[:, b]]
            adj[ia, ib] = True
            adj[ib, ia] = True
    return adj
