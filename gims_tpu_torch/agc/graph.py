"""Adaptive Graph Construction (AGC), dense build.

Port of the dense path of ``gims_tpu/agc/graph.py`` (reference:
models/agc.py:682-709):

  1. spatial candidate edges: all pairs within `radius`;
  2. keep candidates whose descriptor cosine similarity >= the
     `percentile`-th order statistic of all valid upper-triangle
     similarities;
  3. connect isolated nodes to their nearest spatial neighbor;
  4. mask out connected components smaller than `min_size`;
  5. one pass linking each surviving component to its nearest-centroid
     neighbor component through the closest node pair.

Every function takes a batch of keypoint sets with a leading batch axis
(``build_graph`` also takes one set without it). Adjacency is a dense
(B, N, N) bool tensor. This is ``AGCConfig()``'s default build
(dense / exact / dense / exact); the band build, sparse components, the
approximate threshold and the centroid reconnect are not ported yet.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

BIG = 3.0e38


class AGCGraph(NamedTuple):
    adj: torch.Tensor        # (B, N, N) bool symmetric adjacency, no self loops
    kept: torch.Tensor       # (B, N) bool: valid AND survived min_size pruning
    labels: torch.Tensor     # (B, N) int32 component label (min node id; N = invalid)
    threshold: torch.Tensor  # (B,) f32 cosine threshold used


def pairwise_sq_dists(kpts: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) -> (..., N, N) squared distances, by explicit
    differencing (not |x|^2 - 2xy + |y|^2) for radius tests in f32."""
    d = kpts[..., :, None, :] - kpts[..., None, :, :]
    return torch.sum(d * d, dim=-1)


def cosine_similarity_matrix(descs: torch.Tensor) -> torch.Tensor:
    """(..., N, D) -> (..., N, N) cosine similarity; rows are divided by
    max(||x||, 1e-12) (reference: agc.py:382-391)."""
    norm = torch.sqrt(torch.sum(descs * descs, dim=-1, keepdim=True))
    normed = descs / torch.clamp(norm, min=1e-12)
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


def percentile_k(num_valid: torch.Tensor, percentile: float) -> torch.Tensor:
    """In-graph rank rule of the JAX build when no rank is passed, on the
    device: the pair count times percentile/100 in f32, floored and
    clipped. num_valid (B,) int; returns (B,) int64."""
    nv = num_valid.long()
    count = nv * (nv - 1) // 2
    pct = torch.full(count.shape, float(np.float32(percentile / 100.0)),
                     dtype=torch.float32, device=count.device)
    k = torch.floor(count.float() * pct).long()
    k = torch.where(k >= count, count - 1, k)
    return k.clamp(min=0)


def connected_components(adj: torch.Tensor, valid: torch.Tensor,
                         rounds: int) -> torch.Tensor:
    """Min-label propagation with pointer jumping.

    adj (B, N, N) bool, valid (B, N). Returns (B, N) int32 labels: each
    component is labeled by its minimum node index, invalid nodes by N.
    Runs one round and then `rounds` more, all on the device. The JAX
    build stops early once a round changes no label; a round of converged
    labels changes none (each node already holds its component's minimum,
    and so does every neighbour), so the fixed count gives the same labels
    without asking the host whether to go on.
    """
    n = adj.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=adj.device)
    label = torch.where(valid, idx, n)
    # the (B, N, N) neighbour labels in int16 where N fits: half the bytes
    small = torch.int16 if n < 2 ** 15 else torch.int32

    def one_round(label):
        neigh = torch.where(adj, label.to(small)[:, None, :], n).amin(dim=-1)
        label = torch.minimum(label, torch.where(valid, neigh.int(), n))
        for _ in range(3):
            safe = torch.clamp(label, max=n - 1).long()
            jumped = torch.where(label < n, torch.gather(label, 1, safe), n)
            label = torch.minimum(label, jumped)
        return label

    for _ in range(rounds + 1):
        label = one_round(label)
    return label


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
    """Per-batch segment sum: out[b, s] = sum of data[b, i] with seg[b, i] == s."""
    out = torch.zeros((data.shape[0], num), dtype=data.dtype, device=data.device)
    return out.scatter_add_(1, seg, data)


def _component_links_head(kpts, labels, kept, C):
    """Rank-compacted component ids, centroids, each component's nearest
    component, and the link skip rule (reference: agc.py:518-565)."""
    b, n = kept.shape
    dev = kpts.device
    idx = torch.arange(n, device=dev)
    safe_labels = torch.clamp(labels, max=n - 1).long()
    is_rep = kept & (labels == idx)
    rank = torch.clamp(torch.cumsum(is_rep.long(), dim=1) - 1, 0, C - 1)
    lab = torch.where(kept, torch.gather(rank, 1, safe_labels),
                      torch.full_like(rank, C))  # component id in [0, C]

    keptf = kept.float()
    cnt = _segment_sum(keptf, lab, C + 1)
    comp_ok = cnt > 0
    comp_ok[:, C] = False
    num_comps = comp_ok.sum(dim=1)
    sx = _segment_sum(torch.where(kept, kpts[..., 0], 0.0), lab, C + 1)
    sy = _segment_sum(torch.where(kept, kpts[..., 1], 0.0), lab, C + 1)
    cent = torch.stack([sx, sy], dim=-1) / torch.clamp(cnt, min=1.0)[..., None]

    cd = cent[:, :, None, :] - cent[:, None, :, :]
    cd2 = torch.sum(cd * cd, dim=-1)                     # (B, C+1, C+1)
    comp_ids = torch.arange(C + 1, device=dev)
    comp_pair_ok = (comp_ok[:, :, None] & comp_ok[:, None, :]
                    & (comp_ids[:, None] != comp_ids[None, :]))
    _, nnc = _first_min_index(cd2, comp_pair_ok, dim=2)  # sentinel C+1
    nnc_safe = torch.clamp(nnc, max=C)
    # pair (l, nnc[l]) is dropped iff nnc[l] < l and it already linked back
    back = torch.gather(nnc_safe, 1, nnc_safe)
    link_ok = comp_ok & (nnc <= C) & ~((nnc < comp_ids) & (back == comp_ids))
    link_ok = link_ok & (num_comps > 1)[:, None]
    return lab, comp_ids, nnc_safe, link_ok


def _reconnect_components(adj, kpts, d2, labels, kept, buckets=4096):
    """Reference: agc.py:518-565 ``fast_connect_components``: each surviving
    component links to its nearest component (by centroid) through the
    closest node pair, in ascending label order, skipping a link whose
    reverse was already made."""
    b, n = kept.shape
    C = min(n, int(buckets))
    lab, comp_ids, nnc_safe, link_ok = _component_links_head(kpts, labels, kept, C)

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

    # set both directions of every link by a max-scatter over all (B, C+1)
    # slots, the skipped ones adding 0: no nonzero(), whose size the host
    # would have to wait for
    base = torch.arange(b, device=d2.device)[:, None] * (n * n)
    lin = torch.cat([base + u_l_safe * n + v_l_safe,
                     base + v_l_safe * n + u_l_safe]).reshape(-1)
    flat = adj.to(torch.uint8).reshape(-1)
    flat.scatter_reduce_(0, lin, torch.cat([ok, ok]).reshape(-1).to(torch.uint8),
                         "amax")
    return flat.view(b, n, n).bool()


def _check_impls(threshold_impl, cc_impl, reconnect_impl, agc_impl="dense"):
    for name, value, ported in (("agc_impl", agc_impl, "dense"),
                                ("threshold_impl", threshold_impl, "exact"),
                                ("cc_impl", cc_impl, "dense"),
                                ("reconnect_impl", reconnect_impl, "exact")):
        if value != ported:
            raise NotImplementedError(
                f"AGC {name}={value!r} is not ported yet (only {ported!r}); "
                "see ROADMAP.md")


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
    cc_impl: str = "dense",
    reconnect_impl: str = "exact",
    reconnect_buckets: int = 4096,
) -> AGCGraph:
    """Full AGC for padded keypoint sets.

    kpts (B, N, 2) f32, descs (B, N, D) f32 (unnormalized), valid (B, N)
    bool; one set without the batch axis is accepted and returned without
    it. `k` is the optional rank of the percentile threshold per set
    (``pipeline.percentile_rank`` of the valid counts); without it the rank
    follows the JAX build's in-graph f32 rule.
    """
    _check_impls(threshold_impl, cc_impl, reconnect_impl)
    single = kpts.dim() == 2
    if single:
        kpts, descs, valid = kpts[None], descs[None], valid[None]
        if k is not None:
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
    if k is None:
        k = percentile_k(valid.sum(dim=1), percentile)
    else:
        k = torch.as_tensor(k, device=dev).reshape(bsz)
    threshold = kth_smallest_masked(sim, triu, k)

    # --- candidate edges: within radius AND similarity >= threshold ---
    r2 = float(np.float32(radius) * np.float32(radius))  # f32, as JAX squares it
    adj = pair_valid & off_diag & (d2 <= r2) & (sim >= threshold[:, None, None])

    # --- connect isolated nodes to the nearest spatial neighbor ---
    degree = adj.sum(dim=2)
    has_any_edge = adj.flatten(1).any(dim=1)  # the reference skips edgeless graphs
    isolated = valid & (degree == 0) & has_any_edge[:, None]
    _, nn_idx = _first_min_index(d2, pair_valid & off_diag, dim=2)
    nn_idx = torch.clamp(nn_idx, max=n - 1)
    fix = torch.zeros_like(adj).scatter_(2, nn_idx[..., None], isolated[..., None])
    adj = adj | fix | fix.transpose(1, 2)

    # --- connected components + small-component pruning ---
    labels = connected_components(adj, valid, cc_rounds)
    safe_labels = torch.clamp(labels, max=n - 1).long()
    sizes = _segment_sum(valid.long(), safe_labels, n)
    kept = valid & (torch.gather(sizes, 1, safe_labels) >= int(min_size))
    adj = adj & kept[:, :, None] & kept[:, None, :]

    # --- reconnect surviving components ---
    adj = _reconnect_components(adj, kpts, d2, labels, kept, buckets=reconnect_buckets)
    if single:
        return AGCGraph(adj[0], kept[0], labels[0], threshold[0])
    return AGCGraph(adj, kept, labels, threshold)
