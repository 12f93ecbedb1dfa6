"""The dense AGC build with its keypoint axis split over ranks.

Counterpart of ``graph.build_graph`` under the JAX package's keypoint
sharding (``gims_tpu/matcher/sharded.py``), where XLA's partitioner splits
``gims_tpu/agc/graph.py::build_graph`` along the rows of its (N, N)
matrices. PyTorch has no partitioner, so each collective is written here.
Every rank of a ``torch.distributed`` group of P ranks passes the same whole
keypoint sets (B, N, .); rank r owns rows [r N/P, (r+1) N/P) of the
distances, similarities and adjacency and makes no other (N, N) tensor. The
collectives go through ``train/multihost.py`` (under gloo, CUDA tensors are
staged through the host):

  * the percentile threshold (exact, and the strided approximation): an
    exact radix select of the k-th smallest similarity, four passes of an
    8-bit digit of each value's order-preserving 32-bit key, each a local
    histogram of 256 bins and one all-reduce (``kth_smallest_sharded``);
  * the isolated-node fix: an all-reduce of "has an edge" and all-gathers
    of the (B, N) isolated flags and nearest neighbours;
  * the label rounds (``propagate_rows``): each round takes the neighbour
    minimum of the rank's rows, all-gathers the (B, N) labels and runs the
    three pointer jumps on the whole vector, stopping as the plain rounds
    of ``labels.py`` stop; small components are pruned from the gathered
    labels, the same on every rank;
  * the reconnect: the component ids and centroids (O(N)) are computed
    whole on every rank; the (C+1, C+1) and (C+1, N) component tables are
    split by components and their argmins all-gathered; the link endpoints
    over nodes are first argmins across ranks (the minimum, then the lowest
    global index that holds it); each rank writes the links that fall in
    its rows.

Every rank ends with the same kept mask, labels and threshold, and its own
rows of the adjacency. They equal ``build_graph``'s wherever the rank's
similarity rows round as the rows of the whole matrix product do (the same
matrix product kernel, row by row).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from gims_tpu_torch.agc.graph import (
    BIG,
    AGCGraph,
    _component_links_head,
    _f32_rank,
    _f32_square,
    _first_min_index,
    _nearest_component,
    _normalize_rows,
    _prune_small,
    check_impls,
    percentile_k,
)
from gims_tpu_torch.agc.labels import _jump3
from gims_tpu_torch.train import multihost as mh

_SIGN = -2 ** 31
# elements of a row chunk in one histogram pass of the radix select
_CHUNK = 1 << 24


def row_block(n: int, group) -> tuple:
    """(first row, rows) of this rank's block of an axis of length n; n must
    be divisible by the group's size."""
    p, r = mh.world_size(group), mh.rank(group)
    if n % p:
        raise ValueError(f"N={n} must be divisible by the {p} keypoint shards")
    return r * (n // p), n // p


def _order_keys(values: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 keys whose unsigned bit patterns order as the floats."""
    bits = values.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, ~bits, bits ^ _SIGN)


def _from_keys(keys: torch.Tensor) -> torch.Tensor:
    return torch.where(keys < 0, keys ^ _SIGN, ~keys).view(torch.float32)


def kth_smallest_sharded(values: torch.Tensor, mask: torch.Tensor, k_of_count, group):
    """The exact k-th (0-indexed) smallest of the masked values of every
    rank, per item; 0.0 where no rank has a masked value.

    values (B, R, N) f32 and mask (B, R, N) bool are this rank's rows;
    `k_of_count` maps the (B,) global count of masked values to the rank
    (B,) int64, the same on every rank. Four passes, from the most
    significant byte of each value's order-preserving key: each counts the
    candidates' digits in 256 bins (rows in chunks), all-reduces the counts
    and keeps the bin that holds the k-th. Returns the value itself, bit for
    bit, as a sort of the whole set reads it (``graph.kth_smallest_masked``).
    """
    b, rows, n = values.shape
    dev = values.device
    step = max(1, _CHUNK // max(1, b * n))
    prefix = torch.zeros(b, dtype=torch.int64, device=dev)  # the key's leading bytes
    k = count = None
    item = torch.arange(b, device=dev)[:, None, None] * 256
    for p in range(4):
        shift = 24 - 8 * p
        hist = torch.zeros(2 * b * 256, dtype=torch.int64, device=dev)
        for c in range(0, rows, step):
            key = _order_keys(values[:, c:c + step])
            sel = mask[:, c:c + step]
            if p:
                top = (key >> (shift + 8)) & ((1 << (8 * p)) - 1)
                sel = sel & (top == prefix[:, None, None])
            # candidates count in the first B*256 bins; the rest spread over
            # the second half, so that no single bin takes every atomic
            idx = ((key >> shift) & 255).long() + item + torch.where(sel, 0, b * 256)
            flat = idx.reshape(-1)
            hist.scatter_add_(0, flat, torch.ones(1, dtype=torch.int64,
                                                  device=dev).expand_as(flat))
        hist = mh.all_reduce(hist[: b * 256].view(b, 256), "sum", group)
        if p == 0:
            count = hist.sum(dim=1)
            k = torch.minimum(k_of_count(count).clamp(min=0), (count - 1).clamp(min=0))
        cum = hist.cumsum(dim=1)
        digit = (cum <= k[:, None]).sum(dim=1).clamp(max=255)
        k = k - (torch.gather(cum, 1, digit[:, None]) - torch.gather(hist, 1, digit[:, None]))[:, 0]
        prefix = prefix * 256 + digit
    key = torch.where(prefix >= 2 ** 31, prefix - 2 ** 32, prefix).int()
    return torch.where(count > 0, _from_keys(key), 0.0)


def propagate_rows(adj_rows: torch.Tensor, valid: torch.Tensor, rounds: int, r0: int,
                   group) -> torch.Tensor:
    """``labels.propagate("dense", ...)`` over row blocks: adj_rows (B, R, N)
    bool is this rank's rows [r0, r0 + R), valid (B, N) whole. Each round
    takes its rows' neighbour minimum, all-gathers the labels and jumps
    three times on the whole vector; the rounds stop as ``labels._run_plain``
    stops (every rank holds the same labels, so every rank stops together).
    Returns the (B, N) int32 labels, bit-equal to the unsharded rounds."""
    n = valid.shape[1]
    rows = adj_rows.shape[1]
    small = torch.int16 if n < 2 ** 15 else torch.int32
    valid_rows = valid[:, r0:r0 + rows]

    def one_round(label):
        neigh = torch.where(adj_rows, label.to(small)[:, None, :], n).amin(dim=-1)
        mine = torch.minimum(label[:, r0:r0 + rows], torch.where(valid_rows, neigh.int(), n))
        return _jump3(mh.all_gather_cat(mine, 1, group), n)

    idx = torch.arange(n, dtype=torch.int32, device=valid.device)
    label = one_round(torch.where(valid, idx, n))
    settled = torch.zeros(valid.shape[0], dtype=torch.bool, device=valid.device)
    for _ in range(rounds):
        new = one_round(label)
        settled |= (new == label).all(dim=1)
        if bool(settled.all()):
            break
        label = new
    return label


def _first_min_last(values: torch.Tensor, mask: torch.Tensor):
    """``graph._first_min_index`` over the last axis, its first index found
    by an argmax of the hits (the first maximum), which makes no int64
    table of the values' shape."""
    mn = torch.where(mask, values, BIG).amin(dim=-1, keepdim=True)
    hit = mask & (values == mn)
    return mn[..., 0], _first_true(hit)


def _first_true(hit: torch.Tensor) -> torch.Tensor:
    """The index of the first True along the last axis; its length where none."""
    return torch.where(hit.any(dim=-1), hit.to(torch.uint8).argmax(dim=-1), hit.shape[-1])


def _split(c: int, group):
    """This rank's block [l0, l1) of an axis of length c split in P blocks
    of ceil(c / P) (the last ones shorter, or empty)."""
    per = -(-c // mh.world_size(group))
    l0 = min(mh.rank(group) * per, c)
    return l0, min(l0 + per, c), per


def _gather_split(part: torch.Tensor, c: int, per: int, fill: int, group) -> torch.Tensor:
    """The (B, c) whole of every rank's (B, l1 - l0) block of ``_split``."""
    pad = part.new_full((part.shape[0], per - part.shape[1]), fill)
    return mh.all_gather_cat(torch.cat([part, pad], dim=1), 1, group)[:, :c]


def _nearest_component_split(group):
    """``graph._nearest_component`` over each rank's block of components
    (a (C+1)/P by C+1 table), all-gathered."""
    def nearest(cent, comp_ok):
        c1 = cent.shape[1]
        l0, l1, per = _split(c1, group)
        return _gather_split(_nearest_component(cent, comp_ok, l0, l1), c1, per, c1 + 1, group)
    return nearest


def _first_min_across(values: torch.Tensor, mask: torch.Tensor, r0: int, n: int, group):
    """(min, first argmin) over dim 1 of this rank's rows [r0, ...) of a
    masked (B, R, C) table, across ranks: the minimum, then the lowest
    global row that holds it; sentinel n."""
    mn_loc, arg_loc = _first_min_index(values, mask, dim=1)
    mn = mh.all_reduce(mn_loc, "min", group)
    cand = torch.where((mn_loc == mn) & (arg_loc < values.shape[1]), arg_loc + r0, n)
    return mn, mh.all_reduce(cand, "min", group)


def _segment_min(data: torch.Tensor, seg: torch.Tensor, num: int, fill) -> torch.Tensor:
    """out[b, s] = min of data[b, i] with seg[b, i] == s, `fill` where none."""
    out = torch.full((data.shape[0], num), fill, dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(1, seg, data, "amin", include_self=True)


def _set_links_rows(adj_rows, u_l, v_l, ok, r0):
    """``graph._set_links`` on this rank's rows [r0, r0 + R): both directions
    of every link, each written by the rank that owns its row."""
    b, rows, n = adj_rows.shape
    base = torch.arange(b, device=adj_rows.device)[:, None] * (rows * n)
    lin, src = [], []
    for a, c in ((u_l, v_l), (v_l, u_l)):
        lin.append(base + (a - r0).clamp(0, rows - 1) * n + c)
        src.append(ok & (a >= r0) & (a < r0 + rows))
    flat = adj_rows.to(torch.uint8).reshape(-1)
    flat.scatter_reduce_(0, torch.cat(lin).reshape(-1),
                         torch.cat(src).reshape(-1).to(torch.uint8), "amax")
    return flat.view(adj_rows.shape).bool()


def _reconnect_rows(adj_rows, kpts, d2_rows, labels, kept, r0, group, buckets=4096):
    """``graph._reconnect_components`` (each surviving component links to
    its nearest component by centroid through the closest node pair) on
    row blocks. v*(l), the first v of component nnc[l] that some u of l
    reaches at the least distance m*(l): each rank takes m* and then the
    first such v over its rows, both reduced across ranks with min; u*(l),
    the first u of l nearest to v*(l): the same over each rank's rows."""
    b, n = kept.shape
    rows = adj_rows.shape[1]
    C = min(n, int(buckets))
    lab, _, _, nnc_safe, link_ok = _component_links_head(kpts, labels, kept, C,
                                                         _nearest_component_split(group))
    lab_rows = lab[:, r0:r0 + rows]
    kept_rows = kept[:, r0:r0 + rows]

    # the target component of each row's component
    tgt = torch.gather(nnc_safe, 1, lab_rows)
    tmask = kept_rows[:, :, None] & kept[:, None, :] & (lab[:, None, :] == tgt[:, :, None])
    row_min = torch.where(tmask, d2_rows, BIG).amin(dim=-1)
    m_star = mh.all_reduce(_segment_min(row_min, lab_rows, C + 1, BIG), "min", group)
    v_row = _first_true(tmask & (d2_rows == torch.gather(m_star, 1, lab_rows)[:, :, None]))
    v_l = mh.all_reduce(_segment_min(v_row, lab_rows, C + 1, n), "min", group)
    v_l_safe = torch.clamp(v_l, max=n - 1)

    # u*(l): the first kept u of l nearest to v*(l)
    dcol = torch.gather(d2_rows, 2, torch.gather(v_l_safe, 1, lab_rows)[:, :, None])[..., 0]
    dcol = torch.where(kept_rows, dcol, BIG)
    u_min = mh.all_reduce(_segment_min(dcol, lab_rows, C + 1, BIG), "min", group)
    u_row = torch.where(kept_rows & (dcol == torch.gather(u_min, 1, lab_rows)),
                        torch.arange(r0, r0 + rows, device=kpts.device), n)
    u_l = mh.all_reduce(_segment_min(u_row, lab_rows, C + 1, n), "min", group)
    u_l_safe = torch.clamp(u_l, max=n - 1)
    ok = link_ok & (v_l < n) & (u_l < n)
    return _set_links_rows(adj_rows, u_l_safe, v_l_safe, ok, r0)


def _reconnect_centroid_rows(adj_rows, kpts, labels, kept, r0, group, buckets=1024):
    """``graph._reconnect_components_centroid`` on row blocks: v*, the
    target's node nearest to our centroid, from each rank's block of
    components of the (C+1, N) table, all-gathered; u*, our node nearest to
    v*, a first argmin across ranks over each rank's rows of the (N, C+1)
    table."""
    b, n = kept.shape
    rows = adj_rows.shape[1]
    C = min(n, int(buckets))
    lab, comp_ids, cent, nnc_safe, link_ok = _component_links_head(
        kpts, labels, kept, C, _nearest_component_split(group))
    k2 = torch.sum(kpts * kpts, dim=-1)
    l0, l1, per = _split(C + 1, group)
    c_blk = cent[:, l0:l1]
    dt = (torch.sum(c_blk * c_blk, dim=-1)[:, :, None]
          - 2.0 * torch.matmul(c_blk, kpts.transpose(1, 2)) + k2[:, None, :])
    tgt_mask = (lab[:, None, :] == nnc_safe[:, l0:l1, None]) & kept[:, None, :]
    v_l = _gather_split(_first_min_index(dt, tgt_mask, dim=2)[1], C + 1, per, n, group)
    v_l_safe = torch.clamp(v_l, max=n - 1)

    pv = torch.gather(kpts, 1, v_l_safe[..., None].expand(b, C + 1, 2))
    kp_rows = kpts[:, r0:r0 + rows]
    du = (k2[:, r0:r0 + rows, None] - 2.0 * torch.matmul(kp_rows, pv.transpose(1, 2))
          + torch.sum(pv * pv, dim=-1)[:, None, :])
    src_mask = ((lab[:, r0:r0 + rows, None] == comp_ids[None, None, :])
                & kept[:, r0:r0 + rows, None])
    _, u_l = _first_min_across(du, src_mask, r0, n, group)
    u_l_safe = torch.clamp(u_l, max=n - 1)
    ok = link_ok & (v_l < n) & (u_l < n)
    return _set_links_rows(adj_rows, u_l_safe, v_l_safe, ok, r0)


def build_graph_sharded(
    kpts: torch.Tensor,
    descs: torch.Tensor,
    valid: torch.Tensor,
    radius: float,
    percentile: float,
    min_size: int,
    group,
    cc_rounds: int = 20,
    k: Optional[Union[int, Sequence[int], torch.Tensor]] = None,
    threshold_impl: str = "exact",
    threshold_stride: int = 4,
    cc_impl: str = "dense",
    reconnect_impl: str = "exact",
    reconnect_buckets: int = 4096,
) -> AGCGraph:
    """``graph.build_graph`` with the keypoint axis split over `group`.

    kpts (B, N, 2), descs (B, N, D), valid (B, N): the same whole sets on
    every rank, N divisible by the group's size. Returns an AGCGraph whose
    adj is this rank's rows (B, N/P, N) and whose kept, labels and threshold
    are whole and equal on every rank. ``cc_impl="sparse"`` is not ported
    sharded and raises."""
    check_impls(threshold_impl=threshold_impl, cc_impl=cc_impl,
                reconnect_impl=reconnect_impl)
    if cc_impl == "sparse":
        raise NotImplementedError("cc_impl='sparse' under keypoint sharding is not ported; "
                                  "see ROADMAP.md")
    bsz, n = valid.shape
    r0, rows = row_block(n, group)
    dev = kpts.device
    idx = torch.arange(n, device=dev)
    ridx = idx[r0:r0 + rows]
    valid_rows = valid[:, r0:r0 + rows]
    pair_valid = valid_rows[:, :, None] & valid[:, None, :]
    off_diag = ridx[:, None] != idx[None, :]

    # graph.pairwise_sq_dists of this rank's rows, without its (., N, 2)
    # differences: the same sums of two squares
    dx = kpts[:, r0:r0 + rows, None, 0] - kpts[:, None, :, 0]
    d2 = dx * dx
    dy = kpts[:, r0:r0 + rows, None, 1] - kpts[:, None, :, 1]
    d2 += dy * dy
    del dx, dy
    normed = _normalize_rows(descs)
    sim = torch.matmul(normed[:, r0:r0 + rows], normed.transpose(-1, -2))

    # --- percentile threshold over the valid upper triangle of every rank ---
    triu = pair_valid & (ridx[:, None] < idx[None, :])
    if threshold_impl == "approx" and threshold_stride > 1:
        # every stride-th global row, as sim[:, ::s]
        sub = (ridx % int(threshold_stride)) == 0
        threshold = kth_smallest_sharded(
            sim[:, sub], triu[:, sub], lambda cnt: _f32_rank(cnt, percentile), group)
    else:
        if k is None:
            k = percentile_k(valid.sum(dim=1), percentile)
        else:
            k = torch.as_tensor(k, device=dev).reshape(bsz).long()
        threshold = kth_smallest_sharded(sim, triu, lambda cnt: k, group)
    del triu

    # --- candidate edges of this rank's rows ---
    pvod = pair_valid & off_diag
    adj = pvod & (d2 <= _f32_square(radius)) & (sim >= threshold[:, None, None])
    del sim

    # --- isolated nodes to their nearest spatial neighbour ---
    degree = adj.sum(dim=2)
    has_any_edge = mh.all_reduce(adj.flatten(1).any(dim=1), "max", group)
    isolated_rows = valid_rows & (degree == 0) & has_any_edge[:, None]
    _, nn_rows = _first_min_last(d2, pvod)
    nn_rows = torch.clamp(nn_rows, max=n - 1)
    isolated = mh.all_gather_cat(isolated_rows, 1, group)
    nn_idx = mh.all_gather_cat(nn_rows, 1, group)
    fix = torch.zeros_like(adj).scatter_(2, nn_rows[..., None], isolated_rows[..., None])
    # fix.T's rows: node j's fix edge lands in row nn_idx[j]
    fix_t = isolated[:, None, :] & (nn_idx[:, None, :] == ridx[None, :, None])
    adj = adj | fix | fix_t
    del fix, fix_t, pvod, pair_valid

    # --- components and pruning, on the gathered labels ---
    labels = propagate_rows(adj, valid, cc_rounds, r0, group)
    kept = _prune_small(labels, valid, min_size)
    adj = adj & kept[:, r0:r0 + rows, None] & kept[:, None, :]

    if reconnect_impl == "centroid":
        adj = _reconnect_centroid_rows(adj, kpts, labels, kept, r0, group, reconnect_buckets)
    else:
        adj = _reconnect_rows(adj, kpts, d2, labels, kept, r0, group, reconnect_buckets)
    return AGCGraph(adj, kept, labels, threshold)
