"""Connected-component labels of AGC's graphs, rounds that stop early.

Min-label propagation with pointer jumping, as ``connected_components``,
``connected_components_band`` and ``connected_components_sparse`` of
``gims_tpu/agc/graph.py`` run it: a first round, then up to `rounds` more,
stopping after the first round that changes no label (JAX's
``lax.while_loop``). Each component ends labelled by its minimum node
index, invalid nodes by N. One round is

  * a neighbour step over the graph, in one of three layouts:
    - "dense": adj (B, N, N) bool; a node takes the minimum label of its
      row's neighbours;
    - "band": a forward band (B, N, Wh) bool, band[i, m] = edge(i, i+1+m)
      (``agc/band.py``); a node takes the minimum over its forward and its
      backward neighbours, both read from the labels before the step;
    - "sparse": a neighbour list nbr_idx (B, N, D) int with nbr_ok (B, N, D)
      bool; a node pulls the minimum label of its listed neighbours, then
      pushes its new label to them (so an edge kept by either end joins
      both);
  * three pointer jumps, label = min(label, label[label]).

On a CUDA tensor ``propagate`` launches the hand-written kernel
(``csrc/labels.cu``), every round on the card with no question to the host.
``plan`` gives its route for a shape: the cluster route (one graph per
thread-block cluster, the labels in shared memory, each graph stopping at
its own first unchanged round; the dense and band layouts read once as
bytes, then as bits) wherever a graph's labels fit in shared memory (N up
to 27,264 in every layout on an H100: every AGC bucket), else the global
route (the labels in device memory, one cooperative launch). On a CPU tensor it
runs the plain version, ``propagate_plain``, which asks its host loop
whether a round changed anything; ``rounds_plain`` gives the rounds each
graph runs, as ``last_rounds`` holds them after a launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gims_tpu_torch import _build
from gims_tpu_torch.agc.band import _band_shear_bwd, _window_values_bwd, _window_values_fwd

MODES = {"dense": 0, "band": 1, "sparse": 2}

# calls of propagate that launched the kernel (one launch runs every round;
# the dense layout's cluster route launches a packing kernel before it)
launches = 0
# (B,) int32 on the card: the rounds each graph of the last launch ran
# (not synchronised)
last_rounds: Optional[torch.Tensor] = None
# (B, cluster size) int32 on the card, after a launch of the dense or band
# layout's cluster route (else None): 1 where a block listed its rows'
# neighbours in shared memory, 0 where it read their bits every round
last_listed: Optional[torch.Tensor] = None
PLAN_FIELDS = ("cluster", "cluster_size", "rows_per_block", "resident_clusters",
               "smem_bytes", "scratch_words", "list_capacity")


def _jump3(label: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(3):
        safe = torch.clamp(label, max=n - 1).long()
        jumped = torch.where(label < n, torch.gather(label, 1, safe), n)
        label = torch.minimum(label, jumped)
    return label


def _round_fn(mode: str, edges: torch.Tensor, valid: torch.Tensor,
              nbr_idx: Optional[torch.Tensor]):
    n = valid.shape[1]
    if mode == "dense":
        # the (B, N, N) neighbour labels in int16 where N fits: half the bytes
        small = torch.int16 if n < 2 ** 15 else torch.int32

        def one_round(label):
            neigh = torch.where(edges, label.to(small)[:, None, :], n).amin(dim=-1)
            return _jump3(torch.minimum(label, torch.where(valid, neigh.int(), n)), n)
    elif mode == "band":
        wh = edges.shape[2]
        bwd = _band_shear_bwd(edges)

        def one_round(label):
            pulled = torch.where(edges, _window_values_fwd(label, wh, n), n).amin(dim=-1)
            pushed = torch.where(bwd, _window_values_bwd(label, wh, n), n).amin(dim=-1)
            label = torch.minimum(label, torch.minimum(pulled, pushed))
            return _jump3(torch.where(valid, label, n), n)
    elif mode == "sparse":
        b, _, d = nbr_idx.shape
        safe_nbr = torch.clamp(nbr_idx, max=n - 1).long().reshape(b, -1)
        push_tgt = torch.where(edges, nbr_idx.long(), n).reshape(b, -1)

        def one_round(label):
            pulled = torch.where(edges, torch.gather(label, 1, safe_nbr).view(b, n, d),
                                 n).amin(dim=-1)
            label = torch.minimum(label, torch.where(valid, pulled, n))
            src = label[:, :, None].expand(b, n, d).reshape(b, -1)
            pushed = torch.full((b, n + 1), n, dtype=label.dtype, device=label.device)
            pushed.scatter_reduce_(1, push_tgt, src, "amin", include_self=True)
            label = torch.minimum(label, torch.where(valid, pushed[:, :n], n))
            return _jump3(label, n)
    else:
        raise ValueError(f"label propagation mode {mode!r}: one of {sorted(MODES)}")
    return one_round


def _run_plain(mode, edges, valid, rounds, nbr_idx):
    """(labels, rounds run per graph): the batch runs until no graph changes;
    a graph's count stops at its first unchanged round after the first (a
    round that changes nothing leaves a fixed point, so the later rounds
    change nothing either)."""
    n = valid.shape[1]
    one_round = _round_fn(mode, edges, valid, nbr_idx)
    idx = torch.arange(n, dtype=torch.int32, device=valid.device)
    label = one_round(torch.where(valid, idx, n))
    run = torch.ones(valid.shape[0], dtype=torch.int32, device=valid.device)
    settled = torch.zeros(valid.shape[0], dtype=torch.bool, device=valid.device)
    for _ in range(rounds):
        new = one_round(label)
        run += (~settled).int()
        settled |= (new == label).all(dim=1)
        if bool(settled.all()):
            break
        label = new
    return label, run


def propagate_plain(mode: str, edges: torch.Tensor, valid: torch.Tensor, rounds: int,
                    nbr_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of ``propagate``. Returns (B, N) int32."""
    return _run_plain(mode, edges, valid, rounds, nbr_idx)[0]


def rounds_plain(mode: str, edges: torch.Tensor, valid: torch.Tensor, rounds: int,
                 nbr_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) int32: the rounds each graph runs alone, from 1 to 1 + rounds, as
    ``last_rounds`` holds them after a launch."""
    return _run_plain(mode, edges, valid, rounds, nbr_idx)[1]


def plan(mode: str, b: int, n: int, w: int, rounds: int) -> dict:
    """The kernel's route on the current card for (B, N, W) edges: ``cluster``
    (1: the cluster route, 0: the global route), ``cluster_size``,
    ``rows_per_block``, ``resident_clusters``, ``smem_bytes`` (per block),
    ``scratch_words`` (int32) and ``list_capacity`` (the neighbour-list
    entries a block of the dense or band layout holds), as ``csrc/labels.cu``'s plan()
    chooses them."""
    if mode not in MODES:
        raise ValueError(f"label propagation mode {mode!r}: one of {sorted(MODES)}")
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    rc = _build.load().gims_label_plan(MODES[mode], b, n, w, int(rounds), out)
    if rc != 0:
        raise RuntimeError(f"gims_label_plan failed: cudaError {rc}")
    return dict(zip(PLAN_FIELDS, out))


def propagate(mode: str, edges: torch.Tensor, valid: torch.Tensor, rounds: int,
              nbr_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Labels of the components of a batch of graphs, (B, N) int32.

    edges: adj (B, N, N), a forward band (B, N, Wh) or nbr_ok (B, N, D), bool;
    valid (B, N) bool; nbr_idx (B, N, D) int for "sparse". A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    global launches, last_rounds, last_listed
    if mode not in MODES:
        raise ValueError(f"label propagation mode {mode!r}: one of {sorted(MODES)}")
    if edges.device.type == "cpu":
        return propagate_plain(mode, edges, valid, rounds, nbr_idx)
    if edges.device.type != "cuda":
        raise ValueError(f"propagate: unsupported device {edges.device}")
    if edges.dim() != 3 or valid.dim() != 2 or edges.shape[:2] != valid.shape:
        raise ValueError(f"edges {tuple(edges.shape)} and valid {tuple(valid.shape)} "
                         "must be (B, N, W) and (B, N)")
    b, n, w = edges.shape
    if mode == "dense" and w != n:
        raise ValueError(f"dense adjacency must be square, got {tuple(edges.shape)}")
    for name, t in (("edges", edges), ("valid", valid)):
        if t.dtype != torch.bool:
            raise TypeError(f"{name} must be bool, got {t.dtype}")
        if t.device != edges.device:
            raise ValueError(f"{name} is on {t.device}, edges on {edges.device}")
    edges, valid = edges.contiguous(), valid.contiguous()
    nbr_ptr = 0
    if mode == "sparse":
        if nbr_idx is None or nbr_idx.shape != edges.shape:
            raise ValueError("sparse propagation needs nbr_idx of the shape of nbr_ok")
        nbr_idx = nbr_idx.to(device=edges.device, dtype=torch.int32).contiguous()
        nbr_ptr = nbr_idx.data_ptr()
    if rounds < 0 or b * n >= 2 ** 31 or b * n * w >= 2 ** 62:
        raise ValueError(f"propagate: rounds {rounds}, B*N {b * n} out of range")
    with torch.cuda.device(edges.device):
        p = plan(mode, b, n, w, rounds)
        labels = torch.empty((b, n), dtype=torch.int32, device=edges.device)
        run = torch.empty(b, dtype=torch.int32, device=edges.device)
        listed = None
        if p["cluster"] and mode != "sparse":
            listed = torch.empty((b, p["cluster_size"]), dtype=torch.int32, device=edges.device)
        # the dense and band layouts' bits, or the global route's label buffers and flags
        scratch = torch.empty(max(p["scratch_words"], 4), dtype=torch.int32,
                              device=edges.device)
        stream = torch.cuda.current_stream(edges.device).cuda_stream
        rc = _build.load().gims_label_rounds(
            MODES[mode], edges.data_ptr(), nbr_ptr, valid.data_ptr(), labels.data_ptr(),
            run.data_ptr(), 0 if listed is None else listed.data_ptr(), scratch.data_ptr(),
            scratch.numel(), b, n, w, int(rounds), stream)
    if rc != 0:
        raise RuntimeError(f"gims_label_rounds failed: cudaError {rc}")
    launches += 1
    last_rounds, last_listed = run, listed
    return labels
