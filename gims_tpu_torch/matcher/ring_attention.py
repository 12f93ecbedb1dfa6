"""Ring attention over a keypoint-sharded group of ranks.

Port of ``gims_tpu/matcher/ring_attention.py``. The matcher's sequence
length is the keypoint count: beyond one card's memory, the keypoint axis is
split over P ranks, each holding 1/P of the queries and, at any time, 1/P
of the keys. The JAX package runs the ring under ``shard_map`` with
``lax.ppermute``; the port runs one process per rank and passes the K/V
blocks with ``torch.distributed`` point-to-point ops.

Rank r takes its row block of Q and its block of K, V and the key mask, then
runs P steps. Each step is one launch of the attention kernel's partial mode
(``cuda_attention.attention_partials_cuda``: the block's output and each
row's base-2 softmax max and sum; on the CPU its plain version), merged into
the running (out, max, sum) in f32 (``merge_partials``), while the block
moves on to rank r + 1 and rank r - 1's block arrives (``batch_isend_irecv``;
under gloo the blocks travel through host copies, under NCCL they stay on
the card). After the P steps every rank holds its rows of the output, and
the blocks are all-gathered, so every rank returns the whole output.
Forward only: the kernel has no backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from gims_tpu_torch.matcher import cuda_attention
from gims_tpu_torch.train import multihost

# the group that attention_impl="ring" dispatches over (the counterpart of
# the JAX package's ring mesh, read by masked_attention at call time)
_RING = {"group": None}


def set_ring_group(group) -> None:
    """Select the ``torch.distributed`` group of masked_attention(impl='ring');
    None clears it."""
    _RING["group"] = group


def get_ring_group():
    """The ring's group; raises ValueError if none was set."""
    if _RING["group"] is None:
        raise ValueError("attention_impl='ring' needs set_ring_group(group) first "
                         "(a torch.distributed group over the keypoint shards)")
    return _RING["group"]


def merge_partials(out_a, stats_a, out_b, stats_b):
    """Two partial attentions of the same rows over disjoint key blocks,
    merged into the attention over both: out (B, N, H, D), stats
    (B, N, H, 2) f32 of (base-2 max, sum). Returns (out, stats), out in
    f32."""
    m_a, l_a = stats_a[..., 0], stats_a[..., 1]
    m_b, l_b = stats_b[..., 0], stats_b[..., 1]
    m = torch.maximum(m_a, m_b)
    w_a = l_a * torch.exp2(m_a - m)
    w_b = l_b * torch.exp2(m_b - m)
    l = w_a + w_b
    out = (out_a.float() * w_a[..., None] + out_b.float() * w_b[..., None]) \
        / torch.clamp(l, min=1e-30)[..., None]
    return out, torch.stack([m, l], dim=-1)


@torch.no_grad()
def masked_attention_ring(q, k, v, key_mask, group: Optional[object] = None):
    """Dense-equivalent masked attention with the keypoint axis split over
    `group`'s ranks (``get_ring_group()`` where None).

    Every rank passes the full q (B, N, H, D), k, v (B, M, H, D) and
    key_mask (B, M) bool; N and M must be divisible by the world size.
    Same contract as ``attention.masked_attention_direct``: returns the full
    (B, N, H, D) in q's dtype on every rank."""
    group = group if group is not None else get_ring_group()
    p, r = multihost.world_size(group), multihost.rank(group)
    b, n, h, d = q.shape
    m = k.shape[1]
    if n % p or m % p:
        raise ValueError(f"N={n} and M={m} must be divisible by the {p} ring ranks")
    nl, ml = n // p, m // p
    q_r = q[:, r * nl:(r + 1) * nl]
    blk = (k[:, r * ml:(r + 1) * ml].contiguous(), v[:, r * ml:(r + 1) * ml].contiguous(),
           key_mask[:, r * ml:(r + 1) * ml].contiguous())
    out = stats = None
    for step in range(p):
        o_s, st_s = cuda_attention.attention_partials_cuda(q_r, *blk)
        if out is None:
            out, stats = o_s.float(), st_s
        else:
            out, stats = merge_partials(out, stats, o_s, st_s)
        if step + 1 < p:
            blk = tuple(multihost.exchange(blk, (r + 1) % p, (r - 1) % p, group))
    return multihost.all_gather_cat(out.to(q.dtype), 1, group)
