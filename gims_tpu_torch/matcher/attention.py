"""Masked multi-head attention for the GNN trunk.

Port of ``gims_tpu/matcher/attention.py``:

* ``masked_attention_direct`` materializes (B, H, N, M) scores;
* ``masked_attention_flash`` streams a softmax over key blocks, so the
  N x M score matrix never exists in full;
* ``masked_attention_tiled`` repeats the arithmetic of the TPU kernel and of
  the CUDA kernel in ``cuda_attention.py`` tile by tile. It is that kernel's
  plain version.

Scores are scaled by 1/sqrt(head_dim), masked keys get NEG_INF
(reference: models/gmatcher.py:35-39).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e9
LOG2E = 1.4426950408889634
KERNEL_BLOCK_K = 128  # keys per tile of the CUDA kernel, heads up to 128 wide
KERNEL_WIDE_BLOCK_K = 64  # keys per tile of its bf16 kernel for heads of 129-256
KERNEL_MAX_HEAD_DIM = 256  # the widest head of its column-block kernels; wide kernels beyond
# the wide-head kernels (csrc/attention.cu, wide_plan): a CTA takes at most 8
# column blocks of 64 (bf16) or 40 tiles of 8 columns (f32), a head at most a
# cluster of 16 CTAs. These copy the C code's choice, which the plain version
# needs without a card; gims_attention_key_tile is the C side, and a card test
# holds the two equal.
KERNEL_WIDE_BLOCKS = 8
KERNEL_WIDE_F32_BLOCK_K = 32  # keys per tile of the f32 wide-head kernel
KERNEL_WIDEST_HEAD = {torch.bfloat16: 16 * 8 * 64, torch.float32: 16 * 40 * 8}
FLASH_THRESHOLD = 4096
FLASH_BLOCK = 1024


def masked_attention_direct(q, k, v, key_mask):
    """q: (B, N, H, D); k, v: (B, M, H, D); key_mask: (B, M) bool."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    scores = scores.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    prob = torch.softmax(scores, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", prob, v)


def masked_attention_flash(q, k, v, key_mask, block_size=FLASH_BLOCK):
    """Streaming-softmax attention over key blocks, accumulated in f32.

    Equal to the direct path up to float rounding; never holds more than
    (B, H, N, block_size) scores.
    """
    b, n, h, d = q.shape
    m = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qt = q.permute(0, 2, 1, 3)                        # (B, H, N, D)
    acc = torch.zeros((b, h, n, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, n), dtype=torch.float32, device=q.device)
    mx = torch.full((b, h, n), NEG_INF, dtype=torch.float32, device=q.device)
    for start in range(0, m, block_size):
        kc = k[:, start:start + block_size].permute(0, 2, 1, 3)  # (B, H, C, D)
        vc = v[:, start:start + block_size].permute(0, 2, 1, 3)
        mc = key_mask[:, start:start + block_size]
        s = torch.einsum("bhnd,bhcd->bhnc", qt, kc).float() * scale
        s = s.masked_fill(~mc[:, None, None, :], NEG_INF)
        mx_new = torch.maximum(mx, s.amax(dim=-1))
        corr = torch.exp(mx - mx_new)
        p = torch.exp(s - mx_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhnc,bhcd->bhnd", p.to(q.dtype), vc).float()
        mx = mx_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)  # back to (B, N, H, D)


def kernel_block_k(d: int, dtype) -> int:
    """Keys per tile of the CUDA kernel at head width `d`: its bf16 kernel
    takes tiles of 64 keys above 128 columns (shared memory and registers);
    past 256 columns the wide-head kernels take 32 keys in f32 and, in bf16,
    48 where a CTA holds five column blocks of 64 and 32 where it holds six
    to eight (a head's nb blocks over ceil(nb / 8) CTAs, as even as they
    go). The tile sets where P is rounded against the running max. In f32
    up to 256 columns it is 128, not the CUDA kernel's 64 or 32: P stays f32
    there, and the tile moves only the order of the rescaling."""
    if d > KERNEL_MAX_HEAD_DIM:
        if dtype != torch.bfloat16:
            return KERNEL_WIDE_F32_BLOCK_K
        nb = -(-d // 64)
        nz = -(-nb // KERNEL_WIDE_BLOCKS)
        return 48 if -(-nb // nz) == 5 else 32
    return KERNEL_WIDE_BLOCK_K if dtype == torch.bfloat16 and d > 128 else KERNEL_BLOCK_K


def split_tf32(x: torch.Tensor):
    """x = hi + lo as the CUDA kernel's f32 path splits an f32 operand: hi is
    x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero:
    PTX's cvt.rna.tf32.f32), lo the rest x - hi (exact in f32) with its low
    13 bits cleared."""
    hi = ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def einsum_split_f32(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 kernel's product on the tensor cores: a and b split by
    ``split_tf32``, then lo*hi + hi*lo + hi*hi, each an exact product of
    TF32 values summed in f32 (the kernel sums in another order)."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.einsum(equation, a_lo, b_hi) + torch.einsum(equation, a_hi, b_lo)
            + torch.einsum(equation, a_hi, b_hi))


def _tiled_state(q, k, v, key_mask, block_k, split_f32=False):
    """The kernel's online softmax over key tiles: (acc, l, mx), (B, H, N, D)
    and (B, H, N), f32, before the division. split_f32: both products as
    the f32 kernel computes them (``einsum_split_f32``)."""
    b, n, h, d = q.shape
    m = k.shape[1]
    c = LOG2E / math.sqrt(d)
    qt = q.permute(0, 2, 1, 3).float()                # (B, H, N, D)
    acc = torch.zeros((b, h, n, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, n), dtype=torch.float32, device=q.device)
    mx = torch.full((b, h, n), NEG_INF, dtype=torch.float32, device=q.device)
    for start in range(0, m, block_k):
        kc = k[:, start:start + block_k].permute(0, 2, 1, 3).float()
        vc = v[:, start:start + block_k].permute(0, 2, 1, 3)
        bias = torch.where(key_mask[:, start:start + block_k], 0.0, NEG_INF)
        product = einsum_split_f32 if split_f32 else torch.einsum
        s = product("bhnd,bhcd->bhnc", qt, kc) * c + bias[:, None, None, :]
        mx_new = torch.maximum(mx, s.amax(dim=-1))
        corr = torch.exp2(mx - mx_new)
        p = torch.exp2(s - mx_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = product("bhnc,bhcd->bhnd", p.to(v.dtype).float(), vc.float())
        acc = acc * corr[..., None] + pv
        mx = mx_new
    return acc, l, mx


def masked_attention_tiled(q, k, v, key_mask, block_k=None, out_dtype=None, split_f32=False):
    """The arithmetic of ``gims_tpu/matcher/pallas_attention.py::_attn_kernel``
    and of the CUDA kernel, one key tile of ``block_k`` at a time.

    Scores are products of the inputs summed in f32 (never rounded to the
    input dtype), times scale*log2(e), plus a bias of 0 or NEG_INF per key;
    a base-2 running max starts at NEG_INF; the running sum takes the f32 p,
    and P is rounded to v's dtype before P V, which is summed in f32; the
    output is acc / max(l, 1e-30). Keys past M are absent (p = 0). Returns
    (B, N, H, D) in ``out_dtype`` (q's dtype by default): pass float32 to
    get the result before its one rounding. ``block_k`` defaults to the
    kernel's tile at this width and dtype (``kernel_block_k``). ``split_f32``
    computes both products as the kernel's f32 path does on the tensor cores
    (``einsum_split_f32``, f32 inputs).
    """
    acc, l, _ = _tiled_state(q, k, v, key_mask, block_k or kernel_block_k(q.shape[-1], v.dtype),
                             split_f32)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(out_dtype or q.dtype)


def attention_partials_tiled(q, k, v, key_mask, block_k=None, out_dtype=None):
    """The CUDA kernel's partial mode, tile by tile (its plain version): the
    output of ``masked_attention_tiled`` and each row's softmax statistics,
    stats (B, N, H, 2) f32: the base-2 running max m of the scaled, biased
    scores and the sum l of 2^(score - m) over the keys. Partials of
    disjoint key blocks merge into the attention over their union
    (``ring_attention.merge_partials``)."""
    acc, l, mx = _tiled_state(q, k, v, key_mask, block_k or kernel_block_k(q.shape[-1], v.dtype))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    stats = torch.stack([mx, l], dim=-1).permute(0, 2, 1, 3).contiguous()
    return out.permute(0, 2, 1, 3).to(out_dtype or q.dtype), stats


def needs_grad(*tensors) -> bool:
    """True where autograd would record an op on `tensors`: grad is enabled
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def takes_kernel(device, impl: str = "auto", grad: bool = False) -> bool:
    """Whether ``masked_attention`` hands a call to the CUDA kernel's wrapper:
    always under "pallas" (its wrapper raises where the kernel cannot run);
    under "auto" on a CUDA device without a gradient, at every head width,
    as JAX's dispatch takes its TPU kernel at any width."""
    if impl == "pallas":
        return True
    return impl == "auto" and torch.device(device).type == "cuda" and not grad


def masked_attention(q, k, v, key_mask, impl: str = "auto"):
    """Dispatch (``takes_kernel``).

    On a CUDA tensor "auto" and "pallas" launch the CUDA kernel, at every
    key count and head width (its wide-head kernels above
    KERNEL_MAX_HEAD_DIM, up to KERNEL_WIDEST_HEAD). "direct" and "flash"
    force the plain versions. On the CPU "auto" takes
    direct up to FLASH_THRESHOLD keys and flash above, as the JAX package
    does off the TPU. The kernel has no backward (nor has the TPU kernel):
    a call that needs a gradient (``needs_grad``) takes the plain versions
    under "auto" by that same off-TPU rule, on every device, and raises
    under "pallas". "ring" runs ``ring_attention.masked_attention_ring``
    over the group that ``ring_attention.set_ring_group`` named (ValueError
    without one).
    """
    if impl == "ring":
        from gims_tpu_torch.matcher.ring_attention import get_ring_group, masked_attention_ring

        return masked_attention_ring(q, k, v, key_mask, get_ring_group())
    if takes_kernel(q.device, impl, impl == "auto" and needs_grad(q, k, v)):
        from gims_tpu_torch.matcher.cuda_attention import masked_attention_cuda

        return masked_attention_cuda(q, k, v, key_mask)
    if impl == "direct" or (impl == "auto" and k.shape[1] <= FLASH_THRESHOLD):
        return masked_attention_direct(q, k, v, key_mask)
    if impl in ("auto", "flash"):
        return masked_attention_flash(q, k, v, key_mask)
    raise ValueError(f"unknown attention impl {impl!r}")
