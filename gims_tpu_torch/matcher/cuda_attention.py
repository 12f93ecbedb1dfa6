"""Masked multi-head attention through the hand-written CUDA kernel.

Port of ``gims_tpu/matcher/pallas_attention.py``. The kernel
(``csrc/attention.cu``) reads the (B, N, H, D) layout in place, so no
transposed copies are made: bf16 on the tensor cores through TMA, f32 on
the tensor cores as split f32 (each operand two TF32 values, three
products: ``attention.einsum_split_f32`` is its arithmetic), both with f32
accumulation; the output has q's dtype. Head widths from 1 to 256 take the
column-block kernels; wider heads the wide-head kernels (bf16 on wgmma, f32
as split TF32), which split a head's columns over warps and, past 512
(bf16) or 320 (f32) columns, over the CTAs of a cluster, and exchange the
partial scores in shared memory: nothing is allocated beside the output.
The widest heads: ``attention.KERNEL_WIDEST_HEAD``. The bf16 kernels read
widths that are a multiple of 8 (TMA's 16-byte strides); the wrapper zero-pads q, k
and v along D to the next multiple of 8 for other widths (zeros add
nothing to Q K^T, the extra output columns are dropped, and the scale
stays that of the true D). On a
CUDA tensor the wrapper launches the kernel or raises: q, k and v must have
a unit D stride and, in bf16, 16-byte aligned bases and strides (what TMA
reads), and are never copied to make them so, but for that padding. It takes the plain
version (``attention.masked_attention_tiled``) only for a tensor on the CPU.

The kernel has no backward, as the TPU kernel has none: under autograd
(grad enabled and an input that requires grad) the wrapper raises, on any
device, instead of returning a result that carries no gradient.
``attention.masked_attention`` routes such calls to the plain versions.
"""

from __future__ import annotations

import math

import torch

from gims_tpu_torch import _build
from gims_tpu_torch.matcher import attention

BF16_D_STEP = 8  # the bf16 kernel's widths: multiples of 8 (16-byte rows)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# calls of masked_attention_cuda that launched the kernel
launches = 0
# calls of attention_partials_cuda that launched the kernel (partial mode)
partial_launches = 0


def check_layout(name: str, t: torch.Tensor):
    """Raise unless `t` (B, N, H, D) has a unit D stride, and in bf16 a
    16-byte aligned base and strides, as the kernel's tensor maps need (the
    f32 kernel reads any alignment)."""
    if t.stride(3) != 1:
        raise ValueError(f"{name} must have a unit D stride, got strides {t.stride()}")
    if t.dtype != torch.bfloat16:
        return
    esz = t.element_size()
    if t.data_ptr() % 16 or any(st * esz % 16 for st in t.stride()[:3]):
        raise ValueError(f"{name}: base and strides must be 16-byte aligned "
                         f"(strides {t.stride()}, {esz}-byte elements)")


def masked_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: torch.Tensor) -> torch.Tensor:
    """q (B, N, H, D); k, v (B, M, H, D); key_mask (B, M) bool.
    Returns (B, N, H, D) in q's dtype."""
    global launches
    if q.device.type == "cpu":
        _check_grad(q, k, v)
        return attention.masked_attention_tiled(q, k, v, key_mask)
    out = _launch(q, k, v, key_mask, None)
    launches += 1
    return out


def attention_partials_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            key_mask: torch.Tensor):
    """The kernel's partial mode (ring attention's step): the output of
    ``masked_attention_cuda`` and stats (B, N, H, 2) f32, each row's base-2
    softmax max and sum (``attention.attention_partials_tiled`` is its
    plain version, and what a CPU tensor gets)."""
    global partial_launches
    if q.device.type == "cpu":
        _check_grad(q, k, v)
        return attention.attention_partials_tiled(q, k, v, key_mask)
    stats = torch.empty((q.shape[0], q.shape[1], q.shape[2], 2), dtype=torch.float32,
                        device=q.device)
    out = _launch(q, k, v, key_mask, stats)
    partial_launches += 1
    return out, stats


def _check_grad(q, k, v):
    if attention.needs_grad(q, k, v):
        raise RuntimeError("masked_attention_cuda has no backward: q, k or v requires grad "
                           "with grad enabled; use the plain versions (attention_impl "
                           "'auto', 'direct' or 'flash') to train")


def _launch(q, k, v, key_mask, stats):
    """Check the inputs and launch the kernel (partial mode where `stats`
    is given); returns the output."""
    _check_grad(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention_cuda: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, N, H, D)")
    b, n, h, d = q.shape
    m = k.shape[1]
    if tuple(k.shape) != (b, m, h, d) or tuple(v.shape) != (b, m, h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one "
                        "of float32, bfloat16")
    if d < 1 or d > attention.KERNEL_WIDEST_HEAD[q.dtype]:
        raise ValueError(f"head dim {d} unsupported: the {q.dtype} kernel takes 1 to "
                         f"{attention.KERNEL_WIDEST_HEAD[q.dtype]} (a head's columns span at "
                         "most a cluster of 16 CTAs)")
    if key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, m):
        raise ValueError(f"key_mask must be ({b}, {m}) bool")
    if key_mask.stride(1) != 1:
        raise ValueError("key_mask must be contiguous along keys")
    for name, t in (("k", k), ("v", v), ("key_mask", key_mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    scale_log2 = attention.LOG2E / math.sqrt(d)  # of the true width
    pad = -d % BF16_D_STEP if q.dtype == torch.bfloat16 else 0
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_layout(name, t)
    out = torch.empty((b, n, h, d + pad), dtype=q.dtype, device=q.device)
    lib = _build.load()
    args = (_DTYPES[q.dtype], b, n, m, h, d + pad,
            *q.stride(), *k.stride(), *v.stride(), *out.stride(),
            key_mask.stride(0), scale_log2)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), out.data_ptr())
        if stats is None:
            rc = lib.gims_attention_fwd(*ptrs, *args, stream)
        else:
            rc = lib.gims_attention_fwd_partial(*ptrs, stats.data_ptr(), *args, stream)
    if rc != 0:
        raise RuntimeError(f"gims_attention_fwd failed: cudaError {rc}")
    return out[..., :d] if pad else out
