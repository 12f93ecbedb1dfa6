"""Masked multi-head attention through the hand-written CUDA kernel.

Port of ``gims_tpu/matcher/pallas_attention.py``. The kernel
(``csrc/attention.cu``) reads the (B, N, H, D) layout through strides, so
no transposed copies are made, and takes f32 or bf16 inputs with f32
accumulation; the output has q's dtype. On a CUDA tensor the wrapper
launches the kernel or raises. It takes the plain version
(``attention.masked_attention_flash``) only for a tensor on the CPU.
"""

from __future__ import annotations

import math

import torch

from gims_tpu_torch import _build
from gims_tpu_torch.matcher import attention

LOG2E = 1.4426950408889634
HEAD_DIM = 64  # the one head width the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# calls of masked_attention_cuda that launched the kernel
launches = 0


def masked_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: torch.Tensor) -> torch.Tensor:
    """q (B, N, H, D); k, v (B, M, H, D); key_mask (B, M) bool.
    Returns (B, N, H, D) in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return attention.masked_attention_flash(q, k, v, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention_cuda: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, N, H, D)")
    b, n, h, d = q.shape
    m = k.shape[1]
    if tuple(k.shape) != (b, m, h, d) or tuple(v.shape) != (b, m, h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d} unsupported (kernel is built for {HEAD_DIM})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one "
                        "of float32, bfloat16")
    if key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, m):
        raise ValueError(f"key_mask must be ({b}, {m}) bool")
    if key_mask.stride(1) != 1:
        raise ValueError("key_mask must be contiguous along keys")
    for name, t in (("k", k), ("v", v), ("key_mask", key_mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.gims_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype], b, n, m, h, d,
            *q.stride(), *k.stride(), *v.stride(), *out.stride(),
            key_mask.stride(0), LOG2E / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"gims_attention_fwd failed: cudaError {rc}")
    launches += 1
    return out
