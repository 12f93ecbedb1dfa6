"""Deterministic segmented sums: the hand-written kernel ``csrc/segsum.cu``.

``segment_sum(values, index, num)`` returns ``out`` of ``num`` slots with
``out[s] = 0 + values[i1] + values[i2] + ...`` over the ``i`` with
``index[i] == s``, in ascending ``i``, in plain float32 adds: what
``torch.zeros(num).index_add_(0, index, values)`` computes on the CPU, where
it adds in index order. That sequential sum is the plain version
(``segment_sum_plain``). On the card ``index_add_`` adds with atomics in an
order that changes between runs; the kernel gives the sequential sum's bits
on every run. It replaces no TPU kernel: the JAX package's segment sums are
deterministic, and this makes the port's so.

On a CPU tensor the wrapper takes the plain version; on a CUDA tensor it
sorts the destinations (a stable ``torch.sort``, deterministic), finds
each slot's run (``torch.searchsorted``) and launches the kernel, or
raises. Under autograd the gradient of each value
is the gradient of its slot (a gather, no sum). Each caller names itself
with a `tag`, under which the launches are also counted.
"""

from __future__ import annotations

import torch

from gims_tpu_torch import _build

# calls of segment_sum that launched the kernel, in all and by the caller's tag
launches = 0
launches_by_tag: dict = {}


def segment_sum_plain(values: torch.Tensor, index: torch.Tensor, num: int) -> torch.Tensor:
    """The sequential sum: index_add_ into zeros (in index order on the CPU)."""
    out = torch.zeros(num, dtype=values.dtype, device=values.device)
    return out.index_add_(0, index, values)


def _check(values, index):
    if values.dim() != 1 or index.dim() != 1 or values.shape[0] != index.shape[0]:
        raise ValueError(f"segment_sum takes 1-D values and index of one length, got "
                         f"{tuple(values.shape)} and {tuple(index.shape)}")
    if values.dtype != torch.float32:
        raise TypeError(f"segment_sum sums float32 values, got {values.dtype}")
    if index.device != values.device:
        raise ValueError(f"index is on {index.device}, values on {values.device}")


def segment_sum_cuda(values: torch.Tensor, index: torch.Tensor, num: int,
                     tag: str = "other") -> torch.Tensor:
    """The kernel on a CUDA tensor (no autograd)."""
    global launches
    _check(values, index)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum_cuda: unsupported device {values.device}")
    num = int(num)
    if not 0 <= num < 2 ** 31:
        raise ValueError(f"segment_sum_cuda takes up to 2^31 - 1 slots, got {num}")
    keys, perm = torch.sort(index.to(torch.int32), stable=True)
    # each slot's run of the sorted keys: offsets[s] .. offsets[s + 1]
    offsets = torch.searchsorted(keys, torch.arange(num + 1, dtype=torch.int32,
                                                    device=keys.device))
    values = values.contiguous()
    out = torch.empty(num, dtype=torch.float32, device=values.device)
    lib = _build.load()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.gims_segsum(keys.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
                             values.data_ptr(), out.data_ptr(), values.shape[0], num, stream)
    if rc != 0:
        raise RuntimeError(f"gims_segsum failed: cudaError {rc}")
    launches += 1
    launches_by_tag[tag] = launches_by_tag.get(tag, 0) + 1
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, index, num, tag):
        ctx.save_for_backward(index)
        return segment_sum_cuda(values.detach(), index, num, tag)

    @staticmethod
    def backward(ctx, grad_out):
        (index,) = ctx.saved_tensors
        return grad_out[index], None, None, None


def segment_sum(values: torch.Tensor, index: torch.Tensor, num: int,
                tag: str = "other") -> torch.Tensor:
    """(num,) float32 sums of `values` into the slots `index`, in source
    order. A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    _check(values, index)
    if values.device.type == "cpu":
        return segment_sum_plain(values, index, num)
    if torch.is_grad_enabled() and values.requires_grad:
        return _SegmentSum.apply(values, index, num, tag)
    return segment_sum_cuda(values, index, num, tag)


def batched_segment_sum(data: torch.Tensor, seg: torch.Tensor, num: int,
                        tag: str = "other") -> torch.Tensor:
    """out[b, s] = sum of data[b, i] with seg[b, i] == s, in ascending i:
    ``zeros((B, num)).scatter_add_(1, seg, data)`` on the CPU, as one
    segment_sum over the flattened slots b * num + s."""
    b = data.shape[0]
    keys = seg.long() + torch.arange(b, device=seg.device)[:, None] * num
    return segment_sum(data.reshape(-1), keys.reshape(-1), b * num, tag).reshape(b, num)
