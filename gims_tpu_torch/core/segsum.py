"""Deterministic segmented sums: the hand-written kernel ``csrc/segsum.cu``.

``segment_sum_rows(values, slots, num)`` takes values and slots (R, W) and
returns out (R, num) with ``out[r, s] = 0 + values[r, i1] + values[r, i2]
+ ...`` over the ``i`` with ``slots[r, i] == s``, in ascending ``i``, in
plain float32 adds: row r's values land only in row r's slots. That is
what ``index_add_`` into zeros computes on the CPU, where it adds in index
order, over the flat slots ``r * num + s``. That sequential sum is the plain
version (``segment_sum_plain``, ``segment_sum_rows_plain``). On the card
``index_add_`` adds with atomics in an order that changes between runs; the
kernel gives the sequential sum's bits on every run, in one launch, with no
sort. It replaces no TPU kernel: the JAX package's segment sums are
deterministic, and this makes the port's so.

``segment_sum(values, index, num)`` is the flat form: any index, taken as
one row (int64 indices are cast to int32 first). ``batched_segment_sum`` is
the rows form under the name ``scatter_add_`` along dim 1 would have.

On a CPU tensor the wrappers take the plain version; on a CUDA tensor they
launch the kernel or raise. The kernel reads int16 or int32 slots with a
unit stride along W (a row stride of 0 gives every row one slot list) and
never copies to make them so. Under autograd the gradient of each value is
the gradient of its slot (a gather, no sum). Each caller names itself with
a `tag`, under which the launches are also counted.
"""

from __future__ import annotations

import torch

from gims_tpu_torch import _build

# calls that launched the kernel, in all and by the caller's tag
launches = 0
launches_by_tag: dict = {}

_SLOT_BYTES = {torch.int16: 2, torch.int32: 4}


def segment_sum_plain(values: torch.Tensor, index: torch.Tensor, num: int) -> torch.Tensor:
    """The sequential sum: index_add_ into zeros (in index order on the CPU)."""
    out = torch.zeros(num, dtype=values.dtype, device=values.device)
    return out.index_add_(0, index, values)


def segment_sum_rows_plain(values: torch.Tensor, slots: torch.Tensor, num: int) -> torch.Tensor:
    """(R, num): each row's sequential sum, as one index_add_ over the flat
    slots r * num + s."""
    r = values.shape[0]
    keys = slots.long() + torch.arange(r, device=slots.device)[:, None] * num
    return segment_sum_plain(values.reshape(-1), keys.reshape(-1), r * num).reshape(r, num)


def _check(values, index):
    if values.dim() != 1 or index.dim() != 1 or values.shape[0] != index.shape[0]:
        raise ValueError(f"segment_sum takes 1-D values and index of one length, got "
                         f"{tuple(values.shape)} and {tuple(index.shape)}")
    if values.dtype != torch.float32:
        raise TypeError(f"segment_sum sums float32 values, got {values.dtype}")
    if index.device != values.device:
        raise ValueError(f"index is on {index.device}, values on {values.device}")


def _check_rows(values, slots):
    if values.dim() != 2 or tuple(slots.shape) != tuple(values.shape):
        raise ValueError(f"segment_sum_rows takes (R, W) values and slots, got "
                         f"{tuple(values.shape)} and {tuple(slots.shape)}")
    if values.dtype != torch.float32:
        raise TypeError(f"segment_sum_rows sums float32 values, got {values.dtype}")
    if slots.dtype not in (torch.int16, torch.int32, torch.int64):
        raise TypeError(f"slots must be integers, got {slots.dtype}")
    if slots.device != values.device:
        raise ValueError(f"slots are on {slots.device}, values on {values.device}")


def segment_sum_rows_cuda(values: torch.Tensor, slots: torch.Tensor, num: int,
                          tag: str = "other") -> torch.Tensor:
    """The kernel on CUDA tensors (no autograd): values (R, W) float32 and
    slots (R, W) int16 or int32, both with a unit stride along W."""
    global launches
    _check_rows(values, slots)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum_rows_cuda: unsupported device {values.device}")
    if slots.dtype not in _SLOT_BYTES:
        raise TypeError(f"the kernel reads int16 or int32 slots, got {slots.dtype}")
    num = int(num)
    if not 0 <= num < 2 ** 31:
        raise ValueError(f"segment_sum_rows_cuda takes up to 2^31 - 1 slots, got {num}")
    r, w = values.shape
    if w > 1 and (values.stride(1) != 1 or slots.stride(1) != 1):
        raise ValueError(f"values and slots need a unit stride along W, got strides "
                         f"{values.stride()} and {slots.stride()}")
    dev = values.device
    out = torch.empty((r, num), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load()
    args = (values.data_ptr(), slots.data_ptr(), _SLOT_BYTES[slots.dtype], out.data_ptr(), r, w,
            values.stride(0), slots.stride(0), num, torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        rc = lib.gims_segsum_rows(*args)
    else:  # the launch goes to the current device
        with torch.cuda.device(dev):
            rc = lib.gims_segsum_rows(*args)
    if rc != 0:
        raise RuntimeError(f"gims_segsum_rows failed: cudaError {rc}")
    launches += 1
    launches_by_tag[tag] = launches_by_tag.get(tag, 0) + 1
    return out


def segment_sum_cuda(values: torch.Tensor, index: torch.Tensor, num: int,
                     tag: str = "other") -> torch.Tensor:
    """The flat sum on a CUDA tensor (no autograd): the whole index as one
    row of the kernel."""
    _check(values, index)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum_cuda: unsupported device {values.device}")
    if index.dtype not in _SLOT_BYTES:
        index = index.to(torch.int32)
    return segment_sum_rows_cuda(values[None], index[None], num, tag)[0]


class _SegmentSumRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, slots, num, tag):
        ctx.save_for_backward(slots)
        return segment_sum_rows_cuda(values.detach(), slots, num, tag)

    @staticmethod
    def backward(ctx, grad_out):
        (slots,) = ctx.saved_tensors
        return grad_out.gather(1, slots.long()), None, None, None


def segment_sum_rows(values: torch.Tensor, slots: torch.Tensor, num: int,
                     tag: str = "other") -> torch.Tensor:
    """(R, num) float32 sums of each row of `values` into that row's slots
    `slots`, in source order. A CPU tensor takes the plain version; a CUDA
    tensor the kernel (int16 or int32 slots)."""
    _check_rows(values, slots)
    if values.device.type == "cpu":
        return segment_sum_rows_plain(values, slots, num)
    if torch.is_grad_enabled() and values.requires_grad:
        return _SegmentSumRows.apply(values, slots, num, tag)
    return segment_sum_rows_cuda(values, slots, num, tag)


def segment_sum(values: torch.Tensor, index: torch.Tensor, num: int,
                tag: str = "other") -> torch.Tensor:
    """(num,) float32 sums of `values` into the slots `index`, in source
    order: one row of ``segment_sum_rows``."""
    _check(values, index)
    if values.device.type == "cpu":
        return segment_sum_plain(values, index, num)
    if index.dtype not in _SLOT_BYTES:
        index = index.to(torch.int32)
    return segment_sum_rows(values[None], index[None], num, tag)[0]


def batched_segment_sum(data: torch.Tensor, seg: torch.Tensor, num: int,
                        tag: str = "other") -> torch.Tensor:
    """out[b, s] = sum of data[b, i] with seg[b, i] == s, in ascending i:
    ``zeros((B, num)).scatter_add_(1, seg, data)`` on the CPU, as
    ``segment_sum_rows`` (int64 slots cast to int32 on the card)."""
    if data.device.type != "cpu" and seg.dtype not in _SLOT_BYTES:
        seg = seg.to(torch.int32)
    return segment_sum_rows(data, seg, num, tag)
