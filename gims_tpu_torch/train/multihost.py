"""Data parallelism over ranks: one process per rank, one device per rank.

Port of ``gims_tpu/train/multihost.py``. The JAX package joins one process
per host through ``jax.distributed.initialize`` and runs one program over a
mesh of every host's devices. The port follows PyTorch's idiom, as the
reference does (reference: train.py:189-208): one process per rank, an
explicit device per rank, and ``torch.distributed`` for the collectives.

  initialize()            <- jax.distributed.initialize: init_process_group
                             at tcp://<coordinator>
  is_main()               <- process 0 (the reference's rank-0 checks)
  process_batch_slice()   <- the same contiguous rows of each global batch
                             (the DistributedSampler analog), the same
                             ValueError
  replicate()             <- a broadcast of the module's parameters and
                             buffers from rank 0 (DDP's initial broadcast)
  all_mean()              <- lax.pmean over the data axis
  all_reduce()            <- lax.psum / pmin / pmax (the keypoint-sharded
                             matcher's collectives, matcher/sharded.py)
  spawn()                 <- the local devices of one JAX process: N ranks
                             started through torch.multiprocessing (spawn)

``global_mesh`` and ``globalize_batch`` have no counterpart: each rank keeps
its own rows of the batch and its own replica of the state, so there is no
global array to assemble. The train steps average gradients, metrics and
batch statistics with ``all_mean`` where the JAX steps pmean them; the model
is not wrapped in ``DistributedDataParallel``, which broadcasts rank 0's
BatchNorm buffers where JAX averages them.

Backends: ``nccl`` for a rank on a CUDA device and ``gloo`` on the CPU,
unless the caller names one. NCCL refuses two ranks on one card; ``gloo``
lets ranks share a card, and then every tensor it carries is staged through
host memory here (gloo's point-to-point ops read host pointers only).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from gims_tpu_torch.core.device import resolve_device

Tensors = Union[Dict[str, torch.Tensor], Sequence[torch.Tensor]]


def default_backend(device) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: Optional[str] = None, device=None) -> torch.device:
    """Join the process group as rank `process_id` of `num_processes`.

    coordinator: "host:port" of process 0 (``tcp://`` is prefixed), or an
    init URL (``tcp://...``, ``file://...``). `device` is this rank's device
    (default: the current card); a CUDA device becomes the current one.
    `backend` defaults to ``default_backend(device)``. Returns the device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or default_backend(dev), init_method=url,
                            world_size=num_processes, rank=process_id)
    return dev


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_main() -> bool:
    """True on the logging and checkpointing process (reference rank 0)."""
    return rank() == 0


def process_batch_slice(global_batch_size: int, num_processes: Optional[int] = None,
                        process_id: Optional[int] = None) -> slice:
    """This process's contiguous rows of each global batch. Every process
    builds the same global index order (same seed) and materializes only
    these rows. The process count and index default to the group's."""
    n_proc = world_size() if num_processes is None else num_processes
    if global_batch_size % n_proc:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{n_proc} processes")
    per = global_batch_size // n_proc
    pid = rank() if process_id is None else process_id
    return slice(pid * per, (pid + 1) * per)


def _staged(group) -> bool:
    """True where the group's backend carries host tensors only (gloo)."""
    return dist.get_backend(group) == dist.Backend.GLOO


def _flat_buffers(tensors: List[torch.Tensor]):
    """Group `tensors` by (device, dtype): [(indices, flat copy)]."""
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return [(idx, torch.cat([tensors[i].reshape(-1) for i in idx]))
            for idx in groups.values()]


def _collective(fn, buf: torch.Tensor, group) -> torch.Tensor:
    """Run `fn(tensor)` in place on `buf`, through a host copy under gloo."""
    if buf.is_cuda and _staged(group):
        host = buf.cpu()
        fn(host)
        buf.copy_(host)
    else:
        fn(buf)
    return buf


def all_mean(tensors: Tensors, group=None):
    """The mean of each tensor over the group's ranks (``lax.pmean``): one
    all-reduce per device and dtype of a flat copy of the tensors, then a
    division by the world size. Returns new tensors in the structure given
    (a dict by the same keys, or a list)."""
    keys = list(tensors) if isinstance(tensors, dict) else None
    flat = [tensors[k] for k in keys] if keys is not None else list(tensors)
    n = world_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(flat)
    for idx, buf in _flat_buffers([t.detach() for t in flat]):
        _collective(lambda x: dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group), buf, group)
        buf.div_(n)
        offset = 0
        for i in idx:
            numel = flat[i].numel()
            out[i] = buf[offset:offset + numel].view(flat[i].shape)
            offset += numel
    return dict(zip(keys, out)) if keys is not None else out


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


@torch.no_grad()
def all_reduce(tensor: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The elementwise sum, min or max of `tensor` over the group's ranks
    (``lax.psum``, ``pmin``, ``pmax``), as a new tensor on its device; every
    rank receives the same bits. Bool travels as bytes (min and max are
    all and any)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"all_reduce op {op!r}: one of {sorted(_REDUCE_OPS)}")
    buf = tensor.detach().to(torch.uint8 if tensor.dtype == torch.bool else tensor.dtype,
                             copy=True).contiguous()
    _collective(lambda x: dist.all_reduce(x, op=_REDUCE_OPS[op], group=group), buf, group)
    return buf.bool() if tensor.dtype == torch.bool else buf


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Overwrite each tensor, in place, with rank `src`'s (group rank)."""
    tensors = list(tensors)
    src = dist.get_global_rank(group, src) if group is not None else src
    for idx, buf in _flat_buffers(tensors):
        _collective(lambda x: dist.broadcast(x, src=src, group=group), buf, group)
        offset = 0
        for i in idx:
            numel = tensors[i].numel()
            tensors[i].copy_(buf[offset:offset + numel].view(tensors[i].shape))
            offset += numel


def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank, in place (DDP's
    broadcast of the initial state). Returns `module`."""
    broadcast_(list(module.parameters()) + list(module.buffers()), 0, group)
    return module


def broadcast_float(value: float, src: int = 0, group=None, device="cpu") -> float:
    """A float of rank `src` on every rank (the validation score)."""
    t = torch.tensor([value], dtype=torch.float64, device=device)
    broadcast_([t], src, group)
    return float(t[0])


def exchange(send: Sequence[torch.Tensor], dst: int, src: int, group=None) -> List[torch.Tensor]:
    """Send `send` to group rank `dst` and receive tensors of the same
    shapes and dtypes from group rank `src`, as one batch of point-to-point
    ops (``batch_isend_irecv``). Under gloo, CUDA tensors go through host
    copies; under NCCL they stay on the device."""
    staged = _staged(group)
    device = send[0].device
    out = [torch.empty_like(t, device="cpu" if staged else device) for t in send]
    payload = [t.cpu() if staged else t.contiguous() for t in send]
    gdst = dist.get_global_rank(group, dst) if group is not None else dst
    gsrc = dist.get_global_rank(group, src) if group is not None else src
    ops = [dist.P2POp(dist.isend, t, gdst, group) for t in payload]
    ops += [dist.P2POp(dist.irecv, t, gsrc, group) for t in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [t.to(device) for t in out] if staged else out


def all_gather_cat(tensor: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's `tensor` (same shape on each), concatenated along `dim`
    (not the last) in rank order. bf16 and bool travel as bytes, which
    every backend carries."""
    n = world_size(group)
    staged = _staged(group) and tensor.is_cuda
    src = tensor.contiguous()
    wire = torch.uint8 if src.dtype in (torch.bfloat16, torch.bool) else None
    if wire is not None:
        src = src.view(wire)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if wire is not None:
        out = out.view(tensor.dtype)
    return out.to(tensor.device)


def local_init_method(directory: str) -> str:
    """A file rendezvous in `directory` (which must not hold one yet)."""
    return f"file://{directory}/rendezvous"


def spawn(fn, nprocs: int, args=()) -> None:
    """Run ``fn(rank, *args)`` in `nprocs` new processes, started with the
    spawn method (a process that has loaded threads, CUDA or JAX must not
    fork), and wait for all. A rank that raises fails the call.
    `fn` must be importable by name: the children import it afresh."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=tuple(args), nprocs=nprocs, join=True, start_method="spawn")
