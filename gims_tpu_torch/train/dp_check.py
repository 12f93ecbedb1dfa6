"""Data-parallel checks run as spawned ranks, one process per rank.

The tests (on the CPU, over gloo) and ``chip_smoke.py`` (two ranks sharing
the card over gloo) hold the port's data parallelism to its single-rank
runs through these workers. They live in the port's package, so a child
process imports the port and torch only.

    results = run(step_rank, ["cpu", "cpu"], "gloo", {"jobs": [job]}, directory)

``run`` writes the spec to `directory`, starts one process per entry of
`devices` (spawn), joined by a file rendezvous there, and returns each
rank's result in rank order. A job of ``step_rank`` is one train step of the
classic (``"classic"``) or fused end-to-end (``"fused"``) trainer from given
weights on a given global batch, of which each rank takes its
``process_batch_slice`` rows; ``train_step_job`` runs it in the calling
process too (``group=None``: the undistributed step). ``ring_rank`` runs
``masked_attention_ring`` on given inputs.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from gims_tpu_torch.agc import labels
from gims_tpu_torch.matcher import cuda_attention
from gims_tpu_torch.matcher.ring_attention import masked_attention_ring
from gims_tpu_torch.train import fused_step as fstep_mod
from gims_tpu_torch.train import loop as loop_mod
from gims_tpu_torch.train import multihost as mh
from gims_tpu_torch.train import step as step_mod


def run(worker, devices, backend: str, spec: dict, directory: str):
    """Run `worker` as len(devices) ranks (rank r on devices[r]) over
    `backend`; returns the ranks' results. `directory` must be empty."""
    torch.save(spec, os.path.join(directory, "spec.pt"))
    n = len(devices)
    mh.spawn(worker, n, (n, mh.local_init_method(directory), backend,
                         [str(d) for d in devices], directory))
    # written by this program's own ranks
    return [torch.load(os.path.join(directory, f"result{r}.pt"), weights_only=False)
            for r in range(n)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_main(body, rank, world, init_method, backend, devices, directory):
    spec = torch.load(os.path.join(directory, "spec.pt"), weights_only=False)
    dev = torch.device(devices[rank])
    if dev.type == "cpu":
        torch.set_num_threads(1)
    dev = mh.initialize(init_method, world, rank, backend=backend, device=dev)
    try:
        result = body(spec, dev, torch.distributed.group.WORLD)
        result["modules"] = sorted({m.split(".")[0] for m in sys.modules})
        torch.save(result, os.path.join(directory, f"result{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def build_model(job):
    """The trained module of a job: the joint matcher and CNN ("fused") or
    the matcher ("classic"), from the job's JAX-layout variables."""
    cfg = job["cfg"]
    if job["kind"] == "fused":
        return loop_mod._joint_from_variables(cfg, job["variables"], job.get("car_variables"),
                                              cfg.train.init_seed)
    return loop_mod._matcher_from_variables(cfg, job["variables"])


def _rows(batch, device, group):
    b = next(iter(batch.values())).shape[0]
    rows = mh.process_batch_slice(b, mh.world_size(group), mh.rank(group)) \
        if group is not None else slice(0, b)
    return {k: v[rows].to(device) for k, v in batch.items()}


def train_step_job(job, device, group=None):
    """One step of a job on `device`, data-parallel over `group` (None:
    undistributed, on the whole batch). Returns the averaged metrics, the
    step's ms (host clock around a synced step), the parameters and buffers
    after it, the gradient the optimizer took, the label-rounds launches,
    and where `group` is given the ms and bytes of an all-reduce of the
    gradients' size."""
    cfg = job["cfg"]
    model = build_model(job).to(device)
    if group is not None:
        mh.replicate(model, group)
    state, tx = step_mod.create_train_state(cfg, model, job.get("num_batches", 1))
    shape = (cfg.dataset.image_height, cfg.dataset.image_width)
    if job["kind"] == "fused":
        from gims_tpu_torch.fused import octave_budgets

        budgets = octave_budgets(*shape, cfg.train.max_keypoints, cfg.frontend.upsample)
        step = fstep_mod.make_fused_e2e_train_step(cfg, tx, shape, budgets, group=group)
    else:
        step = step_mod.make_train_step(cfg, tx, shape, group=group)
    taken = {}
    update = tx.update

    def keep_grads(grads, opt_state, params):
        taken["grads"] = {n: g.detach().cpu() for n, g in grads.items()}
        return update(grads, opt_state, params)

    tx.update = keep_grads
    batch = _rows(job["batch"], device, group)
    before = labels.launches
    _sync(device)
    t = time.perf_counter()
    state, m = step(state, batch)
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t)
    metrics = {k: float(v) for k, v in m.items() if k != "vec"}
    out = {"metrics": metrics, "step_ms": ms, "label_launches": labels.launches - before,
           "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
           "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()},
           "grads": taken["grads"], "device": str(device)}
    if group is not None:
        grads = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        times = []
        for _ in range(3):
            _sync(device)
            t = time.perf_counter()
            mh.all_mean(grads, group)
            _sync(device)
            times.append(1e3 * (time.perf_counter() - t))
        out.update(all_reduce_ms=times,
                   all_reduce_bytes=sum(g.numel() * g.element_size() for g in grads.values()),
                   backend=torch.distributed.get_backend(group))
    return out


def _steps(spec, device, group):
    return {"jobs": [train_step_job(job, device, group) for job in spec["jobs"]]}


def step_rank(rank, world, init_method, backend, devices, directory):
    """A rank of the train-step jobs in the spec (``spec["jobs"]``)."""
    _rank_main(_steps, rank, world, init_method, backend, devices, directory)


def ring_case(case, device, group, reps: int = 0):
    """``masked_attention_ring`` on a case's q, k, v (cast to its dtype) and
    key mask on `device`: the output on the CPU, the partial-mode launches,
    and with `reps` the ms per call (host clock around synced calls)."""
    dtype = case.get("dtype", torch.float32)
    q, k, v = (case[x].to(device, dtype) for x in ("q", "k", "v"))
    mask = case["mask"].to(device)
    before = cuda_attention.partial_launches
    out = masked_attention_ring(q, k, v, mask, group)
    _sync(device)
    res = {"out": out.cpu(), "launches": cuda_attention.partial_launches - before}
    if reps:
        t = time.perf_counter()
        for _ in range(reps):
            masked_attention_ring(q, k, v, mask, group)
        _sync(device)
        res["ms"] = 1e3 * (time.perf_counter() - t) / reps
    return res


def _rings(spec, device, group):
    return {"cases": [ring_case(c, device, group, spec.get("reps", 0)) for c in spec["cases"]]}


def ring_rank(rank, world, init_method, backend, devices, directory):
    """A rank of ring attention on the cases in the spec (``spec["cases"]``:
    dicts of q, k, v, mask tensors and a dtype)."""
    _rank_main(_rings, rank, world, init_method, backend, devices, directory)
