"""Training step: optimizer, LR schedule, EMA, on one device.

Port of ``gims_tpu/train/step.py:31-203``. Optimizer parity with the JAX
package's optax chain (reference train.py:42-58):
``masked(add_decayed_weights(wd))`` -> ``scale_by_adam(0.9, 0.999, 1e-8)``
(or ``trace(0.9, nesterov=True)`` for "sgd") -> ``scale_by_schedule(-lr)``.
So torch-style L2 weight decay is added to the gradient before Adam, on
Linear/Conv2d weights only (flax ``Dense``/``Conv`` kernels: biases, norm
scales and bin_score are decay-free); eps is added outside the square
root; the learning rate is ``lr_schedule(count)`` with the count taken
before its increment, so step 0 runs at lr 0 under a warmup. The chain is
written out here, functionally over dicts of tensors keyed by parameter
name, rather than through ``torch.optim``: its state and arithmetic then
follow optax step for step, and a caller can gate updates per subtree
(``train/fused_step.py``'s freezing).

LR schedule parity with train.py:87,101-105 + change_lr (train.py:21-26):
linear warmup over warmup_epochs*num_batches steps, then per-epoch
exponential decay after step_epoch.

Data parallelism (``make_distributed_train_step``, or ``group=`` on
``make_train_step``): each rank runs the step on its own rows of the global
batch, and the gradients, the metrics and the batch-statistics updates are
averaged over the ranks (``multihost.all_mean``, one all-reduce a step)
before the optimizer and before the statistics are written, where the JAX
step pmeans them (``gims_tpu/train/step.py:181-184``). So every rank applies
the same update to the same replica.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from gims_tpu_torch.config import GIMSConfig
from gims_tpu_torch.matcher import pipeline
from gims_tpu_torch.train import gt as gt_mod
from gims_tpu_torch.train import multihost

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The JAX TrainState's fields over a module: ``model`` holds the params
    (its parameters) and the batch_stats (its buffers); ``opt_state`` is the
    optimizer's state (``Optimizer.init``), ``ema_params`` an EMA copy of
    the parameters by name (None without EMA)."""

    step: int
    model: nn.Module
    opt_state: Dict[str, Any]
    ema_params: Optional[Tensors]
    ema_updates: int

    @property
    def params(self) -> Tensors:
        return dict(self.model.named_parameters())


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True for Linear/Conv2d weights only (flax Dense/Conv kernels;
    reference pg1, train.py:50-51)."""
    mask = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        for leaf, _ in mod.named_parameters(recurse=False):
            mask[pre + leaf] = isinstance(mod, (nn.Linear, nn.Conv2d)) and leaf == "weight"
    return mask


def lr_schedule(cfg: GIMSConfig, num_batches: int):
    """step -> learning rate (a float), in f32 as the JAX schedule computes it."""
    o = cfg.optimizer
    warmup = o.warmup_epochs * num_batches

    f32 = np.float32

    def fn(step):
        step = f32(step)
        epoch = np.floor(step / f32(num_batches))
        decay = (f32(o.step_value) ** (epoch - f32(o.step_epoch))
                 if epoch >= o.step_epoch else f32(1.0))
        if step < warmup:
            return float(f32(o.lr) * step / f32(max(warmup, 1)))
        return float(f32(o.lr) * decay)

    return fn


class Optimizer:
    """The optax chain of ``make_optimizer``, over dicts of tensors keyed by
    parameter name: ``init(params) -> state`` and ``update(grads, state,
    params) -> (updates, state)``, as optax's ``GradientTransformation``.
    Apply the updates with ``apply_updates``."""

    def __init__(self, cfg: GIMSConfig, num_batches: int, mask: Dict[str, bool]):
        self.schedule = lr_schedule(cfg, num_batches)
        self.weight_decay = cfg.optimizer.weight_decay
        self.mask = mask
        self.adam = cfg.optimizer.opt_type.lower() == "adam"
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.momentum = 0.9

    def init(self, params: Tensors) -> Dict[str, Any]:
        zeros = {n: torch.zeros_like(p, memory_format=torch.preserve_format).detach()
                 for n, p in params.items()}
        if self.adam:
            return {"count": 0, "mu": zeros,
                    "nu": {n: torch.zeros_like(z) for n, z in zeros.items()}}
        return {"count": 0, "trace": zeros}

    @torch.no_grad()
    def update(self, grads: Tensors, state: Dict[str, Any], params: Tensors):
        # torch._foreach_* ops: one launch per group of tensors, not one per
        # tensor and operation (the joint model has ~370 tensors)
        names = list(grads)
        g = [grads[n] for n in names]
        decayed = [i for i, n in enumerate(names) if self.mask[n]]
        if decayed and self.weight_decay:
            gd = torch._foreach_add([g[i] for i in decayed], [params[names[i]] for i in decayed],
                                    alpha=self.weight_decay)
            for i, t in zip(decayed, gd):
                g[i] = t
        count = state["count"]
        lr = self.schedule(count)
        if self.adam:
            b1, b2 = self.b1, self.b2
            mu = torch._foreach_mul([state["mu"][n] for n in names], b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            nu = torch._foreach_mul([state["nu"][n] for n in names], b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            # bias corrections in f32, as optax computes decay**count
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** (count + 1))
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** (count + 1))
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            new_state = {"count": count + 1, "mu": dict(zip(names, mu)),
                         "nu": dict(zip(names, nu))}
        else:
            trace = torch._foreach_mul([state["trace"][n] for n in names], self.momentum)
            torch._foreach_add_(trace, g)
            upd = torch._foreach_mul(trace, self.momentum)  # nesterov: g + m * trace
            torch._foreach_add_(upd, g)
            new_state = {"count": count + 1, "trace": dict(zip(names, trace))}
        torch._foreach_mul_(upd, -lr)
        return dict(zip(names, upd)), new_state


def make_optimizer(cfg: GIMSConfig, num_batches: int, model: nn.Module) -> Optimizer:
    return Optimizer(cfg, num_batches, weight_decay_mask(model))


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """optax.apply_updates, in place on the parameters."""
    if updates:
        torch._foreach_add_([params[n] for n in updates], list(updates.values()))


def create_train_state(cfg: GIMSConfig, model: nn.Module, num_batches: int):
    """A TrainState over `model` (its parameters are trained in place) and
    its optimizer."""
    tx = make_optimizer(cfg, num_batches, model)
    params = dict(model.named_parameters())
    state = TrainState(
        step=0, model=model, opt_state=tx.init(params),
        ema_params=({n: p.detach().clone() for n, p in params.items()}
                    if cfg.train.use_ema else None),
        ema_updates=0)
    return state, tx


@torch.no_grad()
def ema_update(ema_params: Tensors, params: Tensors, updates: int, decay: float = 0.9999):
    """Reference ModelEMA ramp (utils/common.py:995-1015):
    d = decay * (1 - exp(-n / 4000)) at the n-th update, in f32."""
    updates = updates + 1
    d = float(torch.tensor(decay, dtype=torch.float32)
              * (1.0 - torch.exp(-torch.tensor(float(updates)) / 4000.0)))
    names = list(ema_params)
    new = torch._foreach_mul([ema_params[n] for n in names], d)
    torch._foreach_add_(new, [params[n].detach() for n in names], alpha=1.0 - d)
    return dict(zip(names, new)), updates


def apply_batch_stats(model: nn.Module, updates) -> None:
    """Write a training forward's ``{"batch_stats": {name: tensor}}`` into
    `model`'s buffers."""
    bufs = dict(model.named_buffers())
    with torch.no_grad():
        for name, value in updates.get("batch_stats", {}).items():
            bufs[name].copy_(value)


def _grads(params: Tensors) -> Tensors:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in params.items()}


def mean_across(group, grads: Tensors, metrics: Tensors, updates):
    """(grads, metrics, updates) averaged over `group`'s ranks in one
    all-reduce (the JAX steps' three pmeans); as given where `group` is
    None. `metrics["vec"]` is rebuilt from the averaged losses."""
    if group is None:
        return grads, metrics, updates
    stats = updates.get("batch_stats", {})
    scalars = {k: v for k, v in metrics.items() if k != "vec"}
    merged = multihost.all_mean({**{"g." + n: g for n, g in grads.items()},
                                 **{"m." + n: m for n, m in scalars.items()},
                                 **{"s." + n: s for n, s in stats.items()}}, group)
    grads = {n: merged["g." + n] for n in grads}
    metrics = {n: merged["m." + n] for n in scalars}
    metrics["vec"] = torch.stack([metrics["pos_loss"], metrics["neg_loss"],
                                  metrics["total_loss"]])
    return grads, metrics, {**updates, "batch_stats": {n: merged["s." + n] for n in stats}}


def make_train_step(cfg: GIMSConfig, tx: Optimizer, image_shape, group=None):
    """Returns step(state, batch) -> (state, metrics).

    batch: kpts0/desc0/valid0/kpts1/desc1/valid1 (B leading) and per-item
    gt_rows (B, R, 3) / gt_valid (B, R), whose batch column is rewritten
    here; or desc0_h/desc1_h, the 128-d halves (bf16) of duplicated
    descriptors; or desc0_u8/desc1_u8 and "homography", from which the
    descriptors are normalized and duplicated and the ground truth matched
    in the step, as the JAX package's fused raw form. The state's model is
    updated in place.

    group: a ``torch.distributed`` group (the JAX step's ``axis_name``): the
    gradients, metrics and batch-statistics updates are averaged over its
    ranks before the optimizer runs (``mean_across``).
    """
    acfg = cfg.agc

    def _norm_dup(u8):
        d = u8.float()
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
        return torch.cat([d, d], dim=-1)

    def step(state: TrainState, batch):
        batch = dict(batch)
        for s in ("0", "1"):
            if f"desc{s}_h" in batch:
                d = batch.pop(f"desc{s}_h").float()
                batch[f"desc{s}"] = torch.cat([d, d], dim=-1)
        if "homography" in batch:
            batch["desc0"] = _norm_dup(batch.pop("desc0_u8"))
            batch["desc1"] = _norm_dup(batch.pop("desc1_u8"))
            rows, valid = [], []
            for i in range(batch["kpts0"].shape[0]):
                m0, m1 = gt_mod.find_matches(batch["kpts0"][i], batch["kpts1"][i],
                                             batch["homography"][i], batch["valid0"][i],
                                             batch["valid1"][i], dist_thresh=3.0, n_iters=1)
                r, v = gt_mod.build_gt_rows(m0, m1, batch["valid0"][i], batch["valid1"][i], 0)
                rows.append(r)
                valid.append(v)
            batch["gt_rows"], batch["gt_valid"] = torch.stack(rows), torch.stack(valid)
        bsz, nrows, _ = batch["gt_rows"].shape
        b_idx = torch.arange(bsz, dtype=torch.int32,
                             device=batch["gt_rows"].device).repeat_interleave(nrows)
        rows = batch["gt_rows"].reshape(bsz * nrows, 3)
        rows = torch.cat([b_idx[:, None], rows[:, 1:]], dim=1)
        gt_valid = batch["gt_valid"].reshape(bsz * nrows)

        model = state.model
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        total, (pos, neg, updates) = pipeline.training_forward(
            model, acfg, batch["kpts0"], batch["desc0"], batch["valid0"],
            batch["kpts1"], batch["desc1"], batch["valid1"], rows, gt_valid, image_shape)
        total.backward()
        metrics = {"total_loss": total.detach(), "pos_loss": pos.detach(),
                   "neg_loss": neg.detach(),
                   "vec": torch.stack([pos, neg, total]).detach()}
        grads, metrics, updates = mean_across(group, _grads(params), metrics, updates)
        upd, state.opt_state = tx.update(grads, state.opt_state, params)
        apply_updates(params, upd)
        if state.ema_params is not None:
            state.ema_params, state.ema_updates = ema_update(
                state.ema_params, params, state.ema_updates)
        apply_batch_stats(model, updates)
        state.step += 1
        return state, metrics

    return step


def make_distributed_train_step(cfg: GIMSConfig, tx: Optimizer, image_shape, group):
    """The data-parallel step (JAX: the step under ``shard_map`` over the
    data axis). Each rank calls it with its own rows of the global batch
    (``multihost.process_batch_slice``) and its replica of the state; the
    gradients, metrics and batch statistics are averaged over `group`."""
    return make_train_step(cfg, tx, image_shape, group=group)
