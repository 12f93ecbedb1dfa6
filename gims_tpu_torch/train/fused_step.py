"""End-to-end fused training: the descriptor CNN learns jointly with the
matcher through the single-program pipeline that inference runs.

Port of ``gims_tpu/train/fused_step.py:37-195``. The step takes the raw
gray image pair and its homography and runs the fused extraction
(``fused._extract_side``: DoG detection on the gray pyramid, the dense
gray CAR-HyNet maps, bilinear descriptor sampling) inside the loss, so
gradients flow through the descriptor samples into the dense CNN while the
matcher trains on the keypoints and descriptors the fused inference
produces. Detection (top-k, offsets) depends only on the pyramid, so it
carries no gradient. Ground truth is matched on the device from the
homography.

How the port keeps the JAX program's semantics:
- The CNN runs in eval mode (its running averages; the JAX step applies
  it with ``train=False``) and learns: its parameters stay f32 and are cast
  to ``dense_dtype`` (bf16) per call, so the gradients and Adam's moments
  are f32 (``CastCNN``). Its activations are recomputed in the backward
  (``torch.utils.checkpoint``, the JAX step's ``jax.checkpoint``).
- Only the matcher's batch statistics are updated.
- AGC gives no gradient and runs on detached descriptors
  (``pipeline.training_forward``).
- The InfoNCE loss is computed in f32; JAX computes its product at
  ``Precision.HIGH`` (bf16x3), which on the CPU is f32 too.
- The port's ``_extract_side`` takes a batch; here B = 1, as the JAX step
  asserts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn
from torch.func import functional_call
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.config import GIMSConfig
from gims_tpu_torch.matcher import pipeline
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.train import gt as gt_mod
from gims_tpu_torch.train import step as step_mod

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class CastCNN(nn.Module):
    """A CAR-HyNet whose f32 parameters and buffers are cast to `dtype`, as
    the JAX fused extraction casts its variables to ``dense_dtype``
    (``gims_tpu/fused.py:165-171``). The casts are made once, when the
    wrapper is built (once per step), and are in the graph, so the
    gradients reach the f32 parameters. On CUDA the convolution weights are
    cast to channels-last, the layout of the images the fused extraction
    feeds (as ``FusedMatching`` holds its CNN). Under autograd the network's
    activations are recomputed in the backward."""

    def __init__(self, model: CARHyNet, dtype: torch.dtype):
        super().__init__()
        self.model = model

        def cast(t):
            if not t.is_floating_point():
                return t
            if t.is_cuda and t.dim() == 4:
                return t.to(dtype=dtype, memory_format=torch.channels_last)
            return t.to(dtype)

        self.tensors = {n: cast(t) for n, t in list(model.named_parameters())
                        + list(model.named_buffers())}

    def _apply_cast(self, x):
        return functional_call(self.model, self.tensors, (x,))

    def forward(self, x):
        if torch.is_grad_enabled():
            return checkpoint(self._apply_cast, x, use_reentrant=False)
        return self._apply_cast(x)


def joint_variables(matcher: GMatcher, car_model: CARHyNet) -> nn.ModuleDict:
    """The matcher and the descriptor CNN as one trained module; its
    parameter names carry the JAX tree's prefixes, ``gmatcher.`` and
    ``carhynet.``."""
    return nn.ModuleDict({"gmatcher": matcher, "carhynet": car_model})


def split_joint(joint: nn.ModuleDict):
    """Inverse of joint_variables: (matcher, car_model)."""
    return joint["gmatcher"], joint["carhynet"]


def descriptor_info_nce(d0, d1, m0, m1, va0, va1, tau: float = 0.1):
    """Symmetric InfoNCE over the ground-truth correspondences.

    d0/d1: (N, D) L2-normalized descriptors (the 128-d halves); m0/m1 the
    index of each keypoint's match on the other side (-1: none); va0/va1
    validity. Every valid keypoint of the other side is a negative."""
    big_neg = -1e9

    def one_side(da, db, ma, vb):
        logits = (da @ db.T) / tau
        logits = torch.where(vb[None, :], logits, big_neg)
        logp = torch.log_softmax(logits, dim=1)
        pos = ma >= 0
        picked = torch.gather(logp, 1, ma.clamp(min=0).long()[:, None])[:, 0]
        cnt = torch.clamp(pos.float().sum(), min=1.0)
        return -torch.where(pos, picked, 0.0).sum() / cnt

    return 0.5 * (one_side(d0, d1, m0, va1) + one_side(d1, d0, m1, va0))


def make_fused_e2e_train_step(cfg: GIMSConfig, tx: step_mod.Optimizer, image_shape, budgets,
                              freeze_steps: int = 0, group=None):
    """step(state, batch) -> (state, metrics); the state's model is the
    ``joint_variables`` module, updated in place.

    batch: img0_u8, img1_u8 (1, H, W) uint8 gray, homography (1, 3, 3) f32,
    on the model's device.

    freeze_steps > 0: for the first freeze_steps optimizer steps the
    matcher is held fixed, its gradients and its updates (weight decay
    included) zeroed, while the CNN learns; Adam's moments of the matcher
    still decay over those steps, as optax's do. cfg.train.desc_loss_weight
    > 0 adds the InfoNCE descriptor loss on the ground-truth matches.

    group: a ``torch.distributed`` group (the JAX step's ``axis_name``; one
    pair per rank): gradients, metrics and the matcher's batch statistics
    are averaged over its ranks before the freeze gate and the optimizer, as
    the JAX step pmeans them (``gims_tpu/train/fused_step.py:160-163``).
    """
    from gims_tpu_torch.fused import _extract_side

    acfg = cfg.agc
    dlw = float(cfg.train.desc_loss_weight)
    fe = dataclasses.replace(cfg.frontend, descriptor_source="dense_gray")
    cnn_dtype = _DTYPES[fe.dense_dtype]

    def step(state: step_mod.TrainState, batch):
        img0, img1, hmat = batch["img0_u8"], batch["img1_u8"], batch["homography"]
        if img0.shape[0] != 1:
            raise ValueError("the fused e2e step is per pair (B = 1)")
        joint = state.model
        matcher, car_model = split_joint(joint)
        params = dict(joint.named_parameters())
        for p in params.values():
            p.grad = None
        cnn = CastCNN(car_model, cnn_dtype)
        # record_function ranges name the step's stages in a profiler trace
        # (chip_smoke.py phase 16); the forward's own are gims.agc,
        # gims.encoder, gims.trunk and gims.sinkhorn
        with record_function("gims.train.extract"):
            kp0, _, va0, de0 = _extract_side(img0, budgets, fe, cnn)
            kp1, _, va1, de1 = _extract_side(img1, budgets, fe, cnn)
            m0, m1 = gt_mod.find_matches(kp0[0], kp1[0], hmat[0], va0[0], va1[0],
                                         dist_thresh=3.0, n_iters=1)
            rows, row_valid = gt_mod.build_gt_rows(m0, m1, va0[0], va1[0], batch_index=0)
        total, (pos, neg, updates) = pipeline.training_forward(
            matcher, acfg, kp0, de0, va0, kp1, de1, va1, rows, row_valid, image_shape)
        if dlw > 0:
            dnce = descriptor_info_nce(de0[0, :, :128], de1[0, :, :128], m0, m1, va0[0], va1[0])
            total = total + dlw * dnce
        with record_function("gims.train.backward"):
            total.backward()
        metrics = {"total_loss": total.detach(), "pos_loss": pos.detach(),
                   "neg_loss": neg.detach(),
                   "vec": torch.stack([pos, neg, total]).detach()}
        with record_function("gims.train.optimizer"):
            grads, metrics, updates = step_mod.mean_across(
                group, step_mod._grads(params), metrics, updates)
            frozen = state.step < freeze_steps
            if frozen:
                grads = {n: torch.zeros_like(g) if n.startswith("gmatcher.") else g
                         for n, g in grads.items()}
            upd, state.opt_state = tx.update(grads, state.opt_state, params)
            if frozen:
                upd = {n: u for n, u in upd.items() if not n.startswith("gmatcher.")}
            step_mod.apply_updates(params, upd)
            if state.ema_params is not None:
                state.ema_params, state.ema_updates = step_mod.ema_update(
                    state.ema_params, params, state.ema_updates)
            step_mod.apply_batch_stats(matcher, updates)
        state.step += 1
        return state, metrics

    return step


def ema_modules(state: step_mod.TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """The EMA parameters (or the parameters, without EMA) split by
    subtree: {"gmatcher": {name: tensor}, "carhynet": {...}}, names
    relative to each module."""
    src = state.ema_params if state.ema_params is not None else state.params
    out = {"gmatcher": {}, "carhynet": {}}
    for name, t in src.items():
        sub, rest = name.split(".", 1)
        out[sub][rest] = t
    return out
