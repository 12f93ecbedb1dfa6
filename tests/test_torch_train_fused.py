"""The fused end-to-end trainer of the PyTorch port against the JAX package,
on the CPU, and its loop and CLI.

- ``make_fused_e2e_train_step`` at 120x160 with a 512-keypoint budget (the
  256-d matcher of ``tests/test_train.py``'s fused step with one self and one
  cross layer in place of its four, remat on,
  dense AGC 40/5/2, the CNN in f32 in both packages, InfoNCE weight 1): the
  same keypoints (1e-3 px) and validity from the fused extraction, total,
  pos and neg losses 1e-4 relative, and every parameter's gradient of both
  subtrees within 1e-5 + rtol * max|g_jax| per tensor: rtol 1e-3 for the
  matcher's, 2e-2 for the CNN's, whose every gradient above 1e-6 is also at
  a cosine of at least 0.99999 to JAX's (each sums cancelling terms over
  every pixel of the pyramid, in another order: measured up to 2e-3 with
  torch on 8 threads, 5.7e-3 on one, on the first FRN's single weight);
  the freeze gating as ``tests/test_train.py`` runs it. The random starts are the port's
  modules' (a flax init would take longer than the test), carried to JAX
  by the weight maps.
- ``descriptor_info_nce`` on random unit descriptors: 1e-5 (JAX takes its
  product at Precision.HIGH, bf16x3, which on the CPU is f32; the port
  computes in f32).
- ``train()`` on the CPU with ``max_steps=2``, then its resume from
  ``last``, which continues the optimizer's step count, then one step over
  two CPU ranks (a pair each); under ``multihost`` it raises, as the JAX
  loop does; and one CLI run with ``--device cpu``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gims_tpu import fused as jfused
from gims_tpu.carhynet.model import CARHyNet as JCARHyNet
from gims_tpu.config import AGCConfig as JAGCConfig
from gims_tpu.config import DatasetConfig as JDatasetConfig
from gims_tpu.config import FrontendConfig as JFrontendConfig
from gims_tpu.config import MatcherConfig as JMatcherConfig
from gims_tpu.frontend.detect_device import build_gray_blur
from gims_tpu.matcher import pipeline as jpipeline
from gims_tpu.train import data as jdata
from gims_tpu.train import fused_step as jfstep
from gims_tpu.train import gt as jgt
from gims_tpu_torch.api import init_gmatcher_variables
from gims_tpu_torch.carhynet import convert as cconvert
from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.cli import train_cli
from gims_tpu_torch.config import (AGCConfig, DatasetConfig, FrontendConfig, GIMSConfig,
                                   MatcherConfig, OptimizerConfig, TrainConfig)
from gims_tpu_torch.fused import octave_budgets
from gims_tpu_torch.matcher.convert import load_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.train import fused_step as tfstep
from gims_tpu_torch.train import loop as tloop
from gims_tpu_torch.train import step as tstep
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E = os.path.join(REPO, "weights", "gims_tpu_dense_gray_e2e.npz")
H, W = 120, 160
MATCHER = dict(descriptor_dim=256, keypoint_encoder=(32, 64), num_gnn_layers=2,
               sinkhorn_iterations=5, input_dim=256, remat=True)
AGC = dict(radius=40.0, percentile=5.0, min_size=2)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def fused_case():
    """One synthetic pair, JAX's joint variables, and JAX's fused e2e loss
    and gradients (the loss of gims_tpu/train/fused_step.py, composed of
    the JAX package's functions)."""
    ds = jdata.SyntheticPairDataset(JDatasetConfig(image_height=H, image_width=W,
                                                   apply_color_aug=False), length=1, seed=0)
    img0, img1, hmat = ds[0]
    g0 = (np.asarray(img0, np.int32) @ [3735, 19235, 9798] + (1 << 14)) >> 15
    g1 = (np.asarray(img1, np.int32) @ [3735, 19235, 9798] + (1 << 14)) >> 15
    g0, g1 = g0.astype(np.uint8), g1.astype(np.uint8)
    jm = JMatcherConfig(**MATCHER)
    fe = JFrontendConfig(descriptor_source="dense_gray", dense_dtype="float32")
    # random starts made by the port's modules, in the JAX layout (a flax
    # init would dispatch op by op here)
    torch.manual_seed(0)
    car_vars = cconvert.module_variables(CARHyNet(dense=True, in_channels=1))
    m_vars = init_gmatcher_variables(MatcherConfig(**MATCHER), seed=0)
    budgets = jfused.octave_budgets(H, W, 512)
    blur = build_gray_blur(H, W)
    dense_model = JCARHyNet(dense=True, in_channels=1)
    acfg = JAGCConfig(**AGC)

    def loss_fn(params):
        car = {"params": params["carhynet"], "batch_stats": car_vars["batch_stats"]}
        kp0, _, va0, de0 = jfused._extract_side(g0, H, W, budgets, fe, car, None,
                                                dense_model, blur)
        kp1, _, va1, de1 = jfused._extract_side(g1, H, W, budgets, fe, car, None,
                                                dense_model, blur)
        m0, m1 = jgt.find_matches(kp0, kp1, hmat, va0, va1, dist_thresh=3.0, n_iters=1)
        rows, row_valid = jgt.build_gt_rows(m0, m1, va0, va1, batch_index=0)
        total, (pos, neg, _) = jpipeline.training_forward(
            {"params": params["gmatcher"], "batch_stats": m_vars["batch_stats"]}, jm, acfg,
            kp0[None], de0[None], va0[None], kp1[None], de1[None], va1[None],
            rows, row_valid, (H, W))
        dnce = jfstep.descriptor_info_nce(de0[:, :128], de1[:, :128], m0, m1, va0, va1)
        return total + dnce, (pos, neg, dnce, kp0, va0, kp1, va1)

    params = {"gmatcher": m_vars["params"], "carhynet": car_vars["params"]}
    (total, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    pos, neg, dnce, kp0, va0, kp1, va1 = as_np(aux)
    return {"g0": g0, "g1": g1, "hmat": hmat, "m_vars": m_vars, "car_vars": car_vars,
            "total": float(total), "pos": float(pos), "neg": float(neg), "nce": float(dnce),
            "kp": (kp0, kp1), "va": (va0, va1), "grads": as_np(grads)}


def port_config(**train):
    return GIMSConfig(
        matcher=MatcherConfig(**MATCHER), agc=AGCConfig(**AGC),
        frontend=FrontendConfig(descriptor_source="dense_gray", dense_dtype="float32"),
        optimizer=OptimizerConfig(),
        train=TrainConfig(desc_loss_weight=1.0, **train))


def port_state(case, cfg):
    matcher = GMatcher(cfg.matcher, param_dtype=torch.float32)
    load_variables(matcher, case["m_vars"])
    car = CARHyNet(dense=True, in_channels=1)
    cconvert.load_variables(car, case["car_vars"])
    return tstep.create_train_state(cfg, tfstep.joint_variables(matcher, car), num_batches=10)


def port_batch(case):
    return {"img0_u8": torch.from_numpy(case["g0"])[None],
            "img1_u8": torch.from_numpy(case["g1"])[None],
            "homography": torch.from_numpy(case["hmat"])[None]}


def test_fused_e2e_step_losses_and_gradients_match_jax(fused_case, monkeypatch):
    case = fused_case
    cfg = port_config()
    state, tx = port_state(case, cfg)
    budgets = octave_budgets(H, W, 512)
    # the extraction's keypoints equal JAX's (the precondition of the rest)
    from gims_tpu_torch import fused as tfused

    seen = []
    real = tfused._extract_side
    monkeypatch.setattr(tfused, "_extract_side",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    step = tfstep.make_fused_e2e_train_step(cfg, tx, (H, W), budgets)
    state, metrics = step(state, port_batch(case))
    for side, (kp, _, va, _) in enumerate(seen):
        np.testing.assert_array_equal(va[0].numpy(), case["va"][side])
        ok = case["va"][side]
        assert np.abs(kp[0].detach().numpy()[ok] - case["kp"][side][ok]).max() <= 1e-3
    assert ok.sum() > 50
    for key, name in (("total_loss", "total"), ("pos_loss", "pos"), ("neg_loss", "neg")):
        want = case[name]
        assert abs(metrics[key].item() - want) <= 1e-4 * max(1.0, abs(want)), key
    assert case["nce"] > 0
    matcher, car = tfstep.split_joint(state.model)
    ref = GMatcher(cfg.matcher, param_dtype=torch.float32)
    load_variables(ref, {"params": case["grads"]["gmatcher"],
                         "batch_stats": case["m_vars"]["batch_stats"]})
    ref_car = CARHyNet(dense=True, in_channels=1)
    cconvert.load_variables(ref_car, {"params": case["grads"]["carhynet"],
                                      "batch_stats": case["car_vars"]["batch_stats"]})
    for model, want, rtol in ((matcher, ref, 1e-3), (car, ref_car, 2e-2)):
        want = dict(want.named_parameters())
        for name, p in model.named_parameters():
            g = want[name].detach()
            tol = 1e-5 + rtol * g.abs().max().item()
            assert (p.grad - g).abs().max().item() <= tol, name
            if model is car and g.abs().max() > 1e-6:
                cos = torch.nn.functional.cosine_similarity(p.grad.flatten(), g.flatten(), dim=0)
                assert cos.item() >= 0.99999, name
    assert state.step == 1


def test_fused_e2e_freeze_gates_the_matcher(fused_case):
    """As tests/test_train.py: from the state after one step (step 0 runs at
    lr 0 in the warmup), freeze_steps=2 holds the matcher's parameters while
    the CNN learns, then releases them."""
    case = fused_case
    cfg = port_config()
    state, tx = port_state(case, cfg)
    budgets = octave_budgets(H, W, 512)
    batch = port_batch(case)
    state, _ = tfstep.make_fused_e2e_train_step(cfg, tx, (H, W), budgets)(state, batch)
    fstep = tfstep.make_fused_e2e_train_step(cfg, tx, (H, W), budgets, freeze_steps=2)

    def snapshot():
        return {n: p.detach().clone() for n, p in state.model.named_parameters()}

    def moved(a, b, sub):
        return max((a[n] - b[n]).abs().max().item() for n in a if n.startswith(sub + "."))

    s1 = snapshot()
    state, _ = fstep(state, batch)
    s2 = snapshot()
    assert moved(s1, s2, "gmatcher") == 0
    assert moved(s1, s2, "carhynet") > 0
    state, _ = fstep(state, batch)
    s3 = snapshot()
    assert moved(s2, s3, "gmatcher") > 0 and moved(s2, s3, "carhynet") > 0


def test_descriptor_info_nce_matches_jax():
    rng = np.random.RandomState(6)
    d0, d1 = (rng.randn(50, 128).astype(np.float32) for _ in range(2))
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    m0 = np.where(rng.rand(50) < 0.5, rng.permutation(50), -1).astype(np.int32)
    m1 = np.full(50, -1, np.int32)
    m1[m0[m0 >= 0]] = np.nonzero(m0 >= 0)[0]
    va0, va1 = rng.rand(50) < 0.9, rng.rand(50) < 0.9
    want = float(jfstep.descriptor_info_nce(d0, d1, m0, m1, va0, va1))
    got = tfstep.descriptor_info_nce(*(torch.from_numpy(x) for x in (d0, d1, m0, m1, va0, va1)))
    assert abs(got.item() - want) <= 1e-5 * max(1.0, want)


def loop_config(tmp_path, **train):
    return GIMSConfig(
        matcher=MatcherConfig(sinkhorn_iterations=5, match_threshold=0.02, neg_cells="dustbin",
                              remat=True, attention_impl="direct"),
        agc=AGCConfig(radius=15, percentile=2, min_size=7),
        frontend=FrontendConfig(descriptor_source="dense_gray", upsample=False,
                                dense_dtype="float32"),
        dataset=DatasetConfig(image_height=96, image_width=128),
        optimizer=OptimizerConfig(warmup_epochs=0, step_epoch=1, step_value=0.75),
        train=TrainConfig(output_dir=str(tmp_path), max_keypoints=256, val_images_count=1,
                          use_ema=True, freeze_gmatcher_epochs=1, desc_loss_weight=1.0,
                          num_epochs=2, **train))


def test_train_loop_and_resume(tmp_path):
    """train() for 2 steps (one frozen epoch of 2 pairs), warm-started from
    the joint e2e weights; then a resume from ``last`` takes one more step:
    the optimizer's count, the step and the EMA updates continue at 3."""
    cfg = loop_config(tmp_path)
    logs = []
    state = tloop.train(cfg, save_dir=str(tmp_path / "run"), limit=2, max_steps=2,
                        fused_e2e=True, init_weights=E2E, device="cpu", log_fn=logs.append)
    assert state.step == 2 and state.opt_state["count"] == 2 and state.ema_updates == 2
    weights = tmp_path / "run" / "weights"
    for name in ("last.pt", "best.pt", "minloss.pt", "last.npz", "last_car.npz"):
        assert (weights / name).exists(), name
    recs = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert len(recs) == 2 and all(np.isfinite(r["total_loss"]) for r in recs)
    assert any(str(x).startswith("Validation:") for x in logs)
    resumed = tloop.train(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=3)), save_dir=str(tmp_path / "run"), limit=2, max_steps=3,
        fused_e2e=True, restore_path=str(weights / "last"), device="cpu", log_fn=logs.append)
    assert resumed.step == 3 and resumed.opt_state["count"] == 3 and resumed.ema_updates == 3
    with pytest.raises(NotImplementedError, match="multihost fused_e2e"):
        tloop.train(cfg, fused_e2e=True, multihost=True, device="cpu")
    dp = tloop.train(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=1, freeze_gmatcher_epochs=0)), save_dir=str(tmp_path / "dp"),
        limit=2, fused_e2e=True, init_weights=E2E, n_devices=2, device="cpu")
    assert dp.step == 1 and (tmp_path / "dp" / "weights" / "last_car.npz").exists()


def test_train_cli_runs_on_cpu(tmp_path):
    cfg_path = tmp_path / "e2e.yaml"
    cfg_path.write_text(f"""train_params:
  output_dir: {tmp_path}
  experiment_name: e2e
  max_keypoints: 256
  val_images_count: 1
  use_ema: true
  neg_cells: dustbin
  sinkhorn_iterations: 5
  match_threshold: 0.02
  remat: true
  attention_impl: direct
  freeze_gmatcher_epochs: 1
  desc_loss_weight: 1.0
optimizer_params:
  warmup_epochs: 0
dataset_params:
  image_height: 96
  image_width: 128
agc:
  radius: 15
  percentile: 2
  min_size: 7
frontend_params:
  descriptor_source: dense_gray
  upsample: false
  dense_dtype: float32
""")
    state = train_cli.main(["--config_path", str(cfg_path), "--name", "run", "--fused_e2e",
                            "--limit", "2", "--max_steps", "1", "--device", "cpu",
                            "--descriptor_source", "dense_gray"])
    assert state.step == 1
    assert (tmp_path / "run" / "weights" / "last.npz").exists()
    with pytest.raises(NotImplementedError, match="multihost fused_e2e"):
        train_cli.main(["--config_path", str(cfg_path), "--fused_e2e", "--device", "cpu",
                        "--coordinator", "127.0.0.1:1", "--num_processes", "2"])
