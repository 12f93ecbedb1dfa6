"""The training stack of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs, and the same weights carried across with the weight
maps (``matcher/convert.py``, ``carhynet/convert.py``), go through each JAX
function and its port. Tolerances:
- ``MaskedBatchNorm`` in train mode: outputs 1e-5, updated statistics 1e-6;
- ``remap_gt_to_dustbin`` (both ``neg_cells``): equal;
- ``training_forward`` on the tiny config of ``tests/test_train.py``
  (64-d, 4 GNN layers, 5 Sinkhorn iterations, f32): total, pos and neg
  losses 1e-5 relative, every parameter's gradient against ``jax.grad``
  within 1e-5 + 1e-4 * max|g_jax| per tensor (biases ahead of a batch norm
  have a gradient of 0 that both frameworks leave at ~1e-7), the updated
  batch statistics 1e-6;
- ``remat``: losses, gradients and statistics equal to 1e-6 with and
  without ``torch.utils.checkpoint``;
- ``lr_schedule`` two f32 ulps (2.4e-7 relative; XLA's and numpy's f32
  powers may round apart); ``weight_decay_mask`` equal;
- the optimizer alone against the optax chain, fed the same gradients for
  5 steps (Adam and Nesterov SGD, weight decay on): parameters 1e-6;
- ``ema_update``: 1e-7;
- the identity init's deterministic entries: equal;
- one ``make_train_step`` against JAX's: losses 1e-5 relative, the updated
  parameters 1e-6 where the gradient is above 1e-4 (Adam's first step moves
  each parameter by about lr * sign(g), so a gradient that is 0 up to
  rounding may move either way in either framework) and the batch
  statistics 1e-6;
- ``SyntheticPairDataset``: H equal in f32; images equal but for one level
  on at most 0.1% of the pixels (OpenCV's warp has 5-bit weights); the
  folder, mixed and fixed datasets on blurred PNG sources: at most two
  levels (a warp's level scaled by the photometric gain) on at most 2%
  (measured 0.82% on one warped image);
- ``INTER_AREA`` resizes: at most one level on at most 0.01% of the pixels;
  ``filter2D``: 1e-4 on the 0..255 scale;
- npz round trips: the JAX checkpoint through the port and back is equal
  leaf for leaf; the port's export runs in JAX, and JAX's export in the
  port, with an equal forward (Z within 1e-4).
"""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from gims_tpu.api import init_gmatcher_variables as jinit
from gims_tpu.config import AGCConfig as JAGCConfig
from gims_tpu.config import DatasetConfig as JDatasetConfig
from gims_tpu.config import GIMSConfig as JGIMSConfig
from gims_tpu.config import MatcherConfig as JMatcherConfig
from gims_tpu.config import OptimizerConfig as JOptimizerConfig
from gims_tpu.config import TrainConfig as JTrainConfig
from gims_tpu.core import checkpoint as jckpt
from gims_tpu.matcher import pipeline as jpipeline
from gims_tpu.matcher.gmatcher import GMatcher as JGMatcher
from gims_tpu.matcher.layers import MaskedBatchNorm as JMaskedBatchNorm
from gims_tpu.train import data as jdata
from gims_tpu.train import step as jstep
from gims_tpu_torch.api import init_gmatcher_variables
from gims_tpu_torch.config import (AGCConfig, DatasetConfig, GIMSConfig, MatcherConfig,
                                   OptimizerConfig, TrainConfig)
from gims_tpu_torch.core import checkpoint as tckpt
from gims_tpu_torch.core import imgproc
from gims_tpu_torch.matcher import pipeline as tpipeline
from gims_tpu_torch.matcher.convert import load_variables, module_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.matcher.layers import MaskedBatchNorm, batch_stat_updates
from gims_tpu_torch.train import data as tdata
from gims_tpu_torch.train import step as tstep
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

TINY = dict(descriptor_dim=64, keypoint_encoder=(32, 64), num_gnn_layers=4,
            sinkhorn_iterations=5, input_dim=64)
AGC = dict(radius=60.0, percentile=10.0, min_size=2)
SHAPE = (480, 640)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_batch(seed, b=2, nb=40, d=64):
    """tests/test_train.py's tiny batch, with a padded tail on one side."""
    rng = np.random.RandomState(seed)
    batch = {"kpts0": rng.rand(b, nb, 2).astype(np.float32) * 300,
             "desc0": rng.randn(b, nb, d).astype(np.float32),
             "valid0": np.ones((b, nb), bool),
             "kpts1": rng.rand(b, nb, 2).astype(np.float32) * 300,
             "desc1": rng.randn(b, nb, d).astype(np.float32),
             "valid1": np.ones((b, nb), bool),
             "gt_rows": rng.randint(-1, nb, (b, 2 * nb, 3)).astype(np.int32),
             "gt_valid": np.ones((b, 2 * nb), bool)}
    batch["valid1"][1, nb - 5:] = False
    batch["kpts1"][1, nb - 5:] = 1e6
    return batch


def flat_rows(batch):
    b, r, _ = batch["gt_rows"].shape
    rows = batch["gt_rows"].reshape(b * r, 3).copy()
    rows[:, 0] = np.repeat(np.arange(b), r)
    return rows, batch["gt_valid"].reshape(b * r)


def port_grads_of(jax_grads, jax_stats, mcfg):
    """JAX gradient and statistics trees in the port's layout (the weight
    maps permute and transpose a gradient as they do its parameter)."""
    ref = GMatcher(mcfg, param_dtype=torch.float32)
    load_variables(ref, {"params": jax_grads, "batch_stats": jax_stats})
    return dict(ref.named_parameters()), dict(ref.named_buffers())


def assert_grads_close(model, want):
    for name, p in model.named_parameters():
        g = want[name].detach()
        tol = 1e-5 + 1e-4 * g.abs().max().item()
        assert (p.grad - g).abs().max().item() <= tol, name


def test_masked_batchnorm_train_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 30, 8).astype(np.float32) * 3 + 1
    mask = rng.rand(2, 30) < 0.7
    jm = JMaskedBatchNorm(8)
    jv = jm.init(jax.random.PRNGKey(0), x, mask, False)
    jv = {"params": {"scale": rng.rand(8).astype(np.float32) + 0.5,
                     "bias": rng.randn(8).astype(np.float32)},
          "batch_stats": {"mean": rng.randn(8).astype(np.float32),
                          "var": rng.rand(8).astype(np.float32) + 0.5}}
    want, upd = jm.apply(jv, x, mask, True, mutable=["batch_stats"])
    m = MaskedBatchNorm(8)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(jv["params"]["scale"]))
        m.bias.copy_(torch.from_numpy(jv["params"]["bias"]))
        m.running_mean.copy_(torch.from_numpy(jv["batch_stats"]["mean"]))
        m.running_var.copy_(torch.from_numpy(jv["batch_stats"]["var"]))
    with batch_stat_updates() as stats:
        got = m(torch.from_numpy(x), torch.from_numpy(mask), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    mean, var = stats[m]
    np.testing.assert_allclose(mean.numpy(), upd["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(var.numpy(), upd["batch_stats"]["var"], atol=1e-6)
    # the buffers are left as they were; outside the block nothing is recorded
    np.testing.assert_array_equal(m.running_mean.numpy(), jv["batch_stats"]["mean"])
    m(torch.from_numpy(x), torch.from_numpy(mask), train=True)


@pytest.mark.parametrize("neg_cells", ["corner", "dustbin"])
def test_remap_gt_to_dustbin_matches_jax(neg_cells):
    rng = np.random.RandomState(1)
    b, nb0, nb1 = 2, 30, 25
    rows = rng.randint(-1, 30, (200, 3)).astype(np.int32)
    rows[:, 0] = rng.randint(0, b, 200)
    rows[:, 2] = np.minimum(rows[:, 2], nb1 - 1)
    valid = rng.rand(200) < 0.8
    kept0, kept1 = rng.rand(b, nb0) < 0.7, rng.rand(b, nb1) < 0.7
    want = jpipeline.remap_gt_to_dustbin(rows, valid, kept0, kept1, nb0, nb1, neg_cells)
    got = tpipeline.remap_gt_to_dustbin(torch.from_numpy(rows), torch.from_numpy(valid),
                                        torch.from_numpy(kept0), torch.from_numpy(kept1),
                                        nb0, nb1, neg_cells)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def tiny_forward():
    """training_forward of both packages on the tiny batch (dustbin
    negatives, so that they carry gradient), with JAX's value_and_grad."""
    kw = dict(TINY, neg_cells="dustbin")
    jm, tm = JMatcherConfig(**kw), MatcherConfig(**kw)
    variables = as_np(jinit(jm))
    batch = tiny_batch(0)
    rows, gv = flat_rows(batch)

    def loss(params):
        return jpipeline.training_forward(
            {"params": params, "batch_stats": variables["batch_stats"]}, jm,
            JAGCConfig(**AGC), batch["kpts0"], batch["desc0"], batch["valid0"],
            batch["kpts1"], batch["desc1"], batch["valid1"], rows, gv, SHAPE)

    (total, (pos, neg, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    want = {"total": float(total), "pos": float(pos), "neg": float(neg),
            "grads": as_np(grads), "stats": as_np(upd)["batch_stats"]}
    return tm, variables, batch, rows, gv, want


def port_forward(tm, variables, batch, rows, gv):
    model = GMatcher(tm, param_dtype=torch.float32)
    load_variables(model, variables)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, (pos, neg, upd) = tpipeline.training_forward(
        model, AGCConfig(**AGC), t["kpts0"], t["desc0"], t["valid0"], t["kpts1"], t["desc1"],
        t["valid1"], torch.from_numpy(rows), torch.from_numpy(gv), SHAPE)
    total.backward()
    return model, total, pos, neg, upd


def test_training_forward_losses_and_every_gradient_match_jax(tiny_forward):
    tm, variables, batch, rows, gv, want = tiny_forward
    model, total, pos, neg, upd = port_forward(tm, variables, batch, rows, gv)
    for name, value in (("total", total), ("pos", pos), ("neg", neg)):
        assert abs(value.item() - want[name]) <= 1e-5 * max(1.0, abs(want[name])), name
    assert want["neg"] > 0  # dustbin negatives carry loss
    grads, stats = port_grads_of(want["grads"], want["stats"], tm)
    assert_grads_close(model, grads)
    assert set(upd["batch_stats"]) == set(stats)
    for name, value in upd["batch_stats"].items():
        assert (value - stats[name]).abs().max().item() <= 1e-6, name


def test_remat_equals_no_remat(tiny_forward):
    """torch.utils.checkpoint recomputes each GNN layer in the backward;
    the batch statistics are taken once, in the forward."""
    tm, variables, batch, rows, gv, _ = tiny_forward
    outs = [port_forward(dataclasses.replace(tm, remat=r), variables, batch, rows, gv)
            for r in (False, True)]
    (m0, t0, _, _, u0), (m1, t1, _, _, u1) = outs
    assert abs(t0.item() - t1.item()) <= 1e-6
    g1 = dict(m1.named_parameters())
    for name, p in m0.named_parameters():
        assert (p.grad - g1[name].grad).abs().max().item() <= 1e-6, name
    for name, value in u0["batch_stats"].items():
        assert (value - u1["batch_stats"][name]).abs().max().item() <= 1e-6, name
    # one train step of each: the buffers after the step agree too
    for m, u in ((m0, u0), (m1, u1)):
        tstep.apply_batch_stats(m, u)
    b1 = dict(m1.named_buffers())
    for name, buf in m0.named_buffers():
        assert (buf - b1[name]).abs().max().item() <= 1e-6, name


def test_lr_schedule_and_weight_decay_mask_match_jax():
    o = dict(lr=3e-4, warmup_epochs=2, step_epoch=3, step_value=0.9)
    jfn = jstep.lr_schedule(JGIMSConfig(optimizer=JOptimizerConfig(**o)), 7)
    tfn = tstep.lr_schedule(GIMSConfig(optimizer=OptimizerConfig(**o)), 7)
    for s in range(0, 80):
        want = float(jfn(s))
        assert abs(tfn(s) - want) <= 2.4e-7 * max(want, 1e-12), s
    assert tfn(0) == 0.0
    jm = JMatcherConfig(**TINY)
    variables = as_np(jinit(jm))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jstep.weight_decay_mask(variables["params"]))[0]:
        keys = [p.key for p in path]
        want[".".join(keys[:-1] + [{"kernel": "weight", "scale": "weight"}.get(
            keys[-1], keys[-1])])] = bool(leaf)
    assert tstep.weight_decay_mask(GMatcher(MatcherConfig(**TINY))) == want
    assert sum(want.values()) and not all(want.values())


@pytest.mark.parametrize("opt_type", ["adam", "sgd"])
def test_optimizer_matches_optax(opt_type):
    """The same gradients for 5 steps, weight decay on, a warmup of one
    epoch of 2 steps (lr 0 at step 0)."""
    o = dict(opt_type=opt_type, lr=1e-2, weight_decay=5e-4, warmup_epochs=1, step_epoch=1,
             step_value=0.5)
    rng = np.random.RandomState(2)
    module = torch.nn.ModuleDict({"dense": torch.nn.Linear(4, 3),
                                  "norm": MaskedBatchNorm(3)})
    jparams = {"dense": {"kernel": module["dense"].weight.detach().numpy().T.copy(),
                         "bias": module["dense"].bias.detach().numpy().copy()},
               "norm": {"scale": module["norm"].weight.detach().numpy().copy(),
                        "bias": module["norm"].bias.detach().numpy().copy()}}
    tx = jstep.make_optimizer(JGIMSConfig(optimizer=JOptimizerConfig(**o)), 2, jparams)
    jstate = tx.init(jparams)
    topt = tstep.make_optimizer(GIMSConfig(optimizer=OptimizerConfig(**o)), 2, module)
    params = dict(module.named_parameters())
    tstate = topt.init(params)
    update = jax.jit(tx.update)
    for _ in range(5):
        g = {"dense": {"kernel": rng.randn(4, 3).astype(np.float32),
                       "bias": rng.randn(3).astype(np.float32)},
             "norm": {"scale": rng.randn(3).astype(np.float32),
                      "bias": rng.randn(3).astype(np.float32) * 1e-3}}
        upd, jstate = update(g, jstate, jparams)
        jparams = as_np(optax.apply_updates(jparams, upd))
        tg = {"dense.weight": torch.from_numpy(g["dense"]["kernel"].T.copy()),
              "dense.bias": torch.from_numpy(g["dense"]["bias"]),
              "norm.weight": torch.from_numpy(g["norm"]["scale"]),
              "norm.bias": torch.from_numpy(g["norm"]["bias"])}
        tupd, tstate = topt.update(tg, tstate, params)
        tstep.apply_updates(params, tupd)
        np.testing.assert_allclose(params["dense.weight"].detach().numpy().T,
                                   jparams["dense"]["kernel"], atol=1e-6)
        np.testing.assert_allclose(params["dense.bias"].detach().numpy(),
                                   jparams["dense"]["bias"], atol=1e-6)
        np.testing.assert_allclose(params["norm.weight"].detach().numpy(),
                                   jparams["norm"]["scale"], atol=1e-6)
        np.testing.assert_allclose(params["norm.bias"].detach().numpy(),
                                   jparams["norm"]["bias"], atol=1e-6)


def test_ema_update_matches_jax():
    rng = np.random.RandomState(3)
    e, p = rng.randn(5).astype(np.float32), rng.randn(5).astype(np.float32)
    for n in (0, 99, 4999):
        want, wn = jstep.ema_update({"a": e}, {"a": p}, jnp.asarray(n, jnp.int32))
        got, gn = tstep.ema_update({"a": torch.from_numpy(e)}, {"a": torch.from_numpy(p)}, n)
        assert gn == int(wn) == n + 1
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]), atol=1e-7)


def test_identity_init_deterministic_entries_match_jax():
    mcfg = MatcherConfig()
    want = as_np(jinit(JMatcherConfig(), scheme="identity"))["params"]
    got = init_gmatcher_variables(mcfg, scheme="identity")["params"]
    pairs = [(want["final_proj"], got["final_proj"]),
             (want["kenc"]["encoder"]["dense_4"], got["kenc"]["encoder"]["dense_4"])]
    pairs += [(want["gnn"][f"layer_{i}"]["mlp"]["dense_1"], got["gnn"][f"layer_{i}"]["mlp"]["dense_1"])
              for i in range(mcfg.num_gnn_layers)]
    pairs += [(want["gnn_encoder"][f"layer_{i}"], got["gnn_encoder"][f"layer_{i}"])
              for i in range(mcfg.sage_layers)]
    for w, g in pairs:
        w, g = jckpt.flatten_tree(w), tckpt.flatten_tree(g)
        assert set(w) == set(g)
        for leaf in w:
            assert g[leaf].dtype == np.float32
            np.testing.assert_array_equal(g[leaf], w[leaf])
    # the port loads its own identity init, and FusedMatching takes the knob
    load_variables(GMatcher(mcfg), init_gmatcher_variables(mcfg, scheme="identity"))


def test_train_step_matches_jax():
    kw = dict(TINY, neg_cells="dustbin")
    o = dict(warmup_epochs=0)
    jcfg = JGIMSConfig(matcher=JMatcherConfig(**kw), agc=JAGCConfig(**AGC),
                       optimizer=JOptimizerConfig(**o), train=JTrainConfig(use_ema=True))
    tcfg = GIMSConfig(matcher=MatcherConfig(**kw), agc=AGCConfig(**AGC),
                      optimizer=OptimizerConfig(**o), train=TrainConfig(use_ema=True))
    variables = as_np(jinit(jcfg.matcher))
    batch = tiny_batch(4)
    jstate, tx = jstep.create_train_state(jcfg, variables, num_batches=10)
    jstate1, jmetrics = jax.jit(jstep.make_train_step(jcfg, tx, SHAPE))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    model = GMatcher(tcfg.matcher, param_dtype=torch.float32)
    load_variables(model, variables)
    state, topt = tstep.create_train_state(tcfg, model, num_batches=10)
    state, metrics = tstep.make_train_step(tcfg, topt, SHAPE)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 1 and state.ema_updates == 1
    for key in ("total_loss", "pos_loss", "neg_loss"):
        want = float(jmetrics[key])
        assert abs(metrics[key].item() - want) <= 1e-5 * max(1.0, abs(want)), key
    ref = GMatcher(tcfg.matcher, param_dtype=torch.float32)
    load_variables(ref, {"params": as_np(jstate1.params),
                         "batch_stats": as_np(jstate1.batch_stats)})
    want_params = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        # the step leaves the gradients on the parameters (held to jax.grad's
        # in test_training_forward_losses_and_every_gradient_match_jax)
        sure = p.grad.abs() > 1e-4
        assert (p - want_params[name])[sure].abs().max().item() <= 1e-6 if sure.any() else True, name
    want_bufs = dict(ref.named_buffers())
    for name, b in model.named_buffers():
        assert (b - want_bufs[name]).abs().max().item() <= 1e-6, name


def test_synthetic_pair_dataset_matches_jax():
    kw = dict(image_height=120, image_width=160)
    jds = jdata.SyntheticPairDataset(JDatasetConfig(**kw), length=6, seed=0)
    tds = tdata.SyntheticPairDataset(DatasetConfig(**kw), length=6, seed=0)
    for i in range(6):
        (j0, j1, jh), (t0, t1, th) = jds[i], tds[i]
        np.testing.assert_array_equal(th, jh)
        assert th.dtype == np.float32
        for a, b in ((t0, j0), (t1, j1)):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("src,dst", [((600, 800), (300, 400)), ((601, 803), (480, 640)),
                                     ((300, 400), (100, 100)), ((97, 131), (64, 90)),
                                     ((120, 160), (240, 100)), ((480, 640), (600, 800))])
def test_inter_area_matches_cv2(src, dst):
    rng = np.random.RandomState(src[0] + dst[1])
    img = cv2.GaussianBlur(rng.randint(0, 256, src + (3,)).astype(np.uint8), (0, 0), 1.0)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = imgproc.resize(img, dst[::-1], imgproc.INTER_AREA)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4
    gray = imgproc.resize(img[..., 0], dst[::-1], imgproc.INTER_AREA)
    assert gray.shape == dst


@pytest.mark.parametrize("k", [3, 5, 7])
def test_filter2d_matches_cv2(k):
    rng = np.random.RandomState(k)
    img = (rng.rand(60, 80, 3) * 255).astype(np.float32)
    for row in (True, False):
        kernel = np.zeros((k, k), np.float32)
        if row:
            kernel[k // 2, :] = 1.0 / k
        else:
            kernel[:, k // 2] = 1.0 / k
        want = cv2.filter2D(img, -1, kernel)
        np.testing.assert_allclose(imgproc.filter2d(img, kernel), want, atol=1e-4)


def test_npz_round_trips_both_ways(tmp_path):
    """A JAX checkpoint through the port and back is the same tree; the
    port's export of a trained-looking GMatcher runs in JAX, and JAX's in
    the port, with equal Z."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jv = jckpt.unflatten_npz(os.path.join(repo, "weights", "gims_tpu_sift_last.npz"))
    model = GMatcher(MatcherConfig())
    load_variables(model, jv)
    back = tckpt.flatten_tree(module_variables(model))
    want = jckpt.flatten_tree(jv)
    assert set(back) == set(want)
    for key in want:
        assert back[key].shape == want[key].shape and np.array_equal(back[key], want[key]), key

    mcfg = MatcherConfig(**TINY)
    port = GMatcher(mcfg)
    with torch.no_grad():  # move the batch statistics off their defaults
        for buf in port.buffers():
            buf.copy_(torch.rand_like(buf) + 0.5)
    path = str(tmp_path / "port.npz")
    tckpt.save_npz(path, module_variables(port))
    jvars = jckpt.unflatten_npz(path)
    batch = tiny_batch(5)
    rng = np.random.RandomState(5)
    adj = [rng.rand(2, 40, 40) < 0.1 for _ in range(2)]
    args = (batch["kpts0"] / 300 - 0.5, batch["desc0"], adj[0], batch["valid0"],
            batch["kpts1"] / 300 - 0.5, batch["desc1"], adj[1], batch["valid1"])
    want_z = np.asarray(JGMatcher(JMatcherConfig(**TINY)).apply(jvars, *args)["Z"])
    with torch.no_grad():
        got_z = port(*(torch.from_numpy(np.asarray(a)) for a in args))["Z"].numpy()
    ok = want_z > -1e8
    np.testing.assert_allclose(got_z[ok], want_z[ok], atol=1e-4)

    jpath = str(tmp_path / "jax.npz")
    jckpt.save_npz(jpath, as_np(jinit(JMatcherConfig(**TINY), seed=3)))
    loaded = GMatcher(mcfg)
    load_variables(loaded, tckpt.unflatten_npz(jpath))
    want_z = np.asarray(JGMatcher(JMatcherConfig(**TINY)).apply(
        jckpt.unflatten_npz(jpath), *args)["Z"])
    with torch.no_grad():
        got_z = loaded(*(torch.from_numpy(np.asarray(a)) for a in args))["Z"].numpy()
    np.testing.assert_allclose(got_z[ok], want_z[ok], atol=1e-4)


CONFIGS = sorted(f for f in os.listdir(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")) if f.endswith(".yaml"))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_files_read_as_yaml_and_jax_read_them(name):
    """The port reads the config files without PyYAML (the GPU machine has
    none): the same tree as yaml.safe_load, and the same GIMSConfig fields
    as the JAX package's load_config."""
    import yaml

    from gims_tpu.config import load_config as jload
    from gims_tpu_torch.config import load_config, read_yaml

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", name)
    with open(path) as f:
        text = f.read()
    assert read_yaml(text) == yaml.safe_load(text)
    got, want = dataclasses.asdict(load_config(path)), dataclasses.asdict(jload(path))
    for section, fields in got.items():
        for key, value in fields.items():
            if key in want[section]:
                assert value == want[section][key] or (
                    isinstance(value, tuple) and list(value) == list(want[section][key])), (
                    section, key)


def test_image_folder_mixed_and_fixed_datasets_match_jax(tmp_path):
    """ImageFolderPairDataset on a folder of PNGs (random crop, INTER_AREA,
    then make_pair), MixedPairDataset's round robin and
    FixedHomographyDataset against the JAX package's (which reads with
    OpenCV): H equal, images differing on at most 2% of the pixels by at
    most two levels (OpenCV's warp has 5-bit weights, a one-level
    difference, which the photometric augmentation may scale by up to 1.4;
    on these blurred sources 0.82% of a warped image's pixels differ,
    against at most 0.03% on the synthetic noise textures). A JPEG raises,
    naming the ROADMAP item of its decoder."""
    from gims_tpu_torch.core.image_io import imwrite

    rng = np.random.RandomState(8)
    for i in range(2):
        img = cv2.GaussianBlur(rng.randint(0, 256, (150 + 10 * i, 210, 3)).astype(np.uint8),
                               (0, 0), 1.5)
        imwrite(str(tmp_path / f"s{i}.png"), img)
    kw = dict(image_height=96, image_width=128)
    jf = jdata.ImageFolderPairDataset(JDatasetConfig(**kw), str(tmp_path), length=4, seed=1)
    tf = tdata.ImageFolderPairDataset(DatasetConfig(**kw), str(tmp_path), length=4, seed=1)
    jm = jdata.MixedPairDataset([jdata.SyntheticPairDataset(JDatasetConfig(**kw), 2), jf])
    tm = tdata.MixedPairDataset([tdata.SyntheticPairDataset(DatasetConfig(**kw), 2), tf])
    txt = tmp_path / "homo.txt"
    hmat = np.array([[1.05, 0.02, 3.0], [-0.01, 0.98, 2.0], [1e-5, 2e-5, 1.0]])
    txt.write_text("s0.png " + " ".join(map(str, hmat.reshape(-1))) + "\n")
    jx = jdata.FixedHomographyDataset(JDatasetConfig(**kw), str(txt), str(tmp_path))
    tx = tdata.FixedHomographyDataset(DatasetConfig(**kw), str(txt), str(tmp_path))
    assert len(tm) == len(jm) == 6
    pairs = [(jf[i], tf[i]) for i in range(4)] + [(jm[i], tm[i]) for i in range(6)]
    for (j0, j1, jh), (t0, t1, th) in pairs + [(jx[0], tx[0])]:
        np.testing.assert_array_equal(th, jh)
        for a, b in ((t0, j0), (t1, j1)):
            assert a.shape == b.shape == (96, 128, 3)
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 2 and (d > 0).mean() <= 2e-2
    cv2.imwrite(str(tmp_path / "s2.jpg"), np.zeros((80, 80, 3), np.uint8))
    jpeg = tdata.ImageFolderPairDataset(DatasetConfig(**kw), str(tmp_path), length=3, seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jpeg[2]
