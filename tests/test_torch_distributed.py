"""Data parallelism and ring attention of the PyTorch port against the JAX
package, on the CPU.

Ranks are processes started with the spawn method, joined over gloo by a
file rendezvous in ``tmp_path``; their work is done by workers of the port
(``gims_tpu_torch/train/dp_check.py``), so no child imports JAX (each
reports its modules). Tolerances:

- the 2-rank ``make_distributed_train_step`` (tests/test_train.py's tiny
  config with ``use_layernorm=True``, no warmup, 4 pairs, 2 a rank) against
  JAX's ``make_distributed_train_step`` on a 2-device mesh: losses 2e-4
  relative; parameters within 2e-3 relative and 2e-5 absolute where the
  averaged gradient exceeds 1e-4, elsewhere within 2 lr + 2e-5 (Adam's first
  step moves a parameter by about lr * sign(g), and a gradient that is 0 up
  to rounding may take either sign); both ranks bit-equal;
- the fused end-to-end 2-rank step (one pair a rank): its averaged loss
  against the mean of the per-pair losses of undistributed steps, 1e-5
  relative; both ranks bit-equal, both subtrees moved;
- ``process_batch_slice`` against JAX's over a grid of (global, P, pid):
  equal, and the same ValueError;
- ``train(n_devices=2, device="cpu")`` and ``train_cli --devices 2``: one set
  of logs and checkpoints, from rank 0 (``train`` itself fails unless the
  ranks end bit-equal);
- ``FusedMatching(devices=[cpu, cpu])`` against ``devices=None`` on 4 pairs:
  every output equal;
- the ring's plain path at P = 2 and 4 against JAX's ``masked_attention_ring``
  on a 2- and 4-device mesh: 2e-5 (``tests/test_matcher.py``'s bar); the
  plain partials of key blocks merged against the direct attention: 2e-5.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from gims_tpu.api import init_gmatcher_variables as jinit
from gims_tpu.config import AGCConfig as JAGCConfig
from gims_tpu.config import GIMSConfig as JGIMSConfig
from gims_tpu.config import MatcherConfig as JMatcherConfig
from gims_tpu.config import OptimizerConfig as JOptimizerConfig
from gims_tpu.matcher.ring_attention import masked_attention_ring as jring
from gims_tpu.train import multihost as jmh
from gims_tpu.train import step as jstep
from gims_tpu_torch import fused as tfused
from gims_tpu_torch.api import init_gmatcher_variables
from gims_tpu_torch.carhynet.convert import load_car_checkpoint, module_variables
from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.cli import train_cli
from gims_tpu_torch.config import (AGCConfig, DatasetConfig, FrontendConfig, GIMSConfig,
                                   MatcherConfig, OptimizerConfig, TrainConfig, load_config)
from gims_tpu_torch.core import checkpoint as ckpt_io
from gims_tpu_torch.matcher import attention, ring_attention
from gims_tpu_torch.matcher.convert import load_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.synthetic import synthetic_image_pair
from gims_tpu_torch.train import data as tdata
from gims_tpu_torch.train import dp_check
from gims_tpu_torch.train import loop as tloop
from gims_tpu_torch.train import multihost as tmh
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E = os.path.join(REPO, "weights", "gims_tpu_dense_gray_e2e.npz")
TINY = dict(descriptor_dim=64, keypoint_encoder=(32, 64), num_gnn_layers=4,
            sinkhorn_iterations=5, input_dim=64, use_layernorm=True)
AGC = dict(radius=60.0, percentile=10.0, min_size=2)
SHAPE = (480, 640)
FUSED_MATCHER = dict(descriptor_dim=256, keypoint_encoder=(32, 64), num_gnn_layers=2,
                     sinkhorn_iterations=5, input_dim=256, remat=True)
FUSED_FRAME = (96, 128)
BLOCKED = {"jax", "jaxlib", "flax", "gims_tpu", "cv2"}


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_batch(seed, b, nb=40, d=64):
    """tests/test_train.py's tiny batch."""
    rng = np.random.RandomState(seed)
    return {"kpts0": rng.rand(b, nb, 2).astype(np.float32) * 300,
            "desc0": rng.randn(b, nb, d).astype(np.float32),
            "valid0": np.ones((b, nb), bool),
            "kpts1": rng.rand(b, nb, 2).astype(np.float32) * 300,
            "desc1": rng.randn(b, nb, d).astype(np.float32),
            "valid1": np.ones((b, nb), bool),
            "gt_rows": rng.randint(-1, nb, (b, 2 * nb, 3)).astype(np.int32),
            "gt_valid": np.ones((b, 2 * nb), bool)}


def fused_job(batch):
    """tests/test_torch_train_fused.py's 2-layer fused step at 96x128, 256
    keypoints, from the port's random starts."""
    torch.manual_seed(0)
    h, w = FUSED_FRAME
    cfg = GIMSConfig(matcher=MatcherConfig(**FUSED_MATCHER),
                     agc=AGCConfig(radius=40.0, percentile=5.0, min_size=2),
                     frontend=FrontendConfig(descriptor_source="dense_gray", upsample=False,
                                             dense_dtype="float32"),
                     dataset=DatasetConfig(image_height=h, image_width=w),
                     optimizer=OptimizerConfig(warmup_epochs=0),
                     train=TrainConfig(max_keypoints=256, desc_loss_weight=1.0))
    return {"kind": "fused", "cfg": cfg,
            "variables": init_gmatcher_variables(cfg.matcher, seed=0),
            "car_variables": module_variables(CARHyNet(dense=True, in_channels=1)),
            "batch": batch}


@pytest.fixture(scope="module")
def two_rank_steps(tmp_path_factory):
    """One 2-rank run of the classic job (against JAX) and the fused job,
    and JAX's 2-device step."""
    tcfg = GIMSConfig(matcher=MatcherConfig(**TINY), agc=AGCConfig(**AGC),
                      optimizer=OptimizerConfig(warmup_epochs=0))
    jcfg = JGIMSConfig(matcher=JMatcherConfig(**TINY), agc=JAGCConfig(**AGC),
                       optimizer=JOptimizerConfig(warmup_epochs=0))
    variables = as_np(jinit(jcfg.matcher))
    batch = tiny_batch(5, b=4)
    classic = {"kind": "classic", "cfg": tcfg, "variables": variables, "num_batches": 10,
               "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}
    ds = tdata.SyntheticPairDataset(DatasetConfig(image_height=FUSED_FRAME[0],
                                                  image_width=FUSED_FRAME[1],
                                                  apply_color_aug=False), length=2, seed=0)
    fused = fused_job(tloop.build_batch_e2e([ds[0], ds[1]], "cpu"))
    ranks = dp_check.run(dp_check.step_rank, ["cpu", "cpu"], "gloo",
                         {"jobs": [classic, fused]}, str(tmp_path_factory.mktemp("ranks")))

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jstate, tx = jstep.create_train_state(jcfg, variables, 10)
    dist = jstep.make_distributed_train_step(jcfg, tx, SHAPE, mesh)
    js, jm = dist(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    singles = [dp_check.train_step_job(dict(fused, batch={k: v[i:i + 1] for k, v in
                                                          fused["batch"].items()}),
                                       torch.device("cpu"))
               for i in range(2)]
    return {"ranks": ranks, "jax": (as_np(js.params), as_np(js.batch_stats), jm),
            "cfg": tcfg, "singles": singles, "fused": fused}


def test_children_import_no_jax(two_rank_steps):
    for rank in two_rank_steps["ranks"]:
        assert not BLOCKED & set(rank["modules"]), rank["modules"]


def test_distributed_step_matches_jax_two_devices(two_rank_steps):
    r0, r1 = (r["jobs"][0] for r in two_rank_steps["ranks"])
    jparams, jstats, jm = two_rank_steps["jax"]
    for key in ("total_loss", "pos_loss", "neg_loss"):
        want = float(jm[key])
        assert abs(r0["metrics"][key] - want) <= 2e-4 * max(1.0, abs(want)), key
    ref = GMatcher(two_rank_steps["cfg"].matcher, param_dtype=torch.float32)
    load_variables(ref, {"params": jparams, "batch_stats": jstats})
    want = dict(ref.named_parameters())
    lr = two_rank_steps["cfg"].optimizer.lr
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name
        diff = (p - want[name].detach()).abs()
        sure = r0["grads"][name].abs() > 1e-4
        assert (diff[sure] <= 2e-5 + 2e-3 * want[name].detach()[sure].abs()).all(), name
        assert (diff <= 2 * lr + 2e-5).all(), name


def test_fused_two_rank_loss_is_mean_of_pair_losses(two_rank_steps):
    r0, r1 = (r["jobs"][1] for r in two_rank_steps["ranks"])
    singles = two_rank_steps["singles"]
    want = np.mean([s["metrics"]["total_loss"] for s in singles])
    assert r0["metrics"]["total_loss"] == r1["metrics"]["total_loss"]
    assert abs(r0["metrics"]["total_loss"] - want) <= 1e-5 * abs(want)
    start = tloop._joint_from_variables(two_rank_steps["fused"]["cfg"],
                                        two_rank_steps["fused"]["variables"],
                                        two_rank_steps["fused"]["car_variables"], 10)
    moved = set()
    for name, p in start.named_parameters():
        assert torch.equal(r0["params"][name], r1["params"][name]), name
        if not torch.equal(p.detach(), r0["params"][name]):
            moved.add(name.split(".")[0])
    assert moved == {"gmatcher", "carhynet"}


@pytest.mark.parametrize("global_batch", [1, 2, 6, 8, 12])
def test_process_batch_slice_matches_jax(monkeypatch, global_batch):
    for n_proc in (1, 2, 3, 4):
        for pid in range(n_proc):
            monkeypatch.setattr(jax, "process_count", lambda n=n_proc: n)
            monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
            try:
                want = jmh.process_batch_slice(global_batch)
            except ValueError as e:
                with pytest.raises(ValueError, match="not divisible"):
                    tmh.process_batch_slice(global_batch, n_proc, pid)
                assert "not divisible" in str(e)
                continue
            assert tmh.process_batch_slice(global_batch, n_proc, pid) == want


def small_classic_cfg(tmp_path):
    cfg = load_config(os.path.join(REPO, "configs", "synth_sift.yaml"))
    return dataclasses.replace(
        cfg, dataset=dataclasses.replace(cfg.dataset, dataset_path=str(tmp_path / "none"),
                                         image_height=96, image_width=128),
        train=dataclasses.replace(cfg.train, max_keypoints=256, val_images_count=1,
                                  num_epochs=1, output_dir=str(tmp_path)),
        frontend=dataclasses.replace(cfg.frontend, descriptor_source="sift"))


def test_train_two_ranks_rank0_outputs(tmp_path):
    """Two steps of a global batch of 2 (one pair a rank): one line per step
    in metrics.jsonl and results.txt, the checkpoints of one run."""
    run = tmp_path / "run"
    state = tloop.train(small_classic_cfg(tmp_path), save_dir=str(run), limit=4, n_devices=2,
                        max_steps=2, device="cpu")
    assert state.step == 2 and state.opt_state["count"] == 2
    assert next(state.model.parameters()).device.type == "cpu"
    recs = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["total_loss"]) for r in recs)
    assert len((run / "results.txt").read_text().splitlines()) == 1  # one flush
    names = sorted(os.listdir(run / "weights"))
    # (validation scores 0 at this size: no best)
    assert names == ["last.npz", "last.pt", "lastiter.pt", "minloss.pt"], names
    saved = torch.load(run / "weights" / "last.pt", weights_only=True)
    for n, p in state.model.named_parameters():
        assert torch.equal(saved["params"][n], p.detach()), n


def test_train_cli_two_devices(tmp_path):
    yaml = tmp_path / "small.yaml"
    yaml.write_text(f"""train_params:
  output_dir: {tmp_path}
  max_keypoints: 256
  val_images_count: 1
  num_epochs: 1
dataset_params:
  dataset_path: {tmp_path / 'none'}
  image_height: 96
  image_width: 128
""")
    st = train_cli.main(["--config_path", str(yaml), "--name", "cli", "--limit", "2",
                         "--descriptor_source", "sift", "--device", "cpu", "--devices", "2"])
    assert st.step == 1
    assert len((tmp_path / "cli" / "metrics.jsonl").read_text().splitlines()) == 1
    assert (tmp_path / "cli" / "weights" / "last.npz").exists()


def test_fused_matching_split_equals_unsplit():
    h, w = FUSED_FRAME
    pairs = [synthetic_image_pair(s, (h, w)) for s in range(4)]
    imgs0, imgs1 = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    loaded = ckpt_io.unflatten_npz(E2E)
    kw = dict(variables={"params": loaded["params"], "batch_stats": loaded["batch_stats"]},
              car_variables=load_car_checkpoint(E2E[:-4] + "_car.npz"), total_keypoints=256)
    cfg = {"descriptor_source": "dense_gray", "upsample": False, "dense_dtype": "float32",
           "radius": 15, "percentile": 2, "min_size": 7, "sinkhorn_iterations": 20}
    whole = tfused.FusedMatching(cfg, device="cpu", **kw)
    split = tfused.FusedMatching(cfg, devices=["cpu", "cpu"], device="cpu", **kw)
    assert split.resolved_config() == whole.resolved_config()
    want = whole.collect_batch(whole.dispatch_batch(imgs0, imgs1))
    out = split.dispatch_batch(imgs0, imgs1)
    assert isinstance(out, list) and len(out) == 2 and out[0]["kept0"].shape[0] == 2
    got = split.collect_batch(out)
    assert len(got) == 4 and sum(int((g["matches0"] >= 0).sum()) for g in got) > 0
    for a, b in zip(got, want):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    with pytest.raises(ValueError, match="not divisible"):
        split.dispatch_batch(imgs0[:3], imgs1[:3])


def ring_inputs(seed=0, b=2, n=64, m=64, h=4, d=32):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, n, h, d).astype(np.float32)
    k = rng.randn(b, m, h, d).astype(np.float32)
    v = rng.randn(b, m, h, d).astype(np.float32)
    mask = rng.rand(b, m) > 0.3
    mask[1, m // 2:] = False  # a fully masked key block on every rank past the first half
    return q, k, v, mask


@pytest.mark.parametrize("p", [2, 4])
def test_ring_matches_jax(tmp_path, p):
    q, k, v, mask = ring_inputs()
    want = np.asarray(jring(*(jnp.asarray(x) for x in (q, k, v, mask)),
                            Mesh(np.array(jax.devices()[:p]), ("kp",))))
    case = {"q": torch.from_numpy(q), "k": torch.from_numpy(k), "v": torch.from_numpy(v),
            "mask": torch.from_numpy(mask)}
    ranks = dp_check.run(dp_check.ring_rank, ["cpu"] * p, "gloo", {"cases": [case]},
                         str(tmp_path))
    for r in ranks:
        assert not BLOCKED & set(r["modules"])
        got = r["cases"][0]
        assert got["launches"] == 0  # the plain version on the CPU
        np.testing.assert_allclose(got["out"].numpy(), want, rtol=2e-5, atol=2e-5)


def test_plain_partials_merge_to_direct():
    q, k, v, mask = (torch.from_numpy(x) for x in ring_inputs(1, n=50, m=96))
    want = attention.masked_attention_direct(q, k, v, mask)
    out = stats = None
    for blk in range(3):
        sl = slice(32 * blk, 32 * (blk + 1))
        o, st = attention.attention_partials_tiled(q, k[:, sl], v[:, sl], mask[:, sl])
        assert st.shape == (2, 50, 4, 2) and st.dtype == torch.float32
        out, stats = (o, st) if out is None else ring_attention.merge_partials(out, stats, o, st)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    whole, _ = attention.attention_partials_tiled(q, k, v, mask)
    np.testing.assert_array_equal(whole.numpy(),
                                  attention.masked_attention_tiled(q, k, v, mask).numpy())
