"""Training orchestration: the reference train.py:28-186 rebuilt, on one device.

Port of ``gims_tpu/train/loop.py``. Two trainers:

- the classic trainer (``fused_e2e=False``): per batch the host loads or
  synthesizes image pairs and their homographies; with
  ``descriptor_source="sift"`` each image is detected and described by
  OpenCV's SIFT as the port computes it (``frontend/sift.py``, on the
  device), topped up to exactly ``max_keypoints`` (``build_batch_raw``), and
  the step normalizes the descriptors and matches the ground truth
  (``train/step.py``); with another source the feature frontend extracts
  padded features (host-SIFT keypoints, topped up) and the ground truth is
  matched per pair (``build_batch``). Only the matcher trains. Validation
  runs the staged ``Matching`` with the EMA weights;
- the fused end-to-end trainer (``fused_e2e=True``): one step
  (``train/fused_step.py``) detects, describes, matches the ground truth and
  trains the descriptor CNN and the matcher on the device. Validation runs
  the fused inference program (``FusedMatching``).

Batches come from COCO when ``<dataset_path>/train2017`` exists (PNG or
JPEG files), else from synthetic pairs. A prefetch worker prepares batch
i + 1 while the device runs step i, and a side pool of threads extracts the
images of a batch. Checkpoint policy parity: lastiter every
``lastiter_every`` iterations, minloss on a new rolling-mean minimum every
``minloss_every``, last and best per epoch by the validation weighted score
(reference: train.py:155-184).

Where the port departs from the JAX package:
- Checkpoints. The JAX package writes orbax checkpoints; the port writes
  the same payload fields (epoch, iter, params, batch_stats, ema,
  ema_updates, opt_state, step) with ``torch.save`` to
  ``<save_dir>/weights/<name>.pt`` for the same names at the same moments,
  and ``restore_train_state`` reads them back. At every ``last`` and
  ``best`` it also exports the EMA weights (the parameters without EMA) in
  the JAX layout: ``<name>.npz`` (the matcher, as
  ``scripts/export_checkpoint.py`` writes it) and, for the fused trainer,
  ``<name>_car.npz`` (the CNN), which both packages load.
- Data parallelism: one process per rank (``train/multihost.py``).
  ``n_devices=N`` starts N ranks through ``torch.multiprocessing`` (spawn),
  rank r on ``cuda:r`` (or on the CPU with ``device="cpu"``), joined by a
  file rendezvous; ``multihost=True`` runs this process as one rank of a
  group already joined (``multihost.initialize``). The global batch is
  ``batch_size`` x the world size; each rank builds only its
  ``process_batch_slice`` rows and the step averages gradients, metrics
  and batch statistics over the ranks. Logging, results.txt,
  metrics.jsonl, checkpoints, the npz export and validation run on rank 0;
  the validation score is broadcast and a barrier closes the run. The
  fused trainer runs one pair per rank; under ``multihost`` it raises, as
  the JAX loop does. ``train`` returns rank 0's state.
- The loop runs on ``cuda`` unless ``device`` says otherwise. On CUDA each
  step's device time is taken with a pair of CUDA events and written to
  metrics.jsonl as ``step_ms`` (the JAX loop's ``model_time`` is the
  host's dispatch time, kept beside it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gims_tpu_torch.api import init_gmatcher_variables
from gims_tpu_torch.carhynet.convert import load_car_checkpoint
from gims_tpu_torch.carhynet.convert import load_variables as load_car_variables
from gims_tpu_torch.carhynet.convert import module_variables as car_module_variables
from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.config import GIMSConfig
from gims_tpu_torch.core import checkpoint as ckpt_io
from gims_tpu_torch.core.device import resolve_device
from gims_tpu_torch.core.imgproc import bgr_to_gray
from gims_tpu_torch.eval import metrics as M
from gims_tpu_torch.eval.homography import evaluate_pair
from gims_tpu_torch.frontend.feature import FeatureFrontend
from gims_tpu_torch.matcher.convert import load_variables, module_variables
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.train import data as data_mod
from gims_tpu_torch.train import fused_step as fstep_mod
from gims_tpu_torch.train import gt as gt_mod
from gims_tpu_torch.train import multihost as mh
from gims_tpu_torch.train import step as step_mod

MULTIHOST_FUSED = ("multihost fused_e2e is not wired, as in the JAX package "
                   "(gims_tpu/train/loop.py:220-221); run the fused trainer over the "
                   "local devices with n_devices")


def extract_batch(frontend, images, max_keypoints, seeds, pool=None):
    """images: list of (H, W, 3) uint8 -> stacked padded device tensors
    (kpts, desc, valid). Each image draws its top-up from its own
    RandomState (seeded by the caller), so a thread pool may extract the
    images concurrently."""
    def one(args):
        img, seed = args
        return frontend.extract_padded(img, max_keypoints=max_keypoints, bucket=max_keypoints,
                                       train_topup=True, rng=np.random.RandomState(seed))

    outs = list((pool.map if pool is not None else map)(one, zip(images, seeds)))
    return (torch.stack([o["kpts"] for o in outs]), torch.stack([o["desc"] for o in outs]),
            torch.stack([o["valid"] for o in outs]))


def row_seeds(idxs, base_seed: int) -> np.ndarray:
    """Per-image top-up seeds derived from dataset indices (originals first,
    then warps: the builders' image order), so cached batches keep the same
    noise across epochs."""
    idxs = np.asarray(idxs, np.int64)
    out = [(base_seed + 1000003 * idxs + 7919 * side) % (2**31 - 1) for side in (0, 1)]
    return np.concatenate(out).astype(np.int64)


def build_batch(frontend, pairs, max_keypoints, rng, pool=None, seeds=None):
    """pairs: list of (orig, warped, H) -> the train step's batch: padded
    keypoints and validity, the 128-d halves of the duplicated descriptors
    in bf16 (as the JAX package caches them), and each pair's ground-truth
    rows (reprojection at 3 px)."""
    origs = [p[0] for p in pairs]
    warps = [p[1] for p in pairs]
    if seeds is None:
        seeds = rng.randint(0, 2**31 - 1, size=2 * len(pairs))
    half = len(pairs)
    kp, de, va = extract_batch(frontend, origs + warps, max_keypoints, seeds, pool)
    hs = torch.from_numpy(np.stack([p[2] for p in pairs]).astype(np.float32)).to(kp.device)
    rows_list, valid_list = [], []
    for b in range(half):
        m0, m1 = gt_mod.find_matches(kp[b], kp[half + b], hs[b], va[b], va[half + b],
                                     dist_thresh=3.0, n_iters=1)
        rows, valid = gt_mod.build_gt_rows(m0, m1, va[b], va[half + b], batch_index=0)
        rows_list.append(rows)
        valid_list.append(valid)
    return {"kpts0": kp[:half], "desc0_h": de[:half, :, :128].to(torch.bfloat16),
            "valid0": va[:half],
            "kpts1": kp[half:], "desc1_h": de[half:, :, :128].to(torch.bfloat16),
            "valid1": va[half:],
            "gt_rows": torch.stack(rows_list), "gt_valid": torch.stack(valid_list)}


def build_batch_raw(fe_cfg, pairs, max_keypoints, rng, pool=None, seeds=None, device=None):
    """The raw SIFT batch: each image detected and described by OpenCV's
    SIFT (``frontend/sift.py``, on `device`) with its top-up, padded to
    max_keypoints; the step normalizes the descriptors and matches the
    ground truth from the homographies."""
    from gims_tpu_torch.frontend.sift import detect_and_describe_device

    dev = resolve_device(device)
    images = [p[0] for p in pairs] + [p[1] for p in pairs]
    if seeds is None:
        seeds = rng.randint(0, 2**31 - 1, size=len(images))
    nb = max_keypoints

    def one(args):
        img, seed = args
        kp, d = detect_and_describe_device(img, fe_cfg, max_keypoints, train_topup=True,
                                           rng=np.random.RandomState(seed), device=dev)
        n = min(len(kp), nb)
        kpts = np.full((nb, 2), 1e6, np.float32)
        kpts[:n] = kp.pt[:n]
        du8 = d.new_zeros((nb, 128))
        du8[:n] = d[:n]
        valid = np.zeros((nb,), bool)
        valid[:n] = True
        return kpts, du8, valid

    outs = list((pool.map if pool is not None else map)(one, zip(images, seeds)))
    half = len(pairs)
    kpts = torch.from_numpy(np.stack([o[0] for o in outs])).to(dev)
    du8 = torch.stack([o[1] for o in outs])
    valid = torch.from_numpy(np.stack([o[2] for o in outs])).to(dev)
    hs = np.stack([p[2] for p in pairs]).astype(np.float32)
    return {"kpts0": kpts[:half], "desc0_u8": du8[:half], "valid0": valid[:half],
            "kpts1": kpts[half:], "desc1_u8": du8[half:], "valid1": valid[half:],
            "homography": torch.from_numpy(hs).to(dev)}


def test_model(matcher, val_dataset, val_count: int, agc=None, min_matches: int = 12,
               device=None):
    """In-training validation (reference: utils/common.py:912-977):
    skipped pairs contribute penalty records (error=500, P=R=0)."""
    records = []
    for i in range(min(val_count, len(val_dataset))):
        image, warped, H = val_dataset[i]
        record, _ = evaluate_pair(matcher, image, warped, H, min_matches, agc, device=device)
        if record is None:
            record = {"error_dlt": 500.0, "error_ransac": 500.0,
                      "precision": 0.0, "recall": 0.0}
        records.append(record)
    thresholds = [5, 10, 25]
    results = {
        "dlt_auc": [100.0 * a for a in M.pose_auc([r["error_dlt"] for r in records],
                                                  thresholds)],
        "ransac_auc": [100.0 * a for a in M.pose_auc([r["error_ransac"] for r in records],
                                                     thresholds)],
        "precision": 100.0 * float(np.mean([r["precision"] for r in records])),
        "recall": 100.0 * float(np.mean([r["recall"] for r in records])),
        "thresholds": thresholds,
    }
    results["weight_score"] = M.weighted_score(results)
    return results


def build_batch_e2e(pairs, device):
    """Fused end-to-end batch: gray uint8 frames and the homography on
    `device` (the step detects and describes on the device)."""
    g0 = np.stack([bgr_to_gray(p[0]) for p in pairs])
    g1 = np.stack([bgr_to_gray(p[1]) for p in pairs])
    hs = np.stack([p[2] for p in pairs]).astype(np.float32)
    return {"img0_u8": torch.from_numpy(g0).to(device),
            "img1_u8": torch.from_numpy(g1).to(device),
            "homography": torch.from_numpy(hs).to(device)}


def _joint_from_variables(cfg: GIMSConfig, m_vars, car_vars, seed: int):
    """The trained module: a GMatcher with f32 parameters and the gray
    dense CAR-HyNet, loaded from JAX-layout trees (the CNN randomly
    initialized from `seed` where `car_vars` is None)."""
    matcher = GMatcher(cfg.matcher, param_dtype=torch.float32)
    load_variables(matcher, m_vars)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        car = CARHyNet(dense=True, in_channels=1)
    if car_vars is not None:
        load_car_variables(car, car_vars)
    return fstep_mod.joint_variables(matcher, car.eval())


def eval_config(cfg: GIMSConfig) -> dict:
    """The FusedMatching config of validation: the fused inference program
    with the current weights (bf16 trunk and dense maps, as the bench and the
    evaluation run it), at the trained configuration's knobs."""
    return {
        "sinkhorn_iterations": cfg.matcher.sinkhorn_iterations,
        "match_threshold": cfg.matcher.match_threshold,
        "attention_dtype": "bfloat16",
        "fast_frontend": True,
        "descriptor_source": "dense_gray",
        "upsample": cfg.frontend.upsample,
        "dense_layers": cfg.frontend.dense_layers,
        "dense_first_map_oct": cfg.frontend.dense_first_map_oct,
        "radius": cfg.agc.radius, "percentile": cfg.agc.percentile,
        "min_size": cfg.agc.min_size,
    }


def _matcher_from_variables(cfg: GIMSConfig, m_vars):
    """The classic trainer's module: a GMatcher with f32 parameters."""
    matcher = GMatcher(cfg.matcher, param_dtype=torch.float32)
    load_variables(matcher, m_vars)
    return matcher


def _is_joint(state: step_mod.TrainState) -> bool:
    return isinstance(state.model, torch.nn.ModuleDict)


def load_eval_weights(evaluator, state: step_mod.TrainState) -> None:
    """Put the EMA weights (the parameters, without EMA) and the buffers of
    `state` into the validation program: a FusedMatching (the joint model)
    or a Matching (the matcher); its modules cast them to their dtypes."""
    if not _is_joint(state):
        ema = state.ema_params if state.ema_params is not None else state.params
        evaluator.model.load_state_dict({**dict(state.model.named_buffers()), **ema})
        return
    ema = fstep_mod.ema_modules(state)
    matcher, car = fstep_mod.split_joint(state.model)
    evaluator.model.load_state_dict({**dict(matcher.named_buffers()), **ema["gmatcher"]})
    evaluator.car_model.load_state_dict({**dict(car.named_buffers()), **ema["carhynet"]})


def export_npz(state: step_mod.TrainState, path: str) -> None:
    """The EMA weights (the parameters, without EMA) in the JAX layout:
    `path` (the matcher) and, for the joint model, `path` with ``_car``
    before ``.npz`` (the CNN)."""
    if not _is_joint(state):
        ema = state.ema_params if state.ema_params is not None else state.params
        ckpt_io.save_npz(path, module_variables(state.model, ema))
        return
    ema = fstep_mod.ema_modules(state)
    matcher, car = fstep_mod.split_joint(state.model)
    ckpt_io.save_npz(path, module_variables(matcher, ema["gmatcher"]))
    stem = path[:-4] if path.endswith(".npz") else path
    ckpt_io.save_npz(stem + "_car.npz", car_module_variables(car, ema["carhynet"]))


def _ckpt_payload(state: step_mod.TrainState, epoch: int, it: int):
    model = state.model
    return {
        "epoch": epoch,
        "iter": it,
        "params": {n: p.detach() for n, p in model.named_parameters()},
        "batch_stats": {n: b.detach() for n, b in model.named_buffers()},
        "ema": state.ema_params if state.ema_params is not None else {},
        "ema_updates": state.ema_updates,
        "opt_state": state.opt_state,
        "step": state.step,
    }


def _checkpoint_file(path: str) -> str:
    """`path`, or `path`.pt (the name the loop writes, given without the
    suffix as the JAX package's orbax directory is)."""
    if not os.path.exists(path) and os.path.exists(path + ".pt"):
        return path + ".pt"
    return path


def restore_train_state(cfg: GIMSConfig, path: str, num_batches: int, model):
    """Resume: load a checkpoint of ``_ckpt_payload`` into `model` (the
    trained module, as built for a fresh run) and return (state, tx, epoch,
    iter)."""
    loaded = torch.load(_checkpoint_file(path), map_location="cpu", weights_only=True)
    dev = next(model.parameters()).device
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(loaded["params"][n])
        for n, b in model.named_buffers():
            b.copy_(loaded["batch_stats"][n])
    state, tx = step_mod.create_train_state(cfg, model, num_batches)

    def to_dev(x):
        if isinstance(x, dict):
            return {k: to_dev(v) for k, v in x.items()}
        return x.to(dev) if torch.is_tensor(x) else x

    state.step = int(loaded["step"])
    state.opt_state = to_dev(loaded["opt_state"])
    state.ema_params = to_dev(loaded["ema"]) if cfg.train.use_ema else None
    state.ema_updates = int(loaded["ema_updates"])
    return state, tx, int(loaded["epoch"]), int(loaded["iter"])


def train(cfg: GIMSConfig, train_dataset=None, val_dataset=None,
          save_dir: Optional[str] = None, limit: int = -1,
          n_devices: int = 1, carhynet_weights: Optional[str] = None,
          max_steps: int = -1, fast_frontend: bool = False,
          restore_path: Optional[str] = None, cache_features: bool = False,
          init_weights: Optional[str] = None, fused_e2e: bool = False,
          multihost: bool = False, log_fn=print, device=None):
    """Main loop. Returns the final TrainState (rank 0's).

    n_devices > 1: N local ranks, each a process started with the spawn
    method, rank r on ``cuda:r`` over NCCL (``device="cpu"``: every rank on
    the CPU, over gloo). The arguments are pickled to the ranks (`log_fn`
    too: a rank's log lines go to its copy). multihost=True: this process
    is one rank of the group that ``multihost.initialize`` joined, on
    `device`; n_devices is ignored."""
    if multihost:
        if fused_e2e:
            raise NotImplementedError(MULTIHOST_FUSED)
        if not torch.distributed.is_initialized():
            raise ValueError("multihost=True needs a process group: call "
                             "train.multihost.initialize first")
        return _train(cfg, train_dataset, val_dataset, save_dir, limit, carhynet_weights,
                      max_steps, fast_frontend, restore_path, cache_features, init_weights,
                      fused_e2e, log_fn, device, group=torch.distributed.group.WORLD)
    if n_devices > 1:
        return _train_local_ranks(n_devices, device, dict(
            cfg=cfg, train_dataset=train_dataset, val_dataset=val_dataset,
            save_dir=save_dir, limit=limit, carhynet_weights=carhynet_weights,
            max_steps=max_steps, fast_frontend=fast_frontend, restore_path=restore_path,
            cache_features=cache_features, init_weights=init_weights, fused_e2e=fused_e2e,
            log_fn=log_fn))
    return _train(cfg, train_dataset, val_dataset, save_dir, limit, carhynet_weights,
                  max_steps, fast_frontend, restore_path, cache_features, init_weights,
                  fused_e2e, log_fn, device)


def _state_to(state: step_mod.TrainState, device) -> step_mod.TrainState:
    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        return x.to(device) if torch.is_tensor(x) else x

    state.model.to(device)
    state.opt_state = move(state.opt_state)
    state.ema_params = move(state.ema_params) if state.ema_params is not None else None
    return state


def _local_rank(rank: int, world: int, init_method: str, device_type: str, threads: int,
                kwargs: dict, out_dir: str):
    """One local rank of ``train(n_devices=world)``: joins the group, trains,
    and writes its final state (rank 0) or parameters (the others) to
    `out_dir` for the launching process."""
    dev = torch.device("cpu") if device_type == "cpu" else torch.device("cuda", rank)
    if dev.type == "cpu":
        torch.set_num_threads(threads)
    mh.initialize(init_method, world, rank, device=dev)
    try:
        state = _train(**kwargs, device=dev, group=torch.distributed.group.WORLD)
        if rank == 0:
            torch.save(_state_to(state, "cpu"), os.path.join(out_dir, "state.pt"))
        else:
            torch.save({n: p.detach().cpu() for n, p in state.model.named_parameters()},
                       os.path.join(out_dir, f"params{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _train_local_ranks(n: int, device, kwargs: dict):
    """Run `_train` over n local ranks and return rank 0's state on its
    device (``cuda:0`` or the CPU). Fails if a rank fails, or if a rank ends
    with parameters that are not bit-equal to rank 0's."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"n_devices={n} ranks need {n} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")
    out_dir = tempfile.mkdtemp(prefix="gims_ranks_")
    try:
        # the CPU ranks share this process's threads
        threads = max(1, torch.get_num_threads() // n)
        mh.spawn(_local_rank, n, (n, mh.local_init_method(out_dir), dev.type, threads, kwargs,
                                  out_dir))
        # written by this program's own ranks just above
        state = torch.load(os.path.join(out_dir, "state.pt"), weights_only=False)
        params = dict(state.model.named_parameters())
        for r in range(1, n):
            other = torch.load(os.path.join(out_dir, f"params{r}.pt"), weights_only=True)
            diverged = [k for k, p in params.items() if not torch.equal(p.detach(), other[k])]
            if diverged:
                raise RuntimeError(f"rank {r} ended with parameters that differ from rank "
                                   f"0's: {diverged[:5]}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return _state_to(state, torch.device("cuda", 0) if dev.type == "cuda" else dev)


def _train(cfg: GIMSConfig, train_dataset=None, val_dataset=None,
           save_dir: Optional[str] = None, limit: int = -1,
           carhynet_weights: Optional[str] = None,
           max_steps: int = -1, fast_frontend: bool = False,
           restore_path: Optional[str] = None, cache_features: bool = False,
           init_weights: Optional[str] = None, fused_e2e: bool = False,
           log_fn=print, device=None, group=None):
    """The loop of one rank (of `group`, or the only one where None)."""
    if fused_e2e and cfg.frontend.descriptor_source != "dense_gray":
        raise ValueError("fused_e2e requires descriptor_source='dense_gray'")
    device = resolve_device(device)
    n_ranks = mh.world_size(group) if group is not None else 1
    is_main = group is None or mh.rank(group) == 0
    if not is_main:
        log_fn = lambda *a, **k: None  # noqa: E731 (rank-0 logging)
    tcfg = cfg.train
    if fast_frontend:
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, interpolation="linear", warp_size=32))
    save_dir = Path(save_dir or os.path.join(tcfg.output_dir, tcfg.experiment_name))
    weight_dir = save_dir / "weights"
    if is_main:
        weight_dir.mkdir(parents=True, exist_ok=True)
    # the other ranks write to the bit bucket (rank-0 logging parity)
    results_file = open(save_dir / "results.txt" if is_main else os.devnull, "a")
    metrics_file = open(save_dir / "metrics.jsonl" if is_main else os.devnull, "a")

    np.random.seed(tcfg.init_seed)
    rng = np.random.RandomState(tcfg.init_seed)

    m_vars = init_gmatcher_variables(cfg.matcher, seed=tcfg.init_seed,
                                     scheme=cfg.matcher.init_scheme)
    car_vars = frontend = None
    if fused_e2e:
        car_vars = load_car_checkpoint(carhynet_weights) if carhynet_weights else None
    else:
        frontend = FeatureFrontend(cfg.frontend, weights_path=carhynet_weights, device=device)

    if train_dataset is None:
        coco_dir = os.path.join(cfg.dataset.dataset_path, "train2017")
        if os.path.isdir(coco_dir):
            train_dataset = data_mod.CocoPairDataset(cfg.dataset, "train", limit=limit,
                                                     seed=tcfg.init_seed)
        else:
            log_fn(f"[train] no COCO at {coco_dir}; using synthetic pairs")
            train_dataset = data_mod.SyntheticPairDataset(
                cfg.dataset, length=limit if limit > 0 else 1000, seed=tcfg.init_seed)
    if val_dataset is None:
        val_dataset = data_mod.SyntheticPairDataset(
            cfg.dataset, length=tcfg.val_images_count, seed=999)

    if fused_e2e and tcfg.batch_size != 1:
        raise ValueError("fused_e2e uses batch_size=1 per device")
    bsz = tcfg.batch_size * n_ranks  # the global batch
    num_batches = max(len(train_dataset) // bsz, 1)
    start_epoch = tcfg.start_epoch

    def build_model():
        if fused_e2e:
            model = _joint_from_variables(cfg, m_vars, car_vars, tcfg.init_seed).to(device)
        else:
            model = _matcher_from_variables(cfg, m_vars).to(device)
        # every rank starts from rank 0's replica (DDP's broadcast)
        return mh.replicate(model, group) if group is not None else model

    if restore_path:
        model = build_model()
        state, tx, r_epoch, r_it = restore_train_state(cfg, restore_path, num_batches, model)
        # iter == -1 marks an end-of-epoch checkpoint (last/best); anything
        # else resumes the same epoch from its start
        start_epoch = r_epoch + 1 if r_it < 0 else r_epoch
        log_fn(f"[train] resumed {restore_path}: epoch {r_epoch} iter {r_it} "
               f"(opt step {state.step})")
    else:
        if init_weights:
            # warm start from exported npz weights: the model's variables
            # come from the file, the optimizer and the schedule start fresh
            loaded = ckpt_io.unflatten_npz(init_weights)
            m_vars = {"params": loaded["params"],
                      "batch_stats": loaded.get("batch_stats", m_vars.get("batch_stats", {}))}
            car_path = (init_weights[:-4] if init_weights.endswith(".npz")
                        else init_weights) + "_car.npz"
            if fused_e2e and os.path.exists(car_path):
                car_vars = load_car_checkpoint(car_path)
                log_fn(f"[train] CNN warm start from {car_path}")
            log_fn(f"[train] warm start from {init_weights}")
        model = build_model()
        state, tx = step_mod.create_train_state(cfg, model, num_batches)

    image_shape = (cfg.dataset.image_height, cfg.dataset.image_width)
    evaluator = eval_matcher = None
    if fused_e2e:
        from gims_tpu_torch.fused import FusedMatching, octave_budgets

        budgets = octave_budgets(*image_shape, tcfg.max_keypoints, cfg.frontend.upsample)
        freeze_steps = tcfg.freeze_gmatcher_epochs * num_batches
        if freeze_steps:
            log_fn(f"[train] matcher frozen for first {freeze_steps} steps "
                   f"({tcfg.freeze_gmatcher_epochs} epochs)")
        step_fn = fstep_mod.make_fused_e2e_train_step(cfg, tx, image_shape, budgets,
                                                      freeze_steps=freeze_steps, group=group)
        if is_main:
            evaluator = FusedMatching(eval_config(cfg), variables=m_vars,
                                      car_variables=car_vars,
                                      total_keypoints=tcfg.max_keypoints, device=device)

            def eval_matcher(data):
                return evaluator(data["image0"][0], data["image1"][0])
    else:
        from gims_tpu_torch.api import Matching

        step_fn = step_mod.make_train_step(cfg, tx, image_shape, group=group)
        if is_main:
            evaluator = eval_matcher = Matching(cfg, variables=m_vars, frontend=frontend,
                                                device=device)
    fused_sift = not fused_e2e and cfg.frontend.descriptor_source == "sift"

    best_val_score = 1e-10
    best_min_loss = 1e9
    order = np.arange(len(train_dataset))
    global_step = state.step
    log_fn(f"Started training for {tcfg.num_epochs} epochs, {num_batches} batches/epoch, "
           + (f"{n_ranks} ranks ({torch.distributed.get_backend(group)}), rank 0 on {device}"
              if group is not None else f"1 device ({device})"))
    header = ("%10s" * 8) % ("Epoch", "Iter", "PosLoss", "NegLoss", "TotLoss",
                             "Dtime", "Ptime", "Mtime")
    # the prefetch worker prepares batch i+1 on the host while the device
    # runs step i; it alone touches the dataset and rng, so the data order
    # stays deterministic. Inside a batch the side pool extracts the images.
    prefetch = ThreadPoolExecutor(max_workers=1)
    side_pool = ThreadPoolExecutor(max_workers=max(2, 2 * tcfg.batch_size))
    batch_cache = {} if cache_features else None
    timed = device.type == "cuda"

    def make_batch(idxs):
        if group is not None:
            # every rank sees the same global order (same seed) and
            # materializes only its own contiguous rows
            idxs = idxs[mh.process_batch_slice(len(idxs))]
        key = tuple(int(i) for i in idxs) if cache_features else None
        if batch_cache is not None and key in batch_cache:
            return batch_cache[key], 0.0, 0.0
        t1 = time.time()
        pairs = [train_dataset[int(i)] for i in idxs]
        t2 = time.time()
        seeds = row_seeds(idxs, tcfg.init_seed)
        if fused_e2e:
            batch = build_batch_e2e(pairs, device)
        elif fused_sift:
            batch = build_batch_raw(cfg.frontend, pairs, tcfg.max_keypoints, rng,
                                    pool=side_pool, seeds=seeds, device=device)
        else:
            batch = build_batch(frontend, pairs, tcfg.max_keypoints, rng, pool=side_pool,
                                seeds=seeds)
        if batch_cache is not None:
            batch_cache[key] = batch
        return batch, t2 - t1, time.time() - t2

    def save(payload, name):
        if is_main:
            torch.save(payload, weight_dir / name)

    try:
        for epoch in range(start_epoch, tcfg.num_epochs):
            log_fn(header)
            if cache_features:
                groups = order[: num_batches * bsz].reshape(num_batches, -1)[
                    rng.permutation(num_batches)]
                order = groups.reshape(-1)
            else:
                rng.shuffle(order)
            mloss = np.zeros(3)
            fut = prefetch.submit(make_batch, order[:bsz])
            flush_every = max(1, min(tcfg.log_interval, tcfg.minloss_every))
            pending = []

            def flush_pending():
                nonlocal mloss
                if not pending:
                    return
                # one stacked readout per flush, not one per step
                vals = torch.stack([m for _, _, m, _, _ in pending]).cpu().numpy()
                for (ep_i, it_i, _, times, events), loss_items in zip(pending, vals):
                    mloss = (mloss * it_i + loss_items) / (it_i + 1)
                    log_fn(("%10s%10d" + "%10.4g" * 6) % (str(ep_i), it_i, *mloss, *times))
                    rec = {"epoch": ep_i, "iter": it_i,
                           "pos_loss": float(loss_items[0]),
                           "neg_loss": float(loss_items[1]),
                           "total_loss": float(loss_items[2]),
                           "mloss": float(mloss[2]),
                           "data_time": times[0], "preprocess_time": times[1],
                           "model_time": times[2]}
                    if events is not None:
                        rec["step_ms"] = events[0].elapsed_time(events[1])
                    metrics_file.write(json.dumps(rec) + "\n")
                metrics_file.flush()
                ep_i, it_i = pending[-1][:2]
                results_file.write(f"Epoch: {ep_i} Iter: {it_i}, Loss: {mloss[0]}\n")
                results_file.flush()
                pending.clear()

            for it in range(num_batches):
                batch, dt_data, dt_prep = fut.result()
                if it + 1 < num_batches and not (0 < max_steps <= global_step + 1):
                    fut = prefetch.submit(make_batch, order[(it + 1) * bsz:(it + 2) * bsz])
                t1 = time.time()
                events = None
                if timed:
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                state, metrics = step_fn(state, batch)
                if timed:
                    events[1].record()
                pending.append((epoch, it, metrics["vec"],
                                (dt_data, dt_prep, time.time() - t1), events))
                if (it + 1) % flush_every == 0 or it + 1 == num_batches \
                        or (0 < max_steps <= global_step + 1):
                    flush_pending()
                    ckpt_state = None
                    if (it + 1) % tcfg.lastiter_every < flush_every:
                        ckpt_state = _ckpt_payload(state, epoch, it)
                        save(ckpt_state, "lastiter.pt")
                    if ((it + 1) % tcfg.minloss_every < flush_every
                            and mloss[2] < best_min_loss):
                        best_min_loss = float(mloss[2])
                        log_fn(f"save minloss {epoch} with loss {best_min_loss}")
                        save(ckpt_state or _ckpt_payload(state, epoch, it), "minloss.pt")
                global_step += 1
                if 0 < max_steps <= global_step:
                    break

            # per-epoch validation with the EMA (or raw) weights, on rank 0;
            # its score goes to every rank
            score = 0.0
            if is_main:
                load_eval_weights(evaluator, state)
                results = test_model(eval_matcher, val_dataset, tcfg.val_images_count,
                                     agc={"radius": cfg.agc.radius,
                                          "percentile": cfg.agc.percentile,
                                          "min_size": cfg.agc.min_size},
                                     device=device)
                log_fn(f"Validation: {results}")
                score = float(results["weight_score"])
            if group is not None:
                score = mh.broadcast_float(score, 0, group, device)
            ckpt_state = _ckpt_payload(state, epoch, -1)
            save(ckpt_state, "last.pt")
            if is_main:
                export_npz(state, str(weight_dir / "last.npz"))
            if score > best_val_score:
                best_val_score = score
                log_fn(f"Saving best model at epoch {epoch} with score {best_val_score}")
                save(ckpt_state, "best.pt")
                if is_main:
                    export_npz(state, str(weight_dir / "best.npz"))
            if 0 < max_steps <= global_step:
                break
    finally:
        prefetch.shutdown(wait=True)
        side_pool.shutdown(wait=True)
        results_file.close()
        metrics_file.close()
    if group is not None:
        # keep the ranks together through rank 0's closing work
        torch.distributed.barrier(group)
    return state
