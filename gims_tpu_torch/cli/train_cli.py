"""Training CLI: flag parity with the JAX package's ``gims_tpu/cli/train_cli.py``
(reference train.py:212-231), plus ``--device``.

    python -m gims_tpu_torch.cli.train_cli --config_path configs/e2e_fo0_800.yaml \
        --fused_e2e --init_weights weights/gims_tpu_dense_gray_e2e.npz
    python -m gims_tpu_torch.cli.train_cli --config_path configs/synth_sift.yaml \
        --descriptor_source sift

The second is the classic trainer: OpenCV's SIFT as the port computes it
(``frontend/sift.py``), on the device, feeds the matcher. Runs on ``cuda``
unless ``--device cpu``.

Data parallelism (``train/multihost.py``): ``--devices N`` starts N ranks on
this host, rank r on ``cuda:r`` (``--device cpu``: all on the CPU, over
gloo). With ``--coordinator host:port`` this process is one rank, number
``--process_id`` of ``--num_processes`` (launch one per card, on every
host), on ``cuda:{process_id % device_count}`` unless ``--device`` names a
device; ``--fused_e2e`` then raises, as in the JAX package. The ranks
talk over NCCL on CUDA and gloo on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import re
from pathlib import Path

from gims_tpu_torch.config import load_config


def increment_path(path, exist_ok=True, sep=""):
    """Reference: utils/common.py:76-86."""
    path = Path(path)
    if (path.exists() and exist_ok) or (not path.exists()):
        return str(path)
    dirs = glob.glob(f"{path}{sep}*")
    matches = [re.search(rf"%s{sep}(\d+)" % path.stem, d) for d in dirs]
    i = [int(m.groups()[0]) for m in matches if m]
    n = max(i) + 1 if i else 2
    return f"{path}{sep}{n}"


def resolve_save_dir(base, restore_path):
    """Run-dir choice: version a fresh run, but resume in place when
    --restore_path points inside the run dir itself or inside an already
    versioned sibling (``<name>2``)."""
    base = Path(base)
    if restore_path is not None:
        try:
            restore = Path(restore_path).resolve()
            if restore.is_relative_to(base.resolve()):
                return str(base)
            for sib in sorted(base.parent.glob(base.name + "*")):
                if (re.fullmatch(re.escape(base.name) + r"\d+", sib.name)
                        and restore.is_relative_to(sib.resolve())):
                    return str(sib)
        except (OSError, ValueError):
            pass
    return increment_path(base, exist_ok=False)


def main(argv=None):
    import faulthandler
    import signal

    faulthandler.enable()
    faulthandler.register(signal.SIGUSR2, all_threads=True)

    parser = argparse.ArgumentParser(description="GIMS training (PyTorch port)")
    parser.add_argument("--config_path", type=str, default="configs/coco_config.yaml")
    parser.add_argument("--name", type=str, default="gims")
    parser.add_argument("--limit", type=int, default=-1)
    parser.add_argument("--devices", type=int, default=1,
                        help="data-parallel ranks on this host, one process each, "
                             "rank r on cuda:r (all on the CPU with --device cpu)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-host data parallelism: process 0's 'host:port'; this "
                             "process is rank --process_id of --num_processes, on "
                             "cuda:{process_id %% device_count} unless --device names one")
    parser.add_argument("--num_processes", type=int, default=1)
    parser.add_argument("--process_id", type=int, default=0)
    parser.add_argument("--max_steps", type=int, default=-1)
    parser.add_argument("--carhynet_weights", type=str, default=None)
    parser.add_argument("--restore_path", type=str, default=None)
    parser.add_argument("--init_weights", type=str, default=None,
                        help="warm-start model params from an exported npz "
                             "(fresh optimizer/schedule; for fine-tuning)")
    parser.add_argument("--fast", action="store_true",
                        help="fast frontend (linear 32x32 sampling)")
    parser.add_argument("--descriptor_source", type=str, default="carhynet",
                        choices=["carhynet", "sift", "dense", "dense_gray"])
    parser.add_argument("--neg_cells", type=str, default=None, choices=["corner", "dustbin"],
                        help="'corner' = reference loss parity (negatives carry no "
                             "gradient); 'dustbin' = corrected negative supervision")
    parser.add_argument("--init_scheme", type=str, default=None,
                        choices=["default", "identity"],
                        help="'identity' = zero-residual warm start")
    parser.add_argument("--fused_e2e", action="store_true",
                        help="end-to-end fused training: device DoG detection + dense_gray "
                             "descriptor CNN learn jointly with the matcher")
    parser.add_argument("--cache_features", action="store_true",
                        help="build each batch once and reuse it across epochs")
    parser.add_argument("--photo_dir", type=str, default=None,
                        help="mix ImageFolderPairDataset scenes (PNG) from this folder "
                             "into the synthetic train set")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    multihost = args.coordinator is not None
    if multihost and args.fused_e2e:
        from gims_tpu_torch.train.loop import MULTIHOST_FUSED

        raise NotImplementedError(MULTIHOST_FUSED)
    cfg = load_config(args.config_path if os.path.exists(args.config_path) else None)
    if args.descriptor_source != "carhynet":
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, descriptor_source=args.descriptor_source))
    if args.neg_cells:
        cfg = dataclasses.replace(cfg, matcher=dataclasses.replace(
            cfg.matcher, neg_cells=args.neg_cells))
    if args.init_scheme:
        cfg = dataclasses.replace(cfg, matcher=dataclasses.replace(
            cfg.matcher, init_scheme=args.init_scheme))
    save_dir = resolve_save_dir(Path(cfg.train.output_dir) / args.name, args.restore_path)
    from gims_tpu_torch.train import data as data_mod
    from gims_tpu_torch.train.loop import train

    train_dataset = None
    if args.photo_dir:
        n = args.limit if args.limit > 0 else 1000
        train_dataset = data_mod.MixedPairDataset([
            data_mod.SyntheticPairDataset(cfg.dataset, length=n // 2, seed=0),
            data_mod.ImageFolderPairDataset(cfg.dataset, args.photo_dir,
                                            length=n - n // 2, seed=1),
        ])
    device = args.device
    if multihost:
        import torch

        from gims_tpu_torch.train import multihost as mh

        if device is None:
            device = f"cuda:{args.process_id % max(torch.cuda.device_count(), 1)}"
        device = mh.initialize(args.coordinator, args.num_processes, args.process_id,
                               device=device)
    try:
        return train(cfg, train_dataset=train_dataset, save_dir=save_dir, limit=args.limit,
                     n_devices=args.devices, carhynet_weights=args.carhynet_weights,
                     max_steps=args.max_steps, fast_frontend=args.fast,
                     restore_path=args.restore_path, cache_features=args.cache_features,
                     init_weights=args.init_weights, fused_e2e=args.fused_e2e,
                     multihost=multihost, device=device)
    finally:
        if multihost:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
