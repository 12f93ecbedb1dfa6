#!/usr/bin/env python3
"""Where one Matching request's time goes on the GPU (PyTorch/CUDA port).

    python3 scripts/profile_torch_matching.py [--n 7000] [--seed 13] [--reps 3]
    python3 scripts/profile_torch_matching.py --sharded 16384 --n 15000

Serves a synthetic keypoint request (gims_tpu_torch.synthetic, 800x600
frame, eval knobs) through gims_tpu_torch.api.Matching with the staged
checkpoint and its CUDA defaults (bf16 trunk, both kernels). With
``--sharded NB`` it pads the request's two views to bucket NB and calls
``pipeline.forward_match`` with that model instead, unsharded and then
through ``matcher/sharded.py::make_forward_match_sharded`` over a one-rank
NCCL group (ring attention, the row-block AGC and Sinkhorn), one JSON line
each. After one warm-up request it prints one JSON line with, per request
(mean of `--reps`):

* ``request_ms``: host-clock ms of a request, unprofiled;
* ``stages``: for each ``gims.*`` record_function range of the path (AGC,
  encoder, trunk, Sinkhorn, extraction), ``device_ms``, its span on the
  device from the start of its first kernel to the end of its last, and
  ``host_ms``, the host time inside it, from a torch.profiler trace of
  `--reps` requests;
* ``device_busy_ms`` / ``idle_share``: kernel time in that trace against
  its wall time;
* ``top_kernels``: the kernels with the most device time in the trace.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import socket
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from gims_tpu_torch.api import Matching  # noqa: E402
from gims_tpu_torch.config import AGCConfig  # noqa: E402
from gims_tpu_torch.matcher import pipeline  # noqa: E402
from gims_tpu_torch.matcher.sharded import make_forward_match_sharded  # noqa: E402
from gims_tpu_torch.synthetic import EVAL_KNOBS, FRAME, synthetic_request  # noqa: E402
from gims_tpu_torch.train import multihost  # noqa: E402

WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")


def device_us(evt, self_only=False):
    name = "self_device_time_total" if self_only else "device_time_total"
    if hasattr(evt, name):
        return getattr(evt, name)
    return getattr(evt, name.replace("device", "cuda"))


def padded_views(req, nb):
    """The request's two views padded to bucket nb on the card: (1, nb, .)
    keypoints (1e6 past the valid ones), descriptors, valid."""
    out = []
    for side in "01":
        kp, de = req["keypoints" + side], req["descriptors" + side]
        n = len(kp)
        kpts = torch.full((1, nb, 2), 1e6)
        kpts[0, :n] = torch.from_numpy(kp)
        desc = torch.zeros((1, nb, de.shape[1]))
        desc[0, :n] = torch.from_numpy(de)
        valid = torch.arange(nb)[None] < n
        out += [x.cuda() for x in (kpts, desc, valid)]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=7000, help="keypoints per view")
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sharded", type=int, default=0, metavar="NB",
                    help="forward_match at bucket NB, unsharded and sharded over one NCCL rank")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_matching: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    m = Matching({"weights_path": WEIGHTS})
    req, _ = synthetic_request(args.seed, args.n)
    if not args.sharded:
        report(lambda: m(req), args, {"keypoints": args.n})
        return
    views = padded_views(req, args.sharded)
    acfg = AGCConfig(**{k: req[k] for k in EVAL_KNOBS})
    k0, k1 = (pipeline.percentile_rank(v.sum(dim=1), acfg.percentile) for v in views[2::3])
    info = {"keypoints": args.n, "bucket": args.sharded}
    report(lambda: pipeline.forward_match(m.model, acfg, *views, FRAME, k0=k0, k1=k1), args,
           {**info, "run": "unsharded"})
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        call = make_forward_match_sharded(m.model, acfg, torch.distributed.group.WORLD, FRAME)
        report(lambda: call(*views), args, {**info, "run": "sharded, one NCCL rank"})
    finally:
        torch.distributed.destroy_process_group()


def report(call, args, info):
    """One warm-up call, then `args.reps` timed and `args.reps` profiled
    calls of `call`; prints the JSON line."""
    call()  # warm-up

    def requests():
        t = time.perf_counter()
        for _ in range(args.reps):
            call()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / args.reps

    request_ms = requests()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_ms = requests()

    stages, kernels = {}, []
    for evt in prof.key_averages():
        on_device = evt.device_type == torch.autograd.DeviceType.CUDA
        if evt.key.startswith("gims."):
            # a range shows twice: on the host, and on the device from its
            # first kernel's start to its last kernel's end
            stage = stages.setdefault(evt.key, {})
            if on_device:
                stage["device_ms"] = device_us(evt) / 1e3 / args.reps
            else:
                stage["host_ms"] = evt.cpu_time_total / 1e3 / args.reps
        elif on_device:
            kernels.append((device_us(evt, self_only=True) / 1e3 / args.reps,
                            evt.count // args.reps, evt.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "card": smi, **info, "request_ms": request_ms,
        "profiled_request_ms": wall_ms, "stages": stages,
        "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "top_kernels": [{"ms": ms, "calls": c, "name": name[:90]}
                        for ms, c, name in kernels[:12]],
    }), flush=True)


if __name__ == "__main__":
    main()
