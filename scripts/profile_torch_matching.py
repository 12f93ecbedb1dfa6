#!/usr/bin/env python3
"""Where one Matching request's time goes on the GPU (PyTorch/CUDA port).

    python3 scripts/profile_torch_matching.py [--n 7000] [--seed 13] [--reps 3]

Serves a synthetic keypoint request (gims_tpu_torch.synthetic, 800x600
frame, eval knobs) through gims_tpu_torch.api.Matching with the staged
checkpoint and its CUDA defaults (bf16 trunk, both kernels). After one
warm-up request it prints one JSON line with, per request (mean of
`--reps`):

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
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from gims_tpu_torch.api import Matching  # noqa: E402
from gims_tpu_torch.synthetic import synthetic_request  # noqa: E402

WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")


def device_us(evt, self_only=False):
    name = "self_device_time_total" if self_only else "device_time_total"
    if hasattr(evt, name):
        return getattr(evt, name)
    return getattr(evt, name.replace("device", "cuda"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=7000, help="keypoints per view")
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_matching: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    m = Matching({"weights_path": WEIGHTS})
    req, _ = synthetic_request(args.seed, args.n)
    m(req)  # warm-up

    def requests():
        t = time.perf_counter()
        for _ in range(args.reps):
            m(req)
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
        "card": smi, "keypoints": args.n, "request_ms": request_ms,
        "profiled_request_ms": wall_ms, "stages": stages,
        "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "top_kernels": [{"ms": ms, "calls": c, "name": name[:90]}
                        for ms, c, name in kernels[:12]],
    }), flush=True)


if __name__ == "__main__":
    main()
