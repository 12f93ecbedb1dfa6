"""Timers, traces and device probes: the port of ``gims_tpu/core/profiling.py``.

The reference's stage timers (AverageTimer utils/common.py:135-174, Timer
agc.py:17-61, time_synchronized common.py:88-91) with the same surface; a
device synchronise stands where JAX drains its effects or blocks until
ready. ``device_trace`` is the counterpart of JAX's ``tpu_trace``: a
``torch.profiler`` capture of host and CUDA activity written as a Chrome
trace. ``device_peak_memory_gb`` reads ``torch.cuda.max_memory_allocated``
and ``device_warmup`` runs a few matmuls before timing (the reference's
gpu_warmup, utils/common.py:809-820). ``send_notify`` lives in
``core/notify.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_synchronized():
    """Wall time after the card's queued work has finished."""
    _sync()
    return time.time()


class AverageTimer:
    """Exponentially smoothed stage timer, the reference's surface
    (update/print with named stages)."""

    def __init__(self, smoothing=0.3, newline=False):
        self.smoothing = smoothing
        self.newline = newline
        self.times = OrderedDict()
        self.will_print = OrderedDict()
        self.reset()

    def reset(self):
        now = time.time()
        self.start = now
        self.last_time = now
        for name in self.will_print:
            self.will_print[name] = False

    def update(self, name="default"):
        now = time.time()
        dt = now - self.last_time
        if name in self.times:
            dt = self.smoothing * dt + (1 - self.smoothing) * self.times[name]
        self.times[name] = dt
        self.will_print[name] = True
        self.last_time = now

    def print(self, text="Timer"):
        total = 0.0
        parts = [f"[{text}]"]
        for key, val in self.times.items():
            if self.will_print.get(key):
                parts.append(f"{key}={val:.3f}")
                total += val
        parts.append(f"total={total:.3f} sec {{{1.0 / max(total, 1e-9):.1f} FPS}}")
        end = "\n" if self.newline else "\r"
        print(" ".join(parts), end=end, flush=True)
        self.reset()


class Timer(contextlib.AbstractContextManager):
    """`with Timer('stage'):` context timer (reference: agc.py:17-61);
    `sync` synchronises the card at both ends."""

    def __init__(self, name="stage", sync=True, quiet=False):
        self.name = name
        self.sync = sync
        self.quiet = quiet
        self.elapsed = 0.0

    def __enter__(self):
        if self.sync:
            _sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _sync()
        self.elapsed = time.perf_counter() - self.t0
        if not self.quiet:
            print(f">> {self.name}: {self.elapsed:.3f}s")
        return False


@contextlib.contextmanager
def device_trace(logdir="output/trace"):
    """Capture a ``torch.profiler`` trace of a region (host and, where there
    is a card, CUDA activity) into ``logdir/trace.json``, viewable in
    chrome://tracing or Perfetto. Replaces JAX's ``tpu_trace``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_peak_memory_gb(device=None) -> float:
    """Peak memory allocated by torch on the card, in GiB (0 on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated(dev) / (1024**3)


def device_warmup(steps: int = 5) -> None:
    """Warm the card with a few matmuls before timing, read back on the host
    (on the CPU where there is no card)."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    x = torch.ones((1024, 1024), dtype=torch.float32, device=dev)
    for _ in range(steps):
        x = torch.tanh(x @ x * 1e-3)
    float(x.sum())
