"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas=-v -c -o <tmp>/<source>.o csrc/<source>.cu      (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o _build/libgims_kernels_<hash>.so ...

One process per source keeps the build as long as its slowest source as
sources are added.

The library lands in ``gims_tpu_torch/_build/`` (listed in .gitignore)
under a name keyed by a hash of the sources, so an edited source is
rebuilt and an unchanged one is loaded as it is. The build runs at first
use, never at import. ``build_log`` keeps ptxas' report (registers, shared
memory, spills of each kernel) of the build this process ran.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any
build_log = None      # ptxas' report of that build


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH); "
                       "the CUDA kernels cannot be built")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256()
    for path in sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(COMPILE_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgims_kernels_{h.hexdigest()[:16]}.so")


def _check(proc, cmd):
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return out


def build() -> str:
    """Compile the sources if their library is not built yet; return its path."""
    global build_seconds, build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    try:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in sources()]
        cmds = [[nvcc, *COMPILE_FLAGS, "-c", "-o", obj, src] for src, obj in zip(sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]  # all sources at once
        logs = [_check(proc, cmd) for proc, cmd in zip(procs, cmds)]
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", os.path.join(tmp, "lib.so"), *objs]
        _check(subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
               link)
        os.replace(os.path.join(tmp, "lib.so"), out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call and cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib):
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.gims_attention_fwd.restype = i
    lib.gims_attention_fwd.argtypes = (
        [p, p, p, p, p]            # q, k, v, key_mask, out
        + [i] * 6                  # dtype, B, N, M, H, D
        + [i64] * 4 * 4            # strides of q, k, v, out (b, n, h, d)
        + [i64]                    # key_mask batch stride
        + [f, p])                  # scale * log2(e), stream
    lib.gims_attention_fwd_partial.restype = i
    lib.gims_attention_fwd_partial.argtypes = (
        [p, p, p, p, p, p]         # q, k, v, key_mask, out, stats
        + [i] * 6                  # dtype, B, N, M, H, D
        + [i64] * 4 * 4            # strides of q, k, v, out (b, n, h, d)
        + [i64]                    # key_mask batch stride
        + [f, p])                  # scale * log2(e), stream
    lib.gims_attention_key_tile.restype = i
    lib.gims_attention_key_tile.argtypes = [i, i]  # dtype, D
    lib.gims_sinkhorn_z_reads.restype = i
    lib.gims_sinkhorn_z_reads.argtypes = [i, i, i]      # B, M1, N1
    lib.gims_sinkhorn_scratch_len.restype = i64
    lib.gims_sinkhorn_scratch_len.argtypes = [i, i, i]  # B, M1, N1
    lib.gims_sinkhorn_uv.restype = i
    lib.gims_sinkhorn_uv.argtypes = (
        [p, p, p, p, p]            # Z, log_mu, log_nu, u, v
        + [p, i64]                 # scratch, its float2 count
        + [i, i, i, i, p])         # B, M1, N1, iters, stream
    lib.gims_label_plan.restype = i
    lib.gims_label_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(i64)]  # mode, B, N, W, rounds
    lib.gims_label_rounds.restype = i
    lib.gims_label_rounds.argtypes = (
        [i, p, p, p, p, p, p, p, i64]  # mode, edges, nbr_idx, valid, labels, rounds run,
                                       # listed, scratch, len
        + [i, i, i, i, p])          # B, N, W, rounds, stream
    lib.gims_segsum_rows.restype = i
    lib.gims_segsum_rows.argtypes = (
        [p, p, i, p]               # values, slots, slot bytes (2 or 4), out
        + [i, i64, i64, i64, i]    # rows, width, row strides of values and slots, num
        + [p])                     # stream
