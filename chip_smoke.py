#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GIMS on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each with its seconds:
  0 device: versions, the card's name and power limit; TF32 off.
  1 build: the CUDA kernels under gims_tpu_torch/csrc/, one nvcc process
    per source, all at once; ptxas' registers, shared memory and spills per
    kernel; the count of wgmma (HGMMA) instructions in the attention
    kernels' SASS, which must not be 0 for the bf16 kernel.
  2 the attention kernel against its plain PyTorch versions on the card,
    at the three paths' trunk shapes among others.
  3 the Sinkhorn kernels against their plain PyTorch version on the card:
    the fused kernel at Z of 2049, 8193, (8, 3073) and (4, 6145) square,
    the streaming kernel at 24577 (the widest bucket).
  4 the slice: gims_tpu_torch.api.Matching with the staged checkpoint
    (weights/gims_tpu_sift_last.npz, 18 GNN layers, 256-d) serves four
    synthetic keypoint requests in an 800x600 frame (buckets 2048 and
    8192); the kernels' launch counters must rise on this path.
  5 one 2048 request in f32 through the kernels and through the plain
    versions: kept equal, matches and scores agree.
  6 the fused image path: gims_tpu_torch.fused.FusedMatching with the joint
    end-to-end weights (weights/gims_tpu_dense_gray_e2e.npz and _car.npz)
    matches batches of 8 synthetic 800x600 gray pairs (6144 keypoints,
    no upsample, trunk compacted to 3072, AGC 15/2/7, 20 Sinkhorn
    iterations, threshold 0.02, bf16 trunk and CNN) in two configurations,
    timed in turns A, B, B, A: A the exact dense AGC and exact top-k
    (passed explicitly), B the bare defaults on the card, the JAX
    accelerator branch (band AGC of half-width 512, threshold stride 4,
    centroid reconnect of 1024 buckets, approximate top-k). Each: 18
    attention, 1 Sinkhorn and 1 label-rounds launch per dispatch, matches
    on every pair, at least half of them within 3 px of the known
    homography; pairs/s, peak memory and the stage split of one dispatch
    from a torch.profiler trace.
  7 one batch of that path (A) in f32 through the kernels and through the
    plain versions, on the same keypoints and descriptors: kept and
    matches identical.
  8 AGC of every build (dense exact, dense with the strided threshold and
    the centroid reconnect, dense with sparse components, band with dense
    or band components, deferred or not) on one batch of the fused path's
    keypoints, each under torch.cuda.set_sync_debug_mode("error"): a build
    that asks the host anything fails. The band build equals the dense
    one with the same threshold and reconnect wherever band_coverage
    reports full coverage (printed per set), with the label rounds run to
    convergence (the default cap of 20 leaves these graphs' labels short of
    it, and labels cut short depend on the node order).
  9 devsift at the JAX bench's configuration (bench.py, GIMS_BENCH_DESC=
    devsift, ref knobs): SIFT descriptors on the card, the staged
    checkpoint, 2x-upsampled pyramid, 12288 keypoints compacted to 6144,
    4 pairs per dispatch, band components, the Sinkhorn kernel on; the
    same launch, match and correctness bounds, pairs/s, peak memory and
    stage split; then one dispatch in f32 through the kernels and the
    plain versions: kept and matches identical.
  10 the label-rounds kernel against its plain version on the graphs the
    paths above gave it (recorded during phases 4, 6 and 9): labels equal,
    rounds run, times.
  11 one JSON line with every kernel's launches, error and times, on the
    three paths' shapes.
  12 the last line: {"ok": true, "device": {...}}.

Any mismatch raises and the process exits non-zero. Without CUDA it
exits non-zero at once: there is no CPU fallback. It imports torch, numpy,
the standard library and gims_tpu_torch only, and writes nothing outside
gims_tpu_torch/_build/.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from gims_tpu_torch import _build, fused  # noqa: E402
from gims_tpu_torch.agc import graph, labels  # noqa: E402
from gims_tpu_torch.api import Matching  # noqa: E402
from gims_tpu_torch.carhynet.convert import load_car_checkpoint  # noqa: E402
from gims_tpu_torch.config import MatcherConfig  # noqa: E402
from gims_tpu_torch.matcher import attention, cuda_attention, cuda_sinkhorn, pipeline, sinkhorn  # noqa: E402
from gims_tpu_torch.matcher.convert import load_gims_checkpoint  # noqa: E402
from gims_tpu_torch.matcher.gmatcher import GMatcher  # noqa: E402
from gims_tpu_torch.synthetic import correct_share, synthetic_image_pair, synthetic_request  # noqa: E402

WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")
E2E_WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_dense_gray_e2e.npz")
E2E_CAR_WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_dense_gray_e2e_car.npz")
# one NVIDIA H100 SXM, from its data sheet: HBM bytes/s, peak FLOP/s, and
# the exponentials its MUFU units take per second (16 per clock per SM, 132
# SMs, 1.98 GHz boost clock)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
EXP_PER_S = 132 * 16 * 1.98e9
# The attention kernel, element by element: |out - ref| <= atol + rtol * |ref|.
# f32: against the direct version, 1e-4 flat. bf16: against
# masked_attention_tiled's unrounded f32 result, which rounds P to bf16 per
# key tile as the kernel and the TPU kernel do (pallas_attention.py:75). The
# tight rule is the output's one rounding (2**-8) plus f32 summation-order
# slack. Every element is held to it plus one bf16 ulp of every rounded P:
# the kernel and the tiled version round nearly equal f32 p to bf16, and
# where a p lies at a rounding boundary the two roundings differ by one ulp
# (at most 2**-7 p), which moves the output by up to 2**-7 * sum_j p_j |v_j|
# / l, the attention of |v|. Since that term is wide, at least 99.9% of the
# elements must also meet the tight rule (as
# tests/test_torch_attention.py::test_tiled_matches_pallas_interpret holds
# the tiled version to the TPU kernel). Against the direct version (P kept
# in f32) bf16 is held by its RMS error relative to the output's RMS: the
# output's rounding alone gives about 2**-8 / sqrt(3) (0.0023) and P's
# rounding less, so 2**-8 (0.0039).
ATTN_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-4, 2.0 ** -8)}
ATTN_P_ROUNDING = 2.0 ** -7
ATTN_TIGHT_SHARE = 0.999
ATTN_BF16_REL_RMS = 2.0 ** -8
HEAD_DIM = 64  # the trunk's: 256 descriptor channels over 4 heads
SINKHORN_TOL = 2e-4
SINKHORN_ITERS = 100
NUM_LAYERS = 18
DEVICE = "cuda"
# (B, N, M, masked key tail): the trunk's buckets 2048 and 8192 (both sides
# stacked, B=2), a key count that is not a multiple of the 64-key tile, and
# the fused path's compacted trunk (8 pairs, both sides stacked: B=16, 3072)
# the fused path's compacted trunk (8 pairs, both sides stacked: B=16,
# 3072), and the devsift path's (4 pairs: B=8, 6144)
ATTN_CASES = ((2, 2048, 2048, 248), (2, 8192, 8192, 1192), (2, 1000, 2017, 300),
              (16, 3072, 3072, 400), (8, 6144, 6144, 700))
# (bucket, valid rows, valid cols, iterations) of the Sinkhorn input Z
# (bucket+1 square), one entry per batch item: the fused kernel (Z read once
# per iteration) at 2049 and 8193, the streaming kernel (twice) at 24577,
# and the fused path's batch of 8 at 3073 with 20 iterations
FUSED_ITERS = 20
SINKHORN_CASES = ((2048, [1800], [1750], SINKHORN_ITERS), (8192, [7000], [6900], SINKHORN_ITERS),
                  (24576, [22000], [21000], 3),
                  (3072, [2900, 3072, 2500, 3000, 2800, 3072, 2700, 2950],
                   [2950, 3000, 2600, 3072, 2750, 3050, 2800, 2900], FUSED_ITERS),
                  (6144, [5900, 6144, 5200, 6050], [6000, 5800, 6144, 4900], FUSED_ITERS))
# the fused image path as the JAX package's bench runs it (bench.py:223-275)
FUSED_FRAME = (600, 800)
FUSED_BATCH = 8
FUSED_KEYPOINTS = 6144
FUSED_COMPACT = 3072
FUSED_CONFIG = {"radius": 15, "percentile": 2, "min_size": 7,
                "sinkhorn_iterations": FUSED_ITERS, "match_threshold": 0.02,
                "upsample": False, "compact_to": FUSED_COMPACT}
# configuration A: the exact dense AGC and exact top-k, passed explicitly
# since the card's defaults (configuration B) follow the JAX accelerator
# branch
EXACT_KNOBS = {"agc_impl": "dense", "threshold_impl": "exact", "reconnect_impl": "exact",
               "reconnect_buckets": 4096, "topk_impl": "exact"}
ACCEL_DEFAULTS = {"agc_impl": "band", "band_halfwidth": 512, "threshold_impl": "approx",
                  "threshold_stride": 4, "reconnect_impl": "centroid", "reconnect_buckets": 1024,
                  "cc_impl": "dense"}
FUSED_TIMED = 3
STAGES = ("gims.agc", "gims.compact", "gims.encoder", "gims.trunk", "gims.sinkhorn",
          "gims.extract")
FUSED_STAGES = ("gims.frontend.pyramid", "gims.frontend.cnn", "gims.frontend.detect",
                "gims.frontend.sample") + STAGES
# devsift at the JAX bench's configuration (bench.py _run_fused_devsift, ref knobs)
DEVSIFT_BATCH = 4
DEVSIFT_KEYPOINTS = 12288
DEVSIFT_COMPACT = 6144
DEVSIFT_CONFIG = {"descriptor_source": "devsift", "upsample": True, "compact_to": DEVSIFT_COMPACT,
                  "cc_impl": "band", "sift_samples": 16, "threshold_stride": 4,
                  "radius": 15, "percentile": 2, "min_size": 7,
                  "sinkhorn_iterations": FUSED_ITERS, "match_threshold": 0.02,
                  "attention_dtype": "bfloat16"}
DEVSIFT_STAGES = ("gims.frontend.pyramid", "gims.frontend.orientation",
                  "gims.frontend.detect", "gims.frontend.describe") + STAGES
# band vs dense AGC on the card: an edge candidate (a pair within the radius
# whose similarity is not below the threshold) may differ only where its
# similarity lies within f32 rounding of the threshold (band similarities
# come from block products, dense ones from one (N, N) product); other
# entries (isolated-node fixes, reconnect links) only as they follow from
# one: at most this many per set
BAND_STRADDLE_TOL = 1e-5
BAND_MAX_DIFF = 16
# the label rounds' cap for that comparison: the fused path's graphs need
# more than the default 1 + 20 rounds to converge (37 on one 6144-keypoint
# synthetic image), and labels cut short depend on the node order, which the
# band build changes (x-sorted)
CONVERGED_ROUNDS = 100
# (seed, keypoints per view): two requests in bucket 2048, two in 8192
REQUESTS = ((11, 1800), (12, 1850), (13, 7000), (14, 6900))
WHOLE_PATH_REQUEST = (21, 1800)

_T0 = time.perf_counter()


def phase(label, t0, **info):
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[phase {label}] {time.perf_counter() - t0:.3f}s {fields}".rstrip(), flush=True)


# ---------------------------------------------------------------- timing

def cuda_ms(fn, reps=5):
    """Mean ms per call over `reps` calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phases

def device_phase():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on the GPU only", file=sys.stderr, flush=True)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False", flush=True)
    print(smi, flush=True)
    phase("0 device", t0, name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())
    return smi


def kernel_name(line):
    """`kernel<a,b>` of the port's kernel whose mangled name is in `line`
    (template arguments are integers), else None."""
    m = re.search(r"(attn_tc_kernel|attn_f32_kernel|sinkhorn_fused_kernel|"
                  r"sinkhorn_stream_kernel|label_rounds_kernel)(I(?:Li\d+E)+E)?", line)
    if not m:
        return None
    args = re.findall(r"Li(\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_report(log):
    """{kernel: {registers, static_smem_bytes, spill_stores, spill_loads}} from
    nvcc -Xptxas=-v output."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = kernel_name(line)
            if name:
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(m.group(1)),
                             static_smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def hgmma_counts(lib_path):
    """HGMMA (wgmma) instructions per attention kernel in the library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line)
            if name and name.startswith("attn_"):
                counts[name] = 0
            else:
                name = None
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


def build_phase():
    t0 = time.perf_counter()
    lib = _build.load()
    if _build.build_log is None:
        print("  ptxas: the library was built by an earlier process; no report", flush=True)
    else:
        for kernel, info in ptxas_report(_build.build_log).items():
            print(f"  ptxas {kernel} {json.dumps(info)}", flush=True)
    hgmma = hgmma_counts(lib._name)
    print(f"  sass HGMMA {json.dumps(hgmma)}", flush=True)
    tc = [hgmma.get(f"attn_tc_kernel<{nb}>") for nb in (1, 2)]  # one or two column blocks
    if not all(tc):
        raise AssertionError(f"a bf16 attention kernel has no HGMMA instruction: {hgmma}")
    phase("1 build", t0, nvcc_seconds=f"{_build.build_seconds}",
          library=os.path.relpath(lib._name, REPO))


def attention_case(b, n, m, masked_tail, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    h, d = 4, HEAD_DIM
    q, k, v = (torch.randn((b, x, h, d), generator=g, device=DEVICE).to(dtype)
               for x in (n, m, m))
    mask = torch.ones((b, m), dtype=torch.bool, device=DEVICE)
    mask[:, m - masked_tail:] = False
    mask[1, : m // 7] = False  # masked keys at the head of one item too
    out = cuda_attention.masked_attention_cuda(q, k, v, mask).float()
    direct = attention.masked_attention_direct(q.float(), k.float(), v.float(), mask)
    want = direct if dtype == torch.float32 else attention.masked_attention_tiled(
        q, k, v, mask, out_dtype=torch.float32)
    torch.cuda.synchronize()
    diff = (out - want).abs()
    atol, rtol = ATTN_TOL[dtype]
    limit = atol + rtol * want.abs()
    info = {}
    if dtype == torch.bfloat16:
        tight = (diff <= limit).float().mean().item()
        info["share_within_tight_rule"] = tight
        if not tight >= ATTN_TIGHT_SHARE:
            raise AssertionError(f"attention kernel bf16 B={b} N={n} M={m}: only {tight} "
                                 f"of the elements within atol {atol} + rtol {rtol} * |ref|")
        limit = limit + ATTN_P_ROUNDING * attention.masked_attention_tiled(
            q, k, v.abs(), mask, out_dtype=torch.float32)
    excess = (diff - limit).max().item()
    err = diff.max().item()
    if not (math.isfinite(err) and excess <= 0):
        raise AssertionError(f"attention kernel {dtype} B={b} N={n} M={m}: max abs err "
                             f"{err}, over its limit by {excess}")
    info["max_abs_err"] = err
    if dtype == torch.bfloat16:
        rel_rms = ((out - direct).pow(2).mean().sqrt() / direct.pow(2).mean().sqrt()).item()
        info.update(max_abs_err_direct=(out - direct).abs().max().item(),
                    rel_rms_err_direct=rel_rms)
        if not rel_rms <= ATTN_BF16_REL_RMS:
            raise AssertionError(f"attention kernel bf16 B={b} N={n} M={m}: RMS error "
                                 f"against direct {rel_rms} > {ATTN_BF16_REL_RMS}")
    return q, k, v, mask, info


def attention_phase():
    t0 = time.perf_counter()
    rows = {}
    for b, n, m, tail in ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, info = attention_case(b, n, m, tail, dtype, seed=n + m)
            row = {"shape": f"B={b} N={n} M={m} H=4 D=64", "dtype": str(dtype)[6:], **info}
            if m % 64 == 0:  # the trunk's shapes: time them
                esz = q.element_size()
                nbytes = 2 * b * n * 4 * 64 * esz + 2 * b * m * 4 * 64 * esz + b * m
                flops = 4 * b * 4 * n * m * 64
                row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, dtype)
                # one exp2 per score on the MUFU units, beside the matrix products
                row["exp_bound_ms"] = 1e3 * b * 4 * n * m / EXP_PER_S
                row["ms"] = cuda_ms(lambda: cuda_attention.masked_attention_cuda(q, k, v, mask))
                row["tflops"] = flops / row["ms"] / 1e9
                row["plain_ms"] = cuda_ms(
                    lambda: attention.masked_attention_tiled(q, k, v, mask))
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                bias = torch.zeros((b, 1, 1, m), dtype=dtype, device=DEVICE)
                bias.masked_fill_(~mask[:, None, None, :], attention.NEG_INF)
                row["library_ms"] = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=bias))
                row["ratio_to_library"] = row["ms"] / row["library_ms"]
            rows[(n, m, row["dtype"])] = row
            print(f"  attention {json.dumps(row)}", flush=True)
            del q, k, v, mask
    torch.cuda.empty_cache()
    phase("2 attention kernel vs plain", t0,
          max_err_f32=max(r["max_abs_err"] for r in rows.values() if r["dtype"] == "float32"),
          max_err_bf16=max(r["max_abs_err"] for r in rows.values() if r["dtype"] == "bfloat16"))
    return rows


def sinkhorn_case(nb, n0, n1, iters, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    b = len(n0)
    scores = 2.0 * torch.randn((b, nb, nb), generator=g, device=DEVICE)
    ar = torch.arange(nb, device=DEVICE)[None]
    row_mask = ar < torch.tensor(n0, device=DEVICE)[:, None]
    col_mask = ar < torch.tensor(n1, device=DEVICE)[:, None]
    alpha = torch.tensor(1.0, device=DEVICE)
    # the couplings as the Matching path builds them for the kernel: rows of
    # nb + 1 floats in a pitch of a multiple of 4
    couplings, log_mu, log_nu, _ = sinkhorn.dustbin_couplings(
        scores, alpha, row_mask, col_mask, row_pitch=nb + 1 + -(nb + 1) % 4)
    got = cuda_sinkhorn.log_optimal_transport_cuda(scores, alpha, iters, row_mask, col_mask)
    want = sinkhorn.log_optimal_transport(scores, alpha, iters, row_mask, col_mask)
    torch.cuda.synchronize()
    err = 0.0
    for i in range(b):
        rows = torch.cat([torch.nonzero(row_mask[i])[:, 0], torch.tensor([nb], device=DEVICE)])
        cols = torch.cat([torch.nonzero(col_mask[i])[:, 0], torch.tensor([nb], device=DEVICE)])
        err = max(err, (got[i][rows][:, cols] - want[i][rows][:, cols]).abs().max().item())
    if not math.isfinite(err) or err > SINKHORN_TOL:
        raise AssertionError(f"Sinkhorn kernel Z ({nb + 1}x{nb + 1}): max abs err "
                             f"{err} > {SINKHORN_TOL}")
    return couplings, log_mu.contiguous(), log_nu.contiguous(), err


def sinkhorn_phase():
    t0 = time.perf_counter()
    rows = {}
    for nb, n0, n1, iters in SINKHORN_CASES:
        z, mu, nu, err = sinkhorn_case(nb, n0, n1, iters, seed=nb)
        b, m1, n1p = z.shape
        # each input read once, each output written once (Z, marginals, u, v)
        nbytes = 4 * b * (m1 * n1p + 2 * (m1 + n1p))
        # per iteration and element: add potential, max, exp, accumulate, twice
        flops = 2 * iters * b * m1 * n1p * 4
        b_ms, b_by = bound_ms(nbytes, flops, torch.float32)
        z_read_ms = 1e3 * 4 * b * m1 * n1p / HBM_BPS
        row = {"shape": f"Z=({b},{m1},{n1p}) iters={iters}", "dtype": "float32",
               "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
               # bound_ms reads Z once, as if it stayed on the chip. Where Z
               # outgrows the 50 MB L2 (268 MB at bucket 8192), any design
               # reads it from HBM once per iteration, as the fused kernel
               # does; a row pass and a column pass read it twice
               "z_reads_per_iter": cuda_sinkhorn.z_reads_per_iter(b, m1, n1p),
               "one_pass_bound_ms": iters * z_read_ms,
               "two_pass_bound_ms": 2 * iters * z_read_ms,
               "ms": cuda_ms(lambda: cuda_sinkhorn.sinkhorn_uv_cuda(z, mu, nu, iters), 3),
               "plain_ms": cuda_ms(lambda: sinkhorn.log_sinkhorn_uv(z, mu, nu, iters), 1),
               "library_ms": None}
        # the kernel's reads of Z over its time
        row["gbps"] = row["z_reads_per_iter"] * iters * 4 * b * m1 * n1p / row["ms"] / 1e6
        rows[nb] = row
        print(f"  sinkhorn {json.dumps(row)}", flush=True)
        del z, mu, nu
    torch.cuda.empty_cache()
    phase("3 sinkhorn kernel vs plain", t0,
          max_err=max(r["max_abs_err"] for r in rows.values()))
    return rows


def slice_phase():
    t0 = time.perf_counter()
    matcher = Matching({"weights_path": WEIGHTS}, device=DEVICE)
    cfg = matcher.cfg.matcher
    if not (cfg.attention_dtype == "bfloat16" and cfg.use_pallas_sinkhorn):
        raise AssertionError(f"Matching defaults on {DEVICE}: {cfg}")
    requests = [synthetic_request(seed, n) for seed, n in REQUESTS]
    reset_counts()
    with record_labels("matching", lambda mode, edges: edges.shape[1] == 8192):
        for i, (req, H) in enumerate(requests):
            t = time.perf_counter()
            pred = matcher(req)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
            n_match = int((pred["matches0"][0] >= 0).sum())
            info = {"request": i, "ms": round(ms, 3),
                    "keypoints": [len(req["keypoints0"]), len(req["keypoints1"])],
                    "kept": [pred["keypoints0"].shape[1], pred["keypoints1"].shape[1]],
                    "matches": n_match, "correct_share": round(correct_share(pred, H), 4)}
            print(f"  request {json.dumps(info)}", flush=True)
            if n_match <= 0:
                raise AssertionError(f"request {i}: no matches")
            for side in "01":
                if not np.all(np.isfinite(pred[f"matching_scores{side}"])):
                    raise AssertionError(f"request {i}: non-finite scores")
                if pred[f"mdesc{side}"].shape != (pred[f"keypoints{side}"].shape[1], 256):
                    raise AssertionError(f"request {i}: mdesc shape")
    launches = counts()
    n = len(requests)
    if launches != {"attention": NUM_LAYERS * n, "sinkhorn": n, "label_rounds": n}:
        raise AssertionError(f"kernel launches on the Matching path: {launches}, expected "
                             f"{NUM_LAYERS} attention, 1 Sinkhorn and 1 label-rounds per request")
    phase("4 slice (Matching, 4 keypoint requests)", t0, launches=json.dumps(launches))
    return launches


def whole_path_phase(variables):
    """One 2048 request in f32 through the kernels and through the plain
    versions; Z is captured from the model to explain any flipped match."""
    t0 = time.perf_counter()
    req, _ = synthetic_request(*WHOLE_PATH_REQUEST)
    runs = {}
    for name, impl, pallas in (("kernels", "auto", True), ("plain", "flash", False)):
        m = Matching({"attention_dtype": "float32", "attention_impl": impl,
                      "use_pallas_sinkhorn": pallas}, variables=variables,
                     device=DEVICE)
        seen = {}
        m.model.register_forward_hook(
            lambda mod, args, out, seen=seen: seen.update(Z=out["Z"][0], kept0=args[3][0]))
        a0, s0 = cuda_attention.launches, cuda_sinkhorn.launches
        pred = m(req)
        launched = (cuda_attention.launches - a0, cuda_sinkhorn.launches - s0)
        if launched != ((NUM_LAYERS, 1) if name == "kernels" else (0, 0)):
            raise AssertionError(f"{name} run launched {launched}")
        runs[name] = (pred, seen)
    (pk, sk), (pp, sp) = runs["kernels"], runs["plain"]
    for side in "01":
        if not np.array_equal(pk[f"keypoints{side}"], pp[f"keypoints{side}"]):
            raise AssertionError(f"kept keypoints of side {side} differ")
    thr = MatcherConfig().match_threshold
    mk, mp = pk["matches0"][0], pp["matches0"][0]
    flips = np.nonzero(mk != mp)[0]
    agree = 1.0 - len(flips) / max(len(mk), 1)
    kept_rows = torch.nonzero(sk["kept0"])[:, 0]
    unexplained = []
    for i in flips:
        near_thr = min(abs(pk["matching_scores0"][0][i] - thr),
                       abs(pp["matching_scores0"][0][i] - thr)) <= 1e-3
        gaps = []
        for seen in (sk, sp):
            row = seen["Z"][kept_rows[i], :-1].exp()
            top2 = torch.topk(row, 2).values
            gaps.append((top2[0] - top2[1]).item())
        if not (near_thr or min(gaps) <= 1e-3):
            unexplained.append(int(i))
    dscore = max(np.abs(pk[f"matching_scores{s}"] - pp[f"matching_scores{s}"]).max()
                 for s in "01")
    zk, zp = sk["Z"], sp["Z"]
    finite = (zp > -1e8)
    dz = (zk[finite] - zp[finite]).abs().max().item()
    info = {"agree": round(agree, 6), "flips": len(flips), "unexplained": unexplained,
            "max_score_diff": float(dscore), "max_Z_diff": dz,
            "matches": [int((mk >= 0).sum()), int((mp >= 0).sum())]}
    print(f"  whole path {json.dumps(info)}", flush=True)
    if agree < 0.995 or unexplained:
        raise AssertionError(f"kernel and plain matches disagree: {info}")
    if not dscore <= 1e-3:
        raise AssertionError(f"matching_scores differ by {dscore} > 1e-3")
    phase("5 whole path kernels vs plain (f32, 2048)", t0)


def fused_pairs(batch, seed0):
    pairs = [synthetic_image_pair(seed0 + i, FUSED_FRAME) for i in range(batch)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]),
            [p[2] for p in pairs])


def stage_split(prof, reps):
    """{range: {device_ms, host_ms}} of the gims.* ranges in a trace, per
    dispatch, and the kernels' busy time against the trace's wall time."""
    stages, busy_us = {}, 0.0
    for evt in prof.key_averages():
        on_device = evt.device_type == torch.autograd.DeviceType.CUDA
        if evt.key.startswith("gims."):
            # a range shows twice: on the host, and on the device from its
            # first kernel's start to its last kernel's end
            stage = stages.setdefault(evt.key, {})
            if on_device:
                stage["device_ms"] = device_us(evt) / 1e3 / reps
            else:
                stage["host_ms"] = evt.cpu_time_total / 1e3 / reps
        elif on_device:
            busy_us += device_us(evt, self_only=True)
    return stages, busy_us / 1e3 / reps


def device_us(evt, self_only=False):
    name = "self_device_time_total" if self_only else "device_time_total"
    if hasattr(evt, name):
        return getattr(evt, name)
    return getattr(evt, name.replace("device", "cuda"))


# the label-rounds kernel's inputs as the paths gave them, one per path
RECORDED = {}


class record_labels:
    """Within the block, keep the first input of the label-rounds kernel
    that `want(mode, edges)` accepts under `path`, for phase 10."""

    def __init__(self, path, want=lambda mode, edges: True):
        self.path, self.want = path, want

    def __enter__(self):
        self.real = real = labels.propagate

        def recording(mode, edges, valid, rounds, nbr_idx=None):
            if self.path not in RECORDED and self.want(mode, edges):
                RECORDED[self.path] = (mode, edges, valid, rounds, nbr_idx)
            return real(mode, edges, valid, rounds, nbr_idx)

        labels.propagate = recording

    def __exit__(self, *exc):
        labels.propagate = self.real


def reset_counts():
    cuda_attention.launches = cuda_sinkhorn.launches = labels.launches = 0


def counts():
    return {"attention": cuda_attention.launches, "sinkhorn": cuda_sinkhorn.launches,
            "label_rounds": labels.launches}


def timed_dispatches(m, batches, name):
    """Timed dispatches of `m` (one per batch after the first, a warm-up):
    launches per dispatch, matches and the share within 3 px, pairs/s and
    peak memory. Fails on a launch count other than 18 attention, 1
    Sinkhorn and 1 label-rounds per dispatch, a pair without matches,
    non-finite scores or a correct share under 0.5."""
    imgs0, imgs1, _ = batches[0]
    m.collect_batch(m.dispatch_batch(imgs0, imgs1))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    preds, per_dispatch = [], []
    t = time.perf_counter()
    for imgs0, imgs1, hs in batches[1:]:
        before = counts()
        preds.append((m.collect_batch(m.dispatch_batch(imgs0, imgs1)), hs))
        per_dispatch.append(tuple(v - before[k] for k, v in counts().items()))
    elapsed = time.perf_counter() - t
    launches = counts()
    if any(d != (NUM_LAYERS, 1, 1) for d in per_dispatch):
        raise AssertionError(f"{name}: launches per dispatch (attention, Sinkhorn, label "
                             f"rounds) {per_dispatch}, expected ({NUM_LAYERS}, 1, 1)")
    peak = torch.cuda.max_memory_allocated()
    n_good = n_all = 0
    shares = []
    for batch, hs in preds:
        for pred, H in zip(batch, hs):
            n = int((pred["matches0"][0] >= 0).sum())
            if n <= 0:
                raise AssertionError(f"{name}: a pair has no matches")
            if not np.all(np.isfinite(pred["matching_scores0"])):
                raise AssertionError(f"{name}: non-finite matching scores")
            share = correct_share(pred, H)
            shares.append(round(share, 4))
            n_good += share * n
            n_all += n
    pairs = len(preds) * len(preds[0][0])
    share = n_good / n_all
    info = {"config": name, "pairs": pairs, "dispatches": len(preds),
            "pairs_per_s": pairs / elapsed, "ms_per_dispatch": 1e3 * elapsed / len(preds),
            "max_memory_allocated_gb": peak / 1e9,
            "keypoints_per_image": int(preds[0][0][0]["keypoints0"].shape[1]),
            "matches_per_pair": n_all / pairs, "correct_share": share,
            "correct_share_per_pair": shares, "launches": launches}
    print(f"  fused {json.dumps(info)}", flush=True)
    if not share >= 0.5:
        raise AssertionError(f"{name}: {share} of matches within 3 px < 0.5")
    return launches


def profiled_dispatch(m, batch, names, label):
    """The stage split of one dispatch in a torch.profiler trace."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    imgs0, imgs1, _ = batch
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        m.collect_batch(m.dispatch_batch(imgs0, imgs1))
        wall_ms = 1e3 * (time.perf_counter() - t)
    stages, busy_ms = stage_split(prof, 1)
    split = {"config": label, "profiled_dispatch_ms": wall_ms, "device_busy_ms": busy_ms,
             "idle_share": 1 - busy_ms / wall_ms,
             "stages": {k: stages[k] for k in names if k in stages}}
    print(f"  fused stages {json.dumps(split)}", flush=True)
    missing = [k for k in names if k not in stages]
    if missing:
        raise AssertionError(f"{label}: stage ranges missing from the trace: {missing}")


def fused_phase(variables, car_variables):
    """The fused image path at the bench's configuration in two AGC
    configurations, timed in turns A, B, B, A."""
    t0 = time.perf_counter()
    common = dict(variables=variables, car_variables=car_variables,
                  total_keypoints=FUSED_KEYPOINTS, device=DEVICE)
    ms = {"A": fused.FusedMatching({**FUSED_CONFIG, **EXACT_KNOBS}, **common),
          "B": fused.FusedMatching(FUSED_CONFIG, **common)}
    for name, m in ms.items():
        rc = m.resolved_config()
        want = EXACT_KNOBS if name == "A" else {**ACCEL_DEFAULTS, "topk_impl": "approx"}
        got = {k: rc["frontend" if k == "topk_impl" else "agc"][k] for k in want}
        if not (rc["matcher"]["attention_dtype"] == "bfloat16"
                and rc["matcher"]["use_pallas_sinkhorn"]
                and rc["frontend"]["dense_dtype"] == "bfloat16"
                and rc["compact_to"] == FUSED_COMPACT and got == want):
            raise AssertionError(f"FusedMatching {name} on {DEVICE}: {rc}")
    batches = [fused_pairs(FUSED_BATCH, 100 * (i + 1)) for i in range(FUSED_TIMED + 1)]
    total = {"attention": 0, "sinkhorn": 0, "label_rounds": 0}
    for name in ("A", "B", "B", "A"):
        with record_labels("fused_" + name):
            launches = timed_dispatches(ms[name], batches, name)
        total = {k: total[k] + launches[k] for k in total}
    for name in ("A", "B"):
        profiled_dispatch(ms[name], batches[1], FUSED_STAGES, name)
    phase("6 fused image path (FusedMatching, 8 pairs per dispatch, A B B A)", t0,
          launches=json.dumps(total))
    return total, ms


def matcher_vs_plain(m, kp, sc, va, de, b, frame, compact_to, name):
    """The matcher stages of `m` in f32 on given keypoints and descriptors,
    through the kernels and through the plain versions: kept and matches
    identical, matching scores within 1e-3."""
    runs = {}
    for run, impl, kernel in (("kernels", "auto", True), ("plain", "flash", False)):
        mcfg = dataclasses.replace(m.mcfg, attention_dtype="float32",
                                   attention_impl=impl, use_pallas_sinkhorn=kernel)
        model = GMatcher(mcfg).to(DEVICE).eval()
        model.load_state_dict(m.model.state_dict())
        a0, s0 = cuda_attention.launches, cuda_sinkhorn.launches
        out = pipeline.forward_match(
            model, m.acfg, kp[:b], de[:b], va[:b], kp[b:], de[b:], va[b:],
            image_shape=frame, compact_to=compact_to, scores0=sc[:b], scores1=sc[b:])
        launched = (cuda_attention.launches - a0, cuda_sinkhorn.launches - s0)
        if launched != ((NUM_LAYERS, 1) if kernel else (0, 0)):
            raise AssertionError(f"{name}: {run} run launched {launched}")
        runs[run] = {k: v.cpu() for k, v in out.items()}
    k, p = runs["kernels"], runs["plain"]
    diff = {key: int((k[key] != p[key]).sum()) for key in
            ("kept0", "kept1", "matches0", "matches1")}
    dscore = max((k[f"matching_scores{s}"] - p[f"matching_scores{s}"]).abs().max().item()
                 for s in "01")
    info = {"path": name, "differing": diff, "max_score_diff": dscore,
            "matches": int((k["matches0"] >= 0).sum()),
            "kept": [int(k["kept0"].sum()), int(k["kept1"].sum())]}
    print(f"  whole path f32 {json.dumps(info)}", flush=True)
    if any(diff.values()):
        raise AssertionError(f"{name}: kernel and plain outputs differ: {info}")
    if not dscore <= 1e-3:
        raise AssertionError(f"{name}: matching_scores differ by {dscore} > 1e-3")


def fused_vs_plain_phase(m):
    """One batch of the fused path in f32: one extraction, then the matcher
    through the kernels and through the plain versions."""
    t0 = time.perf_counter()
    imgs0, imgs1, _ = fused_pairs(FUSED_BATCH, 900)
    imgs = torch.from_numpy(np.concatenate([imgs0, imgs1])).to(DEVICE)
    fe = dataclasses.replace(m.fe, dense_dtype="float32")
    budgets = fused.octave_budgets(*FUSED_FRAME, FUSED_KEYPOINTS, fe.upsample)
    with torch.no_grad():  # (m's dispatches are not used after this phase)
        kp, sc, va, de = fused._extract_side(imgs, budgets, fe, m.car_model.float())
    matcher_vs_plain(m, kp, sc, va, de, FUSED_BATCH, FUSED_FRAME, FUSED_COMPACT, "fused A")
    phase("7 fused path kernels vs plain (f32, 8 pairs)", t0)
    return kp, de, va


def straddle_check(a, b, kpts, descs, radius, name):
    """Entries where two AGC builds' adjacencies differ: an edge candidate
    among them must lie within BAND_STRADDLE_TOL of the threshold, at most
    BAND_MAX_DIFF entries per set. Returns the count of differing entries
    per set."""
    diff = a.adj != b.adj
    per_set = diff.flatten(1).sum(1).tolist()
    if diff.any():
        bi, ii, jj = torch.nonzero(diff, as_tuple=True)
        normed = graph._normalize_rows(descs)
        near = graph.pairwise_sq_dists(kpts)[bi, ii, jj] <= radius * radius
        sim = (normed[bi, ii] * normed[bi, jj]).sum(-1)
        above = (sim - a.threshold[bi])[near]
        if above.numel() and not above.max().item() < BAND_STRADDLE_TOL:
            raise AssertionError(f"{name}: an edge candidate {above.max().item()} above the "
                                 "threshold differs")
    if max(per_set) > BAND_MAX_DIFF:
        raise AssertionError(f"{name}: {per_set} differing adjacency entries per set")
    return per_set


def agc_builds_phase(kp, de, va, acfg):
    """Every AGC build on one batch of the fused path's keypoints (16 sets
    of 6144), each under set_sync_debug_mode("error"); the band build
    against the dense build with the same threshold and reconnect, with
    converged labels."""
    t0 = time.perf_counter()
    base = dict(radius=acfg.radius, percentile=acfg.percentile, min_size=acfg.min_size)
    approx = dict(threshold_impl="approx", threshold_stride=4, reconnect_impl="centroid",
                  reconnect_buckets=1024, **base)
    band_kw = dict(band_halfwidth=512, threshold_stride=4, reconnect_buckets=1024, **base)
    builds = {
        "dense exact": lambda: graph.build_graph(kp, de, va, **base),
        "dense approx centroid": lambda: graph.build_graph(kp, de, va, **approx),
        "dense sparse": lambda: graph.build_graph(kp, de, va, cc_impl="sparse", **base),
        "band": lambda: graph.build_graph_band(kp, de, va, **band_kw),
        "band deferred, band components": lambda: graph.build_graph_band(
            kp, de, va, defer_unpermute=True, cc_impl="band", **band_kw),
        "dense approx centroid, converged": lambda: graph.build_graph(
            kp, de, va, cc_rounds=CONVERGED_ROUNDS, **approx),
        "band, converged": lambda: graph.build_graph_band(
            kp, de, va, cc_rounds=CONVERGED_ROUNDS, **band_kw),
    }
    outs = {}
    for name, build in builds.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs[name] = build()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        row = {"build": name, "ms": 1e3 * (time.perf_counter() - t),
               "kept": outs[name].kept.sum(1).tolist(), "rounds_run": int(labels.last_rounds)}
        print(f"  agc {json.dumps(row)}", flush=True)
    cov = [graph.band_coverage(kp[i], va[i], acfg.radius, 512)["coverage"]
           for i in range(kp.shape[0])]
    full = torch.tensor([c == 1.0 for c in cov], device=kp.device)

    def on_full(g):
        return graph.AGCGraph(*(x[full] for x in g[:4]))

    band, dense = on_full(outs["band, converged"]), on_full(outs["dense approx centroid, converged"])
    per_set = straddle_check(band, dense, kp[full], de[full], acfg.radius, "band vs dense")
    kept_diff = int((band.kept != dense.kept).sum())
    capped = [int(x) for x in (on_full(outs["band"]).kept
                               != on_full(outs["dense approx centroid"]).kept).sum(1)]
    # the deferred band build composes inv into the caller's order
    deferred, plain_band = outs["band deferred, band components"], outs["band"]
    inv, dadj = deferred.inv, deferred.adj
    adj_c = torch.gather(torch.gather(dadj, 1, inv[..., None].expand(-1, -1, dadj.shape[2])),
                         2, inv[:, None, :].expand(-1, inv.shape[1], -1))
    info = {"coverage_per_set": cov, "sets_full_coverage": int(full.sum()),
            "converged_adj_diff_per_set": per_set, "converged_kept_diff": kept_diff,
            "threshold_equal": bool(torch.equal(band.threshold, dense.threshold)),
            "labels_equal": bool(torch.equal(band.labels, dense.labels)),
            "capped_kept_diff_per_set": capped,
            "deferred_equals_band": bool(torch.equal(adj_c, plain_band.adj)
                                         and torch.equal(deferred.kept, plain_band.kept))}
    print(f"  agc band vs dense {json.dumps(info)}", flush=True)
    if not full.any():
        raise AssertionError("no set with full band coverage")
    if kept_diff > BAND_MAX_DIFF or not info["deferred_equals_band"]:
        raise AssertionError(f"band build: {info}")
    phase("8 AGC builds, no host sync; band vs dense", t0)


def devsift_phase(variables):
    """devsift at the JAX bench's configuration: timed dispatches, stage
    split, then one dispatch's matcher in f32 through kernels and plain."""
    t0 = time.perf_counter()
    m = fused.FusedMatching(DEVSIFT_CONFIG, variables=variables,
                            total_keypoints=DEVSIFT_KEYPOINTS, device=DEVICE)
    rc = m.resolved_config()
    if not (rc["matcher"]["use_pallas_sinkhorn"] and rc["agc"]["agc_impl"] == "band"
            and rc["agc"]["cc_impl"] == "band" and rc["compact_to"] == DEVSIFT_COMPACT
            and m.car_model is None):
        raise AssertionError(f"devsift FusedMatching on {DEVICE}: {rc}")
    batches = [fused_pairs(DEVSIFT_BATCH, 300 + 10 * i) for i in range(FUSED_TIMED + 1)]
    with record_labels("devsift"):
        launches = timed_dispatches(m, batches, "devsift")
    profiled_dispatch(m, batches[1], DEVSIFT_STAGES, "devsift")
    imgs0, imgs1, _ = fused_pairs(DEVSIFT_BATCH, 950)
    imgs = torch.from_numpy(np.concatenate([imgs0, imgs1])).to(DEVICE)
    budgets = fused.octave_budgets(*FUSED_FRAME, DEVSIFT_KEYPOINTS, m.fe.upsample)
    with torch.no_grad():
        kp, sc, va, de = fused._extract_side(imgs, budgets, m.fe, None)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pipeline.run_agc(kp, de, va, m.acfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    matcher_vs_plain(m, kp, sc, va, de, DEVSIFT_BATCH, FUSED_FRAME, DEVSIFT_COMPACT, "devsift")
    phase("9 devsift (4 pairs per dispatch, 12288 keypoints)", t0,
          launches=json.dumps(launches))
    return launches


def label_phase():
    """The label-rounds kernel against its plain version on the recorded
    inputs; times of both."""
    t0 = time.perf_counter()
    rows = {}
    for path, (mode, edges, valid, rounds, nbr) in RECORDED.items():
        got = labels.propagate(mode, edges, valid, rounds, nbr)
        run = int(labels.last_rounds)
        want = labels.propagate_plain(mode, edges, valid, rounds, nbr)
        err = (got - want).abs().max().item()
        b, n, w = edges.shape
        nbytes = edges.numel() + valid.numel() + 4 * b * n  # edges, valid, labels
        b_ms, b_by = bound_ms(nbytes, 0, torch.float32)
        row = {"path": path, "mode": mode, "shape": f"B={b} N={n} W={w}", "rounds_cap": rounds + 1,
               "rounds_run": run, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
               # reading the edges once per round run
               "per_round_read_ms": 1e3 * run * edges.numel() / HBM_BPS,
               "ms": cuda_ms(lambda: labels.propagate(mode, edges, valid, rounds, nbr)),
               "plain_ms": cuda_ms(lambda: labels.propagate_plain(mode, edges, valid, rounds,
                                                                  nbr), 1),
               "library_ms": None}
        print(f"  label rounds {json.dumps(row)}", flush=True)
        if err != 0 or not 1 <= run <= rounds + 1:
            raise AssertionError(f"label-rounds kernel against plain: {row}")
        rows[path] = row
    phase("10 label-rounds kernel vs plain", t0)
    return rows


def kernel_rows(attn, sk, lab, path_launches):
    """The `kernels` line: K1, K2 and the label-rounds kernel at each path's
    shapes, with that path's main-run launch counts."""
    no_library = ("none: no single PyTorch call computes the Sinkhorn "
                  "iterations' potentials")
    rows = []
    for suffix, attn_case, sk_case, label_path in (
            ("", ATTN_CASES[1], SINKHORN_CASES[1], "matching"),
            ("_fused_path", ATTN_CASES[3], SINKHORN_CASES[3], "fused_B"),
            ("_devsift_path", ATTN_CASES[4], SINKHORN_CASES[4], "devsift")):
        _, n, m, _ = attn_case
        a, s = attn[(n, m, "bfloat16")], sk[sk_case[0]]
        c = path_launches[suffix]
        rows += [
            {"name": "masked_attention" + suffix, "route": "cuda",
             "source": "gims_tpu_torch/csrc/attention.cu",
             "replaces": "gims_tpu/matcher/pallas_attention.py:42",
             **a, "launches": c["attention"], "kernel_ms": a["ms"]},
            {"name": "sinkhorn_uv" + suffix, "route": "cuda",
             "source": "gims_tpu_torch/csrc/sinkhorn.cu",
             "replaces": "gims_tpu/matcher/pallas_sinkhorn.py:40",
             **s, "launches": c["sinkhorn"], "kernel_ms": s["ms"],
             "library_ms": None, "library": no_library},
            {"name": "label_rounds" + suffix, "route": "cuda",
             "source": "gims_tpu_torch/csrc/labels.cu",
             # not a Pallas kernel: the lax.while_loop of the label rounds
             "replaces": "gims_tpu/agc/graph.py:167",
             **lab[label_path], "launches": c["label_rounds"], "kernel_ms": lab[label_path]["ms"],
             "library": "none: no single PyTorch call labels connected components"},
        ]
    return rows


def main():
    smi = device_phase()
    build_phase()
    attn = attention_phase()
    sk = sinkhorn_phase()
    launches = slice_phase()
    whole_path_phase(load_gims_checkpoint(WEIGHTS))
    fused_launches, fms = fused_phase(load_gims_checkpoint(E2E_WEIGHTS),
                                      load_car_checkpoint(E2E_CAR_WEIGHTS))
    kp, de, va = fused_vs_plain_phase(fms["A"])
    agc_builds_phase(kp, de, va, fms["B"].acfg)
    del kp, de, va, fms
    torch.cuda.empty_cache()
    devsift_launches = devsift_phase(load_gims_checkpoint(WEIGHTS))
    lab = label_phase()

    t0 = time.perf_counter()
    rows = kernel_rows(attn, sk, lab, {"": launches, "_fused_path": fused_launches,
                                       "_devsift_path": devsift_launches})
    print(json.dumps({"kernels": rows}), flush=True)
    phase("11 kernels", t0, total_seconds=f"{time.perf_counter() - _T0:.1f}",
          card=json.dumps(smi))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
