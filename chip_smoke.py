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
  10 the staged image path S1, the JAX staged bench's device-detector
    configuration (bench.py run_staged, GIMS_BENCH_DETECTOR=device) with
    SIFT descriptors on the card in place of host cv2: Matching with the
    staged checkpoint, 6144 keypoints, fast_frontend, 20 Sinkhorn
    iterations, threshold 0.02, bf16 trunk, the Sinkhorn kernel, AGC
    15/2/7, on 8 synthetic 800x600 gray pairs (stacked to 3 channels as
    api._as_hw3 does), each pair's prepare_features overlapped with the
    previous request as bench.run_staged does. 18 attention, 1 Sinkhorn and
    1 label-rounds launch per request, matches on every pair, at least half
    within 3 px; ms per pair (also with the same requests one after the
    other), the timings split, peak memory and the stage split of one
    profiled request.
  11 S2, every other source on 2 pairs each: carhynet at reference parity
    (bicubic 64x64 warp) and at fast_frontend (bilinear 32x32), dense, and
    dense_gray with the joint end-to-end weights; then one delaunay=True
    request (every detected keypoint kept). Structure checks (shapes,
    kept keypoints among the detected ones, mutual matches), timings, the
    stage split of one carhynet request; then one carhynet request in f32
    through the kernels and through the plain versions, on the same
    features: kept and matches identical. The colour CAR-HyNet is a seeded
    random init (the repo has no trained colour weights).
  12 the fused colour sources, FusedMatching(descriptor_source="carhynet")
    and ("dense") at the JAX defaults (upsampled pyramid, 12288 keypoints
    compacted to 6144, the card's AGC defaults, fast_frontend) on 4
    synthetic colour 800x600 pairs per dispatch, random colour CAR-HyNet:
    18 attention, 1 Sinkhorn and 1 label-rounds launch per dispatch,
    matches on every pair, pairs/s, peak memory and the stage split of one
    dispatch (gims.frontend.warp around the patch warp); one dispatch of
    each under torch.cuda.set_sync_debug_mode("error") up to the readout;
    one batch of each in f32 through the kernels and the plain versions:
    kept and matches identical.
  15 the evaluation (run after phase 12, before 13): the homography
    benchmark of the JAX package's quality records (docs/quality_records/,
    synthetic regime): eval.homography.generate_benchmark makes its 199
    procedural 800x600 pairs (seed 3) and run_benchmark evaluates them with
    FusedMatching at each record's settings, (a) dense_gray with the joint
    end-to-end weights, 6144 keypoints, no upsample, no compaction; (b)
    devsift with the staged checkpoint, 12288 keypoints compacted to 6144,
    upsampled; both with AGC 15/2/7, 20 Sinkhorn iterations, threshold
    0.02, the card's AGC defaults (band 512, threshold stride 4, centroid
    1024, approximate top-k), ground-truth matching and RANSAC on the card.
    One line each: RANSAC and DLT AUC@5/10/25, precision, recall, skip
    share, ms per pair (host clock, reading and warping included), launches
    per pair and the record's numbers; it fails if a pair is skipped, if a
    pair does not take 18 attention, 1 Sinkhorn and 1 label-rounds launch,
    or if RANSAC AUC@5/10/25, precision or recall lies more than 3.0 points
    from its record, precision and recall scored as the records scored them
    (record_gt_scores: the TPU's bf16-rounded ground truth; the port's exact
    ones are printed beside). Then eval_homography_cli on 8 of the pairs with staged
    Matching (the staged checkpoint, SIFT descriptors from the device
    detector, --fast, 6144 keypoints): its artifacts, no pair skipped, its
    numbers printed with no bound (no JAX record exists for it).
  13 the label-rounds kernel against its plain version on the graphs the
    paths above gave it (recorded during phases 4, 6, 9, 10, 12 and 15):
    labels equal, rounds run, times.
  14 one JSON line with every kernel's launches, error and times, on the
    eight paths' shapes; the script's total seconds.
  Then the last line: {"ok": true, "device": {...}}.

Any mismatch raises and the process exits non-zero. Without CUDA it
exits non-zero at once: there is no CPU fallback. It imports torch, numpy,
the standard library and gims_tpu_torch only, and writes nothing outside
gims_tpu_torch/_build/ but phase 15's pairs and artifacts, in a temporary
directory that it removes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from gims_tpu_torch import _build, fused  # noqa: E402
from gims_tpu_torch.agc import graph, labels  # noqa: E402
from gims_tpu_torch.api import Matching  # noqa: E402
from gims_tpu_torch.carhynet.convert import load_car_checkpoint  # noqa: E402
from gims_tpu_torch.cli import eval_homography_cli  # noqa: E402
from gims_tpu_torch.config import FrontendConfig, MatcherConfig  # noqa: E402
from gims_tpu_torch.core.imgproc import bgr_to_gray  # noqa: E402
from gims_tpu_torch.eval import homography  # noqa: E402
from gims_tpu_torch.eval import metrics as eval_metrics  # noqa: E402
from gims_tpu_torch.frontend.feature import FeatureFrontend  # noqa: E402
from gims_tpu_torch.matcher import attention, cuda_attention, cuda_sinkhorn, pipeline, sinkhorn  # noqa: E402
from gims_tpu_torch.matcher.convert import load_gims_checkpoint  # noqa: E402
from gims_tpu_torch.matcher.gmatcher import GMatcher  # noqa: E402
from gims_tpu_torch.synthetic import correct_share, synthetic_image_pair, synthetic_request  # noqa: E402
from gims_tpu_torch.train import gt  # noqa: E402

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
# and the staged image path's (one pair, both sides stacked: B=2, 6144), and
# the fused colour sources' (as devsift's)
ATTN_CASES = ((2, 2048, 2048, 248), (2, 8192, 8192, 1192), (2, 1000, 2017, 300),
              (16, 3072, 3072, 400), (8, 6144, 6144, 700), (2, 6144, 6144, 900))
# (bucket, valid rows, valid cols, iterations) of the Sinkhorn input Z
# (bucket+1 square), one entry per batch item: the fused kernel (Z read once
# per iteration) at 2049 and 8193, the streaming kernel (twice) at 24577,
# and the fused path's batch of 8 at 3073 with 20 iterations
FUSED_ITERS = 20
SINKHORN_CASES = ((2048, [1800], [1750], SINKHORN_ITERS), (8192, [7000], [6900], SINKHORN_ITERS),
                  (24576, [22000], [21000], 3),
                  (3072, [2900, 3072, 2500, 3000, 2800, 3072, 2700, 2950],
                   [2950, 3000, 2600, 3072, 2750, 3050, 2800, 2900], FUSED_ITERS),
                  (6144, [5900, 6144, 5200, 6050], [6000, 5800, 6144, 4900], FUSED_ITERS),
                  (6144, [6144], [6100], FUSED_ITERS))
# the fused image path as the JAX package's bench runs it (bench.py:223-275)
FUSED_FRAME = (600, 800)
FUSED_BATCH = 8
FUSED_KEYPOINTS = 6144
FUSED_COMPACT = 3072
FUSED_CONFIG = {"descriptor_source": "dense_gray", "radius": 15, "percentile": 2, "min_size": 7,
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
# the staged image path as the JAX staged bench runs it with the device
# detector (bench.py run_staged), SIFT descriptors on the card
STAGED_PAIRS = 8
STAGED_CONFIG = {"sinkhorn_iterations": FUSED_ITERS, "match_threshold": 0.02,
                 "max_keypoints": 6144, "attention_dtype": "bfloat16", "fast_frontend": True,
                 "use_pallas_sinkhorn": True, "descriptor_source": "sift",
                 "detector": "device", "sift_descriptor": "device"}
STAGED_KNOBS = {"radius": 15, "percentile": 2, "min_size": 7}
STAGED_STAGES = ("gims.frontend.detect", "gims.frontend.pyramid", "gims.frontend.describe",
                 "gims.agc", "gims.encoder", "gims.trunk", "gims.sinkhorn", "gims.extract")
CARHYNET_STAGED_STAGES = ("gims.frontend.detect", "gims.frontend.pyramid",
                          "gims.frontend.warp", "gims.frontend.cnn") + STAGED_STAGES[3:]
# the fused colour sources at the JAX defaults, 4 pairs per dispatch as devsift
COLOUR_BATCH = 4
COLOUR_KEYPOINTS = 12288
COLOUR_COMPACT = 6144
COLOUR_CONFIG = {"radius": 15, "percentile": 2, "min_size": 7,
                 "sinkhorn_iterations": FUSED_ITERS, "match_threshold": 0.02}
COLOUR_STAGES = {
    "carhynet": ("gims.frontend.pyramid", "gims.frontend.orientation", "gims.frontend.detect",
                 "gims.frontend.warp", "gims.frontend.cnn") + STAGES,
    "dense": ("gims.frontend.pyramid", "gims.frontend.cnn", "gims.frontend.detect",
              "gims.frontend.sample") + STAGES}
# the evaluation (phase 15): the JAX package's recorded synthetic regime
# (scripts/quality_eval.py: generate_benchmark(..., seed=3), 199 procedural
# 800x600 pairs), each fused configuration at its record's settings
EVAL_PAIRS = 199
EVAL_SEED = 3
EVAL_RESIZE = (800, 600)
EVAL_AGC = {"radius": 15, "percentile": 2, "min_size": 7}
EVAL_BOUND = 3.0  # points of RANSAC AUC@5/10/25, precision and recall
EVAL_STAGED_PAIRS = 8
EVAL_RECORDS = {
    "dense_gray": "fused_fo0_dense_gray_gims_tpu_dense_gray_e2e_r15p2m7_n199.json",
    "devsift": "fused_devsift_gims_tpu_sift_last_r15p2m7_n199.json"}
EVAL_CONFIGS = {  # scripts/quality_eval.py --fused with each record's args
    "dense_gray": ({"descriptor_source": "dense_gray", "upsample": False, "compact_to": None},
                   6144),
    "devsift": ({"descriptor_source": "devsift", "upsample": True, "compact_to": 6144}, 12288)}
EVAL_COMMON = {"sinkhorn_iterations": FUSED_ITERS, "match_threshold": 0.02,
               "attention_dtype": "bfloat16", "use_pallas_sinkhorn": True, "fast_frontend": True,
               "sift_samples": 16, "threshold_stride": 4, "dense_first_map_oct": 0, **EVAL_AGC}
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
            rows[(b, n, m, row["dtype"])] = row
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
        rows[(nb, b)] = row
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


def fused_pairs(batch, seed0, colour=False):
    pairs = [synthetic_image_pair(seed0 + i, FUSED_FRAME, colour) for i in range(batch)]
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


def timed_dispatches(m, batches, name, min_share=0.5):
    """Timed dispatches of `m` (one per batch after the first, a warm-up):
    launches per dispatch, matches and the share within 3 px, pairs/s and
    peak memory. Fails on a launch count other than 18 attention, 1
    Sinkhorn and 1 label-rounds per dispatch, a pair without matches,
    non-finite scores or a correct share under `min_share` (None: no
    bound, for descriptors of untrained weights)."""
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
    if min_share is not None and not share >= min_share:
        raise AssertionError(f"{name}: {share} of matches within 3 px < {min_share}")
    return launches


def profiled(fn, names, label, tag):
    """The stage split of one call of `fn` in a torch.profiler trace."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    stages, busy_ms = stage_split(prof, 1)
    split = {"config": label, "profiled_ms": wall_ms, "device_busy_ms": busy_ms,
             "idle_share": 1 - busy_ms / wall_ms,
             "stages": {k: stages[k] for k in names if k in stages}}
    print(f"  {tag} {json.dumps(split)}", flush=True)
    missing = [k for k in names if k not in stages]
    if missing:
        raise AssertionError(f"{label}: stage ranges missing from the trace: {missing}")


def profiled_dispatch(m, batch, names, label):
    """The stage split of one dispatch in a torch.profiler trace."""
    imgs0, imgs1, _ = batch
    profiled(lambda: m.collect_batch(m.dispatch_batch(imgs0, imgs1)), names, label,
             "fused stages")


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


def check_request(pred, feats, name):
    """A staged answer's structure: per side at most the detected keypoints,
    each of them a detected one (none of the padding), finite scores, and
    mutual matches within the kept sets."""
    for s in "01":
        kept = pred["keypoints" + s][0]
        detected = {tuple(p) for p in feats[s]["kp"].pt.tolist()}
        if not all(tuple(p) in detected for p in kept.tolist()):
            raise AssertionError(f"{name}: a kept keypoint of side {s} was not detected")
        k = kept.shape[0]
        if pred["matches" + s].shape != (1, k) or pred["matching_scores" + s].shape != (1, k):
            raise AssertionError(f"{name}: side {s} shapes")
        if not np.all(np.isfinite(pred["matching_scores" + s])):
            raise AssertionError(f"{name}: non-finite matching scores")
    m0, m1 = pred["matches0"][0], pred["matches1"][0]
    i = np.nonzero(m0 >= 0)[0]
    if m0.max(initial=-1) >= len(m1) or not np.array_equal(m1[m0[i]], i) \
            or int((m1 >= 0).sum()) != len(i):
        raise AssertionError(f"{name}: matches are not mutual")


def staged_request(m, pair, **extra):
    return m({"image0": pair[0], "image1": pair[1], **STAGED_KNOBS, **extra})


def staged_phase(variables):
    """S1: the JAX staged bench's device-detector configuration, 8 pairs,
    each pair's frontend overlapped with the previous request."""
    t0 = time.perf_counter()
    m = Matching(STAGED_CONFIG, variables=variables, device=DEVICE)
    fe, mc = m.frontend.cfg, m.cfg.matcher
    if not (mc.attention_dtype == "bfloat16" and mc.use_pallas_sinkhorn
            and (fe.descriptor_source, fe.detector, fe.sift_descriptor, fe.interpolation,
                 fe.warp_size) == ("sift", "device", "device", "linear", 32)):
        raise AssertionError(f"staged S1 configuration on {DEVICE}: {fe} {mc}")
    pairs = [synthetic_image_pair(500 + i, FUSED_FRAME) for i in range(STAGED_PAIRS + 1)]
    staged_request(m, pairs[0], return_descriptors=False)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    preds = []
    with record_labels("staged"), ThreadPoolExecutor(max_workers=1) as pool:
        t = time.perf_counter()
        fut = pool.submit(m.prepare_features, pairs[1][:2])
        for i, pair in enumerate(pairs[1:]):
            feats = fut.result()
            if i + 1 < STAGED_PAIRS:
                fut = pool.submit(m.prepare_features, pairs[i + 2][:2])
            preds.append((staged_request(m, pair, features=feats, return_descriptors=False),
                          feats, pair[2]))
        elapsed = time.perf_counter() - t
    launches = counts()
    n = STAGED_PAIRS
    if launches != {"attention": NUM_LAYERS * n, "sinkhorn": n, "label_rounds": n}:
        raise AssertionError(f"staged S1 launches {launches}, expected {NUM_LAYERS} attention, "
                             "1 Sinkhorn and 1 label-rounds per request")
    # the same pairs one request after the other, frontends not overlapped
    t = time.perf_counter()
    for pair in pairs[1:]:
        staged_request(m, pair, return_descriptors=False)
    sequential = time.perf_counter() - t
    n_good = n_all = 0
    shares = []
    for pred, feats, H in preds:
        check_request(pred, feats, "staged S1")
        k = int((pred["matches0"][0] >= 0).sum())
        if k <= 0:
            raise AssertionError("staged S1: a pair has no matches")
        share = correct_share(pred, H)
        shares.append(round(share, 4))
        n_good += share * k
        n_all += k
    info = {"pairs": n, "ms_per_pair": 1e3 * elapsed / n, "pairs_per_s": n / elapsed,
            "sequential_ms_per_pair": 1e3 * sequential / n,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "keypoints_per_image": [p[1]["0"]["n"] for p in preds],
            "matches_per_pair": n_all / n, "correct_share": n_good / n_all,
            "correct_share_per_pair": shares, "launches": launches,
            "timings_last_pair_s": m.timings}
    print(f"  staged {json.dumps(info)}", flush=True)
    if not info["correct_share"] >= 0.5:
        raise AssertionError(f"staged S1: {info['correct_share']} of matches within 3 px < 0.5")
    profiled(lambda: staged_request(m, pairs[1]), STAGED_STAGES, "S1", "staged stages")
    phase("10 staged image path S1 (Matching, device detector, SIFT on the card, 8 pairs)", t0,
          launches=json.dumps(launches))
    return launches, m


def staged_sources_phase(s1, variables, e2e_variables, e2e_car):
    """S2: every other descriptor source on 2 pairs, a Delaunay request, and
    a carhynet request in f32 through the kernels and the plain versions."""
    t0 = time.perf_counter()
    pairs = [synthetic_image_pair(600 + i, FUSED_FRAME) for i in range(2)]
    base = {k: v for k, v in STAGED_CONFIG.items()
            if k not in ("fast_frontend", "descriptor_source", "sift_descriptor")}
    sources = (("carhynet", {"descriptor_source": "carhynet"}),
               ("carhynet fast", {"descriptor_source": "carhynet", "fast_frontend": True}),
               ("dense", {"descriptor_source": "dense"}),
               ("dense_gray", {"descriptor_source": "dense_gray"}))
    ms = {}
    for name, extra in sources:
        frontend = None
        mvars = variables
        if name == "dense_gray":  # the joint end-to-end weights, matcher and CNN
            frontend = FeatureFrontend(FrontendConfig(descriptor_source="dense_gray",
                                                      detector="device"),
                                       variables=e2e_car, device=DEVICE)
            mvars = e2e_variables
        m = ms[name] = Matching({**base, **extra}, variables=mvars, frontend=frontend,
                                device=DEVICE)
        fe = m.frontend.cfg
        for i, pair in enumerate(pairs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            feats = m.prepare_features(pair[:2])
            pred = staged_request(m, pair, features=feats)
            ms_pair = 1e3 * (time.perf_counter() - t)
            check_request(pred, feats, name)
            row = {"source": name, "interpolation": fe.interpolation, "warp_size": fe.warp_size,
                   "pair": i, "ms": ms_pair, "keypoints": [feats["0"]["n"], feats["1"]["n"]],
                   "kept": [pred["keypoints0"].shape[1], pred["keypoints1"].shape[1]],
                   "matches": int((pred["matches0"][0] >= 0).sum()),
                   "correct_share": round(correct_share(pred, pair[2]), 4),
                   "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "timings_s": m.timings}
            print(f"  staged {json.dumps(row)}", flush=True)
    profiled(lambda: staged_request(ms["carhynet"], pairs[0]), CARHYNET_STAGED_STAGES,
             "S2 carhynet", "staged stages")
    # D-GIMS: the Delaunay graph keeps every detected keypoint
    feats = s1.prepare_features(pairs[0][:2])
    pred = staged_request(s1, pairs[0], features=feats, delaunay=True)
    check_request(pred, feats, "delaunay")
    kept = [pred["keypoints0"].shape[1], pred["keypoints1"].shape[1]]
    info = {"delaunay_kept": kept, "detected": [feats["0"]["n"], feats["1"]["n"]],
            "matches": int((pred["matches0"][0] >= 0).sum())}
    print(f"  staged {json.dumps(info)}", flush=True)
    if kept != info["detected"] or info["matches"] <= 0:
        raise AssertionError(f"delaunay request: {info}")
    # one carhynet request in f32, kernels against plain, on the same features
    frontend = ms["carhynet"].frontend
    feats = ms["carhynet"].prepare_features(pairs[1][:2])
    runs = {}
    for run, impl, kernel in (("kernels", "auto", True), ("plain", "flash", False)):
        m = Matching({**base, "attention_dtype": "float32", "attention_impl": impl,
                      "use_pallas_sinkhorn": kernel}, variables=variables, frontend=frontend,
                     device=DEVICE)
        a0, s0 = cuda_attention.launches, cuda_sinkhorn.launches
        runs[run] = staged_request(m, pairs[1], features=feats)
        launched = (cuda_attention.launches - a0, cuda_sinkhorn.launches - s0)
        if launched != ((NUM_LAYERS, 1) if kernel else (0, 0)):
            raise AssertionError(f"staged carhynet f32 {run} run launched {launched}")
    k, p = runs["kernels"], runs["plain"]
    diff = {key: int((k[key] != p[key]).sum()) if k[key].shape == p[key].shape else -1
            for key in ("keypoints0", "keypoints1", "matches0", "matches1")}
    dscore = max(float(np.abs(k[f"matching_scores{s}"] - p[f"matching_scores{s}"]).max(
        initial=0.0)) for s in "01")
    info = {"path": "staged carhynet", "differing": diff, "max_score_diff": dscore,
            "matches": int((k["matches0"][0] >= 0).sum()),
            "kept": [k["keypoints0"].shape[1], k["keypoints1"].shape[1]]}
    print(f"  whole path f32 {json.dumps(info)}", flush=True)
    if any(diff.values()):
        raise AssertionError(f"staged carhynet: kernel and plain outputs differ: {info}")
    if not dscore <= 1e-3:
        raise AssertionError(f"staged carhynet: matching_scores differ by {dscore} > 1e-3")
    del ms, runs
    torch.cuda.empty_cache()
    phase("11 staged image path S2 (carhynet, dense, dense_gray, delaunay; f32 kernels vs plain)",
          t0)


def fused_colour_phase(variables):
    """The fused colour sources at the JAX defaults: timed dispatches, the
    stage split, a dispatch with no host question, and one batch in f32
    through the kernels and the plain versions."""
    t0 = time.perf_counter()
    total = {}
    budgets = fused.octave_budgets(*FUSED_FRAME, COLOUR_KEYPOINTS, True)
    for source in ("carhynet", "dense"):
        m = fused.FusedMatching({**COLOUR_CONFIG, "descriptor_source": source},
                                variables=variables, total_keypoints=COLOUR_KEYPOINTS,
                                device=DEVICE)
        rc = m.resolved_config()
        if not (rc["matcher"]["use_pallas_sinkhorn"] and rc["agc"]["agc_impl"] == "band"
                and rc["compact_to"] == COLOUR_COMPACT and rc["frontend"]["upsample"]
                and rc["descriptor_in_channels"] == 3
                and rc["frontend"]["warp_size"] == 32):
            raise AssertionError(f"FusedMatching {source} on {DEVICE}: {rc}")
        batches = [fused_pairs(COLOUR_BATCH, 700 + 10 * i, colour=True)
                   for i in range(FUSED_TIMED + 1)]
        with record_labels("fused_" + source):
            total[source] = timed_dispatches(m, batches, source, min_share=None)
        profiled_dispatch(m, batches[1], COLOUR_STAGES[source], source)
        # no host question from the upload to the readout
        i0, i1 = (torch.from_numpy(x).to(DEVICE) for x in batches[-1][:2])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fused.fused_match_batch(m.model, m.car_model, m.acfg, m.fe, budgets, i0, i1,
                                          *FUSED_FRAME, m.compact_transport, m.compact_to)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        m.collect_batch(out)
        print(f"  fused {source}: one dispatch under set_sync_debug_mode(\"error\")", flush=True)
        imgs0, imgs1, _ = fused_pairs(COLOUR_BATCH, 990, colour=True)
        imgs = torch.from_numpy(np.concatenate([imgs0, imgs1])).to(DEVICE)
        fe = dataclasses.replace(m.fe, dense_dtype="float32")
        with torch.no_grad():  # (m's dispatches are not used after this)
            kp, sc, va, de = fused._extract_side(imgs, budgets, fe, m.car_model.float())
        matcher_vs_plain(m, kp, sc, va, de, COLOUR_BATCH, FUSED_FRAME, COLOUR_COMPACT,
                         "fused " + source)
        del m, kp, sc, va, de, imgs, i0, i1, out
        torch.cuda.empty_cache()
    phase("12 fused colour sources (carhynet, dense; 4 pairs per dispatch, 12288 keypoints)",
          t0, launches=json.dumps(total))
    return total


class FusedAsMatching:
    """The reference's data-dict contract over FusedMatching, as
    scripts/quality_eval.py wraps it: one pair per call, dense_gray pairs
    converted to gray on the host. Keeps the host seconds of its calls
    (each ends in the readout)."""

    def __init__(self, m, gray):
        self.m, self.gray, self.seconds = m, gray, 0.0

    def __call__(self, data):
        img0, img1 = data["image0"][0], data["image1"][0]
        if self.gray and img0.ndim == 3:
            img0, img1 = bgr_to_gray(img0), bgr_to_gray(img1)
        t = time.perf_counter()
        pred = self.m(img0, img1)
        self.seconds += time.perf_counter() - t
        return pred


def skip_share(out_dir):
    with open(os.path.join(out_dir, "result", "results.txt")) as f:
        lines = [l for l in f.read().splitlines() if l.strip()]
    return sum(1 for l in lines if l.endswith("=> 0")) / max(len(lines), 1), len(lines)


def record_gt_scores(out_dir, txt):
    """Precision and recall (percent) of a run's saved matches against the
    ground truth as the JAX package computed it on the TPU for its records.

    There, ``warp_keypoints``' f32 product (gims_tpu/train/gt.py:24) ran at
    XLA's DEFAULT precision, which rounds both operands, the keypoints and
    H, to bf16 (the JAX package notes that truncation in
    gims_tpu/frontend/blurmat.py:3-6): a coordinate between 512 and 1024
    moves by up to 2 px, against a 3 px match radius. Here the keypoints
    are projected that way (bf16 operands, f32 products and sums) and the
    rest is the port's own ground-truth matching and metric."""
    dev = torch.device(DEVICE)
    eye = torch.eye(3, device=dev)
    prec, rec = [], []
    with open(txt) as f:
        lines = [l.split() for l in f if l.strip()]
    for parts in lines:
        stem = os.path.splitext(parts[0])[0]
        if float(np.load(os.path.join(out_dir, f"{stem}_evaluation.npz"))["precision"]) < 0:
            continue  # skipped
        art = np.load(os.path.join(out_dir, f"{stem}_matches.npz"))
        H = torch.tensor(np.array(parts[1:], np.float64).reshape(3, 3).astype(np.float32),
                         device=dev)
        k0 = torch.from_numpy(art["keypoints0"]).to(dev)
        k1 = torch.from_numpy(art["keypoints1"]).to(dev)
        src = torch.cat([k0, torch.ones_like(k0[:, :1])], 1)
        dst = src.bfloat16().float() @ H.bfloat16().float().T
        proj = dst[:, :2] / dst[:, 2:3]
        m0, _ = gt.find_matches(proj, k1, eye, torch.ones_like(k0[:, 0], dtype=torch.bool),
                                torch.ones_like(k1[:, 0], dtype=torch.bool), 3.0, 3)
        m0 = m0.cpu().numpy()
        ma_0 = np.nonzero(m0 >= 0)[0]
        ma_1 = m0[ma_0]
        matches = art["matches"]
        gt_vec = np.full(len(matches), -1, np.int32)
        gt_vec[ma_0] = ma_1
        p, r = eval_metrics.match_precision_recall(matches, gt_vec, matches > -1, ma_0, ma_1)
        prec.append(p)
        rec.append(r)
    return 100.0 * float(np.mean(prec)), 100.0 * float(np.mean(rec))


def eval_phase(sift_variables, e2e_variables, e2e_car):
    """The homography benchmark of the JAX package's quality records on the
    card: 199 generated pairs, both fused configurations through
    eval.homography.run_benchmark (ground-truth matching and RANSAC on the
    card), each held to its record; then the CLI with staged Matching on 8
    of the pairs."""
    t0 = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory(prefix="gims_eval_") as tmp:
        t = time.perf_counter()
        txt, images = homography.generate_benchmark(os.path.join(tmp, "set"), n_pairs=EVAL_PAIRS,
                                                    height=EVAL_RESIZE[1], width=EVAL_RESIZE[0],
                                                    seed=EVAL_SEED)
        gen_s = time.perf_counter() - t
        print(f"  eval generated {EVAL_PAIRS} pairs in {gen_s:.3f}s", flush=True)
        launches = {}
        for name, (config, total) in EVAL_CONFIGS.items():
            with open(os.path.join(REPO, "docs", "quality_records", EVAL_RECORDS[name])) as f:
                record = json.load(f)
            rec = record["rows"]["synthetic"]
            args = record["args"]
            if not (args["pairs"] == EVAL_PAIRS and args["max_keypoints"] == total
                    and args["compact_to"] == config["compact_to"]
                    and bool(args["upsample"]) == config["upsample"]
                    and record["skip"]["synthetic"] == 0.0):
                raise AssertionError(f"eval {name}: the record's settings {args} differ")
            variables = e2e_variables if name == "dense_gray" else sift_variables
            m = fused.FusedMatching({**EVAL_COMMON, **config}, variables=variables,
                                    car_variables=e2e_car if name == "dense_gray" else None,
                                    total_keypoints=total, device=DEVICE)
            rc = m.resolved_config()
            want = {k: v for k, v in record["resolved_config"]["agc"].items()
                    if k in ("agc_impl", "band_halfwidth", "threshold_impl", "threshold_stride",
                             "reconnect_impl", "reconnect_buckets", "cc_impl", "cc_rounds")}
            got = {k: rc["agc"][k] for k in want}
            if got != want or rc["frontend"]["topk_impl"] != "approx" \
                    or rc["compact_to"] != config["compact_to"]:
                raise AssertionError(f"eval {name}: FusedMatching {rc} against the record's "
                                     f"{record['resolved_config']}")
            matcher = FusedAsMatching(m, gray=name == "dense_gray")
            out = os.path.join(tmp, name)
            warm0, warm1, _ = fused_pairs(1, 990, colour=True)
            matcher({"image0": warm0, "image1": warm1})  # warm-up
            matcher.seconds = 0.0
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            with record_labels("eval_" + name):
                res = homography.run_benchmark(txt, images, out, resize=EVAL_RESIZE,
                                               agc=EVAL_AGC, matcher=matcher, device=DEVICE)
            elapsed = time.perf_counter() - t
            launches[name] = counts()
            skipped, n_lines = skip_share(out)
            per_pair = {k: v / EVAL_PAIRS for k, v in launches[name].items()}
            row = {"config": name, "pairs": n_lines,
                   "ransac_auc": res["ransac_auc"], "dlt_auc": res["dlt_auc"],
                   "precision": res["precision"], "recall": res["recall"],
                   "skip_share": skipped, "ms_per_pair": 1e3 * elapsed / EVAL_PAIRS,
                   "matcher_ms_per_pair": 1e3 * matcher.seconds / EVAL_PAIRS,
                   "launches_per_pair": per_pair,
                   "record": {"file": "docs/quality_records/" + EVAL_RECORDS[name],
                              "ransac_auc": rec["ransac_auc"], "dlt_auc": rec["dlt_auc"],
                              "precision": rec["precision"], "recall": rec["recall"],
                              "skip_share": record["skip"]["synthetic"]}}
            # precision and recall as the record measured them (TPU ground
            # truth), beside the port's own above
            row["precision_record_gt"], row["recall_record_gt"] = record_gt_scores(out, txt)
            ours = [*res["ransac_auc"], row["precision_record_gt"], row["recall_record_gt"]]
            theirs = [*rec["ransac_auc"], rec["precision"], rec["recall"]]
            row["difference_to_record"] = [a - b for a, b in zip(ours, theirs)]
            print(f"  eval {json.dumps(row)}", flush=True)
            rows[name] = row
            if n_lines != EVAL_PAIRS or skipped:
                raise AssertionError(f"eval {name}: {n_lines} pairs evaluated, skip share "
                                     f"{skipped}")
            if per_pair != {"attention": NUM_LAYERS, "sinkhorn": 1, "label_rounds": 1}:
                raise AssertionError(f"eval {name}: launches per pair {per_pair}")
            if not all(abs(d) <= EVAL_BOUND for d in row["difference_to_record"]):
                raise AssertionError(f"eval {name}: RANSAC AUC@5/10/25, precision, recall "
                                     f"(the record's ground truth) {ours} more than "
                                     f"{EVAL_BOUND} points from the record's {theirs}")
            del m, matcher
            torch.cuda.empty_cache()
        # the CLI with staged Matching (no JAX record: printed with no bound)
        t = time.perf_counter()
        res = eval_homography_cli.main([
            "--input_homography", txt, "--input_dir", images, "--output_dir",
            os.path.join(tmp, "cli"), "--name", "staged", "--max_length",
            str(EVAL_STAGED_PAIRS), "--weights_path", WEIGHTS, "--descriptor_source", "sift",
            "--detector", "device", "--sift_descriptor", "device", "--fast",
            "--max_keypoints", "6144", "--device", DEVICE])
        cli_s = time.perf_counter() - t
        out = os.path.join(tmp, "cli_staged")
        npz = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
        skipped, n_lines = skip_share(out)
        row = {"config": "cli staged sift", "pairs": n_lines, "seconds": cli_s,
               "ransac_auc": res and res["ransac_auc"], "dlt_auc": res and res["dlt_auc"],
               "precision": res and res["precision"], "recall": res and res["recall"],
               "skip_share": skipped, "npz_files": len(npz)}
        print(f"  eval {json.dumps(row)}", flush=True)
        if n_lines != EVAL_STAGED_PAIRS or skipped or len(npz) != 2 * EVAL_STAGED_PAIRS:
            raise AssertionError(f"eval CLI: {row}")
    phase("15 evaluation (199 generated pairs, fused dense_gray and devsift against the JAX "
          "records; the CLI with staged Matching on 8)", t0, launches=json.dumps(launches))
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
    phase("13 label-rounds kernel vs plain", t0)
    return rows


def kernel_rows(attn, sk, lab, path_launches):
    """The `kernels` line: K1, K2 and the label-rounds kernel at each path's
    shapes, with that path's main-run launch counts (the fused colour paths
    share devsift's K1 and K2 shapes: 4 pairs compacted to 6144)."""
    no_library = ("none: no single PyTorch call computes the Sinkhorn "
                  "iterations' potentials")
    rows = []
    for suffix, attn_case, sk_case, label_path in (
            ("", ATTN_CASES[1], SINKHORN_CASES[1], "matching"),
            ("_fused_path", ATTN_CASES[3], SINKHORN_CASES[3], "fused_B"),
            ("_devsift_path", ATTN_CASES[4], SINKHORN_CASES[4], "devsift"),
            ("_staged_image_path", ATTN_CASES[5], SINKHORN_CASES[5], "staged"),
            ("_fused_carhynet_path", ATTN_CASES[4], SINKHORN_CASES[4], "fused_carhynet"),
            ("_fused_dense_path", ATTN_CASES[4], SINKHORN_CASES[4], "fused_dense"),
            # the evaluation: one pair per dispatch at 6144 keypoints
            ("_eval_dense_gray_path", ATTN_CASES[5], SINKHORN_CASES[5], "eval_dense_gray"),
            ("_eval_devsift_path", ATTN_CASES[5], SINKHORN_CASES[5], "eval_devsift")):
        b, n, m, _ = attn_case
        a, s = attn[(b, n, m, "bfloat16")], sk[(sk_case[0], len(sk_case[1]))]
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
    torch.cuda.empty_cache()
    staged_launches, s1 = staged_phase(load_gims_checkpoint(WEIGHTS))
    staged_sources_phase(s1, load_gims_checkpoint(WEIGHTS), load_gims_checkpoint(E2E_WEIGHTS),
                         load_car_checkpoint(E2E_CAR_WEIGHTS))
    del s1
    torch.cuda.empty_cache()
    colour_launches = fused_colour_phase(load_gims_checkpoint(WEIGHTS))
    torch.cuda.empty_cache()
    # the evaluation runs before the label-rounds phase, which holds the
    # kernel to its plain version on the graphs of every path, its own too
    eval_launches = eval_phase(load_gims_checkpoint(WEIGHTS), load_gims_checkpoint(E2E_WEIGHTS),
                               load_car_checkpoint(E2E_CAR_WEIGHTS))
    lab = label_phase()

    t0 = time.perf_counter()
    rows = kernel_rows(attn, sk, lab, {"": launches, "_fused_path": fused_launches,
                                       "_devsift_path": devsift_launches,
                                       "_staged_image_path": staged_launches,
                                       "_fused_carhynet_path": colour_launches["carhynet"],
                                       "_fused_dense_path": colour_launches["dense"],
                                       "_eval_dense_gray_path": eval_launches["dense_gray"],
                                       "_eval_devsift_path": eval_launches["devsift"]})
    print(json.dumps({"kernels": rows}), flush=True)
    phase("14 kernels", t0, total_seconds=f"{time.perf_counter() - _T0:.1f}",
          card=json.dumps(smi))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
