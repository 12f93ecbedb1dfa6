#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GIMS on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each with its seconds:
  0 device: versions, the card's name and power limit; TF32 off.
  1 build: the CUDA kernels under gims_tpu_torch/csrc/, one nvcc process
    per source, all at once; ptxas' registers, shared memory and spills per
    kernel; the count of wgmma (HGMMA) instructions in the attention
    kernels' SASS, which must not be 0 for any bf16 kernel, and of mma.sync
    (HMMA) instructions, which must not be 0 for any f32 kernel (its split
    TF32 products); a spill in a wide-head kernel fails the run.
  2 the attention kernel against its plain PyTorch versions on the card,
    at the paths' trunk shapes among others (head width 64), at a head
    width of 256 (a 512-d trunk of 2 heads; the column-block kernels'
    widest) and past 256 (the wide-head kernels: 320 at 2048 and 8192, a
    head of 512 at 4096), timed beside its bound (in f32 the arithmetic it
    executes: three TF32 products at the TF32 peak, with the f32 CUDA-core
    bound beside it) and SDPA; the phase line carries the wide rows' ratio
    to SDPA.
  3 the Sinkhorn kernels against their plain PyTorch version on the card:
    the fused kernel at Z of 2049, 8193, (8, 3073), (4, 6145), 6145 and
    3073 square, the streaming kernel at 24577 (the widest bucket) and at
    16385 x 100 iterations (phase 22's unsharded reference).
  4 the slice: gims_tpu_torch.api.Matching with the staged checkpoint
    (weights/gims_tpu_sift_last.npz, 18 GNN layers, 256-d) serves four
    synthetic keypoint requests in an 800x600 frame (buckets 2048 and
    8192); the kernels' launch counters must rise on this path.
  5 one 2048 request in f32 through the kernels and through the plain
    versions: kept equal, matches and scores agree.
  25 the wide-head path (run after phase 5): Matching with a 640-d trunk
    of 2 heads (head width 320, random weights) serves one 2048 request in
    bf16 and in f32, 18 wide-head K1 launches each; f32 scores within 1e-3
    of the plain versions'. Then K1 past one cluster of 16 CTAs a head
    (WIDEST_ATTN_CASES: B=2, N=M=2048, H=1, D=12288 bf16 and 8192 f32, a
    head over several clusters) against the plain versions at phase 2's
    bars, timed beside its bound, the plain version and SDPA; two more
    calls must give the same bits.
  26 estimate_pose and the structured style (run after phase 25):
    geometry.estimate_pose on the card (eval/essential.py) on
    POSE_SCENES scenes of tests/test_utils_extra.py at POSE_POINTS points,
    POSE_OUTLIERS of the second view uniform noise: ms a call and of its
    find_essential_mat, the host's waits for the card in a call (reads of
    device values: 3 numbers a RANSAC chunk, the results), R and t
    errors (median within 1 and 2 degrees), inlier shares (over 0.9 of the
    true correspondences, under 0.1 of the noise); then STRUCTURED_PAIRS
    800x600 pairs of generate_benchmark(style="structured") evaluated by
    run_benchmark with staged Matching at the JAX defaults (host SIFT):
    AUC, ms per image made and per pair, launches as phase 15's staged row.
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
    1024, approximate top-k), ground-truth matching and RANSAC on the card;
    (c) staged Matching with OpenCV's SIFT detector and descriptors as the
    port computes them (frontend/sift.py, on the card) at the staged host
    record's args: the staged checkpoint, 2048 keypoints, 20 iterations,
    threshold 0.02, bf16 trunk and the Sinkhorn kernel. One line each: RANSAC and DLT AUC@5/10/25, precision, recall, skip
    share, ms per pair (host clock, reading and warping included), launches
    per pair and the record's numbers; it fails if a pair is skipped, if a
    pair does not take 18 attention, 1 Sinkhorn and 1 label-rounds launch
    (staged: 36 and 2 where the sides fall in two buckets and run apart),
    or if RANSAC AUC@5/10/25, precision or recall lies more than 3.0 points
    from its record, precision and recall scored as the records scored them
    (record_gt_scores: the TPU's bf16-rounded ground truth; the port's exact
    ones are printed beside). Then eval_homography_cli on 8 of the pairs with staged
    Matching (the staged checkpoint, SIFT descriptors from the device
    detector, --fast, 6144 keypoints): its artifacts, no pair skipped, its
    numbers printed with no bound (no JAX record exists for it).
  16 training (run after phase 15, before 13): the port's fused
    end-to-end trainer, gims_tpu_torch.train.loop.train, at the full widths
    of configs/e2e_fo0_800.yaml (800x600, 6144 keypoints, no upsample, the
    18-layer 256-d GMatcher with bf16 direct attention under
    torch.utils.checkpoint, 20 Sinkhorn iterations, threshold 0.02, AGC
    15/2/7, dustbin negatives, InfoNCE weight 1), warm-started from the
    joint e2e weights. Only the loop is cut (printed): 3 synthetic pairs per
    epoch, 2 epochs, the first with the matcher frozen, 2 validation pairs,
    a temporary output directory. It fails unless every loss is finite, the
    matcher's parameters stay fixed in the frozen steps while the CNN's
    move and both move afterwards, each train step launches the label
    rounds and the centroid sums twice, the loss sums once and neither K1
    nor K2, each validation pair launches K1 18 times, K2, the label rounds
    and the centroid sums once, the first step's two AGC graphs
    (adjacency and kept) are equal with the label kernel and with its plain
    version, the exported EMA npz loaded into a fresh FusedMatching matches
    a pair as the in-memory EMA model does, and a resume from `last`
    continues the optimizer's step count. Prints ms per frozen and per
    joint step, peak memory, validation ms per pair, the launches, and the
    stage split of one more joint step in a torch.profiler trace.
  17 host SIFT (run after phase 16): OpenCV's SIFT as the port computes it
    (frontend/sift.py) on two synthetic 800x600 colour pairs, on the card
    and on the CPU: each side's keypoints within the tolerances of
    tests/test_torch_sift.py in the other (98%), the CPU's strongest 2048
    described on both devices (99% of the bytes within one level, cosine
    >= 0.99); ms per image of detection and of description, keypoints per
    image, and the stage split and idle share of one profiled image. Then
    staged Matching with host SIFT detection and descriptors (the staged
    checkpoint, 2048 keypoints, 20 iterations, threshold 0.02, bf16, the
    Sinkhorn kernel) on 8 gray pairs: 18 attention, 1 Sinkhorn and 1
    label-rounds launch a request, a correct share >= 0.5, ms per pair; and
    Matching() at the JAX defaults (carhynet descriptors at host SIFT
    keypoints, every keypoint kept, a random colour CAR-HyNet) on 2 colour
    pairs: structure and launches, no correct-share bound.
  18 training (run after phase 17): the classic trainer,
    train.loop.train without fused_e2e, at configs/synth_sift.yaml's widths
    (640x480, 2048 keypoints, batch 1, the f32 18-layer matcher, 100
    Sinkhorn iterations) with host SIFT descriptors: 2 epochs of 3 synthetic
    pairs, 2 validation pairs, then a resume from `last`. It fails unless
    every loss is finite, last.pt, minloss.pt and the EMA npz are written,
    each step launches the label rounds twice and neither K1 nor K2,
    validation launches as staged Matching does, and the resume continues
    the step count. Prints ms per step, the host SIFT batch times, peak
    memory. Then 5 steps of CAR-HyNet's trainer
    (carhynet.train.train_descriptor) on synthetic patch pairs at 256
    points: the losses finite.
  19 data-parallel serving (run after phase 18): FusedMatching(devices=
    [cuda:0, cuda:0]) at configuration B of phase 6 (full widths, 8 pairs,
    the same weights): in f32 through the kernels (f32 trunk and CNN) the
    kept keypoints and matches of every pair identical to devices=None;
    then the card's defaults (bf16) timed in turns unsplit, split, split,
    unsplit: pairs/s beside the unsplit run, 2 x (18 K1, 1 K2, 1 label
    rounds) launches a split dispatch. devices=2 runs where the machine has
    two cards; here it prints a line saying it did not run.
  20 data-parallel training: two ranks, each a process started with the
    spawn method (gims_tpu_torch/train/dp_check.py), share the card over
    gloo and take one step each of the fused end-to-end trainer at
    configs/e2e_fo0_800.yaml's widths from the joint e2e weights and of the
    classic trainer at configs/synth_sift.yaml's with host SIFT batches, one
    pair a rank (no warmup, no freezing). It fails unless both ranks end
    with bit-equal parameters and metrics, the averaged loss is the mean of
    the per-pair losses of undistributed steps within DP_LOSS_RTOL, a step
    over a one-rank NCCL group is bit-equal to the undistributed step,
    each rank launches the label rounds twice a step, and the step moved the
    trained subtrees. Prints ms per step, and the all-reduce's ms and bytes
    (the gradients: about 54 MB for the joint model).
  21 ring attention: K1's partial mode (the output and each row's base-2
    max and sum) against its plain version at bf16 (2, 6144) and f32 (2,
    2048), D=64, and at their ring steps' shapes: the output bit-equal to
    the default mode, the statistics within PARTIAL_M_TOL and
    PARTIAL_L_RTOL; timed beside the default mode, the plain version and
    SDPA. Then masked_attention_ring at P=2 over two gloo ranks on the card
    (f32 within RING_F32_TOL of dense K1, bf16 within RING_BF16_REL_RMS of
    dense K1 and of the direct version by relative RMS) and at P=1 over
    NCCL (bit-equal to dense K1), 2 and 1 partial launches a rank.
  22 keypoint-axis sharding (run after phase 21, before 13):
    forward_match with every O(N^2) tensor split over ranks
    (gims_tpu_torch/matcher/sharded.py; workers in train/shard_check.py),
    sift_last.npz at its widths on one synthetic pair, AGC 15/2/7 (dense,
    exact threshold and reconnect). At bucket 4096 (3700 keypoints a side)
    in f32 and at 16384 (15000, the reference's limit) in bf16: first the
    unsharded port (K1, K2, the label kernel; 18/1/1 launches), then
    make_forward_match_sharded over two gloo ranks sharing the card, and at
    16384 over a one-rank NCCL group. It fails unless the ranks end
    bit-equal, kept equals the unsharded run's, matches0 agree on
    SHARD_AGREE of the rows (f32 scores within SHARD_SCORE_TOL), each rank
    launches K1's partial mode 18 x P times a call (and nothing else on
    the path), and at 16384 each P=2 rank's peak memory in the call (above
    what it held before) is at most SHARD_MEMORY_SHARE of the unsharded
    run's. Prints ms per call of each run, peaks and their shares; then
    K1's partial mode at the ring steps' shapes (P=2: f32 (2, 2048), bf16
    (2, 8192); P=1: bf16 (2, 16384)). The other configurations
    (SHARD_CONFIGS: the band build at the card's defaults, the sparse
    labels, the trunk compacted to half the bucket) run at 4096 over the
    same two gloo ranks and at 16384 on the one-rank NCCL group, each
    against its own unsharded run, the band run against the unsharded band
    build with cc_impl "dense" and with "band" (the sharded band build
    takes no cc_impl): the same bars, the P=2 peak share at 4096 too, and
    the AGC's adjacency rows and kept equal to the unsharded build's. One
    "shard_config" line each, the unsharded band_cc's beside them.
  23 the entry points (run after phase 22, before 13), on JPEG files of a
    synthetic 800x600 colour pair with a known homography: (a) the port's
    encode_jpeg writes them and decode_jpeg reads them on the card and on
    the CPU, bit-equal (ms to encode and decode one image); (b)
    cli.match_pair_cli.main in-process with --npz and --out, staged
    (--descriptor_source sift, the staged checkpoint) and --fused --fast
    dense_gray (the joint e2e matcher, the CNN seeded as the JAX CLI leaves
    it): keypoints equal to a direct Matching / FusedMatching call of the
    same configuration on the decoded images and matches on ENTRY_AGREE
    (1.0) of the rows, the launches
    equal to that call's, a staged correct share >= 0.5, the PNG written
    equal to draw_matches of the prediction; (c) the staged checkpoint
    rewritten as the reference's torch state_dict, saved as {"ema": sd},
    {"model": sd} with "module." prefixes and bare, each through
    --weights_path x.pt: keypoints equal and matches (at least one) as
    staged above to Matching on convert_gmatcher_torch(sd); (d) cli.serve_cli.make_server
    on a free port in a thread, staged then --fused: three POSTs (the pair,
    a 640x480 pair resized to 800x600, and that pair with
    resize_enabled=0) answered 200 with a PNG whose X-Match-Details
    (keypoint counts equal, the match count within ENTRY_COUNT_SLACK) and
    drawing (byte-equal where the counts are) agree with find_matches
    in-process on the same bytes, a wrong path 404 and a garbage upload 500
    before them; ms per request beside the card's name and power limit, and
    where an in-process request's time goes. Launches of each path are
    counted.
  24 the tools and the deterministic sums (run after phase 23, before 13),
    on phase 23's entry pair: tools.parameter_search over TOOLS_PARAMS with
    the staged Matching (the staged checkpoint, host SIFT detection and
    descriptors, 20 iterations):
    one record row per setting, K1, K2, the label rounds and the centroid
    sums launched on every row (the SIFT sums printed), ms per row; the
    port's USAC (eval/usac.py) on the card and on the CPU on the first
    row's matches: equal counts;
    the native library built with g++ and a KNN case against numpy; the
    headless image viewer (the grid equals compose_grid) and the static and
    interactive reports of the sweep's records.
  13 the label-rounds kernel against its plain version on the graphs the
    paths above gave it (recorded during phases 4, 6, 9, 10, 12, 15-20, 22,
    23, 24):
    labels equal, and the rounds each graph ran equal to rounds_plain's;
    per path the route plan() took (cluster size, shared bytes per block),
    the share of blocks that listed their rows' neighbours (as the kernel
    reports it), the graphs' mean and largest degree, its time at the cap
    and at cap 0 (one round; the difference over the rounds past the first
    gives the cost of a round), the share of its bound, and, labelled as a
    model, the bytes one launch moves in the kernel's design.
  Every path's launches include the segmented-sum kernel's
    (csrc/segsum.cu) by caller: each AGC build launches the centroid sums
    once, each training step the loss sums once (both checked wherever the
    label rounds are), each image described by SIFT on the card the
    histograms at least once (checked in phase 17).
  14 one JSON line with every kernel's launches, error and times, on the
    nineteen paths' shapes (phase 25's wide heads, phase 22's unsharded
    reference at 16384 and
    phase 23's four entry-point paths and phase 24's parameter sweep among
    them), the label rounds of phase 20's steps, K1's partial mode at
    the step shapes of phase 21's and phase 22's rings, and the
    segmented-sum kernel at its three callers' rows, AGC's on the staged
    host and the fused paths (each call one launch and no sort, checked by
    the wrapper's count and the aten ops it ran); the script's total
    seconds.
  Then the last line: {"ok": true, "device": {...}}.

Any mismatch raises and the process exits non-zero. Without CUDA it
exits non-zero at once: there is no CPU fallback. It imports torch, numpy,
the standard library and gims_tpu_torch only, and writes nothing outside
gims_tpu_torch/_build/ but phase 15's pairs and artifacts, phases 16's
and 18's checkpoints, the spec and results of phases 20's, 21's and 22's
ranks and phase 23's images, checkpoints and outputs, in temporary
directories that it removes, and the native library into
gims_tpu_torch/_build/. Phases 20-22 start their ranks as processes
and wait for them to end; phase 23's server listens on 127.0.0.1 only and
is shut down before the phase ends.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from gims_tpu_torch import _build, fused  # noqa: E402
from gims_tpu_torch.agc import graph, labels  # noqa: E402
from gims_tpu_torch.api import Matching, init_gmatcher_variables  # noqa: E402
from gims_tpu_torch.carhynet.convert import load_car_checkpoint  # noqa: E402
from gims_tpu_torch.cli import eval_homography_cli  # noqa: E402
from gims_tpu_torch.config import (AGCConfig, FrontendConfig, GIMSConfig, MatcherConfig,  # noqa: E402
                                   load_config)
from gims_tpu_torch.core import checkpoint as ckpt_io  # noqa: E402
from gims_tpu_torch.core import segsum  # noqa: E402
from gims_tpu_torch.core.imgproc import bgr_to_gray  # noqa: E402
from gims_tpu_torch.eval import essential, geometry, homography  # noqa: E402
from gims_tpu_torch.eval import metrics as eval_metrics  # noqa: E402
from gims_tpu_torch.carhynet import train as car_train  # noqa: E402
from gims_tpu_torch.frontend import sift  # noqa: E402
from gims_tpu_torch.frontend.feature import FeatureFrontend  # noqa: E402
from gims_tpu_torch.matcher import attention, cuda_attention, cuda_sinkhorn, pipeline, sinkhorn  # noqa: E402
from gims_tpu_torch.matcher.convert import load_gims_checkpoint, load_variables  # noqa: E402
from gims_tpu_torch.matcher.sharded import make_forward_match_sharded  # noqa: E402
from gims_tpu_torch.matcher.gmatcher import GMatcher  # noqa: E402
from gims_tpu_torch.synthetic import correct_share, synthetic_image_pair, synthetic_request  # noqa: E402
from gims_tpu_torch.train import data as train_data  # noqa: E402
from gims_tpu_torch.train import (dp_check, fused_step, gt, multihost,  # noqa: E402
                                  shard_check)
from gims_tpu_torch.train import loop as train_loop  # noqa: E402
from gims_tpu_torch.train import step as train_step  # noqa: E402

WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")
E2E_WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_dense_gray_e2e.npz")
E2E_CAR_WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_dense_gray_e2e_car.npz")
# one NVIDIA H100 SXM, from its data sheet: HBM bytes/s, peak FLOP/s, and
# the exponentials its MUFU units take per second (16 per clock per SM, 132
# SMs, 1.98 GHz boost clock)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# the TF32 tensor-core peak (dense), at which K1's f32 path runs its three
# split products
PEAK_TF32 = 495e12
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
              (16, 3072, 3072, 400), (8, 6144, 6144, 700), (2, 6144, 6144, 900),
              (2, 3072, 3072, 300),
              # a split of the fused path's batch of 8 in two (phase 19): B=8, 3072
              (8, 3072, 3072, 400),
              # the unsharded reference of phase 22: one pair at bucket 16384
              (2, 16384, 16384, 1400))
# the trainer's validation (one pair of 6144 keypoints compacted to 3072,
# sides stacked) is ATTN_CASES[6]. A head of 256 columns (a 512-d
# trunk of 2 heads) at the staged image path's bucket: the kernel's widest
WIDE_ATTN_CASE = (2, 6144, 6144, 900)
WIDE_HEAD_DIM = 256
# the wide-head kernels (heads past 256), each row ((B, N, M, masked key
# tail), H, D): a 640-d trunk of 2 heads at 2048 and at 8192 (the Matching
# path's bucket), a 512-d trunk of one head at 4096
WIDER_ATTN_CASES = (((2, 2048, 2048, 248), 2, 320), ((2, 8192, 8192, 1192), 2, 320),
                    ((2, 4096, 4096, 600), 1, 512))
# phase 25: K1 past one cluster of 16 CTAs a head (8192 columns in bf16,
# 5120 in f32), where a head spans several clusters: ((B, N, M, masked key
# tail), H, D, dtype), against the plain versions, two calls bit-equal
WIDEST_ATTN_CASES = (((2, 2048, 2048, 248), 1, 12288, torch.bfloat16),
                     ((2, 2048, 2048, 248), 1, 8192, torch.float32))
# phase 26: estimate_pose on the JAX test's scene (tests/test_utils_extra.py)
# at POSE_POINTS points, a share POSE_OUTLIERS of the second view's replaced
# by uniform pixels, POSE_SCENES scenes; its bars on the median of the
# scenes' pose errors (one scene can miss them at 30% outliers in OpenCV
# too), the inlier shares on every scene. Then STRUCTURED_PAIRS pairs of the
# structured style at 800x600 matched by staged Matching (the JAX defaults)
POSE_POINTS = 2000
POSE_OUTLIERS = 0.3
POSE_SCENES = 3
POSE_K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
POSE_BARS = (1.0, 2.0, 0.9, 0.1)  # degrees of R and t, true inlier share, noise inlier share
STRUCTURED_PAIRS = 2
STRUCTURED_SEED = 26
# the wide-head kernels' instantiations (csrc/attention.cu): bf16 <blocks of
# 64 a warpgroup, keys per tile>, f32 one
WIDE_KERNELS_BF16 = ("attn_wide_tc_kernel<3,48>", "attn_wide_tc_kernel<4,32>")
WIDE_KERNELS_F32 = ("attn_wide_f32_kernel",)
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
                  (6144, [6144], [6100], FUSED_ITERS),
                  (3072, [2900], [2950], FUSED_ITERS),
                  # staged Matching with host SIFT at 2048 keypoints (phases 15, 17)
                  (2048, [1800], [1750], FUSED_ITERS),
                  # a split of the fused path's batch of 8 in two (phase 19)
                  (3072, [2900, 3072, 2500, 3000], [2950, 3000, 2600, 3072], FUSED_ITERS),
                  # the unsharded reference of phase 22 at bucket 16384 (the
                  # streaming kernel)
                  (16384, [15000], [15000], SINKHORN_ITERS))
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
    "devsift": "fused_devsift_gims_tpu_sift_last_r15p2m7_n199.json",
    "staged_host": "staged_sift_gims_tpu_sift_last_r15p2m7_n199.json"}
# the third row: staged Matching with OpenCV's SIFT detector and descriptors
# (the port's, on the card) at the record's args (scripts/quality_eval.py
# without --fused: the staged checkpoint, 2048 keypoints, 20 iterations,
# threshold 0.02; bf16 trunk and the Sinkhorn kernel, Matching's defaults
# on the card as on the TPU, passed explicitly)
EVAL_STAGED_HOST = {"sinkhorn_iterations": FUSED_ITERS, "match_threshold": 0.02,
                    "max_keypoints": 2048, "descriptor_source": "sift", "detector": "host",
                    "sift_descriptor": "host", "attention_dtype": "bfloat16",
                    "use_pallas_sinkhorn": True}
EVAL_CONFIGS = {  # scripts/quality_eval.py --fused with each record's args
    "dense_gray": ({"descriptor_source": "dense_gray", "upsample": False, "compact_to": None},
                   6144),
    "devsift": ({"descriptor_source": "devsift", "upsample": True, "compact_to": 6144}, 12288)}
EVAL_COMMON = {"sinkhorn_iterations": FUSED_ITERS, "match_threshold": 0.02,
               "attention_dtype": "bfloat16", "use_pallas_sinkhorn": True, "fast_frontend": True,
               "sift_samples": 16, "threshold_stride": 4, "dense_first_map_oct": 0, **EVAL_AGC}
# the trainer (phase 16): the port's train.loop.train at the full widths of
# configs/e2e_fo0_800.yaml (800x600, 6144 keypoints, no upsample, 18-layer
# 256-d GMatcher with bf16 direct attention and remat, 20 Sinkhorn
# iterations, threshold 0.02, AGC 15/2/7, dustbin negatives, InfoNCE weight
# 1), warm-started from the joint e2e weights; only the loop is cut
TRAIN_CONFIG = os.path.join(REPO, "configs", "e2e_fo0_800.yaml")
TRAIN_CUTS = {"limit": 3, "num_epochs": 2, "freeze_gmatcher_epochs": 1, "val_images_count": 2}
TRAIN_WIDTHS = {"dim": 256, "layers": 18, "heads": 4, "attention_dtype": "bfloat16",
                "attention_impl": "direct", "remat": True, "sinkhorn_iterations": 20,
                "threshold": 0.02, "neg_cells": "dustbin", "use_pallas_sinkhorn": False,
                "source": "dense_gray", "upsample": False, "keypoints": 6144,
                "frame": [600, 800], "agc": [15.0, 2.0, 7], "desc_loss_weight": 1.0,
                "batch_size": 1}
# host SIFT (phase 17): OpenCV's SIFT as the port computes it, on two
# synthetic 800x600 colour pairs, on the card and on the CPU; the CPU run is
# the reference the card is held to, with the tolerances of
# tests/test_torch_sift.py against OpenCV: 98% of each side's keypoints
# within 1e-3 px (same octave and layer, size and response 1e-4 relative,
# angle 0.05 degrees), 99% of the descriptor bytes within one level, every
# descriptor at cosine >= 0.99
HOST_SIFT_SEEDS = (610, 611)
HOST_SIFT_KEYPOINTS = 2048
HOST_SIFT_STAGES = ("gims.sift.pyramid", "gims.sift.extrema", "gims.sift.adjust",
                    "gims.sift.orientation", "gims.sift.sort", "gims.sift.describe")
HOST_STAGED_PAIRS = 8
HOST_STAGED_CONFIG = EVAL_STAGED_HOST
# the classic trainer (phase 18): configs/synth_sift.yaml at its widths
# (640x480, 2048 keypoints, batch 1, f32 matcher of 18 layers, 100 Sinkhorn
# iterations) with host SIFT descriptors (--descriptor_source sift, as the
# config's comment says); only the loop is cut. Then CAR-HyNet's trainer.
CLASSIC_CONFIG = os.path.join(REPO, "configs", "synth_sift.yaml")
CLASSIC_CUTS = {"limit": 3, "num_epochs": 2, "val_images_count": 2}
CLASSIC_WIDTHS = {"frame": [480, 640], "keypoints": 2048, "batch_size": 1, "layers": 18,
                  "dim": 256, "attention_dtype": "float32", "sinkhorn_iterations": 100}
DESCRIPTOR_STEPS = 5
DESCRIPTOR_POINTS = 256
# (seed, keypoints per view): two requests in bucket 2048, two in 8192
# phases 19-21: two ranks (or chunks) sharing the one card
DP_SPLIT = 2
DP_SEED = 900
# the averaged loss of the 2-rank step against the mean of the per-pair losses
# of undistributed steps: f32 summation order only (the loss's segment sums
# run on atomics)
DP_LOSS_RTOL = 1e-5
# K1's partial mode against attention_partials_tiled: the base-2 row max
# (scores summed in another order: measured 4.3e-6 at 2048, f32) and the
# row sum (relative, measured 3.4e-6)
PARTIAL_M_TOL = 1e-4
PARTIAL_L_RTOL = 1e-4
# (B, N = M, dtype) of the ring; its steps at P=2 run N / 2 against M / 2
RING_CASES = ((2, 6144, torch.bfloat16), (2, 2048, torch.float32))
# the ring against dense K1: f32 element by element (K1's own f32 bound
# against the direct version); bf16 by RMS error relative to the output's
# RMS, against dense K1 and against the direct version in f32: two
# roundings of the output (each step's partial, then the merged result),
# 2 * 2**-8
RING_F32_TOL = 1e-4
RING_BF16_REL_RMS = 2.0 ** -7
# phase 22: keypoint-axis sharding. (bucket, valid keypoints a side, trunk
# dtype): an f32 check at 4096 and the reference's limit (~15k keypoints)
# at 16384 in bf16, sift_last.npz at its widths, one synthetic pair each
SHARD_CASES = ((4096, 3700, "float32"), (16384, 15000, "bfloat16"))
SHARD_SEED = 1400
# the sharded run against the unsharded port: kept equal; matches0
# agreement (the f32 bar is JAX's own, tests/test_sharded.py; bf16 runs K1
# against the ring's merged partials, two roundings of each output); f32
# matching scores within JAX's 2e-3
SHARD_AGREE = {"float32": 0.995, "bfloat16": 0.99}
SHARD_SCORE_TOL = 2e-3
# each P=2 rank's peak device memory in a call against the unsharded run's,
# both above what their process held before the call (the same model and
# inputs; this process also holds the label inputs recorded for phase 13)
SHARD_MEMORY_SHARE = 0.6
# phase 22's other configurations, each against the unsharded port at both
# buckets (4096 over the two gloo ranks, 16384 on the one-rank NCCL group),
# their AGC adjacency rows too where they build one: the card's band
# defaults with cc_impl "dense" and "band", the dense build with the sparse
# labels, and the dense build with the trunk compacted to half the bucket
# (the unsharded runs; the sharded runs are SHARD_RUNS)
SHARD_CONFIGS = {"band": ACCEL_DEFAULTS, "band_cc": {**ACCEL_DEFAULTS, "cc_impl": "band"},
                 "sparse": {"cc_impl": "sparse"}, "compact": {}}
# the sharded band build takes no cc_impl (it labels the band whole): one
# sharded run of "band" is held to the unsharded runs of both
SHARD_RUN_OF = {"band_cc": "band"}
SHARD_RUNS = [name for name in SHARD_CONFIGS if name not in SHARD_RUN_OF]


def shard_references(name):
    """The configurations whose unsharded runs the sharded run `name` is
    held to."""
    return [name] + [n for n, run in SHARD_RUN_OF.items() if run == name]
# phase 23: the entry points on JPEG files of synthetic 800x600 colour pairs
# (and a 640x480 pair that the server resizes), match_pair_cli's flags per
# configuration and the configuration of the direct call they are held to
ENTRY_FRAME = (600, 800)
ENTRY_SMALL = (480, 640)
ENTRY_SEED = 2300
ENTRY_SHARE = 0.5
# matches0 of two runs of a path on the card agree on ENTRY_AGREE of the rows
# (every float sum into slots is made in source order, core/segsum.py), and a
# served request's match count lies within ENTRY_COUNT_SLACK of the
# in-process call's (its drawing is then compared only where the counts are
# equal). Keypoints must be equal.
ENTRY_AGREE = {"staged": 1.0, "fused": 1.0}
ENTRY_COUNT_SLACK = 0.01
ENTRY_CLI = {"staged": ["--descriptor_source", "sift", "--weights_path", WEIGHTS],
             "fused": ["--fused", "--fast", "--descriptor_source", "dense_gray",
                       "--weights_path", E2E_WEIGHTS]}
ENTRY_STAGED_CONFIG = {"sinkhorn_iterations": 20, "match_threshold": 0.02, "max_keypoints": -1,
                       "descriptor_source": "sift"}
ENTRY_FUSED_CONFIG = {"sinkhorn_iterations": 20, "match_threshold": 0.02,
                      "descriptor_source": "dense_gray", "radius": 15, "percentile": 2,
                      "min_size": 7, "attention_dtype": "bfloat16",
                      "use_pallas_sinkhorn": True, "fast_frontend": True}
# phase 24: parameter_search's (radius, percentile, min_size) rows on phase
# 23's pair, with the Matching that tools.parameter_search builds, on the
# SIFT descriptors the staged checkpoint was trained with
TOOLS_PARAMS = ([15, 2, 7], [20, 5, 3], [10, 1, 10])
TOOLS_CONFIG = {"weights_path": WEIGHTS, "sinkhorn_iterations": 20, "match_threshold": 0.02,
                "max_keypoints": -1, "descriptor_source": "sift"}
# the callers of the segmented sum (core/segsum.py), by their tags
SEGSUM_TAGS = ("sift_descriptors", "agc_centroid_sums", "train_loss_sums")
# the segmented sum's rows in the kernels line: (the caller's tag, the path
# whose run gives the row its input, recorded on the host in that path's
# untimed first call, and its launches). AGC's centroid sums twice: 4 rows
# of 2049 slots on the staged host path (the kernel's by-lane way), 16 of
# 3073 on the fused path (by group, each row's slots split over warps)
SEGSUM_ROWS = {"sift_descriptors": ("sift_descriptors", "_host_sift_staged_path"),
               "agc_centroid_sums": ("agc_centroid_sums", "_host_sift_staged_path"),
               "agc_centroid_sums_fused": ("agc_centroid_sums", "_fused_path"),
               "train_loss_sums": ("train_loss_sums", "_train_path")}
# what every matching path launches: K1, K2, and per AGC build one
# label-rounds and one centroid-sums launch
MATCH_KERNELS = ("attention", "sinkhorn", "label_rounds", "segsum_agc_centroid_sums")
REQUESTS = ((11, 1800), (12, 1850), (13, 7000), (14, 6900))
WHOLE_PATH_REQUEST = (21, 1800)
# the wide-head path: Matching with a 640-d trunk of 2 heads (head width
# 320), random weights from the seed, one request at bucket 2048 in each dtype
WIDE_PATH_REQUEST = (22, 1800)
WIDE_PATH_DIM = 640

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


def graph_ms(fn, reps=20):
    """Mean ms of one call of `fn` on the device: a CUDA graph of the call
    replayed `reps` times between CUDA events, so the host's enqueue of each
    op (tens of us, as long as a small kernel) is not counted."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops, dtype, peak=None):
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / (peak or PEAK_FLOPS[dtype])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_bound(nbytes, flops, dtype):
    """K1's bound as its kernels execute the work: bf16 products at the
    bf16 tensor-core peak; f32 at every width as three TF32 products (split
    f32, csrc/attention.cu) at the TF32 peak, printed beside the same work
    as f32 FMAs on the CUDA cores."""
    if dtype != torch.float32:
        ms, by = bound_ms(nbytes, flops, dtype)
        return {"bound_ms": ms, "bound_by": by}
    ms, by = bound_ms(nbytes, 3 * flops, dtype, peak=PEAK_TF32)
    return {"bound_ms": ms, "bound_by": by,
            "bound_executes": "3 TF32 products (split f32) at 495 TFLOP/s",
            "f32_cuda_core_bound_ms": bound_ms(nbytes, flops, dtype)[0]}


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
    m = re.search(r"(attn_tc_kernel|attn_f32_kernel|attn_wide_tc_kernel|attn_wide_f32_kernel|"
                  r"sinkhorn_fused_kernel|"
                  r"sinkhorn_stream_kernel|label_rounds_kernel|label_cluster_kernel|"
                  r"label_pack_kernel|segsum_rows_kernel)(I(?:Li\d+E)+E|I[si](?:Li\d+E)*E)?",
                  line)
    if not m:
        return None
    args = re.findall(r"Li(\d+)E", m.group(2) or "")
    if (m.group(2) or "")[:2] in ("Is", "Ii"):  # the segmented sum's slot type first
        args.insert(0, "int16" if m.group(2)[1] == "s" else "int32")
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


def tensor_core_counts(lib_path, op):
    """`op` instructions (HGMMA: wgmma; HMMA: mma.sync) per attention kernel
    in the library's SASS."""
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
        elif name and re.search(rf"\b{op}\b", line):
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
        spilled = [k for k, info in ptxas_report(_build.build_log).items()
                   if k in WIDE_KERNELS_BF16 + WIDE_KERNELS_F32
                   and (info.get("spill_stores") or info.get("spill_loads"))]
        if spilled:
            raise AssertionError(f"a wide-head attention kernel spills registers: {spilled}")
    hgmma = tensor_core_counts(lib._name, "HGMMA")
    print(f"  sass HGMMA {json.dumps(hgmma)}", flush=True)
    tc = [hgmma.get(k) for k in [f"attn_tc_kernel<{nb}>" for nb in (1, 2, 3, 4)]
          + list(WIDE_KERNELS_BF16)]
    if not all(tc):
        raise AssertionError(f"a bf16 attention kernel has no HGMMA instruction: {hgmma}")
    # the f32 kernels' split products: mma.sync on TF32 (SASS HMMA.1688.F32.TF32)
    hmma = tensor_core_counts(lib._name, "HMMA")
    print(f"  sass HMMA {json.dumps(hmma)}", flush=True)
    f32 = [hmma.get(k) for k in [f"attn_f32_kernel<{d}>" for d in (64, 128, 256)]
           + list(WIDE_KERNELS_F32)]
    if not all(f32):
        raise AssertionError(f"an f32 attention kernel has no HMMA instruction: {hmma}")
    phase("1 build", t0, nvcc_seconds=f"{_build.build_seconds}",
          library=os.path.relpath(lib._name, REPO))


def attention_case(b, n, m, masked_tail, dtype, seed, h=4, d=HEAD_DIM):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = (torch.randn((b, x, h, d), generator=g, device=DEVICE).to(dtype)
               for x in (n, m, m))
    mask = torch.ones((b, m), dtype=torch.bool, device=DEVICE)
    mask[:, m - masked_tail:] = False
    if b > 1:
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


def attention_row(b, n, m, tail, dtype, h=4, d=HEAD_DIM, same_bits=False):
    """K1 against its plain versions at one shape; timed beside its bound,
    the plain version and SDPA where the keys fill whole 64-key tiles. With
    `same_bits`, two more calls (2 launches) must give the same bits."""
    q, k, v, mask, info = attention_case(b, n, m, tail, dtype, seed=n + m + d, h=h, d=d)
    row = {"shape": f"B={b} N={n} M={m} H={h} D={d}", "dtype": str(dtype)[6:], **info}
    if same_bits:
        before = cuda_attention.launches
        runs = [cuda_attention.masked_attention_cuda(q, k, v, mask) for _ in range(2)]
        torch.cuda.synchronize()
        row.update(two_calls_bit_equal=bool(torch.equal(*runs)),
                   launches=cuda_attention.launches - before,
                   clusters_per_head=cuda_attention.kernel_wide_plan(d, dtype)[1])
        del runs
        if not row["two_calls_bit_equal"] or row["launches"] != 2:
            raise AssertionError(f"attention kernel {dtype} D={d}: two calls {row}")
    if m % 64 == 0:  # the trunk's shapes: time them
        esz = q.element_size()
        nbytes = 2 * b * n * h * d * esz + 2 * b * m * h * d * esz + b * m
        flops = 4 * b * h * n * m * d
        row.update(attention_bound(nbytes, flops, dtype))
        # one exp2 per score on the MUFU units, beside the matrix products
        row["exp_bound_ms"] = 1e3 * b * h * n * m / EXP_PER_S
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
        row["bound_share"] = row["bound_ms"] / row["ms"]
    print(f"  attention {json.dumps(row)}", flush=True)
    return row


def attention_phase():
    t0 = time.perf_counter()
    rows = {}
    cases = ([(c, 4, HEAD_DIM) for c in ATTN_CASES] + [(WIDE_ATTN_CASE, 2, WIDE_HEAD_DIM)]
             + list(WIDER_ATTN_CASES))
    for (b, n, m, tail), h, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            row = attention_row(b, n, m, tail, dtype, h, d)
            rows[(b, n, m, row["dtype"]) if d == HEAD_DIM else (b, n, m, row["dtype"], d)] = row
            torch.cuda.empty_cache()
    wide = rows[WIDE_ATTN_CASE[:3] + ("bfloat16", WIDE_HEAD_DIM)]
    # the wide-head kernels' rows: ms against SDPA's in both dtypes
    wider = {f"{b}x{n} H={h} D={d} {dt}": rows[(b, n, m, dt, d)]["ratio_to_library"]
             for (b, n, m, _), h, d in WIDER_ATTN_CASES for dt in ("float32", "bfloat16")}
    phase("2 attention kernel vs plain", t0,
          max_err_f32=max(r["max_abs_err"] for r in rows.values() if r["dtype"] == "float32"),
          max_err_bf16=max(r["max_abs_err"] for r in rows.values() if r["dtype"] == "bfloat16"),
          wide_head_bf16_ms=wide["ms"], wide_head_bound_ms=wide["bound_ms"],
          wider_head_ratio_to_library=json.dumps(wider, separators=(",", ":")))
    return rows


def sinkhorn_case(nb, n0, n1, iters, seed, nb1=None):
    """K2 against its plain version on random scores (B, nb, nb1) (nb1
    defaults to nb), valid rows n0 and columns n1 per item."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    b = len(n0)
    nb1 = nb if nb1 is None else nb1
    scores = 2.0 * torch.randn((b, nb, nb1), generator=g, device=DEVICE)
    row_mask = torch.arange(nb, device=DEVICE)[None] < torch.tensor(n0, device=DEVICE)[:, None]
    col_mask = torch.arange(nb1, device=DEVICE)[None] < torch.tensor(n1, device=DEVICE)[:, None]
    alpha = torch.tensor(1.0, device=DEVICE)
    # the couplings as the Matching path builds them for the kernel: rows of
    # nb1 + 1 floats in a pitch of a multiple of 4
    couplings, log_mu, log_nu, _ = sinkhorn.dustbin_couplings(
        scores, alpha, row_mask, col_mask, row_pitch=nb1 + 1 + -(nb1 + 1) % 4)
    got = cuda_sinkhorn.log_optimal_transport_cuda(scores, alpha, iters, row_mask, col_mask)
    want = sinkhorn.log_optimal_transport(scores, alpha, iters, row_mask, col_mask)
    torch.cuda.synchronize()
    err = 0.0
    for i in range(b):
        rows = torch.cat([torch.nonzero(row_mask[i])[:, 0], torch.tensor([nb], device=DEVICE)])
        cols = torch.cat([torch.nonzero(col_mask[i])[:, 0], torch.tensor([nb1], device=DEVICE)])
        err = max(err, (got[i][rows][:, cols] - want[i][rows][:, cols]).abs().max().item())
    if not math.isfinite(err) or err > SINKHORN_TOL:
        raise AssertionError(f"Sinkhorn kernel Z ({nb + 1}x{nb1 + 1}): max abs err "
                             f"{err} > {SINKHORN_TOL}")
    return couplings, log_mu.contiguous(), log_nu.contiguous(), err


def sinkhorn_row(nb, n0, n1, iters, nb1=None):
    """K2 against its plain version on one batch of Z; timed beside its bound."""
    z, mu, nu, err = sinkhorn_case(nb, n0, n1, iters, seed=nb, nb1=nb1)
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
    print(f"  sinkhorn {json.dumps(row)}", flush=True)
    return row


def sinkhorn_phase():
    t0 = time.perf_counter()
    rows = {}
    for nb, n0, n1, iters in SINKHORN_CASES:
        rows[(nb, len(n0), iters)] = sinkhorn_row(nb, n0, n1, iters)
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
    if differs(launches, match_counts(NUM_LAYERS * n, n, n)):
        raise AssertionError(f"kernel launches on the Matching path: {launches}, expected "
                             f"{NUM_LAYERS} attention, 1 Sinkhorn, 1 label-rounds and 1 "
                             "centroid-sums per request")
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


def wide_path_phase():
    """Matching with a 640-d trunk of 2 heads (the default 18 layers, random
    weights from the seed; no checkpoint has heads past 256) serves one
    keypoint request at bucket 2048 in bf16 and in f32: each of its 18 K1
    launches takes a wide-head kernel (head width 320). Its scores must be
    finite, and in f32 within 1e-3 of the same request through the plain
    versions (the whole path's bar)."""
    t0 = time.perf_counter()
    req, _ = synthetic_request(*WIDE_PATH_REQUEST)
    launches, preds = {}, {}
    for dtype, impl, pallas in (("bfloat16", "auto", True), ("float32", "auto", True),
                                ("plain", "flash", False)):
        mcfg = MatcherConfig(descriptor_dim=WIDE_PATH_DIM, num_heads=2,
                             attention_dtype="float32" if dtype == "plain" else dtype,
                             attention_impl=impl, use_pallas_sinkhorn=pallas)
        m = Matching(GIMSConfig(matcher=mcfg), device=DEVICE)
        reset_counts()
        preds[dtype] = m(req)
        torch.cuda.synchronize()
        launches[dtype] = counts()
        for side in "01":
            if not np.all(np.isfinite(preds[dtype][f"matching_scores{side}"])):
                raise AssertionError(f"wide-head path {dtype}: non-finite scores")
    for dtype in ("bfloat16", "float32"):
        if differs(launches[dtype], match_counts(NUM_LAYERS, 1, 1)):
            raise AssertionError(f"wide-head path {dtype}: launches {launches[dtype]}")
    if differs(launches["plain"], match_counts(0, 0, 1)):
        raise AssertionError(f"wide-head path, plain versions: launches {launches['plain']}")
    dscore = max(np.abs(preds["float32"][f"matching_scores{s}"]
                        - preds["plain"][f"matching_scores{s}"]).max() for s in "01")
    preds_kept = {s: preds["bfloat16"][f"keypoints{s}"].shape[1] for s in "01"}
    if not dscore <= 1e-3:
        raise AssertionError(f"wide-head path: f32 scores differ from the plain versions' "
                             f"by {dscore} > 1e-3")
    del preds
    torch.cuda.empty_cache()
    # K1 past one cluster a head (several clusters, each computing the whole
    # Q K^T of its rows): ms, bound, SDPA's ms, errors, two calls bit-equal
    widest = []
    for (b, n, m, tail), h, d, dtype in WIDEST_ATTN_CASES:
        widest.append(attention_row(b, n, m, tail, dtype, h, d, same_bits=True))
        torch.cuda.empty_cache()
    phase("25 wide-head path (Matching, 640-d trunk of 2 heads; K1 past one cluster a head)",
          t0, launches=json.dumps(launches), f32_max_score_diff=f"{dscore}",
          kept=json.dumps([int(preds_kept[s]) for s in "01"]),
          widest=json.dumps([{k: r[k] for k in ("shape", "dtype", "ms", "bound_ms",
                                                "library_ms", "plain_ms", "max_abs_err",
                                                "launches", "two_calls_bit_equal",
                                                "clusters_per_head")} for r in widest],
                            separators=(",", ":")))
    return {dtype: launches[dtype] for dtype in ("bfloat16", "float32")}


def pose_scene(seed, n=POSE_POINTS, outliers=POSE_OUTLIERS):
    """tests/test_utils_extra.py's scene at n points: (p0, p1, T_0to1) in
    pixels, the last share `outliers` of p1 uniform pixels."""
    rng = np.random.RandomState(seed)
    pts3 = rng.rand(n, 3) * 4 + [[-2, -2, 6]]
    a = np.deg2rad(8.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.6, 0.05, 0.02])
    p0 = (pts3 / pts3[:, 2:]) @ POSE_K.T
    cam1 = pts3 @ R.T + t
    p1 = ((cam1 / cam1[:, 2:]) @ POSE_K.T)[:, :2]
    bad = int(round(outliers * n))
    p1[n - bad:] = rng.rand(bad, 2) * [640, 480]
    return p0[:, :2], p1, np.block([[R, t[:, None]], [np.zeros((1, 3)), np.ones((1, 1))]])


def host_syncs(fn) -> int:
    """The times `fn` makes the host wait for the card (a read of a device
    value, a blocking copy), as torch.cuda.set_sync_debug_mode("warn")
    reports them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def pose_structured_phase(sift_variables):
    """estimate_pose on the card (eval/essential.py: the five-point RANSAC
    and recoverPose in torch), ms a call and of its find_essential_mat, the
    host's waits for the card in a call (host_syncs), pose errors and
    inlier shares;
    then the structured benchmark style: STRUCTURED_PAIRS 800x600 pairs
    generated by the port, evaluated by run_benchmark with staged Matching
    (the JAX defaults: host SIFT, 2048 keypoints), AUC, ms per image made
    and per pair."""
    t0 = time.perf_counter()
    scenes = []
    for seed in range(POSE_SCENES):
        p0, p1, T = pose_scene(2600 + seed)
        geometry.estimate_pose(p0, p1, POSE_K, POSE_K, thresh=1.0, device=DEVICE)  # warm-up
        out, ms = timed_call(lambda: geometry.estimate_pose(p0, p1, POSE_K, POSE_K, thresh=1.0,
                                                            device=DEVICE))
        if out is None:
            raise AssertionError(f"estimate_pose on scene {seed}: None")
        R, t, inl = out
        err_t, err_R = geometry.compute_pose_error(T, R, t)
        good = len(p0) - int(round(POSE_OUTLIERS * len(p0)))
        q0, q1 = (geometry._normalize_points(p, POSE_K) for p in (p0, p1))
        thresh = 1.0 / np.mean(np.diag(POSE_K)[:2])
        _, find_ms = timed_call(lambda: essential.find_essential_mat(q0, q1, thresh, 0.99999,
                                                                     device=DEVICE))
        syncs = host_syncs(lambda: geometry.estimate_pose(p0, p1, POSE_K, POSE_K, thresh=1.0,
                                                          device=DEVICE))
        scenes.append({"ms": ms, "find_essential_ms": find_ms, "host_syncs": syncs,
                       "err_R_deg": float(err_R), "err_t_deg": float(err_t),
                       "inlier_share_true": float(inl[:good].mean()),
                       "inlier_share_noise": float(inl[good:].mean())})
        if not (np.isfinite(R).all() and np.isfinite(t).all()):
            raise AssertionError(f"estimate_pose on scene {seed}: {scenes[-1]}")
    med_R = float(np.median([x["err_R_deg"] for x in scenes]))
    med_t = float(np.median([x["err_t_deg"] for x in scenes]))
    r_bar, t_bar, in_bar, noise_bar = POSE_BARS
    if not (med_R < r_bar and med_t < t_bar
            and all(x["inlier_share_true"] > in_bar and x["inlier_share_noise"] < noise_bar
                    for x in scenes)):
        raise AssertionError(f"estimate_pose: {scenes}")
    print(f"  pose {json.dumps({'points': POSE_POINTS, 'outliers': POSE_OUTLIERS, 'scenes': scenes})}",
          flush=True)

    with tempfile.TemporaryDirectory(prefix="gims_structured_") as tmp:
        t = time.perf_counter()
        txt, images = homography.generate_benchmark(
            os.path.join(tmp, "set"), n_pairs=STRUCTURED_PAIRS, height=EVAL_RESIZE[1],
            width=EVAL_RESIZE[0], seed=STRUCTURED_SEED, style="structured")
        gen_ms = 1e3 * (time.perf_counter() - t) / STRUCTURED_PAIRS
        m = TimedMatching(Matching(EVAL_STAGED_HOST, variables=sift_variables, device=DEVICE))
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        res = homography.run_benchmark(txt, images, os.path.join(tmp, "out"), resize=EVAL_RESIZE,
                                       agc=EVAL_AGC, matcher=m, device=DEVICE)
        elapsed = time.perf_counter() - t
        launches = counts()
        skipped, n_lines = skip_share(os.path.join(tmp, "out"))
    row = {"pairs": n_lines, "ms_per_image_generated": gen_ms,
           "ms_per_pair": 1e3 * elapsed / STRUCTURED_PAIRS,
           "matcher_ms_per_pair": 1e3 * m.seconds / STRUCTURED_PAIRS,
           "ransac_auc": res and res["ransac_auc"], "dlt_auc": res and res["dlt_auc"],
           "precision": res and res["precision"], "recall": res and res["recall"],
           "skip_share": skipped, "launches": launches}
    print(f"  structured {json.dumps(row)}", flush=True)
    if (n_lines != STRUCTURED_PAIRS or skipped or res is None
            or not np.isfinite(res["ransac_auc"]).all()
            or not staged_launches_ok(launches, STRUCTURED_PAIRS)):
        raise AssertionError(f"structured pairs: {row}")
    phase("26 estimate_pose and the structured benchmark style", t0,
          pose_ms=json.dumps([x["ms"] for x in scenes]), median_err_R_deg=med_R,
          median_err_t_deg=med_t, structured_auc=json.dumps(res["ransac_auc"]))
    return scenes, row


def wide_rows(attn, launches):
    """The `kernels` line's rows of the wide-head kernels: K1 at the
    wide-head path's shape (B=2, 2048, H=2, D=320) with that path's
    launches, one row a dtype."""
    b, n, m, _ = WIDER_ATTN_CASES[0][0]
    d = WIDER_ATTN_CASES[0][2]
    rows = []
    for dtype, kernel in (("bfloat16", "attn_wide_tc_kernel"), ("float32", "attn_wide_f32_kernel")):
        a = attn[(b, n, m, dtype, d)]
        rows.append({"name": f"masked_attention_wide_head_path_{dtype}", "route": "cuda",
                     "kernel": kernel, "source": "gims_tpu_torch/csrc/attention.cu",
                     "replaces": "gims_tpu/matcher/pallas_attention.py:42",
                     **a, "launches": launches[dtype]["attention"], "kernel_ms": a["ms"]})
    return rows


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
    that `want(mode, edges)` accepts under `path`, for phase 13; with `n`
    above 1, the first n under `path` + "0", "1", ..."""

    def __init__(self, path, want=lambda mode, edges: True, n=1):
        self.want = want
        self.paths = [path] if n == 1 else [f"{path}{i}" for i in range(n)]

    def __enter__(self):
        self.real = real = labels.propagate

        def recording(mode, edges, valid, rounds, nbr_idx=None):
            free = [p for p in self.paths if p not in RECORDED]
            if free and self.want(mode, edges):
                RECORDED[free[0]] = (mode, edges, valid, rounds, nbr_idx)
            return real(mode, edges, valid, rounds, nbr_idx)

        labels.propagate = recording

    def __exit__(self, *exc):
        labels.propagate = self.real


def reset_counts():
    cuda_attention.launches = cuda_sinkhorn.launches = labels.launches = 0
    cuda_attention.partial_launches = 0
    segsum.launches = 0
    segsum.launches_by_tag.clear()


def counts():
    return {"attention": cuda_attention.launches, "sinkhorn": cuda_sinkhorn.launches,
            "label_rounds": labels.launches,
            **{f"segsum_{tag}": segsum.launches_by_tag.get(tag, 0) for tag in SEGSUM_TAGS}}


def match_counts(attention, sinkhorn, builds, loss_steps=0):
    """The launches a matching path's run must show: K1, K2, one label-rounds
    and one centroid-sums launch per AGC build, one loss-sums launch per
    training step (the SIFT descriptors' launches vary with the keypoints:
    not compared)."""
    return {"attention": attention, "sinkhorn": sinkhorn, "label_rounds": builds,
            "segsum_agc_centroid_sums": builds, "segsum_train_loss_sums": loss_steps}


def differs(got, want):
    """Whether the counts `got` differ from `want` on want's keys."""
    return any(got[k] != v for k, v in want.items())


def zero_counts():
    return dict.fromkeys(counts(), 0)


def host_ms(fn, reps=5):
    """Mean ms per call of a host function over `reps` calls after one warm-up."""
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t) / reps


# inputs of the segmented sum by tag: (values, slots, num, shared) on the
# host; shared: one slot list for every row (row stride 0), kept as one row
SEGSUM_INPUTS = {}


@contextlib.contextmanager
def record_segsum(tags, suffix=""):
    """While active, keeps on the host (SEGSUM_INPUTS, under the tag and
    `suffix`) the largest input that the segmented-sum kernel got under each
    of `tags`. Each recording copies to the host: use it only in a path's
    untimed first call."""
    real = segsum.segment_sum_rows_cuda

    def recorded(values, slots, num, tag="other"):
        kept = SEGSUM_INPUTS.get(tag + suffix)
        if tag in tags and (kept is None or values.numel() > kept[0].numel()):
            shared = slots.shape[0] > 1 and slots.stride(0) == 0
            kept_slots = (slots[:1] if shared else slots).cpu()
            SEGSUM_INPUTS[tag + suffix] = (values.detach().cpu(), kept_slots, int(num), shared)
        return real(values, slots, num, tag)

    segsum.segment_sum_rows_cuda = recorded
    try:
        yield
    finally:
        segsum.segment_sum_rows_cuda = real


def timed_dispatches(m, batches, name, min_share=0.5, chunks=1, record=None):
    """Timed dispatches of `m` (one per batch after the first, a warm-up):
    launches per dispatch, matches and the share within 3 px, pairs/s and
    peak memory. Fails on a launch count other than 18 attention, 1
    Sinkhorn, 1 label-rounds and 1 centroid-sums per dispatch and chunk
    (`chunks`: the devices of a split), a pair without matches, non-finite scores or a
    correct share under `min_share` (None: no bound, for descriptors of
    untrained weights). `record`: a suffix under which the warm-up's AGC
    centroid sums are recorded (record_segsum)."""
    imgs0, imgs1, _ = batches[0]
    with (record_segsum(("agc_centroid_sums",), record) if record
          else contextlib.nullcontext()):
        m.collect_batch(m.dispatch_batch(imgs0, imgs1))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    preds, per_dispatch = [], []
    t = time.perf_counter()
    for imgs0, imgs1, hs in batches[1:]:
        before = counts()
        preds.append((m.collect_batch(m.dispatch_batch(imgs0, imgs1)), hs))
        per_dispatch.append({k: v - before[k] for k, v in counts().items()})
    elapsed = time.perf_counter() - t
    launches = counts()
    want = match_counts(chunks * NUM_LAYERS, chunks, chunks)
    if any(differs(d, want) for d in per_dispatch):
        raise AssertionError(f"{name}: launches per dispatch {per_dispatch}, expected {want}")
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
            "correct_share_per_pair": shares, "launches": launches,
            "launches_per_dispatch": per_dispatch[0]}
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
    total = zero_counts()
    for i, name in enumerate(("A", "B", "B", "A")):
        with record_labels("fused_" + name):
            launches = timed_dispatches(ms[name], batches, name,
                                        record="_fused" if i == 0 else None)
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
               "kept": outs[name].kept.sum(1).tolist(), "rounds_run": labels.last_rounds.tolist()}
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
    if differs(launches, match_counts(NUM_LAYERS * n, n, n)):
        raise AssertionError(f"staged S1 launches {launches}, expected {NUM_LAYERS} attention, "
                             "1 Sinkhorn, 1 label-rounds and 1 centroid-sums per request")
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


def staged_launches_ok(c, pairs, sinkhorn=1):
    """Launch counts of `pairs` staged Matching requests: `sinkhorn` K2
    launches a pair (0 where the config takes the plain Sinkhorn); a pair
    whose sides fill the same bucket stacks them (one AGC, one trunk call a
    layer: 18 K1, 1 label rounds), another runs them apart (36, 2); one
    centroid-sums launch per AGC build."""
    return (c["sinkhorn"] == sinkhorn * pairs and pairs <= c["label_rounds"] <= 2 * pairs
            and c["attention"] == NUM_LAYERS * c["label_rounds"]
            and c["segsum_agc_centroid_sums"] == c["label_rounds"]
            and c["segsum_train_loss_sums"] == 0)


class TimedMatching:
    """A staged Matching as run_benchmark's matcher, summing its host
    seconds of frontend and matcher (``Matching.timings``)."""

    def __init__(self, m):
        self.m, self.seconds, self.frontend_seconds = m, 0.0, 0.0

    def __call__(self, data):
        out = self.m(data)
        self.seconds += self.m.timings["matcher"]
        self.frontend_seconds += self.m.timings["frontend"]
        return out


def eval_phase(sift_variables, e2e_variables, e2e_car):
    """The homography benchmark of the JAX package's quality records on the
    card: 199 generated pairs, both fused configurations and staged Matching
    with host SIFT through eval.homography.run_benchmark (ground-truth
    matching and RANSAC on the card), each held to its record; then the CLI
    with staged Matching on 8 of the pairs."""
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
        for name in EVAL_RECORDS:
            with open(os.path.join(REPO, "docs", "quality_records", EVAL_RECORDS[name])) as f:
                record = json.load(f)
            rec = record["rows"]["synthetic"]
            args = record["args"]
            if name == "staged_host":
                want_args = {"pairs": EVAL_PAIRS, "max_keypoints": 2048,
                             "sinkhorn_iterations": FUSED_ITERS, "match_threshold": 0.02,
                             "agc": [15, 2, 7], "descriptor_source": "sift", "detector": "host",
                             "fused": False, "weights": "weights/gims_tpu_sift_last.npz"}
                if {k: args.get(k) for k in want_args} != want_args \
                        or record["skip"]["synthetic"] != 0.0:
                    raise AssertionError(f"eval {name}: the record's settings {args} differ")
                m = Matching(EVAL_STAGED_HOST, variables=sift_variables, device=DEVICE)
                fe, mc = m.frontend.cfg, m.cfg.matcher
                if (fe.descriptor_source, fe.detector, fe.sift_descriptor, m.max_keypoints,
                        mc.attention_dtype, mc.use_pallas_sinkhorn) != (
                            "sift", "host", "host", 2048, "bfloat16", True):
                    raise AssertionError(f"eval {name}: Matching {fe} {mc}")
                matcher = TimedMatching(m)
            else:
                config, total = EVAL_CONFIGS[name]
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
                        if k in ("agc_impl", "band_halfwidth", "threshold_impl",
                                 "threshold_stride", "reconnect_impl", "reconnect_buckets",
                                 "cc_impl", "cc_rounds")}
                got = {k: rc["agc"][k] for k in want}
                if got != want or rc["frontend"]["topk_impl"] != "approx" \
                        or rc["compact_to"] != config["compact_to"]:
                    raise AssertionError(f"eval {name}: FusedMatching {rc} against the "
                                         f"record's {record['resolved_config']}")
                matcher = FusedAsMatching(m, gray=name == "dense_gray")
            out = os.path.join(tmp, name)
            warm0, warm1, _ = fused_pairs(1, 990, colour=True)
            matcher({"image0": warm0, "image1": warm1, **EVAL_AGC})  # warm-up
            matcher.seconds = 0.0
            matcher.frontend_seconds = 0.0
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
            if name == "staged_host":
                # the staged frontend (host SIFT on the card, both images)
                row["frontend_ms_per_pair"] = 1e3 * matcher.frontend_seconds / EVAL_PAIRS
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
            if name == "staged_host":
                # staged Matching stacks a pair's sides where both fill the
                # same bucket (one AGC, one trunk call a layer: 18, 1, 1), and
                # else runs them apart (36, 1, 2)
                if not staged_launches_ok(launches[name], EVAL_PAIRS):
                    raise AssertionError(f"eval {name}: launches {launches[name]} over "
                                         f"{EVAL_PAIRS} pairs")
            elif differs(per_pair, match_counts(NUM_LAYERS, 1, 1)):
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
    phase("15 evaluation (199 generated pairs, fused dense_gray, devsift and staged host SIFT "
          "against the JAX records; the CLI with staged Matching on 8)", t0,
          launches=json.dumps(launches))
    return launches


def profile_train_step(cfg, model):
    """The stage split of one joint train step (after a warm-up step) in a
    torch.profiler trace: the gims.* ranges (a range's device span runs from
    its first kernel to its last; the backward's kernels are launched from
    autograd's device thread, outside the main thread's range), the device's
    busy time against the wall, and the kernels that took the most time."""
    h, w = cfg.dataset.image_height, cfg.dataset.image_width
    budgets = fused.octave_budgets(h, w, cfg.train.max_keypoints, cfg.frontend.upsample)
    state, tx = train_step.create_train_state(cfg, model, TRAIN_CUTS["limit"])
    step = fused_step.make_fused_e2e_train_step(cfg, tx, (h, w), budgets)
    pair = train_loop.data_mod.SyntheticPairDataset(cfg.dataset, length=1, seed=5)[0]
    batch = train_loop.build_batch_e2e([pair], DEVICE)
    step(state, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    stages, busy_ms = stage_split(prof, 1)
    kernels = sorted(((device_us(e, self_only=True) / 1e3, e.count, e.key[:80])
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.key.startswith("gims.")), reverse=True)
    split = {"config": "train joint step", "profiled_ms": wall_ms, "device_busy_ms": busy_ms,
             "idle_share": 1 - busy_ms / wall_ms, "stages": stages,
             "top_kernels_ms_count": kernels[:12],
             "kernels": sum(k[1] for k in kernels)}
    print(f"  train stages {json.dumps(split)}", flush=True)


def train_phase():
    """The fused end-to-end trainer at the full e2e_fo0_800 widths, the loop
    cut to 3 synthetic pairs per epoch, 2 epochs, the first frozen: every loss
    finite; the matcher's parameters unchanged in the frozen steps while the
    CNN's move, both moving afterwards; per train step 2 label-rounds
    launches and no K1 or K2; per validation pair 18 K1, 1 K2 and 1 label
    launch; the first step's two AGC graphs equal (adjacency and kept) with
    the kernel and with the plain label rounds; the EMA npz export loaded
    into a fresh FusedMatching matches a pair as the in-memory EMA model
    does; a resume from `last` continues the optimizer's step count."""
    t0 = time.perf_counter()
    cfg = load_config(TRAIN_CONFIG)
    m, f, a = cfg.matcher, cfg.frontend, cfg.agc
    got = {"dim": m.descriptor_dim, "layers": m.num_gnn_layers, "heads": m.num_heads,
           "attention_dtype": m.attention_dtype, "attention_impl": m.attention_impl,
           "remat": m.remat, "sinkhorn_iterations": m.sinkhorn_iterations,
           "threshold": m.match_threshold, "neg_cells": m.neg_cells,
           "use_pallas_sinkhorn": m.use_pallas_sinkhorn, "source": f.descriptor_source,
           "upsample": f.upsample, "keypoints": cfg.train.max_keypoints,
           "frame": [cfg.dataset.image_height, cfg.dataset.image_width],
           "agc": [a.radius, a.percentile, a.min_size],
           "desc_loss_weight": cfg.train.desc_loss_weight, "batch_size": cfg.train.batch_size}
    if got != TRAIN_WIDTHS:
        raise AssertionError(f"{TRAIN_CONFIG}: {got}, expected {TRAIN_WIDTHS}")
    print(f"  train cuts {json.dumps(TRAIN_CUTS)}, widths as configured {json.dumps(got)}",
          flush=True)
    tcfg = dataclasses.replace(cfg.train, num_epochs=TRAIN_CUTS["num_epochs"],
                               freeze_gmatcher_epochs=TRAIN_CUTS["freeze_gmatcher_epochs"],
                               val_images_count=TRAIN_CUTS["val_images_count"])
    cfg = dataclasses.replace(cfg, train=tcfg)
    frozen_steps = TRAIN_CUTS["freeze_gmatcher_epochs"] * TRAIN_CUTS["limit"]
    steps, vals, agc_inputs = [], [], []
    real_make, real_test, real_agc = (fused_step.make_fused_e2e_train_step, train_loop.test_model,
                                      pipeline.run_agc)

    def params_of(state, prefix):
        return [p.detach().clone() for n, p in state.model.named_parameters()
                if n.startswith(prefix)]

    def make_step(*args, **kwargs):
        inner = real_make(*args, **kwargs)

        def step(state, batch):
            before_m, before_c = params_of(state, "gmatcher."), params_of(state, "carhynet.")
            first = not steps
            torch.cuda.synchronize()
            before, t = counts(), time.perf_counter()
            # the first step's loss sums: the input of their kernels-line row
            with record_segsum(("train_loss_sums",)) if first else contextlib.nullcontext():
                state, metrics = inner(state, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
            after = counts()
            steps.append({
                "step": state.step - 1, "frozen": state.step - 1 < frozen_steps, "ms": ms,
                "losses": [float(x) for x in metrics["vec"].tolist()],
                "launches": {k: after[k] - before[k] for k in after},
                "matcher_moved": any(not torch.equal(a, b) for a, b in zip(
                    before_m, params_of(state, "gmatcher."))),
                "cnn_moved": any(not torch.equal(a, b) for a, b in zip(
                    before_c, params_of(state, "carhynet.")))})
            return state, metrics

        return step

    def test_model(matcher, val_dataset, val_count, *args, **kwargs):
        torch.cuda.synchronize()
        before, t = counts(), time.perf_counter()
        res = real_test(matcher, val_dataset, val_count, *args, **kwargs)
        torch.cuda.synchronize()
        after, n = counts(), min(val_count, len(val_dataset))
        vals.append({"pairs": n, "ms_per_pair": 1e3 * (time.perf_counter() - t) / n,
                     "launches_per_pair": {k: (after[k] - before[k]) / n for k in after},
                     "weight_score": res["weight_score"], "ransac_auc": res["ransac_auc"]})
        return res

    def run_agc(*args, **kwargs):
        if len(agc_inputs) < 2 and not vals and not steps:  # the first step's two sides
            agc_inputs.append(args)
        return real_agc(*args, **kwargs)

    logs = []
    torch.cuda.reset_peak_memory_stats()
    fused_step.make_fused_e2e_train_step = make_step
    train_loop.test_model, pipeline.run_agc = test_model, run_agc
    try:
        # the first step's two graphs, for phase 13
        with tempfile.TemporaryDirectory(prefix="gims_train_") as tmp, record_labels(
                "train_side", want=lambda mode, edges: not steps, n=2):
            reset_counts()
            t_train = time.perf_counter()
            state = train_loop.train(cfg, save_dir=os.path.join(tmp, "run"),
                                     limit=TRAIN_CUTS["limit"], fused_e2e=True,
                                     init_weights=E2E_WEIGHTS, device=DEVICE, log_fn=logs.append)
            train_s = time.perf_counter() - t_train
            launches = counts()
            peak = torch.cuda.max_memory_allocated()
            weights = os.path.join(tmp, "run", "weights")
            # the npz export against the in-memory EMA model, on one pair
            val = train_loop.data_mod.SyntheticPairDataset(cfg.dataset, length=1, seed=999)
            img0, img1, _ = val[0]
            mem = fused.FusedMatching(train_loop.eval_config(cfg),
                                      total_keypoints=cfg.train.max_keypoints, device=DEVICE)
            train_loop.load_eval_weights(mem, state)
            disk = fused.FusedMatching(
                train_loop.eval_config(cfg),
                variables=load_gims_checkpoint(os.path.join(weights, "last.npz")),
                car_variables=load_car_checkpoint(os.path.join(weights, "last_car.npz")),
                total_keypoints=cfg.train.max_keypoints, device=DEVICE)
            pm, pd = mem(img0, img1), disk(img0, img1)
            for key in ("keypoints0", "keypoints1", "matches0", "matches1"):
                if not np.array_equal(pm[key], pd[key]):
                    raise AssertionError(f"training: the exported npz matches differently ({key})")
            n_export = int((pm["matches0"] >= 0).sum())
            # resume from `last`: one more step, the counts continue
            steps_before = len(steps)
            resumed = train_loop.train(
                dataclasses.replace(cfg, train=dataclasses.replace(tcfg, num_epochs=3)),
                save_dir=os.path.join(tmp, "run"), limit=TRAIN_CUTS["limit"], fused_e2e=True,
                max_steps=state.step + 1, restore_path=os.path.join(weights, "last"),
                device=DEVICE, log_fn=logs.append)
    finally:
        fused_step.make_fused_e2e_train_step = real_make
        train_loop.test_model, pipeline.run_agc = real_test, real_agc
    main_steps = steps[:steps_before]
    n_steps = TRAIN_CUTS["limit"] * TRAIN_CUTS["num_epochs"]
    if len(main_steps) != n_steps or state.step != n_steps:
        raise AssertionError(f"training: {len(main_steps)} steps, state.step {state.step}")
    if not (resumed.step == n_steps + 1 and resumed.opt_state["count"] == n_steps + 1
            and resumed.ema_updates == n_steps + 1):
        raise AssertionError(f"training resume: step {resumed.step}, "
                             f"optimizer count {resumed.opt_state['count']}")
    for st in steps:
        if not all(math.isfinite(x) for x in st["losses"]):
            raise AssertionError(f"training: a loss is not finite: {st}")
        if differs(st["launches"], match_counts(0, 0, 2, loss_steps=1)):
            raise AssertionError(f"training: launches per step {st['launches']}")
        if st["matcher_moved"] == st["frozen"] or not st["cnn_moved"]:
            raise AssertionError(f"training: freezing {st}")
    for v in vals:
        if differs(v["launches_per_pair"], match_counts(NUM_LAYERS, 1, 1)):
            raise AssertionError(f"training validation: launches per pair {v}")
    # the first step's graphs: the label kernel against its plain version
    for side, args in enumerate(agc_inputs):
        kp, de, va, acfg = args[:4]
        adj_k, kept_k, _ = pipeline.run_agc(kp, de, va, acfg)
        real = labels.propagate
        labels.propagate = labels.propagate_plain
        try:
            adj_p, kept_p, _ = pipeline.run_agc(kp, de, va, acfg)
        finally:
            labels.propagate = real
        if not (torch.equal(adj_k, adj_p) and torch.equal(kept_k, kept_p)):
            raise AssertionError(f"training: AGC of side {side} differs with the plain label rounds")
    profile_train_step(cfg, state.model)
    frozen_ms = [st["ms"] for st in main_steps if st["frozen"]]
    joint_ms = [st["ms"] for st in main_steps if not st["frozen"]]
    info = {"steps": len(main_steps), "frozen_steps": len(frozen_ms),
            "ms_per_frozen_step": frozen_ms, "ms_per_joint_step": joint_ms,
            "mean_ms_frozen_after_first": sum(frozen_ms[1:]) / max(1, len(frozen_ms) - 1),
            "mean_ms_joint": sum(joint_ms) / len(joint_ms),
            "losses": [st["losses"] for st in main_steps],
            "max_memory_allocated_gb": peak / 1e9, "train_seconds": train_s,
            "validation": vals, "export_matches": n_export,
            "resumed_step": resumed.step, "launches": launches,
            "agc_graphs_checked": len(agc_inputs)}
    print(f"  train {json.dumps(info)}", flush=True)
    phase("16 training (train.loop.train, e2e_fo0_800 widths, 2 epochs of 3 pairs)", t0,
          launches=json.dumps(launches))
    return launches


def sift_share_within(a, b):
    """Share of a's keypoints (x, y, size, angle, response, packed octave
    columns) with a counterpart in b: within 1e-3 px, the same octave and
    layer bytes, size and response within 1e-4 relative, angle within 0.05
    degrees (circular)."""
    pa, sa, aa, ra, oa = a
    pb, sb, ab, rb, ob = b
    if len(pa) == 0:
        return 1.0
    order = np.argsort(pb[:, 0], kind="stable")
    xs = pb[order, 0]
    lo = np.searchsorted(xs, pa[:, 0] - 1e-3, "left")
    hi = np.searchsorted(xs, pa[:, 0] + 1e-3, "right")
    ok = 0
    for i in range(len(pa)):
        for j in order[lo[i]:hi[i]]:
            da = abs((float(aa[i]) - float(ab[j]) + 180.0) % 360.0 - 180.0)
            if (abs(float(pa[i, 1]) - float(pb[j, 1])) <= 1e-3
                    and (oa[i] & 0xFFFF) == (ob[j] & 0xFFFF) and da <= 0.05
                    and abs(sb[j] / sa[i] - 1) <= 1e-4
                    and abs(rb[j] - ra[i]) <= 1e-4 * max(abs(float(ra[i])), 1e-12)):
                ok += 1
                break
    return ok / len(pa)


def host_sift_phase(variables):
    """OpenCV's SIFT as the port computes it (frontend/sift.py) on the card
    against the CPU on the same images; staged Matching with host SIFT
    detection and descriptors at 2048 keypoints; Matching at the JAX
    defaults."""
    t0 = time.perf_counter()
    cfg = FrontendConfig()
    if (cfg.detector, cfg.sift_descriptor, cfg.contrast_threshold, cfg.edge_threshold,
            cfg.sigma, cfg.n_octave_layers) != ("host", "host", 0.001, 80.0, 1.6, 3):
        raise AssertionError(f"host SIFT: FrontendConfig defaults {cfg}")
    card, cpu = sift.make_sift(cfg, DEVICE), sift.make_sift(cfg, "cpu")
    images = [im for seed in HOST_SIFT_SEEDS
              for im in synthetic_image_pair(seed, FUSED_FRAME, colour=True)[:2]]
    card.compute_device(images[0], sift.filter_top_responses(
        card.detect(images[0]), HOST_SIFT_KEYPOINTS))  # warm-up
    rows = []
    for i, img in enumerate(images):
        torch.cuda.synchronize()
        t = time.perf_counter()
        kp, packed, gauss = card.detect_raw(img)
        torch.cuda.synchronize()
        det_ms = 1e3 * (time.perf_counter() - t)
        top_card = sift.filter_top_responses(kp, HOST_SIFT_KEYPOINTS)
        t = time.perf_counter()
        desc_card = card.compute_device(img, top_card, gauss)
        torch.cuda.synchronize()
        desc_ms = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        kp_cpu, packed_cpu, _ = cpu.detect_raw(img)
        cpu_s = time.perf_counter() - t
        cols = (kp.pt, kp.size, kp.angle, kp.response, packed)
        cols_cpu = (kp_cpu.pt, kp_cpu.size, kp_cpu.angle, kp_cpu.response, packed_cpu)
        share_card, share_cpu = sift_share_within(cols, cols_cpu), sift_share_within(cols_cpu, cols)
        # the same keypoints (the CPU's strongest) described on both devices
        top = sift.filter_top_responses(kp_cpu, HOST_SIFT_KEYPOINTS)
        d_card = card.compute(img, top).astype(np.int64)
        d_cpu = cpu.compute(img, top).astype(np.int64)
        within = float((np.abs(d_card - d_cpu) <= 1).mean())
        cos = (d_card * d_cpu).sum(1) / np.maximum(
            np.linalg.norm(d_card, axis=1) * np.linalg.norm(d_cpu, axis=1), 1e-9)
        row = {"image": i, "keypoints_card": len(kp), "keypoints_cpu": len(kp_cpu),
               "detect_ms": det_ms, "describe_ms_2048": desc_ms, "cpu_detect_s": cpu_s,
               "share_card_in_cpu": share_card, "share_cpu_in_card": share_cpu,
               "same_points_and_octaves": bool(len(kp) == len(kp_cpu) and np.array_equal(
                   kp.pt, kp_cpu.pt) and np.array_equal(packed, packed_cpu)),
               "descriptor_bytes_within_1": within,
               "descriptor_bytes_equal": float((d_card == d_cpu).mean()),
               "min_cosine": float(cos.min()),
               "described": int(desc_card.shape[0])}
        print(f"  host sift {json.dumps(row)}", flush=True)
        rows.append(row)
        if not (share_card >= 0.98 and share_cpu >= 0.98 and within >= 0.99
                and cos.min() >= 0.99 and desc_card.shape == (len(top_card), 128)):
            raise AssertionError(f"host SIFT on the card against the CPU: {row}")
    profiled(lambda: sift.detect_and_describe_device(images[0], cfg, HOST_SIFT_KEYPOINTS,
                                                     device=DEVICE),
             HOST_SIFT_STAGES, "host SIFT one image", "host sift stages")
    summary = {"detect_ms_per_image": [r["detect_ms"] for r in rows],
               "describe_ms_per_image": [r["describe_ms_2048"] for r in rows],
               "keypoints_per_image": [r["keypoints_card"] for r in rows]}
    print(f"  host sift summary {json.dumps(summary)}", flush=True)

    # staged Matching, host SIFT detection and descriptors, 2048 keypoints
    m = Matching(HOST_STAGED_CONFIG, variables=variables, device=DEVICE)
    fe = m.frontend.cfg
    if (fe.descriptor_source, fe.detector, fe.sift_descriptor, m.max_keypoints) != (
            "sift", "host", "host", HOST_SIFT_KEYPOINTS):
        raise AssertionError(f"host staged configuration: {fe}")
    pairs = [synthetic_image_pair(620 + i, FUSED_FRAME) for i in range(HOST_STAGED_PAIRS + 1)]
    # the warm-up, untimed, gives the SIFT and centroid sums' kernels-line inputs
    with record_segsum(("sift_descriptors", "agc_centroid_sums")):
        staged_request(m, pairs[0], return_descriptors=False)
    torch.cuda.synchronize()
    reset_counts()
    preds, per_request = [], []
    t = time.perf_counter()
    with record_labels("host_sift_staged"):
        for pair in pairs[1:]:
            feats = m.prepare_features(pair[:2])
            before = counts()
            pred = staged_request(m, pair, features=feats, return_descriptors=False)
            per_request.append({k: v - before[k] for k, v in counts().items()})
            preds.append((pred, feats, pair[2]))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t
    launches = counts()
    n_good = n_all = 0
    for pred, feats, H in preds:
        check_request(pred, feats, "host staged")
        k = int((pred["matches0"][0] >= 0).sum())
        if k <= 0:
            raise AssertionError("host staged: a pair has no matches")
        share = correct_share(pred, H)
        n_good += share * k
        n_all += k
    info = {"pairs": HOST_STAGED_PAIRS, "ms_per_pair": 1e3 * elapsed / HOST_STAGED_PAIRS,
            "keypoints_per_image": [p[1]["0"]["n"] for p in preds],
            "matches_per_pair": n_all / HOST_STAGED_PAIRS, "correct_share": n_good / n_all,
            "launches": launches, "launches_per_request": per_request[0],
            "timings_last_pair_s": m.timings}
    print(f"  host staged {json.dumps(info)}", flush=True)
    # both sides fill the 2048 bucket: stacked, one AGC and one trunk call a
    # layer; each pair's two images described on the card (SIFT's sums)
    want = match_counts(NUM_LAYERS, 1, 1)
    if any(differs(r, want) for r in per_request):
        raise AssertionError(f"host staged: launches per request {per_request}, expected {want}")
    if launches["segsum_sift_descriptors"] < 2 * HOST_STAGED_PAIRS:
        raise AssertionError(f"host staged: SIFT's segmented sums launched {launches}")
    if not info["correct_share"] >= 0.5:
        raise AssertionError(f"host staged: {info['correct_share']} of matches within 3 px < 0.5")
    del m
    torch.cuda.empty_cache()

    # Matching at the JAX defaults: carhynet descriptors at host SIFT
    # keypoints, all of them kept (max_keypoints -1), a random colour CNN
    m = Matching(variables=variables, device=DEVICE)
    fe = m.frontend.cfg
    if (fe.descriptor_source, fe.detector, fe.sift_descriptor, m.max_keypoints) != (
            "carhynet", "host", "host", -1):
        raise AssertionError(f"Matching defaults: {fe}")
    defaults = []
    for seed in (630, 631):
        img0, img1, _ = synthetic_image_pair(seed, FUSED_FRAME, colour=True)
        feats = m.prepare_features((img0, img1))
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        pred = m({"image0": img0, "image1": img1, "features": feats})
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        check_request(pred, feats, "Matching defaults")
        got = counts()
        defaults.append({"keypoints": [feats["0"]["n"], feats["1"]["n"]], "matcher_ms": ms,
                         "matches": int((pred["matches0"][0] >= 0).sum()), "launches": got})
        if not staged_launches_ok(got, 1, int(m.cfg.matcher.use_pallas_sinkhorn)):
            raise AssertionError(f"Matching defaults: launches {got}")
    print(f"  matching defaults {json.dumps(defaults)}", flush=True)
    del m
    torch.cuda.empty_cache()
    phase("17 host SIFT on the card vs the CPU; staged Matching host/host (2048, 8 pairs); "
          "Matching at the JAX defaults (2 pairs)", t0, launches=json.dumps(launches))
    return launches


def classic_train_phase():
    """The classic trainer at configs/synth_sift.yaml's widths with host
    SIFT descriptors: 2 epochs of 3 synthetic pairs, 2 validation pairs, one
    resume; then 5 steps of CAR-HyNet's trainer."""
    t0 = time.perf_counter()
    cfg = load_config(CLASSIC_CONFIG)
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                descriptor_source="sift"))
    got = {"frame": [cfg.dataset.image_height, cfg.dataset.image_width],
           "keypoints": cfg.train.max_keypoints, "batch_size": cfg.train.batch_size,
           "layers": cfg.matcher.num_gnn_layers, "dim": cfg.matcher.descriptor_dim,
           "attention_dtype": cfg.matcher.attention_dtype,
           "sinkhorn_iterations": cfg.matcher.sinkhorn_iterations}
    if got != CLASSIC_WIDTHS:
        raise AssertionError(f"{CLASSIC_CONFIG}: {got}, expected {CLASSIC_WIDTHS}")
    print(f"  classic cuts {json.dumps(CLASSIC_CUTS)}, widths as configured {json.dumps(got)}",
          flush=True)
    tcfg = dataclasses.replace(cfg.train, num_epochs=CLASSIC_CUTS["num_epochs"],
                               val_images_count=CLASSIC_CUTS["val_images_count"])
    cfg = dataclasses.replace(cfg, train=tcfg)
    steps, vals = [], []
    real_make, real_test = train_step.make_train_step, train_loop.test_model

    def make_step(*args, **kwargs):
        inner = real_make(*args, **kwargs)

        def step(state, batch):
            torch.cuda.synchronize()
            before, t = counts(), time.perf_counter()
            state, metrics = inner(state, batch)
            torch.cuda.synchronize()
            after = counts()
            steps.append({"step": state.step - 1, "ms": 1e3 * (time.perf_counter() - t),
                          "losses": [float(x) for x in metrics["vec"].tolist()],
                          "launches": {k: after[k] - before[k] for k in after}})
            return state, metrics

        return step

    def test_model(matcher, val_dataset, val_count, *args, **kwargs):
        torch.cuda.synchronize()
        before, t = counts(), time.perf_counter()
        res = real_test(matcher, val_dataset, val_count, *args, **kwargs)
        torch.cuda.synchronize()
        after, n = counts(), min(val_count, len(val_dataset))
        vals.append({"pairs": n, "ms_per_pair": 1e3 * (time.perf_counter() - t) / n,
                     "launches": {k: after[k] - before[k] for k in after},
                     "weight_score": res["weight_score"]})
        return res

    logs = []
    torch.cuda.reset_peak_memory_stats()
    train_step.make_train_step, train_loop.test_model = make_step, test_model
    try:
        with tempfile.TemporaryDirectory(prefix="gims_classic_") as tmp, record_labels(
                "classic_train_side", want=lambda mode, edges: not steps, n=2):
            reset_counts()
            t = time.perf_counter()
            state = train_loop.train(cfg, save_dir=os.path.join(tmp, "run"),
                                     limit=CLASSIC_CUTS["limit"], device=DEVICE,
                                     log_fn=logs.append)
            train_s = time.perf_counter() - t
            launches = counts()
            peak = torch.cuda.max_memory_allocated()
            weights = os.path.join(tmp, "run", "weights")
            written = sorted(os.listdir(weights))
            metrics = [json.loads(line) for line in open(os.path.join(tmp, "run",
                                                                      "metrics.jsonl"))]
            steps_before = len(steps)
            resumed = train_loop.train(
                dataclasses.replace(cfg, train=dataclasses.replace(tcfg, num_epochs=3)),
                save_dir=os.path.join(tmp, "run"), limit=CLASSIC_CUTS["limit"],
                max_steps=state.step + 1, restore_path=os.path.join(weights, "last"),
                device=DEVICE, log_fn=logs.append)
    finally:
        train_step.make_train_step, train_loop.test_model = real_make, real_test
    n_steps = CLASSIC_CUTS["limit"] * CLASSIC_CUTS["num_epochs"]
    main_steps = steps[:steps_before]
    if len(main_steps) != n_steps or state.step != n_steps:
        raise AssertionError(f"classic training: {len(main_steps)} steps, state.step {state.step}")
    if not (resumed.step == n_steps + 1 and resumed.opt_state["count"] == n_steps + 1):
        raise AssertionError(f"classic training resume: step {resumed.step}")
    for name in ("last.pt", "minloss.pt", "last.npz"):
        if name not in written:
            raise AssertionError(f"classic training: {name} not written ({written})")
    for st in steps:
        if not all(math.isfinite(x) for x in st["losses"]):
            raise AssertionError(f"classic training: a loss is not finite: {st}")
        if differs(st["launches"], match_counts(0, 0, 2, loss_steps=1)):
            raise AssertionError(f"classic training: launches per step {st['launches']}")
    for v in vals:
        # Matching with every keypoint kept: a pair's sides may fall in two
        # buckets and run apart; the config's use_pallas_sinkhorn (false in
        # synth_sift.yaml, as in the JAX package) picks the plain Sinkhorn
        if not staged_launches_ok(v["launches"], v["pairs"],
                                  int(cfg.matcher.use_pallas_sinkhorn)):
            raise AssertionError(f"classic training validation: launches {v}")

    # CAR-HyNet's trainer on synthetic patch pairs
    car_logs = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    car_vars = car_train.train_descriptor(steps=DESCRIPTOR_STEPS,
                                          batch_points=DESCRIPTOR_POINTS, log_every=1,
                                          log_fn=car_logs.append, device=DEVICE)
    torch.cuda.synchronize()
    car_s = time.perf_counter() - t
    car_losses = [float(line.split("loss=")[1].split()[0]) for line in car_logs]
    if len(car_losses) != DESCRIPTOR_STEPS or not all(map(math.isfinite, car_losses)):
        raise AssertionError(f"CAR-HyNet training: losses {car_logs}")
    if not all(np.all(np.isfinite(v)) for v in _leaves(car_vars)):
        raise AssertionError("CAR-HyNet training: non-finite variables")
    info = {"steps": len(main_steps), "ms_per_step": [st["ms"] for st in main_steps],
            "mean_ms_after_first": sum(st["ms"] for st in main_steps[1:]) / (n_steps - 1),
            "losses": [st["losses"] for st in main_steps],
            "batch_ms": [{"data": 1e3 * r["data_time"], "sift": 1e3 * r["preprocess_time"]}
                         for r in metrics],
            "max_memory_allocated_gb": peak / 1e9, "train_seconds": train_s,
            "validation": vals, "written": written, "resumed_step": resumed.step,
            "launches": launches, "launches_per_step": main_steps[0]["launches"],
            "descriptor_steps": DESCRIPTOR_STEPS, "descriptor_points": DESCRIPTOR_POINTS,
            "descriptor_losses": car_losses,
            "descriptor_ms_per_step": 1e3 * car_s / DESCRIPTOR_STEPS}
    print(f"  classic train {json.dumps(info)}", flush=True)
    phase("18 training (the classic trainer at synth_sift widths, 2 epochs of 3 pairs, a "
          "resume; CAR-HyNet's trainer, 5 steps)", t0, launches=json.dumps(launches))
    return launches


def free_port():
    """A free TCP port on 127.0.0.1 (for a one-rank NCCL rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class nccl_world_one:
    """A process group of this process alone, over NCCL, on the card."""

    def __enter__(self):
        multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl", device=DEVICE)
        return torch.distributed.group.WORLD

    def __exit__(self, *exc):
        torch.distributed.destroy_process_group()


def dp_serving_phase(variables, car_variables):
    """FusedMatching split over [cuda:0, cuda:0] against the unsplit run:
    f32 through the kernels, kept and matches identical; bf16 (the card's
    defaults, configuration B) timed in turns unsplit, split, split,
    unsplit, 2 x (18, 1, 1) launches a split dispatch; devices=2 where the
    machine has two cards."""
    t0 = time.perf_counter()
    common = dict(variables=variables, car_variables=car_variables,
                  total_keypoints=FUSED_KEYPOINTS, device=DEVICE)
    split_devices = [torch.device(DEVICE, 0)] * DP_SPLIT
    batches = [fused_pairs(FUSED_BATCH, DP_SEED + 100 * i) for i in range(FUSED_TIMED + 1)]
    f32 = {**FUSED_CONFIG, "attention_dtype": "float32", "dense_dtype": "float32"}
    imgs0, imgs1, _ = batches[1]
    whole = fused.FusedMatching(f32, **common)
    split = fused.FusedMatching(f32, devices=split_devices, **common)
    reset_counts()
    got = split.collect_batch(split.dispatch_batch(imgs0, imgs1))
    split_launches = counts()
    want = whole.collect_batch(whole.dispatch_batch(imgs0, imgs1))
    for i, (a, b) in enumerate(zip(got, want)):
        for key in ("keypoints0", "keypoints1", "matches0", "matches1"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"split f32 pair {i}: {key} differs from the unsplit run")
    if len(got) != FUSED_BATCH:
        raise AssertionError(f"split f32: {len(got)} pairs back, {FUSED_BATCH} sent")
    print(f"  dp serving f32 {json.dumps({'pairs': len(got), 'identical': True, 'launches': split_launches, 'matches_per_pair': float(np.mean([(g['matches0'] >= 0).sum() for g in got]))})}",
          flush=True)
    del whole, split
    torch.cuda.empty_cache()
    ms = {"unsplit": fused.FusedMatching(FUSED_CONFIG, **common),
          "split": fused.FusedMatching(FUSED_CONFIG, devices=split_devices, **common)}
    total = zero_counts()
    for name in ("unsplit", "split", "split", "unsplit"):
        if name == "split":
            with record_labels("dp_serving"):
                launches = timed_dispatches(ms[name], batches, "split " + str(DP_SPLIT),
                                            chunks=DP_SPLIT)
            total = {k: total[k] + launches[k] for k in total}
        else:
            timed_dispatches(ms[name], batches, "unsplit")
    del ms
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= 2:
        m = fused.FusedMatching(FUSED_CONFIG, **{**common, "device": None}, devices=2)
        timed_dispatches(m, batches, "devices=2", chunks=2)
        del m
    else:
        print(f"  dp serving devices=2: not run, this machine has "
              f"{torch.cuda.device_count()} card", flush=True)
    phase(f"19 data-parallel serving (FusedMatching split over {DP_SPLIT} x cuda:0, "
          f"{FUSED_BATCH} pairs)", t0, launches=json.dumps(total))
    return total


def dp_jobs():
    """The two train-step jobs of phase 20, on two pairs each: the fused
    end-to-end step at e2e_fo0_800's widths from the joint e2e weights, and
    the classic step at synth_sift's with host SIFT batches, a random
    matcher; no warmup and no freezing, so that one step moves the
    parameters."""
    ecfg = load_config(TRAIN_CONFIG)
    ecfg = dataclasses.replace(ecfg, train=dataclasses.replace(ecfg.train,
                                                               freeze_gmatcher_epochs=0))
    loaded = ckpt_io.unflatten_npz(E2E_WEIGHTS)
    ds = train_data.SyntheticPairDataset(ecfg.dataset, length=DP_SPLIT, seed=DP_SEED)
    fjob = {"kind": "fused", "cfg": ecfg,
            "variables": {"params": loaded["params"], "batch_stats": loaded["batch_stats"]},
            "car_variables": load_car_checkpoint(E2E_CAR_WEIGHTS),
            "batch": train_loop.build_batch_e2e([ds[i] for i in range(DP_SPLIT)], "cpu")}
    ccfg = load_config(CLASSIC_CONFIG)
    ccfg = dataclasses.replace(
        ccfg, frontend=dataclasses.replace(ccfg.frontend, descriptor_source="sift"),
        optimizer=dataclasses.replace(ccfg.optimizer, warmup_epochs=0))
    ds = train_data.SyntheticPairDataset(ccfg.dataset, length=DP_SPLIT, seed=DP_SEED)
    idxs = np.arange(DP_SPLIT)
    batch = train_loop.build_batch_raw(ccfg.frontend, [ds[i] for i in idxs],
                                       ccfg.train.max_keypoints, None,
                                       seeds=train_loop.row_seeds(idxs, DP_SEED), device=DEVICE)
    cjob = {"kind": "classic", "cfg": ccfg,
            "variables": init_gmatcher_variables(ccfg.matcher, seed=ccfg.train.init_seed),
            "batch": {k: v.cpu() for k, v in batch.items()}}
    return {"fused": fjob, "classic": cjob}


def pair_job(job, i):
    return {**job, "batch": {k: v[i:i + 1] for k, v in job["batch"].items()}}


def dp_train_phase():
    """One data-parallel step of each trainer over two ranks that share the
    card over gloo (one pair a rank): both ranks end with bit-equal
    parameters, the averaged loss is the mean of the per-pair losses of
    undistributed steps (JAX's criterion, tests/test_train.py:439-520), and a
    step over a one-rank NCCL group is bit-equal to the undistributed step."""
    t0 = time.perf_counter()
    jobs = dp_jobs()
    print(f"  dp train jobs built in {time.perf_counter() - t0:.3f}s (host SIFT batch on the "
          f"card)", flush=True)
    with tempfile.TemporaryDirectory(prefix="gims_dp_") as tmp:
        t = time.perf_counter()
        ranks = dp_check.run(dp_check.step_rank, [DEVICE + ":0"] * DP_SPLIT, "gloo",
                             {"jobs": [jobs["fused"], jobs["classic"]]}, tmp)
        wall = time.perf_counter() - t
    label_launches = {}
    for j, name in enumerate(("fused", "classic")):
        got = [r["jobs"][j] for r in ranks]
        with record_labels("dp_train_" + name):
            singles = [dp_check.train_step_job(pair_job(jobs[name], i), torch.device(DEVICE))
                       for i in range(DP_SPLIT)]
        with nccl_world_one() as group:
            nccl = dp_check.train_step_job(pair_job(jobs[name], 0), torch.device(DEVICE), group)
        loss = got[0]["metrics"]["total_loss"]
        want = float(np.mean([s["metrics"]["total_loss"] for s in singles]))
        info = {
            "job": name, "ranks": DP_SPLIT, "backend": got[0]["backend"],
            "rank_ms_per_step": [g["step_ms"] for g in got],
            "single_ms_per_step": [s["step_ms"] for s in singles],
            "all_reduce_bytes": got[0]["all_reduce_bytes"],
            "all_reduce_ms_gloo_two_ranks": [g["all_reduce_ms"] for g in got],
            "all_reduce_ms_nccl_one_rank": nccl["all_reduce_ms"],
            "nccl_one_rank_ms_per_step": nccl["step_ms"],
            "averaged_loss": loss, "mean_pair_loss": want,
            "pair_losses": [s["metrics"]["total_loss"] for s in singles],
            "label_launches": [g["label_launches"] for g in got],
            "ranks_bit_equal": all(torch.equal(p, got[1]["params"][n])
                                   for n, p in got[0]["params"].items()),
            "nccl_bit_equal": all(torch.equal(p, singles[0]["params"][n])
                                  for n, p in nccl["params"].items())
            and all(torch.equal(b, singles[0]["buffers"][n]) for n, b in nccl["buffers"].items()),
            "moved": sorted({n.split(".")[0] if name == "fused" else "gmatcher"
                             for n, p in dp_check.build_model(jobs[name]).named_parameters()
                             if not torch.equal(p.detach(), got[0]["params"][n])})}
        print(f"  dp train {json.dumps(info)}", flush=True)
        leaked = [m for r in ranks for m in r["modules"] if m in ("jax", "gims_tpu")]
        if leaked:
            raise AssertionError(f"a rank imported {leaked}")
        if not info["ranks_bit_equal"] or got[0]["metrics"] != got[1]["metrics"]:
            raise AssertionError(f"dp train {name}: the ranks' parameters or metrics differ")
        if not abs(loss - want) <= DP_LOSS_RTOL * abs(want):
            raise AssertionError(f"dp train {name}: averaged loss {loss} against the mean of "
                                 f"the pair losses {want} (rtol {DP_LOSS_RTOL})")
        if not info["nccl_bit_equal"]:
            raise AssertionError(f"dp train {name}: the one-rank NCCL step differs from the "
                                 f"undistributed step")
        if info["label_launches"] != [2] * DP_SPLIT:
            raise AssertionError(f"dp train {name}: label launches {info['label_launches']}")
        if info["moved"] != (["carhynet", "gmatcher"] if name == "fused" else ["gmatcher"]):
            raise AssertionError(f"dp train {name}: the step moved {info['moved']}")
        label_launches[name] = sum(info["label_launches"])
    del jobs
    torch.cuda.empty_cache()
    phase(f"20 data-parallel training ({DP_SPLIT} gloo ranks sharing the card, one fused "
          "and one classic step)", t0, ranks_wall_s=f"{wall:.3f}")
    return label_launches


def partial_case(b, n, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = (torch.randn((b, n, 4, HEAD_DIM), generator=g, device=DEVICE).to(dtype)
               for _ in range(3))
    mask = torch.ones((b, n), dtype=torch.bool, device=DEVICE)
    mask[:, n - n // 8:] = False
    mask[1, : n // 7] = False  # masked keys at the head of one item too
    return q, k, v, mask


def partial_row(b, n, dtype, seed):
    """K1's partial mode against its plain version: the output bit-equal to
    the kernel's default mode (phase 2 holds that to the plain versions),
    the row max within PARTIAL_M_TOL, the row sum within PARTIAL_L_RTOL;
    timed beside the default mode, the plain version and SDPA."""
    q, k, v, mask = partial_case(b, n, dtype, seed)
    out, stats = cuda_attention.attention_partials_cuda(q, k, v, mask)
    dense = cuda_attention.masked_attention_cuda(q, k, v, mask)
    _, want = attention.attention_partials_tiled(q, k, v, mask, out_dtype=torch.float32)
    torch.cuda.synchronize()
    m_err = (stats[..., 0] - want[..., 0]).abs().max().item()
    l_err = ((stats[..., 1] - want[..., 1]).abs() / want[..., 1]).max().item()
    row = {"shape": f"B={b} N={n} M={n} H=4 D={HEAD_DIM}", "dtype": str(dtype)[6:],
           "out_equals_default_mode": bool(torch.equal(out, dense)), "max_abs_err_m": m_err,
           "max_rel_err_l": l_err, "max_abs_err": m_err}
    if not (row["out_equals_default_mode"] and m_err <= PARTIAL_M_TOL
            and l_err <= PARTIAL_L_RTOL):
        raise AssertionError(f"K1 partial mode against its plain version: {row}")
    esz = q.element_size()
    h = 4
    nbytes = 2 * b * n * h * HEAD_DIM * esz + 2 * b * n * h * HEAD_DIM * esz + b * n \
        + 8 * b * n * h
    row.update(attention_bound(nbytes, 4 * b * h * n * n * HEAD_DIM, dtype))
    row["ms"] = cuda_ms(lambda: cuda_attention.attention_partials_cuda(q, k, v, mask))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["default_mode_ms"] = cuda_ms(lambda: cuda_attention.masked_attention_cuda(q, k, v, mask))
    row["plain_ms"] = cuda_ms(lambda: attention.attention_partials_tiled(q, k, v, mask), 1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bias = torch.zeros((b, 1, 1, n), dtype=dtype, device=DEVICE)
    bias.masked_fill_(~mask[:, None, None, :], attention.NEG_INF)
    row["library_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias))
    row["ratio_to_library"] = row["ms"] / row["library_ms"]
    print(f"  partial {json.dumps(row)}", flush=True)
    return row


def ring_phase():
    """K1's partial mode against its plain version at the ring cases and at
    their ring steps' shapes; the ring at P=2 over two gloo ranks on the
    card and at P=1 over NCCL, each against dense K1."""
    t0 = time.perf_counter()
    rows = {}
    for b, n, dtype in RING_CASES:
        for nn in (n, n // DP_SPLIT):
            rows[(b, nn, str(dtype)[6:])] = partial_row(b, nn, dtype, seed=nn + 7)
    cases, dense = [], []
    for b, n, dtype in RING_CASES:
        q, k, v, mask = partial_case(b, n, dtype, seed=n + 11)
        cases.append({"q": q.cpu(), "k": k.cpu(), "v": v.cpu(), "mask": mask.cpu(),
                      "dtype": dtype})
        dense.append((cuda_attention.masked_attention_cuda(q, k, v, mask),
                      attention.masked_attention_direct(q.float(), k.float(), v.float(), mask)))
    with tempfile.TemporaryDirectory(prefix="gims_ring_") as tmp:
        t = time.perf_counter()
        ranks = dp_check.run(dp_check.ring_rank, [DEVICE + ":0"] * DP_SPLIT, "gloo",
                             {"cases": cases, "reps": 3}, tmp)
        wall = time.perf_counter() - t
    launches = {}
    with nccl_world_one() as group:
        ones = [dp_check.ring_case(c, torch.device(DEVICE), group, reps=3) for c in cases]
    for i, (b, n, dtype) in enumerate(RING_CASES):
        want, direct = dense[i][0].float(), dense[i][1]
        info = {"case": f"B={b} N={n} M={n} H=4 D={HEAD_DIM}", "dtype": str(dtype)[6:]}
        for p, res in ((DP_SPLIT, [r["cases"][i] for r in ranks]), (1, [ones[i]])):
            errs = []
            for r in res:
                got = r["out"].to(DEVICE).float()
                errs.append({
                    "max_abs_err_dense": (got - want).abs().max().item(),
                    "rel_rms_err_dense": ((got - want).pow(2).mean().sqrt()
                                          / want.pow(2).mean().sqrt()).item(),
                    "rel_rms_err_direct": ((got - direct).pow(2).mean().sqrt()
                                           / direct.pow(2).mean().sqrt()).item(),
                    "bit_equal_dense": bool(torch.equal(r["out"].to(DEVICE), dense[i][0]))})
            info[f"P={p}"] = {"backend": "gloo" if p > 1 else "nccl", "errors": errs,
                              "launches": [r["launches"] for r in res],
                              "ms": [r["ms"] for r in res]}
            for e in errs:
                ok = (e["max_abs_err_dense"] <= RING_F32_TOL if dtype == torch.float32 else
                      e["rel_rms_err_dense"] <= RING_BF16_REL_RMS
                      and e["rel_rms_err_direct"] <= RING_BF16_REL_RMS)
                if not ok or (p == 1 and not e["bit_equal_dense"]):
                    raise AssertionError(f"ring attention P={p}: {info}")
            if [r["launches"] for r in res] != [p] * len(res):
                raise AssertionError(f"ring attention P={p}: launches {info}")
        launches[str(dtype)[6:]] = sum(info[f"P={DP_SPLIT}"]["launches"])
        print(f"  ring {json.dumps(info)}", flush=True)
    phase("21 ring attention (K1 partial mode; P=2 over gloo on the card, P=1 over NCCL)", t0,
          ranks_wall_s=f"{wall:.3f}")
    return rows, launches


def shard_inputs(nb, nv, seed):
    """A synthetic keypoint pair (``synthetic_request``, 800x600) padded to
    bucket nb: (1, nb, .) keypoints at 1e6 past nv, descriptors, valid."""
    req, _ = synthetic_request(seed, nv)
    out = []
    for side in "01":
        kp = np.full((1, nb, 2), 1e6, np.float32)
        kp[0, :nv] = req["keypoints" + side]
        de = np.zeros((1, nb, 256), np.float32)
        de[0, :nv] = req["descriptors" + side]
        va = np.zeros((1, nb), bool)
        va[0, :nv] = True
        out += [torch.from_numpy(kp), torch.from_numpy(de), torch.from_numpy(va)]
    return out


def shard_matcher(variables, dtype):
    cfg = MatcherConfig(attention_dtype=dtype, use_pallas_sinkhorn=True)
    model = GMatcher(cfg)
    load_variables(model, variables)
    return model.to(DEVICE).eval()


def timed_call(fn):
    """(result, ms) of one call, host clock around a synced call."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def shard_agreement(got, want, dtype, name):
    """kept equal, matches0 agreement and (f32) matching scores against the
    unsharded run; raises past the bars."""
    info = {"kept_equal": all(torch.equal(got[k].cpu(), want[k].cpu()) for k in ("kept0", "kept1")),
            "matches0_agreement": (got["matches0"].cpu() == want["matches0"].cpu())
            .float().mean().item(),
            "max_score_diff": (got["matching_scores0"].cpu() - want["matching_scores0"].cpu())
            .abs().max().item(),
            "matches": int((got["matches0"] >= 0).sum())}
    ok = (info["kept_equal"] and info["matches0_agreement"] >= SHARD_AGREE[dtype]
          and info["matches"] > 0 and bool(torch.isfinite(got["matching_scores0"]).all())
          and (dtype != "float32" or info["max_score_diff"] <= SHARD_SCORE_TOL))
    if not ok:
        raise AssertionError(f"sharded {name} against the unsharded port: {info}")
    return info


def shard_config_call(name, nb):
    """(AGCConfig, forward_match's other arguments) of a configuration of
    SHARD_CONFIGS at bucket nb."""
    extra = {"compact_to": nb // 2} if name == "compact" else {}
    return AGCConfig(**STAGED_KNOBS, **SHARD_CONFIGS[name]), extra


def stacked(args):
    """The two sides of a pair's (kpts, descs, valid) stacked, as
    forward_match runs its AGC."""
    return [torch.cat([args[i], args[i + 3]]) for i in range(3)]


def shard_config_references(variables, inputs):
    """The unsharded port at each configuration and bucket: its output, its
    AGC's adjacency and kept (stacked sides; none for compaction, whose AGC
    is the dense build's), its ms, launches and peak memory above what was
    held before the call."""
    want, info = {}, {}
    for nb, _, dt in SHARD_CASES:
        model = shard_matcher(variables, dt)
        args = [x.to(DEVICE) for x in inputs[nb]]
        for name in SHARD_CONFIGS:
            acfg, extra = shard_config_call(name, nb)

            def run():
                return pipeline.forward_match(model, acfg, *args, FUSED_FRAME, **extra)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            out, ms = timed_call(run)
            launches = counts()
            peak = torch.cuda.max_memory_allocated()
            if differs(launches, match_counts(NUM_LAYERS, 1, 1)):
                raise AssertionError(f"unsharded {name} {nb}: launches {launches}")
            want[(name, nb)] = {"out": {k: v.cpu() for k, v in out.items()}}
            if name != "compact":
                adj, kept, _ = pipeline.run_agc(*stacked(args), acfg)
                # the card keeps the larger bucket's for the NCCL check
                want[(name, nb)].update(adj=adj if nb == SHARD_CASES[-1][0] else adj.cpu(),
                                        kept=kept.cpu())
            info[(name, nb)] = {"unsharded": {"ms": ms, "peak_bytes": peak,
                                              "temp_bytes": peak - base, "launches": launches,
                                              "matches": int((out["matches0"] >= 0).sum())}}
            del out
        del model, args
    return want, info


def shard_config_jobs(variables, inputs):
    """The gloo ranks' jobs of SHARD_CONFIGS at the first bucket: the
    sharded call of each (make_forward_match_sharded, or forward_match with
    shard_axis where it compacts), then each AGC build."""
    nb, _, dt = SHARD_CASES[0]
    jobs = []
    for name in SHARD_RUNS:
        acfg, extra = shard_config_call(name, nb)
        jobs.append({"kind": "axis" if extra else "match", "kwargs": extra,
                     "mcfg": MatcherConfig(attention_dtype=dt, use_pallas_sinkhorn=True),
                     "variables": variables, "acfg": acfg, "inputs": inputs[nb],
                     "image_shape": FUSED_FRAME})
    for name in SHARD_RUNS:
        if name != "compact":
            jobs.append({"kind": "agc", "acfg": shard_config_call(name, nb)[0],
                         "inputs": stacked(inputs[nb])})
    return jobs


def shard_config_ranks(results, want, info):
    """The gloo ranks' results of ``shard_config_jobs`` against the
    unsharded port: every rank bit-equal, kept equal and the matches at the
    phase's bars, 18 K1 partial launches a ring step, each rank's peak
    memory under SHARD_MEMORY_SHARE of the unsharded run's, and the AGC's
    adjacency rows and kept equal (the band run to both of its references)."""
    nb, _, dt = SHARD_CASES[0]
    names = SHARD_RUNS
    builds = [n for n in names if n != "compact"]
    for j, name in enumerate(names):
        got = [r[j] for r in results]
        for g in got[1:]:
            for key, value in got[0]["out"].items():
                if not torch.equal(g["out"][key], value):
                    raise AssertionError(f"sharded {name} {nb}: the ranks' {key} differ")
        ref = info[(name, nb)]["unsharded"]
        row = {"backend": "gloo", "ranks_bit_equal": True, "ms": [g["ms"] for g in got],
               "peak_bytes": [g["peak_bytes"] for g in got],
               "temp_share": [g["temp_bytes"] / ref["temp_bytes"] for g in got],
               "partial_launches": [g["partial_launches"] for g in got],
               **shard_agreement(got[0]["out"], want[(name, nb)]["out"], dt,
                                 f"{name} P={DP_SPLIT} {nb}")}
        for ref in shard_references(name)[1:]:
            row[f"against_{ref}"] = shard_agreement(got[0]["out"], want[(ref, nb)]["out"], dt,
                                                    f"{name} as {ref} P={DP_SPLIT} {nb}")
        if row["partial_launches"] != [NUM_LAYERS * DP_SPLIT] * DP_SPLIT:
            raise AssertionError(f"sharded {name} {nb}: K1 partial launches {row}")
        if max(row["temp_share"]) > SHARD_MEMORY_SHARE:
            raise AssertionError(f"sharded {name} {nb}: a rank's peak memory {row}")
        if name in builds:
            g = [r[len(names) + builds.index(name)] for r in results]
            adj = torch.cat([x["adj"] for x in g], dim=1)
            row["adjacency_rows_equal"] = all(
                torch.equal(adj, want[(ref, nb)]["adj"])
                and all(torch.equal(x["kept"], want[(ref, nb)]["kept"]) for x in g)
                for ref in shard_references(name))
            if not row["adjacency_rows_equal"]:
                raise AssertionError(f"sharded {name} {nb}: AGC adjacency rows or kept differ")
        info[(name, nb)][f"P={DP_SPLIT}"] = row


def shard_config_nccl(model, args, want, info):
    """SHARD_CONFIGS at the larger bucket on a one-rank NCCL group (the
    sharded code's collectives on the card): forward_match(shard_axis=...)
    against the unsharded port, 18 K1 partial launches and no K1 or K2
    launch, and the sharded AGC's adjacency and kept equal to the unsharded
    build's (the band run to both of its references)."""
    nb, _, dt = SHARD_CASES[-1]
    with nccl_world_one() as group:
        for name in SHARD_RUNS:
            acfg, extra = shard_config_call(name, nb)

            def run():
                return pipeline.forward_match(model, acfg, *args, FUSED_FRAME, shard_axis=group,
                                              **extra)
            reset_counts()
            out, first_ms = timed_call(run)
            partial = cuda_attention.partial_launches
            c = counts()
            row = {"backend": "nccl", "ms_first_call": first_ms, "ms": timed_call(run)[1],
                   "partial_launches": partial,
                   **shard_agreement(out, want[(name, nb)]["out"], dt, f"{name} P=1 {nb}")}
            for ref in shard_references(name)[1:]:
                row[f"against_{ref}"] = shard_agreement(out, want[(ref, nb)]["out"], dt,
                                                        f"{name} as {ref} P=1 {nb}")
            if partial != NUM_LAYERS or c["attention"] or c["sinkhorn"]:
                raise AssertionError(f"sharded {name} P=1 {nb}: launches {c}, partial {partial}")
            del out
            if name != "compact":
                adj, kept, _ = pipeline.run_agc(*stacked(args), acfg, group=group)
                refs = [want[(r, nb)] for r in shard_references(name)]
                row["adjacency_rows_equal"] = all(torch.equal(adj, ref["adj"])
                                                  and torch.equal(kept.cpu(), ref["kept"])
                                                  for ref in refs)
                del adj, kept
                for ref in refs:
                    ref.pop("adj")
                if not row["adjacency_rows_equal"]:
                    raise AssertionError(f"sharded {name} P=1 {nb}: AGC adjacency or kept differ")
            torch.cuda.empty_cache()
            info[(name, nb)]["P=1"] = row


def shard_phase(variables):
    """forward_match with its keypoint axis split over ranks, against the
    unsharded port: at each case the unsharded port (K1, K2, the label
    kernel), then make_forward_match_sharded over two gloo ranks sharing the
    card; at 16384 also over a one-rank NCCL group. Then K1's partial mode
    at the ring steps' shapes."""
    t0 = time.perf_counter()
    acfg = AGCConfig(**STAGED_KNOBS)
    inputs = {nb: shard_inputs(nb, nv, SHARD_SEED + nb) for nb, nv, _ in SHARD_CASES}
    want, info = {}, {}
    for nb, nv, dt in SHARD_CASES:
        model = shard_matcher(variables, dt)
        args = [x.to(DEVICE) for x in inputs[nb]]
        # the ranks of make_forward_match_sharded's default, passed to both
        k0, k1 = (pipeline.percentile_rank(v.sum(dim=1), acfg.percentile) for v in args[2::3])

        def unsharded():
            return pipeline.forward_match(model, acfg, *args, FUSED_FRAME, k0=k0, k1=k1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        with record_labels(f"sharded_reference_{nb}"):
            out, first_ms = timed_call(unsharded)
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        if differs(launches, match_counts(NUM_LAYERS, 1, 1)):
            raise AssertionError(f"unsharded {nb}: launches {launches}")
        want[nb] = {k: v.cpu() for k, v in out.items()}
        info[nb] = {"case": f"bucket {nb}, {nv} valid a side, {dt}",
                    "unsharded": {"ms_first_call": first_ms, "ms": timed_call(unsharded)[1],
                                  "peak_bytes": peak, "temp_bytes": peak - base,
                                  "launches": launches,
                                  "matches": int((out["matches0"] >= 0).sum())}}
        del model, out, args
    torch.cuda.empty_cache()
    cwant, cinfo = shard_config_references(variables, inputs)

    jobs = [{"kind": "match", "mcfg": MatcherConfig(attention_dtype=dt, use_pallas_sinkhorn=True),
             "variables": variables, "acfg": acfg, "inputs": inputs[nb],
             "image_shape": FUSED_FRAME, "reps": 1} for nb, _, dt in SHARD_CASES]
    n_main = len(jobs)
    jobs += shard_config_jobs(variables, inputs)
    with tempfile.TemporaryDirectory(prefix="gims_shard_") as tmp:
        t = time.perf_counter()
        ranks = dp_check.run(shard_check.shard_rank, [DEVICE + ":0"] * DP_SPLIT, "gloo",
                             {"jobs": jobs}, tmp)
        wall = time.perf_counter() - t
    leaked = [m for r in ranks for m in r["modules"] if m in ("jax", "gims_tpu")]
    if leaked:
        raise AssertionError(f"a rank imported {leaked}")
    launches = {}
    for j, (nb, nv, dt) in enumerate(SHARD_CASES):
        got = [r["jobs"][j] for r in ranks]
        for g in got[1:]:
            for key, value in got[0]["out"].items():
                if not torch.equal(g["out"][key], value):
                    raise AssertionError(f"sharded {nb}: the ranks' {key} differ")
        row = {"backend": "gloo", "ranks_bit_equal": True,
               "ms_first_call": [g["ms"] for g in got], "ms": [g["ms_per_call"] for g in got],
               "peak_bytes": [g["peak_bytes"] for g in got],
               "temp_bytes": [g["temp_bytes"] for g in got],
               "temp_share": [g["temp_bytes"] / info[nb]["unsharded"]["temp_bytes"] for g in got],
               "partial_launches": [g["partial_launches"] for g in got],
               **shard_agreement(got[0]["out"], want[nb], dt, f"P={DP_SPLIT} {nb}")}
        if row["partial_launches"] != [NUM_LAYERS * DP_SPLIT] * DP_SPLIT:
            raise AssertionError(f"sharded {nb}: K1 partial launches {row}")
        if nb == SHARD_CASES[-1][0] and max(row["temp_share"]) > SHARD_MEMORY_SHARE:
            raise AssertionError(f"sharded {nb}: a rank's peak memory {row}")
        info[nb][f"P={DP_SPLIT}"] = row
        launches[dt] = sum(row["partial_launches"])
    shard_config_ranks([r["jobs"][n_main:] for r in ranks], cwant, cinfo)

    nb, nv, dt = SHARD_CASES[-1]
    model = shard_matcher(variables, dt)
    args = [x.to(DEVICE) for x in inputs[nb]]
    with nccl_world_one() as group:
        call = make_forward_match_sharded(model, acfg, group, FUSED_FRAME)
        reset_counts()
        out, first_ms = timed_call(lambda: call(*args))
        nccl_launches = cuda_attention.partial_launches
        row = {"backend": "nccl", "ms_first_call": first_ms,
               "ms": timed_call(lambda: call(*args))[1], "partial_launches": nccl_launches,
               **shard_agreement(out, want[nb], dt, f"P=1 {nb}")}
    if nccl_launches != NUM_LAYERS or counts()["attention"] or counts()["sinkhorn"]:
        raise AssertionError(f"sharded P=1 {nb}: launches {counts()}, partial {nccl_launches}")
    info[nb]["P=1"] = row
    launches["nccl"] = nccl_launches
    del out
    torch.cuda.empty_cache()
    shard_config_nccl(model, args, cwant, cinfo)
    del model, args
    torch.cuda.empty_cache()
    for nb, *_ in SHARD_CASES:
        print(f"  shard {json.dumps(info[nb])}", flush=True)
    for key, row in cinfo.items():
        print(f"  shard_config {json.dumps({'config': key[0], 'bucket': key[1], **row})}",
              flush=True)

    # K1's partial mode at the ring steps' shapes: P=2 (N/2 against M/2) and
    # the one-rank ring (N against M)
    partial = {"float32": partial_row(2, SHARD_CASES[0][0] // DP_SPLIT, torch.float32, 2207),
               "bfloat16": partial_row(2, SHARD_CASES[1][0] // DP_SPLIT, torch.bfloat16, 2208),
               "nccl": partial_row(2, SHARD_CASES[1][0], torch.bfloat16, 2209)}
    torch.cuda.empty_cache()
    phase("22 keypoint-axis sharding (forward_match over 2 gloo ranks sharing the card and a "
          "one-rank NCCL group, against the unsharded port)", t0, ranks_wall_s=f"{wall:.3f}")
    return partial, launches, info[SHARD_CASES[-1][0]]["unsharded"]["launches"]


# ---------------------------------------------------------------- entry points

class record_kernel_shapes:
    """Within the block, the shapes the K1 and K2 wrappers are called with:
    K1 (B, N, M, masked keys of item 0, dtype, H, D), K2 (rows, cols of the
    scores, valid rows and columns per item, iterations)."""

    def __enter__(self):
        self.attention, self.sinkhorn = [], []
        self.real = (cuda_attention.masked_attention_cuda,
                     cuda_sinkhorn.log_optimal_transport_cuda)
        real_attn, real_sk = self.real

        def attn(q, k, v, key_mask):
            b, n, h, d = q.shape
            shape = (b, n, k.shape[1], int((~key_mask[0]).sum()), str(q.dtype)[6:], h, d)
            if shape not in self.attention:
                self.attention.append(shape)
            return real_attn(q, k, v, key_mask)

        def sk(scores, alpha, iters, row_mask, col_mask):
            shape = (scores.shape[1], scores.shape[2], tuple(row_mask.sum(1).tolist()),
                     tuple(col_mask.sum(1).tolist()), int(iters))
            if shape not in self.sinkhorn:
                self.sinkhorn.append(shape)
            return real_sk(scores, alpha, iters, row_mask, col_mask)

        cuda_attention.masked_attention_cuda = attn
        cuda_sinkhorn.log_optimal_transport_cuda = sk
        return self

    def __exit__(self, *exc):
        cuda_attention.masked_attention_cuda, cuda_sinkhorn.log_optimal_transport_cuda = self.real


def reference_gmatcher_state_dict(variables, layers=NUM_LAYERS):
    """A GMatcher's variables (the JAX layout) rewritten as the reference's
    torch state_dict (models/gmatcher.py:165-217: Conv1d kernels (O, I, 1),
    BatchNorm1d with running stats, DGL's SAGEConv with its bias on the conv
    module), the inverse of convert_gmatcher_torch."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))

    def dense(tp, node, conv=True):
        w = np.asarray(node["kernel"]).T
        sd[f"{tp}.weight"] = tensor(w[:, :, None] if conv else w)
        if "bias" in node:
            sd[f"{tp}.bias"] = tensor(node["bias"])

    def mlp(tp, node, st, n):
        for i in range(n):
            dense(f"{tp}.{3 * i}", node[f"dense_{i}"])
            if i < n - 1:
                norm, run = node[f"norm_{i}"], st[f"norm_{i}"]
                sd[f"{tp}.{3 * i + 1}.weight"] = tensor(norm["scale"])
                sd[f"{tp}.{3 * i + 1}.bias"] = tensor(norm["bias"])
                sd[f"{tp}.{3 * i + 1}.running_mean"] = tensor(run["mean"])
                sd[f"{tp}.{3 * i + 1}.running_var"] = tensor(run["var"])
                sd[f"{tp}.{3 * i + 1}.num_batches_tracked"] = torch.tensor(1)

    mlp("kenc.encoder", params["kenc"]["encoder"], stats["kenc"]["encoder"], 5)
    for n in range(layers):
        node = params["gnn"][f"layer_{n}"]
        for j, name in enumerate(("proj_q", "proj_k", "proj_v")):
            dense(f"gnn.layers.{n}.attn.proj.{j}", node["attn"][name])
        dense(f"gnn.layers.{n}.attn.merge", node["attn"]["merge"])
        mlp(f"gnn.layers.{n}.mlp", node["mlp"], stats["gnn"][f"layer_{n}"]["mlp"], 2)
    for i in range(3):
        node = params["gnn_encoder"][f"layer_{i}"]
        dense(f"gnn_encoder.layers.{i}.fc_self", node["fc_self"], conv=False)
        dense(f"gnn_encoder.layers.{i}.fc_neigh", node["fc_neigh"], conv=False)
        sd[f"gnn_encoder.layers.{i}.bias"] = tensor(node["bias"])
    dense("final_proj", params["final_proj"])
    sd["bin_score"] = tensor(params["bin_score"]).reshape(())
    return sd


def post(port, fields, path="/find_matches"):
    """One multipart POST to the local server: (status, headers, body)."""
    import http.client

    from gims_tpu_torch.cli.serve_cli import encode_multipart

    body, ctype = encode_multipart(fields)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def same_prediction(a, b, name, agree=1.0):
    """Keypoints equal; matches0 equal on at least `agree` of the rows.
    Returns that share."""
    for key in ("keypoints0", "keypoints1"):
        if not np.array_equal(np.asarray(a[key]), np.asarray(b[key])):
            raise AssertionError(f"{name}: {key} differs from the direct call's")
    share = float(np.mean(np.asarray(a["matches0"]) == np.asarray(b["matches0"])))
    if not share >= agree:
        raise AssertionError(f"{name}: matches0 equal on {share} of the rows, "
                             f"the direct call's, < {agree}")
    return share


def entry_phase(smi):
    """Phase 23: the entry points a user calls, on JPEG files made here."""
    from gims_tpu_torch.cli import match_pair_cli, serve_cli
    from gims_tpu_torch.core import image_io
    from gims_tpu_torch.eval.viz import draw_matches
    from gims_tpu_torch.matcher.convert import convert_gmatcher_torch

    t0 = time.perf_counter()
    card = smi  # nvidia-smi's name and power limit
    launches, shapes = {}, {}
    with tempfile.TemporaryDirectory(prefix="gims_entry_") as tmp:
        # (a) JPEG on the card
        img0, img1, H = synthetic_image_pair(ENTRY_SEED, ENTRY_FRAME, colour=True)
        t = time.perf_counter()
        jpeg0 = image_io.encode_jpeg(img0)
        encode_ms = 1e3 * (time.perf_counter() - t)
        jpeg1 = image_io.encode_jpeg(img1)
        paths = [os.path.join(tmp, f"{i}.jpg") for i in range(2)]
        for path, data in zip(paths, (jpeg0, jpeg1)):
            with open(path, "wb") as f:
                f.write(data)
        image_io.decode_jpeg(jpeg0, device=DEVICE)  # warm-up
        t = time.perf_counter()
        dec_card = image_io.decode_jpeg(jpeg0, device=DEVICE)
        decode_ms = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        dec_cpu = image_io.decode_jpeg(jpeg0, device="cpu")
        decode_cpu_ms = 1e3 * (time.perf_counter() - t)
        gray_same = np.array_equal(image_io.decode_jpeg(jpeg1, image_io.IMREAD_GRAYSCALE, DEVICE),
                                   image_io.decode_jpeg(jpeg1, image_io.IMREAD_GRAYSCALE, "cpu"))
        if not (np.array_equal(dec_card, dec_cpu) and gray_same):
            raise AssertionError("JPEG decoded on the card differs from the CPU's decode")
        print(f"  entry jpeg {json.dumps({'frame': ENTRY_FRAME, 'bytes': len(jpeg0), 'encode_ms': encode_ms, 'decode_card_ms': decode_ms, 'decode_cpu_ms': decode_cpu_ms, 'max_abs_err_to_source': int(np.abs(dec_cpu.astype(int) - img0).max()), 'card': card})}",
              flush=True)
        decoded = [image_io.imread(p, device=DEVICE) for p in paths]

        # (b) match_pair_cli in-process, against a direct call
        for name, flags in ENTRY_CLI.items():
            npz, out = os.path.join(tmp, f"{name}.npz"), os.path.join(tmp, f"{name}.png")
            argv = [*paths, *flags, "--npz", npz, "--out", out, "--device", DEVICE]
            args = match_pair_cli.build_parser().parse_args(argv)
            key = "_match_pair_path" if name == "staged" else "_match_pair_fused_path"
            reset_counts()
            t = time.perf_counter()
            with record_labels(key[1:-5]), record_kernel_shapes() as rec:
                match_pair_cli.main(argv)
            cli_s = time.perf_counter() - t
            cli_counts = counts()
            direct = entry_matcher(name, args)
            reset_counts()
            pred = match_pair_cli.run(direct, *decoded, args)
            direct_counts = counts()
            saved = np.load(npz)
            agree = same_prediction(
                {"keypoints0": saved["keypoints0"], "keypoints1": saved["keypoints1"],
                 "matches0": saved["matches"]},
                {k: pred[k][0] for k in ("keypoints0", "keypoints1", "matches0")},
                f"match_pair {name}", ENTRY_AGREE[name])
            if cli_counts != direct_counts or min(cli_counts[k] for k in MATCH_KERNELS) < 1:
                raise AssertionError(f"match_pair {name}: launches {cli_counts}, the direct "
                                     f"call's {direct_counts}")
            valid = pred["matches0"][0] > -1
            cli_valid = saved["matches"] > -1  # the drawing of the CLI's own prediction
            want = draw_matches(*decoded, saved["keypoints0"][cli_valid],
                                saved["keypoints1"][saved["matches"][cli_valid]])
            with open(out, "rb") as f:
                if not np.array_equal(image_io.decode_png(f.read()), want):
                    raise AssertionError(f"match_pair {name}: --out is not draw_matches")
            share = correct_share(pred, H)
            if name == "staged" and not share >= ENTRY_SHARE:
                raise AssertionError(f"match_pair staged: {share} of matches within 3 px")
            launches[key], shapes[key] = cli_counts, rec
            print(f"  entry match_pair {json.dumps({'config': name, 'seconds': cli_s, 'keypoints': [int(len(pred['keypoints0'][0])), int(len(pred['keypoints1'][0]))], 'matches': int(valid.sum()), 'matches_equal_share': agree, 'correct_share': share, 'launches': cli_counts, 'card': card})}",
                  flush=True)
            del direct

        # (c) .pt checkpoints in the reference's layout: the staged checkpoint
        # rewritten so (a seeded random matcher matches nothing at 0.02)
        sd = reference_gmatcher_state_dict(load_gims_checkpoint(WEIGHTS))
        forms = {"ema": {"ema": sd}, "model": {"model": {"module." + k: v for k, v in sd.items()}},
                 "bare": sd}
        direct = Matching({**ENTRY_STAGED_CONFIG}, variables=convert_gmatcher_torch(sd),
                          device=DEVICE)
        args = match_pair_cli.build_parser().parse_args([*paths, *ENTRY_CLI["staged"]])
        want = match_pair_cli.run(direct, *decoded, args)
        del direct
        agree = {}
        for form, obj in forms.items():
            pt = os.path.join(tmp, f"{form}.pt")
            torch.save(obj, pt)
            npz = os.path.join(tmp, f"{form}.npz")
            match_pair_cli.main([*paths, "--descriptor_source", "sift", "--weights_path", pt,
                                 "--npz", npz, "--out", os.path.join(tmp, f"{form}.png"),
                                 "--device", DEVICE])
            saved = np.load(npz)
            agree[form] = same_prediction(
                {"keypoints0": saved["keypoints0"], "keypoints1": saved["keypoints1"],
                 "matches0": saved["matches"]},
                {k: want[k][0] for k in ("keypoints0", "keypoints1", "matches0")},
                f".pt {form}", ENTRY_AGREE["staged"])
        n_match = int((want["matches0"][0] > -1).sum())
        if n_match < 1:
            raise AssertionError(".pt checkpoints: the direct call matched nothing")
        print(f"  entry checkpoints {json.dumps({'forms': list(forms), 'matches': n_match, 'matches_equal_share': agree})}",
              flush=True)

        # (d) the HTTP server, staged then fused
        small0, small1, _ = synthetic_image_pair(ENTRY_SEED + 1, ENTRY_SMALL, colour=True)
        small = (image_io.encode_jpeg(small0), image_io.encode_jpeg(small1))
        requests = [({"image0": jpeg0, "image1": jpeg1}, True),
                    ({"image0": small[0], "image1": small[1]}, True),
                    ({"image0": small[0], "image1": small[1], "resize_enabled": b"0"}, False)]
        for name, fused_flag, weights in (("staged", False, WEIGHTS),
                                          ("fused", True, E2E_WEIGHTS)):
            server = serve_cli.make_server(0, weights, fused=fused_flag, device=DEVICE)
            port = server.server_address[1]
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            try:
                status, _, _ = post(port, requests[0][0])  # warm-up
                if status != 200:
                    raise AssertionError(f"serve {name}: warm-up answered {status}")
                bad_path, _, _ = post(port, requests[0][0], "/elsewhere")
                bad_upload, _, _ = post(port, {"image0": b"not an image", "image1": jpeg1})
                if (bad_path, bad_upload) != (404, 500):
                    raise AssertionError(f"serve {name}: wrong path {bad_path}, garbage "
                                         f"upload {bad_upload}; expected 404 and 500")
                key = "_serve_path" if name == "staged" else "_serve_fused_path"
                reset_counts()
                answers, ms = [], []
                with record_labels(key[1:-5]), record_kernel_shapes() as rec:
                    for fields, _ in requests:
                        t = time.perf_counter()
                        answers.append(post(port, fields))
                        ms.append(1e3 * (time.perf_counter() - t))
                served = counts()
                split = []  # where a request's time goes, from the in-process calls
                for (fields, resize), (status, headers, body) in zip(requests, answers):
                    if status != 200 or headers.get("Content-Type") != "image/png":
                        raise AssertionError(f"serve {name}: answered {status}")
                    details = json.loads(headers["X-Match-Details"])
                    t = time.perf_counter()
                    ims = [image_io.imdecode(fields[k], device=DEVICE)
                           for k in ("image0", "image1")]
                    t_decode = time.perf_counter()
                    viz, want = serve_cli.find_matches(server.matcher, *ims, resize)
                    t_find = time.perf_counter()
                    png = image_io.encode_png(viz)
                    t_png = time.perf_counter()
                    split.append({"decode_ms": 1e3 * (t_decode - t),
                                  "matcher_ms": 1e3 * want["seconds"],
                                  "resize_and_draw_ms": 1e3 * (t_find - t_decode - want["seconds"]),
                                  "png_ms": 1e3 * (t_png - t_find)})
                    if (any(details[k] != want[k] for k in ("keypoints0", "keypoints1"))
                            or abs(details["matches"] - want["matches"])
                            > ENTRY_COUNT_SLACK * want["matches"]):
                        raise AssertionError(f"serve {name}: {details} against in-process {want}")
                    served_png = image_io.decode_png(body)
                    if served_png.shape != viz.shape or (
                            details["matches"] == want["matches"] and png != body):
                        raise AssertionError(f"serve {name}: the PNG is not find_matches' drawing")
            finally:
                server.shutdown()
                server.server_close()
                thread.join()
            if min(served[k] for k in MATCH_KERNELS) < 1:
                raise AssertionError(f"serve {name}: launches {served}")
            launches[key], shapes[key] = served, rec
            print(f"  entry serve {json.dumps({'config': name, 'ms_per_request': ms, 'matches': [json.loads(a[1]['X-Match-Details'])['matches'] for a in answers], 'launches': served, 'in_process_split': split, 'card': card})}",
                  flush=True)
            del server
            torch.cuda.empty_cache()
    phase("23 entry points", t0, encode_ms=f"{encode_ms:.1f}", decode_card_ms=f"{decode_ms:.1f}")
    return launches, shapes


def segsum_call(values, slots, num):
    """The aten ops and the kernel launches the wrapper counted of one
    segment_sum_rows_cuda call. No profiler trace: in this script's process
    a trace of one call holds no device event (PERF.md §6, PR 17);
    tests/test_torch_cuda.py holds the call's trace to one kernel."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    torch.cuda.synchronize()
    before = segsum.launches
    with Record():
        segsum.segment_sum_rows_cuda(values, slots, num)
    torch.cuda.synchronize()
    return ops, segsum.launches - before


def segsum_rows(path_launches):
    """The segmented-sum kernel at each caller's rows on the path named in
    SEGSUM_ROWS (recorded on the host in its untimed first call): equal to
    the CPU's sequential sum (index_add_ there, the plain version) on two
    runs; one call one launch and no sort: the only aten op it runs is the
    output's allocation (no op that launches a kernel) and its wrapper
    counts one launch of csrc/segsum.cu, whose C entry launches one kernel;
    its time beside the plain version's on the
    CPU and index_add_'s atomics on the card over the same flat slots (both
    device times of a CUDA graph of the call, eager calls' times beside); its
    bound: each value (4 B) and slot (the caller's 2 or 4 B; a shared slot
    list once) read once and each out (4 B) written once, beside the bound
    of the earlier sort route's definition (12 B a value: key, permutation
    entry and value; 4 B a slot); the launches of that path's run."""
    rows = []
    for key, (tag, path) in SEGSUM_ROWS.items():
        if key not in SEGSUM_INPUTS:
            raise AssertionError(f"segsum: no input of {tag} was recorded on {path}")
        values_h, slots_h, num, shared = SEGSUM_INPUTS[key]
        r, w = values_h.shape
        values, slots = values_h.to(DEVICE), slots_h.to(DEVICE)
        if shared:
            slots, slots_h = slots.expand(r, -1), slots_h.expand(r, -1)
        want = segsum.segment_sum_rows_plain(values_h, slots_h, num)
        runs = [segsum.segment_sum_rows_cuda(values, slots, num) for _ in range(2)]
        torch.cuda.synchronize()
        err = max(float((x.cpu() - want).abs().max()) for x in runs)
        if not all(torch.equal(x.cpu(), want) for x in runs):
            raise AssertionError(f"segsum {key}: differs from the CPU's sequential sum ({err})")
        launches = path_launches[path][f"segsum_{tag}"]
        if launches < 1:
            raise AssertionError(f"segsum {key}: {path} launched it {launches} times")
        ops, launched = segsum_call(values, slots, num)
        sorts = [o for o in ops if "sort" in o or "searchsorted" in o]
        if ops != ["aten.empty.memory_format"] or launched != 1:
            raise AssertionError(f"segsum {key}: one call ran ops {ops}, {launched} launches")
        n = values.numel()
        slot_bytes = slots.element_size() * (w if shared else n)
        bnd, by = bound_ms(4 * n + slot_bytes + 4 * r * num, n, torch.float32)
        flat = (slots.long() + num * torch.arange(r, device=DEVICE)[:, None]).reshape(-1)
        flat_values = values.reshape(-1)
        call = lambda: segsum.segment_sum_rows_cuda(values, slots, num)  # noqa: E731
        library = lambda: torch.zeros(r * num, device=DEVICE).index_add_(  # noqa: E731
            0, flat, flat_values)
        ms, lib_ms = graph_ms(call), graph_ms(library)
        eager_ms, lib_eager_ms = cuda_ms(call), cuda_ms(library)
        rows.append({"name": f"segment_sum_{key}", "route": "cuda",
                     "source": "gims_tpu_torch/csrc/segsum.cu",
                     "replaces": "none: index_add_/scatter_add_ atomics of the port where JAX's "
                                 "segment sums are deterministic (frontend/sift.py, "
                                 "agc/graph.py, matcher/pipeline.py)",
                     "path": path, "shape": f"{r} rows of {w} values into {num} slots each",
                     "slots": f"{slots.dtype}"[6:] + (", one list for every row" if shared
                                                      else ""),
                     "launches": launches, "max_abs_err": err,
                     "two_runs_equal": torch.equal(runs[0], runs[1]),
                     "launches_per_call": launched, "aten_ops_per_call": ops,
                     "sort_ops_per_call": len(sorts),
                     "ms": ms, "timed": "device, CUDA graph replays", "eager_ms": eager_ms,
                     "plain_ms": host_ms(lambda: segsum.segment_sum_rows_plain(values_h, slots_h,
                                                                               num)),
                     "plain_on": "cpu", "bound_ms": bnd, "bound_by": by, "bound_share": bnd / ms,
                     "sort_route_bound_ms": bound_ms(12 * n + 4 * r * num, n, torch.float32)[0],
                     "library_ms": lib_ms, "ratio_to_library": ms / lib_ms,
                     "library_eager_ms": lib_eager_ms,
                     "library": "torch.Tensor.index_add_ (atomics)"})
        print(f"  segsum {json.dumps(rows[-1])}", flush=True)
    return rows


def tools_phase(smi):
    """Phase 24: parameter_search, USAC, the native library, the viewer and
    the reports on the entry pair."""
    from gims_tpu_torch.core import image_io
    from gims_tpu_torch.eval.usac import find_homography_usac
    from gims_tpu_torch.native import bridge
    from gims_tpu_torch.tools import image_viewer, parameter_search, parameter_visualize

    t0 = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="gims_tools_") as tmp:
        img0, img1, _ = synthetic_image_pair(ENTRY_SEED, ENTRY_FRAME, colour=True)
        paths = [os.path.join(tmp, f"{i}.png") for i in range(2)]
        for path, img in zip(paths, (img0, img1)):
            image_io.imwrite(path, img)
        # (a) the sweep: the rows one by one, each with its own launch counts
        matcher = Matching(TOOLS_CONFIG, device=DEVICE)
        ims = [image_io.imread(p) for p in paths]
        out = os.path.join(tmp, "search", "0_1")
        os.makedirs(out)
        parameter_search.search_process(matcher, TOOLS_PARAMS[0], *ims, "0", "1", tmp)  # warm-up
        reset_counts()
        rows, per_row = [], []
        with record_labels("tools_search"), record_kernel_shapes() as shapes:
            for param in TOOLS_PARAMS:
                before = counts()
                t = time.perf_counter()
                rows.append(parameter_search.search_process(matcher, param, *ims, "0", "1", out))
                ms = 1e3 * (time.perf_counter() - t)
                grew = {k: v - before[k] for k, v in counts().items()}
                if min(grew[k] for k in MATCH_KERNELS) < 1:
                    raise AssertionError(f"parameter_search {param}: launches {grew}")
                per_row.append({"param": param, "ms": ms, "launches": grew,
                                "correct": rows[-1][3], "total": rows[-1][4]})
        launches["_tools_search_path"] = counts()
        with open(os.path.join(out, "record.txt")) as f:
            if len(f.read().splitlines()) != len(TOOLS_PARAMS):
                raise AssertionError("parameter_search: record.txt lacks rows")
        if any(r[3] < 1 for r in rows):
            raise AssertionError(f"parameter_search: a row counted no inlier: {rows}")
        print(f"  tools search {json.dumps({'rows': per_row, 'card': smi})}", flush=True)
        # (b) USAC on the card and on the CPU on the same matches
        pred = matcher({"image0": ims[0][None], "image1": ims[1][None],
                        **dict(zip(("radius", "percentile", "min_size"), TOOLS_PARAMS[0])),
                        "return_descriptors": False})
        m = pred["matches0"][0]
        mk0 = np.float32(pred["keypoints0"][0][m > -1])
        mk1 = np.float32(pred["keypoints1"][0][m[m > -1]])
        usac = {}
        for dev in (DEVICE, "cpu"):
            t = time.perf_counter()
            found = find_homography_usac(mk0, mk1, device=dev)
            usac[dev] = (int(found[1].sum()), 1e3 * (time.perf_counter() - t))
        if usac[DEVICE][0] != usac["cpu"][0] or usac[DEVICE][0] != rows[0][3]:
            raise AssertionError(f"usac: card {usac[DEVICE]}, cpu {usac['cpu']}, row {rows[0]}")
        print(f"  tools usac {json.dumps({'matches': len(mk0), 'inliers': usac[DEVICE][0], 'card_ms': usac[DEVICE][1], 'cpu_ms': usac['cpu'][1]})}",
              flush=True)
        del matcher
        # (c) the native library: built with g++, a KNN case against numpy
        t = time.perf_counter()
        lib = bridge.build_library()
        build_s = time.perf_counter() - t
        rng = np.random.RandomState(0)
        qd, td = rng.randn(40, 16).astype(np.float32), rng.randn(50, 16).astype(np.float32)
        b = bridge.CPPbridge(lib)
        b.CreateMatcher(16, k=1, sim_thres=0.95)
        b.KnnMatch(rng.rand(40, 2).astype(np.float32), qd, rng.rand(50, 2).astype(np.float32), td)
        got = {(q, t_) for q, t_, _ in b.all_matches()}
        dist = np.linalg.norm(qd[:, None] - td[None], axis=-1)
        order = np.argsort(dist, axis=1)
        want = {(q, int(order[q, 0])) for q in range(40)
                if dist[q, order[q, 0]] <= 0.95 * dist[q, order[q, 1]]}
        if got != want or not got:
            raise AssertionError(f"native KNN: {sorted(got)} against numpy's {sorted(want)}")
        # (d) the headless viewer and the reports
        folders = [os.path.join(tmp, f) for f in ("gims", "dgims")]
        for folder in folders:
            os.makedirs(folder)
            for i, path in enumerate(paths):
                image_io.imwrite(os.path.join(folder, f"{i}.png"), image_io.imread(path))
        image_viewer.run_headless(folders, os.path.join(tmp, "grids"))
        grid = image_io.imread(os.path.join(tmp, "grids", "0.png"))
        if grid.shape != (720, 960, 3) or not np.array_equal(
                grid, image_viewer.compose_grid(folders, "0.png")):
            raise AssertionError("image_viewer: the headless grid is not compose_grid's")
        record = os.path.join(out, "record.txt")
        with open(parameter_visualize.render_report([record], os.path.join(tmp, "r.html"))) as f:
            report = f.read()
        with open(parameter_visualize.render_interactive([record], os.path.join(tmp, "d.html"))) as f:
            dash = f.read()
        if report.count("data:image/png;base64,") < 5 or '"0_1"' not in dash:
            raise AssertionError("parameter_visualize: a report lacks its plots or records")
    phase("24 tools", t0, native_build_s=f"{build_s:.1f}",
          launches=json.dumps(launches["_tools_search_path"]))
    return launches, shapes



def entry_matcher(name, args):
    """The direct call of `match_pair_cli`'s configuration `name`."""
    if name == "staged":
        return Matching(ENTRY_STAGED_CONFIG, variables=load_gims_checkpoint(WEIGHTS),
                        device=DEVICE)
    return fused.FusedMatching(ENTRY_FUSED_CONFIG, variables=load_gims_checkpoint(E2E_WEIGHTS),
                               total_keypoints=args.total_keypoints, device=DEVICE)


def entry_rows(attn, sk, lab, launches, shapes):
    """The `kernels` rows of the entry points: each kernel at the largest
    shape its path gave it (measured here where phases 2 and 3 did not),
    with the path's launches."""
    rows = []
    for key, c in launches.items():
        rec = shapes[key]
        b, n, m, tail, dtype, h, d = max(rec.attention, key=lambda s: s[0] * s[1] * s[2])
        a = attn.get((b, n, m, dtype)) if d == HEAD_DIM else None
        if a is None or a.get("ms") is None:
            a = attention_row(b, n, m, tail, getattr(torch, dtype), h, d)
        rows.append({"name": "masked_attention" + key, "route": "cuda",
                     "source": "gims_tpu_torch/csrc/attention.cu",
                     "replaces": "gims_tpu/matcher/pallas_attention.py:42", **a,
                     "path_shapes": [f"B={s[0]} N={s[1]} M={s[2]} {s[4]}" for s in rec.attention],
                     "launches": c["attention"], "kernel_ms": a["ms"]})
        nb, nb1, n0, n1, iters = max(rec.sinkhorn, key=lambda s: s[0] * s[1])
        s = sk.get((nb, len(n0), iters)) if nb == nb1 else None
        if s is None:
            s = sinkhorn_row(nb, list(n0), list(n1), iters, nb1=nb1)
        rows.append({"name": "sinkhorn_uv" + key, "route": "cuda",
                     "source": "gims_tpu_torch/csrc/sinkhorn.cu",
                     "replaces": "gims_tpu/matcher/pallas_sinkhorn.py:40", **s,
                     "launches": c["sinkhorn"], "kernel_ms": s["ms"], "library_ms": None,
                     "library": "none: no single PyTorch call computes the Sinkhorn "
                                "iterations' potentials"})
        rows.append(label_row(key, lab[key[1:-5]], c["label_rounds"]))
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def degrees(mode, edges, valid):
    """(B, N) degree of each node of the recorded graphs, 0 where invalid:
    dense rows less the diagonal; band forward plus backward edges; sparse
    the listed neighbours."""
    if mode == "dense":
        eye = torch.eye(edges.shape[1], dtype=torch.bool, device=edges.device)
        deg = torch.stack([(e & ~eye).sum(-1) for e in edges])
    elif mode == "band":
        deg = edges.sum(-1) + labels._band_shear_bwd(edges).sum(-1)
    else:
        deg = edges.sum(-1)
    return torch.where(valid, deg, 0)


def label_traffic(mode, edges, valid, run, p, listed):
    """A model of the bytes one launch moves to and from device memory in the
    kernel's design (its route from plan(), and each block's choice as the
    kernel reported it in labels.last_listed): what it reads of the edges,
    the bits (and dense degrees) it writes and rereads (once to list a
    block's rows, else once per round), valid and the labels."""
    b, n, w = edges.shape
    fixed = valid.numel() + 4 * b * n + 4 * b
    if not p["cluster"]:  # the edges once per round of the batch
        per_round = edges.numel() + (4 * edges.numel() if mode == "sparse" else 0)
        return fixed + max(run) * per_round
    if mode == "sparse":  # nbr_ok and nbr_idx every round
        return fixed + sum(run) * n * w * 5
    rows, cs = p["rows_per_block"], p["cluster_size"]
    # the rows of bits a block reads in one pass: its own, and for the band
    # the W before them
    span = [max(0, min(n, (k + 1) * rows) - k * rows) for k in range(cs)]
    if mode == "band":
        span = [s_ + min(w, k * rows) if s_ else 0 for k, s_ in enumerate(span)]
    passes = 1 if mode == "dense" else 2  # listing: dense from the degrees, band counts first
    words = 4 * ((n + 127) // 128) if mode == "dense" else (w + 31) // 32
    reads = sum((passes if listed[g][k] else passes - 1 + run[g]) * span[k]
                for g in range(b) for k in range(cs))
    written = 4 * b * n * (words + (mode == "dense"))  # the bits, the dense degrees
    return fixed + int(valid.sum()) * w + written + 4 * reads * words


def label_phase():
    """The label-rounds kernel against its plain version on the recorded
    inputs: labels and rounds run per graph equal; its route, the graphs'
    degrees, its time at the cap and at cap 0, against its bound."""
    t0 = time.perf_counter()
    rows = {}
    for path, (mode, edges, valid, rounds, nbr) in RECORDED.items():
        got = labels.propagate(mode, edges, valid, rounds, nbr)
        run = labels.last_rounds.tolist()
        listed = None if labels.last_listed is None else labels.last_listed.tolist()
        want = labels.propagate_plain(mode, edges, valid, rounds, nbr)
        want_run = labels.rounds_plain(mode, edges, valid, rounds, nbr).tolist()
        err = (got - want).abs().max().item()
        b, n, w = edges.shape
        p = labels.plan(mode, b, n, w, rounds)
        # the least the function must move: the edges of the valid nodes (an
        # invalid node keeps N whatever its row holds; sparse reads nbr_ok
        # and the int32 nbr_idx), valid, the labels written
        n_valid = int(valid.sum())
        nbytes = n_valid * w * (5 if mode == "sparse" else 1) + valid.numel() + 4 * b * n
        b_ms, b_by = bound_ms(nbytes, 0, torch.float32)
        deg = degrees(mode, edges, valid)
        moved = label_traffic(mode, edges, valid, run, p, listed)
        ms = cuda_ms(lambda: labels.propagate(mode, edges, valid, rounds, nbr))
        ms_one = cuda_ms(lambda: labels.propagate(mode, edges, valid, 0, nbr))
        row = {"path": path, "mode": mode, "shape": f"B={b} N={n} W={w}", "rounds_cap": rounds + 1,
               "rounds_run": run, "rounds_plain": want_run, "max_abs_err": err,
               "label_route": "cluster" if p["cluster"] else "global",
               "cluster_size": p["cluster_size"], "smem_bytes": p["smem_bytes"],
               "resident_clusters": p["resident_clusters"], "valid_nodes": n_valid,
               "mean_degree": deg.sum().item() / max(1, n_valid), "max_degree": int(deg.max()),
               "listed_share": (None if listed is None
                                else sum(map(sum, listed)) / (b * len(listed[0]))),
               "bound_ms": b_ms, "bound_by": b_by,
               # reading the edges once per round run, as the global route does
               "per_round_read_ms": 1e3 * max(run) * edges.numel() / HBM_BPS,
               "ms": ms, "bound_share": b_ms / ms,
               "one_round_ms": ms_one,
               "per_round_ms": (ms - ms_one) / (max(run) - 1) if max(run) > 1 else None,
               "plain_ms": cuda_ms(lambda: labels.propagate_plain(mode, edges, valid, rounds,
                                                                  nbr), 1),
               "library_ms": None,
               "model_bytes_moved": moved, "model_moved_ms": 1e3 * moved / HBM_BPS}
        print(f"  label rounds {json.dumps(row)}", flush=True)
        if err != 0 or run != want_run or not all(1 <= r <= rounds + 1 for r in run):
            raise AssertionError(f"label-rounds kernel against plain: {row}")
        rows[path] = row
    phase("13 label-rounds kernel vs plain", t0)
    return rows


def label_row(suffix, lab, launches):
    return {"name": "label_rounds" + suffix, "route": "cuda",
            "source": "gims_tpu_torch/csrc/labels.cu",
            # not a Pallas kernel: the lax.while_loop of the label rounds
            "replaces": "gims_tpu/agc/graph.py:167",
            # the modelled bytes stay on phase 13's line
            **{k: v for k, v in lab.items() if not k.startswith("model_")},
            "launches": launches, "kernel_ms": lab["ms"],
            # a launch is one AGC call: the cluster route's dense and band
            # layouts run label_pack_kernel, then label_cluster_kernel
            "kernels_per_launch": 2 if (lab["label_route"] == "cluster"
                                        and lab["mode"] != "sparse") else 1,
            "library": "none: no single PyTorch call labels connected components"}


def kernel_rows(attn, sk, lab, path_launches, partial, dp_train, ring_launches, shard):
    """The `kernels` line: K1, K2 and the label-rounds kernel at each path's
    shapes, with that path's main-run launch counts (the fused colour paths
    share devsift's K1 and K2 shapes: 4 pairs compacted to 6144); the label
    rounds of the data-parallel train steps (phase 20, their launches on the
    two ranks); K1's partial mode at the ring's step shapes (phase 21, its
    launches on the two ranks of the P=2 ring)."""
    no_library = ("none: no single PyTorch call computes the Sinkhorn "
                  "iterations' potentials")
    rows = []
    for suffix, attn_case, sk_case, label_path, *dtype in (
            ("", ATTN_CASES[1], SINKHORN_CASES[1], "matching"),
            ("_fused_path", ATTN_CASES[3], SINKHORN_CASES[3], "fused_B"),
            ("_devsift_path", ATTN_CASES[4], SINKHORN_CASES[4], "devsift"),
            ("_staged_image_path", ATTN_CASES[5], SINKHORN_CASES[5], "staged"),
            ("_fused_carhynet_path", ATTN_CASES[4], SINKHORN_CASES[4], "fused_carhynet"),
            ("_fused_dense_path", ATTN_CASES[4], SINKHORN_CASES[4], "fused_dense"),
            # the evaluation: one pair per dispatch at 6144 keypoints
            ("_eval_dense_gray_path", ATTN_CASES[5], SINKHORN_CASES[5], "eval_dense_gray"),
            ("_eval_devsift_path", ATTN_CASES[5], SINKHORN_CASES[5], "eval_devsift"),
            # training: K1 and K2 run in validation (one pair compacted to
            # 3072), the label rounds in the steps and in validation
            ("_train_path", ATTN_CASES[6], SINKHORN_CASES[6], "train_side0"),
            # staged Matching with host SIFT: one pair at 2048 keypoints,
            # 20 iterations (phase 15's third row, phase 17)
            ("_eval_staged_host_path", ATTN_CASES[0], SINKHORN_CASES[7], "eval_staged_host"),
            ("_host_sift_staged_path", ATTN_CASES[0], SINKHORN_CASES[7], "host_sift_staged"),
            # the classic trainer: K1 (f32, the config's) and K2 (100
            # iterations) in validation, whose pairs of 640x480 take bucket
            # 8192; the label rounds in the steps and in validation
            ("_classic_train_path", ATTN_CASES[1], SINKHORN_CASES[1], "classic_train_side0",
             "float32"),
            # FusedMatching split in two chunks of 4 pairs on the card (phase 19)
            ("_dp_serving_path", ATTN_CASES[7], SINKHORN_CASES[8], "dp_serving"),
            # the unsharded reference of phase 22 at bucket 16384
            ("_sharded_reference_path", ATTN_CASES[8], SINKHORN_CASES[9],
             "sharded_reference_16384")):
        b, n, m, _ = attn_case
        a = attn[(b, n, m, dtype[0] if dtype else "bfloat16")]
        s = sk[(sk_case[0], len(sk_case[1]), sk_case[3])]
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
            label_row(suffix, lab[label_path], c["label_rounds"]),
        ]
    for name, n in dp_train.items():
        rows.append(label_row(f"_dp_train_{name}_path", lab[f"dp_train_{name}"], n))
    for b, n, dtype in RING_CASES:
        dt = str(dtype)[6:]
        rows.append({"name": f"masked_attention_partial_ring_path_{dt}", "route": "cuda",
                     "source": "gims_tpu_torch/csrc/attention.cu",
                     "replaces": "gims_tpu/matcher/pallas_attention.py:42",
                     **partial[(b, n // DP_SPLIT, dt)], "launches": ring_launches[dt],
                     "kernel_ms": partial[(b, n // DP_SPLIT, dt)]["ms"]})
    # phase 22: the ring steps of the sharded forward_match, on the two
    # ranks of P=2 (f32 at 4096, bf16 at 16384) and on the one NCCL rank
    shard_partial, shard_launches = shard
    for key, row in shard_partial.items():
        rows.append({"name": f"masked_attention_partial_sharded_path_{key}", "route": "cuda",
                     "source": "gims_tpu_torch/csrc/attention.cu",
                     "replaces": "gims_tpu/matcher/pallas_attention.py:42",
                     **row, "launches": shard_launches[key], "kernel_ms": row["ms"]})
    return rows


def main():
    smi = device_phase()
    build_phase()
    attn = attention_phase()
    sk = sinkhorn_phase()
    launches = slice_phase()
    whole_path_phase(load_gims_checkpoint(WEIGHTS))
    wide_launches = wide_path_phase()
    pose_structured_phase(load_gims_checkpoint(WEIGHTS))
    torch.cuda.empty_cache()
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
    torch.cuda.empty_cache()
    train_launches = train_phase()
    torch.cuda.empty_cache()
    host_launches = host_sift_phase(load_gims_checkpoint(WEIGHTS))
    torch.cuda.empty_cache()
    classic_launches = classic_train_phase()
    torch.cuda.empty_cache()
    dp_serving_launches = dp_serving_phase(load_gims_checkpoint(E2E_WEIGHTS),
                                           load_car_checkpoint(E2E_CAR_WEIGHTS))
    dp_train_launches = dp_train_phase()
    partial, ring_launches = ring_phase()
    torch.cuda.empty_cache()
    shard = shard_phase(load_gims_checkpoint(WEIGHTS))
    torch.cuda.empty_cache()
    entry_launches, entry_shapes = entry_phase(smi)
    torch.cuda.empty_cache()
    tools_launches, tools_shapes = tools_phase(smi)
    entry_launches.update(tools_launches)
    entry_shapes["_tools_search_path"] = tools_shapes
    torch.cuda.empty_cache()
    lab = label_phase()

    t0 = time.perf_counter()
    rows = kernel_rows(attn, sk, lab, {"": launches, "_fused_path": fused_launches,
                                       "_devsift_path": devsift_launches,
                                       "_staged_image_path": staged_launches,
                                       "_fused_carhynet_path": colour_launches["carhynet"],
                                       "_fused_dense_path": colour_launches["dense"],
                                       "_eval_dense_gray_path": eval_launches["dense_gray"],
                                       "_eval_devsift_path": eval_launches["devsift"],
                                       "_train_path": train_launches,
                                       "_eval_staged_host_path": eval_launches["staged_host"],
                                       "_host_sift_staged_path": host_launches,
                                       "_classic_train_path": classic_launches,
                                       "_dp_serving_path": dp_serving_launches,
                                       "_sharded_reference_path": shard[2]},
                      partial, dp_train_launches, ring_launches, shard[:2])
    rows += wide_rows(attn, wide_launches)
    rows += entry_rows(attn, sk, lab, entry_launches, entry_shapes)
    rows += segsum_rows({"_host_sift_staged_path": host_launches, "_train_path": train_launches,
                         "_fused_path": fused_launches})
    print(json.dumps({"kernels": rows}), flush=True)
    phase("14 kernels", t0, total_seconds=f"{time.perf_counter() - _T0:.1f}",
          card=json.dumps(smi))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
