#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GIMS on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each with its seconds:
  0 device: versions, the card's name and power limit; TF32 off.
  1 build: the CUDA kernels under gims_tpu_torch/csrc/, one nvcc process
    per source, all at once; ptxas' registers, shared memory and spills per
    kernel; the count of wgmma (HGMMA) instructions in the attention
    kernels' SASS, which must not be 0 for the bf16 kernel.
  2 the attention kernel against its plain PyTorch versions on the card.
  3 the Sinkhorn kernels against their plain PyTorch version on the card:
    the fused kernel at Z of 2049 and 8193 square, the streaming kernel at
    24577 (the widest bucket).
  4 the slice: gims_tpu_torch.api.Matching with the staged checkpoint
    (weights/gims_tpu_sift_last.npz, 18 GNN layers, 256-d) serves four
    synthetic keypoint requests in an 800x600 frame (buckets 2048 and
    8192); the kernels' launch counters must rise on this path.
  5 one 2048 request in f32 through the kernels and through the plain
    versions: kept equal, matches and scores agree.
  6 one JSON line with every kernel's launches, error and times.
  7 the last line: {"ok": true, "device": {...}}.

Any mismatch raises and the process exits non-zero. Without CUDA it
exits non-zero at once: there is no CPU fallback. It imports torch, numpy,
the standard library and gims_tpu_torch only, and writes nothing outside
gims_tpu_torch/_build/.
"""

from __future__ import annotations

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

from gims_tpu_torch import _build  # noqa: E402
from gims_tpu_torch.api import Matching  # noqa: E402
from gims_tpu_torch.config import MatcherConfig  # noqa: E402
from gims_tpu_torch.matcher import attention, cuda_attention, cuda_sinkhorn, sinkhorn  # noqa: E402
from gims_tpu_torch.matcher.convert import load_gims_checkpoint  # noqa: E402
from gims_tpu_torch.synthetic import correct_share, synthetic_request  # noqa: E402

WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")
# one NVIDIA H100 SXM, from its data sheet: HBM bytes/s, peak FLOP/s, and
# the exponentials its MUFU units take per second (16 per clock per SM, 132
# SMs, 1.98 GHz boost clock)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
EXP_PER_S = 132 * 16 * 1.98e9
# The attention kernel, element by element: |out - ref| <= atol + rtol * |ref|.
# f32: against the direct version, 1e-4 flat. bf16: against
# masked_attention_tiled's unrounded f32 result, which rounds P to bf16 per
# key tile as the kernel and the TPU kernel do (pallas_attention.py:75); the
# limit is the output's one rounding (2**-8) plus f32 summation-order slack.
# Against the direct version (P kept in f32) bf16 is held by its RMS error
# relative to the output's RMS: the output's rounding alone gives about
# 2**-8 / sqrt(3) (0.0023) and P's rounding less, so 2**-8 (0.0039).
ATTN_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-4, 2.0 ** -8)}
ATTN_BF16_REL_RMS = 2.0 ** -8
SINKHORN_TOL = 2e-4
SINKHORN_ITERS = 100
NUM_LAYERS = 18
DEVICE = "cuda"
# (B, N, M, masked key tail): the trunk's buckets 2048 and 8192 (both sides
# stacked, B=2), and a key count that is not a multiple of the 64-key tile
ATTN_CASES = ((2, 2048, 2048, 248), (2, 8192, 8192, 1192), (2, 1000, 2017, 300))
# (bucket, valid rows, valid cols, iterations) of the Sinkhorn input Z
# (bucket+1 square): the fused kernel (Z read once per iteration) at 2049
# and 8193, the streaming kernel (twice) at 24577
SINKHORN_CASES = ((2048, 1800, 1750, SINKHORN_ITERS), (8192, 7000, 6900, SINKHORN_ITERS),
                  (24576, 22000, 21000, 3))
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


def ptxas_report(log):
    """{kernel: {registers, static_smem_bytes, spill_stores, spill_loads}} from
    nvcc -Xptxas=-v output."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"(attn_tc_kernel|attn_f32_kernel|sinkhorn_fused_kernel|"
                          r"sinkhorn_stream_kernel)(?:ILi(\d+)ELi(\d+)E)?", line)
            name = (m.group(1) + (f"<{m.group(2)},{m.group(3)}>" if m.group(2) else "")) if m else None
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
            m = re.search(r"(attn_tc_kernel|attn_f32_kernel)", line)
            name = m.group(1) if m else None
            if name:
                counts[name] = 0
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
    if not hgmma.get("attn_tc_kernel"):
        raise AssertionError(f"the bf16 attention kernel has no HGMMA instruction: {hgmma}")
    phase("1 build", t0, nvcc_seconds=f"{_build.build_seconds}",
          library=os.path.relpath(lib._name, REPO))


def attention_case(b, n, m, masked_tail, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    h, d = 4, cuda_attention.HEAD_DIM
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
    excess = (diff - (atol + rtol * want.abs())).max().item()
    err = diff.max().item()
    if not (math.isfinite(err) and excess <= 0):
        raise AssertionError(f"attention kernel {dtype} B={b} N={n} M={m}: max abs err "
                             f"{err}, over atol {atol} + rtol {rtol} * |ref| by {excess}")
    info = {"max_abs_err": err}
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
    scores = 2.0 * torch.randn((1, nb, nb), generator=g, device=DEVICE)
    row_mask = torch.arange(nb, device=DEVICE)[None] < n0
    col_mask = torch.arange(nb, device=DEVICE)[None] < n1
    alpha = torch.tensor(1.0, device=DEVICE)
    # the couplings as the Matching path builds them for the kernel: rows of
    # nb + 1 floats in a pitch of a multiple of 4
    couplings, log_mu, log_nu, _ = sinkhorn.dustbin_couplings(
        scores, alpha, row_mask, col_mask, row_pitch=nb + 1 + -(nb + 1) % 4)
    got = cuda_sinkhorn.log_optimal_transport_cuda(scores, alpha, iters, row_mask, col_mask)
    want = sinkhorn.log_optimal_transport(scores, alpha, iters, row_mask, col_mask)
    torch.cuda.synchronize()
    rows = torch.cat([torch.nonzero(row_mask[0])[:, 0], torch.tensor([nb], device=DEVICE)])
    cols = torch.cat([torch.nonzero(col_mask[0])[:, 0], torch.tensor([nb], device=DEVICE)])
    err = (got[0][rows][:, cols] - want[0][rows][:, cols]).abs().max().item()
    if not math.isfinite(err) or err > SINKHORN_TOL:
        raise AssertionError(f"Sinkhorn kernel Z ({nb + 1}x{nb + 1}): max abs err "
                             f"{err} > {SINKHORN_TOL}")
    return couplings, log_mu.contiguous(), log_nu.contiguous(), err


def sinkhorn_phase():
    t0 = time.perf_counter()
    rows = {}
    for nb, n0, n1, iters in SINKHORN_CASES:
        z, mu, nu, err = sinkhorn_case(nb, n0, n1, iters, seed=nb)
        m1, n1p = z.shape[1], z.shape[2]
        # each input read once, each output written once (Z, marginals, u, v)
        nbytes = 4 * (m1 * n1p + 2 * (m1 + n1p))
        # per iteration and element: add potential, max, exp, accumulate, twice
        flops = 2 * iters * m1 * n1p * 4
        b_ms, b_by = bound_ms(nbytes, flops, torch.float32)
        z_read_ms = 1e3 * 4 * m1 * n1p / HBM_BPS
        row = {"shape": f"Z=(1,{m1},{n1p}) iters={iters}", "dtype": "float32",
               "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
               # bound_ms reads Z once, as if it stayed on the chip. Where Z
               # outgrows the 50 MB L2 (268 MB at bucket 8192), any design
               # reads it from HBM once per iteration, as the fused kernel
               # does; a row pass and a column pass read it twice
               "z_reads_per_iter": cuda_sinkhorn.z_reads_per_iter(1, m1, n1p),
               "one_pass_bound_ms": iters * z_read_ms,
               "two_pass_bound_ms": 2 * iters * z_read_ms,
               "ms": cuda_ms(lambda: cuda_sinkhorn.sinkhorn_uv_cuda(z, mu, nu, iters), 3),
               "plain_ms": cuda_ms(lambda: sinkhorn.log_sinkhorn_uv(z, mu, nu, iters), 1),
               "library_ms": None}
        # the kernel's reads of Z over its time
        row["gbps"] = row["z_reads_per_iter"] * iters * 4 * m1 * n1p / row["ms"] / 1e6
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
    cuda_attention.launches = 0
    cuda_sinkhorn.launches = 0
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
    launches = {"attention": cuda_attention.launches, "sinkhorn": cuda_sinkhorn.launches}
    if launches != {"attention": NUM_LAYERS * len(requests), "sinkhorn": len(requests)}:
        raise AssertionError(f"kernel launches on the Matching path: {launches}, "
                             f"expected {NUM_LAYERS} attention and 1 Sinkhorn per request")
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


def main():
    smi = device_phase()
    build_phase()
    attn = attention_phase()
    sk = sinkhorn_phase()
    launches = slice_phase()
    whole_path_phase(load_gims_checkpoint(WEIGHTS))

    t0 = time.perf_counter()
    _, n, m, _ = ATTN_CASES[1]
    a, s = attn[(n, m, "bfloat16")], sk[SINKHORN_CASES[1][0]]
    kernels = [
        {"name": "masked_attention", "route": "cuda",
         "source": "gims_tpu_torch/csrc/attention.cu",
         "replaces": "gims_tpu/matcher/pallas_attention.py:42",
         "launches": launches["attention"], **a, "kernel_ms": a["ms"]},
        {"name": "sinkhorn_uv", "route": "cuda",
         "source": "gims_tpu_torch/csrc/sinkhorn.cu",
         "replaces": "gims_tpu/matcher/pallas_sinkhorn.py:40",
         "launches": launches["sinkhorn"], **s, "kernel_ms": s["ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    phase("6 kernels", t0, total_seconds=f"{time.perf_counter() - _T0:.1f}",
          card=json.dumps(smi))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
