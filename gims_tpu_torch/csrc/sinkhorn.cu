// Log-domain Sinkhorn potentials for the dustbin-padded coupling matrix.
//
// Replaces the TPU kernel gims_tpu/matcher/pallas_sinkhorn.py::_sinkhorn_kernel
// (reached through sinkhorn_uv_pallas / log_optimal_transport_pallas): for
// each batch item, `iters` times,
//     u = log_mu - lse_j(Z + v)      (row update)
//     v = log_nu - lse_i(Z + u)      (column update)
// with the masked-logsumexp semantics of gims_tpu/matcher/sinkhorn.py
// (running max floored at -1e9, sum floored at 1e-38, result floored at
// -1e9). The caller forms Z + u + v - norm.
//
// What bounds it on the H100: Z is read once per iteration at best, so
// iters*4*M1*N1 bytes. At the 8192 bucket Z is 268 MB, larger than the 50 MB
// L2, so every iteration streams it from device memory (8.0 ms for 100
// iterations at 3.35 TB/s); two exponentials per element and iteration run
// on the MUFU units in about half that time. At 2048 (17 MB) Z fits in the
// shared memory of the 132 SMs, and the grid-wide barriers set the pace.
//
// Layout: Z is (B, M1, ldz) with ldz = N1 rounded up to a multiple of 4, so
// every row starts 16-byte aligned and is read as float4 groups or by one
// bulk copy. The pad columns are never used: they may hold anything.
//
// Two kernels, picked by size, both one cooperative launch that runs all
// iterations (grid = the blocks co-resident on the card, this_grid().sync(),
// no -rdc):
//
// sinkhorn_fused_kernel<G, R> (N1 <= 14340, B <= grid): one read of Z per
// iteration. The blocks of a batch item split its rows into bands; a block
// of 512 threads walks its band R rows per step. Thread t owns the float4
// column groups t, t + 512, ... (G of them) and keeps their running column
// (reference, sum) in registers; the last group (the dustbin column of a
// 2^k + 1 row, and the pad) belongs to threads 0-3, one column each, so that
// the dustbin does not cost every thread a group. Thread 0 brings each
// step's R rows (contiguous in memory) into a ring of S stages in shared
// memory by one cp.async.bulk, completing on the stage's mbarrier. Per
// step, one block barrier:
//   * the row pass: wait for the stage, take the thread's columns of the R
//     rows into registers, form each row's (max, sum) of Z + v (v in shared
//     memory), and merge the R rows across the warp by transposition (each
//     exchange hands over half of a lane's rows: 8 rows take 18 shuffles
//     per lane, not 80), one pair per warp and row into a table;
//   * the barrier; thread 0 refills the stage with the rows S steps on
//     (across iterations too: Z does not change), so S - 1 stages stream
//     while the block computes;
//   * in every warp (no warp waits on another) the 32 / R lanes of each row
//     merge its 16 warps' pairs and pass u around the warp by shuffles;
//   * the fold: Z + u from the same registers into the column sums. A
//     column's reference moves only when a value passes it by 16 (terms stay
//     below e^16, far from f32 overflow), and the warp takes that rescale
//     together, so the fold costs one exponential per element.
// Where a block's whole band fits in the ring (the 2048 bucket and below),
// the rows stay in shared memory and Z is read once for all iterations.
// After the sweep each block writes its column partials to a scratch of
// (B, bands, ldz) (reference, sum) pairs, which stays in L2; a grid sync;
// the blocks merge the partials 32 columns at a time and write v; a grid
// sync; the next iteration.
//
// sinkhorn_stream_kernel (wider rows, or more batch items than blocks): the
// column state of a row outgrows a block's registers, so each iteration
// reads Z twice: a row pass (one warp per row, v of the item in shared
// memory) writes u; a grid sync; a column pass over (band, column chunk)
// tiles writes the partials; a grid sync; the same merge writes v.
//
// v, u and the scratch are read with ld.global.cg, past the non-coherent L1.
// The wrapper allocates the scratch; the kernels allocate nothing.
// Exponentials are ex2.approx: relative error ~2^-21 near 0, growing with
// |x| where the term no longer counts, far inside that of the f32 sums. The
// fused kernel keeps v, u, its maxima and references in base 2 (times
// log2(e)), so that Z * log2(e) + v is one fma and each term one ex2; it
// hands natural-log values to u and to the scratch. The streaming kernel
// uses __expf.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block may take on sm_90
constexpr int kMaxStages = 8;
constexpr int kMinStages = 2;  // one stage in use, one in flight (unless the band fits)
constexpr int kMaxRows = 8;                // rows per step of any instantiation
constexpr int kColTabPitch = kWarps + 1;   // float2 per column of the column table
constexpr float kSlack = 16.f;             // how far a column term may pass its reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // the floor in base 2
constexpr int kMaxDevices = 64;

// Shared memory of the fused kernel before v and the ring: the stage
// mbarriers, the row merge table (two steps) and the column merge table.
constexpr size_t kFixedSmem = sizeof(uint64_t) * kMaxStages +
                              sizeof(float2) * (2 * kMaxRows * kWarps + 32 * kColTabPitch);
static_assert(kFixedSmem % 16 == 0, "v and the ring start 16-byte aligned");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Wait until the barrier has left phase `parity`. A wait that never ends is a
// fault of the kernel: trap after ~2^26 polls (seconds) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 26)) __trap();
  }
}

// `bytes` (a multiple of 16) from global to shared memory by the bulk-copy
// unit; completion is counted on `bar`, which this call arms.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  // the stage was last read by ordinary loads: order them before the copy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float lse_final(float m, float s) {
  return fmaxf(m + logf(fmaxf(s, 1e-38f)), kNegInf);
}

// e^x, or 2^x where the values are kept in base 2 (kBase2): ex2.approx,
// which __expf also ends in after its multiply by log2(e)
template <bool kBase2>
__device__ __forceinline__ float expb(float x) {
  if (!kBase2) return __expf(x);
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (max, sum) over aligned groups of W lanes, the same in every lane of a
// group: the max by shuffles, one exponential per lane to bring its sum to
// that max, then the sum by shuffles
template <int W, bool kBase2 = false>
__device__ __forceinline__ void group_merge(float& m, float& s) {
  float mx = m;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  s *= expb<kBase2>(m - mx);
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  m = mx;
}

// merge (m2, s2) into the running (max, sum) (m, s): one exponential, no
// branch, so a warp does not split
template <bool kBase2>
__device__ __forceinline__ void pair_merge(float& m, float& s, float m2, float s2) {
  const float e = expb<kBase2>(-fabsf(m - m2));
  const bool up = m2 > m;
  s = up ? fmaf(s, e, s2) : fmaf(s2, e, s);
  m = up ? m2 : m;
}

// The (max, sum) pairs of R rows (base 2), one pair per row in every lane,
// merged across the warp by transposition: at each of the first log2(R)
// exchanges a lane hands over half of its rows and keeps the other half, so
// the warp moves R - 1 pairs per lane instead of 5 R; then the 32 / R lanes
// that hold the same row finish it. Returns the lane's row, whose pair ends
// in m[0], s[0].
// One exchange: the lane keeps rows [0, H) or [H, 2H) of its 2H (by its lane
// bit `off`), receives its partner's pairs of the same rows, and goes on
// with H rows; recursion keeps every index a constant.
template <int R, int H>
__device__ __forceinline__ void transpose_levels(float (&m)[R], float (&s)[R], int lane, int& row) {
  if constexpr (H >= 1) {
    constexpr int off = 32 * H / R;
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float om = __shfl_xor_sync(0xffffffffu, up ? m[i] : m[H + i], off);
      const float os = __shfl_xor_sync(0xffffffffu, up ? s[i] : s[H + i], off);
      m[i] = up ? m[H + i] : m[i];
      s[i] = up ? s[H + i] : s[i];
      pair_merge<true>(m[i], s[i], om, os);
    }
    row += up ? H : 0;
    transpose_levels<R, H / 2>(m, s, lane, row);
  }
}

template <int R>
__device__ __forceinline__ int transpose_merge(float (&m)[R], float (&s)[R], int lane) {
  int row = 0;
  transpose_levels<R, R / 2>(m, s, lane, row);
  group_merge<32 / R, true>(m[0], s[0]);
  return row;
}

__device__ __forceinline__ float& at(float4& x, int e) {
  return e == 0 ? x.x : (e == 1 ? x.y : (e == 2 ? x.z : x.w));
}
__device__ __forceinline__ float at(const float4& x, int e) {
  return e == 0 ? x.x : (e == 1 ? x.y : (e == 2 ? x.z : x.w));
}

// Fold the values t[0..n) of one column into its (reference, sum): the
// reference moves only when a value passes it by kSlack (in the base of the
// values). With kVote the whole warp takes the rescale when one lane needs
// it (no divergent branch); that almost never happens after a band's first
// rows.
template <int N, bool kVote, bool kBase2>
__device__ __forceinline__ void column_fold(float& m, float& s, const float (&t)[N]) {
  constexpr float slack = kBase2 ? kSlack * kLog2e : kSlack;
  float mx = t[0];
#pragma unroll
  for (int i = 1; i < N; ++i) mx = fmaxf(mx, t[i]);
  const bool up = mx > m + slack;
  if (kVote ? __any_sync(0xffffffffu, up) : up) {
    const float mn = up ? mx : m;
    s *= expb<kBase2>(m - mn);
    m = mn;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s += expb<kBase2>(t[i] - m);
}

// v = log_nu - lse over the bands' column partials, 32 columns per block at
// a time: warp w merges bands w, w + 16, ... (all its loads in flight at
// once where bands <= 16 * kMergeLoads), then each column's 16 pairs by a
// 16-lane shuffle tree.
constexpr int kMergeLoads = 9;
__device__ void merge_columns(const float2* __restrict__ scratch, const float* __restrict__ log_nu,
                              float* __restrict__ v, float2* col_tab, int B, int N1, int ldz,
                              int bands) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunks = (N1 + 31) / 32;
  for (int chunk = blockIdx.x; chunk < B * chunks; chunk += gridDim.x) {
    const int bb = chunk / chunks;
    const int col0 = (chunk % chunks) * 32;
    const int col = col0 + lane;
    float m = kNegInf, s = 0.f;
    for (int band0 = warp; band0 < bands; band0 += kMergeLoads * kWarps) {
      float2 p[kMergeLoads];
#pragma unroll
      for (int k = 0; k < kMergeLoads; ++k) {
        const int band = band0 + k * kWarps;
        p[k] = band < bands && col < N1
                   ? __ldcg(scratch + ((long long)bb * bands + band) * ldz + col)
                   : make_float2(kNegInf, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kMergeLoads; ++k) pair_merge<false>(m, s, p[k].x, p[k].y);
    }
    col_tab[lane * kColTabPitch + warp] = make_float2(m, s);
    __syncthreads();
    const int c = tid / kWarps, part = tid % kWarps;  // column c's pair from warp `part`
    const float2 p = col_tab[c * kColTabPitch + part];
    m = p.x;
    s = p.y;
    group_merge<kWarps>(m, s);
    if (part == 0 && col0 + c < N1) {
      const long long ci = (long long)bb * N1 + col0 + c;
      __stcg(v + ci, __ldg(log_nu + ci) - lse_final(m, s));
    }
    __syncthreads();
  }
}

template <int G, int R>
__global__ void __launch_bounds__(kThreads, 1) sinkhorn_fused_kernel(
    const float* __restrict__ Z, const float* __restrict__ log_mu,
    const float* __restrict__ log_nu, float* __restrict__ u, float* __restrict__ v,
    float2* __restrict__ scratch, int B, int M1, int N1, int bands, int stages, int iters) {
  extern __shared__ float4 smem_f4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_f4);             // [kMaxStages]
  float2* row_tab = reinterpret_cast<float2*>(full + kMaxStages);    // [2][kMaxRows][kWarps]
  float2* col_tab = row_tab + 2 * kMaxRows * kWarps;                 // [32][kColTabPitch]
  float* vs = reinterpret_cast<float*>(col_tab + 32 * kColTabPitch);  // [ldz]

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ldz = (N1 + 3) & ~3, n4 = ldz / 4;
  // groups 0 .. n4 - 2 belong to the threads (G each); the last group (the
  // dustbin column and the pad) to threads 0-3, one column each
  const int n4m = n4 - 1;
  const int tcol = 4 * n4m + tid;
  const bool tail = tid < 4 && tcol < N1;
  float* ring = vs + ldz;  // [stages][R][ldz]
  const float4* vs4 = reinterpret_cast<const float4*>(vs);

  // this block's band: item bb, rows [row0, row_end), spi steps per iteration
  const int slot = blockIdx.x;
  const bool sweeps = slot < B * bands;
  const int bb = sweeps ? slot / bands : 0;
  const int band = slot % bands;
  const int row0 = (int)((long long)band * M1 / bands);
  const int row_end = (int)((long long)(band + 1) * M1 / bands);
  const int spi = sweeps ? (row_end - row0 + R - 1) / R : 0;
  const long long total = (long long)spi * iters;
  const bool resident = spi <= stages;  // the band stays in the ring
  const long long item_row0 = (long long)bb * M1;
  auto rows_of = [&](int j) { return min(R, row_end - (row0 + j * R)); };

  // global step k = it * spi + j brings rows row0 + j * R, ... into stage k % stages
  auto issue = [&](long long k) {
    const int j = (int)(k % spi);
    const int st = (int)(k % stages);
    bulk_load(ring + (size_t)st * R * ldz, Z + (item_row0 + row0 + j * R) * ldz,
              (uint32_t)rows_of(j) * ldz * sizeof(float), &full[st]);
  };
  // Wait for step j's rows and take this thread's columns of them into
  // registers (rows past the band are -inf); then each row's (max, sum) of
  // Z + v over those columns, merged across the warp into row_tab[j % 2]
  // (two tables: a fast warp may write step j + 1's before a slow one has
  // read step j's).
  auto row_pass = [&](int it, int j, float4 (&z)[R][G], float (&zt)[R]) {
    const long long k = (long long)it * spi + j;
    const int st = resident ? j : (int)(k % stages);
    const int nr = rows_of(j);
    if (!resident || it == 0) mbar_wait(&full[st], (uint32_t)((k / stages) & 1));
    const float* rows = ring + (size_t)st * R * ldz;
    const float4* rows4 = reinterpret_cast<const float4*>(rows);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const int g = tid + c * kThreads;
        z[r][c] = r < nr && g < n4m ? rows4[r * n4 + g]
                                    : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      }
      zt[r] = r < nr && tail ? rows[r * ldz + tcol] : -INFINITY;
    }
    const float vt = tail ? vs[tcol] : 0.f;
    float rm[R], rs[R];
#pragma unroll
    for (int r = 0; r < R; ++r) rm[r] = fmaxf(kNegInf2, fmaf(zt[r], kLog2e, vt));
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const int g = tid + c * kThreads;
      const float4 v4 = g < n4m ? vs4[g] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) rm[r] = fmaxf(rm[r], fmaf(at(z[r][c], e), kLog2e, at(v4, e)));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) rs[r] = expb<true>(fmaf(zt[r], kLog2e, vt) - rm[r]);
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const int g = tid + c * kThreads;
      const float4 v4 = g < n4m ? vs4[g] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          rs[r] += expb<true>(fmaf(at(z[r][c], e), kLog2e, at(v4, e)) - rm[r]);
        }
    }
    const int row = transpose_merge<R>(rm, rs, lane);
    if ((lane & (32 / R - 1)) == 0) {
      row_tab[((j & 1) * kMaxRows + row) * kWarps + warp] = make_float2(rm[0], rs[0]);
    }
  };

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const long long first = resident ? spi : (total < stages ? total : stages);
    for (long long k = 0; k < first; ++k) issue(k);
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    if (sweeps) {
      // v, the references and the sums in base 2: Z * log2(e) + v * log2(e)
      // is one fma
      for (int c = tid; c < ldz; c += kThreads) {
        vs[c] = c < N1 ? __ldcg(v + (long long)bb * N1 + c) * kLog2e : 0.f;
      }
      float4 cm[G], cs[G];
#pragma unroll
      for (int c = 0; c < G; ++c) {
        cm[c] = make_float4(kNegInf2, kNegInf2, kNegInf2, kNegInf2);
        cs[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float cmt = kNegInf2, cst = 0.f;  // the tail column's
      // after a step's barrier, the 32 / R lanes of row `my_row` merge its
      // 16 warps' pairs, P per lane, and hand u to the warp
      constexpr int L = 32 / R;
      constexpr int P = R >= 2 ? R / 2 : 1;
      const int my_row = lane / L;
      const int part0 = (lane % L) * P;
      float mu = my_row < rows_of(0) ? __ldg(log_mu + item_row0 + row0 + my_row) : 0.f;
      __syncthreads();

      // Step j: the row pass into registers; one barrier, after which the
      // stage takes the rows `stages` steps on (across iterations too: Z
      // does not change); every warp merges each row's 16 pairs itself and
      // so has u; the fold of the same registers.
      for (int j = 0; j < spi; ++j) {
        const long long k = (long long)it * spi + j;
        const int nr = rows_of(j);
        float4 z[R][G];
        float zt[R];
        row_pass(it, j, z, zt);
        const float mu_j = mu;
        if (j + 1 < spi) {
          mu = my_row < rows_of(j + 1) ? __ldg(log_mu + item_row0 + row0 + (j + 1) * R + my_row) : 0.f;
        }
        __syncthreads();
        if (tid == 0 && !resident && k + stages < total) issue(k + stages);
        float m = kNegInf2, s = 0.f;
        if (my_row < nr) {
          float pm[P], ps[P];
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const float2 p = part0 + q < kWarps
                                 ? row_tab[((j & 1) * kMaxRows + my_row) * kWarps + part0 + q]
                                 : make_float2(kNegInf2, 0.f);
            pm[q] = p.x;
            ps[q] = p.y;
            m = fmaxf(m, p.x);
          }
#pragma unroll
          for (int q = 0; q < P; ++q) s = fmaf(ps[q], expb<true>(pm[q] - m), s);
        }
        group_merge<L, true>(m, s);
        const float u_row = mu_j - lse_final(m * kLn2, s);
        if (warp == 0 && lane % L == 0 && my_row < nr) u[item_row0 + row0 + j * R + my_row] = u_row;
        float ur[R];
#pragma unroll
        for (int r = 0; r < R; ++r) ur[r] = r < nr ? __shfl_sync(0xffffffffu, u_row, r * L) * kLog2e : 0.f;
#pragma unroll
        for (int c = 0; c < G; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float t[R];
#pragma unroll
            for (int r = 0; r < R; ++r) t[r] = fmaf(at(z[r][c], e), kLog2e, ur[r]);
            column_fold<R, true, true>(at(cm[c], e), at(cs[c], e), t);
          }
        }
        if (tail) {
          float t[R];
#pragma unroll
          for (int r = 0; r < R; ++r) t[r] = fmaf(zt[r], kLog2e, ur[r]);
          column_fold<R, false, true>(cmt, cst, t);
        }
      }
      float2* out = scratch + (long long)slot * ldz;
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const int g = tid + c * kThreads;
        if (g < n4m) {
          float4* o = reinterpret_cast<float4*>(out + 4 * g);
          __stcg(o, make_float4(cm[c].x * kLn2, cs[c].x, cm[c].y * kLn2, cs[c].y));
          __stcg(o + 1, make_float4(cm[c].z * kLn2, cs[c].z, cm[c].w * kLn2, cs[c].w));
        }
      }
      if (tail) __stcg(out + tcol, make_float2(cmt * kLn2, cst));
    }
    grid.sync();
    merge_columns(scratch, log_nu, v, col_tab, B, N1, ldz, bands);
    grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads, 1) sinkhorn_stream_kernel(
    const float* __restrict__ Z, const float* __restrict__ log_mu,
    const float* __restrict__ log_nu, float* __restrict__ u, float* __restrict__ v,
    float2* __restrict__ scratch, int B, int M1, int N1, int bands, int stages, int iters) {
  constexpr int L = 8;  // float4 loads in flight per thread
  extern __shared__ float4 smem_f4[];
  float2* col_tab = reinterpret_cast<float2*>(smem_f4);        // [32][kColTabPitch]
  float* vs = reinterpret_cast<float*>(col_tab + 32 * kColTabPitch);  // [ldz]
  const float4* vs4 = reinterpret_cast<const float4*>(vs);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ldz = (N1 + 3) & ~3, n4 = ldz / 4;
  // column chunks of equal width, at most one group per thread
  const int chunks = (n4 + kThreads - 1) / kThreads;
  const int width = (n4 + chunks - 1) / chunks;
  const int gwarp = blockIdx.x * kWarps + warp, nwarps = gridDim.x * kWarps;
  (void)stages;

  for (int it = 0; it < iters; ++it) {
    // row update, item by item with its v in shared memory; one warp per row
    for (int bb = 0; bb < B; ++bb) {
      if (gwarp - warp >= M1) break;  // no row of this block
      __syncthreads();
      for (int c = tid; c < ldz; c += kThreads) vs[c] = c < N1 ? __ldcg(v + (long long)bb * N1 + c) : 0.f;
      __syncthreads();
      for (int r = gwarp; r < M1; r += nwarps) {
        const long long gr = (long long)bb * M1 + r;
        const float4* z4 = reinterpret_cast<const float4*>(Z + gr * ldz);
        float m = kNegInf, s = 0.f;
        for (int g0 = lane; g0 < n4; g0 += L * 32) {
          float4 t[L];
#pragma unroll
          for (int q = 0; q < L; ++q) {
            const int g = g0 + q * 32;
            t[q] = g < n4 ? __ldg(z4 + g) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
          }
          float mx = m;
#pragma unroll
          for (int q = 0; q < L; ++q) {
            const int g = g0 + q * 32;
            const float4 v4 = g < n4 ? vs4[g] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              at(t[q], e) = 4 * g + e < N1 ? at(t[q], e) + at(v4, e) : -INFINITY;
              mx = fmaxf(mx, at(t[q], e));
            }
          }
          s *= __expf(m - mx);
#pragma unroll
          for (int q = 0; q < L; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) s += __expf(at(t[q], e) - mx);
          m = mx;
        }
        group_merge<32>(m, s);
        if (lane == 0) __stcg(u + gr, __ldg(log_mu + gr) - lse_final(m, s));
      }
    }
    grid.sync();

    // column partials over (item, band, column chunk) tiles, L rows per load
    for (int tile = blockIdx.x; tile < B * bands * chunks; tile += gridDim.x) {
      const int slot = tile / chunks;
      const int bb = slot / bands, band = slot % bands;
      const int g = (tile % chunks) * width + tid;
      if (tid >= width || g >= n4) continue;
      const int row0 = (int)((long long)band * M1 / bands);
      const int row_end = (int)((long long)(band + 1) * M1 / bands);
      const float4* zc = reinterpret_cast<const float4*>(Z + (long long)bb * M1 * ldz) + g;
      const float* ub = u + (long long)bb * M1;
      float4 cm = make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
      float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r0 = row0; r0 < row_end; r0 += L) {
        float4 z[L];
        float ur[L];
#pragma unroll
        for (int q = 0; q < L; ++q) {
          const int r = r0 + q;
          z[q] = r < row_end ? __ldg(zc + (long long)r * n4)
                             : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
          ur[q] = r < row_end ? __ldcg(ub + r) : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float t[L];
#pragma unroll
          for (int q = 0; q < L; ++q) t[q] = at(z[q], e) + ur[q];
          column_fold<L, false, false>(at(cm, e), at(cs, e), t);
        }
      }
      float4* o = reinterpret_cast<float4*>(scratch + (long long)slot * ldz + 4 * g);
      __stcg(o, make_float4(cm.x, cs.x, cm.y, cs.y));
      __stcg(o + 1, make_float4(cm.z, cs.z, cm.w, cs.w));
    }
    grid.sync();
    merge_columns(scratch, log_nu, v, col_tab, B, N1, ldz, bands);
    grid.sync();
  }
}

typedef void (*KernelFn)(const float*, const float*, const float*, float*, float*, float2*, int,
                         int, int, int, int, int);

// The fused kernel's instantiations, (column groups per thread, rows per
// step): at most 7 * 512 * 4 + 4 = 14340 columns. A step's rows stay in
// registers from row pass to fold (4 * R * G) beside the column state
// (8 * G), inside the 128 registers a thread has. Index kVariants is the
// streaming kernel.
struct Variant {
  int groups, rows;
  KernelFn fn;
};
constexpr int kVariants = 7;
const Variant& variant(int i) {
  static const Variant vs[kVariants + 1] = {
      {1, 8, sinkhorn_fused_kernel<1, 8>}, {2, 4, sinkhorn_fused_kernel<2, 4>},
      {3, 4, sinkhorn_fused_kernel<3, 4>}, {4, 2, sinkhorn_fused_kernel<4, 2>},
      {5, 2, sinkhorn_fused_kernel<5, 2>}, {6, 2, sinkhorn_fused_kernel<6, 2>},
      {7, 1, sinkhorn_fused_kernel<7, 1>}, {0, 0, sinkhorn_stream_kernel}};
  return vs[i];
}

struct Plan {
  KernelFn fn;
  size_t smem;
  int grid, bands, stages;
};

// The kernel's blocks co-resident on the current device with `smem` bytes of
// dynamic shared memory. The shared-memory limit is raised once per
// variant and device, not on every call.
cudaError_t resident_blocks(int index, size_t smem, int* blocks) {
  static bool raised[kVariants + 1][kMaxDevices] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const void* fn = reinterpret_cast<const void*>(variant(index).fn);
  if (err == cudaSuccess && (dev >= kMaxDevices || !raised[index][dev])) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess && dev < kMaxDevices) raised[index][dev] = true;
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// The first fused instantiation that holds N1 columns, gives each batch item
// a block and whose ring holds two stages or the whole band; otherwise the
// streaming kernel. Returns a cudaError_t.
cudaError_t plan(int B, int M1, int N1, Plan* p) {
  const int ldz = (N1 + 3) & ~3, n4 = ldz / 4;
  const size_t row_bytes = sizeof(float) * ldz;
  for (int i = 0; i < kVariants; ++i) {
    const Variant& vt = variant(i);
    if (vt.groups * kThreads < n4 - 1) continue;
    const size_t fixed = kFixedSmem + row_bytes;
    const int stages =
        (int)std::min<size_t>(kMaxStages, (kMaxSmem - fixed) / (vt.rows * row_bytes));
    if (stages < 1) continue;
    int grid = 0;
    const size_t smem = fixed + (size_t)stages * vt.rows * row_bytes;
    const cudaError_t err = resident_blocks(i, smem, &grid);
    if (err != cudaSuccess) return err;
    if (B > grid) break;
    const int bands = grid / B;
    const int spi = ((M1 + bands - 1) / bands + vt.rows - 1) / vt.rows;
    if (stages < kMinStages && spi > stages) continue;
    *p = Plan{vt.fn, smem, grid, bands, stages};
    return cudaSuccess;
  }
  const size_t smem = sizeof(float2) * 32 * kColTabPitch + row_bytes;
  int grid = 0;
  const cudaError_t err = resident_blocks(kVariants, smem, &grid);
  if (err != cudaSuccess) return err;
  const int chunks = (n4 + kThreads - 1) / kThreads;
  const int bands = std::max(1, grid / (B * chunks));
  *p = Plan{variant(kVariants).fn, smem, grid, bands, 0};
  return cudaSuccess;
}

}  // namespace

// Reads of Z per iteration of the kernel gims_sinkhorn_uv picks for (B, M1,
// N1): 1 (fused) or 2 (streaming), or a negative cudaError_t.
extern "C" int gims_sinkhorn_z_reads(int B, int M1, int N1) {
  if (B <= 0 || M1 <= 0 || N1 <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan(B, M1, N1, &p);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return p.fn == variant(kVariants).fn ? 2 : 1;
}

// float2 elements of the scratch gims_sinkhorn_uv needs for (B, M1, N1), or
// a negative cudaError_t.
extern "C" long long gims_sinkhorn_scratch_len(int B, int M1, int N1) {
  if (B <= 0 || M1 <= 0 || N1 <= 0) return -static_cast<long long>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan(B, M1, N1, &p);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(B) * p.bands * ((N1 + 3) & ~3);
}

// Z (B, M1, ldz), ldz = N1 rounded up to a multiple of 4 (the pad columns
// are not read), 16-byte aligned; log_mu / u (B, M1), log_nu / v (B, N1): contiguous f32 on
// the device; scratch: gims_sinkhorn_scratch_len(B, M1, N1) float2. Writes u
// and v. Returns a cudaError_t (0 = launched).
extern "C" int gims_sinkhorn_uv(const void* Z, const void* log_mu, const void* log_nu, void* u,
                                void* v, void* scratch, long long scratch_len, int B, int M1,
                                int N1, int iters, void* stream) {
  if (B <= 0 || M1 <= 0 || N1 <= 0 || iters < 0 || reinterpret_cast<uintptr_t>(Z) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(u, 0, sizeof(float) * B * M1, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(v, 0, sizeof(float) * B * N1, st);
  if (err != cudaSuccess || iters == 0) return static_cast<int>(err);

  Plan p;
  err = plan(B, M1, N1, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (scratch_len < static_cast<long long>(B) * p.bands * ((N1 + 3) & ~3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* z = static_cast<const float*>(Z);
  const float* mu = static_cast<const float*>(log_mu);
  const float* nu = static_cast<const float*>(log_nu);
  float* uu = static_cast<float*>(u);
  float* vv = static_cast<float*>(v);
  float2* sc = static_cast<float2*>(scratch);
  void* args[] = {&z, &mu, &nu, &uu, &vv, &sc, &B, &M1, &N1, &p.bands, &p.stages, &iters};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(p.fn), dim3(p.grid),
                                    dim3(kThreads), args, p.smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
