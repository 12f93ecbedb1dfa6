// Masked multi-head attention, forward only, for the GMatcher trunk.
//
// Replaces the TPU kernel gims_tpu/matcher/pallas_attention.py::_attn_kernel
// (reached through masked_attention_pallas): softmax(Q K^T * scale + bias) V
// with a per-key bias of 0 (valid) or -1e9 (masked), a base-2 online softmax
// in f32 with scale*log2(e) applied to the f32 scores, P rounded to V's dtype
// before P V (pallas_attention.py:75), P V accumulated in f32, and the output
// divided by max(l, 1e-30). Keys at or past M get p = 0, so a row whose keys
// are all masked gives the mean of its masked keys' V, as the direct version
// does. Padded query rows are computed like any other and masked by the
// caller. Two C entry points: gims_attention_fwd, and gims_attention_fwd_partial,
// which also writes each row's softmax statistics (below); the dtype picks the
// kernel.
//
// Partial mode (ring attention's step, matcher/ring_attention.py): beside the
// output, stats (B, N, H, 2) f32, contiguous, gets for every (b, n, h) the
// row's running max m of the base-2 scores (s * scale * log2(e) + bias) and the
// sum l of 2^(score - m) over the keys, as the online softmax ends them. The
// output is the same as without stats, so out * l with m merges with the
// partials of other key blocks: m' = max(m_a, m_b), w = l * 2^(m - m'),
// out' = (out_a w_a + out_b w_b) / (w_a + w_b). Without stats (a null
// pointer) the kernels do and store what they did before.
//
// Head widths: any D up to 256. Both kernels work on column blocks of 64:
// one block for D <= 64, two for D <= 128, three for D <= 192, four for
// D <= 256. Columns from D up to the block's end are read as zeros (TMA's
// out-of-bounds fill, or a bounds test in the f32 kernel), which add nothing
// to Q K^T and give output columns that are not stored. So D = 32 does the
// work of D = 64. The bf16 kernel needs D a multiple of 8 (TMA's 16-byte
// strides): the wrapper zero-pads other widths and passes the scale of the
// true D.
//
// What bounds it on the H100: 4*B*H*N*M*D operations (QK^T and PV, a
// multiply and an add each) against 4*B*N*H*D + 2*(B*M*H*D) elements moved,
// so it is bound by operations at every bucket the trunk uses (N = M >= 2048,
// D = 64): 137 GFLOP at 8192, 0.139 ms on the bf16 tensor cores. At D = 64
// the exponentials come close: B*H*N*M exp2 on the MUFU units (16 per clock
// per SM) take about as long as the matrix products.
//
// bf16: attn_tc_kernel, on the tensor cores.
//   * One CTA per (b*h, tile of 128 query rows): two consumer warpgroups of
//     64 rows each and one producer warp (288 threads, one CTA per SM).
//   * The producer warp loads Q once, then K and V tiles of 128 keys through
//     TMA (cp.async.bulk.tensor, 4-D tensor maps over the (B, N, H, D)
//     layout with a box of {64, 1, rows, 1}: 128-byte rows, 128-byte
//     swizzle; one box per 64-column block) into a ring of 3 stages (2 at
//     two or more column blocks, for shared memory) guarded by full/empty
//     mbarriers. Heads wider than 128 (three or four column blocks) take
//     tiles of 64 keys, so that Q, two stages of K and V, and the output
//     accumulators (32 floats per column block and thread) still fit the
//     SM's shared memory and registers. Its
//     lanes also turn the tile's uint8 key mask into the additive bias (0,
//     -1e9, or -inf past M, where TMA zero-fills K and V) in shared memory.
//   * Each consumer warpgroup computes S = Q K^T for its 64 rows with wgmma
//     (m64n128k16, or m64n64k16 at three and four column blocks, both
//     operands K-major in shared memory, f32 accumulators
//     in registers), then the softmax in registers: s*scale*log2(e) + bias,
//     the row max across the 4 lanes that share a row, one rescale of the
//     running max, sum and output per key tile. P is rounded to bf16 in
//     registers, where the accumulator layout of S is the A-operand layout
//     of the next wgmma, and O += P V runs as wgmma m64n64k16 per column
//     block with A from registers and V (keys x 64, columns contiguous) read
//     with the transpose flag.
//   * Overlap: the two consumer warpgroups run the same loop independently,
//     so one's exponentials (MUFU) issue while the other's wgmma runs.
//   * Epilogue: O / max(l, 1e-30), rounded once to bf16, stored to
//     (B, N, H, D) from registers.
//   The host builds the three CUtensorMaps per call with
//   cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint so that the
//   library needs no -lcuda. The wrapper guarantees a unit D stride and
//   16-byte aligned bases and strides, as TMA requires.
//
// f32: attn_f32_kernel, scalar FMAs (the tensor cores would round to TF32,
// which the port keeps off). One block per (b*h, tile of 64 query rows), one
// thread per query row holding q and its f32 accumulator in registers (at
// 128 and 256 columns they spill); key tiles of 64 (32 at 128 columns, 16 at
// 256) staged in shared memory, scores 16 keys at a time. It reads any
// strides.

#include <cuda.h>  // CUtensorMap and its enums (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockD = 64;   // columns per block of the head dim
constexpr int kMaxD = 256;    // widest head dim: four blocks
constexpr float kNegInf = -1e9f;
constexpr int kMaxDevices = 64;

struct Strides {
  long long b, n, h, d;
};

// ------------------------------------------------------------ f32 kernel

constexpr int kBQ = 64;   // query rows per block (one thread each)
constexpr int kCH = 16;   // keys per online-softmax update

// kD: the head dim rounded up to a column block; columns from D on are zeros.
template <int kD>
__global__ void __launch_bounds__(kBQ) attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ key_mask,
    float* __restrict__ out, int N, int M, int H, int D, Strides qs, Strides ks,
    Strides vs, Strides os, long long mask_sb, float scale_log2, float* __restrict__ stats) {
  constexpr int kBK = 64 * 64 / kD;  // keys per shared-memory tile (32 KB of K and V)
  __shared__ __align__(16) float k_tile[kBK][kD];
  __shared__ __align__(16) float v_tile[kBK][kD];
  __shared__ float bias[kBK];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int row = blockIdx.x * kBQ + threadIdx.x;
  const bool row_ok = row < N;

  float qr[kD];
  float acc[kD];
  const float* qp = q + b * qs.b + (long long)(row_ok ? row : 0) * qs.n + h * qs.h;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = row_ok && d < D ? qp[d * qs.d] * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m_run = kNegInf;
  float l_run = 0.f;

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const uint8_t* mb = key_mask + b * mask_sb;

  for (int k0 = 0; k0 < M; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < kBK * kD; idx += kBQ) {
      const int j = idx / kD;
      const int d = idx % kD;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < M && d < D) {
        kv = kb[key * ks.n + d * ks.d];
        vv = vb[key * vs.n + d * vs.d];
      }
      k_tile[j][d] = kv;
      v_tile[j][d] = vv;
    }
    if (threadIdx.x < kBK) {
      const int key = k0 + threadIdx.x;
      bias[threadIdx.x] = key < M ? (mb[key] ? 0.f : kNegInf) : -INFINITY;
    }
    __syncthreads();

    const int nk = min(kBK, M - k0);
    for (int c = 0; c < nk; c += kCH) {
      float s[kCH];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kCH; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(k_tile[c + jj]);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        s[jj] = dot + bias[c + jj];  // keys past M: -inf, p = 0 below
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m_run, cmax);
      const float corr = exp2f(m_run - m_new);
      l_run *= corr;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kCH; ++jj) {
        const float p = exp2f(s[jj] - m_new);
        l_run += p;
        const float4* vr = reinterpret_cast<const float4*>(v_tile[c + jj]);
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m_run = m_new;
    }
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    float* op = out + b * os.b + (long long)row * os.n + h * os.h;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      if (d < D) op[d * os.d] = acc[d] * inv;
    }
    if (stats != nullptr) {
      float* st = stats + (((long long)b * N + row) * H + h) * 2;
      st[0] = m_run;
      st[1] = l_run;
    }
  }
}

// ------------------------------------------------ bf16 tensor-core kernel

constexpr int kWgRows = 64;                       // query rows per consumer warpgroup
constexpr int kConsumers = 2;                     // consumer warpgroups per CTA
constexpr int kTcRows = kWgRows * kConsumers;     // 128 query rows per CTA
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kTcThreads = 32 * kConsumerWarps + 32;  // + one producer warp

// Per count of column blocks: keys per tile (128 up to two blocks, 64 beyond,
// for shared memory and registers), the K/V ring depth (3 stages at one
// column block, 2 at more), and the bytes of one K or V column block.
template <int NB>
struct Ring {
  static constexpr int kKeys = NB <= 2 ? 128 : 64;
  static constexpr int kStages = NB == 1 ? 3 : 2;
  static constexpr uint32_t kTileBytes = kKeys * kBlockD * 2;
};

// NB column blocks of 64. Every tile is 1024-byte aligned: the 128-byte
// swizzle repeats every 8 rows of 128 bytes, and both TMA and wgmma take the
// pattern from address bits.
template <int NB>
struct __align__(1024) TcSmem {
  __nv_bfloat16 q[NB][kTcRows * kBlockD];
  __nv_bfloat16 k[Ring<NB>::kStages][NB][Ring<NB>::kKeys * kBlockD];
  __nv_bfloat16 v[Ring<NB>::kStages][NB][Ring<NB>::kKeys * kBlockD];
  float bias[Ring<NB>::kStages][Ring<NB>::kKeys];
  uint64_t full[Ring<NB>::kStages];   // producer -> consumers: K, V and bias landed
  uint64_t empty[Ring<NB>::kStages];  // consumers -> producer: stage free again
  uint64_t q_full;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
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

// One box of the 4-D tensor map {D, H, N, B} into shared memory, from column
// d0; completion is reported to `bar` as transaction bytes (the whole box).
// Rows past N and columns past D are zero-filled.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int d0, int h, int n0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0), "r"(h), "r"(n0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile whose rows are
// 128 bytes: start address >> 4, leading offset 1 (unused by this layout),
// stride 1024 bytes between groups of 8 rows, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = (smem_u32(tile) & 0x3FFFF) >> 4;
  return addr | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, f32) = A (64 x 16) * B (16 x 128) (+ D where scale_d != 0); A and B
// K-major in shared memory, 128-byte swizzled.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) = A (64 x 16) * B (16 x 64) (+ D where scale_d != 0); A and B
// K-major in shared memory, 128-byte swizzled.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// S (64 x kKeys) = Q K^T over one k-step of 16 columns: m64n128k16 for tiles
// of 128 keys, m64n64k16 for tiles of 64.
template <int kKeys>
__device__ __forceinline__ void wgmma_qk(float (&d)[kKeys / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (kKeys == 128) {
    wgmma_m64n128k16_ss(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_m64n64k16_ss(d, desc_a, desc_b, scale_d);
  }
}

// D (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) * B (16 x 64); B
// MN-major in shared memory, 128-byte swizzled, read with the transpose flag.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int NB>
__global__ void __launch_bounds__(kTcThreads, 1) attn_tc_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const uint8_t* __restrict__ key_mask,
    __nv_bfloat16* __restrict__ out, int N, int M, int H, int D, long long osb, long long osn,
    long long osh, long long mask_sb, float scale_log2, float* __restrict__ stats) {
  constexpr int kStages = Ring<NB>::kStages;
  constexpr int kKeys = Ring<NB>::kKeys;
  extern __shared__ uint8_t smem_raw[];
  TcSmem<NB>& sm = *reinterpret_cast<TcSmem<NB>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * kTcRows;
  const int n_tiles = (M + kKeys - 1) / kKeys;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);                // the producer warp's 32 lanes
      mbar_init(&sm.empty[s], kConsumerWarps);   // one arrival per consumer warp
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer warp: Q once, then K, V and the key bias per tile ----
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.q_full, NB * kTcRows * kBlockD * 2);
      for (int c = 0; c < NB; ++c) tma_load(sm.q[c], &q_map, &sm.q_full, kBlockD * c, h, q0, b);
    }
    const uint8_t* mb = key_mask + b * mask_sb;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);  // round 0 passes at once
      const int key0 = t * kKeys;
      for (int i = lane; i < kKeys; i += 32) {
        const int key = key0 + i;
        sm.bias[s][i] = key < M ? (mb[key] ? 0.f : kNegInf) : -INFINITY;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * NB * Ring<NB>::kTileBytes);
        for (int c = 0; c < NB; ++c) {
          tma_load(sm.k[s][c], &k_map, &sm.full[s], kBlockD * c, h, key0, b);
          tma_load(sm.v[s][c], &v_map, &sm.full[s], kBlockD * c, h, key0, b);
        }
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
  } else {
    // ---- consumer warpgroup: 64 query rows ----
    const int wg = warp / 4;
    const int r_lo = 16 * (warp % 4) + lane / 4;  // this thread's rows: r_lo, r_lo + 8
    const int cq = lane % 4;                      // its column pairs: 8j + 2cq, +1
    float o[NB][32];  // O's column block c: columns 64c + 8j + 2cq, +1
#pragma unroll
    for (int c = 0; c < NB; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    }
    float m_lo = kNegInf, m_hi = kNegInf;  // running max (base 2)
    float l_lo = 0.f, l_hi = 0.f;          // this thread's share of the running sum

    mbar_wait(&sm.q_full, 0);
    uint64_t q_desc[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) q_desc[c] = sw128_desc(sm.q[c] + wg * kWgRows * kBlockD);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(&sm.full[s], (t / kStages) & 1);

      // S = Q K^T: 64 x kKeys f32, four k-steps of 16 per column block
      float sc[kKeys / 2];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const uint64_t k_desc = sw128_desc(sm.k[s][c]);
#pragma unroll
        for (int kk = 0; kk < kBlockD / 16; ++kk) {  // +32 bytes per step
          wgmma_qk<kKeys>(sc, q_desc[c] + 2 * kk, k_desc + 2 * kk, c + kk);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax, base 2; sc[4j + 0/1] are row r_lo, sc[4j + 2/3] row r_lo + 8,
      // at columns 8j + 2cq and 8j + 2cq + 1
      const float* bias = sm.bias[s];
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float2 bj = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * cq);
        sc[4 * j + 0] = fmaf(sc[4 * j + 0], scale_log2, bj.x);
        sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale_log2, bj.y);
        sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale_log2, bj.x);
        sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale_log2, bj.y);
        mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx_lo = quad_max(mx_lo);
      mx_hi = quad_max(mx_hi);
      const float corr_lo = exp2f(m_lo - mx_lo);
      const float corr_hi = exp2f(m_hi - mx_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      uint32_t p[kKeys / 4];  // P in bf16 pairs: the A fragments of P V
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float p0 = exp2f(sc[4 * j + 0] - m_lo);
        const float p1 = exp2f(sc[4 * j + 1] - m_lo);
        const float p2 = exp2f(sc[4 * j + 2] - m_hi);
        const float p3 = exp2f(sc[4 * j + 3] - m_hi);
        sum_lo += p0 + p1;  // l sums the f32 p, as the TPU kernel does
        sum_hi += p2 + p3;
        p[2 * j + 0] = pack_bf16(p0, p1);
        p[2 * j + 1] = pack_bf16(p2, p3);
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j + 0] *= corr_lo;
          o[c][4 * j + 1] *= corr_lo;
          o[c][4 * j + 2] *= corr_hi;
          o[c][4 * j + 3] *= corr_hi;
        }
        fence_regs(o[c]);
      }

      // O += P V: kKeys / 16 k-steps of 16 keys per column block; V rows are 128
      // bytes, so a step advances the descriptor by 16 * 128 bytes
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const uint64_t v_desc = sw128_desc(sm.v[s][c]);
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          wgmma_m64n64k16_rs(o[c], p[4 * kk + 0], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3], v_desc + 128 * kk);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(o[c]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    const float sum_lo = quad_sum(l_lo);  // the row's l; m_lo is the row's already
    const float sum_hi = quad_sum(l_hi);
    const float den_lo = fmaxf(sum_lo, 1e-30f);
    const float den_hi = fmaxf(sum_hi, 1e-30f);
    const int row_lo = q0 + wg * kWgRows + r_lo;
    const int row_hi = row_lo + 8;
    if (stats != nullptr && cq == 0) {
      if (row_lo < N) {
        float* st = stats + (((long long)b * N + row_lo) * H + h) * 2;
        st[0] = m_lo;
        st[1] = sum_lo;
      }
      if (row_hi < N) {
        float* st = stats + (((long long)b * N + row_hi) * H + h) * 2;
        st[0] = m_hi;
        st[1] = sum_hi;
      }
    }
    __nv_bfloat16* ob = out + b * osb + h * osh + 2 * cq;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kBlockD * c + 8 * j;  // + 2cq; D is a multiple of 8
        if (col >= D) continue;
        if (row_lo < N) {
          *reinterpret_cast<uint32_t*>(ob + row_lo * osn + col) =
              pack_bf16(o[c][4 * j + 0] / den_lo, o[c][4 * j + 1] / den_lo);
        }
        if (row_hi < N) {
          *reinterpret_cast<uint32_t*>(ob + row_hi * osn + col) =
              pack_bf16(o[c][4 * j + 2] / den_hi, o[c][4 * j + 3] / den_hi);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A (B, N, H, D) bf16 tensor with unit D stride as the 4-D map {D, H, N, B},
// box {64, 1, rows, 1} (one column block), 128-byte swizzle, zero fill out
// of bounds (rows past N, columns past D).
bool encode_bnhd(EncodeTiledFn encode, CUtensorMap* map, const void* base, int B, int N, int H,
                 int D, const Strides& st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.n * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {kBlockD, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
int launch_bf16(const void* q, const void* k, const void* v, const void* key_mask, void* out,
                int B, int N, int M, int H, int D, const Strides& qs, const Strides& ks,
                const Strides& vs, const Strides& os, long long mask_sb, float scale_log2,
                float* stats, cudaStream_t stream) {
  if (qs.d != 1 || ks.d != 1 || vs.d != 1 || os.d != 1 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bnhd(encode, &q_map, q, B, N, H, D, qs, kTcRows) ||
      !encode_bnhd(encode, &k_map, k, B, M, H, D, ks, Ring<NB>::kKeys) ||
      !encode_bnhd(encode, &v_map, v, B, M, H, D, vs, Ring<NB>::kKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(sizeof(TcSmem<NB>)) + 1024;  // + alignment slack
  // the shared-memory limit is raised once per device, not on every call
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= kMaxDevices || !raised[dev])) {
    err = cudaFuncSetAttribute(attn_tc_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTcRows - 1) / kTcRows, B * H);
  attn_tc_kernel<NB><<<grid, kTcThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<const uint8_t*>(key_mask),
      static_cast<__nv_bfloat16*>(out), N, M, H, D, os.b, os.n, os.h, mask_sb, scale_log2,
      stats);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_f32(const void* q, const void* k, const void* v, const void* key_mask, void* out,
               int B, int N, int M, int H, int D, const Strides& qs, const Strides& ks,
               const Strides& vs, const Strides& os, long long mask_sb, float scale_log2,
               float* stats, cudaStream_t stream) {
  const dim3 grid((N + kBQ - 1) / kBQ, B * H);
  attn_f32_kernel<kD><<<grid, kBQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(key_mask), static_cast<float*>(out), N, M, H, D, qs, ks, vs,
      os, mask_sb, scale_log2, stats);
  return static_cast<int>(cudaGetLastError());
}

int attention_fwd(const void* q, const void* k, const void* v, const void* key_mask, void* out,
                  float* stats, int dtype, int B, int N, int M, int H, int D, const Strides& qs,
                  const Strides& ks, const Strides& vs, const Strides& os, long long mask_sb,
                  float scale_log2, void* stream) {
  if (D <= 0 || D > kMaxD || B <= 0 || N <= 0 || M <= 0 || H <= 0 || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (D + kBlockD - 1) / kBlockD;  // column blocks of 64
  if (dtype == 0) {
    auto launch = blocks == 1 ? launch_f32<kBlockD> : blocks == 2 ? launch_f32<2 * kBlockD>
                                                                  : launch_f32<kMaxD>;
    return launch(q, k, v, key_mask, out, B, N, M, H, D, qs, ks, vs, os, mask_sb, scale_log2,
                  stats, st);
  }
  if (dtype == 1) {
    auto launch = blocks == 1   ? launch_bf16<1>
                  : blocks == 2 ? launch_bf16<2>
                  : blocks == 3 ? launch_bf16<3>
                                : launch_bf16<4>;
    return launch(q, k, v, key_mask, out, B, N, M, H, D, qs, ks, vs, os, mask_sb, scale_log2,
                  stats, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (scalar kernel, any strides), 1 = bfloat16 (tensor-core
// kernel: unit D stride, 16-byte aligned bases and strides, so D a multiple
// of 8). D from 1 to 256. Returns a cudaError_t (0 = launched).
extern "C" int gims_attention_fwd(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, int dtype, int B, int N, int M, int H, int D, long long qsb,
    long long qsn, long long qsh, long long qsd, long long ksb, long long ksn,
    long long ksh, long long ksd, long long vsb, long long vsn, long long vsh,
    long long vsd, long long osb, long long osn, long long osh, long long osd,
    long long mask_sb, float scale_log2, void* stream) {
  return attention_fwd(q, k, v, key_mask, out, nullptr, dtype, B, N, M, H, D,
                       Strides{qsb, qsn, qsh, qsd}, Strides{ksb, ksn, ksh, ksd},
                       Strides{vsb, vsn, vsh, vsd}, Strides{osb, osn, osh, osd}, mask_sb,
                       scale_log2, stream);
}

// gims_attention_fwd, and each row's (max, sum) of the base-2 online softmax
// into stats: (B, N, H, 2) f32, contiguous.
extern "C" int gims_attention_fwd_partial(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, void* stats, int dtype, int B, int N, int M, int H, int D, long long qsb,
    long long qsn, long long qsh, long long qsd, long long ksb, long long ksn,
    long long ksh, long long ksd, long long vsb, long long vsn, long long vsh,
    long long vsd, long long osb, long long osn, long long osh, long long osd,
    long long mask_sb, float scale_log2, void* stream) {
  if (stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return attention_fwd(q, k, v, key_mask, out, static_cast<float*>(stats), dtype, B, N, M, H,
                       D, Strides{qsb, qsn, qsh, qsd}, Strides{ksb, ksn, ksh, ksd},
                       Strides{vsb, vsn, vsh, vsd}, Strides{osb, osn, osh, osd}, mask_sb,
                       scale_log2, stream);
}
