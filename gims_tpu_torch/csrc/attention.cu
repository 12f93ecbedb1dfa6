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
// Head widths: any D up to 8192 (bf16) and 5120 (f32). Up to 256 the two
// column-block kernels below work on column blocks of 64:
// one block for D <= 64, two for D <= 128, three for D <= 192, four for
// D <= 256 (the f32 kernel takes three as four). Columns from D up to the
// block's end are read as zeros (TMA's out-of-bounds fill, or the f32
// kernel's zero-filling copies), which add nothing to Q K^T and give output
// columns that are not stored. So D = 32 does the work of D = 64 in bf16
// (the f32 kernel skips 8-column steps past D). The bf16 kernel needs D a
// multiple of 8 (TMA's 16-byte strides): the wrapper zero-pads other widths
// and passes the scale of the true D.
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
// Wider heads (D > 256): attn_wide_tc_kernel (bf16) and attn_wide_f32_kernel
// (f32), below the two column-block kernels. No CTA can hold O for 64 rows
// of a wide head in one warpgroup's registers (32 f32 a thread per column
// block of 64) beside Q, two stages of K and V in shared memory, so the
// wide kernels split a head's columns, for both products:
//   * over the warps of a CTA of 64 query rows: two warpgroups in bf16
//     (each up to four column blocks: D <= 512 in one CTA), eight warps in
//     f32 (two row groups of 32 rows by four column quarters, up to 40
//     tiles of 8 columns: D <= 320 in one CTA);
//   * past that, over the CTAs of a thread-block cluster, which share the
//     query rows and split the column blocks evenly. A cluster holds at
//     most 16 CTAs, so D <= 8192 in bf16 and 5120 in f32; wider heads, which
//     JAX's kernel takes, are refused (they would need Q K^T over more
//     columns than a cluster holds, recomputed by several clusters).
//   Each warp (warpgroup) computes its partial S = Q K^T over its own
//   columns; the partials go through shared memory (distributed shared
//   memory across the cluster), and every warp of the row sums all of them
//   in one fixed order (CTA, then warp), so all hold the same bits of S and
//   two calls give the same bits. Each then runs the online softmax as the
//   kernels above (redundantly: the exponentials are a small share at these
//   widths) and O += P V on its own columns only, P from registers. No
//   product is computed twice and no accumulator leaves registers: nothing
//   is allocated beside the output.
//   * bf16: wgmma (Q K^T m64n{48|32}k16 with Q and K in shared memory, P V
//     m64n64k16 with P from registers and V read with the transpose flag),
//     Q and the K and V tiles through TMA (the tensor maps of attn_tc_kernel)
//     into two stages, each warpgroup loading only its own column blocks
//     (its thread 0 issues the copies; mbarriers per warpgroup and stage).
//     Key tiles of 48 keys where a CTA holds five column blocks (D <= 320,
//     and 513-640 over two CTAs), 32 where it holds six to eight: Q, two
//     stages of K and V and the double-buffered partial scores fit 227 KB
//     (attn_wide_tc_kernel<3, 48> and <4, 32>, at most 3 or 4 blocks a
//     warpgroup). wide_plan makes the split, and gims_attention_key_tile
//     gives its key tile to Python's plain version.
//   * f32: split f32 on mma.sync as attn_f32_kernel, tiles of 32 keys by
//     cp.async, one tile of K and one of V (V(t) lands during Q K^T(t), K(t +
//     1) during P V(t)); a warp's rows are two 16-row tiles, so each split K
//     or V fragment feeds two products.
//   Bound: the same operations as the narrow heads (bf16 tensor cores; f32
//   as three TF32 products at the TF32 peak). The exchange of the partial S
//   sits between the two products of a tile, and the warps of a row wait
//   for each other there once a tile. On the H100 bf16 reaches 14-17% of
//   its bound and f32 20-22% (PERF.md §6): the f32 kernel runs mma.sync at
//   about the rate attn_f32_kernel reaches at D = 64 (28% of its bound);
//   what holds bf16 back is not known: K and V multicast to two CTAs made
//   it 18% slower, and a longer prefetch of them or the next tile's Q K^T
//   issued before this tile's softmax moved it by 6% or less either way
//   (PERF.md §6, PR 18).
//
// f32: attn_f32_kernel, split f32 on the tensor cores (3xTF32). A single
// TF32 product keeps 11 bits of each operand, which moves the f32 result
// past its 1e-4 check, so every operand x is split into hi = tf32(x) and
// lo = x - hi (a TF32 value too) and each product is lo*hi + hi*lo + hi*hi
// in f32 accumulators: f32's precision but for terms below 2^-21 of the
// product. Both products run so, Q K^T and P V, with P kept in f32 (split
// like the inputs), never rounded to a narrower type. Bound: 3 TF32 products
// of 2*B*H*N*M*D operations each at the TF32 tensor-core peak (495 TFLOP/s
// dense), 0.83 ms at the 8192 bucket against 2.05 ms for the same work in
// f32 FMAs on the CUDA cores.
//   * mma.sync m16n8k8 (warp-level), not wgmma: wgmma's TF32 takes neither
//     operand transposed, so V (keys x columns in memory) would need a
//     transposed copy per tile, and hi and lo in shared memory would double
//     the tiles; with mma.sync each thread reads its fragments from the
//     tiles as they arrived and splits them in registers.
//   * One block of 4 warps per (b*h, 128 query rows at D <= 64, else 64):
//     each warp owns 32 (or 16) rows, Q's and P's fragments in registers, S
//     and O as f32 accumulators (the mma's C layout). Q is staged once in
//     shared memory; K and V tiles of 64 keys (32 at D > 64) arrive through
//     cp.async (16-byte copies where rows are 16-byte aligned, else 4-byte),
//     double-buffered, the next tile in flight while this one is used. Rows
//     are padded to D + 4 floats, so the fragment reads hit 32 banks.
//   * P's accumulator layout gives a thread keys 2t and 2t + 1 of each 8,
//     where the A fragment of P V wants k-indices t and t + 4: reading V's
//     rows in that order permutes keys within each 8, which the sum over
//     keys does not see, so P goes from S's registers to P V's directly.
//   * The online softmax in base 2 in f32 registers, the row max across the
//     4 lanes that share a row, as the bf16 kernel.
// It needs a unit D stride (the wrapper refuses others) and reads any other
// strides and alignment.

#include <cuda.h>  // CUtensorMap and its enums (header only)
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kBlockD = 64;   // columns per block of the head dim
constexpr int kMaxD = 256;    // widest head dim of the block kernels: four blocks
constexpr float kNegInf = -1e9f;
constexpr int kMaxDevices = 64;

struct Strides {
  long long b, n, h, d;
};

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

// D (64 x 48, f32) = A (64 x 16) * B (16 x 48) (+ D where scale_d != 0); A and B
// K-major in shared memory, 128-byte swizzled.
__device__ __forceinline__ void wgmma_m64n48k16_ss(float (&d)[24], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32, f32) = A (64 x 16) * B (16 x 32) (+ D where scale_d != 0); A and B
// K-major in shared memory, 128-byte swizzled.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// S (64 x kKeys) = Q K^T over one k-step of 16 columns: m64n{kKeys}k16 for
// tiles of 128, 64, 48 or 32 keys.
template <int kKeys>
__device__ __forceinline__ void wgmma_qk(float (&d)[kKeys / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (kKeys == 128) {
    wgmma_m64n128k16_ss(d, desc_a, desc_b, scale_d);
  } else if constexpr (kKeys == 64) {
    wgmma_m64n64k16_ss(d, desc_a, desc_b, scale_d);
  } else if constexpr (kKeys == 48) {
    wgmma_m64n48k16_ss(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(kKeys == 32, "key tiles of 128, 64, 48 or 32");
    wgmma_m64n32k16_ss(d, desc_a, desc_b, scale_d);
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

// --------------------------------------- f32 kernel: split f32 on the tensor cores

constexpr int kF32Warps = 4;  // warps per block, each 16 * kMT query rows
constexpr int kF32Threads = 32 * kF32Warps;

// Per padded width kD (64, 128, 256): 16-row tiles per warp, keys per tile,
// and the floats of one shared-memory row (kD + 4: a warp's fragment reads
// of Q, K and V then fall in 32 different banks).
template <int kD>
struct F32Cfg {
  static constexpr int kMT = kD == 64 ? 2 : 1;
  static constexpr int kRows = kF32Warps * 16 * kMT;  // query rows per block: 128, 64
  static constexpr int kKeys = kD == 64 ? 64 : 32;
  static constexpr int kStride = kD + 4;
  // Q, then two stages of K, V and the key bias
  static constexpr int kSmemBytes = 4 * (kRows * kStride + 2 * 2 * kKeys * kStride + 2 * kKeys);
};

// x = hi + lo with hi = x rounded to TF32 (nearest, ties away) and lo the
// exact rest with its low 13 bits cleared (a valid TF32 operand): the
// products hi*hi + hi*lo + lo*hi carry f32's precision but for lo*lo and
// lo's truncation, each below 2^-21 of the product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d (16 x 8, f32) += a (16 x 8, TF32, row major) * b (8 x 8, TF32, column major)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in split f32, the small terms first
__device__ __forceinline__ void mma_f32x3(float (&d)[4], const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4], uint32_t b_hi0,
                                          uint32_t b_hi1, uint32_t b_lo0, uint32_t b_lo1) {
  mma_tf32(d, a_lo, b_hi0, b_hi1);
  mma_tf32(d, a_hi, b_lo0, b_lo1);
  mma_tf32(d, a_hi, b_hi0, b_hi1);
}

// Asynchronous copies into shared memory; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows row0 .. row0 + R of one (b, h) slice (base, row stride sn, unit
// column stride) into a tile of R rows of kD + 4 floats; rows at or past
// nrows and columns at or past D read as zeros. vec: 16-byte copies (D a
// multiple of 4, 16-byte aligned rows), else 4-byte copies.
template <int R, int kD>
__device__ __forceinline__ void load_rows_f32(float* tile, const float* base, long long sn,
                                              int row0, int nrows, int D, bool vec) {
  constexpr int kS = kD + 4;
  if (vec) {
    constexpr int kChunks = kD / 4;
    for (int i = threadIdx.x; i < R * kChunks; i += kF32Threads) {
      const int r = i / kChunks;
      const int c = 4 * (i % kChunks);
      const bool in = row0 + r < nrows && c < D;
      cp_async16(tile + r * kS + c, in ? base + (long long)(row0 + r) * sn + c : base, in);
    }
  } else {
    for (int i = threadIdx.x; i < R * kD; i += kF32Threads) {
      const int r = i / kD;
      const int c = i % kD;
      const bool in = row0 + r < nrows && c < D;
      cp_async4(tile + r * kS + c, in ? base + (long long)(row0 + r) * sn + c : base, in);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kF32Threads, kD == 256 ? 1 : 2) attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ key_mask, float* __restrict__ out, int N, int M, int H, int D,
    Strides qs, Strides ks, Strides vs, Strides os, long long mask_sb, float scale_log2,
    float* __restrict__ stats, int vec) {
  using Cfg = F32Cfg<kD>;
  constexpr int kMT = Cfg::kMT;
  constexpr int kKeys = Cfg::kKeys;
  constexpr int kS = Cfg::kStride;
  extern __shared__ __align__(16) float f32_smem[];
  float* q_sm = f32_smem;                      // kRows x kS
  float* k_sm = q_sm + Cfg::kRows * kS;        // 2 stages of kKeys x kS
  float* v_sm = k_sm + 2 * kKeys * kS;         // 2 stages of kKeys x kS
  float* bias_sm = v_sm + 2 * kKeys * kS;      // 2 stages of kKeys

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // this thread's rows g, g + 8 of each 16-row tile
  const int t = lane % 4;  // and its fragment columns
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * Cfg::kRows;
  const int n_tiles = (M + kKeys - 1) / kKeys;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const uint8_t* mb = key_mask + b * mask_sb;
  const int steps = (D + 7) / 8;  // 8-column steps below D: Q K^T's k-steps, O's n-tiles

  auto load_tile = [&](int tile, int stage) {
    const int key0 = tile * kKeys;
    load_rows_f32<kKeys, kD>(k_sm + stage * kKeys * kS, kb, ks.n, key0, M, D, vec);
    load_rows_f32<kKeys, kD>(v_sm + stage * kKeys * kS, vb, vs.n, key0, M, D, vec);
    for (int j = threadIdx.x; j < kKeys; j += kF32Threads) {
      const int key = key0 + j;
      bias_sm[stage * kKeys + j] = key < M ? (mb[key] ? 0.f : kNegInf) : -INFINITY;
    }
  };
  load_rows_f32<Cfg::kRows, kD>(q_sm, q + b * qs.b + h * qs.h, qs.n, q0, N, D, vec);
  load_tile(0, 0);
  cp_async_commit();

  float o[kMT][kD / 8][4];  // O: rows g, g + 8; columns 8j + 2t, + 1
  float m_run[kMT][2], l_run[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
    }
    m_run[mt][0] = m_run[mt][1] = kNegInf;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }
  const float* q_warp = q_sm + warp * 16 * kMT * kS;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();  // empty on the last tile
    cp_async_wait1();   // Q and this tile landed
    __syncthreads();
    const float* kt = k_sm + stage * kKeys * kS;
    const float* vt = v_sm + stage * kKeys * kS;
    const float* bt = bias_sm + stage * kKeys;

    // S = Q K^T (16 x 8 tiles: rows g, g + 8; keys 8j + 2t, + 1)
    float s[kMT][kKeys / 8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      if (kk >= steps) break;
      uint32_t a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* qr = q_warp + (16 * mt + g) * kS + 8 * kk + t;
        split_tf32(qr[0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32(qr[8 * kS], a_hi[mt][1], a_lo[mt][1]);
        split_tf32(qr[4], a_hi[mt][2], a_lo[mt][2]);
        split_tf32(qr[8 * kS + 4], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        const float* kr = kt + (8 * nt + g) * kS + 8 * kk + t;
        uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
        split_tf32(kr[0], b_hi0, b_lo0);
        split_tf32(kr[4], b_hi1, b_lo1);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_f32x3(s[mt][nt], a_hi[mt], a_lo[mt], b_hi0, b_hi1, b_lo0, b_lo1);
        }
      }
    }

    // online softmax, base 2, per row: the row's max across the 4 lanes that share it
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx0 = m_run[mt][0], mx1 = m_run[mt][1];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float2 bj = *reinterpret_cast<const float2*>(bt + 8 * j + 2 * t);
        s[mt][j][0] = fmaf(s[mt][j][0], scale_log2, bj.x);
        s[mt][j][1] = fmaf(s[mt][j][1], scale_log2, bj.y);
        s[mt][j][2] = fmaf(s[mt][j][2], scale_log2, bj.x);
        s[mt][j][3] = fmaf(s[mt][j][3], scale_log2, bj.y);
        mx0 = fmaxf(mx0, fmaxf(s[mt][j][0], s[mt][j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float corr0 = exp2f(m_run[mt][0] - mx0);
      const float corr1 = exp2f(m_run[mt][1] - mx1);
      m_run[mt][0] = mx0;
      m_run[mt][1] = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        s[mt][j][0] = exp2f(s[mt][j][0] - mx0);
        s[mt][j][1] = exp2f(s[mt][j][1] - mx0);
        s[mt][j][2] = exp2f(s[mt][j][2] - mx1);
        s[mt][j][3] = exp2f(s[mt][j][3] - mx1);
        sum0 += s[mt][j][0] + s[mt][j][1];
        sum1 += s[mt][j][2] + s[mt][j][3];
      }
      l_run[mt][0] = l_run[mt][0] * corr0 + sum0;
      l_run[mt][1] = l_run[mt][1] * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[mt][j][0] *= corr0;
        o[mt][j][1] *= corr0;
        o[mt][j][2] *= corr1;
        o[mt][j][3] *= corr1;
      }
    }

    // O += P V, P kept in f32 (split like the inputs). A thread's P holds keys
    // 2t and 2t + 1 of each 8; taken as the A fragment's k-indices t and
    // t + 4, with V's rows read in the same order, the keys are permuted
    // within each 8, which the sum over keys does not see.
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      uint32_t a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        split_tf32(s[mt][kk][0], a_hi[mt][0], a_lo[mt][0]);  // row g,     key 2t
        split_tf32(s[mt][kk][2], a_hi[mt][1], a_lo[mt][1]);  // row g + 8, key 2t
        split_tf32(s[mt][kk][1], a_hi[mt][2], a_lo[mt][2]);  // row g,     key 2t + 1
        split_tf32(s[mt][kk][3], a_hi[mt][3], a_lo[mt][3]);  // row g + 8, key 2t + 1
      }
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) {
        if (nt >= steps) break;
        const float* vr = vt + (8 * kk + 2 * t) * kS + 8 * nt + g;
        uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
        split_tf32(vr[0], b_hi0, b_lo0);   // k-index t:     key 2t
        split_tf32(vr[kS], b_hi1, b_lo1);  // k-index t + 4: key 2t + 1
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_f32x3(o[mt][nt], a_hi[mt], a_lo[mt], b_hi0, b_hi1, b_lo0, b_lo1);
        }
      }
    }
    __syncthreads();  // this stage is read before the next tile's copies land in it
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const float sum0 = quad_sum(l_run[mt][0]);  // the row's l; m_run is the row's already
    const float sum1 = quad_sum(l_run[mt][1]);
    const float den0 = fmaxf(sum0, 1e-30f);
    const float den1 = fmaxf(sum1, 1e-30f);
    const int row0 = q0 + warp * 16 * kMT + 16 * mt + g;
    const int row1 = row0 + 8;
    if (stats != nullptr && t == 0) {
      if (row0 < N) {
        float* st = stats + (((long long)b * N + row0) * H + h) * 2;
        st[0] = m_run[mt][0];
        st[1] = sum0;
      }
      if (row1 < N) {
        float* st = stats + (((long long)b * N + row1) * H + h) * 2;
        st[0] = m_run[mt][1];
        st[1] = sum1;
      }
    }
    float* op0 = out + b * os.b + (long long)row0 * os.n + h * os.h;
    float* op1 = op0 + 8 * os.n;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (row0 < N) {
        if (col < D) op0[col * os.d] = o[mt][j][0] / den0;
        if (col + 1 < D) op0[(col + 1) * os.d] = o[mt][j][1] / den0;
      }
      if (row1 < N) {
        if (col < D) op1[col * os.d] = o[mt][j][2] / den1;
        if (col + 1 < D) op1[(col + 1) * os.d] = o[mt][j][3] / den1;
      }
    }
  }
}

// ------------------------------------------------- wide heads (D > 256)

constexpr int kWideThreads = 256;  // two warpgroups (bf16) or 8 warps (f32) per CTA
constexpr int kWideRows = 64;      // query rows per CTA
constexpr int kWideBlocks = 8;     // bf16: column blocks of 64 a CTA, at most
constexpr int kWideTiles = 40;     // f32: 8-column tiles a CTA, at most (320 columns)
constexpr int kWideF32Keys = 32;   // f32: keys per tile
constexpr int kMaxCluster = 16;    // CTAs that share one head's columns, at most

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The partial scores' exchange barrier: the CTA's, or, where a head's
// columns span the CTAs of a cluster, the cluster's (release and acquire).
__device__ __forceinline__ void exchange_sync(int nz) {
  if (nz == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

__device__ __forceinline__ float key_bias(const uint8_t* mb, int key, int M) {
  return key < M ? (mb[key] ? 0.f : kNegInf) : -INFINITY;
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of attn_wide_tc_kernel<C, kKeys> at cb column blocks a CTA,
// after its 1024-byte alignment: Q (64 rows), two stages of K and V (kKeys
// rows), the two warpgroups' partial scores (double-buffered), 6 mbarriers.
template <int kKeys>
struct WideTcSmem {
  int cb;
  __host__ __device__ size_t k() const { return size_t(cb) * kWideRows * kBlockD * 2; }
  __host__ __device__ size_t v() const { return k() + size_t(2) * cb * kKeys * kBlockD * 2; }
  __host__ __device__ size_t xs() const { return v() + size_t(2) * cb * kKeys * kBlockD * 2; }
  __host__ __device__ size_t bars() const { return xs() + size_t(2) * 2 * kWideRows * kKeys * 4; }
  __host__ __device__ size_t bytes() const { return bars() + 6 * 8; }
};

// bf16, heads past 256: one CTA per (64 query rows, b*h, column chunk z). The
// CTA's chunk is nbz <= cb column blocks of 64; its first warpgroup owns the
// first half (rounded up), its second the rest, for both products. Per key
// tile each warpgroup computes its partial S over its own column blocks on
// wgmma (Q and K from shared memory), the partials go through shared memory
// (distributed shared memory across the cluster when the head spans CTAs) and
// every warpgroup sums all of them in one fixed order (chunk, then
// warpgroup), so all hold the same bits of S. Each then runs the online
// softmax (as attn_tc_kernel) and O += P V on its own column blocks, P from
// registers. Each warpgroup loads its own Q blocks once and its own K and V
// blocks per tile through TMA into two stages, the next tile in flight
// while this one is used; its thread 0 issues the copies.
template <int C, int kKeys>
__global__ void __launch_bounds__(kWideThreads, 1) attn_wide_tc_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const uint8_t* __restrict__ key_mask,
    __nv_bfloat16* __restrict__ out, int N, int M, int H, int D, int cb, long long osb,
    long long osn, long long osh, long long mask_sb, float scale_log2,
    float* __restrict__ stats) {
  constexpr uint32_t kQBytes = kWideRows * kBlockD * 2;
  constexpr uint32_t kTileBytes = kKeys * kBlockD * 2;
  constexpr int kPairs = kKeys / 4;  // a thread's score pairs per tile
  extern __shared__ uint8_t wide_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wide_raw) + 1023) & ~uintptr_t(1023));
  const WideTcSmem<kKeys> lay{cb};
  __nv_bfloat16* q_sm = reinterpret_cast<__nv_bfloat16*>(sm);
  __nv_bfloat16* k_sm = reinterpret_cast<__nv_bfloat16*>(sm + lay.k());
  __nv_bfloat16* v_sm = reinterpret_cast<__nv_bfloat16*>(sm + lay.v());
  float2* xs = reinterpret_cast<float2*>(sm + lay.xs());     // [buffer][warpgroup][pair][thread]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bars());  // [warpgroup][stage]
  uint64_t* q_full = full + 4;                                    // [warpgroup]

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * kWideRows;
  const int z = blockIdx.z;
  const int nz = gridDim.z;
  const int blk0 = z * cb;  // the CTA's first column block
  const int nbz = min(cb, (D + kBlockD - 1) / kBlockD - blk0);
  const int half = (nbz + 1) / 2;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int wb0 = wg == 0 ? 0 : half;  // the warpgroup's first block in the CTA
  const int nbw = wg == 0 ? half : nbz - half;
  const int n_tiles = (M + kKeys - 1) / kKeys;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r_lo = 16 * warp + lane / 4;  // this thread's rows: r_lo, r_lo + 8
  const int cq = lane % 4;                // its column pairs: 8j + 2cq, +1
  uint64_t* my_full = full + 2 * wg;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 6; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the barriers are set up, and every CTA of the cluster has started
  // before any reads a peer's shared memory
  exchange_sync(nz);

  auto load_tile = [&](int t, int s) {
    mbar_arrive_expect_tx(&my_full[s], 2 * nbw * kTileBytes);
    for (int i = 0; i < nbw; ++i) {
      const int c = wb0 + i;
      const int col = kBlockD * (blk0 + c);
      tma_load(k_sm + (s * cb + c) * kKeys * kBlockD, &k_map, &my_full[s], col, h, t * kKeys, b);
      tma_load(v_sm + (s * cb + c) * kKeys * kBlockD, &v_map, &my_full[s], col, h, t * kKeys, b);
    }
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(&q_full[wg], nbw * kQBytes);
    for (int i = 0; i < nbw; ++i) {
      tma_load(q_sm + (wb0 + i) * kWideRows * kBlockD, &q_map, &q_full[wg],
               kBlockD * (blk0 + wb0 + i), h, q0, b);
    }
    load_tile(0, 0);
  }

  float o[C][32];  // O's block i of this warpgroup: columns 8j + 2cq, +1
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int r = 0; r < 32; ++r) o[i][r] = 0.f;
  }
  float m_lo = kNegInf, m_hi = kNegInf;  // running max (base 2)
  float l_lo = 0.f, l_hi = 0.f;          // this thread's share of the running sum
  const uint8_t* mb = key_mask + b * mask_sb;
  mbar_wait(&q_full[wg], 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    // the warpgroup is done with tile t - 1, so its stage s ^ 1 is free
    named_sync(1 + wg, 128);
    if (tid == 0 && t + 1 < n_tiles) load_tile(t + 1, s ^ 1);
    mbar_wait(&my_full[s], (t >> 1) & 1);

    // the partial S over this warpgroup's column blocks
    float sc[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (i < nbw) {
        const uint64_t q_desc = sw128_desc(q_sm + (wb0 + i) * kWideRows * kBlockD);
        const uint64_t k_desc = sw128_desc(k_sm + (s * cb + wb0 + i) * kKeys * kBlockD);
#pragma unroll
        for (int kk = 0; kk < kBlockD / 16; ++kk) {  // +32 bytes per step
          wgmma_qk<kKeys>(sc, q_desc + 2 * kk, k_desc + 2 * kk, 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // S: every partial of the head, summed in the order (chunk, warpgroup);
    // a thread's pairs are those of the same thread of every warpgroup
    float2* buf = xs + (t & 1) * 2 * kPairs * 128;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      buf[(wg * kPairs + j) * 128 + tid] = make_float2(sc[2 * j], sc[2 * j + 1]);
    }
    exchange_sync(nz);
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
    auto add_partials = [&](const float2* src) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const float2 x = src[(w * kPairs + j) * 128 + tid];
          sc[2 * j] += x.x;
          sc[2 * j + 1] += x.y;
        }
      }
    };
    if (nz == 1) {
      add_partials(buf);
    } else {
      for (int zz = 0; zz < nz; ++zz) add_partials(cg::this_cluster().map_shared_rank(buf, zz));
    }

    // online softmax, base 2, as attn_tc_kernel; sc[4j + 0/1] are row r_lo,
    // sc[4j + 2/3] row r_lo + 8, at keys 8j + 2cq and 8j + 2cq + 1
    const int key0 = t * kKeys;
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const int key = key0 + 8 * j + 2 * cq;
      const float b0 = key_bias(mb, key, M);
      const float b1 = key_bias(mb, key + 1, M);
      sc[4 * j + 0] = fmaf(sc[4 * j + 0], scale_log2, b0);
      sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale_log2, b1);
      sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale_log2, b0);
      sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale_log2, b1);
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
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      p[2 * j + 0] = pack_bf16(p0, p1);
      p[2 * j + 1] = pack_bf16(p2, p3);
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[i][4 * j + 0] *= corr_lo;
        o[i][4 * j + 1] *= corr_lo;
        o[i][4 * j + 2] *= corr_hi;
        o[i][4 * j + 3] *= corr_hi;
      }
      fence_regs(o[i]);
    }

    // O += P V on this warpgroup's blocks: kKeys / 16 k-steps of 16 keys
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (i < nbw) {
        const uint64_t v_desc = sw128_desc(v_sm + (s * cb + wb0 + i) * kKeys * kBlockD);
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          wgmma_m64n64k16_rs(o[i], p[4 * kk + 0], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                             v_desc + 128 * kk);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < C; ++i) fence_regs(o[i]);
  }
  // no CTA leaves while a peer may still read its last scores
  if (nz > 1) cg::this_cluster().sync();

  const float sum_lo = quad_sum(l_lo);  // the row's l; m_lo is the row's already
  const float sum_hi = quad_sum(l_hi);
  const float den_lo = fmaxf(sum_lo, 1e-30f);
  const float den_hi = fmaxf(sum_hi, 1e-30f);
  const int row_lo = q0 + r_lo;
  const int row_hi = row_lo + 8;
  if (stats != nullptr && z == 0 && wg == 0 && cq == 0) {  // every warpgroup holds the same
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
  for (int i = 0; i < C; ++i) {
    if (i >= nbw) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = kBlockD * (blk0 + wb0 + i) + 8 * j;  // + 2cq; D is a multiple of 8
      if (col >= D) continue;
      if (row_lo < N) {
        *reinterpret_cast<uint32_t*>(ob + row_lo * osn + col) =
            pack_bf16(o[i][4 * j + 0] / den_lo, o[i][4 * j + 1] / den_lo);
      }
      if (row_hi < N) {
        *reinterpret_cast<uint32_t*>(ob + row_hi * osn + col) =
            pack_bf16(o[i][4 * j + 2] / den_hi, o[i][4 * j + 3] / den_hi);
      }
    }
  }
}

// Rows row0 .. row0 + R and columns col0 .. col0 + w of one (b, h) slice
// (base, row stride sn, unit column stride) into a tile of R rows of kS
// floats; rows at or past nrows and columns at or past D read as zeros. A
// warp copies a row at a time. vec: 16-byte copies (D and w multiples of 4,
// 16-byte aligned rows).
template <int R>
__device__ __forceinline__ void load_rows_wide(float* tile, int kS, const float* base,
                                               long long sn, int row0, int nrows, int col0, int w,
                                               int D, bool vec) {
  const int lane = threadIdx.x % 32;
  const int step = vec ? 4 : 1;
  for (int r = threadIdx.x / 32; r < R; r += kWideThreads / 32) {
    const bool row_in = row0 + r < nrows;
    const float* src_row = base + (long long)(row_in ? row0 + r : 0) * sn + col0;
    float* dst_row = tile + r * kS;
    for (int c = step * lane; c < w; c += 32 * step) {
      const bool in = row_in && col0 + c < D;
      if (vec) {
        cp_async16(dst_row + c, in ? src_row + c : base, in);
      } else {
        cp_async4(dst_row + c, in ? src_row + c : base, in);
      }
    }
  }
}

// Shared memory of attn_wide_f32_kernel at ntc 8-column tiles a CTA: Q (64
// rows), one tile of K and one of V (rows of 8 ntc + 4 floats), the tile's
// key bias, the partial scores of its 8 warps (one buffer, two where the
// head spans a cluster).
__host__ __device__ inline size_t wide_f32_smem(int ntc, int nz) {
  return size_t(4) * ((kWideRows + 2 * kWideF32Keys) * (8 * ntc + 4) + kWideF32Keys) +
         size_t(nz > 1 ? 2 : 1) * kWideThreads * 2 * (kWideF32Keys / 8) * 16;
}

// f32, heads past 256: split f32 on the tensor cores, as attn_f32_kernel, with
// the columns split as in attn_wide_tc_kernel. One CTA of 8 warps per (64
// query rows, b*h, column chunk z); the chunk is ntz <= ntc tiles of 8
// columns. Warp (r, w) = (warp % 2, warp / 2) owns rows 32r .. 32r + 31 (two
// 16-row tiles, so each split K or V fragment feeds two products) and the
// w-th quarter of the chunk's column tiles, for both products: its partial S
// over its columns goes through shared memory (distributed across the
// cluster when the head spans CTAs), and the four warps of row group r sum
// all of the head's partials in the order (chunk, w), so they hold the same
// bits of S; each runs the online softmax and O += P V on its own columns, P
// kept in f32. Q is staged once; one tile of 32 keys of K and one of V
// arrive through cp.async, V(t) during Q K^T(t), K(t + 1) during P V(t),
// and the key bias a tile ahead.
// Rows are padded to 8 ntc + 4 floats (an odd multiple of 4), so the
// fragment reads hit 32 banks.
__global__ void __launch_bounds__(kWideThreads, 1) attn_wide_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ key_mask, float* __restrict__ out, int N, int M, int H, int D,
    int ntc, Strides qs, Strides ks, Strides vs, Strides os, long long mask_sb, float scale_log2,
    float* __restrict__ stats, int vec) {
  constexpr int kKeys = kWideF32Keys;
  constexpr int kCT = kWideTiles / 4;  // a warp's column tiles, at most
  constexpr int kNT = kKeys / 8;       // a tile's key groups of 8
  constexpr int kXs = 4 * 2 * 2 * kNT * 32;  // float4 of one exchange buffer
  extern __shared__ __align__(16) float wide_f32_raw[];
  const int kS = 8 * ntc + 4;
  float* q_sm = wide_f32_raw;              // 64 x kS
  float* k_sm = q_sm + kWideRows * kS;     // kKeys x kS
  float* v_sm = k_sm + kKeys * kS;         // kKeys x kS
  float* bias_sm = v_sm + kKeys * kS;      // the tile's key bias
  float4* xs = reinterpret_cast<float4*>(bias_sm + kKeys);  // [buffer][w][r][mt][j][lane]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = warp % 2;
  const int w = warp / 2;
  const int g = lane / 4;  // this thread's rows g, g + 8 of each 16-row tile
  const int t = lane % 4;  // and its fragment columns
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * kWideRows;
  const int z = blockIdx.z;
  const int nz = gridDim.z;
  const int nt0 = z * ntc;  // the CTA's first column tile
  const int ntz = min(ntc, (D + 7) / 8 - nt0);
  const int quarter = (ntz + 3) / 4;
  const int gw0 = min(w * quarter, ntz);  // the warp's first column tile in the CTA
  const int ntw = min(ntz, gw0 + quarter) - gw0;
  const int col0 = 8 * nt0;
  const int n_tiles = (M + kKeys - 1) / kKeys;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const uint8_t* mb = key_mask + b * mask_sb;

  load_rows_wide<kWideRows>(q_sm, kS, q + b * qs.b + h * qs.h, qs.n, q0, N, col0, 8 * ntz, D,
                            vec);
  load_rows_wide<kKeys>(k_sm, kS, kb, ks.n, 0, M, col0, 8 * ntz, D, vec);
  cp_async_commit();
  // every CTA of the cluster has started before any reads a peer's shared memory
  if (nz > 1) cg::this_cluster().sync();

  float o[2][kCT][4];  // O: rows g, g + 8 of tile mt; columns 8i + 2t, + 1 of the warp's tile i
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < kCT; ++i) o[mt][i][0] = o[mt][i][1] = o[mt][i][2] = o[mt][i][3] = 0.f;
  }
  float m_run[2][2], l_run[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    m_run[mt][0] = m_run[mt][1] = kNegInf;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }
  const float* q_warp = q_sm + 32 * r * kS;
  // thread i < kKeys reads the mask byte of key i of the next tile a tile
  // ahead (2: past M) and stores its bias for every warp
  auto mask_byte = [&](int key) { return key < M ? int(mb[key]) : 2; };
  int mk = threadIdx.x < kKeys ? mask_byte(threadIdx.x) : 0;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kKeys;
    cp_async_wait0();  // K(tile) landed
    __syncthreads();   // for every thread; P V(tile - 1) is done, so V's tile is free
    load_rows_wide<kKeys>(v_sm, kS, vb, vs.n, key0, M, col0, 8 * ntz, D, vec);
    cp_async_commit();
    if (threadIdx.x < kKeys) {  // read after the exchange barrier below
      bias_sm[threadIdx.x] = mk == 2 ? -INFINITY : (mk ? 0.f : kNegInf);
      mk = mask_byte(key0 + kKeys + threadIdx.x);
    }

    // the partial S over this warp's column tiles (16 x 8 tiles: rows g, g + 8;
    // keys 8j + 2t, + 1)
    float s[2][kNT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kCT; ++i) {
      if (i >= ntw) break;
      const int c = 8 * (gw0 + i) + t;
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* qr = q_warp + (16 * mt + g) * kS + c;
        split_tf32(qr[0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32(qr[8 * kS], a_hi[mt][1], a_lo[mt][1]);
        split_tf32(qr[4], a_hi[mt][2], a_lo[mt][2]);
        split_tf32(qr[8 * kS + 4], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* kr = k_sm + (8 * j + g) * kS + c;
        uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
        split_tf32(kr[0], b_hi0, b_lo0);
        split_tf32(kr[4], b_hi1, b_lo1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_f32x3(s[mt][j], a_hi[mt], a_lo[mt], b_hi0, b_hi1, b_lo0, b_lo1);
        }
      }
    }

    // S: every partial of the row group, summed in the order (chunk, w)
    float4* buf = xs + (nz > 1 ? (tile & 1) * kXs : 0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        buf[(((w * 2 + r) * 2 + mt) * kNT + j) * 32 + lane] =
            make_float4(s[mt][j][0], s[mt][j][1], s[mt][j][2], s[mt][j][3]);
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
      }
    }
    exchange_sync(nz);  // also: every warp is done with K's tile
    if (tile + 1 < n_tiles) {
      load_rows_wide<kKeys>(k_sm, kS, kb, ks.n, key0 + kKeys, M, col0, 8 * ntz, D, vec);
    }
    cp_async_commit();  // empty on the last tile
    auto add_partials = [&](const float4* src) {
#pragma unroll
      for (int ww = 0; ww < 4; ++ww) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const float4 x = src[(((ww * 2 + r) * 2 + mt) * kNT + j) * 32 + lane];
            s[mt][j][0] += x.x;
            s[mt][j][1] += x.y;
            s[mt][j][2] += x.z;
            s[mt][j][3] += x.w;
          }
        }
      }
    };
    if (nz == 1) {
      add_partials(buf);
    } else {
      for (int zz = 0; zz < nz; ++zz) add_partials(cg::this_cluster().map_shared_rank(buf, zz));
    }

    // online softmax, base 2, as attn_f32_kernel
    float2 bias[kNT];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      bias[j] = *reinterpret_cast<const float2*>(bias_sm + 8 * j + 2 * t);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float mx0 = m_run[mt][0], mx1 = m_run[mt][1];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[mt][j][0] = fmaf(s[mt][j][0], scale_log2, bias[j].x);
        s[mt][j][1] = fmaf(s[mt][j][1], scale_log2, bias[j].y);
        s[mt][j][2] = fmaf(s[mt][j][2], scale_log2, bias[j].x);
        s[mt][j][3] = fmaf(s[mt][j][3], scale_log2, bias[j].y);
        mx0 = fmaxf(mx0, fmaxf(s[mt][j][0], s[mt][j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float corr0 = exp2f(m_run[mt][0] - mx0);
      const float corr1 = exp2f(m_run[mt][1] - mx1);
      m_run[mt][0] = mx0;
      m_run[mt][1] = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[mt][j][0] = exp2f(s[mt][j][0] - mx0);
        s[mt][j][1] = exp2f(s[mt][j][1] - mx0);
        s[mt][j][2] = exp2f(s[mt][j][2] - mx1);
        s[mt][j][3] = exp2f(s[mt][j][3] - mx1);
        sum0 += s[mt][j][0] + s[mt][j][1];
        sum1 += s[mt][j][2] + s[mt][j][3];
      }
      l_run[mt][0] = l_run[mt][0] * corr0 + sum0;
      l_run[mt][1] = l_run[mt][1] * corr1 + sum1;
#pragma unroll
      for (int i = 0; i < kCT; ++i) {
        o[mt][i][0] *= corr0;
        o[mt][i][1] *= corr0;
        o[mt][i][2] *= corr1;
        o[mt][i][3] *= corr1;
      }
    }

    cp_async_wait1();  // V(tile) landed (K(tile + 1) may be in flight)
    __syncthreads();
    // O += P V on this warp's column tiles, P kept in f32; keys permuted
    // within each 8 as in attn_f32_kernel
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        split_tf32(s[mt][kk][0], a_hi[mt][0], a_lo[mt][0]);  // row g,     key 2t
        split_tf32(s[mt][kk][2], a_hi[mt][1], a_lo[mt][1]);  // row g + 8, key 2t
        split_tf32(s[mt][kk][1], a_hi[mt][2], a_lo[mt][2]);  // row g,     key 2t + 1
        split_tf32(s[mt][kk][3], a_hi[mt][3], a_lo[mt][3]);  // row g + 8, key 2t + 1
      }
#pragma unroll
      for (int i = 0; i < kCT; ++i) {
        if (i >= ntw) break;
        const float* vr = v_sm + (8 * kk + 2 * t) * kS + 8 * (gw0 + i) + g;
        uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
        split_tf32(vr[0], b_hi0, b_lo0);   // k-index t:     key 2t
        split_tf32(vr[kS], b_hi1, b_lo1);  // k-index t + 4: key 2t + 1
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_f32x3(o[mt][i], a_hi[mt], a_lo[mt], b_hi0, b_hi1, b_lo0, b_lo1);
        }
      }
    }
  }
  // no CTA leaves while a peer may still read its last scores
  if (nz > 1) cg::this_cluster().sync();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float sum0 = quad_sum(l_run[mt][0]);  // the row's l; m_run is the row's already
    const float sum1 = quad_sum(l_run[mt][1]);
    const float den0 = fmaxf(sum0, 1e-30f);
    const float den1 = fmaxf(sum1, 1e-30f);
    const int row0 = q0 + 32 * r + 16 * mt + g;
    const int row1 = row0 + 8;
    if (stats != nullptr && z == 0 && w == 0 && t == 0) {  // a row group's warps hold the same
      if (row0 < N) {
        float* st = stats + (((long long)b * N + row0) * H + h) * 2;
        st[0] = m_run[mt][0];
        st[1] = sum0;
      }
      if (row1 < N) {
        float* st = stats + (((long long)b * N + row1) * H + h) * 2;
        st[0] = m_run[mt][1];
        st[1] = sum1;
      }
    }
    float* op0 = out + b * os.b + (long long)row0 * os.n + h * os.h;
    float* op1 = op0 + 8 * os.n;
#pragma unroll
    for (int i = 0; i < kCT; ++i) {
      if (i >= ntw) break;
      const int col = col0 + 8 * (gw0 + i) + 2 * t;
      if (row0 < N) {
        if (col < D) op0[col * os.d] = o[mt][i][0] / den0;
        if (col + 1 < D) op0[(col + 1) * os.d] = o[mt][i][1] / den0;
      }
      if (row1 < N) {
        if (col < D) op1[col * os.d] = o[mt][i][2] / den1;
        if (col + 1 < D) op1[(col + 1) * os.d] = o[mt][i][3] / den1;
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

// Every (b, n, h) row of an f32 tensor starts 16-byte aligned.
bool rows_aligned(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 && st.n % 4 == 0 &&
         st.h % 4 == 0;
}

template <int kD>
int launch_f32(const void* q, const void* k, const void* v, const void* key_mask, void* out,
               int B, int N, int M, int H, int D, const Strides& qs, const Strides& ks,
               const Strides& vs, const Strides& os, long long mask_sb, float scale_log2,
               float* stats, cudaStream_t stream) {
  if (qs.d != 1 || ks.d != 1 || vs.d != 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = F32Cfg<kD>::kSmemBytes;
  // the shared-memory limit is raised once per device, not on every call
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= kMaxDevices || !raised[dev])) {
    err = cudaFuncSetAttribute(attn_f32_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row of q, k and v starts 16-byte aligned
  const int vec = D % 4 == 0 && rows_aligned(q, qs) && rows_aligned(k, ks) && rows_aligned(v, vs);
  const dim3 grid((N + F32Cfg<kD>::kRows - 1) / F32Cfg<kD>::kRows, B * H);
  attn_f32_kernel<kD><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(key_mask), static_cast<float*>(out), N, M, H, D, qs, ks, vs,
      os, mask_sb, scale_log2, stats, vec);
  return static_cast<int>(cudaGetLastError());
}

// Raises `fn`'s shared-memory limit to `smem` where it is lower (per
// device) and allows clusters of up to 16 CTAs.
cudaError_t prepare_wide(const void* fn, size_t smem, int (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && raised[dev] >= static_cast<int>(smem))) {
    return err;
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = static_cast<int>(smem);
  return err;
}

// A wide kernel over (64-row tiles of N, B*H, nz column chunks), the nz CTAs
// of one (row tile, b*h) in one cluster.
template <typename... Exp, typename... Act>
int launch_wide(void (*kernel)(Exp...), int N, int BH, int nz, size_t smem, cudaStream_t stream,
                Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kWideRows - 1) / kWideRows, BH, nz);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = nz;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <int C, int kKeys>
int launch_wide_bf16(const void* q, const void* k, const void* v, const void* key_mask,
                     void* out, int B, int N, int M, int H, int D, const Strides& qs,
                     const Strides& ks, const Strides& vs, const Strides& os, long long mask_sb,
                     float scale_log2, float* stats, cudaStream_t stream, int nz, int cb) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bnhd(encode, &q_map, q, B, N, H, D, qs, kWideRows) ||
      !encode_bnhd(encode, &k_map, k, B, M, H, D, ks, kKeys) ||
      !encode_bnhd(encode, &v_map, v, B, M, H, D, vs, kKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = WideTcSmem<kKeys>{cb}.bytes() + 1024;  // + alignment slack
  static int raised[kMaxDevices] = {};
  const cudaError_t err =
      prepare_wide(reinterpret_cast<const void*>(attn_wide_tc_kernel<C, kKeys>), smem, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_wide(attn_wide_tc_kernel<C, kKeys>, N, B * H, nz, smem, stream, q_map, k_map,
                     v_map, static_cast<const uint8_t*>(key_mask),
                     static_cast<__nv_bfloat16*>(out), N, M, H, D, cb, os.b, os.n, os.h, mask_sb,
                     scale_log2, stats);
}

// How the wide-head kernels split a head of D columns: nz CTAs of one
// cluster, each of at most `per` column blocks of 64 (bf16) or tiles of 8
// (f32), as even as they go, and the keys per tile. bf16 takes the largest
// tile that fits a CTA's shared memory with two stages: 48 keys at five
// blocks (the fewest a CTA holds past 256 columns), 32 at six to eight.
struct WidePlan {
  int nz, per, keys;
};

WidePlan wide_plan(int dtype, int D) {
  const int unit = dtype == 0 ? 8 : kBlockD;
  const int cap = dtype == 0 ? kWideTiles : kWideBlocks;
  const int n = (D + unit - 1) / unit;
  const int nz = (n + cap - 1) / cap;
  const int per = (n + nz - 1) / nz;
  return {nz, per, dtype == 0 ? kWideF32Keys : per <= 5 ? 48 : 32};
}

// bf16 past 256 columns: <3, 48> (at most three blocks a warpgroup) at five
// blocks a CTA, <4, 32> at six to eight.
int launch_wide_bf16_any(const void* q, const void* k, const void* v, const void* key_mask,
                         void* out, int B, int N, int M, int H, int D, const Strides& qs,
                         const Strides& ks, const Strides& vs, const Strides& os,
                         long long mask_sb, float scale_log2, float* stats, cudaStream_t stream) {
  const WidePlan p = wide_plan(1, D);
  if (qs.d != 1 || ks.d != 1 || vs.d != 1 || os.d != 1 || D % 8 != 0 || p.nz > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto launch = p.keys == 48 ? launch_wide_bf16<3, 48> : launch_wide_bf16<4, 32>;
  return launch(q, k, v, key_mask, out, B, N, M, H, D, qs, ks, vs, os, mask_sb, scale_log2, stats,
                stream, p.nz, p.per);
}

// f32 past 256 columns: 8-column tiles over the plan's CTAs.
int launch_wide_f32(const void* q, const void* k, const void* v, const void* key_mask, void* out,
                    int B, int N, int M, int H, int D, const Strides& qs, const Strides& ks,
                    const Strides& vs, const Strides& os, long long mask_sb, float scale_log2,
                    float* stats, cudaStream_t stream) {
  const WidePlan p = wide_plan(0, D);
  if (qs.d != 1 || ks.d != 1 || vs.d != 1 || p.nz > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = wide_f32_smem(p.per, p.nz);
  static int raised[kMaxDevices] = {};
  const cudaError_t err =
      prepare_wide(reinterpret_cast<const void*>(attn_wide_f32_kernel), smem, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = D % 4 == 0 && rows_aligned(q, qs) && rows_aligned(k, ks) && rows_aligned(v, vs);
  return launch_wide(attn_wide_f32_kernel, N, B * H, p.nz, smem, stream,
                     static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<const uint8_t*>(key_mask),
                     static_cast<float*>(out), N, M, H, D, p.per, qs, ks, vs, os, mask_sb,
                     scale_log2, stats, vec);
}

// Keys per tile of the kernel that takes a head of D columns in `dtype`
// (where bf16 rounds P against the running max), 0 where none takes it.
int key_tile(int dtype, int D) {
  if (D < 1 || (dtype != 0 && dtype != 1)) return 0;
  if (D > kMaxD) {
    const WidePlan p = wide_plan(dtype, D);
    return p.nz > kMaxCluster ? 0 : p.keys;
  }
  const int blocks = (D + kBlockD - 1) / kBlockD;
  if (dtype == 0) {
    return blocks == 1 ? F32Cfg<kBlockD>::kKeys : blocks == 2 ? F32Cfg<2 * kBlockD>::kKeys
                                                              : F32Cfg<kMaxD>::kKeys;
  }
  return blocks == 1   ? Ring<1>::kKeys
         : blocks == 2 ? Ring<2>::kKeys
         : blocks == 3 ? Ring<3>::kKeys
                       : Ring<4>::kKeys;
}

int attention_fwd(const void* q, const void* k, const void* v, const void* key_mask, void* out,
                  float* stats, int dtype, int B, int N, int M, int H, int D, const Strides& qs,
                  const Strides& ks, const Strides& vs, const Strides& os, long long mask_sb,
                  float scale_log2, void* stream) {
  if (D <= 0 || B <= 0 || N <= 0 || M <= 0 || H <= 0 || B * H > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > kMaxD) {
    auto launch = dtype == 0 ? launch_wide_f32 : launch_wide_bf16_any;
    return launch(q, k, v, key_mask, out, B, N, M, H, D, qs, ks, vs, os, mask_sb, scale_log2,
                  stats, st);
  }
  const int blocks = (D + kBlockD - 1) / kBlockD;  // column blocks of 64
  if (dtype == 0) {
    auto launch = blocks == 1 ? launch_f32<kBlockD> : blocks == 2 ? launch_f32<2 * kBlockD>
                                                                  : launch_f32<kMaxD>;
    return launch(q, k, v, key_mask, out, B, N, M, H, D, qs, ks, vs, os, mask_sb, scale_log2,
                  stats, st);
  }
  auto launch = blocks == 1   ? launch_bf16<1>
                : blocks == 2 ? launch_bf16<2>
                : blocks == 3 ? launch_bf16<3>
                              : launch_bf16<4>;
  return launch(q, k, v, key_mask, out, B, N, M, H, D, qs, ks, vs, os, mask_sb, scale_log2, stats,
                st);
}

}  // namespace

// dtype: 0 = float32 (split-f32 kernel: unit D stride, any other strides),
// 1 = bfloat16 (tensor-core kernel: unit D stride, 16-byte aligned bases and
// strides, so D a multiple of 8). Any D from 1: up to 256 the column-block
// kernels, beyond the wide-head kernels (D up to 5120 in f32 and 8192 in
// bf16: a head's columns span at most a cluster of 16 CTAs). Returns a
// cudaError_t (0 = launched).
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
  return attention_fwd(q, k, v, key_mask, out, static_cast<float*>(stats), dtype, B, N, M,
                       H, D, Strides{qsb, qsn, qsh, qsd}, Strides{ksb, ksn, ksh, ksd},
                       Strides{vsb, vsn, vsh, vsd}, Strides{osb, osn, osh, osd}, mask_sb,
                       scale_log2, stream);
}

// The keys per tile of the kernel that gims_attention_fwd launches at head
// width D in dtype (0 = float32, 1 = bfloat16), 0 past the widest head it
// takes. attention.kernel_block_k and KERNEL_WIDEST_HEAD are its copies in
// Python (the plain version needs them without a card); a card test holds
// them to it.
extern "C" int gims_attention_key_tile(int dtype, int D) { return key_tile(dtype, D); }
