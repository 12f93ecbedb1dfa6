// Connected-component labels of AGC's graphs: min-label propagation with
// pointer jumping, every round on the card, each graph stopping after the
// first of its rounds that changes no label.
//
// Replaces the jax.lax.while_loop over one_round of connected_components,
// connected_components_sparse and connected_components_band in
// gims_tpu/agc/graph.py (:130, :205, :464). That loop is no Pallas kernel:
// XLA keeps its trip count on the TPU. Eager PyTorch has no such loop, and a
// host loop would wait for the card once per round.
//
// Semantics (those of the JAX loop, vmapped over the batch): the first round
// always runs; then up to `rounds` more, stopping after the first round that
// changes no label. A labelling that a round leaves unchanged is a fixed
// point of the round, so each graph may stop on its own. A round is a
// neighbour step followed by three pointer jumps, label = min(label,
// label[label]); every step reads the labels as the previous step left them
// (synchronous), which is what makes capped, unconverged rounds equal JAX's.
// Integer minima are exact in any order, so the labels equal the JAX
// package's bit for bit, the capped rounds included.
//
// The neighbour step, in three layouts (S = the labels before the step):
//   dense  adj (B, N, N) bool: a node takes the minimum of S over its row;
//   band   forward band (B, N, W) bool, band[i, m] = edge(i, i + 1 + m): a
//          node takes the minimum over its forward and backward neighbours;
//   sparse nbr_ok / nbr_idx (B, N, W): a node pulls the minimum of its
//          listed neighbours, then pushes the result into each of them.
//
// Two routes, chosen by plan() from the shapes alone:
//
// Cluster route (label_cluster_kernel<MODE>), whenever a graph's labels fit
// in shared memory as uint16 (N <= 65535, and four copies of N labels plus
// two ints per owned row within the 227 KB a block of an H100 may hold: N up
// to 27,264 in every layout, at a cluster of 16). Every AGC bucket, 24576 at
// most, takes it. One graph per thread-block cluster of 4, 8 or 16 blocks, a
// block per SM; graphs never exchange data, so no barrier spans the grid,
// and the hardware queues the clusters beyond the resident ones. Every block
// holds the graph's whole label vector (S), two buffers that the neighbour
// step fills (P, by round parity) and a scratch vector (X). Each block owns
// a slice of `rows` nodes: it computes the neighbour step for its slice,
// writes the slice into every peer's P over distributed shared memory, and
// the cluster syncs (barrier.cluster, a hardware barrier). Then every block
// runs the three pointer jumps over the whole vector in its own shared
// memory (P -> X -> P -> S): the same arithmetic on the same data, so all
// blocks hold the same labels and agree, with no reduction, on whether the
// round changed anything. The neighbour step of round r + 1 writes the other
// parity of P, so a block that runs ahead never writes a buffer that a
// slower peer still reads. Per layout:
//   dense  label_pack_kernel (a launch over every SM, a warp per row) reads
//          the byte adjacency once and writes it as bits, (B, N, pitch)
//          uint32 less the diagonal, with each row's count of set bits (the
//          rows of invalid nodes stay 0). Each block then lists its rows'
//          neighbours as uint16 columns in the rest of its shared memory, by
//          one pass over their bits, and every round gathers from that list
//          with no device-memory traffic;
//   band   label_pack_kernel writes the band as bits too, (B, N, W / 32)
//          uint32. Each block lists its rows' forward and backward
//          neighbours (the W rows before its own give the backward ones) by
//          two passes over those bits, from L2, and the rounds pull from the
//          lists alone;
//   sparse a node pulls from nbr_idx and nbr_ok, read every round, then
//          pushes the pulled label into each listed neighbour (as the JAX
//          loop does): an atomicMin on the word of the owning block over
//          distributed shared memory, into a buffer that a second cluster
//          sync closes.
// In the dense and band layouts each block decides alone whether its lists
// fit (the rounds' barriers are the same either way). A block whose lists do
// not fit reads its rows' bits every round instead (the dense rows, or the
// band rows of its slice and the W before it; 1/8 of the bytes, from L2
// where they fit): the same minima. The kernel writes each block's choice
// into `listed`. AGC's graphs have 5-10 neighbours a node, and a block holds
// 9-116 a row.
//
// Global route (label_rounds_kernel<MODE>), for any larger N: the labels in
// device memory, every round in one cooperative launch with grid-wide
// barriers; the dense step rereads the byte adjacency every round. It keeps
// a changed flag per graph and round, so it reports each graph's rounds as
// the cluster route does.
//
// What bounds it now: the packing launch's one read of the valid rows'
// bytes (dense up to B N^2, 604 MB at 16 x 6144, 0.18 ms at 3.35 TB/s; band
// B N W), then per round a cluster barrier, the broadcast and the jumps (3 N
// shared-memory gathers in every block), a few microseconds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

enum Mode { kDense = 0, kBand = 1, kSparse = 2 };
constexpr int kThreads = 512;          // global route
constexpr int kMaxBlocksPerSm = 4;
constexpr int kClusterThreads = 1024;  // cluster route: one block per SM
constexpr int kPackThreads = 256;
constexpr int kMaxLabel = 65535;       // uint16 labels must hold the sentinel N
constexpr int kMaxDevices = 16;
constexpr int kNumSizes = 3;
constexpr int kClusterSizes[kNumSizes] = {4, 8, 16};
constexpr int kScanWords = 36;         // the block scan's warp sums and total

// ------------------------------------------------------------- bytes to bits

// Bits 0-3: which of the four bytes of x are not 0.
__device__ __forceinline__ uint32_t nz_nibble(uint32_t x) {
  const uint32_t n = __vcmpne4(x, 0u) & 0x01010101u;
  return (n | n >> 7 | n >> 14 | n >> 21) & 0xfu;
}

__device__ __forceinline__ uint32_t nz_bits16(uint4 v) {
  return nz_nibble(v.x) | nz_nibble(v.y) << 4 | nz_nibble(v.z) << 8 | nz_nibble(v.w) << 12;
}

// Bit t: p[t] != 0, for t < n <= 32.
__device__ __forceinline__ uint32_t byte_word(const uint8_t* p, int n) {
  uint32_t w = 0;
  for (int t = 0; t < n; ++t)
    if (__ldg(p + t)) w |= 1u << t;
  return w;
}

// Bits t with lo <= t < hi.
__device__ __forceinline__ uint32_t range_mask(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 32);
  if (hi <= lo) return 0u;
  const uint32_t below_hi = hi == 32 ? ~0u : (1u << hi) - 1u;
  return below_hi & ~((1u << lo) - 1u);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Before the cluster route: each row of L bytes (dense L = N, band L = W)
// as bits, (rows, pitch) uint32 with bit t of word w = src[row, 32 w + t] !=
// 0; the rows of invalid nodes and the words past L stay 0 (an invalid node
// pulls nothing and pushes N). Dense (deg not null): the diagonal is left
// out and deg receives each row's count of set bits. A warp per row (per
// few rows where the rows are short and deg is null). vec (L a multiple of
// 32, src 16-byte aligned): a lane per 16 bytes, neighbouring lanes on
// neighbouring bytes, two lanes per word, four loads in flight; else a lane
// per word.
__global__ void __launch_bounds__(kPackThreads) label_pack_kernel(
    const uint8_t* src, const uint8_t* valid, uint32_t* bits, int* deg, long long rows, int N,
    int L, int pitch, int vec) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int nw = (L + 31) >> 5;
  if (vec && deg == nullptr && L <= 2048) {
    // band rows are short: a warp step takes as many rows as 128 pieces of
    // 16 bytes hold, four loads in flight a lane
    const int hw = L >> 4, per = max(1, 128 / hw), pieces = per * hw;
    for (long long row0 = warp * per; row0 < rows; row0 += warps * per) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = u * 32 + lane;
        const long long row = row0 + p / hw;
        v[u] = p < pieces && row < rows && valid[row]
                   ? __ldcs(reinterpret_cast<const uint4*>(src + row * L) + p % hw)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = u * 32 + lane;
        const long long row = row0 + p / hw;
        const uint32_t x = nz_bits16(v[u]);
        const uint32_t hi = __shfl_xor_sync(0xffffffffu, x, 1);
        if ((lane & 1) == 0 && p < pieces && row < rows)
          bits[row * pitch + (p % hw) / 2] = x | hi << 16;
      }
    }
    return;
  }
  for (long long row = warp; row < rows; row += warps) {
    uint32_t* out = bits + row * pitch;
    const int diag = deg != nullptr ? static_cast<int>(row % N) : -1;
    int count = 0;
    if (!valid[row]) {
      for (int w = lane; w < pitch; w += 32) out[w] = 0u;
    } else if (vec) {
      const int hw = L >> 4;  // 16-byte pieces, two per word
      const uint4* in = reinterpret_cast<const uint4*>(src + row * L);
      for (int h0 = 0; h0 < hw; h0 += 4 * 32) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int h = h0 + u * 32 + lane;
          v[u] = h < hw ? __ldcs(in + h) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int h = h0 + u * 32 + lane, d = diag - 16 * h;
          uint32_t x = nz_bits16(v[u]);
          if (d >= 0 && d < 16) x &= ~(1u << d);
          count += __popc(x);
          const uint32_t hi = __shfl_xor_sync(0xffffffffu, x, 1);
          if ((lane & 1) == 0 && h < hw) out[h >> 1] = x | hi << 16;
        }
      }
      for (int w = nw + lane; w < pitch; w += 32) out[w] = 0u;
    } else {
      for (int w = lane; w < pitch; w += 32) {
        uint32_t x = w < nw ? byte_word(src + row * L + 32 * w, min(32, L - 32 * w)) : 0u;
        const int d = diag - 32 * w;
        if (d >= 0 && d < 32) x &= ~(1u << d);
        count += __popc(x);
        out[w] = x;
      }
    }
    count = warp_sum(count);
    if (deg != nullptr && lane == 0) deg[row] = count;
  }
}

// ------------------------------------------------------------- cluster route

struct ClusterArgs {
  const uint8_t* edges;   // nbr_ok (B, N, W), sparse only
  const int* nbr;         // nbr_idx (B, N, W), sparse only
  const uint32_t* bits;   // (B, N, pitch) from label_pack_kernel, dense and band
  const int* deg;         // (B, N) set bits per row, dense only
  const uint8_t* valid;   // (B, N)
  int* labels;            // (B, N), written
  int* rounds_run;        // (B,), written
  int* listed;            // (B, cluster size) or null, written: dense, band
  int N, W, pitch, rounds, rows;
  int list_cap;           // dense, band: neighbour-list entries the shared memory holds
};

// dst = min(src, src[src]) over the whole vector, two labels a thread-step.
// Returns whether any label differs from what dst held (the last jump).
template <bool COMPARE>
__device__ __forceinline__ int jump_all(const uint16_t* src, uint16_t* dst, int np, int N) {
  const uint32_t* s2 = reinterpret_cast<const uint32_t*>(src);
  uint32_t* d2 = reinterpret_cast<uint32_t*>(dst);
  int changed = 0;
  for (int p = threadIdx.x; p < np / 2; p += blockDim.x) {
    const uint32_t w = s2[p];
    const int l0 = w & 0xffffu, l1 = w >> 16;
    const int j0 = l0 < N ? min(l0, static_cast<int>(src[l0])) : N;
    const int j1 = l1 < N ? min(l1, static_cast<int>(src[l1])) : N;
    const uint32_t out = static_cast<uint32_t>(j0) | static_cast<uint32_t>(j1) << 16;
    if (COMPARE) changed |= out != d2[p];
    d2[p] = out;
  }
  return changed;
}

// The shared memory of one block of the cluster route that does not depend
// on the graph (bytes), and its slice. The dense and band layouts' lists of
// neighbours take the rest of the block's shared memory.
size_t cluster_smem(int mode, int N, int cs, int* rows) {
  const int r = ((N + cs - 1) / cs + 7) & ~7;  // slices of whole 16-byte words
  *rows = r;
  const size_t s = 2ull * 4 * cs * r + 4ull * r;  // S, P[2], X; a word per own row
  if (mode == kSparse) return s + 4ull * r;       // pushes received
  return s + 4ull * r + 4 * kScanWords;           // list ends, scan
}

// In place over v[0, n): v[k] = v[0] + ... + v[k - 1]. Returns the total.
// wsum: kScanWords ints of shared memory.
__device__ int block_exclusive_scan(int* v, int n, int* wsum) {
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + nt - 1) / nt, lo = min(n, tid * per), hi = min(n, lo + per);
  int own = 0;
  for (int k = lo; k < hi; ++k) own += v[k];
  int incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < (nt >> 5) ? wsum[lane] : 0;
    int x = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    wsum[lane] = x - w;
    if (lane == 31) wsum[32] = x;
  }
  __syncthreads();
  int run = wsum[warp] + incl - own;
  for (int k = lo; k < hi; ++k) {
    const int t = v[k];
    v[k] = run;
    run += t;
  }
  const int total = wsum[32];
  __syncthreads();
  return total;
}

// Calls visit(k, col0, v) for every uint4 v of the own rows' bits that is
// not 0: row k of the slice, columns col0 .. col0 + 127. Four loads in
// flight a thread.
template <class Visit>
__device__ __forceinline__ void for_each_bit_block(const ClusterArgs& a, size_t gN, int r0,
                                                   int own, Visit visit) {
  const int q4 = a.pitch >> 2;  // 128 columns a uint4
  const uint4* src = reinterpret_cast<const uint4*>(a.bits + (gN + r0) * a.pitch);
  const int total = own * q4, nt = blockDim.x;
  for (int c0 = threadIdx.x; c0 < total; c0 += 4 * nt) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * nt;
      v[u] = c < total ? __ldg(src + c) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if ((v[u].x | v[u].y | v[u].z | v[u].w) == 0u) continue;
      const int c = c0 + u * nt, k = c / q4;
      visit(k, (c - k * q4) * 128, v[u]);
    }
  }
}

// Calls f(k, v) for both ends of every band edge (i, j = i + 1 + m < N) that
// touches the own rows [r0, r0 + own): k = i - r0 with v = j where i is
// owned, k = j - r0 with v = i where j is. Reads the own rows' bits and the
// W rows before them (from L2: the band's bits are 1/8 of its bytes), four
// words in flight a thread.
template <class F>
__device__ __forceinline__ void for_each_band_edge(const ClusterArgs& a, size_t gN, int r0,
                                                   int own, F f) {
  if (own == 0) return;
  const int N = a.N, wb = (a.W + 31) >> 5, r1 = r0 + own, lo = max(0, r0 - a.W);
  const uint32_t* bits = a.bits + (gN + lo) * a.pitch;
  const int items = (r1 - lo) * wb, nt = blockDim.x;
  for (int it0 = threadIdx.x; it0 < items; it0 += 4 * nt) {
    uint32_t xs[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int it = it0 + u * nt, di = it / wb;
      xs[u] = it < items ? __ldg(bits + di * a.pitch + (it - di * wb)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int it = it0 + u * nt, di = it / wb, i = lo + di, m0 = 32 * (it - di * wb);
      uint32_t x = xs[u] & range_mask(0, N - 1 - i - m0);
      if (x == 0u) continue;
      uint32_t y = x & range_mask(r0 - i - 1 - m0, r1 - i - 1 - m0);  // j owned
      if (i < r0) x = 0u;
      while (x) {
        const int t = __ffs(x) - 1;
        x &= x - 1;
        f(i - r0, i + 1 + m0 + t);
      }
      while (y) {
        const int t = __ffs(y) - 1;
        y &= y - 1;
        f(i + 1 + m0 + t - r0, i);
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kClusterThreads, 1) label_cluster_kernel(ClusterArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.x / cs;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = a.N, rows = a.rows, np = cs * rows;
  const int r0 = rank * rows, own = max(0, min(N, r0 + rows) - r0);
  const size_t gN = static_cast<size_t>(g) * N;

  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* S = reinterpret_cast<uint16_t*>(smem);  // then P by round parity, then X
  uint16_t* X = S + 3 * np;
  int* acc = reinterpret_cast<int*>(S + 4 * np);  // the step's result per own row
  int* pushed = acc + rows;                       // sparse: pushes received
  int* ends = acc + rows;                         // dense, band: where each own row's list ends
  int* scan = ends + rows;                        // kScanWords
  uint16_t* list = reinterpret_cast<uint16_t*>(scan + kScanWords);  // a.list_cap
  // atomicMin(v) into node t's word of `pushed`, in the block that owns t
  const auto push = [&](int t, int v) {
    const int o = t / rows;
    if (o == rank)
      atomicMin(pushed + (t - r0), v);
    else
      atomicMin(cluster.map_shared_rank(pushed, o) + (t - o * rows), v);
  };
  const auto fill = [&](int k, int v) { list[atomicAdd(&ends[k], 1)] = static_cast<uint16_t>(v); };

  for (int i = tid; i < np; i += nt) S[i] = (i < N && a.valid[gN + i]) ? i : N;
  if (MODE == kSparse)
    for (int k = tid; k < rows; k += nt) pushed[k] = N;
  // dense, band: the own rows' neighbours, listed as uint16 columns when
  // they fit (counted, then filled by a second pass over the edges); a block
  // decides alone
  bool listed = false;
  if (MODE != kSparse) {
    if (MODE == kDense) {  // counted by label_pack_kernel
      for (int k = tid; k < rows; k += nt) ends[k] = k < own ? a.deg[gN + r0 + k] : 0;
    } else {
      for (int k = tid; k < rows; k += nt) ends[k] = 0;
      __syncthreads();
      for_each_band_edge(a, gN, r0, own, [&](int k, int) { atomicAdd(&ends[k], 1); });
    }
    __syncthreads();
    listed = block_exclusive_scan(ends, rows, scan) <= a.list_cap;
    if (listed && MODE == kDense) {
      for_each_bit_block(a, gN, r0, own, [&](int k, int col0, uint4 v) {
        const uint32_t ws[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t x = ws[q];
          while (x) {
            const int t = __ffs(x) - 1;
            x &= x - 1;
            fill(k, col0 + 32 * q + t);
          }
        }
      });
    } else if (listed) {
      for_each_band_edge(a, gN, r0, own, fill);
    }
    if (tid == 0 && a.listed != nullptr) a.listed[static_cast<size_t>(g) * cs + rank] = listed;
  }
  // every block of the cluster has started and set up before any peer
  // writes into its shared memory
  cluster.sync();

  int r = 0;
  while (true) {
    uint16_t* P = (r & 1) ? S + 2 * np : S + np;
    // the neighbour step for the own rows: S -> P[r0, r0 + rows)
    for (int k = tid; k < rows; k += nt) acc[k] = S[r0 + k];
    __syncthreads();
    if (MODE == kSparse) {
      // a valid node pulls from its listed neighbours, then pushes the result
      for (int k = tid; k < own; k += nt) {
        const int i = r0 + k;
        const int* nb = a.nbr + (gN + i) * a.W;
        const uint8_t* ok = a.edges + (gN + i) * a.W;
        int v = acc[k];
        if (v >= N) continue;  // an invalid node keeps N
        for (int d = 0; d < a.W; ++d) {
          if (!ok[d]) continue;
          int t = nb[d];
          t = t < 0 ? t + N : t;  // JAX's index normalisation, then its clamp
          v = min(v, static_cast<int>(S[min(max(t, 0), N - 1)]));
        }
        acc[k] = v;
        for (int d = 0; d < a.W; ++d) {
          const int t = nb[d];
          if (ok[d] && t >= 0 && t < N && S[t] < N) push(t, v);
        }
      }
    } else if (listed) {
      for (int k = tid; k < own; k += nt) {
        int m = acc[k];
        if (m < N)  // an invalid node keeps N
          for (int e = k ? ends[k - 1] : 0; e < ends[k]; ++e)
            m = min(m, static_cast<int>(S[list[e]]));
        acc[k] = m;
      }
    } else if (MODE == kBand) {  // the lists did not fit: both ends of the band edges every round
      for_each_band_edge(a, gN, r0, own, [&](int k, int v) {
        if (S[r0 + k] < N) atomicMin(&acc[k], static_cast<int>(S[v]));  // an invalid node keeps N
      });
    } else {  // dense, the lists did not fit: the own rows' bits every round
      for_each_bit_block(a, gN, r0, own, [&](int k, int col0, uint4 v) {
        const uint32_t ws[4] = {v.x, v.y, v.z, v.w};
        int m = N;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t x = ws[q];
          while (x) {
            const int t = __ffs(x) - 1;
            x &= x - 1;
            m = min(m, static_cast<int>(S[col0 + 32 * q + t]));
          }
        }
        atomicMin(&acc[k], m);
      });
    }
    if (MODE == kSparse) {
      cluster.sync();  // every push has landed
      for (int k = tid; k < rows; k += nt) {
        P[r0 + k] = min(acc[k], pushed[k]);
        pushed[k] = N;  // no peer pushes again before the next round's step
      }
    } else {
      __syncthreads();
      for (int k = tid; k < rows; k += nt) P[r0 + k] = acc[k];
    }
    __syncthreads();
    // the own slice into every peer's P, 16 bytes a store
    {
      const int n16 = rows / 8;
      const uint4* src = reinterpret_cast<const uint4*>(P + r0);
      for (int it = tid; it < (cs - 1) * n16; it += nt) {
        const int pe = it / n16, c = it - pe * n16;
        const int peer = pe + (pe >= rank);
        reinterpret_cast<uint4*>(cluster.map_shared_rank(P + r0, peer))[c] = src[c];
      }
    }
    cluster.sync();  // P is whole in every block; no peer touches this block's
                     // shared memory again before the next round's step
    jump_all<false>(P, X, np, N);
    __syncthreads();
    jump_all<false>(X, P, np, N);
    __syncthreads();
    const int changed = __syncthreads_or(jump_all<true>(P, S, np, N));
    ++r;
    if (r > a.rounds || (r >= 2 && !changed)) break;
  }
  // The last remote write into any block came before the last cluster.sync,
  // so a block may exit now.
  for (int k = tid; k < own; k += nt) a.labels[gN + r0 + k] = S[r0 + k];
  if (rank == 0 && tid == 0) a.rounds_run[g] = r;
}

// -------------------------------------------------------------- global route

struct Args {
  const uint8_t* edges;  // adj (B, N, N), band (B, N, W) or nbr_ok (B, N, W)
  const int* nbr;        // nbr_idx (B, N, W), sparse only
  const uint8_t* valid;  // (B, N)
  int* S;                // (B, N) labels, the output
  int* P;                // (B, N) scratch
  int* X;
  int* Y;
  int* flags;            // (rounds + 1, B + 1): per round, any graph changed, then each
  int* rounds_run;       // (B,)
  int B, N, W, rounds;
};

__device__ __forceinline__ int ldcg(const int* p) { return __ldcg(p); }

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Minimum of lab[j] over the set bytes of row (N bytes), reduced over the warp.
__device__ int dense_row_min(const uint8_t* row, const int* lab, int N, int lane) {
  int m = N;
  if ((N & 15) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int c = lane; c < N / 16; c += 32) {
      const uint4 v = __ldg(r4 + c);
      if ((v.x | v.y | v.z | v.w) == 0) continue;
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t x = w[q];
        while (x) {
          const int byte = (__ffs(x) - 1) >> 3;
          m = min(m, ldcg(lab + c * 16 + q * 4 + byte));
          x &= ~(0xffu << (byte * 8));
        }
      }
    }
  } else {
    for (int j = lane; j < N; j += 32)
      if (row[j]) m = min(m, ldcg(lab + j));
  }
  return warp_min(m);
}

// One pointer jump over every node: dst = min(src, src[src]).
__device__ __forceinline__ int jump(const int* src, int i, int N) {
  const int l = ldcg(src + i);
  if (l >= N) return N;
  return min(l, ldcg(src + (i - i % N) + l));
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) label_rounds_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int N = a.N, total = a.B * a.N;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31, warp = tid >> 5, nwarps = nthreads >> 5;

  for (int i = tid; i < total; i += nthreads) {
    const int l = a.valid[i] ? i % N : N;
    __stcg(a.S + i, l);
    if (MODE == kBand) __stcg(a.P + i, l);
  }
  for (int i = tid; i < (a.rounds + 1) * (a.B + 1); i += nthreads) __stcg(a.flags + i, 0);
  grid.sync();

  int r = 0;
  while (true) {
    // the neighbour step: S -> P
    if (MODE == kDense) {
      for (int row = warp; row < total; row += nwarps) {
        const int m = dense_row_min(a.edges + static_cast<size_t>(row) * N, a.S + (row - row % N),
                                    N, lane);
        if (lane == 0) {
          const int s = ldcg(a.S + row);
          __stcg(a.P + row, a.valid[row] ? min(s, m) : s);
        }
      }
    } else if (MODE == kBand) {
      for (int row = warp; row < total; row += nwarps) {
        const int base = row - row % N, i = row - base;
        const uint8_t* e = a.edges + static_cast<size_t>(row) * a.W;
        const int si = ldcg(a.S + row);
        int m = N;
        for (int k = lane; k < a.W; k += 32) {
          const int j = i + 1 + k;
          if (e[k] && j < N) {
            m = min(m, ldcg(a.S + base + j));
            if (a.valid[base + j]) atomicMin(a.P + base + j, si);
          }
        }
        m = warp_min(m);
        if (lane == 0 && a.valid[row]) atomicMin(a.P + row, m);
      }
    } else {
      for (int row = tid; row < total; row += nthreads) {
        const int base = row - row % N;
        const int* nb = a.nbr + static_cast<size_t>(row) * a.W;
        const uint8_t* ok = a.edges + static_cast<size_t>(row) * a.W;
        int m = N;
        for (int d = 0; d < a.W; ++d) {
          if (!ok[d]) continue;
          int t = nb[d];
          t = t < 0 ? t + N : t;
          m = min(m, ldcg(a.S + base + min(max(t, 0), N - 1)));
        }
        const int s = ldcg(a.S + row);
        const int v = a.valid[row] ? min(s, m) : s;
        __stcg(a.X + row, v);
        __stcg(a.P + row, v);
      }
      grid.sync();
      for (int row = tid; row < total; row += nthreads) {
        const int base = row - row % N;
        const int* nb = a.nbr + static_cast<size_t>(row) * a.W;
        const uint8_t* ok = a.edges + static_cast<size_t>(row) * a.W;
        const int v = ldcg(a.X + row);
        for (int d = 0; d < a.W; ++d) {
          const int t = nb[d];
          if (ok[d] && t >= 0 && t < N && a.valid[base + t]) atomicMin(a.P + base + t, v);
        }
      }
    }
    grid.sync();
    // three pointer jumps: P -> X -> Y -> S
    for (int i = tid; i < total; i += nthreads) __stcg(a.X + i, jump(a.P, i, N));
    grid.sync();
    for (int i = tid; i < total; i += nthreads) __stcg(a.Y + i, jump(a.X, i, N));
    grid.sync();
    int* f = a.flags + r * (a.B + 1);
    for (int i = tid; i < total; i += nthreads) {
      const int nl = jump(a.Y, i, N);
      if (nl != ldcg(a.S + i)) {
        if (!ldcg(f)) atomicOr(f, 1);
        if (!ldcg(f + 1 + i / N)) atomicOr(f + 1 + i / N, 1);
      }
      __stcg(a.S + i, nl);
      if (MODE == kBand) __stcg(a.P + i, nl);
    }
    grid.sync();
    ++r;
    if (r > a.rounds || (r >= 2 && ldcg(a.flags + (r - 1) * (a.B + 1)) == 0)) break;
  }
  // a graph's rounds: through the first round after the first that changed
  // none of its labels
  for (int g = tid; g < a.B; g += nthreads) {
    int run = r;
    for (int k = 1; k < r; ++k)
      if (ldcg(a.flags + k * (a.B + 1) + 1 + g) == 0) {
        run = k + 1;
        break;
      }
    a.rounds_run[g] = run;
  }
}

// ------------------------------------------------------------------ planning

using ClusterFn = void (*)(ClusterArgs);
using GlobalFn = void (*)(Args);

ClusterFn cluster_kernel_for(int mode) {
  switch (mode) {
    case kDense: return label_cluster_kernel<kDense>;
    case kBand: return label_cluster_kernel<kBand>;
    default: return label_cluster_kernel<kSparse>;
  }
}

GlobalFn global_kernel_for(int mode) {
  switch (mode) {
    case kDense: return label_rounds_kernel<kDense>;
    case kBand: return label_rounds_kernel<kBand>;
    default: return label_rounds_kernel<kSparse>;
  }
}

struct Plan {
  int cluster;   // 1: cluster route, 0: global route
  int cs;        // blocks per cluster (cluster route)
  int rows;      // nodes a block owns (cluster route)
  int resident;  // clusters the card holds at once (cluster route)
  size_t smem;   // dynamic shared memory per block
  int list_cap;  // dense, band: neighbour-list entries a block holds
  long long scratch;  // int32 words of scratch
};

cudaLaunchConfig_t cluster_config(int clusters, int cs, size_t smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cs);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Raises the cluster kernels' shared-memory limit to the device's and allows
// clusters of 16, once per device.
cudaError_t prepare(int dev, int optin) {
  static bool done[kMaxDevices] = {};
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  for (int mode = 0; mode < 3; ++mode) {
    const void* fn = reinterpret_cast<const void*>(cluster_kernel_for(mode));
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

// Clusters of kClusterSizes[c] blocks with `smem` bytes each that the card
// holds at once; the last answer per device, mode and size is kept.
cudaError_t resident_clusters(int dev, int mode, int c, size_t smem, int* n) {
  struct Entry {
    size_t smem;
    int n;
  };
  static Entry kept[kMaxDevices][3][kNumSizes] = {};
  Entry* e = dev < kMaxDevices ? &kept[dev][mode][c] : nullptr;
  if (e != nullptr && e->smem == smem && e->n > 0) {
    *n = e->n;
    return cudaSuccess;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, kClusterSizes[c], smem, 0, &attr);
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      n, reinterpret_cast<const void*>(cluster_kernel_for(mode)), &cfg);
  if (err == cudaSuccess && e != nullptr) *e = Entry{smem, *n};
  return err;
}

// The route for (mode, B, N, W), by size alone. The cluster route when the
// labels fit in uint16 and some cluster size's shared memory fits a block:
// the largest cluster (16, 8 or 4 blocks) of which the card holds one for
// every graph of the batch at once, or, where none does, the smallest that
// fits (the most graphs at once). Otherwise the global route.
cudaError_t plan(int mode, int B, int N, int W, int rounds, Plan* p) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = prepare(dev, optin);
  if (err != cudaSuccess) return err;
  // the dense and band layouts' lists take the rest of the block's shared memory
  const bool lists = mode != kSparse;
  int resident[kNumSizes] = {}, rows[kNumSizes] = {};
  size_t fixed[kNumSizes] = {};
  if (N <= kMaxLabel) {
    for (int c = 0; c < kNumSizes; ++c) {
      fixed[c] = cluster_smem(mode, N, kClusterSizes[c], &rows[c]);
      if (fixed[c] > static_cast<size_t>(optin)) continue;
      err = resident_clusters(dev, mode, c, lists ? optin : fixed[c], &resident[c]);
      if (err != cudaSuccess) return err;
    }
  }
  int c = -1;
  for (int k = kNumSizes - 1; k >= 0 && c < 0; --k)
    if (resident[k] >= B) c = k;
  for (int k = 0; k < kNumSizes && c < 0; ++k)
    if (resident[k] > 0) c = k;
  if (c >= 0) {
    const int pitch = 4 * ((N + 127) / 128);
    p->cluster = 1;
    p->cs = kClusterSizes[c];
    p->rows = rows[c];
    p->resident = resident[c];
    p->smem = lists ? static_cast<size_t>(optin) : fixed[c];
    p->list_cap = lists ? static_cast<int>((optin - fixed[c]) / 2) : 0;
    // dense: the bits, then the rows' degrees; band: the bits
    p->scratch = mode == kDense  ? static_cast<long long>(B) * N * (pitch + 1)
               : mode == kBand ? static_cast<long long>(B) * N * ((W + 31) / 32)
                               : 0;
    return cudaSuccess;
  }
  p->cluster = 0;
  p->cs = p->rows = p->resident = p->list_cap = 0;
  p->smem = 0;
  p->scratch = 3LL * B * N + static_cast<long long>(rounds + 1) * (B + 1);
  return cudaSuccess;
}

bool bad_args(int mode, int B, int N, int W, int rounds) {
  return mode < kDense || mode > kSparse || B <= 0 || N <= 0 || W <= 0 || rounds < 0 ||
         (mode == kDense && W != N);
}

}  // namespace

// The plan for (mode, B, N, W, rounds), into out[0..6]: route (1 cluster, 0
// global), blocks per cluster, nodes per block, resident clusters, shared
// bytes per block, int32 words of scratch, neighbour-list entries a block
// holds (dense, band: the rest of its shared memory). Returns a cudaError_t.
extern "C" int gims_label_plan(int mode, int B, int N, int W, int rounds, long long* out) {
  if (bad_args(mode, B, N, W, rounds)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan(mode, B, N, W, rounds, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.cluster;
  out[1] = p.cs;
  out[2] = p.rows;
  out[3] = p.resident;
  out[4] = static_cast<long long>(p.smem);
  out[5] = p.scratch;
  out[6] = p.list_cap;
  return 0;
}

// mode 0 dense, 1 band, 2 sparse (see above). edges: (B, N, W) bool bytes
// (W = N for dense); nbr: (B, N, W) int32 or null; valid: (B, N) bool bytes;
// labels: (B, N) int32 and rounds_run: (B,) int32, written; listed: null, or
// (B, blocks per cluster) int32 that the dense and band layouts' cluster
// route fill with 1 where a block listed its rows' neighbours (0 where it
// read their bits every round); scratch:
// gims_label_plan's count of int32 words, 16-byte aligned. All contiguous on
// the device. Returns a cudaError_t (0 = launched).
extern "C" int gims_label_rounds(int mode, const void* edges, const void* nbr, const void* valid,
                                 void* labels, void* rounds_run, void* listed, void* scratch,
                                 long long scratch_len, int B, int N, int W, int rounds,
                                 void* stream) {
  if (bad_args(mode, B, N, W, rounds) || (mode == kSparse && nbr == nullptr) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  cudaError_t err = plan(mode, B, N, W, rounds, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (scratch_len < p.scratch) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(edges) % 16 == 0;

  if (p.cluster) {
    // dense: (B, N, pitch) bits of 16-byte rows, then the degrees; band: (B,
    // N, pitch) bits
    const int pitch = mode == kDense ? 4 * ((N + 127) / 128) : (W + 31) / 32;
    int* deg = mode == kDense ? static_cast<int*>(scratch) + static_cast<long long>(B) * N * pitch
                              : nullptr;
    ClusterArgs a;
    a.edges = static_cast<const uint8_t*>(edges);
    a.nbr = static_cast<const int*>(nbr);
    a.bits = static_cast<const uint32_t*>(scratch);
    a.deg = deg;
    a.valid = static_cast<const uint8_t*>(valid);
    a.labels = static_cast<int*>(labels);
    a.rounds_run = static_cast<int*>(rounds_run);
    a.listed = static_cast<int*>(listed);
    a.N = N;
    a.W = W;
    a.pitch = pitch;
    a.rounds = rounds;
    a.rows = p.rows;
    a.list_cap = p.list_cap;
    if (mode != kSparse) {
      int dev = 0, sms = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      // a warp per row, eight blocks an SM
      const long long rows = static_cast<long long>(B) * N, per_block = kPackThreads / 32;
      const int grid = static_cast<int>(std::max(1LL, std::min<long long>(
          (rows + per_block - 1) / per_block, 8LL * sms)));
      label_pack_kernel<<<grid, kPackThreads, 0, st>>>(
          static_cast<const uint8_t*>(edges), a.valid, static_cast<uint32_t*>(scratch), deg, rows,
          N, W, pitch, aligned && W % 32 == 0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(B, p.cs, p.smem, st, &attr);
    err = cudaLaunchKernelEx(&cfg, cluster_kernel_for(mode), a);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }

  const GlobalFn fn = global_kernel_for(mode);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reinterpret_cast<const void*>(fn),
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long total = static_cast<long long>(B) * N;
  // no more blocks than the rows need (a warp per row), at most all resident
  const long long want = (total + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = static_cast<int>(std::max(1LL, std::min<long long>(
      want, static_cast<long long>(std::min(per_sm, kMaxBlocksPerSm)) * sms)));
  int* s = static_cast<int*>(scratch);
  Args a;
  a.edges = static_cast<const uint8_t*>(edges);
  a.nbr = static_cast<const int*>(nbr);
  a.valid = static_cast<const uint8_t*>(valid);
  a.S = static_cast<int*>(labels);
  a.P = s;
  a.X = s + total;
  a.Y = s + 2 * total;
  a.flags = s + 3 * total;
  a.rounds_run = static_cast<int*>(rounds_run);
  a.B = B;
  a.N = N;
  a.W = W;
  a.rounds = rounds;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3(grid), dim3(kThreads),
                                    args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
