// Connected-component labels of AGC's graphs: min-label propagation with
// pointer jumping, every round in one cooperative launch, stopping after the
// first round that changes no label.
//
// Replaces the jax.lax.while_loop over one_round of connected_components,
// connected_components_sparse and connected_components_band in
// gims_tpu/agc/graph.py (:130, :205, :464). That loop is no Pallas kernel:
// XLA keeps its trip count on the TPU. Eager PyTorch has no such loop. A host
// loop would wait for the card once per round, and a fixed round count runs
// 21 rounds of ~10 small launches each where AGC graphs settle in 2-6. Here
// each round ends in a grid-wide barrier after which every block reads the
// round's "changed" flag, so the rounds stop on the card.
//
// One round, in three layouts (template MODE; S = the labels, P, X, Y =
// (B, N) scratch):
//   dense  adj (B, N, N) bool: a warp per row scans it 16 bytes a lane and
//          takes the minimum label of the set bytes: P = min(S, row min);
//   band   forward band (B, N, W) bool, band[i, m] = edge(i, i+1+m): a warp
//          per row takes the minimum over its forward neighbours and pushes
//          S[i] into each of them by atomicMin; P holds S on entry;
//   sparse nbr_ok / nbr_idx (B, N, W): a thread per node pulls the minimum
//          of its listed neighbours into X (and P); a barrier; then pushes
//          X[i] into each listed neighbour's P by atomicMin;
// a barrier, then three pointer jumps P -> X -> Y -> S, each label =
// min(label, label[label]), a barrier after each. The last one also raises
// the round's flag where a label changed. Integer minima are exact in any
// order, so the labels equal the JAX package's bit for bit, the capped
// rounds included.
//
// What bounds it: a dense round reads the (B, N, N) adjacency once, B N^2
// bytes (604 MB at 16 x 6144, 0.18 ms at 3.35 TB/s); band and sparse rounds
// read B N W bytes. Each round also pays four or five grid barriers of a
// few microseconds. Labels written inside the launch are read with
// ld.global.cg, past the non-coherent L1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocksPerSm = 4;
enum Mode { kDense = 0, kBand = 1, kSparse = 2 };

struct Args {
  const uint8_t* edges;  // adj (B, N, N), band (B, N, W) or nbr_ok (B, N, W)
  const int* nbr;        // nbr_idx (B, N, W), sparse only
  const uint8_t* valid;  // (B, N)
  int* S;                // (B, N) labels, the output
  int* P;                // (B, N) scratch
  int* X;
  int* Y;
  int* flags;            // (rounds + 1,) changed flag per round
  int* rounds_run;
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
  if (tid == 0) __stcg(a.flags, 0);
  grid.sync();

  int r = 0;
  while (r <= a.rounds) {
    if (tid == 0 && r < a.rounds) __stcg(a.flags + r + 1, 0);
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
        for (int d = 0; d < a.W; ++d)
          if (ok[d]) m = min(m, ldcg(a.S + base + min(nb[d], N - 1)));
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
    int changed = 0;
    for (int i = tid; i < total; i += nthreads) {
      const int nl = jump(a.Y, i, N);
      changed |= nl != ldcg(a.S + i);
      __stcg(a.S + i, nl);
      if (MODE == kBand) __stcg(a.P + i, nl);
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0) atomicOr(a.flags + r, 1);
    grid.sync();
    ++r;
    if (ldcg(a.flags + r - 1) == 0) break;
  }
  if (tid == 0) *a.rounds_run = r;
}

using KernelFn = void (*)(Args);

KernelFn kernel_for(int mode) {
  switch (mode) {
    case kDense: return label_rounds_kernel<kDense>;
    case kBand: return label_rounds_kernel<kBand>;
    case kSparse: return label_rounds_kernel<kSparse>;
    default: return nullptr;
  }
}

}  // namespace

// mode 0 dense, 1 band, 2 sparse (see above). edges: (B, N, W) bool bytes
// (W = N for dense); nbr: (B, N, W) int32 or null; valid: (B, N) bool bytes;
// labels: (B, N) int32, written; scratch: 3 B N + rounds + 2 int32, its last
// element receives the rounds run. All contiguous on the device. Returns a
// cudaError_t (0 = launched).
extern "C" int gims_label_rounds(int mode, const void* edges, const void* nbr, const void* valid,
                                 void* labels, void* scratch, int B, int N, int W, int rounds,
                                 void* stream) {
  const KernelFn fn = kernel_for(mode);
  if (fn == nullptr || B <= 0 || N <= 0 || W <= 0 || rounds < 0 ||
      (mode == kSparse && nbr == nullptr) || (mode == kDense && W != N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
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
  a.rounds_run = s + 3 * total + rounds + 1;
  a.B = B;
  a.N = N;
  a.W = W;
  a.rounds = rounds;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3(grid), dim3(kThreads),
                                    args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
