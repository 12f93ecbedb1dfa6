// Segmented sum in source order: out[s] = 0 + v[i1] + v[i2] + ... over the
// values whose destination is s, i1 < i2 < ..., in plain f32 adds.
//
// Replaces no TPU kernel. The JAX package sums into slots with XLA's
// segment sums, which give one answer every run; on the card PyTorch's
// index_add_ / scatter_add_ on floats add with atomics, in an order that
// changes from run to run, so two runs of the port could differ in the last
// bit and, through a threshold, in a match. This kernel gives the sequential
// sum that index_add_ computes on the CPU (the plain version), bit for bit,
// on every run. Callers: the SIFT descriptor histograms
// (frontend/sift.py), AGC's centroid sums (agc/graph.py::_segment_sum) and
// the training loss's per-pair sums (matcher/pipeline.py).
//
// Design. The wrapper sorts the destinations (as int32) with a stable
// torch.sort (a radix sort, deterministic), so equal destinations lie
// together in source order, and finds each slot's run in the sorted keys
// with torch.searchsorted (offsets, num + 1 of them); neither waits for the
// host. One thread per slot adds its run's values, read through the
// permutation, in order; it knows its run's bounds before it starts, so the
// loop issues UNROLL independent loads ahead of its dependent adds. Empty
// slots get 0. A run is a few votes for SIFT's slots, a component's members
// for AGC's, a pair's rows for the loss's: the longest run bounds the time.
//
// Bound: bytes. Each key (4 B), permutation entry (8 B) and value (4 B) is
// read once and each slot (4 B) written once; the adds are one per value,
// far below any compute peak. The reads through the permutation are
// gathers, and the sort reads and writes its keys several times, so the
// call runs well above that bound.
//
// A destination outside [0, num) traps, as index_add_'s device assert does.

#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 8;

__global__ void segsum_kernel(const int* __restrict__ keys, const long long* __restrict__ perm,
                              const long long* __restrict__ offsets,
                              const float* __restrict__ values, float* __restrict__ out,
                              long long n, long long num) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < num;
       s += (long long)gridDim.x * blockDim.x) {
    if (s == 0 && n > 0 && (keys[0] < 0 || keys[n - 1] >= num)) __trap();
    long long j = offsets[s];
    const long long end = offsets[s + 1];
    float acc = 0.0f;
    for (; j + UNROLL <= end; j += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = values[perm[j + u]];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; j < end; ++j) acc = __fadd_rn(acc, values[perm[j]]);
    out[s] = acc;
  }
}

}  // namespace

extern "C" int gims_segsum(const void* keys, const void* perm, const void* offsets,
                           const void* values, void* out, long long n, long long num,
                           void* stream) {
  if (num <= 0) return 0;
  const int threads = 256;
  long long blocks = (num + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks an SM
  segsum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (const long long*)perm, (const long long*)offsets,
      (const float*)values, (float*)out, n, num);
  return (int)cudaGetLastError();
}
