// Log-domain Sinkhorn potentials for the dustbin-padded coupling matrix.
//
// Replaces the TPU kernel gims_tpu/matcher/pallas_sinkhorn.py::_sinkhorn_kernel
// (reached through sinkhorn_uv_pallas / log_optimal_transport_pallas): for
// each batch item, `iters` times,
//     u = log_mu - lse_j(Z + v)      (row pass)
//     v = log_nu - lse_i(Z + u)      (column pass)
// with the masked-logsumexp semantics of gims_tpu/matcher/sinkhorn.py
// (running max floored at -1e9, sum floored at 1e-38, result floored at
// -1e9). The caller forms Z + u + v - norm.
//
// What bounds it on the H100: every pass reads all of Z, so the passes move
// 2*iters*4*(M+1)*(N+1) bytes. At the 8192 bucket Z is 268 MB, larger than
// the 50 MB L2, so each pass streams Z from device memory; at 2048 (17 MB)
// it can stay in L2.
//
// The simple design: two launches per iteration, a row pass and a column
// pass. The launch boundary is the grid-wide barrier between them that the
// TPU's sequential grid gave for free. Row pass: one warp per row, each lane
// keeps an online (max, sum) over its columns, then the warp merges them.
// Column pass: a block of 32x32 threads owns 32 neighbouring columns; each
// of its 32 row groups walks every 32nd row, so a warp reads 32 neighbouring
// floats of one row (coalesced); the 32 partial (max, sum) pairs of a column
// merge in shared memory. u and v live in small device buffers. One
// exponential per element: the running sum is rescaled only when the max
// grows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kRowThreads = 256;  // 8 rows (warps) per row-pass block

__device__ __forceinline__ void lse_push(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  if (m2 > m) {
    s = s * expf(m - m2) + s2;
    m = m2;
  } else {
    s += s2 * expf(m2 - m);
  }
}

__device__ __forceinline__ float lse_final(float m, float s) {
  return fmaxf(m + logf(fmaxf(s, 1e-38f)), kNegInf);
}

// u[r] = log_mu[r] - lse_j(Z[r, j] + v[b, j]) for the B*M1 rows r.
__global__ void __launch_bounds__(kRowThreads) sinkhorn_row_kernel(
    const float* __restrict__ Z, const float* __restrict__ log_mu,
    const float* __restrict__ v, float* __restrict__ u, int rows, int M1,
    int N1) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // whole warps leave together
  const float* zr = Z + (long long)r * N1;
  const float* vb = v + (long long)(r / M1) * N1;
  float m = kNegInf, s = 0.f;
#pragma unroll 4
  for (int j = lane; j < N1; j += 32) lse_push(m, s, zr[j] + vb[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
  if (lane == 0) u[r] = log_mu[r] - lse_final(m, s);
}

// v[b, j] = log_nu[b, j] - lse_i(Z[b, i, j] + u[b, i]); block (32, 32) owns
// 32 columns of batch item blockIdx.y.
__global__ void __launch_bounds__(1024) sinkhorn_col_kernel(
    const float* __restrict__ Z, const float* __restrict__ log_nu,
    const float* __restrict__ u, float* __restrict__ v, int M1, int N1) {
  __shared__ float sm[32][33];
  __shared__ float ss[32][33];
  const int b = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  float m = kNegInf, s = 0.f;
  if (j < N1) {
    const float* zb = Z + (long long)b * M1 * N1 + j;
    const float* ub = u + (long long)b * M1;
#pragma unroll 4
    for (int i = ty; i < M1; i += 32) lse_push(m, s, zb[(long long)i * N1] + ub[i]);
  }
  sm[ty][tx] = m;
  ss[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < N1) {
    float mm = sm[0][tx], sum = ss[0][tx];
    for (int g = 1; g < 32; ++g) lse_merge(mm, sum, sm[g][tx], ss[g][tx]);
    v[(long long)b * N1 + j] = log_nu[(long long)b * N1 + j] - lse_final(mm, sum);
  }
}

}  // namespace

// Z (B, M1, N1), log_mu / u (B, M1), log_nu / v (B, N1): contiguous f32 on
// the device. Writes u and v. Returns a cudaError_t (0 = all launched).
extern "C" int gims_sinkhorn_uv(const void* Z, const void* log_mu,
                                const void* log_nu, void* u, void* v, int B,
                                int M1, int N1, int iters, void* stream) {
  if (B <= 0 || M1 <= 0 || N1 <= 0 || iters < 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(u, 0, sizeof(float) * B * M1, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(v, 0, sizeof(float) * B * N1, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows = B * M1;
  const long long row_threads = (long long)rows * 32;
  const int row_blocks = (int)((row_threads + kRowThreads - 1) / kRowThreads);
  const dim3 col_grid((N1 + 31) / 32, B);
  const dim3 col_block(32, 32);
  const float* z = static_cast<const float*>(Z);
  const float* mu = static_cast<const float*>(log_mu);
  const float* nu = static_cast<const float*>(log_nu);
  float* uu = static_cast<float*>(u);
  float* vv = static_cast<float*>(v);
  for (int it = 0; it < iters; ++it) {
    sinkhorn_row_kernel<<<row_blocks, kRowThreads, 0, st>>>(z, mu, vv, uu, rows,
                                                          M1, N1);
    sinkhorn_col_kernel<<<col_grid, col_block, 0, st>>>(z, nu, uu, vv, M1, N1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
