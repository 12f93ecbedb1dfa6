// Masked multi-head attention, forward only, for the GMatcher trunk.
//
// Replaces the TPU kernel gims_tpu/matcher/pallas_attention.py::_attn_kernel
// (reached through masked_attention_pallas): softmax(Q K^T * scale + bias) V
// with a per-key bias of 0 (valid) or -1e9 (masked), online max and sum in
// f32, PV accumulated in f32, output divided by max(l, 1e-30). Padded query
// rows are computed like any other and masked by the caller.
//
// What bounds it on the H100: 4*B*H*N*M*D operations (QK^T and PV, a
// multiply and an add each) against 4*B*N*H*D + 2*(B*M*H*D) elements moved,
// so it is bound by operations, not bytes, at every bucket the trunk uses
// (N = M >= 2048, D = 64).
//
// The simple design: one block per (b*h, tile of 64 query rows), one thread
// per query row holding its q row and its f32 accumulator in registers. The
// block walks the keys in tiles of 64 staged in shared memory (converted to
// f32 on load, so f32 and bf16 inputs share the inner loop); every thread
// reads the same key row, which shared memory broadcasts. Scores are taken 16
// keys at a time, so the running max and the accumulator are rescaled once
// per 16 keys. Softmax is base 2: scale*log2(e) is folded into q. The kernel
// reads the (B, N, H, D) layout through the strides it is given, handles M
// that is not a multiple of the tile (keys past M get p = 0) and fully masked
// keys. No tensor cores: wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;    // head dim
constexpr int kBQ = 64;   // query rows per block (one thread each)
constexpr int kBK = 64;   // keys per shared-memory tile
constexpr int kCH = 16;   // keys per online-softmax update
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long b, n, h, d;
};

template <typename T>
__global__ void __launch_bounds__(kBQ) attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ key_mask, T* __restrict__ out, int N, int M,
    int H, Strides qs, Strides ks, Strides vs, Strides os, long long mask_sb,
    float scale_log2) {
  __shared__ __align__(16) float k_tile[kBK][kD];
  __shared__ __align__(16) float v_tile[kBK][kD];
  __shared__ float bias[kBK];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int row = blockIdx.x * kBQ + threadIdx.x;
  const bool row_ok = row < N;

  float qr[kD];
  float acc[kD];
  const T* qp = q + b * qs.b + (long long)(row_ok ? row : 0) * qs.n + h * qs.h;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = row_ok ? to_f32(qp[d * qs.d]) * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m_run = kNegInf;
  float l_run = 0.f;

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const uint8_t* mb = key_mask + b * mask_sb;

  for (int k0 = 0; k0 < M; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < kBK * kD; idx += kBQ) {
      const int j = idx / kD;
      const int d = idx % kD;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < M) {
        kv = to_f32(kb[key * ks.n + d * ks.d]);
        vv = to_f32(vb[key * vs.n + d * vs.d]);
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
    T* op = out + b * os.b + (long long)row * os.n + h * os.h;
#pragma unroll
    for (int d = 0; d < kD; ++d) store(op + d * os.d, acc[d] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* key_mask,
           void* out, int B, int N, int M, int H, Strides qs, Strides ks,
           Strides vs, Strides os, long long mask_sb, float scale_log2,
           cudaStream_t stream) {
  const dim3 grid((N + kBQ - 1) / kBQ, B * H);
  attn_fwd_kernel<T><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<T*>(out), N, M, H, qs, ks, vs, os, mask_sb, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int gims_attention_fwd(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, int dtype, int B, int N, int M, int H, int D, long long qsb,
    long long qsn, long long qsh, long long qsd, long long ksb, long long ksn,
    long long ksh, long long ksd, long long vsb, long long vsn, long long vsh,
    long long vsd, long long osb, long long osn, long long osh, long long osd,
    long long mask_sb, float scale_log2, void* stream) {
  if (D != kD || B <= 0 || N <= 0 || M <= 0 || H <= 0 || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{qsb, qsn, qsh, qsd}, ks{ksb, ksn, ksh, ksd},
      vs{vsb, vsn, vsh, vsd}, os{osb, osn, osh, osd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, key_mask, out, B, N, M, H, qs, ks, vs, os,
                         mask_sb, scale_log2, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, key_mask, out, B, N, M, H, qs, ks,
                                 vs, os, mask_sb, scale_log2, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
