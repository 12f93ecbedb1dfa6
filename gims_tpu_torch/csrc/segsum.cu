// Segmented sum by rows, in source order: out[r, s] = 0 + v[r, i1] + v[r, i2]
// + ... over the i with slots[r, i] == s, i1 < i2 < ..., in plain f32 adds.
//
// Replaces no TPU kernel. The JAX package sums into slots with XLA's
// segment sums, which give one answer every run; on the card PyTorch's
// index_add_ / scatter_add_ on floats add with atomics, in an order that
// changes from run to run, so two runs of the port could differ in the last
// bit and, through a threshold, in a match. This kernel gives the sequential
// sum that index_add_ computes on the CPU (the plain version), bit for bit,
// on every run. Callers, each with its rows: the SIFT descriptor histograms
// (frontend/sift.py: a row per keypoint, its samples x 8 votes into its 361
// slots, int16), AGC's centroid sums (agc/graph.py: a row per image and
// coordinate, its N values into C + 1 slots) and the training loss's
// per-pair sums (matcher/pipeline.py: four rows of the loss's entries into
// B slots, one slot list for all four, row stride 0). The flat
// core/segsum.py::segment_sum takes its whole index as one row.
//
// Design. Row r's values land only in row r's slots, so no global sort is
// needed. Each warp takes a task: a row, or a range of a row's slots where
// the rows alone would not fill the card or the row's running sums would
// not fit shared memory (a warp then reads the whole row and keeps the
// values of its range). It walks the row in source order in batches of
// steps of 32 values (lane i loading each step's i-th value: coalesced),
// the next batch's loads issued before this one is added, so they are in
// flight meanwhile; a batch goes to the warp's buffer in shared memory as
// (value, slot) pairs in source order. Two ways to add, chosen per call
// from the shape:
//   * by lane (rows x ceil(num / 32) up to 1056 warps: few slots, or few
//     rows, as the loss's and a few images' AGC sums): a warp owns 32
//     slots, a lane one, its running sum in a register; every lane reads
//     every pair of the batch from the buffer (broadcast reads) in order and
//     adds the values of its slot. A slot's adds are one dependent chain in
//     one lane. Batches of 1024 values: few warps walk whole rows, so fewer,
//     larger loads in flight shorten the walk.
//   * by group (SIFT's many rows of 361 slots, AGC's sums of 8 pairs of
//     images; batches of 256 values): a warp owns at most kMaxSpan slots,
//     their running sums and a mask word each in shared memory. In steps of
//     32 values, lane i taking the step's i-th, the lanes with one slot find
//     each other: each sets its bit in its slot's mask word (atomicOr) and
//     reads the word back. The lowest lane of a group adds to the slot's
//     running sum its own value, then its peers' in lane order, read from
//     the buffer four at a time, writes it back and clears the word.
// Steps go in order and lanes in order within a step, so every slot's sum
// is the sequential sum. In the group way values equal to +0 or -0 are left
// out: a running sum starts at +0 and can never become -0 (x + y is -0 only
// where both are -0), so adding a zero never changes it (SIFT's masked
// samples vote zeros). One launch; no sort, no permutation. The flat
// segment_sum (any index) is one row: past kMaxSpan slots its warps each
// read the whole index, which no caller needs to be fast.
//
// Bound: bytes. Each value (4 B) and slot (2 or 4 B) read once and each out
// (4 B) written once; one add per value, far below any compute peak. A slot
// with n values needs n dependent adds, so one slot holding most of a row
// (the loss's) is bounded by that chain instead; a warp walks its row's
// batches one after another, so a row of few values is bounded by that
// walk's latency (AGC's).
//
// A slot outside [0, num) traps, as index_add_'s device assert does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // warps per block
constexpr int kGroupSteps = 8;            // steps of 32 values per batch, by group
constexpr int kLaneSteps = 32;            // by lane: the warp's 1024-value walk is latency-bound
constexpr int kTargetWarps = 132 * 4;     // enough warps to fill the card
constexpr int kLaneWarps = 1056;          // most warps of the by-lane way
constexpr int kMinSpan = 64;              // fewest slots a warp owns when rows split
constexpr int kSmemBytes = 48 * 1024;     // buffers, running sums and masks
// most slots a warp owns by group: its buffer, sums and masks in its share
constexpr int kMaxSpan = kSmemBytes / (8 * kWarps) - 32 * kGroupSteps;

template <int kSteps, typename Slot>
__device__ __forceinline__ void load_batch(const float* __restrict__ vr,
                                           const Slot* __restrict__ sr, long long base,
                                           long long width, int lane, float (&v)[kSteps],
                                           int (&s)[kSteps]) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const long long i = base + 32 * j + lane;
    const bool in = i < width;
    v[j] = in ? vr[i] : 0.f;  // past the row: a zero in slot 0, which adds nothing
    s[j] = in ? (int)sr[i] : 0;
  }
}

// The batch into the warp's buffer of (value, slot) pairs, in source order.
template <int kSteps>
__device__ __forceinline__ void stage_batch(const float (&v)[kSteps], const int (&s)[kSteps],
                                            float2* buf, int num, int lane) {
  __syncwarp();  // the previous batch fully read
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    if (s[j] < 0 || s[j] >= num) __trap();
    buf[32 * j + lane] = make_float2(v[j], __int_as_float(s[j]));
  }
  __syncwarp();
}

// By lane: lane `lane` owns slot mine; acc its running sum.
template <int kSteps>
__device__ __forceinline__ void add_batch_by_lane(const float2* buf, int mine, float& acc) {
  const float4* pairs = reinterpret_cast<const float4*>(buf);
#pragma unroll 2
  for (int i = 0; i < 16 * kSteps; i += 8) {  // 16 values a pass: its adds cover the next reads
    float4 p[8];  // two (value, slot) pairs each, read by every lane
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = pairs[i + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (__float_as_int(p[j].y) == mine) acc = __fadd_rn(acc, p[j].x);
      if (__float_as_int(p[j].w) == mine) acc = __fadd_rn(acc, p[j].z);
    }
  }
}

// By group: the warp's slots [lo, hi), their running sums at sums[s - lo],
// their mask words (zero between steps) at masks[s - lo].
__device__ __forceinline__ void add_batch_by_group(const float2* buf, int lo, int hi,
                                                   float* sums, unsigned* masks, int lane) {
  const unsigned below = (1u << lane) - 1u;
#pragma unroll 2
  for (int u = 0; u < kGroupSteps; ++u) {
    const float2* step = buf + 32 * u;
    const float2 p = step[lane];
    const float x = p.x;
    const int t = __float_as_int(p.y);
    const bool keep = x != 0.f && t >= lo && t < hi;
    if (keep) atomicOr(masks + (t - lo), 1u << lane);
    __syncwarp();
    const unsigned peers = keep ? masks[t - lo] : 0u;
    __syncwarp();
    if (keep && (peers & below) == 0u) {  // the group's first lane
      float acc = __fadd_rn(sums[t - lo], x);
      unsigned rest = peers & (peers - 1u);
      while (rest) {  // the peers in lane order, four reads in flight
        const int i0 = __ffs(rest) - 1;
        rest &= rest - 1u;
        const int i1 = __ffs(rest) - 1;
        rest &= rest - 1u;
        const int i2 = __ffs(rest) - 1;
        rest &= rest - 1u;
        const int i3 = __ffs(rest) - 1;
        rest &= rest - 1u;
        const float x0 = step[i0].x;
        const float x1 = step[max(i1, 0)].x;
        const float x2 = step[max(i2, 0)].x;
        const float x3 = step[max(i3, 0)].x;
        acc = __fadd_rn(acc, x0);
        if (i1 >= 0) acc = __fadd_rn(acc, x1);
        if (i2 >= 0) acc = __fadd_rn(acc, x2);
        if (i3 >= 0) acc = __fadd_rn(acc, x3);
      }
      sums[t - lo] = acc;
      masks[t - lo] = 0u;
    }
    __syncwarp();  // the next step reads the sums and masks this one wrote
  }
}

// Warp task t = (row t / parts, slot range t % parts of `span` slots).
// Shared memory: per warp a buffer of 32 * kSteps pairs, then (by group)
// per warp span running sums and span mask words.
template <typename Slot, int kSteps>
__global__ void __launch_bounds__(32 * kWarps) segsum_rows_kernel(
    const float* __restrict__ values, const Slot* __restrict__ slots, float* __restrict__ out,
    int rows, long long width, long long v_row_stride, long long s_row_stride, int num,
    int parts, int span) {
  constexpr bool kByLane = kSteps == kLaneSteps;
  constexpr int kBatch = 32 * kSteps;
  extern __shared__ __align__(16) float2 smem_pairs[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long task = (long long)blockIdx.x * kWarps + warp;
  if (task >= (long long)rows * parts) return;  // a whole warp; no block barrier follows
  const int r = (int)(task / parts);
  const int lo = (int)(task % parts) * span;
  const int hi = min(num, lo + span);
  float2* buf = smem_pairs + warp * kBatch;
  float* orow = out + (long long)r * num;
  float* sums = reinterpret_cast<float*>(smem_pairs + kWarps * kBatch) + warp * 2 * span;
  unsigned* masks = reinterpret_cast<unsigned*>(sums + span);
  if (!kByLane) {
    for (int i = lane; i < hi - lo; i += 32) {
      sums[i] = 0.f;
      masks[i] = 0u;
    }
  }
  const float* vr = values + r * v_row_stride;
  const Slot* sr = slots + r * s_row_stride;
  float acc = 0.f;
  float v[kSteps], vn[kSteps];
  int t[kSteps], tn[kSteps];
  load_batch<kSteps>(vr, sr, 0, width, lane, v, t);
  for (long long base = 0; base < width; base += kBatch) {
    load_batch<kSteps>(vr, sr, base + kBatch, width, lane, vn, tn);  // in flight meanwhile
    stage_batch<kSteps>(v, t, buf, num, lane);
    if constexpr (kByLane) {
      add_batch_by_lane<kSteps>(buf, lo + lane, acc);
    } else {
      add_batch_by_group(buf, lo, hi, sums, masks, lane);
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      v[j] = vn[j];
      t[j] = tn[j];
    }
  }
  if constexpr (kByLane) {
    if (lo + lane < hi) orow[lo + lane] = acc;
  } else {
    __syncwarp();
    for (int i = lane; i < hi - lo; i += 32) orow[lo + i] = sums[i];
  }
}

template <typename Slot, int kSteps>
int launch_rows(const void* values, const void* slots, void* out, int rows, long long width,
                long long v_row_stride, long long s_row_stride, int num, int parts, int span,
                cudaStream_t stream) {
  const long long blocks = ((long long)rows * parts + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long shared = 8LL * kWarps * (32 * kSteps + (kSteps == kLaneSteps ? 0 : span));
  segsum_rows_kernel<Slot, kSteps><<<(unsigned)blocks, 32 * kWarps, (int)shared, stream>>>(
      (const float*)values, (const Slot*)slots, (float*)out, rows, width, v_row_stride,
      s_row_stride, num, parts, span);
  return (int)cudaGetLastError();
}

}  // namespace

// values (rows, width) f32 with a unit stride along width; slots (rows,
// width) int16 (slot_bytes 2) or int32 (4), unit stride along width, row
// stride s_row_stride (0: one slot list for every row); out (rows, num) f32,
// contiguous. Returns a cudaError_t (0 = launched).
extern "C" int gims_segsum_rows(const void* values, const void* slots, int slot_bytes, void* out,
                                int rows, long long width, long long v_row_stride,
                                long long s_row_stride, int num, void* stream) {
  if (rows < 0 || num < 0 || width < 0 || (slot_bytes != 2 && slot_bytes != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0 || num == 0) return 0;
  const int by_lane = (long long)rows * ((num + 31) / 32) <= kLaneWarps;
  int parts = 1;
  if (by_lane) {
    parts = (num + 31) / 32;
  } else {
    if ((long long)rows * 2 < kTargetWarps) {  // few rows: split their slots over warps
      const int by_warps = (kTargetWarps + rows - 1) / rows;
      const int by_slots = (num + kMinSpan - 1) / kMinSpan;
      parts = by_warps < by_slots ? by_warps : by_slots;
    }
    const int by_smem = (num + kMaxSpan - 1) / kMaxSpan;  // the sums fit shared memory
    if (parts < by_smem) parts = by_smem;
  }
  const int span = (num + parts - 1) / parts;
  parts = (num + span - 1) / span;  // no empty range
  cudaStream_t st = (cudaStream_t)stream;
  auto launch = by_lane ? (slot_bytes == 2 ? launch_rows<int16_t, kLaneSteps>
                                            : launch_rows<int32_t, kLaneSteps>)
                       : (slot_bytes == 2 ? launch_rows<int16_t, kGroupSteps>
                                          : launch_rows<int32_t, kGroupSteps>);
  return launch(values, slots, out, rows, width, v_row_stride, s_row_stride, num, parts, span,
                st);
}
