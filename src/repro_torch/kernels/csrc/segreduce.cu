// Hand-written Hopper (sm_90a) segment max.
//
// Replaces the TPU kernel segment_max_pallas (src/repro/kernels/segreduce.py:92,
// body _make_segmax_kernel at :42).  Contract, as in
// src/repro_torch/kernels/ref.py::ref_segment_max:
//
//   out[s] = max(init[s], max_{i : seg[i] == s, gate} v[i])   s in [0, S)
//   then out[s] = retire wherever valid_mask[s] == 0.
//
// ids outside [0, S) are dropped; when gated, rows with gate[i] != gate_value
// are dropped.  Without init an empty segment reports -inf, the max monoid's
// identity.  Values and init are read in their own type (float32 or int32,
// converted to float32 by round-to-nearest, as torch's cast does); out is
// float32, and the kernel writes every element of it.
//
// Design.  On the TPU the kernel is a one-hot compare-select on the VPU whose
// output tile stays resident across a sequential grid of row blocks.  Here a
// call is one cooperative launch of at most the co-resident blocks, with the
// mask folded in where the segment is written: a seed phase writes
// out[s] = mask ? init[s] or -inf : retire, grid.sync(), then a fold phase
// maxes every kept row whose segment is unmasked into out with the global
// sign-split atomic of atomic_max.cuh.  The vxm's 2^21 vertex slots (8 MB)
// stay resident in the 50 MB L2; the HyperLogLog fold's 4,096 registers
// (2^15 rows) take the same path: a thread-block cluster that maxed into
// shared-memory copies and merged them through distributed shared memory
// was slower there on the card (PERF.md, section 6).
// Each thread keeps kRowsInFlight rows' loads in flight.
// Max is exact in any order, so the result is bit-stable under atomics and
// bit-equal to the plain version (-0.0 orders below +0.0 throughout).
//
// Bound.  Each row is read once (4-byte id and value, plus a 4-byte gate id
// when gated) and each segment written once (plus read once for init, and a
// mask byte when masked): bound by bytes, 8 * n + 4 * S (+ 4 * n, 4 * S, S)
// over the H100's 3.35 TB/s.  One compare per row is far below the float32
// peak.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "atomic_max.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCoopThreads = 1024;
constexpr int kRowsInFlight = 4;  // rows a thread loads before it folds them

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int32_t x) { return __int2float_rn(x); }

struct Args {
  const int32_t* ids;
  const void* vals;
  const int32_t* gate;  // null: no gate
  int32_t gate_value;
  long long n;
  int num_segments;
  const void* init;     // null: -inf
  const uint8_t* mask;  // null: every segment valid
  float retire;
  float* out;
};

// Load up to R rows from i in steps of `stride`: id -1 where the row is past
// n, out of range or gated out.  All loads go out before any is used.
template <typename V, int R>
__device__ __forceinline__ void load_rows(const Args& a, long long i, long long stride,
                                          int32_t (&id)[R], float (&v)[R]) {
  const V* vals = static_cast<const V*>(a.vals);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long k = i + r * stride;
    const bool in = k < a.n;
    id[r] = in ? a.ids[k] : -1;
    v[r] = in ? to_float(vals[k]) : 0.0f;
    if (in && a.gate != nullptr && a.gate[k] != a.gate_value) id[r] = -1;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (static_cast<uint32_t>(id[r]) >= static_cast<uint32_t>(a.num_segments)) id[r] = -1;
  }
}

template <typename V, typename I>
__global__ void __launch_bounds__(kCoopThreads)
segmax_cooperative(Args a) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const I* init = static_cast<const I*>(a.init);
  for (long long s0 = t0; s0 < a.num_segments; s0 += kRowsInFlight * stride) {
    float seed[kRowsInFlight];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const long long s = s0 + r * stride;
      seed[r] = s >= a.num_segments ? 0.0f
                : a.mask != nullptr && a.mask[s] == 0 ? a.retire
                : init == nullptr ? neg_inf() : to_float(init[s]);
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      if (s0 + r * stride < a.num_segments) a.out[s0 + r * stride] = seed[r];
    }
  }
  cg::this_grid().sync();
  for (long long i = t0; i < a.n; i += kRowsInFlight * stride) {
    int32_t id[kRowsInFlight];
    float v[kRowsInFlight];
    load_rows<V>(a, i, stride, id, v);
    if (a.mask != nullptr) {  // a masked segment keeps retire
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (id[r] >= 0 && a.mask[id[r]] == 0) id[r] = -1;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      if (id[r] >= 0) atomic_max_float(&a.out[id[r]], v[r]);
    }
  }
}

template <typename V, typename I>
int cooperative_blocks(int num_sms, int* blocks) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, segmax_cooperative<V, I>, kCoopThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = *blocks < per_sm * num_sms ? *blocks : per_sm * num_sms;
  return 0;
}

template <typename V, typename I>
int launch(const Args& a, int coop_blocks, cudaStream_t s) {
  const long long work = a.n > a.num_segments ? a.n : a.num_segments;
  long long blocks = (work + kCoopThreads - 1) / kCoopThreads;
  if (blocks > coop_blocks) blocks = coop_blocks;
  if (blocks < 1) blocks = 1;
  Args copy = a;
  void* params[] = {&copy};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(segmax_cooperative<V, I>),
      dim3(static_cast<unsigned>(blocks)), dim3(kCoopThreads), params, 0, s));
}

template <typename V>
int launch_init(int init_kind, const Args& a, int coop_blocks, cudaStream_t s) {
  // init_kind: 0 none or float32, 1 int32
  return init_kind == 1 ? launch<V, int32_t>(a, coop_blocks, s)
                        : launch<V, float>(a, coop_blocks, s);
}

}  // namespace

// Once per device, before the first launch on it: report the co-resident
// blocks of the cooperative kernel (*coop_blocks, the least over its
// instantiations).  Returns a cudaError_t.
extern "C" int segment_max_setup(int num_sms, int* coop_blocks) {
  *coop_blocks = 1 << 30;
  int err = cooperative_blocks<float, float>(num_sms, coop_blocks);
  if (err == 0) err = cooperative_blocks<float, int32_t>(num_sms, coop_blocks);
  if (err == 0) err = cooperative_blocks<int32_t, float>(num_sms, coop_blocks);
  if (err == 0) err = cooperative_blocks<int32_t, int32_t>(num_sms, coop_blocks);
  return err;
}

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
// A cooperative launch of at most coop_blocks blocks.  val_kind and
// init_kind: 0 float32, 1 int32.  ids, vals and gate are (n,); init and
// mask (num_segments,); gate, init and mask may be null.  out
// (num_segments,) float32 is written whole.
extern "C" int segment_max_launch(int val_kind, int init_kind, const int32_t* ids,
                                  const void* vals, const int32_t* gate,
                                  int32_t gate_value, long long n, int num_segments,
                                  const void* init, const uint8_t* mask, float retire,
                                  float* out, int coop_blocks, void* stream) {
  if (num_segments == 0) return 0;
  const Args a{ids, vals, gate, gate_value, n, num_segments, init, mask, retire, out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return val_kind == 1 ? launch_init<int32_t>(init_kind, a, coop_blocks, s)
                       : launch_init<float>(init_kind, a, coop_blocks, s);
}
