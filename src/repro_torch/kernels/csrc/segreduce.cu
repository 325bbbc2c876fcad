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
// are dropped.  The wrapper seeds `out` from init (or -inf, the max monoid's
// identity, which is what an empty segment reports) before the launch.
//
// Design.  On the TPU the kernel is a one-hot compare-select on the VPU whose
// output tile stays resident across a sequential grid of row blocks: the TPU
// has no atomics.  Hopper blocks run in parallel and in no order, so here it
// is a scatter with a float atomic max (atomic_max.cuh):
//   * a grid-stride loop over rows;
//   * when S * 4 bytes fits in 48 KB of shared memory (the HyperLogLog fold's
//     4,096 registers take 16 KB), each block maxes into its own
//     shared-memory copy of the segments, initialised to -inf, and then
//     flushes the segments it touched to global memory with the atomic max;
//     the grid is sized so that the flush costs no more atomics than the rows;
//   * above that size (the vxm's 2 * capacity vertex slots) every kept row is
//     one atomic max straight to global memory.
// A second, tiny kernel writes `retire` into the masked-out segments.
//
// Max is exact in any order, so the result is bit-stable under atomics and
// bit-equal to the plain version.
//
// Bound.  Each row is read once (4-byte id and value, plus a 4-byte gate id
// when gated) and each segment written once (plus read once for init, and a
// mask byte when masked): bound by bytes, 8 * n + 4 * S (+ 4 * n, 4 * S, S)
// over the H100's 3.35 TB/s.  One compare per row is far below the float32
// peak.

#include <cstdint>
#include <cuda_runtime.h>

#include "atomic_max.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kSharedBytes = 48 * 1024;  // no opt-in attribute needed

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__global__ void __launch_bounds__(kThreads)
segmax_shared(const int32_t* __restrict__ ids, const float* __restrict__ v,
              const int32_t* __restrict__ gate, int32_t gate_value, int64_t n,
              int num_segments, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* segs = reinterpret_cast<float*>(smem_raw);
  for (int s = threadIdx.x; s < num_segments; s += blockDim.x) segs[s] = neg_inf();
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t id = ids[i];
    if (static_cast<uint32_t>(id) < static_cast<uint32_t>(num_segments) &&
        (gate == nullptr || gate[i] == gate_value)) {
      atomic_max_float(&segs[id], v[i]);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < num_segments; s += blockDim.x) {
    const float m = segs[s];
    if (m != neg_inf()) atomic_max_float(&out[s], m);
  }
}

__global__ void __launch_bounds__(kThreads)
segmax_global(const int32_t* __restrict__ ids, const float* __restrict__ v,
              const int32_t* __restrict__ gate, int32_t gate_value, int64_t n,
              int num_segments, float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t id = ids[i];
    if (static_cast<uint32_t>(id) < static_cast<uint32_t>(num_segments) &&
        (gate == nullptr || gate[i] == gate_value)) {
      atomic_max_float(&out[id], v[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
retire_segments(float* __restrict__ out, const uint8_t* __restrict__ mask,
                int num_segments, float retire) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < num_segments && mask[s] == 0) out[s] = retire;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// vals and ids are (n,), out (num_segments,) seeded by the caller; gate and
// mask may be null.
extern "C" int segment_max_launch(const int32_t* ids, const float* vals,
                                  const int32_t* gate, int32_t gate_value,
                                  long long n, int num_segments, float* out,
                                  const uint8_t* mask, float retire,
                                  int num_sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && num_segments > 0) {
    const int64_t row_blocks = (n + kThreads - 1) / kThreads;
    const size_t smem = static_cast<size_t>(num_segments) * sizeof(float);
    if (smem <= kSharedBytes) {
      // each block flushes up to num_segments atomics: keep the blocks'
      // flushes within the row count, and a few blocks per SM at most
      int64_t blocks = (n + num_segments - 1) / num_segments;
      if (blocks > row_blocks) blocks = row_blocks;
      if (blocks > 4LL * num_sms) blocks = 4LL * num_sms;
      segmax_shared<<<static_cast<int>(blocks), kThreads, smem, s>>>(
          ids, vals, gate, gate_value, n, num_segments, out);
    } else {
      const int64_t cap = 32LL * num_sms;
      const int blocks = static_cast<int>(row_blocks < cap ? row_blocks : cap);
      segmax_global<<<blocks, kThreads, 0, s>>>(ids, vals, gate, gate_value, n,
                                                num_segments, out);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (mask != nullptr && num_segments > 0) {
    retire_segments<<<(num_segments + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        out, mask, num_segments, retire);
  }
  return static_cast<int>(cudaGetLastError());
}
