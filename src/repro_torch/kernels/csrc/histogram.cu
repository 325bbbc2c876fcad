// Hand-written Hopper (sm_90a) weighted histogram.
//
// Replaces the TPU kernel histogram_pallas (src/repro/kernels/histogram.py:108,
// body _make_hist_kernel at :47).  Contract, as in
// src/repro_torch/kernels/ref.py::ref_histogram:
//
//   out[b] = init[b] + sum_{i : ids[i] == b, gate} w[i]     b in [0, num_bins)
//   then out[b] = retire wherever valid_mask[b] == 0.
//
// ids outside [0, num_bins) are dropped; when gated, rows with
// gate[i] != gate_value are dropped.  The wrapper seeds `out` from init (or
// zeros) before the launch; a null weights pointer means every weight is 1.
//
// Design.  On the TPU the kernel is a one-hot matmul on the MXU whose output
// tile stays resident across a sequential grid of row blocks: the TPU has no
// global atomics.  Hopper blocks run in parallel and in no order, and it has
// fast atomics, so here it is a privatised histogram:
//   * a grid-stride loop over rows;
//   * when num_bins * 4 bytes fits in 48 KB of shared memory (the default
//     challenge run's 8,192 flat bins take 32 KB), each block accumulates
//     into its own shared-memory copy of the bins and then adds its non-zero
//     bins to global memory with atomicAdd;
//   * above that size (the fused paths' capacity + 1 segments) every kept
//     row is one atomicAdd straight to global memory.
// A second, tiny kernel writes `retire` into the masked-out bins afterwards.
//
// Bound.  Each row is read once (4-byte id and weight, plus a 4-byte gate id
// when gated) and each bin written once, with one add per row: the kernel is
// bound by bytes, (8 or 12) * n + 4 * num_bins over the H100's 3.35 TB/s.
// Contention on hot bins is what keeps it from that bound; the shared copy
// absorbs it for small bin counts.
//
// Two accumulators: float for float weights, int32 for the integer sums of
// the fused windowed and top-k paths.  Native integer atomics make those
// exact at any count, where the TPU's float32 accumulation is exact only
// below 2^24.  Integer-valued float sums below 2^24 are exact in any order,
// so the default path's activity histogram is bit-stable under atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSharedBytes = 48 * 1024;  // no opt-in attribute needed

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
hist_shared(const int32_t* __restrict__ ids, const Acc* __restrict__ w,
            const int32_t* __restrict__ gate, int32_t gate_value, int64_t n,
            int num_bins, Acc* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* bins = reinterpret_cast<Acc*>(smem_raw);
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) bins[b] = Acc(0);
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t id = ids[i];
    if (static_cast<uint32_t>(id) < static_cast<uint32_t>(num_bins) &&
        (gate == nullptr || gate[i] == gate_value)) {
      atomicAdd(&bins[id], w == nullptr ? Acc(1) : w[i]);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
    const Acc v = bins[b];
    if (v != Acc(0)) atomicAdd(&out[b], v);
  }
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
hist_global(const int32_t* __restrict__ ids, const Acc* __restrict__ w,
            const int32_t* __restrict__ gate, int32_t gate_value, int64_t n,
            int num_bins, Acc* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t id = ids[i];
    if (static_cast<uint32_t>(id) < static_cast<uint32_t>(num_bins) &&
        (gate == nullptr || gate[i] == gate_value)) {
      atomicAdd(&out[id], w == nullptr ? Acc(1) : w[i]);
    }
  }
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
retire_bins(Acc* __restrict__ out, const uint8_t* __restrict__ mask,
            int num_bins, Acc retire) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < num_bins && mask[b] == 0) out[b] = retire;
}

template <typename Acc>
cudaError_t launch(const int32_t* ids, const void* weights,
                   const int32_t* gate, int32_t gate_value, int64_t n,
                   int num_bins, void* out_raw, const uint8_t* mask,
                   double retire, int num_sms, cudaStream_t stream) {
  const Acc* w = static_cast<const Acc*>(weights);
  Acc* out = static_cast<Acc*>(out_raw);
  if (n > 0) {
    const int64_t row_blocks = (n + kThreads - 1) / kThreads;
    const size_t smem = static_cast<size_t>(num_bins) * sizeof(Acc);
    if (smem <= kSharedBytes) {
      // a few resident blocks per SM; each flushes at most num_bins atomics
      const int64_t cap = 4LL * num_sms;
      const int blocks = static_cast<int>(row_blocks < cap ? row_blocks : cap);
      hist_shared<Acc><<<blocks, kThreads, smem, stream>>>(
          ids, w, gate, gate_value, n, num_bins, out);
    } else {
      const int64_t cap = 32LL * num_sms;
      const int blocks = static_cast<int>(row_blocks < cap ? row_blocks : cap);
      hist_global<Acc><<<blocks, kThreads, 0, stream>>>(
          ids, w, gate, gate_value, n, num_bins, out);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (mask != nullptr && num_bins > 0) {
    retire_bins<Acc><<<(num_bins + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(out, mask, num_bins, static_cast<Acc>(retire));
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// acc_int32 selects the int32 accumulator (weights and out int32), else float.
// weights, gate and mask may be null.
extern "C" int histogram_launch(int acc_int32, const int32_t* ids,
                                const void* weights, const int32_t* gate,
                                int32_t gate_value, long long n, int num_bins,
                                void* out, const uint8_t* mask, double retire,
                                int num_sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      acc_int32 ? launch<int32_t>(ids, weights, gate, gate_value, n, num_bins,
                                  out, mask, retire, num_sms, s)
                : launch<float>(ids, weights, gate, gate_value, n, num_bins,
                                out, mask, retire, num_sms, s);
  return static_cast<int>(err);
}
