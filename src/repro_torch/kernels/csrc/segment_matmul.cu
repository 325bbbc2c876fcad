// Hand-written Hopper (sm_90a) segment sum of feature rows.
//
// Replaces the TPU kernel segment_matmul_pallas
// (src/repro/kernels/segment_matmul.py:45, body _seg_mm_kernel at :25).
// Contract, as in src/repro_torch/kernels/ref.py::ref_segment_matmul:
//
//   out[s, :] = sum_{i : seg[i] == s} x[i, :]     s in [0, S)
//
// ids outside [0, S) are dropped; x is float32, bfloat16 or float16, read
// as it is and summed in float32; out is float32 (S, d), zeroed by the
// wrapper before the launch.
//
// Design.  On the TPU the kernel is a one-hot matmul on the MXU,
// onehot(seg)^T @ x, whose output tile stays in VMEM across a sequential
// grid of row blocks: the TPU has no scatter worth the name, so it spends
// 2 * n * S * d flops to avoid one.  Hopper has fast float atomics in L2, so
// here it is the scatter itself: a grid-stride loop over rows, a group of
// 32 to 256 threads per row running along d (neighbouring threads on
// neighbouring features, so the row's load coalesces), each valid row's
// features added into out[seg[i], :] with atomicAdd (a fire-and-forget
// reduction in L2).  No one-hot, so no cost grows with S, and the
// reference's _MATMUL_SEGMENT_LIMIT has nothing to guard here.
//
// Float addition in no fixed order: integer-valued sums below 2^24 are
// exact, others agree with the plain version to a reordering tolerance.
//
// Bound.  Bytes: x read once (n * d * its size), the ids once (4 * n), the
// output written once (4 * S * d), over the H100's 3.35 TB/s; one add per
// element is far below any compute peak.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_rows(const T* __restrict__ x, const int32_t* __restrict__ seg,
                 long long n, int d, int num_segments, int lanes_per_row,
                 float* __restrict__ out) {
  const int rows_per_pass = kThreads / lanes_per_row;
  const int sub = threadIdx.x / lanes_per_row;
  const int lane = threadIdx.x % lanes_per_row;
  const long long step = static_cast<long long>(gridDim.x) * rows_per_pass;
  for (long long i = static_cast<long long>(blockIdx.x) * rows_per_pass + sub;
       i < n; i += step) {
    const int32_t s = seg[i];
    if (static_cast<uint32_t>(s) >= static_cast<uint32_t>(num_segments)) continue;
    const T* row = x + i * d;
    float* dst = out + static_cast<long long>(s) * d;
    for (int c = lane; c < d; c += lanes_per_row) atomicAdd(dst + c, to_float(row[c]));
  }
}

template <typename T>
int launch(const void* x, const int32_t* seg, long long n, int d,
           int num_segments, float* out, int num_sms, cudaStream_t s) {
  int lanes = 32;  // whole warps per row: the row test stays warp-uniform
  while (lanes < d && lanes < kThreads) lanes *= 2;
  const int rows_per_pass = kThreads / lanes;
  long long blocks = (n + rows_per_pass - 1) / rows_per_pass;
  if (blocks > 32LL * num_sms) blocks = 32LL * num_sms;
  segment_sum_rows<T><<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), seg, n, d, num_segments, lanes, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// dtype: 0 float32, 1 bfloat16, 2 float16.  x is (n, d) with contiguous
// rows, seg (n,) int32, out (num_segments, d) float32 zeroed by the caller.
extern "C" int segment_matmul_launch(int dtype, const void* x, const int32_t* seg,
                                     long long n, int d, int num_segments,
                                     float* out, int num_sms, void* stream) {
  if (n == 0 || d == 0 || num_segments == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, seg, n, d, num_segments, out, num_sms, s);
    case 1: return launch<__nv_bfloat16>(x, seg, n, d, num_segments, out, num_sms, s);
    case 2: return launch<__half>(x, seg, n, d, num_segments, out, num_sms, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
