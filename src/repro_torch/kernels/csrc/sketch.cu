// Hand-written Hopper (sm_90a) conservative-update Count-Min fold.
//
// Replaces the TPU kernel cms_update_pallas (src/repro/kernels/sketch.py:69,
// body _cms_kernel at :48).  Contract, as in
// src/repro_torch/kernels/ref.py::ref_cms_update:
//
//   out[r, c] = max(counts[r, c], max_{i : col[r, i] == c} prop[i])
//
// for each depth row r < depth and column c < width: every row scatter-maxes
// the same proposals through its own hashed columns; ids outside [0, width)
// (-1 marks a masked proposal) are dropped.  The wrapper copies `counts`
// into `out` before the launch.  int32 cells (the sketch tier's, exact past
// 2^24) or float32.
//
// Design.  On the TPU the kernel is a one-hot compare-select over a
// (depth, width tiles, proposal blocks) grid whose output tile stays
// resident across the sequential proposal axis: the TPU has no atomics.
// Here the grid is (blocks, depth): the blocks of one depth row walk that
// row's proposals with a grid-stride loop and atomic-max each straight into
// its cell in global memory (a default row of 4,096 cells is 16 KB and stays
// in L2).  int32 uses the native atomicMax, float32 the sign-split trick
// of atomic_max.cuh.  Max is exact in any order: bit-equal to the plain version.
//
// Bound.  Each (row, proposal) column id is read once (4 bytes), each
// proposal once (4 bytes), each cell read once and written once (8 bytes):
// bound by bytes, 4 * depth * n + 4 * n + 8 * depth * width over 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

#include "atomic_max.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cms_fold(const int32_t* __restrict__ cols, const T* __restrict__ prop,
         int64_t n, int width, T* __restrict__ out) {
  const int row = blockIdx.y;
  const int32_t* row_cols = cols + static_cast<int64_t>(row) * n;
  T* row_out = out + static_cast<int64_t>(row) * width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t c = row_cols[i];
    if (static_cast<uint32_t>(c) < static_cast<uint32_t>(width)) {
      atomic_max_any(&row_out[c], prop[i]);
    }
  }
}

template <typename T>
cudaError_t launch(const int32_t* cols, const void* prop_raw, int depth,
                   int64_t n, int width, void* out_raw, int num_sms,
                   cudaStream_t stream) {
  const T* prop = static_cast<const T*>(prop_raw);
  T* out = static_cast<T*>(out_raw);
  const int64_t row_blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = (32LL * num_sms + depth - 1) / depth;
  const dim3 grid(static_cast<unsigned>(row_blocks < cap ? row_blocks : cap),
                  depth);
  cms_fold<T><<<grid, kThreads, 0, stream>>>(cols, prop, n, width, out);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// cols is (depth, n) int32 row-major, prop (n,) and out (depth, width) in
// the cell type (int32 when cells_int32, else float), out seeded by the
// caller with the running counts.
extern "C" int cms_update_launch(int cells_int32, const int32_t* cols,
                                 const void* prop, int depth, long long n,
                                 int width, void* out, int num_sms,
                                 void* stream) {
  if (n <= 0 || depth <= 0 || width <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cells_int32 ? launch<int32_t>(cols, prop, depth, n, width, out, num_sms, s)
                  : launch<float>(cols, prop, depth, n, width, out, num_sms, s);
  return static_cast<int>(err);
}
