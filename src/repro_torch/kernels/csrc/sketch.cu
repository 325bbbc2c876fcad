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
// (-1 marks a masked proposal) are dropped.  int32 cells (the sketch tier's,
// exact past 2^24) or float32.  The kernel reads `counts` and writes every
// cell of `out` once: a call is one launch, with no copy of the cells.
//
// Design.  On the TPU the kernel is a one-hot compare-select over a
// (depth, width tiles, proposal blocks) grid whose output tile stays
// resident across the sequential proposal axis: the TPU has no atomics.
// Here one launch takes one of two paths:
//   * cluster (a depth row's cells fit a block's shared memory: the sketch
//     tier's 4,096 int32 cells are 16 KB): a thread-block cluster of
//     kCluster blocks per depth row.  Each block maxes its share of the
//     row's proposals into its own shared-memory copy of the row (shared
//     atomics: atomicMax for int32, atomic_max.cuh's sign-split trick for
//     float32), cluster.sync(), then owns width / kCluster columns: for
//     each it takes the max of counts and the kCluster copies, read through
//     distributed shared memory, and stores it once.  No global atomics.
//   * cooperative (any width; the only path for rows wider than the
//     opt-in shared memory): a seed phase copies counts into out,
//     grid.sync(), then every kept (row, proposal) pair is one atomic max
//     on its cell in global memory (L2), as segreduce.cu's segment max does.
// The wrapper takes the cluster path wherever a row fits: at the sketch
// tier's shape it is the faster on the device (PERF.md, section 6).
// Each thread keeps kRowsInFlight proposals' loads in flight.  Max is exact
// in any order: both paths are bit-equal to the plain version (-0.0 orders
// below +0.0 throughout; NaN is not supported).
//
// Bound.  Each (row, proposal) column id is read once (4 bytes), each
// proposal once (4 bytes), each cell read once and written once (8 bytes):
// bound by bytes, 4 * depth * n + 4 * n + 8 * depth * width over 3.35 TB/s.
// At the sketch tier's shape that is 0.23 us, far below one launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "atomic_max.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kCluster = 8;        // blocks per depth row on the cluster path
constexpr int kRowsInFlight = 4;   // proposals a thread loads before it folds them

struct Args {
  const int32_t* cols;  // (depth, n)
  const void* prop;     // (n,) in the cell type
  const void* counts;   // (depth, width)
  void* out;            // (depth, width), written whole
  long long n;
  int depth;
  int width;
};

template <typename T> __device__ __forceinline__ T lowest();
template <> __device__ __forceinline__ int32_t lowest<int32_t>() { return INT32_MIN; }
template <> __device__ __forceinline__ float lowest<float>() {
  return __int_as_float(0xff800000);  // -inf
}

// The max in the order of the atomics: +0.0 above -0.0.
__device__ __forceinline__ int32_t max_of(int32_t a, int32_t b) { return a > b ? a : b; }
__device__ __forceinline__ float max_of(float a, float b) {
  const int ia = __float_as_int(a), ib = __float_as_int(b);
  const int ka = ia >= 0 ? ia : ia ^ 0x7fffffff;  // monotone in the float
  const int kb = ib >= 0 ? ib : ib ^ 0x7fffffff;
  return ka >= kb ? a : b;
}

// Fold proposals [i0, i1) of depth row `row` into cells[] (shared or
// global), kRowsInFlight loads in flight per thread before any is used.
template <typename T>
__device__ __forceinline__ void fold(const Args& a, int row, long long i0, long long i1,
                                     long long t, long long stride, T* cells) {
  const int32_t* cols = a.cols + static_cast<long long>(row) * a.n;
  const T* prop = static_cast<const T*>(a.prop);
  for (long long i = i0 + t; i < i1; i += kRowsInFlight * stride) {
    int32_t c[kRowsInFlight];
    T p[kRowsInFlight];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const long long k = i + r * stride;
      c[r] = k < i1 ? cols[k] : -1;
      p[r] = k < i1 ? prop[k] : T(0);
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      if (static_cast<uint32_t>(c[r]) < static_cast<uint32_t>(a.width)) {
        atomic_max_any(&cells[c[r]], p[r]);
      }
    }
  }
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
cms_cluster(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cells = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / kCluster;
  for (int c = threadIdx.x; c < a.width; c += kThreads) cells[c] = lowest<T>();
  __syncthreads();
  const long long share = (a.n + kCluster - 1) / kCluster;
  const long long i0 = rank * share;
  const long long i1 = i0 + share < a.n ? i0 + share : a.n;
  fold<T>(a, row, i0, i1, threadIdx.x, kThreads, cells);
  cluster.sync();
  const long long base = static_cast<long long>(row) * a.width;
  const T* counts = static_cast<const T*>(a.counts) + base;
  T* out = static_cast<T*>(a.out) + base;
  const int cols = (a.width + kCluster - 1) / kCluster;
  const int c1 = (rank + 1) * cols < a.width ? (rank + 1) * cols : a.width;
  for (int c = rank * cols + threadIdx.x; c < c1; c += kThreads) {
    T got[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) got[r] = *cluster.map_shared_rank(&cells[c], r);
    T m = counts[c];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) m = max_of(m, got[r]);
    out[c] = m;
  }
  cluster.sync();  // no block leaves while another reads its copy
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cms_cooperative(Args a) {
  // grid (x blocks per row, y rows at a time): the seed runs over the
  // whole grid, the fold over the x blocks of each row
  const long long block = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  const long long all = static_cast<long long>(gridDim.x) * gridDim.y * kThreads;
  const long long cells = static_cast<long long>(a.depth) * a.width;
  const T* counts = static_cast<const T*>(a.counts);
  T* out = static_cast<T*>(a.out);
  for (long long k = block * kThreads + threadIdx.x; k < cells; k += all) out[k] = counts[k];
  cg::this_grid().sync();
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (int row = blockIdx.y; row < a.depth; row += gridDim.y) {
    fold<T>(a, row, 0, a.n, t, stride, out + static_cast<long long>(row) * a.width);
  }
}

template <typename T>
int cooperative_blocks(int num_sms, int* blocks) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cms_cooperative<T>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = *blocks < per_sm * num_sms ? *blocks : per_sm * num_sms;
  return 0;
}

template <typename T>
int launch(const Args& a, int cluster_path, int coop_blocks, cudaStream_t s) {
  if (cluster_path) {
    const size_t smem = static_cast<size_t>(a.width) * sizeof(T);
    cms_cluster<T><<<a.depth * kCluster, kThreads, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // a block per kThreads * kRowsInFlight proposals of a row, the rows side
  // by side while the co-resident blocks allow
  const long long rows = a.depth < coop_blocks ? a.depth : coop_blocks;
  const long long per_row = coop_blocks / rows;
  long long x = (a.n + static_cast<long long>(kThreads) * kRowsInFlight - 1) /
                (static_cast<long long>(kThreads) * kRowsInFlight);
  if (x > per_row) x = per_row;
  if (x < 1) x = 1;
  Args copy = a;
  void* params[] = {&copy};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cms_cooperative<T>),
      dim3(static_cast<unsigned>(x), static_cast<unsigned>(rows)), dim3(kThreads),
      params, 0, s));
}

}  // namespace

// Once per device, before the first launch on it: allow the cluster path
// the opt-in shared memory, and report the widest row it takes in bytes
// (*cluster_bytes) and the co-resident blocks of the cooperative path
// (*coop_blocks, the least over the cell types).  Returns a cudaError_t.
extern "C" int cms_update_setup(int num_sms, int* cluster_bytes, int* coop_blocks) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(cms_cluster<int32_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(cms_cluster<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *cluster_bytes = optin;
  *coop_blocks = 1 << 30;
  int e = cooperative_blocks<int32_t>(num_sms, coop_blocks);
  if (e == 0) e = cooperative_blocks<float>(num_sms, coop_blocks);
  return e;
}

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
// cols is (depth, n) int32 row-major, prop (n,), counts and out (depth,
// width) in the cell type (int32 when cells_int32, else float); out is
// written whole.  cluster_path: 1 the cluster path (width * 4 bytes within
// what cms_update_setup reported), 0 the cooperative path of at most
// coop_blocks blocks.
extern "C" int cms_update_launch(int cells_int32, int cluster_path, const int32_t* cols,
                                 const void* prop, const void* counts, int depth,
                                 long long n, int width, void* out, int coop_blocks,
                                 void* stream) {
  if (depth <= 0 || width <= 0) return 0;
  const Args a{cols, prop, counts, out, n, depth, width};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cells_int32 ? launch<int32_t>(a, cluster_path, coop_blocks, s)
                     : launch<float>(a, cluster_path, coop_blocks, s);
}
