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
// gate[i] != gate_value are dropped.  A null weights pointer means every
// weight is 1, a null init every init 0.  Weights and init are read in
// their own type (float32 or int32) and converted as torch's cast does;
// sums accumulate in float32 or int32 (exact at any count, where the TPU's
// float32 accumulation is exact only below 2^24).  The kernel writes every
// bin of `out` once or seeds it once: no fill, copy or retire kernel.
//
// Design.  On the TPU the kernel is a one-hot matmul on the MXU whose output
// tile stays resident across a sequential grid of row blocks: the TPU has no
// global atomics.  Here a call is one cooperative launch
// (cudaLaunchCooperativeKernel) of at most the co-resident blocks of
// kThreads threads, on one of two paths that the wrapper picks
// (kernels/histogram.py::plan_histogram):
//   * private (num_bins * 4 bytes fit kPrivateBytes and there are at least
//     as many rows as bins: the default run's 8,192 activity bins): each
//     block sums its rows into its own copy of the bins in shared memory
//     (shared atomics), stores the copy with plain stores into a
//     (blocks, num_bins) scratch (8.4 MB at 264 blocks, resident in L2),
//     grid.sync(), then sums the copies bin by bin in a fixed order (copy
//     group g of G = min(32, blocks) takes copies g, g + G, ... in turn;
//     the G partial sums are added in order), adds init, applies the mask
//     and stores each bin once.  No global atomics; float sums are
//     ordered across blocks (within a block, shared atomics add in any
//     order).
//   * scatter (more bins: the fused paths' capacity + 1 segments, the vxm's
//     vertex slots): a seed phase writes init or 0, or retire where the
//     mask is 0, into every bin; grid.sync(); then every kept row whose bin
//     is valid (the mask read per row) is added with a global atomic, after
//     a warp-level segmented reduction of equal ids in adjacent lanes: a
//     sorted run (a plan's segmentation) costs one atomic per warp round,
//     not one per row.  (A retire pass after a second grid.sync(), in place
//     of the mask read per row, was no faster at the vxm's shape.)
// Rows are read striped across each warp: lane l of a warp's tile of
// 32 * kRowsInFlight rows reads rows l, l + 32, ..., so every load
// instruction reads 128 contiguous bytes and a thread has kRowsInFlight
// rows (16 bytes of each array, as one 16-byte load would) in flight; the
// arrays need no alignment to each other, which views cut from a plan do
// not guarantee.  Adjacent lanes hold adjacent rows, so a sorted run lies
// in adjacent lanes and a warp's atomics land in adjacent words.  (16-byte
// vector loads on the private path were no faster at the activity
// histogram's shape; the private path reads its rows with the evict-first
// policy, which keeps the scratch in L2 and was faster there, while on the
// scatter path it was slower.)  PERF.md, section 6, has the times.
//
// Bound.  Each row is read once (4-byte id and weight, plus a 4-byte gate id
// when gated) and each bin written once (plus read once for init, and a
// mask byte when masked), with one add per row: the kernel is bound by
// bytes, (8 or 12) * n + 4 * num_bins over the H100's 3.35 TB/s.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 4;
constexpr int kPrivateBytes = 48 * 1024;  // the largest private copy of the bins
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* ids;
  const void* w;        // null: every weight 1
  const int32_t* gate;  // null: no gate
  int32_t gate_value;
  long long n;
  int num_bins;
  const void* init;     // null: 0
  const uint8_t* mask;  // null: every bin valid
  double retire;
  void* out;
  void* scratch;        // (blocks, num_bins), the private path only
};

// torch's casts: int32 -> float rounds to nearest, float -> int32 truncates
template <typename To> __device__ __forceinline__ To cast(float x);
template <typename To> __device__ __forceinline__ To cast(int32_t x);
template <> __device__ __forceinline__ float cast<float>(float x) { return x; }
template <> __device__ __forceinline__ float cast<float>(int32_t x) { return __int2float_rn(x); }
template <> __device__ __forceinline__ int32_t cast<int32_t>(float x) { return static_cast<int32_t>(x); }
template <> __device__ __forceinline__ int32_t cast<int32_t>(int32_t x) { return x; }

// A row's element, read through L2 with the evict-first policy when
// kStream (the rows are read once; the private path's scratch should stay).
template <bool kStream, typename T>
__device__ __forceinline__ T row(const T* p, long long k) {
  return kStream ? __ldcs(p + k) : p[k];
}

// Load a lane's kRowsInFlight rows of the warp tile at `base`: id -1 where
// the row is past n, out of range or gated out.  All loads go out before
// any is used.
template <bool kStream, typename Acc, typename W>
__device__ __forceinline__ void load_rows(const Args& a, long long base, int lane,
                                          int32_t (&id)[kRowsInFlight],
                                          Acc (&v)[kRowsInFlight]) {
  const W* w = static_cast<const W*>(a.w);
  int32_t g[kRowsInFlight];
#pragma unroll
  for (int r = 0; r < kRowsInFlight; ++r) {
    const long long k = base + r * 32 + lane;
    const bool in = k < a.n;
    id[r] = in ? row<kStream>(a.ids, k) : -1;
    v[r] = !in ? Acc(0) : w == nullptr ? Acc(1) : cast<Acc>(row<kStream>(w, k));
    g[r] = in && a.gate != nullptr ? row<kStream>(a.gate, k) : a.gate_value;
  }
#pragma unroll
  for (int r = 0; r < kRowsInFlight; ++r) {
    if (static_cast<uint32_t>(id[r]) >= static_cast<uint32_t>(a.num_bins) ||
        g[r] != a.gate_value) {
      id[r] = -1;
    }
  }
}

// The value bin b ends with, given the sum of its rows.
template <typename Acc, typename I>
__device__ __forceinline__ Acc finish(const Args& a, long long b, Acc sum) {
  if (a.mask != nullptr && a.mask[b] == 0) return static_cast<Acc>(a.retire);
  return a.init == nullptr ? sum : cast<Acc>(static_cast<const I*>(a.init)[b]) + sum;
}

template <typename Acc, typename W, typename I>
__global__ void __launch_bounds__(kThreads, 2)
hist_private(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* bins = reinterpret_cast<Acc*>(smem_raw);
  __shared__ Acc part[kThreads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = threadIdx.x; b < a.num_bins; b += kThreads) bins[b] = Acc(0);
  __syncthreads();
  const long long tile = 32LL * kRowsInFlight;
  const long long step = static_cast<long long>(gridDim.x) * kWarps * tile;
  for (long long base = (static_cast<long long>(blockIdx.x) * kWarps + warp) * tile;
       base < a.n; base += step) {
    int32_t id[kRowsInFlight];
    Acc v[kRowsInFlight];
    load_rows<true, Acc, W>(a, base, lane, id, v);
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      if (id[r] >= 0) atomicAdd(&bins[id[r]], v[r]);
    }
  }
  __syncthreads();
  Acc* scratch = static_cast<Acc*>(a.scratch);
  Acc* mine = scratch + static_cast<long long>(blockIdx.x) * a.num_bins;
  for (int b = threadIdx.x; b < a.num_bins; b += kThreads) mine[b] = bins[b];
  cg::this_grid().sync();
  // copy group g (of G) sums copies g, g + G, ... for a chunk of bins, its
  // warps side by side; then the G partial sums are added in order
  const int groups = gridDim.x < kWarps ? gridDim.x : kWarps;
  const int warps_per_group = kWarps / groups;
  const int chunk = 32 * warps_per_group;
  const int g = warp / warps_per_group;
  const int j = (warp % warps_per_group) * 32 + lane;
  for (long long c0 = static_cast<long long>(blockIdx.x) * chunk; c0 < a.num_bins;
       c0 += static_cast<long long>(gridDim.x) * chunk) {
    if (g < groups) {
      const long long b = c0 + j;
      Acc s = Acc(0);
      if (b < a.num_bins) {
#pragma unroll 4
        for (int k = g; k < static_cast<int>(gridDim.x); k += groups) {
          s += scratch[static_cast<long long>(k) * a.num_bins + b];
        }
      }
      part[g * chunk + j] = s;
    }
    __syncthreads();
    const int t = threadIdx.x;
    if (t < chunk && c0 + t < a.num_bins) {
      Acc s = part[t];
      for (int q = 1; q < groups; ++q) s += part[q * chunk + t];
      static_cast<Acc*>(a.out)[c0 + t] = finish<Acc, I>(a, c0 + t, s);
    }
    __syncthreads();
  }
}

template <typename Acc, typename W, typename I>
__global__ void __launch_bounds__(kThreads)
hist_scatter(Args a) {
  Acc* out = static_cast<Acc*>(a.out);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       b < a.num_bins; b += stride) {
    out[b] = finish<Acc, I>(a, b, Acc(0));
  }
  cg::this_grid().sync();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = 32LL * kRowsInFlight;
  const long long step = static_cast<long long>(gridDim.x) * kWarps * tile;
  for (long long base = (static_cast<long long>(blockIdx.x) * kWarps + warp) * tile;
       base < a.n; base += step) {
    int32_t id[kRowsInFlight];
    Acc v[kRowsInFlight];
    load_rows<false, Acc, W>(a, base, lane, id, v);
    if (a.mask != nullptr) {  // a masked bin keeps retire
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (id[r] >= 0 && a.mask[id[r]] == 0) id[r] = -1;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      // a run of equal ids in adjacent lanes is summed into its last lane
      const int32_t prev = __shfl_up_sync(kFull, id[r], 1);
      const int32_t next = __shfl_down_sync(kFull, id[r], 1);
      const bool head = lane == 0 || id[r] != prev;
      Acc s = v[r];
      if (__any_sync(kFull, !head && id[r] >= 0)) {  // segmented inclusive scan
        int f = head;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
          const Acc s_up = __shfl_up_sync(kFull, s, d);
          const int f_up = __shfl_up_sync(kFull, f, d);
          if (lane >= d && !f) {
            s += s_up;
            f = f_up;
          }
        }
      }
      if (id[r] >= 0 && (lane == 31 || id[r] != next)) atomicAdd(&out[id[r]], s);
    }
  }
}

// The co-resident blocks of the kernel `fn` with `smem` dynamic bytes;
// *blocks takes the least over the calls.
template <typename K>
int resident(K fn, size_t smem, int num_sms, int* blocks) {
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = *blocks < per_sm * num_sms ? *blocks : per_sm * num_sms;
  return 0;
}

template <typename Acc, typename W, typename I>
int setup_one(int num_sms, int* private_blocks, int* scatter_blocks) {
  cudaError_t err = cudaFuncSetAttribute(hist_private<Acc, W, I>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kPrivateBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int e = resident(hist_private<Acc, W, I>, kPrivateBytes, num_sms, private_blocks);
  if (e == 0) e = resident(hist_scatter<Acc, W, I>, 0, num_sms, scatter_blocks);
  return e;
}

template <typename Acc, typename W, typename I>
int launch(const Args& a, int private_path, int blocks, cudaStream_t s) {
  Args copy = a;
  void* params[] = {&copy};
  const void* fn = private_path
      ? reinterpret_cast<const void*>(hist_private<Acc, W, I>)
      : reinterpret_cast<const void*>(hist_scatter<Acc, W, I>);
  const size_t smem = private_path ? static_cast<size_t>(a.num_bins) * sizeof(Acc) : 0;
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), params, smem, s));
}

// kinds: 0 float32, 1 int32
template <typename Acc>
int launch_kinds(int w_kind, int init_kind, const Args& a, int private_path, int blocks,
                 cudaStream_t s) {
  if (w_kind == 1) {
    return init_kind == 1 ? launch<Acc, int32_t, int32_t>(a, private_path, blocks, s)
                          : launch<Acc, int32_t, float>(a, private_path, blocks, s);
  }
  return init_kind == 1 ? launch<Acc, float, int32_t>(a, private_path, blocks, s)
                        : launch<Acc, float, float>(a, private_path, blocks, s);
}

template <typename Acc>
int setup_acc(int num_sms, int* private_blocks, int* scatter_blocks) {
  int e = setup_one<Acc, float, float>(num_sms, private_blocks, scatter_blocks);
  if (e == 0) e = setup_one<Acc, float, int32_t>(num_sms, private_blocks, scatter_blocks);
  if (e == 0) e = setup_one<Acc, int32_t, float>(num_sms, private_blocks, scatter_blocks);
  if (e == 0) e = setup_one<Acc, int32_t, int32_t>(num_sms, private_blocks, scatter_blocks);
  return e;
}

}  // namespace

// Once per device, before the first launch on it: allow the private path
// kPrivateBytes of shared memory, and report the co-resident blocks of each
// path (the least over its instantiations) and the largest private copy in
// bytes.  Returns a cudaError_t.
extern "C" int histogram_setup(int num_sms, int* private_blocks, int* scatter_blocks,
                               int* private_bytes) {
  *private_blocks = *scatter_blocks = 1 << 30;
  *private_bytes = kPrivateBytes;
  int e = setup_acc<float>(num_sms, private_blocks, scatter_blocks);
  if (e == 0) e = setup_acc<int32_t>(num_sms, private_blocks, scatter_blocks);
  return e;
}

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
// One cooperative launch of `blocks` blocks (at most what histogram_setup
// reported for the path).  acc_int32 selects the int32 accumulator (out
// int32), else float; w_kind and init_kind: 0 float32, 1 int32 (ignored
// where the pointer is null).  ids, weights and gate are (n,); init and
// mask (num_bins,); weights, gate, init and mask may be null.  scratch is
// (blocks, num_bins) in the accumulator's type on the private path, else
// unused.  out (num_bins,) is written whole.
extern "C" int histogram_launch(int acc_int32, int w_kind, int init_kind, int private_path,
                                int blocks, const int32_t* ids, const void* weights,
                                const int32_t* gate, int32_t gate_value, long long n,
                                int num_bins, const void* init, const uint8_t* mask,
                                double retire, void* out, void* scratch, void* stream) {
  if (num_bins <= 0) return 0;
  const Args a{ids, weights, gate, gate_value, n, num_bins, init, mask, retire, out, scratch};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return acc_int32 ? launch_kinds<int32_t>(w_kind, init_kind, a, private_path, blocks, s)
                   : launch_kinds<float>(w_kind, init_kind, a, private_path, blocks, s);
}
