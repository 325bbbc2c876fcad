// Hand-written Hopper (sm_90a) segment sum of feature rows.
//
// Replaces the TPU kernel segment_matmul_pallas
// (src/repro/kernels/segment_matmul.py:45, body _seg_mm_kernel at :25).
// Contract, as in src/repro_torch/kernels/ref.py::ref_segment_matmul:
//
//   out[s, :] = sum_{i : seg[i] == s} x[i, :]     s in [0, S)
//
// ids outside [0, S) are dropped; x is float32, bfloat16 or float16, read
// as it is and summed in float32; out is float32 (S, d).
//
// Design.  The TPU kernel keeps a (256-segment x 128-feature) output tile
// resident in VMEM across a sequential grid of row blocks and never writes
// a partial sum to HBM.  Here each output tile is owned by one block at a
// time, and its partial sums never leave the chip either.  The wrapper's
// planner (kernels/segment_matmul.py::plan_segment_sum) picks the tile,
// ts <= kMaxTile segments by tf <= 128 features, and one of two ways for a
// tile's block to find its rows:
//   * direct, one block per tile, about one block per SM: the block reads
//     all n int32 ids from L2 in rounds of `cap` (each warp its own
//     contiguous share, kIdLoads loads of 32 in flight a lane) and keeps
//     the rows whose id falls in its tile.  Each block reads 4 * n bytes of
//     ids, so this serves only while n times the tiles an SM takes is small
//     (the planner's PARTITION_IDS);
//   * partitioned, one cooperative launch of one block per SM (`parts`
//     blocks), which first sorts the rows by segment tile in global
//     memory: each block counts the ids of its contiguous chunk of rows per
//     tile in shared memory, in passes of up to kPassTiles tiles, and
//     stores the counts as a (tile x block) matrix; grid.sync(); a warp a
//     tile turns its row of the matrix into an exclusive prefix over the
//     blocks and the tile's total; grid.sync(); each block scans the totals
//     into the tiles' starts and scatters (row, id) of each of its rows to
//     its place in `perm` (a shared-memory integer atomic a tile gives the
//     place); grid.sync(); then the blocks take the (segment tile x feature
//     tile) work items in turn, each reading only its tile's rows from
//     perm.  The ids are read twice in all, whatever the number of tiles,
//     and perm (8 bytes a row) is written and read once.
// Then, either way, for each round of a tile's rows:
//   * the rows are counted per segment (a shared-memory integer atomic,
//     which also gives each row its rank) and listed; a prefix sum of the
//     counts and one scatter sort them by segment in shared memory;
//   * each warp owns an equal share of the tile's segments, sums their
//     rows in registers, lanes on neighbouring features (each row's slice
//     one coalesced read), kRows rows' loads in flight, and stores each
//     segment's slice once with plain coalesced stores (added to what an
//     earlier round stored, when there are several);
//   * unless the round's largest segment holds more than kSplitSlack rows
//     above an equal share of the rows (a hub, which one warp would sum
//     alone): then the warps take equal runs of the sorted rows instead,
//     a warp owning the segments that start in its run, and a segment that
//     runs on past a warp's run is stored after a block barrier, with the
//     pieces that the next warps summed (their runs' heads, in shared
//     memory) added in warp order.
// Every element of out is written by its tile's block, empty segments as 0,
// so out needs no zero fill and a call is one launch; no atomics touch
// floats and none touch global memory.  Each element of x is read from
// device memory once.  Rows are read with scalar loads: a row of d = 1,433
// floats is only 4-byte aligned, and 32 lanes x 4 bytes already make one
// 128-byte line a load.  A tile's rows are summed by one block: a hub
// segment runs at one SM's rate.
//
// Float addition in another order than the plain version's: integer-valued
// sums below 2^24 are exact, others agree to a reordering tolerance.
//
// Bound.  Bytes: x read once (n * d * its size), the ids once (4 * n), the
// output written once (4 * S * d), over the H100's 3.35 TB/s; one add per
// element is far below any compute peak.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;     // features a lane: tiles are at most 128 wide
constexpr int kIdLoads = 8;  // loads of 32 ids in flight a lane
constexpr int kRows = 4;     // rows' loads in flight a warp
constexpr int kMaxTile = 256;  // segments a tile (the TPU kernel's tile)
constexpr int kSplitSlack = 16;  // rows above an equal share before a segment is split
constexpr int kMaxCap = 16384;  // ids a round: ranks fit 17 bits, segments 14
constexpr int kPassTiles = 16384;  // tiles a partition pass counts in shared memory
constexpr int kMaxSharedBytes = 12 * kMaxCap + 8 * (kMaxTile + 1);
static_assert(4 * kPassTiles <= kMaxSharedBytes, "a pass's counts fit the tile's room");

struct Args {
  const void* x;
  const int32_t* seg;
  long long n;
  int d, num_segments, ts, tf, tiles_s, tiles_f, cap;
  int parts;        // 0: direct; else partitioned by `parts` blocks
  int* counts;      // (tiles_s, parts): a chunk's rows in a tile, then their prefix
  int* totals;      // (tiles_s,): a tile's rows
  int* starts;      // (tiles_s + 1,): where a tile's rows start in perm
  int2* perm;       // (n,): (row, id) sorted by tile
  float* out;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// a[0, len) replaced by its exclusive prefix sum; returns the sum of all.
// Each thread takes a contiguous run; every thread of the block calls it.
__device__ int block_exclusive_scan(int* a, int len) {
  __shared__ int warp_sums[kWarps];
  __shared__ int total;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = (len + kThreads - 1) / kThreads;
  const int b = min(len, threadIdx.x * per), e = min(len, b + per);
  int sum = 0;
  for (int i = b; i < e; ++i) sum += a[i];
  const int incl = warp_inclusive_scan(sum);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_sums[lane];
    const int vi = warp_inclusive_scan(v);
    warp_sums[lane] = vi - v;
    if (lane == 31) total = vi;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
  for (int i = b; i < e; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  const int all = total;
  __syncthreads();
  return all;
}

// The block's chunk of rows [c0, c1): each id's tile, relative to a pass's
// first tile t0, handed to f(row, id, local tile) when it lies in the pass.
template <typename F>
__device__ __forceinline__ void each_row_in_pass(const Args& a, long long c0, long long c1,
                                                 int t0, int tp, F f) {
  for (long long j = c0 + threadIdx.x; j < c1; j += kIdLoads * kThreads) {
    int32_t id[kIdLoads];
#pragma unroll
    for (int u = 0; u < kIdLoads; ++u) {
      const long long k = j + static_cast<long long>(u) * kThreads;
      id[u] = k < c1 ? __ldg(a.seg + k) : -1;
    }
#pragma unroll
    for (int u = 0; u < kIdLoads; ++u) {
      if (static_cast<unsigned>(id[u]) >= static_cast<unsigned>(a.num_segments)) continue;
      const int l = id[u] / a.ts - t0;
      if (static_cast<unsigned>(l) < static_cast<unsigned>(tp)) {
        f(static_cast<int>(j + static_cast<long long>(u) * kThreads), id[u], l);
      }
    }
  }
}

// Sorts the rows by segment tile into a.perm, with a.starts; `buf` holds
// kPassTiles ints of shared memory.  Every block of the cooperative grid
// calls it.
__device__ void partition_rows(const Args& a, int* buf) {
  cg::grid_group grid = cg::this_grid();
  const int parts = gridDim.x, g = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long c0 = a.n * g / parts, c1 = a.n * (g + 1) / parts;
  const int T = a.tiles_s;
  // counts of this chunk's rows per tile
  for (int t0 = 0; t0 < T; t0 += kPassTiles) {
    const int tp = min(kPassTiles, T - t0);
    for (int l = threadIdx.x; l < tp; l += kThreads) buf[l] = 0;
    __syncthreads();
    each_row_in_pass(a, c0, c1, t0, tp, [&](int, int, int l) { atomicAdd(&buf[l], 1); });
    __syncthreads();
    for (int l = threadIdx.x; l < tp; l += kThreads) {
      a.counts[static_cast<long long>(t0 + l) * parts + g] = buf[l];
    }
    __syncthreads();
  }
  grid.sync();
  // each tile's counts to their exclusive prefix over the chunks, a warp a tile
  for (long long t = static_cast<long long>(g) * kWarps + warp; t < T;
       t += static_cast<long long>(parts) * kWarps) {
    int* col = a.counts + t * parts;
    int carry = 0;
    for (int base = 0; base < parts; base += 32) {
      const int k = base + lane;
      const int c = k < parts ? col[k] : 0;
      const int incl = warp_inclusive_scan(c);
      if (k < parts) col[k] = carry + incl - c;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) a.totals[t] = carry;
  }
  grid.sync();
  // the tiles' starts, then this chunk's rows to their places
  int carry = 0;
  for (int t0 = 0; t0 < T; t0 += kPassTiles) {
    const int tp = min(kPassTiles, T - t0);
    for (int l = threadIdx.x; l < tp; l += kThreads) buf[l] = a.totals[t0 + l];
    __syncthreads();
    const int total = block_exclusive_scan(buf, tp);
    for (int l = threadIdx.x; l < tp; l += kThreads) {
      const int start = carry + buf[l];
      if (g == 0) a.starts[t0 + l] = start;
      buf[l] = start + a.counts[static_cast<long long>(t0 + l) * parts + g];
    }
    carry += total;
    __syncthreads();
    each_row_in_pass(a, c0, c1, t0, tp, [&](int row, int id, int l) {
      a.perm[atomicAdd(&buf[l], 1)] = make_int2(row, id);
    });
    __syncthreads();
  }
  if (g == 0 && threadIdx.x == 0) a.starts[T] = carry;
  grid.sync();
}

// Entries [j, j + 32 * kIdLoads) of a warp's share [.., j1), a lane's every
// 32nd, as (row, id): from the ids themselves (direct) or from perm; id -1
// past j1.
__device__ __forceinline__ void load_rows(const Args& a, long long j, long long j1,
                                          int32_t (&row)[kIdLoads],
                                          int32_t (&id)[kIdLoads]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < kIdLoads; ++u) {
    const long long k = j + 32 * u + lane;
    if (a.parts == 0) {
      row[u] = static_cast<int>(k);
      id[u] = k < j1 ? __ldg(a.seg + k) : -1;
    } else {
      const int2 p = k < j1 ? a.perm[k] : make_int2(0, -1);
      row[u] = p.x;
      id[u] = p.y;
    }
  }
}

// The first i in [0, len) with a[i] >= key (len if none), a ascending;
// every lane of the warp calls it and gets the answer.
__device__ __forceinline__ int lower_bound(const int* a, int len, int key) {
  for (int base = 0; base < len; base += 32) {
    const int i = base + static_cast<int>(threadIdx.x % 32);
    const unsigned ge = __ballot_sync(0xffffffffu, i < len && a[i] >= key);
    if (ge != 0) return base + __ffs(ge) - 1;
  }
  return len;
}

// acc += the rows sorted[q0, q1) of x, features [f0, f0 + cols) a lane's
// every 32nd, kRows rows' loads in flight.
template <typename T>
__device__ __forceinline__ void sum_rows(const T* __restrict__ x, const int* sorted, int q0,
                                         int q1, int d, int f0, int cols,
                                         float (&acc)[kCols]) {
  const int lane = threadIdx.x % 32;
  for (int q = q0; q < q1; q += kRows) {
    float v[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q + r < q1 ? sorted[q + r] : -1;
      const T* src = x + static_cast<long long>(max(row, 0)) * d + f0;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int f = lane + 32 * k;
        v[r][k] = row >= 0 && f < cols ? to_float(src[f]) : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[k] += v[r][k];
    }
  }
}

// out[s, f0 : f0 + cols] = acc, or += acc after the first round.
__device__ __forceinline__ void store_sums(const Args& a, int s, int f0, int cols,
                                           bool first, const float (&acc)[kCols]) {
  const int lane = threadIdx.x % 32;
  float* dst = a.out + static_cast<long long>(s) * a.d + f0;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int f = lane + 32 * k;
    if (f < cols) dst[f] = first ? acc[k] : dst[f] + acc[k];
  }
}

// One block per work item (segment tile x feature tile) at a time.  Shared
// memory: per segment its count and offset, then a round's listed rows
// (row, segment | rank << 14) and the same rows sorted by segment; a warp's
// head piece (the start of its run, inside a segment that began before it)
// in head_sum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_tiles(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ts = a.ts;
  int* count = reinterpret_cast<int*>(smem);                       // ts
  int* offset = count + ts;                                        // ts + 1
  int2* listed = reinterpret_cast<int2*>(smem + 8 * ((2 * ts + 2) / 2));  // cap
  int* sorted = reinterpret_cast<int*>(listed + a.cap);            // cap
  __shared__ int total, biggest;
  __shared__ float head_sum[kWarps][32 * kCols];
  __shared__ int head_seg[kWarps];

  if (a.parts > 0) partition_rows(a, reinterpret_cast<int*>(smem));
  const T* x = static_cast<const T*>(a.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int items = a.tiles_s * a.tiles_f;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int t = w / a.tiles_f;
    const int s0 = t * ts;
    const int f0 = (w % a.tiles_f) * a.tf;
    const int rows = min(ts, a.num_segments - s0);
    const int cols = min(a.tf, a.d - f0);
    const long long p0 = a.parts > 0 ? a.starts[t] : 0;
    const long long p1 = a.parts > 0 ? a.starts[t + 1] : a.n;

    for (long long r0 = p0; r0 < max(p1, p0 + 1); r0 += a.cap) {
      const long long r1 = min(p1, r0 + a.cap);
      const long long share = (r1 - r0 + 32LL * kWarps - 1) / (32LL * kWarps) * 32;
      const long long j0 = r0 + warp * share;
      const long long j1 = min(r1, j0 + share);
      int32_t row[kIdLoads], id[kIdLoads];
      load_rows(a, j0, j1, row, id);  // in flight while the counts are cleared
      __syncthreads();  // the last round's or item's readers are done
      for (int l = threadIdx.x; l < ts; l += kThreads) count[l] = 0;
      if (threadIdx.x == 0) total = 0;
      __syncthreads();
      for (long long j = j0; j < j1; j += 32 * kIdLoads) {
        if (j != j0) load_rows(a, j, j1, row, id);
#pragma unroll
        for (int u = 0; u < kIdLoads; ++u) {
          const unsigned local = static_cast<unsigned>(id[u]) - static_cast<unsigned>(s0);
          const bool hit = local < static_cast<unsigned>(rows);
          const unsigned ballot = __ballot_sync(0xffffffffu, hit);
          if (ballot == 0) continue;
          int at = 0;
          if (lane == 0) at = atomicAdd(&total, __popc(ballot));
          at = __shfl_sync(0xffffffffu, at, 0) + __popc(ballot & ((1u << lane) - 1));
          if (hit) {
            const int rank = atomicAdd(&count[local], 1);
            listed[at] = make_int2(row[u], static_cast<int>(local) | rank << 14);
          }
        }
      }
      __syncthreads();
      if (warp == 0) {  // offsets: the exclusive prefix sum of the counts
        int carry = 0, most = 0;
        for (int base = 0; base < rows; base += 32) {
          const int l = base + lane;
          const int c = l < rows ? count[l] : 0;
          const int incl = warp_inclusive_scan(c);
          if (l < rows) offset[l] = carry + incl - c;
          carry += __shfl_sync(0xffffffffu, incl, 31);
          most = max(most, __reduce_max_sync(0xffffffffu, c));
        }
        if (lane == 0) {
          offset[rows] = carry;
          biggest = most;
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < total; e += kThreads) {
        const int2 v = listed[e];
        sorted[offset[v.y & 0x3fff] + (v.y >> 14)] = v.x;
      }
      __syncthreads();
      const int per = (total + kWarps - 1) / kWarps;
      if (biggest <= per + kSplitSlack) {
        // each warp owns an equal share of the segments: summed in
        // registers, then stored (or added to an earlier round's sums)
        const int la = warp * rows / kWarps, lb = (warp + 1) * rows / kWarps;
        for (int l = la; l < lb; ++l) {
          float acc[kCols] = {};
          sum_rows(x, sorted, offset[l], offset[l + 1], a.d, f0, cols, acc);
          store_sums(a, s0 + l, f0, cols, r0 == p0, acc);
        }
        continue;
      }
      // a hub: the warps take equal runs [A, B) of the sorted rows; a warp
      // owns the segments that start in its run, sums each in registers and
      // stores it; a run that starts inside a segment sums that piece into
      // head_sum for the segment's owner, which adds the pieces after the
      // barrier
      const int A = min(total, warp * per), B = min(total, A + per);
      const int own0 = lower_bound(offset, rows + 1, A);
      const int own1 = warp == kWarps - 1 ? rows : lower_bound(offset, rows + 1, B);
      const int head = own0 > 0 && offset[own0] > A ? own0 - 1 : -1;
      if (head >= 0) {
        float acc[kCols] = {};
        sum_rows(x, sorted, A, min(offset[own0], B), a.d, f0, cols, acc);
#pragma unroll
        for (int k = 0; k < kCols; ++k) head_sum[warp][lane + 32 * k] = acc[k];
      }
      if (lane == 0) head_seg[warp] = head;
      float acc[kCols];
      int pending = -1;  // a segment that runs past B: stored after the barrier
      for (int l = own0; l < own1; ++l) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
        sum_rows(x, sorted, offset[l], min(offset[l + 1], B), a.d, f0, cols, acc);
        if (offset[l + 1] > B) {
          pending = l;
          break;
        }
        store_sums(a, s0 + l, f0, cols, r0 == p0, acc);
      }
      __syncthreads();
      if (pending >= 0) {
        for (int w2 = warp + 1; w2 < kWarps && head_seg[w2] == pending; ++w2) {
#pragma unroll
          for (int k = 0; k < kCols; ++k) acc[k] += head_sum[w2][lane + 32 * k];
        }
        store_sums(a, s0 + pending, f0, cols, r0 == p0, acc);
      }
    }
  }
}

template <typename T>
int launch(Args a, cudaStream_t s) {
  const int sums = 8 * ((2 * a.ts + 2) / 2) + 12 * a.cap;
  const int smem = a.parts > 0 && sums < 4 * kPassTiles ? 4 * kPassTiles : sums;
  if (a.parts == 0) {
    segment_sum_tiles<T><<<static_cast<unsigned>(a.tiles_s) * a.tiles_f, kThreads,
                           smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(segment_sum_tiles<T>), dim3(a.parts),
      dim3(kThreads), params, static_cast<size_t>(smem), s));
}

template <typename T>
int setup_one(int num_sms, int* parts) {
  const cudaError_t err = cudaFuncSetAttribute(
      segment_sum_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, segment_sum_tiles<T>, kThreads, kMaxSharedBytes);
  if (occ != cudaSuccess) return static_cast<int>(occ);
  *parts = *parts < per_sm * num_sms ? *parts : per_sm * num_sms;
  return 0;
}

}  // namespace

// Once per device, before the first launch on it: let every instantiation
// take up to kMaxSharedBytes of dynamic shared memory (above the 48 KB that
// needs no opt-in), and report the blocks that are surely co-resident
// (*parts, the least over instantiations at that shared memory), the most a
// partitioned launch may take.  Returns a cudaError_t (0 on success).
extern "C" int segment_matmul_setup(int num_sms, int* parts) {
  *parts = 1 << 30;
  int err = setup_one<float>(num_sms, parts);
  if (err == 0) err = setup_one<__nv_bfloat16>(num_sms, parts);
  if (err == 0) err = setup_one<__half>(num_sms, parts);
  if (err == 0 && *parts < 1) err = static_cast<int>(cudaErrorInvalidConfiguration);
  return err;
}

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
// dtype: 0 float32, 1 bfloat16, 2 float16.  x is (n, d) with contiguous
// rows, seg (n,) int32 with n < 2^31, out (num_segments, d) float32, every
// element of which the kernel writes.  The plan (plan_segment_sum): tiles
// of ts <= kMaxTile segments x tf <= 128 features, ids read in rounds
// of cap <= kMaxCap, and parts = 0 (direct) or the blocks of a partitioned
// launch, at most what segment_matmul_setup reported; then `scratch` holds
// (n * 2 + tiles_s * (parts + 2) + 1) int32, 8-byte aligned.
extern "C" int segment_matmul_launch(int dtype, const void* x, const int32_t* seg,
                                     long long n, int d, int num_segments, int ts,
                                     int tf, int cap, int parts, int* scratch,
                                     float* out, void* stream) {
  if (d == 0 || num_segments == 0) return 0;
  if (ts < 1 || ts > kMaxTile || tf < 1 || tf > 32 * kCols || cap < 1 ||
      cap > kMaxCap || parts < 0 || (parts > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.x = x;
  a.seg = seg;
  a.n = n;
  a.d = d;
  a.num_segments = num_segments;
  a.ts = ts;
  a.tf = tf;
  a.tiles_s = (num_segments + ts - 1) / ts;
  a.tiles_f = (d + tf - 1) / tf;
  a.cap = cap;
  a.parts = parts;
  a.out = out;
  if (parts > 0) {
    a.perm = reinterpret_cast<int2*>(scratch);
    a.counts = scratch + 2 * n;
    a.totals = a.counts + static_cast<long long>(a.tiles_s) * parts;
    a.starts = a.totals + a.tiles_s;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, s);
    case 1: return launch<__nv_bfloat16>(a, s);
    case 2: return launch<__half>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
