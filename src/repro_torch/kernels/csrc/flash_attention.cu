// Hand-written Hopper (sm_90a) fused attention forward.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:85, body _fa_kernel at :33).
// Contract, as in src/repro_torch/kernels/ref.py::ref_attention:
//
//   q (B, Hq, Lq, D), k and v (B, Hkv, Lkv, D), Hq % Hkv == 0; query head h
//   reads kv head h / (Hq / Hkv).  Query i sits at position i + Lkv - Lq (the
//   ends of the two ranges align).  Key j is visible to it when j < Lkv, and
//   j <= pos if causal, and pos - j < window if a window is set.
//   o = softmax(scale * q k^T over the visible keys) v, in float32, written
//   in q's type; a row that sees no key is 0 (the TPU kernel's l == 0 case).
//
// Each tensor is addressed through its own batch, head and position strides
// (elements; the feature axis is contiguous), so a cut of a longer KV cache,
// cache[:, :, :n], is read where it lies and never copied.
//
// Design.  The TPU kernel walks a sequential grid whose innermost axis is the
// kv blocks, keeping the running max, sum and accumulator in VMEM scratch
// between grid steps.  Hopper blocks run in parallel and in no order, so the
// kv walk is a loop inside one block:
//
//   * bfloat16: one block of 4 warps per (b, h, 64 query rows), 16 rows a
//     warp.  Each kv tile of 64 keys is staged in shared memory (rows padded
//     by 8 elements, so the fragment reads below hit 32 distinct banks), then
//     every warp computes its 16 x 64 scores with mma.sync m16n8k16 (bf16 in,
//     f32 accumulate) from Q fragments held in registers, runs the online
//     softmax in f32 registers (row max and sum across the 4 lanes that share
//     a row, by shuffles), rounds P to bf16 in the register layout the next
//     product takes as its A operand, and adds P V with V's fragments loaded
//     transposed by ldmatrix.  The f32 accumulator of 16 x D stays in
//     registers for the whole walk.
//   * float32 (no bf16 rounding allowed): one warp per query row, a simple
//     CUDA-core loop: 32 keys a tile in shared memory, one key's score per
//     lane, the warp's online softmax by shuffles, each lane owning D / 32
//     features of the accumulator.
//
// Both skip the kv tiles wholly outside the causal / window band of their
// rows and mask with -inf under a guard (a row whose running max is still
// -inf rescales by 0 and adds 0), where the TPU kernel masks with the finite
// -1e30 and lets alpha = 0 wipe out what a fully masked first tile added.
//
// Bound.  Prefill is bound by operations: 4 * B * Hq * Lq * Lkv' * D flops
// (Lkv' the visible keys per row, half of Lkv for causal prefill) at 989
// TFLOP/s of dense bf16 on the H100 SXM's tensor cores.  mma.sync reaches a
// fraction of that (wgmma and TMA, which reach the rest, are later work).
// Decode (Lq = 1) is bound by bytes: the whole visible K and V, read once,
// over 3.35 TB/s; here B * Hq blocks each stream their kv head's cache, so a
// group of Hq / Hkv heads reads it Hq / Hkv times (from L2 after the first),
// and no split of the kv axis spreads one long row over more SMs.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block (bf16 kernel)
constexpr int kBlockK = 64;           // keys per shared-memory tile (bf16 kernel)
constexpr int kKeysF32 = 32;          // keys per tile (f32 kernel): one per lane
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_sl;  // element strides: batch, head, position
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int lq, lkv, group;
  int causal, window;  // window <= 0: none
  float scale_log2;    // scale * log2(e): scores live in base-2 exponent units
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Is the key at kpos visible to the query at qpos?
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.lkv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// The keys [begin, end) any query at a position in [qlo, qhi] may see.
__device__ __forceinline__ void kv_band(const Params& p, int qlo, int qhi,
                                        int& begin, int& end) {
  begin = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
  end = p.causal ? min(p.lkv, qhi + 1) : p.lkv;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int m = 16; m > 0; m /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int m = 16; m > 0; m /= 2) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// c += a (16 x 16, row major) * b (16 x 8, column major); bf16 in, f32 sum.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 matrices from shared memory, transposed: lanes 0-7 name the
// rows of the first, lanes 8-15 those of the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* row, int col,
                                              bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(row + col) : 0u;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_bf16(const Params p) {
  constexpr int kStride = D + 8;  // padded shared row, in elements
  constexpr int kChunks = kBlockK * D / 8;  // 16-byte chunks in a tile
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * kStride];

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // the row pair (g, g + 8) of the fragments
  const int t = lane % 4;  // the column pair (2t, 2t + 1)
  const int off = p.lkv - p.lq;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int begin, end;
  kv_band(p, q0 + off, min(q0 + kBlockQ, p.lq) - 1 + off, begin, end);
  begin = begin / kBlockK * kBlockK;

  const int wq0 = q0 + warp * 16;  // this warp's first row
  const bool active = wq0 < p.lq;
  const int wlast = min(wq0 + 16, p.lq) - 1;
  const int r0 = wq0 + g;
  const int r1 = r0 + 8;
  const int qp0 = r0 + off;
  const int qp1 = r1 + off;

  uint32_t qf[D / 16][4];  // A fragments of this warp's 16 x D queries
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(q + r0 * p.q_sl, col, r0 < p.lq);
    qf[kk][1] = load_pair(q + r1 * p.q_sl, col, r1 < p.lq);
    qf[kk][2] = load_pair(q + r0 * p.q_sl, col + 8, r0 < p.lq);
    qf[kk][3] = load_pair(q + r1 * p.q_sl, col + 8, r1 < p.lq);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = neg_inf(), m1 = neg_inf();  // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;              // this lane's part of their sums

  for (int kv0 = begin; kv0 < end; kv0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int row = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      const int kv = kv0 + row;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u);
      uint4 vx = kx;
      if (kv < p.lkv) {
        kx = *reinterpret_cast<const uint4*>(k + kv * p.k_sl + col);
        vx = *reinterpret_cast<const uint4*>(v + kv * p.v_sl + col);
      }
      *reinterpret_cast<uint4*>(&ks[row * kStride + col]) = kx;
      *reinterpret_cast<uint4*>(&vs[row * kStride + col]) = vx;
    }
    __syncthreads();
    // the whole tile outside this warp's band: nothing to add
    if (!active || (p.causal && kv0 > wlast + off) ||
        (p.window > 0 && wq0 + off - (kv0 + kBlockK - 1) >= p.window)) {
      continue;
    }

    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = &ks[(j * 8 + g) * kStride + 2 * t];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
    }

    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = kv0 + j * 8 + 2 * t + e;
        s[j][e] = visible(p, qp0, kpos) ? s[j][e] * p.scale_log2 : neg_inf();
        s[j][2 + e] = visible(p, qp1, kpos) ? s[j][2 + e] * p.scale_log2 : neg_inf();
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float base0 = mn0 == neg_inf() ? 0.f : mn0;  // the -inf guard
    const float base1 = mn1 == neg_inf() ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - base0);
    const float alpha1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;

    uint32_t pf[kBlockK / 16][4];  // P as the A fragments of P V
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      const float p00 = exp2f(s[j][0] - base0);
      const float p01 = exp2f(s[j][1] - base0);
      const float p10 = exp2f(s[j][2] - base1);
      const float p11 = exp2f(s[j][3] - base1);
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      pf[j / 2][2 * (j % 2)] = pack_bf16(p00, p01);
      pf[j / 2][2 * (j % 2) + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;

#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
#pragma unroll
      for (int kc = 0; kc < kBlockK / 16; ++kc) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &vs[(kc * 16 + lane % 16) * kStride + n * 8]);
        mma_bf16(acc[n], pf[kc], b0, b1);
      }
    }
  }

  if (!active) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < p.lq) {
      *reinterpret_cast<uint32_t*>(o + r0 * p.o_sl + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    }
    if (r1 < p.lq) {
      *reinterpret_cast<uint32_t*>(o + r1 * p.o_sl + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32)
fa_fwd_f32(const Params p) {
  constexpr int kPer = D / 32;  // accumulator features per lane
  __shared__ float qs[D];
  __shared__ float ks[kKeysF32][D + 1];  // padded: lane j reads row j
  __shared__ float vs[kKeysF32][D];

  const int i = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int lane = threadIdx.x;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                   i * p.q_sl;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  for (int d = lane; d < D; d += 32) qs[d] = q[d];

  const int qpos = i + p.lkv - p.lq;
  int begin, end;
  kv_band(p, qpos, qpos, begin, end);
  float acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.f;
  float m = neg_inf(), l = 0.f;

  for (int kv0 = begin; kv0 < end; kv0 += kKeysF32) {
    __syncwarp();
    for (int c = lane; c < kKeysF32 * D; c += 32) {
      const int row = c / D;
      const int col = c % D;
      const int kv = kv0 + row;
      ks[row][col] = kv < p.lkv ? k[kv * p.k_sl + col] : 0.f;
      vs[row][col] = kv < p.lkv ? v[kv * p.v_sl + col] : 0.f;
    }
    __syncwarp();
    const int kpos = kv0 + lane;
    float s = neg_inf();
    if (visible(p, qpos, kpos)) {
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qs[d], ks[lane][d], dot);
      s = dot * p.scale_log2;
    }
    const float mn = fmaxf(m, warp_max(s));
    const float base = mn == neg_inf() ? 0.f : mn;
    const float alpha = exp2f(m - base);
    const float pj = exp2f(s - base);
    l = l * alpha + warp_sum(pj);
    m = mn;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[e] *= alpha;
    for (int j = 0; j < kKeysF32; ++j) {
      const float pk = __shfl_sync(0xffffffffu, pj, j);
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[e] = fmaf(pk, vs[j][lane + 32 * e], acc[e]);
    }
  }

  const float inv = l == 0.f ? 0.f : 1.f / l;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + i * p.o_sl;
#pragma unroll
  for (int e = 0; e < kPer; ++e) o[lane + 32 * e] = acc[e] * inv;
}

template <int D>
int launch(int is_bf16, const Params& p, int batch, int hq, cudaStream_t s) {
  if (is_bf16) {
    const dim3 grid((p.lq + kBlockQ - 1) / kBlockQ, hq, batch);
    fa_fwd_bf16<D><<<grid, kThreads, 0, s>>>(p);
  } else {
    const dim3 grid(p.lq, hq, batch);
    fa_fwd_f32<D><<<grid, 32, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head size without an instantiation.
// strides: 12 element strides, (batch, head, position) of q, k, v and o.
// window <= 0: none.  The wrapper checks shapes, types and alignment.
extern "C" int flash_attention_launch(int is_bf16, const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int batch,
                                      int hq, int hkv, int lq, int lkv, int d,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (batch == 0 || hq == 0 || lq == 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_sl = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_sl = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_sl = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_sl = strides[11];
  p.lq = lq;
  p.lkv = lkv;
  p.group = hq / hkv;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(is_bf16, p, batch, hq, s);
    case 64: return launch<64>(is_bf16, p, batch, hq, s);
    case 128: return launch<128>(is_bf16, p, batch, hq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
