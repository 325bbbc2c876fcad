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
// The TPU kernel walks a sequential grid whose innermost axis is the kv
// blocks, keeping the running max, sum and accumulator in VMEM scratch
// between grid steps.  Hopper blocks run in parallel and in no order, so here
// the kv walk is a loop inside a block (prefill), or is cut into chunks whose
// partial sums a second kernel combines (decode).  Three kernels; the wrapper
// (kernels/flash_attention.py) picks one from the shapes:
//
// * Prefill, bfloat16 (fa_prefill): bound by operations, 4 * D flops per
//   visible query-key pair at 989 TFLOP/s of dense bf16 on the H100 SXM's
//   tensor cores; only wgmma reaches that rate, and only if the tensor cores
//   never wait for a copy.  One block per (b, query head, 128 query rows), of
//   three warpgroups.  Warpgroup 0 produces: one thread issues TMA copies
//   (tensor maps encoded per call by the host from each operand's own
//   strides, 128-byte swizzle, rows past Lq or Lkv filled with
//   zeros) of the Q tile once and of each 128-key K and V tile into a ring of
//   2 (D 128) or 3 stages, paced by full/empty mbarrier pairs; it gives its
//   registers up (setmaxnreg) to the two consumer warpgroups of 64 query rows
//   each.  A consumer computes S = Q K^T with wgmma m64n128k16 (Q and K from
//   shared memory), runs the online softmax on S in f32 registers (base-2
//   exponent, -inf guard), rounds P to bf16 in registers and adds P V with
//   wgmma m64nDk16, P from registers as the A operand and V read from shared
//   memory through the descriptor's transpose.  Blocks are issued heaviest
//   query tile first under a causal mask; tiles wholly outside the band of a
//   warpgroup's rows are skipped, and only tiles that cross the diagonal, the
//   window's edge or Lkv are masked.  The kv heads' K and V are not shared
//   between the query heads of a GQA group in shared memory: at this bound
//   the re-reads come from the 50 MB L2 and cost no tensor-core time, and one
//   head a block keeps the masks per row simple.  Head size 32 takes the
//   64-byte swizzle (a 128-byte row would hold 64 elements), 64 and 128 the
//   128-byte one (128 as two 64-column slabs).
// * Decode, bfloat16 (fa_decode + fa_decode_combine), when the GQA group's
//   Hq / Hkv query heads x Lq rows fit one 16-row tile: bound by bytes, the
//   visible K and V read once over 3.35 TB/s.  The group's rows are packed
//   into one tile, so each K/V byte leaves device memory once, not once per
//   query head, and the kv axis is split: one block of 4 warps per (b, kv
//   head, kv chunk), with enough chunks for about two blocks on each SM, each
//   streaming its chunk through a 3-stage cp.async ring of 64-key tiles (each
//   warp takes 16 keys of a tile; mma.sync m16n8k16 with the packed rows
//   padded to 16, since tensor-core rate does not matter here).  Each block
//   folds its warps' online-softmax states and writes a float32 partial
//   (max, sum, unnormalised accumulator) per row into scratch the wrapper
//   allocates; a second small kernel, launched by the same C function,
//   rescales the partials by 2^(m_c - max_c m_c) and sums them.  A chunk or
//   warp that sees no key of a row carries m = -inf, l = 0 and adds nothing.
// * Float32 (fa_fwd_f32, no bf16 rounding allowed): one warp per query row,
//   a simple CUDA-core loop: 32 keys a tile in shared memory, one key's score
//   per lane, the warp's online softmax by shuffles, each lane owning D / 32
//   features of the accumulator.  No serving path runs it.
//
// All mask with -inf under a guard (a row whose running max is still -inf
// rescales by 0 and adds 0), where the TPU kernel masks with the finite
// -1e30 and lets alpha = 0 wipe out what a fully masked first tile added.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

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
  int hq, lq, lkv, group;
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

// The max and sum over the 4 lanes that share a row of an m16n8 fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const bf16* row, int col, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(row + col) : 0u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 2^x on the special function unit (2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step for the two rows (g, g + 8) a thread holds of an
// m16nN fragment: s[i] with i % 4 < 2 belong to row g.  Scores are raw q.k
// (masked ones -inf) and the running max m is kept in the same units; each
// exponent is taken as s * k - m * k in one FFMA, k = scale * log2(e).  (A
// caller whose scale is not positive multiplies the scores by it first and
// passes k = 1: the max must be taken after the scale.)  Returns the rescale
// factors of the old state in alpha, updates m and l (this lane's part of
// the row sums), and leaves the exponentials in s.
template <int N>
__device__ __forceinline__ void softmax_step(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float k) {
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float nb[2];  // -base * k
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    const float base = mn == neg_inf() ? 0.f : mn;  // the -inf guard
    alpha[r] = ex2((m[r] - base) * k);
    m[r] = mn;
    nb[r] = -base * k;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = ex2(fmaf(s[i], k, nb[(i / 2) % 2]));
    sum[(i / 2) % 2] += s[i];
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// ---------------------------------------------------------------- prefill

namespace prefill {

constexpr int kBlockM = 128;  // query rows per block: two consumer warpgroups
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65,536

template <int D>
struct Cfg {
  static constexpr int kSpan = D == 32 ? 32 : 64;  // elements per swizzled row
  static constexpr int kRowBytes = 2 * kSpan;      // 64- or 128-byte swizzle
  static constexpr int kLayout = D == 32 ? 2 : 1;  // wgmma descriptor: B64, B128
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kSlabQ = kBlockM * kRowBytes;  // one kSpan-column slab
  static constexpr int kSlabKV = kBlockN * kRowBytes;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;  // one K or V tile
  // Q, the K and V rings, then 2 * kStages + 1 barriers; 1 KB to align
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024 + 256;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of the 4-d tensor map (D, L, H, B) at (c0, c1, c2, c3) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching accumulator registers across the
// asynchronous products: reads of r after this stay after the wait above.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, f32) (+)= A (64 x 16, smem) * B (128 x 16 K-major, smem)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, f32) += A (64 x 16, registers) * B (16 x 32 MN-major, smem)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64 MN-major, smem)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128 MN-major, smem)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 32) {
    wgmma_rs_n32(o, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_prefill(const Params p, const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t sk = sq + C::kQBytes;                       // stage s: + s * tile
  const uint32_t sv = sk + C::kStages * C::kTileBytes;
  const uint32_t bars = sv + C::kStages * C::kTileBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::kStages + s); };
  const uint32_t qbar = bars + 16u * C::kStages;

  const int h = blockIdx.x % p.hq;
  const int b = blockIdx.x / p.hq;
  // heaviest query tile first: under a causal mask the last tiles see most keys
  const int tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * kBlockM;
  const int hk = h / p.group;
  const int off = p.lkv - p.lq;
  int begin, end;
  kv_band(p, q0 + off, min(q0 + kBlockM, p.lq) - 1 + off, begin, end);
  begin = begin / kBlockN * kBlockN;
  const int n_tiles = end > begin ? (end - begin + kBlockN - 1) / kBlockN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread releases a stage
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring filled
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(qbar, C::kQBytes);
      for (int c = 0; c < D / C::kSpan; ++c) {
        tma_load(sq + c * C::kSlabQ, &tq, qbar, c * C::kSpan, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages;
        mbar_wait(empty(s), ((it / C::kStages) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(full(s), 2 * C::kTileBytes);
        const int kv0 = begin + it * kBlockN;
        for (int c = 0; c < D / C::kSpan; ++c) {
          const uint32_t at = s * C::kTileBytes + c * C::kSlabKV;
          tma_load(sk + at, &tk, full(s), c * C::kSpan, kv0, hk, b);
          tma_load(sv + at, &tv, full(s), c * C::kSpan, kv0, hk, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;  // rows g and g + 8 of the warp's 16
    const int t = lane % 4;  // columns 2t, 2t + 1 of each 8
    const int wq0 = q0 + 64 * cw;  // the warpgroup's first row
    const int r0 = wq0 + 16 * warp + g;
    const int qpos[2] = {r0 + off, r0 + 8 + off};
    const bool active = wq0 < p.lq;
    const int wlast = min(wq0 + 64, p.lq) - 1;
    const float kscale = p.scale_log2 > 0.f ? p.scale_log2 : 1.f;  // see softmax_step

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {neg_inf(), neg_inf()};
    float l[2] = {0.f, 0.f};
    const uint64_t dq =
        gmma_desc(sq + 64 * cw * C::kRowBytes, 16, 8 * C::kRowBytes, C::kLayout);
    if (n_tiles > 0) mbar_wait(qbar, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::kStages;
      const int kv0 = begin + it * kBlockN;
      mbar_wait(full(s), (it / C::kStages) & 1);
      // the whole tile outside the band of this warpgroup's rows: nothing
      const bool skip = !active || (p.causal && kv0 > wlast + off) ||
                        (p.window > 0 && wq0 + off - (kv0 + kBlockN - 1) >= p.window);
      if (!skip) {
        float sc[kBlockN / 2];
        const uint64_t dk =
            gmma_desc(sk + s * C::kTileBytes, 16, 8 * C::kRowBytes, C::kLayout);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          // k step kk: slab (16 kk) / kSpan, then 32 bytes per step within it
          const uint32_t slab = (16 * kk) / C::kSpan;
          const uint32_t within = 2 * ((16 * kk) % C::kSpan);
          wgmma_ss_n128(sc, dq + ((slab * C::kSlabQ + within) >> 4),
                        dk + ((slab * C::kSlabKV + within) >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);

        if (!(p.scale_log2 > 0.f)) {
#pragma unroll
          for (int i = 0; i < kBlockN / 2; ++i) sc[i] *= p.scale_log2;
        }
        // mask only a tile that crosses Lkv, the diagonal or the window's edge
        if (kv0 + kBlockN > p.lkv || (p.causal && kv0 + kBlockN - 1 > wq0 + off) ||
            (p.window > 0 && wq0 + 63 + off - kv0 >= p.window)) {
#pragma unroll
          for (int i = 0; i < kBlockN / 2; ++i) {
            const int kpos = kv0 + 8 * (i / 4) + 2 * t + i % 2;
            if (!visible(p, qpos[(i / 2) % 2], kpos)) sc[i] = neg_inf();
          }
        }
        float alpha[2];
        softmax_step(sc, m, l, alpha, kscale);
        uint32_t pa[kBlockN / 16][4];  // P as the A fragments of P V
#pragma unroll
        for (int kc = 0; kc < kBlockN / 16; ++kc) {
          pa[kc][0] = pack_bf16(sc[8 * kc + 0], sc[8 * kc + 1]);
          pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
          pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
          pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kBlockN / 16; ++kc) {
          // V (16 keys x D) from row 16 kc, transposed: the slabs of D lie
          // kSlabKV apart, groups of 8 keys 8 rows apart
          wgmma_pv<D>(o, pa[kc],
                      gmma_desc(sv + s * C::kTileBytes + 16 * kc * C::kRowBytes,
                                C::kSlabKV, 8 * C::kRowBytes, C::kLayout));
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(o);
      }
      mbar_arrive(empty(s));
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[r]);
      inv[r] = sum == 0.f ? 0.f : 1.f / sum;
    }
    bf16* out = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r0 + 8 * r < p.lq) {
          *reinterpret_cast<uint32_t*>(out + (r0 + 8 * r) * p.o_sl + col) =
              pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

}  // namespace prefill

// ---------------------------------------------------------------- decode

namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;   // packed query rows: group x Lq, padded to 16
constexpr int kTile = 64;   // keys per stage; warp w takes keys [16 w, 16 w + 16)
constexpr int kStages = 3;

template <int D>
struct Cfg {
  static constexpr int kStride = D + 8;  // padded shared row: conflict-free reads
  static constexpr int kSmem = 2 * kStages * kTile * kStride * 2;  // K and V rings
  static_assert(kWarps * kRows * D * 4 <= kSmem, "the fold reuses the rings");
};

// c += a (16 x 16, row major) * b (16 x 8, column major); bf16 in, f32 sum.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
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
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(smem)));
}

// 16 bytes global -> shared, asynchronously; zeros where !ok.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Partials in `part` (float32), for block i of n = gridDim.x * y * z: the
// accumulator acc[i][16][D], then the row max m[i][16] and sum l[i][16], in
// base-2 units, acc unnormalised and scaled to m.  Block (c, hk, b) covers
// keys [begin + c * chunk_keys, + chunk_keys) of kv head hk of request b.
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_decode(const Params p, float* part, int begin, int chunk_keys) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [stage][key][kStride]
  bf16* vs = ks + kStages * kTile * C::kStride;
  __shared__ float wm[kWarps][kRows];
  __shared__ float wl[kWarps][kRows];

  const int c = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rows = p.group * p.lq;
  const int off = p.lkv - p.lq;
  const int c0 = begin + c * chunk_keys;
  const int c1 = min(p.lkv, c0 + chunk_keys);
  const int n_tiles = c1 > c0 ? (c1 - c0 + kTile - 1) / kTile : 0;

  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto load_tile = [&](int it, int s) {
    const int kv0 = c0 + it * kTile;
    for (int i = threadIdx.x; i < kTile * D / 8; i += kThreads) {
      const int row = i / (D / 8);
      const int col = (i % (D / 8)) * 8;
      const int kv = kv0 + row;
      const bool ok = kv < c1;
      const long long at = (ok ? kv : 0);
      cp_async_16(ks + (s * kTile + row) * C::kStride + col, k + at * p.k_sl + col, ok);
      cp_async_16(vs + (s * kTile + row) * C::kStride + col, v + at * p.v_sl + col, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // packed row r: query head hk * group + r / Lq, query r % Lq
  int qpos[2];
  bool live[2];
  uint32_t qf[D / 16][4];  // A fragments of the 16 x D packed queries
  const bf16* qrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pr = g + 8 * r;
    live[r] = pr < rows;
    qpos[r] = pr % p.lq + off;
    qrow[r] = static_cast<const bf16*>(p.q) + b * p.q_sb +
              (hk * p.group + pr / p.lq) * p.q_sh + (pr % p.lq) * p.q_sl;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(qrow[0], col, live[0]);
    qf[kk][1] = load_pair(qrow[1], col, live[1]);
    qf[kk][2] = load_pair(qrow[0], col + 8, live[0]);
    qf[kk][3] = load_pair(qrow[1], col + 8, live[1]);
  }

  float acc[D / 2];  // fragment n of 8 features at acc[4 n .. 4 n + 3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {neg_inf(), neg_inf()};
  float l[2] = {0.f, 0.f};
  const float kscale = p.scale_log2 > 0.f ? p.scale_log2 : 1.f;  // see softmax_step

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it has landed; every warp is done with it - 1
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const int s = it % kStages;
    const int kv0 = c0 + it * kTile + 16 * warp;  // this warp's 16 keys
    if (kv0 >= c1) continue;
    const bf16* kt = ks + (s * kTile + 16 * warp) * C::kStride;
    const bf16* vt = vs + (s * kTile + 16 * warp) * C::kStride;

    float sc[8];  // two m16n8 fragments: keys kv0 + [0, 8) and + [8, 16)
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* kr = kt + (8 * j + g) * C::kStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(sc + 4 * j, qf[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i / 2) % 2;
      const int kpos = kv0 + 8 * (i / 4) + 2 * t + i % 2;
      sc[i] = !(live[r] && visible(p, qpos[r], kpos)) ? neg_inf()
              : p.scale_log2 > 0.f                    ? sc[i]
                                                      : sc[i] * p.scale_log2;
    }
    float alpha[2];
    softmax_step(sc, m, l, alpha, kscale);
    const uint32_t pf[4] = {pack_bf16(sc[0], sc[1]), pack_bf16(sc[2], sc[3]),
                            pack_bf16(sc[4], sc[5]), pack_bf16(sc[6], sc[7])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n + 0] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, vt + (lane % 16) * C::kStride + 8 * n);
      mma_bf16(acc + 4 * n, pf, b0, b1);
    }
  }

  // fold the four warps' states: the block's max per row, each warp's
  // accumulator rescaled to it, summed in a fixed order
  cp_async_wait<0>();
  __syncthreads();  // the rings are free
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  m[0] *= kscale;  // the partials' maxima are in base-2 units
  m[1] *= kscale;
  if (t == 0) {
    wm[warp][g] = m[0];
    wm[warp][g + 8] = m[1];
    wl[warp][g] = l[0];
    wl[warp][g + 8] = l[1];
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = neg_inf();
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g + 8 * r]);
    f[r] = m[r] == neg_inf() ? 0.f : exp2f(m[r] - mx);
  }
  float* red = reinterpret_cast<float*>(smem_raw);  // [warp][row][D]
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* dst = red + (warp * kRows + g + 8 * r) * D + 8 * n + 2 * t;
      dst[0] = acc[4 * n + 2 * r] * f[r];
      dst[1] = acc[4 * n + 2 * r + 1] * f[r];
    }
  }
  __syncthreads();
  const int n_blocks = gridDim.x * gridDim.y * gridDim.z;
  const int blk = (b * gridDim.y + hk) * gridDim.x + c;
  float* pacc = part + static_cast<long long>(blk) * kRows * D;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w * kRows * D + i];
    pacc[i] = sum;
  }
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float mx = neg_inf();
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][r]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      if (wm[w][r] != neg_inf()) sum += wl[w][r] * exp2f(wm[w][r] - mx);
    }
    float* pm = part + static_cast<long long>(n_blocks) * kRows * D;
    pm[blk * kRows + r] = mx;
    pm[(n_blocks + blk) * kRows + r] = sum;
  }
}

// One block per (packed row, kv head, request), one thread per feature: the
// chunks' partials rescaled to their common max and summed, then normalised.
template <int D>
__global__ void __launch_bounds__(D)
fa_decode_combine(const Params p, const float* part, int n_chunks) {
  const int r = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int d = threadIdx.x;
  const int n_blocks = n_chunks * gridDim.y * gridDim.z;
  const int blk0 = (b * gridDim.y + hk) * n_chunks;
  const float* pm = part + static_cast<long long>(n_blocks) * kRows * D;
  const float* pl = pm + n_blocks * kRows;
  float mx = neg_inf();
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, pm[(blk0 + c) * kRows + r]);
  float sum = 0.f, acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int i = (blk0 + c) * kRows + r;
    if (pm[i] != neg_inf()) {  // a chunk that sees no key of this row adds nothing
      const float w = exp2f(pm[i] - mx);
      sum += pl[i] * w;
      acc += part[static_cast<long long>(i) * D + d] * w;
    }
  }
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb +
            (hk * p.group + r / p.lq) * p.o_sh + (r % p.lq) * p.o_sl;
  o[d] = __float2bfloat16(sum == 0.f ? 0.f : acc / sum);
}

}  // namespace decode

// ---------------------------------------------------------------- float32

constexpr int kKeysF32 = 32;  // keys per tile: one per lane

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

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library links against nothing but the runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr)
                                                : nullptr;
  }();
  return fn;
}

// The 4-d tensor map (D, L, H, B) of one bf16 operand from its element
// strides, boxes of span features x rows positions of one head, swizzled as
// the wgmma descriptors of fa_prefill expect; reads past L give zeros.
CUresult encode(CUtensorMap* map, const void* base, int d, int l, int h, int b,
                long long sl, long long sh, long long sb, int span, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  // the stride of a size-1 axis (passed as 0) is never used, but must be a
  // multiple of 16 bytes
  const auto bytes = [d](long long s) {
    return static_cast<cuuint64_t>(s > 0 ? 2 * s : 2 * d);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(l > 0 ? l : 1),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {bytes(sl), bytes(sh), bytes(sb)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(span),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            span == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Returns a cudaError_t, or minus the CUresult of a tensor map that did not
// encode.
template <int D>
int launch_prefill(const Params& p, int batch, int hkv, cudaStream_t s) {
  using C = prefill::Cfg<D>;
  CUtensorMap tq, tk, tv;
  CUresult r = encode(&tq, p.q, D, p.lq, p.hq, batch, p.q_sl, p.q_sh, p.q_sb,
                      C::kSpan, prefill::kBlockM);
  if (r == CUDA_SUCCESS) {
    r = encode(&tk, p.k, D, p.lkv, hkv, batch, p.k_sl, p.k_sh, p.k_sb, C::kSpan,
               prefill::kBlockN);
  }
  if (r == CUDA_SUCCESS) {
    r = encode(&tv, p.v, D, p.lkv, hkv, batch, p.v_sl, p.v_sh, p.v_sb, C::kSpan,
               prefill::kBlockN);
  }
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const cudaError_t e = cudaFuncSetAttribute(
      prefill::fa_prefill<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(batch * p.hq, (p.lq + prefill::kBlockM - 1) / prefill::kBlockM);
  prefill::fa_prefill<D><<<grid, prefill::kThreads, C::kSmem, s>>>(p, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_decode(const Params& p, int batch, int hkv, float* part, int begin,
                  int chunk_keys, int n_chunks, cudaStream_t s) {
  using C = decode::Cfg<D>;
  cudaError_t e = cudaFuncSetAttribute(
      decode::fa_decode<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  decode::fa_decode<D><<<dim3(n_chunks, hkv, batch), decode::kThreads, C::kSmem, s>>>(
      p, part, begin, chunk_keys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode::fa_decode_combine<D><<<dim3(p.group * p.lq, hkv, batch), D, 0, s>>>(
      p, part, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int is_bf16, const Params& p, int batch, int hkv, float* part, int begin,
           int chunk_keys, int n_chunks, cudaStream_t s) {
  if (!is_bf16) {
    fa_fwd_f32<D><<<dim3(p.lq, p.hq, batch), 32, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (part != nullptr) {
    if (p.group * p.lq > decode::kRows || n_chunks < 1 || chunk_keys < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_decode<D>(p, batch, hkv, part, begin, chunk_keys, n_chunks, s);
  }
  return launch_prefill<D>(p, batch, hkv, s);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), minus a
// CUresult if a tensor map does not encode, or cudaErrorInvalidValue for a
// head size without an instantiation or a decode tile that cannot hold the
// group's rows.
// strides: 12 element strides, (batch, head, position) of q, k, v and o.
// window <= 0: none.  Float32 runs fa_fwd_f32.  Bfloat16 runs the split-kv
// decode when `part` is given: float32 scratch of n_chunks * hkv * batch *
// 16 * (d + 2) values, chunk c covering keys [begin + c * chunk_keys, +
// chunk_keys); else the prefill kernel.  The wrapper picks the path and
// checks shapes, types and alignment.
extern "C" int flash_attention_launch(int is_bf16, const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int batch,
                                      int hq, int hkv, int lq, int lkv, int d,
                                      int causal, int window, float scale,
                                      float* part, int begin, int chunk_keys,
                                      int n_chunks, void* stream) {
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
  p.hq = hq;
  p.lq = lq;
  p.lkv = lkv;
  p.group = hq / hkv;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(is_bf16, p, batch, hkv, part, begin, chunk_keys, n_chunks, s);
    case 64: return launch<64>(is_bf16, p, batch, hkv, part, begin, chunk_keys, n_chunks, s);
    case 128: return launch<128>(is_bf16, p, batch, hkv, part, begin, chunk_keys, n_chunks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
