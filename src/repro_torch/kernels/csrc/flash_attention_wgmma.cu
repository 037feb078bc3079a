// Flash attention for prefill on Hopper's tensor cores: bf16 in, f32
// accumulate.  The same function as flash_attention.cu (which stays the f32
// route):
//
//   out[b, t, h, :] = softmax_s(mask(q[b, t, h, :] · k[b, s, h / G, :] · scale))
//                     · v[b, s, h / G, :]          G = H / Hkv, scale = 1/sqrt(D)
//
// with qpos = q_offset + t, kpos = s, rel = qpos - kpos; causal masks rel < 0,
// a window masks rel >= window; masked scores are NEG_INF = -2^30 (not -inf);
// the softmax is the online one with m and l in f32; the output is
// acc / max(l, 1e-30) rounded to bf16.
//
// Replaces the Pallas-TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_kernel) for bf16 inputs at head_dim 16, 32, 64, 80 and
// 128.  On the TPU the KV axis is a sequential grid dimension with m, l and
// acc in VMEM scratch; here a CTA owns a (b, h, 64-query tile) and loops over
// 64-key tiles.
//
// Bound on an H100: operations.  At the serve shape (B 4, T = S = 1024, H 32,
// Hkv 8, D 64, causal) the causal pairs need 4·B·H·D·T(T+1)/2 = 17.2 GFLOP,
// 17.4 µs at 989 TFLOP/s of bf16 tensor cores, against 42 MB of q, k, v and
// out (12.5 µs at 3.35 TB/s).  So the products go to wgmma, and the rest is
// kept off the tensor cores' path:
//
// - A CTA is one consumer warpgroup (128 threads, the 64 query rows that are
//   wgmma's M) and one producer warp whose first thread issues every TMA
//   load.  Two CTAs share an SM, so one's prologue and epilogue run under
//   the other's products (on an H100 this beat two consumer warpgroups a
//   CTA, one CTA an SM, with setmaxnreg moving the producer's registers to
//   them).
// - TMA reads Q once and K, V tile by tile into a ring of kStages stages,
//   each with an mbarrier pair: `full` (the producer's expect_tx, completed
//   by the copy's bytes) and `empty` (one arrival per consumer thread once
//   its products have read the stage).  The tensor maps describe q (B, T, H,
//   D) and k, v (B, S, Hkv, D) where they lie, 4-D with a box of (columns,
//   1 head, rows, 1 batch): nothing is transposed or copied.  A row's columns
//   go in boxes of 64 (128 bytes, 128-byte swizzle), 32 (64-byte swizzle) or
//   16 (32-byte swizzle): D 128 is two 64-column boxes, D 80 a 64- and a
//   16-column one.  Rows beyond T or S are zero-filled by TMA.
// - S = Q·K^T: wgmma m64n64k16 over D in steps of 16 columns, A = Q and B = K
//   both from shared memory, both K-major (K's row-major (keys, D) layout is
//   B's K-major form).
// - Softmax in registers on the accumulator's fragment: scores times scale
//   in f32, the mask only on tiles that need it (as column limits a row),
//   row max and (at the end) row sum over the 4 lanes of a quad by xor
//   shuffles, ex2.approx with log2(e) folded in.  l sums the unrounded P.
// - O += P·V: P is rounded to bf16 in registers; the S accumulator's layout
//   is the A-fragment layout of wgmma's register form (FlashAttention-3's
//   reuse), so no shared-memory round trip.  B = V from shared memory as an
//   MN-major operand (the transpose bit): one product spans the 64-column
//   boxes, one more D 80's 16-column box.
// - Software pipeline within the warpgroup (FlashAttention-3's): S of tile
//   i and P·V of tile i - 1 are issued together; the softmax of tile i runs
//   while the tensor cores finish P·V.
// - Epilogue: acc / max(l, 1e-30) to bf16, stored as bf16 pairs; only rows
//   < T are stored.
//
// KV tiles masked for the whole query tile are skipped (exact on every row
// with a valid key: a masked tile after a valid one adds exp(NEG_INF - m) =
// 0, one before it is wiped by corr = 0); a row without a valid key is
// outside the contract and refused by the wrapper.  GQA by index: query head
// h reads KV head h / G.  The grid is 1-D, the heaviest causal query tiles
// (the last) first for every (b, h), heads of one KV head next to each
// other.  Offsets into out are 64-bit; TMA coordinates are 32-bit (T, S, H,
// B < 2^31).
//
// The tensor maps are built per call on the host with cuTensorMapEncodeTiled,
// looked up through the CUDA runtime (cudaGetDriverEntryPointByVersion), so
// the library needs no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;     // -2^30
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;                       // query rows a CTA
constexpr int kBK = 64;                       // keys a tile
constexpr int kConsumers = 128;               // one consumer warpgroup
constexpr int kThreads = kConsumers + 32;     // + a producer warp
constexpr int kCtasPerSm = 2;

// A head_dim's columns as TMA boxes: kN0 boxes of kW0 columns, then one of
// kW1 if kW1 > 0.  A box of w columns is 2 w bytes a row, swizzled at that
// width; a tile of R rows keeps the box at column c at byte c · R · 2.
template <int D>
struct Cfg {
  static constexpr int kW0 = D < 64 ? D : 64;
  static constexpr int kN0 = D < 64 ? 1 : D / 64;
  static constexpr int kW1 = D > 64 ? D % 64 : 0;
  static constexpr int kBoxes = kN0 + (kW1 > 0 ? 1 : 0);
  // K/V ring depth: two CTAs of it fit in an SM's 228 KB
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;    // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  // + 1024 to align the base for the 128-byte swizzle, + the barriers
  static constexpr int kSmem = kBarOffset + 1024 + (2 * kStages + 1) * 8;
  __host__ __device__ static constexpr int width(int box) {
    return box < kN0 ? kW0 : kW1;
  }
};

// the swizzle of a box w columns (2 w bytes) wide, as wgmma's descriptor
// names it (1: 128 B, 2: 64 B, 3: 32 B)
__host__ __device__ constexpr int swizzle_code(int w) {
  return w == 64 ? 1 : w == 32 ? 2 : 3;
}

// the tensor maps of q, k and v: [0] for the kW0-column boxes, [1] for the
// kW1-column one (unused unless kW1 > 0)
struct Maps {
  CUtensorMap q[2], k[2], v[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase with the given parity has completed.  A
// wait that outlasts 2^26 tries (seconds; a tile arrives in microseconds)
// traps, so a fault in the ring ends the launch with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor of a swizzled operand; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of wgmma's registers across it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the SFU, one instruction (exp2f adds a denormal path)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A (64 x 16, K-major) * B (64 x 16, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16, bf16 in registers) * B (16 x 32, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 16, f32) += A (64 x 16, bf16 in registers) * B (16 x 16, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// Issue S = Q K^T: D / 16 steps of 16 columns, each inside one box (at a
// 32-byte offset into its swizzled rows).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2],
                                         const uint8_t* Qs,
                                         const uint8_t* Kt) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = 16 * kk;
    const int box = min(col / C::kW0, C::kN0);
    const int w = C::width(box);
    const int first = box * C::kW0;            // the box's first column
    const int off = (col - first) * 2;
    const uint64_t da = smem_desc(Qs + first * kBQ * 2 + off, 16, 16 * w,
                                  swizzle_code(w));
    const uint64_t db = smem_desc(Kt + first * kBK * 2 + off, 16, 16 * w,
                                  swizzle_code(w));
    wgmma_ss(sc, da, db, kk > 0);
  }
}

// Issue O += P V: kBK / 16 steps of 16 keys, V MN-major (8-row groups 16 w
// bytes apart).  One product spans the kN0 boxes of kW0 columns (boxes kBK
// rows apart), one more the kW1-column box (its n8 blocks of the
// accumulator from index kN0 kW0 / 2 on).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBK / 4],
                                         const uint8_t* Vt) {
  using C = Cfg<D>;
  constexpr int n0 = C::kN0 * C::kW0;
  float (&o0)[n0 / 2] = *reinterpret_cast<float (*)[n0 / 2]>(&o[0]);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs(o0, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
             smem_desc(Vt + kk * 16 * 2 * C::kW0, kBK * 2 * C::kW0,
                       16 * C::kW0, swizzle_code(C::kW0)));
  if constexpr (C::kW1 > 0) {
    float (&o1)[C::kW1 / 2] =
        *reinterpret_cast<float (*)[C::kW1 / 2]>(&o[n0 / 2]);
    const uint8_t* vb = Vt + n0 * kBK * 2;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs(o1, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
               pa[4 * kk + 3],
               smem_desc(vb + kk * 16 * 2 * C::kW1, 16 * C::kW1,
                         16 * C::kW1, swizzle_code(C::kW1)));
  }
}

// The online softmax of one score tile, in place in registers on wgmma's
// accumulator fragment: this thread holds rows r and r + 8 (pos0, pos0 + 8)
// and columns 8 j + cq + {0, 1} of each 8-column block j.  Scores are
// scaled in f32, masked where the tile needs it and replaced by P (f32); l
// sums this unrounded P; corr rescales the accumulator.
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kBK / 2], float (&m_run)[2], float (&l_run)[2],
    float (&corr)[2], bool need_mask, int k0, long long pos0, int cq, int S,
    int causal, int window, float scale) {
  if (need_mask) {
    // the valid columns c of row u: lo[u] < c <= hi[u], c < S - k0
    // (rel = pos - k0 - c; 64-bit positions, clamped to the tile once)
    int hi[2], lo[2];
    const int s_lim = min(S - k0, kBK);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long base = pos0 + 8 * u - k0;         // rel at c = 0
      hi[u] = causal ? (int)max(-1ll, min(base, (long long)kBK)) : kBK;
      lo[u] = window > 0 ? (int)max(-1ll, min(base - window, (long long)kBK))
                         : -1;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + cq + (e & 1), u = e >> 1;
        const bool ok = c < s_lim && c <= hi[u] && c > lo[u];
        sc[4 * j + e] = ok ? sc[4 * j + e] * scale : kNegInf;
      }
  } else {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] *= scale;
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float mb[2];                       // m_new · log2(e), folded into the exp
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
    const float m_new = fmaxf(m_run[u], mx[u]);
    corr[u] = ex2((m_run[u] - m_new) * kLog2e);
    m_run[u] = m_new;
    mb[u] = m_new * kLog2e;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(sc[4 * j + e], kLog2e, -mb[e >> 1]));
      sum[e >> 1] += p;
      sc[4 * j + e] = p;
    }
#pragma unroll
  for (int u = 0; u < 2; ++u) l_run[u] = l_run[u] * corr[u] + sum[u];
}

// P (f32, the accumulator's fragment) to bf16 pairs laid out as wgmma's A
// fragment: pa[2 j] row r, pa[2 j + 1] row r + 8, columns 8 j + cq, + 1.
__device__ __forceinline__ void pack_p(const float (&sc)[kBK / 2],
                                       uint32_t (&pa)[kBK / 4]) {
#pragma unroll
  for (int j = 0; j < kBK / 4; ++j) pa[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
flash_wgmma_kernel(const __grid_constant__ Maps maps,
                   __nv_bfloat16* __restrict__ out, int B, int T_, int S,
                   int H, int Hkv, int causal, int window, long long q_offset,
                   float scale) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;                                 // [boxes][kBQ][2 w]
  uint8_t* Ks = Qs + C::kQBytes;                      // [kStages][boxes][kBK][2 w]
  uint8_t* Vs = Ks + kStages * C::kTileBytes;         // [kStages][boxes][kBK][2 w]
  const uint32_t bar0 = smem_u32(smem + C::kBarOffset);
  // barriers: full[s] at bar0 + 8 s, empty[s] at bar0 + 8 (kStages + s),
  // Q's at bar0 + 16 kStages
  const uint32_t q_bar = bar0 + 16 * kStages;

  // heaviest causal query tiles (the last) first, for every (b, h)
  const int nqt = (T_ + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * H);
  const int qt = nqt - 1 - blockIdx.x / (B * H);
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, T_ - q0);

  // KV tiles holding at least one valid key for some row of this tile
  const long long qpos_lo = q_offset + q0;
  const long long qpos_hi = q_offset + q0 + q_rows - 1;
  int kt_first = 0, kt_last = (S - 1) / kBK;
  if (causal) {
    const long long last = qpos_hi / kBK;
    if (last < kt_last) kt_last = (int)last;
  }
  if (window > 0) {
    const long long lo = qpos_lo - window + 1;
    if (lo > 0) kt_first = (int)(lo / kBK);
  }
  const int n_tiles = kt_last - kt_first + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar0 + 8 * s, 1);
      mbar_init(bar0 + 8 * (kStages + s), kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: its first thread issues every load ----
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, C::kQBytes);
#pragma unroll
      for (int box = 0; box < C::kBoxes; ++box) {
        const int first = box * C::kW0;
        tma_load(smem_u32(Qs + first * kBQ * 2), &maps.q[box < C::kN0 ? 0 : 1],
                 q_bar, first, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(bar0 + 8 * (kStages + s), ((i / kStages) & 1) ^ 1);
        const uint32_t full = bar0 + 8 * s;
        mbar_expect_tx(full, 2 * C::kTileBytes);
        const int k0 = (kt_first + i) * kBK;
#pragma unroll
        for (int box = 0; box < C::kBoxes; ++box) {
          const int first = box * C::kW0;
          const int off = s * C::kTileBytes + first * kBK * 2;
          const int m = box < C::kN0 ? 0 : 1;
          tma_load(smem_u32(Ks + off), &maps.k[m], full, first, hk, k0, b);
          tma_load(smem_u32(Vs + off), &maps.v[m], full, first, hk, k0, b);
        }
      }
    }
  } else {
    // ---- the consumer warpgroup: 64 query rows ----
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r = warp * 16 + lane / 4;             // rows r, r + 8 of 64
    const int cq = 2 * (lane % 4);                  // columns 8 j + cq, + 1
    const long long pos0 = qpos_lo + r;
    // a tile needs the mask if a key lies beyond S, after some row's
    // position (causal) or a window or more before some row's (window)
    auto need_mask = [&](int k0) {
      return k0 + kBK > S || (causal && k0 + kBK - 1 > qpos_lo) ||
             (window > 0 && qpos_lo + kBQ - 1 - k0 >= window);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    float corr[2];
    uint32_t pa[kBK / 4];              // bf16 P of the tile in P·V

    // The accumulator and P are written only while no product is in
    // flight (ptxas serialises the products otherwise).
    mbar_wait(q_bar, 0);
    float sc[kBK / 2];                 // scores of the newest tile, then its P
    {
      const int k0 = kt_first * kBK;
      mbar_wait(bar0, 0);
      wgmma_fence();
      issue_qk<D>(sc, Qs, Ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, m_run, l_run, corr, need_mask(k0), k0, pos0, cq, S,
                   causal, window, scale);
    }
    for (int i = 1; i <= n_tiles; ++i) {
      const int sp = (i - 1) % kStages;
      // O to tile i - 1's max; P of tile i - 1 to bf16
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      pack_p(sc, pa);
      fence_regs(o);
      fence_regs(pa);
      if (i == n_tiles) {              // the last P·V
        wgmma_fence();
        issue_pv<D>(o, pa, Vs + sp * C::kTileBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(bar0 + 8 * (kStages + sp));
        break;
      }
      const int s = i % kStages;
      const int k0 = (kt_first + i) * kBK;
      mbar_wait(bar0 + 8 * s, (i / kStages) & 1);
      wgmma_fence();
      issue_qk<D>(sc, Qs, Ks + s * C::kTileBytes);
      wgmma_commit();
      issue_pv<D>(o, pa, Vs + sp * C::kTileBytes);
      wgmma_commit();
      wgmma_wait<1>();                 // S of tile i
      fence_regs(sc);
      softmax_tile(sc, m_run, l_run, corr, need_mask(k0), k0, pos0, cq, S,
                   causal, window, scale);
      wgmma_wait<0>();                 // P·V of tile i - 1
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(bar0 + 8 * (kStages + sp));      // its stage is free
    }

    // epilogue: the row sums over the quad, acc / max(l, 1e-30) to bf16
    float l_fin[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float l = l_run[u];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_fin[u] = fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = q0 + r + 8 * u;
      if (t >= T_) continue;
      __nv_bfloat16* orow = out + (((long long)b * T_ + t) * H + h) * D + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            __fdiv_rn(o[4 * j + 2 * u], l_fin[u]),
            __fdiv_rn(o[4 * j + 2 * u + 1], l_fin[u]));
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = v;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor (B, len, heads, D), contiguous, as a 4-D map with a box of
// (cols columns, 1 head, rows, 1 batch), swizzled at the box's width (cols
// 64, 32 or 16: 128, 64 or 32 bytes); rows beyond len read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B,
              int len, int heads, int D, int rows, int cols) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)len * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T_, int S, int H, int Hkv, int causal, int window,
           long long q_offset, float scale, cudaStream_t st) {
  using C = Cfg<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -3;
  Maps maps{};
  for (int i = 0; i < (C::kW1 > 0 ? 2 : 1); ++i) {
    const int w = i == 0 ? C::kW0 : C::kW1;
    if (!make_map(encode, &maps.q[i], q, B, T_, H, D, kBQ, w) ||
        !make_map(encode, &maps.k[i], k, B, S, Hkv, D, kBK, w) ||
        !make_map(encode, &maps.v[i], v, B, S, Hkv, D, kBK, w))
      return -2;
  }
  constexpr int bytes = C::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)((T_ + kBQ - 1) / kBQ) * B * H;
  flash_wgmma_kernel<D><<<(unsigned)grid, kThreads, bytes, st>>>(
      maps, static_cast<__nv_bfloat16*>(out), B, T_, S, H, Hkv, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, T, H, D); k, v: (B, S, Hkv, D); out: (B, T, H, D); all bf16,
// contiguous, 16-byte aligned.  D in {16, 32, 64, 80, 128}, H % Hkv == 0,
// T, S >= 1, q_offset >= 0 and every query row holding at least one valid
// key are the caller's to guarantee.  Returns cudaGetLastError() after the
// launch (0 = launched), -1 for a head_dim outside the set, -2 if a tensor
// map could not be encoded, -3 if cuTensorMapEncodeTiled is not available.
extern "C" int venn_flash_attention_wgmma(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int T_, int S, int H, int Hkv,
                                          int D, int causal, int window,
                                          long long q_offset, float scale,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, out, B, T_, S, H, Hkv, causal, window,
                               q_offset, scale, st);
    case 32: return launch<32>(q, k, v, out, B, T_, S, H, Hkv, causal, window,
                               q_offset, scale, st);
    case 64: return launch<64>(q, k, v, out, B, T_, S, H, Hkv, causal, window,
                               q_offset, scale, st);
    case 80: return launch<80>(q, k, v, out, B, T_, S, H, Hkv, causal, window,
                               q_offset, scale, st);
    case 128: return launch<128>(q, k, v, out, B, T_, S, H, Hkv, causal,
                                 window, q_offset, scale, st);
    default: return -1;
  }
}

// Dynamic shared memory a CTA of the kernel takes at this head_dim (bytes),
// or -1 for a head_dim outside the set.
extern "C" int venn_flash_attention_wgmma_smem(int D) {
  switch (D) {
    case 16: return Cfg<16>::kSmem;
    case 32: return Cfg<32>::kSmem;
    case 64: return Cfg<64>::kSmem;
    case 80: return Cfg<80>::kSmem;
    case 128: return Cfg<128>::kSmem;
    default: return -1;
  }
}
