// Int8 symmetric block quantisation of client updates, both directions.
//
//   quantize:    scale[b] = max(absmax(x[b*B : (b+1)*B]) / 127, 1e-12)
//                q[i]     = clip(round_half_even(x[i] / scale[i / B]), -127, 127)
//   dequantize:  out[i]   = (float)q[i] * scale[i / B]        (cast to out's type)
//
// Replaces the Pallas-TPU kernels repro/kernels/quantize.py::quantize
// (_quant_kernel) and ::dequantize (_dequant_kernel).  The TPU kernels reshape
// a tile of rows_per_tile quantisation blocks to (rows, B) in VMEM and reduce
// along lanes.  Here one warp owns one quantisation block (B any multiple of
// 32): it reads the block from device memory, takes |x|'s max with
// __shfl_xor_sync, writes the scale, then reads the block again (from L1/L2,
// it has just been fetched) and writes the codes.  Dequantize is elementwise,
// four elements a thread.
//
// Bit-equality with the reference needs XLA's rules, and the build has no
// --use_fast_math:
//   * the quotient is a true IEEE division (__fdiv_rn), never a multiply by a
//     reciprocal, and absmax / 127 likewise;
//   * rounding is rintf (half to even), never floor(x + 0.5);
//   * NaN propagates as jnp.max / jnp.maximum / jnp.clip propagate it:
//     fmaxf would drop it, so the max is nan_max below; a block that holds a
//     NaN gets scale NaN, every quotient in it is NaN, and a NaN quotient is
//     code 0 (what the reference's cast gives, and what the plain version
//     writes explicitly).
// Dequantize is one IEEE multiply and one rounding (__float2bfloat16_rn for
// bf16), so it is bit-equal as well.
//
// Bound on an H100: bytes.  Quantize reads 4 bytes and writes 1 byte an
// element plus 4 bytes a block: at N = 2^28, B = 256, 1.346 GB, 0.40 ms at
// 3.35 TB/s.  Dequantize moves the same bytes the other way.  Loads are 16
// bytes a lane (float4) when B is a multiple of 128 and x is aligned, so a
// warp reads 512 contiguous bytes per step; codes go out as 4-byte char4.
//
// Indices are 64-bit: N reaches 2^28 and beyond on the path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ signed char code_of(float x, float scale) {
  const float t = rintf(__fdiv_rn(x, scale));
  if (t != t) return 0;                                  // NaN quotient
  return (signed char)fminf(fmaxf(t, -127.f), 127.f);
}

// VEC = 4: lane reads float4 number j at lane*4 + j*128 (B % 128 == 0);
// VEC = 1: lane reads element lane + j*32.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                float* __restrict__ s, long long rows, int B) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;                   // the whole warp leaves together
  const float* xb = x + row * (long long)B;
  signed char* qb = q + row * (long long)B;
  const int steps = B / (32 * VEC);
  float m = 0.f;
  // pass 1: the block's |x| max (L1/L2 keep the block for pass 2)
  for (int j = 0; j < steps; ++j) {
    const int i = j * 32 * VEC + lane * VEC;
    if (VEC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(xb + i);
      m = nan_max(m, nan_max(nan_max(fabsf(v.x), fabsf(v.y)),
                             nan_max(fabsf(v.z), fabsf(v.w))));
    } else {
      m = nan_max(m, fabsf(xb[i]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  float scale = __fdiv_rn(m, 127.f);
  if (scale == scale) scale = fmaxf(scale, 1e-12f);      // NaN stays NaN
  if (lane == 0) s[row] = scale;
  // pass 2: the codes
  for (int j = 0; j < steps; ++j) {
    const int i = j * 32 * VEC + lane * VEC;
    if (VEC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(xb + i);
      char4 c;
      c.x = code_of(v.x, scale);
      c.y = code_of(v.y, scale);
      c.z = code_of(v.z, scale);
      c.w = code_of(v.w, scale);
      *reinterpret_cast<char4*>(qb + i) = c;
    } else {
      qb[i] = code_of(xb[i], scale);
    }
  }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const signed char* __restrict__ q,
                  const float* __restrict__ s, T* __restrict__ out,
                  long long N, int B) {
  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i0 >= N) return;
  if (VEC && i0 + 4 <= N) {
    // B % 4 == 0 here, so the four elements share one block and one scale
    const char4 c = *reinterpret_cast<const char4*>(q + i0);
    const float sc = s[i0 / B];
    put(out + i0 + 0, __fmul_rn((float)c.x, sc));
    put(out + i0 + 1, __fmul_rn((float)c.y, sc));
    put(out + i0 + 2, __fmul_rn((float)c.z, sc));
    put(out + i0 + 3, __fmul_rn((float)c.w, sc));
  } else {
    for (long long i = i0; i < i0 + 4 && i < N; ++i)
      put(out + i, __fmul_rn((float)q[i], s[i / B]));
  }
}

template <typename T>
int launch_dequantize(const void* q, const void* s, void* out, long long N,
                      int B, cudaStream_t st) {
  const long long threads = (N + 3) / 4;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  const bool vec = B % 4 == 0 && (uintptr_t)q % 4 == 0;
  const signed char* qp = static_cast<const signed char*>(q);
  const float* sp = static_cast<const float*>(s);
  T* op = static_cast<T*>(out);
  if (vec)
    dequantize_kernel<T, true><<<blocks, kThreads, 0, st>>>(qp, sp, op, N, B);
  else
    dequantize_kernel<T, false><<<blocks, kThreads, 0, st>>>(qp, sp, op, N, B);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N,) f32; q: (N,) int8; s: (N/B,) f32.  N % B == 0, B % 32 == 0 and
// N > 0 are the caller's to guarantee.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int venn_quantize(const void* x, void* q, void* s, long long N,
                             int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = N / B;
  const unsigned blocks =
      (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const bool vec = B % 128 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)q % 4 == 0;
  const float* xp = static_cast<const float*>(x);
  signed char* qp = static_cast<signed char*>(q);
  float* sp = static_cast<float*>(s);
  if (vec)
    quantize_kernel<4><<<blocks, kThreads, 0, st>>>(xp, qp, sp, rows, B);
  else
    quantize_kernel<1><<<blocks, kThreads, 0, st>>>(xp, qp, sp, rows, B);
  return (int)cudaGetLastError();
}

// q: (N,) int8; s: (N/B,) f32; out: (N,) f32 (out_bf16 = 0) or bf16
// (out_bf16 = 1).  N % B == 0 and N > 0 are the caller's to guarantee; any
// B >= 1 (four elements a thread share one scale load when B % 4 == 0).
extern "C" int venn_dequantize(const void* q, const void* s, void* out,
                               long long N, int B, int out_bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) return launch_dequantize<__nv_bfloat16>(q, s, out, N, B, st);
  return launch_dequantize<float>(q, s, out, N, B, st);
}
