// FedAvg server reduction: the normalised weighted sum of K client updates.
//
//   out[n] = sum_k  w[k] * u[k, n]        (w already normalised, f32)
//
// Replaces the Pallas-TPU kernel repro/kernels/fedavg_reduce.py::fedavg_reduce
// (_kernel).  The TPU kernel walks a (N/bn, K/bk) grid with the client axis
// minor-most and carries an f32 accumulator in VMEM scratch from one grid step
// to the next, after padding u to block multiples.  Blocks of a CUDA grid run
// in no order, so here the client loop lives inside the thread: each thread
// owns kVec consecutive columns, walks k = 0..K-1 accumulating in f32 in
// registers, and writes its columns once.  Nothing is padded (that would copy
// the whole (K, N) matrix); the ragged tail is bounds-checked.
//
// Arithmetic: acc = __fadd_rn(acc, __fmul_rn(w[k], u[k, n])) for k in order,
// starting from 0 — a rounded product, then a rounded sum, never contracted
// into an FMA — which is exactly the plain version's
// `acc = acc + w[k] * u[k].float()`, so the two agree bit for bit.  bf16
// updates are widened exactly and the result is rounded once with
// __float2bfloat16_rn.
//
// Weights are staged through shared memory kWTile at a time (K may be large);
// every thread of a block reaches the barriers, in range or not.
//
// Bound on an H100: bytes.  One sweep of u (K*N elements) and one write of
// out: at K = 8, N = 2^28 f32 that is 9.66 GB, 2.9 ms at 3.35 TB/s.  Loads
// are 16 bytes a thread for f32 (8 for bf16) when N is a multiple of kVec and
// u is aligned, so a warp reads 512 contiguous bytes of a row per step.
//
// Indices are 64-bit: K * N of one llama3.2-1b MLP leaf at K = 8 is 2^31.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;          // columns per thread
constexpr int kWTile = 1024;     // weights staged per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Four consecutive elements of a row, one vector load.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
fedavg_reduce_kernel(const T* __restrict__ u, const float* __restrict__ w,
                     T* __restrict__ out, int K, long long N) {
  __shared__ float sw[kWTile];
  const long long c0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
  const bool full = c0 + kVec <= N;
  float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += kWTile) {
    const int kn = min(kWTile, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kn; i += kThreads) sw[i] = w[k0 + i];
    __syncthreads();
    if (c0 >= N) continue;                 // out of range: barriers only
    for (int kk = 0; kk < kn; ++kk) {
      const float wk = sw[kk];
      const T* row = u + (long long)(k0 + kk) * N + c0;
      float v[kVec];
      if (VEC && full) {
        load4(row, v);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          v[j] = (c0 + j < N) ? to_f(row[j]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(wk, v[j]));
    }
  }
  if (c0 >= N) return;
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (c0 + j < N) store(out + c0 + j, acc[j]);
}

template <typename T>
int launch(const void* u, const void* w, void* out, int K, long long N,
           cudaStream_t s) {
  const long long threads = (N + kVec - 1) / kVec;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  // vector loads need every row start aligned: N a multiple of kVec and u
  // aligned to kVec elements
  const bool vec = (N % kVec == 0) &&
                   ((uintptr_t)u % (kVec * sizeof(T)) == 0);
  const T* up = static_cast<const T*>(u);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  if (vec)
    fedavg_reduce_kernel<T, true><<<blocks, kThreads, 0, s>>>(up, wp, op, K, N);
  else
    fedavg_reduce_kernel<T, false><<<blocks, kThreads, 0, s>>>(up, wp, op, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// u: (K, N) row-major, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); w: (K,) f32,
// already normalised; out: (N,) in u's dtype.  K > 0 and N > 0 are the
// caller's to guarantee (no zero-sized grid).  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int venn_fedavg_reduce(const void* u, const void* w, void* out,
                                  int K, long long N, int is_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(u, w, out, K, N, s);
  return launch<float>(u, w, out, K, N, s);
}
