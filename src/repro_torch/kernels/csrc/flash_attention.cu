// Flash attention for prefill: causal / sliding-window / bidirectional, GQA.
//
//   out[b, t, h, :] = softmax_s(mask(q[b, t, h, :] · scale · k[b, s, h / G, :]))
//                     · v[b, s, h / G, :]          G = H / Hkv, scale = 1/sqrt(D)
//
// with qpos = q_offset + t, kpos = s, rel = qpos - kpos; causal masks rel < 0,
// a window masks rel >= window.  Masked scores are NEG_INF = -2^30 (not -inf),
// the running softmax is the online one (max m, normaliser l, accumulator acc,
// all f32), and the output is acc / max(l, 1e-30) in the input's type.
//
// Replaces the Pallas-TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_kernel).  On the TPU the KV axis is the minor, sequential
// grid dimension and m, l and acc live in VMEM scratch across its steps.
// Here one CTA owns a (b, h, 64-query tile) and loops over 64-key tiles
// inside the program; nothing carries between CTAs.  KV tiles that are fully
// masked for the whole query tile are skipped (the TPU kernel visits them):
// exact on every row with at least one valid key, since a masked tile after a
// valid one adds exp(NEG_INF - m) = 0 and one before it is wiped by corr = 0.
// A row with no valid key is outside the contract: the wrapper refuses such
// calls.  GQA is by index (query head h reads KV head h / G); K and V are
// never expanded.  Tails of T and S are bounds-checked, never padded by a
// copy: out-of-range keys are masked and their V rows zero-filled in shared
// memory; out-of-range query rows are computed on zeros and not stored.
//
// Design (a first, simple kernel: FMA units, no tensor cores, no TMA): 128
// threads, thread (ty, tx) = (tid / 8, tid % 8).  Q (pre-scaled), K, V and the
// probabilities P are staged in shared memory as f32 with rows padded by 4
// floats, so every 16-byte read below is free of bank conflicts.  A thread
// holds a 4 x 8 register tile of the 64 x 64 score tile (rows ty + 16 i,
// columns tx + 8 j) and a 4 x D/8 tile of the output (rows ty + 16 i,
// columns tx * D/8 ...): 12 16-byte shared reads feed 128 FMAs in Q·K^T.
// Row max and row sum reduce over the 8 lanes of a row group by xor
// shuffles.  exp is expf (full precision; the build has no fast math).
//
// Bound on an H100: operations.  At the serve shape (B 4, T = S = 1024, H 32,
// Hkv 8, D 64, causal, bf16) the causal pairs need 4·B·H·D·T(T+1)/2 = 17.2
// GFLOP, 17.4 µs at the 989 TFLOP/s of bf16 tensor cores, against 42 MB of
// q, k, v and out, 12.5 µs at 3.35 TB/s.  On FMA units (67 TFLOP/s f32) this
// kernel cannot beat 0.26 ms; bf16 calls go to the tensor-core kernel
// (flash_attention_wgmma.cu), and this one is the f32 route.
//
// Indices into q, k, v and out are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows a CTA
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 128;      // 16 row groups x 8 lanes
constexpr int kPad = 4;            // floats of padding per shared row
constexpr float kNegInf = -1073741824.0f;   // -2^30

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Copy `rows` rows of D elements (row r at src + r * stride) into shared
// memory as f32 times `mul`, rows at dst + r * (D + kPad); rows at or beyond
// `valid` are zero-filled.  16-byte global loads: 4 f32 or 8 bf16.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long stride, int rows, int valid,
                                      float mul) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;           // 16-byte chunks a row
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d0 = (c % kChunks) * kVec;
    float* o = dst + r * (D + kPad) + d0;
    if (r < valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (long long)r * stride + d0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = __fmul_rn(to_f32(e[i]), mul);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int T_, int S,
             int H, int Hkv, bool causal, int window, long long q_offset,
             float scale) {
  constexpr int kCols = D / 8;                 // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                            // [kBQ][D + kPad]
  float* Ks = Qs + kBQ * (D + kPad);           // [kBK][D + kPad]
  float* Vs = Ks + kBK * (D + kPad);           // [kBK][D + kPad]
  float* Ps = Vs + kBK * (D + kPad);           // [kBQ][kBK + kPad]

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  // heaviest causal tiles (the last) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, T_ - q0);

  const long long q_stride = (long long)H * D;        // between t and t + 1
  const long long kv_stride = (long long)Hkv * D;
  const T* qb = q + (((long long)b * T_ + q0) * H + h) * D;
  const T* kb = k + ((long long)b * S * Hkv + hk) * D;
  const T* vb = v + ((long long)b * S * Hkv + hk) * D;

  stage<T, D>(Qs, qb, q_stride, kBQ, q_rows, scale);

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

  float m_run[4], l_run[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int n = 0; n < kCols; ++n) acc[i][n] = 0.f;
  }

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kBK;
    const int k_rows = min(kBK, S - k0);
    __syncthreads();                 // the previous tile's readers are done
    stage<T, D>(Ks, kb + (long long)k0 * kv_stride, kv_stride, kBK, k_rows,
                1.f);
    stage<T, D>(Vs, vb + (long long)k0 * kv_stride, kv_stride, kBK, k_rows,
                1.f);
    __syncthreads();

    // scores: s[i][j] = Q[ty + 16 i] · K[tx + 8 j]
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * (D + kPad) + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        c[j] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * (D + kPad) + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = qpos_lo + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const long long rel = qpos - kpos;
        bool ok = kpos < S;
        if (causal) ok = ok && rel >= 0;
        if (window > 0) ok = ok && rel < window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float corr = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * (kBK + kPad) + tx + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int n = 0; n < kCols; ++n) acc[i][n] *= corr;
    }
    __syncthreads();

    // acc[i][n] += P[ty + 16 i][:] · V[:, tx * kCols + n]
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * (kBK + kPad) + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = Vs + (j + jj) * (D + kPad) + tx * kCols;
        float vv[kCols];
        if constexpr (kCols % 4 == 0) {
#pragma unroll
          for (int n = 0; n < kCols; n += 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(vr + n);
            vv[n] = t4.x; vv[n + 1] = t4.y; vv[n + 2] = t4.z; vv[n + 3] = t4.w;
          }
        } else {
#pragma unroll
          for (int n = 0; n < kCols; n += 2) {
            const float2 t2 = *reinterpret_cast<const float2*>(vr + n);
            vv[n] = t2.x; vv[n + 1] = t2.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = jj == 0 ? p[i].x : jj == 1 ? p[i].y
                          : jj == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int n = 0; n < kCols; ++n) acc[i][n] = fmaf(pij, vv[n], acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    T* o = out + (((long long)b * T_ + q0 + r) * H + h) * D + tx * kCols;
#pragma unroll
    for (int n = 0; n < kCols; ++n) put(o + n, __fdiv_rn(acc[i][n], l));
  }
}

template <int D>
constexpr int smem_bytes() {
  return (kBQ * (D + kPad) + 2 * kBK * (D + kPad) + kBQ * (kBK + kPad)) *
         (int)sizeof(float);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T_, int S, int H, int Hkv, int causal, int window,
           long long q_offset, float scale, cudaStream_t st) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_ + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, D><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), T_, S, H, Hkv,
      causal != 0, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int T_, int S, int H, int Hkv, int D, int causal, int window,
             long long q_offset, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, T_, S, H, Hkv, causal,
                                  window, q_offset, scale, st);
    case 32: return launch<T, 32>(q, k, v, out, B, T_, S, H, Hkv, causal,
                                  window, q_offset, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, B, T_, S, H, Hkv, causal,
                                  window, q_offset, scale, st);
    case 80: return launch<T, 80>(q, k, v, out, B, T_, S, H, Hkv, causal,
                                  window, q_offset, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, B, T_, S, H, Hkv, causal,
                                    window, q_offset, scale, st);
    default: return -1;
  }
}

}  // namespace

// q: (B, T, H, D); k, v: (B, S, Hkv, D); out: (B, T, H, D); all contiguous,
// 16-byte aligned, of one type: f32 (bf16 = 0) or bf16 (bf16 = 1).
// D in {16, 32, 64, 80, 128}, H % Hkv == 0, T, S >= 1, q_offset >= 0 and every
// query row holding at least one valid key are the caller's to guarantee.
// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// head_dim outside the set.
extern "C" int venn_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int B, int T_,
                                    int S, int H, int Hkv, int D, int causal,
                                    int window, long long q_offset,
                                    float scale, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, T_, S, H, Hkv, D, causal,
                                   window, q_offset, scale, st);
  return dispatch<float>(q, k, v, out, B, T_, S, H, Hkv, D, causal, window,
                         q_offset, scale, st);
}
