// Masked first-fit: the inner step of the batched check-in matcher.
//
//   kidx[i] = min { k : elig[i,k] != 0  and  fillpos(i,k) >= pos[i] },  else K
//
// Two forms of fillpos, one kernel template:
//   GATHER = false   fillpos(i,k) = cand[i,k]            (the (elig, fillcand,
//                    pos) contract of the TPU kernel, which cannot gather)
//   GATHER = true    fillpos(i,k) = fill[cand[i,k]]      (what the matcher
//                    launches: cand holds request indices, fill is the (R,)
//                    fill-position vector; the (n,K) fillcand matrix is never
//                    materialised).  This form also writes
//                    choice[i] = cand[i,kidx[i]] (or -1), saving the caller a
//                    clamp + gather + select per fixed-point round.
//
// Layout: one warp per row, lane k reads column k0+k — 32 consecutive bytes of
// elig and, where eligible, 32 consecutive ints of cand, so a row's reads
// coalesce.  K is a run-time value (the candidate cap widens while a run
// goes on): columns are walked 32 at a time and the walk stops at the first
// group with a hit (__ballot_sync + __ffs gives the lowest lane).  fill is a
// few thousand ints and stays in L2/L1.
//
// Bound on an H100: bytes.  At n = 16384, K = 32 it reads 0.5 MB of elig
// (uint8), up to 2 MB of cand, 64 KB of pos and writes 128 KB: under 1 us at
// 3.35 TB/s, so launch latency, not bandwidth, is what a caller sees.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool GATHER>
__global__ void masked_first_fit_kernel(const uint8_t* __restrict__ elig,
                                        const int32_t* __restrict__ cand,
                                        const int32_t* __restrict__ fill,
                                        const int32_t* __restrict__ pos,
                                        int32_t* __restrict__ kidx,
                                        int32_t* __restrict__ choice,
                                        int n, int K, int R) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together
  const int p = pos[row];
  const size_t base = (size_t)row * (size_t)K;
  int found = K;
  int picked = -1;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    bool avail = false;
    int c = -1;
    if (k < K && elig[base + k] != 0) {
      c = cand[base + k];
      if (GATHER) {
        avail = (c >= 0 && c < R) && fill[c] >= p;
      } else {
        avail = c >= p;
      }
    }
    const unsigned hits = __ballot_sync(0xffffffffu, avail);
    if (hits != 0u) {  // uniform across the warp
      const int first = __ffs(hits) - 1;
      found = k0 + first;
      picked = __shfl_sync(0xffffffffu, c, first);
      break;
    }
  }
  if (lane == 0) {
    kidx[row] = found;
    if (GATHER && choice != nullptr) choice[row] = picked;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  `choice` may be
// null; it is written only when gather != 0.  n > 0 and K > 0 are the caller's
// to guarantee (no zero-sized grid).
extern "C" int venn_masked_first_fit(const void* elig, const void* cand,
                                     const void* fill, const void* pos,
                                     void* kidx, void* choice, int n, int K,
                                     int R, int gather, void* stream) {
  const unsigned blocks = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 grid(blocks), block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gather) {
    masked_first_fit_kernel<true><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(elig), static_cast<const int32_t*>(cand),
        static_cast<const int32_t*>(fill), static_cast<const int32_t*>(pos),
        static_cast<int32_t*>(kidx), static_cast<int32_t*>(choice), n, K, R);
  } else {
    masked_first_fit_kernel<false><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(elig), static_cast<const int32_t*>(cand),
        nullptr, static_cast<const int32_t*>(pos),
        static_cast<int32_t*>(kidx), nullptr, n, K, R);
  }
  return (int)cudaGetLastError();
}
