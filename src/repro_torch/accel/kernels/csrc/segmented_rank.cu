// Segmented rank: the replan's intra-group (demand_key, job_id) ordering.
//
//   rank[i] = #{ j : seg[j] == seg[i], seg[j] >= 0,
//                    (key[j], tie[j]) <lex (key[i], tie[i]) }
//
// Keys are float64, compared as float64: the order is the one np.lexsort on
// the f64 keys gives, with no f32 rounding in between.  Ties are the unique
// job ids, so the ranks of a segment are a permutation of 0..len-1.  A
// negative segment id never matches (callers may pad with -1).
//
// Layout: one thread per row i, its (seg, key, tie) in registers; the j axis
// goes through shared memory in tiles of 256, every thread of the block
// reading the same tile entry at a time (a broadcast, no bank conflict), the
// count kept in a register.  n is a few thousand pending jobs at most, so
// the n*n compares are a few million and the inputs (16 bytes a job) sit in
// L2 after the first block has read them.
//
// Bound on an H100: operations (n*n pair compares against 16*n bytes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;

__global__ void segmented_rank_kernel(const int32_t* __restrict__ seg,
                                      const double* __restrict__ key,
                                      const int32_t* __restrict__ tie,
                                      int32_t* __restrict__ rank, int n) {
  __shared__ int32_t s_seg[kTile];
  __shared__ double s_key[kTile];
  __shared__ int32_t s_tie[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  int32_t si = -1;
  double ki = 0.0;
  int32_t ti = 0;
  if (i < n) {
    si = seg[i];
    ki = key[i];
    ti = tie[i];
  }
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      s_seg[threadIdx.x] = seg[j];
      s_key[threadIdx.x] = key[j];
      s_tie[threadIdx.x] = tie[j];
    } else {
      s_seg[threadIdx.x] = -1;
    }
    __syncthreads();
    const int lim = (n - j0 < kTile) ? (n - j0) : kTile;
    for (int t = 0; t < lim; ++t) {
      const int32_t sj = s_seg[t];
      const double kj = s_key[t];
      const bool less = (kj < ki) || (kj == ki && s_tie[t] < ti);
      count += (sj == si && sj >= 0 && less) ? 1 : 0;
    }
    __syncthreads();
  }
  if (i < n) rank[i] = count;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  n > 0 is the
// caller's to guarantee.
extern "C" int venn_segmented_rank(const void* seg, const void* key,
                                   const void* tie, void* rank, int n,
                                   void* stream) {
  const dim3 grid((unsigned)((n + kTile - 1) / kTile)), block(kTile);
  segmented_rank_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seg), static_cast<const double*>(key),
      static_cast<const int32_t*>(tie), static_cast<int32_t*>(rank), n);
  return (int)cudaGetLastError();
}
