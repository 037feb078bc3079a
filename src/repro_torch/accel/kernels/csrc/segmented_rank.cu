// Segmented rank / order: the replan's intra-group (demand_key, job_id)
// ordering.
//
//   rank[i] = #{ j : seg[j] == seg[i], seg[j] >= 0,
//                    (key[j], tie[j]) <lex (key[i], tie[i]) }
//
// Replaces the TPU kernel repro/accel/kernels/replan_order.py::segmented_rank
// (its _kernel, and segmented_order's bincount + cumsum + scatter around it).
// Keys are float64, compared as float64: the order is the one np.lexsort on
// the f64 keys gives, with no f32 rounding in between.  Ties are the unique
// job ids, so the ranks of a segment are a permutation of 0..len-1.
//
// Two entry points, one kernel template:
//   venn_segmented_rank   the reference's contract: any seg ids, a negative
//                         id never matches (callers may pad with -1).
//   venn_segmented_order  seg sorted ascending (or null: one segment).  A row
//                         finds its segment's [lo, hi) by binary search,
//                         compares only inside it, and writes
//                         perm[lo + rank[i]] = i in the same launch.
//
// Layout: a warp per row i, the row's (seg, key, tie) in registers; the j
// axis goes through shared memory in tiles of 1024 shared by the block's 8
// warps (8 consecutive rows; for the order form the block streams only the
// union of its rows' segments), each thread loading 4 entries of a tile with
// the loads in flight together, the lanes striding over the tile; the count
// is summed with __reduce_add_sync.  At n = 2000 that is 2000 warps in 250
// blocks on the 132 SMs, two tiles a block, each lane doing ~63 compares,
// where a thread a row walked all 2000 columns in a dependent chain.
//
// Bound on an H100: operations (n*n pair compares, one segment, against
// 16*n bytes); at n = 2000 both are far under a launch's latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPerThread = 4;                 // tile entries a thread loads
constexpr int kTile = kThreads * kPerThread;
constexpr unsigned kFull = 0xffffffffu;

// first index in the sorted seg[0, n) whose value is >= v (strict: > v)
__device__ __forceinline__ int bound(const int32_t* seg, int n, int32_t v,
                                     bool strict) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t s = seg[mid];
    if (s < v || (strict && s == v)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool ORDER>
__global__ void __launch_bounds__(kThreads)
segmented_rank_kernel(const int32_t* __restrict__ seg,
                      const double* __restrict__ key,
                      const int32_t* __restrict__ tie,
                      int32_t* __restrict__ out, int n) {
  __shared__ int32_t s_seg[kTile];
  __shared__ double s_key[kTile];
  __shared__ int32_t s_tie[kTile];
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kWarps;
  const int i = row0 + (threadIdx.x >> 5);
  const int ic = i < n ? i : n - 1;  // rows past the end load a real row
  const int32_t si = seg != nullptr ? seg[ic] : 0;
  const double ki = key[ic];
  const int32_t ti = tie[ic];
  // [lo, hi): the j this row compares with; [blo, bhi): the block's union
  int lo = 0, hi = n, blo = 0, bhi = n;
  if (ORDER && seg != nullptr) {
    lo = bound(seg, n, si, false);
    hi = bound(seg, n, si, true);
    const int last = (row0 + kWarps < n ? row0 + kWarps : n) - 1;
    blo = bound(seg, n, seg[row0], false);
    bhi = bound(seg, n, seg[last], true);
  }
  int count = 0;
  for (int j0 = blo; j0 < bhi; j0 += kTile) {
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {  // independent loads, in flight
      const int t = threadIdx.x + m * kThreads;  // together
      if (j0 + t < bhi) {
        if (!ORDER) s_seg[t] = seg[j0 + t];
        s_key[t] = key[j0 + t];
        s_tie[t] = tie[j0 + t];
      }
    }
    __syncthreads();
    const int lim = bhi - j0 < kTile ? bhi - j0 : kTile;
    for (int t = lane; t < lim; t += 32) {
      const bool same = ORDER ? (j0 + t >= lo && j0 + t < hi)
                              : (s_seg[t] == si && si >= 0);
      const double kj = s_key[t];
      const bool less = kj < ki || (kj == ki && s_tie[t] < ti);
      count += (same && less) ? 1 : 0;
    }
    __syncthreads();
  }
  count = (int)__reduce_add_sync(kFull, (unsigned)count);
  if (i < n && lane == 0) {
    if (ORDER) {
      out[lo + count] = i;  // count <= hi - lo - 1: always in bounds
    } else {
      out[i] = count;
    }
  }
}

unsigned blocks_for(int n) { return (unsigned)((n + kWarps - 1) / kWarps); }

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched) unless
// said otherwise.  n > 0 is the caller's to guarantee.
extern "C" int venn_segmented_rank(const void* seg, const void* key,
                                   const void* tie, void* rank, int n,
                                   void* stream) {
  segmented_rank_kernel<false>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(seg), static_cast<const double*>(key),
          static_cast<const int32_t*>(tie), static_cast<int32_t*>(rank), n);
  return (int)cudaGetLastError();
}

// `seg` sorted ascending, or null for one segment.  The entry zero-fills
// `perm` before the launch (NaN keys rank no permutation, and unwritten
// slots must still be valid indices).  With `host_in` (pinned) it is the
// whole resort: `in_bytes` go up from `host_in` to `dev_in` first (key and
// tie point into it), and with `host_out` (pinned) the permutation comes
// down after the launch, followed by a synchronise of the stream; then the
// return value covers the copies and the run too.
extern "C" int venn_segmented_order(const void* seg, const void* key,
                                    const void* tie, void* perm, int n,
                                    const void* host_in, void* dev_in,
                                    size_t in_bytes, void* host_out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (host_in != nullptr) {
    e = cudaMemcpyAsync(dev_in, host_in, in_bytes, cudaMemcpyHostToDevice, s);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaMemsetAsync(perm, 0, sizeof(int32_t) * (size_t)n, s);
  if (e != cudaSuccess) return (int)e;
  segmented_rank_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(seg), static_cast<const double*>(key),
      static_cast<const int32_t*>(tie), static_cast<int32_t*>(perm), n);
  e = cudaGetLastError();
  if (e != cudaSuccess || host_out == nullptr) return (int)e;
  e = cudaMemcpyAsync(host_out, perm, sizeof(int32_t) * (size_t)n,
                      cudaMemcpyDeviceToHost, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamSynchronize(s);
}
