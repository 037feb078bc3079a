// The batched check-in matcher's whole fill-position fixed point for one
// segment, in one launch.
//
// Replaces, on the matcher's path, the host-driven loop around the TPU kernel
// repro/accel/kernels/schedule_match.py::masked_first_fit: the reference runs
// the fixed point as one jitted lax.while_loop with the Pallas first-fit
// inside (repro/accel/_jax_impl.py::_match_jax); this is its counterpart on
// the card.  It computes what match_chunk_torch + match_fixed_point compute:
//
//   rows      row(i) = start + (live ? live[i] : i), i < n;  a = ids[row(i)]
//   elig      cand_req[a,k] >= 0  and  cand_lo[a,k] <= sp  and  sp < cand_hi[a,k]
//             (f64 compares, sp = speeds[row(i)])
//   fill      fill[r] = n where rem[r] > 0, else -1
//   round     choice[i] = cand_req[a, first k: elig and fill[cand_req[a,k]] >= i]
//                         or -1;
//             rank[i]   = #{ j < i : choice[j] == choice[i] }  (stable order)
//             new[r]    = the position i with choice[i] == r and
//                         rank[i] == rem[r] - 1, else n (rem > 0) / -1
//   repeat    until new == fill, at most R + 2 rounds
//   out       choice[n], granted[n] = (choice >= 0 and rank < rem[choice]),
//             rounds (the round at which new == fill), settled (0 / 1)
//
// Design: the segments the drain hands over are small (2 rows a call on
// average on a sparse workload, 78 on a dense one), so what a call costs is
// launches and host syncs, not bandwidth.  One CTA owns the segment and loops
// over the rounds itself; nothing returns to the host between rounds, and
// convergence is a block-wide vote (__syncthreads_or).
//
// * The eligibility mask is round-invariant: a prologue computes it once, a
//   warp per row, as one 32-bit ballot word per 32 candidate columns, and
//   keeps each row's atom id beside it.  The f64 band tables are read once.
// * First-fit: a warp per row, 32 columns at a time, for any run-time K; a
//   group whose mask word is 0 is skipped without a load; lanes of eligible
//   columns gather fill[cand_req] and __ballot_sync + __ffs picks the lowest.
// * Rank: rows go through a tile of blockDim positions at a time, in order.
//   A row's rank = the running count of its request before the tile + the
//   rows of its warp before it with the same request (__match_any_sync) +
//   those of earlier warps of the tile (a compare-count over the tile's keys
//   in shared memory, broadcast reads).  The last term only decides
//   anything when the request's rem - 1 lies within reach; a warp whose rows
//   need no exact rank skips the count.  The running counts advance by
//   shared-memory atomics after the tile (a sum: order does not matter).
// * State: fill, new, the running counts and rem (4 R ints), and the rows'
//   atom ids, choices and mask words (n (W + 2) ints, W = ceil(K / 32)).  Each of the
//   two regions lies in dynamic shared memory when it fits, else in a global
//   scratch buffer (it stays in L2); the wrapper decides, the pointers are
//   generic, so the code is one.
//
// Big segments (the wrapper's GRID_ROWS) take a second route, a cooperative
// grid of up to one CTA a 1024-row tile: a CTA runs first-fit for its
// tiles' rows and adds their choices to per-tile request counts (atomics,
// two buffers by round parity); after a grid barrier a row's rank is the
// counts of the earlier tiles + the same tile-local terms as above; a third
// barrier decides convergence from a grid-wide flag (three slots, so none
// is reset while a CTA may still read it).  All its state lies in global
// scratch, read back through L2 (__ldcg: L1 is not coherent between SMs).
// One CTA walks its rows a warp at a time: at 16384 rows that is 512 rows a
// warp a round, where the grid gives each warp 32.
//
// Bound on an H100: neither bytes nor operations; one small CTA's latency.
// The bytes a call must move (the rows' ids and speeds, their candidate
// rows, rem, the outputs) are a few KB for the segments the drain sees.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
// the kernel's static shared memory (s_tile); with the dynamic part it
// decides whether a launch needs the opt-in above 48 KB
constexpr int kStaticSmem = kThreads * (int)sizeof(int32_t);
// dynamic shared memory a launch may ask for; the wrapper plans its layout
// within it (match_segment.SMEM_BYTES in Python)
constexpr int kDynSmemMax = 220 * 1024;

__global__ void __launch_bounds__(kThreads)
match_segment_kernel(const int32_t* __restrict__ cand_req,
                     const double* __restrict__ cand_lo,
                     const double* __restrict__ cand_hi, int K,
                     const int32_t* __restrict__ ids,
                     const double* __restrict__ speeds, int start,
                     const int32_t* __restrict__ live, int n,
                     const int32_t* __restrict__ rem, int R, int32_t* out,
                     int32_t* scratch, int req_in_smem, int row_in_smem) {
  extern __shared__ int32_t dyn[];
  __shared__ int32_t s_tile[kThreads];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int W = (K + 31) >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  int32_t* req = req_in_smem ? dyn : scratch;
  int32_t* rowb = row_in_smem ? dyn + (req_in_smem ? 4 * R : 0)
                              : scratch + (req_in_smem ? 0 : 4 * R);
  int32_t* cur = req;
  int32_t* nxt = req + R;
  int32_t* cnt = req + 2 * R;
  int32_t* remv = req + 3 * R;
  int32_t* aid = rowb;
  int32_t* choice = rowb + n;
  uint32_t* bits = reinterpret_cast<uint32_t*>(rowb + 2 * n);

  for (int c = tid; c < R; c += blockDim.x) {
    const int r = rem[c];
    remv[c] = r;
    cur[c] = r > 0 ? n : -1;
  }
  // prologue: the round-invariant eligibility, one ballot word a group
  for (int i = warp; i < n; i += nwarps) {
    const int row = start + (live != nullptr ? live[i] : i);
    const int a = ids[row];
    const double sp = speeds[row];
    if (lane == 0) aid[i] = a;
    const size_t base = (size_t)a * (size_t)K;
    for (int g = 0; g < W; ++g) {
      const int k = (g << 5) + lane;
      bool e = false;
      if (k < K && cand_req[base + k] >= 0) {
        e = cand_lo[base + k] <= sp && sp < cand_hi[base + k];
      }
      const unsigned b = __ballot_sync(kFull, e);
      if (lane == 0) bits[(size_t)i * W + g] = b;
    }
  }
  __syncthreads();

  int rounds = 0;
  int settled = 0;
  for (int it = 1; it <= R + 2; ++it) {
    // 1. first-fit under the current fill positions -> choice
    for (int i = warp; i < n; i += nwarps) {
      const size_t base = (size_t)aid[i] * (size_t)K;
      const uint32_t* rb = bits + (size_t)i * W;
      int pick = -1;
      for (int g = 0; g < W; ++g) {
        const unsigned b = rb[g];
        if (b == 0u) continue;  // uniform across the warp
        bool avail = false;
        int c = -1;
        if ((b >> lane) & 1u) {
          c = cand_req[base + (g << 5) + lane];
          avail = c < R && cur[c] >= i;
        }
        const unsigned hits = __ballot_sync(kFull, avail);
        if (hits != 0u) {
          pick = __shfl_sync(kFull, c, __ffs(hits) - 1);
          break;
        }
      }
      if (lane == 0) choice[i] = pick;
    }
    for (int c = tid; c < R; c += blockDim.x) {
      nxt[c] = remv[c] > 0 ? n : -1;
      cnt[c] = 0;
    }
    __syncthreads();
    // 2. stable per-request ranks, a tile of positions at a time -> the new
    //    fill positions, and granted -> out[n, 2n)
    for (int t0 = 0; t0 < n; t0 += blockDim.x) {
      const int i = t0 + tid;
      const int key = i < n ? choice[i] : -1;
      s_tile[tid] = key;
      __syncthreads();
      const unsigned peers = __match_any_sync(kFull, key);
      int r = 0, lo = 0, granted = 0, need = 0;
      if (key >= 0) {
        r = remv[key];
        lo = cnt[key] + __popc(peers & lanes_below);  // rank >= lo
        granted = lo < r;
        // rank <= lo + 32 * warp: exact only matters when r - 1 is in reach
        need = lo < r && lo + 32 * warp >= r - 1;
      }
      if (__any_sync(kFull, need)) {
        int x = 0;
        for (int j = 0; j < 32 * warp; ++j) x += s_tile[j] == key;
        if (need) {
          const int rank = lo + x;
          granted = rank < r;
          if (rank == r - 1) nxt[key] = i;  // one such row per request
        }
      }
      if (i < n) out[n + i] = granted;
      __syncthreads();
      if (key >= 0) atomicAdd(&cnt[key], 1);
      __syncthreads();
    }
    // 3. settled when no fill position moved
    int changed = 0;
    for (int c = tid; c < R; c += blockDim.x) changed |= nxt[c] != cur[c];
    rounds = it;
    if (!__syncthreads_or(changed)) {
      settled = 1;
      break;
    }
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = tid; i < n; i += blockDim.x) out[i] = choice[i];
  if (tid == 0) {
    out[2 * n] = rounds;
    out[2 * n + 1] = settled;
  }
}

// The grid route: the same function as match_segment_kernel, for big
// segments.  scratch: 4 R ints of request state (cur, nxt), n (W + 2) of
// row state (atom ids, unused, mask words), 2 * tiles * R per-tile counts,
// 3 convergence flags.  choice is written straight into out[0, n).
__global__ void __launch_bounds__(kThreads)
match_segment_grid_kernel(const int32_t* __restrict__ cand_req,
                          const double* __restrict__ cand_lo,
                          const double* __restrict__ cand_hi, int K,
                          const int32_t* __restrict__ ids,
                          const double* __restrict__ speeds, int start,
                          const int32_t* __restrict__ live, int n,
                          const int32_t* __restrict__ rem, int R,
                          int32_t* out, int32_t* scratch) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int32_t s_tile[kThreads];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int W = (K + 31) >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int tiles = (n + kThreads - 1) / kThreads;
  const int gtid = blockIdx.x * blockDim.x + tid;
  const int gthreads = gridDim.x * blockDim.x;
  const size_t tR = (size_t)tiles * (size_t)R;

  int32_t* cur = scratch;
  int32_t* nxt = scratch + R;
  int32_t* aid = scratch + 4 * (size_t)R;
  uint32_t* bits = reinterpret_cast<uint32_t*>(aid + 2 * (size_t)n);
  int32_t* tcnt = aid + (size_t)n * (W + 2);
  int32_t* flag = tcnt + 2 * tR;
  int32_t* choice = out;

  for (int c = gtid; c < R; c += gthreads) cur[c] = rem[c] > 0 ? n : -1;
  for (size_t c = gtid; c < tR; c += gthreads) tcnt[tR + c] = 0;  // round 1
  if (gtid < 3) flag[gtid] = 0;
  // prologue: the round-invariant eligibility of the block's tiles' rows
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int end = min(n, (t + 1) * kThreads);
    for (int i = t * kThreads + warp; i < end; i += nwarps) {
      const int row = start + (live != nullptr ? live[i] : i);
      const int a = ids[row];
      const double sp = speeds[row];
      if (lane == 0) aid[i] = a;
      const size_t base = (size_t)a * (size_t)K;
      for (int g = 0; g < W; ++g) {
        const int k = (g << 5) + lane;
        bool e = false;
        if (k < K && cand_req[base + k] >= 0) {
          e = cand_lo[base + k] <= sp && sp < cand_hi[base + k];
        }
        const unsigned b = __ballot_sync(kFull, e);
        if (lane == 0) bits[(size_t)i * W + g] = b;
      }
    }
  }
  grid.sync();

  int rounds = 0;
  int settled = 0;
  for (int it = 1; it <= R + 2; ++it) {
    int32_t* tc = tcnt + (it & 1) * tR;
    int32_t* tc_next = tcnt + ((it + 1) & 1) * tR;
    // 1. reset the new fill positions, the next round's counts and flag;
    //    first-fit of the block's tiles' rows, their counts by tile
    for (int c = gtid; c < R; c += gthreads) nxt[c] = rem[c] > 0 ? n : -1;
    for (size_t c = gtid; c < tR; c += gthreads) tc_next[c] = 0;
    if (gtid == 0) flag[(it + 1) % 3] = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int end = min(n, (t + 1) * kThreads);
      for (int i = t * kThreads + warp; i < end; i += nwarps) {
        const size_t base = (size_t)aid[i] * (size_t)K;
        const uint32_t* rb = bits + (size_t)i * W;
        int pick = -1;
        for (int g = 0; g < W; ++g) {
          const unsigned b = rb[g];
          if (b == 0u) continue;  // uniform across the warp
          bool avail = false;
          int c = -1;
          if ((b >> lane) & 1u) {
            c = cand_req[base + (g << 5) + lane];
            avail = c < R && __ldcg(cur + c) >= i;
          }
          const unsigned hits = __ballot_sync(kFull, avail);
          if (hits != 0u) {
            pick = __shfl_sync(kFull, c, __ffs(hits) - 1);
            break;
          }
        }
        if (lane == 0) choice[i] = pick;
      }
      __syncthreads();
      const int i = t * kThreads + tid;
      if (i < n && choice[i] >= 0) {
        atomicAdd(tc + (size_t)t * R + choice[i], 1);
      }
    }
    grid.sync();
    // 2. ranks: the earlier tiles' counts + the tile-local terms -> the new
    //    fill positions, and granted -> out[n, 2n)
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int i = t * kThreads + tid;
      const int key = i < n ? choice[i] : -1;
      s_tile[tid] = key;
      __syncthreads();
      const unsigned peers = __match_any_sync(kFull, key);
      int r = 0, lo = 0, granted = 0, need = 0;
      if (key >= 0) {
        int off = 0;
        for (int u = 0; u < t; ++u) off += __ldcg(tc + (size_t)u * R + key);
        r = rem[key];
        lo = off + __popc(peers & lanes_below);  // rank >= lo
        granted = lo < r;
        need = lo < r && lo + 32 * warp >= r - 1;
      }
      if (__any_sync(kFull, need)) {
        int x = 0;
        for (int j = 0; j < 32 * warp; ++j) x += s_tile[j] == key;
        if (need) {
          const int rank = lo + x;
          granted = rank < r;
          if (rank == r - 1) nxt[key] = i;  // one such row per request
        }
      }
      if (i < n) out[n + i] = granted;
      __syncthreads();
    }
    grid.sync();
    // 3. settled when no fill position moved anywhere
    int changed = 0;
    for (int c = gtid; c < R; c += gthreads) {
      changed |= __ldcg(nxt + c) != __ldcg(cur + c);
    }
    if (__syncthreads_or(changed) && tid == 0) atomicOr(flag + it % 3, 1);
    rounds = it;
    grid.sync();
    if (__ldcg(flag + it % 3) == 0) {  // the same answer in every block
      settled = 1;
      break;
    }
    int32_t* sw = cur;
    cur = nxt;
    nxt = sw;
  }
  if (gtid == 0) {
    out[2 * n] = rounds;
    out[2 * n + 1] = settled;
  }
}

}  // namespace

// One call from the host does the whole matcher call on `stream`: copies
// `in_ints` ints (rem, then the n live-row indices when has_live) from the
// pinned `host_in` to `dev_in`, launches the segment's kernel, copies the
// 2 n + 2 ints of `dev_out` to the pinned `host_out`, and synchronises the
// stream.  grid = 0: one CTA of 1024 threads; `smem_bytes` of dynamic shared
// memory hold the regions flagged by req_in_smem (4 R ints) and row_in_smem
// (n (ceil(K/32) + 2) ints), in that order; the other regions lie in
// `scratch`, in the same order.  grid = 1: the cooperative grid, a CTA a
// 1024-row tile up to the CTAs the card holds at once, all state in
// `scratch` (its layout above match_segment_grid_kernel).  n, K, R > 0 are
// the caller's to guarantee.  Returns 0, or the first CUDA error: of a copy,
// of the launch (cudaGetLastError), or of the run (the synchronise).
extern "C" int venn_match_segment(const void* cand_req, const void* cand_lo,
                                  const void* cand_hi, int K, const void* ids,
                                  const void* speeds, int start, int n,
                                  int has_live, int R, const void* host_in,
                                  void* dev_in, void* dev_out, void* host_out,
                                  void* scratch, int smem_bytes,
                                  int req_in_smem, int row_in_smem, int grid,
                                  void* stream) {
  if (smem_bytes < 0 || smem_bytes > kDynSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t in_bytes = sizeof(int32_t) * ((size_t)R + (has_live ? n : 0));
  const size_t out_bytes = sizeof(int32_t) * (2 * (size_t)n + 2);
  cudaError_t e =
      cudaMemcpyAsync(dev_in, host_in, in_bytes, cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const int32_t* rem = static_cast<const int32_t*>(dev_in);
  const int32_t* req = static_cast<const int32_t*>(cand_req);
  const double* lo = static_cast<const double*>(cand_lo);
  const double* hi = static_cast<const double*>(cand_hi);
  const int32_t* aid = static_cast<const int32_t*>(ids);
  const double* sp = static_cast<const double*>(speeds);
  const int32_t* lv = has_live ? rem + R : nullptr;
  int32_t* out = static_cast<int32_t*>(dev_out);
  int32_t* scr = static_cast<int32_t*>(scratch);
  if (grid) {
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, match_segment_grid_kernel, kThreads, 0);
    }
    if (e != cudaSuccess) return (int)e;
    const int tiles = (n + kThreads - 1) / kThreads;
    const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
    if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&req, &lo, &hi, &K, &aid, &sp, &start, &lv,
                    &n, &rem, &R, &out, &scr};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(match_segment_grid_kernel), blocks,
        kThreads, args, 0, s);
    if (e != cudaSuccess) return (int)e;
  } else {
    if (smem_bytes + kStaticSmem > 48 * 1024) {
      // static + dynamic shared memory above 48 KB needs the opt-in, an
      // attribute of the kernel on the current device; setting it again is
      // cheap and keeps this free of global state
      e = cudaFuncSetAttribute(match_segment_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDynSmemMax);
      if (e != cudaSuccess) return (int)e;
    }
    match_segment_kernel<<<1, kThreads, smem_bytes, s>>>(
        req, lo, hi, K, aid, sp, start, lv, n, rem, R, out, scr, req_in_smem,
        row_in_smem);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyAsync(host_out, dev_out, out_bytes, cudaMemcpyDeviceToHost, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamSynchronize(s);
}
