// A count over the learned intervals of a chunk of partitions, balanced
// over the positions: the scan shared by range_filter.cu and
// circle_filter.cu.
//
// What is counted: per (query q, partition c) pair i = c * nq + q, the
// positions p in [max(s, 0), min(e, count[c], n_pad)) whose point
// (x[c, p], y[c, p]) passes the pair's test; an inactive pair counts 0.
// `Test` is a plain struct: load(q) reads query q's parameters, and
// operator()(x, y) tests one point.
//
// Why balanced: interval lengths are heavily skewed (at 1,024 range
// queries over 2^23 taxi points: median 2,436 positions, largest 65,302),
// so a warp per pair left the launch waiting on its longest interval.
// Here the positions of all the chunk's intervals are laid end to end
// (pair i owns [off_i, off_i + len_i), off the exclusive scan of the
// lengths) and cut into one equal share per block: block b takes
// [b S, (b + 1) S), S = ceil(T / grid), T the total.
//
// One cooperative launch of one 1,024-thread block per SM, in two phases
// around one grid barrier (the launch holds every block at once, so the
// barrier cannot wait on a block that never runs):
//   1. block b zeroes the outputs of its slice of ceil(n / grid) pairs
//      and publishes the slice's total length;
//   2. every block scans the slice totals, takes its share, and scans
//      only the pairs of the slices that hold it, in tiles of kTile,
//      keeping per pair its end in the share and the flat index of its
//      first point there in shared memory. The threads stride over the
//      share's positions, kUnroll at a time (neighbouring threads read
//      neighbouring coordinates, kUnroll loads in flight each), find each
//      position's pair by binary search in the tile's ends, and add their
//      hits to the pair's shared-memory counter; each pair's non-zero
//      count goes to its output with one atomic add per block.
// Integer counts are sums, whatever their order, so the result is the
// warp-per-pair scan's bit for bit.
//
// The grid is the SM count, never a function of the intervals, which lie
// on the card: the launcher reads nothing back. Launches of one instance
// must not overlap (they share the barrier's counters): the port launches
// on the current stream, one after the other.
//
// Cost with no positions (an all-empty chunk): phase 1, the barrier and
// the scan of the slice totals.
// Bound: bytes, 8 per position of the union of the intervals.
#pragma once

#include <climits>

#include "common.cuh"

namespace interval_scan {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / kWarp;
constexpr int kPairsPerThread = 2;
constexpr int kTile = kThreads * kPairsPerThread;  // pairs per scanned tile
constexpr int kUnroll = 4;           // positions in flight per thread
constexpr int kMaxBlocks = kThreads;  // phase 2 scans one total per thread
// a barrier that waits this many sleeps (about a second) traps: a launch
// whose blocks were not all resident fails instead of hanging
constexpr long long kMaxSpins = 1LL << 24;

// per instance and device: the grid barrier (blocks arrived, releases so
// far) and each slice's total length
__device__ unsigned g_arrived;
__device__ unsigned g_generation;
__device__ long long g_slice[kMaxBlocks];

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery, "Division by invariant integers using multiplication",
// 1994): the scans divide each pair index by nq
struct FastDiv {
  unsigned m;
  int l;

  static FastDiv of(int d) {  // d >= 1
    int l = 0;
    while ((1LL << l) < d) ++l;
    const unsigned long long dd = static_cast<unsigned long long>(d);
    return {static_cast<unsigned>((1ULL << 32) * ((1ULL << l) - dd) / dd +
                                  1),
            l};
  }

  __device__ __forceinline__ int operator()(int n) const {
    const unsigned u = static_cast<unsigned>(n);
    return static_cast<int>((__umulhi(m, u) + u) >> l);
  }
};

// the chunk's learned intervals
struct Pairs {
  const int* s;
  const int* e;
  const unsigned char* active;
  const int* count;
  int nq, n_pad, n;  // n = partitions * nq
  FastDiv by_nq;

  // pair i's positions [lo, lo + len): len 0 past the end, or inactive
  __device__ __forceinline__ int len(int i, int& lo) const {
    lo = 0;
    if (i >= n) return 0;
    const int c = by_nq(i);
    lo = max(__ldg(s + i), 0);
    const int hi = min(min(__ldg(e + i), __ldg(count + c)), n_pad);
    return __ldg(active + i) ? max(hi - lo, 0) : 0;
  }
};

// inclusive scan over the warp
__device__ __forceinline__ long long warp_scan(long long v) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const long long t = __shfl_up_sync(kFullMask, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// exclusive scan of one value per thread over the block; `total` gets
// the sum. Every thread of the block must call it.
__device__ __forceinline__ long long block_scan(long long v,
                                                long long* s_warp,
                                                long long& total) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long incl = warp_scan(v);
  if (lane == kWarp - 1) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) s_warp[lane] = warp_scan(s_warp[lane]);  // kWarps == kWarp
  __syncthreads();
  const long long before = warp > 0 ? s_warp[warp - 1] : 0;
  total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is free again
  return before + incl - v;
}

// Every block of the (cooperative) launch waits here until all have
// arrived; their writes before it are then visible to all. `gen0` is
// g_generation as thread 0 read it on entry: the barrier releases by
// raising it, after the last block to arrive has reset g_arrived.
__device__ __forceinline__ void grid_barrier(unsigned gen0) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&g_arrived, 1u) == gridDim.x - 1) {
      atomicExch(&g_arrived, 0u);
      __threadfence();
      atomicAdd(&g_generation, 1u);
    } else {
      long long spins = 0;
      while (*static_cast<volatile unsigned*>(&g_generation) == gen0) {
        if (++spins > kMaxSpins) __trap();
        __nanosleep(64);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// A tile's pairs are warp-striped: lane l of warp w holds pairs
// w * kWarp * kPairsPerThread + k * kWarp + l, so loads are coalesced,
// shared memory is read and written without bank conflicts, and a
// warp's pairs are consecutive for the scan.
__device__ __forceinline__ int tile_pair(int k) {
  return (threadIdx.x / kWarp) * kWarp * kPairsPerThread + k * kWarp +
         threadIdx.x % kWarp;
}

// first j in [lo, hi) with end[j] > v, or hi
template <typename T>
__device__ __forceinline__ int upper_bound(const T* end, int lo, int hi,
                                           T v) {
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (end[mid] > v)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

template <class Test>
__global__ void __launch_bounds__(kThreads, 1) interval_count_kernel(
    Test test, Pairs pr, const float* __restrict__ x,
    const float* __restrict__ y, int* __restrict__ out) {
  static_assert(kWarps == kWarp, "block_scan scans the warp sums in a warp");
  __shared__ int s_end[kTile];    // pair's end in the share, from its start
  __shared__ int s_first[kTile];  // flat index of the share's offset 0
  __shared__ int s_cnt[kTile];    // hits in the share
  __shared__ long long s_soff[kMaxBlocks + 1];  // slice offsets
  __shared__ long long s_warp[kWarps];
  const int tid = threadIdx.x;
  const int b = blockIdx.x, grid = gridDim.x;
  const int n = pr.n;
  // (read before this block arrives, so before the barrier can release)
  const unsigned gen0 =
      tid == 0 ? *static_cast<volatile unsigned*>(&g_generation) : 0;

  // 1. this block's slice of pairs [p0, p1): zeros and total length
  const int per = (n + grid - 1) / grid;
  const int p0 = min(b * per, n), p1 = min(p0 + per, n);
  long long mine = 0;
  for (int i = p0 + tid; i < p1; i += kThreads) {
    int lo;
    mine += pr.len(i, lo);
    out[i] = 0;
  }
  long long slice;
  block_scan(mine, s_warp, slice);
  if (tid == 0) g_slice[b] = slice;
  grid_barrier(gen0);

  // 2. the slices' offsets, this block's share [a, z), and the pairs of
  // the slices that hold it
  long long total;
  const long long soff = block_scan(tid < grid ? __ldcg(g_slice + tid) : 0,
                                    s_warp, total);
  if (tid < grid) s_soff[tid] = soff;
  if (tid == 0) s_soff[grid] = total;
  __syncthreads();
  const long long share = (total + grid - 1) / grid;
  const long long a = min(static_cast<long long>(b) * share, total);
  const long long z = min(a + share, total);
  const int width = static_cast<int>(z - a);  // the launcher bounds it
  if (a == z) return;
  const int first_slice = upper_bound(s_soff + 1, 0, grid, a);
  const int last_slice = upper_bound(s_soff, first_slice, grid, z - 1) - 1;
  const int q1 = min((last_slice + 1) * per, n);
  long long base = s_soff[first_slice];  // offset of the tile's first pair
  for (int t0 = first_slice * per; t0 < q1 && base < z; t0 += kTile) {
    int len[kPairsPerThread], lo[kPairsPerThread];
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      const int i = t0 + tile_pair(k);
      lo[k] = 0;
      len[k] = i < q1 ? pr.len(i, lo[k]) : 0;
      sum += len[k];
    }
    // the warp's first offset; then row by row within the warp
    sum = __shfl_sync(kFullMask, warp_scan(sum), kWarp - 1);
    long long tile_total;
    long long run = base + __shfl_sync(
        kFullMask, block_scan(tid % kWarp == 0 ? sum : 0, s_warp, tile_total),
        0);
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      const int j = tile_pair(k), i = t0 + j;
      const long long incl = warp_scan(len[k]);
      const long long off = run + incl - len[k];
      run += __shfl_sync(kFullMask, incl, kWarp - 1);
      // the flat index of share offset 0 (it fits an int for the pairs
      // that hold share positions, the only ones it is read for)
      s_first[j] = static_cast<int>(
          static_cast<long long>(len[k] ? pr.by_nq(i) : 0) * pr.n_pad +
          lo[k] + (a - off));
      s_end[j] = static_cast<int>(
          max(min(off + len[k] - a, static_cast<long long>(width)), 0LL));
      s_cnt[j] = 0;
    }
    __syncthreads();

    // this tile's share positions, from the share's start: [r0, r1)
    const int r0 = static_cast<int>(max(base - a, 0LL));
    const int r1 = static_cast<int>(min(base + tile_total - a,
                                        static_cast<long long>(width)));
    if (r0 < r1) {
      // the tile's pairs that hold them: [jlo, jhi]
      const int jlo = upper_bound(s_end, 0, kTile, r0);
      const int jhi = upper_bound(s_end, jlo, kTile, r1 - 1);
      Test t = test;
      int cur = -1, hits = 0;
      for (int r = r0 + tid; r < r1; r += kThreads * kUnroll) {
        int j[kUnroll];
        float vx[kUnroll], vy[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int ru = r + u * kThreads;
          j[u] = ru < r1 ? upper_bound(s_end, jlo, jhi + 1, ru) : -1;
          if (j[u] >= 0) {
            const int p = s_first[j[u]] + ru;
            vx[u] = __ldg(x + p);
            vy[u] = __ldg(y + p);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j[u] < 0) break;
          if (j[u] != cur) {
            if (hits) atomicAdd(&s_cnt[cur], hits);
            hits = 0;
            cur = j[u];
            const int i = t0 + cur;
            t.load(i - pr.by_nq(i) * pr.nq);
          }
          hits += t(vx[u], vy[u]) ? 1 : 0;
        }
      }
      if (hits) atomicAdd(&s_cnt[cur], hits);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      const int j = tile_pair(k);
      if (s_cnt[j]) atomicAdd(out + t0 + j, s_cnt[j]);
    }
    base += tile_total;
    __syncthreads();
  }
}

// the grid of every launch on the current device: one block per SM
inline int grid_size(int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = sms < kMaxBlocks ? sms : kMaxBlocks;
  return static_cast<int>(err);
}

// Launch on `stream`, cooperatively (every block resident at once, or an
// error). Shapes: s/e/active (n_parts, nq); count (n_parts,); x/y
// (n_parts, n_pad); out (n_parts, nq). Refuses (cudaErrorInvalidValue)
// shapes whose pair indices, flat point indices or shares would not fit
// an int.
template <class Test>
int launch(Test test, const int* s, const int* e,
           const unsigned char* active, const int* count, const float* x,
           const float* y, int nq, int n_pad, int n_parts, int* out,
           void* stream) {
  int blocks = 0;
  const int err = grid_size(&blocks);
  if (err != 0) return err;
  const long long n = static_cast<long long>(nq) * n_parts;
  const long long points = static_cast<long long>(n_parts) * n_pad;
  if (n > INT_MAX - kTile || points > INT_MAX ||
      n * n_pad / blocks > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Pairs pr{s, e, active, count, nq, n_pad, static_cast<int>(n),
           FastDiv::of(nq)};
  void* args[] = {&test, &pr, &x, &y, &out};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&interval_count_kernel<Test>), blocks,
      kThreads, args, 0, static_cast<cudaStream_t>(stream)));
}

}  // namespace interval_scan
