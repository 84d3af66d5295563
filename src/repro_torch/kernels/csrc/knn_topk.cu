// Exact per-partition kNN: top-k of (-d^2, position) per query.
//
// Replaces the Pallas kernel src/repro/kernels/knn_topk.py (knn_topk,
// _kernel). Per (query, partition): the k smallest squared distances
// over the partition's first `count` points, ordered by distance and,
// among equal distances, by lowest position (lax.top_k's tie order).
// Outputs are -d^2 and the position; slots left empty (count < k) hold
// -3e38 and -1.
//
// What bounds it on this card: operations, five float operations per
// (query, point) pair, against 8 bytes per point that every query of
// the launch shares. In practice the insertions into the k-lists cost
// as much as the distances: each is a chain of warp shuffles and votes.
//
// Design:
//   - Points in shared memory. A block of 16 warps holds 16 x QW
//     queries (QW = 1, 2 or 4, from nq) and one slice of a partition's
//     points, which it copies into shared memory once (cp.async) and
//     every query of the block reads: one 8-byte point per lane serves
//     the warp's QW queries, and the next step's point is read while
//     this step's distances are computed.
//   - A scattered scan order. The rows are in Morton order, which
//     brings a query's neighbours in a run of ever closer points: in
//     position order nearly every point near the query became a new
//     entry. Lane l of step t takes slot (32 t + l) * step mod m (step
//     coprime with m, near m / golden ratio), which spreads every step
//     over the slice and hits 32 different banks; a list then takes
//     about k (1 + ln(points / k)) entries, as in a random order.
//   - Lists in registers, spread over the lanes. A query's k-list is
//     sorted by (d^2, position) and held one entry per lane (J =
//     ceil(k / 32) registers per lane for d^2 and for the position), so
//     no array is indexed at run time and nothing lives in local memory
//     (ptxas -v: 0 bytes of stack and spills for every k <= 32
//     instance).
//   - Reject first. A point is a candidate only when d^2 <= the list's
//     k-th d^2 (a warp-uniform register): one compare per pair, and one
//     vote per step for all QW queries. A step with candidates inserts
//     them one at a time by a warp-wide rank (ballot + __popc) and a
//     shift by shuffle; no lane diverges.
//   - The point axis split across blocks. The launcher cuts each
//     partition into slices so that one launch fills the card in one
//     wave (nq x n_parts alone is 128 warps at the serving shape). Each
//     block writes its k-lists to a scratch buffer and publishes its
//     lists' k-th d^2 (atomicMax on an order-reversed encoding); the
//     last block of a (query block, partition) to finish, counted by an
//     atomic, merges the slices' lists into the output in the same
//     launch, skipping every entry beyond the least published k-th.
//     The merge runs after the wave, on one block, so what it skips
//     comes off the launch's tail: without the skip a launch took 21%
//     longer at 256 queries and 26% at 16 on an H100 (PERF.md §6).
//
// Why the split and the order are exact: positions are unique, so
// (d^2, position) is a strict total order and the top-k is one set in
// one order whatever the slices and the scan order. Every insertion and
// the merge compare (d^2, position) lexicographically, so a tie goes to
// the lower position wherever the slice borders fall; a point past its
// list's k-th (d^2, position) has k points before it and is in no top-k.
// Each slice's k-th d^2 is at least the partition's, so the merge's skip
// is exact whichever of the published values it sees (the counter
// starts at +inf); the atomics' order decides only how much it skips.
//
// The distance is fmaf(dx, dx, dy*dy), the form XLA:CPU contracts
// dx*dx + dy*dy to; every step is an explicit intrinsic so nvcc cannot
// contract it differently. XLA:CPU reads float32 denormals as zero and
// flushes tiny results: dy*dy and the distance (also the value returned)
// are flushed as dist2_ftz (common.cuh) flushes them. Where every dy*dy
// of a point exceeds 2^-126 neither flush can act, so the scan computes
// the plain FMA and recomputes with dist2_ftz only for a point where one
// does not (a branch per point, not per pair); the coordinates and their
// differences are only squared, so they need no flush.
#include <math_constants.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kNeg = -3.0e38f;
constexpr int kWarps = 16;    // warps per block
constexpr int kThreads = kWarps * kWarp;
// points per slice: at most kMaxSlice (the slice's x and y, 96 KB of
// shared memory, two blocks to an SM), at least kMinSlice (each slice
// pays for filling its own list: k (1 + ln(points / k)) insertions)
constexpr int kMaxSlice = 12288;
constexpr int kMinSlice = 4096;
constexpr unsigned kInfBits = 0x7f800000u;

__device__ __forceinline__ bool lex_less(float da, int pa, float db, int pb) {
  return da < db || (da == db && pa < pb);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// waits for every cp.async this thread issued (an implicit commit)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// A k-list spread over the warp: entry j * 32 + lane is (d[j], p[j]) of
// that lane, sorted by (d^2, position); empty entries are (+inf, INT_MAX).
template <int J>
struct WarpList {
  float d[J];
  int p[J];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      d[j] = CUDART_INF_F;
      p[j] = INT_MAX;
    }
  }

  // insert (dn, pn), the same on every lane, which must come before
  // entry k - 1 (row jk, lane lk); the last entry drops out, and (td, tp)
  // becomes the new entry k - 1
  __device__ __forceinline__ void insert(float dn, int pn, int lane, int jk,
                                         int lk, float& td, int& tp) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < J; ++j)
      rank += __popc(__ballot_sync(kFullMask, lex_less(d[j], p[j], dn, pn)));
    float sd[J];
    int sp[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {  // entry i - 1 for every entry i
      sd[j] = __shfl_up_sync(kFullMask, d[j], 1);
      sp[j] = __shfl_up_sync(kFullMask, p[j], 1);
    }
#pragma unroll
    for (int j = J - 1; j > 0; --j) {  // lane 0 takes lane 31 of row j - 1
      const float wd = __shfl_sync(kFullMask, d[j - 1], kWarp - 1);
      const int wp = __shfl_sync(kFullMask, p[j - 1], kWarp - 1);
      if (lane == 0) {
        sd[j] = wd;
        sp[j] = wp;
      }
    }
    // the old entry k - 2, which becomes entry k - 1 unless the new one
    // takes that place (read while the rank is counted)
    float ed = sd[0];
    int ep = sp[0];
#pragma unroll
    for (int j = 1; j < J; ++j)
      if (j == jk) {
        ed = sd[j];
        ep = sp[j];
      }
    ed = __shfl_sync(kFullMask, ed, lk);
    ep = __shfl_sync(kFullMask, ep, lk);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int i = j * kWarp + lane;
      if (i == rank) {
        d[j] = dn;
        p[j] = pn;
      } else if (i > rank) {
        d[j] = sd[j];
        p[j] = sp[j];
      }
    }
    const bool last = rank == jk * kWarp + lk;
    td = last ? dn : ed;
    tp = last ? pn : ep;
  }
};

// An odd step coprime with m (a multiple of 32) near m / golden ratio:
// i -> i * step mod m visits 0..m-1 once each, spread over the range at
// every scale, and the 32 lanes of a warp hit 32 different banks
__device__ int scatter_step(int m) {
  int step = static_cast<int>(0.6180339887f * static_cast<float>(m)) | 1;
  for (;; step += 2) {
    int a = step, b = m;
    while (b) {
      const int t = a % b;
      a = b;
      b = t;
    }
    if (a == 1) return step;
  }
}

template <int J, int QW>
__global__ void __launch_bounds__(kThreads) knn_topk_kernel(
    const float* __restrict__ qx, const float* __restrict__ qy,
    const int* __restrict__ count, const float* __restrict__ x,
    const float* __restrict__ y, int nq, int n_pad, int k, int n_slices,
    int slice_len, float* __restrict__ part_d, int* __restrict__ part_p,
    unsigned* __restrict__ gbest, unsigned* __restrict__ done,
    float* __restrict__ out_neg, int* __restrict__ out_idx) {
  extern __shared__ float s_pts[];  // the slice's x, then its y
  __shared__ int s_last;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int qb = blockIdx.x, slice = blockIdx.y, c = blockIdx.z;
  const int q0 = (qb * kWarps + warp) * QW;  // this warp's first query
  const int jk = (k - 1) / kWarp, lk = (k - 1) % kWarp;
  const int cap = (slice_len + kWarp - 1) / kWarp * kWarp;
  float* s_x = s_pts;
  float* s_y = s_pts + cap;
  const int cnt = min(count[c], n_pad);
  const int p_begin = slice * slice_len;
  const int n = max(min(p_begin + slice_len, cnt) - p_begin, 0);
  const float* px = x + static_cast<size_t>(c) * n_pad + p_begin;
  const float* py = y + static_cast<size_t>(c) * n_pad + p_begin;

  // the slice into shared memory (cp.async; it lands while the
  // registers are set up)
  for (int i = threadIdx.x; i < n; i += kThreads) {
    cp_async4(s_x + i, px + i);
    cp_async4(s_y + i, py + i);
  }

  // per query: the list's k-th entry (kd, kp), the same on every lane;
  // a point is a candidate when d^2 <= kd (equal d^2 may still win on a
  // lower position: the scan order is not the position order)
  float ax[QW], ay[QW], kd[QW];
  int kp[QW];
  WarpList<J> list[QW];
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    const int q = q0 + i;
    ax[i] = q < nq ? qx[q] : 0.0f;
    ay[i] = q < nq ? qy[q] : 0.0f;
    kd[i] = q < nq ? CUDART_INF_F : -CUDART_INF_F;  // past nq: no point
    kp[i] = INT_MAX;
    list[i].clear();
  }
  unsigned* gb = gbest + static_cast<size_t>(c) * nq;

  // scan the slice in a scattered order (Morton order brings a query's
  // neighbours last, so nearly every point would enter the list):
  // lane l of step t takes slot (32 t + l) * step mod m
  const int m = (n + kWarp - 1) / kWarp * kWarp;
  const int step = m ? scatter_step(m) : 1;
  const int jump = m ? static_cast<int>(
                           static_cast<long long>(kWarp) * step % m)
                     : 0;
  int slot = m ? static_cast<int>(static_cast<long long>(lane) * step % m)
               : 0;
  cp_async_wait_all();
  __syncthreads();
  float nx = s_x[slot], ny = s_y[slot];  // the next step's point
  for (int t = 0; t < m / kWarp; ++t) {
    const bool valid = slot < n;
    const float vx = nx, vy = ny;
    {
      int next = slot + jump;
      if (next >= m) next -= m;
      nx = s_x[next];
      ny = s_y[next];
    }
    float dd[QW];
    bool any = false, small = false;
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      const float dx = __fsub_rn(vx, ax[i]);
      const float dy = __fsub_rn(vy, ay[i]);
      const float yy = __fmul_rn(dy, dy);
      dd[i] = __fmaf_rn(dx, dx, yy);
      small |= yy <= kLeastNormal;
    }
    if (small) {  // rare: a dy*dy at most 2^-126, where the flush may act
#pragma unroll
      for (int i = 0; i < QW; ++i)
        dd[i] = dist2_ftz(__fsub_rn(vx, ax[i]), __fsub_rn(vy, ay[i]));
    }
#pragma unroll
    for (int i = 0; i < QW; ++i) any |= valid && dd[i] <= kd[i];
    if (__any_sync(kFullMask, any)) {
      const int pos = p_begin + slot;
#pragma unroll
      for (int i = 0; i < QW; ++i) {
        unsigned cand = __ballot_sync(kFullMask, valid && dd[i] <= kd[i]);
        while (cand) {
          const int src = __ffs(cand) - 1;
          cand &= cand - 1;
          const float dn = __shfl_sync(kFullMask, dd[i], src);
          const int pn = __shfl_sync(kFullMask, pos, src);
          if (lex_less(dn, pn, kd[i], kp[i])) {
            list[i].insert(dn, pn, lane, jk, lk, kd[i], kp[i]);
          }
        }
      }
    }
    slot += jump;
    if (slot >= m) slot -= m;
  }
  // publish each list's k-th: no point farther than the least of them
  // is in the top-k, which bounds the merge (d^2 >= 0, so the encoding
  // inf - bits grows as d^2 falls)
#pragma unroll
  for (int i = 0; i < QW; ++i)
    if (q0 + i < nq && lane == 0)
      atomicMax(gb + q0 + i, kInfBits - __float_as_uint(kd[i]));

  // this slice's lists to the scratch rows (c, q, slice, :k)
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    const int q = q0 + i;
    if (q >= nq) continue;
    const size_t base =
        ((static_cast<size_t>(c) * nq + q) * n_slices + slice) * k;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = j * kWarp + lane;
      if (e < k) {
        part_d[base + e] = list[i].d[j];
        part_p[base + e] = list[i].p[j];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&done[static_cast<size_t>(c) * gridDim.x + qb], 1u) ==
             static_cast<unsigned>(n_slices - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block merges every slice's list of its queries
  const int total = n_slices * k;
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    const int q = q0 + i;
    if (q >= nq) continue;
    WarpList<J>& l = list[i];
    l.clear();
    float td = CUDART_INF_F;
    int tp = INT_MAX;
    // no entry farther than the least published k-th is in the top-k
    const float bound = __uint_as_float(kInfBits - __ldcg(gb + q));
    const size_t base = (static_cast<size_t>(c) * nq + q) * total;
    for (int o = 0; o < total; o += kWarp) {
      const bool valid = o + lane < total;
      const float dv = valid ? __ldcg(part_d + base + o + lane)
                             : CUDART_INF_F;
      const int pv = valid ? __ldcg(part_p + base + o + lane) : INT_MAX;
      unsigned cand = __ballot_sync(
          kFullMask, dv <= bound && lex_less(dv, pv, td, tp));
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        const float dn = __shfl_sync(kFullMask, dv, src);
        const int pn = __shfl_sync(kFullMask, pv, src);
        if (lex_less(dn, pn, td, tp)) {
          l.insert(dn, pn, lane, jk, lk, td, tp);
        }
      }
    }
    const size_t ob = (static_cast<size_t>(c) * nq + q) * k;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = j * kWarp + lane;
      if (e < k) {
        // as the reference: a distance at or past 3e38 is no hit
        const bool found = l.d[j] < 3.0e38f;
        out_neg[ob + e] = found ? -l.d[j] : kNeg;
        out_idx[ob + e] = found ? l.p[j] : -1;
      }
    }
  }
}

int queries_per_warp(int nq) {
  if (nq <= kWarps) return 1;
  if (nq <= 2 * kWarps) return 2;
  return 4;
}

// the dynamic shared memory of a slice of slice_len points
size_t slice_smem(int slice_len) {
  return 2 * sizeof(float) *
         static_cast<size_t>((slice_len + kWarp - 1) / kWarp * kWarp);
}

// the template arguments of one of the nine instances, as a type
template <int J_, int QW_>
struct Kernel {
  static constexpr int J = J_, QW = QW_;
};

// f(Kernel<J, QW>{}) for the instance that serves k and qw
template <typename F>
int dispatch(int k, int qw, F&& f) {
  auto by_qw = [&](auto j) -> int {
    constexpr int J = decltype(j)::value;
    switch (qw) {
      case 1: return f(Kernel<J, 1>{});
      case 2: return f(Kernel<J, 2>{});
      default: return f(Kernel<J, 4>{});
    }
  };
  if (k <= 32) return by_qw(std::integral_constant<int, 1>{});
  if (k <= 64) return by_qw(std::integral_constant<int, 2>{});
  return by_qw(std::integral_constant<int, 4>{});
}

// Raises instance K's dynamic shared-memory limit to a whole slice's on
// the current device, once per process and device (one bit each in
// `set`); a second call from a racing thread sets it again, harmlessly.
// Returns a cudaError_t.
template <typename K>
cudaError_t allow_slice_smem() {
  static std::atomic<unsigned> set{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (e != cudaSuccess || (set.load() & bit)) return e;
  e = cudaFuncSetAttribute(knn_topk_kernel<K::J, K::QW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(slice_smem(kMaxSlice)));
  if (e == cudaSuccess) set.fetch_or(bit);
  return e;
}

}  // namespace

// The launch plan for (nq, n_pad, n_parts, k): plan[0] = queries per
// warp, plan[1] = query blocks, plan[2] = slices per partition,
// plan[3] = points per slice. The slices are as many as keep every
// block of one launch resident on the card at once (one wave), within
// [kMinSlice, kMaxSlice] points each. Returns a cudaError_t.
REPRO_EXPORT int knn_topk_plan(int nq, int n_pad, int n_parts, int k,
                               int* plan) {
  if (k <= 0 || k > 128 || nq <= 0 || n_parts <= 0 || n_pad <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int qw = queries_per_warp(nq);
  const int qblocks = (nq + kWarps * qw - 1) / (kWarps * qw);
  const size_t smem = slice_smem(std::min(n_pad, kMaxSlice));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = static_cast<cudaError_t>(dispatch(k, qw, [&](auto kern) {
      using K = decltype(kern);
      // the occupancy query counts only up to the instance's limit
      cudaError_t r = allow_slice_smem<K>();
      if (r == cudaSuccess)
        r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, knn_topk_kernel<K::J, K::QW>, kThreads, smem);
      return static_cast<int>(r);
    }));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long groups = static_cast<long long>(qblocks) * n_parts;
  const long long resident =
      static_cast<long long>(std::max(per_sm, 1)) * sms;
  const long long fewest = (n_pad + kMaxSlice - 1LL) / kMaxSlice;
  const long long most =
      std::max(fewest, (n_pad + kMinSlice - 1LL) / kMinSlice);
  const long long slices =
      std::min(std::max(resident / groups, fewest), most);
  const int slice_len = static_cast<int>((n_pad + slices - 1) / slices);
  plan[0] = qw;
  plan[1] = qblocks;
  plan[2] = (n_pad + slice_len - 1) / slice_len;
  plan[3] = slice_len;
  return 0;
}

// Launch on `stream` with a plan from knn_topk_plan (qw, qblocks,
// slices, slice_len = plan[0..3]). Shapes: qx/qy (nq,); count
// (n_parts,); x/y (n_parts, n_pad); part_d/part_p (n_parts, nq, slices,
// k) scratch; gbest (n_parts, nq) and done (n_parts, qblocks) zeros;
// out_neg/out_idx (n_parts, nq, k); k <= 128 (MAX_K in knn_topk.py).
REPRO_EXPORT int knn_topk_launch(
    const float* qx, const float* qy, const int* count, const float* x,
    const float* y, int nq, int n_pad, int n_parts, int k, int qw,
    int qblocks, int slices, int slice_len, float* part_d, int* part_p,
    unsigned* gbest, unsigned* done, float* out_neg, int* out_idx,
    void* stream) {
  if (k <= 0 || k > 128 || slice_len <= 0 || slice_len > kMaxSlice)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(qblocks, slices, n_parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(k, qw, [&](auto kern) {
    using K = decltype(kern);
    const cudaError_t e = allow_slice_smem<K>();
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t smem = slice_smem(slice_len);
    knn_topk_kernel<K::J, K::QW><<<grid, kThreads, smem, s>>>(
        qx, qy, count, x, y, nq, n_pad, k, slices, slice_len, part_d,
        part_p, gbest, done, out_neg, out_idx);
    return static_cast<int>(cudaGetLastError());
  });
}
