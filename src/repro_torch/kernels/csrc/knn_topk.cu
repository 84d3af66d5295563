// Exact per-partition kNN: top-k of (-d^2, position) per query.
//
// Replaces the Pallas kernel src/repro/kernels/knn_topk.py (knn_topk,
// _kernel). Per (query, partition): the k smallest squared distances
// over the partition's first `count` points, ordered by distance and,
// among equal distances, by lowest position (lax.top_k's tie order).
// Outputs are -d^2 and the position; slots left empty (count < k) hold
// -3e38 and -1.
//
// One warp per (query, partition). Each lane scans positions lane,
// lane+32, ... in increasing order and keeps its own k best in a list
// sorted by (d^2, position): a point enters only when strictly closer
// than the lane's k-th, so among equal distances the earlier (lower)
// position stays ahead. The 32 lists are then merged by k rounds of a
// warp-wide lexicographic arg-min over the lists' heads. The TPU kernel
// instead merged 512-point tiles by k rounds of "max, then first hit"
// over the whole tile; the result is the same set in the same order.
//
// The distance is fmaf(dx, dx, dy*dy), the form XLA:CPU contracts
// dx*dx + dy*dy to; every step is an explicit intrinsic so nvcc cannot
// contract it differently.
//
// Bound: operations — five float operations per (query, point) pair
// against 8 bytes per point that all queries share.
#include <climits>

#include "common.cuh"

namespace {

constexpr float kNeg = -3.0e38f;

template <int KMAX>
__global__ void knn_topk_kernel(
    const float* __restrict__ qx, const float* __restrict__ qy,
    const int* __restrict__ count, const float* __restrict__ x,
    const float* __restrict__ y, int nq, int n_pad, int k,
    float* __restrict__ out_neg, int* __restrict__ out_idx) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int c = blockIdx.y;
  if (w >= nq) return;  // whole warp leaves together
  const float ax = qx[w], ay = qy[w];
  const int cnt = min(count[c], n_pad);
  const float* px = x + static_cast<size_t>(c) * n_pad;
  const float* py = y + static_cast<size_t>(c) * n_pad;

  float bd[KMAX];
  int bp[KMAX];
  int nb = 0;
  for (int p = lane; p < cnt; p += kWarp) {
    const float dx = __fsub_rn(px[p], ax);
    const float dy = __fsub_rn(py[p], ay);
    const float d2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
    if (nb < k || d2 < bd[k - 1]) {
      int i = nb < k ? nb : k - 1;
      while (i > 0 && bd[i - 1] > d2) {
        bd[i] = bd[i - 1];
        bp[i] = bp[i - 1];
        --i;
      }
      bd[i] = d2;
      bp[i] = p;
      if (nb < k) ++nb;
    }
  }

  const size_t base = (static_cast<size_t>(c) * nq + w) * k;
  int h = 0;  // head of this lane's list
  for (int r = 0; r < k; ++r) {
    const bool has = h < nb;
    float md = has ? bd[h] : __int_as_float(0x7f800000);  // +inf
    int mp = has ? bp[h] : INT_MAX;
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFullMask, md, off);
      const int op = __shfl_xor_sync(kFullMask, mp, off);
      if (od < md || (od == md && op < mp)) {
        md = od;
        mp = op;
      }
    }
    // positions are unique across lanes: the owner of the minimum pops
    if (has && bp[h] == mp) ++h;
    if (lane == 0) {
      // as the reference: a distance at or past 3e38 is no hit
      const bool found = mp != INT_MAX && md < 3.0e38f;
      out_neg[base + r] = found ? -md : kNeg;
      out_idx[base + r] = found ? mp : -1;
    }
  }
}

template <int KMAX>
int launch(const float* qx, const float* qy, const int* count,
           const float* x, const float* y, int nq, int n_pad, int n_parts,
           int k, float* out_neg, int* out_idx, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int kQueriesPerBlock = kThreads / kWarp;
  const dim3 grid((nq + kQueriesPerBlock - 1) / kQueriesPerBlock, n_parts);
  knn_topk_kernel<KMAX><<<grid, kThreads, 0, stream>>>(
      qx, qy, count, x, y, nq, n_pad, k, out_neg, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`. Shapes: qx/qy (nq,); count (n_parts,);
// x/y (n_parts, n_pad); out_neg/out_idx (n_parts, nq, k); k <= 128
// (MAX_K in knn_topk.py).
REPRO_EXPORT int knn_topk_launch(
    const float* qx, const float* qy, const int* count, const float* x,
    const float* y, int nq, int n_pad, int n_parts, int k, float* out_neg,
    int* out_idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 16)
    return launch<16>(qx, qy, count, x, y, nq, n_pad, n_parts, k, out_neg,
                      out_idx, s);
  if (k <= 32)
    return launch<32>(qx, qy, count, x, y, nq, n_pad, n_parts, k, out_neg,
                      out_idx, s);
  if (k <= 64)
    return launch<64>(qx, qy, count, x, y, nq, n_pad, n_parts, k, out_neg,
                      out_idx, s);
  if (k <= 128)
    return launch<128>(qx, qy, count, x, y, nq, n_pad, n_parts, k, out_neg,
                       out_idx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
