// Polygon join count: ray-casting containment over the learned bounds
// of each polygon's MBR, for a chunk of partitions and every polygon.
//
// Replaces the Pallas kernel src/repro/kernels/point_in_polygon.py
// (point_in_polygon, _kernel). The TPU kernel flags one polygon over a
// whole partition row, one launch per polygon (lax.map), and the
// reference then ANDs the flags with the range filter's mask and sums.
// Here one launch covers every (polygon, partition) pair of a chunk and
// fuses the mask: a block per pair ray-casts only the positions p in
// [s, min(e, count)) whose (x, y) lies in the polygon's MBR (closed
// bounds), and an inactive pair (the MBR misses the partition's box)
// touches nothing and counts 0. Counting only masked points gives the
// same count as mask AND inside over the whole row.
//
// Per point, the parity over edges i < n_edges of (poly[i], poly[nxt]),
// nxt = i + 1, or 0 past the last edge: an edge crosses when
// (y1 > py) != (y2 > py) and px < xin, with
//   t   = (py - y1) / (y2 == y1 ? 1e-30 : y2 - y1)   (IEEE division)
//   xin = fmaf(t, x2 - x1, x1)                       (XLA:CPU's FMA)
// in explicitly rounded intrinsics, so nvcc cannot contract otherwise.
// An edge whose y-span misses py is skipped: it cannot cross.
//
// The vertices (E <= 6140: 48 KB of shared memory per block less the
// 32 bytes of warp_acc) sit in shared memory; threads stride
// over the interval, so neighbouring threads read neighbouring
// coordinates; the integer count is reduced per warp by shuffles, then
// across the block's warps, which is order-independent and so bitwise.
// Grid: (polygons, partitions).
//
// Bound: operations — about 8 float operations per edge per scanned
// point in the MBR — or bytes, 8 per scanned position, whichever is
// larger.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void join_count_kernel(
    const float* __restrict__ polys, const int* __restrict__ n_edges,
    const float* __restrict__ mbrs, const int* __restrict__ s,
    const int* __restrict__ e, const unsigned char* __restrict__ active,
    const int* __restrict__ count, const float* __restrict__ x,
    const float* __restrict__ y, int pg, int e_max, int n_pad,
    int* __restrict__ out) {
  extern __shared__ float vert[];  // (e_max, 2)
  __shared__ int warp_acc[kThreads / kWarp];
  const int g = blockIdx.x;
  const int c = blockIdx.y;
  const size_t cg = static_cast<size_t>(c) * pg + g;
  if (!active[cg]) {  // the whole block leaves together
    if (threadIdx.x == 0) out[cg] = 0;
    return;
  }
  for (int i = threadIdx.x; i < 2 * e_max; i += blockDim.x)
    vert[i] = polys[static_cast<size_t>(g) * 2 * e_max + i];
  __syncthreads();

  const int ne = n_edges[g];
  const int n_loop = min(ne, e_max);
  const float xl = mbrs[4 * g], yl = mbrs[4 * g + 1];
  const float xh = mbrs[4 * g + 2], yh = mbrs[4 * g + 3];
  const int lo = max(s[cg], 0);
  const int hi = min(min(e[cg], count[c]), n_pad);
  const float* px = x + static_cast<size_t>(c) * n_pad;
  const float* py = y + static_cast<size_t>(c) * n_pad;
  int acc = 0;
  for (int p = lo + threadIdx.x; p < hi; p += blockDim.x) {
    const float vx = px[p], vy = py[p];
    if (!(vx >= xl && vx <= xh && vy >= yl && vy <= yh)) continue;
    bool parity = false;
    for (int i = 0; i < n_loop; ++i) {
      // as the reference's gather: an index past E is clamped
      const int nxt = i + 1 >= ne ? 0 : min(i + 1, e_max - 1);
      const float x1 = vert[2 * i], y1 = vert[2 * i + 1];
      const float x2 = vert[2 * nxt], y2 = vert[2 * nxt + 1];
      if ((y1 > vy) != (y2 > vy)) {
        const float den = y2 == y1 ? 1e-30f : __fsub_rn(y2, y1);
        const float t = __fdiv_rn(__fsub_rn(vy, y1), den);
        const float xin = __fmaf_rn(t, __fsub_rn(x2, x1), x1);
        parity ^= vx < xin;
      }
    }
    acc += parity ? 1 : 0;
  }
  acc = warp_sum(acc);
  if (threadIdx.x % kWarp == 0) warp_acc[threadIdx.x / kWarp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / kWarp; ++w) total += warp_acc[w];
    out[cg] = total;
  }
}

}  // namespace

// Launch on `stream`. Shapes: polys (pg, e_max, 2); n_edges (pg,);
// mbrs (pg, 4); s/e/active (n_parts, pg); count (n_parts,);
// x/y (n_parts, n_pad); out (n_parts, pg). e_max <= 6140.
REPRO_EXPORT int join_count_launch(
    const float* polys, const int* n_edges, const float* mbrs, const int* s,
    const int* e, const unsigned char* active, const int* count,
    const float* x, const float* y, int pg, int e_max, int n_pad,
    int n_parts, int* out, void* stream) {
  const size_t smem = static_cast<size_t>(e_max) * 2 * sizeof(float);
  const dim3 grid(pg, n_parts);
  join_count_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      polys, n_edges, mbrs, s, e, active, count, x, y, pg, e_max, n_pad,
      out);
  return static_cast<int>(cudaGetLastError());
}
