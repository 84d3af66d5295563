// Circle count between learned key bounds, for a chunk of partitions.
//
// Replaces the Pallas kernel src/repro/kernels/circle_filter.py
// (circle_count, _kernel). Per (circle, partition): the number of
// positions p in [s, e) with p < count whose (x, y) lies in the circle's
// MBR (closed bounds) and within the circle, dx*dx + dy*dy <= r*r.
//
// As range_filter.cu: the TPU kernel scanned the whole partition row
// under a mask; here a circle touches only [s, min(e, count)), and an
// inactive (circle, partition) pair (the MBR misses the partition's box)
// touches nothing and counts 0, as the reference's mask gives.
//
// The distance is fmaf(dx, dx, dy*dy) <= r*r: XLA:CPU contracts the
// reference's dx*dx + dy*dy to that FMA. Every step is an explicitly
// rounded intrinsic, so nvcc cannot contract it another way.
//
// One warp per (circle, partition); lanes stride over the interval, so
// neighbouring lanes read neighbouring coordinates; a shuffle reduction
// gives the integer count, which is order-independent and so bitwise.
// Grid: (circle blocks of 8 warps, partitions).
//
// Bound: bytes — 8 bytes of coordinates per position in the intervals,
// against about ten operations each.
#include "common.cuh"

namespace {

__global__ void circle_count_kernel(
    const float* __restrict__ rects, const int* __restrict__ s,
    const int* __restrict__ e, const float* __restrict__ circ,
    const unsigned char* __restrict__ active,
    const int* __restrict__ count, const float* __restrict__ x,
    const float* __restrict__ y, int nq, int n_pad, int* __restrict__ out) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int c = blockIdx.y;
  if (w >= nq) return;  // whole warp leaves together
  const size_t cq = static_cast<size_t>(c) * nq + w;
  int acc = 0;
  if (active[cq]) {
    const float xl = rects[4 * w], yl = rects[4 * w + 1];
    const float xh = rects[4 * w + 2], yh = rects[4 * w + 3];
    const float cx = circ[3 * w], cy = circ[3 * w + 1];
    const float r = circ[3 * w + 2];
    const float r2 = __fmul_rn(r, r);
    const int lo = max(s[cq], 0);
    const int hi = min(min(e[cq], count[c]), n_pad);
    const float* px = x + static_cast<size_t>(c) * n_pad;
    const float* py = y + static_cast<size_t>(c) * n_pad;
    for (int p = lo + lane; p < hi; p += kWarp) {
      const float vx = px[p], vy = py[p];
      if (vx >= xl && vx <= xh && vy >= yl && vy <= yh) {
        const float dx = __fsub_rn(vx, cx);
        const float dy = __fsub_rn(vy, cy);
        acc += __fmaf_rn(dx, dx, __fmul_rn(dy, dy)) <= r2 ? 1 : 0;
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) out[cq] = acc;
}

}  // namespace

// Launch on `stream`. Shapes: rects (nq, 4); s/e/active (n_parts, nq);
// circ (nq, 3); count (n_parts,); x/y (n_parts, n_pad); out (n_parts, nq).
REPRO_EXPORT int circle_count_launch(
    const float* rects, const int* s, const int* e, const float* circ,
    const unsigned char* active, const int* count, const float* x,
    const float* y, int nq, int n_pad, int n_parts, int* out,
    void* stream) {
  constexpr int kThreads = 256;
  constexpr int kQueriesPerBlock = kThreads / kWarp;
  const dim3 grid((nq + kQueriesPerBlock - 1) / kQueriesPerBlock, n_parts);
  circle_count_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      rects, s, e, circ, active, count, x, y, nq, n_pad, out);
  return static_cast<int>(cudaGetLastError());
}
