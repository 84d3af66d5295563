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
// touches nothing and counts 0, as the reference's mask gives. The scan
// is interval_scan.cuh's, one launch per chunk.
//
// The distance is fmaf(dx, dx, dy*dy) <= r*r: XLA:CPU contracts the
// reference's dx*dx + dy*dy to that FMA. Every step is an explicitly
// rounded intrinsic, so nvcc cannot contract it another way. XLA:CPU
// reads float32 denormals as zero and flushes tiny results: the MBR test
// compares values read through daz, and dy*dy, the FMA and r*r are
// flushed (dist2_ftz, mul_ftz in common.cuh); dx and dy are only
// squared, so they need no flush.
//
// Bound: bytes — 8 bytes of coordinates per position in the intervals,
// against about ten operations each.
#include "interval_scan.cuh"

namespace {

struct CircleTest {
  const float* rects;  // (nq, 4): the circle's MBR
  const float* circ;   // (nq, 3): cx, cy, r
  float xl, yl, xh, yh, cx, cy, r2;

  __device__ __forceinline__ void load(int q) {
    xl = daz(__ldg(rects + 4 * q));
    yl = daz(__ldg(rects + 4 * q + 1));
    xh = daz(__ldg(rects + 4 * q + 2));
    yh = daz(__ldg(rects + 4 * q + 3));
    cx = __ldg(circ + 3 * q);
    cy = __ldg(circ + 3 * q + 1);
    const float r = __ldg(circ + 3 * q + 2);  // a denormal r squares to 0
    r2 = mul_ftz(r, r);
  }

  __device__ __forceinline__ bool operator()(float vx, float vy) const {
    vx = daz(vx);
    vy = daz(vy);
    if (!(vx >= xl && vx <= xh && vy >= yl && vy <= yh)) return false;
    return dist2_ftz(__fsub_rn(vx, cx), __fsub_rn(vy, cy)) <= r2;
  }
};

}  // namespace

// Launch on `stream`. Shapes: rects (nq, 4); s/e/active (n_parts, nq);
// circ (nq, 3); count (n_parts,); x/y (n_parts, n_pad); out (n_parts, nq).
REPRO_EXPORT int circle_count_launch(
    const float* rects, const int* s, const int* e, const float* circ,
    const unsigned char* active, const int* count, const float* x,
    const float* y, int nq, int n_pad, int n_parts, int* out,
    void* stream) {
  CircleTest test{rects, circ, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  return interval_scan::launch(test, s, e, active, count, x, y, nq, n_pad,
                               n_parts, out, stream);
}
