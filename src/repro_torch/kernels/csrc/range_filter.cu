// Range count between learned key bounds, for a chunk of partitions.
//
// Replaces the Pallas kernel src/repro/kernels/range_filter.py
// (range_count, _kernel). Per (query, partition): the number of
// positions p in [s, e) with p < count whose (x, y) lies in the query
// rect (closed bounds).
//
// The TPU kernel scanned the whole partition row under a mask. Here a
// query touches only the positions in [s, min(e, count)) — what the
// learned bounds bought — and an inactive (query, partition) pair (the
// rect misses the partition's box) touches nothing: its count is 0, as
// the reference's mask gives. The count is the same either way.
//
// The scan is interval_scan.cuh's: the positions of the chunk's
// intervals spread evenly over a fixed grid, one launch per chunk.
//
// XLA:CPU reads float32 denormals as zero, so both sides of each compare
// are read through daz (common.cuh): the rect once per query, the point
// per position.
//
// Bound: bytes — 8 bytes of coordinates per position in the intervals,
// four compares each.
#include "interval_scan.cuh"

namespace {

struct RectTest {
  const float* rects;  // (nq, 4): xl, yl, xh, yh
  float xl, yl, xh, yh;

  __device__ __forceinline__ void load(int q) {
    xl = daz(__ldg(rects + 4 * q));
    yl = daz(__ldg(rects + 4 * q + 1));
    xh = daz(__ldg(rects + 4 * q + 2));
    yh = daz(__ldg(rects + 4 * q + 3));
  }

  __device__ __forceinline__ bool operator()(float vx, float vy) const {
    vx = daz(vx);
    vy = daz(vy);
    return vx >= xl && vx <= xh && vy >= yl && vy <= yh;
  }
};

}  // namespace

// Launch on `stream`. Shapes: rects (nq, 4); s/e/active (n_parts, nq);
// count (n_parts,); x/y (n_parts, n_pad); out (n_parts, nq).
REPRO_EXPORT int range_count_launch(
    const float* rects, const int* s, const int* e,
    const unsigned char* active, const int* count, const float* x,
    const float* y, int nq, int n_pad, int n_parts, int* out,
    void* stream) {
  RectTest test{rects, 0.f, 0.f, 0.f, 0.f};
  return interval_scan::launch(test, s, e, active, count, x, y, nq, n_pad,
                               n_parts, out, stream);
}

// The grid every launch on the current device takes, into *blocks.
REPRO_EXPORT int range_count_grid(int* blocks) {
  return interval_scan::grid_size(blocks);
}
