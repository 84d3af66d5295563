// Polygon join count: ray-casting containment over the learned bounds
// of each polygon's MBR, for a chunk of partitions and every polygon.
//
// Replaces the Pallas kernel src/repro/kernels/point_in_polygon.py
// (point_in_polygon, _kernel). The TPU kernel flags one polygon over a
// whole partition row, one launch per polygon (lax.map), and the
// reference then ANDs the flags with the range filter's mask and sums.
// Here one launch covers every (polygon, partition) pair of a chunk and
// fuses the mask: a pair ray-casts only the positions p in
// [s, min(e, count)) whose (x, y) lies in the polygon's MBR (closed
// bounds), and an inactive pair (the MBR misses the partition's box)
// touches nothing and counts 0. Counting only masked points gives the
// same count as mask AND inside over the whole row.
//
// Per point, the parity over edges i < min(n_edges, E) of (poly[i],
// poly[nxt]), nxt = i + 1, or 0 past the last edge (an index past E is
// clamped to E - 1, as the reference's gather): an edge crosses when
// (y1 > py) != (y2 > py) and px < xin, with
//   t   = (py - y1) / (y2 == y1 ? 1e-30 : y2 - y1)   (IEEE division)
//   xin = fmaf(t, x2 - x1, x1)                       (XLA:CPU's FMA)
// in explicitly rounded intrinsics, so nvcc cannot contract otherwise.
// XLA:CPU reads float32 denormals as zero and flushes tiny results: the
// point, the MBR and the vertices are read through daz, and the
// differences, t and xin computed with sub_ftz, div_ftz and fma_ftz
// (common.cuh).
// An edge whose y-span misses py is skipped: it cannot cross. One thread
// takes a point's edges in order, so the parity is the reference's.
//
// The scan is interval_scan.cuh's, one launch per chunk: the positions
// of all the chunk's active intervals are cut into equal shares, one per
// SM, so no block idles on an inactive pair and the longest interval is
// split over blocks instead of setting the launch's time; counts meet by
// atomic adds, integer sums whatever their order, so bitwise.
// A share spans many (polygon, partition) pairs, so no polygon is staged
// in shared memory: the vertices are read with __ldg from global memory
// (a warp's lanes walk neighbouring positions of, almost always, one
// pair, so each read is one broadcast from L1), and each edge's end
// vertex is carried into the next edge, so a point loads each vertex
// once. There is no limit on the vertices per polygon. The shares
// balance positions, not edges: a point outside the MBR costs four
// compares, one inside up to E edges, so a polygon of thousands of edges
// is balanced by its positions only.
//
// Bound: bytes, 8 per position of the union of the intervals, or
// operations, about 8 per edge per scanned point in the MBR, whichever
// is larger.
#include "interval_scan.cuh"

namespace {

struct PolygonTest {
  const float2* polys;  // (pg, e_max): vertices
  const int* n_edges;   // (pg,)
  const float* mbrs;    // (pg, 4): xl, yl, xh, yh
  int e_max;
  const float2* vert;   // polygon g's row
  float xl, yl, xh, yh;
  int ne;

  __device__ __forceinline__ void load(int g) {
    vert = polys + static_cast<size_t>(g) * e_max;
    ne = __ldg(n_edges + g);
    xl = daz(__ldg(mbrs + 4 * g));
    yl = daz(__ldg(mbrs + 4 * g + 1));
    xh = daz(__ldg(mbrs + 4 * g + 2));
    yh = daz(__ldg(mbrs + 4 * g + 3));
  }

  // vertex i of the polygon, as XLA:CPU reads it
  __device__ __forceinline__ float2 vertex(int i) const {
    const float2 v = __ldg(vert + i);
    return make_float2(daz(v.x), daz(v.y));
  }

  __device__ __forceinline__ bool operator()(float vx, float vy) const {
    vx = daz(vx);
    vy = daz(vy);
    if (!(vx >= xl && vx <= xh && vy >= yl && vy <= yh)) return false;
    const int n_loop = min(ne, e_max);
    bool parity = false;
    float2 v1 = n_loop > 0 ? vertex(0) : make_float2(0.f, 0.f);
    for (int i = 0; i < n_loop; ++i) {
      // nxt == i + 1 on every edge but the last, so v2 is the next v1
      const int nxt = i + 1 >= ne ? 0 : min(i + 1, e_max - 1);
      const float2 v2 = vertex(nxt);
      if ((v1.y > vy) != (v2.y > vy)) {
        const float den = v2.y == v1.y ? 1e-30f : sub_ftz(v2.y, v1.y);
        const float t = div_ftz(sub_ftz(vy, v1.y), den);
        const float xin = fma_ftz(t, sub_ftz(v2.x, v1.x), v1.x);
        parity ^= vx < xin;
      }
      v1 = v2;
    }
    return parity;
  }
};

}  // namespace

// Launch on `stream`. Shapes: polys (pg, e_max, 2); n_edges (pg,);
// mbrs (pg, 4); s/e/active (n_parts, pg); count (n_parts,);
// x/y (n_parts, n_pad); out (n_parts, pg).
REPRO_EXPORT int join_count_launch(
    const float* polys, const int* n_edges, const float* mbrs, const int* s,
    const int* e, const unsigned char* active, const int* count,
    const float* x, const float* y, int pg, int e_max, int n_pad,
    int n_parts, int* out, void* stream) {
  PolygonTest test{reinterpret_cast<const float2*>(polys), n_edges, mbrs,
                   e_max, nullptr, 0.f, 0.f, 0.f, 0.f, 0};
  return interval_scan::launch(test, s, e, active, count, x, y, pg, n_pad,
                               n_parts, out, stream);
}
