// Point query: candidate filter, learned lookup and probe scan in one
// launch.
//
// Replaces the Pallas kernel src/repro/kernels/point_probe.py
// (point_probe, _kernel), together with the point program in front of it
// (src/repro/core/local_ops.py _PointLocal: the first-match grid box, and
// queries.lower_bound_at for each candidate partition). The TPU kernel
// only counted matches in windows the host had gathered; here each query
// runs the whole program:
//
//   candidates  pid1 = the lowest grid box g < overflow that holds the
//               point (closed edges, point_in_box), else overflow;
//               pid2 = overflow (the overflow grid);
//   lookup      per candidate p, lower_bound_at's exact steps: succ =
//               #{knot_keys[p, :] < qk} over the whole padded knot row,
//               seg = clamp(succ - 1, 0, m - 2), t by an IEEE division,
//               phat = fma(t, p1 - p0, p0), start = clamp(rint(phat) -
//               probe/2, 0, n_pad - probe), pos = min(start + #{keys in
//               the window < qk}, count[p]);
//   scan        hits(p) = positions of [s2, s2 + probe), s2 = clamp(pos -
//               probe/2, 0, n_pad - probe), whose key, x and y all equal
//               the query's;
//   merge       found = (hits(pid1) > 0) | (hits(pid2) > 0).
//
// On a meshed executor the planes hold one shard, the global partitions
// [part_offset, part_offset + n_parts), and the boxes stay global: a
// candidate p outside the shard contributes 0, the others read row
// p - part_offset (the reference's probe_pid: lid = pid - off, mine).
// Unsharded, part_offset is 0 and every partition is held.
//
// Bitwise notes: rintf (half to even, as jnp.round and torch.round),
// never roundf; __fdiv_rn and __fmaf_rn spell the reference's IEEE
// division and XLA:CPU's contraction of p0 + t*(p1 - p0); the start
// rounds, it does not truncate (bounds_on_rows truncates, this path does
// not); fminf/fmaxf clamp values that are never NaN (knot rows pad with
// a finite 3.4e38). XLA:CPU reads float32 denormals as zero, so the box
// test and the equality probe flush the coordinates on both sides
// (common.cuh daz); keys are integer-valued, and the lookup's one
// denormal (t below 2^-126 against a padded knot) cannot move a rounded
// position.
//
// Bound: latency. Each query is a chain of dependent reads (box -> knot
// row -> lookup window -> probe window); the bytes (the queries, the
// boxes once, a knot row and two windows per candidate, the output) take
// well under a microsecond at 1,024 queries, below one launch's floor.
// The design shortens the chain: one warp works on each (query,
// candidate), so the overflow candidate's chain runs beside the box scan
// and pid1's chain instead of after it; boxes and knot rows are read
// with __ldg (they stay in L1/L2 across queries); the probe window
// overlaps the lookup window, so its key reads hit L1; x and y are read
// only where the key matches. The two warps of a query meet in shared
// memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// every lane holds the total
__device__ __forceinline__ int warp_total(int v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) point_query_kernel(
    const float4* __restrict__ bounds, const float* __restrict__ knot_keys,
    const float* __restrict__ knot_pos, const float* __restrict__ keys_f,
    const float* __restrict__ x, const float* __restrict__ y,
    const int* __restrict__ count, const float* __restrict__ qx,
    const float* __restrict__ qy, const float* __restrict__ qk, int nq,
    int n_parts, int m, int n_pad, int overflow, int probe, int part_offset,
    int* __restrict__ out) {
  __shared__ int hit[kThreads / kWarp];
  const int lane = threadIdx.x % kWarp;
  const int local = threadIdx.x / kWarp;            // warp in the block
  const int group = blockIdx.x * (kThreads / kWarp) + local;
  const int q = group / 2, cand = group % 2;
  int found = 0;
  if (q < nq) {  // the whole warp takes the same branch
    const float vx = daz(qx[q]), vy = daz(qy[q]), k = qk[q];
    int p = overflow;
    if (cand == 0) {  // the lowest box holding the point, as argmax
      for (int b0 = 0; b0 < overflow; b0 += kWarp) {
        const int g = b0 + lane;
        bool in = false;
        if (g < overflow) {
          const float4 b = __ldg(bounds + g);       // xlo, ylo, xhi, yhi
          in = vx >= daz(b.x) && vx <= daz(b.z) && vy >= daz(b.y) &&
               vy <= daz(b.w);
        }
        const unsigned ballot = __ballot_sync(kFullMask, in);
        if (ballot) {
          p = b0 + __ffs(ballot) - 1;
          break;
        }
      }
    }
    // the shard's row of candidate p; a candidate it does not hold
    // contributes 0 and reads nothing (the whole warp skips it)
    const int row_id = p - part_offset;
    if (row_id >= 0 && row_id < n_parts) {
      p = row_id;
      // learned lookup: the segment over the whole knot row
      const float* kk = knot_keys + static_cast<size_t>(p) * m;
      const float* kp = knot_pos + static_cast<size_t>(p) * m;
      int succ = 0;
      for (int j = lane; j < m; j += kWarp)
        succ += __ldg(kk + j) < k ? 1 : 0;
      succ = warp_total(succ);
      const int seg = min(max(succ - 1, 0), m - 2);
      const float k0 = __ldg(kk + seg), k1 = __ldg(kk + seg + 1);
      const float p0 = __ldg(kp + seg), p1 = __ldg(kp + seg + 1);
      const float t = fminf(
          fmaxf(__fdiv_rn(__fsub_rn(k, k0),
                          fmaxf(__fsub_rn(k1, k0), 1e-30f)),
                0.0f),
          1.0f);
      const float phat = __fmaf_rn(t, __fsub_rn(p1, p0), p0);
      const int half = probe / 2, last = n_pad - probe;
      const int start =
          min(max(static_cast<int>(rintf(phat)) - half, 0), last);
      const float* row = keys_f + static_cast<size_t>(p) * n_pad;
      int below = 0;
      for (int i = lane; i < probe; i += kWarp)
        below += row[start + i] < k ? 1 : 0;
      below = warp_total(below);
      const int pos = min(start + below, count[p]);
      // probe scan around the lower bound
      const int s2 = min(max(pos - half, 0), last);
      const size_t base = static_cast<size_t>(p) * n_pad + s2;
      int hits = 0;
      for (int i = lane; i < probe; i += kWarp) {
        const size_t o = base + i;
        hits += (keys_f[o] == k && daz(x[o]) == vx && daz(y[o]) == vy) ? 1
                                                                      : 0;
      }
      found = warp_total(hits) > 0 ? 1 : 0;
    }
  }
  if (lane == 0) hit[local] = found;
  __syncthreads();
  if (lane == 0 && cand == 0 && q < nq) out[q] = hit[local] | hit[local + 1];
}

}  // namespace

// Launch on `stream`, one warp per (query, candidate). Shapes: bounds
// (P, 4) of every partition, P > overflow, 16-byte aligned; the shard's
// planes knot_keys, knot_pos (n_parts, m); keys_f, x, y (n_parts,
// n_pad); count (n_parts,), rows part_offset.. of P; qx, qy, qk (nq,);
// out (nq,) int32, 1 where the point is found in the shard.
REPRO_EXPORT int point_query_launch(
    const float* bounds, const float* knot_keys, const float* knot_pos,
    const float* keys_f, const float* x, const float* y, const int* count,
    const float* qx, const float* qy, const float* qk, int nq, int n_parts,
    int m, int n_pad, int overflow, int probe, int part_offset, int* out,
    void* stream) {
  const long long threads = 2LL * nq * kWarp;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  point_query_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(bounds), knot_keys, knot_pos, keys_f, x,
      y, count, qx, qy, qk, nq, n_parts, m, n_pad, overflow, probe,
      part_offset, out);
  return static_cast<int>(cudaGetLastError());
}
