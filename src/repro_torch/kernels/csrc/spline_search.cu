// Learned lower bound (paper Fig. 3) for a chunk of partitions at once.
//
// Replaces the Pallas kernel src/repro/kernels/spline_search.py
// (spline_search, _kernel). Per (query key, partition): radix bucket ->
// knot window [T[j], T[j+1]] -> compare-count segment locate -> linear
// interpolation -> round half to even -> compare-count over a
// probe-wide window of the sorted float32 keys, capped at the count.
//
// What bounds it on this card: latency and the launch. Each lookup is a
// chain of four dependent reads (key -> radix row -> knot window ->
// probe window) of a few hundred bytes, far below the byte bound's
// reach, and one launch per chunk of partitions puts the launch's own
// cost (a few microseconds) on every chunk.
//
// Design: a group of 16 lanes (half a warp) works on one (query
// key, partition) pair, so a launch holds nq x n_parts groups instead
// of one thread each:
//   - lane 0 reads the radix row at the key's bucket and broadcasts the
//     knot window [lo, hi] with a shuffle;
//   - the group counts the window's knots below the key in strides of 16
//     (one coalesced load per lane and a ballot/__popc per stride),
//     which gives the segment;
//   - every lane computes the same interpolation (a warp-uniform
//     instruction costs what one lane's does, and needs no shuffle);
//   - the probe window is sorted, so its compare-count is taken in two
//     levels: the group counts the window's samples at stride
//     s = ceil(probe / 16) below q (one load per lane), then the s keys
//     after the last such sample (ceil(s / 16) coalesced loads). Both
//     count with __popc(__ballot_sync(...)). At the reference's probe of
//     256 keys the two levels read 18 sectors of 32 bytes instead of 32.
// The knot and radix rows are read through L1: a partition's rows
// (about 1,800 words at the reference's m_eff) are shared by every key
// of the launch and stay cached, and staging them in shared memory
// measured slower (PERF.md §6).
//
// Numerics match the JAX reference on XLA:CPU bit for bit: the
// interpolation p0 + t*(p1-p0) is the fused multiply-add XLA contracts it
// to (__fmaf_rn), every other operation is an explicitly rounded
// single-precision intrinsic (no contraction left to the compiler), and
// the rounding is rintf (half to even, as jnp.round), not roundf.
// XLA:CPU reads float32 denormals as zero (common.cuh daz/ftz), but no
// flush is needed here: keys and knots are integer-valued, the result is
// an integer position, and the one denormal (t below 2^-126 against a
// padded knot) cannot move a rounded position.
#include "common.cuh"

namespace {

constexpr int kGroup = 16;     // lanes per (key, partition): half a warp
constexpr int kThreads = 256;  // threads per block

__global__ void __launch_bounds__(kThreads) spline_search_kernel(
    const float* __restrict__ q, int nq,
    const float* __restrict__ knot_keys, const float* __restrict__ knot_pos,
    int m, const int* __restrict__ radix_table, int r,
    const float* __restrict__ kmin, const float* __restrict__ scale,
    const int* __restrict__ n_knots, const int* __restrict__ count,
    const float* __restrict__ keys_f, int n_pad, int probe, int radix_bits,
    int* __restrict__ out) {
  const int c = blockIdx.y;
  const float* kk = knot_keys + static_cast<size_t>(c) * m;
  const float* kp = knot_pos + static_cast<size_t>(c) * m;
  const int* rt = radix_table + static_cast<size_t>(c) * r;
  const int lane = threadIdx.x % kGroup;
  const int qi = blockIdx.x * (blockDim.x / kGroup) + threadIdx.x / kGroup;
  if (qi >= nq) return;  // the whole group leaves together
  // this group's half of the warp
  const unsigned gmask = 0xffffu << ((threadIdx.x % kWarp) & kGroup);
  const float qv = q[qi];

  // radix locate (lane 0): bucket j, knot window [lo, hi]
  int lo = 0, hi = 0, cap = 0;
  if (lane == 0) {
    float jf = floorf(__fmul_rn(__fsub_rn(qv, kmin[c]), scale[c]));
    jf = fminf(fmaxf(jf, 0.0f), static_cast<float>(1 << radix_bits));
    const int j = static_cast<int>(jf);
    lo = rt[j];
    hi = min(max(rt[j + 1], lo), max(n_knots[c] - 1, 0));
    cap = count[c];
  }
  lo = __shfl_sync(gmask, lo, 0, kGroup);
  hi = __shfl_sync(gmask, hi, 0, kGroup);

  // segment locate: the knots of [lo, hi] below the key, counted by the
  // group in strides of its width; then the segment's end knots
  int succ = lo;
  for (int b = lo; b <= hi; b += kGroup) {
    const int i = b + lane;
    succ += __popc(__ballot_sync(gmask, i <= hi && kk[i] < qv) & gmask);
  }
  const int seg = max(succ - 1, 0);
  const int seg1 = min(seg + 1, m - 1);
  const float k0 = kk[seg], k1 = kk[seg1], p0 = kp[seg], p1 = kp[seg1];

  // interpolation (FMA, as XLA:CPU contracts it) and probe start; every
  // lane computes the same values
  float t = __fdiv_rn(__fsub_rn(qv, k0), fmaxf(__fsub_rn(k1, k0), 1e-30f));
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float phat = __fmaf_rn(t, __fsub_rn(p1, p0), p0);
  int start = static_cast<int>(rintf(phat)) - probe / 2;
  start = min(max(start, 0), n_pad - probe);

  // exact lower bound by compare-count over the sorted probe window, in
  // two levels: the group counts the samples row[l * stride] below q
  // (c1 of at most kGroup), then the stride keys from sample c1 - 1 on,
  // kGroup per load; all keys before them are below q, all from sample
  // c1 on are not
  const float* row = keys_f + static_cast<size_t>(c) * n_pad + start;
  const int stride = (probe + kGroup - 1) / kGroup;
  const int si = lane * stride;
  const float s1 = si < probe ? row[si] : qv;  // qv < qv: not counted
  const int c1 = __popc(__ballot_sync(gmask, s1 < qv) & gmask);
  int pos = start;
  if (c1 > 0) {
    const int b = (c1 - 1) * stride;
    const int e = min(b + stride, probe);
    pos += b;
    for (int o = b; o < e; o += kGroup) {
      const int i = o + lane;
      const float v = i < e ? row[i] : qv;
      pos += __popc(__ballot_sync(gmask, v < qv) & gmask);
    }
  }
  if (lane == 0) out[static_cast<size_t>(c) * nq + qi] = min(pos, cap);
}

}  // namespace

// Launch on `stream`. Shapes: q (nq,); knot_keys/knot_pos (n_parts, m);
// radix_table (n_parts, r); kmin/scale/n_knots/count (n_parts,);
// keys_f (n_parts, n_pad), each row sorted; out (n_parts, nq). Returns
// cudaGetLastError().
REPRO_EXPORT int spline_search_launch(
    const float* q, int nq, const float* knot_keys, const float* knot_pos,
    int m, const int* radix_table, int r, const float* kmin,
    const float* scale, const int* n_knots, const int* count,
    const float* keys_f, int n_pad, int n_parts, int probe, int radix_bits,
    int* out, void* stream) {
  constexpr int per_block = kThreads / kGroup;
  const dim3 grid((nq + per_block - 1) / per_block, n_parts);
  spline_search_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
          q, nq, knot_keys, knot_pos, m, radix_table, r, kmin, scale,
          n_knots, count, keys_f, n_pad, probe, radix_bits, out);
  return static_cast<int>(cudaGetLastError());
}
