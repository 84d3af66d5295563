// Learned lower bound (paper Fig. 3) for a chunk of partitions at once.
//
// Replaces the Pallas kernel src/repro/kernels/spline_search.py
// (spline_search, _kernel). Per (query key, partition): radix bucket ->
// knot window [T[j], T[j+1]] -> compare-count segment locate -> linear
// interpolation -> round half to even -> compare-count over a
// probe-wide window of the sorted float32 keys, capped at the count.
//
// Grid: (query blocks of 256, partitions). Each block stages its
// partition's knot keys, knot positions and radix row in shared memory
// (they are read by every query of the block); the probe window is read
// from global memory, since a partition's key row (n_pad x 4 bytes) is
// far larger than a block's shared memory. One thread per query.
//
// Bound: bytes. Each query reads `probe` keys (the window) and a few
// knots; arithmetic is a few dozen operations per query.
//
// Numerics match the JAX reference on XLA:CPU bit for bit: the
// interpolation p0 + t*(p1-p0) is the fused multiply-add XLA contracts it
// to (__fmaf_rn), every other operation is an explicitly rounded
// single-precision intrinsic (no contraction left to the compiler), and
// the rounding is rintf (half to even, as jnp.round), not roundf.
#include "common.cuh"

namespace {

__global__ void spline_search_kernel(
    const float* __restrict__ q, int nq,
    const float* __restrict__ knot_keys, const float* __restrict__ knot_pos,
    int m, const int* __restrict__ radix_table, int r,
    const float* __restrict__ kmin, const float* __restrict__ scale,
    const int* __restrict__ n_knots, const int* __restrict__ count,
    const float* __restrict__ keys_f, int n_pad, int probe, int radix_bits,
    int staged, int* __restrict__ out) {
  extern __shared__ float smem[];
  const int c = blockIdx.y;
  const float* kk = knot_keys + static_cast<size_t>(c) * m;
  const float* kp = knot_pos + static_cast<size_t>(c) * m;
  const int* rt = radix_table + static_cast<size_t>(c) * r;
  if (staged) {  // uniform across the block
    float* s_kk = smem;
    float* s_kp = smem + m;
    int* s_rt = reinterpret_cast<int*>(smem + 2 * m);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      s_kk[i] = kk[i];
      s_kp[i] = kp[i];
    }
    for (int i = threadIdx.x; i < r; i += blockDim.x) s_rt[i] = rt[i];
    __syncthreads();
    kk = s_kk;
    kp = s_kp;
    rt = s_rt;
  }
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  const float qv = q[qi];

  // radix locate: bucket j, knot window [lo, hi]
  float jf = floorf(__fmul_rn(__fsub_rn(qv, kmin[c]), scale[c]));
  jf = fminf(fmaxf(jf, 0.0f), static_cast<float>(1 << radix_bits));
  const int j = static_cast<int>(jf);
  const int lo = rt[j];
  const int hi = min(max(rt[j + 1], lo), max(n_knots[c] - 1, 0));

  // branchless segment locate inside the window
  int succ = lo;
  for (int i = lo; i <= hi; ++i) succ += (kk[i] < qv) ? 1 : 0;
  const int seg = max(succ - 1, 0);
  const int seg1 = min(seg + 1, m - 1);
  const float k0 = kk[seg], k1 = kk[seg1];
  const float p0 = kp[seg], p1 = kp[seg1];

  // interpolation (FMA, as XLA:CPU contracts it) and probe start
  float t = __fdiv_rn(__fsub_rn(qv, k0), fmaxf(__fsub_rn(k1, k0), 1e-30f));
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float phat = __fmaf_rn(t, __fsub_rn(p1, p0), p0);
  int start = static_cast<int>(rintf(phat)) - probe / 2;
  start = min(max(start, 0), n_pad - probe);

  // exact lower bound by compare-count over the probe window
  const float* row = keys_f + static_cast<size_t>(c) * n_pad + start;
  int pos = start;
  for (int i = 0; i < probe; ++i) pos += (row[i] < qv) ? 1 : 0;
  out[static_cast<size_t>(c) * nq + qi] = min(pos, count[c]);
}

}  // namespace

// Launch on `stream`. Shapes: q (nq,); knot_keys/knot_pos (n_parts, m);
// radix_table (n_parts, r); kmin/scale/n_knots/count (n_parts,);
// keys_f (n_parts, n_pad); out (n_parts, nq). Returns cudaGetLastError().
REPRO_EXPORT int spline_search_launch(
    const float* q, int nq, const float* knot_keys, const float* knot_pos,
    int m, const int* radix_table, int r, const float* kmin,
    const float* scale, const int* n_knots, const int* count,
    const float* keys_f, int n_pad, int n_parts, int probe, int radix_bits,
    int* out, void* stream) {
  constexpr int kThreads = 256;
  constexpr size_t kMaxSmem = 200 * 1024;
  const size_t smem = (2 * static_cast<size_t>(m) + r) * sizeof(float);
  const int staged = smem <= kMaxSmem;
  if (staged && smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        spline_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((nq + kThreads - 1) / kThreads, n_parts);
  spline_search_kernel<<<grid, kThreads, staged ? smem : 0,
                         static_cast<cudaStream_t>(stream)>>>(
      q, nq, knot_keys, knot_pos, m, radix_table, r, kmin, scale, n_knots,
      count, keys_f, n_pad, probe, radix_bits, staged, out);
  return static_cast<int>(cudaGetLastError());
}
