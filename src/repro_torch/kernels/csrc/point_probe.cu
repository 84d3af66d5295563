// Point probe: equality scan of each query's learned probe window.
//
// Replaces the Pallas kernel src/repro/kernels/point_probe.py
// (point_probe, _kernel). Per query: the number of positions in
// [start, start + probe) of its candidate partition whose key, x and y
// all equal the query's (found iff > 0).
//
// The TPU kernel took windows that the host had gathered into (Q, W)
// planes; this kernel fuses the gather and reads keys_f, x and y at
// (pid, start) directly, so no window plane is written or read back.
// One warp per query; lanes stride over the window.
//
// Bound: bytes — 12 bytes per window slot, three compares each.
#include "common.cuh"

namespace {

__global__ void point_probe_kernel(
    const int* __restrict__ pid, const int* __restrict__ start,
    const float* __restrict__ qk, const float* __restrict__ qx,
    const float* __restrict__ qy, const float* __restrict__ keys_f,
    const float* __restrict__ x, const float* __restrict__ y, int nq,
    int n_parts, int n_pad, int probe, int* __restrict__ out) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (w >= nq) return;  // whole warp leaves together
  // the program clamps both already; clamping again keeps every read
  // inside the planes whatever the caller passes
  const int p = min(max(pid[w], 0), n_parts - 1);
  const int s0 = min(max(start[w], 0), n_pad - probe);
  const size_t base = static_cast<size_t>(p) * n_pad + s0;
  const float k = qk[w], vx = qx[w], vy = qy[w];
  int acc = 0;
  for (int i = lane; i < probe; i += kWarp) {
    const size_t o = base + i;
    acc += (keys_f[o] == k && x[o] == vx && y[o] == vy) ? 1 : 0;
  }
  acc = warp_sum(acc);
  if (lane == 0) out[w] = acc;
}

}  // namespace

// Launch on `stream`. Shapes: pid/start/qk/qx/qy (nq,);
// keys_f/x/y (n_parts, n_pad); out (nq,).
REPRO_EXPORT int point_probe_launch(
    const int* pid, const int* start, const float* qk, const float* qx,
    const float* qy, const float* keys_f, const float* x, const float* y,
    int nq, int n_parts, int n_pad, int probe, int* out, void* stream) {
  constexpr int kThreads = 256;
  constexpr int kQueriesPerBlock = kThreads / kWarp;
  const dim3 grid((nq + kQueriesPerBlock - 1) / kQueriesPerBlock);
  point_probe_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pid, start, qk, qx, qy, keys_f, x, y, nq, n_parts, n_pad, probe, out);
  return static_cast<int>(cudaGetLastError());
}
