// Morton (Z-order) bit interleave of quantized coordinates.
//
// Replaces the Pallas kernel src/repro/kernels/morton.py
// (morton_encode_2d, _morton_kernel; wrapper kernels/ops.py:
// morton_encode): out = spread(qx) | (spread(qy) << 1) in uint32, where
// spread moves the low 16 bits of its argument to the even bit
// positions. The port keeps keys in int64, so the kernel reads int64
// values holding uint32 ones (the low 32 bits are taken, as a cast to
// uint32 takes them) and writes the uint32 key zero-extended to int64.
//
// The TPU kernel worked on (8, 128) uint32 tiles of a padded (rows, 128)
// array. Here it is an elementwise grid-stride pass over the flat
// arrays; the ragged edge is masked, so nothing is padded. The inputs are
// integers, so there is no float32 denormal to flush (common.cuh daz).
//
// Bound: bytes. 24 bytes per point (two int64 in, one int64 out) and
// about 25 integer operations: at 2^23 points 0.060 ms over 3.35 TB/s.
// The design does what a byte-bound pass can: each thread moves 16
// bytes per load and store (longlong2, two points), neighbouring
// threads on neighbouring addresses, so every warp access is a fully
// coalesced 512-byte transaction; the grid is capped at a few blocks
// per SM and strides, so no block is launched for a handful of points.
#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t spread(uint32_t v) {
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

__device__ __forceinline__ long long encode(long long x, long long y) {
  const uint32_t key = spread(static_cast<uint32_t>(x)) |
                       (spread(static_cast<uint32_t>(y)) << 1);
  return static_cast<long long>(key);
}

// n points; the first 2 * (n / 2) as longlong2 pairs, the odd last one
// by the first thread.
__global__ void morton_kernel(const long long* __restrict__ qx,
                              const long long* __restrict__ qy,
                              long long* __restrict__ out, long long n) {
  const long long pairs = n / 2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const longlong2* px = reinterpret_cast<const longlong2*>(qx);
  const longlong2* py = reinterpret_cast<const longlong2*>(qy);
  longlong2* po = reinterpret_cast<longlong2*>(out);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < pairs; i += stride) {
    const longlong2 a = px[i];
    const longlong2 b = py[i];
    po[i] = make_longlong2(encode(a.x, b.x), encode(a.y, b.y));
  }
  if ((n & 1) && blockIdx.x == 0 && threadIdx.x == 0)
    out[n - 1] = encode(qx[n - 1], qy[n - 1]);
}

}  // namespace

// Launch on `stream`. qx, qy, out: (n,) int64, 16-byte aligned (the
// wrapper checks).
REPRO_EXPORT int morton_encode_launch(const long long* qx,
                                      const long long* qy, long long* out,
                                      long long n, void* stream) {
  constexpr int kThreads = 256;
  // two waves of the 8 resident 256-thread blocks per SM of an H100
  constexpr long long kMaxBlocks = 132 * 16;
  const long long pairs = (n / 2 > 0) ? n / 2 : 1;
  long long blocks = (pairs + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  morton_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(qx, qy, out, n);
  return static_cast<int>(cudaGetLastError());
}
