// Shared by every kernel library: export macro, warp reduction, and the
// error-string lookup the Python wrappers use when a launch fails.
#pragma once

#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(kFullMask, v, off);
  return v;  // lane 0 holds the total
}

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
