// Shared by every kernel library: export macro, warp reduction, the
// float32 reads and ops of XLA:CPU's denormal mode, and the error-string
// lookup the Python wrappers use when a launch fails.
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

// XLA:CPU, which runs the reference, reads every float32 denormal input
// of an arithmetic op or a compare as zero (1e-45 == 0.0), and writes
// zero for every result whose value, rounded to 24 bits with an unbounded
// exponent, lies below 2^-126 (tininess after rounding). CUDA keeps
// denormals (the kernels are built without -ftz=true, so the rule stands
// in the source): a kernel reads each loaded coordinate through daz and
// computes each value that can fall below 2^-126 with the ops below,
// whose inputs are already read through daz. The plain versions do the
// same (src/repro_torch/_num.py).
constexpr float kLeastNormal = 1.17549435e-38f;  // 2^-126

// a float32 value as XLA:CPU reads it: a denormal is zero, of its sign
__device__ __forceinline__ float daz(float v) {
  return fabsf(v) < kLeastNormal ? __fmul_rn(v, 0.0f) : v;
}

// XLA:CPU's flush of r, an op's rounded result, where |r| <= 2^-126: r4 is
// the same op with its first input (and addend) times 4, which lies in
// the normal range wherever the rule decides and so is rounded to 24 bits
// there. r rounds on the denormal grid and differs from the rule only on
// [2^-126 - 2^-150, 2^-126 - 2^-151), where it rounds up to 2^-126. An
// overflowing 4a gives an infinite or NaN r4 only where r is not tiny.
__device__ __forceinline__ float ftz(float r, float r4) {
  return fabsf(r4) < 4.0f * kLeastNormal ? __fmul_rn(r, 0.0f) : r;
}

// a - b: a difference below 2^-125 of two floats is exact (both are
// multiples of 2^-149), so flushing the rounded result is the rule
__device__ __forceinline__ float sub_ftz(float a, float b) {
  return daz(__fsub_rn(a, b));
}

__device__ __forceinline__ float mul_ftz(float a, float b) {
  const float r = __fmul_rn(a, b);
  if (fabsf(r) > kLeastNormal) return r;
  return ftz(r, __fmul_rn(__fmul_rn(4.0f, a), b));
}

__device__ __forceinline__ float div_ftz(float a, float b) {
  const float r = __fdiv_rn(a, b);
  if (fabsf(r) > kLeastNormal) return r;
  return ftz(r, __fdiv_rn(__fmul_rn(4.0f, a), b));
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  const float r = __fmaf_rn(a, b, c);
  if (fabsf(r) > kLeastNormal) return r;
  return ftz(r, __fmaf_rn(__fmul_rn(4.0f, a), b, __fmul_rn(4.0f, c)));
}

// fma(dx, dx, dy*dy), XLA:CPU's contraction of dx*dx + dy*dy, with dy*dy
// and the sum flushed. dx and dy need no daz, nor their coordinates: a
// difference differs from that of the flushed coordinates only where
// both are below 2^-101, and a square below 2^-202 moves neither the
// flushed dy*dy nor the FMA's rounding. One compare and a branch that is
// taken only when dy*dy is at most 2^-126 (the sum is then at least it).
__device__ __forceinline__ float dist2_ftz(float dx, float dy) {
  const float yy = __fmul_rn(dy, dy);
  if (yy > kLeastNormal) return __fmaf_rn(dx, dx, yy);
  return fma_ftz(dx, dx, mul_ftz(dy, dy));
}

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
