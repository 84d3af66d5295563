// An empty kernel: what one launch costs on this card, whatever it does.
//
// It replaces no TPU kernel and is on no query path. chip_smoke.py times
// it the way it times the kernels (CUDA events, the stream held busy),
// so a kernel's time per launch can be read against the card's floor.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launch `blocks` blocks of `threads` threads on `stream`.
REPRO_EXPORT int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
