// An empty kernel, for timing the floor that a launch of a given grid costs
// on the card (sm_90a), against which the port's small kernels are judged.
// chip_smoke.py builds and launches it through the same ctypes path as the
// port's kernels; nothing on a ported path loads it.
//
// C interface (bound with ctypes): empty_launch launches on `stream`, does
// not synchronise, and returns cudaGetLastError() of its launch (or
// cudaErrorInvalidValue for a grid it does not take).

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" const char* launch_floor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// An empty kernel of `blocks` blocks of `threads` threads.
extern "C" int empty_launch(int blocks, int threads, cudaStream_t stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
