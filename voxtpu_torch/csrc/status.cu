// CUDA error names for the Python wrappers' exceptions
// (voxtpu_torch/ops/kernels.py raises with this text when a launcher
// returns a nonzero cudaError_t).
#include "common.cuh"

VT_EXPORT const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
