// Shared helpers for the voxtpu_torch CUDA kernels.
//
// Every kernel is built into one shared library with a plain C interface
// (voxtpu_torch/ops/kernels.py runs nvcc and binds it with ctypes). Each
// exported launcher takes device pointers and the caller's CUDA stream,
// launches on that stream, never synchronises or allocates, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#define VT_EXPORT extern "C" __attribute__((visibility("default")))

namespace vt {

template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static constexpr double eps = FLT_EPSILON;
};
template <>
struct Limits<double> {
  static constexpr double eps = DBL_EPSILON;
};

__device__ __forceinline__ long clamp_index(long i, long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Sum of a and b over the block, in an order fixed by blockDim alone (warp
// shuffle trees, then warp 0 over the per-warp partials). The result is
// valid in thread 0. `scratch` holds 2 * 32 values; the caller syncs before
// reusing it.
template <typename T>
__device__ void block_sum2(T& a, T& b, T* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    a = lane < nwarps ? scratch[lane] : T(0);
    b = lane < nwarps ? scratch[32 + lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
  }
}

inline int blocks_for(long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace vt
