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

// mbarriers and bulk copies (sm_90): a barrier lives in shared memory; a
// bulk copy from device memory into shared memory counts its bytes on one.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Arrives on `bar` and makes its current phase wait for `bytes` more.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

inline int blocks_for(long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace vt
