// Probes of the rates that bound kernel B (voxtpu_torch/csrc/burg.cu), for
// tools/burg_split.py: float -> double conversions (cvt.f64.f32), float64
// fused multiply-adds and 32-bit shared-memory loads, each per clock and SM.
//
// Each probe runs kChains independent dependency chains a thread, `iters`
// steps each, over a grid that fills the card. Thread 0 of block 0 records
// its SM clock cycles and its global-timer nanoseconds across the loop, so
// the caller can turn the wall time into clocks. The values are written
// out so that nothing is optimised away.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kChains = 8;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Stamp {
  long long clock0;
  unsigned long long ns0;
  __device__ void start() {
    clock0 = clock64();
    ns0 = global_ns();
  }
  __device__ void stop(long long* out) {
    if (threadIdx.x == 0 && blockIdx.x == 0) {
      out[0] = clock64() - clock0;
      out[1] = static_cast<long long>(global_ns() - ns0);
    }
  }
};

// One conversion a step: the next input is the high word of the double,
// read as a float (a register move, no other pipe).
__global__ void cvt_kernel(float seed, int iters, float* out, long long* stamp) {
  float x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c] = seed + static_cast<float>(threadIdx.x + c);
  Stamp s;
  s.start();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      double d;
      asm volatile("cvt.f64.f32 %0, %1;" : "=d"(d) : "f"(x[c]));
      x[c] = __int_as_float(__double2hiint(d));
    }
  }
  s.stop(stamp);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc += x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__global__ void dfma_kernel(double a, double b, int iters, float* out, long long* stamp) {
  double x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c] = static_cast<double>(threadIdx.x + c);
  Stamp s;
  s.start();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) x[c] = fma(x[c], a, b);
  }
  s.stop(stamp);
  double acc = 0.0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc += x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<float>(acc);
}

// One conversion and one float64 FMA a step, on independent chains: at the
// conversion rate if the two run on separate pipes, slower if they share.
__global__ void cvt_dfma_kernel(float seed, double a, double b, int iters, float* out, long long* stamp) {
  float x[kChains];
  double y[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    x[c] = seed + static_cast<float>(threadIdx.x + c);
    y[c] = static_cast<double>(threadIdx.x + c);
  }
  Stamp s;
  s.start();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      double d;
      asm volatile("cvt.f64.f32 %0, %1;" : "=d"(d) : "f"(x[c]));
      x[c] = __int_as_float(__double2hiint(d));
      y[c] = fma(y[c], a, b);
    }
  }
  s.stop(stamp);
  double acc = 0.0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc += x[c] + y[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<float>(acc);
}

// Lane l of each load reads word l + 32 c: one wavefront a warp load. The
// loads are volatile, so that ptxas cannot drop the ones that repeat an
// address; the sums run on the float32 pipe.
__global__ void lds_kernel(int iters, float* out, long long* stamp) {
  __shared__ float buf[32 * kChains];
  for (int i = threadIdx.x; i < 32 * kChains; i += blockDim.x) buf[i] = static_cast<float>(i);
  __syncthreads();
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(buf)) + 4u * (threadIdx.x & 31u);
  float acc[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc[c] = 0.0f;
  Stamp s;
  s.start();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      float v;
      asm volatile("ld.volatile.shared.f32 %0, [%1];" : "=f"(v) : "r"(base + 128u * c));
      acc[c] += v;
    }
  }
  s.stop(stamp);
  float total = 0.0f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) total += acc[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = total;
}

}  // namespace

// probe: 0 conversions, 1 float64 FMAs, 2 shared loads, 3 a conversion and
// an FMA a step (counted as one operation). Returns the number
// of operations (per lane) each thread does, or -1 for an unknown probe;
// the launch error is left for cudaGetLastError.
EXPORT long long burg_rates_probe(int probe, int blocks, int threads, int iters, void* out, void* stamp,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  long long* s = static_cast<long long*>(stamp);
  switch (probe) {
    case 0: cvt_kernel<<<blocks, threads, 0, st>>>(1.5f, iters, o, s); break;
    case 1: dfma_kernel<<<blocks, threads, 0, st>>>(0.9999999, 1e-3, iters, o, s); break;
    case 2: lds_kernel<<<blocks, threads, 0, st>>>(iters, o, s); break;
    case 3: cvt_dfma_kernel<<<blocks, threads, 0, st>>>(1.5f, 0.9999999, 1e-3, iters, o, s); break;
    default: return -1;
  }
  return static_cast<long long>(iters) * kChains;
}

EXPORT int burg_rates_error() { return static_cast<int>(cudaGetLastError()); }
