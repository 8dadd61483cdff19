// Kernel B: Burg LPC of order P, one thread block per frame.
//
// Replaces voxtpu/ops/burg_pallas.py::burg_pallas (pallas_call at
// burg_pallas.py:95). Semantics follow voxtpu.lpc.burg, the reference's
// lpc_praat_mut (spectrum.rs:101-146): the forward/backward buffers start as
// b1 = x[0..n-2], b2 = x[1..n-1]; order i sums num = b1.b2 and
// denum = |b1|^2 + |b2|^2 over k < n - i, sets the LPC_DENUM_NONPOS status
// bit when denum <= 0 (and divides by 1 instead), updates the coefficients,
// then b1[k] -= c b2[k] and b2[k] = b2[k+1] - c b1[k+1] with the old b1.
// The result is sign-flipped, as in the reference.
//
// What bounds it: P block reductions over n values (13 x 2205 at the CLI
// default), each followed by one serial coefficient update in thread 0 and
// two block barriers. Device memory is read once per frame (n values) and
// written once (P values). Measured at the 44.1 kHz CLI default (35,689
// frames of 2205, order 13, float32, double sums): 1.6 ms, against 66 ms
// for the plain PyTorch version (NVIDIA H100 80GB HBM3, 700 W).
//
// Design: b1 and b2 live in dynamic shared memory for the whole recursion
// (2 x 2205 x 8 B = 35 KB in f64). The update needs no second buffer:
// storing b2 shifted by one more place per order (logical b2[k] is
// B2[k + i - 1] at order i) turns it into an update of disjoint pairs
// (B1[k], B2[k + i - 1]) that each thread can do in place. The reductions run
// in a fixed order (warp shuffles, then warp 0), so results do not depend on
// the batch. They, and the reflection coefficient, are in double for float
// frames too, as in the plain version (voxtpu_torch/ops/burg.py): float sums
// over 2205 samples in this order and in the plain version's differed enough
// to move a formant of the slice by over 1.4 Hz (NVIDIA H100 80GB HBM3, 700 W).
#include "common.cuh"

namespace {

constexpr int kMaxOrder = 64;
constexpr int kThreads = 256;
constexpr int kStatusLpcDenumNonpos = 1;  // voxtpu_torch.errors.LPC_DENUM_NONPOS

template <typename T>
__global__ void burg_kernel(const T* __restrict__ x, T* __restrict__ coef_out,
                            int* __restrict__ status_out, int N, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* b1 = reinterpret_cast<T*>(smem_raw);  // B1[k] = x[k],     k < N - 1
  T* b2 = b1 + N;                          // B2[k] = x[k + 1], k < N - 1
  __shared__ double scratch[64];
  __shared__ T aa[kMaxOrder];
  __shared__ T cf[kMaxOrder];
  __shared__ T ci_shared;
  __shared__ int bad;

  const T* xr = x + static_cast<long>(blockIdx.x) * N;
  for (int k = threadIdx.x; k < N - 1; k += blockDim.x) {
    b1[k] = xr[k];
    b2[k] = xr[k + 1];
  }
  if (threadIdx.x == 0) {
    for (int j = 0; j < P; ++j) {
      aa[j] = T(0);
      cf[j] = T(0);
    }
    bad = 0;
  }
  __syncthreads();

  for (int i = 1; i <= P; ++i) {
    const int m = N - i;    // active sample count this order
    const int shift = i - 1;  // logical b2[k] == b2[k + shift]
    double num = 0.0;
    double den = 0.0;
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      const double u = b1[k];
      const double v = b2[k + shift];
      num += u * v;
      den += u * u + v * v;
    }
    vt::block_sum2(num, den, scratch);
    if (threadIdx.x == 0) {
      const bool is_bad = den <= 0.0;
      if (is_bad) bad = 1;
      const T ci = static_cast<T>(2.0 * num / (is_bad ? 1.0 : den));
      for (int j = 1; j < i; ++j) cf[j - 1] = aa[j - 1] - ci * aa[i - j - 1];
      cf[i - 1] = ci;
      if (i < P) {
        for (int j = 0; j < i; ++j) aa[j] = cf[j];
      }
      ci_shared = ci;
    }
    __syncthreads();
    if (i < P) {
      // new b1[k] = b1[k] - c b2[k]; new b2[k-1] = b2[k] - c b1[k]: both read
      // only the pair (B1[k], B2[k + shift]), so the update is in place.
      const T c = ci_shared;
      for (int k = threadIdx.x; k < m; k += blockDim.x) {
        const T u = b1[k];
        const T v = b2[k + shift];
        b1[k] = u - c * v;
        b2[k + shift] = v - c * u;
      }
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    T* out = coef_out + static_cast<long>(blockIdx.x) * P;
    for (int j = 0; j < P; ++j) out[j] = -cf[j];
    status_out[blockIdx.x] = bad ? kStatusLpcDenumNonpos : 0;
  }
}

template <typename T>
int launch(const void* x, void* coef, void* status, int B, int N, int P, void* stream) {
  if (P < 1 || P > kMaxOrder || N < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const size_t smem = 2 * static_cast<size_t>(N) * sizeof(T);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          burg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    burg_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(coef), static_cast<int*>(status), N, P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VT_EXPORT int vt_burg_f32(const void* x, void* coef, void* status, int B, int N, int P,
                          void* stream) {
  return launch<float>(x, coef, status, B, N, P, stream);
}

VT_EXPORT int vt_burg_f64(const void* x, void* coef, void* status, int B, int N, int P,
                          void* stream) {
  return launch<double>(x, coef, status, B, N, P, stream);
}
