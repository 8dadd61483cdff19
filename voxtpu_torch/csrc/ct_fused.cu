// Kernel E: the n-point half power spectrum and the first n lags of
// irfft(|rfft(x, 2n)|^2) of (B, n) real frames in one pass, one thread block
// per frame.
//
// Replaces voxtpu/ops/ct_fused_pallas.py::ct_fused_power_ac (pallas_call at
// ct_fused_pallas.py:222). Semantics are those of its plain version
// (voxtpu_torch/ops/ct_fused.py, rfft -> power -> irfft): with N = 2n and
// X = DFT_N(x zero-padded to N),
//   half[k] = |X[2k]|^2,                       k = 0 .. n/2 (= |DFT_n(x)[k]|^2)
//   ac[l]   = (1/N) sum_k |X[k]|^2 e^{+2 pi i k l / N},   l = 0 .. n-1.
// The reference's seed-quirk correction stays outside (voxtpu_torch.autocorr).
//
// What bounds it: at the bench path's shapes (15,369 frames of 4096, float32)
// the kernel must read 252 MB and write 378 MB: about 0.19 ms of device
// memory at 3.35 TB/s, against about 8 GFLOP, 0.12 ms at 67 TFLOP/s. So
// device memory sets the bound. This first kernel is bound elsewhere: each
// of its 2 log2(N) radix-2 stages reads and writes the whole N-point frame in
// shared memory, with a block barrier between stages, so shared-memory
// traffic and barrier latency set its time.
//
// Design: the frame, zero-padded to N complex values, lives in dynamic
// shared memory as separate real and imaginary arrays (4 n values: 64 KB in
// float32, 128 KB in float64 at n = 4096). The forward transform is
// decimation in frequency (natural order in, bit-reversed order out) and
// its first stage is fused with the load, since the upper half of the input
// is zero. |X|^2 replaces X in place, still bit-reversed; the even bins go
// to `half`. The inverse is decimation in time (bit-reversed in, natural
// out), so no permutation pass is needed, and its last stage writes only
// the n lags asked for. Twiddles w^k = e^{-2 pi i k / N}, k < n, are built
// on the host in float64 and cast (voxtpu_torch/ops/ct_fused.py); they are
// read through the read-only cache. The TPU kernel's four-step matmul
// factorisation, its pre-interleaved input, its 0/1 selection matmul for the
// even bins and its transposed inverse tables were Mosaic workarounds and
// are gone.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can have

template <typename T>
__global__ void ct_fused_kernel(const T* __restrict__ x, const T* __restrict__ tw,
                                T* __restrict__ half, T* __restrict__ ac, int n, int log2N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = 2 * n;
  T* re = reinterpret_cast<T*>(smem_raw);
  T* im = re + N;
  const T* tw_re = tw;
  const T* tw_im = tw + n;
  const T* xr = x + static_cast<long>(blockIdx.x) * n;

  // Forward, decimation in frequency. The first stage (span n) with
  // a[i + n] = 0: a[i] = x[i], a[i + n] = x[i] w^i.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T v = xr[i];
    re[i] = v;
    im[i] = T(0);
    re[i + n] = v * __ldg(tw_re + i);
    im[i + n] = v * __ldg(tw_im + i);
  }
  __syncthreads();
  for (int s = n >> 1; s >= 1; s >>= 1) {
    const int stride = n / s;  // twiddle of a 2s-point sub-transform: w^(j N / 2s)
    for (int b = threadIdx.x; b < n; b += blockDim.x) {
      const int j = b & (s - 1);
      const int i = ((b - j) << 1) + j;
      const T ur = re[i], ui = im[i], vr = re[i + s], vi = im[i + s];
      const T dr = ur - vr, di = ui - vi;
      const T wr = __ldg(tw_re + j * stride), wi = __ldg(tw_im + j * stride);
      re[i] = ur + vr;
      im[i] = ui + vi;
      re[i + s] = dr * wr - di * wi;
      im[i + s] = dr * wi + di * wr;
    }
    __syncthreads();
  }

  // Power, in place and in bit-reversed order.
  for (int p = threadIdx.x; p < N; p += blockDim.x) {
    const T a = re[p], b = im[p];
    re[p] = a * a + b * b;
    im[p] = T(0);
  }
  __syncthreads();
  // The n-point half spectrum: X_n[k] == X_N[2k], which sits at bitrev(2k).
  T* hr = half + static_cast<long>(blockIdx.x) * (n / 2 + 1);
  for (int k = threadIdx.x; k <= n / 2; k += blockDim.x) {
    hr[k] = re[__brev(static_cast<unsigned>(2 * k)) >> (32 - log2N)];
  }
  __syncthreads();

  // Inverse, decimation in time with the conjugate twiddles: spans 1 .. n/2
  // here, the last (span n) fused with the store of lags 0 .. n-1.
  for (int s = 1; s < n; s <<= 1) {
    const int stride = n / s;
    for (int b = threadIdx.x; b < n; b += blockDim.x) {
      const int j = b & (s - 1);
      const int i = ((b - j) << 1) + j;
      const T wr = __ldg(tw_re + j * stride), wi = __ldg(tw_im + j * stride);
      const T ur = re[i], ui = im[i], xr2 = re[i + s], xi2 = im[i + s];
      const T vr = xr2 * wr + xi2 * wi;  // (xr2 + i xi2) * conj(w)
      const T vi = xi2 * wr - xr2 * wi;
      re[i] = ur + vr;
      im[i] = ui + vi;
      re[i + s] = ur - vr;
      im[i + s] = ui - vi;
    }
    __syncthreads();
  }
  const T inv_N = T(1) / static_cast<T>(N);
  T* ar = ac + static_cast<long>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T vr = re[i + n] * __ldg(tw_re + i) + im[i + n] * __ldg(tw_im + i);
    ar[i] = (re[i] + vr) * inv_N;
  }
}

template <typename T>
int launch(const void* x, const void* tw, void* half, void* ac, int B, int n, void* stream) {
  if (n < 128 || (n & (n - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * static_cast<size_t>(n) * sizeof(T);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int log2N = 1;
  while ((1 << log2N) < 2 * n) ++log2N;
  if (B > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          ct_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    ct_fused_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(tw), static_cast<T*>(half),
        static_cast<T*>(ac), n, log2N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VT_EXPORT int vt_ct_fused_f32(const void* x, const void* tw, void* half, void* ac, int B, int n,
                              void* stream) {
  return launch<float>(x, tw, half, ac, B, n, stream);
}

VT_EXPORT int vt_ct_fused_f64(const void* x, const void* tw, void* half, void* ac, int B, int n,
                              void* stream) {
  return launch<double>(x, tw, half, ac, B, n, stream);
}
