// Kernel G: the pitch pre-stage, one thread block per frame.
//
// Replaces voxtpu/ops/pitch_pre_pallas.py::pitch_pre_pallas (pallas_call at
// pitch_pre_pallas.py:143). Semantics follow the plain version
// (voxtpu_torch/ops/pitch_pre.py, steps 1-3 of voxtpu.pitch's pitch_frames,
// periodic.rs:400-439) op for op, so every output is bit-identical to it:
//   s[l]      = (ac[l] / max|ac|) / hl[l], zeroed where not finite
//   self_lag  = s followed by n zeros                              (B, 2n)
//   for lags 1 <= l <= bi - 2:
//     is_max  = s[l-1] < s[l] > s[l+1]
//     freq    = (1 / (l + 0.5 (s[l+1] - s[l-1]) / (2 s[l] - (s[l-1] - s[l+1])))) * sr
//     cand    = is_max & (freq == 0 | fmin < freq < fmax)
//   freq (B, bi) zeroed outside cand, cand (B, bi) as bytes; lags 0 and
//   bi - 1 are never candidates.
//
// What bounds it: bytes. It reads the (B, n) lags once and writes 2n + bi
// values and bi flags a frame (about 0.91 GB at the bench path's 15,369
// frames of 4096 in float32: 0.27 ms at 3.35 TB/s); it does about ten
// operations a lag.
//
// Design: pass 1 reduces max|ac| over the block; pass 2 writes self_lag;
// pass 3 takes one lag a thread and recomputes s at l - 1, l and l + 1 from
// ac (the same operations, so the same bits), reading them again from L1
// instead of staging the row in shared memory, so every n runs, the CLI
// path's 2205 included. The TPU kernel's 0/1 shift matmuls and 128-lane tile
// walk existed only because Mosaic cannot load lane-misaligned neighbours,
// and its shape gate with them.
//
// Where the rounding must match the plain version:
// - NaN in the max: torch.amax propagates NaN, fmax/fmaxf drop it. A frame
//   whose lags hold a NaN must give an all-zero row, so the max is taken
//   with a NaN-propagating compare (nan_max).
// - sr, fmin and fmax arrive as T, cast on the host side of the launch: in
//   PyTorch a Python float against a float32 tensor is rounded to float32
//   first.
// - `sample_rate / x` in PyTorch is `x.reciprocal() * sample_rate`
//   (Tensor.__rtruediv__), so the frequency is (1 / x) * sr, not sr / x.
// - No contraction (the library is built --fmad=false) and IEEE division
//   (nvcc's default -prec-div=true): 2 s - (a - b) and 0.5 (b - a) round as
//   the plain version does, and the strict 3-point compare is exactly where
//   one ulp flips a candidate.
// - Degenerate rows: an all-zero frame gives 0 / 0 and a tiny hl[l] gives
//   inf; both become 0 before anything reads them, so no NaN reaches kernel
//   A (the corpus block's padding frames are all zero).
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// max(a, b) where a NaN on either side wins, as torch.amax.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (isnan(b) || b > a) ? b : a;
}

// s[l]: normalised by the frame's max, divided by the lag window, zeroed
// where not finite. Two divisions in the plain version's order.
template <typename T>
__device__ __forceinline__ T normed(const T* ac, const T* hl, T m, int l) {
  const T s = (ac[l] / m) / hl[l];
  return isfinite(s) ? s : T(0);
}

template <typename T>
__global__ void pitch_pre_kernel(const T* __restrict__ ac, const T* __restrict__ hl,
                                 T* __restrict__ self_lag, T* __restrict__ freq,
                                 unsigned char* __restrict__ cand, int n, int bi, T sr, T fmin,
                                 T fmax) {
  __shared__ T partial[32];
  __shared__ T row_max;

  const long row = blockIdx.x;
  const T* a = ac + row * n;
  T* sl = self_lag + row * 2 * n;
  T* fr = freq + row * bi;
  unsigned char* cd = cand + row * bi;

  // Pass 1: max |ac| over the frame.
  T m = T(0);
  for (int l = threadIdx.x; l < n; l += blockDim.x) m = nan_max(m, fabs(a[l]));
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_down_sync(0xffffffffu, m, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    m = lane < nwarps ? partial[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_down_sync(0xffffffffu, m, off));
    if (lane == 0) row_max = m;
  }
  __syncthreads();
  m = row_max;

  // Pass 2: the lag buffer and its zero upper half.
  for (int l = threadIdx.x; l < n; l += blockDim.x) {
    sl[l] = normed(a, hl, m, l);
    sl[n + l] = T(0);
  }

  // Pass 3: maxima, parabolic frequency and band filter over lags [0, bi).
  for (int l = threadIdx.x; l < bi; l += blockDim.x) {
    T f = T(0);
    bool c = false;
    if (l >= 1 && l <= bi - 2) {
      const T left = normed(a, hl, m, l - 1);
      const T mid = normed(a, hl, m, l);
      const T right = normed(a, hl, m, l + 1);
      const bool is_max = left < mid && right < mid;
      const T dr = T(0.5) * (right - left);
      const T d2r = T(2) * mid - (left - right);
      const T q = (T(1) / (static_cast<T>(l) + dr / d2r)) * sr;
      c = is_max && (q == T(0) || (q > fmin && q < fmax));
      f = c ? q : T(0);
    }
    fr[l] = f;
    cd[l] = c ? 1 : 0;
  }
}

template <typename T>
int launch(const void* ac, const void* hl, void* self_lag, void* freq, void* cand, int B, int n,
           int bi, double sr, double fmin, double fmax, void* stream) {
  if (n < 1 || bi < 0 || bi > n) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    pitch_pre_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(ac), static_cast<const T*>(hl), static_cast<T*>(self_lag),
        static_cast<T*>(freq), static_cast<unsigned char*>(cand), n, bi, static_cast<T>(sr),
        static_cast<T>(fmin), static_cast<T>(fmax));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VT_EXPORT int vt_pitch_pre_f32(const void* ac, const void* hl, void* self_lag, void* freq,
                               void* cand, int B, int n, int bi, double sr, double fmin,
                               double fmax, void* stream) {
  return launch<float>(ac, hl, self_lag, freq, cand, B, n, bi, sr, fmin, fmax, stream);
}

VT_EXPORT int vt_pitch_pre_f64(const void* ac, const void* hl, void* self_lag, void* freq,
                               void* cand, int B, int n, int bi, double sr, double fmin,
                               double fmax, void* stream) {
  return launch<double>(ac, hl, self_lag, freq, cand, B, n, bi, sr, fmin, fmax, stream);
}
