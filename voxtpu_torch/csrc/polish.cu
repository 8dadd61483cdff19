// Kernel P: the compensated-Newton root polish, one thread a root slot.
//
// The counterpart of voxtpu/roots.py::polish_roots (roots.py:370). There it
// is jnp, which XLA fuses into one program: no pallas_call. Eager PyTorch
// runs the same arithmetic as about 9,300 elementwise launches a call, so
// the port runs it as this one kernel. Semantics follow the plain version
// (voxtpu_torch/ops/polish.py::polish_roots_plain) op for op, so every
// output is bit-identical to it, in float32 and float64:
//   for each root slot z0 of frame f, with p the frame's polynomial:
//     best = z0, n(best) = |p(z0)|^2 in double-T Horner, collapsed
//     twice: dz = p(z) / p'(z); step if finite and |dz|^2 <= max_step^2;
//            keep z as best when |p(z)|^2 < n(best)
//   a slot whose z0 is 0 + 0i is returned as it is.
//
// What bounds it: operations. Each live slot does 5 Horner passes of
// N - 1 steps of about 141 operations (the double-T products and sums)
// plus about 55 for the Newton glue: about 9,200 at N = 14, against 24
// bytes of input and output. At the CLI path's 35,689 x 14 slots that is
// about 4.6 GFLOP, 0.07 ms at 67 TFLOP/s.
//
// Design: one thread a (frame, slot) in a flat F x N grid. Each thread
// reads its frame's N coefficient pairs from global memory on every pass;
// the frame's N threads share them through L1. Every double-T partial stays
// in registers. Slots that are not live skip the work: their output is the
// input either way.
//
// Where the rounding must match the plain version:
// - Association as PyTorch evaluates left to right: e + x1 + y1 is
//   (e + x1) + y1, br zr - bi zi + a0 is ((br zr) - (bi zi)) + a0, and the
//   two_prod error term is ((((ah bh - p) + ah bl) + al bh) + al bl).
// - coef(j) adds +0: a -0.0 coefficient becomes +0.0 as in the plain
//   version (x + 0 is not folded without fast-math).
// - _df_mul_f(ai, -zi) negates before the product.
// - No contraction (the library is built --fmad=false) and IEEE division
//   (nvcc's default -prec-div=true).
// - The split constant is kSplit = 4097 in both dtypes, as the plain
//   version's _SPLIT (a CPU test checks they agree); max_step^2 arrives as
//   a double and is rounded to T, as PyTorch rounds a Python scalar
//   against a float32 tensor.
// - better = n_new < best_n is false for NaN; a step needs both parts
//   finite and dzr^2 + dzi^2 <= max_step^2.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr double kSplit = 4097.0;

// A double-T value: hi + lo.
template <typename T>
struct DF {
  T hi, lo;
};

template <typename T>
__device__ __forceinline__ DF<T> two_sum(T a, T b) {
  const T s = a + b;
  const T bb = s - a;
  return {s, (a - (s - bb)) + (b - bb)};
}

template <typename T>
__device__ __forceinline__ DF<T> quick_two_sum(T a, T b) {
  const T s = a + b;
  return {s, b - (s - a)};
}

template <typename T>
__device__ __forceinline__ DF<T> two_prod(T a, T b) {
  const T split = static_cast<T>(kSplit);
  const T p = a * b;
  const T ca = a * split;
  const T ah = ca - (ca - a);
  const T al = a - ah;
  const T cb = b * split;
  const T bh = cb - (cb - b);
  const T bl = b - bh;
  return {p, ((((ah * bh) - p) + (ah * bl)) + (al * bh)) + (al * bl)};
}

template <typename T>
__device__ __forceinline__ DF<T> df_add(DF<T> x, DF<T> y) {
  const DF<T> s = two_sum(x.hi, y.hi);
  return quick_two_sum(s.hi, (s.lo + x.lo) + y.lo);
}

template <typename T>
__device__ __forceinline__ DF<T> df_add_f(DF<T> x, T f) {
  const DF<T> s = two_sum(x.hi, f);
  return quick_two_sum(s.hi, s.lo + x.lo);
}

template <typename T>
__device__ __forceinline__ DF<T> df_mul_f(DF<T> x, T f) {
  const DF<T> p = two_prod(x.hi, f);
  return quick_two_sum(p.hi, p.lo + (x.lo * f));
}

// p(z) (double-T Horner, collapsed) and p'(z) (plain T) of the polynomial
// c[0..N) at z. The derivative's update reads the value partial of the
// step before.
template <typename T>
__device__ __forceinline__ void horner_df(const T* __restrict__ cre, const T* __restrict__ cim, int N,
                                          T zr, T zi, T& pr, T& pi, T& dpr, T& dpi) {
  const T zero = T(0);
  DF<T> ar = {cre[N - 1] + zero, zero};
  DF<T> ai = {cim[N - 1] + zero, zero};
  T br = zero, bi = zero;
  for (int j = N - 2; j >= 0; --j) {
    const T nbr = ((br * zr) - (bi * zi)) + ar.hi;
    const T nbi = ((br * zi) + (bi * zr)) + ai.hi;
    br = nbr;
    bi = nbi;
    const T nzi = -zi;
    const DF<T> re = df_add(df_mul_f(ar, zr), df_mul_f(ai, nzi));
    const DF<T> im = df_add(df_mul_f(ar, zi), df_mul_f(ai, zr));
    const T cr = cre[j] + zero;
    const T ci = cim[j] + zero;
    ar = df_add_f(re, cr);
    ai = df_add_f(im, ci);
  }
  pr = ar.hi + ar.lo;
  pi = ai.hi + ai.lo;
  dpr = br;
  dpi = bi;
}

template <typename T>
__global__ void polish_kernel(const T* __restrict__ c_re, const T* __restrict__ c_im,
                              const T* __restrict__ z_re, const T* __restrict__ z_im,
                              T* __restrict__ out_re, T* __restrict__ out_im, long slots, int N,
                              int iters, T ms2) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= slots) return;
  const T zr0 = z_re[t];
  const T zi0 = z_im[t];
  if (!(zr0 != T(0) || zi0 != T(0))) {
    out_re[t] = zr0;
    out_im[t] = zi0;
    return;
  }
  const long row = t / N;
  const T* cre = c_re + row * N;
  const T* cim = c_im + row * N;

  T pr, pi, dpr, dpi;
  horner_df(cre, cim, N, zr0, zi0, pr, pi, dpr, dpi);
  T best_r = zr0, best_i = zi0;
  T best_n = (pr * pr) + (pi * pi);
  T cur_r = zr0, cur_i = zi0;
  for (int it = 0; it < iters; ++it) {
    horner_df(cre, cim, N, cur_r, cur_i, pr, pi, dpr, dpi);
    const T den = (dpr * dpr) + (dpi * dpi);
    const T dzr = ((pr * dpr) + (pi * dpi)) / den;
    const T dzi = ((pi * dpr) - (pr * dpi)) / den;
    const bool ok = isfinite(dzr) && isfinite(dzi) && ((dzr * dzr) + (dzi * dzi) <= ms2);
    if (ok) {
      cur_r = cur_r - dzr;
      cur_i = cur_i - dzi;
    }
    T prn, pin, unused_r, unused_i;
    horner_df(cre, cim, N, cur_r, cur_i, prn, pin, unused_r, unused_i);
    const T n_new = (prn * prn) + (pin * pin);
    if (n_new < best_n) {
      best_r = cur_r;
      best_i = cur_i;
      best_n = n_new;
    }
  }
  out_re[t] = best_r;
  out_im[t] = best_i;
}

template <typename T>
int launch(const void* c_re, const void* c_im, const void* z_re, const void* z_im, void* out_re,
           void* out_im, int F, int N, int iters, double ms2, void* stream) {
  if (F < 0 || N < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long slots = static_cast<long>(F) * N;
  if (slots > 0) {
    polish_kernel<T><<<vt::blocks_for(slots, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(c_re), static_cast<const T*>(c_im), static_cast<const T*>(z_re),
        static_cast<const T*>(z_im), static_cast<T*>(out_re), static_cast<T*>(out_im), slots, N, iters,
        static_cast<T>(ms2));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VT_EXPORT int vt_polish_f32(const void* c_re, const void* c_im, const void* z_re, const void* z_im,
                            void* out_re, void* out_im, int F, int N, int iters, double ms2,
                            void* stream) {
  return launch<float>(c_re, c_im, z_re, z_im, out_re, out_im, F, N, iters, ms2, stream);
}

VT_EXPORT int vt_polish_f64(const void* c_re, const void* c_im, const void* z_re, const void* z_im,
                            void* out_re, void* out_im, int F, int N, int iters, double ms2,
                            void* stream) {
  return launch<double>(c_re, c_im, z_re, z_im, out_re, out_im, F, N, iters, ms2, stream);
}
