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
// What bounds it: operations. Each live slot needs 1 + iters Horner passes
// of N - 1 steps of about 141 operations (the double-T products and sums)
// plus about 23 a Newton step: about 5,500 at N = 14 and 2 iterations,
// against 24 bytes of input and output. At the CLI path's 35,689 x 14 slots
// (463,957 live) that is about 2.6 G operations, 0.038 ms at 67 TFLOP/s.
//
// Design: one thread a (frame, slot) in a flat F x N grid. The plain
// version evaluates 1 + 2 iters passes: one at z0, and two an iteration,
// at the current point before its step and after it. The pass at z0 is the
// first iteration's first pass, and each check pass is at the point the
// next iteration starts from; the same operations on the same values give
// the same bits, so each pass's value and derivative serve both, and the
// kernel makes 1 + iters passes (3 in place of 5) with every output as
// before. For N = kN = 14, the order-13 polynomials of every configuration
// the repo runs, N is a template argument: each thread loads its frame's
// pairs once into registers, with the + 0 of every pass applied there, and
// every loop over them is unrolled. Any other N up to kMaxN = 128 (LPC
// orders up to 127) runs a general instantiation that reads the pairs
// from global memory on each pass, the frame's threads sharing them
// through L1. Every double-T partial stays in registers. Slots that are
// not live skip the work: their output is the input either way. 0.1413 ms
// at CLI shapes before this design, 0.0476 for one pass (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md).
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
constexpr int kN = 14;      // voxtpu_torch.ops.polish._N
constexpr int kMaxN = 128;  // voxtpu_torch.ops.polish._MAX_N
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

// The frame's coefficient pairs (index = power), each with the + 0 the
// plain version's coef(j) adds. Regs holds kN of them in registers, loaded
// once; Global reads them from device memory on each use.
template <typename T, int kCount>
struct Regs {
  T re[kCount], im[kCount];
  __device__ __forceinline__ T cr(int j) const { return re[j]; }
  __device__ __forceinline__ T ci(int j) const { return im[j]; }
};
template <typename T>
struct Global {
  const T* re;
  const T* im;
  __device__ __forceinline__ T cr(int j) const { return re[j] + T(0); }
  __device__ __forceinline__ T ci(int j) const { return im[j] + T(0); }
};

// p(z) (double-T Horner, collapsed) and p'(z) (plain T) of the N pairs of
// c at z; kFixed: N == kFixed, known when compiled, the loop unrolled. The
// derivative's update reads the value partial of the step before.
template <int kFixed, typename T, typename Coef>
__device__ __forceinline__ void horner_df(const Coef& c, int n, T zr, T zi, T& pr, T& pi, T& dpr, T& dpi) {
  const int N = kFixed > 0 ? kFixed : n;
  constexpr int kUnroll = kFixed > 1 ? kFixed - 1 : 1;
  const T zero = T(0);
  DF<T> ar = {c.cr(N - 1), zero};
  DF<T> ai = {c.ci(N - 1), zero};
  T br = zero, bi = zero;
#pragma unroll(kUnroll)
  for (int j = N - 2; j >= 0; --j) {
    const T nbr = ((br * zr) - (bi * zi)) + ar.hi;
    const T nbi = ((br * zi) + (bi * zr)) + ai.hi;
    br = nbr;
    bi = nbi;
    const T nzi = -zi;
    const DF<T> re = df_add(df_mul_f(ar, zr), df_mul_f(ai, nzi));
    const DF<T> im = df_add(df_mul_f(ar, zi), df_mul_f(ai, zr));
    ar = df_add_f(re, c.cr(j));
    ai = df_add_f(im, c.ci(j));
  }
  pr = ar.hi + ar.lo;
  pi = ai.hi + ai.lo;
  dpr = br;
  dpi = bi;
}

// The polished root of one live slot z0: 1 + iters passes, each giving the
// value that decides the step before and the derivative of the step after.
template <int kFixed, typename T, typename Coef>
__device__ __forceinline__ void polish_slot(const Coef& c, int N, T zr0, T zi0, int iters, T ms2, T& out_r,
                                            T& out_i) {
  T pr, pi, dpr, dpi;
  horner_df<kFixed>(c, N, zr0, zi0, pr, pi, dpr, dpi);
  T best_r = zr0, best_i = zi0;
  T best_n = (pr * pr) + (pi * pi);
  T cur_r = zr0, cur_i = zi0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // p(cur) and p'(cur): the last pass was at cur.
    const T den = (dpr * dpr) + (dpi * dpi);
    const T dzr = ((pr * dpr) + (pi * dpi)) / den;
    const T dzi = ((pi * dpr) - (pr * dpi)) / den;
    const bool ok = isfinite(dzr) && isfinite(dzi) && ((dzr * dzr) + (dzi * dzi) <= ms2);
    if (ok) {
      cur_r = cur_r - dzr;
      cur_i = cur_i - dzi;
    }
    horner_df<kFixed>(c, N, cur_r, cur_i, pr, pi, dpr, dpi);
    const T n_new = (pr * pr) + (pi * pi);
    if (n_new < best_n) {
      best_r = cur_r;
      best_i = cur_i;
      best_n = n_new;
    }
  }
  out_r = best_r;
  out_i = best_i;
}

// kRegs: N == kN, the pairs in registers; else any N <= kMaxN from global
// memory.
template <typename T, bool kRegs>
__global__ void __launch_bounds__(kThreads)
    polish_kernel(const T* __restrict__ c_re, const T* __restrict__ c_im, const T* __restrict__ z_re,
                  const T* __restrict__ z_im, T* __restrict__ out_re, T* __restrict__ out_im, long slots, int n_arg,
                  int iters, T ms2) {
  const int N = kRegs ? kN : n_arg;
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
  if constexpr (kRegs) {
    Regs<T, kN> c;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      c.re[j] = cre[j] + T(0);
      c.im[j] = cim[j] + T(0);
    }
    polish_slot<kN>(c, N, zr0, zi0, iters, ms2, out_re[t], out_im[t]);
  } else {
    polish_slot<0>(Global<T>{cre, cim}, N, zr0, zi0, iters, ms2, out_re[t], out_im[t]);
  }
}

template <typename T>
int launch(const void* c_re, const void* c_im, const void* z_re, const void* z_im, void* out_re,
           void* out_im, int F, int N, int iters, double ms2, void* stream) {
  if (F < 0 || N < 1 || N > kMaxN || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long slots = static_cast<long>(F) * N;
  if (slots > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto *cr = static_cast<const T*>(c_re), *ci = static_cast<const T*>(c_im);
    const auto *zr = static_cast<const T*>(z_re), *zi = static_cast<const T*>(z_im);
    auto *orr = static_cast<T*>(out_re), *oi = static_cast<T*>(out_im);
    const int blocks = vt::blocks_for(slots, kThreads);
    if (N == kN) {
      polish_kernel<T, true><<<blocks, kThreads, 0, s>>>(cr, ci, zr, zi, orr, oi, slots, N, iters,
                                                         static_cast<T>(ms2));
    } else {
      polish_kernel<T, false><<<blocks, kThreads, 0, s>>>(cr, ci, zr, zi, orr, oi, slots, N, iters,
                                                          static_cast<T>(ms2));
    }
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
