// Kernel C: all roots of each frame's complex polynomial, one thread per
// polynomial.
//
// Replaces voxtpu/ops/roots_pallas.py::find_roots_pallas (pallas_call at
// roots_pallas.py:230). Semantics follow voxtpu.roots.find_roots, the
// reference's polynomial.rs:34-152: leading zero coefficients shift out as
// zero roots; for each of the first m0 - 2 deflation rounds (m0 = degree -
// lowest nonzero index), 20 fixed Laguerre iterations from (-2, -2) with the
// constant-n quirk (n = m0 throughout), freezing once |p(z)| <= 1e-16, then
// synthetic division by (x - z); a zero root sets POLY_DIV_ZERO and stops
// later rounds; the last quadratic or linear factor is solved in closed
// form. The complex square root is the polar form with atan2, as in
// voxtpu.cplx.csqrt, so the TPU kernel's algebraic form (forced by Mosaic's
// missing atan2, PARITY deviation 10a) is gone from the port.
//
// What bounds it: arithmetic and latency in one thread. At order 13 (N = 14)
// a polynomial takes 11 rounds x 20 iterations x a 13-step complex Horner
// triple plus the Laguerre update, about 50 k flops, with no reuse across
// threads. 35,689 frames give 35,689 threads: about 270 resident per SM,
// so the card is far from full. Measured at the 44.1 kHz CLI default
// (float32): 0.5 ms, against 602-641 ms for the plain PyTorch version
// (NVIDIA H100 80GB HBM3, 700 W).
//
// Design: coefficients, the deflated work polynomial and the roots live in
// per-thread arrays (N <= 32 complex values each). Rounds that the plain
// version would mask off are skipped: their Laguerre result is never used.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kMaxN = 32;
constexpr int kLaguerreIters = 20;
constexpr int kStatusZeroDegree = 1 << 1;  // voxtpu_torch.errors.POLY_ZERO_DEGREE
constexpr int kStatusDivZero = 1 << 2;     // voxtpu_torch.errors.POLY_DIV_ZERO

template <typename T>
struct Cx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ Cx<T> cadd(Cx<T> a, Cx<T> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename T>
__device__ __forceinline__ Cx<T> csub(Cx<T> a, Cx<T> b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename T>
__device__ __forceinline__ Cx<T> cmul(Cx<T> a, Cx<T> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <typename T>
__device__ __forceinline__ Cx<T> cdiv(Cx<T> a, Cx<T> b) {
  const T nrm = b.re * b.re + b.im * b.im;
  return {(a.re * b.re + a.im * b.im) / nrm, (a.im * b.re - a.re * b.im) / nrm};
}
template <typename T>
__device__ __forceinline__ T cnorm(Cx<T> a) {
  return hypot(a.re, a.im);
}
template <typename T>
__device__ __forceinline__ Cx<T> csqrt(Cx<T> a) {
  const T r = sqrt(cnorm(a));
  const T theta = atan2(a.im, a.re) * T(0.5);
  return {r * cos(theta), r * sin(theta)};
}

template <typename T>
__device__ Cx<T> laguerre(const Cx<T>* c, int N, T n) {
  const Cx<T> n_c{n, T(0)};
  const Cx<T> nm1_c{n - T(1), T(0)};
  const Cx<T> two{T(2), T(0)};
  Cx<T> z{T(-2), T(-2)};
  bool done = false;
  for (int it = 0; it < kLaguerreIters; ++it) {
    // p, p' and the p''/2 accumulator (polynomial.rs:39-45).
    Cx<T> a = c[N - 1];
    Cx<T> b{T(0), T(0)};
    Cx<T> g{T(0), T(0)};
    for (int j = N - 2; j >= 0; --j) {
      g = cadd(cmul(g, z), b);
      b = cadd(cmul(b, z), a);
      a = cadd(cmul(a, z), c[j]);
    }
    done = done || cnorm(a) <= T(1e-16);
    const Cx<T> ca = cdiv(Cx<T>{-b.re, -b.im}, a);
    const Cx<T> ca2 = cmul(ca, ca);
    const Cx<T> cb = csub(ca2, cdiv(cmul(two, g), a));
    const Cx<T> c1 = csqrt(csub(cmul(cmul(nm1_c, n_c), cb), ca2));
    const Cx<T> cc1 = cadd(ca, c1);
    const Cx<T> cc2 = csub(ca, c1);
    const Cx<T> denom = cnorm(cc1) > cnorm(cc2) ? cc1 : cc2;
    const Cx<T> step = cdiv(n_c, denom);
    if (!done) z = cadd(z, step);
  }
  return z;
}

template <typename T>
__global__ void roots_kernel(const T* __restrict__ c_re, const T* __restrict__ c_im,
                             T* __restrict__ r_re, T* __restrict__ r_im, int* __restrict__ count,
                             int* __restrict__ status_out, int B, int N) {
  const long row = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (row >= B) return;
  const long base = row * N;

  // degree: highest nonzero index (0 if none); off_low: lowest (N - 1 if
  // none), polynomial.rs:26-32.
  Cx<T> c[kMaxN];
  int deg = 0;
  int low = N - 1;
  for (int j = N - 1; j >= 0; --j) {
    c[j] = {c_re[base + j], c_im[base + j]};
    if (c[j].re != T(0) || c[j].im != T(0)) {
      if (deg == 0) deg = j;
      low = j;
    }
  }
  int status = deg < 1 ? kStatusZeroDegree : 0;
  const int m0 = deg - low;

  Cx<T> work[kMaxN];
  Cx<T> roots[kMaxN];
  for (int j = 0; j < N; ++j) {
    work[j] = j + low < N ? c[j + low] : Cx<T>{T(0), T(0)};
    roots[j] = {T(0), T(0)};
  }

  const T n_lag = static_cast<T>(m0);
  const int rounds = N - 3 > 0 ? N - 3 : 0;
  for (int it = 0; it < rounds; ++it) {
    if (!(it < m0 - 2 && status == 0)) continue;
    const Cx<T> z = laguerre(work, N, n_lag);
    if (z.re == T(0) && z.im == T(0)) status |= kStatusDivZero;
    roots[low + it] = z;
    // Synthetic division by (x - z) (polynomial.rs:155-195), in place:
    // q[i] = p[i+1] + z q[i+1] reads the coefficient above before the
    // quotient overwrites it.
    Cx<T> carry{T(0), T(0)};
    Cx<T> above = work[N - 1];
    for (int i = N - 2; i >= 0; --i) {
      carry = cadd(above, cmul(z, carry));
      above = work[i];
      work[i] = carry;
    }
    work[N - 1] = {T(0), T(0)};
  }

  // Quadratic / linear tails (polynomial.rs:131-144).
  if ((status & kStatusZeroDegree) == 0) {
    const int zri = low + (m0 - 2 > 0 ? m0 - 2 : 0);
    const Cx<T> c0 = work[0];
    const Cx<T> c1 = work[1];
    const Cx<T> c2 = N >= 3 ? work[2] : Cx<T>{T(0), T(0)};
    if (m0 >= 2) {
      const Cx<T> a2 = cadd(c2, c2);
      const Cx<T> four{T(4), T(0)};
      const Cx<T> d = csqrt(csub(cmul(c1, c1), cmul(cmul(four, c2), c0)));
      const Cx<T> xq{-c1.re, -c1.im};
      roots[zri] = cdiv(cadd(xq, d), a2);
      if (zri + 1 < N) roots[zri + 1] = cdiv(csub(xq, d), a2);
    } else if (m0 == 1) {
      roots[zri] = cdiv(Cx<T>{-c0.re, -c0.im}, c1);
    }
  }

  for (int j = 0; j < N; ++j) {
    r_re[base + j] = roots[j].re;
    r_im[base + j] = roots[j].im;
  }
  count[row] = deg;
  status_out[row] = status;
}

template <typename T>
int launch(const void* c_re, const void* c_im, void* r_re, void* r_im, void* count, void* status,
           int B, int N, void* stream) {
  if (N < 1 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    constexpr int kThreads = 128;
    roots_kernel<T><<<vt::blocks_for(B, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(c_re), static_cast<const T*>(c_im), static_cast<T*>(r_re),
        static_cast<T*>(r_im), static_cast<int*>(count), static_cast<int*>(status), B, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VT_EXPORT int vt_roots_f32(const void* c_re, const void* c_im, void* r_re, void* r_im,
                           void* count, void* status, int B, int N, void* stream) {
  return launch<float>(c_re, c_im, r_re, r_im, count, status, B, N, stream);
}

VT_EXPORT int vt_roots_f64(const void* c_re, const void* c_im, void* r_re, void* r_im,
                           void* count, void* status, int B, int N, void* stream) {
  return launch<double>(c_re, c_im, r_re, r_im, count, status, B, N, stream);
}
