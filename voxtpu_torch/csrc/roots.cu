// Kernel C: all roots of each frame's complex polynomial, one thread per
// polynomial, the polynomial in registers.
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
// missing atan2, PARITY deviation 10a) is gone from the port. Each thread
// performs, in the same order (built --fmad=false), every operation whose
// result the kernel this one replaced used, so both give the same bits on
// every input.
//
// What bounds it on an H100: the serial chain of one polynomial. At order 13
// (N = 14) a polynomial takes 11 rounds x 20 iterations, each a 13-step
// complex Horner triple (312 float operations, no fused multiply-adds) and
// an update of three complex divisions, four hypots, a square root, an
// atan2 and a sin and cos, each but the last two ending in a branch to a
// slow path. In the kernel this one replaced, one warp's iteration took
// about 2,700 clocks, 80% of it the update (clock64 stamps, NVIDIA H100 80GB
// HBM3, 700 W). At bench shapes (15,369 frames, 481 warps on 528
// schedulers) that chain is the kernel's time; at CLI shapes (35,689
// frames, 1,116 warps) up to 3 warps share a scheduler, and issue adds to
// it (an iteration is about 680 SASS instructions in float32).
//
// Design. The kernel it replaces kept the coefficients, the deflated
// polynomial and the roots in per-thread arrays indexed at run time, so in
// local memory (800 bytes a thread in float32, 1,584 in float64), and
// reloaded each coefficient from there in every Horner step. Here N is a
// template argument: kN = 14, the order-13 polynomials of every
// configuration the repo runs, whose loops over coefficients are all
// unrolled, so every array index is a constant and the polynomial lives in
// registers; the shift by the lowest nonzero index is a barrel of static
// selects; each root goes straight to its output slot. Any other N up to
// kMaxN = 128 (LPC orders up to 127, the reference's own TPU limit) runs
// the capacity instantiation: the same operations in the same order, its
// loops bounded by the runtime N, the pairs in dynamic shared memory, one
// column a thread, pair j of thread t at [j kCapThreads + t]. Its blocks
// are kCapThreads = 32 threads, so the columns take N x 32 pairs: 64 KB in
// float64 and 32 KB in float32 at N = 128 (in blocks of 64 they would take
// 128 KB, one block an SM), and the launcher raises the block's dynamic
// shared-memory limit above 48 KB. The angle of the square root lies
// in [-pi/2, pi/2], which drops the Payne-Hanek reduction (a local array)
// that CUDA's accurate sin and cos keep for huge arguments, and one sincos
// replaces the two calls with the same bits. Each iteration tests the
// |p(z)| <= 1e-16 freeze first and ends there once it holds, as the rest of
// the iterations would not move z. Blocks of 32, 64 or 128 threads time
// alike. Float32: 0.309 ms at CLI shapes against 0.47 for the kernel it
// replaced, 0.204 at bench shapes against 0.343 (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).
#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kN = 14;           // voxtpu_torch.ops.find_roots._N
constexpr int kMaxN = 128;       // voxtpu_torch.ops.find_roots._MAX_N
constexpr int kThreads = 64;     // voxtpu_torch.ops.find_roots._THREADS
constexpr int kCapThreads = 32;  // voxtpu_torch.ops.find_roots._CAP_THREADS
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
// The polar square root. atan2 lies in [-pi, pi], so theta in [-pi/2, pi/2]
// unless it is NaN; a NaN theta goes through as it is (r times it is NaN,
// as r times sin or cos of it was). sincos gives sin's and cos's bits
// (every float of the range and 2^28 doubles, NVIDIA H100 80GB HBM3).
template <typename T>
__device__ __forceinline__ Cx<T> csqrt(Cx<T> a) {
  const T r = sqrt(cnorm(a));
  const T theta = atan2(a.im, a.re) * T(0.5);
  const bool nan = isnan(theta);
  const T t = nan ? T(0) : theta;
  __builtin_assume(fabs(t) <= T(2));
  T s, c;
  sincos(t, &s, &c);
  return {r * (nan ? theta : c), r * (nan ? theta : s)};
}

// A polynomial's coefficient pairs, index = power. Regs keeps them in
// registers: every index is a constant once the loops over them are
// unrolled. Column keeps them in the block's shared memory, one column a
// thread, for the capacity instantiation, whose pairs would not fit in
// registers; its loops run to the runtime N.
template <typename T, int kCap>
struct Regs {
  static constexpr bool kShared = false;
  Cx<T> v[kCap];
  __device__ __forceinline__ Cx<T>& operator[](int j) { return v[j]; }
  __device__ __forceinline__ const Cx<T>& operator[](int j) const { return v[j]; }
};
template <typename T>
struct Column {
  static constexpr bool kShared = true;
  Cx<T>* p;  // pair j at p[j * kCapThreads]
  __device__ __forceinline__ Cx<T>& operator[](int j) const { return p[j * kCapThreads]; }
};

// p[N - 1], the top coefficient, of N <= kCap pairs.
template <int kCap, typename P>
__device__ __forceinline__ auto top(const P& p, int N) {
  auto t = p[kCap - 1];
#pragma unroll
  for (int j = 0; j < kCap - 1; ++j) {
    if (j == N - 1) t = p[j];
  }
  return t;
}

// 20 Laguerre iterations from (-2, -2) on the N pairs of c (polynomial.rs:
// 34-72), with n, the live degree of the first round, held throughout.
template <int kCap, typename P, typename T>
__device__ __forceinline__ Cx<T> laguerre(const P& c, int N, T n) {
  const Cx<T> n_c{n, T(0)};
  const Cx<T> nm1_c{n - T(1), T(0)};
  const Cx<T> two{T(2), T(0)};
  Cx<T> z{T(-2), T(-2)};
  bool done = false;
#pragma unroll 1
  for (int it = 0; it < kLaguerreIters; ++it) {
    if (done) continue;  // z stays: the rest of the iterations would not move it
    // Load shared pairs anew each iteration: holding them all in registers
    // is what the shared layout is there to avoid.
    if constexpr (P::kShared) asm volatile("" ::: "memory");
    // p, p' and the p''/2 accumulator (polynomial.rs:39-45).
    Cx<T> b{T(0), T(0)};
    Cx<T> g{T(0), T(0)};
    Cx<T> a;
    if constexpr (P::kShared) {
      a = c[N - 1];
      for (int j = N - 2; j >= 0; --j) {
        g = cadd(cmul(g, z), b);
        b = cadd(cmul(b, z), a);
        a = cadd(cmul(a, z), c[j]);
      }
    } else {
      a = top<kCap>(c, N);
#pragma unroll
      for (int j = kCap - 2; j >= 0; --j) {
        if (j < N - 1) {
          g = cadd(cmul(g, z), b);
          b = cadd(cmul(b, z), a);
          a = cadd(cmul(a, z), c[j]);
        }
      }
    }
    done = cnorm(a) <= T(1e-16);
    if (done) continue;
    const Cx<T> ca = cdiv(Cx<T>{-b.re, -b.im}, a);
    const Cx<T> ca2 = cmul(ca, ca);
    const Cx<T> cb = csub(ca2, cdiv(cmul(two, g), a));
    const Cx<T> c1 = csqrt(csub(cmul(cmul(nm1_c, n_c), cb), ca2));
    const Cx<T> cc1 = cadd(ca, c1);
    const Cx<T> cc2 = csub(ca, c1);
    const Cx<T> denom = cnorm(cc1) > cnorm(cc2) ? cc1 : cc2;
    z = cadd(z, cdiv(n_c, denom));
  }
  return z;
}

// Synthetic division of p (N <= kCap) by (x - z) (polynomial.rs:155-195), in
// place: q[i] = p[i+1] + z q[i+1] reads the coefficient above before the
// quotient overwrites it; the top coefficient becomes 0.
template <int kCap, typename P, typename T>
__device__ __forceinline__ void deflate(P& p, int N, Cx<T> z) {
  Cx<T> carry{T(0), T(0)};
  if constexpr (P::kShared) {
    Cx<T> above = p[N - 1];
    for (int i = N - 2; i >= 0; --i) {
      carry = cadd(above, cmul(z, carry));
      above = p[i];
      p[i] = carry;
    }
    p[N - 1] = {T(0), T(0)};
  } else {
    Cx<T> above = top<kCap>(p, N);
#pragma unroll
    for (int i = kCap - 2; i >= 0; --i) {
      if (i < N - 1) {
        carry = cadd(above, cmul(z, carry));
        above = p[i];
        p[i] = carry;
      }
    }
#pragma unroll
    for (int j = 0; j < kCap; ++j) {
      if (j == N - 1) p[j] = {T(0), T(0)};
    }
  }
}

// kExact: N == kCap, known when compiled, the pairs in registers; else
// N <= kCap at run time, the pairs in the block's dynamic shared memory.
template <typename T, int kCap, bool kExact>
__global__ void __launch_bounds__(kThreads)
    roots_kernel(const T* __restrict__ c_re, const T* __restrict__ c_im, T* __restrict__ r_re,
                 T* __restrict__ r_im, int* __restrict__ count, int* __restrict__ status_out, int B,
                 int n_arg) {
  static_assert(kCap >= 3, "the tail reads w[0..2]");
  const int N = kExact ? kCap : n_arg;
  const long row = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (row >= B) return;
  const long base = row * N;

  using Poly = std::conditional_t<kExact, Regs<T, kCap>, Column<T>>;
  extern __shared__ __align__(16) unsigned char columns_raw[];
  Poly w;
  if constexpr (!kExact) w.p = reinterpret_cast<Cx<T>*>(columns_raw) + threadIdx.x;

  // degree: highest nonzero index (0 if none); low: lowest (N - 1 if none),
  // polynomial.rs:26-32.
  int deg = 0;
  int low = N - 1;
  // Unrolled with constant indices for the registers; a loop for the capacity.
  constexpr int kUnroll = kExact ? kCap : 1;
#pragma unroll(kUnroll)
  for (int j = N - 1; j >= 0; --j) {
    w[j] = {c_re[base + j], c_im[base + j]};
    if (w[j].re != T(0) || w[j].im != T(0)) {
      if (deg == 0) deg = j;
      low = j;
    }
    r_re[base + j] = T(0);
    r_im[base + j] = T(0);
  }
  int status = deg < 1 ? kStatusZeroDegree : 0;
  const int m0 = deg - low;

  // Shift the x^low factor out: w[j] = c[j + low], 0 past the top.
  if constexpr (kExact) {
#pragma unroll
    for (int s = 1; s < kCap; s <<= 1) {
      if (low & s) {
#pragma unroll
        for (int j = 0; j < kCap; ++j) {
          w[j] = j + s < N ? w[j + s < kCap ? j + s : kCap - 1] : Cx<T>{T(0), T(0)};
        }
      }
    }
  } else {
    // Ascending j reads w[j + low] before it is overwritten.
    for (int j = 0; j < N; ++j) w[j] = j + low < N ? w[j + low] : Cx<T>{T(0), T(0)};
  }

  const T n_lag = static_cast<T>(m0);
  const int rounds = N - 3 > 0 ? N - 3 : 0;
#pragma unroll 1
  for (int it = 0; it < rounds && it < m0 - 2 && status == 0; ++it) {
    const Cx<T> z = laguerre<kCap>(w, N, n_lag);
    if (z.re == T(0) && z.im == T(0)) status |= kStatusDivZero;
    r_re[base + low + it] = z.re;
    r_im[base + low + it] = z.im;
    deflate<kCap>(w, N, z);
  }

  // Quadratic / linear tails (polynomial.rs:131-144).
  if ((status & kStatusZeroDegree) == 0) {
    const int zri = low + (m0 - 2 > 0 ? m0 - 2 : 0);
    const Cx<T> c0 = w[0];
    const Cx<T> c1 = w[1];
    const Cx<T> c2 = N >= 3 ? w[2] : Cx<T>{T(0), T(0)};
    if (m0 >= 2) {
      const Cx<T> a2 = cadd(c2, c2);
      const Cx<T> four{T(4), T(0)};
      const Cx<T> d = csqrt(csub(cmul(c1, c1), cmul(cmul(four, c2), c0)));
      const Cx<T> xq{-c1.re, -c1.im};
      const Cx<T> q1 = cdiv(cadd(xq, d), a2);
      r_re[base + zri] = q1.re;
      r_im[base + zri] = q1.im;
      if (zri + 1 < N) {
        const Cx<T> q2 = cdiv(csub(xq, d), a2);
        r_re[base + zri + 1] = q2.re;
        r_im[base + zri + 1] = q2.im;
      }
    } else if (m0 == 1) {
      const Cx<T> q = cdiv(Cx<T>{-c0.re, -c0.im}, c1);
      r_re[base + zri] = q.re;
      r_im[base + zri] = q.im;
    }
  }
  count[row] = deg;
  status_out[row] = status;
}

template <typename T>
int launch(const void* c_re, const void* c_im, void* r_re, void* r_im, void* count, void* status,
           int B, int N, void* stream) {
  if (N < 1 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto *re = static_cast<const T*>(c_re), *im = static_cast<const T*>(c_im);
    auto *rre = static_cast<T*>(r_re), *rim = static_cast<T*>(r_im);
    auto *cnt = static_cast<int*>(count), *st = static_cast<int*>(status);
    if (N == kN) {
      roots_kernel<T, kN, true><<<vt::blocks_for(B, kThreads), kThreads, 0, s>>>(re, im, rre, rim, cnt, st, B, N);
    } else {
      // N columns of kCapThreads pairs: at most 64 KB (float64, N = 128).
      const int smem = N * kCapThreads * static_cast<int>(sizeof(Cx<T>));
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(roots_kernel<T, kMaxN, false>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      roots_kernel<T, kMaxN, false><<<vt::blocks_for(B, kCapThreads), kCapThreads, smem, s>>>(re, im, rre, rim, cnt,
                                                                                             st, B, N);
    }
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
