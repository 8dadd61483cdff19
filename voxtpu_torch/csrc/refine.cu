// Kernel A: Brent maximization of the Hann-windowed sinc interpolant, one
// thread per pitch candidate.
//
// Replaces voxtpu/ops/refine_pallas.py::brent_refine_pallas (pallas_call at
// refine_pallas.py:379). Semantics follow voxtpu.sinc._WindowEval and
// brent_maximize_sinc (the reference's interpolate_sinc / brent_maximize,
// periodic.rs:29-188): effective depth min(max_depth, offset+floor(x)+1, T),
// taps clamped into [0, L), the 1e-10 integer-snap returns, at most `iters`
// Brent steps with tol_act = sqrt(eps)*|x| + tol/3 and the `q = 2q - t`
// quirk (periodic.rs:140). Masked-off candidates skip the loop and return
// (v0, f(v0)), as the plain version does. iters == 0 is the evaluation-only
// mode: (x0, f(x0)).
//
// What bounds it: arithmetic. At 44.1 kHz with fmin 60 a candidate sums up
// to ~740 taps per side per evaluation, each with a cos and a division, for
// ~10-20 evaluations. The lag row of a frame (2n values, 17.6 KB in f32 at
// n = 2205) is read by all of its candidates and stays in L1/L2, so device
// memory traffic is small. Candidates of one frame share a warp and diverge
// in depth and in Brent iteration count. Measured at the 44.1 kHz CLI
// default (35,689 frames x 32 candidates, float32): 8.1 ms, against 400-428
// ms for the plain PyTorch version (NVIDIA H100 80GB HBM3, 700 W).
//
// Design: the TPU kernel's 8x128 tiles, selection matmuls and depth-sorted
// candidate blocks existed for Mosaic; here each thread reads its frame's
// row from global memory and keeps the Brent state in registers. Each
// candidate's tap sum runs serially in tap order, an order fixed by that
// candidate alone, so outputs do not depend on the batch they came in.
// Built with --fmad=false (ops/kernels.py): Brent is chaotic where the
// integer-snap branch decides its path, and contracted multiply-adds alone
// moved 56 of 371,553 float64 candidates to another local maximum.
#include <cmath>

#include "common.cuh"

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr double kGolden = 1.0 - 0.6180339887498948482045868343656381177203091798057628621;

template <typename T>
struct SincEval {
  const T* __restrict__ y;  // this candidate's frame row, length L
  long L;
  int offset;
  int max_depth;
  int T_;  // static tap bound
  long K;  // floor(x0)

  __device__ T operator()(T x) const {
    const T pi = static_cast<T>(kPi);
    const T nl = floor(x);
    const long nl_i = static_cast<long>(nl);
    long s = nl_i - K;
    s = s < -1 ? -1 : (s > 1 ? 1 : s);
    const T phil = x - nl;
    const T phir = T(1) - phil;
    long md = offset + nl_i + 1;
    md = md < 0 ? 0 : md;
    md = md > max_depth ? max_depth : md;
    md = md > T_ ? T_ : md;
    const T mdf = static_cast<T>(md);
    const long base = offset + K + s;  // index of right tap 0, y[offset + nl]

    const T sin_l = sin(pi * phil);
    const T sin_r = sin(pi * phir);
    const T den_l = phil + mdf;
    const T den_r = phir + mdf;
    T acc_l = T(0);
    T acc_r = T(0);
    for (long n = 0; n <= md; ++n) {
      const T sign = (n & 1) ? T(-1) : T(1);
      const T tap = static_cast<T>(n);
      const T a_l = pi * (phil + tap);
      const T c_l = (sin_l * sign / a_l) * (T(0.5) + T(0.5) * cos(a_l / den_l));
      const T a_r = pi * (phir + tap);
      const T c_r = (sin_r * sign / a_r) * (T(0.5) + T(0.5) * cos(a_r / den_r));
      acc_l += y[vt::clamp_index(base + 1 - n, L)] * c_l;
      acc_r += y[vt::clamp_index(base + n, L)] * c_r;
    }
    T result = acc_l + acc_r;
    // Integer-snap early returns (periodic.rs:41-42).
    if (fabs(x - (nl + T(1))) < T(1e-10)) result = y[vt::clamp_index(base + 1, L)];
    if (fabs(x - nl) < T(1e-10)) result = y[vt::clamp_index(base, L)];
    return result;
  }
};

template <typename T>
__global__ void refine_kernel(const T* __restrict__ y, const T* __restrict__ x0,
                              const uint8_t* __restrict__ valid, T* __restrict__ x_out,
                              T* __restrict__ fx_out, int B, int C, int L, int offset,
                              int max_depth, int T_, int iters, double tol) {
  const long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<long>(B) * C) return;
  const long row = i / C;
  const T xs = x0[i];
  const SincEval<T> f{y + row * static_cast<long>(L), L, offset, max_depth, T_,
                      static_cast<long>(floor(xs))};
  if (iters == 0) {
    x_out[i] = xs;
    fx_out[i] = f(xs);
    return;
  }

  const T eps = static_cast<T>(vt::Limits<T>::eps);
  const T sqrt_eps = static_cast<T>(sqrt(vt::Limits<T>::eps));
  const T tol3 = static_cast<T>(tol / 3.0);
  const T golden = static_cast<T>(kGolden);

  T a = xs - T(1);
  T b = xs + T(1);
  T v = a + golden * (b - a);
  T fv = f(v);
  T x = v, w = v;
  T fx = fv, fw = fv;
  if (valid[i]) {
    for (int it = 0; it < iters; ++it) {
      const T rng = b - a;
      const T middle = (a + b) * T(0.5);
      const T tol_act = sqrt_eps * fabs(x) + tol3;
      if (fabs(x - middle) + rng * T(0.5) <= T(2) * tol_act) break;

      T new_step = x < middle ? golden * (b - x) : golden * (a - x);
      const T t_ = (x - w) * (fx - fv);
      T q = (x - v) * (fx - fw);
      T p = (x - v) * q - (x - w) * t_;
      q = T(2) * q - t_;  // sic (periodic.rs:140)
      if (q > T(0)) {
        p = -p;
      } else {
        q = -q;
      }
      const bool para_ok = fabs(x - w) >= tol_act && fabs(p) < fabs(new_step * q) &&
                           p > q * (a - x + T(2) * tol_act) &&
                           p < q * (b - x - T(2) * tol_act);
      if (para_ok) new_step = p / (q == T(0) ? T(1) : q);
      if (fabs(new_step) < tol_act) new_step = new_step > T(0) ? tol_act : -tol_act;

      const T t = x + new_step;
      const T ft = f(t);
      if (ft <= fx) {
        if (t < x) {
          b = x;
        } else {
          a = x;
        }
        v = w;
        fv = fw;
        w = x;
        fw = fx;
        x = t;
        fx = ft;
      } else {
        if (t < x) {
          a = t;
        } else {
          b = t;
        }
        if (ft <= fw || fabs(w - x) < eps) {
          v = w;
          fv = fw;
          w = t;
          fw = ft;
        } else if (ft <= fv || fabs(v - x) < eps || fabs(v - w) < eps) {
          v = t;
          fv = ft;
        }
      }
    }
  }
  x_out[i] = x;
  fx_out[i] = fx;
}

template <typename T>
int launch(const void* y, const void* x0, const void* valid, void* x_out, void* fx_out, int B,
           int C, int L, int offset, int max_depth, int T_, int iters, double tol,
           void* stream) {
  const long n = static_cast<long>(B) * C;
  if (n > 0) {
    constexpr int kThreads = 128;
    refine_kernel<T><<<vt::blocks_for(n, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(y), static_cast<const T*>(x0),
        static_cast<const uint8_t*>(valid), static_cast<T*>(x_out), static_cast<T*>(fx_out), B,
        C, L, offset, max_depth, T_, iters, tol);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VT_EXPORT int vt_refine_f32(const void* y, const void* x0, const void* valid, void* x_out,
                            void* fx_out, int B, int C, int L, int offset, int max_depth, int T_,
                            int iters, double tol, void* stream) {
  return launch<float>(y, x0, valid, x_out, fx_out, B, C, L, offset, max_depth, T_, iters, tol,
                       stream);
}

VT_EXPORT int vt_refine_f64(const void* y, const void* x0, const void* valid, void* x_out,
                            void* fx_out, int B, int C, int L, int offset, int max_depth, int T_,
                            int iters, double tol, void* stream) {
  return launch<double>(y, x0, valid, x_out, fx_out, B, C, L, offset, max_depth, T_, iters, tol,
                        stream);
}
