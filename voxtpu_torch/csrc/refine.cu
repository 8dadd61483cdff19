// Kernel A: Brent maximization of the Hann-windowed sinc interpolant, one
// warp per pitch candidate.
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
// Where the time goes: evaluations of the interpolant. One sums md + 1 taps
// a side, md up to the lag + 1 (mean ~400, at most ~740 at 44.1 kHz with
// fmin 60), and each tap-side costs two IEEE divisions and an accurate cos.
// How many evaluations a candidate makes follows from Brent's stop test,
// tol_act = sqrt(eps)|x|: x is the lag minus the offset (-1,103 at the CLI
// default, -2,049 at 4096-sample frames), so |x| ~ 1,500-2,450 and tol_act
// ~ 0.5-0.9 samples in float32, where Brent stops after 1-2 evaluations; in
// float64 it takes ~24. The lag row is read by all of a frame's candidates
// and stays in L1/L2, so device memory traffic is small. What bounds the
// kernel now is instruction throughput for that tap arithmetic, nearly all on
// lanes that do useful work (only an evaluation's last step leaves lanes
// idle): 2.0 ms at the CLI shapes in float32, 48 ms in float64 (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md).
//
// The first design ran one thread a candidate: a frame's 32 candidates in
// one warp, of which ~10 are live (the rest make one evaluation of depth 0),
// each live lane walking its own 2(md + 1) tap-sides in series, so the warp
// took as long as its deepest lane (1.7 times the mean) and a load touched
// ~10 places of the row: about a fifth of the lanes that ran did useful work
// (8.1 ms). Now a block takes a frame row and its warps take the row's
// candidates, one at a time from a shared counter. A warp holds one
// candidate's Brent state in all 32 lanes: lane l sums taps l, l + 32, ...
// of both sides in ascending order, a fixed xor butterfly of 5 shuffles adds
// the 32 partial sums, and every lane ends with the same bits, so the lanes
// take the same Brent branch and never diverge. A warp's loads of a side
// are 32 neighbouring values of the row, read from global memory: the time
// is in the arithmetic, so staging the row in shared memory would save
// little. The summation order depends on the candidate's md alone, so
// outputs do not depend on the batch they came in. Each coefficient is
// computed by the same operations, in the same order, as the plain
// version's (`sinc._coefs`).
//
// Built with --fmad=false (ops/kernels.py): Brent is chaotic where the
// integer-snap branch decides its path, and contracted multiply-adds alone
// moved 56 of 371,553 float64 candidates to another local maximum.
#include <cmath>

#include "common.cuh"

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr double kGolden = 1.0 - 0.6180339887498948482045868343656381177203091798057628621;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // warps a block, each on one candidate at a time
constexpr int kThreads = 32 * kWarps;

// sin and cos of an argument that is NaN or lies in [-4, 4]. Every argument
// here does: pi * phi with phi in [0, 1], and pi (phi + n) / (phi + md) with
// n <= md, at most pi (1 + 2 eps). The assumption lets the compiler drop the
// Payne-Hanek reduction that CUDA's accurate sin and cos keep for huge
// arguments (a local array of 32 bytes in float32, 40 in float64); in range
// the result is the same, bit for bit. A NaN argument is taken as 0, so that
// the assumption holds: it comes only from a NaN phi or from 0 / 0 (phi = md
// = 0), where the tap's other factor, sin(pi phi) / (pi (phi + n)), is NaN
// already, and so is the coefficient.
template <typename T>
__device__ __forceinline__ T sin_small(T x) {
  const T t = isnan(x) ? T(0) : x;
  __builtin_assume(fabs(t) <= T(4));
  return sin(t);
}

template <typename T>
__device__ __forceinline__ T cos_small(T x) {
  const T t = isnan(x) ? T(0) : x;
  __builtin_assume(fabs(t) <= T(4));
  return cos(t);
}

template <typename T>
struct SincEval {
  const T* __restrict__ y;  // this candidate's frame row, length L
  long L;
  int offset;
  int max_depth;
  int T_;  // static tap bound
  long K;  // floor(x0)
  int lane;

  // The interpolant at x, the same in every lane of the warp; md gets the
  // clipped depth (the evaluation sums 2 (md + 1) tap-sides).
  __device__ __forceinline__ T operator()(T x, int& md_out) const {
    const T pi = static_cast<T>(kPi);
    const T nl = floor(x);
    const long nl_i = static_cast<long>(nl);
    long s = nl_i - K;
    s = s < -1 ? -1 : (s > 1 ? 1 : s);
    const T phil = x - nl;
    const T phir = T(1) - phil;
    long md_l = offset + nl_i + 1;
    md_l = md_l < 0 ? 0 : md_l;
    md_l = md_l > max_depth ? max_depth : md_l;
    md_l = md_l > T_ ? T_ : md_l;
    const int md = static_cast<int>(md_l);
    md_out = md;
    const T mdf = static_cast<T>(md);
    const long base = offset + K + s;  // index of right tap 0, y[offset + nl]
    // The taps' indices in 32 bits: base brought into [-(md + 2), L + md + 2]
    // first, which moves no index that clamp_index gives for n in [0, md].
    const long reach = md + 2;
    const int b = static_cast<int>(base < -reach ? -reach : (base > L + reach ? L + reach : base));
    const int last = static_cast<int>(L) - 1;

    const T sin_l = sin_small(pi * phil);
    const T sin_r = sin_small(pi * phir);
    const T den_l = phil + mdf;
    const T den_r = phir + mdf;
    T acc_l = T(0);
    T acc_r = T(0);
    for (int n = lane; n <= md; n += 32) {
      const T sign = (n & 1) ? T(-1) : T(1);
      const T tap = static_cast<T>(n);
      const T a_l = pi * (phil + tap);
      const T c_l = (sin_l * sign / a_l) * (T(0.5) + T(0.5) * cos_small(a_l / den_l));
      const T a_r = pi * (phir + tap);
      const T c_r = (sin_r * sign / a_r) * (T(0.5) + T(0.5) * cos_small(a_r / den_r));
      acc_l += y[min(max(b + 1 - n, 0), last)] * c_l;
      acc_r += y[min(max(b + n, 0), last)] * c_r;
    }
    // a + b == b + a bit for bit, so every lane ends with the same sums.
    for (int off = 16; off > 0; off >>= 1) {
      acc_l += __shfl_xor_sync(kFull, acc_l, off);
      acc_r += __shfl_xor_sync(kFull, acc_r, off);
    }
    T result = acc_l + acc_r;
    // Integer-snap early returns (periodic.rs:41-42).
    if (fabs(x - (nl + T(1))) < T(1e-10)) result = y[vt::clamp_index(base + 1, L)];
    if (fabs(x - nl) < T(1e-10)) result = y[vt::clamp_index(base, L)];
    return result;
  }
};

// One block a row of y; its warps take the row's candidates from a shared
// counter. stats (may be null): {evaluations, tap-sides, most Brent
// iterations} of the valid candidates, added to what is there.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    refine_kernel(const T* __restrict__ y, const T* __restrict__ x0, const uint8_t* __restrict__ valid,
                  T* __restrict__ x_out, T* __restrict__ fx_out, unsigned long long* __restrict__ stats,
                  int C, int L, int offset, int max_depth, int T_, int iters, double tol) {
  __shared__ int next;
  __shared__ unsigned long long block_stats[3];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    next = kWarps;
    block_stats[0] = block_stats[1] = block_stats[2] = 0;
  }
  __syncthreads();

  const long row = blockIdx.x;
  const T eps = static_cast<T>(vt::Limits<T>::eps);
  const T sqrt_eps = static_cast<T>(sqrt(vt::Limits<T>::eps));
  const T tol3 = static_cast<T>(tol / 3.0);
  const T golden = static_cast<T>(kGolden);
  unsigned long long evals = 0, tap_sides = 0, most = 0;

  for (int c = threadIdx.x >> 5; c < C;) {
    const long i = row * C + c;
    const T xs = x0[i];
    const bool live = valid[i];
    const SincEval<T> f{y + row * static_cast<long>(L), L, offset, max_depth, T_,
                        static_cast<long>(floor(xs)), lane};
    int md;
    T x, fx;
    if (iters == 0) {
      x = xs;
      fx = f(xs, md);
      if (live) {
        evals += 1;
        tap_sides += 2 * (md + 1);
      }
    } else {
      T a = xs - T(1);
      T b = xs + T(1);
      T v = a + golden * (b - a);
      T fv = f(v, md);
      x = v;
      T w = v;
      fx = fv;
      T fw = fv;
      if (live) {
        evals += 1;
        tap_sides += 2 * (md + 1);
        int it = 0;
        for (; it < iters; ++it) {
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
          const T ft = f(t, md);
          tap_sides += 2 * (md + 1);
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
        evals += it;
        most = max(most, static_cast<unsigned long long>(it));
      }
    }
    if (lane == 0) {
      x_out[i] = x;
      fx_out[i] = fx;
      c = atomicAdd(&next, 1);
    }
    c = __shfl_sync(kFull, c, 0);
  }

  if (stats != nullptr) {
    if (lane == 0) {
      atomicAdd(&block_stats[0], evals);
      atomicAdd(&block_stats[1], tap_sides);
      atomicMax(&block_stats[2], most);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(&stats[0], block_stats[0]);
      atomicAdd(&stats[1], block_stats[1]);
      atomicMax(&stats[2], block_stats[2]);
    }
  }
}

template <typename T>
int launch(const void* y, const void* x0, const void* valid, void* x_out, void* fx_out, void* stats,
           int B, int C, int L, int offset, int max_depth, int T_, int iters, double tol,
           void* stream) {
  if (B > 0 && C > 0) {
    refine_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(y), static_cast<const T*>(x0), static_cast<const uint8_t*>(valid),
        static_cast<T*>(x_out), static_cast<T*>(fx_out), static_cast<unsigned long long*>(stats), C,
        L, offset, max_depth, T_, iters, tol);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stats (may be null): int64[3], zeroed by the caller.
VT_EXPORT int vt_refine_f32(const void* y, const void* x0, const void* valid, void* x_out,
                            void* fx_out, void* stats, int B, int C, int L, int offset, int max_depth,
                            int T_, int iters, double tol, void* stream) {
  return launch<float>(y, x0, valid, x_out, fx_out, stats, B, C, L, offset, max_depth, T_, iters,
                       tol, stream);
}

VT_EXPORT int vt_refine_f64(const void* y, const void* x0, const void* valid, void* x_out,
                            void* fx_out, void* stats, int B, int C, int L, int offset, int max_depth,
                            int T_, int iters, double tol, void* stream) {
  return launch<double>(y, x0, valid, x_out, fx_out, stats, B, C, L, offset, max_depth, T_, iters,
                        tol, stream);
}
