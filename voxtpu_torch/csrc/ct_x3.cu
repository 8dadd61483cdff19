// Kernel X3: the n-point half power spectrum and the first n lags of
// irfft(|rfft(x, 2n)|^2) of (B, n) float32 frames, as the four-step
// Cooley-Tukey decomposition on the tensor cores, each float32 product as
// three bfloat16 products.
//
// Replaces the algorithm="x3" body of voxtpu/ops/ct_fused_pallas.py's
// _kernel (ct_fused_pallas.py:130-151; its pallas_call at :222), which
// voxtpu runs for backend="ct_fused_x3". Semantics are those of its plain
// version, ct_x3_power_ac_plain (voxtpu_torch/ops/ct_x3.py): with
// N = 2n = N1 x 128, x viewed (n/128, 128) as x[n1, n2] and
// k = k2 N1 + k1, l = l1 + 128 l2,
//   stage 1   A[k1, n2]  = sum_n1 W_N1^{n1 k1} x[n1, n2]   (c1, s1: cos, sin)
//   stage 2   B[k1, n2]  = A[k1, n2] W_N^{k1 n2}            (tc, ts)
//   stage 3   X[k1, k2]  = sum_n2 B[k1, n2] W_128^{n2 k2}   (c2, s2)
//   power     P[k1, k2]  = |X|^2; half[j] = P[k1, k2] for even k1,
//                          j = k2 N1/2 + k1/2 <= n/2
//   inverse   Ca, Sa     = P @ cos, sin(2 pi k2 l1 / 128)   (ca, sa)
//             U, V       = Ca cb - Sa sb, Ca sb + Sa cb     (cb, sb: 2 pi k1 l1 / N)
//             ac[l]      = (1/N) sum_k1 cos(c) U - sin(c) V, c = 2 pi l2 k1 / N1
// Every product splits both operands into bfloat16 hi = bf16(v) and
// lo = bf16(v - hi) and sums hi.hi + hi.lo + lo.hi in float32
// (mma.sync.m16n8k16, bfloat16 in, float32 accumulators). The quirk
// correction stays outside (voxtpu_torch.autocorr).
//
// What bounds it: the function is about 44 MFLOP of tensor-core products a
// frame at n = 4096 (three passes of 14.7 MFLOP), 0.68 ms for the bench
// path's 15,369 frames at the H100's 989 TFLOP/s of dense bfloat16, against
// 0.19 ms to read the frames and write both outputs at 3.35 TB/s: the
// products set the bound. This kernel is the simple version: mma.sync (not
// wgmma), one frame a block of 8 warps, every operand fragment loaded and
// split by the threads themselves.
//
// Design:
// - One block a frame. Shared memory holds the frame (n/128 rows), the lag
//   accumulator (n/128 rows) and, for one slab of kSlab k1 rows at a time,
//   the stage-2 tensors B (re, im), then U and V in their place, and the
//   power P: rows of kLd = 132 floats, so that a warp's fragment loads
//   ((g, 2t) and (2t, g) patterns) fall on 32 distinct banks. 84,480 bytes
//   at n = 4096 (two blocks an SM), 220,704 at voxtpu's largest n, 20,608.
// - A slab runs stage 1 + twiddle, stage 3 + power + half, the inverse's
//   first products and U, V, then adds its k1 rows' share of the last
//   product to the lag accumulator; four barriers a slab. Within a slab
//   each warp owns a 16 x 32 output tile (four m16n8 tiles sharing their
//   left operand); the accumulator's tiles go round the warps.
// - Activations (x, B, P, U, V) are float32 in shared memory and are split
//   into (hi, lo) as a fragment is loaded. The tables are split once per
//   (n, nfft) on the device by the wrapper: left operands (c1, s1 and the
//   inverse's (l2, k1) tables) row-major, right operands (c2, s2, -s2, ca,
//   sa) with each column's k, k+1 neighbours side by side, so that every
//   fragment register is one 32-bit load. The elementwise tables (tc, ts,
//   cb, sb) stay float32.
// - Ragged edges (n/128 rows of x, N1 k1 rows, n/128 lag rows) are masked
//   at the loads; the c1 and s1 rows are padded to an even length with
//   zeros, so a pair never straddles the edge.
// Built --fmad=false like the rest of the library (the products themselves
// are tensor-core operations either way): held to a tolerance against the
// plain version and the float64 transform, not to bits.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kN2 = 128;
constexpr int kSlab = 32;    // k1 rows a slab
constexpr int kLd = 132;     // shared-memory row stride, in floats
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 20608;  // the largest frame voxtpu's gate admits (ops/ct_x3.py)

struct Shape {
  int n, N1, rows, rows_p;  // rows = n / 128 (also the lag rows); rows_p: rows rounded up to even
};

__device__ __forceinline__ Shape shape_of(int n) {
  const int rows = n / kN2;
  return {n, 2 * rows, rows, rows + (rows & 1)};
}

// The tables, as ops/ct_x3.py::_device_tables lays them out: bfloat16
// (hi, lo) pairs of c1, s1 (N1 x rows_p), c2, s2, -s2, ca, sa (128 x 128,
// column pairs) and cc, -sc (rows x N1) in one buffer of 16-bit words;
// tc, ts, cb, sb (N1 x 128) in float32 in another.
struct Tables {
  const uint16_t *c1h, *c1l, *s1h, *s1l;
  const uint16_t *c2h, *c2l, *s2h, *s2l, *ns2h, *ns2l, *cah, *cal, *sah, *sal;
  const uint16_t *cch, *ccl, *nsch, *nscl;
  const float *tc, *ts, *cb, *sb;
};

__device__ __forceinline__ Tables tables_of(const uint16_t* bf, const float* f32, const Shape& s) {
  const long a = static_cast<long>(s.N1) * s.rows_p, b = kN2 * kN2, c = static_cast<long>(s.rows) * s.N1;
  const long tw = static_cast<long>(s.N1) * kN2;
  Tables t;
  t.c1h = bf;
  t.c1l = bf + a;
  t.s1h = bf + 2 * a;
  t.s1l = bf + 3 * a;
  const uint16_t* r = bf + 4 * a;
  t.c2h = r; t.c2l = r + b; t.s2h = r + 2 * b; t.s2l = r + 3 * b; t.ns2h = r + 4 * b; t.ns2l = r + 5 * b;
  t.cah = r + 6 * b; t.cal = r + 7 * b; t.sah = r + 8 * b; t.sal = r + 9 * b;
  const uint16_t* q = r + 10 * b;
  t.cch = q; t.ccl = q + c; t.nsch = q + 2 * c; t.nscl = q + 3 * c;
  t.tc = f32; t.ts = f32 + tw; t.cb = f32 + 2 * tw; t.sb = f32 + 3 * tw;
  return t;
}

// A 16 x 16 left operand and a 16 x 8 right operand of mma.m16n8k16, each
// as its bfloat16 hi and lo parts (lane = 4 g + t: left registers at rows
// g, g + 8 and columns 2t, 2t + 8; right registers at rows 2t, 2t + 8 and
// column g; two neighbours a register, the lower index in the low half).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (hi, lo) of the pair (v0, v1): hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in three passes: hi.hi + hi.lo + lo.hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.hi, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.lo, b.hi);
}

// Left operand from a split row-major table (row length ld, even): rows
// m0.. of M, columns k0.. of K (even), zero outside.
__device__ __forceinline__ void load_a_table(FragA& f, const uint16_t* hi, const uint16_t* lo, int ld, int M,
                                             int K, int m0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + g + (i & 1) * 8, c = k0 + 2 * t + (i >> 1) * 8;
    const bool ok = r < M && c < K;
    const long at = static_cast<long>(r) * ld + c;
    f.hi[i] = ok ? *reinterpret_cast<const uint32_t*>(hi + at) : 0u;
    f.lo[i] = ok ? *reinterpret_cast<const uint32_t*>(lo + at) : 0u;
  }
}

// Left operand from a float32 slab in shared memory (kSlab x 128, all in
// range), split as it loads.
__device__ __forceinline__ void load_a_smem(FragA& f, const float* p, int m0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + g + (i & 1) * 8, c = k0 + 2 * t + (i >> 1) * 8;
    const float2 v = *reinterpret_cast<const float2*>(p + r * kLd + c);
    split(v.x, v.y, f.hi[i], f.lo[i]);
  }
}

// Right operand from a split 128 x 128 table in column pairs.
__device__ __forceinline__ void load_b_pairs(FragB& f, const uint16_t* hi, const uint16_t* lo, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int at = ((k0 >> 1) + t + 4 * j) * kN2 + n0 + g;
    f.hi[j] = reinterpret_cast<const uint32_t*>(hi)[at];
    f.lo[j] = reinterpret_cast<const uint32_t*>(lo)[at];
  }
}

// Right operand from float32 rows in shared memory: rows k0.. of K (zero
// at and past K), column n0 + g, split as it loads.
__device__ __forceinline__ void load_b_smem(FragB& f, const float* p, int K, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = k0 + 2 * t + 8 * j;
    const float v0 = k < K ? p[k * kLd + n0 + g] : 0.f;
    const float v1 = k + 1 < K ? p[(k + 1) * kLd + n0 + g] : 0.f;
    split(v0, v1, f.hi[j], f.lo[j]);
  }
}

__global__ void __launch_bounds__(kThreads) ct_x3_kernel(const float* __restrict__ x, const uint16_t* __restrict__ bf,
                                                         const float* __restrict__ f32, float* __restrict__ half,
                                                         float* __restrict__ ac, int n) {
  extern __shared__ float4 smem4[];
  float* const X = reinterpret_cast<float*>(smem4);  // rows x kLd: the frame
  const Shape s = shape_of(n);
  const Tables tb = tables_of(bf, f32, s);
  float* const acc = X + s.rows * kLd;  // rows x kLd: lag accumulator [l2][l1]
  float* const BR = acc + s.rows * kLd;   // kSlab x kLd: B re, then U
  float* const BI = BR + kSlab * kLd;     // B im, then V
  float* const P = BI + kSlab * kLd;      // the slab's power
  const long f = blockIdx.x;
  const float* const xf = x + f * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    X[(i >> 7) * kLd + (i & (kN2 - 1))] = xf[i];
    acc[(i >> 7) * kLd + (i & (kN2 - 1))] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 16, n0 = (warp >> 1) * 32;  // this warp's 16 x 32 tile of a slab
  const int nh = n / 2;
  float* const half_f = half + f * (nh + 1);

  for (int s0 = 0; s0 < s.N1; s0 += kSlab) {
    const int rows_left = s.N1 - s0;  // k1 rows from s0 on
    // Stage 1 and the twiddle: B = (c1 - i s1)[slab] @ X times tw.
    {
      float ar[4][4] = {}, ai[4][4] = {};
      const long o = static_cast<long>(s0) * s.rows_p;
      for (int k0 = 0; k0 < s.rows; k0 += 16) {
        FragA fc, fs;
        load_a_table(fc, tb.c1h + o, tb.c1l + o, s.rows_p, rows_left, s.rows_p, m0, k0);
        load_a_table(fs, tb.s1h + o, tb.s1l + o, s.rows_p, rows_left, s.rows_p, m0, k0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragB fx;
          load_b_smem(fx, X, s.rows, k0, n0 + 8 * j);
          mma3(ar[j], fc, fx);
          mma3(ai[j], fs, fx);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + g + (e >> 1) * 8, c = n0 + 8 * j + 2 * t + (e & 1);
          const bool ok = r < rows_left;
          const long at = static_cast<long>(s0 + r) * kN2 + c;
          const float tc = ok ? tb.tc[at] : 0.f, ts = ok ? tb.ts[at] : 0.f;
          BR[r * kLd + c] = ar[j][e] * tc - ai[j][e] * ts;
          BI[r * kLd + c] = ar[j][e] * ts + ai[j][e] * tc;
        }
      }
    }
    __syncthreads();
    // Stage 3, the power and the half spectrum:
    // X = (BR + i BI) @ (c2 + i s2), P = |X|^2.
    {
      float xr[4][4] = {}, xi[4][4] = {};
      for (int k0 = 0; k0 < kN2; k0 += 16) {
        FragA fr, fi;
        load_a_smem(fr, BR, m0, k0);
        load_a_smem(fi, BI, m0, k0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragB c2, s2, ns2;
          load_b_pairs(c2, tb.c2h, tb.c2l, k0, n0 + 8 * j);
          load_b_pairs(s2, tb.s2h, tb.s2l, k0, n0 + 8 * j);
          load_b_pairs(ns2, tb.ns2h, tb.ns2l, k0, n0 + 8 * j);
          mma3(xr[j], fr, c2);
          mma3(xr[j], fi, ns2);
          mma3(xi[j], fr, s2);
          mma3(xi[j], fi, c2);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + g + (e >> 1) * 8, c = n0 + 8 * j + 2 * t + (e & 1);
          const float p = xr[j][e] * xr[j][e] + xi[j][e] * xi[j][e];
          P[r * kLd + c] = p;
          const int k1 = s0 + r;
          if (r < rows_left && (k1 & 1) == 0) {
            const int at = c * (s.N1 >> 1) + (k1 >> 1);
            if (at <= nh) half_f[at] = p;
          }
        }
      }
    }
    __syncthreads();
    // The inverse's first products: Ca, Sa = P @ (ca, sa); U and V in
    // place of B.
    {
      float ca[4][4] = {}, sa[4][4] = {};
      for (int k0 = 0; k0 < kN2; k0 += 16) {
        FragA fp;
        load_a_smem(fp, P, m0, k0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragB bc, bs;
          load_b_pairs(bc, tb.cah, tb.cal, k0, n0 + 8 * j);
          load_b_pairs(bs, tb.sah, tb.sal, k0, n0 + 8 * j);
          mma3(ca[j], fp, bc);
          mma3(sa[j], fp, bs);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + g + (e >> 1) * 8, c = n0 + 8 * j + 2 * t + (e & 1);
          const bool ok = r < rows_left;
          const long at = static_cast<long>(s0 + r) * kN2 + c;
          const float cb = ok ? tb.cb[at] : 0.f, sb = ok ? tb.sb[at] : 0.f;
          BR[r * kLd + c] = ca[j][e] * cb - sa[j][e] * sb;
          BI[r * kLd + c] = ca[j][e] * sb + sa[j][e] * cb;
        }
      }
    }
    __syncthreads();
    // The slab's share of the last product: acc[l2, l1] += cc[l2, k1] U[k1, l1]
    // - sc[l2, k1] V[k1, l1] over its k1 rows.
    {
      const int K = min(kSlab, rows_left);
      const int tiles = (s.rows + 15) / 16 * 4;
      for (int tile = warp; tile < tiles; tile += kWarps) {
        const int am0 = (tile >> 2) * 16, an0 = (tile & 3) * 32;
        float d[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = am0 + g + (e >> 1) * 8, c = an0 + 8 * j + 2 * t + (e & 1);
            d[j][e] = r < s.rows ? acc[r * kLd + c] : 0.f;
          }
        }
        for (int k0 = 0; k0 < K; k0 += 16) {
          FragA fc, fs;
          load_a_table(fc, tb.cch + s0, tb.ccl + s0, s.N1, s.rows, K, am0, k0);
          load_a_table(fs, tb.nsch + s0, tb.nscl + s0, s.N1, s.rows, K, am0, k0);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragB fu, fv;
            load_b_smem(fu, BR, K, k0, an0 + 8 * j);
            load_b_smem(fv, BI, K, k0, an0 + 8 * j);
            mma3(d[j], fc, fu);
            mma3(d[j], fs, fv);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = am0 + g + (e >> 1) * 8, c = an0 + 8 * j + 2 * t + (e & 1);
            if (r < s.rows) acc[r * kLd + c] = d[j][e];
          }
        }
      }
    }
    __syncthreads();
  }

  const float inv_N = 1.0f / static_cast<float>(2 * n);
  float* const acf = ac + f * n;
  for (int i = threadIdx.x; i < n; i += kThreads) acf[i] = acc[(i >> 7) * kLd + (i & (kN2 - 1))] * inv_N;
}

int launch(const void* x, const void* bf, const void* f32, void* half, void* ac, int B, int n, void* stream) {
  // voxtpu's gate (ops/ct_x3.py::ct_x3_supported) keeps n within kMaxN.
  if (n < kN2 || n % kN2 != 0 || n > kMaxN || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const int rows = n / kN2;
    const size_t smem = sizeof(float) * kLd * (2 * rows + 3 * kSlab);
    cudaError_t err = cudaFuncSetAttribute(ct_x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ct_x3_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const uint16_t*>(bf), static_cast<const float*>(f32),
        static_cast<float*>(half), static_cast<float*>(ac), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VT_EXPORT int vt_ct_x3_f32(const void* x, const void* bf, const void* f32, void* half, void* ac, int B, int n,
                           void* stream) {
  return launch(x, bf, f32, half, ac, B, n, stream);
}
