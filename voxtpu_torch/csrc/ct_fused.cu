// Kernel E: the n-point half power spectrum and the first n lags of
// irfft(|rfft(x, 2n)|^2) of (B, n) real frames in one pass.
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
// device memory sets the bound. The radix-2 kernel this one replaced ran 26
// barrier-separated passes over a 2n-point complex frame in shared memory
// (64 KB a block in float32) and took 7.254 ms there on an H100: barriers
// and shared-memory traffic set its time.
//
// Design: the real input is packed into half as many complex points and
// every transform is n points, in registers.
// - Forward: z[m] = x[2m] + i x[2m+1] for m < n/2, and 0 above (the zero
//   padding, which the first pass never loads). One n-point complex FFT
//   gives Z; the split X[k] = E - U, X[n-k] = conj(E + U), with
//   E = (Z[k] + conj Z[n-k]) / 2, U = i w^k (Z[k] - conj Z[n-k]) / 2,
//   w = e^{-2 pi i / N}, gives P[k] = |X[k]|^2 for k = 0 .. n in natural
//   order; half[k] = P[2k] is a strided pick.
// - Inverse: P is real and even, so W[k] = (P[k] + P[n-k]) + i w^{-k} (P[k]
//   - P[n-k]) packs the N-point inverse into one n-point inverse FFT, whose
//   output m holds ac[2m] + i ac[2m+1] times N. Only m < n/2 is needed, so
//   the last pass computes and stores those outputs alone. One thread
//   handles k and n-k together, so the split and the packing are one
//   exchange through shared memory, fused with the inverse's first pass.
// - Each transform is a self-sorting (Stockham) FFT of radix-16 passes,
//   the last of radix 2^(log2 n mod 4) where log2 n is not a multiple of 4
//   (n = 4096: 16 16 16; 2048: 16 16 8; 8192: 16 16 16 2). Each thread holds
//   kPoints = 16 complex values and does a whole radix-16 butterfly (or
//   16/R radix-R ones) in registers, its internal twiddles constants; threads
//   exchange through shared memory only between passes. A frame's exchange
//   buffer is n complex values (32 KB in float32, 64 KB in float64 at
//   n = 4096), XOR-swizzled so that a warp's stride-16 stores spread over
//   the banks. Frames of fewer than 2048 points share a block, up to
//   kMinBlockThreads threads.
// - Barriers a frame: 4P - 3 for P passes a transform: 9 at n = 512 .. 4096,
//   5 at 128 and 256, 13 at 8192 (the radix-2 kernel: 27 at n = 4096).
// - Twiddles: the host's table of w^k = cos - i sin of 2 pi k / N, k < n,
//   built in float64 and cast, interleaved (ops/ct_fused.py). A pass of
//   radix R over spans of Ns reads w^{s}, w^{2s}, w^{4s}, w^{8s} (s = (j mod
//   Ns) N / (Ns R) for butterfly j) and forms the others with at most three
//   products; the split reads w^k for its k. No __sincosf.
// - Memory: x is read as (x[2m], x[2m+1]) pairs, 8 bytes a thread in float32
//   and 16 in float64, and ac is stored the same way: a warp reads and
//   writes whole contiguous segments (256 bytes in float32), each byte once.
//   A 16-byte load in float32 would give a thread two neighbouring pairs,
//   which the first pass hands to two different butterflies. half rows
//   ((n/2 + 1) values) are not 16-byte aligned; they are stored as scalars.
// Built --fmad=false like the rest of the library: held to a tolerance
// against the plain version, not to bits. tests/test_torch_ct_fused.py's
// _model_ct_fused follows these steps in NumPy.
//
// Frames longer than one block holds (8192 in float32, 4096 in float64) run
// over a thread-block cluster: see ct_fused_cluster_kernel below. Frames
// whose length is not a power of two (voxtpu's other multiples of 128, up
// to 20,608) run ct_fused_pfa_kernel, a prime-factor split of n into a
// power of two and an odd factor: see below.
//
// Registers a thread (ptxas -v for sm_90a, as chip_smoke.py's build prints
// them), by n = 128 .. 8192: float32 104 114 128 128 128 127 119 (capped at
// 128, see Plan::kMinBlocks), float64 192 188 200 212 216 194; the clusters:
// 128 at 16,384 in float32, 246 and 255 at 8,192 and 16,384 in float64; 0
// bytes of stack frame and spill in all 16. Shared memory: none static;
// dynamic, a block's frames times n complex values: 16 KB in float32 and 32 KB in
// float64 for n <= 2048 (128 threads: 16 frames of 128 .. 1 of 2048), 32 KB
// and 64 KB at n = 4096 (256 threads), 64 KB at 8192 (512 threads). At the
// bench frame that is 2 blocks an SM in float32 (registers bind; 4 would
// need at most 64 a thread), 1 in float64. At bench shapes it takes
// 0.552 ms in float32, 2.9 times its bound (chip_smoke.py, NVIDIA H100
// 80GB HBM3, 700 W). The prime-factor kernel (lengths that are not powers
// of two): float32 212-232 registers at 256 threads (N1 <= 1024) and
// 125-128 at 512 (N1 >= 2048), float64 148-217 at 256, 0 bytes of stack
// frame and spill in all 30 instantiations.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPoints = 16;            // complex values a thread holds
constexpr int kMinBlockThreads = 128;  // small frames share a block up to this
constexpr int kMaxLog2 = 14;           // n <= 16384 in either dtype
constexpr int kBlockLog2F32 = 13;      // the largest frame one block holds: 8192 in float32
constexpr int kBlockLog2F64 = 12;      // 4096 in float64; above it a cluster of n / that blocks

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

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

// b * e^{-+2 pi i e / 16} (the conjugate root for the inverse), e in [0, 8).
template <typename T, bool kInv>
__device__ __forceinline__ Cx<T> rot16(Cx<T> b, int e) {
  if (e == 0) return b;
  if (e == 4) return kInv ? Cx<T>{-b.im, b.re} : Cx<T>{b.im, -b.re};
  constexpr double C1 = 0.92387953251128675613, C2 = 0.70710678118654752440, C3 = 0.38268343236508977173;
  const double c = e == 1 ? C1 : e == 2 ? C2 : e == 3 ? C3 : e == 5 ? -C3 : e == 6 ? -C2 : -C1;
  const double s = (e == 1 || e == 7) ? C3 : (e == 2 || e == 6) ? C2 : C1;
  return cmul(b, Cx<T>{T(c), kInv ? T(s) : T(-s)});
}

template <int R>
__device__ __forceinline__ constexpr int bitrev(int i) {
  int r = 0;
  for (int b = 1; b < R; b <<= 1, i >>= 1) r = (r << 1) | (i & 1);
  return r;
}

template <int R>
__device__ __forceinline__ constexpr int log2_of() {
  return R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
}

// The R-point DFT of v[0 .. R) in registers, natural order in and out:
// radix-2 decimation in time over the bit-reversed copy. kZeroUpper: v[R/2
// .. R) are zero and not read. kHalfOut: only outputs 0 .. R/2 are formed.
template <typename T, int R, bool kInv, bool kZeroUpper, bool kHalfOut>
__device__ __forceinline__ void dft(Cx<T>* v) {
  Cx<T> u[R];
  if (kZeroUpper) {
#pragma unroll
    for (int i = 0; i < R; i += 2) u[i] = u[i + 1] = v[bitrev<R>(i)];
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) u[i] = v[bitrev<R>(i)];
  }
#pragma unroll
  for (int st = kZeroUpper ? 1 : 0; st < log2_of<R>(); ++st) {
    const int s = 1 << st;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i & s) continue;
      const Cx<T> b = rot16<T, kInv>(u[i + s], (i & (s - 1)) * (8 >> st));
      if (kHalfOut && 2 * s == R) {
        u[i] = cadd(u[i], b);
        continue;
      }
      u[i + s] = csub(u[i], b);
      u[i] = cadd(u[i], b);
    }
  }
#pragma unroll
  for (int i = 0; i < (kHalfOut ? R / 2 : R); ++i) v[i] = u[i];
}

// v[r] *= w_N^{r s} for r = 1 .. R-1 (conjugated for the inverse): w^{s},
// w^{2s}, w^{4s} and w^{8s} from the table, the others as products of those.
template <typename T, int R, bool kInv>
__device__ __forceinline__ void twiddle(Cx<T>* v, const typename Vec2<T>::type* tw, int s) {
  Cx<T> p[R];
#pragma unroll
  for (int lb = 0; lb < log2_of<R>(); ++lb) {
    const auto w = __ldg(tw + (s << lb));
    p[1 << lb] = {w.x, kInv ? -w.y : w.y};
  }
#pragma unroll
  for (int r = 3; r < R; ++r) {
    const int hb = r >= 8 ? 8 : r >= 4 ? 4 : 2;
    if (r != hb) p[r] = cmul(p[hb], p[r - hb]);
  }
#pragma unroll
  for (int r = 1; r < R; ++r) v[r] = cmul(v[r], p[r]);
}

// Shared-memory index of complex value e of a frame: bits 0-3 XOR bits 4-7.
__device__ __forceinline__ int sw(int e) { return e ^ ((e >> 4) & 15); }

template <typename T>
__device__ __forceinline__ typename Vec2<T>::type pack(Cx<T> a) {
  return {a.re, a.im};
}

// One Stockham pass of radix R over spans of Ns (Ns > 1 but in kRow) of an
// n-point transform through the frame's buffer: butterflies j = t + q n/16
// read buf[j + r n/R] and write buf[(j - j mod Ns) R + j mod Ns + r Ns]. nt:
// the table's n (w = e^{-2 pi i / 2 nt}); n itself but in a cluster's share or
// a prime-factor row. kRow, for the prime-factor kernel's rows: spans of 1
// turn nothing, and a thread whose row lies past the frame's last (live
// false) only meets the barriers. Both are compile-time off for the
// power-of-two kernels: a run-time test there changed their registers and
// cost the float32 cluster a sixth of its time (PERF.md, §6).
template <typename T, int R, bool kInv, bool kRow = false>
__device__ __forceinline__ void exchange_pass(Cx<T>* v, typename Vec2<T>::type* buf,
                                              const typename Vec2<T>::type* tw, int t, int Ns, int n, int nt,
                                              bool live = true) {
  constexpr int G = kPoints / R;
  const int ft = n / kPoints, span = n / R;
  if (!kRow || live) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const auto a = buf[sw(t + q * ft + r * span)];
        v[q * R + r] = {a.x, a.y};
      }
    }
  }
  __syncthreads();
  if (!kRow || live) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int j = t + q * ft, jm = j & (Ns - 1);
      if (!kRow || Ns > 1) twiddle<T, R, kInv>(v + q * R, tw, jm * (2 * nt / (Ns * R)));
      dft<T, R, kInv, false, false>(v + q * R);
      const int base = (j - jm) * R + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[sw(base + r * Ns)] = pack(v[q * R + r]);
    }
  }
  __syncthreads();
}

// The split of the pair (k, n - k) from a = Z[k], b = Z[n-k] and w = w^k:
// E = (Z[k] + conj Z[n-k]) / 2 and U = i w^k (Z[k] - conj Z[n-k]) / 2 give
// P[k] = |E - U|^2 and P[n-k] = |E + U|^2. Each kernel stores the powers
// before it packs W (packed_w): one helper returning W as well gave the
// power-of-two kernels other registers and times.
template <typename T>
__device__ __forceinline__ void split_pair(typename Vec2<T>::type a, typename Vec2<T>::type b,
                                           typename Vec2<T>::type w, T& pk, T& pn) {
  const T er = (a.x + b.x) * T(0.5), ei = (a.y - b.y) * T(0.5);
  const T o_r = (a.x - b.x) * T(0.5), o_i = (a.y + b.y) * T(0.5);
  const T wo_r = w.x * o_r - w.y * o_i, wo_i = w.x * o_i + w.y * o_r;
  const T ur = -wo_i, ui = wo_r;  // U = i w^k O
  const T d1r = er - ur, d1i = ei - ui, d2r = er + ur, d2i = ei + ui;
  pk = d1r * d1r + d1i * d1i;
  pn = d2r * d2r + d2i * d2i;
}

// The inverse's packing W[k] = (P[k] + P[n-k]) + i w^{-k} (P[k] - P[n-k])
// from P[k], P[n-k] and w = w^k; W[n-k] is packed_w(P[n-k], P[k], w^{n-k}),
// w^{n-k} = -conj(w^k).
template <typename T>
__device__ __forceinline__ typename Vec2<T>::type packed_w(T pk, T pn, typename Vec2<T>::type w) {
  const T s = pk + pn, d = pk - pn;
  return {s + w.y * d, w.x * d};
}

template <typename T, int L>
struct Plan {
  static constexpr int n = 1 << L;
  // Blocks a frame (a cluster above the block's largest frame) and the
  // points m of each block's transform.
  static constexpr int kBlockLog2 = sizeof(T) == 4 ? kBlockLog2F32 : kBlockLog2F64;
  static constexpr int kCluster = L > kBlockLog2 ? 1 << (L - kBlockLog2) : 1;
  static constexpr int Lm = L > kBlockLog2 ? kBlockLog2 : L;
  static constexpr int m = 1 << Lm;
  static constexpr int kPasses = (Lm + 3) / 4;
  static constexpr int kLast = 1 << (Lm - 4 * (kPasses - 1));  // the last pass's radix
  static constexpr int kFrameThreads = m / kPoints;
  static constexpr int kFrames = kFrameThreads >= kMinBlockThreads ? 1 : kMinBlockThreads / kFrameThreads;
  static constexpr int kThreads = kFrames * kFrameThreads;
  // Blocks an SM must hold: float32 at most 128 registers a thread (two
  // blocks of the bench frame's 256 threads an SM, not one); float64 keeps
  // up to 255, which it needs to hold its 16 values without a spill.
  static constexpr int kMinBlocks = sizeof(T) == 4 && kThreads <= 256 ? 512 / kThreads : 1;
};

template <typename T, int L>
__global__ void __launch_bounds__(Plan<T, L>::kThreads, Plan<T, L>::kMinBlocks)
    ct_fused_kernel(const T* __restrict__ x, const T* __restrict__ tw_raw, T* __restrict__ half,
                    T* __restrict__ ac, int B) {
  using P = Plan<T, L>;
  static_assert(P::kCluster == 1, "a frame of one block");
  using V = typename Vec2<T>::type;
  constexpr int n = P::n, ft = P::kFrameThreads, span16 = n / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x % ft;
  const long frame = static_cast<long>(blockIdx.x) * P::kFrames + threadIdx.x / ft;
  const bool live = frame < B;
  V* buf = reinterpret_cast<V*>(smem_raw) + (threadIdx.x / ft) * n;
  const V* tw = reinterpret_cast<const V*>(tw_raw);
  Cx<T> v[kPoints];

  // Forward pass 0 (radix 16, spans of 1): butterfly t takes z[t + r n/16],
  // r < 8 from x; r >= 8 is the zero padding.
  const V* z = reinterpret_cast<const V*>(x + frame * n);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const V a = live ? __ldg(z + t + r * span16) : V{T(0), T(0)};
    v[r] = {a.x, a.y};
  }
  dft<T, 16, false, true, false>(v);
#pragma unroll
  for (int r = 0; r < 16; ++r) buf[sw(16 * t + r)] = pack(v[r]);
  __syncthreads();
  int Ns = 16;
#pragma unroll 1
  for (int p = 1; p < P::kPasses - 1; ++p, Ns *= 16) exchange_pass<T, 16, false>(v, buf, tw, t, Ns, n, n);
  exchange_pass<T, P::kLast, false>(v, buf, tw, t, Ns, n, n);

  // The split, the power and the inverse packing, fused with the inverse's
  // pass 0: the thread reads Z[k] and Z[n-k] for its k = t + r n/16 and
  // forms W[k] from P[k] and P[n-k].
  T* hr = half + frame * (n / 2 + 1);
  const bool even = live && (t & 1) == 0;  // k = t + r n/16 is even with t
  T p_n = T(0);                            // P[n], from k = 0 of thread 0
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int k = t + r * span16;
    const V a = buf[sw(k)], bz = buf[sw((n - k) & (n - 1))];
    const V w = __ldg(tw + k);
    T pk, pn;  // P[k], P[n-k]
    split_pair<T>(a, bz, w, pk, pn);
    if (even) hr[k >> 1] = pk;
    if (r == 0) p_n = pn;
    const V wk = packed_w<T>(pk, pn, w);
    v[r] = {wk.x, wk.y};
  }
  if (live && t == 0) hr[n / 2] = p_n;
  __syncthreads();
  dft<T, 16, true, false, false>(v);
#pragma unroll
  for (int r = 0; r < 16; ++r) buf[sw(16 * t + r)] = pack(v[r]);
  __syncthreads();
  Ns = 16;
#pragma unroll 1
  for (int p = 1; p < P::kPasses - 1; ++p, Ns *= 16) exchange_pass<T, 16, true>(v, buf, tw, t, Ns, n, n);

  // The inverse's last pass (spans of n/R, so j < Ns): outputs m = j + r n/R
  // for r < R/2 only, i.e. m < n/2, stored as ac[2m], ac[2m+1] over N.
  constexpr int R = P::kLast, G = kPoints / R, span = n / R;
#pragma unroll
  for (int q = 0; q < G; ++q) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const V a = buf[sw(t + q * ft + r * span)];
      v[q * R + r] = {a.x, a.y};
    }
  }
  if (!live) return;  // no barrier follows
  const T inv_N = T(1) / static_cast<T>(2 * n);
  V* ar = reinterpret_cast<V*>(ac + frame * n);
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int j = t + q * ft;
    twiddle<T, R, true>(v + q * R, tw, 2 * j);
    dft<T, R, true, false, true>(v + q * R);
#pragma unroll
    for (int r = 0; r < R / 2; ++r) ar[j + r * span] = V{v[q * R + r].re * inv_N, v[q * R + r].im * inv_N};
  }
}

// w^e for 0 <= e < 2n from the table of w^k, k < n: w^{k + n} = -w^k.
template <typename T>
__device__ __forceinline__ Cx<T> tw_at(const typename Vec2<T>::type* tw, int e, int n) {
  const bool hi = e >= n;
  const auto w = __ldg(tw + (hi ? e - n : e));
  return hi ? Cx<T>{-w.x, -w.y} : Cx<T>{w.x, w.y};
}

// A frame over a cluster of C = n / m blocks (16,384 in float32; 8,192 and
// 16,384 in float64), block c of the cluster holding residue class c of the
// spectrum: Z[C q + c] for q < m, the m-point FFT of
//   y_c[j] = (sum_{r < C/2} z[j + r m] w_C^{r c}) w_n^{j c},   j < m
// (z is zero from n/2 on, so r < C/2), each class in the single-block
// kernel's plan of m points, its registers and its shared memory. The
// split pairs k with n - k, which lies in class (C - c) mod C: block c reads
// that class through distributed shared memory when it is another block's
// (C = 4: blocks 1 and 3), after a cluster barrier, and a second one keeps
// the peer's Z in place until every block has read it. Block c then packs
// W[C q + c] and runs V_c, the m-point inverse FFT of its class (unpruned);
// after a cluster barrier each block forms its n / 2C outputs t of the
// inverse, sum_c' w_n^{-c' t} V_c'[t mod m], reading its peers' V_c'
// through distributed shared memory; a last cluster barrier keeps every
// block's buffer alive until its peers have read it. Twiddles: w_n^{j c} =
// w^{2 j c} and w_m = w^{2 C} from the same table; no __sincosf.
// Why a cluster: one block cannot hold these frames (16 values a thread
// would take 1,024 threads of at most 64 registers at 16,384 in float32,
// and 256 KB of exchange buffer at 16,384 in float64), while a split by
// residue class leaves each block today's largest plan and makes only the
// split and the last combination cross blocks. The cost: every block reads
// the whole frame (C reads of x, through L2), and each cluster barrier
// waits on the slowest block. At 3,840 frames of 16,384 floats it takes
// 1.15 ms against 0.19 ms of bytes (cuFFT's three calls 3.05); in float64
// 1.77 ms at 7,683 frames of 8,192 and 3.19 ms at 3,840 of 16,384
// (chip_smoke.py phases 14 and 16, NVIDIA H100 80GB HBM3, 700 W).
template <typename T, int L>
__global__ void __launch_bounds__(Plan<T, L>::kThreads, 1)
    ct_fused_cluster_kernel(const T* __restrict__ x, const T* __restrict__ tw_raw, T* __restrict__ half,
                            T* __restrict__ ac) {
  using P = Plan<T, L>;
  using V = typename Vec2<T>::type;
  constexpr int n = P::n, C = P::kCluster, m = P::m, span16 = m / 16;
  static_assert(C == 2 || C == 4, "clusters of 2 or 4 blocks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const long frame = blockIdx.x / C;
  const int t = threadIdx.x;
  V* buf = reinterpret_cast<V*>(smem_raw);
  const V* tw = reinterpret_cast<const V*>(tw_raw);
  Cx<T> v[kPoints];

  // Forward pass 0 (radix 16, spans of 1) on y_c: butterfly t takes
  // y_c[t + r m/16], formed from the frame as it is read.
  const V* z = reinterpret_cast<const V*>(x + frame * n);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int j = t + r * span16;
    const V a = __ldg(z + j);
    Cx<T> y = {a.x, a.y};
    if constexpr (C == 4) {
      const V b = __ldg(z + j + m);  // times (-i)^c
      const Cx<T> rb = c == 0 ? Cx<T>{b.x, b.y} : c == 1 ? Cx<T>{b.y, -b.x} : c == 2 ? Cx<T>{-b.x, -b.y}
                                                                                     : Cx<T>{-b.y, b.x};
      y = cadd(y, rb);
    }
    v[r] = c == 0 ? y : cmul(y, tw_at<T>(tw, 2 * j * c, n));
  }
  dft<T, 16, false, false, false>(v);
#pragma unroll
  for (int r = 0; r < 16; ++r) buf[sw(16 * t + r)] = pack(v[r]);
  __syncthreads();
  int Ns = 16;
#pragma unroll 1
  for (int p = 1; p < P::kPasses - 1; ++p, Ns *= 16) exchange_pass<T, 16, false>(v, buf, tw, t, Ns, m, n);
  exchange_pass<T, P::kLast, false>(v, buf, tw, t, Ns, m, n);

  // The split, the power and the inverse packing of class c, fused with
  // the inverse's pass 0: k = C q + c for q = t + r m/16, and n - k at q'
  // of class (C - c) mod C.
  const int cp = (C - c) % C;
  if constexpr (C == 4) cluster.sync();  // the peer's Z is whole
  // For C = 2 each class pairs with itself: a shared-memory pointer the
  // compiler can see (a mapped one is generic, 64-bit: at 254 registers in
  // float64 that spilled).
  const V* zp = C == 2 || cp == c ? buf : cluster.map_shared_rank(buf, cp);
  T* hr = half + frame * (n / 2 + 1);
  const bool even = (c & 1) == 0;  // k is even with c
  T p_n = T(0);                    // P[n], from k = 0 of block 0's thread 0
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int q = t + r * span16, k = C * q + c;
    const int qp = c == 0 ? (m - q) & (m - 1) : m - 1 - q;
    const V a = buf[sw(q)], bz = zp[sw(qp)];
    const V w = __ldg(tw + k);
    T pk, pn;  // P[k], P[n-k]
    split_pair<T>(a, bz, w, pk, pn);
    if (even) hr[k >> 1] = pk;
    if (r == 0) p_n = pn;
    const V wk = packed_w<T>(pk, pn, w);
    v[r] = {wk.x, wk.y};
  }
  if (c == 0 && t == 0) hr[n / 2] = p_n;
  if constexpr (C == 4) {
    cluster.sync();  // the peer has read this block's Z
  } else {
    __syncthreads();
  }
  dft<T, 16, true, false, false>(v);
#pragma unroll
  for (int r = 0; r < 16; ++r) buf[sw(16 * t + r)] = pack(v[r]);
  __syncthreads();
  Ns = 16;
#pragma unroll 1
  for (int p = 1; p < P::kPasses - 1; ++p, Ns *= 16) exchange_pass<T, 16, true>(v, buf, tw, t, Ns, m, n);
  exchange_pass<T, P::kLast, true>(v, buf, tw, t, Ns, m, n);
  cluster.sync();  // every class's V is whole

  // Outputs t_out = c m/2 + t + i m/16, i < 8 (this block's n / 2C of the
  // n / 2), stored as ac[2 t_out], ac[2 t_out + 1] over N.
  const V* vc[C];
#pragma unroll
  for (int cc = 0; cc < C; ++cc) vc[cc] = cc == c ? buf : cluster.map_shared_rank(buf, cc);
  const T inv_N = T(1) / static_cast<T>(2 * n);
  V* ar = reinterpret_cast<V*>(ac + frame * n);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int to = c * (m / 2) + t + i * span16, sidx = sw(to & (m - 1));
    const V a0 = vc[0][sidx];
    Cx<T> y = {a0.x, a0.y};
#pragma unroll
    for (int cc = 1; cc < C; ++cc) {
      const V a = vc[cc][sidx];
      const Cx<T> w = tw_at<T>(tw, (2 * cc * to) & (2 * n - 1), n);
      y = cadd(y, cmul(Cx<T>{a.x, a.y}, Cx<T>{w.re, -w.im}));
    }
    ar[to] = V{y.re * inv_N, y.im * inv_N};
  }
  cluster.sync();  // no block leaves while a peer reads its buffer
}

// Frames whose length n is not a power of two: n = N1 m with N1 = 2^Q
// (128 .. 4096) and m odd (3 .. 161), voxtpu's multiples of 128 up to
// 20,608. The same function as the kernels above: the frame packed into n/2
// complex points z, the n-point complex transform Z, the split to P[k] =
// |X[k]|^2 for k = 0 .. n, the even-spectrum packing W, its n-point inverse,
// and the first n/2 complex outputs over N = 2n as the lags.
//
// Each n-point transform is a prime-factor (Good-Thomas) split of n =
// N1 x m: since gcd(N1, m) = 1, with j1 = j mod N1, j2 = j mod m on the
// time side and k = (m k1 + N1 k2) mod n on the frequency side,
//   Z[k] = sum_{j1} w_N1^{j1 k1} sum_{j2} w_m^{j2 k2} z[j].
// The frame lives in a buffer of m rows of N1 points, row k2 holding one
// N1-point transform. The m-point DFTs (steps 1 and 5) are products with
// the m x m DFT matrix on the tensor cores:
// 1. Walking j = j1 + N1 i (i < m), j2 = (j1 + N1 i) mod m, so
//      Y[k2][j1] = w_m^{j1 k2} sum_i z[j1 + N1 i] w_m^{c i k2},  c = N1 mod m:
//    one product of the frame as it lies in memory (rows i, columns j1)
//    with a fixed matrix, then a turn by w_m^{j1 k2}. z is zero from n/2
//    on, so i < (m + 1)/2 = mh; and w_m^{c i (m - k2)} is the conjugate of
//    w_m^{c i k2}, so with C + i S the matrix's real and imaginary parts at
//    k2 < mh, the four real products z_re C, z_im S, z_im C, z_re S (each
//    (N1 x mh) @ (mh x mh)) give the outputs k2 and m - k2 together:
//    Y[k2] = w^{j1 k2} ((AC + BS) + i (BC - AS)), Y[m - k2] = w^{-j1 k2}
//    ((AC - BS) + i (BC + AS)). A quarter of the operations of the m x m
//    complex product over the whole buffer.
// 2. the N1-point FFTs along each row, in the radix-16 Stockham passes of
//    the kernels above (N1 / 16 threads a row, 16 values a thread, the
//    block's rows a round at a time);
// 3. the split of each pair (k, n - k), k <= n/2, by one thread in place:
//    k1 = k m^-1 mod N1 (a mask) and k2 = k N1^-1 mod m, stepped by
//    addition from one k to the thread's next (the host passes both
//    inverses), the partner at (-k1, -k2); it writes P[k] and P[n - k] to
//    the half spectrum and W[k] and W[n - k] over Z;
// 4. the inverse N1-point FFTs along the rows;
// 5. the fold, in place (`pfa_fold`): for 0 < k2 < mh, a = V[k2] w^{-j1 k2}
//    and b = V[m - k2] w^{j1 k2} give P = a + b in row k2 and M = a - b in
//    row m - k2 (row 0 keeps V[0] as P, with M = 0); then the inverse
//    m-point DFTs for the outputs j = j1 + N1 i < n/2 alone (i < mh):
//    out[i][j1] = sum_{k2 < mh} (C P_re - S M_im) + i (C P_im + S M_re),
//    four real products (N1 x mh) @ (mh x mh), stored as ac[2j], ac[2j+1]
//    over N.
// The products run on mma.sync (`Tc`): float32 as m16n8k8 on TF32 in
// three passes (a = a_hi + a_lo, each rounded to TF32's 10 mantissa bits,
// to nearest: a_lo b_hi + a_hi b_lo + a_hi b_hi, the dropped a_lo b_lo
// about 2^-22 of a product), into a fresh sum each K tile that the CUDA
// cores add up (the tensor cores' float32 sums truncate); float64 as
// m8n8k4 on the FP64 tensor cores. Where mh > kP (m > 15 in float32, > 7
// in float64) a warp takes an M tile of 16 (float64 8) columns j1 and a
// chunk of N tiles of 8 (kPfaChunk in step 1, whose outputs are four
// sums; kPfaChunk5 in step 5, two sums), the K loop over mh. Where mh <=
// kP one tile holds the whole product and its padding would be zeros:
// there `Pack` puts kP / mhp M subtiles' columns into one tile's K and N,
// the matrix block-diagonal (m = 3: four subtiles a tile, every lane's
// output live), its B fragments built once a stage. The matrix's entries
// are w_m^{c k n mod m}: one table of the m roots w_m^e in shared memory
// (from the table of w = e^{-2 pi i / N}, w_m = w^{2 N1}), the index
// stepped by addition along K and from tile to tile (no % on an element's
// path; a tile's setup takes a few modulos by a float reciprocal, `ModM`),
// split to TF32 as it is read.
// Persistent blocks, one an SM (`PfaPlan`), walk the frames: 256 threads
// (float32 up to about 230 registers, float64 255), or in float32 where
// N1 >= 2048 (m <= 9: the packed tiles alone) 512 threads at up to 128,
// two rows a round of the 4096-point FFTs. Where the staged block fits
// (`pfa_staged`: n <= 19,200 in float32, 9,600 in float64), the next
// frame's n/2 input points arrive in shared memory by one bulk copy
// (cp.async.bulk onto an mbarrier) while the current frame runs steps
// 2-5; otherwise step 1 reads them from device memory, the next K tile's
// points loaded before the current one's products. Staging pays where
// frames are short: at 2,176 float64 2.385 ms staged against 2.818 and
// 2.823 read from device memory, float32 1.863 and 1.955 against 1.991
// and 2.000; at 12,288 within 1% (chip_smoke.py --kernel-e, the two in
// turns, NVIDIA H100 80GB HBM3, 700 W).
// The buffer is the block's shared memory (n + m complex values: 165 KB at
// 20,608 in float32, plus n/2 for the staged input), or, in float64 above
// 14,336 points, where n + m values outgrow the 227 KB a block may have, a
// slice of a scratch buffer in device memory that the wrapper allocates
// (kDev: one slice a block, one block an SM; the slices stay in L2).
// Within a block __syncthreads orders the accesses to either.
// What bounds it: the function's bytes (0.188 ms at each of 2,176, 12,288
// and 20,096 on the recording, float32); its tensor-core products alone
// take 0.092, 0.033 and 0.249 ms at the TF32 rate. It takes 1.863-1.955,
// 1.198-1.204 and 2.086-2.090 ms there, 6-11 times the bound (its first
// version, direct m-point DFTs on the CUDA cores: 2.680-2.700,
// 1.329-1.336 and 8.490-8.508 in the same call; X3 2.247-2.290,
// 1.684-1.711, 2.236-2.260); float64 2.385, 2.276-2.277 and, with the
// buffer in device memory, 9.160-9.171 (the first version 4.013-4.014,
// 2.350-2.378, 26.284-26.578; cuFFT 6.79-6.80, 7.20-7.22, 20.73-20.75)
// (chip_smoke.py --kernel-e, NVIDIA H100 80GB HBM3, 700 W). One block of 8-16
// warps an SM waits on its barriers and on the row FFTs' shared-memory
// passes, which it does not overlap with the products.
constexpr int kPfaThreads = 256;    // 8 warps a block ...
constexpr int kPfaWideThreads = 512;  // ... 16 in float32 where N1 >= 2^kPfaWideLog2
constexpr int kPfaWideLog2 = 11;
constexpr int kPfaChunk = 2;        // N tiles a warp's step-1 accumulators hold (four sums each)
constexpr int kPfaChunk5 = 4;       // N tiles of step 5 (two sums each)
constexpr int kPfaMinLog2 = 7;      // N1 = 2^Q from 128 ...
constexpr int kPfaMaxLog2 = 12;     // ... to 4096 (n = 4096 x 5 = 20,480)
constexpr int kMaxN = 20608;        // voxtpu's largest frame: 128 x 161
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may have (227 KB)

// Whether a frame of n = N1 m in the shared layout stages its input: where
// the staged block fits (one block an SM either way: see PfaPlan).
template <typename T>
bool pfa_staged(int n, int m) {
  return (n + n / 2 + m) * 2 * sizeof(T) + 8 <= static_cast<size_t>(kSmemLimit);
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// a mod m for 0 <= a < 2^24, by a float reciprocal and a correction each
// way: the setup of a tile's index walks (no % on an element's path).
struct ModM {
  int m;
  float inv;
  __device__ explicit ModM(int m_) : m(m_), inv(1.0f / static_cast<float>(m_)) {}
  __device__ int operator()(int a) const {
    int r = a - __float2int_rz(__int2float_rn(a) * inv) * m;
    r += r < 0 ? m : 0;
    return r - (r >= m ? m : 0);
  }
};

// One warp's tensor-core product tile: its fragments' element positions
// (g = lane / 4, t = lane % 4) and the product. `add` adds a b to acc.
template <typename T>
struct Tc;

// float32: mma.sync m16n8k8 on TF32 in three passes, into a fresh sum for
// each K tile that is then added to acc on the CUDA cores: the tensor
// cores' float32 sums truncate, and one chain of mma over the whole K loop
// carried that bias to 3.2e-6 of a frame's largest value at 20,096 = 128 x
// 157 against the 4e-6 allowed (a development version timed by a copy of
// chip_smoke.py's phase 14, not kept; with the fresh sums 5.6e-7 of the
// float64 FFT there, and at most 6.4e-7 on phase 8's noise at the 153
// lengths: chip_smoke.py --kernel-e, NVIDIA H100 80GB HBM3).
template <>
struct Tc<float> {
  static constexpr int kM = 16, kN = 8, kK = 8, kP = 8, kA = 4, kB = 2, kC = 4;
  struct A {
    uint32_t hi[kA], lo[kA];
  };
  struct B {
    uint32_t hi[kB], lo[kB];
  };
  __device__ static int a_row(int e, int g) { return g + 8 * (e & 1); }
  __device__ static int a_col(int e, int t) { return t + 4 * (e >> 1); }
  __device__ static int b_row(int e, int t) { return t + 4 * e; }
  __device__ static int c_row(int e, int g) { return g + 8 * (e >> 1); }
  __device__ static int c_col(int e, int t) { return 2 * t + (e & 1); }
  template <typename F>
  __device__ static void set(F& f, int e, float v) {
    f.hi[e] = tf32_rna(v);
    f.lo[e] = tf32_rna(v - __uint_as_float(f.hi[e]));
  }
  __device__ static void one(float (&c)[kC], const uint32_t (&a)[kA], const uint32_t (&b)[kB]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static void add(float (&acc)[kC], const A& a, const B& b) {
    float s[kC] = {0.f, 0.f, 0.f, 0.f};
    one(s, a.lo, b.hi);
    one(s, a.hi, b.lo);
    one(s, a.hi, b.hi);
#pragma unroll
    for (int e = 0; e < kC; ++e) acc[e] += s[e];
  }
};

// float64: mma.sync m8n8k4 on the FP64 tensor cores, one pass into acc.
template <>
struct Tc<double> {
  static constexpr int kM = 8, kN = 8, kK = 4, kP = 4, kA = 1, kB = 1, kC = 2;
  struct A {
    double v[kA];
  };
  struct B {
    double v[kB];
  };
  __device__ static int a_row(int, int g) { return g; }
  __device__ static int a_col(int, int t) { return t; }
  __device__ static int b_row(int, int t) { return t; }
  __device__ static int c_row(int, int g) { return g; }
  __device__ static int c_col(int e, int t) { return 2 * t + e; }
  template <typename F>
  __device__ static void set(F& f, int e, double v) {
    f.v[e] = v;
  }
  __device__ static void add(double (&acc)[kC], const A& a, const B& b) {
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
        : "+d"(acc[0]), "+d"(acc[1])
        : "d"(a.v[0]), "d"(b.v[0]));
  }
};

// The prime-factor kernel's launch at N1 = 2^Q. One block an SM: float32
// at 256 threads keeps up to about 230 registers a thread; where N1 >=
// 2048, whose m is at most 9 (so steps 1 and 5 take the packed tiles
// alone), 512 threads at most 128 registers, two rows a round of its
// 4096-point FFTs. kLarge: whether some m at this N1 takes more than one
// tile (mh > kP), so that the chunked steps are built at all.
template <typename T, int Q>
struct PfaPlan {
  static constexpr bool kWide = sizeof(T) == 4 && Q >= kPfaWideLog2;
  static constexpr int kThreads = kWide ? kPfaWideThreads : kPfaThreads;
  static constexpr int kMaxM = ((kMaxN >> Q) - 1) | 1;  // the largest odd m with N1 m <= kMaxN
  static constexpr bool kLarge = (kMaxM + 1) / 2 > Tc<T>::kP;
};

// The matrix's B fragments of N tile `tile` (columns n = tile kN + g) as
// the K loop walks: entry (k, n) is roots[c k n mod m]; e holds the index
// of each fragment element, d its step from one K tile to the next.
template <typename T>
struct BWalk {
  using M = Tc<T>;
  int e[M::kB], d;
  __device__ void start(int tile, int c, const ModM& mod, int g, int t) {
    const int col = tile * M::kN + g;
    d = mod(M::kK * c * col);
#pragma unroll
    for (int i = 0; i < M::kB; ++i) e[i] = mod(c * M::b_row(i, t) * col);
  }
  // The fragments of C and S at the current K tile, then a step along K.
  __device__ void next(const typename Vec2<T>::type* roots, int m, typename M::B& bc, typename M::B& bs) {
#pragma unroll
    for (int i = 0; i < M::kB; ++i) {
      const auto r = roots[e[i]];
      M::set(bc, i, r.x);
      M::set(bs, i, -r.y);
      e[i] += d;
      e[i] -= e[i] >= m ? m : 0;
    }
  }
};

// Step 1: Y[k2][j1] for every k2 < m from the frame's n/2 points `src`
// (shared memory where kStaged, else device memory), into buf. A warp
// walks its (M tile, chunk) items and each item's K tiles as one loop, the
// next step's points loaded before the current step's products.
template <typename T, int Q, bool kStaged>
__device__ __forceinline__ void pfa_dft_in(const typename Vec2<T>::type* src, typename Vec2<T>::type* buf,
                                           const typename Vec2<T>::type* roots, int m, const ModM& mod) {
  using M = Tc<T>;
  using V = typename Vec2<T>::type;
  constexpr int N1 = 1 << Q, kTilesM = N1 / M::kM, kWarps = PfaPlan<T, Q>::kThreads / 32;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = (m << Q) / 2, mh = (m + 1) / 2, c = N1 % m;
  const int tiles = (mh + M::kN - 1) / M::kN, ksteps = (mh + M::kK - 1) / M::kK;
  const int items = kTilesM * ((tiles + kPfaChunk - 1) / kPfaChunk);
  auto load = [&](int item, int ks, V (&z)[M::kA]) {
#pragma unroll
    for (int e = 0; e < M::kA; ++e) {
      const int j = (ks * M::kK + M::a_col(e, t)) * N1 + (item % kTilesM) * M::kM + M::a_row(e, g);
      z[e] = V{T(0), T(0)};
      if (j < nh) z[e] = kStaged ? src[j] : __ldg(src + j);
    }
  };
  T acc[kPfaChunk][4][M::kC];
  BWalk<T> walk[kPfaChunk];
  V z[M::kA];
  int item = threadIdx.x >> 5, ks = 0;
  if (item < items) load(item, 0, z);
#pragma unroll 1
  while (item < items) {
    const int j0 = (item % kTilesM) * M::kM, t0 = (item / kTilesM) * kPfaChunk;
    if (ks == 0) {
#pragma unroll
      for (int q = 0; q < kPfaChunk; ++q) {
        walk[q].start(t0 + q, c, mod, g, t);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int e = 0; e < M::kC; ++e) acc[q][p][e] = T(0);
        }
      }
    }
    typename M::A ar, ai;
#pragma unroll
    for (int e = 0; e < M::kA; ++e) {
      M::set(ar, e, z[e].x);
      M::set(ai, e, z[e].y);
    }
    const bool last = ks + 1 == ksteps;
    const int next_item = last ? item + kWarps : item, next_ks = last ? 0 : ks + 1;
    if (next_item < items) load(next_item, next_ks, z);
#pragma unroll
    for (int q = 0; q < kPfaChunk; ++q) {
      if (t0 + q < tiles) {
        typename M::B bc, bs;
        walk[q].next(roots, m, bc, bs);
        M::add(acc[q][0], ar, bc);
        M::add(acc[q][1], ai, bs);
        M::add(acc[q][2], ai, bc);
        M::add(acc[q][3], ar, bs);
      }
    }
    if (last) {
      // Y[k2] and Y[m - k2], turned by w_m^{+-j1 k2}: the roots' index et
      // steps by kN j1 from one N tile to the next.
#pragma unroll
      for (int e = 0; e < M::kC; ++e) {
        const int jm = mod(j0 + M::c_row(e, g)), dt = mod(M::kN * jm), col = sw(j0 + M::c_row(e, g));
        int et = mod(jm * (t0 * M::kN + M::c_col(e, t)));
#pragma unroll
        for (int q = 0; q < kPfaChunk; ++q) {
          const int k2 = (t0 + q) * M::kN + M::c_col(e, t);
          if (t0 + q < tiles && k2 < mh) {
            const T a_c = acc[q][0][e], b_s = acc[q][1][e], b_c = acc[q][2][e], a_s = acc[q][3][e];
            const V w = roots[et];
            buf[k2 * N1 + col] = pack(cmul(Cx<T>{a_c + b_s, b_c - a_s}, Cx<T>{w.x, w.y}));
            if (k2 > 0) buf[(m - k2) * N1 + col] = pack(cmul(Cx<T>{a_c - b_s, b_c + a_s}, Cx<T>{w.x, -w.y}));
          }
          et += dt;
          et -= et >= m ? m : 0;
        }
      }
    }
    item = next_item;
    ks = next_ks;
  }
}

// Between steps 4 and 5, in place: for k2 = 1 .. mh - 1, with a = V[k2]
// w_m^{-j1 k2} and b = V[m - k2] w_m^{j1 k2}, row k2 takes P = a + b and row
// m - k2 takes M = a - b (row 0 keeps V[0]). kPer threads a column j1, each
// every kPer-th k2, its root's index stepping by kPer j1 mod m.
template <typename T, int Q>
__device__ __forceinline__ void pfa_fold(typename Vec2<T>::type* buf, const typename Vec2<T>::type* roots, int m,
                                         const ModM& mod) {
  using V = typename Vec2<T>::type;
  constexpr int N1 = 1 << Q, kThreads = PfaPlan<T, Q>::kThreads;
  constexpr int kCols = N1 < kThreads ? N1 : kThreads, kPer = kThreads / kCols;
  const int mh = (m + 1) / 2, first = 1 + static_cast<int>(threadIdx.x) / kCols;
#pragma unroll 1
  for (int j1 = threadIdx.x % kCols; j1 < N1; j1 += kCols) {
    const int jm = mod(j1), col = sw(j1), step = mod(kPer * jm);
    int e = mod(jm * first);
#pragma unroll 2
    for (int k2 = first; k2 < mh; k2 += kPer) {
      const V w = roots[e], a = buf[k2 * N1 + col], b = buf[(m - k2) * N1 + col];
      const Cx<T> u = cmul(Cx<T>{a.x, a.y}, Cx<T>{w.x, -w.y}), v = cmul(Cx<T>{b.x, b.y}, Cx<T>{w.x, w.y});
      buf[k2 * N1 + col] = pack(cadd(u, v));
      buf[(m - k2) * N1 + col] = pack(csub(u, v));
      e += step;
      e -= e >= m ? m : 0;
    }
  }
}

// Step 5: the outputs j = j1 + N1 i < n/2 of the inverse m-point DFTs from
// buf's folded rows (P in row k2 < mh, M in row m - k2), over N, into ar.
template <typename T, int Q>
__device__ __forceinline__ void pfa_dft_out(const typename Vec2<T>::type* buf, const typename Vec2<T>::type* roots,
                                            typename Vec2<T>::type* ar, int m, T inv_N, const ModM& mod) {
  using M = Tc<T>;
  using V = typename Vec2<T>::type;
  constexpr int N1 = 1 << Q, kTilesM = N1 / M::kM;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = (m << Q) / 2, mh = (m + 1) / 2, c = N1 % m;
  const int tiles = (mh + M::kN - 1) / M::kN, ksteps = (mh + M::kK - 1) / M::kK;
  const int items = kTilesM * ((tiles + kPfaChunk5 - 1) / kPfaChunk5);
#pragma unroll 1
  for (int item = threadIdx.x >> 5; item < items; item += PfaPlan<T, Q>::kThreads / 32) {
    const int j0 = (item % kTilesM) * M::kM, t0 = (item / kTilesM) * kPfaChunk5;
    T acc[kPfaChunk5][2][M::kC];
    BWalk<T> walk[kPfaChunk5];
#pragma unroll
    for (int q = 0; q < kPfaChunk5; ++q) {
      walk[q].start(t0 + q, c, mod, g, t);
#pragma unroll
      for (int e = 0; e < M::kC; ++e) acc[q][0][e] = acc[q][1][e] = T(0);
    }
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      typename M::A pr, pi, nmi, mr;
#pragma unroll
      for (int e = 0; e < M::kA; ++e) {
        const int k2 = ks * M::kK + M::a_col(e, t), col = sw(j0 + M::a_row(e, g));
        V p = {T(0), T(0)}, d = {T(0), T(0)};
        if (k2 < mh) p = buf[k2 * N1 + col];
        if (k2 > 0 && k2 < mh) d = buf[(m - k2) * N1 + col];
        M::set(pr, e, p.x);
        M::set(pi, e, p.y);
        M::set(nmi, e, -d.y);
        M::set(mr, e, d.x);
      }
#pragma unroll
      for (int q = 0; q < kPfaChunk5; ++q) {
        if (t0 + q < tiles) {
          typename M::B bc, bs;
          walk[q].next(roots, m, bc, bs);
          M::add(acc[q][0], pr, bc);
          M::add(acc[q][0], nmi, bs);
          M::add(acc[q][1], pi, bc);
          M::add(acc[q][1], mr, bs);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPfaChunk5; ++q) {
#pragma unroll
      for (int e = 0; e < M::kC; ++e) {
        const int j = ((t0 + q) * M::kN + M::c_col(e, t)) * N1 + j0 + M::c_row(e, g);
        if (t0 + q < tiles && j < nh) ar[j] = V{acc[q][0][e] * inv_N, acc[q][1][e] * inv_N};
      }
    }
  }
}

// Steps 1 and 5 where mh fits one K tile (mh <= kP = min(kK, kN): m <= 15
// in float32, m <= 7 in float64): the tile's K and N hold `groups` = kP /
// mhp groups (mhp the power of two >= mh), group p for M subtile p, the
// matrix block-diagonal in the fragments, so that the padding of a small
// m carries other columns j1 and not zeros. The B fragments are then the
// same for every tile: built once a stage.
template <typename T>
struct Pack {
  using M = Tc<T>;
  int sh, groups, span;  // mhp = 1 << sh; a tile covers span = groups kM columns j1
  typename M::B bc, bs;  // the block-diagonal matrix's C and S
  __device__ Pack(int m, int mh, int c, const typename Vec2<T>::type* roots, const ModM& mod, int g, int t) {
    sh = 0;
    while ((1 << sh) < mh) ++sh;
    groups = M::kP >> sh;
    span = groups * M::kM;
    const int lo = (1 << sh) - 1;
#pragma unroll
    for (int e = 0; e < M::kB; ++e) {
      const int k = M::b_row(e, t);
      const bool live = (k >> sh) == (g >> sh) && (g >> sh) < groups && (k & lo) < mh && (g & lo) < mh;
      const auto r = roots[live ? mod(c * (k & lo) * (g & lo)) : 0];
      M::set(bc, e, live ? r.x : T(0));
      M::set(bs, e, live ? -r.y : T(0));
    }
  }
};

// Step 1 where mh <= kP: as pfa_dft_in, a warp's tiles `span` columns
// apart, the next tile's points loaded before the current tile's products.
template <typename T, int Q, bool kStaged>
__device__ __forceinline__ void pfa_dft_in_small(const typename Vec2<T>::type* src, typename Vec2<T>::type* buf,
                                                 const typename Vec2<T>::type* roots, int m, const ModM& mod) {
  using M = Tc<T>;
  using V = typename Vec2<T>::type;
  constexpr int N1 = 1 << Q, kWarps = PfaPlan<T, Q>::kThreads / 32;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = (m << Q) / 2, mh = (m + 1) / 2;
  const Pack<T> pk(m, mh, N1 % m, roots, mod, g, t);
  const int lo = (1 << pk.sh) - 1, first = (threadIdx.x >> 5) * pk.span, stride = kWarps * pk.span;
  // A element e: z[aj[e] + j0 + aoff[e]], row i = aj[e] / N1 (nh: a padding row).
  int aoff[M::kA], aj[M::kA];
#pragma unroll
  for (int e = 0; e < M::kA; ++e) {
    const int k = M::a_col(e, t);
    aoff[e] = (k >> pk.sh) * M::kM + M::a_row(e, g);
    aj[e] = (k & lo) < mh ? (k & lo) * N1 : nh;
  }
  // C element e: Y[ck[e]][j0 + coff[e]] (ck = mh: dropped), turned by
  // roots[et[e]], et stepping by det[e] from one tile to the next.
  int coff[M::kC], ck[M::kC], et[M::kC], det[M::kC];
#pragma unroll
  for (int e = 0; e < M::kC; ++e) {
    const int n = M::c_col(e, t);
    coff[e] = (n >> pk.sh) * M::kM + M::c_row(e, g);
    ck[e] = (n >> pk.sh) < pk.groups && (n & lo) < mh ? n & lo : mh;
    const int k2 = ck[e] < mh ? ck[e] : 0;
    et[e] = mod(mod(first + coff[e]) * k2);
    det[e] = mod(mod(stride) * k2);
  }
  auto load = [&](int j0, V (&z)[M::kA]) {
#pragma unroll
    for (int e = 0; e < M::kA; ++e) {
      const int j = aj[e] + j0 + aoff[e];
      z[e] = V{T(0), T(0)};
      if (j < nh) z[e] = kStaged ? src[j] : __ldg(src + j);
    }
  };
  V z[M::kA];
  if (first < N1) load(first, z);
#pragma unroll 1
  for (int j0 = first; j0 < N1; j0 += stride) {
    typename M::A ar, ai;
#pragma unroll
    for (int e = 0; e < M::kA; ++e) {
      M::set(ar, e, z[e].x);
      M::set(ai, e, z[e].y);
    }
    if (j0 + stride < N1) load(j0 + stride, z);
    T acc[4][M::kC];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int e = 0; e < M::kC; ++e) acc[p][e] = T(0);
    }
    M::add(acc[0], ar, pk.bc);
    M::add(acc[1], ai, pk.bs);
    M::add(acc[2], ai, pk.bc);
    M::add(acc[3], ar, pk.bs);
#pragma unroll
    for (int e = 0; e < M::kC; ++e) {
      const int k2 = ck[e], col = sw(j0 + coff[e]);
      if (k2 < mh) {
        const T a_c = acc[0][e], b_s = acc[1][e], b_c = acc[2][e], a_s = acc[3][e];
        const V w = roots[et[e]];
        buf[k2 * N1 + col] = pack(cmul(Cx<T>{a_c + b_s, b_c - a_s}, Cx<T>{w.x, w.y}));
        if (k2 > 0) buf[(m - k2) * N1 + col] = pack(cmul(Cx<T>{a_c - b_s, b_c + a_s}, Cx<T>{w.x, -w.y}));
      }
      et[e] += det[e];
      et[e] -= et[e] >= m ? m : 0;
    }
  }
}

// Step 5 where mh <= kP: as pfa_dft_out, over the same packed tiles.
template <typename T, int Q>
__device__ __forceinline__ void pfa_dft_out_small(const typename Vec2<T>::type* buf,
                                                  const typename Vec2<T>::type* roots, typename Vec2<T>::type* ar,
                                                  int m, T inv_N, const ModM& mod) {
  using M = Tc<T>;
  using V = typename Vec2<T>::type;
  constexpr int N1 = 1 << Q, kWarps = PfaPlan<T, Q>::kThreads / 32;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = (m << Q) / 2, mh = (m + 1) / 2;
  const Pack<T> pk(m, mh, N1 % m, roots, mod, g, t);
  const int lo = (1 << pk.sh) - 1, first = (threadIdx.x >> 5) * pk.span, stride = kWarps * pk.span;
  // A element e: P from row ak[e], M from row m - ak[e], column j0 + aoff[e].
  int aoff[M::kA], ak[M::kA];
#pragma unroll
  for (int e = 0; e < M::kA; ++e) {
    const int k = M::a_col(e, t);
    aoff[e] = (k >> pk.sh) * M::kM + M::a_row(e, g);
    ak[e] = k & lo;
  }
  // C element e: output cj[e] + j0 + coff[e] (cj = nh: dropped).
  int coff[M::kC], cj[M::kC];
#pragma unroll
  for (int e = 0; e < M::kC; ++e) {
    const int n = M::c_col(e, t);
    coff[e] = (n >> pk.sh) * M::kM + M::c_row(e, g);
    cj[e] = (n >> pk.sh) < pk.groups && (n & lo) < mh ? (n & lo) * N1 : nh;
  }
#pragma unroll 1
  for (int j0 = first; j0 < N1; j0 += stride) {
    typename M::A pr, pi, nmi, mr;
#pragma unroll
    for (int e = 0; e < M::kA; ++e) {
      const int k2 = ak[e], col = sw(j0 + aoff[e]);
      V p = {T(0), T(0)}, d = {T(0), T(0)};
      if (k2 < mh) p = buf[k2 * N1 + col];
      if (k2 > 0 && k2 < mh) d = buf[(m - k2) * N1 + col];
      M::set(pr, e, p.x);
      M::set(pi, e, p.y);
      M::set(nmi, e, -d.y);
      M::set(mr, e, d.x);
    }
    T acc[2][M::kC];
#pragma unroll
    for (int e = 0; e < M::kC; ++e) acc[0][e] = acc[1][e] = T(0);
    M::add(acc[0], pr, pk.bc);
    M::add(acc[0], nmi, pk.bs);
    M::add(acc[1], pi, pk.bc);
    M::add(acc[1], mr, pk.bs);
#pragma unroll
    for (int e = 0; e < M::kC; ++e) {
      const int j = cj[e] + j0 + coff[e];
      if (j < nh) ar[j] = V{acc[0][e] * inv_N, acc[1][e] * inv_N};
    }
  }
}

// The N1-point FFT (N1 = 2^Q) of every one of the m rows of buf, the
// block's threads taking PfaPlan::kThreads / (N1 / 16) rows a round.
template <typename T, int Q, bool kInv>
__device__ __forceinline__ void row_ffts(typename Vec2<T>::type* buf, const typename Vec2<T>::type* tw, int m,
                                         int n) {
  constexpr int N1 = 1 << Q, ft = N1 / kPoints, rows = PfaPlan<T, Q>::kThreads / ft;
  constexpr int kPasses = (Q + 3) / 4, kLast = 1 << (Q - 4 * (kPasses - 1));
  const int t = threadIdx.x % ft;
  Cx<T> v[kPoints];
#pragma unroll 1
  for (int r0 = 0; r0 < m; r0 += rows) {
    const int row = r0 + static_cast<int>(threadIdx.x) / ft;
    const bool live = row < m;
    auto* rb = buf + (live ? row : 0) * N1;
    exchange_pass<T, 16, kInv, true>(v, rb, tw, t, 1, N1, n, live);
    int Ns = 16;
#pragma unroll 1
    for (int p = 1; p < kPasses - 1; ++p, Ns *= 16) exchange_pass<T, 16, kInv, true>(v, rb, tw, t, Ns, N1, n, live);
    exchange_pass<T, kLast, kInv, true>(v, rb, tw, t, Ns, N1, n, live);
  }
}

// kDev: the buffer in `scratch`, one slice of n complex values a block;
// kStaged: each frame's input staged in shared memory by a bulk copy.
template <typename T, int Q, bool kDev, bool kStaged>
__global__ void __launch_bounds__(PfaPlan<T, Q>::kThreads, 1)
    ct_fused_pfa_kernel(const T* __restrict__ x, const T* __restrict__ tw_raw, T* __restrict__ half,
                        T* __restrict__ ac, T* __restrict__ scratch, int B, int m, int inv_m, int inv_n1) {
  using V = typename Vec2<T>::type;
  constexpr int N1 = 1 << Q, kThreads = PfaPlan<T, Q>::kThreads;
  const int n = m << Q, nh = n / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* const smem = reinterpret_cast<V*>(smem_raw);
  V* buf = kDev ? reinterpret_cast<V*>(scratch) + static_cast<long>(blockIdx.x) * n : smem;
  V* stage = smem + (kDev ? 0 : n);               // kStaged: the frame's n/2 points
  V* roots = stage + (kStaged ? nh : 0);          // w_m^e, e < m
  uint64_t* bar = reinterpret_cast<uint64_t*>(roots + m);
  const V* tw = reinterpret_cast<const V*>(tw_raw);
  const uint32_t bytes = static_cast<uint32_t>(n * sizeof(T));
  long frame = blockIdx.x;
  for (int e = threadIdx.x; e < m; e += kThreads) roots[e] = pack(tw_at<T>(tw, 2 * N1 * e, n));
  if (kStaged && threadIdx.x == 0) {
    vt::mbar_init(bar, 1);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (frame < B) {
      vt::mbar_expect_tx(bar, bytes);
      vt::bulk_copy(stage, x + frame * n, bytes, bar);
    }
  }
  __syncthreads();
  // k2 = k N1^-1 mod m of the split's first k (this thread's), and its step.
  const int k2_first = static_cast<int>(threadIdx.x * inv_n1 % m), k2_step = kThreads * inv_n1 % m;
  const T inv_N = T(1) / static_cast<T>(2 * n);
  const ModM mod(m);
  const bool small = !PfaPlan<T, Q>::kLarge || (m + 1) / 2 <= Tc<T>::kP;  // steps 1 and 5 in one packed tile
  uint32_t parity = 0;

#pragma unroll 1
  for (; frame < B; frame += gridDim.x) {
    // 1. Y[k2][j1], the m-point DFTs over the columns.
    const V* src = kStaged ? stage : reinterpret_cast<const V*>(x + frame * n);
    if (kStaged) {
      vt::mbar_wait(bar, parity);
      parity ^= 1;
    }
    if (small) {
      pfa_dft_in_small<T, Q, kStaged>(src, buf, roots, m, mod);
    } else if constexpr (PfaPlan<T, Q>::kLarge) {
      pfa_dft_in<T, Q, kStaged>(src, buf, roots, m, mod);
    }
    __syncthreads();
    if (kStaged && threadIdx.x == 0 && frame + gridDim.x < B) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the reads of the stage come first
      vt::mbar_expect_tx(bar, bytes);
      vt::bulk_copy(stage, x + (frame + gridDim.x) * n, bytes, bar);
    }
    // 2. Z[k2][k1]: the rows' N1-point FFTs.
    row_ffts<T, Q, false>(buf, tw, m, n);

    // 3. The split of each pair (k, n - k), in place.
    T* hr = half + frame * (nh + 1);
    int k2 = k2_first;
    for (int k = threadIdx.x; k <= nh; k += kThreads) {
      const int k1 = (k * inv_m) & (N1 - 1);
      const int ia = k2 * N1 + sw(k1), ib = (k2 == 0 ? 0 : m - k2) * N1 + sw((N1 - k1) & (N1 - 1));
      const V a = buf[ia], bz = buf[ib];
      const V w = __ldg(tw + k);
      T pk, pn;  // P[k], P[n-k]
      split_pair<T>(a, bz, w, pk, pn);
      if ((k & 1) == 0) {
        hr[k >> 1] = pk;
        if (2 * k != n) hr[(n - k) >> 1] = pn;
      }
      buf[ia] = packed_w<T>(pk, pn, w);                                    // W[k]
      if (k != 0 && 2 * k != n) buf[ib] = packed_w<T>(pn, pk, V{-w.x, w.y});  // W[n-k]
      k2 += k2_step;
      k2 -= k2 >= m ? m : 0;
    }
    __syncthreads();
    // 4. V[k2][j1]: the rows' inverse FFTs.
    row_ffts<T, Q, true>(buf, tw, m, n);

    // 5. The outputs j < n/2, from the rows folded in pairs.
    pfa_fold<T, Q>(buf, roots, m, mod);
    __syncthreads();
    if (small) {
      pfa_dft_out_small<T, Q>(buf, roots, reinterpret_cast<V*>(ac + frame * n), m, inv_N, mod);
    } else if constexpr (PfaPlan<T, Q>::kLarge) {
      pfa_dft_out<T, Q>(buf, roots, reinterpret_cast<V*>(ac + frame * n), m, inv_N, mod);
    }
    __syncthreads();  // the buffer is the next frame's
  }
}

// The Good-Thomas kernel at N1 = 2^Q: `blocks` blocks where kDev (one a
// scratch slice), else as many as the card holds at once, at most B.
template <typename T, int Q, bool kDev, bool kStaged>
int launch_pfa(const void* x, const void* tw, void* half, void* ac, void* scratch, int B, int m, int blocks,
               cudaStream_t stream) {
  constexpr int N1 = 1 << Q;
  int inv_m = 1, inv_n1 = 1;  // m^-1 mod N1 and N1^-1 mod m
  while ((inv_m * m) % N1 != 1) ++inv_m;
  while ((inv_n1 * N1) % m != 1) ++inv_n1;
  const int n = N1 * m;
  const auto kernel = ct_fused_pfa_kernel<T, Q, kDev, kStaged>;
  const size_t smem =
      static_cast<size_t>((kDev ? 0 : n) + (kStaged ? n / 2 : 0) + m) * sizeof(typename Vec2<T>::type) +
      (kStaged ? 8 : 0);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int grid = blocks;
  if (!kDev) {
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PfaPlan<T, Q>::kThreads, smem)) !=
            cudaSuccess) {
      return static_cast<int>(err);
    }
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    grid = sms * per_sm;
  }
  grid = grid < B ? grid : B;
  kernel<<<grid, PfaPlan<T, Q>::kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(tw),
                                              static_cast<T*>(half), static_cast<T*>(ac), static_cast<T*>(scratch),
                                              B, m, inv_m, inv_n1);
  return static_cast<int>(cudaSuccess);
}

template <typename T, bool kDev, bool kStaged>
int launch_pfa_q(const void* x, const void* tw, void* half, void* ac, void* scratch, int B, int q, int m,
                 int blocks, cudaStream_t s) {
  switch (q) {
    case 7: return launch_pfa<T, 7, kDev, kStaged>(x, tw, half, ac, scratch, B, m, blocks, s);
    case 8: return launch_pfa<T, 8, kDev, kStaged>(x, tw, half, ac, scratch, B, m, blocks, s);
    case 9: return launch_pfa<T, 9, kDev, kStaged>(x, tw, half, ac, scratch, B, m, blocks, s);
    case 10: return launch_pfa<T, 10, kDev, kStaged>(x, tw, half, ac, scratch, B, m, blocks, s);
    case 11: return launch_pfa<T, 11, kDev, kStaged>(x, tw, half, ac, scratch, B, m, blocks, s);
    default: return launch_pfa<T, 12, kDev, kStaged>(x, tw, half, ac, scratch, B, m, blocks, s);
  }
}

template <typename T, int L>
int launch_plan(const void* x, const void* tw, void* half, void* ac, int B, cudaStream_t stream) {
  using P = Plan<T, L>;
  const size_t smem = static_cast<size_t>(P::kFrames) * P::n * sizeof(typename Vec2<T>::type);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(ct_fused_kernel<T, L>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + P::kFrames - 1) / P::kFrames;
  ct_fused_kernel<T, L><<<blocks, P::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(tw), static_cast<T*>(half), static_cast<T*>(ac), B);
  return static_cast<int>(cudaSuccess);
}

// A frame over a cluster of Plan::kCluster blocks, launched with its cluster
// dimension. Whether such a cluster can be resident at all is asked once a
// shape (cudaOccupancyMaxActiveClusters); where none can, the launch is
// refused with cudaErrorLaunchOutOfResources, and the wrapper raises.
template <typename T, int L>
int launch_cluster(const void* x, const void* tw, void* half, void* ac, int B, cudaStream_t stream) {
  using P = Plan<T, L>;
  const auto kernel = ct_fused_cluster_kernel<T, L>;
  const size_t smem = static_cast<size_t>(P::m) * sizeof(typename Vec2<T>::type);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B) * P::kCluster);
  config.blockDim = dim3(P::kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  static int resident = 0;  // clusters the card holds at once, asked once
  if (resident == 0) {
    err = cudaOccupancyMaxActiveClusters(&resident, reinterpret_cast<const void*>(kernel), &config);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(x), static_cast<const T*>(tw),
                                             static_cast<T*>(half), static_cast<T*>(ac)));
}

template <typename T, int L>
int launch_shape(const void* x, const void* tw, void* half, void* ac, int B, cudaStream_t stream) {
  if constexpr (Plan<T, L>::kCluster == 1) {
    return launch_plan<T, L>(x, tw, half, ac, B, stream);
  } else {
    return launch_cluster<T, L>(x, tw, half, ac, B, stream);
  }
}

template <typename T>
int launch(const void* x, const void* tw, void* half, void* ac, void* scratch, int B, int n, int blocks,
           void* stream) {
  if (n < 128 || n > kMaxN || n % 128 != 0 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool pow2 = (n & (n - 1)) == 0;
  const int q = __builtin_ctz(static_cast<unsigned>(n)), m = n >> q;
  // Past the block's shared memory (float64 only): the buffer in scratch.
  const bool dev = !pow2 && static_cast<size_t>(n + m) * sizeof(typename Vec2<T>::type) > kSmemLimit;
  if (pow2 ? q > kMaxLog2 : (q < kPfaMinLog2 || q > kPfaMaxLog2 || (dev && (scratch == nullptr || blocks < 1)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    int err = 0;
    if (!pow2) {
      if constexpr (sizeof(T) == 8) {
        if (dev) err = launch_pfa_q<T, true, false>(x, tw, half, ac, scratch, B, q, m, blocks, s);
      }
      if (!dev) {
        err = pfa_staged<T>(n, m) ? launch_pfa_q<T, false, true>(x, tw, half, ac, scratch, B, q, m, blocks, s)
                                  : launch_pfa_q<T, false, false>(x, tw, half, ac, scratch, B, q, m, blocks, s);
      }
    } else {
      switch (q) {
        case 7: err = launch_shape<T, 7>(x, tw, half, ac, B, s); break;
        case 8: err = launch_shape<T, 8>(x, tw, half, ac, B, s); break;
        case 9: err = launch_shape<T, 9>(x, tw, half, ac, B, s); break;
        case 10: err = launch_shape<T, 10>(x, tw, half, ac, B, s); break;
        case 11: err = launch_shape<T, 11>(x, tw, half, ac, B, s); break;
        case 12: err = launch_shape<T, 12>(x, tw, half, ac, B, s); break;
        case 13: err = launch_shape<T, 13>(x, tw, half, ac, B, s); break;
        default: err = launch_shape<T, 14>(x, tw, half, ac, B, s); break;
      }
    }
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: null, or (blocks, n) complex values of the input dtype, the
// buffer of a float64 frame that is not a power of two and outgrows shared
// memory (ops/ct_fused.py allocates it where `ct_fused_layout` says "device").
VT_EXPORT int vt_ct_fused_f32(const void* x, const void* tw, void* half, void* ac, void* scratch, int B, int n,
                              int blocks, void* stream) {
  return launch<float>(x, tw, half, ac, scratch, B, n, blocks, stream);
}

VT_EXPORT int vt_ct_fused_f64(const void* x, const void* tw, void* half, void* ac, void* scratch, int B, int n,
                              int blocks, void* stream) {
  return launch<double>(x, tw, half, ac, scratch, B, n, blocks, stream);
}
