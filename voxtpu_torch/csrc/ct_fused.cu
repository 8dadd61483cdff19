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
// of two): 101-118 registers in float32 at 512 threads, 180-208 in float64
// at 256, 0 bytes of stack frame and spill in all 18 instantiations.
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
//   Z[k] = sum_{j1} w_N1^{j1 k1} sum_{j2} w_m^{j2 k2} z[j],
// so no twiddles lie between the two axes. The frame lives in a buffer of
// m rows of N1 points, row k2 (or j2) holding one N1-point transform:
// 1. the m-point DFTs from the input: Y[k2][j1] = sum_i z[j1 + N1 i]
//    w_m^{j2 k2}, j2 = (j1 + N1 i) mod m, over the n/2 nonzero points only
//    (i with j1 + N1 i < n/2). A thread sums kPfaOuts outputs k2 of one
//    column j1 at once, a warp's reads of z contiguous in j1. The roots
//    w_m^e, e < m, sit in shared memory, taken from the table of w = e^{-2 pi
//    i / N} (w_m = w^{2 N1}), so no sincos runs on the card;
// 2. the N1-point FFTs along each row, in the radix-16 Stockham passes of
//    the kernels above (N1 / 16 threads a row, 16 values a thread, the
//    block's rows a round at a time);
// 3. the split of each pair (k, n - k), k <= n/2, by one thread in place:
//    k1 = k m^-1 mod N1 and k2 = k N1^-1 mod m (the host passes both
//    inverses), the partner at (-k1, -k2); it writes P[k] and P[n - k] to
//    the half spectrum and W[k] and W[n - k] over Z;
// 4. the inverse N1-point FFTs along the rows;
// 5. the inverse m-point DFTs: output j < n/2 sums V[k2][j mod N1]
//    w_m^{-(j mod m) k2} over k2 (the even k2 and the odd in two sums),
//    stored as ac[2j], ac[2j+1] over N: a warp's stores contiguous.
// A direct m-point DFT costs m complex multiply-adds an output where an FFT
// costs log m: at m = 157 about 8 n m operations a frame against the power
// of two's 10 n log2 n. A simple kernel first: at 20,096 = 128 x 157 it
// takes 8.401 ms for 3,130 float32 frames, 45 times the function's bound
// (0.188 ms, its bytes) and 6.7 times the 1.26 ms that its own direct
// DFTs' operations need (its index arithmetic and the roots' shared-memory
// reads beside each multiply-add); at 2,176 = 128 x 17 2.675 ms for 28,932
// frames, 14 times the function's bound (chip_smoke.py phase 14; PERF.md
// has the times beside cuFFT's; NVIDIA H100 80GB HBM3, 700 W).
// The buffer is the block's shared memory (n + m complex values: 165 KB at
// 20,608 in float32), or, in float64 above 14,336 points, where n + m
// values outgrow the 227 KB a block may have, a slice of a scratch buffer
// in device memory that the wrapper allocates (kDev: one slice a block, the
// blocks walking the frames; the slices of all blocks stay in L2). Within a
// block __syncthreads orders the accesses to either.
// Threads a block: float32 512 (at most 128 registers a thread; one block
// an SM, its shared memory binds), float64 256 (up to 255 registers).
template <typename T>
constexpr int kPfaThreads = sizeof(T) == 4 ? 512 : 256;
constexpr int kPfaOuts = 8;        // m-point DFT outputs a thread sums at once
constexpr int kPfaMinLog2 = 7;     // N1 = 2^Q from 128 ...
constexpr int kPfaMaxLog2 = 12;    // ... to 4096 (n = 4096 x 5 = 20,480)
constexpr int kMaxN = 20608;       // voxtpu's largest frame: 128 x 161
constexpr int kSmemLimit = 232448; // bytes of shared memory a block may have (227 KB)

// The N1-point FFT (N1 = 2^Q) of every one of the m rows of buf, the
// block's threads taking kPfaThreads / (N1 / 16) rows a round.
template <typename T, int Q, bool kInv>
__device__ __forceinline__ void row_ffts(typename Vec2<T>::type* buf, const typename Vec2<T>::type* tw, int m,
                                         int n) {
  constexpr int N1 = 1 << Q, ft = N1 / kPoints, rows = kPfaThreads<T> / ft;
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

template <typename T, int Q, bool kDev>
__global__ void __launch_bounds__(kPfaThreads<T>, 1)
    ct_fused_pfa_kernel(const T* __restrict__ x, const T* __restrict__ tw_raw, T* __restrict__ half,
                        T* __restrict__ ac, T* __restrict__ scratch, int B, int m, int inv_m, int inv_n1) {
  using V = typename Vec2<T>::type;
  constexpr int N1 = 1 << Q, kThreads = kPfaThreads<T>;
  const int n = m << Q, nh = n / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* buf = kDev ? reinterpret_cast<V*>(scratch) + static_cast<long>(blockIdx.x) * n : reinterpret_cast<V*>(smem_raw);
  V* roots = reinterpret_cast<V*>(smem_raw) + (kDev ? 0 : n);  // w_m^e, e < m
  const V* tw = reinterpret_cast<const V*>(tw_raw);
  for (int e = threadIdx.x; e < m; e += kThreads) roots[e] = pack(tw_at<T>(tw, 2 * N1 * e, n));
  __syncthreads();
  const int chunks = (m + kPfaOuts - 1) / kPfaOuts;
  const int step = N1 % m;  // j2 gains this from row i to i + 1 of a column
  const T inv_N = T(1) / static_cast<T>(2 * n);

#pragma unroll 1
  for (long frame = blockIdx.x; frame < B; frame += gridDim.x) {
    // 1. Y[k2][j1] for k2 = k0 .. k0 + kPfaOuts - 1: e = j2 (k0 + c) mod m.
    const V* z = reinterpret_cast<const V*>(x + frame * n);
    for (int item = threadIdx.x; item < chunks * N1; item += kThreads) {
      const int j1 = item & (N1 - 1), k0 = (item >> Q) * kPfaOuts;
      const int dk = (step * k0) % m;
      int j2 = j1 % m, e0 = (j2 * k0) % m;
      Cx<T> acc[kPfaOuts];
#pragma unroll
      for (int c = 0; c < kPfaOuts; ++c) acc[c] = {T(0), T(0)};
#pragma unroll 1
      for (int j = j1; j < nh; j += N1) {
        const V a = __ldg(z + j);
        const Cx<T> zj = {a.x, a.y};
        int e = e0;
#pragma unroll
        for (int c = 0; c < kPfaOuts; ++c) {
          const V w = roots[e];
          acc[c] = cadd(acc[c], cmul(zj, Cx<T>{w.x, w.y}));
          e += j2;
          e -= e >= m ? m : 0;
        }
        j2 += step;
        j2 -= j2 >= m ? m : 0;
        e0 += dk;
        e0 -= e0 >= m ? m : 0;
      }
#pragma unroll
      for (int c = 0; c < kPfaOuts; ++c) {
        if (k0 + c < m) buf[(k0 + c) * N1 + sw(j1)] = pack(acc[c]);
      }
    }
    __syncthreads();
    // 2. Z[k2][k1]: the rows' N1-point FFTs.
    row_ffts<T, Q, false>(buf, tw, m, n);

    // 3. The split of each pair (k, n - k), in place.
    T* hr = half + frame * (nh + 1);
    for (int k = threadIdx.x; k <= nh; k += kThreads) {
      const int k1 = (k * inv_m) & (N1 - 1), k2 = (k * inv_n1) % m;
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
    }
    __syncthreads();
    // 4. V[k2][j1]: the rows' inverse FFTs.
    row_ffts<T, Q, true>(buf, tw, m, n);

    // 5. Outputs j < n/2: sum over k2 of V[k2][j1] w_m^{-j2 k2}, the even
    // and the odd k2 in two sums (m is odd: the last term is even's).
    V* ar = reinterpret_cast<V*>(ac + frame * n);
    for (int j = threadIdx.x; j < nh; j += kThreads) {
      const int j2 = j % m;
      const V* col = buf + sw(j & (N1 - 1));
      Cx<T> y0 = {T(0), T(0)}, y1 = {T(0), T(0)};
      int e = 0;
#pragma unroll 1
      for (int k2 = 0; k2 < m; k2 += 2) {
        const V a = col[k2 * N1], w = roots[e];
        y0 = cadd(y0, cmul(Cx<T>{a.x, a.y}, Cx<T>{w.x, -w.y}));
        e += j2;
        e -= e >= m ? m : 0;
        if (k2 + 1 < m) {
          const V b = col[(k2 + 1) * N1], u = roots[e];
          y1 = cadd(y1, cmul(Cx<T>{b.x, b.y}, Cx<T>{u.x, -u.y}));
          e += j2;
          e -= e >= m ? m : 0;
        }
      }
      const Cx<T> y = cadd(y0, y1);
      ar[j] = V{y.re * inv_N, y.im * inv_N};
    }
    __syncthreads();  // the buffer is the next frame's
  }
}

// The Good-Thomas kernel at N1 = 2^Q; kDev: the buffer in `scratch`, one
// slice of n complex values for each of `blocks` blocks.
template <typename T, int Q, bool kDev>
int launch_pfa(const void* x, const void* tw, void* half, void* ac, void* scratch, int B, int m, int blocks,
               cudaStream_t stream) {
  constexpr int N1 = 1 << Q;
  int inv_m = 1, inv_n1 = 1;  // m^-1 mod N1 and N1^-1 mod m
  while ((inv_m * m) % N1 != 1) ++inv_m;
  while ((inv_n1 * N1) % m != 1) ++inv_n1;
  const auto kernel = ct_fused_pfa_kernel<T, Q, kDev>;
  const size_t smem = static_cast<size_t>(kDev ? m : N1 * m + m) * sizeof(typename Vec2<T>::type);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = kDev && blocks < B ? blocks : B;
  kernel<<<grid, kPfaThreads<T>, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(tw),
                                                static_cast<T*>(half), static_cast<T*>(ac), static_cast<T*>(scratch),
                                                B, m, inv_m, inv_n1);
  return static_cast<int>(cudaSuccess);
}

template <typename T, bool kDev>
int launch_pfa_q(const void* x, const void* tw, void* half, void* ac, void* scratch, int B, int q, int m,
                 int blocks, cudaStream_t s) {
  switch (q) {
    case 7: return launch_pfa<T, 7, kDev>(x, tw, half, ac, scratch, B, m, blocks, s);
    case 8: return launch_pfa<T, 8, kDev>(x, tw, half, ac, scratch, B, m, blocks, s);
    case 9: return launch_pfa<T, 9, kDev>(x, tw, half, ac, scratch, B, m, blocks, s);
    case 10: return launch_pfa<T, 10, kDev>(x, tw, half, ac, scratch, B, m, blocks, s);
    case 11: return launch_pfa<T, 11, kDev>(x, tw, half, ac, scratch, B, m, blocks, s);
    default: return launch_pfa<T, 12, kDev>(x, tw, half, ac, scratch, B, m, blocks, s);
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
        err = dev ? launch_pfa_q<T, true>(x, tw, half, ac, scratch, B, q, m, blocks, s)
                  : launch_pfa_q<T, false>(x, tw, half, ac, scratch, B, q, m, blocks, s);
      } else {
        err = launch_pfa_q<T, false>(x, tw, half, ac, scratch, B, q, m, blocks, s);
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
