// Kernel B: Burg LPC of order P, one thread block a frame (a thread-block
// cluster for long frames), the frame held in registers and one block
// barrier an order.
//
// Replaces voxtpu/ops/burg_pallas.py::burg_pallas (pallas_call at
// burg_pallas.py:95). Semantics follow voxtpu.lpc.burg, the reference's
// lpc_praat_mut (spectrum.rs:101-146): the forward/backward buffers start as
// b1 = x[0..n-2], b2 = x[1..n-1]; order i sums num = b1.b2 and
// denum = |b1|^2 + |b2|^2 over k < n - i, sets the LPC_DENUM_NONPOS status
// bit when denum <= 0 (and divides by 1 instead; a NaN denum is not
// flagged), updates the coefficients, then b1[k] -= c b2[k] and
// b2[k] = b2[k+1] - c b1[k+1] with the old b1. The result is sign-flipped,
// as in the reference. The Pallas kernel's 8-row blocks and 128-lane output
// padding were for the TPU's tiles and are not carried over.
//
// Numbers: the sums and the reflection coefficient are in double, also for
// float frames; b1, b2 and the coefficients stay in the frame's dtype, as in
// the plain version (voxtpu_torch/ops/burg.py). Each thread sums its own
// pairs in ascending k with explicit fused multiply-adds: num = fma(u, v,
// num), den = fma(u, u, den), den = fma(v, v, den). A float's product is
// exact in double, so for float frames each step equals the plain version's
// multiply-then-add; for double frames the FMA rounds once where the plain
// version rounds twice (within the 1e-10 tolerance it is held to). Nothing
// else contracts: the library is built --fmad=false. The sums then run in a
// fixed order (a 5-step xor butterfly in each warp, which leaves the same
// bits in every lane, then the warps' partials in warp order), so outputs
// depend on the frame alone, never on the batch.
//
// What bounds it: each order converts the 2 live values of every pair to
// double and does 3 float64 FMAs, 2 float multiplies and 2 float
// subtractions on it: 1.02e9 pair-orders at the CLI default (35,689 frames
// of 2205, order 13). The conversions (cvt.f64.f32) run at 16 a clock an
// SM, a quarter of the float64 FMA rate (tools/burg_split.py measures
// both): 0.49 ms at that shape is the floor of any kernel that sums float
// values in double. Above it, each order's serial steps (the butterfly,
// the barrier, the warps' sum and the float64 division) leave the pipes
// idle unless other frames' blocks fill them, so few warps a frame and
// many frames an SM matter most; the kernel it replaced (one block of 256
// threads, b1 and b2 read twice an order from shared memory, 3 barriers and
// a thread-0 section an order) took 1.59 ms there.
//
// Design. Thread t holds pairs k in [t c, t c + c) of (b1, b2) in registers:
// c = 35 for float frames and 23 for double ones (64 and 96 threads at the
// CLI default), odd so that reading the pairs out of shared memory hits 32
// banks; the wrapper picks threads and c as a pure function of (n, dtype)
// and mirrors the constants below. The frame is read from device memory
// once, every load in flight at once, coalesced through shared memory.
// Order i:
//   1. each thread's partial (num, den) over its live pairs (taken in the
//      previous order's update pass, step 5);
//   2. the xor butterfly; lane 0 of each warp writes the warp's (num, den)
//      and its own first pair, before the update, into one of two slots
//      chosen by the parity of i (so no warp can overwrite a slot another
//      warp still reads);
//   3. one __syncthreads();
//   4. every thread sums the warps' partials in warp order and computes
//      bad and c_i itself (no thread-0 section); warp 0 updates the
//      coefficients, lane j holding a[j + 32 k] for k < 4 (orders up to
//      127, the reference's own TPU limit) and reading each mirrored
//      a[i - 2 - j - 32 k] by shuffle: the four registers shuffled from one
//      source lane, (i - 2 - j) mod 32, then the right one selected;
//   5. each thread updates its pairs in registers from the old values, the
//      last one from its neighbour's first pair (lane + 1 by shuffle, lane
//      31 from the next warp's slot), and in the same pass takes the next
//      order's partial sums on the new values. A warp whose pairs are all
//      live runs this pass without masks; only the warp at the frame's end
//      masks.
// A block takes up to kMaxThreads threads at 128 registers a thread, so the
// register layout holds up to 35 x 512 pairs in float (23 x 512 in double).
// Longer frames keep the rows in shared memory, thread t's pairs at
// [t c, t c + c) with the odd width kSharedWidth, and run the same steps:
// one fused pass and one barrier an order. Its shared memory is 2 (n - 1)
// values and the slots: up to 28,967 float and 14,497 double samples.
//
// Frames longer than that hold the rows over a thread-block cluster of C
// blocks (the cluster layout, burg_cluster_kernel): thread g of the cluster
// (block r's thread t is g = r T + t) takes pairs [g c, g c + c) at the
// shared layout's width, so block r holds the contiguous share [r T c, r T c
// + T c) in its shared memory, read from the frame once (the one sample past
// its share too). A pair is one word, (b1, b2) as a float2 or double2: one
// shared load or store a pair, 64 or 128 bits, free of bank conflicts at
// the odd width. Each order runs the same steps, but for the exchange
// between warps: each warp's (num, den) and first pair go, as one record,
// into every block of the cluster (lane j writes block j's copy with
// st.async), and an mbarrier in each block counts the record bytes in (one
// local arrival that expects them; its phase completes when all C W records
// are there). Every warp then adds the C W partials from its own block's
// copy in one fixed order, block rank then warp (lane l takes records l, l
// + 32, ... in turn, then a 5-step xor butterfly), so every block computes
// the same c_i, and block 0's warp 0 keeps the coefficients (it updates
// them while the next records arrive); the last thread of block r takes
// block r + 1's first pair from its record. Two record sets, by the
// parity of the order, let the exchange run without a cluster barrier: a
// block writes into a set again two orders on, once every warp of the
// cluster has sent its records of the order between, which it does only
// after reading the set. A cluster barrier after the mbarriers are set and
// one before exit bracket the exchange. The fused pass takes the pairs
// through registers K at a time (9 float pairs, 7 double), loading the
// next K before it stores the current ones, so that a load never waits on
// the stores before it.
//
// Why a cluster: one block's 227 KB holds at most 28,967 float and 14,497
// double samples, and past that the rows went to device memory, where each
// order read and wrote them once (512 KB a frame of 32,768 floats; at 56
// registers, 63 in double, two blocks an SM kept about 67 MB of rows in
// flight, more than the 50 MB L2, so every pass waited on memory: 5.8 ms for
// 1,918 frames of 32,768 floats against 0.19 ms of operations, chip_smoke.py
// phase 16, NVIDIA H100 80GB HBM3, 700 W). Over a cluster the rows stay on
// chip and the frame is read once. C is the fewest of 2, 4 and 8 blocks
// whose shares, at the fewest whole warps of at most kMaxThreads threads,
// fit a block's shared memory with the records (32,768 floats: 2 blocks of
// 288 threads; 65,536 floats and 32,768 doubles: 4; ops/burg.py
// launch_config mirrors the rule). At 2,048 noisy frames of 32,768 floats
// that took 1.59 ms against 1.69 at 4 blocks of 160 and 1.88 at 8 of 96,
// and at 65,536 floats 3.43 (4 blocks) against 3.80 (8)
// (tools/burg_split.py --clusters, NVIDIA H100 80GB HBM3, 700 W): every
// C keeps about 66 frames on the card, the shared memory's limit, and more
// blocks only wait on more peers. C = 16 would need the non-portable cluster
// size and a query of the card, which a pure function of (n, dtype) cannot
// make, so the cluster stops at 8 blocks of 448 threads (225,793 float
// samples) or of 224 (112,897 double ones).
//
// What bounds it: a frame's orders run in sequence, and each order's
// exchange, sums and division leave its SMs idle but for the other frames'
// work, which the shared memory limits to about one block an SM at these
// lengths; the conversions (2 a summed pair, 16 a clock an SM) set the
// floor of the passes. The record exchange replaced a first design with one
// cluster barrier an order (barrier.cluster.arrive.release, whose fence
// stalls every warp, then each warp reading the C W partials through
// distributed shared memory), whose results it gives bit for bit.
//
// Frames longer than that keep the rows in device memory (the device
// layout): kMaxThreads threads, thread t's pairs [t c, t c + c) for the c
// that holds them (a runtime width), in a scratch buffer the wrapper
// allocates, 2 x threads x c values a frame. Pair t c + j lies at [j][b1 or
// b2][t], so a warp's loads and stores of one j are 32 neighbouring values,
// and a thread only ever touches its own pairs (it reads them straight from
// the frame at the start): the steps, the one fused pass and the one
// barrier an order are the others'. Each order reads and writes the rows
// once, so the passes wait on memory; the layout takes every n past the
// cluster's.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxOrder = 127;
constexpr int kCoefRegs = 4;  // warp 0's coefficients a lane: 32 kCoefRegs > kMaxOrder
constexpr int kStatusLpcDenumNonpos = 1;  // voxtpu_torch.errors.LPC_DENUM_NONPOS
// Register layout: each dtype's width c (chosen by tools/burg_split.py on
// an H100). Shared-memory layout: its width.
constexpr int kWidthF32 = 35;
constexpr int kWidthF64 = 23;
constexpr int kSharedWidth = 63;
// Where the rows live: burg_kernel's kRows and the launcher's `rows`.
constexpr int kRowsRegisters = 0;
constexpr int kRowsShared = 1;
constexpr int kRowsDevice = 2;
constexpr int kRowsCluster = 3;
// The most blocks a cluster of the cluster layout takes (the portable
// cluster size).
constexpr int kMaxCluster = 8;
// The most threads a block of either layout takes. Every instantiation is
// held to 128 registers a thread (65,536 / 512), so that 8 blocks of 64
// threads (5 of 96) fit on an SM at the path shapes: the compiler otherwise
// spends more on keeping conversions in flight, and fewer frames run at
// once.
constexpr int kMaxThreads = 512;
// Dynamic shared memory a block may take on the card (227 KB).
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// Bytes of dynamic shared memory: the rows (the staged frame, n values, in
// the register layout; b1 and b2, n - 1 values each, in the shared one;
// the block's share of b1 and b2, threads x kSharedWidth values each, in
// the cluster one; none in the device one), rounded to 16 bytes, then the
// slots: (num, den) in double and the first pair (b1, b2) of each warp, for
// two parities; in the cluster layout two mbarriers and two sets of the
// cluster's records, (num, den) and the first pair of each of its warps.
template <typename T>
__host__ __device__ size_t smem_bytes(int N, int threads, int where, int blocks) {
  const size_t rows = where == kRowsShared ? 2 * static_cast<size_t>(N - 1)
                      : where == kRowsCluster ? 2 * static_cast<size_t>(threads) * kSharedWidth
                      : where == kRowsRegisters ? static_cast<size_t>(N) : 0;
  const size_t W = static_cast<size_t>(threads) / 32;
  if (where == kRowsCluster) return round16(rows * sizeof(T)) + 16 + 4 * blocks * W * (sizeof(double) + sizeof(T));
  return round16(rows * sizeof(T)) + 4 * W * sizeof(double) + 4 * W * sizeof(T);
}

// Thread t's pairs in registers; pairs past the frame hold 0 and are never
// summed.
template <typename T, int C>
struct RegisterRows {
  T b1[C], b2[C];
  __device__ __forceinline__ bool has(int) const { return true; }
  __device__ __forceinline__ T get1(int j) const { return b1[j]; }
  __device__ __forceinline__ T get2(int j) const { return b2[j]; }
  __device__ __forceinline__ void set(int j, T u, T v) {
    b1[j] = u;
    b2[j] = v;
  }
};

// Thread t's pairs in shared memory; `count` of them lie inside the frame.
template <typename T>
struct SharedRows {
  T* b1;
  T* b2;
  int count;
  __device__ __forceinline__ bool has(int j) const { return j < count; }
  __device__ __forceinline__ T get1(int j) const { return b1[j]; }
  __device__ __forceinline__ T get2(int j) const { return b2[j]; }
  __device__ __forceinline__ void set(int j, T u, T v) {
    b1[j] = u;
    b2[j] = v;
  }
};

// Thread t's pairs in device memory, one column of the frame's scratch:
// pair j's b1 at col[2 j kMaxThreads] and its b2 kMaxThreads further on;
// `count` of them lie inside the frame.
template <typename T>
struct DeviceRows {
  T* col;
  int count;
  __device__ __forceinline__ bool has(int j) const { return j < count; }
  __device__ __forceinline__ T get1(int j) const { return col[static_cast<size_t>(j) * 2 * kMaxThreads]; }
  __device__ __forceinline__ T get2(int j) const {
    return col[static_cast<size_t>(j) * 2 * kMaxThreads + kMaxThreads];
  }
  __device__ __forceinline__ void set(int j, T u, T v) {
    col[static_cast<size_t>(j) * 2 * kMaxThreads] = u;
    col[static_cast<size_t>(j) * 2 * kMaxThreads + kMaxThreads] = v;
  }
};

// Adds a pair to a thread's partial sums in double: num = fma(u, v, num),
// den = fma(u, u, den), den = fma(v, v, den). In the masked form a pair
// that is not live adds exact zeros instead (u = 0, v = -0: num + (0 x -0)
// is num, and den, a sum of squares from +0, is never -0), so the sums need
// no branch.
template <bool kMasked, typename T>
__device__ __forceinline__ void accumulate(T a, T b, bool live, double& num, double& den) {
  const double u = static_cast<double>(!kMasked || live ? a : T(0));
  const double v = static_cast<double>(!kMasked || live ? b : -T(0));
  num = fma(u, v, num);
  den = fma(u, u, den);
  den = fma(v, v, den);
}

// Order 1's partial sums over the first `live` of this thread's pairs. The
// unmasked form is for warps whose pairs are all live. C: the width, or 0
// for the runtime width c (the device layout).
template <bool kMasked, int C, int kUnroll, typename Rows>
__device__ __forceinline__ void first_sums(const Rows& rows, int live, double& num, double& den, int c) {
  num = 0.0;
  den = 0.0;
#pragma unroll(kUnroll)
  for (int j = 0; j < (C > 0 ? C : c); ++j) {
    if (!kMasked || rows.has(j)) accumulate<kMasked>(rows.get1(j), rows.get2(j), j < live, num, den);
  }
}

// One order's update of this thread's pairs from the old values, (u, v)
// the first pair and (n1, n2) the neighbour's, in the frame's dtype; in the
// same pass the next order's partial sums over the first `live` of them.
template <bool kMasked, int C, int kUnroll, typename T, typename Rows>
__device__ __forceinline__ void update(Rows& rows, T ci, T u, T v, T n1, T n2, int live, double& num,
                                       double& den, int c) {
  num = 0.0;
  den = 0.0;
#pragma unroll(kUnroll)
  for (int j = 0; j < (C > 0 ? C : c); ++j) {
    T nu = n1;
    T nv = n2;
    if (j + 1 < (C > 0 ? C : c)) {
      const bool in = !kMasked || rows.has(j + 1);
      nu = in ? rows.get1(j + 1) : T(0);
      nv = in ? rows.get2(j + 1) : T(0);
    }
    const T new1 = u - ci * v;
    const T new2 = nv - ci * nu;
    if (!kMasked || rows.has(j)) rows.set(j, new1, new2);
    accumulate<kMasked>(new1, new2, j < live, num, den);
    u = nu;
    v = nv;
  }
}

// Warp 0's coefficients after order i, lane j holding a[j + 32 k] in a[k]:
// a[q] = a[q] - ci a[i - 2 - q] for q < i - 1; a[i - 1] = ci. The mirrors
// r = i - 2 - lane - 32 k of one lane's coefficients all sit on source lane
// (i - 2 - lane) mod 32, in register r / 32.
template <typename T>
__device__ __forceinline__ void update_coefs(T (&a)[kCoefRegs], T ci, int i, int lane) {
  const int src = (i - 2 - lane) & 31;
  T m[kCoefRegs];
#pragma unroll
  for (int k = 0; k < kCoefRegs; ++k) m[k] = __shfl_sync(0xffffffffu, a[k], src);
#pragma unroll
  for (int k = 0; k < kCoefRegs; ++k) {
    const int q = lane + 32 * k;
    const int r = i - 2 - q;
    T mir = m[0];
#pragma unroll
    for (int s = 1; s < kCoefRegs; ++s) mir = r >= 32 * s ? m[s] : mir;
    a[k] = q < i - 1 ? a[k] - ci * mir : (q == i - 1 ? ci : a[k]);
  }
}

// kRows: kRowsRegisters, kRowsShared or kRowsDevice. C: the width, 0 for the
// device layout, whose width is `width` (the rows then in `scratch`, 2 x
// kMaxThreads x width values a frame, launched with kMaxThreads threads).
template <typename T, int C, int kRows>
__global__ void __launch_bounds__(kMaxThreads, 1)
    burg_kernel(const T* __restrict__ x, T* __restrict__ coef_out, int* __restrict__ status_out,
                T* __restrict__ scratch, int N, int P, int width) {
  constexpr bool kShared = kRows == kRowsShared;
  constexpr bool kDevice = kRows == kRowsDevice;
  // Register rows need every index fixed at compile time; the others do not.
  constexpr int kUnroll = kRows == kRowsRegisters ? C : 4;
  const int c = C > 0 ? C : width;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int npairs = N - 1;
  const int k0 = threadIdx.x * c;
  // A warp's pairs end at warp_end: its threads' pairs are all live while
  // the live count is at least that.
  const int warp_end = (warp + 1) * 32 * c;
  const T* xr = x + static_cast<long>(blockIdx.x) * N;
  double2* part = reinterpret_cast<double2*>(
      smem_raw + round16((kShared ? 2 * npairs : kDevice ? 0 : N) * sizeof(T)));
  T* first = reinterpret_cast<T*>(part + 2 * W);  // [parity][b1, b2][warp]

  using Rows = typename std::conditional<
      kShared, SharedRows<T>, typename std::conditional<kDevice, DeviceRows<T>, RegisterRows<T, C>>::type>::type;
  Rows rows;
  if constexpr (kDevice) {
    // This thread's column of the frame's rows: its pairs straight from the
    // frame, which no other thread reads or writes, so no barrier follows.
    rows.col = scratch + static_cast<size_t>(2 * kMaxThreads) * c * blockIdx.x + threadIdx.x;
    rows.count = max(0, min(c, npairs - k0));
    for (int j = 0; j < rows.count; ++j) rows.set(j, __ldg(xr + k0 + j), __ldg(xr + k0 + j + 1));
  } else if constexpr (kShared) {
    T* s1 = reinterpret_cast<T*>(smem_raw);
    T* s2 = s1 + npairs;
#pragma unroll 8
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
      const T value = xr[k];
      if (k < npairs) s1[k] = value;
      if (k > 0) s2[k - 1] = value;
    }
    rows.b1 = s1 + k0;
    rows.b2 = s2 + k0;
    rows.count = max(0, min(C, npairs - k0));
    __syncthreads();
  } else {
    // Every load of the frame in flight at once (n <= threads x c + 1), then
    // into shared memory and back out as this thread's pairs.
    T* staged = reinterpret_cast<T*>(smem_raw);
    T fetched[C + 1];
#pragma unroll
    for (int j = 0; j <= C; ++j) {
      const int k = threadIdx.x + j * blockDim.x;
      fetched[j] = k < N ? xr[k] : T(0);
    }
#pragma unroll
    for (int j = 0; j <= C; ++j) {
      const int k = threadIdx.x + j * blockDim.x;
      if (k < N) staged[k] = fetched[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const bool in = k0 + j < npairs;
      rows.set(j, in ? staged[k0 + j] : T(0), in ? staged[k0 + j + 1] : T(0));
    }
  }

  double num;
  double den;
  if (warp_end <= npairs) {
    first_sums<false, C, kUnroll>(rows, c, num, den, c);
  } else {
    first_sums<true, C, kUnroll>(rows, npairs - k0, num, den, c);
  }

  T a[kCoefRegs] = {};  // warp 0: coefficient `lane + 32 k` in a[k]
  bool bad = false;
  for (int i = 1; i <= P; ++i) {
    for (int off = 16; off > 0; off >>= 1) {
      num += __shfl_xor_sync(0xffffffffu, num, off);
      den += __shfl_xor_sync(0xffffffffu, den, off);
    }
    const int par = i & 1;
    double2* sums = part + par * W;
    T* f1 = first + (2 * par) * W;
    T* f2 = f1 + W;
    const T own1 = rows.has(0) ? rows.get1(0) : T(0);
    const T own2 = rows.has(0) ? rows.get2(0) : T(0);
    if (lane == 0) {
      sums[warp] = make_double2(num, den);
      f1[warp] = own1;
      f2[warp] = own2;
    }
    __syncthreads();

    double2 total = sums[0];
    for (int w = 1; w < W; ++w) {
      const double2 s = sums[w];
      total.x += s.x;
      total.y += s.y;
    }
    const bool bad_i = total.y <= 0.0;
    bad = bad || bad_i;
    const T ci = static_cast<T>(2.0 * total.x / (bad_i ? 1.0 : total.y));

    if (warp == 0) update_coefs(a, ci, i, lane);
    if (i == P) break;

    // The neighbour's first pair, before the update.
    T n1 = __shfl_down_sync(0xffffffffu, own1, 1);
    T n2 = __shfl_down_sync(0xffffffffu, own2, 1);
    if (lane == 31) {
      n1 = warp + 1 < W ? f1[warp + 1] : T(0);
      n2 = warp + 1 < W ? f2[warp + 1] : T(0);
    }
    const int m = N - i - 1;  // the next order's live pairs
    if (warp_end <= m) {
      update<false, C, kUnroll>(rows, ci, own1, own2, n1, n2, c, num, den, c);
    } else {
      update<true, C, kUnroll>(rows, ci, own1, own2, n1, n2, m - k0, num, den, c);
    }
  }

  if (warp == 0) {
    T* out = coef_out + static_cast<long>(blockIdx.x) * P;
#pragma unroll
    for (int k = 0; k < kCoefRegs; ++k) {
      if (lane + 32 * k < P) out[lane + 32 * k] = -a[k];
    }
    if (lane == 0) status_out[blockIdx.x] = bad ? kStatusLpcDenumNonpos : 0;
  }
}

// A pair (b1[k], b2[k]) of the cluster layout, in one 8- or 16-byte word.
template <typename T>
using Pair = typename std::conditional<sizeof(T) == 4, float2, double2>::type;

// Pair j of this thread's c at p, or zeros past the `count` in the frame
// (the masked form).
template <bool kMasked, typename T>
__device__ __forceinline__ Pair<T> pair_at(const Pair<T>* p, int j, int count) {
  return !kMasked || j < count ? p[j] : Pair<T>{T(0), T(0)};
}

// The cluster layout's fused pass over this thread's kSharedWidth pairs at p
// (`count` of them in the frame): each pair's update from the old values,
// nb the next thread's first pair, and the next order's partial sums over
// the first `live` new pairs; `own` becomes the new first pair. The pairs
// go through registers K at a time, the next K loaded before the current K
// are stored, so no load waits on the stores before it.
template <bool kMasked, int K, typename T>
__device__ __forceinline__ void cluster_pass(Pair<T>* p, int count, T ci, Pair<T> nb, int live, Pair<T>& own,
                                             double& num, double& den) {
  constexpr int c = kSharedWidth;
  static_assert(c % K == 0, "whole chunks of pairs");
  num = 0.0;
  den = 0.0;
  Pair<T> cur[K];
  cur[0] = own;
#pragma unroll
  for (int j = 1; j < K; ++j) cur[j] = pair_at<kMasked, T>(p, j, count);
#pragma unroll 1
  for (int q = 0; q < c; q += K) {
    const bool more = q + K < c;
    Pair<T> nxt[K];
#pragma unroll
    for (int j = 0; j < K; ++j) nxt[j] = more ? pair_at<kMasked, T>(p, q + K + j, count) : Pair<T>{T(0), T(0)};
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const Pair<T> after = j + 1 < K ? cur[j + 1] : (more ? nxt[0] : nb);
      const T new1 = cur[j].x - ci * cur[j].y;
      const T new2 = after.y - ci * after.x;
      if (!kMasked || q + j < count) p[q + j] = Pair<T>{new1, new2};
      if (q + j == 0) own = count > 0 ? Pair<T>{new1, new2} : Pair<T>{T(0), T(0)};
      accumulate<kMasked>(new1, new2, q + j < live, num, den);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) cur[j] = nxt[j];
  }
}

// Shared-memory addresses of the cluster layout's records, and the PTX of
// their exchange: st.async writes a value into a block of the cluster and
// counts its bytes on that block's mbarrier, whose phase completes once its
// one local arrival (with the bytes it expects) and all those bytes are in.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t in_block(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void push(uint32_t addr, double a, double b, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 [%0], {%1, %2}, [%3];"
               :: "r"(addr), "l"(__double_as_longlong(a)), "l"(__double_as_longlong(b)), "r"(bar) : "memory");
}

__device__ __forceinline__ void push(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
               :: "r"(addr), "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(bar) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// The cluster layout: one cluster of `blocks` blocks a frame, launched with
// that cluster dimension; block r's thread t is the cluster's thread g = r
// T + t, holding pairs [g c, g c + c) at c = kSharedWidth as (b1, b2) words
// in its block's shared memory. The steps are burg_kernel's, but for the
// exchange: each warp's (num, den) and first pair go, as one record, into
// every block of the cluster (st.async), where an mbarrier counts them in,
// two record sets by parity; every warp then adds the cluster's records
// itself, from its own block's shared memory.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    burg_cluster_kernel(const T* __restrict__ x, T* __restrict__ coef_out, int* __restrict__ status_out, int N,
                        int P) {
  constexpr int c = kSharedWidth;
  // Pairs a chunk of the fused pass: 9 float pairs (18 registers, twice) or
  // 7 double ones (28); samples a thread loads at once at the start.
  constexpr int K = sizeof(T) == 4 ? 9 : 7;
  constexpr int kLoads = 16;
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const unsigned frame = blockIdx.x / static_cast<unsigned>(blocks);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int threads = blockDim.x;
  const int W = threads >> 5;
  const int CW = blocks * W;  // records an order: one a warp of the cluster
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int npairs = N - 1;
  // This thread's first pair, and where its warp's pairs end: its threads'
  // pairs are all live while the live count is at least that.
  const int k0 = (rank * threads + static_cast<int>(threadIdx.x)) * c;
  const int warp_end = (rank * W + warp + 1) * 32 * c;
  Pair<T>* share = reinterpret_cast<Pair<T>*>(smem_raw);  // this block's pairs
  // Two mbarriers, then the records: [parity][block rank x W + warp], the
  // sums and the first pairs apart.
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + round16(2 * static_cast<size_t>(threads) * c * sizeof(T)));
  double2* rec_sums = reinterpret_cast<double2*>(bars + 2);
  Pair<T>* rec_pairs = reinterpret_cast<Pair<T>*>(rec_sums + 2 * CW);
  const uint32_t record_bytes = static_cast<uint32_t>(CW * (sizeof(double2) + sizeof(Pair<T>)));
  if (threadIdx.x == 0) {
    for (int q = 0; q < 2; ++q) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(bars + q)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // This block's share of the pairs, [base, base + len), from samples base
  // .. base + len of the frame, kLoads a thread in flight at once.
  const int base = rank * threads * c;
  const int len = max(0, min(threads * c, npairs - base));
  const T* xr = x + static_cast<long>(frame) * N + base;
  for (int k1 = static_cast<int>(threadIdx.x); len > 0 && k1 <= len; k1 += kLoads * threads) {
    T v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) v[u] = k1 + u * threads <= len ? xr[k1 + u * threads] : T(0);
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k1 + u * threads;
      if (k < len) share[k].x = v[u];
      if (k > 0 && k <= len) share[k - 1].y = v[u];
    }
  }
  Pair<T>* mine = share + threadIdx.x * c;
  const int count = max(0, min(c, npairs - k0));
  // Every block's mbarriers are set before any block sends to them.
  cluster.sync();

  double num = 0.0;
  double den = 0.0;
  if (warp_end <= npairs) {
#pragma unroll 9
    for (int j = 0; j < c; ++j) accumulate<false>(mine[j].x, mine[j].y, true, num, den);
  } else {
#pragma unroll 9
    for (int j = 0; j < c; ++j) {
      const Pair<T> v = pair_at<true, T>(mine, j, count);
      accumulate<true>(v.x, v.y, j < count, num, den);
    }
  }
  Pair<T> own = count > 0 ? mine[0] : Pair<T>{T(0), T(0)};

  T a[kCoefRegs] = {};  // block 0's warp 0: coefficient `lane + 32 k` in a[k]
  bool bad = false;
  T ci = T(0);
  for (int i = 1; i <= P; ++i) {
    for (int off = 16; off > 0; off >>= 1) {
      num += __shfl_xor_sync(0xffffffffu, num, off);
      den += __shfl_xor_sync(0xffffffffu, den, off);
    }
    // Order i's records go to set i & 1. A block sends into a set again two
    // orders on, once every warp of the cluster has sent its records of the
    // order between, which it does only after reading this set.
    const int par = i & 1;
    const uint32_t bar = smem_addr(bars + par);
    const int slot = par * CW + rank * W + warp;
    // The warp's first pair is lane 0's; lane j sends the record to block j.
    const T first1 = __shfl_sync(0xffffffffu, own.x, 0);
    const T first2 = __shfl_sync(0xffffffffu, own.y, 0);
    if (lane < blocks) {
      const uint32_t to_bar = in_block(bar, lane);
      push(in_block(smem_addr(rec_sums + slot), lane), num, den, to_bar);
      push(in_block(smem_addr(rec_pairs + slot), lane), first1, first2, to_bar);
    }
    if (threadIdx.x == 0) expect_bytes(bar, record_bytes);
    // While the records arrive: block 0's warp 0 takes the last order's
    // coefficients.
    if (warp == 0 && rank == 0 && i > 1) update_coefs(a, ci, i - 1, lane);
    wait_phase(bar, ((i - 1) >> 1) & 1);

    // The next thread's first pair, before the update: lane + 1 by shuffle,
    // lane 31 from the next warp's record (the next block's first, past this
    // block's last warp).
    Pair<T> nb;
    nb.x = __shfl_down_sync(0xffffffffu, own.x, 1);
    nb.y = __shfl_down_sync(0xffffffffu, own.y, 1);
    if (lane == 31) nb = rank * W + warp + 1 < CW ? rec_pairs[slot + 1] : Pair<T>{T(0), T(0)};
    // The cluster's warp partials in record order (block rank, then warp):
    // lane l adds records l, l + 32, ... in that order, then a 5-step xor
    // butterfly, which leaves the same bits in every lane.
    double2 total = make_double2(0.0, 0.0);
    for (int idx = lane; idx < CW; idx += 32) {
      const double2 s = rec_sums[par * CW + idx];
      total.x += s.x;
      total.y += s.y;
    }
    for (int off = 16; off > 0; off >>= 1) {
      total.x += __shfl_xor_sync(0xffffffffu, total.x, off);
      total.y += __shfl_xor_sync(0xffffffffu, total.y, off);
    }
    const bool bad_i = total.y <= 0.0;
    bad = bad || bad_i;
    ci = static_cast<T>(2.0 * total.x / (bad_i ? 1.0 : total.y));
    if (i == P) break;

    const int m = N - i - 1;  // the next order's live pairs
    if (warp_end <= m) {
      cluster_pass<false, K, T>(mine, count, ci, nb, c, own, num, den);
    } else {
      cluster_pass<true, K, T>(mine, count, ci, nb, m - k0, own, num, den);
    }
  }

  if (warp == 0 && rank == 0) {
    update_coefs(a, ci, P, lane);
    T* out = coef_out + static_cast<long>(frame) * P;
#pragma unroll
    for (int k = 0; k < kCoefRegs; ++k) {
      if (lane + 32 * k < P) out[lane + 32 * k] = -a[k];
    }
    if (lane == 0) status_out[frame] = bad ? kStatusLpcDenumNonpos : 0;
  }
  cluster.sync();  // no block leaves while a peer may still send to it
}

template <typename T, int C, int kRows>
int launch_with(const void* x, void* coef, void* status, void* scratch, int B, int N, int P, int threads, int width,
                cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(N, threads, kRows, 1);
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const auto kernel = burg_kernel<T, C, kRows>;
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<B, threads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(coef), static_cast<int*>(status),
                                         static_cast<T*>(scratch), N, P, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// The cluster layout over B frames, a cluster of `blocks` blocks a frame,
// launched with its cluster dimension. Whether such a cluster can be
// resident at all is asked once a (blocks, threads); where none can, the
// launch is refused with cudaErrorLaunchOutOfResources, and the wrapper
// raises.
template <typename T>
int launch_cluster(const void* x, void* coef, void* status, int B, int N, int P, int threads, int blocks,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(N, threads, kRowsCluster, blocks);
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const auto kernel = burg_cluster_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B) * blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  // Clusters the card holds at once, by (log2 blocks, warps), asked once.
  static int resident[4][kMaxThreads / 32 + 1] = {};
  int& held = resident[__builtin_ctz(blocks)][threads / 32];
  if (held == 0) {
    err = cudaOccupancyMaxActiveClusters(&held, reinterpret_cast<const void*>(kernel), &config);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (held < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(x), static_cast<T*>(coef),
                                             static_cast<int*>(status), N, P));
}

// threads: a multiple of 32, at most kMaxThreads, with blocks x threads x
// width >= n - 1; rows: kRowsRegisters (width: the dtype's register
// width), kRowsShared (kSharedWidth) or kRowsDevice (kMaxThreads threads,
// any width; scratch: B x 2 x threads x width values, else unused), each
// at blocks = 1, or kRowsCluster (kSharedWidth, blocks 2, 4 or 8).
template <typename T>
int launch(const void* x, void* coef, void* status, void* scratch, int B, int N, int P, int threads, int width,
           int rows, int blocks, void* stream) {
  if (P < 1 || P > kMaxOrder || N < 2 || threads < 32 || threads % 32 != 0 || threads > kMaxThreads ||
      width < 1 || blocks < 1 || blocks > kMaxCluster || (blocks & (blocks - 1)) != 0 ||
      static_cast<long>(threads) * width * blocks < N - 1 || (blocks > 1) != (rows == kRowsCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == kRowsCluster && width == kSharedWidth)
    return launch_cluster<T>(x, coef, status, B, N, P, threads, blocks, st);
  constexpr int kWidth = sizeof(T) == 4 ? kWidthF32 : kWidthF64;
  if (rows == kRowsShared && width == kSharedWidth)
    return launch_with<T, kSharedWidth, kRowsShared>(x, coef, status, scratch, B, N, P, threads, width, st);
  if (rows == kRowsRegisters && width == kWidth)
    return launch_with<T, kWidth, kRowsRegisters>(x, coef, status, scratch, B, N, P, threads, width, st);
  if (rows == kRowsDevice && threads == kMaxThreads && (scratch != nullptr || B == 0))
    return launch_with<T, 0, kRowsDevice>(x, coef, status, scratch, B, N, P, threads, width, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

VT_EXPORT int vt_burg_f32(const void* x, void* coef, void* status, void* scratch, int B, int N, int P, int threads,
                          int width, int rows, int blocks, void* stream) {
  return launch<float>(x, coef, status, scratch, B, N, P, threads, width, rows, blocks, stream);
}

VT_EXPORT int vt_burg_f64(const void* x, void* coef, void* status, void* scratch, int B, int N, int P, int threads,
                          int width, int rows, int blocks, void* stream) {
  return launch<double>(x, coef, status, scratch, B, N, P, threads, width, rows, blocks, stream);
}
