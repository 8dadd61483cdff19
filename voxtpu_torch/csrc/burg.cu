// Kernel B: Burg LPC of order P, one thread block a frame, the frame held in
// registers and one block barrier an order.
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
// Frames longer than that keep the rows in device memory (the device
// layout): kMaxThreads threads, thread t's pairs [t c, t c + c) for the c
// that holds them (a runtime width), in a scratch buffer the wrapper
// allocates, 2 x threads x c values a frame. Pair t c + j lies at [j][b1 or
// b2][t], so a warp's loads and stores of one j are 32 neighbouring values,
// and a thread only ever touches its own pairs (it reads them straight from
// the frame at the start): the steps, the one fused pass and the one
// barrier an order are the others'. Each order reads and writes the rows
// once: 512 KB a frame of 32,768 floats. At 56 registers (63 in double)
// two blocks share an SM, so the frames in flight hold about 67 MB of rows,
// more than the 50 MB L2, and the passes wait on memory: 1,918 frames of
// 32,768 floats take 5.8 ms against 0.19 ms of operations (chip_smoke.py,
// phase 16, NVIDIA H100 80GB HBM3, 700 W). A cluster holding the rows in
// distributed shared memory would stop at some n again (16 blocks' 227 KB)
// and still need this layout above it; this one takes every n.
#include <type_traits>

#include "common.cuh"

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
// none in the device one), rounded to 16 bytes, then the slots: (num, den)
// in double and the first pair (b1, b2) of each warp, for two parities.
template <typename T>
__host__ __device__ size_t smem_bytes(int N, int threads, int where) {
  const size_t rows = where == kRowsShared ? 2 * static_cast<size_t>(N - 1)
                      : where == kRowsRegisters ? static_cast<size_t>(N) : 0;
  const size_t W = static_cast<size_t>(threads) / 32;
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

    if (warp == 0) {
      // a[q] = a[q] - ci a[i - 2 - q] for q < i - 1; a[i - 1] = ci. The
      // mirrors r = i - 2 - lane - 32 k of one lane's coefficients all sit
      // on source lane (i - 2 - lane) mod 32, in register r / 32.
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

template <typename T, int C, int kRows>
int launch_with(const void* x, void* coef, void* status, void* scratch, int B, int N, int P, int threads, int width,
                cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(N, threads, kRows);
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

// threads: a multiple of 32, at most kMaxThreads, with threads x width >=
// n - 1; rows: kRowsRegisters (width: the dtype's register width),
// kRowsShared (kSharedWidth) or kRowsDevice (kMaxThreads threads, any
// width; scratch: B x 2 x threads x width values, else unused).
template <typename T>
int launch(const void* x, void* coef, void* status, void* scratch, int B, int N, int P, int threads, int width,
           int rows, void* stream) {
  if (P < 1 || P > kMaxOrder || N < 2 || threads < 32 || threads % 32 != 0 || threads > kMaxThreads ||
      width < 1 || static_cast<long>(threads) * width < N - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
                          int width, int rows, void* stream) {
  return launch<float>(x, coef, status, scratch, B, N, P, threads, width, rows, stream);
}

VT_EXPORT int vt_burg_f64(const void* x, void* coef, void* status, void* scratch, int B, int N, int P, int threads,
                          int width, int rows, void* stream) {
  return launch<double>(x, coef, status, scratch, B, N, P, threads, width, rows, stream);
}
