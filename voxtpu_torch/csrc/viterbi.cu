// Kernel F: the Viterbi pitch-path DP over per-frame candidates and its
// backtrace, one thread block per recording.
//
// Replaces voxtpu/ops/viterbi_pallas.py::viterbi_path_pallas (pallas_call at
// viterbi_pallas.py:213). Semantics follow the plain version
// (voxtpu_torch/ops/viterbi.py, the DP of voxtpu.viterbi.pitch_path) op for
// op, so paths are bit-identical to it:
//   cost(i, j)  = both voiced ? ojc * |log2(f_prev[i] / f_cur[j])|
//                             : (exactly one voiced ? vuc : 0)
//   total(i, j) = score_prev[i] - cost(i, j)
//   bp[t][j]    = first-win argmax_i total(i, j) (a NaN is the maximum, all
//                 -inf gives 0, as jnp.argmax and torch.max)
//   score[j]    = local[t][j] + max_i total(i, j)
// and the path starts at the first-win argmax of the last frame's scores.
//
// What bounds it: the chain of F dependent frame steps. Its bytes (local,
// freq, voiced and the path: about 5 MB at the bench path's 15,369 frames of
// 33 candidates in float32) take about 1.5 us of device memory, and its
// F C^2 transition costs are 17 M divisions and log2s. Each frame's step
// needs the previous frame's scores, so one recording runs on one SM, and
// the time is F times the latency of one step.
//
// Design: the step's C x C costs are spread over the block. A group of G
// lanes (a power of two, G <= C, G C <= 1024: G = 16 for C = 33) owns
// current candidate j; lane g takes previous candidates g, g + G, ..., in
// order, then the group combines its G partial argmaxes with shuffles, in an
// order-aware first-win rule, so the result is the sequential argmax. The
// previous frame's scores, frequencies and voiced flags sit in shared
// memory, double-buffered so one barrier per frame suffices; the rows of the
// next two frames are loaded into registers ahead of use. Backpointers go to
// device memory, (B, F, C) int32. The backtrace stages them back through
// shared memory in chunks of rows read by the whole block, and one thread
// walks each chunk. B recordings are B blocks of one launch. The TPU
// kernel's DMA blocks, column transposes by where-identity reductions and
// lane-packed path rows were Mosaic layout and are gone.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kMaxC = 128;
constexpr int kMaxThreads = 1024;
constexpr int kStageInts = 8192;  // backtrace chunk: kStageInts / C rows

__device__ __forceinline__ float vt_log2(float x) { return log2f(x); }
__device__ __forceinline__ double vt_log2(double x) { return log2(x); }

// True when (b, ib) precedes (a, ia) in the first-win argmax order: the
// larger value, a NaN above everything, the smaller index on a tie.
template <typename T>
__device__ __forceinline__ bool precedes(T b, int ib, T a, int ia) {
  if (isnan(a)) return isnan(b) && ib < ia;
  if (isnan(b)) return true;
  return b > a || (b == a && ib < ia);
}

template <typename T>
struct Row {
  T f;
  T l;
  bool v;
};

template <typename T>
__device__ __forceinline__ Row<T> load_row(const T* fr, const T* loc, const unsigned char* vd,
                                           long o) {
  return Row<T>{fr[o], loc[o], vd[o] != 0};
}

template <typename T>
__global__ void viterbi_kernel(const T* __restrict__ local, const T* __restrict__ freq,
                               const unsigned char* __restrict__ voiced, int* bp,
                               int* __restrict__ path, int F, int C, int G, T ojc, T vuc) {
  __shared__ T score[2][kMaxC];
  __shared__ T fq[2][kMaxC];
  __shared__ bool vo[2][kMaxC];
  __shared__ int stage[kStageInts];
  __shared__ int start;

  const long base = static_cast<long>(blockIdx.x) * F * C;
  const T* loc = local + base;
  const T* fr = freq + base;
  const unsigned char* vd = voiced + base;
  int* bpr = bp + base;
  int* pr = path + static_cast<long>(blockIdx.x) * F;

  const int g = threadIdx.x & (G - 1);
  const int j = threadIdx.x / G;
  const bool writer = j < C && g == 0;
  const int jj = j < C ? j : C - 1;  // lanes past the last candidate compute on its data

  if (writer) {
    score[0][j] = loc[j];
    fq[0][j] = fr[j];
    vo[0][j] = vd[j] != 0;
  }
  Row<T> next1{}, next2{};
  if (F > 1) next1 = load_row(fr, loc, vd, static_cast<long>(C) + jj);
  if (F > 2) next2 = load_row(fr, loc, vd, 2L * C + jj);
  __syncthreads();

  for (int t = 1; t < F; ++t) {
    const int cur = t & 1;
    const int prev = cur ^ 1;
    const Row<T> row = next1;
    next1 = next2;
    if (t + 2 < F) next2 = load_row(fr, loc, vd, static_cast<long>(t + 2) * C + jj);

    T best = T(0);
    int arg = 0;
    for (int i = g; i < C; i += G) {
      const bool vp = vo[prev][i];
      T cost;
      if (vp && row.v) {
        cost = ojc * fabs(vt_log2(fq[prev][i] / row.f));
      } else {
        cost = vp != row.v ? vuc : T(0);
      }
      const T total = score[prev][i] - cost;
      if (i == g || precedes(total, i, best, arg)) {
        best = total;
        arg = i;
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
      const T ob = __shfl_down_sync(0xffffffffu, best, off, G);
      const int oa = __shfl_down_sync(0xffffffffu, arg, off, G);
      if (precedes(ob, oa, best, arg)) {
        best = ob;
        arg = oa;
      }
    }
    if (writer) {
      bpr[static_cast<long>(t) * C + j] = arg;
      score[cur][j] = row.l + best;
      fq[cur][j] = row.f;
      vo[cur][j] = row.v;
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    const int last = (F - 1) & 1;
    T best = score[last][0];
    int arg = 0;
    for (int i = 1; i < C; ++i) {
      if (precedes(score[last][i], i, best, arg)) {
        best = score[last][i];
        arg = i;
      }
    }
    start = arg;
    pr[F - 1] = arg;
  }
  __syncthreads();

  // Backtrace: rows lo+1 .. hi go to shared memory, then thread 0 walks
  // them from hi down: c = bp[t][c], path[t - 1] = c.
  int c = start;
  const int rows_per_chunk = kStageInts / C;
  for (int hi = F - 1; hi >= 1; hi -= rows_per_chunk) {
    const int lo = hi - rows_per_chunk > 0 ? hi - rows_per_chunk : 0;
    const int count = (hi - lo) * C;
    const int* src = bpr + static_cast<long>(lo + 1) * C;
    for (int e = threadIdx.x; e < count; e += blockDim.x) stage[e] = src[e];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = hi; t > lo; --t) {
        c = stage[(t - lo - 1) * C + c];
        pr[t - 1] = c;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* local, const void* freq, const void* voiced, void* bp, void* path, int B,
           int F, int C, double ojc, double vuc, void* stream) {
  if (F < 1 || C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  int G = 32;
  while (G > C || G * C > kMaxThreads) G >>= 1;
  if (B > 0) {
    const int threads = (G * C + 31) / 32 * 32;
    viterbi_kernel<T><<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(local), static_cast<const T*>(freq),
        static_cast<const unsigned char*>(voiced), static_cast<int*>(bp), static_cast<int*>(path),
        F, C, G, static_cast<T>(ojc), static_cast<T>(vuc));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VT_EXPORT int vt_viterbi_f32(const void* local, const void* freq, const void* voiced, void* bp,
                             void* path, int B, int F, int C, double ojc, double vuc,
                             void* stream) {
  return launch<float>(local, freq, voiced, bp, path, B, F, C, ojc, vuc, stream);
}

VT_EXPORT int vt_viterbi_f64(const void* local, const void* freq, const void* voiced, void* bp,
                             void* path, int B, int F, int C, double ojc, double vuc,
                             void* stream) {
  return launch<double>(local, freq, voiced, bp, path, B, F, C, ojc, vuc, stream);
}
