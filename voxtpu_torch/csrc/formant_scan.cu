// Kernel D: the McCandless formant-slot tracker scanned over frames, as a
// chunked speculative scan with exact repair.
//
// Replaces voxtpu/ops/formant_scan_pallas.py::mccandless_scan_pallas
// (pallas_call at formant_scan_pallas.py:284). Semantics follow
// voxtpu.formants.estimate_formants_step (the reference's
// EstimateFormants, spectrum.rs:232-333) exactly, frame after frame:
//   step 2: each of the first min(L, 6) estimates takes its nearest
//           resonance (first wins on ties, and a NaN distance is the
//           minimum, as torch.argmin), over the whole resonance row
//           including its zero tail;
//   step 3: dedup of neighbouring slots with the moving pointer w;
//   step 4: fill empty slots with the first min(R, 6) resonances (b1, b2,
//           b3 branches);
//   step 5: stable sort, invalid slots first, then by frequency, NaN last
//           (torch.sort's order);
//   write-back: the winners (valid, freq > 0) overwrite the leading
//           estimates in order. Winners are never NaN, so steps 5 and
//           write-back together place each winner at its stable rank by
//           frequency among the winners.
// The carry resets to the seed at the first frame of every recording (F =
// files * file_len frames). Only comparisons, copies and |a - b| touch the
// values, so the result is bit-identical to the plain version in any dtype.
//
// What bounds it: latency. The step is a pure function of (carry, row), a
// few hundred dependent operations, and the carry's dependence on the past
// is data-dependent, so one frame cannot start before the frame before it
// ends. The work is made parallel by speculating instead:
//
// 1. Speculate (formant_scan_speculate, one warp a chunk). Each recording
//    is cut into chunks of kChunk frames that never cross its boundary. A
//    chunk's warp starts kWarmup frames before the chunk from the seed (at
//    the recording's first frame where that comes sooner, and then the
//    chunk is exact), steps through the warm-up and the chunk, writes the
//    chunk's outputs and keeps the carry it held on entering the chunk.
//    Tracks forget their start within a few dozen frames of speech, so
//    most chunks enter with the true carry (chip_smoke.py prints the share
//    on every path).
// 2. Repair (formant_scan_repair, one block a recording). The block compares
//    each chunk's speculated entry carry, bit for bit (a NaN matches itself,
//    -0.0 does not match 0.0), with the stored output of the frame before
//    it. Then one warp walks the chunks in order; from the first that
//    differs it re-runs from the true carry, overwriting, and stops at the
//    first frame whose recomputed carry equals, bit for bit, the output
//    stored there: from that frame on the stored outputs follow from the
//    true carry. The result is the serial scan's, bit for bit; the worst
//    case (no speculation holds) is the serial chain.
//
// The step runs on one warp: lane j holds resonance j of the row (j + 32,
// j + 64, ... beyond 32 are read from the row in the step, a group of 32 at
// a time), each estimate's nearest match is a warp min (redux.sync) and a
// ballot for its first lane, and steps 3-5 run in every lane on registers
// with compile-time slot indices (runtime slot pointers are select chains),
// so nothing lives in local memory. Step 4 is skipped, by a branch uniform
// across the warp, when step 3 found no duplicate, as in most frames of
// speech. Rows are prefetched into L2 a chunk at a time and loaded into
// registers two frames ahead, so for R <= 32 no global load sits on the
// carry's chain. Times and repair counts: PERF.md.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kSlots = 6;  // FormantSlots = [Option<Resonance>; 6] (spectrum.rs:228)
constexpr int kMaxL = 128;  // estimates: voxtpu's LANES (formant_scan_pallas.py:31)
constexpr int kChunk = 64;   // frames a chunk (ops/formant_scan.py CHUNK)
constexpr int kWarmup = 96;  // frames stepped from the seed before a chunk (ops/formant_scan.py WARMUP)
constexpr int kWarps = 4;    // chunks (warps) a speculation block
constexpr int kRepairThreads = 256;  // chunks compared at once by a repair block
constexpr int kSpec = 2 * kSlots;    // a speculated entry carry: 6 frequencies, 6 bandwidths
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kWarm, kWrite, kRepair };

// Orders |f - e| as torch.argmin does: a NaN distance is the least, then
// ascending. fabs clears the sign, so equal keys are equal distances.
__device__ __forceinline__ uint32_t dist_key(float d) {
  return isnan(d) ? 0u : __float_as_uint(d) + 1u;
}
__device__ __forceinline__ unsigned long long dist_key(double d) {
  return isnan(d) ? 0ull : static_cast<unsigned long long>(__double_as_longlong(d)) + 1ull;
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned long long bits(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}

// The least key over the warp.
__device__ __forceinline__ uint32_t warp_min(uint32_t key) { return __reduce_min_sync(kFull, key); }
__device__ __forceinline__ unsigned long long warp_min(unsigned long long key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  const unsigned lo = static_cast<unsigned>(key);
  const unsigned mh = __reduce_min_sync(kFull, hi);
  const unsigned ml = __reduce_min_sync(kFull, hi == mh ? lo : 0xffffffffu);
  return (static_cast<unsigned long long>(mh) << 32) | ml;
}

// v[i] for a runtime i in [0, 6), as a select chain so v stays in registers.
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[kSlots], int i) {
  T r = v[0];
#pragma unroll
  for (int k = 1; k < kSlots; ++k) r = i == k ? v[k] : r;
  return r;
}

// The carry: estimates 0..5. Write-back never reaches estimate 6 or above,
// and steps 2 and 3 read estimates 0..5 alone, so estimates 6..L-1 stay the
// seed and change nothing: an output column at or above 6 is its seed in
// every frame. Slots at or above L are unused.
template <typename T>
struct Carry {
  T f[kSlots];
  T b[kSlots];
};

// One McCandless update of the carry, in every lane of the warp. f0, b0:
// this lane's resonance of the row (j = lane; 0 where lane >= R); row_f,
// row_b: the row in device memory, read for resonances 32 and above.
template <typename T>
__device__ __forceinline__ void mccandless_step(Carry<T>& c, T f0, T b0, const T* __restrict__ row_f,
                                                const T* __restrict__ row_b, int R, int L, int lane) {
  using Key = decltype(dist_key(T(0)));
  const int ns = L < kSlots ? L : kSlots;
  const int nfill = R < kSlots ? R : kSlots;

  // Step 4's peaks, resonances 0..5 from lanes 0..5: off the carry's chain.
  T pf[kSlots], pb[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    pf[j] = __shfl_sync(kFull, f0, j);
    pb[j] = __shfl_sync(kFull, b0, j);
  }
  // Step 3's estimates ef[min(r, L - 1)].
  T est[kSlots];
  {
    const T last = pick(c.f, L - 1 < kSlots - 1 ? L - 1 : kSlots - 1);
#pragma unroll
    for (int r = 0; r < kSlots; ++r) est[r] = r < L - 1 ? c.f[r] : last;
  }

  // Step 2: nearest resonance per estimate slot (spectrum.rs:234-245),
  // all six slots at once (no branch, so their reductions overlap); slots
  // at or above ns are dropped after. Resonances 32 and above come a group
  // of 32 at a time; an earlier group wins a tie.
  T sf[kSlots], sb[kSlots];
  bool sv[kSlots];
  {
    Key best[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const Key k = lane < R ? dist_key(fabs(f0 - c.f[s])) : static_cast<Key>(~Key(0));
      best[s] = warp_min(k);
      const int src = __ffs(__ballot_sync(kFull, k == best[s])) - 1;
      sf[s] = __shfl_sync(kFull, f0, src);
      sb[s] = __shfl_sync(kFull, b0, src);
    }
    for (int g = 32; g < R; g += 32) {
      const int j = g + lane;
      const T f = j < R ? row_f[j] : T(0);
      const T b = j < R ? row_b[j] : T(0);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const Key k = j < R ? dist_key(fabs(f - c.f[s])) : static_cast<Key>(~Key(0));
        const Key m = warp_min(k);
        const int src = __ffs(__ballot_sync(kFull, k == m)) - 1;
        const T gf = __shfl_sync(kFull, f, src);
        const T gb = __shfl_sync(kFull, b, src);
        const bool take = m < best[s];
        best[s] = take ? m : best[s];
        sf[s] = take ? gf : sf[s];
        sb[s] = take ? gb : sb[s];
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      sv[s] = s < ns;
      sf[s] = sv[s] ? sf[s] : T(0);
      sb[s] = sv[s] ? sb[s] : T(0);
    }
  }

  // Step 3: dedup with the moving pointer w (spectrum.rs:250-272). Step 3
  // changes no frequency, so slot w's values are kept beside w.
  int w = 0;
  T fw = sf[0], bw = sb[0], ew = est[0];
  bool unassigned = false;
#pragma unroll
  for (int r = 1; r < kSlots; ++r) {
    const bool valid_r = sv[r];
    const bool same = valid_r && sf[r] == fw && sb[r] == bw;
    const bool closer_r = fabs(sf[r] - est[r]) < fabs(sf[r] - ew);
    const bool inval_w = same && closer_r;
#pragma unroll
    for (int k = 0; k < r; ++k) sv[k] = sv[k] && !(inval_w && w == k);
    if (same && !closer_r) sv[r] = false;
    unassigned = unassigned || same;
    if (inval_w || (!same && valid_r)) {
      w = r;
      fw = sf[r];
      bw = sb[r];
      ew = est[r];
    }
  }

  // Step 4: fill empty slots with unassigned peaks (spectrum.rs:274-310);
  // iterations j >= 6 change nothing, and nothing happens unless step 3
  // found a duplicate: a branch uniform across the warp.
  if (unassigned) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      bool contains = false;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) contains = contains || (sv[k] && sf[k] == pf[j] && sb[k] == pb[j]);
      bool can = j < nfill && !contains;
      const bool b1 = can && !sv[j];
      sf[j] = b1 ? pf[j] : sf[j];
      sb[j] = b1 ? pb[j] : sb[j];
      sv[j] = sv[j] || b1;
      can = can && !b1;
      if (j > 0) {
        const bool b2 = can && !sv[j - 1];  // swap(j, j - 1), then slot j = peak
        sf[j - 1] = b2 ? sf[j] : sf[j - 1];
        sb[j - 1] = b2 ? sb[j] : sb[j - 1];
        sv[j - 1] = b2 ? sv[j] : sv[j - 1];
        sf[j] = b2 ? pf[j] : sf[j];
        sb[j] = b2 ? pb[j] : sb[j];
        sv[j] = sv[j] || b2;
        can = can && !b2;
      }
      if (j + 1 < kSlots) {
        const bool b3 = can && !sv[j + 1];  // swap(j, j + 1), then slot j = peak
        sf[j + 1] = b3 ? sf[j] : sf[j + 1];
        sb[j + 1] = b3 ? sb[j] : sb[j + 1];
        sv[j + 1] = b3 ? sv[j] : sv[j + 1];
        sf[j] = b3 ? pf[j] : sf[j];
        sb[j] = b3 ? pb[j] : sb[j];
        sv[j] = sv[j] || b3;
      }
    }
  }

  // Steps 5 and write-back (spectrum.rs:312-332): the stable sort puts
  // invalid slots first and NaN last, and only the winners (valid, freq >
  // 0, so never NaN) reach the estimates, in sorted order. Restricted to
  // the winners the stable sort is theirs: ascending frequency, ties in
  // slot order. So winner k goes to estimate rank[k], the count of winners
  // before it in that order.
  bool win[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) win[k] = sv[k] && sf[k] > T(0);
  int rank[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    int r = 0;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      if (m != k) r += (win[m] && (m < k ? sf[m] <= sf[k] : sf[m] < sf[k])) ? 1 : 0;
    }
    rank[k] = r;
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    T nf = c.f[i], nb = c.b[i];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const bool hit = i < L && win[k] && rank[k] == i;
      nf = hit ? sf[k] : nf;
      nb = hit ? sb[k] : nb;
    }
    c.f[i] = nf;
    c.b[i] = nb;
  }
}

// What a lane reads of frame u ahead of its step: its resonance, and in
// repair the stored outputs it compares with.
template <typename T>
struct Ahead {
  T f, b, of, ob;
};

template <typename T, int kMode>
__device__ __forceinline__ Ahead<T> load_ahead(const T* __restrict__ rf, const T* __restrict__ rb,
                                               const T* out_f, const T* out_b, long u, long t_end, int R,
                                               int L, int lane) {
  Ahead<T> a{T(0), T(0), T(0), T(0)};
  if (u < t_end) {
    if (lane < R) {
      a.f = rf[u * R + lane];
      a.b = rb[u * R + lane];
    }
    if (kMode == kRepair && lane < kSlots && lane < L) {
      a.of = out_f[u * L + lane];
      a.ob = out_b[u * L + lane];
    }
  }
  return a;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Brings the rows of frames [t, t_end) into L2, 128-byte lines spread over
// the lanes.
template <typename T>
__device__ __forceinline__ void prefetch_rows(const T* rf, const T* rb, long t, long t_end, int R,
                                              int lane) {
  const long bytes = (t_end - t) * R * static_cast<long>(sizeof(T));
  if (bytes <= 0) return;
  const char* a = reinterpret_cast<const char*>(rf + t * R);
  const char* b = reinterpret_cast<const char*>(rb + t * R);
  for (long o = lane * 128L; o < bytes; o += 32 * 128L) {
    prefetch_l2(a + o);
    prefetch_l2(b + o);
  }
  if (lane == 0) {
    prefetch_l2(a + bytes - 1);
    prefetch_l2(b + bytes - 1);
  }
}

// Steps the carry over frames [t, t_end), rows loaded two frames ahead.
// kWarm writes nothing; kWrite writes every frame's estimates; kRepair
// compares the new carry with the stored outputs, stops at the first frame
// where they are equal bit for bit (sets *converged), and overwrites the
// frames before it. Returns the frames stepped.
template <typename T, int kMode>
__device__ __forceinline__ long run_frames(Carry<T>& c, const T* __restrict__ rf, const T* __restrict__ rb,
                                           T* out_f, T* out_b, long t, long t_end, int R, int L, int lane,
                                           T seed_f, T seed_b, bool* converged) {
  const long t_begin = t;
  const int nl = L < kSlots ? L : kSlots;
  Ahead<T> a[2];
  a[0] = load_ahead<T, kMode>(rf, rb, out_f, out_b, t, t_end, R, L, lane);
  a[1] = load_ahead<T, kMode>(rf, rb, out_f, out_b, t + 1, t_end, R, L, lane);
  while (t < t_end) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a[i] holds frame t; compile-time i keeps a in registers
      if (t < t_end) {
        mccandless_step(c, a[i].f, a[i].b, rf + t * R, rb + t * R, R, L, lane);
        const T mf = lane < kSlots ? pick(c.f, lane) : seed_f;
        const T mb = lane < kSlots ? pick(c.b, lane) : seed_b;
        if (kMode == kWrite) {
          if (lane < L) {
            out_f[t * L + lane] = mf;
            out_b[t * L + lane] = mb;
          }
        } else if (kMode == kRepair) {
          const bool eq = lane >= nl || (bits(mf) == bits(a[i].of) && bits(mb) == bits(a[i].ob));
          if (__all_sync(kFull, eq)) {
            *converged = true;
            return t - t_begin + 1;
          }
          if (lane < nl) {
            out_f[t * L + lane] = mf;
            out_b[t * L + lane] = mb;
          }
        }
        a[i] = load_ahead<T, kMode>(rf, rb, out_f, out_b, t + 2, t_end, R, L, lane);
        ++t;
      }
    }
  }
  return t - t_begin;
}

template <typename T>
__device__ __forceinline__ Carry<T> seed_carry(const T* __restrict__ ef0, const T* __restrict__ eb0, int L) {
  Carry<T> c;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    c.f[s] = s < L ? ef0[s] : T(0);
    c.b[s] = s < L ? eb0[s] : T(0);
  }
  return c;
}

// Pass 1: one warp a chunk; spec[chunk] keeps the carry it entered with.
// stats (may be null): {chunks, chunks re-run, frames re-run}, set here,
// added to by the repair pass.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    formant_scan_speculate(const T* __restrict__ rf, const T* __restrict__ rb, const T* __restrict__ ef0,
                           const T* __restrict__ eb0, T* out_f, T* out_b, T* __restrict__ spec,
                           unsigned long long* __restrict__ stats, int files, int file_len, int R, int L,
                           int chunks_per_file) {
  const long chunks = static_cast<long>(files) * chunks_per_file;
  if (stats != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    stats[0] = static_cast<unsigned long long>(chunks);
    stats[1] = 0;
    stats[2] = 0;
  }
  const int lane = threadIdx.x & 31;
  const long chunk = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (chunk >= chunks) return;  // the whole warp
  const long file = chunk / chunks_per_file;
  const long start = file * file_len;
  const long t0 = start + (chunk % chunks_per_file) * kChunk;
  const long t1 = t0 + kChunk < start + file_len ? t0 + kChunk : start + file_len;
  const long tw = t0 - kWarmup > start ? t0 - kWarmup : start;
  prefetch_rows(rf, rb, tw, t1, R, lane);

  const T seed_f = lane < L ? ef0[lane] : T(0);
  const T seed_b = lane < L ? eb0[lane] : T(0);
  Carry<T> c = seed_carry(ef0, eb0, L);
  run_frames<T, kWarm>(c, rf, rb, out_f, out_b, tw, t0, R, L, lane, seed_f, seed_b, nullptr);
  if (lane < kSpec) {
    spec[chunk * kSpec + lane] = lane < kSlots ? pick(c.f, lane) : pick(c.b, lane - kSlots);
  }
  run_frames<T, kWrite>(c, rf, rb, out_f, out_b, t0, t1, R, L, lane, seed_f, seed_b, nullptr);
}

// Columns 32 .. L-1 of every frame, where L > 32: their seeds (estimates at
// or above 6 never leave the seed, see Carry). The speculation pass writes
// columns below 32, one a lane, and repair rewrites columns below 6 alone;
// a kernel of its own keeps this loop out of theirs.
template <typename T>
__global__ void __launch_bounds__(kRepairThreads)
    formant_scan_fill(const T* __restrict__ ef0, const T* __restrict__ eb0, T* __restrict__ out_f,
                      T* __restrict__ out_b, long F, int L) {
  const int w = L - 32;
  for (long i = static_cast<long>(blockIdx.x) * kRepairThreads + threadIdx.x; i < F * w;
       i += static_cast<long>(gridDim.x) * kRepairThreads) {
    const long t = i / w;
    const int col = 32 + static_cast<int>(i - t * w);
    out_f[t * L + col] = ef0[col];
    out_b[t * L + col] = eb0[col];
  }
}

// Pass 2: one block a recording. Its threads flag, kRepairThreads chunks at
// a time, the chunks whose speculated entry carry differs from the stored
// output before them; warp 0 then walks the flagged chunks in order.
// Chunks whose warm-up began at the recording's first frame are exact.
template <typename T>
__global__ void __launch_bounds__(kRepairThreads)
    formant_scan_repair(const T* __restrict__ rf, const T* __restrict__ rb, const T* __restrict__ ef0,
                        const T* __restrict__ eb0, T* out_f, T* out_b, const T* __restrict__ spec,
                        unsigned long long* __restrict__ stats, int file_len, int R, int L,
                        int chunks_per_file) {
  __shared__ unsigned differs[kRepairThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long file = blockIdx.x;
  const long start = file * file_len;
  const int nl = L < kSlots ? L : kSlots;
  const int first_speculated = kWarmup / kChunk + 1;  // k * kChunk > kWarmup

  const T seed_f = lane < L ? ef0[lane] : T(0);
  const T seed_b = lane < L ? eb0[lane] : T(0);
  Carry<T> c = seed_carry(ef0, eb0, L);
  bool running = false;  // warp 0: re-running, c the true carry
  unsigned long long rerun_chunks = 0, rerun_frames = 0;

  for (int base = 0; base < chunks_per_file; base += kRepairThreads) {
    const int k = base + threadIdx.x;
    bool d = false;
    if (k < chunks_per_file && k >= first_speculated) {
      const long prev = start + static_cast<long>(k) * kChunk - 1;
      const T* s = spec + (file * chunks_per_file + k) * kSpec;
      for (int i = 0; i < nl; ++i) {
        d = d || bits(s[i]) != bits(out_f[prev * L + i]) || bits(s[kSlots + i]) != bits(out_b[prev * L + i]);
      }
    }
    const unsigned m = __ballot_sync(kFull, d);
    if (lane == 0) differs[warp] = m;
    __syncthreads();
    if (warp == 0) {
      const int kend = base + kRepairThreads < chunks_per_file ? base + kRepairThreads : chunks_per_file;
      int kk = base;
      while (kk < kend) {
        if (!running) {
          const int off = kk - base;
          const unsigned word = differs[off >> 5] >> (off & 31);
          if (word == 0) {
            kk = base + ((off >> 5) + 1) * 32;
            continue;
          }
          kk += __ffs(word) - 1;
          const long prev = start + static_cast<long>(kk) * kChunk - 1;
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            c.f[s] = s < nl ? out_f[prev * L + s] : T(0);
            c.b[s] = s < nl ? out_b[prev * L + s] : T(0);
          }
          running = true;
        }
        const long t0 = start + static_cast<long>(kk) * kChunk;
        const long t1 = t0 + kChunk < start + file_len ? t0 + kChunk : start + file_len;
        bool converged = false;
        rerun_frames += run_frames<T, kRepair>(c, rf, rb, out_f, out_b, t0, t1, R, L, lane, seed_f, seed_b,
                                               &converged);
        ++rerun_chunks;
        running = !converged;
        ++kk;
      }
    }
    __syncthreads();
  }
  if (stats != nullptr && threadIdx.x == 0) {
    atomicAdd(&stats[1], rerun_chunks);
    atomicAdd(&stats[2], rerun_frames);
  }
}

template <typename T>
int launch(const void* rf, const void* rb, const void* ef0, const void* eb0, void* out_f, void* out_b,
           void* spec, void* stats, int F, int R, int L, int file_len, void* stream) {
  if (L < 1 || L > kMaxL || R < 1 || file_len < 1 || F % file_len != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int files = F / file_len;
  if (files > 0) {
    const int per_file = (file_len + kChunk - 1) / kChunk;
    const long chunks = static_cast<long>(files) * per_file;
    const auto s = static_cast<cudaStream_t>(stream);
    const T* rf_ = static_cast<const T*>(rf);
    const T* rb_ = static_cast<const T*>(rb);
    const T* ef_ = static_cast<const T*>(ef0);
    const T* eb_ = static_cast<const T*>(eb0);
    auto* stats_ = static_cast<unsigned long long*>(stats);
    formant_scan_speculate<T><<<vt::blocks_for(chunks, kWarps), kWarps * 32, 0, s>>>(
        rf_, rb_, ef_, eb_, static_cast<T*>(out_f), static_cast<T*>(out_b), static_cast<T*>(spec), stats_,
        files, file_len, R, L, per_file);
    formant_scan_repair<T><<<files, kRepairThreads, 0, s>>>(rf_, rb_, ef_, eb_, static_cast<T*>(out_f),
                                                            static_cast<T*>(out_b), static_cast<const T*>(spec),
                                                            stats_, file_len, R, L, per_file);
    if (L > 32) {
      const long cells = static_cast<long>(F) * (L - 32);
      const int blocks = cells < 1024L * kRepairThreads ? vt::blocks_for(cells, kRepairThreads) : 1024;
      formant_scan_fill<T><<<blocks, kRepairThreads, 0, s>>>(ef_, eb_, static_cast<T*>(out_f), static_cast<T*>(out_b),
                                                            F, L);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// spec: (files * ceil(file_len / 64), 12) scratch of the input dtype; stats:
// null, or 3 int64 (chunks, chunks re-run, frames re-run). Two kernels on
// `stream`, and a third for L > 32 (formant_scan_fill). L <= 128.
VT_EXPORT int vt_formant_scan_f32(const void* rf, const void* rb, const void* ef0, const void* eb0,
                                  void* out_f, void* out_b, void* spec, void* stats, int F, int R, int L,
                                  int file_len, void* stream) {
  return launch<float>(rf, rb, ef0, eb0, out_f, out_b, spec, stats, F, R, L, file_len, stream);
}

VT_EXPORT int vt_formant_scan_f64(const void* rf, const void* rb, const void* ef0, const void* eb0,
                                  void* out_f, void* out_b, void* spec, void* stats, int F, int R, int L,
                                  int file_len, void* stream) {
  return launch<double>(rf, rb, ef0, eb0, out_f, out_b, spec, stats, F, R, L, file_len, stream);
}
