// Kernel F: the Viterbi pitch-path DP over per-frame candidates and its
// backtrace: a pre-pass over the whole card writes every transition cost,
// then one thread block a recording walks the frames.
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
// What bounds it: the chain of F - 1 dependent frame steps. Its bytes
// (local, freq, voiced and the path: about 5 MB at the bench path's 15,369
// frames of 33 candidates in float32) take about 1.5 us of device memory,
// and its F C^2 transition costs are 17 M divisions and log2s. Each frame's
// step needs the previous frame's scores, so one recording runs on one SM,
// and the time is F - 1 times the latency of one step. The kernel this one
// replaced computed each step's C^2 costs inside the chain, on 16 lanes a
// candidate (544 threads at C = 33), and ended each step with a barrier over
// the block: 1,260 ns a step, about 795 clocks of it the costs, 734 the
// lanes' argmax, 636 the four shuffle levels (clock64 stamps, NVIDIA H100
// 80GB HBM3, 700 W; PERF.md).
//
// Design. The costs do not depend on the chain: cost(t, i, j) reads only
// frames t - 1 and t. So `viterbi_costs` computes them all first, one thread
// a cost, over every (recording, frame, j, i) of the launch on the whole
// card, with the same operations in the same order, and writes one record a
// frame step into scratch that the wrapper allocates: the costs as C rows
// (one a current candidate j) of G runs (one a lane) of L = ceil(C / G)
// previous candidates, each run padded to P = 1 + 16 ceil((L - 1) / 16)
// (odd, and room for every 16-item chunk of the run), then the frame's C
// local scores, rounded up to 16 bytes. The previous
// scores sit in shared memory in the same runs. `viterbi_chain` then walks
// a recording with at most 4 warps: G lanes a candidate (the most, a power
// of two, with G <= C and G C <= 128: G = 2 at C = 33, 3 warps), lane g

// taking the run g L, ..., g L + L - 1, whose items sit at constant offsets
// from the lane's two bases (no address arithmetic an item; a warp's 32
// lanes read 32 distinct banks, as P is odd), 16 loads in flight before the
// first compare, then a tournament over index-ordered pairs (4 levels for
// 16), and the group's lanes by log2 G shuffle levels, adjacent lanes
// first. One more warp's elected thread is the producer: it keeps a ring
// of stages of two records each (one where two stages of two do not fit;
// up to kMaxStages, as many as fit in the block's shared memory: 8 of
// 9,248 bytes at C = 33 in float32) filled ahead of the chain with bulk
// copies (cp.async.bulk, the Tensor Memory Accelerator's copy of
// contiguous bytes), each completing on the stage's `full` mbarrier; the
// chain releases a stage on its `empty` mbarrier. Two records a stage halve
// the waits, and the wait for the next stage comes before the step's
// barrier. The chain's warps end each step on a named barrier among
// themselves (bar.sync 1), not over the block; the previous scores are
// double-buffered in shared memory, so one barrier a step suffices. A step
// is C / G shared loads of scores and costs, subtractions and
// compare-selects, the combine, one score store and one backpointer store
// to device memory, (B, F, C) int32, and the barrier; every second step a
// stage's wait and release. The backtrace stages the backpointers back
// through the ring's memory in chunks of rows read by the chain's threads,
// and one thread walks each chunk. B recordings are B blocks of one
// launch, after one pre-pass over all of them.
//
// The scratch is bounded, whatever the recording's length: the wrapper
// picks K frame steps whose records for all B recordings fit in 16 MiB,
// and at least 64 (voxtpu_torch.ops.viterbi._SCRATCH_LIMIT, _MIN_STEPS;
// K = 3,628 at the bench path's 33 candidates in float32), and the host
// runs the steps in chunks of K, each chunk's pre-pass then its chain.
// A chunk's records then stay in the card's 50 MB L2 between the two:
// records of all 15,368 steps at once (71 MB) made F 9% slower at the
// bench path's shapes in float32 (NVIDIA H100 80GB HBM3, 700 W; PERF.md). A
// chain that ends before the last frame leaves its scores in `carry`, one
// row of C a recording, where the next chunk's chain starts; the last
// chunk's chain runs the backtrace over every frame. The TPU kernel's DMA
// blocks, column transposes by where-identity reductions and lane-packed
// path rows were Mosaic layout and are gone.
//
// The argmax is exact under any split of i: the first-win order (the larger
// value, a NaN above everything, the smaller index on a tie) is a strict
// total order on (value, index) pairs, so every reduction tree finds the
// sequential argmax and its value's bits. Every combine here joins a pair
// whose indices are ordered (runs ascend with the lane, items within a
// run), where the order needs no index compare (`later`).
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kMaxC = 128;         // voxtpu_torch.ops.viterbi._MAX_C
constexpr int kChainThreads = 128; // voxtpu_torch.ops.viterbi._CHAIN_THREADS: at most 4 warps on the chain
constexpr int kMaxStages = 8;      // voxtpu_torch.ops.viterbi._MAX_STAGES
constexpr int kSmemLimit = 232448; // voxtpu_torch.ops.viterbi._SMEM_LIMIT: 227 KB a block
constexpr int kChunk = 16;         // items a lane loads, then reduces as a tree (a power of two)
constexpr int kCostThreads = 256;
constexpr int kChainBarrier = 1;   // named barrier of the chain's warps (0 is __syncthreads)
// A score row's slots: the G runs of P, every slot a lane's chunks read (G P
// is at most 136, at C = 9-16).
constexpr int kScores = kMaxC + 32;

__device__ __forceinline__ float vt_log2(float x) { return log2f(x); }
__device__ __forceinline__ double vt_log2(double x) { return log2(x); }

// The first-win argmax of two (value, index) pairs whose indices are
// ordered, (b, ib) after (a, ia): b wins only by a larger value, or as a
// NaN over a number (a NaN is the maximum; ties and two NaNs keep the
// earlier index, as torch.max and jnp.argmax). Written without branches, as
// "b > a or unordered, and a is a number": one compare on the chain.
template <typename T>
__device__ __forceinline__ void later(T b, int ib, T& a, int& ia) {
  const bool p = !(b <= a) & !isnan(a);
  a = p ? b : a;
  ia = p ? ib : ia;
}

// The launch, a function of (C, dtype) alone; mirrored by
// voxtpu_torch.ops.viterbi.launch_config.
struct Config {
  int lanes;     // G, lanes a candidate
  int chain;     // the chain's threads, whole warps
  int run;       // L, previous candidates a lane
  int pitch;     // P, a run's pitch: 1 + kChunk ceil((L - 1) / kChunk), odd
  int record;    // a record's bytes: C rows of G P costs, C local scores
  int per;       // records a stage: 2 where two stages of two fit, else 1
  int stages;    // ring stages
  int smem;      // dynamic shared memory: the ring, two score rows, the mbarriers, the start
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

inline Config config_for(int C, int isz) {
  Config c{};
  c.lanes = 32;
  while (c.lanes > C || c.lanes * C > kChainThreads) c.lanes >>= 1;
  c.chain = round_up(c.lanes * C, 32);
  c.run = (C + c.lanes - 1) / c.lanes;
  c.pitch = (c.run - 1 + kChunk - 1) / kChunk * kChunk + 1;
  c.record = round_up((C * c.lanes * c.pitch + C) * isz, 16);
  const int fixed = round_up(2 * kScores * isz, 16) + 2 * kMaxStages * 8 + 16;
  const int fit = (kSmemLimit - fixed) / c.record;
  c.per = fit >= 4 ? 2 : 1;
  c.stages = fit / c.per < kMaxStages ? fit / c.per : kMaxStages;
  c.smem = c.stages * c.per * c.record + fixed;
  return c;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void chain_sync(int threads) {
  asm volatile("bar.sync %0, %1;" ::"n"(kChainBarrier), "r"(threads) : "memory");
}

// The transition costs of frame steps t0, ..., t0 + K - 1 of every
// recording, one thread a slot: record b K + t - t0 holds cost(t, i, j) at
// [(j G + i / L) P + i mod L], 0 in the other slots of its C rows of G P,
// and local[t][j] at [C G P + j].
template <typename T>
__global__ void __launch_bounds__(kCostThreads)
    viterbi_costs(const T* __restrict__ local, const T* __restrict__ freq, const unsigned char* __restrict__ voiced,
                  unsigned char* __restrict__ records, int B, int F, int C, int G, int L, int P, int record, int t0,
                  int K, T ojc, T vuc) {
  const int row = G * P;
  const long cc = static_cast<long>(C) * row;
  const long total = static_cast<long>(B) * K * cc;
  const long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long step = e / cc;  // b K + t - t0
  const int rem = static_cast<int>(e - step * cc);
  const int j = rem / row;
  const int slot = rem - j * row;  // run slot / P, item slot % P
  const int k = slot % P;
  const int i = slot / P * L + k;
  const long b = step / K;
  const long t = step - b * K + t0;
  const long prev = (b * F + t - 1) * C;
  const long cur = (b * F + t) * C;
  T cost = T(0);  // the padding of a run, and the slots past the last candidate
  if (k < L && i < C) {
    const bool vp = voiced[prev + i] != 0;
    const bool vc = voiced[cur + j] != 0;
    if (vp && vc) {
      cost = ojc * fabs(vt_log2(freq[prev + i] / freq[cur + j]));
    } else {
      cost = vp != vc ? vuc : T(0);
    }
  }
  T* rec = reinterpret_cast<T*>(records + step * record);
  rec[rem] = cost;
  if (rem < C) rec[C * row + rem] = local[cur + rem];
}

// Frame steps t0, ..., t1 - 1 of recording blockIdx.x's chain, from the
// records of those steps; the scores before step t0 are local[0] (t0 = 1)
// or carry[b], where the launch before left them, and the scores after t1 -
// 1 go to carry[b] (t1 < F) or start the backtrace (t1 = F). Threads [0,
// chain) run the chain; thread `chain` is the producer. kProbe: thread 0 of
// block 0 adds the clocks of the frame loop and of its parts to stamps =
// (loop clocks, clocks waiting for a stage, steps, loop ns, clocks in the
// lanes' argmax, in the combine and shuffles, in the stores, at the
// barrier and the release).
template <typename T, bool kProbe>
__global__ void __launch_bounds__(kChainThreads + 32, 1)
    viterbi_chain(const T* __restrict__ local, const unsigned char* __restrict__ records, T* __restrict__ carry,
                  int* bp, int* __restrict__ path, long long* __restrict__ stamps, int F, int C, int G, int L, int P,
                  int record, int per, int stages, int chain, int t0, int t1) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  const int ring_bytes = stages * per * record;
  T* score = reinterpret_cast<T*>(smem + ring_bytes);  // [2][kScores], candidate i at pos(i)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring_bytes + round_up(2 * kScores * sizeof(T), 16));
  uint64_t* empty = full + kMaxStages;
  int* start = reinterpret_cast<int*>(empty + kMaxStages);

  const long base = static_cast<long>(blockIdx.x) * F * C;
  const unsigned char* recs = records + static_cast<long>(blockIdx.x) * (t1 - t0) * record;
  T* carried = carry + static_cast<long>(blockIdx.x) * C;
  int* bpr = bp + base;
  int* pr = path + static_cast<long>(blockIdx.x) * F;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Candidate i's slot in a score row: its run's position, as in a record row.
  const auto pos = [L, P](int i) { return i / L * P + i % L; };
  // Slots of no candidate hold -inf: with the records' 0 there, the items
  // a lane reads past its candidates total -inf, which no earlier item
  // loses to.
  for (int e = threadIdx.x; e < 2 * kScores; e += blockDim.x) score[e] = -static_cast<T>(INFINITY);
  __syncthreads();
  T* first = score + ((t0 - 1) & 1) * kScores;
  for (int j = threadIdx.x; j < C; j += blockDim.x) first[pos(j)] = t0 == 1 ? local[base + j] : carried[j];
  __syncthreads();

  if (threadIdx.x >= chain) {
    // The producer: stage s takes records per s, ..., per s + per - 1, then
    // per (s + stages), ...; round r of a stage waits for the chain to
    // release round r - 1.
    if (threadIdx.x == chain) {
      int s = 0;
      unsigned round = 0;
      for (int q = 0; q < t1 - t0; q += per) {
        const int bytes = (t1 - t0 - q < per ? t1 - t0 - q : per) * record;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        mbar_expect_tx(&full[s], bytes);
        bulk_copy(ring + s * per * record, recs + static_cast<long>(q) * record, bytes, &full[s]);
        if (++s == stages) {
          s = 0;
          ++round;
        }
      }
    }
    return;
  }

  const int g = threadIdx.x & (G - 1);
  const int j = threadIdx.x / G;
  const bool writer = j < C && g == 0;
  const int jj = j < C ? j : C - 1;  // lanes past the last candidate compute on its data
  const int items = min(L, C - g * L);  // the lane's run, g L + k for k < items (none when C < g L + 1)
  const int slot = pos(jj);

  long long loop_clocks = 0, wait_clocks = 0, part_clocks[4] = {0, 0, 0, 0};
  unsigned long long ns0 = 0;
  if (kProbe && threadIdx.x == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
    loop_clocks = clock64();
  }
  int s = 0;            // the stage of record t - 1
  int sub = 0;          // its place in the stage
  unsigned parity = 0;  // the stage's round's parity
  int* bpt = bpr + static_cast<long>(t0) * C + j;  // bp[t][j] of the step
  if (t1 > t0) mbar_wait(&full[0], 0);
  for (int t = t0; t < t1; ++t) {
    const T* sp = score + ((t - 1) & 1) * kScores + g * P;  // the lane's run of previous scores
    T* sc = score + (t & 1) * kScores;
    long long c1 = 0;
    if (kProbe && threadIdx.x == 0) c1 = clock64();
    const T* rec = reinterpret_cast<const T*>(ring + (s * per + sub) * record);
    const T* cost = rec + (jj * G + g) * P;  // the lane's run of row jj
    const T loc = rec[C * G * P + jj];

    // Lane g's items k = 0, 1, ... are the previous candidates i = g L + k.
    // Item 0 starts the lane's argmax; then kChunk items at a time, their
    // loads all in flight before the first compare, reduced as a
    // tournament over adjacent pairs, and joined after. The run's pitch
    // holds every chunk: items past the lane's candidates (all of a lane
    // with none) read -inf scores and 0 costs, and total -inf.
    T best = sp[0] - cost[0];
    int arg = g * L;
    for (int k0 = 1; k0 < items; k0 += kChunk) {
      T v[kChunk];
      int a[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        v[c] = sp[k0 + c] - cost[k0 + c];
        a[c] = g * L + k0 + c;
      }
#pragma unroll
      for (int w = 1; w < kChunk; w <<= 1) {
#pragma unroll
        for (int c = 0; c < kChunk; c += 2 * w) later(v[c + w], a[c + w], v[c], a[c]);
      }
      later(v[0], a[0], best, arg);
    }
    long long c2 = 0;
    if (kProbe && threadIdx.x == 0) {
      c2 = clock64();
      part_clocks[0] += c2 - c1;
    }
    // Lanes join in pairs, then pairs of pairs: lane g + off holds the runs
    // after lane g's, and lane 0 ends with the group's argmax.
    for (int off = 1; off < G; off <<= 1) {
      const T ob = __shfl_down_sync(0xffffffffu, best, off, G);
      const int oa = __shfl_down_sync(0xffffffffu, arg, off, G);
      if (g + off < G) later(ob, oa, best, arg);
    }
    long long c3 = 0;
    if (kProbe && threadIdx.x == 0) {
      c3 = clock64();
      part_clocks[1] += c3 - c2;
    }
    if (writer) {
      *bpt = arg;
      sc[slot] = loc + best;
    }
    bpt += C;
    long long c4 = 0;
    if (kProbe && threadIdx.x == 0) {
      c4 = clock64();
      part_clocks[2] += c4 - c3;
    }
    // A step that ends its stage waits for the next stage, the wait
    // overlapping the other warps' ends of the step (unless the ring has
    // one stage, which the chain must release first), and releases its own.
    const bool more = t + 1 < t1;
    const bool turn = sub + 1 == per;
    const int next = turn ? (s + 1 == stages ? 0 : s + 1) : s;
    const unsigned next_parity = turn && next == 0 ? parity ^ 1 : parity;
    if (more && turn && stages > 1) mbar_wait(&full[next], next_parity);
    long long c5 = 0;
    if (kProbe && threadIdx.x == 0) {
      c5 = clock64();
      wait_clocks += c5 - c4;
    }
    chain_sync(chain);
    if (turn && threadIdx.x == 0) mbar_arrive(&empty[s]);
    if (more && turn && stages == 1) mbar_wait(&full[next], next_parity);
    if (kProbe && threadIdx.x == 0) part_clocks[3] += clock64() - c5;
    s = next;
    sub = turn ? 0 : sub + 1;
    parity = next_parity;
  }
  if (kProbe && threadIdx.x == 0 && blockIdx.x == 0) {
    unsigned long long ns1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
    stamps[0] += clock64() - loop_clocks;
    stamps[1] += wait_clocks;
    stamps[2] += t1 - t0;
    stamps[3] += static_cast<long long>(ns1 - ns0);
    for (int k = 0; k < 4; ++k) stamps[4 + k] += part_clocks[k];
  }
  if (t1 < F) {
    // The last step ended on the chain's barrier: its scores are in place.
    const T* last = score + ((t1 - 1) & 1) * kScores;
    for (int i = threadIdx.x; i < C; i += chain) carried[i] = last[pos(i)];
    return;
  }

  // The path's start: the first-win argmax of the last frame's scores.
  if (threadIdx.x == 0) {
    const T* last = score + ((F - 1) & 1) * kScores;
    T best = last[0];
    int arg = 0;
    for (int i = 1; i < C; ++i) later(last[pos(i)], i, best, arg);
    *start = arg;
    pr[F - 1] = arg;
  }
  chain_sync(chain);

  // Backtrace: rows lo+1 .. hi go to the ring's memory (every bulk copy has
  // completed: the chain waited for each), then thread 0 walks them from hi
  // down: c = bp[t][c], path[t - 1] = c.
  int* stage = reinterpret_cast<int*>(ring);
  int c = *start;
  const int rows_per_chunk = ring_bytes / (4 * C);
  for (int hi = F - 1; hi >= 1; hi -= rows_per_chunk) {
    const int lo = hi - rows_per_chunk > 0 ? hi - rows_per_chunk : 0;
    const int count = (hi - lo) * C;
    const int* src = bpr + static_cast<long>(lo + 1) * C;
    for (int e = threadIdx.x; e < count; e += chain) stage[e] = src[e];
    chain_sync(chain);
    if (threadIdx.x == 0) {
      for (int t = hi; t > lo; --t) {
        c = stage[(t - lo - 1) * C + c];
        pr[t - 1] = c;
      }
    }
    chain_sync(chain);
  }
}

template <typename T, bool kProbe>
int launch_chain(const void* local, const void* records, void* carry, void* bp, void* path, void* stamps, int B,
                 int F, int C, int t0, int t1, const Config& c, cudaStream_t stream) {
  const auto kernel = viterbi_chain<T, kProbe>;
  if (c.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, c.chain + 32, c.smem, stream>>>(
      static_cast<const T*>(local), static_cast<const unsigned char*>(records), static_cast<T*>(carry),
      static_cast<int*>(bp), static_cast<int*>(path), static_cast<long long*>(stamps), F, C, c.lanes, c.run,
      c.pitch, c.record, c.per, c.stages, c.chain, t0, t1);
  return static_cast<int>(cudaGetLastError());
}

// records: B steps records of `record` bytes (`record` as config_for gives
// it, the wrapper's mirror); carry: B C scores; the frame steps run in
// chunks of `steps`, each chunk's costs then its chain, the last chunk's
// chain then the backtrace. stamps: nullptr, or 8 int64 (zeroed by the
// caller) for the probe.
template <typename T>
int launch(const void* local, const void* freq, const void* voiced, void* records, void* carry, void* bp,
           void* path, void* stamps, int B, int F, int C, int record, int steps, double ojc, double vuc,
           void* stream) {
  if (F < 1 || C < 1 || C > kMaxC || B < 0 || (F > 1 && steps < 1)) return static_cast<int>(cudaErrorInvalidValue);
  const Config c = config_for(C, sizeof(T));
  if (c.stages < 1 || record != c.record) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  for (int t0 = 1;; t0 += steps) {
    const int t1 = F - t0 < steps ? F : t0 + steps;
    const long costs = static_cast<long>(B) * (t1 - t0) * C * c.lanes * c.pitch;
    if (costs > 0) {
      viterbi_costs<T><<<vt::blocks_for(costs, kCostThreads), kCostThreads, 0, s>>>(
          static_cast<const T*>(local), static_cast<const T*>(freq), static_cast<const unsigned char*>(voiced),
          static_cast<unsigned char*>(records), B, F, C, c.lanes, c.run, c.pitch, c.record, t0, t1 - t0,
          static_cast<T>(ojc), static_cast<T>(vuc));
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int err = stamps != nullptr
                        ? launch_chain<T, true>(local, records, carry, bp, path, stamps, B, F, C, t0, t1, c, s)
                        : launch_chain<T, false>(local, records, carry, bp, path, stamps, B, F, C, t0, t1, c, s);
    if (err != 0 || t1 == F) return err;
  }
}

}  // namespace

VT_EXPORT int vt_viterbi_f32(const void* local, const void* freq, const void* voiced, void* records, void* carry,
                             void* bp, void* path, void* stamps, int B, int F, int C, int record, int steps,
                             double ojc, double vuc, void* stream) {
  return launch<float>(local, freq, voiced, records, carry, bp, path, stamps, B, F, C, record, steps, ojc, vuc,
                       stream);
}

VT_EXPORT int vt_viterbi_f64(const void* local, const void* freq, const void* voiced, void* records, void* carry,
                             void* bp, void* path, void* stamps, int B, int F, int C, int record, int steps,
                             double ojc, double vuc, void* stream) {
  return launch<double>(local, freq, voiced, records, carry, bp, path, stamps, B, F, C, record, steps, ojc, vuc,
                        stream);
}
