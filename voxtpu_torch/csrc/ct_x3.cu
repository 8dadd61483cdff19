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
//   stage 1   A[k1, n2]  = sum_n1 W_N1^{n1 k1} x[n1, n2]       (c1, s1)
//   stage 2   B[k1, n2]  = A[k1, n2] W_N^{k1 n2}                (the twiddle)
//   stage 3   X[k1, k2]  = sum_n2 B[k1, n2] W_128^{n2 k2}       (c2, s2)
//   power     P[k1, k2]  = |X|^2; half[j] = P[k1, k2] for even k1,
//                          j = k2 N1/2 + k1/2 <= n/2
//   inverse   Ca^T, Sa^T = c2 @ P^T, -s2 @ P^T  [l1, k1]        (cos, sin(2 pi k2 l1 / 128))
//             U + iV     = (Ca + i Sa) e^{2 pi i k1 l1 / N}
//             ac[l]      = (1/N) sum_k1 cc[k1, l2] U - sc[k1, l2] V   (cc, sc: 2 pi k1 l2 / N1)
// Every product splits both operands into bfloat16 hi = bf16(v) and
// lo = bf16(v - hi) and sums hi.hi + hi.lo + lo.hi in float32. The quirk
// correction stays outside (voxtpu_torch.autocorr).
//
// What bounds it: the products. At n = 4096 they are about 44 MFLOP a
// frame on the tensor cores (three passes of 14.7), 0.68 ms for the bench
// path's 15,369 frames at the H100's 989 TFLOP/s of dense bfloat16,
// against 0.19 ms to read the frames and write both outputs at 3.35 TB/s.
//
// Design: one persistent block an SM, walking frames blockIdx.x,
// blockIdx.x + gridDim.x, ... in tiles of 64 k1 rows (one tile for
// n <= 4096, up to 6 at 20,608), with two warpgroups one tile apart: the
// front one runs stage 1, the twiddle, stage 3 and the power and writes
// the half spectrum; the back one runs the inverse and writes the lags. The
// power of a tile passes between them through shared memory (two
// mbarriers, written and read), so one's CUDA-core work (splits, twiddles,
// stores) overlaps the other's products.
// - Every product is a wgmma.mma_async (m64nNk16, bfloat16 in, float32
//   accumulators in registers). Its shared-memory operands are bfloat16
//   images in the no-swizzle K-major layout: 8 x 8 core matrices of 128
//   contiguous bytes, K-neighbours 128 bytes apart, 8-row groups SBO bytes
//   apart.
// - Where the tables live: the hi and lo parts of c2 and s2 (cos and sin
//   of -2 pi r c / 128), 128 KB, in shared memory for the block's whole
//   life, copied once. The inverse's cos and sin tables (ca, sa) equal c2
//   and -s2 (both symmetric), so the same images serve stage 3 as its right
//   operand and the inverse as its left one, and the minus signs are the
//   instruction's scale of -1 on its left operand: no ca, sa or negated s2
//   is kept. Stage 1's c1, s1 and the last product's cc, sc grow with n
//   (1.1 MB in this layout at 20,608) and do not fit beside them: each
//   tile reads its c1, s1 fragments from device memory (16 KB a tile at
//   n = 4096, through L1), and cc, sc come in pieces of 32 lag rows
//   through two stages. One design serves every n: a build that also kept
//   c1, s1, cc and sc resident up to n = 4096 (one tile) ran no faster
//   there on an H100 than this one by more than either varied from run to
//   run. The twiddles are products of two small float32 tables, E(8ab)
//   and E(am) with E(p) = e^{2 pi i p / N} (the inverse's e^{2 pi i k1 l1
//   / N} is the forward twiddle conjugated, so one pair serves both), read
//   through L1.
// - The frame arrives by bulk copy (cp.async.bulk onto an mbarrier), 16
//   rows of 128 samples a chunk, through a ring of four stages that runs
//   ahead across tiles and frames: the front's thread 0 refills a stage as
//   soon as the products that read it are done (a separate producer warp
//   would cost the warpgroups registers: setmaxnreg counts whole
//   warpgroups). The front splits each chunk in place into its bfloat16
//   image, stage 1's right operand.
// - Each value is split once. Stage 1's accumulators (rows k1, columns n2)
//   take the twiddle in registers and are split there into the left-operand
//   fragments of stage 3 (the accumulator's layout is the fragment's).
//   Stage 3 runs in two halves of 64 k2 columns. The power goes to shared
//   memory once, split: the inverse contracts k2, so P is its right
//   operand, and this transposes the chain at the cost of one tile (32 KB)
//   where U and V would take two. The inverse's accumulators (rows l1,
//   columns k1) take the twiddle in registers and are split into the
//   fragments of the last product, which contracts k1 against cc and sc
//   and leaves the lags transposed (rows l1, columns l2) in registers.
// - Several tiles (n > 4096): the lags of a tile are added to those of the
//   tiles before it through the output itself (loaded and stored by the
//   thread that owns them), and the frame's chunks are read once a tile and
//   split again.
// - The half spectrum and the lags are stored from registers: a shuffle
//   gives each lane an even k1 row, so a warp's stores fill 32-byte
//   sectors.
// Built --fmad=false like the rest of the library (the products themselves
// are tensor-core operations either way): held to a tolerance against the
// plain version and the float64 transform, not to bits.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kN2 = 128;
constexpr int kTile = 64;        // k1 rows a tile: one wgmma's M
constexpr int kPiece = 32;       // lag rows (l2) a piece of the last product: its wgmma's N
constexpr int kCols = 64;        // k2 columns a stage-3 product: its wgmma's N (mma_rs_n64)
constexpr int kChunk = 16;       // rows of x a chunk: stage 1's K
constexpr int kStages = 4;       // chunks of x in flight
constexpr int kGroup = 128;      // threads a warpgroup
constexpr int kThreads = 2 * kGroup;  // the front and back warpgroups
constexpr int kMaxN = 20608;     // the largest frame voxtpu's gate admits (ops/ct_x3.py)

// Shared memory, in bytes: the c2, s2 images (hi, lo), the power's image
// (hi, lo), the ring of x chunks, two stages of cc, sc pieces, the
// mbarriers.
constexpr int kTableBytes = kN2 * kN2 * 2;            // one 128 x 128 bfloat16 image
constexpr int kWBytes = 4 * kTableBytes;
constexpr int kPBytes = 2 * kTile * kN2 * 2;
constexpr int kXBytes = kChunk * kN2 * 4;
constexpr int kCCBytes = 4 * kPiece * kTile * 2;
constexpr int kBars = kStages + 2 + 3;
constexpr int kSmem = kWBytes + kPBytes + kStages * kXBytes + 2 * kCCBytes + 8 * kBars;

struct Shape {
  int n, rows, N1, tiles, chunks, pieces;
  int a8, b8;  // rows and columns of the E(8ab) table (rows of E(am), too)
};

__host__ __device__ inline Shape shape_of(int n) {
  Shape s;
  s.n = n;
  s.rows = n / kN2;
  s.N1 = 2 * s.rows;
  s.tiles = (s.N1 + kTile - 1) / kTile;
  s.chunks = (s.rows + kChunk - 1) / kChunk;
  s.pieces = (s.rows + kPiece - 1) / kPiece;
  s.a8 = s.tiles * kTile > kN2 ? s.tiles * kTile : kN2;
  s.b8 = s.tiles * 8 > 16 ? s.tiles * 8 : 16;
  return s;
}

// Offsets into the wrapper's tables (ops/ct_x3.py::_device_tables): in the
// bfloat16 buffer, in 16-bit words, the c2, s2 images, then c1, s1's
// fragments (tiles x chunks x 4 parts x 128 threads x 8), then the cc, sc
// pieces (tiles x pieces x 4 parts x 32 x 64); in the float32 buffer, in
// complex values, E(8ab) (a8 x b8), then E(am) (a8 x 8).
__host__ __device__ inline long c1_offset() { return 4L * kN2 * kN2; }
__host__ __device__ inline long cc_offset(const Shape& s) {
  return c1_offset() + static_cast<long>(s.tiles) * s.chunks * 4 * kGroup * 8;
}
__host__ __device__ inline long em_offset(const Shape& s) { return static_cast<long>(s.a8) * s.b8; }

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

// Arms `bar` for `bytes` and copies them from device memory into shared
// memory, in the threads where `pred` holds: predicated, not branched, so
// that the warpgroup's products around it stay unserialised (ptxas
// serialises wgmma around a path taken by some of a warpgroup's threads).
__device__ __forceinline__ void bulk_copy_if(bool pred, void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n}" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar)), "r"(static_cast<int>(pred))
      : "memory");
}

// Each warpgroup's own barrier (named barriers 1 and 2).
__device__ __forceinline__ void front_sync() { asm volatile("bar.sync 1, %0;" ::"n"(kGroup) : "memory"); }
__device__ __forceinline__ void back_sync() { asm volatile("bar.sync 2, %0;" ::"n"(kGroup) : "memory"); }

// Makes the threads' shared-memory stores visible to the tensor cores'
// operand reads (the async proxy).
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Ties registers to this point: the compiler neither reads an accumulator
// before the wait nor reuses an operand register while a product that
// reads it may still run.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A shared-memory operand's descriptor: no swizzle, K-major, `sbo` bytes
// between 8-row groups and 128 between K-neighbouring core matrices.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// (hi, lo) of the pair (v0, v1): hi = bf16(v), lo = bf16(v - hi), the
// lower index in the low half.
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// c = a b (complex), with fused multiply-adds (asked for: the library is
// built --fmad=false).
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -a.y * b.y), __fmaf_rn(a.x, b.y, a.y * b.x));
}

// v as a value the compiler cannot see through: what is computed from it
// stays where it is used, instead of being hoisted out of the frame loop
// and held in registers across it (the descriptors and the twiddle
// factors are the same for every frame).
template <typename T>
__device__ __forceinline__ T fresh(T v) {
  if constexpr (sizeof(T) == 8) {
    asm volatile("" : "+l"(v));
  } else {
    asm volatile("" : "+r"(v));
  }
  return v;
}

// Split the accumulator d (rows r, columns c of an m64nNk16 result) into
// the left-operand fragments of a product contracting c: fragment k holds
// columns 16k .. 16k + 15, whose four registers are d's pairs 8k + {0, 2,
// 4, 6} (rows g, g + 8 of columns 16k + 2t and 16k + 8 + 2t).
template <int K>
__device__ __forceinline__ void fragments(const float (&d)[8 * K], uint32_t (&hi)[K][4], uint32_t (&lo)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) split(d[8 * k + 2 * r], d[8 * k + 2 * r + 1], hi[k][r], lo[k][r]);
}

// The products: d (N/2 floats a thread) += kScaleA A B, m64nNk16,
// bfloat16 in, float32 accumulators. A from registers (rs) or through its
// descriptor (ss); B through its descriptor. Callers zero d before its
// first product: d is read and written ("+f"), so an unset d would carry
// the previous tile's values, and hold their registers, around the frame
// loop. (scale-d, a predicate operand, is always set: d accumulates.)
template <int kScaleA>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, %70, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kScaleA));
}

template <int kScaleA>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, %38, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kScaleA));
}

template <int kScaleA>
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, %22, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kScaleA));
}

template <int kScaleA>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, %35, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(kScaleA));
}

template <int K>
__device__ __forceinline__ void hold(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) hold(r[k]);
}

__device__ __forceinline__ void load_fragment(uint32_t (&r)[4], const uint4* p) {
  const uint4 v = __ldg(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

// The block's shared memory: the c2, s2 images (hi, lo); the power of one
// tile, hi and lo (rows k1, K = k2); the ring of x chunks (float32, then
// their image); two stages of cc, sc pieces; the mbarriers.
struct Smem {
  unsigned char *W, *P, *X, *CC;
  uint64_t* full_x;            // a chunk of x arrived
  uint64_t* full_cc;           // a cc piece arrived
  uint64_t* tables;            // the tables copied once arrived
  uint64_t *p_full, *p_empty;  // the power of a tile written / read
};

__device__ __forceinline__ Smem smem_of(unsigned char* base) {
  Smem m;
  m.W = base;
  m.P = m.W + kWBytes;
  m.X = m.P + kPBytes;
  m.CC = m.X + kStages * kXBytes;
  m.full_x = reinterpret_cast<uint64_t*>(m.CC + 2 * kCCBytes);
  m.full_cc = m.full_x + kStages;
  m.tables = m.full_cc + 2;
  m.p_full = m.tables + 1;
  m.p_empty = m.p_full + 1;
  return m;
}

// In the thread where `pred` holds, copies item i of the block's chunks of
// x (frame, tile, chunk, in the order the front warpgroup takes them) into
// stage i mod kStages; nothing past the block's last frame.
__device__ __forceinline__ void load_chunk(bool pred, const Smem& m, const float* x, const Shape& s, int B, int i) {
  const int per = s.tiles * s.chunks;
  const long f = blockIdx.x + static_cast<long>(i / per) * gridDim.x;
  const int c = i % per % s.chunks, st = i % kStages;
  const uint32_t bytes = min(kChunk, s.rows - c * kChunk) * kN2 * 4;
  bulk_copy_if(pred && f < B, m.X + st * kXBytes, x + f * s.n + c * kChunk * kN2, bytes, &m.full_x[st]);
}

// The same for item j of the block's cc pieces (frame, tile,
// piece, in the order the back warpgroup takes them) into stage j mod 2.
__device__ __forceinline__ void load_piece(bool pred, const Smem& m, const uint16_t* bf, const Shape& s, int B,
                                           int j) {
  const int per = s.tiles * s.pieces;
  const long f = blockIdx.x + static_cast<long>(j / per) * gridDim.x;
  const uint16_t* const src = bf + cc_offset(s) + static_cast<long>(j % per) * (kCCBytes / 2);
  bulk_copy_if(pred && f < B, m.CC + (j & 1) * kCCBytes, src, kCCBytes, &m.full_cc[j & 1]);
}

// The front warpgroup, for each tile of each frame: stage 1 chunk by
// chunk, the twiddle, stage 3 and the power; it writes the half spectrum
// and, once the back warpgroup has read the last one, P's image.
__device__ __forceinline__ void front(const Smem& m, const float* x, const uint16_t* bf, const float2* tw,
                                      float* half, int B, int n) {
  const Shape s = shape_of(n);
  const float2* const em = tw + em_offset(s);
  const uint4* const c1 = reinterpret_cast<const uint4*>(bf + c1_offset());
  const uint32_t sW = smem_addr(m.W), sX = smem_addr(m.X);
  const int nh = n / 2, h1 = s.N1 / 2;
  mbar_wait(m.tables, 0);

  int it = 0, u = 0;
  for (long f = blockIdx.x; f < B; f += gridDim.x) {
    float* const hf = half + f * (nh + 1);
    for (int t = 0; t < s.tiles; ++t, ++u) {
      // The thread's coordinates, anew each tile: what is computed from them
      // (addresses, masks) is not held across the frame loop either.
      const int tid = fresh(static_cast<int>(threadIdx.x)), w = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
      // Stage 1, chunk by chunk: A = (c1 + i s1)[tile] @ x; rows k1, columns n2.
      float ar[64] = {}, ai[64] = {};
      for (int c = 0; c < s.chunks; ++c, ++it) {
        const int st = it % kStages;
        mbar_wait(&m.full_x[st], (it / kStages) & 1);
        float* const xs = reinterpret_cast<float*>(m.X + st * kXBytes);
        const int valid = min(kChunk, s.rows - c * kChunk);
        float v[kChunk];
#pragma unroll
        for (int r = 0; r < kChunk; ++r) v[r] = r < valid ? xs[r * kN2 + tid] : 0.f;
        front_sync();
        // In place, the chunk's image: stage 1's right operand, 128 n2 rows
        // of K = 16 n1 (SBO 256), hi then lo; thread tid holds column n2 = tid.
        uint32_t* const img = reinterpret_cast<uint32_t*>(xs);
#pragma unroll
        for (int r = 0; r < kChunk; r += 2) {
          uint32_t hi, lo;
          split(v[r], v[r + 1], hi, lo);
          const int at = ((r >> 3) * 128 + (tid >> 3) * 256 + (tid & 7) * 16 + (r & 7) * 2) >> 2;
          img[at] = hi;
          img[at + kXBytes / 8] = lo;
        }
        fence_async_shared();
        front_sync();
        const uint4* const frag = fresh(c1) + (static_cast<long>(t) * s.chunks + c) * 4 * kGroup + tid;
        uint32_t ch[4], cl[4], sh[4], sl[4];
        load_fragment(ch, frag);
        load_fragment(cl, frag + kGroup);
        load_fragment(sh, frag + 2 * kGroup);
        load_fragment(sl, frag + 3 * kGroup);
        const uint32_t xa = fresh(sX) + st * kXBytes;
        const uint64_t xh = desc(xa, 256), xl = desc(xa + kXBytes / 2, 256);
        wg_fence();
        mma_rs_n128<1>(ar, ch, xh);
        mma_rs_n128<1>(ar, ch, xl);
        mma_rs_n128<1>(ar, cl, xh);
        mma_rs_n128<1>(ai, sh, xh);
        mma_rs_n128<1>(ai, sh, xl);
        mma_rs_n128<1>(ai, sl, xh);
        wg_commit();
        wg_wait_all();
        hold(ar);
        hold(ai);
        hold(ch);
        hold(cl);
        hold(sh);
        hold(sl);
        front_sync();  // every warp's products have read the stage: refill it
        load_chunk(tid == 0, m, x, s, B, it + kStages);
      }

      // The twiddle, B = A e^{-2 pi i k1 n2 / N} with n2 = 8 j + m:
      // E(8 k1 j) E(k1 m); then B's fragments, stage 3's left operand.
      {
        const float2* const e8 = fresh(tw);
        const float2* const e1 = fresh(em);
        float2 base[2][2];
        int k1[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          k1[h] = t * kTile + 16 * w + g + 8 * h;
          base[h][0] = e1[k1[h] * 8 + 2 * q];
          base[h][1] = e1[k1[h] * 8 + 2 * q + 1];
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 step = e8[static_cast<long>(k1[h]) * s.b8 + j];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float2 wv = cmul(step, base[h][e]);
              const int i = 4 * j + 2 * h + e;
              const float re = __fmaf_rn(ar[i], wv.x, ai[i] * wv.y), im = __fmaf_rn(ai[i], wv.x, -ar[i] * wv.y);
              ar[i] = re;
              ai[i] = im;
            }
          }
        }
      }
      uint32_t brh[8][4], brl[8][4], bih[8][4], bil[8][4];
      fragments<8>(ar, brh, brl);
      fragments<8>(ai, bih, bil);
      hold(brh);
      hold(brl);
      hold(bih);
      hold(bil);

      // Stage 3 and the power, kCols k2 columns at a time:
      // X = (Br + i Bi) @ (c2 + i s2), P = |X|^2 into P's image and the half spectrum.
#pragma unroll 1
      for (int kh = 0; kh < kN2 / kCols; ++kh) {
        float xr[kCols / 2] = {}, xi[kCols / 2] = {};
        wg_fence();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t o = fresh(sW) + kh * (kCols / 8) * 2048 + k * 256;
          const uint64_t c2h = desc(o, 2048), c2l = desc(o + kTableBytes, 2048), s2h = desc(o + 2 * kTableBytes, 2048),
                         s2l = desc(o + 3 * kTableBytes, 2048);
          mma_rs_n64<1>(xr, brh[k], c2h);
          mma_rs_n64<1>(xr, brh[k], c2l);
          mma_rs_n64<1>(xr, brl[k], c2h);
          mma_rs_n64<-1>(xr, bih[k], s2h);
          mma_rs_n64<-1>(xr, bih[k], s2l);
          mma_rs_n64<-1>(xr, bil[k], s2h);
          mma_rs_n64<1>(xi, brh[k], s2h);
          mma_rs_n64<1>(xi, brh[k], s2l);
          mma_rs_n64<1>(xi, brl[k], s2h);
          mma_rs_n64<1>(xi, bih[k], c2h);
          mma_rs_n64<1>(xi, bih[k], c2l);
          mma_rs_n64<1>(xi, bil[k], c2h);
        }
        wg_commit();
        wg_wait_all();
        hold(xr);
        hold(xi);
        hold(brh);
        hold(brl);
        hold(bih);
        hold(bil);
        if (kh == 0) mbar_wait(m.p_empty, (u & 1) ^ 1);  // the back warpgroup has read the last tile's power
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          float p[2][2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              p[h][e] = xr[i] * xr[i] + xi[i] * xi[i];
            }
          const int k2 = kCols * kh + 8 * j + 2 * q;
          // P's image: the inverse's right operand, 64 k1 rows of K = 128 k2 (SBO 2048).
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t hi, lo;
            split(p[h][0], p[h][1], hi, lo);
            const int at = (k2 >> 3) * 128 + (2 * w + h) * 2048 + g * 16 + q * 4;
            *reinterpret_cast<uint32_t*>(m.P + at) = hi;
            *reinterpret_cast<uint32_t*>(m.P + kPBytes / 2 + at) = lo;
          }
          // The half spectrum, from the even k1 rows: a lane of odd g takes
          // row g + 7 (its even neighbour's row g - 1 + 8), so the lanes of
          // a column hold 8 neighbouring even rows.
          const float o0 = __shfl_xor_sync(0xffffffffu, p[1][0], 4);
          const float o1 = __shfl_xor_sync(0xffffffffu, p[1][1], 4);
          const bool odd = g & 1;
          const int row = t * kTile + 16 * w + (odd ? g + 7 : g);
          if (row < s.N1) {
            const int at = k2 * h1 + (row >> 1);
            if (at <= nh) hf[at] = odd ? o0 : p[0][0];
            if (at + h1 <= nh) hf[at + h1] = odd ? o1 : p[0][1];
          }
        }
      }
      fence_async_shared();
      mbar_arrive(m.p_full);
    }
  }
}

// The back warpgroup, for each tile of each frame once its power is
// written: the inverse's first products, U and V, and the last product
// into the lags.
__device__ __forceinline__ void back(const Smem& m, const uint16_t* bf, const float2* tw, float* ac, int B,
                                     int n) {
  const Shape s = shape_of(n);
  const float2* const em = tw + em_offset(s);
  const uint32_t sW = smem_addr(m.W), sP = smem_addr(m.P), sCC = smem_addr(m.CC);
  const float inv_N = 1.0f / static_cast<float>(2 * n);
  mbar_wait(m.tables, 0);

  int u = 0, jt = 0;
  for (long f = blockIdx.x; f < B; f += gridDim.x) {
    float* const af = ac + f * n;
    for (int t = 0; t < s.tiles; ++t, ++u) {
      const int tid = fresh(static_cast<int>(threadIdx.x) - kGroup), w = tid >> 5, g = (tid & 31) >> 2,
                q = tid & 3;
      mbar_wait(m.p_full, u & 1);
      // The inverse's first products, Ca^T = c2 @ P^T and Sa^T = -s2 @ P^T
      // (rows l1, columns k1), for each half of l1; U + iV = (Ca + i Sa)
      // e^{2 pi i k1 l1 / N}, k1 = 8 j + m; U's and V's fragments.
      uint32_t uh[2][4][4], ul[2][4][4], vh[2][4][4], vl[2][4][4];
#pragma unroll
      for (int lh = 0; lh < 2; ++lh) {
        float ca[32] = {}, sa[32] = {};
        wg_fence();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t o = fresh(sW) + lh * (kTableBytes / 2) + k * 256, po = fresh(sP) + k * 256;
          const uint64_t c2h = desc(o, 2048), c2l = desc(o + kTableBytes, 2048), s2h = desc(o + 2 * kTableBytes, 2048),
                         s2l = desc(o + 3 * kTableBytes, 2048);
          const uint64_t ph = desc(po, 2048), pl = desc(po + kPBytes / 2, 2048);
          mma_ss_n64<1>(ca, c2h, ph);
          mma_ss_n64<1>(ca, c2h, pl);
          mma_ss_n64<1>(ca, c2l, ph);
          mma_ss_n64<-1>(sa, s2h, ph);
          mma_ss_n64<-1>(sa, s2h, pl);
          mma_ss_n64<-1>(sa, s2l, ph);
        }
        wg_commit();
        wg_wait_all();
        hold(ca);
        hold(sa);
        if (lh == 1) mbar_arrive(m.p_empty);  // P read: the front warpgroup may write the next
        const float2* const e8 = fresh(tw);
        const float2* const e1 = fresh(em);
        float2 base[2][2];
        int l1[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l1[h] = 64 * lh + 16 * w + g + 8 * h;
          base[h][0] = e1[l1[h] * 8 + 2 * q];
          base[h][1] = e1[l1[h] * 8 + 2 * q + 1];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 step = e8[static_cast<long>(l1[h]) * s.b8 + 8 * t + j];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float2 wv = cmul(step, base[h][e]);
              const int i = 4 * j + 2 * h + e;
              const float uu = __fmaf_rn(ca[i], wv.x, -sa[i] * wv.y), vv = __fmaf_rn(ca[i], wv.y, sa[i] * wv.x);
              ca[i] = uu;
              sa[i] = vv;
            }
          }
        }
        fragments<4>(ca, uh[lh], ul[lh]);
        fragments<4>(sa, vh[lh], vl[lh]);
        hold(uh[lh]);
        hold(ul[lh]);
        hold(vh[lh]);
        hold(vl[lh]);
      }

      // The last product, a piece of 32 lag rows at a time:
      // ac^T[l1, l2] += U^T @ cc - V^T @ sc over the tile's k1.
      for (int p = 0; p < s.pieces; ++p, ++jt) {
        const int st = jt & 1;
        mbar_wait(&m.full_cc[st], (jt >> 1) & 1);
        const uint32_t cc = sCC + st * kCCBytes;
        const bool carry = t > 0;
#pragma unroll
        for (int lh = 0; lh < 2; ++lh) {
          const int l1 = 64 * lh + 16 * w + g;
          float d[16] = {};
          if (carry) {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int l2 = kPiece * p + 8 * (i >> 2) + 2 * q + (i & 1);
              d[i] = l2 < s.rows ? af[l2 * kN2 + l1 + 8 * ((i >> 1) & 1)] : 0.f;
            }
          }
          wg_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t o = fresh(cc) + k * 256;
            const uint64_t ch = desc(o, 1024), cl = desc(o + kCCBytes / 4, 1024), sh = desc(o + kCCBytes / 2, 1024),
                           sl = desc(o + 3 * (kCCBytes / 4), 1024);
            mma_rs_n32<1>(d, uh[lh][k], ch);
            mma_rs_n32<1>(d, uh[lh][k], cl);
            mma_rs_n32<1>(d, ul[lh][k], ch);
            mma_rs_n32<-1>(d, vh[lh][k], sh);
            mma_rs_n32<-1>(d, vh[lh][k], sl);
            mma_rs_n32<-1>(d, vl[lh][k], sh);
          }
          wg_commit();
          wg_wait_all();
          hold(d);
          hold(uh[lh]);
          hold(ul[lh]);
          hold(vh[lh]);
          hold(vl[lh]);
          const float scale = t == s.tiles - 1 ? inv_N : 1.0f;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int l2 = kPiece * p + 8 * (i >> 2) + 2 * q + (i & 1);
            if (l2 < s.rows) af[l2 * kN2 + l1 + 8 * ((i >> 1) & 1)] = d[i] * scale;
          }
        }
        back_sync();  // every warp's products have read the piece: refill its stage
        load_piece(tid == 0, m, bf, s, B, jt + 2);
      }
    }
  }
}

// One block an SM, frames blockIdx.x, blockIdx.x + gridDim.x, ...: warps
// 0-3 the front warpgroup, warps 4-7 the back one, 255 registers a thread
// each. The two run one tile apart, handing the power over through P's
// image, so that one's CUDA-core work (splits, twiddles, stores) overlaps
// the other's products. The front's thread 0 copies the tables and the
// first kStages chunks of x, then refills each stage as the front frees it;
// the back's thread 0 does the same for the cc pieces.
__global__ void __launch_bounds__(kThreads, 1)
    ct_x3_kernel(const float* __restrict__ x, const uint16_t* __restrict__ bf, const float2* __restrict__ tw,
                 float* __restrict__ half, float* __restrict__ ac, int B, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem m = smem_of(smem);
  if (threadIdx.x == 0) {
    const Shape s = shape_of(n);
    for (int i = 0; i < kStages; ++i) mbar_init(&m.full_x[i], 1);
    for (int i = 0; i < 2; ++i) mbar_init(&m.full_cc[i], 1);
    mbar_init(m.tables, 1);
    mbar_init(m.p_full, kGroup);
    mbar_init(m.p_empty, kGroup);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(m.tables, kWBytes);
    for (int q = 0; q < 4; ++q) bulk_copy(m.W + q * kTableBytes, bf + q * kN2 * kN2, kTableBytes, m.tables);
    for (int i = 0; i < kStages; ++i) load_chunk(true, m, x, s, B, i);
    for (int j = 0; j < 2; ++j) load_piece(true, m, bf, s, B, j);
  }
  __syncthreads();
  // The warpgroup's index, broadcast from lane 0 so that ptxas sees the
  // branch as uniform (it serialises wgmma on a path it takes as divergent).
  if (__shfl_sync(0xffffffffu, threadIdx.x / kGroup, 0) == 0) {
    front(m, x, bf, tw, half, B, n);
  } else {
    back(m, bf, tw, ac, B, n);
  }
}

int launch(const void* x, const void* bf, const void* tw, void* half, void* ac, int B, int n, void* stream) {
  // voxtpu's gate (ops/ct_x3.py::ct_x3_supported) keeps n within kMaxN.
  if (n < kN2 || n % kN2 != 0 || n > kMaxN || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ct_x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ct_x3_kernel<<<B < sms ? B : sms, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const uint16_t*>(bf), static_cast<const float2*>(tw),
        static_cast<float*>(half), static_cast<float*>(ac), B, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VT_EXPORT int vt_ct_x3_f32(const void* x, const void* bf, const void* tw, void* half, void* ac, int B, int n,
                           void* stream) {
  return launch(x, bf, tw, half, ac, B, n, stream);
}
