// Kernels B5 (bf16 mode and f32 mode: q4_0 and q4_1) and B3 (int8): the
// prefill matmuls on one persistent, warp-specialized kernel for Hopper,
// the weight converted once for up to 256 rows of x. q4_prefill.cu builds
// B5's four modes, q4_int8.cu B3.
//
// B5 replaces fastllama_tpu/kernels/q4_matmul.py::q4_matmul_prefill_pallas
// (variant nat, _q4mm_prefill_nat_kernel), and B3 ::q4_matmul_prefill_int8
// (nat; natp maps here; _q4mm_prefill_int8_strip_kernel), with
//   B5  y[M, n_out] f32 = R(x) @ R(W),  W = (q - 8) d (q4_0) or q d + m
//       (q4_1), each weight rounded once in f32 as dequant_matmul_weight
//       makes it, then to bf16; products exact, f32 sums;
//   B3  s8[n] = max(max_kb |d| * 8/127, 1e-20) over the whole K,
//       w8 = rne((q - 8) (d (1 / s8))), acc = xq @ w8 exact in int32,
//       y = (float(acc) dx[m]) s8[n]       (q4_matmul_int8_xla's function)
// from the planes as stored: qs uint8 [K/2, N] (byte (16 kb + j, n) holds
// element 32 kb + j in its low nibble and 32 kb + 16 + j in its high one),
// scales (and mins) f32 [K/32, N]; x as the cast pass's bf16 [M, K] plane
// (B5) or B2's int8 [M, K] plane and row scales dx (B3).
//
// Bound on the H100: operations at the prefill's M (2 M N K against about
// 0.6 bytes of weight an element: far above the ridge at M >= 256), the
// weight bytes below M ~ 64-128. The designs before this one lost to one
// library call by up to 2.7x (PERF.md): B5 wrote each converted bf16
// weight tile to shared memory and read it back from two warpgroups (about
// 90 KB of shared-memory traffic a 64-deep stage of a 128 x 128 tile, more
// than the tensor cores' 512 clocks of work let through), and B3 wrote the
// whole [N, K] int8 plane to HBM in a pass of its own and read it back.
// Here the weight is wgmma's A operand and x its B operand, y^T = W^T x^T
// tile by tile, so one conversion serves every row of an x tile:
//   * Persistent blocks, one an SM, walk the work items (Item): a row tile
//     of BX rows of x (a multiple of 32 up to 256, a template parameter:
//     the wgmma's N; M = 300 runs as two tiles of 160 rows), a column tile
//     of 64 wgs weight columns, and a run of K: the tiles before t0 whole,
//     the rest (the plan's tail past its full rounds, or all of them) split
//     in `splits` runs. The row tile is the fastest, so that the blocks at
//     work together share each column tile's weights in L2.
//   * One producer thread keeps a ring of stages in flight with TMA: the x
//     tile [BX rows][128 bytes of K] with the 128-byte swizzle (K-major, as
//     wgmma reads a B operand), the column tile's packed q4 rows of the
//     stage's q blocks exactly as stored (boxes of 64 wgs bytes, swizzled
//     by the copy: 16-byte chunk ^ row % 8, or ^ row / 2 % 4 for 64-byte
//     rows), its scale rows and (q4_1) its mins rows; zeros past M, N and
//     K. A stage holds 64 of K (two q blocks) in bf16 mode and 128 (four)
//     in int8 mode: 128 bytes of each x row either way.
//   * wgs (1 or 2) consumer warpgroups of 64 weight columns (body_rs).
//     Lane (g, t) of warp w owns columns c0 = 64 wg + 16 w + 2 g and
//     c0 + 1, rows g and g + 8 of its warp's 16 in wgmma's A fragment,
//     reads their two bytes of the packed rows its fragment needs (B5:
//     2t, 2t + 1, 2t + 8, 2t + 9, a q block's two k16 steps in the low
//     then the high nibbles; B3: 4t .. 4t + 3, one k32 step), and makes
//     each weight in registers: the code into the mantissa of 2^23 by one
//     byte permute, less 2^23 + 8 (q - 8, exact); B5 q4_0 times d, rounded
//     once in f32 (the decode fold kernel's variant 0 weight), q4_1
//     R(q d + m) by __fmul_rn and __fadd_rn (no contraction into an FMA),
//     two packed into bf16 by one conversion; B3 times d (1 / s8), plus
//     1.5 * 2^23, which leaves rne of the product in the low byte
//     (requant_magic), four bytes packed by byte permutes. Then
//     wgmma.mma_async m64nBXk16 f32 += bf16 x bf16 (B3: m64nBXk32 s32 +=
//     s8 x s8) with A from those registers and B, the x tile, from shared
//     memory. No converted weight passes through shared memory or HBM.
//     Each k step is one commit group with its own set of A registers;
//     kInFlight groups stay in flight while the next set is made, and
//     nothing between the issues is a branch or a register the wgmma
//     reads (hopper::keep_regs, mbar_arrive_if): ptxas otherwise
//     serializes the wgmmas (C7513 in the -Xptxas -v log).
//   * B3's other design, requantizer warps writing an int8 A tile into
//     shared memory once an x tile and wgmma with both operands from there,
//     ran 1.3-1.5x the register route's time on the 7B planes (PERF.md):
//     its three requantizer warps set the pace.
//   * B3's s8 comes from the whole K before an item's first stage (a max
//     of |d| over the column's scale strip, exact in any order), then
//     __fdiv_rn(1, s8) as the plain version's division.
//   * Where the plan splits K, each split stores its partial tile to
//     global scratch (16-byte stores) and the last to finish, elected by a
//     per-tile counter it resets, sums the partials in split order
//     (deterministic; no atomic adds on y; B3's int32 sums exact).
//   * The epilogue stores the transposed tile: register 4j + c (+ 2) of a
//     lane is x row 8j + 2t + c, columns c0 (and c0 + 1), a float2 store;
//     B3 in the plain version's order (float(acc) dx[m]) s8[n]. Rows past
//     M and columns past n_out are cut.
// f32 mode (B5 at w_dtype float32, and B20's f32 route; body_f32):
//   B5  y[M, n_out] f32 = x @ W, W = (q - 8) d (q4_0) or q d + m (q4_1),
//       nothing rounded to bf16
// The tensor cores have no f32 product, but an f32 x is the exact sum of
// three bf16 parts (fltorch::f32_parts: its upper 16 bits, those of the
// rest, and the rest of that; exact for |x| >= 2^-110), and a code (q - 8,
// or q) is an exact bf16 integer. So the cast pass writes x's three parts
// as three bf16 planes [3][M][K] (and, for q4_1, the f32 block sums
// bsum(x) [K/32][M] of the unrounded x); a stage copies the three parts'
// x tiles by one 4-D tensor copy; the A registers hold the codes alone;
// each q block's two k16 steps run once a part, six wgmmas into a fresh
// set z (scale-d 0 on the first), whose products are exact and whose sums
// are f32; then acc = fma(z, d, acc) on the CUDA cores, one FMA an
// accumulator a q block, and for q4_1 acc += bsum m (the mins term, its
// block sums staged with the stage). z and acc are two register sets of
// BX / 2 (BX registers between them), so f32 mode is built at BX 64, 96
// and 128 only (at 256 the two sets alone would pass the consumers' 232
// registers; 160-224 were not tried). Block b - 1's z is waited for and
// scaled after block b's A registers are made, before block b's issue
// (one z set: the other warpgroup's products fill the tensor cores
// meanwhile). The
// result differs from the plain version's x @ W only in the order of f32
// sums and in the skipped rounding of each (q - 8) d (or q d + m).
// Registers: ptxas gives a block of 288 threads (two consumer warpgroups
// and a producer warp) 168 a thread, and spilled at BX >= 160 (BX 256:
// 128 accumulators, the A sets, the addressing). So the producer is a whole
// warpgroup that gives its registers up (setmaxnreg.dec to 40) to the
// consumers (setmaxnreg.inc to 232).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

// Internal linkage (an anonymous namespace around ra), so that two
// libraries built from one source (tools_torch/prefill_sweep.py's variant
// builds) never bind each other's symbols.
namespace {
namespace ra {

using hopper::fence_regs;
using hopper::keep_regs;
using hopper::mbar_arrive;
using hopper::mbar_arrive_if;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load_2d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

// The functions: B5 q4_0 and q4_1 (bf16), B3 (int8), B5 q4_0 and q4_1
// (f32).
enum Mode { kNat = 0, kAffine = 1, kInt8 = 2, kF32 = 3, kF32A = 4 };
__host__ __device__ constexpr bool f32m(int mode) {
  return mode == kF32 || mode == kF32A;
}
// the modes that stage a mins plane (q4_1)
__host__ __device__ constexpr bool minsm(int mode) {
  return mode == kAffine || mode == kF32A;
}

constexpr int kMaxThreads = 3 * 128;        // two consumer warpgroups and
                                            // the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// the dynamic shared memory of a launch: the card's maximum a block
// (232,448 bytes on the H100) less the static shared memory (the split
// flag, 1 KB kept); one block an SM
constexpr int kSmemBytes = 231424;
constexpr int kMaxStages = 8;

// q blocks a stage (128 bytes of each x row)
__host__ __device__ constexpr int stage_qb(int mode) {
  return mode == kInt8 ? 4 : 2;
}
// commit groups a stage, one wgmma each (B5: a k16 step, B3: a q block's
// k32 step), each with its own set of 4 A registers; kInFlight of them
// stay in flight while the next set is made (1 and 3 ran within 3% of 2,
// PERF.md)
constexpr int kGroups = 4;
constexpr int kInFlight = 2;
// tools_torch/prefill_sweep.py's ablations (wrong results, timed only):
// FLTORCH_RA_ABLATE=1 puts the raw nibble words into the A registers (no
// conversion), 2 issues no wgmma (no products)
#ifndef FLTORCH_RA_ABLATE
#define FLTORCH_RA_ABLATE 0
#endif
static_assert(kInFlight >= 1 && kInFlight < kGroups, "groups in flight");

// A stage's bytes (1024-aligned: the swizzle's period, which the
// descriptors and the tensor copies assume) and the ring's depth, for BX
// rows of x and wgs consumer warpgroups.
__host__ __device__ inline int stage_bytes(int mode, int bx, int wgs) {
  const int cols = 64 * wgs, qb = stage_qb(mode);
  // the x tile (f32 mode: one a part), the packed rows, the scale (and
  // mins) rows, and f32 q4_1's block sums [qb][BX]
  const int raw = (f32m(mode) ? 3 : 1) * bx * 128 + qb * 16 * cols +
                  qb * cols * 4 * (minsm(mode) ? 2 : 1) +
                  (mode == kF32A ? qb * bx * 4 : 0);
  return (raw + 1023) / 1024 * 1024;
}
__host__ __device__ inline int max_stages(int mode, int bx, int wgs) {
  // less the ring's alignment and three barriers a slot
  const int n = (kSmemBytes - 1024 - 24 * kMaxStages) /
                stage_bytes(mode, bx, wgs);
  return n < kMaxStages ? n : kMaxStages;
}

// What a launch takes besides the tensor maps.
struct Args {
  float* y;
  float* partial;        // BX 64 wgs floats a split item
  int* counters;         // int32 zeros, one a tile (left zeroed)
  const float* dx;       // B3: B2's row scales [M]
  const float* scales;   // B3: the scale plane, for s8
  int M, N, NB;          // rows, stored columns, q blocks of the stored K
  int n_out;
  int wgs;               // consumer warpgroups (1, 2): 64 wgs columns
  int stages;            // ring slots
  int nst;               // stages of the K the product runs over
  int rt, ct;            // row tiles, column tiles
  int t0;                // tiles [0, t0) run whole, the rest split
  int splits, sps;       // K splits of a split tile, stages a split
};

// wgmma.mma_async m64nBXk16 f32 += bf16 x bf16 (MmaBf16) and m64nBXk32
// s32 += s8 x s8 (MmaS8): A (4 registers a thread: the m16n8k16 /
// m16n8k32 fragment of the warp's 16 rows) from registers, B K-major from
// shared memory (descriptor), D in BX / 2 registers a thread.
template <int BX> struct MmaBf16;
template <int BX> struct MmaS8;
template <> struct MmaBf16<64> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct MmaBf16<96> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct MmaBf16<128> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct MmaBf16<160> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct MmaBf16<192> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct MmaBf16<224> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, {%112, %113, %114, %115}, %116, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct MmaBf16<256> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct MmaS8<64> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct MmaS8<96> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct MmaS8<128> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct MmaS8<160> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct MmaS8<192> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct MmaS8<224> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, {%112, %113, %114, %115}, %116, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct MmaS8<256> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};


// The accumulator type of a mode, and four of them.
template <int MODE> struct Acc {
  using T = float;
  using T4 = float4;
};
template <> struct Acc<kInt8> {
  using T = int;
  using T4 = int4;
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The code in byte C of `nib` (0..15 a byte) under 2^23's exponent: the
// f32 value 2^23 + q, exact.
template <int C>
__device__ __forceinline__ float magic(uint32_t nib) {
  return __uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7440 | C));
}

// B5's weight of the code in byte C of `nib`: q4_0 (q - 8) d, q4_1 q d + m,
// each operation rounded in f32 as dequant_matmul_weight's.
template <int MODE, int C>
__device__ __forceinline__ float weight(uint32_t nib, float d, float m) {
  if constexpr (MODE == kAffine)
    return __fadd_rn(__fmul_rn(__fadd_rn(magic<C>(nib), -8388608.f), d), m);
  return __fmul_rn(__fadd_rn(magic<C>(nib), -8388616.f), d);
}

// B3's int8 weight of the code in the byte of `nib` that selector `sel`
// (0x7440 + byte) picks, in the low byte of the result: rne((q - 8) sc),
// |(q - 8) sc| <= 127, by adding 1.5 * 2^23 to the f32 product
// (q4_int8.cu's requant_magic).
__device__ __forceinline__ uint32_t rq_sel(uint32_t nib, uint32_t sel,
                                           float sc) {
  const float v = __fadd_rn(
      __uint_as_float(__byte_perm(nib, 0x4B000000u, sel)), -8388616.f);
  return __float_as_uint(__fadd_rn(__fmul_rn(v, sc), 12582912.f));
}

// The low bytes of four words, in order, as one word.
__device__ __forceinline__ uint32_t low4(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// One k16 step's A registers (the low nibbles' k 0..15 of the q block, or
// the high nibbles' 16..31) from the nibble words of the lane's four packed
// rows 2t, 2t + 1, 2t + 8, 2t + 9: n01 = (row 2t c0, row 2t c1, row 2t + 1
// c0, row 2t + 1 c1) and n23 the same of rows 2t + 8, 2t + 9, masked to
// the low or the high nibbles, with the columns' scales (d0, d1) and mins
// (m0, m1). Column c0 is A row g, c1 row g + 8; the lower k in the lower
// half: a[0] (g, k 2t, 2t + 1), a[1] (g + 8, the same k), a[2] (g, k 2t +
// 8, 2t + 9), a[3] (g + 8, ...).
template <int MODE>
__device__ __forceinline__ void make_a_bf16(uint32_t n01, uint32_t n23,
                                            float d0, float d1, float m0,
                                            float m1, uint32_t* a) {
  a[0] = bits(__floats2bfloat162_rn(weight<MODE, 0>(n01, d0, m0),
                                    weight<MODE, 2>(n01, d0, m0)));
  a[1] = bits(__floats2bfloat162_rn(weight<MODE, 1>(n01, d1, m1),
                                    weight<MODE, 3>(n01, d1, m1)));
  a[2] = bits(__floats2bfloat162_rn(weight<MODE, 0>(n23, d0, m0),
                                    weight<MODE, 2>(n23, d0, m0)));
  a[3] = bits(__floats2bfloat162_rn(weight<MODE, 1>(n23, d1, m1),
                                    weight<MODE, 3>(n23, d1, m1)));
}

// One q block's k32 step of B3 in the A registers, from the nibble words
// of the lane's packed rows 4t .. 4t + 3, nib = (low nibbles of rows 4t,
// 4t + 1 (c0, c1, c0, c1), low of rows 4t + 2, 4t + 3, high of 4t, 4t + 1,
// high of 4t + 2, 4t + 3) and the columns' d * (1 / s8): a[0] column c0
// (A row g), k 4t .. 4t + 3 (the low nibbles of rows 4t .. 4t + 3), a[1]
// column c1 (row g + 8), a[2], a[3] the same of the high nibbles (k 16 +
// 4t ..); the lower k in the lower byte.
__device__ __forceinline__ void make_a_int8(const uint32_t* nib, float d0,
                                            float d1, uint32_t* a) {
  a[0] = low4(rq_sel(nib[0], 0x7440, d0), rq_sel(nib[0], 0x7442, d0),
              rq_sel(nib[1], 0x7440, d0), rq_sel(nib[1], 0x7442, d0));
  a[1] = low4(rq_sel(nib[0], 0x7441, d1), rq_sel(nib[0], 0x7443, d1),
              rq_sel(nib[1], 0x7441, d1), rq_sel(nib[1], 0x7443, d1));
  a[2] = low4(rq_sel(nib[2], 0x7440, d0), rq_sel(nib[2], 0x7442, d0),
              rq_sel(nib[3], 0x7440, d0), rq_sel(nib[3], 0x7442, d0));
  a[3] = low4(rq_sel(nib[2], 0x7441, d1), rq_sel(nib[2], 0x7443, d1),
              rq_sel(nib[3], 0x7441, d1), rq_sel(nib[3], 0x7443, d1));
}

// A work item: tile (row tile fastest, then column tile) and split z, the
// K stages [s0, s1). Items 0 .. t0 - 1 are tiles 0 .. t0 - 1 whole; then
// the tiles t0 .. rt ct - 1 a split at a time (z-major), so that only the
// tiles past the plan's full rounds pay a merge.
struct Item {
  int tile, z, m0, n0, s0, s1;
  bool split;
  __device__ Item(int w, int bx, const Args& a) {
    const int rest = a.rt * a.ct - a.t0;
    split = w >= a.t0 && a.splits > 1;
    if (w < a.t0) {
      tile = w;
      z = 0;
    } else {
      tile = a.t0 + (w - a.t0) % rest;
      z = (w - a.t0) / rest;
    }
    m0 = (tile % a.rt) * bx;
    n0 = (tile / a.rt) * 64 * a.wgs;
    s0 = w < a.t0 ? 0 : z * a.sps;
    s1 = w < a.t0 ? a.nst : min(a.nst, s0 + a.sps);
  }
};

__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// s8 of a lane's two columns n, n + 1 from their whole-K scale strips:
// lane t4 of the four that share them every fourth q block from t4, then
// the four lanes' maxima (a max is exact in any order); s8 = max(mx *
// 8/127, 1e-20), as the plain version computes it.
__device__ __forceinline__ void column_s8(const Args& a, int n, int t4,
                                          float* s8) {
  float mx0 = 0.f, mx1 = 0.f;
  if (n < a.N) {
#pragma unroll 4
    for (int kb = t4; kb < a.NB; kb += 4) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(
          a.scales + (size_t)kb * a.N + n));
      mx0 = fmaxf(mx0, fabsf(v.x));
      mx1 = fmaxf(mx1, fabsf(v.y));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  s8[0] = fmaxf(mx0 * (float)(8.0 / 127.0), (float)1e-20);
  s8[1] = fmaxf(mx1 * (float)(8.0 / 127.0), (float)1e-20);
}

// An item's end for the consumers: where its tile is split, store the
// partial and, if this block is the last of the tile's splits to count in,
// sum them all in split order (false: another block stores the tile); then
// the epilogue. D register 4j + c (+ 2) of the lane is x row 8j + 2t + c,
// column c0 (c0 + 1) of the tile; B3 stores
// (float(acc) * dx[m]) * s8[n] in the plain version's order.
template <int MODE, int BX>
__device__ __forceinline__ bool finish(typename Acc<MODE>::T* acc,
                                       const Item& it, const Args& a,
                                       int tid, int cons, int c0, int t4,
                                       const float* s8, int* is_last) {
  using T = typename Acc<MODE>::T;
  if (it.split) {
    // every split stores its partial (registers 4i .. 4i + 3 of consumer
    // thread tid, 16 bytes at i * cons + tid); the last to count in sums
    // them all, its own read back too, in split order
    using T4 = typename Acc<MODE>::T4;
    const size_t per = (size_t)(BX / 8) * cons;            // T4 a split
    T4* pt = reinterpret_cast<T4*>(a.partial) +
             (size_t)(it.tile - a.t0) * a.splits * per;
    T4* mine = pt + (size_t)it.z * per;
#pragma unroll
    for (int i = 0; i < BX / 8; ++i)
      __stcg(mine + i * cons + tid, T4{acc[4 * i], acc[4 * i + 1],
                                      acc[4 * i + 2], acc[4 * i + 3]});
    __threadfence();
    consumers_sync(cons);
    if (tid == 0)
      *is_last = atomicAdd(&a.counters[it.tile], 1) == a.splits - 1;
    consumers_sync(cons);
    if (!*is_last) return false;
    __threadfence();
    // split by split, 8 loads (32 registers) in flight at a time
    for (int z = 0; z < a.splits; ++z) {
      const T4* pz = pt + z * per + tid;
#pragma unroll
      for (int i0 = 0; i0 < BX / 8; i0 += 8) {
        T4 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __ldcg(pz + (i0 + i) * cons);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          T* r = acc + 4 * (i0 + i);
          r[0] = z == 0 ? v[i].x : r[0] + v[i].x;
          r[1] = z == 0 ? v[i].y : r[1] + v[i].y;
          r[2] = z == 0 ? v[i].z : r[2] + v[i].z;
          r[3] = z == 0 ? v[i].w : r[3] + v[i].w;
        }
      }
    }
    if (tid == 0) a.counters[it.tile] = 0;
  }
  const int n = it.n0 + c0;
  const bool pairs = (a.n_out & 1) == 0 && n + 1 < a.n_out;
#pragma unroll
  for (int j = 0; j < BX / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = it.m0 + 8 * j + 2 * t4 + c;
      if (m >= a.M) continue;
      float* yr = a.y + (size_t)m * a.n_out;
      float v0, v1;
      if constexpr (MODE == kInt8) {
        const float dm = __ldg(a.dx + m);
        v0 = ((float)acc[4 * j + c] * dm) * s8[0];
        v1 = ((float)acc[4 * j + 2 + c] * dm) * s8[1];
      } else {
        v0 = acc[4 * j + c];
        v1 = acc[4 * j + 2 + c];
      }
      if (pairs) {
        *reinterpret_cast<float2*>(yr + n) = make_float2(v0, v1);
      } else {
        if (n < a.n_out) yr[n] = v0;
        if (n + 1 < a.n_out) yr[n + 1] = v1;
      }
    }
  }
  return true;
}

// The producer's loop (one thread): each stage's x tile (f32 mode: the
// three parts' tiles, one 4-D copy), packed rows, scale rows, (q4_1) mins
// rows and (f32 q4_1) block sums into the ring.
template <int MODE, int BX>
__device__ __forceinline__ void produce(const CUtensorMap* map_x,
                                        const CUtensorMap* map_q,
                                        const CUtensorMap* map_s,
                                        const CUtensorMap* map_m,
                                        const CUtensorMap* map_b,
                                        const Args& a, uint32_t ring, int sb,
                                        uint32_t full, uint32_t empty,
                                        int items) {
  constexpr int kQB = stage_qb(MODE);
  const int cols = 64 * a.wgs;
  // the stage's bytes: the x tile(s), the packed rows, the scale (and
  // mins) rows, the block sums
  const int xb = (f32m(MODE) ? 3 : 1) * BX * 128;
  const int qbytes = kQB * 16 * cols, sbytes = kQB * cols * 4;
  const int mbytes = minsm(MODE) ? sbytes : 0;
  const int bbytes = MODE == kF32A ? kQB * BX * 4 : 0;
  hopper::prefetch_map(map_x);
  hopper::prefetch_map(map_q);
  hopper::prefetch_map(map_s);
  if constexpr (minsm(MODE)) hopper::prefetch_map(map_m);
  if constexpr (MODE == kF32A) hopper::prefetch_map(map_b);
  int slot = 0, ph = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item t(w, BX, a);
    for (int st = t.s0; st < t.s1; ++st) {
      mbar_wait(empty + 8 * slot, ph ^ 1);
      const uint32_t dst = ring + slot * sb, bar = full + 8 * slot;
      mbar_expect_tx(bar, xb + qbytes + sbytes + mbytes + bbytes);
      // x: 128 bytes of each row's K a stage (64 bf16, 128 int8)
      if constexpr (f32m(MODE))
        hopper::tma_load_4d(dst, map_x, bar, st * 64, t.m0, 0, 0);
      else
        tma_load_2d(dst, map_x, bar, st * (MODE == kInt8 ? 128 : 64), t.m0);
      tma_load_2d(dst + xb, map_q, bar, t.n0, st * kQB * 16);
      tma_load_2d(dst + xb + qbytes, map_s, bar, t.n0, st * kQB);
      if constexpr (minsm(MODE))
        tma_load_2d(dst + xb + qbytes + sbytes, map_m, bar, t.n0,
                    st * kQB);
      if constexpr (MODE == kF32A)
        tma_load_2d(dst + xb + qbytes + 2 * sbytes, map_b, bar, t.m0,
                    st * kQB);
      if (++slot == a.stages) { slot = 0; ph ^= 1; }
    }
  }
}

// The register route's body (B5 and B3; q4_prefill_bf16_kernel and
// q4_prefill_int8_kernel: one name a function in a profile): the weight
// converted into the A registers. Block b takes the items b, b +
// gridDim.x, ... (Item); every role counts the stages it has passed in
// (slot, phase) of the ring. The maps are the kernel's parameters.
template <int MODE, int BX>
__device__ __forceinline__ void body_rs(const CUtensorMap* map_x,
                                          const CUtensorMap* map_q,
                                          const CUtensorMap* map_s,
                                          const CUtensorMap* map_m,
                                          const Args& a) {
  using T = typename Acc<MODE>::T;
  constexpr int kQB = stage_qb(MODE);
  constexpr int kXBytes = BX * 128;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int is_last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* ring_p = smem_raw + (ring - raw);
  const int cols = 64 * a.wgs, cons = 128 * a.wgs;
  const int sb = stage_bytes(MODE, BX, a.wgs);
  const int qbytes = kQB * 16 * cols;
  const uint32_t full = ring + a.stages * sb, empty = full + 8 * a.stages;
  const int items = a.t0 + (a.rt * a.ct - a.t0) * a.splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, cons / 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= cons / 32) {                    // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == cons)
      produce<MODE, BX>(map_x, map_q, map_s, map_m, map_m, a, ring, sb, full,
                        empty, items);
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int tid = threadIdx.x;
  const int c0 = 64 * wg + 16 * w + 2 * g;
  // the byte offsets of the lane's two bytes of its four packed rows (B5:
  // 2t, 2t + 1, 2t + 8, 2t + 9; B3: 4t .. 4t + 3) in a q block's 16 rows,
  // as the tensor copy swizzles them (128-byte rows: 16-byte chunk ^ row %
  // 8; 64-byte rows: ^ row / 2 % 4); a q block's 16 rows keep the pattern,
  // so q block b adds 16 b rows
  int roff[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = MODE == kInt8 ? 4 * t4 + j : 2 * t4 + (j & 1) + 8 * (j >> 1);
    const int sw = cols == 128 ? (r & 7) : ((r >> 1) & 3);
    roff[j] = r * cols + (((c0 >> 4) ^ sw) << 4) + (c0 & 15);
  }
  T acc[BX / 2];
  // the A sets of the stage's commit groups (B5: a q block's low then high
  // k16 step; B3: a q block's k32 step), 4 registers each
  uint32_t afr[kGroups][4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) afr[g][i] = 0u;
  // a warp releases a stage by one arrival (lane 0) once its reads and
  // products of it are done; pw: the slot whose last products are still in
  // flight (-1: none)
  int slot = 0, ph = 0, pw = -1;
  for (int wi = blockIdx.x; wi < items; wi += gridDim.x) {
    const Item it(wi, BX, a);
    // B3: s8 and 1 / s8 of the lane's columns from the whole K's scales
    float s8[2] = {0.f, 0.f}, inv0 = 0.f, inv1 = 0.f;
    if constexpr (MODE == kInt8) {
      column_s8(a, it.n0 + c0, t4, s8);
      inv0 = __fdiv_rn(1.0f, s8[0]);
      inv1 = __fdiv_rn(1.0f, s8[1]);
    }
#pragma unroll
    for (int i = 0; i < BX / 2; ++i) acc[i] = 0;
    fence_regs<BX / 2>(acc);
    for (int st = it.s0; st < it.s1; ++st) {
      mbar_wait(full + 8 * slot, ph);
      const uint8_t* stp = ring_p + slot * sb;
      const uint32_t xs = ring + slot * sb;
      const uint8_t* qsl = stp + kXBytes;
      const float* sc = reinterpret_cast<const float*>(qsl + qbytes);
      // the q block's nibble words and scales (B5: kept for its high step)
      uint32_t nib[4] = {0u, 0u, 0u, 0u};
      float d0 = 0.f, d1 = 0.f, m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        uint32_t* A = afr[j];
        const int b = MODE == kInt8 ? j : j >> 1;     // the q block
        if (MODE == kInt8 || (j & 1) == 0) {
          const uint8_t* slab = qsl + b * 16 * cols;
          uint32_t rw[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) rw[r] = lds_u16(slab + roff[r]);
          const float2 d = *reinterpret_cast<const float2*>(
              sc + b * cols + c0);
          d0 = d.x;
          d1 = d.y;
          if constexpr (MODE == kAffine) {
            const float2 mn = *reinterpret_cast<const float2*>(
                sc + (kQB + b) * cols + c0);
            m0 = mn.x;
            m1 = mn.y;
          }
          if constexpr (MODE == kInt8) {
            d0 = __fmul_rn(d.x, inv0);
            d1 = __fmul_rn(d.y, inv1);
          }
          const uint32_t w01 = __byte_perm(rw[0], rw[1], 0x5410);
          const uint32_t w23 = __byte_perm(rw[2], rw[3], 0x5410);
          nib[0] = w01 & 0x0F0F0F0Fu;
          nib[1] = w23 & 0x0F0F0F0Fu;
          nib[2] = (w01 >> 4) & 0x0F0F0F0Fu;
          nib[3] = (w23 >> 4) & 0x0F0F0F0Fu;
        }
#if FLTORCH_RA_ABLATE == 1    // the sweep's build without the conversion
#pragma unroll
        for (int r = 0; r < 4; ++r)
          A[r] = nib[r] ^ __float_as_uint(d0 + m0) ^ __float_as_uint(d1 + m1);
#else
        if constexpr (MODE == kInt8)
          make_a_int8(nib, d0, d1, A);
        else if ((j & 1) == 0)
          make_a_bf16<MODE>(nib[0], nib[1], d0, d1, m0, m1, A);
        else
          make_a_bf16<MODE>(nib[2], nib[3], d0, d1, m0, m1, A);
#endif
        // every input of the product (the A registers, the descriptor; D
        // untouched) set before its pipeline stage opens; group j reads
        // the j-th 32 bytes of each x row
        uint64_t dsc = hopper::sw128_desc(xs + 32 * j);
        asm volatile("" : "+l"(dsc)::"memory");
        keep_regs<4>(A);
        fence_regs<BX / 2>(acc);
        wgmma_fence();
#if FLTORCH_RA_ABLATE != 2    // the sweep's build without the products
        if constexpr (MODE == kInt8)
          MmaS8<BX>::run(acc, A, dsc);
        else
          MmaBf16<BX>::run(acc, A, dsc);
#endif
        wgmma_commit();
        fence_regs<BX / 2>(acc);
        // kInFlight groups stay in flight; the one before them is done,
        // and its A set is free from here on
        wgmma_wait<kInFlight>();
        keep_regs<4>(afr[(j - kInFlight + kGroups) % kGroups]);
        if (j == kInFlight - 1) {   // so is the stage before: release it
          mbar_arrive_if(empty + 8 * (pw < 0 ? 0 : pw), lane == 0 && pw >= 0);
          pw = -1;
        }
      }
      pw = slot;
      if (++slot == a.stages) { slot = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs<BX / 2>(acc);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) keep_regs<4>(afr[g]);
    mbar_arrive_if(empty + 8 * (pw < 0 ? 0 : pw), lane == 0 && pw >= 0);
    pw = -1;
    finish<MODE, BX>(acc, it, a, tid, cons, c0, t4, s8, &is_last);
  }
}

// The codes of one k16 step in the A registers (f32 mode), from the nibble
// words n01, n23 as make_a_bf16 takes them: each code under bf16's 128
// (ulp 1) by one byte permute, less 136 (q4_0: q - 8) or 128 (q4_1: q),
// exact, a bf16x2 subtraction a pair.
template <int MODE>
__device__ __forceinline__ void make_a_codes(uint32_t n01, uint32_t n23,
                                             uint32_t* a) {
  const __nv_bfloat162 k =
      __float2bfloat162_rn(MODE == kF32 ? 136.f : 128.f);
  auto pair = [&](uint32_t nib, uint32_t sel) {
    const uint32_t v = __byte_perm(nib, 0x43434343u, sel);
    return bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), k));
  };
  a[0] = pair(n01, 0x4240);
  a[1] = pair(n01, 0x4341);
  a[2] = pair(n23, 0x4240);
  a[3] = pair(n23, 0x4341);
}

// The f32 route's body (q4_prefill_f32_kernel): body_rs's roles, stages of
// two q blocks, each q block's six products (two k16 steps a part) into z
// and z scaled into acc (the header's f32 mode).
template <int MODE, int BX>
__device__ __forceinline__ void body_f32(const CUtensorMap* map_x,
                                         const CUtensorMap* map_q,
                                         const CUtensorMap* map_s,
                                         const CUtensorMap* map_m,
                                         const CUtensorMap* map_b,
                                         const Args& a) {
  static_assert(f32m(MODE) && BX <= 128, "f32 mode: BX <= 128");
  constexpr int kQB = stage_qb(MODE);
  constexpr int kPart = BX * 128;              // a part's x tile
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int is_last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* ring_p = smem_raw + (ring - raw);
  const int cols = 64 * a.wgs, cons = 128 * a.wgs;
  const int sb = stage_bytes(MODE, BX, a.wgs);
  const int qbytes = kQB * 16 * cols, sbytes = kQB * cols * 4;
  const uint32_t full = ring + a.stages * sb, empty = full + 8 * a.stages;
  const int items = a.t0 + (a.rt * a.ct - a.t0) * a.splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, cons / 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= cons / 32) {                    // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == cons)
      produce<MODE, BX>(map_x, map_q, map_s, map_m, map_b, a, ring, sb, full,
                        empty, items);
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int tid = threadIdx.x;
  const int c0 = 64 * wg + 16 * w + 2 * g;
  // the lane's packed rows 2t, 2t + 1, 2t + 8, 2t + 9, as body_rs's
  int roff[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 2 * t4 + (j & 1) + 8 * (j >> 1);
    const int sw = cols == 128 ? (r & 7) : ((r >> 1) & 3);
    roff[j] = r * cols + (((c0 >> 4) ^ sw) << 4) + (c0 & 15);
  }
  // acc, and z: a q block's products (register i: column c0 + i / 2 % 2);
  // z is zero at each item's start (zeroed after the item before's last
  // scale), since the item's first q block adds it times 0
  float acc[BX / 2], z[BX / 2];
#pragma unroll
  for (int i = 0; i < BX / 2; ++i) z[i] = 0.f;
  // the A sets of two q blocks (each its two k16 steps), alternating
  uint32_t afr[2][8];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 8; ++i) afr[b][i] = 0u;
  int slot = 0, ph = 0, pw = -1;
  for (int wi = blockIdx.x; wi < items; wi += gridDim.x) {
    const Item it(wi, BX, a);
    float s8[2] = {0.f, 0.f};              // unused (B3's)
    // the scales of the q block whose z is pending (none yet: 0)
    float dp0 = 0.f, dp1 = 0.f;
#pragma unroll
    for (int i = 0; i < BX / 2; ++i) acc[i] = 0.f;
    for (int st = it.s0; st < it.s1; ++st) {
      mbar_wait(full + 8 * slot, ph);
      const uint8_t* stp = ring_p + slot * sb;
      const uint32_t xs = ring + slot * sb;
      const uint8_t* qsl = stp + 3 * kPart;
      const float* sc = reinterpret_cast<const float*>(qsl + qbytes);
      const float* bsum = reinterpret_cast<const float*>(
          qsl + qbytes + 2 * sbytes);
#pragma unroll
      for (int b = 0; b < kQB; ++b) {
        uint32_t* A = afr[b];
        const uint8_t* slab = qsl + b * 16 * cols;
        uint32_t rw[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) rw[r] = lds_u16(slab + roff[r]);
        const float2 d = *reinterpret_cast<const float2*>(sc + b * cols + c0);
        const uint32_t w01 = __byte_perm(rw[0], rw[1], 0x5410);
        const uint32_t w23 = __byte_perm(rw[2], rw[3], 0x5410);
        make_a_codes<MODE>(w01 & 0x0F0F0F0Fu, w23 & 0x0F0F0F0Fu, A);
        make_a_codes<MODE>((w01 >> 4) & 0x0F0F0F0Fu,
                           (w23 >> 4) & 0x0F0F0F0Fu, A + 4);
        // part p, k16 step s: the s-th 32 bytes of the q block's 64 in
        // each row of part p's tile
        uint64_t dsc[6];
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            dsc[3 * s + p] = hopper::sw128_desc(xs + p * kPart +
                                                32 * (2 * b + s));
            asm volatile("" : "+l"(dsc[3 * s + p])::"memory");
          }
        // q block b - 1's products done; its z scaled into acc
        wgmma_wait<0>();
        fence_regs<BX / 2>(z);
        keep_regs<8>(afr[b ^ 1]);
#pragma unroll
        for (int i = 0; i < BX / 2; ++i)
          acc[i] = __fmaf_rn(z[i], (i >> 1) & 1 ? dp1 : dp0, acc[i]);
        if constexpr (MODE == kF32A) {
          // the mins term of q block b: bsum of x rows 8j + 2t (+ 1)
          const float2 mn = *reinterpret_cast<const float2*>(
              sc + (kQB + b) * cols + c0);
#pragma unroll
          for (int j = 0; j < BX / 8; ++j) {
            const float2 v = *reinterpret_cast<const float2*>(
                bsum + b * BX + 8 * j + 2 * t4);
            acc[4 * j] = __fmaf_rn(v.x, mn.x, acc[4 * j]);
            acc[4 * j + 1] = __fmaf_rn(v.y, mn.x, acc[4 * j + 1]);
            acc[4 * j + 2] = __fmaf_rn(v.x, mn.y, acc[4 * j + 2]);
            acc[4 * j + 3] = __fmaf_rn(v.y, mn.y, acc[4 * j + 3]);
          }
        }
        dp0 = d.x;
        dp1 = d.y;
        if (b == 0) {      // so is the stage before: release it
          mbar_arrive_if(empty + 8 * (pw < 0 ? 0 : pw), lane == 0 && pw >= 0);
          pw = -1;
        }
        keep_regs<8>(A);
        fence_regs<BX / 2>(z);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int p = 0; p < 3; ++p)
            MmaBf16<BX>::run(z, A + 4 * s, dsc[3 * s + p],
                             s == 0 && p == 0 ? 0 : 1);
        wgmma_commit();
        fence_regs<BX / 2>(z);
      }
      pw = slot;
      if (++slot == a.stages) { slot = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs<BX / 2>(z);
    keep_regs<8>(afr[0]);
    keep_regs<8>(afr[1]);
    mbar_arrive_if(empty + 8 * (pw < 0 ? 0 : pw), lane == 0 && pw >= 0);
    pw = -1;
#pragma unroll
    for (int i = 0; i < BX / 2; ++i) {
      acc[i] = __fmaf_rn(z[i], (i >> 1) & 1 ? dp1 : dp0, acc[i]);
      z[i] = 0.f;      // a non-finite z times the next item's first 0: NaN
    }
    finish<MODE, BX>(acc, it, a, tid, cons, c0, t4, s8, &is_last);
  }
}

// B5 in f32 mode (MODE kF32: q4_0, kF32A: q4_1).
template <int MODE, int BX>
__global__ void __launch_bounds__(kMaxThreads, 1)
q4_prefill_f32_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_s,
                      const __grid_constant__ CUtensorMap map_m,
                      const __grid_constant__ CUtensorMap map_b,
                      const Args a) {
  body_f32<MODE, BX>(&map_x, &map_q, &map_s, &map_m, &map_b, a);
}

// B5 in bf16 mode (MODE kNat: q4_0, kAffine: q4_1) and B3.
template <int MODE, int BX>
__global__ void __launch_bounds__(kMaxThreads, 1)
q4_prefill_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_s,
                       const __grid_constant__ CUtensorMap map_m,
                       const Args a) {
  body_rs<MODE, BX>(&map_x, &map_q, &map_s, &map_m, a);
}
template <int BX>
__global__ void __launch_bounds__(kMaxThreads, 1)
q4_prefill_int8_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_s,
                       const __grid_constant__ CUtensorMap map_m,
                       const Args a) {
  body_rs<kInt8, BX>(&map_x, &map_q, &map_s, &map_m, a);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int MODE, int BX>
constexpr auto kernel_of() {
  if constexpr (MODE == kInt8)
    return q4_prefill_int8_kernel<BX>;
  else
    return q4_prefill_bf16_kernel<MODE, BX>;
}

template <int MODE, int BX>
int launch(const Args& a, const void* x, int K, const void* qs,
           const void* scales, const void* mins, int blocks,
           cudaStream_t stream) {
  auto* kern = kernel_of<MODE, BX>();
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int cols = 64 * a.wgs, qb = stage_qb(MODE);
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap map_x, map_q, map_s, map_m;
  if (!(MODE == kInt8
            ? hopper::make_map(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                               a.M, K, 128, BX, CU_TENSOR_MAP_SWIZZLE_128B)
            : hopper::make_map(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                               a.M, K, 64, BX,
                               CU_TENSOR_MAP_SWIZZLE_128B)) ||
      !hopper::make_map(&map_q, qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2,
                        a.N, cols, 16 * qb,
                        cols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hopper::make_map(&map_s, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        K / 32, a.N, cols, qb, none) ||
      !hopper::make_map(&map_m, MODE == kAffine ? mins : scales,
                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / 32, a.N, cols,
                        qb, none))
    return (int)cudaErrorInvalidValue;
  kern<<<blocks, 128 * a.wgs + 128, kSmemBytes, stream>>>(
      map_x, map_q, map_s, map_m, a);
  return (int)cudaGetLastError();
}

// The BX widths built (the plan's RA_BX in kernels/q4_matmul.py).
template <int MODE>
int dispatch(int bx, const Args& a, const void* x, int K, const void* qs,
             const void* scales, const void* mins, int blocks,
             cudaStream_t s) {
  switch (bx) {
    case 64: return launch<MODE, 64>(a, x, K, qs, scales, mins, blocks, s);
    case 96: return launch<MODE, 96>(a, x, K, qs, scales, mins, blocks, s);
    case 128: return launch<MODE, 128>(a, x, K, qs, scales, mins, blocks, s);
    case 160: return launch<MODE, 160>(a, x, K, qs, scales, mins, blocks, s);
    case 192: return launch<MODE, 192>(a, x, K, qs, scales, mins, blocks, s);
    case 224: return launch<MODE, 224>(a, x, K, qs, scales, mins, blocks, s);
    case 256: return launch<MODE, 256>(a, x, K, qs, scales, mins, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch of mode MODE: x [M, K] (bf16 or int8, K the stored K), the
// planes, dx (B3), y f32 [M, n_out]; bx, wgs, t0 (the tiles run whole; the
// rest split), splits, sps (stages a split; the K the product runs over is
// kc) and blocks (at most one an SM) from the plan; the ring as deep as
// fits; partial f32 scratch (16-byte aligned) of (ceil(M / bx) *
// ceil(N / 64 wgs) - t0) * splits * bx * 64 * wgs floats where splits > 1,
// counters int32 zeros, one a tile.
template <int MODE>
int gemm(const void* x, int M, int K, int kc, const void* qs,
         const void* scales, const void* mins, const void* dx, int N,
         int bx, int wgs, int t0, int splits, int sps, int blocks,
         void* partial, void* counters, void* y, int n_out,
         cudaStream_t stream) {
  const int qb = stage_qb(MODE);
  const int nst = (kc / 32 + qb - 1) / qb;
  const int tiles = ((M + bx - 1) / (bx > 0 ? bx : 1)) *
                    ((N + 64 * wgs - 1) / (64 * (wgs > 0 ? wgs : 1)));
  if (M < 1 || K % 32 || kc < 32 || kc % 32 || kc > K || N % 16 ||
      n_out > N || wgs < 1 || wgs > 2 || bx % 32 || bx < 64 || bx > 256 ||
      t0 < 0 || t0 > tiles ||
      splits < 1 || sps < 1 || (splits - 1) * sps >= nst ||
      splits * sps < nst || blocks < 1 ||
      (splits > 1 && (!partial || !counters)) ||
      (MODE == kAffine) != (mins != nullptr) ||
      (MODE == kInt8) != (dx != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.y = (float*)y;
  a.partial = (float*)partial;
  a.counters = (int*)counters;
  a.dx = (const float*)dx;
  a.scales = (const float*)scales;
  a.M = M;
  a.N = N;
  a.NB = K / 32;
  a.n_out = n_out;
  a.wgs = wgs;
  a.stages = max_stages(MODE, bx, wgs);
  a.nst = nst;
  a.rt = (M + bx - 1) / bx;
  a.ct = (N + 64 * wgs - 1) / (64 * wgs);
  a.t0 = splits > 1 ? t0 : tiles;
  a.splits = splits;
  a.sps = sps;
  return dispatch<MODE>(bx, a, x, K, qs, scales, mins, blocks, stream);
}

// f32 mode: one launch of q4_prefill_f32_kernel<MODE, BX> on the cast
// pass's planes, xp bf16 [3][M][K] (x's three parts) and, for q4_1, bs f32
// [2 ceil(K / 64)][mr] (bsum(x) of q block b and row m at b mr + m; mr = M
// rounded up to 4), the rest as gemm's.
template <int MODE, int BX>
int launch_f32(const Args& a, const void* xp, const void* bs, int mr, int K,
               const void* qs, const void* scales, const void* mins,
               int blocks, cudaStream_t stream) {
  auto* kern = q4_prefill_f32_kernel<MODE, BX>;
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int cols = 64 * a.wgs, qb = stage_qb(MODE);
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  // the parts as [1][3][M][K]: one box of 64 K x BX rows x 3 parts a stage
  const long long dims[4] = {K, a.M, 3, 1};
  const long long strides[3] = {2LL * K, 2LL * K * a.M, 6LL * K * a.M};
  const int box[4] = {64, BX, 3, 1};
  CUtensorMap map_x, map_q, map_s, map_m, map_b;
  if (!hopper::make_map_4d(&map_x, xp, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                           dims, strides, box) ||
      !hopper::make_map(&map_q, qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2,
                        a.N, cols, 16 * qb,
                        cols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hopper::make_map(&map_s, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        K / 32, a.N, cols, qb, none) ||
      !hopper::make_map(&map_m, MODE == kF32A ? mins : scales,
                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / 32, a.N, cols,
                        qb, none) ||
      !hopper::make_map(&map_b, MODE == kF32A ? bs : scales,
                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        MODE == kF32A ? (K + 63) / 64 * 2 : K / 32,
                        MODE == kF32A ? mr : a.N, BX, qb, none))
    return (int)cudaErrorInvalidValue;
  kern<<<blocks, 128 * a.wgs + 128, kSmemBytes, stream>>>(
      map_x, map_q, map_s, map_m, map_b, a);
  return (int)cudaGetLastError();
}

// f32 mode's gemm (MODE kF32 or kF32A): gemm's contract, x as the cast
// pass's part planes xp and block sums bs (launch_f32), bx 64, 96 or 128.
template <int MODE>
int gemm_f32(const void* xp, const void* bs, int mr, int M, int K, int kc,
             const void* qs, const void* scales, const void* mins, int N,
             int bx, int wgs, int t0, int splits, int sps, int blocks,
             void* partial, void* counters, void* y, int n_out,
             cudaStream_t stream) {
  const int qb = stage_qb(MODE);
  const int nst = (kc / 32 + qb - 1) / qb;
  const int tiles = ((M + bx - 1) / (bx > 0 ? bx : 1)) *
                    ((N + 64 * wgs - 1) / (64 * (wgs > 0 ? wgs : 1)));
  if (M < 1 || K % 32 || kc < 32 || kc % 32 || kc > K || N % 16 ||
      n_out > N || wgs < 1 || wgs > 2 ||
      (bx != 64 && bx != 96 && bx != 128) || t0 < 0 || t0 > tiles ||
      splits < 1 || sps < 1 || (splits - 1) * sps >= nst ||
      splits * sps < nst || blocks < 1 ||
      (splits > 1 && (!partial || !counters)) ||
      (MODE == kF32A) != (mins != nullptr) || mr < M || mr % 4)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.y = (float*)y;
  a.partial = (float*)partial;
  a.counters = (int*)counters;
  a.dx = nullptr;
  a.scales = (const float*)scales;
  a.M = M;
  a.N = N;
  a.NB = K / 32;
  a.n_out = n_out;
  a.wgs = wgs;
  a.stages = max_stages(MODE, bx, wgs);
  a.nst = nst;
  a.rt = (M + bx - 1) / bx;
  a.ct = (N + 64 * wgs - 1) / (64 * wgs);
  a.t0 = splits > 1 ? t0 : tiles;
  a.splits = splits;
  a.sps = sps;
  switch (bx) {
    case 64:
      return launch_f32<MODE, 64>(a, xp, bs, mr, K, qs, scales, mins, blocks,
                                  stream);
    case 96:
      return launch_f32<MODE, 96>(a, xp, bs, mr, K, qs, scales, mins, blocks,
                                  stream);
    default:
      return launch_f32<MODE, 128>(a, xp, bs, mr, K, qs, scales, mins,
                                   blocks, stream);
  }
}

}  // namespace ra
}  // namespace
