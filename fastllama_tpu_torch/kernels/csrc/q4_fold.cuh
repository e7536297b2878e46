// Kernels B1 and B9 (the default decode matmuls, q4_0 and q4_1, in bf16
// mode and in f32 mode), B15, B16, B17 and B18 (the JAX package's v1, v2,
// v3 and v7 decode bodies of q4_matmul_pallas), and the probes B13 and B14
// of tools/bench_q4_floor.py, on one decode-size kernel built for Hopper.
// This header holds the kernel; q4_fold_v0.cu (B1), q4_fold_v9.cu (B9),
// q4_fold_f32.cu (B1 and B9 in f32 mode), q4_fold.cu (B15), q4_fold_v2.cu
// (B16), q4_fold_v3.cu (B17), q4_fold_v7.cu (B18) and q4_fold_probe.cu (B13
// and B14) build one variant each (or a pair), so that they compile side by
// side.
//
// Replaces fastllama_tpu/kernels/q4_matmul.py::q4_matmul_pallas with the
// function of its v0 body, _q4mm_kernel (variant 0; q4_matmul_xla's), and
// ::q41_matmul_pallas (_q41mm_kernel, variant 9), ::_q4mm_kernel_v1 (v1; v4
// and v5 are bit-equal to it), ::_q4mm_kernel_v2 (v2), ::_q4mm_kernel_v3
// (v3) and ::_q4mm_kernel_v7 (v7), each by its function
// (kernels/q4_matmul.py, kernels/q4_variants.py), and
// tools/bench_q4_floor.py::_floor_kernel (variant 13) and ::_nosc_kernel
// (variant 14) (kernels/q4_floor.py), x f32 [1 <= M <= 64, K], the planes
// as stored (qs uint8 [K/2, N] split-K packed: byte (16 kb + j, n) holds
// element 32 kb + j in its low nibble and 32 kb + 16 + j in its high one;
// scales f32 or bf16 [K/32, N]; variant 9's mins f32 [K/32, N]):
//   v0: y = R(x) @ R((q - 8) d)                           (B1)
//   v9: y = R(x) @ R(q d) + bsum(x) @ m                   (B9)
//   v1: y = R(x) @ R(q d) - 8 bsum(x) @ d
//   v2: y = sum_b d_b (R(x_b) @ q_b) - 8 bsum(x) @ d
//   v3: y = R(x) @ R(q R(d)) - 8 bsum(x) @ d
//   v7: y = R(x) @ R(q d) - 8 bsum7(x) @ d
//   10: y = x @ ((q - 8) d)          (B1 in f32 mode, nothing rounded)
//   11: y = x @ (q d) + bsum(x) @ m  (B9 in f32 mode)
//   13: y = R(x_lo) @ qs                      (B13, floor: the whole byte)
//   14: y = R(x_lo) @ (qs & 15) + R(x_hi) @ (qs >> 4)     (B14, nosc)
// with q the code 0..15, R the rounding to bf16, bsum(x) [M, K/32] the
// f32 sums of the unrounded x over each q block, x_b and q_b the 32 columns
// of x and rows of q of q block b, and bsum7(x) the f32 sums of
// R(R(x_lo) + R(x_hi)) over the 16 pairs of each q block (x_lo, x_hi its
// low and high 16, [M, K/2]).
//
// Bound on the H100: bytes. At M = 1 a weight costs 2 flops and 0.625 bytes
// (0.5625 with bf16 scales), far below the ~295 flop/byte ridge, and at
// M = 64 still below it (128 flops a weight, ~205 a byte): the time is the
// weight planes over 3.35 TB/s, and reaching it takes some 64 KB in flight
// on every SM. B1's skeleton, which these bodies ran on before, kept about
// 4.5 KB in flight a warp (16-byte cp.async copies a lane into 4-stage warp
// rings), paid a ring ramp, a staged x slice and a split-K merge through
// global partials, a counter and a last-block re-read in every one of a
// wave of short-lived blocks, and fetched and dequantized every weight tile
// twice at M > 32 (two 32-row tiles of x). Here:
//   * persistent blocks, one an SM (the whole shared memory, 227 KB),
//     in thread block clusters of S = 1..8 (the splits of K: q4_variants.
//     b15_plan); cluster c walks the column tiles c, c + clusters, ... and
//     its block of rank z takes the z-th run of K stages of each tile;
//   * one producer thread streams each stage's weights (4 q blocks: 16 * 4
//     packed rows of the tile's BN columns as stored, in boxes of 128 (or
//     64) columns swizzled by the tensor copy for the readers' banks, and
//     their 4 scale rows, and v9's 4 mins rows) by cp.async.bulk.tensor.2d
//     copies into an
//     mbarrier ring of `stages` slots (about 80 KB) that runs on across
//     tiles, so no tile pays a ramp; a second streams each stage's x (its
//     f32 rows < M of those 128 columns of K) into a ring of `xstages`
//     slots, which holds fewer where x is wide (32 KB a stage at M = 64);
//     the tensor maps cover the planes and x as stored and fill zeros past
//     N and K, so nothing masks;
//   * two or four x warps convert each stage's x, once landed, into bf16
//     in the K-major core-matrix layout wgmma reads as its B operand, and
//     (but for v0) sum the unrounded x over each q block (the fold's block
//     sums; v7:
//     the pair sums R(R(x_lo) + R(x_hi)), rounded by bf16x2 instructions
//     and summed in f32), a thread an x_lo float4 and the x_hi float4 it
//     pairs with; x is
//     read again for every column tile, from L2. (Read by the x warps
//     themselves, one L2 round trip a stage set the pace: 3x the bound;
//     copied with the weights into one ring, x's 32 KB a stage left 3
//     slots at M = 64);
//   * one or two consumer warpgroups of 128 columns each (64 for NW > 32,
//     where the registers allow one m-tile): a lane dequantizes its 4 (2)
//     adjacent columns of packed rows 2t, 2t+1, 2t+8, 2t+9 (t = lane % 4),
//     one 4-byte (2-byte) load a row, straight into wgmma's A-fragment
//     registers, and issues wgmma.mma_async m64nNWk16 a m-tile with A (the
//     weight, 64 columns x 16 k) from registers and B (x^T, 16 k x NW rows,
//     NW = M rounded up to 8) from the stage's x tile: every row of x in
//     one pass, each weight tile
//     fetched and dequantized once. v1: the code into the mantissa of 2^23
//     by one byte permute, then fma(2^23 + q, d, -2^23 d) = q d rounded
//     once in f32 (bit for bit the plain version's f32 product), two
//     packed into bf16 by one cvt. v3: two codes into bf16 128 + q by one
//     permute, then one bf16x2 fma with R(d) and -128 R(d): R(q R(d)), the
//     plain version's bf16 product (__hmul2). v2: the codes alone, 128 + q
//     by one permute less 128 by one bf16x2 subtraction a pair (exact).
//     v0: the code into the mantissa of 2^23, less 2^23 + 8 (q - 8, exact),
//     then one f32 product by d: R((q - 8) d) rounded once in f32 and once
//     to bf16, bit for bit the plain version's weight (one instruction a
//     weight more than v1: fma(2^23 + q, d, -(2^23 + 8) d) is not exact,
//     since (2^23 + 8) d is not an f32). v9: v1's R(q d). At NW = 8 the
//     sync build issues mma.sync m16n8k16 per warp on the same fragments
//     instead;
//   * v1, v3, v7, v9: the folded offset -8 bsum(x) @ d (v9: the mins term
//     bsum(x) @ m) goes into a second set of f32 registers in the D
//     fragment's layout (an FMA a register a q block, bsum from the x
//     warps, -8 d exact), since a wgmma in flight owns the accumulators;
//     the two are added once at the end of a split. v9's stage carries the
//     tile's mins rows beside its scale rows (a fourth tensor map), 8 bytes
//     a column a q block. v0 has no fold: its x warps sum nothing;
//   * v2 scales each q block's product after it is complete: the block's
//     two k16 steps go into a fresh set z (wgmma's scale-d 0 on the first,
//     so nothing zeroes it), then acc += z d by one FMA a D register with
//     its column's d, and the fold goes straight into acc, which no wgmma
//     owns. On the wgmma route block b - 1's product is waited for (and
//     scaled) after block b's A registers are made, before block b's issue:
//     one set of z (a build with two alternating, block b - 1's scaled
//     while block b's runs, took 1.13-1.23x its time at M = 16 and
//     0.96-1.03x at 33 and 64);
//   * where K is split, the blocks of rank 1..S-1 send their partial tiles
//     (acc + fold, f32) to the leader's shared memory by one bulk copy a
//     warpgroup (shared::cta to shared::cluster, completing on the leader's
//     barrier), and the leader adds them in split order and stores y: no
//     global partials, counters, fences or re-reads. A sender reuses its
//     buffer once the leader, done reading, arrives on its barrier.
//   * 10 and 11, f32 mode: the tensor cores have no f32 product, but an f32
//     x is the exact sum of three bf16 parts, h its upper 16 bits, m those
//     of x - h and l = x - h - m (each part takes the next 8 of f32's 24
//     significant bits; exact for |x| >= 2^-110, where no part is
//     subnormal in bf16; truncation, not rounding, so that no part
//     overflows at f32's largest values), and a code (q - 8, or q) is an
//     exact bf16 integer. So each part's product with the codes is exact,
//     and v2's route computes the f32 function: the codes alone in the A
//     registers, the three parts' k16 steps of a q block into z (summed
//     in f32 by the tensor cores), then acc = fma(z, d, acc) and, for 11,
//     the mins term bsum(x) m straight into acc. The x warps write each
//     part of x as its own set of k16 tiles (three products a k16 step;
//     at M <= 2 too: the parts packed as rows of one 8-row tile, one
//     product a k16 step and two shuffles, took 0.98-1.08x the time,
//     PERF.md).
//     z differs from the plain version's x @ W only in the order of f32
//     sums and in the skipped rounding of (q - 8) d (or q d + m);
// each q block's pair; v2: wgmma_wait<0> before it), so a set outlives the
// next issue.
// Products of two bf16 values are exact in f32, so the product differs from
// the plain version by the f32 summation order alone (v2: each q block's,
// then the order of the scaled sums); the fold by the order of its f32
// sums. Every order is fixed by the plan, so two runs agree bit
// for bit.
//
// The probes (variants 13 and 14) run this skeleton with less body, on
// B15's plan at f32 scales, to split B15's time into its parts. They read
// no scale plane (no tensor map of it, no copy, no scale bytes in a
// stage's transaction count), keep no fold, and their x warps sum nothing;
// the x ring still copies each stage's f32 x as B15's does, so the
// skeleton's x traffic is the same. B13 puts the whole byte of each packed
// row into the A registers (v1's route with d = 1: the byte into the
// mantissa of 2^23, less 2^23, exact for 0..255; v2's 128 + q holds 7
// bits) and takes one k16 step a q block against x_lo's tile, the only
// one its x warps convert; B14 puts v2's codes (both nibbles) there and
// takes both steps straight into acc (no z, no d, no -8). So:
//   B13         the weight ring, the x ring, the persistent clusters, the
//               merge, and one k16 step of products;
//   B14 - B13   the nibble unpack and the second k16 step;
//   B15 - B14   the scales, the fold and the block sums.
//
// Two builds for tools_torch/b15_sweep.py only: -DFLTORCH_B15_NO_PDL,
// launched as a plain stream successor (griddepcontrol then waits for
// nothing), and -DFLTORCH_B15_GLOBAL_MERGE,
// whose senders store their partial tiles to global scratch and arrive on
// the leader's barrier, which then reads them back (the merge of B1's
// skeleton, for comparison; `scratch` holds a tile's partials a block).

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load_2d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int kQB = 4;                   // q blocks a stage
// the probes B13 (13) and B14 (14): no scale plane, no fold
__host__ __device__ constexpr bool probe(int var) {
  return var == 13 || var == 14;
}
// the f32 modes of B1 (10) and B9 (11)
__host__ __device__ constexpr bool f32v(int var) {
  return var == 10 || var == 11;
}
// the variants that read a mins plane: B9 in either mode
__host__ __device__ constexpr bool minsv(int var) {
  return var == 9 || var == 11;
}
// the bytes a stage carries a column a q block beside the packed rows: the
// scale (4, or 2 for bf16 scales), and B9's f32 min (the probes: none)
__host__ __device__ constexpr int stage_sbytes(int var, bool sc16) {
  return probe(var) ? 0 : minsv(var) ? 8 : sc16 ? 2 : 4;
}
// the sets of k16 tiles an x slot holds: the f32 modes' three parts apart
__host__ __device__ constexpr int x_sets(int var) {
  return f32v(var) ? 3 : 1;
}
// A consumer warpgroup takes MT m-tiles of 64 columns: 2 (a lane's 4
// adjacent columns, one 4-byte load a packed row) where NW <= 32, 1 (2
// columns) for the widest x, where the registers hold no more; a block
// takes one or two warpgroups.
__host__ __device__ constexpr int mtiles(int nw) { return nw <= 32 ? 2 : 1; }
// the warps that convert x: 2 for 8 rows (fewer threads a block leave the
// consumers more registers: 170 a thread at two m-tiles), else 4 (with 2,
// M = 16 and 32 took 1.15-1.5x the time)
__host__ __device__ constexpr int x_warps(int nw) { return nw <= 8 ? 2 : 4; }
// the consumers, the x warps, and two producer warps (weights, x)
__host__ __device__ constexpr int max_threads(int nw) {
  return 2 * 128 + 32 * x_warps(nw) + 64;
}
// the dynamic shared memory of every launch: the card's maximum a block
// (232,448 bytes on the H100), so one block an SM
constexpr int kSmem = 232448;

// What a launch takes besides the tensor maps (one struct, one parameter).
struct FoldArgs {
  float* y;
  float* scratch;  // FLTORCH_B15_GLOBAL_MERGE builds only
  int M, Kx, N, NB, n_out;
  int wgs;         // consumer warpgroups (1, 2): BN = 64 MT wgs columns
  int stages;      // weight ring slots
  int xstages;     // x ring slots (at most stages)
  int splits;      // S, the cluster size
  int sps;         // K stages a split
  int nst;         // K stages of the plane, ceil(NB / 4)
  int tiles;       // column tiles, ceil(N / BN)
};

// Byte offsets in the (1024-aligned) dynamic shared memory, from the plan.
struct Layout {
  int ws;          // a weight slot: the packed rows ([BN / 128 or 64 boxes]
                   // [16 kQB rows][128 or 64]), then the scales [kQB][BN]
                   // and variant 9's mins [kQB][BN] (sbytes the two
                   // together; 0 for the probes)
  int xr;          // an x slot: x f32 [NW][128] as copied, then
  int xt;          // the bf16 tiles (sets of kQB * 2 k16 tiles of NW x
                   // 16), then
  int xst;         // the block sums [kQB][NW]; xst the slot's bytes
  int w, x, m, bar, total;
};

__host__ __device__ inline Layout fold_layout(int wgs, int nw, int sbytes,
                                              int stages, int xstages,
                                              int splits, int sets = 1) {
  Layout L;
  const int bn = 64 * mtiles(nw) * wgs;
  L.ws = (16 * kQB * bn + kQB * bn * sbytes + 1023) / 1024 * 1024;
  L.xr = nw * 128 * 4;
  L.xt = sets * kQB * 32 * nw * 2;
  L.xst = (L.xr + L.xt + kQB * nw * 4 + 127) / 128 * 128;
  L.w = 0;
  L.x = stages * L.ws;
  L.m = L.x + xstages * L.xst;
  // the leader receives S - 1 partial tiles of BN x NW f32 (a sender sends
  // from the first of them)
  L.bar = L.m + (splits > 1 ? (splits - 1) * bn * nw * 4 : 0);
  // full, empty a weight slot; rfull, xfull, xempty an x slot; mfull,
  // mfree a warpgroup
  L.total = L.bar + 8 * (2 * stages + 3 * xstages + 8);
  return L;
}

// wgmma.mma_async m64nNk16 f32 += bf16 x bf16: A (4 registers a thread, the
// m16n8k16 fragment of the warp's 16 rows) from registers, B K-major from
// shared memory (descriptor), D in N / 2 registers a thread; sd = 0 (the
// instruction's scale-d) writes D = A B, ignoring D's old values.
template <int N> struct WgmmaRs;
template <> struct WgmmaRs<8> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct WgmmaRs<16> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct WgmmaRs<24> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct WgmmaRs<32> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct WgmmaRs<40> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct WgmmaRs<48> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct WgmmaRs<56> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27}, "
        "{%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};
template <> struct WgmmaRs<64> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t b, int sd = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
  }
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma.sync m16n8k16 into a fresh accumulator: c = A B
__device__ __forceinline__ void mma_bf16_new(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// A q block's A registers kept live past the next issue (hopper.cuh)
__device__ __forceinline__ void keep(uint32_t* r) { hopper::keep_regs<8>(r); }
using hopper::mbar_arrive_if;

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// v1: R(q d) of the code in byte C of `nib` (0..15 a byte): 2^23 + q by
// one byte permute, then fma(2^23 + q, d, -2^23 d), the exact q d rounded
// once to f32, as the plain version's product.
template <int C>
__device__ __forceinline__ float qd(uint32_t nib, float d, float nd) {
  return __fmaf_rn(__uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7440 | C)),
                   d, nd);
}

// v0: R((q - 8) d) of the code in byte C of `nib`: 2^23 + q by one byte
// permute, less 2^23 + 8 (q - 8, exact), then one f32 product, rounded once
// as the plain version's f32 weight
template <int C>
__device__ __forceinline__ float q8d(uint32_t nib, float d) {
  return __fmul_rn(
      __fadd_rn(__uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7440 | C)),
                -8388616.f),
      d);
}

// Two codes of `nib` (the bytes that selector nibbles 0 and 2 of `sel`
// pick) as the bf16 values 128 + q: each code under the exponent byte 0x43
// (128, whose bf16 ulp is 1), the first in the low half.
__device__ __forceinline__ __nv_bfloat162 code2(uint32_t nib, int sel) {
  const uint32_t v = __byte_perm(nib, 0x43434343u, sel);
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// The 4 A registers of one k16 step of one m-tile from the nibble words of
// rows (2t, 2t+1) and (2t+8, 2t+9): byte 0 / 2 its column c (A row g), byte
// 1 / 3 column c + 1 (A row g + 8), the lower k in the low half. v1, v7
// and v9 R(q d), v0 R((q - 8) d), v3 R(q R(d)), v2 the code q itself (exact
// in bf16; d is applied to each q block's product; so do 11, B9's f32
// mode, and 10, B1's, with q - 8). B13 takes v1's route with d = 1 on the
// whole bytes (exact: 8 bits), B14 v2's on the nibbles.
template <int VAR>
__device__ __forceinline__ void dequant(uint32_t n01, uint32_t n23, float d0,
                                        float d1, uint32_t* a) {
  if constexpr (VAR == 0) {
    a[0] = bits(__floats2bfloat162_rn(q8d<0>(n01, d0), q8d<2>(n01, d0)));
    a[1] = bits(__floats2bfloat162_rn(q8d<1>(n01, d1), q8d<3>(n01, d1)));
    a[2] = bits(__floats2bfloat162_rn(q8d<0>(n23, d0), q8d<2>(n23, d0)));
    a[3] = bits(__floats2bfloat162_rn(q8d<1>(n23, d1), q8d<3>(n23, d1)));
  } else if constexpr (VAR == 2 || f32v(VAR)) {
    // (128 + q) - 128 = q (10: - 136, q - 8) exactly: a permute and a
    // bf16x2 subtraction a pair
    const __nv_bfloat162 k = __float2bfloat162_rn(VAR == 10 ? 136.f : 128.f);
    a[0] = bits(__hsub2(code2(n01, 0x4240), k));
    a[1] = bits(__hsub2(code2(n01, 0x4341), k));
    a[2] = bits(__hsub2(code2(n23, 0x4240), k));
    a[3] = bits(__hsub2(code2(n23, 0x4341), k));
  } else if constexpr (VAR == 3) {
    // two codes as 128 + q, then one bf16x2 fma: (128 + q) R(d) - 128 R(d)
    // = q R(d), rounded once
    const __nv_bfloat162 h0 = __float2bfloat162_rn(d0);
    const __nv_bfloat162 h1 = __float2bfloat162_rn(d1);
    const __nv_bfloat162 m0 = __hmul2(h0, __float2bfloat162_rn(-128.f));
    const __nv_bfloat162 m1 = __hmul2(h1, __float2bfloat162_rn(-128.f));
    a[0] = bits(__hfma2(code2(n01, 0x4240), h0, m0));
    a[1] = bits(__hfma2(code2(n01, 0x4341), h1, m1));
    a[2] = bits(__hfma2(code2(n23, 0x4240), h0, m0));
    a[3] = bits(__hfma2(code2(n23, 0x4341), h1, m1));
  } else {
    const float e0 = -8388608.f * d0, e1 = -8388608.f * d1;
    a[0] = bits(__floats2bfloat162_rn(qd<0>(n01, d0, e0), qd<2>(n01, d0, e0)));
    a[1] = bits(__floats2bfloat162_rn(qd<1>(n01, d1, e1), qd<3>(n01, d1, e1)));
    a[2] = bits(__floats2bfloat162_rn(qd<0>(n23, d0, e0), qd<2>(n23, d0, e0)));
    a[3] = bits(__floats2bfloat162_rn(qd<1>(n23, d1, e1), qd<3>(n23, d1, e1)));
  }
}

using fltorch::f32_parts;
using fltorch::hi2;

// Block b of the grid is rank z = b % S of cluster b / S. Every role walks
// the same work: the column tiles t = cluster, cluster + clusters, ... and,
// in each, the K stages [z sps, min(nst, (z + 1) sps)); each counts the
// stages it has passed in (slot, phase) of the ring.
//
// Launched as a programmatic dependent of the kernel before it: the
// weights' producer streams from the start (no kernel writes the weights),
// x's producer only after griddepcontrol.wait (a kernel before writes x),
// and y is written after x is read. Each block lets the next kernel's
// launch begin at once (griddepcontrol.launch_dependents): such a kernel
// waits for this one's end before it reads what it wrote.
template <int NW, int VAR, bool SC16, bool SYNC>
__global__ void __launch_bounds__(max_threads(NW), 1)
q4_fold_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_s,
               const __grid_constant__ CUtensorMap map_m,
               const __grid_constant__ CUtensorMap map_x, const FoldArgs a) {
  constexpr bool PROBE = probe(VAR);
  constexpr bool F32 = f32v(VAR);
  // a stage's bytes a column a q block beside the packed rows (a scale and
  // B9's min)
  constexpr int kSB = stage_sbytes(VAR, SC16);
  // each q block's product into a fresh set z, then scaled into acc: v2
  // and the f32 modes
  constexpr bool ZED = VAR == 2 || F32;
  // the variants that fold a term into registers beside acc (v2 and 11
  // fold straight into acc; v0, 10 and the probes fold nothing)
  constexpr bool FOLD = !PROBE && VAR != 0 && !ZED;
  constexpr int kSteps = VAR == 13 ? 1 : 2;       // k16 steps a q block
  // the x tile sets (the f32 parts apart) and their bytes apart
  constexpr int kSets = x_sets(VAR), kSetBytes = kQB * 2 * NW * 32;
  constexpr int MT = mtiles(NW);
  constexpr int kXWarps = x_warps(NW), kXThreads = 32 * kXWarps;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* basep = smem_raw + (base - raw);
  const Layout L =
      fold_layout(a.wgs, NW, kSB, a.stages, a.xstages, a.splits, kSets);
  const uint32_t full = base + L.bar, empty = full + 8 * a.stages;
  const uint32_t rfull = empty + 8 * a.stages;
  const uint32_t xfull = rfull + 8 * a.xstages;
  const uint32_t xempty = xfull + 8 * a.xstages;
  const uint32_t mfull = xempty + 8 * a.xstages, mfree = mfull + 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cons = 4 * a.wgs, bn = 64 * MT * a.wgs;
  // a box's columns (its row bytes): 128, or 64 where BN is not a multiple
  const int bw = bn % 128 ? 64 : 128;
  const int S = a.splits, rank = (int)hopper::cluster_rank();
  const int cid = blockIdx.x / S, ncl = gridDim.x / S;
  const int st0 = rank * a.sps, st1 = min(a.nst, st0 + a.sps);
  const int qbytes = 16 * kQB * bn, sbytes = kQB * bn * kSB;
  // work item i of every role: tile cid + i / nsp ncl, stage st0 + i % nsp
  const int nsp = st1 - st0;
  const int items = nsp > 0 ? (a.tiles - cid + ncl - 1) / ncl * nsp : 0;

  if (threadIdx.x == 0)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (warp == cons + kXWarps && lane == 0) {
    // the descriptors fetched while the barriers are set up
    hopper::prefetch_map(&map_q);
    if constexpr (!PROBE) hopper::prefetch_map(&map_s);
    if constexpr (minsv(VAR)) hopper::prefetch_map(&map_m);
    hopper::prefetch_map(&map_x);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, cons);
    }
    for (int s = 0; s < a.xstages; ++s) {
      mbar_init(rfull + 8 * s, 1);
      mbar_init(xfull + 8 * s, kXThreads);
      mbar_init(xempty + 8 * s, cons);
    }
    for (int w = 0; w < 4; ++w) {
#ifdef FLTORCH_B15_GLOBAL_MERGE
      mbar_init(mfull + 8 * w, S > 1 ? S - 1 : 1);
#else
      mbar_init(mfull + 8 * w, 1);
#endif
      mbar_init(mfree + 8 * w, 1);
    }
    hopper::mbar_init_fence();
  }
  // the x slots zeroed once: the x warps write rows < M only, so rows
  // M..NW-1 of every tile (and their block sums) stay zero
  for (int i = threadIdx.x; i < a.xstages * L.xst / 16; i += blockDim.x)
    *reinterpret_cast<uint4*>(basep + L.x + 16 * i) = make_uint4(0, 0, 0, 0);
  hopper::fence_proxy_async();
  hopper::cluster_sync();    // every block's barriers exist before use

  if (warp == cons + kXWarps) {              // the weights' producer
    // weights, which no kernel writes: from the start, before the kernel
    // before this one is done
    if (lane == 0) {
      int slot = 0, ph = 0;
      for (int i = 0; i < items; ++i) {
        const int t = cid + i / nsp * ncl, st = st0 + i % nsp;
        mbar_wait(empty + 8 * slot, ph ^ 1);
        const uint32_t dst = base + L.w + slot * L.ws, bar = full + 8 * slot;
        mbar_expect_tx(bar, qbytes + sbytes);
        for (int h = 0; h < bn; h += bw)          // boxes of bw columns
          tma_load_2d(dst + h * 16 * kQB, &map_q, bar, t * bn + h,
                      st * kQB * 16);
        if constexpr (!PROBE)
          tma_load_2d(dst + qbytes, &map_s, bar, t * bn, st * kQB);
        if constexpr (minsv(VAR))    // the mins after the f32 scales
          tma_load_2d(dst + qbytes + kQB * bn * 4, &map_m, bar, t * bn,
                      st * kQB);
        if (++slot == a.stages) { slot = 0; ph ^= 1; }
      }
    }
    __syncwarp();
  } else if (warp == cons + kXWarps + 1) {    // x's producer
    // x, which the kernel before writes: once it is done. x's box is its M
    // rows: rows M..NW-1 of the slot are never read
    if (lane == 0) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      int slot = 0, ph = 0;
      for (int i = 0; i < items; ++i) {
        mbar_wait(xempty + 8 * slot, ph ^ 1);
        const uint32_t bar = rfull + 8 * slot;
        mbar_expect_tx(bar, a.M * 128 * 4);
        tma_load_2d(base + L.x + slot * L.xst, &map_x, bar,
                    (st0 + i % nsp) * kQB * 32, 0);
        if (++slot == a.xstages) { slot = 0; ph ^= 1; }
      }
    }
    __syncwarp();
  } else if (warp >= cons) {                         // the x warps
    // pair u of float4s of a stage's x: row u / 16, q block u / 4 % 4, k
    // quads q = u % 4 (x_lo[4q..4q+3]) and q + 4 (x_hi[4q..4q+3], which v7
    // pairs with them); thread xt takes u = xt + kXThreads j. A thread sums
    // its 8 values (v7: the 4 pair sums R(R(x_lo) + R(x_hi)), in order) and
    // the 4 lanes of one row's q block add theirs by shuffles (lanes ^ 1,
    // ^ 2). (A float4 a thread, 8 lanes and 3 shuffles a q block, and v7's
    // pairs one shuffle apart, made the x warps the pace setter at M > 32:
    // 1.2-1.4x the time at M = 33 and 64, tools_torch/b15_sweep.py.)
    constexpr int kJ = NW * 16 / kXThreads;
    const int xt = threadIdx.x - 32 * cons, units = a.M * 16;
    int slot = 0, ph = 0;
    for (int i = 0; i < items; ++i) {
      {
        mbar_wait(rfull + 8 * slot, ph);     // the stage's x landed
        const float* xraw =
            reinterpret_cast<const float*>(basep + L.x + slot * L.xst);
        uint8_t* xs = basep + L.x + slot * L.xst + L.xr;
        float* bs = reinterpret_cast<float*>(xs + L.xt);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int u = xt + kXThreads * j;
          const int r = u >> 4, b = (u >> 2) & 3, q = u & 3;
          const float* src = xraw + r * 128 + 32 * b + 4 * q;
          // element (k, row r) of k16 tile (b, s): core matrix (r / 8, k %
          // 16 / 8) 256 and 128 bytes apart, row r % 8 16 bytes apart;
          // quad q + 4 at the same place of tile (b, 1)
          uint8_t* dst = xs + 2 * b * NW * 32 + (r >> 3) * 256 +
                         ((q >> 1) & 1) * 128 + (r & 7) * 16 + (q & 1) * 8;
          const float4 v = *reinterpret_cast<const float4*>(src);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
          if constexpr (VAR == 13) {
            // B13 reads x_lo's tile (b, 0) alone, and no block sum
            if (u < units)
              *reinterpret_cast<uint2*>(dst) = make_uint2(bits(lo), bits(hi));
            continue;
          }
          const float4 w = *reinterpret_cast<const float4*>(src + 16);
          const __nv_bfloat162 lo4 = __floats2bfloat162_rn(w.x, w.y);
          const __nv_bfloat162 hi4 = __floats2bfloat162_rn(w.z, w.w);
          if constexpr (F32) {
            // the three parts of each value: part p in set p
            const float e[8] = {v.x, v.y, v.z, v.w, w.x, w.y, w.z, w.w};
            uint32_t pt[8][3];
#pragma unroll
            for (int c = 0; c < 8; ++c) f32_parts(e[c], pt[c]);
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              uint8_t* dp = dst + p * kSetBytes;
              if (u < units) {
                *reinterpret_cast<uint2*>(dp) = make_uint2(
                    hi2(pt[0][p], pt[1][p]), hi2(pt[2][p], pt[3][p]));
                *reinterpret_cast<uint2*>(dp + NW * 32) = make_uint2(
                    hi2(pt[4][p], pt[5][p]), hi2(pt[6][p], pt[7][p]));
              }
            }
          } else if (u < units) {
            *reinterpret_cast<uint2*>(dst) = make_uint2(bits(lo), bits(hi));
            *reinterpret_cast<uint2*>(dst + NW * 32) =
                make_uint2(bits(lo4), bits(hi4));
          }
          if constexpr (VAR == 14 || VAR == 0 || VAR == 10) continue;  // no sums
          float sum;
          if constexpr (VAR == 7) {
            // one bf16x2 add rounds the exact pair sum once, as the plain
            // version's f32 sum and rounding do (f32's 24 bits hold twice
            // bf16's 8 and one more: double rounding is innocuous)
            const float2 s01 = __bfloat1622float2(__hadd2(lo, lo4));
            const float2 s23 = __bfloat1622float2(__hadd2(hi, hi4));
            sum = ((s01.x + s01.y) + s23.x) + s23.y;
          } else {
            sum = ((v.x + v.y) + (v.z + v.w)) + ((w.x + w.y) + (w.z + w.w));
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          if (u < units && q == 0) bs[b * NW + r] = sum;
        }
        hopper::fence_proxy_async();
        mbar_arrive(xfull + 8 * slot);
        if (++slot == a.xstages) { slot = 0; ph ^= 1; }
      }
    }
  } else {                                           // the consumers
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;
    const int tid = threadIdx.x & 127;
    // the lane's 2 MT adjacent columns of the tile from c0: m-tile mt's A
    // rows g and g + 8 of its warp's 16 are columns c0 + 2 mt and + 1; the
    // byte offsets of its packed rows 2t, 2t+1, 2t+8, 2t+9 in the stage's
    // first q block, in its 128- (or 64-) column box as the tensor copy
    // swizzles it (16-byte chunk ^ row % 8 for 128-byte rows, ^ row / 2 % 4
    // for 64), one 2 MT-byte load each
    const int c0 = 64 * MT * wg + 16 * MT * w + 2 * MT * g;
    int roff[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 2 * t4 + (j & 1) + 8 * (j >> 1), cb = c0 % bw;
      const int sw = bw == 128 ? (r & 7) : ((r >> 1) & 3);
      roff[j] = (c0 / bw) * 16 * kQB * bw + r * bw + (((cb >> 4) ^ sw) << 4) +
                (cb & 15);
    }
    // v2 takes each q block's product of the codes into a fresh set z,
    // then adds it to acc scaled by d, and the fold straight into acc; the
    // others keep the fold apart in `fold`, since a wgmma in flight owns
    // acc (v0 and the probes have none). acc's order, every variant: each
    // q block's fold, then its product
    float acc[MT][NW / 2], fold[MT][NW / 2], z[MT][NW / 2] = {};
    float dp[2 * MT];     // v2: the scales of the q block whose z is pending
    uint32_t afr[2][MT][8] = {};
    // a warp releases a stage's weight and x slots by one arrival each
    // (lane 0) once its reads and products of them are done (the products
    // and their waits are warp-wide, so every lane's reads are); pw, px:
    // the slots whose last products are still in flight (-1: none)
    int slot = 0, ph = 0, xslot = 0, xph = 0, pw = -1, px = -1, mph = 0;
    auto release = [&](int w, int x) {
      mbar_arrive_if(empty + 8 * (w < 0 ? 0 : w), lane == 0 && w >= 0);
      mbar_arrive_if(xempty + 8 * (x < 0 ? 0 : x), lane == 0 && x >= 0);
    };
    // the fold of a q block (its scales d, or v9's mins, its block sums
    // bsb) into dst: register 4j + c of m-tile mt is x row 8j + 2t + c % 2
    // and column c0 + 2 mt + c / 2; the term bsum (-8 d), or v9's bsum m
    auto add_fold = [&](float (&dst)[MT][NW / 2], const float* bsb,
                        const float* d) {
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(bsb + 8 * j + 2 * t4);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float p0 = minsv(VAR) ? d[2 * mt] : -8.f * d[2 * mt];
          const float p1 = minsv(VAR) ? d[2 * mt + 1] : -8.f * d[2 * mt + 1];
          float* f = dst[mt] + 4 * j;
          f[0] = __fmaf_rn(bv.x, p0, f[0]);
          f[1] = __fmaf_rn(bv.y, p0, f[1]);
          f[2] = __fmaf_rn(bv.x, p1, f[2]);
          f[3] = __fmaf_rn(bv.y, p1, f[3]);
        }
      }
    };
    // v2: acc += z d, each D register by its column's scale
    auto add_scaled = [&](float (&zz)[MT][NW / 2], const float* d) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NW / 2; ++i)
          acc[mt][i] = __fmaf_rn(zz[mt][i], d[2 * mt + ((i >> 1) & 1)],
                                 acc[mt][i]);
    };
    for (int t = cid; t < a.tiles; t += ncl) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) {
          acc[mt][i] = 0.f;
          fold[mt][i] = 0.f;
        }
      // the tile's first q block has no product pending: z, zeroed after
      // the tile before's last scale, is added times 0
#pragma unroll
      for (int c = 0; c < 2 * MT; ++c) dp[c] = 0.f;
      for (int st = st0; st < st1; ++st) {
        mbar_wait(full + 8 * slot, ph);
        mbar_wait(xfull + 8 * xslot, xph);
        const uint8_t* wsl = basep + L.w + slot * L.ws;
        const uint8_t* sc = wsl + qbytes;
        const uint8_t* xs = basep + L.x + xslot * L.xst + L.xr;
        const uint32_t xs_s = base + L.x + xslot * L.xst + L.xr;
        const float* bs = reinterpret_cast<const float*>(xs + L.xt);
#pragma unroll
        for (int b = 0; b < kQB; ++b) {
          uint32_t (&A)[MT][8] = afr[b & 1];
          const uint8_t* slab = wsl + b * 16 * bw;
          uint32_t rw[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            rw[j] = MT == 2
                        ? *reinterpret_cast<const uint32_t*>(slab + roff[j])
                        : lds_u16(slab + roff[j]);
          float d[2 * MT] = {};
#pragma unroll
          for (int c = 0; c < MT && !PROBE; ++c) {
            float2 f;
            if constexpr (SC16)
              f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  sc + (b * bn + c0 + 2 * c) * 2));
            else
              f = *reinterpret_cast<const float2*>(
                  sc + (b * bn + c0 + 2 * c) * 4);
            d[2 * c] = f.x;
            d[2 * c + 1] = f.y;
          }
          float mn[2 * MT] = {};      // v9: the mins, after the f32 scales
#pragma unroll
          for (int c = 0; c < MT && minsv(VAR); ++c) {
            const float2 f = *reinterpret_cast<const float2*>(
                sc + kQB * bn * 4 + (b * bn + c0 + 2 * c) * 4);
            mn[2 * c] = f.x;
            mn[2 * c + 1] = f.y;
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // m-tile mt's bytes of rows (2t, 2t+1) and (2t+8, 2t+9)
            const uint32_t sel = mt ? 0x7632 : 0x5410;
            const uint32_t w01 = __byte_perm(rw[0], rw[1], sel);
            const uint32_t w23 = __byte_perm(rw[2], rw[3], sel);
            if constexpr (VAR == 13) {
              // the whole bytes, one k16 step
              dequant<1>(w01, w23, 1.f, 1.f, A[mt]);
            } else {
              // B14 and 11: v2's codes
              constexpr int kDq = VAR == 14 || VAR == 11 ? 2 : VAR;
              dequant<kDq>(w01 & 0x0F0F0F0Fu, w23 & 0x0F0F0F0Fu, d[2 * mt],
                           d[2 * mt + 1], A[mt]);
              dequant<kDq>((w01 >> 4) & 0x0F0F0F0Fu,
                           (w23 >> 4) & 0x0F0F0F0Fu, d[2 * mt],
                           d[2 * mt + 1], A[mt] + 4);
            }
          }
          if constexpr (FOLD)
            add_fold(fold, bs + b * NW, VAR == 9 ? mn : d);
          if constexpr (SYNC) {
            // B fragment: x rows g, k 2t, 2t + 1 (and + 8) of tile (b, s)
            // of each set
            const uint8_t* xb = xs + 2 * b * NW * 32 + g * 16 + 4 * t4;
#pragma unroll
            for (int s = 0; s < kSteps; ++s)
#pragma unroll
              for (int p = 0; p < kSets; ++p) {
                const uint8_t* xp = xb + p * kSetBytes + s * NW * 32;
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xp);
                const uint32_t b1 =
                    *reinterpret_cast<const uint32_t*>(xp + 128);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                  if constexpr (!ZED)
                    mma_bf16(acc[mt], A[mt] + 4 * s, b0, b1);
                  else if (s == 0 && p == 0)
                    mma_bf16_new(z[mt], A[mt], b0, b1);
                  else
                    mma_bf16(z[mt], A[mt] + 4 * s, b0, b1);
                }
              }
            if constexpr (ZED) {
              if constexpr (VAR != 10)
                add_fold(acc, bs + b * NW, VAR == 11 ? mn : d);
              add_scaled(z, d);
            }
          } else {
            // v2's and the f32 modes' product of block b into z, the
            // others' into acc
            float (&D)[MT][NW / 2] = ZED ? z : acc;
            if constexpr (ZED) {
              // block b - 1's product done before block b's issue
              wgmma_wait<0>();
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                fence_regs<NW / 2>(z[mt]);
                keep(afr[(b + 1) & 1][mt]);
              }
              add_scaled(z, dp);
              if constexpr (VAR != 10)
                add_fold(acc, bs + b * NW, VAR == 11 ? mn : d);
#pragma unroll
              for (int c = 0; c < 2 * MT; ++c) dp[c] = d[c];
              if (b == 0) {
                release(pw, px);
                pw = px = -1;
              }
            }
            // every input of the products (the A registers, the
            // descriptors; D untouched) set before their pipeline stage
            // opens: the compiler would otherwise compute the second
            // step's between the two issues, and ptxas then serializes
            uint64_t dsc[kSteps * kSets];
#pragma unroll
            for (int s = 0; s < kSteps; ++s)
#pragma unroll
              for (int p = 0; p < kSets; ++p) {
                uint64_t& ds = dsc[s * kSets + p];
                ds = hopper::plain_desc(
                    xs_s + p * kSetBytes + (2 * b + s) * NW * 32, 128, 256);
                asm volatile("" : "+l"(ds)::"memory");
              }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              keep(A[mt]);
              fence_regs<NW / 2>(D[mt]);
            }
            wgmma_fence();
            // z starts afresh each block (scale-d 0 on its first product)
#pragma unroll
            for (int s = 0; s < kSteps; ++s)
#pragma unroll
              for (int p = 0; p < kSets; ++p)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                  WgmmaRs<NW>::run(D[mt], A[mt] + 4 * s, dsc[s * kSets + p],
                                   ZED && s == 0 && p == 0 ? 0 : 1);
            wgmma_commit();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) fence_regs<NW / 2>(D[mt]);
            if constexpr (!ZED) {
              wgmma_wait<1>();     // q block b - 1's products are done
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) keep(afr[(b + 1) & 1][mt]);
              if (b == 0) {
                release(pw, px);
                pw = px = -1;
              }
            }
          }
        }
        if constexpr (SYNC) {
          release(slot, xslot);
        } else {
          pw = slot;
          px = xslot;
        }
        if (++slot == a.stages) { slot = 0; ph ^= 1; }
        if (++xslot == a.xstages) { xslot = 0; xph ^= 1; }
      }
      if constexpr (!SYNC) {
        wgmma_wait<0>();
        float (&D)[MT][NW / 2] = ZED ? z : acc;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          fence_regs<NW / 2>(D[mt]);
          keep(afr[0][mt]);
          keep(afr[1][mt]);
        }
        release(pw, px);
        pw = px = -1;
        if constexpr (ZED) {
          add_scaled(D, dp);
          // a non-finite z (an inf or NaN row) times the next tile's first
          // 0 would be NaN there
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < NW / 2; ++i) z[mt][i] = 0.f;
        }
      }
      if constexpr (FOLD) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < NW / 2; ++i) acc[mt][i] += fold[mt][i];
      }

      if (S > 1) {
        // the warpgroup's partial, register i of m-tile mt of thread tid at
        // (mt NW / 2 + i) 128 + tid: a sender's from the first of its merge
        // slots, the leader's S - 1 received in the slots (z - 1) wgs + wg
        constexpr int kP = 64 * MT * NW * 4;
#ifdef FLTORCH_B15_GLOBAL_MERGE
        const size_t gw = kP / 4 * (size_t)a.wgs;      // floats a block
        if (rank != 0) {
          mbar_wait(mfree + 8 * wg, mph ^ 1);
          float* mine = a.scratch + blockIdx.x * gw + wg * (kP / 4);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < NW / 2; ++i)
              __stcg(mine + (mt * NW / 2 + i) * 128 + tid, acc[mt][i]);
          __threadfence();
          wg_sync(wg);
          if (tid == 0)
            hopper::mbar_arrive_cluster(hopper::mapa(mfull + 8 * wg, 0));
          mph ^= 1;
          continue;
        }
        mbar_wait(mfull + 8 * wg, mph);
        for (int z = 1; z < S; ++z) {
          const float* part = a.scratch + (blockIdx.x + z) * gw + wg * (kP / 4);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < NW / 2; ++i)
              acc[mt][i] += __ldcg(part + (mt * NW / 2 + i) * 128 + tid);
        }
#else
        if (rank != 0) {
          mbar_wait(mfree + 8 * wg, mph ^ 1);
          float* mine = reinterpret_cast<float*>(basep + L.m + wg * kP);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < NW / 2; ++i)
              mine[(mt * NW / 2 + i) * 128 + tid] = acc[mt][i];
          hopper::fence_proxy_async();
          wg_sync(wg);
          if (tid == 0)
            hopper::bulk_copy_cluster(
                hopper::mapa(base + L.m + ((rank - 1) * a.wgs + wg) * kP, 0),
                base + L.m + wg * kP, kP, hopper::mapa(mfull + 8 * wg, 0));
          mph ^= 1;
          continue;
        }
        if (tid == 0) mbar_expect_tx(mfull + 8 * wg, (S - 1) * kP);
        mbar_wait(mfull + 8 * wg, mph);
        for (int z = 1; z < S; ++z) {
          const float* part = reinterpret_cast<const float*>(
              basep + L.m + ((z - 1) * a.wgs + wg) * kP);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < NW / 2; ++i)
              acc[mt][i] += part[(mt * NW / 2 + i) * 128 + tid];
        }
#endif
        wg_sync(wg);
        if (tid == 0)
          for (int z = 1; z < S; ++z)
            hopper::mbar_arrive_cluster(hopper::mapa(mfree + 8 * wg, z));
        mph ^= 1;
      }

      // D register 4j + c of m-tile mt: x row 8j + 2t + c % 2, column
      // c0 + 2 mt + c / 2
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int n = t * bn + c0 + 2 * mt;
        const bool pairs = (a.n_out & 1) == 0 && n + 1 < a.n_out;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int m = 8 * j + 2 * t4 + c;
            if (m >= a.M) continue;
            float* yr = a.y + (size_t)m * a.n_out;
            const float v0 = acc[mt][4 * j + c], v1 = acc[mt][4 * j + 2 + c];
            if (pairs) {
              *reinterpret_cast<float2*>(yr + n) = make_float2(v0, v1);
            } else {
              if (n < a.n_out) yr[n] = v0;
              if (n + 1 < a.n_out) yr[n + 1] = v1;
            }
          }
        }
      }
    }
  }
  hopper::cluster_sync();    // no block leaves while a copy or an arrival
                             // still reaches it
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int NW, int VAR, bool SC16, bool SYNC>
int launch_fold(const FoldArgs& a, const void* x, const void* qs,
                const void* scales, const void* mins, int clusters,
                cudaStream_t stream) {
  auto* kern = q4_fold_kernel<NW, VAR, SC16, SYNC>;
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int bn = 64 * mtiles(NW) * a.wgs, bw = bn % 128 ? 64 : 128;
  // the probes have no scale plane and only B9 (9, 11) a mins plane: a
  // map of none is never read
  CUtensorMap map_q, map_s = {}, map_m = {}, map_x;
  if (!hopper::make_map(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.M,
                        a.Kx, 128, a.M, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper::make_map(&map_q, qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                        a.NB * 16, a.N, bw, 16 * kQB,
                        bw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : CU_TENSOR_MAP_SWIZZLE_64B) ||
      (!probe(VAR) &&
       !hopper::make_map(&map_s, scales,
                         SC16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         SC16 ? 2 : 4, a.NB, a.N, bn, kQB,
                         CU_TENSOR_MAP_SWIZZLE_NONE)) ||
      (minsv(VAR) &&
       !hopper::make_map(&map_m, mins, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                         a.NB, a.N, bn, kQB, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  // clusters of S blocks (none where S = 1), launched as a programmatic
  // dependent of the kernel before
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * a.splits);
  cfg.blockDim = dim3(128 * a.wgs + 32 * x_warps(NW) + 64);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
#ifdef FLTORCH_B15_NO_PDL
  attr[0].val.programmaticStreamSerializationAllowed = 0;
#else
  attr[0].val.programmaticStreamSerializationAllowed = 1;
#endif
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = a.splits;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 2 : 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, map_q, map_s, map_m, map_x, a);
}

template <int VAR, bool SC16>
int dispatch_rows(const FoldArgs& a, const void* x, const void* qs,
                  const void* scales, const void* mins, int clusters,
                  int sync, cudaStream_t s) {
#define FLTORCH_B15_LAUNCH(NW, SYNC)                                         \
  launch_fold<NW, VAR, SC16, SYNC>(a, x, qs, scales, mins, clusters, s)
  // the f32 modes are built to NW 32 only: above it B5's f32 mode takes
  // their calls (q4_matmul.f32_on_b5)
#define FLTORCH_B15_WIDE(NW)                                                 \
  if constexpr (f32v(VAR)) return (int)cudaErrorInvalidValue;                 \
  else return FLTORCH_B15_LAUNCH(NW, false)
  switch ((a.M + 7) / 8) {
    case 1:
      return sync ? FLTORCH_B15_LAUNCH(8, true)
                  : FLTORCH_B15_LAUNCH(8, false);
    case 2: return FLTORCH_B15_LAUNCH(16, false);
    case 3: return FLTORCH_B15_LAUNCH(24, false);
    case 4: return FLTORCH_B15_LAUNCH(32, false);
    case 5: FLTORCH_B15_WIDE(40);
    case 6: FLTORCH_B15_WIDE(48);
    case 7: FLTORCH_B15_WIDE(56);
    case 8: FLTORCH_B15_WIDE(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLTORCH_B15_WIDE
#undef FLTORCH_B15_LAUNCH
}

// The entry of variant VAR (0: B1, 1: B15, 2: B16, 3: B17, 7: B18, 9: B9,
// 10: B1 in f32 mode, 11: B9 in f32 mode, 13: B13, 14: B14; another variant
// is refused): q4_fold_gemm's contract (q4_fold.cu); the probes take no
// scales (sc16 must be 0; `scales` is not read); 9 and 11 take f32 scales
// and the mins plane, the others no mins (null); 10 f32 scales; 10 and 11
// take M <= 32.
template <int VAR>
int fold_gemm(const void* x, int M, int Kx, const void* qs,
              const void* scales, const void* mins, int sc16, int N, int NB,
              int variant, int wgs, int stages, int xstages, int splits,
              int sps, int clusters, int sync, void* y, int n_out,
              void* scratch, void* stream) {
  const int nst = (NB + kQB - 1) / kQB, nw = (M + 7) / 8 * 8;
  if (M < 1 || M > (f32v(VAR) ? 32 : 64) || Kx < 4 || Kx % 4 || Kx > 32 * NB ||
      reinterpret_cast<uintptr_t>(x) % 16 || N % 16 || n_out > N ||
      wgs < 1 || wgs > 2 || stages < 2 || xstages < 2 ||
      xstages > stages || splits < 1 || splits > 8 ||
      sps < 1 || (splits - 1) * sps >= nst || splits * sps < nst ||
      clusters < 1 || (sync && M > 8) || variant != VAR ||
      ((probe(VAR) || minsv(VAR) || f32v(VAR)) && sc16) ||
      minsv(VAR) != (mins != nullptr) ||
      (mins != nullptr && reinterpret_cast<uintptr_t>(mins) % 16) ||
      fold_layout(wgs, nw, stage_sbytes(VAR, sc16), stages, xstages,
                  splits, x_sets(VAR)).total + 1024 > kSmem)
    return (int)cudaErrorInvalidValue;
  FoldArgs a;
  a.y = (float*)y;
  a.scratch = (float*)scratch;
  a.M = M;
  a.Kx = Kx;
  a.N = N;
  a.NB = NB;
  a.n_out = n_out;
  a.wgs = wgs;
  a.stages = stages;
  a.xstages = xstages;
  a.splits = splits;
  a.sps = sps;
  a.nst = nst;
  const int bn = 64 * mtiles(nw) * wgs;
  a.tiles = (N + bn - 1) / bn;
  cudaStream_t s = (cudaStream_t)stream;
  // no SC16 build of the probes (they read no scales), of B9 (q4_1's
  // scales are f32) or of the f32 modes
  if constexpr (probe(VAR) || minsv(VAR) || f32v(VAR))
    return dispatch_rows<VAR, false>(a, x, qs, scales, mins, clusters, sync,
                                     s);
  else
    return sc16 ? dispatch_rows<VAR, true>(a, x, qs, scales, mins, clusters,
                                           sync, s)
                : dispatch_rows<VAR, false>(a, x, qs, scales, mins, clusters,
                                            sync, s);
}


}  // namespace

