// Kernel B5: the bf16 / f32 prefill matmul over a q4_0 or q4_1 weight.
//
// Replaces fastllama_tpu/kernels/q4_matmul.py::q4_matmul_prefill_pallas
// (variant nat, _q4mm_prefill_nat_kernel):
//   y[M, n_out] f32 = R(x[M, K]) @ R(W)      f32 accumulation
// with W = (q - 8) * d (q4_0) or, the affine variant, W = q * d + m (q4_1,
// the function q4_matmul_xla computes for such a weight at M > 64), where R
// rounds to bf16 in bf16 mode and is the identity in f32 mode. Each weight
// is __fmul_rn((q - 8), d) or __fadd_rn(__fmul_rn(q, d), m) (no contraction
// into an FMA), rounded once: bit for bit the plain version's
// dequant_matmul_weight. Products of two bf16 values are exact in f32, so
// only the f32 summation order of y differs from a dense matmul. x past its
// own K counts as zero, so the caller never pads it.
//
// Bound on the H100: operations at M = 512 (2 * M * N * K against ~0.6
// bytes of weight an element, above the bf16 ridge of ~295 operations a
// byte), the weight bytes from M ~ 64 to ~128. No [N, K] plane goes
// through HBM.
//
// bf16 mode, two launches: cast_kernel (R(x) as a bf16 [M, K] plane with
// zeros past x's K: TMA copies bytes, so the B operand has to be bf16 in
// global memory), then the register-A kernel of q4_prefill_ra.cuh in its
// q4_0 or q4_1 mode (built here; each weight dequantized straight into the
// A registers of wgmma, x the B operand; the design is described there).
//
// Kernel B20, the split mode (bf16 only; entry q4_prefill_split_gemm):
// replaces fastllama_tpu/kernels/q4_matmul.py::_q4mm_prefill_kernel, the
// body of q4_matmul_prefill_pallas(variant="split"), v1's folded offset at
// prefill M:
//   y = R(x) @ R(q * d) - 8 * bsum(x) @ d      f32 accumulation
// with q the code 0..15 (no -8 in the weight) and bsum(x) [K/32, M] the f32
// sum of the caller's unrounded x over each q block. Two launches: the
// cast pass, which also makes the fold's A operand from bsum (the JAX
// package makes bsum with XLA before its kernel), and bf16_wgmma_kernel:
// persistent, one block an SM walking over work items (a 128 x 128 output
// tile and a run of its K stages, 64 deep), warp-specialized:
//   * one producer thread keeps a ring of 4 stages in flight with TMA: the
//     x tile (128-byte swizzle), the stage's q4 bytes [32, 128] exactly as
//     stored, its scale rows [2, 128] f32 and, by a bulk copy, its fold A
//     tile; zeros past M, N and K;
//   * 8 converter warps write R(__fmul_rn(q, d)) of each stage as a bf16
//     [64, 128] tile in the layout wgmma reads as an MN-major B operand
//     (atoms of 8 K rows by 64 columns, 128 bytes a row, 16-byte chunks
//     swizzled by row; a thread 4 adjacent columns of 4 packed rows),
//     fenced to the async proxy before the stage's barrier;
//   * two consumer warpgroups of 64 rows issue wgmma.mma_async m64n128k16
//     f32 += bf16 x bf16 (A K-major from the x tile, B MN-major from the
//     converted tile), four a stage and the fold as a fifth k16 slice on
//     the tensor cores, into the same f32 accumulators; a stage is
//     released once the next stage's products are in flight.
// Where the tiles alone leave SMs idle, K is split (b5_plan): each split
// stores its partial tile to scratch, and the last to finish a tile,
// elected by a counter it resets, sums the partials in split order
// (deterministic, no atomic adds on y).
// The TPU runs the fold as a dot at Precision.HIGHEST (bf16 multi-pass
// products); here v = bsum and w = -8 d (exact) are each split into three
// bf16 parts, v = h + m + l (rounded) and w = H + M + L (truncated), exact
// in the normal range: each part takes the next 8 of f32's 24 significant
// bits. A stage's
// fold slice holds, for each of its two q blocks, 8 of the 9 part products
// (hH, hM, mH, hL, mM, lH, mL, lM; lL, below 2^-31 |v w|, is left out):
// every one exact in f32 (8 x 8 significant bits), summed in f32 by the
// tensor cores. The fold's error is thus f32 summation error, as a HIGHEST
// dot's; the CPU tests hold a model of it against the JAX body. Its A
// operand [128 rows][16 slots] a stage (K-major, no swizzle) is written by
// the cast pass, in the layout the slice reads, and staged by a bulk copy;
// its B operand, 16 more K rows of the converted tile, by two fold warps
// from the stage's scale rows, beside the converters (written by the
// converters, both operands cost more; PERF.md). An A fragment in
// registers made ptxas serialize the wgmmas: a stage's register set must
// outlive the next stage's issue, which took a branch. A K split folds
// its own stages' blocks, so each output gains the fold once, in the
// deterministic split merge. In f32 mode the function is x @ ((q - 8) * d)
// in exact arithmetic, so the port runs B5's f32 mode there
// (kernels/q4_variants.py).
//
// f32 mode, two launches: cast3_kernel (x's three exact bf16 parts as
// three bf16 planes [3][M][K], zeros past x's K, and for q4_1 the f32
// block sums of x) and the register-A kernel of q4_prefill_ra.cuh in its
// f32 mode (the codes in wgmma's A registers, each part's products into a
// fresh set z a q block, z scaled by d into the f32 accumulators: no TF32,
// every product exact; the design is described there).

#include "common.cuh"
#include "hopper.cuh"
#include "q4_prefill_ra.cuh"

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

// B20's weight, q * d (the offset folded back by the fold slice), of the
// code q (0..15) in the low byte of 2^23's bit pattern: 2^23 + q is exact,
// so is subtracting 2^23; then the product with d, rounded once in f32 as
// the plain version's.
__device__ __forceinline__ float weight(uint32_t magic_q, float d) {
  return __fmul_rn(__fadd_rn(__uint_as_float(magic_q), -8388608.0f), d);
}

// The four weights of the codes in the four bytes of `nib` (each 0..15),
// columns c..c+3 with scales d.
__device__ __forceinline__ float4 weights4(uint32_t nib, float4 d) {
  return make_float4(weight(__byte_perm(nib, 0x4B000000u, 0x7440), d.x),
                     weight(__byte_perm(nib, 0x4B000000u, 0x7441), d.y),
                     weight(__byte_perm(nib, 0x4B000000u, 0x7442), d.z),
                     weight(__byte_perm(nib, 0x4B000000u, 0x7443), d.w));
}

__device__ __forceinline__ uint2 pack_bf16x4(float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                    *reinterpret_cast<const uint32_t*>(&b));
}

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 4;
constexpr int kFoldRows = 16;                    // B20: two q blocks of 8 slots
constexpr int kFoldBBytes = kFoldRows * kBN * 2; // the fold's B rows
constexpr int kFoldABytes = kBM * kFoldRows * 2; // and its A tile, a stage

// B20's fold slice: slot j (0..7) of a q block pairs part kFoldA[j] of v =
// bsum with part kFoldB[j] of w = -8 d (0 the high part, 1 the middle, 2
// the low), two bits a slot: (h, H), (h, M), (m, H), (h, L), (m, M),
// (l, H), (m, L), (l, M).
constexpr uint32_t kFoldA = 0x9910, kFoldB = 0x6184;

__device__ __forceinline__ int fold_part(uint32_t parts, int slot) {
  return (parts >> (2 * slot)) & 3;
}

// Part `part` (0 high, 1 middle, 2 low) of v's three bf16 parts, v = h +
// m + l: h = R(v), m = R(v - h), l = R(v - h - m) (the differences exact).
__device__ __forceinline__ float split3(float v, int part) {
  const float h = __bfloat162float(__float2bfloat16_rn(v));
  const float m = __bfloat162float(__float2bfloat16_rn(v - h));
  const float l = __bfloat162float(__float2bfloat16_rn((v - h) - m));
  return part == 0 ? h : part == 1 ? m : l;
}

// The three bf16 parts of w = -8 d (exact) for 4 columns, by truncation:
// H keeps the top 16 bits of w's pattern (8 significant bits), M those of
// the exact rest w - H, and L = w - H - M has at most 8 significant bits
// left, so w = H + M + L exactly. Each part as the packed pairs of columns
// (0, 1) and (2, 3).
__device__ __forceinline__ void fold_weight_parts(float4 d, uint2* part) {
  const float w[4] = {-8.f * d.x, -8.f * d.y, -8.f * d.z, -8.f * d.w};
  uint32_t p[3][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t h = __float_as_uint(w[c]) & 0xFFFF0000u;
    const float r = w[c] - __uint_as_float(h);
    const uint32_t m = __float_as_uint(r) & 0xFFFF0000u;
    p[0][c] = h;
    p[1][c] = m;
    p[2][c] = __float_as_uint(r - __uint_as_float(m));
  }
#pragma unroll
  for (int pt = 0; pt < 3; ++pt)
    part[pt] = make_uint2(__byte_perm(p[pt][0], p[pt][1], 0x7632),
                          __byte_perm(p[pt][2], p[pt][3], 0x7632));
}

// ---------------------------------------------------------------------------
// 1. activation cast (bf16 mode)
// ---------------------------------------------------------------------------

// xb[m, k] = bf16(x[m, k]) for k < Kx, 0 for Kx <= k < K; four elements a
// thread (Kx and K multiples of 4). FOLD (B20): also the fold's A operand
// fa: for row m and q block b, the f32 sum v of x[m, 32 b .. 32 b + 31]
// (zero past Kx; a thread sums its four, then the 8 threads of the block,
// 8 consecutive lanes as K / 4 is a multiple of 8, by shuffles: a group of
// 8 lies wholly past M * K / 4 or not at all) as its 8 slots, the kFoldA
// parts of v, 16 bytes at fold_a_off(m, b, nks); a last block of even
// index also zeroes the stage's other half.
__device__ __forceinline__ size_t fold_a_off(int m, int b, int nks) {
  return ((size_t)(m >> 7) * nks + (b >> 1)) * kFoldABytes +
         (((m & 127) >> 3) * 2 + (b & 1)) * 128 + (m & 7) * 16;
}

template <bool FOLD>
__global__ void cast_kernel(const float* __restrict__ x, int M, int Kx, int K,
                            __nv_bfloat16* __restrict__ xb,
                            uint8_t* __restrict__ fa) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int quads = K / 4;
  if (i >= (size_t)M * quads) return;
  const int m = (int)(i / quads), k = 4 * (int)(i - (size_t)m * quads);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k < Kx) v = *reinterpret_cast<const float4*>(x + (size_t)m * Kx + k);
  *reinterpret_cast<uint2*>(xb + (size_t)m * K + k) = pack_bf16x4(v);
  if constexpr (FOLD) {
    const unsigned grp = 0xFFu << (threadIdx.x & 24);
    float sum = ((v.x + v.y) + v.z) + v.w;
    sum += __shfl_xor_sync(grp, sum, 1);
    sum += __shfl_xor_sync(grp, sum, 2);
    sum += __shfl_xor_sync(grp, sum, 4);
    if ((threadIdx.x & 7) == 0) {
      const int b = k / 32, nks = (K + kBK - 1) / kBK;
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = split3(sum, fold_part(kFoldA, j));
      const uint2 lo = pack_bf16x4(make_float4(f[0], f[1], f[2], f[3]));
      const uint2 hi = pack_bf16x4(make_float4(f[4], f[5], f[6], f[7]));
      *reinterpret_cast<uint4*>(fa + fold_a_off(m, b, nks)) =
          make_uint4(lo.x, lo.y, hi.x, hi.y);
      if ((b & 1) == 0 && b + 1 == K / 32)
        *reinterpret_cast<uint4*>(fa + fold_a_off(m, b + 1, nks)) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// f32 mode's cast: xp[p][m, k] = part p of x[m, k] (fltorch::f32_parts) for
// k < Kx, 0 for Kx <= k < K; four elements a thread. SUMS (q4_1): also
// bs[b mr + m], the f32 sum of x[m, 32 b .. 32 b + 31] (zero past Kx; the
// 8 threads of a q block add theirs by shuffles, as cast_kernel's FOLD);
// where K / 32 is odd, its last block's even-index group also zeroes the
// stage's other row.
template <bool SUMS>
__global__ void cast3_kernel(const float* __restrict__ x, int M, int Kx,
                             int K, __nv_bfloat16* __restrict__ xp,
                             float* __restrict__ bs, int mr) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int quads = K / 4;
  if (i >= (size_t)M * quads) return;
  const int m = (int)(i / quads), k = 4 * (int)(i - (size_t)m * quads);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k < Kx) v = *reinterpret_cast<const float4*>(x + (size_t)m * Kx + k);
  uint32_t p[4][3];
  fltorch::f32_parts(v.x, p[0]);
  fltorch::f32_parts(v.y, p[1]);
  fltorch::f32_parts(v.z, p[2]);
  fltorch::f32_parts(v.w, p[3]);
  const size_t plane = (size_t)M * K;
#pragma unroll
  for (int pt = 0; pt < 3; ++pt)
    *reinterpret_cast<uint2*>(xp + pt * plane + (size_t)m * K + k) =
        make_uint2(fltorch::hi2(p[0][pt], p[1][pt]),
                   fltorch::hi2(p[2][pt], p[3][pt]));
  if constexpr (SUMS) {
    const unsigned grp = 0xFFu << (threadIdx.x & 24);
    float sum = ((v.x + v.y) + v.z) + v.w;
    sum += __shfl_xor_sync(grp, sum, 1);
    sum += __shfl_xor_sync(grp, sum, 2);
    sum += __shfl_xor_sync(grp, sum, 4);
    if ((threadIdx.x & 7) == 0) {
      const int b = k / 32;
      bs[(size_t)b * mr + m] = sum;
      if ((b & 1) == 0 && b + 1 == K / 32) bs[(size_t)(b + 1) * mr + m] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. B20: the bf16 product on wgmma, the weight dequantized in shared memory
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kConsThreads = 128 * kConsumers;
constexpr int kConvWarps = 8;
constexpr int kConvThreads = 32 * kConvWarps;
constexpr int kXBytes = kBM * kBK * 2;           // x tile, K-major
constexpr int kWBytes = kBK * kBN * 2;           // converted weight tile
constexpr int kQBytes = kBK / 2 * kBN;           // q4 bytes as stored
constexpr int kSBytes = kBK / 32 * kBN * 4;      // scale rows
constexpr int kAtom = 1024;                      // 8 K rows x 64 columns
constexpr int kKGroup = kBN / 64 * kAtom;        // bytes per 8 K rows
struct Ring {
  // two warps that write the fold's B rows beside the converters (the
  // register file is allocated for 20 warps either way)
  static constexpr int kFoldWarps = 2;
  static constexpr int kThreads =
      kConsThreads + kConvThreads + 32 * kFoldWarps + 32;   // + producer
  // the converted tile (with the fold rows below the stage's 64), the fold
  // A tile, and the raw bytes
  static constexpr int kW = kWBytes + kFoldBBytes;
  static constexpr int kA = kFoldABytes;
  static constexpr int kRaw = kQBytes + kSBytes;
  // [x][converted weight][fold A][q4 | scales], 1024-aligned stages (the
  // swizzle's period, which the descriptors assume)
  static constexpr int kStage = kXBytes + kW + kA + (kRaw + 1023) / 1024 * 1024;
  static constexpr int kTx = kXBytes + kA + kRaw;   // loaded bytes a stage
  static constexpr int kSmem = kStages * kStage + 3 * kStages * 8 + 1024;
};

// Byte offset of weight (k, n) in the converted tile, n a multiple of 4:
// atom (k / 8, n / 64), row k % 8, its 16-byte chunk swizzled by the row.
__device__ __forceinline__ int w_off(int k, int n) {
  return (k >> 3) * kKGroup + (n >> 6) * kAtom + (k & 7) * 128 +
         ((((n & 63) >> 3) ^ (k & 7)) << 4) + (n & 7) * 2;
}

// wgmma.mma_async m64n128k16 f32 += bf16 x bf16: A K-major, B MN-major
// (transposed), both from shared memory; D in 64 registers a thread.
__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsThreads) : "memory");
}

// A work item: tile (row tile fastest, then column tile) and split z, the
// K stages [z * k_tiles, (z + 1) * k_tiles).
struct Item {
  int tile, z, m0, n0, kt0, nkt;
  __device__ Item(int w, int M, int N, int nk, int k_tiles) {
    const int rt = (M + kBM - 1) / kBM, tiles = rt * ((N + kBN - 1) / kBN);
    tile = w % tiles;
    z = w / tiles;
    m0 = (tile % rt) * kBM;
    n0 = (tile / rt) * kBN;
    kt0 = z * k_tiles;
    nkt = min(nk, kt0 + k_tiles) - kt0;
  }
};

// Block b takes the items b, b + gridDim.x, ... of tiles * splits; every
// role counts the stages it has passed in g (the ring's slot g % kStages,
// its phase g / kStages). partial: f32 scratch of splits * 64 * 256 floats
// a tile (splits > 1 only), counters: int32 zeros, one a tile.
__global__ void __launch_bounds__(Ring::kThreads, 1)
bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_s, int M, int N,
                  int Kc, int splits, int k_tiles, int n_out,
                  float* __restrict__ partial, int* __restrict__ counters,
                  float* __restrict__ y, const uint8_t* __restrict__ fa,
                  int fa_stages) {
  using R = Ring;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int is_last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* ring_p = smem_raw + (ring - raw);
  const uint32_t bars = ring + kStages * R::kStage;   // full, conv, empty
  const int nk = (Kc + kBK - 1) / kBK;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int items = tiles * splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s),
                kConvThreads + 32 * R::kFoldWarps);
      mbar_init(bars + 8 * (2 * kStages + s), kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == (R::kThreads - 32) / 32) {              // the producer warp
    if (lane == 0) {
      int g = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Item t(w, M, N, nk, k_tiles);
        for (int kt = t.kt0; kt < t.kt0 + t.nkt; ++kt, ++g) {
          const int s = g % kStages;
          mbar_wait(bars + 8 * (2 * kStages + s), ((g / kStages) & 1) ^ 1);
          const uint32_t st = ring + s * R::kStage, full = bars + 8 * s;
          const uint32_t q = st + kXBytes + R::kW + R::kA;
          mbar_expect_tx(full, R::kTx);
          tma_load_2d(st, &map_x, full, kt * kBK, t.m0);
          tma_load_2d(q, &map_q, full, t.n0, kt * (kBK / 2));
          tma_load_2d(q + kQBytes, &map_s, full, t.n0, kt * (kBK / 32));
          hopper::bulk_load(                // the stage's fold A tile
              st + kXBytes + R::kW,
              fa + ((size_t)(t.m0 / kBM) * fa_stages + kt) * kFoldABytes,
              kFoldABytes, full);
        }
      }
    }
    return;
  }

  if (warp >= (kConsThreads + kConvThreads) / 32) {    // the fold warps
    // thread f the columns 4 (f % 32) .. + 3 and the fold rows f / 32 +
    // kFoldWarps i: row r the kFoldB part of -8 d of q block r / 8
    const int f = threadIdx.x - kConsThreads - kConvThreads;
    const int n = 4 * (f & 31);
    int n_st = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x)
      n_st += Item(w, M, N, nk, k_tiles).nkt;
    for (int g = 0; g < n_st; ++g) {
      const int s = g % kStages;
      mbar_wait(bars + 8 * s, (g / kStages) & 1);
      uint8_t* st = ring_p + s * R::kStage;
      const float* sc = reinterpret_cast<const float*>(
          st + kXBytes + R::kW + R::kA + kQBytes);
      uint8_t* wt = st + kXBytes;
      uint2 part[2][3];
#pragma unroll
      for (int b = 0; b < 2; ++b)
        fold_weight_parts(
            *reinterpret_cast<const float4*>(sc + b * kBN + n), part[b]);
#pragma unroll
      for (int i = 0; i < kFoldRows / R::kFoldWarps; ++i) {
        const int row = (f >> 5) + R::kFoldWarps * i;
        const int pt = fold_part(kFoldB, row & 7);
        const uint2* pb = part[i / (8 / R::kFoldWarps)];   // row / 8
        *reinterpret_cast<uint2*>(wt + w_off(kBK + row, n)) =
            pt == 0 ? pb[0] : pt == 1 ? pb[1] : pb[2];
      }
      hopper::fence_proxy_async();
      mbar_arrive(bars + 8 * (kStages + s));
    }
    return;
  }

  if (warp >= kConsThreads / 32) {                     // the converters
    // warp cw owns the stage's packed rows cw, cw + kConvWarps, ... (row
    // 16 kb + j holds K rows 32 kb + j and 32 kb + j + 16), lane l the
    // columns 4 l .. 4 l + 3
    const int cw = warp - kConsThreads / 32, n = 4 * lane;
    const int stages = [&] {         // the block's stages over its items
      int n_st = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x)
        n_st += Item(w, M, N, nk, k_tiles).nkt;
      return n_st;
    }();
    for (int g = 0; g < stages; ++g) {
      const int s = g % kStages;
      mbar_wait(bars + 8 * s, (g / kStages) & 1);
      uint8_t* st = ring_p + s * R::kStage;
      const uint8_t* q4 = st + kXBytes + R::kW + R::kA;
      const float* sc = reinterpret_cast<const float*>(q4 + kQBytes);
      uint8_t* wt = st + kXBytes;
      const float4 d0 = *reinterpret_cast<const float4*>(sc + n);
      const float4 d1 = *reinterpret_cast<const float4*>(sc + kBN + n);
#pragma unroll
      for (int r = cw; r < kBK / 2; r += kConvWarps) {
        const bool hi_blk = r >= 16;
        const int k = 32 * hi_blk + (r & 15);
        const float4 d = hi_blk ? d1 : d0;
        const uint32_t word =
            *reinterpret_cast<const uint32_t*>(q4 + r * kBN + n);
        *reinterpret_cast<uint2*>(wt + w_off(k, n)) = pack_bf16x4(
            weights4(word & 0x0F0F0F0Fu, d));
        *reinterpret_cast<uint2*>(wt + w_off(k + 16, n)) = pack_bf16x4(
            weights4((word >> 4) & 0x0F0F0F0Fu, d));
      }
      hopper::fence_proxy_async();
      mbar_arrive(bars + 8 * (kStages + s));
    }
    return;
  }

  // the consumers: warpgroup wg owns rows m0 + 64 wg .. m0 + 64 wg + 63
  const int wg = warp >> 2, t = threadIdx.x & 127, c = threadIdx.x;
  float acc[64];
  int g = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item item(w, M, N, nk, k_tiles);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_regs<64>(acc);
    for (int it = 0; it < item.nkt; ++it, ++g) {
      const int s = g % kStages, ph = (g / kStages) & 1;
      mbar_wait(bars + 8 * s, ph);                     // x landed
      mbar_wait(bars + 8 * (kStages + s), ph);         // weight converted
      const uint32_t a = ring + s * R::kStage + wg * 64 * 128;
      const uint32_t b = ring + s * R::kStage + kXBytes;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)
        wgmma_bf16_n128(acc, hopper::sw128_desc(a + 32 * k),
                        hopper::sw128_mn_desc(b + 2 * kKGroup * k, kAtom,
                                              kKGroup));
      wgmma_bf16_n128(                 // the fold slice: A K-major, 8-row
          acc,                           // groups 256 bytes apart
          hopper::plain_desc(b + R::kW + wg * 2048, 128, 256),
          hopper::sw128_mn_desc(b + 2 * kKGroup * (kBK / 16), kAtom,
                                kKGroup));
      wgmma_commit();
      fence_regs<64>(acc);
      wgmma_wait<1>();               // the previous stage's products are done
      if (it > 0 && t == 0)
        mbar_arrive(bars + 8 * (2 * kStages + (g - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs<64>(acc);
    if (t == 0) mbar_arrive(bars + 8 * (2 * kStages + (g - 1) % kStages));

    if (splits > 1) {
      // split K: every split stores its partial (register i of consumer
      // thread c at i * 256 + c); the last to count in sums them all, its
      // own read back too, in split order
      float* pt = partial + (size_t)item.tile * splits * 64 * kConsThreads;
      float* mine = pt + (size_t)item.z * 64 * kConsThreads;
#pragma unroll
      for (int i = 0; i < 64; ++i) mine[i * kConsThreads + c] = acc[i];
      __threadfence();
      consumers_sync();
      if (c == 0) is_last = atomicAdd(&counters[item.tile], 1) == splits - 1;
      consumers_sync();
      if (!is_last) continue;
      __threadfence();
      // split by split, each split's 64 loads in flight together (one L2
      // round trip a split, not one a value)
      for (int z = 0; z < splits; ++z) {
        const float* pz = pt + (size_t)z * 64 * kConsThreads + c;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float v = __ldcg(pz + i * kConsThreads);
          acc[i] = z == 0 ? v : acc[i] + v;
        }
      }
      if (c == 0) counters[item.tile] = 0;
    }

    // D fragment: register i of thread t holds row 16 (t / 32) + t % 32 / 4
    // + 8 (i / 2 % 2) and column 8 (i / 4) + 2 (t % 4) + i % 2 of the
    // 64 x 128 tile
    const bool pairs = (n_out & 1) == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = item.m0 + wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2) + 8 * r;
      if (m >= M) continue;
      float* yr = y + (size_t)m * n_out;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = item.n0 + 8 * j + 2 * (t & 3);
        const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
        if (pairs && n + 1 < n_out) {
          *reinterpret_cast<float2*>(yr + n) = make_float2(v0, v1);
        } else {
          if (n < n_out) yr[n] = v0;
          if (n + 1 < n_out) yr[n + 1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// fa: the fold's A plane, which the cast pass writes.
int launch_split(const void* xb, int M, int K, int Kc, const void* qs,
                 const void* scales, int N, int splits, int k_tiles,
                 int blocks, void* partial, void* counters, float* y,
                 int n_out, cudaStream_t stream, const void* fa) {
  using R = Ring;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        R::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  CUtensorMap map_x, map_q, map_s;
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (!hopper::make_map(&map_x, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M,
                        K, kBK, kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&map_q, qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2,
                        N, kBN, kBK / 2, none) ||
      !hopper::make_map(&map_s, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        K / 32, N, kBN, kBK / 32, none))
    return (int)cudaErrorInvalidValue;
  bf16_wgmma_kernel<<<blocks, R::kThreads, R::kSmem, stream>>>(
      map_x, map_q, map_s, M, N, Kc, splits, k_tiles, n_out,
      (float*)partial, (int*)counters, y, (const uint8_t*)fa,
      (K + kBK - 1) / kBK);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel B20 (bf16 mode): y f32 [M, n_out] = R(x) @ R(q * d) - 8 * bsum @ d
// for a q4_0 weight: x, M, Kx, qs, scales, N, K and xb as q4_prefill_gemm
// takes them in bf16 mode, b5_plan's splits and k_steps, `blocks`
// persistent blocks, partial (f32 scratch of (row tiles * column tiles *
// splits * 128 * 128) floats where splits > 1), counters (int32 zeros, one
// a 128 x 128 tile), y, n_out, and fa, scratch of ceil(M / 128) *
// ceil(K / 64) * 4096 bytes (16-byte aligned) for the fold's A tiles, which
// the cast pass writes. The cast pass, then bf16_wgmma_kernel. Returns the
// CUDA error code of the launches.
extern "C" int q4_prefill_split_gemm(const void* x, int M, int Kx,
                                     const void* qs, const void* scales,
                                     int N, int K, void* fa, void* xb,
                                     int splits, int k_steps, int blocks,
                                     void* partial, void* counters, void* y,
                                     int n_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K % 32 || Kx % 4 || Kx > K || N % 16 || M < 1 || splits < 1 ||
      k_steps < 1 || blocks < 1 || !fa)
    return (int)cudaErrorInvalidValue;
  const size_t quads = (size_t)M * (K / 4);
  cast_kernel<true><<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(
      (const float*)x, M, Kx, K, (__nv_bfloat16*)xb, (uint8_t*)fa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int Kc = (Kx + 31) / 32 * 32;
  return launch_split(xb, M, K, Kc, qs, scales, N, splits, k_steps, blocks,
                      partial, counters, (float*)y, n_out, s, fa);
}

// Kernel B5: x f32 [M, Kx] (Kx a multiple of 4, Kx <= K, 16-byte aligned),
// qs uint8 [K/2, N], scales f32 [K/32, N] and mins f32 [K/32, N] or null
// (q4_0) (K the stored K, a multiple of 32; N a multiple of 16; planes
// 16-byte aligned), y f32 [M, n_out]. The K the product runs over (Kx
// rounded up to 32) is cut into `splits` runs of k_steps stages (64 deep),
// the tiles from t0 on split, on bx rows of x and wgs warpgroups a block
// and `blocks` persistent blocks (the plan in kernels/q4_matmul.py);
// partial f32 scratch of ra::gemm's size where splits > 1, counters int32
// zeros, one a tile. bf16 = 1: xb bf16 [M, K] scratch for the cast pass,
// then the register-A kernel (q4_prefill_ra.cuh) in its bf16 mode.
// bf16 = 0 (f32 mode, bx 64, 96 or 128): xb scratch of 6 M K bytes (the
// three part planes) plus, for q4_1, 4 * 2 ceil(K / 64) * (M rounded up to
// 4) bytes (the block sums) for cast3_kernel, then the register-A kernel
// in its f32 mode. Returns the CUDA error code of the launches.
extern "C" int q4_prefill_gemm(const void* x, int M, int Kx, const void* qs,
                               const void* scales, const void* mins, int N,
                               int K, void* xb, int bx, int wgs, int t0,
                               int splits, int k_steps, int blocks,
                               void* partial, void* counters, void* y,
                               int n_out, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K % 32 || Kx % 4 || Kx > K || N % 16 || M < 1 || splits < 1 ||
      k_steps < 1)
    return (int)cudaErrorInvalidValue;
  const size_t quads = (size_t)M * (K / 4);
  const unsigned grid = (unsigned)((quads + 255) / 256);
  const int Kc = (Kx + 31) / 32 * 32;      // x is zero from Kx on
  if (!bf16) {
    const int mr = (M + 3) / 4 * 4;
    float* bs = reinterpret_cast<float*>(static_cast<uint8_t*>(xb) +
                                         (size_t)6 * M * K);
    if (mins)
      cast3_kernel<true><<<grid, 256, 0, s>>>((const float*)x, M, Kx, K,
                                              (__nv_bfloat16*)xb, bs, mr);
    else
      cast3_kernel<false><<<grid, 256, 0, s>>>((const float*)x, M, Kx, K,
                                               (__nv_bfloat16*)xb, nullptr,
                                               mr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return mins ? ra::gemm_f32<ra::kF32A>(xb, bs, mr, M, K, Kc, qs, scales,
                                          mins, N, bx, wgs, t0, splits,
                                          k_steps, blocks, partial, counters,
                                          y, n_out, s)
                : ra::gemm_f32<ra::kF32>(xb, nullptr, mr, M, K, Kc, qs,
                                         scales, nullptr, N, bx, wgs, t0,
                                         splits, k_steps, blocks, partial,
                                         counters, y, n_out, s);
  }
  cast_kernel<false><<<grid, 256, 0, s>>>((const float*)x, M, Kx, K,
                                          (__nv_bfloat16*)xb, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return mins ? ra::gemm<ra::kAffine>(xb, M, K, Kc, qs, scales, mins,
                                      nullptr, N, bx, wgs, t0, splits,
                                      k_steps, blocks, partial,
                                      counters, y, n_out, s)
              : ra::gemm<ra::kNat>(xb, M, K, Kc, qs, scales, nullptr,
                                   nullptr, N, bx, wgs, t0, splits, k_steps,
                                   blocks, partial, counters, y,
                                   n_out, s);
}
