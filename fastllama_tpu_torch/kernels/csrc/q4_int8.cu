// Kernel B3: the activation-quantized int8 prefill matmul.
//
// Replaces fastllama_tpu/kernels/q4_matmul.py::q4_matmul_prefill_int8
// (variant nat, _q4mm_prefill_int8_strip_kernel) with the semantics of its
// exact emulation q4_matmul_int8_xla:
//   s8[n]  = max(max_kb |d[kb, n]| * (8/127), 1e-20)       (whole K)
//   w8     = round_half_even((q - 8) * (d * (1 / s8)))     int8
//   acc    = sum_k xq[m, k] * w8[k, n]                     exact int32
//   y[m,n] = (float(acc) * dx[m]) * s8[n]
// The TPU kernel derived s8 per VMEM K-part when its budget split K; here
// s8 always comes from the whole K, as in the emulation.
//
// Bound on the H100: operations. At M = 512 the int8 products are 2*M*N*K
// operations against ~0.6 bytes of weight per element, far above the
// ridge; the int8 tensor-core peak is 1,979 TOP/s, which only wgmma
// reaches. Two launches:
//   1. requant_kernel: s8 per column from the whole-K scale strip, then the
//      int8 weight w8 as an [N, K] plane (K contiguous, 1 byte a weight)
//      in scratch, written through a shared tile in runs of 512 bytes. A
//      block takes 128 columns and a part of K (at least 4 parts, more on
//      a narrow plane); every block of a column strip derives the same s8
//      from the same scales.
//   2. int8_wgmma_kernel: a 128 x BN output tile (BN 128 or 256, chosen by
//      the wrapper for the fewest waves over the SMs) per block of two
//      consumer warpgroups and one producer warp. One thread of the
//      producer keeps a ring of 4 (BN 256) or 6 (BN 128) stages of 128-deep
//      K slices of both operands in flight with TMA (cp.async.bulk.tensor,
//      128-byte swizzle, zero fill past M, N and K) under full/empty
//      mbarriers. Each consumer warpgroup owns 64 rows and issues
//      wgmma.mma_async m64nBNk32 s8 x s8 -> s32 from shared memory, both
//      operands K-major (xq [M, K] and the [N, K] plane as they lie), four
//      per stage; a stage is released when the next stage's products are
//      in flight (wait_group 1). The grid runs the row tiles fastest, so the
//      blocks of one column tile run together and read its weight slice
//      from HBM once. The epilogue keeps the JAX order (float(acc) * dx) *
//      s8 and the n < n_out cut. The consumers hold 64 or 128 accumulators
//      a thread without spilling (nvcc -Xptxas -v), so no setmaxnreg
//      rebalancing between the roles is needed.
// The requantization is a pass of its own. Fusing it into the product's
// producer side (no plane, but every row tile of 128 requantizes its
// weight tile again, on the CUDA cores beside the tensor cores) was
// bit-exact and slower on every 7B plane at M = 256 and 512 (PERF.md). The
// plane is not cached beside the q4 weight, which would double the weight
// memory.

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// 1. s8 and the int8 weight plane
// ---------------------------------------------------------------------------

// rne((q - 8) * sc) in the low byte of the result, for a code q in 0..15 and
// |(q - 8) * sc| <= 127, without a conversion instruction: 2^23 + q is
// exact, so is subtracting 2^23 + 8; the product is the same f32 rounding
// as the plain version's; adding 1.5 * 2^23 rounds it half to even to an
// integer in the low mantissa bits (two's complement in the low byte).
// The _rn intrinsics keep the compiler from contracting into an FMA.
__device__ __forceinline__ uint32_t requant_byte(uint32_t q, float sc) {
  const float v = __fadd_rn(__uint_as_float(0x4B000000u | q), -8388616.0f);
  return __float_as_uint(__fadd_rn(__fmul_rn(v, sc), 12582912.0f));
}

// The low bytes of four words, in order, as one word.
__device__ __forceinline__ uint32_t pack_low_bytes(const uint32_t* w) {
  return __byte_perm(__byte_perm(w[0], w[1], 0x0040),
                     __byte_perm(w[2], w[3], 0x0040), 0x5410);
}

constexpr int kReqCols = 4, kReqWarps = 8, kReqThreads = 32 * kReqWarps;
constexpr int kReqTileN = 32 * kReqCols;         // columns of a block
constexpr int kReqBlocks = 264;                  // blocks aimed at: 2 an SM
constexpr int kReqKT = 16;                       // q blocks staged at once
constexpr int kReqRow = kReqKT * 32;             // bytes of a staged row

// Block (x, y): columns [128 x, 128 x + 128), lane l owning 4 adjacent ones
// (one 4-byte load per packed row, coalesced along N), and the y-th part of
// the q blocks. Its 8 warps first take the column's max |d| over the whole
// K (warp w the q blocks w, w + 8, ...; a max is exact in any order; block
// row 0 writes s8). Then 16 q blocks at a time: warp w requantizes two of
// them into a shared [128 columns][512 bytes] tile, and each warp writes 16
// of its rows out as 512 contiguous bytes. Written straight from the registers, a column's
// 32 bytes a q block land 4 KB or more from the next column's, and the
// pass ran at a fifth of the rate of a plain fill of the plane (PERF.md).
// The tile's 16-byte chunks are swizzled (chunk ^ (row / 4) % 32), so that
// neither the lanes' stores (rows 4 l + c) nor a warp's read of one row
// meet bank conflicts.
__global__ void __launch_bounds__(kReqThreads)
requant_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ scales,
               int NB, int N, int K, int kb_per_block, float* __restrict__ s8,
               int8_t* __restrict__ w8t) {
  __shared__ float red[kReqWarps][kReqTileN];
  extern __shared__ __align__(16) uint8_t tile[];   // [kReqTileN][kReqRow]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kReqTileN, n = n0 + lane * kReqCols;
  const bool ok = n < N;
  float mx[kReqCols] = {0.f, 0.f, 0.f, 0.f};
  if (ok) {
    for (int kb = warp; kb < NB; kb += kReqWarps) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          scales + (size_t)kb * N + n));
      mx[0] = fmaxf(mx[0], fabsf(v.x));
      mx[1] = fmaxf(mx[1], fabsf(v.y));
      mx[2] = fmaxf(mx[2], fabsf(v.z));
      mx[3] = fmaxf(mx[3], fabsf(v.w));
    }
  }
#pragma unroll
  for (int c = 0; c < kReqCols; ++c) red[warp][lane * kReqCols + c] = mx[c];
  __syncthreads();
  float inv[kReqCols];
#pragma unroll
  for (int c = 0; c < kReqCols; ++c) {
    float m = red[0][lane * kReqCols + c];
#pragma unroll
    for (int w = 1; w < kReqWarps; ++w)
      m = fmaxf(m, red[w][lane * kReqCols + c]);
    const float s = fmaxf(m * (float)(8.0 / 127.0), (float)1e-20);
    inv[c] = __fdiv_rn(1.0f, s);
    if (ok && blockIdx.y == 0 && warp == 0) s8[n + c] = s;
  }
  const int kb_end = min(NB, (int)(blockIdx.y + 1) * kb_per_block);
  for (int g = blockIdx.y * kb_per_block; g < kb_end; g += kReqKT) {
    const int nkt = min(kReqKT, kb_end - g);
    for (int t = 2 * warp; t < min(2 * warp + 2, nkt); ++t) {
      const int kb = g + t;
      const float4 d = ok ? __ldg(reinterpret_cast<const float4*>(
          scales + (size_t)kb * N + n)) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float sc[kReqCols] = {d.x * inv[0], d.y * inv[1], d.z * inv[2],
                                  d.w * inv[3]};
      uint32_t word[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        word[j] = ok ? __ldg(reinterpret_cast<const uint32_t*>(
            qs + (size_t)(kb * 16 + j) * N + n)) : 0u;
#pragma unroll
      for (int c = 0; c < kReqCols; ++c) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4) {
          uint32_t l4[4], h4[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t byte = word[4 * j4 + i] >> (8 * c);
            l4[i] = requant_byte(byte & 15, sc[c]);
            h4[i] = requant_byte((byte >> 4) & 15, sc[c]);
          }
          lo[j4] = pack_low_bytes(l4);
          hi[j4] = pack_low_bytes(h4);
        }
        const int row = lane * kReqCols + c;
        uint8_t* trow = tile + row * kReqRow;
        const int key = (row >> 2) & 31;
        *reinterpret_cast<uint4*>(trow + 16 * ((2 * t) ^ key)) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(trow + 16 * ((2 * t + 1) ^ key)) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
    __syncthreads();
    // rows out: warp w the rows w, w + 8, ...; lane l the 16-byte chunk l
    for (int row = warp; row < kReqTileN; row += kReqWarps) {
      if (n0 + row < N && lane < 2 * nkt)
        *reinterpret_cast<uint4*>(w8t + (size_t)(n0 + row) * K + g * 32 +
                                  16 * lane) =
            *reinterpret_cast<const uint4*>(tile + row * kReqRow +
                                            16 * (lane ^ ((row >> 2) & 31)));
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 2. the int8 product on wgmma, fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128;               // two consumer warpgroups of 64 rows
constexpr int kBK = 128;               // bytes of K per stage: one swizzle row
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * kConsumers + 32;   // + one producer warp

// The tile variants (the wrapper's `tile`): 128 x BN outputs and a ring of
// STAGES stages, 192 KB of shared memory either way (one block an SM). A
// variant of 128 x 128 with 3 stages and two blocks an SM was no faster on
// qkv and slower on w2 (K 11264), so it went.
template <int BN, int STAGES> struct GemmCfg {
  static constexpr int kStages = STAGES;
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kStageBytes = kABytes + BN * kBK;
  // the ring, its barriers and room to align the ring to 1024 bytes (the
  // 128-byte swizzle's period, which the wgmma descriptors assume)
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::sw128_desc;
using hopper::tma_load_2d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

// wgmma.mma_async m64nNk32 s32 += s8 x s8, A and B from shared memory
// (descriptors), D in 64 (N = 128) or 128 (N = 256) registers a thread.
__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 256) wgmma_n256(d, da, db);
  else wgmma_n128(d, da, db);
}

// The epilogue of a warpgroup's 64 x BN tile at (m0, n0): y = (float(acc)
// * dx[m]) * s8[n] where m < M and n < n_out. D fragment: register i of
// thread t holds row 16 * (t / 32) + t % 32 / 4 + 8 * (i / 2 % 2) and
// column 8 * (i / 4) + 2 * (t % 4) + i % 2, so 4 lanes write 32 bytes of a
// row (a whole sector) with one float2 each.
template <int BN>
__device__ __forceinline__ void store_tile(const int* acc, int m0, int n0,
                                           int t, const float* __restrict__ dx,
                                           const float* __restrict__ s8, int M,
                                           int n_out, float* __restrict__ y) {
  const int warp = t >> 5, lane = t & 31;
  const bool pairs = (n_out & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + warp * 16 + (lane >> 2) + 8 * r;
    if (m >= M) continue;
    const float dm = dx[m];
    float* yr = y + (size_t)m * n_out;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      const float v0 = (float)acc[4 * j + 2 * r] * dm;
      const float v1 = (float)acc[4 * j + 2 * r + 1] * dm;
      if (pairs && n + 1 < n_out) {
        const float2 sv = __ldg(reinterpret_cast<const float2*>(s8 + n));
        *reinterpret_cast<float2*>(yr + n) = make_float2(v0 * sv.x, v1 * sv.y);
      } else {
        if (n < n_out) yr[n] = v0 * s8[n];
        if (n + 1 < n_out) yr[n + 1] = v1 * s8[n + 1];
      }
    }
  }
}

template <int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const float* __restrict__ dx, const float* __restrict__ s8,
                  int M, int K, int n_out, float* __restrict__ y) {
  using Cfg = GemmCfg<BN, STAGES>;
  constexpr int S = Cfg::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t bars = ring + S * Cfg::kStageBytes;   // full[S], empty[S]
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int nk = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {                          // the producer warp
    if (t == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S, round = kt / S;
        mbar_wait(bars + 8 * (S + s), (round & 1) ^ 1);
        const uint32_t a = ring + s * Cfg::kStageBytes;
        mbar_expect_tx(bars + 8 * s, Cfg::kStageBytes);
        tma_load_2d(a, &map_x, bars + 8 * s, kt * kBK, m0);
        tma_load_2d(a + Cfg::kABytes, &map_w, bars + 8 * s, kt * kBK, n0);
      }
    }
    return;
  }

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  fence_regs<BN / 2>(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    mbar_wait(bars + 8 * s, (kt / S) & 1);
    const uint32_t a = ring + s * Cfg::kStageBytes + wg * 64 * kBK;
    const uint32_t b = ring + s * Cfg::kStageBytes + Cfg::kABytes;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK; k += 32)
      wgmma_tile<BN>(acc, sw128_desc(a + k), sw128_desc(b + k));
    wgmma_commit();
    fence_regs<BN / 2>(acc);
    wgmma_wait<1>();                 // the previous stage's products are done
    if (kt > 0 && t == 0) mbar_arrive(bars + 8 * (S + (kt - 1) % S));
  }
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc);

  store_tile<BN>(acc, m0 + wg * 64, n0, t, dx, s8, M, n_out, y);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A 2-D map of an int8 [rows, cols] matrix (cols contiguous) in boxes of
// box_cols by box_rows with the 128-byte swizzle (the wgmma operands), zeros
// past the edges.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_cols, int box_rows) {
  return hopper::make_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows,
                          cols, box_cols, box_rows,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int BN, int STAGES>
int launch_gemm(const void* xq, const float* dx, int M, int K,
                const void* w8t, const float* s8, int N, float* y, int n_out,
                cudaStream_t stream) {
  using Cfg = GemmCfg<BN, STAGES>;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_wgmma_kernel<BN, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, xq, M, K, kBK, kBM) ||
      !make_map(&map_w, w8t, N, K, kBK, BN))
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  int8_wgmma_kernel<BN, STAGES><<<grid, kThreads, Cfg::kSmem, stream>>>(
      map_x, map_w, dx, s8, M, K, n_out, y);
  return (int)cudaGetLastError();
}

}  // namespace

// xq int8 [M, K] (K = the stored K, a multiple of 64), dx f32 [M], qs
// uint8 [K/2, N], scales f32 [K/32, N] (N a multiple of 4), s8 f32 [N]
// scratch, w8t int8 [N, K] scratch (16-byte aligned), y f32 [M, n_out];
// tile: the product's variant, 0 = 128 x 256 outputs (4 stages), 1 =
// 128 x 128 (6 stages). Launches the requantization, then the product;
// returns the CUDA error code of the launches.
extern "C" int q4_int8_gemm(const void* xq, const void* dx, int M, int K,
                            const void* qs, const void* scales, int N,
                            void* s8, void* w8t, void* y, int n_out,
                            int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K % 64 || N % 4 || tile < 0 || tile > 1)
    return (int)cudaErrorInvalidValue;
  const int nb = K / 32;
  // whole tiles of kReqKT q blocks; at least 4 blocks along K, more where
  // the column strips alone give fewer than kReqBlocks blocks (every one
  // of them reads the strip's scales for s8)
  const int xb = (N + kReqTileN - 1) / kReqTileN;
  const int tiles = (nb + kReqKT - 1) / kReqKT;
  const int split = min(tiles, max(4, (kReqBlocks + xb - 1) / xb));
  const int per = (tiles + split - 1) / split * kReqKT;
  constexpr int smem = kReqTileN * kReqRow;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        requant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  dim3 grid(xb, (nb + per - 1) / per);
  requant_kernel<<<grid, kReqThreads, smem, s>>>(
      (const uint8_t*)qs, (const float*)scales, nb, N, K, per, (float*)s8,
      (int8_t*)w8t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* d = (const float*)dx;
  const float* sc = (const float*)s8;
  if (tile == 0)
    return launch_gemm<256, 4>(xq, d, M, K, w8t, sc, N, (float*)y, n_out, s);
  return launch_gemm<128, 6>(xq, d, M, K, w8t, sc, N, (float*)y, n_out, s);
}
