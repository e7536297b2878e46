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
// through HBM: the weight is dequantized in shared memory, next to the
// product that reads it.
//
// bf16 mode, two launches:
//   1. cast_kernel: R(x) as a bf16 [M, K] plane with zeros past x's K (TMA
//      copies bytes: the A operand has to be bf16 in global memory);
//   2. bf16_wgmma_kernel<AFFINE>: persistent, one block an SM walking over
//      work items (a 128 x 128 output tile and a run of its K stages, 64
//      deep), warp-specialized:
//      * one producer thread keeps a ring of 4 stages in flight with TMA:
//        the x tile (128-byte swizzle, as wgmma reads it), the stage's q4
//        bytes [32, 128] exactly as stored (N contiguous), its scale rows
//        [2, 128] f32 and, affine, its mins rows; zeros past M, N and K;
//      * 8 converter warps dequantize each stage into a bf16 [64, 128]
//        tile in the layout wgmma reads as an MN-major B operand (the
//        transpose bit): atoms of 8 K rows by 64 columns, 128 bytes a row,
//        16-byte chunks swizzled by row. A thread owns 4 adjacent columns
//        of 4 packed rows: one 4-byte load, then per nibble a byte permute
//        into 2^23 + q, one add, one multiply (and one add of m), a packed
//        bf16 conversion, and an 8-byte store a K row: the weight keeps its
//        N-contiguous order and nothing is transposed. The writes are
//        fenced to the async proxy before the stage's barrier;
//      * two consumer warpgroups of 64 rows issue wgmma.mma_async
//        m64n128k16 f32 += bf16 x bf16 (A K-major from the x tile, B
//        MN-major from the converted tile), four per stage, release a
//        stage once the next stage's products are in flight, and store
//        the item.
//      The ring runs on across items, so the next item's loads and
//      conversions proceed under an item's epilogue. Launched one block
//      a tile, each block paid its ring's fill and drain (~6 us, about
//      ten stages; PERF.md), and the M = 512 qkv plane three waves of
//      them. Where the tiles alone leave SMs idle, K is split
//      (b5_plan): each split stores its partial tile to scratch, and
//      the last to finish a tile, elected by a counter it resets, sums
//      the partials in split order (deterministic, no atomic adds on y).
//
// f32 mode, one launch: f32_gemm_kernel<AFFINE>, a true f32 product on the
// CUDA cores (never TF32): a 128 x 128 tile per 256-thread block, 8 x 8
// outputs a thread, K in 32-deep steps whose x tile and q4 bytes, scales
// (and mins) are copied with cp.async into a double-buffered ring while the
// block dequantizes the current step's weight into shared memory (f32) and
// runs its FFMA. Each output is summed in k order within a split; where
// the tiles alone leave SMs idle K is split as in bf16 mode and the
// splits are added in order.

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

// One weight from its code q (0..15) in the low byte of 2^23's bit pattern:
// 2^23 + q is exact, so is subtracting 2^23 (+ 8); then the product with d
// (and the sum with m) in the plain version's f32 roundings.
template <bool AFFINE>
__device__ __forceinline__ float weight(uint32_t magic_q, float d, float m) {
  const float f = __uint_as_float(magic_q);
  if constexpr (AFFINE) return __fadd_rn(__fmul_rn(__fadd_rn(f, -8388608.0f), d), m);
  return __fmul_rn(__fadd_rn(f, -8388616.0f), d);
}

// The four weights of the codes in the four bytes of `nib` (each 0..15),
// columns c..c+3 with scales d and mins m.
template <bool AFFINE>
__device__ __forceinline__ float4 weights4(uint32_t nib, float4 d, float4 m) {
  return make_float4(
      weight<AFFINE>(__byte_perm(nib, 0x4B000000u, 0x7440), d.x, m.x),
      weight<AFFINE>(__byte_perm(nib, 0x4B000000u, 0x7441), d.y, m.y),
      weight<AFFINE>(__byte_perm(nib, 0x4B000000u, 0x7442), d.z, m.z),
      weight<AFFINE>(__byte_perm(nib, 0x4B000000u, 0x7443), d.w, m.w));
}

__device__ __forceinline__ uint2 pack_bf16x4(float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                    *reinterpret_cast<const uint32_t*>(&b));
}

// 16-byte cp.async with zero fill: nothing is read when pred is false.
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem,
                                            bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(pred ? 16 : 0));
}

// ---------------------------------------------------------------------------
// 1. activation cast (bf16 mode)
// ---------------------------------------------------------------------------

// xb[m, k] = bf16(x[m, k]) for k < Kx, 0 for Kx <= k < K; four elements a
// thread (Kx and K multiples of 4).
__global__ void cast_kernel(const float* __restrict__ x, int M, int Kx, int K,
                            __nv_bfloat16* __restrict__ xb) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int quads = K / 4;
  if (i >= (size_t)M * quads) return;
  const int m = (int)(i / quads), k = 4 * (int)(i - (size_t)m * quads);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k < Kx) v = *reinterpret_cast<const float4*>(x + (size_t)m * Kx + k);
  *reinterpret_cast<uint2*>(xb + (size_t)m * K + k) = pack_bf16x4(v);
}

// ---------------------------------------------------------------------------
// 2. the bf16 product on wgmma, the weight dequantized in shared memory
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 4;
constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kConsThreads = 128 * kConsumers;
constexpr int kConvWarps = 8;
constexpr int kConvThreads = 32 * kConvWarps;
constexpr int kThreads = kConsThreads + kConvThreads + 32;   // + producer
constexpr int kXBytes = kBM * kBK * 2;           // x tile, K-major
constexpr int kWBytes = kBK * kBN * 2;           // converted weight tile
constexpr int kQBytes = kBK / 2 * kBN;           // q4 bytes as stored
constexpr int kSBytes = kBK / 32 * kBN * 4;      // scale (or mins) rows
constexpr int kAtom = 1024;                      // 8 K rows x 64 columns
constexpr int kKGroup = kBN / 64 * kAtom;        // bytes per 8 K rows

template <bool AFFINE> struct Ring {
  static constexpr int kRaw = kQBytes + kSBytes * (AFFINE ? 2 : 1);
  // [x][converted weight][q4 | scales | mins], 1024-aligned stages (the
  // swizzle's period, which the descriptors assume)
  static constexpr int kStage = kXBytes + kWBytes + (kRaw + 1023) / 1024 * 1024;
  static constexpr int kTx = kXBytes + kRaw;     // TMA bytes a stage
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
template <bool AFFINE>
__global__ void __launch_bounds__(kThreads, 1)
bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_s,
                  const __grid_constant__ CUtensorMap map_m, int M, int N,
                  int Kc, int splits, int k_tiles, int n_out,
                  float* __restrict__ partial, int* __restrict__ counters,
                  float* __restrict__ y) {
  using R = Ring<AFFINE>;
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
      mbar_init(bars + 8 * (kStages + s), kConvThreads);
      mbar_init(bars + 8 * (2 * kStages + s), kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == (kConsThreads + kConvThreads) / 32) {    // the producer warp
    if (lane == 0) {
      int g = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Item t(w, M, N, nk, k_tiles);
        for (int kt = t.kt0; kt < t.kt0 + t.nkt; ++kt, ++g) {
          const int s = g % kStages;
          mbar_wait(bars + 8 * (2 * kStages + s), ((g / kStages) & 1) ^ 1);
          const uint32_t st = ring + s * R::kStage, full = bars + 8 * s;
          const uint32_t q = st + kXBytes + kWBytes;
          mbar_expect_tx(full, R::kTx);
          tma_load_2d(st, &map_x, full, kt * kBK, t.m0);
          tma_load_2d(q, &map_q, full, t.n0, kt * (kBK / 2));
          tma_load_2d(q + kQBytes, &map_s, full, t.n0, kt * (kBK / 32));
          if constexpr (AFFINE)
            tma_load_2d(q + kQBytes + kSBytes, &map_m, full, t.n0,
                        kt * (kBK / 32));
        }
      }
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
      const uint8_t* q4 = st + kXBytes + kWBytes;
      const float* sc = reinterpret_cast<const float*>(q4 + kQBytes);
      uint8_t* wt = st + kXBytes;
      const float4 d0 = *reinterpret_cast<const float4*>(sc + n);
      const float4 d1 = *reinterpret_cast<const float4*>(sc + kBN + n);
      float4 m0 = make_float4(0.f, 0.f, 0.f, 0.f), m1 = m0;
      if constexpr (AFFINE) {
        m0 = *reinterpret_cast<const float4*>(sc + 2 * kBN + n);
        m1 = *reinterpret_cast<const float4*>(sc + 3 * kBN + n);
      }
#pragma unroll
      for (int r = cw; r < kBK / 2; r += kConvWarps) {
        const bool hi_blk = r >= 16;
        const int k = 32 * hi_blk + (r & 15);
        const float4 d = hi_blk ? d1 : d0, mn = hi_blk ? m1 : m0;
        const uint32_t word =
            *reinterpret_cast<const uint32_t*>(q4 + r * kBN + n);
        *reinterpret_cast<uint2*>(wt + w_off(k, n)) = pack_bf16x4(
            weights4<AFFINE>(word & 0x0F0F0F0Fu, d, mn));
        *reinterpret_cast<uint2*>(wt + w_off(k + 16, n)) = pack_bf16x4(
            weights4<AFFINE>((word >> 4) & 0x0F0F0F0Fu, d, mn));
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
// 3. the f32 product: FFMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFB = 128, kFK = 32, kFThreads = 256;
constexpr int kFRow = kFK + 4;         // floats a staged x row (16-byte rows,
                                       // two rows of a warp's reads apart
                                       // by 4 banks)

struct FSmem {
  float a[2][kFB][kFRow];              // x tiles [row][k]
  uint8_t q[2][kFK / 2][kFB];          // q4 bytes as stored
  float s[2][kFB];                     // scales of the step's q block
  float mn[2][kFB];                    // mins (affine)
  float w[kFK][kFB];                   // the step's weight [k][column]
};

// x f32 [M, Kx] (zero past Kx, Kx a multiple of 4), qs [K/2, N], scales
// (and mins) [K/32, N]; the product runs over the q blocks below Kx, split
// z of the grid over the steps [z * k_steps, (z + 1) * k_steps). Thread
// (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns 4 tx + j,
// 64 + 4 tx + j (i, j < 8 / 4). partial and counters as for the bf16
// kernel (64 * 256 floats a split of a tile).
template <bool AFFINE>
__global__ void __launch_bounds__(kFThreads, 2)
f32_gemm_kernel(const float* __restrict__ x, int M, int Kx,
                const uint8_t* __restrict__ qs,
                const float* __restrict__ scales,
                const float* __restrict__ mins, int N, int k_steps,
                int n_out, float* __restrict__ partial,
                int* __restrict__ counters, float* __restrict__ y) {
  extern __shared__ __align__(16) uint8_t fsmem_raw[];
  __shared__ int is_last;
  FSmem& sm = *reinterpret_cast<FSmem*>(fsmem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * kFB, n0 = blockIdx.x * kFB;
  const int kt0 = blockIdx.z * k_steps;
  const int kt1 = min((Kx + kFK - 1) / kFK, kt0 + k_steps);

  auto issue = [&](int kt, int st) {
    const int c = tid & 7, k = kt * kFK + 4 * c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 32 * i, m = m0 + r;
      const bool ok = m < M && k < Kx;
      cp_async16z(&sm.a[st][r][4 * c], ok ? x + (size_t)m * Kx + k : x, ok);
    }
    if (tid < 128) {
      const int row = tid >> 3, n = n0 + 16 * (tid & 7);
      cp_async16z(&sm.q[st][row][16 * (tid & 7)],
                  qs + (size_t)(kt * 16 + row) * N + (n < N ? n : 0), n < N);
    } else if (tid < 160 || (AFFINE && tid < 192)) {
      const int c4 = (tid - 128) & 31, n = n0 + 4 * c4;
      const float* src = tid < 160 ? scales : mins;
      float* dst = tid < 160 ? &sm.s[st][4 * c4] : &sm.mn[st][4 * c4];
      cp_async16z(dst, src + (size_t)kt * N + (n < N ? n : 0), n < N);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  issue(kt0, 0);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();                 // step kt landed; step kt - 1 is done
    if (kt + 1 < kt1) issue(kt + 1, st ^ 1);
    // the step's weight: word h of 512 (16 packed rows x 32 words), its
    // low nibbles K row j, its high nibbles K row j + 16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int wi = tid + kFThreads * h, j = wi >> 5, c = 4 * (wi & 31);
      const uint32_t word = *reinterpret_cast<const uint32_t*>(&sm.q[st][j][c]);
      const float4 d = *reinterpret_cast<const float4*>(&sm.s[st][c]);
      const float4 mn = AFFINE ? *reinterpret_cast<const float4*>(&sm.mn[st][c])
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&sm.w[j][c]) =
          weights4<AFFINE>(word & 0x0F0F0F0Fu, d, mn);
      *reinterpret_cast<float4*>(&sm.w[j + 16][c]) =
          weights4<AFFINE>((word >> 4) & 0x0F0F0F0Fu, d, mn);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sm.a[st][ty + 16 * i][kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(&sm.w[kk + q][4 * tx]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&sm.w[kk + q][64 + 4 * tx]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                         : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }

  if (gridDim.z > 1) {
    // split K as in the bf16 kernel: value (i, j) of thread tid at
    // (8 i + j) * 256 + tid; the last split to count in sums them in order
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* pt = partial + (size_t)tile * gridDim.z * 64 * kFThreads + tid;
    float* mine = pt + (size_t)blockIdx.z * 64 * kFThreads;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) mine[(8 * i + j) * kFThreads] = acc[i][j];
    __threadfence();
    __syncthreads();
    if (tid == 0)
      is_last = atomicAdd(&counters[tile], 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    for (int z = 0; z < (int)gridDim.z; ++z) {
      const float* pz = pt + (size_t)z * 64 * kFThreads;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = __ldcg(pz + (8 * i + j) * kFThreads);
          acc[i][j] = z == 0 ? v : acc[i][j] + v;
        }
    }
    if (tid == 0) counters[tile] = 0;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    float* yr = y + (size_t)m * n_out;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n < n_out) yr[n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <bool AFFINE>
int launch_bf16(const void* xb, int M, int K, int Kc, const void* qs,
                const void* scales, const void* mins, int N, int splits,
                int k_tiles, int blocks, void* partial, void* counters,
                float* y, int n_out, cudaStream_t stream) {
  using R = Ring<AFFINE>;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        bf16_wgmma_kernel<AFFINE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  CUtensorMap map_x, map_q, map_s, map_m;
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (!hopper::make_map(&map_x, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M,
                        K, kBK, kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&map_q, qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2,
                        N, kBN, kBK / 2, none) ||
      !hopper::make_map(&map_s, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        K / 32, N, kBN, kBK / 32, none) ||
      !hopper::make_map(&map_m, AFFINE ? mins : scales,
                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / 32, N, kBN,
                        kBK / 32, none))
    return (int)cudaErrorInvalidValue;
  bf16_wgmma_kernel<AFFINE><<<blocks, kThreads, R::kSmem, stream>>>(
      map_x, map_q, map_s, map_m, M, N, Kc, splits, k_tiles, n_out,
      (float*)partial, (int*)counters, y);
  return (int)cudaGetLastError();
}

template <bool AFFINE>
int launch_f32(const float* x, int M, int Kx, const void* qs,
               const void* scales, const void* mins, int N, int splits,
               int k_steps, void* partial, void* counters, float* y,
               int n_out, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        f32_gemm_kernel<AFFINE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(FSmem));
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  dim3 grid((N + kFB - 1) / kFB, (M + kFB - 1) / kFB, splits);
  f32_gemm_kernel<AFFINE><<<grid, kFThreads, sizeof(FSmem), stream>>>(
      x, M, Kx, (const uint8_t*)qs, (const float*)scales, (const float*)mins,
      N, k_steps, n_out, (float*)partial, (int*)counters, y);
  return (int)cudaGetLastError();
}

}  // namespace

// x f32 [M, Kx] (Kx a multiple of 4, Kx <= K, 16-byte aligned), qs uint8
// [K/2, N], scales f32 [K/32, N] and mins f32 [K/32, N] or null (q4_0) (K
// the stored K, a multiple of 32; N a multiple of 16; planes 16-byte
// aligned), y f32 [M, n_out]. The K the product runs over (Kx rounded up
// to 32) is cut into `splits` runs of k_steps stages (bf16 mode: 64 deep,
// f32 mode: 32 deep; b5_plan), partial is f32 scratch of (row tiles *
// column tiles * splits * 128 * 128) floats where splits > 1 and counters
// int32 zeros, one per 128 x 128 output tile (left zeroed). bf16 = 1: xb
// bf16 [M, K] scratch and `blocks` persistent blocks (at most one an SM).
// Returns the CUDA error code of the launches.
extern "C" int q4_prefill_gemm(const void* x, int M, int Kx, const void* qs,
                               const void* scales, const void* mins, int N,
                               int K, void* xb, int splits, int k_steps,
                               int blocks, void* partial, void* counters,
                               void* y, int n_out, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K % 32 || Kx % 4 || Kx > K || N % 16 || M < 1 || splits < 1 ||
      k_steps < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (!bf16) {
    return mins ? launch_f32<true>((const float*)x, M, Kx, qs, scales, mins,
                                   N, splits, k_steps, partial, counters,
                                   (float*)y, n_out, s)
                : launch_f32<false>((const float*)x, M, Kx, qs, scales,
                                    nullptr, N, splits, k_steps, partial,
                                    counters, (float*)y, n_out, s);
  }
  const size_t quads = (size_t)M * (K / 4);
  cast_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(
      (const float*)x, M, Kx, K, (__nv_bfloat16*)xb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int Kc = (Kx + 31) / 32 * 32;      // x is zero from Kx on
  return mins ? launch_bf16<true>(xb, M, K, Kc, qs, scales, mins, N, splits,
                                  k_steps, blocks, partial, counters,
                                  (float*)y, n_out, s)
              : launch_bf16<false>(xb, M, K, Kc, qs, scales, nullptr, N,
                                   splits, k_steps, blocks, partial,
                                   counters, (float*)y, n_out, s);
}
