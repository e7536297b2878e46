// Kernel B12: causal flash attention over a fresh prompt window.
//
// Replaces fastllama_tpu/models/llama.py:288 _flash_prefill_attention, which
// calls the library Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention (causal,
// sm_scale = 1/sqrt(Dh), blocks of min(T, 512) rows). For each (b, h) and
// query row i of the window (n_past == 0, so the window's own K/V is the
// whole context):
//   s_ij = dot(q_i, k_j) * scale       bf16 operands, f32 sums, keys j <= i
//   ctx_i = sum_j bf16(exp(s_ij - m_i)) v_j / sum_j exp(s_ij - m_i)
// with an online softmax over key tiles (m the running max, l the running
// sum of the unrounded p), p rounded to bf16 for the PV product as the
// library's p.astype(v.dtype) does, and the output rounded to bf16 once
// (the library's o_tile_ref.dtype). The result is stored as f32.
//
// Bound on the H100: at 7B (32 heads, Dh 128) and T = 512 the window does
// 4 * 32 * 128 * 131,328 causal pairs = 2.15 GFLOP (2.2 us at 989 TFLOP/s)
// and moves 21.0 MB (bf16 q, k, v and the f32 output; 6.3 us at
// 3.35 TB/s): bytes. At T = 2048 it is 34.4 GFLOP (34.8 us) against
// 83.9 MB (25.0 us): operations.
//
// Design (FlashAttention-3's shape): the operands are bf16 [B, T, H, Dh]
// views with any 16-byte B/T/H strides (the forward passes the roped q and
// the slab cache's K/V rows), read by TMA through 4-D tensor maps in boxes
// of 64 columns (128 bytes, the 128-byte swizzle that wgmma reads). A
// block takes one work item: a tile of 64 * NC query rows of one (b, h) and
// a run of its key tiles (all of them, or one split of them; b12_plan in
// flash_prefill.py picks NC, the key stages and the split). Items are
// launched heaviest first. Warp-specialized:
//   * one producer warp whose first thread loads the Q tile once and keeps
//     a ring of K/V stages in flight: K and V each under their own full
//     barrier, a stage reused once every consumer has released it;
//   * NC consumer warpgroups of 64 query rows issue wgmma.mma_async:
//     S = Q K^T (m64nBNk16, Q and K K-major from shared memory), the online
//     softmax on the accumulators in registers (a row over a quad of
//     lanes: two shuffles), P rounded to bf16 as the register A operand
//     (the accumulator layout is the A fragment layout), O += P V
//     (m64nDk16, V MN-major through the transpose bit). A tile's products
//     and softmax run in turn within a warpgroup; two warpgroups
//     interleave on an SM. Overlapping tile j's softmax with tile j - 1's
//     PV product (FlashAttention-3's pipelining) needs P in registers apart
//     from S: at 64-key tiles, or at 128 with a producer warpgroup giving
//     its registers to the consumers (setmaxnreg 24 / 240). Both measured
//     slower on the H100 than this (PERF.md; tools_torch/b12_sweep.py), so
//     the kernel keeps one register set for S, p and P and a one-warp
//     producer.
//   Tiles above a warpgroup's rows are skipped; only the diagonal tiles
//   are masked. A split item stores its partial (m, l, unnormalized O) to
//   scratch; the last split of a query tile to finish, elected by a
//   counter it resets, merges the partials in split order (deterministic).
// The scores never touch device memory. The head width D is 128 or 256.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::sw128_desc;
using hopper::sw128_mn_desc;
using hopper::tma_load_4d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

// wgmma.mma_async m64n64k16 f32 += bf16 x bf16, A and B K-major from
// shared memory (descriptors); scale_d 0 overwrites D. D in 32 registers.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma.mma_async m64n128k16 f32 += bf16 x bf16, A and B K-major from
// shared memory (descriptors); scale_d 0 overwrites D. D in 64 registers.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma.mma_async m64n128k16 f32 += bf16 x bf16, A from registers (four
// 32-bit registers of bf16 pairs, the accumulator layout), B MN-major
// (transposed) from shared memory. D in 64 registers.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// wgmma.mma_async m64n256k16 f32 += bf16 x bf16, A from registers (four
// 32-bit registers of bf16 pairs, the accumulator layout), B MN-major
// (transposed) from shared memory. D in 128 registers.
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t db) {
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// Two f32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x (ex2.approx.ftz: relative error ~2^-22, 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr int kMaxStages = 4;

// The block's shape for head width D and NC consumer warpgroups (two only
// at D 128). A consumer holds O in D / 2 registers and S (then p, then P
// packed to bf16 in its own first BN / 4) in BN / 2: 128 at D 128 with
// 128-key tiles, 160 at D 256 with 64. Two consumers get 168 registers a
// thread (an SM sub-partition holds three of their nine warps), one 255.
template <int D, int NC> struct Shape {
  static constexpr int kBM = 64 * NC;            // query rows
  static constexpr int kBN = D == 128 ? 128 : 64;   // key rows a tile
  static constexpr int kChunks = D / 64;         // 128-byte column boxes
  static constexpr int kThreads = 128 * NC + 32;    // + the producer warp
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kPartial = D / 2 + 4;     // floats a consumer thread
  static constexpr int smem(int stages) {
    return 1024 + kQBytes + stages * kStageBytes + 8 * (1 + 3 * kMaxStages);
  }
};

// What every block reads of the plan (b12_plan in flash_prefill.py):
// query tiles n_qt a head, key tiles a split kchunk, the first query tile
// whose keys are split (n_qt when none is) and the most splits of a tile.
struct Plan {
  int B, T, H, n_qt, kchunk, stages, split_from, max_splits;
  float scale_log2;                 // 1/sqrt(Dh) * log2(e)
};

// A work item: query rows q0 .. q0 + BM - 1 of (b, h), key tiles kt0 ..
// kt0 + nkt - 1, split z of nsplit; tile indexes the scratch and counter
// of a split query tile. Items go heaviest first: item w is (b, h) =
// w % (B H) of the w / (B H)-th item of a head, whose items run from the
// last query tile (the most keys) to the first, splits in order.
struct Item {
  int b, h, q0, kt0, nkt, nsplit, z, tile;
};

template <int BM, int BN>
__device__ __forceinline__ Item decode(int w, const Plan& p) {
  const int bh = w % (p.B * p.H);
  int r = w / (p.B * p.H);
  Item it{bh / p.H, bh % p.H, 0, 0, 0, 1, 0, -1};
  for (int i = p.n_qt - 1; i >= 0; --i) {
    const int nk = ((i + 1) * BM + BN - 1) / BN;
    const int ns = (nk + p.kchunk - 1) / p.kchunk;
    if (r < ns) {
      it.q0 = i * BM;
      it.z = r;
      it.nsplit = ns;
      it.kt0 = r * p.kchunk;
      it.nkt = min(nk - it.kt0, p.kchunk);
      if (ns > 1)
        it.tile = bh * (p.n_qt - p.split_from) + (i - p.split_from);
      break;
    }
    r -= ns;
  }
  return it;
}

template <int NC> __device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NC) : "memory");
}

template <int D, int NC>
__global__ void __launch_bounds__(Shape<D, NC>::kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const Plan p,
                     float* __restrict__ out, float* __restrict__ partial,
                     int* __restrict__ counters) {
  using S = Shape<D, NC>;
  constexpr int BM = S::kBM, BN = S::kBN, NT = 128 * NC;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int is_last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;           // the Q tile
  const uint32_t ring = sq + S::kQBytes;               // stages: [K | V]
  const uint32_t bars = ring + p.stages * S::kStageBytes;
  const uint32_t bar_q = bars;                         // + k, v full, empty
  const Item it = decode<BM, BN>(blockIdx.x, p);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + kMaxStages + s), 1);
      mbar_init(bars + 8 * (1 + 2 * kMaxStages + s), NC);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= NT) {                             // the producer warp
    if (threadIdx.x == NT) {
      mbar_expect_tx(bar_q, S::kQBytes);
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c)
        tma_load_4d(sq + c * BM * 128, &map_q, bar_q, 64 * c, it.h, it.q0,
                    it.b);
      for (int j = 0; j < it.nkt; ++j) {
        const int s = j % p.stages;
        const uint32_t full_k = bars + 8 * (1 + s);
        const uint32_t full_v = bars + 8 * (1 + kMaxStages + s);
        mbar_wait(bars + 8 * (1 + 2 * kMaxStages + s),
                  ((j / p.stages) & 1) ^ 1);
        const uint32_t kst = ring + s * S::kStageBytes;
        const int k0 = (it.kt0 + j) * BN;
        mbar_expect_tx(full_k, S::kTileBytes);
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c)
          tma_load_4d(kst + c * BN * 128, &map_k, full_k, 64 * c, it.h, k0,
                      it.b);
        mbar_expect_tx(full_v, S::kTileBytes);
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c)
          tma_load_4d(kst + S::kTileBytes + c * BN * 128, &map_v, full_v,
                      64 * c, it.h, k0, it.b);
      }
    }
    return;
  }

  // the consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63; this
  // thread rows r0 and r0 + 8 (the accumulator layout), key columns
  // 8 n + c2, + 1 of each 8
  const int cw = threadIdx.x >> 7, t = threadIdx.x & 127, ct = threadIdx.x;
  const int lane = t & 31, c2 = 2 * (lane & 3);
  const int wg_row0 = it.q0 + 64 * cw;
  const int r0 = wg_row0 + 16 * (t >> 5) + (lane >> 2);
  // the item's tiles that hold a key at or below one of this warpgroup's
  // rows (keys and rows start at multiples of 64, so every row of such a
  // tile has one)
  const int n_mine = max(0, min(it.nkt, (wg_row0 + 63) / BN + 1 - it.kt0));
  const uint32_t qa = sq + cw * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[BN / 2];                          // S, p, then P in bf16 pairs
  float m0 = -INFINITY, m1 = -INFINITY;      // running max, log2 units
  float l0 = 0.f, l1 = 0.f;                  // this lane's part of the sums

  auto issue_s = [&](int j) {                // S = Q K_j^T
    const uint32_t kst = ring + (j % p.stages) * S::kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk >> 2, in = (kk & 3) * 32;
      wgmma_ss<BN>(sc, sw128_desc(qa + c * BM * 128 + in),
                   sw128_desc(kst + c * BN * 128 + in), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int j) {               // O += P V_j
    const uint32_t vst =
        ring + (j % p.stages) * S::kStageBytes + S::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {
          __float_as_uint(sc[4 * kk]), __float_as_uint(sc[4 * kk + 1]),
          __float_as_uint(sc[4 * kk + 2]), __float_as_uint(sc[4 * kk + 3])};
      wgmma_rs<D>(o, a, sw128_mn_desc(vst + kk * 2048, BN * 128, 1024));
    }
    wgmma_commit();
  };
  // the online softmax of tile j's scores, p left in sc; a0, a1 rescale O
  auto softmax = [&](int j, float& a0, float& a1) {
    const int k0 = (it.kt0 + j) * BN;
    if (k0 + BN - 1 > wg_row0) {             // a diagonal tile
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * n + c2 + (e & 1) > r0 + 8 * (e >> 1))
            sc[4 * n + e] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    // the max of the scaled scores is the scaled max (a positive scale
    // keeps the order, and rounding too)
    const float mn0 = fmaxf(m0, quad_max(mx0) * p.scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * p.scale_log2);
    a0 = ex2(m0 - mn0);                      // 0 on the first tile
    a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], p.scale_log2,
                                 -(e < 2 ? mn0 : mn1)));
      l0 += sc[4 * n] + sc[4 * n + 1];
      l1 += sc[4 * n + 2] + sc[4 * n + 3];
    }
  };
  // p to bf16 as the A fragments of the PV product, in sc's own first
  // BN / 4 registers: fragment kk (keys 16 kk + 2 c, + 1 and + 8, of rows
  // r0 and r0 + 8) at 4 kk; register 2 n takes what 4 n and 4 n + 1 held,
  // already read
  auto pack_in_place = [&]() {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const uint32_t lo = pack_bf16(sc[4 * n], sc[4 * n + 1]);
      const uint32_t hi = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
      sc[2 * n] = __uint_as_float(lo);
      sc[2 * n + 1] = __uint_as_float(hi);
    }
  };
  auto rescale = [&](float a0, float a1) {
    // where a row's max moved (past the first tiles, seldom: a warp whose
    // rows all kept theirs skips the multiplies)
    if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= a0;
        o[4 * n + 1] *= a0;
        o[4 * n + 2] *= a1;
        o[4 * n + 3] *= a1;
      }
    }
  };

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_mine; ++j) {
    const int s = j % p.stages;
    float a0, a1;
    mbar_wait(bars + 8 * (1 + s), (j / p.stages) & 1);
    issue_s(j);
    wgmma_wait<0>();
    fence_regs<BN / 2>(sc);
    softmax(j, a0, a1);
    if (j > 0) rescale(a0, a1);
    pack_in_place();
    mbar_wait(bars + 8 * (1 + kMaxStages + s), (j / p.stages) & 1);
    issue_pv(j);
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    fence_regs<BN / 4>(sc);
    if (t == 0) mbar_arrive(bars + 8 * (1 + 2 * kMaxStages + s));
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  const long long row_stride = (long long)p.H * D;
  float* o0 = out + ((long long)it.b * p.T + r0) * row_stride +
              (long long)it.h * D + c2;
  float* o1 = o0 + 8 * row_stride;
  if (it.nsplit > 1) {
    // store this split's (O, m, l), value i of consumer thread ct at
    // i * NT + ct; the last split to count in merges them all in order
    float* tile = partial + (size_t)it.tile * p.max_splits * S::kPartial * NT;
    float* mine = tile + (size_t)it.z * S::kPartial * NT + ct;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) mine[i * NT] = o[i];
    mine[(D / 2) * NT] = m0;
    mine[(D / 2 + 1) * NT] = m1;
    mine[(D / 2 + 2) * NT] = l0;
    mine[(D / 2 + 3) * NT] = l1;
    __threadfence();
    consumers_sync<NC>();
    if (ct == 0) is_last = atomicAdd(&counters[it.tile], 1) == it.nsplit - 1;
    consumers_sync<NC>();
    if (!is_last) return;
    if (ct == 0) counters[it.tile] = 0;
    __threadfence();
    const float* pt = tile + ct;
    float mm0 = -INFINITY, mm1 = -INFINITY;
    for (int z = 0; z < it.nsplit; ++z) {
      const float* pz = pt + (size_t)z * S::kPartial * NT;
      mm0 = fmaxf(mm0, __ldcg(pz + (D / 2) * NT));
      mm1 = fmaxf(mm1, __ldcg(pz + (D / 2 + 1) * NT));
    }
    l0 = l1 = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int z = 0; z < it.nsplit; ++z) {
      const float* pz = pt + (size_t)z * S::kPartial * NT;
      const float w0 = ex2(__ldcg(pz + (D / 2) * NT) - mm0);
      const float w1 = ex2(__ldcg(pz + (D / 2 + 1) * NT) - mm1);
      l0 += __ldcg(pz + (D / 2 + 2) * NT) * w0;
      l1 += __ldcg(pz + (D / 2 + 3) * NT) * w1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        o[i] += __ldcg(pz + i * NT) * ((i & 2) ? w1 : w0);
    }
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(o0 + 8 * n) =
        make_float2(fltorch::round_bf16(o[4 * n] * i0),
                    fltorch::round_bf16(o[4 * n + 1] * i0));
    *reinterpret_cast<float2*>(o1 + 8 * n) =
        make_float2(fltorch::round_bf16(o[4 * n + 2] * i1),
                    fltorch::round_bf16(o[4 * n + 3] * i1));
  }
}

// Query tiles' key-tile counts and splits, as decode() walks them.
struct Grid {
  int n_qt, split_from, max_splits, items;
};

Grid grid_of(int B, int T, int H, int BM, int BN, int kchunk) {
  Grid g{T / BM, T / BM, 1, 0};
  for (int i = g.n_qt - 1; i >= 0; --i) {
    const int ns = (((i + 1) * BM + BN - 1) / BN + kchunk - 1) / kchunk;
    if (ns > 1) g.split_from = i;
    g.max_splits = max(g.max_splits, ns);
    g.items += ns;
  }
  g.items *= B * H;
  return g;
}

template <int D, int NC>
int launch(const void* q, const void* k, const void* v,
           const long long* strides, int B, int T, int H, int stages,
           int kchunk, float scale, void* out, void* partial,
           void* counters, cudaStream_t stream) {
  using S = Shape<D, NC>;
  const int smem = S::smem(stages);
  if (T % S::kBM || stages < 2 || stages > kMaxStages || smem > 232448 - 16)
    return (int)cudaErrorInvalidValue;
  const Grid g = grid_of(B, T, H, S::kBM, S::kBN, kchunk);
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    // [B, T, H, D] innermost first; with one batch row its stride is moot
    const long long* st = strides + 3 * i;
    const long long dims[4] = {D, H, T, B};
    const long long bytes[3] = {2 * st[2], 2 * st[1],
                                2 * (B > 1 ? st[0] : st[1] * T)};
    const int box[4] = {64, 1, i == 0 ? S::kBM : S::kBN, 1};
    if (!hopper::make_map_4d(&maps[i], ptrs[i],
                             CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dims, bytes,
                             box))
      return (int)cudaErrorInvalidValue;
  }
  const Plan p{B, T, H, g.n_qt, kchunk, stages, g.split_from, g.max_splits,
               scale * 1.4426950408889634f};
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_prefill_kernel<D, NC><<<g.items, S::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], p, static_cast<float*>(out),
      static_cast<float*>(partial), static_cast<int*>(counters));
  return (int)cudaGetLastError();
}

}  // namespace

// B12. q, k, v bf16 [B, T, H, Dh] (element strides sb, st, sh each, all
// multiples of 8; the last axis contiguous; 16-byte aligned); out f32
// [B, T, H, Dh] contiguous. The plan (b12_plan): nc consumer warpgroups
// (query tiles of 64 nc rows), `stages` K/V stages, `kchunk` key tiles a
// split. partial: f32 scratch of the split tiles' partials, counters:
// int32 zeros, one a split tile (left zeroed). Dh must be 128 or 256 and T
// a multiple of 64 nc. Returns the CUDA error code of the launch.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             long long qsb, long long qst, long long qsh,
                             long long ksb, long long kst, long long ksh,
                             long long vsb, long long vst, long long vsh,
                             int B, int T_len, int H, int d, int nc,
                             int stages, int kchunk, float scale, void* out,
                             void* partial, void* counters, void* stream) {
  if (T_len <= 0 || B <= 0 || H <= 0 || kchunk <= 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128 && nc == 1)
    return launch<128, 1>(q, k, v, st, B, T_len, H, stages, kchunk, scale,
                          out, partial, counters, s);
  if (d == 128 && nc == 2)
    return launch<128, 2>(q, k, v, st, B, T_len, H, stages, kchunk, scale,
                          out, partial, counters, s);
  if (d == 256 && nc == 1)
    return launch<256, 1>(q, k, v, st, B, T_len, H, stages, kchunk, scale,
                          out, partial, counters, s);
  return (int)cudaErrorInvalidValue;
}
