// Kernel B3 (entry q4_int8_gemm): the activation-quantized int8 prefill
// matmul, on the register-A kernel of q4_prefill_ra.cuh (built here in its
// int8 mode; the design and its bound are described there). Replaces
// fastllama_tpu/kernels/q4_matmul.py::q4_matmul_prefill_int8 (variant nat,
// _q4mm_prefill_int8_strip_kernel) with the semantics of its exact
// emulation q4_matmul_int8_xla:
//   s8[n]  = max(max_kb |d[kb, n]| * (8/127), 1e-20)       (whole K)
//   w8     = round_half_even((q - 8) * (d * (1 / s8)))     int8
//   acc    = sum_k xq[m, k] * w8[k, n]                     exact int32
//   y[m,n] = (float(acc) * dx[m]) * s8[n]
// The TPU kernel derived s8 per VMEM K-part when its budget split K; here
// s8 always comes from the whole K, as in the emulation. One launch after
// B2: each block takes s8 for its columns from their scale strips and
// requantizes every weight straight into wgmma's A registers, so no int8
// weight plane exists (the design before, a pass that wrote the [N, K]
// plane to HBM and a product that read it back, spent 34-50% of its time
// on that plane; PERF.md).
//
// Kernel B19 (entry q4_int8_gemm_natx): replaces the natx body
// (fastllama_tpu/kernels/q4_matmul.py::_q4mm_prefill_int8_nat_kernel, glue
// at q4_matmul_prefill_int8's natx branch) and the split body, bit-equal to
// it: B3's function on scales divided by s8 (the JAX glue's true division
// d / s8, where B3 multiplies by 1 / s8). One launch after B2, no int8
// plane: natx_cluster_kernel, a thread block cluster of C = 1, 2 or 4
// blocks of 128 rows along M (the least power of two that covers M <= 512,
// so one cluster holds the whole of M) for each 128-column tile. Block r
// of the cluster derives s8 for its share of the tile's columns (128 / C
// of them) from their whole-K scale strips, requantizes that share of
// every stage's weight tile, rne((q - 8) * __fdiv_rn(d, s8)) as
// requant_magic does, into its own weight tile, and sends it to the other
// blocks of the cluster by bulk copies between their shared memories; so
// each weight tile is requantized once for its column tile. Each block's
// consumers run wgmma m64n128k32 with both operands in shared memory.
// Details at natx_cluster_kernel.

#include "common.cuh"
#include "hopper.cuh"
#include "q4_prefill_ra.cuh"

namespace {

// ---------------------------------------------------------------------------
// 1. the requantization's arithmetic
// ---------------------------------------------------------------------------

// rne((q - 8) * sc) in the low byte of the result, for a code q in 0..15
// in the low byte of 2^23's bit pattern (as __byte_perm(codes, 0x4B000000,
// 0x7440 + c) gives it for byte c) and |(q - 8) * sc| <= 127, without a
// conversion instruction: 2^23 + q is exact, so is subtracting 2^23 + 8;
// the product is the same f32 rounding as the plain version's; adding
// 1.5 * 2^23 rounds it half to even to an integer in the low mantissa bits
// (two's complement in the low byte). The _rn intrinsics keep the compiler
// from contracting into an FMA.
__device__ __forceinline__ uint32_t requant_magic(uint32_t magic_q, float sc) {
  const float v = __fadd_rn(__uint_as_float(magic_q), -8388616.0f);
  return __float_as_uint(__fadd_rn(__fmul_rn(v, sc), 12582912.0f));
}

// The low bytes of four words, in order, as one word.
__device__ __forceinline__ uint32_t pack_low_bytes(const uint32_t* w) {
  return __byte_perm(__byte_perm(w[0], w[1], 0x0040),
                     __byte_perm(w[2], w[3], 0x0040), 0x5410);
}

// ---------------------------------------------------------------------------
// 2. B19: the natx product, its requantization shared across a cluster
// ---------------------------------------------------------------------------

constexpr int kBM = 128;               // two consumer warpgroups of 64 rows
constexpr int kBK = 128;               // bytes of K per stage: one swizzle row
constexpr int kConsumers = 2;

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

// wgmma.mma_async m64n128k32 s32 += s8 x s8, A and B from shared memory
// (descriptors), D in 64 registers a thread.
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

constexpr int kNxBN = 128;                       // columns of a column tile
constexpr int kNxStages = 5;                     // xq and weight tiles
constexpr int kNxRawBytes = 40 * 1024;           // the raw ring
constexpr int kNxMaxRaw = 16;                    // its slots at C = 4
constexpr int kNxConvWarps = 8;                  // two groups of four
constexpr int kNxGroup = 32 * kNxConvWarps / 2;  // threads of a group
constexpr int kNxConvThreads = 32 * kNxConvWarps;
constexpr int kNxConsThreads = 128 * kConsumers;
constexpr int kNxThreads = kNxConsThreads + kNxConvThreads + 64;
constexpr int kNxTile = kBM * kBK;               // an xq or weight tile
constexpr int kNxBars = 4 * kNxStages + 2 * kNxMaxRaw;
constexpr int kNxSmem =
    2 * kNxStages * kNxTile + kNxRawBytes + 8 * kNxBars + 1024;

// The converters' named barrier (their two groups use 2 and 3).
__device__ __forceinline__ void natx_conv_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kNxConvThreads) : "memory");
}

// store_tile for BN = 128 with s8 of the tile's columns in shared memory.
__device__ __forceinline__ void store_natx(const int* acc, int m0, int n0,
                                           int t, const float* __restrict__ dx,
                                           const float* s8s, int M, int n_out,
                                           float* __restrict__ y) {
  const int warp = t >> 5, lane = t & 31;
  const bool pairs = (n_out & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + warp * 16 + (lane >> 2) + 8 * r;
    if (m >= M) continue;
    const float dm = dx[m];
    float* yr = y + (size_t)m * n_out;
#pragma unroll
    for (int j = 0; j < kNxBN / 8; ++j) {
      const int nl = 8 * j + 2 * (lane & 3), n = n0 + nl;
      const float v0 = (float)acc[4 * j + 2 * r] * dm * s8s[nl];
      const float v1 = (float)acc[4 * j + 2 * r + 1] * dm * s8s[nl + 1];
      if (pairs && n + 1 < n_out) {
        *reinterpret_cast<float2*>(yr + n) = make_float2(v0, v1);
      } else {
        if (n < n_out) yr[n] = v0;
        if (n + 1 < n_out) yr[n + 1] = v1;
      }
    }
  }
}

// Grid (C, column tiles) in clusters of C x 1 x 1 blocks (C = gridDim.x, so
// a cluster holds the whole of M). Block r takes rows 128 r .. 128 r + 127
// and owns the share of the tile's columns n0 + S r .. n0 + S r + S - 1,
// S = 128 / C: the rows S r .. S r + S - 1 of every block's weight tile
// [128 n][128 k] (K contiguous, the layout TMA's 128-byte swizzle gives
// an [N, K] int8 plane: chunk c of row n at chunk c ^ (n & 7)), S * 128 contiguous
// bytes. Three rings, so that only the weight tiles wait on the cluster:
// xq tiles and weight tiles (kNxStages each, 16 KB a slot) and the raw
// ring (the share's q4 bytes [64 packed rows][S] and scale rows [4][S] a
// stage, 80 S bytes, 4 C slots in kNxRawBytes: 16 stages ahead at C = 4).
// (In one ring, where every load waited on all C blocks' releases, the
// chain load, convert, send, consume, release set the pace; PERF.md.)
// Roles:
//  * two producer warps, one thread each: one keeps the xq ring full with TMA
//    (128-byte swizzle; a slot is free once this block's consumers released
//    it), the other the raw ring (as stored; free once this block's
//    converters are done with it); zeros past M, N and K (a zero code, a
//    zero scale: w8 = 0).
//  * 8 converter warps. First s8 of the share's columns from their whole-K
//    strip (a max, exact in any order), stored into the s8s of every block
//    (st.shared::cluster; the consumers read them after a cluster barrier).
//    Then warps 0-3 take the even stages and 4-7 the odd ones, two stages
//    in flight. A stage waits for its raw slot and for its weight slot to be
//    released by every block's consumers. The group divides the stage's
//    scales by s8 in place, each once, with __fdiv_rn (the plain version's
//    IEEE division). A thread then takes units of 4 adjacent columns by 4
//    packed rows of one q block (lanes: 4 row quarters by 8 column quads, so
//    its 4-byte loads and stores meet 4-way bank conflicts at most at every
//    S), requantizes the 32 codes as requant_magic does (a code into 2^23's
//    bit pattern by one byte permute) and stores each column's 4
//    low-nibble and 4 high-nibble bytes, a word each, into its own block's
//    tile. The group
//    then fences the writes to the async proxy and syncs, and its first
//    thread frees the raw slot, sends the share to each other block of the
//    cluster by one bulk copy (shared::cta to shared::cluster, S * 128
//    bytes), which completes its bytes on that block's conv barrier, and
//    arrives on its own conv barrier expecting the (C - 1) * S * 128 bytes
//    the others send. (Stores of 4 bytes each into the other blocks were
//    several times slower; PERF.md.)
//  * two consumer warpgroups of 64 rows each: wait for the xq tile
//    and the whole weight tile (conv), issue four wgmma m64n128k32 a stage,
//    then release the previous stage: its xq slot here, its weight slot on
//    every block's wempty barrier (none for the last kNxStages stages,
//    which nothing waits for).
// Every thread ends at a cluster barrier, so no block exits while a bulk
// copy still reads its shared memory or writes another's.
// Barriers: xfull (one arrival and the TMA bytes), xempty (2 warpgroups),
// conv (one arrival and the other blocks' bytes), wempty (C x 2
// warpgroups) a stage slot; rfull (one arrival and the TMA bytes), rempty
// (one) a raw slot.
__global__ void __launch_bounds__(kNxThreads, 1)
natx_cluster_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_s,
                    const float* __restrict__ scales,
                    const float* __restrict__ dx, int M, int K, int N,
                    int n_out, float* __restrict__ y) {
  constexpr int S = kNxStages;
  __shared__ __align__(16) float s8s[kNxBN];
  __shared__ float4 red[kNxConvThreads];
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t xs = (raw + 1023) & ~1023u;     // the xq ring
  const uint32_t ws = xs + S * kNxTile;          // the weight ring
  const uint32_t rs = ws + S * kNxTile;          // the raw ring
  uint8_t* base = smem_raw + (xs - raw);
  const uint32_t bars = rs + kNxRawBytes;
  const uint32_t xfull = bars, xempty = xfull + 8 * S, conv = xempty + 8 * S;
  const uint32_t wempty = conv + 8 * S, rfull = wempty + 8 * S;
  const uint32_t rempty = rfull + 8 * kNxMaxRaw;
  const int C = gridDim.x, rank = (int)hopper::cluster_rank();
  const int share = kNxBN / C, quads = share / 4;
  const int qlog = 5 - (C >> 1);                  // log2(quads), C = 1, 2, 4
  const int rslot = (kBK / 2 + kBK / 32 * 4) * share;   // raw bytes a stage
  const int R = kNxRawBytes / rslot;                      // raw slots: 4 C
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kNxBN;
  const int ns = n0 + rank * share;               // the share's first column
  const int nk = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(xfull + 8 * s, 1);
      mbar_init(xempty + 8 * s, kConsumers);
      mbar_init(conv + 8 * s, 1);
      mbar_init(wempty + 8 * s, C * kConsumers);
    }
    for (int r = 0; r < R; ++r) {
      mbar_init(rfull + 8 * r, 1);
      mbar_init(rempty + 8 * r, 1);
    }
    hopper::mbar_init_fence();
  }
  hopper::cluster_sync();      // every block's barriers exist before use

  if (warp >= (kNxConsThreads + kNxConvThreads) / 32) {   // the producers
    hopper::cluster_arrive();
    const bool xq = warp == (kNxConsThreads + kNxConvThreads) / 32;
    if (xq && lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        mbar_wait(xempty + 8 * s, ((kt / S) & 1) ^ 1);
        mbar_expect_tx(xfull + 8 * s, kNxTile);
        tma_load_2d(xs + s * kNxTile, &map_x, xfull + 8 * s, kt * kBK, m0);
      }
    } else if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int r = kt % R;
        const uint32_t q = rs + r * rslot, full = rfull + 8 * r;
        mbar_wait(rempty + 8 * r, ((kt / R) & 1) ^ 1);
        mbar_expect_tx(full, rslot);
        tma_load_2d(q, &map_q, full, ns, kt * (kBK / 2));
        tma_load_2d(q + kBK / 2 * share, &map_s, full, ns, kt * (kBK / 32));
      }
    }
    __syncwarp();
    hopper::cluster_wait();
  } else if (warp >= kNxConsThreads / 32) {        // the converters
    const int ct = threadIdx.x - kNxConsThreads;
    {
      // s8 of the share: thread ct the column quad ct % quads, q blocks
      // ct / quads, + step, ...; then the first quads threads reduce
      const int step = kNxConvThreads / quads, n = ns + 4 * (ct % quads);
      float4 mx = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N) {
        for (int kb = ct / quads; kb < K / 32; kb += step) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              scales + (size_t)kb * N + n));
          mx.x = fmaxf(mx.x, fabsf(v.x));
          mx.y = fmaxf(mx.y, fabsf(v.y));
          mx.z = fmaxf(mx.z, fabsf(v.z));
          mx.w = fmaxf(mx.w, fabsf(v.w));
        }
      }
      red[ct] = mx;
      natx_conv_sync();
      if (ct < quads) {
        for (int j = 1; j < step; ++j) {
          const float4 v = red[ct + j * quads];
          mx.x = fmaxf(mx.x, v.x);
          mx.y = fmaxf(mx.y, v.y);
          mx.z = fmaxf(mx.z, v.z);
          mx.w = fmaxf(mx.w, v.w);
        }
        const float f = (float)(8.0 / 127.0), lo = (float)1e-20;
        const float sv[4] = {fmaxf(mx.x * f, lo), fmaxf(mx.y * f, lo),
                             fmaxf(mx.z * f, lo), fmaxf(mx.w * f, lo)};
        const uint32_t at = smem_u32(&s8s[rank * share + 4 * ct]);
        for (int r = 0; r < C; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            hopper::st_cluster(hopper::mapa(at + 4 * c, r),
                               __float_as_uint(sv[c]));
      }
      natx_conv_sync();
      hopper::cluster_arrive();
    }
    const int grp = (warp - kNxConsThreads / 32) >> 2;
    const int gt = ct % kNxGroup;
    const int bytes = share * kBK;                   // the share's rows
    for (int g = grp; g < nk; g += 2) {
      const int s = g % S, r = g % R;
      mbar_wait(rfull + 8 * r, (g / R) & 1);           // q4 bytes, scales
      mbar_wait(wempty + 8 * s, ((g / S) & 1) ^ 1);
      const uint8_t* q4 = base + (rs - xs) + r * rslot;
      float* sc = reinterpret_cast<float*>(base + (rs - xs) + r * rslot +
                                           kBK / 2 * share);
      uint8_t* wt = base + (ws - xs) + s * kNxTile;
      // the stage's scales divided by s8 in place, each once (__fdiv_rn:
      // the plain version's IEEE division)
      for (int i = gt; i < kBK / 32 * share; i += kNxGroup)
        sc[i] = __fdiv_rn(sc[i], s8s[rank * share + (i & (share - 1))]);
      asm volatile("bar.sync %0, %1;\n" ::"r"(2 + grp), "n"(kNxGroup)
                   : "memory");
      for (int u = gt; u < 4 * share; u += kNxGroup) {
        // unit: row quarter qr of q block b, column quad c4 of the share
        const int qr = u & 3, c4 = (u >> 2) & (quads - 1), b = u >> (2 + qlog);
        const float4 d = *reinterpret_cast<const float4*>(
            sc + b * share + 4 * c4);
        const float scv[4] = {d.x, d.y, d.z, d.w};
        uint32_t lo[4], hi[4];           // the low and high nibbles
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(
              q4 + (16 * b + 4 * qr + i) * share + 4 * c4);
          lo[i] = word & 0x0F0F0F0Fu;
          hi[i] = (word >> 4) & 0x0F0F0F0Fu;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint32_t l4[4], h4[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            l4[i] = requant_magic(__byte_perm(lo[i], 0x4B000000u, 0x7440 + c),
                                  scv[c]);
            h4[i] = requant_magic(__byte_perm(hi[i], 0x4B000000u, 0x7440 + c),
                                  scv[c]);
          }
          // the column's row of the tile; its bytes k = 32 b + 4 qr .. + 3
          // (chunk 2 b) and 16 further on (chunk 2 b + 1)
          const int row = rank * share + 4 * c4 + c, sw = row & 7;
          uint8_t* at = wt + row * kBK + 4 * qr;
          *reinterpret_cast<uint32_t*>(at + (((2 * b) ^ sw) << 4)) =
              pack_low_bytes(l4);
          *reinterpret_cast<uint32_t*>(at + (((2 * b + 1) ^ sw) << 4)) =
              pack_low_bytes(h4);
        }
      }
      hopper::fence_proxy_async();
      asm volatile("bar.sync %0, %1;\n" ::"r"(2 + grp), "n"(kNxGroup)
                   : "memory");
      if (gt == 0) {
        mbar_arrive(rempty + 8 * r);
        const uint32_t mine = ws + s * kNxTile + rank * bytes;
        for (int p = 0; p < C; ++p)
          if (p != rank)
            hopper::bulk_copy_cluster(hopper::mapa(mine, p), mine, bytes,
                                      hopper::mapa(conv + 8 * s, p));
        mbar_expect_tx(conv + 8 * s, (C - 1) * bytes);
      }
      __syncwarp();
    }
    hopper::cluster_wait();
  } else {                                         // the consumers
    // warpgroup wg owns rows m0 + 64 wg .. m0 + 64 wg + 63
    hopper::cluster_arrive();
    const int wg = warp >> 2, t = threadIdx.x & 127;
    int acc[kNxBN / 2];
#pragma unroll
    for (int i = 0; i < kNxBN / 2; ++i) acc[i] = 0;
    fence_regs<kNxBN / 2>(acc);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S, ph = (kt / S) & 1;
      mbar_wait(xfull + 8 * s, ph);                         // xq landed
      mbar_wait(conv + 8 * s, ph);          // weight tile
      const uint32_t a = xs + s * kNxTile + wg * 64 * kBK;
      const uint32_t b = ws + s * kNxTile;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK; k += 32)
        wgmma_n128(acc, sw128_desc(a + k), sw128_desc(b + k));
      wgmma_commit();
      fence_regs<kNxBN / 2>(acc);
      wgmma_wait<1>();               // the previous stage's products are done
      if (kt > 0) {
        const int sp = (kt - 1) % S;
        if (t == 0) mbar_arrive(xempty + 8 * sp);
        if (kt - 1 < nk - S && t < C)
          hopper::mbar_arrive_cluster(hopper::mapa(wempty + 8 * sp, t));
      }
    }
    wgmma_wait<0>();
    fence_regs<kNxBN / 2>(acc);
    hopper::cluster_wait();          // every block's s8 share has landed
    store_natx(acc, m0 + wg * 64, n0, t, dx, s8s, M, n_out, y);
  }
  hopper::cluster_sync();
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

// B19's cluster size: the least power of two of 128-row blocks covering M.
int natx_cluster(int M) { return M <= kBM ? 1 : M <= 2 * kBM ? 2 : 4; }

cudaError_t natx_attributes() {
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        natx_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kNxSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  return cudaSuccess;
}

int launch_natx(const void* xq, const float* dx, int M, int K,
                const void* qs, const float* scales, int N, float* y,
                int n_out, cudaStream_t stream) {
  cudaError_t err = natx_attributes();
  if (err != cudaSuccess) return (int)err;
  const int C = natx_cluster(M);
  const int share = kNxBN / C;
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap map_x, map_q, map_s;
  if (!make_map(&map_x, xq, M, K, kBK, kBM) ||
      !hopper::make_map(&map_q, qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2,
                        N, share, kBK / 2, none) ||
      !hopper::make_map(&map_s, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        K / 32, N, share, kBK / 32, none))
    return (int)cudaErrorInvalidValue;
  return (int)hopper::launch_cluster(
      natx_cluster_kernel, dim3(C, (N + kNxBN - 1) / kNxBN), dim3(kNxThreads),
      C, kNxSmem, stream, map_x, map_q, map_s, scales, dx, M, K, N, n_out, y);
}

}  // namespace

// Kernel B19: xq int8 [M, K] and dx f32 [M] (B2's), qs uint8 [K/2, N], the
// raw scales f32 [K/32, N] (1 <= M <= 512, K a multiple of 64, N of 16,
// planes 16-byte aligned), y f32 [M, n_out]: y = (float(acc) * dx) * s8
// with s8 as B3's and w8 = round_half_even((q - 8) * (d / s8)). One
// launch; returns its CUDA error code.
extern "C" int q4_int8_gemm_natx(const void* xq, const void* dx, int M,
                                 int K, const void* qs, const void* scales,
                                 int N, void* y, int n_out, void* stream) {
  if (M < 1 || M > 4 * kBM || K % 64 || N % 16)
    return (int)cudaErrorInvalidValue;
  return launch_natx(xq, (const float*)dx, M, K, qs, (const float*)scales,
                     N, (float*)y, n_out, (cudaStream_t)stream);
}

// How many of B19's clusters at M rows the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error code.
extern "C" int q4_int8_natx_clusters(int M) {
  cudaError_t err = natx_attributes();
  if (err != cudaSuccess) return -(int)err;
  const int C = natx_cluster(M);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1);
  cfg.blockDim = dim3(kNxThreads);
  cfg.dynamicSmemBytes = kNxSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, natx_cluster_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Kernel B3: xq int8 [M, K] and dx f32 [M] (B2's; K the stored K, a
// multiple of 32), qs uint8 [K/2, N], scales f32 [K/32, N] (N a multiple of
// 16, planes 16-byte aligned), y f32 [M, n_out] = (float(acc) * dx) * s8
// with s8 from the whole K and w8 = rne((q - 8) * (d * (1 / s8))): one
// launch of the register-A kernel (q4_prefill_ra.cuh) on bx rows of x and
// wgs warpgroups a block, the tiles from t0 on with K cut into `splits`
// runs of k_steps 128-deep stages, `blocks` persistent blocks; partial f32
// scratch of ra::gemm's size where splits > 1, counters int32 zeros, one a
// tile. Returns the CUDA error code of the launch.
extern "C" int q4_int8_gemm(const void* xq, const void* dx, int M, int K,
                            const void* qs, const void* scales, int N,
                            int bx, int wgs, int t0, int splits,
                            int k_steps, int blocks, void* partial,
                            void* counters, void* y, int n_out,
                            void* stream) {
  return ra::gemm<ra::kInt8>(xq, M, K, K, qs, scales, nullptr, dx, N, bx,
                             wgs, t0, splits, k_steps, blocks, partial,
                             counters, y, n_out, (cudaStream_t)stream);
}
