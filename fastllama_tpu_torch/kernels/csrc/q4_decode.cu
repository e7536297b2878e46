// Kernels B1 and B9: the decode-size 4-bit matmuls (W4A16 skinny GEMM /
// GEMV) for q4_0 and for affine (q4_1 / GPTQ) weights, one template.
//
// B1 (q4_gemv):
// Replaces fastllama_tpu/kernels/q4_matmul.py::q4_matmul_pallas with the
// function of its v0 body (_q4mm_kernel) and of q4_matmul_xla; the other
// bodies (v1-v7: B15-B18) run csrc/q4_fold.cuh. Computes y[M, n_out] f32 = x[M, K] @
// ((q - 8) * d) for M <= 64, reading the split-K packed planes as stored:
//   qs     uint8 [K_pad/2, N]: byte (16*kb + j, n) holds element 32*kb + j in
//          its low nibble and element 32*kb + 16 + j in its high nibble;
//   scales f32   [K_pad/32, N].
// In bf16 mode x and each dequantized weight are rounded to bf16 before the
// product (as q4_matmul_xla does); products of two bf16 values are exact in
// f32, so only the f32 summation order differs from a dense matmul. In f32
// mode nothing is rounded.
//
// B9 (q41_gemv in f32 mode, q41_gemv_mma in bf16 mode) replaces
// q41_matmul_pallas (_q41mm_kernel) in the same file: the weight is
// w = q * d + m with a second f32 plane mins [K_pad/32, N], and the kernel
// computes
//   y = R(x) @ R(q * d) + bsum(x) @ m
// where R rounds to bf16 in bf16 mode (identity in f32 mode) and bsum[m, kb]
// is the sum of the UNROUNDED f32 x over q block kb; the product with the
// mins is a plain f32 one. So the offset plane never meets a bf16 rounding
// (which x @ R(q * d + m) would give it). Padded blocks have d = m = 0 and
// code 0, so they add nothing.
//
// Bound on the H100 (both): bytes. At M = 1 the kernel does 2 flops per weight
// element and reads 0.625 bytes per element (packed nibbles plus an f32
// scale per 32), far below the ~295 flop/byte ridge: the time is the weight
// planes over 3.35 TB/s, and reaching it takes many loads in flight. So:
//   * a lane owns COLS adjacent columns and loads the 16 packed rows of a q
//     block as 16 independent COLS-byte loads (a warp reads 32*COLS
//     contiguous bytes per row), all issued before any is used;
//   * the 8 warps of a block own the same columns and take interleaved q
//     blocks of the block's K range, then add their partial sums through
//     shared memory;
//   * K is also split across blocks (split-K) so that the small-N matrices
//     fill the 132 SMs; the last block to finish an output tile (an atomic
//     counter per tile) adds the [splits, M, N] partials in split order, so
//     the result is deterministic run to run and there is no second launch.
// The block's slice of x is staged once in shared memory (rounded to bf16
// in bf16 mode); past x's K it reads as zero, so x is never padded. B9 also
// stages the block sums of its slice (one f32 per row and q block, summed
// from the unrounded x in k order) and adds bsum * m once per q block.
//
// B1 and B9 in bf16 mode (q4_gemv_mma, q41_gemv_mma) run on the tensor
// cores instead. At M = 8 the FFMA kernel above spends 16 scalar products
// (half of them on zero rows) and a shared-memory read of x per weight
// element, so it is bound by instruction issue, an order of magnitude off
// the byte bound on the H100. Here
// y^T = W^T x^T with mma.sync m16n8k16 bf16 -> f32:
//   * the dequantized weight is the A operand (16 output columns x 16 k),
//     the rows of x are the N side (8 per MMA: M <= 8 is one n-tile, M <= 16
//     two, larger M 4 and a grid of 32-row tiles);
//   * one q block's 16 packed byte rows give k = 0..15 (low nibbles) and
//     k = 16..31 (high nibbles): two k16 steps from the same bytes;
//   * a warp owns 64 adjacent columns (4 m-tiles). The 4 warps of a block
//     form cw column groups of 4 / cw warps: a wide plane takes cw = 4 (256
//     adjacent columns, every warp streams all q blocks of the split), a
//     narrow one cw = 1 (64 columns, the warps take every fourth q block
//     and add up through shared memory), so that few splits (at most 8)
//     fill the card. A warp's A fragments need packed rows
//     2t, 2t+1, 2t+8, 2t+9 (t = lane % 4) of two columns per m-tile; the
//     columns of m-tile mt are permuted so that a lane's 8 columns are
//     adjacent bytes: column g*8 + 2*mt + (i >= 8) holds MMA row i (g = lane
//     / 4, i = g or g + 8). So a lane reads each of its 4 rows as one 8-byte
//     word, and a 16-byte pad per 64-byte row (stride 80) keeps those reads
//     free of bank conflicts (tests/test_torch_q4_matmul.py holds a copy of
//     this map in Python);
//   * each warp streams its q blocks through its own 4-stage cp.async ring
//     of [16 rows x 64 columns] bytes plus the 64 scales (3 q blocks in
//     flight per warp, 24 KB of ring per block, so that 5-7 blocks fit on
//     an SM), so no block barrier sits in the loop;
//   * x is staged once per block as bf16 in fragment order (coalesced
//     float4 reads; one 16-byte shared read per lane, n-tile and q block);
//   * dequantization is the instruction cost, kept to about four per
//     element while bf16((q - 8) * d) stays exact: the nibble is placed in a
//     float's mantissa by one byte permute (2^23 + q), one subtraction gives
//     q - 8, one f32 multiply by d, and cvt.rn.bf16x2 packs two values;
//   * split-K and the last block's ordered reduction are as above.
// Products of two bf16 values are exact in f32, so only the summation order
// differs from the dense product. f32 mode stays on the FFMA kernel (the
// tensor cores have no exact f32 product; TF32 would round the operands).
//
// B9 in bf16 mode is the same tensor-core kernel with AFFINE set, for the
// same reason: the weight bytes grow by a fifth (24 against 20 per 32
// weights), the instructions per q block by 16 * NT FFMAs. What AFFINE
// changes:
//   * the nibble becomes q, not q - 8 (2^23 is subtracted after the byte
//     permute, not 2^23 + 8), so R(q * d) is still one f32 multiply and one
//     rounding, exact as the plain version computes it;
//   * each ring stage carries the 64 mins of the warp's columns beside the
//     64 scales (a third 16-byte cp.async, in lanes 16-31: 1792 bytes a
//     stage, 28 KB of ring per block);
//   * the block stages bsum, the f32 sums of its UNROUNDED x slice over each
//     q block, [q blocks of the split][rows of the tile], while it stages x:
//     the 8 lanes that load one row's q block add their float4s and reduce
//     by three shuffles. Rows >= M of the tile get 0;
//   * after the two k16 MMAs of a q block, a lane adds bsum[row] * m[col] to
//     each of its accumulators: its D fragments cover the same 8 columns
//     whose scales it reads, so the term costs 16 * NT FFMAs per q block
//     beside about 224 dequantization instructions. The term goes into the
//     MMA's accumulator itself, not a separate one: a second accumulator
//     would cost 16 * NT more registers (64 at M > 16) for a difference of
//     summation order only; the mins product is a true f32 one either way.
//
// SC16 (the "h" forms of the JAX tools, B1 as v0h, q4_variant_mma): the
// scales are bf16
// [NB, N]; a ring stage carries 128 bytes of them (8 lanes' copies), read
// as one 16-byte word a lane and widened to f32.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int COLS> struct Packed;
template <> struct Packed<4> {
  using T = uint32_t;
  static __device__ __forceinline__ int byte(T v, int c) {
    return (v >> (8 * c)) & 0xFF;
  }
};
template <> struct Packed<8> {
  using T = uint2;
  static __device__ __forceinline__ int byte(T v, int c) {
    return ((c < 4 ? v.x : v.y) >> (8 * (c & 3))) & 0xFF;
  }
};

template <int MT, int COLS, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
q4_gemv_kernel(const float* __restrict__ x, int M, int Kx,
               const uint8_t* __restrict__ qs,
               const float* __restrict__ scales,
               const float* __restrict__ mins, int N, int NB,
               int kb_per_split, float* __restrict__ partial,
               int* __restrict__ counters, float* __restrict__ y, int n_out,
               int bf16) {
  using PT = typename Packed<COLS>::T;
  constexpr int BN = 32 * COLS;
  extern __shared__ float smem[];        // x slice [, block sums], then
                                         // warp partials
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * BN + lane * COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int kb0 = split * kb_per_split;
  const int nkb = min(NB, kb0 + kb_per_split) - kb0;
  const int width = nkb * 32;

  for (int i = threadIdx.x; i < MT * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    const int m = m0 + r, k = kb0 * 32 + c;
    const float v = (m < M && k < Kx) ? x[(size_t)m * Kx + k] : 0.f;
    smem[i] = bf16 ? fltorch::round_bf16(v) : v;
  }
  float* bsum = smem + MT * width;       // [MT][nkb], AFFINE only
  if constexpr (AFFINE) {
    for (int i = threadIdx.x; i < MT * nkb; i += kThreads) {
      const int r = i / nkb, b = i - r * nkb;
      const int m = m0 + r, k0 = (kb0 + b) * 32;
      float s = 0.f;
      if (m < M)
        for (int j = 0; j < 32 && k0 + j < Kx; ++j)
          s += x[(size_t)m * Kx + k0 + j];
      bsum[i] = s;
    }
  }
  __syncthreads();

  float acc[MT][COLS];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;

  if (n < N) {
    for (int b = warp; b < nkb; b += kWarps) {
      const int kb = kb0 + b;
      PT q[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        q[j] = __ldg(reinterpret_cast<const PT*>(
            qs + (size_t)(kb * 16 + j) * N + n));
      float d[COLS];
#pragma unroll
      for (int c4 = 0; c4 < COLS; c4 += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            scales + (size_t)kb * N + n + c4));
        d[c4] = v.x; d[c4 + 1] = v.y; d[c4 + 2] = v.z; d[c4 + 3] = v.w;
      }
      if constexpr (AFFINE) {
#pragma unroll
        for (int c4 = 0; c4 < COLS; c4 += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              mins + (size_t)kb * N + n + c4));
          const float mn[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int r = 0; r < MT; ++r)
              acc[r][c4 + c] += bsum[r * nkb + b] * mn[c];
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int byte = Packed<COLS>::byte(q[j], c);
          constexpr int kZero = AFFINE ? 0 : 8;
          float wlo = (float)((byte & 15) - kZero) * d[c];
          float whi = (float)((byte >> 4) - kZero) * d[c];
          if (bf16) {
            wlo = fltorch::round_bf16(wlo);
            whi = fltorch::round_bf16(whi);
          }
#pragma unroll
          for (int r = 0; r < MT; ++r)
            acc[r][c] += smem[r * width + b * 32 + j] * wlo +
                         smem[r * width + b * 32 + 16 + j] * whi;
        }
      }
    }
  }
  __syncthreads();                       // x slice no longer needed
  float* red = smem;                     // [kWarps][MT][BN]
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      red[(warp * MT + r) * BN + lane * COLS + c] = acc[r][c];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * BN; i += kThreads) {
    const int r = i / BN, col = i - r * BN;
    const int m = m0 + r, nn = blockIdx.x * BN + col;
    if (m >= M || nn >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * MT + r) * BN + col];
    partial[((size_t)split * M + m) * N + nn] = s;
  }

  // The last block of this output tile to finish adds the splits' partials
  // in split order (deterministic) and resets the tile's counter.
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counters[tile], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < MT * BN; i += kThreads) {
    const int r = i / BN, col = i - r * BN;
    const int m = m0 + r, nn = blockIdx.x * BN + col;
    if (m >= M || nn >= n_out) continue;
    float s = 0.f;
    for (int sp = 0; sp < (int)gridDim.y; ++sp)
      s += __ldcg(partial + ((size_t)sp * M + m) * N + nn);
    y[(size_t)m * n_out + nn] = s;
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

template <int MT, int COLS, bool AFFINE>
int launch_gemv(const float* x, int M, int Kx, const uint8_t* qs,
                const float* scales, const float* mins, int N, int NB,
                int splits,
                int kb_per_split, float* partial, int* counters, float* y,
                int n_out, int bf16, cudaStream_t stream) {
  constexpr int BN = 32 * COLS;
  const size_t x_bytes = (size_t)MT * kb_per_split * (AFFINE ? 33 : 32) *
                         sizeof(float);    // x slice [+ block sums]
  const size_t red_bytes = (size_t)kWarps * MT * BN * sizeof(float);
  const size_t smem = x_bytes > red_bytes ? x_bytes : red_bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        q4_gemv_kernel<MT, COLS, AFFINE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((N + BN - 1) / BN, splits, (M + MT - 1) / MT);
  q4_gemv_kernel<MT, COLS, AFFINE><<<grid, kThreads, smem, stream>>>(
      x, M, Kx, qs, scales, mins, N, NB, kb_per_split, partial, counters, y,
      n_out, bf16);
  return (int)cudaGetLastError();
}

// Tiles by M: 1 row x 256 columns, 4 x 256, or 16 x 128.
template <bool AFFINE>
int dispatch_gemv(const void* x, int M, int Kx, const void* qs,
                  const void* scales, const void* mins, int N, int NB,
                  int splits, int kb_per_split, void* partial, void* counters,
                  void* y, int n_out, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const uint8_t* q = (const uint8_t*)qs;
  const float* sc = (const float*)scales;
  const float* mn = (const float*)mins;
  float* p = (float*)partial;
  int* c = (int*)counters;
  float* yf = (float*)y;
  if (M == 1)
    return launch_gemv<1, 8, AFFINE>(xf, M, Kx, q, sc, mn, N, NB, splits,
                                     kb_per_split, p, c, yf, n_out, bf16, s);
  if (M <= 4)
    return launch_gemv<4, 8, AFFINE>(xf, M, Kx, q, sc, mn, N, NB, splits,
                                     kb_per_split, p, c, yf, n_out, bf16, s);
  return launch_gemv<16, 4, AFFINE>(xf, M, Kx, q, sc, mn, N, NB, splits,
                                    kb_per_split, p, c, yf, n_out, bf16, s);
}

// ---- B1, bf16 mode: tensor cores ------------------------------------------

constexpr int kMmaWarps = 4, kMmaThreads = kMmaWarps * 32;
constexpr int kWarpCols = 64;            // columns of one warp
constexpr int kStages = 4;
constexpr int kRowStride = 80;           // bytes per packed row in a stage
// The tensor-core kernel's modes: B1 (q4_0) and B9 (affine)
enum Mode { kQ40 = 0, kQ41 = 1 };
// planes of 64 values beside the packed rows in a ring stage: the scales
// and, for an affine weight, the mins
template <int MODE>
constexpr int kPlanes = MODE == kQ41 ? 2 : 1;
// a stage: 16 packed rows and the planes (SC16: 2-byte bf16 scales)
template <int MODE, bool SC16>
constexpr int kStageBytes =
    16 * kRowStride + kPlanes<MODE> * kWarpCols * (SC16 ? 2 : 4);

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// q - 8 (q4_0) or q itself (RAW: an affine code) as an exact f32 for byte
// C of `nibs`: the byte goes into the mantissa of 2^23 (one byte permute
// with `magic` = 0x4B000000), then 2^23 + 8 (or 2^23) is subtracted.
// `magic` comes in as a kernel argument so that it sits in a register and
// the permute's selector C is the instruction's immediate (a literal magic
// would take the immediate and cost a register move of the selector per
// element).
template <int C, bool RAW>
__device__ __forceinline__ float nib_val(uint32_t nibs, uint32_t magic) {
  return __uint_as_float(__byte_perm(nibs, magic, 0x7440 | C)) -
         (RAW ? 8388608.f : 8388616.f);
}

// The two code values of A register `reg` of m-tile mt at k16 step `step`
// (0: the low nibbles, 1: the high ones): column 2mt + reg % 2 of the
// lane's 8, rows 2t and 2t + 1 (reg < 2) or 2t + 8 and 2t + 9. All
// arguments but the words are constants once the loops are unrolled.
template <bool RAW>
__device__ __forceinline__ float2 a_codes(const uint32_t (&lo)[4][2],
                                          const uint32_t (&hi)[4][2],
                                          int step, int mt, int reg,
                                          uint32_t magic) {
  const int c = 2 * mt + (reg & 1), r = 2 * (reg >> 1);
  const uint32_t* src0 = step ? hi[r] : lo[r];
  const uint32_t* src1 = step ? hi[r + 1] : lo[r + 1];
  switch (c & 3) {
    case 0: return make_float2(nib_val<0, RAW>(src0[c >> 2], magic),
                               nib_val<0, RAW>(src1[c >> 2], magic));
    case 1: return make_float2(nib_val<1, RAW>(src0[c >> 2], magic),
                               nib_val<1, RAW>(src1[c >> 2], magic));
    case 2: return make_float2(nib_val<2, RAW>(src0[c >> 2], magic),
                               nib_val<2, RAW>(src1[c >> 2], magic));
    default: return make_float2(nib_val<3, RAW>(src0[c >> 2], magic),
                                nib_val<3, RAW>(src1[c >> 2], magic));
  }
}

template <int NT, int MODE, bool SC16>
__global__ void __launch_bounds__(kMmaThreads)
q4_mma_kernel(const float* __restrict__ x, int M, int Kx,
              const uint8_t* __restrict__ qs,
              const void* __restrict__ scales,
              const float* __restrict__ mins, int N, int NB, int cw,
              int kb_per_split, float* __restrict__ partial,
              int* __restrict__ counters, float* __restrict__ y, int n_out,
              uint32_t magic) {
  constexpr bool AFFINE = MODE == kQ41;
  constexpr int MT = 8 * NT;
  constexpr int kSB = kStageBytes<MODE, SC16>;
  constexpr int kSel = SC16 ? 2 : 4;               // bytes of a scale
  constexpr int kEpc = 16 / kSel;                  // scales a 16-byte copy
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kw = kMmaWarps / cw;         // warps per column group
  const int bn = cw * kWarpCols;         // columns of the block
  const int n0 = blockIdx.x * bn, split = blockIdx.y, m0 = blockIdx.z * MT;
  const int nw = n0 + (warp % cw) * kWarpCols;   // this warp's columns
  const int kg = warp / cw;              // its q blocks: kg, kg + kw, ...
  const int kb0 = split * kb_per_split;
  const int nkb = min(NB, kb0 + kb_per_split) - kb0;
  const int cnt = nkb > kg ? (nkb - kg + kw - 1) / kw : 0;
  uint8_t* ring = smem_raw + (size_t)warp * kStages * kSB;
  uint32_t* xs = reinterpret_cast<uint32_t*>(
      smem_raw + (size_t)kMmaWarps * kStages * kSB);
  // AFFINE: the block sums of x, [q block of the split][row of the tile]
  float* bs = reinterpret_cast<float*>(xs + (size_t)kb_per_split * NT * 128);

  // A lane copies two 16-byte pieces of the packed rows (rows lane / 4 and
  // 8 + lane / 4, bytes (lane % 4) * 16) and one 16-byte piece of the
  // scales (lanes < 16, or < 8 for 2-byte scales) or, for an affine
  // weight, of the mins (lanes >= 16, stored right after the scales); its
  // sources advance by kw q blocks per stage. Columns past N read as zeros
  // (N is a multiple of 16).
  const int off = (lane & 3) * 16, sl = lane & 15;
  const bool has_s = AFFINE || lane < 64 / kEpc;
  const bool q_ok = nw + off < N, s_ok = has_s && nw + sl * kEpc < N;
  const uint8_t* q_src = qs + ((size_t)(kb0 + kg) * 16 + (lane >> 2)) * N +
                         nw + off;            // advanced stage by stage
  const uint8_t* s_plane = reinterpret_cast<const uint8_t*>(
      AFFINE && lane >= 16 ? static_cast<const void*>(mins) : scales);
  const uint8_t* s_src =
      s_plane + ((size_t)(kb0 + kg) * N + nw + sl * kEpc) * kSel;
  const size_t q_step = (size_t)kw * 16 * N, s_step = (size_t)kw * N * kSel;
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t q_dst = ring_s + (lane >> 2) * kRowStride + off;
  const uint32_t s_dst = ring_s + 16 * kRowStride + lane * 16;
  constexpr uint32_t kRing = kStages * kSB;
  auto load_stage = [&](uint32_t slot, const uint8_t* qp, const uint8_t* sp) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                 "r"(q_dst + slot), "l"(q_ok ? qp : qs), "r"(q_ok ? 16 : 0));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                 "r"(q_dst + slot + 8 * kRowStride),
                 "l"(q_ok ? qp + 8 * (size_t)N : qs), "r"(q_ok ? 16 : 0));
    if (has_s)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(s_dst + slot), "l"(s_ok ? sp : s_plane),
                   "r"(s_ok ? 16 : 0));
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < cnt) load_stage(i * kSB, q_src, s_src);
    q_src += q_step;
    s_src += s_step;
    cp_async_commit();
  }

  // x slice as bf16 pairs in B-fragment order: word ((b * NT + nt) * 32 +
  // lane) * 4 + w holds x[m0 + nt * 8 + lane / 4][k, k + 1] with k = 32 * b
  // + 16 * (w / 2) + 2 * (lane % 4) + 8 * (w % 2), zeros past Kx. Read as
  // coalesced float4s of the rows < M; the words of rows >= M are left as
  // they are: they only reach accumulator columns that are never stored.
  // Every thread runs the same trip count, so that for an affine weight
  // the 8 adjacent lanes holding the 8 float4s of one row's q block (quads
  // is a multiple of 8 and so is the stride) can add the unrounded x up by
  // shuffles.
  const int rows = min(MT, M - m0), quads = nkb * 8;
  for (int i0 = 0; i0 < rows * quads; i0 += kMmaThreads) {
    const int i = i0 + threadIdx.x;
    const bool ok = i < rows * quads;
    const int r = i / quads, qd = i - r * quads;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (ok) {
      const int k = kb0 * 32 + qd * 4;
      const float* xr = x + (size_t)(m0 + r) * Kx;
      if ((Kx & 3) == 0 && k + 3 < Kx) {
        const float4 f = *reinterpret_cast<const float4*>(xr + k);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = k + e < Kx ? xr[k + e] : 0.f;
      }
      const int b = qd >> 3, nt = r >> 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = ((qd & 7) * 4 + 2 * h) & 15, step = (qd & 7) >> 2;
        const int L = (r & 7) * 4 + ((kk & 7) >> 1);
        xs[((b * NT + nt) * 32 + L) * 4 + 2 * step + (kk >> 3)] =
            pack_bf16(v[2 * h], v[2 * h + 1]);
      }
    }
    if constexpr (AFFINE) {
      float sum = (v[0] + v[1]) + (v[2] + v[3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if (ok && (qd & 7) == 0) bs[(qd >> 3) * MT + r] = sum;
    }
  }
  if constexpr (AFFINE) {
    // rows >= M: a zero sum, so the term adds nothing there
    for (int i = threadIdx.x; i < (MT - rows) * nkb; i += kMmaThreads)
      bs[(i % nkb) * MT + rows + i / nkb] = 0.f;
  }
  __syncthreads();

  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  // this lane's reads: rows 2t, 2t+1, 2t+8, 2t+9 at bytes g*8 .. g*8+7, the
  // scales (and mins) of those 8 columns, its B fragments and, AFFINE, the
  // block sums of its accumulator rows 2t, 2t+1 of each n-tile (all kw q
  // blocks apart)
  const uint8_t* a_rd = ring + 2 * t * kRowStride + g * 8;
  const uint8_t* s_rd = ring + 16 * kRowStride + g * 8 * kSel;
  const uint4* x_rd = reinterpret_cast<const uint4*>(xs) + kg * NT * 32 + lane;
  const float* bs_rd = bs + kg * MT + 2 * t;
  uint32_t rd_slot = 0, wr_slot = (kStages - 1) * kSB;
  for (int i = 0; i < cnt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    if (i + kStages - 1 < cnt) load_stage(wr_slot, q_src, s_src);
    cp_async_commit();
    q_src += q_step;
    s_src += s_step;
    wr_slot = wr_slot + kSB == kRing ? 0 : wr_slot + kSB;
    const int slot = rd_slot;
    rd_slot = rd_slot + kSB == kRing ? 0 : rd_slot + kSB;
    // low and high nibbles of the lane's 4 rows x 8 columns
    uint32_t lo[4][2], hi[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          a_rd + slot + ((r & 1) + 8 * (r >> 1)) * kRowStride);
      lo[r][0] = v.x & 0x0F0F0F0Fu;
      lo[r][1] = v.y & 0x0F0F0F0Fu;
      hi[r][0] = (v.x >> 4) & 0x0F0F0F0Fu;
      hi[r][1] = (v.y >> 4) & 0x0F0F0F0Fu;
    }
    float d[8];
    if constexpr (SC16) {
      const uint4 dv = *reinterpret_cast<const uint4*>(s_rd + slot);
      const uint32_t w[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        d[2 * e] = f.x;
        d[2 * e + 1] = f.y;
      }
    } else {
      const float4 da = *reinterpret_cast<const float4*>(s_rd + slot);
      const float4 db = *reinterpret_cast<const float4*>(s_rd + slot + 16);
      d[0] = da.x; d[1] = da.y; d[2] = da.z; d[3] = da.w;
      d[4] = db.x; d[5] = db.y; d[6] = db.z; d[7] = db.w;
    }
    uint4 xb[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) xb[nt] = x_rd[nt * 32];
    x_rd += kw * NT * 32;
#pragma unroll
    for (int step = 0; step < 2; ++step) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
          // a0: column 2mt, rows 2t/2t+1; a1: column 2mt+1, the same
          // rows; a2, a3: rows 2t+8/2t+9
          const int c = 2 * mt + (reg & 1);
          const float2 q = a_codes<AFFINE>(lo, hi, step, mt, reg, magic);
          a[reg] = pack_bf16(q.x * d[c], q.y * d[c]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], a, step ? xb[nt].z : xb[nt].x,
                   step ? xb[nt].w : xb[nt].y);
      }
    }
    if constexpr (AFFINE) {
      // + bsum[row] * m[col]: D fragment c of (mt, nt) is row nt*8 + 2t +
      // c%2 and column g*8 + 2mt + c/2 (see below), so the 8 mins of the
      // lane's columns and 2 block sums per n-tile suffice
      float p[8];
      const float4 ma = *reinterpret_cast<const float4*>(s_rd + slot + 256);
      const float4 mb = *reinterpret_cast<const float4*>(s_rd + slot + 272);
      p[0] = ma.x; p[1] = ma.y; p[2] = ma.z; p[3] = ma.w;
      p[4] = mb.x; p[5] = mb.y; p[6] = mb.z; p[7] = mb.w;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(bs_rd + nt * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[mt][nt][c] = fmaf(c & 1 ? bv.y : bv.x, p[2 * mt + (c >> 1)],
                                  acc[mt][nt][c]);
      }
      bs_rd += kw * MT;
    }
  }
  cp_async_wait<0>();
  __syncthreads();                       // ring and x slice no longer needed

  // D fragment c of (mt, nt): MMA row i = g + 8 * (c / 2) -> column
  // g * 8 + 2 * mt + c / 2 of the warp; MMA column 2t + c % 2 -> row
  // nt * 8 + 2t + c % 2. The warps of one column group add up through
  // shared memory in warp order.
  float* red = reinterpret_cast<float*>(smem_raw);   // [warp][MT][64]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * MT + nt * 8 + 2 * t + (c & 1)) * kWarpCols + g * 8 +
            2 * mt + (c >> 1)] = acc[mt][nt][c];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * bn; i += kMmaThreads) {
    const int r = i / bn, col = i - r * bn;
    const int m = m0 + r, nn = n0 + col;
    if (m >= M || nn >= N) continue;
    const int cg = col / kWarpCols, cc = col % kWarpCols;
    float sum = 0.f;
    for (int w = cg; w < kMmaWarps; w += cw)
      sum += red[(w * MT + r) * kWarpCols + cc];
    partial[((size_t)split * M + m) * N + nn] = sum;
  }

  // The last block of this output tile to finish adds the splits' partials
  // in split order (deterministic) and resets the tile's counter. Each
  // thread takes 4 adjacent columns at a time, with the loads of up to 8
  // splits in flight together.
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counters[tile], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int nq = bn / 4, splits = gridDim.y;
  for (int i = threadIdx.x; i < rows * nq; i += kMmaThreads) {
    const int m = m0 + i / nq, nn = n0 + (i % nq) * 4;
    if (nn >= N) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          partial + ((size_t)sp * M + m) * N + nn));
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    const float vs[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (nn + e < n_out) y[(size_t)m * n_out + nn + e] = vs[e];
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

template <int NT, int MODE, bool SC16>
int launch_mma(const float* x, int M, int Kx, const uint8_t* qs,
               const void* scales, const float* mins, int N, int NB, int cw,
               int splits, int kb_per_split, float* partial, int* counters,
               float* y, int n_out, cudaStream_t stream) {
  // the ring, the x slice and (affine) the block sums, reused afterwards for
  // the warps' sums
  const size_t ring_x =
      (size_t)kMmaWarps * kStages * kStageBytes<MODE, SC16> +
      (size_t)kb_per_split * NT * 128 * sizeof(uint32_t) +
      (MODE == kQ41 ? (size_t)kb_per_split * 8 * NT * 4 : 0);
  const size_t red = (size_t)kMmaWarps * 8 * NT * kWarpCols * sizeof(float);
  const size_t smem = ring_x > red ? ring_x : red;
  if (smem + 1024 > 48 * 1024) {         // with the static shared memory
    cudaError_t err = cudaFuncSetAttribute(
        q4_mma_kernel<NT, MODE, SC16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int bn = cw * kWarpCols;
  dim3 grid((N + bn - 1) / bn, splits, (M + 8 * NT - 1) / (8 * NT));
  q4_mma_kernel<NT, MODE, SC16><<<grid, kMmaThreads, smem, stream>>>(
      x, M, Kx, qs, scales, mins, N, NB, cw, kb_per_split, partial, counters,
      y, n_out, 0x4B000000u);
  return (int)cudaGetLastError();
}

template <int MODE, bool SC16 = false>
int dispatch_mma(const void* x, int M, int Kx, const void* qs,
                 const void* scales, const void* mins, int N, int NB, int cw,
                 int splits, int kb_per_split, int nt, void* partial,
                 void* counters, void* y, int n_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const uint8_t* q = (const uint8_t*)qs;
  const float* mn = (const float*)mins;
  float* p = (float*)partial;
  int* c = (int*)counters;
  float* yf = (float*)y;
  if (N % 16 || (cw != 1 && cw != 2 && cw != 4) || kb_per_split * nt > 64)
    return (int)cudaErrorInvalidValue;
  switch (nt) {
    case 1: return launch_mma<1, MODE, SC16>(xf, M, Kx, q, scales, mn, N, NB,
                                             cw, splits, kb_per_split, p, c,
                                             yf, n_out, s);
    case 2: return launch_mma<2, MODE, SC16>(xf, M, Kx, q, scales, mn, N, NB,
                                             cw, splits, kb_per_split, p, c,
                                             yf, n_out, s);
    case 4: return launch_mma<4, MODE, SC16>(xf, M, Kx, q, scales, mn, N, NB,
                                             cw, splits, kb_per_split, p, c,
                                             yf, n_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B1 with f32 (sc16 = 0) or 2-byte (sc16 = 1) scales
int dispatch_scales(int sc16, const void* x, int M, int Kx, const void* qs,
                    const void* scales, int N, int NB, int cw, int splits,
                    int kb_per_split, int nt, void* partial, void* counters,
                    void* y, int n_out, void* stream) {
  if (sc16)
    return dispatch_mma<kQ40, true>(x, M, Kx, qs, scales, nullptr, N, NB, cw,
                                    splits, kb_per_split, nt, partial,
                                    counters, y, n_out, stream);
  return dispatch_mma<kQ40, false>(x, M, Kx, qs, scales, nullptr, N, NB, cw,
                                   splits, kb_per_split, nt, partial,
                                   counters, y, n_out, stream);
}

}  // namespace

// B1 in bf16 mode. As q4_gemv, with N a multiple of 16, 16-byte aligned
// planes and the plan of q4_matmul.b1_mma_plan: nt = 1, 2 or 4 n-tiles of 8
// rows per block (M <= 8, <= 16, else 32-row tiles), cw = 1, 2 or 4 column
// groups of 64 columns per block (the 4 warps split the block's q blocks
// among the 4 / cw warps of a group), kb_per_split <= 64 / nt, counters one
// per output tile.
// Returns the CUDA error code of the launch.
extern "C" int q4_gemv_mma(const void* x, int M, int Kx, const void* qs,
                           const void* scales, int N, int NB, int cw,
                           int splits, int kb_per_split, int nt,
                           void* partial, void* counters, void* y, int n_out,
                           void* stream) {
  return dispatch_mma<kQ40>(x, M, Kx, qs, scales, nullptr, N, NB, cw, splits,
                             kb_per_split, nt, partial, counters, y, n_out,
                             stream);
}

// B9 in bf16 mode: as q4_gemv_mma with the mins plane f32 [NB, N] (16-byte
// aligned) after the scales.
extern "C" int q41_gemv_mma(const void* x, int M, int Kx, const void* qs,
                            const void* scales, const void* mins, int N,
                            int NB, int cw, int splits, int kb_per_split,
                            int nt, void* partial, void* counters, void* y,
                            int n_out, void* stream) {
  return dispatch_mma<kQ41>(x, M, Kx, qs, scales, mins, N, NB, cw, splits,
                            kb_per_split, nt, partial, counters, y, n_out,
                            stream);
}

// B1 (variant 0, the only one taken; the JAX package's other
// q4_matmul_pallas variants run csrc/q4_fold.cuh) with f32 or 2-byte
// scales: as q4_gemv_mma, the scales f32 (sc16 = 0) or bf16 (sc16 = 1)
// [NB, N], 16-byte aligned. Returns the CUDA error code of the launch.
extern "C" int q4_variant_mma(const void* x, int M, int Kx, const void* qs,
                              const void* scales, int sc16, int N, int NB,
                              int cw, int splits, int kb_per_split, int nt,
                              void* partial, void* counters, void* y,
                              int n_out, int variant, void* stream) {
  if (variant != 0) return (int)cudaErrorInvalidValue;
  return dispatch_scales(sc16, x, M, Kx, qs, scales, N, NB, cw, splits,
                         kb_per_split, nt, partial, counters, y, n_out,
                         stream);
}

// x f32 [M, Kx] (Kx <= 32 * NB; the stored-K tail reads as zeros),
// partial f32 [splits, M, N] scratch, counters int32 zeros (one per output
// tile; left zeroed), y f32 [M, n_out]. The caller picks (splits,
// kb_per_split) with the tile rule of q4_matmul._splitk: rows per tile
// MT = 1 (M = 1), 4 (M <= 4) or 16, columns per block 256, 256 or 128,
// kb_per_split <= 32. Returns the CUDA error code of the launch.
extern "C" int q4_gemv(const void* x, int M, int Kx, const void* qs,
                       const void* scales, int N, int NB, int splits,
                       int kb_per_split, void* partial, void* counters,
                       void* y, int n_out, int bf16, void* stream) {
  return dispatch_gemv<false>(x, M, Kx, qs, scales, nullptr, N, NB, splits,
                              kb_per_split, partial, counters, y, n_out, bf16,
                              stream);
}

// B9 (f32 mode; bf16 mode as a yardstick): as q4_gemv with the mins plane
// f32 [NB, N] after the scales.
extern "C" int q41_gemv(const void* x, int M, int Kx, const void* qs,
                        const void* scales, const void* mins, int N, int NB,
                        int splits, int kb_per_split, void* partial,
                        void* counters, void* y, int n_out, int bf16,
                        void* stream) {
  return dispatch_gemv<true>(x, M, Kx, qs, scales, mins, N, NB, splits,
                             kb_per_split, partial, counters, y, n_out, bf16,
                             stream);
}
