// Kernels B1 and B9: the decode-size 4-bit matmuls (W4A16 skinny GEMM /
// GEMV) for q4_0 and for affine (q4_1 / GPTQ) weights, one template.
//
// B1 (q4_gemv):
// Replaces fastllama_tpu/kernels/q4_matmul.py::q4_matmul_pallas (variant
// v1, _q4mm_kernel_v1). Computes y[M, n_out] f32 = x[M, K] @ ((q - 8) * d)
// for M <= 64, reading the split-K packed weight planes as stored:
//   qs     uint8 [K_pad/2, N]: byte (16*kb + j, n) holds element 32*kb + j in
//          its low nibble and element 32*kb + 16 + j in its high nibble;
//   scales f32   [K_pad/32, N].
// In bf16 mode x and each dequantized weight are rounded to bf16 before the
// product (as q4_matmul_xla does); products of two bf16 values are exact in
// f32, so only the f32 summation order differs from a dense matmul. In f32
// mode nothing is rounded.
//
// B9 (q41_gemv) replaces q41_matmul_pallas (_q41mm_kernel) in the same
// file: the weight is w = q * d + m with a second f32 plane mins
// [K_pad/32, N], and the kernel computes
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

}  // namespace

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

// B9: as q4_gemv with the mins plane f32 [NB, N] after the scales.
extern "C" int q41_gemv(const void* x, int M, int Kx, const void* qs,
                        const void* scales, const void* mins, int N, int NB,
                        int splits, int kb_per_split, void* partial,
                        void* counters, void* y, int n_out, int bf16,
                        void* stream) {
  return dispatch_gemv<true>(x, M, Kx, qs, scales, mins, N, NB, splits,
                             kb_per_split, partial, counters, y, n_out, bf16,
                             stream);
}
