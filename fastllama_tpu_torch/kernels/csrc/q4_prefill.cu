// Kernel B5: the bf16 / f32 prefill matmul over a q4_0 weight.
//
// Replaces fastllama_tpu/kernels/q4_matmul.py::q4_matmul_prefill_pallas
// (variant nat, _q4mm_prefill_nat_kernel):
//   y[M, n_out] f32 = R(x[M, K]) @ R((q - 8) * d)      f32 accumulation
// in natural K order, where R rounds to bf16 in bf16 mode (the subtraction
// is done in integers and the product with d in f32 before the cast) and is
// the identity in f32 mode. Products of two bf16 values are exact in f32,
// so only the f32 summation order differs from a dense matmul. The f32 mode
// is a true f32 product: FFMA on the CUDA cores, never TF32. x past its own
// K counts as zero, so the caller never pads it.
//
// Bound on the H100: operations. At M = 512 the product is 2*M*N*K
// operations against ~0.6 bytes of weight per element, far above the ridge
// (~295 operations per byte in bf16). Three launches, as kernel B3
// (q4_int8.cu), whose measurements showed that converting the weight inside
// the product's loop repeats the conversion for every row tile and keeps the
// CUDA cores, not the tensor cores, busy:
//   1. dequant_kernel: the weight R((q - 8) * d), written once per call as
//      an [N, K] plane (K contiguous) into scratch: one thread per (column,
//      q block) reads 16 packed bytes and a scale and writes 32 elements;
//   2. cast_kernel (bf16 mode): R(x) as a bf16 [M, K] plane with zeros past
//      x's K;
//   3. bf16_gemm_kernel: mma.sync m16n8k16 bf16 with f32 accumulation. A
//      256-thread block computes a 128x128 output tile, 8 warps of 64x32, K
//      in 32-deep steps; both operand tiles are K contiguous and copied with
//      cp.async into a two-stage shared ring, so the next step's copies run
//      under the current step's products;
//      f32_gemm_kernel (f32 mode): a 64x64 tile per 256-thread block, 4x4
//      outputs per thread, K in 16-deep steps through shared memory, each
//      output summed in k order.
// wgmma, TMA and converting the weight tile in shared memory are later work.

#include "common.cuh"

namespace {

// ---- 1. weight conversion ------------------------------------------------

__device__ __forceinline__ void store32(__nv_bfloat16* dst, const float* v) {
  __align__(16) __nv_bfloat162 h[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  const uint4* src = reinterpret_cast<const uint4*>(h);
  uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = src[i];
}

__device__ __forceinline__ void store32(float* dst, const float* v) {
  float4* out = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    out[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// One thread per (column n, q block kb): elements 32*kb .. 32*kb + 31 of
// column n, contiguous at wt[n, 32*kb ...].
template <typename T>
__global__ void dequant_kernel(const uint8_t* __restrict__ qs,
                               const float* __restrict__ scales, int N, int K,
                               T* __restrict__ wt) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int kb = blockIdx.y;
  if (n >= N) return;
  const float d = scales[(size_t)kb * N + n];
  float v[32];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int byte = __ldg(qs + (size_t)(kb * 16 + j) * N + n);
    v[j] = (float)((byte & 15) - 8) * d;
    v[16 + j] = (float)((byte >> 4) - 8) * d;
  }
  store32(wt + (size_t)n * K + kb * 32, v);
}

// ---- 2. activation cast ----------------------------------------------------

// xb[m, k] = bf16(x[m, k]) for k < Kx, 0 for Kx <= k < Kc; two elements per
// thread (Kx is even), row stride K.
__global__ void cast_kernel(const float* __restrict__ x, int M, int Kx, int Kc,
                            int K, __nv_bfloat16* __restrict__ xb) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int half = Kc / 2;
  if (i >= (size_t)M * half) return;
  const int m = (int)(i / half), k = 2 * (int)(i - (size_t)m * half);
  float2 v = make_float2(0.f, 0.f);
  if (k < Kx) v = *reinterpret_cast<const float2*>(x + (size_t)m * Kx + k);
  *reinterpret_cast<__nv_bfloat162*>(xb + (size_t)m * K + k) =
      __floats2bfloat162_rn(v.x, v.y);
}

// ---- 3a. bf16 product --------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kThreads = 256;
constexpr int kStepBytes = 64;             // 32 bf16 values of K per step
constexpr int kRow = kStepBytes + 16;      // bytes per shared row, padded so
                                           // the fragment reads hit distinct
                                           // banks

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;           // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// xb bf16 [M, K], wt bf16 [N, K]; the product runs over k < Kc (a multiple
// of 32, Kc <= K).
__global__ void __launch_bounds__(kThreads)
bf16_gemm_kernel(const __nv_bfloat16* __restrict__ xb, int M, int K, int Kc,
                 const __nv_bfloat16* __restrict__ wt, int N, int n_out,
                 float* __restrict__ y) {
  __shared__ __align__(16) uint8_t As[2][kBM * kRow];   // [row][k]
  __shared__ __align__(16) uint8_t Bs[2][kBN * kRow];   // [col][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const uint8_t* xbytes = reinterpret_cast<const uint8_t*>(xb);
  const uint8_t* wbytes = reinterpret_cast<const uint8_t*>(wt);
  const size_t row_bytes = (size_t)K * 2;

  // copy roles: 16-byte piece `part` (of 4 per step row) of rows r and
  // r + 64 of each operand tile; rows past M or N are zero-filled
  const int r = tid >> 2, part = tid & 3;
  auto issue = [&](int kb, int st) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + h * 64;
      const int m = m0 + row, n = n0 + row;
      const size_t off = (size_t)kb * kStepBytes + part * 16;
      cp_async16(As[st] + row * kRow + part * 16,
                 xbytes + (size_t)(m < M ? m : 0) * row_bytes + off, m < M);
      cp_async16(Bs[st] + row * kRow + part * 16,
                 wbytes + (size_t)(n < N ? n : 0) * row_bytes + off, n < N);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nkb = Kc / 32;
  issue(0, 0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < nkb) {
      issue(kb + 1, st ^ 1);   // stage st ^ 1 was freed by the last barrier
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kStepBytes; ks += 32) {        // 16 values of K
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* bp = Bs[st] + (wn + j * 8 + g) * kRow + ks + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(bp);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* ap = As[st] + (wm + i * 16 + g) * kRow + ks + t * 4;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(ap);
        af[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * kRow);
        af[2] = *reinterpret_cast<const uint32_t*>(ap + 16);
        af[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * kRow + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af, bf[j]);
      }
    }
    __syncthreads();           // stage st may be overwritten from here on
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + t * 2 + e;
          if (n < n_out) y[(size_t)m * n_out + n] = acc[i][j][h * 2 + e];
        }
      }
    }
  }
}

// ---- 3b. f32 product ---------------------------------------------------------

constexpr int kSB = 64, kSK = 16, kSPad = kSB + 4;

// x f32 [M, Kx] (zero past Kx; Kx a multiple of 4), wt f32 [N, K]; the
// product runs over k < Kc (a multiple of 16, Kc <= K).
__global__ void __launch_bounds__(256)
f32_gemm_kernel(const float* __restrict__ x, int M, int Kx, int Kc,
                const float* __restrict__ wt, int N, int K, int n_out,
                float* __restrict__ y) {
  __shared__ __align__(16) float As[kSK][kSPad];   // [k][row]
  __shared__ __align__(16) float Bs[kSK][kSPad];   // [k][col]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kSB, n0 = blockIdx.x * kSB;
  const int lr = tid >> 2, lk = (tid & 3) * 4;     // loader: row, k offset

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kc; k0 += kSK) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    const int m = m0 + lr, n = n0 + lr, k = k0 + lk;
    if (m < M && k < Kx)
      a = *reinterpret_cast<const float4*>(x + (size_t)m * Kx + k);
    if (n < N)
      b = *reinterpret_cast<const float4*>(wt + (size_t)n * K + k);
    As[lk][lr] = a.x; As[lk + 1][lr] = a.y;
    As[lk + 2][lr] = a.z; As[lk + 3][lr] = a.w;
    Bs[lk][lr] = b.x; Bs[lk + 1][lr] = b.y;
    Bs[lk + 2][lr] = b.z; Bs[lk + 3][lr] = b.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < n_out) y[(size_t)m * n_out + n] = acc[i][j];
    }
  }
}

}  // namespace

// x f32 [M, Kx] (Kx a multiple of 4, Kx <= K, 16-byte aligned), qs uint8
// [K/2, N], scales f32 [K/32, N] (K the stored K, a multiple of 32), wt
// scratch [N, K] of bf16 (bf16 = 1) or f32, xb bf16 [M, K] scratch (bf16
// mode only), y f32 [M, n_out]. Returns the CUDA error code of the launches.
extern "C" int q4_prefill_gemm(const void* x, int M, int Kx, const void* qs,
                               const void* scales, int N, int K, void* wt,
                               void* xb, void* y, int n_out, int bf16,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int Kc = (Kx + 31) / 32 * 32;      // x is zero from Kx on
  const dim3 dq_grid((N + 127) / 128, Kc / 32);
  cudaError_t err;
  if (bf16) {
    dequant_kernel<__nv_bfloat16><<<dq_grid, 128, 0, s>>>(
        (const uint8_t*)qs, (const float*)scales, N, K, (__nv_bfloat16*)wt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t pairs = (size_t)M * (Kc / 2);
    cast_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, s>>>(
        (const float*)x, M, Kx, Kc, K, (__nv_bfloat16*)xb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    bf16_gemm_kernel<<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)xb, M, K, Kc, (const __nv_bfloat16*)wt, N,
        n_out, (float*)y);
    return (int)cudaGetLastError();
  }
  dequant_kernel<float><<<dq_grid, 128, 0, s>>>(
      (const uint8_t*)qs, (const float*)scales, N, K, (float*)wt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kSB - 1) / kSB, (M + kSB - 1) / kSB);
  f32_gemm_kernel<<<grid, 256, 0, s>>>((const float*)x, M, Kx, Kc,
                                       (const float*)wt, N, K, n_out,
                                       (float*)y);
  return (int)cudaGetLastError();
}
