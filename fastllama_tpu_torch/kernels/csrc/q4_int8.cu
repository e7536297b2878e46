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
// ridge; the int8 tensor-core peak is 1,979 TOP/s. Three launches:
//   1. s8_kernel: s8 and 1/s8 per column from the whole-K scale strip;
//   2. requant_kernel: the int8 weight w8, written once per call as an
//      [N, K] plane (K contiguous, 1 byte per element) into scratch. The
//      TPU kernel requantized inside the matmul to spare VMEM; here doing
//      it inside cost the product's row tiles a requantization each (four
//      at M = 512), which kept the CUDA cores, not the tensor cores, busy;
//   3. int8_gemm_kernel: mma.sync m16n8k32 s8 with exact int32
//      accumulation. A 256-thread block computes a 128x128 output tile,
//      8 warps of 64x32, K in 64-deep steps; both operand tiles are K
//      contiguous, copied with cp.async into a two-stage shared ring so the
//      next step's copies run under the current step's products.
// wgmma and TMA are later work.

#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64, kThreads = 256;
constexpr int kRow = kBK + 16;   // bytes per shared row, padded so the
                                 // fragment reads hit distinct banks

__global__ void s8_kernel(const float* __restrict__ scales, int NB, int N,
                          float* __restrict__ s8, float* __restrict__ inv) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float mx = 0.f;
  for (int kb = 0; kb < NB; ++kb) mx = fmaxf(mx, fabsf(scales[(size_t)kb * N + n]));
  const float s = fmaxf(mx * (float)(8.0 / 127.0), (float)1e-20);
  s8[n] = s;
  inv[n] = __fdiv_rn(1.0f, s);
}

// One thread per (column n, q block kb): 16 packed bytes and one scale in,
// 32 int8 weights out, contiguous at w8t[n, 32*kb ...].
__global__ void requant_kernel(const uint8_t* __restrict__ qs,
                               const float* __restrict__ scales,
                               const float* __restrict__ inv, int N, int K,
                               int8_t* __restrict__ w8t) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int kb = blockIdx.y;
  if (n >= N) return;
  const float sc = scales[(size_t)kb * N + n] * inv[n];
  uint32_t lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int byte = __ldg(qs + (size_t)(kb * 16 + j) * N + n);
    const int vlo = __float2int_rn((float)((byte & 15) - 8) * sc);
    const int vhi = __float2int_rn((float)((byte >> 4) - 8) * sc);
    lo[j >> 2] |= (uint32_t)(vlo & 0xFF) << (8 * (j & 3));
    hi[j >> 2] |= (uint32_t)(vhi & 0xFF) << (8 * (j & 3));
  }
  uint4* dst = reinterpret_cast<uint4*>(w8t + (size_t)n * K + kb * 32);
  dst[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  dst[1] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;           // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void mma_s8(int* c, const int* a, const int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ dx,
                 int M, int K, const int8_t* __restrict__ w8t,
                 const float* __restrict__ s8, int N, int n_out,
                 float* __restrict__ y) {
  __shared__ __align__(16) uint8_t As[2][kBM * kRow];   // [row][k]
  __shared__ __align__(16) uint8_t Bs[2][kBN * kRow];   // [col][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  // copy roles: 16-byte piece `part` (of 4 per 64-deep row) of rows r and
  // r + 64 of each operand tile; rows past M or N are zero-filled
  const int r = tid >> 2, part = tid & 3;
  auto issue = [&](int kb, int st) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + h * 64;
      const int m = m0 + row, n = n0 + row;
      const int8_t* a = xq + (size_t)(m < M ? m : 0) * K + kb * kBK + part * 16;
      const int8_t* b = w8t + (size_t)(n < N ? n : 0) * K + kb * kBK + part * 16;
      cp_async16(As[st] + row * kRow + part * 16, a, m < M);
      cp_async16(Bs[st] + row * kRow + part * 16, b, n < N);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nkb = K / kBK;
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
    for (int ks = 0; ks < kBK; ks += 32) {
      int bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* bp = Bs[st] + (wn + j * 8 + g) * kRow + ks + t * 4;
        bf[j][0] = *reinterpret_cast<const int*>(bp);
        bf[j][1] = *reinterpret_cast<const int*>(bp + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* ap = As[st] + (wm + i * 16 + g) * kRow + ks + t * 4;
        int af[4];
        af[0] = *reinterpret_cast<const int*>(ap);
        af[1] = *reinterpret_cast<const int*>(ap + 8 * kRow);
        af[2] = *reinterpret_cast<const int*>(ap + 16);
        af[3] = *reinterpret_cast<const int*>(ap + 8 * kRow + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af, bf[j]);
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
      const float dm = dx[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + t * 2 + e;
          if (n < n_out)
            y[(size_t)m * n_out + n] =
                ((float)acc[i][j][h * 2 + e] * dm) * s8[n];
        }
      }
    }
  }
}

}  // namespace

// xq int8 [M, K] (K = the stored K, a multiple of 64), dx f32 [M], qs
// uint8 [K/2, N], scales f32 [K/32, N], s8inv f32 [2, N] scratch, w8t int8
// [N, K] scratch, y f32 [M, n_out]. Returns the CUDA error code of the
// launches.
extern "C" int q4_int8_gemm(const void* xq, const void* dx, int M, int K,
                            const void* qs, const void* scales, int N,
                            void* s8inv, void* w8t, void* y, int n_out,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* s8 = (float*)s8inv;
  float* inv = s8 + N;
  s8_kernel<<<(N + 255) / 256, 256, 0, s>>>((const float*)scales, K / 32, N,
                                            s8, inv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  requant_kernel<<<dim3((N + 127) / 128, K / 32), 128, 0, s>>>(
      (const uint8_t*)qs, (const float*)scales, inv, N, K, (int8_t*)w8t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<<<grid, kThreads, 0, s>>>(
      (const int8_t*)xq, (const float*)dx, M, K, (const int8_t*)w8t, s8, N,
      n_out, (float*)y);
  return (int)cudaGetLastError();
}
