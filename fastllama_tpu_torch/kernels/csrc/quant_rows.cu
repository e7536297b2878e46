// Kernel B2: per-row symmetric int8 activation quantization.
//
// Replaces fastllama_tpu/kernels/q4_matmul.py::quant_rows_int8
// (_quant_rows_kernel):
//   dx = max(max_k |x|, 1e-20) * f32(1/127)
//   xq = clip(round_half_even(x / dx), -127, 127)
// bit for bit with the JAX package under jit: the max is exact in any
// order; XLA turns the division by the constant 127 into a product with
// its f32 reciprocal, so dx is that product; x / dx is the correctly
// rounded IEEE division (__fdiv_rn); rintf rounds half to even, as
// jnp.round does. The output row is K_out wide; columns past x's K (the
// weight's stored-K padding) are written as zeros, so no padded copy of x
// is made.
//
// Bound on the H100: bytes. One read of the f32 row (4 B/element) and one
// int8 write (1 B/element); a handful of operations per element. One block
// per row keeps the row's max in one block reduction; the row is read
// twice (max, then quantize), the second time mostly from L1/L2.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const float* __restrict__ x, int Kx, int K_out,
                  int8_t* __restrict__ xq, float* __restrict__ dx) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const float* xr = x + row * Kx;
  float mx = 0.f;
  for (int k = threadIdx.x; k < Kx; k += kThreads) mx = fmaxf(mx, fabsf(xr[k]));
  mx = fltorch::block_max(mx, red);
  const float d = __fmul_rn(fmaxf(mx, (float)1e-20), 1.0f / 127.0f);
  int8_t* out = xq + row * K_out;
  for (int k = threadIdx.x; k < K_out; k += kThreads) {
    const float v = k < Kx ? xr[k] : 0.f;
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v, d)), -127.f), 127.f);
    out[k] = (int8_t)(int)q;
  }
  if (threadIdx.x == 0) dx[row] = d;
}

}  // namespace

// x f32 [M, Kx] -> xq int8 [M, K_out], dx f32 [M]. Returns the CUDA error
// code of the launch.
extern "C" int quant_rows_int8(const void* x, int M, int Kx, int K_out,
                               void* xq, void* dx, void* stream) {
  quant_rows_kernel<<<M, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, Kx, K_out, (int8_t*)xq, (float*)dx);
  return (int)cudaGetLastError();
}
