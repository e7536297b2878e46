// Helpers shared by the port's Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fltorch {

// Round an f32 value to bf16 and back (round to nearest even), the cast the
// bf16 weight mode applies to activations and dequantized weights.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16-byte vector of cache elements, widened to f32.
template <typename T> struct Vec16;
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

// The three bf16 parts of an f32 value (B1's, B9's and B5's f32 modes),
// as bit patterns in the upper halves: h = x's upper 16 bits, m = those of
// r = x - h, l = r - m (exact: it keeps at most 8 significant bits, so its
// lower half is zero wherever |x| >= 2^-110); h + m + l = x, each part a
// bf16 value, and no part overflows (truncation, not rounding).
__device__ __forceinline__ void f32_parts(float x, uint32_t* p) {
  p[0] = __float_as_uint(x) & 0xFFFF0000u;
  const float r = __fsub_rn(x, __uint_as_float(p[0]));
  p[1] = __float_as_uint(r) & 0xFFFF0000u;
  p[2] = __float_as_uint(__fsub_rn(r, __uint_as_float(p[1])));
}

// The upper halves of two words as one bf16x2 word (a's in the low half).
__device__ __forceinline__ uint32_t hi2(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions over blockDim.x threads (a multiple of 32, at most
// 1024). `red` is 32 floats of shared scratch; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : 0.f;
  return warp_sum(v);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : -INFINITY;
  return warp_max(v);
}

// rope(x) of a lane's EPL elements (EPL is even, so the partner l ^ 1 of
// each is the lane's own): fma(x, cos, round(partner * sin)), the roundings
// XLA:CPU gives the JAX kernel's x * cos + partner * sin; the rotated k is
// stored in the cache (B4) or the pools (the fused paged step), so it
// matches the reference and the plain versions bit for bit.
template <int EPL>
__device__ __forceinline__ void rope_lane(const float* x, const float* cs,
                                          const float* sn, float* out) {
#pragma unroll
  for (int i = 0; i < EPL; ++i)
    out[i] = __fmaf_rn(x[i], cs[i], __fmul_rn(x[i ^ 1], sn[i]));
}

// Sum over the 16 lanes of a half warp (every lane gets the result).
__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// EPL consecutive cache elements of one lane from shared memory, widened.
template <typename T, int EPL>
__device__ __forceinline__ void lane_row(const T* p, float* out) {
  if constexpr (EPL * sizeof(T) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < EPL; i += Vec16<T>::kN) Vec16<T>::load(p + i, out + i);
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) out[i] = to_f32(p[i]);
  }
}

}  // namespace fltorch
