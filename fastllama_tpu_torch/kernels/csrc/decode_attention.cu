// Kernels B4 and B10: one decode step's attention for one layer.
//
// B4 (decode_attention_fused) is fused: RoPE on q and the new k, the
// in-place K/V cache write, and attention.
//
// Replaces fastllama_tpu/kernels/decode_attention.py::decode_attention_fused
// (_fused_kernel_grouped). For each (sequence b, head h):
//   q, k_new = rope(qkv[b, Q/K block of head h])  lane l: x[l]*cos[l] +
//              x[l^1]*sin_signed[l]  (lanes >= n_rot have cos 1, sin 0)
//   scores_s = dot(T(q), K[b, s, h]) * scale        rows s < n_past[b]
//   s_new    = dot(q, k_new) * scale                 (f32, unrounded)
//   m = max(scores, s_new); p_s = exp(scores_s - m); e = exp(s_new - m)
//   ctx = (dot(T(p), V[b, :n_past, h]) + e * v_new) / (sum p + e)
//   K[b, w, h] = T(k_new), V[b, w, h] = T(v_new), w = clip(n_past, 0, S-1)
// where T is the cache type (bf16 or f32): q and p are cast to it for the
// two cache dots, as the TPU kernel does, with f32 accumulation. The cache
// row is written after every read of the cache, so the attention always
// sees the cache as it was before this step.
//
// Bound on the H100: bytes. The step reads 2 * n_past * H * Dh cache
// elements once and does ~4 flops per element. One 256-thread block per
// (b, h). Scores: each thread takes whole cache rows (s = tid, tid + 256,
// ...) and reads a row's head slice as independent 16-byte loads, so many
// loads are in flight and no per-row warp reduction is needed; the scores
// live in shared memory (4 bytes per row, S <= 12288). PV: each warp takes
// every eighth row, its lanes read one row's head slice contiguously, and
// the 8 warps' partial contexts are added through shared memory. At B = 1
// the 7B model gives only 32 blocks for 132 SMs; splitting S across blocks
// is later work.
//
// B10 (decode_attention) replaces decode_attention (_decode_attn_kernel) of
// the same file: attention alone, over caches that already hold the current
// token's row (the caller ropes and writes it, as it must when LoRA terms
// are added to q, k and v after the fused projection):
//   scores_s = dot(q, K[b, s, h]) * scale     rows s <= n_past[b] (inclusive)
//   ctx      = softmax(scores) @ V[b, :n_past + 1, h]
// Everything is f32 after the load: neither q nor p is cast to the cache
// type. A slot with n_past >= S attends all S rows and gives finite numbers.
// It shares B4's row loops (attend_scores, attend_values) and its bound.

#include "common.cuh"

namespace {

using fltorch::Vec16;

constexpr int kThreads = 256, kWarps = kThreads / 32, kMaxD = 256;

// scores[s] = dot(qv, K[s]) * scale for the n rows of one (b, h) at kbase
// (row stride F), then p = exp(score - max) in place; `extra` is a score
// outside the cache that joins the max (-INFINITY for none). Returns the max
// in m and this thread's share of sum p in lsum. Each thread takes whole rows
// and reads a row's head slice as independent 16-byte loads.
template <typename T>
__device__ __forceinline__ void attend_scores(
    const float* qv, const T* kbase, int n, int F, int d, float scale,
    float extra, float* scores, float* red, float& m, float& lsum) {
  constexpr int VN = Vec16<T>::kN;
  const int tid = threadIdx.x;
  for (int s = tid; s < n; s += kThreads) {
    const T* kr_row = kbase + (size_t)s * F;
    float acc = 0.f;
#pragma unroll 4
    for (int l = 0; l < d; l += VN) {
      float v[VN];
      Vec16<T>::load(kr_row + l, v);
#pragma unroll
      for (int i = 0; i < VN; ++i) acc += qv[l + i] * v[i];
    }
    scores[s] = acc * scale;
  }
  float mx = extra;
  for (int s = tid; s < n; s += kThreads) mx = fmaxf(mx, scores[s]);
  m = fltorch::block_max(mx, red);                               // syncs
  lsum = 0.f;
  for (int s = tid; s < n; s += kThreads) {
    const float p = expf(scores[s] - m);
    scores[s] = p;
    lsum += p;
  }
}

// ctx_s[warp][l] = this warp's share of sum_s p_s * V[s, l] over the n rows
// at vbase; CAST_P rounds p to the cache type first (B4). Each warp takes
// every eighth row and its lanes read one row's head slice contiguously.
// The caller synchronizes (scores complete) before and after.
template <typename T, bool CAST_P>
__device__ __forceinline__ void attend_values(
    const float* scores, const T* vbase, int n, int F, int d,
    float (*ctx_s)[kMaxD]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_lane = d / 32;                   // d <= 256: at most 8
  float acc[kMaxD / 32];
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int s = warp; s < n; s += kWarps) {
    const float p = CAST_P ? fltorch::to_f32(fltorch::from_f32<T>(scores[s]))
                           : scores[s];
    const T* vr_row = vbase + (size_t)s * F + lane * per_lane;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i)
      if (i < per_lane) acc[i] += p * fltorch::to_f32(vr_row[i]);
  }
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i)
    if (i < per_lane) ctx_s[warp][lane * per_lane + i] = acc[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ qkv, T* __restrict__ kc,
                   T* __restrict__ vc, const int* __restrict__ n_past,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, int S, int F, int d,
                   float scale, float* __restrict__ out) {
  extern __shared__ float scores[];              // [S]
  __shared__ float q_s[kMaxD], k_s[kMaxD], v_s[kMaxD], qc_s[kMaxD];
  __shared__ float ctx_s[kWarps][kMaxD];
  __shared__ float red[32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int np = n_past[b];
  const int n = min(max(np, 0), S);              // rows attended
  const int w_row = min(max(np, 0), S - 1);      // row written
  const float* row = qkv + (size_t)b * 3 * F + (size_t)h * d;
  const float* cs = cos_t + (size_t)b * d;
  const float* sn = sin_t + (size_t)b * d;

  for (int l = tid; l < d; l += kThreads) {
    q_s[l] = row[l];
    k_s[l] = row[F + l];
    v_s[l] = row[2 * F + l];
  }
  __syncthreads();
  float qr = 0.f, kr = 0.f;
  if (tid < d) {
    // fma(x, cos, round(partner * sin)): the roundings XLA:CPU gives the
    // JAX kernel's x * cos + partner * sin; the rotated k is stored in the
    // cache, so it matches the reference and the plain version bit for bit
    qr = __fmaf_rn(q_s[tid], cs[tid], __fmul_rn(q_s[tid ^ 1], sn[tid]));
    kr = __fmaf_rn(k_s[tid], cs[tid], __fmul_rn(k_s[tid ^ 1], sn[tid]));
  }
  __syncthreads();
  if (tid < d) {
    q_s[tid] = qr;
    k_s[tid] = kr;
    qc_s[tid] = fltorch::to_f32(fltorch::from_f32<T>(qr));
  }
  const float s_new = fltorch::block_sum(qr * kr, red) * scale;   // syncs

  const size_t head_off = (size_t)h * d;
  float m, lsum;
  attend_scores<T>(qc_s, kc + (size_t)b * S * F + head_off, n, F, d, scale,
                   s_new, scores, red, m, lsum);
  const float e_new = expf(s_new - m);
  const float l_tot = fltorch::block_sum(lsum, red) + e_new;     // syncs
  attend_values<T, true>(scores, vc + (size_t)b * S * F + head_off, n, F, d,
                         ctx_s);
  __syncthreads();
  for (int l = tid; l < d; l += kThreads) {
    float c = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += ctx_s[w][l];
    out[(size_t)b * F + head_off + l] = (c + e_new * v_s[l]) / l_tot;
    const size_t wi = ((size_t)b * S + w_row) * F + head_off + l;
    kc[wi] = fltorch::from_f32<T>(k_s[l]);
    vc[wi] = fltorch::from_f32<T>(v_s[l]);
  }
}

template <typename T>
int launch(const void* qkv, void* kc, void* vc, const void* n_past,
           const void* cos_t, const void* sin_t, int B, int S, int F, int d,
           float scale, void* out, cudaStream_t stream) {
  dim3 grid(F / d, B);
  const size_t smem = (size_t)S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const float*)qkv, (T*)kc, (T*)vc, (const int*)n_past,
      (const float*)cos_t, (const float*)sin_t, S, F, d, scale, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_only_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                 const T* __restrict__ vc, const int* __restrict__ n_past,
                 int S, int F, int d, float scale, float* __restrict__ out) {
  extern __shared__ float scores[];              // [S]
  __shared__ float q_s[kMaxD];
  __shared__ float ctx_s[kWarps][kMaxD];
  __shared__ float red[32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n = min(max(n_past[b], 0) + 1, S);   // rows s <= n_past
  const size_t head_off = (size_t)h * d;
  for (int l = tid; l < d; l += kThreads) q_s[l] = q[(size_t)b * F + head_off + l];
  __syncthreads();
  float m, lsum;
  attend_scores<T>(q_s, kc + (size_t)b * S * F + head_off, n, F, d, scale,
                   -INFINITY, scores, red, m, lsum);
  const float l_tot = fltorch::block_sum(lsum, red);             // syncs
  attend_values<T, false>(scores, vc + (size_t)b * S * F + head_off, n, F, d,
                          ctx_s);
  __syncthreads();
  for (int l = tid; l < d; l += kThreads) {
    float c = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += ctx_s[w][l];
    out[(size_t)b * F + head_off + l] = c / l_tot;
  }
}

template <typename T>
int launch_attn_only(const void* q, const void* kc, const void* vc,
                     const void* n_past, int B, int S, int F, int d,
                     float scale, void* out, cudaStream_t stream) {
  dim3 grid(F / d, B);
  const size_t smem = (size_t)S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_only_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  attn_only_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const T*)kc, (const T*)vc, (const int*)n_past, S, F,
      d, scale, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// B10. q f32 [B, F] (already roped), caches [B, S, F] of type bf16
// (cache_bf16 = 1) or f32 with the current row written, n_past int32 [B]
// (>= 0), out f32 [B, F]; d <= 256 and a multiple of 32.
// Returns the CUDA error code of the launch.
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* n_past, int B, int S, int F,
                                int d, float scale, int cache_bf16, void* out,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cache_bf16)
    return launch_attn_only<__nv_bfloat16>(q, kc, vc, n_past, B, S, F, d,
                                           scale, out, s);
  return launch_attn_only<float>(q, kc, vc, n_past, B, S, F, d, scale, out, s);
}

// B4. qkv f32 [B, 3F], caches [B, S, F] of type bf16 (cache_bf16 = 1) or f32,
// n_past int32 [B], cos/sin f32 [B, d], out f32 [B, F]; d <= 256 and a
// multiple of 32.
// Returns the CUDA error code of the launch.
extern "C" int decode_attention_fused(const void* qkv, void* kc, void* vc,
                                      const void* n_past, const void* cos_t,
                                      const void* sin_t, int B, int S, int F,
                                      int d, float scale, int cache_bf16,
                                      void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cache_bf16)
    return launch<__nv_bfloat16>(qkv, kc, vc, n_past, cos_t, sin_t, B, S, F,
                                 d, scale, out, s);
  return launch<float>(qkv, kc, vc, n_past, cos_t, sin_t, B, S, F, d, scale,
                       out, s);
}
