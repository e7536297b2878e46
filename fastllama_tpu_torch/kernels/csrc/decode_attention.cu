// Kernel B4: one decode step's attention for one layer, fused: RoPE on q
// and the new k, the in-place K/V cache write, and attention.
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

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32, kMaxD = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ qkv, T* __restrict__ kc,
                   T* __restrict__ vc, const int* __restrict__ n_past,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, int S, int F, int d,
                   float scale, float* __restrict__ out) {
  constexpr int VN = Vec16<T>::kN;
  extern __shared__ float scores[];              // [S]
  __shared__ float q_s[kMaxD], k_s[kMaxD], v_s[kMaxD], qc_s[kMaxD];
  __shared__ float ctx_s[kWarps][kMaxD];
  __shared__ float red[32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  for (int s = tid; s < n; s += kThreads) {
    const T* kr_row = kc + ((size_t)b * S + s) * F + head_off;
    float acc = 0.f;
#pragma unroll 4
    for (int l = 0; l < d; l += VN) {
      float v[VN];
      Vec16<T>::load(kr_row + l, v);
#pragma unroll
      for (int i = 0; i < VN; ++i) acc += qc_s[l + i] * v[i];
    }
    scores[s] = acc * scale;
  }
  float mx = s_new;
  for (int s = tid; s < n; s += kThreads) mx = fmaxf(mx, scores[s]);
  const float m = fltorch::block_max(mx, red);                   // syncs
  float lsum = 0.f;
  for (int s = tid; s < n; s += kThreads) {
    const float p = expf(scores[s] - m);
    scores[s] = p;
    lsum += p;
  }
  const float e_new = expf(s_new - m);
  const float l_tot = fltorch::block_sum(lsum, red) + e_new;     // syncs

  const int per_lane = d / 32;                   // d <= 256: at most 8
  float acc[kMaxD / 32];
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int s = warp; s < n; s += kWarps) {
    const float p = fltorch::to_f32(fltorch::from_f32<T>(scores[s]));
    const T* vr_row = vc + ((size_t)b * S + s) * F + head_off + lane * per_lane;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i)
      if (i < per_lane) acc[i] += p * fltorch::to_f32(vr_row[i]);
  }
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i)
    if (i < per_lane) ctx_s[warp][lane * per_lane + i] = acc[i];
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

}  // namespace

// qkv f32 [B, 3F], caches [B, S, F] of type bf16 (cache_bf16 = 1) or f32,
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
