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
// the 7B model gives only 32 blocks for 132 SMs; B10 below splits S across
// blocks, B4 keeps this design until its own redesign.
//
// B10 (decode_attention) replaces decode_attention (_decode_attn_kernel) of
// the same file: attention alone, over caches that already hold the current
// token's row (the caller ropes and writes it, as it must when LoRA terms
// are added to q, k and v after the fused projection):
//   scores_s = dot(q, K[b, s, h]) * scale     rows s <= n_past[b] (inclusive)
//   ctx      = softmax(scores) @ V[b, :n_past + 1, h]
// Everything is f32 after the load: neither q nor p is cast to the cache
// type. A slot with n_past >= S attends all S rows and gives finite numbers.
//
// B10's design is flash-decoding, with loops of its own (B4 keeps the ones
// above). One block per (h, b) walking every row left three quarters of the
// SMs idle at B = 1 (32 blocks) and read key rows 8 KB apart within a warp.
// Here the grid is (h, b, split): the host cuts S (never n_past, which would
// cost a host sync) into `splits` chunks of `chunk` <= 64 rows. A block
// takes the rows of its chunk that are <= min(n_past, S - 1): it first puts
// every K and V row of the chunk in flight at once (cp.async, 16 bytes a
// lane, coalesced) into shared memory, so the chunk costs one memory round
// trip; then 16 lanes take one row and reduce its dot by shuffles, 8 such
// groups take 8 rows at a time, the chunk's scores sit in shared memory,
// p = exp(score - m), and the same groups accumulate p * V. A chunk past the
// length (the neutral partial: m = -inf, l = 0) exits at once; a sequence
// whose rows fit one chunk is written by that block directly. Otherwise
// each block writes its partial (m, l, ctx[D]) to scratch [B, H, splits,
// D + 2], and the last of the sequence's active blocks, elected by an atomic
// counter that it resets, merges the partials in chunk order, loading 8 of
// them at a time in one round trip: deterministic, one launch, graph-safe.

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

// ---- B10 ----------------------------------------------------------------

constexpr int kSplitThreads = 128;               // 8 groups of 16 lanes
constexpr int kGroups = kSplitThreads / 16, kMaxChunk = 64;
constexpr int kMaxSplits = 12288 / kMaxChunk;    // S <= 12288

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

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
    for (int i = 0; i < EPL; ++i) out[i] = fltorch::to_f32(p[i]);
  }
}

template <typename T, int EPL>
__global__ void __launch_bounds__(kSplitThreads)
attn_split_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const int* __restrict__ n_past,
                  int S, int F, int chunk, float scale,
                  float* __restrict__ partial, int* __restrict__ counters,
                  float* __restrict__ out) {
  constexpr int D = 16 * EPL;
  constexpr int kRowChunks = D * (int)sizeof(T) / 16;   // 16-byte pieces
  extern __shared__ __align__(16) uint8_t kv_raw[];     // K, V [chunk][D]
  __shared__ float sc[kMaxChunk];
  __shared__ float red[kGroups][D];
  __shared__ float ml[2];
  __shared__ int is_last;
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int H = gridDim.x, nsp = gridDim.z;
  const int tid = threadIdx.x, grp = tid >> 4, gl = tid & 15;
  const int n = min(max(n_past[b], 0) + 1, S);   // rows s <= n_past
  const int act = (n + chunk - 1) / chunk;       // chunks holding rows
  if (sp >= act) return;                         // past the length
  const int s0 = sp * chunk, cnt = min(s0 + chunk, n) - s0;
  const size_t head_off = (size_t)h * D;
  T* ks = reinterpret_cast<T*>(kv_raw);
  T* vs = ks + (size_t)chunk * D;

  // every K and V row of the chunk in flight at once, K and V as two
  // groups: the scores need only K, so V keeps arriving meanwhile
  const size_t base = ((size_t)b * S + s0) * F + head_off;
  for (int i = tid; i < cnt * kRowChunks; i += kSplitThreads) {
    const int r = i / kRowChunks, c = i - r * kRowChunks;
    cp_async16(ks + (size_t)r * D + c * (16 / sizeof(T)),
               kc + base + (size_t)r * F + c * (16 / sizeof(T)));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < cnt * kRowChunks; i += kSplitThreads) {
    const int r = i / kRowChunks, c = i - r * kRowChunks;
    cp_async16(vs + (size_t)r * D + c * (16 / sizeof(T)),
               vc + base + (size_t)r * F + c * (16 / sizeof(T)));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  float qv[EPL];
  const float* qrow = q + (size_t)b * F + head_off + gl * EPL;
#pragma unroll
  for (int i = 0; i < EPL; ++i) qv[i] = qrow[i];
  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();

  // scores: group g takes rows g, g + 8, ...; the trip count is the same
  // for every lane of the block, so the shuffles are uniform
  for (int r0 = 0; r0 < cnt; r0 += kGroups) {
    const int r = r0 + grp;
    float acc = 0.f;
    if (r < cnt) {
      float kv[EPL];
      lane_row<T, EPL>(ks + (size_t)r * D + gl * EPL, kv);
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc += qv[i] * kv[i];
    }
    acc = group16_sum(acc);
    if (r < cnt && gl == 0) sc[r] = acc * scale;
  }
  __syncthreads();
  if (tid < 32) {                                // softmax over <= 64 rows
    const float a = tid < cnt ? sc[tid] : -INFINITY;
    const float c = tid + 32 < cnt ? sc[tid + 32] : -INFINITY;
    const float m = fltorch::warp_max(fmaxf(a, c));
    const float pa = tid < cnt ? expf(a - m) : 0.f;
    const float pc = tid + 32 < cnt ? expf(c - m) : 0.f;
    if (tid < cnt) sc[tid] = pa;
    if (tid + 32 < cnt) sc[tid + 32] = pc;
    const float l = fltorch::warp_sum(pa + pc);
    if (tid == 0) {
      ml[0] = m;
      ml[1] = l;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  float acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;
  for (int r = grp; r < cnt; r += kGroups) {
    const float p = sc[r];
    float vv[EPL];
    lane_row<T, EPL>(vs + (size_t)r * D + gl * EPL, vv);
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] += p * vv[i];
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) red[grp][gl * EPL + i] = acc[i];
  __syncthreads();
  float* o = out + (size_t)b * F + head_off;
  if (act == 1) {                                // one chunk: no merge
    for (int l = tid; l < D; l += kSplitThreads) {
      float c = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) c += red[g][l];
      o[l] = c / ml[1];
    }
    return;
  }
  float* part = partial + (((size_t)b * H + h) * nsp + sp) * (D + 2);
  for (int l = tid; l < D; l += kSplitThreads) {
    float c = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) c += red[g][l];
    part[2 + l] = c;
  }
  if (tid == 0) {
    part[0] = ml[0];
    part[1] = ml[1];
  }

  // The last of the act blocks of this (b, h) merges them in chunk order.
  __threadfence();
  __syncthreads();
  const int ctr = b * H + h;
  if (tid == 0) is_last = atomicAdd(&counters[ctr], 1) == act - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* pb = partial + ((size_t)b * H + h) * nsp * (D + 2);
  // chunks in order, 8 at a time: the (m, l, ctx) of a batch are loaded
  // together (one round trip), merged two-pass within the batch and online
  // (rescaled by the running max) across batches
  constexpr int kBatch = 8;
  for (int l = tid; l < D; l += kSplitThreads) {
    float M = -INFINITY, L = 0.f, C = 0.f;
    for (int i0 = 0; i0 < act; i0 += kBatch) {
      float mi[kBatch], li[kBatch], ci[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float* pi = pb + (size_t)(i0 + j) * (D + 2);
        const bool ok = i0 + j < act;
        mi[j] = ok ? __ldcg(pi) : -INFINITY;
        li[j] = ok ? __ldcg(pi + 1) : 0.f;
        ci[j] = ok ? __ldcg(pi + 2 + l) : 0.f;
      }
      float mb = M;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) mb = fmaxf(mb, mi[j]);
      const float r = expf(M - mb);              // 0 on the first batch
      L *= r;
      C *= r;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float e = i0 + j < act ? expf(mi[j] - mb) : 0.f;
        L += li[j] * e;
        C += ci[j] * e;
      }
      M = mb;
    }
    o[l] = C / L;
  }
  if (tid == 0) counters[ctr] = 0;
}

template <typename T, int EPL>
int launch_split(const void* q, const void* kc, const void* vc,
                 const void* n_past, int B, int S, int F, int splits,
                 int chunk, float scale, void* partial, void* counters,
                 void* out, cudaStream_t stream) {
  const size_t smem = (size_t)2 * chunk * 16 * EPL * sizeof(T);
  if (smem + 16 * 1024 > 48 * 1024) {    // with the static shared memory
    cudaError_t err = cudaFuncSetAttribute(
        attn_split_kernel<T, EPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(F / (16 * EPL), B, splits);
  attn_split_kernel<T, EPL><<<grid, kSplitThreads, smem, stream>>>(
      (const float*)q, (const T*)kc, (const T*)vc, (const int*)n_past, S, F,
      chunk, scale, (float*)partial, (int*)counters, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_split(const void* q, const void* kc, const void* vc,
                   const void* n_past, int B, int S, int F, int d, int splits,
                   int chunk, float scale, void* partial, void* counters,
                   void* out, cudaStream_t s) {
#define FLTORCH_B10_CASE(EPL)                                                 \
  case 16 * EPL:                                                              \
    return launch_split<T, EPL>(q, kc, vc, n_past, B, S, F, splits, chunk,    \
                                scale, partial, counters, out, s);
  switch (d) {
    FLTORCH_B10_CASE(2) FLTORCH_B10_CASE(4) FLTORCH_B10_CASE(6)
    FLTORCH_B10_CASE(8) FLTORCH_B10_CASE(10) FLTORCH_B10_CASE(12)
    FLTORCH_B10_CASE(14) FLTORCH_B10_CASE(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLTORCH_B10_CASE
}

}  // namespace

// B10. q f32 [B, F] (already roped), caches [B, S, F] of type bf16
// (cache_bf16 = 1) or f32 with the current row written, n_past int32 [B]
// (>= 0), out f32 [B, F]; d <= 256 and a multiple of 32. The caller cuts S
// into `splits` chunks of `chunk` <= 64 rows (splits * chunk >= S) and
// passes partial f32 [B, F / d, splits, d + 2] scratch and counters int32
// zeros [B * F / d] (left zeroed).
// Returns the CUDA error code of the launch.
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* n_past, int B, int S, int F,
                                int d, int splits, int chunk, float scale,
                                int cache_bf16, void* partial, void* counters,
                                void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk < 1 || chunk > kMaxChunk || splits < 1 || splits > kMaxSplits ||
      d > kMaxD || d % 32)
    return (int)cudaErrorInvalidValue;
  if (cache_bf16)
    return dispatch_split<__nv_bfloat16>(q, kc, vc, n_past, B, S, F, d,
                                         splits, chunk, scale, partial,
                                         counters, out, s);
  return dispatch_split<float>(q, kc, vc, n_past, B, S, F, d, splits, chunk,
                               scale, partial, counters, out, s);
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
