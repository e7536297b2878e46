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
// B10 (decode_attention) replaces decode_attention (_decode_attn_kernel) of
// the same file: attention alone, over caches that already hold the current
// token's row (the caller ropes and writes it, as it must when LoRA terms
// are added to q, k and v after the fused projection):
//   scores_s = dot(q, K[b, s, h]) * scale     rows s <= n_past[b] (inclusive)
//   ctx      = softmax(scores) @ V[b, :n_past + 1, h]
// Everything is f32 after the load: neither q nor p is cast to the cache
// type. A slot with n_past >= S attends all S rows and gives finite numbers.
//
// Bound on the H100 (both): bytes. A step reads 2 * n_past * H * Dh cache
// elements once and does ~4 flops per element. Both kernels are one
// flash-decoding kernel (attn_split_kernel; B4 sets FUSED). One block per
// (h, b) walking every row left three quarters of the SMs idle at B = 1 (32
// blocks) and read key rows 8 KB apart within a warp. Here the grid is
// (h, b, split): the host cuts S (never n_past, which would cost a host
// sync) into `splits` chunks of `chunk` <= 64 rows. A block takes the rows
// of its chunk that it attends: it first puts every K and V row of the
// chunk in flight at once (cp.async, 16 bytes a lane, coalesced) into shared
// memory, so the chunk costs one memory round trip; then 16 lanes take one
// row and reduce its dot by shuffles, 8 such groups take 8 rows at a time,
// the chunk's scores sit in shared memory, p = exp(score - m), and the same
// groups accumulate p * V. A chunk past the length (the neutral partial:
// m = -inf, l = 0) exits at once; a sequence whose rows fit one chunk is
// finished by that block directly. Otherwise each block writes its partial
// (m, l, ctx[D]) to scratch [B, H, splits, D + 2], and the last of the
// sequence's active blocks, elected by an atomic counter that it resets,
// merges the partials in chunk order, loading 8 of them at a time in one
// round trip: deterministic, one launch, graph-safe.
//
// What FUSED (B4) adds to that:
//   * every block ropes its own copy of q from the raw qkv (a lane's pairs
//     (l, l^1) lie among its own elements) and casts it to T for the scores;
//   * a chunk's p-cast is T(exp(score - m_chunk)), not the unsplit
//     T(exp(score - m)) with the global max: the chunk's partial is then
//     rescaled by exp(m_chunk - M) in f32. That moves one bf16 rounding of
//     each p, within B4's tolerance of 2^-7 of the largest output; l stays
//     the sum of the unrounded p, as in the plain version;
//   * the new token is one more partial, folded in unrounded after the
//     chunks: m = s_new, l = 1, ctx = v_new;
//   * the block that finishes a (b, h) (the merging block, or the single
//     block of a one-chunk sequence) ropes k_new, computes s_new and writes
//     T(k_new) and T(v_new) at row w. Every other block of the (b, h) has
//     read its rows before it counted in, so the write cannot reach a read
//     of this step, also at n_past >= S where w = S - 1 is attended;
//   * a (b, h) with no rows (n_past = 0) still has its one block, which
//     writes the row and ctx = v_new.

#include "common.cuh"

namespace {

using fltorch::Vec16;
using fltorch::cp_async16;
using fltorch::group16_sum;
using fltorch::lane_row;
using fltorch::rope_lane;

constexpr int kMaxD = 256;

constexpr int kSplitThreads = 128;               // 8 groups of 16 lanes
constexpr int kGroups = kSplitThreads / 16, kMaxChunk = 64;
constexpr int kMaxSplits = 12288 / kMaxChunk;    // S <= 12288

// B4's new token, in the block that finishes a (b, h): ropes the lane's
// slice of k_new, writes T(k_new) and T(v_new) into cache row `row` (group
// 0 of the block) and returns s_new = dot(q, k_new) * scale to every
// thread. All threads of the block call it (the dot is reduced by shuffles).
template <typename T, int EPL>
__device__ __forceinline__ float new_token(const float* kvrow, int F,
                                           const float* qr, const float* cs,
                                           const float* sn, T* krow, T* vrow,
                                           float scale) {
  const int gl = threadIdx.x & 15;
  float x[EPL], kr[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) x[i] = kvrow[gl * EPL + i];
  rope_lane<EPL>(x, cs, sn, kr);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) dot += qr[i] * kr[i];
  dot = group16_sum(dot);
  if (threadIdx.x < 16) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      krow[gl * EPL + i] = fltorch::from_f32<T>(kr[i]);
      vrow[gl * EPL + i] = fltorch::from_f32<T>(kvrow[F + gl * EPL + i]);
    }
  }
  return dot * scale;
}

// q: B10 the roped q [B, F]; B4 the raw projection qkv [B, 3F] and the
// tables cos_t, sin_t [B, D] (B10 passes none).
template <typename T, int EPL, bool FUSED>
__global__ void __launch_bounds__(kSplitThreads)
attn_split_kernel(const float* __restrict__ q, T* __restrict__ kc,
                  T* __restrict__ vc, const int* __restrict__ n_past,
                  const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t, int S, int F, int chunk,
                  float scale, float* __restrict__ partial,
                  int* __restrict__ counters, float* __restrict__ out) {
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
  const int np = max(n_past[b], 0);
  // rows attended: B10 s <= n_past, B4 s < n_past (plus the new token)
  const int n = min(FUSED ? np : np + 1, S);
  // chunks holding rows; B4 keeps one block for a (b, h) with none
  const int act = max(1, (n + chunk - 1) / chunk);
  if (sp >= act) return;                         // past the length
  const int s0 = sp * chunk, cnt = max(0, min(s0 + chunk, n) - s0);
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
  // qr: q in f32 (B4: roped); qv: what the scores take (B4: T(qr))
  float qr[EPL], qv[EPL];
  const float* qrow = q + (size_t)b * (FUSED ? 3 * F : F) + head_off;
  const float* cs = FUSED ? cos_t + (size_t)b * D + gl * EPL : nullptr;
  const float* sn = FUSED ? sin_t + (size_t)b * D + gl * EPL : nullptr;
#pragma unroll
  for (int i = 0; i < EPL; ++i) qv[i] = qrow[gl * EPL + i];
  if constexpr (FUSED) {
    rope_lane<EPL>(qv, cs, sn, qr);
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      qv[i] = fltorch::to_f32(fltorch::from_f32<T>(qr[i]));
  }
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
    const float p =
        FUSED ? fltorch::to_f32(fltorch::from_f32<T>(sc[r])) : sc[r];
    float vv[EPL];
    lane_row<T, EPL>(vs + (size_t)r * D + gl * EPL, vv);
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] += p * vv[i];
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) red[grp][gl * EPL + i] = acc[i];
  __syncthreads();
  float* o = out + (size_t)b * F + head_off;
  // B4: the new token's k and v in qkv, and the cache row it goes to
  const float* kvrow = qrow + F;
  const size_t w_off = ((size_t)b * S + min(np, S - 1)) * F + head_off;
  if (act == 1) {                                // one chunk: no merge
    if constexpr (FUSED) {
      // fold the new token into the chunk's partial; an empty chunk has
      // m = -inf, l = 0, ctx = 0 and weighs exp(-inf) = 0
      const float s_new = new_token<T, EPL>(kvrow, F, qr, cs, sn, kc + w_off,
                                            vc + w_off, scale);
      const float M = fmaxf(ml[0], s_new);
      const float a = expf(ml[0] - M), e = expf(s_new - M);
      const float L = ml[1] * a + e;
      for (int l = tid; l < D; l += kSplitThreads) {
        float c = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) c += red[g][l];
        o[l] = (c * a + e * kvrow[F + l]) / L;
      }
    } else {
      for (int l = tid; l < D; l += kSplitThreads) {
        float c = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) c += red[g][l];
        o[l] = c / ml[1];
      }
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
  const int ctr = b * H + h;
  if (!fltorch::last_of_split(counters, ctr, act, &is_last)) return;
  const float* pb = partial + ((size_t)b * H + h) * nsp * (D + 2);
  float s_new = 0.f;
  if constexpr (FUSED)                           // every read is done
    s_new = new_token<T, EPL>(kvrow, F, qr, cs, sn, kc + w_off, vc + w_off,
                              scale);
  for (int l = tid; l < D; l += kSplitThreads) {
    float M, L, C;
    fltorch::merge_partials<D>(pb, act, l, M, L, C);
    if constexpr (FUSED) {                       // the new token, last
      const float mb = fmaxf(M, s_new);
      const float r = expf(M - mb), e = expf(s_new - mb);
      L = L * r + e;
      C = C * r + e * kvrow[F + l];
    }
    o[l] = C / L;
  }
  if (tid == 0) counters[ctr] = 0;
}

template <typename T, int EPL, bool FUSED>
int launch_split(const void* q, void* kc, void* vc, const void* n_past,
                 const void* cos_t, const void* sin_t, int B, int S, int F,
                 int splits, int chunk, float scale, void* partial,
                 void* counters, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)2 * chunk * 16 * EPL * sizeof(T);
  if (smem + 16 * 1024 > 48 * 1024) {    // with the static shared memory
    cudaError_t err = cudaFuncSetAttribute(
        attn_split_kernel<T, EPL, FUSED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(F / (16 * EPL), B, splits);
  attn_split_kernel<T, EPL, FUSED><<<grid, kSplitThreads, smem, stream>>>(
      (const float*)q, (T*)kc, (T*)vc, (const int*)n_past,
      (const float*)cos_t, (const float*)sin_t, S, F, chunk, scale,
      (float*)partial, (int*)counters, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T, bool FUSED>
int dispatch_split(const void* q, void* kc, void* vc, const void* n_past,
                   const void* cos_t, const void* sin_t, int B, int S, int F,
                   int d, int splits, int chunk, float scale, void* partial,
                   void* counters, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk < 1 || chunk > kMaxChunk || splits < 1 || splits > kMaxSplits ||
      d > kMaxD || d % 32)
    return (int)cudaErrorInvalidValue;
#define FLTORCH_B10_CASE(EPL)                                                 \
  case 16 * EPL:                                                              \
    return launch_split<T, EPL, FUSED>(q, kc, vc, n_past, cos_t, sin_t, B, S, \
                                       F, splits, chunk, scale, partial,      \
                                       counters, out, s);
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
  void* k = const_cast<void*>(kc);               // read only (not FUSED)
  void* v = const_cast<void*>(vc);
  if (cache_bf16)
    return dispatch_split<__nv_bfloat16, false>(
        q, k, v, n_past, nullptr, nullptr, B, S, F, d, splits, chunk, scale,
        partial, counters, out, stream);
  return dispatch_split<float, false>(q, k, v, n_past, nullptr, nullptr, B, S,
                                      F, d, splits, chunk, scale, partial,
                                      counters, out, stream);
}

// B4. qkv f32 [B, 3F], caches [B, S, F] of type bf16 (cache_bf16 = 1) or f32,
// updated in place, n_past int32 [B], cos/sin f32 [B, d], out f32 [B, F];
// d <= 256 and a multiple of 32; splits, chunk, partial and counters as for
// B10.
// Returns the CUDA error code of the launch.
extern "C" int decode_attention_fused(const void* qkv, void* kc, void* vc,
                                      const void* n_past, const void* cos_t,
                                      const void* sin_t, int B, int S, int F,
                                      int d, int splits, int chunk,
                                      float scale, int cache_bf16,
                                      void* partial, void* counters,
                                      void* out, void* stream) {
  if (cache_bf16)
    return dispatch_split<__nv_bfloat16, true>(
        qkv, kc, vc, n_past, cos_t, sin_t, B, S, F, d, splits, chunk, scale,
        partial, counters, out, stream);
  return dispatch_split<float, true>(qkv, kc, vc, n_past, cos_t, sin_t, B, S,
                                     F, d, splits, chunk, scale, partial,
                                     counters, out, stream);
}
