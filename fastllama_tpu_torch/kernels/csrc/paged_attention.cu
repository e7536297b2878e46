// Kernels B6 and B11: one decode step's attention for one layer over the
// paged KV pools, head-major (B6) or flat-lane (B11); and B6's kernel with
// FUSED, the fused paged decode step that takes in B7's write.
//
// Replaces fastllama_tpu/kernels/paged_attention.py::paged_decode_attention
// (_paged_attn_db_kernel and its single-bank fallback). For each (sequence
// b, head h), with n = clip(lengths[b], 0, pp * ps) and key row s living in
// page tables[b, s / ps] at in-page row s % ps of the pools [H, P, ps, D]:
//   scores_s = dot(T(q), K[h, page(s), s % ps]) * scale       s < n
//   m = max scores; p_s = exp(scores_s - m); l = max(sum p, 1e-30)
//   ctx = dot(T(p), V[h, page(s), s % ps]) / l
// where T is the pool type (bf16 or f32): q and p are cast to it for the two
// dots, as the TPU kernel does, with f32 scores, softmax and accumulation.
// n = 0 gives ctx = 0. No row at or past the length, no page past
// ceil(n / ps) and no unset table entry is ever read: nothing stale can
// reach the output, and the kernel has no scratch window to sanitize (the
// TPU kernel copies whole pages into a VMEM window and must zero it once
// against 0 * NaN). Page ids are clipped into the pool. The row the step
// wrote just before (kv_write.cu) is read back from the pool, rounded to
// T: the paged rule, not B4's unrounded fold.
//
// Bound on the H100: bytes. The step reads 2 * n * D pool elements per
// (b, h) once and does ~4 flops per element. Flash-decoding over the page
// table, as B10 and B4 split the slab cache: the grid is (h, b, split) and
// the host cuts the pp * ps key rows into chunks of `chunk` rows (a whole
// number of pages, or a part of one page), planned from the shapes alone
// (B, H, pp * ps, ps: never from lengths, which would cost a host sync).
// A block looks each page id of its chunk up once, puts every K and V row
// of the chunk in flight at once (cp.async, 16 bytes a lane, coalesced
// along a row; K and V as two groups, so the scores start while V
// arrives), then 16 lanes take one row and reduce its dot by shuffles, 8
// such groups take 8 rows at a time, the chunk's scores sit in shared
// memory, p = T(exp(score - m_chunk)) and the same groups accumulate p * V.
// Each chunk rounds its own p against its own max, not the global one: one
// bf16 rounding of each p moves, within 2^-7 of the largest output (bf16)
// and 5e-5 (f32), as for B4; l is the sum of the unrounded p. A chunk past
// the length exits at once (a sequence of length 0 keeps one block, which
// writes zeros); a sequence that fits one chunk is finished by that block.
// Otherwise each block writes its partial (m, l, ctx[D]) to scratch [B, H,
// splits, D + 2], and the last active block of the (b, h), elected by a
// counter that it resets, merges the partials in chunk order, 8 per round
// trip: deterministic, one launch, graph-safe. q is read through its batch
// and head strides (the forward passes a view of its q/k block).
//
// B11 (paged_decode_attention_flat) replaces paged_decode_attention_flat
// (_paged_attn_flat_kernel) of the same file: B6's contract over flat-lane
// pools [P, ps, H * D], where the heads of one row sit side by side as in the
// slab cache. No dispatch of the JAX package reaches it (the round-5 layout
// experiment). The TPU kernel copies each page as one contiguous DMA; here
// the only difference from B6 is where a key row lives:
//   B6:  kp[((h * P + page) * ps + r) * D]      head stride P*ps*D, row D
//   B11: kp[(page * ps + r) * H * D + h * D]    head stride D, row H*D
// so both run the same kernel with the two strides as arguments, and B11 on
// flat pools equals B6 on the head-major transpose bit for bit.
//
// The fused paged step (paged_decode_step_fused, FUSED) replaces, for a
// layer without q/k/v LoRA terms, the sequence RoPE (elementwise) ->
// fastllama_tpu/kernels/kv_write.py::paged_kv_write (B7, one launch) ->
// B6, which is the JAX paged step's order: the new row is written, then
// lengths + 1 keys are attended. Bound: as B6 (bytes), and at the engine's
// sizes the launches themselves: B7 moved ~400 KB a step, far less than a
// launch costs, so its design for this card is to stop being a launch.
// The kernel takes the raw fused projection qkv [B, 3F] (F = H * D) and
// the per-row RoPE lanes cos/sin [B, D]:
//   * every block ropes its own copy of q (rope_lane, B4's FMA form) and
//     casts it to T for the scores;
//   * the chunks attend the lengths[b] resident rows through the page
//     table exactly as B6 does (the same plan, the same chunks);
//   * the new token is one more partial, folded in ROUNDED to T, the paged
//     rule: s_new = dot(T(q), T(k_rope)) * scale, ctx += p * T(v), where B6
//     would read the row back from the pool; only the rounding of its own
//     p differs (the partial's p is exp(s_new - M) unrounded), within B6's
//     tolerance;
//   * the block that finishes a (b, h) writes T(k_rope) and T(v) at
//     (page_ids[b], offsets[b]) with B7's rules (the sentinel's trash
//     page; an id outside [0, P) or an offset outside [0, ps) writes
//     nothing). No block of the step reads that row: the chunks cover rows
//     < lengths[b] only, and pages are not shared between sequences (the
//     trash page is in no table; engine/paged_kv.py), so no other
//     sequence's blocks read it either.

#include "common.cuh"

namespace {

using fltorch::cp_async16;
using fltorch::group16_sum;
using fltorch::lane_row;
using fltorch::rope_lane;

constexpr int kThreads = 128;                    // 8 groups of 16 lanes
constexpr int kGroups = kThreads / 16, kMaxChunk = 256, kMaxD = 256;
constexpr int kMaxSplits = 12288;                // pp * ps <= 12288

// What FUSED adds to B6's arguments (null for B6 and B11).
struct NewToken {
  const int* page_ids;       // [B] write page of the new row
  const int* offsets;        // [B] its row in that page
  const float* cos_t;        // [B, D] RoPE lanes
  const float* sin_t;
};

// The fused step's new token, in the block that finishes a (b, h): ropes
// the lane's slice of k (krow: the head's k in qkv), writes T(k_rope) and
// T(v) into the pool row (group 0 of the block; kdst null: no write) and
// returns s_new = dot(T(q), T(k_rope)) * scale to every thread. All threads
// of the block call it (the dot is reduced by shuffles).
template <typename T, int EPL>
__device__ __forceinline__ float new_token(const float* krow,
                                           const float* vrow,
                                           const float* qv, const float* cs,
                                           const float* sn, T* kdst, T* vdst,
                                           float scale) {
  const int gl = threadIdx.x & 15;
  float x[EPL], kr[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) x[i] = krow[gl * EPL + i];
  rope_lane<EPL>(x, cs, sn, kr);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < EPL; ++i)
    dot += qv[i] * fltorch::to_f32(fltorch::from_f32<T>(kr[i]));
  dot = group16_sum(dot);
  if (kdst != nullptr && threadIdx.x < 16) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      kdst[gl * EPL + i] = fltorch::from_f32<T>(kr[i]);
      vdst[gl * EPL + i] = fltorch::from_f32<T>(vrow[gl * EPL + i]);
    }
  }
  return dot * scale;
}

// q: B6/B11 the roped q (batch stride q_bs, head stride q_hs); FUSED the
// raw qkv [B, 3F] (q_bs = 3F, q_hs = D), with nt's write location and
// RoPE lanes.
template <typename T, int EPL, bool FUSED>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q, int q_bs, int q_hs,
                   T* __restrict__ kp, T* __restrict__ vp,
                   const int* __restrict__ lengths,
                   const int* __restrict__ tables, NewToken nt, int P, int ps,
                   int pp, size_t head_stride, int row_stride, int chunk,
                   float scale, float* __restrict__ partial,
                   int* __restrict__ counters, float* __restrict__ out) {
  constexpr int D = 16 * EPL;
  constexpr int kRowChunks = D * (int)sizeof(T) / 16;   // 16-byte pieces
  constexpr int kPer = 16 / (int)sizeof(T);             // elements a piece
  extern __shared__ __align__(16) uint8_t kv_raw[];     // K, V [chunk][D]
  __shared__ float sc[kMaxChunk];
  __shared__ float red[kGroups][D];
  __shared__ float red32[32];
  __shared__ int pg[kMaxChunk];
  __shared__ int is_last;
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int H = gridDim.x, nsp = gridDim.z;
  const int tid = threadIdx.x, grp = tid >> 4, gl = tid & 15;
  // rows attended through the table: B6 lengths[b] (the caller's count,
  // the new row included), FUSED the lengths[b] resident rows
  const int n = min(max(lengths[b], 0), pp * ps);
  const int act = max(1, (n + chunk - 1) / chunk);   // chunks holding rows
  if (sp >= act) return;                              // past the length
  const int s0 = sp * chunk, cnt = max(0, min(s0 + chunk, n) - s0);
  // the chunk's page ids, one lookup a page, clipped into the pool
  const int p0 = s0 / ps;
  const int npg = cnt > 0 ? (s0 + cnt - 1) / ps - p0 + 1 : 0;
  for (int j = tid; j < npg; j += kThreads)
    pg[j] = min(max(tables[(size_t)b * pp + p0 + j], 0), P - 1);
  __syncthreads();
  T* ks = reinterpret_cast<T*>(kv_raw);
  T* vs = ks + (size_t)chunk * D;
  const size_t hb = (size_t)h * head_stride;
  for (int i = tid; i < cnt * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks, c = i - r * kRowChunks, s = s0 + r;
    cp_async16(ks + (size_t)r * D + c * kPer,
               kp + hb + ((size_t)pg[s / ps - p0] * ps + s % ps) * row_stride
                  + c * kPer);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < cnt * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks, c = i - r * kRowChunks, s = s0 + r;
    cp_async16(vs + (size_t)r * D + c * kPer,
               vp + hb + ((size_t)pg[s / ps - p0] * ps + s % ps) * row_stride
                  + c * kPer);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  float qv[EPL];                                 // T(q), widened
  const float* qrow = q + (size_t)b * q_bs + (size_t)h * q_hs;
  const float* cs = FUSED ? nt.cos_t + (size_t)b * D + gl * EPL : nullptr;
  const float* sn = FUSED ? nt.sin_t + (size_t)b * D + gl * EPL : nullptr;
#pragma unroll
  for (int i = 0; i < EPL; ++i) qv[i] = qrow[gl * EPL + i];
  if constexpr (FUSED) {
    float qr[EPL];
    rope_lane<EPL>(qv, cs, sn, qr);
#pragma unroll
    for (int i = 0; i < EPL; ++i) qv[i] = qr[i];
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i)
    qv[i] = fltorch::to_f32(fltorch::from_f32<T>(qv[i]));
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
  float mx = -INFINITY;
  for (int r = tid; r < cnt; r += kThreads) mx = fmaxf(mx, sc[r]);
  const float m = fltorch::block_max(mx, red32);             // syncs
  float ls = 0.f;
  for (int r = tid; r < cnt; r += kThreads) {
    const float p = expf(sc[r] - m);
    sc[r] = p;
    ls += p;
  }
  const float l = fltorch::block_sum(ls, red32);             // syncs
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  float acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;
  for (int r = grp; r < cnt; r += kGroups) {
    const float p = fltorch::to_f32(fltorch::from_f32<T>(sc[r]));
    float vv[EPL];
    lane_row<T, EPL>(vs + (size_t)r * D + gl * EPL, vv);
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] += p * vv[i];
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) red[grp][gl * EPL + i] = acc[i];
  __syncthreads();
  float* o = out + ((size_t)b * H + h) * D;
  // FUSED: the head's new k and v in qkv and the pool row they go to
  const float* krow = qrow + (size_t)H * D;
  const float* vrow = krow + (size_t)H * D;
  T* kdst = nullptr;
  T* vdst = nullptr;
  if constexpr (FUSED) {
    const int pid = nt.page_ids[b], off = nt.offsets[b];
    if (pid >= 0 && pid < P && off >= 0 && off < ps) {
      const size_t w = hb + ((size_t)pid * ps + off) * row_stride;
      kdst = kp + w;
      vdst = vp + w;
    }
  }
  if (act == 1) {                                // one chunk: no merge
    if constexpr (FUSED) {
      // fold the new token into the chunk's partial; an empty chunk has
      // m = -inf, l = 0, ctx = 0 and weighs exp(-inf) = 0
      const float s_new = new_token<T, EPL>(krow, vrow, qv, cs, sn, kdst,
                                            vdst, scale);
      const float M = fmaxf(m, s_new);
      const float a = expf(m - M), e = expf(s_new - M);
      const float L = l * a + e;
      for (int x = tid; x < D; x += kThreads) {
        float c = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) c += red[g][x];
        const float v = fltorch::to_f32(fltorch::from_f32<T>(vrow[x]));
        o[x] = (c * a + e * v) / L;
      }
    } else {
      const float lt = fmaxf(l, 1e-30f);
      for (int x = tid; x < D; x += kThreads) {
        float c = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) c += red[g][x];
        o[x] = c / lt;
      }
    }
    return;
  }
  float* part = partial + (((size_t)b * H + h) * nsp + sp) * (D + 2);
  for (int x = tid; x < D; x += kThreads) {
    float c = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) c += red[g][x];
    part[2 + x] = c;
  }
  if (tid == 0) {
    part[0] = m;
    part[1] = l;
  }

  // The last of the act blocks of this (b, h) merges them in chunk order.
  const int ctr = b * H + h;
  if (!fltorch::last_of_split(counters, ctr, act, &is_last)) return;
  const float* pb = partial + ((size_t)b * H + h) * nsp * (D + 2);
  float s_new = 0.f;
  if constexpr (FUSED)
    s_new = new_token<T, EPL>(krow, vrow, qv, cs, sn, kdst, vdst, scale);
  for (int x = tid; x < D; x += kThreads) {
    float M, L, C;
    fltorch::merge_partials<D>(pb, act, x, M, L, C);
    if constexpr (FUSED) {                       // the new token, last
      const float mb = fmaxf(M, s_new);
      const float r = expf(M - mb), e = expf(s_new - mb);
      const float v = fltorch::to_f32(fltorch::from_f32<T>(vrow[x]));
      L = L * r + e;
      C = C * r + e * v;
      o[x] = C / L;
    } else {
      o[x] = C / fmaxf(L, 1e-30f);
    }
  }
  if (tid == 0) counters[ctr] = 0;
}

template <typename T, int EPL, bool FUSED>
int launch(const void* q, int q_bs, int q_hs, const void* kp, const void* vp,
           const void* lengths, const void* tables, NewToken nt, int B, int H,
           int P, int ps, int pp, size_t head_stride, int row_stride,
           int splits, int chunk, float scale, void* partial, void* counters,
           void* out, cudaStream_t stream) {
  const size_t smem = (size_t)2 * chunk * 16 * EPL * sizeof(T);
  if (smem + 8 * 1024 > 48 * 1024) {     // with the static shared memory
    cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<T, EPL, FUSED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(H, B, splits);
  paged_split_kernel<T, EPL, FUSED><<<grid, kThreads, smem, stream>>>(
      (const float*)q, q_bs, q_hs, (T*)kp, (T*)vp, (const int*)lengths,
      (const int*)tables, nt, P, ps, pp, head_stride, row_stride, chunk,
      scale, (float*)partial, (int*)counters, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T, bool FUSED>
int dispatch(const void* q, int q_bs, int q_hs, const void* kp,
             const void* vp, const void* lengths, const void* tables,
             NewToken nt, int B, int H, int P, int ps, int pp, int d,
             int flat, int splits, int chunk, float scale, void* partial,
             void* counters, void* out, cudaStream_t s) {
  const size_t head_stride = flat ? (size_t)d : (size_t)P * ps * d;
  const int row_stride = flat ? H * d : d;
#define FLTORCH_B6_CASE(EPL)                                                  \
  case 16 * EPL:                                                              \
    return launch<T, EPL, FUSED>(q, q_bs, q_hs, kp, vp, lengths, tables, nt,  \
                                 B, H, P, ps, pp, head_stride, row_stride,    \
                                 splits, chunk, scale, partial, counters,     \
                                 out, s);
  switch (d) {
    FLTORCH_B6_CASE(2) FLTORCH_B6_CASE(4) FLTORCH_B6_CASE(6)
    FLTORCH_B6_CASE(8) FLTORCH_B6_CASE(10) FLTORCH_B6_CASE(12)
    FLTORCH_B6_CASE(14) FLTORCH_B6_CASE(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLTORCH_B6_CASE
}

}  // namespace

// B6 (flat = 0): pools [H, P, ps, d]; B11 (flat = 1): pools [P, ps, H * d].
// q f32 [B, H, d] (already roped) with batch stride q_bs and head stride q_hs
// in elements (unit stride along d), pools of type bf16 (pool_bf16 = 1) or
// f32 with the current row written, lengths int32 [B], tables int32 [B, pp],
// out f32 [B, H, d]; d <= 256 and a multiple of 32. The caller cuts the
// pp * ps rows into `splits` chunks of `chunk` <= 256 rows (chunk a multiple
// of ps or a divisor of it, splits * chunk >= pp * ps) and passes partial
// f32 [B, H, splits, d + 2] scratch and counters int32 zeros [B * H] (left
// zeroed). FUSED (the fused step, head-major pools only) takes qkv in q and
// nt as above. Returns the CUDA error code of the launch.
template <bool FUSED>
static int paged_entry(const void* q, int q_bs, int q_hs, const void* kp,
                       const void* vp, const void* lengths,
                       const void* tables, NewToken nt, int B, int H, int P,
                       int ps, int pp, int d, int flat, int splits, int chunk,
                       float scale, int pool_bf16, void* partial,
                       void* counters, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk < 1 || chunk > kMaxChunk || (chunk % ps && ps % chunk) ||
      splits < 1 || splits > kMaxSplits || (long)splits * chunk < (long)pp * ps
      || d > kMaxD || d % 32)
    return (int)cudaErrorInvalidValue;
  if (pool_bf16)
    return dispatch<__nv_bfloat16, FUSED>(q, q_bs, q_hs, kp, vp, lengths,
                                          tables, nt, B, H, P, ps, pp, d,
                                          flat, splits, chunk, scale, partial,
                                          counters, out, s);
  return dispatch<float, FUSED>(q, q_bs, q_hs, kp, vp, lengths, tables, nt, B,
                                H, P, ps, pp, d, flat, splits, chunk, scale,
                                partial, counters, out, s);
}

extern "C" int paged_decode_attention(
    const void* q, int q_bs, int q_hs, const void* kp, const void* vp,
    const void* lengths, const void* tables, int B, int H, int P, int ps,
    int pp, int d, int splits, int chunk, float scale, int pool_bf16,
    void* partial, void* counters, void* out, void* stream) {
  return paged_entry<false>(q, q_bs, q_hs, kp, vp, lengths, tables,
                            NewToken{}, B, H, P, ps, pp, d, 0, splits, chunk,
                            scale, pool_bf16, partial, counters, out, stream);
}

extern "C" int paged_decode_attention_flat(
    const void* q, int q_bs, int q_hs, const void* kp, const void* vp,
    const void* lengths, const void* tables, int B, int H, int P, int ps,
    int pp, int d, int splits, int chunk, float scale, int pool_bf16,
    void* partial, void* counters, void* out, void* stream) {
  return paged_entry<false>(q, q_bs, q_hs, kp, vp, lengths, tables,
                            NewToken{}, B, H, P, ps, pp, d, 1, splits, chunk,
                            scale, pool_bf16, partial, counters, out, stream);
}

// The fused paged step. qkv f32 [B, 3 * H * d] (contiguous), pools [H, P,
// ps, d] updated in place, lengths int32 [B] (the resident rows, without
// the new token), tables, splits, chunk, partial and counters as for B6,
// page_ids and offsets int32 [B], cos and sin f32 [B, d], out f32 [B, H, d].
extern "C" int paged_decode_step_fused(
    const void* qkv, void* kp, void* vp, const void* lengths,
    const void* tables, const void* page_ids, const void* offsets,
    const void* cos_t, const void* sin_t, int B, int H, int P, int ps, int pp,
    int d, int splits, int chunk, float scale, int pool_bf16, void* partial,
    void* counters, void* out, void* stream) {
  const NewToken nt{(const int*)page_ids, (const int*)offsets,
                    (const float*)cos_t, (const float*)sin_t};
  return paged_entry<true>(qkv, 3 * H * d, d, kp, vp, lengths, tables, nt, B,
                           H, P, ps, pp, d, 0, splits, chunk, scale,
                           pool_bf16, partial, counters, out, stream);
}
