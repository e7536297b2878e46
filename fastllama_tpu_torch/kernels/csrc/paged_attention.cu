// Kernels B6 and B11: one decode step's attention for one layer over the
// paged KV pools, head-major (B6) or flat-lane (B11).
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

#include "common.cuh"

namespace {

using fltorch::cp_async16;
using fltorch::group16_sum;
using fltorch::lane_row;

constexpr int kThreads = 128;                    // 8 groups of 16 lanes
constexpr int kGroups = kThreads / 16, kMaxChunk = 256, kMaxD = 256;
constexpr int kMaxSplits = 12288;                // pp * ps <= 12288

template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q, int q_bs, int q_hs,
                   const T* __restrict__ kp, const T* __restrict__ vp,
                   const int* __restrict__ lengths,
                   const int* __restrict__ tables, int P, int ps, int pp,
                   size_t head_stride, int row_stride, int chunk, float scale,
                   float* __restrict__ partial, int* __restrict__ counters,
                   float* __restrict__ out) {
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
  const float* qrow = q + (size_t)b * q_bs + (size_t)h * q_hs + gl * EPL;
#pragma unroll
  for (int i = 0; i < EPL; ++i)
    qv[i] = fltorch::to_f32(fltorch::from_f32<T>(qrow[i]));
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
  if (act == 1) {                                // one chunk: no merge
    const float lt = fmaxf(l, 1e-30f);
    for (int e = tid; e < D; e += kThreads) {
      float c = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) c += red[g][e];
      o[e] = c / lt;
    }
    return;
  }
  float* part = partial + (((size_t)b * H + h) * nsp + sp) * (D + 2);
  for (int e = tid; e < D; e += kThreads) {
    float c = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) c += red[g][e];
    part[2 + e] = c;
  }
  if (tid == 0) {
    part[0] = m;
    part[1] = l;
  }

  // The last of the act blocks of this (b, h) merges them in chunk order.
  const int ctr = b * H + h;
  if (!fltorch::last_of_split(counters, ctr, act, &is_last)) return;
  const float* pb = partial + ((size_t)b * H + h) * nsp * (D + 2);
  for (int e = tid; e < D; e += kThreads) {
    float M, L, C;
    fltorch::merge_partials<D>(pb, act, e, M, L, C);
    o[e] = C / fmaxf(L, 1e-30f);
  }
  if (tid == 0) counters[ctr] = 0;
}

template <typename T, int EPL>
int launch(const void* q, int q_bs, int q_hs, const void* kp, const void* vp,
           const void* lengths, const void* tables, int B, int H, int P,
           int ps, int pp, size_t head_stride, int row_stride, int splits,
           int chunk, float scale, void* partial, void* counters, void* out,
           cudaStream_t stream) {
  const size_t smem = (size_t)2 * chunk * 16 * EPL * sizeof(T);
  if (smem + 8 * 1024 > 48 * 1024) {     // with the static shared memory
    cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<T, EPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(H, B, splits);
  paged_split_kernel<T, EPL><<<grid, kThreads, smem, stream>>>(
      (const float*)q, q_bs, q_hs, (const T*)kp, (const T*)vp,
      (const int*)lengths, (const int*)tables, P, ps, pp, head_stride,
      row_stride, chunk, scale, (float*)partial, (int*)counters, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, int q_bs, int q_hs, const void* kp,
             const void* vp, const void* lengths, const void* tables, int B,
             int H, int P, int ps, int pp, int d, int flat, int splits,
             int chunk, float scale, void* partial, void* counters, void* out,
             cudaStream_t s) {
  const size_t head_stride = flat ? (size_t)d : (size_t)P * ps * d;
  const int row_stride = flat ? H * d : d;
#define FLTORCH_B6_CASE(EPL)                                                  \
  case 16 * EPL:                                                              \
    return launch<T, EPL>(q, q_bs, q_hs, kp, vp, lengths, tables, B, H, P,    \
                          ps, pp, head_stride, row_stride, splits, chunk,     \
                          scale, partial, counters, out, s);
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
// zeroed). Returns the CUDA error code of the launch.
static int paged_entry(const void* q, int q_bs, int q_hs, const void* kp,
                       const void* vp, const void* lengths,
                       const void* tables, int B, int H, int P, int ps,
                       int pp, int d, int flat, int splits, int chunk,
                       float scale, int pool_bf16, void* partial,
                       void* counters, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk < 1 || chunk > kMaxChunk || (chunk % ps && ps % chunk) ||
      splits < 1 || splits > kMaxSplits || (long)splits * chunk < (long)pp * ps
      || d > kMaxD || d % 32)
    return (int)cudaErrorInvalidValue;
  if (pool_bf16)
    return dispatch<__nv_bfloat16>(q, q_bs, q_hs, kp, vp, lengths, tables, B,
                                   H, P, ps, pp, d, flat, splits, chunk, scale,
                                   partial, counters, out, s);
  return dispatch<float>(q, q_bs, q_hs, kp, vp, lengths, tables, B, H, P, ps,
                         pp, d, flat, splits, chunk, scale, partial, counters,
                         out, s);
}

extern "C" int paged_decode_attention(
    const void* q, int q_bs, int q_hs, const void* kp, const void* vp,
    const void* lengths, const void* tables, int B, int H, int P, int ps,
    int pp, int d, int splits, int chunk, float scale, int pool_bf16,
    void* partial, void* counters, void* out, void* stream) {
  return paged_entry(q, q_bs, q_hs, kp, vp, lengths, tables, B, H, P, ps, pp,
                     d, 0, splits, chunk, scale, pool_bf16, partial, counters,
                     out, stream);
}

extern "C" int paged_decode_attention_flat(
    const void* q, int q_bs, int q_hs, const void* kp, const void* vp,
    const void* lengths, const void* tables, int B, int H, int P, int ps,
    int pp, int d, int splits, int chunk, float scale, int pool_bf16,
    void* partial, void* counters, void* out, void* stream) {
  return paged_entry(q, q_bs, q_hs, kp, vp, lengths, tables, B, H, P, ps, pp,
                     d, 1, splits, chunk, scale, pool_bf16, partial, counters,
                     out, stream);
}
