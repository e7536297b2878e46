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
// n = 0 gives ctx = 0. Both loops stop at n, so no row at or past the
// length, no page past ceil(n / ps) and no unset table entry is ever read:
// nothing stale can reach the output, and the kernel has no scratch window
// to sanitize (the TPU kernel copies whole pages into a VMEM window and
// must zero it once against 0 * NaN). Page ids are clipped into the pool.
//
// Bound on the H100: bytes. The step reads 2 * n * D pool elements per
// (b, h) once and does ~4 flops per element. One 256-thread block per
// (b, h): 256 blocks at 7B widths with 8 slots. Scores: each thread takes
// whole key rows (s = tid, tid + 256, ...) and reads a row's D values as
// independent 16-byte loads; a row is contiguous within its page, and the
// page id comes from a copy of the sequence's table in shared memory. PV:
// each warp takes every eighth row, its lanes read the row contiguously, and
// the 8 warps' partial contexts are added through shared memory. The TPU
// kernel's head groups, scratch banks and double-buffered page gather have
// no counterpart: blocks run in parallel and read the pools directly.
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

using fltorch::Vec16;

constexpr int kThreads = 256, kWarps = kThreads / 32, kMaxD = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ lengths,
                  const int* __restrict__ tables, int H, int P, int ps,
                  int pp, int d, size_t head_stride, int row_stride,
                  float scale, float* __restrict__ out) {
  extern __shared__ float smem[];                // scores [pp * ps], pages [pp]
  float* scores = smem;
  int* pages = reinterpret_cast<int*>(smem + (size_t)pp * ps);
  __shared__ float q_s[kMaxD];
  __shared__ float ctx_s[kWarps][kMaxD];
  __shared__ float red[32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(max(lengths[b], 0), pp * ps);
  const int n_pages = (n + ps - 1) / ps;
  for (int j = tid; j < n_pages; j += kThreads)
    pages[j] = min(max(tables[(size_t)b * pp + j], 0), P - 1);
  const size_t q_off = ((size_t)b * H + h) * d;
  for (int l = tid; l < d; l += kThreads)
    q_s[l] = fltorch::to_f32(fltorch::from_f32<T>(q[q_off + l]));
  __syncthreads();

  const size_t head_base = (size_t)h * head_stride;
  constexpr int VN = Vec16<T>::kN;
  for (int s = tid; s < n; s += kThreads) {
    const T* row =
        kp + head_base + ((size_t)pages[s / ps] * ps + (s % ps)) * row_stride;
    float acc = 0.f;
#pragma unroll 4
    for (int l = 0; l < d; l += VN) {
      float v[VN];
      Vec16<T>::load(row + l, v);
#pragma unroll
      for (int i = 0; i < VN; ++i) acc += q_s[l + i] * v[i];
    }
    scores[s] = acc * scale;
  }
  // each thread reads back the scores it wrote itself
  float mx = -INFINITY;
  for (int s = tid; s < n; s += kThreads) mx = fmaxf(mx, scores[s]);
  const float m = fltorch::block_max(mx, red);                   // syncs
  float lsum = 0.f;
  for (int s = tid; s < n; s += kThreads) {
    const float p = expf(scores[s] - m);
    scores[s] = p;
    lsum += p;
  }
  const float l_tot = fmaxf(fltorch::block_sum(lsum, red), 1e-30f);  // syncs

  const int per_lane = d / 32;                   // d <= 256: at most 8
  float acc[kMaxD / 32];
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int s = warp; s < n; s += kWarps) {
    const float p = fltorch::to_f32(fltorch::from_f32<T>(scores[s]));
    const T* row = vp + head_base +
                   ((size_t)pages[s / ps] * ps + (s % ps)) * row_stride +
                   lane * per_lane;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i)
      if (i < per_lane) acc[i] += p * fltorch::to_f32(row[i]);
  }
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i)
    if (i < per_lane) ctx_s[warp][lane * per_lane + i] = acc[i];
  __syncthreads();
  for (int l = tid; l < d; l += kThreads) {
    float c = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += ctx_s[w][l];
    out[q_off + l] = c / l_tot;
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* lengths,
           const void* tables, int B, int H, int P, int ps, int pp, int d,
           int flat, float scale, void* out, cudaStream_t stream) {
  dim3 grid(H, B);
  const size_t smem = ((size_t)pp * ps + pp) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const T*)kp, (const T*)vp, (const int*)lengths,
      (const int*)tables, H, P, ps, pp, d,
      flat ? (size_t)d : (size_t)P * ps * d, flat ? H * d : d, scale,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// B6 (flat = 0): pools [H, P, ps, d]; B11 (flat = 1): pools [P, ps, H * d].
// q f32 [B, H, d] (already roped), pools of type bf16 (pool_bf16 = 1) or f32
// with the current row written, lengths int32 [B], tables int32 [B, pp], out
// f32 [B, H, d]; d <= 256 and a multiple of 32.
// Returns the CUDA error code of the launch.
static int paged_entry(const void* q, const void* kp, const void* vp,
                       const void* lengths, const void* tables, int B, int H,
                       int P, int ps, int pp, int d, int flat, float scale,
                       int pool_bf16, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (pool_bf16)
    return launch<__nv_bfloat16>(q, kp, vp, lengths, tables, B, H, P, ps, pp,
                                 d, flat, scale, out, s);
  return launch<float>(q, kp, vp, lengths, tables, B, H, P, ps, pp, d, flat,
                       scale, out, s);
}

extern "C" int paged_decode_attention(const void* q, const void* kp,
                                      const void* vp, const void* lengths,
                                      const void* tables, int B, int H, int P,
                                      int ps, int pp, int d, float scale,
                                      int pool_bf16, void* out, void* stream) {
  return paged_entry(q, kp, vp, lengths, tables, B, H, P, ps, pp, d, 0, scale,
                     pool_bf16, out, stream);
}

extern "C" int paged_decode_attention_flat(const void* q, const void* kp,
                                           const void* vp,
                                           const void* lengths,
                                           const void* tables, int B, int H,
                                           int P, int ps, int pp, int d,
                                           float scale, int pool_bf16,
                                           void* out, void* stream) {
  return paged_entry(q, kp, vp, lengths, tables, B, H, P, ps, pp, d, 1, scale,
                     pool_bf16, out, stream);
}
