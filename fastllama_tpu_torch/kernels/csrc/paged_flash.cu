// Kernel B21: paged decode attention with the library kernel's function.
//
// Replaces fastllama_tpu/engine/paged_kv.py::paged_attention_tpu, which
// calls the library Pallas TPU kernel jax.experimental.pallas.ops.tpu.
// paged_attention (paged_flash_attention_kernel). The JAX engine takes it on
// a TPU where its own kernel's gate fails (fastllama_tpu/engine/
// scheduler.py:398-417): long contexts. For each sequence b and query head
// hq (KV head hk = hq / (Hq / Hkv)), with n = clip(lengths[b], 0, pp * ps)
// and key row s in page tables[b, s / ps] at in-page row s % ps of the
// pools [Hkv, P, ps, D]:
//   q is pre-scaled by 1 / sqrt(D) to f32 before the launch (the JAX
//     wrapper's q * (1 / np.sqrt(d)), which also turns a bf16 q into f32);
//   K and V are read as bf16: the library widens a page to f32 and casts
//     it to bf16 (_maybe_dequantize's default type), so f32 pools are
//     rounded to bf16 (exact for bf16 pools), and widened again for f32
//     dots;
//   the keys are taken in compute blocks of bk = ppcb * ps rows; block i
//     (i * bk < n) has qk_s = dot(q, K_s) over its live rows, m_cur = max
//     qk, s_s = exp(qk_s - m_cur), l_cur = sum s, o_cur = sum s_s V_s, and
//     the running (m, l, o) merge as the library's:
//       m_next = max(m, m_cur); alpha = exp(m - m_next);
//       beta = exp(m_cur - m_next); l_next = alpha l + beta l_cur;
//       o = (l alpha o + beta o_cur) / l_next
//     from m = -inf, l = 0, o = 0. A sequence of length 0 gives zeros, as
//     the library's inline-sequence kernel returns (it skips it).
// The library masks the rows of a block at or past n with -0.7 * FLT_MAX
// (their s is exactly 0); here they are not read at all, nor is any page
// past the last live row, so nothing stale can reach the output. f32 on the
// CUDA cores throughout (never TF32), expf as XLA's exp.
//
// Bound on the H100: bytes, the live K and V rows (2 * n * D elements a
// (b, hq)) over 3.35 TB/s; ~4 flops an element. Design (a first, simple
// one): one block of 256 threads a (hq, b), grid (Hq, B). Eight lanes take
// one key row (D / 8 elements a lane, 16-byte loads, a row's bytes
// contiguous across the group), 32 groups a block, two rows a group in
// flight; a row's dot is reduced by three shuffles. The compute block's
// scores sit in shared memory (bk floats): pass 1 writes them and the block
// max, pass 2 reads the V rows and accumulates s * V per group, the groups
// are summed by shuffles and the warps in order through shared memory, and
// thread t < D keeps o[t]. No host sync and nothing from the lengths on
// the host: the loop over compute blocks stops on the device at n, so the
// engine's step graph holds the launch.

#include "common.cuh"

namespace {

using fltorch::Vec16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / 8;          // rows a round
constexpr int kUnroll = 2;                     // rows a group in flight

// The sum over the 8 lanes of a group (every lane gets it).
__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// EPL consecutive pool elements at p, widened to f32 and rounded to bf16
// (the library's cast of a loaded page).
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* p, float* out) {
#pragma unroll
  for (int i = 0; i < EPL; i += Vec16<T>::kN) Vec16<T>::load(p + i, out + i);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) out[i] = fltorch::round_bf16(out[i]);
  }
}

// q f32 [B, Hq, D] pre-scaled and contiguous; kp, vp [Hkv, P, ps, D];
// lengths int32 [B]; tables int32 [B, pp]; out f32 [B, Hq, D]. Dynamic
// shared memory: bk + kWarps * D floats.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_flash_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ lengths,
                   const int* __restrict__ tables, int Hq, int Hkv, int P,
                   int ps, int pp, int bk, float* __restrict__ out) {
  constexpr int EPL = D / 8;
  extern __shared__ __align__(16) float fsmem[];
  float* scores = fsmem;                       // [bk]
  float* opart = fsmem + bk;                   // [kWarps][D]
  __shared__ float red[32];
  const int hq = blockIdx.x, b = blockIdx.y;
  const int hk = hq / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = threadIdx.x >> 3, lig = lane & 7;   // group, lane in it
  const int n = min(max(lengths[b], 0), pp * ps);
  const int* table = tables + (size_t)b * pp;
  const size_t head = (size_t)hk * P * ps * D;

  float qf[EPL];
  {
    const float* qr = q + ((size_t)b * Hq + hq) * D + lig * EPL;
#pragma unroll
    for (int i = 0; i < EPL; i += 4) Vec16<float>::load(qr + i, qf + i);
  }
  // the element offset of this lane's part of key row s
  auto row_at = [&](int s) -> size_t {
    const int page = min(max(table[s / ps], 0), P - 1);
    return head + ((size_t)page * ps + s % ps) * D + lig * EPL;
  };

  float m_run = -INFINITY, l_run = 0.f, o_acc = 0.f;
  for (int start = 0; start < n; start += bk) {
    const int rows = min(bk, n - start);
    // pass 1: the block's scores and their max
    float mx = -INFINITY;
    for (int r0 = 0; r0 < rows; r0 += kGroups * kUnroll) {
      float kv[kUnroll][EPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + gid + kGroups * u;
        if (r < rows) load_row<T, EPL>(kp + row_at(start + r), kv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // every lane of the warp shuffles, so a group past the rows sums
        // zeros and keeps nothing
        const int r = r0 + gid + kGroups * u;
        float s = 0.f;
        if (r < rows) {
#pragma unroll
          for (int i = 0; i < EPL; ++i) s = fmaf(qf[i], kv[u][i], s);
        }
        s = group8_sum(s);
        if (r < rows) {
          if (lig == 0) scores[r] = s;
          mx = fmaxf(mx, s);
        }
      }
    }
    const float m_cur = fltorch::block_max(mx, red);   // syncs the scores

    // pass 2: s = exp(qk - m_cur), its sum and s * V
    float o[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) o[i] = 0.f;
    float lsum = 0.f;
    for (int r0 = 0; r0 < rows; r0 += kGroups * kUnroll) {
      float kv[kUnroll][EPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + gid + kGroups * u;
        if (r < rows) load_row<T, EPL>(vp + row_at(start + r), kv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + gid + kGroups * u;
        if (r >= rows) continue;
        const float p = expf(scores[r] - m_cur);
        if (lig == 0) lsum += p;
#pragma unroll
        for (int i = 0; i < EPL; ++i) o[i] = fmaf(p, kv[u][i], o[i]);
      }
    }
    // the 4 groups of a warp (lanes lig, lig + 8, ...), then the warps in
    // order
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      o[i] += __shfl_xor_sync(0xffffffffu, o[i], 8);
      o[i] += __shfl_xor_sync(0xffffffffu, o[i], 16);
    }
    if (lane < 8) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) opart[warp * D + lig * EPL + i] = o[i];
    }
    const float l_cur = fltorch::block_sum(lsum, red);  // syncs opart
    const float m_next = fmaxf(m_run, m_cur);
    const float alpha = expf(m_run - m_next);
    const float beta = expf(m_cur - m_next);
    const float l_next = alpha * l_run + beta * l_cur;
    if (threadIdx.x < D) {
      float oc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) oc += opart[w * D + threadIdx.x];
      o_acc = (l_run * alpha * o_acc + beta * oc) / l_next;
    }
    m_run = m_next;
    l_run = l_next;
    __syncthreads();     // the scores and opart are rewritten next block
  }
  if (threadIdx.x < D)
    out[((size_t)b * Hq + hq) * D + threadIdx.x] = o_acc;
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* lengths,
           const void* tables, int B, int Hq, int Hkv, int P, int ps, int pp,
           int bk, void* out, cudaStream_t stream) {
  static int attr = 0;            // the largest dynamic size allowed so far
  const int smem = (bk + kWarps * D) * (int)sizeof(float);
  if (smem > 48 * 1024 && smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  paged_flash_kernel<T, D><<<dim3(Hq, B), kThreads, smem, stream>>>(
      (const float*)q, (const T*)kp, (const T*)vp, (const int*)lengths,
      (const int*)tables, Hq, Hkv, P, ps, pp, bk, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* kp, const void* vp,
             const void* lengths, const void* tables, int B, int Hq, int Hkv,
             int P, int ps, int pp, int D, int bk, void* out,
             cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(q, kp, vp, lengths, tables, B, Hq, Hkv, P,
                                  ps, pp, bk, out, s);
    case 128: return launch<T, 128>(q, kp, vp, lengths, tables, B, Hq, Hkv,
                                    P, ps, pp, bk, out, s);
    case 256: return launch<T, 256>(q, kp, vp, lengths, tables, B, Hq, Hkv,
                                    P, ps, pp, bk, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q f32 [B, Hq, D] (pre-scaled, contiguous, 16-byte aligned); kp, vp
// [Hkv, P, ps, D] bf16 (bf16 = 1) or f32, contiguous; lengths int32 [B];
// tables int32 [B, pp]; D 64, 128 or 256; Hq a multiple of Hkv; ppcb
// dividing pp, its ppcb * ps rows' scores within shared memory; out f32
// [B, Hq, D]. Returns the CUDA error code of the launch.
extern "C" int paged_attention_tpu(const void* q, const void* kp,
                                   const void* vp, const void* lengths,
                                   const void* tables, int B, int Hq,
                                   int Hkv, int P, int ps, int pp, int D,
                                   int ppcb, int bf16, void* out,
                                   void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || P < 1 || ps < 1 || ppcb < 1 ||
      pp % ppcb || (size_t)(ppcb * ps + kWarps * D) * 4 > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const int bk = ppcb * ps;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_d<__nv_bfloat16>(q, kp, vp, lengths, tables, B, Hq,
                                        Hkv, P, ps, pp, D, bk, out, s)
              : launch_d<float>(q, kp, vp, lengths, tables, B, Hq, Hkv, P,
                                ps, pp, D, bk, out, s);
}
