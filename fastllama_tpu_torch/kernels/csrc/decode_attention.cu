// Kernels B4 and B10: one decode step's attention for one layer over the
// slab caches [B, S, H * D].
//
// B4 (decode_attention_fused) replaces fastllama_tpu/kernels/
// decode_attention.py::decode_attention_fused (_fused_kernel_grouped): RoPE
// on q and the new k, the in-place K/V cache write, and attention. For each
// (sequence b, head h):
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
// Both run the split kernel of attn_split.cuh (its design and bound are
// there): a thread block cluster a (b, h) whose blocks divide the live rows
// on the device, one head's rows (2 D bytes every H D elements of the slab)
// by one bulk copy a row into an mbarrier ring, q (B4: and its RoPE lanes,
// k_new and v_new) ahead of them in the same stream, and the partials
// merged in the leader's shared memory. Where B4 differs from the unsplit
// function: each block rounds its own p = exp(score - block max) to T, not
// exp(score - max) (one bf16 rounding of each p moves, within 2^-7 of the
// largest output); l is the sum of the unrounded p; the new token is one
// more partial, folded in unrounded after the merge; a (b, h) with n_past 0
// gives v_new.

#include "attn_split.cuh"

namespace {

attn::Args slab_args(const void* q, const void* n_past, const void* cos_t,
                     const void* sin_t, int B, int S, int F, int d, int cs,
                     int tr, int stages, int per_max, int maps, float scale,
                     void* out, bool fused) {
  attn::Args a = {};
  a.q = (const float*)q;
  a.q_bs = fused ? 3LL * F : F;
  a.q_hs = d;
  a.lens = (const int*)n_past;
  a.cos_t = (const float*)cos_t;
  a.sin_t = (const float*)sin_t;
  a.out = (float*)out;
  a.head_stride = d;
  a.row_stride = F;
  a.H = F / d;
  a.P = B;
  a.ps = S;
  a.pp = 1;
  a.cs = cs;
  a.tr = tr;
  a.stages = stages;
  a.per_max = per_max;
  a.maps = maps;
  a.scale = scale;
  return a;
}

}  // namespace

// B10. q f32 [B, F] (already roped), caches [B, S, F] of type bf16
// (cache_bf16 = 1) or f32 with the current row written, n_past int32 [B]
// (>= 0), out f32 [B, F]; d <= 256 and a multiple of 32; F % d == 0. The
// plan (decode_attention.attn_plan): clusters of cs <= 8 blocks, tiles of
// tr rows, `stages` ring slots, per_max >= ceil(S / cs) (a multiple of 4)
// rows a block at most. Returns the CUDA error code of the launch.
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* n_past, int B, int S, int F,
                                int d, int cs, int tr, int stages,
                                int per_max, int maps, float scale,
                                int cache_bf16, void* out, void* stream) {
  if (d < 32 || F % d) return (int)cudaErrorInvalidValue;
  const attn::Args a = slab_args(q, n_past, nullptr, nullptr, B, S, F, d, cs,
                                 tr, stages, per_max, maps, scale, out, false);
  return attn::dispatch<attn::kB10>(const_cast<void*>(kc),   // read only
                                    const_cast<void*>(vc), a, B, d,
                                    cache_bf16, stream);
}

// B4. qkv f32 [B, 3F], caches [B, S, F] of type bf16 (cache_bf16 = 1) or f32,
// updated in place, n_past int32 [B], cos/sin f32 [B, d], out f32 [B, F];
// d and the plan as for B10.
// Returns the CUDA error code of the launch.
extern "C" int decode_attention_fused(const void* qkv, void* kc, void* vc,
                                      const void* n_past, const void* cos_t,
                                      const void* sin_t, int B, int S, int F,
                                      int d, int cs, int tr, int stages,
                                      int per_max, int maps, float scale,
                                      int cache_bf16, void* out,
                                      void* stream) {
  if (d < 32 || F % d) return (int)cudaErrorInvalidValue;
  const attn::Args a = slab_args(qkv, n_past, cos_t, sin_t, B, S, F, d, cs,
                                 tr, stages, per_max, maps, scale, out, true);
  return attn::dispatch<attn::kB4>(kc, vc, a, B, d, cache_bf16, stream);
}

// 1: launch as a programmatic dependent of the kernel before (the default);
// 0: as a plain stream successor (tools_torch/attn_sweep.py compares).
extern "C" void decode_attention_set_pdl(int on) { attn::g_pdl = on; }
