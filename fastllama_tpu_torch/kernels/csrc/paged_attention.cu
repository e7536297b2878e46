// Kernels B6 and B11: one decode step's attention for one layer over the
// paged KV pools, head-major (B6) or flat-lane (B11); and B6 with the fused
// step's extras, the fused paged decode step that takes in B7's write.
//
// B6 replaces fastllama_tpu/kernels/paged_attention.py::
// paged_decode_attention (_paged_attn_db_kernel and its single-bank
// fallback). For each (sequence b, head h), with n = clip(lengths[b], 0,
// pp * ps) and key row s living in page tables[b, s / ps] at in-page row
// s % ps of the pools [H, P, ps, D]:
//   scores_s = dot(T(q), K[h, page(s), s % ps]) * scale       s < n
//   m = max scores; p_s = exp(scores_s - m); l = max(sum p, 1e-30)
//   ctx = dot(T(p), V[h, page(s), s % ps]) / l
// where T is the pool type (bf16 or f32): q and p are cast to it for the two
// dots, as the TPU kernel does, with f32 scores, softmax and accumulation.
// n = 0 gives ctx = 0. No row at or past the length and no page past
// ceil(n / ps) is ever read (table entries past it are read, the first 64
// of a row beside the length, but never used): nothing stale can reach the
// output (the TPU kernel copies whole pages into a VMEM window and must
// zero it once against 0 * NaN). Page ids are clipped into the pool.
// The row the step wrote just before (kv_write.cu) is read back from the
// pool, rounded to T: the paged rule, not B4's unrounded fold.
//
// B11 (paged_decode_attention_flat) replaces paged_decode_attention_flat
// (_paged_attn_flat_kernel) of the same file: B6's contract over flat-lane
// pools [P, ps, H * D], where the heads of one row sit side by side as in
// the slab cache. No dispatch of the JAX package reaches it (the round-5
// layout experiment). Only where a key row lives differs:
//   B6:  kp[((h * P + page) * ps + r) * D]      head stride P*ps*D, row D
//   B11: kp[(page * ps + r) * H * D + h * D]    head stride D, row H*D
// so both run the same kernel on the same plan with the two strides as
// arguments, and B11 on flat pools equals B6 on the head-major transpose
// bit for bit.
//
// The fused paged step (paged_decode_step_fused) replaces, for a layer
// without q/k/v LoRA terms, the sequence RoPE (elementwise) ->
// fastllama_tpu/kernels/kv_write.py::paged_kv_write (B7, one launch) -> B6,
// the JAX paged step's order: the new row is written, then lengths + 1 keys
// are attended. It takes the raw fused projection qkv [B, 3F] (F = H * D)
// and the per-row RoPE lanes cos/sin [B, D]; the lengths[b] resident rows
// are attended as B6 attends them, and the new token is one more partial,
// folded in rounded to T (s_new = dot(T(q), T(k_rope)) * scale, T(v)), as
// B6 would read it back; only its own p stays unrounded. The leader writes
// T(k_rope) and T(v) with B7's rules.
//
// All three run the split kernel of attn_split.cuh (its design and bound are
// there): a thread block cluster a (b, h) whose blocks divide the live rows
// on the device, a page's rows of one head ([H, P, ps, D]: one contiguous
// run) by one cp.async.bulk (B11's flat rows, 2 D bytes every H D elements,
// by one bulk copy a row) into an mbarrier ring, q (and the fused step's
// lanes, k and v) ahead of them in the same stream, and the partials merged
// in the leader's shared memory. Each block rounds its own p against its
// own max (one bf16 rounding of each p moves, within 2^-7 of the largest
// output); l is the sum of the unrounded p.

#include "attn_split.cuh"

namespace {

attn::Args pool_args(const void* q, long long q_bs, long long q_hs,
                     const void* lengths, const void* tables, int H, int P,
                     int ps, int pp, int d, int flat, int cs, int tr,
                     int stages, int per_max, int maps, float scale,
                     void* out) {
  attn::Args a = {};
  a.q = (const float*)q;
  a.q_bs = q_bs;
  a.q_hs = q_hs;
  a.lens = (const int*)lengths;
  a.tables = (const int*)tables;
  a.out = (float*)out;
  a.head_stride = flat ? (long long)d : (long long)P * ps * d;
  a.row_stride = flat ? (long long)H * d : d;
  a.H = H;
  a.P = P;
  a.ps = ps;
  a.pp = pp;
  a.cs = cs;
  a.tr = tr;
  a.stages = stages;
  a.per_max = per_max;
  a.maps = maps;
  a.scale = scale;
  return a;
}

}  // namespace

// B6 (paged_decode_attention): pools [H, P, ps, d]; B11
// (paged_decode_attention_flat): pools [P, ps, H * d]. q f32 [B, H, d]
// (already roped) with batch stride q_bs and head stride q_hs in elements
// (multiples of 4, the base 16-byte aligned; unit stride along d), pools of
// type bf16 (pool_bf16 = 1) or f32 with the current row written, lengths
// int32 [B], tables int32 [B, pp], out f32 [B, H, d]; d <= 256 and a
// multiple of 32. The plan (decode_attention.attn_plan) as for B10, with
// per_max >= ceil(pp * ps / cs). Returns the CUDA error code of the launch.
extern "C" int paged_decode_attention(
    const void* q, int q_bs, int q_hs, const void* kp, const void* vp,
    const void* lengths, const void* tables, int B, int H, int P, int ps,
    int pp, int d, int cs, int tr, int stages, int per_max, int maps,
    float scale, int pool_bf16, void* out, void* stream) {
  const attn::Args a = pool_args(q, q_bs, q_hs, lengths, tables, H, P, ps,
                                 pp, d, 0, cs, tr, stages, per_max, maps,
                                 scale, out);
  return attn::dispatch<attn::kPaged>(const_cast<void*>(kp),   // read only
                                      const_cast<void*>(vp), a, B, d,
                                      pool_bf16, stream);
}

extern "C" int paged_decode_attention_flat(
    const void* q, int q_bs, int q_hs, const void* kp, const void* vp,
    const void* lengths, const void* tables, int B, int H, int P, int ps,
    int pp, int d, int cs, int tr, int stages, int per_max, int maps,
    float scale, int pool_bf16, void* out, void* stream) {
  const attn::Args a = pool_args(q, q_bs, q_hs, lengths, tables, H, P, ps,
                                 pp, d, 1, cs, tr, stages, per_max, maps,
                                 scale, out);
  return attn::dispatch<attn::kPaged>(const_cast<void*>(kp),
                                      const_cast<void*>(vp), a, B, d,
                                      pool_bf16, stream);
}

// The fused paged step. qkv f32 [B, 3 * H * d] (contiguous), pools [H, P,
// ps, d] updated in place, lengths int32 [B] (the resident rows, without
// the new token), tables and the plan as for B6, page_ids and offsets int32
// [B], cos and sin f32 [B, d], out f32 [B, H, d].
extern "C" int paged_decode_step_fused(
    const void* qkv, void* kp, void* vp, const void* lengths,
    const void* tables, const void* page_ids, const void* offsets,
    const void* cos_t, const void* sin_t, int B, int H, int P, int ps, int pp,
    int d, int cs, int tr, int stages, int per_max, int maps, float scale,
    int pool_bf16, void* out, void* stream) {
  attn::Args a = pool_args(qkv, 3LL * H * d, d, lengths, tables, H, P, ps,
                           pp, d, 0, cs, tr, stages, per_max, maps, scale,
                           out);
  a.page_ids = (const int*)page_ids;
  a.offsets = (const int*)offsets;
  a.cos_t = (const float*)cos_t;
  a.sin_t = (const float*)sin_t;
  return attn::dispatch<attn::kPagedFused>(kp, vp, a, B, d, pool_bf16,
                                           stream);
}

// 1: launch as a programmatic dependent of the kernel before (the default);
// 0: as a plain stream successor (tools_torch/attn_sweep.py compares).
extern "C" void paged_attention_set_pdl(int on) { attn::g_pdl = on; }
