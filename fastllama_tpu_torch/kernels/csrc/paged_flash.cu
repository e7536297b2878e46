// Kernel B21: paged decode attention with the library kernel's function, and
// B21F: one decode step of one layer around it (RoPE, B7's write of the new
// row, the pre-scale and B21's attention over lengths + 1 keys).
//
// B21 replaces fastllama_tpu/engine/paged_kv.py::paged_attention_tpu, which
// calls the library Pallas TPU kernel jax.experimental.pallas.ops.tpu.
// paged_attention (paged_flash_attention_kernel). The JAX engine takes it on
// a TPU where its own kernel's gate fails (fastllama_tpu/engine/
// scheduler.py:398-417): long contexts. For each sequence b and query head
// hq (KV head hk = hq / (Hq / Hkv)), with n = clip(lengths[b], 0, pp * ps)
// and key row s in page tables[b, s / ps] (clipped into the pool) at
// in-page row s % ps of the pools [Hkv, P, ps, D]:
//   q is pre-scaled to f32, f32(q) * f32(1 / sqrt(D)) (the JAX wrapper's
//     q * (1 / np.sqrt(d)), which also turns a bf16 q into f32);
//   K and V are read as bf16: the library widens a page to f32 and casts
//     it to bf16 (_maybe_dequantize's default type), so f32 pools are
//     rounded to bf16 (exact for bf16 pools), and widened again for f32
//     dots;
//   ctx = sum_s exp(qk_s - m) V_s / sum_s exp(qk_s - m) over s < n, the
//     library's online softmax per compute block of ppcb pages; a sequence
//     of length 0 gives zeros, as the library's kernel returns (it skips
//     it). The compute block and every other grouping of the f32 sums move
//     rounding only, so ppcb is checked by the wrapper (the library's
//     ValueError) and does not reach this kernel.
// Rows at or past n are never used: the library masks them with
// -0.7 * FLT_MAX (their exp is exactly 0); here they are not copied, and a
// stale row of the shared ring is skipped by a select, never multiplied by
// 0, so NaN in a page past the length cannot reach the output. f32 on the
// CUDA cores throughout (never TF32), expf as XLA's exp.
//
// B21F (paged_attention_tpu_fused) replaces, for a layer without q/k/v LoRA
// terms on the engine's B21 route, the sequence RoPE (elementwise, the q/k
// concatenation) -> fastllama_tpu/kernels/kv_write.py::paged_kv_write (B7)
// -> the pre-scale -> B21, which is the JAX paged step's order
// (fastllama_tpu/models/llama.py:650-661): the new row is written, then
// lengths + 1 keys are attended. It takes the raw fused projection qkv
// [B, (Hq + 2 Hkv) D] and the per-row RoPE lanes cos/sin [B, D]:
//   * q and k are roped in B4's FMA form (common.cuh rope_lane), q scaled;
//   * the resident rows s < n are attended as B21 attends them;
//   * the new token (row lengths[b], attended when 0 <= lengths[b] <
//     pp * ps) is folded in from registers, rounded to the pool type and
//     then to bf16, which is exactly what B21 would read back from the
//     pool: s_new = dot(q_scaled, bf16(T(k_rope))), v_new = bf16(T(v));
//   * the block where a (b, KV head)'s segment starts writes T(k_rope) and
//     T(v) at (page_ids[b], offsets[b]) with B7's rules (the sentinel's
//     trash page; an id outside [0, P) or an offset outside [0, ps) writes
//     nothing). No block of the step reads that row: the copies take rows
//     < n only, and pages are not shared between sequences, so the
//     generic-proxy store needs no ordering against any bulk copy of the
//     launch, and any block may write it.
//
// Bound on the H100: bytes, the live K and V rows (2 * n * D pool elements a
// (b, KV head)) over 3.35 TB/s; ~4 flops an element (G query heads a KV
// head: 4 G). The design, against what held the first B21 back:
//   1. Split over the sequence, divided on the device. The grid is fixed
//      by the card (kBlocksPerSm blocks an SM), so the step
//      graph holds the launch. A segment is one (b, KV head, head group of
//      up to kHeads query heads); its units are its live pages (at least
//      one, so a segment of length 0 still produces its output). Every
//      block reads lengths, lays the segments end to end (a prefix over
//      the batch) and takes C = ceil(U / nb) consecutive units of the U in
//      all: ragged lengths still give every block the same number of pages.
//      A segment inside one block is finished there; a segment cut by block
//      edges leaves one partial (m, l, o) a piece, two slots a block (the
//      piece that continues a segment from the block before, and the piece
//      that starts one and runs on), and the last piece to arrive (a
//      counter per segment, reset by it) merges them in block order with
//      the library's formula: m' = max(m, m_i), l' = l e^(m - m') +
//      l_i e^(m_i - m'), o' likewise. One launch, deterministic.
//   2. One pass a page. Each consumer warp keeps its own running (m, l, o)
//      over its rows, so scores, the running max and rescale, and p V
//      follow each other with no barrier between K and V; the warps of a
//      head are merged once, where a segment's piece ends.
//   3. Pages staged whole by bulk copies. One producer thread looks each
//      page id up once and copies the page's live rows of K and of V (one
//      contiguous run each, [Hkv, P, ps, D]) with cp.async.bulk into a ring
//      of K+V stages (kRingBytes an SM, shared by its blocks: 3 stages of
//      16 KB tiles at bf16 D 128), each completing on an mbarrier; the consumer
//      warps release a stage on a second barrier, and every wait spins in
//      line. Pages wider than kTileBytes go in tiles of whole rows. Each
//      piece's header (its q rows, and B21F's k, v and RoPE lanes) comes
//      the same way, in stream order before its pages: a consumer's own
//      global load queued behind the SM's page copies (192 KB in flight)
//      stalled the ring for about a tile's time, and B21F, with three such
//      round trips a piece, took 15-20% longer than B21 at 8 x 4096 on
//      the H100.
//   4. One block a KV head and its G = Hq / Hkv query heads (up to kHeads;
//      more make head groups), so each K/V byte is read from memory once:
//      the warps split the query heads, then the rows.
// Half a warp takes one key row (D / 16 elements a lane, 16-byte shared
// loads for bf16 pools), its dot reduced by four shuffles; a warp scores
// kPairs row pairs, then rescales once. B21F ropes q and k from the
// header, scores the new token and writes its row when a piece starts;
// the piece's end only merges and folds.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using hopper::bulk_load;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int kWarps = 8;                      // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kBlocksPerSm = 2;                // the grid
constexpr int kRingBytes = 192 * 1024;         // an SM's rings, all blocks
constexpr int kMaxStages = 8;                  // K+V stages of the ring
constexpr int kHeads = kWarps;                 // query heads a segment
constexpr int kTileBytes = 16 * 1024;          // K (and V) bytes a stage
constexpr int kPairs = 4;                      // row pairs a rescale
constexpr int kSmemMax = 227 * 1024;
constexpr int kHdrSlots = 2;                   // pieces' headers in flight

// What B21F adds (null for B21).
struct NewToken {
  const int* page_ids;       // [B] write page of the new row
  const int* offsets;        // [B] its row in that page
  const float* cos_t;        // [B, D] RoPE lanes
  const float* sin_t;
};

// EPL pool elements of one lane from shared memory as the library reads
// them: widened, and f32 pools rounded to bf16.
template <typename T, int EPL>
__device__ __forceinline__ void read_row(const T* p, float* out) {
  fltorch::lane_row<T, EPL>(p, out);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) out[i] = fltorch::round_bf16(out[i]);
  }
}

// A value stored to the pool as T, read back as the library reads it.
template <typename T>
__device__ __forceinline__ float pool_read(float v) {
  return fltorch::round_bf16(fltorch::to_f32(fltorch::from_f32<T>(v)));
}

// Element i of rope(x) (x a row of D values, cs/sn its lanes): rope_lane's
// arithmetic for one element.
__device__ __forceinline__ float rope_at(const float* x, const float* cs,
                                         const float* sn, int i) {
  return __fmaf_rn(x[i], cs[i], __fmul_rn(x[i ^ 1], sn[i]));
}

// Wait for the phase of parity `parity` of barrier `bar`: the retry loop
// stays in line with the code that waits (hopper::mbar_wait's trapping
// form when built with -DFLTORCH_MBAR_TRAP).
__device__ __forceinline__ void wait_phase(uint32_t bar, int parity) {
#ifdef FLTORCH_MBAR_TRAP
  mbar_wait(bar, parity);
#else
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
#endif
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Where a block stands among the segments: sequence b, segment `seg` of it
// (hk * nhg + head group), unit j of nu (np of them hold a page), nres the
// resident rows attended.
struct Walk {
  int b, seg, j, nu, np, nres;
};

__device__ __forceinline__ void walk_seq(Walk& w, const int* lengths, int b,
                                         int ps, int rows_max) {
  w.b = b;
  w.nres = min(max(lengths[b], 0), rows_max);
  w.np = (w.nres + ps - 1) / ps;
  w.nu = max(w.np, 1);
}

// The walk at unit u: the last sequence whose first unit is <= u.
__device__ __forceinline__ Walk walk_at(int u, const int* cum,
                                        const int* lengths, int B, int ps,
                                        int rows_max) {
  int lo = 0, hi = B - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cum[mid] <= u) lo = mid; else hi = mid - 1;
  }
  Walk w;
  walk_seq(w, lengths, lo, ps, rows_max);
  const int rem = u - cum[lo];
  w.seg = rem / w.nu;
  w.j = rem - w.seg * w.nu;
  return w;
}

__device__ __forceinline__ void walk_next(Walk& w, const int* lengths,
                                          int nseg, int ps, int rows_max) {
  if (++w.j < w.nu) return;
  w.j = 0;
  if (++w.seg < nseg) return;
  w.seg = 0;
  walk_seq(w, lengths, w.b + 1, ps, rows_max);
}

// One warp's pass over the rows of a staged tile that are its own (pairs
// ri, ri + wp, ...; half the warp a row): scores, the running max and
// rescale, then p V, kPairs pairs at a time. Rows >= rows are stale and are
// skipped (a select), never weighted by 0.
template <typename T, int EPL>
__device__ __forceinline__ void attend_tile(const T* ks, const T* vs,
                                            int rows, int ri, int wp,
                                            const float* qv, float& m,
                                            float& l, float* o) {
  constexpr int D = 16 * EPL;
  const int half = (threadIdx.x >> 4) & 1, gl = threadIdx.x & 15;
  for (int p0 = ri; 2 * p0 < rows; p0 += kPairs * wp) {
    float s[kPairs];
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      const int r = 2 * (p0 + c * wp) + half;
      float acc = 0.f;
      if (r < rows) {
        float kv[EPL];
        read_row<T, EPL>(ks + (size_t)r * D + gl * EPL, kv);
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc = fmaf(qv[i], kv[i], acc);
      }
      acc = fltorch::group16_sum(acc);       // every lane of the warp
      s[c] = r < rows ? acc : -INFINITY;
    }
    float mc = s[0];
#pragma unroll
    for (int c = 1; c < kPairs; ++c) mc = fmaxf(mc, s[c]);
    // row 2 p0 is live, so the warp's max is finite
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 16));
    const float mn = fmaxf(m, mc);
    const float a = expf(m - mn);            // 0 while m = -inf
    l *= a;
#pragma unroll
    for (int i = 0; i < EPL; ++i) o[i] *= a;
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      const int r = 2 * (p0 + c * wp) + half;
      if (r < rows) {
        const float p = expf(s[c] - mn);
        l += p;
        float vv[EPL];
        read_row<T, EPL>(vs + (size_t)r * D + gl * EPL, vv);
#pragma unroll
        for (int i = 0; i < EPL; ++i) o[i] = fmaf(p, vv[i], o[i]);
      }
    }
    m = mn;
  }
}

// The weight e^(m_i - M) of a partial of max m_i in a merge of max M (0 for
// an empty partial, whose m_i is -inf).
__device__ __forceinline__ float weight(float mi, float M) {
  return mi == -INFINITY ? 0.f : expf(mi - M);
}

// Floats of a piece's header: q of up to kHeads query heads, and B21F's
// k, v, cos and sin rows.
__host__ __device__ constexpr int hdr_floats(int gmax, int D, bool fused) {
  return (gmax + (fused ? 4 : 0)) * D;
}

// q: B21 the f32 q [B, Hq, D] (batch stride q_bs), B21F the raw qkv [B,
// (Hq + 2 Hkv) D] (q_bs = (Hq + 2 Hkv) D), with nt's write location and
// RoPE lanes; head stride D, 16-byte aligned.
// partial: [gridDim.x][2][kHeads][D + 2] f32; counters: int32 zeros, one a
// segment (left zeroed). Dynamic shared memory: the ring of `stages` K+V
// stages, kHdrSlots headers, their barriers, the warps' states, the new
// token's scores and the prefix over the batch. A piece's header (its q,
// and B21F's k, v and lanes) comes by bulk copies in stream order with the
// pages, so no consumer waits on a global load behind the SM's queued page
// copies (each such round trip cost about a tile's time at 8 x 4096 on
// the H100).
template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(kThreads)
paged_flash_kernel(const float* __restrict__ q, long long q_bs,
                   T* __restrict__ kp, T* __restrict__ vp,
                   const int* __restrict__ lengths,
                   const int* __restrict__ tables, NewToken nt, int B,
                   int Hq, int Hkv, int P, int ps, int pp, int tr,
                   int stages, float scale, float* __restrict__ partial,
                   int* __restrict__ counters, float* __restrict__ out) {
  constexpr int EPL = D / 16;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tile = tr * D;                     // elements of a K or V tile
  const int G = Hq / Hkv, nhg = (G + kHeads - 1) / kHeads, nseg = Hkv * nhg;
  const int hdr = hdr_floats(min(G, kHeads), D, FUSED);
  T* ring = reinterpret_cast<T*>(smem);        // [stages][K, V][tile]
  float* hdrs = reinterpret_cast<float*>(      // [kHdrSlots][hdr]
      smem + (size_t)stages * 2 * tile * sizeof(T));
  uint64_t* bars = reinterpret_cast<uint64_t*>(hdrs + kHdrSlots * hdr);
  float* wst = reinterpret_cast<float*>(bars + 2 * (stages + kHdrSlots));
  float* snew = wst + kWarps * (D + 2);        // [kHeads]
  int* cum = reinterpret_cast<int*>(snew + kHeads);   // [B + 1]
  __shared__ int last_flag;
  const int rows_max = pp * ps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto full = [&](int st) { return smem_u32(bars + st); };
  auto empty = [&](int st) { return smem_u32(bars + stages + st); };
  auto hfull = [&](int hs) { return smem_u32(bars + 2 * stages + hs); };
  auto hempty = [&](int hs) {
    return smem_u32(bars + 2 * stages + kHdrSlots + hs);
  };

  // the units of each sequence laid end to end (warp 0); the barriers
  if (warp == 0) {
    int carry = 0;
    if (lane == 0) cum[0] = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      int v = 0;
      if (b < B) {
        const int n = min(max(lengths[b], 0), rows_max);
        v = max((n + ps - 1) / ps, 1) * nseg;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      if (b < B) cum[b + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  } else if (warp == kWarps && lane == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kWarps);
    }
    for (int hs = 0; hs < kHdrSlots; ++hs) {
      mbar_init(hfull(hs), 1);
      mbar_init(hempty(hs), kWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int U = cum[B];
  const int C = (U + (int)gridDim.x - 1) / (int)gridDim.x;
  const int u0 = (int)blockIdx.x * C;
  if (u0 >= U) return;
  const int u1 = min(u0 + C, U);

  if (warp == kWarps) {                        // the producer
    if (lane != 0) return;
    Walk w = walk_at(u0, cum, lengths, B, ps, rows_max);
    int it = 0, ih = 0;
    for (int u = u0; u < u1; ++u) {
      if (u > u0) walk_next(w, lengths, nseg, ps, rows_max);
      const int hk = w.seg / nhg;
      if (u == u0 || w.j == 0) {               // a piece's header
        const int hs = ih % kHdrSlots, hg = w.seg - hk * nhg;
        const int gb = min(kHeads, G - hg * kHeads);
        if (ih >= kHdrSlots)
          wait_phase(hempty(hs), ((ih / kHdrSlots) - 1) & 1);
        const int qb = (FUSED ? gb + 4 : gb) * D * (int)sizeof(float);
        mbar_expect_tx(hfull(hs), qb);
        float* hp = hdrs + hs * hdr;
        const float* row0 = q + (size_t)w.b * q_bs;
        const int h0 = hk * G + hg * kHeads;
        const int rb = D * (int)sizeof(float);
        bulk_load(smem_u32(hp), row0 + (size_t)h0 * D, gb * rb, hfull(hs));
        if constexpr (FUSED) {
          float* tail = hp + gb * D;           // k, v, cos, sin
          bulk_load(smem_u32(tail), row0 + (size_t)(Hq + hk) * D, rb,
                    hfull(hs));
          bulk_load(smem_u32(tail + D), row0 + (size_t)(Hq + Hkv + hk) * D,
                    rb, hfull(hs));
          bulk_load(smem_u32(tail + 2 * D), nt.cos_t + (size_t)w.b * D, rb,
                    hfull(hs));
          bulk_load(smem_u32(tail + 3 * D), nt.sin_t + (size_t)w.b * D, rb,
                    hfull(hs));
        }
        ++ih;
      }
      if (w.j >= w.np) continue;               // a segment of length 0
      const int page = min(max(tables[(size_t)w.b * pp + w.j], 0), P - 1);
      const int live = min(ps, w.nres - w.j * ps);
      const size_t base = ((size_t)hk * P + page) * ps * D;
      for (int r0 = 0; r0 < live; r0 += tr, ++it) {
        const int st = it % stages;
        if (it >= stages) wait_phase(empty(st), ((it / stages) - 1) & 1);
        const int bytes = min(tr, live - r0) * D * (int)sizeof(T);
        mbar_expect_tx(full(st), 2 * bytes);
        bulk_load(smem_u32(ring + (size_t)(2 * st) * tile),
                  kp + base + (size_t)r0 * D, bytes, full(st));
        bulk_load(smem_u32(ring + (size_t)(2 * st + 1) * tile),
                  vp + base + (size_t)r0 * D, bytes, full(st));
      }
    }
    return;
  }

  // the consumers
  const int tid = threadIdx.x, gl = lane & 15;
  Walk w = walk_at(u0, cum, lengths, B, ps, rows_max);
  int it = 0, ih = 0, wp = 1, ri = 0, gb = 1;
  bool active = false, starts_here = false;
  float qv[EPL], o[EPL], m = -INFINITY, l = 0.f;
  // B21F: the new token's score (each warp, for its head) and element tid
  // of its v, taken while the piece's pages arrive
  float s_new = 0.f, v_tid = 0.f;
  for (int u = u0; u < u1; ++u) {
    if (u > u0) walk_next(w, lengths, nseg, ps, rows_max);
    const int b = w.b, hk = w.seg / nhg, hg = w.seg - hk * nhg;
    if (u == u0 || w.j == 0) {                 // a segment's piece starts
      starts_here = w.j == 0;
      gb = min(kHeads, G - hg * kHeads);
      wp = kWarps / gb;
      active = warp < gb * wp;
      ri = warp % wp;
      m = -INFINITY;
      l = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) o[i] = 0.f;
      const int hs = ih % kHdrSlots;
      wait_phase(hfull(hs), (ih / kHdrSlots) & 1);
      const float* hp = hdrs + hs * hdr;       // q [gb][D], then B21F's
      const float* krow = hp + gb * D;         // k, v, cos and sin rows
      const float* vrow = krow + D;
      const float* cs = vrow + D;
      const float* sn = cs + D;
      if (active) {
        const float* qr = hp + (warp / wp) * D + gl * EPL;
#pragma unroll
        for (int i = 0; i < EPL; ++i) qv[i] = qr[i];
        if constexpr (FUSED) {
          float rq[EPL], kr[EPL];
          fltorch::rope_lane<EPL>(qv, cs + gl * EPL, sn + gl * EPL, rq);
          fltorch::rope_lane<EPL>(krow + gl * EPL, cs + gl * EPL,
                                  sn + gl * EPL, kr);
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < EPL; ++i) {
            qv[i] = rq[i];
            acc = fmaf(__fmul_rn(rq[i], scale), pool_read<T>(kr[i]), acc);
          }
          s_new = fltorch::group16_sum(acc);
        }
#pragma unroll
        for (int i = 0; i < EPL; ++i) qv[i] = __fmul_rn(qv[i], scale);
      }
      if constexpr (FUSED) {
        v_tid = vrow[tid % D];
        // the new row, written once a KV head by the block where its first
        // head group's segment starts (no block of the launch reads it)
        if (starts_here && hg == 0 && tid < D) {
          const int pid = nt.page_ids[b], off = nt.offsets[b];
          if (pid >= 0 && pid < P && off >= 0 && off < ps) {
            const size_t at = (((size_t)hk * P + pid) * ps + off) * D + tid;
            kp[at] = fltorch::from_f32<T>(rope_at(krow, cs, sn, tid));
            vp[at] = fltorch::from_f32<T>(v_tid);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(hempty(hs));
      ++ih;
    }
    if (w.j < w.np) {
      const int live = min(ps, w.nres - w.j * ps);
      for (int r0 = 0; r0 < live; r0 += tr, ++it) {
        const int st = it % stages;
        wait_phase(full(st), (it / stages) & 1);
        if (active)
          attend_tile<T, EPL>(ring + (size_t)(2 * st) * tile,
                              ring + (size_t)(2 * st + 1) * tile,
                              min(tr, live - r0), ri, wp, qv, m, l, o);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
    }
    if (u != u1 - 1 && w.j != w.nu - 1) continue;

    // The piece ends here: the warps' states (the two halves of a warp
    // summed), and B21F's new-token scores (the first warp of each head).
    l += __shfl_xor_sync(0xffffffffu, l, 16);
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      o[i] += __shfl_xor_sync(0xffffffffu, o[i], 16);
    float* ws = wst + warp * (D + 2);
    if (lane < 16) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) ws[2 + gl * EPL + i] = o[i];
    }
    if (lane == 0) {
      ws[0] = m;
      ws[1] = l;
      if (FUSED && active && ri == 0) snew[warp / wp] = s_new;
    }
    consumer_sync();
    const bool whole = starts_here && w.j == w.nu - 1;
    const int first = cum[b] + w.seg * w.nu;
    const int k0 = first / C, k1 = (first + w.nu - 1) / C;
    const int ctr = b * nseg + w.seg;
    // (M, L, O) of element (g, x) over this block's warps of head g
    auto own = [&](int g, int x, float& M, float& L, float& O) {
      const float* wg = wst + g * wp * (D + 2);
      M = -INFINITY;
      L = 0.f;
      O = 0.f;
      for (int v = 0; v < wp; ++v) M = fmaxf(M, wg[v * (D + 2)]);
      for (int v = 0; v < wp; ++v) {
        const float* wv = wg + v * (D + 2);
        const float a = weight(wv[0], M);
        L += wv[1] * a;
        O += wv[2 + x] * a;
      }
    };
    if (!whole) {
      // a cut segment: this piece's partial, then the last piece to arrive
      // merges the pieces in block order: block k0's starting piece (slot
      // 1), then the continuing pieces (slot 0) of blocks k0 + 1 .. k1
      float* slot = partial + ((size_t)blockIdx.x * 2 + (starts_here ? 1 : 0))
                    * kHeads * (D + 2);
      for (int e = tid; e < gb * D; e += kConsumers) {
        const int g = e / D, x = e - g * D;
        float M, L, O;
        own(g, x, M, L, O);
        float* sg = slot + g * (D + 2);
        if (x == 0) {
          sg[0] = M;
          sg[1] = L;
        }
        sg[2 + x] = O;
      }
      __threadfence();
      consumer_sync();
      if (tid == 0) last_flag = atomicAdd(&counters[ctr], 1) == k1 - k0;
      consumer_sync();
    }
    if (whole || last_flag) {
      if (!whole) __threadfence();
      const int ln = lengths[b];
      const bool fold = FUSED && ln >= 0 && ln < rows_max;
      for (int e = tid; e < gb * D; e += kConsumers) {
        const int g = e / D, x = e - g * D;
        float M, L, O;
        if (whole) {
          own(g, x, M, L, O);
        } else {
          M = -INFINITY;
          L = 0.f;
          O = 0.f;
          for (int k = k0; k <= k1; ++k) {
            const float* pc = partial + (((size_t)k * 2 + (k == k0 ? 1 : 0))
                                         * kHeads + g) * (D + 2);
            const float pm = __ldcg(pc), mb = fmaxf(M, pm);
            const float a = weight(M, mb), c = weight(pm, mb);
            L = L * a + __ldcg(pc + 1) * c;
            O = O * a + __ldcg(pc + 2 + x) * c;
            M = mb;
          }
        }
        float r = L > 0.f ? O / L : 0.f;
        if (fold) {                            // B21F's new token, last
          const float sg = snew[g], mb = fmaxf(M, sg);
          const float a = weight(M, mb), en = expf(sg - mb);
          const float vx = e == tid ? v_tid
                           : q[(size_t)b * q_bs + (size_t)(Hq + Hkv + hk) * D
                               + x];
          r = (O * a + en * pool_read<T>(vx)) / (L * a + en);
        }
        out[((size_t)b * Hq + hk * G + hg * kHeads + g) * D + x] = r;
      }
      if (!whole && tid == 0) counters[ctr] = 0;
    }
    consumer_sync();                  // wst, snew and last_flag are reused
  }
}

size_t smem_bytes(int tr, int D, int B, size_t elem, int stages, int gmax,
                  bool fused) {
  return (size_t)stages * 2 * tr * D * elem
         + (size_t)kHdrSlots * hdr_floats(gmax, D, fused) * sizeof(float)
         + 2 * (stages + kHdrSlots) * sizeof(uint64_t)
         + (size_t)(kWarps * (D + 2) + kHeads) * sizeof(float)
         + (size_t)(B + 1) * sizeof(int);
}

// Let the kernel take `smem` bytes of dynamic shared memory and as much of
// the SM's memory as shared memory as it can (room for two blocks an SM).
template <typename T, int D, bool FUSED>
cudaError_t allow_smem(int smem) {
  static int attr = 0;            // the largest dynamic size allowed so far
  if (smem <= attr) return cudaSuccess;
  auto kernel = paged_flash_kernel<T, D, FUSED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) attr = smem;
  return err;
}

template <typename T, int D, bool FUSED>
int launch(const void* q, long long q_bs, void* kp, void* vp,
           const void* lengths, const void* tables, NewToken nt, int B,
           int Hq, int Hkv, int P, int ps, int pp, int tr, float scale,
           int nb, int stages, void* partial, void* counters, void* out,
           cudaStream_t stream) {
  const int smem = (int)smem_bytes(tr, D, B, sizeof(T), stages,
                                  min(Hq / Hkv, kHeads), FUSED);
  const cudaError_t err = allow_smem<T, D, FUSED>(smem);
  if (err != cudaSuccess) return (int)err;
  paged_flash_kernel<T, D, FUSED><<<nb, kThreads, smem, stream>>>(
      (const float*)q, q_bs, (T*)kp, (T*)vp, (const int*)lengths,
      (const int*)tables, nt, B, Hq, Hkv, P, ps, pp, tr, stages, scale,
      (float*)partial, (int*)counters, (float*)out);
  return (int)cudaGetLastError();
}

// Stages of each block's ring: kRingBytes an SM shared by its kBlocksPerSm
// blocks, a stage K and V tiles of tr rows; 2 to kMaxStages.
int ring_stages(int tr, int D, size_t elem) {
  const size_t stage = (size_t)kBlocksPerSm * 2 * tr * D * elem;
  return max(2, min(kMaxStages, (int)(kRingBytes / stage)));
}

template <bool FUSED>
int entry(const void* q, long long q_bs, void* kp, void* vp,
          const void* lengths, const void* tables, NewToken nt, int B,
          int Hq, int Hkv, int P, int ps, int pp, int D, float scale,
          int bf16, int sms, void* partial, void* counters, void* out,
          void* stream) {
  const size_t elem = bf16 ? 2 : 4;
  if (B < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv || P < 1 || ps < 1 ||
      pp < 1 || sms < 1 || (D != 64 && D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  const int tr = min(ps, (int)(kTileBytes / (D * elem)));
  const int stages = ring_stages(tr, D, elem), nb = kBlocksPerSm * sms;
  if (smem_bytes(tr, D, B, elem, stages, min(Hq / Hkv, kHeads), FUSED) >
      (size_t)kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FLTORCH_B21_CASE(TT, DD)                                              \
  return launch<TT, DD, FUSED>(q, q_bs, kp, vp, lengths, tables, nt, B,       \
                               Hq, Hkv, P, ps, pp, tr, scale, nb, stages,     \
                               partial, counters, out, s);
  if (bf16) {
    switch (D) {
      case 64: FLTORCH_B21_CASE(__nv_bfloat16, 64)
      case 128: FLTORCH_B21_CASE(__nv_bfloat16, 128)
      default: FLTORCH_B21_CASE(__nv_bfloat16, 256)
    }
  }
  switch (D) {
    case 64: FLTORCH_B21_CASE(float, 64)
    case 128: FLTORCH_B21_CASE(float, 128)
    default: FLTORCH_B21_CASE(float, 256)
  }
#undef FLTORCH_B21_CASE
}

}  // namespace

// Scratch of B21 and B21F on a card of `sms` SMs: the f32 partials of the
// grid's blocks ([kBlocksPerSm sms, 2, kHeads, D + 2]) and the int32
// counters, one a segment (B Hkv ceil(Hq / Hkv / kHeads)).
extern "C" int paged_flash_partial_floats(int D, int sms) {
  return kBlocksPerSm * sms * 2 * kHeads * (D + 2);
}

extern "C" int paged_flash_counters(int B, int Hq, int Hkv) {
  return B * Hkv * ((Hq / Hkv + kHeads - 1) / kHeads);
}

// B21. q f32 [B, Hq, D] (batch stride q_bs in elements, a multiple of 4;
// head stride D; 16-byte aligned), not yet scaled; kp, vp [Hkv, P, ps, D]
// bf16 (bf16 = 1) or f32, contiguous; lengths int32 [B]; tables int32 [B,
// pp]; D 64, 128 or 256; Hq a multiple of Hkv; scale f32(1 / sqrt(D)); sms
// the card's SMs; partial and counters as paged_flash_partial_floats and
// paged_flash_counters size them (the counters zeroed, and left zeroed);
// out f32 [B, Hq, D]. Returns the CUDA error code of the launch.
extern "C" int paged_attention_tpu(const void* q, long long q_bs,
                                   const void* kp, const void* vp,
                                   const void* lengths, const void* tables,
                                   int B, int Hq, int Hkv, int P, int ps,
                                   int pp, int D, float scale, int bf16,
                                   int sms, void* partial, void* counters,
                                   void* out, void* stream) {
  return entry<false>(q, q_bs, (void*)kp, (void*)vp, lengths,
                      tables, NewToken{}, B, Hq, Hkv, P, ps, pp, D, scale,
                      bf16, sms, partial, counters, out, stream);
}

// B21F. qkv f32 [B, (Hq + 2 Hkv) D] contiguous (q heads, k heads, v heads);
// the pools as B21's, updated in place at (page_ids[b], offsets[b]) (int32
// [B]); lengths int32 [B] the resident rows (the new token's position);
// cos, sin f32 [B, D]; the rest as B21's.
extern "C" int paged_attention_tpu_fused(
    const void* qkv, void* kp, void* vp, const void* lengths,
    const void* tables, const void* page_ids, const void* offsets,
    const void* cos_t, const void* sin_t, int B, int Hq, int Hkv, int P,
    int ps, int pp, int D, float scale, int bf16, int sms, void* partial,
    void* counters, void* out, void* stream) {
  const NewToken nt{(const int*)page_ids, (const int*)offsets,
                    (const float*)cos_t, (const float*)sin_t};
  return entry<true>(qkv, (long long)(Hq + 2 * Hkv) * D, kp, vp, lengths,
                     tables, nt, B, Hq, Hkv, P, ps, pp, D, scale, bf16, sms,
                     partial, counters, out, stream);
}
