// The split decode-attention kernel of B4, B10 (decode_attention.cu), B6,
// B11 and the fused paged step (paged_attention.cu): one decode step's
// attention for one layer, one query row a (sequence b, head h), over key
// rows that live in a slab cache or in page pools.
//
// Where key row s of (b, h) lives, for the three layouts:
//   slab  [B, S, H * D]       page b, row s                     (B4, B10)
//   pools [H, P, ps, D]       page tables[b, s / ps], row s % ps (B6, fused)
//   flat  [P, ps, H * D]      the same pages, heads side by side (B11)
// all as kp + h * head_stride + (page * ps + row) * row_stride; the slab is
// a pool of B pages of S rows whose table is the identity. Page ids are
// clipped into the pool.
//
// Bound on the H100: bytes. A step reads each live K and V row once (2 n D
// elements a (b, h)) and does ~4 flops an element; at the engine's and the
// decode token's sizes (1 x 300 rows: 5 MB; 8 x 300: 39 MB) the floor is a
// launch plus one memory round trip at B = 1, and streaming without gaps
// at B = 8. The design:
//   1. A thread block cluster a (b, h). The grid is (cs H, B) in clusters
//      of cs blocks (cs from the shapes: attn_plan in decode_attention.py,
//      about two blocks an SM in one wave: 8 at B = 1, 1 at B = 8 with 32
//      heads), and the cluster divides the n live rows on the device: rank
//      r takes rows [r per, min((r + 1) per, n)), per = ceil(n / cs). No
//      block is launched for rows past the length at a larger S: the rows,
//      not the cache, are divided. A rank past the rows does nothing but
//      take part in the cluster barrier at the start. Launched as a
//      programmatic dependent, so its launch and set-up overlap the kernel
//      before.
//   2. K and V by bulk copies completing on mbarriers. One producer warp
//      puts the header in flight before it reads the length (q, and the
//      fused modes' RoPE lanes, k and v: in the same stream, ahead of the
//      rows), then K tiles and V tiles of tr rows through a ring of
//      `stages` slots, each slot a full barrier (one arrival plus the
//      bytes) and an empty barrier (the four consumer warps). A page run
//      of rows that are contiguous in memory (the head-major pools) is one
//      cp.async.bulk; rows at a stride (the slab and the flat pools: one
//      head's 2D-byte row every H D elements) go in 8-row boxes of a 2-D
//      tensor map over the [rows, H D] view (encoded once a cache or pool,
//      host side) and single-row bulk copies for a run's last rows, so no
//      row past the length is read. K and V take separate slots, so the
//      scores start while V lands.
//   3. The scores of the block's rows in shared memory, their max m over
//      the block's rows, p = exp(score - m), l = sum p (unrounded), ctx =
//      sum p' V with p' = T(p) where the function casts p to the cache type
//      (B4, B6, B11, fused) and p' = p for B10. Half a warp takes a row
//      (D / 16 elements a lane, its dot reduced by shuffles), two rows at
//      once, so four warps score 16 rows at a time.
//   4. The split merged inside the cluster. Every rank with rows sends its
//      partial (ctx[D], m, l) into slot r of the leader's (rank 0) shared
//      memory by st.async from registers, completing on the leader's merge
//      barrier, and leaves; the leader expects the bytes of the ranks with
//      rows (known from the length) and merges the slots in rank order
//      (M = max m_r; L = sum l_r e^(m_r - M); C likewise): no global
//      scratch, no atomic counter, no __threadfence, and no cluster-wide
//      barrier at the end (one at the start orders the barrier's set-up
//      before any remote store). One launch, deterministic, and graph-safe
//      (nothing of the lengths reaches the host).
// The fused modes' new token is one more partial, folded in by the leader
// after the merge:
//   B4:    s_new = dot(rope(q), rope(k)) * scale and v, unrounded; the
//          leader writes T(rope(k)) and T(v) at row min(n_past, S - 1)
//          after every rank's partial has come, so after every copy of the
//          step has landed: the row is written after every read of the
//          step, also at n_past >= S, where row S - 1 is attended.
//   fused: s_new = dot(T(rope(q)), T(rope(k))) * scale and T(v), the row
//          B6 would read back; written by the leader at (page_ids[b],
//          offsets[b]) with B7's rules (the sentinel's trash page; an id
//          outside [0, P) or an offset outside [0, ps) writes nothing). No
//          block of the step reads that row: the ranks cover rows <
//          lengths[b], and no page is shared between sequences.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

// Everything here has internal linkage: a template's function-local static
// (the shared-memory attribute set so far, the tensor-map cache) would
// otherwise be one object across every library built from this header.
namespace attn {
namespace {

using hopper::bulk_load;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

// The four functions: B10 (slab, f32 throughout, rows <= n_past), B4
// (slab, fused, rows < n_past), B6 and B11 (pools, rows < lengths) and the
// fused paged step (pools, fused, rows < lengths).
enum Mode { kB10 = 0, kB4 = 1, kPaged = 2, kPagedFused = 3 };

// The consumer warps and the rows a group scores at once; the two macros
// (and FLTORCH_ATTN_NO_ROW, which drops the fused modes' row write) exist
// for tools_torch/attn_sweep.py's builds.
#ifndef FLTORCH_ATTN_WARPS
#define FLTORCH_ATTN_WARPS 4
#endif
#ifndef FLTORCH_ATTN_ROWS
#define FLTORCH_ATTN_ROWS 2
#endif
constexpr int kCWarps = FLTORCH_ATTN_WARPS;
constexpr int kConsumers = 32 * kCWarps;  // half a warp a group
constexpr int kGroups = kConsumers / 16;
constexpr int kRowsAtOnce = FLTORCH_ATTN_ROWS;
constexpr int kThreads = kConsumers + 32; // and one producer warp
constexpr int kMaxCluster = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxD = 256;
constexpr int kSmemMax = 227 * 1024;
constexpr int kBoxRows = 8;               // rows of a tensor map's box

struct Args {
  const float* q;            // row (b, h) at q + b q_bs + h q_hs; the fused
  long long q_bs, q_hs;      // modes' raw qkv: k at + H D, v at + 2 H D
  const int* lens;           // [B] n_past (B4, B10) or lengths
  const int* tables;         // [B, pp] page ids; null: the slab
  const int* page_ids;       // fused step: [B] write location
  const int* offsets;
  const float* cos_t;        // fused modes: [B, D] RoPE lanes
  const float* sin_t;
  float* out;                // [B, H, D]
  long long head_stride, row_stride;      // elements
  int H, P, ps, pp;          // slab: P = B, ps = S, pp = 1
  int cs, tr, stages, per_max;            // the plan
  int maps;                  // strided rows: 8-row boxes of km / vm
  float scale;
};

// Bytes of dynamic shared memory: the ring (128-byte aligned), the header
// (q, cos, sin, k, v rows, f32), the scores, the cluster's partial slots,
// the group sums and the barriers.
__host__ __device__ inline size_t smem_bytes(const Args& a, int D,
                                             int elem) {
  return 128 + (size_t)a.stages * a.tr * D * elem + 5 * D * 4
         + (size_t)a.per_max * 4 + (size_t)a.cs * (D + 4) * 4
         + kCWarps * D * 4 + (2 * a.stages + 2) * 8;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

constexpr int kPageIds = 64;              // table entries staged a block

// Page j of sequence b: from the block's staged entries (`pgs`, the first
// kPageIds of its table row, read while the length is) or the table,
// clipped into the pool; the slab's own row b.
__device__ __forceinline__ int page_of(const Args& a, const int* pgs, int b,
                                       int j) {
  if (!a.tables) return b;
  const int id =
      j < kPageIds ? pgs[j] : __ldg(a.tables + (size_t)b * a.pp + j);
  return min(max(id, 0), a.P - 1);
}

// Rows [s, s + rc) of (b, h) from `pool` into `dst`, completing on `bar`,
// issued by the 32 lanes of the producer warp. Rows contiguous in memory
// (row_stride == D: a page of the head-major pools) go as one copy a page
// run, a lane a page. Rows at a stride go, with `maps`, in boxes of
// kBoxRows rows of the [rows, H D] view `map` (one tensor copy each) and
// single rows for the rest of each page run, so no row past the run is
// read, the lanes sharing a run's copies; without, one bulk copy a row, a
// lane a row.
template <typename T, int D>
__device__ __forceinline__ void copy_rows(T* dst, const T* pool,
                                          const CUtensorMap* map,
                                          const Args& a, const int* pgs,
                                          int b, int h, int s, int rc,
                                          int lane, uint32_t bar) {
  const T* hb = pool + (size_t)h * a.head_stride;
  const int p0 = s / a.ps, p1 = (s + rc - 1) / a.ps;
  constexpr int kRowBytes = D * (int)sizeof(T);
  if (a.row_stride == D) {
    for (int j = p0 + lane; j <= p1; j += 32) {
      const int lo = max(s, j * a.ps), hi = min(s + rc, (j + 1) * a.ps);
      bulk_load(smem_u32(dst + (size_t)(lo - s) * D),
                hb + ((size_t)page_of(a, pgs, b, j) * a.ps + (lo - j * a.ps))
                     * D,
                (hi - lo) * kRowBytes, bar);
    }
  } else if (a.maps) {
    for (int j = p0; j <= p1; ++j) {        // the page runs, warp-uniform
      const int lo = max(s, j * a.ps), hi = min(s + rc, (j + 1) * a.ps);
      const int nb = (hi - lo) / kBoxRows;
      const int row0 = page_of(a, pgs, b, j) * a.ps + (lo - j * a.ps);
      for (int u = lane; u < hi - lo - nb * (kBoxRows - 1); u += 32) {
        // unit u: box u, or single row nb kBoxRows + (u - nb) of the run
        const int r = u < nb ? u * kBoxRows : nb * (kBoxRows - 1) + u;
        if (u < nb)
          hopper::tma_load_2d(smem_u32(dst + (size_t)(lo - s + r) * D), map,
                              bar, h * D, row0 + r);
        else
          bulk_load(smem_u32(dst + (size_t)(lo - s + r) * D),
                    hb + (size_t)(row0 + r) * a.row_stride, kRowBytes, bar);
      }
    }
  } else {
    for (int i = lane; i < rc; i += 32) {
      const int r = s + i, j = r / a.ps;
      bulk_load(smem_u32(dst + (size_t)i * D),
                hb + ((size_t)page_of(a, pgs, b, j) * a.ps + (r - j * a.ps))
                     * a.row_stride,
                kRowBytes, bar);
    }
  }
}

template <typename T, int EPL, int MODE>
__global__ void __launch_bounds__(kThreads)
attn_split_kernel(T* __restrict__ kp, T* __restrict__ vp, const Args a,
                  const __grid_constant__ CUtensorMap km,
                  const __grid_constant__ CUtensorMap vm) {
  constexpr int D = 16 * EPL;
  constexpr bool FUSED = MODE == kB4 || MODE == kPagedFused;
  constexpr bool ROUND = MODE != kB10;      // T(q) and T(p)
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float red_m[kCWarps], red_l[kCWarps];
  __shared__ int pgs[kPageIds];
  const int cs = a.cs;
  const int rank = cs > 1 ? (int)hopper::cluster_rank() : 0;
  const int h = blockIdx.x / cs, b = blockIdx.y;
  const size_t tile = (size_t)a.tr * D;     // elements of a slot
  uint8_t* base = smem + ((128 - (smem_u32(smem) & 127)) & 127);
  T* ring = reinterpret_cast<T*>(base);
  float* hdr = reinterpret_cast<float*>(base + a.stages * tile * sizeof(T));
  float* sc = hdr + 5 * D;                  // [per_max]
  // the leader's partial slots: [cs][ctx D | m, l, 0, 0]
  float* part = sc + a.per_max;
  float* red = part + cs * (D + 4);         // [kCWarps][D]
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + kCWarps * D);
  const uint32_t hbar = smem_u32(bars + 2 * a.stages);
  const uint32_t mbar = smem_u32(bars + 2 * a.stages + 1);   // the merge
  auto full = [&](int st) { return smem_u32(bars + st); };
  auto empty = [&](int st) { return smem_u32(bars + a.stages + st); };

  const bool leader = rank == 0;
  const bool kv_hdr = FUSED && leader;                  // k, v rows too
  // launched as a programmatic dependent: the next kernel may launch once
  // every block has started, and nothing a kernel before wrote is read
  // before griddepcontrol.wait
  if (threadIdx.x == 0)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (threadIdx.x == kConsumers) {
    for (int st = 0; st < a.stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kCWarps);
    }
    mbar_init(hbar, 1);
    mbar_init(mbar, 1);
    hopper::mbar_init_fence();
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (threadIdx.x == kConsumers) {
    // the header, which needs no length: q (fused: its RoPE lanes, and the
    // leader's k and v) ahead of the rows in the copy stream
    const float* qrow = a.q + (size_t)b * a.q_bs + (size_t)h * a.q_hs;
    const size_t F = (size_t)a.H * D;
    const int rb = D * 4;
    mbar_expect_tx(hbar, (1 + (FUSED ? 2 : 0) + (kv_hdr ? 2 : 0)) * rb);
    bulk_load(smem_u32(hdr), qrow, rb, hbar);
    if constexpr (FUSED) {
      bulk_load(smem_u32(hdr + D), a.cos_t + (size_t)b * D, rb, hbar);
      bulk_load(smem_u32(hdr + 2 * D), a.sin_t + (size_t)b * D, rb, hbar);
      if (kv_hdr) {
        bulk_load(smem_u32(hdr + 3 * D), qrow + F, rb, hbar);
        bulk_load(smem_u32(hdr + 4 * D), qrow + 2 * F, rb, hbar);
      }
    }
    if (a.maps) {
      hopper::prefetch_map(&km);
      hopper::prefetch_map(&vm);
    }
  }
  // the first page ids of the table row (read beside the length, so the
  // first copies wait for one round trip, not two)
  if (a.tables && threadIdx.x >= kConsumers) {
    for (int j = threadIdx.x - kConsumers; j < min(a.pp, kPageIds); j += 32)
      pgs[j] = __ldg(a.tables + (size_t)b * a.pp + j);
  }
  // the rows of the (b, h), and this rank's share of them
  const int len = max(a.lens[b], 0);
  const int n = MODE == kB10 ? min(len + 1, a.ps)
                : MODE == kB4 ? min(len, a.ps) : min(len, a.pp * a.ps);
  const int per = (n + cs - 1) / cs;
  const int act = per > 0 ? (n + per - 1) / per : 0;    // ranks with rows
  const int s0 = rank * per;
  const int cnt = rank < act ? min(per, n - s0) : 0;
  const int nt = (cnt + a.tr - 1) / a.tr;               // K (and V) tiles
  __syncthreads();
  // every block of the cluster has started, and the leader's merge barrier
  // exists, before any store into the leader (waited for just before)
  if (cs > 1) hopper::cluster_arrive();

  float acc[EPL], m = -INFINITY, l = 0.f;
  float qr[EPL];                            // q in f32 (fused: roped)
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;

  if (threadIdx.x >= kConsumers) {          // the producer warp
    const int lane = threadIdx.x & 31;
    for (int t = 0; t < 2 * nt; ++t) {      // K tiles, then V tiles
      const int st = t % a.stages;
      if (t >= a.stages) mbar_wait(empty(st), ((t / a.stages) - 1) & 1);
      const bool isv = t >= nt;
      const int r0 = (isv ? t - nt : t) * a.tr, rc = min(a.tr, cnt - r0);
      if (lane == 0)
        mbar_expect_tx(full(st), rc * D * (int)sizeof(T));
      __syncwarp();
      copy_rows<T, D>(ring + st * tile, isv ? vp : kp, isv ? &vm : &km, a,
                      pgs, b, h, s0 + r0, rc, lane, full(st));
    }
    __syncwarp();
  } else {                                  // the consumer warps
    const int tid = threadIdx.x, grp = tid >> 4, gl = tid & 15;
    const int warp = tid >> 5, lane = tid & 31;
    float qv[EPL];                          // what the scores take
    mbar_wait(hbar, 0);                     // (before any exit: a copy lands)
    {
#pragma unroll
      for (int i = 0; i < EPL; ++i) qr[i] = hdr[gl * EPL + i];
      if constexpr (FUSED) {
        float x[EPL];
#pragma unroll
        for (int i = 0; i < EPL; ++i) x[i] = qr[i];
        fltorch::rope_lane<EPL>(x, hdr + D + gl * EPL, hdr + 2 * D + gl * EPL,
                                qr);
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        qv[i] = ROUND ? fltorch::to_f32(fltorch::from_f32<T>(qr[i])) : qr[i];
    }
    if (cnt > 0) {
      // scores: group g takes rows g + kGroups j (j < kRowsAtOnce) of a
      // tile at once, their shuffle reductions interleaved; the trip
      // counts are the same for every lane of the block, so the shuffles
      // are uniform
      for (int t = 0; t < nt; ++t) {
        const int st = t % a.stages;
        mbar_wait(full(st), (t / a.stages) & 1);
        const T* ks = ring + st * tile;
        const int r0 = t * a.tr, rc = min(a.tr, cnt - r0);
        for (int r1 = 0; r1 < rc; r1 += kGroups * kRowsAtOnce) {
          float d[kRowsAtOnce];
#pragma unroll
          for (int j = 0; j < kRowsAtOnce; ++j) {
            const int r = r1 + j * kGroups + grp;
            d[j] = 0.f;
            if (r < rc) {
              float kv[EPL];
              fltorch::lane_row<T, EPL>(ks + (size_t)r * D + gl * EPL, kv);
#pragma unroll
              for (int i = 0; i < EPL; ++i) d[j] += qv[i] * kv[i];
            }
          }
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
            for (int j = 0; j < kRowsAtOnce; ++j)
              d[j] += __shfl_xor_sync(0xffffffffu, d[j], o);
          }
#pragma unroll
          for (int j = 0; j < kRowsAtOnce; ++j) {
            const int r = r1 + j * kGroups + grp;
            if (r < rc && gl == 0) sc[r0 + r] = d[j] * a.scale;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
      consumer_sync();
      float mx = -INFINITY;
      for (int r = tid; r < cnt; r += kConsumers) mx = fmaxf(mx, sc[r]);
      mx = fltorch::warp_max(mx);
      if (lane == 0) red_m[warp] = mx;
      consumer_sync();
      m = red_m[0];
#pragma unroll
      for (int w = 1; w < kCWarps; ++w) m = fmaxf(m, red_m[w]);
      float ls = 0.f;
      for (int r = tid; r < cnt; r += kConsumers) {
        const float p = expf(sc[r] - m);
        sc[r] = ROUND ? fltorch::to_f32(fltorch::from_f32<T>(p)) : p;
        ls += p;
      }
      ls = fltorch::warp_sum(ls);
      if (lane == 0) red_l[warp] = ls;
      consumer_sync();                      // also: every p is in sc
      l = 0.f;
#pragma unroll
      for (int w = 0; w < kCWarps; ++w) l += red_l[w];
      for (int t = nt; t < 2 * nt; ++t) {
        const int st = t % a.stages;
        mbar_wait(full(st), (t / a.stages) & 1);
        const T* vs = ring + st * tile;
        const int r0 = (t - nt) * a.tr, rc = min(a.tr, cnt - r0);
#pragma unroll 4
        for (int r = grp; r < rc; r += kGroups) {
          const float p = sc[r0 + r];
          float vv[EPL];
          fltorch::lane_row<T, EPL>(vs + (size_t)r * D + gl * EPL, vv);
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[i] += p * vv[i];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
      // the two groups of a warp, then the warps
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
      if (lane < 16) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) red[warp * D + gl * EPL + i] = acc[i];
      }
      consumer_sync();
    }
  }

  // the leader's new token (the fused modes): its score, while the other
  // ranks finish
  float s_new = 0.f;
  const float* krow = hdr + 3 * D;
  const float* vrow = hdr + 4 * D;
  if (FUSED && leader && threadIdx.x < kConsumers) {
    const int gl = threadIdx.x & 15;
    float kr[EPL];
    fltorch::rope_lane<EPL>(krow + gl * EPL, hdr + D + gl * EPL,
                            hdr + 2 * D + gl * EPL, kr);
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      if constexpr (MODE == kB4)
        d += qr[i] * kr[i];
      else
        d += fltorch::to_f32(fltorch::from_f32<T>(qr[i]))
             * fltorch::to_f32(fltorch::from_f32<T>(kr[i]));
    }
    s_new = fltorch::group16_sum(d) * a.scale;
  }

  // This rank's partial into slot `rank` of the leader: the leader's own
  // by plain stores; another rank's by st.async from registers, 16 bytes
  // a thread, completing on the leader's merge barrier, after which it
  // leaves. The leader expects the bytes of the act - 1 other ranks with
  // rows; ranks without rows send nothing.
  if (cs > 1) hopper::cluster_wait();
  if (threadIdx.x >= kConsumers) return;
  constexpr int kSlot = D + 4;
  if (cnt > 0) {
    const int tid = threadIdx.x;
    float* slot = part + rank * kSlot;
    for (int x = 4 * tid; x < kSlot; x += 4 * kConsumers) {
      float4 v = make_float4(m, l, 0.f, 0.f);
      if (x < D) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int w = 0; w < kCWarps; ++w) {
#pragma unroll
          for (int e = 0; e < 4; ++e) c[e] += red[w * D + x + e];
        }
        v = make_float4(c[0], c[1], c[2], c[3]);
      }
      if (leader)
        *reinterpret_cast<float4*>(slot + x) = v;
      else
        hopper::st_async_v4(hopper::mapa(smem_u32(slot + x), 0), v,
                            hopper::mapa(mbar, 0));
    }
  }
  if (!leader) return;
  if (threadIdx.x == 0)
    mbar_expect_tx(mbar, max(act - 1, 0) * kSlot * 4);
  consumer_sync();                          // the leader's own slot
  if (cs > 1) hopper::mbar_wait_cluster(mbar, 0);

  // the leader: the slots in rank order, then the new token
  const int tid = threadIdx.x;
  float* o = a.out + ((size_t)b * a.H + h) * D;
  for (int x = tid; x < D; x += kConsumers) {
    float M = -INFINITY;
    for (int r = 0; r < act; ++r) M = fmaxf(M, part[r * kSlot + D]);
    float L = 0.f, C = 0.f;
    for (int r = 0; r < act; ++r) {
      const float* pr = part + r * kSlot;
      const float w = expf(pr[D] - M);
      L += pr[D + 1] * w;
      C += pr[x] * w;
    }
    if constexpr (FUSED) {                  // the new token, last
      const float v = MODE == kB4
                          ? vrow[x]
                          : fltorch::to_f32(fltorch::from_f32<T>(vrow[x]));
      const float mb = fmaxf(M, s_new);
      const float r = expf(M - mb), e = expf(s_new - mb);   // r 0 if no rows
      o[x] = (C * r + e * v) / (L * r + e);
    } else if constexpr (MODE == kB10) {
      o[x] = C / L;
    } else {
      o[x] = C / fmaxf(L, 1e-30f);          // length 0: zeros
    }
  }
#ifndef FLTORCH_ATTN_NO_ROW   // an ablation for tools_torch/attn_sweep.py
  if constexpr (FUSED) {                    // the new row, after every read
    size_t w = 0;
    bool ok = true;
    if constexpr (MODE == kB4) {
      w = ((size_t)b * a.ps + min(len, a.ps - 1)) * a.row_stride;
    } else {
      const int pid = a.page_ids[b], off = a.offsets[b];
      ok = pid >= 0 && pid < a.P && off >= 0 && off < a.ps;
      w = ((size_t)pid * a.ps + off) * a.row_stride;
    }
    if (ok) {
      const size_t at = (size_t)h * a.head_stride + w;
      const float* cs_ = hdr + D;
      const float* sn_ = hdr + 2 * D;
      for (int x = tid; x < D; x += kConsumers) {
        kp[at + x] = fltorch::from_f32<T>(__fmaf_rn(
            krow[x], cs_[x], __fmul_rn(krow[x ^ 1], sn_[x])));
        vp[at + x] = fltorch::from_f32<T>(vrow[x]);
      }
    }
  }
#endif
}

// The [P ps, H D] view of a slab cache or flat pool as a tensor map in boxes
// of D x kBoxRows, encoded once for each (address, shape, type) and kept:
// the caches and pools outlive many launches (a decode step's 32 layers
// hold 64), and the encoding costs microseconds of host time.
inline bool pool_map(CUtensorMap* out, const void* ptr, int bf16,
                     long long rows, long long cols, int d) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    long long rows, cols;
    int d, bf16;
  };
  constexpr int kSlots = 512;
  static Entry cache[kSlots] = {};
  Entry& e = cache[((uintptr_t)ptr >> 8) % kSlots];
  if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.d == d &&
      e.bf16 == bf16) {
    *out = e.map;
    return true;
  }
  if (!hopper::make_map(&e.map, ptr,
                        bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        bf16 ? 2 : 4, (int)rows, (int)cols, d, kBoxRows,
                        CU_TENSOR_MAP_SWIZZLE_NONE)) {
    e.ptr = nullptr;
    return false;
  }
  e.ptr = ptr;
  e.rows = rows;
  e.cols = cols;
  e.d = d;
  e.bf16 = bf16;
  *out = e.map;
  return true;
}

// Whether the kernel is launched as a programmatic dependent of the kernel
// before it (its launch and set-up overlap that kernel's end); the
// entries' *_set_pdl turns it off for a comparison.
int g_pdl = 1;

// Launch on `stream`: the grid (cs H, B), in clusters of cs blocks where
// cs > 1. Returns the CUDA error code.
template <typename T, int EPL, int MODE>
int launch(T* kp, T* vp, const Args& a, const CUtensorMap& km,
           const CUtensorMap& vm, int B, cudaStream_t stream) {
  constexpr int D = 16 * EPL;
  auto kernel = attn_split_kernel<T, EPL, MODE>;
  const size_t smem = smem_bytes(a, D, (int)sizeof(T));
  static size_t allowed = 48 * 1024;        // the largest size set so far
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cs * a.H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int na = 0;
  if (g_pdl) {
    attr[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[na++].val.programmaticStreamSerializationAllowed = 1;
  }
  if (a.cs > 1) {
    attr[na].id = cudaLaunchAttributeClusterDimension;
    attr[na].val.clusterDim.x = a.cs;
    attr[na].val.clusterDim.y = 1;
    attr[na++].val.clusterDim.z = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = na;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, kp, vp, a, km, vm);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The checks every entry makes of the plan and the widths, the tensor maps
// where the rows are taken in boxes, then the launch for the element type
// and head width.
template <int MODE>
int dispatch(void* kp, void* vp, Args a, int B, int d, int bf16,
             void* stream) {
  const int elem = bf16 ? 2 : 4;
  a.maps = a.maps && a.row_stride != d;     // contiguous rows need none
  const long long rows = (long long)a.pp * a.ps;
  if (B < 1 || a.H < 1 || d < 32 || d > kMaxD || d % 32 || a.cs < 1 ||
      a.cs > kMaxCluster || a.tr < 1 || a.stages < 1 ||
      a.stages > kMaxStages || a.per_max % 4 ||
      (long long)a.per_max * a.cs < rows || a.P < 1 || a.ps < 1 ||
      smem_bytes(a, d, elem) > (size_t)kSmemMax ||
      (a.maps && (d * elem) % 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap km = {}, vm = {};
  if (a.maps) {
    const long long view = (long long)a.P * a.ps;
    if (!pool_map(&km, kp, bf16, view, a.row_stride, d) ||
        !pool_map(&vm, vp, bf16, view, a.row_stride, d))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
#define FLTORCH_ATTN_CASE(EPL)                                                \
  case 16 * EPL:                                                              \
    return bf16 ? launch<__nv_bfloat16, EPL, MODE>(                           \
                      (__nv_bfloat16*)kp, (__nv_bfloat16*)vp, a, km, vm, B,   \
                      s)                                                      \
                : launch<float, EPL, MODE>((float*)kp, (float*)vp, a, km, vm, \
                                           B, s);
  switch (d) {
    FLTORCH_ATTN_CASE(2) FLTORCH_ATTN_CASE(4) FLTORCH_ATTN_CASE(6)
    FLTORCH_ATTN_CASE(8) FLTORCH_ATTN_CASE(10) FLTORCH_ATTN_CASE(12)
    FLTORCH_ATTN_CASE(14) FLTORCH_ATTN_CASE(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLTORCH_ATTN_CASE
}

}  // namespace
}  // namespace attn
