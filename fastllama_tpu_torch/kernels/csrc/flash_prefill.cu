// Kernel B12: causal flash attention over a fresh prompt window.
//
// Replaces fastllama_tpu/models/llama.py:288 _flash_prefill_attention, which
// calls the library Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention (causal,
// sm_scale = 1/sqrt(Dh), blocks of min(T, 512) rows). For each (b, h) and
// query row i of the window (n_past == 0, so the window's own K/V is the
// whole context):
//   s_ij = dot(bf16(q_i), bf16(k_j)) * scale   f32, keys j <= i
//   ctx_i = sum_j bf16(exp(s_ij - m_i)) bf16(v_j) / sum_j exp(s_ij - m_i)
// with an online softmax over key tiles (m the running max, l the running
// sum of the unrounded p), p rounded to bf16 for the PV product as the
// library's p.astype(v.dtype) does, and the output rounded to bf16 once
// (the library's o_tile_ref.dtype). The result is stored as f32.
//
// Bound on the H100: at 7B (32 heads, Dh 128) and T = 512 the window does
// 4 * 32 * 128 * 131,328 causal pairs = 2.15 GFLOP (2.2 us at 989 TFLOP/s)
// and moves 33.6 MB when q, k and v arrive in f32 (the forward's roped
// projection) with an f32 output (10.0 us at 3.35 TB/s): bytes. From
// T ~ 2048 on the operations come close to the bytes.
//
// Design (FlashAttention-2 shape on mma.sync; no wgmma or TMA yet): one
// block of 4 warps per (64-row query tile, h, b), the heaviest tiles (last
// rows: most keys) launched first. The block stages its 64 x 128 q tile in
// shared memory as bf16 and each warp keeps its 16 rows as mma A fragments
// (32 registers) for the whole loop. It then walks the key tiles 0 .. its
// own (tiles above the diagonal are skipped; only the diagonal tile is
// masked): each 64 x 128 K and V tile is read through its strides in f32,
// rounded to bf16 and stored in shared memory with rows padded by 16
// bytes (ldmatrix rows on distinct banks). S = Q K^T is 8 x 8
// mma.sync.m16n8k16 a warp (K fragments by ldmatrix), the softmax runs on
// the accumulators in registers (a row is spread over a quad of lanes:
// two shuffles), P is repacked from the S accumulators into A fragments as
// bf16 without leaving registers, and O += P V is 4 x 16 mma.sync (V
// fragments by ldmatrix.trans). O is rescaled by exp(m_old - m_new) per
// tile and divided by l at the end. The scores never touch device memory.
// K and V are staged through registers (the f32 operands are rounded on the
// way), without double buffering: only the other block an SM holds (255
// registers a thread) runs while one waits on its loads. A later pass would
// take wgmma with TMA-fed bf16 operands and a producer warp.
#include "common.cuh"

namespace {

constexpr int kD = 128;           // head dim
constexpr int kTile = 64;         // query rows per block, key rows per tile
constexpr int kThreads = 128;     // 4 warps, 16 query rows each
constexpr int kLd = kD + 8;       // bf16 elements per shared row (+16 bytes)

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Two f32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 128 f32 tile (rows g + r * rs) into shared memory as bf16
// [64][kLd]: a warp reads one 512-byte row at a time.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* sm, const float* g,
                                           long long rs) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float4 r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = threadIdx.x + kThreads * (half * 8 + j);
      r[j] = *reinterpret_cast<const float4*>(g + (idx >> 5) * rs +
                                              (idx & 31) * 4);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = threadIdx.x + kThreads * (half * 8 + j);
      uint2 w = make_uint2(pack_bf16(r[j].x, r[j].y),
                           pack_bf16(r[j].z, r[j].w));
      *reinterpret_cast<uint2*>(sm + (idx >> 5) * kLd + (idx & 31) * 4) = w;
    }
  }
}

struct Strides {
  long long b, t, h;   // elements
};

__global__ void __launch_bounds__(kThreads, 2)
flash_prefill_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, Strides qs, Strides ks,
                     Strides vs, int T_len, int H, float scale,
                     float* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 sK[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile * kLd];

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;     // heaviest tiles first
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;         // fragment row, column pair

  // the warp's 16 query rows as A fragments: 8 k-steps of 16 over Dh
  stage_tile(sK, q + b * qs.b + h * qs.h + q0 * qs.t, qs.t);
  __syncthreads();
  uint32_t qf[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    ldmatrix_x4(qf[kk], sK + (warp * 16 + (lane & 15)) * kLd + kk * 16 +
                            (lane >> 4) * 8);
  __syncthreads();

  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;               // this lane's part of the row sums

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  for (int kt = 0; kt <= qt; ++kt) {
    stage_tile(sK, kb + kt * kTile * ks.t, ks.t);
    stage_tile(sV, vb + kt * kTile * vs.t, vs.t);
    __syncthreads();

    // S = Q K^T: the warp's 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {      // 32 columns of Dh a load
        uint32_t bk[4];
        ldmatrix_x4(bk, sK + (n * 8 + (lane & 7)) * kLd + kk * 32 +
                            (lane >> 3) * 8);
        mma_bf16(s[n], qf[2 * kk], bk[0], bk[1]);
        mma_bf16(s[n], qf[2 * kk + 1], bk[2], bk[3]);
      }
    }

    // scale, mask the diagonal tile, online softmax on the accumulators
    const bool diag = kt == qt;
    const int r0 = warp * 16 + g;           // tile rows of s[.][0..1], +8
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * c + (e & 1);
        const int row = r0 + (e >> 1) * 8;
        float x = s[n][e] * scale;
        if (diag && col > row) x = -INFINITY;
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every row sees its own key in the diagonal tile and all keys before
    // it, so the new max is finite; the first tile's alpha is exp(-inf) = 0
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    uint32_t pf[4][4];                      // P as A fragments, 4 k-steps
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = __expf(s[n][0] - mn0), p1 = __expf(s[n][1] - mn0);
      const float p2 = __expf(s[n][2] - mn1), p3 = __expf(s[n][3] - mn1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: 4 k-steps of 16 keys x 16 n-tiles of 8 columns of Dh
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < 16; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sV + (kk * 16 + (lane & 15)) * kLd + n * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(o[n], pf[kk], bv[0], bv[1]);
        mma_bf16(o[n + 1], pf[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();                        // before the next tile's stores
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const long long row_stride = (long long)H * kD;
  float* o0 = out + ((long long)b * T_len + q0 + warp * 16 + g) * row_stride +
              h * kD + 2 * c;
  float* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    *reinterpret_cast<float2*>(o0 + n * 8) =
        make_float2(fltorch::round_bf16(o[n][0] * i0),
                    fltorch::round_bf16(o[n][1] * i0));
    *reinterpret_cast<float2*>(o1 + n * 8) =
        make_float2(fltorch::round_bf16(o[n][2] * i1),
                    fltorch::round_bf16(o[n][3] * i1));
  }
}

}  // namespace

// B12. q, k, v f32 [B, T, H, Dh] (element strides sb, st, sh each; the last
// axis contiguous; rows 16-byte aligned); out f32 [B, T, H, Dh] contiguous.
// Dh must be 128 and T a multiple of 64.
// Returns the CUDA error code of the launch.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             long long qsb, long long qst, long long qsh,
                             long long ksb, long long kst, long long ksh,
                             long long vsb, long long vst, long long vsh,
                             int B, int T_len, int H, int d, float scale,
                             void* out, void* stream) {
  if (d != kD || T_len <= 0 || T_len % kTile || B <= 0 || H <= 0 ||
      B > 65535 || T_len / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B, T_len / kTile);
  flash_prefill_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), Strides{qsb, qst, qsh},
      Strides{ksb, kst, ksh}, Strides{vsb, vst, vsh}, T_len, H, scale,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
