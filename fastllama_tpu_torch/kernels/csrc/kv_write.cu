// Kernels B7 and B8: in-place writes into the paged KV pools [H, P, ps, D].
//
// B7 (paged_kv_write) replaces fastllama_tpu/kernels/kv_write.py::
// paged_kv_write (_kv_write_kernel): one decode step writes one token's K
// and V vectors per sequence,
//   K[h, page_ids[b], offsets[b], :] = T(k_new[b, h, :])   (and V likewise)
// casting f32 to the pool type T. An inactive slot carries the id of the
// pool's last page, the trash page, and writes there; several slots may hit
// it in one launch, which is harmless (nothing reads it). An id outside
// [0, P) or an offset outside [0, ps) writes nothing. The TPU kernel blends
// the row into an 8-row group it reads and writes back; a CUDA thread block
// stores the D values of each head directly.
//
// B8 (paged_kv_write_rows) replaces paged_kv_write_rows
// (_kv_write_rows_kernel) of the same file: T consecutive flat rows
// [T, H * D] of a fresh sequence become whole pages,
//   K[h, page_ids[j], r, :] = k_rows[j * ps + r, h * D : (h + 1) * D]
// a head-major transpose, rows and pools of one type (a pure copy).
//
// Bound on the H100: bytes, and at these sizes the launch. B7 moves
// 2 * B * H * D values (a few hundred KB at most): one block per sequence.
// B8 moves 2 * T * H * D values once: one block per (page, head) copies ps
// runs of D contiguous values as 16-byte vectors, so both the read (a run
// inside a row) and the write (a run inside a page) are whole coalesced
// segments and no staging through shared memory is needed.
//
// slab_write_rows is no TPU kernel's port: it is the in-place write of the
// JAX forward's _write_kv (fastllama_tpu/models/llama.py:260-275) at a
// position held on the device, T rows per sequence into the slab caches
// [B, S, F] at n_past[b] + t, a row whose position falls outside [0, S)
// dropped (the scatter's mode="drop": a padded chunk tail past n_ctx, an
// inactive engine slot at n_ctx + 1). XLA's scatter takes one pass; PyTorch
// has no dropping indexed write, and its general form costs about ten small
// launches a write, 64 writes a 7B window. One block per row copies it as
// 16-byte vectors (every row the forward writes, 7B or 13B, whole or a
// tensor-parallel shard, bf16 or f32, is a 16-byte multiple at a 16-byte
// aligned address); the positions of one sequence are distinct, so no two
// blocks meet.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_write_kernel(T* __restrict__ kp, T* __restrict__ vp,
                const float* __restrict__ k_new,
                const float* __restrict__ v_new,
                const int* __restrict__ page_ids,
                const int* __restrict__ offsets, int H, int P, int ps,
                int d) {
  const int b = blockIdx.x;
  const int pid = page_ids[b], off = offsets[b];
  if (pid < 0 || pid >= P || off < 0 || off >= ps) return;
  const int F = H * d;
  for (int i = threadIdx.x; i < F; i += kThreads) {
    const int h = i / d, l = i - h * d;
    const size_t dst = (((size_t)h * P + pid) * ps + off) * d + l;
    kp[dst] = fltorch::from_f32<T>(k_new[(size_t)b * F + i]);
    vp[dst] = fltorch::from_f32<T>(v_new[(size_t)b * F + i]);
  }
}

// c: 16-byte vectors per head row (D * sizeof(T) / 16).
__global__ void __launch_bounds__(kThreads)
kv_write_rows_kernel(uint4* __restrict__ kp, uint4* __restrict__ vp,
                     const uint4* __restrict__ k_rows,
                     const uint4* __restrict__ v_rows,
                     const int* __restrict__ page_ids, int H, int P, int ps,
                     int c) {
  const int j = blockIdx.x, h = blockIdx.y;
  const int pid = page_ids[j];
  if (pid < 0 || pid >= P) return;
  const int n = ps * c;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / c, x = i - r * c;
    const size_t src = (((size_t)j * ps + r) * H + h) * c + x;
    const size_t dst = (((size_t)h * P + pid) * ps + r) * c + x;
    kp[dst] = k_rows[src];
    vp[dst] = v_rows[src];
  }
}

// c 16-byte units per row; strides in units.
__global__ void __launch_bounds__(kThreads)
slab_write_rows_kernel(uint4* __restrict__ cache,
                       const uint4* __restrict__ rows,
                       const int* __restrict__ n_past, int S, int c,
                       long long stride_b, long long stride_t) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int p = n_past[b] + t;
  if (p < 0 || p >= S) return;
  const uint4* src = rows + b * stride_b + t * stride_t;
  uint4* dst = cache + ((size_t)b * S + p) * c;
  for (int i = threadIdx.x; i < c; i += kThreads) dst[i] = src[i];
}

}  // namespace

// B7. Pools [H, P, ps, d] of type bf16 (pool_bf16 = 1) or f32; k_new, v_new
// f32 [B, H, d]; page_ids, offsets int32 [B].
// Returns the CUDA error code of the launch.
extern "C" int paged_kv_write(void* kp, void* vp, const void* k_new,
                              const void* v_new, const void* page_ids,
                              const void* offsets, int B, int H, int P,
                              int ps, int d, int pool_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return 0;
  if (pool_bf16)
    kv_write_kernel<__nv_bfloat16><<<B, kThreads, 0, s>>>(
        (__nv_bfloat16*)kp, (__nv_bfloat16*)vp, (const float*)k_new,
        (const float*)v_new, (const int*)page_ids, (const int*)offsets, H, P,
        ps, d);
  else
    kv_write_kernel<float><<<B, kThreads, 0, s>>>(
        (float*)kp, (float*)vp, (const float*)k_new, (const float*)v_new,
        (const int*)page_ids, (const int*)offsets, H, P, ps, d);
  return (int)cudaGetLastError();
}

// B8. Pools [H, P, ps, D] and rows [n_blocks * ps, H * D] of one type whose
// head row takes row_bytes = D * sizeof(type) bytes, a multiple of 16, all
// 16-byte aligned; page_ids int32 [n_blocks].
// Returns the CUDA error code of the launch.
extern "C" int paged_kv_write_rows(void* kp, void* vp, const void* k_rows,
                                   const void* v_rows, const void* page_ids,
                                   int n_blocks, int H, int P, int ps,
                                   int row_bytes, void* stream) {
  if (n_blocks == 0) return 0;
  dim3 grid(n_blocks, H);
  kv_write_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (uint4*)kp, (uint4*)vp, (const uint4*)k_rows, (const uint4*)v_rows,
      (const int*)page_ids, H, P, ps, row_bytes / 16);
  return (int)cudaGetLastError();
}

// The slab row write. cache [B, S, F] contiguous; rows [B, T, F] of the
// cache's type, each row contiguous, row (b, t) at b * stride_b + t *
// stride_t bytes; n_past int32 [B]. row_bytes, both strides and both base
// addresses are multiples of 16.
// Returns the CUDA error code of the launch.
extern "C" int slab_write_rows(void* cache, const void* rows,
                               const void* n_past, int B, int S, int T,
                               int row_bytes, long long stride_b,
                               long long stride_t, void* stream) {
  if (B == 0 || T == 0) return 0;
  dim3 grid(T, B);
  slab_write_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (uint4*)cache, (const uint4*)rows, (const int*)n_past, S,
      row_bytes / 16, stride_b / 16, stride_t / 16);
  return (int)cudaGetLastError();
}
