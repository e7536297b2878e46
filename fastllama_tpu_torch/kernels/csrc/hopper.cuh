// Hopper building blocks shared by the port's wgmma kernels (B3 and B5 in
// q4_prefill_ra.cuh, B19 in q4_int8.cu, B20 in q4_prefill.cu, B12 in
// flash_prefill.cu, the fold kernel of q4_fold.cuh) and B21
// (paged_flash.cu): mbarriers, TMA tile loads and their tensor maps, 1-D
// bulk copies, shared-memory matrix descriptors, the wgmma fences and the
// register pins of a register-A pipeline, and the thread block cluster's
// rank, distributed shared memory, cluster-scope barriers and launch.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at
                    // run time through the runtime, so no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. Built with
// -DFLTORCH_MBAR_TRAP (a debugging aid), a wait that spins for seconds traps
// rather than hanging the card; a trap leaves the CUDA context unusable, so
// the libraries are built without it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
#ifdef FLTORCH_MBAR_TRAP
  for (long long spin = 0;; ++spin) {
#else
  for (;;) {
#endif
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
#ifdef FLTORCH_MBAR_TRAP
    if (spin > (1LL << 22)) __trap();
#endif
  }
}

// Order this thread's generic-proxy writes to shared memory before later
// reads by the async proxy (wgmma reading a tile the threads wrote).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Fetch a tensor map (a kernel parameter) into the descriptor cache ahead
// of its first copy.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1) : "memory");
}

// A contiguous run of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory, one bulk copy that reports to
// the barrier (no tensor map: B21 stages a page's rows this way).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// A box of a 4-D map (coordinates innermost first) into shared memory.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused for this layout. Advancing K by 32 bytes within the
// swizzle row adds to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of an MN-major tile of 16-bit elements with the 128-byte
// swizzle (the transposed operand, wgmma's tnsp bit set): atoms of 8 rows
// of K by 64 elements of M or N (128 bytes a row, 1024 bytes an atom, the
// 16-byte chunk c of row r stored at chunk c ^ r), `lbo` bytes between
// atoms along M/N and `sbo` bytes between atoms along K (8 rows of K).
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t saddr, int lbo,
                                                  int sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of a K-major tile of 16-bit elements without swizzle: core
// matrices of 8 rows by 16 bytes (128 contiguous bytes), `lbo` bytes apart
// along K and `sbo` bytes apart along M or N.
__device__ __forceinline__ uint64_t plain_desc(uint32_t saddr, int lbo,
                                               int sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep a register set live (and in its registers) up to this point: the
// compiler sees a wgmma that reads A from registers as done at its issue,
// and would otherwise hand those registers to the next A fragment while
// the product is still in flight, which ptxas answers by serializing the
// wgmmas.
template <int R> __device__ __forceinline__ void keep_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// An arrival on `bar` if `cond`, by a predicated instruction: a branch (or a
// __syncwarp) while a wgmma is in flight makes ptxas serialize the wgmmas.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool cond) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %1, 0;\n"
      "@q mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      ::"r"(bar), "r"((int)cond) : "memory");
}

// Pin the accumulators: the compiler sees wgmma as an ordinary asm that is
// done when it returns, so without this it may read (or move) them before
// the wait that completes the asynchronous products.
template <int R> __device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R> __device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// thread block clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address, in the block of cluster rank `rank`, of the
// local shared address `saddr` (the same offset in that block's window).
__device__ __forceinline__ uint32_t mapa(uint32_t saddr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(saddr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

// Arrive on a barrier of any block of the cluster (an address from mapa),
// with the default semantics (a release at CTA scope): it orders nothing
// this thread wrote for the other block, only what it did before (a slot
// read to its end).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// 16 bytes from registers to `addr` in another block of the cluster (from
// mapa), completing their bytes on that block's barrier `bar` (from mapa);
// the sender may leave at once.
__device__ __forceinline__ void st_async_v4(uint32_t addr, float4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
      " [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// mbar_wait with acquire at cluster scope: what other blocks of the
// cluster stored before completing the phase (st_async_v4) is visible.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, int parity) {
  uint32_t done = 0;
#ifdef FLTORCH_MBAR_TRAP
  for (long long spin = 0;; ++spin) {
#else
  for (;;) {
#endif
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
        " p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
#ifdef FLTORCH_MBAR_TRAP
    if (spin > (1LL << 22)) __trap();
#endif
  }
}

// `bytes` (a multiple of 16) of this block's shared memory at `src` to
// `dst` in another block of the cluster, one bulk copy that completes its
// bytes on that block's barrier `bar` (dst and bar from mapa). Writes of
// this block's threads to src must be fenced to the async proxy first.
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, uint32_t src,
                                                  int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// The cluster barrier, every thread of every block of the cluster, whole
// warps at a time; arrive (releasing the thread's writes) and wait
// (acquiring every arrived thread's) may be apart.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Launch `kernel` on `grid` in clusters of cluster_x x 1 x 1 blocks.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 block,
                           int cluster_x, size_t smem, cudaStream_t stream,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D map of a row-major [rows, cols] matrix of `type` (elements of
// `elem_bytes`, cols contiguous, rows elem_bytes * cols apart) in boxes of
// box_cols by box_rows, zeros past the edges; `swizzle` as the reader
// needs it (128 bytes for a wgmma operand read as it lands, none for a
// tile that threads read).
inline bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                     int elem_bytes, int rows, int cols, int box_cols,
                     int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D map of a strided [d3, d2, d1, d0] tensor of `type` (d0 contiguous,
// `strides` the byte strides of d1, d2 and d3: multiples of 16) in boxes of
// box[0..3] elements, with the 128-byte swizzle (box[0] * elem_bytes must
// then be at most 128).
inline bool make_map_4d(CUtensorMap* map, const void* ptr,
                        CUtensorMapDataType type, const long long dims[4],
                        const long long strides[3], const int box[4]) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gd[4], gs[3];
  cuuint32_t bx[4];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    gd[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
  }
  for (int i = 0; i < 3; ++i) gs[i] = (cuuint64_t)strides[i];
  return fn(map, type, 4, const_cast<void*>(ptr), gd, gs, bx, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
