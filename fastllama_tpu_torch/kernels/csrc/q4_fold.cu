// Kernel B15 (the JAX package's v1 decode body, and v4 and v5): the
// variant 1 build of the decode kernel of csrc/q4_fold.cuh, and its
// cluster capacity.

#include "q4_fold.cuh"

// Kernel B15 (variant 1; q4_fold_v0.cu's q4_fold_v0_gemm is B1, variant
// 0, q4_fold_v2.cu's q4_fold_v2_gemm B16, variant 2, q4_fold_v3.cu's
// q4_fold_v3_gemm B17, variant 3, and q4_fold_v7.cu's q4_fold_v7_gemm B18,
// variant 7, with the same arguments; q4_fold_v9.cu's B9 takes the mins
// too): y f32
// [M, n_out] from x f32
// [M, Kx] (1 <= M <= 64, Kx a multiple of 4 and at most 32 NB, x 16-byte
// aligned; x counts as zero past Kx), qs uint8
// [16 NB, N] and scales f32 (sc16 = 0) or bf16 (sc16 = 1) [NB, N] (N a
// multiple of 16, the planes 16-byte aligned), on the plan of
// q4_variants.b15_plan: wgs consumer warpgroups (1 or 2; 128 wgs columns
// a tile at M <= 32, 64 wgs above), `stages`
// weight ring slots and `xstages` x ring slots (2..stages), `splits`
// (1..8, the cluster size) runs of `sps` K stages (4 q blocks each)
// covering the plane's ceil(NB / 4),
// `clusters` clusters walking the column tiles, sync = 1 (M <= 8 only):
// mma.sync in place of wgmma; scratch: null (the sweep's global-merge build
// takes clusters * splits * 64 wgs * M rounded up to 8 floats). Returns the
// CUDA error code of the launch.
extern "C" int q4_fold_gemm(const void* x, int M, int Kx, const void* qs,
                            const void* scales, int sc16, int N, int NB,
                            int variant, int wgs, int stages, int xstages,
                            int splits, int sps, int clusters, int sync,
                            void* y, int n_out, void* scratch, void* stream) {
  return fold_gemm<1>(x, M, Kx, qs, scales, nullptr, sc16, N, NB,
                     variant, wgs, stages, xstages, splits, sps,
                     clusters, sync, y, n_out, scratch, stream);
}

// How many clusters of `splits` blocks the card holds at once
// (cudaOccupancyMaxActiveClusters, one block an SM), or minus the CUDA
// error code.
extern "C" int q4_fold_clusters(int splits) {
  auto* kern = q4_fold_kernel<8, 1, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(max_threads(8));
  cfg.dynamicSmemBytes = kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
