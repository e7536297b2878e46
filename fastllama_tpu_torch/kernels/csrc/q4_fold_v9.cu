// Kernel B9 in bf16 mode (the JAX package's q41_matmul_pallas): the variant
// 9 build of the decode kernel of csrc/q4_fold.cuh,
// y = R(x) @ R(q d) + bsum(x) @ m for an affine (q4_1) weight. The
// arguments are q4_fold_gemm's (csrc/q4_fold.cu; variant must be 9) with
// the mins plane f32 [NB, N] (16-byte aligned) after the scales, which are
// f32 (sc16 must be 0). Returns the CUDA error code of the launch.

#include "q4_fold.cuh"

extern "C" int q4_fold_v9_gemm(const void* x, int M, int Kx, const void* qs,
                               const void* scales, const void* mins,
                               int sc16, int N, int NB, int variant, int wgs,
                               int stages, int xstages, int splits, int sps,
                               int clusters, int sync, void* y, int n_out,
                               void* scratch, void* stream) {
  return fold_gemm<9>(x, M, Kx, qs, scales, mins, sc16, N, NB, variant,
                      wgs, stages, xstages, splits, sps, clusters, sync, y,
                      n_out, scratch, stream);
}
