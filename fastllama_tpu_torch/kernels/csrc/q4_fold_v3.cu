// Kernel B17 (the JAX package's v3 decode body): the variant 3 build of
// the decode kernel of csrc/q4_fold.cuh, with q4_fold_gemm's arguments
// (csrc/q4_fold.cu; variant must be 3). Returns the CUDA error code of the
// launch.

#include "q4_fold.cuh"

extern "C" int q4_fold_v3_gemm(const void* x, int M, int Kx, const void* qs,
                               const void* scales, int sc16, int N, int NB,
                               int variant, int wgs, int stages,
                               int xstages, int splits, int sps,
                               int clusters, int sync, void* y, int n_out,
                               void* scratch, void* stream) {
  return fold_gemm<3>(x, M, Kx, qs, scales, nullptr, sc16, N, NB,
                     variant, wgs, stages, xstages, splits, sps,
                     clusters, sync, y, n_out, scratch, stream);
}
