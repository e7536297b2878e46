// Kernels B1 and B9 in f32 mode (the JAX package's q4_matmul_pallas and
// q41_matmul_pallas at w_dtype float32): variants 10 and 11 of the decode
// kernel of csrc/q4_fold.cuh, built together, y = x @ ((q - 8) d) and
// y = x @ (q d) + bsum(x) @ m with nothing rounded to bf16: x split into
// three exact bf16 parts, each q block's products of the parts and the
// codes summed in f32 by the tensor cores, then scaled by d. Built for
// M <= 32 (NW 8-32): above it B5's f32 mode takes these calls.

#include "q4_fold.cuh"

// Kernel B1 in f32 mode (variant 10): the arguments are q4_fold_gemm's
// (csrc/q4_fold.cu) with variant 10, f32 scales (sc16 = 0) and no mins.
// Returns the CUDA error code of the launch.
extern "C" int q4_fold_f32_gemm(const void* x, int M, int Kx, const void* qs,
                                const void* scales, int sc16, int N, int NB,
                                int variant, int wgs, int stages,
                                int xstages, int splits, int sps,
                                int clusters, int sync, void* y, int n_out,
                                void* scratch, void* stream) {
  return fold_gemm<10>(x, M, Kx, qs, scales, nullptr, sc16, N, NB,
                       variant, wgs, stages, xstages, splits, sps,
                       clusters, sync, y, n_out, scratch, stream);
}

// Kernel B9 in f32 mode (variant 11): q4_fold_v9_gemm's arguments
// (csrc/q4_fold_v9.cu: the mins plane f32 [NB, N] after the f32 scales)
// with variant 11. Returns the CUDA error code of the launch.
extern "C" int q4_fold_f32a_gemm(const void* x, int M, int Kx,
                                 const void* qs, const void* scales,
                                 const void* mins, int sc16, int N, int NB,
                                 int variant, int wgs, int stages,
                                 int xstages, int splits, int sps,
                                 int clusters, int sync, void* y, int n_out,
                                 void* scratch, void* stream) {
  return fold_gemm<11>(x, M, Kx, qs, scales, mins, sc16, N, NB, variant,
                       wgs, stages, xstages, splits, sps, clusters, sync, y,
                       n_out, scratch, stream);
}
