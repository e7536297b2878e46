// Kernels B13 and B14 (the probes of tools/bench_q4_floor.py, _floor_kernel
// and _nosc_kernel): variants 13 and 14 of the decode kernel of
// csrc/q4_fold.cuh, built together (no bf16-scale build: they read no
// scales).

#include "q4_fold.cuh"

// Kernel B13: y f32 [M, n_out] = R(x_lo) @ qs, the whole packed byte
// (0..255) as the weight, and kernel B14 (q4_fold_nosc_gemm, variant 14):
// R(x_lo) @ (qs & 15) + R(x_hi) @ (qs >> 4), x_lo and x_hi the low and high
// halves of each 32-column q block of x. The arguments are q4_fold_gemm's
// (csrc/q4_fold.cu) on B15's plan at f32 scales, with variant 13 (14),
// sc16 = 0 and `scales` not read (null). Returns the CUDA error code of the
// launch.
extern "C" int q4_fold_floor_gemm(const void* x, int M, int Kx,
                                  const void* qs, const void* scales,
                                  int sc16, int N, int NB, int variant,
                                  int wgs, int stages, int xstages,
                                  int splits, int sps, int clusters,
                                  int sync, void* y, int n_out,
                                  void* scratch, void* stream) {
  return fold_gemm<13>(x, M, Kx, qs, scales, nullptr, sc16, N, NB,
                      variant, wgs, stages, xstages, splits, sps,
                      clusters, sync, y, n_out, scratch, stream);
}

extern "C" int q4_fold_nosc_gemm(const void* x, int M, int Kx,
                                 const void* qs, const void* scales, int sc16,
                                 int N, int NB, int variant, int wgs,
                                 int stages, int xstages, int splits, int sps,
                                 int clusters, int sync, void* y, int n_out,
                                 void* scratch, void* stream) {
  return fold_gemm<14>(x, M, Kx, qs, scales, nullptr, sc16, N, NB,
                      variant, wgs, stages, xstages, splits, sps,
                      clusters, sync, y, n_out, scratch, stream);
}
