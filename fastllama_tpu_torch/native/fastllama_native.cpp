// fastllama_tpu_torch native host code: the host-side hot loops of
// checkpoint loading and offline quantization, as multithreaded C++ with a
// C ABI (bound via ctypes and built at first use by quant/native.py).
//
// Counterparts of the reference's native host paths:
//   * ggml q4_0 wire -> device-layout repack  (replaces the mmap+memcpy load
//     of include/file_loader.hpp; ours additionally transposes to the K-major
//     split-K packed layout the matmul kernels consume)
//   * bit-exact q4_0 quantization             (lib/ggml.c:630-664 semantics:
//     d = amax/7, q = roundf(v/d) + 8, round half away from zero)
//
// Plain C++17 + std::thread; no external deps. The JAX package carries the
// same source; both give the same bytes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kBlock = 32;           // QK4_0
constexpr int kHalf = kBlock / 2;    // 16
constexpr int kWireBlockBytes = 4 + kHalf;  // f32 d + 16 nibble bytes

void parallel_for(int64_t n, int nthreads, void (*fn)(int64_t, int64_t, void*),
                  void* ctx) {
  if (nthreads <= 1 || n < 2) {
    fn(0, n, ctx);
    return;
  }
  nthreads = std::min<int64_t>(nthreads, n);
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi, ctx);
  }
  for (auto& th : ts) th.join();
}

struct RepackCtx {
  const uint8_t* wire;   // [n rows][k/32 blocks][20 bytes]
  int64_t n, k;          // ggml orientation: n rows of k elements
  int64_t k_pad, n_pad;  // padded device dims
  uint8_t* qs;           // out [k_pad/2, n_pad]
  float* scales;         // out [k_pad/32, n_pad]
};

// One source row r contributes column r of every output plane: for each
// block b along K, wire nibbles (pairs (2l, 2l+1)) are re-split so that
// low nibbles hold elements 0..15 and high nibbles 16..31 of the block,
// landing at qs[(b*16 + j) * n_pad + r].
void repack_rows(int64_t lo, int64_t hi, void* vctx) {
  auto* c = static_cast<RepackCtx*>(vctx);
  const int64_t nb = c->k / kBlock;
  const int64_t row_bytes = nb * kWireBlockBytes;
  uint8_t codes[kBlock];
  for (int64_t r = lo; r < hi; ++r) {
    const uint8_t* src = c->wire + r * row_bytes;
    for (int64_t b = 0; b < nb; ++b) {
      float d;
      std::memcpy(&d, src, 4);
      const uint8_t* qs_in = src + 4;
      for (int l = 0; l < kHalf; ++l) {
        codes[2 * l] = qs_in[l] & 0x0F;
        codes[2 * l + 1] = qs_in[l] >> 4;
      }
      uint8_t* dst = c->qs + (b * kHalf) * c->n_pad + r;
      for (int j = 0; j < kHalf; ++j) {
        dst[j * c->n_pad] =
            static_cast<uint8_t>(codes[j] | (codes[kHalf + j] << 4));
      }
      c->scales[b * c->n_pad + r] = d;
      src += kWireBlockBytes;
    }
  }
}

struct QuantCtx {
  const float* x;     // [rows, k]
  int64_t rows, k;
  uint8_t* codes;     // out [rows, k] (one code per element, 0..15)
  float* scales;      // out [rows, k/32]
};

void quantize_rows(int64_t lo, int64_t hi, void* vctx) {
  auto* c = static_cast<QuantCtx*>(vctx);
  const int64_t nb = c->k / kBlock;
  for (int64_t r = lo; r < hi; ++r) {
    const float* src = c->x + r * c->k;
    uint8_t* out = c->codes + r * c->k;
    float* srow = c->scales + r * nb;
    for (int64_t b = 0; b < nb; ++b) {
      const float* v = src + b * kBlock;
      float amax = 0.0f;
      for (int i = 0; i < kBlock; ++i) amax = std::max(amax, std::fabs(v[i]));
      const float d = amax / 7.0f;
      const float id = d != 0.0f ? 1.0f / d : 0.0f;
      srow[b] = d;
      uint8_t* q = out + b * kBlock;
      for (int i = 0; i < kBlock; ++i) {
        // roundf: round half away from zero (ggml.c:653 semantics)
        q[i] = static_cast<uint8_t>(
            static_cast<int8_t>(std::roundf(v[i] * id)) + 8);
      }
    }
  }
}

}  // namespace

extern "C" {

// ggml q4_0 wire payload [n, k] -> padded device planes.
// qs must be pre-filled by the caller IF padding is desired beyond what this
// writes; this function fills the full padded planes itself (pad codes 0x88,
// pad scales 0).
void flt_repack_q4_wire(const uint8_t* wire, int64_t n, int64_t k,
                        int64_t n_pad, int64_t k_pad, uint8_t* qs,
                        float* scales, int nthreads) {
  std::memset(qs, 0x88, static_cast<size_t>(k_pad / 2) * n_pad);
  std::memset(scales, 0, static_cast<size_t>(k_pad / kBlock) * n_pad * 4);
  RepackCtx ctx{wire, n, k, k_pad, n_pad, qs, scales};
  parallel_for(n, nthreads, repack_rows, &ctx);
}

// Bit-exact q4_0 quantization: x [rows, k] f32 -> codes [rows, k] (0..15),
// scales [rows, k/32] f32.
void flt_quantize_q4_0(const float* x, int64_t rows, int64_t k,
                       uint8_t* codes, float* scales, int nthreads) {
  QuantCtx ctx{x, rows, k, codes, scales};
  parallel_for(rows, nthreads, quantize_rows, &ctx);
}

int flt_native_version(void) { return 1; }

}  // extern "C"
