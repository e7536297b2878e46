"""q4_0 matmuls: the dispatcher, three Hopper kernels and their plain versions.

Ports fastllama_tpu/kernels/q4_matmul.py. The weight is a QuantMatmulWeight
(quant/tensor.py: split-K packed nibbles [K_pad/2, N_pad] and f32 scales
[K_pad/32, N_pad]); activations are f32 [M, K] and outputs f32
[M, n_logical].

Kernels (CUDA C++ for sm_90a, sources in csrc/, built by cuda_lib):
  B1 q4_matmul_decode        csrc/q4_decode.cu   (q4_matmul_pallas v1)
  B2 quant_rows_int8         csrc/quant_rows.cu  (quant_rows_int8)
  B3 q4_matmul_prefill_int8  csrc/q4_int8.cu     (q4_matmul_prefill_int8 nat)

Each wrapper launches its kernel for a CUDA tensor and raises on anything it
does not take; for a CPU tensor it runs its plain PyTorch version, which the
tests hold against the JAX package and chip_smoke.py holds the kernel
against. Each wrapper counts its launches in a plain int attribute
`.launches`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..quant.tensor import QBLOCK, QuantMatmulWeight, dequant_matmul_weight
from . import cuda_lib

# Dispatch table (fixed; see q4_matmul).
DECODE_MAX_M = 64
PREFILL_MIN_M = 256
RECIP_127 = float(np.float32(1.0) / np.float32(127.0))   # exact in f32


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_weight(w: QuantMatmulWeight, device: torch.device) -> None:
    """Validate the weight planes for a launch on `device`; the result is
    remembered on the weight (its planes are not replaced after loading),
    so each decode step does not pay for the checks again."""
    if getattr(w, "_checked_on", None) == device:
        return
    _require(w.qs.dtype == torch.uint8 and w.qs.is_contiguous()
             and w.qs.device == device,
             f"qs must be contiguous uint8 on {device}")
    _require(w.scales.dtype == torch.float32 and w.scales.is_contiguous()
             and w.scales.device == device
             and w.scales.shape == (w.qs.shape[0] // (QBLOCK // 2),
                                    w.qs.shape[1]),
             f"scales must be contiguous f32 [K/32, N] on {device}")
    w._checked_on = device


def _pad_k(x: torch.Tensor, k_stored: int) -> torch.Tensor:
    return x if x.shape[-1] == k_stored else F.pad(
        x, (0, k_stored - x.shape[-1]))


# ---------------------------------------------------------------------------
# Dequant + matmul (the q4_matmul_xla counterpart; B1's plain version)
# ---------------------------------------------------------------------------

def q4_matmul_dequant(x: torch.Tensor, w: QuantMatmulWeight,
                      w_dtype=torch.bfloat16) -> torch.Tensor:
    """y = w_dtype(x) @ w_dtype((q - 8) * d) with f32 accumulation.

    bf16 x bf16 products are exact in f32, so upcasting both operands and
    running an f32 matmul is the JAX dot with preferred_element_type=f32."""
    x2 = _pad_k(x, w.k).to(w_dtype).to(torch.float32)
    dense = dequant_matmul_weight(w, w_dtype).to(torch.float32)
    return (x2 @ dense)[:, :w.n_logical]


# ---------------------------------------------------------------------------
# B1: decode-size W4A16 matmul
# ---------------------------------------------------------------------------

def _b1_tile(m: int) -> tuple[int, int]:
    """(rows, columns) of one B1 block for M rows."""
    return (1, 256) if m == 1 else (4, 256) if m <= 4 else (16, 128)


def _splitk(m: int, n: int, nb: int) -> tuple[int, int]:
    """(splits, q blocks per split) for B1's tiles (1, 4 or 16 rows by 256,
    256 or 128 columns, see csrc/q4_decode.cu): about 4 blocks per SM of
    the H100 (132 SMs), at least one q block per warp (8) and at most 32 q
    blocks of x staged per block."""
    rows, cols = _b1_tile(m)
    tiles = -(-n // cols) * -(-m // rows)
    per = -(-nb // max(1, -(-528 // tiles)))
    per = min(32, max(per, min(8, nb)))
    return -(-nb // per), per


def q4_matmul_decode(x: torch.Tensor, w: QuantMatmulWeight,
                     w_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel B1: x f32 [M <= 64, K] -> y f32 [M, n_logical].

    Split-K partials are added by the last block of each output tile in a
    fixed order (deterministic; the sum order differs from a dense matmul,
    so compare at f32 reassociation tolerance)."""
    _require(x.dim() == 2 and x.dtype == torch.float32,
             "x must be f32 [M, K]")
    _require(w_dtype in (torch.bfloat16, torch.float32),
             "w_dtype must be bfloat16 or float32")
    if x.device.type == "cpu":
        return q4_matmul_dequant(x, w, w_dtype)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _check_weight(w, x.device)
    m, kx = x.shape
    kh, n = w.qs.shape
    nb = kh // (QBLOCK // 2)
    _require(x.is_contiguous() and 1 <= m <= DECODE_MAX_M,
             f"x must be contiguous with 1 <= M <= {DECODE_MAX_M}")
    _require(kx <= kh * 2, f"x K={kx} exceeds the stored K={kh * 2}")
    _require(n % 8 == 0, "stored N must be a multiple of 8")
    splits, per = _splitk(m, n, nb)
    rows, cols = _b1_tile(m)
    dev = x.device
    partial = cuda_lib.scratch(dev, "q4_gemv.partial", splits * m * n,
                               torch.float32)
    counters = cuda_lib.tile_counters(dev, -(-n // cols) * -(-m // rows))
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=dev)
    rc = cuda_lib.fn("q4_gemv")(
        x.data_ptr(), m, kx, w.qs.data_ptr(), w.scales.data_ptr(), n, nb,
        splits, per, partial.data_ptr(), counters.data_ptr(), y.data_ptr(),
        w.n_logical, int(w_dtype == torch.bfloat16),
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "q4_gemv")
    q4_matmul_decode.launches += 1
    return y


q4_matmul_decode.launches = 0


# ---------------------------------------------------------------------------
# B2: per-row int8 activation quantization
# ---------------------------------------------------------------------------

def quant_rows_int8_plain(x: torch.Tensor, k_out: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """dx = max(max|x|, 1e-20) * f32(1/127); xq = clip(round_half_even(x / dx))
    with a correctly rounded division."""
    x = _pad_k(x.to(torch.float32), k_out or x.shape[-1])
    # max / 127 as the JAX package computes it under jit: XLA rewrites the
    # division by a constant into a product with the f32 reciprocal
    dx = torch.clamp(x.abs().amax(dim=-1), min=1e-20) * RECIP_127
    xq = torch.clamp(torch.round(x / dx[:, None]), -127, 127)
    return xq.to(torch.int8), dx


def quant_rows_int8(x: torch.Tensor, k_out: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B2: x f32 [M, K] -> (xq int8 [M, k_out], dx f32 [M]).

    Columns past K (up to the weight's stored k_out) are zeros. Bit-exact
    with the JAX kernel."""
    _require(x.dim() == 2 and x.dtype == torch.float32,
             "x must be f32 [M, K]")
    m, kx = x.shape
    k_out = k_out or kx
    _require(k_out >= kx, "k_out must be >= x's K")
    if x.device.type == "cpu":
        return quant_rows_int8_plain(x, k_out)
    _require(x.device.type == "cuda" and x.is_contiguous(),
             "x must be a contiguous CUDA tensor")
    xq = torch.empty((m, k_out), dtype=torch.int8, device=x.device)
    dx = torch.empty((m,), dtype=torch.float32, device=x.device)
    rc = cuda_lib.fn("quant_rows_int8")(
        x.data_ptr(), m, kx, k_out, xq.data_ptr(), dx.data_ptr(),
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(rc, "quant_rows_int8")
    quant_rows_int8.launches += 1
    return xq, dx


quant_rows_int8.launches = 0


# ---------------------------------------------------------------------------
# B3: int8 prefill matmul
# ---------------------------------------------------------------------------

def requant_weight_int8(w: QuantMatmulWeight
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(w8 int8 [K_pad, N_pad] in natural K order, s8 f32 [N_pad]):
    s8 = max(max_K |d| * 8/127, 1e-20) over the whole K and
    w8 = round_half_even((q - 8) * (d * (1 / s8)))."""
    s8 = torch.clamp(w.scales.abs().amax(dim=0) * (8.0 / 127.0), min=1e-20)
    sc = w.scales * (torch.ones_like(s8) / s8)
    kh, n = w.qs.shape
    nb = kh // (QBLOCK // 2)
    q = w.qs.reshape(nb, QBLOCK // 2, n).to(torch.int32)
    codes = torch.cat([q & 0x0F, q >> 4], dim=1) - 8           # [nb, 32, N]
    w8 = torch.round(codes.to(torch.float32) * sc[:, None, :])
    return w8.reshape(nb * QBLOCK, n).to(torch.int8), s8


def int8_accumulators(xq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact xq @ w8 as float64 (|acc| <= 127 * 127 * K < 2**53; PyTorch has
    no int32 matmul on CUDA)."""
    return xq.to(torch.float64) @ w8.to(torch.float64)


def q4_matmul_prefill_int8_plain(xq: torch.Tensor, dx: torch.Tensor,
                                 w: QuantMatmulWeight) -> torch.Tensor:
    w8, s8 = requant_weight_int8(w)
    acc = int8_accumulators(xq, w8).to(torch.float32)
    y = (acc * dx[:, None]) * s8[None, :]
    return y[:, :w.n_logical]


def q4_matmul_prefill_int8(xq: torch.Tensor, dx: torch.Tensor,
                           w: QuantMatmulWeight) -> torch.Tensor:
    """Kernel B3: xq int8 [M, K_stored], dx f32 [M] -> y f32 [M, n_logical].

    Exact int32 accumulators; y = (acc * dx) * s8, the JAX order, so the
    kernel and its plain version agree bit for bit."""
    _require(xq.dim() == 2 and xq.dtype == torch.int8
             and dx.dtype == torch.float32 and dx.shape == (xq.shape[0],),
             "xq must be int8 [M, K] and dx f32 [M]")
    _require(xq.shape[1] == w.k, f"xq K={xq.shape[1]} != stored K={w.k}")
    if xq.device.type == "cpu":
        return q4_matmul_prefill_int8_plain(xq, dx, w)
    _require(xq.device.type == "cuda" and xq.is_contiguous()
             and dx.is_contiguous() and dx.device == xq.device,
             "xq and dx must be contiguous CUDA tensors")
    _check_weight(w, xq.device)
    m, k = xq.shape
    n = w.qs.shape[1]
    _require(k % 64 == 0, "stored K must be a multiple of 64")
    dev = xq.device
    s8inv = cuda_lib.scratch(dev, "q4_int8.s8inv", 2 * n, torch.float32)
    w8t = cuda_lib.scratch(dev, "q4_int8.w8t", n * k, torch.int8)
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=dev)
    rc = cuda_lib.fn("q4_int8_gemm")(
        xq.data_ptr(), dx.data_ptr(), m, k, w.qs.data_ptr(),
        w.scales.data_ptr(), n, s8inv.data_ptr(), w8t.data_ptr(),
        y.data_ptr(), w.n_logical, cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "q4_int8_gemm")
    q4_matmul_prefill_int8.launches += 1
    return y


q4_matmul_prefill_int8.launches = 0


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

def use_int8(m: int, w_dtype, prefill_int8: bool | None) -> bool:
    """The int8 prefill path: M >= PREFILL_MIN_M and int8 enabled (None =
    on in bf16 mode, off in f32 mode)."""
    on = (w_dtype != torch.float32) if prefill_int8 is None else prefill_int8
    return m >= PREFILL_MIN_M and on


def q4_matmul(x: torch.Tensor, w: QuantMatmulWeight, *,
              w_dtype=torch.bfloat16,
              prefill_int8: bool | None = None) -> torch.Tensor:
    """x [..., K_logical] -> [..., n_logical] f32, chosen by M = prod(lead):

      M <= 64                           -> B1 q4_matmul_decode
      M >= 256 and int8 (use_int8)      -> B2 quant_rows_int8 + B3
      otherwise                         -> q4_matmul_dequant (dequant +
                                           torch.matmul), which includes
                                           64 < M < 256 and M >= 256 with
                                           int8 off (f32 mode, or
                                           prefill_int8=False) until the
                                           bf16 prefill kernel B5 lands.

    The stored-K padding of the weight is handled inside (x counts as zero
    there) and outputs have the logical width."""
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    x2 = x.reshape(m, x.shape[-1]).to(torch.float32).contiguous()
    if m <= DECODE_MAX_M:
        y = q4_matmul_decode(x2, w, w_dtype)
    elif use_int8(m, w_dtype, prefill_int8):
        xq, dx = quant_rows_int8(x2, w.k)
        y = q4_matmul_prefill_int8(xq, dx, w)
    else:
        y = q4_matmul_dequant(x2, w, w_dtype)
    return y.reshape(*lead, w.n_logical)
