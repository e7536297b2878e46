"""B13 and B14: two probes of the decode matmul B1's access pattern.

Ports the two Pallas kernels of tools/bench_q4_floor.py, which time how fast
the q4 matmul's access pattern moves the packed weight bytes when its body
does less than the production kernel:

  B13 q4_floor  (_floor_kernel, :37)  out = R(x_lo) @ f32(qs): the whole
                packed byte (0-255) as the weight; no nibble unpack, no
                scales, no -8
  B14 q4_nosc   (_nosc_kernel, :49)   out = R(x_lo) @ (qs & 15)
                                            + R(x_hi) @ (qs >> 4):
                both nibbles, the scale plane never read

where x_lo, x_hi are the low and high halves of each 32-column q block of
x (split_activation) and R rounds to bf16. x is f32 [M <= 64, K], qs uint8
[K/2, N] in the split-K packing of quant/tensor.py, out f32 [M, N].

On the card both run B1's tensor-core kernel (csrc/q4_decode.cu,
q4_mma_kernel in the modes kFloor and kNosc): B1's grid and plan
(q4_matmul.b1_mma_plan), its loads of the packed rows and its ordered
split-K merge, so the gaps between B13, B14 and B1 split B1's time into
the access pattern, the unpack and the scale path. Each wrapper launches
its kernel for a CUDA tensor and raises on anything it does not take; for
a CPU tensor it runs its plain version. Each counts its launches in
`.launches`.
"""
from __future__ import annotations

import torch

from ..quant.tensor import QBLOCK
from . import cuda_lib
from .q4_matmul import B1_MMA_WARP_COLS, DECODE_MAX_M, _require, b1_mma_plan

HALF = QBLOCK // 2


def split_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] -> (x_lo, x_hi) [..., K/2], the halves of each q block:
    x_lo[..., 16 b + j] = x[..., 32 b + j], x_hi[..., 16 b + j] =
    x[..., 32 b + 16 + j] (the JAX package's q4_matmul.split_activation)."""
    lead, k = x.shape[:-1], x.shape[-1]
    xb = x.reshape(*lead, k // QBLOCK, QBLOCK)
    return (xb[..., :HALF].reshape(*lead, k // 2),
            xb[..., HALF:].reshape(*lead, k // 2))


def _rounded(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def q4_floor_plain(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """R(x_lo) @ f32(qs) with f32 accumulation (the products are exact)."""
    x_lo, _ = split_activation(x.to(torch.float32))
    return _rounded(x_lo) @ qs.to(torch.float32)


def q4_nosc_plain(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """R(x_lo) @ (qs & 15) + R(x_hi) @ (qs >> 4), f32."""
    x_lo, x_hi = split_activation(x.to(torch.float32))
    q = qs.to(torch.int32)
    return (_rounded(x_lo) @ (q & 15).to(torch.float32)
            + _rounded(x_hi) @ (q >> 4).to(torch.float32))


def _check(x: torch.Tensor, qs: torch.Tensor) -> None:
    _require(x.dim() == 2 and x.dtype == torch.float32,
             "x must be f32 [M, K]")
    _require(qs.dim() == 2 and qs.dtype == torch.uint8,
             "qs must be uint8 [K/2, N]")
    _require(x.shape[1] == 2 * qs.shape[0] and qs.shape[0] % HALF == 0,
             f"x's K={x.shape[1]} must be twice qs's {qs.shape[0]} rows, a "
             f"multiple of {QBLOCK}")
    _require(1 <= x.shape[0] <= DECODE_MAX_M,
             f"x must have 1 <= M <= {DECODE_MAX_M} rows (B1's plan)")


def _launch(x: torch.Tensor, qs: torch.Tensor, name: str) -> torch.Tensor:
    """One launch of B1's tensor-core kernel in a probe mode."""
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _require(x.is_contiguous() and qs.is_contiguous()
             and qs.device == x.device,
             "x and qs must be contiguous and on one card")
    m, k = x.shape
    kh, n = qs.shape
    _require(n % 16 == 0 and qs.data_ptr() % 16 == 0,
             "the tensor-core kernel needs N % 16 == 0 and a 16-byte "
             "aligned qs")
    nb = kh // HALF
    dev = x.device
    nt, cw, splits, per = b1_mma_plan(m, n, nb)
    tiles = -(-n // (B1_MMA_WARP_COLS * cw)) * -(-m // (8 * nt))
    partial = cuda_lib.scratch(dev, "q4_gemv.partial", splits * m * n,
                               torch.float32)
    counters = cuda_lib.tile_counters(dev, tiles)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    rc = cuda_lib.fn(name)(
        x.data_ptr(), m, k, qs.data_ptr(), n, nb, cw, splits, per, nt,
        partial.data_ptr(), counters.data_ptr(), y.data_ptr(), n,
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, name)
    return y


def q4_floor(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Kernel B13: x f32 [M <= 64, K], qs uint8 [K/2, N] -> f32 [M, N] =
    R(x_lo) @ qs. Split-K partials are added in split order (the same
    result run to run; the sum order differs from a dense matmul)."""
    _check(x, qs)
    if x.device.type == "cpu":
        return q4_floor_plain(x, qs)
    y = _launch(x, qs, "q4_floor_mma")
    q4_floor.launches += 1
    return y


cuda_lib.counted(q4_floor)


def q4_nosc(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Kernel B14: x f32 [M <= 64, K], qs uint8 [K/2, N] -> f32 [M, N] =
    R(x_lo) @ (qs & 15) + R(x_hi) @ (qs >> 4), in split order as B13."""
    _check(x, qs)
    if x.device.type == "cpu":
        return q4_nosc_plain(x, qs)
    y = _launch(x, qs, "q4_nosc_mma")
    q4_nosc.launches += 1
    return y


cuda_lib.counted(q4_nosc)
