"""B13 and B14: two probes of the decode matmul kernel's skeleton.

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

On the card both run the decode kernel of B15-B18 (csrc/q4_fold.cuh, its
variants 13 and 14, built together as csrc/q4_fold_probe.cu) on B15's plan
at f32 scales (q4_variants.b15_plan, or a pinned `plan`): its persistent
clusters, its TMA rings of the packed rows and of x, its x warps and its
cluster merge, with no scale plane, no fold and no block sums. B13 puts
the whole byte into the A registers and takes one k16 step a q block; B14
the codes, two steps. So the gaps between B13, B14 and B15
(q4_variants.q4_decode_v1) split B15's time into the skeleton (with one
step of products), the unpack and second step, and the scales with the
fold. Each wrapper launches its kernel for a CUDA tensor and raises on
anything it does not take; for a CPU tensor it runs its plain version.
Each counts its launches in `.launches`.
"""
from __future__ import annotations

import torch

from ..quant.tensor import QBLOCK
from . import cuda_lib
from . import q4_variants as qv
from .q4_matmul import _require

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
    _require(1 <= x.shape[0] <= qv.B15_MAX_M,
             f"x must have 1 <= M <= {qv.B15_MAX_M} rows (B15's plan)")


def q4_floor(x: torch.Tensor, qs: torch.Tensor,
             plan: qv.B15Plan | None = None) -> torch.Tensor:
    """Kernel B13: x f32 [M <= 64, K], qs uint8 [K/2, N] -> f32 [M, N] =
    R(x_lo) @ qs, on B15's plan at f32 scales (or `plan`; the CPU ignores
    it). Split-K partials are added in split order (the same result run to
    run; the sum order differs from a dense matmul)."""
    _check(x, qs)
    if x.device.type == "cpu":
        return q4_floor_plain(x, qs)
    y = qv._launch_fold(x, qs, None, 13, qs.shape[1], plan)
    q4_floor.launches += 1
    return y


cuda_lib.counted(q4_floor)


def q4_nosc(x: torch.Tensor, qs: torch.Tensor,
            plan: qv.B15Plan | None = None) -> torch.Tensor:
    """Kernel B14: x f32 [M <= 64, K], qs uint8 [K/2, N] -> f32 [M, N] =
    R(x_lo) @ (qs & 15) + R(x_hi) @ (qs >> 4), on B13's plan, in split
    order as B13."""
    _check(x, qs)
    if x.device.type == "cpu":
        return q4_nosc_plain(x, qs)
    y = qv._launch_fold(x, qs, None, 14, qs.shape[1], plan)
    q4_nosc.launches += 1
    return y


cuda_lib.counted(q4_nosc)
