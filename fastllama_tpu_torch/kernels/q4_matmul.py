"""4-bit matmuls: the dispatcher, five Hopper kernels and their plain versions.

Ports fastllama_tpu/kernels/q4_matmul.py. The weight is a QuantMatmulWeight
(quant/tensor.py: split-K packed nibbles [K_pad/2, N_pad], f32 scales
[K_pad/32, N_pad] and, for an affine q4_1 weight, f32 mins of the same
shape); activations are f32 [M, K] and outputs f32 [M, n_logical].

Kernels (CUDA C++ for sm_90a, sources in csrc/, built by cuda_lib; B3 and
B5 share the register-A kernel and its plan, prefill_plan):
  B1 q4_matmul_decode        csrc/q4_fold.cuh    (q4_matmul_pallas: v0's
                             function, q4_matmul_xla's; bf16 mode variant 0
                             of the fold kernel, built as q4_fold_v0.cu;
                             f32 mode variant 10, built as q4_fold_f32.cu)
  B2 quant_rows_int8         csrc/quant_rows.cu  (quant_rows_int8)
  B3 q4_matmul_prefill_int8  csrc/q4_prefill_ra.cuh (q4_matmul_prefill_int8
                             nat; the register-A kernel's int8 mode, built
                             as csrc/q4_int8.cu)
  B5 q4_matmul_prefill       csrc/q4_prefill_ra.cuh (q4_matmul_prefill_pallas
                             nat, also the affine weight's R(x) @ R(q * d +
                             m): the register-A kernel's bf16 and f32
                             modes, built as csrc/q4_prefill.cu)
  B9 q41_matmul_decode       csrc/q4_fold.cuh    (q41_matmul_pallas; bf16
                             mode variant 9 of the fold kernel, built as
                             q4_fold_v9.cu: the mins term in the fold's
                             registers; f32 mode variant 11, built as
                             q4_fold_f32.cu)

f32 mode (w_dtype float32) runs every matmul on the tensor cores with
nothing rounded: x is split into three bf16 parts whose sum is x exactly
(f32_parts), each part's product with the codes is exact, and each q
block's sum z is scaled by d in f32 (f32_model is the arithmetic in plain
PyTorch, which the tests hold against the plain versions and the JAX
bodies).

Each wrapper launches its kernel for a CUDA tensor and raises on anything it
does not take; for a CPU tensor it runs its plain PyTorch version, which the
tests hold against the JAX package and chip_smoke.py holds the kernel
against. Each wrapper counts its launches in a plain int attribute
`.launches`.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..quant.tensor import (
    QBLOCK, QuantMatmulWeight, unpack_codes, dequant_matmul_weight,
)
from . import cuda_lib

# Dispatch table (fixed; see q4_matmul).
DECODE_MAX_M = 64
PREFILL_MIN_M = 256
# q4_0 in bf16 mode at B1_ON_B5_MIN_M <= M <= 64 runs B5, which computes
# B1's function, on every plane but a square one (stored K = N: wo), which
# B5 takes from B1_ON_B5_SQUARE_MIN_M on: B5's register-A kernel (one x tile
# of 64 rows) took 0.03460, 0.05035 and 0.02991 ms against B1's 0.03531,
# 0.05613 and 0.03590 on the 7B qkv, w13 and w2 planes at M = 33 (0.0349,
# 0.0508, 0.0308 against 0.0463, 0.0750, 0.0621 at M = 64), and on wo
# 0.01731 against 0.01586 at M = 33, 0.01711 against 0.01757 at 48
# (tools_torch/prefill_sweep.py --parts b1, PERF.md; NVIDIA H100 80GB
# HBM3 at 700 W). q4_1 stays on B9 at every M <= 64: B5's affine mode
# computes another function (R(q d + m) rounded as a whole).
B1_ON_B5_MIN_M = 33
B1_ON_B5_SQUARE_MIN_M = 48
# f32 mode at F32_ON_B5_MIN_M <= M <= 64 (on a plane of stored K > N: from
# F32_ON_B5_DEEP_MIN_M) runs B5's f32 mode, q4_0 and q4_1, wherever B1 or
# B9 is called (the fold kernel's f32 modes are built to 32 rows only):
# B1's and B9's f32 modes compute the same function in f32 (nothing is
# rounded to bf16 in either), and the fold kernel's three products a k16
# step at NW > 32 make it compute-bound there: at M = 33 the fold took 1.32-1.86x B5's
# time on the 7B qkv, wo, w13 and w2 planes, at M = 64 2.4-4.3x; at M = 24
# 0.67-0.96x, but 1.02-1.07x on w2; at M <= 16 0.31-0.78x
# (tools_torch/f32_sweep.py --parts route, PERF.md; NVIDIA H100 80GB HBM3
# at 700 W)
F32_ON_B5_MIN_M = 33
F32_ON_B5_DEEP_MIN_M = 24
RECIP_127 = float(np.float32(1.0) / np.float32(127.0))   # exact in f32


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_weight(w: QuantMatmulWeight, device: torch.device,
                  affine: bool = False) -> None:
    """Validate the weight planes for a launch on `device` by a q4_0
    kernel (no mins plane) or an affine one (a mins plane shaped as the
    scales); the result is remembered on the weight (its planes are not
    replaced after loading), so each decode step does not pay for the
    checks again."""
    _require((w.mins is not None) == affine,
             "an affine (q4_1) weight needs the q4_1 kernel and a q4_0 "
             "weight the q4_0 kernels")
    if getattr(w, "_checked_on", None) == device:
        return
    _require(w.mins is None or (
        w.mins.dtype == torch.float32 and w.mins.is_contiguous()
        and w.mins.device == device and w.mins.shape == w.scales.shape),
        f"mins must be contiguous f32 [K/32, N] on {device}")
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
    """y = w_dtype(x) @ w_dtype(W) with f32 accumulation, W = (q - 8) * d
    or, for an affine weight, q * d + m.

    bf16 x bf16 products are exact in f32, so upcasting both operands and
    running an f32 matmul is the JAX dot with preferred_element_type=f32.
    The plain version of B1, B5 and the tests; no dispatch reaches it on
    the card, and `.cuda_calls` counts its calls on CUDA tensors so that a
    run can show it."""
    if x.device.type == "cuda":
        q4_matmul_dequant.cuda_calls += 1
    x2 = _pad_k(x, w.k).to(w_dtype).to(torch.float32)
    dense = dequant_matmul_weight(w, w_dtype).to(torch.float32)
    return (x2 @ dense)[:, :w.n_logical]


cuda_lib.counted(q4_matmul_dequant, "cuda_calls")


# ---------------------------------------------------------------------------
# f32 mode's arithmetic: three exact bf16 parts of x
# ---------------------------------------------------------------------------

def f32_parts(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(h, m, l), f32 tensors of bf16 values with h + m + l = x exactly for
    every finite f32 x of |x| >= 2^-110: h keeps x's upper 16 bits (8
    significant bits, truncated), m those of r = x - h (exact), l = r - m
    (exact, at most 8 significant bits: a bf16 value). Below 2^-110 l can
    need bf16 subnormals finer than 2^-133, and keeps its upper 16 bits
    only (an error under 2^-133). Truncation rather than rounding, so no
    part overflows at f32's largest values (R(3.4e38) is inf). The kernels'
    split (csrc/common.cuh f32_parts), bit for bit."""
    mask = torch.tensor(-65536, dtype=torch.int32)      # 0xFFFF0000

    def upper(t):
        return (t.contiguous().view(torch.int32) & mask).view(torch.float32)
    x = x.to(torch.float32)
    h = upper(x)
    r = x - h
    m = upper(r)
    return h, m, upper(r - m)


def f32_model(x: torch.Tensor, w: QuantMatmulWeight) -> torch.Tensor:
    """The f32-mode kernels' arithmetic in plain PyTorch (B1 and B9 on the
    fold kernel, B5 and B20 on the register-A kernel): x f32 [M, K] -> y f32
    [M, n_logical] = sum_b fma(z_b, d_b) (+ bsum_b(x) m_b for an affine
    weight), z_b = sum over x's three parts (f32_parts) of the part's q
    block b times the codes (q - 8, or q), each product exact, summed in
    f64 here (the tensor cores sum in f32), and the q blocks folded in
    order. Equal to x @ W in exact arithmetic, up to f32 sums and the one
    rounding of each weight the plain version makes."""
    kh, n = w.qs.shape
    nb = kh // (QBLOCK // 2)
    xp = _pad_k(x.to(torch.float32), w.k)
    mm = xp.shape[0]
    codes = unpack_codes(w.qs.reshape(nb, QBLOCK // 2, n), 1).to(
        torch.float64)
    if w.mins is None:
        codes = codes - 8.0
    z = sum(torch.einsum("mbj,bjn->mbn",
                         p.to(torch.float64).reshape(mm, nb, QBLOCK), codes)
            for p in f32_parts(xp)).to(torch.float32)     # [M, nb, N]
    acc = torch.zeros((mm, n), dtype=torch.float32)
    bsum = xp.reshape(mm, nb, QBLOCK).sum(-1)
    for b in range(nb):
        acc = torch.addcmul(acc, z[:, b], w.scales[b])
        if w.mins is not None:
            acc = torch.addcmul(acc, bsum[:, b:b + 1], w.mins[b])
    return acc[:, :w.n_logical]


# ---------------------------------------------------------------------------
# B1: decode-size W4A16 matmul
# ---------------------------------------------------------------------------

def _launch_gemv(x: torch.Tensor, w: QuantMatmulWeight, w_dtype,
                 affine: bool) -> torch.Tensor:
    """Checks and launch shared by B1 and B9: the fold kernel
    (q4_variants._launch_fold, on b15_plan), variant 0 (B1) or 9 (B9) in
    bf16 mode, 10 or 11 in f32 mode."""
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _check_weight(w, x.device, affine)
    m, kx = x.shape
    kh = w.qs.shape[0]
    _require(x.is_contiguous() and 1 <= m <= DECODE_MAX_M,
             f"x must be contiguous with 1 <= M <= {DECODE_MAX_M}")
    _require(kx <= kh * 2, f"x K={kx} exceeds the stored K={kh * 2}")
    variant = (9 if affine else 0) if w_dtype == torch.bfloat16 else (
        11 if affine else 10)
    return _q4v._launch_fold(x, w.qs, w.scales, variant, w.n_logical,
                             mins=w.mins)


def _check_matmul_args(x: torch.Tensor, w_dtype) -> None:
    _require(x.dim() == 2 and x.dtype == torch.float32,
             "x must be f32 [M, K]")
    _require(w_dtype in (torch.bfloat16, torch.float32),
             "w_dtype must be bfloat16 or float32")


def q4_matmul_decode(x: torch.Tensor, w: QuantMatmulWeight,
                     w_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel B1: x f32 [M <= 64, K] -> y f32 [M, n_logical].

    bf16 mode runs variant 0 of the fold kernel (csrc/q4_fold.cuh, on
    q4_variants.b15_plan: weight stages by TMA into a ring on persistent
    blocks, R((q - 8) d) dequantized into the A registers of wgmma or
    mma.sync against every row of x at once, K splits added in a thread
    block cluster; exact bf16 products); f32 mode its variant 10: the codes
    q - 8 in the A registers, x's three exact bf16 parts (f32_parts) each
    a product into a q block's z, then acc = fma(z, d, acc) (f32_model; no
    TF32, nothing rounded); at f32_on_b5's rows B5's f32 mode, the same
    function (counted by q4_matmul_prefill). Splits are added in a fixed order
    (deterministic; the sum order differs from a dense matmul, so compare
    at f32 reassociation tolerance)."""
    _check_matmul_args(x, w_dtype)
    if x.device.type == "cpu":
        _require(w.mins is None, "B1 takes q4_0 weights (no mins plane)")
        return q4_matmul_dequant(x, w, w_dtype)
    if w_dtype == torch.float32 and f32_on_b5(x.shape[0], w):
        return q4_matmul_prefill(x, w, w_dtype)
    y = _launch_gemv(x, w, w_dtype, affine=False)
    q4_matmul_decode.launches += 1
    q4_matmul_decode.f32_launches += int(w_dtype == torch.float32)
    return y


# every launch, and apart the f32 mode's (variant 10)
cuda_lib.counted(q4_matmul_decode)
cuda_lib.counted(q4_matmul_decode, "f32_launches")


# ---------------------------------------------------------------------------
# B9: decode-size affine (q4_1 / GPTQ) matmul
# ---------------------------------------------------------------------------

def q41_matmul_decode_plain(x: torch.Tensor, w: QuantMatmulWeight,
                            w_dtype=torch.bfloat16) -> torch.Tensor:
    """y = w_dtype(x) @ w_dtype(q * d) + bsum(x) @ m, where bsum is the sum
    of the UNROUNDED f32 x over each 32-block of K and its product with the
    f32 mins is a true f32 one. In bf16 mode this is more exact than
    q4_matmul_dequant, which rounds x and q * d + m as a whole."""
    kh, n = w.qs.shape
    nb = kh // (QBLOCK // 2)
    xp = _pad_k(x.to(torch.float32), w.k)
    codes = unpack_codes(w.qs.reshape(nb, QBLOCK // 2, n), 1)
    qd = (codes.to(torch.float32) * w.scales.reshape(nb, 1, n)).to(w_dtype)
    y = xp.to(w_dtype).to(torch.float32) @ qd.reshape(w.k, n).to(torch.float32)
    bsum = xp.reshape(xp.shape[0], nb, QBLOCK).sum(-1)
    return (y + bsum @ w.mins)[:, :w.n_logical]


def q41_matmul_decode(x: torch.Tensor, w: QuantMatmulWeight,
                      w_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel B9: x f32 [M <= 64, K], affine weight -> y f32 [M, n_logical]
    (q41_matmul_decode_plain's formula). bf16 mode runs variant 9 of the
    fold kernel: v1's weight R(q d) in the A registers, the mins rows
    streamed beside the scale rows and bsum(x) @ m taken in the fold's f32
    registers; f32 mode its variant 11: B1's f32 route with the codes q and
    the mins term bsum(x) m added to acc a q block (f32_model), and at
    f32_on_b5's rows B5's affine f32 mode (counted by q4_matmul_prefill)."""
    _check_matmul_args(x, w_dtype)
    _require(w.mins is not None, "B9 takes affine weights (a mins plane)")
    if x.device.type == "cpu":
        return q41_matmul_decode_plain(x, w, w_dtype)
    if w_dtype == torch.float32 and f32_on_b5(x.shape[0], w):
        return q4_matmul_prefill(x, w, w_dtype)
    y = _launch_gemv(x, w, w_dtype, affine=True)
    q41_matmul_decode.launches += 1
    q41_matmul_decode.f32_launches += int(w_dtype == torch.float32)
    return y


# every launch, and apart the f32 mode's (variant 11)
cuda_lib.counted(q41_matmul_decode)
cuda_lib.counted(q41_matmul_decode, "f32_launches")


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


cuda_lib.counted(quant_rows_int8)


# ---------------------------------------------------------------------------
# B3 and B5 (bf16 mode): the register-A kernel's plan
# ---------------------------------------------------------------------------

# The rows of x a tile (wgmma's N, template instances of
# csrc/q4_prefill_ra.cuh), the most splits of K, the fewest stages a split
# keeps (its ring fills); and the cost model's constants, fitted to
# tools_torch/prefill_sweep.py's pinned plans on the 7B planes at M = 64-512
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md): a split item's merge in stages
# (bf16 mode, int8 mode) and what a stage weighs beside the warpgroups that
# run it (its x tile and barriers are the same for 64 columns and 128).
RA_BX = (64, 96, 128, 160, 192, 224, 256)
RA_MAX_SPLITS = 8
RA_MIN_STAGES = 4
RA_MERGE_STAGES = {False: 20, True: 6}
RA_STAGE_BASE = 0.5
# f32 mode (B5 at w_dtype float32): the x tiles built (two register sets
# of BX / 2, acc and a q block's z; csrc/q4_prefill_ra.cuh body_f32);
# always two warpgroups (one z set a warpgroup: the other's products keep
# the tensor cores busy while one scales its z); a split's merge costed in
# stages, fitted to pinned plans (tools_torch/f32_sweep.py --parts pins:
# the 7B and 13B planes at M = 24-513, q4_0; of the costs 2-28, 7's plans
# took on average 1.002x each shape's fastest pinned plan, 3-5's 1.004x,
# bf16 mode's 20 1.021x, up to 1.20x; NVIDIA H100 80GB HBM3 at 700 W).
# RA_STAGE_BASE is bf16 mode's fit, not refitted.
RA_BX_F32 = (64, 96, 128)
RA_MERGE_STAGES_F32 = 7


class RaPlan(NamedTuple):
    """The register-A kernel's tiles: bx rows of x and 64 wgs weight
    columns a tile; tiles t0 .. (the rest) split into `splits` runs of K of
    `per` stages (64 deep in bf16 mode, 128 in int8 mode), the tiles before
    t0 run whole."""
    bx: int
    wgs: int
    splits: int
    per: int
    t0: int = 0


def ra_bx(m: int, f32: bool = False) -> int:
    """The rows of x a tile at M rows: M cut into ceil(M / 256) tiles as
    even as they go, rounded up to a built width (M = 65 -> 96, 300 -> two
    of 160, 513 -> three of 192); f32 mode: ceil(M / 128) tiles of at most
    128 (300 -> three of 128, 513 -> five of 128)."""
    widths = RA_BX_F32 if f32 else RA_BX
    tiles = -(-m // widths[-1])
    want = -(-m // tiles)
    return next(b for b in widths if b >= want)


def ra_item_count(tiles: int, p: RaPlan) -> int:
    """How many work items the kernel takes on plan p (len(ra_items))."""
    return tiles if p.splits == 1 else p.t0 + (tiles - p.t0) * p.splits


def ra_items(tiles: int, p: RaPlan) -> list[tuple[int, int]]:
    """The kernel's work items in order, (tile, split): tiles 0 .. t0 - 1
    whole (split 0 of 1), then the rest a split at a time."""
    if p.splits == 1:
        return [(t, 0) for t in range(tiles)]
    rest = tiles - p.t0
    return [(t, 0) for t in range(p.t0)] + [
        (p.t0 + u % rest, u // rest) for u in range(rest * p.splits)]


def ra_makespan(tiles: int, nst: int, sms: int, p: RaPlan,
                merge: int) -> int:
    """The stages the busiest persistent block runs (a split item's merge
    counted as `merge` stages) when block b takes items b, b + blocks, ...
    of ra_items."""
    items = ra_items(tiles, p)
    blocks = min(ra_item_count(tiles, p), sms)
    load = [0] * blocks
    for i, (t, z) in enumerate(items):
        if p.splits == 1 or t < p.t0:
            load[i % blocks] += nst
        else:
            load[i % blocks] += min(nst, (z + 1) * p.per) - z * p.per + merge
    return max(load)


@functools.lru_cache(maxsize=None)
def prefill_plan(m: int, n: int, kc: int, sms: int, int8: bool = False, *,
                 f32: bool = False, bx: int | None = None,
                 wgs: int | None = None, splits: int | None = None,
                 t0: int | None = None) -> RaPlan:
    """The register-A kernel's plan (B5 in bf16 mode, B3 with int8=True,
    B5 in f32 mode with f32=True) for M rows, N stored columns and the K it
    runs over (kc), on a card of `sms` SMs; keywords pin a part
    (tools_torch/prefill_sweep.py, tests). Each candidate (one or two
    warpgroups a block, f32 mode two; K whole, or split in 2 to
    RA_MAX_SPLITS runs of at least RA_MIN_STAGES stages, either for every
    tile or only for the tiles past the full rounds of whole tiles) is
    costed by its makespan (ra_makespan, a merge RA_MERGE_STAGES, f32 mode
    RA_MERGE_STAGES_F32) times wgs + RA_STAGE_BASE; ties go to the fewest
    splits, then to two warpgroups. Cached: the makespans are counted item
    by item in Python, and eager steps ask for the same few plans again and
    again."""
    bx = bx or ra_bx(m, f32)
    nst = -(-kc // (128 if int8 else 64))
    rt = -(-m // bx)
    merge = RA_MERGE_STAGES_F32 if f32 else RA_MERGE_STAGES[int8]
    best = None
    for g in (wgs,) if wgs else (2,) if f32 else (2, 1):
        tiles = rt * -(-n // (64 * g))
        for s in (splits,) if splits else range(1, RA_MAX_SPLITS + 1):
            per = -(-nst // s)
            if splits is None and s > 1 and per < RA_MIN_STAGES:
                break
            s_eff = -(-nst // per)
            if s_eff == 1:
                starts = [tiles]
            elif t0 is not None:
                starts = [t0]
            else:
                starts = sorted({0, tiles // sms * sms} - {tiles})
            for first in starts:
                p = RaPlan(bx, g, s_eff, per, first)
                key = ((g + RA_STAGE_BASE) * ra_makespan(
                    tiles, nst, sms, p, merge), s_eff, -g, -first)
                if best is None or key < best[0]:
                    best = (key, p)
    return best[1]


def _ra_scratch(dev, name: str, m: int, n: int, p: RaPlan):
    """(partial, counters, blocks) of one launch of the register-A kernel:
    f32 scratch for the split items' partial tiles (bx 64 wgs floats an
    item), the tiles' counters and the persistent grid (at most one block
    an SM)."""
    tiles = -(-m // p.bx) * -(-n // (64 * p.wgs))
    split = p.splits > 1
    partial = cuda_lib.scratch(
        dev, name, (tiles - p.t0) * p.splits * p.bx * 64 * p.wgs
        if split else 1, torch.float32)
    return (partial, cuda_lib.tile_counters(dev, tiles),
            min(ra_item_count(tiles, p), cuda_lib.sm_count(dev)))


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
                           w: QuantMatmulWeight,
                           plan: RaPlan | None = None) -> torch.Tensor:
    """Kernel B3: xq int8 [M, K_stored], dx f32 [M] -> y f32 [M, n_logical].

    Exact int32 accumulators; y = (acc * dx) * s8, the JAX order, so the
    kernel and its plain version agree bit for bit. On the card: one launch
    of the register-A kernel (csrc/q4_prefill_ra.cuh), which takes s8 from
    the whole K's scales and requantizes each weight straight into wgmma's
    A registers, on prefill_plan's tiles (`plan` pins one); no int8 weight
    plane exists anywhere."""
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
    _require(k % 32 == 0 and n % 16 == 0 and xq.data_ptr() % 16 == 0,
             "stored K must be a multiple of 32, stored N of 16 and xq "
             "16-byte aligned")
    dev = xq.device
    p = plan or prefill_plan(m, n, k, cuda_lib.sm_count(dev), int8=True)
    partial, counters, blocks = _ra_scratch(dev, "q4_int8.partial", m, n, p)
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=dev)
    rc = cuda_lib.fn("q4_int8_gemm")(
        xq.data_ptr(), dx.data_ptr(), m, k, w.qs.data_ptr(),
        w.scales.data_ptr(), n, p.bx, p.wgs, p.t0, p.splits, p.per, blocks,
        partial.data_ptr(), counters.data_ptr(), y.data_ptr(), w.n_logical,
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "q4_int8_gemm")
    q4_matmul_prefill_int8.launches += 1
    return y


cuda_lib.counted(q4_matmul_prefill_int8)


# ---------------------------------------------------------------------------
# B5: bf16 / f32 prefill matmul
# ---------------------------------------------------------------------------

# B20's split kernel (csrc/q4_prefill.cu bf16_wgmma_kernel<kSplit>) is
# built for one tile: 128 x 128 outputs, two consumer warpgroups of 64
# rows, K in 64-deep stages through a ring of 4, one persistent block an
# SM. b5_plan chooses its split of K.
B5_BM, B5_BN, B5_BK = 128, 128, 64
B5_MAX_SPLITS = 8
B5_MIN_STAGES_PER_SPLIT = 4          # the ring fills
# the cost of a split's merge (the last split of a tile reads the others'
# partial tiles) in stages, fitted to chip_smoke.py's B5 times on the H100
# (PERF.md)
B5_MERGE_STAGES = 4


def b5_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(splits, K stages per split) of B20's split kernel for M rows, N
    stored columns and the K it runs over, on a card of `sms` SMs; a stage
    is 64 deep. A split pays when the 128 x 128 tiles alone leave SMs idle
    (M <= 128: 96 tiles on the 7B qkv plane, 32 on wo). The cost is the
    rounds of the persistent blocks' items a busy SM takes times a round's
    stages, a split's merge added to each round where K is split; the
    fewest splits win a tie. Every split keeps enough stages for its
    pipeline to fill."""
    tiles = -(-m // B5_BM) * -(-n // B5_BN)
    nk = -(-k // B5_BK)
    best = None
    for s in range(1, B5_MAX_SPLITS + 1):
        per = -(-nk // s)
        if s > 1 and per < B5_MIN_STAGES_PER_SPLIT:
            break
        splits = -(-nk // per)
        rounds = -(-(tiles * splits) // sms)
        cost = rounds * (per + (splits > 1) * B5_MERGE_STAGES)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def f32_scratch_bytes(m: int, k: int, affine: bool) -> int:
    """The bytes of B5's f32-mode x scratch (csrc/q4_prefill.cu): the three
    bf16 part planes [3][M][K] and, for an affine weight, the block sums
    f32 [2 ceil(K / 64)][M rounded up to 4]."""
    return 6 * m * k + (4 * 2 * -(-k // 64) * (-(-m // 4) * 4)
                        if affine else 0)


def q4_matmul_prefill(x: torch.Tensor, w: QuantMatmulWeight,
                      w_dtype=torch.bfloat16,
                      plan: RaPlan | None = None) -> torch.Tensor:
    """Kernel B5: x f32 [M, K], q4_0 or affine (q4_1) weight -> y f32
    [M, n_logical] = w_dtype(x) @ w_dtype(W) with f32 accumulation, W =
    (q - 8) * d or q * d + m, in natural K order; a true f32 product (no
    TF32) in f32 mode. Its plain version is q4_matmul_dequant. Any M >= 1
    is taken; the dispatcher sends M > 64 without int8, and B1 and B9
    their f32 calls at f32_on_b5's rows.

    bf16 mode: x cast to bf16, then one launch of the register-A kernel
    (csrc/q4_prefill_ra.cuh: each weight dequantized straight into wgmma's
    A registers, x the B operand, on prefill_plan's tiles; `plan` pins
    one). f32 mode: x's three exact bf16 parts (and an affine weight's
    block sums) by a cast pass, then the register-A kernel in its f32 mode
    (the codes in the A registers, each part's products into a q block's
    z, z scaled by d into acc: f32_model's arithmetic) on prefill_plan's
    f32 tiles. Both split K where the tiles alone leave SMs idle and add
    the splits in order."""
    _check_matmul_args(x, w_dtype)
    if x.device.type == "cpu":
        return q4_matmul_dequant(x, w, w_dtype)
    y = _launch_b5(x, w, w_dtype, plan)
    q4_matmul_prefill.launches += 1
    q4_matmul_prefill.f32_launches += int(w_dtype == torch.float32)
    return y


def _launch_b5(x, w, w_dtype, plan=None):
    """One launch of B5 on the card (on `plan` where given: prefill_plan's
    with f32=True in f32 mode)."""
    _require(x.device.type == "cuda" and x.is_contiguous()
             and x.data_ptr() % 16 == 0,
             "x must be a contiguous, 16-byte aligned CUDA tensor")
    affine = w.mins is not None
    _check_weight(w, x.device, affine)
    m, kx = x.shape
    n = w.qs.shape[1]
    k = w.k
    planes = (w.qs, w.scales, w.mins) if affine else (w.qs, w.scales)
    _require(m >= 1 and kx <= k and kx % 4 == 0,
             f"x K={kx} must be a multiple of 4 and <= the stored K={k}")
    _require(k % 32 == 0 and n % 16 == 0
             and all(p.data_ptr() % 16 == 0 for p in planes),
             "stored K must be a multiple of 32, stored N of 16 and the "
             "weight planes 16-byte aligned")
    dev = x.device
    sms = cuda_lib.sm_count(dev)
    kc = -(-kx // 32) * 32
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=dev)
    bf16 = w_dtype == torch.bfloat16
    p = plan or prefill_plan(m, n, kc, sms, f32=not bf16)
    partial, counters, blocks = _ra_scratch(dev, "q4_prefill.partial", m, n,
                                            p)
    xb = cuda_lib.scratch(dev, "q4_prefill.xb", m * k * 2 if bf16
                          else f32_scratch_bytes(m, k, affine), torch.uint8)
    rc = cuda_lib.fn("q4_prefill_gemm")(
        x.data_ptr(), m, kx, w.qs.data_ptr(), w.scales.data_ptr(),
        w.mins.data_ptr() if affine else None, n, k, xb.data_ptr(), p.bx,
        p.wgs, p.t0, p.splits, p.per, blocks, partial.data_ptr(),
        counters.data_ptr(), y.data_ptr(), w.n_logical, int(bf16),
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "q4_prefill_gemm")
    return y


# every launch, and apart the f32 mode's
cuda_lib.counted(q4_matmul_prefill)
cuda_lib.counted(q4_matmul_prefill, "f32_launches")


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

def b1_on_b5(m: int, w: QuantMatmulWeight) -> bool:
    """Whether B1's call at M rows on w (q4_0, bf16 mode) runs B5 in its
    place: at M >= B1_ON_B5_MIN_M, on a plane of stored K = N at M >=
    B1_ON_B5_SQUARE_MIN_M."""
    square = 2 * w.qs.shape[0] == w.qs.shape[1]
    return m >= (B1_ON_B5_SQUARE_MIN_M if square else B1_ON_B5_MIN_M)


def f32_on_b5(m: int, w: QuantMatmulWeight) -> bool:
    """Whether a call at M <= 64 rows on w in f32 mode (q4_0 or q4_1) runs
    B5's f32 mode in B1's or B9's place: at M >= F32_ON_B5_MIN_M, on a
    plane of stored K > N at M >= F32_ON_B5_DEEP_MIN_M."""
    deep = 2 * w.qs.shape[0] > w.qs.shape[1]
    return m >= (F32_ON_B5_DEEP_MIN_M if deep else F32_ON_B5_MIN_M)


def use_int8(m: int, w_dtype, prefill_int8: bool | None,
             use_pallas: bool | None = None) -> bool:
    """The int8 prefill path for a q4_0 weight at M rows, with the JAX
    package's precedence: at M >= PREFILL_MIN_M, (1) an explicit
    prefill_int8; else (2) FASTLLAMA_PREFILL_INT8 if it is set ("1" forces
    int8, any other value pins it off); else (3) the default, on in bf16
    mode only, and only while use_pallas is not False and
    FASTLLAMA_PREFILL_KERNEL is not "0" (the JAX package's escape hatches
    from its kernels, which keep the bf16-exact function)."""
    if m < PREFILL_MIN_M:
        return False
    if prefill_int8 is not None:
        return prefill_int8
    forced = os.environ.get("FASTLLAMA_PREFILL_INT8")
    if forced is not None:
        return forced == "1"
    return (w_dtype != torch.float32 and use_pallas is not False
            and os.environ.get("FASTLLAMA_PREFILL_KERNEL", "1") != "0")


def q4_matmul(x: torch.Tensor, w: QuantMatmulWeight, *,
              w_dtype=torch.bfloat16,
              prefill_int8: bool | None = None,
              use_pallas: bool | None = None) -> torch.Tensor:
    """x [..., K_logical] -> [..., n_logical] f32, chosen by the weight and
    M = prod(lead):

      q4_0, M <= 64                      -> B1 q4_matmul_decode (bf16 mode
                                            at M >= B1_ON_B5_MIN_M, on a
                                            square plane at M >=
                                            B1_ON_B5_SQUARE_MIN_M: B5)
      q4_1, M <= 64                      -> B9 q41_matmul_decode
      (f32 mode, q4_0 and q4_1, at M >= F32_ON_B5_MIN_M, on a plane of
      stored K > N at M >= F32_ON_B5_DEEP_MIN_M: B5, f32_on_b5, chosen in
      B1's and B9's wrappers)
      q4_0, M >= 256 and int8 (use_int8) -> B2 quant_rows_int8 + B3
      every other M > 64: q4_0 at 64 < M < 256, q4_0 at M >= 256 without
      int8, q4_1 at M > 64               -> B5 q4_matmul_prefill

    B5 at 64 < M < 256 and for q4_1 keeps the reference's function: there
    the JAX package runs q4_matmul_xla, R(x) @ R(W) with f32 accumulation,
    which is B5's (W = (q - 8) * d, or q * d + m for q4_1; the JAX package
    never sends q4_1 to int8, nor does the port). B1 in bf16 mode is variant
    0 of the fold kernel and B9 its variant 9 (csrc/q4_fold.cuh); B5 takes
    B1's calls where it is faster (b1_on_b5). On the H100 B5 is faster
    than the dequant path (q4_matmul_dequant, dequant + torch.matmul) at
    every M and plane timed, in both modes (PERF.md, the B5 table). On the
    CPU B5 runs its plain version, which is that dequant path, so every CPU
    result is the one before.

    use_pallas is the JAX package's switch between its Pallas kernels and
    q4_matmul_xla, and selects the same functions here (all on kernels):
      None  the table above (B1 computes q4_matmul_xla's function);
      False q4_matmul_xla's function at every M: q4_0 at M <= 64 on B1
            (or B5, as above), q4_1 at every M and q4_0 at M > 64 on B5,
            and int8 only where
            prefill_int8 or FASTLLAMA_PREFILL_INT8=1 forces it (B2 + B3);
      True  the Pallas decode kernel's function at M <= 64 for q4_0 in
            bf16 mode, v1's folded offset (q4_variants.q4_decode_v1, B15);
            the table above otherwise.
    The default None is a knowing mix of the JAX package's two backends:
    at M <= 64 the function its CPU computes (q4_matmul_xla's, on B1), at
    M >= 256 in bf16 mode the int8 function its TPU computes (B2 + B3).
    The TPU's decode function, v1's fold (B15), rounds the same exact
    product in another order: the two sit within 1e-2 of max |y| of each
    other (about 5e-3 to 7e-3 at K = 1024 and 4096, M = 1 and 8); the
    default keeps B1's function (tests/test_torch_q4_variants.py holds the
    bound against the JAX v1 body), a choice of function and not of speed:
    PERF.md times both kernels on the H100.
    The environment switches (use_int8) are read when a step runs eagerly
    or is captured, as the JAX package reads them when it traces.

    The stored-K padding of the weight is handled inside (x counts as zero
    there) and outputs have the logical width."""
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    x2 = x.reshape(m, x.shape[-1]).to(torch.float32).contiguous()
    affine = w.mins is not None
    bf16 = w_dtype == torch.bfloat16
    if m <= DECODE_MAX_M and not (affine and use_pallas is False):
        if use_pallas and not affine and bf16:
            y = _q4v.q4_decode_v1(x2, w.qs, w.scales, w.n_logical)
        elif not affine and bf16 and b1_on_b5(m, w):
            y = q4_matmul_prefill(x2, w, w_dtype)
        else:
            y = (q41_matmul_decode if affine else q4_matmul_decode)(
                x2, w, w_dtype)
    elif not affine and use_int8(m, w_dtype, prefill_int8, use_pallas):
        xq, dx = quant_rows_int8(x2, w.k)
        y = q4_matmul_prefill_int8(xq, dx, w)
    else:
        y = q4_matmul_prefill(x2, w, w_dtype)
    return y.reshape(*lead, w.n_logical)


# the fold kernel's plan and launch (q4_variants imports this module, so it
# comes last)
from . import q4_variants as _q4v  # noqa: E402
