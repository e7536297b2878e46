"""4-bit matmuls: the dispatcher, five Hopper kernels and their plain versions.

Ports fastllama_tpu/kernels/q4_matmul.py. The weight is a QuantMatmulWeight
(quant/tensor.py: split-K packed nibbles [K_pad/2, N_pad], f32 scales
[K_pad/32, N_pad] and, for an affine q4_1 weight, f32 mins of the same
shape); activations are f32 [M, K] and outputs f32 [M, n_logical].

Kernels (CUDA C++ for sm_90a, sources in csrc/, built by cuda_lib):
  B1 q4_matmul_decode        csrc/q4_decode.cu   (q4_matmul_pallas v1;
                             tensor cores in bf16 mode, FFMA in f32 mode)
  B2 quant_rows_int8         csrc/quant_rows.cu  (quant_rows_int8)
  B3 q4_matmul_prefill_int8  csrc/q4_int8.cu     (q4_matmul_prefill_int8 nat)
  B5 q4_matmul_prefill       csrc/q4_prefill.cu  (q4_matmul_prefill_pallas nat;
                             also the affine weight's R(x) @ R(q * d + m))
  B9 q41_matmul_decode       csrc/q4_decode.cu   (q41_matmul_pallas; B1's
                             tensor-core kernel with the mins term in bf16
                             mode, FFMA in f32 mode)

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

from ..quant.tensor import (
    QBLOCK, QuantMatmulWeight, unpack_codes, dequant_matmul_weight,
)
from . import cuda_lib

# Dispatch table (fixed; see q4_matmul).
DECODE_MAX_M = 64
PREFILL_MIN_M = 256
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


q4_matmul_dequant.cuda_calls = 0


# ---------------------------------------------------------------------------
# B1: decode-size W4A16 matmul
# ---------------------------------------------------------------------------

def _b1_tile(m: int) -> tuple[int, int]:
    """(rows, columns) of one block of the FFMA kernel (B1 in f32 mode, B9)
    for M rows."""
    return (1, 256) if m == 1 else (4, 256) if m <= 4 else (16, 128)


def _splitk(m: int, n: int, nb: int) -> tuple[int, int]:
    """(splits, q blocks per split) for the FFMA kernel's tiles (1, 4 or 16
    rows by 256, 256 or 128 columns, see csrc/q4_decode.cu): about 4 blocks
    per SM of the H100 (132 SMs), at least one q block per warp (8) and at
    most 32 q blocks of x staged per block."""
    rows, cols = _b1_tile(m)
    tiles = -(-n // cols) * -(-m // rows)
    per = -(-nb // max(1, -(-528 // tiles)))
    per = min(32, max(per, min(8, nb)))
    return -(-nb // per), per


# B1 and B9 in bf16 mode (the tensor-core kernel, q4_gemv_mma and
# q41_gemv_mma): 4 warps per block, each owning 64 columns; cw column groups
# of 4 / cw warps per block
B1_MMA_WARPS = 4
B1_MMA_WARP_COLS = 64
B1_MMA_TARGET_BLOCKS = 792       # 6 per SM of the H100 (132 SMs) ...
B1_MMA_MIN_BLOCKS = 660          # ... and at least 5 per SM
B1_MMA_MAX_SPLITS = 8


def b1_mma_plan(m: int, n: int, nb: int) -> tuple[int, int, int, int]:
    """(n-tiles, column groups cw, splits, q blocks per split) of the
    tensor-core B1 and B9 for M rows, N stored columns and nb q blocks. A
    block takes 8 * n-tiles rows (1 n-tile for M <= 8, 2 for M <= 16, else 4:
    32-row tiles) and 64 * cw columns. Splits aim at 6 blocks per SM (at
    most 8); the widest cw (4, 2, 1) that reaches 5 wins, so a narrow plane
    splits K among the warps of a block rather than across many blocks; the
    staged x slice (q blocks per split * n-tiles * 512 bytes) stays within
    32 KB. B9's larger stage (the mins beside the scales: 28 KB of ring
    per block instead of 24) and its block sums (at most 2 KB) leave the
    plan as it is: the blocks per SM it aims at still fit."""
    nt = 1 if m <= 8 else 2 if m <= 16 else 4
    row_tiles = -(-m // (8 * nt))
    cap = 64 // nt
    for cw in (4, 2, 1):
        tiles = -(-n // (B1_MMA_WARP_COLS * cw)) * row_tiles
        splits = min(B1_MMA_MAX_SPLITS,
                     max(1, -(-B1_MMA_TARGET_BLOCKS // tiles)))
        per = min(cap, -(-nb // splits))
        splits = -(-nb // per)
        if tiles * splits >= B1_MMA_MIN_BLOCKS or cw == 1:
            return nt, cw, splits, per
    raise AssertionError("unreachable")


def _launch_gemv(x: torch.Tensor, w: QuantMatmulWeight, w_dtype,
                 affine: bool) -> torch.Tensor:
    """Checks and launch shared by B1 (q4_gemv_mma in bf16 mode, q4_gemv in
    f32 mode) and B9 (q41_gemv_mma in bf16 mode, q41_gemv in f32 mode)."""
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _check_weight(w, x.device, affine)
    m, kx = x.shape
    kh, n = w.qs.shape
    nb = kh // (QBLOCK // 2)
    _require(x.is_contiguous() and 1 <= m <= DECODE_MAX_M,
             f"x must be contiguous with 1 <= M <= {DECODE_MAX_M}")
    _require(kx <= kh * 2, f"x K={kx} exceeds the stored K={kh * 2}")
    _require(n % 8 == 0, "stored N must be a multiple of 8")
    dev = x.device
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=dev)
    planes = (w.qs, w.scales, w.mins) if affine else (w.qs, w.scales)
    if w_dtype == torch.bfloat16:
        _require(n % 16 == 0 and all(p.data_ptr() % 16 == 0 for p in planes),
                 "the tensor-core kernel needs N % 16 == 0 and 16-byte "
                 "aligned weight planes")
        nt, cw, splits, per = b1_mma_plan(m, n, nb)
        tiles = -(-n // (B1_MMA_WARP_COLS * cw)) * -(-m // (8 * nt))
        name = "q41_gemv_mma" if affine else "q4_gemv_mma"
        plan, mode = (cw, splits, per, nt), ()
    else:
        splits, per = _splitk(m, n, nb)
        rows, cols = _b1_tile(m)
        tiles = -(-n // cols) * -(-m // rows)
        name = "q41_gemv" if affine else "q4_gemv"
        plan, mode = (splits, per), (0,)          # f32 mode: nothing rounded
    partial = cuda_lib.scratch(dev, "q4_gemv.partial", splits * m * n,
                               torch.float32)
    counters = cuda_lib.tile_counters(dev, tiles)
    rc = cuda_lib.fn(name)(
        x.data_ptr(), m, kx, *(p.data_ptr() for p in planes), n, nb, *plan,
        partial.data_ptr(), counters.data_ptr(), y.data_ptr(), w.n_logical,
        *mode, cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, name)
    return y


def _check_matmul_args(x: torch.Tensor, w_dtype) -> None:
    _require(x.dim() == 2 and x.dtype == torch.float32,
             "x must be f32 [M, K]")
    _require(w_dtype in (torch.bfloat16, torch.float32),
             "w_dtype must be bfloat16 or float32")


def q4_matmul_decode(x: torch.Tensor, w: QuantMatmulWeight,
                     w_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel B1: x f32 [M <= 64, K] -> y f32 [M, n_logical].

    bf16 mode runs the tensor-core kernel (mma.sync bf16, exact products);
    f32 mode runs the FFMA kernel, since the tensor cores have no exact f32
    product (TF32 would round the operands): a dispatch by w_dtype, not a
    fallback. Split-K partials are added by the last block of each output
    tile in a fixed order (deterministic; the sum order differs from a dense
    matmul, so compare at f32 reassociation tolerance)."""
    _check_matmul_args(x, w_dtype)
    if x.device.type == "cpu":
        _require(w.mins is None, "B1 takes q4_0 weights (no mins plane)")
        return q4_matmul_dequant(x, w, w_dtype)
    y = _launch_gemv(x, w, w_dtype, affine=False)
    q4_matmul_decode.launches += 1
    return y


q4_matmul_decode.launches = 0


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
    (q41_matmul_decode_plain's formula). bf16 mode runs B1's tensor-core
    kernel with the mins term added to its accumulators, f32 mode the FFMA
    kernel, as B1 does (a dispatch by w_dtype, not a fallback)."""
    _check_matmul_args(x, w_dtype)
    _require(w.mins is not None, "B9 takes affine weights (a mins plane)")
    if x.device.type == "cpu":
        return q41_matmul_decode_plain(x, w, w_dtype)
    y = _launch_gemv(x, w, w_dtype, affine=True)
    q41_matmul_decode.launches += 1
    return y


q41_matmul_decode.launches = 0


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


# B3's product variants (`tile` of csrc/q4_int8.cu): the output columns of
# a 128-row tile, one block an SM
B3_BM = 128
B3_TILES = (256, 128)


def b3_plan(m: int, n: int, sms: int) -> int:
    """The product variant (an index into B3_TILES) for M rows and N stored
    columns on a card of `sms` SMs: the fewest waves of tiles, each wave
    weighed by its tile's width (a tile's time follows its operations); a
    tie takes 256 columns, which reads the activations half as often."""
    def cost(i):
        tiles = -(-m // B3_BM) * -(-n // B3_TILES[i])
        return -(-tiles // sms) * B3_TILES[i]
    return min(range(len(B3_TILES)), key=cost)


def q4_matmul_prefill_int8(xq: torch.Tensor, dx: torch.Tensor,
                           w: QuantMatmulWeight) -> torch.Tensor:
    """Kernel B3: xq int8 [M, K_stored], dx f32 [M] -> y f32 [M, n_logical].

    Exact int32 accumulators; y = (acc * dx) * s8, the JAX order, so the
    kernel and its plain version agree bit for bit. On the card: a
    requantization pass (s8 and the [N, K] int8 plane into scratch), then
    the product over that plane on wgmma fed by TMA."""
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
    _require(k % 64 == 0 and n % 4 == 0,
             "stored K must be a multiple of 64 and stored N of 4")
    dev = xq.device
    s8 = cuda_lib.scratch(dev, "q4_int8.s8", n, torch.float32)
    w8t = cuda_lib.scratch(dev, "q4_int8.w8t", n * k, torch.int8)
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=dev)
    rc = cuda_lib.fn("q4_int8_gemm")(
        xq.data_ptr(), dx.data_ptr(), m, k, w.qs.data_ptr(),
        w.scales.data_ptr(), n, s8.data_ptr(), w8t.data_ptr(), y.data_ptr(),
        w.n_logical, b3_plan(m, n, cuda_lib.sm_count(dev)),
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "q4_int8_gemm")
    q4_matmul_prefill_int8.launches += 1
    return y


q4_matmul_prefill_int8.launches = 0


# ---------------------------------------------------------------------------
# B5: bf16 / f32 prefill matmul
# ---------------------------------------------------------------------------

# B5's kernels (csrc/q4_prefill.cu) are built for one tile: 128 x 128
# outputs; bf16 mode: two consumer warpgroups of 64 rows, K in 64-deep
# stages through a ring of 4, one persistent block an SM; f32 mode: K in
# 32-deep steps (one q block), two blocks an SM. The plan chooses the
# split of K.
B5_BM, B5_BN, B5_BK, B5_F32_BK = 128, 128, 64, 32
B5_MAX_SPLITS = 8
B5_MIN_STAGES_PER_SPLIT = 4          # bf16: the ring fills
B5_MIN_STEPS_PER_SPLIT = 8           # f32
# the cost of a split's merge (the last split of a tile reads the others'
# partial tiles) in the mode's stages, fitted to chip_smoke.py's B5 times
# on the H100 (PERF.md)
B5_MERGE_STAGES = 4
B5_F32_MERGE_STEPS = 1


def b5_plan(m: int, n: int, k: int, sms: int,
            f32: bool = False) -> tuple[int, int]:
    """(splits, K stages per split) of B5 for M rows, N stored columns and
    the K it runs over, on a card of `sms` SMs; a stage is 64 deep in bf16
    mode and 32 in f32 mode. A split pays when the 128 x 128 tiles alone
    leave SMs idle (M <= 128: 96 tiles on the 7B qkv plane, 32 on wo). The
    cost is the rounds of work a busy SM takes (bf16: the persistent
    blocks' items, f32: blocks, one at a time at the FFMA rate) times a
    round's stages, a split's merge added to each round where K is split;
    the fewest splits win a tie. Every split keeps enough stages for its
    pipeline to fill."""
    tiles = -(-m // B5_BM) * -(-n // B5_BN)
    nk = -(-k // (B5_F32_BK if f32 else B5_BK))
    least = B5_MIN_STEPS_PER_SPLIT if f32 else B5_MIN_STAGES_PER_SPLIT
    best = None
    for s in range(1, B5_MAX_SPLITS + 1):
        per = -(-nk // s)
        if s > 1 and per < least:
            break
        splits = -(-nk // per)
        rounds = -(-(tiles * splits) // sms)
        if f32:
            cost = rounds * per + (splits > 1) * B5_F32_MERGE_STEPS
        else:
            cost = rounds * (per + (splits > 1) * B5_MERGE_STAGES)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def q4_matmul_prefill(x: torch.Tensor, w: QuantMatmulWeight,
                      w_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel B5: x f32 [M, K], q4_0 or affine (q4_1) weight -> y f32
    [M, n_logical] = w_dtype(x) @ w_dtype(W) with f32 accumulation, W =
    (q - 8) * d or q * d + m, in natural K order; a true f32 product (no
    TF32) in f32 mode. Its plain version is q4_matmul_dequant. Any M >= 1
    is taken; the dispatcher sends M > 64 without int8.

    bf16 mode: x cast to bf16, then one persistent wgmma product whose
    weight tiles are dequantized in shared memory. f32 mode: an FFMA tile
    that dequantizes in shared memory too. Both split K where the tiles
    alone leave SMs idle (b5_plan) and add the splits in order."""
    _check_matmul_args(x, w_dtype)
    if x.device.type == "cpu":
        return q4_matmul_dequant(x, w, w_dtype)
    y = _launch_b5(x, w, w_dtype)
    q4_matmul_prefill.launches += 1
    return y


def _launch_b5(x, w, w_dtype, blocks=None):
    """One launch of B5 on the card; `blocks` overrides the bf16 kernel's
    persistent grid (at most one block an SM; tools_torch/b5_sweep.py
    launches one block a work item beside it)."""
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
    bf16 = w_dtype == torch.bfloat16
    sms = cuda_lib.sm_count(dev)
    splits, k_steps = b5_plan(m, n, -(-kx // 32) * 32, sms, f32=not bf16)
    tiles = -(-m // B5_BM) * -(-n // B5_BN)
    xb = cuda_lib.scratch(dev, "q4_prefill.xb", m * k if bf16 else 1,
                          torch.bfloat16)
    partial = cuda_lib.scratch(
        dev, "q4_prefill.partial",
        tiles * splits * B5_BM * B5_BN if splits > 1 else 1, torch.float32)
    counters = cuda_lib.tile_counters(dev, tiles)
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=dev)
    rc = cuda_lib.fn("q4_prefill_gemm")(
        x.data_ptr(), m, kx, w.qs.data_ptr(), w.scales.data_ptr(),
        w.mins.data_ptr() if affine else None, n, k, xb.data_ptr(), splits,
        k_steps, blocks or min(tiles * splits, sms), partial.data_ptr(),
        counters.data_ptr(), y.data_ptr(), w.n_logical, int(bf16),
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "q4_prefill_gemm")
    return y


q4_matmul_prefill.launches = 0


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
    """x [..., K_logical] -> [..., n_logical] f32, chosen by the weight and
    M = prod(lead):

      q4_0, M <= 64                      -> B1 q4_matmul_decode
      q4_1, M <= 64                      -> B9 q41_matmul_decode
      q4_0, M >= 256 and int8 (use_int8) -> B2 quant_rows_int8 + B3
      every other M > 64: q4_0 at 64 < M < 256, q4_0 at M >= 256 without
      int8, q4_1 at M > 64               -> B5 q4_matmul_prefill

    B5 at 64 < M < 256 and for q4_1 keeps the reference's function: there
    the JAX package runs q4_matmul_xla, R(x) @ R(W) with f32 accumulation,
    which is B5's (W = (q - 8) * d, or q * d + m for q4_1; the JAX package
    never sends q4_1 to int8, nor does the port). On the H100 B5 is faster
    than the dequant path (q4_matmul_dequant, dequant + torch.matmul) at
    every M and plane timed, in both modes (PERF.md, the B5 table). On the
    CPU B5 runs its plain version, which is that dequant path, so every CPU
    result is the one before.

    The stored-K padding of the weight is handled inside (x counts as zero
    there) and outputs have the logical width."""
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    x2 = x.reshape(m, x.shape[-1]).to(torch.float32).contiguous()
    affine = w.mins is not None
    if m <= DECODE_MAX_M:
        y = (q41_matmul_decode if affine else q4_matmul_decode)(x2, w, w_dtype)
    elif not affine and use_int8(m, w_dtype, prefill_int8):
        xq, dx = quant_rows_int8(x2, w.k)
        y = q4_matmul_prefill_int8(xq, dx, w)
    else:
        y = q4_matmul_prefill(x2, w, w_dtype)
    return y.reshape(*lead, w.n_logical)
