"""The q4 matmul variants: the JAX package's q4_matmul_pallas(variant=),
q4_matmul_prefill_pallas(variant=) and q4_matmul_prefill_int8(variant=) on
raw weight planes, as its variant tools call them
(tools/profile_q4_variants.py, tools/bench_kernels.py,
tools/bench_q4_floor.py).

Each body of the JAX package maps onto one Hopper kernel by the function it
computes. Decode bodies, x f32 [M <= 64, K], qs uint8 [K/2, N] (split-K
packed), d f32 or bf16 [K/32, N]; R rounds to bf16 and bsum(x) is the f32
sum of the unrounded x over each 32-block of K:

  v0          R(x) @ R((q - 8) d)                    B1  (q4_matmul_decode)
  v1, v4, v5  R(x) @ R(q d) - 8 bsum(x) @ d          B15 q4_decode_v1
  v2          sum_b d_b (R(x_b) @ q_b) - 8 bsum @ d  B16 q4_decode_v2
  v3          R(x) @ R(q R(d)) - 8 bsum(x) @ d       B17 q4_decode_v3
  v7          R(x) @ R(q d) - 8 bsum7 @ d            B18 q4_decode_v7

B1 and B15-B18 run one kernel built for Hopper (csrc/q4_fold.cuh, one
build a variant, on b15_plan: persistent blocks in clusters along K, weight
stages by TMA, wgmma with the weight in registers), B1 as its variant 0
(and B9, q4_1's decode matmul, as its variant 9; B1 and B9 in f32 mode as
its variants 10 and 11).

where x_b, q_b are the 32 columns of x and rows of the codes of q block b,
and bsum7 sums R(R(x_lo) + R(x_hi)) in f32 over the 16 pairs of a block
(x_lo, x_hi: its low and high halves). v4 and v5 are bit-equal to v1 in
the JAX package, so they map onto B15 (tests/test_torch_q4_variants.py
holds the identity). The "h" forms of the tools pass bf16 scales: the same
functions on f32(d), which the kernels read as 2-byte values. In f32 mode
(w_dtype float32) nothing is rounded to bf16, so every decode variant is
x @ ((q - 8) d) in exact arithmetic and the variants differ only in f32
rounding: f32 mode runs B1's f32 mode (the fold kernel's variant 10) for
each of them, with f32 scales.

Prefill bodies, x f32 [M, K]:
  int8 nat, natp   B2 + B3 (q4_matmul.quant_rows_int8 and
                   q4_matmul_prefill_int8); natp is bit-equal to nat
  int8 natx, split B2 + B19 q4_prefill_int8_natx (bit-equal to each
                   other; one cluster kernel, csrc/q4_int8.cu)
  bf16 nat         B5 (q4_matmul.q4_matmul_prefill)
  bf16 split       B20 q4_prefill_split: R(x) @ R(q d) - 8 bsum(x) @ d,
                   v1's function at M <= 512 (decode_plain's v1 is its
                   plain version); the cast pass and one product kernel
                   with the fold on the tensor cores (csrc/q4_prefill.cu).
                   In f32 mode the split body is x @ ((q - 8) d) in exact
                   arithmetic, so it runs B5's f32 mode (as the decode
                   variants run B1's), at every M

Each wrapper launches its kernel for a CUDA tensor and raises on anything it
does not take; for a CPU tensor it runs its plain version, which the tests
hold against the JAX bodies in Pallas interpret mode and chip_smoke.py holds
the kernel against. Each counts its launches in `.launches`.
"""
from __future__ import annotations

import itertools
from typing import Callable, NamedTuple

import torch

from ..quant.tensor import QBLOCK, QuantMatmulWeight, unpack_codes
from . import cuda_lib
from . import q4_matmul as qm

HALF = QBLOCK // 2
DECODE_VARIANTS = ("v0", "v1", "v2", "v3", "v4", "v5", "v7")
INT8_VARIANTS = ("nat", "natp", "natx", "split")
# the kernel of each decode body in bf16 mode: B15-B18 their variant of
# csrc/q4_fold.cuh (built one a variant: FOLD_ENTRY); v0 (and v0h, its
# 2-byte scales) is B1, the kernel's variant 0
FOLD_VARIANT = {"v1": 1, "v4": 1, "v5": 1, "v2": 2, "v3": 3, "v7": 7}
# the entry of each variant's build; also B1 and B9 (kernels/q4_matmul.py)
# as variants 0 and 9 and in f32 mode as 10 and 11 (one build of both,
# csrc/q4_fold_f32.cu), and the probes B13 and B14 (kernels/q4_floor.py) as
# 13 and 14, one build of both (csrc/q4_fold_probe.cu) that reads no scales
FOLD_ENTRY = {0: "q4_fold_v0_gemm", 1: "q4_fold_gemm", 2: "q4_fold_v2_gemm",
              3: "q4_fold_v3_gemm", 7: "q4_fold_v7_gemm",
              9: "q4_fold_v9_gemm", 10: "q4_fold_f32_gemm",
              11: "q4_fold_f32a_gemm", 13: "q4_fold_floor_gemm",
              14: "q4_fold_nosc_gemm"}
# the variants that read a mins plane (B9, both modes) and the f32 modes
MINS_VARIANTS = (9, 11)
F32_VARIANTS = (10, 11)


def _rounded(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _codes(qs: torch.Tensor) -> torch.Tensor:
    """The codes 0..15 as f32 [K, N] in natural K order."""
    kh, n = qs.shape
    nb = kh // HALF
    return unpack_codes(qs.reshape(nb, HALF, n), 1).reshape(
        nb * QBLOCK, n).to(torch.float32)


def _block_sums(x: torch.Tensor) -> torch.Tensor:
    """bsum(x): f32 [M, K/32], the unrounded x summed over each q block."""
    return x.reshape(x.shape[0], -1, QBLOCK).sum(-1)


def _pair_sums(x: torch.Tensor) -> torch.Tensor:
    """bsum7(x): f32 [M, K/32], R(R(x_lo) + R(x_hi)) summed over the 16
    pairs of each q block (v7's block sums)."""
    xb = x.reshape(x.shape[0], -1, QBLOCK)
    return _rounded(_rounded(xb[..., :HALF]) + _rounded(xb[..., HALF:])
                    ).sum(-1)


def decode_plain(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor,
                 variant: str, w_dtype=torch.bfloat16) -> torch.Tensor:
    """The function of decode body `variant` (module docstring): x f32 [M,
    K <= K_stored] -> f32 [M, N]; x counts as zero past its K. In f32 mode
    every variant is this module's v0 in f32, B1's f32 function."""
    _require_variant(variant)
    k = qs.shape[0] * 2
    xf = qm._pad_k(x.to(torch.float32), k)
    d = scales.to(torch.float32)
    nb = d.shape[0]
    codes = _codes(qs)                                   # [K, N]
    d_rep = d.repeat_interleave(QBLOCK, dim=0)           # [K, N]
    if w_dtype == torch.float32:
        variant = "v0"
    if variant == "v0":
        w = (codes - 8.0) * d_rep
        if w_dtype != torch.float32:
            w, xf = _rounded(w), _rounded(xf)
        return xf @ w
    corr = -8.0 * ((_pair_sums(xf) if variant == "v7" else _block_sums(xf))
                   @ d)
    xr = _rounded(xf)
    if variant == "v2":
        n = qs.shape[1]
        z = torch.einsum("mbj,bjn->mbn", xr.reshape(-1, nb, QBLOCK),
                         codes.reshape(nb, QBLOCK, n))   # [M, nb, N]
        return (z * d[None]).sum(1) + corr
    if variant == "v3":
        w = _rounded(codes * _rounded(d_rep))
    else:                                   # v1, v4, v5, v7
        w = _rounded(codes * d_rep)
    return xr @ w + corr


def _require_variant(variant: str) -> None:
    qm._require(variant in DECODE_VARIANTS,
                f"decode variant {variant!r}: the JAX package has "
                f"{', '.join(DECODE_VARIANTS)}")


def _check_planes(x: torch.Tensor, qs: torch.Tensor,
                  scales: torch.Tensor) -> None:
    qm._require(x.dim() == 2 and x.dtype == torch.float32,
                "x must be f32 [M, K]")
    qm._require(qs.dim() == 2 and qs.dtype == torch.uint8
                and qs.shape[0] % HALF == 0, "qs must be uint8 [K/2, N]")
    qm._require(scales.dtype in (torch.float32, torch.bfloat16)
                and scales.shape == (qs.shape[0] // HALF, qs.shape[1]),
                "scales must be f32 or bf16 [K/32, N]")
    qm._require(x.shape[1] <= 2 * qs.shape[0],
                f"x K={x.shape[1]} exceeds the stored K={2 * qs.shape[0]}")


# ---------------------------------------------------------------------------
# B1, B9, B15-B18: the plan of csrc/q4_fold.cuh
# ---------------------------------------------------------------------------

# The kernel's constants (csrc/q4_fold.cuh): q blocks a K stage, the columns
# of an m-tile (a consumer warpgroup takes two where M <= 32, else one; a
# block one or two warpgroups), and the dynamic shared memory a plan may
# lay out (the card's 232,448 bytes a block less 1024 for aligning the
# base)
B15_QB = 4
B15_MTILE_COLS = 64
B15_SMEM = 232448 - 1024
B15_MAX_SPLITS = 8                 # a portable thread block cluster
B15_MAX_M = 64
# the f32 modes (10, 11) are built to 32 rows: B5's f32 mode takes more
# (q4_matmul.f32_on_b5)
B15_F32_MAX_M = 32
# the consumer warpgroups of a block: two were the fastest on the 7B planes
# at every M (tools_torch/b15_sweep.py, PERF.md)
B15_WARPGROUPS = 2
# the weight bytes a block aims to keep in flight: the ring's slots are as
# many as reach this (and fit)
B15_RING_BYTES = 80 * 1024
# a split's merge (the partial tiles sent to the leader and added), in K
# stages of one block's time
B15_MERGE_STAGES = 2
# At M <= B15_SYNC_MAX_M the plan weighs one consumer warpgroup against two
# by a cost in K stages of 128 columns (10 KB of weights at f32 scales):
# a stage costs its columns / 128 and B15_STAGE_COST more (its waits and
# the fill that fewer, wider stages do not hide), each split past the
# first B15_SPLIT_COST (the leader takes one more partial tile). A least-
# squares fit of variant 0's 32 pinned plans on the 7B qkv, wo, w13 and w2
# planes at M = 1 (tools_torch/b15_sweep.py --parts pins, PERF.md;
# NVIDIA H100 80GB HBM3 at 700 W) put a launch at 2.0 us + 0.0405 us a KB
# of a block's weights + 0.21 us a stage + 0.49 us a split past the first;
# in those units the cost picks the fastest of the 16 plans on all four
# planes at M = 1 and 8, among them wo's one warpgroup and 3 splits (9.97
# us at M = 1, against 10.49 for two warpgroups and 6 splits).
B15_STAGE_COST = 0.5
B15_SPLIT_COST = 1.2
# mma.sync in place of wgmma at M <= this: one 8-row product a warp, 2-7%
# faster than wgmma at M = 1 and 8 on the 7B planes
# (tools_torch/b15_sweep.py, PERF.md)
B15_SYNC_MAX_M = 8


def b15_wg_cols(nw: int) -> int:
    """The columns of a consumer warpgroup of B15's kernel at nw rows of
    x: two m-tiles (128) at nw <= 32, else one (64) (csrc/q4_fold.cuh
    mtiles)."""
    return B15_MTILE_COLS * (2 if nw <= 32 else 1)


class B15Plan(NamedTuple):
    """A launch of B15's kernel: bn columns a tile (b15_wg_cols a consumer
    warpgroup), qb q blocks a K stage, `stages` weight ring slots and
    `xstages` x ring slots, `splits` blocks a cluster (each a run of `sps`
    K stages of every tile it walks), `clusters` clusters walking the
    column tiles, `items` tiles the busiest cluster takes, nw = M rounded
    up to 8 (the rows of x a product takes), sync: mma.sync in place of
    wgmma."""
    bn: int
    qb: int
    stages: int
    splits: int
    sps: int
    clusters: int
    items: int
    nw: int
    sync: bool
    xstages: int

    @property
    def wgs(self) -> int:
        return self.bn // b15_wg_cols(self.nw)


def b15_stage_sbytes(sc16: bool, mins: bool = False) -> int:
    """The bytes a weight stage of csrc/q4_fold.cuh carries a column a q
    block beside its packed rows (stage_sbytes): a scale (4, or 2 in bf16)
    and, for variant 9 (B9, f32 scales), a min."""
    return 8 if mins else 2 if sc16 else 4


def b15_x_sets(f32: bool) -> int:
    """The sets of k16 tiles an x slot of csrc/q4_fold.cuh holds (x_sets):
    in f32 mode one a part of x (three), else one."""
    return 3 if f32 else 1


def b15_smem(wgs: int, nw: int, sc16: bool, stages: int, xstages: int,
             splits: int, mins: bool = False, sets: int = 1) -> int:
    """The bytes csrc/q4_fold.cuh's fold_layout lays out: `stages` weight
    slots ([16 qb][BN] packed bytes, [qb][BN] scales and B9's [qb][BN]
    mins, 1024-aligned), `xstages` x slots (x f32 [nw][32 qb] as copied,
    `sets` (b15_x_sets) of 2 qb k16 tiles of nw x 16 bf16 and [qb][nw] f32
    block sums, 128-aligned), the leader's S - 1 received partial tiles
    (BN x nw f32) and the barriers."""
    bn = b15_wg_cols(nw) * wgs
    ws = -(-(16 * B15_QB * bn + B15_QB * bn * b15_stage_sbytes(sc16, mins))
           // 1024) * 1024
    xs = -(-(nw * 32 * B15_QB * 4 + sets * B15_QB * 32 * nw * 2
             + B15_QB * nw * 4) // 128) * 128
    merge = (splits - 1) * bn * nw * 4 if splits > 1 else 0
    return (stages * ws + xstages * xs + merge
            + 8 * (2 * stages + 3 * xstages + 8))


def b15_plan(m: int, n: int, nb: int, sms: int, sc16: bool = False,
             capacity: Callable[[int], int] | None = None, *,
             mins: bool = False, f32: bool = False,
             wgs: int | None = None, stages: int | None = None,
             splits: int | None = None, clusters: int | None = None,
             sync: bool | None = None) -> B15Plan:
    """The plan of B15's kernel for M rows, N stored columns and nb q
    blocks on a card of `sms` SMs. capacity(S) is how many clusters of S
    blocks the card holds at once (the card's own answer,
    cudaOccupancyMaxActiveClusters; sms // S without it). Above
    B15_SYNC_MAX_M rows a block has B15_WARPGROUPS consumer warpgroups (BN
    = 256 at M <= 32, 128 above), and among S = 1..8 splits of the
    ceil(nb / 4) K stages the cost is the rounds of tiles the busiest
    cluster takes times its stages and, if K is split, a merge
    (B15_MERGE_STAGES). At M <= B15_SYNC_MAX_M the plan takes one or two
    warpgroups and S by B15_STAGE_COST's and B15_SPLIT_COST's cost. A tie
    goes to fewer splits, then to more warpgroups. mins:
    B9's stages, which carry the mins beside the f32 scales; f32: the f32
    modes' x slots, which hold x's three parts (b15_x_sets). The
    weight ring takes as many slots as keep B15_RING_BYTES in flight and
    the x ring as many as the shared memory left by them and the merge
    holds, the weight ring giving up slots where x's need them (at the
    widest x, 32 KB of f32 a stage) to keep 3 x slots, or at least 2. The
    keyword arguments pin a choice (tools_torch/b15_sweep.py)."""
    if not 1 <= m <= B15_MAX_M:
        raise ValueError(f"B15 takes 1 <= M <= {B15_MAX_M} rows")
    if wgs not in (None, 1, 2):
        raise ValueError("B15 takes 1 or 2 consumer warpgroups")
    nw = -(-m // 8) * 8
    nst = -(-nb // B15_QB)
    cap = capacity or (lambda s: sms // s)
    fitted = m <= B15_SYNC_MAX_M
    sync = fitted if sync is None else sync
    sets = b15_x_sets(f32)
    best = None
    for w, s in itertools.product(
            (wgs,) if wgs else (2, 1) if fitted else (B15_WARPGROUPS,),
            (splits,) if splits else range(1, B15_MAX_SPLITS + 1)):
        bn = b15_wg_cols(nw) * w
        tiles = -(-n // bn)
        # the weight bytes of a slot (the ring's depth aims at them)
        ws = 16 * B15_QB * bn + B15_QB * bn * b15_stage_sbytes(sc16, mins)
        sps = -(-nst // s)
        if -(-nst // sps) != s:
            continue
        fixed = b15_smem(w, nw, sc16, 0, 0, s, mins, sets)
        wone = b15_smem(w, nw, sc16, 1, 0, s, mins, sets) - fixed
        xone = b15_smem(w, nw, sc16, 0, 1, s, mins, sets) - fixed

        def xdepth(depth):
            return min(depth, (B15_SMEM - fixed - depth * wone) // xone)
        if stages:
            depth = stages
        else:
            # the x ring at least 3 deep where the weight ring can give up
            # slots for it (at M = 64, 2 x slots took 1.2x the time of 3;
            # b15_sweep.py), else at least 2
            target = max(2, -(-B15_RING_BYTES // ws))
            depth = next((d for d in range(target, 1, -1)
                          if xdepth(d) >= 3), None) or next(
                (d for d in range(target, 1, -1) if xdepth(d) >= 2), 0)
        if depth < 2 or xdepth(depth) < 2:
            continue
        cl = clusters or min(tiles, cap(s))
        if cl < 1:
            continue
        rounds = -(-tiles // cl)
        if fitted:
            cost = (rounds * sps * (bn / 128 + B15_STAGE_COST)
                    + B15_SPLIT_COST * (s - 1))
        else:
            cost = rounds * (sps + B15_MERGE_STAGES * (s > 1))
        if best is None or (cost, s) < best[0]:
            best = ((cost, s), B15Plan(
                bn=bn, qb=B15_QB, stages=depth, splits=s, sps=sps,
                clusters=cl, items=rounds, nw=nw, sync=sync,
                xstages=xdepth(depth)))
    if best is None:
        raise ValueError(f"no B15 plan fits M={m}, N={n}, nb={nb} with "
                         f"wgs={wgs}, stages={stages}, splits={splits}")
    return best[1]


_B15_CLUSTERS: dict[tuple[int, int], int] = {}
_B15_PLANS: dict[tuple, B15Plan] = {}


def b15_capacity(device) -> Callable[[int], int]:
    """capacity(S) of `device` for b15_plan: how many of the kernel's
    clusters of S blocks it holds at once, asked of the card once."""
    def cap(s: int) -> int:
        key = (device.index, s)
        if key not in _B15_CLUSTERS:
            _B15_CLUSTERS[key] = cuda_lib.fn("q4_fold_clusters")(s)
        return _B15_CLUSTERS[key]
    return cap


def _launch_fold(x: torch.Tensor, qs: torch.Tensor,
                 scales: torch.Tensor | None, variant: int, n_out: int,
                 plan: B15Plan | None = None,
                 mins: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of B15's kernel (variant 0: B1's function, 1: v1's, 2:
    v2's, 3: v3's, 7: v7's, 9: B9's with `mins` f32 [K/32, N], 10 and 11:
    B1's and B9's in f32 mode; its build FOLD_ENTRY[variant]) with f32 or
    2-byte scales (9, 10, 11: f32), or of a probe (variant 13: B13, 14:
    B14; scales None), on b15_plan (the probes: B15's at f32 scales) or
    `plan`. The kernel reads x by tensor copies, which take rows of a
    multiple of 16 bytes: x of another K is padded with zeros to one."""
    qm._require(x.device.type == "cuda", f"unsupported device {x.device}")
    qm._require((mins is not None) == (variant in MINS_VARIANTS),
                "variants 9 and 11 (B9) take a mins plane, no other does")
    planes = tuple(t for t in (x, qs, scales, mins) if t is not None)
    qm._require(all(t.is_contiguous() and t.device == x.device
                    for t in planes),
                "x, qs and scales must be contiguous and on one card")
    m, kx = x.shape
    kh, n = qs.shape
    qm._require(1 <= m <= B15_MAX_M,
                f"x must have 1 <= M <= {B15_MAX_M} rows")
    qm._require(n % 16 == 0 and all(t.data_ptr() % 16 == 0
                                    for t in planes[1:]),
                "B15's kernel needs N % 16 == 0 and 16-byte aligned weight "
                "planes")
    nb = kh // HALF
    dev = x.device
    sc16 = scales is not None and scales.dtype == torch.bfloat16
    f32 = variant in F32_VARIANTS
    qm._require(not (sc16 and f32), "f32 mode takes f32 scales")
    qm._require(not f32 or m <= B15_F32_MAX_M,
                f"the f32 modes take M <= {B15_F32_MAX_M} rows")
    if kx % 4 or x.data_ptr() % 16:
        x = torch.nn.functional.pad(x, (0, -kx % 4)) if kx % 4 else x.clone()
        kx = x.shape[1]
    affine = mins is not None
    if plan is None:
        key = (dev.index, m, n, nb, sc16, affine, f32)
        plan = _B15_PLANS.get(key)
        if plan is None:
            plan = _B15_PLANS[key] = b15_plan(
                m, n, nb, cuda_lib.sm_count(dev), sc16, b15_capacity(dev),
                mins=affine, f32=f32)
    y = x.new_empty((m, n_out))
    entry = FOLD_ENTRY[variant]
    rc = cuda_lib.fn(entry)(
        x.data_ptr(), m, kx, qs.data_ptr(),
        None if scales is None else scales.data_ptr(),
        *((mins.data_ptr(),) if affine else ()), int(sc16), n,
        nb, variant, plan.wgs, plan.stages, plan.xstages, plan.splits,
        plan.sps, plan.clusters, int(plan.sync), y.data_ptr(), n_out, None,
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, entry)
    return y


def _decode_kernel(variant: str, doc: str):
    """The wrapper of the bf16-mode kernel of decode body `variant` (its
    build of csrc/q4_fold.cuh)."""
    def wrapper(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor,
                n_out: int | None = None) -> torch.Tensor:
        _check_planes(x, qs, scales)
        n_out = n_out or qs.shape[1]
        if x.device.type == "cpu":
            return decode_plain(x, qs, scales, variant)[:, :n_out]
        y = _launch_fold(x, qs, scales, FOLD_VARIANT[variant], n_out)
        wrapper.launches += 1
        return y
    wrapper.__name__ = wrapper.__qualname__ = f"q4_decode_{variant}"
    wrapper.__doc__ = doc
    return cuda_lib.counted(wrapper)


_SIG = ("x f32 [M <= 64, K], qs uint8 [K/2, N], scales f32 or bf16 "
        "[K/32, N] -> f32 [M, n_out or N]")
q4_decode_v1 = _decode_kernel("v1", f"""Kernel B15 (v1, v4, v5): {_SIG}
    = R(x) @ R(q d) - 8 bsum(x) @ d. csrc/q4_fold.cuh on b15_plan: weight
    stages by TMA into a ring on persistent blocks, R(q d) dequantized
    into wgmma's A registers against every row of x at once, the -8 folded
    back per q block as bsum * (-8 d) into f32 registers beside the
    accumulators, K splits added in a thread block cluster.""")
q4_decode_v2 = _decode_kernel("v2", f"""Kernel B16 (v2): {_SIG} =
    sum_b d_b (R(x_b) @ q_b) - 8 bsum(x) @ d, on B15's kernel: the codes
    alone (exact in bf16) in the A registers, each q block's product into a
    fresh set of f32 registers, then added to the accumulators scaled by
    its column's d, the fold straight into them.""")
q4_decode_v3 = _decode_kernel("v3", f"""Kernel B17 (v3): {_SIG} =
    R(x) @ R(q R(d)) - 8 bsum(x) @ d: a bf16 x bf16 product (one rounding)
    of the codes and the rounded scales (one bf16x2 fma, as __hmul2
    rounds), on B15's kernel; the fold keeps the f32 d.""")
q4_decode_v7 = _decode_kernel("v7", f"""Kernel B18 (v7): {_SIG} =
    R(x) @ R(q d) - 8 bsum7(x) @ d: B15's kernel, whose x warps sum the
    bf16-rounded pair sums R(R(x_lo) + R(x_hi)) in f32 for the fold.""")
DECODE_KERNELS = {"v1": q4_decode_v1, "v4": q4_decode_v1,
                  "v5": q4_decode_v1, "v2": q4_decode_v2,
                  "v3": q4_decode_v3, "v7": q4_decode_v7}


def q4_decode_v0(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor,
                 w_dtype=torch.bfloat16,
                 n_out: int | None = None) -> torch.Tensor:
    """v0 on raw planes: B1 (R(x) @ R((q - 8) d); f32 mode x @ ((q - 8) d)),
    counted in q4_matmul.q4_matmul_decode.launches. f32 scales go through
    q4_matmul_decode itself; bf16 scales (the v0h form) launch variant 0
    of csrc/q4_fold.cuh in its 2-byte-scale build (bf16 mode only)."""
    _check_planes(x, qs, scales)
    n_out = n_out or qs.shape[1]
    if x.device.type == "cpu":
        return decode_plain(x, qs, scales, "v0", w_dtype)[:, :n_out]
    if scales.dtype == torch.float32:
        return qm.q4_matmul_decode(
            x, QuantMatmulWeight(qs=qs, scales=scales, n_logical=n_out),
            w_dtype)
    qm._require(w_dtype == torch.bfloat16,
                "f32 mode takes f32 scales (B1's f32 mode)")
    y = _launch_fold(x, qs, scales, 0, n_out)
    qm.q4_matmul_decode.launches += 1
    return y


def q4_matmul_pallas(x: torch.Tensor, qs: torch.Tensor,
                     scales: torch.Tensor, *, w_dtype=torch.bfloat16,
                     variant: str = "v1") -> torch.Tensor:
    """The port of q4_matmul_pallas(x, qs, scales, w_dtype=, variant=): x
    f32 [M <= 64, K] -> y f32 [M, N] by the kernel of `variant` (module
    docstring); f32 mode runs B1's f32 mode for every variant."""
    _require_variant(variant)
    qm._require(w_dtype in (torch.bfloat16, torch.float32),
                "w_dtype must be bfloat16 or float32")
    if variant == "v0" or w_dtype == torch.float32:
        return q4_decode_v0(x, qs, scales, w_dtype)
    return DECODE_KERNELS[variant](x, qs, scales)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

PREFILL_CHUNK_M = 512          # natx and split take M <= 512 (the JAX assert)
# B20 runs B15's kernel (the same function, v1's) at M <= this, where the
# split kernel's 128-row tiles are mostly empty and B15's kernel is faster:
# 1.0-3.2x at M = 8-32 on the 7B planes, and 1.2-2.0x slower at M = 64
# (tools_torch/b15_sweep.py; chip_smoke.py phase 15 times both; PERF.md)
B20_ON_B15_MAX_M = 32


def b20_route(m: int) -> str:
    """The kernel B20 takes at M rows in bf16 mode: "b15" (B15's kernel,
    v1's function) or "split" (the cast pass and B5's split mode)."""
    return "b15" if m <= B20_ON_B15_MAX_M else "split"


def natx_scales(scales: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(s8 f32 [N], the normalized scales d / s8 f32 [K/32, N]) of the natx
    and split bodies, as the JAX glue makes them: s8 as B3 takes it,
    max(max_K |d| * 8/127, 1e-20), and a true division, where B3 multiplies
    by the reciprocal 1 / s8. B19's kernel derives both itself, bit-equal."""
    s8 = torch.clamp(scales.abs().amax(dim=0) * (8.0 / 127.0), min=1e-20)
    return s8, scales / s8


def q4_prefill_int8_natx_plain(x: torch.Tensor, qs: torch.Tensor,
                               scales: torch.Tensor) -> torch.Tensor:
    """B19's function: xq, dx as B2 makes them (the JAX glue's x / dx and
    max * f32(1/127)), w8 = round_half_even((q - 8) * (d / s8)), exact
    integer accumulators, y = (acc * dx) * s8."""
    xq, dx = qm.quant_rows_int8_plain(x, 2 * qs.shape[0])
    s8, sc = natx_scales(scales)
    w8 = torch.round((_codes(qs) - 8.0)
                     * sc.repeat_interleave(QBLOCK, dim=0))
    acc = qm.int8_accumulators(xq, w8).to(torch.float32)
    return (acc * dx[:, None]) * s8[None, :]


def q4_prefill_int8_natx(x: torch.Tensor, qs: torch.Tensor,
                         scales: torch.Tensor,
                         n_out: int | None = None) -> torch.Tensor:
    """Kernel B19 (int8 natx and split): x f32 [M <= 512, K], qs uint8
    [K/2, N], scales f32 [K/32, N] -> f32 [M, n_out or N]. On the card: xq
    and dx by B2 (bit-equal to the JAX glue), then one launch of a cluster
    kernel that derives s8 and d / s8 (an IEEE division) from the raw
    scales, requantizes each weight tile once for the cluster of blocks that
    covers M and runs B3's wgmma product on it; no int8 plane is made."""
    _check_planes(x, qs, scales)
    qm._require(scales.dtype == torch.float32, "scales must be f32")
    m = x.shape[0]
    n = qs.shape[1]
    n_out = n_out or n
    qm._require(1 <= m <= PREFILL_CHUNK_M,
                f"natx and split take 1 <= M <= {PREFILL_CHUNK_M} rows")
    if x.device.type == "cpu":
        return q4_prefill_int8_natx_plain(x, qs, scales)[:, :n_out]
    qm._require(x.device.type == "cuda" and all(
        t.is_contiguous() and t.device == x.device for t in (qs, scales)),
        "qs and scales must be contiguous on x's card")
    k = 2 * qs.shape[0]
    qm._require(k % 64 == 0 and n % 16 == 0 and qs.data_ptr() % 16 == 0
                and scales.data_ptr() % 16 == 0,
                "stored K must be a multiple of 64, stored N of 16 and the "
                "weight planes 16-byte aligned")
    xq, dx = qm.quant_rows_int8(x.contiguous(), k)
    dev = x.device
    y = torch.empty((m, n_out), dtype=torch.float32, device=dev)
    rc = cuda_lib.fn("q4_int8_gemm_natx")(
        xq.data_ptr(), dx.data_ptr(), m, k, qs.data_ptr(), scales.data_ptr(),
        n, y.data_ptr(), n_out, cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "q4_int8_gemm_natx")
    q4_prefill_int8_natx.launches += 1
    return y


cuda_lib.counted(q4_prefill_int8_natx)


def q4_matmul_prefill_int8(x: torch.Tensor, qs: torch.Tensor,
                           scales: torch.Tensor, *,
                           variant: str = "nat") -> torch.Tensor:
    """The port of q4_matmul_prefill_int8(x, qs, scales, variant=): x f32
    [M, K] -> y f32 [M, N]; nat and natp run B2 + B3, natx and split B19."""
    qm._require(variant in INT8_VARIANTS,
                f"int8 variant {variant!r}: the JAX package has "
                f"{', '.join(INT8_VARIANTS)}")
    if variant in ("natx", "split"):
        return q4_prefill_int8_natx(x, qs, scales)
    _check_planes(x, qs, scales)
    w = QuantMatmulWeight(qs=qs, scales=scales)
    xq, dx = qm.quant_rows_int8(x.contiguous(), w.k)
    return qm.q4_matmul_prefill_int8(xq, dx, w)


def q4_prefill_split_plain(x: torch.Tensor, qs: torch.Tensor,
                           scales: torch.Tensor,
                           w_dtype=torch.bfloat16) -> torch.Tensor:
    """B20's function at any M: v1's (decode_plain); in f32 mode B5's f32
    function, x @ ((q - 8) d) (B5's f32 mode computes it, at every M)."""
    return decode_plain(x, qs, scales, "v1", w_dtype)


def q4_prefill_split(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor,
                     w_dtype=torch.bfloat16,
                     n_out: int | None = None) -> torch.Tensor:
    """Kernel B20 (the prefill split body, _q4mm_prefill_kernel): x f32
    [1 <= M <= 512, K], qs uint8 [K/2, N], scales f32 [K/32, N] -> f32
    [M, n_out or N] = R(x) @ R(q d) - 8 bsum(x) @ d. bf16 mode: the cast
    pass (which also makes the fold's operand from bsum, the block sums the
    JAX host side makes), then B5's kernel in its split mode: the weight
    R(q d) and, a stage at a time, the fold as one more tensor-core slice
    of bf16 parts of bsum and -8 d (8 of their 9 part products: f32
    summation error, as the JAX body's HIGHEST dot); at M <=
    B20_ON_B15_MAX_M B15's kernel; counted here. f32 mode: B5's f32 mode
    (the register-A kernel's), at every M, counted in
    q4_matmul.q4_matmul_prefill.launches. M > 512 raises, as the JAX body's
    assert does."""
    _check_planes(x, qs, scales)
    qm._require(scales.dtype == torch.float32, "scales must be f32")
    qm._require(w_dtype in (torch.bfloat16, torch.float32),
                "w_dtype must be bfloat16 or float32")
    m, kx = x.shape
    k, n = 2 * qs.shape[0], qs.shape[1]
    n_out = n_out or n
    qm._require(1 <= m <= PREFILL_CHUNK_M,
                f"the split body takes 1 <= M <= {PREFILL_CHUNK_M} rows")
    if x.device.type == "cpu":
        return q4_prefill_split_plain(x, qs, scales, w_dtype)[:, :n_out]
    w = QuantMatmulWeight(qs=qs, scales=scales, n_logical=n_out)
    if w_dtype == torch.float32:
        return qm.q4_matmul_prefill(x, w, w_dtype)
    qm._require(x.device.type == "cuda" and x.is_contiguous()
                and x.data_ptr() % 16 == 0,
                "x must be a contiguous, 16-byte aligned CUDA tensor")
    qm._check_weight(w, x.device)
    qm._require(kx % 4 == 0 and k % 32 == 0 and n % 16 == 0
                and qs.data_ptr() % 16 == 0 and scales.data_ptr() % 16 == 0,
                "x's K must be a multiple of 4, stored N of 16 and the "
                "weight planes 16-byte aligned")
    dev = x.device
    if b20_route(m) == "b15":
        y = _launch_fold(x, qs, scales, FOLD_VARIANT["v1"], n_out)
        q4_prefill_split.launches += 1
        return y
    # the fold's A operand, written by the cast pass: 4 KB a (128-row tile,
    # 64-deep stage) of K
    fold_a = cuda_lib.scratch(dev, "q4_prefill.fold_a",
                              -(-m // qm.B5_BM) * -(-k // qm.B5_BK) * 4096,
                              torch.uint8)
    sms = cuda_lib.sm_count(dev)
    splits, k_steps = qm.b5_plan(m, n, -(-kx // 32) * 32, sms)
    tiles = -(-m // qm.B5_BM) * -(-n // qm.B5_BN)
    xb = cuda_lib.scratch(dev, "q4_prefill.xb", m * k, torch.bfloat16)
    partial = cuda_lib.scratch(
        dev, "q4_prefill.partial",
        tiles * splits * qm.B5_BM * qm.B5_BN if splits > 1 else 1,
        torch.float32)
    counters = cuda_lib.tile_counters(dev, tiles)
    y = torch.empty((m, n_out), dtype=torch.float32, device=dev)
    rc = cuda_lib.fn("q4_prefill_split_gemm")(
        x.data_ptr(), m, kx, qs.data_ptr(), scales.data_ptr(), n, k,
        fold_a.data_ptr(), xb.data_ptr(), splits, k_steps,
        min(tiles * splits, sms), partial.data_ptr(), counters.data_ptr(),
        y.data_ptr(), n_out, cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "q4_prefill_split_gemm")
    q4_prefill_split.launches += 1
    return y


cuda_lib.counted(q4_prefill_split)


def q4_matmul_prefill_pallas(x: torch.Tensor, qs: torch.Tensor,
                             scales: torch.Tensor, *,
                             w_dtype=torch.bfloat16,
                             variant: str = "nat") -> torch.Tensor:
    """The port of q4_matmul_prefill_pallas(x, qs, scales, w_dtype=,
    variant=): nat runs B5, split B20 (B5's f32 mode in f32 mode)."""
    qm._require(variant in ("nat", "split"), f"prefill variant {variant!r}: "
                "the JAX package has nat and split")
    if variant == "split":
        return q4_prefill_split(x, qs, scales, w_dtype)
    _check_planes(x, qs, scales)
    return qm.q4_matmul_prefill(x, QuantMatmulWeight(qs=qs, scales=scales),
                                w_dtype)
