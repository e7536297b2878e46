"""Fresh-prompt flash prefill attention: kernel B12 and its plain version.

B12 ports fastllama_tpu/models/llama.py::_flash_prefill_attention, which
calls the library Pallas TPU kernel
jax.experimental.pallas.ops.tpu.flash_attention.flash_attention with
block_q = block_k_major = block_k = min(T, 512): causal self-attention of a
fresh prompt window (n_past == 0) over its own K/V, with the online softmax
keeping the [T, T] scores out of device memory. The forward takes it where
the JAX package does (models/llama._flash_viable): a prefill trace whose
caller promises n_past == 0, no sequence parallelism, T >= 128 and
T % 128 == 0, head_dim % 128 == 0, bf16 weight mode.

Numerics (the library's): q, k and v rounded to bf16; scores = (q . k) in
f32 times 1/sqrt(Dh); causal mask; the online softmax's p = exp(s - m) is
rounded to bf16 for the PV product; the output is normalized by l and
rounded to bf16 once. The wrapper returns that bf16 output as f32, as the
JAX function's o.astype(f32) does.

The wrapper takes bf16 q, k, v: the forward passes the RoPE pass's bf16
q (and k) and, on the slab path, the bf16 cache rows that write_kv has
just stored, so nothing is rounded twice and the kernel reads half the
bytes of f32 operands.

On the card (csrc/flash_prefill.cu) the operands are read by TMA into
shared memory and multiplied by wgmma: one producer warpgroup keeps K/V
tiles in flight, one or two consumer warpgroups of 64 query rows run
S = Q K^T, the online softmax in registers and O += P V. b12_plan picks,
from the shapes alone, the query tile (64 or 128 rows), the K/V stages and
how many key tiles one block takes: the heaviest query tiles split their
keys across blocks, merged in order by the last split to finish, so few
heads and long windows still fill the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import cuda_lib

# the library's mask value (flash_attention.DEFAULT_MASK_VALUE)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
BLOCK = 512          # the JAX caller's block size cap: min(T, 512)
T_ALIGN = 128        # the gate's T alignment, which every plan divides
HEAD_DIMS = (128, 256)   # the head widths the kernel is built for
SPLIT_COST = 4       # a split's own start and merge, in key tiles (b12_plan)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B12 with the library kernel's numerics:
    q, k, v [B, T, H, Dh] -> ctx f32 [B, T, H, Dh], bf16-valued. Blocks of
    min(T, 512) rows; a query block visits the key blocks up to its own
    (the library skips the rest), keeping the running max m, sum l and
    normalized accumulator acc as the library's scratch does."""
    b, t, h, d = q.shape
    blk = min(t, BLOCK)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = (_bf16(x).transpose(1, 2) for x in (q, k, v))  # [B,H,T,D]
    out = torch.empty_like(qf)
    rows = torch.arange(blk, device=q.device)
    for q0 in range(0, t, blk):
        qb = qf[:, :, q0:q0 + blk]
        m = torch.full(qb.shape[:-1] + (1,), -math.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, q0 + blk, blk):
            s = (qb @ kf[:, :, k0:k0 + blk].transpose(-1, -2)) * scale
            mask = (k0 + rows)[None, :] <= (q0 + rows)[:, None]
            s = s + torch.where(mask, 0.0, MASK_VALUE)
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_next)
            l_corr = torch.exp(m - m_next) * l
            l_next = p.sum(-1, keepdim=True) + l_corr
            inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
            acc = acc * (l_corr * inv) + (_bf16(p) @ vf[:, :, k0:k0 + blk]
                                          ) * inv
            m, l = m_next, l_next
        out[:, :, q0:q0 + blk] = acc
    return _bf16(out).transpose(1, 2).contiguous()


class B12Plan(NamedTuple):
    """nc consumer warpgroups (query tiles of 64 * nc rows), K/V ring
    stages, and kchunk: the most key tiles one block takes (a query tile
    with more is split into runs of kchunk, merged in order)."""
    nc: int
    stages: int
    kchunk: int


def b12_tiles(d: int, nc: int) -> tuple[int, int]:
    """(query rows, key rows) of a tile: 64 per consumer warpgroup, by 128
    keys at Dh 128 and 64 at Dh 256 (what a consumer's registers hold
    beside O)."""
    return 64 * nc, 128 if d == 128 else 64


def _key_tiles(t: int, bm: int, bn: int) -> list[int]:
    """Key tiles of each query tile: the keys up to its last row."""
    return [-(-(i + 1) * bm // bn) for i in range(t // bm)]


def b12_plan(b: int, h: int, t: int, d: int, sms: int) -> B12Plan:
    """B12's launch plan, from the shapes alone. At Dh 128 two consumer
    warpgroups (128-row query tiles, which share each K/V tile) once there
    are at least half as many such tiles as SMs, else one (64 rows); at
    Dh 256 one (O takes 128 registers). Three K/V stages (what shared
    memory holds). Then whether the heaviest query tiles split their keys:
    a split block pays its own start (the Q load, the first K/V) and the
    merge, about SPLIT_COST key tiles on the H100 (tools_torch/
    b12_sweep.py), so a query tile is split, in two, only where its key
    chain outlasts the card's share of all the tile products by more than
    that."""
    nc = 2 if d == 128 and 2 * b * h * (t // 128) >= sms else 1
    bm, bn = b12_tiles(d, nc)
    stages = 3
    nk = _key_tiles(t, bm, bn)
    share = -(-b * h * sum(nk) // sms)
    kchunk = nk[-1]
    if kchunk > share + SPLIT_COST:
        kchunk = max(share, -(-kchunk // 2))
    return B12Plan(nc, stages, kchunk)


def b12_grid(plan: B12Plan, b: int, h: int, t: int, d: int):
    """(items, split_from, max_splits): the grid, the first split query
    tile and the most splits of one, as the kernel's grid_of() counts."""
    bm, bn = b12_tiles(d, plan.nc)
    splits = [-(-n // plan.kchunk) for n in _key_tiles(t, bm, bn)]
    split_from = next((i for i, s in enumerate(splits) if s > 1),
                      len(splits))
    return b * h * sum(splits), split_from, max(splits)


def b12_scratch(plan: B12Plan, b: int, h: int, t: int, d: int
                ) -> tuple[int, int]:
    """(f32 partial floats, int32 counters) the split tiles need: each
    split stores O (Dh / 2 values), m and l of two rows for each of its
    128 nc consumer threads."""
    bm, _ = b12_tiles(d, plan.nc)
    _, split_from, max_splits = b12_grid(plan, b, h, t, d)
    tiles = b * h * (t // bm - split_from)
    return tiles * max_splits * (d // 2 + 4) * 128 * plan.nc, tiles


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def flash_prefill(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Kernel B12. q, k (post-RoPE) and v bf16 [B, T, H, Dh], each with a
    contiguous last axis (any B, T and H strides that are multiples of 16
    bytes). Causal, scale 1/sqrt(Dh). Returns ctx f32 [B, T, H, Dh]
    (contiguous), bf16-valued. On the card T must be a multiple of 128 and
    Dh 128 or 256."""
    _require(q.dim() == 4 and k.shape == q.shape and v.shape == q.shape,
             "q, k, v must be [B, T, H, Dh] of one shape")
    _require(all(x.dtype == torch.bfloat16 for x in (q, k, v)),
             "q, k, v must be bf16")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v)
    b, t, h, d = q.shape
    _require(q.device.type == "cuda"
             and k.device == q.device and v.device == q.device,
             "q, k, v must lie on one CUDA device")
    _require(d in HEAD_DIMS, f"head_dim must be one of {HEAD_DIMS}")
    _require(t > 0 and t % T_ALIGN == 0, f"T must be a multiple of {T_ALIGN}")
    _require(all(x.stride(3) == 1 and x.data_ptr() % 16 == 0
                 and all(s % 8 == 0 for s in x.stride()[:3])
                 for x in (q, k, v)),
             "q, k, v need a contiguous last axis, 16-byte strides")
    plan = b12_plan(b, h, t, d, cuda_lib.sm_count(q.device))
    n_part, n_ctr = b12_scratch(plan, b, h, t, d)
    partial = cuda_lib.scratch(q.device, "b12_partial", max(n_part, 1),
                               torch.float32)
    counters = cuda_lib.tile_counters(q.device, max(n_ctr, 1))
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    rc = cuda_lib.fn("flash_prefill")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, b, t, h, d,
        plan.nc, plan.stages, plan.kchunk, float(1.0 / math.sqrt(d)),
        out.data_ptr(), partial.data_ptr(), counters.data_ptr(),
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
