"""Decode attention: kernels B4 (fused) and B10 (attention alone) and their
plain versions.

B10 ports fastllama_tpu/kernels/decode_attention.py::decode_attention: the
caller has roped q and k and written the current K/V row; the kernel attends
rows s <= n_past[b] (inclusive) with q, scores, softmax and the
probabilities all f32, whatever the cache dtype. It is a public entry point
that no model path takes: a decode step whose layer adds LoRA terms to q, k
or v adds them into the raw fused projection and runs B4.

B4 ports fastllama_tpu/kernels/decode_attention.py::decode_attention_fused:
one decode step of one layer takes the raw fused projection qkv [B, 1, 3F]
([Q | K | V] blocks, models/fuse.py), ropes q and the new k with per-lane
tables, writes the new K/V row at clip(n_past, 0, S-1) into the flat
[B, S, F] caches IN PLACE, attends rows < n_past with the new token folded
in analytically, and returns ctx [B, 1, F] f32. Scores and softmax are f32;
the two cache dots take the cache dtype, with q and p cast down to it.

On the card both run the split kernel of csrc/attn_split.cuh (B4 as its
fused mode), which B6, B11 and the fused paged step also run: a thread
block cluster of cs blocks a (b, h) divides the live rows on the device
(split_rows), each block rounds its own p = exp(score - block max) and the
cluster's leader merges the partials in rank order; the new token of B4 is
one more partial, and the leader writes the new cache row after every block
has read its rows. attn_plan picks cs, the ring's tiles and its depth from
the shapes alone.

Both CUDA entry points are in csrc/decode_attention.cu; each wrapper
launches its kernel for CUDA tensors and runs its plain version for CPU
tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import cuda_lib
from .rope import lane_tables


def rope_lane_tables(positions: torch.Tensor, head_dim: int, n_rot: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos [B, d], sin_signed [B, d]) f32 for positions [B] — the tables
    the fused kernel takes (lanes >= n_rot pass through)."""
    return lane_tables(positions, head_dim, n_rot)


def _rope_fma(x, partner, cos, sin):
    """fma(x, cos, round(partner * sin)) in f32 — the roundings XLA:CPU
    gives the JAX kernel's x * cos + partner * sin. The f32 product x * cos
    is exact in f64, so one f64 add and one rounding to f32 reproduce the
    fused multiply-add (barring a double-rounding tie)."""
    return (x.to(torch.float64) * cos.to(torch.float64)
            + (partner * sin).to(torch.float64)).to(torch.float32)


def decode_attention_fused_plain(qkv, k_cache, v_cache, n_past, cos, sin, *,
                                 head_dim: int, n_rot: int, scale: float):
    """Plain PyTorch version of kernel B4 (same arguments and effects)."""
    del n_rot                      # carried by the tables
    b, s, f = k_cache.shape
    d = head_dim
    h = f // d
    kd = k_cache.dtype
    row = qkv[:, 0].to(torch.float32)
    q, k, v = (row[:, i * f:(i + 1) * f].reshape(b, h, d) for i in range(3))
    partner = torch.arange(d, device=qkv.device) ^ 1
    c, sn = cos[:, None, :], sin[:, None, :]
    qr, kr = (_rope_fma(t, t[..., partner], c, sn) for t in (q, k))

    keys = k_cache.reshape(b, s, h, d).to(torch.float32)
    vals = v_cache.reshape(b, s, h, d).to(torch.float32)
    scores = torch.einsum("bhd,bshd->bhs", qr.to(kd).to(torch.float32),
                          keys) * scale
    mask = (torch.arange(s, device=qkv.device)[None, None, :]
            < n_past.to(torch.int64)[:, None, None])
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    s_new = (qr * kr).sum(-1, keepdim=True) * scale
    m = torch.maximum(scores.amax(-1, keepdim=True), s_new)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    e_new = torch.exp(s_new - m)
    l_tot = p.sum(-1, keepdim=True) + e_new
    ctx = torch.einsum("bhs,bshd->bhd", p.to(kd).to(torch.float32), vals)
    out = (ctx + e_new * v) / l_tot

    rows = torch.clamp(n_past.to(torch.int64), 0, s - 1)
    bi = torch.arange(b, device=qkv.device)
    k_cache[bi, rows] = kr.reshape(b, f).to(kd)
    v_cache[bi, rows] = v.reshape(b, f).to(kd)
    return out.reshape(b, 1, f)



# ---------------------------------------------------------------------------
# The split kernel's plan (csrc/attn_split.cuh), shared with B6, B11 and the
# fused paged step (kernels/paged_attention.py)
# ---------------------------------------------------------------------------

ATTN_TILE_BYTES = 16 * 1024   # K (or V) bytes of a ring slot
ATTN_MAX_TILE = 128           # rows of a slot at most
ATTN_STAGES = 3               # ring slots the plan gives (the kernel takes 8)
ATTN_MAX_CLUSTER = 8          # blocks a cluster (the portable limit)
ATTN_PER_CAP = 2048           # rows a block at most: its scores' room
ATTN_BLOCKS_PER_SM = 2        # the grid the plan aims at: one wave
ATTN_MIN_ROWS = 16            # a full cache gives each block this many rows


class AttnPlan(NamedTuple):
    cs: int          # blocks of a (b, h)'s cluster
    tr: int          # rows of a ring slot
    stages: int      # ring slots
    per_max: int     # rows a block at most (a multiple of 4)
    maps: int        # rows at a stride (slab, flat pools) in 8-row boxes


@functools.lru_cache(maxsize=None)
def attn_plan(b: int, h: int, rows: int, d: int, itemsize: int, sms: int,
              cs: "int | None" = None, stages: "int | None" = None,
              maps: "bool | None" = None, tr: "int | None" = None
              ) -> AttnPlan:
    """The split kernel's plan for B sequences of H heads, caches or page
    tables of `rows` rows (S, or pp * ps), head dim d and elements of
    `itemsize` bytes, on a card of `sms` SMs: from the shapes alone, so a
    step graph's replay keeps it. The cluster size cs gives the grid at
    most ATTN_BLOCKS_PER_SM blocks an SM (one wave: a second, partial wave
    cost B6 at 8 x 300 a third more on the H100) where the heads alone do
    not exceed it, at least ATTN_MIN_ROWS rows a block at full length, and
    a block's rows within ATTN_PER_CAP. Rows at a stride (the slab, the
    flat pools) go in 8-row boxes of a tensor map where a row is a whole
    number of 128-byte lines, else one bulk copy a row; the head-major
    pools' contiguous rows take neither. `cs`, `stages`, `maps` and `tr`
    pin them (tools_torch/attn_sweep.py)."""
    if tr is None:
        tr = max(1, min(ATTN_MAX_TILE, ATTN_TILE_BYTES // (d * itemsize)))
    if cs is None:
        fill = ATTN_BLOCKS_PER_SM * sms // (b * h)
        cs = min(ATTN_MAX_CLUSTER, fill, -(-rows // ATTN_MIN_ROWS))
        cs = max(1, cs, -(-rows // ATTN_PER_CAP))
    per = -(-rows // cs)
    if stages is None:
        # three slots also where two would hold a block's tiles: the larger
        # block spreads 8-block clusters over more SMs at B = 1 (0.8 us
        # faster at 1 x 300 on the H100), and a fourth cost them a second
        # wave; at B = 8 two to four move within the spread
        stages = ATTN_STAGES
    if maps is None:
        maps = d * itemsize % 128 == 0
    return AttnPlan(cs, tr, stages, -(-per // 4) * 4, int(maps))


def attn_smem_bytes(plan: AttnPlan, d: int, itemsize: int) -> int:
    """Dynamic shared memory of a block of the split kernel under `plan`
    (csrc/attn_split.cuh smem_bytes): the ring, the header's five f32 rows,
    the scores, the cluster's partial slots, the four consumer warps' sums
    and the barriers."""
    return (128 + plan.stages * plan.tr * d * itemsize + 5 * d * 4
            + plan.per_max * 4 + plan.cs * (d + 4) * 4 + 4 * d * 4
            + (2 * plan.stages + 2) * 8)


def split_rows(n: int, cs: int) -> list[tuple[int, int]]:
    """(first row, rows) of each rank of a cluster of cs blocks over n live
    rows, as the kernel divides them on the device: per = ceil(n / cs), rank
    r takes [r per, min((r + 1) per, n)); a rank past the rows takes none."""
    per = -(-n // cs) if n > 0 else 0
    return [(r * per, max(0, min(per, n - r * per))) for r in range(cs)]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 16-byte aligned (the kernel
    reads its rows by bulk copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _launch_slab(name, first, k_cache, v_cache, n_past, lanes, head_dim,
                 scale, plan: "AttnPlan | None" = None, entry=None):
    """One launch of B4 (`first` qkv, `lanes` (cos, sin)) or B10 (`first` q,
    no lanes); `plan` pins the split kernel's plan and `entry` takes another
    build's C entry point (tools_torch/attn_sweep.py)."""
    b, s, f = k_cache.shape
    tensors = (first, k_cache, v_cache, n_past, *lanes)
    _require(first.device.type == "cuda"
             and all(t.device == first.device and t.is_contiguous()
                     for t in tensors),
             "all tensors must be contiguous on one CUDA device")
    _require(head_dim % 32 == 0 and head_dim <= 256 and s <= 12288,
             "head_dim must be a multiple of 32 and <= 256, S <= 12288")
    _require(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
             "the caches must be 16-byte aligned")
    dev = first.device
    if plan is None:
        plan = attn_plan(b, f // head_dim, s, head_dim,
                         k_cache.element_size(), cuda_lib.sm_count(dev))
    # the kernel reads these rows by bulk copies: 16-byte aligned
    first, lanes = _aligned(first), tuple(_aligned(t) for t in lanes)
    out = torch.empty((b, 1, f), dtype=torch.float32, device=dev)
    rc = (entry or cuda_lib.fn(name))(
        first.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        n_past.data_ptr(), *(t.data_ptr() for t in lanes), b, s, f,
        head_dim, *plan, float(scale), int(k_cache.dtype == torch.bfloat16),
        out.data_ptr(), cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, name)
    return out


def decode_attention_fused(qkv: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, n_past: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor, *,
                           head_dim: int, n_rot: int,
                           scale: float) -> torch.Tensor:
    """Kernel B4. qkv f32 [B, 1, 3F]; caches [B, S, F] bf16 or f32, updated
    in place; n_past int32 [B]; cos/sin f32 [B, head_dim]. Returns ctx f32
    [B, 1, F]. On the card the keys are split on the device (attn_plan,
    split_rows)."""
    b, s, f = k_cache.shape
    _require(qkv.shape == (b, 1, 3 * f) and qkv.dtype == torch.float32,
             "qkv must be f32 [B, 1, 3F]")
    _require(v_cache.shape == k_cache.shape
             and v_cache.dtype == k_cache.dtype
             and k_cache.dtype in (torch.bfloat16, torch.float32),
             "caches must match, bf16 or f32 [B, S, F]")
    _require(n_past.shape == (b,) and n_past.dtype == torch.int32,
             "n_past must be int32 [B]")
    _require(cos.shape == (b, head_dim) and sin.shape == (b, head_dim)
             and cos.dtype == torch.float32 and sin.dtype == torch.float32,
             "cos/sin must be f32 [B, head_dim]")
    _require(f % head_dim == 0, "F must be a multiple of head_dim")
    if qkv.device.type == "cpu":
        return decode_attention_fused_plain(
            qkv, k_cache, v_cache, n_past, cos, sin, head_dim=head_dim,
            n_rot=n_rot, scale=scale)
    out = _launch_slab("decode_attention_fused", qkv, k_cache, v_cache,
                       n_past, (cos, sin), head_dim, scale)
    decode_attention_fused.launches += 1
    return out


cuda_lib.counted(decode_attention_fused)


# ---------------------------------------------------------------------------
# B10: attention alone over an already-written cache
# ---------------------------------------------------------------------------

def masked_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor,
                     n_head: int, scale: float) -> torch.Tensor:
    """softmax(q . K[s <= position] * scale) @ V in f32: q [B, T, H, Dh],
    caches [B, S, H*Dh], positions [B, T] -> ctx [B, T, H, Dh]. The forward's
    prefill attention and its f32-mode decode step (there under
    utils.precision.ieee_f32), and B10's plain version at T = 1."""
    b, s, f = k_cache.shape
    hd = f // n_head
    keys = k_cache.reshape(b, s, n_head, hd).to(torch.float32)
    vals = v_cache.reshape(b, s, n_head, hd).to(torch.float32)
    scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                          keys) * scale
    mask = (torch.arange(s, device=q.device)[None, None, None, :]
            <= positions[:, None, :, None])
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(scores, dim=-1), vals)


def decode_attention_plain(q, k_cache, v_cache, n_past, *, head_dim: int,
                           scale: float):
    """Plain PyTorch version of kernel B10 (same arguments and result)."""
    b, _, f = k_cache.shape
    h = f // head_dim
    ctx = masked_attention(q.reshape(b, 1, h, head_dim), k_cache, v_cache,
                           n_past.to(torch.int64)[:, None], h, scale)
    return ctx.reshape(b, 1, f)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, n_past: torch.Tensor, *,
                     head_dim: int, scale: float) -> torch.Tensor:
    """Kernel B10. q f32 [B, 1, F] after RoPE; caches [B, S, F] bf16 or f32
    holding the current token at row n_past[b]; n_past int32 [B] >= 0 (a
    slot with n_past >= S attends all S rows).
    Returns ctx f32 [B, 1, F]."""
    b, s, f = k_cache.shape
    _require(q.shape == (b, 1, f) and q.dtype == torch.float32,
             "q must be f32 [B, 1, F]")
    _require(v_cache.shape == k_cache.shape
             and v_cache.dtype == k_cache.dtype
             and k_cache.dtype in (torch.bfloat16, torch.float32),
             "caches must match, bf16 or f32 [B, S, F]")
    _require(n_past.shape == (b,) and n_past.dtype == torch.int32,
             "n_past must be int32 [B]")
    _require(f % head_dim == 0, "F must be a multiple of head_dim")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, n_past,
                                      head_dim=head_dim, scale=scale)
    out = _launch_slab("decode_attention", q, k_cache, v_cache, n_past, (),
                       head_dim, scale)
    decode_attention.launches += 1
    return out


cuda_lib.counted(decode_attention)
