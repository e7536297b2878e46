"""Decode attention: kernels B4 (fused) and B10 (attention alone) and their
plain versions.

B10 ports fastllama_tpu/kernels/decode_attention.py::decode_attention: the
caller has roped q and k and written the current K/V row; the kernel attends
rows s <= n_past[b] (inclusive) with q, scores, softmax and the
probabilities all f32, whatever the cache dtype. The forward takes it for a
decode step whose layer adds LoRA terms to q, k or v, which B4 cannot (it
reads the raw fused projection). On the card it splits the keys: S is cut
into chunks of at most 64 rows (b10_splits), each block attends one chunk of
one head and the last block of a head merges the partial softmaxes in chunk
order (csrc/decode_attention.cu).

B4 ports fastllama_tpu/kernels/decode_attention.py::decode_attention_fused:
one decode step of one layer takes the raw fused projection qkv [B, 1, 3F]
([Q | K | V] blocks, models/fuse.py), ropes q and the new k with per-lane
tables, writes the new K/V row at clip(n_past, 0, S-1) into the flat
[B, S, F] caches IN PLACE, attends rows < n_past with the new token folded
in analytically, and returns ctx [B, 1, F] f32. Scores and softmax are f32;
the two cache dots take the cache dtype, with q and p cast down to it. On
the card it splits the keys as B10 does (the same kernel, its FUSED
variant): each chunk casts its own p = exp(score - chunk max), the new
token joins the merge as one more partial, and the block that finishes a
head writes the new cache row after every block of it has read its rows.

Both CUDA kernels are in csrc/decode_attention.cu; each wrapper launches
its kernel for CUDA tensors and runs its plain version for CPU tensors.
"""
from __future__ import annotations

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


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def decode_attention_fused(qkv: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, n_past: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor, *,
                           head_dim: int, n_rot: int,
                           scale: float) -> torch.Tensor:
    """Kernel B4. qkv f32 [B, 1, 3F]; caches [B, S, F] bf16 or f32, updated
    in place; n_past int32 [B]; cos/sin f32 [B, head_dim]. Returns ctx f32
    [B, 1, F]. On the card the keys are split as for B10 (b10_splits)."""
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
    tensors = (qkv, k_cache, v_cache, n_past, cos, sin)
    _require(qkv.device.type == "cuda"
             and all(t.device == qkv.device and t.is_contiguous()
                     for t in tensors),
             "all tensors must be contiguous on one CUDA device")
    _require(head_dim % 32 == 0 and head_dim <= 256 and s <= 12288,
             "head_dim must be a multiple of 32 and <= 256, S <= 12288")
    dev = qkv.device
    splits, chunk = b10_splits(s)
    partial = cuda_lib.scratch(dev, "decode_attention.partial",
                               b * (f // head_dim) * splits * (head_dim + 2),
                               torch.float32)
    counters = cuda_lib.tile_counters(dev, b * (f // head_dim))
    out = torch.empty((b, 1, f), dtype=torch.float32, device=dev)
    rc = cuda_lib.fn("decode_attention_fused")(
        qkv.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        n_past.data_ptr(), cos.data_ptr(), sin.data_ptr(), b, s, f, head_dim,
        splits, chunk, float(scale), int(k_cache.dtype == torch.bfloat16),
        partial.data_ptr(), counters.data_ptr(), out.data_ptr(),
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "decode_attention_fused")
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
    prefill attention, and B10's plain version at T = 1."""
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


B10_CHUNK = 64        # rows per block at most (the kernel's kMaxChunk)


def b10_splits(s: int) -> tuple[int, int]:
    """(splits, chunk) of B10's and B4's grid for a cache of S rows: chunk
    i takes rows [i * chunk, min((i + 1) * chunk, S)), every chunk holds at
    least one row and chunk <= 64. From S alone, so the host never reads
    n_past."""
    splits = -(-s // B10_CHUNK)
    return splits, -(-s // splits)


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
    tensors = (q, k_cache, v_cache, n_past)
    _require(q.device.type == "cuda"
             and all(t.device == q.device and t.is_contiguous()
                     for t in tensors),
             "all tensors must be contiguous on one CUDA device")
    _require(head_dim % 32 == 0 and head_dim <= 256 and s <= 12288,
             "head_dim must be a multiple of 32 and <= 256, S <= 12288")
    dev = q.device
    h = f // head_dim
    splits, chunk = b10_splits(s)
    partial = cuda_lib.scratch(dev, "decode_attention.partial",
                               b * h * splits * (head_dim + 2), torch.float32)
    counters = cuda_lib.tile_counters(dev, b * h)
    out = torch.empty((b, 1, f), dtype=torch.float32, device=dev)
    rc = cuda_lib.fn("decode_attention")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        n_past.data_ptr(), b, s, f, head_dim, splits, chunk, float(scale),
        int(k_cache.dtype == torch.bfloat16), partial.data_ptr(),
        counters.data_ptr(), out.data_ptr(), cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


cuda_lib.counted(decode_attention)
