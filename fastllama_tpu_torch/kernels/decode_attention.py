"""Fused decode attention (kernel B4) and its plain version.

Ports fastllama_tpu/kernels/decode_attention.py::decode_attention_fused:
one decode step of one layer takes the raw fused projection qkv [B, 1, 3F]
([Q | K | V] blocks, models/fuse.py), ropes q and the new k with per-lane
tables, writes the new K/V row at clip(n_past, 0, S-1) into the flat
[B, S, F] caches IN PLACE, attends rows < n_past with the new token folded
in analytically, and returns ctx [B, 1, F] f32. Scores and softmax are f32;
the two cache dots take the cache dtype, with q and p cast down to it.

The CUDA kernel is csrc/decode_attention.cu; the wrapper launches it for
CUDA tensors and runs decode_attention_fused_plain for CPU tensors.
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
    [B, 1, F]."""
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
    out = torch.empty((b, 1, f), dtype=torch.float32, device=qkv.device)
    rc = cuda_lib.fn("decode_attention_fused")(
        qkv.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        n_past.data_ptr(), cos.data_ptr(), sin.data_ptr(), b, s, f, head_dim,
        float(scale), int(k_cache.dtype == torch.bfloat16), out.data_ptr(),
        cuda_lib.stream_handle(qkv.device))
    cuda_lib.check(rc, "decode_attention_fused")
    decode_attention_fused.launches += 1
    return out


decode_attention_fused.launches = 0
