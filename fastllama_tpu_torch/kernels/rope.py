"""Rotary position embeddings in the ggml (interleaved, GPT-J) convention.

Plain PyTorch port of fastllama_tpu/kernels/rope.py (that module has no
Pallas kernel). For position p and dimension pair (2i, 2i+1) of the first
n_rot dims of each head:

    theta_i = p * 10000^(-2i / n_rot)
    (x0, x1) -> (x0*cos - x1*sin, x0*sin + x1*cos)

Dims past n_rot pass through. The per-lane form x*cos + x[l^1]*sin_signed
(rope_lane_tables_bt + rope_interleaved_lanes) is the same rotation with the
even lane's minus sign folded into the sine table.
"""
from __future__ import annotations

import torch


def _freqs(n: int, n_rot: int, device) -> torch.Tensor:
    base = torch.tensor(10000.0, dtype=torch.float32, device=device)
    return base ** (-2.0 * torch.arange(n, dtype=torch.float32, device=device)
                    / n_rot)


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                     n_rot: int) -> torch.Tensor:
    """x [..., T, n_head, head_dim], positions [T] or [..., T] -> same shape."""
    orig_dtype = x.dtype
    hd = x.shape[-1]
    rot = x[..., :n_rot].to(torch.float32)
    half = n_rot // 2
    theta = positions.to(torch.float32)[..., None, None] * _freqs(
        half, n_rot, x.device)
    cos, sin = torch.cos(theta), torch.sin(theta)
    pairs = rot.reshape(*rot.shape[:-1], half, 2)
    x0, x1 = pairs[..., 0], pairs[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                      dim=-1).reshape(rot.shape).to(orig_dtype)
    if n_rot < hd:
        out = torch.cat([out, x[..., n_rot:]], dim=-1)
    return out


def rope_lane_tables_bt(positions: torch.Tensor, head_dim: int,
                        n_rot: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-lane tables for a [..., T] position grid: (cos, sin_signed), each
    [..., T, 1, head_dim] f32, broadcasting over heads."""
    cos, sin = lane_tables(positions, head_dim, n_rot)
    return cos[..., None, :], sin[..., None, :]


def lane_tables(positions: torch.Tensor, head_dim: int,
                n_rot: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin_signed) [..., head_dim] f32 for positions [...]: lane l <
    n_rot carries angle p * 10000^(-2(l//2)/n_rot), lanes >= n_rot pass
    through (cos 1, sin 0), and even lanes carry -sin."""
    dev = positions.device
    lane = torch.arange(head_dim, device=dev)
    freq = _freqs(head_dim, n_rot, dev)[lane // 2]
    theta = positions.to(torch.float32)[..., None] * freq
    active = lane < n_rot
    cos = torch.where(active, torch.cos(theta), torch.ones_like(theta))
    sign = torch.where(lane % 2 == 0, -1.0, 1.0).to(torch.float32)
    sin = torch.where(active, torch.sin(theta) * sign, torch.zeros_like(theta))
    return cos, sin


def rope_interleaved_lanes(x: torch.Tensor, cos_l: torch.Tensor,
                           sin_s: torch.Tensor, n_rot: int,
                           out_dtype: torch.dtype | None = None
                           ) -> torch.Tensor:
    """Interleaved RoPE in natural lane order: x*cos + x[l^1]*sin_s (the
    partner gather is exact, like the JAX 0/1 matmul at HIGHEST), computed
    in f32 and stored as out_dtype (x's by default): bf16 for the flash
    prefill's operands, one rounding of the same f32 value."""
    del n_rot                      # lanes >= n_rot carry cos 1, sin 0
    xf = x.to(torch.float32)
    partner = xf[..., torch.arange(x.shape[-1], device=x.device) ^ 1]
    return (xf * cos_l + partner * sin_s).to(out_dtype or x.dtype)
