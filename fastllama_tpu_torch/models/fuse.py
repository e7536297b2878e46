"""Weight fusion: [Q | K | V] and [w1 | w3] as single matmul weights.

Port of fastllama_tpu/models/fuse.py for the q4_0 planes. QKV share their
input, as do w1/w3, so they are fused at load time (7 -> 4 matmul launches
per layer). The column order is plain block concatenation, so the splits
after the fused matmul are contiguous slices; fusing packed planes along N
is a pure column permutation (split-K packing runs along K only).
"""
from __future__ import annotations

import numpy as np
import torch

from ..quant.tensor import (
    QBLOCK, QuantMatmulWeight, good_pad_k, good_pad_n,
)
from ..config import resolve_device


def qkv_col_order(n_head: int, hd: int) -> np.ndarray:
    """Fused column order: plain [Q | K | V] blocks."""
    return np.arange(3 * n_head * hd, dtype=np.int64)


def w13_col_order(n_ff: int) -> np.ndarray:
    """Fused column order: plain [w1 | w3] blocks."""
    return np.arange(2 * n_ff, dtype=np.int64)


def fuse_packed(parts: list[tuple[np.ndarray, np.ndarray]],
                order: np.ndarray, device=None) -> QuantMatmulWeight:
    """Fuse q4_0 planes (qs [K/2, N_i], scales [K/32, N_i]) along N with a
    column permutation, then pad with inert values (codes 8, scales 0) to
    good_pad_k / good_pad_n, as the JAX loader does."""
    dev = resolve_device(device)
    qs = np.concatenate([p[0] for p in parts], axis=1)[:, order]
    sc = np.concatenate([p[1] for p in parts], axis=1)[:, order]
    kh, n = qs.shape
    k_pad, n_pad = good_pad_k(kh * 2), good_pad_n(n)
    out_qs = np.full((k_pad // 2, n_pad), 0x88, np.uint8)
    out_qs[:kh, :n] = qs
    out_sc = np.zeros((k_pad // QBLOCK, n_pad), np.float32)
    out_sc[: sc.shape[0], :n] = sc
    return QuantMatmulWeight(qs=torch.from_numpy(out_qs).to(dev),
                             scales=torch.from_numpy(out_sc).to(dev),
                             n_logical=n)


def split_qkv(y: torch.Tensor, n_head: int):
    """[B, T, 3*h*hd] fused [Q|K|V] output -> (q, k, v) each [B, T, h, hd]."""
    b, t, n3 = y.shape
    d = n3 // 3
    hd = d // n_head
    return (y[..., :d].reshape(b, t, n_head, hd),
            y[..., d:2 * d].reshape(b, t, n_head, hd),
            y[..., 2 * d:].reshape(b, t, n_head, hd))


def split_w13(y: torch.Tensor):
    """[B, T, 2F] fused [w1|w3] output -> (gate, up) each [B, T, F]."""
    f = y.shape[-1] // 2
    return y[..., :f], y[..., f:]
