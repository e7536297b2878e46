"""Weight fusion: [Q | K | V] and [w1 | w3] as single matmul weights.

Port of fastllama_tpu/models/fuse.py. QKV share their input, as do w1/w3, so they are fused
at load time (7 -> 4 matmul launches per layer). The column order is plain
block concatenation, so the splits after the fused matmul are contiguous
slices; fusing packed planes along N is a pure column permutation (split-K
packing runs along K only).
"""
from __future__ import annotations

import numpy as np
import torch

from ..quant.tensor import (
    QBLOCK, QuantMatmulWeight, good_pad_k, good_pad_n, make_matmul_weight,
    make_matmul_weight_q41, matmul_weight_from_planes, pack_codes_split_k,
    pad_multiple,
)
from ..config import resolve_device


def qkv_col_order(n_head: int, hd: int) -> np.ndarray:
    """Fused column order: plain [Q | K | V] blocks."""
    return np.arange(3 * n_head * hd, dtype=np.int64)


def w13_col_order(n_ff: int) -> np.ndarray:
    """Fused column order: plain [w1 | w3] blocks."""
    return np.arange(2 * n_ff, dtype=np.int64)


def shard_col_order(n_total: int, n_parts: int, tp: int) -> np.ndarray:
    """Permutation taking the block-fused layout [P0 | P1 | ...] (n_parts
    equal blocks of width n_total/n_parts) to per-shard blocks
    [P0_s0 | P1_s0 | ... | P0_s1 | ...], so that a CONTIGUOUS 1/tp column
    slice holds every part's s-th column range and the shard-local split
    code stays the single-device one."""
    width = n_total // n_parts
    if width % tp:
        raise ValueError(f"part width {width} not divisible by tp={tp}")
    w_loc = width // tp
    starts = (np.arange(n_parts)[None, :] * width
              + np.arange(tp)[:, None] * w_loc)          # [tp, n_parts]
    return (starts.reshape(-1, 1) + np.arange(w_loc)[None, :]).reshape(-1)


def _pad_packed(qs: np.ndarray, scales: np.ndarray, k_logical: int,
                pad_n: int = 0, pad_code: int = 0x88):
    """Pad packed planes to good_pad_k / good_pad_n with inert values:
    pad_code 0x88 (code 8 = value 0) for symmetric q4_0; 0x00 for affine
    weights, whose padding is made inert by zero scales and zero mins."""
    kh, n = qs.shape
    k_pad = good_pad_k(k_logical)
    n_pad = good_pad_n(n) if not pad_n else pad_multiple(n, pad_n)
    if (k_pad // 2, n_pad) == (kh, n):
        return qs, scales
    out_qs = np.full((k_pad // 2, n_pad), pad_code, np.uint8)
    out_qs[:kh, :n] = qs
    return out_qs, _pad_packed_plane(scales, k_logical, pad_n)


def _pad_packed_plane(plane: np.ndarray, k_logical: int,
                      pad_n: int = 0) -> np.ndarray:
    """Zero-pad a [K/32, N] plane to the padded dims."""
    nb, n = plane.shape
    k_pad = good_pad_k(k_logical)
    n_pad = good_pad_n(n) if not pad_n else pad_multiple(n, pad_n)
    if (k_pad // QBLOCK, n_pad) == (nb, n):
        return plane
    out = np.zeros((k_pad // QBLOCK, n_pad), plane.dtype)
    out[:nb, :n] = plane
    return out


def fuse_packed(parts: list[tuple], order: np.ndarray,
                device=None) -> QuantMatmulWeight:
    """Fuse device-layout planes along N with a column permutation, then pad
    with inert values to good_pad_k / good_pad_n, as the JAX loader does.
    Parts are (qs [K/2, N_i], scales [K/32, N_i]) or, for affine (q4_1 /
    GPTQ) weights, (qs, scales, mins)."""
    dev = resolve_device(device)
    affine = len(parts[0]) == 3
    qs = np.concatenate([p[0] for p in parts], axis=1)[:, order]
    sc = np.concatenate([p[1] for p in parts], axis=1)[:, order]
    n_logical = qs.shape[1]
    k_logical = qs.shape[0] * 2
    mn = None
    if affine:
        mn = np.concatenate([p[2] for p in parts], axis=1)[:, order]
        mn = _to_device(_pad_packed_plane(mn, k_logical), np.float32, dev)
    qs, sc = _pad_packed(qs, sc, k_logical,
                         pad_code=0x00 if affine else 0x88)
    return QuantMatmulWeight(qs=_to_device(qs, np.uint8, dev),
                             scales=_to_device(sc, np.float32, dev),
                             mins=mn, n_logical=n_logical)


def _to_device(a: np.ndarray, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


def fuse_dense(parts: list[np.ndarray], order: np.ndarray,
               device=None) -> torch.Tensor:
    """Fuse dense [K, N_i] matmul weights along N (no padding needed)."""
    dev = resolve_device(device)
    return torch.from_numpy(
        np.concatenate(parts, axis=1)[:, order]).to(dev)


def packed_planes(codes: np.ndarray, scales: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Quantizer output (codes [N, K], scales [N, K/32]) -> unpadded device
    planes (qs [K/2, N], scales [K/32, N])."""
    codes_t = np.ascontiguousarray(np.asarray(codes, np.uint8).T)
    return (pack_codes_split_k(codes_t),
            np.ascontiguousarray(np.asarray(scales, np.float32).T))


def make_layer_params(n_head: int, *, attention_norm, ffn_norm,
                      wq, wk, wv, wo, w1, w2, w3, device=None):
    """Build a fused LayerParams on `device` from per-tensor specs.

    Each weight spec is one of
      ("q4", codes [N, K], scales [N, K/32])   - ggml row-major orientation
      ("q41", codes, scales, mins)             - affine (q4_1/GPTQ), row-major
      ("q4p", qs [K/2, N], scales [K/32, N])   - unpadded device planes
      ("dense", w [K, N])                      - already model-transposed
    QKV must share a kind, as must w1/w3.
    """
    from .llama import LayerParams

    dev = resolve_device(device)

    def fuse(specs, order):
        kinds = {s[0] for s in specs}
        if kinds == {"q4"}:
            parts = [packed_planes(s[1], s[2]) for s in specs]
        elif kinds == {"q41"}:
            parts = [packed_planes(s[1], s[2]) + (
                np.ascontiguousarray(np.asarray(s[3], np.float32).T),)
                for s in specs]
        elif kinds == {"q4p"}:
            parts = [(s[1], s[2]) for s in specs]
        elif kinds == {"dense"}:
            return fuse_dense([np.asarray(s[1]) for s in specs], order, dev)
        else:
            raise ValueError(f"cannot fuse mixed weight kinds {kinds}")
        return fuse_packed(parts, order, dev)

    def out_dim(spec):
        if spec[0] in ("q4", "q41"):
            return spec[1].shape[0]
        return spec[1].shape[1]

    hd = out_dim(wq) // n_head
    n_ff = out_dim(w1)
    return LayerParams(
        attention_norm=_to_device(attention_norm, np.float32, dev),
        wqkv=fuse([wq, wk, wv], qkv_col_order(n_head, hd)),
        wo=matmul_from_spec(wo, dev),
        ffn_norm=_to_device(ffn_norm, np.float32, dev),
        w13=fuse([w1, w3], w13_col_order(n_ff)),
        w2=matmul_from_spec(w2, dev),
    )


def matmul_from_spec(spec: tuple, device=None):
    """One unfused matmul weight on `device` from a make_layer_params spec."""
    if spec[0] == "q4":
        return make_matmul_weight(spec[1], spec[2], device=device)
    if spec[0] == "q41":
        return make_matmul_weight_q41(spec[1], spec[2], spec[3],
                                      device=device)
    if spec[0] == "q4p":
        return matmul_weight_from_planes(spec[1], spec[2], device=device)
    return torch.from_numpy(np.asarray(spec[1])).to(resolve_device(device))


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
