"""Block quantization formats, bit-exact with the ggml reference semantics.

Formats (parity contract, see BASELINE.md):
  q4_0: 32-elem block, f32 scale d = amax/7, nibble q = roundf(v/d) + 8
        (reference: lib/ggml.c:590-664)
  q4_1: 32-elem block, f32 d = (max-min)/15, f32 m = min, q = roundf((v-m)/d)
        (reference: lib/ggml.c:597-603, 917-1080)
  q8_0: 32-elem block, f32 d = amax/127, int8 q = roundf(v/d), s = d*sum(q)
        (reference: lib/ggml.c:620-626, 1249-1302)

Two layouts are used:

* **wire layout** — the byte layout of ggml files (GGJT): per block, scale(s)
  followed by 16 packed bytes where byte l holds element 2l in the low nibble
  and element 2l+1 in the high nibble. Used only for file interchange.

* **device layout** — the layout this framework puts on the card: packed
  nibble planes stored K-major with split-K packing (quant/tensor.py) plus a
  separate f32 scale plane of shape [..., K // 32], so the kernels read codes
  and scales as two dense, coalesced planes.

All host-side quantization here is numpy (float32/float64 controlled rounding
so results are bit-identical to the C reference, which uses f32 arithmetic and
``roundf`` — round-half-away-from-zero).
"""
from __future__ import annotations

import numpy as np

QK4_0 = 32
QK4_1 = 32
QK8_0 = 32

# Bytes per block in the ggml wire format.
Q4_0_BLOCK_BYTES = 4 + QK4_0 // 2       # f32 d + 16 nibble bytes
Q4_1_BLOCK_BYTES = 8 + QK4_1 // 2       # f32 d + f32 m + 16 nibble bytes
Q8_0_BLOCK_BYTES = 8 + QK8_0            # f32 d + f32 s + 32 int8


def _roundf(v: np.ndarray) -> np.ndarray:
    """C `roundf` semantics: round half away from zero.

    Computed in float64 (exact for the |v| <= O(100) range used here) to avoid
    the double-rounding hazards of f32 `floor(v + 0.5)`.
    """
    v64 = v.astype(np.float64)
    return np.where(v64 >= 0.0, np.floor(v64 + 0.5), np.ceil(v64 - 0.5))


def quantize_q4_0(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize float rows to q4_0 codes + scales.

    Args:
      x: [..., K] float array, K % 32 == 0.
    Returns:
      (codes, scales): codes uint8 [..., K] with values in [0, 15]
      (the stored nibble, i.e. signed value + 8), scales f32 [..., K//32].
    """
    x = np.asarray(x, dtype=np.float32)
    k = x.shape[-1]
    if k % QK4_0 != 0:
        raise ValueError(f"last dim {k} not a multiple of {QK4_0}")
    lead = x.shape[:-1]
    blocks = x.reshape(*lead, k // QK4_0, QK4_0)

    amax = np.max(np.abs(blocks), axis=-1)
    d = (amax / 7.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv_d = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)

    v = (blocks * inv_d[..., None]).astype(np.float32)
    q = _roundf(v).astype(np.int8) + np.int8(8)
    codes = q.astype(np.uint8).reshape(*lead, k)
    if codes.max(initial=0) > 15:
        raise AssertionError("q4_0 nibble out of range; input not finite?")
    return codes, d


def dequantize_q4_0(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of quantize_q4_0 (reference: lib/ggml.c:1443-1481)."""
    codes = np.asarray(codes, dtype=np.int16)
    k = codes.shape[-1]
    lead = codes.shape[:-1]
    q = codes.reshape(*lead, k // QK4_0, QK4_0).astype(np.float32) - 8.0
    out = q * np.asarray(scales, dtype=np.float32)[..., None]
    return out.reshape(*lead, k).astype(np.float32)


def quantize_q4_1(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """q4_1: per-block min/delta affine quant (reference: ggml.c:917-1080)."""
    x = np.asarray(x, dtype=np.float32)
    k = x.shape[-1]
    if k % QK4_1 != 0:
        raise ValueError(f"last dim {k} not a multiple of {QK4_1}")
    lead = x.shape[:-1]
    blocks = x.reshape(*lead, k // QK4_1, QK4_1)

    mn = np.min(blocks, axis=-1).astype(np.float32)
    mx = np.max(blocks, axis=-1).astype(np.float32)
    d = ((mx - mn) / np.float32(15.0)).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv_d = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)

    v = ((blocks - mn[..., None]) * inv_d[..., None]).astype(np.float32)
    # Reference uses (int8)(v + 0.5f) i.e. truncation after +0.5 (v >= 0 here).
    q = np.minimum(np.floor(v.astype(np.float64) + 0.5), 15.0).astype(np.uint8)
    return q.reshape(*lead, k), d, mn


def dequantize_q4_1(codes: np.ndarray, scales: np.ndarray, mins: np.ndarray) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.int16)
    k = codes.shape[-1]
    lead = codes.shape[:-1]
    q = codes.reshape(*lead, k // QK4_1, QK4_1).astype(np.float32)
    out = q * np.asarray(scales, np.float32)[..., None] + np.asarray(mins, np.float32)[..., None]
    return out.reshape(*lead, k).astype(np.float32)


def quantize_q8_0(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """q8_0 activation quant (reference: ggml.c:1249-1302).

    Returns (codes int8 [..., K], d f32 [..., K//32], s f32 [..., K//32])
    where s = d * sum(codes in block), used by the reference's q4_1×q8_0 dot.
    """
    x = np.asarray(x, dtype=np.float32)
    k = x.shape[-1]
    if k % QK8_0 != 0:
        raise ValueError(f"last dim {k} not a multiple of {QK8_0}")
    lead = x.shape[:-1]
    blocks = x.reshape(*lead, k // QK8_0, QK8_0)
    amax = np.max(np.abs(blocks), axis=-1)
    d = (amax / np.float32(127.0)).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv_d = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)
    q = _roundf((blocks * inv_d[..., None]).astype(np.float32)).astype(np.int8)
    s = (d.astype(np.float64) * q.sum(axis=-1, dtype=np.int64)).astype(np.float32)
    return q.reshape(*lead, k), d, s


def dequantize_q8_0(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.int8)
    k = codes.shape[-1]
    lead = codes.shape[:-1]
    q = codes.reshape(*lead, k // QK8_0, QK8_0).astype(np.float32)
    out = q * np.asarray(scales, np.float32)[..., None]
    return out.reshape(*lead, k).astype(np.float32)


# ---------------------------------------------------------------------------
# Wire (ggml-file) packing: byte l = q[2l] | q[2l+1] << 4
# ---------------------------------------------------------------------------

def pack_nibbles_wire(codes: np.ndarray) -> np.ndarray:
    """[..., K] uint8 codes (0..15) -> [..., K//2] ggml-packed bytes."""
    codes = np.asarray(codes, dtype=np.uint8)
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_nibbles_wire(packed: np.ndarray) -> np.ndarray:
    """[..., K//2] ggml-packed bytes -> [..., K] uint8 codes (0..15)."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty(packed.shape[:-1] + (packed.shape[-1] * 2,), dtype=np.uint8)
    out[..., 0::2] = packed & 0x0F
    out[..., 1::2] = packed >> 4
    return out


def q4_0_to_wire(codes: np.ndarray, scales: np.ndarray) -> bytes:
    """Serialize q4_0 rows to the ggml wire layout (d then 16 bytes per block)."""
    codes = np.asarray(codes, np.uint8)
    k = codes.shape[-1]
    nb = k // QK4_0
    rows = int(np.prod(codes.shape[:-1], dtype=np.int64)) if codes.ndim > 1 else 1
    packed = pack_nibbles_wire(codes).reshape(rows * nb, QK4_0 // 2)
    d = np.asarray(scales, np.float32).reshape(rows * nb, 1)
    out = np.empty((rows * nb, Q4_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :4] = d.view(np.uint8)
    out[:, 4:] = packed
    return out.tobytes()


def q4_0_from_wire(buf: bytes | np.ndarray, shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Parse ggml q4_0 bytes into (codes uint8 [..., K], scales f32 [..., K//32])."""
    k = shape[-1]
    nb = k // QK4_0
    lead = shape[:-1]
    rows = int(np.prod(lead, dtype=np.int64)) if lead else 1
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(rows * nb, Q4_0_BLOCK_BYTES)
    d = raw[:, :4].copy().view(np.float32).reshape(*lead, nb)
    codes = unpack_nibbles_wire(raw[:, 4:]).reshape(*lead, k)
    return codes, d


def q4_1_to_wire(codes: np.ndarray, scales: np.ndarray, mins: np.ndarray) -> bytes:
    codes = np.asarray(codes, np.uint8)
    k = codes.shape[-1]
    nb = k // QK4_1
    rows = int(np.prod(codes.shape[:-1], dtype=np.int64)) if codes.ndim > 1 else 1
    packed = pack_nibbles_wire(codes).reshape(rows * nb, QK4_1 // 2)
    d = np.asarray(scales, np.float32).reshape(rows * nb, 1)
    m = np.asarray(mins, np.float32).reshape(rows * nb, 1)
    out = np.empty((rows * nb, Q4_1_BLOCK_BYTES), dtype=np.uint8)
    out[:, :4] = d.view(np.uint8)
    out[:, 4:8] = m.view(np.uint8)
    out[:, 8:] = packed
    return out.tobytes()


def q4_1_from_wire(buf: bytes | np.ndarray, shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    k = shape[-1]
    nb = k // QK4_1
    lead = shape[:-1]
    rows = int(np.prod(lead, dtype=np.int64)) if lead else 1
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(rows * nb, Q4_1_BLOCK_BYTES)
    d = raw[:, :4].copy().view(np.float32).reshape(*lead, nb)
    m = raw[:, 4:8].copy().view(np.float32).reshape(*lead, nb)
    codes = unpack_nibbles_wire(raw[:, 8:]).reshape(*lead, k)
    return codes, d, m
