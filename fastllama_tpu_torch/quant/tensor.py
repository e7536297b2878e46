"""Device-side quantized tensor containers (PyTorch).

The same layout as the JAX package's quant/tensor.py, so weights carry
across as a plain copy: a q4 weight used as a matmul RHS is stored
**K-major** ([K, N]) with **split-K packing**: within each 32-element
quantization block along K, the byte at row 16*b + j (j in [0,16)) packs

    low  nibble -> element k = 32*b + j        (the block's first half)
    high nibble -> element k = 32*b + 16 + j   (the block's second half)

Scales are a dense f32 plane [K//32, N]; an affine (q4_1 / GPTQ) weight
carries a second such plane of mins. Stored dims may be padded past the
logical ones (good_pad_k / good_pad_n); the padding is inert (q4_0: codes 8,
scales 0; affine: codes 0, scales 0, mins 0), activations count as zero up
to the stored K and outputs are sliced to n_logical
(kernels/q4_matmul.q4_matmul). The padding was chosen for TPU tiles; a
layout made for Hopper is later work.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device
from .q4 import QK4_0

QBLOCK = QK4_0  # 32


@dataclasses.dataclass
class QuantMatmulWeight:
    """A 4-bit quantized matmul RHS of logical shape [K, N] (y = x @ W).

    Attributes:
      qs: uint8 [K_pad//2, N_pad] split-K packed nibbles.
      scales: f32 [K_pad//32, N_pad] per-block scale d.
      mins: f32 [K_pad//32, N_pad] per-block offset m of an affine (q4_1 /
        GPTQ) weight w = q * d + m; None for symmetric q4_0, w = (q - 8) * d.
      n_logical: true output width (callers receive y[..., :n_logical]).
    """
    qs: torch.Tensor
    scales: torch.Tensor
    mins: torch.Tensor | None = None
    n_logical: int = 0

    def __post_init__(self):
        if not self.n_logical:
            self.n_logical = self.qs.shape[1]

    @property
    def k(self) -> int:
        return self.qs.shape[0] * 2

    @property
    def n(self) -> int:
        return self.n_logical

    @property
    def shape(self) -> tuple[int, int]:
        return (self.k, self.n_logical)


@dataclasses.dataclass
class QuantEmbedding:
    """A q4_0-quantized row-gather table of logical shape [V, D]: row-major,
    split-K packed along D. qs uint8 [V, D//2], scales f32 [V, D//32]."""
    qs: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return (self.qs.shape[0], self.qs.shape[1] * 2)


# ---------------------------------------------------------------------------
# Host-side packing converters (numpy)
# ---------------------------------------------------------------------------

def split_pack_lastdim(codes: np.ndarray) -> np.ndarray:
    """[..., K] uint8 codes -> [..., K//2] split-K packed bytes (numpy)."""
    codes = np.asarray(codes, np.uint8)
    k = codes.shape[-1]
    lead = codes.shape[:-1]
    blocks = codes.reshape(*lead, k // QBLOCK, QBLOCK)
    packed = (blocks[..., : QBLOCK // 2] | (blocks[..., QBLOCK // 2:] << 4))
    return packed.astype(np.uint8).reshape(*lead, k // 2)


def split_unpack_lastdim(packed: np.ndarray) -> np.ndarray:
    """Inverse of split_pack_lastdim (numpy)."""
    packed = np.asarray(packed, np.uint8)
    kh = packed.shape[-1]
    lead = packed.shape[:-1]
    blocks = packed.reshape(*lead, kh // (QBLOCK // 2), QBLOCK // 2)
    out = np.concatenate([blocks & 0x0F, blocks >> 4], axis=-1)
    return out.reshape(*lead, kh * 2)


def pad_multiple(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_tile_k(k: int, cap: int = 2816) -> int:
    """Largest multiple of 256 dividing k, up to cap (k itself if none)."""
    best = 0
    d = 256
    while d <= cap:
        if k % d == 0:
            best = d
        d += 256
    return best or k


def good_pad_k(k: int) -> int:
    """Smallest stored K >= k (multiple of 256) with a large 256-multiple
    divisor: 11008 -> 11264. The same rule as the JAX package, so the
    stored planes of both are the same bytes."""
    k0 = pad_multiple(k, 256)
    cand = k0
    while cand <= k0 + 2816:
        if pick_tile_k(cand) >= min(1024, cand):
            return cand
        cand += 256
    return k0


def good_pad_n(n: int) -> int:
    """Smallest stored N >= n that is a multiple of 1024, within +3% of the
    256-rounded n: 22016 -> 22528, 32000 -> 32768."""
    n0 = pad_multiple(n, 256)
    cand = n0
    while cand <= n0 + int(n0 * 0.03):
        if cand % 1024 == 0:
            return cand
        cand += 256
    return n0


def pack_codes_split_k(codes_t: np.ndarray) -> np.ndarray:
    """[K, N] uint8 codes -> [K/2, N] split-K packed bytes."""
    k, n = codes_t.shape
    blocks = codes_t.reshape(k // QBLOCK, QBLOCK, n)
    packed = (blocks[:, : QBLOCK // 2, :] | (blocks[:, QBLOCK // 2:, :] << 4))
    return packed.reshape(k // 2, n).astype(np.uint8)


def matmul_weight_from_planes(qs: np.ndarray, scales: np.ndarray,
                              device=None) -> QuantMatmulWeight:
    """Build from unpadded device-layout planes (qs [K/2, N], scales
    [K/32, N]), applying the inert tile padding good_pad_k / good_pad_n."""
    dev = resolve_device(device)
    qs = np.asarray(qs, np.uint8)
    scales = np.asarray(scales, np.float32)
    kh, n = qs.shape
    k = kh * 2
    k_pad, n_pad = good_pad_k(k), good_pad_n(n)
    if (k_pad, n_pad) != (k, n):
        out_qs = np.full((k_pad // 2, n_pad), 0x88, np.uint8)
        out_qs[:kh, :n] = qs
        out_sc = np.zeros((k_pad // QBLOCK, n_pad), np.float32)
        out_sc[: k // QBLOCK, :n] = scales
        qs, scales = out_qs, out_sc
    return QuantMatmulWeight(
        qs=torch.from_numpy(np.array(qs, np.uint8)).to(dev),
        scales=torch.from_numpy(np.array(scales, np.float32)).to(dev),
        n_logical=n)


def make_matmul_weight(codes: np.ndarray, scales: np.ndarray,
                       device=None) -> QuantMatmulWeight:
    """Build the device layout from row-major quantizer output: codes uint8
    [N, K] (ggml orientation), scales f32 [N, K//32]."""
    codes_t = np.ascontiguousarray(np.asarray(codes, np.uint8).T)
    scales_t = np.ascontiguousarray(np.asarray(scales, np.float32).T)
    return matmul_weight_from_planes(pack_codes_split_k(codes_t), scales_t,
                                     device=device)


def make_matmul_weight_q41(codes: np.ndarray, scales: np.ndarray,
                           mins: np.ndarray, pad_k: int = 0, pad_n: int = 256,
                           device=None) -> QuantMatmulWeight:
    """Affine-quantized RHS (q4_1 / GPTQ): w = q * d + m per 32-block.

    codes uint8 [N, K], scales/mins f32 [N, K//32]. Padding is inert: codes
    0, d 0, m 0 (pad_k=0 = auto, good_pad_k; pad_n=0 = good_pad_n). The
    defaults are the JAX package's, so the planes are the same bytes."""
    dev = resolve_device(device)
    n, k = codes.shape
    k_pad = good_pad_k(k) if not pad_k else pad_multiple(k, pad_k)
    n_pad = good_pad_n(n) if not pad_n else pad_multiple(n, pad_n)
    codes_t = np.zeros((k_pad, n_pad), np.uint8)
    codes_t[:k, :n] = np.asarray(codes, np.uint8).T
    planes = []
    for plane in (scales, mins):
        out = np.zeros((k_pad // QBLOCK, n_pad), np.float32)
        out[: k // QBLOCK, :n] = np.asarray(plane, np.float32).T
        planes.append(torch.from_numpy(out).to(dev))
    return QuantMatmulWeight(
        qs=torch.from_numpy(pack_codes_split_k(codes_t)).to(dev),
        scales=planes[0], mins=planes[1], n_logical=n)


def planes_to_codes(qs: np.ndarray, scales: np.ndarray, k_logical: int,
                    n_logical: int) -> tuple[np.ndarray, np.ndarray]:
    """Device-layout planes (qs [K/2, N], scales [K/32, N], either possibly
    padded) -> row-major (codes [N, K], scales [N, K//32]) numpy, the
    padding stripped to the logical dims."""
    codes_t = split_unpack_lastdim(np.asarray(qs, np.uint8).T).T   # [K, N]
    return (np.ascontiguousarray(codes_t[:k_logical, :n_logical].T),
            np.ascontiguousarray(
                np.asarray(scales)[: k_logical // QBLOCK, :n_logical].T))


def matmul_weight_to_codes(w: QuantMatmulWeight, k_logical: int | None = None
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Device layout -> row-major (codes [N, K], scales [N, K//32]) numpy.
    Padding is stripped (N via n_logical; K via k_logical if given)."""
    return planes_to_codes(w.qs.cpu().numpy(), w.scales.cpu().numpy(),
                           k_logical or w.k, w.n_logical)


def make_embedding(codes: np.ndarray, scales: np.ndarray,
                   device=None) -> QuantEmbedding:
    """Build the row-major gather layout. codes uint8 [V, D], scales [V, D//32]."""
    dev = resolve_device(device)
    packed = split_pack_lastdim(codes)
    return QuantEmbedding(
        qs=torch.from_numpy(packed).to(dev),
        scales=torch.from_numpy(np.ascontiguousarray(scales, np.float32)).to(dev))


# ---------------------------------------------------------------------------
# torch dequantization (the plain path and the tests)
# ---------------------------------------------------------------------------

def unpack_codes(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """Packed bytes -> codes 0..15 (int32): the 16 low nibbles then the 16
    high nibbles of each block, concatenated along the 16-long `dim`."""
    p = packed.to(torch.int32)
    return torch.cat([p & 0x0F, p >> 4], dim=dim)


def dequant_matmul_weight(w: QuantMatmulWeight,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize the dense stored [K_pad, N_pad] weight: (q - 8) * d, or
    q * d + m for an affine weight (computed in f32, then cast)."""
    kh, n = w.qs.shape
    nb = kh // (QBLOCK // 2)
    codes = unpack_codes(w.qs.reshape(nb, QBLOCK // 2, n), 1)  # [nb, 32, N]
    scale = w.scales.reshape(nb, 1, n)
    if w.mins is None:
        dense = (codes.to(torch.float32) - 8.0) * scale
    else:
        dense = codes.to(torch.float32) * scale + w.mins.reshape(nb, 1, n)
    return dense.reshape(nb * QBLOCK, n).to(dtype)


def dequant_embedding_rows(table: QuantEmbedding, ids: torch.Tensor,
                           dtype=torch.float32) -> torch.Tensor:
    """Gather + dequantize rows: ids [...] -> [..., D]."""
    packed = table.qs[ids]                                      # [..., D/2]
    scales = table.scales[ids]                                  # [..., D/32]
    lead = packed.shape[:-1]
    nb = packed.shape[-1] // (QBLOCK // 2)
    codes = unpack_codes(packed.reshape(*lead, nb, QBLOCK // 2), -1) - 8
    dense = codes.to(torch.float32) * scales[..., None]
    return dense.reshape(*lead, nb * QBLOCK).to(dtype)
