"""Random-weight models at real widths, made on the device from a seed.

The port's counterpart of the JAX package's `__graft_entry__._build_model`,
which bench.py and the JAX tools build their models with: random q4_0 codes
(0-255) and scales uniform in [1e-3, dtype_scale], unit norms, and every
matmul plane stored with the padding the loader applies (good_pad_k,
good_pad_n). Decode and prefill speed do not depend on the weights' values,
so these models time the path as a checkpoint would. The values come from a
torch.Generator on the device, so they are not the JAX builder's.
"""
from __future__ import annotations

import torch

from ..config import HyperParams, resolve_device
from ..quant.tensor import (
    QuantEmbedding, QuantMatmulWeight, good_pad_k, good_pad_n,
)
from .llama import LayerParams, LlamaParams


def _scales(shape, gen, dev, dtype_scale):
    return (torch.rand(shape, generator=gen, device=dev)
            * (dtype_scale - 1e-3) + 1e-3)


def rand_weight(k: int, n: int, gen: torch.Generator, device=None,
                affine: bool = False, pad_n: int | None = None,
                dtype_scale: float = 0.02) -> QuantMatmulWeight:
    """A q4_0 matmul weight of logical shape [k, n] with the stored padding
    the loader applies: random codes, scales in [1e-3, dtype_scale].
    affine: a q4_1 weight, with mins in about [-8 d, -7 d] so that q d + m
    is centred like (q - 8) d. pad_n: N padded to a multiple of it instead
    of good_pad_n's rule."""
    dev = gen.device if device is None else torch.device(device)
    kp = good_pad_k(k)
    np_ = good_pad_n(n) if pad_n is None else -(-n // pad_n) * pad_n
    qs = torch.randint(0, 256, (kp // 2, np_), generator=gen, device=dev,
                       dtype=torch.uint8)
    sc = _scales((kp // 32, np_), gen, dev, dtype_scale)
    mins = None
    if affine:
        mins = sc * (torch.rand((kp // 32, np_), generator=gen, device=dev)
                     - 8.0)
    return QuantMatmulWeight(qs=qs, scales=sc, mins=mins, n_logical=n)


def rand_params(hp: HyperParams, gen: torch.Generator, device=None,
                affine: bool = False, n_ff: int | None = None,
                dtype_scale: float = 0.02) -> LlamaParams:
    """Every parameter of a model at hp's widths (n_ff: the FFN width,
    hp.n_ff by default), drawn from gen in a fixed order."""
    dev = gen.device if device is None else torch.device(device)
    d, f = hp.n_embd, n_ff or hp.n_ff

    def w(k, n):
        return rand_weight(k, n, gen, dev, affine, dtype_scale=dtype_scale)
    layers = [LayerParams(
        attention_norm=torch.ones(d, device=dev), wqkv=w(d, 3 * d),
        wo=w(d, d), ffn_norm=torch.ones(d, device=dev), w13=w(d, 2 * f),
        w2=w(f, d)) for _ in range(hp.n_layer)]
    emb = QuantEmbedding(
        qs=torch.randint(0, 256, (hp.n_vocab, d // 2), generator=gen,
                         device=dev, dtype=torch.uint8),
        scales=_scales((hp.n_vocab, d // 32), gen, dev, dtype_scale))
    return LlamaParams(tok_embeddings=emb, norm=torch.ones(d, device=dev),
                       output=w(d, hp.n_vocab), layers=layers)


def build_model(hp: HyperParams, n_ff: int | None = None, seed: int = 0,
                dtype_scale: float = 0.02, device=None,
                affine: bool = False) -> LlamaParams:
    """A random q4_0 (affine: q4_1) model at hp's widths and depth on
    `device` (the card unless the caller names another), from a generator
    seeded with `seed`: `_build_model(hp, n_ff, seed, dtype_scale=...)` of
    the JAX package."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return rand_params(hp, gen, dev, affine, n_ff, dtype_scale)
