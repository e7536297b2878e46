"""LLaMA-family forward pass (PyTorch port of fastllama_tpu/models/llama.py).

Parameters are plain dataclasses of tensors; the forward pass is a plain
function that runs eagerly on the parameters' device. Semantics as in the
JAX package:
  * rms_norm eps = 1e-6; interleaved RoPE; silu-gated FFN; f32 softmax
  * QKV and w1/w3 pre-fused (models/fuse.py)
  * per-layer slab KV caches [B, S, H*Dh], written at n_past ("dus" write);
    here the caches are updated in place and returned
  * LoRA adapters as separate additive LoraTerm fields

Kernel use (the same on every device; on the CPU each wrapper runs its
plain version): every q4 matmul goes through kernels/q4_matmul.q4_matmul
(B1, or B2+B3 for large-M int8 prefill); a decode step (T = 1) in bf16
weight mode without q/k/v LoRA runs the fused decode attention B4.
Prefill attention is plain PyTorch: masked f32 softmax over the cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import HyperParams, resolve_device
from ..kernels.decode_attention import decode_attention_fused
from ..kernels.q4_matmul import q4_matmul
from ..kernels.rope import lane_tables, rope_interleaved, rope_interleaved_lanes
from ..quant.tensor import (
    QuantEmbedding, QuantMatmulWeight, dequant_embedding_rows,
)
from .fuse import split_qkv, split_w13

Linear = Union[QuantMatmulWeight, torch.Tensor]   # dense weights are [K, N]
Embedding = Union[QuantEmbedding, torch.Tensor]   # dense tables are [V, D]
KVPair = tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class LoraTerm:
    """A LoRA adapter term: lora(x) = x @ delta  or  (x @ a) @ b."""
    delta: torch.Tensor | None = None   # [K, N]
    a: torch.Tensor | None = None       # [K, r]
    b: torch.Tensor | None = None       # [r, N]


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x.astype(w.dtype) @ w with f32 accumulation (JAX dot with
    preferred_element_type=f32: bf16 products are exact in f32)."""
    return x.to(w.dtype).to(torch.float32) @ w.to(torch.float32)


def apply_lora(x: torch.Tensor, t: LoraTerm) -> torch.Tensor:
    if t.delta is not None:
        return _dot(x, t.delta)
    return _dot(_dot(x, t.a), t.b)


@dataclasses.dataclass
class LayerParams:
    attention_norm: torch.Tensor       # [n_embd] f32
    wqkv: Linear                       # [D, 3D] fused
    wo: Linear                         # [D, D]
    ffn_norm: torch.Tensor             # [n_embd] f32
    w13: Linear                        # [D, 2F] fused
    w2: Linear                         # [F, D]
    lora_wq: LoraTerm | None = None
    lora_wk: LoraTerm | None = None
    lora_wv: LoraTerm | None = None
    lora_wo: LoraTerm | None = None
    lora_w1: LoraTerm | None = None
    lora_w2: LoraTerm | None = None
    lora_w3: LoraTerm | None = None


@dataclasses.dataclass
class LlamaParams:
    tok_embeddings: Embedding          # [n_vocab, n_embd]
    norm: torch.Tensor                 # [n_embd] f32
    output: Linear                     # [n_embd, n_vocab]
    layers: list[LayerParams]
    lora_output: LoraTerm | None = None


@dataclasses.dataclass(frozen=True)
class ForwardConfig:
    n_head: int
    n_rot: int
    rms_eps: float = 1e-6
    w_dtype: str = "bfloat16"       # dequantized-weight dtype of the matmuls
    act_dtype: str = "float32"      # residual-stream dtype
    all_logits: bool = False        # reference should_put_all_logits
    prefill_int8: bool | None = None

    @property
    def w_tdtype(self) -> torch.dtype:
        return getattr(torch, self.w_dtype)

    @property
    def act_tdtype(self) -> torch.dtype:
        return getattr(torch, self.act_dtype)


@dataclasses.dataclass
class PositionTables:
    """Positions 0..S-1 (int32 [S]) and their per-lane RoPE tables (cos,
    sin_signed: f32 [S, head_dim]), computed once per model; every forward
    slices its window out of them instead of recomputing (a dozen small
    launches per decode step)."""
    positions: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor


def position_tables(n_ctx: int, head_dim: int, n_rot: int,
                    device) -> PositionTables:
    pos = torch.arange(n_ctx, dtype=torch.int32, device=device)
    return PositionTables(pos, *lane_tables(pos, head_dim, n_rot))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight in f32 (one PyTorch operator, so
    the decode step launches one kernel here, not six)."""
    return F.rms_norm(x.to(torch.float32), (x.shape[-1],),
                      weight.to(torch.float32), eps).to(x.dtype)


def apply_linear(x: torch.Tensor, w: Linear, cfg: ForwardConfig) -> torch.Tensor:
    """y = x @ W for quantized or dense weights; f32 result."""
    if isinstance(w, QuantMatmulWeight):
        return q4_matmul(x, w, w_dtype=cfg.w_tdtype,
                         prefill_int8=cfg.prefill_int8)
    return _dot(x, w)


def embed_tokens(table: Embedding, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    n = table.qs.shape[0] if isinstance(table, QuantEmbedding) else table.shape[0]
    tokens = torch.clamp(tokens, 0, n - 1)
    if isinstance(table, QuantEmbedding):
        return dequant_embedding_rows(table, tokens, dtype=dtype)
    return table[tokens].to(dtype)


def _no_qkv_lora(layer: LayerParams) -> bool:
    return (layer.lora_wq is None and layer.lora_wk is None
            and layer.lora_wv is None)


def _attention(x: torch.Tensor, layer: LayerParams, n_past: int,
               positions: torch.Tensor, kv: KVPair, cfg: ForwardConfig,
               rope_ls, rope_bt, n_past_vec):
    """Self-attention for one layer. x [B, T, D]; positions [B, T].
    Returns attn_out [B, T, D]; kv is updated in place."""
    b, t, _ = x.shape
    h = cfg.n_head
    kv_k, kv_v = kv
    s = kv_k.shape[1]
    qkv = apply_linear(x, layer.wqkv, cfg)

    def finish(ctx):
        ctx = ctx.reshape(b, t, -1).to(cfg.act_tdtype)
        out = apply_linear(ctx, layer.wo, cfg)
        if layer.lora_wo is not None:
            out = out + apply_lora(ctx, layer.lora_wo)
        return out.to(cfg.act_tdtype)

    if rope_ls is not None and _no_qkv_lora(layer):
        hd = qkv.shape[-1] // (3 * h)
        return finish(decode_attention_fused(
            qkv.contiguous(), kv_k, kv_v, n_past_vec, rope_ls[0], rope_ls[1],
            head_dim=hd, n_rot=cfg.n_rot, scale=1.0 / math.sqrt(hd)))

    if rope_bt is not None and _no_qkv_lora(layer):
        d = qkv.shape[-1] // 3
        hd = d // h
        qk = qkv[..., :2 * d].reshape(b, t, 2 * h, hd)
        qk = rope_interleaved_lanes(qk, rope_bt[0], rope_bt[1], cfg.n_rot)
        q, k = qk[:, :, :h], qk[:, :, h:]
        v = qkv[..., 2 * d:].reshape(b, t, h, hd)
    else:
        q, k, v = split_qkv(qkv, h)
        hd = q.shape[-1]
        if layer.lora_wq is not None:
            q = q + apply_lora(x, layer.lora_wq).reshape(b, t, h, hd)
        if layer.lora_wk is not None:
            k = k + apply_lora(x, layer.lora_wk).reshape(b, t, h, hd)
        if layer.lora_wv is not None:
            v = v + apply_lora(x, layer.lora_wv).reshape(b, t, h, hd)
        if rope_bt is None:
            q = rope_interleaved(q, positions, cfg.n_rot)
            k = rope_interleaved(k, positions, cfg.n_rot)
        else:
            q = rope_interleaved_lanes(q, rope_bt[0], rope_bt[1], cfg.n_rot)
            k = rope_interleaved_lanes(k, rope_bt[0], rope_bt[1], cfg.n_rot)

    kv_k[:, n_past:n_past + t] = k.reshape(b, t, -1).to(kv_k.dtype)
    kv_v[:, n_past:n_past + t] = v.reshape(b, t, -1).to(kv_v.dtype)

    keys = kv_k.reshape(b, s, h, hd).to(torch.float32)
    vals = kv_v.reshape(b, s, h, hd).to(torch.float32)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32), keys) * scale
    mask = (torch.arange(s, device=x.device)[None, None, None, :]
            <= positions[:, None, :, None])
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return finish(torch.einsum("bhts,bshd->bthd", probs, vals))


def _ffn(x: torch.Tensor, layer: LayerParams, cfg: ForwardConfig) -> torch.Tensor:
    gate, up = split_w13(apply_linear(x, layer.w13, cfg))
    if layer.lora_w1 is not None:
        gate = gate + apply_lora(x, layer.lora_w1)
    if layer.lora_w3 is not None:
        up = up + apply_lora(x, layer.lora_w3)
    act = (F.silu(gate) * up).to(cfg.act_tdtype)
    out = apply_linear(act, layer.w2, cfg)
    if layer.lora_w2 is not None:
        out = out + apply_lora(act, layer.lora_w2)
    return out.to(cfg.act_tdtype)


def _n_out(w: Linear) -> int:
    return w.n_logical if isinstance(w, QuantMatmulWeight) else w.shape[1]


def forward(params: LlamaParams, tokens: torch.Tensor, n_past: int,
            kv_caches: list[KVPair], cfg: ForwardConfig,
            last_idx: int | None = None,
            tables: PositionTables | None = None):
    """The transformer forward pass.

    Args:
      tokens: [B, T] int (padded tokens allowed: their logits and cache rows
        are garbage that later writes overwrite).
      n_past: tokens already in the cache (one shared offset).
      kv_caches: per-layer (k, v), each [B, S, H*Dh]; updated in place.
      last_idx: index of the last valid token in the T window (default T-1);
        the non-all-logits head and the embeddings tap read this row.
      tables: position_tables covering n_past + T positions (built here
        when None).
    Returns (logits [B, T or 1, n_vocab] f32, kv_caches, embeddings [B, D]).
    """
    b, t = tokens.shape
    if last_idx is None:
        last_idx = t - 1
    hd = _n_out(params.layers[0].wqkv) // (3 * cfg.n_head)
    if tables is None:
        tables = position_tables(n_past + t, hd, cfg.n_rot, tokens.device)
    window = slice(n_past, n_past + t)
    positions = tables.positions[window][None, :].expand(b, t)
    x = embed_tokens(params.tok_embeddings, tokens, cfg.act_tdtype)

    rope_ls = rope_bt = n_past_vec = None
    if t == 1 and cfg.w_tdtype != torch.float32:
        n_past_vec = tables.positions[window].expand(b).contiguous()
        rope_ls = (tables.cos[window].expand(b, hd).contiguous(),
                   tables.sin[window].expand(b, hd).contiguous())
    elif t > 1:
        rope_bt = (tables.cos[window][None, :, None, :],
                   tables.sin[window][None, :, None, :])

    for layer, kv in zip(params.layers, kv_caches):
        attn_in = rms_norm(x, layer.attention_norm, cfg.rms_eps)
        x = x + _attention(attn_in, layer, n_past, positions, kv, cfg,
                           rope_ls, rope_bt, n_past_vec)
        x = x + _ffn(rms_norm(x, layer.ffn_norm, cfg.rms_eps), layer, cfg)

    x = rms_norm(x, params.norm, cfg.rms_eps)
    x_last = x[:, last_idx:last_idx + 1]
    embeddings = x_last[:, 0, :].to(torch.float32)
    head_in = x if cfg.all_logits else x_last
    logits = apply_linear(head_in, params.output, cfg)
    if params.lora_output is not None:
        logits = logits + apply_lora(head_in.to(torch.float32),
                                     params.lora_output)
    return logits.to(torch.float32), kv_caches, embeddings


def init_kv_cache(hp: HyperParams, batch: int, n_ctx: int,
                  dtype=torch.bfloat16, device=None) -> list[KVPair]:
    """Per-layer zeroed caches, each [batch, n_ctx, n_head * head_dim]."""
    dev = resolve_device(device)
    shape = (batch, n_ctx, hp.n_head * hp.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(hp.n_layer)]


# ---------------------------------------------------------------------------
# Carrying weights across from the JAX package
# ---------------------------------------------------------------------------

def _linear_from_numpy(leaf, dev) -> Linear:
    if isinstance(leaf, dict):
        return QuantMatmulWeight(
            qs=torch.from_numpy(np.array(leaf["qs"], np.uint8)).to(dev),
            scales=torch.from_numpy(
                np.array(leaf["scales"], np.float32)).to(dev),
            n_logical=int(leaf["n_logical"]))
    return torch.from_numpy(np.array(leaf)).to(dev)


def _f32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dev)


def params_from_numpy(tree: dict, device=None) -> LlamaParams:
    """The port's parameters from the JAX LlamaParams leaves as numpy, in the
    JAX layout (a copy: both packages store the same planes).

    tree = {"tok_embeddings": {"qs": uint8 [V, D/2], "scales": f32 [V, D/32]}
                              or a dense [V, D] array,
            "norm": [D],
            "output": LEAF,
            "layers": [{"attention_norm": [D], "wqkv": LEAF, "wo": LEAF,
                        "ffn_norm": [D], "w13": LEAF, "w2": LEAF}, ...]}
    where a quantized LEAF is {"qs": uint8 [K_pad/2, N_pad] split-K packed,
    "scales": f32 [K_pad/32, N_pad], "n_logical": int} and a dense LEAF is
    a [K, N] array. The caller converts the JAX arrays with np.asarray."""
    dev = resolve_device(device)
    emb = tree["tok_embeddings"]
    if isinstance(emb, dict):
        emb = QuantEmbedding(
            qs=torch.from_numpy(np.array(emb["qs"], np.uint8)).to(dev),
            scales=_f32(emb["scales"], dev))
    else:
        emb = torch.from_numpy(np.array(emb)).to(dev)
    layers = [LayerParams(
        attention_norm=_f32(lt["attention_norm"], dev),
        wqkv=_linear_from_numpy(lt["wqkv"], dev),
        wo=_linear_from_numpy(lt["wo"], dev),
        ffn_norm=_f32(lt["ffn_norm"], dev),
        w13=_linear_from_numpy(lt["w13"], dev),
        w2=_linear_from_numpy(lt["w2"], dev),
    ) for lt in tree["layers"]]
    return LlamaParams(tok_embeddings=emb, norm=_f32(tree["norm"], dev),
                       output=_linear_from_numpy(tree["output"], dev),
                       layers=layers)
