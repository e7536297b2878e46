"""LLaMA-family forward pass (PyTorch port of fastllama_tpu/models/llama.py).

Parameters are plain dataclasses of tensors; the forward pass is a plain
function that runs eagerly on the parameters' device. Semantics as in the
JAX package:
  * rms_norm eps = 1e-6; interleaved RoPE; silu-gated FFN; f32 softmax
  * QKV and w1/w3 pre-fused (models/fuse.py)
  * per-layer slab KV caches [B, S, H*Dh], written at n_past: one shared
    int offset (the session), or an int32 [B] tensor of per-slot depths (the
    batching engine), whose rows at or past S are dropped; the caches are
    updated in place and returned
  * forward_paged_decode / forward_paged_prefill run the same layers over
    the paged pools of engine/paged_kv.py
  * LoRA adapters as separate additive LoraTerm fields
  * under a mesh (parallel/), ForwardConfig carries the process groups:
    tp_group (Megatron tensor parallelism: a vocab-sharded embedding, a psum
    after wo and after w2, the logits all-gathered) and sp_group (sequence
    parallelism: ring-attention prefill and split-S decode, parallel/ring);
    with no group every path is the single-device one

Kernel use (the same on every device; on the CPU each wrapper runs its
plain version): every 4-bit matmul goes through kernels/q4_matmul.q4_matmul
(B1 or B9 at decode size, B2+B3 or B5 for large-M prefill); a decode step
(T = 1) in bf16 weight mode runs the fused decode attention B4 in a layer
without q/k/v LoRA and, in a layer with it, adds the LoRA terms, ropes,
writes the cache row and runs the decode attention B10. The paged decode
step writes the new row with B7 and attends with B6. A fresh-prompt prefill
whose caller sets ForwardConfig.flash_prefill attends over its own window
with the flash kernel B12 where _flash_viable holds (the JAX package's
gate), on bf16 operands: the RoPE pass stores q and k in bf16, and a bf16
slab cache hands over the K/V rows it has just stored; every other prefill
window (and f32-mode slab decode) is plain
PyTorch: masked f32 softmax over the cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import HyperParams, resolve_device
from ..kernels.decode_attention import (
    decode_attention, decode_attention_fused, masked_attention,
)
from ..kernels.flash_prefill import HEAD_DIMS as FLASH_HEAD_DIMS
from ..kernels.flash_prefill import flash_prefill
from ..kernels.kv_write import paged_kv_write, scatter_rows_drop
from ..kernels.paged_attention import (
    paged_decode_attention, paged_decode_step_fused,
)
from ..kernels.q4_matmul import q4_matmul
from ..kernels.rope import lane_tables, rope_interleaved, rope_interleaved_lanes
from ..parallel.collectives import all_gather, axis_index, psum
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


LORA_FIELDS = ("lora_wq", "lora_wk", "lora_wv", "lora_wo", "lora_w1",
               "lora_w2", "lora_w3")


@dataclasses.dataclass
class LlamaParams:
    tok_embeddings: Embedding          # [n_vocab, n_embd]
    norm: torch.Tensor                 # [n_embd] f32
    output: Linear                     # [n_embd, n_vocab]
    layers: list[LayerParams]
    lora_output: LoraTerm | None = None
    # (rank, tp) once parallel/sharding.shard_params made these a model-axis
    # rank's own parameters; None for the whole model
    tp_shard: tuple[int, int] | None = None


@dataclasses.dataclass(frozen=True)
class ForwardConfig:
    n_head: int
    n_rot: int
    rms_eps: float = 1e-6
    w_dtype: str = "bfloat16"       # dequantized-weight dtype of the matmuls
    act_dtype: str = "float32"      # residual-stream dtype
    all_logits: bool = False        # reference should_put_all_logits
    prefill_int8: bool | None = None
    # Tensor-parallel process group (parallel/sharding.py): n_head is then
    # the rank's LOCAL head count. None = single-device semantics.
    tp_group: object = None
    # Sequence-parallel group (parallel/ring.py) and its size: the KV
    # cache's sequence axis is sharded over it (cache row == global
    # position) and a prefill window arrives T-sharded. sp_chunked seeds the
    # ring's online softmax with the cache prefix (rows < n_past), so
    # windows can arrive in n_batch chunks.
    sp_group: object = None
    sp_size: int = 1
    sp_chunked: bool = False
    # Caller's promise that this forward only ever runs with n_past == 0
    # (fresh-prompt prefill). Lets attention use the flash kernel B12 over
    # just the in-window K/V (online softmax, no [T, S] scores in device
    # memory) instead of attending into the (empty) cache. Set by the
    # prefill entry points; decode calls must leave it False.
    flash_prefill: bool = False

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
                 dtype: torch.dtype,
                 cfg: ForwardConfig | None = None) -> torch.Tensor:
    n = table.qs.shape[0] if isinstance(table, QuantEmbedding) else table.shape[0]
    valid = None
    if cfg is not None and cfg.tp_group is not None:
        # vocab-sharded lookup: each rank gathers its rows for the ids in
        # its range, zeros the rest, and a psum assembles the embedding
        tokens = tokens - axis_index(cfg.tp_group) * n
        valid = (tokens >= 0) & (tokens < n)
    tokens = torch.clamp(tokens, 0, n - 1)
    if isinstance(table, QuantEmbedding):
        emb = dequant_embedding_rows(table, tokens, dtype=dtype)
    else:
        emb = table[tokens].to(dtype)
    if valid is None:
        return emb
    return psum(torch.where(valid[..., None], emb, 0).to(dtype),
                cfg.tp_group)


def _tp_sum(out: torch.Tensor, cfg: ForwardConfig) -> torch.Tensor:
    """The sum of a reduction-sharded matmul's partials over the TP group
    (wo and w2 hold a rank's rows)."""
    return out if cfg.tp_group is None else psum(out, cfg.tp_group)


def _head(head_in: torch.Tensor, params: "LlamaParams",
          cfg: ForwardConfig, lora: bool = False) -> torch.Tensor:
    """The output head, f32 [..., n_vocab]: the vocab-sharded head's local
    logits (its n_logical is the local width, so no padded column leaves
    the rank) all-gathered over the TP group."""
    logits = apply_linear(head_in, params.output, cfg)
    if lora and params.lora_output is not None:
        logits = logits + apply_lora(head_in.to(torch.float32),
                                     params.lora_output)
    if cfg.tp_group is not None:
        logits = all_gather(logits, cfg.tp_group, dim=-1)
    return logits.to(torch.float32)


def _no_qkv_lora(layer: LayerParams) -> bool:
    return (layer.lora_wq is None and layer.lora_wk is None
            and layer.lora_wv is None)


def _project_out(ctx: torch.Tensor, layer: LayerParams, cfg: ForwardConfig,
                 b: int, t: int) -> torch.Tensor:
    """The attention output projection: ctx [B, T, H, Dh] or [B, T, F] ->
    wo (plus its LoRA term) in the residual dtype."""
    ctx = ctx.reshape(b, t, -1).to(cfg.act_tdtype)
    out = apply_linear(ctx, layer.wo, cfg)
    if layer.lora_wo is not None:
        out = out + apply_lora(ctx, layer.lora_wo)
    return _tp_sum(out, cfg).to(cfg.act_tdtype)


def _qkv_lora(x: torch.Tensor, layer: LayerParams, q, k, v):
    """q, k, v [B, T, H, Dh] plus the layer's attention-projection LoRA
    terms."""
    b, t, h, hd = q.shape
    if layer.lora_wq is not None:
        q = q + apply_lora(x, layer.lora_wq).reshape(b, t, h, hd)
    if layer.lora_wk is not None:
        k = k + apply_lora(x, layer.lora_wk).reshape(b, t, h, hd)
    if layer.lora_wv is not None:
        v = v + apply_lora(x, layer.lora_wv).reshape(b, t, h, hd)
    return q, k, v


def _write_rows_drop(cache: torch.Tensor, val: torch.Tensor,
                     positions: torch.Tensor) -> None:
    """cache[b, positions[b, t]] = val[b, t], in place, for positions inside
    the cache; a row whose position is at or past S is not written (the JAX
    scatter with mode="drop": an inactive engine slot runs at n_ctx + 1, and
    a padded chunk tail can pass n_ctx)."""
    b, s, f = cache.shape
    pos = positions.to(torch.int64)
    ok = ((pos >= 0) & (pos < s)).reshape(-1)
    flat = (pos + torch.arange(b, device=pos.device)[:, None] * s).reshape(-1)
    scatter_rows_drop(cache.view(1, b * s, f), flat, ok,
                      val.reshape(1, -1, f))


def _flash_viable(cfg: ForwardConfig, t: int, hd: int) -> bool:
    """The JAX package's gate for the flash-prefill path: the caller's
    n_past == 0 promise, no sequence parallelism, lane-aligned shapes, the
    bf16 weight mode (the f32 parity contract keeps the masked f32 path).
    Where JAX also asks for the TPU backend, the wrapper here picks the
    kernel or its plain version by the tensors' device. One departure: of
    the head widths that are multiples of 128 it admits those B12 is built
    for (128, 256); a wider head takes the masked route, within bf16
    tolerance of the JAX flash path."""
    return (cfg.flash_prefill and cfg.sp_group is None
            and t >= 128 and t % 128 == 0
            and hd in FLASH_HEAD_DIMS and cfg.w_tdtype != torch.float32)


def _flash_operands(q, k, v, kv_k, kv_v):
    """bf16 q, k, v [B, T, H, Dh] for B12 on the slab path. At n_past 0
    (the flash route's promise) write_kv has just stored bf16(k) and
    bf16(v) in rows 0..T-1 of a bf16 cache, the values the kernel needs:
    K and V are views of those rows (strides S F, F, Dh, 1), and q is the
    RoPE pass's bf16 output. Other caches (f32, f16) give casts."""
    b, t, h, hd = q.shape
    if kv_k.dtype == torch.bfloat16 and kv_k.shape[1] >= t:
        return (q.to(torch.bfloat16), kv_k[:, :t].view(b, t, h, hd),
                kv_v[:, :t].view(b, t, h, hd))
    return tuple(x.to(torch.bfloat16) for x in (q, k, v))


def _attention(x: torch.Tensor, layer: LayerParams, write_kv,
               positions: torch.Tensor, kv: KVPair, cfg: ForwardConfig,
               rope_ls, rope_bt, n_past_vec):
    """Self-attention for one layer. x [B, T, D]; positions [B, T];
    write_kv(cache, rows [B, T, F]) stores the window's rows. Returns
    attn_out [B, T, D]; kv is updated in place."""
    b, t, _ = x.shape
    h = cfg.n_head
    kv_k, kv_v = kv
    qkv = apply_linear(x, layer.wqkv, cfg)
    flash = _flash_viable(cfg, t, qkv.shape[-1] // (3 * h))
    # on the flash route into a bf16 cache RoPE stores q and k in bf16: the
    # kernel's operands, and the values the cache write rounds k to
    rope_dtype = (torch.bfloat16 if flash and kv_k.dtype == torch.bfloat16
                  else None)

    def finish(ctx):
        return _project_out(ctx, layer, cfg, b, t)

    if rope_ls is not None and _no_qkv_lora(layer):
        hd = qkv.shape[-1] // (3 * h)
        return finish(decode_attention_fused(
            qkv.contiguous(), kv_k, kv_v, n_past_vec, rope_ls[0], rope_ls[1],
            head_dim=hd, n_rot=cfg.n_rot, scale=1.0 / math.sqrt(hd)))

    if rope_bt is not None and _no_qkv_lora(layer):
        d = qkv.shape[-1] // 3
        hd = d // h
        qk = qkv[..., :2 * d].reshape(b, t, 2 * h, hd)
        qk = rope_interleaved_lanes(qk, rope_bt[0], rope_bt[1], cfg.n_rot,
                                    rope_dtype)
        q, k = qk[:, :, :h], qk[:, :, h:]
        v = qkv[..., 2 * d:].reshape(b, t, h, hd)
    else:
        q, k, v = _qkv_lora(x, layer, *split_qkv(qkv, h))
        hd = q.shape[-1]
        # the per-lane form is the rope_interleaved rotation bit for bit
        # (the minus sign is folded into the table); q and k in one call
        lanes = rope_bt if rope_bt is not None else (
            None if rope_ls is None else
            (rope_ls[0][:, None, None, :], rope_ls[1][:, None, None, :]))
        if lanes is None:
            q = rope_interleaved(q, positions, cfg.n_rot)
            k = rope_interleaved(k, positions, cfg.n_rot)
        else:
            qk = rope_interleaved_lanes(torch.cat([q, k], dim=2), lanes[0],
                                        lanes[1], cfg.n_rot, rope_dtype)
            q, k = qk[:, :, :h], qk[:, :, h:]

    scale = 1.0 / math.sqrt(hd)
    if cfg.sp_group is not None:
        return finish(_sp_attention(q, k, v, kv_k, kv_v, positions, cfg,
                                    scale))

    write_kv(kv_k, k.reshape(b, t, -1).to(kv_k.dtype))
    write_kv(kv_v, v.reshape(b, t, -1).to(kv_v.dtype))

    if flash:
        # a fresh prompt (n_past == 0, the caller's promise): the window's
        # own K/V is the whole context, so B12 attends it in place of the
        # masked softmax over the cache
        return finish(flash_prefill(*_flash_operands(q, k, v, kv_k, kv_v)))
    if rope_ls is not None:
        # a bf16 decode step whose layer has q/k/v LoRA: kernel B10 over
        # the cache that now holds this token's row
        return finish(decode_attention(
            q.reshape(b, 1, -1).contiguous(), kv_k, kv_v, n_past_vec,
            head_dim=hd, scale=scale))
    return finish(masked_attention(q, kv_k, kv_v, positions, h, scale))


def _sp_attention(q, k, v, kv_k, kv_v, positions, cfg: ForwardConfig,
                  scale: float) -> torch.Tensor:
    """Attention over a sequence-sharded cache (parallel/ring.py): the
    decode step writes its row on the owner rank and merges the ranks'
    partials; a prefill window runs the ring, seeded with the cache prefix
    when chunked (its start: this rank's first position less its chunk
    offset)."""
    from ..parallel.ring import (
        ring_prefill, sp_decode_attention, sp_write_decode,
    )
    t = q.shape[1]
    if t == 1:
        sp_write_decode(kv_k, kv_v, k, v, positions[:, 0], cfg.sp_group)
        return sp_decode_attention(q, kv_k, kv_v, positions[:, 0],
                                   cfg.sp_group, cfg.n_head, scale)
    win_start = None
    if cfg.sp_chunked:
        win_start = positions[:, 0] - axis_index(cfg.sp_group) * t
    return ring_prefill(q, k, v, kv_k, kv_v, positions, cfg.sp_group,
                        cfg.sp_size, scale, win_start)


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
    return _tp_sum(out, cfg).to(cfg.act_tdtype)


def _n_out(w: Linear) -> int:
    return w.n_logical if isinstance(w, QuantMatmulWeight) else w.shape[1]


def _position_lanes(tables: PositionTables | None, positions: torch.Tensor,
                    hd: int, n_rot: int):
    """Per-lane RoPE tables (cos, sin_signed) [*positions.shape, hd] for an
    int32 position grid on the device: gathered from the model's tables, the
    positions clipped to their length, or computed when there are none."""
    if tables is None:
        return lane_tables(positions, hd, n_rot)
    idx = positions.clamp(0, tables.cos.shape[0] - 1).reshape(-1)
    return (tables.cos.index_select(0, idx).reshape(*positions.shape, hd),
            tables.sin.index_select(0, idx).reshape(*positions.shape, hd))


def forward(params: LlamaParams, tokens: torch.Tensor,
            n_past: "int | torch.Tensor",
            kv_caches: list[KVPair], cfg: ForwardConfig,
            last_idx: int | None = None,
            tables: PositionTables | None = None):
    """The transformer forward pass.

    Args:
      tokens: [B, T] int (padded tokens allowed: their logits and cache rows
        are garbage that later writes overwrite).
      n_past: tokens already in the cache. An int is one shared offset (the
        session). An int32 tensor [B] (or [1]) gives each row its own depth
        (the batching engine): the rows are written by a scatter that drops
        positions at or past S, and nothing is read back to the host.
      kv_caches: per-layer (k, v), each [B, S, H*Dh]; updated in place.
      last_idx: index of the last valid token in the T window (default T-1);
        the non-all-logits head and the embeddings tap read this row.
      tables: position_tables covering the window (built here when None).
        With per-row depths the tables are gathered at the positions clipped
        to the tables' length, where the JAX package computes the angles from
        the position itself: a clipped row is one whose write is dropped.
    Returns (logits [B, T or 1, n_vocab] f32, kv_caches, embeddings [B, D]).
    """
    b, t = tokens.shape
    if last_idx is None:
        last_idx = t - 1
    hd = _n_out(params.layers[0].wqkv) // (3 * cfg.n_head)
    x = embed_tokens(params.tok_embeddings, tokens, cfg.act_tdtype, cfg)
    rope_ls = rope_bt = n_past_vec = None
    # no fused decode kernel over a sequence-sharded cache: SP decode is
    # the split-S merge of parallel/ring.py
    decode_kernels = (t == 1 and cfg.w_tdtype != torch.float32
                      and cfg.sp_group is None)

    if isinstance(n_past, torch.Tensor):
        positions = (n_past.to(torch.int32).reshape(-1, 1) + torch.arange(
            t, dtype=torch.int32, device=tokens.device)[None, :]).expand(b, t)
        if decode_kernels or t > 1:
            cos, sin = _position_lanes(tables, positions, hd, cfg.n_rot)
            if t == 1:
                n_past_vec = positions[:, 0].contiguous()
                rope_ls = (cos[:, 0].contiguous(), sin[:, 0].contiguous())
            else:
                rope_bt = (cos[:, :, None, :], sin[:, :, None, :])

        def write_kv(cache, rows):
            _write_rows_drop(cache, rows, positions)
    elif cfg.sp_group is not None:
        # SP: the window arrives T-sharded, so this rank's chunk starts at
        # its offset; a padded tail may run past the tables (its rows drop)
        start = n_past + (axis_index(cfg.sp_group) * t if t > 1 else 0)
        positions = torch.arange(start, start + t, dtype=torch.int32,
                                 device=tokens.device)[None, :].expand(b, t)
        if t > 1:
            cos, sin = _position_lanes(tables, positions, hd, cfg.n_rot)
            rope_bt = (cos[:, :, None, :], sin[:, :, None, :])
        write_kv = None
    else:
        if tables is None:
            tables = position_tables(n_past + t, hd, cfg.n_rot, tokens.device)
        window = slice(n_past, n_past + t)
        positions = tables.positions[window][None, :].expand(b, t)
        if decode_kernels:
            n_past_vec = tables.positions[window].expand(b).contiguous()
            rope_ls = (tables.cos[window].expand(b, hd).contiguous(),
                       tables.sin[window].expand(b, hd).contiguous())
        elif t > 1:
            rope_bt = (tables.cos[window][None, :, None, :],
                       tables.sin[window][None, :, None, :])

        def write_kv(cache, rows):
            cache[:, window] = rows

    for layer, kv in zip(params.layers, kv_caches):
        attn_in = rms_norm(x, layer.attention_norm, cfg.rms_eps)
        x = x + _attention(attn_in, layer, write_kv, positions, kv, cfg,
                           rope_ls, rope_bt, n_past_vec)
        x = x + _ffn(rms_norm(x, layer.ffn_norm, cfg.rms_eps), layer, cfg)

    x = rms_norm(x, params.norm, cfg.rms_eps)
    if cfg.sp_group is not None and t > 1:
        # last_idx is GLOBAL: its owner rank contributes the row, zeros
        # elsewhere, and the psum makes it whole on every rank
        base = axis_index(cfg.sp_group) * t
        loc = min(max(last_idx - base, 0), t - 1)
        x_last = x[:, loc:loc + 1]
        if not base <= last_idx < base + t:
            x_last = torch.zeros_like(x_last)
        x_last = psum(x_last, cfg.sp_group)
    else:
        x_last = x[:, last_idx:last_idx + 1]
    embeddings = x_last[:, 0, :].to(torch.float32)
    logits = _head(x if cfg.all_logits else x_last, params, cfg, lora=True)
    if cfg.sp_group is not None and cfg.all_logits and t > 1:
        logits = all_gather(logits, cfg.sp_group, dim=1)
    return logits, kv_caches, embeddings


# ---------------------------------------------------------------------------
# The paged paths (engine/paged_kv.py pools)
# ---------------------------------------------------------------------------

def _roped_qkv(x, layer: LayerParams, cfg: ForwardConfig, rope_bt,
               rope_dtype=None):
    """(q, k, v) [B, T, H, Dh] of one layer: the fused projection, the
    q/k/v LoRA terms, then RoPE on q and k in one per-lane pass (stored as
    rope_dtype, f32 by default)."""
    h = cfg.n_head
    q, k, v = _qkv_lora(x, layer, *split_qkv(apply_linear(x, layer.wqkv, cfg),
                                             h))
    qk = rope_interleaved_lanes(torch.cat([q, k], dim=2), rope_bt[0],
                                rope_bt[1], cfg.n_rot, rope_dtype)
    return qk[:, :, :h], qk[:, :, h:], v


def forward_paged_decode(params: LlamaParams, tokens: torch.Tensor,
                         lengths: torch.Tensor, page_tables: torch.Tensor,
                         k_pages: list[torch.Tensor],
                         v_pages: list[torch.Tensor],
                         page_ids: torch.Tensor, offsets: torch.Tensor,
                         cfg: ForwardConfig,
                         tables: PositionTables | None = None):
    """One decode step over a paged KV cache (engine/paged_kv.py).

    Args:
      tokens: [B, 1]; lengths: int32 [B] tokens already resident (the new
        token's position); page_tables: int32 [B, pages_per_seq];
        k_pages/v_pages: per layer [H, P, ps, Dh], updated in place;
        page_ids/offsets: int32 [B] physical write location of the new token
        (from PagedKVManager; the sentinel id for an inactive slot).
    A layer without q/k/v LoRA terms runs the fused step (RoPE, the new
    row's write and the attention over lengths + 1 keys in one kernel,
    paged_decode_step_fused); a layer with them adds the terms to q, k and
    v first, then writes the row with kernel B7 and attends with kernel B6
    (plain versions for CPU tensors).
    Returns (logits [B, 1, V] f32, k_pages, v_pages).
    """
    b = tokens.shape[0]
    hd = k_pages[0].shape[3]
    x = embed_tokens(params.tok_embeddings, tokens, cfg.act_tdtype, cfg)
    cos, sin = _position_lanes(tables, lengths[:, None], hd, cfg.n_rot)
    rope_bt = (cos[:, :, None, :], sin[:, :, None, :])
    attend = lengths + 1

    for layer, kp, vp in zip(params.layers, k_pages, v_pages):
        attn_in = rms_norm(x, layer.attention_norm, cfg.rms_eps)
        if _no_qkv_lora(layer):
            qkv = apply_linear(attn_in, layer.wqkv, cfg)
            ctx = paged_decode_step_fused(
                qkv.reshape(b, -1).to(torch.float32), kp, vp, lengths,
                page_tables, page_ids, offsets, cos[:, 0], sin[:, 0])
        else:
            q, k, v = _roped_qkv(attn_in, layer, cfg, rope_bt)
            paged_kv_write(kp, vp, k[:, 0].contiguous(),
                           v[:, 0].contiguous(), page_ids, offsets)
            ctx = paged_decode_attention(q[:, 0], kp, vp, attend, page_tables)
        x = x + _project_out(ctx, layer, cfg, b, 1)
        x = x + _ffn(rms_norm(x, layer.ffn_norm, cfg.rms_eps), layer, cfg)

    x = rms_norm(x, params.norm, cfg.rms_eps)
    return _head(x, params, cfg), k_pages, v_pages


def forward_paged_prefill(params: LlamaParams, tokens: torch.Tensor,
                          last_idx: int, page_ids: torch.Tensor,
                          offsets: torch.Tensor,
                          k_pages: list[torch.Tensor],
                          v_pages: list[torch.Tensor], cfg: ForwardConfig,
                          tables: PositionTables | None = None):
    """Prefill a FRESH sequence into the paged cache.

    A fresh slot needs no cache reads: causal self-attention over the prompt
    block itself, with the block's K/V scattered into the sequence's pages
    by write_tokens_paged. Where _flash_viable holds (cfg.flash_prefill, as
    the engine's admission sets it) the block attends through B12;
    otherwise through a masked f32 softmax over the unrounded K and V of
    the block. tokens [1, T] (bucketed; the padded tail carries sentinel
    page ids). Returns (last_logits [1, V] f32, k_pages, v_pages).
    """
    from ..engine.paged_kv import write_tokens_paged
    b, t = tokens.shape
    hd = k_pages[0].shape[3]
    dev = tokens.device
    positions = torch.arange(t, dtype=torch.int32, device=dev)[None, :].expand(
        b, t)
    cos, sin = _position_lanes(tables, positions, hd, cfg.n_rot)
    rope_bt = (cos[:, :, None, :], sin[:, :, None, :])
    causal = positions[0][None, :] <= positions[0][:, None]      # [T, T]
    scale = 1.0 / math.sqrt(hd)
    flash = _flash_viable(cfg, t, hd)
    # on the flash route into bf16 pools RoPE stores q and k in bf16 (the
    # pool write rounds k so anyway); v is cast for the kernel, whose K/V
    # rows are the window's own (the pages hold them in another order)
    rope_dtype = (torch.bfloat16
                  if flash and k_pages[0].dtype == torch.bfloat16 else None)
    x = embed_tokens(params.tok_embeddings, tokens, cfg.act_tdtype, cfg)

    for layer, kp, vp in zip(params.layers, k_pages, v_pages):
        attn_in = rms_norm(x, layer.attention_norm, cfg.rms_eps)
        q, k, v = _roped_qkv(attn_in, layer, cfg, rope_bt, rope_dtype)
        write_tokens_paged(kp, vp, k, v, page_ids[None, :], offsets[None, :])
        if flash:
            ctx = flash_prefill(*(x_.to(torch.bfloat16) for x_ in (q, k, v)))
        else:
            scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                                  k.to(torch.float32)) * scale
            scores = torch.where(causal[None, None], scores,
                                 torch.full_like(scores, -1e30))
            ctx = torch.einsum("bhts,bshd->bthd",
                               torch.softmax(scores, dim=-1),
                               v.to(torch.float32))
        x = x + _project_out(ctx, layer, cfg, b, t)
        x = x + _ffn(rms_norm(x, layer.ffn_norm, cfg.rms_eps), layer, cfg)

    x = rms_norm(x, params.norm, cfg.rms_eps)
    logits = _head(x[:, last_idx:last_idx + 1], params, cfg)
    return logits[:, 0], k_pages, v_pages


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

def _f32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dev)


def _linear_from_numpy(leaf, dev) -> Linear:
    if isinstance(leaf, dict):
        mins = leaf.get("mins")
        return QuantMatmulWeight(
            qs=torch.from_numpy(np.array(leaf["qs"], np.uint8)).to(dev),
            scales=_f32(leaf["scales"], dev),
            mins=None if mins is None else _f32(mins, dev),
            n_logical=int(leaf["n_logical"]))
    return _dense(leaf, dev)


def _dense(a, dev) -> torch.Tensor:
    """A dense array in its own dtype. A bf16 JAX array arrives with the
    ml_dtypes bfloat16 dtype, which torch.from_numpy does not take: it goes
    through f32 (exact) and back."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def _lora_from_numpy(leaf, dev) -> LoraTerm | None:
    if leaf is None:
        return None
    return LoraTerm(**{k: _dense(v, dev) for k, v in leaf.items()})


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
    "scales": f32 [K_pad/32, N_pad], "n_logical": int} plus, for an affine
    (q4_1) weight, "mins": f32 [K_pad/32, N_pad], and a dense LEAF is a
    [K, N] array. A layer may carry "lora_wq" ... "lora_w3" and the tree
    "lora_output", each {"delta": [K, N]} or {"a": [K, r], "b": [r, N]}, so
    a JAX model with an adapter attached carries across. The caller converts
    the JAX arrays with np.asarray."""
    dev = resolve_device(device)
    emb = tree["tok_embeddings"]
    if isinstance(emb, dict):
        emb = QuantEmbedding(
            qs=torch.from_numpy(np.array(emb["qs"], np.uint8)).to(dev),
            scales=_f32(emb["scales"], dev))
    else:
        emb = _dense(emb, dev)
    layers = [LayerParams(
        attention_norm=_f32(lt["attention_norm"], dev),
        wqkv=_linear_from_numpy(lt["wqkv"], dev),
        wo=_linear_from_numpy(lt["wo"], dev),
        ffn_norm=_f32(lt["ffn_norm"], dev),
        w13=_linear_from_numpy(lt["w13"], dev),
        w2=_linear_from_numpy(lt["w2"], dev),
        **{f: _lora_from_numpy(lt.get(f), dev) for f in LORA_FIELDS},
    ) for lt in tree["layers"]]
    return LlamaParams(tok_embeddings=emb, norm=_f32(tree["norm"], dev),
                       output=_linear_from_numpy(tree["output"], dev),
                       layers=layers,
                       lora_output=_lora_from_numpy(tree.get("lora_output"),
                                                    dev))
