"""Sequence parallelism: ring-attention prefill + split-S decode merge
(PyTorch port of fastllama_tpu/parallel/ring.py; plain PyTorch, as the JAX
functions are plain jnp).

Layout contract: the KV cache's SEQUENCE axis is sharded over the sp group
(cache row == global token position; rank i owns positions
[i*S_loc, (i+1)*S_loc)). During prefill the activations are sharded along
T over the same group; only attention crosses ranks:

  * ring_prefill: K/V chunks travel around the ring (collectives.ppermute)
    while each rank folds the passing chunk into an online softmax (running
    max, sum of exponentials, weighted accumulator), and collects the rows
    it owns into its local cache slab as they pass.
  * sp_decode_attention: each rank attends over its local rows; the
    partials merge with one pmax and two psums (split-S across ranks).
"""
from __future__ import annotations

import torch

from .collectives import all_gather, axis_index, pmax, ppermute, psum

_NEG = -1e30


def _scores(q, keys, scale):
    """[B, T, H, Dh] x [B, S, H, Dh] -> f32 [B, H, T, S]."""
    return torch.einsum("bthd,bshd->bhts", q, keys) * scale


def _drop_write(cache: torch.Tensor, rows: torch.Tensor, loc: torch.Tensor):
    """cache[b, loc[b, t]] = rows[b, t] where 0 <= loc < S_loc, in place."""
    b, s_loc, f = cache.shape
    ok = (loc >= 0) & (loc < s_loc)
    bi = torch.arange(b, device=cache.device)[:, None].expand_as(loc)
    cache[bi[ok], loc[ok].long()] = rows.reshape(b, -1, f)[ok].to(cache.dtype)


def ring_prefill(q, k, v, kv_k, kv_v, positions, group, sp: int,
                 scale: float, win_start=None):
    """Causal ring attention over a T-sharded prompt window.

    q/k/v: [B, T_loc, H, Dh] post-RoPE, this rank's token chunk;
    kv_k/kv_v: [B, S_loc, H*Dh] local cache slabs (written in place);
    positions: int [B, T_loc] GLOBAL positions of the local chunk.
    win_start: [B] global position of the window's first token (n_past);
      None = a fresh window. Otherwise the online state is seeded with
      attention over the cache prefix (rows < win_start): the query block
      is all-gathered, scored against each rank's resident rows, and the
      partials merged with the split-S pmax / psum (chunked ingest).
    Returns ctx [B, T_loc, H, Dh] f32."""
    b, t, h, hd = q.shape
    s_loc = kv_k.shape[1]
    base = axis_index(group) * s_loc
    qf = q.to(torch.float32)
    acc = torch.zeros((b, h, t, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t, 1), dtype=torch.float32, device=q.device)
    k_rows = base + torch.arange(s_loc, device=q.device)

    if win_start is not None:
        q_all = all_gather(qf, group, dim=1)             # [B, T, H, Dh]
        keys = kv_k.reshape(b, s_loc, h, hd).to(torch.float32)
        vals = kv_v.reshape(b, s_loc, h, hd).to(torch.float32)
        pmask = k_rows[None, None, None, :] < win_start[:, None, None, None]
        scores = torch.where(pmask, _scores(q_all, keys, scale), _NEG)
        m_loc = scores.amax(dim=-1, keepdim=True)
        p = torch.where(pmask, torch.exp(scores - m_loc), 0.0)
        l_loc = p.sum(dim=-1, keepdim=True)
        a_loc = torch.einsum("bhts,bshd->bhtd", p, vals)
        m_g = pmax(m_loc, group)
        coef = torch.exp(m_loc - m_g)
        l_g = psum(l_loc * coef, group)
        acc_g = psum(a_loc * coef, group)
        own = slice(axis_index(group) * t, axis_index(group) * t + t)
        m, l, acc = m_g[:, :, own], l_g[:, :, own], acc_g[:, :, own]

    k_c, v_c, pos_c = k, v, positions
    for step in range(sp):
        scores = _scores(qf, k_c.to(torch.float32), scale)
        mask = pos_c[:, None, None, :] <= positions[:, None, :, None]
        scores = torch.where(mask, scores, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        # explicit zero where masked: a fully masked chunk at m_new == _NEG
        # would otherwise add exp(0) == 1 per masked key
        p = torch.where(mask, torch.exp(scores - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhts,bshd->bhtd", p,
                                         v_c.to(torch.float32))
        m = m_new
        # the passing chunk's rows that this rank's cache region holds
        loc = pos_c - base
        _drop_write(kv_k, k_c, loc)
        _drop_write(kv_v, v_c, loc)
        if step < sp - 1:
            k_c = ppermute(k_c, group)
            v_c = ppermute(v_c, group)
            pos_c = ppermute(pos_c, group)
    return (acc / l).transpose(1, 2)                      # [B, T_loc, H, Dh]


def sp_write_decode(kv_k, kv_v, k, v, pos, group) -> None:
    """Owner-masked write of the new token's K/V row, in place: k/v
    [B, 1, H, Dh]; pos [B] global position. Only the rank whose cache
    region holds `pos` keeps the row, so the write needs no collective."""
    loc = (pos - axis_index(group) * kv_k.shape[1]).reshape(-1, 1)
    _drop_write(kv_k, k, loc)
    _drop_write(kv_v, v, loc)


def sp_decode_attention(q, kv_k, kv_v, pos, group, n_head: int,
                        scale: float):
    """Decode attention over a sequence-sharded cache (split-S merge).

    q: [B, 1, H, Dh]; kv_k/kv_v: [B, S_loc, H*Dh] local slabs; pos: [B]
    global position of the newest token (already written: keys at
    positions <= pos attend). Returns ctx [B, 1, H, Dh] f32."""
    b, s_loc = kv_k.shape[0], kv_k.shape[1]
    hd = q.shape[-1]
    base = axis_index(group) * s_loc
    keys = kv_k.reshape(b, s_loc, n_head, hd).to(torch.float32)
    vals = kv_v.reshape(b, s_loc, n_head, hd).to(torch.float32)
    k_rows = base + torch.arange(s_loc, device=q.device)
    mask = k_rows[None, None, None, :] <= pos[:, None, None, None]
    scores = torch.where(mask, _scores(q.to(torch.float32), keys, scale),
                         _NEG)
    m_loc = scores.amax(dim=-1, keepdim=True)             # [B, H, 1, 1]
    p = torch.where(mask, torch.exp(scores - m_loc), 0.0)
    l_loc = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhts,bshd->bhtd", p, vals)
    m_g = pmax(m_loc, group)
    coef = torch.exp(m_loc - m_g)          # 0 for ranks with no valid rows
    l_g = psum(l_loc * coef, group)
    acc_g = psum(acc * coef, group)
    return (acc_g / l_g).transpose(1, 2)                  # [B, 1, H, Dh]
