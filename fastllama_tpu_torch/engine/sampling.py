"""Token sampling with the reference's exact semantics (host side).

Re-implements sample_top_p_top_k (lib/bridge.cpp:24-108):

  1. greedy argmax when temp <= 0                        (bridge.cpp:39-42)
  2. scale logits by 1/temp; tokens present in the last-n window get the
     CTRL repetition penalty — multiply by `penalty` if the *raw* logit is
     negative, else divide                               (bridge.cpp:53-65)
  3. keep the top-k scaled logits                        (bridge.cpp:13-21)
  4. softmax over the kept set; truncate at the first cumulative
     probability >= top_p (inclusive)                    (bridge.cpp:72-102)
  5. draw from the renormalized distribution             (bridge.cpp:104-107)

`sample_host` is numpy and is the same function as the JAX package's, so a
session on either package draws the same token from the same logits and
RNG state. `sample_device` is the batched sampler of the continuous-batching
engine (the JAX package's `sample_jax`): the same selection on the tensors'
device, with the random numbers handed in by the caller.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Defaults follow interfaces/python/fastllama.py:344-349."""
    top_k: int = 40
    top_p: float = 0.95
    temp: float = 0.8
    repeat_penalty: float = 1.0


def apply_repetition_penalty(logits: np.ndarray, last_tokens,
                             temp: float, penalty: float) -> np.ndarray:
    """Return scaled logits with the CTRL penalty applied (f64, like the ref)."""
    scaled = logits.astype(np.float64) / float(temp)
    if penalty != 1.0 and len(last_tokens) > 0:
        idx = np.unique(np.asarray(list(last_tokens), dtype=np.int64))
        idx = idx[(idx >= 0) & (idx < logits.shape[-1])]
        neg = logits[idx] < 0.0
        scaled[idx] = np.where(neg, scaled[idx] * penalty, scaled[idx] / penalty)
    return scaled


def sample_host(logits: np.ndarray, last_tokens, params: SamplingParams,
                rng: np.random.Generator) -> int:
    """Sample one token id from [n_vocab] logits."""
    logits = np.asarray(logits, dtype=np.float32)
    n_vocab = logits.shape[-1]
    if params.temp <= 0.0:
        return int(np.argmax(logits))

    scaled = apply_repetition_penalty(logits, last_tokens, params.temp,
                                      params.repeat_penalty)

    k = params.top_k if params.top_k > 0 else n_vocab
    k = min(k, n_vocab)
    part = np.argpartition(-scaled, k - 1)[:k]
    order = part[np.argsort(-scaled[part], kind="stable")]
    top = scaled[order]

    probs = np.exp(top - top[0])
    probs /= probs.sum()

    if params.top_p < 1.0:
        cum = np.cumsum(probs)
        cut = int(np.searchsorted(cum, params.top_p) + 1)
        probs = probs[:cut]
        order = order[:cut]
        probs = probs / probs.sum()

    choice = rng.choice(len(probs), p=probs)
    return int(order[choice])


def draw_uniforms(gen: torch.Generator, b: int, k: int,
                  device) -> torch.Tensor:
    """[b, k] f32 uniforms in [1e-20, 1) from `gen` (a generator on
    `device`): the noise sample_device turns into its Gumbel draw."""
    return torch.rand((b, k), generator=gen, device=device,
                      dtype=torch.float32).clamp_min_(1e-20)


def _row_vector(x, b: int, dtype, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=dtype, device=device)
    return x.to(dtype).expand(b)


def sample_device(logits: torch.Tensor, last_tokens: torch.Tensor,
                  uniforms: torch.Tensor, top_k: int, top_p, temp,
                  repeat_penalty,
                  top_k_v: torch.Tensor | None = None) -> torch.Tensor:
    """Batched on-device sampler, the port of the JAX package's sample_jax:
    logits [B, V], last_tokens [B, W] int (pad with -1), uniforms [B, k] f32
    in (0, 1) with k = min(top_k or V, V). Returns [B] int32.

    sample_jax draws its uniforms from a threefry key, which PyTorch cannot
    reproduce, so the draw is the caller's (draw_uniforms from an explicit
    torch.Generator) and this function is the selection alone: the same
    uniforms give the same tokens as sample_jax. Every knob except the top-k
    cap is per row:

      top_k:          static cap (the width of the kept set)
      top_k_v:        optional [B] int per-row k in [1, top_k]
      top_p:          python float or [B] f32 (a float >= 1 skips the cut)
      temp:           python float or [B] f32; rows with temp <= 0 decode
                      greedily from the raw logits
      repeat_penalty: python float or [B] f32 (CTRL penalty over last_tokens,
                      the sign test on the raw logit)

    The kept set comes from a stable descending sort, so equal scaled logits
    keep the lower token id first, as jax.lax.top_k orders them (torch.topk
    promises no order among ties). Nothing here reads a value on the host.
    """
    b, v = logits.shape
    dev = logits.device
    logits = logits.to(torch.float32)
    temp_v = _row_vector(temp, b, torch.float32, dev)
    greedy = torch.argmax(logits, dim=-1)

    scaled = logits / temp_v.clamp_min(1e-6)[:, None]
    if not (isinstance(repeat_penalty, (int, float))
            and repeat_penalty == 1.0):
        rp_v = _row_vector(repeat_penalty, b, torch.float32, dev)[:, None]
        # window membership as a scatter into a [B, V + 1] mask: pads (-1)
        # go to the spare column, ids past the vocabulary clip to V - 1
        lt = last_tokens.to(torch.int64)
        idx = torch.where(lt >= 0, lt.clamp_max(v - 1), v)
        in_window = torch.zeros((b, v + 1), dtype=torch.bool, device=dev)
        in_window.scatter_(1, idx, True)
        pen = torch.where(logits < 0, scaled * rp_v, scaled / rp_v)
        scaled = torch.where(in_window[:, :v], pen, scaled)

    k = min(top_k if top_k > 0 else v, v)
    order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    top_vals, top_idx = order.values[:, :k], order.indices[:, :k]
    if top_k_v is not None:
        # per-row k: ranks past the row's k drop out before the softmax
        keep_k = (torch.arange(k, device=dev)[None, :]
                  < top_k_v.clamp(1, k)[:, None])
        top_vals = torch.where(keep_k, top_vals, -torch.inf)
    e = torch.exp(top_vals - top_vals[:, :1])
    probs = e / e.sum(-1, keepdim=True)

    if not (isinstance(top_p, (int, float)) and top_p >= 1.0):
        tp_v = _row_vector(top_p, b, torch.float32, dev)[:, None]
        cum = torch.cumsum(probs, dim=-1)
        # keep entries whose *preceding* cumsum < top_p (inclusive cut)
        keep = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                          cum[:, :-1] < tp_v], dim=-1)
        probs = torch.where(keep, probs, 0.0)
        probs = probs / probs.sum(-1, keepdim=True)

    gumbel = -torch.log(-torch.log(uniforms))
    choice = torch.argmax(torch.where(probs > 0, torch.log(probs) + gumbel,
                                      -torch.inf), dim=-1)
    sampled = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    return torch.where(temp_v <= 0.0, greedy, sampled).to(torch.int32)
