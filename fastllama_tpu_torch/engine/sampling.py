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
RNG state. The batched on-device sampler of the engine is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
