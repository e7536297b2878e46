"""LlamaModel — the stateful single-stream runtime around the forward pass.

PyTorch port of fastllama_tpu/models/runtime.py: owns the parameters and the
per-layer KV caches on one device, pads each eval window up to a bucket
length (as the JAX runtime does for its compiled shapes, so both packages
run the same windows), and saves/loads the resident KV prefix in the same
npz layout, so a session saved by the JAX package loads here.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import HyperParams, RuntimeConfig, resolve_device
from ..engine.logger import Logger, NULL_LOGGER
from ..engine.tokenizer import Vocab
from .llama import (
    ForwardConfig, LlamaParams, forward, init_kv_cache, position_tables,
)


class LlamaModel:
    """Single-stream (batch=1) model runtime on `device` (the CUDA card
    unless the caller passes device="cpu")."""

    def __init__(self, hp: HyperParams, params: LlamaParams, vocab: Vocab,
                 rcfg: RuntimeConfig = RuntimeConfig(),
                 logger: Logger = NULL_LOGGER, device=None):
        self.device = resolve_device(device)
        self.hp = hp.with_ctx(rcfg.n_ctx)
        self.params = params
        self.vocab = vocab
        self.rcfg = rcfg
        self.logger = logger
        self.is_valid = True
        self.kv = init_kv_cache(self.hp, 1, rcfg.n_ctx,
                                getattr(torch, rcfg.kv_dtype), self.device)
        self.n_cached = 0    # tokens resident in the cache (state save/load)
        self._tables = position_tables(rcfg.n_ctx, hp.head_dim, hp.n_rot,
                                       self.device)
        self._embeddings = torch.zeros((1, hp.n_embd), dtype=torch.float32)
        base = dict(n_head=hp.n_head, n_rot=hp.n_rot,
                    w_dtype=rcfg.weight_dtype, prefill_int8=rcfg.prefill_int8)
        self._cfg = {al: ForwardConfig(all_logits=al, **base)
                     for al in (False, True)}
        self._buckets = sorted({min(b, rcfg.n_ctx)
                                for b in rcfg.prefill_buckets} | {1, rcfg.n_ctx})

    # -- eval ---------------------------------------------------------------

    def _bucket(self, t: int, n_past: int) -> int:
        """Smallest bucket >= t whose window still fits the cache; falls back
        to the exact remaining room at the context boundary."""
        room = self.hp.n_ctx - n_past
        for b in self._buckets:
            if t <= b <= room:
                return b
        return max(t, 1)

    def eval(self, n_past: int, tokens: Sequence[int],
             all_logits: bool = False) -> np.ndarray:
        """Run the forward pass over `tokens` starting at n_past. Returns f32
        numpy logits: [len(tokens), n_vocab] when all_logits else [n_vocab]."""
        t = len(tokens)
        if t == 0:
            raise ValueError("eval of empty token list")
        if n_past + t > self.hp.n_ctx:
            raise ValueError(
                f"eval window [{n_past}, {n_past + t}) exceeds n_ctx={self.hp.n_ctx}")
        buf = np.zeros((1, self._bucket(t, n_past)), np.int64)
        buf[0, :t] = np.asarray(tokens, np.int64)
        with torch.inference_mode():
            logits, self.kv, self._embeddings = forward(
                self.params, torch.from_numpy(buf).to(self.device), n_past,
                self.kv, self._cfg[all_logits], t - 1, self._tables)
            out = logits[0].cpu().numpy()
        self.n_cached = max(self.n_cached, n_past + t)
        return out[:t] if all_logits else out[-1]

    def get_embeddings(self) -> np.ndarray:
        """Final-norm hidden state of the last evaluated token."""
        return self._embeddings[0].cpu().numpy()

    # -- state --------------------------------------------------------------

    def reset(self) -> bool:
        self.n_cached = 0
        self._embeddings = torch.zeros((1, self.hp.n_embd), dtype=torch.float32)
        return True

    def kv_state(self) -> dict[str, np.ndarray]:
        """The resident KV prefix as f32 [L, B, n, H*Dh] arrays."""
        n = self.n_cached
        kk = torch.stack([k[:, :n] for k, _ in self.kv]).float().cpu().numpy()
        vv = torch.stack([v[:, :n] for _, v in self.kv]).float().cpu().numpy()
        return {"kv_k": kk, "kv_v": vv}

    def load_kv_state(self, state: dict[str, np.ndarray]) -> None:
        k = np.asarray(state["kv_k"])          # [L, B, n, H*Dh]
        n = k.shape[2]
        if n > self.hp.n_ctx:
            raise ValueError(f"saved KV length {n} exceeds n_ctx={self.hp.n_ctx}")
        v = np.asarray(state["kv_v"])
        for li, (kc, vc) in enumerate(self.kv):
            kc.zero_()
            vc.zero_()
            kc[:, :n] = torch.from_numpy(k[li]).to(kc.dtype)
            vc[:, :n] = torch.from_numpy(v[li]).to(vc.dtype)
        self.n_cached = n

    def set_threads(self, n: int) -> None:
        """No-op parity shim (reference Model::set_threads)."""
        del n

    # -- LoRA ---------------------------------------------------------------

    def attach_lora(self, path: str) -> bool:
        raise NotImplementedError(
            "LoRA attach needs the ggml (ggla) reader, which the PyTorch port "
            "does not have yet (ROADMAP.md, queue A: the ggml/GGJT reader)")

    def detach_lora(self) -> bool:
        raise NotImplementedError(
            "LoRA detach needs the ggml (ggla) reader, which the PyTorch port "
            "does not have yet (ROADMAP.md, queue A: the ggml/GGJT reader)")

    @property
    def lora_path(self) -> str | None:
        return None
