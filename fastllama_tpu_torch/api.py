"""Top-level user API — the same `Model` surface as fastllama_tpu.api (and
the reference binding, interfaces/python/fastllama.py:194-479), on PyTorch:

    from fastllama_tpu_torch import Model
    model = Model(path="./ggml-model-q4_0.bin", n_ctx=512)  # on the card
    model.attach_lora("./adapter.bin")                      # ggla adapter
    model.ingest("system prompt", is_system_prompt=True)
    model.generate(num_tokens=100, streaming_fn=fn, stop_words=["User:"])

`device=` picks the device; the default is the CUDA card, and a missing
card raises unless the caller passes device="cpu".

`mesh_shape=(1, tp)` serves the model over tp ranks of an initialized
torch.distributed world (one process a rank, every rank running this same
program, e.g. under `torchrun --nproc-per-node tp`); `seq_parallel=True`
with `mesh_shape=(sp, tp)` shards the sequence over sp. Without an
initialized process group of that size it raises.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .config import RuntimeConfig
from .engine.logger import DefaultLogger, Logger
from .engine.session import FastLlama
from .models.loader import load_model


class Model:
    """Stateful model + session with the reference binding's kwargs
    (fastllama.py:198-234). Thread knobs are accepted and ignored."""

    def __init__(self, path: str, *,
                 num_threads: int = 0,
                 n_ctx: int = 512,
                 last_n_size: int = 64,
                 seed: int = 0,
                 tokens_to_keep: int = 200,
                 n_batch: int = 64,
                 should_get_all_logits: bool = False,
                 embedding_eval_enabled: bool = False,
                 use_mmap: bool = False,
                 use_mlock: bool = False,
                 n_load_parallel_blocks: int = 1,
                 load_parallel: bool = True,
                 allocate_extra_mem: int = 0,
                 logger: Optional[Logger] = None,
                 kv_dtype: str = "bfloat16",
                 weight_dtype: str = "bfloat16",
                 use_pallas: Optional[bool] = None,
                 mesh_shape: tuple = (),
                 seq_parallel: bool = False,
                 device=None):
        self.logger = logger or DefaultLogger()
        if use_mmap or use_mlock:
            self.logger.log_warn(
                "Model", "use_mmap/use_mlock have no device analog: weights "
                "are device-resident tensors; flags ignored\n")
        if allocate_extra_mem:
            self.logger.log_warn(
                "Model", "allocate_extra_mem is ignored: PyTorch owns device "
                "allocation\n")
        if mesh_shape and int(np.prod(mesh_shape)) > 1:
            from .parallel.sharding import require_world
            require_world(mesh_shape)
        del num_threads, n_load_parallel_blocks, load_parallel
        rcfg = RuntimeConfig(
            n_ctx=n_ctx, n_batch=n_batch, n_keep=tokens_to_keep,
            last_n_size=last_n_size, seed=seed,
            should_get_all_logits=should_get_all_logits,
            embedding_eval_enabled=embedding_eval_enabled,
            kv_dtype=kv_dtype, weight_dtype=weight_dtype,
            use_pallas=use_pallas, mesh_shape=tuple(mesh_shape),
            seq_parallel=seq_parallel)
        self._model = load_model(path, rcfg, self.logger, device=device)
        self._session = FastLlama(self._model, n_keep=tokens_to_keep,
                                  last_n_size=last_n_size, seed=seed)
        self._stop_words: list[str] = []

    # -- reference-binding surface ------------------------------------------

    def set_stop_words(self, *words: str) -> bool:
        self._stop_words = list(words)
        return True

    def ingest(self, prompt: str, is_system_prompt: bool = False) -> bool:
        return self._session.ingest(prompt, is_system_prompt)

    def generate(self,
                 num_tokens: int = 100,
                 top_p: float = 0.95,
                 top_k: int = 40,
                 temp: float = 0.8,
                 repeat_penalty: float = 1.0,
                 streaming_fn: Callable[[str], None] = lambda s: None,
                 stop_words: Sequence[str] = (),
                 interrupt_fn: "Callable[[], bool] | None" = None) -> bool:
        if stop_words:
            self.set_stop_words(*stop_words)
        return self._session.generate(
            streaming_fn, num_tokens=num_tokens, top_k=top_k, top_p=top_p,
            temp=temp, repeat_penalty=repeat_penalty,
            stop_words=self._stop_words, interrupt_fn=interrupt_fn)

    def perplexity(self, prompt: str) -> Optional[float]:
        return self._session.perplexity(prompt)

    def get_embeddings(self) -> np.ndarray:
        return self._session.get_embeddings()

    def get_logits(self) -> np.ndarray:
        return self._session.get_logits()

    def save_state(self, file_path: str) -> bool:
        return self._session.save_state(file_path)

    def load_state(self, file_path: str) -> bool:
        return self._session.load_state(file_path)

    def attach_lora(self, lora_path: str) -> bool:
        return self._session.attach_lora(lora_path)

    def detach_lora(self) -> bool:
        return self._session.detach_lora()

    def reset(self) -> bool:
        return self._session.reset()

    def dump_vocab(self, file_path: str) -> bool:
        return self._session.dump_vocab(file_path)

    @property
    def n_vocab(self) -> int:
        """Logical vocabulary size (the width of one logits row)."""
        return int(self._model.hp.n_vocab)

    @property
    def session(self) -> FastLlama:
        return self._session
