"""FastLlama — the stateful chat session over one model (PyTorch port).

The same session as fastllama_tpu/engine/session.py over the port's
LlamaModel; the state file format is shared, so a state saved by either
package loads in the other. It re-implements the reference session layer (lib/bridge.cpp / include/
bridge.hpp) with identical semantics:

  * ingest with resident system-prompt pinning       (bridge.cpp:186-238)
  * context recycling: keep the first n_keep tokens, re-feed system prompt
    plus a slice of the recent window                 (bridge.cpp:161-180)
  * streaming generate with stop words scanned across token boundaries and
    resumable partial state                           (bridge.cpp:240-312)
  * top-k/top-p/temperature/CTRL-penalty sampling     (bridge.cpp:24-108)
  * perplexity over n_batch windows, NLL on the second half of each window
                                                      (bridge.cpp:331-422)
  * full session-state save/load (n_past, RNG, pending tokens, last-n
    window, logits, system prompt, KV cache)          (bridge.cpp:424-525)

The lazy-eval contract is preserved exactly: `m_embd` holds tokens that have
been *scheduled* but not yet evaluated; both ingest and generate flush it
through Model.eval before using the logits.
"""
from __future__ import annotations

import json
import signal
import threading
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from ..models.runtime import LlamaModel
from ..utils.trace import trace_region
from .logger import Logger, ProgressTag
from .sampling import SamplingParams, sample_host
from .token_buffer import TokenBuffer, TokenBufferPartialState
from .tokenizer import BOS_ID, EOS_ID, tokenize

STATE_MAGIC = "fastllama_tpu.session.v1"   # shared with the JAX package


class FastLlama:
    EOS = EOS_ID
    BOS = BOS_ID

    def __init__(self, model: LlamaModel, *,
                 n_keep: int = 64,
                 last_n_size: int = 64,
                 seed: int = 0):
        self.model = model
        self.n_keep = n_keep
        self.last_n_size = last_n_size
        self.seed = seed

        self.n_past = 0
        self._embd: list[int] = []               # scheduled, not yet evaluated
        self._last_n: deque[int] = deque(maxlen=last_n_size)
        self._logits: np.ndarray | None = None
        self._system_prompt: list[int] = []
        self._rng = np.random.default_rng(seed)
        self._token_buffer_state = TokenBufferPartialState()

    # -- convenience --------------------------------------------------------

    @property
    def logger(self) -> Logger:
        return self.model.logger

    def get_logits(self) -> np.ndarray:
        """Logits from the most recent eval (last row unless all-logits mode
        was used; reference: bridge.cpp:152-155)."""
        if self._logits is None:
            return np.zeros(0, np.float32)
        return self._logits

    def get_embeddings(self) -> np.ndarray:
        return self.model.get_embeddings()

    # -- context recycling ---------------------------------------------------

    def _recycle_if_exceeds_context(self) -> bool:
        """Mirror of recycle_embed_if_exceeds_context (bridge.cpp:161-180)."""
        length = len(self._embd)
        if length == 0:
            return False
        if length + self.n_past <= self.model.hp.n_ctx:
            return False

        last_tokens_len = len(self._last_n)
        remaining = self.n_past - min(self.n_keep, self.n_past)
        begin_pos = last_tokens_len - min(remaining >> 1, last_tokens_len)
        self.n_past = min(self.n_keep, self.n_past)

        if begin_pos < len(self._system_prompt):
            self._embd = self._system_prompt + self._embd
        else:
            recent = list(self._last_n)[last_tokens_len - begin_pos:]
            self._embd = self._system_prompt + recent + self._embd

        # Safety clamp absent from the reference: its arithmetic can re-feed
        # more than fits (e.g. last_n_size ~ n_ctx, or n_keep close to n_ctx
        # with a large system prompt) — the C++ version would then write the
        # KV cache out of bounds (lib/llama.cpp:336-343). Drop the oldest
        # re-fed tokens so the window always fits.
        overflow = self.n_past + len(self._embd) - self.model.hp.n_ctx
        if overflow > 0:
            del self._embd[:overflow]
        return True

    def _flush_embd(self, all_logits: bool | None = None) -> bool:
        """Evaluate any scheduled tokens (the reference's inline
        `if (!m_embd.empty()) eval(...)` + n_past advance).

        all_logits defaults to the model's should_get_all_logits flag
        (reference: Model.should_put_all_logits, honored per eval)."""
        if all_logits is None:
            all_logits = self.model.rcfg.should_get_all_logits
        if self._embd:
            self._logits = self.model.eval(self.n_past, self._embd,
                                           all_logits=all_logits)
            self.n_past += len(self._embd)
            self._embd.clear()
        return True

    # -- ingest --------------------------------------------------------------

    def ingest(self, prompt: str, is_system_prompt: bool = False) -> bool:
        """Tokenize and schedule a prompt (reference: bridge.cpp:186-238).

        A leading space is inserted and BOS prepended, exactly as the
        reference does (bridge.cpp:193-195)."""
        self.logger.reset()
        if not self.model.is_valid:
            self.logger.log_err("ingest", "tried to ingest using invalid model\n")
            return False

        tokens = tokenize(self.model.vocab, " " + prompt, bos=True)
        max_input = self.model.hp.n_ctx - 4
        if len(tokens) > max_input:
            self.logger.log_err(
                "ingest", f"prompt size(='{len(tokens)}') exceeds maximum "
                f"allowed size('{max_input}')\n")
            return False

        if is_system_prompt:
            if self.n_keep < len(tokens):
                self.logger.log_err(
                    "ingest", f"system prompt size(='{len(tokens)}') exceeds "
                    f"'n_keep'(='{self.n_keep}')\n")
                return False
            self._system_prompt = list(tokens)

        n_batch = self.model.rcfg.n_batch
        total = len(tokens)
        for i in range(0, total, n_batch):
            self.logger.progress(ProgressTag.INGEST, i, total)
            block = tokens[i:i + n_batch]
            self._recycle_if_exceeds_context()
            self._flush_embd()
            self._embd.extend(block)
            self._last_n.extend(block)
        self.logger.progress(ProgressTag.INGEST, total, total)

        # Reference clears the penalty window after ingest (bridge.cpp:235).
        self._last_n.clear()
        return True

    # -- generate ------------------------------------------------------------

    def generate(self,
                 streaming_fn: Callable[[str], None],
                 num_tokens: int = 100,
                 top_k: int = 40,
                 top_p: float = 0.95,
                 temp: float = 0.8,
                 repeat_penalty: float = 1.0,
                 stop_words: Sequence[str] = (),
                 interrupt_fn: "Callable[[], bool] | None" = None) -> bool:
        """Generate up to num_tokens, streaming text (bridge.cpp:240-312).

        Ctrl-C mid-generation stops cleanly at the next token boundary and
        leaves the session fully resumable — the reference routes SIGINT
        into the library the same way (interfaces/python/fastllama.py:238-242,
        interfaces/c/main.cpp:229-232). The previous handler is restored on
        exit; `self.interrupted` reports whether the last generate() was cut
        short. `interrupt_fn` is an extra per-token stop poll for callers
        that cannot use Python signal handlers (the C ABI's
        llama_handle_signal routes through it)."""
        self.logger.reset()
        if not self.model.is_valid:
            self.logger.log_err("generate", "tried to generate using invalid model\n")
            return False
        with trace_region(self.model.rcfg.profile_dir, "generate"):
            return self._generate_traced(streaming_fn, num_tokens, top_k,
                                         top_p, temp, repeat_penalty,
                                         stop_words, interrupt_fn)

    def _generate_traced(self, streaming_fn, num_tokens, top_k, top_p, temp,
                         repeat_penalty, stop_words,
                         interrupt_fn=None) -> bool:
        vocab = self.model.vocab
        stop_bytes = [w.encode("utf-8") for w in stop_words]
        max_buf = max((len(tokenize(vocab, w, bos=False)) for w in stop_words),
                      default=0)
        token_buffer = TokenBuffer(vocab, max_buf, streaming_fn)
        token_buffer.restore_partial_state(self._token_buffer_state)

        params = SamplingParams(top_k=top_k, top_p=top_p, temp=temp,
                                repeat_penalty=repeat_penalty)

        self.interrupted = False
        prev_handler = None

        def _on_sigint(signum, frame):
            del signum, frame
            self.interrupted = True

        # signal handlers can only be installed from the main thread; in a
        # worker thread (e.g. the websocket server) generation is stopped by
        # the caller instead.
        in_main = threading.current_thread() is threading.main_thread()
        if in_main:
            prev_handler = signal.signal(signal.SIGINT, _on_sigint)
        try:
            for _ in range(num_tokens):
                found, before, after = token_buffer.scan_stop_words(stop_bytes)
                if found:
                    if before:
                        streaming_fn(before.decode("utf-8", errors="replace"))
                    self._token_buffer_state = token_buffer.get_partial_state()
                    self._token_buffer_state.left_out = after
                    return True
                if interrupt_fn is not None and interrupt_fn():
                    self.interrupted = True
                if self.interrupted:
                    break

                self._recycle_if_exceeds_context()
                if not self._flush_embd():
                    return False

                token_id = sample_host(self._last_logits_row(), self._last_n,
                                       params, self._rng)
                if token_id == self.EOS:
                    break
                self._last_n.append(token_id)
                token_buffer.add(token_id)
                self._embd.append(token_id)

            token_buffer.flush_all()
            self._token_buffer_state = token_buffer.get_partial_state()
            return True
        finally:
            if in_main and prev_handler is not None:
                signal.signal(signal.SIGINT, prev_handler)

    def _last_logits_row(self) -> np.ndarray:
        if self._logits is None:
            raise RuntimeError("generate called before any ingest/eval")
        row = self._logits
        return row[-1] if row.ndim == 2 else row

    # -- perplexity ----------------------------------------------------------

    def perplexity(self, text: str) -> Optional[float]:
        """Sliding-window perplexity (reference: bridge.cpp:331-422).

        Chunks of n_batch evaluated at n_past=0; NLL accumulated over the
        second half of each chunk predicting the next token."""
        tokens = tokenize(self.model.vocab, text, bos=True)
        block_size = self.model.rcfg.n_batch
        token_len = len(tokens)
        blocks = (token_len + block_size - 1) // block_size
        self.logger.log("perplexity",
                        f"calculating perplexity over {blocks} chunk(s)\n")

        nll = 0.0
        count = 0
        res = None
        import time as _time
        for bi, i in enumerate(range(0, token_len, block_size)):
            block = min(block_size, token_len - i)
            if block < 2:
                break
            t0 = _time.time()
            logits = self.model.eval(0, tokens[i:i + block], all_logits=True)
            if bi == 0:
                # first-pass ETA, like the reference (bridge.cpp:366-380)
                secs = _time.time() - t0
                self.logger.log(
                    "perplexity",
                    f"{secs:.2f} seconds per pass - ETA "
                    f"{secs * blocks / 3600.0:.2f} hours\n")
            # eval refreshes the logits view (reference: every llama_eval
            # fills the buffer bridge.cpp:152-155 exposes) — all positions
            # when the session was built for all-logits, else the last row
            self._logits = (logits if self.model.rcfg.should_get_all_logits
                            else logits[-1])
            for j in range(block // 2, block - 1):
                row = logits[j].astype(np.float64)
                row -= row.max()
                p = np.exp(row)
                p /= p.sum()
                nll += -np.log(p[tokens[i + j + 1]])
                count += 1
            res = float(np.exp(nll / max(count, 1)))
            self.logger.log("perplexity", f"[{bi + 1}/{blocks}]: {res:.4f}\n")
        return res

    # -- state save/load -----------------------------------------------------

    def save_state(self, filepath: str) -> bool:
        """Serialize the full session (reference: bridge.cpp:424-473 +
        Model::save_state). Weights are deliberately excluded so states are
        small and context switching is fast (lib/llama.cpp:80-85)."""
        try:
            header = {
                "magic": STATE_MAGIC,
                "n_past": self.n_past,
                "n_keep": self.n_keep,
                "last_n_size": self.last_n_size,
                "rng": self._rng.bit_generator.state,
                "token_buffer": {
                    "left_out": self._token_buffer_state.left_out.decode("latin-1"),
                    "unicode_backlog":
                        self._token_buffer_state.unicode_backlog.decode("latin-1"),
                },
            }
            arrays = {
                "header": np.frombuffer(
                    json.dumps(header).encode("utf-8"), np.uint8),
                "embd": np.asarray(self._embd, np.int32),
                "last_n": np.asarray(list(self._last_n), np.int32),
                "logits": (self._logits if self._logits is not None
                           else np.zeros(0, np.float32)),
                "system_prompt": np.asarray(self._system_prompt, np.int32),
            }
            # under a mesh every rank gathers the state; rank 0 writes it
            arrays.update(self.model.kv_state())
            ok = True
            if self.model.is_writer:
                with open(filepath, "wb") as f:
                    np.savez(f, **arrays)
        except OSError as e:
            self.logger.log_err("save_state", f"unable to save state: {e}\n")
            ok = False
        self.model.barrier()
        if ok:
            self.logger.log("save_state", f"saved session to {filepath}\n")
        return ok

    def load_state(self, filepath: str) -> bool:
        try:
            with np.load(filepath, allow_pickle=False) as z:
                header = json.loads(bytes(z["header"]).decode("utf-8"))
                if header.get("magic") != STATE_MAGIC:
                    self.logger.log_err("load_state", "bad state file magic\n")
                    return False
                self.n_past = int(header["n_past"])
                self.n_keep = int(header["n_keep"])
                self.last_n_size = int(header.get("last_n_size",
                                                  self.last_n_size))
                rng_state = header["rng"]
                self._rng = np.random.default_rng()
                self._rng.bit_generator.state = rng_state
                tb = header.get("token_buffer", {})
                self._token_buffer_state = TokenBufferPartialState(
                    left_out=tb.get("left_out", "").encode("latin-1"),
                    unicode_backlog=tb.get("unicode_backlog", "").encode("latin-1"),
                )
                self._embd = [int(x) for x in z["embd"]]
                self._last_n = deque(
                    (int(x) for x in z["last_n"]), maxlen=self.last_n_size)
                logits = z["logits"]
                self._logits = logits if logits.size else None
                self._system_prompt = [int(x) for x in z["system_prompt"]]
                self.model.load_kv_state(
                    {"kv_k": z["kv_k"], "kv_v": z["kv_v"]})
            self.logger.log("load_state", f"loaded session from {filepath}\n")
            return True
        except (OSError, KeyError, ValueError) as e:
            self.logger.log_err("load_state", f"unable to load state: {e}\n")
            return False

    # -- reset ---------------------------------------------------------------

    def reset(self) -> bool:
        """Reference: bridge.cpp:527-538."""
        self.logger.log("reset", "resetting the model...\n")
        self.n_past = 0
        self._embd.clear()
        self._last_n.clear()
        self._logits = None
        self._system_prompt = []
        self._rng = np.random.default_rng(self.seed)
        self._token_buffer_state = TokenBufferPartialState()
        res = self.model.reset()
        self.logger.log("reset", "reset completed.\n")
        return res

    # -- LoRA ----------------------------------------------------------------

    def attach_lora(self, filepath: str) -> bool:
        """Runtime adapter attach (reference: bridge passthrough to
        Model::attach_lora)."""
        self.logger.reset()
        return self.model.attach_lora(filepath)

    def detach_lora(self) -> bool:
        self.logger.reset()
        return self.model.detach_lora()

    # -- misc parity ---------------------------------------------------------

    def dump_vocab(self, filepath: str) -> bool:
        try:
            with open(filepath, "w", encoding="utf-8") as f:
                for i, (tok, score) in enumerate(self.model.vocab.id_to_token):
                    f.write(f"{i}\t{score}\t{tok.decode('utf-8', 'replace')}\n")
            return True
        except OSError:
            return False
