"""LlamaModel — the stateful single-stream runtime around the forward pass.

PyTorch port of fastllama_tpu/models/runtime.py: owns the parameters and the
per-layer KV caches on one device, pads each eval window up to a bucket
length (as the JAX runtime does for its compiled shapes, so both packages
run the same windows), and saves/loads the resident KV prefix in the same
npz layout, so a session saved by the JAX package loads here.

With rcfg.mesh_shape = (n_data, tp) over an initialized torch.distributed
world (one process a rank, every rank running the same program), the model
is served over the mesh (parallel/): each rank keeps its tensor-parallel
shard of the weights and of the cache's heads; n_data must be 1 unless
rcfg.seq_parallel makes the data axis the sequence axis (the cache's rows
sharded, prefill by ring attention). Every rank returns the same logits; a
saved state is the one-device file.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch

from ..config import HyperParams, RuntimeConfig, resolve_device
from ..engine.logger import Logger, NULL_LOGGER, ProgressTag
from ..engine.tokenizer import Vocab
from ..io.ggml_reader import MAGIC_GGLA, read_ggml_file
from .llama import (
    LORA_FIELDS, ForwardConfig, LlamaParams, LoraTerm, forward, init_kv_cache,
    position_tables,
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
        self._lora_path: str | None = None
        self.n_cached = 0    # tokens resident in the cache (state save/load)
        base = dict(n_head=hp.n_head, n_rot=hp.n_rot,
                    w_dtype=rcfg.weight_dtype, prefill_int8=rcfg.prefill_int8)
        # multi-GPU: this rank's shard of the weights and of the cache
        self.mesh = None
        self.sp = self.tp = 1
        self.sp_index = self.tp_index = 0
        self._tp_group = self._sp_group = None
        if rcfg.mesh_shape and int(np.prod(rcfg.mesh_shape)) > 1:
            base.update(self._setup_mesh(hp, rcfg))
        # one config per (all_logits, flash_prefill) combination; the flash
        # variants only ever run with n_past == 0 (eval dispatches)
        self._cfg = {
            (al, fl): ForwardConfig(all_logits=al, flash_prefill=fl, **base)
            for al in (False, True) for fl in (False, True)}
        local = dataclasses.replace(self.hp, n_embd=hp.n_embd // self.tp,
                                    n_head=hp.n_head // self.tp)
        self.kv = init_kv_cache(local, 1, rcfg.n_ctx // self.sp,
                                getattr(torch, rcfg.kv_dtype), self.device)
        self._tables = position_tables(rcfg.n_ctx, hp.head_dim, hp.n_rot,
                                       self.device)
        self._embeddings = torch.zeros((1, hp.n_embd), dtype=torch.float32)
        self._buckets = sorted({min(b, rcfg.n_ctx)
                                for b in rcfg.prefill_buckets} | {1, rcfg.n_ctx})

    def _setup_mesh(self, hp: HyperParams, rcfg: RuntimeConfig) -> dict:
        """Build the mesh, take this rank's shard of the parameters onto its
        device, and return the ForwardConfig fields of the sharded forward.
        A batch-1 session refuses data parallelism (seq_parallel makes the
        data axis the sequence axis instead) and needs n_ctx % sp == 0."""
        from ..parallel.multihost import hybrid_mesh
        from ..parallel.sharding import (
            mesh_coords, params_to, rank_device, shard_params,
        )
        n_data, n_model = (rcfg.mesh_shape if len(rcfg.mesh_shape) == 2
                           else (1, rcfg.mesh_shape[0]))
        if n_data != 1 and not rcfg.seq_parallel:
            raise ValueError(
                "the single-stream LlamaModel is batch=1 and cannot be "
                "data-parallel; use mesh_shape=(1, tp) here (or set "
                "rcfg.seq_parallel to shard the SEQUENCE over the data "
                "axis), or the continuous-batching BatchEngine")
        if rcfg.n_ctx % n_data:
            raise ValueError(
                f"n_ctx={rcfg.n_ctx} must be divisible by sp={n_data}")
        if hp.n_head % n_model:
            raise ValueError(
                f"n_head={hp.n_head} not divisible by tp={n_model}")
        self.device = rank_device(self.device)
        self.mesh = hybrid_mesh(n_data, n_model, self.device.type)
        self.sp, self.tp = n_data, n_model
        self.sp_index, self.tp_index = mesh_coords(self.mesh)
        data_axis, model_axis = self.mesh.mesh_dim_names
        if n_model > 1:
            self._tp_group = self.mesh[model_axis].get_group()
        if n_data > 1:
            self._sp_group = self.mesh[data_axis].get_group()
        self.params = params_to(
            shard_params(self.params, self.tp_index, n_model), self.device)
        self.logger.log("Model", f"sharded over mesh "
                        f"{'sp' if n_data > 1 else 'dp'}={n_data} "
                        f"tp={n_model} on {self.device}\n")
        return dict(n_head=hp.n_head // n_model, tp_group=self._tp_group,
                    sp_group=self._sp_group, sp_size=n_data,
                    sp_chunked=n_data > 1)

    @property
    def is_writer(self) -> bool:
        """True on the one rank that writes a file for the whole mesh
        (rank 0; always without a mesh)."""
        return self.mesh is None or self.mesh.get_rank() == 0

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a no-op without one)."""
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()

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
        b = self._bucket(t, n_past)
        if self.sp > 1 and b > 1:
            # prefill windows shard over the sequence axis: T % sp == 0.
            # Padded tail rows land past the real window (causally masked;
            # cache writes past n_ctx drop) and are overwritten by the next
            # chunk's real tokens before anything attends them.
            b = min(-(-b // self.sp) * self.sp, self.hp.n_ctx)
        buf = np.zeros((1, b), np.int64)
        buf[0, :t] = np.asarray(tokens, np.int64)
        if self.sp > 1 and b > 1:
            tl = b // self.sp
            buf = buf[:, self.sp_index * tl:(self.sp_index + 1) * tl]
        with torch.inference_mode():
            logits, self.kv, self._embeddings = forward(
                self.params, torch.from_numpy(buf).to(self.device), n_past,
                self.kv, self._cfg[(all_logits, n_past == 0 and t > 1)],
                t - 1, self._tables)
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

    def _whole_cache(self, cache: torch.Tensor) -> torch.Tensor:
        """One layer's cache as one device holds it: the ranks' head
        columns and (SP) sequence rows all-gathered (a collective: every
        rank calls it)."""
        from ..parallel.collectives import all_gather
        if self._tp_group is not None:
            cache = all_gather(cache, self._tp_group, dim=2)
        if self._sp_group is not None:
            cache = all_gather(cache, self._sp_group, dim=1)
        return cache

    def kv_state(self) -> dict[str, np.ndarray]:
        """The resident KV prefix as f32 [L, B, n, H*Dh] arrays; under a
        mesh the ranks' blocks are gathered, so the arrays are the
        one-device ones on every rank."""
        n = self.n_cached
        kk = torch.stack([self._whole_cache(k)[:, :n]
                          for k, _ in self.kv]).float().cpu().numpy()
        vv = torch.stack([self._whole_cache(v)[:, :n]
                          for _, v in self.kv]).float().cpu().numpy()
        return {"kv_k": kk, "kv_v": vv}

    def load_kv_state(self, state: dict[str, np.ndarray]) -> None:
        """Load a one-device state; under a mesh each rank keeps its block
        (its head columns and, SP, its sequence rows)."""
        k = np.asarray(state["kv_k"])          # [L, B, n, H*Dh]
        n = k.shape[2]
        if n > self.hp.n_ctx:
            raise ValueError(f"saved KV length {n} exceeds n_ctx={self.hp.n_ctx}")
        v = np.asarray(state["kv_v"])
        s_loc, f_loc = self.kv[0][0].shape[1:]
        lo = self.sp_index * s_loc
        rows = slice(lo, min(n, lo + s_loc))
        cols = slice(self.tp_index * f_loc, (self.tp_index + 1) * f_loc)
        for li, (kc, vc) in enumerate(self.kv):
            kc.zero_()
            vc.zero_()
            kc[:, :max(rows.stop - lo, 0)] = torch.from_numpy(
                k[li][:, rows, cols]).to(kc.dtype)
            vc[:, :max(rows.stop - lo, 0)] = torch.from_numpy(
                v[li][:, rows, cols]).to(vc.dtype)
        self.n_cached = n

    def set_threads(self, n: int) -> None:
        """No-op parity shim (reference Model::set_threads)."""
        del n

    # -- LoRA ---------------------------------------------------------------

    def attach_lora(self, path: str) -> bool:
        """Attach a ggla adapter. Each adapter tensor becomes a separate
        additive LoraTerm applied alongside the fused matmuls (cast to the
        weight dtype), so attach is lossless on quantized bases and detach
        restores bit-identical outputs in O(1). Terms are staged and set
        only when every group resolved: a bad adapter leaves the model
        untouched. Failures are logged and return False."""
        if self._lora_path:
            self.logger.log_err("attach_lora",
                                "an adapter is already attached; detach first\n")
            return False
        try:
            gg = read_ggml_file(path)
        except (OSError, ValueError) as e:
            self.logger.log_err("attach_lora", f"failed to read '{path}': {e}\n")
            return False
        if gg.magic != MAGIC_GGLA:
            self.logger.log_err("attach_lora", f"'{path}' is not a ggla adapter\n")
            return False
        use_cache = gg.lora_params["use_cache_matrix"]

        # group adapter tensors by base weight name
        groups: dict[str, dict[str, str]] = {}
        for name in gg.tensors:
            for suffix, key in ((".lora", "delta"), (".loraA", "a"),
                                (".loraB", "b")):
                if name.endswith(suffix):
                    groups.setdefault(name[:-len(suffix)], {})[key] = name
                    break
            else:
                self.logger.log_err("attach_lora",
                                    f"unrecognized adapter tensor '{name}'\n")
                return False

        w_dtype = getattr(torch, self.rcfg.weight_dtype)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device).to(w_dtype)

        staged: list[tuple[object, str, LoraTerm]] = []
        for base_name, g in groups.items():
            slot = self._lora_slot(base_name)
            if slot is None:
                self.logger.log_err(
                    "attach_lora", f"unknown base tensor '{base_name}' — are "
                    "you sure that this adapter is for this model?\n")
                return False
            if use_cache:
                if "delta" not in g:
                    self.logger.log_err("attach_lora",
                                        f"missing cached ΔW for '{base_name}'\n")
                    return False
                # ΔW arrives [N, K] and is stored [K, N]
                term = LoraTerm(delta=put(gg.dense(g["delta"]).T))
            else:
                if "a" not in g or "b" not in g:
                    self.logger.log_err("attach_lora",
                                        f"missing A/B pair for '{base_name}'\n")
                    return False
                # loraA arrives [K, r] (pre-scaled A^T), loraB [N, r]
                term = LoraTerm(a=put(gg.dense(g["a"])),
                                b=put(gg.dense(g["b"]).T))
            staged.append((*slot, term))
            self.logger.progress(ProgressTag.ATTACH_LORA, len(staged),
                                 len(groups))

        for holder, attr, term in staged:
            setattr(holder, attr, term)
        self._lora_path = path
        self._reshard_after_lora_change()
        return True

    def detach_lora(self) -> bool:
        """O(1) detach: drop every LoraTerm."""
        if not self._lora_path:
            self.logger.log_err("detach_lora", "no adapter attached\n")
            return False
        self.params.lora_output = None
        for layer in self.params.layers:
            for attr in LORA_FIELDS:
                setattr(layer, attr, None)
        self.logger.progress(ProgressTag.DETACH_LORA, 1, 1)
        self._lora_path = None
        return True

    def _reshard_after_lora_change(self) -> None:
        """Under tensor parallelism the attached terms arrive at their
        global widths: each rank keeps the slice its base weight's shard
        takes (shard_params slices only the new terms of sharded
        parameters, never the base weights again)."""
        if self.tp > 1:
            from ..parallel.sharding import shard_params
            self.params = shard_params(self.params, self.tp_index, self.tp)

    @property
    def lora_path(self) -> str | None:
        return self._lora_path

    def _lora_slot(self, ggml_name: str):
        """Map a ggml base-tensor name to (holder, lora_field)."""
        if ggml_name == "output.weight":
            return self.params, "lora_output"
        m = re.match(
            r"layers\.(\d+)\.(attention\.(wq|wk|wv|wo)|feed_forward\.(w1|w2|w3))"
            r"\.weight$", ggml_name)
        if not m:
            return None
        li = int(m.group(1))
        if li >= len(self.params.layers):
            return None
        return self.params.layers[li], "lora_" + (m.group(3) or m.group(4))
