"""Continuous-batching engine: many concurrent sessions over one model
(PyTorch port of fastllama_tpu/engine/scheduler.py, one device).

A fixed pool of B slots decodes in lockstep, each at its own cache depth,
with new requests admitted into idle slots at any step.

  * One decode step serves every slot: tokens [B, 1] with per-slot
    positions (models/llama.forward takes n_past as an int32 [B] tensor; an
    inactive slot runs at position n_ctx + 1, past the cache, so its KV write
    is dropped or, in the fused kernel, lands in its own last row).
  * kv_mode "slab" keeps [n_slots, n_ctx] caches; "paged" shares a page pool
    (engine/paged_kv.py) and steps through forward_paged_decode.
  * Sampling parameters are per request (temp / top_k / top_p /
    repeat_penalty as per-slot vectors in engine/sampling.sample_device).
    The engine's top_k is the static cap per-request values are clamped to.
  * Slot state that must survive across steps lives on the device (the last
    tokens, positions, the active mask, the last-n window, the per-slot
    sampling knobs) and is updated in place; the step reads no value from it
    on the host. Host-side Request objects hold text streams and lifecycle.
  * The host drains sampled tokens `drain_depth` steps late: step() enqueues
    the next device step and only then waits for an older step's tokens,
    which were copied into pinned host memory behind a CUDA event. A slot
    that stopped k steps ago just produced k ignored tokens; drained entries
    are matched by request id, so a re-admitted slot never sees a previous
    occupant's tokens.

Under rcfg.mesh_shape = (dp, tp) over an initialized torch.distributed
world (one process a rank, every rank running the same program and given
the same requests; parallel/multihost.py) each rank holds its tensor-
parallel shard of the weights and of the KV heads, and the slots of its data
group (n_slots / dp of them, a contiguous range; their pages come from the
group's partition of the page ids). A decode step runs the group's slots;
the sampled tokens are all-gathered over the data axis, so every rank keeps
the same host state and makes the same stop and admit decisions. The TP
ranks of a group draw the same sampling noise; the groups fold their index
into the seed. An admission runs its prefill on the owner group alone and
broadcasts the first token over the data axis. Chunked admission is
single-device (as in the JAX package): under a mesh it is refused with a
warning and admission is monolithic.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import HyperParams, RuntimeConfig, resolve_device
from ..kernels.kv_write import paged_kv_write_rows
from ..models.llama import (
    ForwardConfig, LlamaParams, forward, forward_paged_decode,
    forward_paged_prefill, init_kv_cache, position_tables,
)
from ..parallel.collectives import all_gather, broadcast
from ..utils.trace import trace_region
from .logger import Logger, NULL_LOGGER
from .paged_kv import PagedKVManager, write_tokens_paged
from .sampling import draw_uniforms, sample_device
from .token_buffer import TokenBuffer
from .tokenizer import EOS_ID, Vocab, tokenize


@dataclasses.dataclass
class Request:
    prompt: str
    max_tokens: int = 128
    # sampling knobs: None = the engine's default. temp <= 0 decodes this
    # request greedily. top_k is clamped to the engine's static top_k cap.
    temp: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    repeat_penalty: Optional[float] = None
    stop_words: Sequence[str] = ()
    streaming_fn: Optional[Callable[[str], None]] = None
    # filled by the engine
    rid: int = -1
    slot: int = -1
    text: str = ""
    tokens_out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    n_prompt: int = 0


@dataclasses.dataclass
class _Admission:
    """An in-flight chunked admission: the prompt's remaining chunks run
    one per engine step against a private [1, n_ctx] row cache."""
    slot_idx: int
    req: Request
    ids: list[int]
    n_done: int = 0
    last_logits: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    n_past: int = 0
    generated: int = 0
    buffer: Optional[TokenBuffer] = None
    stop_bytes: list[bytes] = dataclasses.field(default_factory=list)
    # False while a chunked admission is still prefilling this slot: the
    # slot is reserved (req set) but must not join decode launches or claim
    # drained tokens until _activate_slot flips it
    live: bool = False


class BatchEngine:
    def __init__(self, hp: HyperParams, params: LlamaParams, vocab: Vocab,
                 n_slots: int = 8, n_ctx: int = 2048,
                 rcfg: RuntimeConfig = RuntimeConfig(),
                 sampling_seed: int = 0,
                 top_k: int = 40, top_p: float = 0.95, temp: float = 0.8,
                 repeat_penalty: float = 1.0, last_n: int = 64,
                 kv_mode: str = "slab",
                 page_size: int = 64, total_pages: int = 0,
                 drain_depth: Optional[int] = None,
                 chunked_admission: bool = False,
                 logger: Logger = NULL_LOGGER, device=None):
        """kv_mode: "slab" reserves [n_slots, n_ctx] KV up front; "paged"
        shares a physical page pool (engine/paged_kv.py) so mixed-length
        sequences only hold the pages they fill. total_pages defaults to the
        slab-equivalent capacity.

        drain_depth: how many decode steps the host token drain lags the
        device (None = 0, fully synchronous).

        device: the CUDA card unless the caller passes "cpu"; the parameters
        must already live there (under a mesh they may be on the host: each
        rank copies its shard to its device).
        """
        self.device = resolve_device(device)
        if kv_mode not in ("slab", "paged"):
            raise ValueError(f"kv_mode must be 'slab' or 'paged': {kv_mode!r}")
        self.hp = hp
        # -- mesh setup: this rank's shard, its data group's slots --------
        self.mesh = None
        self.dp = self.tp = 1
        self.dp_index = self.tp_index = 0
        self._dp_group = self._tp_group = None
        if rcfg.mesh_shape and int(np.prod(rcfg.mesh_shape)) > 1:
            params = self._setup_mesh(hp, params, n_slots, rcfg, logger)
        elif params.norm.device.type != self.device.type:
            raise ValueError(
                f"the parameters live on {params.norm.device}, the engine "
                f"runs on {self.device}")
        # this rank's slots [lo, hi): its data group's
        per = n_slots // self.dp
        self._lo, self._hi = self.dp_index * per, (self.dp_index + 1) * per
        self.params = params
        self.vocab = vocab
        self.rcfg = rcfg
        self.n_slots = n_slots
        self.n_ctx = n_ctx
        self.logger = logger
        self.top_k, self.top_p, self.temp = top_k, top_p, temp
        self.repeat_penalty, self.last_n_size = repeat_penalty, last_n
        self.kv_mode = kv_mode
        self.drain_depth = 0 if drain_depth is None else drain_depth
        # two-phase drain: (host tensor, event, entries) of a device->host
        # copy in flight; consumed one drain cycle later
        self._pending_drain = None
        # (tokens tensor [B, 1] of that step alone, per-slot rid snapshot)
        # per launched step
        self._inflight: collections.deque[tuple[torch.Tensor, list[int]]] = \
            collections.deque()

        dev = self.device
        kv_dtype = getattr(torch, rcfg.kv_dtype)
        # the caches' head columns: this rank's
        hp_local = dataclasses.replace(hp, n_embd=hp.n_embd // self.tp,
                                       n_head=hp.n_head // self.tp)
        if kv_mode == "paged":
            total_pages = total_pages or (n_slots * n_ctx) // page_size
            total_pages = -(-total_pages // self.dp) * self.dp
            self.pager = PagedKVManager(
                hp, n_slots=n_slots, page_size=page_size,
                total_pages=total_pages,
                pages_per_seq=-(-n_ctx // page_size), dtype=kv_dtype,
                device=dev, dp=self.dp, group=self.dp_index, tp=self.tp)
            self.kv = None
        else:
            self.pager = None
            self.kv = init_kv_cache(hp_local, per, n_ctx, kv_dtype, dev)
        self.cfg = ForwardConfig(
            n_head=hp.n_head // self.tp, n_rot=hp.n_rot,
            w_dtype=rcfg.weight_dtype, prefill_int8=rcfg.prefill_int8,
            tp_group=self._tp_group)
        # the monolithic admissions' prefill (a fresh row or slot: n_past
        # == 0), which may attend through the flash kernel, as the JAX
        # engine's three prefill builders do; chunked admission keeps cfg
        self._prefill_cfg = dataclasses.replace(self.cfg, flash_prefill=True)
        self._tables = position_tables(n_ctx, hp.head_dim, hp.n_rot, dev)

        # device-side slot state, updated in place
        self.d_tokens = torch.zeros((n_slots, 1), dtype=torch.int64,
                                    device=dev)
        self.d_npast = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.d_active = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
        self.d_lastn = torch.full((n_slots, last_n), -1, dtype=torch.int32,
                                  device=dev)
        self.d_temps = torch.full((n_slots,), temp, dtype=torch.float32,
                                  device=dev)
        self.d_topk = torch.full((n_slots,), top_k, dtype=torch.int32,
                                 device=dev)
        self.d_topp = torch.full((n_slots,), top_p, dtype=torch.float32,
                                 device=dev)
        self.d_rp = torch.full((n_slots,), repeat_penalty,
                               dtype=torch.float32, device=dev)
        # the decode steps draw from one generator on the device (its offset
        # is the step counter); each admission's first token has its own,
        # seeded from the request id, so it does not depend on when the
        # request was admitted
        self._sampling_seed = sampling_seed
        self._gen = torch.Generator(device=dev)
        # a data group's own noise (the JAX step key folds in the dp index);
        # the TP ranks of a group draw the same
        self._gen.manual_seed(sampling_seed + (self.dp_index << 32))
        self._k = min(top_k if top_k > 0 else hp.n_vocab, hp.n_vocab)

        self.slots = [_Slot() for _ in range(n_slots)]
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self._next_rid = 0
        self._buckets = sorted({min(b, n_ctx) for b in rcfg.prefill_buckets}
                               | {n_ctx})

        # The private [1, n_ctx] row cache of an admission: the monolithic
        # slab prefill runs in it and splices its rows into the slab; a
        # chunked admission advances through it one chunk per engine step.
        # It is zeroed once and reused, so its stale rows are finite.
        self.chunked_admission = chunked_admission and self.mesh is None
        if chunked_admission and not self.chunked_admission:
            logger.log_warn(
                "BatchEngine", "chunked admission is single-device only; "
                "falling back to monolithic admission\n")
        self._adm: Optional[_Admission] = None
        self._adm_chunk = max(8, min(rcfg.n_batch, n_ctx))
        self._row_kv = None
        if self.chunked_admission or self.pager is None:
            self._row_kv = init_kv_cache(hp_local, 1, n_ctx, kv_dtype, dev)

    def _setup_mesh(self, hp: HyperParams, params: LlamaParams, n_slots: int,
                    rcfg: RuntimeConfig, logger: Logger) -> LlamaParams:
        """Build the (dp, tp) mesh and return this rank's shard of the
        parameters on its device."""
        from ..parallel.multihost import hybrid_mesh
        from ..parallel.sharding import (
            mesh_coords, params_to, rank_device, shard_params,
        )
        dp, tp = (rcfg.mesh_shape if len(rcfg.mesh_shape) == 2
                  else (1, rcfg.mesh_shape[0]))
        if n_slots % dp:
            raise ValueError(f"n_slots={n_slots} not divisible by dp={dp}")
        if hp.n_head % tp:
            raise ValueError(f"n_head={hp.n_head} not divisible by tp={tp}")
        self.device = rank_device(self.device)
        self.mesh = hybrid_mesh(dp, tp, self.device.type)
        self.dp, self.tp = dp, tp
        self.dp_index, self.tp_index = mesh_coords(self.mesh)
        data_axis, model_axis = self.mesh.mesh_dim_names
        if dp > 1:
            self._dp_group = self.mesh[data_axis].get_group()
        if tp > 1:
            self._tp_group = self.mesh[model_axis].get_group()
        logger.log("BatchEngine", f"sharded over mesh dp={dp} tp={tp} on "
                   f"{self.device}\n")
        return params_to(shard_params(params, self.tp_index, tp), self.device)

    # -- device steps --------------------------------------------------------

    def _sample_and_advance(self, logits: torch.Tensor) -> torch.Tensor:
        """Per-slot sampling on the device and the state advance shared by
        the slab and the paged step: this rank's slots sample, then the
        tokens are all-gathered over the data axis. Returns this step's
        tokens [B, 1] of every slot, a tensor of its own (the drain keeps it
        while d_tokens moves on)."""
        active = self.d_active
        mine = slice(self._lo, self._hi)
        nxt = sample_device(
            logits[:, -1, :], self.d_lastn[mine],
            draw_uniforms(self._gen, self._hi - self._lo, self._k,
                          self.device),
            top_k=self.top_k, top_p=self.d_topp[mine],
            temp=self.d_temps[mine], repeat_penalty=self.d_rp[mine],
            top_k_v=self.d_topk[mine])
        nxt = torch.where(active[mine], nxt, 0)
        if self._dp_group is not None:
            nxt = all_gather(nxt, self._dp_group, dim=0)
        self.d_lastn.copy_(torch.where(
            active[:, None],
            torch.cat([self.d_lastn[:, 1:], nxt[:, None]], dim=1),
            self.d_lastn))
        tok_out = nxt[:, None].to(torch.int64)
        self.d_tokens.copy_(tok_out)
        return tok_out

    def _decode_slab(self) -> torch.Tensor:
        # inactive slots: position beyond n_ctx -> their KV writes drop
        mine = slice(self._lo, self._hi)
        eff_past = torch.where(self.d_active[mine], self.d_npast[mine],
                               self.n_ctx + 1)
        logits, _, _ = forward(self.params, self.d_tokens[mine], eff_past,
                               self.kv, self.cfg, tables=self._tables)
        tok_out = self._sample_and_advance(logits)
        self.d_npast.add_(self.d_active.to(torch.int32))
        return tok_out

    def _decode_paged(self, lengths, tables, page_ids, offs) -> torch.Tensor:
        logits, _, _ = forward_paged_decode(
            self.params, self.d_tokens[self._lo:self._hi], lengths, tables,
            self.pager.k_pages, self.pager.v_pages, page_ids, offs, self.cfg,
            self._tables)
        return self._sample_and_advance(logits)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prefill_slab(self, toks: np.ndarray, slot: int,
                      last_idx: int) -> torch.Tensor:
        """Single-row prefill: run the prompt through the [1, n_ctx] row
        cache, then splice the window's rows into the batched slab at `slot`
        (the prompt costs 1/n_slots of a full-batch forward). Rows past the
        window keep the previous occupant's values: finite, masked by the
        slot's depth and overwritten as it decodes."""
        logits, _, _ = forward(self.params, self._to_device(toks), 0,
                               self._row_kv, self._prefill_cfg, last_idx,
                               self._tables)
        self._splice_slab(slot, toks.shape[1])
        return logits[:, -1, :]

    def _splice_slab(self, slot: int, n_rows: int) -> None:
        slot -= self._lo                  # this rank's slab holds its slots
        for (k_all, v_all), (k1, v1) in zip(self.kv, self._row_kv):
            k_all[slot, :n_rows] = k1[0, :n_rows]
            v_all[slot, :n_rows] = v1[0, :n_rows]

    def _ingest_chunk(self, toks: np.ndarray, n_done: int,
                      last_idx: int) -> torch.Tensor:
        """One n_batch-wide ingest step over the row cache. The rows are
        written by the dropping scatter (the padded tail of the last chunk
        can pass n_ctx); attention is the masked softmax over rows <=
        position, so partitioning the QUERY rows into chunks leaves each
        row's math identical to the monolithic prefill (exactly in f32)."""
        n_past = torch.full((1,), n_done, dtype=torch.int32,
                            device=self.device)
        logits, _, _ = forward(self.params, self._to_device(toks), n_past,
                               self._row_kv, self.cfg, last_idx, self._tables)
        return logits[:, -1, :]

    def _splice_paged(self, slot: int, t: int) -> None:
        """Write the admission row cache's first t rows into the slot's
        pages with the bulk kernel B8: the row count is padded up to a page
        multiple, so every block that holds a real row goes to its real page
        whole. The tail rows of the last page then hold what the row cache
        held there (finite: padded-chunk rows or stale ones), which the
        length mask hides and later decode writes replace. A last block that
        would pass the row cache (n_ctx not a page multiple) goes row by row
        through write_tokens_paged."""
        pager = self.pager
        ps = pager.page_size
        n_bulk = min(-(-t // ps) * ps, (self.n_ctx // ps) * ps)
        if n_bulk:
            block_pages = self._to_device(np.ascontiguousarray(
                pager.page_tables[slot, :n_bulk // ps]))
            for kp, vp, (k1, v1) in zip(pager.k_pages, pager.v_pages,
                                        self._row_kv):
                paged_kv_write_rows(kp, vp, k1[0, :n_bulk], v1[0, :n_bulk],
                                    block_pages)
        if n_bulk < t:
            h, hd = self.hp.n_head, self.hp.head_dim
            pages, offs = (self._to_device(a[None]) for a in
                           pager.token_page_offsets(slot, n_bulk, t - n_bulk))
            for kp, vp, (k1, v1) in zip(pager.k_pages, pager.v_pages,
                                        self._row_kv):
                write_tokens_paged(
                    kp, vp, k1[:, n_bulk:t].reshape(1, t - n_bulk, h, hd),
                    v1[:, n_bulk:t].reshape(1, t - n_bulk, h, hd), pages,
                    offs)

    # -- chunked admission ---------------------------------------------------

    def _start_admission(self, slot_idx: int, req: Request) -> bool:
        ids = self._tokenize_guard(req)
        if ids is None:
            return False
        self._setup_slot(slot_idx, req, ids)
        self._adm = _Admission(slot_idx=slot_idx, req=req, ids=ids)
        return True

    def _advance_admission(self) -> None:
        """Run ONE prompt chunk; on the final chunk, splice the row cache
        into the slot's cache and activate the slot."""
        adm = self._adm
        nb = self._adm_chunk
        t = len(adm.ids)
        r = min(nb, t - adm.n_done)
        toks = np.zeros((1, nb), np.int64)
        toks[0, :r] = adm.ids[adm.n_done:adm.n_done + r]
        adm.last_logits = self._ingest_chunk(toks, adm.n_done, r - 1)
        adm.n_done += r
        if adm.n_done >= t:
            si = adm.slot_idx
            if self.pager is not None:
                if not self.pager.alloc_for(si, t):
                    self.slots[si].req = None
                    adm.req.done = True
                    self.logger.log_err(
                        "BatchEngine",
                        f"request {adm.req.rid}: out of KV pages\n")
                    self._adm = None
                    return
                self._splice_paged(si, t)
                self.pager.lengths[si] = t
            else:
                self._splice_slab(si, min(adm.n_done, self.n_ctx))
            self._activate_slot(si, adm.req, adm.last_logits, t)
            self._adm = None

    # -- request lifecycle ---------------------------------------------------

    def submit(self, req: Request) -> Request:
        req.rid = self._next_rid
        self._next_rid += 1
        self.pending.put(req)
        return req

    def _req_sampling(self, req: Request) -> tuple[float, int, float, float]:
        temp = self.temp if req.temp is None else req.temp
        topk = self.top_k if req.top_k is None else req.top_k
        topk = max(1, min(topk if topk > 0 else self.top_k, self.top_k))
        topp = self.top_p if req.top_p is None else req.top_p
        rp = self.repeat_penalty if req.repeat_penalty is None \
            else req.repeat_penalty
        return temp, topk, topp, rp

    def _tokenize_guard(self, req: Request) -> Optional[list[int]]:
        ids = tokenize(self.vocab, " " + req.prompt, bos=True)
        if len(ids) > self.n_ctx - 4:
            req.done = True
            req.text = ""
            self.logger.log_err("BatchEngine",
                                f"request {req.rid} prompt too long\n")
            return None
        return ids

    def _setup_slot(self, slot_idx: int, req: Request, ids: list[int]) -> None:
        slot = self.slots[slot_idx]
        slot.req = req
        slot.live = False
        slot.n_past = 0
        slot.generated = 0
        slot.stop_bytes = [w.encode() for w in req.stop_words]
        max_buf = max((len(tokenize(self.vocab, w, bos=False))
                       for w in req.stop_words), default=0)

        def emit(s, _req=req):
            _req.text += s
            if _req.streaming_fn:
                _req.streaming_fn(s)

        slot.buffer = TokenBuffer(self.vocab, max_buf, emit)
        req.slot = slot_idx
        req.n_prompt = len(ids)

    def _activate_slot(self, slot_idx: int, req: Request,
                       logits_for_slot: Optional[torch.Tensor],
                       t: int) -> None:
        """Shared admission tail: fresh per-slot sampling state, the first
        token sampled ON DEVICE (no host round-trip), device slot state
        armed, and the first-token drain entry queued. Under data
        parallelism only the owner group has the logits (the others pass
        None) and broadcasts the token over the data axis."""
        slot = self.slots[slot_idx]
        req_temp, req_topk, req_topp, req_rp = self._req_sampling(req)
        self.d_temps[slot_idx] = req_temp
        self.d_topk[slot_idx] = req_topk
        self.d_topp[slot_idx] = req_topp
        self.d_rp[slot_idx] = req_rp
        self.d_lastn[slot_idx] = -1

        if logits_for_slot is None:
            first = torch.zeros(1, dtype=torch.int64, device=self.device)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self._sampling_seed * 1000003 + 100000 + req.rid)
            first = sample_device(
                logits_for_slot, self.d_lastn[slot_idx:slot_idx + 1],
                draw_uniforms(gen, 1, self._k, self.device),
                top_k=self.top_k, top_p=req_topp, temp=req_temp,
                repeat_penalty=req_rp,
                top_k_v=self.d_topk[slot_idx:slot_idx + 1]).to(torch.int64)
        if self._dp_group is not None:          # from the owner data group
            first = broadcast(first, slot_idx // (self._hi - self._lo),
                              self._dp_group)

        # host counters start one behind: the first-token drain advances them
        slot.n_past = t - 1
        slot.generated = 0
        slot.live = True

        self.d_tokens[slot_idx] = first
        self.d_npast[slot_idx] = t
        self.d_active[slot_idx] = True
        self.d_lastn[slot_idx, -1:] = first
        rids = [-1] * self.n_slots
        rids[slot_idx] = req.rid
        # a copy: d_tokens is updated in place by every later step
        self._inflight.append((self.d_tokens.clone(), rids))

    def _admit(self, slot_idx: int, req: Request) -> bool:
        ids = self._tokenize_guard(req)
        if ids is None:
            return False
        self._setup_slot(slot_idx, req, ids)
        slot = self.slots[slot_idx]

        # bucketed prefill (single live row in every mode)
        t = len(ids)
        bucket = next((b for b in self._buckets if b >= t), self.n_ctx)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :t] = ids
        if self.pager is not None:
            # fresh slot: prompt-local attention + page writes
            if not self.pager.alloc_for(slot_idx, t):
                slot.req = None
                req.done = True
                self.logger.log_err("BatchEngine",
                                    f"request {req.rid}: out of KV pages\n")
                return False
            pages = np.full(bucket, self.pager.sentinel, np.int32)
            offs = np.zeros(bucket, np.int32)
            pages[:t], offs[:t] = \
                self.pager.token_page_offsets(slot_idx, 0, t)
            logits_for_slot = None
            if self._lo <= slot_idx < self._hi:
                logits_for_slot, _, _ = forward_paged_prefill(
                    self.params, self._to_device(toks), t - 1,
                    self._to_device(pages), self._to_device(offs),
                    self.pager.k_pages, self.pager.v_pages,
                    self._prefill_cfg, self._tables)
            self.pager.lengths[slot_idx] = t
        elif self._lo <= slot_idx < self._hi:
            logits_for_slot = self._prefill_slab(toks, slot_idx, t - 1)
        else:
            logits_for_slot = None       # another data group's slot

        self._activate_slot(slot_idx, req, logits_for_slot, t)
        return True

    def _emit_token(self, slot: _Slot, token: int) -> None:
        req = slot.req
        if token == EOS_ID:
            slot.buffer.flush_all()
            self._finish(slot)
            return
        req.tokens_out.append(token)
        slot.buffer.add(token)
        found, before, after = slot.buffer.scan_stop_words(slot.stop_bytes)
        if found:
            if before:
                req.text += before.decode("utf-8", "replace")
                if req.streaming_fn:
                    req.streaming_fn(before.decode("utf-8", "replace"))
            self._finish(slot)
            return
        # the context guard reserves the max drain lag (2*depth banked steps
        # + the one being launched): steps launched before the host notices
        # the stop must still write KV in bounds
        if slot.generated >= req.max_tokens or \
                slot.n_past >= self.n_ctx - 2 - 2 * self.drain_depth:
            slot.buffer.flush_all()
            self._finish(slot)

    def _finish(self, slot: _Slot) -> None:
        idx = self.slots.index(slot)
        slot.req.done = True
        slot.req = None
        slot.live = False
        self.d_active[idx] = False
        if self.pager is not None:
            self.pager.free_slot(idx)

    # -- main loop -----------------------------------------------------------

    def _fill_idle_slots(self) -> None:
        if self.chunked_admission:
            # one admission in flight at a time, advanced one chunk per
            # engine step; decode keeps running for the active slots
            if self._adm is None and not self.pending.empty():
                for i, slot in enumerate(self.slots):
                    if slot.req is None:
                        try:
                            req = self.pending.get_nowait()
                        except queue.Empty:
                            break
                        if self._start_admission(i, req):
                            break
            if self._adm is not None:
                self._advance_admission()
            return
        for i, slot in enumerate(self.slots):
            if slot.req is None and not self.pending.empty():
                try:
                    req = self.pending.get_nowait()
                except queue.Empty:
                    break
                self._admit(i, req)

    def _launch(self) -> None:
        """Enqueue one batched decode step (returns without blocking)."""
        if self.pager is not None:
            # the step's write locations and tables are built on the host
            # and go to the device in one copy:
            # [lengths | page ids | offsets | page tables]
            b, pp = self.n_slots, self.pager.pages_per_seq
            packed = np.zeros(3 * b + b * pp, np.int32)
            lengths, pages, offs = packed[:b], packed[b:2 * b], \
                packed[2 * b:3 * b]
            pages[:] = self.pager.sentinel
            for i, slot in enumerate(self.slots):
                if slot.req is None or not slot.live:
                    continue
                ln = int(self.pager.lengths[i])
                if not self.pager.alloc_for(i, ln + 1):
                    self.logger.log_err(
                        "BatchEngine", f"slot {i}: out of KV pages, "
                        "finishing early\n")
                    slot.buffer.flush_all()
                    self._finish(slot)
                    continue
                p, o = self.pager.token_page_offsets(i, ln, 1)
                pages[i], offs[i] = p[0], o[0]
                lengths[i] = ln
            if not any(s.live for s in self.slots):
                return
            packed[3 * b:] = self.pager.page_tables.reshape(-1)
            if self.dp > 1:
                # this rank's slots; their ids are local to its group
                lo, hi = self._lo, self._hi
                packed = np.concatenate(
                    [packed[:b][lo:hi], packed[b:2 * b][lo:hi],
                     packed[2 * b:3 * b][lo:hi],
                     self.pager.page_tables[lo:hi].reshape(-1)])
                b = hi - lo
            d = self._to_device(packed)
            tok_out = self._decode_paged(
                d[:b], d[3 * b:].view(b, pp), d[b:2 * b], d[2 * b:3 * b])
            for i, slot in enumerate(self.slots):
                if slot.req is not None and slot.live:
                    self.pager.lengths[i] += 1
        else:
            tok_out = self._decode_slab()
        self._inflight.append(
            (tok_out,
             [s.req.rid if s.req is not None and s.live else -1
              for s in self.slots]))

    def _pop_entries(self, count: int):
        """The `count` oldest in-flight steps and their tokens as one
        [B, count] device tensor."""
        entries = [self._inflight.popleft() for _ in range(count)]
        arr = entries[0][0] if count == 1 else torch.cat(
            [e[0] for e in entries], dim=1)
        return arr, entries

    def _start_drain(self, count: int) -> None:
        """Begin an ASYNC device->host copy of the `count` oldest in-flight
        steps' tokens (one transfer into pinned memory, an event behind it)
        while the device keeps decoding newer steps; a later
        _consume_drain() waits for the event and emits the tokens."""
        arr, entries = self._pop_entries(count)
        event = None
        if arr.device.type == "cuda":
            host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
            host.copy_(arr, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            arr = host
        self._pending_drain = (arr, event, entries)

    def _consume_drain(self) -> None:
        if self._pending_drain is None:
            return
        arr, event, entries = self._pending_drain
        self._pending_drain = None
        if event is not None:
            # the pinned buffer holds the tokens only once the copy is done
            event.synchronize()
        self._emit_entries(arr.numpy(), entries)

    def _drain(self, count: int) -> None:
        """Synchronous drain (idle flush): read back the `count` oldest
        in-flight steps in ONE transfer and emit, oldest first. Entries are
        matched by request id: a slot re-admitted since the launch never
        sees the old occupant's tokens."""
        arr, entries = self._pop_entries(count)
        self._emit_entries(arr.cpu().numpy(), entries)

    def _emit_entries(self, toks: np.ndarray, entries) -> None:
        for j, (_, rids) in enumerate(entries):
            for i, slot in enumerate(self.slots):
                if slot.req is not None and slot.req.rid == rids[i]:
                    slot.n_past += 1
                    slot.generated += 1
                    self._emit_token(slot, int(toks[i, j]))

    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration: admit pending requests, launch one batched
        decode step, drain once enough steps are banked. Returns the number
        of occupied slots (host view)."""
        self._fill_idle_slots()
        if any(s.live for s in self.slots):
            self._launch()
        # hysteresis: let up to 2*depth steps bank; each cycle first lands
        # the PREVIOUS cycle's async transfer (it overlapped the last `depth`
        # device steps), then starts the next one. Once idle, flush
        # everything synchronously.
        if not any(s.live for s in self.slots):
            self._consume_drain()
            if self._inflight:
                self._drain(len(self._inflight))
        elif len(self._inflight) >= max(2 * self.drain_depth, 1):
            self._consume_drain()
            self._start_drain(max(self.drain_depth, 1))
        return sum(1 for s in self.slots if s.req is not None)

    def run(self, requests: Sequence[Request]) -> list[Request]:
        """Submit requests and run until all complete."""
        for r in requests:
            self.submit(r)
        with trace_region(self.rcfg.profile_dir, "engine_run"):
            while not all(r.done for r in requests):
                self.step()
        self._pending_drain = None
        self._inflight.clear()
        return list(requests)
