"""Paged KV cache: virtual memory for the KV cache (PyTorch port of
fastllama_tpu/engine/paged_kv.py).

The slab cache (models/llama.init_kv_cache) reserves n_ctx rows per slot up
front. The paged cache shares a physical page pool across all sequences:
each sequence holds only the pages it fills, so long and short sequences
coexist without reserving the worst case.

  k_pages / v_pages:  per layer, [H, total_pages + 1, page_size, Dh] on the
                      device (the last page is the trash page)
  page_tables:        [n_slots, pages_per_seq] physical page ids (host)
  lengths:            [n_slots] tokens resident per slot (host)

Decode attention over the pools is kernels/paged_attention.py (B6, and
the fused step with B7's write), or, where that kernel's gate fails (long
contexts), paged_attention_tpu below (B21, the library kernel's function)
and its fused step paged_attention_tpu_fused (RoPE, B7's write and the
pre-scale folded into B21's kernel); the one-token write is
kernels/kv_write.py (B7), the bulk admission write B8.

Under data parallelism (dp > 1) the page ids are partitioned over the dp
groups as in the JAX manager: slot s belongs to group s // (n_slots / dp),
allocates only from that group's partition, and every id is local to the
group, with a trash page of its own (the sentinel). Every rank keeps the
whole host allocator (each makes the same decisions); its device pools are
its own group's partition, [H / tp, total_pages / dp + 1, ps, Dh].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import HyperParams, resolve_device
from ..kernels import cuda_lib
from ..kernels.decode_attention import _rope_fma
from ..kernels.kv_write import paged_kv_write_plain, scatter_rows_drop


def paged_attention_reference(q, k_pages, v_pages, lengths, page_indices):
    """Plain f32 reference: gather each sequence's pages and run masked
    attention (no cast to the pool dtype, unlike kernel B6).

    q: [B, H, D]; k_pages/v_pages: [H, P, ps, D]; lengths: [B];
    page_indices: [B, pages_per_seq]. Returns [B, H, D] f32.
    """
    b, h, d = q.shape
    ps = k_pages.shape[2]
    s_max = page_indices.shape[1] * ps
    idx = page_indices.to(torch.int64)

    def gathered(pool):                    # [H, B, pp, ps, D] -> [B, H, S, D]
        return pool[:, idx].permute(1, 0, 2, 3, 4).reshape(
            b, h, s_max, d).to(torch.float32)

    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    scores = torch.einsum("bhd,bhsd->bhs", q.to(torch.float32),
                          gathered(k_pages)) * scale
    mask = (torch.arange(s_max, device=q.device)[None, None, :]
            < lengths.to(torch.int64)[:, None, None])
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    return torch.einsum("bhs,bhsd->bhd", torch.softmax(scores, dim=-1),
                        gathered(v_pages))


# Kernel B21 (csrc/paged_flash.cu) takes these head dims; its grid, rings
# and scratch are the kernel library's own (paged_flash_partial_floats,
# paged_flash_counters)
B21_HEAD_DIMS = (64, 128, 256)
# the library kernel's mask value (its DEFAULT_MASK_VALUE)
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def _check_library_args(q, k_pages, v_pages, lengths, page_indices,
                        pages_per_compute_block):
    """The library kernel's argument checks, with its messages
    (jax.experimental.pallas.ops.tpu.paged_attention.paged_attention)."""
    if q.dim() != 3 or k_pages.dim() != 4 or page_indices.dim() != 2:
        raise ValueError("q must be [batch_size, num_q_heads, head_dim], the "
                         "pages [num_kv_heads, total_num_pages, page_size, "
                         "head_dim] and page_indices [batch_size, "
                         "pages_per_sequence]")
    batch_size, num_q_heads, head_dim = q.shape
    num_kv_heads, _, _, head_dim_k = k_pages.shape
    batch_size_paged_indices, pages_per_sequence = page_indices.shape
    if k_pages.shape != v_pages.shape:
        raise ValueError(
            "k_pages and v_pages must have the same shape. Got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    if num_q_heads % num_kv_heads != 0:
        raise ValueError(
            "Number of Q heads must be divisible by number of KV heads. Got"
            f" {num_q_heads} and {num_kv_heads}.")
    if head_dim_k != head_dim:
        raise ValueError(
            "head_dim of Q must be the same as that of K/V. Got"
            f" {head_dim} and {head_dim_k}.")
    if pages_per_sequence % pages_per_compute_block != 0:
        raise ValueError(
            "pages_per_compute_block must be divisible by pages per "
            f"sequence. Got {pages_per_compute_block} and "
            f"{pages_per_sequence}.")
    if tuple(lengths.shape) != (batch_size,):
        raise ValueError("`lengths` and `q` must have the same batch size")
    if batch_size_paged_indices != batch_size:
        raise ValueError("`page_indices` and `q` must have the same batch "
                         "size")
    if lengths.dtype != torch.int32:
        raise ValueError(
            f"The dtype of `lengths` must be int32. Got {lengths.dtype}")


def _b21_scale(d: int) -> float:
    """f32(1 / sqrt(D)): the JAX wrapper's f64 constant taken to f32."""
    return float(np.float32(1.0 / np.sqrt(d)))


def _prescaled(q):
    """q * (1 / sqrt(D)) in f32, as the JAX wrapper scales it (a bf16 q is
    widened first)."""
    return q.to(torch.float32) * _b21_scale(q.shape[-1])


def paged_attention_tpu_plain(q, k_pages, v_pages, lengths, page_indices):
    """Plain PyTorch version of kernel B21 (the same arguments but the
    compute block, which moves f32 rounding only): the gather-based f32
    attention on the pre-scaled q over K and V rounded to bf16, as the
    library reads them; rows at or past the length (clipped to pp * ps)
    take no part, and a sequence of length 0 gives zeros. Hq may be a
    multiple of Hkv (query head h attends KV head h // (Hq / Hkv))."""
    b, hq, d = q.shape
    hkv, p, ps, _ = k_pages.shape
    g = hq // hkv
    s_max = page_indices.shape[1] * ps
    idx = page_indices.to(torch.int64).clamp(0, p - 1)

    def gathered(pool):                # [Hkv, B, pp, ps, D] -> [B, Hkv, S, D]
        return pool[:, idx].permute(1, 0, 2, 3, 4).reshape(
            b, hkv, s_max, d).to(torch.bfloat16).to(torch.float32)

    mask = (torch.arange(s_max, device=q.device)[None, None, None, :]
            < lengths.to(torch.int64)[:, None, None, None])
    qs = _prescaled(q).reshape(b, hkv, g, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qs, gathered(k_pages))
    scores = torch.where(mask, scores, torch.full_like(scores, MASK_VALUE))
    m = scores.amax(-1, keepdim=True)
    probs = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    denom = probs.sum(-1, keepdim=True)
    vals = torch.where(mask[:, :, 0, :, None], gathered(v_pages), 0.0)
    ctx = torch.einsum("bkgs,bksd->bkgd", probs, vals)
    ctx = torch.where(denom > 0, ctx / denom.clamp_min(1e-30),
                      torch.zeros_like(ctx))
    return ctx.reshape(b, hq, d)


def _b21_launch(name, head, b, hq, hkv, p, ps, pp, d, k_pages, out):
    """One launch of B21 or B21F (`name`); `head` holds the entry's leading
    pointers. The grid and its scratch are sized by the library."""
    dev = k_pages.device
    sms = cuda_lib.sm_count(dev)
    partial = cuda_lib.scratch(
        dev, "paged_flash.partial",
        cuda_lib.fn("paged_flash_partial_floats")(d, sms), torch.float32)
    counters = cuda_lib.tile_counters(
        dev, cuda_lib.fn("paged_flash_counters")(b, hq, hkv))
    rc = cuda_lib.fn(name)(
        *head, b, hq, hkv, p, ps, pp, d, _b21_scale(d),
        int(k_pages.dtype == torch.bfloat16), sms, partial.data_ptr(),
        counters.data_ptr(), out.data_ptr(), cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, name)
    return out


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _check_b21_pools(dev, k_pages, v_pages, tensors, d):
    """What B21 and B21F take on the card beyond the library's checks."""
    _require(dev.type == "cuda" and all(
        t.device == dev and t.is_contiguous() for t in tensors),
        "the pools, lengths, page_indices (and the fused step's inputs) "
        "must be contiguous and on one CUDA device")
    _require(k_pages.dtype in (torch.bfloat16, torch.float32)
             and v_pages.dtype == k_pages.dtype,
             f"B21 takes bf16 or f32 pools, not {k_pages.dtype}")
    _require(d in B21_HEAD_DIMS,
             f"B21 takes head_dim {B21_HEAD_DIMS}, not {d}")


def paged_attention_tpu(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, lengths: torch.Tensor,
                        page_indices: torch.Tensor,
                        pages_per_compute_block: int = 4) -> torch.Tensor:
    """Kernel B21, the port of paged_attention_tpu (the library Pallas TPU
    kernel paged_attention, q pre-scaled by 1/sqrt(D) outside it): q [B, Hq,
    D] f32 or bf16 (on the card any batch stride); pools [Hkv, P, ps, D] bf16 or f32; lengths int32 [B];
    page_indices int32 [B, pages_per_sequence]. Returns f32 [B, Hq, D]
    (the pre-scale makes q f32, and the library returns q's type). Raises
    ValueError where the library raises; on the card also for what B21
    does not take (head dims other than 64, 128 and 256, other pool
    types). The compute block moves f32 rounding only and is checked, not
    used: the kernel splits each sequence over its blocks by pages
    (csrc/paged_flash.cu) and pre-scales q itself; for CPU tensors the
    plain version."""
    _check_library_args(q, k_pages, v_pages, lengths, page_indices,
                        pages_per_compute_block)
    if q.device.type == "cpu":
        return paged_attention_tpu_plain(q, k_pages, v_pages, lengths,
                                         page_indices)
    b, hq, d = q.shape
    hkv, p, ps, _ = k_pages.shape
    _check_b21_pools(q.device, k_pages, v_pages,
                     (k_pages, v_pages, lengths, page_indices), d)
    _require(page_indices.dtype == torch.int32, "page_indices must be int32")
    qf = q.to(torch.float32)
    if (qf.stride(2) != 1 or qf.stride(1) != d or qf.stride(0) % 4
            or qf.data_ptr() % 16):    # its rows are staged by bulk copies
        qf = qf.contiguous()
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    _b21_launch("paged_attention_tpu",
                (qf.data_ptr(), qf.stride(0), k_pages.data_ptr(),
                 v_pages.data_ptr(), lengths.data_ptr(),
                 page_indices.data_ptr()),
                b, hq, hkv, p, ps, page_indices.shape[1], d, k_pages, out)
    paged_attention_tpu.launches += 1
    return out


cuda_lib.counted(paged_attention_tpu)


def _split_qkv(qkv, hkv, d):
    """q [B, Hq, D], k and v [B, Hkv, D] of a fused projection [B, (Hq + 2
    Hkv) D]."""
    b = qkv.shape[0]
    hq = qkv.shape[1] // d - 2 * hkv
    q = qkv[:, :hq * d].reshape(b, hq, d)
    k = qkv[:, hq * d:(hq + hkv) * d].reshape(b, hkv, d)
    v = qkv[:, (hq + hkv) * d:].reshape(b, hkv, d)
    return q, k, v


def paged_attention_tpu_fused_plain(qkv, k_pages, v_pages, lengths,
                                    page_indices, page_ids, offsets, cos,
                                    sin):
    """Plain version of the fused B21 step (same arguments but the compute
    block, same effects): q and k roped in B4's FMA form (the kernel's
    rope_lane, so the written rows agree bit for bit), B7's plain write of
    T(k_rope) and T(v), then B21's plain attention over lengths + 1 keys,
    which pre-scales the roped q and reads the new row back from the
    pools."""
    hkv, _, _, d = k_pages.shape
    q, k, v = _split_qkv(qkv, hkv, d)
    partner = torch.arange(d, device=qkv.device) ^ 1
    c, sn = cos[:, None, :], sin[:, None, :]
    qr, kr = (_rope_fma(t, t[..., partner], c, sn) for t in (q, k))
    paged_kv_write_plain(k_pages, v_pages, kr, v, page_ids, offsets)
    return paged_attention_tpu_plain(qr, k_pages, v_pages, lengths + 1,
                                     page_indices)


def paged_attention_tpu_fused(qkv: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, lengths: torch.Tensor,
                              page_indices: torch.Tensor,
                              page_ids: torch.Tensor, offsets: torch.Tensor,
                              cos: torch.Tensor, sin: torch.Tensor,
                              pages_per_compute_block: int = 4
                              ) -> torch.Tensor:
    """The fused B21 step (B21F): one paged decode step of one layer on the
    library kernel's route, RoPE, B7's write, the pre-scale and B21 in one
    launch. qkv f32 [B, (Hq + 2 Hkv) D] the raw fused projection (q heads,
    then k, then v); pools [Hkv, P, ps, D] bf16 or f32, updated in place at
    (page_ids[b], offsets[b]) (int32 [B]; B7's rules: the sentinel's trash
    page, nothing written outside the pool); lengths int32 [B] the
    resident rows (the new token's position); page_indices int32 [B, pp];
    cos/sin f32 [B, D] the per-row RoPE lanes. Raises B21's ValueErrors
    (the library's, for q [B, Hq, D]). Returns ctx f32 [B, Hq, D], B21's
    function over lengths + 1 keys; for CPU tensors the plain version."""
    b = qkv.shape[0]
    _require(k_pages.dim() == 4, "pools must be [Hkv, P, ps, D]")
    hkv, p, ps, d = k_pages.shape
    f = qkv.shape[1] if qkv.dim() == 2 else 0
    _require(qkv.dim() == 2 and qkv.dtype == torch.float32
             and f % d == 0 and f // d > 2 * hkv
             and (f // d - 2 * hkv) % hkv == 0,
             f"qkv must be f32 [B, (Hq + 2 * {hkv}) * {d}], Hq a multiple "
             f"of {hkv}: got {tuple(qkv.shape)} {qkv.dtype}")
    _require(cos.shape == (b, d) and sin.shape == (b, d)
             and cos.dtype == torch.float32 and sin.dtype == torch.float32,
             f"cos/sin must be f32 [B, {d}]")
    _require(page_ids.shape == (b,) and offsets.shape == (b,)
             and page_ids.dtype == torch.int32
             and offsets.dtype == torch.int32,
             "page_ids and offsets must be int32 [B]")
    hq = f // d - 2 * hkv
    _check_library_args(qkv[:, :hq * d].view(b, hq, d), k_pages, v_pages,
                        lengths, page_indices, pages_per_compute_block)
    if qkv.device.type == "cpu":
        return paged_attention_tpu_fused_plain(
            qkv, k_pages, v_pages, lengths, page_indices, page_ids, offsets,
            cos, sin)
    _check_b21_pools(qkv.device, k_pages, v_pages,
                     (qkv, k_pages, v_pages, lengths, page_indices, page_ids,
                      offsets, cos, sin), d)
    _require(page_indices.dtype == torch.int32, "page_indices must be int32")
    # qkv's and the lanes' rows are staged by bulk copies: 16-byte aligned
    qkv, cos, sin = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (qkv, cos, sin))
    out = torch.empty((b, hq, d), dtype=torch.float32, device=qkv.device)
    _b21_launch("paged_attention_tpu_fused",
                (qkv.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 lengths.data_ptr(), page_indices.data_ptr(),
                 page_ids.data_ptr(), offsets.data_ptr(), cos.data_ptr(),
                 sin.data_ptr()),
                b, hq, hkv, p, ps, page_indices.shape[1], d, k_pages, out)
    paged_attention_tpu_fused.launches += 1
    return out


cuda_lib.counted(paged_attention_tpu_fused)


def write_tokens_paged(k_pages, v_pages, k_new, v_new, page_ids, offsets):
    """Scatter new K/V vectors into their pages, IN PLACE; returns the pools.

    k_new/v_new: [B, T, H, D]; page_ids/offsets: [B, T] physical page id and
    in-page offset per written token (from the manager; an entry whose page
    id is >= the pool's page count is dropped: inactive slots, padding).
    """
    h, p, ps, d = k_pages.shape
    pid = page_ids.reshape(-1).to(torch.int64)
    off = offsets.reshape(-1).to(torch.int64)
    ok = (pid >= 0) & (pid < p)
    flat = pid * ps + off
    n = pid.shape[0]
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        scatter_rows_drop(pool.view(h, p * ps, d), flat, ok,
                          new.reshape(n, h, d).transpose(0, 1))
    return k_pages, v_pages


@dataclasses.dataclass
class PagedKVManager:
    """Host-side page allocator + device page pools (per layer).

    The pools have one page more than the group's pages: the trash page,
    whose id is the `sentinel`. Inactive slots and padded rows write there,
    so the in-place write kernels need no predicate for them. It is never
    allocated and never in a page table. dp > 1 partitions the ids over the
    data-parallel groups (module docstring); `group` is the group whose
    pools this process holds and `tp` divides their heads.
    """
    hp: HyperParams
    n_slots: int
    page_size: int
    total_pages: int
    pages_per_seq: int
    dtype: torch.dtype = torch.bfloat16
    device: object = None
    dp: int = 1
    group: int = 0
    tp: int = 1

    def __post_init__(self):
        h, d = self.hp.n_head // self.tp, self.hp.head_dim
        if self.total_pages % self.dp or self.n_slots % self.dp:
            raise ValueError(
                f"total_pages={self.total_pages} and n_slots={self.n_slots} "
                f"must divide dp={self.dp}")
        self.device = resolve_device(self.device)
        # pages of one dp group; also its local trash-page id
        self.local_pages = self.total_pages // self.dp
        shape = (h, self.local_pages + 1, self.page_size, d)
        self.k_pages = [torch.zeros(shape, dtype=self.dtype,
                                    device=self.device)
                        for _ in range(self.hp.n_layer)]
        self.v_pages = [torch.zeros(shape, dtype=self.dtype,
                                    device=self.device)
                        for _ in range(self.hp.n_layer)]
        self._free = [list(range(self.local_pages - 1, -1, -1))
                      for _ in range(self.dp)]
        # page table per slot, in group-local ids (unset entries read
        # page-0 garbage but are length-masked)
        self.page_tables = np.zeros((self.n_slots, self.pages_per_seq),
                                    np.int32)
        self._owned: list[list[int]] = [[] for _ in range(self.n_slots)]
        self.lengths = np.zeros(self.n_slots, np.int32)

    @property
    def sentinel(self) -> int:
        """The trash-page id (local to every dp group)."""
        return self.local_pages

    def group_of(self, slot: int) -> int:
        return slot // (self.n_slots // self.dp)

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def free_pages_by_group(self) -> list[int]:
        return [len(f) for f in self._free]

    def alloc_for(self, slot: int, new_len: int) -> bool:
        """Ensure slot has pages covering new_len tokens, from its dp
        group's partition. Atomic: when the partition is short nothing is
        allocated and False is returned."""
        need = -(-new_len // self.page_size)
        if need > self.pages_per_seq:
            return False
        free = self._free[self.group_of(slot)]
        have = len(self._owned[slot])
        if need - have > len(free):
            return False
        while have < need:
            pid = free.pop()
            self.page_tables[slot, have] = pid
            self._owned[slot].append(pid)
            have += 1
        return True

    def free_slot(self, slot: int) -> None:
        self._free[self.group_of(slot)].extend(reversed(self._owned[slot]))
        self._owned[slot] = []
        self.page_tables[slot, :] = 0
        self.lengths[slot] = 0

    def token_page_offsets(self, slot: int, start: int, count: int):
        """(page_ids, offsets) arrays [count] for tokens [start, start+count).
        Caller must have alloc_for'ed through start+count."""
        pos = np.arange(start, start + count)
        page_ids = self.page_tables[slot, pos // self.page_size]
        offsets = (pos % self.page_size).astype(np.int32)
        return page_ids.astype(np.int32), offsets

    def load_from_numpy(self, k_pages, v_pages, page_tables, lengths) -> None:
        """Fill the pools and the tables from numpy arrays in the JAX
        manager's layout (per layer [H, total_pages + 1, ps, Dh]; tables
        [n_slots, pages_per_seq]; lengths [n_slots]), so a state built by
        the JAX package carries across. The allocator is rebuilt from the
        tables: slot s owns the first ceil(lengths[s] / ps) of its entries.
        One dp group only."""
        if self.dp != 1:
            raise ValueError("load_from_numpy takes a manager with dp=1")
        for dst, src in ((self.k_pages, k_pages), (self.v_pages, v_pages)):
            for pool, a in zip(dst, src):
                pool.copy_(torch.from_numpy(
                    np.array(a, np.float32)).to(self.dtype))
        self.page_tables[:] = np.asarray(page_tables, np.int32)
        self.lengths[:] = np.asarray(lengths, np.int32)
        self._owned = [
            [int(x) for x in self.page_tables[s, :-(-int(n) // self.page_size)]]
            for s, n in enumerate(self.lengths)]
        used = {pid for owned in self._owned for pid in owned}
        self._free = [[pid for pid in range(self.total_pages - 1, -1, -1)
                       if pid not in used]]
