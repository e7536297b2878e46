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

Decode attention over the pools is kernels/paged_attention.py (B6), the
one-token write kernels/kv_write.py (B7), the bulk admission write B8.

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
from ..kernels.kv_write import scatter_rows_drop


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
