"""In-place writes into the paged KV pools: kernels B7 and B8 and their plain
versions.

B7 ports fastllama_tpu/kernels/kv_write.py::paged_kv_write: one decode step
writes one token's K and V vectors per sequence into the pools
[H, P, ps, D] at (page_ids[b], offsets[b]), casting to the pool dtype. An
inactive slot carries the manager's sentinel id, the last page of the pool
(the trash page, never in a page table), so its write lands harmlessly; an
id outside the pool writes nothing. The model's paged decode step folds this
write into its fused kernels (kernels/paged_attention.paged_decode_step_fused,
engine/paged_kv.paged_attention_tpu_fused) on every layer; B7 stays a public
entry point.

B8 ports paged_kv_write_rows of the same file: a finished prompt's flat rows
[T, H*D] (T a multiple of ps, positions 0..T-1 of a fresh sequence) become
whole pages [H, ps, D], a head-major transpose, at page_ids[T / ps].

Both update the pools IN PLACE and return them. The CUDA kernels are in
csrc/kv_write.cu; each wrapper launches its kernel for CUDA tensors and runs
its plain version for CPU tensors.

slab_write_rows (in the same source; no TPU kernel's port) is the slab
caches' row write at a position held on the device: the forward's K/V write
when n_past is a tensor (the engine's per-slot depths, every captured
window and step), T rows a sequence at n_past[b] + t, rows outside the
cache dropped, as the JAX forward's scatter with mode="drop".
"""
from __future__ import annotations

import torch

from . import cuda_lib

_DTYPES = (torch.bfloat16, torch.float32)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def scatter_rows_drop(pool: torch.Tensor, target: torch.Tensor,
                      ok: torch.Tensor, values: torch.Tensor) -> None:
    """pool[:, target[j]] = values[:, j] for every j with ok[j], in place;
    entries with ok[j] false are dropped. pool [H, R, ...], target [N] int64,
    ok [N] bool, values [H, N, ...].

    PyTorch's indexed write has no drop mode, and a boolean selection would
    read the mask on the host. A dropped entry instead repeats the first
    kept entry (same row, same values: a duplicate write of identical data);
    when nothing is kept every entry rewrites row 0 with what it holds."""
    n = target.shape[0]
    if n == 0:
        return
    # index_select, not values[:, first]: indexing with a 0-dim tensor would
    # read it on the host
    first = torch.argmax(ok.to(torch.int8)).reshape(1)  # 0 when none is kept
    any_ok = ok.any()
    fb_target = torch.where(any_ok, target.index_select(0, first), 0)
    fb_values = torch.where(any_ok, values.index_select(1, first),
                            pool[:, :1].to(values.dtype))
    tgt = torch.where(ok, target, fb_target)
    shape = (1, n) + (1,) * (values.dim() - 2)
    vals = torch.where(ok.reshape(shape), values, fb_values)
    pool[:, tgt] = vals.to(pool.dtype)


def _check_pools(k_pages, v_pages):
    _require(k_pages.dim() == 4 and v_pages.shape == k_pages.shape
             and v_pages.dtype == k_pages.dtype and k_pages.dtype in _DTYPES,
             "pools must match, bf16 or f32 [H, P, ps, D]: got "
             f"{tuple(k_pages.shape)} {k_pages.dtype} / "
             f"{tuple(v_pages.shape)} {v_pages.dtype}")


def _on_one_cuda_device(tensors) -> bool:
    dev = tensors[0].device
    return dev.type == "cuda" and all(
        t.device == dev and t.is_contiguous() for t in tensors)


# ---------------------------------------------------------------------------
# B7: one token per sequence
# ---------------------------------------------------------------------------

def paged_kv_write_plain(k_pages, v_pages, k_new, v_new, page_ids, offsets):
    """Plain PyTorch version of kernel B7 (same arguments and effects)."""
    h, p, ps, d = k_pages.shape
    pid, off = page_ids.to(torch.int64), offsets.to(torch.int64)
    ok = (pid >= 0) & (pid < p) & (off >= 0) & (off < ps)
    flat = pid * ps + off
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        scatter_rows_drop(pool.view(h, p * ps, d), flat, ok,
                          new.transpose(0, 1))
    return k_pages, v_pages


def paged_kv_write(k_pages: torch.Tensor, v_pages: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   page_ids: torch.Tensor, offsets: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B7. Pools [H, P, ps, D] bf16 or f32, updated in place; k_new
    and v_new f32 [B, H, D]; page_ids and offsets int32 [B]. A page id
    outside [0, P) or an offset outside [0, ps) writes nothing. Returns the
    pools."""
    _check_pools(k_pages, v_pages)
    h, p, ps, d = k_pages.shape
    b = k_new.shape[0]
    _require(k_new.shape == (b, h, d) and v_new.shape == (b, h, d)
             and k_new.dtype == torch.float32
             and v_new.dtype == torch.float32,
             f"k_new/v_new must be f32 [B, {h}, {d}]: got "
             f"{tuple(k_new.shape)} {k_new.dtype}")
    _require(page_ids.shape == (b,) and offsets.shape == (b,)
             and page_ids.dtype == torch.int32
             and offsets.dtype == torch.int32,
             "page_ids and offsets must be int32 [B]")
    if k_pages.device.type == "cpu":
        return paged_kv_write_plain(k_pages, v_pages, k_new, v_new, page_ids,
                                    offsets)
    tensors = (k_pages, v_pages, k_new, v_new, page_ids, offsets)
    _require(_on_one_cuda_device(tensors),
             "all tensors must be contiguous on one CUDA device")
    rc = cuda_lib.fn("paged_kv_write")(
        k_pages.data_ptr(), v_pages.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), page_ids.data_ptr(), offsets.data_ptr(), b, h, p,
        ps, d, int(k_pages.dtype == torch.bfloat16),
        cuda_lib.stream_handle(k_pages.device))
    cuda_lib.check(rc, "paged_kv_write")
    paged_kv_write.launches += 1
    return k_pages, v_pages


cuda_lib.counted(paged_kv_write)


# ---------------------------------------------------------------------------
# B8: whole pages from flat rows
# ---------------------------------------------------------------------------

def paged_kv_write_rows_plain(k_pages, v_pages, k_rows, v_rows, page_ids):
    """Plain PyTorch version of kernel B8 (same arguments and effects)."""
    h, p, ps, d = k_pages.shape
    n = page_ids.shape[0]
    pid = page_ids.to(torch.int64)
    ok = (pid >= 0) & (pid < p)
    for pool, rows in ((k_pages, k_rows), (v_pages, v_rows)):
        blocks = rows.reshape(n, ps, h, d).permute(2, 0, 1, 3)  # [H, n, ps, D]
        scatter_rows_drop(pool, pid, ok, blocks)
    return k_pages, v_pages


def paged_kv_write_rows(k_pages: torch.Tensor, v_pages: torch.Tensor,
                        k_rows: torch.Tensor, v_rows: torch.Tensor,
                        page_ids: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B8. Pools [H, P, ps, D] bf16 or f32, updated in place; k_rows
    and v_rows [T, H*D] of the pool dtype, T a multiple of ps; page_ids
    int32 [T / ps], one target page per block of ps rows, each written
    whole. A page id outside [0, P) writes nothing. Returns the pools."""
    _check_pools(k_pages, v_pages)
    h, p, ps, d = k_pages.shape
    t = k_rows.shape[0]
    _require(k_rows.shape == (t, h * d) and v_rows.shape == (t, h * d)
             and k_rows.dtype == k_pages.dtype
             and v_rows.dtype == k_pages.dtype,
             f"k_rows/v_rows must be {k_pages.dtype} [T, {h * d}]: got "
             f"{tuple(k_rows.shape)} {k_rows.dtype}")
    _require(t % ps == 0 and page_ids.shape == (t // ps,)
             and page_ids.dtype == torch.int32,
             f"T = {t} must be a multiple of the page size {ps} and "
             "page_ids int32 [T / ps]")
    if k_pages.device.type == "cpu":
        return paged_kv_write_rows_plain(k_pages, v_pages, k_rows, v_rows,
                                         page_ids)
    tensors = (k_pages, v_pages, k_rows, v_rows, page_ids)
    _require(_on_one_cuda_device(tensors),
             "all tensors must be contiguous on one CUDA device")
    itemsize = k_pages.dtype.itemsize
    _require((d * itemsize) % 16 == 0 and all(
        x.data_ptr() % 16 == 0 for x in tensors[:4]),
        f"head rows must be 16-byte multiples and aligned: D = {d}, "
        f"{k_pages.dtype}")
    if t:
        rc = cuda_lib.fn("paged_kv_write_rows")(
            k_pages.data_ptr(), v_pages.data_ptr(), k_rows.data_ptr(),
            v_rows.data_ptr(), page_ids.data_ptr(), t // ps, h, p, ps,
            d * itemsize, cuda_lib.stream_handle(k_pages.device))
        cuda_lib.check(rc, "paged_kv_write_rows")
        paged_kv_write_rows.launches += 1
    return k_pages, v_pages


cuda_lib.counted(paged_kv_write_rows)


# ---------------------------------------------------------------------------
# The slab row write at a device offset
# ---------------------------------------------------------------------------

def slab_write_rows_plain(cache, rows, n_past):
    """Plain PyTorch version of slab_write_rows (same arguments and
    effects): the general dropping scatter over the flat cache."""
    b, s, f = cache.shape
    t = rows.shape[1]
    pos = (n_past.to(torch.int64)[:, None]
           + torch.arange(t, device=cache.device)[None, :])
    ok = ((pos >= 0) & (pos < s)).reshape(-1)
    flat = (pos + torch.arange(b, device=cache.device)[:, None] * s
            ).reshape(-1)
    scatter_rows_drop(cache.view(1, b * s, f), flat, ok,
                      rows.reshape(1, b * t, f))
    return cache


def slab_write_rows(cache: torch.Tensor, rows: torch.Tensor,
                    n_past: torch.Tensor) -> torch.Tensor:
    """cache[b, n_past[b] + t] = rows[b, t] in place, for each position in
    [0, S); a row whose position is outside is not written. cache
    [B, S, F] contiguous; rows [B, T, F] of the cache's dtype, each row
    contiguous (a strided view of q/k/v is taken as it is); n_past int32
    [B]. On the card the rows, their strides and both base addresses are
    16-byte multiples (the kernel copies 16-byte vectors). One launch,
    whatever drops. Returns the cache."""
    b, s, f = cache.shape
    t = rows.shape[1]
    _require(rows.dim() == 3 and rows.shape[0] == b and rows.shape[2] == f
             and rows.dtype == cache.dtype,
             f"rows must be {cache.dtype} [{b}, T, {f}]: got "
             f"{tuple(rows.shape)} {rows.dtype}")
    _require(n_past.shape == (b,) and n_past.dtype == torch.int32,
             f"n_past must be int32 [{b}]: got {tuple(n_past.shape)} "
             f"{n_past.dtype}")
    if cache.device.type == "cpu":
        return slab_write_rows_plain(cache, rows, n_past)
    _require(_on_one_cuda_device((cache, n_past))
             and rows.device == cache.device and rows.stride(2) == 1,
             "cache and n_past contiguous, rows with contiguous rows, all on "
             "one CUDA device")
    item = cache.dtype.itemsize
    sizes = (f * item, rows.stride(0) * item, rows.stride(1) * item,
             rows.data_ptr(), cache.data_ptr())
    _require(all(x % 16 == 0 for x in sizes),
             f"rows, their strides and both base addresses must be 16-byte "
             f"multiples: got {sizes}")
    rc = cuda_lib.fn("slab_write_rows")(
        cache.data_ptr(), rows.data_ptr(), n_past.data_ptr(), b, s, t,
        f * item, rows.stride(0) * item, rows.stride(1) * item,
        cuda_lib.stream_handle(cache.device))
    cuda_lib.check(rc, "slab_write_rows")
    slab_write_rows.launches += 1
    return cache


cuda_lib.counted(slab_write_rows)
