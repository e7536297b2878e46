"""Paged decode attention: kernels B6 and B11 and their plain versions.

B6 ports fastllama_tpu/kernels/paged_attention.py::paged_decode_attention:
one decode step's attention for one layer over the page pools,

    ctx[b, h] = softmax(q[b, h] . K[b, h, :len] / sqrt(D)) @ V[b, h, :len]

where sequence b's keys live in the pages page_indices[b, 0 .. ceil(len/ps))
of the pools [H, P, ps, D] and len = lengths[b] counts the token written just
before (kernels/kv_write.py runs first). The numerical contract is the TPU
kernel's: q and the probabilities are cast to the pool dtype before the two
dots, scores, softmax and accumulation are f32, a masked probability is
exactly 0 and the denominator is max(sum p, 1e-30), so a sequence of length
0 yields zeros. Pages past ceil(len/ps) are never read. On the card the
keys are split: the pp * ps rows of a sequence are cut into chunks of whole
pages (b6_plan, from the shapes alone), each block attends one chunk of one
head with its own p = exp(score - chunk max) cast to the pool dtype, and the
last block of a head merges the partial softmaxes in chunk order.

B11 ports fastllama_tpu/kernels/paged_attention.py::
paged_decode_attention_flat: the same contract over flat-lane pools
[P, ps, H*D] (a page row holds every head side by side, as the slab cache
does). No dispatch of the JAX package reaches it: it is the record of a
round-5 layout experiment on the TPU, ported so that every TPU kernel has its
counterpart. On the card it runs B6's kernel with B11's strides.

paged_decode_step_fused is one decode step of one layer over the pools in
one launch: RoPE on q and the new k, B7's write of the new row
(kernels/kv_write.py) and B6's attention over lengths + 1 keys, in the
JAX paged step's order. On the card it is B6's kernel with FUSED: the
chunks attend the resident rows as B6's do, the new token is one more
partial folded in rounded to the pool dtype (as B6 would read it back), and
the block that finishes a head writes the row. The forward takes it for a
layer without q/k/v LoRA terms; B7 and B6 stay the LoRA step's.

The CUDA kernels are in csrc/paged_attention.cu; each wrapper launches its
kernel for CUDA tensors and runs its plain version for CPU tensors.
"""
from __future__ import annotations

import functools
import math

import torch

from . import cuda_lib
from .decode_attention import _rope_fma
from .kv_write import paged_kv_write_plain


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def paged_decode_attention_plain(q, k_pages, v_pages, lengths, page_indices):
    """Plain PyTorch version of kernel B6 (same arguments and result): gather
    each sequence's pages, then the kernel's masked softmax with its casts.
    Rows at or past the length are masked out of both dots, so whatever the
    unused table entries point at never reaches the output."""
    b, h, d = q.shape
    _, p, ps, _ = k_pages.shape
    pp = page_indices.shape[1]
    s_max = pp * ps
    kd = k_pages.dtype
    idx = page_indices.to(torch.int64).clamp(0, p - 1)

    def gathered(pool):                    # [H, B, pp, ps, D] -> [B, H, S, D]
        return pool[:, idx].permute(1, 0, 2, 3, 4).reshape(
            b, h, s_max, d).to(torch.float32)

    mask = (torch.arange(s_max, device=q.device)[None, None, :]
            < lengths.to(torch.int64)[:, None, None])
    scores = torch.einsum("bhd,bhsd->bhs", q.to(kd).to(torch.float32),
                          gathered(k_pages)) * (1.0 / math.sqrt(d))
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    m = scores.amax(-1, keepdim=True)
    probs = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    denom = probs.sum(-1, keepdim=True).clamp_min(1e-30)
    vals = torch.where(mask[..., None], gathered(v_pages), 0.0)
    ctx = torch.einsum("bhs,bhsd->bhd", probs.to(kd).to(torch.float32), vals)
    return ctx / denom


def _check_args(q, k_pages, v_pages, lengths, page_indices, flat: bool):
    """Checks shared by B6 and B11: (P, ps) of the pools."""
    b, h, d = q.shape
    _require(q.dtype == torch.float32, "q must be f32 [B, H, D]")
    want = "[P, ps, H*D]" if flat else f"[{h}, P, ps, {d}]"
    shaped = (k_pages.dim() == 3 and k_pages.shape[2] == h * d) if flat else (
        k_pages.dim() == 4 and k_pages.shape[0] == h
        and k_pages.shape[3] == d)
    _require(shaped and v_pages.shape == k_pages.shape
             and v_pages.dtype == k_pages.dtype
             and k_pages.dtype in (torch.bfloat16, torch.float32),
             f"pools must match, bf16 or f32 {want}: got "
             f"{tuple(k_pages.shape)} {k_pages.dtype}")
    _require(lengths.shape == (b,) and lengths.dtype == torch.int32,
             "lengths must be int32 [B]")
    _require(page_indices.dim() == 2 and page_indices.shape[0] == b
             and page_indices.dtype == torch.int32,
             "page_indices must be int32 [B, pages_per_seq]")
    return tuple(k_pages.shape[:2] if flat else k_pages.shape[1:3])


# B6's and B11's split (see csrc/paged_attention.cu): chunks of at least
# B6_CHUNK rows where the pages allow (a chunk is a multiple of the page
# size or a divisor of it), K and V of a chunk staged at once within
# B6_SMEM_CAP bytes. tools_torch/paged_chunk_sweep.py times the others.
B6_CHUNK = 64
B6_MAX_CHUNK = 256
B6_SMEM_CAP = 96 * 1024


@functools.lru_cache(maxsize=None)
def b6_plan(pp: int, ps: int, d: int, itemsize: int) -> tuple[int, int]:
    """(splits, chunk) of B6's and B11's grid for pp pages of ps rows, head
    dim d and pool elements of `itemsize` bytes: the smallest chunk of at
    least B6_CHUNK rows (or the largest there is). From the shapes alone,
    so the host never reads the lengths; chunk i takes rows [i * chunk,
    (i + 1) * chunk)."""
    s = pp * ps
    cands = [c for c in range(1, min(B6_MAX_CHUNK, s) + 1)
             if (c % ps == 0 or ps % c == 0)
             and 2 * c * d * itemsize <= B6_SMEM_CAP]
    chunk = next((c for c in cands if c >= B6_CHUNK), cands[-1])
    return -(-s // chunk), chunk


def _launch(name, q, k_pages, v_pages, lengths, page_indices, p, ps,
            chunk=None, fused=()):
    """One launch of B6, B11 or the fused step (`name`); `chunk` overrides
    the plan's rows per block (tools_torch/paged_chunk_sweep.py); `fused`
    holds the fused step's (qkv, page_ids, offsets, cos, sin), q then only
    gives the shapes."""
    b, h, d = q.shape
    pp = page_indices.shape[1]
    tensors = (k_pages, v_pages, lengths, page_indices, *fused)
    _require(q.device.type == "cuda" and q.stride(2) == 1
             and all(t.device == q.device and t.is_contiguous()
                     for t in tensors),
             "the pools, lengths, tables (and the fused step's inputs) must "
             "be contiguous and q unit stride along D, all on one CUDA "
             "device")
    _require(d % 32 == 0 and d <= 256 and pp * ps <= 12288,
             "head_dim must be a multiple of 32 and <= 256 and "
             f"pages_per_seq * page_size <= 12288: got D = {d}, "
             f"{pp} x {ps}")
    dev = q.device
    if chunk is None:
        splits, chunk = b6_plan(pp, ps, d, k_pages.element_size())
    else:
        splits = -(-(pp * ps) // chunk)
    partial = cuda_lib.scratch(dev, "paged_attention.partial",
                               b * h * splits * (d + 2), torch.float32)
    counters = cuda_lib.tile_counters(dev, b * h)
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    head = ((q.data_ptr(), q.stride(0), q.stride(1), k_pages.data_ptr(),
             v_pages.data_ptr(), lengths.data_ptr(), page_indices.data_ptr())
            if not fused else
            (fused[0].data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             lengths.data_ptr(), page_indices.data_ptr(),
             *(t.data_ptr() for t in fused[1:])))
    rc = cuda_lib.fn(name)(
        *head, b, h, p, ps, pp, d, splits, chunk, 1.0 / math.sqrt(d),
        int(k_pages.dtype == torch.bfloat16), partial.data_ptr(),
        counters.data_ptr(), out.data_ptr(), cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, name)
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, lengths: torch.Tensor,
                           page_indices: torch.Tensor) -> torch.Tensor:
    """Kernel B6. q f32 [B, H, D] after RoPE (any batch and head strides,
    unit stride along D); pools [H, P, ps, D] bf16 or f32 holding the
    current token's row; lengths int32 [B], the number of
    keys to attend (clipped to pp * ps); page_indices int32 [B, pp].
    Returns ctx f32 [B, H, D]."""
    p, ps = _check_args(q, k_pages, v_pages, lengths, page_indices, False)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, lengths,
                                            page_indices)
    out = _launch("paged_decode_attention", q, k_pages, v_pages, lengths,
                  page_indices, p, ps)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# The fused paged step: RoPE + B7's write + B6's attention in one launch
# ---------------------------------------------------------------------------

def paged_decode_step_fused_plain(qkv, k_pages, v_pages, lengths,
                                  page_indices, page_ids, offsets, cos, sin):
    """Plain version of the fused step (same arguments and effects): the
    composition of today's plain versions. q and k roped in B4's FMA form
    (the kernel's rope_lane, so the written rows agree bit for bit), B7's
    plain write of T(k_rope) and T(v), then B6's plain attention over
    lengths + 1 keys, which reads the new row back from the pools."""
    b = qkv.shape[0]
    h, _, _, d = k_pages.shape
    f = h * d
    q, k, v = (qkv[:, i * f:(i + 1) * f].reshape(b, h, d) for i in range(3))
    partner = torch.arange(d, device=qkv.device) ^ 1
    c, sn = cos[:, None, :], sin[:, None, :]
    qr, kr = (_rope_fma(t, t[..., partner], c, sn) for t in (q, k))
    paged_kv_write_plain(k_pages, v_pages, kr, v, page_ids, offsets)
    return paged_decode_attention_plain(qr, k_pages, v_pages, lengths + 1,
                                        page_indices)


def paged_decode_step_fused(qkv: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, lengths: torch.Tensor,
                            page_indices: torch.Tensor,
                            page_ids: torch.Tensor, offsets: torch.Tensor,
                            cos: torch.Tensor, sin: torch.Tensor
                            ) -> torch.Tensor:
    """One paged decode step of one layer (B7's write folded into B6's
    kernel with RoPE). qkv f32 [B, 3*H*D] the raw fused projection; pools
    [H, P, ps, D] bf16 or f32, updated in place at (page_ids[b],
    offsets[b]) (int32 [B]; B7's rules: the sentinel's trash page, nothing
    written outside the pool); lengths int32 [B] the resident rows (the new
    token's position); page_indices int32 [B, pp]; cos/sin f32 [B, D] the
    per-row RoPE lanes (n_rot is in them). The scale is B6's, 1/sqrt(D).
    Returns ctx f32 [B, H, D]."""
    b = qkv.shape[0]
    _require(k_pages.dim() == 4, "pools must be [H, P, ps, D]")
    h, _, _, d = k_pages.shape
    _require(qkv.shape == (b, 3 * h * d) and qkv.dtype == torch.float32,
             f"qkv must be f32 [B, {3 * h * d}]")
    _require(cos.shape == (b, d) and sin.shape == (b, d)
             and cos.dtype == torch.float32 and sin.dtype == torch.float32,
             f"cos/sin must be f32 [B, {d}]")
    _require(page_ids.shape == (b,) and offsets.shape == (b,)
             and page_ids.dtype == torch.int32
             and offsets.dtype == torch.int32,
             "page_ids and offsets must be int32 [B]")
    q_shape = qkv[:, :h * d].view(b, h, d)
    p, ps = _check_args(q_shape, k_pages, v_pages, lengths, page_indices,
                        False)
    if qkv.device.type == "cpu":
        return paged_decode_step_fused_plain(qkv, k_pages, v_pages, lengths,
                                             page_indices, page_ids, offsets,
                                             cos, sin)
    out = _launch("paged_decode_step_fused", q_shape, k_pages, v_pages,
                  lengths, page_indices, p, ps,
                  fused=(qkv, page_ids, offsets, cos, sin))
    paged_decode_step_fused.launches += 1
    return out


paged_decode_step_fused.launches = 0


# ---------------------------------------------------------------------------
# B11: flat-lane pools
# ---------------------------------------------------------------------------

def head_major(pool: torch.Tensor, n_head: int) -> torch.Tensor:
    """A flat-lane pool [P, ps, H*D] as the head-major [H, P, ps, D] view
    (no copy)."""
    p, ps, f = pool.shape
    return pool.view(p, ps, n_head, f // n_head).permute(2, 0, 1, 3)


def paged_decode_attention_flat_plain(q, k_pages, v_pages, lengths,
                                      page_indices):
    """Plain PyTorch version of kernel B11: B6's plain version over a
    head-major copy of the flat-lane pools (a copy, so that the sums run in
    the same order as B6's and the two agree bit for bit)."""
    h = q.shape[1]
    return paged_decode_attention_plain(
        q, head_major(k_pages, h).contiguous(),
        head_major(v_pages, h).contiguous(), lengths, page_indices)


def paged_decode_attention_flat(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, lengths: torch.Tensor,
                                page_indices: torch.Tensor) -> torch.Tensor:
    """Kernel B11: B6's contract over flat-lane pools [P, ps, H*D] bf16 or
    f32. q f32 [B, H, D], lengths int32 [B], page_indices int32 [B, pp].
    Returns ctx f32 [B, H, D]."""
    p, ps = _check_args(q, k_pages, v_pages, lengths, page_indices, True)
    if q.device.type == "cpu":
        return paged_decode_attention_flat_plain(q, k_pages, v_pages,
                                                 lengths, page_indices)
    out = _launch("paged_decode_attention_flat", q, k_pages, v_pages, lengths,
                  page_indices, p, ps)
    paged_decode_attention_flat.launches += 1
    return out


paged_decode_attention_flat.launches = 0
