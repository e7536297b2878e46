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
0 yields zeros. Pages past ceil(len/ps) are never read. On the card it
runs the split kernel of csrc/attn_split.cuh (B4's and B10's): a thread
block cluster a (b, h) divides the live rows on the device
(decode_attention.split_rows; attn_plan from the shapes alone), each block
takes its rows page by page by bulk copies and rounds its own p = exp(score -
block max) to the pool dtype, and the cluster's leader merges the partial
softmaxes in rank order.

B11 ports fastllama_tpu/kernels/paged_attention.py::
paged_decode_attention_flat: the same contract over flat-lane pools
[P, ps, H*D] (a page row holds every head side by side, as the slab cache
does). No dispatch of the JAX package reaches it: it is the record of a
round-5 layout experiment on the TPU, ported so that every TPU kernel has its
counterpart. On the card it runs B6's kernel and plan with B11's strides.

paged_decode_step_fused is one decode step of one layer over the pools in
one launch: RoPE on q and the new k, B7's write of the new row
(kernels/kv_write.py) and B6's attention over lengths + 1 keys, in the
JAX paged step's order. On the card it is B6's kernel in its fused mode:
the cluster attends the resident rows as B6's does, the new token is one
more partial folded in rounded to the pool dtype (as B6 would read it back),
and the cluster's leader writes the row. The forward takes it for every
layer, a layer's q/k/v LoRA terms added into its qkv first; B6 (and B7)
stay public entry points that no model path takes.

The CUDA kernels are in csrc/paged_attention.cu; each wrapper launches its
kernel for CUDA tensors and runs its plain version for CPU tensors.

paged_attn_group and paged_attn_supported are the JAX package's gate
between its own kernel and the library kernel (B21,
engine/paged_kv.paged_attention_tpu), which its engine takes on the pools
the gate refuses; the port's engine makes the same choice from the same
shapes (engine/scheduler.paged_attn_route).
"""
from __future__ import annotations

import math

import torch

from . import cuda_lib
from .decode_attention import AttnPlan, _aligned, _rope_fma, attn_plan
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


# The JAX kernel's VMEM budget for its K+V windows, and the library kernel's
# budget for one compute block, with the JAX values (fastllama_tpu/kernels/
# paged_attention.py:_VMEM_BUDGET; fastllama_tpu/engine/scheduler.py, the
# ppcb cap): TPU memory sizes, kept because they decide which function the
# engine computes on a pool.
_VMEM_BUDGET = 12 << 20
_PPCB_BUDGET = 1 << 21


def paged_attn_group(h: int, pp: int, ps: int, d: int, itemsize: int,
                     banks: int = 1):
    """Heads per grid cell of the JAX kernel: the largest divisor of h
    whose K+V windows (banks x [g, pp*ps, d] each) fit the budget; None
    when even g = 1 does not (the JAX engine then takes the library
    kernel)."""
    per_head = banks * 2 * pp * ps * d * itemsize
    for g in range(h, 0, -1):
        if h % g == 0 and per_head * g <= _VMEM_BUDGET:
            return g
    return None


def paged_attn_supported(h: int, pp: int, ps: int, d: int,
                         itemsize: int = 2) -> bool:
    """The JAX kernel's gate: a head dim of whole 128-lane tiles, pages of
    whole 8-row groups, and a head group that fits. At Dh 128 it fails past
    24,576 rows a sequence for bf16 pools and 12,288 for f32."""
    return (d % 128 == 0 and ps % 8 == 0
            and paged_attn_group(h, pp, ps, d, itemsize) is not None)


def library_ppcb(pp: int, ps: int, d: int) -> int:
    """The JAX engine's pages_per_compute_block for the library kernel:
    whole sequences, capped so a compute block's double-buffered K+V
    (4 * ppcb * ps * d bytes) stays near 2 MB."""
    return min(pp, max(1, _PPCB_BUDGET // (4 * ps * d)))


def _launch(name, q, k_pages, v_pages, lengths, page_indices, p, ps,
            plan: "AttnPlan | None" = None, fused=(), entry=None):
    """One launch of B6, B11 or the fused step (`name`); `plan` pins the
    split kernel's plan and `entry` takes another build's C entry point
    (tools_torch/attn_sweep.py); `fused` holds the fused step's (qkv,
    page_ids, offsets, cos, sin), q then only gives the shapes."""
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
    _require(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
             "the pools must be 16-byte aligned")
    dev = q.device
    if plan is None:
        plan = attn_plan(b, h, pp * ps, d, k_pages.element_size(),
                         cuda_lib.sm_count(dev))
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    if not fused:
        # the kernel reads q's rows by bulk copies: 16-byte aligned rows
        if q.stride(0) % 4 or q.stride(1) % 4 or q.data_ptr() % 16:
            q = _aligned(q.contiguous())
        head = (q.data_ptr(), q.stride(0), q.stride(1), k_pages.data_ptr(),
                v_pages.data_ptr(), lengths.data_ptr(),
                page_indices.data_ptr())
    else:
        fused = tuple(_aligned(t) for t in fused)
        head = (fused[0].data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                lengths.data_ptr(), page_indices.data_ptr(),
                *(t.data_ptr() for t in fused[1:]))
    rc = (entry or cuda_lib.fn(name))(
        *head, b, h, p, ps, pp, d, *plan, 1.0 / math.sqrt(d),
        int(k_pages.dtype == torch.bfloat16), out.data_ptr(),
        cuda_lib.stream_handle(dev))
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


cuda_lib.counted(paged_decode_attention)


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


cuda_lib.counted(paged_decode_step_fused)


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


cuda_lib.counted(paged_decode_attention_flat)
