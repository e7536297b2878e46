"""Paged decode attention: kernel B6 and its plain version.

B6 ports fastllama_tpu/kernels/paged_attention.py::paged_decode_attention:
one decode step's attention for one layer over the page pools,

    ctx[b, h] = softmax(q[b, h] . K[b, h, :len] / sqrt(D)) @ V[b, h, :len]

where sequence b's keys live in the pages page_indices[b, 0 .. ceil(len/ps))
of the pools [H, P, ps, D] and len = lengths[b] counts the token written just
before (kernels/kv_write.py runs first). The numerical contract is the TPU
kernel's: q and the probabilities are cast to the pool dtype before the two
dots, scores, softmax and accumulation are f32, a masked probability is
exactly 0 and the denominator is max(sum p, 1e-30), so a sequence of length
0 yields zeros. Pages past ceil(len/ps) are never read.

The CUDA kernel is in csrc/paged_attention.cu; the wrapper launches it for
CUDA tensors and runs the plain version for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from . import cuda_lib


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


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, lengths: torch.Tensor,
                           page_indices: torch.Tensor) -> torch.Tensor:
    """Kernel B6. q f32 [B, H, D] after RoPE; pools [H, P, ps, D] bf16 or
    f32 holding the current token's row; lengths int32 [B], the number of
    keys to attend (clipped to pp * ps); page_indices int32 [B, pp].
    Returns ctx f32 [B, H, D]."""
    b, h, d = q.shape
    _require(q.dtype == torch.float32, "q must be f32 [B, H, D]")
    _require(k_pages.dim() == 4 and v_pages.shape == k_pages.shape
             and v_pages.dtype == k_pages.dtype
             and k_pages.dtype in (torch.bfloat16, torch.float32)
             and k_pages.shape[0] == h and k_pages.shape[3] == d,
             f"pools must match, bf16 or f32 [{h}, P, ps, {d}]: got "
             f"{tuple(k_pages.shape)} {k_pages.dtype}")
    _require(lengths.shape == (b,) and lengths.dtype == torch.int32,
             "lengths must be int32 [B]")
    _require(page_indices.dim() == 2 and page_indices.shape[0] == b
             and page_indices.dtype == torch.int32,
             "page_indices must be int32 [B, pages_per_seq]")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, lengths,
                                            page_indices)
    _, p, ps, _ = k_pages.shape
    pp = page_indices.shape[1]
    tensors = (q, k_pages, v_pages, lengths, page_indices)
    _require(q.device.type == "cuda"
             and all(t.device == q.device and t.is_contiguous()
                     for t in tensors),
             "all tensors must be contiguous on one CUDA device")
    _require(d % 32 == 0 and d <= 256 and pp * ps <= 12288,
             "head_dim must be a multiple of 32 and <= 256 and "
             f"pages_per_seq * page_size <= 12288: got D = {d}, "
             f"{pp} x {ps}")
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    rc = cuda_lib.fn("paged_decode_attention")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), page_indices.data_ptr(), b, h, p, ps, pp, d,
        1.0 / math.sqrt(d), int(k_pages.dtype == torch.bfloat16),
        out.data_ptr(), cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
