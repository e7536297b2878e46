"""Fresh-prompt flash prefill attention: kernel B12 and its plain version.

B12 ports fastllama_tpu/models/llama.py::_flash_prefill_attention, which
calls the library Pallas TPU kernel
jax.experimental.pallas.ops.tpu.flash_attention.flash_attention with
block_q = block_k_major = block_k = min(T, 512): causal self-attention of a
fresh prompt window (n_past == 0) over its own K/V, with the online softmax
keeping the [T, T] scores out of device memory. The forward takes it where
the JAX package does (models/llama._flash_viable): a prefill trace whose
caller promises n_past == 0, no sequence parallelism, T >= 128 and
T % 128 == 0, head_dim % 128 == 0, bf16 weight mode.

Numerics (the library's): q, k and v rounded to bf16; scores = (q . k) in
f32 times 1/sqrt(Dh); causal mask; the online softmax's p = exp(s - m) is
rounded to bf16 for the PV product; the output is normalized by l and
rounded to bf16 once. The wrapper returns that bf16 output as f32, as the
JAX function's o.astype(f32) does.

On the card (csrc/flash_prefill.cu) one block of 4 warps takes 64 query
rows of one (batch, head); each warp owns 16 of them and runs
mma.sync.m16n8k16 bf16 -> f32 over 64-key tiles staged in shared memory,
skipping the tiles above the diagonal. q, k and v are read in f32 (the
forward's dtype) through their strides and rounded to bf16 as they are
staged, so the forward passes the roped [B, T, 2H, Dh] tensor's halves and
the fused projection's V slice without a copy.
"""
from __future__ import annotations

import math

import torch

from . import cuda_lib

# the library's mask value (flash_attention.DEFAULT_MASK_VALUE)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
BLOCK = 512          # the JAX caller's block size cap: min(T, 512)
TILE = 64            # the kernel's query and key tile rows
HEAD_DIM = 128       # the head width the kernel is built for


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B12 with the library kernel's numerics:
    q, k, v [B, T, H, Dh] -> ctx f32 [B, T, H, Dh], bf16-valued. Blocks of
    min(T, 512) rows; a query block visits the key blocks up to its own
    (the library skips the rest), keeping the running max m, sum l and
    normalized accumulator acc as the library's scratch does."""
    b, t, h, d = q.shape
    blk = min(t, BLOCK)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = (_bf16(x).transpose(1, 2) for x in (q, k, v))  # [B,H,T,D]
    out = torch.empty_like(qf)
    rows = torch.arange(blk, device=q.device)
    for q0 in range(0, t, blk):
        qb = qf[:, :, q0:q0 + blk]
        m = torch.full(qb.shape[:-1] + (1,), -math.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, q0 + blk, blk):
            s = (qb @ kf[:, :, k0:k0 + blk].transpose(-1, -2)) * scale
            mask = (k0 + rows)[None, :] <= (q0 + rows)[:, None]
            s = s + torch.where(mask, 0.0, MASK_VALUE)
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_next)
            l_corr = torch.exp(m - m_next) * l
            l_next = p.sum(-1, keepdim=True) + l_corr
            inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
            acc = acc * (l_corr * inv) + (_bf16(p) @ vf[:, :, k0:k0 + blk]
                                          ) * inv
            m, l = m_next, l_next
        out[:, :, q0:q0 + blk] = acc
    return _bf16(out).transpose(1, 2).contiguous()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def flash_prefill(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Kernel B12. q, k (post-RoPE) and v f32 [B, T, H, Dh], each with a
    contiguous last axis (any B, T and H strides). Causal, scale
    1/sqrt(Dh). Returns ctx f32 [B, T, H, Dh] (contiguous), bf16-valued.
    On the card T must be a multiple of 64 and Dh 128."""
    _require(q.dim() == 4 and k.shape == q.shape and v.shape == q.shape,
             "q, k, v must be [B, T, H, Dh] of one shape")
    _require(all(x.dtype == torch.float32 for x in (q, k, v)),
             "q, k, v must be f32")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v)
    b, t, h, d = q.shape
    _require(q.device.type == "cuda"
             and k.device == q.device and v.device == q.device,
             "q, k, v must lie on one CUDA device")
    _require(d == HEAD_DIM, f"head_dim must be {HEAD_DIM}")
    _require(t > 0 and t % TILE == 0, f"T must be a multiple of {TILE}")
    _require(all(x.stride(3) == 1 and x.data_ptr() % 16 == 0
                 and all(s % 8 == 0 for s in x.stride()[:3])
                 for x in (q, k, v)),
             "q, k, v need a contiguous last axis, 16-byte aligned rows")
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    rc = cuda_lib.fn("flash_prefill")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, b, t, h, d,
        float(1.0 / math.sqrt(d)), out.data_ptr(),
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
