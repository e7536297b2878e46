"""Full f32 products where the JAX package pins Precision.HIGHEST.

PyTorch's f32 matmul precision is process-global: a host program that calls
torch.set_float32_matmul_precision("high") (or sets
torch.backends.cuda.matmul.allow_tf32) makes every later f32 mm, bmm and
einsum round its operands to TF32 on the card. The JAX package's f32 weight
mode pins HIGHEST on its f32 products (the LoRA dots, the slab and paged
attention einsums, the SP ring), so the port runs those products under
`ieee_f32`, which sets "highest" for their span and gives the caller's
setting back afterwards, on an exception too. A CUDA graph records the
kernels chosen while it captures, so a step captured under the pin replays
pinned whatever the caller sets later.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_f32(on: bool = True):
    """Run the block's f32 products in IEEE f32 when `on` (the f32 weight
    mode); a no-op otherwise, so bf16 mode keeps the caller's setting.

    The pin goes through torch.set_float32_matmul_precision, which keeps
    the legacy switch and the per-backend one (torch.backends.cuda.matmul.
    fp32_precision, where this PyTorch has it) in step. The restore puts
    back both as they were: the legacy setting where it reads, then the
    per-backend string."""
    if not on:
        yield
        return
    matmul = torch.backends.cuda.matmul
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:
        # the caller set only the per-backend switch, so the two disagree
        # and the legacy getter refuses to read
        legacy = None
    try:
        backend = matmul.fp32_precision
    except AttributeError:
        backend = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        if backend is not None:
            matmul.fp32_precision = backend
