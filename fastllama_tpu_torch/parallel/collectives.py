"""The collectives of the sharded forward, named after the JAX ops they
replace (jax.lax.psum / pmax / all_gather / ppermute under shard_map), over
torch.distributed process groups: one process a rank, every rank running
the same program.

The backend is the caller's: NCCL where each rank has a card of its own,
gloo on the CPU and where ranks share a card. PyTorch documents gloo's
support for CUDA tensors as all_reduce and broadcast only, so for the other
ops (all_gather, the ring's send/recv) on a CUDA tensor over a gloo group
the tensor is copied through the host. That route is chosen by the group's
backend name, never by catching a failure, and its bytes are counted in
STAGED (what went to the host plus what came back) so a run can print them.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# bytes and calls of each op that went through the host
STAGED: dict[str, collections.Counter] = {
    "bytes": collections.Counter(), "calls": collections.Counter()}


def reset_staged() -> None:
    for c in STAGED.values():
        c.clear()


def _staged(x: torch.Tensor, group) -> bool:
    """True where the op goes through the host: a CUDA tensor on a gloo
    group, for an op gloo does not take on CUDA tensors."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _count(op: str, nbytes: int) -> None:
    STAGED["bytes"][op] += nbytes
    STAGED["calls"][op] += 1


def axis_index(group) -> int:
    """This rank's index in the group (jax.lax.axis_index)."""
    return dist.get_rank(group)


def axis_size(group) -> int:
    return dist.get_world_size(group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group's ranks, on every rank (a new tensor)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def broadcast(x: torch.Tensor, src_index: int, group) -> torch.Tensor:
    """x of the rank at `src_index` in the group, on every rank (in place)."""
    dist.broadcast(x, src=dist.get_global_rank(group, src_index), group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in rank order
    (jax.lax.all_gather(..., tiled=True))."""
    n = axis_size(group)
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        _count("all_gather", src.numel() * src.element_size() * (n + 1))
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Ring shift: rank i sends x to rank (i + shift) % n and returns what
    rank (i - shift) % n sent (jax.lax.ppermute with the ring's perm)."""
    n = axis_size(group)
    i = axis_index(group)
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        _count("ppermute", 2 * src.numel() * src.element_size())
        src = src.cpu()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src,
                      dist.get_global_rank(group, (i + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (i - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if staged else out
