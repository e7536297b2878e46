"""Multi-process launch: every rank runs the same program (PyTorch port of
fastllama_tpu/parallel/multihost.py).

The JAX package's multi-controller contract made the rule everywhere: one
process a rank (torchrun, or a launcher that sets RANK / WORLD_SIZE /
MASTER_ADDR / MASTER_PORT, or explicit arguments), each issuing the same
sequence of calls over one (data, model) mesh. Tensor parallelism stays
inside a node, where its per-layer psums are cheap; the data axis is
node-major. Everything a rank reads back is replicated by construction: the
BatchEngine all-gathers the sampled tokens over the data axis, so every
rank makes the same stop and admit decisions.

Usage on N nodes of G cards (torchrun --nnodes N --nproc-per-node G):

    from fastllama_tpu_torch.parallel import multihost
    multihost.initialize()                     # env:// from torchrun
    eng = BatchEngine(..., rcfg=RuntimeConfig(mesh_shape=(N * G // tp, tp)))
    eng.run(requests)                          # the same list on every rank
"""
from __future__ import annotations

import logging
import os
import warnings
from datetime import timedelta

import torch

from .sharding import make_mesh

log = logging.getLogger(__name__)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               initialization_timeout: int | None = None,
               backend: str | None = None) -> None:
    """Bring up the default torch.distributed process group (a no-op when it
    is up). coordinator_address "host:port" becomes tcp://host:port; without
    it the env:// rendezvous of torchrun is used. backend defaults to
    default_backend's choice.

    A failure raises whenever the world has more than one process, whether
    the count came from num_processes or from WORLD_SIZE: a multi-rank job
    that silently ran single-process would compute a different mesh on
    every rank. A single-process call that fails warns and goes on without
    a group (like the JAX package's)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    n = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", "0"))
    if backend is None:
        backend = default_backend(n)
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = timedelta(seconds=initialization_timeout)
    try:
        dist.init_process_group(
            backend=backend, world_size=n, rank=rank,
            init_method=(f"tcp://{coordinator_address}"
                         if coordinator_address else "env://"), **kw)
    except (RuntimeError, ValueError) as e:
        if n > 1:
            raise
        warnings.warn(f"torch.distributed.init_process_group failed ({e!r}); "
                      "continuing single-process")


def default_backend(n_processes: int) -> str:
    """NCCL when every rank on this node has a card of its own (the node's
    ranks, LOCAL_WORLD_SIZE, or the whole world when the launcher does not
    say), gloo otherwise: on the CPU, and where ranks share a card (NCCL
    refuses two ranks on one device)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n_processes))
    backend = ("nccl" if torch.cuda.is_available()
               and torch.cuda.device_count() >= local else "gloo")
    log.info("backend %s: %d rank(s) on this node, %d card(s)", backend,
             local, torch.cuda.device_count() if torch.cuda.is_available()
             else 0)
    return backend


def hybrid_mesh(dp: int, tp: int, device_type: str = "cpu"):
    """A (data=dp, model=tp) mesh whose model axis stays inside one node:
    ranks are numbered node-major (torchrun), so tp must divide the ranks
    of a node (LOCAL_WORLD_SIZE) and each node holds whole data groups.
    The one mesh builder of LlamaModel and BatchEngine."""
    import torch.distributed as dist
    if dist.is_initialized():
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   dist.get_world_size()))
        if tp > local or local % tp:
            raise ValueError(
                f"tp={tp} must divide the {local} ranks of a node: tensor "
                "parallelism must stay inside one node")
    return make_mesh(n_data=dp, n_model=tp, device_type=device_type)


def owned_slots(n_slots: int, n_nodes: int | None = None,
                node: int | None = None) -> range:
    """The contiguous slot range whose KV blocks live on this node (the data
    axis is node-major): for a serving front end that wants one node to own
    each response stream although every rank computes all of them. Defaults
    read the launch (torchrun's GROUP_RANK and the node count)."""
    if n_nodes is None:
        import torch.distributed as dist
        if not dist.is_initialized():
            return range(n_slots)
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   dist.get_world_size()))
        n_nodes = dist.get_world_size() // local
    if n_nodes == 1:
        return range(n_slots)
    if node is None:
        node = int(os.environ.get("GROUP_RANK", "0"))
    per = n_slots // n_nodes
    return range(node * per, (node + 1) * per)
