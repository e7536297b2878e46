"""Mesh + sharding: serving one model over several GPUs (PyTorch port of
fastllama_tpu/parallel/sharding.py).

One process a rank, every rank running the same program. The mesh is a
torch.distributed DeviceMesh with the axes ("data", "model"); collectives
(parallel/collectives.py) take its groups. Megatron tensor parallelism,
two psums a layer:

  output-sharded on "model" (columns of the [K, N] layout):
      wqkv (whole heads a rank), w13 (gate/up pairs), the output head (vocab)
  reduction-sharded (rows, then psum):  wo, w2
  vocab-sharded:                        tok_embeddings
  replicated:                           norms
  LoRA terms follow their base weight
  KV cache:   heads on "model", batch on "data" (the engine's slab), or the
              SEQUENCE on "data" (sequence parallelism, parallel/ring.py)

Sharding is pure: shard_params(params, rank, tp) returns the rank's own
parameters, the planes the JAX package's NamedSharding hands device `rank`
of the model axis, so each rank loads a checkpoint on the host, takes its
slice and copies only that to its card.
"""
from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from ..models.fuse import shard_col_order
from ..models.llama import LayerParams, LlamaParams, LoraTerm
from ..quant.tensor import QBLOCK, QuantEmbedding, QuantMatmulWeight, good_pad_n

DATA_AXIS = "data"
MODEL_AXIS = "model"

# kernel B3 (kernels/q4_matmul.q4_matmul_prefill_int8) takes a stored K that
# is a multiple of 64; a reduction-sharded weight whose rank-local K is not
# (7B w2 at tp = 8: 1376) gets inert rows up to it
K_MULTIPLE = 64

log = logging.getLogger(__name__)

_MESHES: dict = {}
_SAID_SHARED: set = set()      # devices whose sharing the log has told


def make_mesh(n_data: int = 1, n_model: int = 1, device_type: str = "cpu"):
    """The (data, model) DeviceMesh over every rank of the initialized
    default process group, whose world size must be n_data * n_model; its
    sub-groups inherit the default group's backend. Without an initialized
    group it raises: the port never runs one device in place of a mesh.
    Meshes are built once a shape (a collective call on every rank)."""
    from torch.distributed.device_mesh import init_device_mesh
    require_world((n_data, n_model))
    key = (n_data, n_model, device_type)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device_type, (n_data, n_model),
                                        mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return _MESHES[key]


def require_world(mesh_shape: tuple[int, ...]) -> None:
    """Raise unless an initialized default process group has
    prod(mesh_shape) ranks."""
    import torch.distributed as dist
    n = int(np.prod(mesh_shape))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh_shape={tuple(mesh_shape)} needs an initialized "
            "torch.distributed process group of that many ranks (torchrun, "
            "or parallel.multihost.initialize); none is initialized")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"mesh_shape={tuple(mesh_shape)} needs a world of {n} ranks; "
            f"the process group has {dist.get_world_size()}")


def mesh_coords(mesh) -> tuple[int, int]:
    """(data index, model index) of this rank."""
    data, model = mesh.mesh_dim_names
    return mesh.get_local_rank(data), mesh.get_local_rank(model)


def local_rank() -> int:
    import torch.distributed as dist
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def rank_device(dev: torch.device) -> torch.device:
    """This rank's device: cuda:{local rank % cards} for a CUDA device
    (ranks share a card where there are fewer cards than ranks; said in
    the log, not refused), the device itself otherwise. Sets it as the
    current CUDA device before any mesh is built."""
    if dev.type != "cuda":
        return dev
    import torch.distributed as dist
    n_cards = torch.cuda.device_count()
    dev = torch.device("cuda", local_rank() % n_cards)
    torch.cuda.set_device(dev)
    if dist.get_world_size() > n_cards and dev not in _SAID_SHARED:
        _SAID_SHARED.add(dev)
        log.warning("%d ranks on %d card(s): rank %d runs on %s, shared "
                    "with other ranks (time-sliced)", dist.get_world_size(),
                    n_cards, dist.get_rank(), dev)
    return dev


# ---------------------------------------------------------------------------
# per-rank slices
# ---------------------------------------------------------------------------

def _part(x: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    """The i-th of n equal contiguous slices of x along dim (a copy)."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim of {size} not divisible into {n} shards")
    return x.narrow(dim, i * (size // n), size // n).contiguous()


def _n_out(w) -> int:
    return w.n_logical if isinstance(w, QuantMatmulWeight) else w.shape[1]


def _strip_n_pad(w):
    """Drop pack-time N padding (it sits at the END of N) so a column split
    lands on real data; a sharded quant weight must be unpadded in N."""
    if not isinstance(w, QuantMatmulWeight) or w.qs.shape[1] == w.n_logical:
        return w
    n = w.n_logical
    if n % 256:
        raise ValueError(
            f"cannot shard a quant weight with n_logical={n} (not a "
            f"multiple of 256)")
    return QuantMatmulWeight(
        qs=w.qs[:, :n], scales=w.scales[:, :n],
        mins=None if w.mins is None else w.mins[:, :n], n_logical=n)


def _out_shard(w, rank: int, tp: int, order: np.ndarray | None = None):
    """The rank's column slice of an output-sharded weight: N padding
    stripped, fused columns re-laid into per-shard blocks (order), the
    rank's contiguous 1/tp slice, and a quant weight re-padded PER SHARD to
    good_pad_n of the local width with inert columns (codes 0x88 for q4_0,
    0x00 for q4_1, zero scales and mins); n_logical becomes the local width,
    so a padded tail never reaches the logits' all-gather."""
    w = _strip_n_pad(w)
    n = _n_out(w)
    if n % tp:
        raise ValueError(f"N={n} not divisible by tp={tp}")
    w_loc = n // tp
    cols = torch.arange(n) if order is None else torch.from_numpy(order)
    cols = cols[rank * w_loc:(rank + 1) * w_loc]
    if not isinstance(w, QuantMatmulWeight):
        return w[:, cols.to(w.device)].contiguous()
    pad = good_pad_n(w_loc) - w_loc

    def plane(p, fill):
        p = p[:, cols.to(p.device)]
        if pad:
            p = torch.cat([p, torch.full((p.shape[0], pad), fill,
                                         dtype=p.dtype, device=p.device)],
                          dim=1)
        return p.contiguous()

    return QuantMatmulWeight(
        qs=plane(w.qs, 0x00 if w.mins is not None else 0x88),
        scales=plane(w.scales, 0),
        mins=None if w.mins is None else plane(w.mins, 0), n_logical=w_loc)


def _red_shard(w, k_logical: int, rank: int, tp: int):
    """The rank's row slice of a reduction-sharded weight: pack-time K
    padding (at the END of the global K) and N padding stripped, the rank's
    1/tp of the rows, and a local K that is not a multiple of K_MULTIPLE
    padded up to one with inert rows (q4_matmul counts x as zero there)."""
    w = _strip_n_pad(w)
    if not isinstance(w, QuantMatmulWeight):
        return _part(w, 0, rank, tp)
    if k_logical % (tp * QBLOCK):
        raise ValueError(f"K={k_logical} does not split into {tp} shards of "
                         f"whole {QBLOCK}-blocks")
    k_loc = k_logical // tp
    k_pad = -(-k_loc // K_MULTIPLE) * K_MULTIPLE - k_loc

    def plane(p, rows_per_k, fill):
        p = _part(p[:k_logical // rows_per_k], 0, rank, tp)
        if k_pad:
            p = torch.cat([p, torch.full((k_pad // rows_per_k, p.shape[1]),
                                         fill, dtype=p.dtype,
                                         device=p.device)], dim=0)
        return p

    return QuantMatmulWeight(
        qs=plane(w.qs, 2, 0x00 if w.mins is not None else 0x88),
        scales=plane(w.scales, QBLOCK, 0),
        mins=None if w.mins is None else plane(w.mins, QBLOCK, 0),
        n_logical=w.n_logical)


def _lora_out(t: LoraTerm | None, n_global: int, rank: int, tp: int):
    """An output-sharded base's term: delta and b columns split, a
    replicated. A term already at the local width is left as it is."""
    if t is None or (t.delta if t.delta is not None else t.b).shape[1] \
            != n_global:
        return t
    if t.delta is not None:
        return LoraTerm(delta=_part(t.delta, 1, rank, tp))
    return LoraTerm(a=t.a, b=_part(t.b, 1, rank, tp))


def _lora_red(t: LoraTerm | None, k_global: int, rank: int, tp: int):
    """A reduction-sharded base's term: delta and a rows split, b
    replicated (the partial sums ride the layer's psum)."""
    if t is None or (t.delta if t.delta is not None else t.a).shape[0] \
            != k_global:
        return t
    if t.delta is not None:
        return LoraTerm(delta=_part(t.delta, 0, rank, tp))
    return LoraTerm(a=_part(t.a, 0, rank, tp), b=t.b)


def _model_sharded_already(params: LlamaParams) -> bool:
    """True once shard_params ran: the base weights carry the local widths
    and must not be permuted or sliced again (re-sharding after a LoRA
    attach only slices the new terms)."""
    return params.tp_shard is not None


def shard_params(params: LlamaParams, rank: int, tp: int) -> LlamaParams:
    """Model-axis rank `rank` of `tp`'s own parameters (tp == 1: params).

    Base weights: output-sharded wqkv / w13 (fused columns re-laid into
    per-shard blocks, models/fuse.shard_col_order) and output head, each
    re-padded per shard; reduction-sharded wo / w2 (K padding stripped
    first); vocab rows of tok_embeddings; norms shared. LoRA terms follow
    their base. Applied to parameters it already sharded, it slices only
    LoRA terms still at their global widths."""
    if tp == 1:
        return params
    if _model_sharded_already(params):
        if params.tp_shard != (rank, tp):
            raise ValueError(f"parameters are rank {params.tp_shard} of a "
                             f"model axis, not ({rank}, {tp})")
        n_vocab = _n_out(params.output) * tp
    else:
        n_vocab = _n_out(params.output)
    layers = []
    for layer in params.layers:
        d = layer.attention_norm.shape[0]
        f = _n_out(layer.w13) // 2 * (tp if params.tp_shard else 1)
        if not _model_sharded_already(params):
            layer = dataclasses.replace(
                layer,
                wqkv=_out_shard(layer.wqkv, rank, tp,
                                shard_col_order(3 * d, 3, tp)),
                w13=_out_shard(layer.w13, rank, tp,
                               shard_col_order(2 * f, 2, tp)),
                wo=_red_shard(layer.wo, d, rank, tp),
                w2=_red_shard(layer.w2, f, rank, tp))
        layers.append(dataclasses.replace(
            layer,
            lora_wq=_lora_out(layer.lora_wq, d, rank, tp),
            lora_wk=_lora_out(layer.lora_wk, d, rank, tp),
            lora_wv=_lora_out(layer.lora_wv, d, rank, tp),
            lora_wo=_lora_red(layer.lora_wo, d, rank, tp),
            lora_w1=_lora_out(layer.lora_w1, f, rank, tp),
            lora_w2=_lora_red(layer.lora_w2, f, rank, tp),
            lora_w3=_lora_out(layer.lora_w3, f, rank, tp)))
    out = params
    if not _model_sharded_already(params):
        emb = params.tok_embeddings
        emb = (QuantEmbedding(qs=_part(emb.qs, 0, rank, tp),
                              scales=_part(emb.scales, 0, rank, tp))
               if isinstance(emb, QuantEmbedding) else _part(emb, 0, rank, tp))
        out = dataclasses.replace(params, tok_embeddings=emb,
                                  output=_out_shard(params.output, rank, tp),
                                  tp_shard=(rank, tp))
    return dataclasses.replace(
        out, layers=layers,
        lora_output=_lora_out(params.lora_output, n_vocab, rank, tp))


def params_to(params: LlamaParams, dev) -> LlamaParams:
    """Every tensor of the parameters on `dev` (the rank's slice, loaded on
    the host, goes to its card)."""
    def mv(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, (QuantMatmulWeight, QuantEmbedding, LoraTerm)):
            return dataclasses.replace(x, **{
                f.name: mv(getattr(x, f.name)) for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name), torch.Tensor)})
        return x
    layers = [LayerParams(**{f.name: mv(getattr(layer, f.name))
                             for f in dataclasses.fields(layer)})
              for layer in params.layers]
    return dataclasses.replace(
        params, tok_embeddings=mv(params.tok_embeddings),
        norm=mv(params.norm), output=mv(params.output), layers=layers,
        lora_output=mv(params.lora_output))


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def shard_kv(kv, data: tuple[int, int], model: tuple[int, int]):
    """The rank's block of per-layer [B, S, H*Dh] caches: batch on the data
    axis, head columns on the model axis (KV_SPEC); data and model are
    (index, size)."""
    def cut(x):
        return _part(_part(x, 0, *data), 2, *model)
    return [(cut(k), cut(v)) for k, v in kv]


def shard_kv_seq(kv, seq: tuple[int, int], model: tuple[int, int]):
    """Sequence-sharded block (SEQ_KV_SPEC): S on the data axis, heads on
    the model axis. S must divide the data-axis size."""
    def cut(x):
        return _part(_part(x, 1, *seq), 2, *model)
    return [(cut(k), cut(v)) for k, v in kv]
