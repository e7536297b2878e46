"""Top-level model loading: path in, LlamaModel out (PyTorch port).

Accepts, as the JAX loader does:

  * fltpu checkpoint directories (io/checkpoint.py; device-layout planes, so
    loading is a memory map and a copy per tensor)
  * ggml-family files (GGML/GGMF/GGJT, one file or ".1", ".2" shards;
    io/ggml_reader.py): q4_0 and q4_1 payloads are repacked to the device
    layout in memory at load time and f16/f32 dense tensors are transposed,
    so a model file made for the reference loads directly.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..config import RuntimeConfig, model_id_from_layers, resolve_device
from ..engine.logger import Logger, NULL_LOGGER, ProgressTag
from ..io.checkpoint import load_params, open_checkpoint
from ..io.ggml_reader import (
    GGML_TYPE_Q4_0, GGML_TYPE_Q4_1, GgmlCheckpoint, read_ggml_checkpoint,
)
from ..quant import native
from ..quant.tensor import make_embedding
from .fuse import make_layer_params, matmul_from_spec
from .llama import LlamaParams
from .runtime import LlamaModel


def _ggml_spec(ckpt: GgmlCheckpoint, name: str) -> tuple:
    """Weight spec for make_layer_params: a q4_0 tensor takes the native
    threaded repack ("q4p" device planes) when the library is available,
    else numpy ("q4"); q4_1 is "q41" and anything else "dense". Both q4_0
    routes give the same bytes."""
    ttype = ckpt.tensor_type(name)
    if ttype == GGML_TYPE_Q4_0:
        single = ckpt.raw_single(name) if native.available() else None
        if single is not None:
            wire, (n, k) = single
            return ("q4p", *native.repack_q4_wire(wire, n, k, n_pad=n,
                                                  k_pad=k))
        return ("q4", *ckpt.q4_0(name))
    if ttype == GGML_TYPE_Q4_1:
        return ("q41", *ckpt.q4_1(name))
    dense = ckpt.dense(name)
    if dense.ndim == 2:
        dense = np.ascontiguousarray(dense.T)      # the model wants [K, N]
    return ("dense", dense)


def repack_route(ckpt: GgmlCheckpoint) -> str | None:
    """Which route _ggml_spec takes for this file's q4_0 matmul weights:
    "native" (the threaded C++ repack), "numpy" (no C++ compiler, or a
    tensor split across shard files), or None when it holds none."""
    names = [nm for nm in ckpt.tensor_names()
             if nm != "tok_embeddings.weight"
             and ckpt.tensor_type(nm) == GGML_TYPE_Q4_0]
    if not names:
        return None
    if native.available() and all(ckpt.raw_single(nm) is not None
                                  for nm in names):
        return "native"
    return "numpy"


def _ggml_embedding(ckpt: GgmlCheckpoint, dev):
    name = "tok_embeddings.weight"
    if ckpt.tensor_type(name) == GGML_TYPE_Q4_0:
        return make_embedding(*ckpt.q4_0(name), device=dev)
    # q4_1/f16/f32 embeddings: materialize dense (gather tables are small)
    return torch.from_numpy(ckpt.dense(name)).to(dev)


def _ggml_matmul(ckpt: GgmlCheckpoint, name: str, dev):
    return matmul_from_spec(_ggml_spec(ckpt, name), dev)


def _load_ggml_params(ckpt: GgmlCheckpoint, dev, logger: Logger) -> LlamaParams:
    hp = ckpt.hyperparams

    def build_layer(i):
        pre = f"layers.{i}."
        return make_layer_params(
            hp.n_head,
            attention_norm=ckpt.dense(pre + "attention_norm.weight"),
            ffn_norm=ckpt.dense(pre + "ffn_norm.weight"),
            wq=_ggml_spec(ckpt, pre + "attention.wq.weight"),
            wk=_ggml_spec(ckpt, pre + "attention.wk.weight"),
            wv=_ggml_spec(ckpt, pre + "attention.wv.weight"),
            wo=_ggml_spec(ckpt, pre + "attention.wo.weight"),
            w1=_ggml_spec(ckpt, pre + "feed_forward.w1.weight"),
            w2=_ggml_spec(ckpt, pre + "feed_forward.w2.weight"),
            w3=_ggml_spec(ckpt, pre + "feed_forward.w3.weight"),
            device=dev)

    # The host repack (mmap read, nibble repack, fusion; numpy releases the
    # GIL) overlaps the per-layer copies to the device across worker
    # threads. ex.map yields in layer order, so layers and progress
    # callbacks come in order whatever order the workers finish in.
    layers = [None] * hp.n_layer
    with ThreadPoolExecutor(max_workers=min(4, os.cpu_count() or 1)) as ex:
        for i, layer in zip(range(hp.n_layer),
                            ex.map(build_layer, range(hp.n_layer))):
            layers[i] = layer
            logger.progress(ProgressTag.LOAD, i + 1, hp.n_layer + 1)
    params = LlamaParams(
        tok_embeddings=_ggml_embedding(ckpt, dev),
        norm=torch.from_numpy(ckpt.dense("norm.weight")).to(dev),
        output=_ggml_matmul(ckpt, "output.weight", dev),
        layers=layers)
    logger.progress(ProgressTag.LOAD, hp.n_layer + 1, hp.n_layer + 1)
    return params


def load_model(path: str, rcfg: RuntimeConfig = RuntimeConfig(),
               logger: Logger = NULL_LOGGER, device=None) -> LlamaModel:
    """Load a checkpoint onto `device` (the CUDA card unless the caller
    passes device="cpu"). Under rcfg.mesh_shape each rank loads the
    checkpoint on the host and LlamaModel copies only its own shard to its
    card."""
    dev = resolve_device(device)
    host = (torch.device("cpu")
            if rcfg.mesh_shape and int(np.prod(rcfg.mesh_shape)) > 1 else dev)
    t0 = time.time()
    logger.log("Model", f"loading model from {path} - please wait ...\n")
    p = Path(path)
    if p.is_dir() and (p / "manifest.json").exists():
        ckpt = open_checkpoint(p)
        hp = ckpt.hp
        params = load_params(ckpt, device=host, logger=logger)
        vocab = ckpt.vocab
    else:
        ckpt = read_ggml_checkpoint(path)
        hp = ckpt.hyperparams
        vocab = ckpt.vocab
        route = repack_route(ckpt)
        if route is not None:
            logger.log("Model", f"q4_0 repack: {route}\n")
        params = _load_ggml_params(ckpt, host, logger)
    logger.log("Model", f"n_vocab = {hp.n_vocab}\n")
    logger.log("Model", f"n_embd  = {hp.n_embd}\n")
    logger.log("Model", f"n_layer = {hp.n_layer} "
                        f"({model_id_from_layers(hp.n_layer)})\n")
    logger.log("Model", f"n_ff    = {hp.n_ff}\n")
    model = LlamaModel(hp, params, vocab, rcfg, logger, device=dev)
    logger.log("Model", f"loaded in {time.time() - t0:.2f}s\n")
    return model
