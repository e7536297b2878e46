"""Top-level model loading: path in, LlamaModel out (PyTorch port).

Reads fltpu checkpoint directories (io/checkpoint.py). The ggml-family
files (GGML/GGMF/GGJT) that the JAX loader also reads are not ported yet.
"""
from __future__ import annotations

import time
from pathlib import Path

from ..config import RuntimeConfig, model_id_from_layers, resolve_device
from ..engine.logger import Logger, NULL_LOGGER
from ..io.checkpoint import load_params, open_checkpoint
from .runtime import LlamaModel


def load_model(path: str, rcfg: RuntimeConfig = RuntimeConfig(),
               logger: Logger = NULL_LOGGER, device=None) -> LlamaModel:
    """Load a checkpoint onto `device` (the CUDA card unless the caller
    passes device="cpu")."""
    dev = resolve_device(device)
    t0 = time.time()
    logger.log("Model", f"loading model from {path} - please wait ...\n")
    p = Path(path)
    if not (p.is_dir() and (p / "manifest.json").exists()):
        raise NotImplementedError(
            f"{path}: only fltpu checkpoint directories load in the PyTorch "
            "port; the ggml/GGJT reader is queued in ROADMAP.md (queue A, "
            "still to port)")
    ckpt = open_checkpoint(p)
    hp = ckpt.hp
    params = load_params(ckpt, device=dev, logger=logger)
    logger.log("Model", f"n_vocab = {hp.n_vocab}\n")
    logger.log("Model", f"n_embd  = {hp.n_embd}\n")
    logger.log("Model", f"n_layer = {hp.n_layer} "
                        f"({model_id_from_layers(hp.n_layer)})\n")
    logger.log("Model", f"n_ff    = {hp.n_ff}\n")
    model = LlamaModel(hp, params, ckpt.vocab, rcfg, logger, device=dev)
    logger.log("Model", f"loaded in {time.time() - t0:.2f}s\n")
    return model
