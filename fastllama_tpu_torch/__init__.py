"""fastllama_tpu_torch — the PyTorch/CUDA port of fastllama_tpu.

Serves q4_0, q4_1 and f16 LLaMA models (ggml-family files or fltpu
checkpoint directories), with runtime LoRA adapters, on an NVIDIA H100
(sm_90a) through the same entry points as the JAX package (Model,
FastLlama, LlamaModel, and engine.scheduler.BatchEngine for many streams at
once), with the JAX package's Pallas kernels rewritten as hand-written CUDA
kernels (kernels/csrc/). It imports neither JAX nor the JAX package. Entry
points run on the CUDA card by default; pass device="cpu" to run the plain
PyTorch path (the tests do).
"""
from .api import Model
from .config import FType, HyperParams, RuntimeConfig
from .engine.logger import DefaultLogger, Logger, ProgressTag
from .engine.session import FastLlama
from .version import __version__

__all__ = ["__version__", "Model", "FType", "HyperParams", "RuntimeConfig",
           "Logger", "DefaultLogger", "ProgressTag", "FastLlama"]
