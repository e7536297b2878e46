"""Model hyper-parameters and size registry (PyTorch port).

The same HyperParams / PRESETS / RuntimeConfig as the JAX package's
config.py, kept as a copy so the port never imports that package.
"""
from __future__ import annotations

import dataclasses
import enum


class FType(enum.IntEnum):
    """Checkpoint weight type (reference: include/llama.hpp:23-32)."""
    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q4_1_SOME_F16 = 4
    MOSTLY_Q4_2 = 5
    MOSTLY_Q4_3 = 6


@dataclasses.dataclass(frozen=True)
class HyperParams:
    n_vocab: int = 32000
    n_ctx: int = 512
    n_embd: int = 4096
    n_mult: int = 256
    n_head: int = 32
    n_layer: int = 32
    n_rot: int = 64
    ftype: FType = FType.MOSTLY_F16

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def n_ff(self) -> int:
        """FFN width (reference formula: lib/llama.cpp:129)."""
        return ((2 * (4 * self.n_embd) // 3 + self.n_mult - 1)
                // self.n_mult) * self.n_mult

    def with_ctx(self, n_ctx: int) -> "HyperParams":
        return dataclasses.replace(self, n_ctx=n_ctx)


# n_layer -> canonical model name (lib/llama.cpp:133-139)
MODEL_ID_BY_LAYERS = {32: "7B", 40: "13B", 60: "30B", 80: "65B"}

# Canonical presets (LLaMA-1 family dims).
PRESETS: dict[str, HyperParams] = {
    "7B": HyperParams(n_embd=4096, n_head=32, n_layer=32, n_rot=128),
    "13B": HyperParams(n_embd=5120, n_head=40, n_layer=40, n_rot=128),
    "30B": HyperParams(n_embd=6656, n_head=52, n_layer=60, n_rot=128),
    "65B": HyperParams(n_embd=8192, n_head=64, n_layer=80, n_rot=128),
}


def model_id_from_layers(n_layer: int) -> str:
    return MODEL_ID_BY_LAYERS.get(n_layer, "7B")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Session/runtime knobs — the reference's builder params
    (include/bridge.hpp:21-54, interfaces/python/fastllama.py:198-234) plus
    the mesh knobs of multi-GPU serving (parallel/)."""
    n_ctx: int = 512
    n_batch: int = 64                 # prefill chunk (reference n_batch)
    n_keep: int = 64                  # tokens kept on context recycle
    last_n_size: int = 64             # repetition-penalty window
    seed: int = 0
    should_get_all_logits: bool = False
    embedding_eval_enabled: bool = False
    kv_dtype: str = "bfloat16"        # reference uses f32 (llama.hpp:104)
    weight_dtype: str = "bfloat16"    # dequant target dtype of the matmuls
    # (data, model) = (dp, tp) ranks of an initialized torch.distributed
    # world, one process a rank (parallel/sharding.py); () = one device
    mesh_shape: tuple[int, ...] = ()
    # the JAX config's field, kept for parity; neither package reads it
    # (the mesh's axes are always ("data", "model"))
    mesh_axes: tuple[str, ...] = ("data", "model")
    # Single-stream sessions: reinterpret mesh_shape's data axis as the
    # SEQUENCE axis (parallel/ring.py) — the KV cache shards over positions
    # and prefill runs ring attention. Ignored by the BatchEngine (its data
    # axis is the batch).
    seq_parallel: bool = False
    # The JAX package's kernel switch (kernels/q4_matmul.q4_matmul): None =
    # the port's dispatch table, False = q4_matmul_xla's function at every
    # M (no default int8), True = the Pallas decode kernel's (v1's fold).
    use_pallas: bool | None = None
    prefill_buckets: tuple[int, ...] = (16, 64, 128, 256, 512, 1024, 2048)
    # Activation-quantized int8 prefill matmuls (kernels/q4_matmul.py,
    # kernels B2+B3). None = on in bf16 mode, off in f32 mode; True/False
    # pin the path on every device.
    prefill_int8: bool | None = None
    # Tracing (reference analog: ggml perf counters + graph_print): when
    # set, FastLlama.generate / BatchEngine.run wrap their hot regions in
    # torch.profiler traces under this directory (utils/trace.py).
    profile_dir: str = ""


# The device an entry point takes when its caller names none (None: the
# card). Set only by set_default_device, for an embedder that cannot pass
# device= through its own interface (the C ABI's FASTLLAMA_C_INIT hook).
_default_device = None


def set_default_device(device) -> None:
    """Make `device` ("cpu", "cuda", ...) what every entry point of this
    process runs on when its caller passes device=None; None restores the
    card."""
    global _default_device
    _default_device = device


def resolve_device(device=None):
    """The device an entry point runs on: the card unless the caller (or
    set_default_device) asks for the CPU. A missing card raises; nothing
    falls back to the CPU."""
    import torch
    if device is None:
        device = _default_device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fastllama_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
