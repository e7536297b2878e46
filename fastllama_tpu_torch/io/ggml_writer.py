"""GGJT v1 writer — interchange with the reference ecosystem and test
fixtures (layout per scripts/convert.py:899-928 / file_loader.hpp FileSaver).
The port's own copy of the JAX package's writer: the same bytes.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..config import HyperParams
from ..engine.tokenizer import Vocab
from ..quant import q4
from .ggml_reader import (
    GGML_TYPE_F16, GGML_TYPE_F32, GGML_TYPE_Q4_0, GGML_TYPE_Q4_1, MAGIC_GGJT,
    MAGIC_GGLA,
)


def write_ggjt(path: str | Path, hp: HyperParams, vocab: Vocab,
               tensors: dict[str, tuple]) -> None:
    """tensors: name -> one of
        ("f32", np.ndarray), ("f16", np.ndarray),
        ("q4_0", codes uint8 [..., K], scales f32 [..., K//32]),
        ("q4_1", codes uint8 [..., K], scales f32, mins f32 [..., K//32])
    2-D arrays use numpy orientation (rows, cols); ggml extents are written
    reversed (fastest-varying first).
    """
    with open(path, "wb") as f:
        f.write(struct.pack("<I", MAGIC_GGJT))
        f.write(struct.pack("<I", 1))  # version GGMF_V1 wire value
        f.write(struct.pack("<7i", hp.n_vocab, hp.n_embd, hp.n_mult,
                            hp.n_head, hp.n_layer, hp.n_rot, int(hp.ftype)))
        for tok, score in vocab.id_to_token:
            f.write(struct.pack("<I", len(tok)))
            f.write(tok)
            f.write(struct.pack("<f", score))

        for name, spec in tensors.items():
            kind = spec[0]
            if kind == "q4_0":
                _, codes, scales = spec
                shape = codes.shape
                ttype = GGML_TYPE_Q4_0
                payload = q4.q4_0_to_wire(codes, scales)
            elif kind == "q4_1":
                _, codes, scales, mins = spec
                shape = codes.shape
                ttype = GGML_TYPE_Q4_1
                payload = q4.q4_1_to_wire(codes, scales, mins)
            elif kind == "f16":
                _, arr = spec
                shape = arr.shape
                ttype = GGML_TYPE_F16
                payload = np.ascontiguousarray(arr.astype(np.float16)).tobytes()
            elif kind == "f32":
                _, arr = spec
                shape = arr.shape
                ttype = GGML_TYPE_F32
                payload = np.ascontiguousarray(arr.astype(np.float32)).tobytes()
            else:
                raise ValueError(f"unknown tensor kind {kind}")
            sname = name.encode("utf-8")
            f.write(struct.pack("<III", len(shape), len(sname), ttype))
            f.write(struct.pack(f"<{len(shape)}i", *shape[::-1]))
            f.write(sname)
            f.seek((f.tell() + 31) & -32)
            f.write(payload)


def write_ggla(path: str | Path, r: int, alpha: int, use_cache: bool,
               tensors: dict[str, np.ndarray], fp16: bool = False) -> None:
    """Write a ggla LoRA adapter (layout per convert-lora-to-ggml.py:51-77).

    tensors: name ('<base>.lora' | '<base>.loraA' | '<base>.loraB') -> array.
    Cached mode: '<base>.lora' = ΔW [out, in]. No-cache: loraA = scaled A^T
    [in, r], loraB = B [out, r].
    """
    with open(path, "wb") as f:
        f.write(struct.pack("<I", MAGIC_GGLA))
        f.write(struct.pack("<I", 1))
        f.write(struct.pack("<?", use_cache))
        f.write(struct.pack("<II", r, alpha))
        for name, arr in tensors.items():
            if fp16:
                arr = arr.astype(np.float16)
                ttype = GGML_TYPE_F16
            else:
                arr = arr.astype(np.float32)
                ttype = GGML_TYPE_F32
            sname = name.encode("utf-8")
            shape = arr.shape
            f.write(struct.pack("<III", len(shape), len(sname), ttype))
            f.write(struct.pack(f"<{len(shape)}i", *shape[::-1]))
            f.write(sname)
            f.seek((f.tell() + 31) & -32)
            f.write(np.ascontiguousarray(arr).tobytes())
