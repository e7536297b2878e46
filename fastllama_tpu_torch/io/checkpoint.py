"""fltpu checkpoints: writer and reader (PyTorch port of io/checkpoint.py).

A checkpoint is a directory holding
  manifest.json   — hyperparams, tensor table (kind/shape/offsets), version
  weights.bin     — 64-byte-aligned concatenated tensor payloads
  vocab.bin       — n_vocab x { len u32, bytes, score f32 }
with tensors in the device layout (split-K packed nibble planes + scale
planes and, for affine q4_1 tensors, mins planes; quant/tensor.py), so
loading is a memory map and a copy to the device per tensor, with no
repacking. Files written by either package load in both.
"""
from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path

import numpy as np
import torch

from ..config import FType, HyperParams, resolve_device
from ..engine.logger import Logger, NULL_LOGGER, ProgressTag
from ..engine.tokenizer import Vocab
from ..quant.q4 import QK4_0
from ..quant.tensor import (
    QuantEmbedding, matmul_weight_from_planes, pack_codes_split_k,
    split_pack_lastdim,
)

FORMAT = "fltpu.v1"
ALIGN = 64


class CheckpointWriter:
    def __init__(self, path: str | Path, hp: HyperParams, vocab: Vocab,
                 ftype: FType = FType.MOSTLY_Q4_0):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.hp = hp
        self.ftype = ftype
        self.tensors: dict[str, dict] = {}
        self._f = open(self.path / "weights.bin", "wb")
        self._off = 0
        with open(self.path / "vocab.bin", "wb") as vf:
            for tok, score in vocab.id_to_token:
                vf.write(struct.pack("<I", len(tok)))
                vf.write(tok)
                vf.write(struct.pack("<f", score))

    def _write_payload(self, a: np.ndarray) -> list:
        pad = -self._off % ALIGN
        if pad:
            self._f.write(b"\0" * pad)
            self._off += pad
        start = self._off
        data = np.ascontiguousarray(a)
        self._f.write(data.tobytes())
        self._off += data.nbytes
        return [start, data.nbytes]

    def add_q4_planes(self, name: str, qs: np.ndarray, scales: np.ndarray):
        """Unpadded device planes: qs uint8 [K/2, N], scales f32 [K/32, N]."""
        kh, n = qs.shape
        self.tensors[name] = {
            "kind": "q4_matmul", "shape": [kh * 2, n],
            "qs": self._write_payload(np.asarray(qs, np.uint8)),
            "scales": self._write_payload(np.asarray(scales, np.float32)),
        }

    def add_q4_matmul(self, name: str, codes: np.ndarray, scales: np.ndarray):
        """codes uint8 [N, K] row-major (quantizer output), scales [N, K/32].
        Stored transposed + split-K packed (the device layout)."""
        self.add_q4_planes(
            name, pack_codes_split_k(np.ascontiguousarray(codes.T)),
            np.ascontiguousarray(scales.T.astype(np.float32)))

    def add_q41_matmul(self, name: str, codes: np.ndarray, scales: np.ndarray,
                       mins: np.ndarray):
        """Affine (q4_1/GPTQ) weight: codes uint8 [N, K], scales/mins
        [N, K/32]. Stored transposed + split-K packed like q4_matmul, plus a
        mins plane."""
        n, k = codes.shape
        self.tensors[name] = {
            "kind": "q41_matmul", "shape": [k, n],
            "qs": self._write_payload(
                pack_codes_split_k(np.ascontiguousarray(codes.T))),
            "scales": self._write_payload(
                np.ascontiguousarray(scales.T.astype(np.float32))),
            "mins": self._write_payload(
                np.ascontiguousarray(mins.T.astype(np.float32))),
        }

    def add_q4_embedding(self, name: str, codes: np.ndarray, scales: np.ndarray):
        self.add_q4_embedding_planes(name, split_pack_lastdim(codes), scales)

    def add_q4_embedding_planes(self, name: str, qs: np.ndarray,
                                scales: np.ndarray):
        """qs uint8 [V, D/2] split-K packed, scales f32 [V, D/32]."""
        v, dh = qs.shape
        self.tensors[name] = {
            "kind": "q4_embedding", "shape": [v, dh * 2],
            "qs": self._write_payload(np.asarray(qs, np.uint8)),
            "scales": self._write_payload(np.asarray(scales, np.float32)),
        }

    def add_dense(self, name: str, a: np.ndarray):
        self.tensors[name] = {
            "kind": "dense", "shape": list(a.shape), "dtype": str(a.dtype),
            "data": self._write_payload(a),
        }

    def finish(self) -> None:
        self._f.close()
        manifest = {
            "format": FORMAT,
            "ftype": int(self.ftype),
            "hyperparams": {
                "n_vocab": self.hp.n_vocab, "n_ctx": self.hp.n_ctx,
                "n_embd": self.hp.n_embd, "n_mult": self.hp.n_mult,
                "n_head": self.hp.n_head, "n_layer": self.hp.n_layer,
                "n_rot": self.hp.n_rot,
            },
            "tensors": self.tensors,
        }
        with open(self.path / "manifest.json", "w") as f:
            json.dump(manifest, f, indent=1)


def read_vocab_bin(path: Path, n_vocab: int) -> Vocab:
    toks = []
    with open(path, "rb") as f:
        for _ in range(n_vocab):
            ln, = struct.unpack("<I", f.read(4))
            word = f.read(ln)
            score, = struct.unpack("<f", f.read(4))
            toks.append((word, score))
    return Vocab.from_tokens(toks)


@dataclasses.dataclass
class Checkpoint:
    path: Path
    hp: HyperParams
    ftype: FType
    vocab: Vocab
    tensors: dict[str, dict]
    mm: np.memmap

    def _payload(self, rec: list, dtype, shape) -> np.ndarray:
        off, size = rec
        return self.mm[off:off + size].view(dtype).reshape(shape)

    def kind(self, name: str) -> str:
        return self.tensors[name]["kind"]

    def raw_q4_planes(self, name: str) -> tuple[np.ndarray, ...]:
        """Unpadded device-layout planes: (qs, scales) for q4_matmul or
        (qs, scales, mins) for q41_matmul."""
        meta = self.tensors[name]
        if meta["kind"] not in ("q4_matmul", "q41_matmul"):
            raise ValueError(f"{name} is {meta['kind']}, not a q4 matmul")
        k, n = meta["shape"]
        planes = (self._payload(meta["qs"], np.uint8, (k // 2, n)),
                  self._payload(meta["scales"], np.float32, (k // QK4_0, n)))
        if meta["kind"] == "q41_matmul":
            planes += (self._payload(meta["mins"], np.float32,
                                     (k // QK4_0, n)),)
        return planes

    def raw_dense(self, name: str) -> np.ndarray:
        meta = self.tensors[name]
        return self._payload(meta["data"], np.dtype(meta["dtype"]),
                             tuple(meta["shape"]))


def open_checkpoint(path: str | Path) -> Checkpoint:
    path = Path(path)
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    h = manifest["hyperparams"]
    hp = HyperParams(n_vocab=h["n_vocab"], n_ctx=h["n_ctx"], n_embd=h["n_embd"],
                     n_mult=h["n_mult"], n_head=h["n_head"],
                     n_layer=h["n_layer"], n_rot=h["n_rot"],
                     ftype=FType(manifest["ftype"]))
    vocab = read_vocab_bin(path / "vocab.bin", hp.n_vocab)
    mm = np.memmap(path / "weights.bin", dtype=np.uint8, mode="r")
    return Checkpoint(path=path, hp=hp, ftype=hp.ftype, vocab=vocab,
                      tensors=manifest["tensors"], mm=mm)


def load_params(ckpt: Checkpoint, device=None,
                logger: Logger = NULL_LOGGER):
    """Build the fused-layout LlamaParams on `device` from a checkpoint:
    QKV and w1/w3 fused along N (models/fuse.py column orders), matmul
    planes padded to good_pad_k / good_pad_n as the JAX loader pads them."""
    from ..models.fuse import (
        fuse_dense, fuse_packed, qkv_col_order, w13_col_order,
    )
    from ..models.llama import LayerParams, LlamaParams

    dev = resolve_device(device)
    hp = ckpt.hp

    def dense(nm):
        return torch.from_numpy(np.array(ckpt.raw_dense(nm))).to(dev)

    def single(nm):
        if ckpt.kind(nm) == "dense":
            return dense(nm)                           # stored [K, N]
        planes = ckpt.raw_q4_planes(nm)
        if len(planes) == 3:
            return fuse_packed([planes], np.arange(planes[0].shape[1]),
                               device=dev)
        return matmul_weight_from_planes(*planes, device=dev)

    def fused(names, order):
        kinds = {ckpt.kind(nm) for nm in names}
        if kinds == {"dense"}:
            return fuse_dense([ckpt.raw_dense(nm) for nm in names], order,
                              device=dev)
        if len(kinds) != 1:
            raise ValueError(f"cannot fuse mixed tensor kinds {kinds}")
        return fuse_packed([ckpt.raw_q4_planes(nm) for nm in names], order,
                           device=dev)

    total = hp.n_layer + 3
    layers = []
    for i in range(hp.n_layer):
        p = f"layers.{i}."
        n_ff = ckpt.tensors[p + "feed_forward.w1.weight"]["shape"][1]
        layers.append(LayerParams(
            attention_norm=dense(p + "attention_norm.weight"),
            wqkv=fused([p + "attention.wq.weight", p + "attention.wk.weight",
                        p + "attention.wv.weight"],
                       qkv_col_order(hp.n_head, hp.head_dim)),
            wo=single(p + "attention.wo.weight"),
            ffn_norm=dense(p + "ffn_norm.weight"),
            w13=fused([p + "feed_forward.w1.weight",
                       p + "feed_forward.w3.weight"], w13_col_order(n_ff)),
            w2=single(p + "feed_forward.w2.weight"),
        ))
        logger.progress(ProgressTag.LOAD, i + 1, total)

    meta = ckpt.tensors["tok_embeddings.weight"]
    if meta["kind"] == "q4_embedding":
        v, d = meta["shape"]
        emb = QuantEmbedding(
            qs=torch.from_numpy(np.array(ckpt._payload(
                meta["qs"], np.uint8, (v, d // 2)))).to(dev),
            scales=torch.from_numpy(np.array(ckpt._payload(
                meta["scales"], np.float32, (v, d // QK4_0)))).to(dev))
    else:
        emb = dense("tok_embeddings.weight")
    logger.progress(ProgressTag.LOAD, total - 1, total)
    out = single("output.weight")
    logger.progress(ProgressTag.LOAD, total, total)
    return LlamaParams(tok_embeddings=emb, norm=dense("norm.weight"),
                       output=out, layers=layers)
