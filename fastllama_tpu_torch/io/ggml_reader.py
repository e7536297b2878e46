"""Reader for ggml-family model files (GGML / GGMF / GGJT) and ggla LoRA
adapters, so checkpoints made for the reference load directly. Numpy only;
the port's own copy of the JAX package's reader (same behaviour).

File layout understood (reference: include/file_loader.hpp:94-250 and
scripts/convert.py:899-928):

  magic u32 ('ggml'/'ggmf'/'ggjt'/'ggla') [+ version u32 unless bare GGML]
  hyperparams: n_vocab n_embd n_mult n_head n_layer n_rot ftype (7 x i32)
    (ggla instead: use_cache u32(bool as i32), r u32, alpha u32)
  vocab: n_vocab x { len u32, bytes, score f32 (GGMF+) }
  tensors: { n_dims u32, name_len u32, type u32, extents i32[n_dims],
             name bytes, [GGJT: pad to 32-byte offset], data }

ggml extents are fastest-varying-first: a 2-D tensor with extents [e0, e1]
is a numpy array of shape (e1, e0). Multi-file shards (".1", ".2" suffixes)
are reassembled with the reference's name-based axis rule
(tensor/utils.hpp:101-112): tok_embeddings / wo / w2 concatenate along
columns (axis 1), everything else along rows (axis 0).
"""
from __future__ import annotations

import dataclasses
import os
import struct
from pathlib import Path

import numpy as np

from ..config import FType, HyperParams
from ..engine.tokenizer import Vocab
from ..quant import q4

MAGIC_GGML = 0x67676D6C
MAGIC_GGMF = 0x67676D66
MAGIC_GGJT = 0x67676A74
MAGIC_GGLA = 0x67676C61

GGML_TYPE_F32 = 0
GGML_TYPE_F16 = 1
GGML_TYPE_Q4_0 = 2
GGML_TYPE_Q4_1 = 3

TYPE_NAMES = {0: "f32", 1: "f16", 2: "q4_0", 3: "q4_1", 4: "q4_2", 5: "q4_3",
              6: "q8_0"}


def _row_bytes(ggml_type: int, ne0: int) -> int:
    if ggml_type == GGML_TYPE_F32:
        return ne0 * 4
    if ggml_type == GGML_TYPE_F16:
        return ne0 * 2
    if ggml_type == GGML_TYPE_Q4_0:
        return (ne0 // q4.QK4_0) * q4.Q4_0_BLOCK_BYTES
    if ggml_type == GGML_TYPE_Q4_1:
        return (ne0 // q4.QK4_1) * q4.Q4_1_BLOCK_BYTES
    raise ValueError(f"unsupported ggml tensor type {ggml_type}")


@dataclasses.dataclass
class TensorRecord:
    name: str
    ggml_type: int
    shape: tuple[int, ...]     # numpy orientation: (rows, cols) = (ne1, ne0)
    file_idx: int
    offset: int
    size: int

    def read_dense(self, mm: np.memmap) -> np.ndarray:
        """Materialize as float32 numpy (dequantizing if needed)."""
        raw = np.asarray(mm[self.offset:self.offset + self.size])
        if self.ggml_type == GGML_TYPE_F32:
            return raw.view(np.float32).reshape(self.shape).copy()
        if self.ggml_type == GGML_TYPE_F16:
            return raw.view(np.float16).reshape(self.shape).astype(np.float32)
        if self.ggml_type == GGML_TYPE_Q4_0:
            codes, scales = q4.q4_0_from_wire(raw, self.shape)
            return q4.dequantize_q4_0(codes, scales)
        if self.ggml_type == GGML_TYPE_Q4_1:
            codes, d, m = q4.q4_1_from_wire(raw, self.shape)
            return q4.dequantize_q4_1(codes, d, m)
        raise ValueError(f"unsupported tensor type {self.ggml_type}")

    def read_q4_0(self, mm: np.memmap) -> tuple[np.ndarray, np.ndarray]:
        """Read q4_0 payload as (codes [N,K] uint8, scales [N,K/32] f32)."""
        if self.ggml_type != GGML_TYPE_Q4_0:
            raise ValueError(f"{self.name} is {TYPE_NAMES[self.ggml_type]}, not q4_0")
        raw = np.asarray(mm[self.offset:self.offset + self.size])
        return q4.q4_0_from_wire(raw, self.shape)

    def read_q4_1(self, mm: np.memmap):
        """Read q4_1 payload as (codes, scales d, mins m) — w = q*d + m."""
        if self.ggml_type != GGML_TYPE_Q4_1:
            raise ValueError(f"{self.name} is {TYPE_NAMES[self.ggml_type]}, not q4_1")
        raw = np.asarray(mm[self.offset:self.offset + self.size])
        return q4.q4_1_from_wire(raw, self.shape)


@dataclasses.dataclass
class GgmlFile:
    path: str
    magic: int
    version: int
    hyperparams: HyperParams | None
    lora_params: dict | None
    vocab: Vocab | None
    tensors: dict[str, TensorRecord]
    _mm: np.memmap = None

    @property
    def mm(self) -> np.memmap:
        if self._mm is None:
            self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        return self._mm

    def dense(self, name: str) -> np.ndarray:
        return self.tensors[name].read_dense(self.mm)

    def q4_0(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        return self.tensors[name].read_q4_0(self.mm)

    def raw(self, name: str) -> np.ndarray:
        """Raw wire bytes of a tensor payload (memmap view)."""
        t = self.tensors[name]
        return self.mm[t.offset:t.offset + t.size]


def read_ggml_file(path: str | Path, file_idx: int = 0) -> GgmlFile:
    path = str(path)
    with open(path, "rb") as f:
        magic, = struct.unpack("<I", f.read(4))
        if magic not in (MAGIC_GGML, MAGIC_GGMF, MAGIC_GGJT, MAGIC_GGLA):
            raise ValueError(f"{path}: bad magic {magic:#x}; not a ggml file")
        version = 0
        if magic != MAGIC_GGML:
            version, = struct.unpack("<I", f.read(4))

        hyperparams = None
        lora_params = None
        vocab = None
        if magic == MAGIC_GGLA:
            # use_cache is a single byte (struct.pack("?"),
            # convert-lora-to-ggml.py:55); r/alpha are u32.
            use_cache, = struct.unpack("<?", f.read(1))
            r, alpha = struct.unpack("<II", f.read(8))
            lora_params = {"use_cache_matrix": bool(use_cache),
                           "r": r, "alpha": alpha}
        else:
            (n_vocab, n_embd, n_mult, n_head, n_layer, n_rot,
             ftype) = struct.unpack("<7i", f.read(28))
            hyperparams = HyperParams(
                n_vocab=n_vocab, n_embd=n_embd, n_mult=n_mult, n_head=n_head,
                n_layer=n_layer, n_rot=n_rot, ftype=FType(ftype))
            has_scores = magic != MAGIC_GGML
            toks = []
            for _ in range(n_vocab):
                ln, = struct.unpack("<I", f.read(4))
                word = f.read(ln)
                score = struct.unpack("<f", f.read(4))[0] if has_scores else 0.0
                toks.append((word, score))
            vocab = Vocab.from_tokens(toks)

        file_size = os.path.getsize(path)
        tensors: dict[str, TensorRecord] = {}
        while f.tell() < file_size:
            head = f.read(12)
            if len(head) < 12:
                break
            n_dims, name_len, ttype = struct.unpack("<III", head)
            if n_dims < 1 or n_dims > 2:
                raise ValueError(f"{path}: tensor with {n_dims} dims")
            extents = struct.unpack(f"<{n_dims}i", f.read(4 * n_dims))
            name = f.read(name_len).decode("utf-8")
            if magic in (MAGIC_GGJT, MAGIC_GGLA):
                # GGJT and ggla both 32-byte-align tensor data (the reference
                # maps ggla to file version GGJT_V1, file_loader.hpp:130-133)
                f.seek(-f.tell() & 31, os.SEEK_CUR)
            offset = f.tell()
            ne0 = extents[0]
            rows = extents[1] if n_dims == 2 else 1
            size = _row_bytes(ttype, ne0) * rows
            shape = (rows, ne0) if n_dims == 2 else (ne0,)
            tensors[name] = TensorRecord(
                name=name, ggml_type=ttype, shape=shape,
                file_idx=file_idx, offset=offset, size=size)
            f.seek(size, os.SEEK_CUR)

    return GgmlFile(path=path, magic=magic, version=version,
                    hyperparams=hyperparams, lora_params=lora_params,
                    vocab=vocab, tensors=tensors)


def find_shard_files(path: str | Path) -> list[str]:
    """Multi-file checkpoints use bare path + '.1', '.2', ... suffixes
    (reference: file_loader.hpp:443-453)."""
    path = str(path)
    out = [path]
    i = 1
    while os.path.exists(f"{path}.{i}"):
        out.append(f"{path}.{i}")
        i += 1
    return out


# name-based shard merge axis (tensor/utils.hpp:101-112); numpy orientation
# (rows, cols): ByColumns in ggml (ne0, the fast axis) = numpy axis 1.
def shard_concat_axis(name: str) -> int:
    if (name.startswith("tok_embeddings.")
            or ".attention.wo.weight" in name
            or ".feed_forward.w2.weight" in name):
        return 1
    return 0


@dataclasses.dataclass
class GgmlCheckpoint:
    """A (possibly sharded) ggml model checkpoint."""
    files: list[GgmlFile]

    @property
    def hyperparams(self) -> HyperParams:
        # n_vocab/n_embd of the first file describe the merged model
        # already; only sharded tensor extents differ per file
        return self.files[0].hyperparams

    @property
    def vocab(self) -> Vocab:
        return self.files[0].vocab

    def tensor_names(self) -> list[str]:
        return list(self.files[0].tensors.keys())

    def dense(self, name: str) -> np.ndarray:
        parts = []
        for fl in self.files:
            if name in fl.tensors:
                parts.append(fl.dense(name))
        if not parts:
            raise KeyError(name)
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts, axis=shard_concat_axis(name))

    def q4_0(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        parts = [fl.q4_0(name) for fl in self.files if name in fl.tensors]
        if not parts:
            raise KeyError(name)
        if len(parts) == 1:
            return parts[0]
        ax = shard_concat_axis(name)
        codes = np.concatenate([p[0] for p in parts], axis=ax)
        scales = np.concatenate([p[1] for p in parts], axis=ax)
        return codes, scales

    def q4_1(self, name: str):
        parts = [fl.tensors[name].read_q4_1(fl.mm)
                 for fl in self.files if name in fl.tensors]
        if not parts:
            raise KeyError(name)
        if len(parts) == 1:
            return parts[0]
        ax = shard_concat_axis(name)
        return tuple(np.concatenate([p[i] for p in parts], axis=ax)
                     for i in range(3))

    def tensor_type(self, name: str) -> int:
        return self.files[0].tensors[name].ggml_type

    def raw_single(self, name: str):
        """(wire bytes, (rows, cols)) when the tensor lives whole in one file
        (what a native repack would read); None for multi-file shards."""
        holders = [fl for fl in self.files if name in fl.tensors]
        if len(holders) != 1:
            return None
        fl = holders[0]
        return fl.raw(name), fl.tensors[name].shape


def read_ggml_checkpoint(path: str | Path) -> GgmlCheckpoint:
    files = [read_ggml_file(p, i) for i, p in enumerate(find_shard_files(path))]
    return GgmlCheckpoint(files=files)
