"""Checkpoint conversion into the fltpu format (PyTorch port).

The port's own copy of the JAX package's io/convert.py, on the port's
modules: the same functions write the same bytes. Three entry paths
(covering the reference's scripts/convert.py:662-839 input matrix):
  * ggml family (GGML/GGMF/GGJT, incl. multi-file shards): q4_0 payloads are
    repacked bit-for-bit (no requantization); f16/f32 payloads are quantized
    to the requested ftype or stored dense.
  * HuggingFace LLaMA directories (torch .bin or .safetensors shards): the
    reference's name mapping (convert.py:586-607) and wq/wk head permutation
    (convert.py:902-905) are applied, then tensors are quantized.
  * quantize: any readable input re-emitted at a different ftype — the
    equivalent of the reference quantize tool (lib/llama.cpp:501-680).

Quantization is the bit-exact q4_0 of quant/q4.py: the native threaded
quantizer (quant/native.py) when it builds, else numpy chunked over rows in
a thread pool; both give the same bytes whatever the worker count. This is
host code: nothing here touches a device.
"""
from __future__ import annotations

import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..config import FType, HyperParams
from ..engine.logger import Logger, NULL_LOGGER, ProgressTag
from ..engine.tokenizer import Vocab
from ..quant.q4 import quantize_q4_0
from .checkpoint import CheckpointWriter
from .ggml_reader import (
    GGML_TYPE_Q4_0, read_ggml_checkpoint,
)

# HF name -> ggml name mapping (reference: convert_transformers_to_orig,
# scripts/convert.py:586-607)
_HF_STATIC = {
    "model.embed_tokens.weight": "tok_embeddings.weight",
    "model.norm.weight": "norm.weight",
    "lm_head.weight": "output.weight",
}
_HF_LAYER = {
    "self_attn.q_proj.weight": "attention.wq.weight",
    "self_attn.k_proj.weight": "attention.wk.weight",
    "self_attn.v_proj.weight": "attention.wv.weight",
    "self_attn.o_proj.weight": "attention.wo.weight",
    "mlp.gate_proj.weight": "feed_forward.w1.weight",
    "mlp.down_proj.weight": "feed_forward.w2.weight",
    "mlp.up_proj.weight": "feed_forward.w3.weight",
    "input_layernorm.weight": "attention_norm.weight",
    "post_attention_layernorm.weight": "ffn_norm.weight",
}


def hf_to_ggml_name(name: str) -> str | None:
    if name in _HF_STATIC:
        return _HF_STATIC[name]
    m = re.match(r"model\.layers\.(\d+)\.(.+)", name)
    if m and m.group(2) in _HF_LAYER:
        return f"layers.{m.group(1)}.{_HF_LAYER[m.group(2)]}"
    return None


def permute_qk(w: np.ndarray, n_head: int) -> np.ndarray:
    """HF rotate-half -> ggml interleaved RoPE weight permutation
    (reference: scripts/convert.py:902-905)."""
    return (w.reshape(n_head, 2, w.shape[0] // n_head // 2, *w.shape[1:])
             .swapaxes(1, 2)
             .reshape(w.shape))


def _is_quantizable(name: str, shape) -> bool:
    """2-D weight tensors are quantized; 1-D stay f32 (lib/llama.cpp:558-572)."""
    return len(shape) == 2


def _quantize_rows_parallel(dense: np.ndarray, workers: int = 0):
    """Parallel bit-exact q4_0 quantization (native threaded kernel when
    built, else chunked numpy over a thread pool)."""
    from ..quant import native
    if native.available() and dense.ndim == 2:
        return native.quantize_q4_0(dense)

    n = dense.shape[0]
    workers = workers or min(8, os.cpu_count() or 1)
    chunk = max(1, n // (workers * 4))
    codes = np.empty(dense.shape, np.uint8)
    scales = np.empty((n, dense.shape[1] // 32), np.float32)

    def work(lo):
        hi = min(lo + chunk, n)
        c, s = quantize_q4_0(dense[lo:hi])
        codes[lo:hi] = c
        scales[lo:hi] = s

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(work, range(0, n, chunk)))
    return codes, scales


def _emit(writer: CheckpointWriter, name: str, get_dense, get_q4,
          ftype: FType, logger: Logger) -> None:
    """Write one tensor in the output ftype. get_q4 is a callable returning
    (codes, scales) when the source is already q4_0 (pass-through), else None.
    """
    is_embedding = name == "tok_embeddings.weight"
    if ftype == FType.MOSTLY_Q4_0:
        q = get_q4() if get_q4 else None
        if q is None:
            dense = get_dense()
            if not _is_quantizable(name, dense.shape):
                writer.add_dense(name, dense.astype(np.float32))
                return
            q = _quantize_rows_parallel(dense)
        codes, scales = q
        if is_embedding:
            writer.add_q4_embedding(name, codes, scales)
        else:
            writer.add_q4_matmul(name, codes, scales)
    else:
        dense = get_dense()
        if len(dense.shape) == 2 and not is_embedding:
            # matmul weights stored pre-transposed [K, N] for the model
            dt = np.float16 if ftype == FType.MOSTLY_F16 else np.float32
            writer.add_dense(name, np.ascontiguousarray(dense.T).astype(dt))
        else:
            writer.add_dense(name, dense.astype(
                np.float16 if (ftype == FType.MOSTLY_F16
                               and len(dense.shape) == 2) else np.float32))


def convert_ggml(src: str, dst: str, ftype: FType = FType.MOSTLY_Q4_0,
                 logger: Logger = NULL_LOGGER) -> None:
    from .ggml_reader import GGML_TYPE_Q4_1
    ckpt = read_ggml_checkpoint(src)
    hp = ckpt.hyperparams
    writer = CheckpointWriter(dst, hp, ckpt.vocab, ftype)
    names = ckpt.tensor_names()
    for i, name in enumerate(names):
        logger.progress(ProgressTag.QUANTIZE, i, len(names))
        if (ckpt.tensor_type(name) == GGML_TYPE_Q4_1
                and ftype == FType.MOSTLY_Q4_1
                and name != "tok_embeddings.weight"):
            # q4_1 pass-through (no requantization)
            writer.add_q41_matmul(name, *ckpt.q4_1(name))
            continue
        src_q4 = (ckpt.tensor_type(name) == GGML_TYPE_Q4_0
                  and ftype == FType.MOSTLY_Q4_0)
        _emit(writer, name,
              get_dense=lambda nm=name: ckpt.dense(nm),
              get_q4=(lambda nm=name: ckpt.q4_0(nm)) if src_q4 else None,
              ftype=ftype, logger=logger)
    writer.finish()
    logger.progress(ProgressTag.QUANTIZE, len(names), len(names))
    logger.log("convert", f"wrote {dst}\n")


class _LazyHFTensors:
    """Lazy per-tensor view of an HF LLaMA directory.

    The reference converter is a lazy loader (scripts/convert.py:662-723) so
    a 65B f16 checkpoint (~130 GB) never has to fit in host RAM; this mirrors
    that contract. safetensors shards are opened once and individual tensors
    materialized on access; torch .bin shards are opened with mmap=True where
    the format allows (zipfile checkpoints), falling back to one eagerly
    loaded shard at a time. Peak RSS stays O(largest tensor) for safetensors
    and O(one shard, OS-evictable) for mmap'd bins.
    """

    def __init__(self, hf_dir: Path):
        self._loaders: dict[str, object] = {}
        st_files = sorted(hf_dir.glob("*.safetensors"))
        if st_files:
            from safetensors import safe_open
            self._handles = [safe_open(str(p), framework="numpy")
                             for p in st_files]
            for h in self._handles:
                for k in h.keys():
                    self._loaders[k] = (lambda h=h, k=k:
                                        np.asarray(h.get_tensor(k)))
            return
        import torch
        for p in sorted(hf_dir.glob("pytorch_model*.bin")):
            try:
                sd = torch.load(str(p), map_location="cpu",
                                weights_only=True, mmap=True)
            except (TypeError, RuntimeError):
                # legacy (non-zip) checkpoints cannot mmap; eager per shard
                sd = torch.load(str(p), map_location="cpu", weights_only=True)
            for k, v in sd.items():
                self._loaders[k] = (lambda v=v:
                                    v.to(torch.float32).numpy())

    def __contains__(self, k):
        return k in self._loaders

    def __iter__(self):
        return iter(self._loaders)

    def __len__(self):
        return len(self._loaders)

    def __getitem__(self, k):
        return self._loaders[k]()

    def keys(self):
        return self._loaders.keys()

    def items(self):
        """Generator of (name, tensor) — materializes one tensor at a time."""
        for k in self._loaders:
            yield k, self._loaders[k]()


def _load_hf_tensors(hf_dir: Path) -> _LazyHFTensors:
    """Lazy tensor mapping over an HF LLaMA directory (safetensors preferred).
    Tensors are read from disk only when indexed — never all at once."""
    return _LazyHFTensors(hf_dir)


def _piece_to_bytes(piece: str) -> bytes:
    if re.fullmatch(r"<0x[0-9A-Fa-f]{2}>", piece):
        return bytes([int(piece[3:-1], 16)])
    return piece.replace("▁", " ").encode("utf-8")


def _hf_vocab(hf_dir: Path) -> Vocab:
    """Build a scored vocab from tokenizer.model (SentencePiece) or, when the
    sentencepiece package is unavailable, from tokenizer.json.

    tokenizer.json fallback: Unigram models carry real scores; BPE exports
    don't, so score = -id is used (SentencePiece ids are frequency-ordered),
    which preserves greedy-merge behavior well in practice."""
    try:
        import sentencepiece as spm
    except ImportError:
        spm = None
    if spm is not None and (hf_dir / "tokenizer.model").exists():
        sp = spm.SentencePieceProcessor()
        sp.Load(str(hf_dir / "tokenizer.model"))
        toks = []
        for i in range(sp.GetPieceSize()):
            piece = sp.IdToPiece(i)
            if sp.IsByte(i):
                text = bytes([int(piece[3:-1], 16)])   # "<0xNN>"
            else:
                text = piece.replace("▁", " ").encode("utf-8")
            toks.append((text, float(sp.GetScore(i))))
        return Vocab.from_tokens(toks)

    with open(hf_dir / "tokenizer.json", encoding="utf-8") as f:
        tj = json.load(f)
    model = tj["model"]
    if model.get("type") == "Unigram":
        pieces = model["vocab"]            # [[piece, score], ...]
        out = [(_piece_to_bytes(p), float(s)) for p, s in pieces]
        return Vocab.from_tokens(out)
    vocab_map = model["vocab"]             # {piece: id}
    n = max(vocab_map.values()) + 1
    out = [(b"", 0.0)] * n
    for piece, idx in vocab_map.items():
        out[idx] = (_piece_to_bytes(piece), -float(idx))
    return Vocab.from_tokens(out)


def _gptq_to_q4_1(tensors: dict, namebase: str):
    """GPTQ-for-LLaMa tensor group -> q4_1 (codes [N,K], d, m [N,K/32]).

    Mirrors the reference's GPTQForLLaMaQuantizedTensor
    (scripts/convert.py:364-478): nibbles little-endian within each int32,
    zeros from qzeros via (z+1)*scale, addends = -zeros, regrouped from the
    GPTQ groupsize (usually 128) to 32. g_idx reordering is unsupported.
    """
    if f"{namebase}.g_idx" in tensors:
        g = np.asarray(tensors[f"{namebase}.g_idx"])
        if not np.array_equal(g, np.sort(g)):
            raise ValueError(f"{namebase}: act-order (g_idx) GPTQ models are "
                             "not supported")
    qweight = np.asarray(tensors[f"{namebase}.qweight"], np.int32)  # [K/8, N]
    scales = np.asarray(tensors[f"{namebase}.scales"], np.float32)

    def unpack_nibbles_le(packed_i32):
        """int32 array -> 8 nibbles each, little-endian nibble order."""
        b = packed_i32.view(np.uint8)           # 4 bytes per int32, LE
        out = np.empty(packed_i32.shape[:-1] + (packed_i32.shape[-1] * 8,),
                       np.uint8)
        b = b.reshape(packed_i32.shape[0], packed_i32.shape[1] * 4)
        out[:, 0::2] = b & 0x0F
        out[:, 1::2] = b >> 4
        return out

    # qweight is [K/8, N]: transpose first -> [N, K/8] then unpack along K
    codes = unpack_nibbles_le(np.ascontiguousarray(qweight.T))  # [N, K]

    if f"{namebase}.zeros" in tensors:
        zeros = np.asarray(tensors[f"{namebase}.zeros"], np.float32)
    else:
        # qzeros is [groups, N/8] packed along N; unpack along its last axis
        qzeros = np.asarray(tensors[f"{namebase}.qzeros"], np.int32)
        zq = unpack_nibbles_le(np.ascontiguousarray(qzeros))    # [groups, N]
        zeros = (zq.astype(np.float32) + 1.0) * scales
    # scales/zeros: new GPTQ = [groups, N]; old = [N, 1]
    if scales.ndim == 2 and scales.shape[1] != 1 and scales.shape[0] != codes.shape[0]:
        scales = scales.T                                     # -> [N, groups]
        zeros = zeros.T
    addends = -zeros

    n, k = codes.shape
    groups = scales.shape[1]
    if k % groups:
        raise ValueError(f"{namebase}: k={k} not divisible by groups={groups}")
    rep = (k // groups) // 32
    d = np.repeat(scales, rep, axis=1)
    m = np.repeat(addends, rep, axis=1)
    return codes, d.astype(np.float32), m.astype(np.float32)


def _is_gptq(tensors: dict) -> bool:
    return any(k.endswith(".qweight") for k in tensors)


def convert_hf(hf_dir: str, dst: str, ftype: FType = FType.MOSTLY_Q4_0,
               n_ctx: int = 2048, logger: Logger = NULL_LOGGER) -> None:
    hf_dir = Path(hf_dir)
    tensors = _load_hf_tensors(hf_dir)
    with open(hf_dir / "config.json") as f:
        cfg = json.load(f)

    n_embd = cfg["hidden_size"]
    n_head = cfg["num_attention_heads"]
    gptq = _is_gptq(tensors)
    if gptq:
        ftype = FType.MOSTLY_Q4_1
    hp = HyperParams(
        n_vocab=cfg["vocab_size"], n_ctx=n_ctx, n_embd=n_embd, n_mult=256,
        n_head=n_head, n_layer=cfg["num_hidden_layers"],
        n_rot=n_embd // n_head, ftype=ftype)
    vocab = _hf_vocab(hf_dir)
    writer = CheckpointWriter(dst, hp, vocab, ftype)

    if gptq:
        logger.log("convert", "GPTQ checkpoint detected -> q4_1 repack "
                   "(no requantization)\n")
        bases = sorted({k.rsplit(".qweight", 1)[0]
                        for k in tensors if k.endswith(".qweight")})
        done = 0
        total = len(bases) + sum(1 for k in tensors
                                 if hf_to_ggml_name(k) and k.endswith(".weight"))
        for base in bases:
            ggml_name = hf_to_ggml_name(base + ".weight")
            if ggml_name is None:
                continue
            codes, d, m = _gptq_to_q4_1(tensors, base)
            if ggml_name.endswith("attention.wq.weight") or \
                    ggml_name.endswith("attention.wk.weight"):
                codes = permute_qk(codes, n_head)
                d = permute_qk(d, n_head)
                m = permute_qk(m, n_head)
            writer.add_q41_matmul(ggml_name, codes, d, m)
            done += 1
            logger.progress(ProgressTag.QUANTIZE, done, total)
        # remaining unquantized tensors (norms, embeddings, lm head) —
        # name-filter first so only needed tensors are ever materialized
        for hf_name in tensors:
            if not hf_name.endswith(".weight"):
                continue
            ggml_name = hf_to_ggml_name(hf_name)
            if ggml_name is None or ggml_name in writer.tensors:
                continue
            w = np.asarray(tensors[hf_name], np.float32)
            if ggml_name.endswith("attention.wq.weight") or \
                    ggml_name.endswith("attention.wk.weight"):
                w = permute_qk(w, n_head)
            _emit(writer, ggml_name, get_dense=lambda w=w: w, get_q4=None,
                  ftype=FType.MOSTLY_F16, logger=logger)
            done += 1
            logger.progress(ProgressTag.QUANTIZE, done, total)
    else:
        items = [(hf, hf_to_ggml_name(hf)) for hf in tensors]
        items = [(hf, g) for hf, g in items if g is not None]
        for i, (hf_name, ggml_name) in enumerate(items):
            logger.progress(ProgressTag.QUANTIZE, i, len(items))
            w = np.asarray(tensors[hf_name])
            if ggml_name.endswith("attention.wq.weight") or \
                    ggml_name.endswith("attention.wk.weight"):
                w = permute_qk(w, n_head)
            _emit(writer, ggml_name, get_dense=lambda w=w: w.astype(np.float32),
                  get_q4=None, ftype=ftype, logger=logger)
        logger.progress(ProgressTag.QUANTIZE, len(items), len(items))
    writer.finish()
    logger.log("convert", f"wrote {dst}\n")


def quantize(src: str, dst: str, ftype: FType = FType.MOSTLY_Q4_0,
             logger: Logger = NULL_LOGGER) -> None:
    """Offline quantizer (reference: fastllama::quantize, llama.cpp:501-680;
    CLI parity with src/quantize.cpp)."""
    src_p = Path(src)
    if src_p.is_dir() and (src_p / "config.json").exists():
        convert_hf(src, dst, ftype, logger=logger)
    else:
        convert_ggml(src, dst, ftype, logger=logger)


def export_ggjt(src: str, dst: str, ftype: FType = FType.MOSTLY_Q4_0,
                logger: Logger = NULL_LOGGER) -> None:
    """Export any readable checkpoint (fltpu dir / ggml file / HF dir) as a
    GGJT file the reference ecosystem can load. q4_0 sources pass through
    bit-exactly; dense sources are quantized per ftype."""
    from ..quant.tensor import planes_to_codes, split_unpack_lastdim
    from .checkpoint import open_checkpoint
    from .ggml_writer import write_ggjt

    src_p = Path(src)
    tensors: dict[str, tuple] = {}

    if src_p.is_dir() and (src_p / "manifest.json").exists():
        ckpt = open_checkpoint(src_p)
        hp, vocab = ckpt.hp, ckpt.vocab
        for name, meta in ckpt.tensors.items():
            kind = meta["kind"]
            if kind == "q4_matmul":
                qs, sc = ckpt.raw_q4_planes(name)
                k, n = meta["shape"]
                tensors[name] = ("q4_0",) + planes_to_codes(qs, sc, k, n)
            elif kind == "q41_matmul":
                # unpack affine planes back to row-major q4_1
                qs, sc, mn = ckpt.raw_q4_planes(name)
                k, n = meta["shape"]
                codes, scales = planes_to_codes(qs, sc, k, n)
                mins = np.ascontiguousarray(mn[: k // 32, :n].T)
                tensors[name] = ("q4_1", codes, scales, mins)
            elif kind == "q4_embedding":
                v, d = meta["shape"]
                qs = ckpt._payload(meta["qs"], np.uint8, (v, d // 2))
                sc = ckpt._payload(meta["scales"], np.float32, (v, d // 32))
                tensors[name] = ("q4_0", split_unpack_lastdim(qs), sc)
            else:
                arr = ckpt.raw_dense(name)
                if arr.ndim == 2 and name != "tok_embeddings.weight":
                    arr = np.ascontiguousarray(arr.T)   # back to [N, K]
                kind_out = "f16" if arr.dtype == np.float16 else "f32"
                tensors[name] = (kind_out, arr)
        write_ggjt(dst, hp, vocab, tensors)
    else:
        if src_p.is_dir() and (src_p / "config.json").exists():
            import tempfile
            with tempfile.TemporaryDirectory() as tmp:
                convert_hf(src, tmp + "/x.fltpu", ftype, logger=logger)
                export_ggjt(tmp + "/x.fltpu", dst, ftype, logger=logger)
                return
        ckpt = read_ggml_checkpoint(src)
        hp, vocab = ckpt.hyperparams, ckpt.vocab
        for name in ckpt.tensor_names():
            ttype = ckpt.tensor_type(name)
            if ttype == GGML_TYPE_Q4_0 and ftype == FType.MOSTLY_Q4_0:
                tensors[name] = ("q4_0",) + ckpt.q4_0(name)
            else:
                dense = ckpt.dense(name)
                if dense.ndim == 2 and ftype == FType.MOSTLY_Q4_0:
                    tensors[name] = ("q4_0",) + _quantize_rows_parallel(dense)
                else:
                    tensors[name] = ("f32", dense)
        write_ggjt(dst, hp, vocab, tensors)
    logger.log("export_ggjt", f"wrote {dst}\n")
