"""PyTorch port: the offline converters (fastllama_tpu_torch/io/convert.py)
write byte-identical files to the JAX package's on the same fixtures
(GGJT q4_0 / q4_1 / f16 files, HF directories as safetensors shards or a
torch .bin, a GPTQ directory), and the HF loader is lazy."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fastllama_tpu.io import convert as jc
from fastllama_tpu.io import ggml_writer as jw
from fastllama_tpu_torch.config import FType, HyperParams
from fastllama_tpu_torch.engine.tokenizer import Vocab
from fastllama_tpu_torch.io import convert as tc
from fastllama_tpu_torch.quant import native
from fastllama_tpu_torch.quant.q4 import quantize_q4_0, quantize_q4_1

from test_hf_convert import _make_hf_dir, _write_tokenizer_json

torch.set_num_threads(1)

HP = HyperParams(n_vocab=300, n_embd=64, n_mult=32, n_head=4, n_layer=2,
                 n_rot=16, ftype=FType.MOSTLY_Q4_0)


def tiny_vocab():
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" t{i}".encode(), 1.0) for i in range(HP.n_vocab - 259)]
    return Vocab.from_tokens(toks)


def ggml_tensors(kind, seed=11):
    """A 2-layer model's tensors in ggml orientation; matmuls of `kind`."""
    rng = np.random.default_rng(seed)
    d, f = HP.n_embd, HP.n_ff

    def w(out, inn):
        dense = (rng.standard_normal((out, inn)) * 0.15).astype(np.float32)
        if kind == "q4_0":
            return ("q4_0",) + quantize_q4_0(dense)
        if kind == "q4_1":
            return ("q4_1",) + quantize_q4_1(dense + 0.02)
        return ("f16", dense)

    ones = ("f32", np.ones(d, np.float32))
    t = {"tok_embeddings.weight": w(HP.n_vocab, d), "norm.weight": ones,
         "output.weight": w(HP.n_vocab, d)}
    for i in range(HP.n_layer):
        p = f"layers.{i}."
        t[p + "attention_norm.weight"] = ones
        t[p + "ffn_norm.weight"] = ones
        for nm in ("wq", "wk", "wv", "wo"):
            t[p + f"attention.{nm}.weight"] = w(d, d)
        t[p + "feed_forward.w1.weight"] = w(f, d)
        t[p + "feed_forward.w3.weight"] = w(f, d)
        t[p + "feed_forward.w2.weight"] = w(d, f)
    return t


@pytest.fixture(scope="module")
def ggml_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("conv_ggml")
    out = {}
    for kind in ("q4_0", "q4_1", "f16"):
        out[kind] = str(root / f"tiny_{kind}.bin")
        jw.write_ggjt(out[kind], HP, tiny_vocab(), ggml_tensors(kind))
    return out


def gptq_dir(hf_dir: Path, rng, d=64, heads=4, layers=2, vocab=300,
             n_ff=256, groupsize=32):
    """A GPTQ-for-LLaMa style directory: qweight/scales/qzeros per
    projection (qweight [K/8, N], scales [groups, N], qzeros [groups, N/8],
    little-endian nibbles), f32 embeddings, norms and head."""
    from safetensors.numpy import save_file
    hf_dir.mkdir(parents=True)
    with open(hf_dir / "config.json", "w") as f:
        json.dump({"hidden_size": d, "num_attention_heads": heads,
                   "num_hidden_layers": layers, "vocab_size": vocab}, f)
    _write_tokenizer_json(hf_dir, vocab)

    def pack_le(nib, axis):
        nib = np.moveaxis(nib, axis, 0)
        out = np.zeros((nib.shape[0] // 8,) + nib.shape[1:], np.uint32)
        for j in range(8):
            out |= nib[j::8].astype(np.uint32) << (4 * j)
        return np.ascontiguousarray(np.moveaxis(out, 0, axis)).view(np.int32)

    t = {"model.embed_tokens.weight":
         (rng.standard_normal((vocab, d)) * 0.4).astype(np.float32),
         "model.norm.weight": np.ones(d, np.float32),
         "lm_head.weight": (rng.standard_normal((vocab, d)) * 0.15
                            ).astype(np.float32)}
    shapes = {"self_attn.q_proj": (d, d), "self_attn.k_proj": (d, d),
              "self_attn.v_proj": (d, d), "self_attn.o_proj": (d, d),
              "mlp.gate_proj": (n_ff, d), "mlp.up_proj": (n_ff, d),
              "mlp.down_proj": (d, n_ff)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = np.ones(d, np.float32)
        t[p + "post_attention_layernorm.weight"] = np.ones(d, np.float32)
        for sub, (n, k) in shapes.items():
            groups = k // groupsize
            t[p + sub + ".qweight"] = pack_le(
                rng.integers(0, 16, (k, n), dtype=np.uint8), 0)
            t[p + sub + ".scales"] = rng.uniform(
                0.01, 0.1, (groups, n)).astype(np.float32)
            t[p + sub + ".qzeros"] = pack_le(
                rng.integers(0, 16, (groups, n), dtype=np.uint8), 1)
    save_file(t, str(hf_dir / "model.safetensors"))


def torch_bin_dir(hf_dir: Path, rng):
    """The safetensors fixture re-saved as one torch pytorch_model.bin."""
    tensors = _make_hf_dir(hf_dir, rng, n_shards=1)
    for p in hf_dir.glob("*.safetensors"):
        p.unlink()
    torch.save({k: torch.from_numpy(v).to(torch.float16)
                for k, v in tensors.items()},
               str(hf_dir / "pytorch_model.bin"))


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("conv_hf")
    _make_hf_dir(root / "st", np.random.default_rng(1))
    torch_bin_dir(root / "bin", np.random.default_rng(2))
    gptq_dir(root / "gptq", np.random.default_rng(3))
    return {k: str(root / k) for k in ("st", "bin", "gptq")}


def files_of(path: Path) -> dict:
    path = Path(path)
    if path.is_file():
        return {"": path.read_bytes()}
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


def assert_same_output(a, b):
    fa, fb = files_of(a), files_of(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], f"{name} differs"


def both(tmp_path, fn_name, src, *args, dst_name="out.fltpu", **kw):
    """Run the JAX and the port's function on the same input; the two
    output paths."""
    out = []
    for side, mod in (("jax", jc), ("torch", tc)):
        dst = tmp_path / side / dst_name
        dst.parent.mkdir()
        getattr(mod, fn_name)(src, str(dst), *args, **kw)
        out.append(dst)
    return out


@pytest.mark.parametrize("kind,ftype", [
    ("q4_0", FType.MOSTLY_Q4_0), ("q4_1", FType.MOSTLY_Q4_1),
    ("f16", FType.MOSTLY_Q4_0), ("f16", FType.MOSTLY_F16),
    ("q4_0", FType.ALL_F32)])
def test_convert_ggml_byte_identical(ggml_files, tmp_path, kind, ftype):
    assert_same_output(*both(tmp_path, "convert_ggml", ggml_files[kind],
                             ftype))


@pytest.mark.parametrize("src,ftype", [
    ("st", FType.MOSTLY_Q4_0), ("st", FType.MOSTLY_F16),
    ("bin", FType.MOSTLY_Q4_0), ("gptq", FType.MOSTLY_Q4_0)])
def test_convert_hf_byte_identical(hf_dirs, tmp_path, src, ftype):
    assert_same_output(*both(tmp_path, "convert_hf", hf_dirs[src], ftype,
                             n_ctx=64))


@pytest.mark.parametrize("src", ["q4_0", "f16", "st"])
def test_quantize_byte_identical(ggml_files, hf_dirs, tmp_path, src):
    path = hf_dirs[src] if src == "st" else ggml_files[src]
    assert_same_output(*both(tmp_path, "quantize", path,
                             FType.MOSTLY_Q4_0))


@pytest.mark.parametrize("src,ftype", [
    ("fltpu q4_0", FType.MOSTLY_Q4_0), ("fltpu q4_1", FType.MOSTLY_Q4_1),
    ("fltpu f16", FType.MOSTLY_F16), ("q4_0", FType.MOSTLY_Q4_0),
    ("f16", FType.MOSTLY_Q4_0), ("f16", FType.ALL_F32),
    ("st", FType.MOSTLY_Q4_0)])
def test_export_ggjt_byte_identical(ggml_files, hf_dirs, tmp_path, src,
                                    ftype):
    if src.startswith("fltpu"):
        kind = src.split()[1]
        path = str(tmp_path / "src.fltpu")
        jc.convert_ggml(ggml_files[kind], path, ftype)
    else:
        path = hf_dirs[src] if src == "st" else ggml_files[src]
    assert_same_output(*both(tmp_path, "export_ggjt", path, ftype,
                             dst_name="out.bin"))


def test_parallel_quantizer_split_independent(monkeypatch):
    """The numpy route's row chunks and the native threads give the bytes
    of one whole-array quantization, whatever the worker count."""
    x = np.random.default_rng(4).standard_normal((37, 96)).astype(np.float32)
    want = quantize_q4_0(x)
    monkeypatch.setattr(native, "available", lambda: False)
    for workers in (1, 2, 3, 8):
        got = tc._quantize_rows_parallel(x, workers=workers)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    monkeypatch.undo()
    for a, b in zip(tc._quantize_rows_parallel(x), want):
        np.testing.assert_array_equal(a, b)


def test_lazy_loader_materializes_on_access(hf_dirs):
    """Tensors are read on access, never held: equal contents, a fresh
    array per access, for safetensors shards and a torch .bin."""
    for src in ("st", "bin"):
        lazy = tc._load_hf_tensors(Path(hf_dirs[src]))
        ref = jc._load_hf_tensors(Path(hf_dirs[src]))
        assert set(lazy) == set(ref) and len(lazy) == len(ref)
        a = lazy["model.embed_tokens.weight"]
        b = lazy["model.embed_tokens.weight"]
        assert a is not b
        np.testing.assert_array_equal(a, ref["model.embed_tokens.weight"])
        for (ka, va), (kb, vb) in zip(lazy.items(), ref.items()):
            assert ka == kb
            np.testing.assert_array_equal(va, vb)


def test_names_permutation_vocab_and_gptq_agree(hf_dirs):
    for name in ("model.embed_tokens.weight", "lm_head.weight",
                 "model.layers.5.self_attn.q_proj.weight",
                 "model.layers.0.mlp.down_proj.weight", "model.rotary.inv"):
        assert tc.hf_to_ggml_name(name) == jc.hf_to_ggml_name(name)
    w = np.random.default_rng(5).standard_normal((64, 32)).astype(np.float32)
    np.testing.assert_array_equal(tc.permute_qk(w, 4), jc.permute_qk(w, 4))
    for src in ("st", "gptq"):
        tv, jv = tc._hf_vocab(Path(hf_dirs[src])), jc._hf_vocab(
            Path(hf_dirs[src]))
        assert tv.id_to_token == jv.id_to_token
    lazy = tc._load_hf_tensors(Path(hf_dirs["gptq"]))
    base = "model.layers.1.mlp.down_proj"
    for a, b in zip(tc._gptq_to_q4_1(lazy, base),
                    jc._gptq_to_q4_1(lazy, base)):
        np.testing.assert_array_equal(a, b)


def test_bpe_tokenizer_json_vocab(tmp_path):
    """A BPE tokenizer.json (no scores): score = -id, byte pieces decoded."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, "<0x41>": 3, "▁the": 4, "ab": 5}
    with open(tmp_path / "tokenizer.json", "w", encoding="utf-8") as f:
        json.dump({"model": {"type": "BPE", "vocab": vocab}}, f)
    tv, jv = tc._hf_vocab(tmp_path), jc._hf_vocab(tmp_path)
    assert tv.id_to_token == jv.id_to_token
    assert tv.id_to_token[3] == (b"A", -3.0)
    assert tv.id_to_token[4] == (b" the", -4.0)


def test_convert_hf_peak_heap_is_bounded(tmp_path):
    """The HF convert streams tensor by tensor: its peak of traced heap
    (tracemalloc sees numpy's and safetensors' buffers) stays well under
    what holding the checkpoint costs. tests/test_hf_convert.py asks the
    same of the JAX converter through ru_maxrss, a process high-water mark
    read after heavy imports: a hold below the imports' own peak leaves it
    unchanged (its eager reading is 0 where it fails). A traced-heap peak
    does not depend on what ran before."""
    import tracemalloc
    _make_hf_dir(tmp_path / "hf", np.random.default_rng(2), d=256, heads=4,
                 layers=8, vocab=2000, n_ff=768, n_shards=3)
    total = sum(p.stat().st_size for p in (tmp_path / "hf").glob(
        "*.safetensors"))
    tracemalloc.start()
    try:
        lazy = tc._load_hf_tensors(tmp_path / "hf")
        held = {k: lazy[k] for k in lazy}
        eager = tracemalloc.get_traced_memory()[1]
        del held, lazy
        tracemalloc.reset_peak()
        tc.convert_hf(str(tmp_path / "hf"), str(tmp_path / "out.fltpu"),
                      FType.MOSTLY_F16, n_ctx=64)
        streamed = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert eager > 0.8 * total
    assert streamed < 0.6 * eager, (streamed, eager, total)
