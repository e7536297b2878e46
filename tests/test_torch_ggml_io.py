"""PyTorch port: the ggml-family reader and writer and the ggml branch of
load_model against the JAX package, on tiny GGJT files (q4_0, q4_1, f16,
f32 tensors; one sharded pair)."""
import dataclasses

import numpy as np
import pytest
import torch

from fastllama_tpu.config import FType, HyperParams
from fastllama_tpu.config import RuntimeConfig as JaxRuntimeConfig
from fastllama_tpu.engine.session import FastLlama as JaxFastLlama
from fastllama_tpu.engine.tokenizer import Vocab
from fastllama_tpu.io import ggml_reader as jr
from fastllama_tpu.io import ggml_writer as jw
from fastllama_tpu.models.loader import load_model as jax_load_model
from fastllama_tpu.quant.q4 import quantize_q4_0, quantize_q4_1
from fastllama_tpu_torch.config import RuntimeConfig
from fastllama_tpu_torch.engine.logger import Logger, ProgressTag
from fastllama_tpu_torch.engine.session import FastLlama
from fastllama_tpu_torch.io import ggml_reader as tr
from fastllama_tpu_torch.io import ggml_writer as tw
from fastllama_tpu_torch.models.loader import load_model

torch.set_num_threads(1)

HP = HyperParams(n_vocab=300, n_embd=64, n_mult=32, n_head=4, n_layer=2,
                 n_rot=16, ftype=FType.MOSTLY_Q4_0)
N_FF = HP.n_ff
BUCKETS = (8, 16, 32, 64)
JRCFG = JaxRuntimeConfig(n_ctx=64, n_batch=16, kv_dtype="float32",
                         weight_dtype="float32", use_pallas=False,
                         prefill_int8=False, prefill_buckets=BUCKETS)
TRCFG = RuntimeConfig(n_ctx=64, n_batch=16, kv_dtype="float32",
                      weight_dtype="float32", prefill_int8=False,
                      prefill_buckets=BUCKETS)


def tiny_vocab():
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" t{i}".encode(), 1.0) for i in range(HP.n_vocab - 259)]
    return Vocab.from_tokens(toks)


def build_tensors(kind, seed=11):
    """name -> writer spec in ggml orientation; `kind` is the type of the
    matmul weights (q4_0, q4_1 or f16); norms are f32."""
    rng = np.random.default_rng(seed)
    d = HP.n_embd

    def w(out, inn, s=0.15, eos_row=False):
        dense = (rng.standard_normal((out, inn)) * s).astype(np.float32)
        if eos_row:
            dense[2] = 0.0            # EOS logit 0: greedy runs its length
        if kind == "q4_0":
            return ("q4_0",) + quantize_q4_0(dense)
        if kind == "q4_1":
            return ("q4_1",) + quantize_q4_1(dense + 0.02)
        return ("f16", dense)

    tensors = {"tok_embeddings.weight": w(HP.n_vocab, d, 0.4),
               "norm.weight": ("f32", np.ones(d, np.float32)),
               "output.weight": w(HP.n_vocab, d, eos_row=True)}
    for i in range(HP.n_layer):
        p = f"layers.{i}."
        tensors[p + "attention_norm.weight"] = (
            "f32", (1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
        for nm in ("wq", "wk", "wv", "wo"):
            tensors[p + f"attention.{nm}.weight"] = w(d, d)
        tensors[p + "ffn_norm.weight"] = ("f32", np.ones(d, np.float32))
        tensors[p + "feed_forward.w1.weight"] = w(N_FF, d)
        tensors[p + "feed_forward.w2.weight"] = w(d, N_FF)
        tensors[p + "feed_forward.w3.weight"] = w(N_FF, d)
    return tensors


def mixed_tensors():
    """One file holding all four tensor types (fused groups share one:
    q/k/v and w2 q4_0, wo q4_1, w1/w3 f16, norms f32)."""
    t = build_tensors("q4_0")
    for name, spec in build_tensors("q4_1", seed=12).items():
        if ".wo." in name:
            t[name] = spec
    for name, spec in build_tensors("f16", seed=13).items():
        if ".w1." in name or ".w3." in name:
            t[name] = spec
    return t


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ggjt")
    out = {}
    for kind in ("q4_0", "q4_1", "f16"):
        out[kind] = str(root / f"{kind}.bin")
        jw.write_ggjt(out[kind], HP, tiny_vocab(), build_tensors(kind))
    out["mixed"] = str(root / "mixed.bin")
    jw.write_ggjt(out["mixed"], HP, tiny_vocab(), mixed_tensors())
    return out


def assert_same_tensor(a, b, name):
    """Checkpoint objects a (JAX reader) and b (port's) agree on `name`."""
    ttype = a.tensor_type(name)
    assert ttype == b.tensor_type(name)
    np.testing.assert_array_equal(a.dense(name), b.dense(name))
    if ttype == jr.GGML_TYPE_Q4_0:
        for x, y in zip(a.q4_0(name), b.q4_0(name)):
            np.testing.assert_array_equal(x, y)
    if ttype == jr.GGML_TYPE_Q4_1:
        for x, y in zip(a.q4_1(name), b.q4_1(name)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["q4_0", "q4_1", "f16", "mixed"])
def test_both_readers_read_the_same(files, kind):
    a = jr.read_ggml_checkpoint(files[kind])
    b = tr.read_ggml_checkpoint(files[kind])
    assert (dataclasses.asdict(a.hyperparams)
            == dataclasses.asdict(b.hyperparams))
    assert a.vocab.id_to_token == b.vocab.id_to_token
    assert a.tensor_names() == b.tensor_names()
    assert len(b.tensor_names()) == 3 + 9 * HP.n_layer
    for name in a.tensor_names():
        ra, rb = a.files[0].tensors[name], b.files[0].tensors[name]
        assert (ra.shape, ra.offset, ra.size) == (rb.shape, rb.offset, rb.size)
        assert rb.offset % 32 == 0
        assert_same_tensor(a, b, name)
    if kind == "mixed":
        types = {b.tensor_type(n) for n in b.tensor_names()}
        assert types == {tr.GGML_TYPE_F32, tr.GGML_TYPE_F16,
                         tr.GGML_TYPE_Q4_0, tr.GGML_TYPE_Q4_1}


@pytest.mark.parametrize("kind", ["q4_0", "q4_1", "f16", "mixed"])
def test_both_writers_write_the_same_bytes(files, tmp_path, kind):
    tensors = mixed_tensors() if kind == "mixed" else build_tensors(kind)
    out = tmp_path / "port.bin"
    tw.write_ggjt(out, HP, tiny_vocab(), tensors)
    assert out.read_bytes() == open(files[kind], "rb").read()


@pytest.mark.parametrize("use_cache,fp16", [(True, False), (False, True)])
def test_ggla_writers_and_readers_agree(tmp_path, use_cache, fp16):
    rng = np.random.default_rng(3)
    d = HP.n_embd
    if use_cache:
        tensors = {"layers.0.attention.wq.weight.lora":
                   rng.standard_normal((d, d)).astype(np.float32)}
    else:
        tensors = {"layers.1.attention.wv.weight.loraA":
                   rng.standard_normal((d, 4)).astype(np.float32),
                   "layers.1.attention.wv.weight.loraB":
                   rng.standard_normal((d, 4)).astype(np.float32)}
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    jw.write_ggla(a, 4, 8, use_cache, tensors, fp16=fp16)
    tw.write_ggla(b, 4, 8, use_cache, tensors, fp16=fp16)
    assert a.read_bytes() == b.read_bytes()
    ga, gb = jr.read_ggml_file(a), tr.read_ggml_file(b)
    assert gb.magic == tr.MAGIC_GGLA and gb.hyperparams is None
    assert ga.lora_params == gb.lora_params == {
        "use_cache_matrix": use_cache, "r": 4, "alpha": 8}
    for name in tensors:
        np.testing.assert_array_equal(ga.dense(name), gb.dense(name))


def test_legacy_magics(tmp_path):
    """GGML has no version word and no scores, GGMF has both, neither aligns
    payloads; both readers agree on a hand-written file of each."""
    import struct
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    for magic, versioned in ((tr.MAGIC_GGML, False), (tr.MAGIC_GGMF, True)):
        path = tmp_path / f"{magic:x}.bin"
        with open(path, "wb") as f:
            f.write(struct.pack("<I", magic))
            if versioned:
                f.write(struct.pack("<I", 1))
            f.write(struct.pack("<7i", 2, 4, 32, 1, 1, 4, 0))
            for tok in (b"a", b"bc"):
                f.write(struct.pack("<I", len(tok)) + tok)
                if versioned:
                    f.write(struct.pack("<f", -1.5))
            f.write(struct.pack("<III", 2, 3, 0))
            f.write(struct.pack("<2i", 4, 3))      # extents fastest-first
            f.write(b"w.x" + arr.tobytes())
        ga, gb = jr.read_ggml_file(path), tr.read_ggml_file(path)
        assert gb.version == (1 if versioned else 0)
        assert gb.vocab.id_to_token == ga.vocab.id_to_token
        assert gb.vocab.id_to_token[1] == (b"bc", -1.5 if versioned else 0.0)
        assert gb.tensors["w.x"].shape == (3, 4)
        assert gb.tensors["w.x"].offset == ga.tensors["w.x"].offset
        np.testing.assert_array_equal(gb.dense("w.x"), arr)


def split_shards(tensors):
    """Two shard files' tensor dicts: 2-D tensors halved on the axis the
    name rule gives, 1-D tensors in the first file only."""
    parts = ({}, {})
    for name, spec in tensors.items():
        if spec[1].ndim == 1:
            parts[0][name] = spec
            continue
        ax = tr.shard_concat_axis(name)
        for i in range(2):
            def half(a):
                # a plane of per-block values halves with its codes
                n = a.shape[ax] // 2
                return np.ascontiguousarray(
                    a[n * i:n * (i + 1)] if ax == 0 else a[:, n * i:n * (i + 1)])
            parts[i][name] = (spec[0],) + tuple(half(a) for a in spec[1:])
    return parts


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    path = tmp_path_factory.mktemp("shards") / "model.bin"
    p0, p1 = split_shards(mixed_tensors())
    jw.write_ggjt(path, HP, tiny_vocab(), p0)
    jw.write_ggjt(str(path) + ".1", HP, tiny_vocab(), p1)
    return str(path)


def test_sharded_pair_reads_the_same(sharded, files):
    assert tr.find_shard_files(sharded) == [sharded, sharded + ".1"]
    assert tr.shard_concat_axis("layers.3.attention.wo.weight") == 1
    assert tr.shard_concat_axis("layers.3.attention.wq.weight") == 0
    a = jr.read_ggml_checkpoint(sharded)
    b = tr.read_ggml_checkpoint(sharded)
    whole = tr.read_ggml_checkpoint(files["mixed"])
    assert len(b.files) == 2
    for name in b.tensor_names():
        assert_same_tensor(a, b, name)
        # and the shards reassemble into the unsharded file's tensors
        np.testing.assert_array_equal(b.dense(name), whole.dense(name))
        assert (b.raw_single(name) is None) == (whole.dense(name).ndim == 2)


def greedy(session_cls, model, prompt, n):
    s = session_cls(model, n_keep=16, seed=3)
    assert s.ingest(prompt)
    out = []
    assert s.generate(out.append, num_tokens=n, temp=0.0)
    return "".join(out), s.n_past, s.get_logits().copy()


@pytest.mark.parametrize("kind", ["q4_0", "q4_1", "f16", "mixed", "sharded"])
def test_load_model_matches_jax(files, sharded, kind):
    """The same file through both load_models: equal planes, f32 logits to
    1e-4 and identical greedy streams (f32 weights and KV, int8 off)."""
    path = sharded if kind == "sharded" else files[kind]
    jm = jax_load_model(path, JRCFG)
    tm = load_model(path, TRCFG, device="cpu")
    for jl_, tl_ in zip(jm.params.layers, tm.params.layers):
        for f in ("wqkv", "wo", "w13", "w2"):
            jw_, tw_ = getattr(jl_, f), getattr(tl_, f)
            if hasattr(jw_, "qs"):
                assert tw_.n_logical == jw_.n_logical
                np.testing.assert_array_equal(tw_.qs.numpy(),
                                              np.asarray(jw_.qs))
                np.testing.assert_array_equal(tw_.scales.numpy(),
                                              np.asarray(jw_.scales))
                assert (tw_.mins is None) == (jw_.mins is None)
                if tw_.mins is not None:
                    np.testing.assert_array_equal(tw_.mins.numpy(),
                                                  np.asarray(jw_.mins))
            else:
                np.testing.assert_array_equal(tw_.numpy(), np.asarray(jw_))
    toks = [1] + list(range(260, 270))
    np.testing.assert_allclose(tm.eval(0, toks), jm.eval(0, toks),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm.eval(len(toks), [271]),
                               jm.eval(len(toks), [271]),
                               rtol=1e-4, atol=1e-4)
    jm.reset()
    tm.reset()
    jtext, jn, jlog = greedy(JaxFastLlama, jm, " t1 t2 t3", 12)
    ttext, tn, tlog = greedy(FastLlama, tm, " t1 t2 t3", 12)
    assert (ttext, tn) == (jtext, jn) and len(ttext) > 0
    np.testing.assert_allclose(tlog, jlog, rtol=1e-4, atol=1e-4)


def test_loader_progress_in_layer_order(files):
    """The worker pool must not reorder layers or progress callbacks."""
    class Rec(Logger):
        def __init__(self):
            super().__init__()
            self.seen = []

        def progress(self, tag, done, total):
            self.seen.append((tag, done, total))

    rec = Rec()
    load_model(files["q4_0"], TRCFG, logger=rec, device="cpu")
    n = HP.n_layer + 1
    assert rec.seen == [(ProgressTag.LOAD, i, n) for i in range(1, n + 1)]
