"""PyTorch port: the session and file entry point against the JAX package,
on one tiny fltpu checkpoint loaded by both `Model`s (f32 parity mode)."""
import numpy as np
import pytest
import torch

import fastllama_tpu
import fastllama_tpu_torch
from fastllama_tpu.config import HyperParams
from fastllama_tpu.engine.tokenizer import Vocab
from fastllama_tpu.io.checkpoint import CheckpointWriter as JaxWriter
from fastllama_tpu.quant.q4 import quantize_q4_0
from fastllama_tpu_torch.io.checkpoint import CheckpointWriter as TorchWriter
from fastllama_tpu.models.loader import load_model as jax_load_model
from fastllama_tpu_torch.models.loader import load_model

torch.set_num_threads(1)

HP = HyperParams(n_vocab=320, n_embd=64, n_head=4, n_layer=2, n_rot=16)
N_FF = 96
KW = dict(n_ctx=64, n_batch=16, tokens_to_keep=24, seed=7,
          kv_dtype="float32", weight_dtype="float32")


def tiny_vocab(n_vocab):
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" w{i}".encode(), 1.0) for i in range(n_vocab - len(toks))]
    return Vocab.from_tokens(toks)


def write(writer_cls, path, seed=0):
    rng = np.random.default_rng(seed)

    def q(n, k, scale=0.15):
        return quantize_q4_0(
            (rng.standard_normal((n, k)) * scale).astype(np.float32))

    d = HP.n_embd
    w = writer_cls(path, HP, tiny_vocab(HP.n_vocab))
    w.add_q4_embedding("tok_embeddings.weight", *q(HP.n_vocab, d, 0.4))
    w.add_dense("norm.weight", np.ones(d, np.float32))
    out = (rng.standard_normal((HP.n_vocab, d)) * 0.15).astype(np.float32)
    out[2] = 0.0                    # EOS logit 0: greedy runs its length
    w.add_q4_matmul("output.weight", *quantize_q4_0(out))
    for i in range(HP.n_layer):
        p = f"layers.{i}."
        w.add_dense(p + "attention_norm.weight", np.ones(d, np.float32))
        w.add_dense(p + "ffn_norm.weight", np.ones(d, np.float32))
        for nm in ("wq", "wk", "wv", "wo"):
            w.add_q4_matmul(p + f"attention.{nm}.weight", *q(d, d))
        w.add_q4_matmul(p + "feed_forward.w1.weight", *q(N_FF, d))
        w.add_q4_matmul(p + "feed_forward.w3.weight", *q(N_FF, d))
        w.add_q4_matmul(p + "feed_forward.w2.weight", *q(d, N_FF))
    w.finish()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "tiny"
    write(JaxWriter, path)
    jm = fastllama_tpu.Model(str(path), use_pallas=False,
                             logger=fastllama_tpu.Logger(), **KW)
    tm = fastllama_tpu_torch.Model(str(path), device="cpu",
                                   logger=fastllama_tpu_torch.Logger(), **KW)
    return jm, tm


def both(models, fn):
    """Reset both models, run fn(model) on each, return (jax, port)."""
    out = []
    for m in models:
        m.reset()
        out.append(fn(m))
    return tuple(out)


def stream(m, prompt, n, **kw):
    chunks = []
    assert m.ingest(prompt)
    assert m.generate(num_tokens=n, temp=0.0, streaming_fn=chunks.append, **kw)
    return "".join(chunks), m.session.n_past, list(m.session._embd)


def test_checkpoint_writer_files_identical(tmp_path):
    write(JaxWriter, tmp_path / "j", seed=1)
    write(TorchWriter, tmp_path / "t", seed=1)
    for name in ("weights.bin", "vocab.bin", "manifest.json"):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes()


def test_greedy_streams_identical(models):
    j, t = both(models, lambda m: stream(m, " w1 w2 w3", 16))
    assert j == t and len(j[0]) > 0
    np.testing.assert_allclose(models[1].get_logits(), models[0].get_logits(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(models[1].get_embeddings(),
                               models[0].get_embeddings(),
                               rtol=1e-4, atol=1e-4)


def test_system_prompt_and_recycle_identical(models):
    def run(m):
        assert m.ingest(" w1 w2 w3", is_system_prompt=True)
        out = stream(m, " w4 w5", 70)          # n_ctx 64: recycles
        return out, list(m.session._system_prompt)
    j, t = both(models, run)
    assert j == t and t[0][1] <= 64


def test_stop_words_identical(models):
    text, _, _ = both(models, lambda m: stream(m, " w9", 16))[1]
    stop = text[len(text) // 2: len(text) // 2 + 2]
    j, t = both(models, lambda m: stream(m, " w9", 16, stop_words=[stop]))
    assert j == t
    assert stop not in t[0] and len(t[0]) < len(text)


def test_jax_state_continues_identically_in_port(models, tmp_path):
    jm, tm = models
    path = str(tmp_path / "state.npz")
    jm.reset()
    stream(jm, " w1 w2 w3 w4", 4)
    assert jm.save_state(path)
    want = stream(jm, " w6", 8)
    tm.reset()
    assert tm.load_state(path)
    assert stream(tm, " w6", 8) == want
    # and back: a state saved by the port loads in the JAX package
    tm.reset()
    stream(tm, " w1 w2", 3)
    assert tm.save_state(path)
    want = stream(tm, " w7", 6)
    jm.reset()
    assert jm.load_state(path)
    assert stream(jm, " w7", 6) == want


def test_perplexity_equal(models):
    text = " ".join(f"w{i % 17}" for i in range(40))
    j, t = both(models, lambda m: m.perplexity(text))
    assert t is not None and np.isfinite(t)
    np.testing.assert_allclose(t, j, rtol=1e-4)


def test_loader_refuses_ggml_files(tmp_path):
    """A file that is neither an fltpu directory nor a ggml-family file is
    refused by its magic, as the JAX loader refuses it (GGJT files load:
    tests/test_torch_ggml_io.py)."""
    f = tmp_path / "model.bin"
    f.write_bytes(b"nope" + b"\0" * 64)
    with pytest.raises(ValueError, match="not a ggml file"):
        load_model(str(f), device="cpu")
    with pytest.raises(ValueError, match="not a ggml file"):
        jax_load_model(str(f))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fastllama_tpu_torch.Model("/nonexistent")
