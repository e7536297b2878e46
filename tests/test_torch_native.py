"""PyTorch port: the threaded native repack and quantizer
(fastllama_tpu_torch/native/fastllama_native.cpp through quant/native.py)
against the port's numpy path and the JAX package's numpy path, bit for bit,
and the loader's "q4p" route against its numpy route (identical planes and
logits)."""
import threading

import numpy as np
import pytest
import torch

from fastllama_tpu.quant import q4 as jq4
from fastllama_tpu.quant import tensor as jtensor
from fastllama_tpu_torch import native as native_build
from fastllama_tpu_torch.config import FType, HyperParams, RuntimeConfig
from fastllama_tpu_torch.engine.logger import Logger
from fastllama_tpu_torch.engine.tokenizer import Vocab
from fastllama_tpu_torch.io.ggml_reader import read_ggml_checkpoint
from fastllama_tpu_torch.io.ggml_writer import write_ggjt
from fastllama_tpu_torch.models import loader
from fastllama_tpu_torch.quant import native, q4
from fastllama_tpu_torch.quant.tensor import (
    make_matmul_weight, matmul_weight_from_planes,
)

torch.set_num_threads(1)


@pytest.fixture
def lib():
    """The native library, built here; module state restored afterwards."""
    if native_build.compiler() is None:
        pytest.skip("no C++ compiler: the numpy route is the only one")
    saved = (native._LIB, native._TRIED)
    assert native.available()
    yield native
    native._LIB, native._TRIED = saved


@pytest.fixture
def numpy_route(monkeypatch):
    """The port as on a machine without a C++ compiler."""
    saved = (native._LIB, native._TRIED)
    monkeypatch.setattr(native_build, "compiler", lambda: None)
    native._LIB, native._TRIED = None, False
    yield
    native._LIB, native._TRIED = saved


def test_load_race_all_threads_agree(lib):
    """The lock-free fast path in native._load must never observe
    _TRIED=True with _LIB unset mid-build: reset the module state and
    hammer available() from 8 threads; every thread must see the SAME
    verdict (mixed verdicts would make the parallel GGJT loader fuse q4 and
    q4p weight kinds)."""
    for trial in range(20):
        native._LIB = None
        native._TRIED = False
        barrier = threading.Barrier(8)
        results = [None] * 8

        def probe(i):
            barrier.wait()
            results[i] = native.available()

        ts = [threading.Thread(target=probe, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert all(r == results[0] for r in results), (
            f"trial {trial}: mixed native-availability verdicts {results}")
        assert results[0] is True


@pytest.mark.parametrize("shape", [(64, 256), (1, 32), (77, 4096)])
def test_quantize_bit_exact_vs_both_numpy_paths(lib, shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 2.5
    x[0, :32] = 0.0                       # an all-zero block: d = 0
    c_nat, s_nat = native.quantize_q4_0(x)
    for c_np, s_np in (q4.quantize_q4_0(x), jq4.quantize_q4_0(x)):
        np.testing.assert_array_equal(c_nat, c_np)
        np.testing.assert_array_equal(s_nat, s_np)


def test_quantize_half_away_rounding(lib):
    x = np.zeros((1, 32), np.float32)
    x[0, 0] = 7.0
    x[0, 1] = 0.5
    x[0, 2] = -2.5
    x[0, 3] = -0.5
    c, s = native.quantize_q4_0(x)
    assert s[0, 0] == np.float32(1.0)
    assert c[0, 1] == 9 and c[0, 2] == 5 and c[0, 3] == 7
    np.testing.assert_array_equal(c, jq4.quantize_q4_0(x)[0])


@pytest.mark.parametrize("n,k", [(48, 128), (300, 64), (96, 352)])
def test_repack_matches_both_numpy_paths(lib, n, k):
    """Padded planes from the wire bytes equal the port's and the JAX
    package's numpy repack of the same codes (padding included)."""
    rng = np.random.default_rng(1)
    codes, scales = q4.quantize_q4_0(
        rng.standard_normal((n, k)).astype(np.float32))
    wire = np.frombuffer(q4.q4_0_to_wire(codes, scales), np.uint8)
    ref = make_matmul_weight(codes, scales, device="cpu")
    jref = jtensor.make_matmul_weight(codes, scales)
    qs, sc = native.repack_q4_wire(wire, n, k, n_pad=ref.qs.shape[1],
                                   k_pad=ref.k)
    for want_qs, want_sc in ((ref.qs.numpy(), ref.scales.numpy()),
                             (np.asarray(jref.qs), np.asarray(jref.scales))):
        np.testing.assert_array_equal(qs, want_qs)
        np.testing.assert_array_equal(sc, want_sc)


def test_repack_unpadded_then_padded_container(lib):
    rng = np.random.default_rng(2)
    n, k = 16, 96
    codes, scales = q4.quantize_q4_0(
        rng.standard_normal((n, k)).astype(np.float32))
    wire = np.frombuffer(q4.q4_0_to_wire(codes, scales), np.uint8)
    w = matmul_weight_from_planes(
        *native.repack_q4_wire(wire, n, k, n_pad=n, k_pad=k), device="cpu")
    ref = make_matmul_weight(codes, scales, device="cpu")
    assert w.n_logical == ref.n_logical == n
    np.testing.assert_array_equal(w.qs.numpy(), ref.qs.numpy())
    np.testing.assert_array_equal(w.scales.numpy(), ref.scales.numpy())


def test_bad_sizes_are_refused_before_the_call(lib):
    wire = np.zeros(20 * 4, np.uint8)            # 4 blocks
    with pytest.raises(ValueError):
        native.repack_q4_wire(wire, 2, 96, n_pad=2, k_pad=96)   # 6 blocks
    with pytest.raises(ValueError):
        native.repack_q4_wire(wire, 2, 64, n_pad=1, k_pad=64)
    with pytest.raises(ValueError):
        native.quantize_q4_0(np.zeros((2, 48), np.float32))


def test_numpy_route_without_a_compiler(numpy_route):
    assert not native.available()
    assert native.repack_q4_wire(np.zeros(20, np.uint8), 1, 32, 1, 32) is None
    x = np.random.default_rng(3).standard_normal((8, 64)).astype(np.float32)
    for a, b in zip(native.quantize_q4_0(x), q4.quantize_q4_0(x)):
        np.testing.assert_array_equal(a, b)


HP = HyperParams(n_vocab=300, n_embd=64, n_mult=32, n_head=4, n_layer=2,
                 n_rot=16, ftype=FType.MOSTLY_Q4_0)
RCFG = RuntimeConfig(n_ctx=64, n_batch=16, kv_dtype="float32",
                     weight_dtype="float32", prefill_int8=False,
                     prefill_buckets=(8, 16, 32, 64))


@pytest.fixture(scope="module")
def q4_file(tmp_path_factory):
    rng = np.random.default_rng(11)
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" t{i}".encode(), 1.0) for i in range(HP.n_vocab - 259)]
    d, f = HP.n_embd, HP.n_ff

    def q(out, inn):
        return ("q4_0",) + q4.quantize_q4_0(
            (rng.standard_normal((out, inn)) * 0.15).astype(np.float32))

    ones = ("f32", np.ones(d, np.float32))
    tensors = {"tok_embeddings.weight": q(HP.n_vocab, d), "norm.weight": ones,
               "output.weight": q(HP.n_vocab, d)}
    for i in range(HP.n_layer):
        p = f"layers.{i}."
        tensors[p + "attention_norm.weight"] = ones
        tensors[p + "ffn_norm.weight"] = ones
        for nm in ("wq", "wk", "wv", "wo"):
            tensors[p + f"attention.{nm}.weight"] = q(d, d)
        tensors[p + "feed_forward.w1.weight"] = q(f, d)
        tensors[p + "feed_forward.w3.weight"] = q(f, d)
        tensors[p + "feed_forward.w2.weight"] = q(d, f)
    path = tmp_path_factory.mktemp("native") / "tiny_q4_0.bin"
    write_ggjt(path, HP, Vocab.from_tokens(toks), tensors)
    return str(path)


def _load(path):
    logs = []
    lm = loader.load_model(path, RCFG, Logger(log_fn=lambda f, m: logs.append(m)),
                           device="cpu")
    return lm, "".join(logs)


def _planes(lm):
    out = [lm.params.output.qs, lm.params.output.scales]
    for layer in lm.params.layers:
        for f in ("wqkv", "wo", "w13", "w2"):
            out += [getattr(layer, f).qs, getattr(layer, f).scales]
    return [t.numpy() for t in out]


def test_loader_q4p_route_equals_numpy_route(lib, q4_file, monkeypatch):
    """Every q4_0 matmul takes the "q4p" spec on the native route; the
    planes and the logits equal the numpy route's bit for bit, and the
    logger names the route each load took."""
    ckpt = read_ggml_checkpoint(q4_file)
    assert loader._ggml_spec(ckpt, "layers.0.attention.wq.weight")[0] == "q4p"
    assert loader.repack_route(ckpt) == "native"
    nat, nat_log = _load(q4_file)
    monkeypatch.setattr(native, "_LIB", None)          # _TRIED stays True
    assert loader._ggml_spec(ckpt, "layers.0.attention.wq.weight")[0] == "q4"
    ref, ref_log = _load(q4_file)
    assert "q4_0 repack: native" in nat_log
    assert "q4_0 repack: numpy" in ref_log
    for a, b in zip(_planes(nat), _planes(ref)):
        np.testing.assert_array_equal(a, b)
    toks = [1] + list(range(260, 270))
    np.testing.assert_array_equal(nat.eval(0, toks), ref.eval(0, toks))
    np.testing.assert_array_equal(nat.eval(len(toks), [271]),
                                  ref.eval(len(toks), [271]))
