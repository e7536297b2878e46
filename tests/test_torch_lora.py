"""PyTorch port: runtime LoRA adapters (attach_lora / detach_lora) against
the JAX package on the same GGJT model and ggla adapter files, and the bf16
decode step with q/k/v LoRA (the kernel B10 route) against the JAX forward."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastllama_tpu.config import FType, HyperParams
from fastllama_tpu.config import RuntimeConfig as JaxRuntimeConfig
from fastllama_tpu.engine.session import FastLlama as JaxFastLlama
from fastllama_tpu.engine.tokenizer import Vocab
from fastllama_tpu.io.ggml_writer import write_ggjt
from fastllama_tpu.models import llama as jl
from fastllama_tpu.models.loader import load_model as jax_load_model
from fastllama_tpu.quant.q4 import quantize_q4_0
from fastllama_tpu.quant.tensor import QuantEmbedding, QuantMatmulWeight
from fastllama_tpu_torch.config import RuntimeConfig
from fastllama_tpu_torch.engine.logger import Logger
from fastllama_tpu_torch.engine.session import FastLlama
from fastllama_tpu_torch.io.ggml_writer import write_ggla
from fastllama_tpu_torch.kernels import decode_attention as tda
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.models.loader import load_model

torch.set_num_threads(1)

HP = HyperParams(n_vocab=300, n_embd=64, n_mult=32, n_head=4, n_layer=2,
                 n_rot=16, ftype=FType.MOSTLY_Q4_0)
N_FF = HP.n_ff
BUCKETS = (8, 16, 32, 64)


def rcfgs(mode):
    kw = dict(n_ctx=64, n_batch=16, kv_dtype=mode, weight_dtype=mode,
              prefill_int8=False, prefill_buckets=BUCKETS)
    return JaxRuntimeConfig(use_pallas=False, **kw), RuntimeConfig(**kw)


@pytest.fixture(scope="module")
def ggjt_path(tmp_path_factory):
    rng = np.random.default_rng(11)
    d = HP.n_embd
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" t{i}".encode(), 1.0) for i in range(HP.n_vocab - 259)]

    def q(out, inn, s=0.15):
        return ("q4_0",) + quantize_q4_0(
            (rng.standard_normal((out, inn)) * s).astype(np.float32))

    tensors = {"tok_embeddings.weight": q(HP.n_vocab, d, 0.4),
               "norm.weight": ("f32", np.ones(d, np.float32)),
               "output.weight": q(HP.n_vocab, d)}
    for i in range(HP.n_layer):
        p = f"layers.{i}."
        tensors[p + "attention_norm.weight"] = ("f32", np.ones(d, np.float32))
        for nm in ("wq", "wk", "wv", "wo"):
            tensors[p + f"attention.{nm}.weight"] = q(d, d)
        tensors[p + "ffn_norm.weight"] = ("f32", np.ones(d, np.float32))
        tensors[p + "feed_forward.w1.weight"] = q(N_FF, d)
        tensors[p + "feed_forward.w2.weight"] = q(d, N_FF)
        tensors[p + "feed_forward.w3.weight"] = q(N_FF, d)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.bin"
    write_ggjt(path, HP, Vocab.from_tokens(toks), tensors)
    return str(path)


def both_models(path, mode="float32", logger=None):
    jr, tr = rcfgs(mode)
    kw = {} if logger is None else {"logger": logger}
    return jax_load_model(path, jr), load_model(path, tr, device="cpu", **kw)


def first_row(session_cls, model, prompt=" t3 t4", seed=5):
    """Logits after ingesting the prompt and sampling one greedy token."""
    s = session_cls(model, n_keep=16, seed=seed)
    assert s.ingest(prompt)
    assert s.generate(lambda t: None, num_tokens=1, temp=0.0)
    return s.get_logits().copy()


def rows(jm, tm, **kw):
    return first_row(JaxFastLlama, jm, **kw), first_row(FastLlama, tm, **kw)


def close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def cached_adapter(path):
    rng = np.random.default_rng(2)
    d = HP.n_embd
    write_ggla(path, r=8, alpha=16, use_cache=True, tensors={
        "layers.0.attention.wq.weight.lora":
            (rng.standard_normal((d, d)) * 0.05).astype(np.float32),
        "layers.1.feed_forward.w1.weight.lora":
            (rng.standard_normal((N_FF, d)) * 0.05).astype(np.float32),
        "output.weight.lora":
            (rng.standard_normal((HP.n_vocab, d)) * 0.05).astype(np.float32)})
    return path


def test_attach_changes_logits_as_in_jax(ggjt_path, tmp_path):
    jm, tm = both_models(ggjt_path)
    jbase, tbase = rows(jm, tm)
    close(tbase, jbase)
    ggla = cached_adapter(str(tmp_path / "adapter.bin"))
    assert jm.attach_lora(ggla) and tm.attach_lora(ggla)
    assert tm.lora_path == ggla == jm.lora_path
    # orientation: the cached delta [N, K] is stored transposed, [K, N]
    term = tm.params.layers[0].lora_wq
    assert term.delta.shape == (HP.n_embd, HP.n_embd) and term.a is None
    assert tm.params.layers[1].lora_w1.delta.shape == (HP.n_embd, N_FF)
    assert tm.params.lora_output.delta.shape == (HP.n_embd, HP.n_vocab)
    np.testing.assert_array_equal(term.delta.numpy(),
                                  np.asarray(jm.params.layers[0].lora_wq.delta))
    jm.reset()
    tm.reset()
    jrow, trow = rows(jm, tm)
    assert not np.array_equal(trow, tbase)
    close(trow, jrow)


def test_second_attach_is_refused(ggjt_path, tmp_path):
    _, tm = both_models(ggjt_path)
    ggla = cached_adapter(str(tmp_path / "adapter.bin"))
    assert tm.attach_lora(ggla)
    before = tm.params.layers[0].lora_wq
    assert not tm.attach_lora(ggla)
    assert tm.params.layers[0].lora_wq is before and tm.lora_path == ggla


def test_detach_restores_bit_identical_logits(ggjt_path, tmp_path):
    _, tm = both_models(ggjt_path)
    assert not tm.detach_lora()            # nothing attached: refused
    base = first_row(FastLlama, tm)
    assert tm.attach_lora(cached_adapter(str(tmp_path / "adapter.bin")))
    tm.reset()
    assert not np.array_equal(first_row(FastLlama, tm), base)
    assert tm.detach_lora()
    assert tm.lora_path is None
    assert all(getattr(layer, f) is None for layer in tm.params.layers
               for f in tl.LORA_FIELDS) and tm.params.lora_output is None
    tm.reset()
    np.testing.assert_array_equal(first_row(FastLlama, tm), base)


def test_low_rank_matches_cached_and_jax(ggjt_path, tmp_path):
    """A no-cache adapter (A, B) gives the logits of the cached delta =
    B A scale adapter, and of the JAX package on the same file; loraA [K, r]
    is stored as is, loraB [N, r] transposed."""
    rng = np.random.default_rng(3)
    d, r, alpha = HP.n_embd, 4, 8
    scale = alpha / r
    a = (rng.standard_normal((r, d)) * 0.1).astype(np.float32)    # [r, in]
    b = (rng.standard_normal((d, r)) * 0.1).astype(np.float32)    # [out, r]
    cached = str(tmp_path / "cached.bin")
    write_ggla(cached, r=r, alpha=alpha, use_cache=True, tensors={
        "layers.0.attention.wv.weight.lora": (b @ a) * scale})
    nocache = str(tmp_path / "nocache.bin")
    write_ggla(nocache, r=r, alpha=alpha, use_cache=False, tensors={
        "layers.0.attention.wv.weight.loraA": (a * scale).T,      # [in, r]
        "layers.0.attention.wv.weight.loraB": b})                 # [out, r]
    out = []
    for adapter in (cached, nocache):
        jm, tm = both_models(ggjt_path)
        assert jm.attach_lora(adapter) and tm.attach_lora(adapter)
        jrow, trow = rows(jm, tm, prompt=" t5", seed=9)
        close(trow, jrow)
        out.append(trow)
    term = tm.params.layers[0].lora_wv
    assert term.a.shape == (d, r) and term.b.shape == (r, d)
    np.testing.assert_array_equal(term.a.numpy(), (a * scale).T)
    np.testing.assert_array_equal(term.b.numpy(), b.T)
    np.testing.assert_allclose(out[0], out[1], rtol=2e-5, atol=2e-5)


class ErrLogger(Logger):
    def __init__(self):
        super().__init__()
        self.errors = []

    def log_err(self, func_name, message):
        self.errors.append((func_name, message))


@pytest.mark.parametrize("case", ["unknown_base", "missing_b", "bad_suffix",
                                  "not_ggla", "no_file"])
def test_bad_adapter_fails_and_leaves_model_untouched(ggjt_path, tmp_path,
                                                      case):
    """Failures log and return False (no exception); terms are staged, so a
    good group ahead of the bad one is not left attached."""
    z = np.zeros((HP.n_embd, HP.n_embd), np.float32)
    good = "layers.0.attention.wq.weight"
    path = str(tmp_path / "bad.bin")
    if case == "unknown_base":
        write_ggla(path, 2, 4, True, {good + ".lora": z,
                                      "layers.99.attention.wq.weight.lora": z})
    elif case == "missing_b":
        write_ggla(path, 2, 4, False, {good + ".loraA": z[:, :2]})
    elif case == "bad_suffix":
        write_ggla(path, 2, 4, True, {good + ".lora": z, good + ".bogus": z})
    elif case == "not_ggla":
        path = ggjt_path
    log = ErrLogger()
    jm, tm = both_models(ggjt_path, logger=log)
    assert not jm.attach_lora(path)
    assert not tm.attach_lora(path)
    assert len(log.errors) == 1 and log.errors[0][0] == "attach_lora"
    assert tm.lora_path is None
    assert all(getattr(layer, f) is None for layer in tm.params.layers
               for f in tl.LORA_FIELDS)


# -- the bf16 decode step with q/k/v LoRA: the B10 route ----------------------

def to_numpy_tree(p):
    """JAX LlamaParams (adapter attached or not) -> params_from_numpy's tree;
    bf16 leaves go through f32 (exact) and are cast back by the caller."""
    def leaf(w):
        if isinstance(w, QuantMatmulWeight):
            out = {"qs": np.asarray(w.qs), "scales": np.asarray(w.scales),
                   "n_logical": w.n_logical}
            if w.mins is not None:
                out["mins"] = np.asarray(w.mins)
            return out
        if isinstance(w, QuantEmbedding):
            return {"qs": np.asarray(w.qs), "scales": np.asarray(w.scales)}
        return np.asarray(w)

    def lora(t):
        if t is None:
            return None
        return {k: np.asarray(v) for k, v in (
            ("delta", t.delta), ("a", t.a), ("b", t.b)) if v is not None}

    layers = []
    for lp in p.layers:
        lt = {f: leaf(getattr(lp, f)) for f in (
            "attention_norm", "wqkv", "wo", "ffn_norm", "w13", "w2")}
        lt.update({f: lora(getattr(lp, f)) for f in tl.LORA_FIELDS})
        layers.append(lt)
    return {"tok_embeddings": leaf(p.tok_embeddings), "norm": leaf(p.norm),
            "output": leaf(p.output), "layers": layers,
            "lora_output": lora(p.lora_output)}


def test_bf16_decode_with_qkv_lora_takes_b10_and_matches_jax(
        ggjt_path, tmp_path, monkeypatch):
    """A JAX model with a bf16 A/B adapter on wq and wv of layer 0 carries
    across through params_from_numpy. On a decode step layer 0 (q/k/v LoRA)
    runs B10 and layer 1 runs B4. Logits agree with the JAX forward (einsum
    attention on the CPU) to bf16 tolerance, 3e-2 of the max: layer 1's B4
    rounds q and p to bf16 where the einsum does not."""
    rng = np.random.default_rng(7)
    d, r = HP.n_embd, 4
    adapter = str(tmp_path / "ab.bin")
    write_ggla(adapter, r=r, alpha=8, use_cache=False, tensors={
        f"layers.0.attention.{w}.weight.lora{s}":
            (rng.standard_normal((d, r)) * 0.2).astype(np.float32)
        for w in ("wq", "wv") for s in ("A", "B")})
    jrcfg, _ = rcfgs("bfloat16")
    jm = jax_load_model(ggjt_path, jrcfg)
    assert jm.attach_lora(adapter)
    tp = tl.params_from_numpy(to_numpy_tree(jm.params), device="cpu")
    assert tp.layers[0].lora_wq.a.dtype == torch.bfloat16
    assert tp.layers[1].lora_wq is None

    calls = []
    for name in ("decode_attention", "decode_attention_fused"):
        orig = getattr(tl, name)
        monkeypatch.setattr(tl, name, lambda *a, _o=orig, _n=name, **kw:
                            calls.append(_n) or _o(*a, **kw))
    jcfg = jl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                            w_dtype="bfloat16", use_pallas=False,
                            prefill_int8=False)
    tcfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                            w_dtype="bfloat16", prefill_int8=False)
    jkv = jl.init_kv_cache(HP, 1, 64, dtype=jnp.bfloat16)
    tkv = tl.init_kv_cache(HP, 1, 64, dtype=torch.bfloat16, device="cpu")
    prompt = [1] + list(range(260, 271))
    n_past = 0
    for toks in (prompt, [272], [273]):
        t = np.asarray([toks], np.int32)
        jlog, jkv, _ = jl.forward_jit(jm.params, jnp.asarray(t),
                                      jnp.int32(n_past), jkv, jcfg,
                                      jnp.int32(len(toks) - 1))
        tlog, tkv, _ = tl.forward(tp, torch.from_numpy(t).long(), n_past,
                                  tkv, tcfg, len(toks) - 1)
        want = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), want, rtol=0,
                                   atol=3e-2 * np.abs(want).max())
        n_past += len(toks)
    assert calls == ["decode_attention", "decode_attention_fused"] * 2
    assert tda.decode_attention.launches == 0       # CPU: plain versions
