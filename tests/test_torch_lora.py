"""PyTorch port: runtime LoRA adapters (attach_lora / detach_lora) against
the JAX package on the same GGJT model and ggla adapter files, the bf16
decode step with q/k/v LoRA (the terms folded into the fused projection that
kernel B4 ropes) against the JAX forward and against the unfused composition
it replaced, and _dot against the JAX apply_lora."""
import math

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


# -- the bf16 decode step with q/k/v LoRA: the B4 route -----------------------

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
    across through params_from_numpy. On a decode step both layers run B4:
    layer 0's q/k/v LoRA terms are added into its fused projection before
    B4 ropes it (the B10 route this layer took before is gone), and no B10
    is called. Logits agree with the JAX forward (einsum attention on the
    CPU) to bf16 tolerance, 3e-2 of the max: B4 rounds q and p to bf16
    where the einsum does not."""
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
    for mod, name in ((tda, "decode_attention"),
                      (tl, "decode_attention_fused")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **kw:
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
    assert calls == ["decode_attention_fused"] * (2 * HP.n_layer)
    assert tda.decode_attention_fused.launches == 0  # CPU: plain versions


def unfused_b4(qkv, k_cache, v_cache, n_past, cos, sin, *, head_dim, n_rot,
               scale):
    """The composition a q/k/v-LoRA decode layer ran before the fold, from
    the same (LoRA'd) qkv: split, RoPE on q and k in one per-lane pass, the
    K/V rows written by slab_write_rows, then B10; plain versions on the
    CPU."""
    from fastllama_tpu_torch.kernels.kv_write import slab_write_rows
    from fastllama_tpu_torch.kernels.rope import rope_interleaved_lanes
    b, s, f = k_cache.shape
    h = f // head_dim
    q, k, v = (qkv[:, :, i * f:(i + 1) * f].reshape(b, 1, h, head_dim)
               for i in range(3))
    qk = rope_interleaved_lanes(torch.cat([q, k], dim=2),
                                cos[:, None, None, :], sin[:, None, None, :],
                                n_rot)
    q, k = qk[:, :, :h], qk[:, :, h:]
    slab_write_rows(k_cache, k.reshape(b, 1, f).to(k_cache.dtype), n_past)
    slab_write_rows(v_cache, v.reshape(b, 1, f).to(v_cache.dtype), n_past)
    return tda.decode_attention(q.reshape(b, 1, f).contiguous(), k_cache,
                                v_cache, n_past, head_dim=head_dim,
                                scale=scale)


def greedy_slab_stream(tp, monkeypatch, fused, steps=6):
    """A prompt, then `steps` greedy decode steps of tl.forward in bf16
    weight mode over f32 slab caches (B4's route, whose f32 cache rounds
    nothing that B10 does not), every layer through B4, or (fused=False)
    through the unfused composition. Returns the tokens and last logits."""
    if not fused:
        monkeypatch.setattr(tl, "decode_attention_fused", unfused_b4)
    cfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                           w_dtype="bfloat16", prefill_int8=False)
    kv = tl.init_kv_cache(HP, 1, 64, dtype=torch.float32, device="cpu")
    prompt = [1] + list(range(260, 267))
    logits, _, _ = tl.forward(tp, torch.tensor([prompt]), 0, kv, cfg)
    tokens = [int(logits[0, -1].argmax())]
    n = len(prompt)
    for _ in range(steps):
        logits, _, _ = tl.forward(tp, torch.tensor([[tokens[-1]]]), n, kv,
                                  cfg)
        tokens.append(int(logits[0, -1].argmax()))
        n += 1
    monkeypatch.undo()
    return tokens, logits[0, -1].numpy()


def test_b4_on_qkv_lora_layers_equals_the_unfused_route(ggjt_path, tmp_path,
                                                        monkeypatch):
    """bf16 A/B terms on wq, wk and wv of both layers: the decode steps on
    B4 (the terms added into the fused projection, then one launch a layer)
    give the greedy tokens of the unfused composition those layers took
    before (the terms added to q, k and v, RoPE, the row writes and B10),
    and logits within 1e-4 of the largest, the paged routes' tolerance."""
    rng = np.random.default_rng(9)
    d, r = HP.n_embd, 4
    adapter = str(tmp_path / "qkv.bin")
    write_ggla(adapter, r=r, alpha=8, use_cache=False, tensors={
        f"layers.{i}.attention.{w}.weight.lora{s}":
            (rng.standard_normal((d, r)) * 0.2).astype(np.float32)
        for i in range(HP.n_layer) for w in ("wq", "wk", "wv")
        for s in ("A", "B")})
    jm = jax_load_model(ggjt_path, rcfgs("bfloat16")[0])
    plain = tl.params_from_numpy(to_numpy_tree(jm.params), device="cpu")
    assert jm.attach_lora(adapter)
    tp = tl.params_from_numpy(to_numpy_tree(jm.params), device="cpu")
    fused, lf = greedy_slab_stream(tp, monkeypatch, fused=True)
    unfused, lu = greedy_slab_stream(tp, monkeypatch, fused=False)
    base, _ = greedy_slab_stream(plain, monkeypatch, fused=True)
    assert fused == unfused and fused != base
    np.testing.assert_allclose(lf, lu, rtol=0, atol=1e-4 * np.abs(lu).max())


# -- _dot: the JAX apply_lora's function, the stored operand read as it is ----

def lora_pair(form, dtype, k=96, n=80, r=8, seed=3):
    """The same term on both packages: {"delta": [K, N]} or {"a": [K, r],
    "b": [r, N]}, rounded to dtype."""
    rng = np.random.default_rng(seed)
    shapes = {"delta": {"delta": (k, n)}, "ab": {"a": (k, r), "b": (r, n)}}
    arrs = {key: (rng.standard_normal(shp) * 0.3).astype(np.float32)
            for key, shp in shapes[form].items()}
    jt = jl.LoraTerm(**{key: jnp.asarray(a, getattr(jnp, dtype))
                        for key, a in arrs.items()})
    tt = tl.LoraTerm(**{key: torch.from_numpy(a).to(getattr(torch, dtype))
                        for key, a in arrs.items()})
    return jt, tt


@pytest.mark.parametrize("form", ["delta", "ab"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_lora_matches_jax(form, dtype):
    """apply_lora (through _dot) against the JAX apply_lora on the same x
    and term: x rounded to the term's dtype, exact products, f32 sums, xa
    rounded to b's dtype; f32 and bf16 terms, delta and A/B forms. Within
    f32 reassociation, plus one bf16 step of xa for the bf16 A/B form
    (an f32-ulp difference in xa can move its rounding)."""
    jt, tt = lora_pair(form, dtype)
    x = np.random.default_rng(4).standard_normal((2, 3, 96)).astype(
        np.float32)
    want = np.asarray(jl.apply_lora(jnp.asarray(x), jt))
    got = tl.apply_lora(torch.from_numpy(x), tt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    w = (tt.delta if form == "delta" else tt.a).to(torch.float32)
    xr = torch.from_numpy(x).to(tt.delta.dtype if form == "delta"
                                else tt.a.dtype).to(torch.float32)
    if form == "delta":
        scale = (xr.abs() @ w.abs()).max().item()
        tol = 1e-6 * scale
    else:
        xa = (xr.abs() @ w.abs())
        scale = (xa @ tt.b.to(torch.float32).abs()).max().item()
        tol = (2 ** -8 if dtype == "bfloat16" else 1e-6) * scale
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_dot_reads_an_f32_operand_as_it_is():
    """An f32 stored operand enters the product itself (no copy), and an
    f32 x too: _dot is their IEEE f32 product."""
    w = torch.randn(64, 32)
    x = torch.randn(3, 64)
    seen = []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(b)
        return real(a, b)
    torch.Tensor.__matmul__ = spy
    try:
        y = tl._dot(x, w)
    finally:
        torch.Tensor.__matmul__ = real
    assert len(seen) == 1 and seen[0] is w
    assert torch.equal(y, x @ w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["delta", "ab"])
def test_dot_on_the_card_ignores_the_tf32_setting(cuda_device, form):
    """f32 terms at 7B width on the card: apply_lora under
    set_float32_matmul_precision("high") equals its result under the
    default setting bit for bit (both pinned), and the f64 product of the
    same values within f32 rounding."""
    jt, tt = lora_pair(form, "float32", k=4096, n=4096, r=8)
    tt = tl.LoraTerm(**{k: (None if v is None else v.to(cuda_device))
                        for k, v in vars(tt).items()})
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((8, 1, 4096), generator=g, device=cuda_device)
    ref = tl.apply_lora(x, tt)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = tl.apply_lora(x, tt)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, ref)
    if form == "delta":
        exact = x.double() @ tt.delta.double()
        scale = (x.abs() @ tt.delta.abs()).max().item()
    else:
        exact = (x.double() @ tt.a.double()).float().double() \
            @ tt.b.double()
        scale = ((x.abs() @ tt.a.abs()) @ tt.b.abs()).max().item()
    assert (got.double() - exact).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
def test_dot_reads_a_bf16_delta_without_a_copy(cuda_device):
    """A cached bf16 delta at 7B width: one product of the rounded x and the
    stored bf16 delta with an f32 output, allocating no copy of the delta
    (the peak is under half of a bf16 copy's bytes), within f32 rounding
    of the f64 product of the rounded values."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    delta = (torch.randn((4096, 4096), generator=g, device=cuda_device)
             * 0.02).to(torch.bfloat16)
    x = torch.randn((1, 1, 4096), generator=g, device=cuda_device)
    tl._dot(x, delta)                     # cuBLAS's workspace, once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = tl._dot(x, delta)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < delta.numel()
    xr = x.to(torch.bfloat16).double()
    exact = xr @ delta.double()
    scale = (xr.abs() @ delta.double().abs()).max().item()
    assert y.dtype == torch.float32 and y.shape == (1, 1, 4096)
    assert (y.double() - exact).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["b4", "fused_step", "b21f"])
def test_fused_kernels_on_a_lora_qkv_match_plain(cuda_device, route):
    """A qkv with bf16 A/B terms on wq and wv folded in on the card
    (_fold_qkv_lora, the forward's glue; the fold within f32 rounding of
    the CPU's) through B4, the fused paged step or the fused B21 step,
    against the kernel's plain version on the same folded qkv, at the
    tolerance of that kernel's own test."""
    import types
    dev = cuda_device
    if route == "b4":
        from test_torch_decode_attention import inputs
        qkv, kc, vc = inputs(2, 256, 256, seed=5)
        qkv = qkv[:, 0]
    elif route == "fused_step":
        from test_torch_paged_kv import fused_case
        case = fused_case("bfloat16", [0, 1, 63, 64, 65, 300], h=2, seed=73)
        qkv = case[0]
    else:
        from test_torch_paged_attention_tpu import fused_case
        case = fused_case(1, seed=15)
        qkv = case[0]
    b, f3 = qkv.shape
    f = f3 // 3
    g = torch.Generator().manual_seed(6)
    terms = {name: tl.LoraTerm(
        a=(torch.randn((f, 8), generator=g) * 0.1).to(torch.bfloat16),
        b=(torch.randn((8, f), generator=g) * 0.1).to(torch.bfloat16))
        for name in ("lora_wq", "lora_wv")}
    x = torch.randn((b, 1, f), generator=g)
    layer = types.SimpleNamespace(lora_wk=None, **terms)
    on_card = types.SimpleNamespace(lora_wk=None, **{
        k: tl.LoraTerm(a=t.a.to(dev), b=t.b.to(dev))
        for k, t in terms.items()})
    cpu = tl._fold_qkv_lora(torch.tensor(qkv).reshape(b, 1, f3), x, layer)
    card = tl._fold_qkv_lora(torch.tensor(qkv).reshape(b, 1, f3).to(dev),
                             x.to(dev), on_card)
    assert not torch.equal(cpu.reshape(b, f3), torch.from_numpy(qkv))
    # f32 rounding, plus one bf16 step of xa (rounded to b's dtype) where
    # the card's and the CPU's f32 xa differ by an ulp
    xa_b = max(((x.abs() @ t.a.float().abs()) @ t.b.float().abs()).max()
               .item() for t in terms.values())
    assert (card.cpu() - cpu).abs().max().item() <= (
        1e-5 * cpu.abs().max().item() + 2 ** -8 * xa_b)
    if route == "b4":
        n = torch.tensor([0, 200], dtype=torch.int32, device=dev)
        cos, sin = tda.rope_lane_tables(n, 128, 128)
        k1, v1 = (torch.from_numpy(a).to(dev).to(torch.bfloat16)
                  for a in (kc, vc))
        k2, v2 = k1.clone(), v1.clone()
        kw = dict(head_dim=128, n_rot=128, scale=1 / math.sqrt(128))
        got = tda.decode_attention_fused(card, k1, v1, n, cos, sin, **kw)
        want = tda.decode_attention_fused_plain(card, k2, v2, n, cos, sin,
                                                **kw)
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
        assert torch.equal(k1, k2) and torch.equal(v1, v2)
        return
    _, kp, vp, lengths, table, page_ids, offsets, cos, sin, used = case
    t = [torch.from_numpy(a).to(dev) for a in (lengths, table, page_ids,
                                                offsets, cos, sin)]
    dt = torch.bfloat16
    pools = [torch.from_numpy(a).to(dt).to(dev) for a in (kp, vp)]
    ref = [p.clone() for p in pools]
    qkv2 = card.reshape(b, f3)
    if route == "fused_step":
        from fastllama_tpu_torch.kernels import paged_attention as tpa
        got = tpa.paged_decode_step_fused(qkv2, *pools, *t)
        want = tpa.paged_decode_step_fused_plain(qkv2, *ref, *t)
        tol = 2 ** -7 * want[:-1].abs().max().item() + 1e-6
    else:
        from fastllama_tpu_torch.engine import paged_kv as tpk
        got = tpk.paged_attention_tpu_fused(qkv2, *pools, *t,
                                            pages_per_compute_block=2)
        want = tpk.paged_attention_tpu_fused_plain(qkv2, *ref, *t)
        tol = 1e-5 * want[:-1].abs().max().item()
    idx = sorted(used)
    for p, q in zip(pools, ref):
        assert torch.equal(p[:, idx], q[:, idx])
    assert bool(torch.isfinite(got).all())
    assert (got - want)[:-1].abs().max().item() <= tol
