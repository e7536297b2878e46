"""PyTorch port: the continuous-batching engine (engine/scheduler.py) and
the per-slot-depth forward against the JAX package, on a tiny f32 model."""
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastllama_tpu.config import HyperParams, RuntimeConfig as JaxRuntimeConfig
from fastllama_tpu.engine import scheduler as js
from fastllama_tpu.engine.tokenizer import Vocab as JaxVocab
from fastllama_tpu.models import llama as jl
from fastllama_tpu.models.fuse import make_layer_params
from fastllama_tpu.quant.q4 import quantize_q4_0
from fastllama_tpu.quant.tensor import make_embedding, make_matmul_weight
from fastllama_tpu_torch.config import RuntimeConfig
from fastllama_tpu_torch.engine import scheduler as ts
from fastllama_tpu_torch.engine.tokenizer import Vocab
from fastllama_tpu_torch.models import llama as tl

from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

HP = HyperParams(n_vocab=320, n_embd=64, n_head=4, n_layer=2, n_rot=16)
N_FF = 96
N_CTX = 64
KW = dict(kv_dtype="float32", weight_dtype="float32", n_batch=8,
          prefill_buckets=(8, 16, 32, 64))


def jax_params(seed=0):
    rng = np.random.default_rng(seed)

    def qw(k_in, n_out, scale=0.15):
        return ("q4",) + quantize_q4_0(
            (rng.standard_normal((n_out, k_in)) * scale).astype(np.float32))

    d = HP.n_embd
    layers = [make_layer_params(
        HP.n_head,
        attention_norm=(1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ffn_norm=np.ones(d, np.float32),
        wq=qw(d, d), wk=qw(d, d), wv=qw(d, d), wo=qw(d, d),
        w1=qw(d, N_FF), w2=qw(N_FF, d), w3=qw(d, N_FF),
    ) for _ in range(HP.n_layer)]
    emb = (rng.standard_normal((HP.n_vocab, d)) * 0.4).astype(np.float32)
    out = (rng.standard_normal((HP.n_vocab, d)) * 0.15).astype(np.float32)
    out[2] = 0.0                    # EOS logit 0: greedy runs its length
    return jl.LlamaParams(
        tok_embeddings=make_embedding(*quantize_q4_0(emb)),
        norm=jnp.ones(d), output=make_matmul_weight(*quantize_q4_0(out)),
        layers=layers)


def vocab_tokens():
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" w{i}".encode(), 1.0) for i in range(HP.n_vocab - len(toks))]
    return toks


@pytest.fixture(scope="module")
def world():
    jp = jax_params()
    tp = tl.params_from_numpy(to_numpy_tree(jp), device="cpu")
    return dict(jp=jp, tp=tp, jvocab=JaxVocab.from_tokens(vocab_tokens()),
                tvocab=Vocab.from_tokens(vocab_tokens()))


def port_engine(world, n_slots=3, rcfg_kw=None, **kw):
    rcfg = RuntimeConfig(**{**KW, **(rcfg_kw or {})})
    return ts.BatchEngine(HP, world["tp"], world["tvocab"], n_slots=n_slots,
                          n_ctx=N_CTX, rcfg=rcfg, device="cpu", **kw)


def jax_engine(world, n_slots=3, rcfg_kw=None, **kw):
    rcfg = JaxRuntimeConfig(use_pallas=False, **{**KW, **(rcfg_kw or {})})
    return js.BatchEngine(HP, world["jp"], world["jvocab"], n_slots=n_slots,
                          n_ctx=N_CTX, rcfg=rcfg, **kw)


def words(start, n):
    """n words; the tiny vocabulary has no merges, so a word is one token per
    character: 3 tokens (w0..w9) or 4, plus BOS for the prompt."""
    return " ".join(f"w{(start + i) % 60}" for i in range(n))


# ---------------------------------------------------------------------------
# forward with per-slot depths
# ---------------------------------------------------------------------------

def cfgs(mode):
    return (jl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot, w_dtype=mode,
                             act_dtype="float32", use_pallas=False,
                             kv_update="scatter", prefill_int8=False),
            tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot, w_dtype=mode,
                             prefill_int8=False))


def staggered_batch(world, mode, s_len=16, with_tables=False):
    """The batched decode math of the engine: three rows prefilled one at a
    time into one [3, S] cache (the other rows run past the cache, so their
    writes drop), then one decode step at per-row depths, on both packages.
    Returns (port logits, jax logits, port caches, jax caches)."""
    jcfg, tcfg = cfgs(mode)
    prompts = [[1, 5, 9], [2, 7], [4]]
    b, t = 3, 3
    jkv = jl.init_kv_cache(HP, b, s_len, dtype=getattr(jnp, mode))
    tkv = tl.init_kv_cache(HP, b, s_len, dtype=getattr(torch, mode),
                           device="cpu")
    tables = (tl.position_tables(s_len, HP.head_dim, HP.n_rot, "cpu")
              if with_tables else None)
    for i, p in enumerate(prompts):
        row_past = np.full((b,), s_len + 8, np.int32)
        row_past[i] = 0
        row_toks = np.zeros((b, t), np.int32)
        row_toks[i, :len(p)] = p
        _, jkv, _ = jl.forward(world["jp"], jnp.asarray(row_toks),
                               jnp.asarray(row_past), jkv, jcfg,
                               jnp.int32(len(p) - 1))
        tl.forward(world["tp"], torch.from_numpy(row_toks).long(),
                   torch.from_numpy(row_past), tkv, tcfg, len(p) - 1, tables)
    npast = np.array([len(p) for p in prompts], np.int32)
    step = np.array([[11]] * b, np.int32)
    jlog, jkv, _ = jl.forward(world["jp"], jnp.asarray(step),
                              jnp.asarray(npast), jkv, jcfg)
    tlog, _, _ = tl.forward(world["tp"], torch.from_numpy(step).long(),
                            torch.from_numpy(npast), tkv, tcfg, None, tables)
    return tlog.numpy(), np.asarray(jlog), tkv, jkv


@pytest.mark.parametrize("with_tables", [False, True])
def test_vector_npast_forward_matches_jax(world, with_tables):
    """f32: logits within 2e-4 of the JAX forward with kv_update="scatter",
    and the caches too (so every dropped row was dropped on both sides).
    With the model's position tables the angles are gathered (positions
    clipped to the tables' length), without them computed: the same logits."""
    tlog, jlog, tkv, jkv = staggered_batch(world, "float32",
                                           with_tables=with_tables)
    np.testing.assert_allclose(tlog, jlog, rtol=2e-4, atol=2e-4)
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-4,
                                   atol=2e-4)


def test_vector_npast_matches_single_rows(world):
    """Each row of the batched step equals its own single-stream forward."""
    tlog, _, _, _ = staggered_batch(world, "float32")
    _, tcfg = cfgs("float32")
    for i, p in enumerate([[1, 5, 9], [2, 7], [4]]):
        kv = tl.init_kv_cache(HP, 1, 16, dtype=torch.float32, device="cpu")
        tl.forward(world["tp"], torch.tensor([p]), 0, kv, tcfg)
        ref, _, _ = tl.forward(world["tp"], torch.tensor([[11]]), len(p), kv,
                               tcfg)
        np.testing.assert_allclose(tlog[i, -1], ref.numpy()[0, -1],
                                   rtol=2e-4, atol=2e-4)


def test_vector_npast_bf16_step_with_an_inactive_slot(world):
    """bf16 mode at T = 1 runs the fused decode attention (B4's plain
    version here) at B = n_slots with per-slot depths. A slot at n_ctx + 1
    yields finite garbage and leaves the other rows alone; the active rows
    agree with the JAX einsum path to bf16 tolerance (3e-2 of the largest
    logit, as test_torch_model's decode step)."""
    tlog, jlog, tkv, _ = staggered_batch(world, "bfloat16")
    np.testing.assert_allclose(tlog, jlog, rtol=0,
                               atol=3e-2 * np.abs(jlog).max())
    _, tcfg = cfgs("bfloat16")
    before = [(k.clone(), v.clone()) for k, v in tkv]
    npast = torch.tensor([4, 16 + 1, 2], dtype=torch.int32)
    out, _, _ = tl.forward(world["tp"], torch.tensor([[12], [0], [13]]),
                           npast, tkv, tcfg)
    assert torch.isfinite(out).all()
    for (k, v), (k0, v0) in zip(tkv, before):
        assert torch.isfinite(k.float()).all()
        # the inactive slot's write went to its own last row, nowhere else
        assert torch.equal(k[1, :15], k0[1, :15])
        assert not torch.equal(k[0, 4], k0[0, 4])
        assert torch.equal(k[0, :4], k0[0, :4])


def test_padded_chunk_tail_past_the_cache_is_dropped(world):
    """A [1, T] window whose padded tail passes the cache: rows in range
    are written, the rest dropped, on both packages alike."""
    jcfg, tcfg = cfgs("float32")
    s_len = 8
    jkv = jl.init_kv_cache(HP, 1, s_len, dtype=jnp.float32)
    tkv = tl.init_kv_cache(HP, 1, s_len, dtype=torch.float32, device="cpu")
    toks = np.array([[3, 4, 5, 0, 0, 0]], np.int32)
    jlog, jkv, _ = jl.forward(world["jp"], jnp.asarray(toks),
                              jnp.asarray([5], jnp.int32), jkv, jcfg,
                              jnp.int32(2))
    tlog, _, _ = tl.forward(world["tp"], torch.from_numpy(toks).long(),
                            torch.tensor([5], dtype=torch.int32), tkv, tcfg, 2)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(tkv[1][0].numpy(), np.asarray(jkv[1][0]),
                               rtol=2e-4, atol=2e-4)
    assert (tkv[0][0][0, :5] == 0).all() and (tkv[0][0][0, 5:] != 0).any()


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

MODES = {"slab": dict(kv_mode="slab"),
         "paged": dict(kv_mode="paged", page_size=8),
         "chunked_slab": dict(kv_mode="slab", chunked_admission=True),
         "chunked_paged": dict(kv_mode="paged", page_size=8,
                               chunked_admission=True)}


def scenario(mod, stop):
    """Seven requests through three slots: queueing, a prompt of several
    chunks, max_tokens from 1 to 9, a stop word, a per-request penalty and
    a prompt too long for the context."""
    return [
        mod.Request(prompt=words(1, 4), max_tokens=9),
        mod.Request(prompt=words(5, 8), max_tokens=6),        # 4 chunks
        mod.Request(prompt=words(9, 2), max_tokens=8, stop_words=[stop]),
        mod.Request(prompt=words(1, 80), max_tokens=3),       # too long
        mod.Request(prompt=words(20, 9), max_tokens=1),
        mod.Request(prompt=words(30, 10), max_tokens=7, repeat_penalty=1.7),
        mod.Request(prompt=words(40, 3), max_tokens=5),
    ]


@pytest.fixture(scope="module")
def stop_word(world):
    """A word the third request generates, so that its stop word fires."""
    req = ts.Request(prompt=words(9, 2), max_tokens=8)
    port_engine(world, temp=0.0).run([req])
    found = re.findall(r" w\d+", req.text)
    assert len(found) >= 2, req.text
    return found[0]


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_greedy_streams_match_jax(world, stop_word, mode):
    """f32 mode, temp 0: the port's engine gives the JAX engine's tokens
    and text, request for request."""
    je = jax_engine(world, temp=0.0, **MODES[mode])
    jreqs = scenario(js, stop_word)
    je.run(jreqs)
    te = port_engine(world, temp=0.0, **MODES[mode])
    treqs = scenario(ts, stop_word)
    te.run(treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and jr.done
        assert tr.tokens_out == jr.tokens_out, (mode, jr.text, tr.text)
        assert tr.text == jr.text
        assert tr.n_prompt == jr.n_prompt
    assert treqs[3].text == "" and treqs[3].tokens_out == []
    assert len(treqs[4].tokens_out) == 1
    assert stop_word not in treqs[2].text and len(treqs[2].tokens_out) < 8
    if te.pager is not None:
        assert te.pager.free_pages == je.pager.free_pages == 24


def qkv_lora_world(world, seed=21):
    """world with q/k/v LoRA terms on both layers, the same on both
    packages: a cached delta on wq, an A/B pair on wk, a delta on wv."""
    import dataclasses
    rng = np.random.default_rng(seed)
    d, r = HP.n_embd, 4

    def arr(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)
    jl_layers, tl_layers = [], []
    for jlay, tlay in zip(world["jp"].layers, world["tp"].layers):
        terms = {"lora_wq": {"delta": arr(d, d)},
                 "lora_wk": {"a": arr(d, r), "b": arr(r, d)},
                 "lora_wv": {"delta": arr(d, d)}}
        jl_layers.append(dataclasses.replace(jlay, **{
            f: jl.LoraTerm(**{k: jnp.asarray(v) for k, v in t.items()})
            for f, t in terms.items()}))
        tl_layers.append(dataclasses.replace(tlay, **{
            f: tl.LoraTerm(**{k: torch.from_numpy(v) for k, v in t.items()})
            for f, t in terms.items()}))
    return dict(world, jp=dataclasses.replace(world["jp"], layers=jl_layers),
                tp=dataclasses.replace(world["tp"], layers=tl_layers))


@pytest.mark.parametrize("mode", ["paged", "chunked_paged"])
def test_paged_engine_with_qkv_lora_takes_the_fused_step(world, stop_word,
                                                         mode, monkeypatch):
    """f32 mode, temp 0, q/k/v LoRA terms on every layer: each paged decode
    step runs the fused paged step once a layer (the terms added into the
    layer's fused projection before it ropes), never B7's write or B6, and
    the streams equal the JAX engine's, whose step adds the terms to q, k
    and v, ropes, writes and attends apart."""
    lw = qkv_lora_world(world)
    calls = {"PS": 0, "B7": 0, "B6": 0}

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(tl, "paged_decode_step_fused",
                        count("PS", tl.paged_decode_step_fused))
    monkeypatch.setattr(tl, "paged_kv_write", count("B7", tl.paged_kv_write))
    from fastllama_tpu_torch.kernels import paged_attention as tpa
    monkeypatch.setattr(tpa, "paged_decode_attention",
                        count("B6", tpa.paged_decode_attention))
    je = jax_engine(lw, temp=0.0, **MODES[mode])
    jreqs = scenario(js, stop_word)
    je.run(jreqs)
    te = port_engine(lw, temp=0.0, **MODES[mode])
    treqs = scenario(ts, stop_word)
    te.run(treqs)
    assert [r.tokens_out for r in treqs] == [r.tokens_out for r in jreqs]
    assert sum(len(r.tokens_out) for r in treqs) > 20
    assert calls["PS"] > 0 and calls["PS"] % HP.n_layer == 0
    assert calls["B7"] == 0 and calls["B6"] == 0
    assert te.pager.free_pages == je.pager.free_pages == 24


@pytest.mark.parametrize("chunked", [False, True])
def test_engine_out_of_pages_matches_jax(world, chunked):
    """A pool of three pages under two slots: the requests that fit run as
    in JAX, the rest finish early or are refused, and every page is free
    afterwards."""
    kw = dict(n_slots=2, temp=0.0, kv_mode="paged", page_size=8,
              total_pages=3, chunked_admission=chunked)

    def reqs(mod):
        return [mod.Request(prompt=words(i, 4 + 3 * i), max_tokens=10)
                for i in range(4)]

    je, te = jax_engine(world, **kw), port_engine(world, **kw)
    jreqs, treqs = reqs(js), reqs(ts)
    je.run(jreqs)
    te.run(treqs)
    assert all(r.done for r in treqs)
    assert [r.tokens_out for r in treqs] == [r.tokens_out for r in jreqs]
    assert any(len(r.tokens_out) < 10 for r in treqs)
    assert te.pager.free_pages == 3


# ---------------------------------------------------------------------------
# the port's engine on its own
# ---------------------------------------------------------------------------

def test_engine_runs_on_the_card_by_default(world):
    """No device argument means the CUDA card; without one the engine
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.BatchEngine(HP, world["tp"], world["tvocab"], n_ctx=N_CTX,
                       rcfg=RuntimeConfig(**KW))


def test_engine_rejects_an_unknown_kv_mode(world):
    with pytest.raises(ValueError, match="kv_mode"):
        port_engine(world, kv_mode="ring")


@pytest.mark.parametrize("mode", ["slab", "chunked_paged"])
def test_stochastic_run_is_seeded_and_drain_independent(world, mode):
    """Sampled streams repeat for a seed, differ between seeds, and do not
    depend on how late the host drains the tokens."""
    def run(depth, seed):
        eng = port_engine(world, temp=0.9, drain_depth=depth,
                          sampling_seed=seed, **MODES[mode])
        reqs = [ts.Request(prompt=words(2, 3), max_tokens=12)]
        eng.run(reqs)
        return reqs[0].tokens_out

    base = run(0, 5)
    assert len(base) == 12
    assert run(0, 5) == base
    assert run(2, 5) == base
    assert run(0, 6) != base


@pytest.mark.parametrize("mode", list(MODES))
def test_async_drain_matches_sync(world, mode):
    """drain_depth > 0 must not change any greedy stream, slot reuse
    included; each banked step keeps a token tensor of its own."""
    outs = {}
    for depth in (0, 3):
        eng = port_engine(world, n_slots=2, temp=0.0, drain_depth=depth,
                          repeat_penalty=1.2, **MODES[mode])
        reqs = [ts.Request(prompt=words(i, 2 + i), max_tokens=5)
                for i in range(5)]
        eng.run(reqs)
        assert all(r.done for r in reqs)
        outs[depth] = [r.tokens_out for r in reqs]
    assert outs[0] == outs[3]
    assert all(len(t) == 5 for t in outs[0])


def test_inflight_entries_do_not_alias(world):
    eng = port_engine(world, temp=0.0, drain_depth=4)
    eng.submit(ts.Request(prompt=words(3, 3), max_tokens=20))
    for _ in range(4):
        eng.step()
    ptrs = {e[0].data_ptr() for e in eng._inflight}
    assert len(eng._inflight) >= 3 and len(ptrs) == len(eng._inflight)
    assert eng.d_tokens.data_ptr() not in ptrs


def test_batched_isolation_and_slot_reuse(world):
    """A slot's greedy output does not depend on its neighbours, and a
    reused slot does not inherit the previous occupant's penalty window."""
    alone = ts.Request(prompt=words(7, 2), max_tokens=6)
    port_engine(world, temp=0.0, repeat_penalty=1.5).run([alone])
    eng = port_engine(world, n_slots=2, temp=0.0, repeat_penalty=1.5)
    others = [ts.Request(prompt=words(i, 3), max_tokens=6) for i in (1, 2)]
    eng.run(others)
    again = ts.Request(prompt=words(7, 2), max_tokens=6)
    eng.run([again, ts.Request(prompt=words(4, 5), max_tokens=6)])
    assert again.tokens_out == alone.tokens_out


def test_per_request_knobs(world):
    """top_k = 1 and a tiny top_p are greedy whatever the temperature; a
    temp = 0 request inside a hot engine decodes greedily."""
    ref = ts.Request(prompt=words(3, 2), max_tokens=6)
    port_engine(world, temp=0.0).run([ref])
    eng = port_engine(world, n_slots=4, temp=0.9)
    reqs = [ts.Request(prompt=words(3, 2), max_tokens=6, top_k=1),
            ts.Request(prompt=words(3, 2), max_tokens=6, top_p=1e-6),
            ts.Request(prompt=words(3, 2), max_tokens=6, temp=0.0),
            ts.Request(prompt=words(1, 2), max_tokens=6)]
    eng.run(reqs)
    for r in reqs[:3]:
        assert r.tokens_out == ref.tokens_out


def test_streaming_and_mid_run_admission(world):
    """A request submitted while another decodes is admitted chunk by
    chunk; streaming_fn receives exactly the request's text."""
    eng = port_engine(world, n_slots=2, temp=0.0, **MODES["chunked_paged"])
    got = []
    first = ts.Request(prompt=words(1, 3), max_tokens=10,
                       streaming_fn=got.append)
    eng.submit(first)
    for _ in range(4):
        eng.step()
    late = ts.Request(prompt=words(5, 9), max_tokens=4)
    eng.submit(late)
    while not (first.done and late.done):
        eng.step()
    assert "".join(got) == first.text and len(first.tokens_out) == 10
    assert len(late.tokens_out) == 4
    assert eng.pager.free_pages == eng.pager.total_pages


def test_chunked_paged_splice_equals_the_scatter(world):
    """The bulk page write of a finished chunked admission (B8's plain
    version here, whole pages) leaves the prompt's rows in the slot's pages
    exactly where the row-by-row scatter puts them."""
    from fastllama_tpu_torch.engine.paged_kv import write_tokens_paged
    eng = port_engine(world, n_slots=2, temp=0.0, **MODES["chunked_paged"])
    eng.submit(ts.Request(prompt=words(1, 6), max_tokens=4))
    while not any(s.live for s in eng.slots):
        eng.step()
    t_prompt = eng.slots[0].req.n_prompt
    assert t_prompt == 19 and eng.pager.lengths[0] in (19, 20)
    pages, offs = eng.pager.token_page_offsets(0, 0, t_prompt)
    for li in range(HP.n_layer):
        want_k = torch.zeros_like(eng.pager.k_pages[li])
        want_v = torch.zeros_like(want_k)
        k1, v1 = eng._row_kv[li]
        write_tokens_paged(
            want_k, want_v, k1[:, :t_prompt].reshape(1, t_prompt, 4, 16),
            v1[:, :t_prompt].reshape(1, t_prompt, 4, 16),
            torch.from_numpy(pages[None]), torch.from_numpy(offs[None]))
        got = eng.pager.k_pages[li].reshape(4, -1, 16)
        flat = torch.from_numpy(pages.astype(np.int64) * 8 + offs)
        assert torch.equal(got[:, flat], want_k.reshape(4, -1, 16)[:, flat])


def test_chunked_paged_splice_with_a_partial_last_page(world):
    """n_ctx not a page multiple and a prompt that reaches into the last,
    partial page: the whole pages go through the bulk write, the remaining
    rows row by row, and the stream equals the monolithic paged engine's."""
    def run(chunked):
        eng = ts.BatchEngine(HP, world["tp"], world["tvocab"], n_slots=2,
                             n_ctx=62, rcfg=RuntimeConfig(**KW), temp=0.0,
                             kv_mode="paged", page_size=8,
                             chunked_admission=chunked, device="cpu")
        req = ts.Request(prompt=words(10, 14), max_tokens=2)
        eng.run([req])
        assert req.n_prompt == 57 and len(req.tokens_out) == 2
        return req.tokens_out

    assert run(True) == run(False)


def test_drain_backlog_grows_with_admissions_at_depth_0(world):
    """A behaviour of the reference engine that the port keeps: every
    admission banks one entry more (its first token) than the one per step
    that a drain depth of 0 takes out, so while the engine stays busy the
    host falls one step further behind with each admitted request; the
    backlog only clears once every slot is idle. Both engines bank the same
    number of entries at every step."""
    def backlog(mod, eng):
        reqs = [mod.Request(prompt=words(i, 2), max_tokens=4)
                for i in range(6)]
        for r in reqs:
            eng.submit(r)
        seen = []
        while not all(r.done for r in reqs):
            eng.step()
            seen.append(len(eng._inflight))
        eng.step()                        # idle: the backlog is flushed
        return seen + [len(eng._inflight)]

    port = backlog(ts, port_engine(world, n_slots=2, temp=0.0))
    ref = backlog(js, jax_engine(world, n_slots=2, temp=0.0))
    assert port == ref
    assert port[0] == 2 and max(port) >= 5 and port[-1] == 0, port
