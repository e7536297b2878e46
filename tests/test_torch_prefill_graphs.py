"""PyTorch port: the compiled prefill windows and admissions (the
counterparts of the JAX package's forward_jit, its engine's jitted prefill,
chunk and splice steps, and bench.py's prefill_step) against the JAX
package.

On the CPU every graph (utils/step_graph.GraphCache, one StepGraph a key)
runs its step on its static buffers without a capture, so these tests hold
everything but the capture: the tensor offsets and last rows, the row write
that drops what falls outside the cache, the staged inputs, the keys a new
bucket, a LoRA attach or the context boundary add and a state load keeps,
the admissions' tensor slots and first-token draw. The `cuda`-marked tests
hold the captures themselves on the card (replays bit-equal to the eager
windows and admissions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fastllama_tpu.config import RuntimeConfig as JaxRuntimeConfig
from fastllama_tpu.engine import scheduler as js
from fastllama_tpu.engine.session import FastLlama as JaxFastLlama
from fastllama_tpu.models import llama as jl
from fastllama_tpu.models.fuse import make_layer_params
from fastllama_tpu.models.loader import load_model as jax_load_model
from fastllama_tpu.quant.q4 import quantize_q4_0, quantize_q4_1
from fastllama_tpu.quant.tensor import make_embedding, make_matmul_weight
from fastllama_tpu_torch.config import RuntimeConfig
from fastllama_tpu_torch.engine import scheduler as ts
from fastllama_tpu_torch.engine.session import FastLlama
from fastllama_tpu_torch.kernels import cuda_lib
from fastllama_tpu_torch.kernels.kv_write import (
    scatter_rows_drop, slab_write_rows,
)
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.models.loader import load_model
from fastllama_tpu_torch.utils.step_graph import GraphCache
import bench_torch
import test_torch_flash_prefill as tfl
from test_torch_lora import cached_adapter, ggjt_path  # noqa: F401
from test_torch_model import HP, N_FF
from test_torch_scheduler import MODES, jax_engine, port_engine, words
from test_torch_scheduler import world  # noqa: F401

torch.set_num_threads(1)

N_CTX = 192
PAST = 24                    # the offset of the later windows


def quant_params(kind: str, seed=0):
    """A tiny JAX model whose matmuls are q4_0 ("q4") or q4_1 ("q41")."""
    rng = np.random.default_rng(seed)

    def qw(k_in, n_out, scale=0.15):
        w = (rng.standard_normal((n_out, k_in)) * scale).astype(np.float32)
        if kind == "q41":
            return ("q41",) + quantize_q4_1(w + 0.05)
        return ("q4",) + quantize_q4_0(w)

    d = HP.n_embd
    layers = [make_layer_params(
        HP.n_head,
        attention_norm=(1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ffn_norm=(1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        wq=qw(d, d), wk=qw(d, d), wv=qw(d, d), wo=qw(d, d),
        w1=qw(d, N_FF), w2=qw(N_FF, d), w3=qw(d, N_FF),
    ) for _ in range(HP.n_layer)]
    emb = (rng.standard_normal((HP.n_vocab, d)) * 0.4).astype(np.float32)
    out = (rng.standard_normal((HP.n_vocab, d)) * 0.15).astype(np.float32)
    return jl.LlamaParams(
        tok_embeddings=make_embedding(*quantize_q4_0(emb)),
        norm=jnp.ones(d), output=make_matmul_weight(*quantize_q4_0(out)),
        layers=layers)


def numpy_tree(p):
    """JAX LlamaParams (q4_0 or q4_1 matmuls) -> params_from_numpy's tree."""
    def leaf(w):
        if hasattr(w, "n_logical"):
            out = {"qs": np.asarray(w.qs), "scales": np.asarray(w.scales),
                   "n_logical": w.n_logical}
            if getattr(w, "mins", None) is not None:
                out["mins"] = np.asarray(w.mins)
            return out
        if hasattr(w, "qs"):
            return {"qs": np.asarray(w.qs), "scales": np.asarray(w.scales)}
        return np.asarray(w)
    return {"tok_embeddings": leaf(p.tok_embeddings), "norm": leaf(p.norm),
            "output": leaf(p.output),
            "layers": [{f: leaf(getattr(lp, f)) for f in (
                "attention_norm", "wqkv", "wo", "ffn_norm", "w13", "w2")}
                for lp in p.layers]}


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind in ("q4", "q41"):
        jp = quant_params(kind)
        out[kind] = (jp, tl.params_from_numpy(numpy_tree(jp), device="cpu"))
    return out


def close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def window_tokens(n, seed):
    return np.random.default_rng(seed).integers(3, HP.n_vocab, n)


def i32(x):
    return torch.tensor([x], dtype=torch.int32)


# bucket, offset, all_logits, mode, matmuls. f32: 1e-4 of the largest logit
# (the step graph's decode rule); bf16: 3e-2, the port's bf16 rule.
CASES = [(16, 0, False, "float32", "q4"), (16, PAST, True, "float32", "q4"),
         (64, 0, True, "float32", "q4"), (64, PAST, False, "float32", "q4"),
         (128, 0, False, "float32", "q4"), (128, PAST, True, "float32", "q4"),
         (16, PAST, False, "bfloat16", "q4"), (64, 0, True, "bfloat16", "q4"),
         (128, PAST, False, "bfloat16", "q4"),
         (16, 0, False, "float32", "q41"), (64, PAST, True, "float32", "q41"),
         (128, PAST, False, "bfloat16", "q41")]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.mark.parametrize("bucket,n_past,all_logits,mode,kind", CASES)
def test_forward_jit_matches_jax_and_the_int_route(models, bucket, n_past,
                                                   all_logits, mode, kind):
    """A window of bucket - 3 real tokens padded to the bucket, after a
    PAST-token prefix or at n_past 0: the port's forward_jit (n_past and
    last_idx int32 tensors, a graph of the cache) within the mode's
    tolerance of the JAX forward_jit, and bit for bit the port's int route
    (logits, embeddings and every cache row)."""
    jp, tp = models[kind]
    dt = getattr(torch, mode)
    jcfg = jl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot, w_dtype=mode,
                            use_pallas=False, prefill_int8=False,
                            all_logits=all_logits)
    cfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot, w_dtype=mode,
                           prefill_int8=False, all_logits=all_logits)
    tables = tl.position_tables(N_CTX, HP.head_dim, HP.n_rot, "cpu")
    jkv = jl.init_kv_cache(HP, 1, N_CTX, dtype=getattr(jnp, mode))
    gkv = tl.init_kv_cache(HP, 1, N_CTX, dt, "cpu")
    ikv = tl.init_kv_cache(HP, 1, N_CTX, dt, "cpu")
    t = bucket - 3
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :t] = window_tokens(t, bucket)
    with torch.inference_mode():
        if n_past:
            prefix = window_tokens(n_past, 1)[None]
            _, jkv, _ = jl.forward_jit(
                jp, jnp.asarray(prefix, jnp.int32), jnp.int32(0), jkv,
                dataclasses.replace(jcfg, all_logits=False))
            for kv in (gkv, ikv):
                tl.forward(tp, torch.from_numpy(prefix), 0, kv, cfg, None,
                           tables)
        jlog, jkv, jemb = jl.forward_jit(
            jp, jnp.asarray(toks, jnp.int32), jnp.int32(n_past), jkv, jcfg,
            jnp.int32(t - 1))
        graphs = GraphCache("cpu")
        glog, _, gemb = tl.forward_jit(
            tp, torch.from_numpy(toks), i32(n_past), gkv, cfg, i32(t - 1),
            tables, graphs=graphs)
        ilog, _, iemb = tl.forward(tp, torch.from_numpy(toks), n_past, ikv,
                                   cfg, t - 1, tables)
    assert torch.equal(glog, ilog) and torch.equal(gemb, iemb)
    for (gk, gv), (ik, iv) in zip(gkv, ikv):
        assert torch.equal(gk, ik) and torch.equal(gv, iv)
    rows = slice(0, t) if all_logits else slice(None)
    close(glog[0, rows].float().numpy(), np.asarray(jlog)[0, rows],
          TOL[mode])
    close(gemb.numpy(), np.asarray(jemb), TOL[mode])
    assert graphs.captures == 1


def test_forward_jit_flash_window_matches_jax_flash(monkeypatch):
    """A fresh bf16 window through B12's route (the port's plain version:
    its gate holds at head_dim 128, bucket 128) against the JAX forward_jit
    with its flash gate opened under interpret mode; the tensor route bit
    for bit the int route."""
    jp = tfl.jax_params()
    tp = tl.params_from_numpy(numpy_tree(jp), device="cpu")
    hp = tfl.HP
    calls = tfl.spy_flash(monkeypatch)
    cfg = tl.ForwardConfig(n_head=hp.n_head, n_rot=hp.n_rot,
                           prefill_int8=False, flash_prefill=True)
    tables = tl.position_tables(tfl.N_CTX, hp.head_dim, hp.n_rot, "cpu")
    toks = np.zeros((1, 128), np.int64)
    toks[0, :125] = np.random.default_rng(4).integers(3, hp.n_vocab, 125)
    kvs = [tl.init_kv_cache(hp, 1, tfl.N_CTX, torch.bfloat16, "cpu")
           for _ in range(2)]
    with torch.inference_mode():
        glog, _, gemb = tl.forward_jit(
            tp, torch.from_numpy(toks), i32(0), kvs[0], cfg, i32(124),
            tables, graphs=GraphCache("cpu"))
        ilog, _, iemb = tl.forward(tp, torch.from_numpy(toks), 0, kvs[1],
                                   cfg, 124, tables)
    assert len(calls) == 2 * hp.n_layer
    assert torch.equal(glog, ilog) and torch.equal(gemb, iemb)
    for (gk, gv), (ik, iv) in zip(*kvs):
        assert torch.equal(gk, ik) and torch.equal(gv, iv)
    tfl.open_jax_gate(monkeypatch)
    jkv = jl.init_kv_cache(hp, 1, tfl.N_CTX, dtype=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        jlog, _, jemb = jax.jit(jl.forward, static_argnums=4)(
            jp, jnp.asarray(toks, jnp.int32), jnp.int32(0), jkv,
            tfl.jax_cfg(flash_prefill=True), jnp.int32(124))
        jlog, jemb = jax.block_until_ready((jlog, jemb))
    close(glog[0, -1].numpy(), np.asarray(jlog)[0, -1], tfl.SLICE_TOL)
    close(gemb.numpy(), np.asarray(jemb), tfl.SLICE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_write_drops_as_the_scatter(dtype):
    """slab_write_rows (one launch on the card) leaves the cache the
    general dropping scatter leaves: T rows a sequence at n_past + t, rows
    at or past S and below 0 dropped, a sequence wholly past S untouched,
    rows read through a strided view as the forward hands them."""
    rng = np.random.default_rng(9)
    b, s, f, t = 5, 16, 8, 6
    cache = torch.from_numpy(rng.standard_normal((b, s, f)).astype(
        np.float32)).to(dtype)
    wide = torch.from_numpy(rng.standard_normal((b, t, 3 * f)).astype(
        np.float32)).to(dtype)
    rows = wide[:, :, f:2 * f]                       # k of a fused qkv
    n_past = torch.tensor([0, 13, 10, 17, -2], dtype=torch.int32)
    got = cache.clone()
    slab_write_rows(got, rows, n_past)
    want = cache.clone()
    pos = n_past.to(torch.int64)[:, None] + torch.arange(t)[None, :]
    scatter_rows_drop(want.view(1, b * s, f),
                      (pos + torch.arange(b)[:, None] * s).reshape(-1),
                      ((pos >= 0) & (pos < s)).reshape(-1),
                      rows.reshape(1, b * t, f))
    assert torch.equal(got, want)
    assert torch.equal(got[1, 13:16], rows[1, :3])
    assert torch.equal(got[1, :13], cache[1, :13])
    assert torch.equal(got[2, 10:16], rows[2])
    assert torch.equal(got[3], cache[3])
    assert torch.equal(got[4, :4], rows[4, 2:])
    assert torch.equal(got[4, 4:], cache[4, 4:])


# ---------------------------------------------------------------------------
# the session: every window through its graph
# ---------------------------------------------------------------------------

def session_models(path, n_batch):
    kw = dict(n_ctx=128, n_batch=n_batch, kv_dtype="float32",
              weight_dtype="float32", prefill_int8=False)
    return (jax_load_model(path, JaxRuntimeConfig(use_pallas=False, **kw)),
            load_model(path, RuntimeConfig(**kw), device="cpu"))


def prompt_words(n, start=3):
    """n words of the file's vocabulary (" t0" .. " t40"; the tokenizer
    spells each in 3-4 byte tokens)."""
    return "".join(f" t{(start + i) % 41}" for i in range(n))


def greedy(session, prompt, n):
    out = []
    assert session.ingest(prompt)
    assert session.generate(out.append, num_tokens=n, temp=0.0)
    return "".join(out)


@pytest.mark.parametrize("n_batch", [64, 512])
def test_session_windows_match_jax(ggjt_path, tmp_path, n_batch):  # noqa: F811
    """FastLlama on LlamaModel with every window replayed from its graph
    (a 75-token prompt in n_batch chunks, a generation that recycles the
    context, save_state, reset, load_state, perplexity over 112 tokens)
    against the JAX session: the same greedy streams and perplexity. The
    windows' graphs build once a key: the reload replays."""
    jm, tm = session_models(ggjt_path, n_batch)
    js_, ts_ = (JaxFastLlama(jm, n_keep=16, seed=5),
                FastLlama(tm, n_keep=16, seed=5))

    def both(fn):
        return fn(js_), fn(ts_)

    j, t = both(lambda s: greedy(s, prompt_words(20), 70))    # recycles
    assert t == j and t
    cache = tm._graphs
    assert cache.captures >= 1
    path = str(tmp_path / "state.npz")
    assert ts_.save_state(path) and js_.save_state(path + ".jax.npz")
    j, t = both(lambda s: greedy(s, prompt_words(5, 30), 6))
    assert t == j
    built = cache.captures
    for s, p in ((js_, path + ".jax.npz"), (ts_, path)):
        assert s.reset() and s.load_state(p)
    replays = cache.replays
    assert both(lambda s: greedy(s, prompt_words(5, 30), 6)) == (j, t)
    assert cache.captures == built and cache.replays > replays
    text = prompt_words(30, 7)
    jp_, tp_ = both(lambda s: s.perplexity(text))
    np.testing.assert_allclose(tp_, jp_, rtol=1e-4)


def test_window_graph_keys(ggjt_path, tmp_path):  # noqa: F811
    """One graph a (config, bucket) pair and state: a later window of a
    bucket already seen replays at any offset; a new bucket or the fresh
    window's config captures; a LoRA attach is a new key; a state load
    writes the caches in place and keeps the graphs; the context boundary
    takes an exact length, counted. The cache drops its least recently
    used graph past its size."""
    _, tm = session_models(ggjt_path, 16)
    cache = tm._graphs
    ids = window_tokens(60, 2).tolist()
    tm.eval(0, ids[:10])                         # fresh, bucket 16
    tm.eval(10, ids[10:15])                      # later, bucket 16
    assert (cache.captures, cache.replays) == (2, 0)
    tm.eval(15, ids[15:27])                      # replays at a new offset
    assert (cache.captures, cache.replays) == (2, 1)
    tm.eval(27, ids[27:60])                      # bucket 64
    assert cache.captures == 3
    state = tm.kv_state()
    tm.reset()
    tm.load_kv_state(state)
    tm.eval(60, ids[:9])                         # bucket 16, loaded caches
    assert (cache.captures, cache.replays) == (3, 2)
    assert tm.attach_lora(cached_adapter(str(tmp_path / "a.bin")))
    tm.eval(60, ids[:9])
    assert cache.captures == 4
    assert tm.detach_lora()
    before = tm.boundary_windows
    tm.eval(120, ids[:7])                        # room 8: no bucket fits
    assert tm.boundary_windows == before + 1 and cache.captures == 5

    small = GraphCache("cpu", size=2)
    for shape in ((1,), (2,), (3,), (1,)):
        small(lambda a: a + 1, ("s",), (), torch.zeros(shape))
    assert (small.captures, small.evictions, len(small.graphs)) == (4, 2, 2)
    small(lambda a: a + 1, ("s",), (), torch.zeros(1))
    assert small.replays == 1 and small.captures == 4


def test_ttft_step_replays_one_graph():
    """bench_torch's TTFT prefill is one graph (bench.py's jitted
    prefill_step): the window and its argmax captured once, each trial on
    the zeroed cache a replay whose token equals the first's."""
    from test_torch_bench import HP as BHP
    from test_torch_bench import N_CTX as BN
    from fastllama_tpu_torch.models.synthetic import build_model
    params = build_model(BHP, seed=0, device="cpu")
    prefill = bench_torch.prefill_step_fn(params, BHP, BN, "cpu", True)
    kv = tl.init_kv_cache(BHP, 1, BN, torch.bfloat16, "cpu")
    toks = torch.from_numpy(window_tokens(BN, 3)[None])
    with torch.inference_mode():
        first = int(prefill(toks, kv)[0, 0])
        for _ in range(2):
            for k, v in kv:
                k.zero_()
                v.zero_()
            assert int(prefill(toks, kv)[0, 0]) == first
    assert prefill.graph.captures == 1 and prefill.graph.replays == 2


# ---------------------------------------------------------------------------
# the engine: admissions through their graphs
# ---------------------------------------------------------------------------

ADMISSION_KINDS = ("prefill", "chunk", "splice")


def engine_requests(mod, n=6, **kw):
    return [mod.Request(prompt=words(3 * i, 2 + 2 * i), max_tokens=7, **kw)
            for i in range(n)]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_admissions_match_jax_greedy(world, mode, depth):  # noqa: F811
    """temp 0: an engine whose admissions (monolithic prefill with its
    splice and first token, or the chunk steps and the final splice)
    replay their graphs gives the JAX engine's streams, at drain depth 0
    and 2, in slab, paged, chunked slab and chunked paged modes; each
    admission step kind builds once a bucket."""
    je = jax_engine(world, temp=0.0, drain_depth=depth, **MODES[mode])
    te = port_engine(world, temp=0.0, drain_depth=depth, **MODES[mode])
    jr, tr = engine_requests(js), engine_requests(ts)
    je.run(jr)
    te.run(tr)
    assert [r.tokens_out for r in tr] == [r.tokens_out for r in jr]
    assert all(len(r.tokens_out) == 7 for r in tr)
    # one admission step a request, or its chunks and the final splice
    chunk = te._adm_chunk
    steps = sum(1 + (-(-r.n_prompt // chunk) if "chunked" in mode else 0)
                for r in tr)
    adm = [g for kind in ADMISSION_KINDS for g in te._graphs.entries(kind)]
    assert sum(g.captures + g.replays for g in adm) == steps
    assert sum(g.replays for g in adm) > 0


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_admissions_replayed_equal_eager_sampled(world, mode,  # noqa: F811
                                                        depth):
    """temp 0.8, one seed, per-request knobs (a top_p of 1 and a penalty
    among them): the streams of an engine whose admissions and steps
    replay their graphs equal those of the same engine with every graph
    taken off (eager, as under a mesh), and the generators end alike. The
    knobs are device rows of the admission step, so they make no keys of
    their own: one prefill graph a bucket (or one chunk and one splice
    graph), and the cache never drops one."""
    def run(graph):
        eng = port_engine(world, temp=0.8, drain_depth=depth,
                          sampling_seed=3, **MODES[mode])
        if not graph:
            eng._graphs = None
        reqs = engine_requests(ts)
        reqs[1].top_p, reqs[2].repeat_penalty = 1.0, 1.3
        reqs[3].top_k, reqs[4].temp = 5, 0.0
        eng.run(reqs)
        return eng, reqs
    geng, greqs = run(True)
    eeng, ereqs = run(False)
    got, want = ([r.tokens_out for r in q] for q in (greqs, ereqs))
    assert got == want and all(len(t) == 7 for t in got)
    assert torch.equal(geng._gen.get_state(), eeng._gen.get_state())
    cache = geng._graphs
    keys = {kind: len(cache.entries(kind)) for kind in ADMISSION_KINDS}
    if "chunked" in mode:
        assert keys == {"prefill": 0, "chunk": 1, "splice": 1}
    else:
        buckets = {next(b for b in geng._buckets if b >= r.n_prompt)
                   for r in greqs}
        assert keys == {"prefill": len(buckets), "chunk": 0, "splice": 0}
    assert cache.evictions == 0


# ---------------------------------------------------------------------------
# on the card: the captures themselves
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured only there")
    cuda_lib.build()
    return torch.device("cuda")


@pytest.mark.cuda
def test_window_replays_are_bit_equal_to_eager_windows(models, cuda_device):
    """bf16 on the card: windows of buckets 16 and 64 at n_past 0 and
    PAST, each key captured once then replayed at other contents, give
    the eager int route's logits, embeddings and cache rows bit for bit,
    and a replay adds the eager window's launches."""
    tp = tl.params_from_numpy(numpy_tree(models["q4"][0]), device=cuda_device)
    cfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot)
    tables = tl.position_tables(N_CTX, HP.head_dim, HP.n_rot, cuda_device)
    gkv, ikv = (tl.init_kv_cache(HP, 1, N_CTX, torch.bfloat16, cuda_device)
                for _ in range(2))
    graphs = GraphCache(cuda_device)
    with torch.inference_mode():
        for rep in range(3):
            for bucket, n_past in ((16, 0), (64, PAST), (16, PAST)):
                t = bucket - rep - 1
                toks = np.zeros((1, bucket), np.int64)
                toks[0, :t] = window_tokens(t, 10 * rep + bucket)
                before = cuda_lib.counts()
                glog, _, gemb = tl.forward_jit(
                    tp, torch.from_numpy(toks), i32(n_past), gkv, cfg,
                    i32(t - 1), tables, graphs=graphs)
                glog, gemb = glog.clone(), gemb.clone()
                mid = cuda_lib.counts()
                ilog, _, iemb = tl.forward(
                    tp, torch.from_numpy(toks).to(cuda_device),
                    n_past, ikv, cfg, t - 1, tables)
                after = cuda_lib.counts()
                assert torch.equal(glog, ilog) and torch.equal(gemb, iemb)
                replayed = [m - b for m, b in zip(mid, before)]
                eager = [a - m for a, m in zip(after, mid)]
                # the tensor route's row writes are slab_write_rows
                # launches where the int route slices
                rw = [i for i, (w, _) in enumerate(cuda_lib.COUNTED)
                      if w is slab_write_rows][0]
                assert replayed[rw] == 2 * HP.n_layer and eager[rw] == 0
                replayed[rw] = 0
                assert replayed == eager and sum(eager) > 0
        torch.cuda.synchronize()
    for (gk, gv), (ik, iv) in zip(gkv, ikv):
        assert torch.equal(gk, ik) and torch.equal(gv, iv)
    assert graphs.captures == 2 and graphs.replays == 7


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_admission_replays_draw_what_eager_draws(cuda_device, mode):
    """bf16 on the card (head_dim 128), temp 0.8: an engine whose admissions and steps
    replay their graphs streams what the same engine with the graphs taken
    off streams, request for request (the first token drawn from each
    request's own generator into the admission's input)."""
    tp = tl.params_from_numpy(numpy_tree(tfl.jax_params()),
                              device=cuda_device)

    def run(graph):
        eng = ts.BatchEngine(
            tfl.HP, tp, tfl.vocab(), n_slots=3, n_ctx=128,
            rcfg=RuntimeConfig(n_batch=16, prefill_buckets=(16, 32, 128)),
            temp=0.8, sampling_seed=3, device=cuda_device, **MODES[mode])
        if not graph:
            eng._graphs = None
        reqs = engine_requests(ts)
        eng.run(reqs)
        return eng, [r.tokens_out for r in reqs]
    geng, got = run(True)
    _, want = run(False)
    # (a sampled stream may end early on EOS: random weights)
    assert got == want and all(got)
    assert geng._graphs.replays > 0
