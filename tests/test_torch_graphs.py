"""PyTorch port: the compiled decode step (utils/step_graph.StepGraph, the
counterpart of jax.jit on the decode steps) against the JAX package.

On the CPU a StepGraph runs the step on its static buffers without a
capture, so these tests hold everything but the capture: the input copies,
the static outputs that the next step overwrites, the keys that a LoRA
attach, a detach or a new cache change and a state load or a reset keep.
The `cuda`-marked tests hold the capture itself on the card (replays
bit-equal to eager steps, the launch counts a replay adds, the generator a
capture leaves where an eager step leaves it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu.engine import scheduler as js
from fastllama_tpu.engine.session import FastLlama as JaxFastLlama
from fastllama_tpu.models import llama as jl
from fastllama_tpu_torch.engine import scheduler as ts
from fastllama_tpu_torch.engine.session import FastLlama
from fastllama_tpu_torch.kernels import cuda_lib
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.utils.step_graph import StepGraph, reached
from test_torch_lora import both_models, cached_adapter, ggjt_path  # noqa: F401
from test_torch_model import HP, jax_params, to_numpy_tree
from test_torch_scheduler import MODES, jax_engine, port_engine, words
from test_torch_scheduler import world  # noqa: F401

torch.set_num_threads(1)

PROMPT = [1] + list(range(40, 55))        # 16 tokens
STEPS = 16


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, tl.params_from_numpy(to_numpy_tree(jp), device="cpu")


def close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def decode_tokens(seed=3):
    return np.random.default_rng(seed).integers(3, HP.n_vocab, STEPS)


def prefilled(tp, mode, dev="cpu"):
    """A [1, 64] cache of `mode` with PROMPT prefilled by the int form."""
    cfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot, w_dtype=mode,
                           prefill_int8=False)
    kv = tl.init_kv_cache(HP, 1, 64, dtype=getattr(torch, mode), device=dev)
    tables = tl.position_tables(64, HP.head_dim, HP.n_rot, dev)
    tl.forward(tp, torch.tensor([PROMPT], device=dev), 0, kv, cfg, None,
               tables)
    return cfg, kv, tables


@pytest.mark.parametrize("mode,tol", [("float32", 1e-4),
                                      ("bfloat16", 3e-2)])
def test_forward_jit_decode_matches_jax_and_the_int_form(params, mode, tol):
    """16 decode steps after a 16-token prefill, the same tokens fed to
    both packages: the port's forward_jit_decode (tensor n_past, the step
    graph) is within the mode's parity tolerance of the JAX
    forward_jit_decode (f32: 1e-4 of the largest logit; bf16: 3e-2, B4's
    plain version against the JAX einsum path, as test_torch_model's bf16
    decode), and bit for bit the port's int-n_past forward, caches too."""
    jp, tp = params
    jcfg = jl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot, w_dtype=mode,
                            use_pallas=False, prefill_int8=False)
    jkv = jl.init_kv_cache(HP, 1, 64, dtype=getattr(jnp, mode))
    _, jkv, _ = jl.forward_jit(jp, jnp.asarray([PROMPT], jnp.int32),
                               jnp.int32(0), jkv, jcfg)
    cfg, gkv, tables = prefilled(tp, mode)
    _, ikv, _ = prefilled(tp, mode)
    graph = StepGraph("cpu")
    outs = []
    with torch.inference_mode():
        for i, tok in enumerate(decode_tokens()):
            n_past = len(PROMPT) + i
            jlog, jkv, jemb = jl.forward_jit_decode(
                jp, jnp.asarray([[tok]], jnp.int32), jnp.int32(n_past), jkv,
                jcfg)
            glog, _, gemb = tl.forward_jit_decode(
                tp, torch.tensor([[tok]]),
                torch.tensor([n_past], dtype=torch.int32), gkv, cfg, tables,
                graph=graph)
            ilog, _, iemb = tl.forward(tp, torch.tensor([[tok]]), n_past,
                                       ikv, cfg, None, tables)
            assert torch.equal(glog, ilog) and torch.equal(gemb, iemb)
            close(glog.numpy(), np.asarray(jlog), tol)
            close(gemb.numpy(), np.asarray(jemb), tol)
            outs.append(glog)
    for (gk, gv), (ik, iv) in zip(gkv, ikv):
        assert torch.equal(gk, ik) and torch.equal(gv, iv)
    # one key over the run, and every step's logits are the one static
    # output, which the next step overwrote
    assert graph.captures == 1
    assert all(o is outs[0] for o in outs)


def test_step_graph_keys(params):
    """The key: the static part by value, the input shapes and dtypes, and
    the identity of every object the state reaches (a LoRA term set on a
    layer in place is a new object there); a call with a new key rebuilds,
    one with the same key reuses the static buffers."""
    _, tp = params
    graph = StepGraph("cpu")
    x = torch.zeros(3)

    def fn(a):
        return a + 1

    state = (tp, [torch.zeros(2)])
    out = graph(fn, "s", state, x)
    assert graph.captures == 1 and torch.equal(out, torch.ones(3))
    assert graph(fn, "s", state, x + 1) is out and graph.captures == 1
    assert torch.equal(out, torch.full((3,), 2.0))
    graph(fn, "t", state, x)                            # static part
    graph(fn, "t", state, torch.zeros(4))               # input shape
    graph(fn, "t", state, torch.zeros(4, dtype=torch.float64))
    assert graph.captures == 4
    layer = tp.layers[0]
    objs = reached(state)
    for leaf in (layer.wqkv, tp.layers[1].w2, state[1][0], tp.norm):
        assert any(o is leaf for o in objs)
    try:
        layer.lora_wq = tl.LoraTerm(delta=torch.zeros(HP.n_embd, HP.n_embd))
        graph(fn, "t", state, torch.zeros(4, dtype=torch.float64))
        assert graph.captures == 5
    finally:
        layer.lora_wq = None
    graph(fn, "t", state, torch.zeros(4, dtype=torch.float64))
    assert graph.captures == 6
    graph(fn, "t", (tp, [torch.zeros(2)]), torch.zeros(4,
                                                       dtype=torch.float64))
    assert graph.captures == 7                          # a new tensor


def test_decode_row_write_drops_as_the_scatter():
    """The one-row-a-sequence write of a decode step (the captured step's
    K/V write in layers with q/k/v LoRA and in f32 mode) leaves the cache
    the general dropping scatter leaves: rows in range written, positions
    below 0 or at or past S dropped."""
    from fastllama_tpu_torch.kernels.kv_write import scatter_rows_drop
    rng = np.random.default_rng(9)
    b, s, f = 6, 16, 8
    cache = torch.from_numpy(rng.standard_normal((b, s, f)).astype(
        np.float32))
    val = torch.from_numpy(rng.standard_normal((b, 1, f)).astype(np.float32))
    pos = torch.tensor([[0], [5], [15], [16], [40], [-1]], dtype=torch.int32)
    got = cache.clone()
    tl._write_rows_drop(got, val, pos)
    want = cache.clone()
    p64 = pos.to(torch.int64)
    scatter_rows_drop(want.view(1, b * s, f),
                      (p64 + torch.arange(b)[:, None] * s).reshape(-1),
                      ((p64 >= 0) & (p64 < s)).reshape(-1),
                      val.reshape(1, -1, f))
    assert torch.equal(got, want)
    assert torch.equal(got[2, 15], val[2, 0])
    assert torch.equal(got[3], cache[3]) and torch.equal(got[5], cache[5])


def greedy_stream(session, prompt, n):
    out = []
    assert session.ingest(prompt)
    assert session.generate(out.append, num_tokens=n, temp=0.0)
    return "".join(out)


def test_session_through_the_step_graph_matches_jax(ggjt_path, tmp_path):
    """FastLlama on LlamaModel, every single-token step through the step
    graph, against the JAX session's greedy streams: a system prompt, a
    generation that recycles the context (n_ctx 64), save_state, reset,
    load_state, a LoRA attach and its detach between generations. State
    loads, resets and recycles keep the graph (the caches are written in
    place); attach builds a new key, detach comes back to the first key
    (the layers' fields are reset in place), whose graph the session's
    cache still holds, and restores the logits bit for bit."""
    jm, tm = both_models(ggjt_path)
    js_, ts_ = JaxFastLlama(jm, n_keep=16, seed=5), FastLlama(tm, n_keep=16,
                                                              seed=5)
    cache = tm._graphs

    def both(fn):
        return fn(js_), fn(ts_)

    for s in (js_, ts_):
        assert s.ingest(" t1 t2", is_system_prompt=True)
    j, t = both(lambda s: greedy_stream(s, " t3 t4", 8))
    assert t == j and t
    step = cache.last                         # the decode step's graph
    key, built = step.key, step.captures
    assert built == 1 and key is not None
    assert cache.entries("decode") == [step]

    j, t = both(lambda s: greedy_stream(s, " t5", 60))    # recycles
    assert t == j and ts_.n_past <= 64
    path = str(tmp_path / "state.npz")
    assert ts_.save_state(path) and js_.save_state(path + ".jax.npz")
    j, t = both(lambda s: greedy_stream(s, " t6", 6))
    assert t == j
    for s, p in ((js_, path + ".jax.npz"), (ts_, path)):
        assert s.reset() and s.load_state(p)
    j2, t2 = both(lambda s: greedy_stream(s, " t6", 6))
    assert (j2, t2) == (j, t)
    assert (step.key, step.captures) == (key, built)
    assert cache.entries("decode") == [step]

    for s in (js_, ts_):
        s.reset()
    base = both(lambda s: greedy_stream(s, " t7", 4))
    base_logits = ts_.get_logits().copy()
    adapter = cached_adapter(str(tmp_path / "adapter.bin"))
    assert jm.attach_lora(adapter) and tm.attach_lora(adapter)
    for s in (js_, ts_):
        s.reset()
    j, t = both(lambda s: greedy_stream(s, " t7", 4))
    assert t == j
    attached = cache.last
    assert attached is not step and attached.key != key
    assert attached.captures == 1 and len(cache.entries("decode")) == 2
    np.testing.assert_allclose(ts_.get_logits(), js_.get_logits(),
                               rtol=1e-4, atol=1e-4)
    assert jm.detach_lora() and tm.detach_lora()
    for s in (js_, ts_):
        s.reset()
    assert both(lambda s: greedy_stream(s, " t7", 4)) == base
    assert cache.last is step and step.captures == built
    assert len(cache.entries("decode")) == 2 and cache.evictions == 0
    np.testing.assert_array_equal(ts_.get_logits(), base_logits)


def test_embeddings_are_a_copy_of_the_static_output(ggjt_path):
    """get_embeddings after a decode step copies the graph's output, so
    the next step does not change an array already returned."""
    _, tm = both_models(ggjt_path)
    s = FastLlama(tm, n_keep=16, seed=5)
    greedy_stream(s, " t3", 2)
    first = s.get_embeddings()
    kept = first.copy()
    assert tm._embeddings is tm._graphs.last._outputs[1]
    greedy_stream(s, " t4", 2)
    assert tm._embeddings is tm._graphs.last._outputs[1]
    assert not np.array_equal(first, s.get_embeddings())
    np.testing.assert_array_equal(first, kept)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("mode", ["slab", "paged"])
def test_engine_graph_greedy_matches_jax(world, mode, depth):  # noqa: F811
    """temp 0: the engine's step graph gives the JAX engine's streams, at
    drain depth 0 and 2 (at 2 a banked step's tokens outlive the next
    steps, which overwrite the graph's output), with one key over the run:
    admissions and stops between steps write the slot state in place."""
    def reqs(mod):
        return [mod.Request(prompt=words(i, 2 + i), max_tokens=7)
                for i in range(5)]
    je = jax_engine(world, temp=0.0, drain_depth=depth, **MODES[mode])
    te = port_engine(world, temp=0.0, drain_depth=depth, **MODES[mode])
    jr, tr = reqs(js), reqs(ts)
    je.run(jr)
    te.run(tr)
    assert [r.tokens_out for r in tr] == [r.tokens_out for r in jr]
    assert all(len(r.tokens_out) == 7 for r in tr)
    assert [g.captures for g in te._graphs.entries("decode")] == [1]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("mode", ["slab", "paged"])
def test_engine_graph_equals_eager_sampled(world, mode, depth):  # noqa: F811
    """temp 0.8, one seed: the streams through the step graph equal the
    eager step's (the engine with no graph, as under a mesh), request for
    request, and the generator ends where the eager engine's does."""
    def run(graph):
        eng = port_engine(world, temp=0.8, drain_depth=depth,
                          sampling_seed=3, **MODES[mode])
        if not graph:
            eng._graphs = None
        reqs = [ts.Request(prompt=words(i, 2 + i), max_tokens=9)
                for i in range(5)]
        eng.run(reqs)
        return eng, [r.tokens_out for r in reqs]
    geng, got = run(True)
    eeng, want = run(False)
    assert got == want and all(len(t) == 9 for t in got)
    assert torch.equal(geng._gen.get_state(), eeng._gen.get_state())
    assert [g.captures for g in geng._graphs.entries("decode")] == [1]


def test_engine_step_returns_a_tensor_of_its_own(world):  # noqa: F811
    """Each launched step banks its tokens in a tensor of its own, not the
    graph's output (which the next step overwrites)."""
    eng = port_engine(world, temp=0.0, drain_depth=4)
    eng.submit(ts.Request(prompt=words(3, 3), max_tokens=20))
    for _ in range(4):
        eng.step()
    out = eng._graphs.entries("decode")[0]._outputs
    assert all(e[0].data_ptr() != out.data_ptr() for e in eng._inflight)


# ---------------------------------------------------------------------------
# on the card: the capture itself
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured only there")
    cuda_lib.build()
    return torch.device("cuda")


def card_params(params, dev):
    return tl.params_from_numpy(to_numpy_tree(params[0]), device=dev)


@pytest.mark.cuda
def test_replays_are_bit_equal_to_eager_steps(params, cuda_device):
    """bf16 on the card (B1 and B4): 16 replays give the eager int-form
    steps' logits and caches bit for bit, and the kernels' launch counts
    after them equal those of 16 eager steps."""
    tp = card_params(params, cuda_device)
    cfg, gkv, tables = prefilled(tp, "bfloat16", cuda_device)
    _, ikv, _ = prefilled(tp, "bfloat16", cuda_device)
    graph = StepGraph(cuda_device)
    toks = decode_tokens()

    def graph_step(i):
        return tl.forward_jit_decode(
            tp, torch.tensor([[toks[i]]]),
            torch.tensor([len(PROMPT) + i], dtype=torch.int32), gkv, cfg,
            tables, graph=graph)[0]

    def eager_step(i):
        return tl.forward(tp, torch.tensor([[toks[i]]], device=cuda_device),
                          len(PROMPT) + i, ikv, cfg, None, tables)[0]

    with torch.inference_mode():
        graph_step(0)                   # the warm-up and the capture
        eager_step(0)
        before = cuda_lib.counts()
        for i in range(1, STEPS):
            g = graph_step(i).clone()
            assert torch.equal(g, eager_step(i))
        mid = cuda_lib.counts()
        for i in range(1, STEPS):          # eager alone, one more time
            eager_step(i)
        after = cuda_lib.counts()
    assert graph.captures == 1 and graph.replays == STEPS - 1
    replays_and_eager = [m - b for m, b in zip(mid, before)]
    eager = [a - m for a, m in zip(after, mid)]
    assert [2 * e for e in eager] == replays_and_eager and sum(eager) > 0
    for (gk, gv), (ik, iv) in zip(gkv, ikv):
        assert torch.equal(gk, ik) and torch.equal(gv, iv)


@pytest.mark.cuda
def test_capture_leaves_the_generator_where_eager_leaves_it(cuda_device):
    """A step drawing from a non-default generator: the first call (its
    warm-up, then the capture) moves the generator as one eager step does,
    and each replay draws what the next eager step draws."""
    def draws(gen):
        return torch.rand((4, 8), generator=gen, device=cuda_device) * 2

    g1 = torch.Generator(device=cuda_device)
    g2 = torch.Generator(device=cuda_device)
    g1.manual_seed(7)
    g2.manual_seed(7)
    graph = StepGraph(cuda_device, generators=(g1,))
    first = graph(lambda: draws(g1), "rng", ()).clone()
    assert torch.equal(first, draws(g2))
    assert torch.equal(g1.get_state(), g2.get_state())
    for _ in range(3):
        assert torch.equal(graph(lambda: draws(g1), "rng", ()), draws(g2))
    assert torch.equal(g1.get_state(), g2.get_state())
    assert graph.replays == 3 and graph.captures == 1


@pytest.mark.cuda
def test_capture_counts_no_launch_itself(params, cuda_device):
    """A capture adds no launch to the counters; the warm-up adds one
    eager step's."""
    tp = card_params(params, cuda_device)
    cfg, kv, tables = prefilled(tp, "bfloat16", cuda_device)
    before = cuda_lib.counts()
    with torch.inference_mode():
        tl.forward(tp, torch.tensor([[5]], device=cuda_device), 16, kv, cfg,
                   None, tables)
        one = [a - b for a, b in zip(cuda_lib.counts(), before)]
        mark = cuda_lib.counts()
        graph = StepGraph(cuda_device)
        tl.forward_jit_decode(tp, torch.tensor([[5]]),
                              torch.tensor([16], dtype=torch.int32), kv, cfg,
                              tables, graph=graph)
    assert [a - b for a, b in zip(cuda_lib.counts(), mark)] == one
    assert sum(graph.launches_per_replay().values()) == sum(one)
