"""PyTorch port: the bench path — models/synthetic.py against the JAX
package's __graft_entry__._build_model, and bench_torch.py's decode and
TTFT steps against the JAX forward on the same weights (bench.py's
steps), its JSON line against bench.py's keys."""
import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from __graft_entry__ import _build_model
from fastllama_tpu.config import HyperParams as JaxHyperParams
from fastllama_tpu.models import llama as jl
from fastllama_tpu_torch.config import HyperParams
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.models import synthetic
from fastllama_tpu_torch.quant.tensor import QuantEmbedding, QuantMatmulWeight
from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# two heads of 128 (B12's gate), a vocab whose head the loader pads (500
# logical columns stored as 512)
HP = HyperParams(n_vocab=500, n_embd=256, n_head=2, n_layer=2, n_rot=128)
JHP = JaxHyperParams(n_vocab=500, n_embd=256, n_head=2, n_layer=2, n_rot=128)
N_CTX = 256


@pytest.fixture(scope="module")
def jax_params():
    return _build_model(JHP, n_ff=HP.n_ff, seed=0)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return tl.params_from_numpy(to_numpy_tree(jax_params), device="cpu")


def leaves(p):
    yield "tok_embeddings", p.tok_embeddings
    yield "norm", p.norm
    yield "output", p.output
    for i, lp in enumerate(p.layers):
        for f in ("attention_norm", "wqkv", "wo", "ffn_norm", "w13", "w2"):
            yield f"layers.{i}.{f}", getattr(lp, f)


def test_synthetic_builder_matches_the_jax_builders_layout(jax_params):
    """Shapes, dtypes, logical widths and the loader's padding of every
    leaf equal _build_model's; codes span 0-255 and scales lie in [1e-3,
    dtype_scale] (the values differ: the generators differ)."""
    tp = synthetic.build_model(HP, seed=0, device="cpu", dtype_scale=0.05)
    got, want = dict(leaves(tp)), dict(leaves(jax_params))
    assert list(got) == list(want)
    for name, w in want.items():
        t = got[name]
        if hasattr(w, "qs"):
            assert isinstance(t, QuantEmbedding if "emb" in name
                              else QuantMatmulWeight), name
            assert tuple(t.qs.shape) == w.qs.shape, name
            assert tuple(t.scales.shape) == w.scales.shape, name
            assert t.qs.dtype == torch.uint8 and t.scales.dtype == \
                torch.float32, name
            if isinstance(t, QuantMatmulWeight):
                assert t.n_logical == w.n_logical and t.mins is None, name
            assert int(t.qs.min()) == 0 and int(t.qs.max()) == 255, name
            assert 1e-3 <= float(t.scales.min()) <= float(t.scales.max()) \
                <= 0.05, name
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    # the padded plane: the head's 500 columns stored as 512 (good_pad_n)
    assert tuple(tp.output.qs.shape) == (128, 512)
    assert tp.output.n_logical == 500
    again = synthetic.build_model(HP, seed=0, device="cpu", dtype_scale=0.05)
    assert torch.equal(again.layers[1].w2.qs, tp.layers[1].w2.qs)


def jax_greedy(params, tok, n_past, kv, cfg):
    logits, kv, _ = jl.forward(params, jnp.asarray(tok), jnp.int32(n_past),
                               kv, cfg)
    return int(jnp.argmax(logits[0, -1])), kv


def test_decode_step_matches_jax_forward(jax_params, port_params):
    """bench_torch's decode step (tensor n_past advanced on the device,
    greedy argmax) gives the JAX forward's greedy tokens below S."""
    step = bench_torch.decode_step_fn(port_params, HP, 32, "cpu")
    kv = tl.init_kv_cache(HP, 1, 32, torch.bfloat16, "cpu")
    jkv = jl.init_kv_cache(JHP, 1, 32, dtype=jnp.bfloat16)
    cfg = jl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot)
    tok = torch.zeros((1, 1), dtype=torch.int64)
    n_past = torch.zeros((1,), dtype=torch.int32)
    jtok, got, want = 0, [], []
    with torch.inference_mode():
        for i in range(6):
            tok = step(tok, n_past, kv)
            got.append(int(tok[0, 0]))
            jtok, jkv = jax_greedy(jax_params, [[jtok]], i, jkv, cfg)
            want.append(jtok)
    assert int(n_past[0]) == 6
    assert got == want


def test_decode_step_replays_one_graph(port_params):
    """bench_torch's decode step is one step graph (bench.py's jitted
    decode_step): the forward, the argmax and the n_past advance inside
    it. Over a run it keeps one key: the token it returns is the graph's
    output, copied back in as the next input, and the caller's n_past
    tensor advances in place; a TTFT trial's new n_past tensor and its
    token from the prefill are inputs, not a new key; a new cache is."""
    step = bench_torch.decode_step_fn(port_params, HP, 32, "cpu")
    kv = tl.init_kv_cache(HP, 1, 32, torch.bfloat16, "cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    n_past = torch.zeros((1,), dtype=torch.int32)
    with torch.inference_mode():
        outs = [step(tok, n_past, kv)]
        for _ in range(4):
            outs.append(step(outs[-1], n_past, kv))
        assert int(n_past[0]) == 5
        assert all(o is outs[0] for o in outs)
        at = torch.full((1,), 20, dtype=torch.int32)
        step(torch.tensor([[7]]), at, kv)
        assert int(at[0]) == 21 and step.graph.captures == 1
        step(tok, n_past, tl.init_kv_cache(HP, 1, 32, torch.bfloat16, "cpu"))
    assert step.graph.captures == 2


@pytest.mark.parametrize("int8", [True, False])
def test_ttft_step_matches_jax_forward(jax_params, port_params, int8):
    """bench_torch's TTFT prefill (a fresh 256-token window, flash prefill,
    int8 or bf16-exact prefill matmuls pinned) and the decode step after
    it: the JAX forward's greedy tokens (its masked route on the CPU)."""
    tokens = np.random.default_rng(0).integers(3, HP.n_vocab, (1, N_CTX))
    prefill = bench_torch.prefill_step_fn(port_params, HP, N_CTX, "cpu",
                                          int8)
    step = bench_torch.decode_step_fn(port_params, HP, N_CTX, "cpu")
    kv = tl.init_kv_cache(HP, 1, N_CTX, torch.bfloat16, "cpu")
    cfg = jl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                           flash_prefill=True, prefill_int8=int8)
    jkv = jl.init_kv_cache(JHP, 1, N_CTX, dtype=jnp.bfloat16)
    with torch.inference_mode():
        first = prefill(torch.from_numpy(tokens), kv)
        # the decode step at n_past T - 1 of a window one token shorter,
        # so that the step stays below S
        short = bench_torch.prefill_step_fn(port_params, HP, N_CTX, "cpu",
                                            int8)(
            torch.from_numpy(tokens[:, :-1]), kv)
        nxt = step(short, torch.tensor([N_CTX - 1], dtype=torch.int32), kv)
    want, _ = jax_greedy(jax_params, tokens, 0, jkv, cfg)
    jkv = jl.init_kv_cache(JHP, 1, N_CTX, dtype=jnp.bfloat16)
    jshort, jkv = jax_greedy(jax_params, tokens[:, :-1], 0, jkv,
                             dataclasses.replace(cfg, flash_prefill=False))
    jnext, _ = jax_greedy(jax_params, [[jshort]], N_CTX - 1, jkv,
                          jl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot))
    assert int(first[0, 0]) == want
    assert (int(short[0, 0]), int(nxt[0, 0])) == (jshort, jnext)


def bench_py_keys() -> set:
    """The keys of bench.py's JSON line, read from its source: the `out`
    dict literal and the keys it adds by subscript."""
    keys = set()
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "out"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                and t.value.id == "out" for t in node.targets):
            keys |= {t.slice.value for t in node.targets}
    return keys


def test_json_line_has_bench_pys_keys():
    """bench_torch.run end to end on the CPU at a tiny size: the line has
    bench.py's keys (vs_baseline from baseline_ref.json's 7B rate), finite
    and positive numbers; a 13B line leaves vs_baseline out, as bench.py
    does without a 13B rate in that file."""
    keys = bench_py_keys()
    assert {"metric", "value", "unit", "steady_state_tokens_per_sec",
            "ttft_ms_p50", "ttft_ms_p50_int8", "ttft_ms_p50_bf16",
            "vs_baseline"} == keys
    hp = dataclasses.replace(HP, n_layer=1)
    out = bench_torch.run(hp, "7b", "cpu", n_ctx=128, prompt=128, iters=2,
                          trials=1)
    assert set(out) == keys
    assert out["metric"] == "decode_tokens_per_sec_per_chip_7b_q4_0"
    assert out["unit"] == "tokens/s"
    for k in keys - {"metric", "unit"}:
        assert np.isfinite(out[k]) and out[k] > 0, k
    ref = ROOT / "baseline_ref.json"
    assert bench_torch.baseline_for("7b", ref)[0] == 1.388
    assert bench_torch.baseline_for("13b", ref)[0] is None
    line = bench_torch.result_line("13b", 2.0, 3.0, 4.0, 5.0, None)
    assert set(line) == keys - {"vs_baseline"}
    assert bench_torch.baseline_for("13b", ROOT / "missing.json") == (
        10.0, "estimate")


def test_chip_smoke_counts_bench_torchs_steps(monkeypatch):
    """chip_smoke.py's phase 11 holds bench_torch's launches to BENCH_STEPS
    decode steps and BENCH_WINDOWS prefill windows: bench_torch.run at its
    own iters and trials makes exactly that many of each."""
    import chip_smoke
    calls = {"step": 0, "window": 0}

    def counted(factory, key):
        def make(*a, **k):
            fn = factory(*a, **k)

            def call(*args):
                calls[key] += 1
                return fn(*args)
            return call
        return make
    monkeypatch.setattr(bench_torch, "decode_step_fn",
                        counted(bench_torch.decode_step_fn, "step"))
    monkeypatch.setattr(bench_torch, "prefill_step_fn",
                        counted(bench_torch.prefill_step_fn, "window"))
    bench_torch.run(dataclasses.replace(HP, n_layer=1), "7b", "cpu",
                    n_ctx=128, prompt=128)
    assert calls == {"step": chip_smoke.BENCH_STEPS,
                     "window": chip_smoke.BENCH_WINDOWS}


def test_chip_smoke_reads_a_scripts_launches():
    """chip_smoke.run_counted runs a script as __main__ in a subprocess and
    reads the launch counts it prints at its exit (every kernel's, the
    fused steps' (PS, B21F), the slab row write's, and the dequant path's;
    all 0 on the CPU, where no kernel launches)."""
    import chip_smoke
    rc, out, _, _, n = chip_smoke.run_counted(
        "tools_torch/bench_q4_floor.py", ["256", "128", "1", "floor",
                                          "--device", "cpu"], str(ROOT))
    assert rc == 0 and '"bench_q4_floor"' in out
    assert set(n) == {f"B{i}" for i in range(1, 22)} | {
        "PS", "B21F", "RW", "dequant"}
    assert not any(n.values())
