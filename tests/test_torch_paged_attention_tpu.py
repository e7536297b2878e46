"""PyTorch port: B21, engine/paged_kv.paged_attention_tpu (the library
Pallas TPU kernel paged_attention, which the JAX engine takes on pools past
its own kernel's gate), against the library kernel under
pltpu.force_tpu_interpret_mode(); the gate and the engine's route against
the JAX package's; a tiny long-context engine against the JAX engine."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fastllama_tpu.config import HyperParams, RuntimeConfig as JaxRuntimeConfig
from fastllama_tpu.engine import paged_kv as jpk
from fastllama_tpu.engine import scheduler as js
from fastllama_tpu.engine.tokenizer import Vocab as JaxVocab
from fastllama_tpu.kernels import paged_attention as jpa
from fastllama_tpu.models import llama as jl
from fastllama_tpu.models.fuse import make_layer_params
from fastllama_tpu.quant.q4 import quantize_q4_0
from fastllama_tpu.quant.tensor import make_embedding, make_matmul_weight
from fastllama_tpu_torch.config import RuntimeConfig
from fastllama_tpu_torch.engine import paged_kv as tpk
from fastllama_tpu_torch.engine import scheduler as ts
from fastllama_tpu_torch.engine.tokenizer import Vocab
from fastllama_tpu_torch.kernels import paged_attention as tpa
from fastllama_tpu_torch.models import llama as tl

from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

B, HKV, D, PS, P, PP = 3, 2, 128, 16, 14, 4
LENGTHS = np.array([37, 0, PP * PS], np.int32)     # mid-page, empty, full


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def inputs(g, seed=0):
    """q [B, g * HKV, D], pools [HKV, P, PS, D] f32 and a shuffled table, as
    numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, g * HKV, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((HKV, P, PS, D)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(P)[:B * PP].reshape(B, PP).astype(np.int32)
    return q, kp, vp, table


def library(q, kp, vp, lengths, table, ppcb):
    """The JAX package's paged_attention_tpu (the library kernel) in
    interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jpk.paged_attention_tpu(
            q, kp, vp, jnp.asarray(lengths), jnp.asarray(table),
            pages_per_compute_block=ppcb))


def both(q, kp, vp, qd, kd):
    """The same values for both packages in the given dtypes."""
    jq = jnp.asarray(q).astype(getattr(jnp, qd))
    jk, jv = (jnp.asarray(a).astype(getattr(jnp, kd)) for a in (kp, vp))
    tq = torch.from_numpy(q).to(getattr(torch, qd))
    tk, tv = (torch.from_numpy(a).to(getattr(torch, kd)) for a in (kp, vp))
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("g,ppcb", [(2, 1), (2, 2), (2, 4), (1, 2)])
@pytest.mark.parametrize("qd,kd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
def test_plain_matches_the_library_kernel(qd, kd, g, ppcb):
    """B21's plain version against the library kernel in interpret mode,
    within 1e-5 (about 1e-7 to 7e-7 measured): q pre-scaled to f32 (a bf16
    q gives f32 out), K and V read as bf16 (the library rounds f32 pools),
    Hq = g * Hkv, compute blocks of 1, 2 and 4 pages; a sequence of length
    0 gives zeros, as the library returns for it."""
    q, kp, vp, table = inputs(g)
    (jq, jk, jv), (tq, tk, tv) = both(q, kp, vp, qd, kd)
    want = library(jq, jk, jv, LENGTHS, table, ppcb)
    got = tpk.paged_attention_tpu(tq, tk, tv, torch.from_numpy(LENGTHS),
                                  torch.from_numpy(table),
                                  pages_per_compute_block=ppcb)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert got.shape == want.shape == (B, g * HKV, D)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert not want[1].any() and not got[1].any()


def test_f32_pools_are_read_as_bf16():
    """The library rounds f32 pools to bf16 (its page cast): it sits far
    from the JAX package's unrounded f32 reference and, as B21 does, on
    the reference of the rounded pools (the sequences of nonzero length:
    the reference averages every value at length 0)."""
    q, kp, vp, table = inputs(1, seed=1)
    (jq, jk, jv), (tq, tk, tv) = both(q, kp, vp, "float32", "float32")
    live = [0, 2]
    want = library(jq, jk, jv, LENGTHS, table, 2)[live]
    lens, tab = jnp.asarray(LENGTHS), jnp.asarray(table)
    exact = np.asarray(jpk.paged_attention_reference(
        jq, jk, jv, lens, tab))[live]
    rounded = np.asarray(jpk.paged_attention_reference(
        jq, *(a.astype(jnp.bfloat16).astype(jnp.float32) for a in (jk, jv)),
        lens, tab))[live]
    assert np.abs(want - exact).max() > 1e-4
    assert np.abs(want - rounded).max() <= 1e-5
    got = tpk.paged_attention_tpu(tq, tk, tv, torch.from_numpy(LENGTHS),
                                  torch.from_numpy(table)).numpy()[live]
    assert np.abs(got - rounded).max() <= 1e-5


def _bad_args():
    q, kp, vp, table = inputs(2)
    lens = LENGTHS
    yield "pages_per_compute_block must be divisible", (q, kp, vp, lens,
                                                         table, 3)
    yield "same shape", (q, kp, vp[:, :-1], lens, table, 2)
    yield "divisible by number of KV heads", (q[:, :3], kp, vp, lens, table,
                                              2)
    yield "head_dim of Q", (q[..., :64], kp, vp, lens, table, 2)
    yield "`lengths` and `q`", (q, kp, vp, lens[:2], table, 2)
    yield "`page_indices` and `q`", (q, kp, vp, lens, table[:2], 2)
    yield "must be int32", (q, kp, vp, lens.astype(np.float32), table, 2)


@pytest.mark.parametrize("match,args", list(_bad_args()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_raises_where_the_library_raises(match, args):
    q, kp, vp, lens, table, ppcb = args
    with pytest.raises(ValueError, match=match):
        jpk.paged_attention_tpu(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(lens),
                                jnp.asarray(table),
                                pages_per_compute_block=ppcb)
    with pytest.raises(ValueError, match=match):
        tpk.paged_attention_tpu(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (q, kp, vp, lens, table)),
            pages_per_compute_block=ppcb)


# -- the gate and the route ----------------------------------------------------

@pytest.mark.parametrize("h", [2, 32, 40])
def test_gate_matches_the_jax_gate(h):
    """paged_attn_group / paged_attn_supported against the JAX package's
    over (hd, ps, pp, itemsize), and the library block size against the JAX
    engine's cap."""
    for hd in (64, 128, 256):
        for ps in (8, 16, 60, 64):
            for pp in (1, 96, 192, 193, 384, 385, 512):
                for isz in (2, 4):
                    args = (h, pp, ps, hd, isz)
                    assert (tpa.paged_attn_group(*args)
                            == jpa.paged_attn_group(*args))
                    assert (tpa.paged_attn_supported(*args)
                            == jpa.paged_attn_supported(*args))
                    assert tpa.library_ppcb(pp, ps, hd) == min(
                        pp, max(1, (1 << 21) // (4 * ps * hd)))


def test_gate_fails_past_the_documented_rows():
    """At Dh 128 and 32 heads, pages of 64 rows: the JAX kernel takes 24,576
    rows a sequence of bf16 pools and 12,288 of f32 pools, no more."""
    for rows, isz, ok in ((24576, 2, True), (24640, 2, False),
                          (12288, 4, True), (12352, 4, False)):
        assert tpa.paged_attn_supported(32, rows // 64, 64, 128, isz) is ok


@pytest.mark.parametrize("hd,ps,n_ctx,isz,want", [
    (128, 64, 512, 2, None),              # the fused step (phase 6)
    (128, 64, 32768, 2, 64),              # B21, the 7B long-context engine
    (128, 64, 16384, 4, 64),              # B21, f32 pools past 12,288 rows
    (128, 64, 16384, 2, None),            # bf16 pools still fit
    (128, 60, 32760, 2, None),            # pages not of 8 rows: own route
    (96, 64, 32768, 2, None),             # no 128-lane heads: own route
])
def test_route_follows_the_jax_dispatch(hd, ps, n_ctx, isz, want):
    pp = -(-n_ctx // ps)
    route = ts.paged_attn_route(32, pp, ps, hd, isz)
    if want is None:
        assert route is None
    else:
        assert route.func is tpk.paged_attention_tpu
        assert route.keywords == {"pages_per_compute_block": want}


# -- a tiny engine past the f32 gate -------------------------------------------

HP = HyperParams(n_vocab=320, n_embd=256, n_head=2, n_layer=2, n_rot=128)
N_FF = 192
N_CTX = 16384               # pp 256 pages of 64: past the 12,288-row gate
KW = dict(kv_dtype="float32", weight_dtype="float32", n_batch=8,
          prefill_buckets=(8, 16, 32, 64))


def jax_params(seed=0):
    rng = np.random.default_rng(seed)

    def qw(k_in, n_out, scale=0.1):
        return ("q4",) + quantize_q4_0(
            (rng.standard_normal((n_out, k_in)) * scale).astype(np.float32))

    d = HP.n_embd
    layers = [make_layer_params(
        HP.n_head, attention_norm=np.ones(d, np.float32),
        ffn_norm=np.ones(d, np.float32), wq=qw(d, d), wk=qw(d, d),
        wv=qw(d, d), wo=qw(d, d), w1=qw(d, N_FF), w2=qw(N_FF, d),
        w3=qw(d, N_FF)) for _ in range(HP.n_layer)]
    emb = (rng.standard_normal((HP.n_vocab, d)) * 0.4).astype(np.float32)
    out = (rng.standard_normal((HP.n_vocab, d)) * 0.1).astype(np.float32)
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
    return dict(jp=jp, tp=tl.params_from_numpy(to_numpy_tree(jp),
                                               device="cpu"),
                jvocab=JaxVocab.from_tokens(vocab_tokens()),
                tvocab=Vocab.from_tokens(vocab_tokens()))


PROMPTS = ["w1 w2 w3", "w7 w8 w9 w10 w11 w12", "w20 w4"]


def requests(mod):
    return [mod.Request(prompt=p, max_tokens=6, temp=0.0) for p in PROMPTS]


def test_long_context_engine_takes_b21_and_matches_jax(world, monkeypatch):
    """A 2-layer engine of two 128-wide heads, f32 pools, n_ctx 16384 and
    pages of 64 rows (pp 256; total_pages set to 32, not the slab-sized
    default): past the JAX kernel's f32 gate, so the route is B21 with the
    JAX engine's 64-page compute blocks, every layer of every step, and
    never the fused step. Its greedy streams equal the JAX engine's on the
    CPU (whose step attends through its reference there)."""
    calls, fused = [], []
    real, real_fused = tpk.paged_attention_tpu, tl.paged_decode_step_fused

    def spy(*a, **kw):
        calls.append(kw["pages_per_compute_block"])
        return real(*a, **kw)
    monkeypatch.setattr(ts, "paged_attention_tpu", spy)
    monkeypatch.setattr(tl, "paged_decode_step_fused",
                        lambda *a: fused.append(1) or real_fused(*a))
    eng = ts.BatchEngine(HP, world["tp"], world["tvocab"], n_slots=2,
                         n_ctx=N_CTX, rcfg=RuntimeConfig(**KW),
                         kv_mode="paged", page_size=64, total_pages=32,
                         device="cpu")
    assert eng.pager.pages_per_seq == 256
    port = [list(r.tokens_out) for r in eng.run(requests(ts))]
    jeng = js.BatchEngine(HP, world["jp"], world["jvocab"], n_slots=2,
                          n_ctx=N_CTX,
                          rcfg=JaxRuntimeConfig(use_pallas=False, **KW),
                          kv_mode="paged", page_size=64, total_pages=32)
    ref = [list(r.tokens_out) for r in jeng.run(requests(js))]
    assert port == ref and all(len(t) == 6 for t in port)
    assert calls and set(calls) == {64} and len(calls) % HP.n_layer == 0
    assert fused == []
    assert eng.pager.free_pages == 32


def test_engine_raises_where_the_jax_engine_raises(world, monkeypatch):
    """n_ctx 25000 at pages of 64 rows: pp 391, and the JAX engine's block
    of 64 pages does not divide it. The JAX engine's step (built as on its
    accelerator) raises the library's ValueError when it is traced; the
    port's engine raises the same at its first decode step."""
    n_ctx, msg = 25000, "Got 64 and 391"
    kw = dict(n_slots=2, n_ctx=n_ctx, kv_mode="paged", page_size=64,
              total_pages=8)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jeng = js.BatchEngine(HP, world["jp"], world["jvocab"],
                          rcfg=JaxRuntimeConfig(use_pallas=False, **KW), **kw)
    monkeypatch.undo()
    pg = jeng.pager
    b = jeng.n_slots
    with pytest.raises(ValueError, match=msg):
        jax.eval_shape(
            jeng._decode_fn, jeng.params, jeng.d_tokens,
            jnp.zeros(b, jnp.int32), jnp.asarray(pg.page_tables),
            jnp.zeros(b, jnp.int32), jnp.zeros(b, jnp.int32), jeng.d_active,
            jeng.d_lastn, jeng.d_temps, jeng.d_topk, jeng.d_topp, jeng.d_rp,
            jeng._base_key, jeng.d_step, pg.k_pages, pg.v_pages)
    eng = ts.BatchEngine(HP, world["tp"], world["tvocab"],
                         rcfg=RuntimeConfig(**KW), device="cpu", **kw)
    assert eng.pager.pages_per_seq == 391
    with pytest.raises(ValueError, match=msg):
        eng.run(requests(ts)[:1])


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kd", ["bfloat16", "float32"])
@pytest.mark.parametrize("ppcb", [1, 2, 4])
def test_b21_kernel_matches_plain(cuda_device, kd, ppcb):
    """B21 on the card against its plain version at 1e-5 of the largest
    output (f32 sums in another order), Hq = 2 Hkv, a bf16 q, a length-0
    sequence (zeros); NaN in every page no sequence reaches; bit-equal
    twice; each call counted."""
    q, kp, vp, table = inputs(2, seed=3)
    dt = getattr(torch, kd)
    qd = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    kd_, vd = (torch.from_numpy(a).to(cuda_device, dt) for a in (kp, vp))
    lens = torch.from_numpy(LENGTHS).to(cuda_device)
    tab = torch.from_numpy(table).to(cuda_device)
    used = np.zeros(P, bool)
    for row, n in zip(table, LENGTHS):
        used[row[:-(-int(n) // PS)]] = True
    kq, vq = kd_.clone(), vd.clone()
    kq[:, torch.from_numpy(~used)] = float("nan")
    vq[:, torch.from_numpy(~used)] = float("nan")
    before = tpk.paged_attention_tpu.launches
    got = tpk.paged_attention_tpu(qd, kq, vq, lens, tab,
                                  pages_per_compute_block=ppcb)
    assert tpk.paged_attention_tpu.launches == before + 1
    want = tpk.paged_attention_tpu_plain(qd, kd_, vd, lens, tab)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= (
        1e-5 * want.abs().max().item())
    assert not got[1].any()
    assert torch.equal(got, tpk.paged_attention_tpu(
        qd, kq, vq, lens, tab, pages_per_compute_block=ppcb))
