"""PyTorch port: the fresh-prompt flash prefill attention (kernel B12's
plain version) against the JAX package's _flash_prefill_attention, which
calls the library Pallas TPU kernel, run here in TPU interpret mode; the
port's bf16 forward and paged prefill with the gate open against the JAX
forward with its gate opened the same way; and the gate itself."""
import dataclasses
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fastllama_tpu.config import HyperParams
from fastllama_tpu.engine import paged_kv as jpk
from fastllama_tpu.models import llama as jl
from fastllama_tpu.models.fuse import make_layer_params
from fastllama_tpu.quant.q4 import quantize_q4_0
from fastllama_tpu.quant.tensor import make_embedding, make_matmul_weight
from fastllama_tpu_torch.config import RuntimeConfig
from fastllama_tpu_torch.engine import paged_kv as tpk
from fastllama_tpu_torch.engine import scheduler as ts
from fastllama_tpu_torch.engine.tokenizer import Vocab
from fastllama_tpu_torch.kernels import flash_prefill as tfp
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.models.runtime import LlamaModel

from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

# head_dim 128: the kernel's width and the gate's lane alignment
HP = HyperParams(n_vocab=320, n_embd=256, n_head=2, n_layer=2, n_rot=128)
N_FF = 256
N_CTX = 256
# the library kernel's output is bf16: a rounding tie or a sum order can
# move an element by one bf16 ulp (2^-8 relative), so 2^-7 of the largest
# output
TOL = 2.0 ** -7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def qkv_inputs(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def jax_flash(q, k, v):
    """The JAX package's _flash_prefill_attention, the library Pallas
    kernel in TPU interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        out = jl._flash_prefill_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q.shape[-1])
        return np.asarray(jax.block_until_ready(out))


def close(got, want, rel=TOL):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# B12's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("t", [128, 512, 1024])
def test_plain_matches_the_library_kernel(t, b):
    """flash_prefill_plain (and the wrapper on CPU tensors) against the
    library kernel in interpret mode, T = 1024 taking two 512-row blocks,
    within 2^-7 of the largest output; the output is bf16-valued."""
    q, k, v = qkv_inputs(b, t, 2, 128, seed=t + b)
    want = jax_flash(q, k, v)
    launches = tfp.flash_prefill.launches
    got = tfp.flash_prefill(*(torch.from_numpy(x) for x in (q, k, v)))
    assert tfp.flash_prefill.launches == launches      # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (b, t, 2, 128)
    assert torch.equal(got, got.to(torch.bfloat16).float())
    close(got.numpy(), want)
    plain = tfp.flash_prefill_plain(*(torch.from_numpy(x) for x in (q, k, v)))
    assert torch.equal(got, plain)


def test_plain_reads_strided_views():
    """q and k as the halves of a roped [B, T, 2H, Dh] tensor and v as a
    slice of the fused projection (the forward's views) give the result of
    contiguous copies."""
    rng = np.random.default_rng(3)
    qk = torch.from_numpy(rng.standard_normal((2, 128, 4, 128)).astype(
        np.float32))
    qkv = torch.from_numpy(rng.standard_normal((2, 128, 3 * 256)).astype(
        np.float32))
    q, k = qk[:, :, :2], qk[:, :, 2:]
    v = qkv[..., 512:].reshape(2, 128, 2, 128)
    assert not v.is_contiguous()
    got = tfp.flash_prefill(q, k, v)
    want = tfp.flash_prefill(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


def test_plain_is_causal_attention_to_bf16_rounding():
    """The plain version is softmax(q k^T / sqrt(Dh), causal) v of the
    bf16-rounded operands, to the roundings it adds (p and the output in
    bf16)."""
    q, k, v = (torch.from_numpy(x) for x in qkv_inputs(1, 256, 2, 128, 7))
    r = [x.to(torch.bfloat16).float().transpose(1, 2) for x in (q, k, v)]
    s = r[0] @ r[1].transpose(-1, -2) / math.sqrt(128)
    s = s.masked_fill(torch.ones(256, 256).triu(1).bool(), -math.inf)
    want = (torch.softmax(s, -1) @ r[2]).transpose(1, 2)
    close(tfp.flash_prefill_plain(q, k, v).numpy(), want.numpy())


@pytest.mark.parametrize("bad", ["shape", "bf16", "mixed"])
def test_wrapper_refuses_bad_inputs(bad):
    """The forward hands B12 f32 operands of one shape; anything else is
    refused on the CPU as on the card."""
    q, k, v = (torch.from_numpy(x) for x in qkv_inputs(1, 128, 2, 128, 1))
    if bad == "shape":
        k = k[:, :64]
    elif bad == "bf16":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    else:
        v = v.to(torch.bfloat16)
    with pytest.raises(ValueError):
        tfp.flash_prefill(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("t,h", [(128, 2), (512, 32), (1024, 8)])
def test_kernel_matches_plain_on_the_card(cuda_device, t, h, b):
    """B12 on the card against its plain version on the same inputs (q and
    k strided halves of one tensor, v a strided slice), within 2^-7 of the
    largest output, bf16-valued, launches counted."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(t + h)
    qk = torch.randn((b, t, 2 * h, 128), generator=gen, device=cuda_device)
    qkv = torch.randn((b, t, 3 * h * 128), generator=gen, device=cuda_device)
    q, k = qk[:, :, :h], qk[:, :, h:]
    v = qkv[..., 2 * h * 128:].reshape(b, t, h, 128)
    n = tfp.flash_prefill.launches
    got = tfp.flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert tfp.flash_prefill.launches == n + 1
    want = tfp.flash_prefill_plain(q, k, v)
    assert torch.isfinite(got).all()
    assert torch.equal(got, got.to(torch.bfloat16).float())
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item()


@pytest.mark.cuda
def test_kernel_refuses_unsupported_shapes(cuda_device):
    q = torch.zeros((1, 96, 2, 128), device=cuda_device)
    with pytest.raises(ValueError):
        tfp.flash_prefill(q, q, q)                     # T % 64
    q = torch.zeros((1, 128, 2, 64), device=cuda_device)
    with pytest.raises(ValueError):
        tfp.flash_prefill(q, q, q)                     # head_dim


# ---------------------------------------------------------------------------
# the slice: forward and forward_paged_prefill with the gate open
# ---------------------------------------------------------------------------

def jax_params(seed=0):
    rng = np.random.default_rng(seed)

    def qw(k_in, n_out, scale=0.1):
        return ("q4",) + quantize_q4_0(
            (rng.standard_normal((n_out, k_in)) * scale).astype(np.float32))

    d = HP.n_embd
    layers = [make_layer_params(
        HP.n_head,
        attention_norm=(1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ffn_norm=(1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        wq=qw(d, d, 0.2), wk=qw(d, d, 0.2), wv=qw(d, d), wo=qw(d, d),
        w1=qw(d, N_FF), w2=qw(N_FF, d), w3=qw(d, N_FF),
    ) for _ in range(HP.n_layer)]
    emb = (rng.standard_normal((HP.n_vocab, d)) * 0.4).astype(np.float32)
    out = (rng.standard_normal((HP.n_vocab, d)) * 0.15).astype(np.float32)
    return jl.LlamaParams(
        tok_embeddings=make_embedding(*quantize_q4_0(emb)),
        norm=jnp.ones(d), output=make_matmul_weight(*quantize_q4_0(out)),
        layers=layers)


def with_qkv_lora(jp, tp, seed=5):
    """A delta LoRA term on wq and an (a, b) term on wv of layer 0."""
    rng = np.random.default_rng(seed)
    d = HP.n_embd
    dq = (rng.standard_normal((d, d)) * 0.02).astype(np.float32)
    a = (rng.standard_normal((d, 8)) * 0.1).astype(np.float32)
    bm = (rng.standard_normal((8, d)) * 0.1).astype(np.float32)
    jp = dataclasses.replace(jp, layers=[dataclasses.replace(
        jp.layers[0], lora_wq=jl.LoraTerm(delta=jnp.asarray(dq)),
        lora_wv=jl.LoraTerm(a=jnp.asarray(a), b=jnp.asarray(bm)))]
        + jp.layers[1:])
    tp = dataclasses.replace(tp, layers=[dataclasses.replace(
        tp.layers[0], lora_wq=tl.LoraTerm(delta=torch.from_numpy(dq)),
        lora_wv=tl.LoraTerm(a=torch.from_numpy(a), b=torch.from_numpy(bm)))]
        + tp.layers[1:])
    return jp, tp


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, tl.params_from_numpy(to_numpy_tree(jp), device="cpu")


def vocab():
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" w{i}".encode(), 1.0) for i in range(HP.n_vocab - len(toks))]
    return Vocab.from_tokens(toks)


def open_jax_gate(monkeypatch):
    """The JAX gate minus its backend test (a test-time override: the
    library kernel then runs in interpret mode on the CPU)."""
    def viable(cfg, t, hd):
        return (cfg.flash_prefill and cfg.sp_axis is None
                and t >= 128 and t % 128 == 0
                and hd % 128 == 0 and cfg.w_jdtype != jnp.float32)
    monkeypatch.setattr(jl, "_flash_viable", viable)


def spy_flash(monkeypatch):
    """Count the forward's calls of B12 (the name models/llama imported)."""
    calls = []
    real = tl.flash_prefill

    def spy(q, k, v):
        calls.append(q.shape)
        return real(q, k, v)
    monkeypatch.setattr(tl, "flash_prefill", spy)
    return calls


def jax_cfg(**kw):
    return jl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                            w_dtype="bfloat16", use_pallas=False,
                            prefill_int8=False, **kw)


PROMPT = [1] + np.random.default_rng(11).integers(3, HP.n_vocab,
                                                  127).tolist()   # 128


# Off the gate the two forwards agree to f32 rounding. With it open each
# side rounds q, k, v, p and the output to bf16, and the plain version
# parts from the library kernel by one bf16 ulp in a fifth of the ctx
# elements (held to 2^-7 above). This model's scores reach ~45, so p is
# peaked and such an ulp moves the logits by ~1e-2 of the largest after
# two layers, as much as the JAX flash path parts from its own masked f32
# path: the bf16 tolerance of the port's other bf16 paths, 3e-2.
SLICE_TOL = 3e-2


@pytest.mark.parametrize("lora", [False, True])
def test_forward_through_eval_matches_jax_flash(params, monkeypatch, lora):
    """The port's bf16 LlamaModel.eval at n_past 0 over a 128-token window
    (the session's first window: B12's plain version, in every layer, q/k/v
    LoRA or not) against the JAX package's un-jitted forward with
    flash_prefill=True and its gate opened under interpret mode."""
    jp, tp = params
    if lora:
        jp, tp = with_qkv_lora(jp, tp)
    calls = spy_flash(monkeypatch)
    lm = LlamaModel(HP, tp, vocab(), RuntimeConfig(
        n_ctx=N_CTX, kv_dtype="bfloat16", weight_dtype="bfloat16",
        prefill_int8=False), device="cpu")
    got = lm.eval(0, PROMPT)
    assert len(calls) == HP.n_layer
    emb = lm.get_embeddings()

    open_jax_gate(monkeypatch)
    jkv = jl.init_kv_cache(HP, 1, N_CTX, dtype=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        jlog, jkv, jemb = jl.forward(
            jp, jnp.asarray([PROMPT], jnp.int32), jnp.int32(0), jkv,
            jax_cfg(flash_prefill=True), jnp.int32(len(PROMPT) - 1))
        jlog, jemb = jax.block_until_ready((jlog, jemb))
    close(got, np.asarray(jlog)[0, -1], SLICE_TOL)
    close(emb, np.asarray(jemb)[0], SLICE_TOL)
    # the cache holds the window's rows as the masked path would write them
    for (tk, _), (jk, _) in zip(lm.kv, jkv):
        np.testing.assert_allclose(
            tk[0, :128].float().numpy(),
            np.asarray(jk[0, :128].astype(jnp.float32)),
            atol=2 ** -7 * float(jnp.abs(jk[0, :128]).max()))


def test_forward_paged_prefill_matches_jax_flash(params, monkeypatch):
    """forward_paged_prefill of a 120-token prompt bucketed to 128 (the
    sentinel tail) with flash_prefill=True against the JAX function with
    its gate opened under interpret mode; the pools' rows agree too."""
    jp, tp = params
    t0, bucket = 120, 128
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :t0] = PROMPT[:t0]
    kw = dict(n_slots=1, page_size=16, total_pages=8, pages_per_seq=8)
    jm = jpk.PagedKVManager(HP, dtype=jnp.bfloat16, **kw)
    tm = tpk.PagedKVManager(HP, dtype=torch.bfloat16, device="cpu", **kw)
    for m in (jm, tm):
        assert m.alloc_for(0, t0)
    pages = np.full(bucket, jm.sentinel, np.int32)
    offs = np.zeros(bucket, np.int32)
    pages[:t0], offs[:t0] = jm.token_page_offsets(0, 0, t0)

    calls = spy_flash(monkeypatch)
    tcfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                            w_dtype="bfloat16", prefill_int8=False,
                            flash_prefill=True)
    tlog, _, _ = tl.forward_paged_prefill(
        tp, torch.from_numpy(toks).long(), t0 - 1, torch.from_numpy(pages),
        torch.from_numpy(offs), tm.k_pages, tm.v_pages, tcfg)
    assert len(calls) == HP.n_layer

    open_jax_gate(monkeypatch)
    with pltpu.force_tpu_interpret_mode():
        jlog, jkp, _ = jl.forward_paged_prefill(
            jp, jnp.asarray(toks), jnp.int32(t0 - 1), jnp.asarray(pages),
            jnp.asarray(offs), jm.k_pages, jm.v_pages,
            jax_cfg(flash_prefill=True))
        jlog = jax.block_until_ready(jlog)
    close(tlog.numpy(), np.asarray(jlog), SLICE_TOL)
    used = sorted(set(pages[:t0].tolist()))
    for tk, jk in zip(tm.k_pages, jkp):
        want = np.asarray(jk[:, used].astype(jnp.float32))
        np.testing.assert_allclose(tk[:, used].float().numpy(), want,
                                   atol=2 ** -7 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def test_gate_conditions():
    cfg = tl.ForwardConfig(n_head=2, n_rot=128, flash_prefill=True)
    assert tl._flash_viable(cfg, 128, 128)
    assert tl._flash_viable(cfg, 1024, 256)
    assert not tl._flash_viable(dataclasses.replace(cfg, flash_prefill=False),
                                128, 128)
    assert not tl._flash_viable(dataclasses.replace(cfg, w_dtype="float32"),
                                128, 128)
    assert not tl._flash_viable(dataclasses.replace(cfg, sp_group=object()),
                                128, 128)
    for t in (1, 64, 192):                              # T < 128, T % 128
        assert not tl._flash_viable(cfg, t, 128)
    assert not tl._flash_viable(cfg, 128, 64)           # head_dim % 128


def session_model(params, mode="bfloat16"):
    return LlamaModel(HP, params[1], vocab(), RuntimeConfig(
        n_ctx=N_CTX, kv_dtype=mode, weight_dtype=mode, prefill_int8=False),
        device="cpu")


def test_session_windows_take_b12_only_at_n_past_0(params, monkeypatch):
    """LlamaModel.eval picks the flash config for n_past == 0 and t > 1,
    as the JAX runtime does: the first window (bucket 128) enters B12 in
    every layer; a later window (n_past > 0, as an ingest chunk, a
    recycling re-feed or a window after load_state is), a window whose
    bucket is under 128, a decode step and f32 mode do not."""
    calls = spy_flash(monkeypatch)
    lm = session_model(params)
    lm.eval(0, PROMPT)
    assert len(calls) == HP.n_layer
    lm.eval(len(PROMPT), PROMPT[:100])           # n_past > 0, bucket 128
    lm.eval(len(PROMPT) + 100, [5])              # decode
    lm.eval(0, PROMPT[:60])                      # bucket 64
    lm.eval(0, [7])                              # one token at n_past 0
    assert len(calls) == HP.n_layer
    session_model(params, "float32").eval(0, PROMPT)
    assert len(calls) == HP.n_layer


def test_forward_off_the_gate_keeps_the_masked_path(params, monkeypatch):
    """With flash_prefill=True the forward still attends by the masked
    softmax where the gate fails: a 192-row window (T % 128) and f32
    weights."""
    calls = spy_flash(monkeypatch)
    for mode, t in (("bfloat16", 192), ("float32", 128)):
        cfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                               w_dtype=mode, prefill_int8=False,
                               flash_prefill=True)
        kv = tl.init_kv_cache(HP, 1, N_CTX, dtype=getattr(torch, mode),
                              device="cpu")
        toks = torch.tensor([(PROMPT * 2)[:t]])
        logits, _, _ = tl.forward(params[1], toks, 0, kv, cfg)
        assert torch.isfinite(logits).all()
    assert calls == []


@pytest.mark.parametrize("kv_mode", ["slab", "paged"])
def test_engine_monolithic_admission_takes_b12(params, monkeypatch, kv_mode):
    """The engine's monolithic admission (slab row cache or paged) runs
    its prefill with flash_prefill=True: a prompt whose bucket is 128
    enters B12 in every layer, one whose bucket is 64 does not; chunked
    admission keeps the masked path, as in the JAX package."""
    calls = spy_flash(monkeypatch)
    prompts = [" ".join(f"w{i + 1}" for i in range(30)),
               " ".join(f"w{i + 1}" for i in range(8))]
    for chunked in (False, True):
        rcfg = RuntimeConfig(n_ctx=N_CTX, n_batch=128, kv_dtype="bfloat16",
                             weight_dtype="bfloat16", prefill_int8=False)
        eng = ts.BatchEngine(HP, params[1], vocab(), n_slots=2, n_ctx=N_CTX,
                             rcfg=rcfg, kv_mode=kv_mode, page_size=16,
                             temp=0.0, chunked_admission=chunked,
                             device="cpu")
        reqs = [ts.Request(prompt=p, max_tokens=3) for p in prompts]
        eng.run(reqs)
        assert all(r.done and len(r.tokens_out) == 3 for r in reqs)
        assert [64 < r.n_prompt <= 128 for r in reqs] == [True, False]
        assert len(calls) == HP.n_layer
