"""PyTorch port: params_from_numpy and the forward pass against
fastllama_tpu.models.llama.forward on a tiny random q4_0 model."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastllama_tpu.config import HyperParams
from fastllama_tpu.models import llama as jl
from fastllama_tpu.models.fuse import make_layer_params
from fastllama_tpu.quant.q4 import quantize_q4_0
from fastllama_tpu.quant.tensor import (
    QuantEmbedding, QuantMatmulWeight, make_embedding, make_matmul_weight,
)
from fastllama_tpu_torch.models import llama as tl

torch.set_num_threads(1)

HP = HyperParams(n_vocab=256, n_embd=128, n_head=2, n_layer=2, n_rot=32)
N_FF = 96


def jax_params(seed=0):
    rng = np.random.default_rng(seed)

    def qw(k_in, n_out, scale=0.15):
        return ("q4",) + quantize_q4_0(
            (rng.standard_normal((n_out, k_in)) * scale).astype(np.float32))

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


def to_numpy_tree(p):
    """JAX LlamaParams -> the numpy tree params_from_numpy takes."""
    def leaf(w):
        if isinstance(w, QuantMatmulWeight):
            return {"qs": np.asarray(w.qs), "scales": np.asarray(w.scales),
                    "n_logical": w.n_logical}
        if isinstance(w, QuantEmbedding):
            return {"qs": np.asarray(w.qs), "scales": np.asarray(w.scales)}
        return np.asarray(w)
    return {"tok_embeddings": leaf(p.tok_embeddings), "norm": leaf(p.norm),
            "output": leaf(p.output),
            "layers": [{f: leaf(getattr(lp, f)) for f in (
                "attention_norm", "wqkv", "wo", "ffn_norm", "w13", "w2")}
                for lp in p.layers]}


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, tl.params_from_numpy(to_numpy_tree(jp), device="cpu")


def test_params_from_numpy_copies_the_planes(params):
    jp, tp = params
    for jw, tw in ((jp.output, tp.output),
                   (jp.layers[1].w13, tp.layers[1].w13),
                   (jp.layers[0].w2, tp.layers[0].w2)):
        assert tw.n_logical == jw.n_logical
        np.testing.assert_array_equal(tw.qs.numpy(), np.asarray(jw.qs))
        np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
    np.testing.assert_array_equal(tp.tok_embeddings.qs.numpy(),
                                  np.asarray(jp.tok_embeddings.qs))
    assert tp.layers[0].attention_norm.dtype == torch.float32


def run_both(params, mode, int8, tokens_seq, all_logits):
    """Prefill then one decode step on both packages; returns pairs of
    (port, jax) logits and embeddings per step."""
    jp, tp = params
    jcfg = jl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot, w_dtype=mode,
                            use_pallas=False, prefill_int8=int8,
                            all_logits=all_logits)
    tcfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot, w_dtype=mode,
                            prefill_int8=int8, all_logits=all_logits)
    jkv = jl.init_kv_cache(HP, 1, 512, dtype=getattr(jnp, mode))
    tkv = tl.init_kv_cache(HP, 1, 512, dtype=getattr(torch, mode),
                           device="cpu")
    out, n_past = [], 0
    for toks, last in tokens_seq:
        t = np.asarray([toks], np.int32)
        jlog, jkv, jemb = jl.forward_jit(jp, jnp.asarray(t), jnp.int32(n_past),
                                         jkv, jcfg, jnp.int32(last))
        tlog, tkv, temb = tl.forward(tp, torch.from_numpy(t).long(), n_past,
                                     tkv, tcfg, last)
        out.append((tlog.numpy(), np.asarray(jlog), temb.numpy(),
                    np.asarray(jemb)))
        n_past += last + 1
    return out


def close(a, b, rtol):
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max())


PROMPT = [1] + list(range(40, 55))        # 16 tokens


@pytest.mark.parametrize("all_logits", [False, True])
def test_forward_f32_prefill_and_decode(params, all_logits):
    steps = run_both(params, "float32", None,
                     [(PROMPT, len(PROMPT) - 1), ([77], 0), ([78], 0)],
                     all_logits)
    for tlog, jlog, temb, jemb in steps:
        assert tlog.shape == jlog.shape
        np.testing.assert_allclose(tlog, jlog, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(temb, jemb, rtol=1e-4, atol=1e-4)


def test_forward_padded_window_last_idx(params):
    """A bucket-padded window: the head and the tap read row last_idx."""
    padded = PROMPT[:10] + [0] * 6
    (tlog, jlog, temb, jemb), = run_both(params, "float32", None,
                                         [(padded, 9)], False)
    np.testing.assert_allclose(tlog, jlog, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(temb, jemb, rtol=1e-4, atol=1e-4)


def test_forward_bf16(params):
    """bf16 weights and KV. Prefill (M <= 64: B1's plain version, the same
    roundings as q4_matmul_xla) matches tightly. The decode step runs the
    fused attention B4 on the port but the einsum path in JAX on the CPU;
    they round q, p and the new K/V row to bf16 at different places, so
    decode logits agree to bf16 tolerance (3e-2 of the max)."""
    steps = run_both(params, "bfloat16", False,
                     [(PROMPT, len(PROMPT) - 1), ([77], 0), ([78], 0)], False)
    close(steps[0][0], steps[0][1], 1e-4)
    close(steps[0][2], steps[0][3], 1e-4)
    for tlog, jlog, temb, jemb in steps[1:]:
        close(tlog, jlog, 3e-2)
        close(temb, jemb, 3e-2)


def test_forward_int8_prefill(params):
    """A 256-token prefill with prefill_int8=True on both sides: B2+B3's
    plain versions against the jitted q4_matmul_int8_xla. Each matmul is
    exact given the same input (test_torch_q4_matmul), but the activation
    requant is discontinuous: an f32-ulp difference upstream (attention sum
    order) can move one int8 code by 1, so layer outputs agree to the int8
    step, 3e-2 of the max, not to f32 rounding."""
    rng = np.random.default_rng(9)
    toks = [1] + rng.integers(3, HP.n_vocab, 255).tolist()
    (tlog, jlog, temb, jemb), = run_both(params, "bfloat16", True,
                                         [(toks, 255)], True)
    close(tlog, jlog, 3e-2)
    close(temb, jemb, 3e-2)
    # and almost every logit is still at f32 agreement
    assert np.mean(np.abs(tlog - jlog) <= 1e-4 * np.abs(jlog).max()) > 0.95


def test_lora_terms_match(params):
    """apply_lora: delta and (a, b) forms, f32."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    a = rng.standard_normal((16, 4)).astype(np.float32)
    b = rng.standard_normal((4, 8)).astype(np.float32)
    delta = rng.standard_normal((16, 8)).astype(np.float32)
    for jt_, tt_ in (
            (jl.LoraTerm(delta=jnp.asarray(delta)),
             tl.LoraTerm(delta=torch.from_numpy(delta))),
            (jl.LoraTerm(a=jnp.asarray(a), b=jnp.asarray(b)),
             tl.LoraTerm(a=torch.from_numpy(a), b=torch.from_numpy(b)))):
        np.testing.assert_allclose(
            tl.apply_lora(torch.from_numpy(x), tt_).numpy(),
            np.asarray(jl.apply_lora(jnp.asarray(x), jt_)),
            rtol=1e-5, atol=1e-5)


def test_lora_in_forward_matches(params):
    """A q/k/v and FFN LoRA term changes the forward identically (the fused
    decode attention is skipped when q/k/v carry LoRA, as in JAX)."""
    jp, tp = params
    rng = np.random.default_rng(5)
    d = HP.n_embd
    dq = (rng.standard_normal((d, d)) * 0.05).astype(np.float32)
    d1 = (rng.standard_normal((d, N_FF)) * 0.05).astype(np.float32)
    jp2 = dataclasses.replace(jp, layers=[dataclasses.replace(
        jp.layers[0], lora_wq=jl.LoraTerm(delta=jnp.asarray(dq)),
        lora_w1=jl.LoraTerm(delta=jnp.asarray(d1)))] + jp.layers[1:])
    tp2 = dataclasses.replace(tp, layers=[dataclasses.replace(
        tp.layers[0], lora_wq=tl.LoraTerm(delta=torch.from_numpy(dq)),
        lora_w1=tl.LoraTerm(delta=torch.from_numpy(d1)))] + tp.layers[1:])
    steps = run_both((jp2, tp2), "float32", None,
                     [(PROMPT, len(PROMPT) - 1), ([77], 0)], False)
    for tlog, jlog, _, _ in steps:
        np.testing.assert_allclose(tlog, jlog, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_rot", [32, 64])
def test_rope_matches_jax(n_rot):
    """rope_interleaved and the per-lane form (rope_lane_tables_bt +
    rope_interleaved_lanes) against the JAX functions; the two libraries'
    cos/sin/pow differ by an ulp, so f32 tolerance."""
    from fastllama_tpu.kernels import rope as jr
    from fastllama_tpu_torch.kernels import rope as tr
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 5, 2, 64)).astype(np.float32)
    pos = np.arange(7, 12, dtype=np.int32)[None, :]
    want = np.asarray(jr.rope_interleaved(jnp.asarray(x), jnp.asarray(pos),
                                          n_rot))
    got = tr.rope_interleaved(torch.from_numpy(x), torch.from_numpy(pos),
                              n_rot).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    cos, sin = tr.rope_lane_tables_bt(torch.from_numpy(pos), 64, n_rot)
    jcos, jsin = jr.rope_lane_tables_bt(jnp.asarray(pos), 64, n_rot)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    lanes = tr.rope_interleaved_lanes(torch.from_numpy(x), cos, sin, n_rot)
    np.testing.assert_allclose(lanes.numpy(), want, rtol=1e-5, atol=1e-5)


def test_position_tables_slice_equals_direct(params):
    """forward with the model's precomputed tables equals forward building
    its own for the window."""
    _, tp = params
    cfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                           w_dtype="bfloat16")
    toks = torch.tensor([PROMPT])
    out = []
    for tables in (None, tl.position_tables(64, 64, HP.n_rot, "cpu")):
        kv = tl.init_kv_cache(HP, 1, 64, dtype=torch.bfloat16, device="cpu")
        tl.forward(tp, toks, 0, kv, cfg, None, tables)
        out.append(tl.forward(tp, torch.tensor([[9]]), len(PROMPT), kv, cfg,
                              None, tables)[0])
    torch.testing.assert_close(out[0], out[1], rtol=1e-6, atol=1e-6)
