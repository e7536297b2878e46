"""PyTorch port: the fused decode attention (B4 plain version) against the
JAX package's Pallas kernel in interpret mode."""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastllama_tpu.kernels.decode_attention import (
    decode_attention_fused as jax_fused, rope_lane_tables as jax_tables,
)
from fastllama_tpu_torch.kernels import decode_attention as tda

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def inputs(b, s, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, 3 * f)).astype(np.float32),
            rng.standard_normal((b, s, f)).astype(np.float32),
            rng.standard_normal((b, s, f)).astype(np.float32))


def run_both(qkv, kc, vc, n_past, hd, n_rot, cache):
    scale = 1.0 / math.sqrt(hd)
    np_ = np.asarray(n_past, np.int32)
    jdt = getattr(jnp, cache)
    cos, sin = jax_tables(jnp.asarray(np_), hd, n_rot)
    jctx, jk, jv = jax_fused(
        jnp.asarray(qkv), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
        jnp.asarray(np_), cos, sin, head_dim=hd, n_rot=n_rot, scale=scale,
        interpret=True)
    tdt = getattr(torch, cache)
    tk = torch.from_numpy(kc).to(tdt)
    tv = torch.from_numpy(vc).to(tdt)
    tn = torch.from_numpy(np_)
    # the tables agree to f32 rounding (cos/sin/pow differ by an ulp between
    # the two libraries); the kernel is then fed the same tables
    tcos, tsin = tda.rope_lane_tables(tn, hd, n_rot)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(cos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(sin), atol=1e-6)
    ctx = tda.decode_attention_fused(
        torch.from_numpy(qkv), tk, tv, tn, torch.from_numpy(np.array(cos)),
        torch.from_numpy(np.array(sin)), head_dim=hd, n_rot=n_rot,
        scale=scale)
    return (ctx.numpy(), tk.to(torch.float32).numpy(),
            tv.to(torch.float32).numpy(), np.asarray(jctx),
            np.asarray(jk, np.float32), np.asarray(jv, np.float32))


@pytest.mark.parametrize("n_past", [[0], [1], [77], [127], [0, 127], [5, 64]])
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_b4_plain_matches_pallas(n_past, cache):
    b, s, h, hd = len(n_past), 128, 2, 128
    qkv, kc, vc = inputs(b, s, h * hd, seed=sum(n_past) + b)
    ctx, k, v, jctx, jk, jv = run_both(qkv, kc, vc, n_past, hd, hd, cache)
    # f32 cache: f32 reassociation; bf16 cache: q and p are rounded to bf16
    # for the cache dots, so an f32-ulp difference can move a rounding
    tol = 2e-5 if cache == "float32" else 1e-2
    np.testing.assert_allclose(ctx, jctx, rtol=tol, atol=tol)
    np.testing.assert_array_equal(k, jk)       # written rows and the rest
    np.testing.assert_array_equal(v, jv)


def test_b4_plain_partial_rotation():
    """n_rot < head_dim: lanes past n_rot pass through unrotated."""
    qkv, kc, vc = inputs(1, 128, 256, seed=3)
    ctx, k, v, jctx, jk, jv = run_both(qkv, kc, vc, [40], 128, 64, "float32")
    np.testing.assert_allclose(ctx, jctx, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(v, jv)


def test_b4_wrapper_rejects_bad_inputs():
    qkv = torch.zeros((1, 1, 3 * 256))
    kc = torch.zeros((1, 16, 256))
    ones = torch.zeros((1, 128))
    with pytest.raises(ValueError):
        tda.decode_attention_fused(qkv, kc, kc.clone(),
                                   torch.zeros(1, dtype=torch.int64), ones,
                                   ones, head_dim=128, n_rot=128, scale=1.0)
    with pytest.raises(ValueError):
        tda.decode_attention_fused(qkv[..., :256], kc, kc.clone(),
                                   torch.zeros(1, dtype=torch.int32), ones,
                                   ones, head_dim=128, n_rot=128, scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_b4_kernel_matches_plain(cuda_device, cache):
    qkv, kc, vc = inputs(2, 256, 256, seed=5)
    dt = getattr(torch, cache)
    n = torch.tensor([0, 200], dtype=torch.int32, device=cuda_device)
    cos, sin = tda.rope_lane_tables(n, 128, 128)
    args = [torch.from_numpy(a).to(cuda_device) for a in (qkv, kc, vc)]
    k1, v1 = args[1].to(dt), args[2].to(dt)
    k2, v2 = k1.clone(), v1.clone()
    kw = dict(head_dim=128, n_rot=128, scale=1 / math.sqrt(128))
    got = tda.decode_attention_fused(args[0], k1, v1, n, cos, sin, **kw)
    want = tda.decode_attention_fused_plain(args[0], k2, v2, n, cos, sin, **kw)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
