"""PyTorch port: the q4 matmuls (B1-B3 plain versions and the dispatcher)
against the JAX package's kernels (Pallas interpret mode) and XLA paths."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fastllama_tpu.kernels import q4_matmul as jqm
from fastllama_tpu.quant import tensor as jt
from fastllama_tpu.quant.q4 import quantize_q4_0
from fastllama_tpu_torch.kernels import q4_matmul as tqm
from fastllama_tpu_torch.quant import tensor as tt

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def weights(k, n, seed=0):
    rng = np.random.default_rng(seed)
    codes, scales = quantize_q4_0(
        (rng.standard_normal((n, k)) * 0.1).astype(np.float32))
    return (tt.make_matmul_weight(codes, scales, device="cpu"),
            jt.make_matmul_weight(codes, scales))


def acts(m, k, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)) * scale).astype(np.float32)


def assert_close(got, want, rtol):
    """|got - want| <= rtol * max|want| elementwise (f32 reassociation at
    rtol ~1e-5, bf16 rounding at ~1e-2)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


# (M, K_logical, N_logical): N and K padding both exercised
@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (8, 256, 128),
                                   (64, 512, 256), (3, 352, 96)])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_b1_plain_matches_pallas_and_xla(m, k, n, mode):
    wt, wj = weights(k, n)
    x = acts(m, k)
    jdt, tdt = getattr(jnp, mode), getattr(torch, mode)
    got = tqm.q4_matmul_decode(torch.from_numpy(x), wt, tdt).numpy()
    assert got.shape == (m, n)
    xla = jqm.q4_matmul(jnp.asarray(x), wj, use_pallas=False, w_dtype=jdt)
    pallas = jqm.q4_matmul(jnp.asarray(x), wj, use_pallas=True,
                           interpret=True, w_dtype=jdt)
    if mode == "float32":
        assert_close(got, xla, 1e-5)
        assert_close(got, pallas, 1e-5)
    else:
        # same bf16 roundings as q4_matmul_xla; the Pallas v1 kernel rounds
        # q*d (not (q-8)*d) to bf16 and folds -8 back in f32
        assert_close(got, xla, 1e-5)
        assert_close(got, pallas, 2e-2)


def test_b2_plain_bit_exact_vs_pallas():
    """Bit-exact with the (jitted) Pallas kernel. Under jit XLA computes
    dx = max / 127 as max * f32(1/127); the eager q4_matmul_int8_xla takes
    the true quotient, so the two JAX paths differ by 1 ulp in some rows.
    The port follows the jitted one."""
    x = acts(64, 256, seed=2, scale=5.0)
    x[3] = 0.0                                      # dx floor 1e-20 / 127
    xq, dx = tqm.quant_rows_int8(torch.from_numpy(x))
    jxq, jdx = jqm.quant_rows_int8(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx)[:, 0])


def test_b2_pads_k_with_zeros():
    x = acts(4, 96, seed=3)
    xq, dx = tqm.quant_rows_int8(torch.from_numpy(x), 256)
    xq0, dx0 = tqm.quant_rows_int8(torch.from_numpy(x))
    assert xq.shape == (4, 256) and not xq[:, 96:].any()
    assert torch.equal(xq[:, :96], xq0) and torch.equal(dx, dx0)


@jax.jit
def _jax_int8_accumulators(x, wj):
    """The exact int32 accumulators of q4_matmul_int8_xla, step for step
    (jitted, as the JAX forward runs it)."""
    scales = wj.scales
    s8 = jnp.maximum(jnp.max(jnp.abs(scales), axis=0, keepdims=True)
                     * (8.0 / 127.0), 1e-20)
    sc = jqm._repeat_scales((scales * (1.0 / s8)).astype(jnp.float32))
    qsw = wj.qs.astype(jnp.int32)
    w_lo = jnp.round(((qsw & 0x0F) - 8).astype(jnp.float32) * sc
                     ).astype(jnp.int32)
    w_hi = jnp.round(((qsw >> 4) - 8).astype(jnp.float32) * sc
                     ).astype(jnp.int32)
    xf = jnp.asarray(x)
    dx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1), 1e-20) / 127.0
    xq = jnp.clip(jnp.round(xf / dx[:, None]), -127, 127).astype(jnp.int32)
    x_lo, x_hi = jqm.split_activation(xq)
    acc = jnp.dot(x_lo, w_lo, preferred_element_type=jnp.int32)
    acc += jnp.dot(x_hi, w_hi, preferred_element_type=jnp.int32)
    return acc


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (256, 352, 96)])
def test_b3_plain_exact_accumulators_vs_int8_xla(m, k, n):
    wt, wj = weights(k, n, seed=4)
    x = acts(m, k, seed=5, scale=2.0)
    xp = np.pad(x, ((0, 0), (0, wt.k - k)))
    xq, dx = tqm.quant_rows_int8(torch.from_numpy(x), wt.k)
    w8, _ = tqm.requant_weight_int8(wt)
    acc = tqm.int8_accumulators(xq, w8).numpy()
    np.testing.assert_array_equal(
        acc.astype(np.int64), np.asarray(_jax_int8_accumulators(xp, wj)))
    got = tqm.q4_matmul_prefill_int8(xq, dx, wt).numpy()
    want = np.asarray(jax.jit(jqm.q4_matmul_int8_xla)(
        jnp.asarray(xp), wj.qs, wj.scales))[:, :n]
    assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)))


@pytest.mark.parametrize("m,mode,int8,path", [
    (1, "bfloat16", None, "decode"),
    (64, "float32", None, "decode"),
    (65, "bfloat16", None, "dequant"),
    (255, "bfloat16", True, "dequant"),
    (256, "bfloat16", None, "int8"),
    (256, "bfloat16", False, "dequant"),
    (256, "float32", None, "dequant"),
    (512, "float32", True, "int8"),
])
def test_dispatch_table(monkeypatch, m, mode, int8, path):
    called = []
    for name, tag in (("q4_matmul_decode", "decode"),
                      ("q4_matmul_dequant", "dequant"),
                      ("q4_matmul_prefill_int8", "int8")):
        orig = getattr(tqm, name)
        monkeypatch.setattr(tqm, name, lambda *a, _o=orig, _t=tag, **kw:
                            called.append(_t) or _o(*a, **kw))
    wt, _ = weights(64, 32)
    y = tqm.q4_matmul(torch.zeros((1, m, 64)), wt,
                      w_dtype=getattr(torch, mode), prefill_int8=int8)
    assert y.shape == (1, m, 32)
    assert called[0] == path          # (B1's CPU path then runs its plain)


@pytest.mark.parametrize("m,int8", [(100, False), (256, True)])
def test_dispatcher_matches_jax_q4_matmul(m, int8):
    wt, wj = weights(352, 96, seed=6)
    x = acts(m, 352, seed=7)
    got = tqm.q4_matmul(torch.from_numpy(x), wt, w_dtype=torch.bfloat16,
                        prefill_int8=int8).numpy()
    # jitted, as the JAX forward runs it (see test_b2_plain_bit_exact_vs_pallas)
    want = np.asarray(jax.jit(lambda a, w: jqm.q4_matmul(
        a, w, use_pallas=False, w_dtype=jnp.bfloat16, prefill_int8=int8))(
            jnp.asarray(x), wj))
    if int8:
        assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)))
    else:
        assert_close(got, want, 1e-5)


# -- on the card: each kernel against its plain version ----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 64])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_b1_kernel_matches_plain(cuda_device, m, mode):
    wt, _ = weights(352, 96, seed=8)
    w = tt.QuantMatmulWeight(wt.qs.to(cuda_device), wt.scales.to(cuda_device),
                             wt.n_logical)
    x = torch.from_numpy(acts(m, 352)).to(cuda_device)
    got = tqm.q4_matmul_decode(x, w, getattr(torch, mode))
    want = tqm.q4_matmul_dequant(x, w, getattr(torch, mode))
    assert_close(got.cpu().numpy(), want.cpu().numpy(), 1e-5)


@pytest.mark.cuda
def test_b2_b3_kernels_bit_exact(cuda_device):
    wt, _ = weights(352, 96, seed=9)
    w = tt.QuantMatmulWeight(wt.qs.to(cuda_device), wt.scales.to(cuda_device),
                             wt.n_logical)
    x = torch.from_numpy(acts(256, 352, scale=3.0)).to(cuda_device)
    xq, dx = tqm.quant_rows_int8(x, w.k)
    xq0, dx0 = tqm.quant_rows_int8_plain(x, w.k)
    assert torch.equal(xq, xq0) and torch.equal(dx, dx0)
    assert torch.equal(tqm.q4_matmul_prefill_int8(xq, dx, w),
                       tqm.q4_matmul_prefill_int8_plain(xq, dx, w))
