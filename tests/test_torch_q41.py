"""PyTorch port: affine (q4_1 / GPTQ) weights — the planes, the dequant and
kernel B9's plain version against the JAX package (q41_matmul_pallas in
interpret mode and the XLA dequant path)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastllama_tpu.kernels import q4_matmul as jqm
from fastllama_tpu.quant import tensor as jt
from fastllama_tpu.quant.q4 import quantize_q4_1
from fastllama_tpu_torch.kernels import q4_matmul as tqm
from fastllama_tpu_torch.quant import tensor as tt

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def weights(k, n, seed=0, offset=0.1):
    rng = np.random.default_rng(seed)
    dense = (rng.standard_normal((n, k)) * 0.2 + offset).astype(np.float32)
    codes, d, m = quantize_q4_1(dense)
    return (tt.make_matmul_weight_q41(codes, d, m, device="cpu"),
            jt.make_matmul_weight_q41(codes, d, m), (codes, d, m))


def acts(m, k, seed=1):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)


def assert_close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


# K 352 pads to 512 and N 96 to 256: padding is codes 0, d 0, m 0
@pytest.mark.parametrize("k,n", [(256, 256), (352, 96)])
def test_q41_planes_equal_jax_byte_for_byte(k, n):
    wt, wj, _ = weights(k, n)
    assert wt.n_logical == wj.n_logical == n
    assert wt.qs.dtype == torch.uint8 and wt.mins.dtype == torch.float32
    np.testing.assert_array_equal(wt.qs.numpy(), np.asarray(wj.qs))
    np.testing.assert_array_equal(wt.scales.numpy(), np.asarray(wj.scales))
    np.testing.assert_array_equal(wt.mins.numpy(), np.asarray(wj.mins))


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_q41_dequant_equals_jax(mode):
    wt, wj, (codes, d, m) = weights(352, 96)
    got = tt.dequant_matmul_weight(wt, getattr(torch, mode)).to(torch.float32)
    want = np.asarray(jt.dequant_matmul_weight(wj, getattr(jnp, mode)),
                      np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "float32":
        dense = codes.reshape(96, -1, 32) * d[..., None] + m[..., None]
        np.testing.assert_array_equal(got.numpy()[:352, :96],
                                      dense.reshape(96, 352).T)


def test_codes_roundtrip_through_device_layout():
    """matmul_weight_to_codes and split_unpack_lastdim invert the packing."""
    wt, _, (codes, d, _) = weights(352, 96)
    c2, d2 = tt.matmul_weight_to_codes(wt, k_logical=352)
    np.testing.assert_array_equal(c2, codes)
    np.testing.assert_array_equal(d2, d)
    np.testing.assert_array_equal(
        tt.split_unpack_lastdim(tt.split_pack_lastdim(codes)), codes)


@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (8, 256, 128),
                                   (64, 512, 256), (3, 352, 96)])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_b9_plain_matches_pallas(m, k, n, mode):
    """B9's plain version against q41_matmul_pallas(interpret=True) through
    the JAX dispatcher. f32: reassociation only (1e-5 of the max). bf16: the
    same roundings on both sides (x and q * d to bf16, the mins term in
    f32), so still reassociation, 1e-5, far below a bf16 ulp (4e-3)."""
    wt, wj, _ = weights(k, n)
    x = acts(m, k)
    got = tqm.q41_matmul_decode(torch.from_numpy(x), wt,
                                getattr(torch, mode)).numpy()
    assert got.shape == (m, n)
    want = jqm.q4_matmul(jnp.asarray(x), wj, use_pallas=True, interpret=True,
                         w_dtype=getattr(jnp, mode))
    assert_close(got, want, 1e-5)
    if mode == "float32":
        xla = jqm.q4_matmul(jnp.asarray(x), wj, use_pallas=False,
                            w_dtype=jnp.float32)
        assert_close(got, xla, 1e-5)


def test_b9_plain_is_more_exact_than_dequant_at_bf16():
    """B9 is x_bf16 @ bf16(q * d) + bsum(x_f32) @ m, not x_bf16 @
    bf16(q * d + m): the offset plane meets no bf16 rounding, so with
    offsets that dominate the weights the kernel's form lies closer to the
    exact product than the dequant form, and the two differ by more than
    f32 reassociation."""
    wt, _, _ = weights(512, 128, seed=3, offset=2.0)
    x = torch.from_numpy(acts(16, 512, seed=4))
    exact = (x.double() @ tt.dequant_matmul_weight(wt, torch.float32)
             .double())[:, :128]
    b9 = tqm.q41_matmul_decode(x, wt, torch.bfloat16).double()
    dq = tqm.q4_matmul_dequant(x, wt, torch.bfloat16).double()
    err_b9 = (b9 - exact).abs().mean().item()
    err_dq = (dq - exact).abs().mean().item()
    assert err_b9 < 0.5 * err_dq
    assert (b9 - dq).abs().max().item() > 1e-3 * exact.abs().max().item()


@pytest.mark.parametrize("m", [65, 256])
def test_q41_prefill_matches_jax_dequant_path(m):
    """Affine weights above M = 64 take dequant (q * d + m) + matmul on both
    packages."""
    wt, wj, _ = weights(352, 96, seed=5)
    x = acts(m, 352, seed=6)
    got = tqm.q4_matmul(torch.from_numpy(x), wt, w_dtype=torch.bfloat16,
                        prefill_int8=None).numpy()
    want = jqm.q4_matmul(jnp.asarray(x), wj, use_pallas=False,
                         w_dtype=jnp.bfloat16, prefill_int8=None)
    assert_close(got, want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 64])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_b9_kernel_matches_plain(cuda_device, m, mode):
    wt, _, _ = weights(352, 96, seed=7)
    w = tt.QuantMatmulWeight(
        wt.qs.to(cuda_device), wt.scales.to(cuda_device),
        mins=wt.mins.to(cuda_device), n_logical=wt.n_logical)
    x = torch.from_numpy(acts(m, 352)).to(cuda_device)
    got = tqm.q41_matmul_decode(x, w, getattr(torch, mode))
    want = tqm.q41_matmul_decode_plain(x, w, getattr(torch, mode))
    assert_close(got.cpu().numpy(), want.cpu().numpy(), 1e-5)
