"""PyTorch port: quantization, packing and dequantization against the JAX
package (exact equality)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastllama_tpu.quant import q4 as jq4
from fastllama_tpu.quant import tensor as jt
from fastllama_tpu_torch.quant import q4 as tq4
from fastllama_tpu_torch.quant import tensor as tt

torch.set_num_threads(1)


@pytest.mark.parametrize("fmt", ["q4_0", "q4_1", "q8_0"])
def test_quantize_golden_blocks_equal(fmt):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((16, 128)) * 3.0).astype(np.float32)
    x[0, :32] = 0.0                               # zero block
    x[1, :32] = [7.0, 0.5, -0.5, 2.5, -2.5] + [0.0] * 27   # .5 ties
    got = getattr(tq4, f"quantize_{fmt}")(x)
    want = getattr(jq4, f"quantize_{fmt}")(x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    deq = {"q4_0": "dequantize_q4_0", "q4_1": "dequantize_q4_1",
           "q8_0": "dequantize_q8_0"}[fmt]
    args = got if fmt != "q8_0" else got[:2]
    np.testing.assert_array_equal(getattr(tq4, deq)(*args),
                                  getattr(jq4, deq)(*args))


def test_wire_packing_equal():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    codes, scales = tq4.quantize_q4_0(x)
    wire = tq4.q4_0_to_wire(codes, scales)
    assert wire == jq4.q4_0_to_wire(codes, scales)
    for a, b in zip(tq4.q4_0_from_wire(wire, (4, 64)),
                    jq4.q4_0_from_wire(wire, (4, 64))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,n", [(64, 32), (64, 96), (352, 320)])
def test_matmul_weight_planes_and_dequant_equal(k, n):
    """Same stored planes (padding included) and the same dense [K_pad,
    N_pad] dequant as the JAX package, in f32 and bf16."""
    rng = np.random.default_rng(2)
    codes, scales = tq4.quantize_q4_0(
        rng.standard_normal((n, k)).astype(np.float32) * 0.1)
    wt = tt.make_matmul_weight(codes, scales, device="cpu")
    wj = jt.make_matmul_weight(codes, scales)
    assert wt.n_logical == wj.n_logical and wt.k == wj.k
    np.testing.assert_array_equal(wt.qs.numpy(), np.asarray(wj.qs))
    np.testing.assert_array_equal(wt.scales.numpy(), np.asarray(wj.scales))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = tt.dequant_matmul_weight(wt, tdt).to(torch.float32).numpy()
        want = np.asarray(jt.dequant_matmul_weight(wj, jdt), np.float32)
        np.testing.assert_array_equal(got, want)


def test_embedding_rows_equal():
    rng = np.random.default_rng(3)
    codes, scales = tq4.quantize_q4_0(
        rng.standard_normal((50, 64)).astype(np.float32))
    et = tt.make_embedding(codes, scales, device="cpu")
    ej = jt.make_embedding(codes, scales)
    ids = np.array([[0, 7, 49], [3, 3, 12]], np.int64)
    got = tt.dequant_embedding_rows(et, torch.from_numpy(ids)).numpy()
    want = np.asarray(jt.dequant_embedding_rows(ej, jnp.asarray(ids)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [64, 4096, 11008, 5120, 13824])
def test_padding_rules_equal(k):
    assert tt.good_pad_k(k) == jt.good_pad_k(k)
    assert tt.good_pad_n(k) == jt.good_pad_n(k)
    assert tt.good_pad_n(32000) == jt.good_pad_n(32000) == 32768
