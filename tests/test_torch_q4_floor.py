"""PyTorch port: B13 and B14, the probes of the decode matmul's access
pattern (kernels/q4_floor.py), against the Pallas kernels of
tools/bench_q4_floor.py (_floor_kernel, _nosc_kernel) run in interpret
mode, and their fragment order on the tensor cores emulated in numpy."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fastllama_tpu.kernels.q4_matmul import QBLOCK, split_activation
from fastllama_tpu_torch.kernels import q4_floor as qf
from fastllama_tpu_torch.kernels import q4_matmul as tqm
from test_torch_q4_matmul import b1_a_fragment, b1_b_fragment, b1_c_fragment
from tools import bench_q4_floor as jfloor

torch.set_num_threads(1)

PLAIN = {"floor": qf.q4_floor_plain, "nosc": qf.q4_nosc_plain}
WRAPPER = {"floor": qf.q4_floor, "nosc": qf.q4_nosc}


def inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qs = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    scales = rng.standard_normal((k // QBLOCK, n)).astype(np.float32)
    return x, qs, scales


def assert_close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


# K a multiple of 256 and N of 128: the JAX tool's _pick_tile_k / _pick_tile
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("mode", ["floor", "nosc"])
def test_plain_matches_the_pallas_probe(m, mode):
    x, qs, scales = inputs(m, 512, 256)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfloor._run(jnp.asarray(x), jnp.asarray(qs),
                                      jnp.asarray(scales), mode))
    got = WRAPPER[mode](torch.from_numpy(x), torch.from_numpy(qs))
    assert got.dtype == torch.float32 and got.shape == (m, 256)
    assert_close(got.numpy(), want, 1e-5)


def test_split_activation_matches_jax():
    x = inputs(3, 256, 128)[0]
    want = split_activation(jnp.asarray(x))
    got = qf.split_activation(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_probes_take_the_whole_byte_and_its_nibbles():
    """One weight byte per column: floor reads it whole, nosc as its low
    nibble against x_lo plus its high nibble against x_hi, no -8."""
    x = torch.zeros((1, 32))
    x[0, 3], x[0, 16 + 3] = 1.0, 2.0
    qs = torch.zeros((16, 16), dtype=torch.uint8)
    qs[3] = torch.arange(240, 256, dtype=torch.uint8)
    q = qs[3].float()
    assert torch.equal(qf.q4_floor(x, qs)[0], q)
    assert torch.equal(qf.q4_nosc(x, qs)[0], (q.int() & 15) + 2.0 * (
        q.int() >> 4))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x, qs = torch.zeros((2, 64)), torch.zeros((32, 16), dtype=torch.uint8)
    for fn in WRAPPER.values():
        with pytest.raises(ValueError):
            fn(x[:, :32], qs)                      # K not twice the rows
        with pytest.raises(ValueError):
            fn(torch.zeros((65, 64)), qs)          # past B1's M
        with pytest.raises(ValueError):
            fn(x.double(), qs)
        with pytest.raises(ValueError):
            fn(x, qs.to(torch.int32))


def test_byte_permute_gives_the_exact_code():
    """The kernel's nib_val: byte c put into the mantissa of 2^23
    (0x4B000000 | c), less 2^23, is c itself for every byte (the floor's
    whole byte and the nibbles of nosc); less 2^23 + 8 it is c - 8 (B1)."""
    c = np.arange(256, dtype=np.uint32)
    f = (np.uint32(0x4B000000) | c).view(np.float32)
    np.testing.assert_array_equal(f - np.float32(8388608.0), c)
    np.testing.assert_array_equal(f - np.float32(8388616.0), c - 8.0)
    # and bf16 holds each code exactly (8 significant bits)
    t = torch.from_numpy(c.astype(np.float32))
    assert torch.equal(t.to(torch.bfloat16).float(), t)


def emulate(mode, x, qs):
    """numpy m16n8k16 products assembled as q4_mma_kernel assembles them in
    the probe modes: A from the packed bytes through B1's fragment map
    (kFloor: the whole byte at k16 step 0 only; kNosc: the nibble of the
    step, neither scaled nor centred), B from the bf16 x slice, the
    accumulators back to (row, column) through B1's D map."""
    m, k = x.shape
    kh, n = qs.shape
    nb = kh // 16
    q = qs.astype(np.float64)
    codes = {"floor": [q], "nosc": [q.astype(np.int64) & 15,
                                    q.astype(np.int64) >> 4]}[mode]
    steps = len(codes)
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    nt = tqm.b1_mma_plan(m, n, nb)[0]
    rows = -(-m // (8 * nt)) * 8 * nt
    xp = np.zeros((rows, k))
    xp[:m] = xb
    y = np.zeros((rows, n))
    for n0 in range(0, n, 64):
        for kb in range(nb):
            for m0 in range(0, rows, 8):
                for mt in range(4):
                    for step in range(steps):
                        a, b = np.zeros((16, 16)), np.zeros((16, 8))
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            for reg in range(4):
                                i = g + 8 * (reg & 1)
                                for e, (col, _, row, _) in enumerate(
                                        b1_a_fragment(lane, reg, mt, step)):
                                    a[i, 2 * t + 8 * (reg >> 1) + e] = codes[
                                        step][kb * 16 + row, n0 + col]
                            for reg in range(2):
                                for e, (r, kk) in enumerate(
                                        b1_b_fragment(lane, reg, step)):
                                    b[2 * t + 8 * reg + e, g] = xp[
                                        m0 + r, kb * 32 + kk]
                        d = a @ b
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            for reg in range(4):
                                r, col = b1_c_fragment(lane, reg, mt)
                                y[m0 + r, n0 + col] += d[g + 8 * (reg >> 1),
                                                         2 * t + (reg & 1)]
    return y[:m]


@pytest.mark.parametrize("m", [1, 9])
@pytest.mark.parametrize("mode", ["floor", "nosc"])
def test_fragment_order_products_equal_plain(m, mode):
    """The probes' fragment order gives the plain version, to 1e-5 of the
    largest output (the codes are non-negative, so that is the sum of
    |x| |W|'s scale); floor's k16 step 0 reads x_lo, nosc's step 1 x_hi."""
    x, qs, _ = inputs(m, 64, 128, seed=3)
    want = PLAIN[mode](torch.from_numpy(x), torch.from_numpy(qs)).numpy()
    assert_close(emulate(mode, x, qs), want, 1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 9, 17, 64])
@pytest.mark.parametrize("mode", ["floor", "nosc"])
def test_probe_kernels_match_plain(cuda_device, m, mode):
    """B13 and B14 on the card at each of B1's n-tile counts: within 1e-5
    of the largest output, and bit-equal across two runs."""
    x, qs, _ = inputs(m, 1024, 512, seed=5)
    xd, qd = torch.from_numpy(x).to(cuda_device), torch.from_numpy(qs).to(
        cuda_device)
    got = WRAPPER[mode](xd, qd)
    assert_close(got.cpu().numpy(), PLAIN[mode](xd, qd).cpu().numpy(), 1e-5)
    assert torch.equal(got, WRAPPER[mode](xd, qd))
