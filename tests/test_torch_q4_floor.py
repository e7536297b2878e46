"""PyTorch port: B13 and B14, the probes of the decode matmul kernel's
skeleton (kernels/q4_floor.py: variants 13 and 14 of csrc/q4_fold.cuh),
against the Pallas kernels of tools/bench_q4_floor.py (_floor_kernel,
_nosc_kernel) run in interpret mode, the fold kernel's numpy model in its
probe mode against both, and the wrappers' route to the probe build."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fastllama_tpu.kernels.q4_matmul import QBLOCK, split_activation
from fastllama_tpu_torch.kernels import cuda_lib
from fastllama_tpu_torch.kernels import q4_floor as qf
from fastllama_tpu_torch.kernels import q4_variants as qv
from test_torch_q4_variants import B15_CAPACITY, _ReportsCuda, b15_model
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
    assert qv.B15_MAX_M == 64
    for fn in WRAPPER.values():
        with pytest.raises(ValueError):
            fn(x[:, :32], qs)                      # K not twice the rows
        with pytest.raises(ValueError, match="B15's plan"):
            fn(torch.zeros((65, 64)), qs)          # past B15_MAX_M
        with pytest.raises(ValueError):
            fn(x.double(), qs)
        with pytest.raises(ValueError):
            fn(x, qs.to(torch.int32))


def test_byte_permute_gives_the_exact_code():
    """The fold kernel's route for B13's whole byte (v1's qd with d = 1):
    byte c put into the mantissa of 2^23 (0x4B000000 | c), less 2^23, is c
    itself for every byte (B14's nibbles take v2's codes); less 2^23 + 8
    it is c - 8 (B1's nib_val)."""
    c = np.arange(256, dtype=np.uint32)
    f = (np.uint32(0x4B000000) | c).view(np.float32)
    np.testing.assert_array_equal(f - np.float32(8388608.0), c)
    np.testing.assert_array_equal(f - np.float32(8388616.0), c - 8.0)
    # and bf16 holds each code exactly (8 significant bits)
    t = torch.from_numpy(c.astype(np.float32))
    assert torch.equal(t.to(torch.bfloat16).float(), t)


@pytest.mark.parametrize("m", [1, 5, 8, 9, 13, 40, 64])
@pytest.mark.parametrize("mode", ["floor", "nosc"])
def test_fragment_order_products_equal_plain(m, mode):
    """The probes as the fold kernel computes them (test_torch_q4_variants.
    b15_model in its probe mode: the packed rows' swizzled shared-memory
    image, the A fragments of the whole byte (floor, one k16 step against
    x_lo's tile) or of both nibbles (nosc), x's K-major bf16 tiles, the
    split order) on a 1088 x 192 plane (34 q blocks, a ragged last column
    tile) under a plan of one split and one of three (an uneven last
    split), one and two consumer warpgroups: within 1e-5 of the largest
    output of the plain version (the codes are non-negative, so that is
    the sum of |x| |W|'s scale; only the f32 summation order differs)."""
    x, qs, _ = inputs(m, 1088, 192, seed=3)
    want = PLAIN[mode](torch.from_numpy(x), torch.from_numpy(qs)).numpy()
    for wgs, splits in ((1, 1), (2, 3)):
        plan = qv.b15_plan(m, 192, 34, 132, False, wgs=wgs, splits=splits,
                           clusters=1)
        assert plan.splits == splits
        assert_close(b15_model(x, qs, None, mode, plan), want, 1e-5)


@pytest.mark.parametrize("mode", ["floor", "nosc"])
def test_fold_probe_model_matches_the_pallas_probe(mode):
    """The fold kernel's probe mode against the JAX tool's Pallas probe
    (_run in interpret mode) at its tile sizes, M = 8 on B15's own plan."""
    x, qs, scales = inputs(8, 512, 256, seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfloor._run(jnp.asarray(x), jnp.asarray(qs),
                                      jnp.asarray(scales), mode))
    plan = qv.b15_plan(8, 256, 16, 132, False, B15_CAPACITY.get)
    assert_close(b15_model(x, qs, None, mode, plan), want, 1e-5)


@pytest.mark.parametrize("m", [1, 8, 64])
def test_probes_launch_the_probe_builds_of_the_fold_kernel(monkeypatch, m):
    """On a CUDA tensor q4_floor and q4_nosc launch the probe build of
    csrc/q4_fold.cuh (entries q4_fold_floor_gemm, q4_fold_nosc_gemm;
    variants 13 and 14, no scales) on B15's plan at f32 scales, never an
    entry of B1's kernel, and each counts its launch: the entry points a
    spy on cuda_lib.fn records."""
    called = []

    def fn(name):
        if name == "q4_fold_clusters":
            return lambda s: B15_CAPACITY[s]

        def entry(*args):
            called.append((name, args))
            return 0
        return entry
    monkeypatch.setattr(cuda_lib, "fn", fn)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_lib, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(qv, "_B15_CLUSTERS", {})
    monkeypatch.setattr(qv, "_B15_PLANS", {})
    k, n = 4096, 12288
    x, qs, _ = inputs(m, k, n, seed=6)
    xd, qd = (torch.Tensor._make_subclass(_ReportsCuda,
                                          torch.from_numpy(a).clone())
              for a in (x, qs))
    plan = qv.b15_plan(m, n, k // QBLOCK, 132, False, B15_CAPACITY.get)
    for mode in ("floor", "nosc"):
        before = WRAPPER[mode].launches
        y = WRAPPER[mode](xd, qd)
        assert y.shape == (m, n) and WRAPPER[mode].launches == before + 1
    assert [c[0] for c in called] == ["q4_fold_floor_gemm",
                                      "q4_fold_nosc_gemm"]
    for (_, args), variant in zip(called, (13, 14)):
        # x, M, Kx, qs, scales, sc16, N, NB, variant, then the plan
        assert args[1:3] == (m, k) and args[4:9] == (None, 0, n,
                                                    k // QBLOCK, variant)
        assert args[9:16] == (plan.wgs, plan.stages, plan.xstages,
                              plan.splits, plan.sps, plan.clusters,
                              int(plan.sync))
    assert "q4_floor_mma" not in cuda_lib.ARGTYPES
    assert "q4_nosc_mma" not in cuda_lib.ARGTYPES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


# pinned plans of the probes: (M, consumer warpgroups, splits, ring slots,
# clusters, mma.sync): the mma.sync and wgmma routes at M <= 8, one split
# and several
PROBE_PINNED = [(1, 2, 1, 4, 1, True), (1, 1, 3, 6, None, False),
                (8, 2, 1, 4, 2, False), (8, 1, 4, 4, None, True),
                (17, 2, 2, 4, 3, False), (40, 1, 1, 3, None, False),
                (64, 2, 3, 3, None, False), (64, 1, 8, 2, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(m, None) for m in (1, 8, 9, 17, 64)]
                         + PROBE_PINNED, ids=str)
@pytest.mark.parametrize("mode", ["floor", "nosc"])
def test_probe_kernels_match_plain(cuda_device, case, mode):
    """B13 and B14 on the card on B15's plan (counted) and on pinned plans:
    within 1e-5 of the largest output, and bit-equal across two runs."""
    m = case[0]
    x, qs, _ = inputs(m, 1024, 512, seed=5)
    xd, qd = torch.from_numpy(x).to(cuda_device), torch.from_numpy(qs).to(
        cuda_device)
    plan = None
    if case[1] is not None:
        _, wgs, splits, stages, clusters, sync = case
        plan = qv.b15_plan(m, 512, 32, 132, False, wgs=wgs, splits=splits,
                           stages=stages, clusters=clusters, sync=sync)
    before = WRAPPER[mode].launches
    got = WRAPPER[mode](xd, qd, plan)
    assert WRAPPER[mode].launches == before + 1
    assert_close(got.cpu().numpy(), PLAIN[mode](xd, qd).cpu().numpy(), 1e-5)
    assert torch.equal(got, WRAPPER[mode](xd, qd, plan))
