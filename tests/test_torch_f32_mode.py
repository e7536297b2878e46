"""PyTorch port: the f32 mode of the matmuls (w_dtype float32; B1 and B9 on
the fold kernel's variants 10 and 11, B5 and B20 on the register-A kernel's
f32 mode), which run on the tensor cores with nothing rounded: x's three
exact bf16 parts (q4_matmul.f32_parts), the kernels' arithmetic in plain
PyTorch (q4_matmul.f32_model) against the plain versions and the JAX
bodies in Pallas interpret mode at w_dtype=float32, the three-part case
(chip_smoke.three_part_case: an input that only arithmetic using all three
parts passes), the plans of both kernels' f32 modes, the routes, and
(marked cuda) each
kernel against its plain version and on the three-part case on the card,
and a NaN row kept to itself."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import example, given, settings, strategies as st

from fastllama_tpu.kernels import q4_matmul as jqm
from fastllama_tpu.quant import tensor as jt
from fastllama_tpu.quant.q4 import quantize_q4_0, quantize_q4_1
from fastllama_tpu_torch.kernels import q4_matmul as tqm
from fastllama_tpu_torch.kernels import q4_variants as tqv
from fastllama_tpu_torch.quant import tensor as tt
from test_torch_q4_variants import B15_PLANES, check_b15_plan_covers
import chip_smoke as cs

torch.set_num_threads(1)

# the smallest |x| whose three parts are exact (the last part's lowest bit,
# 2^(e - 23), at or above bf16's finest subnormal step, 2^-133)
EXACT_MIN = 2.0 ** -110
F32_MAX = float(np.finfo(np.float32).max)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def q40(k, n, seed=0):
    rng = np.random.default_rng(seed)
    codes, scales = quantize_q4_0(
        (rng.standard_normal((n, k)) * 0.1).astype(np.float32))
    return (tt.make_matmul_weight(codes, scales, device="cpu"),
            jt.make_matmul_weight(codes, scales))


def q41(k, n, seed=0):
    rng = np.random.default_rng(seed)
    codes, d, mn = quantize_q4_1(
        (rng.standard_normal((n, k)) * 0.2 + 0.1).astype(np.float32))
    return (tt.make_matmul_weight_q41(codes, d, mn, device="cpu"),
            jt.make_matmul_weight_q41(codes, d, mn))


def acts(m, k, seed=1):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)


def tol_of(x, w):
    """1e-5 of the largest sum |x| @ |W| (W the f32 dequantized weight):
    the f32 checks' rule, on the card too."""
    wd = tt.dequant_matmul_weight(w, torch.float32)
    xa = tqm._pad_k(torch.as_tensor(x).abs(), wd.shape[0])
    return 1e-5 * (xa @ wd.abs())[:, :w.n_logical].max().item()


# -- the three parts --------------------------------------------------------

def check_parts(v):
    x = torch.tensor([v], dtype=torch.float32)
    parts = tqm.f32_parts(x)
    for p in parts:
        # each part a bf16 value, its lower 16 bits zero
        assert torch.equal(p.to(torch.bfloat16).float(), p)
        assert int(p.view(torch.int32).item()) & 0xFFFF == 0
    total = sum(p.double() for p in parts).item()
    if abs(v) >= EXACT_MIN:
        assert total == float(x.item()), v
    else:
        assert abs(total - float(x.item())) < 2.0 ** -133, v


@settings(max_examples=3000, deadline=None, database=None)
@given(st.floats(width=32, allow_nan=False, allow_infinity=False))
@example(F32_MAX)
@example(-F32_MAX)
@example(3.3961e38)                  # rounds to inf in bf16, not truncated
@example(2.0 ** -126)                # the smallest normal
@example(-(2.0 ** -126) * (2 - 2.0 ** -23))
@example(EXACT_MIN)
@example(EXACT_MIN * (1 + 2.0 ** -23))
@example(-EXACT_MIN * (2 - 2.0 ** -23))
@example(2.0 ** -111 * (1 + 2.0 ** -23))   # below: the last part flushes
@example(2.0 ** -149)                # the smallest subnormal
@example(2.0 ** -126 * (1 - 2.0 ** -23))   # the largest subnormal
@example(1.0 + 2.0 ** -23)
@example(-0.0)
def test_f32_parts_sum_to_x_exactly(v):
    """h + m + l == x exactly for every finite f32 x of |x| >= 2^-110, at
    the extremes (f32's largest values, where a rounded h would overflow)
    and down to 2^-110; below it the error stays under 2^-133 (bf16's
    finest subnormal step); each part is a bf16 value."""
    check_parts(v)


def test_f32_parts_are_exact_on_every_exponent():
    """The same identity on 2^20 random bit patterns of every finite
    exponent (the kernels split x the same way, bit for bit)."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2 ** 32, 2 ** 20, dtype=np.uint64).astype(
        np.uint32)
    x = torch.from_numpy(bits.view(np.float32).copy())
    x = x[torch.isfinite(x)]
    h, m, l = tqm.f32_parts(x)
    total = h.double() + m.double() + l.double()
    big = x.abs() >= EXACT_MIN
    assert torch.equal(total[big], x.double()[big])
    assert ((total[~big] - x.double()[~big]).abs() < 2.0 ** -133).all()
    for p in (h, m, l):
        assert torch.equal(p.to(torch.bfloat16).float(), p)


# -- the arithmetic against the plain versions and the JAX bodies ------------

@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (2, 352, 96),
                                   (8, 512, 128), (64, 256, 256),
                                   (65, 352, 96), (300, 256, 128)])
@pytest.mark.parametrize("affine", [False, True], ids=["q4_0", "q4_1"])
def test_f32_model_matches_the_plain_versions(m, k, n, affine):
    """f32_model (the three parts, each q block's z, then the fold) against
    the plain versions of f32 mode, which the kernels are held to on the
    card: q4_matmul_dequant (B1 and B5: x @ W, W rounded once in f32) and,
    for q4_1, q41_matmul_decode_plain (B9: x @ (q d) + bsum(x) @ m), within
    1e-5 of max |x| @ |W|."""
    w, _ = (q41 if affine else q40)(k, n, seed=m)
    x = torch.from_numpy(acts(m, k, seed=m + 1))
    got = tqm.f32_model(x, w)
    assert got.shape == (m, n) and got.dtype == torch.float32
    tol = tol_of(x, w)
    want = tqm.q4_matmul_dequant(x, w, torch.float32)
    assert (got - want).abs().max().item() <= tol
    if affine:
        b9 = tqm.q41_matmul_decode_plain(x, w, torch.float32)
        assert (got - b9).abs().max().item() <= tol
    # the wrappers' CPU branches are those plain versions
    fn = (tqm.q41_matmul_decode if affine else tqm.q4_matmul_decode) \
        if m <= 64 else tqm.q4_matmul_prefill
    assert (fn(x, w, torch.float32) - got).abs().max().item() <= tol


@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("variant", ["v0", "v1", "v2"])
def test_f32_model_matches_the_jax_decode_bodies(variant, m):
    """B1's f32 arithmetic against q4_matmul_pallas(w_dtype=float32) in
    interpret mode, in the body each variant names (v0: q4_matmul_xla's
    function, v1 the JAX package's default, v2 the per-block scaling):
    nothing is rounded to bf16 on either side, so they differ by f32 sums
    alone, within 1e-5 of max |x| @ |W|."""
    w, wj = q40(256, 256, seed=20)
    x = acts(m, 256, seed=21)
    want = np.asarray(jqm.q4_matmul_pallas(
        jnp.asarray(x), wj.qs, wj.scales, interpret=True,
        w_dtype=jnp.float32, variant=variant))
    got = tqm.f32_model(torch.from_numpy(x), w).numpy()
    assert got.shape == want.shape == (m, 256)
    assert np.abs(got - want).max() <= tol_of(x, w)


@pytest.mark.parametrize("m", [1, 8, 64])
def test_f32_model_matches_the_jax_q41_body(m):
    """B9's f32 arithmetic against q41_matmul_pallas(w_dtype=float32) in
    interpret mode (x zero-padded to the stored K, as the dispatcher feeds
    it), within 1e-5 of max |x| @ |W|."""
    w, wj = q41(352, 96, seed=22)
    x = acts(m, 352, seed=23)
    xp = np.pad(x, ((0, 0), (0, wj.k - 352)))
    want = np.asarray(jqm.q41_matmul_pallas(
        jnp.asarray(xp), wj.qs, wj.scales, wj.mins, interpret=True,
        w_dtype=jnp.float32))[:, :96]
    got = tqm.f32_model(torch.from_numpy(x), w).numpy()
    assert np.abs(got - want).max() <= tol_of(x, w)


@pytest.mark.parametrize("m", [128, 264])
@pytest.mark.parametrize("variant", ["nat", "split"])
def test_f32_model_matches_the_jax_prefill_bodies(variant, m):
    """B5's (and B20's) f32 arithmetic against
    q4_matmul_prefill_pallas(w_dtype=float32) in interpret mode, nat and
    split (whose folded -8 is x @ ((q - 8) d) in exact arithmetic), within
    1e-5 of max |x| @ |W|."""
    w, wj = q40(256, 256, seed=24)
    x = acts(m, 256, seed=25)
    want = np.asarray(jqm.q4_matmul_prefill_pallas(
        jnp.asarray(x), wj.qs, wj.scales, interpret=True,
        w_dtype=jnp.float32, variant=variant))
    got = tqm.f32_model(torch.from_numpy(x), w).numpy()
    assert np.abs(got - want).max() <= tol_of(x, w)
    split = tqv.q4_prefill_split(torch.from_numpy(x), w.qs, w.scales,
                                 torch.float32).numpy()
    assert np.abs(split - want).max() <= tol_of(x, w)


# -- the three-part case ----------------------------------------------------

def three_part_err(y, exact):
    return (y.double() - exact).abs().max().item()


@pytest.mark.parametrize("m,k,n", [(3, 256, 64), (8, 4096, 256)])
@pytest.mark.parametrize("affine", [False, True], ids=["q4_0", "q4_1"])
def test_three_part_case_needs_every_part(m, k, n, affine):
    """chip_smoke.three_part_case, the card's check that a kernel uses all
    three parts of x: f32_model (the kernels' arithmetic) and the plain
    version sit within its tol (1/64 of the largest |l @ W|) of the exact
    product, while the same arithmetic on x without its last part misses
    by 64 tol, with its middle part cut to 7 bits by more, and bf16 mode
    by far more."""
    gen = torch.Generator()
    gen.manual_seed(m + k)
    x, w, exact, tol, miss = cs.three_part_case(torch, m, k, n, affine, gen,
                                                torch.device("cpu"))
    assert tol > 0 and miss >= 32 * tol
    plain = tqm.q41_matmul_decode_plain if affine else tqm.q4_matmul_dequant
    assert three_part_err(tqm.f32_model(x, w), exact) <= tol / 16
    assert three_part_err(plain(x, w, torch.float32), exact) <= tol / 16
    h, mid, low = tqm.f32_parts(x)
    assert three_part_err(tqm.f32_model(h + mid, w), exact) >= 32 * tol
    cut = (mid.view(torch.int32) & -(1 << 17)).view(torch.float32)
    assert three_part_err(tqm.f32_model(h + cut + low, w), exact) > miss
    assert three_part_err(plain(x, w, torch.bfloat16), exact) > 100 * miss


# -- the plans --------------------------------------------------------------

@pytest.mark.parametrize("k,n", B15_PLANES)
@pytest.mark.parametrize("affine", [False, True], ids=["q4_0", "q4_1"])
def test_f32_fold_plan_covers_every_column_tile_and_q_block_once(k, n,
                                                                 affine):
    """The fold kernel's plan for its f32 variants (10, and 11 with the
    mins) on the 7B, 13B and tp planes at M = 1..64: x slots of three tile
    sets (one at M <= 2 on mma.sync), every (column tile, q block) once,
    within the shared memory a block gets (check_b15_plan_covers)."""
    check_b15_plan_covers(k // 32, n, False, mins=affine, f32=True)


# stored (K, N) planes: 7B, 13B, and a rank's at tp 2 and 4
RA_PLANES = [(4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096),
             (4096, 32768), (5120, 15360), (5120, 5120), (5120, 27648),
             (13824, 5120), (4096, 6144), (2048, 4096), (4096, 11264),
             (5504, 4096), (1024, 4096), (4096, 5632), (2752, 4096)]
F32_ROWS = (1, 8, 57, 64, 65, 128, 192, 255, 256, 300, 512, 513)


def f32_ring_stages(affine, bx, wgs):
    """The ring slots of the register-A kernel's f32 mode
    (q4_prefill_ra.cuh max_stages): a stage's three part tiles of bx rows,
    packed rows, scales, and for q4_1 the mins and the block sums [2][bx],
    1024-aligned, in 231,424 bytes less 1 KB of alignment and the
    barriers."""
    cols = 64 * wgs
    raw = (3 * bx * 128 + 2 * 16 * cols + 2 * cols * 4 * (2 if affine else 1)
           + (2 * bx * 4 if affine else 0))
    return min(8, (231424 - 1024 - 24 * 8) // (-(-raw // 1024) * 1024))


@pytest.mark.parametrize("k,n", RA_PLANES)
def test_f32_prefill_plan_covers_every_output_and_q_block_once(k, n):
    """prefill_plan(f32=True) at 1 to 513 rows: x tiles of at most 128 rows
    (64, 96 or 128: z and acc take BX / 2 registers each), two warpgroups,
    and the row tiles, column tiles and splits of K (64-deep stages of two
    q blocks) cover every output and q block once in the kernel's items,
    every split keeping RA_MIN_STAGES stages; the ring holds three stages
    or more with the q4_1 block sums too."""
    nb = k // 32
    for m in F32_ROWS:
        p = tqm.prefill_plan(m, n, k, 132, f32=True)
        assert p.bx == tqm.ra_bx(m, True) and p.bx in tqm.RA_BX_F32
        assert p.wgs == 2 and 1 <= p.splits <= tqm.RA_MAX_SPLITS
        assert -(-m // p.bx) == -(-m // 128)
        cols = 128
        tiles = -(-m // p.bx) * -(-n // cols)
        nst = -(-nb // 2)
        blocks = {t: [] for t in range(tiles)}
        for t, z in tqm.ra_items(tiles, p):
            if p.splits == 1 or t < p.t0:
                stages = range(nst)
            else:
                stages = range(z * p.per, min(nst, (z + 1) * p.per))
                assert len(stages) >= tqm.RA_MIN_STAGES
            blocks[t] += [2 * s + j for s in stages for j in range(2)
                          if 2 * s + j < nb]
        assert all(b == list(range(nb)) for b in blocks.values())
        assert f32_ring_stages(True, p.bx, p.wgs) >= 3
    assert [tqm.ra_bx(m, True) for m in (1, 65, 128, 192, 255, 300, 512,
                                          513)] == [64, 96, 128, 96, 128,
                                                    128, 128, 128]
    assert tqm.f32_scratch_bytes(300, k, False) == 6 * 300 * k
    assert tqm.f32_scratch_bytes(301, k, True) == (
        6 * 301 * k + 4 * 2 * -(-k // 64) * 304)


# -- the routes -------------------------------------------------------------

def test_b20_f32_mode_runs_b5_at_every_m(monkeypatch):
    """B20 (q4_prefill_split) in f32 mode launches B5's f32 mode at every
    M (the register-A kernel; x @ ((q - 8) d) is the split body's function
    in exact arithmetic), counted in q4_matmul_prefill.launches, B15's
    kernel never; in bf16 mode B15's at M <= 32 (variant 1)."""
    from test_torch_q4_matmul import reports_cuda
    launched = []

    def b5(x, w, w_dtype, plan=None):
        launched.append(("B5", w_dtype))
        return torch.zeros((x.shape[0], w.n_logical))

    def fold(x, qs, scales, variant, n_out, plan=None, mins=None):
        launched.append(("fold", variant))
        return torch.zeros((x.shape[0], n_out))
    monkeypatch.setattr(tqm, "_launch_b5", b5)
    monkeypatch.setattr(tqv, "_launch_fold", fold)
    w, _ = q40(256, 256)
    qs, sc = reports_cuda(w.qs), reports_cuda(w.scales)
    for m in (1, 32, 33, 300, 512):
        launched.clear()
        before = tqm.q4_matmul_prefill.launches
        y = tqv.q4_prefill_split(reports_cuda(torch.zeros((m, 256))), qs, sc,
                                 torch.float32)
        assert y.shape == (m, 256)
        assert launched == [("B5", torch.float32)], m
        assert tqm.q4_matmul_prefill.launches == before + 1
    launched.clear()
    tqv.q4_prefill_split(reports_cuda(torch.zeros((8, 256))), qs, sc)
    assert launched == [("fold", 1)]


@pytest.mark.parametrize("affine", [False, True], ids=["q4_0", "q4_1"])
def test_f32_decode_wrappers_send_wide_calls_to_b5(monkeypatch, affine):
    """B1's and B9's wrappers called directly in f32 mode launch the fold
    kernel's f32 variant (10, 11) below f32_on_b5's rows and B5's f32 mode
    from them (the fold's f32 modes are built to B15_F32_MAX_M rows), each
    launch counted by the wrapper that made it; in bf16 mode the fold
    kernel at every M <= 64."""
    from test_torch_q4_matmul import reports_cuda
    launched = []

    def b5(x, w, w_dtype, plan=None):
        launched.append(("B5", w_dtype))
        return torch.zeros((x.shape[0], w.n_logical))

    def fold(x, qs, scales, variant, n_out, plan=None, mins=None):
        launched.append(("fold", variant))
        return torch.zeros((x.shape[0], n_out))
    monkeypatch.setattr(tqm, "_launch_b5", b5)
    monkeypatch.setattr(tqv, "_launch_fold", fold)
    fn = tqm.q41_matmul_decode if affine else tqm.q4_matmul_decode
    for k, n in ((256, 512), (1024, 256)):
        wt = (q41 if affine else q40)(k, n)[0]
        w = tt.QuantMatmulWeight(
            qs=reports_cuda(wt.qs), scales=reports_cuda(wt.scales),
            mins=None if wt.mins is None else reports_cuda(wt.mins),
            n_logical=wt.n_logical)
        first = (tqm.F32_ON_B5_DEEP_MIN_M if 2 * w.qs.shape[0] >
                 w.qs.shape[1] else tqm.F32_ON_B5_MIN_M)
        assert first - 1 <= tqv.B15_F32_MAX_M
        for m in (1, 2, 8, 23, 24, 32, 33, 64):
            x = reports_cuda(torch.zeros((m, k)))
            launched.clear()
            before = (fn.launches, tqm.q4_matmul_prefill.launches)
            assert fn(x, w, torch.float32).shape == (m, n)
            b5_rows = m >= first
            assert launched == ([("B5", torch.float32)] if b5_rows
                                else [("fold", 11 if affine else 10)]), m
            assert (fn.launches - before[0],
                    tqm.q4_matmul_prefill.launches - before[1]) == (
                (0, 1) if b5_rows else (1, 0)), m
            launched.clear()
            fn(x, w, torch.bfloat16)
            assert launched == [("fold", 9 if affine else 0)], m


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 8, 9, 16, 33, 64])
@pytest.mark.parametrize("affine", [False, True], ids=["q4_0", "q4_1"])
@pytest.mark.parametrize("k,n", [(4096, 4096), (11264, 4096)])
def test_f32_fold_kernels_match_plain(cuda_device, k, n, affine, m):
    """B1 and B9 in f32 mode (the fold kernel's variants 10 and 11; at
    f32_on_b5's rows B5's f32 mode) against their plain versions within
    1e-5 of max |x| @ |W|, twice and bit-equal, and no bf16 rounding: the
    f32 mode is far closer to the exact product than the bf16 mode; and on
    the three-part case within its tol of the exact product."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m)
    from fastllama_tpu_torch.models import synthetic
    w = synthetic.rand_weight(k, n, gen, cuda_device, affine)
    x = torch.randn((m, k), generator=gen, device=cuda_device)
    fn = tqm.q41_matmul_decode if affine else tqm.q4_matmul_decode
    plain = tqm.q41_matmul_decode_plain if affine else tqm.q4_matmul_dequant
    y = fn(x, w, torch.float32)
    want = plain(x, w, torch.float32)
    tol = tol_of(x.cpu(), type(w)(qs=w.qs.cpu(), scales=w.scales.cpu(),
                                  mins=None if w.mins is None
                                  else w.mins.cpu(), n_logical=w.n_logical))
    assert (y - want).abs().max().item() <= tol
    assert torch.equal(y, fn(x, w, torch.float32))
    exact = (tqm._pad_k(x, w.k).double()
             @ tt.dequant_matmul_weight(w, torch.float32).double())
    bf16 = fn(x, w, torch.bfloat16)
    assert ((y.double() - exact[:, :n]).abs().max()
            < (bf16.double() - exact[:, :n]).abs().max() / 10)
    x, w, exact, tol, miss = cs.three_part_case(torch, m, k, n, affine, gen,
                                                cuda_device)
    assert miss >= 32 * tol
    assert three_part_err(fn(x, w, torch.float32), exact) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 65, 128, 300, 513])
@pytest.mark.parametrize("affine", [False, True], ids=["q4_0", "q4_1"])
def test_b5_f32_kernel_matches_plain(cuda_device, affine, m):
    """B5 in f32 mode (the register-A kernel's f32 mode) on a 7B w2 plane
    against q4_matmul_dequant within 1e-5 of max |x| @ |W|, on its plan and
    on pinned plans that split K (tiles 0 and 1 whole), twice bit-equal;
    and on the three-part case (K 11008 as w2's) within its tol of the
    exact product on the same plans."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m)
    from fastllama_tpu_torch.models import synthetic
    w = synthetic.rand_weight(11008, 4096, gen, cuda_device, affine)
    x = torch.randn((m, 11008), generator=gen, device=cuda_device)
    want = tqm.q4_matmul_dequant(x, w, torch.float32)
    tol = 1e-5 * (tqm._pad_k(x.abs(), w.k)
                  @ tt.dequant_matmul_weight(w, torch.float32).abs()).max()
    n = w.qs.shape[1]
    for plan in (None, tqm.prefill_plan(m, n, w.k, 132, f32=True, splits=3,
                                        t0=0),
                 tqm.prefill_plan(m, n, w.k, 132, f32=True, splits=3,
                                  t0=1)):
        y = tqm.q4_matmul_prefill(x, w, torch.float32, plan=plan)
        assert (y - want).abs().max().item() <= tol.item(), plan
        assert torch.equal(y, tqm.q4_matmul_prefill(x, w, torch.float32,
                                                    plan=plan))
    x, w, exact, tol, miss = cs.three_part_case(torch, m, 11008, n, affine,
                                                gen, cuda_device)
    assert miss >= 32 * tol
    for plan in (None, tqm.prefill_plan(m, n, w.k, 132, f32=True, splits=3,
                                        t0=1)):
        y = tqm.q4_matmul_prefill(x, w, torch.float32, plan=plan)
        assert three_part_err(y, exact) <= tol, plan


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m", [("fold", 16), ("B5", 300)])
@pytest.mark.parametrize("affine", [False, True], ids=["q4_0", "q4_1"])
def test_f32_kernels_keep_a_nan_row_to_itself(cuda_device, affine, kernel,
                                              m):
    """A NaN row of x makes its own outputs NaN and no other's: the fold
    kernel's f32 mode on wgmma (M = 16) and B5's f32 mode at M = 300 on a
    plan that splits K with tile 0 whole (286 items on 132 blocks: a block
    goes from row tile 0's item to row tile 1's, where a z left from the
    NaN row would be added times 0), on the 7B wo plane; the other rows
    within 1e-5 of max |x| @ |W| of the plain version."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m)
    from fastllama_tpu_torch.models import synthetic
    w = synthetic.rand_weight(4096, 4096, gen, cuda_device, affine)
    x = torch.randn((m, 4096), generator=gen, device=cuda_device)
    x[5] = float("nan")
    if kernel == "fold":
        y = tqv._launch_fold(x, w.qs, w.scales, 11 if affine else 10,
                             w.n_logical, mins=w.mins)
    else:
        y = tqm.q4_matmul_prefill(x, w, torch.float32, plan=tqm.prefill_plan(
            m, 4096, 4096, 132, f32=True, splits=3, t0=1))
    assert torch.isnan(y[5]).all()
    rest = torch.ones(m, dtype=torch.bool, device=cuda_device)
    rest[5] = False
    xs = x[rest]
    want = (tqm.q41_matmul_decode_plain if affine and kernel == "fold"
            else tqm.q4_matmul_dequant)(xs, w, torch.float32)
    tol = 1e-5 * (tqm._pad_k(xs.abs(), w.k)
                  @ tt.dequant_matmul_weight(w, torch.float32).abs()).max()
    assert torch.isfinite(y[rest]).all()
    assert (y[rest] - want).abs().max().item() <= tol.item()


# ---------------------------------------------------------------------------
# f32 products under the process's TF32 setting: full f32 where the JAX
# package pins Precision.HIGHEST (utils/precision.ieee_f32)
# ---------------------------------------------------------------------------

def _precision_state():
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:
        legacy = "mixed"
    try:
        backend = torch.backends.cuda.matmul.fp32_precision
    except AttributeError:
        backend = None
    return legacy, backend


@pytest.mark.parametrize("setting", ["highest", "high", "medium"])
def test_ieee_f32_pins_highest_and_restores_the_callers_setting(setting):
    """Inside ieee_f32 the matmul precision is "highest"; after it, on a
    normal exit and on an exception, the caller's setting is back; with
    on=False nothing changes."""
    from fastllama_tpu_torch.utils.precision import ieee_f32
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(setting)
    try:
        before = _precision_state()
        with ieee_f32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert _precision_state() == before
        with pytest.raises(KeyError):
            with ieee_f32():
                raise KeyError("inside")
        assert _precision_state() == before
        with ieee_f32(False):
            assert _precision_state() == before
    finally:
        torch.set_float32_matmul_precision(prev)


def test_ieee_f32_restores_a_per_backend_setting():
    """A caller that set only the per-backend switch (where this PyTorch
    has one) gets it back, though the legacy getter cannot read then."""
    from fastllama_tpu_torch.utils.precision import ieee_f32
    matmul = torch.backends.cuda.matmul
    try:
        old = matmul.fp32_precision
    except AttributeError:
        pytest.skip("this PyTorch has no per-backend precision switch")
    try:
        matmul.fp32_precision = "tf32"
        with ieee_f32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == "tf32"
    finally:
        torch.set_float32_matmul_precision("highest")
        matmul.fp32_precision = old


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_forward_leaves_the_callers_setting_alone(mode, monkeypatch):
    """The f32 forward pins its products and gives the setting back; the
    bf16 forward never touches it (ieee_f32 is entered with on=False
    there, apart from any f32 LoRA term's _dot)."""
    import contextlib
    from fastllama_tpu_torch.models import llama as tl
    from fastllama_tpu_torch.utils.precision import ieee_f32
    from test_torch_model import HP as hp, jax_params, to_numpy_tree
    seen = []

    @contextlib.contextmanager
    def spy(on=True):
        seen.append(on)
        with ieee_f32(on):
            yield
    monkeypatch.setattr(tl, "ieee_f32", spy)
    tp = tl.params_from_numpy(to_numpy_tree(jax_params()), device="cpu")
    cfg = tl.ForwardConfig(n_head=hp.n_head, n_rot=hp.n_rot, w_dtype=mode)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        kv = tl.init_kv_cache(hp, 1, 16, dtype=getattr(torch, mode),
                              device="cpu")
        tl.forward(tp, torch.tensor([[1, 5, 9]]), 0, kv, cfg)
        tl.forward(tp, torch.tensor([[7]]), 3, kv, cfg)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and all(seen) == (mode == "float32")


def _pinned_calls(site, mode, monkeypatch):
    """The matmul precision in force at each product of one site the JAX
    package pins at HIGHEST in f32 mode, while the caller has "high" set:
    "slab", masked_attention's einsums in a prefill window and a decode
    step of forward; "paged", forward_paged_prefill's einsums; "sp",
    _sp_attention's calls into the ring (prefill and decode; the ring's
    functions stand in for a world here)."""
    import sys
    from fastllama_tpu_torch.engine import paged_kv as tpk
    from fastllama_tpu_torch.models import llama as tl
    from fastllama_tpu_torch.parallel import ring
    from test_torch_model import HP as hp, jax_params, to_numpy_tree
    seen = []
    real_einsum = torch.einsum

    def einsum(*a, **kw):
        caller = sys._getframe(1).f_code.co_name
        if caller in ("masked_attention", "forward_paged_prefill"):
            seen.append(torch.get_float32_matmul_precision())
        return real_einsum(*a, **kw)

    def ring_fn(*a, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return torch.zeros_like(a[0])
    monkeypatch.setattr(torch, "einsum", einsum)
    for name in ("ring_prefill", "sp_decode_attention"):
        monkeypatch.setattr(ring, name, ring_fn)
    monkeypatch.setattr(ring, "sp_write_decode", lambda *a: None)
    cfg = tl.ForwardConfig(n_head=hp.n_head, n_rot=hp.n_rot, w_dtype=mode)
    dtype = getattr(torch, mode)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        if site == "sp":
            g = torch.Generator().manual_seed(0)
            q = torch.randn((1, 2, hp.n_head, 64), generator=g)
            cache = torch.zeros((1, 8, hp.n_embd))
            sp = dataclasses.replace(cfg, sp_group=object(), sp_size=2)
            for t in (2, 1):
                pos = torch.arange(t, dtype=torch.int32)[None]
                tl._sp_attention(q[:, :t], q[:, :t], q[:, :t], cache, cache,
                                 pos, sp, 0.125)
            return seen
        tp = tl.params_from_numpy(to_numpy_tree(jax_params()), device="cpu")
        if site == "slab":
            kv = tl.init_kv_cache(hp, 1, 16, dtype=dtype, device="cpu")
            tl.forward(tp, torch.tensor([[1, 5, 9]]), 0, kv, cfg)
            tl.forward(tp, torch.tensor([[7]]), 3, kv, cfg)
            return seen
        m = tpk.PagedKVManager(hp, n_slots=1, page_size=4, total_pages=4,
                               pages_per_seq=4, dtype=dtype, device="cpu")
        assert m.alloc_for(0, 5)
        pages, offs = m.token_page_offsets(0, 0, 5)
        tl.forward_paged_prefill(
            tp, torch.tensor([[1, 5, 9, 20, 7]]), 4,
            torch.as_tensor(np.asarray(pages), dtype=torch.int32),
            torch.as_tensor(np.asarray(offs), dtype=torch.int32),
            m.k_pages, m.v_pages, cfg)
        return seen
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", ["slab", "paged", "sp"])
def test_attention_products_run_pinned_in_f32_mode(site, mode, monkeypatch):
    """Under a caller's "high", every product of the site (the slab and
    paged attention einsums, the SP ring) runs at "highest" in f32 weight
    mode, as the JAX package pins HIGHEST there, and under the caller's
    own setting in bf16 mode, where the JAX package pins nothing."""
    seen = _pinned_calls(site, mode, monkeypatch)
    want = "highest" if mode == "float32" else "high"
    assert seen and set(seen) == {want}, seen
    assert torch.get_float32_matmul_precision() != "high"


@pytest.mark.cuda
@pytest.mark.parametrize("lora_rank", [0, 8], ids=["base", "lora"])
def test_f32_mode_under_tf32_matches_the_cpu(cuda_device, lora_rank):
    """A host program's torch.set_float32_matmul_precision("high") does not
    reach the f32 mode: phase 16's 2-layer 7B-width f32 model (with f32 A/B
    terms on wq and wv for "lora") on the card, prefill and first decode
    step, eager, captured under "high" and replayed (chip_smoke.c2_check),
    gives logits equal bit for bit to the same runs under "highest" (an
    unpinned f32 product would take TF32 there) and within 1e-4 of the
    largest logit of the same weights on the CPU; the setting is "high"
    throughout and restored after."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    before = torch.get_float32_matmul_precision()
    out = cs.c2_check(torch, cuda_device, gen, lora_rank=lora_rank)
    assert torch.get_float32_matmul_precision() == before
    assert out["precision_during"] == "high" and out["replays"] >= 2
    for route in ("eager", "captured", "replayed"):
        assert out["equal"][route], (route, out)
        assert max(out[route]) <= 1e-4, (route, out)
