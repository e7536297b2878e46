"""PyTorch port: the q4 matmul variants (kernels/q4_variants.py: B15-B20,
the JAX package's q4_matmul_pallas / q4_matmul_prefill_int8 /
q4_matmul_prefill_pallas bodies) against those bodies in Pallas interpret
mode, the default decode function (C1) against the JAX v1 body, and the
kernel switches (use_pallas, FASTLLAMA_PREFILL_INT8,
FASTLLAMA_PREFILL_KERNEL) against the JAX dispatch."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import fastllama_tpu
import fastllama_tpu_torch
from fastllama_tpu.config import HyperParams
from fastllama_tpu.engine.tokenizer import Vocab
from fastllama_tpu.io.checkpoint import CheckpointWriter
from fastllama_tpu.kernels import q4_matmul as jqm
from fastllama_tpu.quant import tensor as jt
from fastllama_tpu.quant.q4 import quantize_q4_0, quantize_q4_1
from fastllama_tpu_torch.kernels import cuda_lib
from fastllama_tpu_torch.kernels import q4_matmul as tqm
from fastllama_tpu_torch.kernels import q4_variants as qv
from fastllama_tpu_torch.quant import tensor as tt

torch.set_num_threads(1)

K, N = 512, 256
DECODE = ("v0", "v1", "v2", "v3", "v4", "v5", "v7")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def planes(k=K, n=N, seed=0):
    """(qs, f32 scales) of a q4_0 weight from numpy-seeded data, as both
    packages store them (split-K packing)."""
    rng = np.random.default_rng(seed)
    codes, scales = quantize_q4_0(
        (rng.standard_normal((n, k)) * 0.1).astype(np.float32))
    wj = jt.make_matmul_weight(codes, scales)
    return np.array(wj.qs), np.array(wj.scales)


def acts(m, k=K, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)) * scale).astype(np.float32)


def absum(x, qs, sc):
    """The largest sum |R(x)| (q + 8) |d|: the scale of every term of the
    variants (the weight and the folded offset)."""
    xr = torch.from_numpy(x).to(torch.bfloat16).float().abs()
    w = (qv._codes(torch.from_numpy(qs)) + 8.0) * torch.from_numpy(
        sc).float().abs().repeat_interleave(32, dim=0)
    return (xr @ w).max().item()


def jax_body(x, qs, sc, variant, w_dtype, m_pad=0):
    """The JAX body in interpret mode; m_pad > M feeds it x padded with zero
    rows (row i of the result is then still x's row i)."""
    m = x.shape[0]
    if m_pad > m:
        x = np.pad(x, ((0, m_pad - m), (0, 0)))
    return np.asarray(jqm.q4_matmul_pallas(
        jnp.asarray(x), jnp.asarray(qs), jnp.asarray(sc), interpret=True,
        variant=variant, w_dtype=w_dtype))[:m]


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("mode", ["bfloat16", "float32"])
@pytest.mark.parametrize("h", [False, True], ids=["f32_scales", "h"])
@pytest.mark.parametrize("variant", DECODE)
def test_decode_plain_matches_the_jax_body(variant, h, mode, m):
    """Each decode body's plain version (the function its kernel computes:
    v0 B1, v1/v4/v5 B15, v2 B16, v3 B17, v7 B18; "h": bf16 scales) against
    the JAX body in interpret mode, within 1e-5 of sum |x| |w|: the same
    roundings, the f32 sums in another order. In f32 mode every variant is
    B1's f32 function (x @ ((q - 8) d), nothing rounded), which differs
    from each body by f32 rounding alone, within the same 1e-5. v7 at
    M = 1 meets the body fed x padded to 8 rows, as the JAX dispatcher
    feeds it (q4_matmul pads M to 8): on the CPU, at one row, XLA folds
    the bf16 pair sum x_lo + x_hi into the f32 dot that sums it, unrounded,
    which the body at every other M (and its dtype rules) rounds."""
    qs, sc = planes()
    x = acts(m)
    jsc = jnp.asarray(sc).astype(jnp.bfloat16) if h else sc
    tsc = torch.from_numpy(sc).to(torch.bfloat16) if h else torch.from_numpy(
        sc)
    want = jax_body(x, qs, jsc, variant, getattr(jnp, mode),
                    m_pad=8 if (variant, m) == ("v7", 1) else 0)
    got = qv.q4_matmul_pallas(torch.from_numpy(x), torch.from_numpy(qs), tsc,
                              w_dtype=getattr(torch, mode),
                              variant=variant).numpy()
    assert got.shape == want.shape == (m, N)
    tol = 1e-5 * absum(x, qs, tsc.float().numpy())
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("variant", ["v0", "v1", "v2", "v3", "v7"])
def test_variants_differ_from_each_other(variant):
    """The bodies are distinct functions in bf16 mode (so each needs its
    own kernel): each plain version differs from v0's (B1's) by more than
    ten times the tolerance above; v4 and v5 are v1 (below)."""
    qs, sc = planes()
    x = acts(8)
    args = (torch.from_numpy(x), torch.from_numpy(qs), torch.from_numpy(sc))
    y = qv.decode_plain(*args, variant).numpy()
    y0 = qv.decode_plain(*args, "v0").numpy()
    if variant == "v0":
        np.testing.assert_array_equal(y, tqm.q4_matmul_dequant(
            args[0], tt.QuantMatmulWeight(qs=args[1], scales=args[2])).numpy())
    else:
        assert np.abs(y - y0).max() > 10 * 1e-5 * absum(x, qs, sc)


@pytest.mark.parametrize("variant", ["v4", "v5"])
def test_v4_v5_map_onto_b15_bit_equal(variant):
    """v4 and v5 are bit-equal to v1 in the JAX package (interpret mode), so
    the port runs them on v1's kernel, B15, with v1's result."""
    qs, sc = planes(seed=2)
    x = acts(8, seed=3)
    np.testing.assert_array_equal(
        jax_body(x, qs, sc, variant, jnp.bfloat16),
        jax_body(x, qs, sc, "v1", jnp.bfloat16))
    assert qv.DECODE_KERNELS[variant] is qv.q4_decode_v1
    args = (torch.from_numpy(x), torch.from_numpy(qs), torch.from_numpy(sc))
    assert torch.equal(qv.q4_matmul_pallas(*args, variant=variant),
                       qv.q4_matmul_pallas(*args, variant="v1"))


# -- the int8 prefill bodies -------------------------------------------------

def jax_int8(x, qs, sc, variant):
    return np.asarray(jqm.q4_matmul_prefill_int8(
        jnp.asarray(x), jnp.asarray(qs), jnp.asarray(sc), interpret=True,
        variant=variant))


@pytest.mark.parametrize("m,k,n", [(256, 512, 256), (64, 1024, 128)])
@pytest.mark.parametrize("variant", ["natx", "split"])
def test_b19_plain_matches_natx_and_split(variant, m, k, n):
    """B19's plain version against the natx and split bodies (bit-equal to
    each other) in interpret mode: bit-equal. They divide the scales by s8
    (d / s8) where B3 (nat) multiplies by 1 / s8, and differ from nat in
    many outputs; xq and dx are B2's."""
    qs, sc = planes(k, n, seed=4)
    x = acts(m, k, seed=5, scale=2.0)
    want = jax_int8(x, qs, sc, variant)
    got = qv.q4_matmul_prefill_int8(torch.from_numpy(x), torch.from_numpy(qs),
                                    torch.from_numpy(sc),
                                    variant=variant).numpy()
    np.testing.assert_array_equal(got, want)
    nat = qv.q4_matmul_prefill_int8(torch.from_numpy(x), torch.from_numpy(qs),
                                    torch.from_numpy(sc)).numpy()
    assert (nat != got).sum() > 0.01 * got.size


def test_natp_maps_onto_b3_bit_equal():
    """natp is bit-equal to nat in the JAX package, so the port runs it on
    B2 + B3; both agree with the JAX bodies to the B3 tolerance (2 ulp of
    the final f32 rescale)."""
    qs, sc = planes(seed=6)
    x = acts(256, seed=7, scale=2.0)
    nat, natp = (jax_int8(x, qs, sc, v) for v in ("nat", "natp"))
    np.testing.assert_array_equal(nat, natp)
    args = (torch.from_numpy(x), torch.from_numpy(qs), torch.from_numpy(sc))
    got = qv.q4_matmul_prefill_int8(*args, variant="natp")
    assert torch.equal(got, qv.q4_matmul_prefill_int8(*args, variant="nat"))
    assert np.all(np.abs(got.numpy() - natp)
                  <= 2 * np.spacing(np.abs(natp)))


def pack_codes(codes):
    """qs uint8 [K/2, N] of codes [K, N] (0..15) in the split-K packing:
    row 16 b + j holds K row 32 b + j low and 32 b + 16 + j high."""
    k, n = codes.shape
    c = codes.reshape(k // 32, 2, 16, n).astype(np.uint8)
    return (c[:, 0] | (c[:, 1] << 4)).reshape(k // 2, n)


def reciprocal_traps(k=1024, n=400, seed=30, traps=96):
    """(qs, scales) of a q4_0 plane whose natx requantization tells d / s8
    from d * (1 / s8): every column's largest scale is 0.02 (so s8 is one
    value), and at `traps` (q block, column) places the scale is one whose
    division and reciprocal product, times the block's code q - 8 (all 32
    codes of that block), round to different integers. Found by scanning
    the f32 neighbours of each rounding boundary (k + 1/2) s8 / |q - 8|."""
    s8 = np.float32(np.float32(0.02) * np.float32(8.0 / 127.0))
    inv = np.float32(np.float32(1.0) / s8)
    found = []
    for qm in (q for q in range(-8, 8) if q):
        for b in range(128):
            d0 = np.float32((b + 0.5) / abs(qm) * s8)
            if d0 >= 0.02:
                break
            ds = (np.array([d0]).view(np.int32)
                  + np.arange(-16, 17, dtype=np.int32)).view(np.float32)
            wd = np.round(np.float32(qm) * (ds / s8).astype(np.float32))
            wr = np.round(np.float32(qm) * (ds * inv).astype(np.float32))
            found += [(d, qm + 8) for d in ds[wd != wr]]
    rng = np.random.default_rng(seed)
    nb = k // 32
    scales = rng.uniform(1e-3, 0.019, (nb, n)).astype(np.float32)
    scales[0] = 0.02
    codes = rng.integers(0, 16, (k, n))
    for i, at in enumerate(rng.choice((nb - 1) * n, traps, replace=False)):
        b, col = 1 + at // n, at % n
        scales[b, col], codes[32 * b:32 * b + 32, col] = found[i % len(found)]
    return pack_codes(codes), scales


def natx_by_reciprocal(x, qs, scales):
    """B19's plain version with B3's reciprocal product in place of the
    division: what a kernel that multiplied by 1 / s8 would give."""
    xq, dx = tqm.quant_rows_int8_plain(x, 2 * qs.shape[0])
    s8, _ = qv.natx_scales(scales)
    sc = scales * (torch.ones_like(s8) / s8)
    w8 = torch.round((qv._codes(qs) - 8.0) * sc.repeat_interleave(32, dim=0))
    acc = tqm.int8_accumulators(xq, w8).to(torch.float32)
    return (acc * dx[:, None]) * s8[None, :]


@pytest.mark.parametrize("m", [1, 65])
def test_reciprocal_traps_tell_the_division_apart(m):
    """On reciprocal_traps' plane (N 400: not a multiple of B19's 128-column
    tile) B19's plain version is bit-equal to the JAX natx body in interpret
    mode, and a reciprocal in place of its division changes outputs: the
    plane the `cuda` test holds B19's kernel to bit for bit."""
    qs, sc = reciprocal_traps()
    x = acts(m, 1024, seed=31, scale=2.0)
    args = (torch.from_numpy(x), torch.from_numpy(qs), torch.from_numpy(sc))
    got = qv.q4_matmul_prefill_int8(*args, variant="natx")
    np.testing.assert_array_equal(got.numpy(), jax_int8(x, qs, sc, "natx"))
    assert (got != natx_by_reciprocal(*args)).sum().item() >= 8 * m


def test_variant_wrappers_refuse_what_they_do_not_take():
    qs, sc = (torch.from_numpy(a) for a in planes())
    x = torch.from_numpy(acts(8))
    with pytest.raises(ValueError, match="v6"):
        qv.q4_matmul_pallas(x, qs, sc, variant="v6")
    with pytest.raises(ValueError, match="natq"):
        qv.q4_matmul_prefill_int8(x, qs, sc, variant="natq")
    with pytest.raises(ValueError, match="M <= 512"):
        qv.q4_matmul_prefill_pallas(torch.zeros((513, K)), qs, sc,
                                    variant="split")
    with pytest.raises(ValueError, match="nats"):
        qv.q4_matmul_prefill_pallas(x, qs, sc, variant="nats")
    with pytest.raises(ValueError, match="M <= 512"):
        qv.q4_prefill_int8_natx(torch.zeros((513, K)), qs, sc)
    np.testing.assert_array_equal(
        qv.q4_matmul_prefill_pallas(x, qs, sc).numpy(),
        tqm.q4_matmul_dequant(x, tt.QuantMatmulWeight(qs=qs, scales=sc))
        .numpy())


# -- B20: the bf16 prefill split body ----------------------------------------

def jax_split(x, qs, sc, w_dtype):
    return np.asarray(jqm.q4_matmul_prefill_pallas(
        jnp.asarray(x), jnp.asarray(qs), jnp.asarray(sc), interpret=True,
        variant="split", w_dtype=w_dtype))


@pytest.mark.parametrize("m,k,n", [(1, 1024, 256), (64, 1024, 256),
                                   (256, 512, 256), (512, 512, 256)])
@pytest.mark.parametrize("mode", ["bfloat16", "float32"])
def test_b20_plain_matches_the_jax_split_body(mode, m, k, n):
    """q4_matmul_prefill_pallas(variant="split") (B20 on the card; its plain
    version here) against the JAX split body (_q4mm_prefill_kernel) in
    interpret mode. bf16: v1's fold at prefill M, within 1e-4 absolute on
    outputs of max |y| about 10-17 (the same roundings, the f32 sums in
    another order: about 1e-5 measured). f32: the port runs B5's f32
    function x @ ((q - 8) d), equal to the body in exact arithmetic, held
    at the JAX test's own tolerance (rtol 1e-5, atol 2e-4)."""
    qs, sc = planes(k, n, seed=22)
    x = acts(m, k, seed=23)
    want = jax_split(x, qs, sc, getattr(jnp, mode))
    got = qv.q4_matmul_prefill_pallas(
        torch.from_numpy(x), torch.from_numpy(qs), torch.from_numpy(sc),
        w_dtype=getattr(torch, mode), variant="split").numpy()
    assert got.shape == want.shape == (m, n)
    assert np.abs(want).max() > 5.0
    if mode == "bfloat16":
        assert np.abs(got - want).max() <= 1e-4
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)


@pytest.mark.parametrize("m", [8, 64])
def test_b20_is_v1s_function_at_decode_m(m):
    """At M <= 64 the JAX split body is bit-equal to the JAX v1 decode body
    (interpret mode), and the port's B20 plain version is v1's (B15's plain
    version) at every M; it differs from nat (B5) by far more than its
    tolerance."""
    qs, sc = planes(1024, 256, seed=24)
    x = acts(m, 1024, seed=25)
    np.testing.assert_array_equal(jax_split(x, qs, sc, jnp.bfloat16),
                                  jax_body(x, qs, sc, "v1", jnp.bfloat16))
    args = (torch.from_numpy(x), torch.from_numpy(qs), torch.from_numpy(sc))
    split = qv.q4_matmul_prefill_pallas(*args, variant="split")
    assert torch.equal(split, qv.decode_plain(*args, "v1"))
    nat = qv.q4_matmul_prefill_pallas(*args)
    assert (split - nat).abs().max().item() > 100 * 1e-4


# B20's fold slots (csrc/q4_prefill.cu kFoldA, kFoldB): slot j pairs part
# FOLD_A[j] of bsum with part FOLD_B[j] of -8 d (0 high, 1 middle, 2 low):
# hH, hM, mH, hL, mM, lH, mL, lM
FOLD_A = (0, 0, 1, 0, 1, 2, 1, 2)
FOLD_B = (0, 1, 0, 2, 1, 0, 2, 1)


def bf16_parts(v):
    """v (f32) as three bf16 parts, high to low, in f32, each rounded (the
    cast pass's split of bsum): v = h + m + l."""
    h = v.to(torch.bfloat16).float()
    m = (v - h).to(torch.bfloat16).float()
    return h, m, ((v - h) - m).to(torch.bfloat16).float()


def truncated_parts(w):
    """w (f32) as three bf16 parts by truncation (the fold warps' split of
    -8 d): the top 16 bits of w's pattern, those of the exact rest, and
    what is left (at most 8 significant bits): w = H + M + L."""
    h = (w.view(torch.int32) & -65536).view(torch.float32)
    r = w - h
    m = (r.view(torch.int32) & -65536).view(torch.float32)
    return h, m, r - m


def b20_model(x, qs, sc):
    """B20's bf16 arithmetic as its kernel is built: R(x) @ R(q d), exact
    products summed (float64 here, f32 on the tensor cores), plus the fold:
    the cast pass's block sums (a thread's four x in order, then the 8
    threads of a block pairwise, in f32) and -8 d, each as three bf16 parts
    (rounded, truncated), and for each q block the 8 slot products FOLD_A x
    FOLD_B, each exact, summed."""
    x, qs, sc = (torch.from_numpy(a) for a in (x, qs, sc))
    m, k = x.shape
    w = (qv._codes(qs) * sc.repeat_interleave(32, dim=0)).to(
        torch.bfloat16).double()
    prod = x.to(torch.bfloat16).double() @ w
    q = x.reshape(m, k // 32, 8, 4)
    s = ((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]
    for _ in range(3):                  # the shuffles: lanes ^ 1, ^ 2, ^ 4
        s = s[..., 0::2] + s[..., 1::2]
    vp, wp = bf16_parts(s[..., 0]), truncated_parts(-8.0 * sc)
    fold = sum(vp[a].double() @ wp[b].double()
               for a, b in zip(FOLD_A, FOLD_B))
    return (prod + fold).float().numpy()


@pytest.mark.parametrize("m", [1, 64, 512])
@pytest.mark.parametrize("k", [1024, 4096])
def test_b20_fold_model_matches_the_jax_split_body(k, m):
    """The model of B20's kernel (b20_model: the fold as bf16 part products
    on the tensor cores) against the JAX split body (_q4mm_prefill_kernel,
    its fold a HIGHEST dot) in interpret mode, within 1e-4 of max |y|, the
    bound phase 15 holds the kernel to. The 8 slots leave out only l L,
    below 2^-31 |v w| a block; what remains is f32 summation error (4e-7
    to 1e-6 of max |y| measured). With the high parts alone (h H) the fold
    would miss by 6e-3 to 1e-2 of max |y|: far past the bound."""
    qs, sc = planes(k, 256, seed=32)
    x = acts(m, k, seed=33)
    want = jax_split(x, qs, sc, jnp.bfloat16)
    got = b20_model(x, qs, sc)
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * top
    xt = torch.from_numpy(x).reshape(m, k // 32, 32).sum(-1)
    coarse = -8.0 * (xt.to(torch.bfloat16).double()
                     @ torch.from_numpy(sc).to(torch.bfloat16).double())
    exact = -8.0 * (xt.double() @ torch.from_numpy(sc).double())
    assert (coarse - exact).abs().max().item() > 1e-4 * top


# -- C1: the default decode function -----------------------------------------

# the port's bf16 tolerance between two roundings of one q4 product (the
# card-vs-CPU rule of chip_smoke.py phase 5): a share of max |y|
BF16_TOL = 1e-2


@pytest.mark.parametrize("k,n", [(1024, 512), (4096, 256)])
@pytest.mark.parametrize("m", [1, 8])
def test_default_decode_is_within_bf16_tolerance_of_the_v1_body(m, k, n):
    """C1, a knowing departure: q4_matmul's default (use_pallas=None) at
    decode M runs B1, q4_matmul_xla's function (the JAX package's default
    on the CPU), where a TPU runs v1's fold. The two round the same exact
    product in two orders: the default sits within 1e-2 of max |y| of the
    JAX v1 body in interpret mode (about 5e-3 to 7e-3 measured), and
    is not v1 itself (use_pallas=True is, B15)."""
    qs, sc = planes(k, n, seed=26)
    x = acts(m, k, seed=27)
    wt = tt.QuantMatmulWeight(qs=torch.from_numpy(qs),
                              scales=torch.from_numpy(sc))
    got = tqm.q4_matmul(torch.from_numpy(x), wt).numpy()
    want = jax_body(x, qs, sc, "v1", jnp.bfloat16)
    err = np.abs(got - want).max()
    assert 0 < err <= BF16_TOL * np.abs(want).max()
    np.testing.assert_array_equal(
        got, tqm.q4_matmul_dequant(torch.from_numpy(x), wt).numpy())


# -- the kernel switches -----------------------------------------------------

def q40_weights(k=352, n=96, seed=8):
    rng = np.random.default_rng(seed)
    codes, scales = quantize_q4_0(
        (rng.standard_normal((n, k)) * 0.1).astype(np.float32))
    return (tt.make_matmul_weight(codes, scales, device="cpu"),
            jt.make_matmul_weight(codes, scales))


def q41_weights(k=352, n=96, seed=9):
    rng = np.random.default_rng(seed)
    codes, scales, mins = quantize_q4_1(
        (rng.standard_normal((n, k)) * 0.1 + 0.02).astype(np.float32))
    return (tt.make_matmul_weight_q41(codes, scales, mins, device="cpu"),
            jt.make_matmul_weight_q41(codes, scales, mins))


def close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("mode", ["bfloat16", "float32"])
@pytest.mark.parametrize("affine,m", [(False, 1), (False, 8), (False, 100),
                                      (False, 256), (True, 1), (True, 100)])
def test_use_pallas_false_is_q4_matmul_xla(affine, m, mode):
    """q4_matmul(use_pallas=False) against the JAX q4_matmul(use_pallas=
    False) (jitted, as its forward runs it): q4_matmul_xla's function at
    every M and for both weight kinds, no int8 at M = 256, to f32
    reassociation (1e-5 of the largest output)."""
    wt, wj = (q41_weights if affine else q40_weights)()
    x = acts(m, 352, seed=10)
    got = tqm.q4_matmul(torch.from_numpy(x), wt, w_dtype=getattr(torch, mode),
                        use_pallas=False).numpy()
    want = np.asarray(jax.jit(lambda a, w: jqm.q4_matmul(
        a, w, use_pallas=False, w_dtype=getattr(jnp, mode)))(
            jnp.asarray(x), wj))
    close(got, want, 1e-5)


@pytest.mark.parametrize("m", [1, 8])
def test_use_pallas_true_is_the_pallas_decode_kernel(m):
    """q4_matmul(use_pallas=True) at decode M: the JAX Pallas kernel's
    function (v1's fold, B15) against the JAX q4_matmul(use_pallas=True)
    in interpret mode, within 1e-5 of sum |x| |w|."""
    qs, sc = planes(seed=11)
    wt = tt.QuantMatmulWeight(qs=torch.from_numpy(qs),
                              scales=torch.from_numpy(sc))
    wj = jt.QuantMatmulWeight(jnp.asarray(qs), jnp.asarray(sc), None, N)
    x = acts(m, seed=12)
    got = tqm.q4_matmul(torch.from_numpy(x), wt, use_pallas=True).numpy()
    want = np.asarray(jqm.q4_matmul(jnp.asarray(x), wj, use_pallas=True,
                                    interpret=True))
    assert np.abs(got - want).max() <= 1e-5 * absum(x, qs, sc)


def spy_port(monkeypatch):
    called = []
    for name, tag in (("q4_matmul_prefill_int8", "int8"),
                      ("q4_matmul_prefill", "exact")):
        orig = getattr(tqm, name)
        monkeypatch.setattr(tqm, name, lambda *a, _o=orig, _t=tag, **kw:
                            called.append(_t) or _o(*a, **kw))
    return called


def spy_jax(monkeypatch):
    """The JAX dispatch's choice at prefill M: its int8 functions (the
    kernel, or the emulation where the kernel path is not taken) or its
    bf16-exact ones (the resident-x kernel, or q4_matmul_xla); each spy
    returns zeros of the output's shape."""
    called = []
    for name, tag in (("q4_matmul_prefill_int8", "int8"),
                      ("q4_matmul_int8_xla", "int8"),
                      ("q4_matmul_prefill_pallas", "exact")):
        monkeypatch.setattr(jqm, name, lambda x, qs, *a, _t=tag, **kw:
                            called.append(_t) or jnp.zeros(
                                (x.shape[0], qs.shape[1]), jnp.float32))
    monkeypatch.setattr(jqm, "q4_matmul_xla", lambda x, w, **kw:
                        called.append("exact") or jnp.zeros(
                            (x.shape[0], w.qs.shape[1]), jnp.float32))
    return called


@pytest.mark.parametrize("use_pallas", [None, False])
@pytest.mark.parametrize("prefill_int8", [None, True, False])
@pytest.mark.parametrize("kernel_env", [None, "0"])
@pytest.mark.parametrize("int8_env", [None, "1", "0", "yes"])
def test_prefill_switches_follow_the_jax_dispatch(
        monkeypatch, int8_env, kernel_env, prefill_int8, use_pallas):
    """At M = 256 (q4_0, bf16 mode) the port takes int8 (B2 + B3) or the
    bf16-exact B5 where the JAX dispatch takes its int8 or its exact
    function, under every combination of FASTLLAMA_PREFILL_INT8 ("1"
    forces, any other value pins off), FASTLLAMA_PREFILL_KERNEL ("0"
    turns the default int8 off), an explicit prefill_int8 (which wins) and
    use_pallas (False turns the default off). The port's None is the JAX
    package's TPU dispatch, its use_pallas=True on the CPU."""
    for var, val in (("FASTLLAMA_PREFILL_INT8", int8_env),
                     ("FASTLLAMA_PREFILL_KERNEL", kernel_env)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    qs, sc = planes(seed=13)
    wt = tt.QuantMatmulWeight(qs=torch.from_numpy(qs),
                              scales=torch.from_numpy(sc))
    wj = jt.QuantMatmulWeight(jnp.asarray(qs), jnp.asarray(sc), None, N)
    x = acts(256, seed=14)
    port, jax_ = spy_port(monkeypatch), spy_jax(monkeypatch)
    tqm.q4_matmul(torch.from_numpy(x), wt, prefill_int8=prefill_int8,
                  use_pallas=use_pallas)
    jqm.q4_matmul(jnp.asarray(x), wj, prefill_int8=prefill_int8,
                  use_pallas=True if use_pallas is None else use_pallas)
    assert len(port) == len(jax_) == 1 and port == jax_


@pytest.mark.parametrize("prefill_int8", [None, True])
def test_f32_mode_takes_int8_only_when_asked(monkeypatch, prefill_int8):
    monkeypatch.delenv("FASTLLAMA_PREFILL_INT8", raising=False)
    monkeypatch.delenv("FASTLLAMA_PREFILL_KERNEL", raising=False)
    qs, sc = planes(seed=15)
    wt = tt.QuantMatmulWeight(qs=torch.from_numpy(qs),
                              scales=torch.from_numpy(sc))
    wj = jt.QuantMatmulWeight(jnp.asarray(qs), jnp.asarray(sc), None, N)
    x = acts(256, seed=16)
    port, jax_ = spy_port(monkeypatch), spy_jax(monkeypatch)
    tqm.q4_matmul(torch.from_numpy(x), wt, w_dtype=torch.float32,
                  prefill_int8=prefill_int8)
    jqm.q4_matmul(jnp.asarray(x), wj, w_dtype=jnp.float32,
                  prefill_int8=prefill_int8, use_pallas=True)
    assert port == jax_ == ["int8" if prefill_int8 else "exact"]


# -- Model(use_pallas=False) on a tiny checkpoint ----------------------------

HP = HyperParams(n_vocab=320, n_embd=64, n_head=4, n_layer=2, n_rot=16)
N_FF = 96
# one token a character (the byte pieces): a window of 272 tokens
PROMPT = "".join(chr(97 + i * 7 % 26) for i in range(270))


def write_tiny(path, seed=0):
    rng = np.random.default_rng(seed)

    def q(n, k, scale=0.15):
        return quantize_q4_0(
            (rng.standard_normal((n, k)) * scale).astype(np.float32))
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" w{i}".encode(), 1.0) for i in range(HP.n_vocab - len(toks))]
    d = HP.n_embd
    w = CheckpointWriter(path, HP, Vocab.from_tokens(toks))
    w.add_q4_embedding("tok_embeddings.weight", *q(HP.n_vocab, d, 0.4))
    w.add_dense("norm.weight", np.ones(d, np.float32))
    w.add_q4_matmul("output.weight", *q(HP.n_vocab, d))
    for i in range(HP.n_layer):
        p = f"layers.{i}."
        w.add_dense(p + "attention_norm.weight", np.ones(d, np.float32))
        w.add_dense(p + "ffn_norm.weight", np.ones(d, np.float32))
        for nm in ("wq", "wk", "wv", "wo"):
            w.add_q4_matmul(p + f"attention.{nm}.weight", *q(d, d))
        w.add_q4_matmul(p + "feed_forward.w1.weight", *q(N_FF, d))
        w.add_q4_matmul(p + "feed_forward.w3.weight", *q(N_FF, d))
        w.add_q4_matmul(p + "feed_forward.w2.weight", *q(d, N_FF))
    w.finish()


def test_model_use_pallas_false_matches_the_jax_model(tmp_path, monkeypatch):
    """Model(use_pallas=False) in bf16 mode on both packages: a 272-token
    window (no int8 prefill in either: the switch turns the default off,
    so the port's window runs B5 and never B3) and 4 greedy tokens; the
    last logits agree at the port's bf16 tolerance (3e-2 of the largest)
    and so do the streams."""
    monkeypatch.delenv("FASTLLAMA_PREFILL_INT8", raising=False)
    monkeypatch.delenv("FASTLLAMA_PREFILL_KERNEL", raising=False)
    write_tiny(tmp_path / "tiny")
    kw = dict(n_ctx=512, n_batch=512, seed=7, kv_dtype="bfloat16",
              weight_dtype="bfloat16", use_pallas=False)
    jm = fastllama_tpu.Model(str(tmp_path / "tiny"),
                             logger=fastllama_tpu.Logger(), **kw)
    tm = fastllama_tpu_torch.Model(str(tmp_path / "tiny"), device="cpu",
                                   logger=fastllama_tpu_torch.Logger(), **kw)
    assert tm._model.rcfg.use_pallas is False
    port = spy_port(monkeypatch)
    streams = []
    for m in (jm, tm):
        chunks = []
        assert m.ingest(PROMPT)
        assert m.generate(num_tokens=4, temp=0.0,
                          streaming_fn=chunks.append)
        streams.append("".join(chunks))
    assert "exact" in port and "int8" not in port
    assert streams[0] == streams[1]
    close(tm.get_logits(), jm.get_logits(), 3e-2)


# -- B15 and B17's kernel (csrc/q4_fold.cuh): its plan and its arithmetic ----

# (K, N) planes: 7B (N padded as the tensor-core plans see them: 22016 and
# 32000 are multiples of 64 but not of 128), 13B, and the 7B planes a rank
# holds at tp 2 and tp 4 (tests/test_torch_q4_matmul.py's PLANES_7B_TP)
B15_PLANES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
              (4096, 32000), (5120, 15360), (5120, 5120), (5120, 27648),
              (13824, 5120), (4096, 6144), (2048, 4096), (4096, 11264),
              (5504, 4096), (4096, 16384), (4096, 3072), (1024, 4096),
              (4096, 5632), (2752, 4096), (4096, 8192)]
# clusters a card holds at once, as an H100 answered for B19's clusters of 4
# (30, not 33): a capacity below sms // S
B15_CAPACITY = {1: 132, 2: 66, 3: 42, 4: 30, 5: 24, 6: 18, 7: 14, 8: 15}


def check_b15_plan_covers(nb, n, sc16, mins=False, f32=False):
    """For M = 1..64 (f32: 1..B15_F32_MAX_M, the rows its modes are built
    for), with the card's own capacity and with sms // S: the plan of the
    fold kernel on a plane of nb q blocks and N stored columns (mins: B9's
    stages, f32 scales and mins; f32: the f32 modes' x slots, three sets
    of tiles) covers each (column tile, q block) exactly
    once, in clusters of at most 8, with at least 2 ring slots and within
    the shared memory a block gets."""
    for cap in (B15_CAPACITY.get, None):
        for m in range(1, (qv.B15_F32_MAX_M if f32 else 64) + 1):
            p = qv.b15_plan(m, n, nb, 132, sc16, cap, mins=mins, f32=f32)
            sets = qv.b15_x_sets(f32)
            assert sets == (3 if f32 else 1)
            assert p.nw == -(-m // 8) * 8 and p.qb == qv.B15_QB == 4
            # two consumer warpgroups, or one where the fitted cost at
            # M <= 8 picks it
            assert p.wgs == qv.B15_WARPGROUPS == 2 or (
                p.wgs == 1 and m <= qv.B15_SYNC_MAX_M)
            assert p.bn == (128 if m <= 32 else 64) * p.wgs
            assert 1 <= p.splits <= 8 and p.stages >= 2
            assert p.sync == (m <= qv.B15_SYNC_MAX_M == 8)
            assert 2 <= p.xstages <= p.stages
            # a weight slot: the packed rows, then 4 (2) bytes of scale and
            # variant 9's 4 bytes of min a column a q block
            slot = 64 * p.bn + 4 * p.bn * (8 if mins else 2 if sc16 else 4)
            assert (qv.b15_smem(p.wgs, p.nw, sc16, 1, 0, p.splits, mins,
                                sets)
                    - qv.b15_smem(p.wgs, p.nw, sc16, 0, 0, p.splits, mins,
                                  sets)
                    == -(-slot // 1024) * 1024 + 16)
            # an x slot: x f32 [nw][128], the sets of 8 k16 tiles of nw x 16
            # bf16 and the block sums [4][nw], 128-aligned
            xslot = p.nw * 512 + sets * 8 * p.nw * 32 + 16 * p.nw
            assert (qv.b15_smem(p.wgs, p.nw, sc16, 0, 1, p.splits, mins,
                                sets)
                    - qv.b15_smem(p.wgs, p.nw, sc16, 0, 0, p.splits, mins,
                                  sets)
                    == -(-xslot // 128) * 128 + 24)
            assert qv.b15_smem(p.wgs, p.nw, sc16, p.stages, p.xstages,
                               p.splits, mins, sets) <= qv.B15_SMEM == \
                232448 - 1024
            tiles = -(-n // p.bn)
            nst = -(-nb // 4)
            assert p.clusters <= min(tiles, (cap or (lambda s: 132 // s))(
                p.splits))
            assert p.clusters * p.splits <= 132
            assert p.items == -(-tiles // p.clusters)
            assert (p.splits - 1) * p.sps < nst <= p.splits * p.sps
            # the tiles of each cluster, the q blocks of each rank's run
            walked = np.concatenate([np.arange(c, tiles, p.clusters)
                                     for c in range(p.clusters)])
            runs = np.concatenate([
                np.arange(4 * z * p.sps, min(nb, 4 * (z + 1) * p.sps))
                for z in range(p.splits)])
            assert np.array_equal(np.sort(walked), np.arange(tiles))
            assert np.array_equal(np.sort(runs), np.arange(nb))


@pytest.mark.parametrize("k,n", B15_PLANES)
@pytest.mark.parametrize("sc16", [False, True], ids=["f32", "bf16"])
def test_b15_plan_covers_every_column_tile_and_q_block_once(k, n, sc16):
    """check_b15_plan_covers on the 7B, 13B and tp planes (what
    csrc/q4_fold.cuh's entry points check of a plan)."""
    check_b15_plan_covers(k // 32, n, sc16)


def test_b15_plan_splits_where_the_tiles_leave_sms_idle():
    """The plan's choices on the 7B planes at M = 1 with a capacity as the
    H100's: wo (32 tiles of 128) splits K, w13 at M = 64 fills the card
    with tiles, and a pinned plan is taken as given or refused."""
    wo = qv.b15_plan(1, 4096, 128, 132, False, B15_CAPACITY.get)
    assert wo.splits > 1 and wo.clusters * wo.splits > 66
    big = qv.b15_plan(64, 22016, 128, 132, False, B15_CAPACITY.get)
    assert big.clusters * big.splits >= 100
    pinned = qv.b15_plan(8, 4096, 128, 132, False, None, wgs=1, stages=3,
                         splits=4, clusters=5, sync=True)
    assert (pinned.bn, pinned.stages, pinned.splits, pinned.sps,
            pinned.clusters, pinned.sync) == (128, 3, 4, 8, 5, True)
    with pytest.raises(ValueError):
        qv.b15_plan(64, 4096, 128, 132, wgs=2, stages=12, splits=8)
    with pytest.raises(ValueError):
        qv.b15_plan(65, 4096, 128, 132)


# the clusters of S blocks an H100 holds at once for the fold kernel, as the
# card answered (cudaOccupancyMaxActiveClusters)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


@pytest.mark.parametrize("m", [1, 8])
def test_b15_plan_takes_the_fastest_pinned_plan_at_decode_m(m):
    """At M <= 8 the plan weighs one warpgroup against two and 1-8 splits
    by B15_STAGE_COST and B15_SPLIT_COST: on the 7B planes (stored) with
    the H100's cluster capacity it picks what the card timed fastest among
    the 16 pinned plans of variant 0 (qkv 2 warpgroups and 2 splits, wo 1
    and 3, w13 2 and 4, w2 2 and 6), for q4_0 and q4_1 stages alike; above
    M = 8 the plan keeps two warpgroups."""
    want = {(4096, 12288): (2, 2), (4096, 4096): (1, 3),
            (4096, 22528): (2, 4), (11264, 4096): (2, 6)}
    for (k, n), choice in want.items():
        for mins in (False, True):
            p = qv.b15_plan(m, n, k // 32, 132, False, H100_CLUSTERS.get,
                            mins=mins)
            assert (p.wgs, p.splits) == choice, (k, n, mins)
        assert qv.b15_plan(9, n, k // 32, 132, False,
                           H100_CLUSTERS.get).wgs == qv.B15_WARPGROUPS == 2


def _bf16(a):
    """f32 -> bf16 (round to nearest even) -> f32, in numpy."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        torch.bfloat16).float().numpy()


def _f32(a):
    return np.asarray(a, dtype=np.float64).astype(np.float32)


def b15_smem_image(rows, bn):
    """The bytes of a stage's packed rows [R][bn] as the tensor copies lay
    them out: boxes of 128 columns (64 where bn is not a multiple of 128),
    one after the other, each swizzled (128-byte rows: 16-byte chunk ^ row
    % 8; 64-byte rows: chunk ^ row / 2 % 4)."""
    bw = 64 if bn % 128 else 128
    img = np.zeros(rows.size, dtype=np.uint8)
    for h in range(bn // bw):
        box = img[h * rows.shape[0] * bw:(h + 1) * rows.shape[0] * bw]
        for r in range(rows.shape[0]):
            sw = (r & 7) if bw == 128 else ((r >> 1) & 3)
            for c in range(bw // 16):
                at = r * bw + ((c ^ sw) << 4)
                box[at:at + 16] = rows[r, h * bw + 16 * c:h * bw + 16 * c + 16]
    return img


# the probes B13 and B14 as the kernel's variants 13 and 14 (b15_model)
PROBES = ("floor", "nosc")


def b15_model(x, qs, sc, variant, plan, sc16=False, mins=None):
    """The kernel of B1 and B9 (variants "v0" and "v9"), B15-B18 and the
    probes B13 and B14 (csrc/q4_fold.cuh) as built, in numpy: for
    each column tile and split (the plan's), each K stage of 4 q blocks
    staged as the kernel stages it (the packed rows in swizzled boxes, x as
    bf16 in wgmma's K-major core-matrix layout, zeros past K and N), the x
    warps' block sums (a lane's quads q and q + 4: each float4 summed in
    order, then the two; v7: the four pair sums R(R(x_lo) + R(x_hi)) in
    order; then lanes ^ 1, ^ 2), each consumer lane's A registers (m-tile mt of its 2 MT
    columns c0 + 2 mt, + 1 of packed rows 2t, 2t+1, 2t+8, 2t+9,
    dequantized: v1, v7 and v9 R(f32(q d)), v0 R(f32(q - 8) d) (q - 8
    exact, one f32 product), v3 R(q R(d)), v2 the code q) placed
    by the m16n8k16 A-fragment map into its warpgroup's 64 x 16 tile, B
    read from the x tile through the descriptor's offsets (LBO 128, SBO
    256), the products exact. v1, v3, v7: summed in float64 over the split
    (the tensor cores sum in f32), the fold as an f32 FMA a D register and
    q block in q block order (v9: bsum m, mins f32 [K/32, N]; v0: none),
    acc + fold in f32. v2: each q block's two k16
    steps summed in float64 and rounded to f32 (z), then acc = fma(bsum,
    -8 d, acc) and acc = fma(z, d, acc) in q block order, d the D
    register's column's. Then the D registers stored by the kernel's map,
    and the leader's sum of the splits in split order. sc: f32 scales
    (their bf16 values when sc16). The probes (variant "floor": B13,
    "nosc": B14; sc None) read no scales and keep no fold: "floor" puts
    the whole byte in the A registers and takes one k16 step a q block,
    against x_lo's tile (b, 0); "nosc" the codes (both nibbles, no -8),
    both steps; their products summed as v1's."""
    m, kx = x.shape
    k2, n = qs.shape
    nb = k2 // 16
    probe = variant in PROBES
    if probe:
        sc = np.zeros((nb, n), dtype=np.float32)
    mpad = None
    if variant == "v9":
        mpad = np.zeros((-(-nb // 4) * 4, -(-n // plan.bn) * plan.bn),
                        dtype=np.float32)
        mpad[:nb, :n] = mins
    nw, bn, nst = plan.nw, plan.bn, -(-nb // 4)
    mt_n, wgs, bw = (2 if nw <= 32 else 1), plan.wgs, 64 if bn % 128 else 128
    tiles = -(-n // bn)
    qpad = np.zeros((nst * 64, tiles * bn), dtype=np.uint8)
    qpad[:k2, :n] = qs
    spad = np.zeros((nst * 4, tiles * bn), dtype=np.float32)
    spad[:nb, :n] = _bf16(sc) if sc16 else sc
    xpad = np.zeros((nw, nst * 128), dtype=np.float32)
    xpad[:m, :kx] = x
    # the consumer threads of a warpgroup: warp w, lane (g, t)
    tid = np.arange(128)
    w, g, t = tid // 32, (tid % 32) // 4, tid % 4
    rows4 = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
    y = np.zeros((m, n), dtype=np.float32)
    for tile in range(tiles):
        parts = []
        for z in range(plan.splits):
            # [warpgroup, m-tile] -> D [A row, x row], fold alike; v2's acc
            d_acc = np.zeros((wgs, mt_n, 64, nw))
            fold = np.zeros((wgs, mt_n, 64, nw), dtype=np.float32)
            acc = np.zeros((wgs, mt_n, 64, nw), dtype=np.float32)
            for st in range(z * plan.sps, min(nst, (z + 1) * plan.sps)):
                img = b15_smem_image(
                    qpad[64 * st:64 * st + 64, tile * bn:(tile + 1) * bn], bn)
                scs = spad[4 * st:4 * st + 4, tile * bn:(tile + 1) * bn]
                if mpad is not None:
                    mns = mpad[4 * st:4 * st + 4, tile * bn:(tile + 1) * bn]
                xs = xpad[:, 128 * st:128 * st + 128]
                # the x warps: bf16 tiles in the core-matrix layout, and the
                # block sums (a lane's 4 in order, then lanes ^ 1, ^ 2, ^ 4)
                xt = np.zeros(4 * 2 * nw * 16, dtype=np.float32)
                q4 = xs.reshape(nw, 4, 8, 4)          # [row, block, quad, e]
                if variant == "v7":
                    pair = _bf16(_bf16(q4[:, :, :4]) + _bf16(q4[:, :, 4:]))
                    bsum = (((pair[..., 0] + pair[..., 1]) + pair[..., 2])
                            + pair[..., 3])
                else:
                    quad = ((q4[..., 0] + q4[..., 1])
                            + (q4[..., 2] + q4[..., 3]))
                    bsum = quad[..., :4] + quad[..., 4:]
                while bsum.shape[-1] > 1:
                    bsum = bsum[..., 0::2] + bsum[..., 1::2]
                bsum = bsum[..., 0].T                       # [b][row]
                for b in range(4):
                    for s in range(2):
                        for kk in range(16):
                            for r in range(nw):
                                at = ((2 * b + s) * nw * 32 + (r >> 3) * 256 +
                                      (kk >> 3) * 128 + (r & 7) * 16 +
                                      (kk & 7) * 2) // 2
                                xt[at] = xs[r, 32 * b + 16 * s + kk]
                xt = _bf16(xt)
                for wg in range(wgs):
                    c0 = 64 * mt_n * wg + 16 * mt_n * w + 2 * mt_n * g
                    cb = c0 % bw
                    for b in range(4):
                        slab = img[b * 16 * bw:]
                        for mt in range(mt_n):
                            byte = np.zeros((4, 2, 128), dtype=np.int64)
                            for j, r in enumerate(rows4):
                                sw = (r & 7) if bw == 128 else ((r >> 1) & 3)
                                off = ((c0 // bw) * 64 * bw + r * bw +
                                       (((cb >> 4) ^ sw) << 4) + (cb & 15) +
                                       2 * mt)
                                byte[j, 0] = slab[off]
                                byte[j, 1] = slab[off + 1]
                            d = scs[b, c0 + 2 * mt], scs[b, c0 + 2 * mt + 1]
                            if mpad is not None:
                                mn = (mns[b, c0 + 2 * mt],
                                      mns[b, c0 + 2 * mt + 1])
                            prod = np.zeros((64, nw))
                            for s in range(1 if variant == "floor" else 2):
                                # [row j][column e]; floor: the whole byte
                                code = (byte if variant == "floor"
                                        else (byte >> (4 * s)) & 15)
                                a = np.zeros((64, 16))
                                for j in range(4):
                                    for e in range(2):
                                        q = code[j, e].astype(np.float64)
                                        if variant == "v2" or probe:
                                            v = q
                                        elif variant == "v3":
                                            v = _bf16(q * _bf16(d[e]))
                                        elif variant == "v0":
                                            v = _bf16(_f32((q - 8.0) * d[e]))
                                        else:
                                            v = _bf16(_f32(q * d[e]))
                                        # A row g (+ 8: column + 1), k 2t +
                                        # j % 2 (+ 8: rows 2t+8, 2t+9)
                                        a[16 * w + g + 8 * e,
                                          2 * t + (j & 1) + 8 * (j >> 1)] = v
                                kk, r = np.meshgrid(np.arange(16),
                                                    np.arange(nw),
                                                    indexing="ij")
                                at = ((2 * b + s) * nw * 32 + (r >> 3) * 256 +
                                      (kk >> 3) * 128 + (r & 7) * 16 +
                                      (kk & 7) * 2) // 2
                                prod += a @ xt[at]
                            d_acc[wg, mt] += prod
                            if probe or variant == "v0":
                                continue              # no fold
                            z = _f32(prod)
                            # the fold (v2: into acc, then z d): register
                            # 4j + c, A row g + 8 (c / 2), x row 8j + 2t + c % 2
                            tgt = acc if variant == "v2" else fold
                            for i in range(nw // 2):
                                e = (i >> 1) & 1
                                ra = 16 * w + g + 8 * e
                                xr = 8 * (i >> 2) + 2 * t + (i & 1)
                                p = (_f32(mn[e]) if mpad is not None else
                                     _f32(-8.0 * np.asarray(
                                         d[e], dtype=np.float64)))
                                tgt[wg, mt, ra, xr] = _f32(
                                    bsum[b, xr].astype(np.float64) * p
                                    + tgt[wg, mt, ra, xr])
                                if variant == "v2":
                                    acc[wg, mt, ra, xr] = _f32(
                                        z[ra, xr].astype(np.float64) * d[e]
                                        + acc[wg, mt, ra, xr])
            parts.append(acc if variant == "v2" else _f32(d_acc) + fold)
        tot = parts[0]
        for part in parts[1:]:
            tot = tot + part                       # f32, in split order
        # the D registers stored: A row 16w + g + 8 (i / 2 % 2) of m-tile mt
        # of warpgroup wg -> column c0 + 2 mt + i / 2 % 2
        for wg in range(wgs):
            c0 = 64 * mt_n * wg + 16 * mt_n * w + 2 * mt_n * g
            for mt in range(mt_n):
                for i in range(nw // 2):
                    ra = 16 * w + g + 8 * ((i >> 1) & 1)
                    xr = 8 * (i >> 2) + 2 * t + (i & 1)
                    col = tile * bn + c0 + 2 * mt + ((i >> 1) & 1)
                    ok = (xr < m) & (col < n)
                    y[xr[ok], col[ok]] = tot[wg, mt, ra[ok], xr[ok]]
    return y


@pytest.mark.parametrize("m", [1, 5, 8, 13, 40, 64])
@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v7"])
def test_b15_model_matches_plain_and_the_jax_body(variant, m):
    """The numpy model of the kernel of B15-B18 (b15_model: the fragment
    maps, x's K-major layout, v7's pair sums, v2's product a q block
    scaled into acc, the fold's FMAs and the split order) on a 1088 x 192
    plane (34 q blocks; a ragged last tile) with K 1000 (x past its K is
    zero; the last stage half past the plane), under plans of 1, 2 and 3
    splits (an uneven last split), one and two consumer warpgroups (BN
    128 and 256, or 64 in 64-column boxes and 128 above M = 32), f32 and
    bf16 scales:
    within 1e-5 of sum |R(x)| (q + 8) |d| of decode_plain and of the JAX
    body in interpret mode (the products are exact; only the f32
    summation order differs). v7 at M = 1 feeds the JAX body 8 rows, as
    its dispatcher does (test_decode_plain_matches_the_jax_body)."""
    qs_full, sc_full = planes(1280, 256, seed=40)
    qs, sc = qs_full[:544, :192].copy(), sc_full[:34, :192].copy()
    x = acts(m, 1000, seed=41)
    # the JAX body on the whole stored plane, x zero past its K: the rows
    # and columns past the cut add nothing and are not compared
    want_jax = jax_body(np.pad(x, ((0, 0), (0, 280))), qs_full, sc_full,
                        variant, jnp.bfloat16,
                        m_pad=8 if (variant, m) == ("v7", 1) else 0)[:, :192]
    for sc16, wgs, splits in ((False, 1, 1), (False, 2, 2), (True, 2, 3)):
        tsc = torch.from_numpy(sc)
        if sc16:
            tsc = tsc.to(torch.bfloat16)
        plan = qv.b15_plan(m, 192, 34, 132, sc16, wgs=wgs, splits=splits,
                           clusters=1)
        got = b15_model(x, qs, sc, variant, plan, sc16)
        want = qv.decode_plain(torch.from_numpy(x), torch.from_numpy(qs), tsc,
                               variant).numpy()
        tol = 1e-5 * absum(np.pad(x, ((0, 0), (0, 88))), qs,
                           tsc.float().numpy())
        assert got.shape == want.shape == (m, 192)
        assert np.abs(got - want).max() <= tol, (sc16, wgs, splits)
        if not sc16:
            assert np.abs(got - want_jax).max() <= tol, (wgs, splits)


def q41_planes(k, n, seed):
    """(qs, scales, mins) of a stored q4_1 weight from numpy-seeded data,
    as both packages store them."""
    rng = np.random.default_rng(seed)
    codes, d, mn = quantize_q4_1(
        (rng.standard_normal((n, k)) * 0.1 + 0.02).astype(np.float32))
    wj = jt.make_matmul_weight_q41(codes, d, mn)
    return np.array(wj.qs), np.array(wj.scales), np.array(wj.mins)


# (stored K, stored N, the q blocks and columns cut from it, x's K): a plane
# of 34 q blocks, and the 86 of w2 at tp 4 (K 2752, PLANES_7B_TP): neither
# a multiple of the 4 a stage takes, so the last stage's tensor copies fill
# zeros past the plane (codes 0 and d = 0: v0's weight (0 - 8) 0 = -0)
FOLD_CUTS = [(1280, 256, 34, 192, 1000), (3072, 256, 86, 128, 2752)]


@pytest.mark.parametrize("m", [1, 8, 9, 33, 64])
@pytest.mark.parametrize("variant", ["v0", "v9"])
def test_b15_model_holds_b1_and_b9(variant, m):
    """The numpy model of the fold kernel (b15_model) for variant 0 (B1,
    R(x) @ R((q - 8) d), no fold) and variant 9 (B9, R(x) @ R(q d) + bsum(x)
    @ m, the mins term in the fold's registers) on FOLD_CUTS' planes, with
    one and two consumer warpgroups and 1-3 splits (variant 0 also with
    bf16 scales, v0h): within 1e-5 of sum |R(x)| |W| (B9: plus sum |bsum|
    |m|) of the plain versions (q4_matmul_dequant, decode_plain's v0,
    q41_matmul_decode_plain) and of the JAX bodies in interpret mode
    (q4_matmul_pallas(variant="v0"), q41_matmul_pallas) on the whole stored
    plane, x zero past its K (the rows and columns past the cut add
    nothing and are not compared)."""
    for kp, np_, nb, n, kx in FOLD_CUTS:
        seed = 50 + nb
        x = acts(m, kx, seed=seed + 1)
        xfull = np.pad(x, ((0, 0), (0, kp - kx)))
        if variant == "v0":
            qs_full, sc_full = planes(kp, np_, seed=seed)
            mn = mn_full = None
            want_jax = jax_body(xfull, qs_full, sc_full, "v0",
                                jnp.bfloat16)[:, :n]
        else:
            qs_full, sc_full, mn_full = q41_planes(kp, np_, seed)
            mn = mn_full[:nb, :n].copy()
            want_jax = np.asarray(jqm.q41_matmul_pallas(
                jnp.asarray(xfull), jnp.asarray(qs_full),
                jnp.asarray(sc_full), jnp.asarray(mn_full),
                interpret=True))[:, :n]
        qs, sc = qs_full[:16 * nb, :n].copy(), sc_full[:nb, :n].copy()
        w = tt.QuantMatmulWeight(
            qs=torch.from_numpy(qs), scales=torch.from_numpy(sc),
            mins=None if mn is None else torch.from_numpy(mn))
        xt = torch.from_numpy(x)
        xk = np.pad(x, ((0, 0), (0, 32 * nb - kx)))
        xr = np.abs(_bf16(xk))
        if variant == "v0":
            want = tqm.q4_matmul_dequant(xt, w).numpy()
            scale = (xr @ np.abs(tt.dequant_matmul_weight(
                w, torch.bfloat16).float().numpy())).max()
        else:
            want = tqm.q41_matmul_decode_plain(xt, w).numpy()
            qd = np.abs(_bf16(qv._codes(w.qs).numpy()
                              * np.repeat(sc, 32, axis=0)))
            bsum = np.abs(xk.reshape(m, nb, 32).sum(-1))
            scale = (xr @ qd + bsum @ np.abs(mn)).max()
        tol = 1e-5 * scale
        cases = ((False, 1, 1), (False, 2, 2), (True, 2, 3))
        for sc16, wgs, splits in cases[:3 if variant == "v0" else 2]:
            tsc = torch.from_numpy(sc)
            if sc16:
                tsc = tsc.to(torch.bfloat16)
            plan = qv.b15_plan(m, n, nb, 132, sc16, mins=mn is not None,
                               wgs=wgs, splits=splits, clusters=1)
            got = b15_model(x, qs, sc, variant, plan, sc16, mins=mn)
            assert got.shape == (m, n)
            if sc16:
                want16 = qv.decode_plain(xt, w.qs, tsc, "v0").numpy()
                assert np.abs(got - want16).max() <= tol, (nb, wgs, splits)
                continue
            assert np.abs(got - want).max() <= tol, (nb, wgs, splits)
            assert np.abs(got - want_jax).max() <= tol, (nb, wgs, splits)


@pytest.mark.parametrize("sc16", [False, True], ids=["f32", "bf16"])
def test_b1_weight_in_the_a_registers_is_dequant_matmul_weight(sc16):
    """Variant 0's dequantization as the kernel computes it (the code in the
    mantissa of 2^23, less 2^23 + 8, then one f32 product by d, then
    cvt.rn.bf16x2) is bit-equal, weight by weight, to dequant_matmul_weight
    (and, for bf16 scales, to decode_plain's v0 weight) on a plane holding
    every code, with scales over many binades; v1's one-FMA route with the
    constant -(2^23 + 8) d rounded to f32 is not."""
    rng = np.random.default_rng(60)
    k, n = 256, 512
    codes = rng.integers(0, 16, (k, n)).astype(np.uint8)
    d = (rng.uniform(0.5, 1.0, (k // 32, n))
         * 2.0 ** rng.integers(-20, 4, (k // 32, n))).astype(np.float32)
    if sc16:
        d = _bf16(d)
    qs = tt.pack_codes_split_k(codes)
    w = tt.QuantMatmulWeight(qs=torch.from_numpy(qs),
                             scales=torch.from_numpy(d))
    dr = np.repeat(d, 32, axis=0)
    q8 = (np.float32(8388608.0) + codes.astype(np.float32)) + np.float32(
        -8388616.0)
    mine = _bf16((q8 * dr).astype(np.float32))
    want = tt.dequant_matmul_weight(w, torch.bfloat16).float().numpy()
    assert np.array_equal(q8, codes.astype(np.float32) - 8.0)
    assert np.array_equal(mine.view(np.uint32), want.view(np.uint32))
    one_fma = _bf16(_f32(np.float64(8388608.0 + codes) * dr + _f32(
        -8388616.0 * np.float64(dr))))
    assert not np.array_equal(one_fma, want)


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes a wrapper past its
    CPU branch to its launch, where a spy stands in for the entry point."""
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_v1_to_v7_launch_their_build_of_the_fold_kernel(monkeypatch):
    """Each of v1-v7 launches its own build of csrc/q4_fold.cuh with its
    variant number (v4 and v5 v1's), and v0h (v0 with 2-byte scales) the
    variant 0 build, B1's: the entry points a spy on cuda_lib.fn records,
    each launch counted by its wrapper (v0h by B1's)."""
    called = []

    def fn(name):
        if name == "q4_fold_clusters":
            return lambda s: B15_CAPACITY[s]

        def entry(*args):
            called.append((name, args[8]))
            return 0
        return entry
    monkeypatch.setattr(cuda_lib, "fn", fn)
    monkeypatch.setattr(cuda_lib, "sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_lib, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(qv, "_B15_CLUSTERS", {})
    monkeypatch.setattr(qv, "_B15_PLANS", {})
    qs, sc = planes()
    x, qd, sd = (torch.Tensor._make_subclass(
        _ReportsCuda, torch.from_numpy(a).clone()) for a in (acts(8), qs, sc))
    for variant in ("v1", "v2", "v3", "v4", "v5", "v7"):
        kernel = qv.DECODE_KERNELS[variant]
        before = kernel.launches
        y = qv.q4_matmul_pallas(x, qd, sd, variant=variant)
        assert y.shape == (8, N) and kernel.launches == before + 1
    before = tqm.q4_matmul_decode.launches
    y = qv.q4_matmul_pallas(x, qd, sd.to(torch.bfloat16), variant="v0")
    assert y.shape == (8, N) and tqm.q4_matmul_decode.launches == before + 1
    assert called == [("q4_fold_gemm", 1), ("q4_fold_v2_gemm", 2),
                      ("q4_fold_v3_gemm", 3), ("q4_fold_gemm", 1),
                      ("q4_fold_gemm", 1), ("q4_fold_v7_gemm", 7),
                      ("q4_fold_v0_gemm", 0)]


def test_b20_route_follows_b20_on_b15_max_m():
    """B20 takes B15's kernel (v1's function) at M <= B20_ON_B15_MAX_M and
    its split kernel above it; the split kernel's tiles are 128 rows."""
    lim = qv.B20_ON_B15_MAX_M
    assert 1 <= lim <= qv.B15_MAX_M
    assert [qv.b20_route(m) for m in (1, lim, lim + 1, 512)] == [
        "b15", "b15", "split", "split"]


# -- on the card: each kernel against its plain version ----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 17, 64])
@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v7", "v0h", "v1h",
                                     "v2h", "v3h", "v7h"])
def test_variant_kernels_match_plain(cuda_device, variant, m):
    """B15-B18 (csrc/q4_fold.cuh) and the h forms (v0h: B1 with 2-byte
    scales) on the card at M = 1, 8 (mma.sync), 17 and 64 (wgmma): within
    1e-5 of sum |x| |w| of the plain version and bit-equal across two runs;
    each counts its launch."""
    qs, sc = planes(1024, 512, seed=17)
    x = acts(m, 1024, seed=18)
    base, h = variant.rstrip("h"), variant.endswith("h")
    qd = torch.from_numpy(qs).to(cuda_device)
    sd = torch.from_numpy(sc).to(cuda_device)
    if h:
        sd = sd.to(torch.bfloat16)
    xd = torch.from_numpy(x).to(cuda_device)
    counter = (tqm.q4_matmul_decode if base == "v0"
               else qv.DECODE_KERNELS[base])
    before = counter.launches
    got = qv.q4_matmul_pallas(xd, qd, sd, variant=base)
    assert counter.launches == before + 1
    want = qv.decode_plain(xd, qd, sd, base)
    assert (got - want).abs().max().item() <= 1e-5 * absum(
        x, qs, sd.float().cpu().numpy())
    assert torch.equal(got, qv.q4_matmul_pallas(xd, qd, sd, variant=base))


# B15's kernel under pinned plans: (M, consumer warpgroups, splits, ring
# slots, clusters, mma.sync), every row count NW = 8..64 of its products
# among them; None: the wrapper's own plan
B15_PINNED = [(1, 2, 1, 2, 1, False), (1, 1, 8, 4, None, False),
              (1, 2, 3, 8, 2, True), (1, 1, 2, 6, None, False),
              (5, 1, 2, 6, 3, True), (8, 1, 4, 4, None, False),
              (13, 2, 2, 4, 1, False), (16, 1, 1, 4, None, False),
              (24, 1, 1, 5, None, False), (33, 1, 3, 4, 2, False),
              (40, 2, 1, 4, 3, False), (48, 2, 5, 2, None, False),
              (56, 1, 2, 3, 1, False), (64, 2, 2, 3, None, False),
              (64, 1, 8, 2, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("sc16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v7"])
@pytest.mark.parametrize("pinned", B15_PINNED + [(m, None) for m in
                                                 (1, 7, 8, 9, 16, 33, 64)],
                         ids=str)
def test_b15_kernel_matches_plain_under_every_plan_shape(cuda_device, pinned,
                                                         variant, sc16):
    """The kernel of B15 (v1), B16 (v2), B17 (v3) and B18 (v7) on a
    4096 x 448 plane (a ragged last tile; K 4000, or 3998, which the
    wrapper pads to a multiple of 4 for the tensor copies of x) under
    pinned plans (one and two consumer warpgroups, 1-8 splits, 2-8 ring
    slots, clusters that walk several tiles, mma.sync at M <= 8) and
    under the wrapper's own plan (counted, with n_out 440): within 1e-5 of
    sum |R(x)| (q + 8) |d| of the plain version, bit-equal twice."""
    m = pinned[0]
    qs, sc = planes(4096, 512, seed=42)
    qs, sc = qs[:, :448].copy(), sc[:, :448].copy()
    kx = 3998 if m in (5, 33) else 4000
    x = acts(m, kx, seed=43)
    qd, sd = (torch.from_numpy(a).to(cuda_device) for a in (qs, sc))
    if sc16:
        sd = sd.to(torch.bfloat16)
    xd = torch.from_numpy(x).to(cuda_device)
    kernel = qv.DECODE_KERNELS[variant]
    if pinned[1] is None:
        n_out = 440
        before = kernel.launches
        got = kernel(xd, qd, sd, n_out)
        assert kernel.launches == before + 1
        again = kernel(xd, qd, sd, n_out)
    else:
        _, wgs, splits, stages, clusters, sync = pinned
        n_out = 448
        plan = qv.b15_plan(m, 448, 128, 132, sc16, wgs=wgs, splits=splits,
                           stages=stages, clusters=clusters, sync=sync)
        got = qv._launch_fold(xd, qd, sd, qv.FOLD_VARIANT[variant], n_out,
                              plan)
        again = qv._launch_fold(xd, qd, sd, qv.FOLD_VARIANT[variant], n_out,
                                plan)
    want = qv.decode_plain(xd, qd, sd, variant)[:, :n_out]
    tol = 1e-5 * absum(np.pad(x, ((0, 0), (0, 4096 - kx))), qs,
                       sd.float().cpu().numpy())
    assert got.shape == (m, n_out)
    assert (got - want).abs().max().item() <= tol
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v0", "v0h", "v9"])
@pytest.mark.parametrize("pinned", B15_PINNED + [(m, None) for m in
                                                 (1, 7, 8, 9, 16, 33, 64)],
                         ids=str)
def test_b1_b9_fold_variants_match_plain_under_every_plan_shape(
        cuda_device, pinned, variant):
    """Variants 0 (B1; v0h: bf16 scales) and 9 (B9, with the mins plane)
    of the fold kernel, launched directly, on a 2752 x 448 plane (86 q
    blocks: the last stage's tensor copies fill zeros past K; a ragged
    last tile) with x of K 2750 (padded by the wrapper to 2752), under
    B15_PINNED's plans and the wrapper's own: within 1e-5 of the plain
    version's scale (sum |R(x)| |W|, B9: plus sum |bsum| |m|), bit-equal
    twice."""
    m = pinned[0]
    affine, sc16 = variant == "v9", variant == "v0h"
    if affine:
        qs, sc, mn = q41_planes(3072, 512, seed=44)
    else:
        (qs, sc), mn = planes(3072, 512, seed=44), None
    qs, sc = qs[:1376, :448].copy(), sc[:86, :448].copy()
    x = torch.from_numpy(acts(m, 2750, seed=45)).to(cuda_device)
    w = tt.QuantMatmulWeight(
        qs=torch.from_numpy(qs).to(cuda_device),
        scales=torch.from_numpy(sc).to(cuda_device),
        mins=None if mn is None else torch.from_numpy(
            mn[:86, :448].copy()).to(cuda_device))
    sd = w.scales.to(torch.bfloat16) if sc16 else w.scales
    plan = None
    if pinned[1] is not None:
        _, wgs, splits, stages, clusters, sync = pinned
        plan = qv.b15_plan(m, 448, 86, 132, sc16, mins=affine, wgs=wgs,
                           splits=splits, stages=stages, clusters=clusters,
                           sync=sync)
    runs = [qv._launch_fold(x, w.qs, sd, 9 if affine else 0, 448, plan,
                            mins=w.mins) for _ in range(2)]
    if affine:
        want = tqm.q41_matmul_decode_plain(x, w)
        tol = b9_scale(x, w)
    else:
        want = qv.decode_plain(x, w.qs, sd, "v0")
        wd = qv.decode_plain(torch.eye(2752, device=cuda_device), w.qs,
                             sd, "v0")
        tol = 1e-5 * (tqm._pad_k(x, 2752).to(torch.bfloat16).float().abs()
                      @ wd.abs()).max().item()
    assert runs[0].shape == (m, 448)
    assert (runs[0] - want).abs().max().item() <= tol
    assert torch.equal(runs[0], runs[1])


def b9_scale(x, w):
    """1e-5 of B9's two terms' scale: sum |R(x)| |R(q d)| + sum |bsum| |m|."""
    qd = (qv._codes(w.qs) * w.scales.repeat_interleave(32, dim=0)).to(
        torch.bfloat16).float().abs()
    xk = tqm._pad_k(x, w.k)
    bsum = xk.reshape(x.shape[0], -1, 32).sum(-1).abs()
    return 1e-5 * (xk.to(torch.bfloat16).float().abs() @ qd
                   + bsum @ w.mins.abs()).max().item()


# every cluster shape of B19 (1, 2 and 4 blocks of 128 rows) with its edges
EDGE_ROWS = [1, 63, 65, 127, 129, 255, 257, 511, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("m", EDGE_ROWS)
def test_b19_kernel_bit_exact(cuda_device, m):
    """B19 (B2, then one cluster launch) bit for bit against its plain
    version at every cluster size and ragged M; each call counts one."""
    qs, sc = planes(1024, 512, seed=19)
    x = torch.from_numpy(acts(m, 1024, seed=20, scale=3.0)).to(cuda_device)
    qd, sd = (torch.from_numpy(a).to(cuda_device) for a in (qs, sc))
    before = qv.q4_prefill_int8_natx.launches
    got = qv.q4_prefill_int8_natx(x, qd, sd)
    assert qv.q4_prefill_int8_natx.launches == before + 1
    assert torch.equal(got, qv.q4_prefill_int8_natx_plain(x, qd, sd))
    assert torch.equal(got, qv.q4_prefill_int8_natx(x, qd, sd))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 129, 512])
def test_b19_kernel_divides_at_ragged_n(cuda_device, m):
    """B19 on reciprocal_traps' plane (N 400, a ragged last column tile;
    scales whose d / s8 and d (1 / s8) requantize apart): bit-equal to its
    plain version, which a reciprocal would not be."""
    qs, sc = reciprocal_traps()
    x = torch.from_numpy(acts(m, 1024, seed=34, scale=2.0)).to(cuda_device)
    qd, sd = (torch.from_numpy(a).to(cuda_device) for a in (qs, sc))
    got = qv.q4_prefill_int8_natx(x, qd, sd)
    assert torch.equal(got, qv.q4_prefill_int8_natx_plain(x, qd, sd))
    assert not torch.equal(got, natx_by_reciprocal(x, qd, sd))


@pytest.mark.cuda
@pytest.mark.parametrize("m", EDGE_ROWS)
@pytest.mark.parametrize("k", [4096, 11008])
def test_b20_kernel_matches_plain(cuda_device, m, k):
    """B20 on the card (the cast pass and B5's kernel in its split mode,
    the fold on the tensor cores; B15's kernel at M = 1) against its plain
    version at 1e-4 of max |y| in bf16 (at N 512 every plan splits K 8
    ways: the fold is added once), and in f32 mode (B5's f32
    kernel, counted as B5) at 1e-5; bit-equal twice, each launch counted
    as B20's."""
    qs, sc = planes(k, 512, seed=28)
    x = torch.from_numpy(acts(m, k, seed=29)).to(cuda_device)
    qd, sd = (torch.from_numpy(a).to(cuda_device) for a in (qs, sc))
    before = (qv.q4_prefill_split.launches, tqm.q4_matmul_prefill.launches)
    got = qv.q4_matmul_prefill_pallas(x, qd, sd, variant="split")
    assert (qv.q4_prefill_split.launches,
            tqm.q4_matmul_prefill.launches) == (before[0] + 1, before[1])
    want = qv.q4_prefill_split_plain(x, qd, sd)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.equal(got, qv.q4_matmul_prefill_pallas(x, qd, sd,
                                                        variant="split"))
    got32 = qv.q4_matmul_prefill_pallas(x, qd, sd, variant="split",
                                        w_dtype=torch.float32)
    assert tqm.q4_matmul_prefill.launches == before[1] + 1
    want32 = qv.q4_prefill_split_plain(x, qd, sd, torch.float32)
    assert (got32 - want32).abs().max().item() <= (
        1e-5 * want32.abs().max().item())


@pytest.mark.cuda
def test_use_pallas_routes_on_the_card(cuda_device):
    """use_pallas=False: B1 at decode M, B5 at prefill M and no B3;
    use_pallas=True: B15 at decode M."""
    qs, sc = planes(1024, 512, seed=21)
    w = tt.QuantMatmulWeight(qs=torch.from_numpy(qs).to(cuda_device),
                             scales=torch.from_numpy(sc).to(cuda_device))
    kernels = (tqm.q4_matmul_decode, tqm.q4_matmul_prefill,
               tqm.q4_matmul_prefill_int8, qv.q4_decode_v1)
    for m, use_pallas, want in ((8, False, 0), (256, False, 1),
                                (8, True, 3)):
        before = [k.launches for k in kernels]
        tqm.q4_matmul(torch.randn((m, 1024), device=cuda_device), w,
                      use_pallas=use_pallas)
        after = [k.launches for k in kernels]
        assert [b - a for a, b in zip(before, after)] == [
            int(i == want) for i in range(4)]
