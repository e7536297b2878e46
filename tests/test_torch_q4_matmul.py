"""PyTorch port: the q4_0 matmuls (B1-B3 and B5 plain versions, the
dispatcher, and a numpy model of B3's and B5's register-A kernel) against
the JAX package's kernels (Pallas interpret mode) and XLA paths. The affine
kernel B9 is in test_torch_q41.py."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fastllama_tpu.kernels import q4_matmul as jqm
from fastllama_tpu.quant import tensor as jt
from fastllama_tpu.quant.q4 import quantize_q4_0, quantize_q4_1
from fastllama_tpu_torch.kernels import q4_matmul as tqm
from fastllama_tpu_torch.kernels import q4_variants as tqv
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


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (256, 352, 96),
                                   (256, 13824, 64)])     # 13B w2's K
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


# (M, K_logical, N_logical): K and N padding both exercised at the last
@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (264, 352, 96)])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_b5_plain_matches_pallas(m, k, n, mode):
    """B5's plain version (q4_matmul_dequant) against the natural-order
    prefill kernel in interpret mode, fed as the JAX dispatch feeds it: x
    zero-padded to the stored K and cast to w_dtype. Both round x and
    (q - 8) * d to w_dtype and accumulate in f32, so they agree to f32
    reassociation (1e-5 of the max) in both modes."""
    wt, wj = weights(k, n, seed=10)
    x = acts(m, k, seed=11)
    jdt, tdt = getattr(jnp, mode), getattr(torch, mode)
    got = tqm.q4_matmul_prefill(torch.from_numpy(x), wt, tdt).numpy()
    assert got.shape == (m, n)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, wj.k - k))).astype(jdt)
    want = jqm.q4_matmul_prefill_pallas(xp, wj.qs, wj.scales, interpret=True,
                                        w_dtype=jdt)
    assert_close(got, np.asarray(want)[:, :n], 1e-5)


def _q41_weights(k, n):
    """A q4_1 weight quantized from data for both packages (the port's and
    the JAX package's planes, stored N padded to 256)."""
    rng = np.random.default_rng(31)
    codes, d, mn = quantize_q4_1(
        (rng.standard_normal((n, k)) * 0.2 + 0.1).astype(np.float32))
    return (tt.make_matmul_weight_q41(codes, d, mn, device="cpu"),
            jt.make_matmul_weight_q41(codes, d, mn), (codes, d, mn))


def q41_weight(k, n):
    rng = np.random.default_rng(12)
    return tt.make_matmul_weight_q41(
        rng.integers(0, 16, (n, k), dtype=np.uint8),
        rng.uniform(0.01, 0.1, (n, k // 32)).astype(np.float32),
        rng.uniform(-0.5, 0.5, (n, k // 32)).astype(np.float32), device="cpu")


@pytest.mark.parametrize("affine,m,mode,int8,path", [
    (False, 1, "bfloat16", None, "B1"),
    (False, 32, "float32", None, "B1"),
    (False, 64, "float32", None, "B1"),     # B1's wrapper sends it to B5
    (False, 65, "bfloat16", None, "B5"),
    (False, 255, "bfloat16", True, "B5"),
    (False, 256, "bfloat16", None, "B3"),
    (False, 256, "bfloat16", True, "B3"),
    (False, 512, "float32", True, "B3"),
    (False, 256, "bfloat16", False, "B5"),
    (False, 256, "float32", None, "B5"),
    (False, 4096, "bfloat16", False, "B5"),
    (True, 1, "bfloat16", None, "B9"),
    (True, 8, "float32", None, "B9"),
    (True, 64, "float32", None, "B9"),      # B9's wrapper sends it to B5
    (True, 65, "bfloat16", None, "B5"),
    (True, 256, "bfloat16", None, "B5"),
    (True, 512, "float32", True, "B5"),
])
def test_dispatch_table(monkeypatch, affine, m, mode, int8, path):
    called = []
    for name, tag in (("q4_matmul_decode", "B1"),
                      ("q4_matmul_dequant", "dequant"),
                      ("q4_matmul_prefill_int8", "B3"),
                      ("q4_matmul_prefill", "B5"),
                      ("q41_matmul_decode", "B9")):
        orig = getattr(tqm, name)
        monkeypatch.setattr(tqm, name, lambda *a, _o=orig, _t=tag, **kw:
                            called.append(_t) or _o(*a, **kw))
    wt = q41_weight(64, 32) if affine else weights(64, 32)[0]
    y = tqm.q4_matmul(torch.zeros((1, m, 64)), wt,
                      w_dtype=getattr(torch, mode), prefill_int8=int8)
    assert y.shape == (1, m, 32)
    assert called[0] == path          # (a CPU path then runs its plain)


def test_kernels_refuse_the_other_weight_kind():
    """B1 takes q4_0 weights, B9 affine ones; each raises on the other kind
    instead of computing with the wrong formula. B5 takes both and computes
    each kind's own function (q4_matmul_dequant's)."""
    x = torch.from_numpy(acts(3, 64))
    with pytest.raises(ValueError, match="q4_0"):
        tqm.q4_matmul_decode(x, q41_weight(64, 32))
    with pytest.raises(ValueError, match="affine"):
        tqm.q41_matmul_decode(x, weights(64, 32)[0])
    for w in (q41_weight(64, 32), weights(64, 32)[0]):
        np.testing.assert_array_equal(
            tqm.q4_matmul_prefill(x, w).numpy(),
            tqm.q4_matmul_dequant(x, w).numpy())


@pytest.mark.parametrize("m,int8", [(100, False), (256, True), (256, False)])
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
                             n_logical=wt.n_logical)
    x = torch.from_numpy(acts(m, 352)).to(cuda_device)
    got = tqm.q4_matmul_decode(x, w, getattr(torch, mode))
    want = tqm.q4_matmul_dequant(x, w, getattr(torch, mode))
    assert_close(got.cpu().numpy(), want.cpu().numpy(), 1e-5)


@pytest.mark.cuda
def test_b2_b3_kernels_bit_exact(cuda_device):
    wt, _ = weights(352, 96, seed=9)
    w = tt.QuantMatmulWeight(wt.qs.to(cuda_device), wt.scales.to(cuda_device),
                             n_logical=wt.n_logical)
    x = torch.from_numpy(acts(256, 352, scale=3.0)).to(cuda_device)
    xq, dx = tqm.quant_rows_int8(x, w.k)
    xq0, dx0 = tqm.quant_rows_int8_plain(x, w.k)
    assert torch.equal(xq, xq0) and torch.equal(dx, dx0)
    assert torch.equal(tqm.q4_matmul_prefill_int8(xq, dx, w),
                       tqm.q4_matmul_prefill_int8_plain(xq, dx, w))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 200, 256])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_b5_kernel_matches_plain(cuda_device, m, mode):
    wt, _ = weights(352, 96, seed=13)
    w = tt.QuantMatmulWeight(wt.qs.to(cuda_device), wt.scales.to(cuda_device),
                             n_logical=wt.n_logical)
    x = torch.from_numpy(acts(m, 352)).to(cuda_device)
    got = tqm.q4_matmul_prefill(x, w, getattr(torch, mode))
    want = tqm.q4_matmul_dequant(x, w, getattr(torch, mode))
    assert_close(got.cpu().numpy(), want.cpu().numpy(), 1e-5)


# -- B1 in bf16 mode: variant 0 of the fold kernel --------------------------

from test_torch_q4_variants import (  # noqa: E402
    _ReportsCuda, check_b15_plan_covers)

# (K, N) stored planes at 7B widths: qkv, wo, w13, w2, head; at 13B: qkv,
# wo, w13, w2
PLANES_7B = [(4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096),
             (4096, 32768)]
PLANES_13B = [(5120, 15360), (5120, 5120), (5120, 27648), (13824, 5120)]
# the 7B planes a rank holds under tensor parallelism (parallel/sharding.py:
# K padding stripped before the split, N re-padded per shard), tp = 2 then
# tp = 4: qkv, wo, w13, w2, head
PLANES_7B_TP = [(4096, 6144), (2048, 4096), (4096, 11264), (5504, 4096),
                (4096, 16384),
                (4096, 3072), (1024, 4096), (4096, 5632), (2752, 4096),
                (4096, 8192)]


@pytest.mark.parametrize("k,n", PLANES_7B + PLANES_13B + PLANES_7B_TP)
@pytest.mark.parametrize("sc16", [False, True], ids=["f32", "v0h"])
def test_b1_fold_plan_covers_every_column_tile_and_q_block_once(k, n, sc16):
    """B1's plan in bf16 mode (variant 0 of the fold kernel, b15_plan; v0h:
    bf16 scales) on every stored 7B and 13B plane and the 7B planes a rank
    holds at tp 2 and 4 (w2 at tp 4: 86 q blocks, not a multiple of a
    stage's 4), for M = 1..64: the clusters' column tiles and the splits'
    q blocks cover the plane exactly once, within the shared memory a block
    gets (check_b15_plan_covers)."""
    check_b15_plan_covers(k // 32, n, sc16)


def reports_cuda(t):
    """t as a CPU tensor that reports a CUDA device (test_torch_q4_variants
    ._ReportsCuda): a wrapper takes it past its CPU branch."""
    return torch.Tensor._make_subclass(_ReportsCuda, t.clone())


# the rows of each route test: the fold kernel's product widths, and both
# sides of B1_ON_B5_MIN_M, B1_ON_B5_SQUARE_MIN_M and F32_ON_B5_DEEP_MIN_M
ROUTE_ROWS = (1, 8, 9, 23, 24, 32, 33, 47, 48, 56, 57, 64)


@pytest.mark.parametrize("affine", [False, True], ids=["q4_0", "q4_1"])
@pytest.mark.parametrize("mode", ["bfloat16", "float32"])
@pytest.mark.parametrize("use_pallas", [None, False, True])
def test_decode_rows_launch_the_fold_variants(monkeypatch, use_pallas, mode,
                                              affine):
    """q4_matmul at M <= 64, by spies on the launchers: in bf16 mode q4_0
    runs variant 0 of the fold kernel (B1; B5, the same function, at M >=
    B1_ON_B5_MIN_M, on a plane of stored K = N at M >=
    B1_ON_B5_SQUARE_MIN_M; use_pallas=True B15, variant 1) and q4_1
    variant 9 (B9; use_pallas=False B5 at every M, as before);
    f32 mode runs the fold kernel's f32 variants, 10 (B1) and 11 (B9),
    and B5's f32 mode at F32_ON_B5_MIN_M rows and more (on a plane of
    stored K > N from F32_ON_B5_DEEP_MIN_M; q4_1 with use_pallas=False:
    B5 at every M). Each launch is counted by the wrapper the dispatcher
    called."""
    launched = []

    def fold(x, qs, scales, variant, n_out, plan=None, mins=None):
        assert (mins is not None) == (variant in (9, 11))
        launched.append(("fold", variant))
        return torch.zeros((x.shape[0], n_out))

    def b5(x, w, w_dtype, plan=None):
        launched.append(("B5", w.mins is not None))
        return torch.zeros((x.shape[0], w.n_logical))
    monkeypatch.setattr(tqv, "_launch_fold", fold)
    monkeypatch.setattr(tqm, "_launch_b5", b5)
    counters = (tqm.q4_matmul_decode, tqm.q41_matmul_decode,
                tqm.q4_matmul_prefill, tqv.q4_decode_v1)
    bf16 = mode == "bfloat16"
    # a plane wider than deep, one deeper than wide (stored K 1024 > N) and
    # a square one
    for k, n in ((256, 512), (1024, 256), (256, 256)):
        wt = (q41_weight(k, n) if affine else weights(k, n)[0])
        w = tt.QuantMatmulWeight(
            qs=reports_cuda(wt.qs), scales=reports_cuda(wt.scales),
            mins=None if wt.mins is None else reports_cuda(wt.mins),
            n_logical=wt.n_logical)
        square = 2 * w.qs.shape[0] == w.qs.shape[1]
        first_b5 = (tqm.B1_ON_B5_SQUARE_MIN_M if square
                    else tqm.B1_ON_B5_MIN_M)
        first_f32_b5 = (tqm.F32_ON_B5_DEEP_MIN_M
                        if 2 * w.qs.shape[0] > w.qs.shape[1]
                        else tqm.F32_ON_B5_MIN_M)
        for m in ROUTE_ROWS:
            launched.clear()
            before = [c.launches for c in counters]
            y = tqm.q4_matmul(reports_cuda(torch.zeros((1, m, k))), w,
                              w_dtype=getattr(torch, mode),
                              use_pallas=use_pallas)
            assert y.shape == (1, m, n)
            if affine and use_pallas is False:
                want, counter = ("B5", True), 2
            elif not bf16 and m >= first_f32_b5:
                want, counter = ("B5", affine), 2
            elif not bf16:
                want, counter = ("fold", 11 if affine else 10), int(affine)
            elif affine:
                want, counter = ("fold", 9), 1
            elif use_pallas:
                want, counter = ("fold", 1), 3
            elif m >= first_b5:
                want, counter = ("B5", False), 2
            else:
                want, counter = ("fold", 0), 0
            assert launched == [want], (k, n, m)
            assert [c.launches - b for c, b in zip(counters, before)] == [
                int(i == counter) for i in range(4)], (k, n, m)
    assert (tqm.B1_ON_B5_MIN_M, tqm.B1_ON_B5_SQUARE_MIN_M,
            tqm.F32_ON_B5_MIN_M, tqm.F32_ON_B5_DEEP_MIN_M,
            tqm.DECODE_MAX_M) == (33, 48, 33, 24, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 40, 64])
def test_b1_mma_kernel_matches_plain_at_every_tile(cuda_device, m):
    """B1 in bf16 mode (variant 0 of the fold kernel, wgmma or mma.sync) at
    each product width NW = 8..64 and a partial last one; the planes' N =
    256 stored columns with 96 logical, 11 q blocks (the last stage's
    tensor copies fill zeros past K)."""
    wt, _ = weights(352, 96, seed=16)
    w = tt.QuantMatmulWeight(wt.qs.to(cuda_device), wt.scales.to(cuda_device),
                             n_logical=wt.n_logical)
    x = torch.from_numpy(acts(m, 352, seed=17)).to(cuda_device)
    got = tqm.q4_matmul_decode(x, w, torch.bfloat16)
    want = tqm.q4_matmul_dequant(x, w, torch.bfloat16)
    assert_close(got.cpu().numpy(), want.cpu().numpy(), 1e-5)
    assert torch.equal(got, tqm.q4_matmul_decode(x, w, torch.bfloat16))


# -- B3 and B5 (bf16 mode): the register-A kernel ---------------------------
#
# csrc/q4_prefill_ra.cuh in numpy: the tensor copies' swizzles, the lanes'
# loads of the packed rows, the weight made in the A registers and wgmma's
# A fragment map, the x tile read as wgmma's K-major B operand, the D
# fragment, the splits' merge in split order and the epilogue.

def sw128(row, byte):
    """Byte offset of (row, byte) in a K-major tile of 128-byte rows as TMA
    writes it with the 128-byte swizzle (tile base 1024-aligned): the
    16-byte chunk index XOR the row within its 8-row group."""
    return row * 128 + (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15)


def tma_swizzle(addr, row_bytes):
    """The hardware's swizzle of a box of `row_bytes`-wide rows (128: the
    128-byte mode, address bits 4-6 XOR bits 7-9; 64: the 64-byte mode,
    bits 4-5 XOR bits 7-8) at a 1024-aligned base."""
    mask = 7 if row_bytes == 128 else 3
    return addr ^ (((addr >> 7) & mask) << 4)


def wgmma_read(start, row, kbyte):
    """The byte wgmma reads for (row, kbyte) of a K-major operand whose
    128-byte-swizzle descriptor starts at `start` (the tile base plus the k
    step's byte offset; 8-row groups 1024 bytes apart): the plain address,
    then the swizzle the hardware applies (address bits 4-6 XOR bits 7-9)."""
    addr = start + (row // 8) * 1024 + (row % 8) * 128 + kbyte
    return addr ^ (((addr >> 7) & 7) << 4)


def d_fragment(i, t):
    """(row, column) of accumulator register i of thread t of a warpgroup in
    wgmma's m64nN D fragment."""
    return (16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2),
            8 * (i // 4) + 2 * (t % 4) + i % 2)


def ra_lanes(wgs):
    """Per consumer thread (wg, w, g, t4) and c0 = 64 wg + 16 w + 2 g, the
    first of the lane's two weight columns."""
    t = np.arange(128 * wgs)
    wg, w, lane = t // 128, (t // 32) % 4, t % 32
    g, t4 = lane // 4, lane % 4
    return wg, w, g, t4, 64 * wg + 16 * w + 2 * g


def ra_rows(int8, t4):
    """The q block's packed rows of a lane's four loads: B3 4t .. 4t + 3
    (k 4t.. of the low, 16 + 4t.. of the high nibbles), B5 2t, 2t + 1,
    2t + 8, 2t + 9 (k 2t, 2t + 1, 2t + 8, 2t + 9 of either k16 step)."""
    j = np.arange(4)
    if int8:
        return 4 * t4[:, None] + j
    return 2 * t4[:, None] + (j & 1) + 8 * (j >> 1)


def ra_roff(int8, cols, t4, c0):
    """The kernel's byte offsets of the lanes' 2-byte loads in a q block's
    16 rows (q4_prefill_ra.cuh body_rs roff)."""
    r = ra_rows(int8, t4)
    sw = (r & 7) if cols == 128 else ((r >> 1) & 3)
    c0 = c0[:, None]
    return r * cols + (((c0 >> 4) ^ sw) << 4) + (c0 & 15)


def f32(v):
    return np.asarray(v, np.float32)


def to_bf16(v):
    return torch.from_numpy(f32(v)).to(torch.bfloat16).float().numpy()


def magic(q):
    """2^23 + q as the f32 the byte permute makes (exact)."""
    return (np.uint32(0x4B000000) | q.astype(np.uint32)).view(np.float32)


def ra_weights(mode, q, d, mn):
    """The lane's weights from codes q (0..15) and its column's d (and m):
    bf16 R((q - 8) d) or R(q d + m), int8 rne((q - 8) d) as the int8 byte
    (d = the scale times 1 / s8), every operation one f32 rounding."""
    if mode == "int8":
        v = f32(magic(q) - np.float32(8388616.0))
        low = (f32(f32(v * d) + np.float32(12582912.0)).view(np.uint32)
               & 0xFF).astype(np.uint8)
        return low.view(np.int8).astype(np.int64)
    if mode == "q4_1":
        return to_bf16(f32(f32(f32(magic(q) - np.float32(8388608.0)) * d)
                           + mn))
    return to_bf16(f32(f32(magic(q) - np.float32(8388616.0)) * d))


def ra_a_tile(mode, qbuf, sbuf, b, cols, inv=None):
    """q block b of a stage as the consumers put it into wgmma's A
    registers, assembled through the A fragment map into A [64 wgs rows,
    32 k] (A row 16 w + g (+ 8) of warpgroup wg: weight column c0 (+ 1);
    bf16: regs 0-3 the low nibbles' k16 step, 4-7 the high ones', reg 0
    (g, k 2t, 2t + 1), 1 (g + 8, ...), 2 (g, k 2t + 8, 2t + 9), 3 (g + 8,
    ...); int8: one k32 step, reg 0 (g, k 4t .. 4t + 3), 1 (g + 8, ...),
    2 (g, k 16 + 4t ..), 3 (g + 8, ...)). qbuf: the stage's packed rows as
    the tensor copy swizzled them; sbuf: its scale rows [qb][cols] (and
    mins rows after them); inv: int8's 1 / s8 by column."""
    int8 = mode == "int8"
    wgs = cols // 64
    wg, w, g, t4, c0 = ra_lanes(wgs)
    off = b * 16 * cols + ra_roff(int8, cols, t4, c0)
    lo, hi = qbuf[off], qbuf[off + 1]          # columns c0, c0 + 1
    d = [sbuf[b, c0], sbuf[b, c0 + 1]]
    mn = ([sbuf[sbuf.shape[0] // 2 + b, c0], sbuf[sbuf.shape[0] // 2 + b,
                                                  c0 + 1]]
          if mode == "q4_1" else [np.zeros(len(c0), np.float32)] * 2)
    if int8:
        d = [f32(d[0] * inv[c0]), f32(d[1] * inv[c0 + 1])]
    a = np.zeros((64 * wgs, 32), np.float64)
    rows = [64 * wg + 16 * w + g, 64 * wg + 16 * w + g + 8]
    for half, byte in enumerate((lo, hi)):     # column c0, c0 + 1
        for nib in range(2):
            q = (byte >> (4 * nib)) & 15        # [threads, 4 rows]
            v = ra_weights(mode, q, d[half][:, None], mn[half][:, None])
            for j in range(4):
                if int8:        # k 4t + j, + 16 for the high nibbles
                    k = 16 * nib + 4 * t4 + j
                else:           # rows 2t, 2t+1, 2t+8, 2t+9 -> k of step nib
                    k = 16 * nib + 2 * t4 + (j & 1) + 8 * (j >> 1)
                a[rows[half], k] = v[:, j]
    return a


def ra_stage_box(plane, r0, rows, c0, cols, swizzle_bytes=None):
    """A TMA box [rows, cols] of `plane` at (r0, c0) with zeros past its
    edges, as a flat buffer (swizzled: swizzle_bytes the row's bytes)."""
    box = np.zeros((rows, cols), plane.dtype)
    part = plane[r0:r0 + rows, c0:c0 + cols]
    box[:part.shape[0], :part.shape[1]] = part
    if swizzle_bytes is None:
        return box
    flat = np.zeros(rows * cols, plane.dtype)
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    flat[tma_swizzle(rr * cols + cc, swizzle_bytes)] = box
    return flat


def ra_model(mode, x, w, plan, dx=None):
    """y [M, n_logical] of the register-A kernel on `plan` (q4_matmul.RaPlan):
    mode "q4_0" / "q4_1" (B5, x f32 [M, Kx]) or "int8" (B3, x the int8
    [M, K] plane, dx its row scales). Work items in the kernel's order
    (ra_items: the tiles before t0 whole, then the rest a split at a time;
    row tile fastest, then column tile), a split tile's partial D kept and
    its splits summed in split order, then the epilogue through the D
    fragment."""
    int8 = mode == "int8"
    qs = w.qs.numpy()
    sc = w.scales.numpy()
    kh, n = qs.shape
    k = 2 * kh
    m = x.shape[0]
    cols, bx = 64 * plan.wgs, plan.bx
    qb = 4 if int8 else 2
    if int8:
        kc = k
        # s8 prologue: lane t4 of a column pair takes q blocks t4, t4 + 4,
        # ...; then the four lanes' maxima (exact in any order)
        mx = np.max(np.stack([np.abs(sc[t::4]).max(0) if t < sc.shape[0]
                              else np.zeros(n, np.float32)
                              for t in range(4)]), 0)
        s8 = np.maximum(f32(mx * np.float32(8.0 / 127.0)),
                        np.float32(1e-20))
        inv = f32(np.float32(1.0) / s8)
        xbytes = x.astype(np.int8).view(np.uint8)
    else:
        kx = x.shape[1]
        kc = -(-kx // 32) * 32
        xb = torch.from_numpy(np.pad(x, ((0, 0), (0, k - kx)))).to(
            torch.bfloat16)
        xbytes = xb.view(torch.int16).numpy().view(np.uint8).reshape(m, 2 * k)
        inv = s8 = None
    planes = [sc] + ([w.mins.numpy()] if mode == "q4_1" else [])
    nst = -(-kc // (32 * qb))
    rt, ct = -(-m // bx), -(-n // cols)
    tiles = rt * ct
    assert plan.splits == -(-nst // plan.per)
    split_from = plan.t0 if plan.splits > 1 else tiles
    y = np.zeros((m, w.n_logical), np.float32)
    # the D fragment: register i of consumer thread tid holds A row (weight
    # column) and N (x row) of d_fragment; the epilogue's own map, register
    # 4j + 2h + c of lane (w, g, t) is x row 8j + 2t + c, column c0 + h,
    # must say the same
    wg, wq, g, t4, c0 = ra_lanes(plan.wgs)
    ireg = np.arange(bx // 2)[None, :]
    j, half, c = ireg // 4, (ireg >> 1) & 1, ireg & 1
    xrow = 8 * j + 2 * t4[:, None] + c
    col = c0[:, None] + half
    frr, fcc = d_fragment(ireg, (np.arange(128 * plan.wgs) % 128)[:, None])
    assert (frr == 16 * wq[:, None] + g[:, None] + 8 * half).all()
    assert (fcc == xrow).all()
    parts = {}
    for tile, z in tqm.ra_items(tiles, plan):
        m0, n0 = (tile % rt) * bx, (tile // rt) * cols
        split = tile >= split_from
        stages = (range(z * plan.per, min(nst, (z + 1) * plan.per)) if split
                  else range(nst))
        acc = np.zeros((64 * plan.wgs, bx), np.int64 if int8 else np.float32)
        for st in stages:
            xbuf = ra_stage_box(xbytes, m0, bx, st * 128, 128, 128)
            qbuf = ra_stage_box(qs, st * qb * 16, qb * 16, n0, cols, cols)
            sbuf = np.concatenate([ra_stage_box(p, st * qb, qb, n0, cols)
                                   for p in planes])
            rr = np.arange(bx)[:, None]
            for b in range(qb):
                a = ra_a_tile(mode, qbuf, sbuf, b, cols, None if inv is None
                              else np.pad(inv, (0, cols))[n0:n0 + cols])
                if int8:        # one k32 step: 32 bytes of each x row
                    kk = np.arange(32)[None, :]
                    bt = xbuf[wgmma_read(32 * b, rr, kk)].view(np.int8)
                    acc += a.astype(np.int64) @ bt.astype(np.int64).T
                    continue
                for s in range(2):  # a k16 step: 32 bytes of each x row
                    kk = 2 * np.arange(16)[None, :]
                    start = 32 * (2 * b + s)
                    lo = xbuf[wgmma_read(start, rr, kk)].astype(np.uint16)
                    hi = xbuf[wgmma_read(start, rr, kk + 1)].astype(np.uint16)
                    bt = torch.from_numpy((lo | (hi << 8)).view(np.int16)) \
                        .view(torch.bfloat16).float().numpy()
                    acc = f32(acc + f32(a[:, 16 * s:16 * s + 16]) @ bt.T)
        parts[(tile, z)] = acc[64 * wg[:, None] + frr, fcc]   # [tid, reg]
        if split and sum(p[0] == tile for p in parts) < plan.splits:
            continue
        total = parts[(tile, 0)]
        for zz in range(1, plan.splits if split else 1):   # in split order
            total = total + parts[(tile, zz)]
        mm, nn = m0 + xrow, n0 + col
        ok = (mm < m) & (nn < w.n_logical)
        v = total[ok]
        if int8:
            v = f32(f32(v.astype(np.float32) * dx[mm[ok]]) * s8[nn[ok]])
        y[mm[ok], nn[ok]] = v
    return y


def test_b3_swizzle_maps_are_bijections_and_wgmma_reads_the_k_slice():
    """TMA's 128-byte swizzle places a 256-row x tile bijectively; wgmma,
    with the descriptor's start advanced by 32 bytes a k step (a k16 step of
    bf16 or a k32 step of int8), reads exactly the logical (row, k) byte for
    every row of a BX-row B operand; the 128- and 64-byte swizzles of the
    packed rows' boxes are bijections, the lanes' offsets of their two
    bytes (ra_roff, both modes) are where the copy put columns c0 and c0 + 1
    of their rows, for one and two warpgroups."""
    rr, bb = np.meshgrid(np.arange(256), np.arange(128), indexing="ij")
    assert sorted(sw128(rr, bb).ravel()) == list(range(256 * 128))
    assert (tma_swizzle(rr * 128 + bb, 128) == sw128(rr, bb)).all()
    for ks in range(0, 128, 32):
        kk = np.arange(32)[None, :]
        rows = np.arange(256)[:, None]
        assert (wgmma_read(ks, rows, kk) == sw128(rows, ks + kk)).all()
    for cols in (64, 128):
        rr, cc = np.meshgrid(np.arange(64), np.arange(cols), indexing="ij")
        assert sorted(tma_swizzle(rr * cols + cc, cols).ravel()) == list(
            range(64 * cols))
        _, _, _, t4, c0 = ra_lanes(cols // 64)
        for int8 in (False, True):
            r = ra_rows(int8, t4)
            off = ra_roff(int8, cols, t4, c0)
            assert (off == tma_swizzle(r * cols + c0[:, None], cols)).all()
            assert (off + 1 == tma_swizzle(r * cols + c0[:, None] + 1,
                                           cols)).all()


@pytest.mark.parametrize("bn", tqm.RA_BX)
def test_b3_d_fragment_covers_the_tile_once(bn):
    """wgmma's D fragment of a warpgroup covers its 64 x BX tile once at
    every built BX (the register-A kernel's x rows)."""
    t = np.arange(128)[:, None]
    i = np.arange(bn // 2)[None, :]
    r, c = d_fragment(i, t)
    cells = sorted(zip(r.ravel().tolist(), c.ravel().tolist()))
    assert cells == [(a, b) for a in range(64) for b in range(bn)]


@pytest.mark.parametrize("m,n_logical,plan", [
    (130, 200, (160, 2, 2, 2, 0)), (256, 256, (256, 1, 4, 1, 2)),
    (100, 96, (128, 2, 1, 4))])
def test_b3_emulation_equals_plain(m, n_logical, plan):
    """The register-A kernel's maps and order of operations (ra_model, int8
    mode: s8 from the whole K in the prologue, w8 made in the A registers,
    the x tile as the B operand, exact int32 sums, the splits merged in
    order, the epilogue (float(acc) * dx) * s8) give
    q4_matmul_prefill_int8_plain's output bit for bit, across partial row
    and column tiles, one and two warpgroups, K (padded from 320 to the
    stored 512: four 128-deep stages) split in two for every tile, in four
    for the tiles past the first two, or not."""
    k = 320
    wt, _ = weights(k, n_logical, seed=21)
    x = acts(m, k, seed=22, scale=2.0)
    xq, dx = tqm.quant_rows_int8(torch.from_numpy(x), wt.k)
    want = tqm.q4_matmul_prefill_int8_plain(xq, dx, wt).numpy()
    got = ra_model("int8", xq.numpy(), wt, tqm.RaPlan(*plan), dx.numpy())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,plan", [("int8", (128, 1, 2, 2, 1)),
                                       ("q4_0", (128, 2, 2, 4, 0)),
                                       ("q4_1", (96, 1, 3, 2, 1))])
def test_ra_model_at_a_shard_k_past_the_last_stage(mode, plan):
    """ra_model on a stored K that no stage divides, as a tp shard keeps
    it (K = 352, 11 q blocks: B3's last 128-deep stage 3/4 inside K, B5's
    last 64-deep stage half; the copies fill zeros past K), K split so
    that the short stage falls in the last split: B3 bit-equal to
    q4_matmul_prefill_int8_plain, B5 within 1e-5 of q4_matmul_dequant."""
    k, n, m = 352, 200, 130
    rng = np.random.default_rng(29)
    sc = rng.uniform(1e-3, 0.02, (k // 32, 208)).astype(np.float32)
    wt = tt.QuantMatmulWeight(
        qs=torch.from_numpy(rng.integers(0, 256, (k // 2, 208),
                                         dtype=np.uint8)),
        scales=torch.from_numpy(sc),
        mins=torch.from_numpy(-7.5 * sc) if mode == "q4_1" else None,
        n_logical=n)
    x = acts(m, k, seed=30, scale=2.0)
    if mode == "int8":
        xq, dx = tqm.quant_rows_int8(torch.from_numpy(x), wt.k)
        want = tqm.q4_matmul_prefill_int8_plain(xq, dx, wt).numpy()
        got = ra_model("int8", xq.numpy(), wt, tqm.RaPlan(*plan), dx.numpy())
        np.testing.assert_array_equal(got, want)
        return
    want = tqm.q4_matmul_dequant(torch.from_numpy(x), wt,
                                 torch.bfloat16).numpy()
    got = ra_model(mode, x, wt, tqm.RaPlan(*plan))
    assert_close(got, want, 1e-5)


def test_b3_requant_byte_rounds_half_to_even():
    """The requant pass's arithmetic without conversions: (2^23 + q) -
    (2^23 + 8) is q - 8 exactly, the product is the plain version's f32
    rounding, and adding 1.5 * 2^23 leaves round_half_even of it in the
    low byte, at every code and at scales that make exact ties."""
    rng = np.random.default_rng(23)
    sc = np.concatenate([rng.uniform(0, 127 / 8, 4000),
                         np.arange(1, 32) / 2.0]).astype(np.float32)
    q = np.arange(16, dtype=np.uint32)[:, None]
    v = ((0x4B000000 | q).view(np.float32) - np.float32(8388616.0))
    assert (v == (q.astype(np.float32) - 8)).all()
    prod = (v * sc[None, :]).astype(np.float32)
    low = ((prod + np.float32(12582912.0)).astype(np.float32)
           .view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    want = torch.round(torch.from_numpy(prod)).to(torch.int8).numpy()
    np.testing.assert_array_equal(low, want)


# the rows the plan is held at: B1's rows that B5 takes (b1_on_b5), B5's
# edges, the engine's buckets and the prefill's 512 bucket, and partial
# tiles past them
RA_ROWS = (57, 64, 65, 128, 192, 255, 256, 300, 512, 513)


def ra_stages(int8, affine, bx, wgs):
    """The ring slots of the kernel (q4_prefill_ra.cuh max_stages): a
    stage's 1024-aligned bytes (the x tile, the packed rows, the scale and
    mins rows) in the dynamic shared memory of a launch (231,424 bytes)
    less 1 KB of alignment and the barriers."""
    cols, qb = 64 * wgs, 4 if int8 else 2
    raw = bx * 128 + qb * 16 * cols + qb * cols * 4 * (2 if affine else 1)
    return min(8, (231424 - 1024 - 24 * 8) // (-(-raw // 1024) * 1024))


def check_ra_plan_covers(k, n, int8):
    """prefill_plan at RA_ROWS on a stored (K, N) plane: the row tiles,
    column tiles and splits of K cover every output and every q block once
    (a stage 2 q blocks in bf16 mode, 4 in int8 mode; the last may reach
    past K, where the copies fill zeros) in the kernel's items (ra_items:
    whole tiles, then the split ones), every split keeps RA_MIN_STAGES
    stages, and the ring holds three stages or more (B5: in both weight
    kinds)."""
    nb, qb = k // 32, 4 if int8 else 2
    for m in RA_ROWS:
        p = tqm.prefill_plan(m, n, k, 132, int8=int8)
        assert p.bx in tqm.RA_BX and p.wgs in (1, 2)
        assert 1 <= p.splits <= tqm.RA_MAX_SPLITS
        cols = 64 * p.wgs
        rows = [z * p.bx + r for z in range(-(-m // p.bx))
                for r in range(p.bx) if z * p.bx + r < m]
        outs = [y * cols + c for y in range(-(-n // cols))
                for c in range(cols) if y * cols + c < n]
        assert rows == list(range(m)) and outs == list(range(n))
        nst = -(-nb // qb)
        tiles = -(-m // p.bx) * -(-n // cols)
        assert p.splits == 1 or 0 <= p.t0 < tiles
        blocks = {t: [] for t in range(tiles)}
        for t, z in tqm.ra_items(tiles, p):
            if p.splits == 1 or t < p.t0:
                stages = range(nst)
            else:
                stages = range(z * p.per, min(nst, (z + 1) * p.per))
                assert len(stages) >= tqm.RA_MIN_STAGES
            blocks[t] += [qb * s + j for s in stages for j in range(qb)
                          if qb * s + j < nb]
        assert all(b == list(range(nb)) for b in blocks.values())
        assert ra_stages(int8, False, p.bx, p.wgs) >= 3
        assert int8 or ra_stages(int8, True, p.bx, p.wgs) >= 3


@pytest.mark.parametrize("k,n", PLANES_7B[:4] + PLANES_13B
                         + PLANES_7B_TP[:4] + PLANES_7B_TP[5:9])
def test_b3_plan_covers_every_output_once(k, n):
    """B3's plan (prefill_plan, int8 mode) on the 7B and 13B planes and the
    tp planes covers every output and q block once at RA_ROWS and its x
    tiles follow M: ceil(M / 256) tiles as even as they go (M = 300: two
    of 160; 513: three of 192)."""
    check_ra_plan_covers(k, n, True)
    assert [tqm.ra_bx(m) for m in (57, 65, 128, 255, 256, 300, 512, 513,
                                    1024)] == [64, 96, 128, 256, 256, 160,
                                               256, 192, 256]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("k,n", PLANES_7B + PLANES_13B + PLANES_7B_TP)
def test_ra_plan_covers_every_output_and_q_block_once(k, n, int8):
    """The register-A kernel's plan in both modes (B5 in bf16 mode, B3) on
    every stored 7B and 13B plane and the planes a rank holds at tp 2 and 4
    (w2 at tp 4: 86 q blocks) at RA_ROWS (check_ra_plan_covers)."""
    check_ra_plan_covers(k, n, int8)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 300, 512, 513, 1024])
@pytest.mark.parametrize("k,n", [(11008, 4096), (5120, 15360)])
def test_b3_kernel_bit_exact_at_7b_and_13b_planes(cuda_device, m, k, n):
    """B3 (requant pass + wgmma product) on a 7B plane (w2) and a 13B plane
    (qkv) equals its plain version bit for bit, across partial row tiles,
    and run to run."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m + k)
    kp, np_ = tt.good_pad_k(k), tt.good_pad_n(n)
    w = tt.QuantMatmulWeight(
        qs=torch.randint(0, 256, (kp // 2, np_), generator=g,
                         device=cuda_device, dtype=torch.uint8),
        scales=torch.rand((kp // 32, np_), generator=g, device=cuda_device)
        * 0.019 + 1e-3, n_logical=n)
    x = torch.randn((m, k), generator=g, device=cuda_device) * 3.0
    xq, dx = tqm.quant_rows_int8(x, w.k)
    got = tqm.q4_matmul_prefill_int8(xq, dx, w)
    assert torch.equal(got, tqm.q4_matmul_prefill_int8_plain(xq, dx, w))
    assert torch.equal(got, tqm.q4_matmul_prefill_int8(xq, dx, w))


# the planes a rank holds at tp 4 whose K the shard keeps unpadded: w2
# (2752, 86 q blocks: B3's last 128-deep stage half past K, B5's whole) and
# wo (1024)
TP4_SHARDS = [(2752, 4096), (1024, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["q4_0", "q4_1", "int8"])
@pytest.mark.parametrize("k,n", [(4096, 12288), (11008, 4096), (5120, 15360),
                                 (13824, 5120), (4096, 4096)] + TP4_SHARDS)
def test_ra_kernels_match_plain_under_pinned_plans(cuda_device, mode, k, n):
    """B3 (bit for bit) and B5 (q4_0, q4_1; 1e-5 of the largest |x| @ |W|)
    on 7B and 13B planes and tp 4's shards (stored K = K: the copies' zero
    fill past K inside the tile loop) at RA_ROWS, on their plan and pinned
    to one and two warpgroups a block with K whole and split three ways
    (every tile, or every tile but the first), each run twice and equal."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(k + n)
    kp = k if (k, n) in TP4_SHARDS else tt.good_pad_k(k)
    np_ = tt.good_pad_n(n)
    sc = torch.rand((kp // 32, np_), generator=g, device=cuda_device) \
        * 0.019 + 1e-3
    w = tt.QuantMatmulWeight(
        qs=torch.randint(0, 256, (kp // 2, np_), generator=g,
                         device=cuda_device, dtype=torch.uint8),
        scales=sc, mins=(sc * -7.5) if mode == "q4_1" else None, n_logical=n)
    int8 = mode == "int8"
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for m in RA_ROWS:
        x = torch.randn((m, k), generator=g, device=cuda_device)
        kc = kp if int8 else k
        plans = [None] + [tqm.prefill_plan(m, np_, kc, sms, int8=int8,
                                           wgs=wgs, splits=s, t0=t0)
                          for wgs in (1, 2) for s, t0 in ((1, None), (3, 0),
                                                          (3, 1))]
        if int8:
            xq, dx = tqm.quant_rows_int8(x, w.k)
            want = tqm.q4_matmul_prefill_int8_plain(xq, dx, w)
            for p in plans:
                got = tqm.q4_matmul_prefill_int8(xq, dx, w, plan=p)
                assert torch.equal(got, want), (m, p)
                assert torch.equal(got, tqm.q4_matmul_prefill_int8(
                    xq, dx, w, plan=p))
            continue
        want = tqm.q4_matmul_dequant(x, w, torch.bfloat16)
        wd = tt.dequant_matmul_weight(w, torch.bfloat16).float()
        tol = 1e-5 * (tqm._pad_k(x.abs(), kp).to(torch.bfloat16).float()
                      @ wd.abs())[:, :n].max().item()
        for p in plans:
            got = tqm.q4_matmul_prefill(x, w, torch.bfloat16, plan=p)
            assert (got - want).abs().max().item() <= tol, (m, p)
            assert torch.equal(got, tqm.q4_matmul_prefill(
                x, w, torch.bfloat16, plan=p))


# -- b5_plan (B20's split kernel) and B20's converter tile -------------------

# (K, N) stored planes at 7B (qkv, wo, w13, w2) and 13B
B5_PLANES = PLANES_7B[:4] + PLANES_13B


# (B5's f32 mode runs the register-A kernel on prefill_plan:
# test_torch_f32_mode)
@pytest.mark.parametrize("k,n", B5_PLANES + PLANES_7B_TP[:4]
                         + PLANES_7B_TP[5:9])
def test_b5_plan_covers_every_output_and_q_block_once(k, n):
    """Row tiles x column tiles x K splits of b5_plan cover each output once
    and each q block of K once at every M from 65 to 513 (B20's split
    kernel: 64-deep stages of two q blocks, at least
    B5_MIN_STAGES_PER_SPLIT a split); on the 7B qkv plane M = 128 splits K
    four ways (96 tiles on 132 SMs) and M = 512 does not split (384
    tiles)."""
    nb = k // 32
    qb = tqm.B5_BK // 32
    least = tqm.B5_MIN_STAGES_PER_SPLIT
    for m in range(65, 514):
        splits, per = tqm.b5_plan(m, n, k, 132)
        nk = -(-nb // qb)
        assert 1 <= splits <= tqm.B5_MAX_SPLITS and splits == -(-nk // per)
        rows = [z * tqm.B5_BM + r for z in range(-(-m // tqm.B5_BM))
                for r in range(tqm.B5_BM) if z * tqm.B5_BM + r < m]
        cols = [y * tqm.B5_BN + c for y in range(-(-n // tqm.B5_BN))
                for c in range(tqm.B5_BN) if y * tqm.B5_BN + c < n]
        assert rows == list(range(m)) and cols == list(range(n))
        blocks = []
        for z in range(splits):
            stages = range(z * per, min(nk, (z + 1) * per))
            assert splits == 1 or len(stages) >= least
            blocks += [qb * kt + j for kt in stages for j in range(qb)
                       if qb * kt + j < nb]
        assert blocks == list(range(nb))
    assert tqm.b5_plan(128, 12288, 4096, 132) == (4, 16)
    assert tqm.b5_plan(512, 12288, 4096, 132)[0] == 1


def b5_w_off(k, n):
    """Byte offset of weight (k, n) of a stage's converted bf16 tile [64 K,
    128 N] as the converter writes it (csrc/q4_prefill.cu w_off, n any
    column): atoms of 8 K rows by 64 columns (1024 bytes; 2048 bytes per 8 K
    rows), 128-byte rows, the 16-byte chunk XOR the row within the atom."""
    return ((k >> 3) * 2048 + (n >> 6) * 1024 + (k & 7) * 128
            + ((((n & 63) >> 3) ^ (k & 7)) << 4) + (n & 7) * 2)


def wgmma_read_mn(start, lbo, sbo, k, n):
    """The byte wgmma reads for B element (k, n), k < 16, of an MN-major
    16-bit operand whose 128-byte-swizzle descriptor starts at `start` with
    leading offset lbo (between 64-element atoms along N) and stride offset
    sbo (between 8-row groups along K): the canonical layout's address, then
    the swizzle the hardware applies (address bits 4-6 XOR bits 7-9)."""
    addr = start + (n // 64) * lbo + (k // 8) * sbo + (k % 8) * 128 + \
        (n % 64) * 2
    return addr ^ (((addr >> 7) & 7) << 4)


def test_b5_converter_tile_is_a_bijection_and_wgmma_reads_the_k_slice():
    """B20's converters' tile places the 64 x 128 weights of a stage
    bijectively in 16 KB; wgmma's MN-major descriptor (LBO 1024, SBO 2048,
    start advanced by 4096 bytes a k16 step) reads exactly the (k, n) the
    converter wrote for every k of each of the four k16 steps; a warp's
    8-byte stores (lane l: columns 4 l .. 4 l + 3 of one K row) fill two
    whole 128-byte wavefronts, every 4-byte bank once per half warp."""
    kk, nn = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    assert sorted((b5_w_off(kk, nn) // 2).ravel()) == list(range(64 * 128))
    for step in range(4):
        k16, n = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
        got = wgmma_read_mn(step * 2 * 2048, 1024, 2048, k16, n)
        assert (got == b5_w_off(step * 16 + k16, n)).all()
    lanes = np.arange(32)
    for k in range(64):
        offs = b5_w_off(k, 4 * lanes)
        for half in (offs[:16], offs[16:]):
            banks = np.concatenate([half // 4, half // 4 + 1]) % 32
            assert sorted(banks.tolist()) == list(range(32))


@pytest.mark.parametrize("affine", [False, True])
def test_b5_converter_arithmetic_equals_dequant_bit_for_bit(affine):
    """The weight without a conversion instruction, as the register-A
    kernel makes it in bf16 mode (and B5's f32 kernel before the rounding):
    2^23 + q minus 2^23 (+ 8) is q (q - 8) exactly, then __fmul_rn by d (and
    __fadd_rn of m), each rounded in f32 (numpy f32 ops: no FMA), then one
    rounding to bf16, gives dequant_matmul_weight's bf16 weight bit for bit
    at every code."""
    rng = np.random.default_rng(24)
    d = rng.uniform(1e-3, 0.02, 4096).astype(np.float32)
    mn = (d * rng.uniform(-8, -7, 4096)).astype(np.float32)
    q = np.arange(16, dtype=np.uint32)[:, None]
    magic = (0x4B000000 | q).view(np.float32)
    if affine:
        v = (magic - np.float32(8388608.0)) * d[None, :] + mn[None, :]
    else:
        v = (magic - np.float32(8388616.0)) * d[None, :]
    assert v.dtype == np.float32
    got = torch.from_numpy(v).to(torch.bfloat16)
    qs = torch.from_numpy(np.tile(q.astype(np.uint8) | (q.astype(np.uint8)
                                                       << 4), (1, 1)))
    w = tt.QuantMatmulWeight(
        qs=qs.expand(16, 4096).contiguous(),
        scales=torch.from_numpy(d)[None, :].contiguous(),
        mins=torch.from_numpy(mn)[None, :].contiguous() if affine else None,
        n_logical=4096)
    want = tt.dequant_matmul_weight(w, torch.bfloat16)[:16]
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,plan", [(130, (160, 2, 2, 5, 0)),
                                    (65, (96, 1, 1, 10)),
                                    (260, (128, 2, 3, 4, 3))])
@pytest.mark.parametrize("affine", [False, True])
def test_b5_emulation_equals_plain(m, plan, affine):
    """The register-A kernel's maps and order of operations (ra_model, bf16
    mode: the weight made in the A registers, the x tile as the B operand,
    f32 sums a k16 step, the splits added in order) against
    q4_matmul_dequant within f32 reassociation, across partial row and
    column tiles, x's K (608) short of the stored K (768), one and two
    warpgroups, and K split in two for every tile, in three for the tiles
    past the first three, or not."""
    wt = q41_weight(608, 200) if affine else weights(608, 200, seed=25)[0]
    x = acts(m, 608, seed=26)
    want = tqm.q4_matmul_dequant(torch.from_numpy(x), wt).numpy()
    got = ra_model("q4_1" if affine else "q4_0", x, wt, tqm.RaPlan(*plan))
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("mode", ["q4_0", "q4_1", "int8"])
@pytest.mark.parametrize("wgs", [1, 2])
def test_ra_a_fragment_holds_the_weights(mode, wgs):
    """Row 16 w + g (+ 8) of warpgroup wg's A operand holds weight column
    64 wg + 16 w + 2 g (+ 1) of every q block bit for bit: B5's through its
    loads (ra_roff on the swizzled packed rows), its arithmetic in
    registers (ra_weights) and wgmma's A fragment map,
    dequant_matmul_weight's bf16 weight (q4_0, q4_1); B3's the same way
    (int8), requant_weight_int8's w8; for one and two warpgroups a
    block."""
    k, n = 256, 256
    wt = q41_weight(k, n) if mode == "q4_1" else weights(k, n, seed=27)[0]
    int8 = mode == "int8"
    if int8:
        w8, s8 = tqm.requant_weight_int8(wt)
        want = w8.numpy().astype(np.float64)
        inv = f32(np.float32(1.0) / s8.numpy())
    else:
        want = tt.dequant_matmul_weight(wt, torch.bfloat16).float().numpy()
        inv = None
    qs, planes = wt.qs.numpy(), [wt.scales.numpy()]
    if mode == "q4_1":
        planes.append(wt.mins.numpy())
    cols, qb = 64 * wgs, 4 if int8 else 2
    # A row 16 w + g + 8 h of warpgroup wg holds column n0 + col[r],
    # 64 wg + 16 w + 2 g + h
    r = np.arange(cols)
    rem = r % 64
    col = 64 * (r // 64) + 16 * (rem // 16) + 2 * (rem % 8) + (rem % 16) // 8
    for n0 in range(0, n, cols):
        for st in range(k // (32 * qb)):
            qbuf = ra_stage_box(qs, st * qb * 16, qb * 16, n0, cols, cols)
            sbuf = np.concatenate([ra_stage_box(p, st * qb, qb, n0, cols)
                                   for p in planes])
            for b in range(qb):
                a = ra_a_tile(mode, qbuf, sbuf, b, cols, None if inv is None
                              else inv[n0:n0 + cols])
                kb = st * qb + b
                np.testing.assert_array_equal(
                    a, want[32 * kb:32 * kb + 32, n0 + col].T)


def test_b3_s8_prologue_equals_the_plain_scales():
    """B3's prologue: the four lanes of a column pair take every fourth q
    block's |d| (a max, exact in any order), s8 = max(mx * 8/127, 1e-20)
    and 1 / s8 by one IEEE division give requant_weight_int8's s8 and its
    d * (1 / s8) bit for bit, on a plane of 13 q blocks (not a multiple of
    four) with a zero column (s8 at its floor)."""
    wt, _ = weights(416, 96, seed=28)
    sc = wt.scales.numpy().copy()
    sc[:, 5] = 0.0
    wt = tt.QuantMatmulWeight(wt.qs, torch.from_numpy(sc), n_logical=96)
    lanes = [np.abs(sc[t::4]).max(0) for t in range(4)]
    mx = np.maximum(np.maximum(lanes[0], lanes[1]),
                    np.maximum(lanes[2], lanes[3]))
    s8 = np.maximum(f32(mx * np.float32(8.0 / 127.0)), np.float32(1e-20))
    inv = f32(np.float32(1.0) / s8)
    w8, s8_plain = tqm.requant_weight_int8(wt)
    np.testing.assert_array_equal(s8, s8_plain.numpy())
    assert s8[5] == np.float32(1e-20)
    np.testing.assert_array_equal(
        f32(sc * inv[None, :]),
        (wt.scales * (torch.ones_like(s8_plain) / s8_plain)).numpy())


@pytest.mark.parametrize("mode", ["q4_0", "q4_1", "int8"])
@pytest.mark.parametrize("m", [130, 256])
def test_ra_model_matches_the_jax_kernels(mode, m):
    """The register-A model against the JAX package at a small size (K 352
    padded to 512, N 96 padded to 256): int8 against q4_matmul_prefill_int8
    (its Pallas kernel in interpret mode, which quantizes x itself) within
    2 ulps (the JAX path's (acc * dx) * s8 may be fused by XLA; the port's
    own plain version is bit-equal, test_b3_emulation_equals_plain) and its
    exact int32 accumulators against q4_matmul_int8_xla's; q4_0 against
    q4_matmul_prefill_pallas in interpret mode and q4_1 against
    q4_matmul_xla (the JAX package's function for an affine weight at M >
    64; its Pallas prefill kernel takes q4_0 only), within 1e-5 of the
    largest output."""
    k, n = 352, 96
    plan = tqm.prefill_plan(m, 256, 512 if mode == "int8" else 352, 4,
                            int8=mode == "int8")
    x = acts(m, k, seed=29, scale=2.0)
    if mode == "q4_1":
        wt, wj, _ = _q41_weights(k, n)
    else:
        wt, wj = weights(k, n, seed=30)
    xp = np.pad(x, ((0, 0), (0, wt.k - k)))
    if mode == "int8":
        xq, dx = tqm.quant_rows_int8(torch.from_numpy(x), wt.k)
        got = ra_model("int8", xq.numpy(), wt, plan, dx.numpy())
        want = np.asarray(jqm.q4_matmul_prefill_int8(
            jnp.asarray(xp), wj.qs, wj.scales, interpret=True))[:, :n]
        assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)))
        w8, _ = tqm.requant_weight_int8(wt)
        np.testing.assert_array_equal(
            tqm.int8_accumulators(xq, w8).numpy().astype(np.int64),
            np.asarray(_jax_int8_accumulators(xp, wj)))
        return
    got = ra_model(mode, x, wt, plan)
    if mode == "q4_0":
        want = jqm.q4_matmul_prefill_pallas(
            jnp.asarray(xp).astype(jnp.bfloat16), wj.qs, wj.scales,
            interpret=True, w_dtype=jnp.bfloat16)
    else:
        want = jqm.q4_matmul_xla(jnp.asarray(xp), wj, w_dtype=jnp.bfloat16)
    assert_close(got, np.asarray(want)[:, :n], 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [65, 128, 255, 256, 513])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("k,n", [(4096, 12288), (13824, 5120)])
def test_b5_kernel_matches_plain_at_7b_and_13b_planes(cuda_device, m, mode,
                                                      affine, k, n):
    """B5 (q4_0 and q4_1, bf16 and f32 mode) on 7B and 13B planes against
    its plain version within f32 reassociation (1e-5 of the largest
    |x| @ |W|), across split and unsplit K and partial row tiles."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m + k + affine)
    kp, np_ = tt.good_pad_k(k), tt.good_pad_n(n)
    sc = torch.rand((kp // 32, np_), generator=g, device=cuda_device) \
        * 0.019 + 1e-3
    w = tt.QuantMatmulWeight(
        qs=torch.randint(0, 256, (kp // 2, np_), generator=g,
                         device=cuda_device, dtype=torch.uint8),
        scales=sc, mins=(sc * -7.5) if affine else None, n_logical=n)
    x = torch.randn((m, k), generator=g, device=cuda_device)
    dt = getattr(torch, mode)
    got = tqm.q4_matmul_prefill(x, w, dt)
    want = tqm.q4_matmul_dequant(x, w, dt)
    wd = tt.dequant_matmul_weight(w, dt).float()
    scale = (tqm._pad_k(x.abs(), kp).to(dt).float() @ wd.abs())[:, :n].max()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-5 * scale.item()
    assert torch.equal(got, tqm.q4_matmul_prefill(x, w, dt))
