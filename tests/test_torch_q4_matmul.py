"""PyTorch port: the q4_0 matmuls (B1-B3 and B5 plain versions and the
dispatcher) against the JAX package's kernels (Pallas interpret mode) and
XLA paths. The affine kernel B9 is in test_torch_q41.py."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fastllama_tpu.kernels import q4_matmul as jqm
from fastllama_tpu.quant import tensor as jt
from fastllama_tpu.quant.q4 import quantize_q4_0
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


def q41_weight(k, n):
    rng = np.random.default_rng(12)
    return tt.make_matmul_weight_q41(
        rng.integers(0, 16, (n, k), dtype=np.uint8),
        rng.uniform(0.01, 0.1, (n, k // 32)).astype(np.float32),
        rng.uniform(-0.5, 0.5, (n, k // 32)).astype(np.float32), device="cpu")


@pytest.mark.parametrize("affine,m,mode,int8,path", [
    (False, 1, "bfloat16", None, "B1"),
    (False, 64, "float32", None, "B1"),
    (False, 65, "bfloat16", None, "B5"),
    (False, 255, "bfloat16", True, "B5"),
    (False, 256, "bfloat16", None, "B3"),
    (False, 256, "bfloat16", True, "B3"),
    (False, 512, "float32", True, "B3"),
    (False, 256, "bfloat16", False, "B5"),
    (False, 256, "float32", None, "B5"),
    (False, 4096, "bfloat16", False, "B5"),
    (True, 1, "bfloat16", None, "B9"),
    (True, 64, "float32", None, "B9"),
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
# sides of B1_ON_B5_MIN_M
ROUTE_ROWS = (1, 8, 9, 33, 48, 56, 57, 64)


@pytest.mark.parametrize("affine", [False, True], ids=["q4_0", "q4_1"])
@pytest.mark.parametrize("mode", ["bfloat16", "float32"])
@pytest.mark.parametrize("use_pallas", [None, False, True])
def test_decode_rows_launch_the_fold_variants(monkeypatch, use_pallas, mode,
                                              affine):
    """q4_matmul at M <= 64, by spies on the launchers: in bf16 mode q4_0
    runs variant 0 of the fold kernel (B1; B5, the same function, at M >=
    B1_ON_B5_MIN_M on a plane of stored K > N; use_pallas=True B15, variant
    1) and q4_1 variant 9 (B9; use_pallas=False B5 at every M, as before);
    f32 mode runs the FFMA kernel (q4_1 with use_pallas=False: B5). Each
    launch is counted by the wrapper the dispatcher called."""
    launched = []

    def fold(x, qs, scales, variant, n_out, plan=None, mins=None):
        assert (mins is not None) == (variant == 9)
        launched.append(("fold", variant))
        return torch.zeros((x.shape[0], n_out))

    def ffma(x, w, aff):
        launched.append(("ffma", aff))
        return torch.zeros((x.shape[0], w.n_logical))

    def b5(x, w, w_dtype):
        launched.append(("B5", w.mins is not None))
        return torch.zeros((x.shape[0], w.n_logical))
    monkeypatch.setattr(tqv, "_launch_fold", fold)
    monkeypatch.setattr(tqm, "_launch_ffma", ffma)
    monkeypatch.setattr(tqm, "_launch_b5", b5)
    counters = (tqm.q4_matmul_decode, tqm.q41_matmul_decode,
                tqm.q4_matmul_prefill, tqv.q4_decode_v1)
    bf16 = mode == "bfloat16"
    # a plane wider than deep and one deeper than wide (stored K 1024 > N)
    for k, n in ((256, 512), (1024, 256)):
        wt = (q41_weight(k, n) if affine else weights(k, n)[0])
        w = tt.QuantMatmulWeight(
            qs=reports_cuda(wt.qs), scales=reports_cuda(wt.scales),
            mins=None if wt.mins is None else reports_cuda(wt.mins),
            n_logical=wt.n_logical)
        deep = 2 * w.qs.shape[0] > w.qs.shape[1]
        for m in ROUTE_ROWS:
            launched.clear()
            before = [c.launches for c in counters]
            y = tqm.q4_matmul(reports_cuda(torch.zeros((1, m, k))), w,
                              w_dtype=getattr(torch, mode),
                              use_pallas=use_pallas)
            assert y.shape == (1, m, n)
            if affine and use_pallas is False:
                want, counter = ("B5", True), 2
            elif not bf16:
                want, counter = ("ffma", affine), int(affine)
            elif affine:
                want, counter = ("fold", 9), 1
            elif use_pallas:
                want, counter = ("fold", 1), 3
            elif deep and m >= tqm.B1_ON_B5_MIN_M:
                want, counter = ("B5", False), 2
            else:
                want, counter = ("fold", 0), 0
            assert launched == [want], (k, n, m)
            assert [c.launches - b for c, b in zip(counters, before)] == [
                int(i == counter) for i in range(4)], (k, n, m)
    assert tqm.B1_ON_B5_MIN_M == 57 and tqm.DECODE_MAX_M == 64


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


# -- B3's wgmma kernel: its plan, the swizzles and the fragment map ---------

def sw128(row, byte):
    """Byte offset of (row, byte) in a K-major int8 tile of 128-byte rows as
    TMA writes it with the 128-byte swizzle (tile base 1024-aligned): the
    16-byte chunk index XOR the row within its 8-row group."""
    return row * 128 + (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15)


def wgmma_read(start, row, kbyte):
    """The byte wgmma reads for (row, kbyte) of a K-major operand whose
    128-byte-swizzle descriptor starts at `start` (the tile base plus the k
    step's byte offset; 8-row groups 1024 bytes apart): the plain address,
    then the swizzle the hardware applies (address bits 4-6 XOR bits 7-9)."""
    addr = start + (row // 8) * 1024 + (row % 8) * 128 + kbyte
    return addr ^ (((addr >> 7) & 7) << 4)


def d_fragment(i, t):
    """(row, column) of accumulator register i of thread t of a warpgroup in
    wgmma's m64nN D fragment (csrc/q4_int8.cu's epilogue)."""
    return (16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2),
            8 * (i // 4) + 2 * (t % 4) + i % 2)


def b3_emulate(xq, w8, dx, s8, n_out, bn):
    """The wgmma kernel's data movement and arithmetic in numpy: 128 x bn
    output tiles, K in 128-byte stages written through sw128 into a shared
    buffer, four k32 steps read back through wgmma_read by two warpgroups of
    64 rows, int32 sums in the D fragment, then (f32(acc) * dx) * s8 where
    row < M and column < n_out (zeros past the edges, as TMA fills)."""
    m, k = xq.shape
    n = w8.shape[1]
    y = np.zeros((m, n_out), np.float32)
    w8t = np.ascontiguousarray(w8.T)
    t = np.arange(128)[:, None]
    i = np.arange(bn // 2)[None, :]
    fr, fc = d_fragment(i, t)
    for m0 in range(0, m, 128):
        for n0 in range(0, n, bn):
            acc = np.zeros((2, 128, bn // 2), np.int64)
            for k0 in range(0, k, 128):
                def stage(mat, r0, rows):
                    tile = np.zeros((rows, 128), np.int64)
                    part = mat[r0:r0 + rows, k0:k0 + 128]
                    tile[:part.shape[0], :part.shape[1]] = part
                    buf = np.zeros(rows * 128, np.int64)
                    rr, bb = np.meshgrid(np.arange(rows), np.arange(128),
                                         indexing="ij")
                    buf[sw128(rr, bb)] = tile
                    return buf
                a_buf, b_buf = stage(xq, m0, 128), stage(w8t, n0, bn)
                for ks in range(0, 128, 32):
                    kk = np.arange(32)
                    for wg in range(2):
                        a = a_buf[wgmma_read(wg * 64 * 128 + ks,
                                             fr[..., None], kk)]
                        b = b_buf[wgmma_read(ks, fc[..., None], kk)]
                        acc[wg] += (a * b).sum(-1)
            for wg in range(2):
                rows = m0 + wg * 64 + fr
                cols = n0 + fc
                ok = (rows < m) & (cols < n_out)
                v = (acc[wg].astype(np.float32)
                     * dx[np.minimum(rows, m - 1)]) \
                    * s8[np.minimum(cols, n - 1)]
                y[rows[ok], cols[ok]] = v[ok]
    return y


def test_b3_swizzle_maps_are_bijections_and_wgmma_reads_the_k_slice():
    """TMA's 128-byte swizzle places a 256-row tile bijectively; wgmma,
    with the descriptor's start advanced by 32 bytes a k step, reads
    exactly the logical (row, k) byte for every row of a 64- or 256-row
    operand; the requant pass's staging tile (chunk ^ (row / 4) % 32 in
    512-byte rows) is a bijection whose stores (rows 4 l + c of lanes l)
    and row reads meet no bank conflict (8 distinct 16-byte bank groups in
    every quarter warp)."""
    rr, bb = np.meshgrid(np.arange(256), np.arange(128), indexing="ij")
    assert sorted(sw128(rr, bb).ravel()) == list(range(256 * 128))
    for ks in range(0, 128, 32):
        kk = np.arange(32)[None, :]
        rows = np.arange(256)[:, None]
        assert (wgmma_read(ks, rows, kk) == sw128(rows, ks + kk)).all()
    off = lambda row, chunk: row * 512 + ((chunk ^ ((row >> 2) & 31)) << 4)
    rows, chunks = np.meshgrid(np.arange(128), np.arange(32), indexing="ij")
    assert sorted((off(rows, chunks) // 16).ravel()) == list(range(4096))
    lanes = np.arange(32)
    for c in range(4):
        for chunk in range(32):
            banks = (off(4 * lanes + c, chunk) // 16) % 8
            assert all(len(set(banks[q:q + 8])) == 8 for q in (0, 8, 16, 24))
    for row in range(128):
        assert len(set(off(row, lanes) % 128 // 16)) == 8


@pytest.mark.parametrize("bn", [128, 256])
def test_b3_d_fragment_covers_the_tile_once(bn):
    t = np.arange(128)[:, None]
    i = np.arange(bn // 2)[None, :]
    r, c = d_fragment(i, t)
    cells = sorted(zip(r.ravel().tolist(), c.ravel().tolist()))
    assert cells == [(a, b) for a in range(64) for b in range(bn)]


@pytest.mark.parametrize("m,n_logical,bn", [(130, 200, 128), (256, 256, 256),
                                            (100, 96, 256)])
def test_b3_emulation_equals_plain(m, n_logical, bn):
    """The kernel's maps and order of operations (b3_emulate) give
    q4_matmul_prefill_int8_plain's output bit for bit, across partial row
    and column tiles and K padded from 320 to the stored 512."""
    k = 320
    wt, _ = weights(k, n_logical, seed=21)
    x = acts(m, k, seed=22, scale=2.0)
    xq, dx = tqm.quant_rows_int8(torch.from_numpy(x), wt.k)
    w8, s8 = tqm.requant_weight_int8(wt)
    want = tqm.q4_matmul_prefill_int8_plain(xq, dx, wt).numpy()
    got = b3_emulate(xq.numpy().astype(np.int64), w8.numpy().astype(np.int64),
                     dx.numpy(), s8.numpy(), n_logical, bn)
    np.testing.assert_array_equal(got, want)


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


@pytest.mark.parametrize("k,n", PLANES_7B[:4] + PLANES_13B
                         + PLANES_7B_TP[:4] + PLANES_7B_TP[5:9])
def test_b3_plan_covers_every_output_once(k, n):
    """The grid of B3's product (row tiles of 128 by the planned variant's
    columns) covers M x N once at the prefill's and the admissions' M; the
    7B qkv plane takes 128-column tiles at M = 512 (3 waves on 132 SMs
    against 2 of 256 columns weighing 4) and 256 at M = 256."""
    for m in (256, 300, 512, 513, 1024, 2048):
        bn = tqm.B3_TILES[tqm.b3_plan(m, n, 132)]
        gy = -(-n // bn)
        assert gy <= 65535
        rows = [z * tqm.B3_BM + r for z in range(-(-m // tqm.B3_BM))
                for r in range(tqm.B3_BM) if z * tqm.B3_BM + r < m]
        cols = [y * bn + c for y in range(gy) for c in range(bn)
                if y * bn + c < n]
        assert rows == list(range(m)) and cols == list(range(n))
    assert tqm.B3_TILES[tqm.b3_plan(512, 12288, 132)] == 128
    assert tqm.B3_TILES[tqm.b3_plan(256, 12288, 132)] == 256


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


# -- B5's wgmma kernel: its planner, converter tile and descriptor ----------

# (K, N) stored planes at 7B (qkv, wo, w13, w2) and 13B
B5_PLANES = PLANES_7B[:4] + PLANES_13B


@pytest.mark.parametrize("k,n", B5_PLANES + PLANES_7B_TP[:4]
                         + PLANES_7B_TP[5:9])
@pytest.mark.parametrize("f32", [False, True])
def test_b5_plan_covers_every_output_and_q_block_once(k, n, f32):
    """Row tiles x column tiles x K splits of B5 cover each output once and
    each q block of K once at every M from 65 to 513, in bf16 mode (64-deep
    stages of two q blocks, at least B5_MIN_STAGES_PER_SPLIT a split) and
    f32 mode (steps of one q block, at least B5_MIN_STEPS_PER_SPLIT); on
    the 7B qkv plane M = 128 splits K four ways in bf16 mode (96 tiles on
    132 SMs) and M = 512 does not split (384 tiles)."""
    nb = k // 32
    qb = (tqm.B5_F32_BK if f32 else tqm.B5_BK) // 32
    least = (tqm.B5_MIN_STEPS_PER_SPLIT if f32
             else tqm.B5_MIN_STAGES_PER_SPLIT)
    for m in range(65, 514):
        splits, per = tqm.b5_plan(m, n, k, 132, f32=f32)
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
    if not f32:
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
    """The converter's tile places the 64 x 128 weights of a stage
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
    """The converter's weight without a conversion instruction: 2^23 + q
    minus 2^23 (+ 8) is q (q - 8) exactly, then __fmul_rn by d (and
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


def b5_emulate(x, w, sms):
    """B5's bf16 kernel in numpy: 128 x 128 tiles, K split as b5_plan says
    for `sms` SMs, 64-deep stages whose weights the converter writes
    through b5_w_off into a byte tile and wgmma reads back through
    wgmma_read_mn four k16 steps a stage, f32 sums per split, the splits
    added in order; zeros past M, N and K as TMA fills."""
    m, kx = x.shape
    kh, n = w.qs.shape
    k = kh * 2
    kc = -(-kx // 32) * 32
    splits, per = tqm.b5_plan(m, n, kc, sms)
    nk = -(-kc // 64)
    xb = torch.from_numpy(np.pad(x, ((0, 0), (0, k - kx)))).to(
        torch.bfloat16).float().numpy()
    wd = tt.dequant_matmul_weight(w, torch.bfloat16).float().numpy()
    y = np.zeros((m, n), np.float32)
    k16, nn = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    for m0 in range(0, m, 128):
        for n0 in range(0, n, 128):
            parts = []
            for z in range(splits):
                acc = np.zeros((128, 128), np.float32)
                for kt in range(z * per, min(nk, (z + 1) * per)):
                    tile = np.zeros((64, 128), np.float32)
                    part = wd[kt * 64:kt * 64 + 64, n0:n0 + 128]
                    tile[:part.shape[0], :part.shape[1]] = part
                    buf = np.zeros(8192, np.float32)
                    kk, cc = np.meshgrid(np.arange(64), np.arange(128),
                                         indexing="ij")
                    buf[b5_w_off(kk, cc) // 2] = tile
                    a = np.zeros((128, 64), np.float32)
                    xa = xb[m0:m0 + 128, kt * 64:kt * 64 + 64]
                    a[:xa.shape[0], :xa.shape[1]] = xa
                    for step in range(4):
                        b = buf[wgmma_read_mn(step * 4096, 1024, 2048, k16,
                                              nn) // 2]
                        acc += a[:, step * 16:step * 16 + 16] @ b
                parts.append(acc)
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            y[m0:m0 + 128, n0:n0 + 128] = total[:m - m0, :n - n0]
    return y[:, :w.n_logical]


@pytest.mark.parametrize("m,sms", [(130, 132), (65, 4), (260, 1)])
@pytest.mark.parametrize("affine", [False, True])
def test_b5_emulation_equals_plain(m, sms, affine):
    """The kernel's maps and order of operations (b5_emulate) against
    q4_matmul_dequant within f32 reassociation, across partial row and
    column tiles, K padded from 608 to the stored K, and K split in two
    (four tiles on 132 SMs, two on 4) or not (six tiles on one SM)."""
    wt = q41_weight(608, 200) if affine else weights(608, 200, seed=25)[0]
    x = acts(m, 608, seed=26)
    want = tqm.q4_matmul_dequant(torch.from_numpy(x), wt).numpy()
    assert (tqm.b5_plan(m, wt.qs.shape[1], 608, sms)[0] > 1) == (sms > 1)
    assert_close(b5_emulate(x, wt, sms), want, 1e-5)


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
