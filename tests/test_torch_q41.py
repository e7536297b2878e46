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
    """Affine weights above M = 64 take the dequant path's function, R(x)
    @ R(q * d + m) with f32 accumulation, on both packages: the JAX one as
    dequant + dot, the port through B5 (on the CPU its plain version)."""
    wt, wj, _ = weights(352, 96, seed=5)
    x = acts(m, 352, seed=6)
    got = tqm.q4_matmul(torch.from_numpy(x), wt, w_dtype=torch.bfloat16,
                        prefill_int8=None).numpy()
    want = jqm.q4_matmul(jnp.asarray(x), wj, use_pallas=False,
                         w_dtype=jnp.bfloat16, prefill_int8=None)
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("m", [65, 128, 300])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_b5_affine_plain_matches_jax_q4_matmul_xla(m, mode):
    """B5 on a q4_1 weight (its plain version on the CPU) against the JAX
    package's q4_matmul_xla, the function the JAX dispatch runs for an
    affine weight at M > 64: R(x) @ R(q * d + m), f32 accumulation, x
    zero-padded to the stored K. Equal to f32 reassociation."""
    wt, wj, _ = weights(352, 96, seed=15)
    x = acts(m, 352, seed=16)
    got = tqm.q4_matmul_prefill(torch.from_numpy(x), wt,
                                getattr(torch, mode)).numpy()
    assert got.shape == (m, 96)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, wj.k - 352)))
    want = np.asarray(jqm.q4_matmul_xla(xp, wj, w_dtype=getattr(jnp, mode)))
    assert_close(got, want[:, :96], 1e-5)


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


# -- B9 in bf16 mode: B1's tensor-core kernel with the mins term -------------

from test_torch_q4_matmul import (  # noqa: E402
    b1_a_fragment, b1_b_fragment, b1_c_fragment)

# (K, N) logical planes at 7B widths: qkv, wo, w13, w2, head
PLANES_7B = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
             (4096, 32000)]


@pytest.mark.parametrize("pad_n", [256, 1024])
@pytest.mark.parametrize("k,n", PLANES_7B)
def test_b9_mma_plan_covers_affine_planes(k, n, pad_n):
    """The tensor-core plan on the affine planes as they are stored:
    make_matmul_weight_q41 pads N to a multiple of 256 (22016, 32000), the
    fused and fltpu planes to good_pad_n's 1024 rule (22528, 32768). For M =
    1..64 the row tiles, the blocks' columns (those < N: a 256-column block
    may run past a 256-padded plane) and the splits' q blocks cover each
    (row, column, q block) exactly once, and a block's shared memory (the
    28 KB ring with the mins, the x slice, the block sums) fits the SM."""
    kp = tt.good_pad_k(k)
    np_ = tt.pad_multiple(n, 256) if pad_n == 256 else tt.good_pad_n(n)
    nb = kp // 32
    wc = tqm.B1_MMA_WARP_COLS
    for m in range(1, 65):
        nt, cw, splits, per = tqm.b1_mma_plan(m, np_, nb)
        rows_per, kw = 8 * nt, tqm.B1_MMA_WARPS // cw
        rows = [z * rows_per + r for z in range(-(-m // rows_per))
                for r in range(rows_per) if z * rows_per + r < m]
        assert rows == list(range(m))
        cols = [c for x in range(-(-np_ // (cw * wc))) for g in range(cw)
                for j in range(wc) if (c := x * cw * wc + g * wc + j) < np_]
        assert cols == list(range(np_))
        blocks = []
        for sp in range(splits):
            nkb = min(nb, (sp + 1) * per) - sp * per
            assert nkb >= 1
            for kg in range(kw):
                blocks += [sp * per + b for b in range(kg, nkb, kw)]
        assert sorted(blocks) == list(range(nb))
        ring = 4 * 4 * (16 * 80 + 2 * 64 * 4)
        smem = max(ring + per * nt * 512 + per * rows_per * 4,
                   4 * rows_per * 64 * 4)
        assert smem + 1024 <= 227 * 1024


def b9_stage_block_sums(x_tile, nkb, mt_rows):
    """A copy of the kernel's staging of the block sums for one (row tile,
    split): x_tile f32 [rows, nkb * 32] holds the tile's rows < M (unrounded).
    Each thread's float4 is summed as (v0 + v1) + (v2 + v3), the 8 lanes of a
    q block add theirs by shuffles at distances 1, 2 and 4, and lane 0 of
    the 8 writes bs[b * MT + r]; then rows >= M get zeros. Returns bs [nkb *
    MT] f32 and how often each entry was written."""
    rows, quads = x_tile.shape[0], nkb * 8
    bs = np.full(nkb * mt_rows, np.nan, np.float32)
    writes = np.zeros(nkb * mt_rows, int)
    for i0 in range(0, rows * quads, 128):
        sums = np.zeros(128, np.float32)
        for tid in range(128):
            i = i0 + tid
            if i < rows * quads:
                r, qd = divmod(i, quads)
                v = x_tile[r, qd * 4:qd * 4 + 4]
                sums[tid] = (v[0] + v[1]) + (v[2] + v[3])
        for dist in (1, 2, 4):
            sums = sums + sums[np.arange(128) ^ dist]
        for tid in range(128):
            i = i0 + tid
            r, qd = divmod(i, quads)
            if i < rows * quads and qd % 8 == 0:
                bs[(qd >> 3) * mt_rows + r] = sums[tid]
                writes[(qd >> 3) * mt_rows + r] += 1
    for i in range((mt_rows - rows) * nkb):
        bs[(i % nkb) * mt_rows + rows + i // nkb] = 0.0
        writes[(i % nkb) * mt_rows + rows + i // nkb] += 1
    return bs, writes


@pytest.mark.parametrize("m", [1, 5, 8, 13, 40])
def test_b9_fragment_map_with_mins_equals_plain(m):
    """numpy m16n8k16 products through B1's fragment maps with the affine
    dequantization (A = R(q * d), no - 8), the block sums staged as the
    kernel stages them (each entry written once, zeros on the rows >= M of
    the tile) and the mins term added after each q block's two MMAs at the
    D-fragment rows and columns (row nt*8 + 2t + c%2, column g*8 + 2mt + c/2:
    the lane's scale columns) equal B9's plain version at bf16 to 1e-5 of
    sum |x||R(q d)| + sum |bsum||m|; the rows >= M of the staged x hold
    garbage and reach no stored output. The plain version equals
    q41_matmul_pallas in interpret mode on the same inputs."""
    k, n = 96, 128
    wt, wj, _ = weights(k, n, seed=14)
    x = acts(m, k, seed=15)
    xt = torch.from_numpy(x)
    want = tqm.q41_matmul_decode_plain(xt, wt, torch.bfloat16).numpy()
    pallas = jqm.q4_matmul(jnp.asarray(x), wj, use_pallas=True,
                           interpret=True, w_dtype=jnp.bfloat16)
    assert_close(want, pallas, 1e-5)

    kh, ns = wt.qs.shape
    nb = kh // 16
    qs = wt.qs.numpy()
    codes = np.stack([qs & 15, qs >> 4]).astype(np.float32)  # [nib, row, N]
    sc, mins = wt.scales.numpy(), wt.mins.numpy()
    # R(q * d) in f32 then bf16, as the kernel's FMUL and cvt.rn.bf16x2
    qd = torch.from_numpy(codes * np.repeat(sc, 16, axis=0)[None]).to(
        torch.bfloat16).double().numpy()
    nt, cw, splits, per = tqm.b1_mma_plan(m, ns, nb)
    mt_rows = 8 * nt
    m_pad = -(-m // mt_rows) * mt_rows
    xf = np.zeros((m, wt.k), np.float32)
    xf[:, :k] = x
    xs = np.random.default_rng(16).standard_normal((m_pad, wt.k)) * 1e3
    xs[:m] = torch.from_numpy(xf).to(torch.bfloat16).double().numpy()
    y = np.zeros((m_pad, ns))
    for m0 in range(0, m_pad, mt_rows):
        rows = min(mt_rows, m - m0)
        for sp in range(splits):
            kb0 = sp * per
            nkb = min(nb, kb0 + per) - kb0
            bs, writes = b9_stage_block_sums(
                xf[m0:m0 + rows, kb0 * 32:(kb0 + nkb) * 32], nkb, mt_rows)
            assert (writes == 1).all()
            bs = bs.reshape(nkb, mt_rows)
            assert (bs[:, rows:] == 0).all()
            np.testing.assert_allclose(
                bs[:, :rows].T, xf[m0:m0 + rows, kb0 * 32:(kb0 + nkb) * 32]
                .reshape(rows, nkb, 32).sum(-1), rtol=0, atol=1e-5)
            for b in range(nkb):
                kb = kb0 + b
                for n0 in range(0, ns, 64):
                    for t0 in range(0, mt_rows, 8):     # the n-tiles
                        for mt in range(4):
                            d = np.zeros((16, 8))
                            for step in range(2):
                                a = np.zeros((16, 16))
                                bm = np.zeros((16, 8))
                                for lane in range(32):
                                    g, t = lane >> 2, lane & 3
                                    for reg in range(4):
                                        i = g + 8 * (reg & 1)
                                        for e, (col, kk, row, nib) in \
                                                enumerate(b1_a_fragment(
                                                    lane, reg, mt, step)):
                                            a[i, 2 * t + 8 * (reg >> 1) + e] \
                                                = qd[nib, kb * 16 + row,
                                                     n0 + col]
                                    for reg in range(2):
                                        for e, (r, kk) in enumerate(
                                                b1_b_fragment(lane, reg,
                                                              step)):
                                            bm[2 * t + 8 * reg + e, g] = xs[
                                                m0 + t0 + r, kb * 32 + kk]
                                d += a @ bm
                            for lane in range(32):
                                g, t = lane >> 2, lane & 3
                                for c in range(4):
                                    r, col = b1_c_fragment(lane, c, mt)
                                    # the kernel's own indices for the term
                                    assert r == 2 * t + (c & 1)
                                    assert col == g * 8 + 2 * mt + (c >> 1)
                                    y[m0 + t0 + r, n0 + col] += (
                                        d[g + 8 * (c >> 1), 2 * t + (c & 1)]
                                        + float(bs[b, t0 + 2 * t + (c & 1)])
                                        * float(mins[kb, n0 + g * 8 + 2 * mt
                                                     + (c >> 1)]))
    got = y[:m, :wt.n_logical]
    bsum = np.abs(xf.reshape(m, nb, 32).sum(-1))
    dense = qd.reshape(2, nb, 16, ns).transpose(1, 0, 2, 3).reshape(wt.k, ns)
    absum = (np.abs(xs[:m]) @ np.abs(dense)
             + bsum @ np.abs(mins))[:, :wt.n_logical].max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * absum)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 4, 8, 9, 16, 17, 40, 64])
def test_b9_mma_kernel_matches_plain_at_every_tile(cuda_device, m):
    """The tensor-core B9 (bf16 mode) at each n-tile count and a partial
    last row tile, on a 256-column plane with 96 logical columns and K
    padded from 352 to 512 (x shorter than the stored K): 1e-5 of the
    largest output, deterministic run to run."""
    wt, _, _ = weights(352, 96, seed=18)
    w = tt.QuantMatmulWeight(
        wt.qs.to(cuda_device), wt.scales.to(cuda_device),
        mins=wt.mins.to(cuda_device), n_logical=wt.n_logical)
    x = torch.from_numpy(acts(m, 352, seed=19)).to(cuda_device)
    got = tqm.q41_matmul_decode(x, w, torch.bfloat16)
    want = tqm.q41_matmul_decode_plain(x, w, torch.bfloat16)
    assert_close(got.cpu().numpy(), want.cpu().numpy(), 1e-5)
    assert torch.equal(got, tqm.q41_matmul_decode(x, w, torch.bfloat16))
