"""PyTorch port: the decode attention kernels' plain versions (B4 fused,
B10 attention alone) against the JAX package's Pallas kernels in interpret
mode."""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fastllama_tpu.kernels.decode_attention import (
    decode_attention as jax_attn, decode_attention_fused as jax_fused,
    rope_lane_tables as jax_tables,
)
from fastllama_tpu_torch.kernels import decode_attention as tda

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def inputs(b, s, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, 3 * f)).astype(np.float32),
            rng.standard_normal((b, s, f)).astype(np.float32),
            rng.standard_normal((b, s, f)).astype(np.float32))


def run_both(qkv, kc, vc, n_past, hd, n_rot, cache):
    scale = 1.0 / math.sqrt(hd)
    np_ = np.asarray(n_past, np.int32)
    jdt = getattr(jnp, cache)
    cos, sin = jax_tables(jnp.asarray(np_), hd, n_rot)
    jctx, jk, jv = jax_fused(
        jnp.asarray(qkv), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
        jnp.asarray(np_), cos, sin, head_dim=hd, n_rot=n_rot, scale=scale,
        interpret=True)
    # JAX on the CPU may alias the numpy caches and dispatches
    # asynchronously: let it finish before the torch side writes, and give
    # the torch side its own copies (an f32 tensor would share kc's memory)
    jctx, jk, jv = jax.block_until_ready((jctx, jk, jv))
    tdt = getattr(torch, cache)
    tk = torch.from_numpy(kc.copy()).to(tdt)
    tv = torch.from_numpy(vc.copy()).to(tdt)
    tn = torch.from_numpy(np_)
    # the tables agree to f32 rounding (cos/sin/pow differ by an ulp between
    # the two libraries); the kernel is then fed the same tables
    tcos, tsin = tda.rope_lane_tables(tn, hd, n_rot)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(cos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(sin), atol=1e-6)
    ctx = tda.decode_attention_fused(
        torch.from_numpy(qkv), tk, tv, tn, torch.from_numpy(np.array(cos)),
        torch.from_numpy(np.array(sin)), head_dim=hd, n_rot=n_rot,
        scale=scale)
    return (ctx.numpy(), tk.to(torch.float32).numpy(),
            tv.to(torch.float32).numpy(), np.asarray(jctx),
            np.asarray(jk, np.float32), np.asarray(jv, np.float32))


@pytest.mark.parametrize("n_past", [[0], [1], [77], [127], [0, 127], [5, 64]])
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_b4_plain_matches_pallas(n_past, cache):
    b, s, h, hd = len(n_past), 128, 2, 128
    qkv, kc, vc = inputs(b, s, h * hd, seed=sum(n_past) + b)
    ctx, k, v, jctx, jk, jv = run_both(qkv, kc, vc, n_past, hd, hd, cache)
    # f32 cache: f32 reassociation; bf16 cache: q and p are rounded to bf16
    # for the cache dots, so an f32-ulp difference can move a rounding
    tol = 2e-5 if cache == "float32" else 1e-2
    np.testing.assert_allclose(ctx, jctx, rtol=tol, atol=tol)
    np.testing.assert_array_equal(k, jk)       # written rows and the rest
    np.testing.assert_array_equal(v, jv)


def test_b4_plain_partial_rotation():
    """n_rot < head_dim: lanes past n_rot pass through unrotated."""
    qkv, kc, vc = inputs(1, 128, 256, seed=3)
    ctx, k, v, jctx, jk, jv = run_both(qkv, kc, vc, [40], 128, 64, "float32")
    np.testing.assert_allclose(ctx, jctx, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(v, jv)


def test_b4_wrapper_rejects_bad_inputs():
    qkv = torch.zeros((1, 1, 3 * 256))
    kc = torch.zeros((1, 16, 256))
    ones = torch.zeros((1, 128))
    with pytest.raises(ValueError):
        tda.decode_attention_fused(qkv, kc, kc.clone(),
                                   torch.zeros(1, dtype=torch.int64), ones,
                                   ones, head_dim=128, n_rot=128, scale=1.0)
    with pytest.raises(ValueError):
        tda.decode_attention_fused(qkv[..., :256], kc, kc.clone(),
                                   torch.zeros(1, dtype=torch.int32), ones,
                                   ones, head_dim=128, n_rot=128, scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_b4_kernel_matches_plain(cuda_device, cache):
    qkv, kc, vc = inputs(2, 256, 256, seed=5)
    dt = getattr(torch, cache)
    n = torch.tensor([0, 200], dtype=torch.int32, device=cuda_device)
    cos, sin = tda.rope_lane_tables(n, 128, 128)
    args = [torch.from_numpy(a).to(cuda_device) for a in (qkv, kc, vc)]
    k1, v1 = args[1].to(dt), args[2].to(dt)
    k2, v2 = k1.clone(), v1.clone()
    kw = dict(head_dim=128, n_rot=128, scale=1 / math.sqrt(128))
    got = tda.decode_attention_fused(args[0], k1, v1, n, cos, sin, **kw)
    want = tda.decode_attention_fused_plain(args[0], k2, v2, n, cos, sin, **kw)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


# -- B10: attention alone over an already-written cache ----------------------

def b10_both(q, kc, vc, n_past, hd, cache):
    scale = 1.0 / math.sqrt(hd)
    np_ = np.asarray(n_past, np.int32)
    jdt, tdt = getattr(jnp, cache), getattr(torch, cache)
    want = jax_attn(jnp.asarray(q), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
                    jnp.asarray(np_), head_dim=hd, scale=scale,
                    interpret=True)
    got = tda.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc).to(tdt),
        torch.from_numpy(vc).to(tdt), torch.from_numpy(np_), head_dim=hd,
        scale=scale)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n_past", [[0], [1], [77], [127], [0, 127], [5, 64]])
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_b10_plain_matches_pallas_interpret(n_past, cache):
    """Rows s <= n_past (inclusive) attended; q, scores and p stay f32 for
    both cache types, so both agree to f32 rounding (the cache values are
    the same bf16 numbers on both sides)."""
    b, s, hd, h = len(n_past), 128, 128, 2
    rng = np.random.default_rng(20)
    q = rng.standard_normal((b, 1, h * hd)).astype(np.float32)
    _, kc, vc = inputs(b, s, h * hd, seed=21)
    got, want = b10_both(q, kc, vc, n_past, hd, cache)
    assert got.shape == (b, 1, h * hd)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_b10_mask_is_inclusive():
    """The row at n_past itself takes part: changing it changes the result,
    changing the row after it does not."""
    hd = 32
    rng = np.random.default_rng(22)
    q = torch.from_numpy(rng.standard_normal((1, 1, hd)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((1, 8, hd)).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((1, 8, hd)).astype(np.float32))
    n = torch.tensor([3], dtype=torch.int32)
    base = tda.decode_attention(q, kc, vc, n, head_dim=hd, scale=0.2)
    vc2 = vc.clone()
    vc2[0, 4] += 1.0
    assert torch.equal(tda.decode_attention(q, kc, vc2, n, head_dim=hd,
                                            scale=0.2), base)
    vc2[0, 3] += 1.0
    assert not torch.equal(tda.decode_attention(q, kc, vc2, n, head_dim=hd,
                                                scale=0.2), base)


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_b10_inactive_slot_is_finite(cache):
    """A slot with n_past >= S attends all S rows and gives finite numbers
    on both packages (the engine discards them)."""
    b, s, hd, h = 2, 128, 128, 1
    rng = np.random.default_rng(23)
    q = rng.standard_normal((b, 1, h * hd)).astype(np.float32)
    _, kc, vc = inputs(b, s, h * hd, seed=24)
    got, want = b10_both(q, kc, vc, [5, s + 40], hd, cache)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_b10_kernel_matches_plain(cuda_device, cache):
    b, s, hd, h = 2, 128, 128, 2
    rng = np.random.default_rng(25)
    dt = getattr(torch, cache)
    q = torch.from_numpy(rng.standard_normal((b, 1, h * hd)).astype(
        np.float32)).to(cuda_device)
    _, kc, vc = inputs(b, s, h * hd, seed=26)
    kc = torch.from_numpy(kc).to(cuda_device).to(dt)
    vc = torch.from_numpy(vc).to(cuda_device).to(dt)
    n = torch.tensor([0, 300], dtype=torch.int32, device=cuda_device)
    scale = 1.0 / math.sqrt(hd)
    got = tda.decode_attention(q, kc, vc, n, head_dim=hd, scale=scale)
    want = tda.decode_attention_plain(q, kc, vc, n, head_dim=hd, scale=scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# -- B10's split over the keys: the planner and the merge rule ----------------

@pytest.mark.parametrize("s", [1, 63, 64, 65, 512, 12288])
def test_b10_splits_cover_every_row_once(s):
    splits, chunk = tda.b10_splits(s)
    assert 1 <= chunk <= tda.B10_CHUNK
    rows = [r for i in range(splits)
            for r in range(i * chunk, min((i + 1) * chunk, s))]
    assert rows == list(range(s))
    assert all(i * chunk < s for i in range(splits))   # no chunk is empty
    if s == 512:
        assert (splits, chunk) == (8, 64)


def split_merge(q, k, v, n_past, scale):
    """The kernel's split-and-merge rule in float64 numpy for one (b, h):
    q [D], caches k, v [S, D]. Per chunk of b10_splits: m_i = max score,
    l_i = sum exp(score - m_i), c_i = sum exp(score - m_i) v, or the neutral
    (-inf, 0, 0) for a chunk past the length (its block exits; it adds
    nothing). Then, over the chunks in order, 8 at a time: within a batch
    M = the running max, weights exp(m_i - M); across batches the running
    sums are rescaled by exp(M_old - M_new); ctx = C / L."""
    s_len = k.shape[0]
    n = min(max(int(n_past), 0) + 1, s_len)
    splits, chunk = tda.b10_splits(s_len)
    parts = []
    for i in range(splits):
        rows = np.arange(i * chunk, min((i + 1) * chunk, n))
        if rows.size == 0:
            parts.append((-np.inf, 0.0, np.zeros(k.shape[1])))
            continue
        sc = k[rows] @ q * scale
        m = sc.max()
        p = np.exp(sc - m)
        parts.append((m, p.sum(), p @ v[rows]))
    big, l_tot, ctx = -np.inf, 0.0, np.zeros(k.shape[1])
    for i0 in range(0, splits, 8):
        batch = parts[i0:i0 + 8]
        mb = max([big] + [m for m, _, _ in batch])
        r = np.exp(big - mb)
        l_tot, ctx = l_tot * r, ctx * r
        for m, l, c in batch:
            e = np.exp(m - mb)                  # 0 for a neutral chunk
            l_tot += l * e
            ctx = ctx + c * e
        big = mb
    return ctx / l_tot


@pytest.mark.parametrize("s,n_past", [(512, 0), (512, 1), (512, 63),
                                      (512, 64), (512, 300), (512, 511),
                                      (512, 700), (1024, 700), (1024, 1023)])
def test_b10_split_merge_rule_equals_plain(s, n_past):
    """The merge of per-chunk partial softmaxes (neutral chunks included;
    S = 1024 takes two batches of 8 chunks) equals the plain B10 at every
    depth, n_past >= S included: to 1e-5 of the largest output, f64 merge
    against the f32 plain version."""
    b, hd, h = 1, 32, 2
    rng = np.random.default_rng(27)
    q = rng.standard_normal((b, 1, h * hd)).astype(np.float32)
    _, kc, vc = inputs(b, s, h * hd, seed=28)
    scale = 1.0 / math.sqrt(hd)
    want = tda.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.tensor([n_past], dtype=torch.int32), head_dim=hd,
        scale=scale).numpy().reshape(h, hd)
    got = np.stack([split_merge(
        q[0, 0, i * hd:(i + 1) * hd].astype(np.float64),
        kc[0, :, i * hd:(i + 1) * hd].astype(np.float64),
        vc[0, :, i * hd:(i + 1) * hd].astype(np.float64), n_past, scale)
        for i in range(h)])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("s", [512, 1024])
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_b10_split_kernel_matches_plain_at_every_depth(cuda_device, cache, s):
    """Eight slots at the depths where chunks begin, end and go neutral, one
    of them past S (S = 1024: two merge batches); 5e-5 of the largest output
    (f32 rounding of exp and the sum order)."""
    depths = [0, 1, 63, 64, 300, 511, 512, 700]
    b, hd, h = len(depths), 128, 2
    rng = np.random.default_rng(29)
    dt = getattr(torch, cache)
    q = torch.from_numpy(rng.standard_normal((b, 1, h * hd)).astype(
        np.float32)).to(cuda_device)
    _, kc, vc = inputs(b, s, h * hd, seed=30)
    kc = torch.from_numpy(kc).to(cuda_device).to(dt)
    vc = torch.from_numpy(vc).to(cuda_device).to(dt)
    n = torch.tensor(depths, dtype=torch.int32, device=cuda_device)
    scale = 1.0 / math.sqrt(hd)
    got = tda.decode_attention(q, kc, vc, n, head_dim=hd, scale=scale)
    want = tda.decode_attention_plain(q, kc, vc, n, head_dim=hd, scale=scale)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=5e-5 * want.abs().max().item())
    assert torch.equal(got, tda.decode_attention(q, kc, vc, n, head_dim=hd,
                                                 scale=scale))


# -- B4's split over the keys: the per-chunk p-cast and the new token --------

def _round_to(a, cache):
    """a rounded to the cache type, back as float64."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, cache)).double().numpy()


def _rope_f32(x, cos, sin):
    """fma(x, cos, round(partner * sin)) in f32 (the kernel's per-lane form):
    the f32 product x * cos is exact in float64, so one add and one rounding
    give the fused multiply-add."""
    partner = x[np.arange(x.shape[-1]) ^ 1]
    return (x.astype(np.float64) * cos
            + (partner * sin).astype(np.float32)).astype(np.float32)


def b4_split_rule(qkv, kc, vc, n_past, cos, sin, hd, scale, cache):
    """The kernel's rule for one sequence and one head in numpy: q and k_new
    roped in f32; chunks of b10_splits(S) over rows s < n_past (one chunk,
    empty, when there are none); per chunk m_i = max score (scores from
    T(q)), p = exp(score - m_i) in f32, l_i = sum p, c_i = sum T(p) V; the
    chunks merged in order 8 at a time (as for B10), then the new token as
    one more partial (s_new, 1, v_new), unrounded. Returns (ctx [hd], the
    written row T(k_new), T(v_new))."""
    q, k, v = qkv[:hd], qkv[hd:2 * hd], qkv[2 * hd:]
    qr, kr = _rope_f32(q, cos, sin), _rope_f32(k, cos, sin)
    qv = _round_to(qr, cache)
    s_len = kc.shape[0]
    n = min(max(n_past, 0), s_len)
    splits, chunk = tda.b10_splits(s_len)
    act = max(1, -(-n // chunk))
    parts = []
    for i in range(act):
        rows = np.arange(i * chunk, min((i + 1) * chunk, n))
        if rows.size == 0:
            parts.append((-np.inf, 0.0, np.zeros(hd)))
            continue
        sc = (kc[rows] @ qv * scale).astype(np.float32)
        m = sc.max()
        p = np.exp(sc - m, dtype=np.float32)
        parts.append((float(m), float(p.sum(dtype=np.float64)),
                      _round_to(p, cache) @ vc[rows]))
    s_new = float(np.dot(qr.astype(np.float64), kr) * scale)
    if act == 1:
        m, l, c = parts[0]
        big = max(m, s_new)
        a, e = np.exp(m - big), np.exp(s_new - big)
        return (c * a + e * v) / (l * a + e), _round_to(kr, cache), \
            _round_to(v, cache)
    big, l_tot, ctx = -np.inf, 0.0, np.zeros(hd)
    for i0 in range(0, act, 8):
        batch = parts[i0:i0 + 8]
        mb = max([big] + [m for m, _, _ in batch])
        r = np.exp(big - mb)
        l_tot, ctx = l_tot * r, ctx * r
        for m, l, c in batch:
            e = np.exp(m - mb)
            l_tot += l * e
            ctx = ctx + c * e
        big = mb
    mb = max(big, s_new)
    r, e = np.exp(big - mb), np.exp(s_new - mb)
    return ((ctx * r + e * v) / (l_tot * r + e), _round_to(kr, cache),
            _round_to(v, cache))


B4_S = 576          # 9 chunks of 64: two merge batches


@pytest.mark.parametrize("n_past", [0, 1, 63, 64, 65, B4_S - 1, B4_S,
                                    B4_S + 88])
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_b4_split_rule_equals_plain_and_pallas(n_past, cache):
    """B4's split-key rule (b4_split_rule) equals the plain B4, and the
    plain B4 equals _fused_kernel_grouped in interpret mode, within 2^-7 of
    the largest output for bf16 caches (each chunk rounds its own p =
    exp(score - chunk max) to bf16 where the unsplit kernel rounds exp(score
    - max): one bf16 rounding of each p moves) and 5e-5 for f32 caches (f32
    rounding and sum order); the written K/V rows are equal bit for bit on
    all three, at the depths where chunks begin and end, the last row, and
    past S (an inactive slot: all S rows attended, row S - 1 written)."""
    b, h, hd = 1, 2, 128
    f = h * hd
    qkv, kc, vc = inputs(b, B4_S, f, seed=40 + n_past)
    # the caches before the step (the step writes row S - 1, which it
    # attends, at n_past >= S)
    kcr, vcr = _round_to(kc[0], cache), _round_to(vc[0], cache)
    ctx, k, v, jctx, jk, jv = run_both(qkv, kc, vc, [n_past], hd, hd, cache)
    tol = (2 ** -7 if cache == "bfloat16" else 5e-5) * np.abs(ctx).max()
    np.testing.assert_allclose(ctx, jctx, rtol=0, atol=tol)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(v, jv)
    w = min(n_past, B4_S - 1)
    # the tables run_both fed to both kernels
    cos, sin = (np.asarray(t)[0] for t in jax_tables(
        jnp.asarray([n_past], jnp.int32), hd, hd))
    for i in range(h):
        c = slice(i * hd, (i + 1) * hd)
        got, k_row, v_row = b4_split_rule(
            qkv[0, 0].reshape(3, f)[:, c].reshape(-1), kcr[:, c], vcr[:, c],
            n_past, cos, sin, hd, 1.0 / math.sqrt(hd), cache)
        np.testing.assert_allclose(got, ctx[0, 0, c], rtol=0, atol=tol)
        np.testing.assert_array_equal(k_row, k[0, w, c])
        np.testing.assert_array_equal(v_row, v[0, w, c])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [512, 576])
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_b4_split_kernel_matches_plain_at_every_depth(cuda_device, cache, s):
    """Eight slots at the depths where chunks begin and end, the last row
    and past S (S = 576: two merge batches); 2^-7 (bf16) or 5e-5 (f32) of
    the largest output, caches equal bit for bit after the call, the same
    output and caches run to run."""
    depths = [0, 1, 63, 64, 65, 300, s - 1, s + 88]
    b, hd, h = len(depths), 128, 2
    dt = getattr(torch, cache)
    qkv, kc, vc = inputs(b, s, h * hd, seed=41)
    qkv = torch.from_numpy(qkv).to(cuda_device)
    kc = torch.from_numpy(kc).to(cuda_device).to(dt)
    vc = torch.from_numpy(vc).to(cuda_device).to(dt)
    n = torch.tensor(depths, dtype=torch.int32, device=cuda_device)
    cos, sin = tda.rope_lane_tables(n, hd, hd)
    kw = dict(head_dim=hd, n_rot=hd, scale=1 / math.sqrt(hd))
    caches = [(kc.clone(), vc.clone()) for _ in range(3)]
    got = tda.decode_attention_fused(qkv, *caches[0], n, cos, sin, **kw)
    again = tda.decode_attention_fused(qkv, *caches[1], n, cos, sin, **kw)
    want = tda.decode_attention_fused_plain(qkv, *caches[2], n, cos, sin,
                                            **kw)
    assert torch.isfinite(got).all()
    rel = 2 ** -7 if cache == "bfloat16" else 5e-5
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel * want.abs().max().item())
    assert all(torch.equal(a, c) for a, c in zip(caches[0], caches[2]))
    assert torch.equal(got, again)
    assert all(torch.equal(a, c) for a, c in zip(caches[0], caches[1]))
