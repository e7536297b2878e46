"""PyTorch port: the paged KV cache (engine/paged_kv.py), the plain versions
of kernels B6, B7 and B8 against the Pallas kernels in interpret mode, and
the paged forward passes against the JAX package's."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastllama_tpu.config import HyperParams
from fastllama_tpu.engine import paged_kv as jpk
from fastllama_tpu.kernels import kv_write as jkw
from fastllama_tpu.kernels import paged_attention as jpa
from fastllama_tpu.models import llama as jl
from fastllama_tpu_torch.engine import paged_kv as tpk
from fastllama_tpu_torch.kernels import kv_write as tkw
from fastllama_tpu_torch.kernels import paged_attention as tpa
from fastllama_tpu_torch.models import llama as tl

from test_torch_model import to_numpy_tree
from test_torch_scheduler import HP, jax_params

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def to_t(a, dtype=None):
    """numpy or JAX array -> torch tensor (bf16 through f32, exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def f32(t):
    return t.to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# the allocator, on both packages
# ---------------------------------------------------------------------------

def manager(side, **kw):
    hp = HyperParams(n_vocab=64, n_embd=64, n_head=4, n_layer=2, n_rot=16)
    if side == "jax":
        return jpk.PagedKVManager(hp, dtype=jnp.float32, **kw)
    return tpk.PagedKVManager(hp, dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_allocator_alloc_free(side):
    m = manager(side, n_slots=3, page_size=8, total_pages=6, pages_per_seq=3)
    assert m.free_pages == 6 and m.sentinel == 6
    assert tuple(m.k_pages[0].shape) == (4, 7, 8, 16)   # + the trash page
    assert m.alloc_for(0, 1)          # 1 page
    assert m.alloc_for(0, 8)          # still 1 page
    assert m.alloc_for(0, 9)          # 2 pages
    assert m.free_pages == 4
    assert m.alloc_for(1, 24)         # 3 pages
    assert m.free_pages == 1
    assert not m.alloc_for(2, 16)     # needs 2, only 1 free: nothing taken
    assert m.free_pages == 1
    m.free_slot(1)
    assert m.free_pages == 4
    assert m.alloc_for(2, 16)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_allocator_pages_per_seq_cap(side):
    m = manager(side, n_slots=1, page_size=8, total_pages=16,
                pages_per_seq=2)
    assert m.alloc_for(0, 16)
    assert not m.alloc_for(0, 17)     # over the per-sequence cap


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_token_page_offsets(side):
    m = manager(side, n_slots=1, page_size=4, total_pages=8, pages_per_seq=4)
    assert m.alloc_for(0, 10)
    pages, offs = m.token_page_offsets(0, 2, 6)   # tokens 2..7
    assert list(offs) == [2, 3, 0, 1, 2, 3]
    assert pages.dtype == np.int32 and offs.dtype == np.int32
    assert pages[0] == pages[1] == m.page_tables[0, 0]
    assert pages[2] == pages[5] == m.page_tables[0, 1]


def test_allocators_hand_out_the_same_pages():
    """The same calls give the same tables on both packages (the engines'
    streams depend on nothing else of the allocator)."""
    ms = [manager(s, n_slots=3, page_size=8, total_pages=9, pages_per_seq=4)
          for s in ("jax", "torch")]
    for m in ms:
        m.alloc_for(0, 20)
        m.alloc_for(2, 9)
        m.free_slot(0)
        m.alloc_for(1, 30)
        m.alloc_for(2, 17)
    np.testing.assert_array_equal(ms[0].page_tables, ms[1].page_tables)
    assert ms[0].free_pages == ms[1].free_pages


def test_load_from_numpy_rebuilds_the_allocator():
    rng = np.random.default_rng(2)
    jm = manager("jax", n_slots=2, page_size=8, total_pages=6,
                 pages_per_seq=3)
    jm.alloc_for(0, 10)
    jm.alloc_for(1, 3)
    jm.lengths[:] = [10, 3]
    jm.k_pages = [jnp.asarray(rng.standard_normal(p.shape), jnp.float32)
                  for p in jm.k_pages]
    tm = manager("torch", n_slots=2, page_size=8, total_pages=6,
                 pages_per_seq=3)
    tm.load_from_numpy([np.asarray(p) for p in jm.k_pages],
                       [np.asarray(p) for p in jm.v_pages], jm.page_tables,
                       jm.lengths)
    np.testing.assert_array_equal(tm.k_pages[1].numpy(),
                                  np.asarray(jm.k_pages[1]))
    assert tm.free_pages == jm.free_pages == 3
    assert tm.alloc_for(0, 17) and jm.alloc_for(0, 17)
    np.testing.assert_array_equal(tm.page_tables, jm.page_tables)
    tm.free_slot(0)
    assert tm.free_pages == 5


# ---------------------------------------------------------------------------
# write_tokens_paged, B7 and B8
# ---------------------------------------------------------------------------

def test_write_tokens_paged_matches_jax():
    """The scatter with ids past the pool dropped: several tokens, one
    dropped in the middle, one sequence dropped whole."""
    rng = np.random.default_rng(0)
    h, p, ps, d = 2, 6, 4, 8
    kp = rng.standard_normal((h, p, ps, d)).astype(np.float32)
    vp = rng.standard_normal((h, p, ps, d)).astype(np.float32)
    k_new = rng.standard_normal((2, 3, h, d)).astype(np.float32)
    v_new = rng.standard_normal((2, 3, h, d)).astype(np.float32)
    pids = np.array([[3, 6, 1], [9, 9, 9]], np.int32)      # 6, 9: dropped
    offs = np.array([[0, 2, 3], [1, 1, 1]], np.int32)
    want = jpk.write_tokens_paged(*(jnp.asarray(a) for a in (
        kp, vp, k_new, v_new, pids, offs)))
    tk, tv = to_t(kp), to_t(vp)
    got = tpk.write_tokens_paged(tk, tv, to_t(k_new), to_t(v_new),
                                 to_t(pids), to_t(offs))
    assert got[0] is tk and got[1] is tv                   # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want[1]))
    # nothing kept: the pools stay as they are
    tk2 = to_t(kp)
    tpk.write_tokens_paged(tk2, to_t(vp), to_t(k_new), to_t(v_new),
                           to_t(np.full((2, 3), 7, np.int32)), to_t(offs))
    np.testing.assert_array_equal(tk2.numpy(), kp)


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_b7_plain_matches_pallas_and_scatter(pool):
    """paged_kv_write's plain version against the Pallas kernel (interpret
    mode) and the scatter: every page but the trash page bit for bit."""
    rng = np.random.default_rng(3)
    h, p, ps, d = 4, 5, 16, 128        # page 4 = trash (sentinel id)
    b = 4
    jdt = getattr(jnp, pool)
    kp = jnp.asarray(rng.standard_normal((h, p, ps, d)), jdt)
    vp = jnp.asarray(rng.standard_normal((h, p, ps, d)), jdt)
    k_new = rng.standard_normal((b, h, d)).astype(np.float32)
    v_new = rng.standard_normal((b, h, d)).astype(np.float32)
    pids = np.array([1, 3, 4, 4], np.int32)     # slots 2, 3 inactive
    offs = np.array([9, 3, 7, 7], np.int32)

    pk, pv = jkw.paged_kv_write(kp, vp, jnp.asarray(k_new),
                                jnp.asarray(v_new), jnp.asarray(pids),
                                jnp.asarray(offs), interpret=True)
    sk, sv = jpk.write_tokens_paged(
        kp, vp, jnp.asarray(k_new)[:, None], jnp.asarray(v_new)[:, None],
        jnp.asarray(pids)[:, None], jnp.asarray(offs)[:, None])
    tk, tv = to_t(kp), to_t(vp)
    out = tkw.paged_kv_write(tk, tv, to_t(k_new), to_t(v_new), to_t(pids),
                             to_t(offs))
    assert out[0] is tk and out[1] is tv
    for got, pal, sc in ((tk, pk, sk), (tv, pv, sv)):
        np.testing.assert_array_equal(f32(got)[:, :4], f32(to_t(pal))[:, :4])
        np.testing.assert_array_equal(f32(got)[:, :4], f32(to_t(sc))[:, :4])
    np.testing.assert_array_equal(
        f32(tk)[:, 1, 9], f32(to_t(k_new[0]).to(getattr(torch, pool))))


def test_b7_drops_ids_outside_the_pool():
    rng = np.random.default_rng(4)
    h, p, ps, d = 2, 3, 4, 8
    kp = to_t(rng.standard_normal((h, p, ps, d)).astype(np.float32))
    vp = kp.clone()
    before = kp.clone()
    new = to_t(rng.standard_normal((3, h, d)).astype(np.float32))
    tkw.paged_kv_write(kp, vp, new, new, to_t(np.array([3, -1, 7], np.int32)),
                       to_t(np.array([0, 1, 2], np.int32)))
    assert torch.equal(kp, before) and torch.equal(vp, before)
    tkw.paged_kv_write(kp, vp, new, new, to_t(np.array([3, 1, 7], np.int32)),
                       to_t(np.array([0, 1, 2], np.int32)))
    assert torch.equal(kp[:, 1, 1], new[1])
    assert int((kp != before).any(-1).sum()) == h          # one row per head


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_b8_plain_matches_pallas_and_scatter(pool):
    """paged_kv_write_rows' plain version against the Pallas kernel
    (interpret mode) and the scatter; a sentinel block lands in the trash
    page, every other page bit for bit."""
    rng = np.random.default_rng(1)
    h, p, ps, d = 4, 6, 8, 128          # page 5 = trash
    jdt = getattr(jnp, pool)
    kp = jnp.asarray(rng.standard_normal((h, p, ps, d)), jdt)
    vp = jnp.asarray(rng.standard_normal((h, p, ps, d)), jdt)
    t = 32
    rows_k = jnp.asarray(rng.standard_normal((t, h * d)), jdt)
    rows_v = jnp.asarray(rng.standard_normal((t, h * d)), jdt)
    block_pages = np.array([2, 0, 5, 4], np.int32)
    pk, pv = jkw.paged_kv_write_rows(kp, vp, rows_k, rows_v,
                                     jnp.asarray(block_pages),
                                     interpret=True)
    pages = np.repeat(block_pages, ps)[None, :]
    offs = np.tile(np.arange(ps, dtype=np.int32), 4)[None, :]
    sk, sv = jpk.write_tokens_paged(
        kp, vp, rows_k.reshape(1, t, h, d), rows_v.reshape(1, t, h, d),
        jnp.asarray(pages), jnp.asarray(offs))
    tk, tv = to_t(kp), to_t(vp)
    out = tkw.paged_kv_write_rows(tk, tv, to_t(rows_k), to_t(rows_v),
                                  to_t(block_pages))
    assert out[0] is tk and out[1] is tv
    for got, pal, sc in ((tk, pk, sk), (tv, pv, sv)):
        np.testing.assert_array_equal(f32(got)[:, :5], f32(to_t(pal))[:, :5])
        np.testing.assert_array_equal(f32(got)[:, :5], f32(to_t(sc))[:, :5])
    # an id past the pool writes nothing
    tk2 = to_t(kp)
    tkw.paged_kv_write_rows(tk2, to_t(vp), to_t(rows_k), to_t(rows_v),
                            to_t(np.array([6, 9, -1, 60], np.int32)))
    np.testing.assert_array_equal(f32(tk2), f32(to_t(kp)))


def test_write_wrappers_reject_wrong_shapes():
    kp = torch.zeros((2, 3, 4, 8))
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="f32"):
        tkw.paged_kv_write(kp, kp.clone(), torch.zeros((2, 2, 8),
                           dtype=torch.bfloat16), torch.zeros((2, 2, 8)),
                           ids, ids)
    with pytest.raises(ValueError, match="multiple of the page size"):
        tkw.paged_kv_write_rows(kp, kp.clone(), torch.zeros((6, 16)),
                                torch.zeros((6, 16)), ids)
    with pytest.raises(ValueError, match="pools must match"):
        tkw.paged_kv_write(kp, kp.to(torch.bfloat16), torch.zeros((2, 2, 8)),
                           torch.zeros((2, 2, 8)), ids, ids)


# ---------------------------------------------------------------------------
# B6
# ---------------------------------------------------------------------------

def attention_case(pool, seed=7):
    rng = np.random.default_rng(seed)
    h, d, ps, pages, pp, b = 4, 128, 8, 24, 4, 5
    jdt = getattr(jnp, pool)
    kp = jnp.asarray(rng.standard_normal((h, pages, ps, d)), jdt)
    vp = jnp.asarray(rng.standard_normal((h, pages, ps, d)), jdt)
    tables = rng.permutation(pages)[: b * pp].reshape(b, pp).astype(np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    lengths = np.array([5, 1, 32, 8, 7], np.int32)   # partial/single/full
    return q, kp, vp, lengths, tables


@pytest.mark.parametrize("pool,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("group_size", [0, 2])
def test_b6_plain_matches_pallas(pool, tol, group_size):
    """paged_decode_attention's plain version against the Pallas kernel in
    interpret mode, double-buffered (group_size 0) and single-bank with two
    heads per cell. f32 pools: 1e-5. bf16 pools: both cast q and p to bf16
    before the dots, but XLA's and PyTorch's exp differ by an f32 ulp, which
    can move a rounded p by one bf16 ulp (2^-8 relative): 2e-2 absolute on
    outputs of order 1."""
    q, kp, vp, lengths, tables = attention_case(pool)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), kp, vp, jnp.asarray(lengths), jnp.asarray(tables),
        group_size=group_size, interpret=True))
    got = tpa.paged_decode_attention(to_t(q), to_t(kp), to_t(vp),
                                     to_t(lengths), to_t(tables)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_b6_plain_matches_the_references_at_f32():
    q, kp, vp, lengths, tables = attention_case("float32", seed=8)
    want = np.asarray(jpk.paged_attention_reference(
        jnp.asarray(q), kp, vp, jnp.asarray(lengths), jnp.asarray(tables)))
    args = (to_t(q), to_t(kp), to_t(vp), to_t(lengths), to_t(tables))
    np.testing.assert_allclose(tpa.paged_decode_attention(*args).numpy(),
                               want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tpk.paged_attention_reference(*args).numpy(),
                               want, rtol=1e-5, atol=1e-5)


def test_b6_plain_length_zero_and_stale_pages():
    """A sequence of length 0 yields zeros, and nothing in a page past the
    length (NaN here) reaches the output."""
    q, kp, vp, lengths, tables = attention_case("float32", seed=9)
    lengths = np.array([0, 1, 9, 8, 3], np.int32)
    tk, tv = to_t(kp), to_t(vp)
    used = set()
    for row, n in zip(tables, lengths):
        used.update(row[:-(-int(n) // 8)].tolist() if n else [])
    stale = [p for p in range(tk.shape[1]) if p not in used]
    clean = tpa.paged_decode_attention(to_t(q), tk, tv, to_t(lengths),
                                       to_t(tables))
    tk[:, stale] = float("nan")
    tv[:, stale] = float("nan")
    got = tpa.paged_decode_attention(to_t(q), tk, tv, to_t(lengths),
                                     to_t(tables))
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)
    assert (got[0] == 0).all()


def test_b6_wrapper_rejects_wrong_types():
    q, kp, vp, lengths, tables = attention_case("float32")
    with pytest.raises(ValueError, match="lengths"):
        tpa.paged_decode_attention(to_t(q), to_t(kp), to_t(vp),
                                   to_t(lengths).long(), to_t(tables))
    with pytest.raises(ValueError, match="pools must match"):
        tpa.paged_decode_attention(to_t(q), to_t(kp)[:2], to_t(vp),
                                   to_t(lengths), to_t(tables))


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_b6_kernel_matches_plain(cuda_device, pool):
    q, kp, vp, lengths, tables = attention_case(pool)
    lengths[0] = 0
    args = [to_t(a).to(cuda_device) for a in (q, kp, vp, lengths, tables)]
    got = tpa.paged_decode_attention(*args)
    want = tpa.paged_decode_attention_plain(*args)
    tol = 2e-2 if pool == "bfloat16" else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert (got[0] == 0).all()


# ---------------------------------------------------------------------------
# B6's split over the keys (csrc/paged_attention.cu) and its plan
# ---------------------------------------------------------------------------

def _as_pool(a, pool):
    """f32 numpy values rounded to the pool dtype (and back to f32)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, pool)).to(torch.float32).numpy()


def b6_split_rule(q, kp, vp, length, table, chunk, pool):
    """The card kernel's arithmetic for one sequence, in numpy f32: q [H, D],
    pools [H, P, ps, D] holding pool-dtype values. Keys are cut into chunks
    of `chunk` rows; chunk c has its own max m_c, p = exp(score - m_c) cast
    to the pool dtype for the PV dot and l_c the sum of the unrounded p;
    the partials merge in chunk order, 8 at a time (two-pass within a
    batch, rescaled by the running max across batches), and ctx = C /
    max(L, 1e-30). Only rows < length of pages the table names are read."""
    h, p, ps, d = kp.shape
    n = int(np.clip(length, 0, table.shape[0] * ps))
    scale = np.float32(1.0 / np.sqrt(d))
    pages = np.clip(table, 0, p - 1)
    rows = [(pages[s // ps], s % ps) for s in range(n)]
    qr = _as_pool(q, pool)
    out = np.zeros((h, d), np.float32)
    for hh in range(h):
        parts = []
        for s0 in range(0, max(n, 1), chunk):
            rr = rows[s0:s0 + chunk]
            if not rr:
                parts.append((np.float32(-np.inf), np.float32(0),
                              np.zeros(d, np.float32)))
                continue
            k = np.stack([kp[hh, a, b] for a, b in rr])
            v = np.stack([vp[hh, a, b] for a, b in rr])
            sc = (k @ qr[hh]).astype(np.float32) * scale
            m = sc.max()
            pr = np.exp(sc - m).astype(np.float32)
            parts.append((m, pr.sum(dtype=np.float32),
                          (_as_pool(pr, pool) @ v).astype(np.float32)))
        big_m, big_l, big_c = np.float32(-np.inf), np.float32(0), 0.0
        for i0 in range(0, len(parts), 8):
            batch = parts[i0:i0 + 8]
            mb = max([big_m] + [m for m, _, _ in batch])
            r = np.exp(np.float32(big_m - mb)) if big_m > -np.inf else 0
            big_l, big_c = big_l * r, big_c * r
            for m, l, c in batch:
                e = np.exp(np.float32(m - mb)) if m > -np.inf else 0
                big_l, big_c = big_l + l * e, big_c + c * e
            big_m = mb
        out[hh] = big_c / max(big_l, np.float32(1e-30))
    return out


def split_case(pool, seed=61):
    """Six sequences at the page and chunk edges over a shuffled table of
    64-row pages (+ the trash page), 10 pages each (ten 64-row chunks: two
    merge batches); NaN in every page no sequence reaches."""
    rng = np.random.default_rng(seed)
    h, d, ps, pp = 2, 128, 64, 10
    lengths = np.array([0, 1, ps - 1, ps, ps + 1, pp * ps], np.int32)
    b = len(lengths)
    p = b * pp + 1
    kp = _as_pool(rng.standard_normal((h, p, ps, d)), pool)
    vp = _as_pool(rng.standard_normal((h, p, ps, d)), pool)
    tables = rng.permutation(b * pp).reshape(b, pp).astype(np.int32)
    used = {int(pg) for row, n in zip(tables, lengths)
            for pg in row[:-(-int(n) // ps)]}
    stale = [pg for pg in range(p) if pg not in used]
    kq, vq = kp.copy(), vp.copy()
    kq[:, stale] = np.nan
    vq[:, stale] = np.nan
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, kp, vp, kq, vq, lengths, tables


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_b6_split_rule_equals_plain_and_pallas(pool):
    """B6's split-key rule (b6_split_rule, 64-row chunks as b6_plan gives
    for 64-row pages) equals the plain B6, and the plain B6 equals the
    Pallas kernel in interpret mode, at lengths 0, 1, ps - 1, ps, ps + 1 and
    pp * ps: within 2^-7 of the largest output for bf16 pools (each chunk
    rounds its own p = exp(score - chunk max) to bf16 where the unsplit
    kernels round exp(score - max): one bf16 rounding of each p moves) and
    5e-5 for f32 pools (f32 rounding and sum order). The rule and the
    plain version read pools with NaN in every page no sequence reaches."""
    q, kp, vp, kq, vq, lengths, tables = split_case(pool)
    jdt = getattr(jnp, pool)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(lengths), jnp.asarray(tables), interpret=True))
    dt = getattr(torch, pool)
    plain = tpa.paged_decode_attention(
        to_t(q), to_t(kq).to(dt), to_t(vq).to(dt), to_t(lengths),
        to_t(tables)).numpy()
    assert np.isfinite(plain).all() and (plain[0] == 0).all()
    tol = (2 ** -7 if pool == "bfloat16" else 5e-5) * np.abs(want).max()
    np.testing.assert_allclose(plain, want, rtol=0, atol=tol)
    assert tpa.b6_plan(10, 64, 128, 2 if pool == "bfloat16" else 4) == (
        10, 64)
    for i, n in enumerate(lengths):
        got = b6_split_rule(q[i], kq, vq, n, tables[i], 64, pool)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, plain[i], rtol=0, atol=tol)
    assert (b6_split_rule(q[0], kq, vq, 0, tables[0], 64, pool) == 0).all()


@pytest.mark.parametrize("ps", [1, 8, 16, 48, 64, 128, 256])
@pytest.mark.parametrize("pp", [1, 3, 8, 64])
def test_b6_plan_covers_every_row_once(ps, pp):
    """b6_plan's chunks cover the pp * ps rows once, each a multiple of the
    page size or a divisor of it (a page lookup per page), at most 256 rows
    and K and V of a chunk within the shared-memory cap, for head dims 64,
    128 (7B, 13B) and 256 and both pool types; the engine's shape (8 pages
    of 64 rows) gives 64-row chunks. The plan reads no head count: the grid
    is (H, B, splits), so 32 and 40 heads split alike."""
    s = pp * ps
    for d in (64, 128, 256):
        for isz in (2, 4):
            splits, chunk = tpa.b6_plan(pp, ps, d, isz)
            assert 1 <= chunk <= tpa.B6_MAX_CHUNK
            assert chunk % ps == 0 or ps % chunk == 0
            assert 2 * chunk * d * isz <= tpa.B6_SMEM_CAP
            assert splits == -(-s // chunk) and splits <= 12288
            covered = [r for c in range(splits)
                       for r in range(c * chunk, min((c + 1) * chunk, s))]
            assert covered == list(range(s))
            if s >= tpa.B6_CHUNK and d * isz <= 512:
                assert chunk >= min(tpa.B6_CHUNK, s) or ps % chunk == 0
    assert tpa.b6_plan(8, 64, 128, 2) == (8, 64)       # the engine, bf16
    assert tpa.b6_plan(8, 64, 128, 4) == (8, 64)       # f32 pools


# ---------------------------------------------------------------------------
# B11: flat-lane pools [P, ps, H*D]
# ---------------------------------------------------------------------------

def flat_case(pool, seed=31):
    """Five sequences over a shuffled table of flat-lane pools (+ the trash
    page): lengths 0, partial, pp * ps (every page), and table entries that
    are read holding the sentinel (the trash page) and an id past the pool
    (clipped into it on both packages)."""
    rng = np.random.default_rng(seed)
    h, d, ps, pp, b = 4, 128, 8, 4, 5
    p = b * pp + 1
    jdt = getattr(jnp, pool)
    kp = jnp.asarray(rng.standard_normal((p, ps, h * d)), jdt)
    vp = jnp.asarray(rng.standard_normal((p, ps, h * d)), jdt)
    tables = rng.permutation(b * pp).reshape(b, pp).astype(np.int32)
    tables[1, 0] = p - 1
    tables[4, 1] = p + 5
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    lengths = np.array([0, 3, pp * ps, 9, 17], np.int32)
    return q, kp, vp, lengths, tables


@pytest.mark.parametrize("pool,tol", [("float32", 5e-5), ("bfloat16", 2 ** -7)])
@pytest.mark.parametrize("group_size", [0, 1])
def test_b11_plain_matches_pallas(pool, tol, group_size):
    """paged_decode_attention_flat's plain version against the Pallas kernel
    in interpret mode. Tolerance relative to the largest output: f32 pools
    5e-5 (exp and the sum order); bf16 pools 2^-7, since both cast p to bf16
    before the PV dot and XLA's and PyTorch's exp differ by an f32 ulp, which
    can move a rounded p by one bf16 ulp (2^-8)."""
    q, kp, vp, lengths, tables = flat_case(pool)
    want = np.asarray(jpa.paged_decode_attention_flat(
        jnp.asarray(q), kp, vp, jnp.asarray(lengths), jnp.asarray(tables),
        group_size=group_size, interpret=True))
    got = tpa.paged_decode_attention_flat(
        to_t(q), to_t(kp), to_t(vp), to_t(lengths), to_t(tables)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
    assert (got[0] == 0).all()


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_b11_plain_equals_b6_on_the_transpose(pool):
    """B11 over flat pools is B6 over the head-major copy, bit for bit, and
    NaN in every page no sequence reaches stays out of the output."""
    q, kp, vp, lengths, tables = flat_case(pool, seed=32)
    tk, tv = to_t(kp), to_t(vp)
    h = q.shape[1]
    hk, hv = (tpa.head_major(x, h).contiguous() for x in (tk, tv))
    want = tpa.paged_decode_attention(to_t(q), hk, hv, to_t(lengths),
                                      to_t(tables))
    used = set()
    for row, n in zip(tables, lengths):
        used.update(np.clip(row[:-(-int(n) // 8)], 0, tk.shape[0] - 1)
                    .tolist() if n else [])
    stale = [p for p in range(tk.shape[0]) if p not in used]
    tk[stale] = float("nan")
    tv[stale] = float("nan")
    got = tpa.paged_decode_attention_flat(to_t(q), tk, tv, to_t(lengths),
                                          to_t(tables))
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_b11_wrapper_rejects_wrong_shapes_and_types():
    q, kp, vp, lengths, tables = flat_case("float32")
    args = [to_t(a) for a in (q, kp, vp, lengths, tables)]
    with pytest.raises(ValueError, match="pools must match"):
        tpa.paged_decode_attention_flat(args[0], args[1][..., :256],
                                        *args[2:])
    with pytest.raises(ValueError, match="pools must match"):
        tpa.paged_decode_attention_flat(args[0], args[1],
                                        args[2].to(torch.bfloat16), *args[3:])
    with pytest.raises(ValueError, match="pools must match"):   # head-major
        tpa.paged_decode_attention_flat(
            args[0], *(tpa.head_major(x, 4) for x in args[1:3]), *args[3:])
    with pytest.raises(ValueError, match="q must be f32"):
        tpa.paged_decode_attention_flat(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="lengths"):
        tpa.paged_decode_attention_flat(*args[:3], args[3].long(), args[4])
    with pytest.raises(ValueError, match="page_indices"):
        tpa.paged_decode_attention_flat(*args[:4], args[4][:, None])


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_b11_kernel_matches_plain_and_b6(cuda_device, pool):
    q, kp, vp, lengths, tables = flat_case(pool)
    args = [to_t(a).to(cuda_device) for a in (q, kp, vp, lengths, tables)]
    got = tpa.paged_decode_attention_flat(*args)
    want = tpa.paged_decode_attention_flat_plain(*args)
    tol = (2 ** -7 if pool == "bfloat16" else 5e-5) * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert (got[0] == 0).all()
    hk, hv = (tpa.head_major(x, 4).contiguous() for x in args[1:3])
    assert torch.equal(got, tpa.paged_decode_attention(args[0], hk, hv,
                                                       *args[3:]))


@pytest.mark.cuda
@pytest.mark.parametrize("ps,pp", [(64, 10), (16, 24), (128, 3)])
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_b6_b11_split_kernels_at_every_page_edge(cuda_device, pool, ps, pp):
    """B6 and B11 on the card against their plain versions at every page
    and chunk edge (64-row chunks: whole pages of 16 and 64 rows, half
    pages of 128), NaN in every page no sequence reaches, q a strided view
    as the forward passes it: 2^-7 (bf16) or 5e-5 (f32) of the largest
    output; B11 on the flat-lane transpose equal to B6 bit for bit; B6
    equal run to run; a sequence of length 0 gives zeros."""
    rng = np.random.default_rng(71)
    h, d = 4, 128
    s = pp * ps
    lengths = sorted({0, 1, ps - 1, ps, ps + 1, 63, 64, 65, s - 1, s})
    b = len(lengths)
    dt = getattr(torch, pool)
    p = b * pp + 1
    kp, vp = (torch.from_numpy(rng.standard_normal((h, p, ps, d)).astype(
        np.float32)).to(dt).to(cuda_device) for _ in range(2))
    tables = torch.from_numpy(rng.permutation(b * pp).reshape(b, pp).astype(
        np.int32)).to(cuda_device)
    used = torch.zeros(p, dtype=torch.bool, device=cuda_device)
    for row, n in zip(tables.tolist(), lengths):
        if n:
            used[row[:-(-n // ps)]] = True
    kq, vq = kp.clone(), vp.clone()
    kq[:, ~used] = float("nan")
    vq[:, ~used] = float("nan")
    wide = torch.from_numpy(rng.standard_normal((b, 2 * h, d)).astype(
        np.float32)).to(cuda_device)
    q = wide[:, h:]
    n = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    got = tpa.paged_decode_attention(q, kq, vq, n, tables)
    want = tpa.paged_decode_attention_plain(q, kp, vp, n, tables)
    tol = (2 ** -7 if pool == "bfloat16" else 5e-5) * want.abs().max().item()
    assert torch.isfinite(got).all() and (got[0] == 0).all()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert torch.equal(got, tpa.paged_decode_attention(q, kq, vq, n, tables))
    assert torch.equal(got, tpa.paged_decode_attention(q.contiguous(), kq, vq,
                                                       n, tables))
    flat = [x.permute(1, 2, 0, 3).reshape(p, ps, h * d).contiguous()
            for x in (kq, vq)]
    got11 = tpa.paged_decode_attention_flat(q, *flat, n, tables)
    assert torch.equal(got11, got)
    torch.testing.assert_close(
        got11, tpa.paged_decode_attention_flat_plain(
            q, *(x.permute(1, 2, 0, 3).reshape(p, ps, h * d).contiguous()
                 for x in (kp, vp)), n, tables), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_b7_b8_kernels_match_plain(cuda_device, pool):
    rng = np.random.default_rng(12)
    h, p, ps, d = 4, 6, 8, 128
    dt = getattr(torch, pool)
    pools = [to_t(rng.standard_normal((h, p, ps, d)).astype(np.float32))
             .to(dt).to(cuda_device) for _ in range(2)]
    ref = [x.clone() for x in pools]
    new = [to_t(rng.standard_normal((3, h, d)).astype(np.float32))
           .to(cuda_device) for _ in range(2)]
    pids = to_t(np.array([2, 5, 9], np.int32)).to(cuda_device)
    offs = to_t(np.array([7, 0, 1], np.int32)).to(cuda_device)
    tkw.paged_kv_write(*pools, *new, pids, offs)
    tkw.paged_kv_write_plain(*ref, *new, pids, offs)
    rows = [to_t(rng.standard_normal((16, h * d)).astype(np.float32)).to(dt)
            .to(cuda_device) for _ in range(2)]
    blocks = to_t(np.array([4, 5], np.int32)).to(cuda_device)
    tkw.paged_kv_write_rows(*pools, *rows, blocks)
    tkw.paged_kv_write_rows_plain(*ref, *rows, blocks)
    for got, want in zip(pools, ref):
        assert torch.equal(got[:, :5], want[:, :5])


# ---------------------------------------------------------------------------
# the fused paged step: RoPE + B7's write + B6's attention in one kernel
# ---------------------------------------------------------------------------

def fused_case(pool, lengths, h=2, seed=71):
    """qkv, head-major pools of 64-row pages (+ the trash page) over a
    shuffled table of pp = 10 pages a sequence, each active slot's write at
    its table's row `length`, the last slot inactive (sentinel page, length
    0), NaN in every page no slot reads, per-row RoPE lanes (n_rot =
    D / 2) at the lengths. numpy f32 arrays, the pools' values rounded to
    the pool dtype."""
    rng = np.random.default_rng(seed)
    d, ps, pp = 128, 64, 10
    lengths = np.array(list(lengths) + [0], np.int32)
    b = len(lengths)
    p = b * pp + 1
    kp = _as_pool(rng.standard_normal((h, p, ps, d)), pool)
    vp = _as_pool(rng.standard_normal((h, p, ps, d)), pool)
    tables = rng.permutation(b * pp).reshape(b, pp).astype(np.int32)
    page_ids = np.array([tables[i, n // ps] for i, n in enumerate(lengths)],
                        np.int32)
    page_ids[-1] = p - 1
    offsets = (lengths % ps).astype(np.int32)
    # the pages each slot's plain step reads (the inactive slot's plain B6
    # reads one row of its first page)
    used = {int(pg) for row, n in zip(tables, lengths)
            for pg in row[:int(n) // ps + 1]}
    stale = [pg for pg in range(p - 1) if pg not in used]
    kp[:, stale] = np.nan
    vp[:, stale] = np.nan
    qkv = rng.standard_normal((b, 3 * h * d)).astype(np.float32)
    cos, sin = (t.numpy() for t in tl.lane_tables(
        torch.from_numpy(lengths), d, d // 2))
    return qkv, kp, vp, lengths, tables, page_ids, offsets, cos, sin, used


def roped_qk(qkv, cos, sin, h):
    """q and k of the raw projection roped in B4's FMA form (the kernels'
    rope_lane), f32 [B, H, D] each; v [B, H, D]."""
    from fastllama_tpu_torch.kernels.decode_attention import _rope_fma
    b = qkv.shape[0]
    d = cos.shape[1]
    t = torch.from_numpy(qkv).reshape(b, 3, h, d)
    partner = torch.arange(d) ^ 1
    c, sn = torch.from_numpy(cos)[:, None], torch.from_numpy(sin)[:, None]
    q, k = (_rope_fma(x, x[..., partner], c, sn).numpy()
            for x in (t[:, 0], t[:, 1]))
    return q, k, t[:, 2].numpy()


def run_fused_plain(case, pool):
    qkv, kp, vp, lengths, tables, page_ids, offsets, cos, sin, _ = case
    dt = getattr(torch, pool)
    tk, tv = to_t(kp).to(dt), to_t(vp).to(dt)
    ctx = tpa.paged_decode_step_fused(
        to_t(qkv), tk, tv, to_t(lengths), to_t(tables), to_t(page_ids),
        to_t(offsets), to_t(cos), to_t(sin))
    return ctx.numpy(), f32(tk), f32(tv)


@pytest.mark.parametrize("pool,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_fused_step_plain_matches_jax_write_then_attention(pool, tol):
    """The fused step's plain version against the JAX paged step's order:
    paged_kv_write (Pallas, interpret mode) of the roped k and v, then
    paged_decode_attention (Pallas, interpret mode) over lengths + 1 keys
    with the roped q. The pools equal the JAX write's bit for bit on every
    page but the trash page; ctx within B6's plain-against-Pallas tolerance
    (test_b6_plain_matches_pallas) on the active slots. JAX reads pools
    without NaN (its kernel copies whole pages)."""
    case = fused_case(pool, [1, 63, 64, 65, 300])
    qkv, kp, vp, lengths, tables, page_ids, offsets, cos, sin, used = case
    h = kp.shape[0]
    q, k, v = roped_qk(qkv, cos, sin, h)
    jdt = getattr(jnp, pool)
    clean = [np.nan_to_num(a, nan=0.0) for a in (kp, vp)]
    jk, jv = jkw.paged_kv_write(
        jnp.asarray(clean[0], jdt), jnp.asarray(clean[1], jdt),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(page_ids),
        jnp.asarray(offsets), interpret=True)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(lengths + 1), jnp.asarray(tables),
        interpret=True))
    ctx, tk, tv = run_fused_plain(case, pool)
    idx = sorted(used)
    np.testing.assert_array_equal(tk[:, idx], f32(to_t(jk))[:, idx])
    np.testing.assert_array_equal(tv[:, idx], f32(to_t(jv))[:, idx])
    assert np.isfinite(ctx).all()
    np.testing.assert_allclose(ctx[:-1], want[:-1], rtol=tol, atol=tol)


def fused_split_rule(q, k, v, kp, vp, length, table, chunk, pool):
    """The fused kernel's arithmetic for one sequence in numpy f32: B6's
    chunks over the `length` resident rows (b6_split_rule's partials and
    merge), then the new token folded in last, rounded to the pool dtype:
    s_new = dot(T(q), T(k)) * scale, M' = max(M, s_new), L' = L exp(M -
    M') + exp(s_new - M'), C' = C exp(M - M') + exp(s_new - M') T(v)."""
    h, _, ps, d = kp.shape
    n = int(np.clip(length, 0, table.shape[0] * ps))
    scale = np.float32(1.0 / np.sqrt(d))
    pages = np.clip(table, 0, kp.shape[1] - 1)
    rows = [(pages[s // ps], s % ps) for s in range(n)]
    qr, kr, vr = (_as_pool(a, pool) for a in (q, k, v))
    out = np.zeros((h, d), np.float32)
    for hh in range(h):
        big_m, big_l, big_c = np.float32(-np.inf), np.float32(0), \
            np.zeros(d, np.float32)
        parts = []
        for s0 in range(0, n, chunk):
            rr = rows[s0:s0 + chunk]
            kk = np.stack([kp[hh, a, b] for a, b in rr])
            vv = np.stack([vp[hh, a, b] for a, b in rr])
            sc = (kk @ qr[hh]).astype(np.float32) * scale
            m = sc.max()
            pr = np.exp(sc - m).astype(np.float32)
            parts.append((m, pr.sum(dtype=np.float32),
                          (_as_pool(pr, pool) @ vv).astype(np.float32)))
        for i0 in range(0, len(parts), 8):
            batch = parts[i0:i0 + 8]
            mb = max([big_m] + [m for m, _, _ in batch])
            r = np.exp(np.float32(big_m - mb)) if big_m > -np.inf else 0
            big_l, big_c = big_l * r, big_c * r
            for m, l, c in batch:
                e = np.exp(np.float32(m - mb))
                big_l, big_c = big_l + l * e, big_c + c * e
            big_m = mb
        s_new = np.float32(qr[hh] @ kr[hh]) * scale
        mb = max(big_m, s_new)
        r = np.exp(np.float32(big_m - mb)) if big_m > -np.inf else 0
        e = np.exp(np.float32(s_new - mb))
        out[hh] = (big_c * r + e * vr[hh]) / (big_l * r + e)
    return out


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_fused_split_rule_folds_the_new_token_rounded(pool):
    """The fused kernel's rule (fused_split_rule: B6's 64-row chunks over
    the resident rows, the new token one more partial rounded to the pool
    dtype) equals the fused step's plain version (B7's write, then B6 over
    lengths + 1 keys, which reads the new row back from the pool) within
    B6's tolerance at lengths 0, 1, 63, 64, 65 and pp * ps - 1: 2^-7 of the
    largest output for bf16 pools (the new token's own p is not rounded,
    and each chunk rounds p against its own max) and 5e-5 for f32 pools.
    The rule reads pools with NaN in every page no sequence reaches."""
    case = fused_case(pool, [0, 1, 63, 64, 65, 639], seed=72)
    qkv, kp, vp, lengths, tables, _, _, cos, sin, _ = case
    h = kp.shape[0]
    q, k, v = roped_qk(qkv, cos, sin, h)
    ctx, _, _ = run_fused_plain(case, pool)
    tol = (2 ** -7 if pool == "bfloat16" else 5e-5) * np.abs(ctx).max()
    for i in range(len(lengths) - 1):
        got = fused_split_rule(q[i], k[i], v[i], kp, vp, lengths[i],
                               tables[i], 64, pool)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ctx[i], rtol=0, atol=tol)
    np.testing.assert_array_equal(
        fused_split_rule(q[0], k[0], v[0], kp, vp, 0, tables[0], 64, pool),
        _as_pool(v[0], pool))


def test_fused_step_wrapper_rejects_wrong_shapes():
    case = fused_case("float32", [5])
    qkv, kp, vp, lengths, tables, page_ids, offsets, cos, sin, _ = case
    args = [to_t(a) for a in (qkv, kp, vp, lengths, tables, page_ids,
                              offsets, cos, sin)]
    with pytest.raises(ValueError, match="qkv"):
        tpa.paged_decode_step_fused(args[0][:, :-1], *args[1:])
    with pytest.raises(ValueError, match="cos"):
        tpa.paged_decode_step_fused(*args[:7], args[7][:, :64], args[8])
    with pytest.raises(ValueError, match="page_ids"):
        tpa.paged_decode_step_fused(*args[:5], args[5].long(), *args[6:])


@pytest.mark.cuda
@pytest.mark.parametrize("h", [2, 40])
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_fused_step_kernel_matches_plain(cuda_device, pool, h):
    """The fused step on the card against its plain version at lengths 0,
    1, ps - 1, ps, ps + 1, 300 and pp * ps - 1 and an inactive slot: the
    written rows bit for bit, ctx within B6's tolerance on the active
    slots, finite everywhere; and against the standalone B7 + B6 on the
    same roped q and k."""
    case = fused_case(pool, [0, 1, 63, 64, 65, 300, 639], h=h, seed=73)
    qkv, kp, vp, lengths, tables, page_ids, offsets, cos, sin, used = case
    dt = getattr(torch, pool)
    dev = cuda_device
    t = [to_t(a).to(dev) for a in (qkv, lengths, tables, page_ids, offsets,
                                   cos, sin)]
    pools = [to_t(a).to(dt).to(dev) for a in (kp, vp)]
    ref_pools = [x.clone() for x in pools]
    b7_pools = [x.clone() for x in pools]
    got = tpa.paged_decode_step_fused(t[0], *pools, *t[1:])
    want = tpa.paged_decode_step_fused_plain(t[0], *ref_pools, *t[1:])
    q, k, v = (to_t(a).to(dev) for a in roped_qk(qkv, cos, sin, h))
    tkw.paged_kv_write(*b7_pools, k, v, t[3], t[4])
    b6 = tpa.paged_decode_attention(q, *b7_pools, t[1] + 1, t[2])
    idx = sorted(used)
    for x, y, z in zip(pools, ref_pools, b7_pools):
        assert torch.equal(x[:, idx], y[:, idx])
        assert torch.equal(x[:, idx], z[:, idx])
    tol = (2 ** -7 if pool == "bfloat16" else 5e-5) \
        * want[:-1].abs().max().item() + 1e-6
    assert bool(torch.isfinite(got).all())
    assert (got - want)[:-1].abs().max().item() <= tol
    assert (got - b6)[:-1].abs().max().item() <= tol


# ---------------------------------------------------------------------------
# the paged forward passes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, tl.params_from_numpy(to_numpy_tree(jp), device="cpu")


def paged_prefill_then_decode(params, mode):
    """A 5-token prompt prefilled into pages (bucket 8, sentinel tail), then
    two decode steps of a batch of two slots (the second inactive), on both
    packages. Returns [(port logits, jax logits)], port and jax managers."""
    jp, tp = params
    jcfg = jl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot, w_dtype=mode,
                            use_pallas=False, prefill_int8=False)
    tcfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot, w_dtype=mode,
                            prefill_int8=False)
    kw = dict(n_slots=2, page_size=4, total_pages=8, pages_per_seq=4)
    jm = jpk.PagedKVManager(HP, dtype=getattr(jnp, mode), **kw)
    tm = tpk.PagedKVManager(HP, dtype=getattr(torch, mode), device="cpu",
                            **kw)
    prompt = [1, 5, 9, 20, 7]
    t0, bucket = len(prompt), 8
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :t0] = prompt
    out = []
    for m in (jm, tm):
        assert m.alloc_for(0, t0)
    pages = np.full(bucket, jm.sentinel, np.int32)
    offs = np.zeros(bucket, np.int32)
    pages[:t0], offs[:t0] = jm.token_page_offsets(0, 0, t0)
    jlog, jm.k_pages, jm.v_pages = jl.forward_paged_prefill(
        jp, jnp.asarray(toks), jnp.int32(t0 - 1), jnp.asarray(pages),
        jnp.asarray(offs), jm.k_pages, jm.v_pages, jcfg)
    tlog, _, _ = tl.forward_paged_prefill(
        tp, to_t(toks).long(), t0 - 1, to_t(pages), to_t(offs), tm.k_pages,
        tm.v_pages, tcfg)
    out.append((tlog.numpy(), np.asarray(jlog)))
    n = t0
    for tok in (11, 30):
        for m in (jm, tm):
            assert m.alloc_for(0, n + 1)
        wp, wo = jm.token_page_offsets(0, n, 1)
        lengths = np.array([n, 0], np.int32)
        page_ids = np.array([wp[0], jm.sentinel], np.int32)
        offsets = np.array([wo[0], 0], np.int32)
        step = np.array([[tok], [0]], np.int32)
        jlog, jm.k_pages, jm.v_pages = jl.forward_paged_decode(
            jp, jnp.asarray(step), jnp.asarray(lengths),
            jnp.asarray(jm.page_tables), jm.k_pages, jm.v_pages,
            jnp.asarray(page_ids), jnp.asarray(offsets), jcfg)
        tlog, _, _ = tl.forward_paged_decode(
            tp, to_t(step).long(), to_t(lengths), to_t(tm.page_tables),
            tm.k_pages, tm.v_pages, to_t(page_ids), to_t(offsets), tcfg)
        out.append((tlog.numpy()[0], np.asarray(jlog)[0]))
        n += 1
    return out, tm, jm


def test_paged_forward_f32_matches_jax(params):
    steps, tm, jm = paged_prefill_then_decode(params, "float32")
    for tlog, jlog in steps:
        assert tlog.shape == jlog.shape
        np.testing.assert_allclose(tlog, jlog, rtol=2e-4, atol=2e-4)
    # the pools: every page but the trash page
    for li in range(HP.n_layer):
        for tpool, jpool in ((tm.k_pages[li], jm.k_pages[li]),
                             (tm.v_pages[li], jm.v_pages[li])):
            np.testing.assert_allclose(tpool.numpy()[:, :8],
                                       np.asarray(jpool)[:, :8],
                                       rtol=2e-4, atol=2e-4)


def test_paged_forward_bf16_matches_jax(params):
    """bf16 weights and pools. The prefill takes the same roundings on both
    sides (1e-4 of the largest logit). The decode step runs B6's plain
    version here, which casts q and p to bf16 as the TPU kernel does, and
    the f32 jnp reference in JAX on the CPU: bf16 tolerance, 3e-2 of the
    largest logit, as for the slab decode step (test_torch_model)."""
    steps, tm, jm = paged_prefill_then_decode(params, "bfloat16")
    tlog, jlog = steps[0]
    np.testing.assert_allclose(tlog, jlog, rtol=0,
                               atol=1e-4 * np.abs(jlog).max())
    for tlog, jlog in steps[1:]:
        np.testing.assert_allclose(tlog, jlog, rtol=0,
                                   atol=3e-2 * np.abs(jlog).max())
    np.testing.assert_allclose(
        f32(tm.k_pages[0])[:, :8],
        np.asarray(jm.k_pages[0]).astype(np.float32)[:, :8],
        rtol=0, atol=2 ** -6)


def test_paged_decode_matches_slab_forward(params):
    """The port's own two caches agree: a prompt prefilled into the slab
    cache and mirrored into pages, then one decode step each way."""
    _, tp = params
    cfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                           w_dtype="float32")
    prompt = torch.tensor([[1, 5, 9, 20, 7]])
    t0 = prompt.shape[1]
    kv = tl.init_kv_cache(HP, 1, 16, dtype=torch.float32, device="cpu")
    tl.forward(tp, prompt, 0, kv, cfg)
    mgr = tpk.PagedKVManager(HP, n_slots=1, page_size=4, total_pages=8,
                             pages_per_seq=4, dtype=torch.float32,
                             device="cpu")
    assert mgr.alloc_for(0, t0 + 1)
    pages, offs = mgr.token_page_offsets(0, 0, t0)
    for li in range(HP.n_layer):
        k, v = (c[:, :t0].reshape(1, t0, HP.n_head, -1) for c in kv[li])
        tpk.write_tokens_paged(mgr.k_pages[li], mgr.v_pages[li], k, v,
                               to_t(pages[None]), to_t(offs[None]))
    tok = torch.tensor([[11]])
    want, _, _ = tl.forward(tp, tok, t0, kv, cfg)
    wp, wo = mgr.token_page_offsets(0, t0, 1)
    got, _, _ = tl.forward_paged_decode(
        tp, tok, to_t(np.array([t0], np.int32)), to_t(mgr.page_tables),
        mgr.k_pages, mgr.v_pages, to_t(wp), to_t(wo), cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_paged_forward_ignores_lora_output(params):
    """The paged forward passes of the JAX package add no lora_output term
    to the head (forward does); the port follows them."""
    import dataclasses
    jp, tp = params
    rng = np.random.default_rng(6)
    delta = (rng.standard_normal((HP.n_embd, HP.n_vocab)) * 0.1).astype(
        np.float32)
    jp2 = dataclasses.replace(jp, lora_output=jl.LoraTerm(
        delta=jnp.asarray(delta)))
    tp2 = dataclasses.replace(tp, lora_output=tl.LoraTerm(
        delta=torch.from_numpy(delta)))
    plain, _, _ = paged_prefill_then_decode((jp, tp), "float32")
    with_term, _, _ = paged_prefill_then_decode((jp2, tp2), "float32")
    for (t0, j0), (t1, j1) in zip(plain, with_term):
        np.testing.assert_array_equal(j0, j1)
        np.testing.assert_array_equal(t0, t1)


def greedy_paged_stream(params, monkeypatch, fused, steps=6):
    """A 5-token prompt prefilled into pages, then `steps` greedy decode
    steps of two slots (the second inactive) through forward_paged_decode,
    f32. fused=False sends every layer down the unfused route (RoPE, B7,
    B6), as a layer with q/k/v LoRA terms goes. Returns the tokens and the
    last logits."""
    _, tp = params
    if not fused:
        monkeypatch.setattr(tl, "_no_qkv_lora", lambda layer: False)
    cfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                           w_dtype="float32", prefill_int8=False)
    m = tpk.PagedKVManager(HP, n_slots=2, page_size=4, total_pages=8,
                           pages_per_seq=4, dtype=torch.float32,
                           device="cpu")
    prompt = [1, 5, 9, 20, 7]
    n = len(prompt)
    assert m.alloc_for(0, n)
    pages, offs = m.token_page_offsets(0, 0, n)
    logits, _, _ = tl.forward_paged_prefill(
        tp, torch.tensor([prompt]), n - 1, to_t(pages), to_t(offs),
        m.k_pages, m.v_pages, cfg)
    tokens = [int(logits[0].argmax())]
    for _ in range(steps):
        assert m.alloc_for(0, n + 1)
        wp, wo = m.token_page_offsets(0, n, 1)
        logits, _, _ = tl.forward_paged_decode(
            tp, torch.tensor([[tokens[-1]], [0]]),
            to_t(np.array([n, 0], np.int32)), to_t(m.page_tables),
            m.k_pages, m.v_pages, to_t(np.array([wp[0], m.sentinel],
                                                np.int32)),
            to_t(np.array([wo[0], 0], np.int32)), cfg)
        tokens.append(int(logits[0, 0].argmax()))
        n += 1
    monkeypatch.undo()
    return tokens, logits[0, 0].numpy()


def test_fused_paged_decode_equals_the_unfused_route(params, monkeypatch):
    """A 2-layer f32 forward_paged_decode on the fused route (one fused
    step a layer) gives the unfused route's greedy tokens, token for token,
    and logits within f32 rounding (the two differ in RoPE's rounding of
    the new k, an FMA against a product and a sum, and in the order of
    f32 sums)."""
    fused, lf = greedy_paged_stream(params, monkeypatch, fused=True)
    unfused, lu = greedy_paged_stream(params, monkeypatch, fused=False)
    assert fused == unfused
    np.testing.assert_allclose(lf, lu, rtol=0, atol=1e-4 * np.abs(lu).max())
