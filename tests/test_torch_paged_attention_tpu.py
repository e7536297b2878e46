"""PyTorch port: B21, engine/paged_kv.paged_attention_tpu (the library
Pallas TPU kernel paged_attention, which the JAX engine takes on pools past
its own kernel's gate), against the library kernel under
pltpu.force_tpu_interpret_mode(); the fused B21 step
(paged_attention_tpu_fused: RoPE, B7's write, the pre-scale and B21)
against the JAX step's composition and the port's unfused route; a model of
B21's split over the sequence and its merge; the gate and the engine's
route against the JAX package's; a tiny long-context engine against the
JAX engine."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fastllama_tpu.config import HyperParams, RuntimeConfig as JaxRuntimeConfig
from fastllama_tpu.engine import paged_kv as jpk
from fastllama_tpu.engine import scheduler as js
from fastllama_tpu.engine.tokenizer import Vocab as JaxVocab
from fastllama_tpu.kernels import kv_write as jkw
from fastllama_tpu.kernels import paged_attention as jpa
from fastllama_tpu.models import llama as jl
from fastllama_tpu.models.fuse import make_layer_params
from fastllama_tpu.quant.q4 import quantize_q4_0
from fastllama_tpu.quant.tensor import make_embedding, make_matmul_weight
from fastllama_tpu_torch.config import RuntimeConfig
from fastllama_tpu_torch.engine import paged_kv as tpk
from fastllama_tpu_torch.engine import scheduler as ts
from fastllama_tpu_torch.engine.tokenizer import Vocab
from fastllama_tpu_torch.kernels import kv_write as tkw
from fastllama_tpu_torch.kernels import paged_attention as tpa
from fastllama_tpu_torch.models import llama as tl

from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

B, HKV, D, PS, P, PP = 3, 2, 128, 16, 14, 4
LENGTHS = np.array([37, 0, PP * PS], np.int32)     # mid-page, empty, full


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def inputs(g, seed=0):
    """q [B, g * HKV, D], pools [HKV, P, PS, D] f32 and a shuffled table, as
    numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, g * HKV, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((HKV, P, PS, D)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(P)[:B * PP].reshape(B, PP).astype(np.int32)
    return q, kp, vp, table


def library(q, kp, vp, lengths, table, ppcb):
    """The JAX package's paged_attention_tpu (the library kernel) in
    interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jpk.paged_attention_tpu(
            q, kp, vp, jnp.asarray(lengths), jnp.asarray(table),
            pages_per_compute_block=ppcb))


def both(q, kp, vp, qd, kd):
    """The same values for both packages in the given dtypes."""
    jq = jnp.asarray(q).astype(getattr(jnp, qd))
    jk, jv = (jnp.asarray(a).astype(getattr(jnp, kd)) for a in (kp, vp))
    tq = torch.from_numpy(q).to(getattr(torch, qd))
    tk, tv = (torch.from_numpy(a).to(getattr(torch, kd)) for a in (kp, vp))
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("g,ppcb", [(2, 1), (2, 2), (2, 4), (1, 2)])
@pytest.mark.parametrize("qd,kd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
def test_plain_matches_the_library_kernel(qd, kd, g, ppcb):
    """B21's plain version against the library kernel in interpret mode,
    within 1e-5 (about 1e-7 to 7e-7 measured): q pre-scaled to f32 (a bf16
    q gives f32 out), K and V read as bf16 (the library rounds f32 pools),
    Hq = g * Hkv, compute blocks of 1, 2 and 4 pages; a sequence of length
    0 gives zeros, as the library returns for it."""
    q, kp, vp, table = inputs(g)
    (jq, jk, jv), (tq, tk, tv) = both(q, kp, vp, qd, kd)
    want = library(jq, jk, jv, LENGTHS, table, ppcb)
    got = tpk.paged_attention_tpu(tq, tk, tv, torch.from_numpy(LENGTHS),
                                  torch.from_numpy(table),
                                  pages_per_compute_block=ppcb)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert got.shape == want.shape == (B, g * HKV, D)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert not want[1].any() and not got[1].any()


def test_f32_pools_are_read_as_bf16():
    """The library rounds f32 pools to bf16 (its page cast): it sits far
    from the JAX package's unrounded f32 reference and, as B21 does, on
    the reference of the rounded pools (the sequences of nonzero length:
    the reference averages every value at length 0)."""
    q, kp, vp, table = inputs(1, seed=1)
    (jq, jk, jv), (tq, tk, tv) = both(q, kp, vp, "float32", "float32")
    live = [0, 2]
    want = library(jq, jk, jv, LENGTHS, table, 2)[live]
    lens, tab = jnp.asarray(LENGTHS), jnp.asarray(table)
    exact = np.asarray(jpk.paged_attention_reference(
        jq, jk, jv, lens, tab))[live]
    rounded = np.asarray(jpk.paged_attention_reference(
        jq, *(a.astype(jnp.bfloat16).astype(jnp.float32) for a in (jk, jv)),
        lens, tab))[live]
    assert np.abs(want - exact).max() > 1e-4
    assert np.abs(want - rounded).max() <= 1e-5
    got = tpk.paged_attention_tpu(tq, tk, tv, torch.from_numpy(LENGTHS),
                                  torch.from_numpy(table)).numpy()[live]
    assert np.abs(got - rounded).max() <= 1e-5


def _bad_args():
    q, kp, vp, table = inputs(2)
    lens = LENGTHS
    yield "pages_per_compute_block must be divisible", (q, kp, vp, lens,
                                                         table, 3)
    yield "same shape", (q, kp, vp[:, :-1], lens, table, 2)
    yield "divisible by number of KV heads", (q[:, :3], kp, vp, lens, table,
                                              2)
    yield "head_dim of Q", (q[..., :64], kp, vp, lens, table, 2)
    yield "`lengths` and `q`", (q, kp, vp, lens[:2], table, 2)
    yield "`page_indices` and `q`", (q, kp, vp, lens, table[:2], 2)
    yield "must be int32", (q, kp, vp, lens.astype(np.float32), table, 2)


@pytest.mark.parametrize("match,args", list(_bad_args()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_raises_where_the_library_raises(match, args):
    q, kp, vp, lens, table, ppcb = args
    with pytest.raises(ValueError, match=match):
        jpk.paged_attention_tpu(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(lens),
                                jnp.asarray(table),
                                pages_per_compute_block=ppcb)
    with pytest.raises(ValueError, match=match):
        tpk.paged_attention_tpu(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (q, kp, vp, lens, table)),
            pages_per_compute_block=ppcb)


# -- the fused B21 step -------------------------------------------------------

# lengths 0, 1, ps - 1, ps, ps + 1, a page edge inside the table +- 1, then
# an inactive slot (length 0, the sentinel page)
FUSED_LENGTHS = [0, 1, PS - 1, PS, PS + 1, 2 * PS - 1, 2 * PS + 1]


def fused_case(g, seed=11):
    """The fused step's inputs as numpy: qkv f32 [B, (g + 2) HKV D], pools
    [HKV, P, PS, D] f32 over B = len(FUSED_LENGTHS) + 1 sequences of PP
    pages (a shuffled table; P = B PP + 1, the last the trash page), each
    active slot's write at its table's row `length`, the last slot
    inactive (the sentinel page), the RoPE lanes at the lengths (n_rot =
    D / 2: lanes past it pass through). Returns the arrays and the pages
    any plain step reads (every other page is NaN in the pools)."""
    rng = np.random.default_rng(seed)
    lengths = np.array(FUSED_LENGTHS + [0], np.int32)
    b = len(lengths)
    p = b * PP + 1
    kp, vp = (rng.standard_normal((HKV, p, PS, D)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(b * PP).reshape(b, PP).astype(np.int32)
    page_ids = np.array([table[i, n // PS] for i, n in enumerate(lengths)],
                        np.int32)
    page_ids[-1] = p - 1
    offsets = (lengths % PS).astype(np.int32)
    used = sorted({int(pg) for row, n in zip(table, lengths)
                   for pg in row[:int(n) // PS + 1]})
    stale = [pg for pg in range(p - 1) if pg not in used]
    kp[:, stale] = np.nan
    vp[:, stale] = np.nan
    qkv = rng.standard_normal((b, (g + 2) * HKV * D)).astype(np.float32)
    cos, sin = (t.numpy() for t in tl.lane_tables(
        torch.from_numpy(lengths), D, D // 2))
    return qkv, kp, vp, lengths, table, page_ids, offsets, cos, sin, used


def run_fused_plain(case, pool, ppcb=2):
    """The fused step on CPU tensors (its plain version): ctx and the
    pools after the write, f32 numpy."""
    qkv, kp, vp, lengths, table, page_ids, offsets, cos, sin, _ = case
    dt = getattr(torch, pool)
    tk, tv = (torch.from_numpy(a).to(dt) for a in (kp, vp))
    ctx = tpk.paged_attention_tpu_fused(
        *(torch.from_numpy(a) for a in (qkv,)), tk, tv,
        *(torch.from_numpy(a) for a in (lengths, table, page_ids, offsets,
                                        cos, sin)),
        pages_per_compute_block=ppcb)
    return ctx.numpy(), tk.float().numpy(), tv.float().numpy()


def assert_k_within_an_ulp(got, want, k, page_ids, offsets, used, pool):
    """K pools (f32 numpy) equal on every page in `used` but the rows the
    active slots wrote (all but the last slot), where each value is within
    one ulp of k's RoPE: one f32 ulp of the raw k (|x cos| <= |x|: the one
    rounding the FMA form skips) plus one ulp of the pool type at the
    value."""
    got, want = got.copy(), want.copy()
    for i in range(len(page_ids) - 1):
        pg, off = int(page_ids[i]), int(offsets[i])
        a, b = got[:, pg, off], want[:, pg, off]
        step = np.spacing(np.abs(b))
        if pool == "bfloat16":
            step = step * 2.0 ** 16
        assert (np.abs(a - b) <= step + np.spacing(np.abs(k[i]))).all()
        got[:, pg, off] = b
    np.testing.assert_array_equal(got[:, used], want[:, used])


# the tolerance of test_fused_paged_decode_equals_the_unfused_route
# (tests/test_torch_paged_kv.py): the routes differ by RoPE's rounding of
# the new k (an FMA against a product and a sum) and the order of f32 sums
FUSED_RTOL = 1e-4


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_fused_plain_matches_the_jax_composition(pool, g):
    """The fused B21 step's plain version against the JAX paged step's
    order (fastllama_tpu/models/llama.py:650-661): _rope_qk (on the same
    RoPE lanes), paged_kv_write (Pallas, interpret mode), then the library
    paged attention (interpret mode) over lengths + 1 keys. The pools are
    equal but for the written rows, which are within one ulp of the pool
    type (the fused step ropes k in B4's FMA form; JAX rounds the product
    and the sum apart); ctx within 1e-4 of the largest output (the
    tolerance of test_fused_paged_decode_equals_the_unfused_route),
    every slot but the inactive one. JAX reads pools without NaN (the
    library copies whole compute blocks)."""
    case = fused_case(g)
    qkv, kp, vp, lengths, table, page_ids, offsets, cos, sin, used = case
    b = len(lengths)
    hq = g * HKV
    t = qkv.reshape(b, 1, g + 2, HKV, D)
    q = t[:, :, :g].reshape(b, 1, hq, D)
    k, v = t[:, :, g], t[:, :, g + 1]
    jcfg = jl.ForwardConfig(n_head=hq, n_rot=D // 2, w_dtype="float32")
    tabs = (jnp.asarray(cos[:, None, None, :]),
            jnp.asarray(sin[:, None, None, :]))
    jq, jk = jl._rope_qk(jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(lengths[:, None]), jcfg, tabs)
    jdt = getattr(jnp, pool)
    clean = [jnp.asarray(np.nan_to_num(a, nan=0.0), jdt) for a in (kp, vp)]
    wk, wv = jkw.paged_kv_write(*clean, jk[:, 0], jnp.asarray(v[:, 0]),
                                jnp.asarray(page_ids), jnp.asarray(offsets),
                                interpret=True)
    want = library(jq[:, 0], wk, wv, lengths + 1, table, 2)
    ctx, tk, tv = run_fused_plain(case, pool)
    assert_k_within_an_ulp(tk, np.asarray(wk.astype(jnp.float32)), k[:, 0],
                           page_ids, offsets, used, pool)
    np.testing.assert_array_equal(tv[:, used], np.asarray(
        wv.astype(jnp.float32))[:, used])
    assert np.isfinite(ctx).all()
    np.testing.assert_allclose(ctx[:-1], want[:-1], rtol=0,
                               atol=FUSED_RTOL * np.abs(want).max())


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_fused_plain_matches_the_unfused_route(world, pool):
    """The fused B21 step's plain version against the port's unfused B21
    route on the same projection (models/llama.py: _roped_qkv, then B7's
    plain write and B21's plain attention over lengths + 1 keys), the
    engine's first layer of the tiny long-context model: the pools within
    one ulp of k (the FMA form), v bit for bit, ctx within 1e-4 of the
    largest output on every slot (each route reads its own row back)."""
    case = fused_case(1, seed=12)
    _, kp, vp, lengths, table, page_ids, offsets, cos, sin, used = case
    b = len(lengths)
    layer = world["tp"].layers[0]
    cfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                           w_dtype="float32", prefill_int8=False)
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (b, 1, HP.n_embd)).astype(np.float32))
    cs, sn = tl.lane_tables(torch.from_numpy(lengths), D, HP.n_rot)
    qkv = tl.apply_linear(x, layer.wqkv, cfg).reshape(b, -1)
    q, k, v = tl._roped_qkv(x, layer, cfg, (cs[:, None, None, :],
                                            sn[:, None, None, :]))
    dt = getattr(torch, pool)
    pools = [torch.from_numpy(a).to(dt) for a in (kp, vp)]
    fused = [t.clone() for t in pools]
    t = [torch.from_numpy(a) for a in (lengths, table, page_ids, offsets)]
    tkw.paged_kv_write_plain(*pools, k[:, 0], v[:, 0], t[2], t[3])
    want = tpk.paged_attention_tpu_plain(q[:, 0], *pools, t[0] + 1, t[1])
    got = tpk.paged_attention_tpu_fused(qkv.float(), *fused, *t, cs, sn)
    raw_k = qkv.reshape(b, 3, HP.n_head, D)[:, 1].detach().numpy()
    assert_k_within_an_ulp(fused[0].float().numpy(),
                           pools[0].float().numpy(), raw_k, page_ids,
                           offsets, used, pool)
    assert torch.equal(fused[1][:, used], pools[1][:, used])
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= (
        FUSED_RTOL * want.abs().max().item())


# the query heads of one of B21's head groups: kHeads, its consumer warps
B21_SRC = (Path(tpk.__file__).resolve().parents[1] / "kernels" / "csrc"
           / "paged_flash.cu").read_text()
B21_HEADS = int(re.search(r"constexpr int {} = (\d+);".format(
    re.search(r"constexpr int kHeads = (\w+);", B21_SRC)[1]), B21_SRC)[1])


def b21_partition(lengths, hkv: int, g: int, ps: int, pp: int, nb: int):
    """B21's division of the work among its nb blocks, which
    csrc/paged_flash.cu computes on the device from the lengths. A segment
    is (b, KV head, head group of up to B21_HEADS query heads), in that
    order; its units are its live pages, ceil(clip(lengths[b], 0, pp ps) /
    ps), at least one. The segments' units are laid end to end, U in all,
    and block k takes units [k C, min((k + 1) C, U)), C = ceil(U / nb).
    Returns, per block, its pieces (b, hk, hg, first page, end page, slot):
    slot None for a segment wholly inside the block (finished there), 1 for
    the piece that starts a segment and runs on, 0 for a piece that
    continues one; the pieces of a cut segment merge in block order."""
    nhg = -(-g // B21_HEADS)
    nres = np.clip(np.asarray(lengths, np.int64), 0, pp * ps)
    nu = np.maximum(-(-nres // ps), 1)
    segs = [(b, s // nhg, s % nhg, int(nu[b]))
            for b in range(len(nres)) for s in range(hkv * nhg)]
    total = sum(n for *_, n in segs)
    c = -(-total // nb)
    blocks = [[] for _ in range(nb)]
    u = 0
    for b, hk, hg, n in segs:
        k0, k1 = u // c, (u + n - 1) // c
        for k in range(k0, k1 + 1):
            lo, hi = max(u, k * c) - u, min(u + n, (k + 1) * c) - u
            slot = None if k0 == k1 else (1 if k == k0 else 0)
            blocks[k].append((b, hk, hg, lo, hi, slot))
        u += n
    return blocks


def split_model(q, kp, vp, lengths, table, nb):
    """B21's arithmetic as csrc/paged_flash.cu divides it, in f64: each
    block's pieces (b21_partition) attend their pages with one (m, l, o) a
    head, a piece wholly inside a block is finished there, and a cut
    segment's pieces merge in block order with the library's formula.
    Returns ctx [B, Hq, D] and the pieces' count by segment."""
    b, hq, d = q.shape
    hkv, _, ps, _ = kp.shape
    g = hq // hkv
    pp = table.shape[1]
    qs = q.astype(np.float64) * np.float32(1.0 / np.sqrt(d))
    kb, vb = (torch.from_numpy(a).to(torch.bfloat16).double().numpy()
              for a in (kp, vp))
    rows_max = pp * ps
    pieces = {}
    for k, block in enumerate(b21_partition(
            lengths, hkv, g, ps, pp, nb)):
        for bi, hk, hg, lo, hi, slot in block:
            heads = range(hk * g + hg * B21_HEADS,
                          hk * g + min(g, (hg + 1) * B21_HEADS))
            n = int(np.clip(lengths[bi], 0, rows_max))
            rows = [(table[bi, j], r) for j in range(lo, hi)
                    for r in range(min(ps, n - j * ps))]
            part = {}
            for h in heads:
                if rows:
                    kk = np.stack([kb[hk, min(max(pg, 0), kp.shape[1] - 1), r]
                                   for pg, r in rows])
                    vv = np.stack([vb[hk, min(max(pg, 0), kp.shape[1] - 1), r]
                                   for pg, r in rows])
                    s = kk @ qs[bi, h]
                    m = s.max()
                    e = np.exp(s - m)
                    part[h] = (m, e.sum(), e @ vv)
                else:
                    part[h] = (-np.inf, 0.0, np.zeros(d))
            pieces.setdefault((bi, hk, hg), []).append((k, slot, part))
    out = np.zeros((b, hq, d))
    for (bi, hk, hg), ps_ in pieces.items():
        slots = [slot for _, slot, _ in ps_]
        assert slots == ([None] if len(ps_) == 1
                         else [1] + [0] * (len(ps_) - 1))
        assert [k for k, _, _ in ps_] == list(range(ps_[0][0],
                                                     ps_[0][0] + len(ps_)))
        for h in ps_[0][2]:
            big_m, big_l, big_o = -np.inf, 0.0, np.zeros(d)
            for _, _, part in ps_:
                m, l, o = part[h]
                mb = max(big_m, m)
                if mb == -np.inf:
                    continue
                a = 0.0 if big_m == -np.inf else np.exp(big_m - mb)
                c = 0.0 if m == -np.inf else np.exp(m - mb)
                big_l, big_o, big_m = big_l * a + l * c, big_o * a + o * c, mb
            out[bi, h] = big_o / big_l if big_l > 0 else 0.0
    return out, {key: len(v) for key, v in pieces.items()}


@pytest.mark.parametrize("nb", [1, 2, 3, 7, 64, 264])
@pytest.mark.parametrize("g", [1, 2, 9, 17])
def test_split_model_matches_the_unsplit_plain(g, nb):
    """B21's division of the live pages among nb blocks (b21_partition)
    and its merge, modelled in f64, against the plain version within 1e-5
    of the largest output, at lengths that cross page (compute block) and
    block edges, 0 and past the table (clipped); G = 9 query heads a KV
    head make two head groups, 17 three. Every live page of every segment is
    attended exactly once, a segment of length 0 has one unit, and the
    blocks take C = ceil(U / nb) units each."""
    rng = np.random.default_rng(20 + g)
    lengths = np.array([37, 0, PP * PS, 1, PS, PS + 1, 3 * PS - 1, 99],
                       np.int32)
    b = len(lengths)
    p = b * PP + 1
    q = rng.standard_normal((b, g * HKV, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((HKV, p, PS, D)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(b * PP).reshape(b, PP).astype(np.int32)
    got, counts = split_model(q, kp, vp, lengths, table, nb)
    want = tpk.paged_attention_tpu_plain(
        *(torch.from_numpy(a) for a in (q, kp, vp, lengths, table))).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    nhg = -(-g // B21_HEADS)
    units = np.maximum(-(-np.clip(lengths, 0, PP * PS) // PS), 1)
    total = int(units.sum()) * HKV * nhg
    c = -(-total // nb)
    blocks = b21_partition(lengths, HKV, g, PS, PP, nb)
    assert sum(hi - lo for bl in blocks for *_, lo, hi, _ in bl) == total
    assert all(sum(hi - lo for *_, lo, hi, _ in bl) == min(
        c, max(0, total - k * c)) for k, bl in enumerate(blocks))
    assert len(counts) == b * HKV * nhg


# -- the gate and the route ----------------------------------------------------

@pytest.mark.parametrize("h", [2, 32, 40])
def test_gate_matches_the_jax_gate(h):
    """paged_attn_group / paged_attn_supported against the JAX package's
    over (hd, ps, pp, itemsize), and the library block size against the JAX
    engine's cap."""
    for hd in (64, 128, 256):
        for ps in (8, 16, 60, 64):
            for pp in (1, 96, 192, 193, 384, 385, 512):
                for isz in (2, 4):
                    args = (h, pp, ps, hd, isz)
                    assert (tpa.paged_attn_group(*args)
                            == jpa.paged_attn_group(*args))
                    assert (tpa.paged_attn_supported(*args)
                            == jpa.paged_attn_supported(*args))
                    assert tpa.library_ppcb(pp, ps, hd) == min(
                        pp, max(1, (1 << 21) // (4 * ps * hd)))


def test_gate_fails_past_the_documented_rows():
    """At Dh 128 and 32 heads, pages of 64 rows: the JAX kernel takes 24,576
    rows a sequence of bf16 pools and 12,288 of f32 pools, no more."""
    for rows, isz, ok in ((24576, 2, True), (24640, 2, False),
                          (12288, 4, True), (12352, 4, False)):
        assert tpa.paged_attn_supported(32, rows // 64, 64, 128, isz) is ok


@pytest.mark.parametrize("hd,ps,n_ctx,isz,want", [
    (128, 64, 512, 2, None),              # the fused step (phase 6)
    (128, 64, 32768, 2, 64),              # B21, the 7B long-context engine
    (128, 64, 16384, 4, 64),              # B21, f32 pools past 12,288 rows
    (128, 64, 16384, 2, None),            # bf16 pools still fit
    (128, 60, 32760, 2, None),            # pages not of 8 rows: own route
    (96, 64, 32768, 2, None),             # no 128-lane heads: own route
])
def test_route_follows_the_jax_dispatch(hd, ps, n_ctx, isz, want):
    pp = -(-n_ctx // ps)
    route = ts.paged_attn_route(32, pp, ps, hd, isz)
    if want is None:
        assert route is None
    else:
        assert route == ts.B21Route(want)


# -- a tiny engine past the f32 gate -------------------------------------------

HP = HyperParams(n_vocab=320, n_embd=256, n_head=2, n_layer=2, n_rot=128)
N_FF = 192
N_CTX = 16384               # pp 256 pages of 64: past the 12,288-row gate
KW = dict(kv_dtype="float32", weight_dtype="float32", n_batch=8,
          prefill_buckets=(8, 16, 32, 64))


def jax_params(seed=0):
    rng = np.random.default_rng(seed)

    def qw(k_in, n_out, scale=0.1):
        return ("q4",) + quantize_q4_0(
            (rng.standard_normal((n_out, k_in)) * scale).astype(np.float32))

    d = HP.n_embd
    layers = [make_layer_params(
        HP.n_head, attention_norm=np.ones(d, np.float32),
        ffn_norm=np.ones(d, np.float32), wq=qw(d, d), wk=qw(d, d),
        wv=qw(d, d), wo=qw(d, d), w1=qw(d, N_FF), w2=qw(N_FF, d),
        w3=qw(d, N_FF)) for _ in range(HP.n_layer)]
    emb = (rng.standard_normal((HP.n_vocab, d)) * 0.4).astype(np.float32)
    out = (rng.standard_normal((HP.n_vocab, d)) * 0.1).astype(np.float32)
    out[2] = 0.0                    # EOS logit 0: greedy runs its length
    return jl.LlamaParams(
        tok_embeddings=make_embedding(*quantize_q4_0(emb)),
        norm=jnp.ones(d), output=make_matmul_weight(*quantize_q4_0(out)),
        layers=layers)


def vocab_tokens():
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" w{i}".encode(), 1.0) for i in range(HP.n_vocab - len(toks))]
    return toks


@pytest.fixture(scope="module")
def world():
    jp = jax_params()
    return dict(jp=jp, tp=tl.params_from_numpy(to_numpy_tree(jp),
                                               device="cpu"),
                jvocab=JaxVocab.from_tokens(vocab_tokens()),
                tvocab=Vocab.from_tokens(vocab_tokens()))


PROMPTS = ["w1 w2 w3", "w7 w8 w9 w10 w11 w12", "w20 w4"]


def requests(mod):
    return [mod.Request(prompt=p, max_tokens=6, temp=0.0) for p in PROMPTS]


def lora_params(world, seed=14):
    """Both packages' tiny params with q and v LoRA terms on every layer."""
    import dataclasses
    rng = np.random.default_rng(seed)
    d = HP.n_embd
    jl_layers, tl_layers = [], []
    for jlay, tlay in zip(world["jp"].layers, world["tp"].layers):
        dq, dv = ((rng.standard_normal((d, d)) * 0.02).astype(np.float32)
                  for _ in range(2))
        jl_layers.append(dataclasses.replace(
            jlay, lora_wq=jl.LoraTerm(delta=jnp.asarray(dq)),
            lora_wv=jl.LoraTerm(delta=jnp.asarray(dv))))
        tl_layers.append(dataclasses.replace(
            tlay, lora_wq=tl.LoraTerm(delta=torch.from_numpy(dq)),
            lora_wv=tl.LoraTerm(delta=torch.from_numpy(dv))))
    return (dataclasses.replace(world["jp"], layers=jl_layers),
            dataclasses.replace(world["tp"], layers=tl_layers))


def long_engine_case(world, monkeypatch, lora):
    """A 2-layer engine of two 128-wide heads, f32 pools, n_ctx 16384 and
    pages of 64 rows (pp 256; total_pages set to 32, not the slab-sized
    default): past the JAX kernel's f32 gate, so the route is B21 with the
    JAX engine's 64-page compute blocks, every layer of every step, and
    never the port's own fused step. Each layer takes the fused B21 step
    (RoPE, B7's write, the pre-scale and B21 in one call), never B7 or the
    unfused B21, with q/k/v LoRA terms too (added into the layer's fused
    projection first). The greedy streams equal the JAX engine's on the
    CPU (whose step attends through its reference there)."""
    jp, tp = lora_params(world) if lora else (world["jp"], world["tp"])
    calls = {"B21": [], "B21F": [], "B7": 0, "PS": 0}
    real, real_f = tpk.paged_attention_tpu, tpk.paged_attention_tpu_fused
    real_b7, real_ps = tl.paged_kv_write, tl.paged_decode_step_fused

    def spy(key, fn):
        def wrapped(*a, **kw):
            calls[key].append(kw["pages_per_compute_block"])
            return fn(*a, **kw)
        return wrapped

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(tpk, "paged_attention_tpu", spy("B21", real))
    monkeypatch.setattr(ts, "paged_attention_tpu_fused", spy("B21F", real_f))
    monkeypatch.setattr(tl, "paged_kv_write", count("B7", real_b7))
    monkeypatch.setattr(tl, "paged_decode_step_fused", count("PS", real_ps))
    eng = ts.BatchEngine(HP, tp, world["tvocab"], n_slots=2,
                         n_ctx=N_CTX, rcfg=RuntimeConfig(**KW),
                         kv_mode="paged", page_size=64, total_pages=32,
                         device="cpu")
    assert eng.pager.pages_per_seq == 256
    port = [list(r.tokens_out) for r in eng.run(requests(ts))]
    jeng = js.BatchEngine(HP, jp, world["jvocab"], n_slots=2,
                          n_ctx=N_CTX,
                          rcfg=JaxRuntimeConfig(use_pallas=False, **KW),
                          kv_mode="paged", page_size=64, total_pages=32)
    ref = [list(r.tokens_out) for r in jeng.run(requests(js))]
    assert port == ref and all(len(t) == 6 for t in port)
    steps = len(calls["B21F"]) // HP.n_layer
    assert steps > 0 and set(calls["B21F"]) == {64}
    assert len(calls["B21F"]) == steps * HP.n_layer
    assert calls["B21"] == [] and calls["PS"] == 0 and calls["B7"] == 0
    assert eng.pager.free_pages == 32


def test_long_context_engine_takes_b21_and_matches_jax(world, monkeypatch):
    """long_engine_case without LoRA: the fused B21 step on every layer."""
    long_engine_case(world, monkeypatch, lora=False)


def test_long_context_lora_engine_takes_b7_and_b21(world, monkeypatch):
    """long_engine_case with q/k/v LoRA terms on both layers: the fused B21
    step on every layer as without them, B7 and the unfused B21 (the route
    such layers took before the fold) never called."""
    long_engine_case(world, monkeypatch, lora=True)


def test_engine_raises_where_the_jax_engine_raises(world, monkeypatch):
    """n_ctx 25000 at pages of 64 rows: pp 391, and the JAX engine's block
    of 64 pages does not divide it. The JAX engine's step (built as on its
    accelerator) raises the library's ValueError when it is traced; the
    port's engine raises the same at its first decode step."""
    n_ctx, msg = 25000, "Got 64 and 391"
    kw = dict(n_slots=2, n_ctx=n_ctx, kv_mode="paged", page_size=64,
              total_pages=8)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jeng = js.BatchEngine(HP, world["jp"], world["jvocab"],
                          rcfg=JaxRuntimeConfig(use_pallas=False, **KW), **kw)
    monkeypatch.undo()
    pg = jeng.pager
    b = jeng.n_slots
    with pytest.raises(ValueError, match=msg):
        jax.eval_shape(
            jeng._decode_fn, jeng.params, jeng.d_tokens,
            jnp.zeros(b, jnp.int32), jnp.asarray(pg.page_tables),
            jnp.zeros(b, jnp.int32), jnp.zeros(b, jnp.int32), jeng.d_active,
            jeng.d_lastn, jeng.d_temps, jeng.d_topk, jeng.d_topp, jeng.d_rp,
            jeng._base_key, jeng.d_step, pg.k_pages, pg.v_pages)
    eng = ts.BatchEngine(HP, world["tp"], world["tvocab"],
                         rcfg=RuntimeConfig(**KW), device="cpu", **kw)
    assert eng.pager.pages_per_seq == 391
    with pytest.raises(ValueError, match=msg):
        eng.run(requests(ts)[:1])


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kd", ["bfloat16", "float32"])
@pytest.mark.parametrize("ppcb", [1, 2, 4])
def test_b21_kernel_matches_plain(cuda_device, kd, ppcb):
    """B21 on the card against its plain version at 1e-5 of the largest
    output (f32 sums in another order), Hq = 2 Hkv, a bf16 q, a length-0
    sequence (zeros); NaN in every page no sequence reaches; bit-equal
    twice; each call counted."""
    q, kp, vp, table = inputs(2, seed=3)
    dt = getattr(torch, kd)
    qd = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    kd_, vd = (torch.from_numpy(a).to(cuda_device, dt) for a in (kp, vp))
    lens = torch.from_numpy(LENGTHS).to(cuda_device)
    tab = torch.from_numpy(table).to(cuda_device)
    used = np.zeros(P, bool)
    for row, n in zip(table, LENGTHS):
        used[row[:-(-int(n) // PS)]] = True
    kq, vq = kd_.clone(), vd.clone()
    kq[:, torch.from_numpy(~used)] = float("nan")
    vq[:, torch.from_numpy(~used)] = float("nan")
    before = tpk.paged_attention_tpu.launches
    got = tpk.paged_attention_tpu(qd, kq, vq, lens, tab,
                                  pages_per_compute_block=ppcb)
    assert tpk.paged_attention_tpu.launches == before + 1
    want = tpk.paged_attention_tpu_plain(qd, kd_, vd, lens, tab)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= (
        1e-5 * want.abs().max().item())
    assert not got[1].any()
    assert torch.equal(got, tpk.paged_attention_tpu(
        qd, kq, vq, lens, tab, pages_per_compute_block=ppcb))


@pytest.mark.cuda
def test_b21_kernel_takes_a_batch_strided_q(cuda_device):
    """B21 on the card on q [B, Hq, D] cut from a wider f32 tensor (the
    roped q of the unfused route, batch stride 2 Hq D) gives what it gives
    on a contiguous copy of it, bit for bit; a q whose head stride is not D
    is copied first and gives the same."""
    q, kp, vp, table = inputs(2, seed=4)
    dev = cuda_device
    wide = torch.randn((B, 2 * q.shape[1], D), device=dev)
    wide[:, :q.shape[1]] = torch.from_numpy(q).to(dev)
    strided = wide[:, :q.shape[1]]
    heads = torch.randn((B, q.shape[1], 2 * D), device=dev)
    heads[..., :D] = strided
    pools = [torch.from_numpy(a).to(dev, torch.bfloat16) for a in (kp, vp)]
    lens = torch.from_numpy(LENGTHS).to(dev)
    tab = torch.from_numpy(table).to(dev)
    want = tpk.paged_attention_tpu(strided.contiguous(), *pools, lens, tab)
    for qq in (strided, heads[..., :D]):
        assert torch.equal(tpk.paged_attention_tpu(qq, *pools, lens, tab),
                           want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
def test_b21_kernel_splits_long_sequences(cuda_device, b):
    """B21 on the card at long lengths (pp 512 pages of 64 rows, 32 heads,
    bf16 pools), where a sequence's pages are split over many blocks: B = 1
    at 32,767 rows and B = 8 at ragged lengths up to 32,767, NaN in every
    page no sequence reaches and in the tails of partly filled pages;
    within 1e-5 of the largest output of the plain version, bit-equal
    twice."""
    rng = np.random.default_rng(5 + b)
    h, d, ps, pp = 32, 128, 64, 512
    lengths = np.array([32767, 4096, 300, 0, 65, 1, 20000, 4097][:b],
                       np.int32)
    need = [-(-int(n) // ps) for n in lengths]
    p = sum(need) + 1
    dev = cuda_device
    kp = torch.randn((h, p, ps, d), device=dev).to(torch.bfloat16)
    vp = torch.randn((h, p, ps, d), device=dev).to(torch.bfloat16)
    table = np.zeros((b, pp), np.int32)
    perm = rng.permutation(p - 1)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n]
        at += n
    clean = (kp.clone(), vp.clone())
    for i, n in enumerate(lengths):
        if n % ps:
            last = int(table[i, int(n) // ps])
            kp[:, last, int(n) % ps:] = float("nan")
            vp[:, last, int(n) % ps:] = float("nan")
    kp[:, p - 1] = float("nan")
    vp[:, p - 1] = float("nan")
    q = torch.randn((b, h, d), device=dev)
    lens = torch.from_numpy(lengths).to(dev)
    tab = torch.from_numpy(table).to(dev)
    got = tpk.paged_attention_tpu(q, kp, vp, lens, tab,
                                  pages_per_compute_block=64)
    want = tpk.paged_attention_tpu_plain(q, *clean, lens, tab)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= (
        1e-5 * want.abs().max().item())
    assert torch.equal(got, tpk.paged_attention_tpu(
        q, kp, vp, lens, tab, pages_per_compute_block=64))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("pool", ["bfloat16", "float32"])
def test_fused_b21_kernel_matches_plain(cuda_device, pool, g):
    """The fused B21 step on the card against its plain version at
    FUSED_LENGTHS and an inactive slot: the pools bit for bit on every page
    a sequence reads, ctx within 1e-5 of the largest output on the active
    slots (the new row from registers is what B21 reads back), finite
    everywhere; bit-equal on a second run from the same pools; counted."""
    case = fused_case(g, seed=15)
    qkv, kp, vp, lengths, table, page_ids, offsets, cos, sin, used = case
    dt = getattr(torch, pool)
    dev = cuda_device
    t = [torch.from_numpy(a).to(dev) for a in (qkv, lengths, table,
                                                page_ids, offsets, cos, sin)]
    pools = [torch.from_numpy(a).to(dt).to(dev) for a in (kp, vp)]
    again = [x.clone() for x in pools]
    ref = [x.clone() for x in pools]
    before = tpk.paged_attention_tpu_fused.launches
    got = tpk.paged_attention_tpu_fused(t[0], *pools, *t[1:],
                                        pages_per_compute_block=2)
    assert tpk.paged_attention_tpu_fused.launches == before + 1
    want = tpk.paged_attention_tpu_fused_plain(t[0], *ref, *t[1:])
    for x, y in zip(pools, ref):
        assert torch.equal(x[:, used], y[:, used])
    assert bool(torch.isfinite(got).all())
    assert (got - want)[:-1].abs().max().item() <= (
        1e-5 * want[:-1].abs().max().item())
    assert torch.equal(got, tpk.paged_attention_tpu_fused(
        t[0], *again, *t[1:], pages_per_compute_block=2))
