"""PyTorch port: the fresh-prompt flash prefill attention (kernel B12's
plain version) against the JAX package's _flash_prefill_attention, which
calls the library Pallas TPU kernel, run here in TPU interpret mode, at
head widths 128 and 256; B12's launch plan and a numpy emulation of the
kernel's schedule; the port's bf16 forward and paged prefill with the gate
open against the JAX forward with its gate opened the same way, the bf16
operands they hand B12, and the gate itself."""
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fastllama_tpu.config import HyperParams
from fastllama_tpu.engine import paged_kv as jpk
from fastllama_tpu.models import llama as jl
from fastllama_tpu.models.fuse import make_layer_params
from fastllama_tpu.quant.q4 import quantize_q4_0
from fastllama_tpu.quant.tensor import make_embedding, make_matmul_weight
from fastllama_tpu_torch.config import RuntimeConfig
from fastllama_tpu_torch.engine import paged_kv as tpk
from fastllama_tpu_torch.engine import scheduler as ts
from fastllama_tpu_torch.engine.tokenizer import Vocab
from fastllama_tpu_torch.kernels import flash_prefill as tfp
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.models.runtime import LlamaModel

from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

# head_dim 128: the kernel's width and the gate's lane alignment
HP = HyperParams(n_vocab=320, n_embd=256, n_head=2, n_layer=2, n_rot=128)
N_FF = 256
N_CTX = 256
# the library kernel's output is bf16: a rounding tie or a sum order can
# move an element by one bf16 ulp (2^-8 relative), so 2^-7 of the largest
# output
TOL = 2.0 ** -7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def qkv_inputs(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def bf16(x):
    """A numpy f32 array as the bf16 tensor B12 takes."""
    return torch.from_numpy(x).to(torch.bfloat16)


# The JAX references run jitted: dispatched op by op, a JAX op issued
# while the Pallas interpreter's callback thread runs one of its own can
# deadlock the two (seen in the forwards under six test workers).


def jax_flash(q, k, v):
    """The JAX package's _flash_prefill_attention, the library Pallas
    kernel in TPU interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(jl._flash_prefill_attention, static_argnums=3)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q.shape[-1])
        return np.asarray(jax.block_until_ready(out))


def close(got, want, rel=TOL):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# B12's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("t", [128, 512, 1024])
def test_plain_matches_the_library_kernel(t, b):
    """flash_prefill_plain (and the wrapper on CPU tensors, which takes
    bf16 operands) against the library kernel in interpret mode, T = 1024
    taking two 512-row blocks, within 2^-7 of the largest output; the
    output is bf16-valued."""
    q, k, v = qkv_inputs(b, t, 2, 128, seed=t + b)
    want = jax_flash(q, k, v)
    launches = tfp.flash_prefill.launches
    got = tfp.flash_prefill(*(bf16(x) for x in (q, k, v)))
    assert tfp.flash_prefill.launches == launches      # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (b, t, 2, 128)
    assert torch.equal(got, got.to(torch.bfloat16).float())
    close(got.numpy(), want)
    plain = tfp.flash_prefill_plain(*(torch.from_numpy(x) for x in (q, k, v)))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("t", [128, 256])
def test_plain_matches_the_library_kernel_at_head_dim_256(t):
    """At Dh = 256, a width the gate admits (Dh % 128 == 0), the plain
    version against the library kernel in interpret mode, within 2^-7 of
    the largest output."""
    q, k, v = qkv_inputs(1, t, 2, 256, seed=t + 256)
    want = jax_flash(q, k, v)
    got = tfp.flash_prefill(*(bf16(x) for x in (q, k, v)))
    assert got.shape == (1, t, 2, 256)
    assert torch.equal(got, got.to(torch.bfloat16).float())
    close(got.numpy(), want)


def test_plain_reads_strided_views():
    """q and k as the halves of a roped [B, T, 2H, Dh] tensor and v as
    rows of a slab cache [B, S, H Dh] (the forward's views) give the result
    of contiguous copies."""
    rng = np.random.default_rng(3)
    qk = bf16(rng.standard_normal((2, 128, 4, 128)).astype(np.float32))
    cache = bf16(rng.standard_normal((2, 256, 256)).astype(np.float32))
    q, k = qk[:, :, :2], qk[:, :, 2:]
    v = cache[:, :128].view(2, 128, 2, 128)
    assert not v.is_contiguous()
    got = tfp.flash_prefill(q, k, v)
    want = tfp.flash_prefill(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


def test_plain_is_causal_attention_to_bf16_rounding():
    """The plain version is softmax(q k^T / sqrt(Dh), causal) v of the
    bf16-rounded operands, to the roundings it adds (p and the output in
    bf16)."""
    q, k, v = (torch.from_numpy(x) for x in qkv_inputs(1, 256, 2, 128, 7))
    r = [x.to(torch.bfloat16).float().transpose(1, 2) for x in (q, k, v)]
    s = r[0] @ r[1].transpose(-1, -2) / math.sqrt(128)
    s = s.masked_fill(torch.ones(256, 256).triu(1).bool(), -math.inf)
    want = (torch.softmax(s, -1) @ r[2]).transpose(1, 2)
    close(tfp.flash_prefill_plain(q, k, v).numpy(), want.numpy())


@pytest.mark.parametrize("bad", ["shape", "f32", "mixed"])
def test_wrapper_refuses_bad_inputs(bad):
    """The forward hands B12 bf16 operands of one shape; anything else is
    refused on the CPU as on the card."""
    q, k, v = (bf16(x) for x in qkv_inputs(1, 128, 2, 128, 1))
    if bad == "shape":
        k = k[:, :64]
    elif bad == "f32":
        q, k, v = (x.float() for x in (q, k, v))
    else:
        v = v.float()
    with pytest.raises(ValueError):
        tfp.flash_prefill(q, k, v)


def cache_operands(dev, b, t, h, d, seed):
    """The forward's operands on the slab path: q the bf16 half of a roped
    [B, T, 2H, Dh] tensor, K and V rows 0..T-1 of bf16 caches [B, S, H Dh]
    with S = T + 64 (strides S H Dh, H Dh, Dh, 1)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qk = torch.randn((b, t, 2 * h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kc, vc = (torch.randn((b, t + 64, h * d), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    return (qk[:, :, :h], kc[:, :t].view(b, t, h, d),
            vc[:, :t].view(b, t, h, d))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("t,h", [(128, 40), (512, 32), (512, 8),
                                 (1024, 16), (2048, 8)])
def test_kernel_matches_plain_on_the_card(cuda_device, t, h, d):
    """B12 on the card against its plain version on the forward's operands
    (q a strided half, K and V slab-cache views), B = 2, under b12_plan's
    plan (split keys at few heads), within 2^-7 of the largest output,
    bf16-valued, the same twice, launches counted."""
    q, k, v = cache_operands(cuda_device, 2, t, h, d, seed=t + h + d)
    n = tfp.flash_prefill.launches
    got = tfp.flash_prefill(q, k, v)
    again = tfp.flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert tfp.flash_prefill.launches == n + 2
    want = tfp.flash_prefill_plain(q, k, v)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert torch.equal(got, got.to(torch.bfloat16).float())
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(1, 2, 1), (1, 3, 3), (2, 2, 1),
                                  (2, 3, 2), (2, 3, 16)])
def test_kernel_under_every_plan_kind(cuda_device, plan, monkeypatch):
    """Each kind of plan (64- and 128-row query tiles, two and three
    stages, every key tile its own split up to no split) gives the plain
    version's result at Dh 128 and, with one consumer, 256."""
    nc, stages, kchunk = plan
    monkeypatch.setattr(tfp, "b12_plan", lambda *a: tfp.B12Plan(*plan))
    for d in (128, 256):
        if d == 256 and nc == 2:
            continue                    # not a Dh-256 shape
        q, k, v = cache_operands(cuda_device, 1, 512, 4, d, seed=d + kchunk)
        got = tfp.flash_prefill(q, k, v)
        want = tfp.flash_prefill_plain(q, k, v)
        err = (got - want).abs().max().item()
        assert err <= TOL * want.abs().max().item(), (plan, d, err)


@pytest.mark.cuda
def test_kernel_refuses_unsupported_shapes(cuda_device):
    q = torch.zeros((1, 192, 2, 128), dtype=torch.bfloat16,
                    device=cuda_device)
    with pytest.raises(ValueError):
        tfp.flash_prefill(q, q, q)                     # T % 128
    q = torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16,
                    device=cuda_device)
    with pytest.raises(ValueError):
        tfp.flash_prefill(q, q, q)                     # head_dim


# ---------------------------------------------------------------------------
# B12's plan and schedule
# ---------------------------------------------------------------------------

SHAPES = [(b, h, t) for b in (1, 2) for h in (8, 16, 32, 40)
          for t in (128, 256, 512, 1024, 2048)]


class B12Item(NamedTuple):
    """One block's work, as the kernel's decode() gives it: query rows
    q0 .. q0 + 64 nc - 1 of (b, h), key tiles kt0 .. kt0 + nkt - 1, split z
    of nsplit; tile is the split query tile's scratch index (-1 if whole)."""
    b: int
    h: int
    q0: int
    kt0: int
    nkt: int
    nsplit: int
    z: int
    tile: int


def b12_items(plan, b, h, t, d):
    """Every block's item in launch order, as the kernel's decode() walks
    the grid: item w is (b, h) = w % (B H) of the w // (B H)-th item of a
    head, whose items run from the last query tile to the first, splits
    in order; the grid and split tiles as b12_grid counts them."""
    bm, bn = tfp.b12_tiles(d, plan.nc)
    nk = [-(-(i + 1) * bm // bn) for i in range(t // bm)]
    n_qt = len(nk)
    items, split_from, _ = tfp.b12_grid(plan, b, h, t, d)
    per_head = []
    for i in reversed(range(n_qt)):
        ns = -(-nk[i] // plan.kchunk)
        for z in range(ns):
            kt0 = z * plan.kchunk
            per_head.append((i, z, ns, kt0, min(nk[i] - kt0, plan.kchunk)))
    out = []
    for w in range(items):
        bh = w % (b * h)
        i, z, ns, kt0, nkt = per_head[w // (b * h)]
        tile = bh * (n_qt - split_from) + i - split_from if ns > 1 else -1
        out.append(B12Item(bh // h, bh % h, i * bm, kt0, nkt, ns, z, tile))
    return out


@pytest.mark.parametrize("d", [128, 256])
def test_b12_plan_covers_each_causal_pair_once(d):
    """Across b12_plan's items (tiles and splits) every (query row, key)
    pair at or below the diagonal of every (b, h) is in exactly one item
    whose key tiles it lies in, and no item holds a tile wholly above its
    query rows; a split tile's items share one scratch index, unique to
    it, within the scratch b12_scratch sizes."""
    for b, h, t in SHAPES:
        plan = tfp.b12_plan(b, h, t, d, 132)
        bm, bn = tfp.b12_tiles(d, plan.nc)
        seen = np.zeros((b, h, t // bm, t // bn), np.int32)
        tiles = {}
        n_part, n_ctr = tfp.b12_scratch(plan, b, h, t, d)
        for it in b12_items(plan, b, h, t, d):
            assert 1 <= it.nkt <= plan.kchunk and it.q0 % bm == 0
            assert it.kt0 * bn < it.q0 + bm           # not above the rows
            seen[it.b, it.h, it.q0 // bm, it.kt0:it.kt0 + it.nkt] += 1
            if it.nsplit > 1:
                assert 0 <= it.tile < n_ctr
                tiles.setdefault(it.tile, set()).add((it.b, it.h, it.q0,
                                                      it.z))
        for i in range(t // bm):
            need = -(-(i + 1) * bm // bn)             # keys up to its rows
            assert (seen[:, :, i, :need] == 1).all(), (b, h, t, i)
            assert (seen[:, :, i, need:] == 0).all()
        for members in tiles.values():
            assert len({m[:3] for m in members}) == 1
            assert sorted(m[3] for m in members) == list(range(len(members)))
        assert n_part == n_ctr * max(
            [it.nsplit for it in b12_items(plan, b, h, t, d)]
        ) * (d // 2 + 4) * 128 * plan.nc or n_ctr == 0


@pytest.mark.parametrize("d", [128, 256])
def test_b12_plan_splits_only_where_the_chain_outlasts_the_card(d):
    """At 1-40 heads and T = 128-4096 every query tile has a block; a
    query tile's keys are split, in two, only where the heaviest chain of
    key tiles exceeds the card's share of all the tile products (132 SMs)
    by more than a split costs (SPLIT_COST tiles), and then no block's
    chain is longer than that share or half the heaviest chain; items go
    heaviest first within each round of heads."""
    for b, h, t in SHAPES + [(1, h, t) for h in (1, 2, 4)
                             for t in (512, 2048, 4096)]:
        plan = tfp.b12_plan(b, h, t, d, 132)
        bm, bn = tfp.b12_tiles(d, plan.nc)
        nk = [-(-(i + 1) * bm // bn) for i in range(t // bm)]
        share = -(-b * h * sum(nk) // 132)
        items = b12_items(plan, b, h, t, d)
        assert len(items) >= b * h * (t // bm)
        assert max(it.nsplit for it in items) <= 2
        longest = max(it.nkt for it in items)
        if nk[-1] <= share + tfp.SPLIT_COST:
            assert longest == nk[-1], (b, h, t, plan)
        else:
            assert longest == max(share, -(-nk[-1] // 2)), (b, h, t, plan)
        first = items[:b * h]
        assert all(it.q0 == t - bm and it.z == 0 for it in first)
    # 7B's 32 heads at T = 512: 128-row tiles, three stages, no split; a
    # rank's 8 heads at T = 2048: the last tiles' 16 key tiles in two
    assert tfp.b12_plan(1, 32, 512, 128, 132) == tfp.B12Plan(2, 3, 4)
    assert tfp.b12_plan(1, 8, 2048, 128, 132) == tfp.B12Plan(2, 3, 9)


def ulp_bf16(x):
    """One bf16 ulp at |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


def r_bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def emulate_kernel(q, k, v, plan):
    """numpy emulation of the kernel's schedule on bf16-valued f32 inputs
    [B, T, H, D]: each item of b12_items, each consumer warpgroup's 64 rows
    over its key tiles (the ones not wholly above its rows): scores in f32
    times scale log2(e), the diagonal tiles masked, the running max m in
    log2 units, p = 2^(x - m) rounded to bf16 per tile for the PV product,
    l summing the unrounded p; O, holding P V of the tiles before j, is
    rescaled by tile j's factor before tile j's product adds in. A whole
    query tile stores bf16(O / l); a split one keeps (O, m, l) per split
    and the last merges them in split order."""
    b, t, h, d = q.shape
    bm, bn = tfp.b12_tiles(d, plan.nc)
    sl2 = np.float32(1.0 / math.sqrt(d) * 1.4426950408889634)
    out = np.zeros((b, t, h, d), np.float32)
    parts = {}
    for it in b12_items(plan, b, h, t, d):
        for cw in range(plan.nc):
            r0 = it.q0 + 64 * cw
            rows = np.arange(r0, r0 + 64)
            qr = q[it.b, r0:r0 + 64, it.h]
            n_mine = max(0, min(it.nkt, (r0 + 63) // bn + 1 - it.kt0))
            m = np.full(64, -np.inf, np.float32)
            l = np.zeros(64, np.float32)
            o = np.zeros((64, d), np.float32)
            prev = None
            for j in range(n_mine):
                k0 = (it.kt0 + j) * bn
                keys = np.arange(k0, k0 + bn)
                x = (qr @ k[it.b, k0:k0 + bn, it.h].T) * sl2
                x = np.where(keys[None, :] > rows[:, None], -np.inf, x)
                mn = np.maximum(m, x.max(1))
                a = np.exp2(m - mn).astype(np.float32)
                p = np.exp2(x - mn[:, None]).astype(np.float32)
                m, l = mn, l * a + p.sum(1, dtype=np.float32)
                if prev is not None:
                    o = (o + prev) * a[:, None]
                prev = r_bf16(p) @ v[it.b, k0:k0 + bn, it.h]
            if prev is not None:
                o = o + prev
            key = (it.b, it.h, r0)
            if it.nsplit == 1:
                out[it.b, r0:r0 + 64, it.h] = r_bf16(o * (1 / l)[:, None])
                continue
            parts.setdefault(key, {})[it.z] = (o, m, l)
            if len(parts[key]) < it.nsplit:
                continue
            zs = [parts[key][z] for z in range(it.nsplit)]
            mm = np.max([zm for _, zm, _ in zs], axis=0)
            ll = np.zeros(64, np.float32)
            oo = np.zeros((64, d), np.float32)
            for zo, zm, zl in zs:
                w = np.exp2(zm - mm).astype(np.float32)
                ll = ll + zl * w
                oo = oo + zo * w[:, None]
            out[it.b, r0:r0 + 64, it.h] = r_bf16(oo * (1 / ll)[:, None])
    return out


@pytest.mark.parametrize("d,t,plan", [
    (128, 512, tfp.B12Plan(2, 3, 3)),     # a split tile
    (128, 512, tfp.B12Plan(1, 3, 1)),     # every key tile its own split
    (128, 512, tfp.B12Plan(2, 3, 4)),     # no split (7B's plan)
    (128, 256, tfp.B12Plan(1, 3, 1)),     # key tiles wider than the rows
    (256, 512, tfp.B12Plan(1, 3, 3)),
])
def test_kernel_schedule_matches_plain_to_one_ulp(d, t, plan):
    """The kernel's schedule (emulate_kernel: its tiles, per-tile p
    rounding against the running max, the rescale order and the split
    merge) against the plain version (the library's 512-row blocks),
    within one bf16 ulp of the largest output."""
    q, k, v = (r_bf16(x) for x in qkv_inputs(1, t, 2, d, seed=d + t))
    got = emulate_kernel(q, k, v, plan)
    want = tfp.flash_prefill_plain(*(torch.from_numpy(x) for x in (q, k, v))
                                   ).numpy()
    assert np.array_equal(got, r_bf16(got))
    err = np.abs(got - want).max()
    assert err <= ulp_bf16(np.abs(want).max()), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# the slice: forward and forward_paged_prefill with the gate open
# ---------------------------------------------------------------------------

def jax_params(seed=0, hp=HP):
    rng = np.random.default_rng(seed)

    def qw(k_in, n_out, scale=0.1):
        return ("q4",) + quantize_q4_0(
            (rng.standard_normal((n_out, k_in)) * scale).astype(np.float32))

    d = hp.n_embd
    layers = [make_layer_params(
        hp.n_head,
        attention_norm=(1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ffn_norm=(1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        wq=qw(d, d, 0.2), wk=qw(d, d, 0.2), wv=qw(d, d), wo=qw(d, d),
        w1=qw(d, N_FF), w2=qw(N_FF, d), w3=qw(d, N_FF),
    ) for _ in range(hp.n_layer)]
    emb = (rng.standard_normal((hp.n_vocab, d)) * 0.4).astype(np.float32)
    out = (rng.standard_normal((hp.n_vocab, d)) * 0.15).astype(np.float32)
    return jl.LlamaParams(
        tok_embeddings=make_embedding(*quantize_q4_0(emb)),
        norm=jnp.ones(d), output=make_matmul_weight(*quantize_q4_0(out)),
        layers=layers)


def with_qkv_lora(jp, tp, seed=5):
    """A delta LoRA term on wq and an (a, b) term on wv of layer 0."""
    rng = np.random.default_rng(seed)
    d = HP.n_embd
    dq = (rng.standard_normal((d, d)) * 0.02).astype(np.float32)
    a = (rng.standard_normal((d, 8)) * 0.1).astype(np.float32)
    bm = (rng.standard_normal((8, d)) * 0.1).astype(np.float32)
    jp = dataclasses.replace(jp, layers=[dataclasses.replace(
        jp.layers[0], lora_wq=jl.LoraTerm(delta=jnp.asarray(dq)),
        lora_wv=jl.LoraTerm(a=jnp.asarray(a), b=jnp.asarray(bm)))]
        + jp.layers[1:])
    tp = dataclasses.replace(tp, layers=[dataclasses.replace(
        tp.layers[0], lora_wq=tl.LoraTerm(delta=torch.from_numpy(dq)),
        lora_wv=tl.LoraTerm(a=torch.from_numpy(a), b=torch.from_numpy(bm)))]
        + tp.layers[1:])
    return jp, tp


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, tl.params_from_numpy(to_numpy_tree(jp), device="cpu")


# a head width of 256 (two heads of n_embd 512), which the gate admits
HP256 = dataclasses.replace(HP, n_embd=512, n_rot=256)


@pytest.fixture(scope="module")
def params256():
    jp = jax_params(seed=1, hp=HP256)
    return jp, tl.params_from_numpy(to_numpy_tree(jp), device="cpu")


def vocab():
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" w{i}".encode(), 1.0) for i in range(HP.n_vocab - len(toks))]
    return Vocab.from_tokens(toks)


def open_jax_gate(monkeypatch):
    """The JAX gate minus its backend test (a test-time override: the
    library kernel then runs in interpret mode on the CPU)."""
    def viable(cfg, t, hd):
        return (cfg.flash_prefill and cfg.sp_axis is None
                and t >= 128 and t % 128 == 0
                and hd % 128 == 0 and cfg.w_jdtype != jnp.float32)
    monkeypatch.setattr(jl, "_flash_viable", viable)


def spy_flash(monkeypatch):
    """Count the forward's calls of B12 (the name models/llama imported)."""
    calls = []
    real = tl.flash_prefill

    def spy(q, k, v):
        calls.append(q.shape)
        return real(q, k, v)
    monkeypatch.setattr(tl, "flash_prefill", spy)
    return calls


def jax_cfg(hp=HP, **kw):
    return jl.ForwardConfig(n_head=hp.n_head, n_rot=hp.n_rot,
                            w_dtype="bfloat16", use_pallas=False,
                            prefill_int8=False, **kw)


PROMPT = [1] + np.random.default_rng(11).integers(3, HP.n_vocab,
                                                  127).tolist()   # 128


# Off the gate the two forwards agree to f32 rounding. With it open each
# side rounds q, k, v, p and the output to bf16, and the plain version
# parts from the library kernel by one bf16 ulp in a fifth of the ctx
# elements (held to 2^-7 above). This model's scores reach ~45, so p is
# peaked and such an ulp moves the logits by ~1e-2 of the largest after
# two layers, as much as the JAX flash path parts from its own masked f32
# path: the bf16 tolerance of the port's other bf16 paths, 3e-2.
SLICE_TOL = 3e-2


@pytest.mark.parametrize("lora", [False, True])
def test_forward_through_eval_matches_jax_flash(params, monkeypatch, lora):
    """The port's bf16 LlamaModel.eval at n_past 0 over a 128-token window
    (the session's first window: B12's plain version, in every layer, q/k/v
    LoRA or not) against the JAX package's un-jitted forward with
    flash_prefill=True and its gate opened under interpret mode."""
    jp, tp = params
    if lora:
        jp, tp = with_qkv_lora(jp, tp)
    calls = spy_flash(monkeypatch)
    lm = LlamaModel(HP, tp, vocab(), RuntimeConfig(
        n_ctx=N_CTX, kv_dtype="bfloat16", weight_dtype="bfloat16",
        prefill_int8=False), device="cpu")
    got = lm.eval(0, PROMPT)
    assert len(calls) == HP.n_layer
    emb = lm.get_embeddings()

    open_jax_gate(monkeypatch)
    jkv = jl.init_kv_cache(HP, 1, N_CTX, dtype=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        jlog, jkv, jemb = jax.jit(jl.forward, static_argnums=4)(
            jp, jnp.asarray([PROMPT], jnp.int32), jnp.int32(0), jkv,
            jax_cfg(flash_prefill=True), jnp.int32(len(PROMPT) - 1))
        jlog, jemb = jax.block_until_ready((jlog, jemb))
    close(got, np.asarray(jlog)[0, -1], SLICE_TOL)
    close(emb, np.asarray(jemb)[0], SLICE_TOL)
    # the cache holds the window's rows as the masked path would write them
    for (tk, _), (jk, _) in zip(lm.kv, jkv):
        np.testing.assert_allclose(
            tk[0, :128].float().numpy(),
            np.asarray(jk[0, :128].astype(jnp.float32)),
            atol=2 ** -7 * float(jnp.abs(jk[0, :128]).max()))


def test_forward_paged_prefill_matches_jax_flash(params, monkeypatch):
    """forward_paged_prefill of a 120-token prompt bucketed to 128 (the
    sentinel tail) with flash_prefill=True against the JAX function with
    its gate opened under interpret mode; the pools' rows agree too."""
    jp, tp = params
    t0, bucket = 120, 128
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :t0] = PROMPT[:t0]
    kw = dict(n_slots=1, page_size=16, total_pages=8, pages_per_seq=8)
    jm = jpk.PagedKVManager(HP, dtype=jnp.bfloat16, **kw)
    tm = tpk.PagedKVManager(HP, dtype=torch.bfloat16, device="cpu", **kw)
    for m in (jm, tm):
        assert m.alloc_for(0, t0)
    pages = np.full(bucket, jm.sentinel, np.int32)
    offs = np.zeros(bucket, np.int32)
    pages[:t0], offs[:t0] = jm.token_page_offsets(0, 0, t0)

    calls = spy_flash(monkeypatch)
    tcfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                            w_dtype="bfloat16", prefill_int8=False,
                            flash_prefill=True)
    tlog, _, _ = tl.forward_paged_prefill(
        tp, torch.from_numpy(toks).long(), t0 - 1, torch.from_numpy(pages),
        torch.from_numpy(offs), tm.k_pages, tm.v_pages, tcfg)
    assert len(calls) == HP.n_layer

    open_jax_gate(monkeypatch)
    with pltpu.force_tpu_interpret_mode():
        jlog, jkp, _ = jax.jit(jl.forward_paged_prefill, static_argnums=7)(
            jp, jnp.asarray(toks), jnp.int32(t0 - 1), jnp.asarray(pages),
            jnp.asarray(offs), jm.k_pages, jm.v_pages,
            jax_cfg(flash_prefill=True))
        jlog = jax.block_until_ready(jlog)
    close(tlog.numpy(), np.asarray(jlog), SLICE_TOL)
    used = sorted(set(pages[:t0].tolist()))
    for tk, jk in zip(tm.k_pages, jkp):
        want = np.asarray(jk[:, used].astype(jnp.float32))
        np.testing.assert_allclose(tk[:, used].float().numpy(), want,
                                   atol=2 ** -7 * np.abs(want).max())


def test_head_dim_256_forward_and_paged_prefill_match_jax_flash(
        params256, monkeypatch):
    """A tiny Dh-256 model (two heads of 256): the port's bf16
    LlamaModel.eval at n_past 0 and forward_paged_prefill, each through
    B12's plain version in every layer, against the JAX forwards with
    flash_prefill=True and the gate opened under interpret mode, at the
    port's bf16 tolerance of the largest logit."""
    jp, tp = params256
    calls = spy_flash(monkeypatch)
    lm = LlamaModel(HP256, tp, vocab(), RuntimeConfig(
        n_ctx=N_CTX, kv_dtype="bfloat16", weight_dtype="bfloat16",
        prefill_int8=False), device="cpu")
    got = lm.eval(0, PROMPT)
    t0, bucket = 120, 128
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :t0] = PROMPT[:t0]
    kw = dict(n_slots=1, page_size=16, total_pages=8, pages_per_seq=8)
    jm = jpk.PagedKVManager(HP256, dtype=jnp.bfloat16, **kw)
    tm = tpk.PagedKVManager(HP256, dtype=torch.bfloat16, device="cpu", **kw)
    for m in (jm, tm):
        assert m.alloc_for(0, t0)
    pages = np.full(bucket, jm.sentinel, np.int32)
    offs = np.zeros(bucket, np.int32)
    pages[:t0], offs[:t0] = jm.token_page_offsets(0, 0, t0)
    tlog, _, _ = tl.forward_paged_prefill(
        tp, torch.from_numpy(toks).long(), t0 - 1, torch.from_numpy(pages),
        torch.from_numpy(offs), tm.k_pages, tm.v_pages,
        tl.ForwardConfig(n_head=HP256.n_head, n_rot=HP256.n_rot,
                         w_dtype="bfloat16", prefill_int8=False,
                         flash_prefill=True))
    assert calls == [(1, 128, 2, 256)] * (2 * HP256.n_layer)

    open_jax_gate(monkeypatch)
    jkv = jl.init_kv_cache(HP256, 1, N_CTX, dtype=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        jlog, _, _ = jax.jit(jl.forward, static_argnums=4)(
            jp, jnp.asarray([PROMPT], jnp.int32), jnp.int32(0), jkv,
            jax_cfg(HP256, flash_prefill=True), jnp.int32(len(PROMPT) - 1))
        jplog, _, _ = jax.jit(jl.forward_paged_prefill, static_argnums=7)(
            jp, jnp.asarray(toks), jnp.int32(t0 - 1), jnp.asarray(pages),
            jnp.asarray(offs), jm.k_pages, jm.v_pages,
            jax_cfg(HP256, flash_prefill=True))
        jlog, jplog = jax.block_until_ready((jlog, jplog))
    close(got, np.asarray(jlog)[0, -1], SLICE_TOL)
    close(tlog.numpy(), np.asarray(jplog), SLICE_TOL)


@pytest.mark.cuda
def test_head_dim_256_window_runs_on_the_card(cuda_device, params256):
    """The tiny Dh-256 model's first window on the card: the gate admits
    it, B12 launches once a layer (no raise), and the logits agree with
    the CPU run's (its plain version) at the port's bf16 tolerance."""
    _, tp = params256
    rcfg = RuntimeConfig(n_ctx=N_CTX, kv_dtype="bfloat16",
                         weight_dtype="bfloat16", prefill_int8=False)
    want = LlamaModel(HP256, tp, vocab(), rcfg, device="cpu").eval(0, PROMPT)
    lm = LlamaModel(HP256, tl.params_from_numpy(to_numpy_tree(
        params256[0]), device=cuda_device), vocab(), rcfg,
        device=cuda_device)
    n = tfp.flash_prefill.launches
    got = lm.eval(0, PROMPT)
    assert tfp.flash_prefill.launches == n + HP256.n_layer
    close(got, want, SLICE_TOL)


def test_flash_route_operands_are_bf16_rope_and_cache_rows(params,
                                                           monkeypatch):
    """On the flash route the RoPE pass stores q and k in bf16, bit for
    bit bf16 of its f32 result; the slab forward hands B12 that q and, for
    K and V, views of the bf16 cache rows the window just wrote (equal to
    the bf16 k and to bf16 v); the paged prefill hands it the bf16 q and k
    and a bf16 cast of v."""
    jp, tp = params
    ropes, seen = [], []
    real_rope, real_flash = tl.rope_interleaved_lanes, tl.flash_prefill

    def rope(x, cos, sin, n_rot, out_dtype=None):
        out = real_rope(x, cos, sin, n_rot, out_dtype)
        if out_dtype is not None:
            f32 = real_rope(x, cos, sin, n_rot)
            assert f32.dtype == torch.float32
            assert torch.equal(out, f32.to(out_dtype))
        ropes.append(out)
        return out

    def flash(q, k, v):
        seen.append((q, k, v))
        return real_flash(q, k, v)
    monkeypatch.setattr(tl, "rope_interleaved_lanes", rope)
    monkeypatch.setattr(tl, "flash_prefill", flash)
    lm = LlamaModel(HP, tp, vocab(), RuntimeConfig(
        n_ctx=N_CTX, kv_dtype="bfloat16", weight_dtype="bfloat16",
        prefill_int8=False), device="cpu")
    lm.eval(0, PROMPT)
    h, t = HP.n_head, len(PROMPT)
    assert len(seen) == HP.n_layer == len(ropes)
    for (q, k, v), qk, (kc, vc) in zip(seen, ropes, lm.kv):
        assert qk.dtype == torch.bfloat16
        assert all(x.dtype == torch.bfloat16 for x in (q, k, v))
        assert torch.equal(q, qk[:, :, :h]) and torch.equal(k, qk[:, :, h:])
        for x, cache in ((k, kc), (v, vc)):
            assert x.untyped_storage().data_ptr() == \
                cache.untyped_storage().data_ptr()
            assert torch.equal(x, cache[:, :t].view(1, t, h, -1))

    ropes.clear()
    seen.clear()
    tm = tpk.PagedKVManager(HP, dtype=torch.bfloat16, device="cpu",
                            n_slots=1, page_size=16, total_pages=8,
                            pages_per_seq=8)
    assert tm.alloc_for(0, t)
    pages, offs = tm.token_page_offsets(0, 0, t)
    tl.forward_paged_prefill(
        tp, torch.tensor([PROMPT]), t - 1, torch.from_numpy(pages),
        torch.from_numpy(offs), tm.k_pages, tm.v_pages,
        tl.ForwardConfig(n_head=h, n_rot=HP.n_rot, w_dtype="bfloat16",
                         prefill_int8=False, flash_prefill=True))
    assert len(seen) == HP.n_layer
    for (q, k, v), qk in zip(seen, ropes):
        assert all(x.dtype == torch.bfloat16 for x in (q, k, v))
        assert torch.equal(q, qk[:, :, :h]) and torch.equal(k, qk[:, :, h:])


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def test_gate_conditions():
    cfg = tl.ForwardConfig(n_head=2, n_rot=128, flash_prefill=True)
    assert tl._flash_viable(cfg, 128, 128)
    assert tl._flash_viable(cfg, 1024, 256)
    assert not tl._flash_viable(dataclasses.replace(cfg, flash_prefill=False),
                                128, 128)
    assert not tl._flash_viable(dataclasses.replace(cfg, w_dtype="float32"),
                                128, 128)
    assert not tl._flash_viable(dataclasses.replace(cfg, sp_group=object()),
                                128, 128)
    for t in (1, 64, 192):                              # T < 128, T % 128
        assert not tl._flash_viable(cfg, t, 128)
    assert not tl._flash_viable(cfg, 128, 64)           # head_dim % 128
    # the port's departure: a head wider than B12's widths is masked
    assert not tl._flash_viable(cfg, 128, 384)


def test_head_dim_384_takes_the_masked_route_within_bf16_tolerance(
        monkeypatch):
    """A head width the JAX gate admits but B12 is not built for (384):
    the port's first window takes the masked f32 route (B12 never called)
    and stays within the port's bf16 tolerance of the JAX forward on its
    flash path (interpret mode)."""
    hp = dataclasses.replace(HP, n_embd=768, n_rot=384)
    jp = jax_params(seed=2, hp=hp)
    tp = tl.params_from_numpy(to_numpy_tree(jp), device="cpu")
    calls = spy_flash(monkeypatch)
    lm = LlamaModel(hp, tp, vocab(), RuntimeConfig(
        n_ctx=N_CTX, kv_dtype="bfloat16", weight_dtype="bfloat16",
        prefill_int8=False), device="cpu")
    got = lm.eval(0, PROMPT)
    assert calls == []
    open_jax_gate(monkeypatch)
    jkv = jl.init_kv_cache(hp, 1, N_CTX, dtype=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        jlog, _, _ = jax.jit(jl.forward, static_argnums=4)(
            jp, jnp.asarray([PROMPT], jnp.int32), jnp.int32(0), jkv,
            jax_cfg(hp, flash_prefill=True), jnp.int32(len(PROMPT) - 1))
        jlog = jax.block_until_ready(jlog)
    close(got, np.asarray(jlog)[0, -1], SLICE_TOL)


def session_model(params, mode="bfloat16"):
    return LlamaModel(HP, params[1], vocab(), RuntimeConfig(
        n_ctx=N_CTX, kv_dtype=mode, weight_dtype=mode, prefill_int8=False),
        device="cpu")


def test_session_windows_take_b12_only_at_n_past_0(params, monkeypatch):
    """LlamaModel.eval picks the flash config for n_past == 0 and t > 1,
    as the JAX runtime does: the first window (bucket 128) enters B12 in
    every layer; a later window (n_past > 0, as an ingest chunk, a
    recycling re-feed or a window after load_state is), a window whose
    bucket is under 128, a decode step and f32 mode do not."""
    calls = spy_flash(monkeypatch)
    lm = session_model(params)
    lm.eval(0, PROMPT)
    assert len(calls) == HP.n_layer
    lm.eval(len(PROMPT), PROMPT[:100])           # n_past > 0, bucket 128
    lm.eval(len(PROMPT) + 100, [5])              # decode
    lm.eval(0, PROMPT[:60])                      # bucket 64
    lm.eval(0, [7])                              # one token at n_past 0
    assert len(calls) == HP.n_layer
    session_model(params, "float32").eval(0, PROMPT)
    assert len(calls) == HP.n_layer


def test_forward_off_the_gate_keeps_the_masked_path(params, monkeypatch):
    """With flash_prefill=True the forward still attends by the masked
    softmax where the gate fails: a 192-row window (T % 128) and f32
    weights."""
    calls = spy_flash(monkeypatch)
    for mode, t in (("bfloat16", 192), ("float32", 128)):
        cfg = tl.ForwardConfig(n_head=HP.n_head, n_rot=HP.n_rot,
                               w_dtype=mode, prefill_int8=False,
                               flash_prefill=True)
        kv = tl.init_kv_cache(HP, 1, N_CTX, dtype=getattr(torch, mode),
                              device="cpu")
        toks = torch.tensor([(PROMPT * 2)[:t]])
        logits, _, _ = tl.forward(params[1], toks, 0, kv, cfg)
        assert torch.isfinite(logits).all()
    assert calls == []


@pytest.mark.parametrize("kv_mode", ["slab", "paged"])
def test_engine_monolithic_admission_takes_b12(params, monkeypatch, kv_mode):
    """The engine's monolithic admission (slab row cache or paged) runs
    its prefill with flash_prefill=True: a prompt whose bucket is 128
    enters B12 in every layer, one whose bucket is 64 does not; chunked
    admission keeps the masked path, as in the JAX package."""
    calls = spy_flash(monkeypatch)
    prompts = [" ".join(f"w{i + 1}" for i in range(30)),
               " ".join(f"w{i + 1}" for i in range(8))]
    for chunked in (False, True):
        rcfg = RuntimeConfig(n_ctx=N_CTX, n_batch=128, kv_dtype="bfloat16",
                             weight_dtype="bfloat16", prefill_int8=False)
        eng = ts.BatchEngine(HP, params[1], vocab(), n_slots=2, n_ctx=N_CTX,
                             rcfg=rcfg, kv_mode=kv_mode, page_size=16,
                             temp=0.0, chunked_admission=chunked,
                             device="cpu")
        reqs = [ts.Request(prompt=p, max_tokens=3) for p in prompts]
        eng.run(reqs)
        assert all(r.done and len(r.tokens_out) == 3 for r in reqs)
        assert [64 < r.n_prompt <= 128 for r in reqs] == [True, False]
        assert len(calls) == HP.n_layer
