#!/usr/bin/env python3
"""Drive fastllama_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits nonzero before the last line):
  1. print the card (nvidia-smi name, power limit) and build the CUDA
     kernels from kernels/csrc/ (one nvcc per source, in parallel);
  2. hold each kernel (B1-B5, B9, B10) against its plain PyTorch version on
     the card at the 7B shapes of the paths below, and time kernel, plain
     version and bound (the larger of bytes / 3.35 TB/s and operations /
     peak rate); for B10 also one scaled_dot_product_attention call;
  3. the q4_0 session at full 7B width (32 layers, bf16 weights and KV,
     n_ctx 512, seeded random weights made on the card): LlamaModel +
     FastLlama ingest a 300-token prompt with n_batch 512 and generate 64
     tokens greedily; prints TTFT, decode tok/s and each kernel's launches
     in this run (B1-B4 must be > 0); then the same parameters under
     RuntimeConfig(prefill_int8=False), the bf16-exact prefill: B5 must
     launch 128 times per window and B2/B3 not at all;
  4. the q4_1 + LoRA session at the same width and depth (affine weights
     made on the card): a ggla adapter (A/B form, rank 8, wq and wv of
     every layer) written by the port's write_ggla is attached through
     attach_lora; while attached a decode step must launch B9 129 times,
     B10 32 times and B4 never; after detach_lora the same prompt's logits
     must equal those taken before the attach bit for bit, on B4 again;
  5. the file entry points: a 2-layer fltpu checkpoint, an 8-layer q4_0
     GGJT file and a 2-layer q4_1 GGJT file at 7B widths, each loaded with
     Model(path=...), ingested and decoded; prefill and first decode logits
     are held against the same file loaded on the CPU (plain versions);
  then one line {"kernels": [...]}, the nvidia-smi line, and last
  {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, calls: int, replays: int = 3) -> float:
    """Device time of one fn() call, by CUDA events around replays of a CUDA
    graph that holds `calls` calls, so the host's per-call cost (Python,
    ctypes, allocator) is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / (replays * calls)


# ---------------------------------------------------------------------------
# synthetic weights
# ---------------------------------------------------------------------------

def rand_weight(torch, k, n, gen, dev, affine=False):
    """A q4_0 matmul weight with the stored padding the loader applies:
    random codes and scales in [1e-3, 0.02] (as the JAX package's bench
    builds them), logical width n. affine: a q4_1 weight, with mins in
    about [-8 d, -7 d] so that q * d + m is centred like (q - 8) * d."""
    from fastllama_tpu_torch.quant.tensor import (
        QuantMatmulWeight, good_pad_k, good_pad_n)
    kp, np_ = good_pad_k(k), good_pad_n(n)
    qs = torch.randint(0, 256, (kp // 2, np_), generator=gen, device=dev,
                       dtype=torch.uint8)
    sc = torch.rand((kp // 32, np_), generator=gen, device=dev) * 0.019 + 1e-3
    mins = None
    if affine:
        mins = sc * (torch.rand((kp // 32, np_), generator=gen, device=dev)
                     - 8.0)
    return QuantMatmulWeight(qs=qs, scales=sc, mins=mins, n_logical=n)


def weight_bytes(w) -> int:
    planes = 1 if w.mins is None else 2
    return w.qs.numel() + planes * w.scales.numel() * 4


def rand_params(torch, hp, gen, dev, affine=False):
    from fastllama_tpu_torch.models.llama import LayerParams, LlamaParams
    from fastllama_tpu_torch.quant.tensor import QuantEmbedding
    d, f = hp.n_embd, hp.n_ff
    layers = [LayerParams(
        attention_norm=torch.ones(d, device=dev),
        wqkv=rand_weight(torch, d, 3 * d, gen, dev, affine),
        wo=rand_weight(torch, d, d, gen, dev, affine),
        ffn_norm=torch.ones(d, device=dev),
        w13=rand_weight(torch, d, 2 * f, gen, dev, affine),
        w2=rand_weight(torch, f, d, gen, dev, affine))
        for _ in range(hp.n_layer)]
    emb = QuantEmbedding(
        qs=torch.randint(0, 256, (hp.n_vocab, d // 2), generator=gen,
                         device=dev, dtype=torch.uint8),
        scales=torch.rand((hp.n_vocab, d // 32), generator=gen, device=dev)
        * 0.019 + 1e-3)
    out = rand_weight(torch, d, hp.n_vocab, gen, dev, affine)
    out.scales[:, 2] = 0.0        # EOS logit 0: greedy runs its full length
    if affine:
        out.mins[:, 2] = 0.0
    return LlamaParams(tok_embeddings=emb, norm=torch.ones(d, device=dev),
                       output=out, layers=layers)


def synthetic_vocab(n_vocab: int):
    from fastllama_tpu_torch.engine.tokenizer import Vocab
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" w{i}".encode(), 1.0) for i in range(n_vocab - len(toks))]
    return Vocab.from_tokens(toks)


def prompt_of(n_chars: int, seed: int) -> str:
    """Random lowercase text; the synthetic vocab gives one token per
    character, so it tokenizes to n_chars + 2 tokens (BOS, leading space)."""
    rng = np.random.default_rng(seed)
    return "".join(chr(97 + int(i)) for i in rng.integers(0, 26, n_chars))


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def copies_for(nbytes: int) -> int:
    """Distinct weight copies to cycle through so that timed launches find
    their weights in device memory, not in the 50 MB L2."""
    return max(2, math.ceil(160e6 / nbytes))


def check_kernels(torch, dev, gen, out_dir):
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import q4_matmul as qm

    def absum_of(x, wd, n, mode):
        """The largest sum |x| @ |W| of the rounded operands: the scale of
        the f32 reassociation tolerance."""
        return (qm._pad_k(x.abs(), wd.shape[0]).to(mode).float()
                @ wd.float().abs())[:, :n].max().item()

    results = {}
    # (name, K logical, N logical) of the main path's matmuls at 7B
    shapes = [("qkv", 4096, 12288), ("wo", 4096, 4096), ("w13", 4096, 22016),
              ("w2", 11008, 4096), ("head", 4096, 32000)]
    b1 = []
    for name, k, n in shapes:
        w = rand_weight(torch, k, n, gen, dev)
        wbytes = weight_bytes(w)
        ws = [w] + [rand_weight(torch, k, n, gen, dev)
                    for _ in range(copies_for(wbytes) - 1)]
        for m in (1, 64):
            x = torch.randn((m, k), generator=gen, device=dev)
            for mode in ((torch.bfloat16, torch.float32) if m == 1
                         and name == "wo" else (torch.bfloat16,)):
                y = qm.q4_matmul_decode(x, w, mode)
                y_ref = qm.q4_matmul_dequant(x, w, mode)
                # reassociation tolerance: 1e-5 of the absolute-sum |x| @ |W|
                err = (y - y_ref).abs().max().item()
                tol = 1e-5 * absum_of(x, qm.dequant_matmul_weight(w, mode),
                                      n, mode)
                require(bool(torch.isfinite(y).all()), f"B1 {name} not finite")
                require(err <= tol, f"B1 {name} M={m} {mode}: err {err} > {tol}")
                it = iter(range(10**9))
                ms = time_ms(torch, lambda: qm.q4_matmul_decode(
                    x, ws[next(it) % len(ws)], mode), calls=4 * len(ws))
                plain_ms = time_ms(torch, lambda: qm.q4_matmul_dequant(
                    x, w, mode), calls=2)
                kind = "bf16" if mode == torch.bfloat16 else "f32"
                bnd, by = bound_ms(wbytes + x.numel() * 4 + m * n * 4,
                                   2.0 * m * k * n, kind)
                b1.append(dict(shape=f"{name} M={m} K={k} N={n} {kind}",
                               max_abs_err=err, tol=tol, ms=ms,
                               plain_ms=plain_ms, bound_ms=bnd, bound_by=by))
                print(f"B1 {b1[-1]}", flush=True)
        del ws, w
    results["B1"] = b1

    b2, b3 = [], []
    m = 512
    for name, k, n in shapes[:4]:
        w = rand_weight(torch, k, n, gen, dev)
        x = torch.randn((m, k), generator=gen, device=dev) * 3.0
        xq, dx = qm.quant_rows_int8(x, w.k)
        xq_ref, dx_ref = qm.quant_rows_int8_plain(x, w.k)
        require(torch.equal(xq, xq_ref) and torch.equal(dx, dx_ref),
                f"B2 {name}: not bit-exact")
        if name in ("qkv", "w2"):          # the two K's of the main path
            ms = time_ms(torch, lambda: qm.quant_rows_int8(x, w.k), calls=20)
            plain_ms = time_ms(torch, lambda: qm.quant_rows_int8_plain(
                x, w.k), calls=5)
            bnd, by = bound_ms(m * k * 4 + m * w.k + m * 4, 4.0 * m * k,
                               "f32")
            b2.append(dict(shape=f"M={m} K={k} -> {w.k}", max_abs_err=0.0,
                           ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                           bound_by=by))
            print(f"B2 {b2[-1]}", flush=True)
        y = qm.q4_matmul_prefill_int8(xq, dx, w)
        y_ref = qm.q4_matmul_prefill_int8_plain(xq, dx, w)
        require(torch.equal(y, y_ref), f"B3 {name}: not bit-exact "
                f"(max err {(y - y_ref).abs().max().item()})")
        wbytes = w.qs.numel() + w.scales.numel() * 4
        ws = [w] + [rand_weight(torch, k, n, gen, dev)
                    for _ in range(copies_for(wbytes) - 1)]
        it = iter(range(10**9))
        ms = time_ms(torch, lambda: qm.q4_matmul_prefill_int8(
            xq, dx, ws[next(it) % len(ws)]), calls=2 * len(ws))
        plain_ms = time_ms(torch, lambda: qm.q4_matmul_prefill_int8_plain(
            xq, dx, w), calls=2)
        bnd, by = bound_ms(m * w.k + m * 4 + wbytes + m * n * 4,
                           2.0 * m * w.k * n, "int8")
        b3.append(dict(shape=f"{name} M={m} K={w.k} N={n}", max_abs_err=0.0,
                       ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by))
        print(f"B3 {b3[-1]}", flush=True)
        del ws, w
    results["B2"], results["B3"] = b2, b3

    b4 = []
    s_len, h, d = 512, 32, 128
    f = h * d
    n_caches = 16
    caches = [(torch.randn((1, s_len, f), generator=gen, device=dev)
               .to(torch.bfloat16),
               torch.randn((1, s_len, f), generator=gen, device=dev)
               .to(torch.bfloat16)) for _ in range(n_caches)]
    for n_past in (0, 1, 300, 511):
        qkv = torch.randn((1, 1, 3 * f), generator=gen, device=dev)
        npv = torch.tensor([n_past], dtype=torch.int32, device=dev)
        cos, sin = da.rope_lane_tables(npv, d, d)
        kc, vc = caches[0]
        kc2, vc2 = kc.clone(), vc.clone()
        ctx = da.decode_attention_fused(qkv, kc, vc, npv, cos, sin,
                                        head_dim=d, n_rot=d,
                                        scale=1 / math.sqrt(d))
        ctx_ref = da.decode_attention_fused_plain(qkv, kc2, vc2, npv, cos,
                                                  sin, head_dim=d, n_rot=d,
                                                  scale=1 / math.sqrt(d))
        err = (ctx - ctx_ref).abs().max().item()
        # bf16 tolerance: p is rounded to bf16 before the PV dot, and one
        # f32 ulp of exp can move that rounding by one bf16 ulp (2^-8)
        tol = 2 ** -7 * ctx_ref.abs().max().item() + 1e-6
        require(err <= tol, f"B4 n_past={n_past}: err {err} > {tol}")
        require(torch.equal(kc, kc2) and torch.equal(vc, vc2),
                f"B4 n_past={n_past}: caches differ")
        it = iter(range(10**9))

        def run():
            kk, vv = caches[next(it) % n_caches]
            da.decode_attention_fused(qkv, kk, vv, npv, cos, sin, head_dim=d,
                                      n_rot=d, scale=1 / math.sqrt(d))
        ms = time_ms(torch, run, calls=2 * n_caches)
        plain_ms = time_ms(torch, lambda: da.decode_attention_fused_plain(
            qkv, kc2, vc2, npv, cos, sin, head_dim=d, n_rot=d,
            scale=1 / math.sqrt(d)), calls=5)
        qr = torch.randn((1, h, 1, d), generator=gen, device=dev
                         ).to(torch.bfloat16)
        kv_n = max(n_past, 1)
        keys = kc[:, :kv_n].reshape(1, kv_n, h, d).transpose(1, 2)
        vals = vc[:, :kv_n].reshape(1, kv_n, h, d).transpose(1, 2)
        sdpa_ms = time_ms(torch, lambda: torch.nn.functional
                          .scaled_dot_product_attention(qr, keys, vals),
                          calls=20)
        bnd, by = bound_ms(3 * f * 4 + 2 * n_past * f * 2 + 2 * f * 2
                           + 2 * d * 4 + 4 + f * 4, 4.0 * n_past * f, "bf16")
        b4.append(dict(shape=f"B=1 S={s_len} H={h} d={d} n_past={n_past}",
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                       sdpa_attention_only_ms=sdpa_ms, bound_ms=bnd,
                       bound_by=by))
        print(f"B4 {b4[-1]}", flush=True)
    results["B4"] = b4

    # B10: attention alone over a written cache (rows s <= n_past). q, the
    # scores and p are f32 for both cache types, so the tolerance is f32
    # rounding: exp within a few ulp and the sum order, 5e-5 of the largest
    # output.
    b10 = []
    scale = 1 / math.sqrt(d)

    def b10_check(q, kc, vc, npv, label):
        ctx = da.decode_attention(q, kc, vc, npv, head_dim=d, scale=scale)
        ref = da.decode_attention_plain(q, kc, vc, npv, head_dim=d,
                                        scale=scale)
        err = (ctx - ref).abs().max().item()
        tol = 5e-5 * ref.abs().max().item() + 1e-6
        require(bool(torch.isfinite(ctx).all()), f"B10 {label}: not finite")
        require(err <= tol, f"B10 {label}: err {err} > {tol}")
        return err, tol

    for n_past in (0, 1, 300, 511):
        q = torch.randn((1, 1, f), generator=gen, device=dev)
        npv = torch.tensor([n_past], dtype=torch.int32, device=dev)
        kc, vc = caches[0]
        err, tol = b10_check(q, kc, vc, npv, f"n_past={n_past}")
        it = iter(range(10**9))

        def run10():
            kk, vv = caches[next(it) % n_caches]
            da.decode_attention(q, kk, vv, npv, head_dim=d, scale=scale)
        ms = time_ms(torch, run10, calls=2 * n_caches)
        plain_ms = time_ms(torch, lambda: da.decode_attention_plain(
            q, kc, vc, npv, head_dim=d, scale=scale), calls=5)
        rows = n_past + 1
        qh = q.reshape(1, h, 1, d).to(torch.bfloat16)
        keys = kc[:, :rows].reshape(1, rows, h, d).transpose(1, 2)
        vals = vc[:, :rows].reshape(1, rows, h, d).transpose(1, 2)
        sdpa_ms = time_ms(torch, lambda: torch.nn.functional
                          .scaled_dot_product_attention(qh, keys, vals),
                          calls=20)
        bnd, by = bound_ms(f * 4 + 2 * rows * f * 2 + 4 + f * 4,
                           4.0 * rows * f, "bf16")
        b10.append(dict(shape=f"B=1 S={s_len} H={h} d={d} n_past={n_past}",
                        max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                        library_ms=sdpa_ms, bound_ms=bnd, bound_by=by))
        print(f"B10 {b10[-1]}", flush=True)
    # f32 caches, and a slot with n_past >= S (attends all S rows, finite)
    q2 = torch.randn((2, 1, f), generator=gen, device=dev)
    np2 = torch.tensor([300, s_len + 88], dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        kc2 = torch.randn((2, s_len, f), generator=gen, device=dev).to(dt)
        vc2 = torch.randn((2, s_len, f), generator=gen, device=dev).to(dt)
        err, tol = b10_check(q2, kc2, vc2, np2, f"{dt} inactive slot")
        b10.append(dict(shape=f"B=2 S={s_len} n_past=[300, {s_len + 88}] "
                        f"{dt} caches", max_abs_err=err, tol=tol))
        print(f"B10 {b10[-1]}", flush=True)
    results["B10"] = b10
    del caches

    # B5: bf16 / f32 prefill matmul against dequant + torch.matmul (its
    # plain version and the path it replaces); tolerance as B1
    b5 = []
    for name, k, n in shapes[:4]:
        w = rand_weight(torch, k, n, gen, dev)
        wbytes = weight_bytes(w)
        ws = [w] + [rand_weight(torch, k, n, gen, dev)
                    for _ in range(copies_for(wbytes) - 1)]
        cases = [(512, torch.bfloat16)]
        if name == "qkv":
            cases += [(256, torch.bfloat16), (2048, torch.bfloat16),
                      (512, torch.float32)]
        for m, mode in cases:
            x = torch.randn((m, k), generator=gen, device=dev)
            y = qm.q4_matmul_prefill(x, w, mode)
            y_ref = qm.q4_matmul_dequant(x, w, mode)
            err = (y - y_ref).abs().max().item()
            tol = 1e-5 * absum_of(x, qm.dequant_matmul_weight(w, mode), n,
                                  mode)
            require(bool(torch.isfinite(y).all()), f"B5 {name} not finite")
            require(err <= tol, f"B5 {name} M={m} {mode}: err {err} > {tol}")
            it = iter(range(10**9))
            ms = time_ms(torch, lambda: qm.q4_matmul_prefill(
                x, ws[next(it) % len(ws)], mode), calls=len(ws))
            plain_ms = time_ms(torch, lambda: qm.q4_matmul_dequant(
                x, w, mode), calls=2)
            kind = "bf16" if mode == torch.bfloat16 else "f32"
            bnd, by = bound_ms(wbytes + x.numel() * 4 + m * n * 4,
                               2.0 * m * k * n, kind)
            b5.append(dict(shape=f"{name} M={m} K={k} N={n} {kind}",
                           max_abs_err=err, tol=tol, ms=ms,
                           plain_ms=plain_ms, bound_ms=bnd, bound_by=by))
            print(f"B5 {b5[-1]}", flush=True)
        del ws, w
    results["B5"] = b5

    # B9: decode-size affine matmul against its plain version (the kernel's
    # formula, not the dequant form); tolerance as B1, over both terms
    b9 = []
    for name, k, n in shapes:
        w = rand_weight(torch, k, n, gen, dev, affine=True)
        wbytes = weight_bytes(w)
        ws = [w] + [rand_weight(torch, k, n, gen, dev, affine=True)
                    for _ in range(copies_for(wbytes) - 1)]
        nb = w.k // 32
        for m in (1, 64):
            x = torch.randn((m, k), generator=gen, device=dev)
            for mode in ((torch.bfloat16, torch.float32) if m == 1
                         and name == "qkv" else (torch.bfloat16,)):
                y = qm.q41_matmul_decode(x, w, mode)
                y_ref = qm.q41_matmul_decode_plain(x, w, mode)
                qd = qm.dequant_matmul_weight(
                    type(w)(qs=w.qs, scales=w.scales,
                            mins=torch.zeros_like(w.mins)), mode)
                bsum = qm._pad_k(x, w.k).reshape(m, nb, 32).sum(-1).abs()
                absum = absum_of(x, qd, n, mode) + (
                    bsum @ w.mins.abs())[:, :n].max().item()
                err = (y - y_ref).abs().max().item()
                tol = 1e-5 * absum
                require(bool(torch.isfinite(y).all()), f"B9 {name} not finite")
                require(err <= tol, f"B9 {name} M={m} {mode}: err {err} > {tol}")
                it = iter(range(10**9))
                ms = time_ms(torch, lambda: qm.q41_matmul_decode(
                    x, ws[next(it) % len(ws)], mode), calls=4 * len(ws))
                plain_ms = time_ms(torch, lambda: qm.q41_matmul_decode_plain(
                    x, w, mode), calls=2)
                kind = "bf16" if mode == torch.bfloat16 else "f32"
                bnd, by = bound_ms(wbytes + x.numel() * 4 + m * n * 4,
                                   2.0 * m * k * n, kind)
                b9.append(dict(shape=f"{name} M={m} K={k} N={n} {kind}",
                               max_abs_err=err, tol=tol, ms=ms,
                               plain_ms=plain_ms, bound_ms=bnd, bound_by=by))
                print(f"B9 {b9[-1]}", flush=True)
        del ws, w
    results["B9"] = b9
    with open(os.path.join(out_dir, "kernel_checks.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    return results


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

def counted_kernels(qm, da):
    return {"B1": qm.q4_matmul_decode, "B2": qm.quant_rows_int8,
            "B3": qm.q4_matmul_prefill_int8, "B4": da.decode_attention_fused,
            "B5": qm.q4_matmul_prefill, "B9": qm.q41_matmul_decode,
            "B10": da.decode_attention}


def reset_counts(qm, da):
    for fn in counted_kernels(qm, da).values():
        fn.launches = 0


def read_counts(qm, da):
    return {k: fn.launches for k, fn in counted_kernels(qm, da).items()}


N_PROMPT, N_DECODE = 300, 64
# launches of one 300-token prefill window plus N_DECODE decode steps: four
# matmuls per layer and the head per step, the head once per window
DECODE_MATMULS = 129 * N_DECODE + 1
LAYER_CALLS = 32 * N_DECODE


def make_session(hp, params, dev, **rcfg_kw):
    from fastllama_tpu_torch.config import RuntimeConfig
    from fastllama_tpu_torch.engine.session import FastLlama
    from fastllama_tpu_torch.models.runtime import LlamaModel
    rcfg = RuntimeConfig(n_ctx=512, n_batch=512, kv_dtype="bfloat16",
                         weight_dtype="bfloat16", **rcfg_kw)
    model = LlamaModel(hp, params, synthetic_vocab(hp.n_vocab), rcfg,
                       device=dev)
    return model, FastLlama(model, n_keep=64, seed=0)


def timed_run(torch, sess, prompt):
    """Reset, ingest the prompt, sample the first token, decode N_DECODE
    more. Returns (ttft_ms, decode_s, last tokens, last logits)."""
    sess.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    require(sess.ingest(prompt), "ingest failed")
    n_prompt = len(sess._embd)
    require(sess.generate(lambda s: None, num_tokens=1, temp=0.0),
            "generate (first token) failed")
    ttft_ms = (time.perf_counter() - t0) * 1e3
    n0 = sess.n_past
    t1 = time.perf_counter()
    require(sess.generate(lambda s: None, num_tokens=N_DECODE, temp=0.0),
            "generate failed")
    decode_s = time.perf_counter() - t1
    require(n_prompt == N_PROMPT, f"prompt is {n_prompt} tokens")
    require(sess.n_past - n0 == N_DECODE,
            f"decoded {sess.n_past - n0} tokens, not {N_DECODE}")
    logits = sess.get_logits().copy()
    require(logits.ndim == 1 and np.isfinite(logits).all(),
            "session logits not finite / wrong shape")
    return ttft_ms, decode_s, list(sess._last_n), logits


def warm_up(sess, prompt):
    """First-use allocator and library setup, outside any counted run."""
    require(sess.ingest(prompt), "warm-up ingest failed")
    require(sess.generate(lambda s: None, num_tokens=2, temp=0.0), "warm-up")


def model_weight_bytes(params) -> int:
    return weight_bytes(params.output) + sum(
        weight_bytes(w) for layer in params.layers
        for w in (layer.wqkv, layer.wo, layer.w13, layer.w2))


def main_path(torch, dev, gen):
    from fastllama_tpu_torch.config import PRESETS
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import q4_matmul as qm

    hp = PRESETS["7B"]
    t0 = time.perf_counter()
    params = rand_params(torch, hp, gen, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model, sess = make_session(hp, params, dev)
    prompt = prompt_of(N_PROMPT - 2, seed=1)
    warm_up(sess, prompt)

    reset_counts(qm, da)
    first = timed_run(torch, sess, prompt)              # the counted run
    counts = read_counts(qm, da)
    require(first[3].shape == (hp.n_vocab,), "main-path logits: wrong shape")
    for k in ("B1", "B2", "B3", "B4"):
        require(counts[k] > 0, f"kernel {k} was not launched on the main path")
    for k in ("B5", "B9", "B10"):
        require(counts[k] == 0, f"kernel {k} launched on the q4_0 int8 path")
    # two more runs for the spread of the host-clock numbers
    runs = [first] + [timed_run(torch, sess, prompt) for _ in range(2)]
    require(runs[0][2] == runs[1][2] == runs[2][2],
            "greedy streams differ between identical runs")
    ttfts = [r[0] for r in runs]
    ms_tok = [r[1] / N_DECODE * 1e3 for r in runs]
    wbytes = model_weight_bytes(params)
    profile = profile_decode(torch, sess, n_steps=8)
    busy = profile.get("device_ms_per_token")
    med_ms = float(np.median(ms_tok))
    res = dict(n_layer=hp.n_layer, n_prompt=N_PROMPT,
               ttft_ms=float(np.median(ttfts)), ttft_ms_runs=ttfts,
               decode_tokens=N_DECODE, decode_tok_s=1e3 / med_ms,
               decode_ms_per_token=med_ms, decode_ms_per_token_runs=ms_tok,
               weight_bytes_per_token=wbytes,
               decode_bound_ms_per_token=wbytes / HBM_BYTES_PER_S * 1e3,
               weights_setup_s=setup_s, launches=counts,
               device_busy_ms_per_token=busy,
               device_idle_share=(None if busy is None else
                                  1.0 - busy / med_ms),
               decode_profile=profile,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"main path: {json.dumps(res)}", flush=True)
    del sess, model

    # the bf16-exact prefill: the same parameters with int8 prefill off
    model, sess = make_session(hp, params, dev, prefill_int8=False)
    warm_up(sess, prompt)
    reset_counts(qm, da)
    exact = timed_run(torch, sess, prompt)
    ecounts = read_counts(qm, da)
    require(ecounts["B5"] == 128, f"B5 launched {ecounts['B5']} times in one "
            "prefill window, not 128")
    require(ecounts["B2"] == 0 and ecounts["B3"] == 0,
            "int8 prefill kernels launched with prefill_int8=False")
    require(ecounts["B1"] == DECODE_MATMULS and ecounts["B4"] == LAYER_CALLS,
            f"bf16-exact run: unexpected decode launches {ecounts}")
    ettfts = [exact[0]] + [timed_run(torch, sess, prompt)[0]
                           for _ in range(2)]
    res["bf16_prefill"] = dict(
        ttft_ms=float(np.median(ettfts)), ttft_ms_runs=ettfts,
        int8_ttft_ms=res["ttft_ms"], launches=ecounts)
    print(f"bf16-exact prefill: {json.dumps(res['bf16_prefill'])}", flush=True)
    del sess, model, params
    torch.cuda.empty_cache()
    return res


def q41_lora_path(torch, dev, gen, tmp):
    """32 layers of 7B-width q4_1 weights with a rank-8 A/B adapter on wq and
    wv of every layer: detached, attached, detached again."""
    from fastllama_tpu_torch.config import PRESETS
    from fastllama_tpu_torch.io.ggml_writer import write_ggla
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import q4_matmul as qm

    hp = PRESETS["7B"]
    params = rand_params(torch, hp, gen, dev, affine=True)
    model, sess = make_session(hp, params, dev)
    prompt = prompt_of(N_PROMPT - 2, seed=1)
    rng = np.random.default_rng(5)
    rank = 8
    adapter = os.path.join(tmp, "adapter.bin")
    write_ggla(adapter, r=rank, alpha=16, use_cache=False, tensors={
        f"layers.{i}.attention.{w}.weight.lora{ab}":
            (rng.standard_normal((hp.n_embd, rank)) * 0.02).astype(np.float32)
        for i in range(hp.n_layer) for w in ("wq", "wv") for ab in "AB"})
    warm_up(sess, prompt)

    def state(label, attached):
        reset_counts(qm, da)
        first = timed_run(torch, sess, prompt)
        counts = read_counts(qm, da)
        want = {"B9": DECODE_MATMULS, "B1": 0, "B2": 0, "B3": 0, "B5": 0,
                "B4": 0 if attached else LAYER_CALLS,
                "B10": LAYER_CALLS if attached else 0}
        require(counts == want, f"q4_1 {label}: launches {counts}, "
                f"expected {want}")
        runs = [first] + [timed_run(torch, sess, prompt) for _ in range(2)]
        ms_tok = [r[1] / N_DECODE * 1e3 for r in runs]
        out = dict(ttft_ms=float(np.median([r[0] for r in runs])),
                   ttft_ms_runs=[r[0] for r in runs],
                   decode_ms_per_token=float(np.median(ms_tok)),
                   decode_ms_per_token_runs=ms_tok, launches=counts)
        print(f"q4_1 {label}: {json.dumps(out)}", flush=True)
        return first, out

    before, res_before = state("before attach", attached=False)
    require(model.attach_lora(adapter), "attach_lora failed")
    require(not model.attach_lora(adapter), "a second attach was accepted")
    with_lora, res_lora = state("LoRA attached", attached=True)
    require(not np.array_equal(with_lora[3], before[3]),
            "the adapter did not change the logits")
    profile = profile_decode(torch, sess, n_steps=8)
    busy = profile.get("device_ms_per_token")
    require(model.detach_lora(), "detach_lora failed")
    after, res_after = state("after detach", attached=False)
    require(np.array_equal(after[3], before[3]) and after[2] == before[2],
            "logits after detach_lora differ from those before attach_lora")
    wbytes = model_weight_bytes(params)
    res = dict(n_layer=hp.n_layer, lora_rank=rank, before_attach=res_before,
               attached=res_lora, after_detach=res_after,
               detach_bit_identical=True, weight_bytes_per_token=wbytes,
               decode_bound_ms_per_token=wbytes / HBM_BYTES_PER_S * 1e3,
               attached_device_busy_ms_per_token=busy,
               attached_device_idle_share=(
                   None if busy is None else
                   1.0 - busy / res_lora["decode_ms_per_token"]),
               attached_decode_profile=profile)
    print(f"q4_1 + LoRA path: {json.dumps(res)}", flush=True)
    del sess, model, params
    torch.cuda.empty_cache()
    return res


def profile_decode(torch, sess, n_steps: int) -> dict:
    """Device time per decode step by kernel (torch.profiler over n_steps
    more greedy steps, after the counted run). Empty if the profiler sees no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        require(sess.generate(lambda s: None, num_tokens=n_steps, temp=0.0),
                "profiled generate failed")
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        by_name[e.key] = (by_name.get(e.key, (0.0, 0))[0] + us,
                          by_name.get(e.key, (0.0, 0))[1] + e.count)
    total_us = sum(v[0] for v in by_name.values())
    if total_us <= 0:
        return {}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"device_ms_per_token": total_us / 1e3 / n_steps,
            "kernels": [{"name": k[:90], "ms_per_token": v[0] / 1e3 / n_steps,
                         "calls_per_token": v[1] / n_steps}
                        for k, v in top]}


def write_checkpoint(path, hp, seed):
    """A q4_0 fltpu checkpoint at full width, from numpy (random codes,
    scales in [1e-3, 0.02])."""
    from fastllama_tpu_torch.io.checkpoint import CheckpointWriter
    rng = np.random.default_rng(seed)

    def planes(k, n):
        return (rng.integers(0, 256, (k // 2, n), dtype=np.uint8),
                rng.uniform(1e-3, 0.02, (k // 32, n)).astype(np.float32))

    d, f = hp.n_embd, hp.n_ff
    w = CheckpointWriter(path, hp, synthetic_vocab(hp.n_vocab))
    w.add_q4_embedding_planes(
        "tok_embeddings.weight",
        rng.integers(0, 256, (hp.n_vocab, d // 2), dtype=np.uint8),
        rng.uniform(1e-3, 0.02, (hp.n_vocab, d // 32)).astype(np.float32))
    w.add_dense("norm.weight", np.ones(d, np.float32))
    qs, sc = planes(d, hp.n_vocab)
    sc[:, 2] = 0.0                 # EOS logit 0
    w.add_q4_planes("output.weight", qs, sc)
    for i in range(hp.n_layer):
        p = f"layers.{i}."
        w.add_dense(p + "attention_norm.weight", np.ones(d, np.float32))
        w.add_dense(p + "ffn_norm.weight", np.ones(d, np.float32))
        for nm in ("wq", "wk", "wv", "wo"):
            w.add_q4_planes(p + f"attention.{nm}.weight", *planes(d, d))
        w.add_q4_planes(p + "feed_forward.w1.weight", *planes(d, f))
        w.add_q4_planes(p + "feed_forward.w3.weight", *planes(d, f))
        w.add_q4_planes(p + "feed_forward.w2.weight", *planes(f, d))
    w.finish()


def write_ggjt_file(path, hp, seed, affine):
    """A GGJT file at full width from numpy: random codes, scales in
    [1e-3, 0.02] and, for q4_1, mins in about [-8 d, -7 d]."""
    from fastllama_tpu_torch.io.ggml_writer import write_ggjt
    rng = np.random.default_rng(seed)

    def q(n, k, eos_row=False):
        codes = rng.integers(0, 16, (n, k), dtype=np.uint8)
        sc = rng.uniform(1e-3, 0.02, (n, k // 32)).astype(np.float32)
        if eos_row:
            sc[2] = 0.0            # EOS logit 0
        if not affine:
            return ("q4_0", codes, sc)
        mins = sc * rng.uniform(-8.0, -7.0, sc.shape).astype(np.float32)
        return ("q4_1", codes, sc, mins)

    d, f = hp.n_embd, hp.n_ff
    ones = ("f32", np.ones(d, np.float32))
    tensors = {"tok_embeddings.weight": q(hp.n_vocab, d),
               "norm.weight": ones,
               "output.weight": q(hp.n_vocab, d, eos_row=True)}
    for i in range(hp.n_layer):
        p = f"layers.{i}."
        tensors[p + "attention_norm.weight"] = ones
        tensors[p + "ffn_norm.weight"] = ones
        for nm in ("wq", "wk", "wv", "wo"):
            tensors[p + f"attention.{nm}.weight"] = q(d, d)
        tensors[p + "feed_forward.w1.weight"] = q(f, d)
        tensors[p + "feed_forward.w3.weight"] = q(f, d)
        tensors[p + "feed_forward.w2.weight"] = q(d, f)
    write_ggjt(path, hp, synthetic_vocab(hp.n_vocab), tensors)


def card_vs_cpu(lm_gpu, lm_cpu):
    """Largest difference of the prefill and first decode logits of one
    model on the card and on the CPU (plain versions), over the largest
    logit."""
    toks = [1] + list(range(300, 320))
    errs = []
    for lm in (lm_gpu, lm_cpu):
        lm.reset()
    for n_past, window in ((0, toks), (len(toks), [toks[-1]])):
        a = lm_gpu.eval(n_past, window)
        b = lm_cpu.eval(n_past, window)
        errs.append(float(np.abs(a - b).max() / np.abs(b).max()))
    return errs


def file_entry_point(torch, tmp, label, n_layer, write, tol=1e-2,
                     f32_too=False):
    """write(path, hp) makes a model file of n_layer 7B-width layers; it is
    loaded through Model(path=...) on the card, driven, and its prefill and
    first decode logits are held against the same file on the CPU.

    tol is for bf16 weights and activations on both sides. q4_0 sums are
    nearly exact in f32 (products of two bf16 values), so only the odd
    re-rounding differs: 1e-2 is generous. The affine kernel's mins term
    has full f32 operands, so card and CPU differ in the last bit of every
    sum, and each bf16 rounding of an activation turns a difference d into
    about sqrt(d * 2^-8): after a few matmuls the difference sits at the
    bf16 step whatever its start (the same file on the CPU alone, f32
    against f64 accumulation, reads 1e-2). Such a file takes the bf16
    tolerance of the CPU tests, 3e-2, and f32_too adds the comparison in
    f32 mode, where nothing is rounded: 1e-4."""
    import dataclasses
    import fastllama_tpu_torch
    from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
    from fastllama_tpu_torch.models.loader import load_model

    hp = dataclasses.replace(PRESETS["7B"], n_layer=n_layer)
    path = os.path.join(tmp, label.replace(" ", "_"))
    t0 = time.perf_counter()
    write(path, hp)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = fastllama_tpu_torch.Model(path=path, n_ctx=512, n_batch=64,
                                      logger=fastllama_tpu_torch.Logger())
    load_s = time.perf_counter() - t0
    prompt = prompt_of(20, seed=4)
    require(model.ingest(prompt), f"{label}: Model.ingest failed")
    n_prompt = len(model.session._embd)
    out = []
    require(model.generate(num_tokens=8, temp=0.0, streaming_fn=out.append),
            f"{label}: Model.generate failed")
    require(model.session.n_past == n_prompt + 7,
            f"{label}: n_past {model.session.n_past} after {n_prompt} + 8")
    require(np.isfinite(model.get_logits()).all(), f"{label}: logits not finite")

    # reference: the same file on the CPU (plain versions)
    lm_gpu = model._model
    lm_cpu = load_model(path, lm_gpu.rcfg, device="cpu")
    errs = card_vs_cpu(lm_gpu, lm_cpu)
    require(max(errs) <= tol, f"{label}: card vs CPU logits rel err {errs}")
    res = dict(n_layer=n_layer, write_s=write_s, load_s=load_s,
               text_len=len("".join(out)),
               rel_err_prefill=errs[0], rel_err_decode=errs[1])
    del model, lm_gpu, lm_cpu
    if f32_too:
        rcfg = RuntimeConfig(n_ctx=512, n_batch=64, kv_dtype="float32",
                             weight_dtype="float32")
        errs = card_vs_cpu(load_model(path, rcfg),
                           load_model(path, rcfg, device="cpu"))
        require(max(errs) <= 1e-4,
                f"{label}: f32 mode, card vs CPU logits rel err {errs}")
        res.update(f32_rel_err_prefill=errs[0], f32_rel_err_decode=errs[1])
    print(f"file entry point, {label}: {json.dumps(res)}", flush=True)
    torch.cuda.empty_cache()
    return res


def file_entry_points(torch, tmp):
    return {
        "fltpu": file_entry_point(
            torch, tmp, "fltpu q4_0", 2,
            lambda path, hp: write_checkpoint(path, hp, seed=3)),
        "ggjt_q4_0": file_entry_point(
            torch, tmp, "GGJT q4_0", 8,
            lambda path, hp: write_ggjt_file(path, hp, 6, affine=False)),
        "ggjt_q4_1": file_entry_point(
            torch, tmp, "GGJT q4_1", 2,
            lambda path, hp: write_ggjt_file(path, hp, 7, affine=True),
            tol=3e-2, f32_too=True),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    try:
        import fastllama_tpu_torch  # noqa: F401
        from fastllama_tpu_torch.kernels import cuda_lib
        from fastllama_tpu_torch.kernels import decode_attention as da
        from fastllama_tpu_torch.kernels import q4_matmul as qm
    except ImportError as e:
        print(f"chip_smoke: fastllama_tpu_torch not importable: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    cuda_lib.build()
    print(f"kernels built in {cuda_lib.build_seconds:.1f} s", flush=True)
    with open(os.path.join(out_dir, "nvcc_log.txt"), "w") as fh:
        for name, log in cuda_lib.build_log.items():
            fh.write(f"== {name}.cu\n{log}\n")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = check_kernels(torch, dev, gen, out_dir)
    main_res = main_path(torch, dev, gen)
    tmp = tempfile.mkdtemp(prefix="fltorch_smoke_")
    try:
        q41_res = q41_lora_path(torch, dev, gen, tmp)
        file_res = file_entry_points(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def pick(rows, key):
        return next(r for r in rows if key in r["shape"])

    # each kernel's launches in the counted run of the path that drives it
    launches = dict(main_res["launches"],
                    B5=main_res["bf16_prefill"]["launches"]["B5"],
                    B9=q41_res["attached"]["launches"]["B9"],
                    B10=q41_res["attached"]["launches"]["B10"])
    main_rows = {"B1": pick(checks["B1"], "qkv M=1"),
                 "B2": pick(checks["B2"], "K=4096"),
                 "B3": pick(checks["B3"], "qkv"),
                 "B4": pick(checks["B4"], "n_past=300"),
                 "B5": pick(checks["B5"], "qkv M=512 K=4096 N=12288 bf16"),
                 "B9": pick(checks["B9"], "qkv M=1 K=4096 N=12288 bf16"),
                 "B10": pick(checks["B10"], "n_past=300")}
    meta = {
        "B1": ("q4_matmul_decode", "csrc/q4_decode.cu",
               "fastllama_tpu/kernels/q4_matmul.py:433"),
        "B2": ("quant_rows_int8", "csrc/quant_rows.cu",
               "fastllama_tpu/kernels/q4_matmul.py:786"),
        "B3": ("q4_matmul_prefill_int8", "csrc/q4_int8.cu",
               "fastllama_tpu/kernels/q4_matmul.py:904"),
        "B4": ("decode_attention_fused", "csrc/decode_attention.cu",
               "fastllama_tpu/kernels/decode_attention.py:258"),
        "B5": ("q4_matmul_prefill", "csrc/q4_prefill.cu",
               "fastllama_tpu/kernels/q4_matmul.py:578"),
        "B9": ("q41_matmul_decode", "csrc/q4_decode.cu",
               "fastllama_tpu/kernels/q4_matmul.py:395"),
        "B10": ("decode_attention", "csrc/decode_attention.cu",
                "fastllama_tpu/kernels/decode_attention.py:72"),
    }
    kernels = []
    for key, (name, src, replaces) in meta.items():
        row = main_rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fastllama_tpu_torch/kernels/" + src,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(r["max_abs_err"] for r in checks[key]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"), "shape": row["shape"]})
        require(launches[key] > 0, f"kernel {key} was launched on no path")
    summary = {"card": smi, "build_s": cuda_lib.build_seconds,
               "kernel_checks": checks, "main_path": main_res,
               "q41_lora_path": q41_res, "file_entry_points": file_res}
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
