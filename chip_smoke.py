#!/usr/bin/env python3
"""Drive fastllama_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits nonzero before the last line):
  1. print the card (nvidia-smi name, power limit) and build the CUDA
     kernels from kernels/csrc/ (one nvcc per source, in parallel);
  2. hold each kernel B1-B4 against its plain PyTorch version on the card at
     the 7B shapes of the main path, and time kernel, plain version and
     bound (the larger of bytes / 3.35 TB/s and operations / peak rate);
  3. the main path at full 7B width (32 layers, q4_0, bf16 weights and KV,
     n_ctx 512, seeded random weights made on the card): LlamaModel +
     FastLlama ingest a 300-token prompt with n_batch 512 and generate 64
     tokens greedily; prints TTFT, decode tok/s and each kernel's launches
     in this run (all four must be > 0);
  4. the file entry point: write a 2-layer checkpoint of the same widths
     with the port's CheckpointWriter, load it with Model(path=...), ingest
     and generate 8 tokens; its prefill and first decode logits are held
     against the same checkpoint loaded on the CPU (plain versions);
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

def rand_weight(torch, k, n, gen, dev):
    """A q4_0 matmul weight with the stored padding the loader applies:
    random codes and scales in [1e-3, 0.02] (as the JAX package's bench
    builds them), logical width n."""
    from fastllama_tpu_torch.quant.tensor import (
        QuantMatmulWeight, good_pad_k, good_pad_n)
    kp, np_ = good_pad_k(k), good_pad_n(n)
    qs = torch.randint(0, 256, (kp // 2, np_), generator=gen, device=dev,
                       dtype=torch.uint8)
    sc = torch.rand((kp // 32, np_), generator=gen, device=dev) * 0.019 + 1e-3
    return QuantMatmulWeight(qs=qs, scales=sc, n_logical=n)


def rand_params(torch, hp, gen, dev):
    from fastllama_tpu_torch.models.llama import LayerParams, LlamaParams
    from fastllama_tpu_torch.quant.tensor import QuantEmbedding
    d, f = hp.n_embd, hp.n_ff
    layers = [LayerParams(
        attention_norm=torch.ones(d, device=dev),
        wqkv=rand_weight(torch, d, 3 * d, gen, dev),
        wo=rand_weight(torch, d, d, gen, dev),
        ffn_norm=torch.ones(d, device=dev),
        w13=rand_weight(torch, d, 2 * f, gen, dev),
        w2=rand_weight(torch, f, d, gen, dev)) for _ in range(hp.n_layer)]
    emb = QuantEmbedding(
        qs=torch.randint(0, 256, (hp.n_vocab, d // 2), generator=gen,
                         device=dev, dtype=torch.uint8),
        scales=torch.rand((hp.n_vocab, d // 32), generator=gen, device=dev)
        * 0.019 + 1e-3)
    out = rand_weight(torch, d, hp.n_vocab, gen, dev)
    out.scales[:, 2] = 0.0        # EOS logit 0: greedy runs its full length
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

    results = {}
    # (name, K logical, N logical) of the main path's matmuls at 7B
    shapes = [("qkv", 4096, 12288), ("wo", 4096, 4096), ("w13", 4096, 22016),
              ("w2", 11008, 4096), ("head", 4096, 32000)]
    b1 = []
    for name, k, n in shapes:
        w = rand_weight(torch, k, n, gen, dev)
        wbytes = w.qs.numel() + w.scales.numel() * 4
        ws = [w] + [rand_weight(torch, k, n, gen, dev)
                    for _ in range(copies_for(wbytes) - 1)]
        for m in (1, 64):
            x = torch.randn((m, k), generator=gen, device=dev)
            for mode in ((torch.bfloat16, torch.float32) if m == 1
                         and name == "wo" else (torch.bfloat16,)):
                y = qm.q4_matmul_decode(x, w, mode)
                y_ref = qm.q4_matmul_dequant(x, w, mode)
                # reassociation tolerance: 1e-5 of the absolute-sum |x| @ |W|
                absum = (qm._pad_k(x.abs(), w.k).to(mode).float()
                         @ qm.dequant_matmul_weight(w, mode).float().abs()
                         )[:, :n].max().item()
                err = (y - y_ref).abs().max().item()
                tol = 1e-5 * absum
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
    del caches
    with open(os.path.join(out_dir, "kernel_checks.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    return results


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

def reset_counts(qm, da):
    for fn in (qm.q4_matmul_decode, qm.quant_rows_int8,
               qm.q4_matmul_prefill_int8, da.decode_attention_fused):
        fn.launches = 0


def read_counts(qm, da):
    return {"B1": qm.q4_matmul_decode.launches,
            "B2": qm.quant_rows_int8.launches,
            "B3": qm.q4_matmul_prefill_int8.launches,
            "B4": da.decode_attention_fused.launches}


def main_path(torch, dev, gen):
    from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
    from fastllama_tpu_torch.engine.session import FastLlama
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.models.runtime import LlamaModel

    hp = PRESETS["7B"]
    t0 = time.perf_counter()
    params = rand_params(torch, hp, gen, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rcfg = RuntimeConfig(n_ctx=512, n_batch=512, kv_dtype="bfloat16",
                         weight_dtype="bfloat16")
    model = LlamaModel(hp, params, synthetic_vocab(hp.n_vocab), rcfg,
                       device=dev)
    sess = FastLlama(model, n_keep=64, seed=0)
    prompt = prompt_of(298, seed=1)
    # warm-up outside the counted run (first-use allocator and library setup)
    require(sess.ingest(prompt), "warm-up ingest failed")
    require(sess.generate(lambda s: None, num_tokens=2, temp=0.0), "warm-up")

    def run():
        """ingest the prompt, sample the first token, decode 64 more;
        returns (ttft_ms, decode_s, prompt tokens, tokens decoded)."""
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
        require(sess.generate(lambda s: None, num_tokens=64, temp=0.0),
                "generate failed")
        decode_s = time.perf_counter() - t1
        tokens.append(list(sess._last_n))
        return ttft_ms, decode_s, n_prompt, sess.n_past - n0

    tokens = []

    reset_counts(qm, da)
    ttft_ms, decode_s, n_prompt, n_decoded = run()     # the counted run
    counts = read_counts(qm, da)
    logits = sess.get_logits()
    require(n_prompt == 300, f"prompt is {n_prompt} tokens, not 300")
    require(n_decoded == 64, f"decoded {n_decoded} tokens, not 64")
    require(logits.shape == (hp.n_vocab,) and np.isfinite(logits).all(),
            "main-path logits not finite / wrong shape")
    for k, v in counts.items():
        require(v > 0, f"kernel {k} was not launched on the main path")
    # two more runs for the spread of the host-clock numbers
    runs = [(ttft_ms, decode_s)] + [run()[:2] for _ in range(2)]
    require(tokens[0] == tokens[1] == tokens[2],
            "greedy streams differ between identical runs")
    ttfts = [r[0] for r in runs]
    ms_tok = [r[1] / n_decoded * 1e3 for r in runs]
    wbytes = sum(w.qs.numel() + w.scales.numel() * 4
                 for layer in params.layers
                 for w in (layer.wqkv, layer.wo, layer.w13, layer.w2))
    wbytes += params.output.qs.numel() + params.output.scales.numel() * 4
    profile = profile_decode(torch, sess, n_steps=8)
    busy = profile.get("device_ms_per_token")
    med_ms = float(np.median(ms_tok))
    res = dict(n_layer=hp.n_layer, n_prompt=n_prompt,
               ttft_ms=float(np.median(ttfts)), ttft_ms_runs=ttfts,
               decode_tokens=n_decoded, decode_tok_s=1e3 / med_ms,
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
    """A 2-layer q4_0 fltpu checkpoint at full width, from numpy (random
    codes, scales in [1e-3, 0.02])."""
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


def file_entry_point(torch, dev):
    import dataclasses
    import fastllama_tpu_torch
    from fastllama_tpu_torch.config import PRESETS

    hp = dataclasses.replace(PRESETS["7B"], n_layer=2)
    tmp = tempfile.mkdtemp(prefix="fltorch_smoke_")
    try:
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        write_checkpoint(ckpt, hp, seed=3)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = fastllama_tpu_torch.Model(path=ckpt, n_ctx=512, n_batch=64,
                                          logger=fastllama_tpu_torch.Logger())
        load_s = time.perf_counter() - t0
        prompt = prompt_of(20, seed=4)
        require(model.ingest(prompt), "Model.ingest failed")
        n_prompt = len(model.session._embd)
        out = []
        require(model.generate(num_tokens=8, temp=0.0,
                               streaming_fn=out.append), "Model.generate failed")
        sess = model.session
        require(sess.n_past == n_prompt + 7,
                f"n_past {sess.n_past} after {n_prompt} + 8 tokens")
        require(np.isfinite(model.get_logits()).all(), "logits not finite")

        # reference: the same checkpoint on the CPU (plain versions)
        lm_gpu = model._model
        from fastllama_tpu_torch.models.loader import load_model
        lm_cpu = load_model(ckpt, lm_gpu.rcfg, device="cpu")
        toks = [1] + list(range(300, 320))
        errs = []
        for lm in (lm_gpu, lm_cpu):
            lm.reset()
        for n_past, window in ((0, toks), (len(toks), [toks[-1]])):
            a = lm_gpu.eval(n_past, window)
            b = lm_cpu.eval(n_past, window)
            errs.append(float(np.abs(a - b).max() / np.abs(b).max()))
        # bf16 weights and activations on both sides; only f32 summation
        # order differs (and bf16 re-rounding of values that differ by it)
        require(max(errs) <= 1e-2, f"card vs CPU logits rel err {errs}")
        res = dict(checkpoint_write_s=write_s, load_s=load_s,
                   text_len=len("".join(out)),
                   rel_err_prefill=errs[0], rel_err_decode=errs[1])
        print(f"file entry point: {json.dumps(res)}", flush=True)
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    file_res = file_entry_point(torch, dev)

    def pick(rows, key):
        return next(r for r in rows if key in r["shape"])

    launches = main_res["launches"]
    main_rows = {"B1": pick(checks["B1"], "qkv M=1"),
                 "B2": pick(checks["B2"], "K=4096"),
                 "B3": pick(checks["B3"], "qkv"),
                 "B4": pick(checks["B4"], "n_past=300")}
    meta = {
        "B1": ("q4_matmul_decode", "csrc/q4_decode.cu",
               "fastllama_tpu/kernels/q4_matmul.py:433"),
        "B2": ("quant_rows_int8", "csrc/quant_rows.cu",
               "fastllama_tpu/kernels/q4_matmul.py:786"),
        "B3": ("q4_matmul_prefill_int8", "csrc/q4_int8.cu",
               "fastllama_tpu/kernels/q4_matmul.py:904"),
        "B4": ("decode_attention_fused", "csrc/decode_attention.cu",
               "fastllama_tpu/kernels/decode_attention.py:258"),
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
            "library_ms": None, "shape": row["shape"]})
    summary = {"card": smi, "build_s": cuda_lib.build_seconds,
               "kernel_checks": checks, "main_path": main_res,
               "file_entry_point": file_res}
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
