#!/usr/bin/env python3
"""Drive fastllama_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits nonzero before the last line):
  1. print the card (nvidia-smi name, power limit) and build the CUDA
     kernels from kernels/csrc/ (one nvcc per source, in parallel);
  2. hold each kernel (B1-B12) against its plain PyTorch version on the
     card at the 7B shapes of the paths below, and time kernel, plain
     version and bound (the larger of bytes / 3.35 TB/s and operations /
     peak rate); for B4, B10 and B11 also one scaled_dot_product_attention
     call, for B1 and B9 one torch.ops.aten._weight_int4pack_mm call on the
     same codes, for B3 one torch._int_mm call (the int8 product alone),
     for B5 one torch.mm of the rounded x by the dequantized weight
     (yardsticks; the port calls none of them). B1 at M = 1, 2, 4, 8,
     16 and 64 and B9 also at 9, 17 and 40, on every plane in bf16 (tensor
     cores; the FFMA design timed beside them in the same call), f32 mode
     at M = 1 and 8 on wo (B1) and qkv (B9), B9 also on planes padded to
     256 columns, B1 also on the 13B planes; B3 bit for bit on the 7B and
     13B planes at M = 512 and 256, its requantization and product timed
     apart from a torch.profiler trace; B5 (q4_0 and q4_1, bf16 and f32
     mode) on the 7B and 13B planes at M = 65, 128, 192, 255, 256, 512
     and 513, timed beside the dequant path it replaces at 64 < M < 256
     and for q4_1 (q4_matmul_dequant); B4 (bf16 and f32 caches, caches bit
     for bit) and B10 at
     n_past 0, 1, 63, 64, (65,) 300, 511 and past S; B1, B4, B9 and B10 run
     twice and must agree bit for bit. The engine's kernels: B6, B7, B8 and
     B11 (flat-lane pools, bit for bit against B6 on the same pools; no path
     of the JAX package reaches it, so its launches are this phase's) on
     bf16 and f32 pools (8 sequences of ragged lengths over a shuffled page
     table, sentinel and out-of-pool page ids, NaN in every page no sequence
     reaches; B6 also at B = 1, at the steady window's depths, at 40
     heads and with q a strided view), B4 and B10 at B = 8 with per-slot
     depths, one slot inactive; the fused paged step (RoPE, B7's write and
     B6's attention in one kernel) at lengths 0, 1, ps - 1, ps, ps + 1,
     300 and pp * ps - 1 with an inactive sentinel slot, bf16 and f32
     pools, 32 and 40 heads: its written rows bit for bit against its plain
     version and the standalone B7, ctx within B6's tolerance, timed beside
     the unfused step (the forward's glue, B7 and B6). The 7B planes a rank
     holds under tensor parallelism (cut by parallel/sharding.shard_params
     at tp = 2 and 4): B1 at M = 1 and 8, B2 + B3 bit for bit at M = 512
     and 256, B5 at M = 128 and 512, each timed. B12 (the fresh-prompt
     flash prefill attention) on the forward's operands (bf16 q, K and V
     rows of bf16 slab caches) at 32 heads and T = 128, 512, 1024, 2048,
     at 40 heads (13B), 16 and 8 heads (a rank at tp 2 and 4) and Dh 256
     (16 heads) at T = 512, timed beside its plain version, the masked
     f32 softmax over an n_ctx-row cache it replaced and
     scaled_dot_product_attention (is_causal, bf16; the yardstick), with
     its bound for bf16 and for f32 operands. Afterwards no phase
     may call the dequant path on the card (q4_matmul_dequant.cuda_calls
     must read 0 after phase 10);
  3. the q4_0 session at full 7B width (32 layers, bf16 weights and KV,
     n_ctx 512, seeded random weights made on the card): LlamaModel +
     FastLlama ingest a 300-token prompt with n_batch 512 and generate 64
     tokens greedily; prints TTFT (and the device time of its window by
     kernel, from a torch.profiler trace), decode tok/s and each kernel's
     launches in this run (B1-B4 must be > 0, B12 32: once a layer in
     the fresh 512-row window); the window's device time is profiled on
     B12 and, in the same call, on the masked route it replaced; then the
     same parameters under RuntimeConfig(prefill_int8=False), the
     bf16-exact prefill: B5 must launch 128 times per window, B12 32 and
     B2/B3 not at all;
  4. the q4_1 + LoRA session at the same width and depth (affine weights
     made on the card): a ggla adapter (A/B form, rank 8, wq and wv of
     every layer) written by the port's write_ggla is attached through
     attach_lora; its 512-row prefill window runs B5 (affine) 128 times
     and B12 32 times (attached or not: the gate ignores LoRA);
     while attached a decode step must launch B9 129 times, B10 32 times
     and B4 never; after detach_lora the same prompt's logits
     must equal those taken before the attach bit for bit, on B4 again;
  5. the file entry points: a 2-layer fltpu checkpoint, an 8-layer q4_0
     GGJT file and a 2-layer q4_1 GGJT file at 7B widths, each loaded with
     Model(path=...), ingested and decoded; prefill and first decode logits
     are held against the same file loaded on the CPU (plain versions);
  6. the continuous-batching engine at full 7B width (32 layers, q4_0, bf16,
     8 slots, n_ctx 512, pages of 64 rows): twelve requests of mixed prompt
     length, 48 tokens each, through BatchEngine with kv_mode "paged",
     "paged" with chunked admission, and "slab"; sampled twice with one
     seed (equal streams), then greedy. Every request must finish, every
     page must be free again, the fused paged step must launch once per
     layer and decode step (B6 and B7 never), B8 once per layer and
     chunked admission, B4 in the slab run only, B12 once per layer and
     monolithic admission whose prompt bucket passes its gate (seven of
     the twelve; never in chunked admission or f32 mode). Prints tok/s,
     ms per
     engine step, the device time and launches per step from a
     torch.profiler trace, the time to the first streamed token of a
     300-token request in an idle engine, drain depth 0 against 2; holds a
     two-layer f32 engine's three modes to equal greedy streams; and runs
     a two-layer paged engine whose layers carry q/k/v LoRA terms, whose
     steps take RoPE, B7 and B6 apart (the standalone kernels' caller);
  7. the converters and the native repack: native/fastllama_native.cpp
     built with g++ (seconds printed) and its quantizer held bit for bit
     against numpy's on a w13-sized tensor; a 2-layer f16 GGJT file at 7B
     widths quantized by the port's quantize (an fltpu directory) and
     export_ggjt (a q4_0 GGJT), phase 5's fltpu directory exported to GGJT;
     each GGJT loaded with Model(path=...) on the card by the native "q4p"
     route (the log must say so) and by the numpy route: planes byte-equal,
     prefill and first decode logits bit-equal (and equal to the quantized
     fltpu directory's); load seconds of both routes and the quantize and
     export seconds printed;
  8. the C ABI: libfastllama_c.so built from native/c_api.cpp,
     examples/c/main.c and perplexity.c compiled unchanged against the
     port's header and library; main.c runs on phase 5's 8-layer q4_0 GGJT
     with a 300-token prompt and 64 greedy tokens (n_ctx 512, n_batch 64)
     and must stream the text fastllama_tpu_torch.Model streams here with
     the same arguments; code run by FASTLLAMA_C_INIT in the C program's
     interpreter reports the card and B1's and B4's launches (> 0);
     perplexity.c over the prompt must be within 1e-3 relative of
     Model.perplexity; the C program's and the Python API's host seconds
     and tokens per second are printed side by side;
  9. traces (inside phases 3 and 6): phase 3's session with profile_dir
     set for 8 greedy tokens, whose device_op_breakdown must name B1's and
     B4's kernels with a device total within 10% of the script's own
     profile of 8 steps; phase 6's paged engine, one run() of 2 requests x
     8 tokens with profile_dir, whose breakdown must name the fused paged
     step's kernel; both top-10 lists printed;
 10. multi-GPU serving (parallel/) in worlds of ranks spawned with
     torch.multiprocessing, gloo, every rank on cuda:0 (time-slicing the
     card: their ms per token are printed as such, not as a TP speed), on
     phase 5's 8-layer q4_0 and 2-layer q4_1 GGJT files, each held against
     the one-card run of the same file: world (1, 2) the TP session
     (300-token prompt, int8 then bf16-exact prefill, 64 greedy tokens;
     first-token logits within phase 5's 1e-2; saved, then loaded into a
     one-card Model: its next logits within 1e-2 of the world's), TP + LoRA
     on the q4_1 file (detach bit for bit on every rank), the engine paged
     and slab; world (2, 1) the SP session (seq_parallel, n_ctx 2048, a
     1024-token prompt in n_batch 512 chunks, 32 greedy tokens) and the
     engine with dp 2; world (2, 2) the engine on the q4_1 file in f32,
     whose greedy streams must equal one card's. Every rank's launches are
     read (B1-B4 > 0 in the TP session, the fused paged step > 0, the
     dequant path 0; B12 once a layer in each TP window and TP or dp
     admission past its gate, never in the SP session or f32), and the
     bytes gloo's CUDA all-gathers and ring sends
     copied through the host are printed;
  then the whole script's seconds, one line {"kernels": [...]}, the
  nvidia-smi line, and last {"ok": true, "device": {...}}.
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

def rand_weight(torch, k, n, gen, dev, affine=False, pad_n=None):
    """A q4_0 matmul weight with the stored padding the loader applies:
    random codes and scales in [1e-3, 0.02] (as the JAX package's bench
    builds them), logical width n. affine: a q4_1 weight, with mins in
    about [-8 d, -7 d] so that q * d + m is centred like (q - 8) * d.
    pad_n: N padded to a multiple of it instead of good_pad_n's rule."""
    from fastllama_tpu_torch.quant.tensor import (
        QuantMatmulWeight, good_pad_k, good_pad_n)
    kp = good_pad_k(k)
    np_ = good_pad_n(n) if pad_n is None else -(-n // pad_n) * pad_n
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


# B1's row counts: the single stream (1), the engine (8) and the tiles' edges;
# B9 adds the rows just past an n-tile (9, 17) and a partial 32-row tile (40)
B1_ROWS = (1, 2, 4, 8, 16, 64)
B9_ROWS = (1, 2, 4, 8, 9, 16, 17, 40, 64)


def ffma_gemv(torch, qm, x, w):
    """One launch of the FFMA kernel in bf16 mode (q4_gemv for a q4_0
    weight, q41_gemv for an affine one), the design that B1's and B9's bf16
    mode had before the tensor-core kernel (f32 mode's kernel still): a
    yardstick timed beside them, not counted as a launch of either."""
    from fastllama_tpu_torch.kernels import cuda_lib
    m, kx = x.shape
    kh, n = w.qs.shape
    splits, per = qm._splitk(m, n, kh // 16)
    rows, cols = qm._b1_tile(m)
    partial = cuda_lib.scratch(x.device, "q4_gemv.partial", splits * m * n,
                               torch.float32)
    counters = cuda_lib.tile_counters(x.device, -(-n // cols) * -(-m // rows))
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=x.device)
    planes = (w.qs, w.scales) if w.mins is None else (w.qs, w.scales, w.mins)
    name = "q4_gemv" if w.mins is None else "q41_gemv"
    cuda_lib.check(cuda_lib.fn(name)(
        x.data_ptr(), m, kx, *(p.data_ptr() for p in planes), n, kh // 16,
        splits, per, partial.data_ptr(), counters.data_ptr(), y.data_ptr(),
        w.n_logical, 1, cuda_lib.stream_handle(x.device)), name)
    return y


def int4pack_planes(torch, w):
    """w's codes, scales and offsets in the form that
    torch.ops.aten._weight_int4pack_mm takes: groups of 32 along K, each
    weight (q - 8) * scale + zero with a bf16 scale and zero per group; zero
    is 0 for q4_0 and m + 8 d for q4_1 (q * d + m). Returns (packed weight,
    scales-and-zeros [K/32, N, 2])."""
    from fastllama_tpu_torch.quant.tensor import unpack_codes
    kh, n = w.qs.shape
    nb = kh // 16
    codes = (unpack_codes(w.qs.reshape(nb, 16, n), 1).reshape(nb * 32, n)
             .t().contiguous())                         # int32 [N, K]
    try:      # [N, K / 2] uint8, the even k in the high nibble
        packed = torch.ops.aten._convert_weight_to_int4pack(
            (codes[:, ::2] << 4 | codes[:, 1::2]).to(torch.uint8), 8)
    except RuntimeError:              # PyTorch before 2.5: int32 [N, K]
        packed = torch.ops.aten._convert_weight_to_int4pack(codes, 8)
    zero = (torch.zeros_like(w.scales) if w.mins is None
            else w.mins + 8.0 * w.scales)
    return packed, torch.stack([w.scales, zero], -1).to(torch.bfloat16)


def int4pack_packs(torch, ws):
    """int4pack_planes of every weight copy, or the error that the card's
    PyTorch gave (the yardstick is then "none")."""
    try:
        return [int4pack_planes(torch, w) for w in ws]
    except (RuntimeError, AttributeError, TypeError) as e:
        return f"{type(e).__name__}: {e}"[:300]


def int4pack_row(torch, packs, x, y_ref, n):
    """library_ms of one torch.ops.aten._weight_int4pack_mm call on the same
    codes (bf16 x, scales and zeros, bf16 result; weights cycled as the
    kernels' are) and its error against the kernel's plain version. Its
    tolerance is bf16's, 2^-7 of the largest output, since its scales, zeros
    and output are bf16. Beside the kernel only: the port never calls it."""
    if isinstance(packs, str):
        return dict(library_ms=None, library_error=packs)
    mm = torch.ops.aten._weight_int4pack_mm
    xb = x.to(torch.bfloat16)
    k_stored = packs[0][1].shape[0] * 32
    if xb.shape[1] < k_stored:
        xb = torch.nn.functional.pad(xb, (0, k_stored - xb.shape[1]))
    try:
        y = mm(xb, packs[0][0], 32, packs[0][1])
    except RuntimeError as e:
        return dict(library_ms=None,
                    library_error=f"RuntimeError: {e}"[:300])
    err = (y.float()[:, :n] - y_ref).abs().max().item()
    tol = 2 ** -7 * y_ref.abs().max().item()
    it = iter(range(10**9))

    def run():
        pw, sz = packs[next(it) % len(packs)]
        mm(xb, pw, 32, sz)
    ms = time_ms(torch, run, calls=4 * len(packs))
    if err > tol:
        return dict(library_ms=None, library_error=(
            f"differs from the plain version by {err} > {tol}"),
            library_unchecked_ms=ms)
    return dict(library_ms=ms, library_max_abs_err=err, library_tol=tol)


def sdpa_over(torch, q, kvs):
    """Device ms of one scaled_dot_product_attention call, cycling through
    the (keys, values) pairs kvs as the kernels cycle their caches, so that
    the yardstick too reads device memory rather than the L2."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    it = iter(range(10**9))
    return time_ms(torch, lambda: sdpa(q, *kvs[next(it) % len(kvs)]),
                   calls=4 * len(kvs))


def sdpa_cycled(torch, q, caches, rows, h, d):
    """sdpa_over the first `rows` rows of each slab cache pair [B, S, h*d],
    viewed as [B, h, rows, d]."""
    b = caches[0][0].shape[0]
    return sdpa_over(torch, q, [tuple(
        x[:, :rows].reshape(b, rows, h, d).transpose(1, 2) for x in kv)
        for kv in caches])


def check_kernels(torch, dev, gen, out_dir):
    """Phase 2: every kernel against its plain version on the card, timed."""
    results = {}
    check_decode_matmuls(torch, dev, gen, results)
    check_prefill_matmuls(torch, dev, gen, results)
    check_shard_planes(torch, dev, gen, results)
    check_decode_attention(torch, dev, gen, results)
    check_flash_prefill(torch, dev, gen, results)
    check_engine_kernels(torch, dev, gen, results)
    check_fused_paged_step(torch, dev, gen, results)
    check_shard_attention(torch, dev, gen, results)
    check_fused_paged_step(torch, dev, gen, results, heads=SHARD_HEADS)
    with open(os.path.join(out_dir, "kernel_checks.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    return results


def absum_of(torch, qm, x, wd, n, mode):
    """The largest sum |x| @ |W| of the rounded operands: the scale of the
    f32 reassociation tolerance."""
    return (qm._pad_k(x.abs(), wd.shape[0]).to(mode).float()
            @ wd.float().abs())[:, :n].max().item()


def b9_tol(torch, qm, x, w, mode):
    """B9's tolerance: 1e-5 of sum |x| |R(q d)| + sum |bsum| |m|, both
    terms' scale."""
    qd = qm.dequant_matmul_weight(type(w)(
        qs=w.qs, scales=w.scales, mins=torch.zeros_like(w.mins)), mode)
    nb = w.k // 32
    bsum = qm._pad_k(x, w.k).reshape(x.shape[0], nb, 32).sum(-1).abs()
    return 1e-5 * (absum_of(torch, qm, x, qd, w.n_logical, mode) + (
        bsum @ w.mins.abs())[:, :w.n_logical].max().item())


# (name, K logical, N logical) of the main path's matmuls at 7B and 13B
PLANES_7B = [("qkv", 4096, 12288), ("wo", 4096, 4096), ("w13", 4096, 22016),
             ("w2", 11008, 4096), ("head", 4096, 32000)]
PLANES_13B = [("qkv13", 5120, 15360), ("wo13", 5120, 5120),
              ("w13_13", 5120, 27648), ("w2_13", 13824, 5120)]


def check_decode_matmuls(torch, dev, gen, results):
    """B1 and B9 on every 7B plane: bf16 mode (tensor cores) at B1_ROWS /
    B9_ROWS, with the FFMA design and one _weight_int4pack_mm call timed
    beside them; f32 mode (FFMA) at M = 1 and 8 on wo (B1) and qkv (B9);
    B9 also on the planes padded to 256 columns as make_matmul_weight_q41
    pads them."""
    from fastllama_tpu_torch.kernels import q4_matmul as qm

    def b1_case(x, w, mode):
        y = qm.q4_matmul_decode(x, w, mode)
        y_ref = qm.q4_matmul_dequant(x, w, mode)
        tol = 1e-5 * absum_of(torch, qm, x, qm.dequant_matmul_weight(w, mode),
                              w.n_logical, mode)
        return y, y_ref, tol

    def b9_case(x, w, mode):
        y = qm.q41_matmul_decode(x, w, mode)
        y_ref = qm.q41_matmul_decode_plain(x, w, mode)
        return y, y_ref, b9_tol(torch, qm, x, w, mode)

    for key, affine, fn, case, rows_of, f32_plane in (
            ("B1", False, qm.q4_matmul_decode, b1_case, B1_ROWS, "wo"),
            ("B9", True, qm.q41_matmul_decode, b9_case, B9_ROWS, "qkv")):
        out = []
        for name, k, n in PLANES_7B:
            w = rand_weight(torch, k, n, gen, dev, affine)
            wbytes = weight_bytes(w)
            ws = [w] + [rand_weight(torch, k, n, gen, dev, affine)
                        for _ in range(copies_for(wbytes) - 1)]
            packs = int4pack_packs(torch, ws)
            for m in rows_of:
                x = torch.randn((m, k), generator=gen, device=dev)
                modes = ((torch.bfloat16, torch.float32)
                         if m in (1, 8) and name == f32_plane
                         else (torch.bfloat16,))
                for mode in modes:
                    y, y_ref, tol = case(x, w, mode)
                    err = (y - y_ref).abs().max().item()
                    require(bool(torch.isfinite(y).all()),
                            f"{key} {name} not finite")
                    require(err <= tol, f"{key} {name} M={m} {mode}: err "
                            f"{err} > {tol}")
                    require(torch.equal(y, fn(x, w, mode)),
                            f"{key} {name} M={m} {mode}: not deterministic")
                    it = iter(range(10**9))
                    ms = time_ms(torch, lambda: fn(
                        x, ws[next(it) % len(ws)], mode), calls=4 * len(ws))
                    plain = qm.q41_matmul_decode_plain if affine else \
                        qm.q4_matmul_dequant
                    plain_ms = time_ms(torch, lambda: plain(x, w, mode),
                                       calls=2)
                    kind = "bf16" if mode == torch.bfloat16 else "f32"
                    bnd, by = bound_ms(wbytes + x.numel() * 4 + m * n * 4,
                                       2.0 * m * k * n, kind)
                    row = dict(shape=f"{name} M={m} K={k} N={n} {kind}",
                               max_abs_err=err, tol=tol, ms=ms,
                               plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                               bound_share=bnd / ms)
                    if kind == "bf16":
                        # the FFMA design (f32 mode's kernel) in this call,
                        # and the library's W4A16 matmul on the same codes
                        it = iter(range(10**9))
                        row["ffma_design_ms"] = time_ms(
                            torch, lambda: ffma_gemv(
                                torch, qm, x, ws[next(it) % len(ws)]),
                            calls=4 * len(ws))
                        if m in B1_ROWS:
                            row.update(int4pack_row(torch, packs, x, y_ref,
                                                    n))
                    out.append(row)
                    print(f"{key} {row}", flush=True)
            del ws, w, packs
        results[key] = out

    # B9 on planes padded to 256 columns (make_matmul_weight_q41's rule):
    # 22016 and 32000 columns take other block layouts than 22528 and 32768
    from fastllama_tpu_torch.quant.tensor import good_pad_k
    for name, k, n in (("w13", 4096, 22016), ("head", 4096, 32000)):
        w = rand_weight(torch, k, n, gen, dev, True, pad_n=256)
        require(w.qs.shape == (good_pad_k(k) // 2, n), "B9 256-padded plane")
        for m in (1, 8, 17, 64):
            x = torch.randn((m, k), generator=gen, device=dev)
            y, y_ref, tol = b9_case(x, w, torch.bfloat16)
            err = (y - y_ref).abs().max().item()
            require(bool(torch.isfinite(y).all()) and err <= tol,
                    f"B9 {name} N={n} (padded to 256) M={m}: err {err} > "
                    f"{tol}")
            results["B9"].append(dict(
                shape=f"{name} M={m} K={k} N={n} padded to 256 bf16",
                max_abs_err=err, tol=tol))
        del w

    # B1 (tensor cores, b1_mma_plan's layouts) on the 13B planes, once
    for name, k, n in PLANES_13B:
        w = rand_weight(torch, k, n, gen, dev)
        for m in B1_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev)
            y, y_ref, tol = b1_case(x, w, torch.bfloat16)
            err = (y - y_ref).abs().max().item()
            require(bool(torch.isfinite(y).all()) and err <= tol,
                    f"B1 13B {name} M={m}: err {err} > {tol}")
            results["B1"].append(dict(shape=f"{name} M={m} K={k} N={n} bf16",
                                      max_abs_err=err, tol=tol))
        del w


def check_prefill_matmuls(torch, dev, gen, results):
    """B2 and B3 (bit for bit) and B5 against their plain versions; B3 on
    the 7B and 13B planes at M = 512 and 256, its two launches timed apart
    and torch._int_mm (the int8 product alone) beside it."""
    from fastllama_tpu_torch.kernels import cuda_lib
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    shapes = PLANES_7B
    b2, b3 = [], []
    for name, k, n in shapes[:4] + PLANES_13B:
        w = rand_weight(torch, k, n, gen, dev)
        wbytes = w.qs.numel() + w.scales.numel() * 4
        ws = [w] + [rand_weight(torch, k, n, gen, dev)
                    for _ in range(copies_for(wbytes) - 1)]
        w8, _ = qm.requant_weight_int8(w)
        w8_cm = w8.t().contiguous().t()           # [K, N], column-major
        # M = 512: the single stream's bucket and a monolithic admission;
        # M = 256: the chunked admission's chunks
        for m in (512, 256):
            x = torch.randn((m, k), generator=gen, device=dev) * 3.0
            xq, dx = qm.quant_rows_int8(x, w.k)
            xq_ref, dx_ref = qm.quant_rows_int8_plain(x, w.k)
            require(torch.equal(xq, xq_ref) and torch.equal(dx, dx_ref),
                    f"B2 {name} M={m}: not bit-exact")
            if m == 512 and name in ("qkv", "w2"):   # the main path's K's
                ms = time_ms(torch, lambda: qm.quant_rows_int8(x, w.k),
                             calls=20)
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
            require(torch.equal(y, y_ref), f"B3 {name} M={m}: not bit-exact "
                    f"(max err {(y - y_ref).abs().max().item()})")
            require(torch.equal(y, qm.q4_matmul_prefill_int8(xq, dx, w)),
                    f"B3 {name} M={m}: not deterministic")
            # the library's int8 product (cuBLASLt through torch._int_mm):
            # the exact int32 accumulators alone, no requantization or scales
            acc = torch._int_mm(xq, w8_cm)
            require(torch.equal(acc.double(), qm.int8_accumulators(xq, w8)),
                    f"B3 {name} M={m}: _int_mm is not the exact product")
            tile = qm.B3_TILES[qm.b3_plan(m, w.qs.shape[1],
                                          cuda_lib.sm_count(dev))]
            it = iter(range(10**9))

            def cycled():
                return qm.q4_matmul_prefill_int8(xq, dx,
                                                 ws[next(it) % len(ws)])
            ms = time_ms(torch, cycled, calls=2 * len(ws))
            # its two launches apart, by kernel name in a profiler trace
            split = device_ms_by_name(torch, cycled, 2 * len(ws),
                                      ("requant_kernel", "int8_wgmma_kernel"))
            plain_ms = (time_ms(torch, lambda: qm.q4_matmul_prefill_int8_plain(
                xq, dx, w), calls=2)
                if m == 512 and name in {p[0] for p in shapes} else None)
            # the function's operations: the logical K and N, not the
            # stored padding
            ops = 2.0 * m * k * n
            bnd, by = bound_ms(m * w.k + m * 4 + wbytes + m * n * 4, ops,
                               "int8")
            gemm_ms = split["int8_wgmma_kernel"]
            row = dict(shape=f"{name} M={m} K={k} N={n}", max_abs_err=0.0,
                       ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                       library_ms=time_ms(torch, lambda: torch._int_mm(
                           xq, w8_cm), calls=10),
                       requant_ms=split["requant_kernel"], gemm_ms=gemm_ms,
                       tile_n=tile,
                       gemm_int8_peak_share=ops / PEAK_OPS["int8"] * 1e3
                       / gemm_ms)
            b3.append(row)
            print(f"B3 {row}", flush=True)
        del ws, w, w8, w8_cm
    results["B2"], results["B3"] = b2, b3

    check_b5(torch, dev, gen, results)


# B5's rows: the engine's 128 bucket and its edges (65-255: q4_0 without
# int8 and every q4_1 prefill), the chunked admission (256) and the 512
# bucket, and a row past a tile
B5_ROWS = (65, 128, 192, 255, 256, 512, 513)


def check_b5(torch, dev, gen, results):
    """B5 on the 7B and 13B planes at B5_ROWS, q4_0 and q4_1, bf16 and f32
    mode: held against its plain version (q4_matmul_dequant, which is also
    the path it replaces at 64 < M < 256 and for q4_1) within f32
    reassociation (1e-5 of the largest |x| @ |W|); timed beside that path
    and beside the product alone as one library call (torch.mm of the
    rounded x by the already dequantized weight, f32 output); the cast and
    the product timed apart from a profiler trace at M = 128 and 512 on
    qkv."""
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    b5 = []
    for name, k, n in PLANES_7B[:4] + PLANES_13B:
        for affine in (False, True):
            w = rand_weight(torch, k, n, gen, dev, affine)
            wbytes = weight_bytes(w)
            ws = [w] + [rand_weight(torch, k, n, gen, dev, affine)
                        for _ in range(copies_for(wbytes) - 1)]
            quant = "q4_1" if affine else "q4_0"
            for mode in (torch.bfloat16, torch.float32):
                kind = "bf16" if mode == torch.bfloat16 else "f32"
                wd = qm.dequant_matmul_weight(w, mode)
                for m in B5_ROWS:
                    x = torch.randn((m, k), generator=gen, device=dev)
                    y = qm.q4_matmul_prefill(x, w, mode)
                    y_ref = qm.q4_matmul_dequant(x, w, mode)
                    err = (y - y_ref).abs().max().item()
                    tol = 1e-5 * absum_of(torch, qm, x, wd, n, mode)
                    label = f"B5 {name} M={m} {kind} {quant}"
                    require(bool(torch.isfinite(y).all()),
                            f"{label}: not finite")
                    require(err <= tol, f"{label}: err {err} > {tol}")
                    it = iter(range(10**9))
                    ms = time_ms(torch, lambda: qm.q4_matmul_prefill(
                        x, ws[next(it) % len(ws)], mode), calls=len(ws))
                    dequant_ms = time_ms(torch, lambda: qm.q4_matmul_dequant(
                        x, w, mode), calls=2)
                    xr = qm._pad_k(x, w.k).to(mode)
                    kw = {"out_dtype": torch.float32} if kind == "bf16" else {}
                    library_ms = time_ms(torch, lambda: torch.mm(xr, wd, **kw),
                                         calls=4)
                    bnd, by = bound_ms(wbytes + x.numel() * 4 + m * n * 4,
                                       2.0 * m * k * n, kind)
                    row = dict(shape=f"{name} M={m} K={k} N={n} {kind} "
                               f"{quant}", max_abs_err=err, tol=tol, ms=ms,
                               plain_ms=dequant_ms, dequant_path_ms=dequant_ms,
                               bound_ms=bnd, bound_by=by,
                               library_ms=library_ms)
                    if name == "qkv" and not affine and kind == "bf16" \
                            and m in (128, 512):
                        row.update(device_ms_by_name(
                            torch, lambda: qm.q4_matmul_prefill(
                                x, ws[next(it) % len(ws)], mode),
                            2 * len(ws), ("cast_kernel", "bf16_wgmma_kernel")))
                    b5.append(row)
                    print(f"B5 {row}", flush=True)
                del wd
            del ws, w
    results["B5"] = b5


def check_decode_attention(torch, dev, gen, results):
    """B4 and B10 at B = 1 over 16 cycled 7B-width caches (bf16), and B4 on
    f32 caches; engine batch shapes in check_engine_kernels."""
    from fastllama_tpu_torch.kernels import decode_attention as da
    b4 = []
    s_len, h, d = 512, 32, 128
    f = h * d
    scale = 1 / math.sqrt(d)
    kw4 = dict(head_dim=d, n_rot=d, scale=scale)
    n_caches = 16
    caches = [(torch.randn((1, s_len, f), generator=gen, device=dev)
               .to(torch.bfloat16),
               torch.randn((1, s_len, f), generator=gen, device=dev)
               .to(torch.bfloat16)) for _ in range(n_caches)]
    f32_caches = tuple(torch.randn((1, s_len, f), generator=gen, device=dev)
                       for _ in range(2))

    def b4_check(qkv, kc, vc, npv, cos, sin, label):
        """B4 on clones of the caches against its plain version: output
        within tolerance, caches bit for bit after the call, and the same
        output and caches from a second run."""
        runs = []
        for _ in range(2):
            k1, v1 = kc.clone(), vc.clone()
            runs.append((da.decode_attention_fused(qkv, k1, v1, npv, cos, sin,
                                                   **kw4), k1, v1))
        k2, v2 = kc.clone(), vc.clone()
        ref = da.decode_attention_fused_plain(qkv, k2, v2, npv, cos, sin,
                                              **kw4)
        ctx, k1, v1 = runs[0]
        err = (ctx - ref).abs().max().item()
        # bf16: each chunk rounds its p = exp(score - chunk max) to bf16
        # before the PV dot where the plain version rounds exp(score - max),
        # and one f32 ulp of exp can move a rounding by one bf16 ulp (2^-8);
        # f32: exp within a few ulp and the sum order, as for B10
        rel = 2 ** -7 if kc.dtype == torch.bfloat16 else 5e-5
        tol = rel * ref.abs().max().item() + 1e-6
        require(bool(torch.isfinite(ctx).all()), f"B4 {label}: not finite")
        require(err <= tol, f"B4 {label}: err {err} > {tol}")
        require(torch.equal(k1, k2) and torch.equal(v1, v2),
                f"B4 {label}: caches differ")
        require(all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])),
                f"B4 {label}: not deterministic")
        return err, tol

    # the depths where the 64-row chunks begin and end, the last row, and
    # one past S (an inactive slot: all S rows attended, row S - 1 written)
    for n_past in (0, 1, 63, 64, 65, 300, 511, s_len + 88):
        qkv = torch.randn((1, 1, 3 * f), generator=gen, device=dev)
        npv = torch.tensor([n_past], dtype=torch.int32, device=dev)
        cos, sin = da.rope_lane_tables(npv, d, d)
        kc, vc = caches[0]
        err, tol = b4_check(qkv, kc, vc, npv, cos, sin, f"n_past={n_past}")
        ferr, ftol = b4_check(qkv, *f32_caches, npv, cos, sin,
                              f"n_past={n_past} f32 caches")
        it = iter(range(10**9))

        def run():
            kk, vv = caches[next(it) % n_caches]
            da.decode_attention_fused(qkv, kk, vv, npv, cos, sin, **kw4)
        ms = time_ms(torch, run, calls=2 * n_caches)
        plain_ms = time_ms(torch, lambda: da.decode_attention_fused_plain(
            qkv, kc.clone(), vc.clone(), npv, cos, sin, **kw4), calls=5)
        rows = min(n_past, s_len)
        qr = torch.randn((1, h, 1, d), generator=gen, device=dev
                         ).to(torch.bfloat16)
        sdpa_ms = sdpa_cycled(torch, qr, caches, max(rows, 1), h, d)
        bnd, by = bound_ms(3 * f * 4 + 2 * rows * f * 2 + 2 * f * 2
                           + 2 * d * 4 + 4 + f * 4, 4.0 * rows * f, "bf16")
        b4.append(dict(shape=f"B=1 S={s_len} H={h} d={d} n_past={n_past}",
                       max_abs_err=err, tol=tol, f32_max_abs_err=ferr,
                       f32_tol=ftol, ms=ms, plain_ms=plain_ms,
                       sdpa_attention_only_ms=sdpa_ms, bound_ms=bnd,
                       bound_by=by))
        print(f"B4 {b4[-1]}", flush=True)
    results["B4"] = b4
    del f32_caches

    # B10: attention alone over a written cache (rows s <= n_past). q, the
    # scores and p are f32 for both cache types, so the tolerance is f32
    # rounding: exp within a few ulp and the sum order, 5e-5 of the largest
    # output.
    b10 = []

    def b10_check(q, kc, vc, npv, label):
        ctx = da.decode_attention(q, kc, vc, npv, head_dim=d, scale=scale)
        ref = da.decode_attention_plain(q, kc, vc, npv, head_dim=d,
                                        scale=scale)
        err = (ctx - ref).abs().max().item()
        tol = 5e-5 * ref.abs().max().item() + 1e-6
        require(bool(torch.isfinite(ctx).all()), f"B10 {label}: not finite")
        require(err <= tol, f"B10 {label}: err {err} > {tol}")
        require(torch.equal(ctx, da.decode_attention(
            q, kc, vc, npv, head_dim=d, scale=scale)),
            f"B10 {label}: not deterministic")
        return err, tol

    # the depths where B10's 64-row chunks begin, end and go neutral, and
    # one past S (an inactive slot: all S rows, finite)
    for n_past in (0, 1, 63, 64, 300, 511, s_len + 88):
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
        rows = min(n_past + 1, s_len)
        qh = q.reshape(1, h, 1, d).to(torch.bfloat16)
        sdpa_ms = sdpa_cycled(torch, qh, caches, rows, h, d)
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


# B12's shapes: (label, heads, T, Dh) at 7B (32 heads: the TTFT window's
# 512 bucket, the 128 bucket, and longer windows), 13B (40 heads), the heads
# a rank holds at tp = 2 and 4 (16 and 8), and a head width of 256 (which
# the gate admits: Dh % 128 == 0)
B12_SHAPES = [("7B", 32, 128, 128), ("7B", 32, 512, 128),
              ("7B", 32, 1024, 128), ("7B", 32, 2048, 128),
              ("13B", 40, 512, 128), ("tp=2", 16, 512, 128),
              ("tp=4", 8, 512, 128), ("Dh256", 16, 512, 256)]


def check_flash_prefill(torch, dev, gen, results):
    """B12 against its plain version at the shapes of B12_SHAPES (B = 1), on
    the operands the forward passes: q the bf16 half of a roped
    [1, T, 2H, Dh] tensor, K and V rows 0..T-1 of bf16 slab caches
    [1, S, H Dh] (S = max(T, 512)). Within 2^-7 of the largest output (one
    bf16 ulp of the output, 2^-8 relative, from a tie or the f32 sum
    order), bf16-valued, the same result twice. Timed over input sets
    cycled past the L2, beside its plain version, the masked f32 softmax
    over the cache that the forward took before B12, and
    scaled_dot_product_attention(is_causal=True) on bf16 [1, H, T, Dh] (the
    yardstick; the port never calls it). The bound counts bf16 q, k, v and
    the f32 output; bound_f32_ms the f32 operands B12 read before."""
    from fastllama_tpu_torch.kernels import cuda_lib
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import flash_prefill as fp
    rows = []
    for label, h, t, d in B12_SHAPES:
        f = h * d
        s_len = max(t, ENG_CTX)
        nread = 3 * t * f * 2
        sets = []
        for _ in range(copies_for(nread)):
            qk = torch.randn((1, t, 2 * h, d), generator=gen,
                             device=dev).to(torch.bfloat16)
            kc, vc = (torch.randn((1, s_len, f), generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
            sets.append((qk[:, :, :h], kc[:, :t].view(1, t, h, d),
                         vc[:, :t].view(1, t, h, d)))
        q, k, v = sets[0]
        shape = f"{label} H={h} d={d} T={t}"
        out = fp.flash_prefill(q, k, v)
        again = fp.flash_prefill(q, k, v)
        ref = fp.flash_prefill_plain(q, k, v)
        err = (out - ref).abs().max().item()
        tol = 2 ** -7 * ref.abs().max().item()
        require(bool(torch.isfinite(out).all()), f"B12 {shape}: not finite")
        require(err <= tol, f"B12 {shape}: err {err} > {tol}")
        require(torch.equal(out, out.to(torch.bfloat16).float()),
                f"B12 {shape}: output not bf16-valued")
        require(torch.equal(out, again), f"B12 {shape}: not deterministic")
        it = iter(range(10**9))

        def run():
            fp.flash_prefill(*sets[next(it) % len(sets)])
        ms = time_ms(torch, run, calls=4 * len(sets))
        plain_ms = time_ms(torch, lambda: fp.flash_prefill_plain(q, k, v),
                           calls=3)
        kc, vc = (torch.randn((1, s_len, f), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        pos = torch.arange(t, device=dev)[None, :]
        qf = q.float()
        masked_ms = time_ms(torch, lambda: da.masked_attention(
            qf, kc, vc, pos, h, 1 / math.sqrt(d)), calls=3)
        del kc, vc, qf
        sd = [tuple(x.transpose(1, 2).contiguous() for x in st)
              for st in sets]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa_ms = time_ms(torch, lambda: sdpa(*sd[next(it) % len(sd)],
                                              is_causal=True),
                          calls=4 * len(sd))
        del sd, sets
        ops = 4.0 * h * d * t * (t + 1) / 2
        bnd, by = bound_ms(nread + t * f * 4, ops, "bf16")
        bnd_f32, by_f32 = bound_ms(2 * nread + t * f * 4, ops, "bf16")
        plan = fp.b12_plan(1, h, t, d, cuda_lib.sm_count(dev))
        rows.append(dict(shape=shape + " bf16", max_abs_err=err, tol=tol,
                         ms=ms, plain_ms=plain_ms, plan=list(plan),
                         replaced_masked_ms=masked_ms,
                         replaced_masked_rows=s_len, library_ms=sdpa_ms,
                         bound_ms=bnd, bound_by=by, bound_f32_ms=bnd_f32,
                         bound_f32_by=by_f32))
        print(f"B12 {rows[-1]}", flush=True)
    results["B12"] = rows


# engine shapes at 7B: 8 slots, n_ctx 512, pages of 64 rows
ENG_SLOTS, ENG_CTX, ENG_PS = 8, 512, 64


def check_engine_kernels(torch, dev, gen, results):
    """Phase 2, the engine's kernels at 7B shapes: B6, B7, B8 and B11 (the
    flat-lane pools) against their plain versions (bf16 and f32 pools), and
    B4 and B10 at B = 8 with per-slot depths, one of them n_ctx + 1 (an
    inactive slot)."""
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import kv_write as kw
    from fastllama_tpu_torch.kernels import paged_attention as pa
    h, d, ps, b = 32, 128, ENG_PS, ENG_SLOTS
    pp = ENG_CTX // ps
    n_pages = b * pp                      # + the trash page
    f = h * d

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    def pool(dt):
        return torch.randn((h, n_pages + 1, ps, d), generator=gen,
                           device=dev).to(dt)

    b6, b7, b8, b11 = [], [], [], []
    b11_launches = 0
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    tables = perm.reshape(b, pp).to(torch.int32).contiguous()
    ragged = [0, 1, ps - 1, ps, 300, pp * ps, 200, 37]
    steady = [100, 107, 114, 121, 128, 135, 142, 150]
    for dt in (torch.bfloat16, torch.float32):
        isz = dt.itemsize
        name = "bf16" if dt == torch.bfloat16 else "f32"
        pools = [(pool(dt), pool(dt)) for _ in range(3 if isz == 2 else 2)]
        q = torch.randn((b, h, d), generator=gen, device=dev)
        for label, lens in (("ragged " + str(ragged), ragged),
                            ("8x300", [300] * b),
                            ("steady " + str(steady), steady)):
            lengths = i32(lens)
            kp, vp = pools[0]
            # pages no sequence reaches (and the trash page) hold NaN: no
            # stale value may reach the output
            kq, vq = kp.clone(), vp.clone()
            used = torch.zeros(n_pages + 1, dtype=torch.bool, device=dev)
            for row, n in zip(tables.tolist(), lens):
                if n:
                    used[row[:-(-n // ps)]] = True
            kq[:, ~used] = float("nan")
            vq[:, ~used] = float("nan")
            ctx = pa.paged_decode_attention(q, kq, vq, lengths, tables)
            ref = pa.paged_decode_attention_plain(q, kp, vp, lengths, tables)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(ctx).all()),
                    f"B6 {name} {label}: not finite")
            err = (ctx - ref).abs().max().item()
            # bf16 pools: p is rounded to bf16 before the PV dot and one f32
            # ulp of exp can move that rounding by one bf16 ulp (2^-8), as
            # for B4; f32 pools: exp within a few ulp and the sum order
            tol = ((2 ** -7 if isz == 2 else 5e-5) * ref.abs().max().item()
                   + 1e-6)
            require(err <= tol, f"B6 {name} {label}: err {err} > {tol}")
            for i, n in enumerate(lens):
                if n == 0:
                    require(bool((ctx[i] == 0).all()),
                            f"B6 {name}: a sequence of length 0 is not zeros")
            it = iter(range(10**9))

            def run6():
                kk, vv = pools[next(it) % len(pools)]
                pa.paged_decode_attention(q, kk, vv, lengths, tables)
            ms = time_ms(torch, run6, calls=8 * len(pools))
            plain_ms = time_ms(torch, lambda: pa.paged_decode_attention_plain(
                q, kp, vp, lengths, tables), calls=2)
            rows = sum(lens)
            bnd, by = bound_ms(2 * b * f * 4 + 2 * rows * f * isz + b * 4
                               + b * pp * 4, 4.0 * rows * f,
                               "bf16" if isz == 2 else "f32")
            row = dict(shape=f"B={b} H={h} d={d} ps={ps} pp={pp} {name} "
                       f"lengths={label}", max_abs_err=err, tol=tol, ms=ms,
                       plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                       library_ms=None)
            if label == "8x300":
                # beside it, not the same function: one SDPA call over keys
                # already gathered from the pages into [B, H, 300, d]
                idx = tables.long()
                gathered = [tuple(x[:, idx].permute(1, 0, 2, 3, 4).reshape(
                    b, h, pp * ps, d)[:, :, :300].to(torch.bfloat16)
                    .contiguous() for x in kv) for kv in pools]
                qh = q.reshape(b, h, 1, d).to(torch.bfloat16)
                row["sdpa_over_gathered_keys_ms"] = sdpa_over(
                    torch, qh, gathered)
                del gathered
            b6.append(row)
            print(f"B6 {row}", flush=True)
        # q as the forward passes it: a view of a wider tensor (batch and
        # head strides), bit for bit against the same values made contiguous
        q_wide = torch.randn((b, 2 * h, d), generator=gen, device=dev)
        lengths = i32(ragged)
        require(torch.equal(
            pa.paged_decode_attention(q_wide[:, h:], *pools[0], lengths,
                                      tables),
            pa.paged_decode_attention(q_wide[:, h:].contiguous(), *pools[0],
                                      lengths, tables)),
            f"B6 {name}: a strided q gives another result")

        # B11: the same pools in the flat-lane layout [P, ps, H*D]; a read
        # table entry holds the sentinel (the trash page) and another an id
        # past the pool (clipped into it); NaN in every page no sequence
        # reaches. Held against its plain version and, bit for bit, against
        # B6 on the head-major pools it was made from.
        flats = [tuple(x.permute(1, 2, 0, 3).reshape(n_pages + 1, ps, f)
                       .contiguous() for x in kv) for kv in pools]
        t11 = tables.clone()
        t11[1, 0] = n_pages
        t11[4, 0] = n_pages + 3
        for label, lens in (("ragged " + str(ragged), ragged),
                            ("8x300", [300] * b)):
            lengths = i32(lens)
            kf, vf = flats[0]
            kq, vq = kf.clone(), vf.clone()
            used = torch.zeros(n_pages + 1, dtype=torch.bool, device=dev)
            for row, n in zip(t11.clamp(0, n_pages).tolist(), lens):
                if n:
                    used[row[:-(-n // ps)]] = True
            kq[~used] = float("nan")
            vq[~used] = float("nan")
            pa.paged_decode_attention_flat.launches = 0
            ctx = pa.paged_decode_attention_flat(q, kq, vq, lengths, t11)
            ref = pa.paged_decode_attention_flat_plain(q, kf, vf, lengths,
                                                       t11)
            b6_ctx = pa.paged_decode_attention(q, *pools[0], lengths, t11)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(ctx).all()),
                    f"B11 {name} {label}: not finite")
            err = (ctx - ref).abs().max().item()
            tol = ((2 ** -7 if isz == 2 else 5e-5) * ref.abs().max().item()
                   + 1e-6)
            require(err <= tol, f"B11 {name} {label}: err {err} > {tol}")
            require(torch.equal(ctx, b6_ctx),
                    f"B11 {name} {label}: differs from B6 on the same pools")
            for i, n in enumerate(lens):
                if n == 0:
                    require(bool((ctx[i] == 0).all()),
                            f"B11 {name}: length 0 does not give zeros")
            it = iter(range(10**9))

            def run11():
                kk, vv = flats[next(it) % len(flats)]
                pa.paged_decode_attention_flat(q, kk, vv, lengths, t11)
            ms = time_ms(torch, run11, calls=8 * len(flats))
            plain_ms = time_ms(torch, lambda: pa
                               .paged_decode_attention_flat_plain(
                                   q, kf, vf, lengths, t11), calls=2)
            rows = sum(lens)
            bnd, by = bound_ms(2 * b * f * 4 + 2 * rows * f * isz + b * 4
                               + b * pp * 4, 4.0 * rows * f,
                               "bf16" if isz == 2 else "f32")
            row = dict(shape=f"B={b} H={h} d={d} ps={ps} pp={pp} {name} "
                       f"flat pools lengths={label}", max_abs_err=err,
                       tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                       bound_by=by, library_ms=None, equals_b6=True)
            if label == "8x300":
                # one SDPA call over the keys already gathered from the pages
                idx = t11.long().clamp(0, n_pages)
                gathered = [tuple(x[idx].reshape(b, pp * ps, h, d)[:, :300]
                                  .transpose(1, 2).to(torch.bfloat16)
                                  .contiguous() for x in kv) for kv in flats]
                qh = q.reshape(b, h, 1, d).to(torch.bfloat16)
                row["library_ms"] = sdpa_over(torch, qh, gathered)
                del gathered
            b11_launches += pa.paged_decode_attention_flat.launches
            b11.append(row)
            print(f"B11 {row}", flush=True)
        del flats

        # B7: one row per sequence; sentinel ids hit the trash page, an id
        # past the pool writes nothing; every other page bit for bit
        k_new = torch.randn((b, h, d), generator=gen, device=dev)
        v_new = torch.randn((b, h, d), generator=gen, device=dev)
        pids = i32([5, n_pages, 17, 0, n_pages, n_pages + 3, 63, 31])
        offs = i32([0, 0, ps - 1, 9, 3, 1, 40, 63])
        (k1, v1), (k2, v2) = ((x.clone(), y.clone()) for x, y in pools[:2])
        k2.copy_(k1)
        v2.copy_(v1)
        before = k1[:, :n_pages].clone()
        kw.paged_kv_write(k1, v1, k_new, v_new, pids, offs)
        kw.paged_kv_write_plain(k2, v2, k_new, v_new, pids, offs)
        torch.cuda.synchronize()
        require(torch.equal(k1[:, :n_pages], k2[:, :n_pages])
                and torch.equal(v1[:, :n_pages], v2[:, :n_pages]),
                f"B7 {name}: pages differ from the plain version's")
        require(torch.equal(k1[:, 5, 0], k_new[0].to(dt))
                and int((k1[:, :n_pages] != before).any(-1).sum()) <= 5 * h,
                f"B7 {name}: wrote other rows than the five addressed")
        ms = time_ms(torch, lambda: kw.paged_kv_write(
            k1, v1, k_new, v_new, pids, offs), calls=32)
        plain_ms = time_ms(torch, lambda: kw.paged_kv_write_plain(
            k2, v2, k_new, v_new, pids, offs), calls=4)
        # the library's indexed write of the same rows: index_put_ into
        # each pool's [P ps, H, D] view, a sentinel id onto the trash page
        # and an id past the pool clamped onto it too
        flat = (pids.long() * ps + offs.long()).clamp_max(n_pages * ps)
        kt, vt = (x.to(dt) for x in (k_new, v_new))

        def index_put():
            k2.view(h, -1, d).transpose(0, 1).index_put_((flat,), kt)
            v2.view(h, -1, d).transpose(0, 1).index_put_((flat,), vt)
        bnd, by = bound_ms(2 * b * f * (4 + isz) + 2 * b * 4, 0.0, "f32")
        b7.append(dict(shape=f"B={b} H={h} d={d} ps={ps} {name}",
                       max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       bound_ms=bnd, bound_by=by,
                       library_ms=time_ms(torch, index_put, calls=16),
                       library_call="index_put_, one call a pool"))
        print(f"B7 {b7[-1]}", flush=True)

        # B8: a 512-row prompt into 8 shuffled pages, one block to the trash
        # page and one past the pool
        t = ENG_CTX
        k_rows = torch.randn((t, f), generator=gen, device=dev).to(dt)
        v_rows = torch.randn((t, f), generator=gen, device=dev).to(dt)
        blocks = i32([9, 2, n_pages, 40, 41, n_pages + 1, 7, 22])
        k2.copy_(k1)
        v2.copy_(v1)
        kw.paged_kv_write_rows(k1, v1, k_rows, v_rows, blocks)
        kw.paged_kv_write_rows_plain(k2, v2, k_rows, v_rows, blocks)
        torch.cuda.synchronize()
        require(torch.equal(k1[:, :n_pages], k2[:, :n_pages])
                and torch.equal(v1[:, :n_pages], v2[:, :n_pages]),
                f"B8 {name}: pages differ from the plain version's")
        require(torch.equal(k1[3, 40, 5], k_rows[3 * ps + 5, 3 * d:4 * d]),
                f"B8 {name}: row 5 of block 3 is not in page 40")
        ms = time_ms(torch, lambda: kw.paged_kv_write_rows(
            k1, v1, k_rows, v_rows, blocks), calls=16)
        plain_ms = time_ms(torch, lambda: kw.paged_kv_write_rows_plain(
            k2, v2, k_rows, v_rows, blocks), calls=4)
        bsel = blocks.long().clamp_max(n_pages)
        kb, vb = (x.reshape(pp, ps, h, d).permute(2, 0, 1, 3).contiguous()
                  for x in (k_rows, v_rows))

        def index_copy_pages():
            k2.index_copy_(1, bsel, kb)
            v2.index_copy_(1, bsel, vb)
        real = 6 * ps                     # rows of the six blocks written
        bnd, by = bound_ms(2 * 2 * real * f * isz + pp * 4, 0.0, "f32")
        b8.append(dict(shape=f"T={t} H={h} d={d} ps={ps} {name}",
                       max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       bound_ms=bnd, bound_by=by,
                       library_ms=time_ms(torch, index_copy_pages,
                                          calls=16),
                       library_call="index_copy_ of whole pages, one call "
                                    "a pool"))
        print(f"B8 {b8[-1]}", flush=True)
        del pools, k1, v1, k2, v2
    # B6 at B = 1 (300 keys; small pools, cycled through more than the
    # L2) with SDPA over the gathered keys beside it, and at 13B's 40 heads
    pools1 = [tuple(torch.randn((h, pp + 1, ps, d), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2)) for _ in range(16)]
    q1 = torch.randn((1, h, d), generator=gen, device=dev)
    t1 = torch.arange(pp, dtype=torch.int32, device=dev)[None]
    n1 = i32([300])
    ctx = pa.paged_decode_attention(q1, *pools1[0], n1, t1)
    ref = pa.paged_decode_attention_plain(q1, *pools1[0], n1, t1)
    err = (ctx - ref).abs().max().item()
    tol = 2 ** -7 * ref.abs().max().item() + 1e-6
    require(err <= tol, f"B6 B=1 x 300: err {err} > {tol}")
    it = iter(range(10**9))
    ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q1, *pools1[next(it) % len(pools1)], n1, t1), calls=4 * len(pools1))
    plain_ms = time_ms(torch, lambda: pa.paged_decode_attention_plain(
        q1, *pools1[0], n1, t1), calls=2)
    bnd, by = bound_ms(2 * f * 4 + 2 * 300 * f * 2 + 4 + pp * 4,
                       4.0 * 300 * f, "bf16")
    gathered = [tuple(x[:, :pp].reshape(1, h, pp * ps, d)[:, :, :300]
                      .contiguous() for x in kv) for kv in pools1]
    b6.append(dict(shape=f"B=1 H={h} d={d} ps={ps} pp={pp} bf16 "
                   "lengths=1x300", max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                   library_ms=None, sdpa_over_gathered_keys_ms=sdpa_over(
                       torch, q1.reshape(1, h, 1, d).to(torch.bfloat16),
                       gathered)))
    print(f"B6 {b6[-1]}", flush=True)
    del pools1, gathered
    h13 = 40
    k13, v13 = (torch.randn((h13, 2 * pp + 1, ps, d), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
    q13 = torch.randn((2, h13, d), generator=gen, device=dev)
    t13 = torch.randperm(2 * pp, generator=gen, device=dev).reshape(
        2, pp).to(torch.int32)
    for lens in ([300, 1], [pp * ps, ps + 1]):
        ctx = pa.paged_decode_attention(q13, k13, v13, i32(lens), t13)
        ref = pa.paged_decode_attention_plain(q13, k13, v13, i32(lens), t13)
        err = (ctx - ref).abs().max().item()
        tol = 2 ** -7 * ref.abs().max().item() + 1e-6
        require(err <= tol, f"B6 H=40 {lens}: err {err} > {tol}")
        b6.append(dict(shape=f"B=2 H={h13} d={d} ps={ps} pp={pp} bf16 "
                       f"lengths={lens}", max_abs_err=err, tol=tol))
    del k13, v13
    results["B6"], results["B7"], results["B8"] = b6, b7, b8
    results["B11"] = b11
    results["B11_phase2_launches"] = b11_launches

    # B4 and B10 at B = 8 with per-slot depths; slot 4 is inactive
    s_len = ENG_CTX
    scale = 1 / math.sqrt(d)
    n_caches = 3                          # 3 x 2 x 33.5 MB > L2
    caches = [tuple(torch.randn((b, s_len, f), generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
              for _ in range(n_caches)]
    for label, depths in (("mixed", [0, 1, 63, 64, 300, 511, s_len + 1,
                                     200]), ("8x300", [300] * b)):
        npv = i32(depths)
        cos, sin = da.rope_lane_tables(npv.clamp_max(s_len - 1), d, d)
        qkv = torch.randn((b, 1, 3 * f), generator=gen, device=dev)
        kc, vc = caches[0]
        kc2, vc2 = kc.clone(), vc.clone()
        kc3, vc3 = kc.clone(), vc.clone()
        kw4 = dict(head_dim=d, n_rot=d, scale=scale)
        ctx = da.decode_attention_fused(qkv, kc, vc, npv, cos, sin, **kw4)
        ref = da.decode_attention_fused_plain(qkv, kc2, vc2, npv, cos, sin,
                                              **kw4)
        again = da.decode_attention_fused(qkv, kc3, vc3, npv, cos, sin, **kw4)
        torch.cuda.synchronize()
        err = (ctx - ref).abs().max().item()
        tol = 2 ** -7 * ref.abs().max().item() + 1e-6
        require(bool(torch.isfinite(ctx).all()), f"B4 B=8 {label}: not finite")
        require(err <= tol, f"B4 B=8 {label}: err {err} > {tol}")
        require(torch.equal(kc, kc2) and torch.equal(vc, vc2),
                f"B4 B=8 {label}: caches differ")
        require(torch.equal(ctx, again) and torch.equal(kc, kc3)
                and torch.equal(vc, vc3), f"B4 B=8 {label}: not deterministic")
        del kc3, vc3
        it = iter(range(10**9))

        def run4():
            kk, vv = caches[next(it) % n_caches]
            da.decode_attention_fused(qkv, kk, vv, npv, cos, sin, **kw4)
        ms = time_ms(torch, run4, calls=8 * n_caches)
        plain_ms = time_ms(torch, lambda: da.decode_attention_fused_plain(
            qkv, kc2, vc2, npv, cos, sin, **kw4), calls=2)
        rows = sum(min(n, s_len) for n in depths)
        bnd, by = bound_ms(b * 3 * f * 4 + 2 * rows * f * 2 + 2 * b * f * 2
                           + 2 * b * d * 4 + b * 4 + b * f * 4,
                           4.0 * rows * f, "bf16")
        results["B4"].append(dict(
            shape=f"B={b} S={s_len} H={h} d={d} depths {label} {depths}",
            max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
            bound_by=by))
        print(f"B4 {results['B4'][-1]}", flush=True)

        q = torch.randn((b, 1, f), generator=gen, device=dev)
        ctx = da.decode_attention(q, kc, vc, npv, head_dim=d, scale=scale)
        ref = da.decode_attention_plain(q, kc, vc, npv, head_dim=d,
                                        scale=scale)
        torch.cuda.synchronize()
        err = (ctx - ref).abs().max().item()
        tol = 5e-5 * ref.abs().max().item() + 1e-6
        require(bool(torch.isfinite(ctx).all()),
                f"B10 B=8 {label}: not finite")
        require(err <= tol, f"B10 B=8 {label}: err {err} > {tol}")
        it = iter(range(10**9))

        def run10():
            kk, vv = caches[next(it) % n_caches]
            da.decode_attention(q, kk, vv, npv, head_dim=d, scale=scale)
        ms = time_ms(torch, run10, calls=8 * n_caches)
        plain_ms = time_ms(torch, lambda: da.decode_attention_plain(
            q, kc, vc, npv, head_dim=d, scale=scale), calls=2)
        rows = sum(min(n + 1, s_len) for n in depths)
        bnd, by = bound_ms(2 * b * f * 4 + 2 * rows * f * 2 + b * 4,
                           4.0 * rows * f, "bf16")
        row = dict(shape=f"B={b} S={s_len} H={h} d={d} depths {label} "
                   f"{depths}", max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, bound_ms=bnd, bound_by=by)
        if label == "8x300":
            qh = q.reshape(b, h, 1, d).to(torch.bfloat16)
            row["library_ms"] = sdpa_cycled(torch, qh, caches, 301, h, d)
        results["B10"].append(row)
        print(f"B10 {row}", flush=True)
    del caches


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

def check_fused_paged_step(torch, dev, gen, results, heads=(32, 40)):
    """Phase 2, the fused paged step (RoPE + B7's write + B6's attention in
    one launch) at 7B and 13B heads, or at the heads a rank holds under
    tensor parallelism (SHARD_HEADS; rows to results["shard_local"]), bf16
    and f32 pools: eight slots at
    lengths 0, 1, ps - 1, ps, ps + 1, 300 and pp * ps - 1 plus an inactive
    slot (sentinel page id, length 0), NaN in every page no sequence
    reaches. Held against its plain version (ctx within B6's tolerance on
    the active slots, every written row bit for bit) and against the
    standalone B7 + B6 on the same roped q and k (ctx within B6's
    tolerance, the pools bit for bit); timed at 8 x 300 and at the steady
    window's depths beside the unfused step (the forward's glue: split,
    concatenation, RoPE, two copies; then B7 and B6)."""
    from fastllama_tpu_torch.kernels import kv_write as kw
    from fastllama_tpu_torch.kernels import paged_attention as pa
    from fastllama_tpu_torch.kernels.decode_attention import _rope_fma
    from fastllama_tpu_torch.kernels.rope import (
        lane_tables, rope_interleaved_lanes)
    d, ps, b = 128, ENG_PS, ENG_SLOTS
    pp = ENG_CTX // ps
    n_pages = b * pp                      # + the trash page

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    def write_at(tables, lens, active):
        tl = tables.tolist()
        return (i32([tl[i][n // ps] if a else n_pages
                     for i, (n, a) in enumerate(zip(lens, active))]),
                i32([n % ps if a else 0 for n, a in zip(lens, active)]))

    def roped(qkv, cos, sin, h):
        f = h * d
        q, k, v = (qkv[:, i * f:(i + 1) * f].reshape(b, h, d)
                   for i in range(3))
        partner = torch.arange(d, device=dev) ^ 1
        c, sn = cos[:, None, :], sin[:, None, :]
        return (*(_rope_fma(t, t[..., partner], c, sn) for t in (q, k)),
                v.contiguous())

    rows = []
    lens_check = [0, 1, ps - 1, ps, ps + 1, 300, pp * ps - 1, 0]
    active = [True] * 7 + [False]
    for h in heads:
        f = h * d
        for dt in (torch.bfloat16, torch.float32):
            name = f"H={h} {'bf16' if dt == torch.bfloat16 else 'f32'}"
            kp, vp = (torch.randn((h, n_pages + 1, ps, d), generator=gen,
                                  device=dev).to(dt) for _ in range(2))
            tables = torch.randperm(n_pages, generator=gen, device=dev)\
                .reshape(b, pp).to(torch.int32).contiguous()
            lengths = i32(lens_check)
            pids, offs = write_at(tables, lens_check, active)
            qkv = torch.randn((b, 3 * f), generator=gen, device=dev)
            cos, sin = lane_tables(lengths, d, d)
            used = torch.zeros(n_pages + 1, dtype=torch.bool, device=dev)
            for row, n, a in zip(tables.tolist(), lens_check, active):
                if a:
                    used[row[:n // ps + 1]] = True
            kq, vq = kp.clone(), vp.clone()
            kq[:, ~used] = float("nan")
            vq[:, ~used] = float("nan")
            ctx = pa.paged_decode_step_fused(qkv, kq, vq, lengths, tables,
                                             pids, offs, cos, sin)
            k2, v2 = kp.clone(), vp.clone()
            ref = pa.paged_decode_step_fused_plain(qkv, k2, v2, lengths,
                                                   tables, pids, offs, cos,
                                                   sin)
            qr, kr, v = roped(qkv, cos, sin, h)
            k3, v3 = kp.clone(), vp.clone()
            kw.paged_kv_write(k3, v3, kr, v, pids, offs)
            unfused = pa.paged_decode_attention(qr, k3, v3, lengths + 1,
                                                tables)
            torch.cuda.synchronize()
            act = torch.tensor(active, device=dev)
            require(bool(torch.isfinite(ctx).all()),
                    f"fused step {name}: not finite")
            tol = ((2 ** -7 if dt == torch.bfloat16 else 5e-5)
                   * ref[act].abs().max().item() + 1e-6)
            err = (ctx - ref)[act].abs().max().item()
            err_b = (ctx - unfused)[act].abs().max().item()
            require(err <= tol, f"fused step {name}: err {err} > {tol}")
            require(err_b <= tol, f"fused step {name}: against B7 + B6 "
                    f"err {err_b} > {tol}")
            idx = used[:n_pages].nonzero().flatten()
            require(all(torch.equal(x[:, idx], y[:, idx]) and
                        torch.equal(x[:, idx], z[:, idx])
                        for x, y, z in ((kq, k2, k3), (vq, v2, v3))),
                    f"fused step {name}: written pages differ from the "
                    "plain write's or B7's")
            row = dict(shape=f"B={b} {name} d={d} ps={ps} pp={pp} "
                       f"lengths={lens_check} (last slot inactive)",
                       max_abs_err=err, err_vs_b7_b6=err_b, tol=tol)
            if h != 40:
                for label, lens in (("8x300", [300] * b),
                                    ("steady", [100, 107, 114, 121, 128, 135,
                                                142, 150])):
                    tl = i32(lens)
                    pi, of = write_at(tables, lens, [True] * b)
                    cs, sn = lane_tables(tl, d, d)
                    pools = [(kp, vp)] + [tuple(
                        torch.randn((h, n_pages + 1, ps, d), generator=gen,
                                    device=dev).to(dt) for _ in range(2))
                        for _ in range(2)]
                    it = iter(range(10**9))

                    def fused():
                        kk, vv = pools[next(it) % len(pools)]
                        pa.paged_decode_step_fused(qkv, kk, vv, tl, tables,
                                                   pi, of, cs, sn)

                    def glue_b7_b6():
                        # the forward's unfused step, from the same qkv
                        kk, vv = pools[next(it) % len(pools)]
                        q, k, v = qkv.view(b, 1, 3, h, d).unbind(2)
                        qk = rope_interleaved_lanes(
                            torch.cat([q, k], dim=2), cs[:, None, None, :],
                            sn[:, None, None, :], d)
                        kw.paged_kv_write(kk, vv, qk[:, 0, h:].contiguous(),
                                          v[:, 0].contiguous(), pi, of)
                        pa.paged_decode_attention(qk[:, 0, :h], kk, vv,
                                                  tl + 1, tables)
                    ms = time_ms(torch, fused, calls=8 * len(pools))
                    unfused_ms = time_ms(torch, glue_b7_b6,
                                         calls=8 * len(pools))
                    plain_ms = time_ms(torch, lambda: pa
                                       .paged_decode_step_fused_plain(
                                           qkv, k2, v2, tl, tables, pi, of,
                                           cs, sn), calls=2)
                    n_rows = sum(lens)
                    isz = dt.itemsize
                    bnd, by = bound_ms(
                        b * 3 * f * 4 + 2 * b * d * 4 + 2 * n_rows * f * isz
                        + 2 * b * f * isz + b * f * 4 + 3 * b * 4
                        + b * pp * 4, 4.0 * (n_rows + b) * f,
                        "bf16" if isz == 2 else "f32")
                    rows.append(dict(
                        shape=f"B={b} {name} d={d} ps={ps} pp={pp} "
                        f"lengths={label}", max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, unfused_glue_b7_b6_ms=unfused_ms,
                        bound_ms=bnd, bound_by=by, library_ms=None))
                    print(f"fused step {rows[-1]}", flush=True)
                    del pools
            rows.append(row)
            print(f"fused step {row}", flush=True)
            del kp, vp, kq, vq, k2, v2, k3, v3
    if heads == SHARD_HEADS:
        results["shard_local"] += [dict(kernel="PS", **r) for r in rows]
    else:
        results["PS"] = rows


def counted_kernels(qm, da):
    from fastllama_tpu_torch.kernels.flash_prefill import flash_prefill
    return {"B1": qm.q4_matmul_decode, "B2": qm.quant_rows_int8,
            "B3": qm.q4_matmul_prefill_int8, "B4": da.decode_attention_fused,
            "B5": qm.q4_matmul_prefill, "B9": qm.q41_matmul_decode,
            "B10": da.decode_attention, "B12": flash_prefill}


def reset_counts(qm, da):
    for fn in counted_kernels(qm, da).values():
        fn.launches = 0


def read_counts(qm, da):
    return {k: fn.launches for k, fn in counted_kernels(qm, da).items()}


N_PROMPT, N_DECODE = 300, 64
PREFILL_MATMULS = 4 * 32     # a 512-row window: four matmuls a layer
FLASH_WINDOW = 32            # B12 once a layer in a fresh 512-row window
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
    require(counts["B12"] == FLASH_WINDOW, f"B12 launched {counts['B12']} "
            f"times in the TTFT window, not {FLASH_WINDOW}")
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
    require(profile, "the profiler saw no device time in the decode steps")
    traced = trace_session(torch, model, sess, profile["device_ms_per_token"])
    prefill = profile_prefill(torch, sess, prompt)
    prefill_masked = profile_prefill(torch, sess, prompt, flash=False)
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
               decode_profile=profile, prefill_profile=prefill,
               prefill_profile_masked_route=prefill_masked,
               traced_generate=traced, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"main path: {json.dumps(res)}", flush=True)
    del sess, model

    # the bf16-exact prefill: the same parameters with int8 prefill off
    model, sess = make_session(hp, params, dev, prefill_int8=False)
    warm_up(sess, prompt)
    reset_counts(qm, da)
    exact = timed_run(torch, sess, prompt)
    ecounts = read_counts(qm, da)
    require(ecounts["B5"] == PREFILL_MATMULS, f"B5 launched {ecounts['B5']} "
            f"times in one prefill window, not {PREFILL_MATMULS}")
    require(ecounts["B2"] == 0 and ecounts["B3"] == 0,
            "int8 prefill kernels launched with prefill_int8=False")
    require(ecounts["B12"] == FLASH_WINDOW, f"bf16-exact window: B12 "
            f"launched {ecounts['B12']} times, not {FLASH_WINDOW}")
    require(ecounts["B1"] == DECODE_MATMULS and ecounts["B4"] == LAYER_CALLS,
            f"bf16-exact run: unexpected decode launches {ecounts}")
    ettfts = [exact[0]] + [timed_run(torch, sess, prompt)[0]
                           for _ in range(2)]
    res["bf16_prefill"] = dict(
        ttft_ms=float(np.median(ettfts)), ttft_ms_runs=ettfts,
        int8_ttft_ms=res["ttft_ms"], launches=ecounts,
        prefill_profile=profile_prefill(torch, sess, prompt),
        prefill_profile_masked_route=profile_prefill(torch, sess, prompt,
                                                     flash=False))
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
        # the gate does not look at LoRA: B12 attends the window attached
        want = {"B9": DECODE_MATMULS, "B1": 0, "B2": 0, "B3": 0,
                "B5": PREFILL_MATMULS, "B12": FLASH_WINDOW,
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
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        require(sess.generate(lambda s: None, num_tokens=n_steps, temp=0.0),
                "profiled generate failed")
        torch.cuda.synchronize()
    dev_ms, launches, top = device_time_by_kernel(prof, n_steps)
    if dev_ms <= 0:
        return {}
    return {"device_ms_per_token": dev_ms,
            "kernels": [{"name": k, "ms_per_token": ms, "calls_per_token": n}
                        for k, ms, n in top]}


def profile_prefill(torch, sess, prompt, flash=True) -> dict:
    """The TTFT window (reset, ingest, first token) under torch.profiler:
    device ms by kernel, so the prefill's device time reads apart from the
    host clock. flash=False runs the window on the route B12 replaced (the
    masked f32 softmax over the cache), by taking the flash flag off the
    model's configs for this window: the before of B12's after, in the
    same call. Empty if the profiler sees no device activity."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    model = sess.model
    cfgs = model._cfg
    if not flash:
        model._cfg = {key: dataclasses.replace(c, flash_prefill=False)
                      for key, c in cfgs.items()}
    sess.reset()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            require(sess.ingest(prompt), "profiled ingest failed")
            require(sess.generate(lambda s: None, num_tokens=1, temp=0.0),
                    "profiled first token failed")
            torch.cuda.synchronize()
    finally:
        model._cfg = cfgs
    dev_ms, launches, top = device_time_by_kernel(prof, 1)
    if dev_ms <= 0:
        return {}
    return {"device_ms": dev_ms, "launches": launches,
            "kernels": [{"name": k, "ms": ms, "calls": n} for k, ms, n in top]}


def kernel_device_us(prof) -> dict:
    """{kernel name: (device µs, launches)} from a torch.profiler trace."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        old = by_name.get(e.key, (0.0, 0))
        by_name[e.key] = (old[0] + us, old[1] + e.count)
    return by_name


def device_ms_by_name(torch, fn, calls: int, names) -> dict:
    """Device ms per fn() call of the kernels whose names contain each of
    `names`, from a torch.profiler trace of `calls` calls (after two warm-up
    calls): the launches of one wrapper timed apart. Fails if a name is
    missing from the trace."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = kernel_device_us(prof)
    out = {}
    for want in names:
        hits = [v for k, v in by_name.items() if want in k]
        require(hits and sum(c for _, c in hits) == calls,
                f"profiler: {want} not seen {calls} times in the trace")
        out[want] = sum(us for us, _ in hits) / 1e3 / calls
    return out


def device_time_by_kernel(prof, n_steps: int):
    """From a torch.profiler trace of n_steps steps: (device ms per step,
    device launches per step, the twelve kernels with the most device time
    as (name, ms per step, calls per step))."""
    by_name = kernel_device_us(prof)
    total_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return (total_us / 1e3 / n_steps,
            sum(v[1] for v in by_name.values()) / n_steps,
            [(k[:90], v[0] / 1e3 / n_steps, v[1] / n_steps) for k, v in top])


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
    res = dict(path=path, n_layer=n_layer, write_s=write_s, load_s=load_s,
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


# ---------------------------------------------------------------------------
# phase 7: the converters and the native repack
# ---------------------------------------------------------------------------

def write_f16_file(path, hp, seed):
    """A GGJT file of f16 tensors at full width, norms one: random f16 bit
    patterns with the exponent field at most 7 (|w| < 2^-7, finite, signs
    and mantissas uniform), made as integers since normal samples of 666M
    weights take most of this phase's time."""
    from fastllama_tpu_torch.io.ggml_writer import write_ggjt
    rng = np.random.default_rng(seed)

    def w(n, k):
        bits = rng.integers(0, 1 << 16, (n, k), dtype=np.uint16)
        return ("f16", (bits & np.uint16(0x9FFF)).view(np.float16))

    d, f = hp.n_embd, hp.n_ff
    ones = ("f32", np.ones(d, np.float32))
    tensors = {"tok_embeddings.weight": w(hp.n_vocab, d), "norm.weight": ones,
               "output.weight": w(hp.n_vocab, d)}
    for i in range(hp.n_layer):
        p = f"layers.{i}."
        tensors[p + "attention_norm.weight"] = ones
        tensors[p + "ffn_norm.weight"] = ones
        for nm in ("wq", "wk", "wv", "wo"):
            tensors[p + f"attention.{nm}.weight"] = w(d, d)
        tensors[p + "feed_forward.w1.weight"] = w(f, d)
        tensors[p + "feed_forward.w3.weight"] = w(f, d)
        tensors[p + "feed_forward.w2.weight"] = w(d, f)
    write_ggjt(path, hp, synthetic_vocab(hp.n_vocab), tensors)


class LogLines:
    """A Logger whose info channel is kept, to read which repack route a
    load took."""

    def __init__(self):
        import fastllama_tpu_torch
        self.lines = []
        self.logger = fastllama_tpu_torch.Logger(
            log_fn=lambda fn, msg: self.lines.append(msg))

    def route(self):
        return [ln.split(":", 1)[1].strip() for ln in self.lines
                if ln.startswith("q4_0 repack:")]


def load_timed(torch, path, numpy_route=False):
    """Model(path=...) on the card through the native repack or (numpy_route)
    the numpy one; returns (model, load seconds, the route the log names)."""
    import fastllama_tpu_torch
    from fastllama_tpu_torch.quant import native
    saved = native._LIB
    if numpy_route:
        native._LIB = None               # _TRIED stays set: available() False
    log = LogLines()
    try:
        t0 = time.perf_counter()
        model = fastllama_tpu_torch.Model(path=path, n_ctx=512, n_batch=64,
                                          logger=log.logger)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        native._LIB = saved
    return model, load_s, log.route()


def model_planes(lm):
    p = lm.params
    out = [p.tok_embeddings.qs, p.tok_embeddings.scales, p.output.qs,
           p.output.scales]
    for layer in p.layers:
        for f in ("wqkv", "wo", "w13", "w2"):
            out += [getattr(layer, f).qs, getattr(layer, f).scales]
    return out


def eval_logits(lm):
    """Prefill (21 tokens) and first decode logits of a loaded model."""
    toks = [1] + list(range(300, 320))
    lm.reset()
    return lm.eval(0, toks), lm.eval(len(toks), [toks[-1]])


def converters_path(torch, tmp, fltpu_path):
    """Phase 7: the native library, a 2-layer f16 file at 7B widths
    quantized by the port's quantize (fltpu) and export_ggjt (GGJT), phase
    5's fltpu directory exported to GGJT; each GGJT loaded on the card by
    the native route and the numpy route: equal planes, equal logits."""
    import dataclasses
    from fastllama_tpu_torch import native as native_build
    from fastllama_tpu_torch.config import PRESETS, FType
    from fastllama_tpu_torch.io.convert import export_ggjt, quantize
    from fastllama_tpu_torch.quant import native, q4

    lib = native_build.build_native()
    require(native.available(), "the native repack library did not load")
    # built at first use, by phase 5's first GGJT load (None: a build of an
    # earlier run in this checkout was found)
    build_s = native_build.build_seconds.get("fastllama_native")
    print(f"native repack built in {build_s} s ({lib}, flags "
          f"{' '.join(native_build.CXXFLAGS)})", flush=True)

    # the quantizers alone on one w13-sized tensor: bit-equal, timed
    x = (np.random.default_rng(12).standard_normal((11008, 4096),
                                                   dtype=np.float32) * 0.02)
    t0 = time.perf_counter()
    nat = native.quantize_q4_0(x)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = q4.quantize_q4_0(x)
    np_s = time.perf_counter() - t0
    require(all(np.array_equal(a, b) for a, b in zip(nat, ref)),
            "native q4_0 quantization differs from numpy's")
    del x, nat, ref

    hp = dataclasses.replace(PRESETS["7B"], n_layer=2, ftype=FType.MOSTLY_F16)
    f16 = os.path.join(tmp, "f16_2_layers.bin")
    t0 = time.perf_counter()
    write_f16_file(f16, hp, seed=8)
    write_s = time.perf_counter() - t0
    outs = {"quantized.fltpu": os.path.join(tmp, "quantized.fltpu"),
            "quantized.ggjt": os.path.join(tmp, "quantized.bin"),
            "exported.ggjt": os.path.join(tmp, "exported.bin")}
    t0 = time.perf_counter()
    quantize(f16, outs["quantized.fltpu"], FType.MOSTLY_Q4_0)
    quantize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    export_ggjt(f16, outs["quantized.ggjt"], FType.MOSTLY_Q4_0)
    export_f16_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    export_ggjt(fltpu_path, outs["exported.ggjt"], FType.MOSTLY_Q4_0)
    export_fltpu_s = time.perf_counter() - t0

    loads = {}
    for label in ("quantized.ggjt", "exported.ggjt"):
        path = outs[label]
        # native, numpy, numpy, native: the first load of a file pays for
        # reading it into the page cache and growing the allocator
        m_nat, nat_load_s, nat_route = load_timed(torch, path)
        m_np, np_load_s, np_route = load_timed(torch, path, numpy_route=True)
        again = [load_timed(torch, path, numpy_route=True)[1],
                 load_timed(torch, path)[1]]
        require(nat_route == ["native"] and np_route == ["numpy"],
                f"{label}: repack routes {nat_route} / {np_route}")
        pa, pb = model_planes(m_nat._model), model_planes(m_np._model)
        require(len(pa) == len(pb) and all(
            a.device.type == "cuda" and torch.equal(a, b)
            for a, b in zip(pa, pb)),
            f"{label}: native-route planes differ from the numpy route's")
        la, lb = eval_logits(m_nat._model), eval_logits(m_np._model)
        require(all(np.array_equal(a, b) for a, b in zip(la, lb))
                and all(np.isfinite(a).all() for a in la),
                f"{label}: native-route logits differ from the numpy route's")
        loads[label] = dict(native_load_s=[nat_load_s, again[1]],
                            numpy_load_s=[np_load_s, again[0]],
                            planes=len(pa), logits_bit_equal=True)
        if label == "quantized.ggjt":
            lq = eval_logits(load_timed(torch, outs["quantized.fltpu"])[0]
                             ._model)
            require(all(np.array_equal(a, b) for a, b in zip(la, lq)),
                    "quantize (fltpu) and export_ggjt (GGJT) of one f16 file "
                    "give other logits")
        del m_nat, m_np
        torch.cuda.empty_cache()
    res = dict(build_s=build_s, cxxflags=native_build.CXXFLAGS,
               quantize_q4_0_11008x4096_s={"native": nat_s, "numpy": np_s},
               f16_write_s=write_s, quantize_s=quantize_s,
               export_ggjt_f16_s=export_f16_s,
               export_ggjt_fltpu_s=export_fltpu_s, loads=loads,
               f16_file_bytes=os.path.getsize(f16))
    print(f"converters and native repack: {json.dumps(res)}", flush=True)
    os.remove(f16)
    return res


# ---------------------------------------------------------------------------
# phase 8: the C ABI on the card
# ---------------------------------------------------------------------------

# Python run by the C ABI's boot hook in the C program's embedded
# interpreter: after each generate / perplexity it prints one line to stderr
# with the card, the kernels' launch counts since the process started, the
# host time of the call, and the kernel library's load time.
C_INIT = r"""
import json, sys, time, torch
import fastllama_tpu_torch as _F
from fastllama_tpu_torch.kernels import cuda_lib as _cl
from fastllama_tpu_torch.kernels import decode_attention as _da
from fastllama_tpu_torch.kernels import q4_matmul as _qm
_K = {"B1": _qm.q4_matmul_decode, "B2": _qm.quant_rows_int8,
      "B3": _qm.q4_matmul_prefill_int8, "B4": _da.decode_attention_fused,
      "B5": _qm.q4_matmul_prefill, "B9": _qm.q41_matmul_decode,
      "B10": _da.decode_attention}
def _wrap(name):
    inner = getattr(_F.Model, name)
    def call(self, *a, **k):
        t0 = time.perf_counter()
        r = inner(self, *a, **k)
        torch.cuda.synchronize()
        print("C_ABI_RUN " + json.dumps({
            "call": name, "s": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name(),
            "on_card": self._model.device.type == "cuda",
            "launches": {k_: f.launches for k_, f in _K.items()},
            "kernel_lib_s": _cl.build_seconds}), file=sys.stderr, flush=True)
        return r
    setattr(_F.Model, name, call)
_wrap("generate")
_wrap("perplexity")
"""


# The Python API in a fresh process, as main.c drives the C ABI: load, stop
# word, ingest, one greedy generate, timed as the boot hook above times it.
PY_RUN = r"""
import json, sys, time, torch
import fastllama_tpu_torch
path, prompt, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
m = fastllama_tpu_torch.Model(path=path, n_ctx=512)
m.set_stop_words("###")
assert m.ingest(prompt)
chunks = []
t0 = time.perf_counter()
assert m.generate(num_tokens=n, top_k=40, top_p=0.95, temp=0.0,
                  repeat_penalty=1.0, streaming_fn=chunks.append)
torch.cuda.synchronize()
print(json.dumps({"s": time.perf_counter() - t0, "text": "".join(chunks)}))
"""


# The python command line as a C program linked to the shared libpython the
# C ABI embeds: PY_RUN through it costs what the embedded interpreter
# costs, without the ABI.
EMBED_HOST_C = r"""
#include <Python.h>
int main(int argc, char** argv) { return Py_BytesMain(argc, argv); }
"""


def c_runs(stderr: str) -> list:
    return [json.loads(ln.split("C_ABI_RUN ", 1)[1])
            for ln in stderr.splitlines() if ln.startswith("C_ABI_RUN ")]


def c_abi_path(torch, tmp, model_path):
    """Phase 8: libfastllama_c.so from the port's sources; examples/c/main.c
    and perplexity.c compiled unchanged against it and run on phase 5's
    8-layer q4_0 GGJT; held against fastllama_tpu_torch.Model here."""
    import fastllama_tpu_torch
    from fastllama_tpu_torch import native as native_build

    lib = native_build.build_c_abi()
    build_s = native_build.build_seconds.get("fastllama_c")
    repo = os.path.dirname(os.path.abspath(__file__))
    progs = {}
    for name in ("main", "perplexity"):
        progs[name] = os.path.join(tmp, f"fl_{name}")
        cc = subprocess.run(
            ["gcc", os.path.join(repo, "examples", "c", f"{name}.c"),
             f"-I{native_build.HEADER_DIR}", f"-L{lib.parent}",
             "-lfastllama_c", "-o", progs[name]],
            capture_output=True, text=True)
        require(cc.returncode == 0, f"examples/c/{name}.c did not compile "
                f"against the port's header and library:\n{cc.stderr}")
    env = native_build.c_program_env(lib.parent)
    env["FASTLLAMA_C_INIT"] = C_INIT
    prompt = prompt_of(N_PROMPT - 2, seed=9)

    t0 = time.perf_counter()
    r = subprocess.run([progs["main"], model_path, prompt, str(N_DECODE), "0"],
                       capture_output=True, env=env, timeout=600)
    c_wall = time.perf_counter() - t0
    err = r.stderr.decode(errors="replace")
    require(r.returncode == 0, f"main.c exited {r.returncode}:\n{err[-4000:]}")
    runs = c_runs(err)
    require(len(runs) == 1 and runs[0]["on_card"], f"main.c runs: {runs}")
    crun = runs[0]
    require(crun["launches"]["B1"] > 0 and crun["launches"]["B4"] > 0,
            f"the C program launched {crun['launches']}: B1 and B4 expected")
    require(f"logits: {32000} values" in err, "main.c: no logits view line")

    # the same through the Python API in a fresh process: the same cold start
    t0 = time.perf_counter()
    rpy = subprocess.run([sys.executable, "-c", PY_RUN, model_path, prompt,
                          str(N_DECODE)], capture_output=True, text=True,
                         timeout=600, cwd=repo)
    py_wall = time.perf_counter() - t0
    require(rpy.returncode == 0, f"the Python API run failed:\n"
            f"{rpy.stderr[-4000:]}")
    py_cold = json.loads(rpy.stdout.strip().splitlines()[-1])

    # ... and in a C program that is the python command over libpython
    host_src = os.path.join(tmp, "py_host.c")
    with open(host_src, "w") as fh:
        fh.write(EMBED_HOST_C)
    host = os.path.join(tmp, "py_host")
    cc = subprocess.run(["gcc", host_src, "-o", host,
                         *native_build.embed_flags()],
                        capture_output=True, text=True)
    require(cc.returncode == 0, f"py_host.c did not build:\n{cc.stderr}")
    env_host = native_build.c_program_env(lib.parent)
    rh = subprocess.run([host, "-c", PY_RUN, model_path, prompt,
                         str(N_DECODE)], capture_output=True, text=True,
                        timeout=600, cwd=repo, env=env_host)
    require(rh.returncode == 0, f"the Python API run in py_host failed:\n"
            f"{rh.stderr[-4000:]}")
    py_host = json.loads(rh.stdout.strip().splitlines()[-1])

    # the same file and arguments through the Python API, in this process
    t0 = time.perf_counter()
    model = fastllama_tpu_torch.Model(path=model_path, n_ctx=512)
    load_s = time.perf_counter() - t0
    chunks = []
    model.set_stop_words("###")
    require(model.ingest(prompt), "Model.ingest failed")
    n_prompt = model.session.n_past + len(model.session._embd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    require(model.generate(num_tokens=N_DECODE, top_k=40, top_p=0.95,
                           temp=0.0, repeat_penalty=1.0,
                           streaming_fn=chunks.append), "Model.generate")
    torch.cuda.synchronize()
    py_gen_s = time.perf_counter() - t0
    n_gen = model.session.n_past - n_prompt + 1
    text = "".join(chunks).encode()
    require(len(text) > 0 and r.stdout.rstrip(b"\n") == text
            and py_cold["text"].encode() == text
            and py_host["text"].encode() == text,
            f"main.c streamed {r.stdout[:120]!r}..., the Python API "
            f"{text[:120]!r}... ({py_cold['text'][:120]!r}... in a fresh "
            "process)")
    del model

    # perplexity.c over a file holding the prompt
    text_file = os.path.join(tmp, "prompt.txt")
    with open(text_file, "w") as fh:
        fh.write(prompt)
    t0 = time.perf_counter()
    rp = subprocess.run([progs["perplexity"], model_path, text_file],
                        capture_output=True, env=env, timeout=600)
    ppl_wall = time.perf_counter() - t0
    perr = rp.stderr.decode(errors="replace")
    out = rp.stdout.decode(errors="replace")
    require(rp.returncode == 0,
            f"perplexity.c exited {rp.returncode}:\n{perr[-4000:]}")
    require(c_runs(perr) and c_runs(perr)[0]["on_card"],
            "perplexity.c did not run on the card")
    c_ppl = float(out.split("perplexity: ", 1)[1].split()[0])
    model = fastllama_tpu_torch.Model(path=model_path, n_ctx=512,
                                      should_get_all_logits=True)
    py_ppl = model.perplexity(prompt)
    require(abs(c_ppl - py_ppl) <= 1e-3 * abs(py_ppl),
            f"perplexity.c {c_ppl} against Model.perplexity {py_ppl}")
    del model
    torch.cuda.empty_cache()
    res = dict(c_abi_build_s=build_s, prompt_tokens=n_prompt,
               tokens=n_gen, c_program_wall_s=c_wall,
               c_generate_s=crun["s"], c_tok_s=n_gen / crun["s"],
               c_launches=crun["launches"], c_device=crun["device"],
               c_kernel_lib_s=crun["kernel_lib_s"],
               python_process_wall_s=py_wall,
               python_process_generate_s=py_cold["s"],
               python_process_tok_s=n_gen / py_cold["s"],
               python_shared_libpython_generate_s=py_host["s"],
               python_shared_libpython_tok_s=n_gen / py_host["s"],
               python_warm_load_s=load_s, python_warm_generate_s=py_gen_s,
               python_warm_tok_s=n_gen / py_gen_s, streams_equal=True,
               c_perplexity=c_ppl, python_perplexity=py_ppl,
               perplexity_c_wall_s=ppl_wall)
    print(f"C ABI: {json.dumps(res)}", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 9: traces
# ---------------------------------------------------------------------------

def traced_breakdown(trace_dir, label, want):
    """device_op_breakdown of a trace; fails unless every name in `want` is
    a key. Prints the top 10."""
    from fastllama_tpu_torch.utils.trace import (
        device_op_breakdown, print_breakdown,
    )
    total, agg, cnt = device_op_breakdown(trace_dir)
    missing = [k for k in want if k not in agg]
    require(not missing, f"trace {label}: no {missing} in {sorted(agg)}")
    print(f"trace {label}:", flush=True)
    print_breakdown(total, agg, cnt, top=10, file=sys.stdout)
    return total, [{"name": k, "us": v, "calls": cnt[k]}
                   for k, v in agg.most_common(10)]


def trace_session(torch, model, sess, profile_ms, n_steps=8):
    """Phase 9, the session: profile_dir set for n_steps greedy tokens; the
    breakdown names B1's and B4's kernels and its device total is within
    10% of profile_decode's over as many steps of the same session."""
    import dataclasses
    t0 = time.perf_counter()
    trace_dir = tempfile.mkdtemp(prefix="fltorch_trace_")
    try:
        model.rcfg = dataclasses.replace(model.rcfg, profile_dir=trace_dir)
        require(sess.generate(lambda s: None, num_tokens=n_steps, temp=0.0),
                "traced generate failed")
        model.rcfg = dataclasses.replace(model.rcfg, profile_dir="")
        total, top = traced_breakdown(
            os.path.join(trace_dir, "generate"), "generate",
            ("q4_mma_kernel", "attn_split_kernel"))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    ref_ms = profile_ms * n_steps
    require(abs(total / 1e3 - ref_ms) <= 0.1 * ref_ms,
            f"traced generate: {total / 1e3} ms of device time against "
            f"{ref_ms} ms in the script's own profile")
    return dict(steps=n_steps, device_ms=total / 1e3, profile_ms=ref_ms,
                top=top, seconds=time.perf_counter() - t0)


def trace_engine(torch, sched, make_traced):
    """Phase 9, the engine: one short run() (2 requests, 8 tokens) with
    profile_dir; its breakdown names the fused paged step's kernel, which
    launched (and standalone B6 did not)."""
    kernels = all_kernels()
    t0 = time.perf_counter()
    trace_dir = tempfile.mkdtemp(prefix="fltorch_trace_")
    try:
        eng = make_traced(trace_dir)
        reqs = [sched.Request(prompt=prompt_of(40, seed=400 + i),
                              max_tokens=8, temp=0.0) for i in range(2)]
        for fn in kernels.values():
            fn.launches = 0
        eng.run(reqs)
        counts = {k: fn.launches for k, fn in kernels.items()}
        require(all(len(r.tokens_out) == 8 for r in reqs),
                "traced engine run: a request did not finish")
        require(counts["PS"] > 0 and counts["B6"] == 0,
                f"traced engine run: launches {counts}")
        total, top = traced_breakdown(
            os.path.join(trace_dir, "engine_run"), "engine_run",
            ("paged_split_kernel", "q4_mma_kernel"))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    return dict(device_ms=total / 1e3, launches=counts, top=top,
                seconds=time.perf_counter() - t0)



# ---------------------------------------------------------------------------
# phase 6: the continuous-batching engine
# ---------------------------------------------------------------------------

# prompt lengths in tokens: eight requests fill the slots (three of them long
# enough for the int8 prefill kernels), four more queue behind them
ENG_PROMPTS = [300, 40, 270, 120, 20, 260, 90, 60, 30, 280, 100, 50]
ENG_GEN = 48


def engine_requests(sched, **kw):
    return [sched.Request(prompt=prompt_of(n - 2, seed=100 + i),
                          max_tokens=ENG_GEN, **kw)
            for i, n in enumerate(ENG_PROMPTS)]


def common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def all_kernels():
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import kv_write as kw
    from fastllama_tpu_torch.kernels import paged_attention as pa
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    return dict(counted_kernels(qm, da), B6=pa.paged_decode_attention,
                B7=kw.paged_kv_write, B8=kw.paged_kv_write_rows,
                B11=pa.paged_decode_attention_flat,
                PS=pa.paged_decode_step_fused)


def flash_admissions(eng, reqs) -> int:
    """Requests whose monolithic admission enters B12 (models/llama.
    _flash_viable): a prompt bucket of at least 128 rows, a multiple of
    128 (head_dim is 128 and the mode bf16 wherever this is asked)."""
    n = 0
    for r in reqs:
        bucket = next((b for b in eng._buckets if b >= r.n_prompt),
                      eng.n_ctx)
        n += bucket >= 128 and bucket % 128 == 0
    return n


def engine_run(torch, sched, make, label, n_layer, chunked, f32=False,
               lora=False, **req_kw):
    """One engine, ENG_PROMPTS through it, with every launch counted (a
    paged engine steps through the fused step, or with q/k/v LoRA terms
    (lora) through B7 + B6). Returns (token streams, result row)."""
    kernels = all_kernels()
    eng = make()
    reqs = engine_requests(sched, **req_kw)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in kernels.items()}
    require(counts["B11"] == 0, f"engine {label}: B11 launched")
    # B12 once a layer in each monolithic bf16 admission whose bucket
    # passes the gate; never in chunked admission or f32 mode
    want = 0 if chunked or f32 else n_layer * flash_admissions(eng, reqs)
    require(counts["B12"] == want, f"engine {label}: B12 launched "
            f"{counts['B12']} times, not {want}")
    streams = [list(r.tokens_out) for r in reqs]
    require(all(r.done for r in reqs), f"engine {label}: a request is not done")
    require(all(len(t) == ENG_GEN for t in streams),
            f"engine {label}: token counts {[len(t) for t in streams]}")
    require(all(r.n_prompt == n for r, n in zip(reqs, ENG_PROMPTS)),
            f"engine {label}: prompt lengths {[r.n_prompt for r in reqs]}")
    if eng.pager is not None:
        require(eng.pager.free_pages == eng.pager.total_pages,
                f"engine {label}: {eng.pager.free_pages} pages free of "
                f"{eng.pager.total_pages} after the run")
        step = "B6" if lora else "PS"
        standalone = counts["B6"] == counts["B7"] > 0 and counts["PS"] == 0
        fused = counts["PS"] > 0 and counts["B6"] == counts["B7"] == 0
        require((standalone if lora else fused)
                and counts[step] % n_layer == 0
                and counts["B4"] == 0 and counts["B10"] == 0,
                f"engine {label}: decode launches {counts}")
        require(counts["B8"] == (n_layer * len(reqs) if chunked else 0),
                f"engine {label}: B8 launched {counts['B8']} times")
        steps = counts[step] // n_layer
    else:
        # the slab step runs the fused B4 in bf16 mode and plain attention
        # in f32 mode (no attention kernel to count the steps by)
        require((counts["B4"] == 0 if f32 else
                 counts["B4"] > 0 and counts["B4"] % n_layer == 0)
                and counts["B1"] > 0
                and counts["B6"] == counts["B7"] == counts["B8"] == 0
                and counts["PS"] == 0,
                f"engine {label}: decode launches {counts}")
        steps = None if f32 else counts["B4"] // n_layer
    n_tok = sum(len(t) for t in streams)
    row = dict(label=label, wall_s=wall, tokens=n_tok, decode_steps=steps,
               tok_s_with_admissions=n_tok / wall, launches=counts)
    print(f"engine {label}: {json.dumps(row)}", flush=True)
    return streams, row


def engine_steady(torch, sched, make, profile_steps=8, timed_steps=30):
    """Eight slots decoding at once, no admission in the window: the host
    clock per engine step (ending in a synchronize) and, from a
    torch.profiler trace of a few more steps, the device time per step."""
    from torch.profiler import ProfilerActivity, profile
    eng = make()
    reqs = [sched.Request(prompt=prompt_of(98, seed=200 + i), max_tokens=300,
                          temp=0.8) for i in range(ENG_SLOTS)]
    for r in reqs:
        eng.submit(r)
    while sum(s.live for s in eng.slots) < ENG_SLOTS:
        eng.step()
    for _ in range(10):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        eng.step()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / timed_steps * 1e3
    out = dict(ms_per_step=ms_step, tok_s=ENG_SLOTS / ms_step * 1e3)
    if profile_steps:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(profile_steps):
                eng.step()
            torch.cuda.synchronize()
        dev_ms, launches, top = device_time_by_kernel(prof, profile_steps)
        if dev_ms > 0:
            out.update(
                device_ms_per_step=dev_ms,
                device_idle_share=1.0 - dev_ms / ms_step,
                launches_per_step=launches,
                kernels=[{"name": k, "ms_per_step": ms, "calls_per_step": n}
                         for k, ms, n in top])
    require(all(s.live for s in eng.slots),
            "steady engine: a slot stopped inside the measured window")
    return out


def engine_ttft(torch, sched, make, repeats=3):
    """Host clock from run() of one 300-token request in an idle engine to
    its first streamed text (ms, one value per repeat after a warm-up): the
    admission, the first token sampled on the device, and the engine steps
    until the drain hands it to the host."""
    eng = make()
    out = []
    for i in range(repeats + 1):
        stamps = []
        req = sched.Request(
            prompt=prompt_of(ENG_PROMPTS[0] - 2, seed=300 + i), max_tokens=2,
            temp=0.0, streaming_fn=lambda s, st=stamps: st.append(
                time.perf_counter()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run([req])
        require(bool(stamps), "engine TTFT: nothing was streamed")
        out.append((stamps[0] - t0) * 1e3)
    return out[1:]


def engine_path(torch, dev, gen):
    import dataclasses
    from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
    from fastllama_tpu_torch.engine import scheduler as sched

    hp = PRESETS["7B"]
    vocab = synthetic_vocab(hp.n_vocab)
    params = rand_params(torch, hp, gen, dev)
    res = {"n_layer": hp.n_layer, "n_slots": ENG_SLOTS, "n_ctx": ENG_CTX,
           "page_size": ENG_PS, "prompts": ENG_PROMPTS, "gen": ENG_GEN}

    def maker(params, hp, mode, chunked=False, depth=None, seed=3,
              mode_dtype="bfloat16", profile_dir=""):
        rcfg = RuntimeConfig(n_ctx=ENG_CTX, n_batch=256 if chunked else 512,
                             kv_dtype=mode_dtype, weight_dtype=mode_dtype,
                             profile_dir=profile_dir)
        return lambda: sched.BatchEngine(
            hp, params, vocab, n_slots=ENG_SLOTS, n_ctx=ENG_CTX, rcfg=rcfg,
            sampling_seed=seed, kv_mode=mode, page_size=ENG_PS,
            drain_depth=depth, chunked_admission=chunked)

    modes = {"paged": maker(params, hp, "paged"),
             "paged_chunked": maker(params, hp, "paged", chunked=True),
             "slab": maker(params, hp, "slab")}
    engine_run(torch, sched, modes["slab"], "warm-up", hp.n_layer, False)
    sampled, greedy, rows = {}, {}, {}
    for name, make in modes.items():
        chunked = name == "paged_chunked"
        sampled[name], rows[name] = engine_run(
            torch, sched, make, name + " temp 0.8", hp.n_layer, chunked)
        again, _ = engine_run(torch, sched, make, name + " temp 0.8 again",
                              hp.n_layer, chunked)
        require(again == sampled[name],
                f"engine {name}: the same seed gave other sampled streams")
        greedy[name], rows[name + "_greedy"] = engine_run(
            torch, sched, make, name + " greedy", hp.n_layer, chunked,
            temp=0.0)
    res["runs"] = rows

    # greedy streams across the modes. In bf16 the three modes round at
    # different places (the fused slab kernel folds the new token in
    # unrounded and the paged prefill attends the unrounded block below
    # B12's gate, while the paged step and the chunked row cache read rows
    # rounded to bf16), so a
    # near-tie of two logits can flip and the streams part from there on:
    # the first token must agree for most requests, and the common prefixes
    # are reported. The f32 engines below must agree token for token.
    pairs = {}
    for a, b in (("paged", "paged_chunked"), ("paged", "slab"),
                 ("paged_chunked", "slab")):
        pre = [common_prefix(x, y) for x, y in zip(greedy[a], greedy[b])]
        pairs[f"{a} vs {b}"] = pre
        require(sum(p >= 1 for p in pre) >= len(pre) // 2,
                f"engine greedy {a} vs {b}: first tokens differ, prefixes "
                f"{pre}")
    res["greedy_common_prefix_bf16"] = pairs

    # one request against the single-stream session on the same prompt: the
    # prefill is the same launch sequence (the same first token); the decode
    # steps run B1 at M = 1 against M = 8
    model, sess = make_session(hp, params, dev)
    out = []
    require(sess.ingest(prompt_of(ENG_PROMPTS[0] - 2, seed=100)),
            "session ingest failed")
    require(sess.generate(out.append, num_tokens=ENG_GEN, temp=0.0),
            "session generate failed")
    single = list(sess._last_n)[-ENG_GEN:]
    pre = common_prefix(single, greedy["slab"][0])
    require(pre >= 1, "engine slab greedy: the first token differs from the "
            f"single-stream session's ({single[:4]} / {greedy['slab'][0][:4]})")
    res["greedy_prefix_vs_single_stream"] = pre
    del sess, model

    # steady decode: ms per step, device time, drain depth 0 against 2
    steady = {}
    for name in ("paged", "slab"):
        steady[name] = engine_steady(torch, sched, modes[name])
        print(f"engine steady {name}: {json.dumps(steady[name])}", flush=True)
    ttft = {name: engine_ttft(torch, sched, make)
            for name, make in modes.items()}
    print(f"engine TTFT ms (300-token prompt, idle engine): "
          f"{json.dumps(ttft)}", flush=True)
    drain = []
    for depth in (0, 2, 2, 0):
        r = engine_steady(torch, sched,
                          maker(params, hp, "paged", depth=depth),
                          profile_steps=0, timed_steps=60)
        drain.append(dict(drain_depth=depth, **r))
    print(f"engine drain depth: {json.dumps(drain)}", flush=True)
    traced = trace_engine(torch, sched, lambda d: maker(
        params, hp, "paged", profile_dir=d)())
    res.update(steady=steady, drain_depth=drain, ttft_ms=ttft,
               traced_engine_run=traced,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, modes
    torch.cuda.empty_cache()

    # f32 mode at full width, two layers: nothing is rounded to bf16, so the
    # three modes must give the same greedy streams (f32 sum order can still
    # flip an exact near-tie: at most two of the twelve requests may differ)
    hp2 = dataclasses.replace(hp, n_layer=2)
    params2 = rand_params(torch, hp2, gen, dev)
    f32, f32_b12 = {}, {}
    for name, kw in (("paged", {}), ("paged_chunked", {"chunked": True}),
                     ("slab", {})):
        mode = "slab" if name == "slab" else "paged"
        f32[name], row = engine_run(
            torch, sched, maker(params2, hp2, mode, mode_dtype="float32",
                                **kw),
            name + " f32 2 layers greedy", hp2.n_layer, bool(kw), f32=True,
            temp=0.0)
        f32_b12[name] = row["launches"]["B12"]
    res["f32_b12_launches"] = f32_b12
    same = {}
    for a, b in (("paged", "paged_chunked"), ("paged", "slab")):
        n_same = sum(x == y for x, y in zip(f32[a], f32[b]))
        same[f"{a} vs {b}"] = n_same
        require(n_same >= len(ENG_PROMPTS) - 2,
                f"engine f32 {a} vs {b}: only {n_same} of "
                f"{len(ENG_PROMPTS)} greedy streams are equal")
    res["f32_equal_streams_of_12"] = same

    # the paged step of a layer with q/k/v LoRA terms (rank 8 on wq and wv
    # of both layers): RoPE, B7 and B6 apart, the caller of the standalone
    # kernels; bf16, greedy
    from fastllama_tpu_torch.models.llama import LoraTerm
    rank = 8
    for layer in params2.layers:
        for field in ("lora_wq", "lora_wv"):
            setattr(layer, field, LoraTerm(
                a=torch.randn((hp.n_embd, rank), generator=gen, device=dev)
                * 0.02,
                b=torch.randn((rank, hp.n_embd), generator=gen, device=dev)
                * 0.02))
    _, res["runs"]["paged_lora_2_layers"] = engine_run(
        torch, sched, maker(params2, hp2, "paged"),
        "paged LoRA 2 layers greedy", hp2.n_layer, False, lora=True,
        temp=0.0)
    print(f"engine path: {json.dumps({k: v for k, v in res.items() if k != 'runs'})}",
          flush=True)
    del params2
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 2, continued: the planes a rank holds under tensor parallelism
# ---------------------------------------------------------------------------

# the tensor-parallel degrees whose rank-local 7B planes phase 2 holds
SHARD_TPS = (2, 4)
SHARD_HEADS = tuple(32 // tp for tp in SHARD_TPS)     # 7B's 32 heads split


def clone_weight(w):
    from fastllama_tpu_torch.quant.tensor import QuantMatmulWeight
    return QuantMatmulWeight(
        qs=w.qs.clone(), scales=w.scales.clone(),
        mins=None if w.mins is None else w.mins.clone(),
        n_logical=w.n_logical)


def shard_planes(torch, dev, gen, tp, affine=False):
    """(name, weight) of the 7B planes model-axis rank tp - 1 holds, cut by
    the port's shard_params from one random 7B layer and head (q4_1 where
    affine): K padding stripped before the split (wo, w2), fused columns
    re-laid and N re-padded per shard (qkv, w13, head)."""
    from fastllama_tpu_torch.config import PRESETS
    from fastllama_tpu_torch.models.llama import LayerParams, LlamaParams
    from fastllama_tpu_torch.parallel.sharding import shard_params
    from fastllama_tpu_torch.quant.tensor import QuantEmbedding
    hp = PRESETS["7B"]
    d, f, v = hp.n_embd, hp.n_ff, hp.n_vocab
    layer = LayerParams(
        attention_norm=torch.ones(d, device=dev),
        wqkv=rand_weight(torch, d, 3 * d, gen, dev, affine),
        wo=rand_weight(torch, d, d, gen, dev, affine),
        ffn_norm=torch.ones(d, device=dev),
        w13=rand_weight(torch, d, 2 * f, gen, dev, affine),
        w2=rand_weight(torch, f, d, gen, dev, affine))
    emb = QuantEmbedding(
        qs=torch.zeros((v, d // 2), dtype=torch.uint8, device=dev),
        scales=torch.zeros((v, d // 32), device=dev))
    p = shard_params(LlamaParams(tok_embeddings=emb,
                                 norm=torch.ones(d, device=dev),
                                 output=rand_weight(torch, d, v, gen, dev,
                                                    affine),
                                 layers=[layer]), tp - 1, tp)
    lay = p.layers[0]
    return [("qkv", lay.wqkv), ("wo", lay.wo), ("w13", lay.w13),
            ("w2", lay.w2), ("head", p.output)]


# each kernel's rows on a rank's planes: B1 (decode, the engine's step), B3
# (with B2; the 512 bucket, the chunked admission) and B5 (bf16-exact
# prefill) on q4_0; B9 (decode, the engine's step) on q4_1
SHARD_CASES = {False: (("B1", 1), ("B1", 8), ("B3", 512), ("B3", 256),
                       ("B5", 128), ("B5", 512)),
               True: (("B9", 1), ("B9", 8))}


def check_shard_planes(torch, dev, gen, results):
    """B1 (M = 1, 8; bf16), B3 (M = 512, 256; bit for bit, with B2) and B5
    (M = 128, 512; bf16) on the q4_0 planes a rank holds at tp = 2 and 4,
    and B9 (M = 1, 8; bf16) on the q4_1 planes, against their plain
    versions as on the whole planes; each timed over cycled copies of the
    plane, the plain version and the bound beside it."""
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    bf16 = torch.bfloat16
    rows = results.setdefault("shard_local", [])
    for tp in SHARD_TPS:
        for affine, cases in SHARD_CASES.items():
            quant = "q4_1" if affine else "q4_0"
            for name, w in shard_planes(torch, dev, gen, tp, affine):
                k, n, n_st = w.k, w.n_logical, w.qs.shape[1]
                wbytes = weight_bytes(w)
                ws = [w] + [clone_weight(w)
                            for _ in range(copies_for(wbytes) - 1)]
                wd = qm.dequant_matmul_weight(w, bf16)
                for key, m in cases:
                    label = f"{key} tp={tp} {name} M={m} K={k} N={n} " \
                            f"(stored {n_st}) {quant}"
                    x = torch.randn((m, k), generator=gen, device=dev)
                    it = iter(range(10**9))
                    if key == "B3":
                        x = x * 3.0
                        xq, dx = qm.quant_rows_int8(x, w.k)
                        xq_ref, dx_ref = qm.quant_rows_int8_plain(x, w.k)
                        require(torch.equal(xq, xq_ref)
                                and torch.equal(dx, dx_ref),
                                f"B2 {label}: not bit-exact")
                        y = qm.q4_matmul_prefill_int8(xq, dx, w)
                        y_ref = qm.q4_matmul_prefill_int8_plain(xq, dx, w)
                        err, tol = (y - y_ref).abs().max().item(), 0.0
                        require(torch.equal(y, y_ref), f"{label}: not "
                                f"bit-exact (max err {err})")

                        def run():
                            return qm.q4_matmul_prefill_int8(
                                xq, dx, ws[next(it) % len(ws)])

                        def plain():
                            return qm.q4_matmul_prefill_int8_plain(xq, dx, w)

                        def again():
                            return qm.q4_matmul_prefill_int8(xq, dx, w)
                        nbytes, kind = (m * w.k + m * 4 + wbytes + m * n * 4,
                                        "int8")
                    else:
                        fn, pfn = {
                            "B1": (qm.q4_matmul_decode, qm.q4_matmul_dequant),
                            "B5": (qm.q4_matmul_prefill, qm.q4_matmul_dequant),
                            "B9": (qm.q41_matmul_decode,
                                   qm.q41_matmul_decode_plain)}[key]
                        y = fn(x, w, bf16)
                        y_ref = pfn(x, w, bf16)
                        err = (y - y_ref).abs().max().item()
                        tol = (b9_tol(torch, qm, x, w, bf16) if affine else
                               1e-5 * absum_of(torch, qm, x, wd, n, bf16))
                        require(bool(torch.isfinite(y).all()) and err <= tol,
                                f"{label}: err {err} > {tol}")

                        def run(fn=fn):
                            return fn(x, ws[next(it) % len(ws)], bf16)

                        def plain(pfn=pfn):
                            return pfn(x, w, bf16)

                        def again(fn=fn):
                            return fn(x, w, bf16)
                        nbytes, kind = (wbytes + x.numel() * 4 + m * n * 4,
                                        "bf16")
                    require(torch.equal(y, again()),
                            f"{label}: not deterministic")
                    ms = time_ms(torch, run, calls=2 * len(ws))
                    plain_ms = (time_ms(torch, plain, calls=2)
                                if m in (1, 512) else None)
                    bnd, by = bound_ms(nbytes, 2.0 * m * k * n, kind)
                    row = dict(kernel=key, m=m, shape=label, max_abs_err=err,
                               tol=tol, ms=ms, plain_ms=plain_ms,
                               bound_ms=bnd, bound_by=by,
                               bound_share=bnd / ms)
                    rows.append(row)
                    print(f"shard-local {row}", flush=True)
                del ws, w, wd


def check_shard_attention(torch, dev, gen, results):
    """B4 and B10 at the heads a rank holds at tp = 2 and 4 (16 and 8): at
    B = 1 (the TP session) at the depths where the 64-row chunks begin and
    end, the last row and past S (an inactive slot), and at B = 8 (the slab
    engine's step) with per-slot depths, one of them past S; bf16 and f32
    caches. Held against their plain versions at the whole-width rows'
    tolerances (B4: output within 2^-7 (bf16) or 5e-5 (f32) of the largest
    output, caches bit for bit, the same result twice; B10: within 5e-5);
    timed on bf16 caches at 1 x 300 and 8 x 300 over cycled caches."""
    from fastllama_tpu_torch.kernels import decode_attention as da
    rows = results.setdefault("shard_local", [])
    s_len, d = ENG_CTX, 128
    scale = 1 / math.sqrt(d)
    kw4 = dict(head_dim=d, n_rot=d, scale=scale)
    depth_sets = {1: [[n] for n in (0, 1, 63, 64, 65, 300, 511,
                                    s_len + 88)],
                  ENG_SLOTS: [[0, 1, 63, 64, 300, 511, s_len + 1, 200],
                              [300] * ENG_SLOTS]}
    for tp in SHARD_TPS:
        h = 32 // tp
        f = h * d
        for b, sets in depth_sets.items():
            for dt in (torch.bfloat16, torch.float32):
                kind = "bf16" if dt == torch.bfloat16 else "f32"
                kc, vc = (torch.randn((b, s_len, f), generator=gen,
                                      device=dev).to(dt) for _ in range(2))
                for depths in sets:
                    label = f"tp={tp} B={b} S={s_len} H={h} d={d} " \
                            f"depths={depths} {kind} caches"
                    npv = torch.tensor(depths, dtype=torch.int32, device=dev)
                    cos, sin = da.rope_lane_tables(
                        npv.clamp_max(s_len - 1), d, d)
                    qkv = torch.randn((b, 1, 3 * f), generator=gen,
                                      device=dev)
                    runs = []
                    for _ in range(2):
                        k1, v1 = kc.clone(), vc.clone()
                        runs.append((da.decode_attention_fused(
                            qkv, k1, v1, npv, cos, sin, **kw4), k1, v1))
                    k2, v2 = kc.clone(), vc.clone()
                    ref = da.decode_attention_fused_plain(
                        qkv, k2, v2, npv, cos, sin, **kw4)
                    ctx, k1, v1 = runs[0]
                    err = (ctx - ref).abs().max().item()
                    tol = ((2 ** -7 if kind == "bf16" else 5e-5)
                           * ref.abs().max().item() + 1e-6)
                    require(bool(torch.isfinite(ctx).all()),
                            f"B4 {label}: not finite")
                    require(err <= tol, f"B4 {label}: err {err} > {tol}")
                    require(torch.equal(k1, k2) and torch.equal(v1, v2),
                            f"B4 {label}: caches differ")
                    require(all(torch.equal(x, y)
                                for x, y in zip(runs[0], runs[1])),
                            f"B4 {label}: not deterministic")
                    del runs, k1, v1, k2, v2
                    b4 = dict(kernel="B4", shape="B4 " + label,
                              max_abs_err=err, tol=tol)
                    q = torch.randn((b, 1, f), generator=gen, device=dev)
                    ctx = da.decode_attention(q, kc, vc, npv, head_dim=d,
                                              scale=scale)
                    ref = da.decode_attention_plain(q, kc, vc, npv,
                                                    head_dim=d, scale=scale)
                    err = (ctx - ref).abs().max().item()
                    tol = 5e-5 * ref.abs().max().item() + 1e-6
                    require(bool(torch.isfinite(ctx).all()),
                            f"B10 {label}: not finite")
                    require(err <= tol, f"B10 {label}: err {err} > {tol}")
                    require(torch.equal(ctx, da.decode_attention(
                        q, kc, vc, npv, head_dim=d, scale=scale)),
                        f"B10 {label}: not deterministic")
                    b10 = dict(kernel="B10", shape="B10 " + label,
                               max_abs_err=err, tol=tol)
                    if kind == "bf16" and depths[0] == 300 \
                            and len(set(depths)) == 1:
                        b4.update(_time_attention(
                            torch, dev, gen, da, b, s_len, h, d, qkv, q, npv,
                            cos, sin, kc, vc, kw4))
                        b10.update(b4.pop("b10"))
                    for row in (b4, b10):
                        rows.append(row)
                        print(f"shard-local {row}", flush=True)
                del kc, vc


def _time_attention(torch, dev, gen, da, b, s_len, h, d, qkv, q, npv, cos,
                    sin, kc, vc, kw4):
    """B4's and B10's times (ms, plain ms, bound) over bf16 caches cycled
    through more than the L2, at the depths npv; B10's under "b10"."""
    f = h * d
    n = copies_for(2 * kc.numel() * kc.element_size())
    caches = [(kc, vc)] + [tuple(torch.randn(kc.shape, generator=gen,
                                             device=dev).to(kc.dtype)
                                 for _ in range(2)) for _ in range(n - 1)]
    it = iter(range(10**9))

    def run4():
        kk, vv = caches[next(it) % n]
        da.decode_attention_fused(qkv, kk, vv, npv, cos, sin, **kw4)

    def run10():
        kk, vv = caches[next(it) % n]
        da.decode_attention(q, kk, vv, npv, head_dim=d, scale=kw4["scale"])
    depths = npv.tolist()
    r4 = sum(min(x, s_len) for x in depths)
    r10 = sum(min(x + 1, s_len) for x in depths)
    bnd4, by4 = bound_ms(b * 3 * f * 4 + 2 * r4 * f * 2 + 2 * b * f * 2
                         + 2 * b * d * 4 + b * 4 + b * f * 4, 4.0 * r4 * f,
                         "bf16")
    bnd10, by10 = bound_ms(2 * b * f * 4 + 2 * r10 * f * 2 + b * 4,
                           4.0 * r10 * f, "bf16")
    out = dict(ms=time_ms(torch, run4, calls=4 * n),
               plain_ms=time_ms(torch, lambda: da.decode_attention_fused_plain(
                   qkv, kc.clone(), vc.clone(), npv, cos, sin, **kw4),
                   calls=2),
               bound_ms=bnd4, bound_by=by4,
               b10=dict(ms=time_ms(torch, run10, calls=4 * n),
                        plain_ms=time_ms(torch, lambda: da
                                         .decode_attention_plain(
                                             q, kc, vc, npv, head_dim=d,
                                             scale=kw4["scale"]), calls=2),
                        bound_ms=bnd10, bound_by=by10))
    out["bound_share"] = bnd4 / out["ms"]
    out["b10"]["bound_share"] = bnd10 / out["b10"]["ms"]
    del caches
    return out


# ---------------------------------------------------------------------------
# phase 10: multi-GPU serving (parallel/), ranks sharing the card
# ---------------------------------------------------------------------------

# phase 5's bf16 tolerances, card against CPU (q4_0, q4_1)
PAR_TOL, PAR_TOL_Q41 = 1e-2, 3e-2
SP_CTX, SP_PROMPT, SP_DECODE = 2048, 1024, 32
SHARED = "ranks sharing one H100 (time-sliced; not a TP speed)"
# bf16 mesh engines: streams of the twelve that may leave the one-card
# engine's greedy stream after their first token
ENG_BF16_SLACK = 2
# the run of the (1, 2) world whose launches a kernel's line reports
TP_PART = {"B1": "int8", "B2": "int8", "B3": "int8", "B4": "int8",
           "B5": "bf16_exact", "B9": "lora", "B10": "lora",
           "PS": "engine_paged", "B12": "int8"}


def _rank_main(rank, n, port, fn, args, q):
    """One rank of a spawned world: gloo over localhost, every rank on the
    card (cuda:0 here: the world shares it)."""
    import traceback
    import torch
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=n)
        q.put((rank, fn(torch, *args), None))
    except BaseException:                           # reported to the parent
        q.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(shape, fn, *args, timeout=400.0):
    """fn(torch, *args) on dp * tp spawned ranks; their results in rank
    order. Every process started here is stopped before it returns."""
    import queue
    import socket
    import torch.multiprocessing as mp
    n = shape[0] * shape[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, fn, args, q))
             for r in range(n)]
    for p in procs:
        p.start()
    out, err, got = [None] * n, None, 0
    deadline = time.monotonic() + timeout
    try:
        while got < n and err is None:
            try:
                rank, res, tb = q.get(timeout=2.0)
            except queue.Empty:
                lost = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if lost:
                    err = f"world {shape}: ranks ended without a result " \
                          f"(rank, exit code) {lost}"
                elif time.monotonic() > deadline:
                    err = f"world {shape}: no result within {timeout} s"
                continue
            if tb:
                err = f"world {shape} rank {rank}:\n{tb}"
            out[rank] = res
            got += 1
    finally:
        for p in procs:
            p.join(timeout=10 if err is None else 1)
            if p.is_alive():
                p.kill()
                p.join()
    require(err is None, str(err))
    return out


def _counts_and_staged():
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.parallel import collectives
    return dict(launches={k: fn.launches for k, fn in all_kernels().items()},
                dequant_cuda_calls=qm.q4_matmul_dequant.cuda_calls,
                staged_bytes=dict(collectives.STAGED["bytes"]),
                staged_calls=dict(collectives.STAGED["calls"]))


def _reset_counts():
    from fastllama_tpu_torch.parallel import collectives
    for fn in all_kernels().values():
        fn.launches = 0
    collectives.reset_staged()


def _session_run(torch, sess, prompt, n_decode):
    """Reset, ingest, the first token (its logits), n_decode - 1 more;
    returns (first logits, stream, ms per decoded token)."""
    sess.reset()
    require(sess.ingest(prompt), "ingest failed")
    require(sess.generate(lambda s: None, num_tokens=1, temp=0.0),
            "generate failed")
    first = sess.get_logits().copy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    require(sess.generate(lambda s: None, num_tokens=n_decode - 1, temp=0.0),
            "generate failed")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (n_decode - 1)
    require(np.isfinite(first).all(), "logits not finite")
    return first, list(sess._last_n)[-n_decode:], ms


def _engine_streams(torch, hp, params, vocab, rcfg, mode):
    """ENG_PROMPTS through a greedy BatchEngine of 8 slots (n_ctx 512, pages
    of 64 rows): streams, free pages by dp group, launches, ms a token."""
    from fastllama_tpu_torch.engine import scheduler as sched
    eng = sched.BatchEngine(hp, params, vocab, n_slots=ENG_SLOTS,
                            n_ctx=ENG_CTX, rcfg=rcfg, kv_mode=mode,
                            page_size=ENG_PS, temp=0.0)
    reqs = engine_requests(sched)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [list(r.tokens_out) for r in reqs]
    require(all(r.done and len(t) == ENG_GEN for r, t in zip(reqs, streams)),
            f"engine {mode} {rcfg.mesh_shape}: a request did not finish")
    res = dict(streams=streams, ms_per_token=wall * 1e3 / sum(map(len, streams)),
               flash_admissions=flash_admissions(eng, reqs),
               **_counts_and_staged())
    if eng.pager is not None:
        res["free_pages_by_group"] = eng.pager.free_pages_by_group
        require(eng.pager.free_pages == eng.pager.total_pages,
                f"engine {mode} {rcfg.mesh_shape}: pages not freed "
                f"{eng.pager.free_pages_by_group} of {eng.pager.total_pages}")
        require(res["launches"]["PS"] > 0, f"engine paged {rcfg.mesh_shape}:"
                " the fused paged step did not launch")
    del eng
    torch.cuda.empty_cache()
    return res


def tp_world(torch, q40, q41, adapter, state):
    """World (1, 2): the TP session on the 8-layer q4_0 file (int8 prefill,
    then the bf16-exact prefill; 64 greedy tokens; save), TP + LoRA on the
    2-layer q4_1 file (attach, detach bit for bit), and the engine, paged
    and slab."""
    import fastllama_tpu_torch
    from fastllama_tpu_torch.config import RuntimeConfig
    from fastllama_tpu_torch.engine.session import FastLlama
    from fastllama_tpu_torch.models.runtime import LlamaModel
    res = {}
    model = fastllama_tpu_torch.Model(path=q40, n_ctx=512, n_batch=512,
                                      mesh_shape=(1, 2),
                                      logger=fastllama_tpu_torch.Logger())
    lm = model._model
    res["n_layer"] = lm.hp.n_layer
    prompt = prompt_of(N_PROMPT - 2, seed=4)
    warm_up(model.session, prompt)
    _reset_counts()
    first, stream, ms = _session_run(torch, model.session, prompt, N_DECODE)
    res["int8"] = dict(first=first, stream=stream, ms_per_token=ms,
                       device=str(lm.device), **_counts_and_staged())
    require(model.save_state(state), "save_state failed")
    require(model.generate(num_tokens=1, temp=0.0), "generate failed")
    res["next_after_save"] = model.get_logits().copy()

    exact = LlamaModel(lm.hp, lm.params, lm.vocab, RuntimeConfig(
        n_ctx=512, n_batch=512, prefill_int8=False, mesh_shape=(1, 2)))
    _reset_counts()
    first, stream, _ = _session_run(torch, FastLlama(exact, n_keep=64),
                                    prompt, 2)
    res["bf16_exact"] = dict(first=first, **_counts_and_staged())
    del exact
    res["engine"] = {mode: _engine_streams(
        torch, lm.hp, lm.params, lm.vocab,
        RuntimeConfig(n_ctx=ENG_CTX, n_batch=512, mesh_shape=(1, 2)), mode)
        for mode in ("paged", "slab")}
    del model, lm
    torch.cuda.empty_cache()

    q = fastllama_tpu_torch.Model(path=q41, n_ctx=512, n_batch=64,
                                  mesh_shape=(1, 2),
                                  logger=fastllama_tpu_torch.Logger())
    probe = [1] + list(range(300, 320))
    before = q._model.eval(0, probe)
    require(q.attach_lora(adapter), "attach_lora failed")
    _reset_counts()
    attached = q._model.eval(0, probe)
    q._model.eval(len(probe), [probe[-1]])
    res["lora"] = dict(attached=attached, **_counts_and_staged())
    require(q.detach_lora(), "detach_lora failed")
    res["lora"]["detach_equal"] = bool(np.array_equal(
        q._model.eval(0, probe), before))
    return res


def sp_world(torch, q40):
    """World (2, 1): the SP session (seq_parallel, n_ctx 2048, a 1024-token
    prompt in n_batch 512 chunks, 32 greedy tokens) and the engine with dp
    2, paged and slab."""
    import fastllama_tpu_torch
    from fastllama_tpu_torch.config import RuntimeConfig
    model = fastllama_tpu_torch.Model(path=q40, n_ctx=SP_CTX, n_batch=512,
                                      mesh_shape=(2, 1), seq_parallel=True,
                                      logger=fastllama_tpu_torch.Logger())
    lm = model._model
    _reset_counts()
    first, stream, ms = _session_run(
        torch, model.session, prompt_of(SP_PROMPT - 2, seed=9), SP_DECODE)
    res = {"sp": dict(first=first, stream=stream, ms_per_token=ms,
                      **_counts_and_staged()), "n_layer": lm.hp.n_layer}
    res["engine"] = {mode: _engine_streams(
        torch, lm.hp, lm.params, lm.vocab,
        RuntimeConfig(n_ctx=ENG_CTX, n_batch=512, mesh_shape=(2, 1)), mode)
        for mode in ("paged", "slab")}
    return res


def f32_world(torch, q41):
    """World (2, 2): the engine on the 2-layer q4_1 file in f32, paged and
    slab. Each rank loads the file on the host; the engine copies the
    rank's shard to its card."""
    import dataclasses
    from fastllama_tpu_torch.config import RuntimeConfig
    from fastllama_tpu_torch.models.loader import load_model
    rcfg = RuntimeConfig(n_ctx=ENG_CTX, n_batch=512, kv_dtype="float32",
                         weight_dtype="float32")
    lm = load_model(q41, rcfg, device="cpu")
    rcfg = dataclasses.replace(rcfg, mesh_shape=(2, 2))
    return {mode: _engine_streams(torch, lm.hp, lm.params, lm.vocab, rcfg,
                                  mode) for mode in ("paged", "slab")}


def rel_err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def parallel_path(torch, tmp, q40, q41):
    """Phase 10: the port's multi-GPU serving in spawned worlds of ranks
    that share the card (gloo; NCCL refuses two ranks on one device), each
    held against the one-card run of the same file. Budget about 150 s."""
    import fastllama_tpu_torch
    from fastllama_tpu_torch.config import RuntimeConfig
    from fastllama_tpu_torch.engine.session import FastLlama
    from fastllama_tpu_torch.io.ggml_writer import write_ggla
    from fastllama_tpu_torch.models.loader import load_model
    from fastllama_tpu_torch.models.runtime import LlamaModel
    res = {"backend": "gloo", "note": SHARED}
    print(f"parallel: backend gloo, worlds (data, model) (1, 2), (2, 1), "
          f"(2, 2); every rank on cuda:0 ({SHARED})", flush=True)

    # one-card references on the same files
    quiet = fastllama_tpu_torch.Logger()
    one = fastllama_tpu_torch.Model(path=q40, n_ctx=512, n_batch=512,
                                    logger=quiet)
    prompt = prompt_of(N_PROMPT - 2, seed=4)
    ref_first, ref_stream, ref_ms = _session_run(torch, one.session, prompt,
                                                 N_DECODE)
    lm = one._model
    exact = LlamaModel(lm.hp, lm.params, lm.vocab, RuntimeConfig(
        n_ctx=512, n_batch=512, prefill_int8=False))
    ref_exact, _, _ = _session_run(torch, FastLlama(exact, n_keep=64),
                                   prompt, 2)
    del exact
    ref_engine = {mode: _engine_streams(
        torch, lm.hp, lm.params, lm.vocab,
        RuntimeConfig(n_ctx=ENG_CTX, n_batch=512), mode)
        for mode in ("paged", "slab")}
    long_ctx = LlamaModel(lm.hp, lm.params, lm.vocab,
                          RuntimeConfig(n_ctx=SP_CTX, n_batch=512))
    ref_sp, ref_sp_stream, ref_sp_ms = _session_run(
        torch, FastLlama(long_ctx, n_keep=64),
        prompt_of(SP_PROMPT - 2, seed=9), SP_DECODE)
    del long_ctx
    q = fastllama_tpu_torch.Model(path=q41, n_ctx=512, n_batch=64,
                                  logger=quiet)
    rank, hp41 = 8, q._model.hp
    rng = np.random.default_rng(21)
    adapter = os.path.join(tmp, "adapter_2_layers.bin")
    write_ggla(adapter, r=rank, alpha=16, use_cache=False, tensors={
        f"layers.{i}.attention.{w}.weight.lora{ab}":
            (rng.standard_normal((hp41.n_embd, rank)) * 0.02)
            .astype(np.float32)
        for i in range(hp41.n_layer) for w in ("wq", "wv") for ab in "AB"})
    require(q.attach_lora(adapter), "one-card attach_lora failed")
    ref_attached = q._model.eval(0, [1] + list(range(300, 320)))
    del q
    f32_rcfg = RuntimeConfig(n_ctx=ENG_CTX, n_batch=512, kv_dtype="float32",
                             weight_dtype="float32")
    lm32 = load_model(q41, f32_rcfg)
    ref_f32 = {mode: _engine_streams(torch, lm32.hp, lm32.params, lm32.vocab,
                                     f32_rcfg, mode)
               for mode in ("paged", "slab")}
    del lm32
    torch.cuda.empty_cache()

    def prefixes(a, b):
        return [common_prefix(x, y) for x, y in zip(a, b)]

    def engine_check(label, got, want, equal=False):
        out = {}
        for mode in ("paged", "slab"):
            pre = prefixes(got[mode]["streams"], want[mode]["streams"])
            # bf16: every request's first token, and all streams but
            # ENG_BF16_SLACK in full (a sum order may flip a near tie late
            # in a stream); f32: every stream in full
            full = sum(p == ENG_GEN for p in pre)
            require(all(p >= 1 for p in pre) and full >= len(pre) - (
                0 if equal else ENG_BF16_SLACK),
                f"{label} {mode}: greedy streams differ from the one-card "
                f"engine's, common prefixes {pre}")
            out[mode] = dict(common_prefix=pre,
                             free_pages_by_group=got[mode].get(
                                 "free_pages_by_group"),
                             ms_per_token=got[mode]["ms_per_token"],
                             one_card_ms_per_token=want[mode]["ms_per_token"],
                             launches=got[mode]["launches"],
                             staged_bytes=got[mode]["staged_bytes"])
        return out

    # world (1, 2): TP session, TP + LoRA, engines
    t0 = time.perf_counter()
    state = os.path.join(tmp, "tp_state.npz")
    ranks = spawn_world((1, 2), tp_world, q40, q41, adapter, state)
    tp_s = time.perf_counter() - t0
    r0 = ranks[0]
    errs = dict(int8=rel_err(r0["int8"]["first"], ref_first),
                bf16_exact=rel_err(r0["bf16_exact"]["first"], ref_exact),
                lora_attached=rel_err(r0["lora"]["attached"], ref_attached))
    require(errs["int8"] <= PAR_TOL and errs["bf16_exact"] <= PAR_TOL
            and errs["lora_attached"] <= PAR_TOL_Q41,
            f"TP (1, 2) first-token logits against one card: {errs}")
    for r in ranks:
        require(np.array_equal(r["int8"]["first"], r0["int8"]["first"]),
                "TP ranks returned different logits")
        require(r["lora"]["detach_equal"],
                "TP + LoRA: detach did not restore the logits bit for bit")
        c = r["int8"]["launches"]
        require(all(c[k] > 0 for k in ("B1", "B2", "B3", "B4")),
                f"TP session launches {c}")
        # B12 at the rank's 16 heads: once a layer in each fresh window
        # and in every monolithic admission past the gate
        n_layer = r0["n_layer"]
        require(c["B12"] == n_layer
                and r["bf16_exact"]["launches"]["B12"] == n_layer
                and r["lora"]["launches"]["B12"] == 0,
                f"TP B12 launches {c['B12']}, bf16-exact "
                f"{r['bf16_exact']['launches']['B12']}, LoRA probe "
                f"{r['lora']['launches']['B12']}")
        for mode, e in r["engine"].items():
            require(e["launches"]["B12"] == n_layer * e["flash_admissions"],
                    f"TP engine {mode}: B12 launched "
                    f"{e['launches']['B12']} times")
        require(r["bf16_exact"]["launches"]["B5"] > 0
                and r["bf16_exact"]["launches"]["B3"] == 0,
                f"TP bf16-exact launches {r['bf16_exact']['launches']}")
        require(r["lora"]["launches"]["B9"] > 0
                and r["lora"]["launches"]["B10"] > 0,
                f"TP + LoRA launches {r['lora']['launches']}")
        for part in ("int8", "bf16_exact", "lora"):
            require(r[part]["dequant_cuda_calls"] == 0,
                    f"TP {part}: the dequant path ran on the card")
    # the TP world's saved session, loaded on one card
    require(one.load_state(state), "one-card load_state of the TP state")
    require(one.generate(num_tokens=1, temp=0.0), "generate after load")
    errs["saved_then_one_card"] = rel_err(one.get_logits(),
                                          r0["next_after_save"])
    require(errs["saved_then_one_card"] <= PAR_TOL,
            f"TP save -> one-card load: next logits rel err "
            f"{errs['saved_then_one_card']}")
    del one, lm
    torch.cuda.empty_cache()
    res["tp_1x2"] = dict(
        seconds=tp_s, rel_err=errs,
        greedy_common_prefix=common_prefix(r0["int8"]["stream"], ref_stream),
        ms_per_token=r0["int8"]["ms_per_token"], one_card_ms_per_token=ref_ms,
        device=[r["int8"]["device"] for r in ranks],
        launches_by_rank=[dict({p: r[p]["launches"] for p in
                                ("int8", "bf16_exact", "lora")},
                               engine_paged=r["engine"]["paged"]["launches"])
                          for r in ranks],
        staged_bytes_by_rank=[r["int8"]["staged_bytes"] for r in ranks],
        staged_calls=r0["int8"]["staged_calls"],
        engine=engine_check("engine (1, 2)", r0["engine"], ref_engine))

    # world (2, 1): SP session, engines with dp 2
    t0 = time.perf_counter()
    ranks = spawn_world((2, 1), sp_world, q40)
    sp_s = time.perf_counter() - t0
    r0 = ranks[0]
    e = rel_err(r0["sp"]["first"], ref_sp)
    require(e <= PAR_TOL, f"SP (2, 1) first-token logits rel err {e}")
    # SP windows take the ring, never B12; the dp 2 engine's admissions
    # run on their slot's rank
    for mode in ("paged", "slab"):
        got = sum(r["engine"][mode]["launches"]["B12"] for r in ranks)
        want = r0["n_layer"] * r0["engine"][mode]["flash_admissions"]
        require(got == want, f"engine (2, 1) {mode}: B12 launched {got} "
                f"times over the ranks, not {want}")
    for r in ranks:
        require(r["sp"]["launches"]["B12"] == 0,
                f"SP session: B12 launched {r['sp']['launches']['B12']}")
        require(r["sp"]["launches"]["B4"] == 0
                and r["sp"]["launches"]["B1"] > 0
                and r["sp"]["dequant_cuda_calls"] == 0,
                f"SP session launches {r['sp']['launches']}")
    res["sp_2x1"] = dict(
        seconds=sp_s, rel_err=e,
        greedy_common_prefix=common_prefix(r0["sp"]["stream"], ref_sp_stream),
        ms_per_token=r0["sp"]["ms_per_token"], one_card_ms_per_token=ref_sp_ms,
        launches_by_rank=[r["sp"]["launches"] for r in ranks],
        staged_bytes_by_rank=[r["sp"]["staged_bytes"] for r in ranks],
        engine=engine_check("engine (2, 1)", r0["engine"], ref_engine))

    # world (2, 2): f32 engines on the 2-layer q4_1 file, streams equal
    t0 = time.perf_counter()
    ranks = spawn_world((2, 2), f32_world, q41)
    res["f32_2x2"] = dict(seconds=time.perf_counter() - t0,
                          engine=engine_check("engine f32 (2, 2)", ranks[0],
                                              ref_f32, equal=True))
    for r in ranks:
        for mode in ("paged", "slab"):
            require(r[mode]["streams"] == ranks[0][mode]["streams"],
                    "engine f32 (2, 2): ranks disagree on the streams")
            require(r[mode]["dequant_cuda_calls"] == 0,
                    "engine f32 (2, 2): the dequant path ran on the card")
            require(r[mode]["launches"]["B12"] == 0,
                    "engine f32 (2, 2): B12 launched in f32 mode")
    for key in ("tp_1x2", "sp_2x1", "f32_2x2"):
        brief = {k: v for k, v in res[key].items()
                 if k not in ("launches_by_rank", "engine")}
        print(f"parallel {key}: {json.dumps(brief)}", flush=True)
        for mode, e in res[key]["engine"].items():
            print(f"parallel {key} engine {mode}: common prefixes "
                  f"{e['common_prefix']}, free pages by dp group "
                  f"{e['free_pages_by_group']}, staged bytes "
                  f"{e['staged_bytes']}", flush=True)
    for i, by_part in enumerate(res["tp_1x2"]["launches_by_rank"]):
        print(f"parallel tp_1x2 rank {i} launches: " + json.dumps(
            {part: {k: v for k, v in c.items() if v}
             for part, c in by_part.items()}), flush=True)
    for i, c in enumerate(res["sp_2x1"]["launches_by_rank"]):
        print(f"parallel sp_2x1 rank {i} launches: "
              + json.dumps({k: v for k, v in c.items() if v}), flush=True)
    print("parallel ms per token, " + SHARED + ": " + json.dumps({
        "TP session (1, 2)": res["tp_1x2"]["ms_per_token"],
        "one-card session": res["tp_1x2"]["one_card_ms_per_token"],
        "SP session (2, 1), n_ctx 2048": res["sp_2x1"]["ms_per_token"],
        "one-card session, n_ctx 2048":
            res["sp_2x1"]["one_card_ms_per_token"],
        **{f"engine {k} {m}": res[k]["engine"][m]["ms_per_token"]
           for k in ("tp_1x2", "sp_2x1") for m in ("paged", "slab")},
        **{f"engine f32 (2, 2) {m}":
           res["f32_2x2"]["engine"][m]["ms_per_token"]
           for m in ("paged", "slab")}}), flush=True)
    return res


def main() -> int:
    t_start = time.perf_counter()
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
    phase_s = {"1 build": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    checks = check_kernels(torch, dev, gen, out_dir)
    phase_s["2 kernel checks"] = time.perf_counter() - t0
    # phase 2 calls the dequant path as a plain version and a yardstick; no
    # path from here on may call it on the card
    qm.q4_matmul_dequant.cuda_calls = 0
    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[label] = time.perf_counter() - t0
        return out

    main_res = timed("3 q4_0 session (+ 9 traced)", main_path, torch, dev,
                     gen)
    tmp = tempfile.mkdtemp(prefix="fltorch_smoke_")
    try:
        q41_res = timed("4 q4_1 + LoRA", q41_lora_path, torch, dev, gen, tmp)
        file_res = timed("5 files", file_entry_points, torch, tmp)
        engine_res = timed("6 engine (+ 9 traced)", engine_path, torch, dev,
                           gen)
        conv_res = timed("7 converters", converters_path, torch, tmp,
                         file_res["fltpu"]["path"])
        c_res = timed("8 C ABI", c_abi_path, torch, tmp,
                      file_res["ggjt_q4_0"]["path"])
        par_res = timed("10 parallel", parallel_path, torch, tmp,
                        file_res["ggjt_q4_0"]["path"],
                        file_res["ggjt_q4_1"]["path"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    require(qm.q4_matmul_dequant.cuda_calls == 0,
            f"the dequant path ran {qm.q4_matmul_dequant.cuda_calls} times "
            "on the card in phases 3-10")

    def pick(rows, key):
        return next(r for r in rows if key in r["shape"])

    # each kernel's launches in the counted run of the path that drives it
    launches = dict(main_res["launches"],
                    B5=main_res["bf16_prefill"]["launches"]["B5"],
                    B9=q41_res["attached"]["launches"]["B9"],
                    B10=q41_res["attached"]["launches"]["B10"],
                    B6=engine_res["runs"]["paged_lora_2_layers"]["launches"]
                    ["B6"],
                    B7=engine_res["runs"]["paged_lora_2_layers"]["launches"]
                    ["B7"],
                    PS=engine_res["runs"]["paged"]["launches"]["PS"],
                    B8=engine_res["runs"]["paged_chunked"]["launches"]["B8"],
                    B11=checks["B11_phase2_launches"])
    main_rows = {"B1": pick(checks["B1"], "qkv M=1"),
                 "B2": pick(checks["B2"], "K=4096"),
                 "B3": pick(checks["B3"], "qkv M=512 K=4096"),
                 "B4": pick(checks["B4"], "n_past=300"),
                 "B5": pick(checks["B5"],
                            "qkv M=512 K=4096 N=12288 bf16 q4_0"),
                 "B9": pick(checks["B9"], "qkv M=1 K=4096 N=12288 bf16"),
                 "B10": pick(checks["B10"], "n_past=300"),
                 "B6": pick(checks["B6"], "bf16 lengths=8x300"),
                 "B7": pick(checks["B7"], "bf16"),
                 "B8": pick(checks["B8"], "bf16"),
                 "B11": pick(checks["B11"], "bf16 flat pools lengths=8x300"),
                 "PS": pick(checks["PS"], "H=32 bf16 d=128 ps=64 pp=8 "
                            "lengths=8x300"),
                 "B12": pick(checks["B12"], "7B H=32 d=128 T=512 bf16")}
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
        "B6": ("paged_decode_attention", "csrc/paged_attention.cu",
               "fastllama_tpu/kernels/paged_attention.py:333"),
        "B7": ("paged_kv_write", "csrc/kv_write.cu",
               "fastllama_tpu/kernels/kv_write.py:55"),
        "B8": ("paged_kv_write_rows", "csrc/kv_write.cu",
               "fastllama_tpu/kernels/kv_write.py:115"),
        "B11": ("paged_decode_attention_flat", "csrc/paged_attention.cu",
                "fastllama_tpu/kernels/paged_attention.py:283"),
        # B7 folded into B6's kernel with RoPE; it also replaces the B6
        # launch of that step (fastllama_tpu/kernels/paged_attention.py:333)
        "PS": ("paged_decode_step_fused", "csrc/paged_attention.cu",
               "fastllama_tpu/kernels/kv_write.py:55"),
        # the library Pallas TPU flash_attention the JAX function calls
        "B12": ("flash_prefill", "csrc/flash_prefill.cu",
                "fastllama_tpu/models/llama.py:288"),
    }
    kernels = []
    for key, (name, src, replaces) in meta.items():
        row = main_rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fastllama_tpu_torch/kernels/" + src,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(r["max_abs_err"] for r in checks[key]
                               + [s for s in checks["shard_local"]
                                  if s["kernel"] == key]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"), "shape": row["shape"]})
        if key == "B11":
            # the one exception to "launched on a path": the JAX package
            # keeps it as the record of a layout experiment and no dispatch
            # reaches it, so its launches are phase 2's
            kernels[-1]["path"] = ("none: no dispatch of the JAX package "
                                   "reaches it (CLAUDE.md:161-168); "
                                   "launches counted in phase 2")
            require(launches[key] > 0, "kernel B11 was not launched")
            continue
        if key == "PS":
            kernels[-1]["folds"] = ("fastllama_tpu/kernels/kv_write.py:55 "
                                    "(B7) + fastllama_tpu/kernels/"
                                    "paged_attention.py:333 (B6)")
        if key in ("B6", "B7"):
            kernels[-1]["path"] = ("the paged step of layers with q/k/v "
                                   "LoRA terms (phase 6, 2 layers); the "
                                   "paged engine's other steps run the "
                                   "fused step")
        local = {s["shape"]: s["ms"] for s in checks["shard_local"]
                 if s["kernel"] == key and "ms" in s
                 and s.get("m", 1) in (1, 512)}
        if local:
            # the planes and heads a rank holds at tp = 2 and 4 (phase 2);
            # the matmuls at the session's rows (decode M = 1, prefill
            # M = 512)
            kernels[-1]["shard_local_ms"] = local
        if key in TP_PART:
            # this kernel's launches on each rank of the (1, 2) world
            kernels[-1]["launches_tp_ranks"] = [
                by_rank[TP_PART[key]][key]
                for by_rank in par_res["tp_1x2"]["launches_by_rank"]]
        if key in c_res["c_launches"]:
            kernels[-1]["launches_c_program"] = c_res["c_launches"][key]
        if key == "B12":
            runs = engine_res["runs"]
            kernels[-1].update(
                replaced_ms=row["replaced_masked_ms"],
                launches_by_path={
                    "ttft_window_int8": main_res["launches"]["B12"],
                    "ttft_window_bf16_exact":
                        main_res["bf16_prefill"]["launches"]["B12"],
                    "ttft_window_q4_1_lora":
                        q41_res["attached"]["launches"]["B12"],
                    **{f"engine_{m}": runs[m]["launches"]["B12"]
                       for m in ("paged", "paged_chunked", "slab")},
                    "engine_f32_2_layers": engine_res["f32_b12_launches"]})
        if key == "B1":
            m8 = pick(checks["B1"], "qkv M=8 ")
            kernels[-1].update(ms_at_engine_m8=m8["ms"],
                               bound_ms_at_engine_m8=m8["bound_ms"])
        require(launches[key] > 0, f"kernel {key} was launched on no path")
    summary = {"card": smi, "build_s": cuda_lib.build_seconds,
               "kernel_checks": checks, "main_path": main_res,
               "q41_lora_path": q41_res, "file_entry_points": file_res,
               "engine_path": engine_res, "converters": conv_res,
               "c_abi": c_res, "parallel": par_res,
               "seconds": time.perf_counter() - t_start,
               "phase_seconds": phase_s}
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"chip_smoke: whole script {summary['seconds']:.1f} s, by phase "
          f"{json.dumps(phase_s)}", flush=True)
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
