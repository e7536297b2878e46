#!/usr/bin/env python3
"""Drive fastllama_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits nonzero before the last line):
  1. print the card (nvidia-smi name, power limit) and build the CUDA
     kernels from kernels/csrc/ (one nvcc per source, in parallel);
  2. hold each kernel (B1-B14: fourteen functions of the repo reach
     pl.pallas_call, twelve in the JAX package and two in
     tools/bench_q4_floor.py; the variant bodies B15-B19 in phase 14, B20
     and the library paged attention B21 in phase 15)
     against its plain PyTorch version on the
     card at the 7B shapes of the paths below, and time kernel, plain
     version and bound (the larger of bytes / 3.35 TB/s and operations /
     peak rate); for B4, B10 and B11 also one scaled_dot_product_attention
     call, for B1 and B9 one torch.ops.aten._weight_int4pack_mm call on the
     same codes, for B3 one torch._int_mm call (the int8 product alone),
     for B5 one torch.mm of the rounded x by the dequantized weight
     (yardsticks; the port calls none of them). B1 at M = 1, 2, 4, 8,
     16 and 64 and B9 also at 9, 17 and 40, on every plane in bf16 (variants
     0 and 9 of the fold kernel, csrc/q4_fold.cuh), f32 mode (variants 10
     and 11: x's three exact bf16 parts on the tensor cores) at M = 1, 2, 8
     and 64 on every 7B and 13B plane beside one torch.mm f32 call, with
     the bytes, FFMA and three-part tensor bounds (at M = 64 B1 and B9
     send f32 calls to B5's f32 mode), and every f32 kernel on the
     three-part case (three_part_case: an input only a kernel that uses
     all three parts of x passes, at 1/64 of what dropping the last part
     misses by), B9 also on planes padded
     to 256 columns, B1 and B9 also on
     the 13B planes at M = 1, 8 and 64 (timed, with the library call), B1
     with bf16 scales (v0h) on the 7B and 13B planes; B3 bit for bit on the 7B and
     13B planes at M = 512 and 256 (one launch of the register-A kernel,
     csrc/q4_prefill_ra.cuh; what an int8 call launches and allocates at
     qkv M = 512: no requantization pass, no int8 plane); B5 (q4_0 and q4_1, bf16 and f32
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
     its bound for bf16 and for f32 operands. B13 and B14 (the probes of
     the fold kernel's skeleton, csrc/q4_fold.cuh on B15's plan at f32
     scales, printed: the packed byte whole, or both nibbles, with no
     scales and no fold) on the 7B planes qkv, wo, w13, w2 at M = 1, 8, 64
     and the 13B planes at M = 8, within 1e-5 of sum |x| |code|, bit-equal
     twice, timed beside B15 (the same kernel and plan) and B1 on the same
     plane and M (no library call reads packed bytes as integer
     weights). At
     13B widths also B2 (timed at K = 5120 and 13824), B9 at M = 1 and 8
     on the q4_1 planes, B4 and B10 at 40 heads (n_past 0, 300, 511, past
     S; 8 x 300), the standalone B7 and B8 on 40-head pools. The slab
     row write slab_write_rows (csrc/kv_write.cu; no TPU kernel's port:
     the K/V write of every window and step replayed at a tensor offset,
     the counterpart of the JAX forward's dropping scatter) bit for bit
     against its plain version at the paths' shapes (a 512-row window's k
     view and v, 64-row chunks inside the cache and past S, a LoRA step's
     row, eight slots with two past S, f32), timed beside index_copy_; it
     is the kernels line's "RW". Afterwards
     no phase may call the dequant path on the card
     (q4_matmul_dequant.cuda_calls must read 0 after phase 10);
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
     while attached a decode step must launch B9 129 times and B4 32
     times (the q and v terms added into each layer's fused projection
     before B4 ropes it), B10 and the row write apart never; after
     detach_lora the same prompt's logits must equal those taken before
     the attach bit for bit;
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
     steps take the fused step on every layer (B7 and B6 never: no model
     path takes the standalone kernels, which phase 2 holds);
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
     a 2-layer q4_0 GGJT file written here and phase 5's 2-layer q4_1 GGJT
     file, each held against the one-card run of the same file: world
     (1, 2) the TP session (300-token prompt, int8 then bf16-exact
     prefill, 16 greedy tokens;
     first-token logits within phase 5's 1e-2; saved, then loaded into a
     one-card Model: its next logits within 1e-2 of the world's), TP + LoRA
     on the q4_1 file (B4 on every decode layer; detach bit for bit on
     every rank), the engine paged
     and slab (ten requests, 16 tokens each); world (2, 1) the SP session
     (seq_parallel, n_ctx 2048, a 1024-token prompt in n_batch 512 chunks,
     8 greedy tokens) and the engine with dp 2; world (2, 2) the engine on
     the q4_1 file in f32,
     whose greedy streams must equal one card's. Every rank's launches are
     read (B1-B4 > 0 in the TP session, the fused paged step > 0, the
     dequant path 0; B12 once a layer in each TP window and TP or dp
     admission past its gate, never in the SP session or f32), and the
     bytes gloo's CUDA all-gathers and ring sends
     copied through the host are printed;
 11. the bench and profile path: bench_torch.py and bench_torch.py
     --dims=13b (the 13B session, 40 layers), each of whose stdout must
     hold one JSON line with bench.py's keys, finite and positive
     (printed); tools_torch/bench_q4_floor.py at its defaults in this
     process (B13, B14, B1, B15 and B17 at K 4096, N 12288, M 8; their
     launches counted from 0 there, the path of B13's and B14's kernels-line
     entries); the other tools_torch scripts of the path (bench_kernels,
     bench_prefill, bench_paged_attn, bench_engine plain and
     --stall-bench --chunked, profile_decode at 7B and 13B widths,
     profile_paged) at one layer and examples_torch/python/
     example-batch.py and perplexity.py on phase 10's 2-layer q4_0 GGJT.
     Each runs as a subprocess, one at a time, that must exit 0; each
     prints its launches at its exit, counted in its own process: a
     bench_torch run must show B4 once a layer a decode step, B1 for each
     layer's four matmuls and the head, B12 once a layer a prefill window,
     B5 in the bf16 windows, B2 and B3 in the int8 ones and nothing else;
     every other script the kernels of its path; none but bench_kernels
     (which holds B1 against it) the dequant path;
 12. the compiled decode step (utils/step_graph.StepGraph: CUDA graphs, the
     counterpart of the JAX package's jitted decode steps) at full 7B width
     and depth (32 layers, q4_0, bf16 cache, n_ctx 512): 64 greedy session
     steps replayed (forward_jit_decode) against the eager forward of a
     second model from the same cache state, logits bit-equal at every
     step, one capture, each replay B1 129 and B4 32 launches; host and
     device ms a token and the idle share of FastLlama.generate on both
     routes; the engine (8 slots, paged and slab, ten requests) through
     its step graph against the eager step at temp 0 and 0.8 (one seed),
     drain depth 2 (depth 0 in phase 13's engine runs), streams equal and
     one capture a run, and the
     steady window on both routes (host ms, device ms and launches a step,
     one replay a step). Every earlier phase runs its decode steps through
     the step graphs as a user's calls would (the session, the engine,
     bench_torch.py, the C ABI's Model; the mesh paths of phase 10 stay
     eager), and its launch counts hold exactly: a capture adds no launch,
     each replay the graph's; phase 4 also holds the attached q4_1 + LoRA
     step to a graph of its own (B9 129 and B4 32 launches a replay, one
     capture) and detach back to the first graph (no capture);
 13. the compiled prefill windows and admissions (utils/step_graph.
     GraphCache: one graph a bucket and configuration, the counterparts of
     the JAX package's forward_jit and its engine's jitted prefill, chunk
     and splice steps) at full 7B width and depth: the q4_0 session's
     300-token prompt at n_batch 512 (one window) and 64 (five), int8 and
     bf16-exact prefill, two TTFTs and 64 greedy tokens a route in turns
     on two models, the second with its graphs taken off (eager), every
     window's and step's logits bit-equal and the streams equal; TTFT host
     ms and the TTFT window's device ms on both routes, the window graphs'
     captures, replays, build seconds and pool memory; at n_batch 64 int8
     also a window after load_state and a generation of 240 tokens that
     recycles the context, bit-equal to eager. The engine (8 slots, paged,
     paged chunked and slab; phase 6's twelve requests with mixed top_p
     and repeat_penalty, at temp 0 then 0.8 on one engine a route) with
     its admissions replayed against the engine with every graph taken
     off: streams equal, one admission graph a bucket (or the chunk and
     the splice) and no eviction, run() wall time on both routes, each
     engine step of one 300-token admission on the host clock and in a
     profile (tools_torch/engine_admission.admit_once); bench_torch.py's
     TTFTs (phase 11) are its replayed windows'. Every earlier phase runs
     its windows and admissions through these graphs as a user's calls
     would (the mesh paths of phase 10 stay eager), and the exact counts
     of phases 3, 4, 6 and 11 hold: slab_write_rows launches once a layer
     for K and once for V in every window (64 a 7B window);
 14. the q4 matmul variants and the kernel switches: B15-B18 (the decode
     bodies v1/v4/v5, v2, v3 and v7 of the JAX package's
     q4_matmul_pallas; kernels/q4_variants.py) and the h forms (bf16
     scales; v0h is B1's 2-byte-scale mode) against their plain versions,
     B15 and B17 (their own kernel, csrc/q4_fold.cuh) at M = 1, 8, 16, 33
     and 64 on the 7B planes and the 13B qkv plane, the others at M = 1, 8
     and 64 on the 7B planes and M = 8 on the 13B qkv plane, twice and
     bit-equal, timed beside B1, B13, B14 and _weight_int4pack_mm; B20 at
     M <= 32 on qkv, one B20 launch and B15's kernel's result; B19
     (the int8 natx / split body) bit for bit on the 7B and 13B qkv planes
     at M = 512 (and 256), timed beside B2 + B3 and torch._int_mm;
     tools_torch/profile_q4_variants.py with every variant name in this
     process (each variant's kernels launched); the 7B session as
     Model(use_pallas=False) would run it (300-token prompt, 32 greedy
     tokens) on the graph and the eager route, logits bit-equal and
     launches exact (B1 for the decode matmuls and the window's head, B5
     for the window's matmuls, no B2, B3 or B9); use_pallas=True (B15 in
     place of B1, on the graph and the eager route); one window each
     under FASTLLAMA_PREFILL_INT8=0 and
     FASTLLAMA_PREFILL_KERNEL=0 (B5, no B3) and FASTLLAMA_PREFILL_INT8=1
     with use_pallas=False (B2 + B3); use_pallas=True also on the eager
     route, bit-equal, and the device time of a decode token and of the
     n_batch 64 ingest under both switches;
 15. B20 (the prefill split body, v1's fold at prefill M: B5's kernel in
     its split mode) against its plain version on the 7B planes at M =
     512, 256, 64 and 1 and the 13B qkv at 512, bf16 (1e-4 of max |y|)
     and f32 (B5's f32 mode, 1e-5), one plan splitting K, timed beside
     B5 (nat), B15 at M <= 64 and torch.mm of the dequantized weight, and
     the entry point's counted run; B21 (engine/paged_kv.
     paged_attention_tpu, the library paged attention's function, split
     over the sequence with pages staged by bulk copies) against its plain
     version at 32 and 40 heads, bf16 and f32 pools, ragged lengths 1, 63,
     64, 65, 300, 32767, 0 and 4097 over a shuffled table and at B = 1 x
     32767, with NaN in every page no sequence reaches and in the tails of
     partly filled pages, compute blocks of 1, 2, 4, 64 and 512 pages,
     timed beside B6 at 8 x 300 and alone at 8 x 300, 8 x 4096 and 1 x
     32767 on the long engine's tables; the fused B21 step (B21F: RoPE,
     B7's write and the pre-scale folded into B21) against its plain
     version at the same lengths and an inactive slot, pools bit-equal,
     timed beside B7 + B21; the 7B paged engine at n_ctx 32768 (pages of
     64, 128 of them): phase 6's twelve requests greedy with exact
     launches (B21F 32 a decode step; B7, B21 and the fused step none),
     every step's logits on the step graph bit-equal to eager, the streams
     equal to phase 6's n_ctx 512 engine's (the fused step), run() wall
     time and the steady window of both engines; a 2-layer n_ctx 32768
     engine with q/k/v LoRA terms (B21F 2 a step; B7 and B21 none);
     and the n_ctx 32768 engine's steady window with 8 sequences at about
     4096 resident rows (528 pages, 17.7 GB of pools);
 16. f32 mode at full 7B width (f32_path): the 32-layer q4_0 session with a
     300-token prompt (B5's f32 mode at M = 300) and 32 greedy tokens (B1's
     f32 mode at M = 1; the masked attention over the f32 cache, as the
     JAX forward's gate keeps f32 off B4), TTFT, ms a token, the window's
     and the decode steps' device time, launches a token and the idle
     share; the 8-slot paged f32 engine (B1's f32 mode at M = 8, the fused
     step on f32 pools), ms and device ms a step; an 8-layer q4_1 f32
     session (B5's and B9's affine f32 modes); exact f32 launches, no
     retired kernel in any trace; a 2-layer 7B-width f32 model's logits on
     the card against the CPU (1e-4), and again (c2_check) under
     torch.set_float32_matmul_precision("high") with f32 LoRA terms on wq
     and wv, eager, captured and replayed, each bit-equal to its run under
     "highest": the f32 products pinned;
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

from fastllama_tpu_torch.utils.trace import copies_for, kernel_key, time_ms

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


def f32_bounds(nbytes: float, flops: float) -> dict:
    """The bounds of an f32-mode matmul of `flops` (2 M K N) operations:
    bound_ms the larger of the bytes over the HBM rate and the operations
    the kernels run, three bf16 products a multiply-add (x's three parts),
    over the bf16 tensor rate; beside it the FFMA bound (the same function
    on the CUDA cores at the f32 rate) that the replaced kernels had."""
    bnd, by = bound_ms(nbytes, 3.0 * flops, "bf16")
    return dict(bound_ms=bnd, bound_by=by,
                tensor_bound_ms=3.0 * flops / PEAK_OPS["bf16"] * 1e3,
                ffma_bound_ms=flops / PEAK_OPS["f32"] * 1e3,
                bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


# x's values in the three-part case: 1 + t and -1 + t in pairs, t =
# THREE_PART_TAIL, so that each of x's three bf16 parts (q4_matmul.
# f32_parts: 1 or 1 - 2^-8, then about 2^-10 or 2^-9, then 2^-22 or about
# -2^-17) carries bits of the product
THREE_PART_TAIL = 2.0 ** -10 + 2.0 ** -17 + 2.0 ** -22


def three_part_case(torch, m, k, n, affine, gen, dev):
    """An f32-mode matmul that only a kernel using all three parts of x
    passes. x row i is s_i 2^e_i (1 + t, -1 + t, 1 + t, ...) (t =
    THREE_PART_TAIL, s = +-1, e in -1..1); a pair of K positions (2j,
    2j + 1) shares one code (1..3; q4_0 stores q = c + 8, q4_1 q = c with
    mins 0) and the scales are 1 or 1/2. A pair's upper parts cancel, so
    y stays small and its f32 sums nearly exact, while the last part (l)
    of every value adds to each output with one sign. Returns (x f32
    [m, k], the weight, y_exact f64 [m, n], tol, miss): tol is 1/64 of
    the largest |l @ W|, miss the error of the same product without l
    (a kernel that drops l, or more for one that drops or truncates m)."""
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.quant.tensor import QuantMatmulWeight
    nb = k // 32

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)
    pair = torch.tensor([1.0 + THREE_PART_TAIL, -1.0 + THREE_PART_TAIL],
                        dtype=torch.float64, device=dev)
    row = (2.0 * ints(0, 2, (m, 1)) - 1) * torch.pow(2.0, ints(-1, 2, (m, 1)))
    x = (row.double() * pair.repeat(k // 2)[None]).float()
    codes = ints(1, 4, (k // 2, n)).repeat_interleave(2, 0)      # [k, n]
    d = torch.pow(2.0, -ints(0, 2, (nb, n)).float())
    q = (codes + (0 if affine else 8)).to(torch.uint8).reshape(nb, 32, n)
    w = QuantMatmulWeight(
        qs=(q[:, :16] | (q[:, 16:] << 4)).reshape(k // 2, n).contiguous(),
        scales=d.contiguous(), n_logical=n,
        mins=torch.zeros_like(d) if affine else None)
    wd = codes.double() * d.double().repeat_interleave(32, 0)
    exact = x.double() @ wd
    h, mid, low = qm.f32_parts(x)
    tol = (low.double() @ wd).abs().max().item() / 64
    miss = ((h.double() + mid.double()) @ wd - exact).abs().max().item()
    return x, w, exact, tol, miss


# ---------------------------------------------------------------------------
# synthetic weights
# ---------------------------------------------------------------------------

def rand_weight(torch, k, n, gen, dev, affine=False, pad_n=None):
    """A q4_0 (affine: q4_1) matmul weight of logical shape [k, n] with the
    loader's stored padding, from the package's synthetic builder
    (models/synthetic.rand_weight: random codes, scales in [1e-3, 0.02] as
    the JAX package's bench builds them)."""
    from fastllama_tpu_torch.models import synthetic
    return synthetic.rand_weight(k, n, gen, dev, affine, pad_n)


def weight_bytes(w) -> int:
    planes = 1 if w.mins is None else 2
    return w.qs.numel() + planes * w.scales.numel() * 4


def rand_params(torch, hp, gen, dev, affine=False):
    """models/synthetic.rand_params with the head's EOS column zeroed, so
    that greedy decoding runs its full length."""
    from fastllama_tpu_torch.models import synthetic
    params = synthetic.rand_params(hp, gen, dev, affine)
    params.output.scales[:, 2] = 0.0      # EOS logit 0
    if affine:
        params.output.mins[:, 2] = 0.0
    return params


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

# B1's row counts: the single stream (1), the engine (8) and the tiles' edges;
# B9 adds the rows just past an n-tile (9, 17) and a partial 32-row tile (40)
B1_ROWS = (1, 2, 4, 8, 16, 64)
B9_ROWS = (1, 2, 4, 8, 9, 16, 17, 40, 64)
# the rows of B1's and B9's f32 mode on every 7B plane: the single stream,
# M = 2, the engine, and 64 (B5's f32 mode, which B1 and B9 call there)
# (the 13B planes: PROBE_ROWS)
F32_ROWS = (1, 2, 8, 64)


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
    ms = time_ms(run, calls=4 * len(packs))
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
    return time_ms(lambda: sdpa(q, *kvs[next(it) % len(kvs)]),
                   calls=4 * len(kvs))


def sdpa_cycled(torch, q, caches, rows, h, d):
    """sdpa_over the first `rows` rows of each slab cache pair [B, S, h*d],
    viewed as [B, h, rows, d]."""
    b = caches[0][0].shape[0]
    return sdpa_over(torch, q, [tuple(
        x[:, :rows].reshape(b, rows, h, d).transpose(1, 2) for x in kv)
        for kv in caches])


def check_kernels(torch, dev, gen, out_dir):
    """Phase 2: every kernel against its plain version on the card, timed.
    B6, B7 and B10 have no model path (every decode layer runs B4 or a
    fused paged step): their launches here are the only ones, recorded as
    B11's are."""
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import kv_write as kw
    from fastllama_tpu_torch.kernels import paged_attention as pa
    standalone = {"B6": pa.paged_decode_attention, "B7": kw.paged_kv_write,
                  "B10": da.decode_attention}
    for fn in standalone.values():
        fn.launches = 0
    results = {}
    check_decode_matmuls(torch, dev, gen, results)
    check_floor_probes(torch, dev, gen, results)
    check_prefill_matmuls(torch, dev, gen, results)
    check_f32_three_parts(torch, dev, gen, results)
    check_shard_planes(torch, dev, gen, results)
    check_decode_attention(torch, dev, gen, results)
    check_flash_prefill(torch, dev, gen, results)
    check_engine_kernels(torch, dev, gen, results)
    check_fused_paged_step(torch, dev, gen, results)
    check_shard_attention(torch, dev, gen, results)
    check_fused_paged_step(torch, dev, gen, results, heads=SHARD_HEADS)
    check_13b_kernels(torch, dev, gen, results)
    check_row_write(torch, dev, gen, results)
    results["standalone_phase2_launches"] = {
        k: fn.launches for k, fn in standalone.items()}
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


def f32_library_ms(torch, qm, x, w):
    """The library yardstick of an f32-mode matmul: one torch.mm of x (f32,
    padded to the stored K) by the dequantized f32 weight (TF32 off), on a
    weight the port never makes."""
    xr = qm._pad_k(x, w.k)
    wd = qm.dequant_matmul_weight(w, torch.float32)
    ms = time_ms(lambda: torch.mm(xr, wd), calls=4)
    del wd
    return ms


def check_decode_matmuls(torch, dev, gen, results):
    """B1 and B9 on every 7B plane: bf16 mode (variants 0 and 9 of the fold
    kernel) at B1_ROWS / B9_ROWS, with one _weight_int4pack_mm call timed
    beside them; f32 mode (variants 10 and 11) at F32_ROWS, beside one
    torch.mm f32 call and the bf16 mode's time at the same rows; B1 with
    bf16 scales (v0h, variant 0's 2-byte-scale build) at M = 1, 8 and 64;
    B9 also on the planes padded to 256 columns as make_matmul_weight_q41
    pads them; B1 and B9 on the 13B planes at M = 1, 8 and 64 in bf16 mode
    and in f32 mode, timed beside the library calls."""
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.kernels import q4_variants as qv

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

    for key, affine, fn, case, rows_of in (
            ("B1", False, qm.q4_matmul_decode, b1_case, B1_ROWS),
            ("B9", True, qm.q41_matmul_decode, b9_case, B9_ROWS)):
        out = []
        for name, k, n in PLANES_7B:
            w = rand_weight(torch, k, n, gen, dev, affine)
            wbytes = weight_bytes(w)
            ws = [w] + [rand_weight(torch, k, n, gen, dev, affine)
                        for _ in range(copies_for(wbytes) - 1)]
            packs = int4pack_packs(torch, ws)
            for m in sorted(set(rows_of) | set(F32_ROWS)):
                x = torch.randn((m, k), generator=gen, device=dev)
                modes = ((torch.bfloat16,) if m in rows_of else ()) + (
                    (torch.float32,) if m in F32_ROWS else ())
                bf16_ms = None
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
                    ms = time_ms(lambda: fn(
                        x, ws[next(it) % len(ws)], mode), calls=4 * len(ws))
                    plain = qm.q41_matmul_decode_plain if affine else \
                        qm.q4_matmul_dequant
                    plain_ms = time_ms(lambda: plain(x, w, mode),
                                       calls=2)
                    kind = "bf16" if mode == torch.bfloat16 else "f32"
                    nbytes = wbytes + x.numel() * 4 + m * n * 4
                    row = dict(shape=f"{name} M={m} K={k} N={n} {kind}",
                               max_abs_err=err, tol=tol, ms=ms,
                               plain_ms=plain_ms)
                    if kind == "bf16":
                        bf16_ms = ms
                        bnd, by = bound_ms(nbytes, 2.0 * m * k * n, kind)
                        row.update(bound_ms=bnd, bound_by=by)
                        # the library's W4A16 matmul on the same codes
                        if m in B1_ROWS:
                            row.update(int4pack_row(torch, packs, x, y_ref,
                                                    n))
                    else:
                        row.update(f32_bounds(nbytes, 2.0 * m * k * n))
                        row.update(library_ms=f32_library_ms(torch, qm, x, w),
                                   library_call="torch.mm f32 of x by the "
                                   "dequantized weight (TF32 off)",
                                   bf16_mode_ms=bf16_ms)
                        row["vs_library"] = ms / row["library_ms"]
                        if bf16_ms:
                            row["vs_bf16_mode"] = ms / bf16_ms
                    row["bound_share"] = row["bound_ms"] / ms
                    out.append(row)
                    print(f"{key} {row}", flush=True)
                if not affine and m in PROBE_ROWS:
                    out.append(check_v0h(torch, qm, qv, x, w, name))
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

    # B1 (and v0h) and B9 on the 13B planes at PROBE_ROWS, timed over
    # cycled copies beside the library call
    for key, affine, fn, case in (
            ("B1", False, qm.q4_matmul_decode, b1_case),
            ("B9", True, qm.q41_matmul_decode, b9_case)):
        for name, k, n in PLANES_13B:
            w = rand_weight(torch, k, n, gen, dev, affine)
            wbytes = weight_bytes(w)
            ws = [w] + [rand_weight(torch, k, n, gen, dev, affine)
                        for _ in range(copies_for(wbytes) - 1)]
            packs = int4pack_packs(torch, ws)
            for m in PROBE_ROWS:
                x = torch.randn((m, k), generator=gen, device=dev)
                for mode in (torch.bfloat16, torch.float32):
                    kind = "bf16" if mode == torch.bfloat16 else "f32"
                    y, y_ref, tol = case(x, w, mode)
                    err = (y - y_ref).abs().max().item()
                    label = f"{key} 13B {name} M={m} {kind}"
                    require(bool(torch.isfinite(y).all()) and err <= tol,
                            f"{label}: err {err} > {tol}")
                    require(torch.equal(y, fn(x, w, mode)),
                            f"{label}: not deterministic")
                    it = iter(range(10**9))
                    ms = time_ms(lambda: fn(x, ws[next(it) % len(ws)],
                                            mode), calls=4 * len(ws))
                    nbytes = wbytes + x.numel() * 4 + m * n * 4
                    row = dict(shape=f"{name} M={m} K={k} N={n} {kind}",
                               max_abs_err=err, tol=tol, ms=ms)
                    if kind == "bf16":
                        bnd, by = bound_ms(nbytes, 2.0 * m * k * n, "bf16")
                        row.update(bound_ms=bnd, bound_by=by)
                        row.update(int4pack_row(torch, packs, x, y_ref, n))
                    else:
                        row.update(f32_bounds(nbytes, 2.0 * m * k * n))
                        row.update(library_ms=f32_library_ms(torch, qm, x, w))
                        row["vs_library"] = ms / row["library_ms"]
                    row["bound_share"] = row["bound_ms"] / ms
                    results[key].append(row)
                    print(f"{key} 13B {row}", flush=True)
                if not affine:
                    results[key].append(check_v0h(torch, qm, qv, x, w,
                                                  name))
            del ws, w, packs


# the f32 kernels on the three-part case: B1 and B9 on the fold kernel
# (mma.sync at 1, 2 and 8, wgmma at 16 and 32), B5 (its plan, and a
# pinned plan splitting K with tile 0 whole)
F32_EXACT_DECODE_ROWS = (1, 2, 8, 16, 32)
F32_EXACT_PREFILL_ROWS = (65, 300)


def check_f32_three_parts(torch, dev, gen, results):
    """Every f32-mode kernel on three_part_case at the 7B wo plane (K = N
    = 4096): within its tol of the exact product, where the same product
    without x's last part misses by 32 tol or more."""
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    out = []
    for affine in (False, True):
        dec = qm.q41_matmul_decode if affine else qm.q4_matmul_decode
        for m in F32_EXACT_DECODE_ROWS + F32_EXACT_PREFILL_ROWS:
            x, w, exact, tol, miss = three_part_case(torch, m, 4096, 4096,
                                                     affine, gen, dev)
            require(miss >= 32 * tol, f"three-part case M={m}: l misses by "
                    f"{miss}, under 32 x {tol}")
            if m in F32_EXACT_DECODE_ROWS:
                runs = [("B9" if affine else "B1", dec(x, w, torch.float32))]
            else:
                split = qm.prefill_plan(m, 4096, 4096, torch.cuda.
                                        get_device_properties(dev).
                                        multi_processor_count, f32=True,
                                        splits=3, t0=1)
                runs = [("B5", qm.q4_matmul_prefill(x, w, torch.float32)),
                        ("B5 split", qm.q4_matmul_prefill(
                            x, w, torch.float32, plan=split))]
            for key, y in runs:
                err = (y.double() - exact).abs().max().item()
                label = (f"{key} three-part case M={m} "
                         f"{'q4_1' if affine else 'q4_0'}")
                require(err <= tol, f"{label}: err {err} > {tol}")
                out.append(dict(shape=label, max_abs_err=err, tol=tol,
                                without_last_part=miss))
                print(f"f32 {out[-1]}", flush=True)
    results["f32_three_parts"] = out


def check_v0h(torch, qm, qv, x, w, name):
    """B1 with bf16 scales (v0h: q4_variants.q4_decode_v0, variant 0's
    2-byte-scale build) on w's codes against its plain version, within
    1e-5 of sum |R(x)| |R((q - 8) R(d))|, twice and bit-equal; a row
    without a time."""
    sc = w.scales.to(torch.bfloat16)
    y = qv.q4_decode_v0(x, w.qs, sc, n_out=w.n_logical)
    y_ref = qv.decode_plain(x, w.qs, sc, "v0")[:, :w.n_logical]
    wd = qm.dequant_matmul_weight(type(w)(qs=w.qs, scales=sc.float()))
    tol = 1e-5 * absum_of(torch, qm, x, wd, w.n_logical, torch.bfloat16)
    err = (y - y_ref).abs().max().item()
    label = f"B1 v0h {name} M={x.shape[0]}"
    require(bool(torch.isfinite(y).all()) and err <= tol,
            f"{label}: err {err} > {tol}")
    require(torch.equal(y, qv.q4_decode_v0(x, w.qs, sc, n_out=w.n_logical)),
            f"{label}: not deterministic")
    return dict(shape=f"{name} M={x.shape[0]} K={w.k} N={w.n_logical} "
                "v0h (bf16 scales)", max_abs_err=err, tol=tol)


# B13's and B14's rows: the single stream (1), the engine and the JAX
# tool's default (8), B1's largest (64)
PROBE_ROWS = (1, 8, 64)
# what no library call computes: the packed bytes as integer weights
NO_PROBE_LIBRARY = ("none: no PyTorch call reads packed bytes as integer "
                    "weights")


def check_floor_probes(torch, dev, gen, results):
    """B13 (q4_floor) and B14 (q4_nosc), the probes of the fold kernel
    (csrc/q4_fold.cuh, on B15's plan at f32 scales, printed), on the 7B
    planes qkv, wo, w13 and w2 at PROBE_ROWS and on the 13B planes at
    M = 8: held against their plain versions within 1e-5 of sum |R(x_half)|
    |code| (the products are exact, so only the summation order differs),
    each run twice and bit-equal; timed beside B15 (q4_variants.
    q4_decode_v1: the same kernel, plane, M and plan, with the scales and
    the fold) and B1 on the same plane and M, over weight copies cycled
    past the L2, with their bound (qs, x and out over the HBM rate: B13's x
    is its low halves only; B15's and B1's add the scale plane)."""
    from fastllama_tpu_torch.kernels import cuda_lib
    from fastllama_tpu_torch.kernels import q4_floor as qf
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.kernels import q4_variants as qv
    out = {"B13": [], "B14": []}
    sms = cuda_lib.sm_count(dev)
    probes = {"B13": (qf.q4_floor, qf.q4_floor_plain),
              "B14": (qf.q4_nosc, qf.q4_nosc_plain)}
    cases = [(p, PROBE_ROWS) for p in PLANES_7B[:4]] + [
        (p, (8,)) for p in PLANES_13B]
    for (name, k, n), rows in cases:
        w = rand_weight(torch, k, n, gen, dev)
        wbytes = weight_bytes(w)
        ws = [w] + [rand_weight(torch, k, n, gen, dev)
                    for _ in range(copies_for(wbytes) - 1)]
        for m in rows:
            x = torch.randn((m, w.k), generator=gen, device=dev)
            xr = x.to(torch.bfloat16).float().abs()
            lo, hi = qf.split_activation(xr)
            q = w.qs.to(torch.int32)
            absum = {"B13": (lo @ w.qs.float()).max().item(),
                     "B14": (lo @ (q & 15).float()
                             + hi @ (q >> 4).float()).max().item()}
            it = iter(range(10**9))
            b1_ms = time_ms(lambda: qm.q4_matmul_decode(
                x, ws[next(it) % len(ws)]), calls=4 * len(ws))
            # B15's function has B1's bytes and operations
            b1_bound, _ = bound_ms(wbytes + x.numel() * 4 + m * n * 4,
                                   2.0 * m * k * n, "bf16")
            plan = qv.b15_plan(m, w.qs.shape[1], w.qs.shape[0] // 16, sms,
                               False, qv.b15_capacity(dev))
            print(f"B13/B14 {name} M={m}: B15's plan {plan._asdict()}",
                  flush=True)

            def b15():
                ww = ws[next(it) % len(ws)]
                return qv.q4_decode_v1(x, ww.qs, ww.scales)
            b15_ms = time_ms(b15, calls=4 * len(ws))
            for key, (fn, plain) in probes.items():
                y = fn(x, w.qs)
                again = fn(x, w.qs)
                ref = plain(x, w.qs)
                err = (y - ref).abs().max().item()
                tol = 1e-5 * absum[key]
                label = f"{key} {name} M={m} K={w.k} N={w.qs.shape[1]}"
                require(bool(torch.isfinite(y).all()), f"{label}: not finite")
                require(err <= tol, f"{label}: err {err} > {tol}")
                require(torch.equal(y, again), f"{label}: not deterministic")
                ms = time_ms(lambda: fn(x, ws[next(it) % len(ws)].qs),
                             calls=4 * len(ws))
                plain_ms = time_ms(lambda: plain(x, w.qs), calls=2)
                # B13's function reads x's low halves only, B14's all of x
                ops = 2.0 * m * w.qs.numel() * (1 if key == "B13" else 2)
                x_bytes = x.numel() * (2 if key == "B13" else 4)
                bnd, by = bound_ms(w.qs.numel() + x_bytes
                                   + m * w.qs.shape[1] * 4, ops, "bf16")
                row = dict(shape=f"{name} M={m} K={w.k} N={w.qs.shape[1]}",
                           max_abs_err=err, tol=tol, ms=ms,
                           plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                           bound_share=bnd / ms, library_ms=None,
                           library_call=NO_PROBE_LIBRARY, b1_ms=b1_ms,
                           b1_bound_ms=b1_bound, b15_ms=b15_ms,
                           share_of_b15=ms / b15_ms, plan=plan._asdict())
                out[key].append(row)
                print(f"{key} {row}", flush=True)
        del ws, w
    results.update(out)


def check_13b_kernels(torch, dev, gen, results):
    """The kernels not held elsewhere at 13B widths (PRESETS["13B"]: 40
    heads of 128, n_embd 5120, n_ff 13824), at the 7B rows' tolerances:
    B9 at M = 1 and 8 on the four 13B q4_1 planes; B4 and B10 at 40 heads,
    B = 1 at n_past 0, 300, 511 and past S and B = 8 at 8 x 300 (bf16 and
    f32 caches); the standalone B7 and B8 (T = 512) on 40-head bf16 pools,
    bit for bit. (B2 runs on the 13B planes in check_prefill_matmuls,
    B1, B3, B5, B6, B12 and the fused step in their own checks.) One row a
    kernel and case in results["13B"]."""
    from fastllama_tpu_torch.kernels import kv_write as kw
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    rows = results.setdefault("13B", [])
    for name, k, n in PLANES_13B:
        w = rand_weight(torch, k, n, gen, dev, affine=True)
        for m in (1, 8):
            x = torch.randn((m, k), generator=gen, device=dev)
            y = qm.q41_matmul_decode(x, w, torch.bfloat16)
            ref = qm.q41_matmul_decode_plain(x, w, torch.bfloat16)
            err = (y - ref).abs().max().item()
            tol = b9_tol(torch, qm, x, w, torch.bfloat16)
            label = f"B9 13B {name} M={m} K={k} N={n} bf16"
            require(bool(torch.isfinite(y).all()) and err <= tol,
                    f"{label}: err {err} > {tol}")
            require(torch.equal(y, qm.q41_matmul_decode(x, w,
                                                        torch.bfloat16)),
                    f"{label}: not deterministic")
            ms = time_ms(lambda: qm.q41_matmul_decode(
                x, w, torch.bfloat16), calls=8)
            rows.append(dict(kernel="B9", shape=label, max_abs_err=err,
                             tol=tol, ms_l2_warm=ms))
            print(f"13B {rows[-1]}", flush=True)
        del w
    s_len = ENG_CTX
    check_attention_heads(torch, dev, gen, rows, "13B", 40, {
        1: [[0], [300], [511], [s_len + 88]], ENG_SLOTS: [[300] * ENG_SLOTS]})

    h, d, ps, b = 40, 128, ENG_PS, ENG_SLOTS
    pp = ENG_CTX // ps
    n_pages = b * pp
    f = h * d

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)
    k1, v1 = (torch.randn((h, n_pages + 1, ps, d), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    k2, v2 = k1.clone(), v1.clone()
    k_new, v_new = (torch.randn((b, h, d), generator=gen, device=dev)
                    for _ in range(2))
    pids = i32([5, n_pages, 17, 0, n_pages, n_pages + 3, 63, 31])
    offs = i32([0, 0, ps - 1, 9, 3, 1, 40, 63])
    kw.paged_kv_write(k1, v1, k_new, v_new, pids, offs)
    kw.paged_kv_write_plain(k2, v2, k_new, v_new, pids, offs)
    torch.cuda.synchronize()
    require(torch.equal(k1[:, :n_pages], k2[:, :n_pages])
            and torch.equal(v1[:, :n_pages], v2[:, :n_pages]),
            "B7 13B (40 heads): pages differ from the plain version's")
    ms = time_ms(lambda: kw.paged_kv_write(
        k1, v1, k_new, v_new, pids, offs), calls=32)
    rows.append(dict(kernel="B7", shape=f"B7 13B B={b} H={h} d={d} ps={ps} "
                     "bf16", max_abs_err=0.0, ms_l2_warm=ms))
    print(f"13B {rows[-1]}", flush=True)
    k_rows, v_rows = (torch.randn((ENG_CTX, f), generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
    blocks = i32([9, 2, n_pages, 40, 41, n_pages + 1, 7, 22])
    kw.paged_kv_write_rows(k1, v1, k_rows, v_rows, blocks)
    kw.paged_kv_write_rows_plain(k2, v2, k_rows, v_rows, blocks)
    torch.cuda.synchronize()
    require(torch.equal(k1[:, :n_pages], k2[:, :n_pages])
            and torch.equal(v1[:, :n_pages], v2[:, :n_pages]),
            "B8 13B (40 heads): pages differ from the plain version's")
    require(torch.equal(k1[3, 40, 5], k_rows[3 * ps + 5, 3 * d:4 * d]),
            "B8 13B: row 5 of block 3 is not in page 40")
    ms = time_ms(lambda: kw.paged_kv_write_rows(
        k1, v1, k_rows, v_rows, blocks), calls=16)
    rows.append(dict(kernel="B8", shape=f"B8 13B T={ENG_CTX} H={h} d={d} "
                     f"ps={ps} bf16", max_abs_err=0.0, ms_l2_warm=ms))
    print(f"13B {rows[-1]}", flush=True)
    del k1, v1, k2, v2


def check_prefill_matmuls(torch, dev, gen, results):
    """B2 and B3 (bit for bit) and B5 against their plain versions; B3 on
    the 7B and 13B planes at M = 512 and 256 (the register-A kernel, one
    launch: its device time from a profiler trace beside the wrapper's
    graph time), torch._int_mm (the int8 product alone) beside it; at qkv
    M = 512 what one int8 call launches and allocates (b3_call)."""
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
            # the main path's K's at 7B and 13B
            if m == 512 and name in ("qkv", "w2", "qkv13", "w2_13"):
                ms = time_ms(lambda: qm.quant_rows_int8(x, w.k),
                             calls=20)
                plain_ms = time_ms(lambda: qm.quant_rows_int8_plain(
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
            plan = qm.prefill_plan(m, w.qs.shape[1], w.k,
                                   cuda_lib.sm_count(dev), int8=True)
            it = iter(range(10**9))

            def cycled():
                return qm.q4_matmul_prefill_int8(xq, dx,
                                                 ws[next(it) % len(ws)])
            ms = time_ms(cycled, calls=2 * len(ws))
            # its one launch, by kernel name in a profiler trace
            kern_ms = device_ms_by_name(torch, cycled, 2 * len(ws),
                                        ("q4_prefill_int8_kernel",))
            plain_ms = (time_ms(lambda: qm.q4_matmul_prefill_int8_plain(
                xq, dx, w), calls=2)
                if m == 512 and name in {p[0] for p in shapes} else None)
            # the function's operations: the logical K and N, not the
            # stored padding
            ops = 2.0 * m * k * n
            bnd, by = bound_ms(m * w.k + m * 4 + wbytes + m * n * 4, ops,
                               "int8")
            gemm_ms = kern_ms["q4_prefill_int8_kernel"]
            row = dict(shape=f"{name} M={m} K={k} N={n}", max_abs_err=0.0,
                       ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                       library_ms=time_ms(lambda: torch._int_mm(
                           xq, w8_cm), calls=10),
                       kernel_ms=gemm_ms, plan=list(plan),
                       int8_peak_share=ops / PEAK_OPS["int8"] * 1e3
                       / gemm_ms)
            row["vs_library"] = row["ms"] / row["library_ms"]
            if name == "qkv" and m == 512:
                row.update(b3_call(torch, x, w))
            b3.append(row)
            print(f"B3 {row}", flush=True)
        del ws, w, w8, w8_cm
    results["B2"], results["B3"] = b2, b3

    check_b5(torch, dev, gen, results)


def b3_call(torch, x, w):
    """What one int8 call of q4_matmul launches and allocates: B2's
    quant_rows_kernel and one q4_prefill_int8_kernel (no requantization
    pass) from a profile, and the bytes the allocator hands out during it
    (xq, dx and y, and the split scratch where it grows; no int8 [N, K]
    plane)."""
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    kernels = kernels_per_call(
        torch, lambda: qm.q4_matmul(x, w, prefill_int8=True))
    require(kernels == {"quant_rows_kernel": 1, "q4_prefill_int8_kernel": 1},
            f"B3: an int8 call launches {kernels}, not B2's kernel and one "
            "product kernel")
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
    qm.q4_matmul(x, w, prefill_int8=True)
    torch.cuda.synchronize()
    allocated = (torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
                 - before)
    m, k = x.shape
    n = w.qs.shape[1]
    outputs = m * k + 4 * m + 4 * m * n            # xq, dx, y
    require(allocated < outputs + n * k // 2,
            f"B3: a call allocated {allocated} bytes, its outputs "
            f"{outputs}: an [N, K] int8 plane is {n * k}")
    return dict(kernels_a_call=kernels, allocated_bytes_a_call=allocated,
                output_bytes=outputs, int8_plane_bytes=n * k)


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
    rounded x by the already dequantized weight, f32 output; f32 mode: an
    f32 torch.mm, TF32 off); the cast and the product (the register-A
    kernel, q4_prefill_bf16_kernel, f32 mode cast3_kernel and
    q4_prefill_f32_kernel) timed apart from a profiler trace at M = 128
    and 512 on qkv."""
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
                    ms = time_ms(lambda: qm.q4_matmul_prefill(
                        x, ws[next(it) % len(ws)], mode), calls=len(ws))
                    dequant_ms = time_ms(lambda: qm.q4_matmul_dequant(
                        x, w, mode), calls=2)
                    xr = qm._pad_k(x, w.k).to(mode)
                    kw = {"out_dtype": torch.float32} if kind == "bf16" else {}
                    library_ms = time_ms(lambda: torch.mm(xr, wd, **kw),
                                         calls=4)
                    nbytes = wbytes + x.numel() * 4 + m * n * 4
                    row = dict(shape=f"{name} M={m} K={k} N={n} {kind} "
                               f"{quant}", max_abs_err=err, tol=tol, ms=ms,
                               plain_ms=dequant_ms, dequant_path_ms=dequant_ms,
                               library_ms=library_ms,
                               vs_library=ms / library_ms)
                    if kind == "bf16":
                        bnd, by = bound_ms(nbytes, 2.0 * m * k * n, kind)
                        row.update(bound_ms=bnd, bound_by=by)
                    else:
                        row.update(f32_bounds(nbytes, 2.0 * m * k * n))
                    row["bound_share"] = row["bound_ms"] / ms
                    row["plan"] = list(qm.prefill_plan(
                        m, w.qs.shape[1], -(-k // 32) * 32,
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count, f32=kind == "f32"))
                    if name == "qkv" and not affine and m in (128, 512):
                        row.update(device_ms_by_name(
                            torch, lambda: qm.q4_matmul_prefill(
                                x, ws[next(it) % len(ws)], mode),
                            2 * len(ws), ("cast_kernel",
                                          "q4_prefill_bf16_kernel")
                            if kind == "bf16" else (
                                "cast3_kernel", "q4_prefill_f32_kernel")))
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
        # bf16: each block rounds its p = exp(score - block max) to bf16
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

    # no rows, one, the 64-row edges (8 rows a block of a cluster of 8 at
    # S 512), 300, the last row, and
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
        ms = time_ms(run, calls=2 * n_caches)
        plain_ms = time_ms(lambda: da.decode_attention_fused_plain(
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

    # one row, two, the 64-row edges, 300, the last row, and
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
        ms = time_ms(run10, calls=2 * n_caches)
        plain_ms = time_ms(lambda: da.decode_attention_plain(
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
        ms = time_ms(run, calls=4 * len(sets))
        plain_ms = time_ms(lambda: fp.flash_prefill_plain(q, k, v),
                           calls=3)
        kc, vc = (torch.randn((1, s_len, f), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        pos = torch.arange(t, device=dev)[None, :]
        qf = q.float()
        masked_ms = time_ms(lambda: da.masked_attention(
            qf, kc, vc, pos, h, 1 / math.sqrt(d)), calls=3)
        del kc, vc, qf
        sd = [tuple(x.transpose(1, 2).contiguous() for x in st)
              for st in sets]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa_ms = time_ms(lambda: sdpa(*sd[next(it) % len(sd)],
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
            ms = time_ms(run6, calls=8 * len(pools))
            plain_ms = time_ms(lambda: pa.paged_decode_attention_plain(
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
            ms = time_ms(run11, calls=8 * len(flats))
            plain_ms = time_ms(lambda: pa
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
        ms = time_ms(lambda: kw.paged_kv_write(
            k1, v1, k_new, v_new, pids, offs), calls=32)
        plain_ms = time_ms(lambda: kw.paged_kv_write_plain(
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
                       library_ms=time_ms(index_put, calls=16),
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
        ms = time_ms(lambda: kw.paged_kv_write_rows(
            k1, v1, k_rows, v_rows, blocks), calls=16)
        plain_ms = time_ms(lambda: kw.paged_kv_write_rows_plain(
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
                       library_ms=time_ms(index_copy_pages,
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
    ms = time_ms(lambda: pa.paged_decode_attention(
        q1, *pools1[next(it) % len(pools1)], n1, t1), calls=4 * len(pools1))
    plain_ms = time_ms(lambda: pa.paged_decode_attention_plain(
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
        ms = time_ms(run4, calls=8 * n_caches)
        plain_ms = time_ms(lambda: da.decode_attention_fused_plain(
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
        ms = time_ms(run10, calls=8 * n_caches)
        plain_ms = time_ms(lambda: da.decode_attention_plain(
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
                    ms = time_ms(fused, calls=8 * len(pools))
                    unfused_ms = time_ms(glue_b7_b6,
                                         calls=8 * len(pools))
                    plain_ms = time_ms(lambda: pa
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


def check_row_write(torch, dev, gen, results):
    """slab_write_rows (csrc/kv_write.cu: the slab caches' K/V row write at
    an offset held on the device, every captured window's)
    bit for bit against its plain version (the dropping scatter) at the
    shapes the paths give it: the fresh 512-row window's k (a strided view
    of the RoPE pass's output) and v, a 64-row chunk inside the cache and
    one whose tail passes S, a LoRA decode step's row, eight engine slots
    at depths 0-511 and past S (dropped), f32 caches. Timed at the
    window's shape beside index_copy_ (the same write where nothing can
    drop) and the plain version; bound: the rows read once and written
    once."""
    from fastllama_tpu_torch.kernels import kv_write as kw
    f, s = 4096, 512
    bf, f32 = torch.bfloat16, torch.float32

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def rand(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    rows = []
    cases = (("T=512 n_past=0 k view bf16", 1, 512, [0], bf, True),
             ("T=512 n_past=0 v bf16", 1, 512, [0], bf, False),
             ("T=64 n_past=300 bf16", 1, 64, [300], bf, False),
             ("T=64 n_past=480 tail past S bf16", 1, 64, [480], bf, False),
             ("T=1 n_past=300 bf16", 1, 1, [300], bf, False),
             ("B=8 T=1 n_past=0..511, 512, 513 f32", 8, 1,
              [0, 1, 63, 64, 300, 511, 512, 513], f32, False),
             ("T=512 n_past=0 f32", 1, 512, [0], f32, False))
    for label, b, t, n_past, dt, view in cases:
        cache = rand((b, s, f), dt)
        src = rand((b, t, 2 * f if view else f), dt)
        val = src[:, :, f:] if view else src
        n = i32(n_past)
        got, want = cache.clone(), cache.clone()
        kw.slab_write_rows(got, val, n)
        kw.slab_write_rows_plain(want, val, n)
        require(torch.equal(got, want), f"slab_write_rows {label}: the "
                "cache differs from the plain version's")
        rows.append(dict(kernel="RW", shape=label, max_abs_err=0.0))
    # timed at the fresh window: caches cycled through more than the L2
    t = 512
    nbytes = 2 * t * f * 2
    caches = [torch.zeros((1, s, f), dtype=bf, device=dev)
              for _ in range(copies_for(nbytes))]
    val = rand((1, t, f), bf)
    n0 = i32([0])
    idx = torch.arange(t, device=dev)
    it = iter(range(10**9))
    ms = time_ms(lambda: kw.slab_write_rows(
        caches[next(it) % len(caches)], val, n0), calls=4 * len(caches))
    lib_ms = time_ms(lambda: caches[next(it) % len(caches)].index_copy_(
        1, idx, val), calls=4 * len(caches))
    plain_ms = time_ms(lambda: kw.slab_write_rows_plain(caches[0], val, n0),
                       calls=2)
    bnd, by = bound_ms(nbytes + 4, 0.0, "bf16")
    rows[0].update(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                   library_ms=lib_ms,
                   library_call="index_copy_ of the window's rows (no drop)")
    print(f"RW {rows[0]}", flush=True)
    del caches
    results["RW"] = rows


def counted_kernels(qm, da):
    from fastllama_tpu_torch.kernels.flash_prefill import flash_prefill
    from fastllama_tpu_torch.kernels.kv_write import slab_write_rows
    return {"B1": qm.q4_matmul_decode, "B2": qm.quant_rows_int8,
            "B3": qm.q4_matmul_prefill_int8, "B4": da.decode_attention_fused,
            "B5": qm.q4_matmul_prefill, "B9": qm.q41_matmul_decode,
            "B10": da.decode_attention, "B12": flash_prefill,
            "RW": slab_write_rows}


def reset_counts(qm, da):
    for fn in counted_kernels(qm, da).values():
        fn.launches = 0


def read_counts(qm, da):
    return {k: fn.launches for k, fn in counted_kernels(qm, da).items()}


N_PROMPT, N_DECODE = 300, 64
PREFILL_MATMULS = 4 * 32     # a 512-row window: four matmuls a layer
FLASH_WINDOW = 32            # B12 once a layer in a fresh 512-row window
# slab_write_rows: the K and V rows of each layer of a window replayed at a
# tensor offset (models/llama.forward_jit); a decode step's layer, with q/k/v
# LoRA terms too, writes its row inside B4
WINDOW_ROWS = 2 * 32
# launches of one 300-token prefill window plus N_DECODE decode steps: four
# matmuls per layer and the head per step, the head once per window
DECODE_MATMULS = 129 * N_DECODE + 1
LAYER_CALLS = 32 * N_DECODE


def make_session(hp, params, dev, **rcfg_kw):
    from fastllama_tpu_torch.config import RuntimeConfig
    from fastllama_tpu_torch.engine.session import FastLlama
    from fastllama_tpu_torch.models.runtime import LlamaModel
    rcfg = RuntimeConfig(**{**dict(n_ctx=512, n_batch=512,
                                   kv_dtype="bfloat16",
                                   weight_dtype="bfloat16"), **rcfg_kw})
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
    # the windows ingest ran, and the last one, which generate runs
    n_prompt = sess.n_past + len(sess._embd)
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
    require(counts["RW"] == WINDOW_ROWS, f"slab_write_rows launched "
            f"{counts['RW']} times in the TTFT window, not {WINDOW_ROWS}")
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
    require_window_kernels(prefill, "q4_prefill_int8_kernel", "int8 window")
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
    eprof = profile_prefill(torch, sess, prompt)
    require_window_kernels(eprof, "q4_prefill_bf16_kernel",
                           "bf16-exact window")
    res["bf16_prefill"] = dict(
        ttft_ms=float(np.median(ettfts)), ttft_ms_runs=ettfts,
        int8_ttft_ms=res["ttft_ms"], launches=ecounts,
        prefill_profile=eprof,
        prefill_profile_masked_route=profile_prefill(torch, sess, prompt,
                                                     flash=False))
    print(f"bf16-exact prefill: {json.dumps(res['bf16_prefill'])}", flush=True)
    del sess, model, params
    torch.cuda.empty_cache()
    return res


def q41_lora_path(torch, dev, gen, tmp):
    """32 layers of 7B-width q4_1 weights with a rank-8 A/B adapter on wq and
    wv of every layer: detached, attached, detached again. Attached, every
    decode layer still runs B4, its q and v terms added into the fused
    projection first (models/llama._fold_qkv_lora): no B10 and no row
    write outside the windows'."""
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
        # the gate does not look at LoRA: B12 attends the window attached;
        # attached or not, each decode layer runs B4 and only the window
        # writes rows apart
        want = {"B9": DECODE_MATMULS, "B1": 0, "B2": 0, "B3": 0,
                "B5": PREFILL_MATMULS, "B12": FLASH_WINDOW,
                "B4": LAYER_CALLS, "B10": 0, "RW": WINDOW_ROWS}
        require(counts == want, f"q4_1 {label}: launches {counts}, "
                f"expected {want}")
        # the decode steps replay a graph of this state's own (phase 12):
        # attach and detach are new keys, as new pytrees retrace under jit
        per_replay = model._graphs.last.launches_per_replay()
        require(per_replay == {"q41_matmul_decode": 129,
                               "decode_attention_fused": 32},
                f"q4_1 {label}: a replay holds {per_replay}")
        runs = [first] + [timed_run(torch, sess, prompt) for _ in range(2)]
        ms_tok = [r[1] / N_DECODE * 1e3 for r in runs]
        out = dict(ttft_ms=float(np.median([r[0] for r in runs])),
                   ttft_ms_runs=[r[0] for r in runs],
                   decode_ms_per_token=float(np.median(ms_tok)),
                   decode_ms_per_token_runs=ms_tok, launches=counts,
                   launches_per_replay=per_replay,
                   step_graph_captures=sum(
                       g.captures for g in model._graphs.entries("decode")))
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
    graphs = [r["step_graph_captures"] for r in (res_before, res_lora,
                                                  res_after)]
    # attach is a new key; detach resets the layers' fields in place, so
    # the first key comes back and its graph, still in the session's
    # cache, replays (as jax.jit's cache would hit)
    require(graphs[1] == graphs[0] + 1 and graphs[2] == graphs[1],
            f"q4_1: step graph captures {graphs} (before attach, attached, "
            "after detach): attach must capture once, detach none")
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


def require_window_kernels(prof, product, label):
    """A TTFT window's profile (where the profiler saw device time) names
    the prefill matmul's kernel and no int8 weight-plane pass (the
    requantization kernel the register-A kernel retired)."""
    names = [k["name"] for k in prof.get("kernels", [])]
    require(not prof or (any(product in n for n in names)
                         and not any("requant" in n for n in names)),
            f"{label}: the profile's kernels {names} do not show {product}")


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
    try:
        if not flash:
            # its window's graph is built outside the trace: the profile
            # reads a replay, as the flash route's
            warm_up(sess, prompt)
        sess.reset()
        torch.cuda.synchronize()
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


def device_ms_by_name(torch, fn, calls: int, names,
                      traces: int = 5) -> dict:
    """Device ms per fn() call of the kernels whose names contain each of
    `names`, from a torch.profiler trace of `calls` calls: the launches of
    one wrapper timed apart.

    The trace records its second step of `calls` calls; the first runs
    with the tracer already on and is dropped. The tracer on the H100 has
    still lost a whole call's launches from a trace now and then, so a
    trace that holds another count of a name than `calls` is printed and
    taken again, up to `traces` times, and the call fails if none holds
    every name exactly `calls` times."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        by_name = kernel_device_us(prof)
        hits = {want: [v for k, v in by_name.items() if want in k]
                for want in names}
        seen = {want: sum(c for _, c in h) for want, h in hits.items()}
        if all(n == calls for n in seen.values()):
            return {want: sum(us for us, _ in h) / 1e3 / calls
                    for want, h in hits.items()}
        print(f"profiler: trace {attempt} of {traces} holds {seen} "
              f"launches, not {calls} each", flush=True)
    raise SmokeFailure(f"profiler: {names} not seen {calls} times each in "
                       f"any of {traces} traces")


def kernels_per_call(torch, fn, calls: int = 4, traces: int = 5) -> dict:
    """{kernel base name: launches a call} of one fn() call, from a
    torch.profiler trace of `calls` calls, recorded as device_ms_by_name
    records its traces (the second of two steps). A trace that holds no
    kernel or a count that is not a whole multiple of `calls` (the tracer
    loses launches now and then, late in a long process) is printed and
    taken again, up to `traces` times."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        counts = {}
        for k, (_, c) in kernel_device_us(prof).items():
            if not k.startswith("ProfilerStep"):   # the schedule's own span
                counts[kernel_key(k)] = counts.get(kernel_key(k), 0) + c
        if counts and all(c % calls == 0 for c in counts.values()):
            return {k: c // calls for k, c in counts.items()}
        print(f"profiler: trace {attempt} of {traces}: {counts}", flush=True)
    raise SmokeFailure(f"profiler: no trace of {calls} calls held whole "
                       f"calls")


def device_time_by_kernel(prof, n_steps: int):
    """From a torch.profiler trace of n_steps steps: (device ms per step,
    device launches per step, the twelve kernels with the most device time
    as (name, ms per step, calls per step)). The device time is the time
    the device's events cover (overlaps once: a programmatic dependent
    starts before the kernel ahead of it ends); a kernel's, its spans'."""
    from torch.autograd import DeviceType
    from fastllama_tpu_torch.utils.trace import busy_us
    by_name = kernel_device_us(prof)
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    total_us = (busy_us(spans) if spans
                else sum(v[0] for v in by_name.values()))
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


def first_logits(lm):
    """The prefill logits of a 21-token prompt from a reset model, then its
    first decode step's (numpy copies)."""
    toks = [1] + list(range(300, 320))
    lm.reset()
    return [lm.eval(0, toks), lm.eval(len(toks), [toks[-1]])]


def rel_errs(got, want):
    """Each pair's largest difference over the largest reference logit."""
    return [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(got, want)]


def card_vs_cpu(lm_gpu, lm_cpu):
    """Largest difference of the prefill and first decode logits of one
    model on the card and on the CPU (plain versions), over the largest
    logit."""
    return rel_errs(first_logits(lm_gpu), first_logits(lm_cpu))


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
            "kernel_lib_s": _cl.build_seconds,
            "step_build_s": self._model._graphs.build_s}),
            file=sys.stderr,
            flush=True)
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
print(json.dumps({"s": time.perf_counter() - t0, "text": "".join(chunks),
                  "step_build_s": m._model._graphs.build_s}))
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
    py_build_s = model._model._graphs.build_s
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
               python_warm_tok_s=n_gen / py_gen_s,
               # host seconds of the graphs' warm-ups and captures (the
               # decode step's and the last prompt window's) inside each
               # generate above (phases 12 and 13)
               step_build_s={"c_program": crun["step_build_s"],
                             "python_process": py_cold["step_build_s"],
                             "python_shared_libpython":
                                 py_host["step_build_s"],
                             "python_warm": py_build_s},
               streams_equal=True,
               c_perplexity=c_ppl, python_perplexity=py_ppl,
               perplexity_c_wall_s=ppl_wall)
    print(f"C ABI: {json.dumps(res)}", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 11: the bench and profile path
# ---------------------------------------------------------------------------

# bench.py's keys (bench_torch.py prints them); vs_baseline only where
# baseline_ref.json has a rate for the dims (7B)
BENCH_KEYS = ("metric", "value", "unit", "steady_state_tokens_per_sec",
              "ttft_ms_p50", "ttft_ms_p50_int8", "ttft_ms_p50_bf16")
# bench_torch.py's decode steps (the first, 5 warm, 64 and 192 timed, 8
# traced, one after each of the 2 x 5 timed TTFT prefills) and its prefill
# windows (2 routes x (1 first + 5 timed))
BENCH_STEPS = 1 + 5 + 64 + 3 * 64 + 8 + 2 * 5
BENCH_WINDOWS = 2 * (1 + 5)
# the kernels a bench_torch run never reaches
OFF_BENCH_PATH = ("B6", "B7", "B8", "B9", "B10", "B11", "PS", "B13", "B14",
                  "RW", "B15", "B16", "B17", "B18", "B19", "B20", "B21",
                  "B21F")
# each tool of tools_torch/ at one layer (the phase is host-bound: its
# depth is its time), run as a subprocess on the card: (script, arguments,
# the kernels it must launch)
BENCH_TOOLS = [
    # its default variants v0, v1 and v2
    ("bench_kernels.py", ["--layers", "1"], ("B1", "B15", "B16")),
    ("bench_prefill.py", ["--layers", "1"], ("B1", "B2", "B3", "B12")),
    ("bench_paged_attn.py", ["--reps", "4"],
     ("B4", "B6", "B10", "PS", "B21")),
    ("bench_engine.py", ["--layers", "1", "--max-tokens", "8"],
     ("B1", "B4")),
    ("bench_engine.py", ["--layers", "1", "--max-tokens", "16",
                         "--stall-bench", "--chunked", "--kv-mode", "paged",
                         "--admissions", "1"], ("B1", "B8", "PS")),
    ("profile_decode.py", ["--layers", "1", "--steps", "2"], ("B1", "B4")),
    ("profile_decode.py", ["--dims", "13b", "--layers", "1", "--steps",
                           "2"], ("B1", "B4")),
    ("profile_paged.py", ["--layers", "1", "--steps", "2"], ("B1", "PS")),
]
# runs the script argv[1] as __main__ with argv[2:], and at its exit prints
# every kernel wrapper's launches (counts_now) on stderr as one line
COUNTED = """import atexit, json, os, runpy, sys
sys.path.insert(0, os.getcwd())
import chip_smoke
atexit.register(lambda: print("launches " + json.dumps(
    chip_smoke.counts_now()), file=sys.stderr, flush=True))
sys.argv = sys.argv[1:]
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[0])))
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def counts_now() -> dict:
    """Every kernel wrapper's launches by its table name (B1-B21, PS, RW,
    B21F) and the dequant path's calls on the card ("dequant")."""
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    out = {k: fn.launches for k, fn in every_kernel().items()}
    out.update(dequant=qm.q4_matmul_dequant.cuda_calls)
    return out


def start_counted(script, args, cwd):
    """Start `script args` from cwd as a subprocess under COUNTED."""
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-c", COUNTED, script, *args], cwd=cwd,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def run_counted(script, args, cwd, timeout=600.0):
    """Run `script args` from cwd as a subprocess, alone on the card, under
    COUNTED; returns finish_counted's tuple."""
    return finish_counted(start_counted(script, args, cwd), timeout)


def finish_counted(started, timeout=600.0):
    """Wait for a start_counted subprocess (killed past `timeout` s); returns
    (returncode, stdout, stderr, seconds, launches: the counts it printed at
    its exit, None where it printed none)."""
    t0, proc = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    counted = [ln for ln in err.splitlines() if ln.startswith("launches {")]
    launches = json.loads(counted[-1].split(" ", 1)[1]) if counted else None
    return proc.returncode, out, err, time.perf_counter() - t0, launches


def bench_line(out: str, dims: str) -> dict:
    """bench_torch.py's JSON line (the last of its stdout): bench.py's keys,
    finite positive numbers."""
    lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
    require(len(lines) == 1, f"bench_torch {dims}: {len(lines)} JSON lines")
    line = json.loads(lines[0])
    want = set(BENCH_KEYS) | ({"vs_baseline"} if dims == "7b" else set())
    require(set(line) == want, f"bench_torch {dims}: keys {sorted(line)}")
    require(line["metric"] == f"decode_tokens_per_sec_per_chip_{dims}_q4_0"
            and line["unit"] == "tokens/s", f"bench_torch {dims}: {line}")
    for key in want - {"metric", "unit"}:
        require(math.isfinite(line[key]) and line[key] > 0,
                f"bench_torch {dims}: {key} = {line[key]}")
    return line


def bench_launches(n: dict, n_layer: int, dims: str) -> None:
    """A bench_torch run's launches: B4 once a layer in each decode step, B1
    for the four matmuls of each layer and the head in each step and the
    head once a prefill window, B12 once a layer and B5 four times a layer
    in each window of its route, B2 and B3 in the int8 windows; nothing
    else, and never the dequant path."""
    want = dict(B1=(4 * n_layer + 1) * BENCH_STEPS + BENCH_WINDOWS,
                B4=n_layer * BENCH_STEPS, B12=n_layer * BENCH_WINDOWS,
                B5=4 * n_layer * BENCH_WINDOWS // 2, dequant=0,
                **{k: 0 for k in OFF_BENCH_PATH})
    got = {k: n[k] for k in want}
    require(got == want, f"bench_torch {dims} launches {got}, not {want}")
    require(n["B2"] > 0 and n["B3"] > 0,
            f"bench_torch {dims}: no int8 prefill kernels ({n})")


def bench_path(torch, tmp, model_path):
    """Phase 11: bench_torch.py at 7B and 13B (--dims=13b: the 13B session);
    tools_torch/bench_q4_floor.py (B13, B14, B1, B15 and B17 at its defaults K 4096,
    N 12288, M 8) in this process, every count set to 0 just before and
    read just after; the other tools at a small depth and examples_torch/
    python/example-batch.py and perplexity.py on phase 10's 2-layer q4_0
    GGJT. bench_torch.py and the bench_* tools run as subprocesses alone on
    the card (so the times they print are uncontended); the profilers and
    the examples, whose times nothing records, run together (their
    processes reach the card in parallel; the times they print are
    contended). Each must exit 0 and must have launched the kernels of its
    path, and none but bench_kernels (which holds B1 against it) the
    dequant path; its launches are counted in its own process
    (COUNTED)."""
    import contextlib
    import io
    from fastllama_tpu_torch.config import PRESETS
    from fastllama_tpu_torch.kernels import q4_floor as qf
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from tools_torch import bench_q4_floor
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    res = {"bench": {}, "tools": {}}
    for dims, preset in (("7b", "7B"), ("13b", "13B")):
        rc, out, err, sec, n = run_counted(
            "bench_torch.py", ["--dims=13b"] if dims == "13b" else [], root,
            timeout=400.0)
        print(f"bench_torch {dims} ({sec:.1f} s): stderr tail:\n"
              + "\n".join(err.strip().splitlines()[-15:]), flush=True)
        require(rc == 0, f"bench_torch {dims} exited {rc}: {err[-2000:]}")
        line = bench_line(out, dims)
        require(n is not None, f"bench_torch {dims} printed no launches")
        bench_launches(n, PRESETS[preset].n_layer, dims)
        dev_ms = [ln for ln in err.splitlines()
                  if ln.startswith("device_ms_per_token")]
        res["bench"][dims] = dict(line=line, seconds=sec, launches=n,
                                  device_ms_per_token=dev_ms[-1] if dev_ms
                                  else None)
        print(f"bench_torch {dims}: {json.dumps(line)}", flush=True)

    # its default modes floor, nosc, v0, v1 and v3
    floor_modes = {"B13": qf.q4_floor, "B14": qf.q4_nosc,
                   "B1": qm.q4_matmul_decode,
                   "B15": variant_kernels()["B15"],
                   "B17": variant_kernels()["B17"]}
    for fn in floor_modes.values():
        fn.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_q4_floor.main([])
    launches = {k: fn.launches for k, fn in floor_modes.items()}
    print(buf.getvalue(), end="", flush=True)
    require(rc == 0, f"bench_q4_floor exited {rc}")
    require(all(launches.values()), f"bench_q4_floor launches {launches}")
    res["q4_floor"] = dict(json.loads(buf.getvalue().strip().splitlines()[-1]),
                           launches_counted=launches)

    text = os.path.join(tmp, "perplexity.txt")
    with open(text, "w") as fh:
        fh.write(prompt_of(3000, seed=11))
    ex = os.path.join("examples_torch", "python")
    runs = [(os.path.join("tools_torch", t), a, want)
            for t, a, want in BENCH_TOOLS] + [
        (os.path.join(ex, "example-batch.py"), [model_path], ("B1", "B4")),
        (os.path.join(ex, "perplexity.py"), [model_path, text],
         ("B2", "B3", "B12"))]
    alone = [r for r in runs if os.path.basename(r[0]).startswith("bench_")]
    results = [(r, run_counted(r[0], r[1], root)) for r in alone]
    started = [(r, start_counted(r[0], r[1], root))
               for r in runs if r not in alone]
    results += [(r, finish_counted(st)) for r, st in started]
    for (script, args, want), (rc, out, err, sec, n) in results:
        label = " ".join([script] + args).replace(
            model_path, "<2-layer q4_0 GGJT>").replace(text, "<text>")
        tail = "\n".join(out.strip().splitlines()[-6:])
        print(f"{label} ({sec:.1f} s, exit {rc}, launches {n}):\n{tail}",
              flush=True)
        require(rc == 0, f"{label} exited {rc}: {err[-2000:]}")
        require(n is not None and all(n[k] > 0 for k in want),
                f"{label}: launches {n}, none of some of {want}")
        require("bench_kernels" in script or n["dequant"] == 0,
                f"{label}: the dequant path ran {n['dequant']} times")
        res["tools"][label] = dict(seconds=sec, stdout=out, launches=n)
    ppl = res["tools"][next(k for k in res["tools"] if "perplexity" in k)]
    require("Final perplexity:" in ppl["stdout"],
            "perplexity.py printed no perplexity")
    # each kernel's launches over the whole bench path
    res["launches"] = {
        k: sum(r["launches"][k] for r in list(res["bench"].values())
               + list(res["tools"].values())) + launches.get(k, 0)
        for k in res["bench"]["7b"]["launches"] if k != "dequant"}
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
            ("q4_fold_kernel", "attn_split_kernel"))
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
            ("attn_split_kernel", "q4_fold_kernel"))
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


def engine_requests(sched, prompts=ENG_PROMPTS, gen=ENG_GEN, **kw):
    return [sched.Request(prompt=prompt_of(n - 2, seed=100 + i),
                          max_tokens=gen, **kw)
            for i, n in enumerate(prompts)]


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
               **req_kw):
    """One engine, ENG_PROMPTS through it, with every launch counted (a
    paged engine steps through the fused step on every layer, with q/k/v
    LoRA terms too; never B7 or B6). Returns (token streams, result
    row)."""
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
        require(counts["PS"] > 0 and counts["B6"] == counts["B7"] == 0
                and counts["PS"] % n_layer == 0
                and counts["B4"] == 0 and counts["B10"] == 0,
                f"engine {label}: decode launches {counts}")
        require(counts["B8"] == (n_layer * len(reqs) if chunked else 0),
                f"engine {label}: B8 launched {counts['B8']} times")
        steps = counts["PS"] // n_layer
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


def engine_steady(torch, sched, make, profile_steps=8, timed_steps=30,
                  prompt_chars=98, counted=None):
    """Eight slots decoding at once, no admission in the window: the host
    clock per engine step (ending in a synchronize) and, from a
    torch.profiler trace of a few more steps, the device time per step.
    Prompts of prompt_chars + 2 tokens. counted = (key, kernel name): that
    wrapper's launches a step in the profiled steps beside the profile's
    calls of the kernel, and the kernel's time and share of the device
    time. The profiler loses launches late in a long process: a trace
    whose calls of the kernel fall short of the count is taken again (up
    to three traces), and if the last still falls short the kernel's time
    is its time a launch times the counted launches (kernel_ms_source
    says which)."""
    from torch.profiler import ProfilerActivity, profile
    eng = make()
    reqs = [sched.Request(prompt=prompt_of(prompt_chars, seed=200 + i),
                          max_tokens=300, temp=0.8) for i in range(ENG_SLOTS)]
    for r in reqs:
        eng.submit(r)
    while sum(s.live for s in eng.slots) < ENG_SLOTS:
        eng.step()
    for _ in range(10):
        eng.step()
    torch.cuda.synchronize()
    def replays():
        return sum(g.replays for g in eng._graphs.entries("decode"))
    before = None if eng._graphs is None else replays()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        eng.step()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / timed_steps * 1e3
    out = dict(ms_per_step=ms_step, tok_s=ENG_SLOTS / ms_step * 1e3)
    if before is not None:
        out["replays_per_step"] = (replays() - before) / timed_steps
    for attempt in range(3 if profile_steps else 0):
        if counted:
            wrapper = every_kernel()[counted[0]]
            before = wrapper.launches
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
        if not counted:
            break
        mine = [k for k in out.get("kernels", ()) if counted[1] in k["name"]]
        n_counted = (wrapper.launches - before) / profile_steps
        n_profiled = sum(k["calls_per_step"] for k in mine)
        out.update(counted_per_step=n_counted, profiled_per_step=n_profiled,
                   profile_attempts=attempt + 1)
        if n_profiled == n_counted or dev_ms <= 0:
            break
    if counted and profile_steps and dev_ms > 0 and n_profiled > 0:
        # a trace that lost launches of the counted kernel is retaken; if
        # the last one still lacks some, its time a launch is scaled to
        # the counted launches, and the device total takes the difference
        kernel_ms = sum(k["ms_per_step"] for k in mine)
        if n_profiled == n_counted:
            out["kernel_ms_source"] = "profile"
        else:
            scaled = kernel_ms / n_profiled * n_counted
            out["device_ms_per_step"] = dev_ms = dev_ms + scaled - kernel_ms
            out["device_idle_share"] = 1.0 - dev_ms / ms_step
            kernel_ms = scaled
            out["kernel_ms_source"] = ("profile's ms a launch x counted "
                                       "launches")
        out["kernel_ms_per_step"] = kernel_ms
        out["kernel_share"] = kernel_ms / dev_ms
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

    # the paged step of layers with q/k/v LoRA terms (rank 8 on wq and wv
    # of both layers): the fused step on every layer, the terms added into
    # the fused projection first; bf16, greedy
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
        "paged LoRA 2 layers greedy", hp2.n_layer, False, temp=0.0)
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
    """B1 (M = 1, 8; bf16, and v0h untimed), B3 (M = 512, 256; bit for
    bit, with B2) and B5 (M = 128, 512; bf16) on the q4_0 planes a rank
    holds at tp = 2 and 4, and B9 (M = 1, 8; bf16) on the q4_1 planes,
    against their plain
    versions as on the whole planes; each timed over cycled copies of the
    plane, the plain version and the bound beside it."""
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.kernels import q4_variants as qv
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
                    ms = time_ms(run, calls=2 * len(ws))
                    plain_ms = (time_ms(plain, calls=2)
                                if m in (1, 512) else None)
                    bnd, by = bound_ms(nbytes, 2.0 * m * k * n, kind)
                    row = dict(kernel=key, m=m, shape=label, max_abs_err=err,
                               tol=tol, ms=ms, plain_ms=plain_ms,
                               bound_ms=bnd, bound_by=by,
                               bound_share=bnd / ms)
                    rows.append(row)
                    print(f"shard-local {row}", flush=True)
                    if key == "B1":
                        row = dict(check_v0h(torch, qm, qv, x, w,
                                             f"tp={tp} {name}"),
                                   kernel="B1", m=m)
                        rows.append(row)
                        print(f"shard-local {row}", flush=True)
                del ws, w, wd


def check_shard_attention(torch, dev, gen, results):
    """B4 and B10 at the heads a rank holds at tp = 2 and 4 (16 and 8): at
    B = 1 (the TP session) at no rows, one, the 64-row edges, the last row
    and past S (an inactive slot), and at B = 8 (the slab
    engine's step) with per-slot depths, one of them past S; bf16 and f32
    caches (check_attention_heads)."""
    s_len = ENG_CTX
    depth_sets = {1: [[n] for n in (0, 1, 63, 64, 65, 300, 511,
                                    s_len + 88)],
                  ENG_SLOTS: [[0, 1, 63, 64, 300, 511, s_len + 1, 200],
                              [300] * ENG_SLOTS]}
    rows = results.setdefault("shard_local", [])
    for tp in SHARD_TPS:
        check_attention_heads(torch, dev, gen, rows, f"tp={tp}", 32 // tp,
                              depth_sets)


def check_attention_heads(torch, dev, gen, rows, tag, h, depth_sets):
    """B4 and B10 at h heads of 128 over 512-row caches, B slots each at
    the depths of depth_sets {B: [depths, ...]}, bf16 and f32 caches: held
    against their plain versions at the whole-width rows' tolerances (B4:
    output within 2^-7 (bf16) or 5e-5 (f32) of the largest output, caches
    bit for bit, the same result twice; B10: within 5e-5); timed on bf16
    caches where every slot is at 300 rows, over cycled caches. One row a
    kernel and case, labelled with `tag`, appended to rows."""
    from fastllama_tpu_torch.kernels import decode_attention as da
    s_len, d = ENG_CTX, 128
    scale = 1 / math.sqrt(d)
    kw4 = dict(head_dim=d, n_rot=d, scale=scale)
    f = h * d
    for b, sets in depth_sets.items():
        for dt in (torch.bfloat16, torch.float32):
            kind = "bf16" if dt == torch.bfloat16 else "f32"
            kc, vc = (torch.randn((b, s_len, f), generator=gen,
                                  device=dev).to(dt) for _ in range(2))
            for depths in sets:
                label = f"{tag} B={b} S={s_len} H={h} d={d} " \
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
                    print(f"{tag} {row}", flush=True)
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
    out = dict(ms=time_ms(run4, calls=4 * n),
               plain_ms=time_ms(lambda: da.decode_attention_fused_plain(
                   qkv, kc.clone(), vc.clone(), npv, cos, sin, **kw4),
                   calls=2),
               bound_ms=bnd4, bound_by=by4,
               b10=dict(ms=time_ms(run10, calls=4 * n),
                        plain_ms=time_ms(lambda: da
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
# the worlds' depth: a q4_0 GGJT of PAR_LAYERS 7B-wide layers (written
# here), PAR_DECODE greedy tokens of the TP session, SP_DECODE of the SP
# one, and engines of PAR_PROMPTS (eight fill the slots, two admissions
# while they decode) with PAR_GEN tokens each. A mesh step is eager and
# stages every collective through the host, a cost a layer and a token:
# this phase is host-bound, so its depth is its time
PAR_LAYERS, PAR_DECODE = 2, 16
SP_CTX, SP_PROMPT, SP_DECODE = 2048, 1024, 8
PAR_PROMPTS, PAR_GEN = ENG_PROMPTS[:10], 16
SHARED = "ranks sharing one H100 (time-sliced; not a TP speed)"
# bf16 mesh engines: streams of the ten that may leave the one-card
# engine's greedy stream after their first token
ENG_BF16_SLACK = 2
# the run of the (1, 2) world whose launches a kernel's line reports
TP_PART = {"B1": "int8", "B2": "int8", "B3": "int8", "B4": "int8",
           "B5": "bf16_exact", "B9": "lora",
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
    """PAR_PROMPTS through a greedy BatchEngine of 8 slots (n_ctx 512, pages
    of 64 rows), PAR_GEN tokens each: streams, free pages by dp group,
    launches, ms a token."""
    from fastllama_tpu_torch.engine import scheduler as sched
    eng = sched.BatchEngine(hp, params, vocab, n_slots=ENG_SLOTS,
                            n_ctx=ENG_CTX, rcfg=rcfg, kv_mode=mode,
                            page_size=ENG_PS, temp=0.0)
    reqs = engine_requests(sched, PAR_PROMPTS, PAR_GEN)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [list(r.tokens_out) for r in reqs]
    require(all(r.done and len(t) == PAR_GEN for r, t in zip(reqs, streams)),
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
    """World (1, 2): the TP session on the PAR_LAYERS q4_0 file (int8
    prefill, then the bf16-exact prefill; PAR_DECODE greedy tokens; save),
    TP + LoRA on the
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
    first, stream, ms = _session_run(torch, model.session, prompt,
                                     PAR_DECODE)
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
    prompt in n_batch 512 chunks, SP_DECODE greedy tokens) and the engine
    with dp 2, paged and slab."""
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


def parallel_path(torch, tmp, q41):
    """Phase 10: the port's multi-GPU serving in spawned worlds of ranks
    that share the card (gloo; NCCL refuses two ranks on one device), each
    held against the one-card run of the same file: a q4_0 GGJT of
    PAR_LAYERS layers written here (its path in res["q4_0_path"]) and
    phase 5's 2-layer q4_1 GGJT. Budget about 100 s."""
    import dataclasses
    import fastllama_tpu_torch
    from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
    from fastllama_tpu_torch.engine.session import FastLlama
    from fastllama_tpu_torch.io.ggml_writer import write_ggla
    from fastllama_tpu_torch.models.loader import load_model
    from fastllama_tpu_torch.models.runtime import LlamaModel
    res = {"backend": "gloo", "note": SHARED}
    print(f"parallel: backend gloo, worlds (data, model) (1, 2), (2, 1), "
          f"(2, 2); every rank on cuda:0 ({SHARED})", flush=True)
    q40 = res["q4_0_path"] = os.path.join(tmp, "ggjt_q4_0_par")
    write_ggjt_file(q40, dataclasses.replace(PRESETS["7B"],
                                             n_layer=PAR_LAYERS),
                    6, affine=False)

    # one-card references on the same files
    quiet = fastllama_tpu_torch.Logger()
    one = fastllama_tpu_torch.Model(path=q40, n_ctx=512, n_batch=512,
                                    logger=quiet)
    prompt = prompt_of(N_PROMPT - 2, seed=4)
    ref_first, ref_stream, ref_ms = _session_run(torch, one.session, prompt,
                                                 PAR_DECODE)
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
            full = sum(p == PAR_GEN for p in pre)
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
                and r["lora"]["launches"]["B4"] > 0
                and r["lora"]["launches"]["B10"] == 0,
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


# ---------------------------------------------------------------------------
# phase 12: the compiled decode step (CUDA graphs)
# ---------------------------------------------------------------------------

GRAPH_STEPS = 64
# ten requests through the eight slots: two admissions while others decode
GRAPH_PROMPTS = [300, 40, 270, 120, 20, 260, 90, 60, 30, 100]
GRAPH_GEN = 24


def eager_route(model):
    """Take a model's or an engine's graphs off: its windows and decode
    steps, or its admissions and decode steps, then run eagerly, as under a
    mesh (the route the graphs replaced)."""
    model._graphs = None
    return model


def graph_session(torch, hp, params, dev, prompt):
    """The session's decode step replayed (forward_jit_decode) against the
    eager forward (int n_past) from the same cache state: GRAPH_STEPS
    greedy steps with the same token into both models, logits bit-equal at
    every step (same kernels, same order, same inputs). Then host and
    device ms a token of FastLlama.generate on each route."""
    from fastllama_tpu_torch.engine.tokenizer import tokenize
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    (ga, sa), (gb, sb) = (make_session(hp, params, dev) for _ in range(2))
    eager_route(gb)
    ids = tokenize(ga.vocab, " " + prompt, bos=True)
    first = [m.eval(0, ids) for m in (ga, gb)]
    require(np.array_equal(*first), "graphs: the two prefills differ")
    reset_counts(qm, da)
    tok, n = int(np.argmax(first[0])), len(ids)
    for i in range(GRAPH_STEPS):
        la, lb = ga.eval(n + i, [tok]), gb.eval(n + i, [tok])
        require(np.array_equal(la, lb), f"graphs: step {i}: replayed logits "
                f"differ from eager (max |diff| {np.abs(la - lb).max()})")
        tok = int(np.argmax(la))
    counts = read_counts(qm, da)
    # a step: four matmuls a layer and the head (B1), B4 once a layer
    per_step = {"q4_matmul_decode": 4 * hp.n_layer + 1,
                "decode_attention_fused": hp.n_layer}
    want = {"B1": 2 * per_step["q4_matmul_decode"] * GRAPH_STEPS,
            "B4": 2 * hp.n_layer * GRAPH_STEPS}
    require({k: counts[k] for k in want} == want, f"graphs: launches of "
            f"both routes {counts}, expected {want}")
    step = ga._graphs.last
    require(ga._graphs.entries("decode") == [step] and step.captures == 1
            and step.replays == GRAPH_STEPS - 1,
            f"graphs: {step.captures} captures, {step.replays} replays")
    per_replay = step.launches_per_replay()
    require(per_replay == per_step, f"graphs: a replay holds {per_replay}")
    # host clock (generate, median of 2 runs a route, in turns) and the
    # device time of 8 more steps
    runs = {"graph": [], "eager": []}
    for route in ("graph", "eager", "eager", "graph"):
        runs[route].append(timed_run(torch, sa if route == "graph" else sb,
                                     prompt))
    require(runs["graph"][0][2] == runs["eager"][0][2],
            "graphs: greedy streams differ between the routes")
    # host cost of a replay's key: walking the state the step reads
    from fastllama_tpu_torch.utils.step_graph import reached
    t0 = time.perf_counter()
    for _ in range(100):
        tuple(map(id, reached((ga.params, ga.kv, ga._tables))))
    key_us = (time.perf_counter() - t0) / 100 * 1e6
    out = dict(steps_bit_equal=GRAPH_STEPS, launches_per_replay=per_replay,
               key_walk_us=key_us)
    for route, sess in (("graph", sa), ("eager", sb)):
        ms = [r[1] / N_DECODE * 1e3 for r in runs[route]]
        prof = profile_decode(torch, sess, n_steps=8)
        busy = prof.get("device_ms_per_token")
        out[route] = dict(
            decode_ms_per_token=float(np.median(ms)),
            decode_ms_per_token_runs=ms,
            ttft_ms_runs=[r[0] for r in runs[route]],
            device_ms_per_token=busy,
            device_idle_share=(None if busy is None else
                               1.0 - busy / float(np.median(ms))))
    print(f"graphs session: {json.dumps(out)}", flush=True)
    return out


def graph_engine(torch, hp, params, vocab):
    """The engine's step graph, paged and slab, against the eager step
    (the engine with its graph taken off): streams equal at temp 0 and at
    temp 0.8 with one seed, at drain depth 2 (phase 13 holds depth 0),
    one capture a run;
    then the steady window on both routes (host ms a step, device ms and
    launches a step from a profile, replays a step)."""
    from fastllama_tpu_torch.config import RuntimeConfig
    from fastllama_tpu_torch.engine import scheduler as sched
    rcfg = RuntimeConfig(n_ctx=ENG_CTX, n_batch=512, kv_dtype="bfloat16",
                         weight_dtype="bfloat16")

    def make(mode, depth=None, graph=True):
        def build():
            eng = sched.BatchEngine(
                hp, params, vocab, n_slots=ENG_SLOTS, n_ctx=ENG_CTX,
                rcfg=rcfg, sampling_seed=5, kv_mode=mode, page_size=ENG_PS,
                drain_depth=depth)
            return eng if graph else eager_route(eng)
        return build

    def streams(build, temp):
        eng = build()
        reqs = [sched.Request(prompt=prompt_of(n - 2, seed=500 + i),
                              max_tokens=GRAPH_GEN, temp=temp)
                for i, n in enumerate(GRAPH_PROMPTS)]
        eng.run(reqs)
        require(all(len(r.tokens_out) == GRAPH_GEN for r in reqs),
                "graphs engine: a request did not run its length")
        return eng, [r.tokens_out for r in reqs]

    out = {"equal_streams": []}
    # drain depth 2 here; phase 13's engine runs hold depth 0 (paged and
    # slab, temp 0 and 0.8, the same replayed steps and admissions)
    for mode in ("paged", "slab"):
        for depth in (2,):
            for temp in (0.0, 0.8):
                eng, got = streams(make(mode, depth), temp)
                _, want = streams(make(mode, depth, graph=False), temp)
                label = f"{mode} depth {depth} temp {temp}"
                require(got == want, f"graphs engine {label}: the replayed "
                        "streams differ from the eager step's")
                decode = [g.captures for g in eng._graphs.entries("decode")]
                require(decode == [1], f"graphs engine {label}: decode "
                        f"step captures {decode} in one run")
                out["equal_streams"].append(label)
    for mode in ("paged", "slab"):
        for route in ("graph", "eager"):
            row = engine_steady(torch, sched,
                                make(mode, graph=route == "graph"))
            out[f"steady_{mode}_{route}"] = row
            print(f"graphs engine steady {mode} {route}: {json.dumps(row)}",
                  flush=True)
        require(out[f"steady_{mode}_graph"]["replays_per_step"] == 1.0,
                f"graphs engine {mode}: not one replay a step")
    return out


def graphs_path(torch, dev, gen):
    """Phase 12: the compiled decode step at full 7B width and depth."""
    from fastllama_tpu_torch.config import PRESETS
    hp = PRESETS["7B"]
    params = rand_params(torch, hp, gen, dev)
    res = {"n_layer": hp.n_layer,
           "session": graph_session(torch, hp, params, dev,
                                    prompt_of(N_PROMPT - 2, seed=1)),
           "engine": graph_engine(torch, hp, params,
                                  synthetic_vocab(hp.n_vocab))}
    print(f"graphs path: {json.dumps(res)}", flush=True)
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 13: the compiled prefill windows and admissions (CUDA graphs)
# ---------------------------------------------------------------------------

# the session's (n_batch, int8 prefill) configurations: one 512-row window
# or five of 64 rows for the 300-token prompt
WINDOW_CONFIGS = ((512, True), (512, False), (64, True), (64, False))


def recorded_evals(model) -> list:
    """Every eval's logits of `model` from now on (a copy each)."""
    out = []
    inner = model.eval

    def ev(*a, **k):
        r = inner(*a, **k)
        out.append(r.copy())
        return r
    model.eval = ev
    return out


def graph_windows(torch, hp, params, dev, n_batch, int8, extras):
    """One session configuration on both routes (two models, the second's
    graphs taken off): the 300-token TTFT and 64 greedy tokens twice a
    route in turns, every window's and step's logits bit-equal between
    the routes and the streams equal; the TTFT window's device ms on each
    route from a profile; the window graphs' captures, replays, build
    seconds and pool. extras: also a window after load_state and a
    generation that recycles the context, both bit-equal."""
    t_config = time.perf_counter()
    (ga, sa), (gb, sb) = (make_session(hp, params, dev, n_batch=n_batch,
                                       prefill_int8=int8) for _ in range(2))
    eager_route(gb)
    label = f"n_batch {n_batch} {'int8' if int8 else 'bf16-exact'}"
    prompt = prompt_of(N_PROMPT - 2, seed=1)
    for sess in (sa, sb):
        warm_up(sess, prompt)
    rec = {"graph": recorded_evals(ga), "eager": recorded_evals(gb)}
    runs = {"graph": [], "eager": []}
    for route in ("graph", "eager", "eager", "graph"):
        rec[route].clear()
        r = timed_run(torch, sa if route == "graph" else sb, prompt)
        runs[route].append((r, list(rec[route])))
    (g, gl), (e, el) = runs["graph"][0], runs["eager"][0]
    n_windows = -(-N_PROMPT // n_batch)
    require(len(gl) == len(el) == n_windows + N_DECODE
            and all(np.array_equal(a, b) for a, b in zip(gl, el)),
            f"prefill graphs {label}: replayed logits differ from eager")
    require(g[2] == e[2], f"prefill graphs {label}: greedy streams differ")
    out = dict(windows=n_windows, evals_bit_equal=len(gl))
    for route, sess in (("graph", sa), ("eager", sb)):
        ttft = [r[0][0] for r in runs[route]]
        prof = profile_prefill(torch, sess, prompt)
        out[route] = dict(ttft_ms=float(np.median(ttft)), ttft_ms_runs=ttft,
                          window_device_ms=prof.get("device_ms"),
                          window_launches=prof.get("launches"))
    cache = ga._graphs
    out["graphs"] = dict(captures=cache.captures, replays=cache.replays,
                         evictions=cache.evictions, build_s=cache.build_s,
                         pool_bytes=cache.pool_bytes(),
                         boundary_windows=ga.boundary_windows)
    if extras:
        state = ga.kv_state()
        n = state["kv_k"].shape[2]
        ids = [int(x) for x in np.random.default_rng(3).integers(
            3, hp.n_vocab, 40)]
        after = []
        for m in (ga, gb):
            m.reset()
            m.load_kv_state(state)
            after.append(m.eval(n, ids))
        require(np.array_equal(*after), f"prefill graphs {label}: the "
                "window after load_state differs from eager")
        streams = []
        for sess in (sa, sb):
            sess.reset()
            out_tok = []
            require(sess.ingest(prompt) and sess.generate(
                out_tok.append, num_tokens=240, temp=0.0),
                "recycling generate failed")
            streams.append((list(sess._last_n), sess.n_past))
        require(streams[0] == streams[1] and streams[0][1] < N_PROMPT + 240,
                f"prefill graphs {label}: the recycling streams differ or "
                f"did not recycle ({streams[0][1]}, {streams[1][1]})")
        out.update(load_state_window_bit_equal=True,
                   recycle_streams_equal=True,
                   graphs_after_extras=dict(
                       captures=cache.captures, replays=cache.replays,
                       boundary_windows=ga.boundary_windows))
    out["seconds"] = time.perf_counter() - t_config
    print(f"prefill graphs session {label}: {json.dumps(out)}", flush=True)
    del sa, sb, ga, gb
    return out


def graph_admissions(torch, hp, params, vocab):
    """The engine (8 slots, n_ctx 512, pages of 64 rows) with its
    admissions replayed against the same engine with every graph taken
    off: phase 6's twelve requests (20-300 prompt tokens, 48 tokens each)
    with top_p 0.95 or 1 and repeat_penalty 1 or 1.1 mixed among them,
    paged, paged chunked and slab, at temp 0 and then 0.8 (one seed) on
    one engine a route, streams equal, the wall time of run() on both
    routes, and the admission graphs' keys (one a bucket, or the chunk and
    the splice: the knobs make none) with no eviction; then one 300-token
    admission into the idle engine on both routes, each engine step until
    its first streamed token on the host clock and in a profile
    (tools_torch/engine_admission.admit_once)."""
    from fastllama_tpu_torch.config import RuntimeConfig
    from fastllama_tpu_torch.engine import scheduler as sched
    from tools_torch.engine_admission import admission_graphs, admit_once

    def make(mode, chunked, graph):
        rcfg = RuntimeConfig(n_ctx=ENG_CTX, n_batch=256 if chunked else 512,
                             kv_dtype="bfloat16", weight_dtype="bfloat16")
        eng = sched.BatchEngine(
            hp, params, vocab, n_slots=ENG_SLOTS, n_ctx=ENG_CTX, rcfg=rcfg,
            sampling_seed=3, kv_mode=mode, page_size=ENG_PS,
            chunked_admission=chunked)
        return eng if graph else eager_route(eng)

    def requests(temp):
        reqs = engine_requests(sched, temp=temp)
        for i, r in enumerate(reqs):
            r.top_p = (0.95, 1.0)[i % 2]
            r.repeat_penalty = (1.0, 1.1)[i // 2 % 2]
        return reqs

    out = {}
    for name, mode, chunked in (("paged", "paged", False),
                                ("paged_chunked", "paged", True),
                                ("slab", "slab", False)):
        t_mode = time.perf_counter()
        row = {}
        engs = {route: make(mode, chunked, route == "graph")
                for route in ("graph", "eager")}
        for temp in (0.0, 0.8):
            got = {}
            for route, eng in engs.items():
                reqs = requests(temp)
                if route == "graph":
                    greqs = reqs
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run(reqs)
                torch.cuda.synchronize()
                got[route] = [r.tokens_out for r in reqs]
                row[f"run_wall_s_temp_{temp}_{route}"] = \
                    time.perf_counter() - t0
            require(got["graph"] == got["eager"]
                    and all(len(t) == ENG_GEN for t in got["graph"]),
                    f"prefill graphs engine {name} temp {temp}: replayed "
                    "admissions stream otherwise than eager ones")
        geng = engs["graph"]
        adm = admission_graphs(geng)
        buckets = {next(b for b in geng._buckets if b >= r.n_prompt)
                   for r in greqs}
        want = 2 if chunked else len(buckets)
        require(adm["keys"] == want and adm["evictions"] == 0,
                f"prefill graphs engine {name}: admission graphs {adm}, "
                f"expected {want} keys and no eviction")
        row["admission_graphs"] = dict(adm, build_s=geng._graphs.build_s,
                                       pool_bytes=geng._graphs.pool_bytes())
        for route, eng in engs.items():
            admit_once(eng, 1, False)
            timed = [admit_once(eng, 2 + i, False) for i in range(2)]
            traced = admit_once(eng, 9, True)
            row[f"admission_{route}"] = dict(
                host_ms_per_step_runs=[[s[0] for s in r] for r in timed],
                device_ms_per_step=[s[1] for s in traced],
                launches_per_step=[s[2] for s in traced])
        del engs, geng
        row["seconds"] = time.perf_counter() - t_mode
        out[name] = row
        print(f"prefill graphs engine {name}: {json.dumps(row)}", flush=True)
    return out


def prefill_graphs_path(torch, dev, gen):
    """Phase 13: the compiled prefill windows and admissions at full 7B
    width and depth (32 layers, q4_0, bf16, n_ctx 512)."""
    from fastllama_tpu_torch.config import PRESETS
    hp = PRESETS["7B"]
    params = rand_params(torch, hp, gen, dev)
    res = {"n_layer": hp.n_layer, "sessions": {}}
    for n_batch, int8 in WINDOW_CONFIGS:
        res["sessions"][f"n_batch_{n_batch}_{'int8' if int8 else 'bf16'}"] \
            = graph_windows(torch, hp, params, dev, n_batch, int8,
                            extras=(n_batch, int8) == (64, True))
        torch.cuda.empty_cache()
    res["engine"] = graph_admissions(torch, hp, params,
                                     synthetic_vocab(hp.n_vocab))
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 14: the q4 matmul variants (B15-B19) and the kernel switches
# ---------------------------------------------------------------------------

# v0h (B1 with 2-byte scales) at these rows
VARIANT_ROWS = (1, 8, 64)
# B15-B18 (v1, v2, v3, v7 and their h forms) at row counts that take their
# kernel's plans apart: M <= 8 (8 rows of x, mma.sync), two m-tiles a
# warpgroup (M <= 32) and one (M > 32), up to the 64 rows of one product
FOLD_ROWS = (1, 8, 16, 33, 64)
FOLD_KEYS = ("v1", "v1h", "v2", "v2h", "v3", "v3h", "v7", "v7h")
# the decode variants held in phase 14 and their kernels (v0h: B1 with
# 2-byte scales); v4 and v5 run B15 as v1 does
VARIANT_KEYS = {"v1": "B15", "v2": "B16", "v3": "B17", "v7": "B18",
                "v0h": "B1", "v1h": "B15", "v2h": "B16", "v3h": "B17",
                "v7h": "B18"}
SWITCH_GEN = 32              # greedy tokens of the use_pallas=False session
PALLAS_GEN = 8               # greedy tokens of the use_pallas=True session


def variant_kernels():
    from fastllama_tpu_torch.kernels import q4_variants as qv
    return {"B15": qv.q4_decode_v1, "B16": qv.q4_decode_v2,
            "B17": qv.q4_decode_v3, "B18": qv.q4_decode_v7,
            "B19": qv.q4_prefill_int8_natx}


def every_kernel():
    """Every counted wrapper by its table name: B1-B21, PS, RW and B21F
    (the fused B21 step)."""
    from fastllama_tpu_torch.engine import paged_kv as pk
    from fastllama_tpu_torch.kernels import q4_floor as qf
    from fastllama_tpu_torch.kernels import q4_variants as qv
    return dict(all_kernels(), B13=qf.q4_floor, B14=qf.q4_nosc,
                **variant_kernels(), B20=qv.q4_prefill_split,
                B21=pk.paged_attention_tpu,
                B21F=pk.paged_attention_tpu_fused)


def reset_every_count():
    for fn in every_kernel().values():
        fn.launches = 0


def check_variants(torch, dev, gen, results):
    """B15-B18 and the h forms (bf16 scales; v0h is B1 with them, variant
    0's 2-byte-scale build)
    on the 7B planes qkv, wo, w13 and w2 and the 13B qkv plane: B15-B18
    (csrc/q4_fold.cuh, a build each) at FOLD_ROWS on every one, with their
    plan, v0h at VARIANT_ROWS on the 7B planes and M = 8 on the 13B one.
    Each within 1e-5 of sum |R(x)| (q + 8) |d| of its plain version (only
    the f32 summation order differs), run twice and bit-equal, timed over
    weight copies cycled past the L2 (v0h at M = 1 and 8) beside B1 (v0,
    variant 0 of the same kernel), B13 and B14 (the fold kernel's probes on B15's
    plan; on the 7B planes at VARIANT_ROWS) and _weight_int4pack_mm on the
    same plane and M; plain versions timed on qkv at M = 8. B20 at
    M <= B20_ON_B15_MAX_M on qkv: one B20 launch (none of B15's),
    bit-equal to B15's kernel on the same inputs. B19 bit for bit on qkv at M = 512 and 256 and the 13B qkv at
    M = 512, timed beside B2 + B3 (nat) and torch._int_mm of its int8
    plane; at qkv M = 512 the kernels of one call from a profile (B2's and
    one product kernel, no requantization pass) and the memory it
    allocates (its outputs, no [N, K] int8 plane)."""
    from fastllama_tpu_torch.kernels import cuda_lib
    from fastllama_tpu_torch.kernels import q4_floor as qf
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.kernels import q4_variants as qv
    out = {k: [] for k in ("B15", "B16", "B17", "B18", "B19", "B1h",
                           "B20_on_B15")}
    sms = cuda_lib.sm_count(dev)
    for plane, is_13b in [(p, False) for p in PLANES_7B[:4]] + [
            (PLANES_13B[0], True)]:
        name, k, n = plane
        w = rand_weight(torch, k, n, gen, dev)
        wbytes = weight_bytes(w)
        ws = [w] + [rand_weight(torch, k, n, gen, dev)
                    for _ in range(copies_for(wbytes) - 1)]
        sc16 = [ww.scales.to(torch.bfloat16) for ww in ws]
        packs = int4pack_packs(torch, ws)
        absum_w = (qv._codes(w.qs) + 8.0) * w.scales.abs().repeat_interleave(
            32, dim=0)
        n_st, nb = w.qs.shape[1], w.qs.shape[0] // 16
        for m in FOLD_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev)
            absum = (qm._pad_k(x.abs(), w.k).to(torch.bfloat16).float()
                     @ absum_w).max().item()
            it = iter(range(10**9))
            b1_ms = time_ms(lambda: qm.q4_matmul_decode(
                x, ws[next(it) % len(ws)]), calls=2 * len(ws))
            xk = qm._pad_k(x, w.k)
            probe_ms = {key: (time_ms(lambda fn=fn: fn(
                xk, ws[next(it) % len(ws)].qs), calls=2 * len(ws))
                if m in VARIANT_ROWS and not is_13b else None)
                for key, fn in (("b13_ms", qf.q4_floor),
                                ("b14_ms", qf.q4_nosc))}
            lib = int4pack_row(torch, packs, x,
                               qm.q4_matmul_dequant(x, w), n)
            for variant, key in VARIANT_KEYS.items():
                fold = variant in FOLD_KEYS
                if m not in (FOLD_ROWS if fold else (8,) if is_13b
                             else VARIANT_ROWS):
                    continue
                base, h = variant.rstrip("h"), variant.endswith("h")
                scs = sc16 if h else [ww.scales for ww in ws]

                def call(i):
                    return qv.q4_matmul_pallas(x, ws[i].qs, scs[i],
                                               variant=base)
                y, again = call(0), call(0)
                ref = qv.decode_plain(x, w.qs, scs[0], base)
                err = (y - ref).abs().max().item()
                tol = 1e-5 * absum
                label = f"{variant} {name} M={m} K={k} N={n}"
                require(bool(torch.isfinite(y).all()), f"{label}: not finite")
                require(err <= tol, f"{label}: err {err} > {tol}")
                require(torch.equal(y, again), f"{label}: not deterministic")
                # v0h timed at M = 1 and 8 (its rows of the table)
                ms = (time_ms(lambda: call(next(it) % len(ws)),
                              calls=2 * len(ws)) if fold or m in (1, 8)
                      else None)
                plain_ms = (time_ms(lambda: qv.decode_plain(
                    x, w.qs, scs[0], base), calls=2)
                    if m == 8 and name == "qkv" else None)
                nbytes = (w.qs.numel() + w.scales.numel() * (2 if h else 4)
                          + x.numel() * 4 + m * n_st * 4)
                bnd, by = bound_ms(nbytes, 2.0 * m * k * n, "bf16")
                row = dict(shape=f"{name} M={m} K={k} N={n}"
                           + (" bf16 scales" if h else ""), variant=variant,
                           max_abs_err=err, tol=tol, ms=ms,
                           plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                           b1_ms=b1_ms, **probe_ms, **lib)
                if ms:
                    row.update(bound_share=bnd / ms, vs_b1=ms / b1_ms)
                    if lib.get("library_ms"):
                        row["vs_library"] = ms / lib["library_ms"]
                if fold:
                    row["plan"] = qv.b15_plan(
                        m, n_st, nb, sms, h, qv.b15_capacity(dev))._asdict()
                out["B1h" if variant == "v0h" else key].append(row)
                print(f"{key} {row}", flush=True)
            if name == "qkv" and m <= qv.B20_ON_B15_MAX_M:
                # B20 takes B15's kernel at these M: counted as B20 alone
                before = (qv.q4_prefill_split.launches,
                          qv.q4_decode_v1.launches)
                y20 = qv.q4_prefill_split(x, w.qs, w.scales)
                require((qv.q4_prefill_split.launches,
                         qv.q4_decode_v1.launches) == (before[0] + 1,
                                                       before[1]),
                        f"B20 M={m}: launches not counted as B20's alone")
                require(torch.equal(y20, qv.q4_decode_v1(x, w.qs, w.scales)),
                        f"B20 M={m}: not B15's kernel's result")
                def b20(xx=x):
                    ww = ws[next(it) % len(ws)]
                    return qv.q4_prefill_split(xx, ww.qs, ww.scales)
                out["B20_on_B15"].append(dict(
                    shape=f"qkv M={m}", ms=time_ms(b20, calls=2 * len(ws))))
        del ws, w, sc16, packs, absum_w

    # B19: the int8 natx / split function
    for (name, k, n), rows in ((PLANES_7B[0], (512, 256)),
                               (PLANES_13B[0], (512,))):
        w = rand_weight(torch, k, n, gen, dev)
        wbytes = weight_bytes(w)
        ws = [w] + [rand_weight(torch, k, n, gen, dev)
                    for _ in range(copies_for(wbytes) - 1)]
        s8, sc = qv.natx_scales(w.scales)
        w8 = torch.round((qv._codes(w.qs) - 8.0)
                         * sc.repeat_interleave(32, dim=0)).to(torch.int8)
        w8_cm = w8.t().contiguous().t()
        for m in rows:
            x = torch.randn((m, k), generator=gen, device=dev) * 3.0
            y = qv.q4_prefill_int8_natx(x, w.qs, w.scales)
            ref = qv.q4_prefill_int8_natx_plain(x, w.qs, w.scales)
            label = f"B19 {name} M={m}"
            require(torch.equal(y, ref), f"{label}: not bit-exact (max err "
                    f"{(y - ref).abs().max().item()})")
            require(torch.equal(y, qv.q4_prefill_int8_natx(x, w.qs,
                                                           w.scales)),
                    f"{label}: not deterministic")
            xq, _ = qm.quant_rows_int8(x, w.k)
            acc = torch._int_mm(xq, w8_cm)
            require(torch.equal(acc.double(), qm.int8_accumulators(xq, w8)),
                    f"{label}: _int_mm is not the exact product")
            it = iter(range(10**9))

            def cycled(fn):
                ww = ws[next(it) % len(ws)]
                return fn(x, ww.qs, ww.scales)
            ms = time_ms(lambda: cycled(qv.q4_prefill_int8_natx),
                         calls=2 * len(ws))
            nat_ms = time_ms(lambda: cycled(qv.q4_matmul_prefill_int8),
                             calls=2 * len(ws))
            plain_ms = (time_ms(lambda: qv.q4_prefill_int8_natx_plain(
                x, w.qs, w.scales), calls=2) if name == "qkv" else None)
            bnd, by = bound_ms(x.numel() * 4 + wbytes + m * w.qs.shape[1] * 4,
                               2.0 * m * k * n, "int8")
            library_ms = time_ms(lambda: torch._int_mm(xq, w8_cm), calls=10)
            row = dict(shape=f"{name} M={m} K={k} N={n}", max_abs_err=0.0,
                       ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                       b2_b3_nat_ms=nat_ms, vs_b2_b3=ms / nat_ms,
                       library_ms=library_ms, vs_library=ms / library_ms,
                       library_call="torch._int_mm of the int8 plane (the "
                                    "product alone)")
            if name == "qkv" and m == 512:
                row.update(b19_call(torch, x, w))
            out["B19"].append(row)
            print(f"B19 {row}", flush=True)
        del ws, w, w8, w8_cm, s8, sc
    results.update(out)


def b19_call(torch, x, w):
    """What one B19 call launches and allocates: its kernels from a profile
    (B2's quant_rows_kernel and one product kernel, natx_cluster_kernel),
    and the bytes the allocator hands out during it (xq, dx and y; no int8
    [N, K] plane); and how many of its clusters the card holds at once."""
    from fastllama_tpu_torch.kernels import q4_variants as qv
    kernels = kernels_per_call(
        torch, lambda: qv.q4_prefill_int8_natx(x, w.qs, w.scales))
    require(sorted(kernels.values()) == [1, 1]
            and "natx_cluster_kernel" in kernels,
            f"B19: a call launches {kernels}, not B2's kernel and one "
            "product kernel")
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
    qv.q4_prefill_int8_natx(x, w.qs, w.scales)
    torch.cuda.synchronize()
    allocated = (torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
                 - before)
    m, k = x.shape
    n = w.qs.shape[1]
    outputs = m * k + 4 * m + 4 * m * n            # xq, dx, y
    require(allocated < outputs + n * k // 2,
            f"B19: a call allocated {allocated} bytes, its outputs "
            f"{outputs}: an [N, K] int8 plane is {n * k}")
    from fastllama_tpu_torch.kernels import cuda_lib
    clusters = cuda_lib.fn("q4_int8_natx_clusters")(m)
    require(clusters > 0, f"B19: cudaOccupancyMaxActiveClusters {clusters}")
    return dict(kernels_a_call=kernels, allocated_bytes_a_call=allocated,
                output_bytes=outputs, int8_plane_bytes=n * k,
                clusters_a_card=clusters)


def profile_variants_tool(torch):
    """tools_torch/profile_q4_variants.py with every variant name at its
    defaults (K 4096, N 12288, M 8), in this process, every count set to 0
    just before and read just after: each variant's kernels must have
    launched, and no variant's time (graph, or trace where it held every
    launch) may fall below its HBM bound."""
    import contextlib
    import io
    from tools_torch import profile_q4_variants as pqv
    reset_every_count()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = pqv.main(["4096", "12288", "8", *pqv.VARIANTS])
    finally:
        print(buf.getvalue(), end="", flush=True)
    counts = {k: fn.launches for k, fn in every_kernel().items()}
    require(rc == 0, f"profile_q4_variants exited {rc}")
    want = ("B1", "B2", "B3", "B5", "B13", "B14", "B15", "B16", "B17", "B18",
            "B19")
    require(all(counts[k] > 0 for k in want),
            f"profile_q4_variants launches {counts}")
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    # no call beats the HBM bound: its weights are cycled past the L2
    fast = [r["variant"] for r in line["profile_q4_variants"]
            if min(r["graph_us"], r["us"]) < r["bound_us"]]
    require(not fast, f"profile_q4_variants: {fast} below the HBM bound")
    return dict(rows=line["profile_q4_variants"], launches=counts)


def switch_session(torch, hp, params, dev, label, n_gen, eager=False,
                   env=None, **rcfg):
    """One session of the 7B model under RuntimeConfig(**rcfg) with the
    environment `env` set while it runs: reset, the 300-token prompt, the
    first token and n_gen - 1 more greedy tokens, every count 0 just before
    and read just after. Returns (counts, every eval's logits, tokens)."""
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        model, sess = make_session(hp, params, dev, **rcfg)
        if eager:
            eager_route(model)
        prompt = prompt_of(N_PROMPT - 2, seed=1)
        warm_up(sess, prompt)
        evals = recorded_evals(model)
        sess.reset()
        reset_every_count()
        require(sess.ingest(prompt), f"{label}: ingest failed")
        require(sess.generate(lambda s: None, num_tokens=n_gen, temp=0.0),
                f"{label}: generate failed")
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in every_kernel().items()}
        tokens = list(sess._last_n)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require(all(np.isfinite(e).all() for e in evals),
            f"{label}: logits not finite")
    del sess, model
    return counts, evals, tokens


def expect_counts(label, counts, want):
    """Exact launches: the kernels of `want` as given, every other 0."""
    full = {k: want.get(k, 0) for k in counts}
    require(counts == full, f"{label}: launches {counts}, expected {full}")


def switches_path(torch, dev, gen):
    """The kernel switches at full 7B width and depth: Model(use_pallas=
    False) (q4_matmul_xla's function: B1 for the decode matmuls and the
    window's head, B5 for the window's matmuls, no B2/B3) on the graph and
    the eager route, logits bit-equal; use_pallas=True (B15 in place of B1);
    and one window each under FASTLLAMA_PREFILL_INT8=0,
    FASTLLAMA_PREFILL_KERNEL=0 (B5, no B2/B3) and FASTLLAMA_PREFILL_INT8=1
    with use_pallas=False (int8 forced: B2 + B3)."""
    from fastllama_tpu_torch.config import PRESETS
    hp = PRESETS["7B"]
    params = rand_params(torch, hp, gen, dev)
    steps = SWITCH_GEN - 1                  # decode steps after the window
    layers = hp.n_layer
    # a 300-token window: four matmuls a layer at M = 300, B12 and (its
    # graph's) the slab row write of each layer, the head at M = 1; a decode
    # step: four matmuls a layer and the head at M = 1, B4 once a layer
    window = dict(B12=layers, RW=WINDOW_ROWS)
    decode_q4 = (4 * layers + 1) * steps + 1
    res = {}
    runs = {}
    for route in ("graph", "eager"):
        runs[route] = switch_session(
            torch, hp, params, dev, f"use_pallas=False {route}", SWITCH_GEN,
            eager=route == "eager", use_pallas=False)
        expect_counts(f"use_pallas=False {route}", runs[route][0], dict(
            window, B1=decode_q4, B5=4 * layers, B4=layers * steps,
            RW=WINDOW_ROWS if route == "graph" else 0))
    (gc, gl, gt), (_, el, et) = runs["graph"], runs["eager"]
    require(len(gl) == len(el) == SWITCH_GEN and all(
        np.array_equal(a, b) for a, b in zip(gl, el)),
        "use_pallas=False: replayed logits differ from the eager route's")
    require(gt == et, "use_pallas=False: greedy streams differ")
    res["use_pallas_false"] = dict(launches=gc, evals_bit_equal=len(gl))
    runs = {}
    for route in ("graph", "eager"):
        runs[route] = switch_session(
            torch, hp, params, dev, f"use_pallas=True {route}", PALLAS_GEN,
            eager=route == "eager", use_pallas=True)
        expect_counts(f"use_pallas=True {route}", runs[route][0], dict(
            window, B15=(4 * layers + 1) * (PALLAS_GEN - 1) + 1,
            B2=4 * layers, B3=4 * layers, B4=layers * (PALLAS_GEN - 1),
            RW=WINDOW_ROWS if route == "graph" else 0))
    (counts, gl, gt), (_, el, et) = runs["graph"], runs["eager"]
    require(len(gl) == len(el) == PALLAS_GEN and all(
        np.array_equal(a, b) for a, b in zip(gl, el)),
        "use_pallas=True: replayed logits differ from the eager route's")
    require(gt == et, "use_pallas=True: greedy streams differ")
    res["use_pallas_true"] = dict(launches=counts, evals_bit_equal=len(gl))
    t0 = time.perf_counter()
    res["device_times"] = pallas_device_times(torch, hp, params, dev)
    res["device_times"]["seconds"] = time.perf_counter() - t0
    bf16_window = dict(window, B5=4 * layers, B1=1)
    for env, rcfg, want in (
            ({"FASTLLAMA_PREFILL_INT8": "0"}, {}, bf16_window),
            ({"FASTLLAMA_PREFILL_KERNEL": "0"}, {}, bf16_window),
            ({"FASTLLAMA_PREFILL_INT8": "1"}, {"use_pallas": False},
             dict(window, B2=4 * layers, B3=4 * layers, B1=1))):
        label = " ".join(f"{k}={v}" for k, v in env.items()) + (
            " use_pallas=False" if rcfg else "")
        counts, _, _ = switch_session(torch, hp, params, dev, label, 1,
                                      env=env, **rcfg)
        expect_counts(label, counts, want)
        res[label] = dict(launches=counts)
        print(f"switch window {label}: {counts}", flush=True)
    del params
    torch.cuda.empty_cache()
    return res


def pallas_device_times(torch, hp, params, dev):
    """Device time of the 7B session under use_pallas=False (B1 at decode
    M) and use_pallas=True (B15), one after the other: the 300-token
    prompt's ingest
    at n_batch 64 (five windows of M = 64 and the first token) and a decode
    token, from torch.profiler traces of replayed graphs (profile_prefill,
    profile_decode over 8 steps); an empty entry where the profiler saw no
    device activity."""
    prompt = prompt_of(N_PROMPT - 2, seed=1)
    out = {}
    for use_pallas in (False, True):
        model, sess = make_session(hp, params, dev, n_batch=64,
                                   use_pallas=use_pallas)
        warm_up(sess, prompt)
        window = profile_prefill(torch, sess, prompt)
        decode = profile_decode(torch, sess, 8)
        out[f"use_pallas_{str(use_pallas).lower()}"] = dict(
            n_batch_64_ingest_device_ms=window.get("device_ms"),
            decode_device_ms_per_token=decode.get("device_ms_per_token"),
            top_kernels=decode.get("kernels", [])[:4])
        del sess, model
    print(f"use_pallas device times: {out}", flush=True)
    torch.cuda.empty_cache()
    return out


def variants_path(torch, dev, gen):
    """Phase 14: B15-B19 against their plain versions, the variant tool
    with every variant, and the kernel switches' sessions."""
    checks = {}
    t0 = time.perf_counter()
    check_variants(torch, dev, gen, checks)
    t1 = time.perf_counter()
    tool = profile_variants_tool(torch)
    t2 = time.perf_counter()
    switches = switches_path(torch, dev, gen)
    seconds = dict(checks=t1 - t0, tool=t2 - t1,
                   switches=time.perf_counter() - t2)
    print(f"phase 14 parts (s): {seconds}", flush=True)
    return dict(checks=checks, tool=tool, switches=switches, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 15: B20, B21 and the long-context paged engine
# ---------------------------------------------------------------------------

B20_ROWS = (512, 256, 64, 1)
# the long-context engine: n_ctx 32768 in pages of 64 rows (pp 512, past
# the JAX kernel's 24,576-row gate for bf16 pools, so every step attends
# through B21 with 64-page compute blocks); its pool is set to 128 pages
# (the default would hold 8 x 32768 rows: about 137 GB at 7B)
LONG_CTX, LONG_PAGES = 32768, 128
B21_LENGTHS = (1, ENG_PS - 1, ENG_PS, ENG_PS + 1, 300, LONG_CTX - 1, 0,
               4097)
B21_PPCBS = (1, 2, 4, 64, LONG_CTX // ENG_PS)
B21_LIBRARY = "none: no call attends through page tables (as for B6)"
# B21's timed shapes on the long engine's tables: (label, sequences, rows)
B21_TIMED = (("8x300", ENG_SLOTS, 300), ("8x4096", ENG_SLOTS, 4096),
             ("1x32767", 1, LONG_CTX - 1))
# the long engine's deep window: eight prompts of LONG_DEEP_ROWS tokens
# (a prefill bucket of their size) in a pool of LONG_DEEP_PAGES pages
LONG_DEEP_ROWS, LONG_DEEP_PAGES = 4096, 528


def check_b20(torch, dev, gen, results):
    """B20 (q4_variants.q4_prefill_split, the prefill split body: v1's fold
    at prefill M; at M <= B20_ON_B15_MAX_M B15's kernel) on the 7B planes
    qkv, wo, w13, w2
    at B20_ROWS and the 13B qkv at M = 512. bf16: against its plain version
    within 1e-4 of max |y|,
    run twice and bit-equal, timed beside B5 (nat) and, at M <= 64, B15 on
    the same plane and M, and beside torch.mm of the rounded x by the
    dequantized weight (the yardstick, as for B5); f32 mode (B5's f32
    kernel) within 1e-5 of max |y|. At least one plan splits K (the fold
    must be added once, not once a split). At qkv M = 512 the kernels of
    one bf16 call from a profile: the cast pass and the product kernel,
    nothing else (no fold pass, no block sums by PyTorch ops). Then the
    entry point's counted
    run: every count 0 just before q4_matmul_prefill_pallas(variant=
    "split") runs once in bf16 and once in f32 on each 7B plane at M = 512,
    read just after: B20 one launch a bf16 call, B5 one an f32 call,
    nothing else."""
    from fastllama_tpu_torch.kernels import cuda_lib
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.kernels import q4_variants as qv
    sms = cuda_lib.sm_count(dev)
    rows_out, split_plans = [], 0
    cases = [(p, B20_ROWS) for p in PLANES_7B[:4]] + [(PLANES_13B[0],
                                                        (512,))]
    for (name, k, n), ms_rows in cases:
        w = rand_weight(torch, k, n, gen, dev)
        wbytes = weight_bytes(w)
        ws = [w] + [rand_weight(torch, k, n, gen, dev)
                    for _ in range(copies_for(wbytes) - 1)]
        wd = qm.dequant_matmul_weight(w, torch.bfloat16)
        n_st = w.qs.shape[1]
        for m in ms_rows:
            x = torch.randn((m, k), generator=gen, device=dev)
            label = f"B20 {name} M={m} K={k} N={n}"
            y = qv.q4_prefill_split(x, w.qs, w.scales)
            ref = qv.q4_prefill_split_plain(x, w.qs, w.scales)
            err = (y - ref).abs().max().item()
            tol = 1e-4 * ref.abs().max().item()
            require(bool(torch.isfinite(y).all()), f"{label}: not finite")
            require(err <= tol, f"{label}: err {err} > {tol}")
            require(torch.equal(y, qv.q4_prefill_split(x, w.qs, w.scales)),
                    f"{label}: not deterministic")
            y32 = qv.q4_prefill_split(x, w.qs, w.scales, torch.float32)
            ref32 = qv.q4_prefill_split_plain(x, w.qs, w.scales,
                                              torch.float32)
            err32 = (y32 - ref32).abs().max().item()
            tol32 = 1e-5 * ref32.abs().max().item()
            require(err32 <= tol32, f"{label} f32: err {err32} > {tol32}")
            splits, per = qm.b5_plan(m, n_st, -(-k // 32) * 32, sms)
            split_plans += splits > 1
            it = iter(range(10**9))

            def cycled(fn):
                ww = ws[next(it) % len(ws)]
                return fn(ww)
            ms = time_ms(lambda: cycled(lambda ww: qv.q4_prefill_split(
                x, ww.qs, ww.scales)), calls=len(ws))
            nat_ms = time_ms(lambda: cycled(lambda ww: qm.q4_matmul_prefill(
                x, ww, torch.bfloat16)), calls=len(ws))
            b15_ms = (time_ms(lambda: cycled(lambda ww: qv.q4_decode_v1(
                x, ww.qs, ww.scales)), calls=4 * len(ws)) if m <= 64
                else None)
            xr = qm._pad_k(x, w.k).to(torch.bfloat16)
            library_ms = time_ms(lambda: torch.mm(
                xr, wd, out_dtype=torch.float32), calls=4)
            plain_ms = (time_ms(lambda: qv.q4_prefill_split_plain(
                x, w.qs, w.scales), calls=2) if name == "qkv" else None)
            f32_ms = (time_ms(lambda: cycled(lambda ww: qv.q4_prefill_split(
                x, ww.qs, ww.scales, torch.float32)), calls=len(ws))
                if name == "qkv" and m == 512 else None)
            nbytes = (wbytes + x.numel() * 4 + m * n_st * 4
                      + m * (k // 32) * 4)
            bnd, by = bound_ms(nbytes, 2.0 * m * k * n, "bf16")
            row = dict(shape=f"{name} M={m} K={k} N={n} bf16",
                       max_abs_err=err, tol=tol, f32_max_abs_err=err32,
                       f32_tol=tol32, splits=splits, stages_per_split=per,
                       ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                       library_ms=library_ms,
                       library_call="torch.mm of the rounded x by the "
                                    "dequantized weight (as for B5)",
                       vs_library=ms / library_ms, b5_nat_ms=nat_ms,
                       vs_b5=ms / nat_ms, b15_ms=b15_ms, f32_ms=f32_ms,
                       kernel="B15's" if m <= qv.B20_ON_B15_MAX_M
                       else "cast + bf16_wgmma_kernel<kSplit>")
            if name == "qkv" and m == 512:
                kernels = kernels_per_call(torch, lambda: qv.q4_prefill_split(
                    x, w.qs, w.scales))
                require(kernels == {"cast_kernel": 1, "bf16_wgmma_kernel": 1},
                        f"B20: a call launches {kernels}, not the cast pass "
                        "and one product kernel")
                row["kernels_a_call"] = kernels
            rows_out.append(row)
            print(f"B20 {row}", flush=True)
        del ws, w, wd
    require(split_plans > 0, "B20: no case ran a plan with K splits")

    # the entry point's counted run
    ws = [rand_weight(torch, k, n, gen, dev) for _, k, n in PLANES_7B[:4]]
    xs = [torch.randn((512, k), generator=gen, device=dev)
          for _, k, _ in PLANES_7B[:4]]
    torch.cuda.synchronize()
    reset_every_count()
    for x, w in zip(xs, ws):
        for mode in (torch.bfloat16, torch.float32):
            qv.q4_matmul_prefill_pallas(x, w.qs, w.scales, w_dtype=mode,
                                        variant="split")
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in every_kernel().items()}
    expect_counts("B20 entry point", counts, dict(B20=4, B5=4))
    results["B20"] = rows_out
    results["B20_entry_launches"] = counts
    del ws, xs


def time_settled(fn, calls):
    """time_ms of fn, the smaller of two timings in a row: on the H100 the
    first kernel timed after a plain reference's multi-GB gathers read up
    to 16% slow, and the next one not (tools_torch/b21_sweep.py's first
    variant a case)."""
    return min(time_ms(fn, calls=calls), time_ms(fn, calls=calls))


def b21_case(torch, dev, gen, h, dt, lens, pp, extra=16, new_row=0):
    """Pools [h, P, 64, 128] of `dt` for sequences of lengths `lens` over pp
    pages each: each sequence's live pages (holding its rows, and the
    new_row rows past them) from one shuffle, its other table entries any
    page (never read); NaN in every page no sequence reaches and in the
    rows past each length in its last page (the kernel's copies), and the
    clean pools (the plain version's). Returns (q, clean pools, NaN pools,
    lengths, tables)."""
    ps, d = ENG_PS, 128
    need = [min(-(-(n + new_row) // ps), pp) for n in lens]
    n_pages = sum(need) + extra
    perm = torch.randperm(n_pages, generator=gen, device=dev).tolist()
    tables, at = [], 0
    for k in need:
        tail = torch.randint(0, n_pages + 1, (pp - k,), generator=gen,
                             device=dev).tolist()
        tables.append(perm[at:at + k] + tail)
        at += k
    kp, vp = (torch.randn((h, n_pages + 1, ps, d), generator=gen,
                          device=dev).to(dt) for _ in range(2))
    used = torch.zeros(n_pages + 1, dtype=torch.bool, device=dev)
    used[perm[:at]] = True
    kq, vq = kp.clone(), vp.clone()
    kq[:, ~used] = float("nan")
    vq[:, ~used] = float("nan")
    for n, row in zip(lens, tables):
        if n % ps and n < pp * ps:
            kq[:, row[n // ps], n % ps:] = float("nan")
            vq[:, row[n // ps], n % ps:] = float("nan")
    q = torch.randn((len(lens), h, d), generator=gen, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return (q, (kp, vp), (kq, vq), torch.tensor(list(lens), **i32),
            torch.tensor(tables, **i32))


def check_b21(torch, dev, gen, results):
    """B21 (engine/paged_kv.paged_attention_tpu, the library paged
    attention's function) against its plain version on bf16 and f32 pools
    at 32 heads (40 on bf16 pools at the engine's block), Dh 128, pages of
    64 rows, pp 512 (the long-context engine's tables): eight sequences of
    lengths B21_LENGTHS over a shuffled table, and one of 32,767 rows (B =
    1, its pages split over many blocks), NaN in every page no sequence
    reaches and past each length in its last page, compute blocks of
    B21_PPCBS pages; within 1e-5 of the largest output (f32 throughout,
    sums in another order), a sequence of length 0 zeros, run twice and
    bit-equal. A bf16 q as the JAX tool passes it. Timed at 8 x 300 on pp
    8 pools beside B6 on the same pools (the engine's block there: 8
    pages), and at B21_TIMED on pp 512 (64-page blocks), each beside its
    bound (the live K and V bytes over 3.35 TB/s); time_settled."""
    from fastllama_tpu_torch.engine import paged_kv as pk
    from fastllama_tpu_torch.kernels import paged_attention as pa
    pp = LONG_CTX // ENG_PS
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    # (heads, pool type, lengths, q types, compute blocks): a bf16 q once,
    # on bf16 pools; 40 heads at the engine's block; one long sequence
    for h, dt, lens, qdts, ppcbs in (
            (32, bf16, B21_LENGTHS, (f32, bf16), B21_PPCBS),
            (32, f32, B21_LENGTHS, (f32,), B21_PPCBS),
            (40, bf16, B21_LENGTHS, (f32,),
             (pa.library_ppcb(pp, ENG_PS, 128),)),
            (32, bf16, (LONG_CTX - 1,), (f32,), B21_PPCBS)):
        name = f"H={h} {'bf16' if dt == bf16 else 'f32'}"
        q, clean, nan, lens_t, tables = b21_case(torch, dev, gen, h, dt,
                                                 lens, pp)
        for qdt in qdts:
            qq = q.to(qdt)
            ref = pk.paged_attention_tpu_plain(qq, *clean, lens_t, tables)
            tol = 1e-5 * ref.abs().max().item() + 1e-6
            for ppcb in ppcbs:
                label = (f"B21 {name} B={len(lens)} "
                         f"q {'bf16' if qdt == bf16 else 'f32'} ppcb={ppcb}")
                out = pk.paged_attention_tpu(qq, *nan, lens_t, tables,
                                             pages_per_compute_block=ppcb)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(out).all()),
                        f"{label}: not finite")
                err = (out - ref).abs().max().item()
                require(err <= tol, f"{label}: err {err} > {tol}")
                require(0 not in lens or not out[lens.index(0)].any(),
                        f"{label}: a sequence of length 0 is not zeros")
                require(torch.equal(out, pk.paged_attention_tpu(
                    qq, *nan, lens_t, tables, pages_per_compute_block=ppcb)),
                    f"{label}: not deterministic")
                rows.append(dict(shape=f"{name} d=128 ps={ENG_PS} pp={pp} "
                                 f"ppcb={ppcb} lengths={list(lens)}",
                                 q=str(qdt), max_abs_err=err, tol=tol))
        del clean, nan

    # timed: 8 x 300 on pp 8 (beside B6), then B21_TIMED on pp 512
    h, d = 32, 128
    for label, b, n_len, tpp in (("8x300", ENG_SLOTS, 300, ENG_CTX // ENG_PS),
                                 *((lb, bb, nn, pp)
                                   for lb, bb, nn in B21_TIMED)):
        live = 2 * b * n_len * h * d * 2
        cases = [b21_case(torch, dev, gen, h, bf16, [n_len] * b, tpp,
                          extra=0) for _ in range(copies_for(live))]
        q, clean, _, lens, tables = cases[0]
        ppcb = pa.library_ppcb(tpp, ENG_PS, d)
        it = iter(range(10**9))

        def run(fn):
            c = cases[next(it) % len(cases)]
            return fn(c[0], *c[1], c[3], c[4])
        # timed before the plain reference's gathers (time_settled)
        ms = time_settled(lambda: run(lambda *a: pk.paged_attention_tpu(
            *a, pages_per_compute_block=ppcb)), 8 * len(cases))
        ref = pk.paged_attention_tpu_plain(q, *clean, lens, tables)
        out = pk.paged_attention_tpu(q, *clean, lens, tables,
                                     pages_per_compute_block=ppcb)
        err = (out - ref).abs().max().item()
        require(err <= 1e-5 * ref.abs().max().item() + 1e-6,
                f"B21 timed {label} pp={tpp}: err {err}")
        plain_ms = time_ms(lambda: pk.paged_attention_tpu_plain(
            q, *clean, lens, tables), calls=2)
        bnd, by = bound_ms(live, 4.0 * b * n_len * h * d, "f32")
        row = dict(shape=f"H=32 d=128 ps={ENG_PS} pp={tpp} ppcb={ppcb} bf16 "
                   f"lengths={label}", max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                   bound_share=bnd / ms, library_ms=None,
                   library_call=B21_LIBRARY)
        if tpp * ENG_PS <= 12288:
            row["b6_ms"] = time_ms(lambda: run(pa.paged_decode_attention),
                                   calls=8 * len(cases))
        rows.append(row)
        print(f"B21 {row}", flush=True)
        del cases
    results["B21"] = rows


def b21f_case(torch, dev, gen, h, dt, lens, pp, extra=16):
    """The fused B21 step's inputs: b21_case's pools with room for each
    sequence's new row, one more sequence (length 0) inactive on the trash
    page (the pools' last page, in no live table), qkv f32 [B, 3 h 128]
    and the RoPE lanes at the lengths. Returns (qkv, clean pools, NaN
    pools, lengths, tables, page ids, offsets, cos, sin)."""
    from fastllama_tpu_torch.kernels.rope import lane_tables
    lens = list(lens) + [0]
    _, clean, nan, lens_t, tables = b21_case(torch, dev, gen, h, dt, lens,
                                             pp, extra=extra, new_row=1)
    d, ps = 128, ENG_PS
    i32 = dict(dtype=torch.int32, device=dev)
    pid = tables[torch.arange(len(lens), device=dev),
                 (lens_t // ps).clamp_max(pp - 1).long()].clone()
    pid[-1] = clean[0].shape[1] - 1
    off = (lens_t % ps).to(**i32)
    qkv = torch.randn((len(lens), 3 * h * d), generator=gen, device=dev)
    cos, sin = lane_tables(lens_t, d, d)
    return qkv, clean, nan, lens_t, tables, pid.to(**i32), off, cos, sin


def check_b21_fused(torch, dev, gen, results):
    """The fused B21 step (engine/paged_kv.paged_attention_tpu_fused: RoPE,
    B7's write, the pre-scale and B21 in one launch) against its plain
    version on bf16 and f32 pools at 32 heads, pp 512: B21_LENGTHS and an
    inactive slot (the trash page), NaN in every page no sequence reaches
    and past each length; the pools bit-equal to the plain step's (every
    row but the NaN ones), ctx within 1e-5 of the largest output on the
    active slots (the new row, taken from registers, is what B21 reads
    back) and finite everywhere, bit-equal on a second run. Timed at
    B21_TIMED beside the plain step and beside B7 + B21 on the same pools
    (q, k and v from qkv as they are), each beside its bound: the live K
    and V bytes read, qkv, the lanes and the output moved, the new row
    written; time_settled."""
    from fastllama_tpu_torch.engine import paged_kv as pk
    from fastllama_tpu_torch.kernels import kv_write as kw
    from fastllama_tpu_torch.kernels import paged_attention as pa
    pp = LONG_CTX // ENG_PS
    f32, bf16 = torch.float32, torch.bfloat16
    ppcb = pa.library_ppcb(pp, ENG_PS, 128)
    rows = []

    def same(a, b):
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num(), b.nan_to_num())

    for dt in (bf16, f32):
        name = f"H=32 {'bf16' if dt == bf16 else 'f32'}"
        qkv, clean, nan, lens, tables, pid, off, cs, sn = b21f_case(
            torch, dev, gen, 32, dt, B21_LENGTHS, pp)
        ref_pools = [x.clone() for x in clean]
        ref = pk.paged_attention_tpu_fused_plain(qkv, *ref_pools, lens,
                                                 tables, pid, off, cs, sn)
        first = [x.clone() for x in nan]
        again = [x.clone() for x in nan]
        out = pk.paged_attention_tpu_fused(qkv, *first, lens, tables, pid,
                                           off, cs, sn,
                                           pages_per_compute_block=ppcb)
        torch.cuda.synchronize()
        label = f"B21F {name}"
        require(bool(torch.isfinite(out).all()), f"{label}: not finite")
        tol = 1e-5 * ref[:-1].abs().max().item() + 1e-6
        err = (out - ref)[:-1].abs().max().item()
        require(err <= tol, f"{label}: err {err} > {tol}")
        # the pools: the NaN pools with the plain step's written rows
        for got, base, want in zip(first, nan, ref_pools):
            exp = base.clone()
            at = (pid.long(), off.long())
            exp[:, at[0], at[1]] = want[:, at[0], at[1]]
            require(same(got, exp), f"{label}: pools differ from the plain "
                    "step's write")
        require(torch.equal(out, pk.paged_attention_tpu_fused(
            qkv, *again, lens, tables, pid, off, cs, sn,
            pages_per_compute_block=ppcb)), f"{label}: not deterministic")
        rows.append(dict(shape=f"{name} d=128 ps={ENG_PS} pp={pp} "
                         f"ppcb={ppcb} lengths={list(B21_LENGTHS)} + "
                         "inactive", max_abs_err=err, tol=tol))
        del clean, nan, first, again, ref_pools

    h, d = 32, 128
    for label, b, n_len in B21_TIMED:
        live = 2 * b * n_len * h * d * 2
        cases = [b21f_case(torch, dev, gen, h, bf16, [n_len] * b, pp,
                           extra=0) for _ in range(copies_for(live))]
        qkv, clean, _, lens, tables, pid, off, cs, sn = cases[0]
        it = iter(range(10**9))

        def fused():
            c = cases[next(it) % len(cases)]
            return pk.paged_attention_tpu_fused(
                c[0], *c[1], *c[3:], pages_per_compute_block=ppcb)

        # the unfused route's kernels on the same pools: B7 then B21 over
        # lengths + 1 keys (q, k and v taken from qkv as they are)
        split = [(c[0].view(b + 1, 3, h, d)[:, 0],
                  c[0].view(b + 1, 3, h, d)[:, 1].contiguous(),
                  c[0].view(b + 1, 3, h, d)[:, 2].contiguous(), c[3] + 1)
                 for c in cases]

        def unfused():
            i = next(it) % len(cases)
            c, (q, k, v, attend) = cases[i], split[i]
            kw.paged_kv_write(*c[1], k, v, c[5], c[6])
            return pk.paged_attention_tpu(q, *c[1], attend, c[4],
                                          pages_per_compute_block=ppcb)
        # timed before the plain reference's gathers (time_settled)
        ms = time_settled(fused, 8 * len(cases))
        route_ms = time_settled(unfused, 8 * len(cases))
        out = pk.paged_attention_tpu_fused(
            qkv, *clean, lens, tables, pid, off, cs, sn,
            pages_per_compute_block=ppcb)
        ref = pk.paged_attention_tpu_fused_plain(
            qkv, *[x.clone() for x in clean], lens, tables, pid, off, cs,
            sn)
        err = (out - ref)[:-1].abs().max().item()
        require(err <= 1e-5 * ref[:-1].abs().max().item() + 1e-6,
                f"B21F timed {label}: err {err}")
        plain_ms = time_ms(lambda: pk.paged_attention_tpu_fused_plain(
            qkv, *clean, lens, tables, pid, off, cs, sn), calls=2)
        moved = (live + (b + 1) * (3 * h * d + 2 * d + h * d) * 4
                 + 2 * (b + 1) * h * d * 2)
        bnd, by = bound_ms(moved, 4.0 * b * (n_len + 1) * h * d, "f32")
        row = dict(shape=f"H=32 d=128 ps={ENG_PS} pp={pp} ppcb={ppcb} bf16 "
                   f"lengths={label} + inactive", max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                   bound_share=bnd / ms, b7_b21_ms=route_ms,
                   library_ms=None, library_call=B21_LIBRARY)
        rows.append(row)
        print(f"B21F {row}", flush=True)
        del cases, split
    results["B21F"] = rows


def long_context_engine(torch, dev, gen):
    """The 7B paged engine at n_ctx 32768 (32 layers, bf16 weights and pools,
    8 slots, pages of 64 rows, 128 pages): phase 6's twelve requests
    greedy, every count 0 just before and read just after: the fused B21
    step (B21F) 32 launches a decode step, B7, the unfused B21, the fused
    step, B6, B4 and B8 none, B12 once a layer in each admission past its
    gate. Every decode step's logits on the step graph bit-equal to the
    eager step's and the streams equal; the twelve greedy streams equal to
    the same requests' on phase 6's n_ctx 512 engine (the fused step), the
    first decode step's logits within 1e-2 of its largest logit. A 2-layer
    engine at n_ctx 32768 with q/k/v LoRA terms (rank 8 on wq and wv)
    takes B21F on every layer of every step too (the terms added into the
    fused projection first), never B7 or the unfused B21. Then the
    steady window of both 32-layer engines in turns (ms a step, tok/s,
    device ms and launches a step, B21F's counted and profiled launches
    and share), and of the n_ctx 32768 engine with eight sequences at about
    LONG_DEEP_ROWS resident rows."""
    import dataclasses
    from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
    from fastllama_tpu_torch.engine import paged_kv as pk
    from fastllama_tpu_torch.engine import scheduler as sched
    from fastllama_tpu_torch.kernels import paged_attention as pa
    from fastllama_tpu_torch.models.llama import LoraTerm
    hp = PRESETS["7B"]
    vocab = synthetic_vocab(hp.n_vocab)
    params = rand_params(torch, hp, gen, dev)
    rec = torch.empty((ENG_SLOTS, 1, hp.n_vocab), dtype=torch.float32,
                      device=dev)

    def make(n_ctx, total_pages=0, graph=True, hp=hp, params=params,
             buckets=()):
        rcfg = RuntimeConfig(n_ctx=n_ctx, n_batch=512, kv_dtype="bfloat16",
                             weight_dtype="bfloat16")
        if buckets:
            rcfg = dataclasses.replace(
                rcfg, prefill_buckets=rcfg.prefill_buckets + buckets)

        def build():
            eng = sched.BatchEngine(
                hp, params, vocab, n_slots=ENG_SLOTS, n_ctx=n_ctx, rcfg=rcfg,
                sampling_seed=3, kv_mode="paged", page_size=ENG_PS,
                total_pages=total_pages)
            return eng if graph else eager_route(eng)
        return build

    long_make = make(LONG_CTX, LONG_PAGES)
    short_make = make(ENG_CTX)
    real = sched.forward_paged_decode

    def recording(*a, **kw):
        out = real(*a, **kw)
        rec.copy_(out[0])
        return out

    def drive(build, label):
        """The twelve requests greedy through a fresh engine, stepped by
        hand: (engine, requests, each decode step's logits, counts, s)."""
        eng = build()
        reqs = engine_requests(sched, temp=0.0)
        steps = every_kernel()["B21F" if eng._paged_attn else "PS"]
        logits = []
        torch.cuda.synchronize()
        reset_every_count()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        while not all(r.done for r in reqs):
            before = steps.launches
            eng.step()
            if steps.launches > before:
                logits.append(rec.clone())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in every_kernel().items()}
        eng._pending_drain = None
        eng._inflight.clear()
        require(all(len(r.tokens_out) == ENG_GEN for r in reqs),
                f"{label}: a request did not run its length")
        require(eng.pager.free_pages == eng.pager.total_pages,
                f"{label}: {eng.pager.free_pages} pages free of "
                f"{eng.pager.total_pages}")
        return eng, reqs, logits, counts, wall

    sched.forward_paged_decode = recording
    try:
        eng, reqs, logits, counts, wall = drive(long_make, "long graph")
        streams = [r.tokens_out for r in reqs]
        route = eng._paged_attn
        ppcb = pa.library_ppcb(LONG_CTX // ENG_PS, ENG_PS, hp.head_dim)
        require(route == sched.B21Route(ppcb)
                and eng.pager.pages_per_seq == LONG_CTX // ENG_PS,
                f"long engine: route {route}")
        n_steps = counts["B21F"] // hp.n_layer
        expect_counts("long engine", counts, dict(
            B21F=hp.n_layer * n_steps, B1=counts["B1"], B2=counts["B2"],
            B3=counts["B3"], B5=counts["B5"], RW=counts["RW"],
            B12=hp.n_layer * flash_admissions(eng, reqs)))
        require(n_steps == len(logits) and counts["B21F"] % hp.n_layer == 0
                and n_steps > 0, f"long engine: {counts['B21F']} B21F "
                f"launches, {len(logits)} decode steps")
        decode_graphs = [g.captures for g in eng._graphs.entries("decode")]
        require(decode_graphs == [1], f"long engine: decode captures "
                f"{decode_graphs}")
        del eng
        eng_e, reqs_e, logits_e, counts_e, wall_e = drive(
            make(LONG_CTX, LONG_PAGES, graph=False), "long eager")
        streams_e = [r.tokens_out for r in reqs_e]
        del eng_e
        require(streams_e == streams, "long engine: the replayed streams "
                "differ from the eager step's")
        require(len(logits_e) == len(logits) and all(
            torch.equal(a, b) for a, b in zip(logits, logits_e)),
            "long engine: replayed logits differ from the eager step's")
        eng_s, reqs_s, logits_s, counts_s, wall_s = drive(short_make,
                                                          "fused n_ctx 512")
        streams_s = [r.tokens_out for r in reqs_s]
        require(eng_s._paged_attn is None and counts_s["B21"] == 0
                and counts_s["B21F"] == 0 and counts_s["PS"] > 0,
                f"fused engine: launches {counts_s}")
        del eng_s
        # q/k/v LoRA terms on both layers of a 2-layer engine: B21F on every
        # layer, the terms folded into its qkv
        hp2 = dataclasses.replace(hp, n_layer=2)
        params2 = rand_params(torch, hp2, gen, dev)
        for layer in params2.layers:
            for field in ("lora_wq", "lora_wv"):
                setattr(layer, field, LoraTerm(
                    a=torch.randn((hp.n_embd, 8), generator=gen, device=dev)
                    * 0.02,
                    b=torch.randn((8, hp.n_embd), generator=gen, device=dev)
                    * 0.02))
        eng_l, reqs_l, logits_l, counts_l, wall_l = drive(
            make(LONG_CTX, LONG_PAGES, hp=hp2, params=params2),
            "long LoRA 2 layers")
        n_lora = counts_l["B21F"] // hp2.n_layer
        expect_counts("long LoRA engine", counts_l, dict(
            B21F=hp2.n_layer * n_lora,
            B1=counts_l["B1"], B2=counts_l["B2"], B3=counts_l["B3"],
            B5=counts_l["B5"], RW=counts_l["RW"],
            B12=hp2.n_layer * flash_admissions(eng_l, reqs_l)))
        require(n_lora == len(logits_l) and n_lora > 0,
                f"long LoRA engine: {counts_l['B21F']} B21F launches, "
                f"{len(logits_l)} decode steps")
        del eng_l, params2
    finally:
        sched.forward_paged_decode = real
    first_err = (logits[0] - logits_s[0]).abs().max().item()
    first_scale = logits_s[0].abs().max().item()
    require(first_err <= 1e-2 * first_scale,
            f"long engine: first decode logits {first_err} from the fused "
            f"route's (largest {first_scale})")
    require(streams == streams_s, "long engine: greedy streams differ from "
            "the n_ctx 512 engine's: common prefixes "
            f"{[common_prefix(a, b) for a, b in zip(streams, streams_s)]}")
    n_tok = sum(len(t) for t in streams)
    res = dict(n_ctx=LONG_CTX, total_pages=LONG_PAGES, ppcb=ppcb,
               decode_steps=n_steps, launches=counts,
               launches_eager=counts_e, launches_fused_512=counts_s,
               launches_lora_2_layers=counts_l, wall_s_lora_2_layers=wall_l,
               steps_bit_equal=len(logits),
               first_step_err_vs_fused=first_err,
               first_step_max_logit=first_scale,
               greedy_common_prefix_vs_fused=[
                   common_prefix(a, b) for a, b in zip(streams, streams_s)],
               wall_s=wall, wall_s_eager=wall_e, wall_s_fused_512=wall_s,
               tok_s_with_admissions=n_tok / wall,
               tok_s_with_admissions_fused_512=n_tok / wall_s,
               pool_gb=2 * hp.n_layer * (LONG_PAGES + 1) * ENG_PS
               * hp.n_embd * 2 / 1e9,
               deep_pool_gb=2 * hp.n_layer * (LONG_DEEP_PAGES + 1) * ENG_PS
               * hp.n_embd * 2 / 1e9)
    steady = {}
    for label, build in (("long", long_make), ("fused_512", short_make),
                         ("long_again", long_make),
                         ("fused_512_again", short_make),
                         ("long_deep", make(LONG_CTX, LONG_DEEP_PAGES,
                                            buckets=(LONG_DEEP_ROWS,)))):
        deep = label == "long_deep"
        steady[label] = engine_steady(
            torch, sched, build,
            prompt_chars=LONG_DEEP_ROWS - 2 if deep else 98,
            counted=(("B21F", "paged_flash_kernel") if "long" in label
                     else ("PS", "attn_split_kernel")))
        print(f"long-context steady {label}: {json.dumps(steady[label])}",
              flush=True)
        torch.cuda.empty_cache()
    res["steady"] = steady
    print(f"long-context engine: {json.dumps({k: v for k, v in res.items() if k != 'steady'})}",
          flush=True)
    del params
    torch.cuda.empty_cache()
    return res


def long_context_path(torch, dev, gen):
    """Phase 15: B20, B21 and the fused B21 step against their plain
    versions and the 7B paged engine at n_ctx 32768 on the fused B21
    step."""
    from fastllama_tpu_torch.engine import paged_kv as pk
    checks = {}
    check_b20(torch, dev, gen, checks)
    # no model path runs the unfused B21 (every paged layer takes B21F past
    # the gate): its launches here are its only ones, as B11's in phase 2
    pk.paged_attention_tpu.launches = 0
    check_b21(torch, dev, gen, checks)
    checks["B21_check_launches"] = pk.paged_attention_tpu.launches
    check_b21_fused(torch, dev, gen, checks)
    engine = long_context_engine(torch, dev, gen)
    return dict(checks=checks, engine=engine)


# ---------------------------------------------------------------------------
# phase 16: the f32 mode at full 7B width
# ---------------------------------------------------------------------------

F32_PROMPT, F32_DECODE = 300, 32
F32_Q41_LAYERS = 8
# the kernels the f32 mode retired (csrc/q4_decode.cu's GEMV and
# csrc/q4_prefill.cu's FFMA tile): a trace of the f32 path names neither
F32_RETIRED = ("q4_gemv_kernel", "f32_gemm_kernel")


def f32_pair(torch, dev, gen, n_layer=2, lora_rank=0):
    """A 7B-width f32 LlamaModel of n_layer layers on the card and the same
    weights on the CPU (plain versions); with lora_rank, f32 A/B terms of
    that rank on wq and wv of every layer, on both."""
    import dataclasses
    from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
    from fastllama_tpu_torch.models.llama import LoraTerm
    from fastllama_tpu_torch.models.runtime import LlamaModel
    from fastllama_tpu_torch.parallel.sharding import params_to
    hp = dataclasses.replace(PRESETS["7B"], n_layer=n_layer)
    params = rand_params(torch, hp, gen, dev)
    for layer in params.layers if lora_rank else ():
        for field in ("lora_wq", "lora_wv"):
            setattr(layer, field, LoraTerm(
                a=torch.randn((hp.n_embd, lora_rank), generator=gen,
                              device=dev) * 0.05,
                b=torch.randn((lora_rank, hp.n_embd), generator=gen,
                              device=dev) * 0.05))
    rcfg = RuntimeConfig(n_ctx=512, n_batch=64, kv_dtype="float32",
                         weight_dtype="float32")
    vocab = synthetic_vocab(hp.n_vocab)
    lm_gpu = LlamaModel(hp, params, vocab, rcfg, device=dev)
    lm_cpu = LlamaModel(hp, params_to(params, torch.device("cpu")), vocab,
                        rcfg, device="cpu")
    return lm_gpu, lm_cpu


def c2_check(torch, dev, gen, lora_rank=0):
    """The f32 mode under a host program's TF32 setting: f32_pair's card
    model run with torch.set_float32_matmul_precision("highest") and then
    with "high" in force, each on the eager route, through step graphs
    captured under that setting, and through their replays. The pins make
    every "high" run's logits equal its "highest" twin's bit for bit
    ("equal": TF32 products in any pinned product break that, where the
    1e-4 card-against-CPU rule lets them by); each "high" run is also held
    against the CPU as card_vs_cpu holds it. The caller's setting is
    restored, on a failure too. Returns {"eager": [prefill, decode]
    errors over the largest CPU logit, "captured": [...], "replayed":
    [...], "equal": {route: bool}, "replays": graph replays under "high",
    "precision_during": the setting read in the "high" runs}."""
    from fastllama_tpu_torch.utils.step_graph import GraphCache
    lm_gpu, lm_cpu = f32_pair(torch, dev, gen, lora_rank=lora_rank)
    want = first_logits(lm_cpu)
    graphs = lm_gpu._graphs
    prev = torch.get_float32_matmul_precision()
    got = {}
    out = {"equal": {}}
    try:
        for setting in ("highest", "high"):
            torch.set_float32_matmul_precision(setting)
            eager_route(lm_gpu)
            runs = {"eager": first_logits(lm_gpu)}
            lm_gpu._graphs = GraphCache(graphs.device, graphs.generators,
                                        graphs.size)
            runs["captured"] = first_logits(lm_gpu)
            before = lm_gpu._graphs.replays
            runs["replayed"] = first_logits(lm_gpu)
            got[setting] = runs
        out["replays"] = lm_gpu._graphs.replays - before
        out["precision_during"] = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prev)
    for route, logits in got["high"].items():
        out[route] = rel_errs(logits, want)
        out["equal"][route] = all(
            np.array_equal(a, b) for a, b in zip(logits,
                                                 got["highest"][route]))
    del lm_gpu, lm_cpu
    torch.cuda.empty_cache()
    return out


def f32_counts(qm, da):
    """Every counted kernel's launches, and B1's, B9's and B5's f32-mode
    launches apart (f32_launches: the fold kernel's variants 10 and 11, the
    register-A kernel's f32 mode)."""
    out = read_counts(qm, da)
    for key, fn in (("B1", qm.q4_matmul_decode), ("B9", qm.q41_matmul_decode),
                    ("B5", qm.q4_matmul_prefill)):
        out[key + "_f32"] = fn.f32_launches
    return out


def f32_reset(qm, da):
    reset_counts(qm, da)
    for fn in (qm.q4_matmul_decode, qm.q41_matmul_decode,
               qm.q4_matmul_prefill):
        fn.f32_launches = 0


def f32_traced(torch, fn, steps):
    """(device ms a step, launches a step, {kernel: calls a step}) of
    `steps` calls of fn under torch.profiler, every kernel named; the
    device's busy time as device_time_by_kernel counts it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    dev_ms, launches, top = device_time_by_kernel(prof, steps)
    names = {k[:90]: c / steps for k, (_, c) in kernel_device_us(prof).items()
             if not k.startswith("ProfilerStep")}
    require(not any(r in k for k in names for r in F32_RETIRED),
            f"f32 path: a retired kernel in the trace {sorted(names)}")
    return dict(device_ms=dev_ms, launches=launches, calls=names,
                kernels=[{"name": k, "ms": ms, "calls": n}
                         for k, ms, n in top])


def f32_session(torch, dev, hp, params, prompt, n_decode, runs=3):
    """The f32 session (kv and weights f32, n_ctx 512, n_batch 512) on the
    prompt: a warm-up, then `runs` timed runs (reset, ingest, first token:
    TTFT; n_decode greedy tokens: ms a token) on the host clock, the first
    counted; the streams must agree. Returns (model, session, row)."""
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    model, sess = make_session(hp, params, dev, kv_dtype="float32",
                               weight_dtype="float32")
    warm_up(sess, prompt)
    out = []
    for i in range(runs):
        if i == 0:
            f32_reset(qm, da)
        sess.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        require(sess.ingest(prompt), "f32 ingest failed")
        n_prompt = sess.n_past + len(sess._embd)
        require(sess.generate(lambda s: None, num_tokens=1, temp=0.0),
                "f32 first token failed")
        ttft = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        require(sess.generate(lambda s: None, num_tokens=n_decode, temp=0.0),
                "f32 generate failed")
        decode_s = time.perf_counter() - t1
        logits = sess.get_logits().copy()
        require(n_prompt == F32_PROMPT and np.isfinite(logits).all()
                and logits.shape == (hp.n_vocab,),
                f"f32 session: {n_prompt} prompt tokens, logits finite "
                f"{np.isfinite(logits).all()}")
        if i == 0:
            counts = f32_counts(qm, da)
        out.append((ttft, decode_s / n_decode * 1e3, list(sess._last_n)))
    require(all(o[2] == out[0][2] for o in out),
            "f32 session: greedy streams differ between identical runs")
    ttfts, ms_tok = [o[0] for o in out], [o[1] for o in out]
    row = dict(n_layer=hp.n_layer, n_prompt=F32_PROMPT,
               decode_tokens=n_decode, ttft_ms=float(np.median(ttfts)),
               ttft_ms_runs=ttfts, decode_ms_per_token=float(
                   np.median(ms_tok)), decode_ms_per_token_runs=ms_tok,
               launches=counts)
    return model, sess, row


def f32_path(torch, dev, gen):
    """Phase 16: f32 mode (weight_dtype and kv_dtype float32) at full 7B
    width, synthetic weights as bench.py builds them: the 32-layer q4_0
    session (a 300-token prompt at n_batch 512, B5's f32 mode at M = 300,
    then F32_DECODE greedy tokens: B1's f32 mode at M = 1, the masked
    attention over the f32 cache, whose K and V rows RW writes) with TTFT
    and ms a token on the host clock, the TTFT window's
    and the decode steps' device time from traces, launches a token and
    the idle share; the 8-slot paged engine in f32 (B1's f32 mode at M = 8,
    the fused paged step on f32 pools): ms a step, device ms a step,
    launches a step; an 8-layer q4_1 session (B5's and B9's affine f32
    modes); and a 2-layer 7B-width f32 model's prefill and first decode
    logits on the card against the same weights on the CPU (plain
    versions), within phase 5's f32 rule (1e-4 of the largest logit).
    The f32 launches are exact, the dequant path runs 0 times and no
    trace names a retired kernel (F32_RETIRED)."""
    import dataclasses
    from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
    from fastllama_tpu_torch.engine import scheduler as sched
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.models.runtime import LlamaModel
    from fastllama_tpu_torch.parallel.sharding import params_to

    res = {}
    hp = PRESETS["7B"]
    params = rand_params(torch, hp, gen, dev)
    prompt = prompt_of(F32_PROMPT - 2, seed=16)
    dequant0 = qm.q4_matmul_dequant.cuda_calls
    model, sess, row = f32_session(torch, dev, hp, params, prompt,
                                   F32_DECODE)
    c = row["launches"]
    # one 300-row window: four matmuls a layer on B5 (f32), the head's last
    # row on B1; each decode token 129 matmuls on B1 (f32); the attention
    # of f32 mode is the masked route over the f32 cache, as the JAX
    # forward's (its gate keeps f32 off the fused decode kernel B4 and off
    # B12), the K and V rows of every layer written by RW
    want = dict(B5_f32=PREFILL_MATMULS, B5=PREFILL_MATMULS,
                B1_f32=129 * F32_DECODE + 1, B1=129 * F32_DECODE + 1,
                RW=WINDOW_ROWS * (F32_DECODE + 1), B2=0, B3=0, B4=0, B9=0,
                B9_f32=0, B10=0, B12=0)
    require(all(c[k] == v for k, v in want.items()),
            f"f32 session launches {c}, want {want}")
    window = f32_traced(torch, lambda: (sess.reset(), sess.ingest(prompt),
                                        sess.generate(lambda s: None,
                                                      num_tokens=1,
                                                      temp=0.0)), 1)
    require(any("q4_prefill_f32_kernel" in k for k in window["calls"])
            and any("cast3_kernel" in k for k in window["calls"]),
            f"f32 window: no f32 prefill kernel in {sorted(window['calls'])}")
    decode = f32_traced(torch, lambda: sess.generate(
        lambda s: None, num_tokens=1, temp=0.0), 8)
    require(any("q4_fold_kernel" in k for k in decode["calls"]),
            f"f32 decode: no fold kernel in {sorted(decode['calls'])}")
    row.update(window_device_ms=window["device_ms"],
               window_kernels=window["kernels"],
               window_gemm_launches={k: v for k, v in window["calls"].items()
                                     if "gemm" in k.lower()},
               device_ms_per_token=decode["device_ms"],
               launches_per_token=decode["launches"],
               decode_kernels=decode["kernels"],
               device_idle_share=1.0 - decode["device_ms"]
               / row["decode_ms_per_token"],
               weight_bytes_per_token=model_weight_bytes(params),
               decode_bytes_bound_ms=model_weight_bytes(params)
               / HBM_BYTES_PER_S * 1e3)
    res["q4_0_session"] = row
    print(f"f32 session: {json.dumps(row)}", flush=True)
    del sess, model
    torch.cuda.empty_cache()

    # the 8-slot paged engine in f32
    vocab = synthetic_vocab(hp.n_vocab)
    rcfg = RuntimeConfig(n_ctx=ENG_CTX, n_batch=512, kv_dtype="float32",
                         weight_dtype="float32")

    def make():
        return sched.BatchEngine(hp, params, vocab, n_slots=ENG_SLOTS,
                                 n_ctx=ENG_CTX, rcfg=rcfg, sampling_seed=3,
                                 kv_mode="paged", page_size=ENG_PS)
    engine_run(torch, sched, make, "f32 warm-up", hp.n_layer, False,
               f32=True, temp=0.0)
    f32_reset(qm, da)
    _, erow = engine_run(torch, sched, make, "f32 paged greedy", hp.n_layer,
                         False, f32=True, temp=0.0)
    ec = f32_counts(qm, da)
    require(ec["B1_f32"] == ec["B1"] > 0 and ec["B5_f32"] == ec["B5"]
            and ec["B9"] == ec["B2"] == ec["B3"] == 0,
            f"f32 engine launches {ec}")
    erow["launches"].update({k: ec[k] for k in ("B1_f32", "B5_f32")})
    steady = engine_steady(torch, sched, make)
    res["engine"] = dict(run=erow, steady=steady)
    print(f"f32 engine steady: {json.dumps(steady)}", flush=True)
    del params
    torch.cuda.empty_cache()

    # the q4_1 session at 8 layers: B5's and B9's affine f32 modes
    hp8 = dataclasses.replace(hp, n_layer=F32_Q41_LAYERS)
    params = rand_params(torch, hp8, gen, dev, affine=True)
    model, sess, row = f32_session(torch, dev, hp8, params, prompt, 16,
                                   runs=2)
    c = row["launches"]
    want = dict(B5_f32=4 * F32_Q41_LAYERS, B5=4 * F32_Q41_LAYERS,
                B9_f32=(4 * F32_Q41_LAYERS + 1) * 16 + 1,
                B9=(4 * F32_Q41_LAYERS + 1) * 16 + 1, B1=0, B1_f32=0, B2=0,
                B3=0)
    require(all(c[k] == v for k, v in want.items()),
            f"f32 q4_1 session launches {c}, want {want}")
    res["q4_1_session"] = row
    print(f"f32 q4_1 session: {json.dumps(row)}", flush=True)
    del sess, model, params
    torch.cuda.empty_cache()

    # the card against the CPU: a 2-layer 7B-width f32 model, the same
    # weights on both
    hp2 = dataclasses.replace(hp, n_layer=2)
    params = rand_params(torch, hp2, gen, dev)
    rcfg = RuntimeConfig(n_ctx=512, n_batch=64, kv_dtype="float32",
                         weight_dtype="float32")
    lm_gpu = LlamaModel(hp2, params, vocab, rcfg, device=dev)
    lm_cpu = LlamaModel(hp2, params_to(params, torch.device("cpu")), vocab,
                        rcfg, device="cpu")
    errs = card_vs_cpu(lm_gpu, lm_cpu)
    require(max(errs) <= 1e-4, f"f32 2 layers, card vs CPU logits rel err "
            f"{errs}")
    res["card_vs_cpu_2_layers"] = dict(rel_err_prefill=errs[0],
                                       rel_err_decode=errs[1])
    del lm_gpu, lm_cpu, params
    torch.cuda.empty_cache()
    # the same check under a host program's TF32 setting, with f32 LoRA
    # terms on wq and wv: eager, captured under "high" and replayed, each
    # equal bit for bit to the same run under "highest"
    c2 = c2_check(torch, dev, gen, lora_rank=8)
    require(all(max(c2[k]) <= 1e-4 and c2["equal"][k]
                for k in ("eager", "captured", "replayed"))
            and c2["replays"] > 0 and c2["precision_during"] == "high",
            f"f32 2 layers under TF32 'high': {c2}")
    res["card_vs_cpu_tf32_high"] = c2
    res["dequant_calls"] = qm.q4_matmul_dequant.cuda_calls - dequant0
    require(res["dequant_calls"] == 0,
            f"f32 path: the dequant path ran {res['dequant_calls']} times")
    print(f"f32 path: {json.dumps({k: v for k, v in res.items() if k not in ('q4_0_session', 'q4_1_session', 'engine')})}",
          flush=True)
    return res


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from fastllama_tpu_torch.kernels import cuda_lib
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import q4_matmul as qm
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
                        file_res["ggjt_q4_1"]["path"])
        # phase 11's bench_q4_floor holds B1 against the dequant path in
        # this process, as phase 2 does: the count of phases 3-10 is read
        # before it (phase 11's subprocesses count their own)
        dequant_calls = qm.q4_matmul_dequant.cuda_calls
        bench_res = timed("11 bench path", bench_path, torch, tmp,
                          par_res["q4_0_path"])
        graph_res = timed("12 graphs", graphs_path, torch, dev, gen)
        prefill_res = timed("13 prefill graphs", prefill_graphs_path, torch,
                            dev, gen)
        var_res = timed("14 variants and switches", variants_path, torch,
                        dev, gen)
        long_res = timed("15 B20, B21, long-context engine",
                         long_context_path, torch, dev, gen)
        f32_res = timed("16 f32 mode at 7B", f32_path, torch, dev, gen)
        # bench_torch.py's TTFT windows replay their graphs (phase 11)
        prefill_res["bench_7b_ttft_ms"] = {
            k: bench_res["bench"]["7b"]["line"][k]
            for k in ("ttft_ms_p50_int8", "ttft_ms_p50_bf16")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    require(dequant_calls == 0,
            f"the dequant path ran {dequant_calls} times on the card in "
            "phases 3-10")

    def pick(rows, key):
        return next(r for r in rows if key in r["shape"])

    # each kernel's launches in the counted run of the path that drives it;
    # B6, B7, B10 and the unfused B21 have no model path (every decode
    # layer, with q/k/v LoRA terms too, runs B4, the fused step or B21F):
    # their launches are their checks', as B11's
    standalone = checks["standalone_phase2_launches"]
    launches = dict(main_res["launches"],
                    B5=main_res["bf16_prefill"]["launches"]["B5"],
                    B9=q41_res["attached"]["launches"]["B9"],
                    B10=standalone["B10"], B6=standalone["B6"],
                    B7=standalone["B7"],
                    PS=engine_res["runs"]["paged"]["launches"]["PS"],
                    B8=engine_res["runs"]["paged_chunked"]["launches"]["B8"],
                    B11=checks["B11_phase2_launches"],
                    RW=main_res["launches"]["RW"],
                    **{k: bench_res["q4_floor"]["launches_counted"][k]
                       for k in ("B13", "B14")},
                    **{k: var_res["tool"]["launches"][k]
                       for k in variant_kernels()},
                    B20=long_res["checks"]["B20_entry_launches"]["B20"],
                    B21=long_res["checks"]["B21_check_launches"],
                    B21F=long_res["engine"]["launches"]["B21F"])
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
                 "B12": pick(checks["B12"], "7B H=32 d=128 T=512 bf16"),
                 # bench_q4_floor's default shape: the 7B qkv plane at M = 8
                 "B13": pick(checks["B13"], "qkv M=8 "),
                 "B14": pick(checks["B14"], "qkv M=8 "),
                 "RW": pick(checks["RW"], "T=512 n_past=0 k view"),
                 # profile_q4_variants' default shape: the 7B qkv plane at
                 # M = 8
                 **{k: pick(var_res["checks"][k], "qkv M=8 K=4096 N=12288")
                    for k in ("B15", "B16", "B17", "B18")},
                 "B19": pick(var_res["checks"]["B19"], "qkv M=512 "),
                 "B20": pick(long_res["checks"]["B20"], "qkv M=512 "),
                 "B21": pick(long_res["checks"]["B21"],
                             "pp=512 ppcb=64 bf16 lengths=8x300"),
                 "B21F": pick(long_res["checks"]["B21F"],
                              "lengths=8x300 + inactive")}
    meta = {
        # variant 0 of the fold kernel (built as csrc/q4_fold_v0.cu; its
        # f32 mode variant 10, csrc/q4_fold_f32.cu, a row of its own)
        "B1": ("q4_matmul_decode", "csrc/q4_fold.cuh",
               "fastllama_tpu/kernels/q4_matmul.py:433"),
        "B2": ("quant_rows_int8", "csrc/quant_rows.cu",
               "fastllama_tpu/kernels/q4_matmul.py:786"),
        # the register-A kernel in its int8 mode (built as csrc/q4_int8.cu)
        "B3": ("q4_matmul_prefill_int8", "csrc/q4_prefill_ra.cuh",
               "fastllama_tpu/kernels/q4_matmul.py:904"),
        # the split attention kernel in its B4 mode (built as
        # csrc/decode_attention.cu; B10, B6, B11 and PS its other modes)
        "B4": ("decode_attention_fused", "csrc/attn_split.cuh",
               "fastllama_tpu/kernels/decode_attention.py:258"),
        # the register-A kernel in its bf16 modes (built as
        # csrc/q4_prefill.cu, with the cast passes; its f32 mode a row of
        # its own)
        "B5": ("q4_matmul_prefill", "csrc/q4_prefill_ra.cuh",
               "fastllama_tpu/kernels/q4_matmul.py:578"),
        # variant 9 of the fold kernel (built as csrc/q4_fold_v9.cu)
        "B9": ("q41_matmul_decode", "csrc/q4_fold.cuh",
               "fastllama_tpu/kernels/q4_matmul.py:395"),
        "B10": ("decode_attention", "csrc/attn_split.cuh",
                "fastllama_tpu/kernels/decode_attention.py:72"),
        # built as csrc/paged_attention.cu, with B11 and PS
        "B6": ("paged_decode_attention", "csrc/attn_split.cuh",
               "fastllama_tpu/kernels/paged_attention.py:333"),
        "B7": ("paged_kv_write", "csrc/kv_write.cu",
               "fastllama_tpu/kernels/kv_write.py:55"),
        "B8": ("paged_kv_write_rows", "csrc/kv_write.cu",
               "fastllama_tpu/kernels/kv_write.py:115"),
        "B11": ("paged_decode_attention_flat", "csrc/attn_split.cuh",
                "fastllama_tpu/kernels/paged_attention.py:283"),
        # B7 folded into B6's kernel with RoPE; it also replaces the B6
        # launch of that step (fastllama_tpu/kernels/paged_attention.py:333)
        "PS": ("paged_decode_step_fused", "csrc/attn_split.cuh",
               "fastllama_tpu/kernels/kv_write.py:55"),
        # the library Pallas TPU flash_attention the JAX function calls
        "B12": ("flash_prefill", "csrc/flash_prefill.cu",
                "fastllama_tpu/models/llama.py:288"),
        # the probes of tools/bench_q4_floor.py (_run launches them at :87
        # and :90); variants 13 and 14 of B15's kernel, built as
        # csrc/q4_fold_probe.cu
        "B13": ("q4_floor", "csrc/q4_fold.cuh",
                "tools/bench_q4_floor.py:37"),
        "B14": ("q4_nosc", "csrc/q4_fold.cuh",
                "tools/bench_q4_floor.py:49"),
        # no Pallas kernel: the slab row write at a device offset, the
        # counterpart of the JAX forward's _write_kv scatter (mode="drop")
        "RW": ("slab_write_rows", "csrc/kv_write.cu",
               "fastllama_tpu/models/llama.py:275"),
        # the variant bodies of q4_matmul_pallas (launched at :484 and
        # :498; v4 :308 and v5 :338 are bit-equal to v1) and of
        # q4_matmul_prefill_int8 (natx :715, launched at :1034; split :667,
        # bit-equal, at :1047): B15-B18 one kernel, built a variant each
        # (csrc/q4_fold.cu, q4_fold_v2.cu, q4_fold_v3.cu, q4_fold_v7.cu),
        # B19 its own
        "B15": ("q4_decode_v1", "csrc/q4_fold.cuh",
                "fastllama_tpu/kernels/q4_matmul.py:161"),
        "B16": ("q4_decode_v2", "csrc/q4_fold.cuh",
                "fastllama_tpu/kernels/q4_matmul.py:233"),
        "B17": ("q4_decode_v3", "csrc/q4_fold.cuh",
                "fastllama_tpu/kernels/q4_matmul.py:272"),
        "B18": ("q4_decode_v7", "csrc/q4_fold.cuh",
                "fastllama_tpu/kernels/q4_matmul.py:189"),
        "B19": ("q4_prefill_int8_natx", "csrc/q4_int8.cu",
                "fastllama_tpu/kernels/q4_matmul.py:715"),
        # the prefill split body (q4_matmul_prefill_pallas(variant="split"),
        # launched at :660): B5's kernel in its split mode
        "B20": ("q4_prefill_split", "csrc/q4_prefill.cu",
                "fastllama_tpu/kernels/q4_matmul.py:503"),
        # the library Pallas TPU paged_attention the JAX function calls
        "B21": ("paged_attention_tpu", "csrc/paged_flash.cu",
                "fastllama_tpu/engine/paged_kv.py:55"),
        # RoPE, B7's write and the pre-scale folded into B21's kernel; it
        # replaces the B21 launch of that step
        "B21F": ("paged_attention_tpu_fused", "csrc/paged_flash.cu",
                 "fastllama_tpu/engine/paged_kv.py:55"),
    }
    kernels = []
    for key, (name, src, replaces) in meta.items():
        row = main_rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fastllama_tpu_torch/kernels/" + src,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(r["max_abs_err"] for r in checks.get(
                key, var_res["checks"].get(
                    key, long_res["checks"].get(key, []))) + [
                    s for s in checks["shard_local"] + checks["13B"]
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
        if key in ("B6", "B7", "B10"):
            # a public entry point with no model path: a decode layer with
            # q/k/v LoRA terms adds them into its fused projection and runs
            # B4 (slab) or the fused step (paged), as its neighbours do
            runs = engine_res["runs"]
            kernels[-1].update(
                path="none on the model's paths (launches: phase 2's "
                     "checks); the q/k/v-LoRA layers run "
                     + ("B4" if key == "B10" else "the fused step"),
                launches_by_path={
                    "q4_1_lora_attached": q41_res["attached"]["launches"]
                    ["B10"] if key == "B10" else None,
                    "engine_paged_lora_2_layers":
                        runs["paged_lora_2_layers"]["launches"][key],
                    "engine_paged": runs["paged"]["launches"][key]})
            require(launches[key] > 0 and all(
                not v for v in kernels[-1]["launches_by_path"].values()),
                f"kernel {key}: launches {kernels[-1]['launches_by_path']} "
                f"on the model's paths, phase 2's {launches[key]}")
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
        if key == "RW":
            kernels[-1].update(
                tpu_kernel="none: the XLA scatter of _write_kv (mode='drop'),"
                           " no pl.pallas_call",
                launches_by_path={
                    "q4_1_lora_attached": q41_res["attached"]["launches"]
                    ["RW"],
                    **{f"engine_{m}": engine_res["runs"][m]["launches"]["RW"]
                       for m in ("paged", "paged_chunked", "slab")}},
                library_call=row["library_call"])
        if key in variant_kernels():
            kernels[-1].update(
                path="tools_torch/profile_q4_variants.py with every variant "
                     "(phase 14, K 4096, N 12288, M 8)",
                launches_by_path={
                    "use_pallas_true_session": var_res["switches"]
                    ["use_pallas_true"]["launches"][key],
                    "bench_path": bench_res["launches"].get(key, 0)})
            if key == "B19":
                kernels[-1].update(
                    {k: row[k] for k in ("b2_b3_nat_ms", "vs_b2_b3",
                                         "vs_library", "kernels_a_call",
                                         "allocated_bytes_a_call",
                                         "clusters_a_card")})
            else:
                kernels[-1].update(b1_ms=row["b1_ms"], vs_b1=row["vs_b1"],
                                   b13_ms=row["b13_ms"],
                                   b14_ms=row["b14_ms"])
            require(launches[key] > 0, f"kernel {key} was launched on no "
                    "path")
            continue
        if key == "B20":
            kernels[-1].update(
                path="q4_variants.q4_matmul_prefill_pallas(variant='split') "
                     "on the 7B planes at M = 512, bf16 and f32 (phase 15's "
                     "counted run; f32 runs B5's f32 mode)",
                library_call=row["library_call"], b5_nat_ms=row["b5_nat_ms"],
                vs_b5=row["vs_b5"], vs_library=row["vs_library"],
                kernels_a_call=row["kernels_a_call"])
            require(launches[key] > 0, "kernel B20 was launched on no path")
            continue
        if key == "B21":
            eng = long_res["engine"]
            kernels[-1].update(
                path="none on the model's paths (launches: phase 15's "
                     "checks): the n_ctx 32768 engine's q/k/v-LoRA layers "
                     "run B21F as its other layers do",
                library_call=row["library_call"],
                b6_ms_8x300_pp8=pick(long_res["checks"]["B21"],
                                     "pp=8 ")["b6_ms"],
                launches_by_path={
                    "bench_path": bench_res["launches"][key],
                    "long_engine_lora_2_layers":
                        eng["launches_lora_2_layers"]["B21"],
                    "b21f_in_that_run":
                        eng["launches_lora_2_layers"]["B21F"]})
            require(launches[key] > 0
                    and eng["launches_lora_2_layers"]["B21"] == 0
                    and eng["launches_lora_2_layers"]["B21F"] > 0,
                    "kernel B21: launches on the long LoRA engine")
            continue
        if key == "B21F":
            eng = long_res["engine"]
            kernels[-1].update(
                path="the 7B paged engine at n_ctx 32768 (phase 15: twelve "
                     "requests, 32 launches a decode step; B7, B21 and the "
                     "fused step 0)",
                folds=("fastllama_tpu/kernels/kv_write.py:55 (B7) + "
                       "fastllama_tpu/engine/paged_kv.py:55 (B21)"),
                library_call=row["library_call"],
                b7_b21_ms=row["b7_b21_ms"],
                launches_by_path={"bench_path":
                                      bench_res["launches"].get(key, 0)})
            require(launches[key] > 0 and eng["launches"]["B21"] == 0
                    and eng["launches"]["B7"] == 0,
                    "kernel B21F: launches on its path")
            continue
        if key in ("B13", "B14"):
            kernels[-1].update(
                path="tools_torch/bench_q4_floor.py (phase 11, its default "
                     "K 4096, N 12288, M 8)",
                built_as="fastllama_tpu_torch/kernels/csrc/q4_fold_probe.cu",
                library_call=NO_PROBE_LIBRARY, b1_ms=row["b1_ms"],
                b1_bound_ms=row["b1_bound_ms"], b15_ms=row["b15_ms"],
                plan=row["plan"])
        # its launches on phase 11's bench path (every script summed)
        kernels[-1].setdefault("launches_by_path", {})["bench_path"] = (
            bench_res["launches"][key])
        if key in ("B3", "B5"):
            kernels[-1].update(
                built_as="fastllama_tpu_torch/kernels/csrc/"
                         + ("q4_int8.cu" if key == "B3" else "q4_prefill.cu"),
                plan=row["plan"], vs_library=row["vs_library"])
            if key == "B3":
                kernels[-1].update({k: row[k] for k in (
                    "kernel_ms", "kernels_a_call", "allocated_bytes_a_call",
                    "int8_plane_bytes")})
        if key in ("B1", "B9"):
            m8 = pick(checks[key], "qkv M=8 K=4096 N=12288 bf16")
            kernels[-1].update(
                built_as="fastllama_tpu_torch/kernels/csrc/q4_fold_v"
                         f"{0 if key == 'B1' else 9}.cu",
                ms_at_engine_m8=m8["ms"],
                bound_ms_at_engine_m8=m8["bound_ms"],
                library_ms_at_engine_m8=m8.get("library_ms"))
        require(launches[key] > 0, f"kernel {key} was launched on no path")
    # the f32 modes of B1, B9 and B5 (B20's f32 route runs B5's): the fold
    # kernel's variants 10 and 11 (built as csrc/q4_fold_f32.cu) and the
    # register-A kernel's f32 mode, counted apart (f32_launches) on phase
    # 16's path
    s0, s1 = f32_res["q4_0_session"], f32_res["q4_1_session"]
    erun = f32_res["engine"]["run"]["launches"]
    for key, shape, built, n, by_path in (
            ("B1", "qkv M=1 K=4096 N=12288 f32", "q4_fold_f32.cu",
             s0["launches"]["B1_f32"],
             {"f32_engine_8_slots": erun["B1_f32"]}),
            ("B9", "qkv M=1 K=4096 N=12288 f32", "q4_fold_f32.cu",
             s1["launches"]["B9_f32"], {}),
            ("B5", "qkv M=512 K=4096 N=12288 f32 q4_0", "q4_prefill.cu",
             s0["launches"]["B5_f32"],
             {"f32_q4_1_session_8_layers": s1["launches"]["B5_f32"],
              "f32_engine_8_slots": erun["B5_f32"],
              "b20_f32_entry_point": 4})):
        row = pick(checks[key], shape)
        name, src, replaces = meta[key]
        require(n > 0, f"kernel {key} (f32 mode) was launched on no path")
        kernels.append({
            "name": f"{name} (f32 mode)", "route": "cuda",
            "source": "fastllama_tpu_torch/kernels/" + src,
            "replaces": replaces, "launches": n,
            "max_abs_err": max(r["max_abs_err"] for r in checks[key]
                               if r["shape"].endswith(" f32")
                               or " f32 " in r["shape"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "library_call": "torch.mm f32 of x by the dequantized weight "
                            "(TF32 off)",
            "ffma_bound_ms": row["ffma_bound_ms"],
            "tensor_bound_ms": row["tensor_bound_ms"],
            "built_as": "fastllama_tpu_torch/kernels/csrc/" + built,
            "path": "phase 16: the f32 session at 7B (q4_0, 32 layers; "
                    "q4_1, 8 layers for B9)",
            "launches_by_path": by_path})
    summary = {"card": smi, "build_s": cuda_lib.build_seconds,
               "kernel_checks": checks, "main_path": main_res,
               "q41_lora_path": q41_res, "file_entry_points": file_res,
               "engine_path": engine_res, "converters": conv_res,
               "c_abi": c_res, "parallel": par_res, "bench_path": bench_res,
               "graphs": graph_res, "prefill_graphs": prefill_res,
               "variants": var_res, "long_context": long_res,
               "f32_mode": f32_res,
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
