#!/usr/bin/env python3
"""Wall-clock continuous-batching throughput on one CUDA card (the port of
tools/bench_engine.py).

    python3 tools_torch/bench_engine.py [--slots 8] [--layers 32]
        [--max-tokens 64] [--kv-mode slab|paged] [--drain-depth 4]
        [--stall-bench [--chunked]] [--device D]

Measures engine.scheduler.BatchEngine.run() end to end (admission, device
steps, the lagging token drain, detokenization) against the device-step
rate (back-to-back engine steps, one host read at the end), on synthetic
7B-width q4_0 weights made on the card (models/synthetic.build_model) and
the JAX tool's toy vocab. --stall-bench instead measures the inter-token
gaps of n_slots - 1 resident streams while 430-token prompts are admitted
into the free slot, monolithic or (--chunked) chunked admission: p50/p90/
p99/max gap of the residents and the engine step's wall time. All clocks
are the host's. On --device cpu the plain versions run.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools_torch._trace_util import (  # noqa: E402
    bench_vocab, build_prompt_tokens, open_device,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--max-tokens", type=int, default=64)
    ap.add_argument("--drain-depth", type=int, default=4)
    ap.add_argument("--kv-mode", default="slab", choices=("slab", "paged"))
    ap.add_argument("--stall-bench", action="store_true",
                    help="measure inter-token latency under mid-run "
                    "admissions instead of throughput")
    ap.add_argument("--chunked", action="store_true",
                    help="chunked admission (with --stall-bench)")
    ap.add_argument("--admissions", type=int, default=4)
    ap.add_argument("--stagger", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.slots < 2 or args.layers < 1:
        ap.error("--slots must be at least 2 and --layers at least 1")
    return args


def sync(eng):
    return eng.d_tokens.cpu()


def stall_bench(args, hp, params, vocab, dev):
    """Inter-token latency under mid-run admissions: n_slots - 1 resident
    decoding requests and staggered 430-token admissions into the free
    slot."""
    from fastllama_tpu_torch.config import RuntimeConfig
    from fastllama_tpu_torch.engine.scheduler import BatchEngine, Request
    from fastllama_tpu_torch.engine.tokenizer import tokenize
    rcfg = RuntimeConfig(prefill_buckets=(16, 512), n_batch=64)
    eng = BatchEngine(hp, params, vocab, n_slots=args.slots,
                      n_ctx=args.n_ctx, rcfg=rcfg, temp=0.8,
                      kv_mode=args.kv_mode, drain_depth=args.drain_depth,
                      sampling_seed=0, chunked_admission=args.chunked,
                      device=dev)
    print(f"admission mode: "
          f"{'chunked' if eng.chunked_admission else 'monolithic'}",
          flush=True)
    big_prompt = build_prompt_tokens(vocab, min(430, args.n_ctx - 8))
    n_big = len(tokenize(vocab, " " + big_prompt, bos=True))
    print(f"big prompt: {len(big_prompt.split())} words -> {n_big} tokens",
          flush=True)
    assert n_big <= args.n_ctx - 4
    t0 = time.time()
    warm = [Request(prompt="w1 w2 w3", max_tokens=4)
            for _ in range(args.slots - 1)]
    warm.append(Request(prompt=big_prompt, max_tokens=4))
    eng.run(warm)
    print(f"warmup {time.time() - t0:.1f}s", flush=True)

    residents = [Request(prompt=f"w{i % 7} w{i % 11}",
                         max_tokens=args.max_tokens)
                 for i in range(args.slots - 1)]
    for r in residents:
        eng.submit(r)
    bigs = [Request(prompt=big_prompt, max_tokens=4)
            for _ in range(args.admissions)]
    step_walls, arrivals = [], {i: [] for i in range(len(residents))}
    seen = [0] * len(residents)
    bi = si = 0
    while not all(r.done for r in residents):
        if bi < len(bigs) and si >= 16 and si % args.stagger == 0 \
                and (bi == 0 or bigs[bi - 1].done):
            eng.submit(bigs[bi])
            bi += 1
        t0 = time.perf_counter()
        eng.step()
        now = time.perf_counter()
        step_walls.append(now - t0)
        for i, r in enumerate(residents):
            d = len(r.tokens_out) - seen[i]
            if d > 0:
                arrivals[i].extend([now] * d)
                seen[i] += d
        si += 1
    gaps = np.concatenate([np.diff(np.asarray(a)) for a in arrivals.values()
                           if len(a) >= 2] or [np.zeros(0)]) * 1e3
    sw = np.asarray(step_walls) * 1e3
    n_tok = sum(len(r.tokens_out) for r in residents)
    print(f"{len(residents)} residents emitted {n_tok} tokens across "
          f"{si} steps; {bi} big admissions injected")
    if len(gaps):
        print(f"resident inter-token gap ms: "
              f"p50 {np.percentile(gaps, 50):.2f} "
              f"p90 {np.percentile(gaps, 90):.2f} "
              f"p99 {np.percentile(gaps, 99):.2f} max {gaps.max():.2f} "
              f"(n={len(gaps)})")
    print(f"engine step wall ms: p50 {np.percentile(sw, 50):.2f} "
          f"p99 {np.percentile(sw, 99):.2f} max {sw.max():.2f}")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = open_device(args.device, "bench_engine")
    from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
    from fastllama_tpu_torch.engine.scheduler import BatchEngine, Request
    from fastllama_tpu_torch.models.synthetic import build_model
    hp = dataclasses.replace(PRESETS["7B"], n_layer=args.layers)
    t0 = time.time()
    params = build_model(hp, device=dev)
    print(f"built 7B-width q4_0 weights ({args.layers} layers) in "
          f"{time.time() - t0:.1f}s", flush=True)
    vocab = bench_vocab()
    with torch.inference_mode():
        if args.stall_bench:
            return stall_bench(args, hp, params, vocab, dev)

        rcfg = RuntimeConfig(prefill_buckets=(16,))

        def engine(drain_depth):
            return BatchEngine(hp, params, vocab, n_slots=args.slots,
                               n_ctx=args.n_ctx, rcfg=rcfg, temp=0.8,
                               kv_mode=args.kv_mode, drain_depth=drain_depth,
                               sampling_seed=0, device=dev)
        eng = engine(args.drain_depth)
        t0 = time.time()
        eng.run([Request(prompt="w1 w2 w3", max_tokens=4)
                 for _ in range(args.slots)])
        print(f"warmup {time.time() - t0:.1f}s", flush=True)
        reqs = [Request(prompt=f"w{i % 7} w{i % 11} w{i % 5}",
                        max_tokens=args.max_tokens)
                for i in range(args.slots)]
        t0 = time.perf_counter()
        eng.run(reqs)
        wall = time.perf_counter() - t0
        n_tok = sum(len(r.tokens_out) for r in reqs)
        wall_tps = n_tok / wall

        # device-step rate: back-to-back steps, one host read at the end
        eng2 = engine(10 ** 6)
        for i in range(args.slots):
            eng2.submit(Request(prompt=f"w{i % 7} w{i % 11}",
                                max_tokens=10 ** 6))
        eng2._fill_idle_slots()
        sync(eng2)
        for _ in range(8):
            eng2._launch()
        sync(eng2)
        n_steps = min(64, args.n_ctx - 16)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng2._launch()
        sync(eng2)
        dev_s = time.perf_counter() - t0
    dev_tps = n_steps * args.slots / dev_s
    print(f"wall-clock: {n_tok} tokens in {wall:.3f}s = {wall_tps:.1f} tok/s "
          f"({args.slots} slots)")
    print(f"device-step rate: {n_steps} steps in {dev_s:.3f}s = "
          f"{dev_tps:.1f} tok/s aggregate")
    print(f"wall/device efficiency: {100 * wall_tps / dev_tps:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
