#!/usr/bin/env python3
"""Profile the batching engine's decode step on one CUDA card and print its
device time by kernel (the port of tools/profile_paged.py).

    python3 tools_torch/profile_paged.py [--steps 8] [--layers 32]
        [--slots 8] [--kv-mode paged|slab] [--page-size 64]
        [--prompt-words 2 | --prompt-tokens N] [--out DIR] [--device D]

On synthetic 7B-width q4_0 weights (models/synthetic.build_model) and the
JAX tool's toy vocab, --slots requests are admitted into an
engine.scheduler.BatchEngine (every slot live), six steps warm it, then
--steps engine steps (_launch, no host drain) run inside
utils.trace.trace_region; the newest trace's device events are summed by
kernel and printed per step. Then 48 back-to-back steps on the host clock.
--prompt-tokens sizes the prompts in tokens (the toy vocab byte-tokenizes
most words), deepening the cache during the profiled steps. The trace
goes to --out/engine_step/ (default: profile_paged under the temporary
directory, TMPDIR). On --device cpu the innermost CPU operators stand in
for the kernels.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools_torch._trace_util import (  # noqa: E402
    bench_vocab, build_prompt_tokens, load_device_op_breakdown, open_device,
    print_breakdown,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "profile_paged"))
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--kv-mode", default="paged", choices=("paged", "slab"))
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--prompt-words", type=int, default=2,
                    help="prompt length in words (longer -> deeper cache "
                         "lengths during the profiled steps)")
    ap.add_argument("--prompt-tokens", type=int, default=0,
                    help="build the prompt to about this many TOKENS "
                         "(overrides --prompt-words)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.steps < 1 or args.slots < 1 or args.layers < 1:
        ap.error("--steps, --slots and --layers must be at least 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = open_device(args.device, "profile_paged")
    from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
    from fastllama_tpu_torch.engine.scheduler import BatchEngine, Request
    from fastllama_tpu_torch.engine.tokenizer import tokenize
    from fastllama_tpu_torch.models.synthetic import build_model
    from fastllama_tpu_torch.utils.trace import trace_region
    hp = dataclasses.replace(PRESETS["7B"], n_layer=args.layers)
    t0 = time.time()
    params = build_model(hp, device=dev)
    print(f"built weights in {time.time() - t0:.1f}s", file=sys.stderr)
    vocab = bench_vocab()
    n_words = args.prompt_words
    prompts = None
    if args.prompt_tokens:
        prompt = build_prompt_tokens(vocab, args.prompt_tokens)
        n_words = len(prompt.split())
        print(f"prompt: {n_words} words -> "
              f"{len(tokenize(vocab, ' ' + prompt, bos=True))} tokens",
              file=sys.stderr)
        prompts = [prompt] * args.slots
    if prompts is None:
        prompts = [" ".join(f"w{(i + j) % 700}" for j in range(n_words))
                   for i in range(args.slots)]
    rcfg = RuntimeConfig(prefill_buckets=(
        min(args.n_ctx, max(16, n_words + 64)),))
    with torch.inference_mode():
        eng = BatchEngine(hp, params, vocab, n_slots=args.slots,
                          n_ctx=args.n_ctx, rcfg=rcfg, temp=0.8,
                          kv_mode=args.kv_mode, page_size=args.page_size,
                          drain_depth=10 ** 6, sampling_seed=0, device=dev)
        for p in prompts:
            eng.submit(Request(prompt=p, max_tokens=10 ** 6))
        eng._fill_idle_slots()
        if not all(s.live for s in eng.slots):
            raise SystemExit("admission failed (prompt too long for n_ctx, "
                             "or out of pages?)")
        for _ in range(6):
            eng._launch()
        eng.d_tokens.cpu()
        with trace_region(args.out, "engine_step"):
            for _ in range(args.steps):
                eng._launch()
            eng.d_tokens.cpu()
        n = 48
        t0 = time.perf_counter()
        for _ in range(n):
            eng._launch()
        eng.d_tokens.cpu()
        dt = time.perf_counter() - t0
    print(f"wall: {n} steps in {dt:.3f}s = {dt / n * 1e3:.3f} ms/step "
          f"({args.slots * n / dt:.0f} tok/s aggregate)", file=sys.stderr)
    total, agg, cnt = load_device_op_breakdown(
        os.path.join(args.out, "engine_step"))
    print_breakdown(total, agg, cnt, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
