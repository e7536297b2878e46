#!/usr/bin/env python3
"""Profile the full-model prefill window on one CUDA card and print the
device time by kernel (the port of tools/profile_prefill.py).

    python3 tools_torch/profile_prefill.py [--seq 512] [--n-ctx 512]
        [--layers 32] [--mode int8|bf16] [--reps 4] [--out DIR]

At 7B widths (n_vocab 32000, n_embd 4096, 32 heads of 128, n_ff 11008)
with seeded random q4_0 weights made on the card, a fresh window of --seq
tokens (n_past 0, flash_prefill set, as the session's first window runs)
goes through models/llama.forward --reps times inside
utils.trace.trace_region. The newest trace's device events are summed by
kernel (utils.trace.device_op_breakdown) and printed per window, with the
share of the flash prefill attention B12 (taken where the window passes its
gate: --seq a multiple of 128, at least 128). --mode int8 runs the
activation-quantized prefill matmuls (B2 + B3), bf16 the bf16-exact B5.
The trace goes to --out/prefill/ (default: profile_prefill under the
temporary directory, TMPDIR).
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=512,
                    help="window length in tokens (n_past 0)")
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--mode", default="int8", choices=("int8", "bf16"),
                    help="prefill matmuls: int8 (B2 + B3) or bf16-exact "
                         "(B5)")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "profile_prefill"))
    args = ap.parse_args(argv)
    if not 0 < args.seq <= args.n_ctx:
        ap.error(f"--seq {args.seq} must be in [1, --n-ctx {args.n_ctx}]")
    if args.layers < 1 or args.reps < 1:
        ap.error("--layers and --reps must be at least 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_prefill: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fastllama_tpu_torch.config import PRESETS
    from fastllama_tpu_torch.kernels import cuda_lib
    from fastllama_tpu_torch.models.llama import (
        ForwardConfig, _flash_viable, forward, init_kv_cache,
        position_tables,
    )
    from fastllama_tpu_torch.utils.trace import (
        device_op_breakdown, print_breakdown, trace_region,
    )

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip() or torch.cuda.get_device_name(0)}",
          flush=True)
    cuda_lib.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    hp = dataclasses.replace(PRESETS["7B"], n_layer=args.layers)
    params = cs.rand_params(torch, hp, gen, dev)
    cfg = ForwardConfig(n_head=hp.n_head, n_rot=hp.n_rot,
                        w_dtype="bfloat16", prefill_int8=args.mode == "int8",
                        flash_prefill=True)
    print(f"window {args.seq} tokens, {args.layers} layers, {args.mode} "
          f"prefill matmuls; B12 "
          f"{'on' if _flash_viable(cfg, args.seq, hp.head_dim) else 'off'}"
          " (its gate)", flush=True)
    tables = position_tables(args.n_ctx, hp.head_dim, hp.n_rot, dev)
    kv = init_kv_cache(hp, 1, args.n_ctx, torch.bfloat16, dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        3, hp.n_vocab, (1, args.seq))).to(dev)

    def window():
        return forward(params, tokens, 0, kv, cfg, args.seq - 1, tables)[0]

    with torch.inference_mode():
        window()
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        print(f"host clock of a window (best of 3): {best * 1e3:.3f} ms",
              flush=True)
        with trace_region(args.out, "prefill"):
            for _ in range(args.reps):
                window()
    total, agg, cnt = device_op_breakdown(os.path.join(args.out, "prefill"))
    print_breakdown(total, agg, cnt, args.reps)
    flash = sum(us for k, us in agg.items() if "flash_prefill" in k)
    print(f"B12 (flash_prefill_kernel): {flash / 1e3 / args.reps:.4f} ms a "
          f"window, {flash / max(total, 1e-9):.1%} of its device time")
    return 0


if __name__ == "__main__":
    sys.exit(main())
