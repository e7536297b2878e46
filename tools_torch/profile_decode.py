#!/usr/bin/env python3
"""Profile the single-stream decode step on one CUDA card and print its
device time by kernel (the port of tools/profile_decode.py).

    python3 tools_torch/profile_decode.py [--steps 8] [--batch 1]
        [--dims 7b|13b] [--layers N] [--out DIR] [--device D]

Synthetic q4_0 weights at the family's widths (models/synthetic
.build_model; --layers cuts the depth), a bf16 slab cache of 512 rows, and
the decode step of bench_torch.py (models/llama.forward with a tensor
n_past, greedy argmax on the device). After four warm steps, --steps steps
run inside utils.trace.trace_region (torch.profiler); the newest trace's
device events are summed by kernel (utils.trace.device_op_breakdown) and
printed per step, with the host clock of a step beside them. The trace goes
to --out/decode/ (default: profile_decode under the temporary directory,
TMPDIR). The JAX tool's --hlo and --copt are XLA options (the compiled HLO,
compiler flags) with no counterpart here and are left out. On --device cpu
the innermost CPU operators stand in for the kernels.
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
    load_device_op_breakdown, open_device, print_breakdown,
)

N_CTX = 512


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "profile_decode"))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--dims", default="7b", choices=("7b", "13b"),
                    help="model widths (weights are synthetic either way)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override n_layer (0 = the family's real depth)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if not 1 <= args.steps <= N_CTX - 8 or args.batch < 1:
        ap.error(f"--steps must be in [1, {N_CTX - 8}], --batch at least 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = open_device(args.device, "profile_decode")
    from bench_torch import decode_step_fn
    from fastllama_tpu_torch.config import PRESETS
    from fastllama_tpu_torch.models.llama import init_kv_cache
    from fastllama_tpu_torch.models.synthetic import build_model
    from fastllama_tpu_torch.utils.trace import trace_region
    hp = PRESETS["13B" if args.dims == "13b" else "7B"]
    if args.layers:
        hp = dataclasses.replace(hp, n_layer=args.layers)
    params = build_model(hp, device=dev)
    step = decode_step_fn(params, hp, N_CTX, dev)
    kv = init_kv_cache(hp, args.batch, N_CTX, torch.bfloat16, dev)
    tok = torch.zeros((args.batch, 1), dtype=torch.int64, device=dev)
    n_past = torch.zeros((args.batch,), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for _ in range(4):
            tok = step(tok, n_past, kv)
        int(tok[0, 0])
        with trace_region(args.out, "decode"):
            t0 = time.perf_counter()
            for _ in range(args.steps):
                tok = step(tok, n_past, kv)
            int(tok[0, 0])
            host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    total, agg, cnt = load_device_op_breakdown(os.path.join(args.out,
                                                            "decode"))
    print(f"{args.dims} ({hp.n_layer} layers) batch {args.batch}: host "
          f"{host_ms:.3f} ms a step under the profiler")
    print_breakdown(total, agg, cnt, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
