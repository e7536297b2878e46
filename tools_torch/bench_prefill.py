#!/usr/bin/env python3
"""Prefill benchmark and flash-attention parity on one CUDA card (the port
of tools/bench_prefill.py).

    python3 tools_torch/bench_prefill.py [--layers 32] [--seq 512]
        [--n-ctx 512] [--device D]

At 7B widths with synthetic q4_0 weights made on the card
(models/synthetic.build_model), one fresh window of --seq tokens (n_past
0) runs twice on the same weights, each replayed from its captured graph
as the session runs it (models/llama.forward_jit, one graph a route, the
cache zeroed in place before each window): "einsum", the masked f32
softmax over the cache, and "flash", ForwardConfig.flash_prefill (B12
where the window passes its gate: --seq a multiple of 128). The prefill
matmuls are the default (int8, B2 + B3). Prints each route's host clock of
a window (best of 3, ended by a synchronize), the last-token logits'
largest relative difference (bf16 tolerance) and the speedup. On --device
cpu the plain versions run on the graphs' static buffers.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools_torch._trace_util import open_device  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if not 0 < args.seq <= args.n_ctx or args.layers < 1:
        ap.error("--seq must be in [1, --n-ctx] and --layers at least 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = open_device(args.device, "bench_prefill")
    from fastllama_tpu_torch.config import PRESETS
    from fastllama_tpu_torch.models.llama import (
        ForwardConfig, forward_jit, init_kv_cache, position_tables,
    )
    from fastllama_tpu_torch.utils.step_graph import GraphCache
    from fastllama_tpu_torch.models.synthetic import build_model
    hp = dataclasses.replace(PRESETS["7B"], n_layer=args.layers)
    t0 = time.time()
    params = build_model(hp, device=dev)
    print(f"weights on {dev} in {time.time() - t0:.1f}s", flush=True)
    base = ForwardConfig(n_head=hp.n_head, n_rot=hp.n_rot)
    tables = position_tables(args.n_ctx, hp.head_dim, hp.n_rot, dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, hp.n_vocab, (1, args.seq))).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    graphs = GraphCache(dev)
    kv = init_kv_cache(hp, 1, args.n_ctx, torch.bfloat16, dev)
    n_past = torch.zeros((1,), dtype=torch.int32, device=dev)
    last = torch.full((1,), args.seq - 1, dtype=torch.int32, device=dev)
    results = {}
    with torch.inference_mode():
        for name, cfg in (("einsum", base),
                          ("flash", dataclasses.replace(
                              base, flash_prefill=True))):
            def run():
                for k, v in kv:
                    k.zero_()
                    v.zero_()
                sync()
                t0 = time.perf_counter()
                lg = forward_jit(params, tokens, n_past, kv, cfg, last,
                                 tables, graphs=graphs)[0]
                sync()
                return time.perf_counter() - t0, lg.clone()
            run()
            best, lg = min((run() for _ in range(3)),
                           key=lambda r: r[0])
            results[name] = (best, lg[0, -1].float().cpu().numpy())
            print(f"{name}: prefill {args.seq} wall {best * 1e3:.3f} ms",
                  flush=True)
    a, b = results["einsum"][1], results["flash"][1]
    rel = float(np.max(np.abs(a - b))) / max(1e-6, float(np.max(np.abs(a))))
    print(f"flash-vs-einsum last-token logits: max rel diff {rel:.3e}")
    print(f"speedup: {results['einsum'][0] / results['flash'][0]:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
