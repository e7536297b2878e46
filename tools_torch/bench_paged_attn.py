#!/usr/bin/env python3
"""Paged decode attention against the slab decode attention on one CUDA
card (the port of tools/bench_paged_attn.py).

    python3 tools_torch/bench_paged_attn.py [--batch 8] [--n-ctx 512]
        [--reps 32] [--device D]

At 7B heads (32 of 128) with pages of 64 rows and bf16 pools [H, P, 64,
128], every sequence at length S - 64 and then 64:
  own    B6, kernels/paged_attention.paged_decode_attention;
  fused  the engine's fused paged step (RoPE, B7's write and B6 in one
         kernel, paged_decode_step_fused) at the same lengths;
  paged  the library section of the JAX tool: paged_attention_tpu (B21,
         engine/paged_kv.py, the library kernel's function) with a bf16 q,
         as the JAX tool passes it, at pages_per_compute_block 1, 2, 4 and
         pages_per_seq;
  plan   B6 under each cluster size its kernel takes (1, 2, 4 and 8
         blocks a (b, h), decode_attention.attn_plan pinned, as
         tools_torch/attn_sweep.py --parts pins; the plan's choice
         marked);
  slab   B10 (decode_attention) over slab caches [B, S, H*D] at n_past =
         the same depths, and B4 (decode_attention_fused, the slab
         engine's step: RoPE, the row's write and attention) beside it.
Each kernel is first held against its plain version (2^-7 of the largest
output for bf16 pools; 5e-5 for B10's f32 scores; 1e-5 for B21, whose
probabilities stay f32). Times: --reps calls in a
CUDA graph replayed between CUDA events, pools and caches cycled past the
50 MB L2; GB/s of the live K/V bytes. On --device cpu the plain versions
run on the host clock.
"""
import argparse
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools_torch._trace_util import (  # noqa: E402
    copies_for, open_device, time_calls,
)

H, D, PS = 32, 128, 64       # 7B heads, head_dim; page size
CLUSTERS = (1, 2, 4, 8)      # B6's blocks a (b, h) that it takes


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--reps", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.n_ctx % PS or args.n_ctx < 2 * PS or args.batch < 1:
        ap.error(f"--n-ctx must be a multiple of {PS}, at least {2 * PS}")
    return args


def check(name, got, ref, rel):
    err = (got - ref).abs().max().item()
    tol = rel * ref.abs().max().item() + 1e-6
    if not err <= tol:
        raise SystemExit(f"{name}: err {err} > {tol}")


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = open_device(args.device, "bench_paged_attn")
    from fastllama_tpu_torch.engine import paged_kv as pk
    from fastllama_tpu_torch.kernels import cuda_lib
    from fastllama_tpu_torch.kernels import decode_attention as da
    from fastllama_tpu_torch.kernels import paged_attention as pa
    from fastllama_tpu_torch.kernels.rope import lane_tables
    b, s = args.batch, args.n_ctx
    pps = s // PS
    total_pages = b * pps + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    on_card = dev.type == "cuda"
    pool_bytes = 2 * H * total_pages * PS * D * 2
    pools = [tuple(torch.randn((H, total_pages, PS, D), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(2))
             for _ in range(copies_for(pool_bytes) if on_card else 1)]
    tables = torch.arange(b * pps, dtype=torch.int32,
                          device=dev).reshape(b, pps)
    q = torch.randn((b, H, D), generator=gen, device=dev)
    kv_bytes = 2 * b * s * H * D * 2            # full-length K+V read
    clock = "device" if on_card else "host (cpu)"
    it = iter(range(10**9))

    def cycled(seq):
        return seq[next(it) % len(seq)]

    def report(label, length, dt_ms, nbytes):
        print(f"{label} len={length:4d}: {dt_ms * 1e3:8.2f} us {clock} "
              f"({nbytes / dt_ms / 1e6:6.1f} GB/s of live KV)", flush=True)

    with torch.inference_mode():
        for length in (s - PS, 64):
            lengths = torch.full((b,), length, dtype=torch.int32, device=dev)
            live = kv_bytes * length / s
            check(f"B6 len={length}",
                  pa.paged_decode_attention(q, *pools[0], lengths, tables),
                  pa.paged_decode_attention_plain(q, *pools[0], lengths,
                                                  tables), 2 ** -7)
            report("own   ", length, time_calls(
                lambda: pa.paged_decode_attention(q, *cycled(pools), lengths,
                                                  tables),
                args.reps, dev), live)
            # the fused step writes the new row at `length` (a page id and
            # an offset each) and attends length + 1 keys
            qkv = torch.randn((b, 3 * H * D), generator=gen, device=dev)
            pids = tables.gather(1, (lengths // PS)[:, None].long())[:, 0]
            offs = (lengths % PS).to(torch.int32)
            cos, sin = lane_tables(lengths, D, D)
            k2, v2 = (x.clone() for x in pools[0])
            check(f"fused len={length}",
                  pa.paged_decode_step_fused(qkv, *pools[0], lengths, tables,
                                             pids, offs, cos, sin),
                  pa.paged_decode_step_fused_plain(qkv, k2, v2, lengths,
                                                   tables, pids, offs, cos,
                                                   sin), 2 ** -7)
            del k2, v2
            report("fused ", length, time_calls(
                lambda: pa.paged_decode_step_fused(
                    qkv, *cycled(pools), lengths, tables, pids, offs, cos,
                    sin), args.reps, dev), live)

        qb = q.to(torch.bfloat16)
        for length in (s - PS, 64):
            lengths = torch.full((b,), length, dtype=torch.int32, device=dev)
            for ppcb in sorted({1, 2, 4, pps}):
                check(f"B21 len={length} ppcb={ppcb}",
                      pk.paged_attention_tpu(qb, *pools[0], lengths, tables,
                                             pages_per_compute_block=ppcb),
                      pk.paged_attention_tpu_plain(qb, *pools[0], lengths,
                                                   tables), 1e-5)
                report(f"paged ppcb={ppcb}", length, time_calls(
                    lambda: pk.paged_attention_tpu(
                        qb, *cycled(pools), lengths, tables,
                        pages_per_compute_block=ppcb), args.reps, dev),
                    kv_bytes * length / s)

        if on_card:
            sms = cuda_lib.sm_count(dev)
            planned = da.attn_plan(b, H, s, D, 2, sms).cs
            for length in (s - PS, 64):
                lengths = torch.full((b,), length, dtype=torch.int32,
                                     device=dev)
                for cl in CLUSTERS:
                    plan = da.attn_plan(b, H, s, D, 2, sms, cs=cl)
                    dt = time_calls(lambda: pa._launch(
                        "paged_decode_attention", q, *cycled(pools), lengths,
                        tables, total_pages, PS, plan=plan), args.reps, dev)
                    mark = " (attn_plan)" if cl == planned else ""
                    report(f"plan cs={cl}{mark}", length, dt,
                           kv_bytes * length / s)

        # slab decode attention over [B, S, H*D], cache depth = length
        slab_bytes = 2 * b * s * H * D * 2
        caches = [tuple(torch.randn((b, s, H * D), generator=gen,
                                    device=dev).to(torch.bfloat16)
                        for _ in range(2))
                  for _ in range(copies_for(slab_bytes) if on_card else 1)]
        qs = q.reshape(b, 1, H * D)
        for length in (s - PS, 64):
            npast = torch.full((b,), length, dtype=torch.int32, device=dev)
            kw = dict(head_dim=D, scale=1.0 / math.sqrt(D))
            check(f"B10 len={length}",
                  da.decode_attention(qs, *caches[0], npast, **kw),
                  da.decode_attention_plain(qs, *caches[0], npast, **kw),
                  5e-5)
            report("slab  ", length, time_calls(
                lambda: da.decode_attention(qs, *cycled(caches), npast, **kw),
                args.reps, dev), kv_bytes * (length + 1) / s)
            # B4, the slab engine's fused step (RoPE, the row's write and
            # attention), at the same depth
            qkv = torch.randn((b, 1, 3 * H * D), generator=gen, device=dev)
            cos, sin = lane_tables(npast, D, D)
            kw4 = dict(head_dim=D, n_rot=D, scale=kw["scale"])
            k2, v2 = (x.clone() for x in caches[0])
            check(f"B4 len={length}",
                  da.decode_attention_fused(qkv, *caches[0], npast, cos, sin,
                                            **kw4),
                  da.decode_attention_fused_plain(qkv, k2, v2, npast, cos,
                                                  sin, **kw4), 2 ** -7)
            del k2, v2
            report("slab-fused (B4)", length, time_calls(
                lambda: da.decode_attention_fused(
                    qkv, *cycled(caches), npast, cos, sin, **kw4),
                args.reps, dev), kv_bytes * length / s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
