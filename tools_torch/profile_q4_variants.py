#!/usr/bin/env python3
"""Compare the q4 matmul variants by their device time from a profiler
trace on one CUDA card (the port of tools/profile_q4_variants.py).

    python3 tools_torch/profile_q4_variants.py [K] [N] [M] [variants...]
        [--device D]

Defaults: K 4096, N 12288, M 8, variants v1 v3. The variants are the JAX
tool's names, each run by the kernel of the same function
(kernels/q4_variants.py):
  v0 .. v5, v7  q4_matmul_pallas(variant=): v0 on B1, v1/v4/v5 on B15, v2
                on B16, v3 on B17, v7 on B18 (M <= 64)
  <v>h          the same with bf16 scales, read as 2-byte values
  floor, nosc   the probes B13 and B14 (tools_torch/bench_q4_floor.py)
  pf            q4_matmul_prefill_pallas (nat): B5
  pfi8          q4_matmul_prefill_int8 (nat): B2 + B3
  pfi8s         q4_matmul_prefill_int8 (split): B19 (M <= 512)
  xla           q4_matmul_xla's function as the plain PyTorch dequant and
                matmul (q4_matmul.q4_matmul_dequant): the library yardstick
Random planes as the JAX tool makes them (codes 0-254, scales N(0, 0.1)),
x rounded to bf16 values. Each variant is first held against its plain
version (max error over the largest |output|). Then 32 calls, chained
through x (each call's first output column added into x, times 0) over
weight copies cycled past the 50 MB L2, run under torch.profiler after a
warm chain, and again as a CUDA graph between CUDA events (the package's
utils/trace.time_ms); the chain's own adds, timed alone the same ways, are
taken off. Prints us a call of device time from the trace, or from the
graph where no trace held every launch (a trace with a launch count that
is no multiple of 32 is taken again, up to three times; one whose time
falls below the bound is dropped), the graph's
beside it, the kernels that took the trace's time, GB/s of the bytes the
call must move (the planes, x and the output; floor reads x's low halves
and no scales, nosc no scales) and the bound at 3.35 TB/s (the H100's HBM
rate); the card and its power limit first. On --device cpu the plain
versions run on the host clock. The last line is one JSON object
with the rows and each kernel's launches in this run.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools_torch._trace_util import (  # noqa: E402
    copies_for, open_device, time_calls,
)

DECODE = ("v0", "v1", "v2", "v3", "v4", "v5", "v7")
VARIANTS = DECODE + tuple(v + "h" for v in DECODE) + (
    "floor", "nosc", "pf", "pfi8", "pfi8s", "xla")
HBM_BYTES_PER_S = 3.35e12
REPS = 32                    # chained calls in a traced chain


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("k", nargs="?", type=int, default=4096)
    ap.add_argument("n", nargs="?", type=int, default=12288)
    ap.add_argument("m", nargs="?", type=int, default=8)
    ap.add_argument("variants", nargs="*", default=["v1", "v3"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    for v in args.variants:
        if v not in VARIANTS:
            ap.error(f"variant {v!r}: the JAX tool's names are "
                     f"{', '.join(VARIANTS)}")
    if args.k % 64 or args.n % 16 or args.m < 1:
        ap.error("K must be a multiple of 64, N of 16, and M at least 1")
    limit = {v: 64 for v in args.variants
             if v.rstrip("h") in DECODE or v in ("floor", "nosc")}
    limit.update({v: 512 for v in args.variants if v == "pfi8s"})
    for v, most in limit.items():
        if args.m > most:
            ap.error(f"variant {v} takes M <= {most}")
    return args


def calls(name):
    """(kernel call, plain version, bf16 scales?) of variant `name`, each
    called as f(x, qs, scales)."""
    from fastllama_tpu_torch.kernels import q4_floor as qf
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.kernels import q4_variants as qv
    from fastllama_tpu_torch.quant.tensor import QuantMatmulWeight

    def dense(x, qs, sc):
        return qm.q4_matmul_dequant(
            x, QuantMatmulWeight(qs=qs, scales=sc), torch.bfloat16)

    def int8_plain(x, qs, sc):
        w = QuantMatmulWeight(qs=qs, scales=sc)
        return qm.q4_matmul_prefill_int8_plain(
            *qm.quant_rows_int8_plain(x, w.k), w)
    if name in ("floor", "nosc"):
        kern, plain = ((qf.q4_floor, qf.q4_floor_plain) if name == "floor"
                       else (qf.q4_nosc, qf.q4_nosc_plain))
        return (lambda x, qs, sc: kern(x, qs),
                lambda x, qs, sc: plain(x, qs), False)
    if name == "pf":
        return qv.q4_matmul_prefill_pallas, dense, False
    if name == "pfi8":
        return qv.q4_matmul_prefill_int8, int8_plain, False
    if name == "pfi8s":
        return (lambda x, qs, sc: qv.q4_matmul_prefill_int8(
            x, qs, sc, variant="split"), qv.q4_prefill_int8_natx_plain, False)
    if name == "xla":
        return dense, dense, False
    base = name[:-1] if name.endswith("h") else name
    return (lambda x, qs, sc: qv.q4_matmul_pallas(x, qs, sc, variant=base),
            lambda x, qs, sc: qv.decode_plain(x, qs, sc, base),
            name.endswith("h"))


def call_bytes(name, k, n, m) -> int:
    """The bytes a call must move: qs, the scales (2 bytes each for the h
    forms, none for the probes), x (f32; floor reads its low halves) and
    the f32 output."""
    scale_bytes = {"floor": 0, "nosc": 0}.get(
        name, 2 if name.endswith("h") else 4)
    x_bytes = m * k * (2 if name == "floor" else 4)
    return k // 2 * n + k // 32 * n * scale_bytes + x_bytes + m * n * 4


def trace_kernels(prof_fn, dev, traces: int = 3) -> tuple[dict, bool]:
    """({kernel name: (device us, launches)} of one prof_fn() run from a
    torch.profiler trace, whether the trace held every launch), after one
    untraced run. Every kernel of a run launches a multiple of REPS times;
    the tracer on the H100 has lost launches from a trace now and then, so
    a trace with another count is printed and taken again, up to `traces`
    times."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    prof_fn()
    torch.cuda.synchronize(dev)
    for attempt in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_fn()
            torch.cuda.synchronize(dev)
        by_name = cs.kernel_device_us(prof)
        if by_name and all(n % REPS == 0 for _, n in by_name.values()):
            return by_name, True
        print(f"profiler: trace {attempt} of {traces} holds launch counts "
              f"{[(k[:40], n) for k, (_, n) in by_name.items()]}, not "
              f"multiples of {REPS}", flush=True)
    return by_name, False


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = open_device(args.device, "profile_q4_variants")
    from fastllama_tpu_torch.kernels import q4_floor as qf
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.kernels import q4_variants as qv
    k, n, m = args.k, args.n, args.m
    print(f"device={dev} K={k} N={n} M={m}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_copies = (copies_for(k // 2 * n + k // 32 * n * 4)
                if dev.type == "cuda" else 2)
    planes = [(torch.randint(0, 255, (k // 2, n), generator=gen, device=dev,
                             dtype=torch.uint8),
               torch.randn((k // 32, n), generator=gen, device=dev) * 0.1)
              for _ in range(n_copies)]
    planes16 = [(qs, sc.to(torch.bfloat16)) for qs, sc in planes]
    x = torch.randn((m, k), generator=gen, device=dev).to(
        torch.bfloat16).to(torch.float32)
    on_card = dev.type == "cuda"
    rows = []
    with torch.inference_mode():
        y0 = torch.zeros((m, n), device=dev)

        def glue():
            x.add_(y0[:, :1], alpha=0.0)
        glue_graph_us = time_calls(glue, REPS, dev) * 1e3
        if on_card:
            by_name, glue_ok = trace_kernels(
                lambda: [glue() for _ in range(REPS)], dev)
            glue_trace_us = sum(v[0] for v in by_name.values())
        for name in args.variants:
            kern, plain, sc16 = calls(name)
            ps = planes16 if sc16 else planes
            y = kern(x, *ps[0])
            ref = plain(x, *ps[0])
            err = ((y - ref).abs().max() / ref.abs().max()).item()
            it = iter(range(10**9))

            def call():
                yy = kern(x, *ps[next(it) % len(ps)])
                x.add_(yy[:, :1], alpha=0.0)
            graph_us = time_calls(call, REPS, dev) * 1e3 - glue_graph_us
            trace_us, top = None, []
            if on_card:
                by_name, ok = trace_kernels(
                    lambda: [call() for _ in range(REPS)], dev)
                top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
            nbytes = call_bytes(name, k, n, m)
            bound_us = nbytes / HBM_BYTES_PER_S * 1e6
            if on_card and ok and glue_ok:
                # a time below the bound is a trace that lost launches too
                t = (sum(v[0] for v in by_name.values())
                     - glue_trace_us) / REPS
                trace_us = t if t >= bound_us else None
            us = graph_us if trace_us is None else trace_us
            row = dict(variant=name, us=us, calls=REPS,
                       source=("trace" if trace_us is not None else
                               "graph" if on_card else "host (cpu)"),
                       trace_us=trace_us, graph_us=graph_us,
                       gb_per_s=nbytes / us / 1e3, bytes=nbytes,
                       bound_us=bound_us, relerr=err,
                       kernels=[(nm[:60], t / REPS) for nm, (t, _) in top])
            rows.append(row)
            print(f"{name:5s}: {us:8.2f} us/call ({row['source']}; graph "
                  f"{graph_us:.2f}, x{REPS})  {row['gb_per_s']:7.1f} GB/s  "
                  f"(bound@3.35TB/s: {bound_us:.2f} us)  relerr {err:.2e}",
                  flush=True)
            for nm, t in row["kernels"]:
                print(f"        {t:8.2f} us  {nm}", flush=True)
    launches = {fn.__name__: fn.launches for fn in (
        qm.q4_matmul_decode, qv.q4_decode_v1, qv.q4_decode_v2,
        qv.q4_decode_v3, qv.q4_decode_v7, qf.q4_floor, qf.q4_nosc,
        qm.q4_matmul_prefill, qm.quant_rows_int8, qm.q4_matmul_prefill_int8,
        qv.q4_prefill_int8_natx)}
    print(json.dumps({"profile_q4_variants": rows, "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
