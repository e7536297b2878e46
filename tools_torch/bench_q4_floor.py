#!/usr/bin/env python3
"""The q4 decode matmul's memory floor on one CUDA card: how fast does the
decode kernel's skeleton move the packed weight bytes when its body does
(almost) nothing? The port of tools/bench_q4_floor.py.

    python3 tools_torch/bench_q4_floor.py [K] [N] [M] [modes] [--device D]

The probes run the decode kernel of B15-B18 (kernels/csrc/q4_fold.cuh,
built as csrc/q4_fold_probe.cu) on B15's plan at f32 scales: its TMA
rings, persistent clusters, x warps and cluster merge, with less body:
  floor  B13 (kernels/q4_floor.q4_floor): the whole packed byte as a bf16
         weight against x_lo, one k16 step a q block; no unpack, no
         scales, no fold
  nosc   B14 (q4_floor.q4_nosc): both nibbles against x_lo / x_hi, the
         scale plane never read, no fold
  v0 .. v5, v7
         the JAX package's q4_matmul_pallas bodies by the kernel of the
         same function (kernels/q4_variants.py, bf16 mode): v0 on B1 (the
         port's production kernel), v1/v4/v5 on B15, v2 on B16, v3 on B17,
         v7 on B18
Defaults: K 4096, N 12288, M 8, modes floor,nosc,v0,v1,v3 (the JAX tool's
floor,nosc,v1,v3 and B1). The gaps between floor, nosc and v1 split B15's
time into the skeleton, the unpack and the scales with the fold; v0 is B1
on its own skeleton.

Each mode is first held against its plain version (max error over the
largest |output|). Timing: 64 calls chained through x (each call's first
output column added into x, times 0, so the values stay put), as the JAX
tool chains them, in a CUDA graph replayed between CUDA events, with the
weight planes cycled through copies past the 50 MB L2; the chain's own add,
timed alone the same way, is subtracted. Prints us a call, GB/s of the
bytes it must move (qs, x and out: floor reads only x_lo, the variants the
scales) and the bound at 3.35 TB/s (the H100's HBM rate); the card and
its power limit first. On --device cpu the plain versions run on the host
clock. The last line is one JSON object with the rows and each kernel's
launches in this run.
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

PROBES = ("floor", "nosc")
DEFAULT_MODES = "floor,nosc,v0,v1,v3"
HBM_BYTES_PER_S = 3.35e12
REPS = 64                    # chained calls in the timed graph


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("k", nargs="?", type=int, default=4096)
    ap.add_argument("n", nargs="?", type=int, default=12288)
    ap.add_argument("m", nargs="?", type=int, default=8)
    ap.add_argument("modes", nargs="?", default=DEFAULT_MODES)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    args.modes = args.modes.split(",")
    from fastllama_tpu_torch.kernels.q4_variants import DECODE_VARIANTS
    for mode in args.modes:
        if mode not in PROBES + DECODE_VARIANTS:
            ap.error(f"mode {mode!r}: the modes are "
                     f"{', '.join(PROBES + DECODE_VARIANTS)}")
    if args.k % 32 or args.n % 16 or not 1 <= args.m <= 64:
        ap.error("K must be a multiple of 32, N of 16, and 1 <= M <= 64")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = open_device(args.device, "bench_q4_floor")
    from fastllama_tpu_torch.kernels import q4_floor as qf
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    from fastllama_tpu_torch.kernels import q4_variants as qv
    from fastllama_tpu_torch.quant.tensor import QuantMatmulWeight
    k, n, m = args.k, args.n, args.m
    print(f"K={k} N={n} M={m}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    qs_bytes, sc_bytes = k // 2 * n, k // 32 * n * 4
    planes = []
    n_copies = copies_for(qs_bytes + sc_bytes) if dev.type == "cuda" else 2
    for _ in range(n_copies):
        qs = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                           dtype=torch.uint8)
        sc = torch.randn((k // 32, n), generator=gen, device=dev)
        planes.append(QuantMatmulWeight(qs=qs, scales=sc, n_logical=n))
    x = torch.randn((m, k), generator=gen, device=dev)
    kernels = {
        "floor": (lambda x, w: qf.q4_floor(x, w.qs),
                  lambda x, w: qf.q4_floor_plain(x, w.qs)),
        "nosc": (lambda x, w: qf.q4_nosc(x, w.qs),
                 lambda x, w: qf.q4_nosc_plain(x, w.qs)),
        **{v: (lambda x, w, v=v: qv.q4_matmul_pallas(x, w.qs, w.scales,
                                                     variant=v),
               lambda x, w, v=v: qv.decode_plain(x, w.qs, w.scales, v))
           for v in qv.DECODE_VARIANTS},
    }
    rows = []
    with torch.inference_mode():
        # the chain's own add, timed alone: subtracted from each mode
        y0 = torch.zeros((m, n), device=dev)
        chain_ms = time_calls(lambda: x.add_(y0[:, :1], alpha=0.0),
                              REPS, dev)
        for mode in args.modes:
            kern, plain = kernels[mode]
            y = kern(x, planes[0])
            ref = plain(x, planes[0])
            err = ((y - ref).abs().max() / ref.abs().max()).item()
            it = iter(range(10**9))

            def call():
                yy = kern(x, planes[next(it) % len(planes)])
                x.add_(yy[:, :1], alpha=0.0)
            ms = time_calls(call, REPS, dev) - chain_ms
            # floor reads only x's low halves (x_lo); the variants the scales
            x_bytes = x.numel() * (2 if mode == "floor" else 4)
            nbytes = qs_bytes + x_bytes + m * n * 4 + (
                0 if mode in PROBES else sc_bytes)
            bound_us = nbytes / HBM_BYTES_PER_S * 1e6
            row = dict(mode=mode, us=ms * 1e3, gb_per_s=nbytes / ms / 1e6,
                       bound_us=bound_us, bytes=nbytes, relerr=err,
                       chain_add_us=chain_ms * 1e3)
            rows.append(row)
            clock = "device" if dev.type == "cuda" else "host (cpu)"
            print(f"{mode:6s}: {row['us']:8.3f} us {clock}  "
                  f"{row['gb_per_s']:7.1f} GB/s  (bound@3.35TB/s: "
                  f"{bound_us:.3f} us)  relerr {err:.2e}", flush=True)
    launches = {"q4_floor": qf.q4_floor.launches,
                "q4_nosc": qf.q4_nosc.launches,
                "q4_matmul_decode": qm.q4_matmul_decode.launches,
                **{fn.__name__: fn.launches for fn in (
                    qv.q4_decode_v1, qv.q4_decode_v2, qv.q4_decode_v3,
                    qv.q4_decode_v7)}}
    print(json.dumps({"bench_q4_floor": rows, "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
