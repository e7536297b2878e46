#!/usr/bin/env python3
"""The decode matmul variants over a 7B decode layer's four matmuls on one
CUDA card (the port of tools/bench_kernels.py).

    python3 tools_torch/bench_kernels.py [--variants v0,v1,v2] [--layers 32]
        [--m 8] [--device D]

Each variant is the JAX package's q4_matmul_pallas(variant=) body run by
the kernel of the same function (kernels/q4_variants.q4_matmul_pallas, bf16
mode): v0 on B1, v1/v4/v5 on B15, v2 on B16, v3 on B17, v7 on B18. Each
chained layer runs wqkv -> wo -> w13 -> w2, every input a slice of the
previous output (data-dependent, as in the JAX tool), on random planes of
the JAX tool's shapes (codes 0-255, scales in [1e-3, 0.02]). Each plane is
first held against the variant's plain version (relerr: max error over the
largest |output|). Then --layers layers are captured in one CUDA graph and
timed between CUDA events: us a layer (the glue's small launches included)
and the layer's weight bytes over it. On --device cpu the plain versions
run on the host clock.
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools_torch._trace_util import open_device, time_calls  # noqa: E402

D = 4096
SHAPES = {                       # 7B decode matmuls
    "wqkv": (D, 12288),
    "wo": (D, D),
    "w13": (D, 22016),
    "w2": (11264, D),            # 11008 padded to a 256-multiple
}
LAYER_BYTES = sum(k // 2 * n + k // 32 * n * 4 for k, n in SHAPES.values())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="v0,v1,v2")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    args.variants = args.variants.split(",")
    from fastllama_tpu_torch.kernels.q4_variants import DECODE_VARIANTS
    for v in args.variants:
        if v not in DECODE_VARIANTS:
            ap.error(f"variant {v!r}: the JAX package's q4_matmul_pallas "
                     f"has {', '.join(DECODE_VARIANTS)}")
    if not 1 <= args.m <= 64 or args.layers < 1:
        ap.error("--m must be in [1, 64] and --layers at least 1")
    return args


def make_weight(gen, dev, k, n):
    from fastllama_tpu_torch.quant.tensor import QuantMatmulWeight
    qs = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                       dtype=torch.uint8)
    sc = torch.rand((k // 32, n), generator=gen, device=dev) * 0.019 + 1e-3
    return QuantMatmulWeight(qs=qs, scales=sc, n_logical=n)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = open_device(args.device, "bench_kernels")
    from fastllama_tpu_torch.kernels import q4_variants as qv
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    weights = {nm: make_weight(gen, dev, k, n) for nm, (k, n)
               in SHAPES.items()}
    print(f"per-layer weight bytes: {LAYER_BYTES / 1e6:.1f} MB", flush=True)
    x0 = torch.randn((args.m, D), generator=gen, device=dev)

    for variant in args.variants:
        def kern(x, w):
            return qv.q4_matmul_pallas(x, w.qs, w.scales, variant=variant)

        with torch.inference_mode():
            for nm, (k, n) in SHAPES.items():
                x = torch.randn((8, k), generator=gen, device=dev)
                y = kern(x, weights[nm])
                ref = qv.decode_plain(x, weights[nm].qs, weights[nm].scales,
                                      variant)
                err = ((y - ref).abs().max() / ref.abs().max()).item()
                print(f"  {variant} {nm:5s} relerr={err:.2e}", flush=True)

            def layer():
                y = kern(x0, weights["wqkv"])
                y = kern((y[:, :D] * 1e-3).contiguous(), weights["wo"])
                y = kern(y * 1e-3, weights["w13"])
                y = kern((y[:, :11264] * 1e-3).contiguous(), weights["w2"])
                x0.add_(y, alpha=1e-6)
            ms = time_calls(layer, args.layers, dev)
        clock = "device" if dev.type == "cuda" else "host (cpu)"
        print(f"{variant}: {ms * 1e3:8.1f} us/layer {clock}  "
              f"{LAYER_BYTES / ms / 1e6:6.1f} GB/s effective", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
