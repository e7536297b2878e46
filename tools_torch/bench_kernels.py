#!/usr/bin/env python3
"""The decode matmul B1 over a 7B decode layer's four matmuls on one CUDA
card (the port of tools/bench_kernels.py).

    python3 tools_torch/bench_kernels.py [--variants v1] [--layers 32]
        [--m 8] [--device D]

Each chained layer runs wqkv -> wo -> w13 -> w2 through
kernels/q4_matmul.q4_matmul_decode (B1, bf16 mode), every input a slice of
the previous output (data-dependent, as in the JAX tool), on random planes
of the JAX tool's shapes (codes 0-255, scales in [1e-3, 0.02]). Each plane
is first held against the dequant form (relerr: max error over the largest
|output|). Then --layers layers are captured in one CUDA graph and timed
between CUDA events: us a layer (the glue's small launches included) and
the layer's weight bytes over it. The JAX tool's TPU variants v0 and v2 of
B1's function were refuted on the TPU and are not ported: --variants takes
v1 only. On --device cpu the plain version runs on the host clock.
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
    ap.add_argument("--variants", default="v1")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    args.variants = args.variants.split(",")
    if args.variants != ["v1"]:
        ap.error("--variants takes v1 only: the JAX tool's v0 and v2 are TPU "
                 "variants of B1's function (q4_matmul_pallas) refuted on "
                 "the TPU and not ported")
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
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    weights = {nm: make_weight(gen, dev, k, n) for nm, (k, n)
               in SHAPES.items()}
    print(f"per-layer weight bytes: {LAYER_BYTES / 1e6:.1f} MB", flush=True)
    x0 = torch.randn((args.m, D), generator=gen, device=dev)

    def kern(x, w):
        return qm.q4_matmul_decode(x, w, torch.bfloat16)

    with torch.inference_mode():
        for nm, (k, n) in SHAPES.items():
            x = torch.randn((8, k), generator=gen, device=dev)
            y = kern(x, weights[nm])
            ref = qm.q4_matmul_dequant(x, weights[nm], torch.bfloat16)
            err = ((y - ref).abs().max() / ref.abs().max()).item()
            print(f"  v1 {nm:5s} relerr={err:.2e}", flush=True)

        def layer():
            y = kern(x0, weights["wqkv"])
            y = kern((y[:, :D] * 1e-3).contiguous(), weights["wo"])
            y = kern(y * 1e-3, weights["w13"])
            y = kern((y[:, :11264] * 1e-3).contiguous(), weights["w2"])
            x0.add_(y, alpha=1e-6)
        ms = time_calls(layer, args.layers, dev)
    clock = "device" if dev.type == "cuda" else "host (cpu)"
    print(f"v1: {ms * 1e3:8.1f} us/layer {clock}  "
          f"{LAYER_BYTES / ms / 1e6:6.1f} GB/s effective", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
