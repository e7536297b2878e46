#!/usr/bin/env python
"""Offline quantizer CLI of the PyTorch port (tools/quantize.py over
fastllama_tpu_torch) — parity with the reference's quantize tool
(src/quantize.cpp:6-54): model-in, model-out, target type. Host code only.

    python tools_torch/quantize.py ./models/7B/ggml-model-f16.bin ./models/7B-q4.fltpu 2

Type codes follow the reference (2 = q4_0). HF directories are accepted too.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fastllama_tpu_torch.config import FType
from fastllama_tpu_torch.engine.logger import DefaultLogger
from fastllama_tpu_torch.io.convert import quantize


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model_in")
    ap.add_argument("model_out")
    ap.add_argument("type", type=int, nargs="?", default=2,
                    help="2 = q4_0 (default)")
    args = ap.parse_args()

    try:
        ftype = FType(args.type)
    except ValueError:
        print(f"invalid quantization type {args.type}", file=sys.stderr)
        return 1
    if ftype not in (FType.MOSTLY_Q4_0, FType.MOSTLY_F16, FType.ALL_F32):
        print(f"unsupported quantization type {ftype!r}", file=sys.stderr)
        return 1

    t0 = time.time()
    quantize(args.model_in, args.model_out, ftype, logger=DefaultLogger())
    print(f"\nquantize: took {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
