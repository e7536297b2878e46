#!/usr/bin/env python
"""Convert a checkpoint (ggml-family file or HuggingFace LLaMA directory)
into the fltpu format, or any readable checkpoint into a GGJT file.

The PyTorch port's tools/convert.py (over fastllama_tpu_torch), the
counterpart of the reference's scripts/convert.py. Host code only. Examples:

    python tools_torch/convert.py ./models/7B/ggml-model-q4_0.bin ./models/7B.fltpu
    python tools_torch/convert.py ./hf/llama-7b ./models/7B.fltpu --ftype q4_0
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fastllama_tpu_torch.config import FType
from fastllama_tpu_torch.engine.logger import DefaultLogger
from fastllama_tpu_torch.io.convert import convert_ggml, convert_hf, export_ggjt

FTYPES = {"f32": FType.ALL_F32, "f16": FType.MOSTLY_F16,
          "q4_0": FType.MOSTLY_Q4_0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="ggml .bin file, fltpu dir, or HF model dir")
    ap.add_argument("dst", help="output path (.fltpu dir or .bin for ggjt)")
    ap.add_argument("--ftype", choices=sorted(FTYPES), default="q4_0")
    ap.add_argument("--format", choices=["fltpu", "ggjt"], default="fltpu",
                    help="ggjt writes a file the reference ecosystem loads")
    ap.add_argument("--n-ctx", type=int, default=2048,
                    help="default context length recorded in the manifest")
    args = ap.parse_args()

    logger = DefaultLogger()
    src = Path(args.src)
    if args.format == "ggjt":
        export_ggjt(args.src, args.dst, FTYPES[args.ftype], logger=logger)
    elif src.is_dir() and (src / "config.json").exists():
        convert_hf(args.src, args.dst, FTYPES[args.ftype], n_ctx=args.n_ctx,
                   logger=logger)
    else:
        convert_ggml(args.src, args.dst, FTYPES[args.ftype], logger=logger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
