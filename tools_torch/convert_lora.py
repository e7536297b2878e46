#!/usr/bin/env python
"""Convert a HuggingFace PEFT LoRA adapter to the ggla format (the PyTorch
port's tools/convert_lora.py, writing with fastllama_tpu_torch).

Counterpart of the reference's scripts/convert-lora-to-ggml.py. Two modes:
  default (cached): ΔW = B·A·(alpha/r) precomputed per base tensor and
    stored as a single '<base>.lora' matrix — O(1) runtime attach
  --no-cache: stores scaled A^T ('<base>.loraA') and B ('<base>.loraB')
    for a low-rank runtime term (smaller file, same math)

    python tools_torch/convert_lora.py ./peft-adapter-dir [-t fp16] [--no-cache]
"""
import argparse
import json
import os
import re
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fastllama_tpu_torch.io.ggml_writer import write_ggla

HF_SUBLAYER_TO_GGML = {
    "self_attn.q_proj": "attention.wq",
    "self_attn.k_proj": "attention.wk",
    "self_attn.v_proj": "attention.wv",
    "self_attn.o_proj": "attention.wo",
    "mlp.gate_proj": "feed_forward.w1",
    "mlp.down_proj": "feed_forward.w2",
    "mlp.up_proj": "feed_forward.w3",
}


def translate(name: str) -> tuple[str, str]:
    m = re.match(
        r"base_model\.model\.model\.layers\.(\d+)\.(.+)\.lora_(A|B)\.weight",
        name)
    if not m:
        print(f"Error: unrecognized tensor {name}", file=sys.stderr)
        sys.exit(1)
    sub = m.group(2)
    if sub not in HF_SUBLAYER_TO_GGML:
        print(f"Error: unsupported sublayer {sub}", file=sys.stderr)
        sys.exit(1)
    return (f"layers.{m.group(1)}.{HF_SUBLAYER_TO_GGML[sub]}.weight",
            m.group(3))


def load_adapter(path: Path) -> dict[str, np.ndarray]:
    st = path / "adapter_model.safetensors"
    if st.exists():
        from safetensors.numpy import load_file
        return {k: np.asarray(v) for k, v in load_file(str(st)).items()}
    import torch
    sd = torch.load(str(path / "adapter_model.bin"), map_location="cpu",
                    weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="PEFT adapter directory")
    ap.add_argument("-t", "--dtype", choices=["fp16", "fp32"], default="fp32")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("-o", "--output", default=None,
                    help="output file (default: <path>/ggml-adapter-model.bin)")
    args = ap.parse_args()

    path = Path(args.path)
    with open(path / "adapter_config.json") as f:
        cfg = json.load(f)
    if cfg.get("peft_type") != "LORA":
        print(f"Error: unsupported adapter type {cfg.get('peft_type')}",
              file=sys.stderr)
        return 1
    if cfg.get("fan_in_fan_out"):
        print("Error: fan_in_fan_out is not supported", file=sys.stderr)
        return 1

    r = int(cfg["r"])
    alpha = int(cfg["lora_alpha"])
    scale = float(alpha) / r

    model = load_adapter(path)
    pairs: dict[str, dict[str, np.ndarray]] = {}
    for name, v in model.items():
        base, kind = translate(name)
        pairs.setdefault(base, {})[kind] = np.asarray(v, np.float32)

    tensors: dict[str, np.ndarray] = {}
    for base, ab in sorted(pairs.items()):
        if "A" not in ab or "B" not in ab:
            print(f"Error: incomplete A/B pair for {base}", file=sys.stderr)
            return 1
        A, B = ab["A"], ab["B"]          # A [r, in], B [out, r]
        if args.no_cache:
            tensors[base + ".loraA"] = (A * scale).T   # [in, r]
            tensors[base + ".loraB"] = B               # [out, r]
        else:
            tensors[base + ".lora"] = (B @ A) * scale  # [out, in]

    out = args.output or str(path / "ggml-adapter-model.bin")
    write_ggla(out, r=r, alpha=alpha, use_cache=not args.no_cache,
               tensors=tensors, fp16=(args.dtype == "fp16"))
    print(f"Converted {path} to {out} "
          f"({'no-cache' if args.no_cache else 'cached ΔW'} mode)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
