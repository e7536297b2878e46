#!/usr/bin/env python
"""Export a HuggingFace LLaMA (optionally merging a PEFT LoRA adapter) to the
original Meta layout (consolidated.00.pth + params.json). The PyTorch
port's tools/export_hf.py, reading with fastllama_tpu_torch.

Counterpart of the reference's scripts/export-from-huggingface.py:66-175:
merges LoRA into the base weights and *unpermutes* wq/wk back from the HF
rotate-half layout to the original interleaved layout.

    python tools_torch/export_hf.py --base ./hf/llama-7b --lora ./peft-adapter \
        --out ./export/7B
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fastllama_tpu_torch.io.convert import _load_hf_tensors, hf_to_ggml_name

# HF name -> original Meta checkpoint name (reference export script mapping)
_STATIC = {
    "model.embed_tokens.weight": "tok_embeddings.weight",
    "model.norm.weight": "norm.weight",
    "lm_head.weight": "output.weight",
}
_LAYER = {
    "self_attn.q_proj.weight": "attention.wq.weight",
    "self_attn.k_proj.weight": "attention.wk.weight",
    "self_attn.v_proj.weight": "attention.wv.weight",
    "self_attn.o_proj.weight": "attention.wo.weight",
    "mlp.gate_proj.weight": "feed_forward.w1.weight",
    "mlp.down_proj.weight": "feed_forward.w2.weight",
    "mlp.up_proj.weight": "feed_forward.w3.weight",
    "input_layernorm.weight": "attention_norm.weight",
    "post_attention_layernorm.weight": "ffn_norm.weight",
}


def unpermute(w: np.ndarray, n_head: int) -> np.ndarray:
    """Inverse of the HF conversion permutation (reference:
    export-from-huggingface.py:99-108)."""
    return (w.reshape(n_head, w.shape[0] // n_head // 2, 2, *w.shape[1:])
             .swapaxes(1, 2)
             .reshape(w.shape))


def hf_to_orig_name(name: str) -> str | None:
    import re
    if name in _STATIC:
        return _STATIC[name]
    m = re.match(r"model\.layers\.(\d+)\.(.+)", name)
    if m and m.group(2) in _LAYER:
        return f"layers.{m.group(1)}.{_LAYER[m.group(2)]}"
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base", required=True, help="HF LLaMA model directory")
    ap.add_argument("--lora", default=None, help="PEFT adapter directory")
    ap.add_argument("--out", required=True, help="output directory")
    args = ap.parse_args()

    import torch

    base = Path(args.base)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    with open(base / "config.json") as f:
        cfg = json.load(f)
    n_head = cfg["num_attention_heads"]

    tensors = {k: np.asarray(v, np.float32)
               for k, v in _load_hf_tensors(base).items()}

    if args.lora:
        lora_dir = Path(args.lora)
        with open(lora_dir / "adapter_config.json") as f:
            lcfg = json.load(f)
        scale = float(lcfg["lora_alpha"]) / float(lcfg["r"])
        from tools_torch.convert_lora import load_adapter, translate  # noqa
        adapter = load_adapter(lora_dir)
        pairs: dict[str, dict[str, np.ndarray]] = {}
        for name, v in adapter.items():
            gname, kind = translate(name)
            pairs.setdefault(gname, {})[kind] = np.asarray(v, np.float32)
        # gname is ggml-style; map back to HF to merge
        ggml_to_hf = {hf_to_ggml_name(k): k for k in tensors
                      if hf_to_ggml_name(k)}
        merged = 0
        for gname, ab in pairs.items():
            hf_name = ggml_to_hf.get(gname)
            if hf_name is None or "A" not in ab or "B" not in ab:
                print(f"warning: cannot merge adapter tensor {gname}",
                      file=sys.stderr)
                continue
            tensors[hf_name] = tensors[hf_name] + (ab["B"] @ ab["A"]) * scale
            merged += 1
        print(f"merged {merged} LoRA deltas into the base weights")

    state = {}
    for hf_name, w in tensors.items():
        orig = hf_to_orig_name(hf_name)
        if orig is None:
            continue
        if orig.endswith("attention.wq.weight") or \
                orig.endswith("attention.wk.weight"):
            w = unpermute(w, n_head)
        state[orig] = torch.from_numpy(w).to(torch.float16)

    torch.save(state, out / "consolidated.00.pth")
    params = {
        "dim": cfg["hidden_size"],
        "multiple_of": 256,
        "n_heads": n_head,
        "n_layers": cfg["num_hidden_layers"],
        "norm_eps": cfg.get("rms_norm_eps", 1e-6),
        "vocab_size": -1,
    }
    with open(out / "params.json", "w") as f:
        json.dump(params, f)
    print(f"wrote {out}/consolidated.00.pth ({len(state)} tensors) "
          f"and params.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
