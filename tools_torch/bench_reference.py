#!/usr/bin/env python3
"""Measure the reference fastLLaMa's decode throughput on this host's CPU,
for bench_torch.py's vs_baseline (the port of tools/bench_reference.py).

    python3 tools_torch/bench_reference.py --lib BUILD/pyfastllama.so \\
        --ref-python REFERENCE/interfaces/python [--model PATH]
        [--gen-model] [--num-tokens 32]

Writes a synthetic LLaMA-7B q4_0 GGJT checkpoint (random codes and scales
from a seeded numpy generator, through the port's io/ggml_writer
.write_ggjt; decode speed does not depend on the values) unless --model
exists, loads it through the reference's own Python binding (the
directory --ref-python, against the library --lib built from the
reference's sources), times greedy generation and writes
baseline_ref.json. The reference library is not part of this repository:
the tests exercise gen_model only.
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fastllama_tpu_torch.config import FType, HyperParams  # noqa: E402
from fastllama_tpu_torch.engine.tokenizer import Vocab  # noqa: E402
from fastllama_tpu_torch.io.ggml_writer import write_ggjt  # noqa: E402

HP_7B = HyperParams(n_vocab=32000, n_ctx=512, n_embd=4096, n_mult=256,
                    n_head=32, n_layer=32, n_rot=128,
                    ftype=FType.MOSTLY_Q4_0)


def gen_model(path: str, hp: HyperParams = HP_7B) -> None:
    """A q4_0 GGJT file at hp's widths: codes 1-15 and scales in [1e-3,
    0.02] from numpy's default_rng(0), the vocab's " tN" words after the
    specials and byte tokens; the JAX tool's file at the same hp, byte for
    byte."""
    rng = np.random.default_rng(0)
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" t{i}".encode(), 1.0) for i in range(hp.n_vocab - 259)]
    vocab = Vocab.from_tokens(toks)

    def q4(n, k, scale=0.02):
        codes = rng.integers(1, 16, (n, k), dtype=np.uint8)
        scales = rng.uniform(1e-3, scale, (n, k // 32)).astype(np.float32)
        return ("q4_0", codes, scales)

    d, nff = hp.n_embd, hp.n_ff
    tensors = {
        "tok_embeddings.weight": q4(hp.n_vocab, d),
        "norm.weight": ("f32", np.ones(d, np.float32)),
        "output.weight": q4(hp.n_vocab, d),
    }
    for i in range(hp.n_layer):
        p = f"layers.{i}."
        tensors[p + "attention_norm.weight"] = ("f32", np.ones(d, np.float32))
        for w in ("wq", "wk", "wv", "wo"):
            tensors[p + f"attention.{w}.weight"] = q4(d, d)
        tensors[p + "ffn_norm.weight"] = ("f32", np.ones(d, np.float32))
        tensors[p + "feed_forward.w1.weight"] = q4(nff, d)
        tensors[p + "feed_forward.w2.weight"] = q4(d, nff)
        tensors[p + "feed_forward.w3.weight"] = q4(nff, d)
        print(f"\rlayer {i + 1}/{hp.n_layer}", end="", flush=True)
    print("\nwriting GGJT ...")
    write_ggjt(path, hp, vocab, tensors)
    print(f"wrote {path} ({os.path.getsize(path) / 1e9:.2f} GB)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", required=True, help="path to pyfastllama.so")
    ap.add_argument("--ref-python", required=True,
                    help="the reference's Python binding directory "
                         "(interfaces/python of its sources)")
    ap.add_argument("--model", default=os.path.join(tempfile.gettempdir(),
                                                    "ref7b.bin"))
    ap.add_argument("--gen-model", action="store_true")
    ap.add_argument("--num-tokens", type=int, default=32)
    ap.add_argument("--threads", type=int, default=os.cpu_count())
    ap.add_argument("--out", default=str(ROOT / "baseline_ref.json"))
    args = ap.parse_args(argv)

    if args.gen_model or not os.path.exists(args.model):
        gen_model(args.model)

    sys.path.insert(0, args.ref_python)
    import fastllama as ref_fastllama  # noqa: E402  (the reference's binding)
    ref_fastllama.set_library_path(str(Path(args.lib).parent))
    model = ref_fastllama.Model(
        path=args.model, num_threads=args.threads, n_ctx=512,
        should_get_all_logits=False)
    assert model.ingest("Hello world, this is a benchmark of"), "ingest failed"
    count = [0]

    def cb(s):
        count[0] += 1

    t0 = time.time()
    model.generate(num_tokens=args.num_tokens, temp=0.0, streaming_fn=cb)
    dt = time.time() - t0
    tps = args.num_tokens / dt
    print(f"reference: {args.num_tokens} tokens in {dt:.2f}s -> {tps:.2f} "
          f"tok/s")
    with open(args.out, "w") as f:
        json.dump({"tokens_per_sec": round(tps, 3),
                   "source": f"measured reference build on this host "
                             f"({args.threads} threads)",
                   "num_tokens": args.num_tokens}, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
