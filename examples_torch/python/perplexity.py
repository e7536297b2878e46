#!/usr/bin/env python
"""Perplexity evaluation — mirror of the reference's
examples/python/perplexity.py (8000-char text slice), on
fastllama_tpu_torch.

    python3 examples_torch/python/perplexity.py MODEL [TEXT] [DEVICE]

DEVICE: a torch device ("cpu"); the default is the CUDA card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fastllama_tpu_torch import Model

MODEL_PATH = sys.argv[1] if len(sys.argv) > 1 else "./models/7B.fltpu"
TEXT_PATH = sys.argv[2] if len(sys.argv) > 2 else "./wikitext-2/wiki.test.raw"
DEVICE = sys.argv[3] if len(sys.argv) > 3 else None

with open(TEXT_PATH, encoding="utf-8") as f:
    text = f.read()[:8000]

model = Model(MODEL_PATH, n_ctx=512, n_batch=512, should_get_all_logits=True,
              device=DEVICE)
ppl = model.perplexity(text)
print(f"\nFinal perplexity: {ppl:.4f}")
