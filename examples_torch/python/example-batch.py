#!/usr/bin/env python
"""Continuous batching: many concurrent generations through one model —
a capability the reference does not have — on fastllama_tpu_torch.

    python3 examples_torch/python/example-batch.py MODEL [DEVICE]

DEVICE: a torch device ("cpu"); the default is the CUDA card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fastllama_tpu_torch.config import RuntimeConfig
from fastllama_tpu_torch.engine.scheduler import BatchEngine, Request
from fastllama_tpu_torch.models.loader import load_model

MODEL_PATH = sys.argv[1] if len(sys.argv) > 1 else "./models/7B.fltpu"
DEVICE = sys.argv[2] if len(sys.argv) > 2 else None

rcfg = RuntimeConfig(n_ctx=2048)
model = load_model(MODEL_PATH, rcfg, device=DEVICE)
engine = BatchEngine(model.hp, model.params, model.vocab,
                     n_slots=8, n_ctx=2048, rcfg=rcfg, temp=0.8,
                     device=DEVICE)

prompts = [
    "The capital of France is",
    "Once upon a time, in a land far away,",
    "The three laws of robotics are",
    "To make a great cup of coffee, you need",
    "The fastest land animal is",
    "In the year 2050, computers will",
]
requests = [Request(prompt=p, max_tokens=64) for p in prompts]
engine.run(requests)

for req in requests:
    print(f"\n=== {req.prompt!r} ===")
    print(req.text)
