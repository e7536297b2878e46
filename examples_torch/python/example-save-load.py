#!/usr/bin/env python
"""Session state save/load for fast context switching — mirror of the
reference's examples/python/example-save-load.py (lines 29-35), on
fastllama_tpu_torch.

    python3 examples_torch/python/example-save-load.py MODEL [DEVICE]

DEVICE: a torch device ("cpu"); the default is the CUDA card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fastllama_tpu_torch import Model

MODEL_PATH = sys.argv[1] if len(sys.argv) > 1 else "./models/7B.fltpu"
DEVICE = sys.argv[2] if len(sys.argv) > 2 else None
STATE_PATH = "./model_state.npz"

model = Model(MODEL_PATH, n_ctx=512, device=DEVICE)

model.ingest("Here is a story about a dragon named Ember:", is_system_prompt=True)
print("Generating opening...")
model.generate(num_tokens=60, temp=0.8,
               streaming_fn=lambda s: print(s, end="", flush=True))

print(f"\n\nSaving session to {STATE_PATH} ...")
assert model.save_state(STATE_PATH)

print("Continuing original session:")
model.generate(num_tokens=40, temp=0.8,
               streaming_fn=lambda s: print(s, end="", flush=True))

print(f"\n\nRestoring saved session from {STATE_PATH} ...")
assert model.load_state(STATE_PATH)
print("Continuing restored session (same RNG + KV state):")
model.generate(num_tokens=40, temp=0.8,
               streaming_fn=lambda s: print(s, end="", flush=True))
print()
