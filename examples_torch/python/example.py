#!/usr/bin/env python
"""Basic chat with a resident system prompt — mirror of the reference's
examples/python/example.py, on fastllama_tpu_torch.

    python3 examples_torch/python/example.py MODEL [DEVICE]

DEVICE: a torch device ("cpu"); the default is the CUDA card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fastllama_tpu_torch import Model

MODEL_PATH = sys.argv[1] if len(sys.argv) > 1 else "./models/7B.fltpu"
DEVICE = sys.argv[2] if len(sys.argv) > 2 else None

print("loading model (first compile may take a minute)...")
model = Model(MODEL_PATH, n_ctx=512, device=DEVICE)

system_prompt = (
    "Below is an instruction that describes a task. Write a response that "
    "appropriately completes the request.")
if not model.ingest(system_prompt, is_system_prompt=True):
    raise SystemExit("failed to ingest system prompt")

print("\nStart of chat (type 'exit' to quit)")
while True:
    user = input("\n\nUser: ")
    if user.strip().lower() == "exit":
        break
    if not model.ingest(user):
        print("ingest failed", file=sys.stderr)
        continue
    print("\nAssistant: ", end="", flush=True)
    model.generate(
        num_tokens=300, top_p=0.95, top_k=40, temp=0.8, repeat_penalty=1.0,
        streaming_fn=lambda s: print(s, end="", flush=True),
        stop_words=["User:"])
