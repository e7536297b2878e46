#!/usr/bin/env python
"""Vicuna-format chat — mirror of examples/python/example-vicuna.py, on
fastllama_tpu_torch.

    python3 examples_torch/python/example-vicuna.py MODEL [DEVICE]

DEVICE: a torch device ("cpu"); the default is the CUDA card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fastllama_tpu_torch import Model

MODEL_PATH = sys.argv[1] if len(sys.argv) > 1 else "./models/vicuna-7B.fltpu"
DEVICE = sys.argv[2] if len(sys.argv) > 2 else None

model = Model(MODEL_PATH, n_ctx=512, device=DEVICE)

system = ("A chat between a curious user and an artificial intelligence "
          "assistant. The assistant gives helpful, detailed, and polite "
          "answers to the user's questions.")
model.ingest(system, is_system_prompt=True)

print("\nStart of chat (type 'exit' to quit)")
while True:
    user = input("\n\nUSER: ")
    if user.strip().lower() == "exit":
        break
    if not model.ingest(f"USER: {user}\nASSISTANT:"):
        continue
    print("\nASSISTANT: ", end="", flush=True)
    model.generate(num_tokens=300, temp=0.7,
                   streaming_fn=lambda s: print(s, end="", flush=True),
                   stop_words=["USER:", "</s>"])
