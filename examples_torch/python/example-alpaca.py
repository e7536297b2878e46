#!/usr/bin/env python
"""Alpaca-format chat — mirror of examples/python/example-alpaca.py, on
fastllama_tpu_torch.

    python3 examples_torch/python/example-alpaca.py MODEL [DEVICE]

DEVICE: a torch device ("cpu"); the default is the CUDA card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fastllama_tpu_torch import Model

MODEL_PATH = sys.argv[1] if len(sys.argv) > 1 else "./models/alpaca-7B.fltpu"
DEVICE = sys.argv[2] if len(sys.argv) > 2 else None

model = Model(MODEL_PATH, n_ctx=512, device=DEVICE)

print("\nStart of chat (type 'exit' to quit)")
while True:
    user = input("\n\nUser: ")
    if user.strip().lower() == "exit":
        break
    prompt = (
        "Below is an instruction that describes a task. Write a response "
        "that appropriately completes the request.\n\n"
        f"### Instruction:\n{user}\n\n### Response:\n")
    if not model.ingest(prompt):
        continue
    print("\nAssistant: ", end="", flush=True)
    model.generate(num_tokens=300, temp=0.1, repeat_penalty=1.0,
                   streaming_fn=lambda s: print(s, end="", flush=True),
                   stop_words=["###"])
