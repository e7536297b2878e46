#!/usr/bin/env python
"""Runtime LoRA adapter hot-swap — mirror of the reference's
examples/python/example-lora-adapter.py (REPL commands load_lora /
unload_lora / reset, reference lines 29-41), on fastllama_tpu_torch.

    python3 examples_torch/python/example-lora-adapter.py MODEL [ADAPTER]
        [DEVICE]

DEVICE: a torch device ("cpu"); the default is the CUDA card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fastllama_tpu_torch import Model

MODEL_PATH = sys.argv[1] if len(sys.argv) > 1 else "./models/7B.fltpu"
ADAPTER_PATH = sys.argv[2] if len(sys.argv) > 2 else "./models/ggml-adapter-model.bin"
DEVICE = sys.argv[3] if len(sys.argv) > 3 else None

model = Model(MODEL_PATH, n_ctx=512, device=DEVICE)

print("\nCommands: load_lora | unload_lora | reset | exit")
while True:
    user = input("\n\nUser: ")
    cmd = user.strip().lower()
    if cmd == "exit":
        break
    if cmd == "load_lora":
        print("attached" if model.attach_lora(ADAPTER_PATH) else "attach failed")
        continue
    if cmd == "unload_lora":
        print("detached" if model.detach_lora() else "detach failed")
        continue
    if cmd == "reset":
        model.reset()
        print("session reset")
        continue
    prompt = (
        "Below is an instruction that describes a task. Write a response "
        "that appropriately completes the request.\n\n"
        f"### Instruction:\n{user}\n\n### Response:\n")
    if not model.ingest(prompt):
        continue
    print("\nAssistant: ", end="", flush=True)
    model.generate(num_tokens=300, temp=0.1,
                   streaming_fn=lambda s: print(s, end="", flush=True),
                   stop_words=["###"])
