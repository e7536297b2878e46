#!/usr/bin/env python
"""Custom logger with progress callbacks — mirror of the reference's
examples/python/example-logging.py, on fastllama_tpu_torch.

    python3 examples_torch/python/example-logging.py MODEL [DEVICE]

DEVICE: a torch device ("cpu"); the default is the CUDA card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fastllama_tpu_torch import Model
from fastllama_tpu_torch.engine.logger import Logger, ProgressTag

MODEL_PATH = sys.argv[1] if len(sys.argv) > 1 else "./models/7B.fltpu"
DEVICE = sys.argv[2] if len(sys.argv) > 2 else None

LOG_FILE = open("fastllama.log", "w")


def log(func, msg):
    LOG_FILE.write(f"[INFO] {func}: {msg}")
    LOG_FILE.flush()


def log_err(func, msg):
    LOG_FILE.write(f"[ERROR] {func}: {msg}")
    sys.stderr.write(f"[ERROR] {func}: {msg}")


def progress(tag: ProgressTag, done: int, total: int):
    if total:
        print(f"\r[{tag.name}] {100.0 * done / total:5.1f}%",
              end="\n" if done >= total else "", flush=True)


logger = Logger(log_fn=log, log_err_fn=log_err, progress_fn=progress)
model = Model(MODEL_PATH, n_ctx=512, logger=logger, device=DEVICE)

model.ingest("The capital of France is")
model.generate(num_tokens=20, temp=0.0,
               streaming_fn=lambda s: print(s, end="", flush=True))
print("\n(see fastllama.log for the log stream)")
