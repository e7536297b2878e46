"""Shared pieces of the bench and profiling tools (the port of
tools/_trace_util.py): the trace parsing of the package's tracing module
(fastllama_tpu_torch/utils/trace.py), re-exported, the prompt builder and
toy vocab of the bench tools, and what the port's tools add: the device a
tool runs on (the card unless --device names another, printed with its
power limit) and the timing of a call (the package's CUDA-graph timing on
the card, the host clock on the CPU)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fastllama_tpu_torch.utils.trace import (   # noqa: E402,F401
    copies_for,
    device_op_breakdown as load_device_op_breakdown,
    print_breakdown,
    time_ms,
)


def build_prompt_tokens(vocab, target_tokens: int) -> str:
    """A " wN"-word prompt that tokenizes to >= target_tokens (the bench
    vocab byte-tokenizes words it does not hold, so prompts are sized in
    tokens, not words)."""
    from fastllama_tpu_torch.engine.tokenizer import tokenize
    words = []
    i = 0
    while True:
        words.append(f"w{i % 700}")
        i += 1
        if i % 8 == 0 and len(tokenize(
                vocab, " " + " ".join(words), bos=True)) >= target_tokens:
            return " ".join(words)


def bench_vocab():
    """The JAX bench tools' toy vocab: the three specials, 256 byte tokens
    and " w0".." w740"; ids past it (the head samples any of the model's
    n_vocab) detokenize to nothing."""
    from fastllama_tpu_torch.engine.tokenizer import Vocab
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" w{i}".encode(), 1.0) for i in range(741)]
    return Vocab.from_tokens(toks)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them (the
    device name alone where nvidia-smi is missing)."""
    import subprocess

    import torch
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def open_device(name: str | None, tool: str):
    """The device a tool runs on: the CUDA card unless `name` names another
    (resolve_device raises without a card); on the card, print it with its
    power limit and build the kernels."""
    import torch
    from fastllama_tpu_torch.config import resolve_device
    dev = resolve_device(name)
    if dev.type == "cuda":
        from fastllama_tpu_torch.kernels import cuda_lib
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"{tool}: card {card_line()}", flush=True)
        cuda_lib.build()
    else:
        print(f"{tool}: on {dev}: plain PyTorch versions, host clock",
              flush=True)
    return dev


def time_calls(fn, calls: int, device, replays: int = 3) -> float:
    """ms of one fn() call: on the card time_ms (CUDA events around replays
    of a CUDA graph of `calls` calls, so no host cost is in the number); on
    the CPU the host clock of `calls` calls."""
    import time
    if device.type == "cuda":
        return time_ms(fn, calls, replays)
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e3 / calls
