#!/usr/bin/env python
"""Interactive chat REPL of the PyTorch port (tools/chat.py over
fastllama_tpu_torch.Model) — the counterpart of the reference's CLI chat
(src/alpaca.cpp:7-49, examples/python/example.py).

    python tools_torch/chat.py ./models/7B.fltpu --n-ctx 512    # on the card
    python tools_torch/chat.py ./models/7B.fltpu --device cpu   # plain PyTorch
    torchrun --nproc-per-node 2 tools_torch/chat.py ./models/7B.fltpu --tp 2

It runs on the CUDA card unless --device names another device; with no card
it fails rather than fall back to the CPU. --tp N serves the model over N
ranks (tensor parallelism) launched by torchrun: every rank runs this
program, rank 0 reads each line and broadcasts it, and rank 0 alone prints.

Special commands (parity with examples/python/example-lora-adapter.py:29-41):
    /load_lora <path>   attach a ggla adapter
    /unload_lora        detach the adapter
    /save <path>        save session state
    /load <path>        load session state
    /reset              reset the session
    /quit
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model")
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--n-batch", type=int, default=64)
    ap.add_argument("--n-keep", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--repeat-penalty", type=float, default=1.0)
    ap.add_argument("--num-tokens", type=int, default=300)
    ap.add_argument("--system-prompt", default=(
        "Below is an instruction that describes a task. Write a response "
        "that appropriately completes the request."))
    ap.add_argument("--stop-word", action="append", default=[],
                    help="may be given multiple times")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shards the model over a "
                         "(1, tp) mesh of torchrun's ranks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    read_line, say, logger = input, print, None
    if args.tp > 1:
        import torch.distributed as dist
        from fastllama_tpu_torch import Logger
        from fastllama_tpu_torch.parallel import multihost
        multihost.initialize(backend="gloo" if args.device == "cpu" else None)
        if dist.is_initialized() and dist.get_rank() != 0:
            logger = Logger()                   # silent

            def say(*a, **kw):
                return None

        def read_line(prompt):
            # rank 0 reads; every rank gets the line (None: end of input)
            line = [None]
            if not dist.is_initialized() or dist.get_rank() == 0:
                try:
                    line[0] = input(prompt)
                except (EOFError, KeyboardInterrupt):
                    pass
            if dist.is_initialized():
                dist.broadcast_object_list(line, src=0)
            if line[0] is None:
                raise EOFError
            return line[0]

    try:
        return _chat(args, read_line, say, logger)
    finally:
        if args.tp > 1 and dist.is_initialized():
            # every rank leaves together: a rank that exits while another
            # still holds the group (rank 0 hosts its store) can abort at
            # interpreter shutdown in a gloo thread ("terminate called
            # without an active exception")
            dist.barrier()
            dist.destroy_process_group()


def _chat(args, read_line, say, logger) -> int:
    from fastllama_tpu_torch import Model

    say("loading model (the first call on a card builds its kernels)...")
    model = Model(args.model, n_ctx=args.n_ctx, n_batch=args.n_batch,
                  tokens_to_keep=args.n_keep, seed=args.seed,
                  mesh_shape=(1, args.tp) if args.tp > 1 else (),
                  logger=logger, device=args.device)
    if args.system_prompt:
        if not model.ingest(args.system_prompt, is_system_prompt=True):
            print("failed to ingest system prompt", file=sys.stderr)
            return 1
    if args.stop_word:
        model.set_stop_words(*args.stop_word)

    def stream(chunk: str) -> None:
        say(chunk, end="", flush=True)

    while True:
        try:
            user = read_line("\n\nUser: ")
        except (EOFError, KeyboardInterrupt):
            break
        if not user.strip():
            continue
        if user.startswith("/"):
            cmd, *rest = user[1:].split(None, 1)
            arg = rest[0] if rest else ""
            if cmd == "quit":
                break
            elif cmd == "load_lora":
                say("attached" if model.attach_lora(arg) else "attach failed")
            elif cmd == "unload_lora":
                say("detached" if model.detach_lora() else "detach failed")
            elif cmd == "save":
                say("saved" if model.save_state(arg) else "save failed")
            elif cmd == "load":
                say("loaded" if model.load_state(arg) else "load failed")
            elif cmd == "reset":
                model.reset()
                if args.system_prompt:
                    model.ingest(args.system_prompt, is_system_prompt=True)
                say("reset")
            else:
                say(f"unknown command /{cmd}")
            continue

        if not model.ingest(user):
            say("ingest failed", file=sys.stderr)
            continue
        say("\nAssistant: ", end="", flush=True)
        model.generate(num_tokens=args.num_tokens, temp=args.temp,
                       top_k=args.top_k, top_p=args.top_p,
                       repeat_penalty=args.repeat_penalty,
                       streaming_fn=stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
