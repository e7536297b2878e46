#!/usr/bin/env python
"""Websocket chat server + model hot-swap — mirror of the reference's
examples/python/webui_srv.py, on fastllama_tpu_torch (protocol: 'P:<prompt>',
'load_model:<name>',
'list_models'; streamed tokens as 'ST:<chunk>', progress as 'Prog:<pct>',
end marker 'E:').

Serve, then open examples/html/webui_example.html in a browser.

    python examples_torch/python/webui_srv.py --models-dir ./models --port 8080

--device: a torch device ("cpu"); the default is the CUDA card.
"""
import argparse
import asyncio
import json
import sys
import threading
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fastllama_tpu_torch import Model
from fastllama_tpu_torch.engine.logger import Logger, ProgressTag


def list_models(models_dir: Path) -> list[str]:
    out = []
    for p in sorted(models_dir.iterdir()) if models_dir.exists() else []:
        if p.is_dir() and (p / "manifest.json").exists():
            out.append(p.name)
        elif p.suffix == ".bin":
            out.append(p.name)
    return out


async def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--models-dir", default="./models")
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--n-ctx", type=int, default=2048)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    try:
        import websockets
    except ImportError:
        print("the 'websockets' package is not installed in this environment; "
              "install it to run the web UI server", file=sys.stderr)
        return 1

    models_dir = Path(args.models_dir)
    state = {"model": None, "name": None}
    lock = threading.Lock()

    async def handler(ws):
        loop = asyncio.get_running_loop()

        def send(msg: str):
            asyncio.run_coroutine_threadsafe(ws.send(msg), loop)

        async for message in ws:
            if message == "list_models":
                await ws.send("Models: " + json.dumps(list_models(models_dir)))
            elif message.startswith("load_model:"):
                name = message[len("load_model:"):].strip()
                path = models_dir / name

                def progress(tag: ProgressTag, done: int, total: int):
                    if tag == ProgressTag.LOAD and total:
                        send(f"Prog:{100.0 * done / total:.1f}")

                def load():
                    with lock:
                        state["model"] = Model(
                            str(path), n_ctx=args.n_ctx,
                            logger=Logger(progress_fn=progress),
                            device=args.device)
                        state["name"] = name
                    send(f"Loaded:{name}")

                await loop.run_in_executor(None, load)
            elif message.startswith("P:"):
                prompt = message[2:]
                model = state["model"]
                if model is None:
                    await ws.send("Err:no model loaded")
                    continue

                def generate():
                    with lock:
                        if not model.ingest(prompt):
                            send("Err:ingest failed")
                            return
                        model.generate(
                            num_tokens=300, temp=0.8,
                            streaming_fn=lambda s: send("ST:" + s),
                            stop_words=["User:"])
                    send("E:")

                await loop.run_in_executor(None, generate)
            else:
                await ws.send("Err:unknown command")

    async with websockets.serve(handler, args.host, args.port):
        print(f"serving on ws://{args.host}:{args.port}  "
              f"(models dir: {models_dir})")
        await asyncio.Future()


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))
