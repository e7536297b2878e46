#!/usr/bin/env python3
"""Where an engine admission's time goes, on one CUDA card.

    python3 tools_torch/engine_admission.py     # from the repository root

For each engine mode (paged, paged with chunked admission, slab) at 7B
widths (32 layers, 8 slots, n_ctx 512, pages of 64 rows, seeded weights) one
300-token request is admitted into an idle engine several times. Each line
gives, per engine step of that request up to its first streamed token: the
host clock of the step ending in a synchronize, its device time and its
device launches from a torch.profiler trace, and the five kernels with the
most device time. The first step of a monolithic admission holds the
prefill and one decode step; a chunked admission spreads the prefill over
its first steps.
"""
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fastllama_tpu_torch.config import PRESETS, RuntimeConfig  # noqa: E402
from fastllama_tpu_torch.engine import scheduler as sched  # noqa: E402
from fastllama_tpu_torch.kernels import cuda_lib  # noqa: E402


def admit_once(eng, seed, profile_it):
    """Steps of one request until its first streamed text:
    [(host ms, device ms, launches, top kernels)]."""
    from torch.profiler import ProfilerActivity, profile
    stamps, steps = [], []
    req = sched.Request(prompt=cs.prompt_of(298, seed=seed), max_tokens=4,
                        temp=0.0, streaming_fn=stamps.append)
    eng.submit(req)
    while not stamps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile_it:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng.step()
                torch.cuda.synchronize()
            dev_ms, launches, top = cs.device_time_by_kernel(prof, 1)
            steps.append((None, dev_ms, launches,
                          [(k[:50], round(ms, 3), n) for k, ms, n in top[:5]]))
        else:
            eng.step()
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3,))
    while not req.done:
        eng.step()
    return steps


def main():
    if not torch.cuda.is_available():
        print("engine_admission: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cuda_lib.build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    hp = PRESETS["7B"]
    params = cs.rand_params(torch, hp, gen, dev)
    vocab = cs.synthetic_vocab(hp.n_vocab)
    print("card:", torch.cuda.get_device_name(0))
    for name, mode, chunked in (("paged", "paged", False),
                                ("paged_chunked", "paged", True),
                                ("slab", "slab", False)):
        rcfg = RuntimeConfig(n_ctx=512, n_batch=256 if chunked else 512,
                             kv_dtype="bfloat16", weight_dtype="bfloat16")
        eng = sched.BatchEngine(hp, params, vocab, n_slots=8, n_ctx=512,
                                rcfg=rcfg, kv_mode=mode, page_size=64,
                                chunked_admission=chunked)
        admit_once(eng, 1, False)                       # warm-up
        timed = [admit_once(eng, 2 + i, False) for i in range(3)]
        traced = admit_once(eng, 9, True)
        print(json.dumps({
            "mode": name,
            "host_ms_per_step_runs": [[round(s[0], 2) for s in run]
                                      for run in timed],
            "traced_steps": [dict(device_ms=round(s[1], 2), launches=s[2],
                                  top=s[3]) for s in traced]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
