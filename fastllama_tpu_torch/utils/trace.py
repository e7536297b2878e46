"""Tracing/profiling hooks (PyTorch port of utils/trace.py).

The reference exposes per-tensor/per-graph perf counters and a graphviz
dump (ggml.h:303-305, 325-327, 704-707) plus wall-clock phase logs
(lib/llama.cpp:256-261, lib/bridge.cpp:357-380). The equivalents here:

  * `trace_region(dir, name)`: a no-op-when-disabled context manager around
    `torch.profiler`. The session and the batching engine wrap their hot
    regions in it when `RuntimeConfig.profile_dir` is set, so
    `FastLlama.generate` / `BatchEngine.run` drop chrome traces (viewable in
    Perfetto or chrome://tracing, or summarized below) with no change at
    the call site. With the knob empty it creates no profiler and adds no
    synchronization.
  * `device_op_breakdown(dir)` / `print_breakdown(...)`: parse the newest
    trace's device events (the CUDA `kernel`, `gpu_memcpy` and
    `gpu_memset` categories; not the `cudaLaunchKernel` runtime calls on
    the host) into per-kernel totals, every launch of one kernel under its
    base name without template arguments. A trace of a CPU-only run has no
    device events; then the innermost CPU operators stand in for them.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace_region(profile_dir: str | None, name: str):
    """torch.profiler trace around a region; no-op when profile_dir is falsy.

    Traces land in <profile_dir>/<name>/; repeated regions of the same name
    add new files (the parser picks the newest). With a card, the region's
    device work is synchronized before the trace closes, so every launch of
    the region is in it."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(profile_dir, name)
    os.makedirs(out, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        out, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def kernel_key(name: str) -> str:
    """A kernel's base name: a demangled signature loses its return type,
    namespaces, template arguments and parameters ('void (anonymous
    namespace)::q4_mma_kernel<2, false>(float const*, ...)' ->
    'q4_mma_kernel'), so every launch of one kernel adds up; 'Memcpy DtoH
    (Device -> Pinned)' keeps what precedes its parenthesis; a plain name
    ('aten::mm', 'sm80_xmma_gemm_...') stays as it is."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    if not cut:
        return name
    return name[:min(cut)].strip().rsplit("::", 1)[-1]


def _newest_trace(trace_dir: str) -> str:
    paths = [p for pat in ("*.trace.json", "*.trace.json.gz")
             for p in glob.glob(f"{trace_dir}/**/{pat}", recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no trace found under {trace_dir}")
    return max(paths, key=lambda p: Path(p).stat().st_mtime_ns)


def _innermost(events: list) -> list:
    """The events that contain no other event of the same thread (leaf
    operators), so nested CPU operators are not counted twice."""
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    leaves = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack, has_child = [], set()
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"]:
                stack.pop()
            if stack:
                has_child.add(id(stack[-1]))
            stack.append(e)
        leaves += [e for e in evs if id(e) not in has_child]
    return leaves


def device_op_breakdown(trace_dir: str):
    """(total_us, Counter[kernel] -> us, Counter[kernel] -> count) over the
    device events of the newest trace under trace_dir (the innermost CPU
    operators when the trace has no device events)."""
    path = _newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
    picked = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    if not picked:
        picked = _innermost([e for e in complete if e.get("cat") == "cpu_op"])
    agg = collections.Counter()
    cnt = collections.Counter()
    total = 0.0
    for e in picked:
        key = kernel_key(e.get("name", "?"))
        dur = float(e.get("dur", 0))       # microseconds
        agg[key] += dur
        cnt[key] += 1
        total += dur
    return total, agg, cnt


def print_breakdown(total: float, agg, cnt, steps: int = 1, top: int = 40,
                    file=None):
    print(f"\ntotal device time: {total / 1e3:.2f} ms over {steps} steps "
          f"({total / 1e3 / steps:.2f} ms/step)", file=file)
    for k, v in agg.most_common(top):
        print(f"  {v / steps:10.1f} us/step  x{cnt[k] // steps:<5d} {k}",
              file=file)
