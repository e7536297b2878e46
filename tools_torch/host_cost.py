#!/usr/bin/env python3
"""Host cost per call of the port's decode-path pieces, on one CUDA card.

    python3 tools_torch/host_cost.py     # from the repository root

Each line is the mean host time (µs) of one call, taken over a loop of
calls between two synchronizations, so it measures what the host spends
enqueuing, not the device: a decode step whose host time exceeds its
device time leaves the card idle. Ends with the CPU-side profile of twenty
single-token evals of a 2-layer model at 7B widths.
"""
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fastllama_tpu_torch.config import PRESETS, RuntimeConfig  # noqa: E402
from fastllama_tpu_torch.kernels import cuda_lib  # noqa: E402
from fastllama_tpu_torch.kernels import decode_attention as da  # noqa: E402
from fastllama_tpu_torch.kernels import q4_matmul as qm  # noqa: E402
from fastllama_tpu_torch.models.runtime import LlamaModel  # noqa: E402


def host_us(fn, n=2000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t) / n * 1e6


def main():
    if not torch.cuda.is_available():
        print("host_cost: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cuda_lib.build()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    w = cs.rand_weight(torch, 4096, 4096, g, dev)
    x = torch.randn((1, 4096), device=dev)
    a = torch.randn((1, 4096), device=dev)
    print("torch.add us", host_us(lambda: a + a))
    print("rms_norm us", host_us(lambda: torch.nn.functional.rms_norm(
        a, (4096,), a[0], 1e-6)))
    print("empty us", host_us(lambda: torch.empty((16, 4096), device=dev)))
    print("current_stream us",
          host_us(lambda: torch.cuda.current_stream().cuda_stream))
    print("B1 wrapper us", host_us(lambda: qm.q4_matmul_decode(x, w)))
    w1 = cs.rand_weight(torch, 4096, 4096, g, dev, affine=True)
    print("B9 wrapper us", host_us(lambda: qm.q41_matmul_decode(x, w1)))
    print("q4_matmul us", host_us(lambda: qm.q4_matmul(x.view(1, 1, 4096), w)))
    kc = torch.zeros((1, 512, 4096), dtype=torch.bfloat16, device=dev)
    vc = kc.clone()
    qkv = torch.randn((1, 1, 3 * 4096), device=dev)
    n = torch.tensor([300], dtype=torch.int32, device=dev)
    cos, sin = da.rope_lane_tables(n, 128, 128)
    print("B4 wrapper us", host_us(lambda: da.decode_attention_fused(
        qkv, kc, vc, n, cos, sin, head_dim=128, n_rot=128, scale=0.088)))
    print("rope tables us", host_us(lambda: da.rope_lane_tables(n, 128, 128)))
    hp = dataclasses.replace(PRESETS["7B"], n_layer=2)
    p = cs.rand_params(torch, hp, g, dev)
    m = LlamaModel(hp, p, cs.synthetic_vocab(hp.n_vocab),
                   RuntimeConfig(n_ctx=512), device=dev)
    m.eval(0, list(range(1, 20)))
    print("eval 2-layer decode us", host_us(lambda: m.eval(100, [5]), n=300))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            m.eval(100, [5])
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
