#!/usr/bin/env python3
"""Device time of kernel B1's tensor-core launch (bf16 mode) under each
block layout, on one CUDA card.

    python3 tools_torch/b1_plan_sweep.py     # from the repository root

For each 7B plane (qkv, wo, w13, w2, head) and M in {1, 8}, it times
q4_gemv_mma with every column-group count cw in {1, 2, 4} and split count in
{2, 4, 8, 16} (q blocks per split capped by the staged x slice), beside the
layout that q4_matmul.b1_mma_plan picks, with weights cycled through more
than the 50 MB L2. One line per plane and M: the plan's ms, then the
fastest layouts. Each result is checked against the plain version first.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fastllama_tpu_torch.kernels import cuda_lib  # noqa: E402
from fastllama_tpu_torch.kernels import q4_matmul as qm  # noqa: E402


def launch(x, w, nt, cw, splits, per):
    m, kx = x.shape
    kh, n = w.qs.shape
    tiles = -(-n // (qm.B1_MMA_WARP_COLS * cw)) * -(-m // (8 * nt))
    partial = cuda_lib.scratch(x.device, "q4_gemv.partial", splits * m * n,
                               torch.float32)
    counters = cuda_lib.tile_counters(x.device, tiles)
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=x.device)
    cuda_lib.check(cuda_lib.fn("q4_gemv_mma")(
        x.data_ptr(), m, kx, w.qs.data_ptr(), w.scales.data_ptr(), n,
        kh // 16, cw, splits, per, nt, partial.data_ptr(),
        counters.data_ptr(), y.data_ptr(), w.n_logical,
        cuda_lib.stream_handle(x.device)), "q4_gemv_mma")
    return y


def main():
    if not torch.cuda.is_available():
        print("b1_plan_sweep: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cuda_lib.build()
    shapes = [("qkv", 4096, 12288), ("wo", 4096, 4096),
              ("w13", 4096, 22016), ("w2", 11008, 4096),
              ("head", 4096, 32000)]
    out = []
    for name, k, n in shapes:
        w = cs.rand_weight(torch, k, n, gen, dev)
        ws = [w] + [cs.rand_weight(torch, k, n, gen, dev)
                    for _ in range(cs.copies_for(cs.weight_bytes(w)) - 1)]
        nb = w.qs.shape[0] // 16
        for m in (1, 8):
            x = torch.randn((m, k), generator=gen, device=dev)
            ref = qm.q4_matmul_dequant(x, w, torch.bfloat16)
            plan = qm.b1_mma_plan(m, w.qs.shape[1], nb)
            nt = plan[0]
            layouts = {plan[1:]}
            for cw in (1, 2, 4):
                for splits in (2, 4, 8, 16):
                    per = min(64 // nt, -(-nb // splits))
                    layouts.add((cw, -(-nb // per), per))
            times = {}
            for cw, splits, per in sorted(layouts):
                y = launch(x, w, nt, cw, splits, per)
                err = (y - ref).abs().max().item()
                tol = 1e-4 * ref.abs().max().item()
                if err > tol:
                    raise SystemExit(f"{name} M={m} cw={cw} splits={splits}: "
                                     f"err {err} > {tol}")
                it = iter(range(10**9))
                times[(cw, splits, per)] = cs.time_ms(
                    lambda: launch(x, ws[next(it) % len(ws)], nt, cw,
                                          splits, per), calls=4 * len(ws))
            best = sorted(times.items(), key=lambda kv: kv[1])[:4]
            row = dict(plane=name, m=m, plan=plan[1:],
                       plan_ms=times[plan[1:]],
                       fastest=[dict(cw=c, splits=s, per=p, ms=t)
                                for (c, s, p), t in best])
            out.append(row)
            print(json.dumps(row), flush=True)
        del ws, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
