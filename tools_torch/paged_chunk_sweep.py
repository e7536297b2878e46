#!/usr/bin/env python3
"""Device time of the split-key paged decode attention (kernel B6) under
each chunk size, on one CUDA card.

    python3 tools_torch/paged_chunk_sweep.py     # from the repository root

At 7B widths (32 heads of 128, pages of 64 rows, 8 pages a sequence, bf16
pools) it launches B6 with chunks of 32, 64, 128, 192 and 256 rows
(b6_plan's choice marked) at B = 1 (300 keys), B = 8 (8 x 300; 8 x 128 and
8 x 100-150 as in the paged engine's steady window; the ragged lengths of
chip_smoke.py's check), over pools cycled through more than the 50 MB L2.
Each launch is first held against the plain version (2^-7 of the largest
output). One JSON line per case and chunk size.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fastllama_tpu_torch.kernels import cuda_lib  # noqa: E402
from fastllama_tpu_torch.kernels import paged_attention as pa  # noqa: E402

H, D, PS, PP = 32, 128, 64, 8
CASES = ((1, [300]), (8, [300] * 8), (8, [128] * 8),
         (8, [100, 107, 114, 121, 128, 135, 142, 150]),
         (8, [0, 1, PS - 1, PS, 300, PP * PS, 200, 37]))
CHUNKS = (32, 64, 128, 192, 256)


def main():
    if not torch.cuda.is_available():
        print("paged_chunk_sweep: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cuda_lib.build()
    for b, lens in CASES:
        n_pages = b * PP
        perm = torch.randperm(n_pages, generator=gen, device=dev)
        tables = perm.reshape(b, PP).to(torch.int32).contiguous()
        pool_bytes = 2 * H * (n_pages + 1) * PS * D * 2
        pools = [tuple(torch.randn((H, n_pages + 1, PS, D), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(2))
                 for _ in range(cs.copies_for(pool_bytes))]
        q = torch.randn((b, H, D), generator=gen, device=dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        ref = pa.paged_decode_attention_plain(q, *pools[0], lengths, tables)
        tol = 2 ** -7 * ref.abs().max().item() + 1e-6
        plan = pa.b6_plan(PP, PS, D, 2)
        rows = sum(lens)
        bound, _ = cs.bound_ms(2 * b * H * D * 4 + 2 * rows * H * D * 2
                               + b * 4 + b * PP * 4, 4.0 * rows * H * D,
                               "bf16")
        for chunk in CHUNKS:
            ctx = pa._launch("paged_decode_attention", q, *pools[0], lengths,
                             tables, n_pages + 1, PS, chunk=chunk)
            err = (ctx - ref).abs().max().item()
            if err > tol:
                raise SystemExit(f"B6 b={b} {lens} chunk={chunk}: err {err}"
                                 f" > {tol}")
            it = iter(range(10**9))
            ms = cs.time_ms(lambda: pa._launch(
                "paged_decode_attention", q, *pools[next(it) % len(pools)],
                lengths, tables, n_pages + 1, PS, chunk=chunk),
                calls=8 * len(pools))
            print(json.dumps(dict(b=b, lengths=lens, chunk=chunk,
                                  planned=chunk == plan[1], ms=ms,
                                  bound_ms=bound, err=err, tol=tol)),
                  flush=True)
        del pools
    return 0


if __name__ == "__main__":
    sys.exit(main())
