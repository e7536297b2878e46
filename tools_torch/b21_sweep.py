#!/usr/bin/env python3
"""Device time of the paged attention B21 and its fused step B21F on one
CUDA card, in turns on the same pools.

    python3 tools_torch/b21_sweep.py [8x300 8x4096 1x32767]   # from the root

At 7B widths (32 heads of 128, pages of 64 rows, tables of 512 pages, bf16
pools) and chip_smoke.B21_TIMED's lengths (8 x 300, 8 x 4096, 1 x 32767;
one more inactive slot, as the fused step's check builds them), over pools
cycled through more than the 50 MB L2, it times in turns B21 over the
lengths, B21F (RoPE, the new row's write, the pre-scale and B21 over
lengths + 1 keys), B7 + B21 over lengths + 1 (the unfused route's
kernels), B21F again, B21 again, B21 on B21F's roped q and B21F with its
write sent outside the pool, all through the wrappers. B21 is first held
against the plain version (1e-5 of the largest output). One JSON line per
case and variant, with the bound (live K and V bytes over 3.35 TB/s). On
the H100 the first variant timed in a case reads up to 16% slow (after the
plain reference's gathers; chip_smoke.time_settled).
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fastllama_tpu_torch.engine import paged_kv as pk  # noqa: E402
from fastllama_tpu_torch.kernels import cuda_lib  # noqa: E402
from fastllama_tpu_torch.kernels import kv_write as kw  # noqa: E402

H, D = 32, 128
PP = cs.LONG_CTX // cs.ENG_PS
PPCB = 64


def b21(c, q=None, attend=None):
    """B21 over the case's pools: q (qkv's q heads, or `q`), lengths or
    `attend`."""
    qkv, pools, lens, tables = c[0], c[1], c[3], c[4]
    if q is None:
        q = qkv.view(qkv.shape[0], 3, H, D)[:, 0].contiguous()
    return pk.paged_attention_tpu(q, *pools,
                                  lens if attend is None else attend,
                                  tables, pages_per_compute_block=PPCB)


def main():
    if not torch.cuda.is_available():
        print("b21_sweep: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cuda_lib.build()
    for label, b, n in cs.B21_TIMED:
        if sys.argv[1:] and label not in sys.argv[1:]:
            continue
        live = 2 * b * n * H * D * 2
        cases = [cs.b21f_case(torch, dev, gen, H, torch.bfloat16, [n] * b,
                              PP, extra=0)
                 for _ in range(cs.copies_for(live))]
        c0 = cases[0]
        ref = pk.paged_attention_tpu_plain(
            c0[0].view(b + 1, 3, H, D)[:, 0], *c0[1], c0[3], c0[4])
        tol = 1e-5 * ref.abs().max().item() + 1e-6
        split = [(c[0].view(b + 1, 3, H, D)[:, 0].contiguous(),
                  c[0].view(b + 1, 3, H, D)[:, 1].contiguous(),
                  c[0].view(b + 1, 3, H, D)[:, 2].contiguous(), c[3] + 1)
                 for c in cases]
        err = (b21(c0, q=split[0][0]) - ref).abs().max().item()
        if err > tol:
            raise SystemExit(f"{label} B21: err {err} > {tol}")
        bound, _ = cs.bound_ms(live, 4.0 * b * n * H * D, "f32")
        it = iter(range(10**9))

        def pick():
            i = next(it) % len(cases)
            return cases[i], split[i]

        def fused():
            c, _ = pick()
            return pk.paged_attention_tpu_fused(
                c[0], *c[1], *c[3:], pages_per_compute_block=PPCB)

        def unfused():
            c, (q, k, v, attend) = pick()
            kw.paged_kv_write(*c[1], k, v, c[5], c[6])
            return b21(c, q=q, attend=attend)

        def plain_b21():
            c, (q, *_) = pick()
            return b21(c, q=q)

        # B21F's own q (roped, as its plain step ropes it), for B21 on the
        # same values, and B21F with its write sent outside the pool
        roped = []
        for c in cases:
            t = c[0].view(b + 1, 3, H, D)
            partner = torch.arange(D, device=dev) ^ 1
            roped.append(pk._rope_fma(t[:, 0], t[:, 0][..., partner],
                                      c[7][:, None], c[8][:, None])
                         .contiguous())
        nowhere = [torch.full_like(c[5], -1) for c in cases]

        def b21_roped():
            i = next(it) % len(cases)
            return b21(cases[i], q=roped[i])

        def fused_no_write():
            i = next(it) % len(cases)
            c = cases[i]
            return pk.paged_attention_tpu_fused(
                c[0], *c[1], c[3], c[4], nowhere[i], *c[6:],
                pages_per_compute_block=PPCB)

        runs = [("B21", plain_b21), ("B21F", fused), ("B7+B21", unfused),
                ("B21F", fused), ("B21", plain_b21),
                ("B21 on B21F's roped q", b21_roped),
                ("B21F writing nothing", fused_no_write)]
        for name, fn in runs:
            ms = cs.time_ms(fn, calls=8 * len(cases))
            print(json.dumps(dict(case=label, variant=name, ms=ms,
                                  bound_ms=bound, bound_share=bound / ms)),
                  flush=True)
        del cases, split
    return 0


if __name__ == "__main__":
    sys.exit(main())
