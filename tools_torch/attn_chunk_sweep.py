#!/usr/bin/env python3
"""Device time of the split-key decode attention (kernels B4 and B10) under
each chunk size, on one CUDA card.

    python3 tools_torch/attn_chunk_sweep.py     # from the repository root

At 7B widths (32 heads of 128, caches of 512 rows, bf16) it launches the
two kernels with chunks of 16, 32 and 64 rows (b10_splits picks 64) at
B = 1 (n_past 300) and B = 8 (8 x 300, 8 x 128 as in the slab engine's
steady window, and the engine's mixed depths), with caches cycled through
more than the 50 MB L2. Each launch is first held against the plain
version (B4: 2^-7 of the largest output, caches bit for bit; B10: 5e-5,
and a float64 evaluation of the attention). One JSON line per case and
chunk size.
"""
import json
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fastllama_tpu_torch.kernels import cuda_lib  # noqa: E402
from fastllama_tpu_torch.kernels import decode_attention as da  # noqa: E402

H, D, S = 32, 128, 512
F = H * D


def launch(name, chunk, first, kc, vc, npv, cos=None, sin=None):
    """One launch of B4 (name "decode_attention_fused", first = qkv) or B10
    ("decode_attention", first = q) with chunks of `chunk` rows."""
    b = kc.shape[0]
    splits = -(-S // chunk)
    dev = kc.device
    partial = cuda_lib.scratch(dev, "decode_attention.partial",
                               b * H * splits * (D + 2), torch.float32)
    counters = cuda_lib.tile_counters(dev, b * H)
    out = torch.empty((b, 1, F), dtype=torch.float32, device=dev)
    tables = (cos.data_ptr(), sin.data_ptr()) if cos is not None else ()
    cuda_lib.check(cuda_lib.fn(name)(
        first.data_ptr(), kc.data_ptr(), vc.data_ptr(), npv.data_ptr(),
        *tables, b, S, F, D, splits, chunk, 1 / math.sqrt(D), 1,
        partial.data_ptr(), counters.data_ptr(), out.data_ptr(),
        cuda_lib.stream_handle(dev)), name)
    return out


def attention_f64(q, kc, vc, npv):
    """B10's function in float64: softmax(q . K[s <= n_past]) @ V."""
    b = kc.shape[0]
    qh = q.double().reshape(b, H, D)
    keys = kc.double().reshape(b, S, H, D)
    vals = vc.double().reshape(b, S, H, D)
    sc = torch.einsum("bhd,bshd->bhs", qh, keys) / math.sqrt(D)
    rows = torch.arange(S, device=kc.device)[None, None, :]
    sc = sc.masked_fill(rows > npv.long()[:, None, None], float("-inf"))
    return torch.einsum("bhs,bshd->bhd", torch.softmax(sc, -1),
                        vals).reshape(b, 1, F)


def main():
    if not torch.cuda.is_available():
        print("attn_chunk_sweep: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cuda_lib.build()
    kw4 = dict(head_dim=D, n_rot=D, scale=1 / math.sqrt(D))
    for b, depths in ((1, [300]), (8, [300] * 8), (8, [128] * 8),
                      (8, [0, 1, 63, 64, 300, 511, S + 1, 200])):
        n_caches = 16 if b == 1 else 3
        caches = [tuple(torch.randn((b, S, F), generator=gen, device=dev)
                        .to(torch.bfloat16) for _ in range(2))
                  for _ in range(n_caches)]
        npv = torch.tensor(depths, dtype=torch.int32, device=dev)
        cos, sin = da.rope_lane_tables(npv.clamp_max(S - 1), D, D)
        qkv = torch.randn((b, 1, 3 * F), generator=gen, device=dev)
        q = torch.randn((b, 1, F), generator=gen, device=dev)
        # the checks read a snapshot: the timed B4 launches write their new
        # row into the cycled caches, and B10 attends that row
        kc, vc = (x.clone() for x in caches[0])
        k2, v2 = kc.clone(), vc.clone()
        ref4 = da.decode_attention_fused_plain(qkv, k2, v2, npv, cos, sin,
                                               **kw4)
        ref10 = da.decode_attention_plain(q, kc, vc, npv, head_dim=D,
                                          scale=1 / math.sqrt(D))
        ref10_64 = attention_f64(q, kc, vc, npv)
        for chunk in (16, 32, 64):
            k1, v1 = kc.clone(), vc.clone()
            ctx = launch("decode_attention_fused", chunk, qkv, k1, v1, npv,
                         cos, sin)
            err = (ctx - ref4).abs().max().item()
            tol = 2 ** -7 * ref4.abs().max().item() + 1e-6
            if err > tol or not (torch.equal(k1, k2) and torch.equal(v1, v2)):
                raise SystemExit(f"B4 b={b} chunk={chunk}: err {err} > {tol}"
                                 " or caches differ")
            ctx10 = launch("decode_attention", chunk, q, kc, vc, npv)
            err10 = (ctx10 - ref10).abs().max().item()
            if err10 > 5e-5 * ref10.abs().max().item() + 1e-6:
                raise SystemExit(f"B10 b={b} chunk={chunk}: err {err10}")
            row = dict(b=b, depths=depths, chunk=chunk, b4_err_plain=err,
                       b10_err_plain=err10,
                       b10_err_f64=(ctx10.double() - ref10_64).abs().max()
                       .item(),
                       b10_plain_err_f64=(ref10.double() - ref10_64).abs()
                       .max().item())
            for key, name, first, tab in (
                    ("b4_ms", "decode_attention_fused", qkv, (cos, sin)),
                    ("b10_ms", "decode_attention", q, ())):
                it = iter(range(10**9))
                row[key] = cs.time_ms(lambda: launch(
                    name, chunk, first, *caches[next(it) % n_caches], npv,
                    *tab), calls=8 * n_caches)
            print(json.dumps(row), flush=True)
        del caches
    return 0


if __name__ == "__main__":
    sys.exit(main())
