#!/usr/bin/env python3
"""Device time of the bf16 prefill matmul (kernel B5) under variants of its
design, on one CUDA card.

    python3 tools_torch/b5_sweep.py     # from the repository root

On the four 7B planes (qkv, wo, w13, w2) at M = 65, 128, 256 and 512 with
q4_0 weights (cycled through more than the 50 MB L2), it times B5 as built
(persistent: one block an SM walking over the work items) beside:

  * one_block_an_item: the same kernel with one block per work item (a
    grid of waves, each block filling and draining its own ring);
  * conv7, conv6: 7 or 6 converter warps instead of 8 (16 or fewer warps
    a block leave 128 registers a thread instead of 96);
  * no_conversion, no_products, no_x: the kernel with the converters'
    work, the consumers' wgmma or the x tile's TMA load removed; their
    results are wrong and not checked: they show what each part costs.

The variants are built from csrc/q4_prefill.cu with one line replaced, into
the git-ignored build directory. Every correct variant is first held
against the plain version (1e-5 of the largest |x| @ |W|). One JSON line
per plane and M.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fastllama_tpu_torch.kernels import cuda_lib  # noqa: E402
from fastllama_tpu_torch.kernels import q4_matmul as qm  # noqa: E402

ROWS = (65, 128, 256, 512)
# name: ((text to replace, replacement), ...), whether the result is right
VARIANTS = {
    "conv7": ((("constexpr int kConvWarps = 8;",
                "constexpr int kConvWarps = 7;"),), True),
    "conv6": ((("constexpr int kConvWarps = 8;",
                "constexpr int kConvWarps = 6;"),), True),
    "no_conversion": ((
        ("*reinterpret_cast<uint2*>(wt + w_off(k, n)) = pack_bf16x4(",
         "if (false) *reinterpret_cast<uint2*>(wt + w_off(k, n)) = "
         "pack_bf16x4("),
        ("*reinterpret_cast<uint2*>(wt + w_off(k + 16, n)) = pack_bf16x4(",
         "if (false) *reinterpret_cast<uint2*>(wt + w_off(k + 16, n)) = "
         "pack_bf16x4(")), False),
    "no_products": ((
        ("        wgmma_bf16_n128(acc, hopper::sw128_desc(a + 32 * k),",
         "        if (false) wgmma_bf16_n128(acc, "
         "hopper::sw128_desc(a + 32 * k),"),), False),
    "no_x": ((
        ("          tma_load_2d(st, &map_x, full, kt * kBK, t.m0);\n", ""),
        ("mbar_expect_tx(full, R::kTx);",
         "mbar_expect_tx(full, R::kTx - kXBytes);")), False),
}


def build_variants():
    """{name: (ctypes library, checked)} of the variants, built in
    parallel."""
    src = (cuda_lib.CSRC / "q4_prefill.cu").read_text()
    procs = {}
    for name, (subs, checked) in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"b5_sweep: {name}: source line not found")
            text = text.replace(old, new)
        path = cuda_lib.CSRC / f"_sweep_{name}.cu"
        path.write_text(text)
        out = cuda_lib.BUILD_DIR / f"libsweep_{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out, path, checked)
    libs = {}
    for name, (proc, out, path, checked) in procs.items():
        log, _ = proc.communicate()
        path.unlink()
        if proc.returncode:
            raise SystemExit(f"b5_sweep: {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.q4_prefill_gemm.argtypes = cuda_lib.ARGTYPES["q4_prefill_gemm"]
        lib.q4_prefill_gemm.restype = ctypes.c_int
        libs[name] = (lib, checked)
    return libs


def main():
    if not torch.cuda.is_available():
        print("b5_sweep: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cuda_lib.build()
    built = cuda_lib._libs["q4_prefill"]
    libs = build_variants()
    sms = cuda_lib.sm_count(dev)
    bf16 = torch.bfloat16
    for name, k, n in cs.PLANES_7B[:4]:
        w = cs.rand_weight(torch, k, n, gen, dev)
        ws = [w] + [cs.rand_weight(torch, k, n, gen, dev)
                    for _ in range(cs.copies_for(cs.weight_bytes(w)) - 1)]
        wd = qm.dequant_matmul_weight(w, bf16)
        for m in ROWS:
            x = torch.randn((m, k), generator=gen, device=dev)
            ref = qm.q4_matmul_dequant(x, w, bf16)
            tol = 1e-5 * cs.absum_of(torch, qm, x, wd, n, bf16)
            splits, per = qm.b5_plan(m, w.qs.shape[1], -(-k // 32) * 32, sms)
            items = -(-m // qm.B5_BM) * -(-w.qs.shape[1] // qm.B5_BN) * splits
            row = dict(plane=name, m=m, k=k, n=n, splits=splits,
                       stages_per_split=per, items=items)
            runs = [("as_built", built, None, True),
                    ("one_block_an_item", built, items, True)]
            runs += [(v, lib, None, ok) for v, (lib, ok) in libs.items()]
            for label, lib, blocks, checked in runs:
                cuda_lib._libs["q4_prefill"] = lib
                if checked:
                    err = (qm._launch_b5(x, w, bf16, blocks) - ref).abs() \
                        .max().item()
                    if err > tol:
                        raise SystemExit(f"b5_sweep: {label} {name} M={m}: "
                                         f"err {err} > {tol}")
                it = iter(range(10**9))
                row[label] = cs.time_ms(torch, lambda: qm._launch_b5(
                    x, ws[next(it) % len(ws)], bf16, blocks), calls=len(ws))
            cuda_lib._libs["q4_prefill"] = built
            print(json.dumps(row), flush=True)
        del ws, w, wd
    return 0


if __name__ == "__main__":
    sys.exit(main())
