#!/usr/bin/env python3
"""Device time of the int8 natx product (kernel B19) and the bf16 prefill
split body (kernel B20) beside ablations of their designs, on one CUDA card.

    python3 tools_torch/fold_cluster_sweep.py     # from the repository root

On the 7B qkv and wo planes at M = 512 and 256 (q4_0 weights cycled through
more than the 50 MB L2) it times, through their wrappers, B19 and B20 as
built, B2 + B3 (int8 nat) and B5 (bf16 nat) on the same inputs, and builds
of csrc/q4_int8.cu and csrc/q4_prefill.cu with lines replaced:

  * b19_no_conversion, b19_no_copies, b19_skeleton: B19 without its
    converters' requantization, without the bulk copies that send each
    block's share of the weight tile to the rest of its cluster, or
    without either (the skeleton: the rings, the cluster's barriers and
    the products);
  * b20_no_fold_rows, b20_no_fold_slice, b20_no_fold: B20 without the fold
    warps' B rows, without the fold's k16 slice on the tensor cores, or
    without both;
  * b20_5_stages: B20 with a ring of 5 stages (its 45 KB stage fits 5 in
    a block's 227 KB) in place of B5's 4: right, and checked.

The ablations' results are wrong and not checked: they show what each part
costs. B19, B20 and b20_5_stages are first held against their plain
versions (B19 bit for bit, B20 within 1e-4 of max |y|). The card's name and
power limit, then one JSON line per plane and M.
"""
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fastllama_tpu_torch.kernels import cuda_lib  # noqa: E402
from fastllama_tpu_torch.kernels import q4_matmul as qm  # noqa: E402
from fastllama_tpu_torch.kernels import q4_variants as qv  # noqa: E402
from fastllama_tpu_torch.quant.tensor import QuantMatmulWeight  # noqa: E402

ROWS = (512, 256)
_NO_CONVERSION = ("      for (int u = gt; u < 4 * share; u += kNxGroup) {",
                  "      for (int u = gt; u < 0; u += kNxGroup) {")
_NO_COPIES = (("        for (int p = 0; p < C; ++p)\n",
               "        for (int p = 0; p < 0; ++p)\n"),
              ("mbar_expect_tx(conv + 8 * s, (C - 1) * bytes);",
               "mbar_expect_tx(conv + 8 * s, 0);"))
_NO_FOLD_ROWS = (
    "      for (int i = 0; i < kFoldRows / R::kFoldWarps; ++i) {",
    "      for (int i = 0; i < 0; ++i) {")
_NO_FOLD_SLICE = (
    "      wgmma_bf16_n128(                 // the fold slice",
    "      if (false) wgmma_bf16_n128(      // the fold slice")
_FIVE_STAGES = ("constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 4;",
                "constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 5;")
# name: (source, (text to replace, replacement), ...)
VARIANTS = {
    "b19_no_conversion": ("q4_int8", (_NO_CONVERSION,)),
    "b19_no_copies": ("q4_int8", _NO_COPIES),
    "b19_skeleton": ("q4_int8", (_NO_CONVERSION, *_NO_COPIES)),
    "b20_no_fold_rows": ("q4_prefill", (_NO_FOLD_ROWS,)),
    "b20_no_fold_slice": ("q4_prefill", (_NO_FOLD_SLICE,)),
    "b20_no_fold": ("q4_prefill", (_NO_FOLD_ROWS, _NO_FOLD_SLICE)),
    "b20_5_stages": ("q4_prefill", (_FIVE_STAGES,)),
}
ENTRY = {"q4_int8": "q4_int8_gemm_natx",
         "q4_prefill": "q4_prefill_split_gemm"}


def build_variants():
    """{name: (library name, ctypes library)} of the variants, built in
    parallel from copies of the sources in a temporary directory."""
    tmp = Path(tempfile.mkdtemp())
    for header in cuda_lib.CSRC.glob("*.cuh"):
        shutil.copy(header, tmp)
    procs = {}
    for name, (lib, subs) in VARIANTS.items():
        text = (cuda_lib.CSRC / f"{lib}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"fold_cluster_sweep: {name}: source line "
                                 "not found")
            text = text.replace(old, new)
        path = tmp / f"{name}.cu"
        path.write_text(text)
        out = cuda_lib.BUILD_DIR / f"libsweep_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out)
    libs = {}
    for name, (lib, proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"fold_cluster_sweep: {name} did not build:\n"
                             f"{log}")
        cdll = ctypes.CDLL(str(out))
        entry = getattr(cdll, ENTRY[lib])
        entry.argtypes = cuda_lib.ARGTYPES[ENTRY[lib]]
        entry.restype = ctypes.c_int
        libs[name] = (lib, cdll)
    shutil.rmtree(tmp)
    return libs


def main():
    if not torch.cuda.is_available():
        print("fold_cluster_sweep: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cuda_lib.build()
    built = dict(cuda_lib._libs)
    libs = build_variants()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name, k, n in cs.PLANES_7B[:2]:
        w = cs.rand_weight(torch, k, n, gen, dev)
        ws = [w] + [cs.rand_weight(torch, k, n, gen, dev)
                    for _ in range(cs.copies_for(cs.weight_bytes(w)) - 1)]
        for m in ROWS:
            x = torch.randn((m, k), generator=gen, device=dev)
            b19 = qv.q4_prefill_int8_natx(x, w.qs, w.scales)
            cs.require(torch.equal(b19, qv.q4_prefill_int8_natx_plain(
                x, w.qs, w.scales)), f"B19 {name} M={m}: not bit-exact")
            want = qv.q4_prefill_split_plain(x, w.qs, w.scales)
            err = (qv.q4_prefill_split(x, w.qs, w.scales) - want).abs().max()
            cs.require(err.item() <= 1e-4 * want.abs().max().item(),
                       f"B20 {name} M={m}: err {err.item()}")
            it = iter(range(10**9))

            def timed(fn):
                def call():
                    ww = ws[next(it) % len(ws)]
                    return fn(x, ww.qs, ww.scales)
                return cs.time_ms(call, calls=len(ws))
            row = dict(plane=name, m=m, k=k, n=n,
                       b19=timed(qv.q4_prefill_int8_natx),
                       b2_b3=timed(qv.q4_matmul_prefill_int8),
                       b20=timed(qv.q4_prefill_split),
                       b5=timed(lambda x, qs, sc: qm.q4_matmul_prefill(
                           x, QuantMatmulWeight(qs=qs, scales=sc))))
            for label, (lib, cdll) in libs.items():
                cuda_lib._libs[lib] = cdll
                if label == "b20_5_stages":
                    err = (qv.q4_prefill_split(x, w.qs, w.scales)
                           - want).abs().max().item()
                    cs.require(err <= 1e-4 * want.abs().max().item(),
                               f"{label} {name} M={m}: err {err}")
                row[label] = timed(qv.q4_prefill_int8_natx
                                   if lib == "q4_int8"
                                   else qv.q4_prefill_split)
                cuda_lib._libs[lib] = built[lib]
            print(json.dumps(row), flush=True)
        del ws, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
