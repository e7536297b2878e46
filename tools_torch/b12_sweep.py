#!/usr/bin/env python3
"""Kernel B12 (the fresh-prompt flash prefill attention) under variants of
its plan and design, on one CUDA card.

    python3 tools_torch/b12_sweep.py            # from the repository root
    python3 tools_torch/b12_sweep.py --check    # build and check, no times

Builds csrc/flash_prefill.cu and prints each kernel instantiation's
registers and spills (nvcc -Xptxas -v). Then,
at 7B (32 heads, T = 128-2048), 13B (40 heads), a rank's 16 and 8 heads
(T = 512; 8 also at 2048) and Dh 256 (16 heads, T = 512), on the forward's operands (q a
bf16 half of a roped tensor, K and V rows of bf16 slab caches), B12 under
b12_plan's plan and under each other plan kind is held against the plain
version (2^-7 of the largest output) and, without --check, timed with its
inputs cycled past the L2:

  * plan: b12_plan's choice;
  * nc1 / nc2 (Dh 128): the other query tile height, no split;
  * split: the heaviest query tiles' keys split into runs of the card's
    share of all tile products (what filling the SMs takes);
  * no_split: every query tile in one block, where the plan splits;
  * stages2: two K/V stages where the plan has three or four;
  * bn64: 64-key tiles at Dh 128 too (a csrc line replaced; built apart;
    run without a split).

One JSON line per shape, with the card and its power limit first.
"""
import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fastllama_tpu_torch.kernels import cuda_lib  # noqa: E402
from fastllama_tpu_torch.kernels import flash_prefill as fp  # noqa: E402

SHAPES = [("7B", 32, 128, 128), ("7B", 32, 512, 128), ("7B", 32, 2048, 128),
          ("13B", 40, 512, 128), ("tp=2", 16, 512, 128),
          ("tp=4", 8, 512, 128), ("tp=4", 8, 2048, 128),
          ("Dh256", 16, 512, 256)]
# source lines replaced in the design variants (each runs without a split:
# its tiles are not the plan's)
VARIANTS = {
    # 64-key tiles at Dh 128 too
    "bn64": (("  static constexpr int kBN = D == 128 ? 128 : 64;   // key rows",
              "  static constexpr int kBN = 64;   // key rows"),),
}


def kernel_registers(log: str) -> dict:
    """{(Dh, nc): (registers, spill bytes)} from ptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "flash_prefill_kernel" in name:
            t = re.search(r"flash_prefill_kernelILi(\d+)ELi(\d)E", name)
            out[(int(t.group(1)), t.group(2))] = (int(m.group(1)), spill)
            name = None
    return out


def build_variants() -> dict:
    """{name: entry point} of the design variants, built in parallel."""
    src = (cuda_lib.CSRC / "flash_prefill.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"b12_sweep: {name}: source line not found")
            text = text.replace(old, new)
        path = cuda_lib.CSRC / f"_sweep_{name}.cu"
        path.write_text(text)
        out = cuda_lib.BUILD_DIR / f"libsweep_b12_{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out, path)
    fns = {}
    for name, (proc, out, path) in procs.items():
        log, _ = proc.communicate()
        path.unlink()
        if proc.returncode != 0:
            raise SystemExit(f"b12_sweep: {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.flash_prefill.argtypes = cuda_lib.ARGTYPES["flash_prefill"]
        lib.flash_prefill.restype = ctypes.c_int
        fns[name] = lib.flash_prefill
    return fns


def operands(dev, gen, h, t, d):
    qk = torch.randn((1, t, 2 * h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kc, vc = (torch.randn((1, t + 64, h * d), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    return (qk[:, :, :h], kc[:, :t].view(1, t, h, d),
            vc[:, :t].view(1, t, h, d))


def plans(h, t, d, sms):
    base = fp.b12_plan(1, h, t, d, sms)
    out = {"plan": base}
    bm, bn = fp.b12_tiles(d, base.nc)
    nk = [-(-(i + 1) * bm // bn) for i in range(t // bm)]
    share = -(-h * sum(nk) // sms)
    if share < nk[-1]:
        out["split"] = base._replace(kchunk=share)
    if base.kchunk < nk[-1]:
        out["no_split"] = base._replace(kchunk=nk[-1])
    if d == 128:
        nc = 3 - base.nc
        bm, bn = fp.b12_tiles(d, nc)
        out[f"nc{nc}"] = base._replace(nc=nc, kchunk=-(-t // bn))
    out["stages2"] = base._replace(stages=2)
    return out


def launch(fn, q, k, v, plan):
    """One launch of `fn` (the built entry point or a variant's)."""
    b, t, h, d = q.shape
    n_part, n_ctr = fp.b12_scratch(plan, b, h, t, d)
    partial = cuda_lib.scratch(q.device, "b12_partial", max(n_part, 1),
                               torch.float32)
    counters = cuda_lib.tile_counters(q.device, max(n_ctr, 1))
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, b, t, h, d,
            plan.nc, plan.stages, plan.kchunk, float(1 / math.sqrt(d)),
            out.data_ptr(), partial.data_ptr(), counters.data_ptr(),
            cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, "flash_prefill")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="build and check only, no timing")
    ap.add_argument("--trap", action="store_true",
                    help="build with -DFLTORCH_MBAR_TRAP: a barrier wait "
                    "that never completes traps instead of hanging")
    args = ap.parse_args()
    if args.trap:
        cuda_lib.NVCC_FLAGS.append("-DFLTORCH_MBAR_TRAP")
    if not torch.cuda.is_available():
        print("b12_sweep: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    cuda_lib.build()
    log = cuda_lib.build_log.get("flash_prefill", "")
    regs = kernel_registers(log)
    print(json.dumps({"registers_spills": {f"Dh{d} nc{nc}": v for (d, nc), v
                                           in sorted(regs.items())}}))
    for line in log.splitlines():
        if "warning" in line or "Performance" in line:
            print(line.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = cuda_lib.sm_count(dev)
    built = cuda_lib.fn("flash_prefill")
    variants = {}
    if not args.check:
        variants = build_variants()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, h, t, d in SHAPES:
        q, k, v = operands(dev, gen, h, t, d)
        ref = fp.flash_prefill_plain(q, k, v)
        tol = 2 ** -7 * ref.abs().max().item()
        runs = {name: (built, plan) for name, plan in plans(h, t, d, sms)
                .items()}
        runs.update({name: (fn, runs["plan"][1]._replace(kchunk=10**6))
                     for name, fn in variants.items()})
        row = {"shape": f"{label} H={h} T={t} d={d}",
               "plan": list(runs["plan"][1])}
        for name, (fn, plan) in runs.items():
            out = launch(fn, q, k, v, plan)
            err = (out - ref).abs().max().item()
            if not err <= tol:
                print(f"b12_sweep: {row['shape']} {name} {plan}: err {err} "
                      f"> {tol}", file=sys.stderr)
                return 1
            row[name] = {"plan": list(plan), "max_abs_err": err}
        if not args.check:
            sets = [operands(dev, gen, h, t, d) for _ in range(
                cs.copies_for(3 * t * h * d * 2))]
            it = iter(range(10**9))
            for name, (fn, plan) in runs.items():
                row[name]["ms"] = cs.time_ms(torch, lambda: launch(
                    fn, *sets[next(it) % len(sets)], plan),
                    calls=4 * len(sets))
            sd = [tuple(x.transpose(1, 2).contiguous() for x in st)
                  for st in sets]
            row["sdpa_ms"] = cs.time_ms(torch, lambda: sdpa(
                *sd[next(it) % len(sd)], is_causal=True), calls=4 * len(sd))
        print(json.dumps(row), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
