#!/usr/bin/env python3
"""Device time of the prefill matmuls B5 (bf16 mode, q4_0 and q4_1) and B3
(int8) on the register-A kernel (csrc/q4_prefill_ra.cuh), on one CUDA card.

    python3 tools_torch/prefill_sweep.py [--parts compare,pins,builds,b1]
        [--planes qkv,wo,...] [--old DIR] [--rounds R] [--out FILE]
        # from the repo root

Parts:
  compare  B5 (q4_0, q4_1) at M = 65, 128, 256, 300, 512, 513 and B3 at
           M = 256, 300, 512 on the 7B and 13B planes, on the kernel's own
           plan, beside one library call (torch.mm of the rounded x by the
           dequantized weight; torch._int_mm of xq by the int8 weight) and
           the bound; with --old DIR also the B3 and B5 of the checkout in
           DIR (the commit before the register-A kernel, unpacked by git
           archive: its csrc/q4_prefill.cu and q4_int8.cu built here, their
           entries called as that commit's wrappers called them, each held
           against the plain version too), in turns with the kernel;
  turns    B3 against the --old checkout's B3 at M = 256, 300, 512, in
           --rounds rounds of old, new, new, old on fresh inputs each
           round: the spread of both times and of their ratio;
  pins     the same kernels on the 7B planes at M = 64, 128, 256, 512 (B3:
           256, 512) under pinned plans: one or two warpgroups a block,
           each split of K up to 8 (for every tile, or for the tiles past
           the full rounds), and x tiles taller than the plan's;
  builds   the kernel as built and without its conversion or its
           products (FLTORCH_RA_ABLATE; unchecked), on the 7B planes at
           M = 128, 256, 512 (B3: 256, 512), on the plan and with K whole
           on two warpgroups;
  b1       B1's kernel (variant 0 of the fold kernel) beside B5 at M =
           33-64 on the 7B planes, q4_0 in bf16 mode: both compute the same
           function, and q4_matmul sends such a call to B5 where B5 wins
           (b1_on_b5).
Every row is first held against its plain version: B3 bit for bit, B5 and
B1 within 1e-5 of the largest |x| @ |W|. Weights are cycled through more
than the 50 MB L2. One JSON line a row, on stdout and in --out (default
chiprun_out/prefill_sweep.jsonl), each with the card's name and power
limit.
"""
import argparse
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
from fastllama_tpu_torch.kernels import q4_variants as qv  # noqa: E402

B5_ROWS = (65, 128, 256, 300, 512, 513)
B3_ROWS = (256, 300, 512)
PIN_ROWS = {"b5": (64, 128, 256, 512), "b3": (256, 512)}
B1_ROWS = (33, 40, 48, 56, 57, 60, 64)
SPLITS = (1, 2, 3, 4, 6, 8)


# The entries of the checkout before the register-A kernel (--old): B5's
# q4_prefill_gemm (cast pass + a wgmma kernel whose converter warps wrote
# each bf16 weight tile to shared memory) and B3's q4_int8_gemm (a pass that
# wrote the [N, K] int8 plane, then a wgmma product over it), with that
# checkout's argument lists and plans.
P_, I_ = ctypes.c_void_p, ctypes.c_int
OLD_ARGTYPES = {
    "q4_prefill": ("q4_prefill_gemm", [P_, I_, I_, P_, P_, P_, I_, I_, P_, I_,
                                       I_, I_, P_, P_, P_, I_, I_, P_]),
    "q4_int8": ("q4_int8_gemm", [P_, P_, I_, I_, P_, P_, I_, P_, P_, P_, I_,
                                 I_, P_]),
}


def build_old(tree):
    """{source: entry} of the --old checkout's B5 and B3, built in
    parallel into the git-ignored build directory."""
    csrc = Path(tree) / "fastllama_tpu_torch" / "kernels" / "csrc"
    procs = {}
    for name in OLD_ARGTYPES:
        out = cuda_lib.BUILD_DIR / f"libold_{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    entries = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"prefill_sweep: old {name} did not build:\n{log}")
        fn_name, argtypes = OLD_ARGTYPES[name]
        fn = getattr(ctypes.CDLL(str(out)), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    return entries


def old_b5(fn, x, w, sms):
    """The old B5 (bf16 mode) on its plan, b5_plan's 128 x 128 tiles."""
    dev = x.device
    m, kx = x.shape
    n, k = w.qs.shape[1], w.k
    splits, per = qm.b5_plan(m, n, -(-kx // 32) * 32, sms)
    tiles = -(-m // qm.B5_BM) * -(-n // qm.B5_BN)
    xb = cuda_lib.scratch(dev, "old.xb", m * k, torch.bfloat16)
    partial = cuda_lib.scratch(dev, "old.partial", tiles * splits * 128 * 128
                               if splits > 1 else 1, torch.float32)
    counters = cuda_lib.tile_counters(dev, tiles)
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=dev)
    cuda_lib.check(fn(
        x.data_ptr(), m, kx, w.qs.data_ptr(), w.scales.data_ptr(),
        None if w.mins is None else w.mins.data_ptr(), n, k, xb.data_ptr(),
        splits, per, min(tiles * splits, sms), partial.data_ptr(),
        counters.data_ptr(), y.data_ptr(), w.n_logical, 1,
        cuda_lib.stream_handle(dev)), "old q4_prefill_gemm")
    return y


def old_b3(fn, xq, dx, w, sms):
    """The old B3 on its plan: 128 x 256 or 128 x 128 product tiles, the
    fewest waves weighed by the tile's width."""
    dev = xq.device
    m, k = xq.shape
    n = w.qs.shape[1]
    cost = [-(-(-(-m // 128) * -(-n // bn)) // sms) * bn for bn in (256, 128)]
    s8 = cuda_lib.scratch(dev, "old.s8", n, torch.float32)
    w8t = cuda_lib.scratch(dev, "old.w8t", n * k, torch.int8)
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=dev)
    cuda_lib.check(fn(
        xq.data_ptr(), dx.data_ptr(), m, k, w.qs.data_ptr(),
        w.scales.data_ptr(), n, s8.data_ptr(), w8t.data_ptr(), y.data_ptr(),
        w.n_logical, cost.index(min(cost)), cuda_lib.stream_handle(dev)),
        "old q4_int8_gemm")
    return y


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]


class Rows:
    def __init__(self, path, smi):
        self.fh = open(path, "w")
        self.smi = smi

    def emit(self, row):
        row["card"] = self.smi
        line = json.dumps(row)
        print(line, flush=True)
        self.fh.write(line + "\n")


def weights(name, k, n, gen, dev, affine=False):
    w = cs.rand_weight(torch, k, n, gen, dev, affine)
    return [w] + [cs.rand_weight(torch, k, n, gen, dev, affine)
                  for _ in range(cs.copies_for(cs.weight_bytes(w)) - 1)]


def cycled(fn, ws):
    it = iter(range(10**9))
    return lambda: fn(ws[next(it) % len(ws)])


def check_b5(x, w, plan=None):
    """B5's error against its plain version, and its tolerance."""
    bf16 = torch.bfloat16
    y = qm.q4_matmul_prefill(x, w, bf16, plan=plan)
    wd = qm.dequant_matmul_weight(w, bf16)
    tol = 1e-5 * cs.absum_of(torch, qm, x, wd, w.n_logical, bf16)
    err = (y - qm.q4_matmul_dequant(x, w, bf16)).abs().max().item()
    cs.require(err <= tol and bool(torch.isfinite(y).all()),
               f"B5 M={x.shape[0]} plan={plan}: err {err} > {tol}")
    return err, tol, wd


def check_b3(xq, dx, w, plan=None):
    y = qm.q4_matmul_prefill_int8(xq, dx, w, plan=plan)
    cs.require(torch.equal(y, qm.q4_matmul_prefill_int8_plain(xq, dx, w)),
               f"B3 M={xq.shape[0]} plan={plan}: not bit-exact")


def b5_bound(w, m, k, n):
    return cs.bound_ms(cs.weight_bytes(w) + m * k * 4 + m * n * 4,
                       2.0 * m * k * n, "bf16")


def b3_bound(w, m, k, n):
    return cs.bound_ms(m * w.k + m * 4 + cs.weight_bytes(w) + m * n * 4,
                       2.0 * m * k * n, "int8")


def part_compare(planes, gen, dev, out, sms, old=None):
    bf16 = torch.bfloat16
    for name, k, n in planes:
        for affine in (False, True):
            ws = weights(name, k, n, gen, dev, affine)
            w = ws[0]
            quant = "q4_1" if affine else "q4_0"
            for m in B5_ROWS:
                x = torch.randn((m, k), generator=gen, device=dev)
                err, tol, wd = check_b5(x, w)
                xr = qm._pad_k(x, w.k).to(bf16)
                bnd, by = b5_bound(w, m, k, n)
                row = dict(kernel="B5", plane=name, quant=quant, m=m, k=k,
                           n=n, plan=list(qm.prefill_plan(
                               m, w.qs.shape[1], -(-k // 32) * 32, sms)),
                           max_abs_err=err, tol=tol,
                           ms=cs.time_ms(cycled(lambda v: qm.q4_matmul_prefill(
                               x, v, bf16), ws), calls=len(ws)),
                           library_ms=cs.time_ms(lambda: torch.mm(
                               xr, wd, out_dtype=torch.float32), calls=4),
                           bound_ms=bnd, bound_by=by)
                row["vs_library"] = row["ms"] / row["library_ms"]
                if old:
                    yo = old_b5(old["q4_prefill"], x, w, sms)
                    row["old_err"] = (yo - qm.q4_matmul_dequant(
                        x, w, bf16)).abs().max().item()
                    cs.require(row["old_err"] <= tol, "old B5: wrong")
                    # in turns: old, new, new, old
                    o1 = cs.time_ms(cycled(lambda v: old_b5(
                        old["q4_prefill"], x, v, sms), ws), calls=len(ws))
                    n2 = cs.time_ms(cycled(lambda v: qm.q4_matmul_prefill(
                        x, v, bf16), ws), calls=len(ws))
                    o2 = cs.time_ms(cycled(lambda v: old_b5(
                        old["q4_prefill"], x, v, sms), ws), calls=len(ws))
                    row.update(old_ms=[o1, o2], ms_again=n2,
                               vs_old=(row["ms"] + n2) / (o1 + o2))
                out.emit(row)
                del wd
            del ws, w
        ws = weights(name, k, n, gen, dev)
        w = ws[0]
        w8, _ = qm.requant_weight_int8(w)
        w8_cm = w8.t().contiguous().t()
        for m in B3_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev) * 3.0
            xq, dx = qm.quant_rows_int8(x, w.k)
            check_b3(xq, dx, w)
            bnd, by = b3_bound(w, m, k, n)
            row = dict(kernel="B3", plane=name, m=m, k=k, n=n,
                       plan=list(qm.prefill_plan(m, w.qs.shape[1], w.k, sms,
                                                 int8=True)),
                       max_abs_err=0.0,
                       ms=cs.time_ms(cycled(lambda v: qm.q4_matmul_prefill_int8(
                           xq, dx, v), ws), calls=len(ws)),
                       library_ms=cs.time_ms(lambda: torch._int_mm(
                           xq, w8_cm), calls=8),
                       bound_ms=bnd, bound_by=by)
            row["vs_library"] = row["ms"] / row["library_ms"]
            if old:
                cs.require(torch.equal(old_b3(old["q4_int8"], xq, dx, w, sms),
                                       qm.q4_matmul_prefill_int8_plain(
                                           xq, dx, w)), "old B3: wrong")
                o1 = cs.time_ms(cycled(lambda v: old_b3(
                    old["q4_int8"], xq, dx, v, sms), ws), calls=len(ws))
                n2 = cs.time_ms(cycled(lambda v: qm.q4_matmul_prefill_int8(
                    xq, dx, v), ws), calls=len(ws))
                o2 = cs.time_ms(cycled(lambda v: old_b3(
                    old["q4_int8"], xq, dx, v, sms), ws), calls=len(ws))
                row.update(old_ms=[o1, o2], ms_again=n2,
                           vs_old=(row["ms"] + n2) / (o1 + o2))
            out.emit(row)
        del ws, w, w8, w8_cm


def part_turns(planes, gen, dev, out, sms, old, rounds):
    for name, k, n in planes:
        ws = weights(name, k, n, gen, dev)
        w = ws[0]
        for m in B3_ROWS:
            olds, news = [], []
            for _ in range(rounds):
                x = torch.randn((m, k), generator=gen, device=dev) * 3.0
                xq, dx = qm.quant_rows_int8(x, w.k)
                check_b3(xq, dx, w)
                cs.require(torch.equal(old_b3(old["q4_int8"], xq, dx, w, sms),
                                       qm.q4_matmul_prefill_int8_plain(
                                           xq, dx, w)), "old B3: wrong")
                t_old = cycled(lambda v: old_b3(old["q4_int8"], xq, dx, v,
                                                sms), ws)
                t_new = cycled(lambda v: qm.q4_matmul_prefill_int8(
                    xq, dx, v), ws)
                for fn, acc in ((t_old, olds), (t_new, news), (t_new, news),
                                (t_old, olds)):
                    acc.append(cs.time_ms(fn, calls=len(ws)))
            ratios = [(news[2 * i] + news[2 * i + 1]) /
                      (olds[2 * i] + olds[2 * i + 1]) for i in range(rounds)]
            out.emit(dict(kernel="B3 turns", plane=name, m=m, k=k, n=n,
                          rounds=rounds, old_ms=olds, new_ms=news,
                          new_over_old=ratios,
                          new_over_old_range=[min(ratios), max(ratios)]))
        del ws, w


def pin_plans(m, n, kc, sms, int8):
    """The plan and pinned alternatives: wgs 1, 2 by every split, and x
    tiles taller than the plan's (fewer row tiles)."""
    base = qm.prefill_plan(m, n, kc, sms, int8=int8)
    plans = {tuple(base)}
    for bx in sorted({base.bx, 128, 192, 256}):
        if bx < base.bx:
            continue
        for g in (1, 2):
            for s in SPLITS:
                for t0 in (0, None):      # every tile split, or the plan's
                    p = qm.prefill_plan(m, n, kc, sms, int8=int8, bx=bx,
                                        wgs=g, splits=s, t0=t0)
                    if p.splits == s:
                        plans.add(tuple(p))
    return base, sorted(plans)


def part_pins(planes, gen, dev, out, sms):
    bf16 = torch.bfloat16
    for name, k, n in planes:
        ws = weights(name, k, n, gen, dev)
        w = ws[0]
        for m in PIN_ROWS["b5"]:
            x = torch.randn((m, k), generator=gen, device=dev)
            kc = -(-k // 32) * 32
            base, plans = pin_plans(m, w.qs.shape[1], kc, sms, False)
            for p in plans:
                plan = qm.RaPlan(*p)
                check_b5(x, w, plan)
                out.emit(dict(kernel="B5", plane=name, m=m, plan=list(p),
                              planned=plan == base,
                              ms=cs.time_ms(cycled(lambda v: qm.q4_matmul_prefill(
                                  x, v, bf16, plan=plan), ws), calls=len(ws))))
        for m in PIN_ROWS["b3"]:
            x = torch.randn((m, k), generator=gen, device=dev) * 3.0
            xq, dx = qm.quant_rows_int8(x, w.k)
            base, plans = pin_plans(m, w.qs.shape[1], w.k, sms, True)
            for p in plans:
                plan = qm.RaPlan(*p)
                check_b3(xq, dx, w, plan)
                out.emit(dict(kernel="B3", plane=name, m=m, plan=list(p),
                              planned=plan == base,
                              ms=cs.time_ms(cycled(lambda v: qm.q4_matmul_prefill_int8(
                                  xq, dx, v, plan=plan), ws), calls=len(ws))))
        del ws, w


# the variant builds of both sources: name -> (nvcc define, whether the
# result is right)
ENTRIES = {"q4_prefill": "q4_prefill_gemm", "q4_int8": "q4_int8_gemm"}
BUILDS = {"as_built": ("-DFLTORCH_RA_ABLATE=0", True),
          "no_conversion": ("-DFLTORCH_RA_ABLATE=1", False),
          "no_products": ("-DFLTORCH_RA_ABLATE=2", False)}


def build_variants():
    """{(source, variant): library} of q4_prefill.cu and q4_int8.cu built
    as BUILDS says, in parallel, into the git-ignored build directory."""
    procs = {}
    for name in ENTRIES:
        for v, (define, _) in BUILDS.items():
            out = cuda_lib.BUILD_DIR / f"libvariant_{v}_{name}.so"
            procs[(name, v)] = (subprocess.Popen(
                [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, define, "-o",
                 str(out), str(cuda_lib.CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                out)
    libs = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"prefill_sweep: {key} did not build:\n{log}")
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, ENTRIES[key[0]])
        fn.argtypes = cuda_lib.ARGTYPES[ENTRIES[key[0]]]
        fn.restype = ctypes.c_int
        libs[key] = lib
    return libs


def part_builds(planes, gen, dev, out, sms):
    bf16 = torch.bfloat16
    libs = build_variants()
    built = dict(cuda_lib._libs)
    for name, k, n in planes:
        ws = weights(name, k, n, gen, dev)
        w = ws[0]
        ns = w.qs.shape[1]
        for kernel, rows in (("B5", PIN_ROWS["b5"][1:]), ("B3",
                                                          PIN_ROWS["b3"])):
            int8 = kernel == "B3"
            for m in rows:
                x = torch.randn((m, k), generator=gen, device=dev)
                xq, dx = qm.quant_rows_int8(x, w.k)
                kc = w.k if int8 else -(-k // 32) * 32
                plans = {tuple(qm.prefill_plan(m, ns, kc, sms, int8=int8)),
                         tuple(qm.prefill_plan(m, ns, kc, sms, int8=int8,
                                               wgs=2, splits=1))}
                for p in sorted(plans):
                    plan = qm.RaPlan(*p)
                    row = dict(kernel=kernel, plane=name, m=m, plan=list(p))
                    src = "q4_int8" if int8 else "q4_prefill"
                    for v, (_, right) in BUILDS.items():
                        cuda_lib._libs[src] = libs[(src, v)]
                        if int8:
                            if right:
                                check_b3(xq, dx, w, plan)
                            fn = cycled(lambda u: qm.q4_matmul_prefill_int8(
                                xq, dx, u, plan=plan), ws)
                        else:
                            if right:
                                check_b5(x, w, plan)
                            fn = cycled(lambda u: qm.q4_matmul_prefill(
                                x, u, bf16, plan=plan), ws)
                        row[f"{v}_ms"] = cs.time_ms(fn, calls=len(ws))
                    cuda_lib._libs.update(built)
                    out.emit(row)
        del ws, w


def part_b1(planes, gen, dev, out, sms):
    bf16 = torch.bfloat16
    for name, k, n in planes:
        ws = weights(name, k, n, gen, dev)
        w = ws[0]
        for m in B1_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev)
            err, tol, wd = check_b5(x, w)
            b1 = qv._launch_fold(x, w.qs, w.scales, 0, w.n_logical)
            err1 = (b1 - qm.q4_matmul_dequant(x, w, bf16)).abs().max().item()
            cs.require(err1 <= tol, f"B1 {name} M={m}: err {err1} > {tol}")
            row = dict(kernel="B1 vs B5", plane=name, m=m, k=k, n=n,
                       b1_ms=cs.time_ms(cycled(lambda v: qv._launch_fold(
                           x, v.qs, v.scales, 0, v.n_logical), ws),
                           calls=len(ws)),
                       b5_ms=cs.time_ms(cycled(lambda v: qm.q4_matmul_prefill(
                           x, v, bf16), ws), calls=len(ws)),
                       b5_plan=list(qm.prefill_plan(
                           m, w.qs.shape[1], -(-k // 32) * 32, sms)),
                       routed_to_b5=qm.b1_on_b5(m, w))
            out.emit(row)
            del wd
        del ws, w


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="compare,pins,builds,b1")
    ap.add_argument("--planes", default="")
    ap.add_argument("--old", default="")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/prefill_sweep.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prefill_sweep: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cuda_lib.build()
    sms = cuda_lib.sm_count(dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    out = Rows(args.out, card())
    pick = set(filter(None, args.planes.split(",")))
    planes = [p for p in cs.PLANES_7B[:4] + cs.PLANES_13B
              if not pick or p[0] in pick]
    parts = args.parts.split(",")
    old = build_old(args.old) if args.old else None
    if "compare" in parts:
        part_compare(planes, gen, dev, out, sms, old)
    if "turns" in parts:
        cs.require(old is not None, "--parts turns needs --old")
        part_turns(planes, gen, dev, out, sms, old, args.rounds)
    seven = [p for p in planes if p in cs.PLANES_7B]
    if "pins" in parts:
        part_pins(seven, gen, dev, out, sms)
    if "builds" in parts:
        part_builds(seven, gen, dev, out, sms)
    if "b1" in parts:
        part_b1(seven, gen, dev, out, sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
