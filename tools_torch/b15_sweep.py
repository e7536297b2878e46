#!/usr/bin/env python3
"""Device time of the decode kernel of B1, B9 and B15-B18
(csrc/q4_fold.cuh) under variants of its plan and its design, on one CUDA
card.

    python3 tools_torch/b15_sweep.py [--planes qkv,wo,w13,w2] [--rows 1,8,64]
                                     [--b20-rows 8,16,32,64] [--no-builds]
                                     [--parts plans,route,pins]

On the named 7B planes (and the 13B qkv plane, "qkv13") at the given M,
with q4_0 weights cycled through more than the 50 MB L2, the part "plans"
times through the kernel's entry point:

  * plan: B15 (v1) on q4_variants.b15_plan, and B16 (v2), B17 (v3) and
    B18 (v7) on the same plan (b16, b17, b18), and the probes B13 (b13:
    the skeleton, the whole byte and one k16 step, no scales or fold) and
    B14 (b14: the codes, two steps) on it too, both checked against their
    plain versions (kernels/q4_floor.py): b13, b14 - b13 and plan - b14
    split B15's time into the skeleton, the unpack and the scales with the
    fold;
  * stages_S: the plan with S weight ring slots (2 to 16, where they fit
    beside an x ring of 2 or more);
  * one_warpgroup: the best plan with one consumer warpgroup in place of
    two (a tile of 128 columns at M <= 32, 64 above, in place of 256 or
    128);
  * splits_S: the plan's tile width with K split S ways (1 to 8);
  * one_cluster_an_item: the plan with a cluster for every column tile (the
    grid as a wave of short-lived clusters, each filling its own ring);
  * mma_sync or wgmma (M <= 8): the plan with the other product
    (mma.sync m16n8k16 a warp, or wgmma a warpgroup);
  * no_pdl, global_merge: csrc/q4_fold.cu built with
    -DFLTORCH_B15_NO_PDL (a plain stream successor of the launch before,
    not a programmatic dependent; checked) and with
    -DFLTORCH_B15_GLOBAL_MERGE (a split's partial tiles through global
    memory, B1's way, on the plan's splits or 2; checked), beside the
    cluster merge of the same plan ("cluster_merge");

and beside them B1 (q4_matmul_decode), torch.ops.aten._weight_int4pack_mm
(B1's function with bf16 scales; the port never calls it) and the byte
bound. The part "route" prints, a line a plane and M, the default decode
matmuls against what the dispatcher could run in their place: variant 0
of the kernel on its plan (v0) beside q4_matmul_decode (b1: what B1's
wrapper launches) and B5 (b5, q4_matmul_prefill: the same function) and
_weight_int4pack_mm; on q4_1 weights of the plane variant 9 (v9) beside
q41_matmul_decode (b9), B5's affine mode (b5_affine; R(x) @ R(q d + m),
q4_matmul_xla's function) and _weight_int4pack_mm with q4_1's offsets;
each with its byte bound. The part "pins" (M <= 8) times variant 0 under
every consumer warpgroup count (1, 2) and split count (1-8), then the
fastest of those under ring depths of 2-8 slots.
Every correct variant is first held against the plain version (1e-5 of
sum |R(x)| (q + 8) |d|; B9's of its two terms). Then, at each --b20-rows M
on the 7B planes, B20's
split kernel (q4_prefill_split past B20_ON_B15_MAX_M) beside B15 on the
same inputs: both compute v1's function. The card's name and power limit,
then one JSON line per plane and M.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from fastllama_tpu_torch.kernels import cuda_lib  # noqa: E402
from fastllama_tpu_torch.kernels import q4_variants as qv  # noqa: E402
from fastllama_tpu_torch.quant.tensor import QuantMatmulWeight  # noqa: E402

PLANES = {"qkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
          "w2": (11008, 4096), "qkv13": (5120, 15360)}
# name: (source, flag, entry point)
BUILDS = {"no_pdl": ("q4_fold", "-DFLTORCH_B15_NO_PDL", "q4_fold_gemm"),
          "global_merge": ("q4_fold", "-DFLTORCH_B15_GLOBAL_MERGE",
                           "q4_fold_gemm")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--planes", default="qkv,wo,w13,w2",
                    help="planes of " + ", ".join(PLANES))
    ap.add_argument("--rows", default="1,8,64", help="M values, 1..64")
    ap.add_argument("--b20-rows", default="8,16,32,64",
                    help="M values for B20 against B15 (empty: none)")
    ap.add_argument("--no-builds", action="store_true",
                    help="skip the builds of BUILDS")
    ap.add_argument("--parts", default="plans,route",
                    help="of plans, route, pins (module docstring)")
    args = ap.parse_args(argv)
    args.parts = set(p for p in args.parts.split(",") if p)
    if args.parts - {"plans", "route", "pins"}:
        ap.error(f"unknown parts {args.parts}")
    args.planes = [p for p in args.planes.split(",") if p]
    args.rows = [int(r) for r in args.rows.split(",") if r]
    args.b20_rows = [int(r) for r in args.b20_rows.split(",") if r]
    bad = [p for p in args.planes if p not in PLANES]
    if bad:
        ap.error(f"unknown planes {bad}")
    if not all(1 <= r <= qv.B15_MAX_M for r in args.rows + args.b20_rows):
        ap.error(f"rows must lie in 1..{qv.B15_MAX_M}")
    return args


def build_variants():
    """{name: entry point} of each of BUILDS (a build of the kernel of
    csrc/q4_fold.cuh with one flag), built in parallel into the git-ignored
    build directory."""
    procs = {}
    for name, (src, flag, fn) in BUILDS.items():
        out = cuda_lib.BUILD_DIR / f"libsweep_b15_{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, flag, "-o", str(out),
             str(cuda_lib.CSRC / f"{src}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out, fn)
    entries = {}
    for name, (proc, out, fn) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"b15_sweep: {name} did not build:\n{log}")
        entry = getattr(ctypes.CDLL(str(out)), fn)
        entry.argtypes = cuda_lib.ARGTYPES[fn]
        entry.restype = ctypes.c_int
        entries[name] = entry
    return entries


def launch(entry, x, qs, scales, variant, plan, scratch=None):
    """One launch of `entry` (q4_fold_gemm of some build) on `plan`."""
    m, kx = x.shape
    n = qs.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rc = entry(x.data_ptr(), m, kx, qs.data_ptr(), scales.data_ptr(),
               int(scales.dtype == torch.bfloat16), n, qs.shape[0] // 16,
               variant, plan.wgs, plan.stages, plan.xstages, plan.splits,
               plan.sps, plan.clusters, int(plan.sync), y.data_ptr(), n,
               None if scratch is None else scratch.data_ptr(),
               cuda_lib.stream_handle(x.device))
    cuda_lib.check(rc, "q4_fold_gemm")
    return y


def plans(m, n, nb, sms, cap):
    """{label: B15Plan} of the sweep at one plane and M (module docstring);
    labels whose plan does not fit are left out."""
    base = qv.b15_plan(m, n, nb, sms, False, cap)
    out = {"plan": base}

    def add(label, **kw):
        try:
            out[label] = qv.b15_plan(m, n, nb, sms, False, cap, **kw)
        except ValueError:
            pass
    for st in (2, 4, 6, 8, 12, 16):
        add(f"stages_{st}", wgs=base.wgs, splits=base.splits, stages=st)
    add("one_warpgroup", wgs=1)
    for s in range(1, qv.B15_MAX_SPLITS + 1):
        add(f"splits_{s}", wgs=base.wgs, splits=s)
    tiles = -(-n // base.bn)
    out["one_cluster_an_item"] = base._replace(clusters=tiles, items=1)
    if m <= 8:                     # the other product of the plan's
        out["wgmma" if base.sync else "mma_sync"] = base._replace(
            sync=not base.sync)
    return out


def route_row(cs, qm, name, k, n, m, x, ws, packs, ws1, packs1, timed,
              timed1):
    """The part "route" at one plane and M (module docstring)."""
    w, w1 = ws[0], ws1[0]
    row = dict(route=name, m=m, k=k, n=n)
    checks = (
        ("v0", lambda ww: qv._launch_fold(x, ww.qs, ww.scales, 0, n),
         qm.q4_matmul_dequant(x, w), w, timed),
        ("b1", lambda ww: qm.q4_matmul_decode(x, ww),
         qm.q4_matmul_dequant(x, w), w, timed),
        ("b5", lambda ww: qm.q4_matmul_prefill(x, ww),
         qm.q4_matmul_dequant(x, w), w, timed),
        ("v9", lambda ww: qv._launch_fold(x, ww.qs, ww.scales, 9, n,
                                          mins=ww.mins),
         qm.q41_matmul_decode_plain(x, w1), w1, timed1),
        ("b9", lambda ww: qm.q41_matmul_decode(x, ww),
         qm.q41_matmul_decode_plain(x, w1), w1, timed1),
        ("b5_affine", lambda ww: qm.q4_matmul_prefill(x, ww),
         qm.q4_matmul_dequant(x, w1), w1, timed1))
    for label, fn, ref, ww, tm in checks:
        tol = (cs.b9_tol(torch, qm, x, ww, torch.bfloat16)
               if ww.mins is not None else 1e-5 * cs.absum_of(
                   torch, qm, x, qm.dequant_matmul_weight(ww), n,
                   torch.bfloat16))
        err = (fn(ww) - ref).abs().max().item()
        cs.require(err <= tol, f"{label} {name} M={m}: err {err} > {tol}")
        row[label] = tm(fn)
    lib = cs.int4pack_row(torch, packs, x, qm.q4_matmul_dequant(x, w), n)
    lib1 = cs.int4pack_row(torch, packs1, x,
                           qm.q41_matmul_decode_plain(x, w1), n)
    row.update(library_ms=lib.get("library_ms"),
               library_q41_ms=lib1.get("library_ms"))
    for key, ww in (("bound_ms", w), ("bound_q41_ms", w1)):
        row[key], _ = cs.bound_ms(cs.weight_bytes(ww) + x.numel() * 4
                                  + m * n * 4, 2.0 * m * k * n, "bf16")
    return row


def pin_row(cs, qm, name, m, x, w, n, nb, sms, cap, timed):
    """The part "pins" at one plane and M <= 8: variant 0 under every
    consumer warpgroup and split count, then the fastest under 2-8 ring
    slots (module docstring)."""
    ref = qm.q4_matmul_dequant(x, w)
    tol = 1e-5 * cs.absum_of(torch, qm, x, qm.dequant_matmul_weight(w), n,
                             torch.bfloat16)
    row = dict(pins=name, m=m, plan=qv.b15_plan(
        m, n, nb, sms, False, cap)._asdict(), by_plan={}, by_stages={})

    def run(plan):
        y = qv._launch_fold(x, w.qs, w.scales, 0, n, plan)
        err = (y - ref).abs().max().item()
        cs.require(err <= tol, f"pins {name} M={m} {plan}: err {err}")
        return timed(lambda ww: qv._launch_fold(x, ww.qs, ww.scales, 0, n,
                                                plan))
    best = None
    for wgs in (1, 2):
        for s in range(1, qv.B15_MAX_SPLITS + 1):
            try:
                plan = qv.b15_plan(m, n, nb, sms, False, cap, wgs=wgs,
                                   splits=s)
            except ValueError:
                continue
            ms = run(plan)
            row["by_plan"][f"wgs{wgs}_s{s}"] = dict(
                ms=ms, stages=plan.stages, clusters=plan.clusters,
                items=plan.items, sps=plan.sps)
            if best is None or ms < best[0]:
                best = (ms, plan)
    for st in (2, 3, 4, 5, 6, 8):
        try:
            plan = qv.b15_plan(m, n, nb, sms, False, cap, wgs=best[1].wgs,
                               splits=best[1].splits, stages=st)
        except ValueError:
            continue
        row["by_stages"][f"wgs{plan.wgs}_s{plan.splits}_st{st}"] = run(plan)
    return row


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("b15_sweep: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fastllama_tpu_torch.kernels import q4_floor as qf
    from fastllama_tpu_torch.kernels import q4_matmul as qm
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cuda_lib.build()
    entry = cuda_lib.fn("q4_fold_gemm")
    # the other variants on the plan: (label, variant, its entry point)
    others = [(key, v, cuda_lib.fn(qv.FOLD_ENTRY[v]))
              for key, v in (("b16", 2), ("b17", 3), ("b18", 7))]
    builds = {} if args.no_builds else build_variants()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sms = cuda_lib.sm_count(dev)
    cap = qv.b15_capacity(dev)
    print(json.dumps({"clusters_a_card": {s: cap(s) for s in range(1, 9)}}),
          flush=True)
    for name in args.planes:
        k, n = PLANES[name]
        w = cs.rand_weight(torch, k, n, gen, dev)
        nb = w.qs.shape[0] // 16                  # the stored K's q blocks
        ws = [w] + [cs.rand_weight(torch, k, n, gen, dev)
                    for _ in range(cs.copies_for(cs.weight_bytes(w)) - 1)]
        packs = cs.int4pack_packs(torch, ws)
        absum_w = (qv._codes(w.qs) + 8.0) * w.scales.abs().repeat_interleave(
            32, dim=0)
        cycle = iter(range(10**9))

        def timed(fn):
            """fn(qs, scales) timed over the weight copies in turn."""
            def call():
                ww = ws[next(cycle) % len(ws)]
                return fn(ww.qs, ww.scales)
            return cs.time_ms(call, calls=2 * len(ws))

        def timed_w(fn, copies):
            """fn(weight) timed over `copies` in turn."""
            def call():
                return fn(copies[next(cycle) % len(copies)])
            return cs.time_ms(call, calls=2 * len(copies))
        ws1 = packs1 = None
        if "route" in args.parts:              # q4_1 weights of the plane
            w1 = cs.rand_weight(torch, k, n, gen, dev, True)
            ws1 = [w1] + [cs.rand_weight(torch, k, n, gen, dev, True) for _ in
                          range(cs.copies_for(cs.weight_bytes(w1)) - 1)]
            packs1 = cs.int4pack_packs(torch, ws1)
        for m in args.rows:
            x = torch.randn((m, k), generator=gen, device=dev)
            if "route" in args.parts:
                print(json.dumps(route_row(
                    cs, qm, name, k, n, m, x, ws, packs, ws1, packs1,
                    lambda fn: timed_w(fn, ws), lambda fn: timed_w(fn, ws1))),
                    flush=True)
            if "pins" in args.parts and m <= 8:
                print(json.dumps(pin_row(
                    cs, qm, name, m, x, w, n, nb, sms, cap,
                    lambda fn: timed_w(fn, ws))), flush=True)
            if "plans" not in args.parts:
                continue
            tol = 1e-5 * (qm._pad_k(x.abs(), w.k).to(torch.bfloat16).float()
                          @ absum_w).max().item()
            want = qv.decode_plain(x, w.qs, w.scales, "v1")

            def check(label, y, variant=1):
                ref = want if variant == 1 else qv.decode_plain(
                    x, w.qs, w.scales, f"v{variant}")
                err = (y - ref).abs().max().item()
                cs.require(err <= tol, f"{label} {name} M={m}: err {err} > "
                           f"{tol}")
            row = dict(plane=name, m=m, k=k, n=n)
            done = {}
            for label, plan in plans(m, n, nb, sms, cap).items():
                if plan in done:                  # the same launch again
                    row[label] = row[done[plan]]
                    continue
                done[plan] = label
                check(label, launch(entry, x, w.qs, w.scales, 1, plan))
                row[label] = timed(lambda qs, sc, p=plan: launch(
                    entry, x, qs, sc, 1, p))
                if label == "plan":
                    row["plan_is"] = plan._asdict()
                    for key, v, fn in others:
                        check(key, launch(fn, x, w.qs, w.scales, v, plan), v)
                        row[key] = timed(lambda qs, sc, p=plan, f=fn, v=v:
                                         launch(f, x, qs, sc, v, p))
                    # the probes on the same plan (x's K is the stored K)
                    xk = qm._pad_k(x, w.k)
                    for key, fn, plain in (
                            ("b13", qf.q4_floor, qf.q4_floor_plain),
                            ("b14", qf.q4_nosc, qf.q4_nosc_plain)):
                        y, ref = fn(xk, w.qs, plan), plain(xk, w.qs)
                        err = (y - ref).abs().max().item()
                        lim = 1e-5 * ref.abs().max().item()
                        cs.require(err <= lim, f"{key} {name} M={m}: err "
                                   f"{err} > {lim}")
                        row[key] = timed(lambda qs, sc, f=fn, p=plan: f(
                            xk, qs, p))
            base = row["plan_is"]
            plan = qv.B15Plan(**base)
            if builds:
                check("no_pdl", launch(builds["no_pdl"], x, w.qs, w.scales,
                                       1, plan))
                row["no_pdl"] = timed(lambda qs, sc: launch(
                    builds["no_pdl"], x, qs, sc, 1, plan))
                merge = plan if plan.splits > 1 else qv.b15_plan(
                    m, n, nb, sms, False, cap, wgs=plan.wgs, splits=2)
                scratch = torch.empty(
                    merge.clusters * merge.splits * merge.bn * merge.nw,
                    dtype=torch.float32, device=dev)
                check("global_merge", launch(builds["global_merge"], x, w.qs,
                                             w.scales, 1, merge, scratch))
                row["global_merge"] = timed(lambda qs, sc: launch(
                    builds["global_merge"], x, qs, sc, 1, merge, scratch))
                row["cluster_merge"] = timed(lambda qs, sc: launch(
                    entry, x, qs, sc, 1, merge))
                row["merge_splits"] = merge.splits
            row["b1"] = timed(lambda qs, sc: qm.q4_matmul_decode(
                x, QuantMatmulWeight(qs=qs, scales=sc)))
            row.update(cs.int4pack_row(torch, packs, x,
                                       qm.q4_matmul_dequant(x, w), n))
            nbytes = (w.qs.numel() + w.scales.numel() * 4 + x.numel() * 4
                      + m * n * 4)
            row["bound_ms"], _ = cs.bound_ms(nbytes, 2.0 * m * k * n, "bf16")
            print(json.dumps(row), flush=True)
        if name in ("qkv", "wo", "w13", "w2") and args.b20_rows:
            for m in args.b20_rows:
                x = torch.randn((m, k), generator=gen, device=dev)
                saved = qv.B20_ON_B15_MAX_M
                qv.B20_ON_B15_MAX_M = 0           # the split kernel
                try:
                    split = timed(lambda qs, sc: qv.q4_prefill_split(
                        x, qs, sc))
                finally:
                    qv.B20_ON_B15_MAX_M = saved
                b15 = timed(lambda qs, sc: qv.q4_decode_v1(x, qs, sc))
                print(json.dumps(dict(b20_plane=name, m=m, split_ms=split,
                                      b15_ms=b15, split_vs_b15=split / b15)),
                      flush=True)
        del ws, w, packs, absum_w, ws1, packs1
    return 0


if __name__ == "__main__":
    sys.exit(main())
