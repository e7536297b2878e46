#!/usr/bin/env python3
"""Device time of the split decode-attention kernel (csrc/attn_split.cuh:
B4, B10, B6, B11 and the fused paged step) beside its yardsticks, on one
CUDA card.

    python3 tools_torch/attn_sweep.py [--parts compare,pins] [--old DIR]
        [--rounds R] [--out FILE]     # from the repository root

compare  7B widths (32 heads of 128) and 13B's 40 heads. The slab shapes
         (B4, B10): 1 x 64, 1 x 300 and 1 x 511 at S 512, 1 x 300 at S 2048,
         8 x 300 at S 512, and 40 heads at 1 x 300 and 8 x 300; bf16 caches,
         and f32 at 1 x 300. The paged shapes (B6, the fused step, B11):
         8 x 300, 8 x 64, 1 x 300, 8 ragged lengths 20-300, and 40 heads at
         8 x 300, pages of 64 rows, 8 a sequence; bf16 pools, and f32 at
         8 x 300. Each kernel is first held against its plain version (2^-7
         of the largest output for bf16, 5e-5 for f32 and for B10; caches
         and pools bit for bit), then timed in --rounds rounds of old, new,
         new, old (new alone without --old), beside one PyTorch call (SDPA
         over the live rows for B4, attention only, and B10; SDPA over the
         keys gathered from the pages for B6, B11 and the fused step, at
         equal lengths) and, at the paged shapes, B21 and B21F
         (engine/paged_kv.py, the library kernel's function on the same
         pools); the bound from the bytes each call must move.
pins     the new kernel under pinned plans (attn_plan's cs, stages, tr,
         maps) and launch modes: clusters of 1, 2, 4 and 8 blocks, ring
         depths 2, 3 and 4, 32-row tiles, strided rows in 8-row tensor-map
         boxes or one bulk copy a row, and a plain launch in place of the
         programmatic dependent one, at slab 1 x 64, 1 x 300, 1 x 300 at
         S 2048 and 8 x 300, and paged 8 x 300 (head-major and flat) and
         1 x 300.

builds   the kernel built with other consumer warp counts and rows a
         group scores at once (FLTORCH_ATTN_WARPS, FLTORCH_ATTN_ROWS), and
         without the fused modes' row write (FLTORCH_ATTN_NO_ROW: an
         ablation, timed unchecked), on the default plan, in turns with the
         default build (default, variant, variant, default), at slab 1 x 64,
         1 x 300 and 8 x 300 (B4, B10) and paged 8 x 300 and 1 x 300 (B6,
         B11, the fused step).

paths    (needs --old) the decode token and the engine steps end to end, in
         subprocesses: `bench_torch.py` (7B q4_0, 32 layers: decode tok/s
         on the host clock over replayed steps, device ms a token from a
         trace) and `tools_torch/bench_engine.py --kv-mode slab|paged` (8
         slots: the device-step rate, back-to-back replayed steps) on the
         --old tree and on this one, and this one with the attention
         kernels launched as plain stream successors (no PDL), in the
         order old, new, no-PDL, new, old.

--old DIR is a `git archive` of an earlier commit unpacked into a
git-ignored directory (_tree_check/old): its csrc/decode_attention.cu and
csrc/paged_attention.cu are built beside the new ones and launched with
that tree's argument lists and plans (the cp.async split kernels: chunks
of b10_splits and b6_plan, partials and counters in global memory).
Caches and pools are cycled past the 50 MB L2. Every row is a JSON line
naming the card and its power limit; --out writes them all as one JSON
list.
"""
import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fastllama_tpu_torch.kernels import cuda_lib  # noqa: E402
from fastllama_tpu_torch.kernels import decode_attention as da  # noqa: E402
from fastllama_tpu_torch.kernels import paged_attention as pa  # noqa: E402

D = 128
PS, PP = 64, 8                     # the engine's pages: n_ctx 512
SLAB = [("1x64", 32, 512, [64]), ("1x300", 32, 512, [300]),
        ("1x511", 32, 512, [511]), ("1x300 S2048", 32, 2048, [300]),
        ("8x300", 32, 512, [300] * 8), ("13B 1x300", 40, 512, [300]),
        ("13B 8x300", 40, 512, [300] * 8)]
PAGED = [("8x300", 32, [300] * 8), ("8x64", 32, [64] * 8),
         ("1x300", 32, [300]),
         ("8 ragged", 32, [20, 60, 100, 140, 180, 220, 260, 300]),
         ("13B 8x300", 40, [300] * 8)]
F32_SLAB, F32_PAGED = ("1x300",), ("8x300",)
PIN_SLAB = ("1x64", "1x300", "1x300 S2048", "8x300")
PIN_PAGED = ("8x300", "1x300")
PINS = [dict(cs=c) for c in (1, 2, 4, 8)] + [
    dict(stages=2), dict(stages=3), dict(stages=4), dict(tr=32),
    dict(maps=False), dict(maps=True), dict(pdl=False)]


def set_pdl(on):
    """Launch the new kernels as programmatic dependents (the default) or
    as plain stream successors."""
    for lib in ("decode_attention", "paged_attention"):
        cuda_lib.fn(f"{lib}_set_pdl")(int(on))


def pinned(pin, *shape):
    """The plan of `shape` (attn_plan's arguments) under `pin`; a pdl pin
    sets the launch mode (and the plan is the default)."""
    set_pdl(pin.get("pdl", True))
    return da.attn_plan(*shape, **{k: v for k, v in pin.items()
                                   if k != "pdl"})

# The --old tree's entries: its argument lists (plans, scratch, counters)
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_ARGTYPES = {
    "decode_attention_fused": [P_] * 6 + [I_] * 6 + [F_, I_] + [P_] * 4,
    "decode_attention": [P_] * 4 + [I_] * 6 + [F_, I_] + [P_] * 4,
    "paged_decode_attention": [P_, I_, I_] + [P_] * 4 + [I_] * 8
                              + [F_, I_] + [P_] * 4,
    "paged_decode_attention_flat": [P_, I_, I_] + [P_] * 4 + [I_] * 8
                                   + [F_, I_] + [P_] * 4,
    "paged_decode_step_fused": [P_] * 9 + [I_] * 8 + [F_, I_] + [P_] * 4,
}
OLD_LIB = {"decode_attention_fused": "decode_attention",
           "decode_attention": "decode_attention",
           "paged_decode_attention": "paged_attention",
           "paged_decode_attention_flat": "paged_attention",
           "paged_decode_step_fused": "paged_attention"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="compare,pins",
                    help="comma-separated: compare, pins, builds, paths")
    ap.add_argument("--old", default=None,
                    help="an unpacked checkout whose kernels to time beside")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    args.parts = [p for p in args.parts.split(",") if p]
    bad = set(args.parts) - {"compare", "pins", "builds", "paths"}
    if bad:
        ap.error(f"unknown parts {sorted(bad)}")
    if args.rounds < 1:
        ap.error("--rounds must be at least 1")
    if "paths" in args.parts and not args.old:
        ap.error("paths needs --old")
    return args


def build_old(tree):
    """{entry: function} of the --old checkout's two attention sources,
    built in parallel into the git-ignored build directory."""
    csrc = Path(tree) / "fastllama_tpu_torch" / "kernels" / "csrc"
    procs = {}
    for name in sorted(set(OLD_LIB.values())):
        out = cuda_lib.BUILD_DIR / f"libold_{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"attn_sweep: old {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    entries = {}
    for fn_name, argtypes in OLD_ARGTYPES.items():
        fn = getattr(libs[OLD_LIB[fn_name]], fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[fn_name] = fn
    return entries


BUILDS = {"warps8_rows4": ["-DFLTORCH_ATTN_WARPS=8", "-DFLTORCH_ATTN_ROWS=4"],
          "rows1": ["-DFLTORCH_ATTN_ROWS=1"],
          "no_row": ["-DFLTORCH_ATTN_NO_ROW"]}
BUILD_SLAB = ("1x64", "1x300", "8x300")
BUILD_PAGED = ("8x300", "1x300")


def build_variants():
    """{variant: {entry: function}}: the two attention sources built with
    each BUILDS flag set, in parallel, with the new argument lists."""
    procs = {}
    for var, flags in BUILDS.items():
        for name in ("decode_attention", "paged_attention"):
            out = cuda_lib.BUILD_DIR / f"lib{var}_{name}.so"
            procs[var, name] = (subprocess.Popen(
                [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *flags, "-o",
                 str(out), str(cuda_lib.CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out)
    libs = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"attn_sweep: build {key} failed:\n{log}")
        libs[key] = ctypes.CDLL(str(out))
    got = {}
    for var in BUILDS:
        got[var] = {}
        for fn_name, lib in OLD_LIB.items():
            fn = getattr(libs[var, lib], fn_name)
            fn.argtypes = cuda_lib.ARGTYPES[fn_name]
            fn.restype = ctypes.c_int
            got[var][fn_name] = fn
    return got


def builds_part(args, gen, dev, rows, label):
    """Each BUILDS variant against the default build, in turns."""
    variants = build_variants()
    scale = 1 / math.sqrt(D)
    for name, h, s, lens in SLAB:
        if name not in BUILD_SLAB:
            continue
        caches, qkv, npv, cos, sin = slab_case(gen, dev, h, s, lens,
                                               torch.bfloat16)
        q = qkv[:, :, :h * D].contiguous()
        it = iter(range(10**9))

        def cyc():
            return caches[next(it) % len(caches)]
        for kern, first, lanes in (("decode_attention_fused", qkv,
                                    (cos, sin)),
                                   ("decode_attention", q, ())):
            for var, entries in variants.items():
                def run(entry):
                    return cs.time_ms(lambda: da._launch_slab(
                        kern, first, *cyc(), npv, lanes, D, scale,
                        entry=entry), calls=2 * len(caches))
                row = dict(shape=f"slab {name} H={h} S={s} bfloat16",
                           kernel="B4" if lanes else "B10", build=var)
                try:
                    got = turns(lambda: run(entries[kern]),
                                lambda: run(None), args.rounds)
                except RuntimeError as e:
                    card_rows(rows, dict(row, error=str(e)), label)
                    continue
                summary(row, got)
                row["default_ms"] = row.pop("old_ms")
                row["variant_ms"] = row.pop("new_ms")
                row["variant_over_default"] = row.pop("new_over_old")
                card_rows(rows, row, label)
        del caches
    for name, h, lens in PAGED:
        if name not in BUILD_PAGED:
            continue
        pools, tables, lengths = paged_case(gen, dev, h, lens,
                                            torch.bfloat16)
        b, f, n_pages = len(lens), h * D, len(lens) * PP
        q = torch.randn((b, h, D), generator=gen, device=dev)
        flats = [tuple(x.permute(1, 2, 0, 3).reshape(n_pages + 1, PS, f)
                       .contiguous() for x in kv) for kv in pools]
        qkv = torch.randn((b, 3 * f), generator=gen, device=dev)
        pos = [min(n, PP * PS - 1) for n in lens]
        page_ids = tables[torch.arange(b, device=dev),
                          torch.tensor([p // PS for p in pos],
                                       device=dev)].contiguous()
        offsets = torch.tensor([p % PS for p in pos], dtype=torch.int32,
                               device=dev)
        cos, sin = da.rope_lane_tables(lengths, D, D)
        it = iter(range(10**9))

        def cyc(src):
            return src[next(it) % len(src)]
        for kern, src, key in (
                ("paged_decode_attention", pools, "B6"),
                ("paged_decode_attention_flat", flats, "B11"),
                ("paged_decode_step_fused", pools, "PS")):
            fused = ((qkv, page_ids, offsets, cos, sin) if key == "PS"
                     else ())
            qa = qkv[:, :f].view(b, h, D) if fused else q
            for var, entries in variants.items():
                def run(entry):
                    return cs.time_ms(lambda: pa._launch(
                        kern, qa, *cyc(src), lengths, tables, n_pages + 1,
                        PS, fused=fused, entry=entry), calls=2 * len(pools))
                row = dict(shape=f"paged {name} H={h} ps={PS} pp={PP} "
                           "bfloat16", kernel=key, build=var)
                try:
                    got = turns(lambda: run(entries[kern]),
                                lambda: run(None), args.rounds)
                except RuntimeError as e:
                    card_rows(rows, dict(row, error=str(e)), label)
                    continue
                summary(row, got)
                row["default_ms"] = row.pop("old_ms")
                row["variant_ms"] = row.pop("new_ms")
                row["variant_over_default"] = row.pop("new_over_old")
                card_rows(rows, row, label)
        del pools, flats


PATH_RUNS = ("old", "new", "nopdl", "new", "old")
# the no-PDL run: the kernels' launch mode set before the script runs
NOPDL = ("import runpy, sys; from fastllama_tpu_torch.kernels import "
         "cuda_lib; cuda_lib.build(); "
         "[cuda_lib.fn(f'{x}_set_pdl')(0) for x in ('decode_attention', "
         "'paged_attention')]; sys.argv = sys.argv[1:]; "
         "runpy.run_path(sys.argv[0], run_name='__main__')")


def path_run(tree, script, args, nopdl=False):
    """stdout of one script run in `tree` (a subprocess, so each tree's
    package is its own)."""
    cmd = ([sys.executable, "-c", NOPDL] if nopdl else [sys.executable])
    out = subprocess.run(cmd + [script, *args], cwd=tree,
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"attn_sweep: {script} in {tree} failed:\n"
                         f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return out.stdout, out.stderr


def paths_part(args, rows, label):
    """The decode token and the 8-slot engine steps on the --old tree and
    this one, in turns."""
    import re
    here = str(Path(__file__).resolve().parents[1])
    for i, who in enumerate(PATH_RUNS):
        tree = args.old if who == "old" else here
        row = dict(path_run=i, tree=who)
        out, err = path_run(tree, "bench_torch.py", [], who == "nopdl")
        line = json.loads(out.strip().splitlines()[-1])
        row["decode_tok_s"] = line.get("value")
        row["slope_tok_s"] = line.get("steady_state_tokens_per_sec")
        m = re.search(r"device_ms_per_token: ([0-9.]+)", err)
        row["device_ms_per_token"] = float(m.group(1)) if m else None
        m = re.search(r"\(([0-9.]+) ms/token\)", err)
        row["host_ms_per_token"] = float(m.group(1)) if m else None
        for mode in ("slab", "paged"):
            out, _ = path_run(tree, "tools_torch/bench_engine.py",
                              ["--kv-mode", mode], who == "nopdl")
            m = re.search(r"device-step rate: (\d+) steps in ([0-9.]+)s",
                          out)
            row[f"{mode}_ms_per_step"] = (float(m.group(2)) * 1e3
                                          / int(m.group(1)) if m else None)
        card_rows(rows, row, label)


def old_splits(s):
    """The old B4 / B10 split: chunks of at most 64 rows cut from S."""
    splits = -(-s // 64)
    return splits, -(-s // splits)


def old_b6_plan(pp, ps, d, isz):
    """The old B6 / B11 plan: the smallest chunk of at least 64 rows that
    is a multiple or a divisor of the page, K and V within 96 KB."""
    s = pp * ps
    cands = [c for c in range(1, min(256, s) + 1)
             if (c % ps == 0 or ps % c == 0) and 2 * c * d * isz <= 96 * 1024]
    chunk = next((c for c in cands if c >= 64), cands[-1])
    return -(-s // chunk), chunk


def old_call(fn, name, head, b, h, splits, chunk, scale, bf16, out):
    """One launch of the old entry `name` with its global partials and
    counters."""
    dev = out.device
    partial = cuda_lib.scratch(dev, "old.partial", b * h * splits * (D + 2),
                               torch.float32)
    counters = cuda_lib.tile_counters(dev, b * h)
    cuda_lib.check(fn(*head, splits, chunk, scale, bf16, partial.data_ptr(),
                      counters.data_ptr(), out.data_ptr(),
                      cuda_lib.stream_handle(dev)), f"old {name}")
    return out


def err_of(got, want):
    return (got - want).abs().max().item()


def rel_tol(dt):
    return 2 ** -7 if dt == torch.bfloat16 else 5e-5


OUT = [None]        # --out, rewritten after every row


def card_rows(rows, row, label):
    print(json.dumps(dict(row, card=label)), flush=True)
    rows.append(dict(row, card=label))
    if OUT[0]:
        Path(OUT[0]).write_text(json.dumps(rows, indent=1))


def turns(new, old, rounds):
    """ms of new (and old) in rounds of old, new, new, old: each list."""
    got = {"new": [], "old": []}
    for _ in range(rounds):
        order = ("old", "new", "new", "old") if old else ("new",)
        for who in order:
            got[who].append((new if who == "new" else old)())
    return got


def summary(row, got):
    """The means of the turns and their spread (max - min over mean)."""
    for who, ms in got.items():
        if ms:
            mean = sum(ms) / len(ms)
            row[f"{who}_ms"] = mean
            row[f"{who}_spread"] = (max(ms) - min(ms)) / mean
    if got["old"]:
        row["new_over_old"] = row["new_ms"] / row["old_ms"]


def slab_case(gen, dev, h, s, lens, dt):
    b, f = len(lens), h * D
    nbytes = 2 * b * s * f * dt.itemsize
    caches = [tuple(torch.randn((b, s, f), generator=gen, device=dev).to(dt)
                    for _ in range(2)) for _ in range(cs.copies_for(nbytes))]
    qkv = torch.randn((b, 1, 3 * f), generator=gen, device=dev)
    npv = torch.tensor(lens, dtype=torch.int32, device=dev)
    cos, sin = da.rope_lane_tables(npv, D, D)
    return caches, qkv, npv, cos, sin


def slab_part(args, gen, dev, old, rows, label, pins_only=False):
    scale = 1 / math.sqrt(D)
    kw4 = dict(head_dim=D, n_rot=D, scale=scale)
    for name, h, s, lens in SLAB:
        dts = [torch.bfloat16] + ([torch.float32] if name in F32_SLAB
                                  else [])
        if pins_only:
            if name not in PIN_SLAB:
                continue
            dts = [torch.bfloat16]
        for dt in dts:
            caches, qkv, npv, cos, sin = slab_case(gen, dev, h, s, lens, dt)
            b, f = len(lens), h * D
            isz = dt.itemsize
            q = qkv[:, :, :f].contiguous()
            it = iter(range(10**9))

            def cyc():
                return caches[next(it) % len(caches)]
            calls = 2 * len(caches)
            base = dict(shape=f"slab {name} H={h} S={s} {dt}".replace(
                "torch.", ""), lengths=lens)
            if pins_only:
                for pin in PINS:
                    plan = pinned(pin, b, h, s, D, isz,
                                  cuda_lib.sm_count(dev))
                    for kern, first, lanes in (
                            ("decode_attention_fused", qkv, (cos, sin)),
                            ("decode_attention", q, ())):
                        ms = cs.time_ms(lambda: da._launch_slab(
                            kern, first, *cyc(), npv, lanes, D, scale,
                            plan=plan), calls=calls)
                        card_rows(rows, dict(base, kernel="B4" if lanes
                                             else "B10", pin=pin,
                                             plan=plan._asdict(), ms=ms),
                                  label)
                set_pdl(True)
                continue
            # B4: against the plain version, caches bit for bit
            k1, v1 = (x.clone() for x in caches[0])
            k2, v2 = (x.clone() for x in caches[0])
            got = da.decode_attention_fused(qkv, k1, v1, npv, cos, sin, **kw4)
            want = da.decode_attention_fused_plain(qkv, k2, v2, npv, cos, sin,
                                                   **kw4)
            tol = rel_tol(dt) * want.abs().max().item() + 1e-6
            cs.require(err_of(got, want) <= tol and torch.equal(k1, k2)
                       and torch.equal(v1, v2), f"B4 {base}: wrong")
            fo = old["decode_attention_fused"] if old else None
            splits, chunk = old_splits(s)

            def b4_old():
                kc, vc = cyc()
                return old_call(fo, "decode_attention_fused", (
                    qkv.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                    npv.data_ptr(), cos.data_ptr(), sin.data_ptr(), b, s, f,
                    D), b, h, splits, chunk, scale, int(isz == 2),
                    torch.empty((b, 1, f), device=dev))
            if old:
                k3, v3 = (x.clone() for x in caches[0])
                out = torch.empty((b, 1, f), device=dev)
                old_call(fo, "decode_attention_fused", (
                    qkv.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                    npv.data_ptr(), cos.data_ptr(), sin.data_ptr(), b, s, f,
                    D), b, h, splits, chunk, scale, int(isz == 2), out)
                cs.require(err_of(out, want) <= tol and torch.equal(k3, k2),
                           f"old B4 {base}: wrong")
            got_t = turns(
                lambda: cs.time_ms(lambda: da.decode_attention_fused(
                    qkv, *cyc(), npv, cos, sin, **kw4), calls=calls),
                (lambda: cs.time_ms(b4_old, calls=calls)) if old else None,
                args.rounds)
            rows_live = sum(min(n, s) for n in lens)
            bnd, by = cs.bound_ms(
                b * (3 * f * 4 + 2 * f * isz + 2 * D * 4 + 4 + f * 4)
                + 2 * rows_live * f * isz, 4.0 * rows_live * f,
                "bf16" if isz == 2 else "f32")
            row = dict(base, kernel="B4", max_abs_err=err_of(got, want),
                       tol=tol, bound_ms=bnd, bound_by=by,
                       plan=da.attn_plan(b, h, s, D, isz,
                                         cuda_lib.sm_count(dev))._asdict())
            summary(row, got_t)
            if len(set(lens)) == 1:
                qh = torch.randn((b, h, 1, D), generator=gen,
                                 device=dev).to(torch.bfloat16)
                row["library_ms"] = cs.sdpa_cycled(
                    torch, qh, [tuple(x.to(torch.bfloat16) for x in kv)
                                for kv in caches] if isz == 4 else caches,
                    max(min(lens[0], s), 1), h, D)
                row["library"] = "SDPA over the live rows, attention only"
            card_rows(rows, row, label)

            # B10
            got = da.decode_attention(q, *caches[0], npv, head_dim=D,
                                      scale=scale)
            want = da.decode_attention_plain(q, *caches[0], npv, head_dim=D,
                                             scale=scale)
            tol = 5e-5 * want.abs().max().item() + 1e-6
            cs.require(err_of(got, want) <= tol, f"B10 {base}: wrong")
            fo = old["decode_attention"] if old else None

            def b10_old(kv=None):
                kc, vc = kv or cyc()
                return old_call(fo, "decode_attention", (
                    q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                    npv.data_ptr(), b, s, f, D), b, h, splits, chunk, scale,
                    int(isz == 2), torch.empty((b, 1, f), device=dev))
            if old:
                cs.require(err_of(b10_old(caches[0]), want) <= tol,
                           f"old B10 {base}: wrong")
            got_t = turns(
                lambda: cs.time_ms(lambda: da.decode_attention(
                    q, *cyc(), npv, head_dim=D, scale=scale), calls=calls),
                (lambda: cs.time_ms(b10_old, calls=calls)) if old else None,
                args.rounds)
            rows10 = sum(min(n + 1, s) for n in lens)
            bnd, by = cs.bound_ms(b * (2 * f * 4 + 4) + 2 * rows10 * f * isz,
                                  4.0 * rows10 * f,
                                  "bf16" if isz == 2 else "f32")
            row = dict(base, kernel="B10", max_abs_err=err_of(got, want),
                       tol=tol, bound_ms=bnd, bound_by=by)
            summary(row, got_t)
            if len(set(lens)) == 1:
                qh = q.reshape(b, h, 1, D).to(dt)
                row["library_ms"] = cs.sdpa_cycled(
                    torch, qh, caches, min(lens[0] + 1, s), h, D)
                row["library"] = "SDPA over the live rows"
            card_rows(rows, row, label)
            del caches


def paged_case(gen, dev, h, lens, dt):
    b = len(lens)
    n_pages = b * PP
    nbytes = 2 * h * (n_pages + 1) * PS * D * dt.itemsize
    pools = [tuple(torch.randn((h, n_pages + 1, PS, D), generator=gen,
                               device=dev).to(dt) for _ in range(2))
             for _ in range(cs.copies_for(nbytes))]
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    tables = perm.reshape(b, PP).to(torch.int32).contiguous()
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return pools, tables, lengths


def paged_part(args, gen, dev, old, rows, label, pins_only=False):
    from fastllama_tpu_torch.engine import paged_kv as pk
    scale = 1 / math.sqrt(D)
    for name, h, lens in PAGED:
        dts = [torch.bfloat16] + ([torch.float32] if name in F32_PAGED
                                  else [])
        if pins_only:
            if name not in PIN_PAGED:
                continue
            dts = [torch.bfloat16]
        for dt in dts:
            pools, tables, lengths = paged_case(gen, dev, h, lens, dt)
            b, f, isz = len(lens), h * D, dt.itemsize
            n_pages = b * PP
            q = torch.randn((b, h, D), generator=gen, device=dev)
            qkv = torch.randn((b, 3 * f), generator=gen, device=dev)
            # the new rows: each sequence's next row (its page and offset)
            pos = [min(n, PP * PS - 1) for n in lens]
            page_ids = tables[torch.arange(b, device=dev),
                              torch.tensor([p // PS for p in pos],
                                           device=dev)].contiguous()
            offsets = torch.tensor([p % PS for p in pos], dtype=torch.int32,
                                   device=dev)
            cos, sin = da.rope_lane_tables(lengths, D, D)
            flats = [tuple(x.permute(1, 2, 0, 3).reshape(n_pages + 1, PS, f)
                           .contiguous() for x in kv) for kv in pools]
            it = iter(range(10**9))

            def cyc(src):
                return src[next(it) % len(src)]
            calls = 2 * len(pools)
            base = dict(shape=f"paged {name} H={h} ps={PS} pp={PP} {dt}"
                        .replace("torch.", ""), lengths=lens)
            if pins_only:
                for pin in PINS:
                    plan = pinned(pin, b, h, PP * PS, D, isz,
                                  cuda_lib.sm_count(dev))
                    for kern, src in (("paged_decode_attention", pools),
                                      ("paged_decode_attention_flat", flats)):
                        ms = cs.time_ms(lambda: pa._launch(
                            kern, q, *cyc(src), lengths, tables, n_pages + 1,
                            PS, plan=plan), calls=calls)
                        card_rows(rows, dict(
                            base, kernel="B6" if src is pools else "B11",
                            pin=pin, plan=plan._asdict(), ms=ms), label)
                set_pdl(True)
                continue
            rows_live = sum(lens)
            bnd, by = cs.bound_ms(
                b * (2 * f * 4 + 4 + PP * 4) + 2 * rows_live * f * isz,
                4.0 * rows_live * f, "bf16" if isz == 2 else "f32")
            gathered = None
            if len(set(lens)) == 1:
                idx = tables.long()
                gathered = [tuple(x[:, idx].permute(1, 0, 2, 3, 4).reshape(
                    b, h, PP * PS, D)[:, :, :lens[0]].to(torch.bfloat16)
                    .contiguous() for x in kv) for kv in pools]
            qh = q.reshape(b, h, 1, D).to(torch.bfloat16)
            lib = cs.sdpa_over(torch, qh, gathered) if gathered else None
            del gathered
            b21 = cs.time_ms(lambda: pk.paged_attention_tpu(
                q, *cyc(pools), lengths, tables), calls=calls)
            for kern, src, key in (("paged_decode_attention", pools, "B6"),
                                   ("paged_decode_attention_flat", flats,
                                    "B11")):
                fn = getattr(pa, kern)
                want = (pa.paged_decode_attention_plain(q, *pools[0], lengths,
                                                        tables))
                got = fn(q, *src[0], lengths, tables)
                tol = rel_tol(dt) * want.abs().max().item() + 1e-6
                cs.require(err_of(got, want) <= tol, f"{key} {base}: wrong")
                fo = old[kern] if old else None
                splits, chunk = old_b6_plan(PP, PS, D, isz)

                def run_old(kv=None):
                    kp, vp = kv or cyc(src)
                    return old_call(fo, kern, (
                        q.data_ptr(), q.stride(0), q.stride(1),
                        kp.data_ptr(), vp.data_ptr(), lengths.data_ptr(),
                        tables.data_ptr(), b, h, n_pages + 1, PS, PP, D), b,
                        h, splits, chunk, scale, int(isz == 2),
                        torch.empty((b, h, D), device=dev))
                if old:
                    cs.require(err_of(run_old(src[0]), want) <= tol,
                               f"old {key} {base}: wrong")
                got_t = turns(
                    lambda: cs.time_ms(lambda: fn(
                        q, *cyc(src), lengths, tables), calls=calls),
                    (lambda: cs.time_ms(run_old, calls=calls)) if old
                    else None, args.rounds)
                row = dict(base, kernel=key, max_abs_err=err_of(got, want),
                           tol=tol, bound_ms=bnd, bound_by=by,
                           library_ms=lib, b21_ms=b21)
                if lib is not None:
                    row["library"] = "SDPA over the gathered keys"
                summary(row, got_t)
                card_rows(rows, row, label)

            # the fused step: pools and written rows bit for bit
            k1, v1 = (x.clone() for x in pools[0])
            k2, v2 = (x.clone() for x in pools[0])
            args5 = (lengths, tables, page_ids, offsets, cos, sin)
            got = pa.paged_decode_step_fused(qkv, k1, v1, *args5)
            want = pa.paged_decode_step_fused_plain(qkv, k2, v2, *args5)
            tol = rel_tol(dt) * want.abs().max().item() + 1e-6
            cs.require(err_of(got, want) <= tol and torch.equal(k1, k2)
                       and torch.equal(v1, v2), f"PS {base}: wrong")
            fo = old["paged_decode_step_fused"] if old else None

            def ps_old():
                kp, vp = cyc(pools)
                return old_call(fo, "paged_decode_step_fused", (
                    qkv.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    lengths.data_ptr(), tables.data_ptr(),
                    page_ids.data_ptr(), offsets.data_ptr(), cos.data_ptr(),
                    sin.data_ptr(), b, h, n_pages + 1, PS, PP, D), b, h,
                    *old_b6_plan(PP, PS, D, isz), scale, int(isz == 2),
                    torch.empty((b, h, D), device=dev))
            if old:
                k3, v3 = (x.clone() for x in pools[0])
                out = torch.empty((b, h, D), device=dev)
                old_call(fo, "paged_decode_step_fused", (
                    qkv.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                    lengths.data_ptr(), tables.data_ptr(),
                    page_ids.data_ptr(), offsets.data_ptr(), cos.data_ptr(),
                    sin.data_ptr(), b, h, n_pages + 1, PS, PP, D), b, h,
                    *old_b6_plan(PP, PS, D, isz), scale, int(isz == 2), out)
                cs.require(err_of(out, want) <= tol and torch.equal(k3, k2),
                           f"old PS {base}: wrong")
            got_t = turns(
                lambda: cs.time_ms(lambda: pa.paged_decode_step_fused(
                    qkv, *cyc(pools), *args5), calls=calls),
                (lambda: cs.time_ms(ps_old, calls=calls)) if old else None,
                args.rounds)
            b21f = cs.time_ms(lambda: pk.paged_attention_tpu_fused(
                qkv, *cyc(pools), *args5), calls=calls)
            bnd, by = cs.bound_ms(
                b * (3 * f * 4 + 2 * f * isz + 2 * D * 4 + 12 + PP * 4
                     + f * 4) + 2 * rows_live * f * isz,
                4.0 * (rows_live + b) * f, "bf16" if isz == 2 else "f32")
            row = dict(base, kernel="PS", max_abs_err=err_of(got, want),
                       tol=tol, bound_ms=bnd, bound_by=by, library_ms=lib,
                       b21f_ms=b21f)
            summary(row, got_t)
            card_rows(rows, row, label)
            del pools, flats


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_sweep: no CUDA card", file=sys.stderr)
        return 2
    from tools_torch._trace_util import card_line
    dev = torch.device("cuda", 0)
    label = card_line()
    print(f"attn_sweep: card {label}", flush=True)
    cuda_lib.build()
    old = build_old(args.old) if args.old else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        OUT[0] = args.out
    if "compare" in args.parts:
        slab_part(args, gen, dev, old, rows, label)
        paged_part(args, gen, dev, old, rows, label)
    if "pins" in args.parts:
        slab_part(args, gen, dev, None, rows, label, pins_only=True)
        paged_part(args, gen, dev, None, rows, label, pins_only=True)
    if "builds" in args.parts:
        builds_part(args, gen, dev, rows, label)
    if "paths" in args.parts:
        paths_part(args, rows, label)
    print(json.dumps(dict(rows=len(rows), card=label)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
