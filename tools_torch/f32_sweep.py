#!/usr/bin/env python3
"""Device time of the f32-mode matmuls on one CUDA card: B1 and B9 (the
fold kernel's variants 10 and 11, csrc/q4_fold.cuh) and B5 (the register-A
kernel's f32 mode, csrc/q4_prefill_ra.cuh).

    python3 tools_torch/f32_sweep.py
        [--parts check,decode,route,prefill,pins,paths] [--old DIR]
        [--rounds R] [--out FILE]                  # from the repo root

Parts:
  check    each kernel once against its plain version at a few shapes (no
           timing: the first call after touching the kernels);
  decode   B1 and B9 in f32 mode on every 7B plane at M = 1, 2, 8, 64
           (64: the wrappers' call of B5's f32 mode) and the 13B planes
           at M = 1, 8: beside the bf16 mode's kernel at the
           same shape (variants 0 and 9), one torch.mm f32 of the
           dequantized weight, and the bounds (bytes, FFMA, three-part
           tensor); with --old DIR also that checkout's f32 kernel (the
           FFMA GEMV, q4_gemv / q41_gemv of its csrc/q4_decode.cu, on its
           own plan), in --rounds rounds of old, new, new, old;
  route    B1 and B9 in f32 mode (the fold kernel's variants 10 and 11,
           launched directly) beside B5's f32 mode (the register-A
           kernel: the same function in f32) at M = 8-32 on the 7B
           planes, q4_0 and q4_1: where B1 and B9 send f32 calls to B5
           (f32_on_b5; the fold's f32 modes are built to 32 rows);
  prefill  B5 in f32 mode (q4_0, q4_1) on the 7B and 13B planes at M = 65,
           128, 192, 256, 300, 512, 513, beside torch.mm f32 and the
           bounds; with --old DIR that checkout's FFMA tile
           (f32_gemm_kernel, its q4_prefill_gemm with bf16 = 0) in turns.
  pins     B5 in f32 mode (q4_0) on the 7B and 13B planes at PIN_ROWS
           under every distinct plan that prefill_plan picks for a merge
           cost in MERGE_CANDIDATES (RA_MERGE_STAGES_F32), each timed once;
           then a "fit" row: for each candidate, the mean over shapes of
           its plan's time over the fastest timed plan's (merge_fit);
  paths    (needs --old) the f32 path end to end at full 7B width (32
           layers, q4_0, weight and KV f32): the session's TTFT for a
           300-token prompt and ms a greedy token on the host clock, the
           window's and a token's device time from traces, and the 8-slot
           paged engine's steady step, each tree in a subprocess of its own
           (PATH_SNIPPET, which uses only chip_smoke helpers both trees
           have), in the order old, new, new, old;
--old DIR is a `git archive` of an earlier commit unpacked into a
git-ignored directory (_tree_check/); its sources are built here. Every
row is first held against the plain version within 1e-5 of the largest
|x| @ |W| (the old kernels too). Weights are cycled through more than the
50 MB L2. One JSON line a row, on stdout and in --out (default
chiprun_out/f32_sweep.jsonl), each with the card's name and power limit.
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
from fastllama_tpu_torch.utils.trace import copies_for, time_ms  # noqa: E402

DECODE_ROWS = (1, 2, 8, 64)
ROUTE_ROWS = (8, 9, 16, 17, 24, 32)
PIN_ROWS = (24, 32, 48, 64, 128, 192, 256, 300, 512, 513)
MERGE_CANDIDATES = (2, 3, 4, 5, 7, 10, 14, 20, 28)
DECODE_ROWS_13B = (1, 8)
PREFILL_ROWS = (65, 128, 192, 256, 300, 512, 513)

# The --old checkout's f32 entries (the FFMA kernels this mode replaced):
# csrc/q4_decode.cu's GEMV and csrc/q4_prefill.cu's entry, with that
# checkout's argument lists.
P_, I_ = ctypes.c_void_p, ctypes.c_int
OLD_ENTRIES = {
    "q4_gemv": ("q4_decode", [P_, I_, I_, P_, P_, I_, I_, I_, I_, P_, P_, P_,
                              I_, I_, P_]),
    "q41_gemv": ("q4_decode", [P_, I_, I_, P_, P_, P_, I_, I_, I_, I_, P_, P_,
                               P_, I_, I_, P_]),
    "q4_prefill_gemm": ("q4_prefill", [P_, I_, I_, P_, P_, P_, I_, I_, P_, I_,
                                       I_, I_, I_, I_, I_, P_, P_, P_, I_, I_,
                                       P_]),
}


def build_old(tree):
    """{entry: function} of the --old checkout's f32 kernels, its two
    sources built in parallel into the git-ignored build directory."""
    csrc = Path(tree) / "fastllama_tpu_torch" / "kernels" / "csrc"
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted({s for s, _ in OLD_ENTRIES.values()}):
        out = cuda_lib.BUILD_DIR / f"libold_f32_{src}.so"
        procs[src] = (subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out),
             str(csrc / f"{src}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for src, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"f32_sweep: old {src} did not build:\n{log}")
        libs[src] = ctypes.CDLL(str(out))
    entries = {}
    for name, (src, argtypes) in OLD_ENTRIES.items():
        fn = getattr(libs[src], name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    return entries


def old_gemv_plan(m, n, nb):
    """(tiles, splits, q blocks a split) of the old f32 GEMV: 1, 4 or 16
    rows by 256, 256 or 128 columns a block, about 4 blocks an SM of 132,
    8 to 32 q blocks a split (that checkout's q4_matmul._b1_tile and
    _splitk)."""
    rows, cols = (1, 256) if m == 1 else (4, 256) if m <= 4 else (16, 128)
    tiles = -(-n // cols) * -(-m // rows)
    per = -(-nb // max(1, -(-528 // tiles)))
    per = min(32, max(per, min(8, nb)))
    return tiles, -(-nb // per), per


def old_tile_plan(m, n, kc, sms):
    """(tiles, splits, 32-deep steps a split) of the old f32 prefill tile
    (128 x 128 outputs): split where the tiles leave SMs idle, at least 8
    steps a split, costed by rounds times steps plus one for a merge (that
    checkout's q4_matmul.b5_plan(f32=True))."""
    tiles = -(-m // 128) * -(-n // 128)
    nk = -(-kc // 32)
    best = None
    for s in range(1, 9):
        per = -(-nk // s)
        if s > 1 and per < 8:
            break
        splits = -(-nk // per)
        cost = -(-(tiles * splits) // sms) * per + (splits > 1)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return tiles, best[1], best[2]


def old_gemv(fn, x, w):
    """The old f32 GEMV (split-K FFMA, last-block reduction) on its plan
    (old_gemv_plan)."""
    m, kx = x.shape
    kh, n = w.qs.shape
    nb = kh // 16
    tiles, splits, per = old_gemv_plan(m, n, nb)
    partial = cuda_lib.scratch(x.device, "old.gemv", splits * m * n,
                               torch.float32)
    counters = cuda_lib.tile_counters(x.device, tiles)
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=x.device)
    planes = (w.qs, w.scales) if w.mins is None else (w.qs, w.scales, w.mins)
    cuda_lib.check(fn(
        x.data_ptr(), m, kx, *(p.data_ptr() for p in planes), n, nb, splits,
        per, partial.data_ptr(), counters.data_ptr(), y.data_ptr(),
        w.n_logical, 0, cuda_lib.stream_handle(x.device)), "old gemv")
    return y


def old_ffma_tile(fn, x, w, sms):
    """The old f32 prefill kernel (128 x 128 FFMA tiles, the weight
    dequantized in shared memory) on its plan (old_tile_plan)."""
    m, kx = x.shape
    n, k = w.qs.shape[1], w.k
    tiles, splits, per = old_tile_plan(m, n, -(-kx // 32) * 32, sms)
    partial = cuda_lib.scratch(x.device, "old.ffma",
                               tiles * splits * 128 * 128 if splits > 1
                               else 1, torch.float32)
    counters = cuda_lib.tile_counters(x.device, tiles)
    y = torch.empty((m, w.n_logical), dtype=torch.float32, device=x.device)
    cuda_lib.check(fn(
        x.data_ptr(), m, kx, w.qs.data_ptr(), w.scales.data_ptr(),
        None if w.mins is None else w.mins.data_ptr(), n, k,
        partial.data_ptr(), 0, 0, 0, splits, per, 0, partial.data_ptr(),
        counters.data_ptr(), y.data_ptr(), w.n_logical, 0,
        cuda_lib.stream_handle(x.device)), "old q4_prefill_gemm")
    return y


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]


class Rows:
    def __init__(self, path, smi):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self.fh = open(path, "w")
        self.smi = smi

    def emit(self, row):
        row["card"] = self.smi
        line = json.dumps(row)
        print(line, flush=True)
        self.fh.write(line + "\n")
        self.fh.flush()


def plain_of(x, w):
    """(the plain version's y, the tolerance 1e-5 of max |x| @ |W|)."""
    wd = qm.dequant_matmul_weight(w, torch.float32)
    tol = 1e-5 * (qm._pad_k(x.abs(), w.k) @ wd.abs())[:, :w.n_logical].max()
    if w.mins is not None and x.shape[0] <= qm.DECODE_MAX_M:
        return qm.q41_matmul_decode_plain(x, w, torch.float32), tol.item()
    return qm.q4_matmul_dequant(x, w, torch.float32), tol.item()


def held(label, y, want, tol):
    err = (y - want).abs().max().item()
    if not (torch.isfinite(y).all() and err <= tol):
        raise SystemExit(f"f32_sweep: {label}: err {err} > {tol}")
    return err


def turns(new, old, rounds):
    """Mean ms of new (and old) over rounds of old, new, new, old, and the
    spread (max - min over the mean) of each."""
    got = {"new": [], "old": []}
    for _ in range(rounds):
        for who in (("old", "new", "new", "old") if old else ("new",)):
            got[who].append((new if who == "new" else old)())
    out = {}
    for who, ms in got.items():
        if ms:
            mean = sum(ms) / len(ms)
            out[f"{who}_ms"] = mean
            out[f"{who}_spread"] = (max(ms) - min(ms)) / mean
    if got["old"]:
        out["new_over_old"] = out["new_ms"] / out["old_ms"]
    return out


def cycled(fn, ws):
    it = iter(range(10**9))
    return lambda: fn(ws[next(it) % len(ws)])


def check_part(rows, gen, dev):
    for affine in (False, True):
        for k, n in ((4096, 4096), (11008, 4096)):
            w = cs.rand_weight(torch, k, n, gen, dev, affine)
            for m in (1, 2, 3, 8, 9, 33, 64, 65, 128, 300, 513):
                x = torch.randn((m, k), generator=gen, device=dev)
                want, tol = plain_of(x, w)
                y = qm.q4_matmul(x, w, w_dtype=torch.float32)
                err = held(f"check K={k} N={n} M={m} affine={affine}", y,
                           want, tol)
                again = qm.q4_matmul(x, w, w_dtype=torch.float32)
                rows.emit(dict(part="check", shape=f"M={m} K={k} N={n}",
                               affine=affine, max_abs_err=err, tol=tol,
                               deterministic=bool(torch.equal(y, again))))


def decode_part(rows, gen, dev, old, rounds):
    planes = [(p, DECODE_ROWS) for p in cs.PLANES_7B] + [
        (p, DECODE_ROWS_13B) for p in cs.PLANES_13B]
    for affine in (False, True):
        key = "B9" if affine else "B1"
        fn = qm.q41_matmul_decode if affine else qm.q4_matmul_decode
        for (name, k, n), ms_rows in planes:
            w = cs.rand_weight(torch, k, n, gen, dev, affine)
            wbytes = cs.weight_bytes(w)
            ws = [w] + [cs.rand_weight(torch, k, n, gen, dev, affine)
                        for _ in range(copies_for(wbytes) - 1)]
            for m in ms_rows:
                x = torch.randn((m, k), generator=gen, device=dev)
                want, tol = plain_of(x, w)
                err = held(f"{key} {name} M={m}", fn(x, w, torch.float32),
                           want, tol)
                calls = 4 * len(ws)
                new = cycled(lambda ww: fn(x, ww, torch.float32), ws)
                oldf = None
                if old:
                    entry = old["q41_gemv" if affine else "q4_gemv"]
                    held(f"old {key} {name} M={m}", old_gemv(entry, x, w),
                         want, tol)
                    oldf = cycled(lambda ww: old_gemv(entry, x, ww), ws)
                row = dict(part="decode", kernel=key,
                           shape=f"{name} M={m} K={k} N={n} f32",
                           max_abs_err=err, tol=tol)
                row.update(turns(lambda: time_ms(new, calls=calls),
                                 oldf and (lambda: time_ms(oldf,
                                                           calls=calls)),
                                 rounds))
                row["bf16_mode_ms"] = time_ms(cycled(
                    lambda ww: fn(x, ww, torch.bfloat16), ws), calls=calls)
                row["vs_bf16_mode"] = row["new_ms"] / row["bf16_mode_ms"]
                row["library_ms"] = cs.f32_library_ms(torch, qm, x, w)
                row["vs_library"] = row["new_ms"] / row["library_ms"]
                row.update(cs.f32_bounds(wbytes + x.numel() * 4 + m * n * 4,
                                         2.0 * m * k * n))
                rows.emit(row)
            del ws, w


def route_part(rows, gen, dev, rounds):
    for affine in (False, True):
        def fold(x, w, w_dtype):
            return qv._launch_fold(x, w.qs, w.scales, 11 if affine else 10,
                                   w.n_logical, mins=w.mins)
        for name, k, n in cs.PLANES_7B[:4]:
            w = cs.rand_weight(torch, k, n, gen, dev, affine)
            wbytes = cs.weight_bytes(w)
            ws = [w] + [cs.rand_weight(torch, k, n, gen, dev, affine)
                        for _ in range(copies_for(wbytes) - 1)]
            for m in ROUTE_ROWS:
                x = torch.randn((m, k), generator=gen, device=dev)
                want, tol = plain_of(x, w)
                held(f"route fold {name} M={m}", fold(x, w, torch.float32),
                     want, tol)
                held(f"route B5 {name} M={m}", qm.q4_matmul_prefill(
                    x, w, torch.float32), want, tol)
                calls = 4 * len(ws)
                row = dict(part="route", shape=f"{name} M={m} K={k} N={n} "
                           f"f32 {'q4_1' if affine else 'q4_0'}")
                got = turns(lambda: time_ms(cycled(lambda ww: fold(
                    x, ww, torch.float32), ws), calls=calls),
                    lambda: time_ms(cycled(lambda ww: qm.q4_matmul_prefill(
                        x, ww, torch.float32), ws), calls=calls), rounds)
                row.update(fold_ms=got["new_ms"], b5_ms=got["old_ms"],
                           fold_over_b5=got["new_over_old"],
                           spreads=[got["new_spread"], got["old_spread"]])
                rows.emit(row)
            del ws, w


def plans_by_merge(m, n, kc, sms, candidates=MERGE_CANDIDATES):
    """{plan: [merge costs that pick it]} of prefill_plan(f32=True) at
    each candidate RA_MERGE_STAGES_F32 (the constant restored after)."""
    keep = qm.RA_MERGE_STAGES_F32
    out = {}
    try:
        for c in candidates:
            qm.RA_MERGE_STAGES_F32 = c
            qm.prefill_plan.cache_clear()
            out.setdefault(qm.prefill_plan(m, n, kc, sms, f32=True),
                           []).append(c)
    finally:
        qm.RA_MERGE_STAGES_F32 = keep
        qm.prefill_plan.cache_clear()
    return out


def merge_fit(shapes, candidates=MERGE_CANDIDATES):
    """shapes: one {candidate: ms of the plan it picks} a shape -> (the
    candidate of the least mean ratio to each shape's fastest plan,
    {candidate: mean ratio}); a tie goes to the smaller candidate."""
    mean = {c: sum(s[c] / min(s.values()) for s in shapes) / len(shapes)
            for c in candidates}
    return min(candidates, key=lambda c: (mean[c], c)), mean


def pins_part(rows, gen, dev):
    sms = cuda_lib.sm_count(dev)
    shapes = []
    for name, k, n in cs.PLANES_7B[:4] + cs.PLANES_13B:
        w = cs.rand_weight(torch, k, n, gen, dev)
        ws = [w] + [cs.rand_weight(torch, k, n, gen, dev)
                    for _ in range(copies_for(cs.weight_bytes(w)) - 1)]
        kc = -(-k // 32) * 32
        for m in PIN_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev)
            want, tol = plain_of(x, w)
            by_c = {}
            for plan, picked in plans_by_merge(m, w.qs.shape[1], kc,
                                               sms).items():
                held(f"pins {name} M={m} {tuple(plan)}",
                     qm.q4_matmul_prefill(x, w, torch.float32, plan=plan),
                     want, tol)
                ms = time_ms(cycled(lambda ww: qm.q4_matmul_prefill(
                    x, ww, torch.float32, plan=plan), ws), calls=len(ws))
                by_c.update({c: ms for c in picked})
                rows.emit(dict(part="pins", shape=f"{name} M={m} K={k} N={n} "
                               "f32 q4_0", plan=list(plan), ms=ms,
                               merge_costs=picked))
            shapes.append(by_c)
        del ws, w
    best, mean = merge_fit(shapes)
    rows.emit(dict(part="fit", merge_stages_f32=best,
                   in_use=qm.RA_MERGE_STAGES_F32,
                   mean_over_fastest={str(c): v for c, v in mean.items()}))


# One run of the f32 path in the current directory's tree: its own
# chip_smoke helpers and kernels (built there), one JSON line on stdout.
PATH_SNIPPET = r"""
import json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
from fastllama_tpu_torch.engine import scheduler as sched
from fastllama_tpu_torch.kernels import cuda_lib
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev)
gen.manual_seed(0)
cuda_lib.build()
hp = PRESETS["7B"]
params = cs.rand_params(torch, hp, gen, dev)
model, sess = cs.make_session(hp, params, dev, kv_dtype="float32",
                              weight_dtype="float32")
prompt = cs.prompt_of(298, seed=16)
cs.warm_up(sess, prompt)
ttft, tok = [], []
for _ in range(3):
    sess.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.ingest(prompt)
    sess.generate(lambda s: None, num_tokens=1, temp=0.0)
    t1 = time.perf_counter()
    sess.generate(lambda s: None, num_tokens=32, temp=0.0)
    t2 = time.perf_counter()
    ttft.append((t1 - t0) * 1e3)
    tok.append((t2 - t1) / 32 * 1e3)
window = cs.profile_prefill(torch, sess, prompt)
decode = cs.profile_decode(torch, sess, n_steps=8)
del sess, model
torch.cuda.empty_cache()
rcfg = RuntimeConfig(n_ctx=512, n_batch=512, kv_dtype="float32",
                     weight_dtype="float32")
vocab = cs.synthetic_vocab(hp.n_vocab)
steady = cs.engine_steady(torch, sched, lambda: sched.BatchEngine(
    hp, params, vocab, n_slots=8, n_ctx=512, rcfg=rcfg, sampling_seed=3,
    kv_mode="paged", page_size=64))
print("PATH " + json.dumps(dict(
    ttft_ms=float(np.median(ttft)), ttft_runs=ttft,
    ms_per_token=float(np.median(tok)), ms_per_token_runs=tok,
    window_device_ms=window.get("device_ms"),
    token_device_ms=decode.get("device_ms_per_token"),
    engine_ms_per_step=steady["ms_per_step"],
    engine_device_ms_per_step=steady.get("device_ms_per_step"),
    engine_launches_per_step=steady.get("launches_per_step"))))
"""


def path_run(tree):
    """One PATH_SNIPPET run from tree's root: its JSON result."""
    out = subprocess.run([sys.executable, "-c", PATH_SNIPPET], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    line = next((ln for ln in out.stdout.splitlines()
                 if ln.startswith("PATH ")), None)
    if out.returncode or line is None:
        raise SystemExit(f"f32_sweep: path run in {tree} failed:\n"
                         f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return json.loads(line[5:])


def paths_part(rows, old_tree):
    new_tree = str(Path(__file__).resolve().parents[1])
    for i, (who, tree) in enumerate((("old", old_tree), ("new", new_tree),
                                     ("new", new_tree), ("old", old_tree))):
        row = dict(part="paths", tree=who, turn=i)
        row.update(path_run(tree))
        rows.emit(row)


def prefill_part(rows, gen, dev, old, rounds):
    sms = cuda_lib.sm_count(dev)
    for name, k, n in cs.PLANES_7B[:4] + cs.PLANES_13B:
        for affine in (False, True):
            w = cs.rand_weight(torch, k, n, gen, dev, affine)
            wbytes = cs.weight_bytes(w)
            ws = [w] + [cs.rand_weight(torch, k, n, gen, dev, affine)
                        for _ in range(copies_for(wbytes) - 1)]
            for m in PREFILL_ROWS:
                x = torch.randn((m, k), generator=gen, device=dev)
                want, tol = plain_of(x, w)
                err = held(f"B5 {name} M={m}", qm.q4_matmul_prefill(
                    x, w, torch.float32), want, tol)
                calls = len(ws)
                new = cycled(lambda ww: qm.q4_matmul_prefill(
                    x, ww, torch.float32), ws)
                oldf = None
                if old:
                    entry = old["q4_prefill_gemm"]
                    held(f"old B5 {name} M={m}",
                         old_ffma_tile(entry, x, w, sms), want, tol)
                    oldf = cycled(lambda ww: old_ffma_tile(entry, x, ww, sms),
                                  ws)
                row = dict(part="prefill", kernel="B5",
                           shape=f"{name} M={m} K={k} N={n} f32 "
                                 f"{'q4_1' if affine else 'q4_0'}",
                           max_abs_err=err, tol=tol,
                           plan=list(qm.prefill_plan(m, w.qs.shape[1],
                                                     -(-k // 32) * 32, sms,
                                                     f32=True)))
                row.update(turns(lambda: time_ms(new, calls=calls),
                                 oldf and (lambda: time_ms(oldf,
                                                           calls=calls)),
                                 rounds))
                row["library_ms"] = cs.f32_library_ms(torch, qm, x, w)
                row["vs_library"] = row["new_ms"] / row["library_ms"]
                row.update(cs.f32_bounds(wbytes + x.numel() * 4 + m * n * 4,
                                         2.0 * m * k * n))
                rows.emit(row)
            del ws, w


PARTS = ("check", "decode", "route", "prefill", "pins", "paths")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default=",".join(PARTS[:4]))
    ap.add_argument("--old", default="")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/f32_sweep.jsonl")
    args = ap.parse_args(argv)
    bad = set(args.parts.split(",")) - set(PARTS)
    if bad:
        ap.error(f"unknown parts {sorted(bad)}: {', '.join(PARTS)}")
    if "paths" in args.parts.split(",") and not args.old:
        ap.error("paths needs --old")
    return args


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("f32_sweep: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cuda_lib.build()
    old = build_old(args.old) if args.old else None
    rows = Rows(args.out, card())
    parts = args.parts.split(",")
    if "check" in parts:
        check_part(rows, gen, dev)
    if "decode" in parts:
        decode_part(rows, gen, dev, old, args.rounds)
    if "route" in parts:
        route_part(rows, gen, dev, args.rounds)
    if "prefill" in parts:
        prefill_part(rows, gen, dev, old, args.rounds)
    if "pins" in parts:
        pins_part(rows, gen, dev)
    if "paths" in parts:
        paths_part(rows, args.old)
    return 0


if __name__ == "__main__":
    sys.exit(main())
