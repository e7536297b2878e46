"""The attached LoRA step on the card: the adapter glue's products and the
paths that run q/k/v LoRA terms, against an earlier tree in turns.

    python3 tools_torch/lora_step.py [--parts dot,paths,dense] [--old DIR]
                                     [--rounds R] [--out FILE]

dot      (this tree, in process) one adapter term at 7B width (K = N =
         4096): a cached delta (bf16 [4096, 4096]) and an A/B pair of rank 8,
         at M = 1 and 8, through three forms of the JAX apply_lora's
         function, each timed (utils.trace.time_ms: CUDA events around a
         CUDA graph of many calls) beside its byte bound and held against
         the f64 product: "cast", both operands cast to f32 on every call
         (the stored one too); "f32_copy", the stored operand cast to f32
         once and x rounded, then cast, every call; "port", models.llama.
         _dot as it stands (on the card a bf16 product with an f32 output,
         torch.mm(out_dtype=)). Also an f32 delta in f32 mode: _dot (pinned
         to IEEE f32) against the same product under TF32 ("high").
paths    (needs --old) in subprocesses, each tree's own package and
         chip_smoke.py helpers: the 7B q4_1 session (32 layers, a 300-token
         prompt, 64 greedy tokens) detached, then with a rank-8 A/B adapter
         on wq and wv of every layer attached; a 4-layer 7B-width q4_1
         session with a cached bf16 delta on wq and wv of every layer; the
         2-layer 7B-width paged engine (8 slots) without and with q/k/v
         LoRA terms (rank 8 on wq and wv) and the same 2-layer LoRA engine
         at n_ctx 32768 (past the paged gate). Each: host ms a token or a
         step, device ms from a torch.profiler trace, launches a replay or
         a step, the device's idle share. Trees in turns: old, new, new,
         old, R rounds.
dense    (needs --old) in subprocesses as paths: _dot's other callers, the
         dense 16-bit matmul weights (a GGJT f16 file loads so): a 2-layer
         7B-width model whose matmul weights and head are dense f16 (the
         q4_0 weights of chip_smoke.rand_params, dequantized), its prefill
         and first decode logits on the card against the same weights on
         the CPU (chip_smoke.card_vs_cpu), and its session's ms a token
         (300-token prompt, 64 greedy tokens), device ms and idle share.

--old DIR is a `git archive` of an earlier commit unpacked into a directory
of the repo that .gitignore lists. Every number is printed with the card's
name and power limit; --out writes them all as JSON.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="dot,paths")
    ap.add_argument("--old", default=None,
                    help="an earlier tree (git archive) for --parts paths")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--one-tree", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.parts = [p for p in args.parts.split(",") if p]
    if ({"paths", "dense"} & set(args.parts) and not args.old
            and not args.one_tree):
        ap.error("paths and dense need --old")
    return args


# ---------------------------------------------------------------------------
# dot: one term's product
# ---------------------------------------------------------------------------

def cast_form(x, t):
    """Both operands to f32 on every call."""
    import torch
    f32 = torch.float32

    def dot(x, w):
        return x.to(w.dtype).to(f32) @ w.to(f32)
    if t.delta is not None:
        return dot(x, t.delta)
    return dot(dot(x, t.a), t.b)


def f32_copy_form(x, t, dtype):
    """The stored operands held in f32 (made once); x rounded to the
    adapter's dtype, then cast, every call."""
    import torch
    f32 = torch.float32

    def dot(x, w):
        return x.to(dtype).to(f32) @ w
    if t.delta is not None:
        return dot(x, t.delta)
    return dot(dot(x, t.a), t.b)


def exact(x, t):
    """The f64 product of x rounded to the term's dtype (and of xa rounded
    to b's), and the scale |x| @ |w| its error is judged against."""
    import torch
    f64 = torch.float64
    if t.delta is not None:
        xr = x.to(t.delta.dtype).to(f64)
        w = t.delta.to(f64)
        return xr @ w, (xr.abs() @ w.abs()).max().item()
    xr = x.to(t.a.dtype).to(f64)
    xa = (xr @ t.a.to(f64)).to(torch.float32).to(t.b.dtype).to(f64)
    return (xa @ t.b.to(f64),
            (xa.abs() @ t.b.to(f64).abs()).max().item())


def dot_part(dev, rows):
    import torch
    from fastllama_tpu_torch.models import llama as tl
    from fastllama_tpu_torch.utils.trace import time_ms
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    k = n = 4096
    bf16 = torch.bfloat16
    try:
        torch.mm(torch.zeros((1, 8), dtype=bf16, device=dev),
                 torch.zeros((8, 8), dtype=bf16, device=dev),
                 out_dtype=torch.float32)
        rows.append(dict(part="dot", check="torch.mm(out_dtype=f32) on bf16",
                         available=True))
    except (TypeError, RuntimeError) as e:
        rows.append(dict(part="dot", check="torch.mm(out_dtype=f32) on bf16",
                         available=False, error=str(e)[:200]))
        print(json.dumps(rows[-1]), flush=True)
        return
    for form in ("delta", "ab"):
        if form == "delta":
            t = tl.LoraTerm(delta=(torch.randn((k, n), generator=g, device=dev)
                                   * 0.02).to(bf16))
            stored = k * n * 2
        else:
            t = tl.LoraTerm(
                a=(torch.randn((k, 8), generator=g, device=dev) * 0.02)
                .to(bf16),
                b=(torch.randn((8, n), generator=g, device=dev) * 0.02)
                .to(bf16))
            stored = (k * 8 + 8 * n) * 2
        t32 = tl.LoraTerm(**{f: (None if v is None else v.float())
                             for f, v in vars(t).items()})
        for m in (1, 8):
            x = torch.randn((m, 1, k), generator=g, device=dev)
            want, scale = exact(x, t)
            row = dict(part="dot", form=form, m=m, k=k, n=n,
                       bound_ms=(stored + m * (k + n) * 4)
                       / HBM_BYTES_PER_S * 1e3)
            for name, fn in (("cast", lambda: cast_form(x, t)),
                             ("f32_copy", lambda: f32_copy_form(x, t32, bf16)),
                             ("port", lambda: tl.apply_lora(x, t))):
                y = fn()
                row[name + "_err"] = ((y.double() - want).abs().max().item()
                                      / scale)
                row[name + "_ms"] = time_ms(fn, calls=32)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tl.apply_lora(x, t)
            torch.cuda.synchronize()
            row["port_peak_bytes"] = torch.cuda.max_memory_allocated() - base
            rows.append(row)
            print(json.dumps(row), flush=True)
    # f32 mode: an f32 delta, _dot pinned against the TF32 product
    w = torch.randn((k, n), generator=g, device=dev) * 0.02
    for m in (1, 8):
        x = torch.randn((m, 1, k), generator=g, device=dev)
        want = x.double() @ w.double()
        scale = (x.abs() @ w.abs()).max().item()
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            pinned = tl._dot(x, w)
            tf32 = x @ w
            row = dict(part="dot", form="f32 delta under 'high'", m=m,
                       pinned_err=(pinned.double() - want).abs().max().item()
                       / scale,
                       tf32_err=(tf32.double() - want).abs().max().item()
                       / scale,
                       pinned_ms=time_ms(lambda: tl._dot(x, w), calls=32),
                       tf32_ms=time_ms(lambda: x @ w, calls=32))
        finally:
            torch.set_float32_matmul_precision(prev)
        row["pinned_ms_highest"] = time_ms(lambda: tl._dot(x, w), calls=32)
        rows.append(row)
        print(json.dumps(row), flush=True)


# ---------------------------------------------------------------------------
# paths: one tree's sessions and engines (a subprocess)
# ---------------------------------------------------------------------------

def session_row(torch, cs, sess, model, label):
    """The counted run's host numbers, then a profile of 8 more tokens."""
    first = cs.timed_run(torch, sess, cs.prompt_of(cs.N_PROMPT - 2, seed=1))
    runs = [first] + [cs.timed_run(torch, sess, cs.prompt_of(
        cs.N_PROMPT - 2, seed=1)) for _ in range(2)]
    ms = sorted(r[1] / cs.N_DECODE * 1e3 for r in runs)
    prof = cs.profile_decode(torch, sess, n_steps=8)
    busy = prof.get("device_ms_per_token")
    return dict(label=label, ms_per_token=ms[1], ms_per_token_runs=ms,
                device_ms_per_token=busy,
                idle_share=None if busy is None else 1.0 - busy / ms[1],
                launches_per_replay=model._graphs.last.launches_per_replay(),
                kernels=prof.get("kernels"), logits=first[3])


def sessions(torch, cs, dev, gen, tmp):
    import dataclasses
    import numpy as np
    from fastllama_tpu_torch.config import PRESETS
    from fastllama_tpu_torch.io.ggml_writer import write_ggla
    out = {}
    hp = PRESETS["7B"]
    params = cs.rand_params(torch, hp, gen, dev, affine=True)
    model, sess = cs.make_session(hp, params, dev)
    cs.warm_up(sess, cs.prompt_of(cs.N_PROMPT - 2, seed=1))
    rng = np.random.default_rng(5)
    adapter = os.path.join(tmp, "ab.bin")
    write_ggla(adapter, r=8, alpha=16, use_cache=False, tensors={
        f"layers.{i}.attention.{w}.weight.lora{ab}":
            (rng.standard_normal((hp.n_embd, 8)) * 0.02).astype(np.float32)
        for i in range(hp.n_layer) for w in ("wq", "wv") for ab in "AB"})
    out["detached"] = session_row(torch, cs, sess, model, "detached")
    cs.require(model.attach_lora(adapter), "attach_lora failed")
    out["attached"] = session_row(torch, cs, sess, model, "attached A/B r8")
    cs.require(model.detach_lora(), "detach_lora failed")
    after = session_row(torch, cs, sess, model, "detached again")
    out["detach_bit_identical"] = bool(np.array_equal(
        after["logits"], out["detached"]["logits"]))
    del sess, model, params
    torch.cuda.empty_cache()
    # the cached-delta form at 7B width on a few layers
    hp4 = dataclasses.replace(hp, n_layer=4)
    params = cs.rand_params(torch, hp4, gen, dev, affine=True)
    model, sess = cs.make_session(hp4, params, dev)
    cs.warm_up(sess, cs.prompt_of(cs.N_PROMPT - 2, seed=1))
    adapter = os.path.join(tmp, "delta.bin")
    write_ggla(adapter, r=8, alpha=16, use_cache=True, tensors={
        f"layers.{i}.attention.{w}.weight.lora":
            (rng.standard_normal((hp.n_embd, hp.n_embd)) * 0.001)
            .astype(np.float32)
        for i in range(hp4.n_layer) for w in ("wq", "wv")})
    out["delta_4_layers_detached"] = session_row(torch, cs, sess, model,
                                                 "4 layers detached")
    cs.require(model.attach_lora(adapter), "attach_lora (delta) failed")
    out["delta_4_layers_attached"] = session_row(
        torch, cs, sess, model, "4 layers, cached delta on wq, wv")
    del sess, model, params
    torch.cuda.empty_cache()
    for row in out.values():
        if isinstance(row, dict):
            row.pop("logits", None)
    return out


def engines(torch, cs, dev, gen):
    import dataclasses
    from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
    from fastllama_tpu_torch.engine import scheduler as sched
    from fastllama_tpu_torch.models.llama import LoraTerm
    hp2 = dataclasses.replace(PRESETS["7B"], n_layer=2)
    vocab = cs.synthetic_vocab(hp2.n_vocab)
    params = cs.rand_params(torch, hp2, gen, dev)

    def make(n_ctx, total_pages=0):
        rcfg = RuntimeConfig(n_ctx=n_ctx, n_batch=512, kv_dtype="bfloat16",
                             weight_dtype="bfloat16")
        return lambda: sched.BatchEngine(
            hp2, params, vocab, n_slots=cs.ENG_SLOTS, n_ctx=n_ctx,
            rcfg=rcfg, sampling_seed=3, kv_mode="paged", page_size=cs.ENG_PS,
            total_pages=total_pages)

    def steady(label, maker):
        counts = cs.every_kernel()
        for fn in counts.values():
            fn.launches = 0
        row = cs.engine_steady(torch, sched, maker)
        row["counted"] = {k: fn.launches for k, fn in counts.items()
                          if fn.launches}
        row["label"] = label
        return row
    out = {"paged_2_layers": steady("2 layers", make(cs.ENG_CTX))}
    for layer in params.layers:
        for field in ("lora_wq", "lora_wv"):
            setattr(layer, field, LoraTerm(
                a=torch.randn((hp2.n_embd, 8), generator=gen, device=dev)
                * 0.02,
                b=torch.randn((8, hp2.n_embd), generator=gen, device=dev)
                * 0.02))
    out["paged_lora_2_layers"] = steady("2 layers, q/k/v LoRA",
                                        make(cs.ENG_CTX))
    out["long_lora_2_layers"] = steady(
        "2 layers, q/k/v LoRA, n_ctx 32768",
        make(cs.LONG_CTX, cs.LONG_PAGES))
    del params
    torch.cuda.empty_cache()
    return out


def dense(torch, cs, dev, gen):
    """The dense f16 model's card-against-CPU errors and session row."""
    import dataclasses
    from fastllama_tpu_torch.config import PRESETS, RuntimeConfig
    from fastllama_tpu_torch.models.runtime import LlamaModel
    from fastllama_tpu_torch.parallel.sharding import params_to
    from fastllama_tpu_torch.quant.tensor import dequant_matmul_weight
    hp = dataclasses.replace(PRESETS["7B"], n_layer=2)
    params = cs.rand_params(torch, hp, gen, dev)

    def f16(w, k):
        # the stored weight's K rows are padded past w2's logical n_ff
        return dequant_matmul_weight(w, torch.float16)[:k, :w.n] \
            .contiguous()
    params.output = f16(params.output, hp.n_embd)
    for layer in params.layers:
        for field in ("wqkv", "wo", "w13", "w2"):
            k = hp.n_ff if field == "w2" else hp.n_embd
            setattr(layer, field, f16(getattr(layer, field), k))
    vocab = cs.synthetic_vocab(hp.n_vocab)
    rcfg = RuntimeConfig(n_ctx=512, n_batch=64, kv_dtype="bfloat16",
                         weight_dtype="bfloat16")
    errs = cs.card_vs_cpu(
        LlamaModel(hp, params, vocab, rcfg, device=dev),
        LlamaModel(hp, params_to(params, torch.device("cpu")), vocab, rcfg,
                   device="cpu"))
    model, sess = cs.make_session(hp, params, dev)
    cs.warm_up(sess, cs.prompt_of(cs.N_PROMPT - 2, seed=1))
    row = session_row(torch, cs, sess, model, "2 layers, dense f16")
    row.pop("logits", None)
    del sess, model, params
    torch.cuda.empty_cache()
    return dict(rel_err_prefill=errs[0], rel_err_decode=errs[1], **row)


def one_tree(parts):
    """Run in a subprocess whose sys.path starts with the tree to measure:
    its package and its chip_smoke.py helpers."""
    import torch
    import chip_smoke as cs
    from fastllama_tpu_torch.kernels import cuda_lib
    cuda_lib.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tmp = tempfile.mkdtemp(prefix="lora_step_")
    out = {}
    try:
        if "paths" in parts:
            out.update(sessions=sessions(torch, cs, dev, gen, tmp),
                       engines=engines(torch, cs, dev, gen))
        if "dense" in parts:
            out["dense"] = dense(torch, cs, dev, gen)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    print("LORA_STEP " + json.dumps(out), flush=True)


def tree_run(tree, parts):
    """One tree's parts in a subprocess: this script with --one-tree, which
    puts the tree first on sys.path (its package, its chip_smoke.py)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--one-tree",
         str(tree), "--parts", ",".join(parts)], cwd=tree,
        capture_output=True, text=True, timeout=1500)
    line = next((ln for ln in res.stdout.splitlines()
                 if ln.startswith("LORA_STEP ")), None)
    if res.returncode or line is None:
        raise RuntimeError(f"{tree}: rc {res.returncode}\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    out = json.loads(line[len("LORA_STEP "):])
    out["wall_s"] = time.perf_counter() - t0
    return out


def brief(run):
    if "sessions" not in run:
        return {k: v for k, v in run.get("dense", {}).items()
                if k != "kernels"}
    s, e = run["sessions"], run["engines"]
    pick = ("ms_per_token", "device_ms_per_token", "idle_share")
    return dict(
        **{f"{k} {p}": s[k][p] for k in ("detached", "attached",
                                          "delta_4_layers_detached",
                                          "delta_4_layers_attached")
           for p in pick},
        attached_replay=s["attached"]["launches_per_replay"],
        detach_bit_identical=s["detach_bit_identical"],
        **{f"{k} {p}": e[k].get(p) for k in e
           for p in ("ms_per_step", "device_ms_per_step",
                     "launches_per_step")},
        **{f"{k} counted": e[k]["counted"] for k in e})


def paths_part(args, rows, parts):
    old, new = Path(args.old).resolve(), ROOT
    for rnd in range(args.rounds):
        for label, tree in (("old", old), ("new", new), ("new", new),
                            ("old", old)):
            run = tree_run(tree, parts)
            row = dict(part=",".join(parts), tree=label, round=rnd, **run)
            rows.append(row)
            print(f"{row['part']} {label} round {rnd}: "
                  + json.dumps(brief(run)), flush=True)


def main(argv=None):
    args = parse_args(argv)
    if args.one_tree:
        sys.path.insert(0, str(Path(args.one_tree).resolve()))
        one_tree(args.parts)
        return 0
    sys.path.insert(0, str(ROOT))
    import torch
    from tools_torch._trace_util import card_line
    if not torch.cuda.is_available():
        print("lora_step: needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    rows = []
    if "dot" in args.parts:
        from fastllama_tpu_torch.kernels import cuda_lib
        cuda_lib.build()
        dot_part(torch.device("cuda", 0), rows)
    tree_parts = [p for p in args.parts if p in ("paths", "dense")]
    if tree_parts:
        paths_part(args, rows, tree_parts)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=card, torch=torch.__version__, rows=rows), fh,
                      indent=1)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
