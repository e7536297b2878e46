"""Spawned torch.distributed worlds for the port's parallel tests.

run_world(n, fn, *args) starts n processes (torch.multiprocessing, spawn),
joins them into one gloo world (a file rendezvous in a fresh temporary
directory, so no port is picked and released before the ranks bind it),
calls fn(rank, *args) in each and returns the ranks' results in rank
order. A rank that raises fails the call with its traceback. This module and the case functions below import
the port only (never JAX), so a rank starts in seconds; the tests compare
what they return with the JAX package in the test process.
"""
from __future__ import annotations

import os
import shutil
import socket
import tempfile
import traceback

import numpy as np


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, n, rdzv, fn, args, q):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                                rank=rank, world_size=n)
        q.put((rank, fn(rank, *args), None))
    except BaseException:                       # noqa: BLE001 - reported
        q.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(n: int, fn, *args, timeout: float = 240.0) -> list:
    import queue
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="torch_world_")
    rdzv = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_entry, args=(r, n, rdzv, fn, args, q),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    out, errs = [None] * n, []
    try:
        for _ in range(n):
            rank, res, err = q.get(timeout=timeout)
            out[rank] = res
            if err:
                errs.append(f"rank {rank}:\n{err}")
                break
    except queue.Empty:
        errs.append(f"a rank gave no result within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=5 if not errs else 0.1)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    if errs:
        raise RuntimeError("\n".join(errs))
    return out


# ---------------------------------------------------------------------------
# what a rank runs (port only)
# ---------------------------------------------------------------------------

def _params(tree):
    from fastllama_tpu_torch.models.llama import params_from_numpy
    return params_from_numpy(tree, device="cpu")


def _tp_forward(rank, dp, tp, tree, hp, tokens, decode_tokens):
    """The sharded forward of (dp, tp): this rank's data rows, prefill with
    all logits then one decode step per decode_tokens column. Returns
    (data index, model index, [prefill logits, step logits...])."""
    import torch
    from fastllama_tpu_torch.models import llama as tl
    from fastllama_tpu_torch.parallel.sharding import (
        make_mesh, mesh_coords, shard_kv, shard_params,
    )
    mesh = make_mesh(dp, tp)
    di, mi = mesh_coords(mesh)
    params = shard_params(_params(tree), mi, tp)
    cfg = tl.ForwardConfig(n_head=hp.n_head // tp, n_rot=hp.n_rot,
                           w_dtype="float32", all_logits=True,
                           tp_group=mesh["model"].get_group()
                           if tp > 1 else None)
    b, t = tokens.shape
    rows = slice(di * b // dp, (di + 1) * b // dp)
    kv = shard_kv(tl.init_kv_cache(hp, b, 16, torch.float32, "cpu"),
                  (di, dp), (mi, tp))
    outs = []
    with torch.inference_mode():
        logits, kv, _ = tl.forward(params, torch.from_numpy(tokens[rows]), 0,
                                   kv, cfg, t - 1)
        outs.append(logits.numpy())
        for i in range(decode_tokens.shape[1]):
            step = torch.from_numpy(decode_tokens[rows, i:i + 1])
            logits, kv, _ = tl.forward(params, step, t + i, kv, cfg, 0)
            outs.append(logits.numpy())
    return di, mi, outs


def _sp_forward(rank, sp, tp, tree, hp, tokens, chunk, decode_tokens):
    """Sequence-parallel forward on (sp, tp): a fresh prefill of `tokens`
    (each rank its T chunk), then the same tokens ingested in `chunk`-wide
    windows (the ring seeded with the cache prefix) and decode steps.
    Returns the logits on this rank: fresh [B, T, V], chunked [B, T, V],
    steps [n, B, 1, V]."""
    import dataclasses
    import torch
    from fastllama_tpu_torch.models import llama as tl
    from fastllama_tpu_torch.parallel.sharding import (
        make_mesh, mesh_coords, shard_kv_seq, shard_params,
    )
    mesh = make_mesh(sp, tp)
    si, mi = mesh_coords(mesh)
    params = shard_params(_params(tree), mi, tp)
    base = tl.ForwardConfig(
        n_head=hp.n_head // tp, n_rot=hp.n_rot, w_dtype="float32",
        all_logits=True, tp_group=mesh["model"].get_group() if tp > 1
        else None, sp_group=mesh["data"].get_group(), sp_size=sp)
    b, t = tokens.shape
    s = 2 * t

    def fresh_kv():
        return shard_kv_seq(tl.init_kv_cache(hp, b, s, torch.float32, "cpu"),
                            (si, sp), (mi, tp))

    def mine(x):
        tl_ = x.shape[1] // sp
        return torch.from_numpy(x[:, si * tl_:(si + 1) * tl_])

    with torch.inference_mode():
        fresh, _, _ = tl.forward(params, mine(tokens), 0, fresh_kv(), base,
                                 t - 1)
        cfg = dataclasses.replace(base, sp_chunked=True)
        kv = fresh_kv()
        parts = []
        for c0 in range(0, t, chunk):
            out, kv, _ = tl.forward(params, mine(tokens[:, c0:c0 + chunk]),
                                    c0, kv, cfg, chunk - 1)
            parts.append(out.numpy())
        steps = []
        for i in range(decode_tokens.shape[1]):
            out, kv, _ = tl.forward(
                params, torch.from_numpy(decode_tokens[:, i:i + 1]), t + i,
                kv, cfg, 0)
            steps.append(out.numpy())
    return fresh.numpy(), np.concatenate(parts, axis=1), np.stack(steps)


def _session(rank, mesh_shape, seq_parallel, tree, hp, vocab_tokens, prompt,
             n_gen, lora_path, state_path):
    """A FastLlama session over the mesh: ingest, greedy generate, save;
    then the LoRA adapter attached (logits and a greedy continuation) and
    detached (logits). Returns what a test compares."""
    from fastllama_tpu_torch.config import RuntimeConfig
    from fastllama_tpu_torch.engine.session import FastLlama
    from fastllama_tpu_torch.engine.tokenizer import Vocab
    from fastllama_tpu_torch.models.runtime import LlamaModel
    rcfg = RuntimeConfig(n_ctx=64, n_batch=8, kv_dtype="float32",
                         weight_dtype="float32",
                         prefill_buckets=(8, 16, 32, 64),
                         mesh_shape=mesh_shape, seq_parallel=seq_parallel)
    model = LlamaModel(hp, _params(tree), Vocab.from_tokens(vocab_tokens),
                       rcfg, device="cpu")
    sess = FastLlama(model, n_keep=8, seed=3)
    assert sess.ingest(prompt)
    toks: list[str] = []
    assert sess.generate(toks.append, num_tokens=n_gen, temp=0.0)
    res = dict(stream=toks, logits=sess.get_logits().copy())
    assert sess.save_state(state_path)
    if lora_path:
        probe = [1, 300, 301, 302]
        before = model.eval(0, probe)
        assert model.attach_lora(lora_path)
        res["attached"] = model.eval(0, probe)
        assert model.detach_lora()
        res["detached_equal"] = bool(np.array_equal(model.eval(0, probe),
                                                    before))
    return res


def _engine(rank, mesh_shape, kv_mode, tree, hp, vocab_tokens, prompts,
            engine_kw):
    """The port's BatchEngine over the mesh, greedy: returns the texts and
    the free pages (by dp group) after the run."""
    from fastllama_tpu_torch.config import RuntimeConfig
    from fastllama_tpu_torch.engine.scheduler import BatchEngine, Request
    from fastllama_tpu_torch.engine.tokenizer import Vocab
    rcfg = RuntimeConfig(kv_dtype="float32", weight_dtype="float32",
                         prefill_buckets=(8, 16, 32), mesh_shape=mesh_shape)
    eng = BatchEngine(hp, _params(tree), Vocab.from_tokens(vocab_tokens),
                      rcfg=rcfg, temp=0.0, kv_mode=kv_mode, device="cpu",
                      **engine_kw)
    reqs = [Request(prompt=p, max_tokens=4) for p in prompts]
    eng.run(reqs)
    pages = (None if eng.pager is None else
             (eng.pager.free_pages_by_group, eng.pager.total_pages))
    return [r.text for r in reqs], pages


def _layout(rank, dp, tp):
    """hybrid_mesh(dp, tp) in this world: the rank grid, this rank's
    (data, model) coordinates and its groups' ranks; and whether a tp that
    does not divide a node's ranks is refused (LOCAL_WORLD_SIZE = 1)."""
    import os
    import torch.distributed as dist
    from fastllama_tpu_torch.parallel.multihost import hybrid_mesh
    from fastllama_tpu_torch.parallel.sharding import mesh_coords
    mesh = hybrid_mesh(dp, tp)
    groups = [dist.get_process_group_ranks(mesh[a].get_group())
              for a in ("data", "model")]
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        hybrid_mesh(dp, tp)
        refused = False
    except ValueError:
        refused = True
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return mesh.mesh.tolist(), mesh_coords(mesh), groups, refused


def world_cases(rank, cases):
    """Run each (name, fn, args) case in this world; returns {name: result}."""
    fns = {"tp_forward": _tp_forward, "sp_forward": _sp_forward,
           "session": _session, "engine": _engine, "layout": _layout}
    return {name: fns[kind](rank, *args) for name, kind, args in cases}
