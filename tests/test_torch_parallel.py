"""PyTorch port, multi-GPU serving (parallel/) without a spawned world: the
per-rank shard_params planes against the addressable shards of the JAX
package's NamedSharding on its virtual CPU mesh (bit for bit, tp 2, 4, 8,
q4_0 and q4_1, with and without LoRA, and a re-shard after an attach), the
7B planes a rank holds, the fused-column order, the dp page partitions
against the JAX manager, multihost's launch helpers, and the refusal of a
mesh without a process group. The spawned worlds are in
test_torch_parallel_worlds.py and test_torch_parallel_engine.py."""
import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import torch.distributed as dist

from fastllama_tpu.config import HyperParams
from fastllama_tpu.engine.paged_kv import PagedKVManager as JaxPager
from fastllama_tpu.models import llama as jl
from fastllama_tpu.models.fuse import make_layer_params
from fastllama_tpu.models.fuse import shard_col_order as jax_col_order
from fastllama_tpu.parallel.sharding import make_mesh as jax_mesh
from fastllama_tpu.parallel.sharding import shard_params as jax_shard
from fastllama_tpu.quant.q4 import quantize_q4_0
from fastllama_tpu.quant.tensor import (
    QuantMatmulWeight as JaxQW, make_embedding, make_matmul_weight,
    make_matmul_weight_q41,
)
from fastllama_tpu_torch.config import RuntimeConfig
from fastllama_tpu_torch.engine.paged_kv import PagedKVManager
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.models.fuse import shard_col_order
from fastllama_tpu_torch.parallel import multihost
from fastllama_tpu_torch.parallel.sharding import K_MULTIPLE, shard_params
from fastllama_tpu_torch.quant.tensor import QuantMatmulWeight, good_pad_k

from _torch_world import free_port
from test_sharding import HP, N_FF

torch.set_num_threads(1)


@pytest.mark.parametrize("n_total,n_parts,tp", [
    (768, 3, 2), (768, 3, 8), (512, 2, 4), (12288, 3, 4), (22016, 2, 2)])
def test_shard_col_order_matches_jax(n_total, n_parts, tp):
    np.testing.assert_array_equal(shard_col_order(n_total, n_parts, tp),
                                  jax_col_order(n_total, n_parts, tp))


# ---------------------------------------------------------------------------
# per-rank planes against the JAX shards
# ---------------------------------------------------------------------------

def _q41(rng, n, k):
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.15
    blocks = w.reshape(n, k // 32, 32)
    lo, hi = blocks.min(-1), blocks.max(-1)
    d = np.maximum(hi - lo, 1e-6) / 15.0
    codes = np.clip(np.round((blocks - lo[..., None]) / d[..., None]), 0, 15)
    return codes.reshape(n, k).astype(np.uint8), d, lo


def jax_params(affine: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    d = HP.n_embd

    def spec(k, n):
        if affine:
            return ("q41",) + _q41(rng, n, k)
        return ("q4",) + quantize_q4_0(
            (rng.standard_normal((n, k)) * 0.15).astype(np.float32))

    layers = [make_layer_params(
        HP.n_head, attention_norm=np.ones(d, np.float32),
        ffn_norm=np.ones(d, np.float32), wq=spec(d, d), wk=spec(d, d),
        wv=spec(d, d), wo=spec(d, d), w1=spec(d, N_FF), w2=spec(N_FF, d),
        w3=spec(d, N_FF)) for _ in range(HP.n_layer)]
    emb = (rng.standard_normal((HP.n_vocab, d)) * 0.4).astype(np.float32)
    out = (make_matmul_weight_q41(*_q41(rng, HP.n_vocab, d)) if affine else
           make_matmul_weight(*quantize_q4_0(
               (rng.standard_normal((HP.n_vocab, d)) * 0.15)
               .astype(np.float32))))
    return jl.LlamaParams(tok_embeddings=make_embedding(*quantize_q4_0(emb)),
                          norm=jnp.ones(d), output=out, layers=layers)


LORA_KINDS = {"lora_wq": ("delta", HP.n_embd, HP.n_embd),
              "lora_wv": ("ab", HP.n_embd, HP.n_embd),
              "lora_wo": ("ab", HP.n_embd, HP.n_embd),
              "lora_w1": ("delta", HP.n_embd, N_FF),
              "lora_w2": ("delta", N_FF, HP.n_embd),
              "lora_w3": ("ab", HP.n_embd, N_FF)}


def lora_terms(seed=5):
    """{field: {"delta": [K, N]} or {"a": [K, 4], "b": [4, N]}} per layer,
    and the head's term."""
    rng = np.random.default_rng(seed)

    def term(kind, k, n):
        if kind == "delta":
            return {"delta": rng.standard_normal((k, n)).astype(np.float32)}
        return {"a": rng.standard_normal((k, 4)).astype(np.float32),
                "b": rng.standard_normal((4, n)).astype(np.float32)}
    layers = [{f: term(*v) for f, v in LORA_KINDS.items()}
              for _ in range(HP.n_layer)]
    return layers, term("ab", HP.n_embd, HP.n_vocab)


def attach(jp, tp_params, terms):
    """The same LoRA terms on the JAX and the port parameters."""
    layers, head = terms
    for jlay, tlay, lt in zip(jp.layers, tp_params.layers, layers):
        for f, t in lt.items():
            setattr(jlay, f, jl.LoraTerm(**{k: jnp.asarray(v)
                                            for k, v in t.items()}))
            setattr(tlay, f, tl.LoraTerm(**{k: torch.from_numpy(v.copy())
                                            for k, v in t.items()}))
    jp.lora_output = jl.LoraTerm(**{k: jnp.asarray(v) for k, v in head.items()})
    tp_params.lora_output = tl.LoraTerm(**{k: torch.from_numpy(v.copy())
                                           for k, v in head.items()})


def port_params(jp):
    def leaf(w):
        if isinstance(w, JaxQW):
            out = {"qs": np.asarray(w.qs), "scales": np.asarray(w.scales),
                   "n_logical": w.n_logical}
            if w.mins is not None:
                out["mins"] = np.asarray(w.mins)
            return out
        if hasattr(w, "qs"):
            return {"qs": np.asarray(w.qs), "scales": np.asarray(w.scales)}
        return np.asarray(w)
    tree = {"tok_embeddings": leaf(jp.tok_embeddings), "norm": leaf(jp.norm),
            "output": leaf(jp.output),
            "layers": [{f: leaf(getattr(lp, f)) for f in (
                "attention_norm", "wqkv", "wo", "ffn_norm", "w13", "w2")}
                for lp in jp.layers]}
    return tl.params_from_numpy(tree, device="cpu")


def jax_shard_of(arr, mesh, r):
    dev = mesh.devices[0, r]
    return np.asarray(next(s.data for s in arr.addressable_shards
                           if s.device == dev))


def assert_weight_is_shard(tw, jw, mesh, r, k_rows=None):
    """The port's plane = the JAX device's shard; a reduction-sharded
    weight may carry inert rows past the shard's K (K_MULTIPLE)."""
    if isinstance(tw, torch.Tensor):
        np.testing.assert_array_equal(tw.numpy(), jax_shard_of(jw, mesh, r))
        return
    assert tw.n_logical == jw.n_logical
    planes = [("qs", 2), ("scales", 32)] + (
        [("mins", 32)] if jw.mins is not None else [])
    for name, per in planes:
        want = jax_shard_of(getattr(jw, name), mesh, r)
        got = getattr(tw, name).numpy()
        assert got.shape[1] == want.shape[1] and got.flags.c_contiguous
        np.testing.assert_array_equal(got[:want.shape[0]], want)
        if got.shape[0] > want.shape[0]:                  # inert K rows
            assert got.shape[0] * per % K_MULTIPLE == 0
            fill = (0x00 if jw.mins is not None else 0x88) if name == "qs" \
                else 0
            assert (got[want.shape[0]:] == fill).all()


def assert_rank_params(tp_r, js, mesh, r):
    for tlay, jlay in zip(tp_r.layers, js.layers):
        for f in ("wqkv", "wo", "w13", "w2"):
            assert_weight_is_shard(getattr(tlay, f), getattr(jlay, f), mesh, r)
        for f in ("attention_norm", "ffn_norm"):
            np.testing.assert_array_equal(getattr(tlay, f).numpy(),
                                          np.asarray(getattr(jlay, f)))
        for f in LORA_KINDS:
            jt, tt = getattr(jlay, f), getattr(tlay, f)
            assert (jt is None) == (tt is None)
            for part in ("delta", "a", "b"):
                if jt is not None and getattr(jt, part) is not None:
                    assert_weight_is_shard(getattr(tt, part),
                                           getattr(jt, part), mesh, r)
    assert_weight_is_shard(tp_r.output, js.output, mesh, r)
    for name in ("qs", "scales"):
        np.testing.assert_array_equal(
            getattr(tp_r.tok_embeddings, name).numpy(),
            jax_shard_of(getattr(js.tok_embeddings, name), mesh, r))
    if js.lora_output is not None:
        assert_weight_is_shard(tp_r.lora_output.b, js.lora_output.b, mesh, r)
        np.testing.assert_array_equal(tp_r.lora_output.a.numpy(),
                                      np.asarray(js.lora_output.a))
    assert tp_r.tp_shard == (r, mesh.shape["model"])


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("affine", [False, True], ids=["q4_0", "q4_1"])
@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
def test_shard_params_planes_equal_jax_shards(tp, affine, lora):
    jp = jax_params(affine)
    tp_params = port_params(jp)
    if lora:
        attach(jp, tp_params, lora_terms())
    mesh = jax_mesh(1, tp)
    js = jax_shard(jp, mesh)
    for r in range(tp):
        assert_rank_params(shard_params(tp_params, r, tp), js, mesh, r)


@pytest.mark.parametrize("tp", [2, 8])
def test_reshard_after_attach_slices_only_the_new_terms(tp):
    """Sharded parameters with a LoRA adapter attached at its global widths
    (what LlamaModel.attach_lora does on a rank) re-shard to the JAX
    package's re-shard after an attach: the base weights are not permuted
    or sliced a second time, the terms take their base's split; a third
    call changes nothing."""
    jp = jax_params(False)
    tp_params = port_params(jp)
    mesh = jax_mesh(1, tp)
    js = jax_shard(jp, mesh)
    ranks = [shard_params(tp_params, r, tp) for r in range(tp)]
    terms = lora_terms()
    for r, tp_r in enumerate(ranks):
        attach(js, tp_r, terms)
        again = shard_params(tp_r, r, tp)
        if r == 0:
            js2 = jax_shard(js, mesh)
        assert_rank_params(again, js2, mesh, r)
        third = shard_params(again, r, tp)
        assert third.layers[0].lora_w1.delta is again.layers[0].lora_w1.delta
        assert third.layers[0].wqkv is again.layers[0].wqkv


def test_shard_params_refuses_another_rank_of_sharded_params():
    p = shard_params(port_params(jax_params(False)), 0, 2)
    with pytest.raises(ValueError):
        shard_params(p, 1, 2)


def _zero_weight(k, n):
    kp = good_pad_k(k)
    from fastllama_tpu_torch.quant.tensor import good_pad_n
    n_pad = good_pad_n(n)
    return QuantMatmulWeight(qs=torch.zeros((kp // 2, n_pad), dtype=torch.uint8),
                             scales=torch.zeros((kp // 32, n_pad)),
                             n_logical=n)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_7b_planes_a_rank_holds(tp):
    """The stored planes of a 7B layer and head on a rank (the shapes
    chip_smoke.py holds the kernels at): K padding stripped before the split
    (w2's 11264 stored rows -> 11008 / tp), N re-padded per shard, and at
    tp = 8 w2's 1376 rows padded to 1408 for B3's K multiple of 64."""
    d, f, v = 4096, 11008, 32000
    layer = tl.LayerParams(
        attention_norm=torch.ones(d), wqkv=_zero_weight(d, 3 * d),
        wo=_zero_weight(d, d), ffn_norm=torch.ones(d),
        w13=_zero_weight(d, 2 * f), w2=_zero_weight(f, d))
    from fastllama_tpu_torch.quant.tensor import QuantEmbedding
    params = tl.LlamaParams(
        tok_embeddings=QuantEmbedding(qs=torch.zeros((v, d // 2),
                                                     dtype=torch.uint8),
                                      scales=torch.zeros((v, d // 32))),
        norm=torch.ones(d), output=_zero_weight(d, v), layers=[layer])
    got = shard_params(params, tp - 1, tp)
    want = {2: [(4096, 6144), (2048, 4096), (4096, 11264), (5504, 4096),
                (4096, 16384)],
            4: [(4096, 3072), (1024, 4096), (4096, 5632), (2752, 4096),
                (4096, 8192)],
            8: [(4096, 1536), (512, 4096), (4096, 2816), (1408, 4096),
                (4096, 4096)]}[tp]
    lay = got.layers[0]
    ws = (lay.wqkv, lay.wo, lay.w13, lay.w2, got.output)
    assert [(w.k, w.qs.shape[1]) for w in ws] == want
    assert [w.n_logical for w in ws] == [3 * d // tp, d, 2 * f // tp, d,
                                         v // tp]
    assert got.tok_embeddings.qs.shape == (v // tp, d // 2)


# ---------------------------------------------------------------------------
# dp page partitions
# ---------------------------------------------------------------------------

def test_dp_page_partitions_match_jax_manager():
    """The same admissions, growths and frees on the port's manager
    (dp = 2, one group's pools on this rank) and the JAX manager: equal
    page tables, sentinels and free counts at every step."""
    hp = HyperParams(n_vocab=64, n_embd=64, n_head=4, n_layer=1, n_rot=16)
    kw = dict(n_slots=4, page_size=8, total_pages=10, pages_per_seq=4)
    jm = JaxPager(hp, dtype=jnp.float32, dp=2, **kw)
    tm = PagedKVManager(hp, dtype=torch.float32, device="cpu", dp=2, group=1,
                        tp=2, **kw)
    assert tm.sentinel == jm.sentinel == 5
    assert tm.k_pages[0].shape == (2, 6, 8, 16)
    for op, slot, n in [("alloc", 0, 9), ("alloc", 2, 20), ("alloc", 1, 17),
                        ("alloc", 3, 4), ("alloc", 0, 17), ("free", 2, 0),
                        ("alloc", 3, 30), ("alloc", 1, 33), ("free", 0, 0),
                        ("alloc", 0, 8)]:
        if op == "alloc":
            assert tm.alloc_for(slot, n) == jm.alloc_for(slot, n)
        else:
            tm.free_slot(slot)
            jm.free_slot(slot)
        np.testing.assert_array_equal(tm.page_tables, jm.page_tables)
        assert tm.free_pages == jm.free_pages
        assert tm.free_pages_by_group == [len(f) for f in jm._free]
        assert tm.group_of(slot) == jm.group_of(slot)


# ---------------------------------------------------------------------------
# multihost and the refusals
# ---------------------------------------------------------------------------

def test_initialize_raises_when_the_ranks_cannot_meet():
    """Two processes asked for, the other never comes: the rendezvous times
    out and initialize raises instead of going on single-process."""
    with pytest.raises(RuntimeError):
        multihost.initialize(f"127.0.0.1:{free_port()}", num_processes=2,
                             process_id=1, initialization_timeout=2,
                             backend="gloo")
    assert not dist.is_initialized()


def test_initialize_single_process_failure_warns(monkeypatch):
    """One process and no rendezvous to be found: a warning, no group."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        multihost.initialize(backend="gloo")
    assert any("continuing single-process" in str(w.message) for w in caught)
    assert not dist.is_initialized()


def test_initialize_raises_for_a_world_from_the_environment(monkeypatch):
    """WORLD_SIZE = 2 from the launcher (no num_processes): the other rank
    never comes and initialize raises, as for an explicit count."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError):
        multihost.initialize(initialization_timeout=2, backend="gloo")
    assert not dist.is_initialized()


@pytest.mark.parametrize("cuda,cards,local,world,want", [
    (True, 4, "4", 8, "nccl"),      # two nodes of four cards
    (True, 4, "8", 8, "gloo"),      # ranks share this node's cards
    (True, 2, None, 2, "nccl"),     # no LOCAL_WORLD_SIZE: the whole world
    (True, 1, None, 2, "gloo"),
    (False, 0, "2", 2, "gloo")])
def test_default_backend_counts_this_nodes_ranks(monkeypatch, cuda, cards,
                                                  local, world, want):
    """NCCL when each of this node's ranks (LOCAL_WORLD_SIZE) has a card,
    whatever the world's size; gloo on the CPU or where ranks share one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert multihost.default_backend(world) == want


def test_session_mesh_keeps_tensor_parallelism_inside_a_node(monkeypatch):
    """LlamaModel builds its mesh through hybrid_mesh, as BatchEngine does:
    a model axis wider than a node's ranks is refused."""
    from fastllama_tpu_torch.engine.tokenizer import Vocab
    from fastllama_tpu_torch.models.runtime import LlamaModel
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="inside one node"):
            LlamaModel(HP, port_params(jax_params(False)),
                       Vocab.from_tokens([(b"<unk>", 0.0)]),
                       RuntimeConfig(n_ctx=16, mesh_shape=(1, 2)),
                       device="cpu")
    finally:
        dist.destroy_process_group()


def test_owned_slots_partition_the_slots_node_major():
    assert multihost.owned_slots(8) == range(8)
    assert multihost.owned_slots(8, n_nodes=1) == range(8)
    parts = [multihost.owned_slots(8, n_nodes=4, node=i) for i in range(4)]
    assert [list(p) for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_mesh_without_a_process_group_raises(tmp_path):
    """Model, LlamaModel and BatchEngine with a mesh and no initialized
    process group raise; nothing runs one device in its place."""
    from fastllama_tpu_torch import Model
    from fastllama_tpu_torch.engine.scheduler import BatchEngine
    from fastllama_tpu_torch.engine.tokenizer import Vocab
    from fastllama_tpu_torch.models.runtime import LlamaModel
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        Model(str(tmp_path / "absent.bin"), mesh_shape=(1, 2), device="cpu")
    params = port_params(jax_params(False))
    vocab = Vocab.from_tokens([(b"<unk>", 0.0), (b"<s>", 0.0),
                               (b"</s>", 0.0)])
    rcfg = RuntimeConfig(n_ctx=16, kv_dtype="float32",
                         weight_dtype="float32", mesh_shape=(1, 2))
    with pytest.raises(RuntimeError, match="process group"):
        LlamaModel(HP, params, vocab, rcfg, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        BatchEngine(HP, params, vocab, n_slots=2, n_ctx=16, rcfg=rcfg,
                    device="cpu")


def test_session_refuses_data_parallelism():
    from fastllama_tpu_torch.engine.tokenizer import Vocab
    from fastllama_tpu_torch.models.runtime import LlamaModel
    rcfg = RuntimeConfig(n_ctx=16, mesh_shape=(2, 1))
    with pytest.raises(ValueError, match="data-parallel"):
        LlamaModel(HP, port_params(jax_params(False)),
                   Vocab.from_tokens([(b"<unk>", 0.0)]), rcfg, device="cpu")
