"""PyTorch port, multi-GPU serving: the continuous-batching engine over a
(dp, tp) mesh of spawned gloo ranks on the CPU, slab and paged, at (1, 2),
(2, 1) and (2, 2): greedy streams equal to the JAX package's mesh engine on
its virtual CPU mesh, and every page back in its dp partition after the run
(sampled streams are not compared across frameworks: the generators
differ). One world is spawned per shape."""
import numpy as np
import pytest
import torch

from fastllama_tpu.config import RuntimeConfig as JaxRuntimeConfig
from fastllama_tpu.engine import scheduler as js

from _torch_world import run_world, world_cases
from test_session import tiny_vocab
from test_sharding import HP, build_params
from test_torch_model import to_numpy_tree
from test_torch_parallel_worlds import vocab_tokens

torch.set_num_threads(1)

ENGINE_PROMPTS = ["w3 w4 w5", "w1 w2", "w7", "w2 w6 w8", "w4 w9", "w5"]
ENGINE_KW = dict(n_slots=4, n_ctx=32, page_size=8)


@pytest.fixture(scope="module")
def model():
    jp = build_params(quantized=True, rng=np.random.default_rng(7))
    return dict(jp=jp, tree=to_numpy_tree(jp))


_WORLDS = {}


def world(shape, m):
    """Both engines of one world shape, run once (one spawn per shape)."""
    if shape not in _WORLDS:
        cases = [(f"engine_{mode}", "engine", (
            shape, mode, m["tree"], HP, vocab_tokens(HP.n_vocab),
            ENGINE_PROMPTS, ENGINE_KW)) for mode in ("slab", "paged")]
        cases.append(("layout", "layout", shape))
        _WORLDS[shape] = run_world(shape[0] * shape[1], world_cases, cases)
    return _WORLDS[shape]


_JAX_ENGINE = {}


def jax_engine_texts(model, shape, kv_mode):
    key = (shape, kv_mode)
    if key not in _JAX_ENGINE:
        rcfg = JaxRuntimeConfig(kv_dtype="float32", weight_dtype="float32",
                                use_pallas=False, prefill_buckets=(8, 16, 32),
                                mesh_shape=shape)
        eng = js.BatchEngine(HP, model["jp"], tiny_vocab(HP.n_vocab),
                             rcfg=rcfg, temp=0.0, kv_mode=kv_mode,
                             **ENGINE_KW)
        reqs = [js.Request(prompt=p, max_tokens=4) for p in ENGINE_PROMPTS]
        eng.run(reqs)
        _JAX_ENGINE[key] = [r.text for r in reqs]
    return _JAX_ENGINE[key]


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("kv_mode", ["slab", "paged"])
def test_mesh_engine_matches_jax_mesh_engine(model, shape, kv_mode):
    want = jax_engine_texts(model, shape, kv_mode)
    for r in world(shape, model):
        texts, pages = r[f"engine_{kv_mode}"]
        assert texts == want
        if kv_mode == "paged":
            free, total = pages
            assert len(free) == shape[0] and sum(free) == total


def test_hybrid_mesh_layout(model):
    """hybrid_mesh(2, 2) over four ranks: ranks numbered data-major, the
    model axis over consecutive ranks (one node's), the data axis across;
    a tp that does not divide a node's ranks is refused."""
    for rank, r in enumerate(world((2, 2), model)):
        grid, coords, (data, mdl), refused = r["layout"]
        assert grid == [[0, 1], [2, 3]]
        assert coords == (rank // 2, rank % 2)
        assert mdl == [rank // 2 * 2, rank // 2 * 2 + 1]
        assert data == [rank % 2, rank % 2 + 2]
        assert refused
