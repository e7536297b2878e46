"""PyTorch port, multi-GPU serving (parallel/) in spawned gloo worlds on the
CPU, against the JAX package's mesh functions on its 8-device virtual CPU
mesh: the tensor-parallel forward (make_sharded_forward), the sequence-
parallel forward (make_seq_parallel_forward: fresh, chunked with the ring
seeded by the cache prefix, decode), the sharded session (greedy stream,
LoRA attach and detach, save then one-device load) and the mesh engine,
slab and paged, is in test_torch_parallel_engine.py.

One world is spawned per shape (a module-scoped fixture runs every case of
that shape in it and returns numpy results); each case is a test of its
own. Logits are held within 1e-4 of the largest |logit| (f32: only the
order of the sums differs)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastllama_tpu.models.llama import init_kv_cache
from fastllama_tpu.parallel.sharding import (
    make_mesh, make_seq_parallel_forward, make_sharded_forward, shard_kv,
    shard_kv_seq, shard_params,
)
from fastllama_tpu_torch.config import RuntimeConfig
from fastllama_tpu_torch.engine.session import FastLlama
from fastllama_tpu_torch.engine.tokenizer import Vocab
from fastllama_tpu_torch.io.ggml_writer import write_ggla
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.models.runtime import LlamaModel

from _torch_world import run_world, world_cases
from test_sharding import CFG, HP, build_params
from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

REL = 1e-4
PROMPT = " " + " ".join(f"w{i}" for i in range(1, 12))
SP_T, SP_CHUNK = 16, 8


def close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err <= REL * float(np.abs(b).max()), err


def vocab_tokens(n_vocab):
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    return toks + [(f" w{i}".encode(), 1.0) for i in range(n_vocab - len(toks))]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    rng = np.random.default_rng(7)
    jp = build_params(quantized=True, rng=rng)
    jd = build_params(quantized=False, rng=rng)
    tmp = tmp_path_factory.mktemp("parallel")
    d, f, r = HP.n_embd, 256, 4
    ab = {}
    for base, k, n in (("layers.0.attention.wq", d, d),
                       ("layers.1.attention.wv", d, d),
                       ("layers.0.attention.wo", d, d),
                       ("layers.1.feed_forward.w1", d, f),
                       ("layers.0.feed_forward.w2", f, d),
                       ("output", d, HP.n_vocab)):
        ab[base + ".weight.loraA"] = rng.standard_normal((k, r)) * 0.05
        ab[base + ".weight.loraB"] = rng.standard_normal((n, r)) * 0.05
    lora = str(tmp / "adapter.bin")
    write_ggla(lora, r=r, alpha=r, use_cache=False, tensors=ab)
    return dict(jp=jp, jd=jd, tree=to_numpy_tree(jp), dense=to_numpy_tree(jd),
                lora=lora, tmp=tmp)


def _tp_inputs(dp):
    b = 2 * dp
    tokens = (np.arange(b * 5).reshape(b, 5) * 7 % 200).astype(np.int64)
    steps = (np.arange(b * 3).reshape(b, 3) * 13 % 250 + 3).astype(np.int64)
    return tokens, steps


def _sp_inputs():
    tokens = ((np.arange(SP_T) * 11 + 2) % 200).astype(np.int64)[None]
    steps = np.array([[17, 42, 99, 7]], np.int64)
    return tokens, steps


def _cases(shape, m):
    dp, tp = shape
    cases = []
    if shape in ((1, 2), (1, 4), (2, 2)):
        cases.append(("tp_q4_0", "tp_forward",
                      (dp, tp, m["tree"], HP, *_tp_inputs(dp))))
    if shape == (1, 2):
        cases.append(("tp_dense", "tp_forward",
                      (dp, tp, m["dense"], HP, *_tp_inputs(dp))))
    if dp == 2:
        tokens, steps = _sp_inputs()
        cases.append(("sp", "sp_forward",
                      (dp, tp, m["tree"], HP, tokens, SP_CHUNK, steps)))
    if shape in ((1, 2), (2, 1)):
        cases.append(("session", "session", (
            shape, dp > 1, m["tree"], HP, vocab_tokens(HP.n_vocab), PROMPT,
            4, m["lora"], str(m["tmp"] / f"state_{dp}x{tp}.npz"))))
    return cases


_WORLDS = {}


def world(shape, m):
    """Every case of one world shape, run once (one spawn per shape)."""
    if shape not in _WORLDS:
        _WORLDS[shape] = run_world(shape[0] * shape[1], world_cases,
                                   _cases(shape, m))
    return _WORLDS[shape]


# ---------------------------------------------------------------------------
# tensor parallelism: the forward against make_sharded_forward
# ---------------------------------------------------------------------------

def jax_tp(params, shape, tokens, steps):
    dp, tp = shape
    mesh = make_mesh(n_data=dp, n_model=tp)
    sh = shard_params(params, mesh)
    fn = make_sharded_forward(mesh, params, CFG)
    kv = shard_kv(init_kv_cache(HP, tokens.shape[0], 16, dtype=jnp.float32),
                  mesh)
    t = tokens.shape[1]
    out, kv, _ = fn(sh, jnp.asarray(tokens, jnp.int32), jnp.int32(0), kv,
                    jnp.int32(t - 1))
    outs = [np.asarray(out)]
    for i in range(steps.shape[1]):
        out, kv, _ = fn(sh, jnp.asarray(steps[:, i:i + 1], jnp.int32),
                        jnp.int32(t + i), kv, jnp.int32(0))
        outs.append(np.asarray(out))
    return outs


@pytest.mark.parametrize("shape,case", [((1, 2), "tp_q4_0"),
                                        ((1, 4), "tp_q4_0"),
                                        ((2, 2), "tp_q4_0"),
                                        ((1, 2), "tp_dense")])
def test_tp_forward_matches_jax_sharded_forward(model, shape, case):
    params = model["jp"] if case == "tp_q4_0" else model["jd"]
    ref = jax_tp(params, shape, *_tp_inputs(shape[0]))
    ranks = world(shape, model)
    # every model-axis rank returns the same logits (the head's all-gather);
    # the data groups' rows stack in order
    for step, want in enumerate(ref):
        for mi in range(shape[1]):
            got = np.concatenate([r[case][2][step] for r in ranks
                                  if r[case][1] == mi], axis=0)
            close(got, want)


# ---------------------------------------------------------------------------
# sequence parallelism: against make_seq_parallel_forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_sp_forward_matches_jax_seq_parallel_forward(model, shape):
    sp, tp = shape
    tokens, steps = _sp_inputs()
    jp = model["jp"]
    mesh = make_mesh(n_data=sp, n_model=tp)
    sh = shard_params(jp, mesh)
    b, t = tokens.shape

    def kv0():
        return shard_kv_seq(init_kv_cache(HP, b, 2 * t, dtype=jnp.float32),
                            mesh)

    toks = jnp.asarray(tokens, jnp.int32)
    fresh, _, _ = make_seq_parallel_forward(mesh, jp, CFG)(
        sh, toks, jnp.int32(0), kv0(), jnp.int32(t - 1))
    fn = make_seq_parallel_forward(mesh, jp, CFG, chunked=True)
    kv, parts = kv0(), []
    for c0 in range(0, t, SP_CHUNK):
        out, kv, _ = fn(sh, toks[:, c0:c0 + SP_CHUNK], jnp.int32(c0), kv,
                        jnp.int32(SP_CHUNK - 1))
        parts.append(np.asarray(out))
    dec = make_seq_parallel_forward(mesh, jp, CFG, decode=True)
    step_out = []
    for i in range(steps.shape[1]):
        out, kv, _ = dec(sh, jnp.asarray(steps[:, i:i + 1], jnp.int32),
                         jnp.int32(t + i), kv, jnp.int32(0))
        step_out.append(np.asarray(out))
    for r in world(shape, model):
        got_fresh, got_chunked, got_steps = r["sp"]
        close(got_fresh, np.asarray(fresh))
        close(got_chunked, np.concatenate(parts, axis=1))
        close(got_steps, np.stack(step_out))


# ---------------------------------------------------------------------------
# the sharded session
# ---------------------------------------------------------------------------

def one_device_session(model):
    rcfg = RuntimeConfig(n_ctx=64, n_batch=8, kv_dtype="float32",
                         weight_dtype="float32",
                         prefill_buckets=(8, 16, 32, 64))
    lm = LlamaModel(HP, tl.params_from_numpy(model["tree"], device="cpu"),
                    Vocab.from_tokens(vocab_tokens(HP.n_vocab)), rcfg,
                    device="cpu")
    return lm, FastLlama(lm, n_keep=8, seed=3)


@pytest.fixture(scope="module")
def reference_session(model):
    lm, sess = one_device_session(model)
    assert sess.ingest(PROMPT)
    toks = []
    assert sess.generate(toks.append, num_tokens=4, temp=0.0)
    path = str(model["tmp"] / "state_one_device.npz")
    assert sess.save_state(path)
    res = dict(stream=toks, logits=sess.get_logits().copy(), state=path)
    probe = [1, 300, 301, 302]
    assert lm.attach_lora(model["lora"])
    res["attached"] = lm.eval(0, probe)
    assert lm.detach_lora()
    return res


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_sharded_session_matches_one_device(model, reference_session, shape):
    ref = reference_session
    for r in world(shape, model):
        got = r["session"]
        assert got["stream"] == ref["stream"]
        close(got["logits"], ref["logits"])


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_sharded_session_lora_attach_and_detach(model, reference_session,
                                                shape):
    """Attached: the one-device logits within the tolerance; detached: the
    logits before the attach bit for bit, on every rank."""
    for r in world(shape, model):
        close(r["session"]["attached"], reference_session["attached"])
        assert r["session"]["detached_equal"]


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_sharded_save_loads_on_one_device(model, reference_session, shape):
    """The sharded world's saved state is the one-device file (same arrays;
    the caches within the tolerance), and a one-device session loaded from
    it continues as the one-device session does."""
    world(shape, model)
    path = str(model["tmp"] / f"state_{shape[0]}x{shape[1]}.npz")
    with np.load(path) as got, np.load(reference_session["state"]) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            if key in ("kv_k", "kv_v", "logits"):
                close(got[key], want[key])
            else:
                np.testing.assert_array_equal(got[key], want[key])
    conts = []
    for p in (path, reference_session["state"]):
        _, sess = one_device_session(model)
        assert sess.load_state(p)
        assert sess.generate(lambda s: None, num_tokens=2, temp=0.0)
        conts.append(sess.get_logits().copy())
    close(conts[0], conts[1])
