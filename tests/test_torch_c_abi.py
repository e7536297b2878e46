"""PyTorch port: the C ABI (fastllama_tpu_torch/native/c_api.cpp), built by
native.build_c_abi(), drives fastllama_tpu_torch.Model from plain C. The JAX
package's own C clients (examples/c/*.c, tests/_c_interrupt.c) compile
unchanged against the port's header and library; the CPU is asked for
through the ABI's boot hook FASTLLAMA_C_INIT (no card here). Counterparts of
tests/test_c_abi.py, plus the C stream against the port's Python API and
the port's f32 stream against the JAX package's."""
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import fastllama_tpu
import fastllama_tpu_torch
from fastllama_tpu_torch import native
from fastllama_tpu_torch.config import FType, HyperParams
from fastllama_tpu_torch.engine.tokenizer import Vocab
from fastllama_tpu_torch.io.ggml_writer import write_ggjt
from fastllama_tpu_torch.quant.q4 import quantize_q4_0

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU_INIT = ("import fastllama_tpu_torch.config as c; "
            "c.set_default_device('cpu')")
HP = HyperParams(n_vocab=300, n_embd=64, n_mult=32, n_head=4, n_layer=2,
                 n_rot=16, ftype=FType.MOSTLY_Q4_0)


def vocab_of(n_vocab):
    toks = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    toks += [(bytes([i]), -1e6) for i in range(256)]
    toks += [(f" t{i}".encode(), 1.0) for i in range(n_vocab - 259)]
    return Vocab.from_tokens(toks)


def write_model(path, hp, seed):
    rng = np.random.default_rng(seed)
    d, f = hp.n_embd, hp.n_ff

    def q(out, inn, s=0.15, eos_row=False):
        dense = (rng.standard_normal((out, inn)) * s).astype(np.float32)
        if eos_row:
            dense[2] = 0.0             # EOS logit 0: greedy runs its length
        return ("q4_0",) + quantize_q4_0(dense)

    ones = ("f32", np.ones(d, np.float32))
    t = {"tok_embeddings.weight": q(hp.n_vocab, d, 0.4), "norm.weight": ones,
         "output.weight": q(hp.n_vocab, d, eos_row=True)}
    for i in range(hp.n_layer):
        p = f"layers.{i}."
        t[p + "attention_norm.weight"] = ones
        t[p + "ffn_norm.weight"] = ones
        for nm in ("wq", "wk", "wv", "wo"):
            t[p + f"attention.{nm}.weight"] = q(d, d)
        t[p + "feed_forward.w1.weight"] = q(f, d)
        t[p + "feed_forward.w3.weight"] = q(f, d)
        t[p + "feed_forward.w2.weight"] = q(d, f)
    write_ggjt(path, hp, vocab_of(hp.n_vocab), t)
    return str(path)


@pytest.fixture(scope="module")
def c_abi_lib():
    if native.compiler() is None or shutil.which("gcc") is None:
        pytest.skip("C toolchain not available")
    return native.build_c_abi()


@pytest.fixture(scope="module")
def c_prog(c_abi_lib, tmp_path_factory):
    """Compile one of the JAX package's C clients, unchanged, against the
    port's header and library."""
    out_dir = tmp_path_factory.mktemp("cprogs")

    def build(src: Path):
        out = out_dir / src.stem
        if not out.exists():
            r = subprocess.run(
                ["gcc", str(src), f"-I{native.HEADER_DIR}",
                 f"-L{c_abi_lib.parent}", "-lfastllama_c", "-o", str(out)],
                capture_output=True, text=True)
            assert r.returncode == 0, f"{src.name} compile failed:\n{r.stderr}"
        return out
    return build


def run_c(c_abi_lib, prog, *args, init=CPU_INIT, stdin=None):
    env = native.c_program_env(c_abi_lib.parent)
    env.pop("FASTLLAMA_C_INIT", None)
    if init:
        env["FASTLLAMA_C_INIT"] = init
    return subprocess.run([str(prog), *args], input=stdin,
                          capture_output=True, text=True, timeout=600,
                          env=env)


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("cckpt") / "tiny.bin", HP, 11)


def test_header_is_byte_compatible_with_the_jax_header():
    """Same declarations, field order and entry points: the two headers
    differ only in comments."""
    def code(path):
        text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
        return [ln.strip() for ln in text.splitlines() if ln.strip()]
    assert code(native.HEADER_DIR / "fastllama_c.h") == code(
        REPO / "fastllama_tpu" / "native" / "fastllama_c.h")


def test_c_abi_generates(c_abi_lib, c_prog, tiny_model):
    r = run_c(c_abi_lib, c_prog(REPO / "examples/c/main.c"), tiny_model,
              " t1 t2", "4", "0")
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert len(r.stdout.strip()) > 0
    assert f"logits: {HP.n_vocab} values" in r.stderr


def python_stream(path, n, **kw):
    m = fastllama_tpu_torch.Model(path, n_ctx=512, device="cpu", **kw)
    assert m.ingest(" t1 t2")
    chunks = []
    assert m.generate(num_tokens=n, temp=0.0, top_k=40, top_p=0.95,
                      repeat_penalty=1.0, streaming_fn=chunks.append,
                      stop_words=["###"])
    return "".join(chunks), m


def test_c_abi_greedy_matches_python_api(c_abi_lib, c_prog, tiny_model):
    """The C surface is a veneer: greedy text through the ABI equals greedy
    text through fastllama_tpu_torch.Model on the same file and arguments
    (the defaults: bf16 weights and KV)."""
    r = run_c(c_abi_lib, c_prog(REPO / "examples/c/main.c"), tiny_model,
              " t1 t2", "8", "0")
    assert r.returncode == 0, r.stderr
    text, _ = python_stream(tiny_model, 8)
    assert len(text) > 0 and r.stdout.rstrip("\n") == text


def test_port_stream_equals_jax_stream_in_f32(tiny_model):
    """What the C program streams is the port's Model; in f32 the port's
    greedy tokens equal the JAX Model's on the same file."""
    f32 = dict(kv_dtype="float32", weight_dtype="float32")
    text, tm = python_stream(tiny_model, 8, **f32)
    jm = fastllama_tpu.Model(tiny_model, n_ctx=512, use_pallas=False, **f32)
    assert jm.ingest(" t1 t2")
    chunks = []
    assert jm.generate(num_tokens=8, temp=0.0, top_k=40, top_p=0.95,
                       repeat_penalty=1.0, streaming_fn=chunks.append,
                       stop_words=["###"])
    assert text == "".join(chunks)
    assert list(tm.session._last_n) == list(jm.session._last_n)


def test_c_abi_without_a_card_refuses_to_load(c_abi_lib, c_prog,
                                               tiny_model):
    """No boot hook and no card: llama_load_model returns false and says
    why; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    r = run_c(c_abi_lib, c_prog(REPO / "examples/c/main.c"), tiny_model,
              " t1 t2", "4", "0", init=None)
    assert r.returncode == 1
    assert "model load failed" in r.stderr
    assert "device='cpu'" in r.stderr


@pytest.fixture(scope="module")
def real_vocab_model(tmp_path_factory):
    """1-layer model at the real LLaMA vocab width (n_vocab 32000), so the
    logits view is exercised at production row size."""
    hp = HyperParams(n_vocab=32000, n_embd=64, n_mult=32, n_head=4,
                     n_layer=1, n_rot=16, ftype=FType.MOSTLY_Q4_0)
    return write_model(tmp_path_factory.mktemp("ckpt32k") / "real.bin", hp,
                       13)


def test_c_abi_perplexity_real_vocab(c_abi_lib, c_prog, real_vocab_model,
                                     tmp_path):
    """perplexity.c end-to-end at n_vocab 32000: the all-logits view is
    n_positions * 32000 wide, the argmax id a valid vocab id, and the
    perplexity equals Model.perplexity on the same text (printed to 4
    decimals: 1e-6 relative at this size, 1e-4 stated)."""
    text = " t1 t2 t3 t4 t5 t6 t7 t8 t9 t10 t11 t12"
    (tmp_path / "text.txt").write_text(text)
    r = run_c(c_abi_lib, c_prog(REPO / "examples/c/perplexity.c"),
              real_vocab_model, str(tmp_path / "text.txt"))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    m = re.search(r"logit view: (\d+) values, argmax id (\d+)", r.stdout)
    assert m, r.stdout
    n_values, argmax = int(m.group(1)), int(m.group(2))
    assert n_values % 32000 == 0 and n_values >= 32000
    assert 0 <= argmax < 32000
    c_ppl = float(re.search(r"perplexity: ([0-9.]+)", r.stdout).group(1))
    model = fastllama_tpu_torch.Model(real_vocab_model, n_ctx=512,
                                      should_get_all_logits=True,
                                      device="cpu")
    np.testing.assert_allclose(c_ppl, model.perplexity(text), rtol=1e-4)


def test_c_abi_handle_signal_stops_generate(c_abi_lib, c_prog, tiny_model):
    """llama_handle_signal mid-generate: the in-flight generate stops at the
    next token boundary and returns true; the flag is cleared by the next
    llama_generate, which runs unimpeded."""
    r = run_c(c_abi_lib, c_prog(REPO / "tests/_c_interrupt.c"), tiny_model,
              " t1 t2", "12")
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    m = re.search(r"chunks1=(\d+) chunks2=(\d+)", r.stdout)
    assert m, r.stdout
    chunks1, chunks2 = int(m.group(1)), int(m.group(2))
    assert 1 <= chunks1 <= 3, (chunks1, chunks2)
    assert chunks2 > chunks1, (chunks1, chunks2)


def test_c_abi_alpaca_example(c_abi_lib, c_prog, tiny_model):
    """The alpaca REPL example: one instruction line on stdin is wrapped in
    the Alpaca template, ingested and answered."""
    r = run_c(c_abi_lib, c_prog(REPO / "examples/c/example-alpaca.c"),
              tiny_model, "4", "0", stdin="t1 t2\n")
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert r.stdout.count("User: ") == 2, r.stdout
