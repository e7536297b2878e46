"""PyTorch port: the CLIs of tools_torch/ (quantize, convert, convert_lora,
export_hf, chat) driven through main() on tiny fixtures; each writes what
the JAX package's tool of the same name writes, byte for byte. chat is
driven through piped stdin with --device cpu."""
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from test_hf_convert import _make_hf_dir
from test_torch_convert import ggml_tensors, tiny_vocab
from test_torch_convert import HP

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from fastllama_tpu.io import ggml_writer as jw  # noqa: E402
from tools import chat as j_chat  # noqa: E402
from tools import convert as j_convert  # noqa: E402
from tools import convert_lora as j_convert_lora  # noqa: E402
from tools import export_hf as j_export_hf  # noqa: E402
from tools import quantize as j_quantize  # noqa: E402
from tools_torch import chat as t_chat  # noqa: E402
from tools_torch import convert as t_convert  # noqa: E402
from tools_torch import convert_lora as t_convert_lora  # noqa: E402
from tools_torch import export_hf as t_export_hf  # noqa: E402
from tools_torch import profile_prefill as t_profile_prefill  # noqa: E402
from tools_torch import quantize as t_quantize  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools_in")
    out = {}
    for kind in ("q4_0", "f16"):
        out[kind] = str(root / f"tiny_{kind}.bin")
        jw.write_ggjt(out[kind], HP, tiny_vocab(), ggml_tensors(kind))
    _make_hf_dir(root / "hf", np.random.default_rng(1))
    out["hf"] = str(root / "hf")
    out["lora"] = str(peft_dir(root / "lora", np.random.default_rng(6)))
    return out


def peft_dir(path: Path, rng, r=4, d=64, n_ff=256):
    """A PEFT LoRA adapter: A [r, in] and B [out, r] on q/v/down of two
    layers, as safetensors."""
    from safetensors.numpy import save_file
    path.mkdir()
    with open(path / "adapter_config.json", "w") as f:
        json.dump({"peft_type": "LORA", "r": r, "lora_alpha": 8,
                   "fan_in_fan_out": False}, f)
    t = {}
    for i in range(2):
        for sub, (out, inn) in (("self_attn.q_proj", (d, d)),
                                ("self_attn.v_proj", (d, d)),
                                ("mlp.down_proj", (d, n_ff))):
            p = f"base_model.model.model.layers.{i}.{sub}"
            t[p + ".lora_A.weight"] = (rng.standard_normal((r, inn)) * 0.1
                                       ).astype(np.float32)
            t[p + ".lora_B.weight"] = (rng.standard_normal((out, r)) * 0.1
                                       ).astype(np.float32)
    save_file(t, str(path / "adapter_model.safetensors"))
    return path


def run_main(module, argv, monkeypatch, stdin=None):
    monkeypatch.setattr(sys, "argv", [module.__name__] + [str(a) for a in argv])
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    return module.main()


def both_tools(jmod, tmod, tmp_path, monkeypatch, argv_of):
    """Run the JAX tool and the port's with argv_of(out_dir); compare the
    two output directories byte for byte."""
    outs = []
    for side, mod in (("jax", jmod), ("torch", tmod)):
        out = tmp_path / side
        out.mkdir()
        assert run_main(mod, argv_of(out), monkeypatch) == 0
        outs.append(out)
    trees = [{str(f.relative_to(o)): f.read_bytes()
              for f in sorted(o.rglob("*")) if f.is_file()} for o in outs]
    assert sorted(trees[0]) == sorted(trees[1]) and trees[0]
    for name in trees[0]:
        assert trees[0][name] == trees[1][name], f"{name} differs"


@pytest.mark.parametrize("src,ftype", [("f16", 2), ("q4_0", 2), ("f16", 1),
                                       ("hf", 2)])
def test_quantize_cli(inputs, tmp_path, monkeypatch, src, ftype):
    both_tools(j_quantize, t_quantize, tmp_path, monkeypatch,
               lambda out: [inputs[src], out / "model.fltpu", ftype])


def test_quantize_cli_refuses_a_bad_type(inputs, tmp_path, monkeypatch):
    for mod in (j_quantize, t_quantize):
        assert run_main(mod, [inputs["f16"], tmp_path / "x", 5],
                        monkeypatch) == 1


@pytest.mark.parametrize("src,extra", [
    ("q4_0", []), ("f16", ["--ftype", "f16"]), ("hf", ["--n-ctx", "64"]),
    ("f16", ["--format", "ggjt"]), ("hf", ["--format", "ggjt"])])
def test_convert_cli(inputs, tmp_path, monkeypatch, src, extra):
    name = "model.bin" if "ggjt" in extra else "model.fltpu"
    both_tools(j_convert, t_convert, tmp_path, monkeypatch,
               lambda out: [inputs[src], out / name, *extra])


@pytest.mark.parametrize("extra", [[], ["--no-cache"], ["-t", "fp16"]])
def test_convert_lora_cli(inputs, tmp_path, monkeypatch, extra):
    both_tools(j_convert_lora, t_convert_lora, tmp_path, monkeypatch,
               lambda out: [inputs["lora"], "-o", out / "adapter.bin",
                            *extra])


@pytest.mark.parametrize("lora", [False, True])
def test_export_hf_cli(inputs, tmp_path, monkeypatch, lora):
    extra = ["--lora", inputs["lora"]] if lora else []
    both_tools(j_export_hf, t_export_hf, tmp_path, monkeypatch,
               lambda out: ["--base", inputs["hf"], "--out", out, *extra])


CHAT_ARGS = ["--temp", "0", "--num-tokens", "4", "--n-ctx", "256",
             "--system-prompt", " t5 t6"]


def chat_session(tmp_path):
    state = tmp_path / "state.bin"
    return "\n".join([" t1 t2", f"/save {state}", " t3", "/reset",
                      f"/load {state}", " t3", "/bogus", "", "/quit",
                      " never read"]) + "\n"


def test_chat_cli_through_stdin(inputs, tmp_path, monkeypatch, capsys):
    """The same piped session through both chat tools prints the same
    transcript (after the first line, which names what loading does); the
    state saved before a turn and loaded after /reset replays that turn."""
    outs = []
    for side, mod, extra in (("jax", j_chat, []),
                             ("torch", t_chat, ["--device", "cpu"])):
        (tmp_path / side).mkdir()
        assert run_main(mod, [inputs["q4_0"], *CHAT_ARGS, *extra],
                        monkeypatch, stdin=chat_session(tmp_path / side)) == 0
        outs.append(capsys.readouterr().out)
    j_out, t_out = (o.split("\n", 1)[1] for o in outs)
    assert t_out == j_out
    turns = t_out.split("Assistant: ")
    assert len(turns) == 4 and "saved" in t_out and "loaded" in t_out
    assert "reset" in t_out and "unknown command /bogus" in t_out
    # " t3" after /load replays " t3" after /save: the same text
    assert turns[2].split("\n")[0] == turns[3].split("\n")[0]


def test_chat_cli_tp_and_no_card(inputs, monkeypatch):
    """--tp 2 outside a launch of two ranks (no process group) raises, as
    --device unset without a card does: nothing runs one device instead."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.warns(UserWarning, match="single-process"), \
            pytest.raises(RuntimeError, match="process group"):
        run_main(t_chat, [inputs["q4_0"], "--tp", "2", "--device", "cpu"],
                 monkeypatch, stdin="")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_main(t_chat, [inputs["q4_0"]], monkeypatch, stdin="")


def test_chat_cli_tp_under_torchrun(tmp_path, monkeypatch, capsys):
    """chat.py --tp 2 launched by torchrun (two CPU ranks over gloo): rank 0
    reads the piped lines and broadcasts them, and the transcript (printed
    by rank 0 alone) is the one-device chat's, /save and /load included."""
    import subprocess
    from fastllama_tpu_torch.config import HyperParams
    from fastllama_tpu_torch.io.ggml_writer import write_ggjt
    from test_torch_parallel_worlds import vocab_tokens
    from fastllama_tpu_torch.engine.tokenizer import Vocab
    hp = HyperParams(n_vocab=512, n_embd=256, n_head=8, n_layer=2, n_rot=16)
    rng = np.random.default_rng(4)

    def q(n, k):
        return ("q4_0", rng.integers(0, 16, (n, k), dtype=np.uint8),
                rng.uniform(1e-3, 0.02, (n, k // 32)).astype(np.float32) * 8)
    ones = ("f32", np.ones(hp.n_embd, np.float32))
    d, f = hp.n_embd, hp.n_ff
    tensors = {"tok_embeddings.weight": q(hp.n_vocab, d), "norm.weight": ones,
               "output.weight": q(hp.n_vocab, d)}
    for i in range(hp.n_layer):
        p = f"layers.{i}."
        tensors.update({p + "attention_norm.weight": ones,
                        p + "ffn_norm.weight": ones,
                        p + "feed_forward.w1.weight": q(f, d),
                        p + "feed_forward.w3.weight": q(f, d),
                        p + "feed_forward.w2.weight": q(d, f)})
        for nm in ("wq", "wk", "wv", "wo"):
            tensors[p + f"attention.{nm}.weight"] = q(d, d)
    model = tmp_path / "tiny.bin"
    write_ggjt(model, hp, Vocab.from_tokens(vocab_tokens(hp.n_vocab)),
               tensors)
    args = [str(model), "--temp", "0", "--num-tokens", "4", "--n-ctx", "64",
            "--system-prompt", " w5 w6", "--device", "cpu"]

    def session(side):
        (tmp_path / side).mkdir()
        state = tmp_path / side / "state.bin"
        return "\n".join([" w1 w2", f"/save {state}", " w3", "/reset",
                          f"/load {state}", " w3", "/quit"]) + "\n"
    assert run_main(t_chat, args, monkeypatch, stdin=session("one")) == 0
    one = capsys.readouterr().out
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    # --standalone: the rendezvous store binds a free port itself, where a
    # port picked here and released could be taken by another process
    # before torchrun binds it
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--standalone",
         str(REPO / "tools_torch" / "chat.py"), *args, "--tp", "2"],
        input=session("tp"), capture_output=True, text=True, timeout=240,
        env=env, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout == one
    assert "saved" in one and "loaded" in one and one.count("Assistant: ") == 3


def test_profile_prefill_arguments():
    """tools_torch/profile_prefill.py: the JAX tool's window options with
    its defaults, --mode int8 or bf16 only, a window that fits the cache."""
    args = t_profile_prefill.parse_args([])
    assert (args.seq, args.n_ctx, args.layers, args.mode, args.reps) == (
        512, 512, 32, "int8", 4)
    assert Path(args.out) == Path(tempfile.gettempdir(), "profile_prefill")
    args = t_profile_prefill.parse_args(
        ["--seq", "1024", "--n-ctx", "2048", "--layers", "2", "--mode",
         "bf16", "--reps", "1", "--out", "prof"])
    assert (args.seq, args.n_ctx, args.layers, args.mode, args.reps,
            args.out) == (1024, 2048, 2, "bf16", 1, "prof")
    for bad in (["--mode", "xla"], ["--seq", "1024"], ["--seq", "0"],
                ["--layers", "0"]):
        with pytest.raises(SystemExit):
            t_profile_prefill.parse_args(bad)


def test_profile_prefill_needs_a_card(capsys):
    """Without a card the profiler refuses (exit code 2) before building
    or tracing anything: a CPU run is no device measurement."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert t_profile_prefill.main(["--layers", "1"]) == 2
    assert "no CUDA card" in capsys.readouterr().err
