"""PyTorch port: the CLIs of tools_torch/ (quantize, convert, convert_lora,
export_hf, chat) driven through main() on tiny fixtures; each writes what
the JAX package's tool of the same name writes, byte for byte. chat is
driven through piped stdin with --device cpu."""
import io
import json
import os
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
from tools_torch import attn_sweep as t_attn_sweep  # noqa: E402
from tools_torch import b15_sweep as t_b15_sweep  # noqa: E402
from tools_torch import f32_sweep as t_f32_sweep  # noqa: E402
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


def torchrun_report(run, want: str, log_dir: Path) -> str:
    """What a failed torchrun chat left: its exit code, a diff of its
    transcript against the one-device one, each rank's stderr (the files
    torchrun's --tee writes under log_dir/<run>/attempt_0/<rank>/) and
    torchrun's own."""
    import difflib
    diff = "".join(difflib.unified_diff(
        want.splitlines(keepends=True), run.stdout.splitlines(keepends=True),
        "one device", "torchrun --tp 2"))
    ranks = "".join(f"--- {p.relative_to(log_dir)} ---\n"
                    f"{p.read_text(errors='replace')[-3000:]}\n"
                    for p in sorted(log_dir.rglob("stderr.log")))
    return (f"exit code {run.returncode}\n--- transcript diff ---\n"
            f"{diff or '(equal)'}\n{ranks or '(no rank logs)'}"
            f"--- torchrun's stderr ---\n{run.stderr[-3000:]}")


def test_chat_cli_tp_under_torchrun(tmp_path, monkeypatch, capsys):
    """chat.py --tp 2 launched by torchrun (two CPU ranks over gloo): rank 0
    reads the piped lines and broadcasts them, and the transcript (printed
    by rank 0 alone) is the one-device chat's, /save and /load included."""
    import signal
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
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    # --standalone: the rendezvous store binds a free port itself, where a
    # port picked here and released could be taken by another process
    # before torchrun binds it
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "2", "--standalone", "--log-dir", str(tmp_path / "logs"),
           "--tee", "2", str(REPO / "tools_torch" / "chat.py"), *args,
           "--tp", "2"]
    # its own session, so that a run past the limit is stopped with both
    # ranks (a killed torchrun would leave them waiting on each other)
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=tmp_path,
                            start_new_session=True)
    try:
        out, err = proc.communicate(session("tp"), timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        err += "\n(stopped after 240 s)"
    run = subprocess.CompletedProcess(cmd, proc.returncode, out, err)
    assert run.returncode == 0 and run.stdout == one, torchrun_report(
        run, one, tmp_path / "logs")
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


def test_attn_sweep_arguments():
    """tools_torch/attn_sweep.py (which replaced attn_chunk_sweep.py and
    paged_chunk_sweep.py): compare and pins by default, three rounds, no
    old tree; parts, --old and --rounds on the command line; unknown
    parts, no rounds and the paths part without an old tree refused."""
    args = t_attn_sweep.parse_args([])
    assert (args.parts, args.old, args.rounds) == (["compare", "pins"],
                                                   None, 3)
    args = t_attn_sweep.parse_args(["--parts", "compare", "--old",
                                    "_tree_check/old", "--rounds", "5"])
    assert (args.parts, args.old, args.rounds) == (["compare"],
                                                   "_tree_check/old", 5)
    for bad in (["--parts", "turns"], ["--rounds", "0"],
                ["--parts", "paths"]):
        with pytest.raises(SystemExit):
            t_attn_sweep.parse_args(bad)
    assert t_attn_sweep.parse_args(
        ["--parts", "paths,builds", "--old", "o"]).parts == ["paths",
                                                             "builds"]
    assert not (REPO / "tools_torch" / "attn_chunk_sweep.py").exists()
    assert not (REPO / "tools_torch" / "paged_chunk_sweep.py").exists()


def test_attn_sweep_old_plans_are_the_parents():
    """The --old tree's plans as the cp.async kernels took them: 64-row
    chunks cut from S (8 at S 512, 192 at 12288) and B6's 64-row chunks
    on the engine's 64-row pages (bf16 and f32), whole 16-row pages four at
    a time, and half pages of 128 rows."""
    assert t_attn_sweep.old_splits(512) == (8, 64)
    assert t_attn_sweep.old_splits(12288) == (192, 64)
    assert t_attn_sweep.old_splits(65) == (2, 33)
    assert t_attn_sweep.old_b6_plan(8, 64, 128, 2) == (8, 64)
    assert t_attn_sweep.old_b6_plan(8, 64, 128, 4) == (8, 64)
    assert t_attn_sweep.old_b6_plan(24, 16, 128, 2) == (6, 64)
    assert t_attn_sweep.old_b6_plan(3, 128, 128, 2) == (6, 64)


def test_attn_sweep_needs_a_card(capsys):
    """Without a card the sweep refuses (exit code 2) before it builds or
    times anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert t_attn_sweep.main(["--parts", "pins"]) == 2
    assert "no CUDA card" in capsys.readouterr().err


def test_f32_sweep_arguments_and_old_plans():
    """tools_torch/f32_sweep.py: every part but paths by default, three
    rounds, an unknown part refused, paths only with --old; the plans it
    gives the --old checkout's f32
    kernels are that checkout's (q4_matmul._splitk and _b1_tile, and
    b5_plan(f32=True), before the f32 mode moved to the tensor cores): the
    7B planes' values those functions gave."""
    args = t_f32_sweep.parse_args([])
    assert args.parts == "check,decode,route,prefill" and args.rounds == 3
    assert not args.old
    with pytest.raises(SystemExit):
        t_f32_sweep.parse_args(["--parts", "decode,ffma"])
    with pytest.raises(SystemExit):           # paths needs the old tree
        t_f32_sweep.parse_args(["--parts", "paths"])
    assert t_f32_sweep.parse_args(["--parts", "paths", "--old", "d"]).old
    compile(t_f32_sweep.PATH_SNIPPET, "path", "exec")
    assert t_f32_sweep.old_gemv_plan(1, 12288, 128) == (48, 11, 12)
    assert t_f32_sweep.old_gemv_plan(8, 4096, 128) == (32, 16, 8)
    assert t_f32_sweep.old_gemv_plan(64, 22528, 128) == (704, 4, 32)
    assert t_f32_sweep.old_gemv_plan(2, 4096, 352) == (16, 32, 11)
    assert t_f32_sweep.old_tile_plan(512, 12288, 4096, 132) == (384, 1, 128)
    assert t_f32_sweep.old_tile_plan(128, 4096, 4096, 132) == (32, 4, 32)
    assert t_f32_sweep.old_tile_plan(65, 12288, 11264, 132) == (96, 4, 88)


def test_f32_sweep_merge_fit():
    """tools_torch/f32_sweep.py's pins part: plans_by_merge gives each
    candidate merge cost exactly one plan (prefill_plan's at that cost,
    RA_MERGE_STAGES_F32 restored after), and merge_fit picks the
    candidate whose plans come nearest each shape's fastest, a tie going
    to the smaller."""
    keep = t_f32_sweep.qm.RA_MERGE_STAGES_F32
    got = t_f32_sweep.plans_by_merge(300, 12288, 4096, 132)
    assert sorted(c for cs_ in got.values() for c in cs_) == list(
        t_f32_sweep.MERGE_CANDIDATES)
    assert t_f32_sweep.qm.RA_MERGE_STAGES_F32 == keep
    assert t_f32_sweep.qm.prefill_plan(300, 12288, 4096, 132,
                                       f32=True) in got
    shapes = [{2: 1.0, 5: 1.2, 9: 1.5}, {2: 2.0, 5: 1.0, 9: 1.0}]
    best, mean = t_f32_sweep.merge_fit(shapes, (2, 5, 9))
    assert best == 5 and mean == {2: 1.5, 5: 1.1, 9: 1.25}
    assert t_f32_sweep.merge_fit([{3: 1.0, 4: 1.0}], (3, 4))[0] == 3


def test_f32_sweep_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert t_f32_sweep.main(["--parts", "check"]) == 2
    assert "no CUDA card" in capsys.readouterr().err


def test_b15_sweep_arguments():
    """tools_torch/b15_sweep.py: the 7B planes at M = 1, 8, 64 and B20
    against B15 at M = 8-64 by default; planes, rows and the ablated builds
    chosen on the command line; unknown planes and M outside 1..64
    refused."""
    import ast
    ast.parse((REPO / "tools_torch" / "b15_sweep.py").read_text())
    args = t_b15_sweep.parse_args([])
    assert (args.planes, args.rows, args.b20_rows, args.no_builds) == (
        ["qkv", "wo", "w13", "w2"], [1, 8, 64], [8, 16, 32, 64], False)
    args = t_b15_sweep.parse_args(["--planes", "qkv13,wo", "--rows", "1,33",
                                   "--b20-rows", "", "--no-builds"])
    assert (args.planes, args.rows, args.b20_rows, args.no_builds) == (
        ["qkv13", "wo"], [1, 33], [], True)
    for bad in (["--planes", "qkv,head"], ["--rows", "65"], ["--rows", "0"],
                ["--b20-rows", "128"]):
        with pytest.raises(SystemExit):
            t_b15_sweep.parse_args(bad)


@pytest.mark.parametrize("m", [1, 8, 9, 33, 64])
def test_b15_sweep_plans_fit_and_differ_as_named(m):
    """The sweep's plans on the 7B w13 plane with the H100's cluster
    capacity: each fits the 227 KB a block gets, each label changes what
    it names and nothing else it can keep (stages_S the ring, splits_S the
    split, one_cluster_an_item the grid, wgmma the product, at M <= 8
    only)."""
    from fastllama_tpu_torch.kernels import q4_variants as qv
    cap = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}.get
    plans = t_b15_sweep.plans(m, 22016, 128, 132, cap)
    base = plans["plan"]
    other = "wgmma" if base.sync else "mma_sync"
    assert (other in plans) == (m <= 8) and base.sync == (m <= 8)
    assert plans["one_cluster_an_item"] == base._replace(
        clusters=-(-22016 // base.bn), items=1)
    for label, p in plans.items():
        assert 2 <= p.xstages <= p.stages
        assert qv.b15_smem(p.wgs, p.nw, False, p.stages, p.xstages,
                           p.splits) <= qv.B15_SMEM
        if label.startswith("stages_"):
            assert p._replace(xstages=0) == base._replace(
                stages=int(label[7:]), xstages=0)
        if label.startswith("splits_"):
            assert p.splits == int(label[7:]) and p.bn == base.bn
        if label == "one_warpgroup":
            assert p.wgs == 1 and base.wgs == 2


def test_b15_sweep_needs_a_card(capsys):
    """Without a card the sweep refuses (exit code 2) before it builds or
    times anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert t_b15_sweep.main(["--rows", "1"]) == 2
    assert "no CUDA card" in capsys.readouterr().err


# -- the bench and profile path ----------------------------------------------

BENCH_SCRIPTS = [REPO / "bench_torch.py"] + [
    REPO / "tools_torch" / f"{n}.py" for n in (
        "_trace_util", "bench_q4_floor", "bench_kernels", "bench_prefill",
        "bench_paged_attn", "bench_engine", "profile_decode",
        "profile_paged", "bench_reference", "profile_q4_variants")]
# the tools that run on the card: each takes --device, with the card the
# default; the smallest arguments each accepts
ON_CARD = {"bench_torch": [],
           "bench_q4_floor": ["64", "32", "1"],
           "bench_kernels": ["--layers", "1", "--m", "1"],
           "bench_prefill": ["--layers", "1", "--seq", "128"],
           "bench_paged_attn": ["--batch", "1", "--n-ctx", "128"],
           "bench_engine": ["--layers", "1", "--slots", "2"],
           "profile_decode": ["--layers", "1", "--steps", "1"],
           "profile_paged": ["--layers", "1", "--slots", "1"],
           "profile_q4_variants": ["64", "32", "1"]}


def load_tool(name):
    import importlib
    return importlib.import_module(
        name if name == "bench_torch" else f"tools_torch.{name}")


@pytest.mark.parametrize("path", BENCH_SCRIPTS, ids=lambda p: p.name)
def test_bench_scripts_parse(path):
    import ast
    ast.parse(path.read_text())


@pytest.mark.parametrize("name", sorted(ON_CARD) + ["bench_reference"])
def test_bench_tools_help(name, capsys):
    with pytest.raises(SystemExit) as e:
        load_tool(name).main(["--help"])
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(ON_CARD))
def test_bench_tools_need_a_card(name):
    """Without --device each runs on the card; with none it raises before
    it builds a model (bench_reference times the reference's CPU library
    and runs nothing on the card)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        load_tool(name).main(ON_CARD[name])


def test_bench_tools_refuse_the_unported_variants(capsys):
    """Every q4_matmul_pallas body is ported (kernels/q4_variants.py), so
    bench_q4_floor takes the JAX tool's v1 and v3 (and B1 as v0) and
    bench_kernels the JAX tool's default v0,v1,v2; a name the JAX package
    does not have (v6) is refused with the list of those it has."""
    floor = load_tool("bench_q4_floor")
    args = floor.parse_args([])
    assert (args.k, args.n, args.m, args.modes) == (
        4096, 12288, 8, ["floor", "nosc", "v0", "v1", "v3"])
    assert floor.parse_args(["512", "256", "1", "nosc"]).modes == ["nosc"]
    assert floor.parse_args(["512", "256", "8", "floor,v3,v7"]).modes == [
        "floor", "v3", "v7"]
    kern = load_tool("bench_kernels")
    assert kern.parse_args([]).variants == ["v0", "v1", "v2"]
    assert kern.parse_args(["--variants", "v3,v4,v5,v7"]).variants == [
        "v3", "v4", "v5", "v7"]
    for bad, tool in ((["512", "256", "8", "floor,v6"], floor),
                      (["--variants", "v0,v6"], kern)):
        with pytest.raises(SystemExit):
            tool.parse_args(bad)
        assert "v0, v1, v2, v3, v4, v5, v7" in capsys.readouterr().err


def test_bench_q4_floor_on_the_cpu(capsys):
    """--device cpu: the plain versions, each held against itself, and the
    last line's rows and launch counts (no kernel launched)."""
    assert load_tool("bench_q4_floor").main(
        ["256", "128", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["mode"] for r in out["bench_q4_floor"]] == [
        "floor", "nosc", "v0", "v1", "v3"]
    assert all(r["relerr"] == 0.0 for r in out["bench_q4_floor"])
    assert out["launches"] == {"q4_floor": 0, "q4_nosc": 0,
                               "q4_matmul_decode": 0, "q4_decode_v1": 0,
                               "q4_decode_v2": 0, "q4_decode_v3": 0,
                               "q4_decode_v7": 0}


def test_profile_q4_variants_takes_the_jax_tools_arguments(capsys):
    """[K] [N] [M] [variants...] with the JAX tool's defaults (4096, 12288,
    8, v1 v3) and every variant name it takes; names it does not take, and
    M past a kernel's limit, are refused."""
    tool = load_tool("profile_q4_variants")
    args = tool.parse_args([])
    assert (args.k, args.n, args.m, args.variants) == (4096, 12288, 8,
                                                       ["v1", "v3"])
    every = ["v0", "v1", "v2", "v3", "v4", "v5", "v7", "v0h", "v1h", "v2h",
             "v3h", "v4h", "v5h", "v7h", "floor", "nosc", "pf", "pfi8",
             "pfi8s", "xla"]
    assert list(tool.VARIANTS) == every
    assert tool.parse_args(["512", "256", "2", *every]).variants == every
    assert tool.parse_args(["512", "256", "512", "pf", "pfi8",
                            "pfi8s"]).m == 512
    for bad in (["512", "256", "8", "v6"], ["512", "256", "65", "v1"],
                ["512", "256", "513", "pfi8s"], ["500", "256", "8"]):
        with pytest.raises(SystemExit):
            tool.parse_args(bad)
    assert "v6" in capsys.readouterr().err


def test_profile_q4_variants_on_the_cpu(capsys):
    """--device cpu: every variant's plain version, held against itself,
    on the host clock; the last line's rows and launch counts (no kernel
    launched)."""
    tool = load_tool("profile_q4_variants")
    assert tool.main(["256", "128", "2", *tool.VARIANTS,
                      "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = out["profile_q4_variants"]
    assert [r["variant"] for r in rows] == list(tool.VARIANTS)
    assert all(r["relerr"] == 0.0 and r["us"] > 0 for r in rows)
    assert not any(out["launches"].values())


def test_profile_tools_keep_the_jax_tools_options():
    """profile_decode and profile_paged take the JAX tools' options and
    defaults (the XLA-only --hlo and --copt left out), their traces under
    the temporary directory."""
    dec = load_tool("profile_decode").parse_args([])
    assert (dec.steps, dec.batch, dec.dims, dec.layers) == (8, 1, "7b", 0)
    assert Path(dec.out) == Path(tempfile.gettempdir(), "profile_decode")
    pag = load_tool("profile_paged").parse_args([])
    assert (pag.steps, pag.slots, pag.layers, pag.n_ctx, pag.kv_mode,
            pag.page_size, pag.prompt_words, pag.prompt_tokens) == (
        8, 8, 32, 512, "paged", 64, 2, 0)
    for tool, bad in (("profile_decode", ["--hlo", "x"]),
                      ("profile_decode", ["--copt", "a=b"]),
                      ("profile_decode", ["--dims", "30b"]),
                      ("profile_paged", ["--kv-mode", "flat"])):
        with pytest.raises(SystemExit):
            load_tool(tool).parse_args(bad)


def test_build_prompt_tokens_reaches_its_target():
    from fastllama_tpu_torch.engine.tokenizer import tokenize
    tu = load_tool("_trace_util")
    vocab = tu.bench_vocab()
    assert vocab.size == 259 + 741
    prompt = tu.build_prompt_tokens(vocab, 100)
    n = len(tokenize(vocab, " " + prompt, bos=True))
    assert n >= 100 and len(prompt.split()) % 8 == 0


def test_bench_reference_writes_the_jax_tools_file(tmp_path, monkeypatch):
    """gen_model at a tiny size writes the JAX tool's bytes (the JAX tool's
    7B HyperParams swapped for the tiny one)."""
    from fastllama_tpu.config import FType as JFType
    from fastllama_tpu.config import HyperParams as JHyperParams
    from fastllama_tpu_torch.config import FType, HyperParams
    from tools import bench_reference as j_ref
    dims = dict(n_vocab=300, n_ctx=64, n_embd=64, n_mult=32, n_head=4,
                n_layer=2, n_rot=16)
    monkeypatch.setattr(j_ref, "HyperParams", lambda **kw: JHyperParams(
        **dims, ftype=JFType.MOSTLY_Q4_0))
    j_ref.gen_model(str(tmp_path / "jax.bin"))
    load_tool("bench_reference").gen_model(
        str(tmp_path / "torch.bin"),
        HyperParams(**dims, ftype=FType.MOSTLY_Q4_0))
    assert (tmp_path / "jax.bin").read_bytes() == \
        (tmp_path / "torch.bin").read_bytes()
