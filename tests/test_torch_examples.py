"""PyTorch port: the Python examples (examples_torch/python/) run on a tiny
synthetic q4_0 GGJT file with the CPU device, fed through stdin where they
read input; no download. Each names the CUDA card as its default device,
and none imports JAX or the JAX package (test_torch_isolation.py)."""
import ast
import io
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastllama_tpu_torch.io import ggml_writer as tw
from test_torch_ggml_io import HP, build_tensors, tiny_vocab

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch" / "python"
NAMES = ("example.py", "example-alpaca.py", "example-batch.py",
         "example-logging.py", "example-lora-adapter.py",
         "example-save-load.py", "example-vicuna.py", "perplexity.py",
         "webui_srv.py")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples")
    model = d / "tiny-q4_0.bin"
    tw.write_ggjt(model, HP, tiny_vocab(), build_tensors("q4_0"))
    rng = np.random.default_rng(3)
    adapter = d / "adapter.bin"
    tw.write_ggla(adapter, 4, 8, False, {
        "layers.1.attention.wv.weight.loraA":
            (rng.standard_normal((HP.n_embd, 4)) * 0.1).astype(np.float32),
        "layers.1.attention.wv.weight.loraB":
            (rng.standard_normal((HP.n_embd, 4)) * 0.1).astype(np.float32)})
    text = d / "text.txt"
    text.write_text(" ".join(f"t{i % 37}" for i in range(150)))
    return {"model": str(model), "adapter": str(adapter), "text": str(text)}


def run_example(name, argv, monkeypatch, tmp_path, stdin=None):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")


def test_the_nine_examples_are_ported():
    assert sorted(p.name for p in EXAMPLES.glob("*.py")) == sorted(NAMES)
    for name in NAMES:
        tree = ast.parse((EXAMPLES / name).read_text())
        mods = [n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)]
        assert any(m and m.startswith("fastllama_tpu_torch") for m in mods)


def test_batch(files, monkeypatch, tmp_path, capsys):
    run_example("example-batch.py", [files["model"], "cpu"], monkeypatch,
                tmp_path)
    out = capsys.readouterr().out
    assert out.count("=== ") == 6 and "'The capital of France is'" in out


def test_save_load(files, monkeypatch, tmp_path, capsys):
    run_example("example-save-load.py", [files["model"], "cpu"], monkeypatch,
                tmp_path)
    out = capsys.readouterr().out
    assert (tmp_path / "model_state.npz").exists()
    assert "Restoring saved session" in out and "Continuing restored" in out


def test_lora_adapter_through_stdin(files, monkeypatch, tmp_path, capsys):
    run_example("example-lora-adapter.py",
                [files["model"], files["adapter"], "cpu"], monkeypatch,
                tmp_path, stdin="load_lora\nt1 t2\nunload_lora\nreset\nexit\n")
    out = capsys.readouterr().out
    assert "attached" in out and "detached" in out and "session reset" in out
    assert "Assistant: " in out


def test_logging(files, monkeypatch, tmp_path, capsys):
    run_example("example-logging.py", [files["model"], "cpu"], monkeypatch,
                tmp_path)
    assert "fastllama.log" in capsys.readouterr().out
    assert (tmp_path / "fastllama.log").read_text()


def test_perplexity(files, monkeypatch, tmp_path, capsys):
    run_example("perplexity.py", [files["model"], files["text"], "cpu"],
                monkeypatch, tmp_path)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("Final perplexity: ")
    assert np.isfinite(float(line.split(": ")[1]))


@pytest.mark.parametrize("name", ["example.py", "example-alpaca.py",
                                  "example-vicuna.py"])
def test_chat_examples_default_to_the_card(files, monkeypatch, tmp_path,
                                           name):
    """The interactive chats take the device after the model path; without
    it they run on the card, and with no card they raise rather than fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        run_example(name, [files["model"]], monkeypatch, tmp_path,
                    stdin="exit\n")


def test_webui_server_reports_the_missing_websockets(monkeypatch, tmp_path,
                                                     capsys):
    """webui_srv imports websockets lazily: without the package (hidden
    here where it is installed) it says so and exits 1 before it loads
    anything."""
    monkeypatch.setitem(sys.modules, "websockets", None)
    with pytest.raises(SystemExit) as e:
        run_example("webui_srv.py", ["--device", "cpu"], monkeypatch,
                    tmp_path)
    assert e.value.code == 1
    assert "websockets" in capsys.readouterr().err
