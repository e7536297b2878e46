"""PyTorch port: neither the package, chip_smoke.py nor the scripts under
tools_torch/ import JAX or the JAX package, and the C++ sources of the
port's native libraries (the Python the C ABI embeds, its capsule name)
name neither."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "fastllama_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_package_imports_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import fastllama_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps({'mods': mods, 'loaded': sorted(sys.modules)}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert len(res["mods"]) >= 40
    for mod in ("engine.scheduler", "engine.paged_kv", "engine.sampling",
                "kernels.paged_attention", "kernels.kv_write",
                "kernels.flash_prefill", "native",
                "quant.native", "io.convert", "utils.trace", "parallel",
                "parallel.sharding", "parallel.ring", "parallel.multihost",
                "parallel.collectives"):
        assert f"fastllama_tpu_torch.{mod}" in res["mods"]
    leaked = [m for m in res["loaded"] if _forbidden(m)]
    assert leaked == []


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "fastllama_tpu_torch").rglob("*.py")) + sorted(
    (ROOT / "tools_torch").glob("*.py")), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    assert [n for n in _imports(path) if _forbidden(n)] == []


NATIVE_SOURCES = sorted((ROOT / "fastllama_tpu_torch" / "native").glob("*.cpp"))
PORT_TOOLS = [ROOT / "tools_torch" / f"{n}.py" for n in (
    "quantize", "convert", "convert_lora", "export_hf", "chat")]


@pytest.mark.parametrize("path", NATIVE_SOURCES + PORT_TOOLS,
                         ids=lambda p: p.name)
def test_native_sources_and_tools_name_no_jax(path):
    """No `jax` and no `fastllama_tpu` other than `fastllama_tpu_torch`, as
    a word, anywhere in the file: the C ABI's embedded Python imports and
    its capsule name included."""
    text = path.read_text()
    assert re.findall(r"\bjax\b", text) == []
    assert re.findall(r"\bfastllama_tpu\b(?!_torch)", text) == []


def test_c_abi_embeds_the_port():
    src = (ROOT / "fastllama_tpu_torch" / "native" / "c_api.cpp").read_text()
    helper = src[src.index('R"PY('):src.index(')PY"')]
    assert "fastllama_tpu_torch.Model(" in helper
    assert "from fastllama_tpu_torch.engine.logger import Logger" in helper
    assert 'kCapName = "fastllama_tpu_torch.cptr"' in src
