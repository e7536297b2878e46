"""PyTorch port: neither the package nor chip_smoke.py imports JAX or the
JAX package."""
import ast
import json
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
    assert len(res["mods"]) >= 17
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
    (ROOT / "fastllama_tpu_torch").rglob("*.py")), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    assert [n for n in _imports(path) if _forbidden(n)] == []
