"""Build the port's host-side native libraries with g++ at first use.

Two libraries, each built from this directory's sources into the
git-ignored `native/_build/` the first time it is asked for, never at
import time:

  * `build_native()` -> libfastllama_native.so, the threaded q4_0 repack and
    quantizer (fastllama_native.cpp), bound with ctypes by quant/native.py;
  * `build_c_abi()` -> libfastllama_c.so, the C ABI (c_api.cpp +
    fastllama_c.h), which embeds CPython over fastllama_tpu_torch.Model.
    C programs compile against `HEADER_DIR` and link with
    `-L<directory of the path> -lfastllama_c`.

A library lives in a directory whose name carries a hash of its sources,
flags and the CPU's features, so a changed source is rebuilt, and processes that build at once
(test workers) never read a half-written file: each builds in a directory
of its own and renames it.
"""
from __future__ import annotations

import hashlib
import os
import platform
import shlex
import shutil
import subprocess
import sysconfig
import time
from pathlib import Path

HEADER_DIR = Path(__file__).resolve().parent
BUILD_DIR = HEADER_DIR / "_build"

CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-march=native", "-Wall"]
LDFLAGS = ["-shared", "-pthread"]

build_seconds: dict[str, float] = {}   # compile wall time per library stem,
                                       # for the builds this process ran


def compiler() -> str | None:
    """The C++ compiler (g++ or $CXX), or None when the machine has none."""
    return shutil.which(os.environ.get("CXX", "g++"))


def _cpu_id() -> bytes:
    """What -march=native compiles for: the CPU's feature flags (Linux), so
    a build directory copied from another machine is not reused there."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.processor().encode()


def _build(stem: str, sources: list[str], flags: list[str]) -> Path:
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the port's native "
                           "libraries")
    h = hashlib.sha256()
    for src in sources:
        h.update((HEADER_DIR / src).read_bytes())
    h.update((HEADER_DIR / "fastllama_c.h").read_bytes())
    h.update(" ".join([cxx] + flags).encode())
    h.update(_cpu_id())
    out_dir = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}"
    out = out_dir / f"lib{stem}.so"
    if out.exists():
        return out
    tmp_dir = out_dir.with_name(f"{out_dir.name}.{os.getpid()}.tmp")
    tmp_dir.mkdir(parents=True, exist_ok=True)
    # flags after the sources: the linker resolves -lpython after c_api.o
    cmd = [cxx, *(str(HEADER_DIR / s) for s in sources), "-o",
           str(tmp_dir / out.name), *flags]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[stem] = time.perf_counter() - t0
    if r.returncode != 0:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise RuntimeError(f"building lib{stem}.so failed:\n"
                           f"{shlex.join(cmd)}\n{r.stderr}")
    try:
        os.replace(tmp_dir, out_dir)
    except OSError:                 # another process finished it first
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return out


def build_native() -> Path:
    """Compile (where needed) the threaded repack/quantizer; its path."""
    return _build("fastllama_native", ["fastllama_native.cpp"],
                  CXXFLAGS + LDFLAGS)


def python_config() -> list[str]:
    """python3-config of this interpreter's version, as on PATH."""
    ver = sysconfig.get_config_var("VERSION") or "3"
    found = shutil.which(f"python{ver}-config") or shutil.which(
        "python3-config")
    if found is None:
        raise RuntimeError("python3-config not found: the C ABI embeds "
                           "CPython and needs its headers and libpython")
    return [found]


def embed_flags() -> list[str]:
    """`python3-config --includes` and `--ldflags --embed`, plus an rpath to
    the directory of libpython so a C program finds it at run time."""
    cfg = python_config()
    inc = subprocess.run(cfg + ["--includes"], capture_output=True,
                         text=True, check=True).stdout.split()
    ld = subprocess.run(cfg + ["--ldflags", "--embed"], capture_output=True,
                        text=True, check=True).stdout.split()
    libdir = sysconfig.get_config_var("LIBDIR")
    return inc + ld + ([f"-Wl,-rpath,{libdir}"] if libdir else [])


def build_c_abi() -> Path:
    """Compile (where needed) libfastllama_c.so from c_api.cpp; its path."""
    return _build("fastllama_c", ["c_api.cpp"],
                  CXXFLAGS + LDFLAGS + embed_flags())


def c_program_env(lib_dir, base: dict | None = None) -> dict:
    """Environment for a C program linked to the C ABI in `lib_dir`: the
    embedded interpreter must find this repository and the running
    interpreter's site-packages (it does not see a virtualenv by itself),
    and the loader the C ABI and libpython."""
    env = dict(os.environ if base is None else base)
    repo = str(HEADER_DIR.parents[1])
    paths = [repo, sysconfig.get_paths()["purelib"],
             sysconfig.get_paths()["platlib"]]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    libs = [str(lib_dir), sysconfig.get_config_var("LIBDIR") or ""]
    if env.get("LD_LIBRARY_PATH"):
        libs.append(env["LD_LIBRARY_PATH"])
    env["LD_LIBRARY_PATH"] = ":".join(d for d in libs if d)
    return env
