"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Every `csrc/*.cu` file is compiled on first use, one `nvcc` process per
source, all started together, into `kernels/_build/` (listed in
.gitignore), for `sm_90a` with plain C entry points. A library is rebuilt
only when its source, a header under csrc/ or the flags change: the file
name carries a hash of all three. Nothing here runs at import time, so the
CPU tests import every module without a compiler.

Each C entry point returns the CUDA error code of its launches;
`check(rc, name)` turns a nonzero code into an exception. Pointers are
passed as ctypes.c_void_p and the stream is PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("quant_rows", "q4_int8", "q4_prefill",
           "decode_attention", "paged_attention", "kv_write",
           "flash_prefill", "paged_flash", "q4_fold", "q4_fold_v0",
           "q4_fold_v2", "q4_fold_v3", "q4_fold_v7", "q4_fold_v9",
           "q4_fold_f32", "q4_fold_probe")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
L = ctypes.c_longlong
# the entry of each build of csrc/q4_fold.cuh (one a variant; the probes'
# build has two, which read no scales, and the f32 modes' build two; the
# q4_1 variants 9 and 11 take the mins plane after the scales)
FOLD_ARGS = [P, I, I, P, P, I, I, I, I, I, I, I, I, I, I, I, P, I, P, P]
FOLD_MINS_ARGS = FOLD_ARGS[:5] + [P] + FOLD_ARGS[5:]
ARGTYPES = {
    "q4_fold_gemm": FOLD_ARGS, "q4_fold_v0_gemm": FOLD_ARGS,
    "q4_fold_v2_gemm": FOLD_ARGS,
    "q4_fold_v3_gemm": FOLD_ARGS, "q4_fold_v7_gemm": FOLD_ARGS,
    "q4_fold_floor_gemm": FOLD_ARGS, "q4_fold_nosc_gemm": FOLD_ARGS,
    "q4_fold_v9_gemm": FOLD_MINS_ARGS,
    "q4_fold_f32_gemm": FOLD_ARGS, "q4_fold_f32a_gemm": FOLD_MINS_ARGS,
    "q4_fold_clusters": [I],
    "quant_rows_int8": [P, I, I, I, P, P, P],
    "q4_int8_gemm": [P, P, I, I, P, P, I, I, I, I, I, I, I, P, P, P, I, P],
    "q4_int8_gemm_natx": [P, P, I, I, P, P, I, P, I, P],
    "q4_int8_natx_clusters": [I],
    "q4_prefill_gemm": [P, I, I, P, P, P, I, I, P, I, I, I, I, I, I, P, P,
                        P, I, I, P],
    "q4_prefill_split_gemm": [P, I, I, P, P, I, I, P, P, I, I, I, P, P, P,
                              I, P],
    "decode_attention_fused": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                               F, I, P, P],
    "decode_attention": [P, P, P, P, I, I, I, I, I, I, I, I, I, F, I, P, P],
    "paged_decode_attention": [P, I, I, P, P, P, P, I, I, I, I, I, I, I, I,
                               I, I, I, F, I, P, P],
    "paged_decode_attention_flat": [P, I, I, P, P, P, P, I, I, I, I, I, I, I,
                                    I, I, I, I, F, I, P, P],
    "paged_decode_step_fused": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                I, I, I, I, I, F, I, P, P],
    "decode_attention_set_pdl": [I], "paged_attention_set_pdl": [I],
    "paged_kv_write": [P, P, P, P, P, P, I, I, I, I, I, I, P],
    "paged_kv_write_rows": [P, P, P, P, P, I, I, I, I, I, P],
    "slab_write_rows": [P, P, P, I, I, I, I, L, L, P],
    "paged_attention_tpu": [P, L, P, P, P, P, I, I, I, I, I, I, I, F, I, I,
                            P, P, P, P],
    "paged_attention_tpu_fused": [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                  I, I, F, I, I, P, P, P, P],
    "paged_flash_partial_floats": [I, I],
    "paged_flash_counters": [I, I, I],
    "flash_prefill": [P, P, P, L, L, L, L, L, L, L, L, L, I, I, I, I, I, I,
                      I, F, P, P, P, P],
}
LIB_OF = {"q4_fold_gemm": "q4_fold", "q4_fold_clusters": "q4_fold",
          "q4_fold_v0_gemm": "q4_fold_v0",
          "q4_fold_v2_gemm": "q4_fold_v2",
          "q4_fold_v3_gemm": "q4_fold_v3",
          "q4_fold_v7_gemm": "q4_fold_v7",
          "q4_fold_v9_gemm": "q4_fold_v9",
          "q4_fold_f32_gemm": "q4_fold_f32",
          "q4_fold_f32a_gemm": "q4_fold_f32",
          "q4_fold_floor_gemm": "q4_fold_probe",
          "q4_fold_nosc_gemm": "q4_fold_probe",
          "quant_rows_int8": "quant_rows", "q4_int8_gemm": "q4_int8",
          "q4_int8_gemm_natx": "q4_int8",
          "q4_int8_natx_clusters": "q4_int8",
          "q4_prefill_gemm": "q4_prefill",
          "q4_prefill_split_gemm": "q4_prefill",
          "decode_attention_fused": "decode_attention",
          "decode_attention": "decode_attention",
          "paged_decode_attention": "paged_attention",
          "paged_decode_attention_flat": "paged_attention",
          "paged_decode_step_fused": "paged_attention",
          "decode_attention_set_pdl": "decode_attention",
          "paged_attention_set_pdl": "paged_attention",
          "paged_kv_write": "kv_write", "paged_kv_write_rows": "kv_write",
          "slab_write_rows": "kv_write",
          "flash_prefill": "flash_prefill",
          "paged_attention_tpu": "paged_flash",
          "paged_attention_tpu_fused": "paged_flash",
          "paged_flash_partial_floats": "paged_flash",
          "paged_flash_counters": "paged_flash"}

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None   # wall time of the last build() call
build_log: dict[str, str] = {}       # nvcc output (-Xptxas -v) per source


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda)")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, ctypes.CDLL]:
    """Compile (where needed) and load every kernel library."""
    global build_seconds
    if len(_libs) == len(SOURCES):
        return _libs
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in SOURCES:
        _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in ARGTYPES.items():
        cfn = getattr(_libs[LIB_OF[fn]], fn)
        cfn.argtypes = argtypes
        cfn.restype = ctypes.c_int
    build_seconds = time.perf_counter() - t0
    return _libs


def fn(name: str):
    """The C entry point `name`, building the libraries on first use."""
    return getattr(build()[LIB_OF[name]], name)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError_t {rc}")


# Every kernel wrapper registers its count here: (wrapper, attribute), the
# attribute a plain int the wrapper adds one to where it launches its
# kernel ("launches"; the dequant path's "cuda_calls"). utils/step_graph
# reads them around a capture and adds a graph's launches at each replay.
COUNTED: list[tuple[object, str]] = []


def counted(wrapper, attr: str = "launches"):
    """Register `wrapper`'s count `attr`, starting at 0."""
    setattr(wrapper, attr, 0)
    COUNTED.append((wrapper, attr))
    return wrapper


def counts() -> list[int]:
    """Every registered count, in COUNTED's order."""
    return [getattr(w, a) for w, a in COUNTED]


# Per-device scratch shared by every launch on that device, so such launches
# must stay on one stream (they are stream-ordered there). A captured graph
# holds the buffers it was captured with (buffers()), so a later eager
# launch that grows one never frees memory a graph still writes.
_counters: dict[int, object] = {}
_scratch: dict[tuple[int, str], object] = {}


def buffers() -> list:
    """The tile counters and scratch tensors that exist now, every device."""
    return [*_counters.values(), *_scratch.values()]


def tile_counters(device, n: int):
    """n zeroed int32 counters on `device` for kernels that elect a last
    block per output tile; each kernel leaves them zeroed again."""
    import torch
    buf = _counters.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1 << 16), dtype=torch.int32, device=device)
        _counters[device.index] = buf
    return buf


def scratch(device, name: str, n: int, dtype):
    """A scratch tensor of n `dtype` elements on `device`, one per name
    (contents undefined), reused by the next launch on the stream."""
    import torch
    nbytes = n * dtype.itemsize
    key = (device.index, name)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                          device=device)
        _scratch[key] = buf
    return buf[:nbytes].view(dtype)


_sms: dict[int, int] = {}


def sm_count(device) -> int:
    """The card's SM count (132 on the H100 SXM), read once per device."""
    n = _sms.get(device.index)
    if n is None:
        import torch
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sms[device.index] = n
    return n


def stream_handle(device) -> int:
    """PyTorch's current stream on `device`, as the raw cudaStream_t."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)
