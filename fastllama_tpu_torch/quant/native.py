"""ctypes binding for the native host kernels, with numpy fallbacks.

The port's copy of the JAX package's quant/native.py. The shared library
(native/fastllama_native.cpp) is built with g++ on first use
(native.build_native); on a machine without a C++ compiler every entry
point falls back to the (slower) numpy implementation, which gives the
same bytes. A compiler that fails on the source raises: that is a fault,
not a platform without the library.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .q4 import QK4_0, quantize_q4_0 as _np_quantize_q4_0

_LIB = None
_TRIED = False
_LOAD_LOCK = threading.Lock()


def _load():
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        return _load_locked()


def _load_locked():
    """Under _LOAD_LOCK: the parallel loader calls _load from worker
    threads. `_LIB` is assigned BEFORE `_TRIED = True` (the very last
    statement), so the lock-free fast path in `_load` can never observe
    `_TRIED=True` with `_LIB` still unset mid-build: that half-state would
    let concurrent loader threads take the numpy path and mix repack kinds
    within one fused weight group."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    from .. import native
    lib = None
    if native.compiler() is not None:
        lib = ctypes.cdll.LoadLibrary(str(native.build_native()))
        lib.flt_repack_q4_wire.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int]
        lib.flt_repack_q4_wire.restype = None
        lib.flt_quantize_q4_0.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.flt_quantize_q4_0.restype = None
    _LIB = lib
    _TRIED = True  # publish LAST: the fast path reads (_TRIED, _LIB) lock-free
    return _LIB


def available() -> bool:
    return _load() is not None


def _nthreads() -> int:
    return min(8, os.cpu_count() or 1)


def repack_q4_wire(wire: np.ndarray, n: int, k: int,
                   n_pad: int, k_pad: int):
    """ggml q4_0 wire bytes [n rows of k] -> padded device planes
    (qs [k_pad/2, n_pad] uint8, scales [k_pad/32, n_pad] f32), or None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    wire = np.ascontiguousarray(wire, dtype=np.uint8)
    if k % QK4_0 or wire.size != n * (k // QK4_0) * (4 + QK4_0 // 2):
        raise ValueError(f"q4_0 wire of {wire.size} bytes is not [{n}, {k}]")
    if n_pad < n or k_pad < k or k_pad % QK4_0:
        raise ValueError(f"padded dims ({k_pad}, {n_pad}) below ({k}, {n})")
    qs = np.empty((k_pad // 2, n_pad), np.uint8)
    scales = np.empty((k_pad // QK4_0, n_pad), np.float32)
    lib.flt_repack_q4_wire(
        wire.ctypes.data, n, k, n_pad, k_pad,
        qs.ctypes.data, scales.ctypes.data, _nthreads())
    return qs, scales


def quantize_q4_0(x: np.ndarray):
    """Threaded bit-exact q4_0 quantization; numpy fallback when the native
    library is missing. Same output contract as quant.q4.quantize_q4_0."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    if lib is None or x.ndim != 2:
        return _np_quantize_q4_0(x)
    rows, k = x.shape
    if k % QK4_0:
        raise ValueError(f"q4_0 rows of {k} values are not whole blocks")
    codes = np.empty((rows, k), np.uint8)
    scales = np.empty((rows, k // QK4_0), np.float32)
    lib.flt_quantize_q4_0(x.ctypes.data, rows, k,
                          codes.ctypes.data, scales.ctypes.data, _nthreads())
    return codes, scales
