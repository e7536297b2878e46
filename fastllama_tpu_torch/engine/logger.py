"""Pluggable logger + progress protocol.

Same callback surface as the reference Logger (include/logger.hpp:102-164)
and its Python marshalling (interfaces/python/fastllama.py:107-192): four
text channels (info / error / warn / reset) plus a phase-tagged progress
channel driving progress bars. No FFI here — plain Python callables.
"""
from __future__ import annotations

import enum
import sys
import time
from typing import Callable, Optional


class ProgressTag(enum.IntEnum):
    """Phases reported via progress callbacks (include/logger.hpp:12-20)."""
    UNKNOWN = 0
    INIT = 1
    LOAD = 2
    SAVE = 3
    INGEST = 4
    ATTACH_LORA = 5
    DETACH_LORA = 6
    QUANTIZE = 7      # new phase (offline quantizer tool)


class Logger:
    def __init__(self,
                 log_fn: Optional[Callable[[str, str], None]] = None,
                 log_err_fn: Optional[Callable[[str, str], None]] = None,
                 log_warn_fn: Optional[Callable[[str, str], None]] = None,
                 reset_fn: Optional[Callable[[], None]] = None,
                 progress_fn: Optional[Callable[[ProgressTag, int, int], None]] = None):
        self._log = log_fn
        self._err = log_err_fn
        self._warn = log_warn_fn
        self._reset = reset_fn
        self._progress = progress_fn

    def log(self, func_name: str, *parts) -> None:
        if self._log:
            self._log(func_name, "".join(str(p) for p in parts))

    def log_err(self, func_name: str, *parts) -> None:
        if self._err:
            self._err(func_name, "".join(str(p) for p in parts))

    def log_warn(self, func_name: str, *parts) -> None:
        if self._warn:
            self._warn(func_name, "".join(str(p) for p in parts))

    def reset(self) -> None:
        if self._reset:
            self._reset()

    def progress(self, tag: ProgressTag, done: int, total: int) -> None:
        if self._progress:
            self._progress(tag, done, total)


class DefaultLogger(Logger):
    """Prints like the reference DefaultLogger (logger.hpp:36-75)."""

    def __init__(self, stream=None):
        super().__init__()
        self._stream = stream or sys.stderr
        self._last_progress = 0.0

    def log(self, func_name: str, *parts) -> None:
        print(f"[Info]: Func('{func_name}') {''.join(str(p) for p in parts)}",
              file=self._stream, end="")

    def log_err(self, func_name: str, *parts) -> None:
        print(f"[Error]: Func('{func_name}') {''.join(str(p) for p in parts)}",
              file=self._stream, end="")

    def log_warn(self, func_name: str, *parts) -> None:
        print(f"[Warn]: Func('{func_name}') {''.join(str(p) for p in parts)}",
              file=self._stream, end="")

    def progress(self, tag: ProgressTag, done: int, total: int) -> None:
        now = time.time()
        if total and (done >= total or now - self._last_progress > 0.25):
            self._last_progress = now
            pct = 100.0 * done / total
            print(f"\r[{tag.name}] {pct:5.1f}% ({done}/{total})",
                  file=self._stream, end="\n" if done >= total else "")


NULL_LOGGER = Logger()
