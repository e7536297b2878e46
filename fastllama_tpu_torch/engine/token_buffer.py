"""Streaming detokenizer buffer with stop-word scanning.

Re-implements the reference TokenBuffer semantics (include/token_buffer.hpp):
generated tokens are held back just long enough to (a) detect stop words that
span token boundaries and (b) withhold trailing bytes of incomplete UTF-8
sequences until their continuation arrives. On a stop-word hit, the text
before the stop word is flushed, the text after it is stashed as partial
state, and generation can resume later without re-emitting or losing bytes
(TokenBufferPartialState, token_buffer.hpp:14-20).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

from .tokenizer import Vocab, utf8_len


@dataclasses.dataclass
class TokenBufferPartialState:
    left_out: bytes = b""
    unicode_backlog: bytes = b""


def _split_trailing_incomplete_utf8(data: bytes) -> tuple[bytes, bytes]:
    """Split off an incomplete trailing UTF-8 sequence.

    Mirrors check_and_put_unicode_char_in_buffer_if_invalid
    (token_buffer.hpp:108-134): walk by utf8_len; if the last character's
    declared length overruns the buffer, hold those bytes back.
    """
    if not data:
        return data, b""
    i = 0
    last_i = 0
    ln = 0
    n = len(data)
    while i < n:
        ln = utf8_len(data[i])
        last_i = i
        i += ln
    if last_i + ln > n:
        return data[:last_i], data[last_i:]
    return data, b""


class TokenBuffer:
    """Holds up to `max_buffer_size` pending tokens before flushing text."""

    def __init__(self, vocab: Vocab, max_buffer_size: int,
                 fn: Callable[[str], None]):
        self._vocab = vocab
        self._max = max_buffer_size
        self._fn = fn
        self._buffer: list[int] = []
        self._backlog = b""

    def _emit(self, data: bytes) -> None:
        if not self._backlog and not data:
            return
        data = self._backlog + data
        self._backlog = b""
        out, backlog = _split_trailing_incomplete_utf8(data)
        self._backlog = backlog
        if out:
            self._fn(out.decode("utf-8", errors="replace"))

    def add(self, token_id: int) -> None:
        if len(self._buffer) >= self._max:
            self.flush_one()
        self._buffer.append(token_id)

    def flush_one(self) -> None:
        if not self._buffer:
            return
        tid = self._buffer.pop(0)
        self._emit(self._vocab.token_bytes(tid))

    def flush_all(self) -> None:
        while self._buffer:
            self.flush_one()
        # NOTE: a still-incomplete trailing UTF-8 sequence stays in the
        # backlog (matching the reference, which never force-flushes it).

    def scan_stop_words(self, stop_words: Iterable[bytes]
                        ) -> tuple[bool, bytes, bytes]:
        """Check whether any stop word appears in the buffered text.

        Returns (found, text_before_stop, text_after_stop). The buffered
        backlog participates in the scan (token_buffer.hpp:54-81).
        """
        stop_words = list(stop_words)
        if not stop_words:
            return False, b"", b""
        text = self._backlog + b"".join(
            self._vocab.token_bytes(t) for t in self._buffer)
        for w in stop_words:
            pos = text.find(w)
            if pos != -1:
                return True, text[:pos], text[pos + len(w):]
        return False, b"", b""

    def get_partial_state(self) -> TokenBufferPartialState:
        return TokenBufferPartialState(unicode_backlog=self._backlog)

    def restore_partial_state(self, state: TokenBufferPartialState) -> None:
        """Resume after a stop: emit the held-back remainder first."""
        if state.left_out:
            out, backlog = _split_trailing_incomplete_utf8(state.left_out)
            self._backlog = backlog
            if out:
                self._fn(out.decode("utf-8", errors="replace"))
            state.left_out = b""
        else:
            self._backlog = state.unicode_backlog

    def clear(self) -> None:
        self._buffer.clear()
        self._backlog = b""
