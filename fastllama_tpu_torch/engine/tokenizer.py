"""SentencePiece-style tokenizer: greedy highest-score bigram merging.

Same algorithm as the reference (include/tokenizer.hpp:74-166): split text
into UTF-8 characters, repeatedly merge the adjacent pair whose concatenation
is the vocab token with the highest score (ties broken toward the leftmost
pair), then emit token ids; spans not in the vocab fall back to raw bytes with
id = byte + 3 (tokenizer.hpp:130-133). BOS id 1 is prepended when requested
(tokenizer.hpp:168-177). Host-side Python — tokenization is not on the GPU
hot path.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable

BOS_ID = 1
EOS_ID = 2
BYTE_FALLBACK_OFFSET = 3

_UTF8_LEN = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4]


def utf8_len(first_byte: int) -> int:
    return _UTF8_LEN[first_byte >> 4]


@dataclasses.dataclass
class Vocab:
    """id -> (token bytes, score) plus the reverse map.

    Token text is kept as bytes: ggml vocab entries are raw byte strings and
    merges operate on byte concatenation (include/vocab.hpp:14-42).
    """
    id_to_token: list[tuple[bytes, float]]
    token_to_id: dict[bytes, int]

    @classmethod
    def from_tokens(cls, tokens: Iterable[tuple[bytes, float]]) -> "Vocab":
        id_to_token = list(tokens)
        token_to_id: dict[bytes, int] = {}
        for i, (tok, _score) in enumerate(id_to_token):
            token_to_id[tok] = i
        return cls(id_to_token, token_to_id)

    def token_bytes(self, token_id: int) -> bytes:
        if 0 <= token_id < len(self.id_to_token):
            return self.id_to_token[token_id][0]
        return b""

    @property
    def size(self) -> int:
        return len(self.id_to_token)


def tokenize(vocab: Vocab, text: str | bytes, bos: bool = False) -> list[int]:
    """Tokenize text. Matches the reference tokenizer's output exactly."""
    if isinstance(text, str):
        data = text.encode("utf-8")
    else:
        data = bytes(text)
    out: list[int] = []
    if not data:
        return out
    if bos:
        out.append(BOS_ID)

    # initial symbols: utf-8 characters as (start, end) byte spans
    spans: list[tuple[int, int]] = []
    i = 0
    n = len(data)
    while i < n:
        ln = min(n - i, utf8_len(data[i]))
        spans.append((i, i + ln))
        i += ln

    m = len(spans)
    prev = list(range(-1, m - 1))
    nxt = [i + 1 if i + 1 < m else -1 for i in range(m)]
    alive = [True] * m
    # span text per symbol (mutated on merge)
    start = [s for s, _ in spans]
    end = [e for _, e in spans]

    # priority queue of candidate merges: (-score, left_index, merged_len)
    # Reference comparator (tokenizer.hpp:62-66): higher score wins; equal
    # scores -> smaller left index wins.
    heap: list[tuple[float, int, int]] = []

    def try_add(left: int, right: int) -> None:
        if left == -1 or right == -1:
            return
        merged = data[start[left]:end[right]]
        tid = vocab.token_to_id.get(merged)
        if tid is None:
            return
        score = vocab.id_to_token[tid][1]
        heapq.heappush(heap, (-score, left, len(merged)))

    for i in range(1, m):
        try_add(i - 1, i)

    while heap:
        neg_score, left, size = heapq.heappop(heap)
        if not alive[left]:
            continue
        right = nxt[left]
        if right == -1 or not alive[right]:
            continue
        if (end[right] - start[left]) != size:
            continue  # stale entry: spans changed since queued
        # merge right into left
        end[left] = end[right]
        alive[right] = False
        nxt[left] = nxt[right]
        if nxt[right] != -1:
            prev[nxt[right]] = left
        try_add(prev[left], left)
        try_add(left, nxt[left])

    i = 0
    while i != -1:
        if alive[i]:
            span = data[start[i]:end[i]]
            tid = vocab.token_to_id.get(span)
            if tid is not None:
                out.append(tid)
            else:
                for b in span:
                    out.append(b + BYTE_FALLBACK_OFFSET)
        i = nxt[i]
    return out


def detokenize(vocab: Vocab, ids: Iterable[int]) -> bytes:
    return b"".join(vocab.token_bytes(i) for i in ids)
