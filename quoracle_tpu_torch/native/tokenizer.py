"""Byte-level BPE: a ctypes binding over bpe.cpp and the identical
pure-Python path.

The port's copy of ``quoracle_tpu/native/tokenizer.py``. Both paths read
``models/bpe_merges.txt``, a byte-identical copy of the JAX package's
merges, so ids match the JAX package exactly. The shared object builds at
first use (``native.build_and_load``); the Python path serves only when
that build fails, and the failure is logged.
"""

from __future__ import annotations

import ctypes
import heapq
import logging
import os
from functools import lru_cache
from typing import Sequence

from quoracle_tpu_torch.models.tokenizer import Tokenizer
from quoracle_tpu_torch.native import build_and_load

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
MERGES_PATH = os.path.join(os.path.dirname(_DIR), "models",
                           "bpe_merges.txt")
SRC_PATH = os.path.join(_DIR, "bpe.cpp")

N_SPECIALS = 3
BYTE_BASE = N_SPECIALS              # byte b -> id b + BYTE_BASE
FIRST_MERGE_ID = BYTE_BASE + 256
MAX_WORD_LEN = 128


@lru_cache(maxsize=1)
def _load_native():
    """(lib, handle), or None when the build failed."""
    lib = build_and_load(SRC_PATH)
    if lib is None:
        return None
    lib.qt_bpe_load.restype = ctypes.c_void_p
    lib.qt_bpe_load.argtypes = [ctypes.c_char_p]
    lib.qt_bpe_encode.restype = ctypes.c_int64
    lib.qt_bpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    handle = lib.qt_bpe_load(MERGES_PATH.encode())
    if not handle:
        logger.warning("bpe.cpp could not read %s; using the Python "
                       "fallback", MERGES_PATH)
        return None
    return lib, ctypes.c_void_p(handle)


def native_available() -> bool:
    return _load_native() is not None


# ---------------------------------------------------------------------------
# Pure-Python implementation (lockstep with bpe.cpp)
# ---------------------------------------------------------------------------

def pre_split(text: str) -> list[bytes]:
    """Split text into merge units: a run of whitespace binds to the word
    that follows it (GPT-2 style ' word' units) so merges never cross word
    boundaries. Long runs are capped so pathological inputs stay O(n)."""
    words: list[bytes] = []
    data = text.encode("utf-8")
    start = 0
    in_space = True
    for i, b in enumerate(data):
        is_space = b in (0x20, 0x09, 0x0A, 0x0D)
        if is_space and not in_space:
            words.append(data[start:i])
            start = i
        elif b == 0x0A:                      # newline always closes a unit
            words.append(data[start:i + 1])
            start = i + 1
            in_space = True
            continue
        if i - start >= MAX_WORD_LEN:
            words.append(data[start:i])
            start = i
        in_space = is_space
    if start < len(data):
        words.append(data[start:])
    return [w for w in words if w]


def load_merges(path: str) -> list[tuple[int, int]]:
    merges = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            a, b = line.split()
            merges.append((int(a), int(b)))
    return merges


@lru_cache(maxsize=1)
def _python_tables():
    merges = load_merges(MERGES_PATH)
    ranks = {pair: i for i, pair in enumerate(merges)}
    expansions: list[bytes] = [b""] * FIRST_MERGE_ID
    for b in range(256):
        expansions[BYTE_BASE + b] = bytes([b])
    for a, b in merges:
        expansions.append(expansions[a] + expansions[b])
    return ranks, expansions


def _py_encode_unit(data: bytes, ranks, n_merges: int,
                    out: list[int]) -> None:
    n = len(data)
    if n == 0:
        return
    if n == 1:
        out.append(BYTE_BASE + data[0])
        return
    ids = [BYTE_BASE + b for b in data]
    prev = list(range(-1, n - 1))
    nxt = list(range(1, n + 1))
    nxt[-1] = -1
    alive = [True] * n
    heap: list[tuple[int, int, int]] = []

    def push(pos: int) -> None:
        r = nxt[pos]
        if pos < 0 or r < 0:
            return
        rank = ranks.get((ids[pos], ids[r]))
        if rank is not None and rank < n_merges:
            heapq.heappush(heap, (rank, pos, r))

    for i in range(n - 1):
        push(i)
    while heap:
        rank, pos, right = heapq.heappop(heap)
        if not alive[pos] or nxt[pos] != right or not alive[right]:
            continue
        if ranks.get((ids[pos], ids[right])) != rank:
            continue
        ids[pos] = FIRST_MERGE_ID + rank
        alive[right] = False
        rr = nxt[right]
        nxt[pos] = rr
        if rr >= 0:
            prev[rr] = pos
        if prev[pos] >= 0:
            push(prev[pos])
        push(pos)
    i = 0
    while i >= 0:
        if alive[i]:
            out.append(ids[i])
        i = nxt[i]


def _py_encode(text: str, n_merges: int) -> list[int]:
    ranks, _ = _python_tables()
    out: list[int] = []
    for unit in pre_split(text):
        _py_encode_unit(unit, ranks, n_merges, out)
    return out


class NativeBPETokenizer(Tokenizer):
    """Byte-level BPE over the shared merges artifact, truncated to
    ``n_merges`` so the id space fits the model's vocab
    (vocab_size = 259 + n_merges ceiling). Encodes through the C++ build;
    ``native`` is False only when that build failed."""

    def __init__(self, n_merges: int = 1 << 30):
        ranks, expansions = _python_tables()
        self.n_merges = min(n_merges, len(ranks))
        self._native = _load_native()
        self._expansions = expansions

    @property
    def native(self) -> bool:
        return self._native is not None

    @classmethod
    def for_vocab(cls, vocab_size: int) -> "NativeBPETokenizer":
        return cls(n_merges=max(0, vocab_size - FIRST_MERGE_ID))

    @classmethod
    def byte_level(cls) -> "NativeBPETokenizer":
        """No merges: one token a byte (tiny models whose vocab fits no
        merge)."""
        return cls(n_merges=0)

    @property
    def vocab_size(self) -> int:
        return FIRST_MERGE_ID + self.n_merges

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        if self._native is not None:
            lib, handle = self._native
            data = text.encode("utf-8")
            cap = len(data) + 8
            buf = (ctypes.c_int32 * cap)()
            n = lib.qt_bpe_encode(handle, data, len(data), self.n_merges,
                                  buf, cap)
            ids = buf[:min(n, cap)]
        else:
            ids = _py_encode(text, self.n_merges)
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        exp = self._expansions
        limit = FIRST_MERGE_ID + self.n_merges
        data = b"".join(
            exp[i] for i in ids
            if BYTE_BASE <= i < limit and i < len(exp))
        return data.decode("utf-8", errors="replace")
