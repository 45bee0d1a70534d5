"""Tokenizers for the port's model pool.

The port's own copy of the JAX package's tokenizer layer
(``quoracle_tpu/models/tokenizer.py`` plus the pure-Python BPE of
``quoracle_tpu/native/tokenizer.py``). The learned byte-level BPE reads
``bpe_merges.txt`` beside this file, a byte-identical copy of
``quoracle_tpu/native/bpe_merges.txt``, so ids match the JAX package
exactly. The JAX package can also encode through a C++ build of the same
algorithm; its Python path is documented as bit-identical, so the port
keeps only that one. Checkpoint tokenizers (HF files) arrive with
checkpoint loading in a later slice.
"""

from __future__ import annotations

import abc
import heapq
import os
from functools import lru_cache
from typing import Sequence

from quoracle_tpu_torch.utils.normalize import (
    stringify_content as _stringify_content,
)

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_N_SPECIALS = 3

MERGES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bpe_merges.txt")
BYTE_BASE = _N_SPECIALS             # byte b -> id b + BYTE_BASE
FIRST_MERGE_ID = BYTE_BASE + 256
MAX_WORD_LEN = 128


class Tokenizer(abc.ABC):
    """Interface the runtime depends on."""

    pad_id: int = PAD_ID
    bos_id: int = BOS_ID
    eos_id: int = EOS_ID

    @abc.abstractmethod
    def encode(self, text: str, add_bos: bool = False) -> list[int]: ...

    @abc.abstractmethod
    def decode(self, ids: Sequence[int]) -> str: ...

    def decode_raw(self, ids: Sequence[int]) -> str:
        """Decode for TEXT-PREFIX comparison (session splicing). Byte-level
        tokenizers keep their default decode."""
        return self.decode(ids)

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    def count(self, text: str) -> int:
        return len(self.encode(text))

    # One neutral chat template for every family, as in the JAX package.
    def render_chat(self, messages: Sequence[dict]) -> str:
        parts = []
        for m in messages:
            role = m.get("role", "user")
            content = m.get("content", "")
            if not isinstance(content, str):
                content = _stringify_content(content)
            parts.append(f"<|{role}|>\n{content}\n")
        parts.append("<|assistant|>\n")
        return "".join(parts)

    def encode_chat(self, messages: Sequence[dict]) -> list[int]:
        return self.encode(self.render_chat(messages), add_bos=True)


class ByteTokenizer(Tokenizer):
    """Byte-level reversible tokenizer: id = byte + 3 specials offset."""

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = [b + _N_SPECIALS for b in text.encode("utf-8")]
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        # ids beyond the byte range (model vocab > tokenizer vocab) skip
        data = bytes(i - _N_SPECIALS for i in ids
                     if _N_SPECIALS <= i < 256 + _N_SPECIALS)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return 256 + _N_SPECIALS


# ---------------------------------------------------------------------------
# Byte-level BPE (pure Python, lockstep with the JAX package's bpe.cpp)
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
    (vocab_size = 259 + n_merges ceiling). The name matches the JAX
    package's class; the port runs its Python implementation."""

    def __init__(self, n_merges: int = 1 << 30):
        ranks, expansions = _python_tables()
        self.n_merges = min(n_merges, len(ranks))
        self._expansions = expansions

    @classmethod
    def for_vocab(cls, vocab_size: int) -> "NativeBPETokenizer":
        return cls(n_merges=max(0, vocab_size - FIRST_MERGE_ID))

    @property
    def vocab_size(self) -> int:
        return FIRST_MERGE_ID + self.n_merges

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = _py_encode(text, self.n_merges)
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        exp = self._expansions
        limit = FIRST_MERGE_ID + self.n_merges
        data = b"".join(
            exp[i] for i in ids
            if BYTE_BASE <= i < limit and i < len(exp))
        return data.decode("utf-8", errors="replace")


_TOK_CACHE: dict[tuple, Tokenizer] = {}


def get_tokenizer(model_name: str) -> Tokenizer:
    """Tokenizer for a catalog model: the learned BPE sized to the model's
    vocab, with bos/eos ids from the model's catalog entry so the tokenizer
    and the engine's stop condition always agree."""
    from quoracle_tpu_torch.models.config import get_model_config
    try:
        cfg = get_model_config(model_name)
        bos, eos, vocab = cfg.bos_token_id, cfg.eos_token_id, cfg.vocab_size
        ckpt = cfg.checkpoint_path
    except KeyError:
        bos, eos, vocab, ckpt = BOS_ID, EOS_ID, 32768, None
    if ckpt:
        raise NotImplementedError(
            f"model {model_name!r} names checkpoint {ckpt!r}: checkpoint "
            f"tokenizers are not ported yet (random-init models only)")
    key = (model_name, bos, eos, vocab)
    cached = _TOK_CACHE.get(key)
    if cached is not None:
        return cached
    tok = NativeBPETokenizer.for_vocab(vocab)
    tok.bos_id, tok.eos_id = bos, eos
    _TOK_CACHE[key] = tok
    return tok
