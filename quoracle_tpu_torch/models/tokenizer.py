"""Tokenizers for the port's model pool.

The port's own copy of the JAX package's tokenizer layer
(``quoracle_tpu/models/tokenizer.py`` plus the pure-Python BPE of
``quoracle_tpu/native/tokenizer.py``). The learned byte-level BPE reads
``bpe_merges.txt`` beside this file, a byte-identical copy of
``quoracle_tpu/native/bpe_merges.txt``, so ids match the JAX package
exactly. The JAX package can also encode through a C++ build of the same
algorithm; its Python path is documented as bit-identical, so the port
keeps only that one.

A checkpoint brings its own tokenizer (``HFAutoTokenizer``: its
``tokenizer.json``, special tokens and chat template; ``HFTokenizer``: a
bare ``tokenizer.json``). The JAX package wraps ``transformers`` and
``tokenizers`` for these; the port reads the files itself, without either
library or ``regex``: byte-level BPE only (the ``ByteLevel``
pre-tokenizer, alone or after ``Split`` as llama-3 ships it, BPE by merge
rank, the ``ByteLevel`` decoder), the added tokens split out first, and
the chat template rendered by ``jinja2`` as ``transformers`` renders it.
Any other model, normalizer, pre-tokenizer or decoder raises
``NotImplementedError`` (SentencePiece, Unigram and WordPiece files are
queued in ROADMAP.md, Queue 1 item 13).
"""

from __future__ import annotations

import abc
import heapq
import json
import os
import re
import threading
import unicodedata
from functools import lru_cache
from typing import Optional, Sequence

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


# ---------------------------------------------------------------------------
# HF tokenizer files: tokenizer.json (byte-level BPE)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def byte_chars() -> tuple[str, ...]:
    """GPT-2's byte -> printable character table (``ByteLevel``): bytes
    that print stand for themselves, the others map to 256 + n in order."""
    keep = set(range(ord("!"), ord("~") + 1)) | set(
        range(0xA1, 0xAD)) | set(range(0xAE, 0x100))
    out, n = [], 0
    for b in range(256):
        if b in keep:
            out.append(chr(b))
        else:
            out.append(chr(256 + n))
            n += 1
    return tuple(out)


@lru_cache(maxsize=1)
def _char_bytes() -> dict[str, int]:
    return {c: b for b, c in enumerate(byte_chars())}


# Unicode White_Space: what the tokenizers library's regex engines mean by
# \s (Python's \s also takes U+001C..U+001F)
_WHITE_SPACE = (r"\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
                r"\u202f\u205f\u3000")
_SPACE_RE = re.compile(f"[{_WHITE_SPACE}]")


@lru_cache(maxsize=1)
def _unicode_classes() -> dict[str, str]:
    """Character-class bodies for \\p{L} and \\p{N}, which the standard
    library's ``re`` does not know, built from ``unicodedata``'s general
    categories (L*: letters; Nd, Nl, No: numbers)."""
    spans: dict[str, list] = {"L": [], "N": []}
    for cp in range(0x110000):
        ranges = spans.get(unicodedata.category(chr(cp))[0])
        if ranges is None:
            continue
        if ranges and ranges[-1][1] == cp - 1:
            ranges[-1][1] = cp
        else:
            ranges.append([cp, cp])
    return {k: "".join(f"\\U{lo:08x}" if lo == hi
                       else f"\\U{lo:08x}-\\U{hi:08x}" for lo, hi in v)
            for k, v in spans.items()}


# escapes whose meaning differs between Oniguruma and ``re``
_UNSUPPORTED_ESCAPES = set("PwWbBhHXRKGz")


def translate_regex(pattern: str) -> str:
    """A tokenizer file's (Oniguruma) pattern -> Python ``re``: \\p{L},
    \\p{N}, \\s and \\S become explicit classes; escapes whose meaning
    differs between the engines raise."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            e = pattern[i + 1]
            if e == "p":
                m = re.match(r"\{(\w+)\}", pattern[i + 2:])
                if not m or m.group(1) not in ("L", "N"):
                    raise NotImplementedError(
                        f"tokenizer regex: {pattern[i:i + 8]!r} is not "
                        f"supported (only \\p{{L}} and \\p{{N}})")
                body = _unicode_classes()[m.group(1)]
                out.append(body if in_class else f"[{body}]")
                i += 2 + m.end()
                continue
            if e == "s":
                out.append(_WHITE_SPACE if in_class else f"[{_WHITE_SPACE}]")
            elif e == "S":
                if in_class:
                    raise NotImplementedError(
                        "tokenizer regex: \\S inside a class")
                out.append(f"[^{_WHITE_SPACE}]")
            elif e in _UNSUPPORTED_ESCAPES:
                raise NotImplementedError(
                    f"tokenizer regex: \\{e} is not supported")
            else:
                out.append(c + e)
            i += 2
            continue
        out.append(c)
        if c == "[" and not in_class:
            in_class = True
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
            if pattern[i + 1:i + 2] == "]":       # a literal ] comes first
                out.append("\\]")
                i += 1
        elif c == "]" and in_class:
            in_class = False
        i += 1
    return "".join(out)


# GPT-2's pattern: the ByteLevel pre-tokenizer's own split (use_regex)
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _is_word_char(ch: str) -> bool:
    """\\w of the regex engine that places added tokens (Unicode)."""
    cat = unicodedata.category(ch)
    return (ch.isalpha() or cat[0] == "M" or cat in ("Nd", "Nl", "Pc")
            or ch in "\u200c\u200d")


class _Added:
    """One entry of a tokenizer file's ``added_tokens``."""
    __slots__ = ("id", "content", "special", "lstrip", "rstrip",
                 "single_word", "normalized")

    def __init__(self, d: dict):
        self.id = int(d["id"])
        self.content = d["content"]
        self.special = bool(d.get("special", False))
        self.lstrip = bool(d.get("lstrip", False))
        self.rstrip = bool(d.get("rstrip", False))
        self.single_word = bool(d.get("single_word", False))
        self.normalized = bool(d.get("normalized", not self.special))


def _unsupported(what: str, value) -> NotImplementedError:
    if isinstance(value, dict):
        value = value.get("type", value)
    return NotImplementedError(
        f"tokenizer.json: {what} {value!r} is not supported (the port "
        f"reads byte-level BPE files only)")


class HFTokenizer(Tokenizer):
    """A ``tokenizer.json`` whose model is byte-level BPE, run by the port
    (ids and texts as the ``tokenizers`` library gives them):

    * the added tokens are split out of the text first (leftmost-longest;
      ``lstrip``, ``rstrip``, ``single_word``; the non-normalized ones
      before the normalized, as the library does), special or not;
    * the rest is pre-tokenized: ``Split`` steps (regex or string,
      ``Isolated``), then ``ByteLevel`` (``add_prefix_space``; its own
      GPT-2 split when ``use_regex``), which maps bytes to characters;
    * each piece merges by BPE rank (``ignore_merges``: a piece in the
      vocab is taken whole; characters outside the vocab become
      ``unk_token``, fused or not, or are dropped);
    * decoding drops ids outside the vocab (and special tokens unless
      asked), maps characters back to bytes (a token with a character
      outside the byte table keeps its own UTF-8) and replaces invalid
      UTF-8 with U+FFFD.
    """

    _CACHE_WORDS = 1 << 16

    def __init__(self, path: str, bos_id: int = BOS_ID, eos_id: int = EOS_ID,
                 extra_specials: Sequence[str] = ()):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        self.path = path
        self.bos_id, self.eos_id = bos_id, eos_id
        for key in ("normalizer", "truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(key, spec[key])
        self._load_model(spec.get("model") or {})
        self._load_pre_tokenizer(spec.get("pre_tokenizer"))
        dec = spec.get("decoder")
        if not (isinstance(dec, dict) and dec.get("type") == "ByteLevel"):
            raise _unsupported("decoder", dec)
        self._added = [_Added(d) for d in spec.get("added_tokens") or []]
        for content in extra_specials:
            if not any(a.content == content for a in self._added):
                self._add_special(content)
        self._index_added()
        self._cache: dict[str, tuple[int, ...]] = {}

    # -- the file ------------------------------------------------------------
    def _load_model(self, m: dict) -> None:
        if m.get("type") != "BPE":
            raise _unsupported("model", m.get("type"))
        if m.get("dropout") not in (None, 0, 0.0):
            raise _unsupported("BPE dropout", m.get("dropout"))
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if m.get(key):
                raise _unsupported(f"BPE {key}", m[key])
        if m.get("byte_fallback"):
            raise _unsupported("BPE byte_fallback", True)
        self._vocab: dict[str, int] = dict(m["vocab"])
        self._inv = {i: t for t, i in self._vocab.items()}
        self._unk = m.get("unk_token")
        if self._unk is not None and self._unk not in self._vocab:
            raise ValueError(f"tokenizer.json: unk_token {self._unk!r} is "
                             f"not in the vocab")
        self._fuse_unk = bool(m.get("fuse_unk", False))
        self._ignore_merges = bool(m.get("ignore_merges", False))
        self._merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, pair in enumerate(m.get("merges") or []):
            a, b = pair.split(" ", 1) if isinstance(pair, str) else pair
            try:
                key = (self._vocab[a], self._vocab[b])
                new = self._vocab[a + b]
            except KeyError as e:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names "
                                 f"a token outside the vocab: {e}") from None
            self._merges.setdefault(key, (rank, new))

    def _load_pre_tokenizer(self, pt) -> None:
        seq = isinstance(pt, dict) and pt.get("type") == "Sequence"
        steps = list(pt.get("pretokenizers") or []) if seq else [pt]
        if not (steps and isinstance(steps[-1], dict)
                and steps[-1].get("type") == "ByteLevel"):
            raise _unsupported("pre_tokenizer", pt)
        self._splits: list[re.Pattern] = []
        for st in steps[:-1]:
            if st.get("type") != "Split":
                raise _unsupported("pre_tokenizer step", st)
            if st.get("behavior") != "Isolated" or st.get("invert"):
                raise _unsupported("Split behavior",
                                   (st.get("behavior"), st.get("invert")))
            pat = st["pattern"]
            self._splits.append(re.compile(
                translate_regex(pat["Regex"]) if "Regex" in pat
                else re.escape(pat["String"])))
        bl = steps[-1]
        self._prefix_space = bool(bl.get("add_prefix_space", False))
        # ByteLevel prefixes each piece the Split steps made, then splits
        # it by the GPT-2 pattern when use_regex
        self._bl_split = (re.compile(translate_regex(GPT2_PATTERN))
                          if bl.get("use_regex", True) else None)

    def _add_special(self, content: str) -> None:
        """Register ``content`` as a special added token with the id the
        library gives it: its vocab id, else one past the largest."""
        ids = [a.id for a in self._added]
        if content in self._vocab:
            new = self._vocab[content]
        elif ids and max(ids) >= len(self._vocab):
            new = max(ids) + 1
        else:
            new = len(self._vocab)
        self._added.append(_Added({"id": new, "content": content,
                                   "special": True, "normalized": False}))

    def _index_added(self) -> None:
        self._added_by_id = {a.id: a for a in self._added}
        self._added_by_content = {a.content: a for a in self._added}
        self._added_res = []
        for normalized in (False, True):
            group = sorted((a.content for a in self._added
                            if a.normalized == normalized),
                           key=lambda c: -len(c))
            self._added_res.append(
                re.compile("|".join(map(re.escape, group)))
                if group else None)

    # -- encoding ------------------------------------------------------------
    def _split_added(self, text: str, pattern) -> list:
        """[(added token or None, text)] over ``text``: the library's
        ``find_matches``."""
        if pattern is None or not text:
            return [(None, text)]
        out, at = [], 0
        for m in pattern.finditer(text):
            tok = self._added_by_content[m.group(0)]
            start, stop = m.start(), m.end()
            if tok.single_word and (
                    (start > 0 and _is_word_char(text[start - 1]))
                    or (stop < len(text) and _is_word_char(text[stop]))):
                continue
            if tok.lstrip:
                s = start
                while s > 0 and _SPACE_RE.match(text[s - 1]):
                    s -= 1
                start = max(s, at)
            if tok.rstrip:
                while stop < len(text) and _SPACE_RE.match(text[stop]):
                    stop += 1
            if at < start:
                out.append((None, text[at:start]))
            out.append((tok, text[start:stop]))
            at = stop
        if at < len(text):
            out.append((None, text[at:]))
        return out

    @staticmethod
    def _isolate(pieces: list[str], pattern: re.Pattern) -> list[str]:
        """Split each piece into its matches and the gaps between them."""
        out = []
        for p in pieces:
            at = 0
            for m in pattern.finditer(p):
                if m.start() == m.end():
                    continue
                if at < m.start():
                    out.append(p[at:m.start()])
                out.append(m.group(0))
                at = m.end()
            if at < len(p):
                out.append(p[at:])
        return out

    def _pre_tokenize(self, text: str) -> list[str]:
        pieces = [text]
        for pat in self._splits:
            pieces = self._isolate(pieces, pat)
        if self._prefix_space:
            pieces = [p if p.startswith(" ") else " " + p for p in pieces]
        if self._bl_split is not None:
            pieces = self._isolate(pieces, self._bl_split)
        table = byte_chars()
        return ["".join(table[b] for b in p.encode("utf-8"))
                for p in pieces if p]

    def _bpe(self, word: str) -> tuple[int, ...]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        vocab = self._vocab
        if self._ignore_merges and word in vocab:
            out: tuple[int, ...] = (vocab[word],)
        else:
            ids: list[int] = []
            unk = None                  # a pending (fusable) unk symbol
            for ch in word:
                tid = vocab.get(ch)
                if tid is not None:
                    if unk is not None:
                        ids.append(unk)
                        unk = None
                    ids.append(tid)
                elif self._unk is not None:
                    if unk is not None and not self._fuse_unk:
                        ids.append(unk)
                    unk = vocab[self._unk]
            if unk is not None:
                ids.append(unk)
            out = tuple(self._merge(ids))
        if len(self._cache) < self._CACHE_WORDS:
            self._cache[word] = out
        return out

    def _merge(self, ids: list[int]) -> list[int]:
        """Apply merges lowest rank first (leftmost on a tie) until none
        applies: the library's ``Word::merge_all``."""
        n = len(ids)
        if n < 2:
            return ids
        merges = self._merges
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prev = list(range(-1, n - 1))
        alive = [True] * n
        heap: list = []

        def push(pos: int) -> None:
            r = nxt[pos]
            if pos >= 0 and r >= 0:
                hit = merges.get((ids[pos], ids[r]))
                if hit is not None:
                    heapq.heappush(heap, (hit[0], pos, hit[1]))

        for i in range(n - 1):
            push(i)
        while heap:
            _, pos, new = heapq.heappop(heap)
            right = nxt[pos]
            if not alive[pos] or right < 0:
                continue
            hit = merges.get((ids[pos], ids[right]))
            if hit is None or hit[1] != new:
                continue
            ids[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] >= 0:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                push(prev[pos])
            push(pos)
        out, i = [], 0
        while i >= 0:
            out.append(ids[i])
            i = nxt[i]
        return out

    def encode_ids(self, text: str) -> list[int]:
        """The library's ``encode(text, add_special_tokens=False).ids``."""
        out: list[int] = []
        raw, normalized = self._added_res
        for tok, part in self._split_added(text, raw):
            if tok is not None:
                out.append(tok.id)
                continue
            for tok2, part2 in self._split_added(part, normalized):
                if tok2 is not None:
                    out.append(tok2.id)
                    continue
                for word in self._pre_tokenize(part2):
                    out.extend(self._bpe(word))
        return out

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self.encode_ids(text)
        return [self.bos_id] + ids if add_bos else ids

    # -- decoding ------------------------------------------------------------
    def token_to_id(self, token: str) -> Optional[int]:
        a = self._added_by_content.get(token)
        return a.id if a is not None else self._vocab.get(token)

    def decode_ids(self, ids: Sequence[int], skip_special: bool) -> str:
        table = _char_bytes()
        data = bytearray()
        for tid in ids:
            a = self._added_by_id.get(int(tid))
            if a is not None:
                if skip_special and a.special:
                    continue
                tok = a.content
            else:
                tok = self._inv.get(int(tid))
                if tok is None:
                    continue
            try:
                data.extend([table[c] for c in tok])
            except KeyError:
                data.extend(tok.encode("utf-8"))
        return data.decode("utf-8", errors="replace")

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_ids(ids, skip_special=True)

    def decode_raw(self, ids: Sequence[int]) -> str:
        return self.decode_ids(ids, skip_special=False)

    @property
    def vocab_size(self) -> int:
        """Model vocab and added tokens, each text once (the library's
        ``get_vocab_size(with_added_tokens=True)``)."""
        return len(set(self._vocab) | set(self._added_by_content))


_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")


def _token_text(v) -> Optional[str]:
    """A tokenizer_config special token: a string or an AddedToken dict."""
    if v is None or isinstance(v, str):
        return v
    return v["content"]


def _template_env():
    """The jinja2 environment ``transformers`` renders chat templates in."""
    import datetime

    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None,
               sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = \
        lambda fmt: datetime.datetime.now().strftime(fmt)
    return env


def _clean_up_spaces(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


class HFAutoTokenizer(Tokenizer):
    """The tokenizer of a served checkpoint directory, as the JAX
    package's ``transformers.AutoTokenizer`` gives it: ``tokenizer.json``
    through ``HFTokenizer``; the special tokens of
    ``tokenizer_config.json`` (those the file lacks are added, as
    ``transformers`` adds them) and its ``clean_up_tokenization_spaces``
    (default off); its chat template (or ``chat_template.jinja``),
    rendered as ``transformers`` renders it and encoded without added
    specials. Without a template the neutral one serves."""

    def __init__(self, path: str):
        tj = os.path.join(path, "tokenizer.json")
        if not os.path.isfile(tj):
            if any(os.path.isfile(os.path.join(path, f)) for f in
                   ("vocab.json", "tokenizer.model", "vocab.txt")):
                raise NotImplementedError(
                    f"checkpoint dir {path!r} has no tokenizer.json: "
                    f"slow-tokenizer files (vocab.json, SentencePiece, "
                    f"WordPiece) are not ported")
            raise ValueError(
                f"checkpoint dir {path!r} has no tokenizer files "
                "(tokenizer.json) — a served checkpoint must ship its own "
                "tokenizer")
        conf: dict = {}
        cp = os.path.join(path, "tokenizer_config.json")
        if os.path.isfile(cp):
            with open(cp, encoding="utf-8") as f:
                conf = json.load(f)
        # the template's special-token variables (transformers'
        # special_tokens_map)
        self.special_tokens: dict = {
            k: _token_text(conf[k]) for k in _SPECIAL_KEYS
            if _token_text(conf.get(k)) is not None}
        extra = [_token_text(t)
                 for t in conf.get("additional_special_tokens") or []]
        if extra:
            self.special_tokens["additional_special_tokens"] = extra
        self._tok = HFTokenizer(tj, extra_specials=[
            self.special_tokens[k] for k in _SPECIAL_KEYS
            if k in self.special_tokens] + extra)
        for tid, d in (conf.get("added_tokens_decoder") or {}).items():
            if self._tok.token_to_id(d["content"]) != int(tid):
                raise NotImplementedError(
                    f"tokenizer_config.json adds token {d['content']!r} "
                    f"(id {tid}), which tokenizer.json lacks")

        def special_id(key: str) -> Optional[int]:
            text = self.special_tokens.get(key)
            return None if text is None else self._tok.token_to_id(text)
        # no invented specials: without a bos token add_bos adds nothing
        bos, eos, pad = (special_id(k) for k in
                         ("bos_token", "eos_token", "pad_token"))
        self._has_bos = bos is not None
        self.bos_id = bos if self._has_bos else BOS_ID
        self.eos_id = eos if eos is not None else EOS_ID
        self.pad_id = pad if pad is not None else self.eos_id
        self._clean_up = bool(conf.get("clean_up_tokenization_spaces",
                                       False))
        template = conf.get("chat_template")
        jinja_file = os.path.join(path, "chat_template.jinja")
        if os.path.isfile(jinja_file):
            with open(jinja_file, encoding="utf-8") as f:
                template = f.read()
        if isinstance(template, list):
            template = {t["name"]: t["template"]
                        for t in template}.get("default")
        self._template = (_template_env().from_string(template)
                          if template else None)

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self._tok.encode_ids(text)
        return [self.bos_id] + ids if add_bos and self._has_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        text = self._tok.decode_ids(ids, skip_special=True)
        return _clean_up_spaces(text) if self._clean_up else text

    def decode_raw(self, ids: Sequence[int]) -> str:
        # template markers kept: the splice suffix must re-encode to them
        return self._tok.decode_ids(ids, skip_special=False)

    @property
    def vocab_size(self) -> int:
        return self._tok.vocab_size

    def encode_chat(self, messages: Sequence[dict]) -> list[int]:
        msgs = [{"role": m.get("role", "user"),
                 "content": m.get("content", "")
                 if isinstance(m.get("content", ""), str)
                 else _stringify_content(m.get("content"))}
                for m in messages]
        if self._template is None:
            return self.encode(self.render_chat(msgs), add_bos=True)
        return self._tok.encode_ids(self._template.render(
            messages=msgs, tools=None, documents=None,
            add_generation_prompt=True, **self.special_tokens))


_TOK_CACHE: dict[tuple, Tokenizer] = {}
# backends and engines may be built from several threads; one tokenizer
# per key, so every engine of a model shares its (stateless) instance
_TOK_LOCK = threading.Lock()


def get_tokenizer(model_name: str,
                  tokenizer_path: Optional[str] = None) -> Tokenizer:
    """Tokenizer for a catalog model: a checkpoint's own
    (``HFAutoTokenizer``), else the ``tokenizer.json`` at
    ``tokenizer_path`` (``HFTokenizer``), else the learned BPE sized to
    the model's vocab. bos/eos come from the catalog entry (a checkpoint's
    tokenizer brings its own), so the tokenizer and the engine's stop
    condition agree. The cache key holds the checkpoint path: a name
    registered again, or after a first lookup, never keeps a stale
    tokenizer."""
    from quoracle_tpu_torch.models.config import get_model_config
    try:
        cfg = get_model_config(model_name)
        bos, eos, vocab = cfg.bos_token_id, cfg.eos_token_id, cfg.vocab_size
        ckpt = cfg.checkpoint_path
    except KeyError:
        bos, eos, vocab, ckpt = BOS_ID, EOS_ID, 32768, None
    key = (model_name, tokenizer_path, ckpt, bos, eos, vocab)
    with _TOK_LOCK:
        cached = _TOK_CACHE.get(key)
        if cached is None:
            if ckpt:
                cached = HFAutoTokenizer(ckpt)
            elif tokenizer_path:
                cached = HFTokenizer(tokenizer_path, bos_id=bos, eos_id=eos)
            else:
                cached = NativeBPETokenizer.for_vocab(vocab)
                cached.bos_id, cached.eos_id = bos, eos
            _TOK_CACHE[key] = cached
    return cached


# the reset hook the JAX package's get_tokenizer has
get_tokenizer.cache_clear = _TOK_CACHE.clear
