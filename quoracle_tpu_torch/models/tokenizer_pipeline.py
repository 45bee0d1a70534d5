"""The components of a ``tokenizer.json`` pipeline, read without the
``tokenizers`` library.

A ``tokenizer.json`` names a normalizer, a pre-tokenizer, a model and a
decoder; models/tokenizer.py's ``HFTokenizer`` runs them in that order
(the added tokens split out first). Each class here is built from its
dict in the file and gives what the ``tokenizers`` library gives:

* normalizers: ``Sequence``, ``NFC``, ``NFD``, ``NFKC``, ``NFKD``,
  ``Lowercase``, ``Replace`` (string or regex), ``Prepend``, ``Strip``,
  ``StripAccents``, ``BertNormalizer``;
* pre-tokenizers: ``Metaspace``, ``Split`` (every behavior, ``invert``),
  ``WhitespaceSplit``, ``Whitespace``, ``BertPreTokenizer``,
  ``Punctuation``, ``Digits``, ``ByteLevel``, ``Sequence``;
* models: ``BPE`` (merge rank, ``byte_fallback``, ``fuse_unk``,
  ``continuing_subword_prefix``, ``end_of_word_suffix``,
  ``ignore_merges``), ``Unigram`` (Viterbi over the piece scores),
  ``WordPiece`` (greedy longest match);
* decoders: ``Sequence``, ``Replace``, ``ByteFallback``, ``Fuse``,
  ``Strip``, ``Metaspace``, ``WordPiece``, ``BPEDecoder``, ``ByteLevel``.

Any other type raises ``NotImplementedError`` naming itself.

Text moves through the pipeline as pieces ``(text, starts)``: ``starts``
holds, for each character, the offset in the input of the character it
came from (the library's alignments), or is None when nothing downstream
reads it. Only ``Metaspace`` with ``prepend_scheme`` "first" reads it: it
prepends to a piece whose first character comes from the input's first.
Regex patterns are Oniguruma's; ``translate_regex`` rewrites them for
``re`` (``\\p{L}``, ``\\p{N}``, ``\\s``, ``\\w`` as Unicode classes).
"""

from __future__ import annotations

import heapq
import re
import unicodedata
from functools import lru_cache
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# character classes
# ---------------------------------------------------------------------------

# Unicode White_Space: what the library's char::is_whitespace and its regex
# engines mean by \s (Python's str.isspace and \s also take U+001C..U+001F)
_WHITE_SPACE = (r"\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
                r"\u202f\u205f\u3000")
SPACE_RE = re.compile(f"[{_WHITE_SPACE}]")
_WHITE_SET = frozenset(
    [chr(c) for c in (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0,
                      0x1680, 0x2028, 0x2029, 0x202F, 0x205F, 0x3000)]
    + [chr(c) for c in range(0x2000, 0x200B)])


def is_whitespace(ch: str) -> bool:
    return ch in _WHITE_SET


def is_punctuation(ch: str) -> bool:
    """The library's punctuation test: ASCII punctuation or a P* char."""
    return (("!" <= ch <= "/") or (":" <= ch <= "@") or ("[" <= ch <= "`")
            or ("{" <= ch <= "~") or unicodedata.category(ch)[0] == "P")


def is_numeric(ch: str) -> bool:
    """char::is_numeric: Nd, Nl or No."""
    return unicodedata.category(ch)[0] == "N"


# the symbols of Unicode's Other_Alphabetic (circled and squared Latin
# letters): Alphabetic, so \w to both regex engines, though not letters
_OTHER_ALPHABETIC = frozenset(
    cp for lo, hi in ((0x24B6, 0x24E9), (0x1F130, 0x1F149),
                      (0x1F150, 0x1F169), (0x1F170, 0x1F189))
    for cp in range(lo, hi + 1))


def _word(cat: str, cp: int) -> bool:
    return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc")
            or cp in _OTHER_ALPHABETIC)


def is_word_char(ch: str) -> bool:
    """\\w of the Rust ``regex`` crate (the added tokens' single_word,
    the ``Whitespace`` pre-tokenizer): Alphabetic, marks, decimal digits,
    connector punctuation and the joiners (not ² or ①)."""
    return _word(unicodedata.category(ch), ord(ch)) or ch in "\u200c\u200d"


_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_chinese(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK)


# Oniguruma's Unicode \w is the Rust crate's without the joiners; outside
# a character class it also takes the Latin-1 superscripts and fractions
# (the library's build reads \w and [^\w] apart on those six)
_LATIN1_WORD = "\\xb2\\xb3\\xb9\\xbc-\\xbe"


@lru_cache(maxsize=1)
def _unicode_classes() -> dict[str, str]:
    """Character-class bodies for \\p{L}, \\p{N}, Oniguruma's \\w (W)
    and the Rust crate's (R), which the standard library's ``re`` does
    not know or reads otherwise, built from ``unicodedata``."""
    spans: dict[str, list] = {"L": [], "N": [], "W": [], "R": []}

    def add(ranges: list, cp: int) -> None:
        if ranges and ranges[-1][1] == cp - 1:
            ranges[-1][1] = cp
        else:
            ranges.append([cp, cp])

    for cp in range(0x110000):
        cat = unicodedata.category(chr(cp))
        if cat[0] in "LN":
            add(spans[cat[0]], cp)
        if _word(cat, cp):
            add(spans["W"], cp)
            add(spans["R"], cp)
        elif cp in (0x200C, 0x200D):
            add(spans["R"], cp)
    return {k: "".join(f"\\U{lo:08x}" if lo == hi
                       else f"\\U{lo:08x}-\\U{hi:08x}" for lo, hi in v)
            for k, v in spans.items()}


# escapes whose meaning differs between Oniguruma and ``re``
_UNSUPPORTED_ESCAPES = set("PbBhHXRKGz")


def translate_regex(pattern: str) -> str:
    """A tokenizer file's (Oniguruma) pattern -> Python ``re``: \\p{L},
    \\p{N}, \\s, \\S and \\w become explicit classes (\\W outside a
    class); escapes whose meaning differs between the engines raise."""
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
            if e in "sw":
                body = (_WHITE_SPACE if e == "s"
                        else _unicode_classes()["W"])
                out.append(body if in_class else f"[{body}]" if e == "s"
                           else f"[{body}{_LATIN1_WORD}]")
            elif e in "SW":
                if in_class:
                    raise NotImplementedError(
                        f"tokenizer regex: \\{e} inside a class")
                body = (_WHITE_SPACE if e == "S"
                        else _unicode_classes()["W"] + _LATIN1_WORD)
                out.append(f"[^{body}]")
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
def char_bytes() -> dict[str, int]:
    return {c: b for b, c in enumerate(byte_chars())}


def unsupported(what: str, value) -> NotImplementedError:
    if isinstance(value, dict):
        value = value.get("type", value)
    return NotImplementedError(
        f"tokenizer.json: {what} {value!r} is not supported (the port "
        f"reads the components listed in models/tokenizer_pipeline.py)")


# ---------------------------------------------------------------------------
# patterns and splits
# ---------------------------------------------------------------------------

Span = tuple[int, int, bool]          # (start, stop, is a match)


class Pattern:
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern, or a character
    predicate; ``find`` covers the text with matches and the gaps between
    them, as the library's ``Pattern::find_matches``."""

    def __init__(self, spec=None, pred=None, compiled=None):
        self.pred = pred
        self.re: Optional[re.Pattern] = compiled
        if spec is not None:
            if "Regex" in spec:
                self.re = re.compile(translate_regex(spec["Regex"]))
            elif spec["String"]:
                self.re = re.compile(re.escape(spec["String"]))

    def find(self, text: str) -> list[Span]:
        if not text:
            return [(0, 0, False)]
        out: list[Span] = []
        prev = 0
        if self.pred is not None:
            for i, ch in enumerate(text):
                if self.pred(ch):
                    if prev < i:
                        out.append((prev, i, False))
                    out.append((i, i + 1, True))
                    prev = i + 1
        elif self.re is not None:
            for m in self.re.finditer(text):
                s, e = m.span()
                if prev != s:
                    out.append((prev, s, False))
                out.append((s, e, True))
                prev = e
        if prev != len(text):
            out.append((prev, len(text), False))
        return out


def split_spans(spans: list[Span], behavior: str) -> list[tuple[int, int]]:
    """The library's ``NormalizedString::split`` over ``find``'s spans:
    the pieces each behavior keeps (empty ones dropped)."""
    out: list[list] = []
    if behavior == "Removed":
        out = [[s, e] for s, e, m in spans if not m]
    elif behavior == "Isolated":
        out = [[s, e] for s, e, _ in spans]
    elif behavior == "MergedWithPrevious":
        prev = False
        for s, e, m in spans:
            if m and not prev and out:
                out[-1][1] = e
            else:
                out.append([s, e])
            prev = m
    elif behavior == "MergedWithNext":
        prev = False
        for s, e, m in reversed(spans):
            if m and not prev and out:
                out[-1][0] = s
            else:
                out.append([s, e])
            prev = m
        out.reverse()
    elif behavior == "Contiguous":
        prev = False
        for s, e, m in spans:
            if m == prev and out:
                out[-1][1] = e
            else:
                out.append([s, e])
            prev = m
    else:
        raise unsupported("split behavior", behavior)
    return [(s, e) for s, e in out if s < e]


Piece = tuple[str, Optional[list]]    # (text, input offset of each char)


def _slices(piece: Piece, cuts) -> list[Piece]:
    text, al = piece
    return [(text[s:e], None if al is None else al[s:e]) for s, e in cuts]


# ---------------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------------

class Normalizer:
    def __call__(self, text: str, al: Optional[list]) -> Piece:
        raise NotImplementedError

    def text(self, text: str) -> str:
        return self(text, None)[0]


def _per_char(fn, text: str, al: Optional[list]) -> Piece:
    """Map each character to a string; every character it becomes keeps
    the source character's offset."""
    if al is None:
        return "".join(map(fn, text)), None
    out, new_al = [], []
    for ch, a in zip(text, al):
        s = fn(ch)
        out.append(s)
        new_al.extend([a] * len(s))
    return "".join(out), new_al


class NormalizerChain(Normalizer):
    def __init__(self, steps: list):
        self.steps = steps

    def __call__(self, text, al):
        for st in self.steps:
            text, al = st(text, al)
        return text, al


class UnicodeForm(Normalizer):
    def __init__(self, form: str):
        self.form = form

    def __call__(self, text, al):
        out = unicodedata.normalize(self.form, text)
        if al is None:
            return out, None
        # offsets: each run of a starter and its combining marks
        # normalizes on its own; in a run that changes, each character's
        # own expansion keeps its offset, or (a composition) the run's
        # first; where runs interact (Hangul jamo), the text's first
        groups, new_al = [], []
        for i, ch in enumerate(text):
            if i and unicodedata.combining(ch):
                groups[-1][0] += ch
                groups[-1][1].append(al[i])
            else:
                groups.append([ch, [al[i]]])
        parts = [unicodedata.normalize(self.form, g) for g, _ in groups]
        if "".join(parts) != out:
            return out, [al[0]] * len(out)
        for part, (g, offs) in zip(parts, groups):
            each = [unicodedata.normalize(self.form, c) for c in g]
            if part == g:
                new_al.extend(offs)
            elif "".join(each) == part:
                for e, o in zip(each, offs):
                    new_al.extend([o] * len(e))
            else:
                new_al.extend([offs[0]] * len(part))
        return out, new_al


class Lowercase(Normalizer):
    def __call__(self, text, al):
        return _per_char(str.lower, text, al)


class Replace(Normalizer):
    def __init__(self, pattern: dict, content: str):
        self.pattern = Pattern(pattern)
        self.content = content
        self.literal = pattern.get("String") if "Regex" not in pattern \
            else None

    def __call__(self, text, al):
        if al is None and self.literal:
            return text.replace(self.literal, self.content), None
        out, new_al = [], ([] if al is not None else None)
        for s, e, m in self.pattern.find(text):
            if not m:
                out.append(text[s:e])
                if al is not None:
                    new_al.extend(al[s:e])
                continue
            out.append(self.content)
            if al is not None and self.content:
                # inserted after the match's last char (or the one before
                # an empty match; the piece's start at its head)
                src = al[e - 1] if e > 0 else (al[0] if al else 0)
                new_al.extend([src] * len(self.content))
        return "".join(out), new_al


class Prepend(Normalizer):
    def __init__(self, prefix: str):
        self.prefix = prefix

    def __call__(self, text, al):
        if not text:
            return text, al
        return (self.prefix + text,
                None if al is None else [al[0]] * len(self.prefix) + al)


class Strip(Normalizer):
    def __init__(self, left: bool, right: bool):
        self.left, self.right = left, right

    def __call__(self, text, al):
        s, e = 0, len(text)
        if self.left:
            while s < e and is_whitespace(text[s]):
                s += 1
        if self.right:
            while e > s and is_whitespace(text[e - 1]):
                e -= 1
        return text[s:e], None if al is None else al[s:e]


def _filter(keep, text: str, al: Optional[list]) -> Piece:
    if al is None:
        return "".join(ch for ch in text if keep(ch)), None
    pairs = [(ch, a) for ch, a in zip(text, al) if keep(ch)]
    return "".join(p[0] for p in pairs), [p[1] for p in pairs]


def _not_mark(ch: str) -> bool:
    return unicodedata.category(ch)[0] != "M"


class StripAccents(Normalizer):
    def __call__(self, text, al):
        return _filter(_not_mark, text, al)


class BertNormalizer(Normalizer):
    def __init__(self, clean_text=True, handle_chinese_chars=True,
                 strip_accents=None, lowercase=True):
        self.clean_text = clean_text
        self.chinese = handle_chinese_chars
        self.strip_accents = (lowercase if strip_accents is None
                              else strip_accents)
        self.lowercase = lowercase

    @staticmethod
    def _keep(ch: str) -> bool:
        if ch in "\t\n\r":
            return True
        return not (ch in "\x00\ufffd" or unicodedata.category(ch)[0] == "C")

    def __call__(self, text, al):
        if self.clean_text:
            text, al = _filter(self._keep, text, al)
            text, al = _per_char(
                lambda c: " " if c in "\t\n\r" or is_whitespace(c) else c,
                text, al)
        if self.chinese:
            text, al = _per_char(
                lambda c: f" {c} " if _is_chinese(c) else c, text, al)
        if self.strip_accents:
            text, al = UnicodeForm("NFD")(text, al)
            text, al = _filter(_not_mark, text, al)
        if self.lowercase:
            text, al = _per_char(str.lower, text, al)
        return text, al


def build_normalizer(d) -> Optional[Normalizer]:
    if d is None:
        return None
    t = d.get("type")
    if t == "Sequence":
        return NormalizerChain([build_normalizer(x) for x in d["normalizers"]])
    if t in ("NFC", "NFD", "NFKC", "NFKD"):
        return UnicodeForm(t)
    if t == "Lowercase":
        return Lowercase()
    if t == "Replace":
        return Replace(d["pattern"], d["content"])
    if t == "Prepend":
        return Prepend(d["prepend"])
    if t == "Strip":
        return Strip(bool(d.get("strip_left", True)),
                     bool(d.get("strip_right", True)))
    if t == "StripAccents":
        return StripAccents()
    if t == "BertNormalizer":
        return BertNormalizer(d.get("clean_text", True),
                              d.get("handle_chinese_chars", True),
                              d.get("strip_accents"),
                              d.get("lowercase", True))
    raise unsupported("normalizer", d)


# ---------------------------------------------------------------------------
# pre-tokenizers
# ---------------------------------------------------------------------------

class PreTokenizer:
    """Maps pieces to pieces; empty pieces are dropped."""
    needs_offsets = False

    def __call__(self, pieces: list[Piece]) -> list[Piece]:
        out: list[Piece] = []
        for p in pieces:
            out.extend(q for q in self.split(p) if q[0])
        return out

    def split(self, piece: Piece) -> list[Piece]:
        raise NotImplementedError


class SplitBy(PreTokenizer):
    """``Split``, and every pre-tokenizer that is one split by a
    pattern with a behavior."""

    def __init__(self, pattern: Pattern, behavior: str,
                 invert: bool = False):
        self.pattern, self.behavior, self.invert = pattern, behavior, invert
        split_spans([], behavior)               # names an unknown one

    def split(self, piece):
        spans = self.pattern.find(piece[0])
        if self.invert:
            spans = [(s, e, not m) for s, e, m in spans]
        return _slices(piece, split_spans(spans, self.behavior))


class PreTokenizerChain(PreTokenizer):
    def __init__(self, steps: list):
        self.steps = steps
        self.needs_offsets = any(s.needs_offsets for s in steps)

    def __call__(self, pieces):
        for st in self.steps:
            pieces = st(pieces)
        return pieces


class Metaspace(PreTokenizer):
    def __init__(self, replacement: str = "\u2581",
                 prepend_scheme: str = "always", split: bool = True):
        if prepend_scheme not in ("always", "first", "never"):
            raise unsupported("Metaspace prepend_scheme", prepend_scheme)
        self.rep, self.scheme, self.do_split = (replacement, prepend_scheme,
                                                split)
        self.needs_offsets = prepend_scheme == "first"
        self._split = SplitBy(Pattern(pred=lambda c: c == replacement),
                              "MergedWithNext")

    def split(self, piece):
        text, al = piece
        text = text.replace(" ", self.rep)
        if not text.startswith(self.rep) and (
                self.scheme == "always"
                or (self.scheme == "first" and al[0] == 0)):
            text = self.rep + text
            al = None if al is None else [al[0]] + al
        piece = (text, al)
        return self._split.split(piece) if self.do_split else [piece]


class ByteLevelPre(PreTokenizer):
    """``ByteLevel``: a space before each piece (``add_prefix_space``),
    GPT-2's split (``use_regex``), then bytes to characters."""

    def __init__(self, add_prefix_space: bool, use_regex: bool):
        self.prefix = add_prefix_space
        self.regex = (SplitBy(Pattern({"Regex": GPT2_PATTERN}), "Isolated")
                      if use_regex else None)

    def split(self, piece):
        text, al = piece
        if self.prefix and not text.startswith(" "):
            text, al = " " + text, None if al is None else al[:1] + al
        pieces = [(text, al)]
        if self.regex is not None:
            pieces = self.regex.split(pieces[0])
        table = byte_chars()
        out = []
        for t, a in pieces:
            if a is None:
                out.append(("".join(table[b] for b in t.encode("utf-8")),
                            None))
                continue
            chars, offs = [], []
            for ch, o in zip(t, a):
                bs = ch.encode("utf-8")
                chars.extend(table[b] for b in bs)
                offs.extend([o] * len(bs))
            out.append(("".join(chars), offs))
        return out


def _prepend_scheme(d: dict) -> str:
    """A Metaspace's scheme; files older than ``prepend_scheme`` give
    ``add_prefix_space``. The library requires ``replacement``."""
    if "replacement" not in d:
        raise ValueError("tokenizer.json: a Metaspace without replacement")
    scheme = d.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if d.get("add_prefix_space", True) else "never"
    return scheme


def build_pre_tokenizer(d) -> Optional[PreTokenizer]:
    if d is None:
        return None
    t = d.get("type")
    if t == "Sequence":
        return PreTokenizerChain(
            [build_pre_tokenizer(x) for x in d["pretokenizers"]])
    if t == "Metaspace":
        scheme = _prepend_scheme(d)
        return Metaspace(d["replacement"], scheme,
                         bool(d.get("split", True)))
    if t == "Split":
        return SplitBy(Pattern(d["pattern"]), d["behavior"],
                       bool(d.get("invert", False)))
    if t == "WhitespaceSplit":
        return SplitBy(Pattern(pred=is_whitespace), "Removed")
    if t == "Whitespace":
        # the library runs this one through the Rust regex crate
        word = _unicode_classes()["R"]
        return SplitBy(Pattern(compiled=re.compile(
            f"[{word}]+|[^{word}{_WHITE_SPACE}]+")), "Removed", invert=True)
    if t == "BertPreTokenizer":
        return PreTokenizerChain([
            SplitBy(Pattern(pred=is_whitespace), "Removed"),
            SplitBy(Pattern(pred=is_punctuation), "Isolated")])
    if t == "Punctuation":
        return SplitBy(Pattern(pred=is_punctuation),
                       d.get("behavior", "Isolated"))
    if t == "Digits":
        return SplitBy(Pattern(pred=is_numeric),
                       "Isolated" if d.get("individual_digits", False)
                       else "Contiguous")
    if t == "ByteLevel":
        return ByteLevelPre(bool(d.get("add_prefix_space", True)),
                            bool(d.get("use_regex", True)))
    raise unsupported("pre_tokenizer", d)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

class Model:
    vocab: dict[str, int]

    def tokenize(self, word: str) -> list[int]:
        raise NotImplementedError

    def id_to_token(self, tid: int) -> Optional[str]:
        raise NotImplementedError


def _byte_token(b: int) -> str:
    return f"<0x{b:02X}>"


class BPE(Model):
    _CACHE_WORDS = 1 << 16
    _CACHE_CHARS = 256          # longer words (a whole segment) skip it

    def __init__(self, m: dict):
        if m.get("dropout") not in (None, 0, 0.0):
            raise unsupported("BPE dropout", m.get("dropout"))
        self.vocab = dict(m["vocab"])
        self._inv = {i: t for t, i in self.vocab.items()}
        self.unk = m.get("unk_token")
        if self.unk is not None and self.unk not in self.vocab:
            raise ValueError(f"tokenizer.json: unk_token {self.unk!r} is "
                             f"not in the vocab")
        self.fuse_unk = bool(m.get("fuse_unk", False))
        self.byte_fallback = bool(m.get("byte_fallback", False))
        self.ignore_merges = bool(m.get("ignore_merges", False))
        self.prefix = m.get("continuing_subword_prefix") or ""
        self.suffix = m.get("end_of_word_suffix") or ""
        cut = len(self.prefix.encode("utf-8"))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, pair in enumerate(m.get("merges") or []):
            a, b = pair.split(" ", 1) if isinstance(pair, str) else pair
            try:
                if len(b.encode("utf-8")) < cut:
                    # the library's slice past the end panics
                    raise KeyError(b)
                new = a + b.encode("utf-8")[cut:].decode("utf-8")
                # a pair named twice keeps its last rank, as the
                # library's map does
                self.merges[(self.vocab[a], self.vocab[b])] = (
                    rank, self.vocab[new])
            except (KeyError, UnicodeDecodeError) as e:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names "
                                 f"a token outside the vocab: {e}") from None
        self._cache: dict[str, tuple[int, ...]] = {}

    def id_to_token(self, tid):
        return self._inv.get(tid)

    def tokenize(self, word: str) -> tuple[int, ...]:
        if not word:
            return ()
        vocab = self.vocab
        if self.ignore_merges:
            hit = vocab.get(word)
            if hit is not None:
                return (hit,)
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids: list[int] = []
        unk = None                  # a pending (fusable) unk symbol
        last = len(word) - 1
        for i, ch in enumerate(word):
            s = ch
            if i and self.prefix:
                s = self.prefix + s
            if i == last and self.suffix:
                s = s + self.suffix
            tid = vocab.get(s)
            if tid is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(tid)
                continue
            if self.byte_fallback:
                bt = [vocab.get(_byte_token(b)) for b in s.encode("utf-8")]
                if None not in bt:
                    ids.extend(bt)
                    continue
            if self.unk is not None:
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = vocab[self.unk]
        if unk is not None:
            ids.append(unk)
        out = tuple(self._merge(ids))
        if len(word) <= self._CACHE_CHARS and \
                len(self._cache) < self._CACHE_WORDS:
            self._cache[word] = out
        return out

    def _merge(self, ids: list[int]) -> list[int]:
        """Apply merges lowest rank first (leftmost on a tie) until none
        applies: the library's ``Word::merge_all``."""
        n = len(ids)
        if n < 2:
            return ids
        merges = self.merges
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


_UNK_PENALTY = 10.0


class Unigram(Model):
    """Viterbi over the pieces' log-probabilities; an unknown character
    scores the lowest piece less 10; runs of unknowns fuse."""

    def __init__(self, m: dict):
        if not isinstance(m.get("vocab"), list):
            raise ValueError("tokenizer.json: a Unigram vocab is a list of "
                             "[piece, score]")
        self.pieces = [(p, float(s)) for p, s in m["vocab"]]
        self.vocab = {}
        for i, (p, _) in enumerate(self.pieces):
            self.vocab[p] = i
        self.unk_id = m.get("unk_id")
        self.byte_fallback = bool(m.get("byte_fallback", False))
        self.min_score = min((s for _, s in self.pieces), default=0.0)
        self.max_len = max((len(p) for p, _ in self.pieces), default=0)
        self._cache: dict[str, tuple[int, ...]] = {}

    def id_to_token(self, tid):
        return self.pieces[tid][0] if 0 <= tid < len(self.pieces) else None

    def _unk(self) -> int:
        if self.unk_id is None:
            raise ValueError("tokenizer.json: an unknown character and no "
                             "unk_id")
        return self.unk_id

    def _viterbi(self, text: str) -> list[str]:
        n = len(text)
        unk_score = self.min_score - _UNK_PENALTY
        score = [0.0] * (n + 1)
        start: list[Optional[int]] = [None] * (n + 1)
        node = [0] * (n + 1)
        vocab, pieces = self.vocab, self.pieces
        for at in range(n):
            base = score[at]
            single = False
            for end in range(at + 1, min(n, at + self.max_len) + 1):
                tid = vocab.get(text[at:end])
                if tid is None:
                    continue
                cand = pieces[tid][1] + base
                if start[end] is None or cand > score[end]:
                    score[end], start[end], node[end] = cand, at, tid
                if end == at + 1:
                    single = True
            if not single:
                cand = unk_score + base
                if start[at + 1] is None or cand > score[at + 1]:
                    score[at + 1], start[at + 1] = cand, at
                    node[at + 1] = self._unk()
        out: list[str] = []
        fused: list[str] = []
        end = n
        while end > 0:
            at = start[end]
            if self.unk_id is not None and node[end] == self.unk_id:
                fused.append(text[at:end])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(text[at:end])
            end = at
        if fused:
            out.append("".join(reversed(fused)))
        out.reverse()
        return out

    def tokenize(self, word: str) -> tuple[int, ...]:
        if not word:
            return ()
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids: list[int] = []
        for s in self._viterbi(word):
            tid = self.vocab.get(s)
            if tid is None and self.byte_fallback:
                bt = [self.vocab.get(_byte_token(b))
                      for b in s.encode("utf-8")]
                if None not in bt:
                    ids.extend(bt)
                    continue
            ids.append(self._unk() if tid is None else tid)
        out = tuple(ids)
        if len(word) <= BPE._CACHE_CHARS and \
                len(self._cache) < BPE._CACHE_WORDS:
            self._cache[word] = out
        return out


class WordPiece(Model):
    def __init__(self, m: dict):
        for key in ("unk_token", "continuing_subword_prefix"):
            if key in m and not isinstance(m[key], str):
                raise ValueError(f"tokenizer.json: WordPiece {key} "
                                 f"{m[key]!r} is not a string")
        self.vocab = dict(m["vocab"])
        self._inv = {i: t for t, i in self.vocab.items()}
        self.unk = m.get("unk_token", "[UNK]")
        self.prefix = m.get("continuing_subword_prefix", "##")
        self.max_chars = int(m.get("max_input_chars_per_word", 100))

    def id_to_token(self, tid):
        return self._inv.get(tid)

    def _unk(self) -> tuple[int, ...]:
        if self.unk not in self.vocab:
            raise ValueError(f"tokenizer.json: WordPiece unk_token "
                             f"{self.unk!r} is not in the vocab")
        return (self.vocab[self.unk],)

    def tokenize(self, word: str) -> tuple[int, ...]:
        if len(word) > self.max_chars:
            return self._unk()
        out, at, n = [], 0, len(word)
        while at < n:
            end = n
            while end > at:
                s = word[at:end]
                tid = self.vocab.get(self.prefix + s if at else s)
                if tid is not None:
                    break
                end -= 1
            else:
                return self._unk()
            out.append(tid)
            at = end
        return tuple(out)


def build_model(m: dict) -> Model:
    t = m.get("type")
    if t is None and "merges" in m:
        t = "BPE"
    if t == "BPE":
        return BPE(m)
    if t == "Unigram":
        return Unigram(m)
    if t == "WordPiece":
        return WordPiece(m)
    raise unsupported("model", t)


# ---------------------------------------------------------------------------
# decoders: each maps the list of token strings to a list of strings
# ---------------------------------------------------------------------------

class Decoder:
    def __call__(self, tokens: list[str]) -> list[str]:
        raise NotImplementedError


class DecoderChain(Decoder):
    def __init__(self, steps: list):
        self.steps = steps

    def __call__(self, tokens):
        for st in self.steps:
            tokens = st(tokens)
        return tokens


class ReplaceDecoder(Decoder):
    def __init__(self, pattern: dict, content: str):
        self.norm = Replace(pattern, content)

    def __call__(self, tokens):
        return [self.norm.text(t) for t in tokens]


_HEX = re.compile(r"\+?[0-9a-fA-F]+")


def _fallback_byte(tok: str) -> Optional[int]:
    if (len(tok.encode("utf-8")) == 6 and tok.startswith("<0x")
            and tok.endswith(">") and _HEX.fullmatch(tok[3:5])):
        return int(tok[3:5], 16)
    return None


class ByteFallbackDecoder(Decoder):
    """Runs of ``<0xXX>`` tokens become their bytes' text, or one U+FFFD
    a byte when those bytes are not valid UTF-8."""

    def __call__(self, tokens):
        out: list[str] = []
        run = bytearray()

        def flush():
            if run:
                try:
                    out.append(run.decode("utf-8"))
                except UnicodeDecodeError:
                    out.extend(["\ufffd"] * len(run))
                run.clear()

        for tok in tokens:
            b = _fallback_byte(tok)
            if b is not None:
                run.append(b)
                continue
            flush()
            out.append(tok)
        flush()
        return out


class FuseDecoder(Decoder):
    def __call__(self, tokens):
        return ["".join(tokens)]


class StripDecoder(Decoder):
    def __init__(self, content: str, start: int, stop: int):
        self.content, self.start, self.stop = content, start, stop

    def __call__(self, tokens):
        out = []
        for tok in tokens:
            lo = 0
            for i in range(min(self.start, len(tok))):
                if tok[i] != self.content:
                    break
                lo = i + 1
            hi = len(tok)
            for i in range(min(self.stop, len(tok))):
                j = len(tok) - i - 1
                if tok[j] != self.content:
                    break
                hi = j
            out.append(tok[lo:hi])
        return out


class MetaspaceDecoder(Decoder):
    def __init__(self, replacement: str, prepend_scheme: str):
        self.rep, self.scheme = replacement, prepend_scheme

    def __call__(self, tokens):
        return [t.replace(self.rep, "" if i == 0 and self.scheme != "never"
                          else " ") for i, t in enumerate(tokens)]


def _cleanup(text: str) -> str:
    """The WordPiece decoder's ``cleanup``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" do not", " don't"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        text = text.replace(a, b)
    return text


class WordPieceDecoder(Decoder):
    def __init__(self, prefix: str, cleanup: bool):
        self.prefix, self.cleanup = prefix, cleanup

    def __call__(self, tokens):
        out = []
        for i, t in enumerate(tokens):
            if i:
                t = (t.replace(self.prefix, "", 1)
                     if t.startswith(self.prefix) else " " + t)
            out.append(_cleanup(t) if self.cleanup else t)
        return out


class BPEDecoder(Decoder):
    def __init__(self, suffix: str):
        self.suffix = suffix

    def __call__(self, tokens):
        last = len(tokens) - 1
        return [t.replace(self.suffix, "" if i == last else " ")
                for i, t in enumerate(tokens)]


class ByteLevelDecoder(Decoder):
    """Characters back to bytes (a token with a character outside the
    byte table keeps its own UTF-8); invalid UTF-8 becomes U+FFFD."""

    def __call__(self, tokens):
        table = char_bytes()
        data = bytearray()
        for tok in tokens:
            try:
                data.extend([table[c] for c in tok])
            except KeyError:
                data.extend(tok.encode("utf-8"))
        return [data.decode("utf-8", errors="replace")]


def build_decoder(d) -> Optional[Decoder]:
    if d is None:
        return None
    t = d.get("type")
    if t == "Sequence":
        return DecoderChain([build_decoder(x) for x in d["decoders"]])
    if t == "Replace":
        return ReplaceDecoder(d["pattern"], d["content"])
    if t == "ByteFallback":
        return ByteFallbackDecoder()
    if t == "Fuse":
        return FuseDecoder()
    if t == "Strip":
        return StripDecoder(d["content"], int(d.get("start", 0)),
                            int(d.get("stop", 0)))
    if t == "Metaspace":
        scheme = _prepend_scheme(d)
        return MetaspaceDecoder(d["replacement"], scheme)
    if t == "WordPiece":
        return WordPieceDecoder(d.get("prefix", "##"),
                                bool(d.get("cleanup", True)))
    if t == "BPEDecoder":
        return BPEDecoder(d.get("suffix", "</w>"))
    if t == "ByteLevel":
        return ByteLevelDecoder()
    raise unsupported("decoder", d)


def decode_tokens(decoder: Optional[Decoder], tokens: Sequence[str]) -> str:
    """The library's ``decode`` of the token strings: the decoder chain
    joined, or the tokens joined by spaces without a decoder."""
    if decoder is None:
        return " ".join(tokens)
    return "".join(decoder(list(tokens)))
