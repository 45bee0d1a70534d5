"""A reader and writer for the YAML subset of the repo's manifests and
skills (GROVE.md and SKILL.md frontmatter).

The port's own module: it has no counterpart in the JAX package, which
reads frontmatter with PyYAML. The machine that serves the port on the
GPU has no PyYAML, so the port always reads and writes through this
module, and behaves the same wherever it runs.

``load(text)`` equals ``yaml.safe_load(text)`` on the subset:

- block mappings and block sequences (a sequence may sit at its key's
  indentation, and a sequence entry may open a compact mapping);
- flow sequences ``[a, b]``;
- plain scalars (on one line or folded over several), single-quoted and
  double-quoted scalars (with the escapes ``dump_mapping`` writes, as
  PyYAML's emitter does: hex escapes for characters outside printable
  ASCII among them), folded ``>`` and literal ``|`` block scalars
  with their chomping indicator;
- ``#`` comments;
- YAML 1.1's implicit types as PyYAML's SafeLoader resolves them: null,
  bools (``yes``/``no``/``on``/``off``/``true``/``false``), ints
  (decimal, ``0b``, ``0x``, leading-zero octal, ``_`` separators,
  base-60) and floats (``.inf``, ``.nan``, base-60).

Everything else raises :class:`FrontmatterError` (a ``ValueError``) that
names the construct: flow mappings, block scalars' indentation
indicators, other escapes, anchors, aliases, tags, directives, document
markers, complex (``?``) keys, merge keys, timestamps, tabs and
characters YAML does not print. The reader never guesses. A manifest
that needs more extends the subset, with a case against PyYAML.

``dump_mapping(mapping)`` equals ``yaml.safe_dump(mapping,
sort_keys=False)`` for a flat mapping of strings to strings, the shape
``SkillsLoader.create`` writes.

The scanning rules (folding of quoted and plain scalars, block scalar
indentation, where a plain scalar ends) follow PyYAML's scanner
(``yaml/scanner.py``) and the style choice and line splitting follow its
emitter (``yaml/emitter.py``), so that the two agree byte for byte.
"""

from __future__ import annotations

import math
import re
from typing import Any


class FrontmatterError(ValueError):
    """Text outside the supported YAML subset, or malformed YAML."""


_NON_PRINTABLE = re.compile(
    "[^\x0A\x20-\x7E\xA0-\uD7FF\uE000-\uFFFD\U00010000-\U0010FFFF]")
_WS = " \n\0"

# PyYAML's implicit resolvers (yaml/resolver.py), keyed by first
# character, in registration order.
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_MERGE = re.compile(r"^(?:<<)$")
_NULL = re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_VALUE = re.compile(r"^(?:=)$")
_RESOLVERS: dict[str, list] = {}
for _tag, _rx, _first in (
        ("bool", _BOOL, "yYnNtTfFoO"), ("float", _FLOAT, "-+0123456789."),
        ("int", _INT, "-+0123456789"), ("merge", _MERGE, "<"),
        ("null", _NULL, ["~", "n", "N", ""]),
        ("timestamp", _TIMESTAMP, "0123456789"), ("value", _VALUE, "=")):
    for _ch in _first:
        _RESOLVERS.setdefault(_ch, []).append((_tag, _rx))

# the double-quoted escapes PyYAML's emitter writes, and so dump_mapping:
# these, \x, \u and \U for the other characters outside printable ASCII,
# and "\ " for a space that starts a line of a split scalar
_DQ_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t",
               "\x0A": "n", "\x0B": "v", "\x0C": "f", "\x0D": "r",
               "\x1B": "e", '"': '"', "\\": "\\", "\x85": "N",
               "\xA0": "_", "\u2028": "L", "\u2029": "P"}
_ESCAPES = {code: ch for ch, code in _DQ_ESCAPES.items()} | {" ": " "}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}


def implicit_tag(value: str) -> str:
    """The type a plain scalar ``value`` reads as under YAML 1.1's
    implicit resolution (PyYAML's ``Resolver.resolve``): "str" when no
    resolver matches."""
    for tag, rx in _RESOLVERS.get(value[:1], ()):
        if rx.match(value):
            return tag
    return "str"


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        total, base = 0, 1
        for part in reversed(value.split(":")):
            total += int(part) * base
            base *= 60
        return sign * total
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        total, base = 0.0, 1
        for part in reversed(value.split(":")):
            total += float(part) * base
            base *= 60
        return sign * total
    return sign * float(value)


def _resolve_plain(value: str) -> Any:
    tag = implicit_tag(value)
    if tag == "str":
        return value
    if tag == "null":
        return None
    if tag == "bool":
        return value.lower() in ("yes", "true", "on")
    if tag == "int":
        return _to_int(value)
    if tag == "float":
        return _to_float(value)
    raise FrontmatterError(
        f"a {tag} scalar ({value!r}) is outside the supported YAML subset")


_INDICATORS = {"&": "an anchor", "*": "an alias", "!": "a tag",
               "%": "a directive", "@": "a reserved indicator '@'",
               "`": "a reserved indicator '`'", "?": "a complex key ('?')",
               ",": "a flow indicator ','", "]": "a flow indicator ']'",
               "{": "a flow mapping ('{')", "}": "a flow indicator '}'"}


class _Parser:
    def __init__(self, text: str):
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        for ch, what in (("\u2028", "line separator"),
                         ("\u2029", "paragraph separator"),
                         ("\uFEFF", "byte order mark")):
            if ch in text:
                raise FrontmatterError(
                    f"a {what} (U+{ord(ch):04X}) is outside the supported "
                    f"YAML subset")
        if "\t" in text:
            raise FrontmatterError(
                f"tab character at line "
                f"{text.count(chr(10), 0, text.index(chr(9))) + 1}: tabs are "
                f"outside the supported YAML subset")
        bad = _NON_PRINTABLE.search(text)
        if bad:
            raise FrontmatterError(
                f"character {bad.group()!r} is outside the supported YAML "
                f"subset")
        for n, line in enumerate(text.split("\n"), 1):
            if line[:3] in ("---", "...") and line[3:4] in ("", " "):
                raise FrontmatterError(
                    f"document marker {line[:3]!r} at line {n} is outside "
                    f"the supported YAML subset")
            if line.startswith("%"):
                raise FrontmatterError(
                    f"a directive at line {n} is outside the supported "
                    f"YAML subset")
        self.s = text
        self.i = 0

    # -- position ------------------------------------------------------

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else "\0"

    def col(self) -> int:
        return self.i - (self.s.rfind("\n", 0, self.i) + 1)

    def err(self, what: str) -> FrontmatterError:
        line = self.s.count("\n", 0, self.i) + 1
        return FrontmatterError(f"{what} (line {line}, column "
                                f"{self.col() + 1})")

    def at_comment(self) -> bool:
        if self.peek() != "#":
            return False
        if self.i and self.s[self.i - 1] not in " \n":
            raise self.err("a '#' comment needs a space before it")
        return True

    def skip_blank(self) -> None:
        """Spaces, comments and line breaks up to the next content."""
        while True:
            while self.peek() == " ":
                self.i += 1
            if self.at_comment():
                while self.peek() not in "\n\0":
                    self.i += 1
            if self.peek() == "\n":
                self.i += 1
                continue
            return

    def end_of_line(self) -> None:
        while self.peek() == " ":
            self.i += 1
        if self.at_comment():
            while self.peek() not in "\n\0":
                self.i += 1
        ch = self.peek()
        if ch not in "\n\0":
            if ch == ":":
                raise self.err("a mapping value where none is allowed "
                               "(a 'key: value' on the line of its parent, "
                               "or a key over several lines)")
            raise self.err(f"unexpected {ch!r} after a value")

    # -- documents and block nodes -------------------------------------

    def document(self) -> Any:
        self.skip_blank()
        if self.peek() == "\0":
            return None
        node = self.node(-1)
        self.skip_blank()
        if self.peek() != "\0":
            raise self.err("content outside the top node (bad "
                           "indentation?)")
        return node

    def node(self, indent: int) -> Any:
        """A block node that starts a line at a column > ``indent``."""
        if self.peek() == "-" and self.peek(1) in _WS:
            return self.block_seq(self.col(), indentless=False)
        if self.key_ahead():
            return self.block_map(self.col())
        return self.inline_value(indent)

    def key_ahead(self) -> bool:
        """Whether a single-line simple key and its ': ' start here."""
        start = self.i
        try:
            ch = self.peek()
            if ch in "\"'":
                self.quoted()
            elif self.plain_starts(flow=False):
                self.plain(-1, flow=False)
            else:
                return False
            if "\n" in self.s[start:self.i]:
                return False
            while self.peek() == " ":
                self.i += 1
            return self.peek() == ":" and self.peek(1) in _WS
        except FrontmatterError:
            return False
        finally:
            self.i = start

    def key(self) -> Any:
        if self.peek() in "\"'":
            key = self.quoted()
        else:
            key = _resolve_plain(self.plain(-1, flow=False))
        while self.peek() == " ":
            self.i += 1
        self.i += 1                       # ':'
        return key

    def block_map(self, m: int) -> dict:
        out: dict = {}
        while True:
            key = self.key()
            out[key] = self.map_value(m)
            self.skip_blank()
            if self.peek() == "\0" or self.col() < m:
                return out
            if self.col() > m:
                raise self.err("bad indentation of a mapping entry")
            if not self.key_ahead():
                raise self.err(f"expected a 'key:' at column {m + 1}")

    def map_value(self, m: int) -> Any:
        while self.peek() == " ":
            self.i += 1
        if self.peek() in "\n\0" or self.at_comment():
            self.end_of_line()
            self.skip_blank()
            if self.peek() == "\0":
                return None
            c = self.col()
            if c == m and self.peek() == "-" and self.peek(1) in _WS:
                return self.block_seq(m, indentless=True)
            if c <= m:
                return None
            return self.node(m)
        if self.peek() == "-" and self.peek(1) in _WS:
            raise self.err("a block sequence on the line of its key")
        if self.key_ahead():
            raise self.err("a mapping on the line of its key")
        return self.inline_value(m)

    def block_seq(self, s: int, *, indentless: bool) -> list:
        out = []
        while True:
            self.i += 1                   # '-'
            out.append(self.seq_item(s))
            self.skip_blank()
            if self.peek() == "\0" or self.col() < s:
                return out
            if self.col() > s:
                raise self.err("bad indentation of a sequence entry")
            if self.peek() == "-" and self.peek(1) in _WS:
                continue
            if indentless:
                return out
            raise self.err(f"expected '- ' at column {s + 1}")

    def seq_item(self, s: int) -> Any:
        while self.peek() == " ":
            self.i += 1
        if self.peek() in "\n\0" or self.at_comment():
            self.end_of_line()
            self.skip_blank()
            if self.peek() == "\0" or self.col() <= s:
                return None
            return self.node(s)
        if self.peek() == "-" and self.peek(1) in _WS:
            return self.block_seq(self.col(), indentless=False)
        if self.key_ahead():
            return self.block_map(self.col())
        return self.inline_value(s)

    def inline_value(self, indent: int) -> Any:
        """A scalar or flow collection (or a block scalar) here; the
        enclosing block collection sits at column ``indent``."""
        ch = self.peek()
        if ch in "|>":
            return self.block_scalar(indent)
        if ch == "[":
            value = self.flow_seq()
        elif ch in "\"'":
            value = self.quoted()
        elif self.plain_starts(flow=False):
            value = _resolve_plain(self.plain(indent, flow=False))
        else:
            raise self.err(f"{_INDICATORS.get(ch, repr(ch))} is outside "
                           f"the supported YAML subset")
        self.end_of_line()
        return value

    # -- scalars -------------------------------------------------------

    def plain_starts(self, *, flow: bool) -> bool:
        ch, nxt = self.peek(), self.peek(1)
        return (ch not in "\0 \n-?:,[]{}#&*!|>'\"%@`"
                or (nxt not in _WS
                    and (ch == "-" or (not flow and ch in "?:"))))

    def plain(self, indent: int, *, flow: bool) -> str:
        """PyYAML's ``scan_plain``; leaves the position at the scalar's
        last character."""
        chunks: list[str] = []
        spaces: list[str] = []
        end = self.i
        stops = _WS + (",[]{}" if flow else "")
        while True:
            if self.peek() == "#":
                break
            n = 0
            while True:
                ch = self.peek(n)
                if (ch in _WS or (ch == ":" and self.peek(n + 1) in stops)
                        or (flow and ch in ",?[]{}")):
                    break
                n += 1
            if n == 0:
                break
            chunks.extend(spaces)
            chunks.append(self.s[self.i:self.i + n])
            self.i += n
            end = self.i
            spaces = self.plain_spaces()
            if (not spaces or self.peek() == "#"
                    or (not flow and self.col() < indent + 1)):
                break
        self.i = end
        return "".join(chunks)

    def plain_spaces(self) -> list[str]:
        n = 0
        while self.peek(n) == " ":
            n += 1
        whitespace = self.s[self.i:self.i + n]
        self.i += n
        if self.peek() == "\n":
            self.i += 1
            breaks = []
            while self.peek() in " \n":
                if self.peek() == "\n":
                    breaks.append("\n")
                self.i += 1
            return breaks or [" "]
        return [whitespace] if whitespace else []

    def quoted(self) -> str:
        """PyYAML's ``scan_flow_scalar`` (single or double quotes)."""
        quote = self.peek()
        double = quote == '"'
        self.i += 1
        chunks: list[str] = []
        while True:
            self.quoted_non_spaces(double, chunks)
            if self.peek() == quote:
                self.i += 1
                return "".join(chunks)
            self.quoted_spaces(chunks)

    def quoted_non_spaces(self, double: bool, chunks: list) -> None:
        while True:
            n = 0
            while self.peek(n) not in "'\"\\\0 \n":
                n += 1
            if n:
                chunks.append(self.s[self.i:self.i + n])
                self.i += n
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.i += 2
            elif (double and ch == "'") or (not double and ch in "\"\\"):
                chunks.append(ch)
                self.i += 1
            elif double and ch == "\\":
                self.i += 1
                ch = self.peek()
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.i += 1
                elif ch in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[ch]
                    self.i += 1
                    digits = self.s[self.i:self.i + n]
                    if len(digits) < n or any(
                            d not in "0123456789ABCDEFabcdef"
                            for d in digits):
                        raise self.err(f"a \\{ch} escape needs {n} hex "
                                       f"digits")
                    chunks.append(chr(int(digits, 16)))
                    self.i += n
                elif ch == "\n":
                    self.i += 1
                    chunks.extend(self.quoted_breaks())
                else:
                    raise self.err(f"unknown escape \\{ch} (outside the "
                                   f"supported YAML subset)")
            else:
                return

    def quoted_spaces(self, chunks: list) -> None:
        n = 0
        while self.peek(n) == " ":
            n += 1
        whitespace = self.s[self.i:self.i + n]
        self.i += n
        ch = self.peek()
        if ch == "\0":
            raise self.err("end of text inside a quoted scalar")
        if ch == "\n":
            self.i += 1
            breaks = self.quoted_breaks()
            chunks.extend(breaks or [" "])
        else:
            chunks.append(whitespace)

    def quoted_breaks(self) -> list[str]:
        breaks = []
        while True:
            while self.peek() == " ":
                self.i += 1
            if self.peek() != "\n":
                return breaks
            breaks.append("\n")
            self.i += 1

    def block_scalar(self, indent: int) -> str:
        """PyYAML's ``scan_block_scalar``: ``|`` or ``>``, then the
        chomping indicator (``+``/``-``), its indentation detected."""
        folded = self.peek() == ">"
        self.i += 1
        chomping = None
        if self.peek() in "+-":
            chomping = self.peek() == "+"
            self.i += 1
        if self.peek() in "0123456789":
            raise self.err("a block scalar's indentation indicator is "
                           "outside the supported YAML subset")
        if self.peek() not in _WS:
            raise self.err("expected a line break after a block scalar's "
                           "indicator")
        self.end_of_line()
        if self.peek() == "\n":
            self.i += 1
        breaks, max_indent = self.block_indentation()
        ind = max(indent + 1, 1, max_indent)
        chunks: list[str] = []
        line_break = ""
        while self.col() == ind and self.peek() != "\0":
            chunks.extend(breaks)
            leading_non_space = self.peek() != " "
            n = 0
            while self.peek(n) not in "\n\0":
                n += 1
            chunks.append(self.s[self.i:self.i + n])
            self.i += n
            line_break = ""
            if self.peek() == "\n":
                line_break = "\n"
                self.i += 1
            breaks = self.block_breaks(ind)
            if self.col() == ind and self.peek() != "\0":
                if (folded and line_break == "\n" and leading_non_space
                        and self.peek() != " "):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        return "".join(chunks)

    def block_indentation(self) -> tuple[list[str], int]:
        breaks: list[str] = []
        max_indent = 0
        while self.peek() in " \n":
            if self.peek() == "\n":
                breaks.append("\n")
                self.i += 1
            else:
                self.i += 1
                max_indent = max(max_indent, self.col())
        return breaks, max_indent

    def block_breaks(self, ind: int) -> list[str]:
        breaks: list[str] = []
        while self.col() < ind and self.peek() == " ":
            self.i += 1
        while self.peek() == "\n":
            breaks.append("\n")
            self.i += 1
            while self.col() < ind and self.peek() == " ":
                self.i += 1
        return breaks

    # -- flow collections ----------------------------------------------

    def flow_node(self) -> Any:
        ch = self.peek()
        if ch == "[":
            return self.flow_seq()
        if ch == "{":
            raise self.err(f"{_INDICATORS[ch]} is outside the supported "
                           f"YAML subset")
        if ch in "\"'":
            return self.quoted()
        if ch == "\0":
            raise self.err("end of text inside a flow collection")
        if not self.plain_starts(flow=True):
            raise self.err(f"{_INDICATORS.get(ch, repr(ch))} where a flow "
                           f"node should start")
        return _resolve_plain(self.plain(-1, flow=True))

    def flow_seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip_blank()
            if self.peek() == "]":
                self.i += 1
                return out
            out.append(self.flow_node())
            self.skip_blank()
            ch = self.peek()
            if ch == ":":
                raise self.err("a 'key: value' pair inside a flow "
                               "sequence is outside the supported subset")
            self.i += 1
            if ch == "]":
                return out
            if ch != ",":
                raise self.err("expected ',' or ']' in a flow sequence")


def load(text: str) -> Any:
    """``yaml.safe_load(text)`` for the supported subset; raises
    :class:`FrontmatterError` outside it."""
    return _Parser(text).document()


# ---------------------------------------------------------------------------
# Writer (PyYAML's emitter, for one flat block mapping of strings)
# ---------------------------------------------------------------------------

_BREAKS = "\n\x85\u2028\u2029"
_SPACE_OR_BREAK = "\0 \t\r\n\x85\u2028\u2029"


def _analyze(scalar: str) -> dict:
    """PyYAML's ``Emitter.analyze_scalar`` (allow_unicode=False): which
    styles may carry ``scalar``."""
    if not scalar:
        return dict(empty=True, multiline=False, block_plain=True,
                    single=True)
    block_ind = flow_ind = line_breaks = special = False
    leading_space = leading_break = trailing_space = trailing_break = False
    break_space = space_break = False
    if scalar.startswith(("---", "...")):
        block_ind = flow_ind = True
    preceded_by_ws = True
    followed_by_ws = len(scalar) == 1 or scalar[1] in _SPACE_OR_BREAK
    previous_space = previous_break = False
    for index, ch in enumerate(scalar):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                flow_ind = block_ind = True
            if ch in "?:":
                flow_ind = True
                if followed_by_ws:
                    block_ind = True
            if ch == "-" and followed_by_ws:
                flow_ind = block_ind = True
        else:
            if ch in ",?[]{}":
                flow_ind = True
            if ch == ":":
                flow_ind = True
                if followed_by_ws:
                    block_ind = True
            if ch == "#" and preceded_by_ws:
                flow_ind = block_ind = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
            special = True
        if ch == " ":
            if index == 0:
                leading_space = True
            if index == len(scalar) - 1:
                trailing_space = True
            if previous_break:
                break_space = True
            previous_space, previous_break = True, False
        elif ch in _BREAKS:
            if index == 0:
                leading_break = True
            if index == len(scalar) - 1:
                trailing_break = True
            if previous_space:
                space_break = True
            previous_space, previous_break = False, True
        else:
            previous_space = previous_break = False
        preceded_by_ws = ch in _SPACE_OR_BREAK
        followed_by_ws = (index + 2 >= len(scalar)
                          or scalar[index + 2] in _SPACE_OR_BREAK)
    block_plain = single = True
    if leading_space or leading_break or trailing_space or trailing_break:
        block_plain = False
    if break_space:
        block_plain = single = False
    if space_break or special:
        block_plain = single = False
    if line_breaks or block_ind:
        block_plain = False
    return dict(empty=False, multiline=line_breaks,
                block_plain=block_plain, single=single)


class _Emitter:
    """The part of PyYAML's emitter state a block mapping of strings
    uses: column, whether the last write was whitespace or indentation,
    and the indent of the value being written."""

    best_width = 80

    def __init__(self):
        self.out: list[str] = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.indent = 0

    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def write_indicator(self, indicator: str, need_whitespace: bool) -> None:
        data = indicator if self.whitespace or not need_whitespace \
            else " " + indicator
        self.whitespace = False
        self.indention = False
        self.write(data)

    def line_break(self, data: str = "\n") -> None:
        self.whitespace = self.indention = True
        self.column = 0
        self.out.append(data)

    def write_indent(self) -> None:
        if (not self.indention or self.column > self.indent
                or (self.column == self.indent and not self.whitespace)):
            self.line_break()
        if self.column < self.indent:
            self.whitespace = True
            self.write(" " * (self.indent - self.column))

    def write_plain(self, text: str, split: bool) -> None:
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if (start + 1 == end and self.column > self.best_width
                            and split):
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    if text[start] == "\n":
                        self.line_break()
                    for br in text[start:end]:
                        self.line_break(br)
                    self.write_indent()
                    self.whitespace = self.indention = False
                    start = end
            elif ch is None or ch in " " + _BREAKS:
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1

    def write_single_quoted(self, text: str, split: bool) -> None:
        self.write_indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > self.best_width
                            and split and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    if text[start] == "\n":
                        self.line_break()
                    for br in text[start:end]:
                        self.line_break(br)
                    self.write_indent()
                    start = end
            elif ch is None or ch in " " + _BREAKS or ch == "'":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1
        self.write_indicator("'", False)

    def write_double_quoted(self, text: str, split: bool) -> None:
        self.write_indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if (ch is None or ch in '"\\\x85\u2028\u2029\uFEFF'
                    or not "\x20" <= ch <= "\x7E"):
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _DQ_ESCAPES:
                        data = "\\" + _DQ_ESCAPES[ch]
                    elif ch <= "\xFF":
                        data = "\\x%02X" % ord(ch)
                    elif ch <= "\uFFFF":
                        data = "\\u%04X" % ord(ch)
                    else:
                        data = "\\U%08X" % ord(ch)
                    self.write(data)
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > self.best_width
                    and split):
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.write_indicator('"', False)


def dump_mapping(mapping: dict) -> str:
    """``yaml.safe_dump(mapping, sort_keys=False)`` for a flat mapping
    of strings to strings whose keys are plain simple keys."""
    if not isinstance(mapping, dict) or not mapping:
        raise FrontmatterError("dump_mapping writes a non-empty mapping")
    e = _Emitter()
    first = True
    for key, value in mapping.items():
        if not isinstance(key, str) or not isinstance(value, str):
            raise FrontmatterError(
                "dump_mapping writes string keys and string values only")
        a = _analyze(key)
        if (a["empty"] or a["multiline"] or not a["block_plain"]
                or implicit_tag(key) != "str" or len(key) >= 128):
            raise FrontmatterError(
                f"key {key!r} is not a plain simple key")
        e.indent = 0
        if not first:
            e.write_indent()
        first = False
        e.indent = 2
        e.write_plain(key, split=False)
        e.indent = 0
        e.write_indicator(":", False)
        e.indent = 2
        a = _analyze(value)
        if implicit_tag(value) == "str" and a["block_plain"]:
            e.write_plain(value, split=True)
        elif a["single"]:
            e.write_single_quoted(value, split=True)
        else:
            e.write_double_quoted(value, split=True)
    e.indent = 0
    e.write_indent()
    return "".join(e.out)
