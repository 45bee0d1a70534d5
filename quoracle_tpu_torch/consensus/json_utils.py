"""Robust JSON recovery from LLM output.

Parity with the reference's JsonExtractor
(reference lib/quoracle/utils/json_extractor.ex): models wrap JSON in
markdown fences, prepend prose, or emit trailing commentary; recover the
object rather than failing the round. On-device serving will eventually add
grammar-constrained decoding (SURVEY.md §7 hard part 4), which makes this a
fallback instead of the common path.

The PyTorch port's own copy of
``quoracle_tpu/consensus/json_utils.py``, line for line but for its
imports, so the parity tests can compare the two packages' outputs
field by field.
"""

from __future__ import annotations

import json
import re
from typing import Any, Optional

_FENCE_RE = re.compile(r"```(?:json)?\s*(.*?)```", re.DOTALL)


def extract_json(text: str) -> Optional[Any]:
    """Best-effort extraction of the first JSON object/array in text."""
    if not text:
        return None
    # 1. Whole string is JSON.
    parsed = _try(text)
    if parsed is not None:
        return parsed
    # 2. Markdown fence contents.
    for m in _FENCE_RE.finditer(text):
        parsed = _try(m.group(1))
        if parsed is not None:
            return parsed
    # 3. First balanced {...} or [...] span.
    for opener, closer in (("{", "}"), ("[", "]")):
        span = _balanced_span(text, opener, closer)
        if span is not None:
            parsed = _try(span)
            if parsed is not None:
                return parsed
    return None


def _try(s: str) -> Optional[Any]:
    s = s.strip()
    if not s or s[0] not in "{[":
        return None
    try:
        return json.loads(s)
    except (json.JSONDecodeError, ValueError):
        return None


def _balanced_span(text: str, opener: str, closer: str) -> Optional[str]:
    start = text.find(opener)
    if start < 0:
        return None
    depth = 0
    in_str = False
    escape = False
    for i in range(start, len(text)):
        ch = text[i]
        if in_str:
            if escape:
                escape = False
            elif ch == "\\":
                escape = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch == opener:
            depth += 1
        elif ch == closer:
            depth -= 1
            if depth == 0:
                return text[start:i + 1]
    return None


def normalize_json_value(value: Any) -> Any:
    """Canonical deep-sorted form for structural fingerprinting: dict keys
    sorted, nested normalized (reference aggregator deep-sorted-map rule)."""
    if isinstance(value, dict):
        return {k: normalize_json_value(value[k]) for k in sorted(value)}
    if isinstance(value, list):
        return [normalize_json_value(v) for v in value]
    return value


def stable_dumps(value: Any) -> str:
    return json.dumps(normalize_json_value(value), sort_keys=True,
                      separators=(",", ":"), ensure_ascii=False)
