"""Result normalization + truncation utilities.

Parity with the reference's Utils.JSONNormalizer / ContentStringifier /
ResponseTruncator (reference lib/quoracle/utils/ — SURVEY.md §2.6): action
results and histories must serialize to JSON deterministically before they
enter model context or the DB, multimodal content must flatten to text for
token counting, and oversized outputs must truncate with an explicit marker
rather than silently blowing the context window.

The PyTorch port's copy of ``quoracle_tpu/utils/normalize.py`` (token
counts, chat renders and history JSON agree with the JAX package byte for
byte).
"""

from __future__ import annotations

import json
from typing import Any

TRUNCATION_MARKER = "\n...[truncated {omitted} of {total} chars]..."
DEFAULT_MAX_CHARS = 30_000


def normalize_json(value: Any) -> Any:
    """Make a value JSON-serializable: tuples/sets -> lists, exceptions ->
    tagged dicts, bytes -> utf-8 (replace), unknown objects -> repr. The
    reference normalizes Elixir tuples to tagged JSON
    (json_normalizer.ex); our equivalent hazard is Python-only types."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, bytes):
        return value.decode("utf-8", errors="replace")
    if isinstance(value, dict):
        return {str(k): normalize_json(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [normalize_json(v) for v in value]
    if isinstance(value, (set, frozenset)):
        # key=repr: mixed-type sets ({1, "a"}) have no natural order and
        # plain sorted() raises TypeError; repr gives a deterministic one.
        return sorted((normalize_json(v) for v in value), key=repr)
    if isinstance(value, BaseException):
        return {"error": type(value).__name__, "message": str(value)}
    if hasattr(value, "__dict__") and not isinstance(value, type):
        try:
            return {"type": type(value).__name__,
                    **{k: normalize_json(v) for k, v in vars(value).items()}}
        except Exception:
            pass
    return repr(value)


def to_json(value: Any, **kwargs: Any) -> str:
    return json.dumps(normalize_json(value), ensure_ascii=False,
                      sort_keys=True, **kwargs)


def stringify_content(content: Any) -> str:
    """Flatten chat-message content (string or multimodal part list) to plain
    text for token counting / logging (reference content_stringifier.ex).
    Image parts become placeholder markers sized like their token cost is
    accounted elsewhere."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        parts = []
        for part in content:
            if isinstance(part, str):
                parts.append(part)
            elif isinstance(part, dict):
                if part.get("type") == "text":
                    parts.append(str(part.get("text", "")))
                elif part.get("type") in ("image", "image_url",
                                          "image_base64"):
                    # NEVER inline image payloads: a base64 body would blow
                    # text-only members' windows and wreck token budgeting
                    parts.append("[image]")
                else:
                    parts.append(to_json(part))
            else:
                parts.append(str(part))
        return "\n".join(parts)
    if isinstance(content, dict):
        return to_json(content)
    return str(content)


def truncate_response(text: str, max_chars: int = DEFAULT_MAX_CHARS) -> str:
    """Head+tail truncation with an explicit marker (reference
    response_truncator.ex). Keeps both ends: shell output errors usually live
    at the tail, context at the head."""
    if len(text) <= max_chars:
        return text
    marker = TRUNCATION_MARKER.format(
        omitted=len(text) - max_chars, total=len(text))
    keep = max_chars - len(marker)
    head = keep * 2 // 3
    tail = keep - head
    return text[:head] + marker + (text[-tail:] if tail > 0 else "")
