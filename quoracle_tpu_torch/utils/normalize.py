"""Chat-content flattening, copied from ``quoracle_tpu/utils/normalize.py``
(the port keeps its own copy so token counts and chat renders agree with
the JAX package byte for byte)."""

from __future__ import annotations

import json
from typing import Any


def normalize_json(value: Any) -> Any:
    """Make a value JSON-serializable: tuples/sets -> lists, exceptions ->
    tagged dicts, bytes -> utf-8 (replace), unknown objects -> repr."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, bytes):
        return value.decode("utf-8", errors="replace")
    if isinstance(value, dict):
        return {str(k): normalize_json(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [normalize_json(v) for v in value]
    if isinstance(value, (set, frozenset)):
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
    text for token counting / chat rendering. Image parts become a
    placeholder marker, never their payload."""
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
                    parts.append("[image]")
                else:
                    parts.append(to_json(part))
            else:
                parts.append(str(part))
        return "\n".join(parts)
    if isinstance(content, dict):
        return to_json(content)
    return str(content)
