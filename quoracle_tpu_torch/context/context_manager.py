"""History -> chat messages.

Parity with the reference's ContextManager (reference
lib/quoracle/agent/context_manager.ex:22-50): chronological messages from a
model's history, consecutive same-role messages merged (many providers and
our chat templates reject role repetition), decision/result entries
JSON-formatted so the model sees its own past decisions and their outcomes
as structured data.

The PyTorch port's copy of ``quoracle_tpu/context/context_manager.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from quoracle_tpu_torch.context.history import (
    DECISION, RESULT, SUMMARY, HistoryEntry,
)
from quoracle_tpu_torch.utils.normalize import to_json


def _strip_images(value, found: list):
    """Recursively pull image payloads out of a result structure, leaving a
    textual marker (reference ImageDetector: base64/URL image parts in
    action results become multimodal message content,
    agent/consensus/image_detector.ex)."""
    if isinstance(value, dict):
        if value.get("image_base64"):
            found.append(str(value["image_base64"]))
            return {**{k: _strip_images(v, found) for k, v in value.items()
                       if k != "image_base64"},
                    "image": f"[attached image #{len(found)}]"}
        return {k: _strip_images(v, found) for k, v in value.items()}
    if isinstance(value, list):
        return [_strip_images(v, found) for v in value]
    return value


def _entry_content(entry: HistoryEntry):
    """str for plain entries; a multimodal parts list when a RESULT carries
    image data (so a VLM pool member actually SEES the fetched image)."""
    if entry.kind == DECISION:
        return "[DECISION] " + (entry.content if isinstance(entry.content, str)
                                else to_json(entry.content))
    if entry.kind == RESULT:
        tag = f" action={entry.action_type}" if entry.action_type else ""
        if isinstance(entry.content, str):
            return f"[RESULT{tag}] {entry.content}"
        images: list[str] = []
        stripped = _strip_images(entry.content, images)
        text = f"[RESULT{tag}] {to_json(stripped)}"
        if images:
            return [{"type": "text", "text": text}] + [
                {"type": "image_base64", "data": b64} for b64 in images]
        return text
    if entry.kind == SUMMARY:
        body = entry.content if isinstance(entry.content, str) else to_json(entry.content)
        return "[CONDENSED HISTORY SUMMARY] " + body
    return entry.as_text()


def _as_parts(content) -> list:
    if isinstance(content, list):
        return content
    return [{"type": "text", "text": content}]


def merge_content(a, b):
    """Append message content; strings stay strings, anything multimodal
    becomes a parts list (adjacent text parts collapse)."""
    if isinstance(a, str) and isinstance(b, str):
        return a + "\n\n" + b
    parts = _as_parts(a) + _as_parts(b)
    out: list = []
    for p in parts:
        if (out and p.get("type") == "text"
                and out[-1].get("type") == "text"):
            out[-1] = {"type": "text",
                       "text": out[-1]["text"] + "\n\n" + p["text"]}
        else:
            out.append(dict(p))
    return out


def build_conversation_messages(
    history: Sequence[HistoryEntry],
    context_summary: Optional[str] = None,
    additional_context: Optional[str] = None,
) -> list[dict]:
    """Chronological chat messages with same-role merge. An optional context
    summary / additional context is prepended as the opening user message
    (reference context_manager.ex:22-50)."""
    messages: list[dict] = []
    preamble_parts = [p for p in (context_summary, additional_context) if p]
    if preamble_parts:
        messages.append({"role": "user", "content": "\n\n".join(preamble_parts)})
    for entry in history:
        role, content = entry.role(), _entry_content(entry)
        if messages and messages[-1]["role"] == role:
            messages[-1]["content"] = merge_content(
                messages[-1]["content"], content)
        else:
            messages.append({"role": role, "content": content})
    if not messages:
        messages.append({"role": "user", "content": "(no history yet)"})
    # Chat templates require the last message to be user-side for a new
    # assistant turn; consensus always queries after an external event, but a
    # decision-tail can occur after restore.
    if messages[-1]["role"] == "assistant":
        messages.append({"role": "user", "content": "(continue)"})
    return messages
