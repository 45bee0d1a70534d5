"""Per-model conversation history + the context slice of agent state.

Each model in the pool keeps its OWN history so each fills its own context
window (reference README.md:642-650 "per-model conversation histories";
state field model_histories in reference lib/quoracle/agent/core/state.ex).
Entries are typed: user/assistant messages, consensus decisions, action
results, condensation summaries. Histories are stored OLDEST-FIRST
(chronological — the reference stores newest-first and reverses; one order,
no reversals, is less error-prone).

The PyTorch port's copy of ``quoracle_tpu/context/history.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

from quoracle_tpu_torch.utils.normalize import to_json

# Entry kinds
USER = "user"              # external/user/parent message
ASSISTANT = "assistant"    # raw model output
DECISION = "decision"      # consensus winner (action + params + reasoning)
RESULT = "result"          # action result delivered back
SUMMARY = "summary"        # condensation marker (replaces removed entries)


@dataclasses.dataclass
class HistoryEntry:
    kind: str                      # one of the constants above
    content: Any                   # str for user/assistant; dict for others
    ts: float = dataclasses.field(default_factory=time.time)
    action_type: Optional[str] = None   # for RESULT: which action produced it

    def as_text(self) -> str:
        """Flat text for token counting and reflection input."""
        if isinstance(self.content, str):
            return self.content
        return to_json(self.content)

    def role(self) -> str:
        """Chat role when serialized to messages. Decisions are the agent's
        own output (assistant); results and summaries arrive as user-side
        context (reference context_manager.ex JSON-formats :decision/:result
        entries into the conversation)."""
        if self.kind in (ASSISTANT, DECISION):
            return "assistant"
        return "user"


@dataclasses.dataclass
class Lesson:
    """ACE lesson: factual or behavioral knowledge that survives condensation
    (reference agent/reflector.ex lesson type)."""
    type: str                      # "factual" | "behavioral"
    content: str
    confidence: int = 1
    embedding: Optional[Any] = None   # np.ndarray, filled by LessonManager


@dataclasses.dataclass
class AgentContext:
    """The context slice of agent state: everything the message builder and
    condensation read/write. The agent Core owns one of these; tests build
    them directly (plain data, no processes)."""

    model_histories: dict[str, list[HistoryEntry]] = dataclasses.field(default_factory=dict)
    # ACE (reference state fields context_lessons / model_states)
    context_lessons: dict[str, list[Lesson]] = dataclasses.field(default_factory=dict)
    model_states: dict[str, list[str]] = dataclasses.field(default_factory=dict)
    # current-state injections
    todos: list[dict] = dataclasses.field(default_factory=list)
    children: list[dict] = dataclasses.field(default_factory=list)
    budget_snapshot: Optional[dict] = None
    correction_feedback: dict[str, str] = dataclasses.field(default_factory=dict)
    context_summary: Optional[str] = None

    def history(self, model_spec: str) -> list[HistoryEntry]:
        return self.model_histories.setdefault(model_spec, [])

    def append_all(self, entry: HistoryEntry, model_pool: list[str]) -> None:
        """Append one entry to every pool member's history (external events
        are shared; model outputs are per-model)."""
        for spec in model_pool:
            self.history(spec).append(entry)

    def append(self, model_spec: str, entry: HistoryEntry) -> None:
        self.history(model_spec).append(entry)
