"""Token budgeting with exact per-model counts.

Parity with the reference's TokenManager (reference
lib/quoracle/agent/token_manager.ex): history token totals, reactive
condensation trigger at 100% of the window, the 80%-oldest-first condensation
split (token_manager.ex:162-200 "ACE v3.0"), and the dynamic max_tokens
formula of PerModelQuery (reference per_model_query.ex:17-24,136-145:
max_tokens = min(window - margin*input, output_limit), floored at 4096 —
below the floor the round condenses first).

The reference multiplies input by 1.12 because tiktoken only approximates
non-OpenAI tokenizers; our counts come from the serving tokenizer itself, so
the margin is 1.02 (chat-template framing drift only).

The PyTorch port's copy of ``quoracle_tpu/context/token_manager.py``
(``OUTPUT_FLOOR`` from the port's ``models/config.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from quoracle_tpu_torch.context.history import HistoryEntry
from quoracle_tpu_torch.models.config import OUTPUT_FLOOR

DEFAULT_CONTEXT_LIMIT = 128_000   # reference token_manager.ex:9
SAFETY_MARGIN = 1.02
CONDENSE_FRACTION = 0.80          # token_manager.ex:164 "removes >80%"

# (model_spec, text) -> exact token count. The TPU backend provides this from
# its tokenizers; tests inject len-based counters.
CountFn = Callable[[str, str], int]


class TokenManager:
    def __init__(self, count_fn: CountFn,
                 context_limit_fn: Optional[Callable[[str], int]] = None,
                 margin: float = SAFETY_MARGIN):
        self._count = count_fn
        self._limit = context_limit_fn or (lambda spec: DEFAULT_CONTEXT_LIMIT)
        self.margin = margin

    # -- counting ----------------------------------------------------------
    def count(self, model_spec: str, text: Optional[str]) -> int:
        if not text:
            return 0
        return self._count(model_spec, text)

    def entry_tokens(self, model_spec: str, entry: HistoryEntry) -> int:
        return self.count(model_spec, entry.as_text())

    def history_tokens(self, model_spec: str,
                       history: Sequence[HistoryEntry]) -> int:
        return sum(self.entry_tokens(model_spec, e) for e in history)

    def messages_tokens(self, model_spec: str, messages: Sequence[dict]) -> int:
        """Same accounting as ModelBackend.count_message_tokens: content
        tokens + 4/message for the rendered <|role|> framing — the two layers
        must agree or budget math drifts from what encode_chat produces."""
        from quoracle_tpu_torch.utils.normalize import stringify_content
        return sum(self.count(model_spec, stringify_content(m.get("content"))) + 4
                   for m in messages)

    def context_limit(self, model_spec: str) -> int:
        return self._limit(model_spec)

    def usage_fraction(self, model_spec: str,
                       history: Sequence[HistoryEntry]) -> float:
        limit = self.context_limit(model_spec)
        return self.history_tokens(model_spec, history) / max(1, limit)

    # -- condensation triggers (reference token_manager.ex:147-205) --------
    def should_condense(self, model_spec: str,
                        history: Sequence[HistoryEntry]) -> bool:
        """Reactive: trigger only at 100% of the window."""
        return (self.history_tokens(model_spec, history)
                >= self.context_limit(model_spec))

    def split_for_condensation(
        self, model_spec: str, history: Sequence[HistoryEntry],
        total_tokens: Optional[int] = None,
    ) -> tuple[list[HistoryEntry], list[HistoryEntry]]:
        """(to_remove, to_keep): oldest entries covering >80% of tokens are
        removed; the newest tail is kept. Always keeps at least the last 2
        entries so the agent retains its immediate exchange."""
        history = list(history)
        if len(history) <= 2:
            return [], history
        if total_tokens is None:
            total_tokens = self.history_tokens(model_spec, history)
        if total_tokens <= 0:
            return [], history
        target = int(total_tokens * CONDENSE_FRACTION) + 1
        removed, acc = [], 0
        max_remove = len(history) - 2
        for entry in history:
            if acc >= target or len(removed) >= max_remove:
                break
            removed.append(entry)
            acc += self.entry_tokens(model_spec, entry)
        return removed, history[len(removed):]

    # -- dynamic output budget (reference per_model_query.ex:136-145) ------
    def dynamic_max_tokens(self, model_spec: str, input_tokens: int,
                           output_limit: int) -> Optional[int]:
        """Room left for generation, or None if below the output floor —
        None tells the caller to condense before querying. The floor is
        min(OUTPUT_FLOOR, output_limit) so small-window models use their own
        limit as the floor (same formula as TPUBackend.query)."""
        window = self.context_limit(model_spec)
        room = int(window - self.margin * input_tokens)
        if room < min(OUTPUT_FLOOR, output_limit):
            return None
        return max(1, min(room, output_limit))
