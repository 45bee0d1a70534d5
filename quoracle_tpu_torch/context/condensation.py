"""Condensation: shrink a model's history when its window fills.

Parity with the reference's Condensation (reference
lib/quoracle/agent/consensus/per_model_query/condensation.ex):

* inline — the model itself returns ``"condense": N`` and its N oldest
  entries are condensed (clamped to len-2; reference condensation.ex:38-48);
* token-threshold — triggered reactively at 100% of the window or when the
  dynamic output budget falls below the floor (reference
  per_model_query.ex:86-131,149-196): the oldest >80% of tokens are removed.

Removed entries go through ACE reflection (context/reflector.py) and are
replaced by a single SUMMARY entry; extracted lessons merge into the
store via embedding dedup (context/lessons.py). A progress guarantee holds
throughout: condensation always strictly shrinks the history (reference
agent AGENTS.md:19).

The PyTorch port's copy of ``quoracle_tpu/context/condensation.py``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

from quoracle_tpu_torch.context.history import (
    SUMMARY, AgentContext, HistoryEntry,
)
from quoracle_tpu_torch.context.lessons import Embedder, accumulate_lessons
from quoracle_tpu_torch.context.reflector import Reflection, reflect
from quoracle_tpu_torch.context.token_manager import TokenManager

logger = logging.getLogger(__name__)

# Injectable reflection seam (reference reflector_fn): (model_spec, entries)
# -> Reflection. Production binds context/reflector.reflect to a backend.
ReflectFn = Callable[[str, list[HistoryEntry]], Reflection]


def make_reflect_fn(backend, summarization_model_fn=None,
                    cost_fn=None) -> ReflectFn:
    """``summarization_model_fn`` resolves the configured summarization
    model LAZILY per reflection (the DB setting can change at runtime) —
    guarded: a transient DB error must degrade to the default model, not
    break reflect()'s never-raises progress guarantee. ``cost_fn(model,
    usage)`` records reflection + pre-summarization spend."""
    def fn(model_spec, entries):
        sm = None
        if summarization_model_fn is not None:
            try:
                sm = summarization_model_fn()
            except Exception:         # noqa: BLE001 — settings read only
                logger.warning("summarization_model lookup failed",
                               exc_info=True)
        return reflect(backend, model_spec, entries,
                       summarization_model=sm, cost_fn=cost_fn)
    return fn


@dataclasses.dataclass
class CondensationResult:
    condensed: bool
    removed_entries: int = 0
    lessons_added: int = 0


def _apply(ctx: AgentContext, model_spec: str, removed: list[HistoryEntry],
           kept: list[HistoryEntry], reflect_fn: ReflectFn,
           embedder: Optional[Embedder]) -> CondensationResult:
    reflection = reflect_fn(model_spec, removed)
    summary = HistoryEntry(kind=SUMMARY, content=reflection.summary_text)
    ctx.model_histories[model_spec] = [summary] + kept
    # state is REPLACED each condensation; lessons ACCUMULATE (reference
    # reflector.ex moduledoc)
    if reflection.state:
        ctx.model_states[model_spec] = reflection.state
    added = 0
    if reflection.lessons:
        if embedder is not None:
            before = len(ctx.context_lessons.get(model_spec, []))
            ctx.context_lessons[model_spec] = accumulate_lessons(
                ctx.context_lessons.get(model_spec, []), reflection.lessons,
                embedder)
            added = len(ctx.context_lessons[model_spec]) - before
        else:
            ctx.context_lessons.setdefault(model_spec, []).extend(reflection.lessons)
            added = len(reflection.lessons)
    return CondensationResult(condensed=True, removed_entries=len(removed),
                              lessons_added=added)


def inline_condense(ctx: AgentContext, model_spec: str, n: int,
                    reflect_fn: ReflectFn,
                    embedder: Optional[Embedder] = None) -> CondensationResult:
    """Model-requested: condense the N oldest entries (clamp to len-2)."""
    history = ctx.history(model_spec)
    if len(history) <= 2 or n <= 0:
        return CondensationResult(condensed=False)
    n = min(n, len(history) - 2)
    removed, kept = history[:n], history[n:]
    return _apply(ctx, model_spec, removed, kept, reflect_fn, embedder)


def condense_for_tokens(ctx: AgentContext, model_spec: str,
                        tm: TokenManager, reflect_fn: ReflectFn,
                        embedder: Optional[Embedder] = None) -> CondensationResult:
    """Token-threshold: remove the oldest >80% of tokens."""
    history = ctx.history(model_spec)
    removed, kept = tm.split_for_condensation(model_spec, history)
    if not removed:
        return CondensationResult(condensed=False)
    return _apply(ctx, model_spec, removed, kept, reflect_fn, embedder)


def ensure_fits(ctx: AgentContext, model_spec: str, tm: TokenManager,
                reflect_fn: ReflectFn, output_limit: int,
                embedder: Optional[Embedder] = None,
                max_iterations: int = 4) -> Optional[int]:
    """Proactive loop before a query (reference per_model_query.ex:149-196):
    condense until the dynamic output budget clears the floor. Returns the
    max_tokens to use, or None if the history cannot be made to fit (caller
    errors loudly)."""
    prev_tokens: Optional[int] = None
    for _ in range(max_iterations):
        input_tokens = tm.history_tokens(model_spec, ctx.history(model_spec))
        budget = tm.dynamic_max_tokens(model_spec, input_tokens, output_limit)
        if budget is not None:
            return budget
        if prev_tokens is not None and input_tokens >= prev_tokens:
            # The last condensation didn't shrink the history (e.g. the
            # replacement summary is as big as the lone removable entry) —
            # stop burning reflection queries on a history that can't fit.
            break
        prev_tokens = input_tokens
        result = condense_for_tokens(ctx, model_spec, tm, reflect_fn, embedder)
        if not result.condensed:
            break
    input_tokens = tm.history_tokens(model_spec, ctx.history(model_spec))
    return tm.dynamic_max_tokens(model_spec, input_tokens, output_limit)
