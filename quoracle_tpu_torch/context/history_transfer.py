"""Runtime model-pool switching (HistoryTransfer).

Parity with the reference's HistoryTransfer (reference
lib/quoracle/agent/history_transfer.ex, invoked via Core.switch_model_pool,
core.ex:115-127,257-263): when an agent's pool changes mid-task, each
incoming model inherits the conversation rather than starting cold —

* the SOURCE history for a new model is the largest old-pool history that
  already fits the new model's window (token counts taken with the NEW
  model's tokenizer — windows and tokenizers both differ across families);
* if nothing fits, the overall largest history is taken and condensed until
  it fits (the normal ensure_fits loop, with ACE reflection of what's
  removed);
* the ACE slice (lessons + state summaries) is re-keyed from the same source
  model, so learned knowledge survives the switch;
* old-pool-only histories are dropped, and the caller drops the old pool's
  resident KV sessions — the cached prompt prefixes no longer match any
  live history.

Pure context surgery: no backend calls except through the injected
reflect_fn/embedder (the condensation seams), so tests drive it without
models.

The PyTorch port's copy of
``quoracle_tpu/context/history_transfer.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from quoracle_tpu_torch.context.condensation import ReflectFn, ensure_fits
from quoracle_tpu_torch.context.history import AgentContext
from quoracle_tpu_torch.context.lessons import Embedder
from quoracle_tpu_torch.context.token_manager import TokenManager


@dataclasses.dataclass
class TransferReport:
    """What happened, for logging/assertions."""
    source_for: dict[str, str] = dataclasses.field(default_factory=dict)
    condensed: dict[str, bool] = dataclasses.field(default_factory=dict)
    dropped_models: list[str] = dataclasses.field(default_factory=list)


def transfer_histories(
    ctx: AgentContext,
    old_pool: list[str],
    new_pool: list[str],
    tm: TokenManager,
    reflect_fn: ReflectFn,
    output_limit_fn: Callable[[str], int],
    embedder: Optional[Embedder] = None,
) -> TransferReport:
    """Mutate ``ctx`` in place from old_pool keying to new_pool keying."""
    report = TransferReport()
    # Source candidates come from the OLD pool's histories as they stand now
    # (snapshot — new-pool writes below must not become candidates).
    candidates = {m: list(ctx.model_histories.get(m, [])) for m in old_pool}

    for m in new_pool:
        if m in candidates:
            continue  # model kept across pools: its history stays its own
        out_limit = output_limit_fn(m)
        # Rank old histories by size under the NEW model's tokenizer; prefer
        # the largest that already fits, else condense the overall largest
        # (reference: "pick largest fitting history, condense until fits").
        ranked = sorted(
            ((tm.history_tokens(m, h), src) for src, h in candidates.items()),
            key=lambda t: t[0], reverse=True)
        if not ranked:
            continue  # no old pool at all: new model starts cold
        fitting = [src for tokens, src in ranked
                   if tm.dynamic_max_tokens(m, tokens, out_limit) is not None]
        chosen = fitting[0] if fitting else ranked[0][1]
        ctx.model_histories[m] = list(candidates[chosen])
        # Copy lessons per model: accumulate_lessons mutates confidence in
        # place, so shared Lesson objects would couple the new models' ACE.
        ctx.context_lessons[m] = [dataclasses.replace(les) for les in
                                  ctx.context_lessons.get(chosen, [])]
        ctx.model_states[m] = list(ctx.model_states.get(chosen, []))
        report.source_for[m] = chosen
        if not fitting:
            ensure_fits(ctx, m, tm, reflect_fn, out_limit, embedder=embedder)
            report.condensed[m] = True

    keep = set(new_pool)
    for m in list(ctx.model_histories):
        if m not in keep:
            del ctx.model_histories[m]
            ctx.context_lessons.pop(m, None)
            ctx.model_states.pop(m, None)
            report.dropped_models.append(m)
    ctx.correction_feedback = {k: v for k, v in ctx.correction_feedback.items()
                               if k in keep}
    return report
