"""Single source of truth for consensus message assembly.

Parity with the reference's MessageBuilder — both the LLM-query path and the
UI logging path call this one function, and the injection order is fixed
(reference lib/quoracle/agent/consensus/message_builder.ex:9-20):

  1. base messages from the model's history
  2. ACE context (lessons + state) into the FIRST user message
  3. refinement prompt appended (consensus refinement rounds)
  4. TODO context into the LAST message
  5. children context into the LAST message
  6. system prompt (profile, action schemas — caller supplies the string)
  7. budget context into the LAST message
  7.5 correction feedback PREPENDED into the last message (appears first)
  8. context token count at the END of the last user message

The PyTorch port's copy of ``quoracle_tpu/context/message_builder.py``.
"""

from __future__ import annotations

from typing import Optional

from quoracle_tpu_torch.context.context_manager import build_conversation_messages
from quoracle_tpu_torch.context.history import AgentContext
from quoracle_tpu_torch.context.token_manager import TokenManager
from quoracle_tpu_torch.utils.normalize import to_json


from quoracle_tpu_torch.context.context_manager import merge_content


def _append_to_last(messages: list[dict], block: str) -> None:
    messages[-1]["content"] = merge_content(messages[-1]["content"], block)


def _prepend_to_last(messages: list[dict], block: str) -> None:
    messages[-1]["content"] = merge_content(block, messages[-1]["content"])


def _ace_block(ctx: AgentContext, model_spec: str) -> Optional[str]:
    lessons = ctx.context_lessons.get(model_spec, [])
    states = ctx.model_states.get(model_spec, [])
    if not lessons and not states:
        return None
    parts = ["[ACCUMULATED CONTEXT — lessons and state from condensed history]"]
    if lessons:
        parts.append("Lessons:")
        parts += [f"- ({l.type}, confidence {l.confidence}) {l.content}"
                  for l in lessons]
    if states:
        parts.append("Current state summary:")
        parts += [f"- {s}" for s in states]
    return "\n".join(parts)


def build_messages_for_model(
    ctx: AgentContext,
    model_spec: str,
    system_prompt: Optional[str] = None,
    refinement_prompt: Optional[str] = None,
    token_manager: Optional[TokenManager] = None,
) -> list[dict]:
    # 1. base
    messages = build_conversation_messages(
        ctx.history(model_spec), context_summary=ctx.context_summary)

    # 2. ACE into FIRST user message (historical knowledge belongs at the top)
    ace = _ace_block(ctx, model_spec)
    if ace:
        for m in messages:
            if m["role"] == "user":
                m["content"] = merge_content(ace, m["content"])
                break

    # 3. refinement prompt (a fresh user turn: the refinement is the newest event)
    if refinement_prompt:
        messages.append({"role": "user", "content": refinement_prompt})

    # 4. TODO (current state)
    if ctx.todos:
        _append_to_last(messages, "[CURRENT TODO LIST]\n" + to_json(ctx.todos))

    # 5. children (current state)
    if ctx.children:
        _append_to_last(
            messages, "[ACTIVE CHILD AGENTS]\n" + to_json(ctx.children))

    # 6. system prompt
    if system_prompt:
        messages.insert(0, {"role": "system", "content": system_prompt})

    # 7. budget
    if ctx.budget_snapshot:
        _append_to_last(
            messages, "[BUDGET]\n" + to_json(ctx.budget_snapshot))

    # 7.5 correction feedback — prepended LAST so it appears FIRST in the
    # final message (the model reads its mistake before anything else)
    correction = ctx.correction_feedback.get(model_spec)
    if correction:
        _prepend_to_last(
            messages, "[CORRECTION — your previous response was invalid]\n"
            + correction)

    # 8. token-count meta at the very end
    if token_manager is not None:
        used = token_manager.messages_tokens(model_spec, messages)
        limit = token_manager.context_limit(model_spec)
        _append_to_last(
            messages,
            f"[CONTEXT: {used} of {limit} tokens used "
            f"({100.0 * used / max(1, limit):.0f}%). Respond with "
            f'"condense": N to condense your N oldest messages.]')

    return messages
