"""Prompt fields: agent identity composition + constraint accumulation.

Parity with the reference's Fields subsystem (reference
lib/quoracle/fields/ — PromptFieldManager: *injected* task-level fields
(global context, constraints) vs *provided* per-agent fields (role,
cognitive style, …); parent→child transformation; ConstraintAccumulator
carries constraints down the spawn tree so a child can never escape an
ancestor's constraint; CognitiveStyles maps style atoms to reasoning
directives, reference fields/cognitive_styles.ex:6-40).

The PyTorch port's copy of ``quoracle_tpu/governance/fields.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# Style atom → reasoning directive. Same vocabulary as the reference's
# style set; directive text is our own.
COGNITIVE_STYLES: dict[str, str] = {
    "systematic": (
        "Work systematically: decompose the task into explicit steps, "
        "execute them in order, and verify each step's outcome before "
        "moving on."),
    "creative": (
        "Favor novel approaches: generate multiple distinct options before "
        "committing, and prefer an unconventional path when the obvious one "
        "is weak."),
    "skeptical": (
        "Challenge assumptions: actively look for reasons the current plan "
        "or claim is wrong, and demand evidence before accepting results."),
    "collaborative": (
        "Coordinate actively: keep your parent and children informed of "
        "progress, surface blockers early, and prefer delegating to "
        "duplicating work."),
    "decisive": (
        "Bias to action: pick the best available option quickly, commit, "
        "and course-correct later rather than over-deliberating."),
    "analytical": (
        "Reason quantitatively: prefer measurements, counts, and concrete "
        "comparisons over qualitative impressions; show your working."),
}


def style_directive(style: Optional[str]) -> Optional[str]:
    if not style:
        return None
    return COGNITIVE_STYLES.get(style,
                                f"Adopt this cognitive style: {style}")


@dataclasses.dataclass(frozen=True)
class AgentFields:
    """The provided per-agent identity fields (reference's 9 agent fields,
    fields/schemas.ex). All optional; the composer skips empty ones."""
    role: Optional[str] = None
    cognitive_style: Optional[str] = None
    constraints: Optional[str] = None
    global_context: Optional[str] = None
    delegation_strategy: Optional[str] = None
    communication_style: Optional[str] = None
    risk_tolerance: Optional[str] = None
    planning_horizon: Optional[str] = None
    identity_notes: Optional[str] = None


def compose_field_prompt(fields: AgentFields,
                         accumulated_constraints: Sequence[str] = ()) -> Optional[str]:
    """Render the identity block of the system prompt (replaces the interim
    composer that lived in actions/executors.py). Accumulated ancestor
    constraints always render — a child cannot drop them."""
    parts: list[str] = []
    if fields.role:
        parts.append(f"Your role: {fields.role}")
    directive = style_directive(fields.cognitive_style)
    if directive:
        parts.append(directive)
    for label, value in (
        ("Delegation strategy", fields.delegation_strategy),
        ("Communication style", fields.communication_style),
        ("Risk tolerance", fields.risk_tolerance),
        ("Planning horizon", fields.planning_horizon),
    ):
        if value:
            parts.append(f"{label}: {value}")
    if fields.identity_notes:
        parts.append(fields.identity_notes)
    if fields.global_context:
        parts.append(f"Global context:\n{fields.global_context}")
    constraints = [c for c in accumulated_constraints if c]
    if fields.constraints:
        constraints.append(fields.constraints)
    if constraints:
        parts.append("Constraints you must respect (yours and every "
                     "ancestor's):\n"
                     + "\n".join(f"- {c}" for c in constraints))
    return "\n\n".join(parts) or None


def accumulate_constraints(parent_accumulated: Sequence[str],
                           parent_own: Optional[str]) -> tuple[str, ...]:
    """Constraints flow down the tree (reference ConstraintAccumulator):
    the child's accumulated set = parent's accumulated + parent's own."""
    out = list(parent_accumulated)
    if parent_own:
        out.append(parent_own)
    return tuple(out)


def child_fields_from_spawn(params: dict) -> AgentFields:
    """Spawn params → the child's provided fields (reference
    FieldTransformer: the spawn action's field params become the child's
    provided fields verbatim; transformation hooks apply on top)."""
    return AgentFields(
        role=params.get("role"),
        cognitive_style=params.get("cognitive_style"),
        constraints=params.get("constraints"),
        global_context=params.get("global_context"),
    )
