"""Capability groups: the single source of truth for action gating.

Parity with the reference's 5 selectable capability groups + 11 always-allowed
actions (reference lib/quoracle/profiles/capability_groups.ex:8-47) and
ActionGate filtering (reference lib/quoracle/profiles/action_gate.ex).

The PyTorch port's own copy of
``quoracle_tpu/governance/capabilities.py``, line for line but for its
imports, so the parity tests can compare the two packages' outputs
field by field.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

ALWAYS_ALLOWED: frozenset[str] = frozenset({
    "wait", "orient", "todo", "send_message", "fetch_web", "answer_engine",
    "generate_images", "learn_skills", "create_skill", "batch_sync",
    "batch_async",
})

GROUP_ACTIONS: dict[str, frozenset[str]] = {
    "hierarchy": frozenset({"spawn_child", "dismiss_child", "adjust_budget"}),
    "local_execution": frozenset({"execute_shell", "call_mcp", "record_cost",
                                  "search_secrets", "generate_secret"}),
    "file_read": frozenset({"file_read"}),
    "file_write": frozenset({"file_write", "search_secrets",
                             "generate_secret"}),
    "external_api": frozenset({"call_api", "record_cost", "search_secrets",
                               "generate_secret"}),
}

# Display order (reference capability_groups.ex:38).
VALID_GROUPS: tuple[str, ...] = ("file_read", "file_write", "external_api",
                                 "hierarchy", "local_execution")

GROUP_DESCRIPTIONS: dict[str, str] = {
    "file_read": "Read files from the filesystem",
    "file_write": "Write and edit files on the filesystem",
    "external_api": "Make HTTP requests to external APIs",
    "hierarchy": "Spawn and manage child agents",
    "local_execution": "Execute shell commands and MCP calls",
}


class InvalidGroupError(ValueError):
    pass


def validate_groups(groups: Iterable[str]) -> None:
    bad = [g for g in groups if g not in GROUP_ACTIONS]
    if bad:
        raise InvalidGroupError(f"invalid capability groups: {bad}")


def allowed_actions_for_groups(groups: Sequence[str]) -> set[str]:
    """Base (always-allowed) actions plus everything the groups enable."""
    validate_groups(groups)
    allowed = set(ALWAYS_ALLOWED)
    for g in groups:
        allowed |= GROUP_ACTIONS[g]
    return allowed


def blocked_actions_for_groups(groups: Sequence[str],
                               all_actions: Iterable[str]) -> list[str]:
    allowed = allowed_actions_for_groups(groups)
    return sorted(a for a in all_actions if a not in allowed)


def filter_actions(actions: Iterable[str], groups: Optional[Sequence[str]],
                   forbidden: Iterable[str] = ()) -> list[str]:
    """Gate an action list by capability groups, then drop forbidden actions
    (grove hard rules, reference consensus_handler.ex:294-313). ``groups`` of
    None means ungoverned (all actions); an empty list means base actions
    only — the reference makes the same distinction."""
    forbidden_set = set(forbidden)
    if groups is None:
        allowed = None
    else:
        allowed = allowed_actions_for_groups(groups)
    out = []
    for a in actions:
        if a in forbidden_set:
            continue
        if allowed is not None and a not in allowed:
            continue
        out.append(a)
    return out
