"""Parameter validation against action schemas.

Parity with the reference's Validator (reference
lib/quoracle/actions/validator.ex:14-50): required params, types, enums, XOR
constraints, recursive batch sub-action validation, and the wait parameter.
Invalid responses are FILTERED before clustering (reference
agent/consensus.ex:269-293) — validation errors also feed per-model
correction feedback on retry.

The PyTorch port's own copy of
``quoracle_tpu/actions/validator.py``, line for line but for its
imports, so the parity tests can compare the two packages' outputs
field by field.
"""

from __future__ import annotations

from typing import Any, Optional

from quoracle_tpu_torch.actions.schema import (
    ACTIONS, ActionSchema, batchable_async_actions, batchable_sync_actions,
    get_schema,
)


class ValidationError(Exception):
    def __init__(self, errors: list[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


_TYPE_CHECKS = {
    "string": lambda v: isinstance(v, str),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "boolean": lambda v: isinstance(v, bool),
    "map": lambda v: isinstance(v, dict),
    "list": lambda v: isinstance(v, list),
}


def validate_params(action: str, params: dict,
                    allowed_actions: Optional[set[str]] = None,
                    profile_optional: bool = False) -> list[str]:
    """Returns a list of error strings; empty = valid.

    ``profile_optional`` relaxes spawn_child's required profile under grove
    topology auto-injection (reference validator.ex:14-50).
    """
    errors: list[str] = []
    if action not in ACTIONS:
        return [f"unknown action {action!r}"]
    if allowed_actions is not None and action not in allowed_actions:
        return [f"action {action!r} not permitted for this agent"]
    schema = ACTIONS[action]
    if not isinstance(params, dict):
        return [f"params must be an object, got {type(params).__name__}"]

    required = set(schema.required)
    if profile_optional and action == "spawn_child":
        required.discard("profile")
    for p in sorted(required):
        if params.get(p) is None:
            errors.append(f"missing required param {p!r}")

    for group in schema.xor_groups:
        present = [p for p in group if params.get(p) is not None]
        if len(present) != 1:
            errors.append(
                f"exactly one of {group} required, got {present or 'none'}")

    known = set(schema.params)
    for key, value in params.items():
        if key not in known:
            errors.append(f"unknown param {key!r} for action {action!r}")
            continue
        if value is None:
            continue
        expected = schema.types.get(key)
        if expected and not _TYPE_CHECKS[expected](value):
            errors.append(
                f"param {key!r} must be {expected}, got {type(value).__name__}")
            continue
        enum = schema.enums.get(key)
        if enum is not None and value not in enum:
            errors.append(f"param {key!r} must be one of {enum}, got {value!r}")

    if action in ("batch_sync", "batch_async"):
        errors.extend(_validate_batch(action, params, allowed_actions,
                                      profile_optional))
    return errors


def _validate_batch(action: str, params: dict,
                    allowed_actions: Optional[set[str]],
                    profile_optional: bool = False) -> list[str]:
    errors: list[str] = []
    subs = params.get("actions")
    if not isinstance(subs, list) or not subs:
        return ["batch requires a non-empty 'actions' list"]
    allowed_set = (batchable_sync_actions() if action == "batch_sync"
                   else batchable_async_actions())
    for i, sub in enumerate(subs):
        if not isinstance(sub, dict) or "action" not in sub:
            errors.append(f"batch item {i} must be an object with 'action'")
            continue
        sub_action = sub["action"]
        if sub_action not in allowed_set:
            errors.append(f"batch item {i}: {sub_action!r} not batchable in {action}")
            continue
        # profile_optional flows into sub-actions: a grove agent batching
        # spawn_childs gets the same topology profile injection a bare
        # spawn_child gets
        sub_errors = validate_params(sub_action, sub.get("params", {}),
                                     allowed_actions=allowed_actions,
                                     profile_optional=profile_optional)
        errors.extend(f"batch item {i}: {e}" for e in sub_errors)
    return errors


def validate_wait_param(action: str, wait: Any) -> Optional[str]:
    """The wait parameter accompanies every action except `wait` itself
    (reference schema.ex:100-102). Legal: bool, or non-negative int."""
    schema = get_schema(action)
    if not schema.wait_required:
        return None
    if wait is None:
        return "missing wait parameter"
    if isinstance(wait, bool):
        return None
    if isinstance(wait, int) and wait >= 0:
        return None
    return f"wait must be true/false or a non-negative integer, got {wait!r}"
