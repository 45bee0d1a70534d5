"""Action schemas: the single source of truth for the action vocabulary.

Parity with the reference's 22 actions
(reference lib/quoracle/actions/schema/action_list.ex:6-29) and their
per-param consensus rules / priorities
(reference lib/quoracle/actions/schema.ex:72-102, schema/agent_schemas.ex,
schema/api_schemas.ex). Expressed as one dataclass per action rather than
scattered function heads; everything downstream (validator, prompt builder,
aggregator fingerprints, result merging, capability gating) reads from here.

Consensus rules per param (reference actions/consensus_rules.ex:18-120):
  exact            — byte equality; differing values split clusters
  semantic(t)      — embedding cosine >= t treats values as equivalent
  mode             — most common value wins at merge
  union            — sorted union of list values
  structural       — deep-sorted structural merge for maps/lists
  percentile(p)    — numeric: p-th percentile of cluster values
  batch_sequence   — per-position merge of batch sub-actions
  wait             — wait-parameter voting (False/0 < int < True)

The PyTorch port's own copy of
``quoracle_tpu/actions/schema.py``, line for line but for its
imports, so the parity tests can compare the two packages' outputs
field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


# -- consensus rule descriptors ---------------------------------------------

def exact() -> tuple: return ("exact",)
def semantic(threshold: float = 0.85) -> tuple: return ("semantic", threshold)
def mode() -> tuple: return ("mode",)
def union() -> tuple: return ("union",)
def structural() -> tuple: return ("structural",)
def percentile(p: float = 50.0) -> tuple: return ("percentile", p)
def batch_sequence() -> tuple: return ("batch_sequence",)
def wait_rule() -> tuple: return ("wait",)


@dataclasses.dataclass(frozen=True)
class ActionSchema:
    name: str
    description: str
    required: tuple[str, ...] = ()
    optional: tuple[str, ...] = ()
    types: dict[str, str] = dataclasses.field(default_factory=dict)
    enums: dict[str, tuple] = dataclasses.field(default_factory=dict)
    descriptions: dict[str, str] = dataclasses.field(default_factory=dict)
    rules: dict[str, tuple] = dataclasses.field(default_factory=dict)
    # Exactly one of each group must be present (shell: command XOR check_id).
    xor_groups: tuple[tuple[str, ...], ...] = ()
    # Tiebreak priority: LOWER wins ties (reference schema.ex action priorities).
    priority: int = 50
    # All actions except `wait` itself require the model to supply a wait
    # parameter deciding whether to pause after execution
    # (reference schema.ex:100-102).
    wait_required: bool = True

    @property
    def params(self) -> tuple[str, ...]:
        return self.required + self.optional

    def rule_for(self, param: str) -> tuple:
        return self.rules.get(param, exact())


_A: dict[str, ActionSchema] = {}


def _register(schema: ActionSchema) -> ActionSchema:
    _A[schema.name] = schema
    return schema


# --- agent lifecycle --------------------------------------------------------

_register(ActionSchema(
    name="spawn_child",
    description="Spawn a child agent to work on a subtask.",
    required=("task_description", "success_criteria", "immediate_context",
              "approach_guidance", "profile"),
    optional=("budget", "skills", "cognitive_style", "constraints",
              "global_context", "role"),
    types={"task_description": "string", "success_criteria": "string",
           "immediate_context": "string", "approach_guidance": "string",
           "profile": "string", "budget": "number", "skills": "list",
           "cognitive_style": "string", "constraints": "string",
           "global_context": "string", "role": "string"},
    rules={"task_description": semantic(0.85), "success_criteria": semantic(0.85),
           "immediate_context": semantic(0.80), "approach_guidance": semantic(0.80),
           "profile": mode(), "budget": percentile(50), "skills": union(),
           "cognitive_style": mode(), "constraints": semantic(0.80),
           "global_context": semantic(0.80), "role": mode()},
    priority=20,
))

_register(ActionSchema(
    name="dismiss_child",
    description="Dismiss a child agent (recursively terminates its subtree).",
    required=("child_id",),
    optional=("reason",),
    types={"child_id": "string", "reason": "string"},
    rules={"child_id": exact(), "reason": semantic(0.7)},
    priority=25,
))

_register(ActionSchema(
    name="send_message",
    description="Send a message to parent, children, or a specific agent.",
    required=("target", "content"),
    optional=("message_type",),
    types={"target": "string", "content": "string", "message_type": "string"},
    enums={"message_type": ("info", "question", "result", "error", "announcement")},
    rules={"target": exact(), "content": semantic(0.80), "message_type": mode()},
    priority=10,
))

_register(ActionSchema(
    name="wait",
    description="Pause until new events arrive (or a timeout).",
    required=(),
    optional=("duration", "reason"),
    types={"duration": "integer", "reason": "string"},
    rules={"duration": percentile(50), "reason": semantic(0.7)},
    priority=90,
    wait_required=False,
))

_register(ActionSchema(
    name="orient",
    description="Structured self-reflection on progress and strategy.",
    required=("current_understanding", "progress_assessment"),
    optional=("obstacles", "next_steps", "confidence", "assumptions",
              "information_needed", "risks", "alternatives", "decision_rationale",
              "success_likelihood", "course_correction"),
    types={"current_understanding": "string", "progress_assessment": "string",
           "obstacles": "string", "next_steps": "string", "confidence": "number",
           "assumptions": "string", "information_needed": "string",
           "risks": "string", "alternatives": "string",
           "decision_rationale": "string", "success_likelihood": "number",
           "course_correction": "string"},
    rules={k: semantic(0.75) for k in
           ("current_understanding", "progress_assessment", "obstacles",
            "next_steps", "assumptions", "information_needed", "risks",
            "alternatives", "decision_rationale", "course_correction")}
          | {"confidence": percentile(50), "success_likelihood": percentile(50)},
    priority=80,
))

_register(ActionSchema(
    name="todo",
    description="Replace the agent's TODO list.",
    required=("items",),
    types={"items": "list"},
    rules={"items": structural()},
    priority=70,
))

# --- world-facing -----------------------------------------------------------

_register(ActionSchema(
    name="execute_shell",
    description="Run a shell command (sync if fast, async with command_id if slow); "
                "or poll/terminate a running command via check_id.",
    required=(),
    optional=("command", "working_dir", "timeout", "check_id", "terminate"),
    types={"command": "string", "working_dir": "string", "timeout": "integer",
           "check_id": "string", "terminate": "boolean"},
    rules={"command": exact(), "working_dir": exact(),
           "timeout": percentile(75), "check_id": exact(), "terminate": mode()},
    xor_groups=(("command", "check_id"),),
    priority=30,
))

_register(ActionSchema(
    name="fetch_web",
    description="Fetch a URL and convert to markdown.",
    required=("url",),
    optional=("timeout",),
    types={"url": "string", "timeout": "integer"},
    rules={"url": exact(), "timeout": percentile(75)},
    priority=35,
))

_register(ActionSchema(
    name="call_api",
    description="Call an external HTTP API (REST/JSON-RPC/GraphQL).",
    required=("url", "method"),
    optional=("headers", "body", "auth", "timeout", "protocol"),
    types={"url": "string", "method": "string", "headers": "map",
           "body": "map", "auth": "map", "timeout": "integer",
           "protocol": "string"},
    enums={"method": ("GET", "POST", "PUT", "PATCH", "DELETE"),
           "protocol": ("rest", "jsonrpc", "graphql")},
    rules={"url": exact(), "method": exact(), "headers": structural(),
           "body": structural(), "auth": structural(),
           "timeout": percentile(75), "protocol": mode()},
    priority=35,
))

_register(ActionSchema(
    name="call_mcp",
    description="Invoke a tool on a configured MCP server.",
    required=("server", "tool"),
    optional=("arguments", "timeout"),
    types={"server": "string", "tool": "string", "arguments": "map",
           "timeout": "integer"},
    rules={"server": exact(), "tool": exact(), "arguments": structural(),
           "timeout": percentile(75)},
    priority=35,
))

_register(ActionSchema(
    name="answer_engine",
    description="Ask a web-grounded answer engine.",
    required=("query",),
    optional=("focus",),
    types={"query": "string", "focus": "string"},
    rules={"query": semantic(0.85), "focus": mode()},
    priority=40,
))

_register(ActionSchema(
    name="file_read",
    description="Read a file from the workspace.",
    required=("path",),
    optional=("offset", "limit"),
    types={"path": "string", "offset": "integer", "limit": "integer"},
    rules={"path": exact(), "offset": percentile(50), "limit": percentile(50)},
    priority=30,
))

_register(ActionSchema(
    name="file_write",
    description="Write content to a file in the workspace.",
    required=("path", "content"),
    optional=("append",),
    types={"path": "string", "content": "string", "append": "boolean"},
    rules={"path": exact(), "content": semantic(0.90), "append": mode()},
    priority=30,
))

# --- knowledge / skills -----------------------------------------------------

_register(ActionSchema(
    name="learn_skills",
    description="Load skills into the agent's active skill set.",
    required=("skills",),
    types={"skills": "list"},
    rules={"skills": union()},
    priority=60,
))

_register(ActionSchema(
    name="create_skill",
    description="Author a new skill file.",
    required=("name", "description", "content"),
    types={"name": "string", "description": "string", "content": "string"},
    rules={"name": exact(), "description": semantic(0.8),
           "content": semantic(0.85)},
    priority=60,
))

# --- secrets / budget / costs ----------------------------------------------

_register(ActionSchema(
    name="generate_secret",
    description="Create and store an encrypted secret.",
    required=("name",),
    optional=("length", "charset", "value", "description"),
    types={"name": "string", "length": "integer", "charset": "string",
           "value": "string", "description": "string"},
    enums={"charset": ("alphanumeric", "hex", "base64", "ascii")},
    rules={"name": exact(), "length": percentile(50), "charset": mode(),
           "value": exact(), "description": semantic(0.7)},
    priority=55,
))

_register(ActionSchema(
    name="search_secrets",
    description="Search stored secrets by name/description.",
    required=("query",),
    types={"query": "string"},
    rules={"query": semantic(0.8)},
    priority=55,
))

_register(ActionSchema(
    name="record_cost",
    description="Record a manually-incurred cost against the budget.",
    required=("amount", "description"),
    types={"amount": "number", "description": "string"},
    rules={"amount": percentile(50), "description": semantic(0.7)},
    priority=65,
))

_register(ActionSchema(
    name="adjust_budget",
    description="Adjust a child agent's budget allocation.",
    required=("child_id", "amount"),
    types={"child_id": "string", "amount": "number"},
    rules={"child_id": exact(), "amount": percentile(50)},
    priority=45,
))

# --- media ------------------------------------------------------------------

_register(ActionSchema(
    name="generate_images",
    description="Generate images from a text prompt across configured image models.",
    required=("prompt",),
    optional=("count", "size"),
    types={"prompt": "string", "count": "integer", "size": "string"},
    rules={"prompt": semantic(0.85), "count": percentile(50), "size": mode()},
    priority=50,
))

# --- batching ---------------------------------------------------------------

_register(ActionSchema(
    name="batch_sync",
    description="Execute multiple actions sequentially in one consensus cycle.",
    required=("actions",),
    types={"actions": "list"},
    rules={"actions": batch_sequence()},
    priority=15,
))

_register(ActionSchema(
    name="batch_async",
    description="Execute multiple actions in parallel in one consensus cycle.",
    required=("actions",),
    types={"actions": "list"},
    rules={"actions": batch_sequence()},
    priority=15,
))


ACTIONS: dict[str, ActionSchema] = dict(_A)


def get_schema(name: str) -> ActionSchema:
    if name not in ACTIONS:
        raise KeyError(f"unknown action {name!r}")
    return ACTIONS[name]


def batchable_sync_actions() -> set[str]:
    """Actions allowed inside batch_sync (reference action_list.ex:33-47):
    no nested batches, no wait, no spawn/dismiss lifecycle races."""
    return set(ACTIONS) - {"batch_sync", "batch_async", "wait",
                           "spawn_child", "dismiss_child"}


def batchable_async_actions() -> set[str]:
    """batch_async excludes only wait and nested batches
    (reference action_list.ex:79)."""
    return set(ACTIONS) - {"batch_sync", "batch_async", "wait"}
