"""Verbatim LLM prompt dumps for named scenarios — the prompt-debugging
tool + golden-prompt source of truth.

Parity with the reference's ``mix quoracle.show_llm_prompts``
(reference lib/mix/tasks/quoracle.show_llm_prompts.ex:10-25): every scenario
calls the REAL prompt-construction code (build_system_prompt,
build_messages_for_model, build_refinement_prompt, ConsensusEngine.decide),
never hand-written prompt text, so the dump shows exactly what a served
model would receive. The same 12 scenarios + ``all``.

Consensus scenarios run the full engine over a scripted MockBackend and dump
what each pool member saw in each round plus the outcome — the refinement
prompts in the dump are the engine's own.

Usage:
    python -m quoracle_tpu_torch.tools.show_prompts <scenario>|all
    python -m quoracle_tpu_torch.tools.show_prompts --write-golden tests/golden

tests/test_golden_prompts.py locks every scenario against checked-in golden
files; regenerate with --write-golden after INTENTIONAL prompt changes.

The PyTorch port's copy of ``quoracle_tpu/tools/show_prompts.py``: the
same scenarios over the port's prompt code and ``MockBackend``, which
tests/test_torch_cli.py holds byte for byte to the same golden files.
"""

from __future__ import annotations

import json
import sys
from typing import Callable

from quoracle_tpu_torch.consensus.aggregator import build_refinement_prompt, Cluster
from quoracle_tpu_torch.consensus.engine import ConsensusConfig, ConsensusEngine
from quoracle_tpu_torch.consensus.parser import ActionProposal
from quoracle_tpu_torch.consensus.prompt_builder import build_system_prompt
from quoracle_tpu_torch.context.history import (
    DECISION, RESULT, USER, AgentContext, HistoryEntry, Lesson,
)
from quoracle_tpu_torch.context.message_builder import build_messages_for_model
from quoracle_tpu_torch.context.token_manager import TokenManager
from quoracle_tpu_torch.governance.fields import AgentFields, compose_field_prompt
from quoracle_tpu_torch.models.runtime import MockBackend

POOL = MockBackend.DEFAULT_POOL
MODEL = POOL[0]

SCENARIOS: dict[str, Callable[[], str]] = {}


def scenario(fn: Callable[[], str]) -> Callable[[], str]:
    SCENARIOS[fn.__name__] = fn
    return fn


def _tm() -> TokenManager:
    """Deterministic char-based counter (goldens must not depend on a model
    tokenizer being present)."""
    return TokenManager(lambda spec, text: max(1, len(text) // 4),
                        context_limit_fn=lambda spec: 128_000)


def render_messages(messages: list[dict]) -> str:
    parts = []
    for m in messages:
        parts.append(f"---------- {m['role']} ----------")
        parts.append(m["content"] if isinstance(m["content"], str)
                     else json.dumps(m["content"], indent=1))
    return "\n".join(parts) + "\n"


def _action_json(action: str, params: dict, reasoning: str,
                 wait=False) -> str:
    return json.dumps({"action": action, "params": params,
                       "reasoning": reasoning, "wait": wait})


# ---------------------------------------------------------------------------
# Prompt-construction scenarios
# ---------------------------------------------------------------------------

@scenario
def generalist_initial() -> str:
    """Generalist agent's first interaction: full ungoverned system prompt."""
    ctx = AgentContext()
    ctx.append(MODEL, HistoryEntry(
        kind=USER, content="$INITIAL_TASK_DESCRIPTION"))
    msgs = build_messages_for_model(
        ctx, MODEL, system_prompt=build_system_prompt(),
        token_manager=_tm())
    return render_messages(msgs)


@scenario
def generalist_with_history() -> str:
    """Generalist after an orient → shell sequence (decision + result
    entries rendered through the real history serializer)."""
    ctx = AgentContext()
    ctx.append(MODEL, HistoryEntry(kind=USER, content="$INITIAL_TASK"))
    ctx.append(MODEL, HistoryEntry(kind=DECISION, content={
        "action": "orient",
        "params": {
            "current_situation": "Starting data-analysis request",
            "goal_clarity": "Analyze /path/to/data.csv structure",
            "available_resources": "Shell, file read, web fetch",
            "key_challenges": "Unknown data format and size",
        },
        "reasoning": "Understand the task before acting", "wait": False,
        "confidence": 1.0, "kind": "consensus", "rounds": 1}))
    ctx.append(MODEL, HistoryEntry(kind=RESULT, action_type="orient", content={
        "action": "orient",
        "result": {"status": "ok", "recorded": True}}))
    ctx.append(MODEL, HistoryEntry(kind=DECISION, content={
        "action": "execute_shell",
        "params": {"command": "head -20 /path/to/data.csv"},
        "reasoning": "Inspect the file before parsing", "wait": False,
        "confidence": 1.0, "kind": "consensus", "rounds": 1}))
    ctx.append(MODEL, HistoryEntry(kind=RESULT, action_type="execute_shell",
                                   content={
        "action": "execute_shell",
        "result": {"status": "ok", "exit_code": 0,
                   "stdout": "id,name,value\n1,a,10\n2,b,20\n"}}))
    ctx.todos = [{"task": "inspect csv", "done": True},
                 {"task": "summarize columns", "done": False}]
    msgs = build_messages_for_model(
        ctx, MODEL, system_prompt=build_system_prompt(),
        token_manager=_tm())
    return render_messages(msgs)


@scenario
def with_fields_full() -> str:
    """All hierarchical identity fields + two ancestor constraints."""
    fields = AgentFields(
        role="Research coordinator for the data-pipeline workstream",
        cognitive_style="systematic",
        constraints="Never modify files outside /workspace",
        global_context="The org is migrating analytics to the new warehouse",
        delegation_strategy="Delegate independent subtasks; keep synthesis",
        communication_style="Terse status updates, full detail on request",
        risk_tolerance="Low: prefer reversible actions",
        planning_horizon="Multi-day",
        identity_notes="You were spawned to coordinate, not to implement",
    )
    field_prompt = compose_field_prompt(
        fields, accumulated_constraints=(
            "Stay under the task budget",
            "Do not contact external services without approval"))
    msgs = [{"role": "system", "content": build_system_prompt(
        field_system_prompt=field_prompt,
        capability_groups=["hierarchy", "file_read"],
        profile_name="coordinator",
        profile_description="Coordinates child agents",
        profile_names=("generalist", "coordinator", "implementer"))},
        {"role": "user", "content": "$INITIAL_TASK"}]
    return render_messages(msgs)


@scenario
def with_cognitive_style() -> str:
    """Cognitive-style directive rendered into the identity block."""
    out = []
    for style in ("systematic", "skeptical", "decisive"):
        prompt = compose_field_prompt(AgentFields(
            role="Analyst", cognitive_style=style))
        out.append(f"==== cognitive_style: {style} ====\n{prompt}\n")
    return "\n".join(out)


@scenario
def refinement_round() -> str:
    """The engine's own refinement prompt for a 2-1 split."""
    a = ActionProposal(model_spec=POOL[0], action="execute_shell",
                       params={"command": "ls /workspace"},
                       reasoning="List files first")
    b = ActionProposal(model_spec=POOL[1], action="execute_shell",
                       params={"command": "ls /workspace"},
                       reasoning="Same: inspect layout")
    c = ActionProposal(model_spec=POOL[2], action="spawn_child",
                       params={"task_description": "Survey the workspace",
                               "success_criteria": "A file inventory",
                               "immediate_context": "Fresh task",
                               "approach_guidance": "Use shell listings",
                               "profile": "generalist"},
                       reasoning="Delegate the survey")
    prompt = build_refinement_prompt(
        [Cluster(proposals=[a, b]), Cluster(proposals=[c])], own=c,
        round_num=2, max_rounds=4)
    return prompt + "\n"


@scenario
def with_secrets() -> str:
    """Secrets usage docs appear when the secret actions are allowed."""
    msgs = [{"role": "system", "content": build_system_prompt(
        capability_groups=["external_api", "local_execution"])},
        {"role": "user", "content": "Call the payments API with our key."}]
    return render_messages(msgs)


@scenario
def with_ace_context() -> str:
    """ACE lessons + state summary injected into the first user message
    (the 8-step injection order's step 2)."""
    ctx = AgentContext()
    ctx.append(MODEL, HistoryEntry(kind=USER, content="$CONTINUING_TASK"))
    ctx.context_lessons[MODEL] = [
        Lesson(type="factual", content="The data lives in /data/warehouse",
               confidence=3),
        Lesson(type="behavioral",
               content="Child agents need explicit success criteria",
               confidence=2),
    ]
    ctx.model_states[MODEL] = [
        "Phase 1 (inventory) complete; phase 2 (summaries) in progress"]
    ctx.budget_snapshot = {"mode": "allocated", "limit": "10.00",
                           "spent": "4.50", "committed": "2.00"}
    msgs = build_messages_for_model(ctx, MODEL, token_manager=_tm())
    return render_messages(msgs)


# ---------------------------------------------------------------------------
# Full-engine consensus scenarios (scripted pool, real engine)
# ---------------------------------------------------------------------------

def _run_consensus(scripts: dict[str, list[str]],
                   max_refinement_rounds: int = 4) -> str:
    backend = MockBackend(scripts={m: list(v) for m, v in scripts.items()})
    engine = ConsensusEngine(backend, ConsensusConfig(
        model_pool=list(POOL),
        max_refinement_rounds=max_refinement_rounds))
    messages = {m: [{"role": "system", "content": "$SYSTEM_PROMPT"},
                    {"role": "user", "content": "$TASK"}] for m in POOL}
    outcome = engine.decide(messages)

    # group the captured requests into rounds (one request per member per
    # round, in pool order)
    rounds: list[list] = []
    for i, req in enumerate(backend.calls):
        if i % len(POOL) == 0:
            rounds.append([])
        rounds[-1].append(req)
    parts = []
    for rnum, reqs in enumerate(rounds, 1):
        parts.append(f"======== ROUND {rnum} ========")
        for req in reqs:
            parts.append(f"\n#### what {req.model_spec} saw "
                         f"(temperature {req.temperature:.2f}) ####")
            parts.append(render_messages(req.messages))
    d = outcome.decision
    parts.append("======== OUTCOME ========")
    parts.append(json.dumps({
        "status": outcome.status,
        "kind": d.kind if d else None,
        "action": d.action if d else None,
        "params": d.params if d else None,
        "confidence": round(d.confidence, 3) if d else None,
        "rounds_used": outcome.rounds_used,
    }, indent=1, sort_keys=True))
    return "\n".join(parts) + "\n"


@scenario
def consensus_immediate() -> str:
    """3 models agree on round 1 (unanimity rule)."""
    shell = _action_json("execute_shell", {"command": "ls /workspace"},
                         "inspect")
    return _run_consensus({m: [shell] for m in POOL})


@scenario
def consensus_exact_match_params() -> str:
    """execute_shell commands must match exactly — differing commands split
    the clusters and refinement converges them."""
    ls_a = _action_json("execute_shell", {"command": "ls /workspace"},
                        "list files")
    ls_b = _action_json("execute_shell", {"command": "ls -la /workspace"},
                        "list with details")
    return _run_consensus({
        POOL[0]: [ls_a, ls_a],
        POOL[1]: [ls_a, ls_a],
        POOL[2]: [ls_b, ls_a],
    })


@scenario
def consensus_semantic_params() -> str:
    """spawn_child task descriptions merge by semantic similarity."""
    sa = _action_json("spawn_child", {
        "task_description": "Survey the repository files and sizes",
        "success_criteria": "Inventory produced",
        "immediate_context": "Fresh task", "approach_guidance": "Use shell",
        "profile": "generalist"}, "delegate")
    sb = _action_json("spawn_child", {
        "task_description": "Survey the repository files and their sizes",
        "success_criteria": "Inventory produced",
        "immediate_context": "Fresh task", "approach_guidance": "Use shell",
        "profile": "generalist"}, "delegate it")
    return _run_consensus({POOL[0]: [sa], POOL[1]: [sa], POOL[2]: [sb]})


@scenario
def consensus_different_actions() -> str:
    """Models disagree on the action type; refinement sways the minority."""
    shell = _action_json("execute_shell", {"command": "cat README.md"},
                         "read the readme")
    msg = _action_json("send_message", {"target": "parent",
                                        "content": "starting"},
                       "tell the parent")
    return _run_consensus({
        POOL[0]: [shell, shell],
        POOL[1]: [shell, shell],
        POOL[2]: [msg, shell],
    })


@scenario
def consensus_max_rounds() -> str:
    """No convergence: forced decision (plurality + tiebreak) after max
    refinement rounds."""
    shell = _action_json("execute_shell", {"command": "pwd"}, "locate")
    msg = _action_json("send_message", {"target": "parent",
                                        "content": "hello"}, "greet")
    wait = _action_json("wait", {}, "hold", wait=True)
    return _run_consensus({
        POOL[0]: [shell] * 3,
        POOL[1]: [msg] * 3,
        POOL[2]: [wait] * 3,
    }, max_refinement_rounds=2)


@scenario
def consensus_cluster_merge() -> str:
    """2-1 split where the minority joins the majority cluster in round 2;
    params merge within the winning cluster."""
    todo_a = _action_json("todo", {"items": [
        {"task": "read config", "done": False}]}, "plan")
    todo_b = _action_json("todo", {"items": [
        {"task": "scan sources", "done": False}]}, "plan differently")
    return _run_consensus({
        POOL[0]: [todo_a, todo_a],
        POOL[1]: [todo_a, todo_a],
        POOL[2]: [todo_b, todo_a],
    })


# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--write-golden":
        import os
        out_dir = argv[1]
        os.makedirs(out_dir, exist_ok=True)
        for name, fn in SCENARIOS.items():
            with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
                f.write(fn())
        print(f"wrote {len(SCENARIOS)} goldens to {out_dir}")
        return 0
    if not argv or argv[0] not in set(SCENARIOS) | {"all"}:
        names = "\n  ".join(sorted(SCENARIOS) + ["all"])
        print(f"usage: python -m quoracle_tpu_torch.tools.show_prompts "
              f"<scenario>\n\nscenarios:\n  {names}")
        return 1 if not argv else 2
    targets = sorted(SCENARIOS) if argv[0] == "all" else [argv[0]]
    for name in targets:
        print("=" * 100)
        print(f"SCENARIO: {name}")
        print("=" * 100)
        print(SCENARIOS[name]())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
