"""Action executors: the behavior behind each action name.

Each executor is ``async def fn(core, router, params) -> dict``. The schema
layer (actions/schema.py) has already validated params by the time an
executor runs — consensus filters invalid proposals before they can win
(reference consensus.ex:269-293) — so executors only check *runtime*
conditions (child exists, budget available, path allowed…).

Coverage in this module (reference files in parens):
  wait (actions/wait.ex), send_message (send_message.ex), orient (orient.ex),
  todo (todo.ex), file_read / file_write (file_read.ex/file_write.ex),
  execute_shell smart mode (shell.ex:13,24-35,66-114), spawn_child
  (spawn.ex:7-20,109-161,184-227,412-433), dismiss_child (dismiss_child.ex),
  adjust_budget / record_cost (adjust_budget.ex/record_cost.ex),
  generate_secret / search_secrets (generate_secret.ex/search_secrets.ex),
  batch_sync / batch_async (batch_sync.ex/batch_async.ex).
The world-facing network actions (fetch_web, call_api, call_mcp,
answer_engine, generate_images) and the skills actions live in
actions/world.py / the skills subsystem and register themselves here.

The PyTorch port's copy of ``quoracle_tpu/actions/executors.py``, with
the seventeen executors registered here (the world actions register from
``actions/world.py``).
"""

from __future__ import annotations

import asyncio
import os
import time
import uuid
from decimal import Decimal
from typing import Any, Awaitable, Callable, Optional

import logging

from quoracle_tpu_torch.actions.schema import (
    batchable_async_actions, batchable_sync_actions,
)
from quoracle_tpu_torch.infra.budget import BudgetError

logger = logging.getLogger(__name__)

Executor = Callable[[Any, Any, dict], Awaitable[dict]]

EXECUTORS: dict[str, Executor] = {}


class ActionError(Exception):
    """Executor-level failure that becomes an error result (not a crash)."""


def register(name: str) -> Callable[[Executor], Executor]:
    def deco(fn: Executor) -> Executor:
        EXECUTORS[name] = fn
        return fn
    return deco


def get_executor(name: str) -> Executor:
    fn = EXECUTORS.get(name)
    if fn is None:
        raise ActionError(f"action {name!r} is not available in this runtime")
    return fn


# ---------------------------------------------------------------------------
# Introspection / local state
# ---------------------------------------------------------------------------

@register("wait")
async def wait_action(core, router, params: dict) -> dict:
    """The wait itself is enacted by the Core on the action result
    (reference consensus_handler.ex:264-292 wait-parameter semantics); the
    executor just acknowledges."""
    duration = params.get("duration")
    return {"status": "ok", "waiting": duration if duration else "indefinite",
            "reason": params.get("reason", "")}


@register("orient")
async def orient_action(core, router, params: dict) -> dict:
    """Structured self-reflection: the value is the params themselves landing
    in history (reference actions/orient.ex — 12 reflection fields)."""
    return {"status": "ok", "reflection": dict(params)}


@register("todo")
async def todo_action(core, router, params: dict) -> dict:
    """Replace the TODO list (reference actions/todo.ex — replacement, not
    merge) and broadcast to the UI."""
    items = params["items"]
    core.ctx.todos = list(items)
    core.deps.events.todo_updated(core.agent_id, core.ctx.todos)
    return {"status": "ok", "items": len(core.ctx.todos)}


# ---------------------------------------------------------------------------
# Messaging
# ---------------------------------------------------------------------------

@register("send_message")
async def send_message_action(core, router, params: dict) -> dict:
    """Direct agent messaging: parent / children / announcement / agent id
    (reference actions/send_message.ex; targets at schema.ex:13)."""
    registry = core.deps.registry
    target = params["target"]
    message = {
        "from": core.agent_id,
        "content": params["content"],
        "message_type": params.get("message_type", "info"),
        "ts": time.time(),
    }
    if target == "parent":
        regs = [registry.parent_of(core.agent_id)]
        if regs[0] is None:
            raise ActionError("agent has no parent")
    elif target == "children":
        regs = registry.children_of(core.agent_id)
    elif target == "announcement":
        regs = [r for r in registry.agents_for_task(core.config.task_id)
                if r.agent_id != core.agent_id]
    else:
        reg = registry.lookup(target)
        if reg is None:
            raise ActionError(f"unknown target agent {target!r}")
        regs = [reg]

    delivered = []
    for reg in regs:
        reg.core.post({"type": "agent_message", **message})
        delivered.append(reg.agent_id)
    core.deps.events.task_message(core.config.task_id, {
        **message, "targets": delivered})
    return {"status": "ok", "delivered_to": delivered}


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def _check_path(core, path: str, write: bool) -> str:
    """Grove confinement (reference groves/hard_rule_enforcer.ex file
    confinement + path_security.ex): resolve relative to working_dir, then
    check against the agent's node confinement."""
    p = os.path.abspath(os.path.join(core.config.working_dir, path))
    if core.grove is not None:
        err = core.grove.check_file_path(p, write=write,
                                         node=core.config.grove_node)
        if err:
            raise ActionError(err)
    return p


@register("file_read")
async def file_read_action(core, router, params: dict) -> dict:
    from quoracle_tpu_torch.actions.router import truncate_output
    path = _check_path(core, params["path"], write=False)
    offset = int(params.get("offset") or 0)
    limit = params.get("limit")
    try:
        with open(path, "r", errors="replace") as f:
            lines = f.readlines()
    except OSError as e:
        raise ActionError(f"file_read failed: {e}")
    selected = lines[offset: offset + int(limit) if limit else None]
    return {"status": "ok", "path": path,
            "content": truncate_output("".join(selected)),
            "total_lines": len(lines)}


@register("file_write")
async def file_write_action(core, router, params: dict) -> dict:
    path = _check_path(core, params["path"], write=True)
    content = params["content"]
    if core.grove is not None:
        err = core.grove.validate_file_schema(path, content)
        if err:
            raise ActionError(err)
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        mode = "a" if params.get("append") else "w"
        with open(path, mode) as f:
            f.write(content)
    except OSError as e:
        raise ActionError(f"file_write failed: {e}")
    return {"status": "ok", "path": path, "bytes": len(content.encode())}


# ---------------------------------------------------------------------------
# Shell (smart mode)
# ---------------------------------------------------------------------------

@register("execute_shell")
async def execute_shell_action(core, router, params: dict) -> dict:
    """Smart mode (reference actions/shell.ex:13,24-26): sync result if the
    command finishes within the threshold, otherwise async with a command_id
    the agent polls/terminates via check_id (XOR-validated against command).
    Output is pumped into the command's buffer from the moment of launch, so
    nothing emitted before the sync/async handoff is ever lost."""
    from quoracle_tpu_torch.actions.router import (
        ShellCommand, ShellOwner, pump_stream, truncate_output,
    )

    if params.get("check_id"):
        owner = core.shell_routers.get(params["check_id"])
        if owner is None:
            raise ActionError(
                f"no running command {params['check_id']!r} (already "
                f"completed, terminated, or never existed)")
        if params.get("terminate"):
            return await owner.terminate_command()
        return owner.poll_command()

    command = params["command"]
    working_dir = params.get("working_dir") or core.config.working_dir
    if core.grove is not None:
        node = core.config.grove_node
        err = (core.grove.check_shell_command(command, node)
               or core.grove.check_working_dir(working_dir, node))
        if err:
            raise ActionError(err)
    if not os.path.isdir(working_dir):
        raise ActionError(f"working_dir {working_dir!r} does not exist")

    try:
        # Own process group so terminate/timeout can kill the shell AND its
        # descendants (the sh here does not exec; a lone kill of the shell
        # would orphan the real command with the stdout pipe still open).
        proc = await asyncio.create_subprocess_shell(
            command, cwd=working_dir,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT,
            stdin=asyncio.subprocess.DEVNULL,
            start_new_session=True)
    except OSError as e:
        raise ActionError(f"failed to start command: {e}")

    from quoracle_tpu_torch.actions.router import (
        close_subprocess_transport, kill_process_group,
    )
    cmd = ShellCommand(command_id=f"cmd-{uuid.uuid4().hex[:10]}",
                       command=command, proc=proc,
                       started_at=time.monotonic())
    pump = asyncio.ensure_future(pump_stream(proc.stdout, cmd.output))

    threshold = core.deps.shell_sync_threshold_s
    timeout = params.get("timeout")

    def go_async() -> dict:
        ShellOwner(core, cmd, pump).adopt(float(timeout) if timeout else None)
        return {"status": "ok", "async": True, "command_id": cmd.command_id,
                "command_status": "running",
                "note": ("command still running; poll or terminate it with "
                         f"execute_shell check_id={cmd.command_id!r}")}

    try:
        # Poll returncode for the sync window instead of proc.wait():
        # asyncio's exit waiter is gated on pipe EOF, which a backgrounded
        # descendant can hold open long after the process itself exits.
        deadline = time.monotonic() + threshold
        while proc.returncode is None and time.monotonic() < deadline:
            await asyncio.sleep(min(0.005, threshold / 4))
        if proc.returncode is None:
            return go_async()
        try:
            # Process exited within the threshold; the pump ends at pipe
            # EOF — which a backgrounded descendant can hold open, in which
            # case the command is still producing output: treat as async.
            await asyncio.wait_for(asyncio.shield(pump), timeout=threshold)
        except asyncio.TimeoutError:
            return go_async()
    except asyncio.CancelledError:
        # Core teardown cancelled the router mid-launch — this process has
        # no ShellOwner yet, so reap it here or it leaks.
        pump.cancel()
        kill_process_group(proc)
        close_subprocess_transport(proc)
        raise
    cmd.status = "completed"
    cmd.exit_code = proc.returncode
    close_subprocess_transport(proc)
    return {"status": "ok", "sync": True, "exit_code": cmd.exit_code,
            "output": truncate_output(cmd.output_text())}


# ---------------------------------------------------------------------------
# Lifecycle: spawn / dismiss
# ---------------------------------------------------------------------------

SPAWN_MAX_RETRIES = 3        # reference spawn.ex:412-433
SPAWN_RETRY_DELAY_S = 0.2


SPAWN_FIELD_SUMMARIZE_TOKENS = 2000   # per-field threshold (reference
                                      # config_builder pre-summarization)


def _compose_initial_message(params: dict) -> str:
    return "\n\n".join(
        f"[{label}]\n{params[key]}" for label, key in (
            ("TASK", "task_description"),
            ("SUCCESS CRITERIA", "success_criteria"),
            ("IMMEDIATE CONTEXT", "immediate_context"),
            ("APPROACH GUIDANCE", "approach_guidance"),
        ))


async def _summarize_spawn_fields(core, params: dict) -> dict:
    """Pre-summarize OVERSIZED spawn fields through the configured
    summarization model before the child inherits them (reference
    spawn/config_builder.ex maybe_pre_summarize_entry + the
    summarization_model setting): a parent that pastes its whole
    conversation into immediate_context must not start the child at the
    edge of its window. Failures keep the original text — degraded, never
    blocking (the reference's fallback-artifact behavior)."""
    deps = core.deps
    model = None
    if deps.persistence is not None:
        model = deps.persistence.get_setting("summarization_model")
    model = model or core.config.model_pool[0]
    from quoracle_tpu_torch.models.runtime import QueryRequest
    out = dict(params)
    loop = asyncio.get_running_loop()

    async def summarize_one(key: str, text: str) -> None:
        try:
            # count INSIDE the guard: a misconfigured summarization_model
            # (unknown spec) must degrade, not kill the spawn task
            n = deps.token_manager.count(model, text)
            if n <= SPAWN_FIELD_SUMMARIZE_TOKENS:
                return
            # the summarizer's own window bounds one query: clamp the
            # input to its newest tail rather than sending an overflow
            # the degrade-guard would swallow (leaving the child with the
            # full oversized field — the outcome this function prevents)
            cap = max(1024, deps.backend.context_window(model) - 1200)
            while deps.token_manager.count(model, text) > cap \
                    and len(text) > 2000:
                text = "[earlier context truncated]\n" \
                    + text[-(len(text) * 2 // 3):]
            res = (await loop.run_in_executor(
                None, lambda: deps.backend.query([
                    QueryRequest(model, [
                        {"role": "system",
                         "content": "Condense the following context for a "
                                    "sub-agent. Keep every concrete fact, "
                                    "path, and constraint; drop "
                                    "narration."},
                        {"role": "user", "content": text}],
                        temperature=0.2, max_tokens=1024)])))[0]
            if res.ok and res.text.strip():
                out[key] = res.text.strip()
                if res.usage and res.usage.cost:
                    from quoracle_tpu_torch.infra.costs import CostEntry
                    deps.costs.record(CostEntry(
                        agent_id=core.agent_id,
                        task_id=core.config.task_id,
                        amount=Decimal(str(res.usage.cost)),
                        cost_type="model", model_spec=model,
                        input_tokens=res.usage.prompt_tokens,
                        output_tokens=res.usage.completion_tokens,
                        description=f"spawn field summarization: {key}"))
        except Exception:             # noqa: BLE001 — degrade, don't block
            logger.warning("spawn field summarization failed for %s",
                           key, exc_info=True)

    # concurrent: the spawn waits for the SLOWEST oversized field, not
    # the sum (the backend's batcher may even coalesce the queries)
    await asyncio.gather(*(
        summarize_one(key, out[key])
        for key in ("task_description", "success_criteria",
                    "immediate_context", "approach_guidance",
                    "global_context")
        if isinstance(out.get(key), str)))
    return out


@register("spawn_child")
async def spawn_child_action(core, router, params: dict) -> dict:
    """Async spawn (reference spawn.ex:7-20): child_id allocated and budget
    escrowed synchronously, the child itself starts in a background task, and
    the action returns immediately — success/failure arrives later as a
    child_spawned / spawn_failed message to the parent."""
    from quoracle_tpu_torch.agent.state import AgentConfig, new_agent_id

    deps, registry = core.deps, core.deps.registry
    if registry.dismissing(core.agent_id):
        raise ActionError("parent is being dismissed; refusing to spawn")

    child_id = new_agent_id()
    budget = params.get("budget")
    if budget is None and core.budget_limit is not None:
        # Reference spawn.ex:152-155: children of budgeted parents MUST get
        # an explicit allocation or the escrow books don't balance.
        raise ActionError("budget is required when the parent has a budget")
    allocated: Optional[Decimal] = None
    if budget is not None:
        try:
            allocated = Decimal(str(budget))
            deps.escrow.lock_for_child(core.agent_id, child_id, allocated)
        except (BudgetError, KeyError) as e:
            raise ActionError(f"budget escrow failed: {e}")

    profile = params.get("profile")
    # Topology auto-injection (reference TopologyResolver
    # apply_spawn_contract, spawn.ex:117): the grove edge this spawn follows
    # assigns the child's node, skills, and any contract overrides.
    from quoracle_tpu_torch.governance.fields import (
        accumulate_constraints, child_fields_from_spawn,
        compose_field_prompt,
    )
    resolved = None
    if core.grove is not None:
        from quoracle_tpu_torch.governance.grove import GroveError
        try:
            resolved = core.grove.resolve_spawn(core.config.grove_node,
                                                params)
        except GroveError as e:
            if allocated is not None:
                try:
                    deps.escrow.release_child(child_id)
                except (BudgetError, KeyError):
                    pass
            raise ActionError(str(e))
    child_node = resolved.node if resolved else None
    child_skills = tuple(params.get("skills") or ())
    extra_constraints: list[str] = []
    forbidden = set(core.config.forbidden_actions)
    governance_docs = core.config.governance_docs
    if resolved is not None:
        child_skills += tuple(s for s in resolved.skills
                              if s not in child_skills)
        profile = resolved.profile or profile
        if resolved.constraints:
            extra_constraints.append(resolved.constraints)
    if core.grove is not None:
        forbidden |= core.grove.blocked_actions(child_node)
        governance_docs = core.grove.governance_docs_for(child_node)

    # Constraint accumulation down the tree (reference
    # ConstraintAccumulator): child inherits every ancestor constraint.
    inherited = accumulate_constraints(core.config.accumulated_constraints,
                                       core.config.own_constraints)
    inherited += tuple(extra_constraints)

    def build_cfg(p: dict) -> AgentConfig:
        # built from the (possibly summarized) params so an oversized
        # global_context doesn't reach the child's system prompt verbatim
        fields = child_fields_from_spawn(p)
        return AgentConfig(
            agent_id=child_id,
            task_id=core.config.task_id,
            parent_id=core.agent_id,
            model_pool=(resolved.model_pool if resolved else None)
                        or list(core.config.model_pool),
            profile=profile,
            capability_groups=(resolved.capability_groups
                               if resolved is not None
                               and resolved.capability_groups is not None
                               else core.config.capability_groups),
            forbidden_actions=tuple(sorted(forbidden)),
            max_refinement_rounds=core.config.max_refinement_rounds,
            field_system_prompt=compose_field_prompt(fields, inherited),
            own_constraints=p.get("constraints"),
            accumulated_constraints=inherited,
            profile_names=core.config.profile_names,
            grove_path=core.config.grove_path,
            grove_node=child_node,
            governance_docs=governance_docs,
            active_skills=child_skills,
            budget_mode="allocated" if allocated is not None else "na",
            budget_limit=allocated,
            working_dir=core.config.working_dir,
            # QoS: tenant attribution flows down the tree; the child's
            # CLASS is derived from its depth at build time, not copied
            tenant=core.config.tenant,
        )

    def _release_escrow() -> None:
        if allocated is not None:
            try:
                deps.escrow.release_child(child_id)
            except (BudgetError, KeyError):
                pass

    async def do_spawn() -> None:
        last_err: Optional[Exception] = None
        try:
            # dismissing check FIRST: no paid summarization call for a
            # child that will never spawn (the spawn/dismiss race,
            # reference core.ex:213-220)
            if registry.dismissing(core.agent_id) \
                    or registry.lookup(core.agent_id) is None:
                last_err = RuntimeError("parent dismissed during spawn")
            else:
                try:
                    # oversized fields summarize INSIDE the background
                    # task — an LLM call must not delay the spawn
                    # action's immediate return
                    sum_params = await _summarize_spawn_fields(core,
                                                               params)
                except Exception:     # noqa: BLE001 — degrade, never block
                    logger.warning("spawn field summarization failed",
                                   exc_info=True)
                    sum_params = params
                cfg = build_cfg(sum_params)
                initial_message = _compose_initial_message(sum_params)
                for attempt in range(SPAWN_MAX_RETRIES):
                    # Re-check right before registering: terminate_tree
                    # may have flagged the parent while this task ran.
                    if registry.dismissing(core.agent_id) \
                            or registry.lookup(core.agent_id) is None:
                        last_err = RuntimeError(
                            "parent dismissed during spawn")
                        break
                    try:
                        child = await deps.supervisor.start_agent(cfg)
                        if registry.dismissing(core.agent_id) \
                                or registry.lookup(core.agent_id) is None:
                            # Parent was torn down after tree collection:
                            # this child escaped the BFS, so reap it here
                            # — the subtree must not grow during
                            # dismissal.
                            await deps.supervisor.terminate_tree(
                                child_id, by=core.agent_id,
                                reason="parent dismissed")
                            last_err = RuntimeError(
                                "parent dismissed during spawn")
                            break
                        # UI learns about the child before any blocking
                        # waits (reference spawn.ex:264-272).
                        child.post({"type": "user_message",
                                    "content": initial_message,
                                    "from": core.agent_id})
                        core.post({"type": "child_spawned",
                                   "child_id": child_id,
                                   "profile": profile})
                        return
                    except Exception as e:            # noqa: BLE001
                        last_err = e
                        await asyncio.sleep(
                            SPAWN_RETRY_DELAY_S * (attempt + 1))
        except asyncio.CancelledError:
            # core teardown cancels background tasks — the escrow must
            # not stay committed to a child that never spawned (the
            # summarization call widened this window to seconds)
            _release_escrow()
            raise
        _release_escrow()
        core.post({"type": "spawn_failed", "child_id": child_id,
                   "reason": f"{type(last_err).__name__}: {last_err}"})

    core.track_background(asyncio.ensure_future(do_spawn()))
    return {"status": "ok", "agent_id": child_id,
            "budget_allocated": str(allocated) if allocated is not None else None}


@register("dismiss_child")
async def dismiss_child_action(core, router, params: dict) -> dict:
    """Recursive subtree dismissal + budget absorption (reference
    dismiss_child.ex + TreeTerminator, agent AGENTS.md:168-175)."""
    child_id = params["child_id"]
    reg = core.deps.registry.lookup(child_id)
    if reg is None or reg.parent_id != core.agent_id:
        raise ActionError(f"{child_id!r} is not a live child of this agent")
    terminated = await core.deps.supervisor.terminate_tree(
        child_id, by=core.agent_id, reason=params.get("reason", "dismissed"))
    core.children = [c for c in core.children if c["agent_id"] != child_id]
    core.ctx.children = list(core.children)
    return {"status": "ok", "dismissed": child_id,
            "agents_terminated": terminated}


# ---------------------------------------------------------------------------
# Budget / costs
# ---------------------------------------------------------------------------

@register("adjust_budget")
async def adjust_budget_action(core, router, params: dict) -> dict:
    child_id = params["child_id"]
    if not any(c["agent_id"] == child_id for c in core.children):
        raise ActionError(f"{child_id!r} is not a child of this agent")
    try:
        state = core.deps.escrow.adjust_child(
            core.agent_id, child_id, Decimal(str(params["amount"])))
    except (BudgetError, KeyError) as e:
        raise ActionError(f"adjust_budget failed: {e}")
    core.deps.events.budget_updated(child_id, state.snapshot())
    return {"status": "ok", "child_id": child_id,
            "new_allocation": str(params["amount"])}


@register("record_cost")
async def record_cost_action(core, router, params: dict) -> dict:
    from quoracle_tpu_torch.infra.costs import CostEntry
    entry = core.deps.costs.record(CostEntry(
        agent_id=core.agent_id, task_id=core.config.task_id,
        amount=Decimal(str(params["amount"])), cost_type="manual",
        description=params["description"]))
    return {"status": "ok", "recorded": str(entry.amount)}


# ---------------------------------------------------------------------------
# Secrets
# ---------------------------------------------------------------------------

@register("generate_secret")
async def generate_secret_action(core, router, params: dict) -> dict:
    name = params["name"]
    store = core.deps.secrets
    if params.get("value"):
        store.put(name, params["value"], params.get("description", ""),
                  created_by=core.agent_id)
    else:
        store.generate(name, length=int(params.get("length") or 32),
                       charset=params.get("charset") or "alphanumeric",
                       description=params.get("description", ""),
                       created_by=core.agent_id)
    return {"status": "ok", "name": name,
            "usage": f"reference it as {{{{SECRET:{name}}}}} in action params"}


@register("search_secrets")
async def search_secrets_action(core, router, params: dict) -> dict:
    return {"status": "ok",
            "secrets": core.deps.secrets.search(params["query"])}


# ---------------------------------------------------------------------------
# Skills (reference actions/learn_skills.ex / create_skill.ex)
# ---------------------------------------------------------------------------

@register("learn_skills")
async def learn_skills_action(core, router, params: dict) -> dict:
    """Load skills into the active set; invalidates the cached system prompt
    so next cycle carries the skill content (reference core.ex:338-341)."""
    loader = core.skills_loader
    if loader is None:
        raise ActionError("no skills directory is configured")
    available = loader.all()
    missing = [s for s in params["skills"] if s not in available]
    if missing:
        raise ActionError(
            f"unknown skills: {', '.join(missing)}. Available: "
            f"{', '.join(sorted(available)) or '(none)'}")
    added = [s for s in params["skills"] if s not in core.active_skills]
    core.active_skills.extend(added)
    # Learned skills must survive pause/restore: mirror into the persisted
    # config (restore reads config.active_skills).
    core.config.active_skills = tuple(core.active_skills)
    if core.deps.persistence is not None:
        core.deps.persistence.persist_agent(core)
    core.invalidate_system_prompt()
    return {"status": "ok", "active_skills": list(core.active_skills),
            "added": added}


@register("create_skill")
async def create_skill_action(core, router, params: dict) -> dict:
    loader = core.skills_loader
    if loader is None:
        raise ActionError("no skills directory is configured")
    from quoracle_tpu_torch.governance.skills import SkillError
    try:
        skill = loader.create(params["name"], params["description"],
                              params["content"])
    except SkillError as e:
        raise ActionError(str(e))
    return {"status": "ok", "name": skill.name, "path": skill.path}


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------

async def _run_sub_action(core, router, sub: dict) -> dict:
    name = sub.get("action")
    try:
        fn = get_executor(name)
        result = await fn(core, router, sub.get("params", {}))
        if "status" not in result:
            result["status"] = "ok"
    except ActionError as e:
        result = {"status": "error", "error": str(e)}
    except Exception as e:                                 # noqa: BLE001
        result = {"status": "error", "error": f"{type(e).__name__}: {e}"}
    return {"action": name, **result}


@register("batch_sync")
async def batch_sync_action(core, router, params: dict) -> dict:
    """Sequential sub-actions; an error stops the remainder (the agent sees
    partial results and can re-plan). Batchable set per reference
    action_list.ex:33-47."""
    allowed = batchable_sync_actions()
    results = []
    for sub in params["actions"]:
        if sub.get("action") not in allowed:
            results.append({"action": sub.get("action"), "status": "error",
                            "error": "not batchable in batch_sync"})
            break
        result = await _run_sub_action(core, router, sub)
        results.append(result)
        if result["status"] != "ok":
            break
    status = "ok" if all(r["status"] == "ok" for r in results) else "partial"
    return {"status": status, "results": results}


@register("batch_async")
async def batch_async_action(core, router, params: dict) -> dict:
    """Concurrent sub-actions (reference batch_async.ex — excludes only
    wait/batch_*, action_list.ex:79)."""
    allowed = batchable_async_actions()
    subs = list(params["actions"])
    for sub in subs:
        if sub.get("action") not in allowed:
            raise ActionError(
                f"{sub.get('action')!r} is not batchable in batch_async")
    results = await asyncio.gather(
        *(_run_sub_action(core, router, sub) for sub in subs))
    status = "ok" if all(r["status"] == "ok" for r in results) else "partial"
    return {"status": status, "results": list(results)}
