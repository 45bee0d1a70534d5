"""AgentCore: the event-driven actor at the center of the framework.

Parity with the reference's Agent.Core + MessageHandler +
ActionResultHandler + ConsensusHandler (reference
lib/quoracle/agent/core.ex:2-5 "zero hardcoded decision logic",
message_handler.ex:62-80 message queueing, action_result_handler.ex,
consensus_handler.ex:64,126-152,264-292) rebuilt as an asyncio actor:

* one mailbox (asyncio.Queue) processed strictly one message at a time —
  the GenServer serialization guarantee that makes the reference's state
  handling race-free comes for free from awaiting each handler;
* external messages queue while dispatched actions are un-acked and flush
  into ONE batched history entry at the next consensus cycle (reference
  message_handler.ex:62-80 + MessageBatcher);
* consensus triggering is deferred and batched via a ``consensus_scheduled``
  flag + a trigger message (reference core.ex:421-422, agent
  AGENTS.md:195-200 — staleness-checked so double triggers collapse);
* the wait parameter of a decision is enacted on the action result:
  False/0 → continue now, True → wait for events, int → timed wait
  (reference consensus_handler.ex:264-292);
* consensus failures retry ≤ max_consensus_retries with per-model
  correction feedback, then notify the parent of the stall (reference
  agent AGENTS.md:204-214);
* the heavy pipeline (condensation + the consensus rounds, i.e. every
  ModelBackend call) runs in a worker thread via run_in_executor — on the
  TPU backend that thread drives batched generate steps while the actor
  stays responsive is NOT needed; the actor deliberately blocks (GenServer
  semantics): other agents run their own actors concurrently, and their
  rounds batch into the same engine.

The PyTorch port's copy of ``quoracle_tpu/agent/core.py``. Left for a
later slice (ROADMAP Queue 1 item 9, second bullet): groves (an
``AgentConfig.grove_path`` raises ``NotImplementedError``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from decimal import Decimal
from typing import Any, Optional

from quoracle_tpu_torch.actions.router import ActionRouter
from quoracle_tpu_torch.actions.schema import ACTIONS
from quoracle_tpu_torch.agent.state import AgentConfig, AgentDeps, new_action_id
from quoracle_tpu_torch.consensus.engine import (
    ConsensusConfig, ConsensusEngine, ConsensusOutcome,
)
from quoracle_tpu_torch.consensus.prompt_builder import build_system_prompt
from quoracle_tpu_torch.context.condensation import (
    condense_for_tokens, ensure_fits, inline_condense, make_reflect_fn,
)
from quoracle_tpu_torch.context.history import (
    ASSISTANT, DECISION, RESULT, USER, AgentContext, HistoryEntry,
)
from quoracle_tpu_torch.context.message_builder import build_messages_for_model
from quoracle_tpu_torch.governance.capabilities import filter_actions
from quoracle_tpu_torch.infra.costs import CostEntry
from quoracle_tpu_torch.infra import treeobs
from quoracle_tpu_torch.infra.injection import UNTRUSTED_ACTIONS, wrap_untrusted
from quoracle_tpu_torch.infra.telemetry import TRACER
from quoracle_tpu_torch.utils.normalize import to_json

logger = logging.getLogger(__name__)


def format_message_batch(messages: list[dict]) -> str:
    """XML batch of queued inbound messages → one history entry (reference
    agent/message_formatter.ex XML format + message_batcher.ex FIFO drain)."""
    parts = ["<messages>"]
    for m in messages:
        src = m.get("from") or "system"
        mtype = m.get("message_type", "info")
        parts.append(f'<message from="{src}" type="{mtype}">')
        content = m.get("content", "")
        parts.append(content if isinstance(content, str) else to_json(content))
        parts.append("</message>")
    parts.append("</messages>")
    return "\n".join(parts)


class AgentCore:
    """One agent. Construct, then the supervisor runs :meth:`run` as a task.
    Interact only via :meth:`post` — never call into a core from another
    core's handlers (the reference's deadlock rule, agent AGENTS.md:237-247).
    """

    def __init__(self, config: AgentConfig, deps: AgentDeps):
        self.config = config
        self.deps = deps
        self.agent_id = config.agent_id
        self.ctx: AgentContext = config.restored_context or AgentContext()

        self.mailbox: asyncio.Queue = asyncio.Queue()
        self.pending_actions: dict[str, dict] = {}
        self.queued_messages: list[dict] = []
        self.consensus_scheduled = False
        # Restore path: the persisted context carries the children tracker
        self.children: list[dict] = list(self.ctx.children)
        # command_id → ShellOwner (actions/router.py), registered on the
        # async-mode handoff and serving later check_id decisions
        self.shell_routers: dict[str, Any] = {}
        self.stopping = False
        self.stop_reason = "normal"
        self.stopped = asyncio.Event()
        self.consensus_failures = 0
        self._overflow_models: set[str] = set()
        self._background: set[asyncio.Task] = set()
        self._wait_timer: Optional[asyncio.TimerHandle] = None
        self._wait_token = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._system_prompt: Optional[str] = None
        def _reflection_cost(model_spec, usage):
            # budgeted agents must see reflection + pre-summarization
            # spend (the reference routes condensation costs through the
            # same recorder as consensus queries)
            if not usage.cost:
                return
            deps.costs.record(CostEntry(
                agent_id=self.agent_id, task_id=config.task_id,
                amount=Decimal(str(usage.cost)), cost_type="model",
                model_spec=model_spec,
                input_tokens=usage.prompt_tokens,
                output_tokens=usage.completion_tokens,
                description="condensation reflection"))

        self._reflect_fn = make_reflect_fn(
            deps.backend,
            summarization_model_fn=(
                (lambda: deps.persistence.get_setting("summarization_model"))
                if deps.persistence is not None else None),
            cost_fn=_reflection_cost)

        # Groves (governance/grove.py) are not ported yet (Queue 1 item 9,
        # second bullet). The JAX package fails CLOSED when a grove cannot
        # load (the exception propagates to the spawner), so an agent
        # configured with one stops here the same way.
        if config.grove_path:
            raise NotImplementedError(
                f"groves are not ported yet (grove_path="
                f"{config.grove_path!r})")
        self.skills_loader = deps.skills
        self.active_skills: list[str] = list(config.active_skills)

        # Session-graph lineage: stamp this agent into the
        # tree registry BEFORE the engine builds so priority_for_depth
        # can read depth O(1).  register_spawn is idempotent — the
        # supervisor may have pre-registered us at start_agent.
        self._tree_ctx = treeobs.register_spawn(
            self.agent_id, config.parent_id, tree_id=config.task_id,
            deadline_ms=config.deadline_ms,
            token_budget=config.token_budget)

        self.engine = self._build_engine()

    def _tree_depth(self) -> int:
        """Distance from the task root.  Fast path: the
        treeobs TreeRegistry already holds our depth O(1) — parents
        register before spawning children, so our record derived its
        depth from the parent's at spawn.  Fallback (treeobs disabled
        or record evicted): walk the live agent registry parent chain
        (a cycle guard covers restore oddities)."""
        d = treeobs.depth_of(self.agent_id)
        if d is not None:
            return int(d)
        depth, cur, seen = 0, self.config.parent_id, set()
        while cur is not None and cur not in seen:
            seen.add(cur)
            depth += 1
            reg = self.deps.registry.lookup(cur)
            cur = reg.parent_id if reg is not None else None
        return depth

    def _build_engine(self) -> ConsensusEngine:
        """Consensus engine for the CURRENT model pool — rebuilt on
        switch_model_pool (reference core.ex:115-127)."""
        from quoracle_tpu_torch.serving.qos import priority_for_depth
        config, deps = self.config, self.deps
        allowed = filter_actions(list(ACTIONS), config.capability_groups,
                                 config.forbidden_actions)
        # QoS class from tree position: root agents serve the
        # user directly and outrank grandchildren's fan-out work; an
        # explicit qos_priority on the config wins over the derivation.
        priority = (config.qos_priority
                    if config.qos_priority is not None
                    else int(priority_for_depth(self._tree_depth())))
        return ConsensusEngine(
            deps.backend,
            ConsensusConfig(
                model_pool=list(config.model_pool),
                max_refinement_rounds=config.max_refinement_rounds,
                force_reflection=config.force_reflection,
                allowed_actions=set(allowed),
                profile_optional_spawn=False,   # no grove (see above)
                session_key=self.agent_id,   # KV residency per agent×model
                priority=priority,
                tenant=config.tenant,
                # consensus-quality audit attribution: every
                # decide's audit record lands under this task at
                # /api/consensus?task_id=… (consensus/quality.py)
                task_id=config.task_id,
                # session-graph lineage: every decide this
                # engine issues books chip/tokens/waits to our tree node
                tree=(self._tree_ctx.to_dict()
                      if self._tree_ctx is not None else None),
            ),
            log=lambda event, data: deps.events.log(
                self.agent_id, "debug", event, **data))

    # -- public surface ----------------------------------------------------

    @property
    def budget_limit(self) -> Optional[Decimal]:
        return self.config.budget_limit

    def post(self, msg: dict) -> None:
        """Thread-safe mailbox send (cast)."""
        loop = self._loop
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if loop is not None and running is not loop and loop.is_running():
            loop.call_soon_threadsafe(self.mailbox.put_nowait, msg)
        else:
            self.mailbox.put_nowait(msg)

    def track_background(self, task: asyncio.Task) -> None:
        """Register a background task (spawns) for teardown ownership."""
        self._background.add(task)
        task.add_done_callback(self._background.discard)

    def invalidate_system_prompt(self) -> None:
        """Skill/profile changes rebuild the cached prompt next cycle
        (reference core.ex:338-341)."""
        self._system_prompt = None

    # -- main loop ---------------------------------------------------------

    async def run(self) -> None:
        deps = self.deps
        self._loop = asyncio.get_running_loop()
        try:
            deps.escrow.get(self.agent_id)   # spawn path: lock_for_child
        except KeyError:                     # already registered the child
            deps.escrow.register(self.agent_id, mode=self.config.budget_mode,
                                 limit=self.config.budget_limit)
        deps.events.agent_spawned(self.agent_id, self.config.parent_id,
                                  self.config.task_id,
                                  profile=self.config.profile)
        if deps.persistence is not None:
            deps.persistence.persist_agent(self)
        try:
            while True:
                msg = await self.mailbox.get()
                if msg["type"] == "stop":
                    break
                try:
                    await self._dispatch(msg)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # A handler crash must not kill the agent (the reference
                    # Core traps exits); the error lands in the logs topic.
                    logger.exception("agent %s handler failed on %s",
                                     self.agent_id, msg.get("type"))
                    deps.events.log(self.agent_id, "error",
                                    f"handler crash on {msg.get('type')}")
        except asyncio.CancelledError:
            self.stop_reason = "killed"
            raise
        finally:
            await self._terminate()

    async def _dispatch(self, msg: dict) -> None:
        t = msg["type"]
        if t in ("user_message", "agent_message"):
            self._cancel_wait_timer()
            self.queued_messages.append(msg)
            self._maybe_schedule_consensus()
        elif t == "trigger_consensus":
            self.consensus_scheduled = False
            if self.stopping or self.pending_actions:
                # Stale trigger: results re-schedule when they land
                # (reference agent AGENTS.md:200 staleness check).
                return
            await self._run_consensus_cycle()
        elif t == "action_result":
            await self._handle_action_result(msg)
        elif t == "child_spawned":
            # Idempotent tracking (reference ChildrenTracker, core.ex:320-330).
            if not any(c["agent_id"] == msg["child_id"] for c in self.children):
                self.children.append({"agent_id": msg["child_id"],
                                      "spawned_at": time.time(),
                                      "profile": msg.get("profile")})
            self.ctx.children = list(self.children)
        elif t == "spawn_failed":
            self._cancel_wait_timer()   # a wake event outranks a timed wait
            self.children = [c for c in self.children
                             if c["agent_id"] != msg["child_id"]]
            self.ctx.children = list(self.children)
            self.queued_messages.append({
                "from": "system",
                "content": (f"Spawning child {msg['child_id']} FAILED: "
                            f"{msg.get('reason')}. You may retry or re-plan."),
            })
            self._maybe_schedule_consensus()
        elif t == "shell_completed":
            self._cancel_wait_timer()   # a wake event outranks a timed wait
            self.queued_messages.append({
                "from": "system",
                "content": (
                    f"Background command {msg['command_id']} "
                    f"({msg.get('command', '')!r}) finished with status "
                    f"{msg['status']}, exit code {msg['exit_code']}.\n"
                    + wrap_untrusted(msg.get("output", ""))),
            })
            self._maybe_schedule_consensus()
        elif t == "wait_timeout":
            if msg["token"] != self._wait_token:
                return  # cancelled timer that already fired
            self._wait_timer = None
            self.queued_messages.append({
                "from": "system",
                "content": "Your wait period elapsed with no new events.",
            })
            self._maybe_schedule_consensus()
        elif t == "switch_model_pool":
            await self._switch_model_pool(list(msg["model_pool"]))
        elif t == "stop_requested":
            # Graceful: finish the mailbox up to here, skip new consensus
            # (reference core.ex:425-429 drains triggers and stops normally).
            self.stopping = True
            self.stop_reason = msg.get("reason", "stop_requested")
            self.post({"type": "stop"})
        else:
            logger.warning("agent %s: unknown message type %r",
                           self.agent_id, t)

    # -- scheduling --------------------------------------------------------

    def _maybe_schedule_consensus(self) -> None:
        if self.stopping or self.pending_actions or self.consensus_scheduled:
            return
        self.consensus_scheduled = True
        self.post({"type": "trigger_consensus"})

    def _cancel_wait_timer(self) -> None:
        self._wait_token += 1
        if self._wait_timer is not None:
            self._wait_timer.cancel()
            self._wait_timer = None

    def _start_wait_timer(self, seconds: float) -> None:
        self._cancel_wait_timer()
        token = self._wait_token
        assert self._loop is not None
        self._wait_timer = self._loop.call_later(
            seconds, lambda: self.post({"type": "wait_timeout",
                                        "token": token}))

    # -- consensus cycle ---------------------------------------------------

    async def _run_consensus_cycle(self) -> None:
        deps = self.deps
        batch = self.queued_messages
        self.queued_messages = []
        if batch:
            self.ctx.append_all(
                HistoryEntry(kind=USER, content=format_message_batch(batch)),
                self.config.model_pool)
        self.ctx.budget_snapshot = deps.escrow.get(self.agent_id).snapshot()

        loop = asyncio.get_running_loop()
        # The whole model-touching pipeline runs off-loop; the actor blocks
        # (GenServer semantics) but the event loop keeps every OTHER agent
        # and router running.
        outcome = await loop.run_in_executor(None, self._consensus_blocking)
        self._process_outcome(outcome)

    def _consensus_blocking(self) -> ConsensusOutcome:
        """Worker-thread half of the cycle: condense → build → decide →
        inline-condense. Exclusive ctx access holds because the actor loop is
        suspended awaiting this function.

        Trace root for the whole tick: trace_id is the TASK, so every
        child span down the serving path (decide → rounds → member
        generate phases) lands in /api/trace?task_id=…. Binding the
        current span thread-locally is safe here — this runs on an
        executor thread, one tick at a time per agent."""
        with TRACER.span("agent.decide_tick", trace_id=self.config.task_id,
                         parent=None, agent_id=self.agent_id), \
                treeobs.bind(self._tree_ctx):
            # Tiered-KV prefetch: this agent is about to run a
            # consensus round keyed by its own id — warm any hibernated
            # session now so the page-in overlaps prompt building and
            # condensation instead of serializing before prefill.
            # Best-effort: backends without tiering no-op, busy engines
            # skip, and the generate path restores synchronously anyway.
            try:
                self.deps.backend.prefetch_sessions(self.agent_id)
            except Exception:             # noqa: BLE001 — warm-up only
                pass
            return self._consensus_blocking_impl()

    def _consensus_blocking_impl(self) -> ConsensusOutcome:
        deps, cfg = self.deps, self.config
        if self._system_prompt is None:
            available, active = [], []
            if self.skills_loader is not None:
                loaded = self.skills_loader.all()
                active = [loaded[n].as_dict() for n in self.active_skills
                          if n in loaded]
                available = [
                    {"name": s.name, "description": s.description}
                    for s in loaded.values()
                    if s.name not in self.active_skills]
            self._system_prompt = build_system_prompt(
                field_system_prompt=cfg.field_system_prompt,
                capability_groups=cfg.capability_groups,
                forbidden_actions=cfg.forbidden_actions,
                profile_name=cfg.profile,
                profile_description=cfg.profile_description,
                profile_names=cfg.profile_names,
                available_skills=available,
                active_skills=active,
                grove_path=cfg.grove_path,
                governance_docs=cfg.governance_docs,
            )
        tm = deps.token_manager
        overflowed, self._overflow_models = self._overflow_models, set()
        for m in overflowed:
            # Reactive: this model overflowed its window last round
            # (reference per_model_query.ex:93-120 condense-and-retry).
            condense_for_tokens(self.ctx, m, tm, self._reflect_fn,
                                embedder=deps.backend)
        for m in cfg.model_pool:
            # Proactive condensation until the output budget clears the
            # floor (reference per_model_query.ex:149-196).
            ensure_fits(self.ctx, m, tm, self._reflect_fn,
                        deps.backend.output_limit(m), embedder=deps.backend)

        messages_per_model = {
            m: build_messages_for_model(self.ctx, m,
                                        system_prompt=self._system_prompt,
                                        token_manager=tm)
            for m in cfg.model_pool
        }
        if deps.consensus_fn is not None:
            outcome = deps.consensus_fn(messages_per_model)
        else:
            outcome = self.engine.decide(messages_per_model)

        # Model-requested inline condensation (reference condensation.ex:38-48).
        for m, n in outcome.condense_requests.items():
            inline_condense(self.ctx, m, n, self._reflect_fn,
                            embedder=deps.backend)
        return outcome

    # -- model-pool switching ----------------------------------------------

    async def _switch_model_pool(self, new_pool: list[str]) -> None:
        """HistoryTransfer (reference core.ex:115-127, history_transfer.ex):
        re-key histories + ACE onto the new pool, drop the old pool's KV
        sessions, rebuild the consensus engine. Condensation may reflect via
        the backend, so the transfer runs off-loop like consensus does."""
        deps = self.deps
        old_pool = list(self.config.model_pool)
        if set(new_pool) == set(old_pool):
            # Same membership (possibly reordered): nothing to transfer and
            # every resident KV prefix stays valid — but order is
            # semantically meaningful (pool[0] is the default answer model),
            # so the reorder still logs and persists.
            self.config.model_pool = list(new_pool)
            self.engine = self._build_engine()
            deps.events.log(self.agent_id, "info",
                            f"model pool reordered {old_pool} -> {new_pool}")
            if deps.persistence is not None:
                deps.persistence.persist_agent(self)
            return
        loop = asyncio.get_running_loop()
        report = await loop.run_in_executor(
            None, self._switch_blocking, old_pool, new_pool)
        deps.events.log(
            self.agent_id, "info",
            f"model pool switched {old_pool} -> {new_pool}",
            sources=report.source_for, condensed=sorted(report.condensed),
            dropped=report.dropped_models)
        if deps.persistence is not None:
            # persist_agent rewrites the serialized config, so the NEW pool
            # is what a restore rebuilds with.
            deps.persistence.persist_agent(self)

    def _switch_blocking(self, old_pool: list[str], new_pool: list[str]):
        from quoracle_tpu_torch.context.history_transfer import transfer_histories
        deps = self.deps
        report = transfer_histories(
            self.ctx, old_pool, new_pool, deps.token_manager,
            self._reflect_fn, deps.backend.output_limit,
            embedder=deps.backend)
        # Drop KV sessions whose histories changed: removed members and
        # members that just inherited a transferred history. Unchanged
        # members keep their still-valid resident prefixes.
        stale = set(report.dropped_models) | set(report.source_for)
        if stale:
            deps.backend.drop_session(self.agent_id, model_specs=sorted(stale))
        # A pending reactive-condensation flag for a dropped model would
        # re-create its history key via ctx.history() next cycle.
        self._overflow_models &= set(new_pool)
        self.config.model_pool = list(new_pool)
        self.engine = self._build_engine()
        return report

    def _process_outcome(self, outcome: ConsensusOutcome) -> None:
        deps, cfg = self.deps, self.config
        if outcome.cost or outcome.prompt_tokens:
            deps.costs.record(CostEntry(
                agent_id=self.agent_id, task_id=cfg.task_id,
                amount=Decimal(str(outcome.cost)), cost_type="model",
                input_tokens=outcome.prompt_tokens,
                output_tokens=outcome.completion_tokens,
                measured_chip_ms=round(
                    getattr(outcome, "chip_ms", 0.0), 3),
                description=f"consensus x{outcome.rounds_used} rounds"))
        for p in outcome.proposals:
            deps.events.raw_response_log(self.agent_id, p.model_spec,
                                         p.raw_text)
        for model_spec, report in outcome.bug_reports:
            deps.events.log(self.agent_id, "warning",
                            f"bug report from {model_spec}: {report}")

        if outcome.status != "ok":
            self._handle_consensus_failure(outcome)
            return
        self.consensus_failures = 0
        self.ctx.correction_feedback.clear()

        # Refinement reasoning trace (sliding window already applied by the
        # engine) joins each model's own history before the decision entry —
        # the reference's per-model state-slice merge (per_model_query
        # StateMerge).
        for m, pairs in outcome.refinement_history.items():
            h = self.ctx.history(m)
            for prompt, response in pairs:
                h.append(HistoryEntry(kind=ASSISTANT, content=response))
                h.append(HistoryEntry(kind=USER, content=prompt))

        decision = outcome.decision
        assert decision is not None
        record = {
            "action": decision.action, "params": decision.params,
            "reasoning": decision.reasoning, "wait": decision.wait,
            "confidence": decision.confidence, "kind": decision.kind,
            "rounds": outcome.rounds_used,
        }
        self.ctx.append_all(HistoryEntry(kind=DECISION, content=record),
                            cfg.model_pool)
        deps.events.decision_log(self.agent_id, record)
        if deps.persistence is not None:
            deps.persistence.persist_conversation(self)
        self._execute_decision(decision.action, decision.params, decision.wait)

    def _handle_consensus_failure(self, outcome: ConsensusOutcome) -> None:
        deps = self.deps
        self.consensus_failures += 1
        detail = "; ".join(f"{f.model_spec}: {f.error}"
                           for f in outcome.failures) or outcome.status
        deps.events.log(self.agent_id, "error",
                        f"consensus failed ({outcome.status}): {detail}")
        if self.consensus_failures >= self.config.max_consensus_retries:
            # Stall: tell the parent and go idle; the next inbound message
            # re-triggers (reference agent AGENTS.md:204-214).
            self.consensus_failures = 0
            parent = deps.registry.parent_of(self.agent_id)
            if parent is not None:
                parent.core.post({
                    "type": "agent_message", "from": self.agent_id,
                    "message_type": "error",
                    "content": (f"Agent {self.agent_id} consensus stalled "
                                f"after repeated failures: {detail}"),
                })
            return
        for f in outcome.failures:
            if f.correction:
                self.ctx.correction_feedback[f.model_spec] = f.correction
            if "context_overflow" in f.error:
                # Reactive condensation then retry (reference
                # per_model_query.ex:93-120 — condense once, re-query).
                # Deferred to the next cycle's worker thread: condensation
                # reflects via the backend, which must never run on the
                # event loop.
                self._overflow_models.add(f.model_spec)
        self._maybe_schedule_consensus()

    # -- action execution --------------------------------------------------

    def _execute_decision(self, action: str, params: dict, wait: Any) -> None:
        """Non-blocking dispatch (reference action_executor.ex:99-181):
        pending registered BEFORE dispatch so a synchronously-failing router
        still finds its entry when the result posts back."""
        action_id = new_action_id()
        router = ActionRouter(self, action_id, action, params)
        self.pending_actions[action_id] = {
            "action": action, "params": params, "wait": wait,
            "router": router,
        }
        router.dispatch()

    @staticmethod
    def _result_history_content(action: str, result: dict) -> Any:
        """NO_EXECUTE-fence untrusted output before it enters model history
        (reference ActionResultHandler wraps by action_type). Batch results
        are wrapped per sub-action — a shell sub-result inside batch_async
        gets the same fence it would get standalone."""
        if action in UNTRUSTED_ACTIONS:
            return wrap_untrusted(to_json({"action": action, "result": result}))
        if action in ("batch_sync", "batch_async") \
                and isinstance(result.get("results"), list):
            subs = [wrap_untrusted(to_json(sub))
                    if sub.get("action") in UNTRUSTED_ACTIONS else sub
                    for sub in result["results"]]
            return {"action": action, "result": {**result, "results": subs}}
        return {"action": action, "result": result}

    async def _handle_action_result(self, msg: dict) -> None:
        pending = self.pending_actions.pop(msg["action_id"], None)
        if pending is None:
            return  # stale result from a router outliving a restore
        action, result = msg["action"], msg["result"]
        content = self._result_history_content(action, result)
        self.ctx.append_all(
            HistoryEntry(kind=RESULT, content=content, action_type=action),
            self.config.model_pool)
        if self.deps.persistence is not None:
            self.deps.persistence.persist_conversation(self)

        wait = pending["wait"]
        if action == "wait" and result.get("status") == "ok":
            duration = pending["params"].get("duration")
            # absent → indefinite; 0 → continue now (duration=0 must not
            # collapse into the indefinite case)
            wait = True if duration is None else duration
        if self.queued_messages:
            # Events arrived while the action ran: they outrank the wait
            # directive (reference ActionResultHandler flushes queued
            # messages before honoring wait).
            self._maybe_schedule_consensus()
        elif wait is True:
            pass  # indefinite: next inbound message wakes the agent
        elif isinstance(wait, (int, float)) and wait > 0:
            self._start_wait_timer(float(wait))
        else:
            self._maybe_schedule_consensus()

    # -- teardown ----------------------------------------------------------

    async def _terminate(self) -> None:
        deps = self.deps
        self._cancel_wait_timer()
        for task in list(self._background):
            task.cancel()
        for pending in list(self.pending_actions.values()):
            await pending["router"].shutdown()
        self.pending_actions.clear()
        for router in list(self.shell_routers.values()):
            await router.shutdown()
        self.shell_routers.clear()
        if deps.persistence is not None:
            try:
                deps.persistence.persist_ace_state(self)
            except Exception:
                logger.exception("agent %s: ACE persist on terminate failed",
                                 self.agent_id)
        deps.events.agent_terminated(self.agent_id, self.stop_reason)
        # session-graph lineage: the node's measurements stay
        # queryable until its whole tree completes and ages off the LRU
        treeobs.complete_node(self.agent_id)
        self.stopped.set()
