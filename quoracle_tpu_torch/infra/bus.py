"""In-process event bus + agent event broadcasts.

Replaces Phoenix.PubSub and the reference's PubSub.AgentEvents
(reference lib/quoracle/pubsub/agent_events.ex:9-29 — 13 broadcast functions
over topics ``agents:lifecycle``, ``agents:<id>:state|logs|metrics``,
``actions:all``, ``tasks:<id>:messages``; every function takes the pubsub
instance explicitly and ``safe_broadcast`` never raises into the caller).

Here the bus is a plain object handed to components at construction — one bus
per test gives the same isolation the reference gets from per-test PubSub
instances (reference test/support/pubsub_isolation.ex:44-50) without any
named processes.

The PyTorch port's copy of ``quoracle_tpu/infra/bus.py``. Its lock is the
port's ``infra/locks.named_lock("bus")`` (the port declares no lock
hierarchy). ``TorchBackend`` broadcasts ``TOPIC_SERVING`` from its serving
threads, so ``subscribe_queue`` keeps the JAX package's cross-thread push.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Optional

from quoracle_tpu_torch.infra.locks import named_lock

logger = logging.getLogger(__name__)

Handler = Callable[[str, dict], None]


@dataclasses.dataclass
class Subscription:
    topic: str
    handler: Handler
    _bus: "EventBus"

    def unsubscribe(self) -> None:
        self._bus.unsubscribe(self)


class EventBus:
    """Topic → handlers fan-out. Thread-safe; handlers run synchronously in
    the broadcasting thread/task. Async consumers subscribe a queue via
    :meth:`subscribe_queue` and drain it at their own pace."""

    def __init__(self) -> None:
        self._subs: dict[str, list[Subscription]] = {}
        self._lock = named_lock("bus")

    def subscribe(self, topic: str, handler: Handler) -> Subscription:
        """Subscribe to one topic, or to every broadcast with topic="*"
        (durable log writers and the dashboard tail the whole bus; the
        reference gets this from its per-topic PubSub.subscribe calls on
        known topic lists)."""
        sub = Subscription(topic, handler, self)
        with self._lock:
            self._subs.setdefault(topic, []).append(sub)
        return sub

    def subscribe_queue(self, topic: str,
                        queue: Optional[asyncio.Queue] = None) -> tuple[Subscription, asyncio.Queue]:
        """Must be called from a running event loop; broadcasts may come from
        any thread (e.g. an executor thread running backend.query), so the
        push is marshalled onto the subscribing loop with
        call_soon_threadsafe — a bare put_nowait from a foreign thread never
        wakes the loop's waiting getters."""
        q: asyncio.Queue = queue if queue is not None else asyncio.Queue()
        loop = asyncio.get_running_loop()

        def push(t: str, event: dict) -> None:
            try:
                loop.call_soon_threadsafe(q.put_nowait, (t, event))
            except RuntimeError:
                pass  # loop closed: subscriber is gone, drop the event

        return self.subscribe(topic, push), q

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            subs = self._subs.get(sub.topic, [])
            if sub in subs:
                subs.remove(sub)

    def broadcast(self, topic: str, event: dict) -> None:
        """Deliver to every subscriber of ``topic``. Handler exceptions are
        logged, never raised into the broadcaster — parity with the
        reference's safe_broadcast (agent_events.ex:21-29): a dying UI must
        not take an agent down with it."""
        with self._lock:
            subs = list(self._subs.get(topic, ()))
            if topic != "*":
                subs += self._subs.get("*", ())
        for sub in subs:
            try:
                sub.handler(topic, event)
            except Exception:
                logger.exception("event handler failed on topic %s", topic)


# ---------------------------------------------------------------------------
# Topics (reference pubsub/agent_events.ex:9-17)
# ---------------------------------------------------------------------------

TOPIC_LIFECYCLE = "agents:lifecycle"
TOPIC_ACTIONS = "actions:all"
# Serving telemetry (no reference analog — the reference never executes
# attention): per-query-round engine phase timings + radix prefix-cache
# hit/miss/evict counters (models/prefix_cache.py), broadcast by
# TPUBackend.attach_bus consumers and ring-buffered by EventHistory.
TOPIC_SERVING = "serving:metrics"
# Finished trace spans (infra/telemetry.py): the Runtime registers a
# tracer sink that re-broadcasts every finished span here; EventHistory
# ring-buffers them for /api/trace?task_id=… mount replay and the SSE
# tail streams them live.
TOPIC_TRACE = "trace:spans"
# Resource incidents: stall-watchdog trips and flight-recorder
# dumps (runtime.StallWatchdog) — ring-buffered by EventHistory (the
# /api/history "resources" key) and tailed live by the SSE stream, so an
# open dashboard sees the incident the moment the watchdog fires.
TOPIC_RESOURCES = "resources:events"
# Consensus quality: per-decide audit records and model-health
# drift alerts (consensus/quality.py) — the Runtime registers a QUALITY
# sink that re-broadcasts them here; EventHistory rings them (the
# /api/history "consensus" key + /api/consensus?task_id=…), the durable
# writer persists audit records to the consensus_audit table, and the
# SSE stream tails drift alerts live.
TOPIC_CONSENSUS = "consensus:audit"
# Disaggregated serving plane: cluster incidents — replica
# death, handoff rejects, all-replicas-shed at the router — broadcast by
# serving/cluster.py and ring-buffered by EventHistory (the /api/history
# "cluster" key); the SSE stream tails them live so an open dashboard
# sees a replica drop the moment the router marks it dead.
TOPIC_CLUSTER = "cluster:events"
# Cross-host cluster fabric: wire-layer incidents — a peer
# link going silent/dead at the front door, frame-level rejects, a
# degraded fleet prefix service — broadcast by serving/fabric/ and
# ring-buffered by EventHistory (the /api/history "fabric" key); the
# SSE stream tails them live so an open dashboard sees a partition the
# moment the transport gives up on it.
TOPIC_FABRIC = "fabric:events"
# Elastic fleet controller: policy-action and drain events —
# a replica scaled up/down, re-tiered, or drained with its sessions
# live-migrated — broadcast by serving/fleet.py and ring-buffered by
# EventHistory (the /api/history "fleet" key); the SSE stream tails
# them live so an open dashboard sees a scale event the moment the
# controller commits it.
TOPIC_FLEET = "fleet:events"
# Fleet simulator: end-of-replay summaries (events, ledger
# digest, outcome counts, tier census, virtual goodput) broadcast by
# sim/replay.py when a bus is attached — a boot-armed --sim-trace
# replay surfaces its result on the SSE stream and the EventHistory
# ring exactly like a chaos report, without polling GET /api/sim.
TOPIC_SIM = "sim:events"
# Serving flywheel: draft-promotion lifecycle events — a
# candidate promoted through the fleet's drain/hot-swap, a failed
# promotion restoring the incumbent, a live acceptance regression
# auto-rolling back — broadcast by training/promote.py when a bus is
# attached and ring-buffered by EventHistory (the /api/history "train"
# key); the SSE stream tails them live so an open dashboard sees a
# rollback the moment the guard trips.
TOPIC_TRAIN = "train:events"


def topic_agent_state(agent_id: str) -> str:
    return f"agents:{agent_id}:state"


def topic_agent_logs(agent_id: str) -> str:
    return f"agents:{agent_id}:logs"


def topic_agent_metrics(agent_id: str) -> str:
    return f"agents:{agent_id}:metrics"


def topic_task_messages(task_id: str) -> str:
    return f"tasks:{task_id}:messages"


class AgentEvents:
    """The 13 broadcast functions of the reference's PubSub.AgentEvents,
    as methods over an explicit bus. Events are plain dicts with an ``event``
    tag + timestamp so UI/history consumers can replay them uniformly."""

    def __init__(self, bus: EventBus, clock: Callable[[], float] = time.time):
        self.bus = bus
        self._clock = clock

    def _ev(self, name: str, **fields: Any) -> dict:
        return {"event": name, "ts": self._clock(), **fields}

    # -- lifecycle ---------------------------------------------------------
    def agent_spawned(self, agent_id: str, parent_id: Optional[str],
                      task_id: str, **extra: Any) -> None:
        self.bus.broadcast(TOPIC_LIFECYCLE, self._ev(
            "agent_spawned", agent_id=agent_id, parent_id=parent_id,
            task_id=task_id, **extra))

    def agent_terminated(self, agent_id: str, reason: str = "normal") -> None:
        self.bus.broadcast(TOPIC_LIFECYCLE, self._ev(
            "agent_terminated", agent_id=agent_id, reason=reason))

    def agent_dismissed(self, agent_id: str, by: Optional[str] = None) -> None:
        self.bus.broadcast(TOPIC_LIFECYCLE, self._ev(
            "agent_dismissed", agent_id=agent_id, by=by))

    def task_status_changed(self, task_id: str, status: str) -> None:
        self.bus.broadcast(TOPIC_LIFECYCLE, self._ev(
            "task_status_changed", task_id=task_id, status=status))

    # -- per-agent state/logs/metrics -------------------------------------
    def state_updated(self, agent_id: str, state_summary: dict) -> None:
        self.bus.broadcast(topic_agent_state(agent_id), self._ev(
            "state_updated", agent_id=agent_id, state=state_summary))

    def todo_updated(self, agent_id: str, todos: list) -> None:
        self.bus.broadcast(topic_agent_state(agent_id), self._ev(
            "todo_updated", agent_id=agent_id, todos=todos))

    def log(self, agent_id: str, level: str, message: str, **extra: Any) -> None:
        self.bus.broadcast(topic_agent_logs(agent_id), self._ev(
            "log", agent_id=agent_id, level=level, message=message, **extra))

    def decision_log(self, agent_id: str, decision: dict) -> None:
        self.bus.broadcast(topic_agent_logs(agent_id), self._ev(
            "decision", agent_id=agent_id, decision=decision))

    def raw_response_log(self, agent_id: str, model_spec: str, text: str) -> None:
        """Debug: raw LLM output per model (reference consensus.ex:102-110)."""
        self.bus.broadcast(topic_agent_logs(agent_id), self._ev(
            "raw_response", agent_id=agent_id, model=model_spec, text=text))

    def cost_recorded(self, agent_id: str, cost: dict) -> None:
        self.bus.broadcast(topic_agent_metrics(agent_id), self._ev(
            "cost_recorded", agent_id=agent_id, cost=cost))

    def budget_updated(self, agent_id: str, budget: dict) -> None:
        self.bus.broadcast(topic_agent_metrics(agent_id), self._ev(
            "budget_updated", agent_id=agent_id, budget=budget))

    # -- actions / messages ------------------------------------------------
    def action_started(self, agent_id: str, action_id: str, action: str,
                       params: dict) -> None:
        self.bus.broadcast(TOPIC_ACTIONS, self._ev(
            "action_started", agent_id=agent_id, action_id=action_id,
            action=action, params=params))

    def action_completed(self, agent_id: str, action_id: str, action: str,
                         status: str) -> None:
        self.bus.broadcast(TOPIC_ACTIONS, self._ev(
            "action_completed", agent_id=agent_id, action_id=action_id,
            action=action, status=status))

    def task_message(self, task_id: str, message: dict) -> None:
        self.bus.broadcast(topic_task_messages(task_id), self._ev(
            "task_message", task_id=task_id, message=message))
