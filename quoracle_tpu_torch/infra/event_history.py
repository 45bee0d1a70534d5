"""Bounded per-agent event history for UI mount replay.

Parity with the reference's UI.EventHistory + RingBuffer
(reference lib/quoracle/ui/event_history.ex:17-20 — 100 logs / 50 messages
per agent, replayed when a dashboard view mounts mid-run). A plain object
subscribed to the bus; no GenServer needed.

The PyTorch port's copy of ``quoracle_tpu/infra/event_history.py``,
its lock a ``named_lock`` of the port's own ``infra/locks.py``.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.bus import (
    EventBus, Subscription, TOPIC_ACTIONS, TOPIC_CLUSTER, TOPIC_CONSENSUS,
    TOPIC_FABRIC, TOPIC_FLEET,
    TOPIC_LIFECYCLE, TOPIC_RESOURCES, TOPIC_SERVING, TOPIC_TRACE,
    TOPIC_TRAIN,
)

MAX_LOGS_PER_AGENT = 100      # reference ui/event_history.ex:17-20
MAX_MESSAGES_PER_AGENT = 50
# Trace-span ring: one consensus round emits ~10 spans (tick, decide,
# rounds, members, phases, action), so 512 covers dozens of recent rounds
# across tasks; /api/trace filters by trace_id. Configurable via
# QUORACLE_TRACE_RING (serving-plane spans share
# this ring with consensus traces, so fleets under heavy decode traffic
# size it up; overflow is COUNTED in quoracle_trace_dropped_total
# either way, never silent).
MAX_TRACE_SPANS = 512
# Consensus-audit ring: one record per decide (plus occasional
# drift alerts), so 256 covers hours of recent decisions across tasks;
# /api/consensus filters by task_id, deep history lives in the
# consensus_audit table.
MAX_CONSENSUS_RECORDS = 256


class EventHistory:
    """Ring buffers of recent events, keyed by agent. Subscribes to topic
    prefixes on an explicit bus; `replay()` returns snapshots for a newly
    mounted view."""

    def __init__(self, bus: EventBus,
                 max_logs: int = MAX_LOGS_PER_AGENT,
                 max_messages: int = MAX_MESSAGES_PER_AGENT,
                 max_trace_spans: Optional[int] = None):
        import os
        self.bus = bus
        self.max_logs = max_logs
        self.max_messages = max_messages
        if max_trace_spans is None:
            try:
                max_trace_spans = max(16, int(os.environ.get(
                    "QUORACLE_TRACE_RING", MAX_TRACE_SPANS)))
            except ValueError:
                max_trace_spans = MAX_TRACE_SPANS
        self.max_trace_spans = max_trace_spans
        self._logs: dict[str, deque] = {}
        self._messages: dict[str, deque] = {}
        self._lifecycle: deque = deque(maxlen=max_logs)
        self._actions: deque = deque(maxlen=max_logs)
        self._serving: deque = deque(maxlen=max_logs)
        self._traces: deque = deque(maxlen=max_trace_spans)
        self._resources: deque = deque(maxlen=max_logs)
        self._consensus: deque = deque(maxlen=MAX_CONSENSUS_RECORDS)
        self._cluster: deque = deque(maxlen=max_logs)
        self._fabric: deque = deque(maxlen=max_logs)
        self._fleet: deque = deque(maxlen=max_logs)
        self._train: deque = deque(maxlen=max_logs)
        self._tasks: set[str] = set()
        self._lock = named_lock("history")
        self._closed = False
        self._subs: list[Subscription] = [
            bus.subscribe(TOPIC_LIFECYCLE, self._on_lifecycle),
            bus.subscribe(TOPIC_ACTIONS, self._on_action),
            bus.subscribe(TOPIC_SERVING, self._on_serving),
            bus.subscribe(TOPIC_TRACE, self._on_trace),
            bus.subscribe(TOPIC_RESOURCES, self._on_resource),
            bus.subscribe(TOPIC_CONSENSUS, self._on_consensus),
            bus.subscribe(TOPIC_CLUSTER, self._on_cluster),
            bus.subscribe(TOPIC_FABRIC, self._on_fabric),
            bus.subscribe(TOPIC_FLEET, self._on_fleet),
            bus.subscribe(TOPIC_TRAIN, self._on_train),
        ]

    # Agent log/message topics are per-agent; the runtime calls track_agent
    # when an agent spawns so its topics are captured from the start.
    # Subscribe-and-append runs UNDER the lock: bus handlers
    # fire on arbitrary broadcasting threads, and a track racing close()
    # must neither mutate _subs mid-iteration nor leak a subscription past
    # the closed flag. (bus.subscribe takes only the bus's own lock, and
    # broadcast holds no lock while running handlers, so the ordering
    # self._lock -> bus._lock cannot invert.)
    def track_agent(self, agent_id: str) -> None:
        from quoracle_tpu_torch.infra.bus import topic_agent_logs, topic_agent_state
        with self._lock:
            if self._closed or agent_id in self._logs:
                return
            self._logs[agent_id] = deque(maxlen=self.max_logs)
            self._messages[agent_id] = deque(maxlen=self.max_messages)
            self._subs.append(self.bus.subscribe(
                topic_agent_logs(agent_id), self._on_agent_event))
            self._subs.append(self.bus.subscribe(
                topic_agent_state(agent_id), self._on_agent_event))

    def track_task(self, task_id: str) -> None:
        from quoracle_tpu_torch.infra.bus import topic_task_messages
        with self._lock:
            if self._closed or task_id in self._tasks:
                return
            self._tasks.add(task_id)
            self._subs.append(self.bus.subscribe(
                topic_task_messages(task_id), self._on_task_message))

    def _on_lifecycle(self, topic: str, event: dict) -> None:
        with self._lock:
            self._lifecycle.append(event)
        if event.get("event") == "agent_spawned":
            self.track_agent(event["agent_id"])
        elif (event.get("event") == "task_status_changed"
              and event.get("status") == "running"):
            # create_task and restore both announce "running" — the task's
            # mailbox ring starts capturing from the same broadcast the
            # dashboard learns the task exists from (no runtime call site
            # needed; mirrors agent auto-tracking above).
            self.track_task(event["task_id"])

    def _on_action(self, topic: str, event: dict) -> None:
        with self._lock:
            self._actions.append(event)

    def _on_agent_event(self, topic: str, event: dict) -> None:
        agent_id = event.get("agent_id")
        if agent_id is None:
            return
        with self._lock:
            buf = self._logs.setdefault(agent_id, deque(maxlen=self.max_logs))
            buf.append(event)

    def _on_serving(self, topic: str, event: dict) -> None:
        with self._lock:
            self._serving.append(event)

    def _on_trace(self, topic: str, event: dict) -> None:
        with self._lock:
            if len(self._traces) == self.max_trace_spans:
                # overflow is overwrite-oldest either way, but COUNTED:
                # a sustained drop rate means
                # serving spans are starving consensus traces
                from quoracle_tpu_torch.infra.telemetry import (
                    TRACE_DROPPED_TOTAL,
                )
                TRACE_DROPPED_TOTAL.inc(ring="history")
            self._traces.append(event)

    def _on_resource(self, topic: str, event: dict) -> None:
        with self._lock:
            self._resources.append(event)

    def _on_consensus(self, topic: str, event: dict) -> None:
        with self._lock:
            self._consensus.append(event)

    def _on_cluster(self, topic: str, event: dict) -> None:
        with self._lock:
            self._cluster.append(event)

    def _on_fabric(self, topic: str, event: dict) -> None:
        with self._lock:
            self._fabric.append(event)

    def _on_fleet(self, topic: str, event: dict) -> None:
        with self._lock:
            self._fleet.append(event)

    def _on_train(self, topic: str, event: dict) -> None:
        with self._lock:
            self._train.append(event)

    def _on_task_message(self, topic: str, event: dict) -> None:
        # topic is "tasks:<id>:messages". Ring under the TASK key always
        # (the mailbox replay), and ALSO under the SENDER when the message
        # names one — executors emit the sender as 'from' (keying
        # on 'agent_id' alone left the agent-keyed ring permanently empty).
        msg = event.get("message") or {}
        sender = msg.get("agent_id") or msg.get("from")
        task_id = event.get("task_id")
        with self._lock:
            keys = {k for k in (task_id, sender) if k}
            for key in keys:
                buf = self._messages.setdefault(
                    key, deque(maxlen=self.max_messages))
                buf.append(event)

    # -- replay ------------------------------------------------------------
    def replay_logs(self, agent_id: str) -> list[dict]:
        with self._lock:
            return list(self._logs.get(agent_id, ()))

    def replay_messages(self, key: str) -> list[dict]:
        with self._lock:
            return list(self._messages.get(key, ()))

    def replay_lifecycle(self) -> list[dict]:
        with self._lock:
            return list(self._lifecycle)

    def replay_actions(self) -> list[dict]:
        with self._lock:
            return list(self._actions)

    def replay_serving(self) -> list[dict]:
        """Recent serving rounds (phase timings + prefix-cache counters)."""
        with self._lock:
            return list(self._serving)

    def replay_resources(self) -> list[dict]:
        """Recent resource incidents (watchdog stalls, flight-recorder
        dumps — TOPIC_RESOURCES)."""
        with self._lock:
            return list(self._resources)

    def replay_consensus(self, task_id: Optional[str] = None) -> list[dict]:
        """Recent consensus-audit records + drift alerts (TOPIC_CONSENSUS,
        consensus/quality.py), optionally filtered to one task. Backs
        /api/consensus?task_id=… and the /api/history "consensus" key.
        Drift alerts carry no task_id, so a task filter returns audit
        records only."""
        with self._lock:
            records = list(self._consensus)
        if task_id is None:
            return records
        return [r for r in records if r.get("task_id") == task_id]

    def replay_cluster(self) -> list[dict]:
        """Recent cluster incidents (replica death, handoff rejects,
        router all-shed — TOPIC_CLUSTER, serving/cluster.py). Backs the
        /api/history "cluster" key."""
        with self._lock:
            return list(self._cluster)

    def replay_fabric(self) -> list[dict]:
        """Recent fabric incidents (peer death, frame rejects, prefixd
        degrades — TOPIC_FABRIC, serving/fabric/). Backs the
        /api/history "fabric" key."""
        with self._lock:
            return list(self._fabric)

    def replay_fleet(self) -> list[dict]:
        """Recent fleet-controller events (scale / re-tier / drain
        actions, per-drain migration totals — TOPIC_FLEET,
        serving/fleet.py). Backs the /api/history "fleet" key."""
        with self._lock:
            return list(self._fleet)

    def replay_train(self) -> list[dict]:
        """Recent serving-flywheel events (promotions, rollbacks —
        TOPIC_TRAIN, training/promote.py). Backs the /api/history
        "train" key."""
        with self._lock:
            return list(self._train)

    def replay_traces(self, trace_id: Optional[str] = None) -> list[dict]:
        """Recent finished spans (infra/telemetry.py), optionally filtered
        to one trace (= task). Backs /api/trace?task_id=…."""
        with self._lock:
            spans = list(self._traces)
        if trace_id is None:
            return spans
        return [s for s in spans if s.get("trace_id") == trace_id]

    def close(self) -> None:
        # swap the list out under the lock: a concurrent track_* sees
        # _closed and subscribes nothing, and nothing mutates the list we
        # iterate
        with self._lock:
            self._closed = True
            subs, self._subs = self._subs, []
        for sub in subs:
            sub.unsubscribe()
