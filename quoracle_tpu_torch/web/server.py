"""Dashboard HTTP server: JSON API + SSE event stream + the SPA page.

Endpoints (reference routes at lib/quoracle_web/router.ex:22-32):
  GET  /                    dashboard page (3-panel parity)
  GET  /logs                standalone cross-task log view (LogViewLive)
  GET  /mailbox             standalone cross-task mailbox + agent panel
                            (MailboxLive)
  GET  /telemetry           dev telemetry page (LiveDashboard equivalent,
                            router.ex:42-50)
  GET  /settings            read-only settings audit view
                            (SecretManagementLive; mutations via the API)
  GET  /healthz             health check (reference HealthController)
  GET  /events              SSE: every bus broadcast as one JSON event
  GET  /metrics             Prometheus text exposition (infra/telemetry.py
                            registry; bearer-token gated like the API)
  GET  /api/status          runtime summary
  GET  /api/metrics         telemetry snapshot (VM, rows, serving phases,
                            histogram quantiles)
  GET  /api/resources       live resource accounting: device
                            memory + per-engine HBM attribution, compile
                            registry, scheduler health, watchdog + flight
                            recorder status (infra/resources.py)
  GET  /api/qos             serving-QoS panel: admission
                            controller signals/thresholds, per-member
                            weighted-fair queues, SLO tails, shed counters
  GET  /api/kv              tiered-KV panel: per-member tier
                            occupancy (HBM/host/disk), demote/restore/
                            spill counters, restore-latency quantiles
                            (serving/kvtier.py)
  GET  /api/fabric          cross-host fabric panel: peer
                            topology, wire request/retry/frame-reject
                            counters, prefixd client stats
  GET  /api/cluster         disaggregated serving plane:
                            replica topology + roles + liveness, router
                            placement/affinity/shed state with the
                            per-replica admission signals, KV-handoff
                            counters (serving/cluster.py)
  GET  /api/fleet           elastic fleet controller: policy
                            config, tick/cooldown state, the action
                            ledger, drain/migration counters
                            (serving/fleet.py)
  GET  /api/chaos           chaos plane: armed plan, injection-point
                            catalog, recent fired faults, the last
                            scenario's invariant verdicts, the fault and
                            invariant counters (chaos/faults.py)
  GET  /api/sim, /api/train
                            501 in the port: the fleet simulator and the
                            training capture store are not ported (the
                            body names the ROADMAP item)
  GET  /api/costs           chip-economics panel: nominal
                            Decimal billing rows beside the measured
                            chip-second ledgers (per-stage/tenant/class
                            splits, padding overhead; infra/costobs.py)
  GET  /api/budget          per-tenant-class SLO error budgets:
                            1h/6h burn rates, remaining-budget ratios,
                            deterministic trip ids (observed-only)
  GET  /api/models          consensus-quality scorecards: rolling
                            per-member agreement/dissent/failure-by-kind/
                            recovery rates, proposal latency, drift state
                            (consensus/quality.py)
  GET  /api/consensus?task_id  per-decide audit records for one task
                            (member→cluster map, winner, entropy, margin,
                            failures by kind) — in-memory ring merged with
                            the durable consensus_audit table
  POST /api/flightrec/dump  dump the flight-recorder ring to a JSON file
  GET  /api/trace?task_id   finished trace spans for one task (TOPIC_TRACE
                            ring in infra/event_history.py)
  GET  /api/timeline?session_id  one session's cross-process lifecycle:
                            spans pulled from every fabric
                            peer, ordered, with per-stage TTFT
                            attribution (infra/fleetobs.py)
  GET  /api/incidents       correlated incident bundles:
                            deterministic-id directories of every
                            reachable peer's flight-ring dump
  GET  /api/profile         liveness & hotspot plane:
                            collapsed-stack wall-clock profile windows,
                            heartbeats, stall status, wait-state totals
                            (fleet-federated on a front door)
  GET  /api/tree?tree_id    one agent tree's session graph:
                            per-node + subtree chip-ns/token/wait
                            rollups (conservation exact), critical
                            path, orphan flags — assembled across
                            every fabric peer on a front door
  GET  /api/tasks           tasks + live agent counts
  GET  /api/agents?task_id  agent tree with budget/cost/todo state
  GET  /api/logs?agent_id   durable logs (newest last)
  GET  /api/history?agent_id  ring-buffer mount replay (EventHistory)
  GET  /api/messages?task_id  task mailbox
  POST /api/tasks           {description?, model_pool?, profile?, budget?, grove?}
  POST /api/tasks/<id>/pause | /resume
  POST /api/messages        {agent_id, content} → user message to an agent

The server runs in its own thread (stdlib ThreadingHTTPServer); mutating
calls bridge into the runtime's asyncio loop with run_coroutine_threadsafe —
the dashboard never touches agent state off-loop.

The PyTorch port's copy of ``quoracle_tpu/web/server.py``, over the
port's ``Runtime`` and planes. Routes whose planes the port has not got
answer 501 with a JSON body naming the ROADMAP item that ports them
(``NOT_PORTED``), never an empty payload that looks real; the same
planes are listed as not ported on the /telemetry page.
"""

from __future__ import annotations

import asyncio
import json
import logging
import queue
import sys
import threading
import urllib.parse
from decimal import Decimal
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from quoracle_tpu_torch.web.page import DASHBOARD_HTML

logger = logging.getLogger(__name__)

API_CALL_TIMEOUT_S = 60.0

# The API routes whose modules the port has not got, with the ROADMAP
# Queue 1 item that ports each.
NOT_PORTED = {
    "/api/sim": "ROADMAP Queue 1 item 14 (sim/)",
    "/api/train": "ROADMAP Queue 1 item 11 (training capture)",
}


class DashboardServer:
    """``auth_token`` (default: env QUORACLE_DASHBOARD_TOKEN) gates the
    mutating endpoints — POST /api/tasks spawns agents that can run shell
    commands, so binding a non-loopback host without a token is refused
    outright rather than exposing unauthenticated RCE."""

    def __init__(self, runtime: Any, host: str = "127.0.0.1",
                 port: int = 8400, auth_token: Optional[str] = None):
        import os
        self.runtime = runtime
        self.host = host
        self.port = port
        self.auth_token = auth_token or os.environ.get(
            "QUORACLE_DASHBOARD_TOKEN") or None
        # NB: "" is NOT loopback — ThreadingHTTPServer binds INADDR_ANY for it.
        if self.auth_token is None and host not in (
                "127.0.0.1", "localhost", "::1"):
            raise ValueError(
                f"refusing to bind dashboard to non-loopback host {host!r} "
                "without an auth token (pass auth_token= or set "
                "QUORACLE_DASHBOARD_TOKEN)")
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        import time as _time
        self._t0 = _time.monotonic()

    # ------------------------------------------------------------------

    async def start(self) -> "DashboardServer":
        self._loop = asyncio.get_running_loop()
        server = self

        class Handler(_Handler):
            dashboard = server

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]   # resolve port 0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dashboard-http", daemon=True)
        self._thread.start()
        return self

    async def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- bridged runtime calls (run on the asyncio loop) ----------------

    def call_async(self, coro) -> Any:
        assert self._loop is not None
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout=API_CALL_TIMEOUT_S)

    def post_to_agent(self, agent_id: str, msg: dict) -> bool:
        reg = self.runtime.registry.lookup(agent_id)
        if reg is None:
            return False
        reg.core.post(msg)
        return True

    # -- read-model builders (thread-safe reads) ------------------------

    def tasks_payload(self) -> list[dict]:
        out = []
        for t in self.runtime.store.list_tasks():
            live = self.runtime.registry.agents_for_task(t["id"])
            out.append({**t, "live_agents": len(live),
                        "cost": str(self.runtime.store.costs_for_task(t["id"]))})
        return out

    def agents_payload(self, task_id: Optional[str]) -> list[dict]:
        regs = (self.runtime.registry.agents_for_task(task_id)
                if task_id else self.runtime.registry.all())
        out = []
        for reg in regs:
            core = reg.core
            try:
                budget = self.runtime.escrow.get(reg.agent_id).snapshot()
            except KeyError:
                budget = None
            out.append({
                "agent_id": reg.agent_id,
                "parent_id": reg.parent_id,
                "task_id": reg.task_id,
                "profile": core.config.profile,
                "grove_node": core.config.grove_node,
                "dismissing": reg.dismissing,
                "children": [c["agent_id"] for c in core.children],
                "todos": core.ctx.todos,
                "active_skills": list(core.active_skills),
                "pending_actions": len(core.pending_actions),
                "budget": budget,
                "cost": str(self.runtime.costs.total_for(reg.agent_id)),
            })
        return out

    def logs_payload(self, agent_id: Optional[str], limit: int = 200) -> list[dict]:
        rows = self.runtime.db.query(
            "SELECT * FROM logs WHERE (?1 IS NULL OR agent_id=?1) "
            "ORDER BY id DESC LIMIT ?2", (agent_id, limit))
        return [dict(r) for r in reversed(rows)]

    def history_payload(self, agent_id: Optional[str],
                        task_id: Optional[str] = None) -> dict:
        """Mount replay straight from the in-memory ring buffers
        (infra/event_history.py) — the recent-events snapshot a freshly
        opened view renders BEFORE its SSE subscription starts delivering,
        exactly the reference's LiveView mount replay
        (reference ui/event_history.ex:17-20). Durable tables cover deep
        history; this covers the live tail without a DB round-trip."""
        h = self.runtime.history
        payload = {
            "lifecycle": h.replay_lifecycle(),
            "actions": h.replay_actions(),
            "serving": h.replay_serving(),
            "resources": h.replay_resources(),
            # consensus-audit ring: recent decide records +
            # drift alerts, same bearer gating + token redaction as the
            # trace ring (both ride the generic gated-GET path)
            "consensus": h.replay_consensus(),
            # cluster incidents: replica death, handoff
            # rejects, router all-shed — TOPIC_CLUSTER ring
            "cluster": h.replay_cluster(),
            # fabric incidents: peer death, frame rejects,
            # prefixd degrades — TOPIC_FABRIC ring
            "fabric": h.replay_fabric(),
            # fleet-controller events: scale / re-tier /
            # drain actions + migration totals — TOPIC_FLEET ring
            "fleet": h.replay_fleet(),
            # serving-flywheel events: promotions and
            # rollbacks — TOPIC_TRAIN ring
            "train": h.replay_train(),
        }
        if agent_id:
            payload["logs"] = h.replay_logs(agent_id)
        if agent_id or task_id:
            # task mailbox broadcasts ring under the TASK key and, when
            # the message names a sender ('agent_id' or the executors'
            # 'from' field), under that sender too (event_history.py)
            payload["messages"] = h.replay_messages(agent_id or task_id)
        return payload

    def logs_joined_payload(self, task_id: Optional[str],
                            level: Optional[str],
                            limit: int = 300) -> list[dict]:
        """Cross-task log rows: logs carry only agent_id, so the task
        association joins through the agents table (the /logs standalone
        view's read model — reference LogViewLive)."""
        rows = self.runtime.db.query(
            "SELECT l.*, a.task_id AS task_id FROM logs l "
            "LEFT JOIN agents a ON l.agent_id = a.agent_id "
            "WHERE (?1 IS NULL OR a.task_id=?1) "
            "AND (?2 IS NULL OR l.level=?2) "
            "ORDER BY l.id DESC LIMIT ?3", (task_id, level, limit))
        return [dict(r) for r in reversed(rows)]

    def messages_payload(self, task_id: Optional[str],
                         limit: int = 100) -> list[dict]:
        rows = self.runtime.db.query(
            "SELECT * FROM messages WHERE (?1 IS NULL OR task_id=?1) "
            "ORDER BY id DESC LIMIT ?2", (task_id, limit))
        return [dict(r) for r in reversed(rows)]

    def groves_payload(self) -> list[dict]:
        """Available groves + resolved bootstrap pre-fill for the new-task
        modal (reference new_task_modal.ex grove selector +
        bootstrap_resolver.ex — the browser shows the fields a grove run
        would start with and posts the grove dir back on create)."""
        from quoracle_tpu_torch.governance.grove import GroveEnforcer
        out = []
        for m in self.runtime.list_groves():
            try:
                boot = GroveEnforcer(m).bootstrap_fields()
            except Exception:            # noqa: BLE001 — list what loads
                boot = {}
            out.append({
                "name": m.name, "dir": m.path,
                "description": m.description,
                "root_node": m.root_node,
                "bootstrap": {k: (v[:2000] if isinstance(v, str) else v)
                              for k, v in boot.items()},
            })
        return out

    def metrics_payload(self) -> dict:
        """Runtime telemetry snapshot (reference parity: QuoracleWeb.
        Telemetry polls Phoenix/Ecto/VM metrics into LiveDashboard,
        telemetry.ex:20-50 — here the same classes of numbers come from
        one on-demand endpoint): process/VM stats, durable-row counts,
        live-agent counts, cost totals, the serving backend's per-member
        phase timings + KV-session occupancy, and the histogram-quantile
        telemetry block (infra/telemetry.py) that supersedes the
        last-call scalars — which stay for parity."""
        import resource
        import threading
        import time as _time

        from quoracle_tpu_torch.infra.telemetry import METRICS

        rt = self.runtime
        ru = resource.getrusage(resource.RUSAGE_SELF)
        # ru_maxrss is KiB on Linux but BYTES on darwin (getrusage(2)) —
        # and it is PEAK rss either way; current rss comes from
        # /proc/self/statm on Linux (falls back to the peak elsewhere).
        rss_div = 1024 * 1024 if sys.platform == "darwin" else 1024
        peak_rss_mb = round(ru.ru_maxrss / rss_div, 1)
        rss_mb = peak_rss_mb
        try:
            import os
            with open("/proc/self/statm") as f:
                rss_pages = int(f.read().split()[1])
            rss_mb = round(rss_pages * os.sysconf("SC_PAGE_SIZE")
                           / (1024 * 1024), 1)
        except (OSError, IndexError, ValueError):
            pass
        vm = {
            "rss_mb": rss_mb,
            "peak_rss_mb": peak_rss_mb,
            "user_cpu_s": round(ru.ru_utime, 1),
            "system_cpu_s": round(ru.ru_stime, 1),
            "threads": threading.active_count(),
            "uptime_s": round(_time.monotonic() - self._t0, 1),
        }
        counts = {
            row_kind: rt.db.query(
                f"SELECT COUNT(*) AS n FROM {row_kind}")[0]["n"]
            for row_kind in ("tasks", "agents", "logs", "messages",
                             "actions", "agent_costs")
        }
        live = rt.registry.all()
        agents = {
            "live": len(live),
            "pending_actions": sum(len(r.core.pending_actions)
                                   for r in live),
        }
        backend = {"type": type(rt.backend).__name__}
        engines = getattr(rt.backend, "engines", None)
        if engines:
            backend["members"] = {
                spec: {
                    "last_prefill_ms": round(e.last_prefill_s * 1000, 1),
                    "last_decode_ms": round(e.last_decode_s * 1000, 1),
                    "last_prefill_tokens": e.last_prefill_tokens,
                    "kv_sessions": len(e.sessions),
                    "kv_free_pages": e.sessions.free_pages(),
                    # radix prefix cache (models/prefix_cache.py):
                    # hit/miss/evict/COW counters + resident page count
                    "prefix_cache": e.sessions.prefix_cache.stats(),
                }
                for spec, e in engines.items()
            }
        return {"vm": vm, "rows": counts, "agents": agents,
                "backend": backend,
                # histogram quantiles (p50/p95/p99) per instrument — the
                # tail-latency view the last_* scalars above cannot give
                "telemetry": METRICS.snapshot(),
                "total_cost": str(rt.store.total_costs())}

    def resources_payload(self) -> dict:
        """GET /api/resources: the live resource view — device
        memory with per-engine HBM attribution (infra/resources.py),
        the compile registry per engine (models/generate.py), scheduler
        health (models/scheduler.py), the stall watchdog, and the flight
        recorder's status. Collectors run first so the gauges a scraper
        reads next agree with this JSON."""
        from quoracle_tpu_torch.infra import resources
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        from quoracle_tpu_torch.infra.telemetry import METRICS

        METRICS.collect()
        rt = self.runtime
        engines = getattr(rt.backend, "engines", None) or {}
        watchdog = getattr(rt, "watchdog", None)
        return {
            "process": resources.process_stats(),
            "devices": resources.device_memory_stats(),
            "hbm": resources.hbm_attribution(rt.backend),
            "compile": {spec: e.compiles.snapshot()
                        for spec, e in engines.items()
                        if getattr(e, "compiles", None) is not None},
            "scheduler": rt.backend.scheduler_stats(),
            "watchdog": watchdog.status() if watchdog is not None else None,
            "flight_recorder": FLIGHT.status(),
        }

    def trace_payload(self, trace_id: Optional[str]) -> dict:
        """Finished spans from the TOPIC_TRACE ring, filtered to one
        trace (= task) when given. Spans link via span_id/parent_id;
        clients rebuild the decide → member prefill/decode → action tree
        from those fields."""
        spans = self.runtime.history.replay_traces(trace_id)
        return {"task_id": trace_id, "n_spans": len(spans), "spans": spans}

    def models_payload(self) -> dict:
        """GET /api/models: the consensus-quality scorecards —
        rolling per-member agreement/dissent/failure-by-kind/recovery
        rates, proposal latency quantiles, and EWMA drift state
        (consensus/quality.py QUALITY)."""
        from quoracle_tpu_torch.consensus.quality import QUALITY
        payload = QUALITY.scorecards()
        payload["pool"] = self.runtime.default_pool()
        # speculative serving: per-member acceptance /
        # tokens-per-round / adaptive-K / fallback scorecard — the
        # serving-side half of the member picture
        backend = self.runtime.backend
        payload["speculative"] = (backend.spec_stats()
                                  if hasattr(backend, "spec_stats")
                                  else {"enabled": False})
        return payload

    def consensus_payload(self, task_id: Optional[str]) -> dict:
        """GET /api/consensus?task_id=…: per-decide audit records — the
        EventHistory ring (live tail) merged with the durable
        consensus_audit table (deep history), deduped by decide_id and
        ordered by time."""
        ring = self.runtime.history.replay_consensus(task_id)
        durable = (self.runtime.store.audit_for_task(task_id)
                   if task_id else [])
        seen: set = set()
        records = []
        for r in durable + ring:
            key = r.get("decide_id") or ("ts", r.get("ts"))
            if key in seen:
                continue
            seen.add(key)
            records.append(r)
        records.sort(key=lambda r: r.get("ts") or 0.0)
        return {"task_id": task_id, "n_records": len(records),
                "records": records}

    def kv_payload(self) -> dict:
        """GET /api/kv: the tiered-KV panel — per-member tier
        occupancy (HBM pages / host bytes / disk entries), the
        demote/restore/spill counters, and restore-latency quantiles
        from the quoracle_kv_restore_ms histogram."""
        from quoracle_tpu_torch.infra.telemetry import (
            KV_DEMOTES_TOTAL, KV_RESTORE_MS, KV_RESTORES_TOTAL,
        )
        backend = self.runtime.backend
        payload = (backend.kv_stats() if hasattr(backend, "kv_stats")
                   else {"enabled": False})
        payload["counters"] = {
            "demotes": KV_DEMOTES_TOTAL._snapshot(),
            "restores": KV_RESTORES_TOTAL._snapshot(),
            "restore_ms": KV_RESTORE_MS._snapshot(),
        }
        return payload

    def cluster_payload(self) -> dict:
        """GET /api/cluster: the disaggregated-plane panel —
        replica topology, router placement/affinity state (with each
        replica's live admission-signal snapshot), and the handoff
        counters. ``enabled`` False on single-backend runtimes."""
        from quoracle_tpu_torch.infra.telemetry import (
            CLUSTER_HANDOFF_MS, CLUSTER_HANDOFFS_TOTAL,
            ROUTER_PLACEMENTS_TOTAL,
        )
        backend = self.runtime.backend
        stats = getattr(backend, "cluster_stats", None)
        payload = stats() if stats is not None else {"enabled": False}
        payload["counters"] = {
            "handoffs": CLUSTER_HANDOFFS_TOTAL._snapshot(),
            "handoff_ms": CLUSTER_HANDOFF_MS._snapshot(),
            "placements": ROUTER_PLACEMENTS_TOTAL._snapshot(),
        }
        return payload

    def fabric_payload(self) -> dict:
        """GET /api/fabric: the cross-host fabric panel —
        peer topology + per-peer transport counters (front-door
        runtimes), the wire request/retry/frame-reject series, and
        prefixd client stats rolled up from the engine tiers.
        ``enabled`` False when this runtime neither fronts peers nor
        serves as one."""
        from quoracle_tpu_torch.infra.telemetry import (
            FABRIC_FRAME_REJECTS_TOTAL, FABRIC_PREFIXD_TOTAL,
            FABRIC_REQUESTS_TOTAL, FABRIC_RETRIES_TOTAL, FABRIC_RTT_MS,
        )
        backend = self.runtime.backend
        stats = getattr(backend, "fabric_stats", None)
        if stats is not None:
            payload = stats()
        else:
            peer = getattr(self.runtime, "_fabric_peer", None)
            payload = ({"enabled": True, "peer": peer.stats()}
                       if peer is not None else {"enabled": False})
        prefixd = {}
        engines = getattr(backend, "engines", None) or {}
        for name, eng in engines.items():
            tier = getattr(getattr(eng, "sessions", None), "tier", None)
            client = getattr(tier, "prefixd", None)
            if client is not None:
                prefixd[name] = client.stats()
        if prefixd:
            payload["prefixd"] = prefixd
        payload["counters"] = {
            "requests": FABRIC_REQUESTS_TOTAL._snapshot(),
            "retries": FABRIC_RETRIES_TOTAL._snapshot(),
            "frame_rejects": FABRIC_FRAME_REJECTS_TOTAL._snapshot(),
            "rtt_ms": FABRIC_RTT_MS._snapshot(),
            "prefixd": FABRIC_PREFIXD_TOTAL._snapshot(),
        }
        return payload

    def chaos_payload(self) -> dict:
        """GET /api/chaos: the chaos plane — armed plan, injection-point
        catalog, recent fired faults, the last scenario report's
        invariant verdicts, and the fault/invariant counter series."""
        from quoracle_tpu_torch.chaos.faults import CHAOS
        from quoracle_tpu_torch.infra.telemetry import (
            CHAOS_FAULTS_TOTAL, CHAOS_INVARIANT_FAILURES,
            CHAOS_SCENARIOS_TOTAL,
        )
        payload = CHAOS.status()
        payload["counters"] = {
            "faults": CHAOS_FAULTS_TOTAL._snapshot(),
            "scenarios": CHAOS_SCENARIOS_TOTAL._snapshot(),
            "invariant_failures": CHAOS_INVARIANT_FAILURES._snapshot(),
        }
        return payload

    def fleet_payload(self) -> dict:
        """GET /api/fleet: the elastic-fleet panel — policy
        config, tick/cooldown state, the recent action ledger, and the
        action/migration counter series. ``enabled`` False on runtimes
        without a FleetController."""
        from quoracle_tpu_torch.infra.telemetry import (
            FLEET_ACTIONS_TOTAL, FLEET_DRAIN_MS,
            FLEET_SESSIONS_MIGRATED_TOTAL,
        )
        fleet = getattr(self.runtime, "_fleet", None)
        payload = fleet.stats() if fleet is not None \
            else {"enabled": False}
        payload["counters"] = {
            "actions": FLEET_ACTIONS_TOTAL._snapshot(),
            "sessions_migrated":
                FLEET_SESSIONS_MIGRATED_TOTAL._snapshot(),
            "drain_ms": FLEET_DRAIN_MS._snapshot(),
        }
        return payload

    def costs_payload(self) -> dict:
        """GET /api/costs: the chip-economics panel —
        nominal Decimal billing (catalog-rate CostEntry rows, newest
        last, bounded) beside the measured chip-second ledgers
        (per-model busy wall, per-stage / per-tenant / per-class
        splits, padding overhead) so billed and burned sit in one
        response."""
        from quoracle_tpu_torch.infra import costobs
        with self.runtime.costs._lock:
            entries = list(self.runtime.costs._entries[-200:])
        payload = costobs.costs_payload()
        payload["nominal"] = {
            "n_entries": len(entries),
            "total_amount": str(sum((e.amount for e in entries),
                                    Decimal("0"))),
            "measured_chip_ms": round(
                sum(e.measured_chip_ms for e in entries), 3),
            "entries": [{
                "agent_id": e.agent_id, "task_id": e.task_id,
                "amount": str(e.amount), "type": e.cost_type,
                "model": e.model_spec,
                "input_tokens": e.input_tokens,
                "output_tokens": e.output_tokens,
                "measured_chip_ms": e.measured_chip_ms,
                "ts": e.ts,
            } for e in entries],
        }
        return payload

    def budget_payload(self) -> dict:
        """GET /api/budget: per-tenant-class SLO error budgets
        — multi-window (1h/6h) burn rates, remaining-budget
        ratios, and deterministic trip ids from the chip-economics
        plane's BudgetTracker. Observed-only: nothing in admission or
        fleet policy acts on these numbers."""
        from quoracle_tpu_torch.infra import costobs
        payload = costobs.BUDGET.snapshot()
        payload["enabled"] = costobs.enabled()
        payload["slo_targets"] = dict(costobs.SLO_TARGETS)
        return payload

    def qos_payload(self) -> dict:
        """GET /api/qos: the serving-QoS panel — admission
        controller state (signals, thresholds, tenant buckets), the
        per-member weighted-fair queue snapshots, the SLO tracker's
        per-class tails, and the admit/shed counter series."""
        from quoracle_tpu_torch.infra.telemetry import (
            QOS_ADMIT_WAIT_MS, QOS_ADMITTED_TOTAL, QOS_SHED_TOTAL,
        )
        backend = self.runtime.backend
        payload = (backend.qos_stats()
                   if hasattr(backend, "qos_stats")
                   else {"enabled": False})
        payload["counters"] = {
            "admitted": QOS_ADMITTED_TOTAL._snapshot(),
            "shed": QOS_SHED_TOTAL._snapshot(),
            "admit_wait_ms": QOS_ADMIT_WAIT_MS._snapshot(),
        }
        payload["tenant_map_configured"] = bool(
            self._tenant_map())
        return payload

    def _tenant_map(self) -> dict:
        """The ``qos_tenants`` setting: {bearer token: tenant name}.
        Unset/malformed → empty (every caller is tenant 'default')."""
        try:
            mapping = self.runtime.store.get_setting("qos_tenants")
        except Exception:                # noqa: BLE001 — optional setting
            return {}
        return mapping if isinstance(mapping, dict) else {}

    def tenant_for_token(self, token: Optional[str]) -> str:
        return self._tenant_map().get(token or "", "default")

    def prometheus_text(self) -> str:
        """GET /metrics body: scrape-time gauge refresh + the registry's
        text exposition (infra/telemetry.py). A fabric front door
        serves the FLEET rollup instead: every peer's
        lossless registry state scraped over the wire and merged, all
        series labeled by ``peer`` (the door's own under
        ``peer="door"``), histogram aggregates under ``peer="fleet"``
        whose quantiles equal the merged per-peer oracle."""
        from quoracle_tpu_torch.infra.telemetry import (
            KV_FREE_PAGES, LIVE_AGENTS, METRICS,
        )
        rt = self.runtime
        LIVE_AGENTS.set(len(rt.registry.all()))
        for spec, e in (getattr(rt.backend, "engines", None) or {}).items():
            KV_FREE_PAGES.set(e.sessions.free_pages(), model=spec)
        fed_fn = getattr(rt.backend, "federated_metrics", None)
        if fed_fn is not None:
            return fed_fn().render_prometheus()
        return METRICS.render_prometheus()

    def timeline_payload(self, session_id: Optional[str] = None,
                         trace_id: Optional[str] = None) -> dict:
        """GET /api/timeline?session_id=…: one session's ordered
        lifecycle — spans pulled from every fabric peer on a
        front door (backend.pull_timeline), the process-wide span ring
        otherwise. With no filter, the most recently traced session is
        shown (the /telemetry panel's default)."""
        from quoracle_tpu_torch.infra import fleetobs
        if session_id is None and trace_id is None:
            for s in reversed(fleetobs.SPANS.spans()):
                if s.get("session"):
                    session_id = s["session"]
                    break
        fn = getattr(self.runtime.backend, "pull_timeline", None)
        if fn is not None:
            return fn(session_id=session_id, trace_id=trace_id)
        return fleetobs.assemble_timeline(
            fleetobs.SPANS.spans(), session_id=session_id,
            trace_id=trace_id)

    def incidents_payload(self) -> dict:
        """GET /api/incidents: the correlated-incident bundles
        — each a deterministic-id directory holding every
        reachable peer's flight-ring dump, retention-pruned."""
        from quoracle_tpu_torch.infra.fleetobs import INCIDENTS
        return {"incidents": INCIDENTS.list(),
                **INCIDENTS.status()}

    def profile_payload(self) -> dict:
        """GET /api/profile: the liveness & hotspot plane —
        collapsed-stack wall-clock profile windows, heartbeat counters,
        stall-detector status, and per-state wait totals. On a front
        door the payload federates every alive peer's view
        (backend.pull_profile); a single process reports itself."""
        from quoracle_tpu_torch.infra import introspect
        fn = getattr(self.runtime.backend, "pull_profile", None)
        if fn is not None:
            return fn()
        return introspect.profile_payload()

    def tree_payload(self, tree_id: Optional[str] = None) -> dict:
        """GET /api/tree?tree_id=…: one coherent agent-tree view
        — per-node and per-subtree rollups (chip-ns, tokens,
        wait-ns; conservation exact), the critical path, and orphan
        flags. On a front door the view assembles every alive peer's
        registry slice (backend.pull_tree); a single process reports
        its own. With no filter, the most recently registered tree is
        shown."""
        from quoracle_tpu_torch.infra import treeobs
        if not treeobs.enabled():
            return {"enabled": False, "tree_id": tree_id}
        if tree_id is None:
            trees = treeobs.local_tree_state().get("trees") or {}
            tree_id = next(reversed(trees), None)
            if tree_id is None:
                return {"enabled": True, "tree_id": None, "nodes": []}
        fn = getattr(self.runtime.backend, "pull_tree", None)
        if fn is not None:
            return fn(tree_id)
        return treeobs.tree_payload(tree_id)

    def settings_payload(self) -> dict:
        """The settings surface (reference SecretManagementLive): system
        settings, profiles, secret METADATA (values never leave the vault),
        and the served model catalog."""
        from quoracle_tpu_torch.models.config import list_models
        store = self.runtime.store
        return {
            "settings": store.all_settings(),
            "profiles": {name: store.get_profile(name)
                         for name in store.list_profiles()},
            "secrets": self.runtime.secrets.search(""),
            "models": list_models(),
            "default_pool": self.runtime.default_pool(),
        }


class _Handler(BaseHTTPRequestHandler):
    dashboard: DashboardServer = None  # bound by DashboardServer.start

    # -- plumbing -------------------------------------------------------

    def log_message(self, fmt, *args):          # quiet access log
        # redact ?token=… — GET /events carries the bearer token as a query
        # param (EventSource can't set headers); it must not reach logs.
        # The same applies to every other tokened GET (/metrics scrapers,
        # /api/trace?task_id=…&token=…): the regex matches the token
        # param at any position, so new endpoints are covered by
        # construction — only the token value is secret, task/trace ids
        # are not.
        import re
        args = tuple(re.sub(r"([?&]token=)[^& ]*", r"\1[REDACTED]", a)
                     if isinstance(a, str) else a for a in args)
        logger.debug("dashboard: " + fmt, *args)

    def _send_json(self, payload: Any, status: int = 200,
                   extra_headers: Optional[dict] = None) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(status)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _send_html(self, html_text: str, status: int = 200) -> None:
        body = html_text.encode()
        self.send_response(status)
        self.send_header("content-type", "text/html; charset=utf-8")
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, text: str, content_type: str,
                   status: int = 200) -> None:
        body = text.encode()
        self.send_response(status)
        self.send_header("content-type", content_type)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        length = int(self.headers.get("content-length") or 0)
        if not length:
            return {}
        try:
            return json.loads(self.rfile.read(length))
        except json.JSONDecodeError:
            return {}

    # -- GET ------------------------------------------------------------

    def do_GET(self) -> None:       # noqa: N802 (stdlib API)
        parsed = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(parsed.query)
        one = lambda k: (q.get(k) or [None])[0]
        d = self.dashboard
        # When a token is configured (the non-loopback deployment mode) the
        # read endpoints are gated too: logs/messages/SSE carry full agent
        # transcripts, which routinely include repo contents and secrets.
        # Only the static page and the health probe stay open. GETs may
        # carry the token as ?token= because EventSource can't set headers
        # (the SPA attaches it; see page.py).
        if parsed.path not in ("/", "/healthz") and not self._authorized(
                query_token=one("token")):
            self._send_json({"error": "unauthorized"}, 401)
            return
        try:
            if parsed.path == "/":
                self._send_html(DASHBOARD_HTML)
            elif parsed.path == "/logs":
                from quoracle_tpu_torch.web import views
                self._send_html(views.logs_page(
                    d.tasks_payload(),
                    d.logs_joined_payload(one("task_id"), one("level")),
                    one("task_id"), one("level")))
            elif parsed.path == "/mailbox":
                from quoracle_tpu_torch.web import views
                self._send_html(views.mailbox_page(
                    d.tasks_payload(), d.agents_payload(one("task_id")),
                    d.messages_payload(one("task_id")), one("task_id")))
            elif parsed.path == "/telemetry":
                from quoracle_tpu_torch.web import views
                self._send_html(views.telemetry_page(
                    d.metrics_payload(), d.resources_payload(),
                    d.qos_payload(), d.models_payload(),
                    d.kv_payload(), d.chaos_payload(),
                    d.fleet_payload(), d.timeline_payload(),
                    None, d.profile_payload(),
                    not_ported={path.rsplit("/", 1)[1]: item
                                for path, item in NOT_PORTED.items()}))
            elif parsed.path == "/settings":
                from quoracle_tpu_torch.web import views
                self._send_html(views.settings_page(
                    d.settings_payload(), d.runtime.credentials.list()))
            elif parsed.path == "/healthz":
                self._send_json({"status": "ok"})
            elif parsed.path == "/api/status":
                self._send_json(d.runtime.status())
            elif parsed.path == "/api/tasks":
                self._send_json(d.tasks_payload())
            elif parsed.path == "/api/agents":
                self._send_json(d.agents_payload(one("task_id")))
            elif parsed.path == "/api/logs":
                self._send_json(d.logs_payload(one("agent_id")))
            elif parsed.path == "/api/history":
                self._send_json(d.history_payload(one("agent_id"),
                                                  one("task_id")))
            elif parsed.path == "/api/messages":
                self._send_json(d.messages_payload(one("task_id")))
            elif parsed.path == "/api/groves":
                self._send_json(d.groves_payload())
            elif parsed.path == "/api/credentials":
                # metadata only — payloads never leave the vault
                self._send_json(d.runtime.credentials.list())
            elif parsed.path == "/api/settings":
                self._send_json(d.settings_payload())
            elif parsed.path == "/api/metrics":
                self._send_json(d.metrics_payload())
            elif parsed.path == "/api/resources":
                self._send_json(d.resources_payload())
            elif parsed.path == "/api/qos":
                self._send_json(d.qos_payload())
            elif parsed.path == "/api/kv":
                self._send_json(d.kv_payload())
            elif parsed.path == "/api/cluster":
                self._send_json(d.cluster_payload())
            elif parsed.path == "/api/fabric":
                self._send_json(d.fabric_payload())
            elif parsed.path == "/api/chaos":
                self._send_json(d.chaos_payload())
            elif parsed.path in NOT_PORTED:
                self._send_json({"error": "not ported",
                                 "route": parsed.path,
                                 "roadmap": NOT_PORTED[parsed.path]}, 501)
            elif parsed.path == "/api/fleet":
                self._send_json(d.fleet_payload())
            elif parsed.path == "/api/costs":
                self._send_json(d.costs_payload())
            elif parsed.path == "/api/budget":
                self._send_json(d.budget_payload())
            elif parsed.path == "/api/models":
                self._send_json(d.models_payload())
            elif parsed.path == "/api/consensus":
                self._send_json(d.consensus_payload(one("task_id")))
            elif parsed.path == "/api/trace":
                self._send_json(d.trace_payload(one("task_id")
                                                or one("trace_id")))
            elif parsed.path == "/api/timeline":
                self._send_json(d.timeline_payload(
                    one("session_id"), one("trace_id")))
            elif parsed.path == "/api/incidents":
                self._send_json(d.incidents_payload())
            elif parsed.path == "/api/profile":
                self._send_json(d.profile_payload())
            elif parsed.path == "/api/tree":
                self._send_json(d.tree_payload(one("tree_id")))
            elif parsed.path == "/metrics":
                # Prometheus text exposition; gated by the same bearer
                # token as the API above (scrapers pass it via the
                # authorization header or ?token=)
                self._send_text(d.prometheus_text(),
                                "text/plain; version=0.0.4; charset=utf-8")
            elif parsed.path == "/events":
                self._stream_events()
            else:
                self._send_json({"error": "not found"}, 404)
        except BrokenPipeError:
            pass
        except Exception as e:
            logger.exception("dashboard GET %s failed", self.path)
            try:
                self._send_json({"error": str(e)}, 500)
            except Exception:
                pass

    def _stream_events(self) -> None:
        """SSE: a plain thread-safe queue subscribed to every bus topic —
        broadcasts arrive from the runtime loop or executor threads alike."""
        d = self.dashboard
        events: queue.Queue = queue.Queue(maxsize=1000)

        def push(topic: str, event: dict) -> None:
            try:
                events.put_nowait({"topic": topic, **event})
            except queue.Full:
                pass                      # slow browser: drop, don't block

        sub = d.runtime.bus.subscribe("*", push)
        try:
            self.send_response(200)
            self.send_header("content-type", "text/event-stream")
            self.send_header("cache-control", "no-cache")
            self.end_headers()
            while True:
                try:
                    event = events.get(timeout=15.0)
                    data = json.dumps(event, default=str)
                    self.wfile.write(f"data: {data}\n\n".encode())
                except queue.Empty:
                    self.wfile.write(b": heartbeat\n\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            sub.unsubscribe()

    # -- POST -----------------------------------------------------------

    def _authorized(self, query_token: Optional[str] = None) -> bool:
        token = self.dashboard.auth_token
        if token is None:
            return True             # loopback-only bind (enforced at init)
        import hmac
        got = query_token if query_token is not None else \
            (self.headers.get("authorization") or "").removeprefix("Bearer ")
        # bytes on both sides: compare_digest raises TypeError on non-ASCII
        # str, and headers are latin-1 decoded so that's remotely reachable.
        return hmac.compare_digest(got.encode("utf-8", "surrogateescape"),
                                   token.encode("utf-8", "surrogateescape"))

    def _qos_shed(self, tenant: str) -> bool:
        """Serving-QoS gate for work-creating POSTs: dashboard
        submissions are INTERACTIVE-class; when the backend's admission
        controller sheds, the caller gets 429 + ``Retry-After`` (seconds,
        ceil) and the structured reject body with ``retry_after_ms`` —
        never a hung request against a saturated queue. Returns True when
        the response has been sent (caller must stop)."""
        ctrl = getattr(self.dashboard.runtime.backend,
                       "qos_controller", None)
        if ctrl is None:
            return False
        from quoracle_tpu_torch.serving.admission import AdmissionError
        from quoracle_tpu_torch.serving.qos import Priority
        try:
            ctrl.admit(tenant=tenant, priority=Priority.INTERACTIVE)
        except AdmissionError as e:
            self._send_json(
                e.as_dict(), 429,
                extra_headers={"Retry-After":
                               max(1, -(-e.retry_after_ms // 1000))})
            return True
        return False

    def do_POST(self) -> None:      # noqa: N802 (stdlib API)
        d = self.dashboard
        if not self._authorized():
            self._send_json({"error": "unauthorized"}, 401)
            return
        tenant = d.tenant_for_token(
            (self.headers.get("authorization") or "")
            .removeprefix("Bearer "))
        body = self._read_body()
        try:
            if self.path == "/api/tasks":
                if self._qos_shed(tenant):
                    return
                pool = body.get("model_pool")
                if pool is None and body.get("profile") is None:
                    pool = d.runtime.default_pool()   # UI sends only text
                task_id, root = d.call_async(d.runtime.tasks.create_task(
                    body.get("description"),
                    model_pool=pool,
                    profile=body.get("profile"),
                    budget=body.get("budget"),
                    grove=body.get("grove"),
                    tenant=tenant))
                self._send_json({"task_id": task_id,
                                 "root_agent": root.agent_id}, 201)
            elif self.path.startswith("/api/tasks/") \
                    and self.path.endswith("/pause"):
                task_id = self.path.split("/")[3]
                stopped = d.call_async(d.runtime.tasks.pause_task(task_id))
                self._send_json({"task_id": task_id, "stopped": stopped})
            elif self.path.startswith("/api/tasks/") \
                    and self.path.endswith("/resume"):
                task_id = self.path.split("/")[3]
                restored = d.call_async(d.runtime.tasks.restore_task(task_id))
                self._send_json({"task_id": task_id, "restored": restored})
            elif self.path == "/api/flightrec/dump":
                from quoracle_tpu_torch.infra.flightrec import FLIGHT
                path = FLIGHT.dump(reason=str(body.get("reason")
                                              or "api"))
                self._send_json({"path": path,
                                 **FLIGHT.status()}, 201)
            elif self.path == "/api/messages":
                if self._qos_shed(tenant):
                    return
                ok = d.post_to_agent(body.get("agent_id", ""), {
                    "type": "user_message",
                    "content": body.get("content", ""), "from": "user"})
                self._send_json({"delivered": ok}, 200 if ok else 404)
            elif self.path == "/api/settings":
                # {key: value, ...} — merge into model_settings rows;
                # validate ALL keys before writing any (atomic endpoint)
                if not all(isinstance(k, str) and k for k in body):
                    self._send_json({"error": "keys must be non-empty "
                                              "strings"}, 400)
                    return
                for key, value in body.items():
                    d.runtime.store.set_setting(key, value)
                self._send_json(d.runtime.store.all_settings())
            elif self.path == "/api/profiles":
                name = body.get("name")
                if not name or not isinstance(name, str):
                    self._send_json({"error": "profile name required"}, 400)
                    return
                # MERGE into the existing profile: a form that carries only
                # model_pool must not silently drop capability_groups etc.
                data = d.runtime.store.get_profile(name) or {}
                data.update({k: v for k, v in body.items() if k != "name"})
                d.runtime.store.save_profile(name, data)
                self._send_json({"name": name, **data}, 201)
            elif self.path == "/api/credentials":
                cid = body.get("id")
                data = body.get("data")
                if not cid or not isinstance(data, dict):
                    self._send_json({"error": "id and data{} required"},
                                    400)
                    return
                d.runtime.credentials.put(cid, data,
                                          model_spec=body.get("model_spec"))
                self._send_json(d.runtime.credentials.list(), 201)
            elif self.path == "/api/secrets":
                name = body.get("name")
                if not name or not isinstance(name, str):
                    self._send_json({"error": "secret name required"}, 400)
                    return
                if body.get("value"):
                    d.runtime.secrets.put(
                        name, str(body["value"]),
                        description=body.get("description", ""),
                        created_by="dashboard")
                else:   # no value → generate (reference generate_secret)
                    d.runtime.secrets.generate(
                        name, length=int(body.get("length", 32)),
                        charset=body.get("charset", "alphanumeric"),
                        description=body.get("description", ""),
                        created_by="dashboard")
                # metadata only; the value never goes back over the wire
                self._send_json(
                    next(s for s in d.runtime.secrets.search("")
                         if s["name"] == name), 201)
            else:
                self._send_json({"error": "not found"}, 404)
        except Exception as e:
            logger.exception("dashboard POST %s failed", self.path)
            self._send_json({"error": str(e)}, 500)

    def do_DELETE(self) -> None:    # noqa: N802 (stdlib API)
        d = self.dashboard
        if not self._authorized():
            self._send_json({"error": "unauthorized"}, 401)
            return
        try:
            parts = self.path.rstrip("/").split("/")
            if self.path.startswith("/api/profiles/") and len(parts) == 4:
                ok = d.runtime.store.delete_profile(
                    urllib.parse.unquote(parts[3]))
                self._send_json({"deleted": ok}, 200 if ok else 404)
            elif self.path.startswith("/api/secrets/") and len(parts) == 4:
                ok = d.runtime.secrets.delete(
                    urllib.parse.unquote(parts[3]))
                self._send_json({"deleted": ok}, 200 if ok else 404)
            elif self.path.startswith("/api/credentials/") and len(parts) == 4:
                ok = d.runtime.credentials.delete(
                    urllib.parse.unquote(parts[3]))
                self._send_json({"deleted": ok}, 200 if ok else 404)
            else:
                self._send_json({"error": "not found"}, 404)
        except Exception as e:
            logger.exception("dashboard DELETE %s failed", self.path)
            self._send_json({"error": str(e)}, 500)
