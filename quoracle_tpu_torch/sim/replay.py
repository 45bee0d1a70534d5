"""Compressed-time replay driver (port of ``quoracle_tpu/sim/replay.py``).

``ReplayDriver`` walks a trace event by event on a VIRTUAL clock — time
advances to the next arrival instead of sleeping — against a
deterministic capacity + tier-ladder model, and records every outcome
(admit / shed / deadline, modeled TTFT, tier transition, tokens) into a
:class:`ReplayLedger`. The model is pure arithmetic over the event
stream: no wall-clock reads feed any ledger field, so replaying the
same trace twice yields a BIT-identical serialized ledger — the
determinism contract tier-1 asserts (sim/gate.py).

The modeled serving plane:

* **capacity** — an exact FCFS k-server queue (per-slot free-time heap)
  with a reserved interactive sub-pool, per-class queue-wait shed
  bounds (batch sheds first, the shed ladder's shape), and per-event
  service time from prompt/decode token counts × consensus K;
* **tier ladder** — LRU session tiers with capacity cascades
  (resident → host → disk → prefixd → dropped), restore penalties per
  rung charged into TTFT, and a conservation census (every virtual
  session accounted — the hibernation-tier invariant's source);
* **forecast seam** — per-window traffic-mix priors offered to a
  dry-run FleetController through ``FleetSignals.forecast`` (shadow
  mode: recorded, never acted on — the predictive-policy down payment).

A real plane (a ClusterPlane or FabricPlane, or a live fleet
via ``--sim-trace``) can ride along: every ``sample_every``-th event is
ALSO submitted as a temperature-0 request, and the collected texts feed
the temp-0 spot-check equality invariant. Samples never enter the
ledger — wall time stays out of the determinism contract.

``paced=True`` sleeps a bounded wall-clock scale between events (game
day against a live fleet); ledger fields are virtual either way, so
compressed and paced replays of the same trace are identical.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
import logging
import time
from collections import OrderedDict
from typing import Optional

from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.sim.workload import (
    CLASSES, Trace, event_prompt_text, tree_id_of,
)

logger = logging.getLogger(__name__)

TIERS = ("resident", "host", "disk", "prefixd")

# trace class → serving priority (serving/qos.Priority values)
CLASS_PRIORITY = {"interactive": 0, "agent": 1, "batch": 2}


@dataclasses.dataclass(frozen=True)
class CapacityModel:
    """The modeled fleet, in whole numbers a capacity planner would
    recognize. Defaults approximate a small disaggregated cluster; the
    canonical scenarios (sim/gate.py) size it per trace."""

    decode_slots: int = 32                # concurrent decode rows
    reserved_interactive: int = 8        # slots only interactive/agent use
    prefill_tok_s: float = 50_000.0       # aggregate prefill throughput
    decode_tok_s: float = 400.0           # per-row decode speed
    # queue-wait shed bounds per class (ms) — batch sheds first
    shed_wait_ms: tuple = (("interactive", 2_000), ("agent", 4_000),
                           ("batch", 1_000))
    # tier-ladder session capacities (cascade on overflow)
    resident_sessions: int = 512
    host_sessions: int = 4_096
    disk_sessions: int = 16_384
    prefixd_sessions: int = 16_384
    # restore penalty charged into TTFT per source rung (ms)
    restore_ms: tuple = (("host", 8), ("disk", 40), ("prefixd", 120))


class TierLadder:
    """Deterministic LRU model of the HBM→host→disk→prefixd ladder for
    O(100k) virtual sessions. A touch promotes to resident and cascades
    overflow down the rungs; past the last rung a session is DROPPED
    with a structured reason (never silently forgotten) and its next
    touch is a cold re-prefill. ``census()`` accounts every session
    ever seen — the conservation invariant's source of truth."""

    def __init__(self, cap: CapacityModel):
        self.caps = {"resident": cap.resident_sessions,
                     "host": cap.host_sessions,
                     "disk": cap.disk_sessions,
                     "prefixd": cap.prefixd_sessions}
        self.tiers: dict = {t: OrderedDict() for t in TIERS}
        self.dropped: set = set()
        self.seen = 0
        self.restores = {t: 0 for t in ("host", "disk", "prefixd")}
        self.demotions = {t: 0 for t in ("host", "disk", "prefixd")}
        self.drops = 0
        self.cold_reprefills = 0

    def touch(self, session: str) -> str:
        """Promote to resident; return the tier the session came FROM
        (``new`` for first sight, ``dropped`` for a cold re-prefill)."""
        for t in TIERS:
            if session in self.tiers[t]:
                if t == "resident":
                    self.tiers[t].move_to_end(session)
                    return "resident"
                del self.tiers[t][session]
                self.tiers["resident"][session] = True
                self.restores[t] += 1
                self._cascade()
                return t
        if session in self.dropped:
            self.dropped.discard(session)
            self.cold_reprefills += 1
            src = "dropped"
        else:
            self.seen += 1
            src = "new"
        self.tiers["resident"][session] = True
        self._cascade()
        return src

    def _cascade(self) -> None:
        for src, dst in (("resident", "host"), ("host", "disk"),
                         ("disk", "prefixd")):
            tier = self.tiers[src]
            while len(tier) > self.caps[src]:
                victim, _ = tier.popitem(last=False)
                self.tiers[dst][victim] = True
                self.demotions[dst] += 1
        last = self.tiers["prefixd"]
        while len(last) > self.caps["prefixd"]:
            victim, _ = last.popitem(last=False)
            self.dropped.add(victim)
            self.drops += 1

    def census(self) -> dict:
        c = {t: len(self.tiers[t]) for t in TIERS}
        c["dropped"] = len(self.dropped)
        c["seen"] = self.seen
        return c


class ReplayLedger:
    """Per-event outcomes, canonically serializable. One row per trace
    event: ``[eid, t_ms, cls, outcome, reason, ttft_us, tier_from,
    tier_to, tokens, tree]`` — ints and strings only, so the digest is
    a byte-level determinism check. ``tree`` is the
    agent-tree lineage id for tree-stream events, empty otherwise; the
    sim_tree_conservation gate invariant reconciles it against the
    generated trace exactly."""

    def __init__(self):
        self.rows: list = []

    def append(self, eid: str, t_ms: int, cls: str, outcome: str,
               reason: str, ttft_us: int, tier_from: str,
               tier_to: str, tokens: int, tree: str = "") -> None:
        self.rows.append([eid, t_ms, cls, outcome, reason, ttft_us,
                          tier_from, tier_to, tokens, tree])

    def __len__(self) -> int:
        return len(self.rows)

    def to_json(self) -> str:
        return json.dumps({"version": 1, "rows": self.rows},
                          sort_keys=True, separators=(",", ":"))

    def digest(self) -> str:
        h = hashlib.sha256()
        for r in self.rows:
            h.update(json.dumps(r, separators=(",", ":")).encode())
        return h.hexdigest()[:16]

    def counts(self) -> dict:
        c = {"ok": 0, "shed": 0, "deadline": 0}
        for r in self.rows:
            c[r[3]] = c.get(r[3], 0) + 1
        return c


class ReplayDriver:
    """One trace → one ledger. Single-threaded by design: the only lock
    involved is the process-wide ``SIM`` status board's (rank 3,
    bookkeeping only — nothing is called under it)."""

    def __init__(self, trace: Trace,
                 capacity: Optional[CapacityModel] = None,
                 plane=None, member: Optional[str] = None,
                 fleet=None, bus=None, paced: bool = False,
                 pace_scale: float = 10_000.0, pace_cap_ms: float = 5.0,
                 sample_every: int = 0, max_samples: int = 8,
                 forecast_windows: int = 8):
        self.trace = trace
        self.capacity = capacity or CapacityModel()
        self.plane = plane
        self.member = member
        self.fleet = fleet
        self.bus = bus
        self.paced = paced
        self.pace_scale = pace_scale
        self.pace_cap_ms = pace_cap_ms
        self.sample_every = sample_every
        self.max_samples = max_samples
        self.forecast_windows = max(1, forecast_windows)
        self.ladder = TierLadder(self.capacity)
        self.samples: list = []
        self.forecasts: list = []
        self._stop = False

    def stop(self) -> None:
        self._stop = True

    # -- the modeled serving plane ---------------------------------------

    def _service_ms(self, e, tier_from: str) -> tuple:
        """(restore_ms, prefill_ms, decode_ms) for one event."""
        cap = self.capacity
        restore = dict(cap.restore_ms).get(tier_from, 0)
        prefill = 1000.0 * e.prompt_tokens / cap.prefill_tok_s
        decode = (1000.0 * e.max_new_tokens * max(1, e.consensus_k)
                  / cap.decode_tok_s)
        return float(restore), prefill, decode

    def run(self) -> ReplayLedger:
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        from quoracle_tpu_torch.infra.telemetry import (
            SIM_EVENTS_TOTAL, SIM_GOODPUT, SIM_REPLAYS_TOTAL,
            SIM_SESSIONS, SIM_TTFT_MS,
        )

        cap = self.capacity
        mode = "paced" if self.paced else "compressed"
        FLIGHT.record("sim_replay_start", mode=mode,
                      events=len(self.trace),
                      trace=self.trace.digest())
        t_wall0 = time.monotonic()
        ledger = ReplayLedger()
        shed_wait = dict(cap.shed_wait_ms)
        # FCFS k-server free-time heaps: a shared pool every class uses
        # plus a reserved pool batch may not touch — the modeled shed
        # ladder's interactive protection
        shared = [0.0] * max(1, cap.decode_slots
                             - cap.reserved_interactive)
        reserved = [0.0] * max(0, cap.reserved_interactive)
        heapq.heapify(shared)
        heapq.heapify(reserved)
        ok_tokens = 0
        event_counts: dict = {}
        horizon = max(1, self.trace.spec.horizon_ms)
        window_ms = max(1, horizon // self.forecast_windows)
        window_end = window_ms
        window_counts = {c: 0 for c in CLASSES}
        prev_t = 0
        observe_stride = 16 if len(self.trace) > 10_000 else 1
        for idx, e in enumerate(self.trace.events):
            if self._stop:
                break
            if self.paced and e.t_ms > prev_t:
                # wall pacing only — no wall-clock value is recorded
                time.sleep(min(self.pace_cap_ms,
                               (e.t_ms - prev_t) / self.pace_scale)
                           / 1000.0)
            prev_t = e.t_ms
            while e.t_ms >= window_end:
                self._flush_forecast(window_end, window_ms,
                                     window_counts)
                window_counts = {c: 0 for c in CLASSES}
                window_end += window_ms
            window_counts[e.cls] += 1
            # admission against the modeled queue
            pool = shared
            if e.cls != "batch" and reserved and (
                    reserved[0] <= shared[0]):
                pool = reserved
            free = pool[0]
            start = max(float(e.t_ms), free)
            wait_ms = start - e.t_ms
            tier_from = self.ladder.touch(e.session)
            restore, prefill, decode = self._service_ms(e, tier_from)
            ttft_ms = wait_ms + restore + prefill
            if wait_ms > shed_wait.get(e.cls, 2_000):
                outcome, reason = "shed", "admission_rejected:queue_wait"
                ttft_ms, tokens = 0.0, 0
            elif e.deadline_ms and ttft_ms > e.deadline_ms:
                outcome = "deadline"
                reason = "deadline_exceeded:modeled_ttft"
                tokens = 0
            else:
                outcome, reason = "ok", ""
                if tier_from == "dropped":
                    reason = "cold_reprefill"
                tokens = e.max_new_tokens * max(1, e.consensus_k)
                ok_tokens += tokens
                heapq.heapreplace(pool, start + restore + prefill
                                  + decode)
            ledger.append(e.eid, e.t_ms, e.cls, outcome, reason,
                          int(round(ttft_ms * 1000.0)), tier_from,
                          "resident", tokens, tree_id_of(e))
            key = (e.stream.split(":", 1)[0], outcome)
            event_counts[key] = event_counts.get(key, 0) + 1
            if outcome == "ok" and idx % observe_stride == 0:
                SIM_TTFT_MS.observe(ttft_ms, cls=e.cls)
            self._maybe_sample(idx, e)
        self._flush_forecast(window_end, window_ms, window_counts)
        for (stream, outcome), n in sorted(event_counts.items()):
            SIM_EVENTS_TOTAL.inc(n, stream=stream, outcome=outcome)
        goodput = 1000.0 * ok_tokens / horizon
        SIM_GOODPUT.set(round(goodput, 3))
        census = self.ladder.census()
        for tier in (*TIERS, "dropped"):
            SIM_SESSIONS.set(census[tier], tier=tier)
        SIM_REPLAYS_TOTAL.inc(mode=mode, result="ok")
        wall_s = time.monotonic() - t_wall0
        summary = {
            "mode": mode, "events": len(ledger),
            "trace": self.trace.digest(), "ledger": ledger.digest(),
            "outcomes": ledger.counts(),
            "goodput_tok_s_virtual": round(goodput, 3),
            "census": census, "samples": len(self.samples),
            "forecasts": len(self.forecasts),
            "cold_reprefills": self.ladder.cold_reprefills,
            "restores": dict(self.ladder.restores),
            "demotions": dict(self.ladder.demotions),
            "events_per_wall_s": round(len(ledger)
                                       / max(1e-9, wall_s), 1),
            "compression_x": round(horizon / 1000.0
                                   / max(1e-9, wall_s), 1),
            "wall_s": round(wall_s, 3),
        }
        FLIGHT.record("sim_replay_end", **{
            k: summary[k] for k in ("mode", "events", "ledger",
                                    "outcomes", "wall_s")})
        if self.bus is not None:
            from quoracle_tpu_torch.infra.bus import TOPIC_SIM
            try:
                self.bus.broadcast(TOPIC_SIM, {"type": "sim_replay",
                                               **summary})
            except Exception:             # noqa: BLE001 — best-effort
                logger.exception("sim replay broadcast failed")
        SIM.note_replay(summary)
        return ledger

    def _flush_forecast(self, window_end: int, window_ms: int,
                        counts: dict) -> None:
        """Offer the NEXT window's traffic-mix prior (computed from this
        window's arrivals) to the fleet policy — shadow mode."""
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        span_s = window_ms / 1000.0
        mix = tuple(sorted(
            (c, round(n / span_s, 4)) for c, n in counts.items()))
        self.forecasts.append({"t_ms": window_end, "mix": dict(mix)})
        FLIGHT.record("sim_forecast", t_ms=window_end, mix=dict(mix))
        if self.fleet is not None:
            from quoracle_tpu_torch.serving.fleet import FleetSignals
            try:
                self.fleet.tick(FleetSignals(replicas=(),
                                             forecast=mix))
            except Exception:             # noqa: BLE001 — shadow seam
                logger.exception("sim forecast tick failed")

    def _maybe_sample(self, idx: int, e) -> None:
        """Engine-backed spot check: every ``sample_every``-th event is
        also served for real at temperature 0. Texts are collected for
        the equality invariant; wall time never touches the ledger."""
        if (self.plane is None or self.sample_every <= 0
                or idx % self.sample_every != 0
                or len(self.samples) >= self.max_samples):
            return
        from quoracle_tpu_torch.models.runtime import QueryRequest
        member = self.member
        if member is None:
            return
        req = QueryRequest(
            member, [{"role": "user", "content": event_prompt_text(e)}],
            temperature=0.0, max_tokens=8,
            priority=CLASS_PRIORITY.get(e.cls, 2), tenant=e.tenant)
        try:
            r = self.plane.query([req])[0]
            self.samples.append(
                (e.eid, bool(r.ok), r.text if r.ok else (r.error or "")))
        except Exception as exc:          # noqa: BLE001 — structured
            self.samples.append((e.eid, False, f"{type(exc).__name__}"))


class SimStatus:
    """Process-wide status board behind ``GET /api/sim`` and the
    /telemetry panel — the sim twin of ``CHAOS.status()``. Pure
    bookkeeping under the rank-3 ``sim.replay`` lock; nothing else is
    ever called while it is held."""

    def __init__(self):
        self._lock = named_lock("sim.replay")
        self._trace: Optional[dict] = None
        self._last_replay: Optional[dict] = None
        self._last_report: Optional[dict] = None

    def note_trace(self, stats: dict) -> None:
        with self._lock:
            self._trace = dict(stats)

    def note_replay(self, summary: dict) -> None:
        with self._lock:
            self._last_replay = dict(summary)

    def note_report(self, report: dict) -> None:
        with self._lock:
            self._last_report = dict(report)

    def status(self) -> dict:
        with self._lock:
            return {
                "enabled": (self._trace is not None
                            or self._last_replay is not None
                            or self._last_report is not None),
                "trace": self._trace,
                "last_replay": self._last_replay,
                "last_report": self._last_report,
            }


SIM = SimStatus()
