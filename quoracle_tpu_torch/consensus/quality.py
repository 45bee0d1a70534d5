"""Consensus-quality observability of the PyTorch port (the port's copy
of ``quoracle_tpu/consensus/quality.py``): per-model scorecards, vote
entropy, dissent attribution, decision audit records, and model-health
drift detection.

Three questions it answers from telemetry alone:

  * **which pool member is degrading** — rolling per-member scorecards
    (agreement-with-winner rate, dissent rate, failure rate BY CAUSE,
    correction-recovery rate, proposal latency, chip-ms), exported as
    ``quoracle_consensus_*`` instruments;
  * **how contested was this decision** — per-decide vote entropy over
    clusters, winner margin (winner share − runner-up share),
    rounds-to-consensus, and the near-threshold embedder similarity
    margins that show when two clusters ALMOST merged;
  * **why did this cluster win** — a structured audit record per decide
    (member → proposal → cluster assignment, winner, confidence,
    entropy, margin, failures by kind), the same record in both
    packages, fanned out to the sinks.

**Drift detection**: per member, a slow EWMA baseline and a fast EWMA of
the dissent/failure indicators; when the fast estimate deviates from the
frozen baseline past the threshold, a ``model_health_drift`` event lands
in the flight recorder and fans out to the sinks.

The module-level ``QUALITY`` is deliberately process-wide: records carry
their own task/agent attribution, and tests that need a hermetic view
construct their own :class:`ConsensusQuality`. The layer is strictly
READ-ONLY: it observes outcomes the engine already computed, never
touches the backend, RNG, or device state. The JAX package also registers
the training flywheel's capture store as a sink; the flywheel is not in
the port (Queue 1 item 11), so no sink is registered here.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import deque
from typing import Any, Callable, Iterable, Optional, Sequence

from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.telemetry import (
    CONSENSUS_ENTROPY, CONSENSUS_MARGIN, CONSENSUS_ROUNDS_TO_DECISION,
    CONSENSUS_SIM_MARGIN, MEMBER_AGREEMENTS, MEMBER_DECIDES, MEMBER_DISSENTS,
    MEMBER_DRIFTING, MEMBER_DRIFT_EVENTS, MEMBER_FAILURES, MEMBER_LATENCY_MS,
    MEMBER_RECOVERIES,
)

# Failure attribution (ModelFailure.kind): the four causes the engine can
# distinguish. ``transport`` = the backend returned an error row (the
# member never answered); ``parse`` = the response was not a JSON action;
# ``schema`` = it parsed but failed parameter validation; ``deadline`` =
# the row expired at QoS admission (serving/admission.py).
FAILURE_KINDS = ("transport", "parse", "schema", "deadline")

# Drift-detection defaults: the baseline EWMA moves an order of magnitude
# slower than the recent estimate, so a genuine behavior change opens a
# gap between them instead of dragging both. min_samples gates the alarm
# until the estimates mean something; the trip clears at half the
# threshold (hysteresis, StallWatchdog-style trip-once semantics).
DEFAULT_BASELINE_ALPHA = 0.02
DEFAULT_RECENT_ALPHA = 0.25
DEFAULT_MIN_SAMPLES = 20
DEFAULT_DRIFT_THRESHOLD = 0.30
LATENCY_WINDOW = 256            # per-member rolling latency samples kept

_decide_ids = itertools.count(1)


def next_decide_id() -> str:
    """Allocate a decide id (``c<n:x>``). The engine draws it BEFORE the
    query rounds so the same id reaches the ChipLedger's row keys
    and the audit record — one id, both planes."""
    return f"c{next(_decide_ids):x}"


# ---------------------------------------------------------------------------
# Decision-quality math (pure; oracle-tested in tests/test_quality.py)
# ---------------------------------------------------------------------------


def vote_entropy(cluster_sizes: Sequence[int]) -> float:
    """Shannon entropy (bits) of the cluster-share distribution.

    0.0 = unanimous (one cluster), log2(k) = a k-way even split — the
    contestedness of a decide in one number, independent of which
    cluster won."""
    total = sum(cluster_sizes)
    if total <= 0:
        return 0.0
    h = 0.0
    for s in cluster_sizes:
        if s > 0:
            p = s / total
            h -= p * math.log2(p)
    return h


def winner_margin(cluster_sizes: Sequence[int]) -> float:
    """Winner share − runner-up share (runner-up 0 with a single
    cluster): 1.0 = unanimous, 0.0 = a tie the tiebreak had to break."""
    total = sum(cluster_sizes)
    if total <= 0:
        return 0.0
    ordered = sorted(cluster_sizes, reverse=True)
    runner_up = ordered[1] if len(ordered) > 1 else 0
    return (ordered[0] - runner_up) / total


def build_audit_record(*, task_id: Optional[str], agent_id: Optional[str],
                       pool: Sequence[str], outcome: Any,
                       clusters: Sequence[Any], winner_index: Optional[int],
                       sim_margins: Sequence[float],
                       failure_counts: dict[str, dict[str, int]],
                       corrected: Iterable[str],
                       decide_id: Optional[str] = None) -> dict:
    """The structured per-decide record (audit trail). Pure: reads
    the outcome the engine already computed; every field is
    JSON-serializable so the record rides the bus / the DB / the API
    unchanged."""
    sizes = [c.size for c in clusters]
    members: dict[str, dict] = {m: {} for m in pool}
    for idx, c in enumerate(clusters):
        for p in c.proposals:
            members.setdefault(p.model_spec, {}).update(
                action=p.action, cluster=idx,
                agreed=(winner_index is not None and idx == winner_index))
    for f in outcome.failures:          # final-round failures
        members.setdefault(f.model_spec, {}).setdefault("agreed", False)
        members[f.model_spec]["failure"] = {
            "kind": f.kind, "error": str(f.error)[:200]}
    for m, ms in outcome.member_latency_ms.items():
        members.setdefault(m, {})["latency_ms"] = round(ms, 2)
    for m, ms in getattr(outcome, "member_chip_ms", {}).items():
        members.setdefault(m, {})["chip_ms"] = round(ms, 3)

    corrected = sorted(set(corrected))
    proposed = {p.model_spec for p in outcome.proposals}
    decision = outcome.decision
    return {
        "event": "consensus_audit",
        "ts": time.time(),
        "decide_id": decide_id or next_decide_id(),
        "task_id": task_id,
        "agent_id": agent_id,
        "status": outcome.status,
        "rounds": outcome.rounds_used,
        "n_members": len(pool),
        "n_proposals": len(outcome.proposals),
        "decision": ({
            "action": decision.action, "kind": decision.kind,
            "confidence": decision.confidence,
            "cluster_size": decision.cluster_size,
            "total_responses": decision.total_responses,
        } if decision is not None else None),
        "entropy_bits": round(vote_entropy(sizes), 4) if sizes else None,
        "margin": round(winner_margin(sizes), 4) if sizes else None,
        "clusters": [{"action": c.action, "size": c.size,
                      "members": [p.model_spec for p in c.proposals]}
                     for c in clusters],
        "winner_cluster": winner_index,
        "members": members,
        "failure_counts": {m: dict(kinds)
                           for m, kinds in failure_counts.items()},
        "corrected": corrected,
        "recovered": sorted(set(corrected) & proposed),
        "sim_margins": [round(m, 4) for m in list(sim_margins)[:64]],
        "sim_margin_min": (round(min(sim_margins), 4)
                           if sim_margins else None),
        "n_sim_checks": len(sim_margins),
        "deadline_misses": outcome.deadline_misses,
        # speculative serving: per-decide speedup attribution —
        # how many of this decide's completion tokens came from accepted
        # draft proposals instead of vanilla decode steps
        "spec_rounds": getattr(outcome, "spec_rounds", 0),
        "spec_accepted_tokens": getattr(outcome, "spec_accepted_tokens",
                                        0),
        "latency_ms": round(outcome.latency_ms, 2),
        # chip economics: what this decide cost in measured
        # device time and decoded tokens — the adaptive-consensus
        # roadmap item reads its tokens-per-decide baseline from here
        "chip_ms": round(getattr(outcome, "chip_ms", 0.0), 3),
        "tokens_per_decide": getattr(outcome, "completion_tokens", 0),
    }


# ---------------------------------------------------------------------------
# Per-member rolling scorecards + drift detection
# ---------------------------------------------------------------------------


class _Ewma:
    """Baseline/recent EWMA pair over a 0/1 indicator with trip-once drift
    semantics. The baseline FREEZES while tripped — a degradation must not
    slowly become the new normal and silence its own alarm."""

    __slots__ = ("baseline", "recent", "samples", "tripped")

    def __init__(self) -> None:
        self.baseline: Optional[float] = None
        self.recent: Optional[float] = None
        self.samples = 0
        self.tripped = False

    def update(self, x: float, baseline_alpha: float, recent_alpha: float,
               min_samples: int, threshold: float) -> Optional[str]:
        """Returns "trip" / "clear" on a state change, else None."""
        self.samples += 1
        if self.baseline is None or self.recent is None:
            self.baseline = self.recent = x
            return None
        self.recent += recent_alpha * (x - self.recent)
        if not self.tripped:
            self.baseline += baseline_alpha * (x - self.baseline)
        deviation = self.recent - self.baseline
        if (not self.tripped and self.samples >= min_samples
                and deviation > threshold):
            self.tripped = True
            return "trip"
        if self.tripped and deviation < threshold / 2:
            self.tripped = False
            return "clear"
        return None

    def snapshot(self) -> dict:
        return {"baseline": (round(self.baseline, 4)
                             if self.baseline is not None else None),
                "recent": (round(self.recent, 4)
                           if self.recent is not None else None),
                "samples": self.samples,
                "tripped": self.tripped}


class _MemberStats:
    __slots__ = ("decides", "proposals", "agreements", "dissents",
                 "failed_decides", "failures", "corrections", "recoveries",
                 "deadline_misses", "latency", "drift", "chip_ms")

    def __init__(self) -> None:
        self.chip_ms = 0.0          # measured device wall
        self.decides = 0
        self.proposals = 0          # decides where the member's row was valid
        self.agreements = 0
        self.dissents = 0
        self.failed_decides = 0     # decides with >= 1 failure of any kind
        self.failures: dict[str, int] = {}
        self.corrections = 0        # decides where a correction was issued
        self.recoveries = 0         # ...and the member recovered to a proposal
        self.deadline_misses = 0
        self.latency: deque = deque(maxlen=LATENCY_WINDOW)
        self.drift = {"dissent": _Ewma(), "failure": _Ewma()}

    def _latency_q(self, p: float) -> Optional[float]:
        if not self.latency:
            return None
        vals = sorted(self.latency)
        return round(vals[min(len(vals) - 1, int(p * len(vals)))], 2)

    def snapshot(self) -> dict:
        voted = self.agreements + self.dissents
        return {
            "decides": self.decides,
            "proposals": self.proposals,
            "agreements": self.agreements,
            "dissents": self.dissents,
            "agreement_rate": (round(self.agreements / voted, 4)
                               if voted else None),
            "dissent_rate": (round(self.dissents / voted, 4)
                             if voted else None),
            "failed_decides": self.failed_decides,
            "failure_rate": (round(self.failed_decides / self.decides, 4)
                             if self.decides else None),
            "failures": dict(self.failures),
            "corrections": self.corrections,
            "recoveries": self.recoveries,
            "recovery_rate": (round(self.recoveries / self.corrections, 4)
                              if self.corrections else None),
            "deadline_misses": self.deadline_misses,
            "latency_p50_ms": self._latency_q(0.50),
            "latency_p95_ms": self._latency_q(0.95),
            # chip economics: measured device time this
            # member consumed across its decides
            "chip_ms_total": round(self.chip_ms, 3),
            "chip_ms_per_decide": (round(self.chip_ms / self.decides, 3)
                                   if self.decides else None),
            "drift": {sig: e.snapshot() for sig, e in self.drift.items()},
            "drifting": sorted(sig for sig, e in self.drift.items()
                               if e.tripped),
        }


class ConsensusQuality:
    """Rolling consensus-quality state: scorecards + drift + sink fan-out.

    ``observe_decide`` is the single entry point — the engine calls it
    (when ``ConsensusConfig.quality`` is on) with the audit record built
    by :func:`build_audit_record`. Sinks receive every audit record AND
    every drift event; sink exceptions are swallowed (telemetry must
    never take the serving path down — same contract as Tracer sinks)."""

    def __init__(self, flight: Any = None,
                 baseline_alpha: float = DEFAULT_BASELINE_ALPHA,
                 recent_alpha: float = DEFAULT_RECENT_ALPHA,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 drift_threshold: float = DEFAULT_DRIFT_THRESHOLD):
        self._flight = flight
        self.baseline_alpha = baseline_alpha
        self.recent_alpha = recent_alpha
        self.min_samples = min_samples
        self.drift_threshold = drift_threshold
        self._lock = named_lock("quality")
        self._members: dict[str, _MemberStats] = {}
        self._decides = 0
        self._sinks: list[Callable[[dict], None]] = []
        self._sink_lock = named_lock("quality.sinks")

    # -- sinks (Tracer-shaped) -------------------------------------------

    def add_sink(self, fn: Callable[[dict], None]) -> None:
        with self._sink_lock:
            if fn not in self._sinks:
                self._sinks.append(fn)

    def remove_sink(self, fn: Callable[[dict], None]) -> None:
        with self._sink_lock:
            if fn in self._sinks:
                self._sinks.remove(fn)

    def _emit(self, event: dict) -> None:
        with self._sink_lock:
            sinks = list(self._sinks)
        for fn in sinks:
            try:
                fn(event)
            except Exception:             # noqa: BLE001 — telemetry only
                pass

    def _flight_record(self, kind: str, **fields: Any) -> None:
        flight = self._flight
        if flight is None:
            from quoracle_tpu_torch.infra.flightrec import FLIGHT
            flight = FLIGHT
        try:
            flight.record(kind, **fields)
        except Exception:                 # noqa: BLE001 — telemetry only
            pass

    # -- the observation path --------------------------------------------

    def observe_decide(self, record: dict) -> None:
        """Fold one audit record into scorecards + metrics + drift, then
        fan it out to the sinks. Tolerant of sparse records (tests feed
        synthetic ones); never raises into the engine."""
        drift_events: list[dict] = []
        with self._lock:
            self._decides += 1
            members = record.get("members") or {}
            failure_counts = record.get("failure_counts") or {}
            corrected = set(record.get("corrected") or ())
            recovered = set(record.get("recovered") or ())
            for model, m in members.items():
                st = self._members.setdefault(model, _MemberStats())
                st.decides += 1
                MEMBER_DECIDES.inc(model=model)
                cluster = m.get("cluster")
                agreed = bool(m.get("agreed"))
                if cluster is not None:
                    st.proposals += 1
                    if agreed:
                        st.agreements += 1
                        MEMBER_AGREEMENTS.inc(model=model)
                    else:
                        st.dissents += 1
                        MEMBER_DISSENTS.inc(model=model)
                kinds = failure_counts.get(model) or {}
                if kinds:
                    st.failed_decides += 1
                for kind, n in kinds.items():
                    st.failures[kind] = st.failures.get(kind, 0) + n
                    MEMBER_FAILURES.inc(n, model=model, kind=kind)
                    if kind == "deadline":
                        st.deadline_misses += n
                if model in corrected:
                    st.corrections += 1
                    if model in recovered:
                        st.recoveries += 1
                        MEMBER_RECOVERIES.inc(model=model)
                latency = m.get("latency_ms")
                if isinstance(latency, (int, float)) and latency > 0:
                    st.latency.append(float(latency))
                    MEMBER_LATENCY_MS.observe(float(latency), model=model)
                chip = m.get("chip_ms")
                if isinstance(chip, (int, float)) and chip > 0:
                    st.chip_ms += float(chip)
                drift_events += self._update_drift(
                    model, st,
                    dissent=1.0 if (cluster is not None and not agreed)
                    else 0.0,
                    failure=1.0 if kinds else 0.0)

        entropy = record.get("entropy_bits")
        if isinstance(entropy, (int, float)):
            CONSENSUS_ENTROPY.observe(float(entropy))
        margin = record.get("margin")
        if isinstance(margin, (int, float)):
            CONSENSUS_MARGIN.observe(float(margin))
        rounds = record.get("rounds")
        if isinstance(rounds, int) and rounds > 0:
            CONSENSUS_ROUNDS_TO_DECISION.observe(rounds)
        for sm in record.get("sim_margins") or ():
            if isinstance(sm, (int, float)):
                CONSENSUS_SIM_MARGIN.observe(
                    abs(float(sm)), side="above" if sm >= 0 else "below")

        for event in drift_events:       # outside the lock: sinks + flight
            if event["event"] == "model_health_drift":
                self._flight_record("model_health_drift",
                                    **{k: v for k, v in event.items()
                                       if k not in ("event", "ts")})
            self._emit(event)
        self._emit(record)

    def _update_drift(self, model: str, st: _MemberStats,
                      **signals: float) -> list[dict]:
        """Runs under self._lock; returns state-change events to emit."""
        events = []
        for signal, x in signals.items():
            e = st.drift[signal]
            change = e.update(x, self.baseline_alpha, self.recent_alpha,
                              self.min_samples, self.drift_threshold)
            if change is None:
                continue
            MEMBER_DRIFTING.set(1.0 if change == "trip" else 0.0,
                                model=model, signal=signal)
            if change == "trip":
                MEMBER_DRIFT_EVENTS.inc(model=model, signal=signal)
            events.append({
                "event": ("model_health_drift" if change == "trip"
                          else "model_health_recovered"),
                "ts": time.time(),
                "model": model,
                "signal": signal,
                "baseline": round(e.baseline, 4),
                "recent": round(e.recent, 4),
                "threshold": self.drift_threshold,
                "samples": e.samples,
            })
        return events

    # -- reads -----------------------------------------------------------

    def scorecards(self) -> dict:
        """The ``GET /api/models`` payload: every member's rolling
        scorecard + drift state."""
        with self._lock:
            return {
                "n_decides": self._decides,
                "members": {m: st.snapshot()
                            for m, st in sorted(self._members.items())},
                "drifting": sorted(
                    m for m, st in self._members.items()
                    if any(e.tripped for e in st.drift.values())),
            }

    def reset(self) -> None:
        """Drop all rolling state (tests). Sinks survive."""
        with self._lock:
            self._members.clear()
            self._decides = 0


# Process-wide instance (the METRICS/TRACER/FLIGHT pattern): records carry
# task/agent attribution, so cross-Runtime isolation comes from filtering.
QUALITY = ConsensusQuality()

