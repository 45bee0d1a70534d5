"""Workload-level invariant gate (port of ``quoracle_tpu/sim/gate.py``).

The chaos catalog (chaos/invariants.py) proves the stack recovers from
injected faults; this module proves the stack would SERVE THE WORKLOAD
— the same ``InvariantResult`` currency, evaluated over a full replay
ledger instead of a storm window:

* ``slo_attainment``        — per priority class, the fraction of
  events served with modeled TTFT inside the class budget meets the
  attainment floor (a shed or deadline miss counts against the class);
* ``goodput_floor``         — delivered tokens per VIRTUAL second over
  the whole trace stay above the scenario floor;
* ``no_silent_loss_ledger`` — ledger rows and trace events match 1:1
  by event id, and every non-ok row carries a structured reason from
  the SAME closed prefix set the chaos plane enforces;
* ``tier_conservation``     — every virtual session the ladder ever
  saw is accounted resident/host/disk/prefixd/dropped (the
  hibernation-tier conservation law);
* ``ledger_deterministic``  — two replays of one trace serialize to
  byte-identical ledgers;
* ``sim_tree_conservation`` — agent-tree lineage ids in the ledger
  reconcile EXACTLY with the generated trace: per-tree row
  counts equal per-tree trace event counts, per-tree delivered-token
  sums equal the trace-side recomputation, and no row carries a tree
  id its trace event disagrees with;
* ``temp0_spot_equal``      — when a real plane rides along, the
  sampled temperature-0 texts from both replays are identical and
  every sampled failure is structured.

``SIM_SCENARIOS`` pins four canonical traces (diurnal mix, burst
storm, agent tree, long-tail ladder) to sized capacity models and
floors; ``run_sim_scenario`` replays one twice and evaluates the whole
catalog — the tier-1 acceptance gate every later serving-policy change
replays against (tests/test_torch_sim.py holds the port's verdicts and
ledger digests to the JAX package's).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

from quoracle_tpu_torch.chaos.invariants import (
    STRUCTURED_ERROR_PREFIXES, InvariantResult, conservation,
)
from quoracle_tpu_torch.sim.replay import (
    SIM, TIERS, CapacityModel, ReplayDriver, ReplayLedger,
)
from quoracle_tpu_torch.sim.workload import (
    Trace, canonical_spec, generate, tree_id_of,
)

logger = logging.getLogger(__name__)

MEMBER = "xla:tiny"

# ok-row reasons that are annotations, not failures
_OK_REASONS = ("", "cold_reprefill")


# -- the workload invariant catalog --------------------------------------

def slo_attainment(ledger: ReplayLedger, targets) -> list:
    """Per class: fraction of events with outcome ok AND modeled TTFT
    within the class budget; sheds and deadline misses count against
    the class (they ARE the SLO miss)."""
    out = []
    for cls, budget_ms, floor in targets:
        rows = [r for r in ledger.rows if r[2] == cls]
        if not rows:
            out.append(InvariantResult(
                f"sim_slo_{cls}", True, "no events of class"))
            continue
        hit = sum(1 for r in rows
                  if r[3] == "ok" and r[5] <= budget_ms * 1000)
        frac = hit / len(rows)
        out.append(InvariantResult(
            f"sim_slo_{cls}", frac >= floor,
            f"attained {hit}/{len(rows)} = {frac:.3f} "
            f"(budget {budget_ms}ms, floor {floor})"))
    return out


def goodput_floor(ledger: ReplayLedger, horizon_ms: int,
                  floor_tok_s: float) -> InvariantResult:
    tokens = sum(r[8] for r in ledger.rows)
    goodput = 1000.0 * tokens / max(1, horizon_ms)
    return InvariantResult(
        "sim_goodput_floor", goodput >= floor_tok_s,
        f"{goodput:.2f} tok/s virtual (floor {floor_tok_s})")


def no_silent_loss_ledger(trace: Trace,
                          ledger: ReplayLedger) -> InvariantResult:
    """Full-ledger accounting: one row per trace event, matched by id,
    and every non-ok row structured with a recognized prefix."""
    want = [e.eid for e in trace.events]
    got = [r[0] for r in ledger.rows]
    if want != got:
        return InvariantResult(
            "sim_no_silent_loss", False,
            f"event/row mismatch: {len(want)} events, {len(got)} rows")
    bad = 0
    detail = ""
    for r in ledger.rows:
        outcome, reason = r[3], r[4]
        if outcome == "ok":
            if reason not in _OK_REASONS:
                bad += 1
                detail = detail or f"ok row {r[0]} reason {reason!r}"
        elif outcome in ("shed", "deadline"):
            if not reason.startswith(STRUCTURED_ERROR_PREFIXES):
                bad += 1
                detail = detail or (f"{outcome} row {r[0]} "
                                    f"unstructured {reason!r}")
        else:
            bad += 1
            detail = detail or f"row {r[0]} unknown outcome {outcome!r}"
    return InvariantResult(
        "sim_no_silent_loss", bad == 0,
        detail or f"{len(got)} rows, all accounted and structured")


def tier_conservation(ladder) -> InvariantResult:
    census = ladder.census()
    return conservation(
        "sim_tier_conservation", census["seen"],
        {t: census[t] for t in (*TIERS, "dropped")})


def ledger_deterministic(a: ReplayLedger,
                         b: ReplayLedger) -> InvariantResult:
    ja, jb = a.to_json(), b.to_json()
    return InvariantResult(
        "sim_ledger_deterministic", ja == jb,
        f"digests {a.digest()} vs {b.digest()}, "
        f"{len(a)} vs {len(b)} rows"
        + ("" if ja == jb else " — NOT byte-identical"))


def sim_tree_conservation(trace: Trace,
                          ledger: ReplayLedger) -> InvariantResult:
    """Agent-tree lineage accounting: every ledger row's
    tree id matches the trace event it came from, per-tree node (row)
    counts equal per-tree trace event counts, and per-tree delivered
    tokens equal the trace-side recomputation (``max_new_tokens *
    max(1, consensus_k)`` on ok rows, 0 on shed/deadline). EXACT
    integer equality — never approximate; scenarios without tree
    streams pass vacuously."""
    by_eid = {e.eid: e for e in trace.events}
    want_count: dict = {}
    for e in trace.events:
        tid = tree_id_of(e)
        if tid:
            want_count[tid] = want_count.get(tid, 0) + 1
    got_count: dict = {}
    got_tokens: dict = {}
    want_tokens: dict = {}
    for r in ledger.rows:
        tid = r[9] if len(r) > 9 else ""
        e = by_eid.get(r[0])
        expect = tree_id_of(e) if e is not None else ""
        if tid != expect:
            return InvariantResult(
                "sim_tree_conservation", False,
                f"row {r[0]} tree id {tid!r} != trace {expect!r}")
        if not tid:
            continue
        got_count[tid] = got_count.get(tid, 0) + 1
        got_tokens[tid] = got_tokens.get(tid, 0) + r[8]
        want_tokens[tid] = want_tokens.get(tid, 0) + (
            e.max_new_tokens * max(1, e.consensus_k)
            if r[3] == "ok" else 0)
    if not want_count:
        return InvariantResult(
            "sim_tree_conservation", True, "no agent-tree events")
    if got_count != want_count:
        bad = sorted(set(want_count) ^ set(got_count)
                     | {t for t in want_count
                        if got_count.get(t) != want_count[t]})
        return InvariantResult(
            "sim_tree_conservation", False,
            f"node-count mismatch on trees {bad[:4]}")
    if got_tokens != want_tokens:
        bad = sorted(t for t in want_tokens
                     if got_tokens.get(t) != want_tokens[t])
        return InvariantResult(
            "sim_tree_conservation", False,
            f"token-sum mismatch on trees {bad[:4]}")
    return InvariantResult(
        "sim_tree_conservation", True,
        f"{len(want_count)} trees, {sum(want_count.values())} nodes, "
        f"{sum(got_tokens.values())} tokens reconciled exactly")


def temp0_spot_equal(samples_a: list, samples_b: list) -> InvariantResult:
    """Engine-backed spot check: both replays sampled the same events
    at temperature 0 and got bit-identical texts; any sampled failure
    is structured."""
    if not samples_a and not samples_b:
        return InvariantResult(
            "sim_temp0_spot_equal", True, "model-only replay, 0 samples")
    if samples_a != samples_b:
        return InvariantResult(
            "sim_temp0_spot_equal", False,
            f"sample divergence across replays "
            f"({len(samples_a)} vs {len(samples_b)})")
    for eid, ok, text in samples_a:
        if not ok and not text.startswith(STRUCTURED_ERROR_PREFIXES):
            return InvariantResult(
                "sim_temp0_spot_equal", False,
                f"sample {eid} unstructured failure {text[:80]!r}")
    return InvariantResult(
        "sim_temp0_spot_equal", True,
        f"{len(samples_a)} samples bit-identical across replays")


# -- scenario catalog ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimScenario:
    """One canonical trace pinned to a sized capacity model and
    floors. ``scale`` multiplies population sizes (tests keep the
    100k long tail at full size; bench smoke may shrink it)."""

    name: str
    description: str
    capacity: CapacityModel
    goodput_floor_tok_s: float
    # ((class, ttft budget ms, attainment floor), ...)
    slo: tuple
    engine_sampled: bool = False
    scale: float = 1.0


SIM_SCENARIOS = {
    "diurnal_mix": SimScenario(
        name="diurnal_mix",
        description=("multi-tenant diurnal curves, engine-sampled "
                     "spot checks"),
        capacity=CapacityModel(),
        goodput_floor_tok_s=0.5,
        slo=(("interactive", 1_500, 0.95), ("agent", 6_000, 0.90)),
        engine_sampled=True,
    ),
    "storm": SimScenario(
        name="storm",
        description=("burst storm over a deliberately small fleet: "
                     "the shed ladder must fire, batch first, while "
                     "the reserved pool protects interactive"),
        capacity=CapacityModel(
            decode_slots=2, reserved_interactive=1,
            prefill_tok_s=20_000.0, decode_tok_s=60.0),
        goodput_floor_tok_s=1.0,
        slo=(("interactive", 1_500, 0.70),),
    ),
    "agent_tree": SimScenario(
        name="agent_tree",
        description=("recursive spawn fan-outs with per-depth "
                     "consensus K, engine-sampled"),
        capacity=CapacityModel(),
        goodput_floor_tok_s=0.5,
        slo=(("agent", 6_000, 0.90),),
        engine_sampled=True,
    ),
    "longtail_ladder": SimScenario(
        name="longtail_ladder",
        description=("O(100k) mostly-hibernated sessions reactivating "
                     "through the full tier ladder at compressed time"),
        capacity=CapacityModel(),
        goodput_floor_tok_s=1.0,
        slo=(("interactive", 1_500, 0.90),),
    ),
}


@dataclasses.dataclass
class SimReport:
    name: str
    seed: int
    passed: bool
    invariants: list
    evidence: dict
    wall_s: float

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "passed": self.passed,
            "invariants": [r.as_dict() for r in self.invariants],
            "evidence": self.evidence,
            "wall_s": round(self.wall_s, 2),
        }


def run_sim_scenario(name: str, seed: int = 0, plane=None,
                     scale: Optional[float] = None, *,
                     member: Optional[str] = None, device=None,
                     engine_factory=None) -> SimReport:
    """Generate the canonical trace, replay it TWICE at compressed
    time, and evaluate the full workload-invariant catalog. For
    engine-sampled scenarios a one-replica ClusterPlane over ``member``
    (default :data:`MEMBER`) is built on ``device`` (None: the GPU;
    through ``engine_factory`` when given), or pass ``plane`` (serving
    ``member``) to reuse one; model-only scenarios never touch a
    device. ``scale`` overrides the scenario's population scale (bench
    smoke shrinks the long tail). Both replays must agree
    byte-for-byte."""
    from quoracle_tpu_torch.infra.flightrec import FLIGHT
    from quoracle_tpu_torch.infra.telemetry import SIM_GATE_FAILURES

    sc = SIM_SCENARIOS[name]
    t0 = time.monotonic()
    spec = canonical_spec(
        name, seed=seed, scale=sc.scale if scale is None else scale)
    trace = generate(spec)
    SIM.note_trace(trace.stats())
    member = member or MEMBER
    own_plane = None
    if sc.engine_sampled and plane is None:
        from quoracle_tpu_torch.serving.cluster import ClusterPlane
        own_plane = plane = ClusterPlane.build(
            [member], replicas=1, disaggregate=False, device=device,
            engine_factory=engine_factory)
    try:
        sample_every = (max(1, len(trace) // 8)
                        if sc.engine_sampled else 0)
        drivers = []
        ledgers = []
        for _ in range(2):
            d = ReplayDriver(trace, capacity=sc.capacity, plane=plane,
                             member=member, sample_every=sample_every)
            ledgers.append(d.run())
            drivers.append(d)
        results = [ledger_deterministic(*ledgers),
                   no_silent_loss_ledger(trace, ledgers[0])]
        results.extend(slo_attainment(ledgers[0], sc.slo))
        results.append(goodput_floor(ledgers[0], spec.horizon_ms,
                                     sc.goodput_floor_tok_s))
        results.append(tier_conservation(drivers[0].ladder))
        results.append(sim_tree_conservation(trace, ledgers[0]))
        results.append(temp0_spot_equal(drivers[0].samples,
                                        drivers[1].samples))
    finally:
        if own_plane is not None:
            own_plane.close()
    passed = all(r.ok for r in results)
    if not passed:
        SIM_GATE_FAILURES.inc(scenario=name)
    report = SimReport(
        name=name, seed=seed, passed=passed, invariants=results,
        evidence={"trace": trace.stats(),
                  "ledger": ledgers[0].digest(),
                  "outcomes": ledgers[0].counts(),
                  "census": drivers[0].ladder.census(),
                  "samples": len(drivers[0].samples)},
        wall_s=time.monotonic() - t0)
    FLIGHT.record("sim_gate", name=name, seed=seed, passed=passed,
                  invariants=len(results))
    SIM.note_report(report.as_dict())
    return report
