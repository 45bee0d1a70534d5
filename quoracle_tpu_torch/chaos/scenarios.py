"""Composable chaos scenarios of the PyTorch port (port of
``quoracle_tpu/chaos/scenarios.py``).

Each scenario scripts one hostile condition over the real serving stack
(ClusterPlane + router + QoS + tiered KV + continuous batching, the
production objects), declares the invariant set it must satisfy
(chaos/invariants.py), and runs in two phases:

  1. **clean**: the traffic with nothing armed, the fault-free baseline
     every survivor is compared against;
  2. **storm**: a seeded :class:`FaultPlan` armed on :data:`CHAOS` while
     the identical traffic replays.

``run_scenario(name, seed)`` returns a :class:`ScenarioReport` with
per-invariant verdicts, the fired fault schedule, and scenario-specific
evidence. Scenarios marked ``deterministic_rerun`` run the storm twice
and assert that the second plan (same seed, fresh counters) fires the
identical schedule.

The backends a scenario builds serve ``xla:tiny`` on ``device`` (None:
the GPU; ``"cpu"`` only when asked);
``engine_factory(spec, quantize_weights=, quantize_kv=)`` hands them
prebuilt engines (shared weights) instead of seeded random ones. A
caller that passes ``context`` owns the backends (``{"cluster": plane,
"backends": [plane]}``, with ``member`` naming the pool member they
serve), and the scenario builds nothing.
The registry:

  traffic_storm       multi-tenant storm + admission/router signal loss
  kill_mid_handoff    decode-replica death mid-row + export failure
  restart_warm_start  process restart over a corrupted disk prefix store
  drift_storm         member garbage/crash feeding drift detection
  hbm_pressure_churn  forced demote churn + restore failures + a
                      compile-key poisoning storm
  scale_storm         the elastic fleet scales, re-tiers, and drains
                      mid-traffic while a replica is killed during its
                      own drain and a migration degrades

The JAX registry's ``fabric_partition`` (peer links flapping over the
cross-host fabric) waits for the fabric, ROADMAP Queue 1 item 14:
``run_scenario`` names it and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging
import shutil
import tempfile
import time
from typing import Callable, Optional

from quoracle_tpu_torch.chaos import invariants as inv
from quoracle_tpu_torch.chaos.faults import CHAOS, FaultPlan, FaultRule
from quoracle_tpu_torch.infra.flightrec import FLIGHT

logger = logging.getLogger(__name__)

MEMBER = "xla:tiny"


@dataclasses.dataclass
class ScenarioReport:
    name: str
    seed: int
    passed: bool
    invariants: list
    schedule: list
    evidence: dict
    wall_s: float

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "passed": self.passed,
            "invariants": [r.as_dict() for r in self.invariants],
            "faults_fired": len(self.schedule),
            "schedule": [list(t) for t in self.schedule[:64]],
            "evidence": self.evidence,
            "wall_s": round(self.wall_s, 2),
        }


class Scenario:
    """Base: subclasses fill in build/rules/traffic/check."""

    name = "base"
    description = ""
    deterministic_rerun = False

    def build(self, ctx: dict) -> None:
        raise NotImplementedError

    def rules(self, ctx: dict) -> list:
        raise NotImplementedError

    def traffic(self, ctx: dict, phase: str) -> dict:
        """Drive one full pass; returns at least ``{"submitted": int,
        "results": [...]}`` plus scenario-specific keys. ``phase`` is
        "clean" / "storm" / "rerun" so session ids never collide across
        phases (a cross-phase splice would corrupt the baseline)."""
        raise NotImplementedError

    def check(self, ctx: dict, clean: dict, storm: dict,
              plan, flight_slice: list) -> list:
        raise NotImplementedError

    def close(self, ctx: dict) -> None:
        for b in ctx.get("backends", ()):
            try:
                b.close()
            except Exception:             # noqa: BLE001 — best-effort
                logger.exception("%s: backend close failed", self.name)


def _flight_for_plan(plan) -> list:
    """This plan's chaos_fault events out of the process-wide ring."""
    nonce = getattr(plan, "nonce", None)
    return [e for e in FLIGHT.snapshot()
            if e.get("kind") == "chaos_fault" and e.get("plan") == nonce]


def run_scenario(name: str, seed: int = 0,
                 context: Optional[dict] = None, *, device=None,
                 engine_factory: Optional[Callable] = None
                 ) -> ScenarioReport:
    """Build → clean pass → armed storm pass → invariants. With
    ``context`` the caller owns backend lifecycle (and names their pool
    ``member`` there, default ``MEMBER``); else the scenario builds its
    backends over ``MEMBER`` on ``device`` (through ``engine_factory``
    when given) and closes them."""
    from quoracle_tpu_torch.infra import locks as lockdep
    from quoracle_tpu_torch.infra.telemetry import (
        CHAOS_INVARIANT_FAILURES, CHAOS_SCENARIOS_TOTAL,
    )

    if name in NOT_PORTED:
        raise NotImplementedError(
            f"chaos scenario {name!r} is not ported yet: {NOT_PORTED[name]}")
    sc = SCENARIOS[name]()
    ctx: dict = dict(context or {})
    ctx.setdefault("device", device)
    ctx.setdefault("member", MEMBER)
    ctx.setdefault("engine_factory", engine_factory)
    owns = context is None
    ctx.setdefault("tmpdir", tempfile.mkdtemp(prefix=f"chaos-{name}-"))
    t0 = time.monotonic()
    try:
        if owns:
            sc.build(ctx)
        FLIGHT.record("chaos_scenario_start", scenario=name, seed=seed,
                      phase="clean")
        clean = sc.traffic(ctx, "clean")
        # the storm must not inherit blame for earlier inversions
        lockdep.LOCKDEP.drain()
        plan = FaultPlan(seed, sc.rules(ctx))
        FLIGHT.record("chaos_scenario_start", scenario=name, seed=seed,
                      phase="storm")
        with CHAOS.arming(plan):
            storm = sc.traffic(ctx, "storm")
        flight_slice = _flight_for_plan(plan)
        results = list(sc.check(ctx, clean, storm, plan, flight_slice))
        if sc.deterministic_rerun:
            plan2 = FaultPlan(seed, sc.rules(ctx))
            with CHAOS.arming(plan2):
                sc.traffic(ctx, "rerun")
            results.append(inv.fault_schedule(
                plan2, _flight_for_plan(plan2),
                expected=plan.schedule()))
        passed = all(r.ok for r in results)
        report = ScenarioReport(
            name=name, seed=seed, passed=passed, invariants=results,
            schedule=plan.schedule(), evidence=storm.get("evidence", {}),
            wall_s=time.monotonic() - t0)
        CHAOS_SCENARIOS_TOTAL.inc(scenario=name,
                                  result="pass" if passed else "fail")
        for r in results:
            if not r.ok:
                CHAOS_INVARIANT_FAILURES.inc(scenario=name,
                                             invariant=r.name)
                # correlated incident capture: a failed
                # recovery invariant is a bug report — bundle every
                # reachable flight ring under one deterministic id
                from quoracle_tpu_torch.infra.fleetobs import INCIDENTS
                INCIDENTS.capture("chaos_invariant",
                                  f"{name}:{r.name}",
                                  reason=r.detail[:200])
        FLIGHT.record("chaos_scenario_end", scenario=name, seed=seed,
                      passed=passed,
                      failed=[r.name for r in results if not r.ok],
                      faults=len(plan.fired))
        CHAOS.note_report(report.as_dict())
        return report
    finally:
        if owns:
            sc.close(ctx)
        shutil.rmtree(ctx.get("tmpdir", ""), ignore_errors=True)


# ---------------------------------------------------------------------------
# Shared request plumbing
# ---------------------------------------------------------------------------


def _req(ctx, msgs, sid=None, cj=False, max_tokens=16, priority=None,
         tenant="default"):
    from quoracle_tpu_torch.models.runtime import QueryRequest
    return QueryRequest(ctx["member"], msgs, temperature=0.0,
                        max_tokens=max_tokens, session_id=sid,
                        constrain_json=cj, priority=priority,
                        tenant=tenant)


def _msgs(text: str) -> list:
    return [{"role": "user", "content": text}]


def _where(ctx) -> dict:
    """Where a scenario's cluster serves: its device and engine factory."""
    return {"device": ctx.get("device"),
            "engine_factory": ctx.get("engine_factory")}


def _backend_where(ctx, quantize_kv: bool = False) -> dict:
    """The same for a single ``TorchBackend``: its device and, from the
    factory, its member's engine."""
    factory = ctx.get("engine_factory")
    engines = None
    if factory is not None:
        engines = {ctx["member"]: factory(ctx["member"],
                                          quantize_weights=False,
                                          quantize_kv=quantize_kv)}
    return {"device": ctx.get("device"), "engines": engines}


# ---------------------------------------------------------------------------
# 1. Multi-tenant traffic storm
# ---------------------------------------------------------------------------


class TrafficStorm(Scenario):
    """Mixed-class multi-tenant traffic through a 2-replica
    prefill/decode cluster with QoS on, while the admission controller's
    signal refresh drops/delays and the router loses replica snapshots.
    A rate-capped "burst" tenant floods bulk rows that must shed
    STRUCTURED (429-shaped), never silently; interactive rows must
    survive bit-equal to the fault-free run."""

    name = "traffic_storm"
    description = ("multi-tenant storm + admission/router signal "
                   "loss over the disaggregated cluster")
    deterministic_rerun = True

    N_EQ = 4
    N_BURST = 4

    def build(self, ctx: dict) -> None:
        from quoracle_tpu_torch.serving.cluster import ClusterPlane
        from quoracle_tpu_torch.serving.qos import Priority, TenantPolicy
        # replicas=3 → 1 prefill + 2 decode: the router has a real
        # placement choice, so the router.signals drop path is live
        cl = ClusterPlane.build([ctx["member"]], replicas=3,
                                disaggregate=True, continuous=True,
                                continuous_chunk=8, qos=True,
                                **_where(ctx))
        for rep in cl.replicas:
            ctrl = getattr(rep.backend, "qos_controller", None)
            if ctrl is not None:
                ctrl.set_tenant(TenantPolicy(
                    name="burst", rate_per_s=0.001, burst=1.0,
                    max_class=Priority.BACKGROUND))
        ctx["cluster"] = cl
        ctx["backends"] = [cl]

    def rules(self, ctx: dict) -> list:
        return [
            FaultRule("admission.signals", "drop", prob=0.5),
            FaultRule("admission.signals", "delay", prob=0.4,
                      delay_ms=15),
            FaultRule("router.signals", "drop", prob=0.5),
        ]

    def traffic(self, ctx: dict, phase: str) -> dict:
        from quoracle_tpu_torch.serving.qos import Priority
        cl = ctx["cluster"]
        eq_reqs = []
        for i in range(self.N_EQ):
            eq_reqs.append(_req(
                ctx, _msgs(f"interactive row {i}: summarize the storm"),
                cj=(i % 2 == 1), priority=Priority.INTERACTIVE,
                tenant=f"tenant-{i % 2}"))
        burst_reqs = [
            _req(ctx, _msgs(f"burst row {j}: bulk backfill"),
                 priority=Priority.BACKGROUND, tenant="burst")
            for j in range(self.N_BURST)]
        eq = cl.query(eq_reqs)
        burst = cl.query(burst_reqs)
        return {
            "submitted": len(eq_reqs) + len(burst_reqs),
            "results": eq + burst,
            "eq": eq,
        }

    def check(self, ctx, clean, storm, plan, flight_slice) -> list:
        cl = ctx["cluster"]
        return [
            inv.no_silent_loss(storm["submitted"], storm["results"],
                               backends=[cl]),
            inv.structured_failures(storm["results"]),
            inv.temp0_equality(clean["eq"], storm["eq"]),
            inv.slo_burn_bounded(storm["results"], backends=[cl]),
            inv.lockdep_clean(),
            inv.fault_schedule(plan, flight_slice),
        ]


# ---------------------------------------------------------------------------
# 2. Kill mid-handoff
# ---------------------------------------------------------------------------


class KillMidHandoff(Scenario):
    """A 3-replica cluster (1 prefill, 2 decode): the first row's
    decode replica dies AFTER its KV handoff landed — the retained
    envelope must re-place it onto the survivor bit-identically
    (kv_handoff_replace); a later export failure must degrade to a cold
    re-prefill. Every row survives; nothing is silently lost."""

    name = "kill_mid_handoff"
    description = ("decode-replica death mid-row (envelope re-place) "
                   "+ handoff export failure (cold degrade)")

    def build(self, ctx: dict) -> None:
        from quoracle_tpu_torch.serving.cluster import ClusterPlane
        cl = ClusterPlane.build([ctx["member"]], replicas=3,
                                disaggregate=True, continuous=True,
                                continuous_chunk=8, **_where(ctx))
        ctx["cluster"] = cl
        ctx["backends"] = [cl]

    def rules(self, ctx: dict) -> list:
        return [
            FaultRule("cluster.decode", "crash", max_fires=1),
            FaultRule("handoff.export", "fail", start=2, max_fires=1),
        ]

    def traffic(self, ctx: dict, phase: str) -> dict:
        cl = ctx["cluster"]
        results = []
        for i in range(4):
            results += cl.query([_req(
                ctx, _msgs(f"handoff row {i}: explain replica failover"),
                cj=(i == 3), max_tokens=12)])
        return {"submitted": 4, "results": results, "eq": results}

    def check(self, ctx, clean, storm, plan, flight_slice) -> list:
        cl = ctx["cluster"]
        ho = cl.handoff.stats()
        dead = [r.replica_id for r in cl.replicas if not r.alive]
        out = [
            inv.no_silent_loss(storm["submitted"], storm["results"],
                               backends=[cl]),
            inv.structured_failures(storm["results"]),
            inv.temp0_equality(clean["eq"], storm["eq"]),
            inv.lockdep_clean(),
            inv.fault_schedule(plan, flight_slice),
            inv.InvariantResult(
                "recovery_engaged",
                ho["replaced"] >= 1 and len(dead) == 1,
                f"replaced={ho['replaced']} dead={dead}"),
        ]
        storm["evidence"] = {"handoff": ho, "dead_replicas": dead}
        return out


# ---------------------------------------------------------------------------
# 3. Restart warm-start over a corrupted disk store
# ---------------------------------------------------------------------------


class RestartWarmStart(Scenario):
    """Process 1 serves traffic and persists prefix blocks; process 2
    (a fresh backend over the same --disk-kv-dir) warm-starts while
    chaos corrupts entries UNDER it mid-load. The crc32 boundary must
    skip-unlink-degrade: identical outputs, corrupt counter up, no
    poisoned prefix ever served."""

    name = "restart_warm_start"
    description = ("restart warm-start while disk prefix entries "
                   "corrupt under the reader")

    PROMPTS = [
        "system: shared policy preamble for every agent session. " * 4
        + f"task {i}: restate the rules briefly."
        for i in range(3)
    ]

    def _backend(self, ctx: dict):
        from quoracle_tpu_torch.models.runtime import TorchBackend
        return TorchBackend([ctx["member"]], host_kv_mb=32,
                            disk_kv_dir=ctx["tmpdir"], disk_kv_gb=1.0,
                            **_backend_where(ctx))

    def build(self, ctx: dict) -> None:
        ctx["backends"] = []

    def rules(self, ctx: dict) -> list:
        return [FaultRule("kvtier.disk_load", "corrupt", every=2),
                FaultRule("kvtier.restore", "fail", prob=0.25)]

    def traffic(self, ctx: dict, phase: str) -> dict:
        b = self._backend(ctx)            # each phase IS a "process"
        try:
            results = []
            for i, p in enumerate(self.PROMPTS):
                results += b.query([_req(ctx, _msgs(p), max_tokens=12,
                                         sid=f"{phase}-s{i}")])
            for i in range(len(self.PROMPTS)):
                b.drop_session(f"{phase}-s{i}")
            for e in b.engines.values():
                tier = getattr(e.sessions, "tier", None)
                if tier is not None:
                    tier.flush_spills()
            stats = b.kv_stats()
            return {"submitted": len(self.PROMPTS), "results": results,
                    "eq": results, "kv": stats}
        finally:
            b.close()

    def check(self, ctx, clean, storm, plan, flight_slice) -> list:
        disk = {}
        for m in (storm.get("kv") or {}).get("members", {}).values():
            disk = m.get("disk") or {}
        fired_corrupt = [t for t in plan.schedule()
                         if t[3] == "corrupt"]
        out = [
            inv.no_silent_loss(storm["submitted"], storm["results"]),
            inv.structured_failures(storm["results"]),
            inv.temp0_equality(clean["eq"], storm["eq"]),
            inv.lockdep_clean(),
            inv.fault_schedule(plan, flight_slice),
            inv.InvariantResult(
                "corruption_contained",
                (not fired_corrupt)
                or disk.get("corrupt_skipped", 0) >= len(fired_corrupt),
                f"corrupt_fired={len(fired_corrupt)} "
                f"corrupt_skipped={disk.get('corrupt_skipped')}"),
        ]
        storm["evidence"] = {"disk": disk,
                             "corrupt_fired": len(fired_corrupt)}
        return out


# ---------------------------------------------------------------------------
# 4. Drift storm
# ---------------------------------------------------------------------------


class DriftStorm(Scenario):
    """Member crash/garbage injection under real ConsensusEngine
    decides: a healthy baseline, then one member turns to garbage
    (valid-but-divergent proposals → dissent) and another starts
    crashing (structured transport failures). The quality plane's
    detector must trip dissent drift on the garbage member, every audit
    record must stay coherent, and no decide may be lost. Resets the
    process-wide QUALITY rolling state — scenario baselines must not inherit another
    run's EWMA history."""

    name = "drift_storm"
    description = ("member garbage/crash under consensus decides — "
                   "drift detection + audit coherence")
    deterministic_rerun = True

    N_DECIDES = 26
    GARBAGE_AT = 20                       # past QUALITY.min_samples
    GARBAGE_MEMBER = "mock:consensus-model-3"
    CRASH_MEMBER = "mock:consensus-model-2"

    def build(self, ctx: dict) -> None:
        from quoracle_tpu_torch.models.runtime import MockBackend
        ctx["backend"] = MockBackend()
        ctx["backends"] = []              # MockBackend has no close()

    def rules(self, ctx: dict) -> list:
        return [
            FaultRule("pool.member", "garbage", start=self.GARBAGE_AT,
                      match={"model": self.GARBAGE_MEMBER}),
            FaultRule("pool.member", "crash", start=self.GARBAGE_AT + 2,
                      every=3, match={"model": self.CRASH_MEMBER}),
        ]

    def traffic(self, ctx: dict, phase: str) -> dict:
        from quoracle_tpu_torch.consensus.engine import (
            ConsensusConfig, ConsensusEngine,
        )
        from quoracle_tpu_torch.consensus.quality import QUALITY
        from quoracle_tpu_torch.models.runtime import MockBackend
        QUALITY.reset()
        pool = list(MockBackend.DEFAULT_POOL)
        eng = ConsensusEngine(ctx["backend"], ConsensusConfig(
            model_pool=pool, session_key=f"chaos-{phase}",
            quality=True, task_id=f"chaos-drift-{phase}"))
        outcomes, records = [], []
        for i in range(self.N_DECIDES):
            msgs = {m: _msgs(f"decide {i}: pick the next action")
                    for m in pool}
            out = eng.decide(msgs)
            outcomes.append(out)
            if out.audit is not None:
                records.append(out.audit)
        return {"submitted": self.N_DECIDES, "outcomes": outcomes,
                "records": records,
                "scorecards": QUALITY.scorecards()}

    def check(self, ctx, clean, storm, plan, flight_slice) -> list:
        cards = storm["scorecards"]
        garbage = cards["members"].get(self.GARBAGE_MEMBER, {})
        drift = (garbage.get("drift") or {}).get("dissent") or {}
        crash_card = cards["members"].get(self.CRASH_MEMBER, {})
        failures = crash_card.get("failures") or {}
        decided = sum(1 for o in storm["outcomes"]
                      if o.status is not None)
        out = [
            inv.InvariantResult(
                "no_silent_loss",
                decided == storm["submitted"]
                and len(storm["records"]) == storm["submitted"],
                f"decides={decided}/{storm['submitted']} "
                f"audit_records={len(storm['records'])}"),
            inv.audit_coherent(storm["records"]),
            inv.lockdep_clean(),
            inv.fault_schedule(plan, flight_slice),
            inv.InvariantResult(
                "drift_tripped", bool(drift.get("tripped")),
                f"garbage member dissent drift: {drift}"),
            inv.InvariantResult(
                "failures_attributed",
                sum(failures.values()) >= 1 if plan.schedule() else True,
                f"crash member failure kinds: {failures}"),
        ]
        storm["evidence"] = {"drifting": cards.get("drifting"),
                             "garbage_drift": drift,
                             "crash_failures": failures}
        return out


# ---------------------------------------------------------------------------
# 5. HBM-pressure churn
# ---------------------------------------------------------------------------


class HbmPressureChurn(Scenario):
    """Sessioned continuous-batching traffic on an INT8-quantized member
    while chaos forces the eviction ladder to hibernate
    everything demotable every other tick, fails a quarter of the
    restores (degrade-to-re-prefill), poisons compile-cache keys into a
    ledger-level recompile storm, and flips per-page SCALE bytes in
    disk entries on the restore path. Outputs must not move a bit; the
    storm gauge must trip and recover; every scale corruption must be
    crc-rejected (skip, unlink, re-prefill) — silently-wrong KV is the
    one outcome this scenario exists to rule out."""

    name = "hbm_pressure_churn"
    description = ("forced demote churn + restore failures + compile-"
                   "key poisoning + per-page scale corruption under "
                   "sessioned continuous traffic on a quantized member")

    N_SESSIONS = 3

    def build(self, ctx: dict) -> None:
        from quoracle_tpu_torch.models.runtime import TorchBackend
        b = TorchBackend([ctx["member"]], continuous=True,
                         continuous_chunk=8, host_kv_mb=32,
                         disk_kv_dir=ctx["tmpdir"], disk_kv_gb=1.0,
                         quantize_kv=True,
                         **_backend_where(ctx, quantize_kv=True))
        ctx["backend"] = b
        ctx["backends"] = [b]

    def rules(self, ctx: dict) -> list:
        return [
            FaultRule("sched.tick", "demote", every=2),
            FaultRule("kvtier.restore", "fail", prob=0.25),
            FaultRule("compile.key", "poison", max_fires=8),
            FaultRule("kvtier.scale_corrupt", "corrupt", prob=0.5),
        ]

    def traffic(self, ctx: dict, phase: str) -> dict:
        b = ctx["backend"]
        results = []
        # > 1 page (128 tokens, byte tokenizer) so wave 1's store-backs
        # write-through full prefix blocks to the disk store
        prompts = [f"churn session {i}: keep a running tally. " * 4
                   for i in range(self.N_SESSIONS)]
        # wave 1 establishes sessions; churn demotes them between
        # ticks; wave 2 resumes them (restore or re-prefill, same bits)
        for wave in range(2):
            for i, p in enumerate(prompts):
                results += b.query([_req(
                    ctx, _msgs(p + f" wave {wave}."), max_tokens=10,
                    sid=f"{phase}-churn{i}")])
        # wave 3: FRESH sessions over the same shared prompts, with the
        # radix tree stripped and the host prefix copies evicted — the
        # prefix ladder's DISK rung must serve, i.e. every restore runs
        # through the crc boundary the scale_corrupt point flips
        # (reject → unlink → re-prefill, bits unchanged).
        eng = b.engines[ctx["member"]]
        tier = eng.sessions.tier
        tier.flush_spills()
        with eng._paged_lock:
            with eng.sessions.lock:
                got = eng.sessions.alloc(eng.sessions.n_pages - 1)
                if got is not None:
                    eng.sessions._release(got)
        with eng.sessions.lock:
            for key in list(tier.host.prefixes):
                e = tier.host.prefixes.pop(key)
                tier.host.bytes -= e.nbytes
            tier.host.sessions.clear()
            tier.host.bytes = 0
        for i, p in enumerate(prompts):
            results += b.query([_req(ctx,
                                     _msgs(p + " wave 0."), max_tokens=10,
                                     sid=f"{phase}-fresh{i}")])
        for i in range(self.N_SESSIONS):
            b.drop_session(f"{phase}-churn{i}")
            b.drop_session(f"{phase}-fresh{i}")
        eng = b.engines[ctx["member"]]
        tier = eng.sessions.tier
        return {
            "submitted": 3 * self.N_SESSIONS,
            "results": results, "eq": results,
            "tier": tier.stats() if tier is not None else {},
            "storms_total": eng.compiles.storms_total,
            # a storm already active at phase end never RE-trips inside
            # the 120 s window — the detection check must not demand a
            # second transition
            "storm_active": eng.compiles.storm,
        }

    def check(self, ctx, clean, storm, plan, flight_slice) -> list:
        tier_clean = clean.get("tier") or {}
        tier_storm = storm.get("tier") or {}
        demoted = (tier_storm.get("demoted_sessions", 0)
                   - tier_clean.get("demoted_sessions", 0))
        storms = (storm.get("storms_total", 0)
                  - clean.get("storms_total", 0))
        poisoned = [t for t in plan.schedule() if t[3] == "poison"]
        churned = [t for t in plan.schedule() if t[3] == "demote"]
        scale_hits = [t for t in plan.schedule()
                      if t[0] == "kvtier.scale_corrupt"]
        disk = (tier_storm.get("disk") or {})
        corrupt_detected = (disk.get("corrupt_skipped", 0)
                            - ((tier_clean.get("disk") or {})
                               .get("corrupt_skipped", 0)))
        out = [
            inv.no_silent_loss(storm["submitted"], storm["results"],
                               backends=[ctx["backend"]]),
            inv.structured_failures(storm["results"]),
            inv.temp0_equality(clean["eq"], storm["eq"]),
            inv.lockdep_clean(),
            inv.fault_schedule(plan, flight_slice),
            inv.InvariantResult(
                "churn_engaged",
                demoted >= 1 if churned else True,
                f"demote_faults={len(churned)} sessions_demoted={demoted}"),
            inv.InvariantResult(
                "storm_detected",
                (storms >= 1 or bool(clean.get("storm_active"))
                 or bool(storm.get("storm_active")))
                if len(poisoned) >= 5 else True,
                f"poisoned_keys={len(poisoned)} storms_tripped={storms} "
                f"active={bool(storm.get('storm_active'))}"),
            # every flipped per-page scale byte must
            # be DETECTED — crc reject → skip + unlink + re-prefill. The
            # temp-0 equality check above is the "never silently wrong"
            # half; this is the "the boundary actually fired" half.
            inv.InvariantResult(
                "scale_corruption_detected",
                corrupt_detected >= 1 if scale_hits else True,
                f"scale_corrupt_faults={len(scale_hits)} "
                f"crc_rejects={corrupt_detected}"),
        ]
        storm["evidence"] = {"tier": tier_storm, "storms": storms,
                             "storm_active": bool(
                                 storm.get("storm_active")),
                             "poisoned": len(poisoned),
                             "scale_corrupt": len(scale_hits),
                             "crc_rejects": corrupt_detected}
        return out


# (6. The JAX registry's fabric_partition waits for the cross-host fabric:
# NOT_PORTED below.)


# ---------------------------------------------------------------------------
# 7. Scale storm
# ---------------------------------------------------------------------------


class ScaleStorm(Scenario):
    """The elastic fleet under fire: a 4-replica prefill/decode cluster
    runs sessioned traffic while the FleetController scales up (policy
    ticks over synthetic burn signals), retires a decode replica
    through a live drain, re-tiers a prefill replica and flips it back,
    and force-drains the replica holding a live session — with chaos
    KILLING the first draining replica mid-drain (sessions still
    aboard) and degrading one later migration. Every row must survive
    bit-equal to the fault-free pass (cold re-prefills allowed, wrong
    bits never), failures must be structured, and the handoff envelope
    ledger must end empty — a leaked envelope is a stranded failover
    source. Both phases run the SAME self-restoring script, so the
    shared cluster enters the storm with the clean phase's topology
    shape (2 prefill + 2 decode)."""

    name = "scale_storm"
    description = ("forced drain + re-tier + scale-down mid-traffic "
                   "with a replica killed during its own drain")

    N_SESSIONS = 3

    def build(self, ctx: dict) -> None:
        from quoracle_tpu_torch.serving.cluster import ClusterPlane
        from quoracle_tpu_torch.serving.fleet import (
            FleetConfig, FleetController,
        )
        cl = ClusterPlane.build([ctx["member"]], replicas=4,
                                disaggregate=True, continuous=True,
                                continuous_chunk=8, **_where(ctx))
        ctx["cluster"] = cl
        ctx["fleet"] = FleetController(cl, FleetConfig(
            min_replicas=1, max_replicas=4, hysteresis_ticks=2,
            cooldown_ticks=0, seed=5))
        ctx["backends"] = [cl]

    def rules(self, ctx: dict) -> list:
        return [
            # the first draining replica dies with sessions aboard —
            # mark-failed + re-prefill, never silent loss
            FaultRule("fleet.migrate", "crash", max_fires=1),
            # one later migration degrades a single session to
            # re-prefill (affinity dropped, bits unchanged)
            FaultRule("fleet.migrate", "fail", max_fires=1),
        ]

    @staticmethod
    def _burn_signals(cl):
        from quoracle_tpu_torch.serving.fleet import (
            FleetSignals, ReplicaSignal,
        )
        return FleetSignals(replicas=tuple(
            ReplicaSignal(r.replica_id, r.role,
                          12.0 if r.role == "decode" else 0.0)
            for r in cl.replicas), slo_burn=2.0)

    def traffic(self, ctx: dict, phase: str) -> dict:
        cl, fc = ctx["cluster"], ctx["fleet"]
        results, drains = [], []
        sids = [f"{phase}-elastic{i}" for i in range(self.N_SESSIONS)]
        # wave 1: establish sessions on the decode tier
        for i, sid in enumerate(sids):
            results += cl.query([_req(
                ctx, _msgs(f"elastic session {i}: plan the next scale "
                           f"event step by step"), sid=sid, max_tokens=10)])
        # policy scale-up: two burn ticks clear the hysteresis bound
        fc.tick(self._burn_signals(cl))
        up = fc.tick(self._burn_signals(cl))
        assert up is not None and up.action == "scale_up"
        results += cl.query([_req(ctx, _msgs("mid-traffic row A"),
                                  max_tokens=8)])
        # scale-down: retire the first decode replica through a live
        # drain — the storm kills it mid-drain (fleet.migrate crash)
        first_dec = sorted(r.replica_id for r in cl.replicas
                           if r.role == "decode")[0]
        drains.append(fc.drain(first_dec, retire=True,
                               reason=f"{phase}-scale-down"))
        # re-tier a prefill replica into the decode tier and back —
        # the drain-flip-drain-flip round trip must strand nothing
        pre = sorted(r.replica_id for r in cl.replicas
                     if r.role == "prefill")[-1]
        drains.append(fc.drain(pre, new_role="decode",
                               reason=f"{phase}-retier"))
        results += cl.query([_req(ctx, _msgs("mid-traffic row B"),
                                  max_tokens=8)])
        drains.append(fc.drain(pre, new_role="prefill",
                               reason=f"{phase}-retier-back"))
        # wave 2: resume every session (migrated, or re-prefilled where
        # the kill took its replica down)
        for i, sid in enumerate(sids):
            results += cl.query([_req(
                ctx, _msgs(f"elastic session {i}: continue the plan"),
                sid=sid, max_tokens=10)])
        # forced drain of the replica HOLDING session 0 (the hot-swap
        # primitive): its migration degrades in the storm (fail)
        holder = cl.router.affinity_of(sids[0])
        if holder is not None:
            drains.append(fc.drain(holder.replica_id, retire=False,
                                   reason=f"{phase}-hot-swap"))
        # wave 3: every session serves again, wherever it landed
        for i, sid in enumerate(sids):
            results += cl.query([_req(
                ctx, _msgs(f"elastic session {i}: summarize"),
                sid=sid, max_tokens=10)])
        for sid in sids:
            cl.drop_session(sid)
        return {
            "submitted": 3 * self.N_SESSIONS + 2,
            "results": results, "eq": results,
            "drains": drains,
            "handoff": cl.handoff.stats(),
        }

    def check(self, ctx, clean, storm, plan, flight_slice) -> list:
        cl = ctx["cluster"]
        crash_fired = [t for t in plan.schedule() if t[3] == "crash"]
        fail_fired = [t for t in plan.schedule() if t[3] == "fail"]
        clean_first, storm_first = clean["drains"][0], storm["drains"][0]
        out = [
            inv.no_silent_loss(storm["submitted"], storm["results"],
                               backends=[cl]),
            inv.structured_failures(storm["results"]),
            inv.temp0_equality(clean["eq"], storm["eq"]),
            inv.lockdep_clean(),
            inv.fault_schedule(plan, flight_slice),
            inv.InvariantResult(
                "clean_drain_migrated",
                clean_first["migrated"] >= 1
                and not clean_first["died"],
                f"clean scale-down drain: {clean_first}"),
            inv.InvariantResult(
                "kill_mid_drain_contained",
                (not crash_fired)
                or (storm_first["died"]
                    and storm_first["replica"] == crash_fired[0][1]),
                f"crash={crash_fired} storm drain: {storm_first}"),
            inv.InvariantResult(
                "migration_degraded_structurally",
                (not fail_fired)
                or any(d["failed"] >= 1 for d in storm["drains"]),
                f"fail={fail_fired} drains={storm['drains']}"),
            inv.InvariantResult(
                "no_envelope_leaks",
                storm["handoff"]["inflight"] == 0,
                f"handoff={storm['handoff']}"),
        ]
        storm["evidence"] = {
            "drains": storm["drains"],
            "ledger": ctx["fleet"].ledger(),
            "dead_replicas": [r.replica_id for r in cl.replicas
                              if not r.alive],
            "handoff": storm["handoff"],
        }
        return out


SCENARIOS: dict = {
    sc.name: sc for sc in (TrafficStorm, KillMidHandoff,
                           RestartWarmStart, DriftStorm,
                           HbmPressureChurn, ScaleStorm)
}

# The JAX registry's scenarios the port has not got, each with the
# ROADMAP item that ports it.
NOT_PORTED: dict = {
    "fabric_partition": "ROADMAP Queue 1 item 14 (the cross-host fabric)",
}
