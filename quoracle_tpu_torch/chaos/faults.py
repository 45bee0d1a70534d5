"""Deterministic fault injection for the serving stack of the PyTorch
port (port of ``quoracle_tpu/chaos/faults.py``).

A :class:`FaultPlan` is armed on the process-wide :data:`CHAOS` plane,
and the serving code's injection points (no-op hooks threaded through
existing seams) consult it on the hot path at the cost of one attribute
read while nothing is armed.

Determinism contract, the same as the JAX plane's so one plan fires at
the same calls in both packages:

* a plan carries an EXPLICIT seed and every fire decision is a pure
  function of ``(seed, point, key, n, rule)`` where ``n`` is the
  per-``(point, key)`` invocation counter: ``sha256`` of
  ``"seed:point:key:n:rule"``, no wall clock, no process-salted
  ``hash()``, no global RNG. The ``chaos_fault`` flight events carry the
  schedule (chaos/invariants.py ``fault_schedule`` compares it with the
  plan's ledger);
* ``key`` is the ctx field that names the independent stream (model for
  pool members, replica for cluster serves, "" otherwise), so threads
  serving different streams cannot perturb each other's schedules.

Injection points (all no-op while nothing is armed):

======================  =====================================  ==========
point                   seam                                   kinds
======================  =====================================  ==========
pool.member             TorchBackend._query_member_impl /      crash,
                        MockBackend.query                      slow,
                                                               garbage
sched.tick              ContinuousBatcher._loop (per tick)     demote,
                                                               delay
kvtier.restore          TierManager.restore_session            fail, delay
kvtier.disk_load        DiskPrefixStore.load (corrupts the     corrupt
                        FILE bytes so the crc32 boundary is
                        exercised end to end)
kvtier.scale_corrupt    DiskPrefixStore.load (flips a byte in  corrupt
                        an int8 entry's per-page scale arrays,
                        the same crc boundary)
compile.key             CompileRegistry.record (salts the      poison
                        shape key: a ledger-level recompile
                        storm)
admission.signals       AdmissionController.refresh_signals    drop, delay
router.signals          ClusterRouter._load_score              drop
cluster.serve           ClusterPlane._delegate                 crash, slow
cluster.decode          ClusterPlane._decode_on (decode-       crash, slow
                        replica death mid-row: envelope
                        re-place)
handoff.export          KVHandoff.export                       fail
fleet.migrate           FleetController._migrate_all (per      crash, fail
                        session migration)
======================  =====================================  ==========

``INJECTION_POINTS`` is the JAX catalog whole, so a plan the JAX package
accepts is accepted here. ``fabric.send`` and ``fabric.prefixd`` (the
cross-host fabric) and ``train.capture`` and ``train.promote`` (training)
fire nowhere in the port until their modules are ported (ROADMAP Queue 1
items 14 and 11).

``crash`` kinds raise :class:`InjectedFault` out of ``fire()``: a
structured error naming point and key, so the recovery paths exercise
the exception shape a real device failure produces. ``slow``/``delay``
sleep (bounded by ``MAX_DELAY_S``) outside the plan lock. Every other
kind is returned as a :class:`Fault` directive for the seam to apply
(corrupt the bytes, drop the signal, salt the key): only the seam owns
the state being attacked.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import time
from typing import Any, Optional, Sequence

from quoracle_tpu_torch.infra.locks import named_lock

logger = logging.getLogger(__name__)

# hard ceiling on injected sleeps: chaos must bend latency, not wedge
# tier-1 or a canary
MAX_DELAY_S = 0.25

INJECTION_POINTS: dict = {
    "pool.member": "member crash / slow / garbage-output at the pool "
                   "runtime's per-member query entry",
    "sched.tick": "forced demote churn / tick delay in the continuous "
                  "batcher's decode loop",
    "kvtier.restore": "session restore failure / delay in the tier "
                      "ladder (degrades to re-prefill)",
    "kvtier.disk_load": "on-disk prefix entry corrupted before load — "
                        "the crc32 boundary must catch it",
    "kvtier.scale_corrupt": "int8 entry's per-page scale bytes flipped "
                            "on the restore path — the same "
                            "crc boundary must reject it; a wrong "
                            "scale would silently rescale every token "
                            "of the page",
    "compile.key": "compile-cache key poisoning — every dispatch "
                   "ledgers as a fresh miss (recompile storm)",
    "admission.signals": "admission signal refresh dropped/delayed — "
                         "the shed ladder steers on stale data",
    "router.signals": "router-side replica signal snapshot dropped",
    "cluster.serve": "replica failure serving a delegated request",
    "cluster.decode": "decode-replica death mid-row, after the KV "
                      "handoff landed",
    "handoff.export": "prefill-side handoff export failure (cold "
                      "re-prefill degrade)",
    "fabric.send": "peer link fault per wire attempt — drop / delay / "
                   "corrupt-frame (the receiver's crc boundary rejects "
                   "it; bounded retry absorbs transient flaps)",
    "fabric.prefixd": "fleet prefix service unavailable / slow — the "
                      "read-through client degrades to local tiers "
                      "and cold prefill",
    "fleet.migrate": "replica death mid-drain — fires per "
                     "session migration on the fleet controller's "
                     "drain path; a crash means the draining replica "
                     "died with sessions still aboard, which must "
                     "degrade to mark-failed + re-prefill, never "
                     "silent loss",
    "train.capture": "capture-plane record write dropped / corrupted / "
                     "crashed — fires per capture batch on "
                     "the store's append path; serving must neither "
                     "block nor change a single output bit, and a "
                     "corrupt frame must be skipped-and-unlinked at "
                     "read like any disk rot",
    "train.promote": "draft hot-swap failure mid-promotion "
                     "— fires per replica on the promotion rollout; a "
                     "crash means the fleet was left half-swapped, "
                     "which must roll back to the incumbent on every "
                     "replica with zero downtime (train_rollback "
                     "flight event present)",
}


class InjectedFault(RuntimeError):
    """A chaos-injected failure. Deliberately a plain RuntimeError
    subclass: the serving stack must recover through the SAME except
    paths a real failure takes — nothing is allowed to special-case
    chaos. Structured so invariant checks (and operators reading a
    flight dump) can attribute the failure to its injection."""

    def __init__(self, point: str, key: str = "", n: int = 0):
        super().__init__(
            f"chaos_injected: fault at {point!r}"
            + (f" (key={key!r}, n={n})" if key or n else f" (n={n})"))
        self.point = point
        self.key = key
        self.n = n


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One scheduled fault family. ``prob`` is evaluated by a seeded
    counter hash (see :meth:`FaultPlan._decide`); ``start``/``every``/
    ``max_fires`` window it; ``match`` filters on ctx fields (equality),
    so a rule can target one model or one replica."""

    point: str
    kind: str
    prob: float = 1.0
    start: int = 0
    every: int = 1
    max_fires: int = 1 << 30
    delay_ms: float = 50.0
    match: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Fault:
    """The directive ``fire()`` hands back to a seam (non-raising,
    non-sleeping kinds only)."""

    point: str
    kind: str
    key: str
    n: int
    delay_ms: float = 0.0


class FaultPlan:
    """A seeded set of :class:`FaultRule`\\ s plus the fired-fault
    ledger. The plan itself is immutable once armed (rules are frozen
    dataclasses); only the counters/ledger mutate, under the plane's
    lock."""

    # ctx fields that name a rule's independent stream, in priority
    # order — the per-(point, key) counter is what makes concurrent
    # streams independent and the schedule reproducible
    KEY_FIELDS = ("model", "replica", "tenant")

    def __init__(self, seed: int, rules: Sequence[FaultRule]):
        self.seed = int(seed)
        self.rules: tuple = tuple(rules)
        self.counts: dict = {}            # (point, key) -> invocations
        self.fired: list[dict] = []       # the ledger (bounded)
        self._fires_by_rule: dict = {}    # rule idx -> fires so far
        self.nonce = 0                    # set at arm (flight filtering)

    @classmethod
    def from_dict(cls, spec: dict) -> "FaultPlan":
        """Build from the JSON shape ``--chaos-plan`` loads:
        ``{"seed": 7, "faults": [{"point": ..., "kind": ...,
        "prob": 0.5, ...}, ...]}``. Unknown points are rejected loudly —
        a typo'd plan silently injecting nothing is worse than no
        plan."""
        rules = []
        for r in spec.get("faults") or spec.get("rules") or ():
            if r.get("point") not in INJECTION_POINTS:
                raise ValueError(
                    f"unknown injection point {r.get('point')!r} "
                    f"(known: {sorted(INJECTION_POINTS)})")
            rules.append(FaultRule(**r))
        return cls(seed=int(spec.get("seed", 0)), rules=rules)

    @classmethod
    def from_json(cls, path: str) -> "FaultPlan":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    @staticmethod
    def _key(ctx: dict) -> str:
        for f in FaultPlan.KEY_FIELDS:
            v = ctx.get(f)
            if v:
                return str(v)
        return ""

    def _decide(self, rule_idx: int, rule: FaultRule, point: str,
                key: str, n: int) -> bool:
        """Pure schedule decision for invocation ``n`` of
        ``(point, key)``: window check, then a sha256-seeded Bernoulli —
        a real hash, not ``hash()`` (process-salted) and not crc32
        (linear over GF(2): adjacent seeds would draw near-identical
        schedules), because the schedule must reproduce across
        processes AND genuinely vary with the seed."""
        if n < rule.start or (n - rule.start) % rule.every != 0:
            return False
        if self._fires_by_rule.get(rule_idx, 0) >= rule.max_fires:
            return False
        if rule.prob >= 1.0:
            return True
        digest = hashlib.sha256(
            f"{self.seed}:{point}:{key}:{n}:{rule_idx}".encode()
        ).digest()
        draw = int.from_bytes(digest[:8], "big") / float(1 << 64)
        return draw < rule.prob

    def schedule(self) -> list[tuple]:
        """The fired-fault schedule as sorted ``(point, key, n, kind)``
        tuples — sorted because concurrent streams interleave
        arbitrarily in ledger order while each stream's own sequence is
        deterministic; the sorted view is the reproducible artifact."""
        return sorted((f["point"], f["key"], f["n"], f["kind"])
                      for f in self.fired)

    def as_dict(self) -> dict:
        return {
            "seed": self.seed,
            "rules": [r.as_dict() for r in self.rules],
            "fired": len(self.fired),
        }


class ChaosPlane:
    """The process-wide injection surface (module-level :data:`CHAOS`,
    deliberately global like FLIGHT/METRICS: the seams it serves span
    every subsystem and a fault plan is process-scoped by nature).
    Disarmed cost is one attribute read per seam hit."""

    def __init__(self):
        self._plan: Optional[FaultPlan] = None
        self._lock = named_lock("chaos.plan")
        self._last_report: Optional[dict] = None
        self._arm_seq = 0

    # -- arming ----------------------------------------------------------

    def arm(self, plan: FaultPlan) -> None:
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        from quoracle_tpu_torch.infra.telemetry import CHAOS_ARMED
        with self._lock:
            self._arm_seq += 1
            # the nonce distinguishes THIS arming's flight events from a
            # previous plan's (the ring is process-wide); it is not part
            # of the deterministic schedule
            plan.nonce = self._arm_seq
            self._plan = plan
        CHAOS_ARMED.set(1.0)
        FLIGHT.record("chaos_armed", armed=True, seed=plan.seed,
                      rules=len(plan.rules))
        logger.warning("chaos plane ARMED: seed=%d, %d rule(s)",
                       plan.seed, len(plan.rules))

    def disarm(self) -> Optional[FaultPlan]:
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        from quoracle_tpu_torch.infra.telemetry import CHAOS_ARMED
        with self._lock:
            plan, self._plan = self._plan, None
        CHAOS_ARMED.set(0.0)
        if plan is not None:
            FLIGHT.record("chaos_armed", armed=False, seed=plan.seed,
                          fired=len(plan.fired))
        return plan

    def armed(self) -> bool:
        return self._plan is not None

    class _Armed:
        def __init__(self, plane, plan):
            self.plane, self.plan = plane, plan

        def __enter__(self):
            self.plane.arm(self.plan)
            return self.plan

        def __exit__(self, *exc):
            self.plane.disarm()
            return False

    def arming(self, plan: FaultPlan) -> "ChaosPlane._Armed":
        """``with CHAOS.arming(plan): ...`` — scenario-scoped arming."""
        return ChaosPlane._Armed(self, plan)

    # -- the hot-path hook -----------------------------------------------

    def fire(self, point: str, **ctx: Any) -> Optional[Fault]:
        """The seam hook. Disarmed: one attribute read, returns None.
        Armed: bump the ``(point, key)`` counter, evaluate the rules,
        and on a hit record the fault (ledger + counter + flight event)
        and act — ``crash`` raises :class:`InjectedFault`, ``slow``/
        ``delay`` sleep (outside the lock, bounded), anything else
        returns the :class:`Fault` directive for the seam to apply."""
        plan = self._plan
        if plan is None:
            return None
        key = FaultPlan._key(ctx)
        hit: Optional[tuple] = None
        with self._lock:
            if self._plan is not plan:    # raced a disarm
                return None
            n = plan.counts.get((point, key), 0)
            plan.counts[(point, key)] = n + 1
            for idx, rule in enumerate(plan.rules):
                if rule.point != point:
                    continue
                if rule.match and any(ctx.get(k) != v
                                      for k, v in rule.match.items()):
                    continue
                if self._decide_locked(plan, idx, rule, point, key, n):
                    hit = (idx, rule, n)
                    break
        if hit is None:
            return None
        idx, rule, n = hit
        self._record(plan, point, rule.kind, key, n)
        if rule.kind == "crash":
            raise InjectedFault(point, key=key, n=n)
        if rule.kind in ("slow", "delay"):
            time.sleep(min(MAX_DELAY_S, max(0.0, rule.delay_ms) / 1000))
            return None
        return Fault(point=point, kind=rule.kind, key=key, n=n,
                     delay_ms=rule.delay_ms)

    @staticmethod
    def _decide_locked(plan: FaultPlan, idx: int, rule: FaultRule,
                       point: str, key: str, n: int) -> bool:
        if not plan._decide(idx, rule, point, key, n):
            return False
        plan._fires_by_rule[idx] = plan._fires_by_rule.get(idx, 0) + 1
        return True

    def _record(self, plan: FaultPlan, point: str, kind: str, key: str,
                n: int) -> None:
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        from quoracle_tpu_torch.infra.telemetry import CHAOS_FAULTS_TOTAL
        with self._lock:
            seq = len(plan.fired)
            if seq < 4096:                # ledger is bounded, counters not
                plan.fired.append({"seq": seq, "point": point,
                                   "kind": kind, "key": key, "n": n})
        CHAOS_FAULTS_TOTAL.inc(point=point, kind=kind)
        # the event's own kind is "chaos_fault"; the FAULT's kind rides
        # as fault_kind (chaos/invariants.chaos_events reads it back)
        FLIGHT.record("chaos_fault", point=point, fault_kind=kind,
                      key=key, n=n, seq=seq,
                      plan=getattr(plan, "nonce", 0))

    # -- reads (GET /api/chaos) ------------------------------------------

    def note_report(self, report: dict) -> None:
        with self._lock:
            self._last_report = report

    def status(self) -> dict:
        plan = self._plan
        with self._lock:
            last = self._last_report
        out: dict = {
            "armed": plan is not None,
            "points": dict(INJECTION_POINTS),
            "last_scenario": last,
        }
        if plan is not None:
            with self._lock:
                out["plan"] = plan.as_dict()
                out["fired"] = list(plan.fired[-64:])
        return out


CHAOS = ChaosPlane()


def chaos_demote_churn(engine) -> int:
    """Forced demote churn (the ``sched.tick`` seam's ``demote``
    directive): apply alloc pressure so the eviction ladder demotes
    every demotable victim to the host tier — sessions the still-live
    rows then restore by page-in, mid-traffic. The tier's invariants
    promise to survive this interleaving; temp-0 outputs must not
    move. Returns pages cycled (0 when no tier is attached —
    churn without a tier would DESTROY state, which is a pool-sizing
    incident, not chaos)."""
    st = getattr(engine, "sessions", None)
    if st is None or getattr(st, "tier", None) is None or st.k is None:
        return 0
    with engine._paged_lock:
        with st.lock:
            # demand (nearly) the WHOLE pool: the ladder must demote
            # every demotable victim to satisfy it. A refusal
            # (unattainable — pinned pages) still demoted everything it
            # could first, which is the churn this exists to inject.
            got = st.alloc(max(1, st.n_pages - 1))
            if got:
                st._release(got)
                return len(got)
    return 0
