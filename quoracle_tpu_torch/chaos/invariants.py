"""Machine-checked recovery invariants of the PyTorch port (port of
``quoracle_tpu/chaos/invariants.py``).

A chaos run without enforced postconditions is a demo. Every scenario
(chaos/scenarios.py) declares the subset of these checks it must
satisfy, and the harness evaluates them from the sources of truth the
stack already maintains — client-side result accounting, the flight
recorder ring, MetricsRegistry counters, the consensus audit trail, and
the lockdep ledger — never from chaos-only side channels, so a passing
invariant means the PRODUCTION observability surface proves the
property, not the harness.

The catalog:

* ``no_silent_loss`` — every submitted request produced exactly one
  result: ok, shed (structured admission reject), or failed
  (structured error). ``submitted == ok + shed + failed`` with nothing
  unclassified and no stranded queue state.
* ``structured_failures`` — every failure is STRUCTURED: its error text
  carries a recognized machine-readable prefix, and replica failures
  name replica + phase. A bare traceback string is a failed check.
* ``temp0_equality`` — every surviving (ok) row's text is BIT-IDENTICAL
  to the same request's fault-free run. Recovery paths (handoff
  re-place, tier restore, re-prefill degrade) must be invisible in the
  output at temperature 0.
* ``audit_coherent`` — every consensus audit record emitted during the
  window is internally coherent: a decision names a winner cluster that
  exists and contains members, failures carry kinds, entropy/margin are
  in range.
* ``lockdep_clean`` — the port's lock-order sanitizer
  (infra/locks.py, ``QUORACLE_LOCKDEP=1`` or ``locks.enable()``)
  observed ZERO lock-order inversions during the storm.
* ``slo_burn_bounded`` — overload resolved through the shed ladder, not
  through unbounded latency: every propagated retry hint is bounded by
  the backoff cap and the queues fully drained by scenario end.
* ``fault_schedule`` (determinism) — the per-key ``(point, key, n,
  kind)`` tuples recovered from the ``chaos_fault`` flight events equal
  the plan ledger's, and a re-run with the same seed reproduces them
  exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from quoracle_tpu_torch.serving.admission import BACKOFF_CAP_MS

# error prefixes the serving stack is ALLOWED to fail a row with — the
# closed set that makes "structured failures only" checkable (these are
# the exact strings QueryResult.error carries; web/consensus layers
# parse the same prefixes)
STRUCTURED_ERROR_PREFIXES: tuple = (
    "admission_rejected:",
    "replica_failed:",
    "deadline_exceeded:",
    "context_overflow:",
    "chaos_injected:",
    "scripted failure",
    "generate failed: chaos_injected:",
)


@dataclasses.dataclass
class InvariantResult:
    name: str
    ok: bool
    detail: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _result(name: str, ok: bool, detail: str = "") -> InvariantResult:
    return InvariantResult(name=name, ok=bool(ok), detail=detail)


def conservation(name: str, total: int, parts: dict) -> InvariantResult:
    """Shared conservation law: ``total`` equals the sum of ``parts``
    with nothing unaccounted. The chaos no-silent-loss check and the
    sim gate's hibernation-tier census (sim/gate.py) are both
    instances of this shape — a population must be fully partitioned
    into named buckets."""
    s = sum(parts.values())
    return _result(
        name, s == total,
        f"total={total} sum={s} parts=" + ",".join(
            f"{k}:{v}" for k, v in sorted(parts.items())))


def classify(result) -> str:
    """ok | shed | failed for one QueryResult-shaped object."""
    if result is None:
        return "missing"
    if getattr(result, "ok", False):
        return "ok"
    err = getattr(result, "error", "") or ""
    if err.startswith("admission_rejected:") \
            or err.startswith("deadline_exceeded:"):
        return "shed"
    return "failed"


def _stranded_rows(backends: Sequence[Any],
                   settle_s: float = 2.0) -> list[str]:
    """Queued/live rows still parked in any backend scheduler. A row's
    future resolves INSIDE its finishing tick, so a caller that just
    collected results can observe the row in the live list for one more
    tick — poll briefly before calling it stranded."""
    import time
    deadline = time.monotonic() + settle_s
    while True:
        stranded = []
        for b in backends:
            stats = getattr(b, "scheduler_stats", None)
            for name, st in (stats() if stats is not None
                             else {}).items():
                if st.get("queued") or st.get("live"):
                    stranded.append(
                        f"{name}: queued={st.get('queued')} "
                        f"live={st.get('live')}")
        if not stranded or time.monotonic() >= deadline:
            return stranded
        time.sleep(0.05)


def no_silent_loss(submitted: int, results: Sequence[Any],
                   backends: Sequence[Any] = ()) -> InvariantResult:
    """submitted == ok + shed + failed, nothing missing, and no backend
    scheduler still holds queued/live rows (a stranded future IS a
    silent loss with extra steps)."""
    counts = {"ok": 0, "shed": 0, "failed": 0, "missing": 0}
    for r in results:
        counts[classify(r)] += 1
    total = counts["ok"] + counts["shed"] + counts["failed"]
    stranded = _stranded_rows(backends)
    ok = (counts["missing"] == 0 and total == submitted
          and len(results) == submitted and not stranded)
    return _result(
        "no_silent_loss", ok,
        f"submitted={submitted} ok={counts['ok']} shed={counts['shed']} "
        f"failed={counts['failed']} missing={counts['missing']}"
        + (f" stranded={stranded}" if stranded else ""))


def structured_failures(results: Sequence[Any]) -> InvariantResult:
    """Every non-ok result's error is a recognized structured shape;
    replica failures name replica and phase."""
    bad = []
    for i, r in enumerate(results):
        if r is None or getattr(r, "ok", False):
            continue
        err = getattr(r, "error", "") or ""
        if not any(err.startswith(p) for p in STRUCTURED_ERROR_PREFIXES):
            bad.append(f"[{i}] unstructured: {err[:120]}")
        elif err.startswith("replica_failed:") and (
                "replica=" not in err or "phase=" not in err):
            bad.append(f"[{i}] replica failure missing attribution: "
                       f"{err[:120]}")
    return _result("structured_failures", not bad, "; ".join(bad[:6]))


def temp0_equality(clean: Sequence[Any],
                   storm: Sequence[Any]) -> InvariantResult:
    """Index-aligned: every storm row that SURVIVED (ok) must match the
    clean run's text for the same request bit-for-bit. (The clean run
    must itself be fully ok — a broken baseline proves nothing.)"""
    if len(clean) != len(storm):
        return _result("temp0_equality", False,
                       f"result count {len(storm)} != clean {len(clean)}")
    broken_base = [i for i, r in enumerate(clean)
                   if not getattr(r, "ok", False)]
    if broken_base:
        return _result("temp0_equality", False,
                       f"clean baseline rows failed: {broken_base[:6]}")
    diverged = [i for i, (a, b) in enumerate(zip(clean, storm))
                if getattr(b, "ok", False) and b.text != a.text]
    survivors = sum(1 for r in storm if getattr(r, "ok", False))
    return _result(
        "temp0_equality", not diverged,
        f"survivors={survivors}/{len(storm)}"
        + (f" diverged={diverged[:6]}" if diverged else " all bit-equal"))


def audit_coherent(records: Sequence[dict]) -> InvariantResult:
    """Internal coherence of the consensus audit trail: decided records
    name a real winner cluster with members; failures carry kinds;
    entropy/margin within range; decide_ids unique."""
    bad = []
    seen_ids = set()
    for rec in records:
        rid = rec.get("decide_id")
        if rid in seen_ids:
            bad.append(f"duplicate decide_id {rid}")
        seen_ids.add(rid)
        clusters = rec.get("clusters") or []
        widx = rec.get("winner_cluster")
        if rec.get("decision") is not None:
            if widx is None or not (0 <= widx < len(clusters)):
                bad.append(f"{rid}: winner_cluster {widx} not in "
                           f"clusters[{len(clusters)}]")
            elif not clusters[widx].get("members"):
                bad.append(f"{rid}: winner cluster has no members")
        ent = rec.get("entropy_bits")
        if ent is not None and ent < 0:
            bad.append(f"{rid}: negative entropy {ent}")
        margin = rec.get("margin")
        if margin is not None and not (0 <= margin <= 1):
            bad.append(f"{rid}: margin {margin} out of [0,1]")
        for m, info in (rec.get("members") or {}).items():
            f = info.get("failure")
            if f is not None and not f.get("kind"):
                bad.append(f"{rid}: {m} failure without kind")
    return _result("audit_coherent", not bad,
                   f"records={len(records)}"
                   + ("; " + "; ".join(bad[:6]) if bad else ""))


def lockdep_clean() -> InvariantResult:
    """Drain the sanitizer ledger: any inversion observed during the
    storm is a latent ABBA deadlock the chaos run just proved
    reachable."""
    from quoracle_tpu_torch.infra import locks as lockdep
    if not lockdep.enabled():
        return _result("lockdep_clean", False,
                       "sanitizer disabled — run with QUORACLE_LOCKDEP=1")
    inversions = lockdep.LOCKDEP.drain()
    return _result(
        "lockdep_clean", not inversions,
        "; ".join(f"{i['thread']}: {i['acquiring']} while holding "
                  f"{i['violates']}" for i in inversions[:4])
        or "0 inversions")


RATE_LIMIT_HINT_CAP_MS = 3_600_000      # a bucket-refill hint's sanity bound


def slo_burn_bounded(results: Sequence[Any],
                     backends: Sequence[Any] = (),
                     cap_ms: int = BACKOFF_CAP_MS) -> InvariantResult:
    """Overload resolves through bounded, escalating sheds — every
    OVERLOAD retry hint is within (0, cap]; rate-limit sheds carry
    their bucket's refill time instead, bounded only by the one-hour
    sanity cap (a 0.001 req/s tenant is legitimately told to come back
    in minutes). By scenario end no queue still holds work — latency
    debt fully paid or shed, never parked."""
    bad = []
    for i, r in enumerate(results):
        err = getattr(r, "error", "") or ""
        if "retry_after_ms=" in err:
            try:
                v = int(err.split("retry_after_ms=")[1].split(")")[0]
                        .split(",")[0])
            except ValueError:
                bad.append(f"[{i}] unparseable retry hint: {err[:80]}")
                continue
            bound = (RATE_LIMIT_HINT_CAP_MS if "over its rate" in err
                     else cap_ms)
            if not (0 <= v <= bound):
                bad.append(f"[{i}] retry_after_ms {v} outside "
                           f"[0, {bound}]")
    bad.extend(f"{s} (not drained)" for s in _stranded_rows(backends))
    return _result("slo_burn_bounded", not bad, "; ".join(bad[:6]))


def chaos_events(flight_slice: Sequence[dict]) -> list[tuple]:
    """The sorted fault schedule recovered from a flight-ring slice —
    the production-surface twin of ``FaultPlan.schedule()``."""
    return sorted(
        (e["point"], e.get("key", ""), e["n"], e["fault_kind"])
        for e in flight_slice if e.get("kind") == "chaos_fault")


def fault_schedule(plan, flight_slice: Sequence[dict],
                   expected: Optional[list] = None) -> InvariantResult:
    """Determinism: the ``chaos_fault`` flight events recorded during
    the storm carry exactly the plan ledger's schedule; with
    ``expected`` (a previous run's schedule) also assert the re-run
    reproduced it."""
    from_flight = chaos_events(flight_slice)
    ledger = plan.schedule()
    ok = from_flight == ledger
    detail = (f"fired={len(ledger)}"
              + ("" if ok else
                 f"; flight({len(from_flight)}) != ledger({len(ledger)})"))
    if ok and expected is not None:
        ok = ledger == expected
        if not ok:
            detail += (f"; re-run diverged: {len(ledger)} vs "
                       f"expected {len(expected)}")
        else:
            detail += "; re-run reproduced the schedule"
    return _result("fault_schedule", ok, detail)
