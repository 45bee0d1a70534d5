"""Priority classes, per-tenant token buckets, and the weighted-fair
multi-queue (port of ``quoracle_tpu/serving/qos.py``).

The continuous batcher (models/scheduler.py) admits from a POLICY — it
calls ``put``/``pop`` on an :class:`AdmissionPolicy` and never looks
inside:

* :class:`FifoPolicy` — arrival order, the default (QoS is opt-in;
  temperature-0 outputs are identical either way, only ORDER moves).
* :class:`WeightedFairPolicy` — one deque per :class:`Priority` class,
  served by deficit round-robin (DRR: each class earns ``quantum ×
  weight`` credit when the cursor arrives and spends 1 per admitted row,
  so long-run service converges to the weight ratio without preemption)
  plus an AGING FLOOR: any row that has waited ``aging_floor_s`` is
  served next regardless of its class. An SLO tracker (slo.py) can scale
  weights live via ``weight_fn`` (demoting BATCH while INTERACTIVE
  burns).

The baton batcher (models/runtime.py) reads only the classes and their
coercion. The JAX module's ``named_lock`` is a plain ``threading.Lock``
here.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from quoracle_tpu_torch.infra.telemetry import QOS_QUEUE_DEPTH


class Priority(enum.IntEnum):
    """QoS classes, most urgent first (lower value = served sooner).

    INTERACTIVE — a human is waiting (dashboard submissions, root task
    messages). AGENT — root/near-root agents' consensus turns (the
    latency-critical tool-calling tier). BATCH — deep subtree fan-out
    work. BACKGROUND — condensation, reflection, prefetch: work nobody
    is waiting on.
    """

    INTERACTIVE = 0
    AGENT = 1
    BATCH = 2
    BACKGROUND = 3


# Default DRR weights: 8/4/2/1 — each class gets ~2x the service share of
# the one below it while every class stays live (no strict preemption).
DEFAULT_WEIGHTS: dict[Priority, float] = {
    Priority.INTERACTIVE: 8.0,
    Priority.AGENT: 4.0,
    Priority.BATCH: 2.0,
    Priority.BACKGROUND: 1.0,
}

# Any queued row older than this is served next regardless of class — the
# starvation bound.
DEFAULT_AGING_FLOOR_S = 2.0


def priority_for_depth(depth: int) -> Priority:
    """Derive an agent's QoS class from its depth in the agent tree:
    root agents (depth 0) are the user's direct delegates and outrank
    grandchildren — the deeper the subtree, the more the work resembles
    batch fan-out. INTERACTIVE is reserved for requests a human is
    actively waiting on (web submissions), never derived from depth."""
    if depth <= 0:
        return Priority.AGENT
    if depth <= 2:
        return Priority.BATCH
    return Priority.BACKGROUND


def class_name(priority: Any) -> str:
    """Metric-label form of a priority ('interactive', …); tolerates raw
    ints and unknown values (clamped into the enum range)."""
    try:
        return Priority(int(priority)).name.lower()
    except (ValueError, TypeError):
        return Priority.BATCH.name.lower()


def coerce_priority(priority: Any,
                    default: Priority = Priority.AGENT) -> Priority:
    """None/ints/enum members → a Priority, clamped into range (an
    out-of-range int from a remote caller must not crash admission)."""
    if priority is None:
        return default
    try:
        v = int(priority)
    except (TypeError, ValueError):
        return default
    return Priority(min(max(v, Priority.INTERACTIVE), Priority.BACKGROUND))


# ---------------------------------------------------------------------------
# Token buckets (per-tenant rate limiting)
# ---------------------------------------------------------------------------


class TokenBucket:
    """Classic token bucket: ``rate_per_s`` tokens accrue continuously up
    to ``burst``; ``try_acquire(n)`` either spends n and returns 0.0, or
    returns the seconds until n tokens will exist (the caller's
    ``retry_after``). Monotonic-clock based; thread-safe."""

    def __init__(self, rate_per_s: float, burst: float):
        if rate_per_s <= 0:
            raise ValueError("rate_per_s must be positive")
        self.rate_per_s = float(rate_per_s)
        self.burst = max(float(burst), 1.0)
        self._tokens = self.burst
        self._t_last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t_last)
                           * self.rate_per_s)
        self._t_last = now

    def try_acquire(self, n: float = 1.0,
                    now: Optional[float] = None) -> float:
        """0.0 = acquired; > 0 = seconds until ``n`` tokens accrue."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._refill(now)
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate_per_s

    def level(self) -> float:
        with self._lock:
            self._refill(time.monotonic())
            return self._tokens


@dataclasses.dataclass
class TenantPolicy:
    """Per-tenant admission shape: request rate + burst, and a floor on
    how urgent the tenant's rows may claim to be (an untrusted tenant
    whose every request says INTERACTIVE gets clamped to ``max_class``).
    ``rate_per_s=None`` = unlimited."""

    name: str = "default"
    rate_per_s: Optional[float] = None
    burst: float = 8.0
    max_class: Priority = Priority.INTERACTIVE

    def make_bucket(self) -> Optional[TokenBucket]:
        if self.rate_per_s is None:
            return None
        return TokenBucket(self.rate_per_s, self.burst)


@dataclasses.dataclass
class QoSConfig:
    """Everything the backend needs to turn QoS on: DRR weights + aging
    floor for the per-member weighted-fair queues, tenant policies for
    the admission controller, and per-class SLO targets (slo.py)."""

    weights: Optional[dict] = None            # Priority -> weight
    quantum: float = 1.0
    aging_floor_s: float = DEFAULT_AGING_FLOOR_S
    tenants: Optional[dict] = None            # name -> TenantPolicy
    slo_targets_ms: Optional[dict] = None     # Priority -> target tail ms
    admission: Any = None                     # AdmissionConfig (admission.py)


# ---------------------------------------------------------------------------
# Admission policies (the seam the scheduler calls through)
# ---------------------------------------------------------------------------


class AdmissionPolicy:
    """What ``ContinuousBatcher`` depends on for queueing. Rows are any
    objects carrying ``priority`` and ``t_submit`` attributes (the
    scheduler's ``_Row``); policies never inspect anything else. All
    methods are thread-safe."""

    def put(self, row: Any) -> None:
        raise NotImplementedError

    def pop(self) -> Optional[Any]:
        """Next row to admit, or None when empty."""
        raise NotImplementedError

    def qsize(self) -> int:
        raise NotImplementedError

    def drain(self) -> list:
        """Remove and return every queued row (close path)."""
        raise NotImplementedError

    def snapshot(self) -> dict:
        """Debug/panel view (/api/qos). Default: just the depth."""
        return {"policy": type(self).__name__, "queued": self.qsize()}


class FifoPolicy(AdmissionPolicy):
    """The pre-QoS behavior: one queue, strict arrival order."""

    def __init__(self) -> None:
        self._q: deque = deque()
        self._lock = threading.Lock()

    def put(self, row: Any) -> None:
        with self._lock:
            self._q.append(row)

    def pop(self) -> Optional[Any]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def qsize(self) -> int:
        with self._lock:
            return len(self._q)

    def drain(self) -> list:
        with self._lock:
            rows, self._q = list(self._q), deque()
            return rows


class WeightedFairPolicy(AdmissionPolicy):
    """Deficit round-robin over per-class deques with an aging floor.

    DRR mechanics (single-pop form): a cursor walks the classes; on
    ARRIVAL at a class its deficit earns ``quantum × weight(cls)``, and
    each admitted row spends 1.0 — the cursor stays parked while credit
    remains, so a weight-8 class admits (up to) 8 rows per visit and
    long-run shares converge to the weight ratio (the property test
    drives 1k synthetic admits at this). An EMPTY class forfeits its
    deficit (standard DRR: credit never banks across idle periods).

    The aging floor overrides DRR: before any credit math, the oldest
    queue head that has waited ``aging_floor_s`` is served immediately.
    That bounds every class's worst-case wait at roughly the floor plus
    one service time, whatever the weights say — BACKGROUND can be slow,
    never starved.

    ``weight_fn`` (slo.SLOTracker.weight_multiplier) scales weights at
    pop time, so SLO demotion takes effect on the very next admit.
    """

    def __init__(self, weights: Optional[dict] = None,
                 quantum: float = 1.0,
                 aging_floor_s: float = DEFAULT_AGING_FLOOR_S,
                 weight_fn: Optional[Callable[[Priority], float]] = None,
                 model: str = ""):
        base = dict(DEFAULT_WEIGHTS)
        for k, v in (weights or {}).items():
            base[coerce_priority(k)] = float(v)
        if any(w <= 0 for w in base.values()):
            raise ValueError("DRR weights must be positive")
        self.weights = base
        self.quantum = float(quantum)
        self.aging_floor_s = float(aging_floor_s)
        self.weight_fn = weight_fn
        self.model = model
        self._order = sorted(Priority)
        self._queues: dict[Priority, deque] = {p: deque()
                                               for p in self._order}
        self._deficit: dict[Priority, float] = {p: 0.0
                                                for p in self._order}
        self._cursor = 0
        self._fresh = True          # cursor just arrived (earn credit once)
        self._lock = threading.Lock()
        self.served: dict[Priority, int] = {p: 0 for p in self._order}
        self.aged_served = 0

    # -- helpers (call with the lock held) ------------------------------

    def _weight(self, cls: Priority) -> float:
        w = self.weights[cls]
        if self.weight_fn is not None:
            try:
                w *= max(0.01, float(self.weight_fn(cls)))
            except Exception:         # noqa: BLE001 — policy must not die
                pass
        return w

    def _advance(self) -> None:
        self._cursor = (self._cursor + 1) % len(self._order)
        self._fresh = True

    def _gauge(self, cls: Priority) -> None:
        QOS_QUEUE_DEPTH.set(len(self._queues[cls]),
                            cls=cls.name.lower(), model=self.model)

    def _serve(self, cls: Priority, aged: bool = False) -> Any:
        row = self._queues[cls].popleft()
        self.served[cls] += 1
        if aged:
            self.aged_served += 1
        self._gauge(cls)
        return row

    # -- AdmissionPolicy -------------------------------------------------

    def put(self, row: Any) -> None:
        cls = coerce_priority(getattr(row, "priority", None))
        with self._lock:
            self._queues[cls].append(row)
            self._gauge(cls)

    def pop(self) -> Optional[Any]:
        now = time.monotonic()
        with self._lock:
            # 1) aging floor: the oldest over-floor head wins outright
            aged_cls, aged_t = None, None
            for cls in self._order:
                q = self._queues[cls]
                if not q:
                    continue
                t = getattr(q[0], "t_submit", now)
                if now - t >= self.aging_floor_s and (
                        aged_t is None or t < aged_t):
                    aged_cls, aged_t = cls, t
            if aged_cls is not None:
                return self._serve(aged_cls, aged=True)
            # 2) DRR walk: bounded — even a 0.01x-demoted weight-1 class
            # accrues 1.0 credit within ~100 arrivals, and every arrival
            # is O(1); an all-empty ring exits on the first full lap.
            for i in range(max(64, 8 * len(self._order))):
                if i >= len(self._order) and self.qsize_locked() == 0:
                    return None
                cls = self._order[self._cursor]
                q = self._queues[cls]
                if not q:
                    self._deficit[cls] = 0.0
                    self._advance()
                    continue
                if self._fresh:
                    self._deficit[cls] += self.quantum * self._weight(cls)
                    self._fresh = False
                if self._deficit[cls] >= 1.0:
                    self._deficit[cls] -= 1.0
                    return self._serve(cls)
                self._advance()
            # pathological weight_fn (all ~0): serve the oldest head so
            # the loop never wedges the decode worker
            heads = [(getattr(q[0], "t_submit", now), cls)
                     for cls, q in self._queues.items() if q]
            if not heads:
                return None
            return self._serve(min(heads)[1])

    def qsize_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def qsize(self) -> int:
        with self._lock:
            return self.qsize_locked()

    def drain(self) -> list:
        with self._lock:
            rows: list = []
            for cls in self._order:
                rows.extend(self._queues[cls])
                self._queues[cls].clear()
                self._gauge(cls)
            return rows

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            per_class = {}
            for cls in self._order:
                q = self._queues[cls]
                per_class[cls.name.lower()] = {
                    "queued": len(q),
                    "weight": round(self._weight(cls), 3),
                    "deficit": round(self._deficit[cls], 3),
                    "served": self.served[cls],
                    "oldest_wait_s": (round(
                        now - getattr(q[0], "t_submit", now), 3)
                        if q else None),
                }
            return {
                "policy": "weighted_fair",
                "model": self.model,
                "queued": self.qsize_locked(),
                "aging_floor_s": self.aging_floor_s,
                "aged_served": self.aged_served,
                "classes": per_class,
            }
