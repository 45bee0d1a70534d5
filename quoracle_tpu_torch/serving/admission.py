"""Admission control and overload shedding (port of
``quoracle_tpu/serving/admission.py``).

Every submission to a continuous batcher passes
``AdmissionController.admit()`` before it may queue, and under pressure
the controller SHEDS — a structured :class:`AdmissionError` carrying
``retry_after_ms`` instead of silent queue growth. Shedding is selective
by class: bulk tiers (BATCH/BACKGROUND) go first, AGENT only under hard
overload, INTERACTIVE only at the absolute depth cap that protects the
process itself. Deadline-expired rows fail with the distinct
:class:`DeadlineExceededError` — the consensus engine treats that as a
member miss (one row's lateness), never a pool failure. The baton batcher
(models/runtime.py) raises the same error for a row whose deadline lapsed
while it waited.

Signals (refreshed at most every ``refresh_s``, so admit() stays cheap):

* queue depth — live, from the depth sources each continuous batcher
  registers (its policy's ``qsize``);
* admit-wait p95 — COUNT DELTAS of the ``quoracle_sched_admit_wait_ms``
  histogram (infra/telemetry.py) over the refresh window;
* device-memory headroom — ``infra/resources.headroom_fraction()`` (None
  on the CPU, where the signal simply doesn't fire).

Every decision lands in telemetry (``quoracle_qos_{admitted,shed}_total``
by class/tenant/reason). Left out, each marked where it stood: the
fault-injection seam of the signal refresh (Queue 1 item 9), the
error-budget burn signals (``SignalSnapshot.budget_burn`` is ``{}``,
what the JAX package gives with its cost plane off), the liveness
heartbeat and the flight-recorder record of every shed (Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Any, Callable, Optional

from quoracle_tpu_torch.infra.telemetry import (
    QOS_ADMITTED_TOTAL, QOS_SHED_TOTAL, SCHED_ADMIT_WAIT_MS, quantile,
)
from quoracle_tpu_torch.serving.qos import (
    Priority, TenantPolicy, class_name, coerce_priority,
)


class AdmissionError(RuntimeError):
    """Structured reject: machine-readable reason + retry hint. The
    serving layer maps it to a failed row whose error string carries the
    same fields."""

    reason = "rejected"

    def __init__(self, message: str, retry_after_ms: int = 1000,
                 tenant: Optional[str] = None,
                 priority: Optional[Priority] = None):
        super().__init__(message)
        self.retry_after_ms = max(0, int(retry_after_ms))
        self.tenant = tenant
        self.priority = priority

    def as_dict(self) -> dict:
        return {
            "error": str(self),
            "reason": self.reason,
            "retry_after_ms": self.retry_after_ms,
            "tenant": self.tenant,
            "priority": (class_name(self.priority)
                         if self.priority is not None else None),
        }


class RateLimitedError(AdmissionError):
    """Tenant token bucket empty; retry_after_ms = time to refill."""

    reason = "rate_limit"


# hard ceiling on any escalated retry hint: past a minute the client
# should re-resolve capacity, not keep a stale backoff alive
BACKOFF_CAP_MS = 60_000


def escalate_retry_ms(base_ms: int, attempt: int,
                      cap_ms: int = BACKOFF_CAP_MS,
                      salt: int = 0) -> int:
    """Capped exponential backoff with DETERMINISTIC jitter for repeated
    aggregate sheds: attempt 1 returns
    ``base_ms``; each further consecutive shed doubles it, plus a
    0–25% jitter derived from ``crc32(salt, attempt)`` — crc32, not
    ``random``, so a retry storm de-synchronizes identically on every
    replay and tests can assert exact values. Monotonic by
    construction up to the cap: the doubling (×2) always dominates the
    worst-case jitter (×1.25), so successive 429s carry non-decreasing
    hints until both clamp at ``cap_ms``."""
    base_ms = max(1, int(base_ms))
    attempt = max(1, int(attempt))
    # cap the exponent before shifting — a long outage must not build
    # a bignum just to clamp it
    scaled = base_ms << min(attempt - 1, 24)
    jitter = (zlib.crc32(f"{salt}:{attempt}".encode()) % 1000) / 4000.0
    return int(min(cap_ms, scaled * (1.0 + jitter)))


class OverloadedError(AdmissionError):
    """System-level shed: queue depth / admit-wait / HBM pressure."""

    reason = "overload"


class DeadlineExceededError(AdmissionError):
    """The row's deadline passed before it could be admitted (or was
    already expired at submit). Retrying the SAME request is pointless —
    retry_after_ms is 0 by convention. The consensus engine treats this
    as a member miss, not a pool failure."""

    reason = "deadline"

    def __init__(self, message: str, tenant: Optional[str] = None,
                 priority: Optional[Priority] = None):
        super().__init__(message, retry_after_ms=0, tenant=tenant,
                         priority=priority)


@dataclasses.dataclass(frozen=True)
class SignalSnapshot:
    """One timestamped, structured view of the controller's sampled
    overload signals: EXACTLY the numbers the shed
    ladder reads — ``admit_wait_p95_ms`` and ``hbm_headroom`` are the
    same cached fields ``admit()`` consults, ``queue_depth`` the same
    live max over registered depth sources — so the cluster router
    places traffic on the very signals admission sheds on; there is one
    source of truth, not a parallel estimate. ``ts`` is the monotonic
    time the snapshot was BUILT; ``refreshed_ts`` when the p95/HBM
    window last refreshed (queue depth is always live)."""

    ts: float
    refreshed_ts: float
    queue_depth: int
    admit_wait_p95_ms: Optional[float]
    hbm_headroom: Optional[float]
    admitted: int
    shed: int
    # OBSERVED signal only: worst error-budget burn rate per priority
    # class from the JAX package's cost plane, which the port does not
    # have yet (Queue 1 item 8), so always {} here. The shed ladder does
    # NOT read it.
    budget_burn: dict = dataclasses.field(default_factory=dict)

    def age_s(self, now: Optional[float] = None) -> float:
        """Seconds since the cached signal window refreshed — the
        router's staleness guard input."""
        now = time.monotonic() if now is None else now
        return max(0.0, now - self.refreshed_ts)

    def stale(self, max_age_s: float,
              now: Optional[float] = None) -> bool:
        return self.age_s(now) > max_age_s

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AdmissionConfig:
    """Shed thresholds. ``max_queue_depth`` is the soft bound: past it
    bulk classes shed; past 2x AGENT sheds too; past 4x everything sheds
    (the process-protection cap). ``max_admit_wait_p95_ms`` and
    ``min_hbm_headroom`` shed bulk classes only — they are early-warning
    signals, not hard limits."""

    max_queue_depth: int = 64
    max_admit_wait_p95_ms: float = 4000.0
    min_hbm_headroom: float = 0.03
    base_retry_ms: int = 1000
    max_retry_ms: int = 30000
    refresh_s: float = 1.0
    hbm_refresh_s: float = 5.0
    # fewer than this many new admit-wait samples in a window → the p95
    # signal is stale noise, not evidence of overload
    min_wait_samples: int = 8


class AdmissionController:
    """One per backend (shared across pool members — overload is a
    system condition, not a per-engine one). Thread-safe; ``admit()`` is
    called on every submission and does no I/O outside its rate-limited
    signal refresh."""

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 tenants: Optional[dict] = None,
                 headroom_fn: Optional[Callable[[], Optional[float]]] = None,
                 model: str = ""):
        self.config = config or AdmissionConfig()
        self.model = model
        self._lock = threading.Lock()
        self._tenants: dict[str, TenantPolicy] = {}
        self._buckets: dict[str, Any] = {}
        for name, pol in (tenants or {}).items():
            self.set_tenant(pol if isinstance(pol, TenantPolicy)
                            else TenantPolicy(name=name, **pol))
        self._headroom_fn = headroom_fn
        self._depth_sources: dict[str, Callable[[], int]] = {}
        # cached signals (refreshed under _sig_lock, read without)
        self._sig_lock = threading.Lock()
        self._t_refresh = 0.0
        self._t_hbm = 0.0
        self._wait_counts: Optional[list] = None
        self.admit_wait_p95_ms: Optional[float] = None
        self.hbm_headroom: Optional[float] = None
        self.admitted = 0
        self.shed = 0

    # -- configuration ---------------------------------------------------

    def set_tenant(self, policy: TenantPolicy) -> None:
        with self._lock:
            self._tenants[policy.name] = policy
            self._buckets[policy.name] = policy.make_bucket()

    def register_depth_source(self, name: str,
                              fn: Callable[[], int]) -> None:
        with self._lock:
            self._depth_sources[name] = fn

    # -- signals ---------------------------------------------------------

    def _default_headroom(self) -> Optional[float]:
        from quoracle_tpu_torch.infra.resources import headroom_fraction
        return headroom_fraction()

    def refresh_signals(self, now: Optional[float] = None) -> None:
        """Refresh the cached overload signals if the window elapsed.
        Exceptions are swallowed — a broken sampler must never take
        admission (and the serving path behind it) down.

        The headroom sampler runs OUTSIDE ``_sig_lock``: every submit
        thread calls admit → refresh_signals, so holding the signal lock
        through a device query would serialize ALL submitters behind it.
        The window claim (``_t_hbm`` bump) stays under the lock, so
        exactly one caller per window pays the sample and the rest read
        the cached value."""
        # (the JAX package fires its fault-injection seam
        # "admission.signals" here, before the signal lock: Queue 1
        # item 9)
        now = time.monotonic() if now is None else now
        cfg = self.config
        sample_hbm = False
        with self._sig_lock:
            if now - self._t_refresh < cfg.refresh_s:
                return
            self._t_refresh = now
            try:
                counts, _, _ = SCHED_ADMIT_WAIT_MS.counts()
                if self._wait_counts is not None:
                    delta = [a - b for a, b in
                             zip(counts, self._wait_counts)]
                    if sum(delta) >= cfg.min_wait_samples:
                        self.admit_wait_p95_ms = quantile(
                            SCHED_ADMIT_WAIT_MS.buckets, delta, 0.95)
                    else:
                        self.admit_wait_p95_ms = None
                self._wait_counts = counts
            except Exception:             # noqa: BLE001 — telemetry only
                pass
            if now - self._t_hbm >= cfg.hbm_refresh_s:
                self._t_hbm = now         # claim the window; sample after
                sample_hbm = True
        if sample_hbm:
            try:
                fn = self._headroom_fn or self._default_headroom
                head = fn()
            except Exception:             # noqa: BLE001 — optional signal
                head = None
            with self._sig_lock:
                self.hbm_headroom = head

    def signals(self, now: Optional[float] = None,
                max_age_s: Optional[float] = None) -> SignalSnapshot:
        """The sampled signal state as a structured, timestamped
        :class:`SignalSnapshot`. Refreshes the
        cached window first (rate-limited exactly like ``admit()``'s
        refresh, so calling this costs nothing extra in steady state);
        with ``max_age_s`` set, a window older than that forces a
        refresh even inside ``refresh_s`` — the router's staleness
        guard."""
        now0 = time.monotonic() if now is None else now
        if max_age_s is not None:
            with self._sig_lock:
                if now0 - self._t_refresh > max_age_s:
                    # expire the window so the refresh below re-samples
                    self._t_refresh = 0.0
        self.refresh_signals(now0)
        depth = self.queue_depth()
        # (the JAX package reads its error-budget burn signals here when
        # its cost plane is on: Queue 1 item 8)
        burn: dict = {}
        with self._sig_lock:
            return SignalSnapshot(
                ts=now0, refreshed_ts=self._t_refresh,
                queue_depth=depth,
                admit_wait_p95_ms=self.admit_wait_p95_ms,
                hbm_headroom=self.hbm_headroom,
                admitted=self.admitted, shed=self.shed,
                budget_burn=burn)

    def queue_depth(self) -> int:
        with self._lock:
            fns = list(self._depth_sources.values())
        depth = 0
        for fn in fns:
            try:
                depth = max(depth, int(fn()))
            except Exception:             # noqa: BLE001
                pass
        return depth

    def _retry_ms(self, depth: int, cls: Priority) -> int:
        """Retry hint grows with how far past the bound the queue is and
        with how demotable the class is (bulk work backs off longer)."""
        cfg = self.config
        over = depth / max(1, cfg.max_queue_depth)
        scale = 1.0 + max(0.0, over - 1.0) + 0.5 * int(cls)
        return min(cfg.max_retry_ms, int(cfg.base_retry_ms * scale))

    # -- the decision ----------------------------------------------------

    def admit(self, tenant: str = "default", priority: Any = None,
              deadline_s: Optional[float] = None,
              queue_depth: Optional[int] = None,
              cost: float = 1.0) -> Priority:
        """Admit or raise. Returns the EFFECTIVE priority (the tenant's
        ``max_class`` clamp applied) so the caller enqueues the row at
        the class admission actually granted."""
        now = time.monotonic()
        cls = coerce_priority(priority)
        with self._lock:
            pol = self._tenants.get(tenant) or self._tenants.get("*")
            bucket = self._buckets.get(pol.name) if pol else None
        if pol is not None and cls < pol.max_class:
            cls = pol.max_class
        if deadline_s is not None and now >= deadline_s:
            self._record_shed(cls, tenant, "deadline", 0)
            raise DeadlineExceededError(
                f"deadline passed {((now - deadline_s) * 1000):.0f}ms "
                f"before admission", tenant=tenant, priority=cls)
        if bucket is not None:
            wait_s = bucket.try_acquire(cost, now=now)
            if wait_s > 0:
                retry = int(wait_s * 1000) + 1
                self._record_shed(cls, tenant, "rate_limit", retry)
                raise RateLimitedError(
                    f"tenant {tenant!r} over its rate "
                    f"({pol.rate_per_s}/s, burst {pol.burst:g})",
                    retry_after_ms=retry, tenant=tenant, priority=cls)
        self.refresh_signals(now)
        cfg = self.config
        depth = queue_depth if queue_depth is not None \
            else self.queue_depth()
        if depth >= 4 * cfg.max_queue_depth:
            self._shed(cls, tenant, depth,
                       f"queue at hard cap ({depth} rows)")
        if depth >= 2 * cfg.max_queue_depth and cls >= Priority.AGENT:
            self._shed(cls, tenant, depth,
                       f"queue past 2x bound ({depth} rows)")
        if cls >= Priority.BATCH:
            if depth >= cfg.max_queue_depth:
                self._shed(cls, tenant, depth,
                           f"queue past bound ({depth} rows)")
            p95 = self.admit_wait_p95_ms
            if p95 is not None and p95 > cfg.max_admit_wait_p95_ms:
                self._shed(cls, tenant, depth,
                           f"admit-wait p95 {p95:.0f}ms over "
                           f"{cfg.max_admit_wait_p95_ms:.0f}ms")
            head = self.hbm_headroom
            if head is not None and head < cfg.min_hbm_headroom:
                self._shed(cls, tenant, depth,
                           f"HBM headroom {head:.3f} under "
                           f"{cfg.min_hbm_headroom}")
        with self._sig_lock:
            self.admitted += 1
        QOS_ADMITTED_TOTAL.inc(cls=cls.name.lower(), tenant=tenant)
        # (the JAX package beats its liveness heartbeat "qos.admit" here:
        # Queue 1 item 8)
        return cls

    def _shed(self, cls: Priority, tenant: str, depth: int,
              why: str) -> None:
        retry = self._retry_ms(depth, cls)
        self._record_shed(cls, tenant, "overload", retry)
        raise OverloadedError(f"shed {cls.name} for tenant {tenant!r}: "
                              f"{why}", retry_after_ms=retry,
                              tenant=tenant, priority=cls)

    def _record_shed(self, cls: Priority, tenant: str, reason: str,
                     retry_ms: int) -> None:
        with self._sig_lock:
            self.shed += 1
        QOS_SHED_TOTAL.inc(cls=cls.name.lower(), tenant=tenant,
                           reason=reason)
        # (the JAX package records a "qos_shed" flight-recorder event
        # with retry_ms here: Queue 1 item 8)

    # -- reads -----------------------------------------------------------

    def stats(self) -> dict:
        cfg = self.config
        with self._lock:
            tenants = {
                name: {
                    "rate_per_s": pol.rate_per_s,
                    "burst": pol.burst,
                    "max_class": class_name(pol.max_class),
                    "tokens": (round(self._buckets[name].level(), 2)
                               if self._buckets.get(name) else None),
                } for name, pol in self._tenants.items()
            }
            depth_sources = sorted(self._depth_sources)
        with self._sig_lock:
            admitted, shed = self.admitted, self.shed
        return {
            "admitted": admitted,
            "shed": shed,
            "queue_depth": self.queue_depth(),
            "admit_wait_p95_ms": self.admit_wait_p95_ms,
            "hbm_headroom": self.hbm_headroom,
            "thresholds": {
                "max_queue_depth": cfg.max_queue_depth,
                "max_admit_wait_p95_ms": cfg.max_admit_wait_p95_ms,
                "min_hbm_headroom": cfg.min_hbm_headroom,
            },
            "tenants": tenants,
            "depth_sources": depth_sources,
        }
