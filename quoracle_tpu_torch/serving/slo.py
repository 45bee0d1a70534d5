"""Per-class latency SLOs with EWMA tail tracking (port of
``quoracle_tpu/serving/slo.py``).

The control loop: every retired row reports (class, latency) here; the
tracker keeps an exponentially-weighted mean and variance per class and
derives a TAIL estimate (mean + 2σ — a p95-flavored proxy that needs no
window buffer and reacts within ~1/alpha observations). While the
INTERACTIVE tail sits over its target, BATCH and BACKGROUND admission
weight is DEMOTED (multiplied by ``demote_to``) in the weighted-fair
queue — interactive latency recovers by slowing bulk work down, not by
dropping it. The demotion releases with hysteresis (tail back under
``recover_ratio × target``) so the weights don't flap at the boundary.

Every demotion counts in ``quoracle_qos_demotions_total``; the live tail
estimates and multipliers are gauges (infra/telemetry.py), and each
demote and restore is recorded in the flight recorder with the
INTERACTIVE tail.
"""

from __future__ import annotations

import math
from typing import Optional

from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.telemetry import (
    QOS_CLASS_TAIL_MS, QOS_DEMOTIONS_TOTAL, QOS_WEIGHT_MULTIPLIER,
)
from quoracle_tpu_torch.serving.qos import Priority, coerce_priority

# Default per-class tail targets (ms): a human notices ~1.5 s; agent
# turns tolerate a few seconds; bulk classes only alert, never demote.
DEFAULT_TARGETS_MS: dict[Priority, float] = {
    Priority.INTERACTIVE: 1500.0,
    Priority.AGENT: 6000.0,
    Priority.BATCH: 30000.0,
    Priority.BACKGROUND: 120000.0,
}


class SLOTracker:
    """EWMA tail tracker + the INTERACTIVE-burn → BATCH-demotion loop.

    Thread-safe; ``observe`` is the hot path (a few float ops under one
    lock). ``weight_multiplier`` is read by WeightedFairPolicy at every
    DRR credit refill, so a demotion shapes the very next admit.
    """

    def __init__(self, targets_ms: Optional[dict] = None,
                 alpha: float = 0.15, demote_to: float = 0.25,
                 recover_ratio: float = 0.8):
        base = dict(DEFAULT_TARGETS_MS)
        for k, v in (targets_ms or {}).items():
            base[coerce_priority(k)] = float(v)
        self.targets_ms = base
        self.alpha = float(alpha)
        self.demote_to = float(demote_to)
        self.recover_ratio = float(recover_ratio)
        self._mean: dict[Priority, float] = {}
        self._var: dict[Priority, float] = {}
        self._count: dict[Priority, int] = {p: 0 for p in Priority}
        self._demoted = False
        self.demotions = 0
        self._lock = named_lock("qos.slo")
        for p in Priority:
            QOS_WEIGHT_MULTIPLIER.set(1.0, cls=p.name.lower())

    # ------------------------------------------------------------------

    def observe(self, priority, latency_ms: float) -> None:
        cls = coerce_priority(priority)
        a = self.alpha
        with self._lock:
            m = self._mean.get(cls)
            if m is None:
                self._mean[cls] = float(latency_ms)
                self._var[cls] = 0.0
            else:
                d = float(latency_ms) - m
                self._mean[cls] = m + a * d
                # EW variance (West 1979 form): decays like the mean
                self._var[cls] = (1 - a) * (self._var[cls] + a * d * d)
            self._count[cls] += 1
            tail = self._tail_locked(cls)
            flipped = self._update_demotion_locked()
        QOS_CLASS_TAIL_MS.set(round(tail, 2), cls=cls.name.lower())
        if flipped is not None:
            self._record_flip(flipped)

    def _tail_locked(self, cls: Priority) -> float:
        m = self._mean.get(cls)
        if m is None:
            return 0.0
        return m + 2.0 * math.sqrt(max(0.0, self._var.get(cls, 0.0)))

    def _update_demotion_locked(self) -> Optional[bool]:
        """Returns True on demote, False on restore, None on no change.
        Demotion needs a few observations first — one slow warmup row
        must not throttle the whole batch tier."""
        tail = self._tail_locked(Priority.INTERACTIVE)
        target = self.targets_ms[Priority.INTERACTIVE]
        if (not self._demoted and tail > target
                and self._count[Priority.INTERACTIVE] >= 3):
            self._demoted = True
            self.demotions += 1
            return True
        if self._demoted and tail < self.recover_ratio * target:
            self._demoted = False
            return False
        return None

    def _record_flip(self, demoted: bool) -> None:
        tail = self.tail_ms(Priority.INTERACTIVE)
        if demoted:
            QOS_DEMOTIONS_TOTAL.inc()
            FLIGHT.record("qos_demote",
                          interactive_tail_ms=round(tail, 1),
                          target_ms=self.targets_ms[Priority.INTERACTIVE],
                          demote_to=self.demote_to)
        else:
            FLIGHT.record("qos_restore",
                          interactive_tail_ms=round(tail, 1))
        for p in (Priority.BATCH, Priority.BACKGROUND):
            QOS_WEIGHT_MULTIPLIER.set(
                self.demote_to if demoted else 1.0, cls=p.name.lower())

    # -- reads -----------------------------------------------------------

    def weight_multiplier(self, priority) -> float:
        cls = coerce_priority(priority)
        with self._lock:
            if self._demoted and cls >= Priority.BATCH:
                return self.demote_to
            return 1.0

    def tail_ms(self, priority) -> float:
        cls = coerce_priority(priority)
        with self._lock:
            return self._tail_locked(cls)

    @property
    def demoted(self) -> bool:
        with self._lock:
            return self._demoted

    def burn(self, priority=Priority.INTERACTIVE) -> float:
        """Tail-over-target ratio for a class: 0.0 with no
        observations, 1.0 exactly at target, >1.0 while the SLO burns.
        The fleet controller reads this as its scale-up pressure signal
        — the same number the demotion loop compares against 1.0."""
        cls = coerce_priority(priority)
        with self._lock:
            if not self._count.get(cls):
                return 0.0
            return self._tail_locked(cls) / max(1e-9,
                                                self.targets_ms[cls])

    def stats(self) -> dict:
        with self._lock:
            return {
                "demoted": self._demoted,
                "demotions": self.demotions,
                "demote_to": self.demote_to,
                "classes": {
                    p.name.lower(): {
                        "target_ms": self.targets_ms[p],
                        "tail_ms": round(self._tail_locked(p), 2),
                        "mean_ms": round(self._mean.get(p, 0.0), 2),
                        "observed": self._count[p],
                    } for p in Priority
                },
            }
