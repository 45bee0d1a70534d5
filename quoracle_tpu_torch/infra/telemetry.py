"""Serving-path metrics of the PyTorch port (port of
``quoracle_tpu/infra/telemetry.py``, the metrics half).

* :class:`MetricsRegistry` — counters, gauges, and fixed-bucket
  EXPONENTIAL latency histograms. Recording is lock-cheap (one small
  per-metric lock, a bisect, two adds); snapshots derive p50/p95/p99 by
  linear interpolation inside the owning bucket, and
  ``render_prometheus()`` emits the text exposition format.
* The instruments the continuous batcher, the QoS layer and the
  speculator record (``SCHED_*``, ``QOS_*``, ``SPEC_*``): module globals
  shared by every batcher in the process, as in the JAX package, so tests
  read deltas, never absolute values. The admission controller reads the admit-wait histogram's
  bucket counts as its p95 signal.

Left for Queue 1 item 8 (observability): the ``Tracer`` and its spans,
the registry's federation (``Histogram.merge``, ``export_state``), the
process collector, and every other instrument of the JAX module.
Recording never touches RNG or device state, so temperature-0 outputs
are the same with or without it.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Callable, Iterable, Optional, Sequence

# Latency buckets in MILLISECONDS: powers of two from 0.5 ms to ~65 s.
DEFAULT_MS_BUCKETS: tuple[float, ...] = tuple(2.0 ** i for i in range(-1, 17))


def quantile(bounds: Sequence[float], counts: Sequence[int],
             p: float) -> Optional[float]:
    """The p-quantile (0 < p < 1) of a bucketed distribution.

    ``counts`` has ``len(bounds) + 1`` slots (the last is the +Inf
    overflow). Linear interpolation inside the owning bucket; the overflow
    bucket reports its lower edge (no upper bound to interpolate to).
    Returns None for an empty histogram. A module function so callers can
    take quantiles of COUNT DELTAS (before/after a window).
    """
    total = sum(counts)
    if total <= 0:
        return None
    target = p * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            if i >= len(bounds):          # +Inf overflow bucket
                return lo
            hi = bounds[i]
            frac = (target - cum) / c
            return lo + frac * (hi - lo)
        cum += c
    return bounds[-1]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _escape(v: Any) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt_labels(key: tuple, extra: tuple = ()) -> str:
    items = tuple(key) + tuple(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


def _num(v: float) -> str:
    """Prometheus number formatting: integral floats render bare."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        # label-key tuple -> cell (shape depends on the metric kind)
        self._cells: dict[tuple, Any] = {}


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + n

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._cells.get(_label_key(labels), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._cells.values()))

    def _snapshot(self) -> dict:
        with self._lock:
            cells = dict(self._cells)
        return {"type": self.kind, "total": sum(cells.values()),
                "series": {_label_str(k): v for k, v in cells.items()}}

    def _render(self, out: list[str]) -> None:
        with self._lock:
            cells = dict(self._cells)
        for key, v in sorted(cells.items()):
            out.append(f"{self.name}{_fmt_labels(key)} {_num(v)}")


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels: Any) -> None:
        with self._lock:
            self._cells[_label_key(labels)] = float(v)

    def value(self, **labels: Any) -> Optional[float]:
        with self._lock:
            return self._cells.get(_label_key(labels))

    def _snapshot(self) -> dict:
        with self._lock:
            cells = dict(self._cells)
        return {"type": self.kind,
                "series": {_label_str(k): v for k, v in cells.items()}}

    def _render(self, out: list[str]) -> None:
        with self._lock:
            cells = dict(self._cells)
        for key, v in sorted(cells.items()):
            out.append(f"{self.name}{_fmt_labels(key)} {_num(v)}")


class _HistCell:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # +1 = +Inf overflow
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket exponential histogram. ``observe`` is the hot path:
    one lock, one bisect, three adds."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError("histogram buckets must be strictly increasing")

    def observe(self, v: float, **labels: Any) -> None:
        key = _label_key(labels)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _HistCell(len(self.buckets))
            cell.counts[idx] += 1
            cell.sum += v
            cell.count += 1

    def counts(self, **labels: Any) -> tuple[list[int], float, int]:
        """(bucket counts incl. +Inf slot, sum, count). With no labels the
        counts AGGREGATE across every label set."""
        with self._lock:
            if labels:
                cell = self._cells.get(_label_key(labels))
                cells = [cell] if cell is not None else []
            else:
                cells = list(self._cells.values())
        agg = [0] * (len(self.buckets) + 1)
        s, n = 0.0, 0
        for c in cells:
            for i, v in enumerate(c.counts):
                agg[i] += v
            s += c.sum
            n += c.count
        return agg, s, n

    def percentiles(self, ps: Iterable[float] = (0.50, 0.95, 0.99),
                    **labels: Any) -> dict[float, Optional[float]]:
        agg, _, _ = self.counts(**labels)
        return {p: quantile(self.buckets, agg, p) for p in ps}

    def _snapshot(self) -> dict:
        def q(agg):
            return {f"p{int(p * 100)}": quantile(self.buckets, agg, p)
                    for p in (0.50, 0.95, 0.99)}
        with self._lock:
            cells = {k: (list(c.counts), c.sum, c.count)
                     for k, c in self._cells.items()}
        agg, s, n = [0] * (len(self.buckets) + 1), 0.0, 0
        series = {}
        for k, (counts, cs, cn) in cells.items():
            for i, v in enumerate(counts):
                agg[i] += v
            s += cs
            n += cn
            series[_label_str(k)] = {"count": cn, "sum": cs, **q(counts)}
        return {"type": self.kind, "count": n, "sum": s, **q(agg),
                "series": series}

    def _render(self, out: list[str]) -> None:
        with self._lock:
            cells = {k: (list(c.counts), c.sum, c.count)
                     for k, c in self._cells.items()}
        for key, (counts, s, n) in sorted(cells.items()):
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                out.append(f"{self.name}_bucket"
                           f"{_fmt_labels(key, (('le', _num(b)),))} {cum}")
            out.append(f"{self.name}_bucket"
                       f"{_fmt_labels(key, (('le', '+Inf'),))} {n}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} {_num(s)}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {n}")


class MetricsRegistry:
    """Get-or-create registry; re-registering a name returns the existing
    metric (a type mismatch raises — two layers silently recording into
    differently-typed metrics of one name would corrupt both).

    COLLECTORS are scrape-time callbacks: values that are a view of live
    state are re-derived at every ``snapshot()`` / ``render_prometheus()``.
    Collector exceptions are swallowed: a broken sampler must never take a
    scrape (or the serving path behind it) down."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    def register_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def remove_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self) -> None:
        """Run every registered collector (outside the registry lock —
        collectors call back into gauge()/set())."""
        with self._lock:
            fns = list(self._collectors)
        for fn in fns:
            try:
                fn()
            except Exception:             # noqa: BLE001 — telemetry only
                pass

    def _get(self, cls, name: str, help: str, **kw) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_MS_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def snapshot(self) -> dict:
        """JSON-friendly view: per metric the aggregate (and per-label
        series) counts + p50/p95/p99 quantiles. Collectors run first."""
        self.collect()
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m._snapshot() for m in metrics}

    def render_prometheus(self) -> str:
        """Text exposition format (version 0.0.4). HELP/TYPE headers are
        emitted for every registered metric even before first traffic.
        Collectors run first."""
        self.collect()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: list[str] = []
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            m._render(out)
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        """Drop every registered metric (tests). Collectors survive."""
        with self._lock:
            self._metrics.clear()


METRICS = MetricsRegistry()

# -- continuous batcher (models/scheduler.py) --------------------------------
SCHED_QUEUE_DEPTH = METRICS.gauge(
    "quoracle_sched_queue_depth",
    "rows waiting for a continuous-batcher slot, per model")
SCHED_SLOTS_BUSY = METRICS.gauge(
    "quoracle_sched_slots_busy",
    "rows live in the shared decode loop, per model")
SCHED_ADMIT_WAIT_MS = METRICS.histogram(
    "quoracle_sched_admit_wait_ms",
    "submit → decode-loop admission wait (ms)")
SCHED_ROWS_TOTAL = METRICS.counter(
    "quoracle_sched_rows_total",
    "continuous-batcher rows by terminal status (retired | failed)")

# -- serving QoS (serving/qos.py, admission.py, slo.py) ----------------------
QOS_ADMITTED_TOTAL = METRICS.counter(
    "quoracle_qos_admitted_total",
    "requests admitted past QoS admission control, by class and tenant")
QOS_SHED_TOTAL = METRICS.counter(
    "quoracle_qos_shed_total",
    "requests shed by QoS admission control, by class/tenant/reason "
    "(rate_limit | overload | deadline)")
QOS_ADMIT_WAIT_MS = METRICS.histogram(
    "quoracle_qos_admit_wait_ms",
    "submit → decode-loop admission wait per QoS class (ms)")
QOS_QUEUE_DEPTH = METRICS.gauge(
    "quoracle_qos_queue_depth",
    "rows waiting in the weighted-fair queue, per class and model")
QOS_CLASS_TAIL_MS = METRICS.gauge(
    "quoracle_qos_class_tail_ms",
    "EWMA latency-tail estimate per QoS class (serving/slo.py)")
QOS_WEIGHT_MULTIPLIER = METRICS.gauge(
    "quoracle_qos_weight_multiplier",
    "SLO-driven DRR weight multiplier per class (1.0 = undemoted)")
QOS_DEMOTIONS_TOTAL = METRICS.counter(
    "quoracle_qos_demotions_total",
    "bulk-class weight demotions while the INTERACTIVE tail is over "
    "its SLO target")

# -- speculative serving (models/speculative.py) -----------------------------
# Batched draft/verify decoding in the continuous serving path
# (BatchedSpeculator): per-member acceptance, realized tokens per round,
# the adaptive-K state and fallback attribution.
SPEC_ROUNDS = METRICS.counter(
    "quoracle_spec_rounds_total",
    "speculative draft/verify rounds executed, per model")
SPEC_DRAFTED = METRICS.counter(
    "quoracle_spec_drafted_tokens_total",
    "draft tokens proposed across all rounds, per model")
SPEC_ACCEPTED = METRICS.counter(
    "quoracle_spec_accepted_tokens_total",
    "draft tokens accepted by the target verify, per model")
SPEC_ACCEPTANCE = METRICS.histogram(
    "quoracle_spec_acceptance",
    "per-round acceptance rate (accepted / drafted), per model",
    buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0))
SPEC_TOKENS_PER_ROUND = METRICS.histogram(
    "quoracle_spec_tokens_per_round",
    "tokens committed per speculative round per row (accepted + "
    "correction), per model",
    buckets=(1, 2, 3, 4, 5, 6, 8, 10, 12, 16))
SPEC_K = METRICS.gauge(
    "quoracle_spec_k",
    "current adaptive draft length K, per model")
SPEC_ENGAGED = METRICS.gauge(
    "quoracle_spec_engaged",
    "1 while the member's speculator is engaged, 0 while it has "
    "disengaged to vanilla decode (acceptance collapse)")
SPEC_FALLBACK_TOTAL = METRICS.counter(
    "quoracle_spec_fallback_total",
    "decode ticks a row fell back to vanilla, per model and reason "
    "(disengaged | sampling | window | draft_error | verify_error)")
