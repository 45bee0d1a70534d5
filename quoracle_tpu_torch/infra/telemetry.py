"""Serving-path telemetry of the PyTorch port: metrics registry + span
tracing (the port's copy of ``quoracle_tpu/infra/telemetry.py``).

* **MetricsRegistry** — counters, gauges, and fixed-bucket EXPONENTIAL
  latency histograms. Recording is lock-cheap (one small per-metric lock,
  a bisect, two adds); snapshots derive p50/p95/p99 by linear
  interpolation inside the owning bucket, ``render_prometheus()`` emits
  the text exposition format, and ``export_state()`` is the lossless
  payload that federation (infra/fleetobs.py) merges across processes.
* **Tracer** — span-based tracing. A :class:`Span` carries ``trace_id``
  (the task), ``agent_id``, ``round``, and ``phase`` attributes and links
  to its parent; finished spans go to registered sinks. Propagation
  across the thread hops of the serving path (caller thread →
  pool-member threads → batcher threads) is explicit:
  ``TRACER.use(parent)`` rebinds the current span in a foreign thread.
  With no sink, ``TRACER.active()`` is False and the serving path builds
  no span at all.

Every instrument of the JAX module is registered here under the same
name, type, help text, labels and buckets, so both packages expose the
same surface; the ones for layers the port does not have yet (bus,
fabric, fleet controller, chaos, simulator, training) stay registered
and idle.

Telemetry is deliberately process-wide: metrics are write-mostly
aggregates and spans carry their own ``trace_id``, so isolation comes
from filtering, not instancing. Tests that need a hermetic view build
their own :class:`MetricsRegistry` / :class:`Tracer` or attach a private
sink; the module globals are shared, so tests read deltas.

Recording never touches RNG, device state or row content — temperature-0
and seeded outputs are bit-identical with tracing on or off.
"""

from __future__ import annotations

import bisect
import itertools
import threading
import time
from typing import Any, Callable, Iterable, Optional, Sequence

from quoracle_tpu_torch.infra.locks import named_lock

# ---------------------------------------------------------------------------
# Buckets
# ---------------------------------------------------------------------------

# Latency buckets in MILLISECONDS: powers of two from 0.5 ms to ~65 s.
# Exponential spacing keeps relative quantile error bounded (~±50% worst
# case, far tighter after interpolation) across the 5 decades the serving
# path spans (µs-scale cache lookups to multi-second compile rounds).
DEFAULT_MS_BUCKETS: tuple[float, ...] = tuple(2.0 ** i for i in range(-1, 17))

# Throughput buckets (tokens/second): powers of four, 1 .. ~4.2M tok/s.
THROUGHPUT_BUCKETS: tuple[float, ...] = tuple(4.0 ** i for i in range(0, 12))


def quantile(bounds: Sequence[float], counts: Sequence[int],
             p: float) -> Optional[float]:
    """The p-quantile (0 < p < 1) of a bucketed distribution.

    ``counts`` has ``len(bounds) + 1`` slots (the last is the +Inf
    overflow). Linear interpolation inside the owning bucket; the overflow
    bucket reports its lower edge (no upper bound to interpolate to).
    Returns None for an empty histogram. Exposed as a module function so
    bench.py can compute quantiles of COUNT DELTAS (before/after a
    measured window) without a second histogram instance.
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


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = named_lock("metrics")
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
        assert list(self.buckets) == sorted(set(self.buckets)), \
            "histogram buckets must be strictly increasing"

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

    # -- reads -----------------------------------------------------------

    def counts(self, **labels: Any) -> tuple[list[int], float, int]:
        """(bucket counts incl. +Inf slot, sum, count). With no labels the
        counts AGGREGATE across every label set — bench.py diffs these
        around a measured window."""
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

    # -- federation -------------------------------------------

    def merge(self, other: "Histogram") -> None:
        """LOSSLESS merge of another histogram's cells into this one:
        identical bucket boundaries → per-bucket summed counts, so every
        quantile of the merged histogram equals the quantile of one
        histogram that observed both streams (the fleet-rollup
        guarantee; mismatched boundaries refuse loudly — a lossy
        re-bucketing would silently corrupt the federated tails)."""
        if tuple(other.buckets) != self.buckets:
            raise ValueError(
                f"histogram {self.name!r}: cannot merge mismatched "
                f"bucket boundaries ({len(other.buckets)} vs "
                f"{len(self.buckets)})")
        with other._lock:
            cells = {k: (list(c.counts), c.sum, c.count)
                     for k, c in other._cells.items()}
        for key, (counts, s, n) in cells.items():
            self.merge_cell(key, counts, s, n)

    def merge_cell(self, key: tuple, counts: Sequence[int],
                   s: float, n: int) -> None:
        """Merge one exported cell (bucket counts + sum + count) under
        ``key`` — the primitive both :meth:`merge` and the wire-state
        federation (infra/fleetobs.py) build on."""
        if len(counts) != len(self.buckets) + 1:
            raise ValueError(
                f"histogram {self.name!r}: cell has {len(counts)} "
                f"buckets, expected {len(self.buckets) + 1}")
        key = tuple(sorted((str(k), str(v)) for k, v in key))
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _HistCell(len(self.buckets))
            for i, c in enumerate(counts):
                cell.counts[i] += int(c)
            cell.sum += float(s)
            cell.count += int(n)

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


def _num(v: float) -> str:
    """Prometheus number formatting: integral floats render bare."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class MetricsRegistry:
    """Get-or-create registry; re-registering a name returns the existing
    metric (type mismatch raises — two layers silently recording into
    differently-typed metrics of one name would corrupt both).

    COLLECTORS are scrape-time callbacks: values that are a
    *view of live state* (device memory, queue depth, open fds) rather
    than an event stream would go stale the moment they were set — so a
    collector re-derives them lazily at every ``snapshot()`` /
    ``render_prometheus()``, setting plain gauges the exposition then
    renders. Collector exceptions are swallowed: a broken sampler must
    never take a scrape (or the serving path behind it) down."""

    def __init__(self) -> None:
        self._lock = named_lock("metrics.registry")
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    # -- collectors ------------------------------------------------------

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
        """JSON-friendly view for /api/metrics: per metric the aggregate
        (and per-label-series) counts + p50/p95/p99 quantiles — the
        histogram replacement for the last-call scalars. Collectors run
        first so lazily-sampled gauges are current."""
        self.collect()
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m._snapshot() for m in metrics}

    def render_prometheus(self) -> str:
        """Text exposition format (version 0.0.4). HELP/TYPE headers are
        emitted for every registered metric even before first traffic, so
        scrapers and tests see the full metric surface immediately.
        Collectors run first (scrape-time gauge refresh)."""
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
        """Drop every registered metric (tests). Collectors survive — they
        get-or-create their gauges by name at the next scrape."""
        with self._lock:
            self._metrics.clear()

    # -- portable state -----------------------------

    def export_state(self) -> dict:
        """The registry's full state as a JSON-able dict — the wire
        payload a fleet front door scrapes from each peer (fleetobs's
        MSG_OBS "metrics" op). Unlike the Prometheus text exposition
        this is LOSSLESS for histograms (raw bucket counts travel, not
        quantiles), so the front door's merged rollup interpolates
        quantiles over summed counts exactly as one process would.
        Collectors run first, like every other scrape."""
        self.collect()
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {}
        for m in metrics:
            entry: dict = {"kind": m.kind, "help": m.help}
            with m._lock:
                cells = dict(m._cells)
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
                entry["series"] = [
                    [list(map(list, k)),
                     {"counts": list(c.counts), "sum": c.sum,
                      "count": c.count}]
                    for k, c in cells.items()]
            else:
                entry["series"] = [[list(map(list, k)), v]
                                   for k, v in cells.items()]
            out[m.name] = entry
        return out


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

_span_ids = itertools.count(1)


class Span:
    """One timed unit of work. Attributes are free-form; the serving path
    uses trace_id (task), agent_id, model, round, phase."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "_t0", "ts", "duration_ms", "_tracer")

    def __init__(self, tracer: "Tracer", name: str,
                 trace_id: Optional[str], parent_id: Optional[str],
                 attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = f"s{next(_span_ids):x}"
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0 = time.monotonic()
        self.ts = time.time()
        self.duration_ms: Optional[float] = None
        self._tracer = tracer

    def finish(self, **attrs: Any) -> None:
        if self.duration_ms is not None:
            return                        # idempotent
        if attrs:
            self.attrs.update(attrs)
        self.duration_ms = (time.monotonic() - self._t0) * 1000.0
        self._tracer._emit(self)

    def as_event(self) -> dict:
        return {"event": "span", "ts": self.ts, "name": self.name,
                "trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id,
                "duration_ms": (round(self.duration_ms, 3)
                                if self.duration_ms is not None else None),
                **self.attrs}


class _SpanCtx:
    """Context manager: binds the span as the thread's current on enter,
    restores the previous current and finishes on exit."""

    __slots__ = ("_tracer", "_span", "_bind", "_prev")

    def __init__(self, tracer: "Tracer", span: Span, bind: bool):
        self._tracer = tracer
        self._span = span
        self._bind = bind

    def __enter__(self) -> Span:
        if self._bind:
            self._prev = self._tracer.current()
            self._tracer._set_current(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._bind:
            self._tracer._set_current(self._prev)
        self._span.finish(**({"error": repr(exc)} if exc is not None
                             else {}))


class _UseCtx:
    __slots__ = ("_tracer", "_span", "_prev")

    def __init__(self, tracer: "Tracer", span: Optional[Span]):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Optional[Span]:
        self._prev = self._tracer.current()
        self._tracer._set_current(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        self._tracer._set_current(self._prev)


class Tracer:
    """Thread-local current-span stack + sink fan-out. Sinks receive the
    finished span's event dict; sink exceptions are swallowed (telemetry
    must never take the serving path down)."""

    def __init__(self) -> None:
        self._tls = threading.local()
        self._sinks: list[Callable[[dict], None]] = []
        self._sink_lock = named_lock("tracer.sinks")

    # -- sinks -----------------------------------------------------------

    def add_sink(self, fn: Callable[[dict], None]) -> None:
        with self._sink_lock:
            if fn not in self._sinks:
                self._sinks.append(fn)

    def remove_sink(self, fn: Callable[[dict], None]) -> None:
        with self._sink_lock:
            if fn in self._sinks:
                self._sinks.remove(fn)

    def active(self) -> bool:
        """True when at least one sink would receive finished spans —
        the hot-path guard (scheduler decode ticks, tier restores) that
        keeps span construction off the serving path entirely while
        nothing is listening. Racy by design: a stale read costs one
        span either way, never correctness."""
        return bool(self._sinks)

    def _emit(self, span: Span) -> None:
        with self._sink_lock:
            sinks = list(self._sinks)
        if not sinks:
            return
        event = span.as_event()
        for fn in sinks:
            try:
                fn(event)
            except Exception:             # noqa: BLE001 — telemetry only
                pass

    # -- current-span plumbing ------------------------------------------

    def current(self) -> Optional[Span]:
        return getattr(self._tls, "span", None)

    def _set_current(self, span: Optional[Span]) -> None:
        self._tls.span = span

    def use(self, span: Optional[Span]) -> _UseCtx:
        """Rebind ``span`` as current in THIS thread (cross-thread
        propagation: capture `current()` before the hop, `use()` it
        inside). Restores the previous binding on exit."""
        return _UseCtx(self, span)

    # -- span creation ---------------------------------------------------

    def span(self, name: str, trace_id: Optional[str] = None,
             parent: Optional[Span] = None, bind: bool = True,
             **attrs: Any) -> _SpanCtx:
        """Open a span as a context manager. ``parent`` defaults to the
        thread's current span; ``trace_id`` inherits from the parent.
        ``bind=False`` creates + times the span without making it current
        (for async code on the event loop, where a thread-local binding
        would leak across interleaved tasks)."""
        return _SpanCtx(self, self.start(name, trace_id, parent, **attrs),
                        bind)

    def start(self, name: str, trace_id: Optional[str] = None,
              parent: Optional[Span] = None, **attrs: Any) -> Span:
        """Open an unbound span; the caller must ``finish()`` it."""
        p = parent if parent is not None else self.current()
        tid = trace_id or (p.trace_id if p is not None else None)
        return Span(self, name, tid, p.span_id if p is not None else None,
                    attrs)

    def emit(self, name: str, duration_ms: float,
             trace_id: Optional[str] = None, parent: Optional[Span] = None,
             ts: Optional[float] = None, **attrs: Any) -> None:
        """Retroactive span: a phase whose duration was measured elsewhere
        (e.g. the engine's device-fenced prefill/decode seconds) enters
        the trace after the fact. ``ts`` backdates the span's start so
        timeline assembly (infra/fleetobs.py) orders it where the work
        actually began, not where it was reported."""
        span = self.start(name, trace_id, parent, **attrs)
        span.duration_ms = float(duration_ms)
        if ts is not None:
            span.ts = float(ts)
        self._emit(span)


# ---------------------------------------------------------------------------
# Process-wide defaults + the serving path's named instruments
# ---------------------------------------------------------------------------

METRICS = MetricsRegistry()
TRACER = Tracer()

# Histograms (ms unless noted). Registered at import so GET /metrics
# exposes the full surface before first traffic.
PREFILL_MS = METRICS.histogram(
    "quoracle_prefill_ms", "per-generate prefill device phase (ms)")
DECODE_MS = METRICS.histogram(
    "quoracle_decode_ms", "per-generate decode device phase (ms)")
ROUND_MS = METRICS.histogram(
    "quoracle_round_ms", "one consensus query round: query+parse+validate (ms)")
DECIDE_MS = METRICS.histogram(
    "quoracle_decide_ms", "full ConsensusEngine.decide, refinement included (ms)")
ACTION_MS = METRICS.histogram(
    "quoracle_action_ms", "action executor wall time (ms)")
DECODE_STEP_MS = METRICS.histogram(
    "quoracle_decode_step_ms", "decode phase per emitted token (ms)",
    buckets=tuple(2.0 ** i for i in range(-4, 12)))
PREFIX_LOOKUP_MS = METRICS.histogram(
    "quoracle_prefix_lookup_ms", "radix prefix-cache lookup (ms)",
    buckets=tuple(2.0 ** i for i in range(-6, 8)))
PREFILL_TOKENS_PER_S = METRICS.histogram(
    "quoracle_prefill_tokens_per_s", "per-wave prefill token throughput",
    buckets=THROUGHPUT_BUCKETS)
JIT_COMPILES = METRICS.counter(
    "quoracle_jit_compiles_total",
    "first-call shape-bucket compiles per engine (cache-miss rounds)")
ROUNDS_TOTAL = METRICS.counter(
    "quoracle_consensus_rounds_total", "consensus query rounds run")
ACTIONS_TOTAL = METRICS.counter(
    "quoracle_actions_total", "actions executed, labeled by status")
LIVE_AGENTS = METRICS.gauge(
    "quoracle_live_agents", "live agents at last scrape")
KV_FREE_PAGES = METRICS.gauge(
    "quoracle_kv_free_pages", "free KV pool pages per engine at last scrape")

# -- resource observability ---------------------------------------
# HBM accounting gauges are COLLECTOR-refreshed (infra/resources.py sets
# them from the CUDA allocator at scrape time).
HBM_USED_BYTES = METRICS.gauge(
    "quoracle_hbm_used_bytes", "device memory in use, per device")
HBM_LIMIT_BYTES = METRICS.gauge(
    "quoracle_hbm_limit_bytes", "device memory capacity, per device")
HBM_HEADROOM_RATIO = METRICS.gauge(
    "quoracle_hbm_headroom_ratio",
    "min over devices of (limit - used) / limit; -1 when no device "
    "reports a limit")
HBM_COMPONENT_BYTES = METRICS.gauge(
    "quoracle_hbm_component_bytes",
    "per-engine HBM attribution: params / kv_pool / prefix_cache bytes")
COMPILE_HITS = METRICS.counter(
    "quoracle_compile_cache_hits_total",
    "generate() dispatches whose (model, shape-bucket) was already "
    "compiled (models/generate.py CompileRegistry)")
COMPILE_MISSES = METRICS.counter(
    "quoracle_compile_cache_misses_total",
    "first-dispatch (model, shape-bucket) compiles")
COMPILE_MISSES_IN_WINDOW = METRICS.gauge(
    "quoracle_compile_misses_in_window",
    "compile misses inside the storm window, per model")
COMPILE_STORM = METRICS.gauge(
    "quoracle_compile_storm",
    "1 while a model's compile misses exceed the storm threshold "
    "inside the window (recompile storm), else 0")
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
# -- ragged serving kernel ----------------------------------------
# Padding-waste accounting for the serving hot path: per generate call
# (one continuous-batcher tick), the chunk-token slots the device actually
# processed vs the tick's REAL tokens. The bucketed paths pad every tick
# to a [batch-bucket × prompt-bucket] rectangle; the unified ragged kernel
# processes per-row tq-aligned segments — the delta between these two
# counters is exactly what raggedness reclaims (the bench's headline).
SCHED_REAL_TOKENS_TOTAL = METRICS.counter(
    "quoracle_sched_real_tokens_total",
    "real chunk tokens submitted across generate ticks, per model")
SCHED_PADDED_TOKENS_TOTAL = METRICS.counter(
    "quoracle_sched_padded_tokens_total",
    "device chunk-token slots processed across generate ticks (real + "
    "padding), per model — [B·T] on the bucketed paths, the flat token "
    "budget on the unified ragged path")
SCHED_PAD_WASTE_RATIO = METRICS.gauge(
    "quoracle_sched_pad_waste_ratio",
    "last tick's (padded - real) / padded chunk-token waste, per model")
WATCHDOG_STALLS = METRICS.counter(
    "quoracle_watchdog_stalls_total",
    "stall-watchdog trips (decode loop made no progress past deadline)")
WATCHDOG_STALLED = METRICS.gauge(
    "quoracle_watchdog_stalled",
    "1 while a watched source is tripped, per source")
PREFIX_CACHE_PAGES = METRICS.gauge(
    "quoracle_prefix_cache_pages",
    "radix prefix-cache occupancy per model: kind = resident | "
    "referenced | evictable")

# -- serving QoS ---------------------------------------------------
# Admission control + weighted-fair scheduling (serving/):
# every admit/shed decision and the per-class queue/latency state.
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

# -- speculative serving -------------------------------------------
# Batched draft/verify decoding in the continuous serving path
# (models/speculative.py BatchedSpeculator): per-member acceptance,
# realized tokens-per-round, adaptive-K state, and fallback attribution —
# the scorecard inputs for /api/models and the /telemetry view.
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

# -- tiered KV -----------------------------------------------------
# Host offload + session hibernation + the disk prefix store
# (serving/kvtier.py TierManager): tier occupancy, demote/restore flow,
# and restore latency — the observability contract of the capacity layer.
KV_TIER_BYTES = METRICS.gauge(
    "quoracle_kv_tier_bytes",
    "KV bytes resident per tier (hbm | host | disk), per model — "
    "collector-refreshed (infra/resources.py)")
KV_TIER_ENTRIES = METRICS.gauge(
    "quoracle_kv_tier_entries",
    "entries per tier and kind (session | prefix), per model")
KV_DEMOTES_TOTAL = METRICS.counter(
    "quoracle_kv_demotes_total",
    "HBM→host demotions by kind (session | prefix), per model — "
    "eviction that preserved state instead of destroying it")
KV_RESTORES_TOTAL = METRICS.counter(
    "quoracle_kv_restores_total",
    "host/disk→HBM restores by kind and source, per model — touches "
    "served by page-in instead of re-prefill")
KV_RESTORE_MS = METRICS.histogram(
    "quoracle_kv_restore_ms",
    "page-in latency per restore (ms), by kind — compare against "
    "quoracle_prefill_ms for the hibernation win")
KV_DISK_SPILLS_TOTAL = METRICS.counter(
    "quoracle_kv_disk_spills_total",
    "prefix blocks written to the checksummed disk store, per model")
KV_DISK_LOADS_TOTAL = METRICS.counter(
    "quoracle_kv_disk_loads_total",
    "disk prefix loads by status (ok | corrupt), per model — corrupt "
    "entries are skipped and unlinked, never served")
KV_HOST_EVICTIONS_TOTAL = METRICS.counter(
    "quoracle_kv_host_evictions_total",
    "host-tier LRU evictions by kind (session | prefix), per model")
KV_ALLOC_DRIFT_TOTAL = METRICS.counter(
    "quoracle_kv_alloc_drift_total",
    "SessionStore.alloc accounting-drift refusals (the formerly silent "
    "defensive branch), per model — any nonzero value is a bug report")

# -- quantized serving --------------------------------------------
# Int8 weights + int8 KV pages (models/quant.py): the byte-economy
# instruments — bytes each tier move avoided shipping, the per-token KV
# rate capacity planning actually gets, and the dequant-path program
# identity — so a quantized member's 2x capacity claim is auditable
# from /metrics.
QUANT_BYTES_SAVED_TOTAL = METRICS.counter(
    "quoracle_quant_bytes_saved_total",
    "bytes NOT held or shipped because a member serves int8, by tier "
    "(weights | demote | disk_spill | handoff), per model — each event "
    "counts the bf16-equivalent minus the actual int8+scales bytes")
QUANT_KV_BYTES_PER_TOKEN = METRICS.gauge(
    "quoracle_quant_kv_bytes_per_token",
    "pool bytes per resident KV token (int8 payload + per-(token, "
    "kv-head) fp32 scales) for quantized members — compare against "
    "2·L·KV·hd·2 for the bf16 rate the member would otherwise pay")
QUANT_DEQUANT_COMPILES_TOTAL = METRICS.counter(
    "quoracle_quant_dequant_compiles_total",
    "compile-ledger misses booked by quantized-KV engines, per model — "
    "the dequant path's program identities; a storm here is the same "
    "capacity incident as quoracle_compile_cache_misses_total")

# -- disaggregated serving plane ----------------------------------
# Cluster/router/handoff instruments (serving/cluster.py, router.py,
# handoff.py): replica topology, placement flow, and the prefill→decode
# KV handoff — the observability contract of the multi-replica layer.
CLUSTER_REPLICAS = METRICS.gauge(
    "quoracle_cluster_replicas",
    "replicas registered in the cluster plane, by role "
    "(prefill | decode | unified) and liveness (alive | dead)")
CLUSTER_REQUESTS_TOTAL = METRICS.counter(
    "quoracle_cluster_requests_total",
    "requests the cluster plane served, by replica and path "
    "(disagg | affinity | unified | image | failover)")
CLUSTER_HANDOFFS_TOTAL = METRICS.counter(
    "quoracle_cluster_handoffs_total",
    "prefill→decode KV handoffs by status (ok | export_failed | "
    "signature_mismatch | replaced | replace_failed), per model")
CLUSTER_HANDOFF_MS = METRICS.histogram(
    "quoracle_cluster_handoff_ms",
    "KV handoff latency (ms): prefill-side hibernate through decode-side "
    "adopt — compare against quoracle_prefill_ms for the re-prefill it "
    "replaces")
ROUTER_PLACEMENTS_TOTAL = METRICS.counter(
    "quoracle_router_placements_total",
    "router placement decisions, by role and reason "
    "(affinity | least_loaded | only | failover)")
ROUTER_SHED_TOTAL = METRICS.counter(
    "quoracle_router_shed_total",
    "submissions shed at the cluster front door because every eligible "
    "replica's admission controller rejected them, by class and tenant")
ROUTER_SIGNAL_AGE_MS = METRICS.histogram(
    "quoracle_router_signal_age_ms",
    "age of the per-replica admission signal snapshot at placement time "
    "(ms) — large values mean the router is steering on stale load data")

# -- cluster fabric -----------------------------------------------
# Wire-layer instruments (serving/fabric/): every cross-host exchange —
# handoffs, placements, prefix fetches — is one framed request/response,
# so the fabric's health is legible as request/retry/reject series plus
# an RTT histogram per operation.
FABRIC_REQUESTS_TOTAL = METRICS.counter(
    "quoracle_fabric_requests_total",
    "fabric wire requests by op (serve | prefill | decode | signals | "
    "admit | prefix_get | prefix_put | hello | stats | ...) and status "
    "(ok | error | unreachable)")
FABRIC_RTT_MS = METRICS.histogram(
    "quoracle_fabric_rtt_ms",
    "round-trip latency (ms) of one fabric request by op — includes "
    "retries/backoff, so a flapping link widens this tail before it "
    "trips unreachable")
FABRIC_RETRIES_TOTAL = METRICS.counter(
    "quoracle_fabric_retries_total",
    "fabric request retry attempts by op — a rising rate means a lossy "
    "or flapping peer link the bounded backoff is still absorbing")
FABRIC_FRAME_REJECTS_TOTAL = METRICS.counter(
    "quoracle_fabric_frame_rejects_total",
    "wire frames rejected at the codec boundary, by reason (crc | "
    "truncated | magic | version | oversize) — corruption and version "
    "skew are rejected structurally, never adopted")
FABRIC_BYTES_TOTAL = METRICS.counter(
    "quoracle_fabric_bytes_total",
    "bytes moved over fabric TCP transports, by direction "
    "(sent | received)")
FABRIC_PEERS = METRICS.gauge(
    "quoracle_fabric_peers",
    "remote peers registered at the fabric front door, by role "
    "(prefill | decode | unified) and liveness (alive | dead)")
FABRIC_PREFIXD_TOTAL = METRICS.counter(
    "quoracle_fabric_prefixd_total",
    "fleet prefix-service client operations, by op (get | put) and "
    "status (hit | miss | stored | dup | error) — the error rate is "
    "the prefixd-unavailable alert input")

# -- chaos plane --------------------------------------------------
# Deterministic fault injection (chaos/faults.py) + the scenario harness
# (chaos/scenarios.py): every fired fault and every machine-checked
# invariant verdict is a first-class series, so a game-day run is
# attributable from /metrics alone.
CHAOS_ARMED = METRICS.gauge(
    "quoracle_chaos_armed",
    "1 while a FaultPlan is armed on the process-wide chaos plane — "
    "production should alert on this outside announced game-day windows")
CHAOS_FAULTS_TOTAL = METRICS.counter(
    "quoracle_chaos_faults_total",
    "faults fired by the chaos plane, by injection point and kind "
    "(crash | slow | garbage | drop | delay | corrupt | poison | fail | "
    "demote)")
CHAOS_SCENARIOS_TOTAL = METRICS.counter(
    "quoracle_chaos_scenarios_total",
    "chaos scenario runs by scenario name and result (pass | fail)")
CHAOS_INVARIANT_FAILURES = METRICS.counter(
    "quoracle_chaos_invariant_failures_total",
    "invariant checks that FAILED during a chaos scenario, by scenario "
    "and invariant name — any nonzero value is a recovery-path bug "
    "report, alert like a crash")

# -- elastic fleet controller -------------------------------------
# Signal-driven autoscaling + role re-tiering + live session migration
# (serving/fleet.py): every policy action, every migrated session, and
# the drain latency are first-class series — a scale event must be as
# attributable from /metrics as a shed or a handoff.
FLEET_ACTIONS_TOTAL = METRICS.counter(
    "quoracle_fleet_actions_total",
    "fleet-controller policy actions executed, by action (scale_up | "
    "scale_down | retier | drain) and target role — the action ledger's "
    "counter twin; a flapping rate here means the hysteresis bounds are "
    "too tight for the traffic")
FLEET_TICKS_TOTAL = METRICS.counter(
    "quoracle_fleet_ticks_total",
    "fleet-controller policy ticks evaluated, by outcome (action | "
    "hold | cooldown) — the denominator that turns the action counter "
    "into a flap rate")
FLEET_SESSIONS_MIGRATED_TOTAL = METRICS.counter(
    "quoracle_fleet_sessions_migrated_total",
    "sessions live-migrated off a draining replica through the handoff "
    "path, by model and status (ok | failed) — failed means the session "
    "degraded to a re-prefill on its next touch, never wrong bits")
FLEET_DRAIN_MS = METRICS.histogram(
    "quoracle_fleet_drain_ms",
    "wall time (ms) of one replica drain: settle-wait through the last "
    "session's migration — the zero-downtime retirement budget")
FLEET_DRAINING = METRICS.gauge(
    "quoracle_fleet_draining",
    "replicas currently draining (new placements excluded, affinities "
    "still serving until each session's migration lands)")

# -- fleet observability ------------------------------------------
# Cross-process tracing + metrics federation + correlated incident
# capture (infra/fleetobs.py): span-ring health, the front door's
# peer-scrape loop, and the incident ledger — the observability OF the
# observability layer, so a starved trace ring or a stale federation
# window is itself alertable.
TRACE_DROPPED_TOTAL = METRICS.counter(
    "quoracle_trace_dropped_total",
    "finished spans dropped on span-ring overflow, per ring "
    "(fleetobs | history) — the ring overwrites oldest-first; a "
    "sustained rate means serving traffic is starving consensus traces "
    "and the ring size / decode-tick sample knobs need retuning")
FLEETOBS_SCRAPE_MS = METRICS.histogram(
    "quoracle_fleetobs_scrape_ms",
    "wall time (ms) of one fleet metrics-federation sweep: every "
    "peer's MSG_OBS metrics state pulled + merged at the front door")
FLEETOBS_PEERS = METRICS.gauge(
    "quoracle_fleetobs_peers",
    "peers in the last federation sweep, by status (ok | failed) — a "
    "failed peer's series go stale in the rollup until it answers")
FLEETOBS_STALENESS_S = METRICS.gauge(
    "quoracle_fleetobs_staleness_s",
    "age of the last successful federation sweep at scrape time — the "
    "federation-staleness alert input (DEPLOY §16)")
FLEETOBS_SLO_BURN = METRICS.gauge(
    "quoracle_fleetobs_slo_burn",
    "max INTERACTIVE SLO-burn ratio reported by any peer in the last "
    "federation sweep — the fleet-wide worst-tail gauge")
FLEETOBS_GOODPUT = METRICS.gauge(
    "quoracle_fleetobs_goodput_tokens_per_s",
    "fleet-wide goodput (real chunk tokens/s summed over peers) "
    "computed from consecutive federation sweeps' counter deltas")
INCIDENTS_TOTAL = METRICS.counter(
    "quoracle_incidents_total",
    "correlated incidents opened, by kind (watchdog | replica_dead | "
    "chaos_invariant | manual) — each one is a retention-pruned bundle "
    "of every reachable peer's flight-ring dump under one incident id")

# -- fleet simulator ----------------------------------------------
# Deterministic workload simulator (the JAX package's sim/, not ported): per-replay
# traffic/outcome counters and the modeled-fleet gauges the /telemetry
# sim panel and GET /api/sim read. Instruments carry MODELED quantities
# (virtual-clock TTFT, virtual goodput) — they share the registry so
# one scrape shows real and simulated planes side by side, but nothing
# here is a chip measurement.
SIM_EVENTS_TOTAL = METRICS.counter(
    "quoracle_sim_events_total",
    "trace events replayed, by workload stream and modeled outcome "
    "(ok | shed | deadline) — flushed once per replay, not per event")
SIM_REPLAYS_TOTAL = METRICS.counter(
    "quoracle_sim_replays_total",
    "completed trace replays, by mode (compressed | paced) and result")
SIM_TTFT_MS = METRICS.histogram(
    "quoracle_sim_ttft_ms",
    "modeled time-to-first-token (virtual ms: queue wait + tier "
    "restore + prefill) for admitted events, by class — sampled every "
    "16th event on large traces",
    buckets=(1, 5, 20, 50, 100, 250, 500, 1_000, 1_500, 3_000, 6_000,
             15_000))
SIM_GOODPUT = METRICS.gauge(
    "quoracle_sim_goodput_tokens_per_s",
    "delivered tokens per VIRTUAL second over the last replayed trace")
SIM_SESSIONS = METRICS.gauge(
    "quoracle_sim_sessions",
    "virtual sessions by final ladder tier (resident | host | disk | "
    "prefixd | dropped) after the last replay — the conservation "
    "census the sim gate checks")
SIM_GATE_FAILURES = METRICS.counter(
    "quoracle_sim_gate_failures_total",
    "sim scenarios that failed at least one workload invariant, by "
    "scenario — the acceptance gate's alarm counter")

# -- chip economics -----------------------------------------------
# Chip-economics plane (infra/costobs.py): per-stage chip-second
# attribution, roofline/MFU per compiled program, per-decide cost
# rollups, and tenant error budgets. Everything here is READ-ONLY
# measurement — the attribution invariant (stage chip-seconds sum to
# engine busy wall, exactly) and the temp-0 on/off bit-equality gate
# both depend on these series never touching the serving path.
COST_CHIP_MS_TOTAL = METRICS.counter(
    "quoracle_cost_chip_ms_total",
    "device wall (ms, float) charged by the ChipLedger, by model, "
    "stage (prefill | decode | verify | restore) and tenant class — "
    "tenant='overhead' rows are padding/ragged waste; the sum over all "
    "labels equals the engine's measured busy wall by construction")
COST_DECIDE_CHIP_MS = METRICS.histogram(
    "quoracle_cost_decide_chip_ms",
    "measured chip-ms one consensus decide consumed across all member "
    "generates and verify chunks — the denominator of the adaptive-"
    "consensus roadmap item's tokens-per-chip objective")
COST_DECIDE_TOKENS = METRICS.histogram(
    "quoracle_cost_decide_tokens",
    "completion tokens one consensus decide consumed across all pool "
    "members and rounds (tokens-per-decide, the adaptive-consensus "
    "baseline)",
    buckets=(8, 16, 32, 64, 128, 256, 512, 1_024, 2_048, 4_096,
             8_192, 16_384))
COST_GOODPUT_PER_CHIP = METRICS.gauge(
    "quoracle_cost_goodput_per_chip_s",
    "fleet-wide real chunk tokens per CHIP-SECOND, computed at the "
    "front door from consecutive federation sweeps' token and chip-ms "
    "counter deltas — the elastic fleet's cost objective input")
MFU_RATIO = METRICS.histogram(
    "quoracle_mfu_ratio",
    "model FLOPs utilization per charged step: analytic FLOPs of the "
    "ragged kernel/matmuls (geometry x real tokens, int8-aware) over "
    "measured step wall x device peak, by model, stage and padded "
    "token bucket — a cliff at a fixed bucket means a recompile or "
    "padding regression",
    buckets=(0.005, 0.01, 0.02, 0.04, 0.08, 0.15, 0.25, 0.4, 0.6, 0.8,
             1.0))
MFU_HBM_BOUND = METRICS.gauge(
    "quoracle_mfu_hbm_bound",
    "1 while the roofline model says the program's last observation "
    "was HBM-bandwidth-bound (bytes/peak_bw > flops/peak_flops), per "
    "model and stage — decode at small batch should sit at 1")
MFU_CLIFFS_TOTAL = METRICS.counter(
    "quoracle_mfu_cliffs_total",
    "MFU-cliff crossings per model, stage and padded token bucket — "
    "an observation fell below half the program's running best; the "
    "mfu_cliff flight event's counter twin and the DEPLOY §18 alert "
    "input (a recompile or padding regression eating chip-seconds)")
BUDGET_BURN_RATE = METRICS.gauge(
    "quoracle_budget_burn_rate",
    "error-budget burn rate per tenant class and window (1h | 6h): "
    "observed error fraction over the window divided by the class SLO "
    "error allowance — 1.0 burns the whole budget in exactly one "
    "window; the multi-window alert input (DEPLOY §18)")
BUDGET_REMAINING_RATIO = METRICS.gauge(
    "quoracle_budget_remaining_ratio",
    "fraction of the tenant class's 6h error budget still unburned "
    "(1.0 = untouched, 0 = exhausted) — floor-clamped at 0")
BUDGET_EVENTS_TOTAL = METRICS.counter(
    "quoracle_budget_events_total",
    "requests scored against a tenant-class error budget, by class "
    "and outcome (ok | error) — errors are sheds, deadline drops and "
    "SLO misses; the budget denominator")

# -- liveness & hotspot plane -------------------------------------
# Introspection plane (infra/introspect.py): progress-heartbeat stall
# detection, sampled wall-clock profiling, and per-row wait-state
# decomposition. Read-only measurement like the chip-economics series
# above — temp-0 on/off bit-equality depends on none of these touching
# a serving decision.
INTROSPECT_STALLS_TOTAL = METRICS.counter(
    "quoracle_introspect_stalls_total",
    "stall-detector trips per progress source — an ACTIVE source whose "
    "heartbeat froze for two intervals; each trip ships an all-thread "
    "stack + lock-holder incident bundle (DEPLOY §19 StallDetected)")
INTROSPECT_PROFILE_SAMPLES = METRICS.counter(
    "quoracle_introspect_profile_samples_total",
    "wall-clock profiler sampling ticks folded into collapsed-stack "
    "windows — the /api/profile hotspot denominator")
INTROSPECT_OVERHEAD_RATIO = METRICS.gauge(
    "quoracle_introspect_profiler_overhead_ratio",
    "observed fraction of process wall the frame sampler itself "
    "consumed since start — self-measured, gated at 1 percent for the default "
    "rate by bench config 24 (DEPLOY §19 ProfilerOverhead)")
INTROSPECT_WAIT_MS = METRICS.histogram(
    "quoracle_introspect_wait_ms",
    "per-row wait-state decomposition by state (admission | queue | "
    "dispatch | kv_restore | wire | lock | other) and model — the "
    "named waits plus the exact integer-ns remainder bucket sum to "
    "each row's observed wall by construction",
    buckets=(0.1, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1_000,
             2_500, 5_000, 10_000))
INTROSPECT_WAIT_SKEW_TOTAL = METRICS.counter(
    "quoracle_introspect_wait_skew_total",
    "rows whose measured sub-waits overran the observed wall (clock "
    "skew / overlapping measurements) and were deterministically "
    "trimmed to preserve the sum-to-wall invariant — a steady rate "
    "means an instrumentation bug (DEPLOY §19 WaitStateSkew)")

# -- serving flywheel ---------------------------------------------
# Training plane (the JAX package's training/, not ported): replay capture store,
# draft-distillation trainer, and the bench-gated promotion pipeline.
# The capture series is read-only measurement like the two planes above
# — temp-0 on/off bit-equality depends on capture never touching a
# serving decision (QUORACLE_TRAIN_CAPTURE=0 kills the whole plane).
TRAIN_CAPTURE_RECORDS_TOTAL = METRICS.counter(
    "quoracle_train_capture_records_total",
    "capture-plane record dispositions by source (spec | consensus) "
    "and status (ok | sampled_out | dropped) — dropped counts faults "
    "and errors the serving path absorbed without blocking")
TRAIN_CAPTURE_BYTES = METRICS.gauge(
    "quoracle_train_capture_bytes",
    "sealed on-disk bytes in the replay capture store — maintained "
    "incrementally (O(1), no per-scrape directory walk) and bounded "
    "by --capture-mb (DEPLOY §20 CaptureStoreFull)")
TRAIN_CAPTURE_EVICTIONS_TOTAL = METRICS.counter(
    "quoracle_train_capture_evictions_total",
    "oldest capture segments unlinked to hold the size budget — a "
    "steady rate means the budget is smaller than the retention the "
    "trainer needs (DEPLOY §20 CaptureStoreFull)")
TRAIN_STEPS_TOTAL = METRICS.counter(
    "quoracle_train_steps_total",
    "optimizer steps taken by the pjit distillation trainer, by model")
TRAIN_LOSS = METRICS.gauge(
    "quoracle_train_loss",
    "last observed distillation loss (weighted CE against recorded "
    "target tokens), by model")
TRAIN_EVAL_ACCEPTANCE = METRICS.gauge(
    "quoracle_train_eval_acceptance",
    "offline replay acceptance through the real verify_chunk path, by "
    "model, role (candidate | incumbent) and stat (p50 | p95 | mean) — "
    "the promotion gate's evidence")
TRAIN_PROMOTIONS_TOTAL = METRICS.counter(
    "quoracle_train_promotions_total",
    "draft promotion attempts by model and outcome (promoted | "
    "rejected | failed | rolled_back) — failed means the hot-swap "
    "aborted mid-fleet and the incumbent was restored; rolled_back "
    "means the live acceptance guard tripped after promotion "
    "(DEPLOY §20 PromotionRollback / AcceptanceRegression)")

# -- session-graph observability ----------------------------------
# Agent-tree plane (infra/treeobs.py): lineage registry and subtree
# rollups over what the planes above already measure. Read-only like
# costobs/introspect — temp-0 on/off bit-equality depends on tree
# bookkeeping never touching a serving decision (QUORACLE_TREEOBS=0
# kills the whole plane).
TREE_NODES_TOTAL = METRICS.counter(
    "quoracle_tree_nodes_total",
    "agent-tree node registrations by event (spawned | completed) — "
    "the spawned-minus-completed gap is the live node census")
TREE_ORPHANS_TOTAL = METRICS.counter(
    "quoracle_tree_orphans_total",
    "nodes flagged orphaned at tree assembly: the parent record is "
    "missing (its peer crashed before federation) — flagged, never "
    "silently unparented (DEPLOY §21 TreeOrphanRate)")
TREE_BUDGET_OVERRUNS_TOTAL = METRICS.counter(
    "quoracle_tree_budget_overruns_total",
    "subtrees that overspent the token budget inherited at spawn — "
    "observed only, no policy acts on it (DEPLOY §21 "
    "TreeBudgetOverrun)")
TREE_DEPTH = METRICS.histogram(
    "quoracle_tree_depth",
    "spawn depth of each registered agent-tree node (root = 0) — a "
    "drifting upper tail is runaway recursion (DEPLOY §21 "
    "TreeDepthRunaway)",
    buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16, 24))
TREE_FANOUT = METRICS.gauge(
    "quoracle_tree_fanout",
    "mean children per node at each depth over the registry's current "
    "window, by depth — the fan-out prior exported read-only into "
    "FleetSignals for the elastic-fleet roadmap item")

# -- consensus quality ---------------------------------------------
# Decision-quality instruments (consensus/quality.py): per-decide
# contestedness and the per-member scorecard counters. Registered at
# import so the full quoracle_consensus_* surface scrapes before first
# traffic, like everything above.
# -- lock discipline -----------------------------------------------
# Runtime lock-order sanitizer (analysis/lockdep.py): inversions seen by
# the tier-1 suite (conftest enables QUORACLE_LOCKDEP) or a production
# process run with the env flag. Any nonzero value is a latent ABBA
# deadlock report — alert on it like a crash, not like a latency burn.
LOCKDEP_INVERSIONS = METRICS.counter(
    "quoracle_lockdep_inversions_total",
    "lock-order inversions observed by the runtime sanitizer, labeled "
    "by the acquiring and held lock names — any nonzero value is a "
    "latent ABBA deadlock report")

CONSENSUS_ENTROPY = METRICS.histogram(
    "quoracle_consensus_vote_entropy_bits",
    "Shannon entropy (bits) of the cluster-share distribution per decide: "
    "0 = unanimous, log2(k) = k-way even split",
    buckets=(0.01, 0.05, 0.1, 0.2, 0.35, 0.5, 0.7, 0.92, 1.1, 1.4,
             1.59, 2.0, 2.33, 3.0))
CONSENSUS_MARGIN = METRICS.histogram(
    "quoracle_consensus_winner_margin",
    "winner share minus runner-up share per decide (1 = unanimous, "
    "0 = tiebroken)",
    buckets=(0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0))
CONSENSUS_ROUNDS_TO_DECISION = METRICS.histogram(
    "quoracle_consensus_rounds_to_decision",
    "rounds a decide needed (1 = round-1 consensus)",
    buckets=(1, 2, 3, 4, 5, 6, 8))
CONSENSUS_SIM_MARGIN = METRICS.histogram(
    "quoracle_consensus_similarity_margin",
    "|cosine - threshold| of semantic-compatibility checks during "
    "clustering, side = above (joined) | below (split): mass near 0 "
    "means clusters are forming on a knife edge",
    buckets=(0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6))
MEMBER_DECIDES = METRICS.counter(
    "quoracle_consensus_member_decides_total",
    "decides a pool member participated in, per model")
MEMBER_AGREEMENTS = METRICS.counter(
    "quoracle_consensus_member_agreement_total",
    "decides where the member's valid proposal landed in the winning "
    "cluster, per model")
MEMBER_DISSENTS = METRICS.counter(
    "quoracle_consensus_member_dissent_total",
    "decides where the member's valid proposal lost to another cluster, "
    "per model")
MEMBER_FAILURES = METRICS.counter(
    "quoracle_consensus_member_failures_total",
    "member failures by cause, per model and kind "
    "(transport | parse | schema | deadline)")
MEMBER_RECOVERIES = METRICS.counter(
    "quoracle_consensus_member_recoveries_total",
    "decides where a corrected member produced a valid proposal in a "
    "later round, per model")
MEMBER_LATENCY_MS = METRICS.histogram(
    "quoracle_consensus_member_latency_ms",
    "per-decide summed proposal latency per pool member (ms)")
MEMBER_DRIFT_EVENTS = METRICS.counter(
    "quoracle_consensus_drift_total",
    "model_health_drift trips per model and signal (dissent | failure)")
MEMBER_DRIFTING = METRICS.gauge(
    "quoracle_consensus_member_drifting",
    "1 while a member's recent dissent/failure EWMA deviates from its "
    "baseline past the drift threshold, per model and signal")

# Process self-observation: sampled lazily by the
# collector below so /api/metrics and GET /metrics always carry a current
# view — no writer has to remember to refresh them.
_PROC_T0 = time.monotonic()


def open_fd_count() -> Optional[int]:
    """Open file descriptors of this process (Linux /proc; None where the
    kernel doesn't expose it)."""
    import os
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def _process_collector() -> None:
    import threading as _threading
    METRICS.gauge("quoracle_process_uptime_s",
                  "seconds since telemetry import").set(
        round(time.monotonic() - _PROC_T0, 3))
    METRICS.gauge("quoracle_process_threads",
                  "live threads at scrape").set(
        _threading.active_count())
    fds = open_fd_count()
    if fds is not None:
        METRICS.gauge("quoracle_process_open_fds",
                      "open file descriptors at scrape").set(fds)


METRICS.register_collector(_process_collector)
