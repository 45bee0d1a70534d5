"""Fleet-scope observability of the PyTorch port (the port's copy of
``quoracle_tpu/infra/fleetobs.py``).

Tracing, the flight recorder and the metrics stop at the process
boundary; this module is the cross-process glue, four primitives:

* **TraceContext** — a compact (trace_id, span_id) pair that rides
  ``QueryRequest.trace``, batcher rows, the HandoffEnvelope wire
  header, and fabric RPC payloads, so a receiving peer can rebind
  ``TRACER`` and its spans (admit, queue-wait, prefill, kv-export,
  wire-transfer, adopt, decode, migration, retire) land in the SAME
  trace the front door opened. A TraceContext is itself a valid
  ``parent=`` for ``Tracer.start/emit`` (it exposes ``trace_id`` /
  ``span_id``), which is the whole propagation mechanism — no tracer
  surgery, just a remote parent.
* **SpanRing** — a process-wide bounded ring of finished spans
  (``SPANS``; ``ensure_ring()`` installs it as a TRACER sink) that the
  new wire op serves per ``session_id``/``trace_id``, so a front door
  can pull every peer's slice of one session's lifecycle and
  :func:`assemble_timeline` orders them into a single timeline with
  per-stage TTFT attribution. Ring overflow is COUNTED
  (``quoracle_trace_dropped_total``), the capacity is configurable
  (``QUORACLE_TRACE_RING``), and decode-tick spans are sampled
  (``QUORACLE_TRACE_DECODE_SAMPLE``) so serving traffic cannot starve
  consensus traces out of the ring.
* **federate** — lossless metrics federation: each peer exports its
  registry's raw state (``MetricsRegistry.export_state`` — bucket
  COUNTS, not quantiles), the front door merges identical-boundary
  histograms by summed counts and serves one Prometheus rollup with
  per-peer labels plus ``peer="fleet"`` aggregates whose interpolated
  quantiles equal what one process observing every stream would
  report (tier-1 asserted against a hand-fed oracle).
* **IncidentManager** — correlated incident capture: watchdog trips,
  chaos invariant failures, and replica deaths stamp a DETERMINISTIC
  incident id (sha256 over kind:key:occurrence — no wall clock, the
  chaos plane's idiom), dump the local flight ring into a bundle
  directory, and broadcast the id over the fabric so every reachable
  peer's dump lands in the SAME retention-pruned bundle, served at
  ``GET /api/incidents``.

Tracing off (no TRACER sinks) leaves the serving fast path untouched:
every hot-path emit is guarded by ``TRACER.active()`` and span
recording never touches RNG or device state, so temp-0 outputs are
bit-identical with tracing on or off (tests/test_torch_obs_serving.py).

The fabric (the wire ops that pull rings and broadcast incidents) is not
in the port yet: the notifier seam of :class:`IncidentManager` stays, with
nothing attached.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from collections import deque
from typing import Any, Iterable, Optional, Sequence

from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.telemetry import (
    INCIDENTS_TOTAL, METRICS, TRACE_DROPPED_TOTAL, TRACER, Histogram,
    MetricsRegistry,
)

DEFAULT_SPAN_RING = 512
DEFAULT_DECODE_TICK_SAMPLE = 16
DEFAULT_INCIDENT_RETENTION = 8


# ---------------------------------------------------------------------------
# Trace context propagation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The two ids that cross a process boundary. Shaped like a span's
    linkage fields on purpose: ``Tracer.start(parent=ctx)`` reads
    exactly ``trace_id`` and ``span_id``, so a TraceContext IS a valid
    remote parent."""

    trace_id: str
    span_id: str

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_dict(cls, d: Any) -> Optional["TraceContext"]:
        """None on anything malformed — a foreign or un-upgraded peer's
        payload must never make trace plumbing raise."""
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not (isinstance(tid, str) and tid
                and isinstance(sid, str) and sid):
            return None
        return cls(trace_id=tid, span_id=sid)

    @classmethod
    def current(cls) -> Optional["TraceContext"]:
        """The calling thread's current span as a portable context (the
        stamp every wire payload carries), or None outside any span."""
        span = TRACER.current()
        if span is None or span.trace_id is None:
            return None
        return cls(trace_id=span.trace_id, span_id=span.span_id)

    @classmethod
    def from_span(cls, span) -> Optional["TraceContext"]:
        if span is None or getattr(span, "trace_id", None) is None:
            return None
        return cls(trace_id=span.trace_id, span_id=span.span_id)


_trace_seq_lock = named_lock("fleetobs.incidents")
_trace_seq = [0]


def fresh_trace_id(hint: Optional[str] = None) -> str:
    """A new root trace id for a request that arrived without one (the
    front door is the outermost traced layer for serving traffic)."""
    with _trace_seq_lock:
        _trace_seq[0] += 1
        n = _trace_seq[0]
    return f"tr-{hint}-{n}" if hint else f"tr-{n}"


def request_span(name: str, session_id: Optional[str] = None,
                 **attrs: Any):
    """The serving plane's root-span helper: a no-op context manager
    while nothing is tracing (the fast path stays untouched), else a
    bound span that inherits the current trace or mints a fresh root
    trace id — every downstream span (peer legs included, via the wire
    context) then shares ONE trace."""
    import contextlib
    if not TRACER.active():
        return contextlib.nullcontext()
    if session_id:
        attrs["session"] = session_id
    cur = TRACER.current()
    trace_id = None
    if cur is None or cur.trace_id is None:
        trace_id = fresh_trace_id(session_id)
    return TRACER.span(name, trace_id=trace_id, **attrs)


def tag_current_span(session_id: Optional[str]) -> None:
    """Late session binding: a sessionless request's id is minted
    mid-flight (the handoff id); stamp it onto the enclosing request
    span so session-filtered timelines include the root."""
    if not session_id:
        return
    cur = TRACER.current()
    if cur is not None and "session" not in cur.attrs:
        cur.attrs["session"] = session_id


def bind_remote(ctx: Optional[TraceContext]):
    """Rebind TRACER in the receiving thread so spans opened while the
    context manager is active parent onto the REMOTE span that shipped
    the request — ``with fleetobs.bind_remote(ctx): ...`` on the peer
    side is the whole cross-process story. A None ctx binds nothing
    (spans root locally, exactly the un-traced behavior)."""
    return TRACER.use(ctx) if ctx is not None else TRACER.use(
        TRACER.current())


def decode_tick_sample() -> int:
    """The decode-tick span sampling period: 1 = every tick, N = one in
    N (per batcher, keyed on its monotonic step counter — deterministic,
    no RNG). Serving decode loops tick far faster than consensus
    decides, so unsampled tick spans would flush every consensus trace
    out of a bounded ring."""
    try:
        return max(1, int(os.environ.get(
            "QUORACLE_TRACE_DECODE_SAMPLE",
            DEFAULT_DECODE_TICK_SAMPLE)))
    except ValueError:
        return DEFAULT_DECODE_TICK_SAMPLE


def sample_tick(step: int) -> bool:
    return step % decode_tick_sample() == 0


def ring_capacity() -> int:
    try:
        return max(16, int(os.environ.get("QUORACLE_TRACE_RING",
                                          DEFAULT_SPAN_RING)))
    except ValueError:
        return DEFAULT_SPAN_RING


# ---------------------------------------------------------------------------
# The process-wide span ring (each peer's pull-able trace slice)
# ---------------------------------------------------------------------------


class SpanRing:
    """Bounded ring of finished span events, overflow counted instead of
    silently overwritten (satellite — the ring still drops
    oldest-first, but the drop is now a first-class series)."""

    def __init__(self, capacity: Optional[int] = None,
                 ring_label: str = "fleetobs"):
        self.capacity = capacity or ring_capacity()
        self.ring_label = ring_label
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = named_lock("fleetobs.spans")
        self.dropped = 0

    def record(self, event: dict) -> None:
        """Tracer sink shape: one finished span's event dict."""
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
                TRACE_DROPPED_TOTAL.inc(ring=self.ring_label)
            self._ring.append(event)

    def spans(self, session_id: Optional[str] = None,
              trace_id: Optional[str] = None) -> list[dict]:
        with self._lock:
            out = list(self._ring)
        if session_id is not None:
            out = [s for s in out if s.get("session") == session_id]
        if trace_id is not None:
            out = [s for s in out if s.get("trace_id") == trace_id]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def stats(self) -> dict:
        with self._lock:
            return {"n_spans": len(self._ring),
                    "capacity": self.capacity, "dropped": self.dropped}


SPANS = SpanRing()
_ring_installed = False


def ensure_ring() -> SpanRing:
    """Idempotently install the process-wide span ring as a TRACER sink
    — called by every serving-plane constructor (peer, front door,
    cluster plane, Runtime) so any process that serves traffic can
    answer a timeline pull."""
    global _ring_installed
    if not _ring_installed:
        TRACER.add_sink(SPANS.record)     # add_sink dedups by equality
        _ring_installed = True
    return SPANS


# ---------------------------------------------------------------------------
# Timeline assembly + TTFT attribution
# ---------------------------------------------------------------------------

# Stage names the attribution understands. The disaggregated request's
# exact decomposition (sums to the door-observed end-to-end wall BY
# CONSTRUCTION — each subtraction's remainder is itself a stage):
#   door.request = wire_overhead + peer.prefill + peer.decode
#   peer.prefill = prefill_compute + kv_export
#   peer.decode  = kv_adopt + queue_wait + decode
_LEG_PREFILL = ("peer.prefill", "cluster.prefill")
_LEG_DECODE = ("peer.decode", "cluster.decode")
_LEG_SERVE = ("peer.serve",)
_TOTAL = ("door.request", "cluster.request")


def _sum(spans: Sequence[dict], names: Iterable[str]) -> float:
    names = tuple(names)
    return sum(s.get("duration_ms") or 0.0 for s in spans
               if s.get("name") in names)


def assemble_timeline(spans: Iterable[dict],
                      session_id: Optional[str] = None,
                      trace_id: Optional[str] = None) -> dict:
    """Order a (possibly multi-peer, possibly duplicated — loopback
    peers share a ring) span set into one session lifecycle: spans
    deduped by span_id, sorted by start time, with the per-stage TTFT
    attribution and an end-to-end total the stages sum to."""
    seen: set = set()
    out: list[dict] = []
    for s in spans:
        sid = s.get("span_id")
        if sid is None or sid in seen:
            continue
        if session_id is not None and s.get("session") != session_id:
            continue
        if trace_id is not None and s.get("trace_id") != trace_id:
            continue
        seen.add(sid)
        out.append(s)
    out.sort(key=lambda s: (s.get("ts") or 0.0, s.get("span_id") or ""))
    trace_ids = sorted({s.get("trace_id") for s in out
                        if s.get("trace_id")})
    total = _sum(out, _TOTAL)
    if total <= 0 and out:
        # no door span (e.g. direct engine traffic): the span extent
        t0 = min(s.get("ts") or 0.0 for s in out)
        t1 = max((s.get("ts") or 0.0) + (s.get("duration_ms") or 0.0)
                 / 1000.0 for s in out)
        total = (t1 - t0) * 1000.0
    prefill_leg = _sum(out, _LEG_PREFILL)
    decode_leg = _sum(out, _LEG_DECODE)
    serve_leg = _sum(out, _LEG_SERVE)
    export = _sum(out, ("kv.export",))
    adopt = _sum(out, ("kv.adopt",))
    queue = _sum(out, ("sched.queue_wait",))
    stages: dict = {}
    if prefill_leg or decode_leg:
        stages = {
            "queue_wait": queue,
            "prefill": max(0.0, prefill_leg - export),
            "kv_export": export,
            "wire": max(0.0, total - prefill_leg - decode_leg
                        - serve_leg),
            "kv_adopt": adopt,
            "decode": max(0.0, decode_leg - adopt - queue),
        }
        if serve_leg:                     # affinity round-2 continuation
            stages["serve"] = serve_leg
    elif serve_leg:
        stages = {"serve": serve_leg,
                  "wire": max(0.0, total - serve_leg)}
    # Wait-state decomposition rollup: rows retired under the
    # introspect plane carry ``waits_ns`` on their sched.decode span —
    # integer ns that sum EXACTLY to the span's ``wall_ns``. Aggregated
    # here per trace so /api/timeline answers "what did this session
    # actually wait on" beside the door-level stage decomposition.
    wait_by_state: dict = {}
    wait_rows = 0
    wait_wall_ns = 0
    for s in out:
        w = s.get("waits_ns")
        if not isinstance(w, dict):
            continue
        wait_rows += 1
        wait_wall_ns += int(s.get("wall_ns") or 0)
        for state, ns in w.items():
            try:
                wait_by_state[state] = (wait_by_state.get(state, 0)
                                        + int(ns))
            except (TypeError, ValueError):
                continue
    waits = None
    if wait_rows:
        waits = {
            "rows": wait_rows,
            "wall_ms": round(wait_wall_ns / 1e6, 3),
            "by_state_ms": {k: round(v / 1e6, 3)
                            for k, v in sorted(wait_by_state.items())},
            "exact": sum(wait_by_state.values()) == wait_wall_ns,
        }
    return {
        "session_id": session_id,
        "trace_ids": trace_ids,
        "contiguous": len(trace_ids) == 1,
        "n_spans": len(out),
        "total_ms": round(total, 3),
        "stages": {k: round(v, 3) for k, v in stages.items()},
        "stages_sum_ms": round(sum(stages.values()), 3),
        "waits": waits,
        "spans": out,
    }


# ---------------------------------------------------------------------------
# Metrics federation
# ---------------------------------------------------------------------------


class FederatedMetrics:
    """The front door's merged view over N peers' exported registry
    states. ``view`` renders the scrape surface: every series labeled
    by ``peer`` plus ``peer="fleet"`` aggregates (summed counters,
    losslessly merged histograms — exclude ``peer="fleet"`` when
    summing in PromQL). ``fleet`` holds the merged-only registry the
    snapshot/quantile reads use."""

    def __init__(self) -> None:
        self.view = MetricsRegistry()
        self.fleet = MetricsRegistry()
        self.peers: list[str] = []
        self.skipped: list[str] = []      # boundary-mismatched merges

    def render_prometheus(self) -> str:
        return self.view.render_prometheus()

    def snapshot(self) -> dict:
        return self.fleet.snapshot()

    def quantiles(self, name: str,
                  ps: Sequence[float] = (0.50, 0.95, 0.99),
                  **labels: Any) -> dict:
        m = self.fleet._metrics.get(name)
        if not isinstance(m, Histogram):
            return {}
        return m.percentiles(ps, **labels)


def federate(states: dict) -> FederatedMetrics:
    """Merge ``{peer_name: MetricsRegistry.export_state()}`` into one
    federated view. Histogram merges are LOSSLESS (identical boundaries
    → summed counts; a mismatched-boundary series is skipped and named
    in ``skipped`` rather than lossily re-bucketed)."""
    fed = FederatedMetrics()
    fed.peers = sorted(states)
    for peer in fed.peers:
        state = states[peer] or {}
        for name, entry in sorted(state.items()):
            kind = entry.get("kind")
            help_ = entry.get("help", "")
            series = entry.get("series") or []
            try:
                if kind == "histogram":
                    buckets = tuple(entry.get("buckets") or ())
                    view_h = fed.view.histogram(name, help_,
                                                buckets=buckets)
                    fleet_h = fed.fleet.histogram(name, help_,
                                                  buckets=buckets)
                    if tuple(view_h.buckets) != buckets:
                        fed.skipped.append(f"{peer}:{name}")
                        continue
                    for key, cell in series:
                        base = tuple((str(k), str(v)) for k, v in key)
                        view_h.merge_cell(
                            base + (("peer", peer),),
                            cell["counts"], cell["sum"], cell["count"])
                        view_h.merge_cell(
                            base + (("peer", "fleet"),),
                            cell["counts"], cell["sum"], cell["count"])
                        fleet_h.merge_cell(
                            base, cell["counts"], cell["sum"],
                            cell["count"])
                elif kind == "counter":
                    view_c = fed.view.counter(name, help_)
                    fleet_c = fed.fleet.counter(name, help_)
                    for key, v in series:
                        labels = {str(k): str(val) for k, val in key}
                        view_c.inc(float(v), peer=peer, **labels)
                        view_c.inc(float(v), peer="fleet", **labels)
                        fleet_c.inc(float(v), **labels)
                elif kind == "gauge":
                    view_g = fed.view.gauge(name, help_)
                    for key, v in series:
                        labels = {str(k): str(val) for k, val in key}
                        view_g.set(float(v), peer=peer, **labels)
            except (TypeError, ValueError, KeyError):
                # one malformed peer series must not take the whole
                # rollup down — name it and keep merging
                fed.skipped.append(f"{peer}:{name}")
    return fed


def local_obs_state() -> dict:
    """One peer's MSG_OBS "metrics" answer: the registry's lossless
    state plus the scalar fleet-rollup inputs (SLO burn, goodput
    counter) the front door turns into gauges."""
    state = METRICS.export_state()
    tokens = 0.0
    entry = state.get("quoracle_sched_real_tokens_total")
    if entry:
        tokens = sum(float(v) for _, v in entry.get("series") or [])
    from quoracle_tpu_torch.infra import costobs
    return {"state": state, "tokens_total": tokens,
            "chip_ms_total": costobs.total_chip_ms()}


# ---------------------------------------------------------------------------
# Correlated incident capture
# ---------------------------------------------------------------------------


class IncidentManager:
    """Deterministic incident ids + one bundle directory per incident,
    retention-pruned. ``capture`` is the single entry point every
    trigger uses (watchdog trip, chaos invariant failure, replica
    death); ``notifiers`` are the fabric broadcast hooks a front door
    registers so every peer's flight ring lands in the same bundle."""

    def __init__(self, directory: Optional[str] = None,
                 retention: int = DEFAULT_INCIDENT_RETENTION):
        self._dir = directory
        self.retention = retention
        self._lock = named_lock("fleetobs.incidents")
        self._counts: dict = {}           # (kind, key) -> occurrences
        self._notifiers: list = []
        self.opened = 0

    # -- wiring -----------------------------------------------------------

    def add_notifier(self, fn) -> None:
        """``fn(incident_id, kind, key, reason)`` — the front door's
        fabric broadcast. Exceptions are swallowed per notifier: a
        dead peer must not block incident capture."""
        with self._lock:
            if fn not in self._notifiers:
                self._notifiers.append(fn)

    def remove_notifier(self, fn) -> None:
        with self._lock:
            if fn in self._notifiers:
                self._notifiers.remove(fn)

    def directory(self) -> str:
        return (self._dir
                or os.environ.get("QUORACLE_INCIDENT_DIR")
                or os.path.join(tempfile.gettempdir(),
                                f"quoracle-incidents-{os.getuid()}"))

    def bundle_dir(self, incident_id: str) -> str:
        return os.path.join(self.directory(), f"incident-{incident_id}")

    # -- capture ----------------------------------------------------------

    @staticmethod
    def _incident_id(kind: str, key: str, n: int) -> str:
        digest = hashlib.sha256(
            f"{kind}:{key}:{n}".encode()).hexdigest()[:12]
        return f"inc-{digest}"

    def capture(self, kind: str, key: str, reason: str = "",
                broadcast: bool = True, **detail: Any) -> str:
        """Open an incident: stamp the deterministic id, dump the LOCAL
        flight ring into the bundle, notify the fabric (each reachable
        peer dumps its own ring into the same bundle), prune old
        bundles. Never raises — incident capture runs on failure paths
        that must keep degrading gracefully."""
        with self._lock:
            n = self._counts.get((kind, key), 0) + 1
            self._counts[(kind, key)] = n
            self.opened += 1
            notifiers = list(self._notifiers)
        iid = self._incident_id(kind, key, n)
        INCIDENTS_TOTAL.inc(kind=kind)
        FLIGHT.record("incident_open", incident=iid, incident_kind=kind,
                      key=key, occurrence=n, reason=reason[:200])
        try:
            bdir = self.bundle_dir(iid)
            os.makedirs(bdir, exist_ok=True)
            with open(os.path.join(bdir, "manifest.json"), "w") as f:
                json.dump({"incident_id": iid, "kind": kind,
                           "key": key, "occurrence": n,
                           "reason": reason, "ts": time.time(),
                           "detail": {k: str(v)[:500]
                                      for k, v in detail.items()}},
                          f, indent=1)
            FLIGHT.dump(reason=f"incident-{kind}",
                        path=os.path.join(bdir,
                                          f"local-{os.getpid()}.json"))
        except Exception:                 # noqa: BLE001 — capture only
            pass
        for fn in notifiers:
            if not broadcast:
                break
            try:
                fn(iid, kind, key, reason)
            except Exception:             # noqa: BLE001 — best-effort
                pass
        self._prune()
        return iid

    def peer_dump(self, incident_id: str, replica_id: str) -> Optional[str]:
        """This process's flight ring into an EXISTING incident bundle —
        the receiving side of the fabric broadcast (MSG_OBS "incident").
        Returns the dump path, or None when the dump failed."""
        FLIGHT.record("incident_dump", incident=incident_id,
                      replica=replica_id)
        try:
            bdir = self.bundle_dir(incident_id)
            os.makedirs(bdir, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in replica_id)[:48]
            path = FLIGHT.dump(
                reason=f"incident-peer-{safe}",
                path=os.path.join(bdir, f"peer-{safe}.json"))
        except Exception:                 # noqa: BLE001 — capture only
            return None
        # correlated hotspot capture: this peer's profile +
        # stacks + heartbeats land in the SAME bundle as its flight ring
        from quoracle_tpu_torch.infra import introspect
        introspect.attach_to_bundle(incident_id, tag=f"peer-{safe}")
        return path

    # -- reads / retention ------------------------------------------------

    def list(self) -> list[dict]:
        """GET /api/incidents payload: every retained bundle's manifest
        plus its dump files, newest first."""
        d = self.directory()
        out = []
        try:
            names = [n for n in os.listdir(d)
                     if n.startswith("incident-")]
        except OSError:
            return []
        for name in names:
            bdir = os.path.join(d, name)
            manifest: dict = {}
            try:
                with open(os.path.join(bdir, "manifest.json")) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                manifest = {"incident_id": name.removeprefix("incident-")}
            try:
                files = sorted(f for f in os.listdir(bdir)
                               if f != "manifest.json")
            except OSError:
                files = []
            out.append({**manifest, "files": files,
                        "path": bdir, "n_dumps": len(files)})
        out.sort(key=lambda m: m.get("ts") or 0.0, reverse=True)
        return out

    def _prune(self) -> None:
        """Keep the ``retention`` newest bundles — the incident store
        must never become the disk-filler it exists to diagnose."""
        d = self.directory()
        try:
            bundles = sorted(
                (os.path.getmtime(os.path.join(d, n)), n)
                for n in os.listdir(d) if n.startswith("incident-"))
        except OSError:
            return
        for _, name in bundles[:max(0, len(bundles) - self.retention)]:
            shutil.rmtree(os.path.join(d, name), ignore_errors=True)

    def status(self) -> dict:
        with self._lock:
            return {"opened": self.opened,
                    "directory": self.directory(),
                    "retention": self.retention,
                    "notifiers": len(self._notifiers)}


INCIDENTS = IncidentManager()
