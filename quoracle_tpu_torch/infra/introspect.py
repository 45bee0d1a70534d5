"""Liveness & hotspot plane of the PyTorch port (the port's copy of
``quoracle_tpu/infra/introspect.py``).

The fleet can say *what* happened (infra/fleetobs.py traces, federation,
incidents) and *what it cost* (infra/costobs.py chip-seconds, MFU, burn
budgets); this module answers *why a request is slow or a stage is stuck
right now*. Four parts, all read-only measurement:

* **Progress heartbeats + stall detector** — hot stages :func:`beat` a
  named monotonic counter (scheduler ticks, rows retired, KV restore
  bytes, wire RPC frames); :class:`StallDetector` watches ``(active,
  progress)`` sources (the JAX package's StallWatchdog contract) and
  trips within two heartbeat intervals of a frozen
  source, capturing every thread's stack (``sys._current_frames``) plus
  the cross-thread named-lock holder snapshot
  (:func:`infra.locks.holders`) into an incident bundle.
* **Sampled wall-clock profiler** — :class:`WallProfiler` folds periodic
  frame samples into collapsed-stack profiles per rotating window,
  served by :func:`profile_payload`; :func:`torch_trace_window` arms a
  real ``torch.profiler`` window (CPU and CUDA activities) behind the
  same flag.
* **Wait-state decomposition** — :class:`WaitClock` partitions each
  session row's wall into named waits (admission, batch queue, device
  dispatch, KV restore, wire transfer, lock wait) that sum EXACTLY to
  the observed wall in integer ns, reusing the chip-ledger's
  remainder-booking idiom: the ``other`` bucket is the exact
  remainder, never a measurement. Rows export ``waits_ns`` on their
  ``sched.decode`` trace span; fleetobs.assemble_timeline aggregates
  them per trace on ``/api/timeline``.
* **Burn-triggered capture** — a budget trip (costobs.BudgetTracker) or
  a stall calls :func:`on_burn_trip` / the detector, which opens a
  deterministic-id incident (fleetobs.INCIDENTS — the fabric notifier
  fans the capture RPC to every peer) and attaches this process's
  profile + stacks to the shared bundle.

Env-gated like every observability plane: ``QUORACLE_INTROSPECT=0``
kills it (default on), and temp-0 outputs are bit-equal either way —
nothing here touches RNG, device state, batch composition, or any
scheduling decision. Lock discipline: the plane's single lock
is ``introspect`` — :func:`beat` may be called while holding any
serving lock; all flight/metric emission and frame walking happen
strictly OUTSIDE it (the costobs discipline), and the stall capture
records the sampling thread's own held locks (``sampler_held``) so
tests can assert it holds none.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from quoracle_tpu_torch.infra import locks as lockdep
from quoracle_tpu_torch.infra.locks import named_lock

# ---------------------------------------------------------------------------
# Enablement
# ---------------------------------------------------------------------------


def _env_enabled() -> bool:
    return os.environ.get("QUORACLE_INTROSPECT", "1").strip().lower() \
        not in ("0", "false", "off")


DEFAULT_HZ = 20.0                     # profiler sampling rate (≤1% wall)


class _State:
    __slots__ = ("enabled", "sample_hz")

    def __init__(self) -> None:
        self.enabled = _env_enabled()
        try:
            self.sample_hz = float(
                os.environ.get("QUORACLE_INTROSPECT_HZ", "") or DEFAULT_HZ)
        except ValueError:
            self.sample_hz = DEFAULT_HZ


_STATE = _State()

# The plane's one lock: heartbeat counters, profiler windows and wait
# aggregates. beat() is called under serving locks; the plane emits to
# the flight recorder and the metrics strictly outside it.
_LOCK = named_lock("introspect")


def enabled() -> bool:
    return _STATE.enabled


def enable() -> None:
    """Turn the plane on (tests/bench; ``QUORACLE_INTROSPECT`` does it
    at import) and install the contended-acquire wait hook."""
    _STATE.enabled = True
    lockdep.LOCK_WAIT_HOOK = _lock_wait


def disable() -> None:
    _STATE.enabled = False
    lockdep.LOCK_WAIT_HOOK = None


# ---------------------------------------------------------------------------
# Progress heartbeats
# ---------------------------------------------------------------------------

_HEARTBEATS: dict = {}                # name -> monotonic count


def beat(name: str, amount: int = 1) -> None:
    """Advance a named progress heartbeat. Callable under any serving
    lock; no emission happens here."""
    if not _STATE.enabled:
        return
    with _LOCK:
        _HEARTBEATS[name] = _HEARTBEATS.get(name, 0) + max(1, int(amount))


def heartbeats() -> dict:
    with _LOCK:
        return dict(_HEARTBEATS)


def heartbeat_count(name: str) -> int:
    with _LOCK:
        return _HEARTBEATS.get(name, 0)


# ---------------------------------------------------------------------------
# All-thread stack capture (stall bundles; runs OUTSIDE ranked locks)
# ---------------------------------------------------------------------------


def thread_stacks(max_depth: int = 40) -> dict:
    """Every live thread's stack as ``thread-name:ident`` →
    ``["file:func:line", ...]`` (innermost first). Pure frame walking —
    takes no locks, so it is safe from any capture path."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: dict = {}
    for ident, frame in sys._current_frames().items():
        rows: list = []
        f: Any = frame
        while f is not None and len(rows) < max_depth:
            co = f.f_code
            rows.append(f"{os.path.basename(co.co_filename)}:"
                        f"{co.co_name}:{f.f_lineno}")
            f = f.f_back
        out[f"{names.get(ident, '?')}:{ident}"] = rows
    return out


# ---------------------------------------------------------------------------
# Stall detector
# ---------------------------------------------------------------------------


class StallDetector:
    """Trips on a frozen-but-active progress source within two
    heartbeat intervals. Sources follow the StallWatchdog contract
    (``fn() -> (active, progress)``); tests drive :meth:`check` with an
    explicit clock instead of sleeping. A trip captures all-thread
    stacks + the cross-thread lock-holder snapshot, records the
    ``stall_detected`` flight event, and opens a deterministic-id
    incident — the fabric notifier fans the capture to every peer."""

    def __init__(self, interval_s: float = 5.0):
        self.interval_s = interval_s
        self._watches: dict = {}
        self._last: dict = {}         # name -> (progress, since)
        self._tripped: dict = {}      # name -> last trip time
        self.trips = 0
        self.last_bundle: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def watch(self, name: str, fn: Callable[[], tuple]) -> None:
        with _LOCK:
            self._watches[name] = fn

    def unwatch(self, name: str) -> None:
        with _LOCK:
            self._watches.pop(name, None)
            self._last.pop(name, None)
            self._tripped.pop(name, None)

    def start(self) -> None:
        if not _STATE.enabled or self._thread is not None:
            return
        with _LOCK:
            if not self._watches:
                return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="introspect-stall", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:         # noqa: BLE001 — telemetry only
                pass

    def check(self, now: Optional[float] = None) -> list:
        """One scan; returns the source names that tripped THIS scan.
        All capture/emission happens after the bookkeeping, outside the
        plane lock."""
        if not _STATE.enabled:
            return []
        now0 = time.monotonic() if now is None else now
        deadline = 2.0 * self.interval_s
        with _LOCK:
            watches = dict(self._watches)
        tripped: list = []
        for name in sorted(watches):
            try:
                active, progress = watches[name]()
            except Exception:         # noqa: BLE001 — telemetry only
                continue
            with _LOCK:
                last = self._last.get(name)
                if not active:
                    self._last.pop(name, None)
                    self._tripped.pop(name, None)
                    continue
                if last is None or last[0] != progress:
                    self._last[name] = (progress, now0)
                    self._tripped.pop(name, None)
                    continue
                if now0 - last[1] < deadline:
                    continue
                if name in self._tripped:
                    continue          # one bundle per distinct wedge
                self._tripped[name] = now0
                self.trips += 1
                stalled_s = now0 - last[1]
            tripped.append(name)
            self._trip(name, stalled_s)
        return tripped

    def _trip(self, name: str, stalled_s: float) -> None:
        # Frame walking, flight, metrics and incident I/O — all outside
        # the plane lock; sampler_held records OUR held stack so tests
        # assert the sampler never captures while holding a ranked lock.
        bundle = {
            "source": name,
            "stalled_s": round(stalled_s, 2),
            "stacks": thread_stacks(),
            "holders": lockdep.holders(),
            "sampler_held": [k for k in lockdep.holders()
                             if k.endswith(f":{threading.get_ident()}")],
        }
        self.last_bundle = bundle
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        from quoracle_tpu_torch.infra.telemetry import INTROSPECT_STALLS_TOTAL
        FLIGHT.record("stall_detected", source=name,
                      stalled_s=round(stalled_s, 2),
                      threads=len(bundle["stacks"]),
                      holders=sum(len(v) for v in
                                  bundle["holders"].values()))
        INTROSPECT_STALLS_TOTAL.inc(source=name)
        from quoracle_tpu_torch.infra.fleetobs import INCIDENTS
        iid = INCIDENTS.capture(
            "stall", name,
            reason=f"source {name!r} active but frozen "
                   f"{stalled_s:.1f}s (2x heartbeat interval)",
            stalled_s=round(stalled_s, 2))
        attach_to_bundle(iid, tag="stall", extra=bundle)

    def status(self) -> dict:
        with _LOCK:
            return {
                "interval_s": self.interval_s,
                "watches": sorted(self._watches),
                "tripped": sorted(self._tripped),
                "trips": self.trips,
            }


STALLS = StallDetector()


# ---------------------------------------------------------------------------
# Sampled wall-clock profiler
# ---------------------------------------------------------------------------


class WallProfiler:
    """Low-overhead periodic frame sampler. Each tick walks every OTHER
    thread's frames (``sys._current_frames``) and folds the stack into
    a collapsed ``file:func;file:func`` string; counts accumulate per
    rotating window. Self-measures its own sampling wall so
    ``overhead_frac`` is an observation, not a guess."""

    WINDOW_S = 30.0                   # profile window length
    KEEP = 4                          # completed windows retained
    MAX_STACKS = 200                  # distinct stacks per window
    TOP_N = 25                        # stacks reported per window

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.hz = _STATE.sample_hz
        self.samples = 0
        self.sample_ns = 0            # wall spent inside sample_once
        self._t_started: Optional[float] = None
        self._win: dict = {}          # collapsed stack -> count
        self._win_start = 0.0
        self._win_samples = 0
        self._done: deque = deque(maxlen=self.KEEP)

    def start(self, hz: Optional[float] = None) -> None:
        if not _STATE.enabled or self._thread is not None:
            return
        self.hz = float(hz) if hz else _STATE.sample_hz
        if self.hz <= 0:
            return
        self._t_started = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="introspect-profiler", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        with _LOCK:
            rotated = self._rotate_locked(time.monotonic())
        self._emit_window(rotated)

    def _loop(self) -> None:
        period = 1.0 / max(0.5, self.hz)
        while not self._stop.wait(period):
            try:
                self.sample_once()
            except Exception:         # noqa: BLE001 — telemetry only
                pass

    def sample_once(self) -> int:
        """One sampling tick (tests call this directly). Returns the
        number of thread stacks folded."""
        if not _STATE.enabled:
            return 0
        t0 = time.monotonic_ns()
        me = threading.get_ident()
        folded: list = []
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            parts: list = []
            f: Any = frame
            while f is not None and len(parts) < 25:
                co = f.f_code
                parts.append(f"{os.path.basename(co.co_filename)}:"
                             f"{co.co_name}")
                f = f.f_back
            parts.reverse()
            folded.append(";".join(parts))
        dt = time.monotonic_ns() - t0
        now = time.monotonic()
        rotated = None
        with _LOCK:
            if not self._win_samples:
                self._win_start = now
            elif now - self._win_start >= self.WINDOW_S:
                rotated = self._rotate_locked(now)
            for s in folded:
                if s in self._win or len(self._win) < self.MAX_STACKS:
                    self._win[s] = self._win.get(s, 0) + 1
                else:
                    self._win["<overflow>"] = \
                        self._win.get("<overflow>", 0) + 1
            self.samples += 1
            self._win_samples += 1
            self.sample_ns += dt
        self._emit_window(rotated)
        from quoracle_tpu_torch.infra.telemetry import INTROSPECT_PROFILE_SAMPLES
        INTROSPECT_PROFILE_SAMPLES.inc()
        return len(folded)

    def _rotate_locked(self, now: float) -> Optional[dict]:
        if not self._win_samples:
            return None
        top = sorted(self._win.items(), key=lambda kv: (-kv[1], kv[0]))
        win = {
            "dur_s": round(now - self._win_start, 3),
            "samples": self._win_samples,
            "distinct": len(self._win),
            "stacks": dict(top[:self.TOP_N]),
        }
        self._done.append(win)
        self._win = {}
        self._win_start = now
        self._win_samples = 0
        return win

    def _emit_window(self, win: Optional[dict]) -> None:
        if win is None:
            return
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        from quoracle_tpu_torch.infra.telemetry import INTROSPECT_OVERHEAD_RATIO
        FLIGHT.record("profile_window", samples=win["samples"],
                      distinct=win["distinct"], dur_s=win["dur_s"])
        INTROSPECT_OVERHEAD_RATIO.set(self.overhead_frac())
        return

    def overhead_frac(self) -> float:
        """Observed fraction of wall spent sampling since start()."""
        if self._t_started is None:
            return 0.0
        elapsed_ns = (time.monotonic() - self._t_started) * 1e9
        return self.sample_ns / max(1.0, elapsed_ns)

    def snapshot(self) -> dict:
        with _LOCK:
            cur = sorted(self._win.items(), key=lambda kv: (-kv[1], kv[0]))
            payload = {
                "hz": self.hz,
                "running": self._thread is not None,
                "samples": self.samples,
                "overhead_frac": round(self.overhead_frac(), 6),
                "window": {"samples": self._win_samples,
                           "stacks": dict(cur[:self.TOP_N])},
                "windows": list(self._done),
            }
        return payload


PROFILER = WallProfiler()


@contextlib.contextmanager
def torch_trace_window(logdir: str):
    """A real ``torch.profiler`` window (CPU and, when a card is present,
    CUDA activities) behind the introspect flag — device-level truth
    where Python frame samples only see the host side. On exit the
    trace is written as a Chrome trace under ``logdir``. Yields whether
    the profiler armed (False with the plane off or when the profiler
    cannot start)."""
    if not _STATE.enabled:
        yield False
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:                 # noqa: BLE001 — optional backend
        yield False
        return
    try:
        yield True
    finally:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                logdir, f"torch-trace-{os.getpid()}.json"))
        except Exception:             # noqa: BLE001 — best-effort
            pass


# ---------------------------------------------------------------------------
# Wait-state decomposition
# ---------------------------------------------------------------------------

# The named wait vocabulary. "other" is the exact remainder bucket —
# computed, never measured, so per-row waits sum to the wall by
# construction (the ChipLedger remainder-booking idiom).
WAIT_STATES: tuple = ("admission", "queue", "dispatch", "kv_restore",
                      "wire", "lock", "other")


class WaitClock:
    """Integer-ns wait ledger for one session row (or one front-door
    request). Opened at submit, fed named waits as they are measured,
    closed at retire: ``close`` books the exact remainder into
    ``other`` — and when measured sub-waits overran the observed wall
    (overlapping measurements / clock skew), trims the largest buckets
    deterministically and records the skew instead of breaking the
    sum-to-wall invariant."""

    __slots__ = ("t0_ns", "waits", "skew_ns")

    def __init__(self, t0_ns: Optional[int] = None):
        self.t0_ns = time.monotonic_ns() if t0_ns is None else int(t0_ns)
        self.waits: dict = {}
        self.skew_ns = 0

    def note(self, state: str, ns: int) -> None:
        ns = int(ns)
        if ns > 0:
            self.waits[state] = self.waits.get(state, 0) + ns

    def close(self, t_end_ns: Optional[int] = None) -> dict:
        end = time.monotonic_ns() if t_end_ns is None else int(t_end_ns)
        wall = max(0, end - self.t0_ns)
        named = sum(self.waits.values())
        if named > wall:
            self.skew_ns = named - wall
            for state, _ in sorted(self.waits.items(),
                                   key=lambda kv: (-kv[1], kv[0])):
                over = sum(self.waits.values()) - wall
                if over <= 0:
                    break
                self.waits[state] -= min(over, self.waits[state])
            named = sum(self.waits.values())
        self.waits["other"] = wall - named
        return {"wall_ns": wall, "waits_ns": dict(self.waits),
                "skew_ns": self.skew_ns}


# Per-thread accumulators for waits measured INSIDE an engine step: the
# KV tier notes restore wall on the dispatching thread, the lockdep
# wait hook notes contended TrackedLock acquires. The batcher drains
# them around each engine call and books them against the step's rows.
class _ThreadAcc(threading.local):
    restore_ns = 0
    lock_ns = 0


_ACC = _ThreadAcc()


def _lock_wait(name: str, ns: int) -> None:
    # locks.LOCK_WAIT_HOOK target: runs while the caller may hold
    # arbitrary locks, so it must take none — one TLS add only.
    _ACC.lock_ns += ns


def note_restore(ms: float, nbytes: int = 0) -> None:
    """KV tier restore happened on this thread: feed the wait
    accumulator and the ``kv.restore`` heartbeat (bytes when known)."""
    if not _STATE.enabled:
        return
    _ACC.restore_ns += int(ms * 1e6)
    beat("kv.restore", max(1, int(nbytes)))


def drain_inner_waits() -> tuple:
    """Return-and-clear this thread's (restore_ns, lock_ns)."""
    r, lk = _ACC.restore_ns, _ACC.lock_ns
    _ACC.restore_ns = 0
    _ACC.lock_ns = 0
    return r, lk


_WAIT_TOTALS: dict = {}               # model -> {state: ns}
_WAIT_ROWS: dict = {}                 # model -> rows recorded


def record_row_waits(model: str, closed: dict) -> None:
    """Book one closed WaitClock: per-state histograms + the running
    totals ``/api/profile`` reports. Emission outside the plane lock."""
    if not _STATE.enabled:
        return
    waits = closed["waits_ns"]
    with _LOCK:
        agg = _WAIT_TOTALS.setdefault(model, {})
        for state, ns in waits.items():
            agg[state] = agg.get(state, 0) + ns
        _WAIT_ROWS[model] = _WAIT_ROWS.get(model, 0) + 1
    from quoracle_tpu_torch.infra.telemetry import INTROSPECT_WAIT_MS
    for state, ns in waits.items():
        if ns > 0:
            INTROSPECT_WAIT_MS.observe(ns / 1e6, state=state, model=model)
    if closed.get("skew_ns"):
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        from quoracle_tpu_torch.infra.telemetry import INTROSPECT_WAIT_SKEW_TOTAL
        INTROSPECT_WAIT_SKEW_TOTAL.inc(model=model)
        FLIGHT.record("wait_skew", model=model,
                      skew_ns=closed["skew_ns"],
                      wall_ns=closed["wall_ns"])


def wait_totals() -> dict:
    with _LOCK:
        return {m: {"rows": _WAIT_ROWS.get(m, 0),
                    "by_state_ns": dict(states)}
                for m, states in _WAIT_TOTALS.items()}


# ---------------------------------------------------------------------------
# Burn-triggered capture
# ---------------------------------------------------------------------------


def on_burn_trip(tenant: str, cls: str, window: str, trip_id: str,
                 burn: float) -> None:
    """A tenant class's error budget tripped (costobs.BudgetTracker —
    called AFTER its lock released): open a deterministic-id incident
    (the fabric notifier fans the capture RPC to every peer) and attach
    this process's profile + stacks to the shared bundle."""
    if not _STATE.enabled:
        return
    from quoracle_tpu_torch.infra.fleetobs import INCIDENTS
    iid = INCIDENTS.capture(
        "burn", f"{tenant}:{cls}:{window}",
        reason=f"error-budget burn {burn:.1f}x over the {window} "
               f"threshold (trip {trip_id})",
        tenant=tenant, cls=cls, window=window, trip_id=trip_id,
        burn=round(burn, 3))
    attach_to_bundle(iid, tag="burn")


def attach_to_bundle(incident_id: str, tag: str = "local",
                     extra: Optional[dict] = None) -> Optional[str]:
    """Write this process's profile + all-thread stacks + heartbeats
    into an EXISTING incident bundle (both the local capture path and
    the peer side of the MSG_OBS incident broadcast call this). Never
    raises — capture runs on failure paths."""
    if not _STATE.enabled:
        return None
    from quoracle_tpu_torch.infra.fleetobs import INCIDENTS
    try:
        bdir = INCIDENTS.bundle_dir(incident_id)
        os.makedirs(bdir, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in tag)[:48]
        path = os.path.join(bdir,
                            f"introspect-{safe}-{os.getpid()}.json")
        payload = {"incident_id": incident_id, "tag": tag,
                   "profile": PROFILER.snapshot(),
                   "stacks": thread_stacks(),
                   "heartbeats": heartbeats()}
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return path
    except Exception:                 # noqa: BLE001 — capture only
        return None


# ---------------------------------------------------------------------------
# Process wiring
# ---------------------------------------------------------------------------


def profile_payload() -> dict:
    """The whole plane's state in one read (the JAX package serves it
    at ``GET /api/profile``)."""
    return {
        "enabled": _STATE.enabled,
        "profiler": PROFILER.snapshot(),
        "heartbeats": heartbeats(),
        "stalls": STALLS.status(),
        "waits": wait_totals(),
    }


def start(sources: Any = ()) -> None:
    """Arm the plane for a live process: watch each ``(name, fn)``
    progress source and start the profiler + stall poll threads
    (daemon; :func:`shutdown` joins them)."""
    if not _STATE.enabled:
        return
    lockdep.LOCK_WAIT_HOOK = _lock_wait
    for name, fn in sources:
        STALLS.watch(name, fn)
    PROFILER.start()
    STALLS.start()


def shutdown() -> None:
    PROFILER.close()
    STALLS.close()


def reset() -> None:
    """Test hook: stop threads and clear every ledger/window/counter
    (mirrors costobs.reset); re-reads the env gate."""
    shutdown()
    global PROFILER, STALLS
    with _LOCK:
        _HEARTBEATS.clear()
        _WAIT_TOTALS.clear()
        _WAIT_ROWS.clear()
    PROFILER = WallProfiler()
    STALLS = StallDetector()
    _ACC.restore_ns = 0
    _ACC.lock_ns = 0
    _STATE.enabled = _env_enabled()
    lockdep.LOCK_WAIT_HOOK = _lock_wait if _STATE.enabled else None


if _STATE.enabled:
    lockdep.LOCK_WAIT_HOOK = _lock_wait
