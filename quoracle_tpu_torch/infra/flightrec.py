"""Crash-safe flight recorder of the PyTorch port (the port's copy of
``quoracle_tpu/infra/flightrec.py``): a bounded ring of recent structured events
(finished spans, resource samples, scheduler transitions, watchdog trips)
that can be DUMPED to a JSON file when something goes wrong.

The operational gap this closes: a capacity incident — HBM exhaustion, a
recompile storm, a wedged decode loop — usually kills the process or the
operator's patience before anyone attaches a scraper, and the Prometheus
counters that survive say *that* it happened, not *what led up to it*.
The recorder keeps the last ``capacity`` events in memory at near-zero
cost (one deque append per event) and serializes them on:

  * a stall-watchdog trip (runtime.StallWatchdog → ``dump(reason=...)``),
  * an unhandled crash — ``sys.excepthook`` is chained, with an
    ``atexit`` backstop for crashes the hook saw but could not persist,
  * a termination signal: SIGTERM / SIGQUIT are
    chained in ``install()`` so a chaos kill, an operator drain, or a
    supervisor timeout leaves a post-mortem artifact before the process
    honors the signal — the chained previous disposition (SIG_DFL
    included) still runs, so delivery semantics are unchanged,
  * demand: :meth:`FlightRecorder.dump`.

Dumps land in ``QUORACLE_FLIGHTREC_DIR`` (default: a per-uid directory
under the system temp dir) as ``flightrec-<utc>-<reason>.json``;
``retention`` newest dumps are kept, older ones unlinked — the recorder
must never become the disk-filler it exists to diagnose.

Like METRICS/TRACER (infra/telemetry.py), the module-level ``FLIGHT`` is
deliberately process-wide: events carry their own attribution, a crash
hook is global by nature, and tests that need a hermetic ring construct
their own :class:`FlightRecorder`.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Optional

from quoracle_tpu_torch.infra.locks import named_lock

DEFAULT_CAPACITY = 2048
DEFAULT_RETENTION = 12


class FlightRecorder:
    """Bounded ring of structured events + JSON dump-on-demand."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 directory: Optional[str] = None,
                 retention: int = DEFAULT_RETENTION):
        self.capacity = capacity
        self.retention = retention
        self._dir = directory
        self._ring: deque = deque(maxlen=capacity)
        self._lock = named_lock("flight")
        self._installed = False
        self._crashed = False
        self._dumps = 0
        self._last_dump: Optional[str] = None

    # -- recording -------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> None:
        event = {"ts": time.time(), "kind": kind, **fields}
        with self._lock:
            self._ring.append(event)

    def record_span(self, event: dict) -> None:
        """Tracer sink shape: a finished span's event dict."""
        with self._lock:
            self._ring.append({"kind": "span", **event})

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    # -- dumping ---------------------------------------------------------

    def directory(self) -> str:
        return (self._dir
                or os.environ.get("QUORACLE_FLIGHTREC_DIR")
                or os.path.join(tempfile.gettempdir(),
                                f"quoracle-flightrec-{os.getuid()}"))

    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> str:
        """Serialize the ring to a JSON file and return its path. Never
        raises into a crashing process' hook — the CALLER decides whether
        a dump failure matters."""
        events = self.snapshot()
        if path is None:
            d = self.directory()
            os.makedirs(d, exist_ok=True)
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in reason)[:48]
            path = os.path.join(
                d, f"flightrec-{stamp}-{os.getpid()}-{safe}.json")
        payload = {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "n_events": len(events),
            "events": events,
        }
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)               # readers never see a torn file
        with self._lock:
            self._dumps += 1
            self._last_dump = path
            self._crashed = False           # persisted; atexit can relax
        self._prune(os.path.dirname(path))
        return path

    def _prune(self, d: str) -> None:
        """Keep the ``retention`` newest dumps in ``d``."""
        try:
            dumps = sorted(
                f for f in os.listdir(d)
                if f.startswith("flightrec-") and f.endswith(".json"))
            for f in dumps[:max(0, len(dumps) - self.retention)]:
                os.unlink(os.path.join(d, f))
        except OSError:
            pass

    def status(self) -> dict:
        with self._lock:
            return {
                "n_events": len(self._ring),
                "capacity": self.capacity,
                "directory": self.directory(),
                "retention": self.retention,
                "dumps": self._dumps,
                "last_dump": self._last_dump,
                "crash_hooks_installed": self._installed,
            }

    # -- crash hooks -----------------------------------------------------

    def install(self) -> None:
        """Idempotently chain ``sys.excepthook`` (+ an ``atexit``
        backstop), chain SIGTERM/SIGQUIT dump handlers, and register the recorder as a tracer sink so
        finished spans enter the ring. Called once by the process's composition root; never
        uninstalled — crash capture is process-scoped by nature."""
        with self._lock:
            if self._installed:
                return
            self._installed = True
        from quoracle_tpu_torch.infra.telemetry import TRACER
        TRACER.add_sink(self.record_span)
        self._install_signal_hooks()

        prev_hook = sys.excepthook

        def hook(exc_type, exc, tb):
            self._crashed = True
            self.record("crash", exc_type=exc_type.__name__,
                        error=repr(exc))
            try:
                self.dump(reason=f"crash-{exc_type.__name__}")
            except Exception:             # noqa: BLE001 — dying anyway
                pass
            prev_hook(exc_type, exc, tb)

        sys.excepthook = hook

        import atexit

        def backstop():
            # only crashes the hook recorded but could not persist (dump
            # resets the flag) — a clean exit writes nothing
            if self._crashed:
                try:
                    self.dump(reason="atexit")
                except Exception:         # noqa: BLE001
                    pass

        atexit.register(backstop)

    def _install_signal_hooks(self) -> None:
        """Chain SIGTERM/SIGQUIT so a chaos kill or an operator drain
        leaves a post-mortem dump (retention-pruned like every other
        dump) BEFORE the process honors the signal. The previous
        disposition always runs afterwards — a chained Python handler is
        called directly; SIG_DFL/SIG_IGN are restored and the signal
        re-raised, so delivery semantics (exit status included) are
        exactly what they were without the hook. Signal handlers can
        only be set from the main thread; a recorder installed from a
        worker thread simply skips them (the excepthook/atexit capture
        above still applies)."""
        import signal

        if threading.current_thread() is not threading.main_thread():
            return
        for signum in (signal.SIGTERM, signal.SIGQUIT):
            try:
                prev = signal.getsignal(signum)
            except (ValueError, OSError):   # unsupported platform
                continue

            def handler(got_signum, frame, _prev=prev):
                name = signal.Signals(got_signum).name
                self.record("signal_dump", signal=name)
                try:
                    self.dump(reason=f"signal-{name}")
                except Exception:         # noqa: BLE001 — dying anyway
                    pass
                if callable(_prev):
                    _prev(got_signum, frame)
                else:
                    # SIG_DFL / SIG_IGN: restore and re-deliver so the
                    # default action (termination, exit status −signum)
                    # happens exactly as without the hook
                    signal.signal(got_signum,
                                  _prev if _prev is not None
                                  else signal.SIG_DFL)
                    os.kill(os.getpid(), got_signum)

            try:
                signal.signal(signum, handler)
            except (ValueError, OSError):
                pass


FLIGHT = FlightRecorder()


# ---------------------------------------------------------------------------
# Flight-event registry: the single authoritative list of event
# kinds the ring may carry. qlint's registry pass cross-checks every
# ``FLIGHT.record("<kind>", ...)`` call site against this table (and the
# table against the call sites — an entry nothing records is dead), and
# requires each kind to be documented in ARCHITECTURE.md or DEPLOY.md.
# Adding a record site means adding a row here FIRST.
# ---------------------------------------------------------------------------

FLIGHT_EVENTS: dict = {
    # process / crash capture
    "crash": "unhandled exception captured by the chained sys.excepthook",
    "signal_dump": "SIGTERM/SIGQUIT received — post-mortem dump written "
                   "before the signal's previous disposition runs",
    "span": "finished tracer span (Tracer sink → ring)",
    "watchdog_stall": "stall watchdog tripped on a frozen progress source",
    "resource_sample": "periodic device-memory / member-capacity sample",
    # compile / serving health
    "compile_storm": "CompileRegistry miss rate crossed the storm "
                     "threshold inside its window",
    "sched_admit": "continuous batcher admitted queued rows into slots",
    "sched_retire": "continuous-batcher row retired",
    "sched_row_failed": "continuous-batcher row failed in isolation",
    # QoS
    "qos_shed": "admission controller shed a request",
    "qos_demote": "SLO tracker demoted bulk-class weights",
    "qos_restore": "SLO tracker restored demoted weights",
    "qos_deadline_drop": "queued row dropped at admit (deadline passed)",
    # speculative serving
    "spec_reprobe": "disengaged speculator re-probing acceptance",
    "spec_disengage": "speculator disengaged to vanilla decode",
    "spec_error": "speculative sub-tick failed; rows decoded vanilla",
    # tiered KV
    "kv_demote": "HBM victim demoted to the host tier",
    "kv_restore": "hibernated session / prefix block paged back in",
    "kv_disk_spill": "prefix block written to the disk store",
    "kv_disk_corrupt": "checksum-rejected disk entry skipped + unlinked",
    "kv_alloc_drift": "SessionStore.alloc accounting-drift refusal",
    # disaggregated serving plane
    "kv_handoff_export": "prefill-side session hibernated into a "
                         "handoff envelope",
    "kv_handoff_adopt": "decode-side replica adopted a handed-off "
                        "session by page-in",
    "kv_handoff_reject": "handoff rejected (engine KV signature "
                         "mismatch or export failure)",
    "kv_handoff_replace": "row re-placed onto another decode replica "
                          "after its first decode replica failed",
    "cluster_replica_dead": "router marked a replica dead after a "
                            "serving failure",
    "router_all_shed": "every eligible replica shed a submission at "
                       "the cluster front door",
    # cluster fabric (serving/fabric/)
    "fabric_frame_reject": "a wire frame was rejected at the codec "
                           "boundary (crc / truncation / magic / "
                           "version skew) — corrupt bytes never adopted",
    "fabric_peer_dead": "the front door marked a remote peer failed "
                        "(silent signals or exhausted transport "
                        "retries); its rows re-place through retained "
                        "envelopes",
    "fabric_handoff_wire": "a HandoffEnvelope crossed the wire "
                           "(prefill peer → front door → decode peer), "
                           "with byte size and per-leg latency",
    "fabric_prefixd_degraded": "the fleet prefix-service client "
                               "degraded a fetch/publish to local-only "
                               "after a transport failure",
    "fabric_peer_rejoin": "a peer previously marked failed re-announced "
                          "via a hello and was restored to the front "
                          "door's placement set",
    # elastic fleet controller (serving/fleet.py)
    "fleet_action": "the fleet controller executed one policy action "
                    "(scale_up / scale_down / retier / drain) — the "
                    "tick, target, and deterministic reason string "
                    "form the replayable action ledger",
    "fleet_drain": "a replica drain finished: every resident session "
                   "live-migrated through the handoff path (or counted "
                   "failed), with per-drain totals and wall time",
    "fleet_migrate_failed": "one session's live migration degraded — "
                            "the session re-prefills on its next touch "
                            "(affinity dropped), bits unchanged",
    # fleet observability (infra/fleetobs.py)
    "incident_open": "a correlated incident was opened (deterministic "
                     "incident id stamped): the local flight ring dumps "
                     "into the incident bundle and the id is broadcast "
                     "over the fabric so every peer's dump lands in the "
                     "same bundle",
    "incident_dump": "this process dumped its flight ring into an "
                     "incident bundle on a fabric broadcast (MSG_OBS "
                     "incident op) — the peer-side half of correlated "
                     "capture",
    # consensus quality
    "model_health_drift": "EWMA drift detector tripped for a member",
    # chaos plane (chaos/faults.py + chaos/scenarios.py)
    "chaos_armed": "a FaultPlan was armed or disarmed on the chaos "
                   "plane (armed=true|false, seed, rules)",
    "chaos_fault": "the chaos plane fired one fault at an injection "
                   "point (point, fault_kind, key, n) — the sorted "
                   "(point, key, n, fault_kind) tuples ARE the "
                   "deterministic fault schedule a seed reproduces",
    "chaos_scenario_start": "a chaos scenario began driving traffic "
                            "(scenario, seed, phase=clean|storm)",
    "chaos_scenario_end": "a chaos scenario finished; carries the "
                          "per-invariant pass/fail verdicts",
    # lock discipline (analysis/lockdep.py)
    "lockdep_inversion": "runtime lock-order sanitizer saw an "
                         "acquisition against the declared hierarchy",
    # fleet simulator (sim/replay.py + sim/gate.py)
    "sim_replay_start": "a trace replay began (mode=compressed|paced, "
                        "events, trace digest)",
    "sim_replay_end": "a trace replay finished; carries the ledger "
                      "digest, outcome counts, and wall seconds",
    "sim_forecast": "the trace replay offered a next-window "
                    "traffic-mix prior to the fleet policy "
                    "(shadow-mode FleetSignals.forecast seam)",
    "sim_gate": "a sim scenario's workload-invariant verdict "
                "(name, seed, passed, invariants)",
    # chip economics (infra/costobs.py)
    "mfu_cliff": "a compiled program's observed MFU fell below half "
                 "its running best for that (model, stage, bucket) — "
                 "the recompile / padding-regression tripwire; carries "
                 "both ratios and the token bucket",
    "budget_burn": "a tenant class's error-budget burn rate crossed "
                   "the fast (1h) or slow (6h) alert threshold, with a "
                   "deterministic trip id — observed signal only, no "
                   "policy acts on it yet",
    # liveness & hotspot plane (infra/introspect.py)
    "stall_detected": "the introspect stall detector tripped: an "
                      "active progress source's heartbeat froze for "
                      "two intervals — an all-thread stack capture "
                      "plus the TrackedLock holder snapshot land in a "
                      "deterministic-id incident bundle",
    "profile_window": "the sampled wall-clock profiler rotated a "
                      "collapsed-stack window (samples, distinct "
                      "stacks, window wall)",
    "wait_skew": "a row's measured sub-waits overran its observed "
                 "wall and were deterministically trimmed — the "
                 "sum-to-wall invariant held, but the overlap is an "
                 "instrumentation bug to chase",
    # session-graph observability (infra/treeobs.py)
    "tree_orphan": "a tree node's parent record is missing from the "
                   "assembled view (the parent's peer crashed before "
                   "its registry state was federated) — the node is "
                   "FLAGGED, never silently unparented; fires once per "
                   "(tree, node)",
    "tree_budget_overrun": "a node's subtree spent more completion "
                           "tokens than the budget it inherited at "
                           "spawn — observed signal only (no policy "
                           "acts on it yet); fires once per "
                           "(tree, node) with the overspend",
    # serving flywheel (training/)
    "train_capture_degraded": "the capture plane absorbed a write "
                              "failure (real or injected) and dropped "
                              "the record — serving is unaffected by "
                              "construction; recorded once per store "
                              "so a flapping disk cannot flood the "
                              "ring",
    "train_capture_evict": "the capture store unlinked its oldest "
                           "sealed segment to hold the --capture-mb "
                           "budget (bytes and records given up)",
    "train_promote": "a candidate draft rolled through the fleet via "
                     "drain/hot-swap — carries the offline p50s, the "
                     "per-replica swap count, and the live floor the "
                     "acceptance guard will hold it to",
    "train_rollback": "the incumbent draft was restored — either the "
                      "promotion failed mid-swap (outcome=failed) or "
                      "the live acceptance EWMA fell below the "
                      "offline-measured floor (outcome=regression); "
                      "zero-downtime either way",
}
