"""QoS-aware cluster router of the PyTorch port (port of
``quoracle_tpu/serving/router.py``).

The cluster front door: every submission entering a multi-replica
serving plane (serving/cluster.py) is PLACED here before any replica
lock is touched. Placement inputs, in priority order:

  1. **Session affinity** — a decode row whose session's pages are
     resident on a replica goes back to that replica; moving it would
     pay a handoff (or worse, a re-prefill) for nothing. Affinity is
     recorded when a handoff lands and cleared when the session drops.
     The DiskPrefixStore signature dir is the complementary SHARED
     medium: replicas over the same ``--disk-kv-dir`` lazily adopt each
     other's persisted prefix blocks, so affinity is a latency
     optimization, never a correctness requirement.
  2. **Role** — prefill work goes to prefill-tier replicas, decode work
     to decode-tier replicas; "unified" replicas accept both (the
     non-disaggregated data-parallel mode).
  3. **Live load signals** — the SAME numbers each replica's admission
     controller sheds on (:class:`~quoracle_tpu_torch.serving.admission.
     SignalSnapshot`: queue depth, admit-wait p95, effective HBM
     headroom with demotable bytes counted): least-loaded wins, with a
     staleness guard that forces a signal refresh rather than steering
     on stale load data.
  4. **Tenant / priority** — admission itself stays per-replica (each
     replica's controller enforces rates and shed ladders exactly as in
     the single-Runtime world); the router's ``admit`` aggregates: a
     submission is shed at the front door only when EVERY eligible
     replica sheds it, and the propagated 429 carries the MAX
     retry-after across replicas — the earliest moment a retry could
     possibly succeed anywhere.

Liveness: a replica that fails a serving call is marked dead
(``mark_failed``, which also captures a ``replica_dead`` incident in
infra/fleetobs.py) and drops out of placement; its in-flight rows are
re-placed through the retained handoff envelopes (cluster.py). Every
replica here lives in this process. The JAX router also scores network
peers whose signal polls fail (a silence streak marks them failed); that
comes with the cross-host fabric (ROADMAP Queue 1 item 14), and until
then ``stats()["silent"]`` stays empty.

Locking: the router lock ("router", rank 6) sits ABOVE every replica-
internal lock (batcher 10, admission 12, …) in the declared hierarchy —
placement reads per-replica signals (signal lock 14) and that is the
only downward edge it ever takes.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from quoracle_tpu_torch.chaos.faults import CHAOS
from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.telemetry import (
    ROUTER_PLACEMENTS_TOTAL, ROUTER_SHED_TOTAL, ROUTER_SIGNAL_AGE_MS,
)
from quoracle_tpu_torch.serving.admission import (
    AdmissionError, OverloadedError, escalate_retry_ms,
)
from quoracle_tpu_torch.serving.qos import class_name, coerce_priority

# A signal window older than this forces a refresh at placement time —
# matches the admission controller's own refresh cadence (refresh_s=1.0)
# with headroom for the scrape jitter.
DEFAULT_MAX_SIGNAL_AGE_S = 5.0



class ClusterRouter:
    """Placement + affinity + liveness for one ClusterPlane. Replicas
    are registered once at build; all methods are thread-safe."""

    def __init__(self, max_signal_age_s: float = DEFAULT_MAX_SIGNAL_AGE_S):
        self._lock = named_lock("router")
        self._replicas: dict[str, Any] = {}      # id -> Replica
        self._affinity: dict[str, str] = {}      # session_id -> replica id
        # graceful drain: ids here are excluded from NEW
        # placements but keep serving their affinity sessions until
        # each one's migration lands — distinct from mark_failed, which
        # purges affinities (the sessions are gone)
        self._draining: set[str] = set()
        self.max_signal_age_s = float(max_signal_age_s)
        self.placements = 0
        self.shed = 0
        # retry-after backoff state: consecutive
        # aggregate sheds escalate the propagated hint exponentially
        # (deterministic jitter, capped, monotone non-decreasing) and
        # one successful admit resets the streak — without this a
        # saturated cluster tells every rejected client the same small
        # retry_after and they re-arrive in lockstep, re-saturating it.
        self._shed_streak = 0
        self._last_retry_ms = 0
        # per-replica consecutive silent-signal polls of network peers
        # (the fabric's, Queue 1 item 14): empty while every replica is
        # in process
        self._silent: dict[str, int] = {}

    # -- topology --------------------------------------------------------

    def register(self, replica) -> None:
        with self._lock:
            self._replicas[replica.replica_id] = replica

    def replicas(self, role: Optional[str] = None,
                 alive_only: bool = True,
                 include_draining: bool = False) -> list:
        """Replicas eligible for ``role`` ("prefill" / "decode" / None =
        all): exact-role matches first, then "unified" (which serves
        both), dead replicas excluded. Draining replicas are
        excluded from eligibility unless ``include_draining`` — the
        fleet controller's topology reads want them, new placements
        must not."""
        with self._lock:
            reps = list(self._replicas.values())
            draining = set(self._draining)
        out = [r for r in reps
               if (not alive_only or r.alive)
               and (include_draining or r.replica_id not in draining)
               and (role is None or r.role == role
                    or r.role == "unified")]
        out.sort(key=lambda r: (r.role == "unified", r.replica_id))
        return out

    def deregister(self, replica_id: str) -> None:
        """Remove a replica from the router entirely (scale-down
        retirement): its affinities must already have been migrated
        (drain) or be acceptable losses (the caller purged them via
        mark_failed). Remaining affinities are dropped — a
        pointer at an unregistered replica could never serve."""
        with self._lock:
            self._replicas.pop(replica_id, None)
            self._draining.discard(replica_id)
            self._silent.pop(replica_id, None)
            for sid in [s for s, rid in self._affinity.items()
                        if rid == replica_id]:
                del self._affinity[sid]

    def mark_failed(self, replica_id: str, error: str = "") -> None:
        """A serving call against this replica raised: drop it from
        placement. Recorded loudly — a silently shrinking cluster is an
        incident, not a detail."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None or not rep.alive:
                return
            rep.alive = False
            self._draining.discard(replica_id)
            # purge affinities pointing at the corpse: their sessions
            # are gone; the next round re-places (handoff envelopes
            # cover rows mid-flight)
            stale = [sid for sid, rid in self._affinity.items()
                     if rid == replica_id]
            for sid in stale:
                del self._affinity[sid]
        FLIGHT.record("cluster_replica_dead", replica=replica_id,
                      error=error[:200], dropped_affinities=len(stale))
        # correlated incident capture: every replica death —
        # serving failure, silent signals, chaos kill — stamps a
        # deterministic incident id, dumps the local flight ring into
        # the bundle, and (via the front door's registered notifier)
        # broadcasts the id so every reachable peer's dump joins it.
        # This is the single chokepoint: both planes route deaths here.
        from quoracle_tpu_torch.infra.fleetobs import INCIDENTS
        INCIDENTS.capture("replica_dead", replica_id,
                          reason=error[:200])

    def mark_draining(self, replica_id: str) -> None:
        """Graceful drain — DISTINCT from
        ``mark_failed``: the replica leaves the placement set but its
        affinity entries survive, so resident sessions keep serving on
        their pages (no spurious cold re-prefills) until the fleet
        controller migrates each one and rewrites its affinity."""
        with self._lock:
            if replica_id in self._replicas:
                self._draining.add(replica_id)

    def clear_draining(self, replica_id: str) -> None:
        """Drain finished without retirement (a re-tier flip): the
        replica re-enters the placement set under its current role."""
        with self._lock:
            self._draining.discard(replica_id)

    def is_draining(self, replica_id: str) -> bool:
        with self._lock:
            return replica_id in self._draining

    def revive(self, replica_id: str) -> bool:
        """A failed replica came back: restore it to the placement set
        with a clean silent-poll streak. Its old affinities stayed purged by
        mark_failed — the sessions died with the process; new traffic
        lands normally. Returns False for an unknown id."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return False
            rep.alive = True
            self._silent.pop(replica_id, None)
            self._draining.discard(replica_id)
        return True

    def alive_count(self, role: Optional[str] = None) -> int:
        return len(self.replicas(role))

    # -- affinity --------------------------------------------------------

    def affinity_of(self, session_id: Optional[str]):
        """The live replica holding this session's pages, or None."""
        if not session_id:
            return None
        with self._lock:
            rid = self._affinity.get(session_id)
            rep = self._replicas.get(rid) if rid else None
        return rep if rep is not None and rep.alive else None

    def set_affinity(self, session_id: str, replica_id: str) -> None:
        with self._lock:
            self._affinity[session_id] = replica_id

    def drop_affinity(self, session_id: str) -> None:
        with self._lock:
            self._affinity.pop(session_id, None)

    # -- placement -------------------------------------------------------

    def _load_score(self, rep) -> tuple:
        """Lower is better. Ranks by the admission controller's own
        sampled signals; a replica without QoS wiring scores by queue
        depth alone (scheduler stats)."""
        now = time.monotonic()
        # Chaos seam: a "drop" directive loses this replica's
        # signal snapshot — the router must degrade to worst-rank
        # placement for it, never crash or stall the front door.
        d = CHAOS.fire("router.signals", replica=rep.replica_id)
        if d is not None and d.kind == "drop":
            return (1 << 20, 0.0, 0.0)
        ctrl = getattr(rep.backend, "qos_controller", None)
        if ctrl is not None:
            # (the JAX router catches a network peer's failed poll here
            # and scores it worst-rank: the fabric, Queue 1 item 14)
            snap = ctrl.signals(max_age_s=self.max_signal_age_s)
            with self._lock:
                self._silent.pop(rep.replica_id, None)
            ROUTER_SIGNAL_AGE_MS.observe(snap.age_s(now) * 1000,
                                         replica=rep.replica_id)
            head = snap.hbm_headroom
            return (snap.queue_depth,
                    snap.admit_wait_p95_ms or 0.0,
                    -(head if head is not None else 1.0))
        depth = 0
        try:
            for st in rep.backend.scheduler_stats().values():
                depth += int(st.get("queued", 0)) + int(st.get("live", 0))
        except Exception:                 # noqa: BLE001 — best-effort
            pass
        return (depth, 0.0, -1.0)

    def place(self, role: str, session_id: Optional[str] = None,
              exclude: tuple = ()):
        """Pick the replica a submission runs on. Affinity first (decode
        rows stick to the replica holding their pages), then the
        least-loaded eligible replica by live signals. Returns a
        Replica; raises :class:`OverloadedError` when no live replica is
        eligible (every caller maps that to the structured 429)."""
        rep = self.affinity_of(session_id)
        if rep is not None and rep.replica_id not in exclude \
                and (role is None or rep.role in (role, "unified")):
            self._note_place(rep, role, "affinity")
            return rep
        cands = [r for r in self.replicas(role)
                 if r.replica_id not in exclude]
        if not cands:
            raise OverloadedError(
                f"no live {role or 'serving'} replica "
                f"(cluster degraded)", retry_after_ms=5000)
        if len(cands) == 1:
            self._note_place(cands[0], role, "only")
            return cands[0]
        best = min(cands, key=self._load_score)
        self._note_place(best, role,
                         "failover" if exclude else "least_loaded")
        return best

    def _note_place(self, rep, role: str, reason: str) -> None:
        with self._lock:
            self.placements += 1
        ROUTER_PLACEMENTS_TOTAL.inc(role=role or "any", reason=reason,
                                    replica=rep.replica_id)

    # -- front-door admission --------------------------------------------

    def admit(self, tenant: str = "default", priority: Any = None,
              deadline_s: Optional[float] = None, role: str = "decode"):
        """Cluster-level admission (the web edge calls this exactly like
        a single backend's controller): try each eligible replica's
        admission controller in load order; the FIRST that admits wins
        and its (possibly tenant-clamped) priority is returned. Only
        when every eligible replica sheds does the front door shed —
        with the MAX retry-after across their individual rejections, and
        the most urgent rejection's class attribution."""
        cands = self.replicas(role)
        controllers = [
            (r, getattr(r.backend, "qos_controller", None))
            for r in cands]
        controllers = [(r, c) for r, c in controllers if c is not None]
        if not controllers:
            if not cands:
                raise OverloadedError("no live replica", retry_after_ms=5000)
            return coerce_priority(priority)     # QoS off: admit all
        errors: list[AdmissionError] = []
        for rep, ctrl in sorted(
                ((r, c) for r, c in controllers),
                key=lambda rc: self._load_score(rc[0])):
            try:
                cls = ctrl.admit(tenant=tenant, priority=priority,
                                 deadline_s=deadline_s)
                with self._lock:
                    self._shed_streak = 0
                    self._last_retry_ms = 0
                return cls
            except AdmissionError as e:
                errors.append(e)
        cls = coerce_priority(priority)
        base = max(e.retry_after_ms for e in errors)
        with self._lock:
            self.shed += 1
            self._shed_streak += 1
            # per-replica rejections may shrink between sheds (the
            # ladder's own hint tracks depth) — clamp to the previous
            # propagated hint so successive 429s NEVER tell a client to
            # come back sooner while the cluster is still saturated
            retry = max(self._last_retry_ms,
                        escalate_retry_ms(base, self._shed_streak))
            self._last_retry_ms = retry
        ROUTER_SHED_TOTAL.inc(cls=class_name(cls), tenant=tenant)
        FLIGHT.record("router_all_shed", tenant=tenant,
                      cls=class_name(cls), replicas=len(errors),
                      retry_after_ms=retry)
        raise OverloadedError(
            f"all {len(errors)} {role} replicas shed "
            f"({'; '.join(sorted({e.reason for e in errors}))})",
            retry_after_ms=retry, tenant=tenant, priority=cls)

    # -- reads -----------------------------------------------------------

    def capacity_hint(self) -> dict:
        """Whole-fleet capacity in the units the fleet simulator's
        ``CapacityModel`` speaks: alive serving-tier replica
        count and their summed continuous-batcher decode rows (the
        simulator, ``sim/``, is ROADMAP Queue 1 item 14). Best-effort:
        an unreachable backend contributes the scheduler default (8 rows)."""
        decode = prefill = slots = 0
        for rep in self.replicas():
            if rep.role == "prefill":
                prefill += 1
                continue
            decode += 1
            n = 0
            fn = getattr(rep.backend, "scheduler_stats", None)
            if callable(fn):
                try:
                    for st in (fn() or {}).values():
                        n += int(st.get("max_slots", 0) or 0)
                except Exception:         # noqa: BLE001 — silent peer
                    n = 0
            slots += n or 8
        return {"decode_replicas": decode, "prefill_replicas": prefill,
                "decode_slots": max(1, slots)}

    def stats(self) -> dict:
        with self._lock:
            reps = list(self._replicas.values())
            affinity = len(self._affinity)
            placements, shed = self.placements, self.shed
            streak, last_retry = self._shed_streak, self._last_retry_ms
            draining = set(self._draining)
        out = {
            "replicas": {},
            "affinity_sessions": affinity,
            "placements": placements,
            "shed": shed,
            "shed_streak": streak,
            "last_retry_after_ms": last_retry,
            "max_signal_age_s": self.max_signal_age_s,
        }
        with self._lock:
            out["silent"] = dict(self._silent)
        for rep in reps:
            ctrl = getattr(rep.backend, "qos_controller", None)
            sig = None
            if ctrl is not None:
                try:
                    sig = ctrl.signals().as_dict()
                except Exception:         # noqa: BLE001 — silent peer
                    sig = {"unreachable": True}
            out["replicas"][rep.replica_id] = {
                "role": rep.role,
                "alive": rep.alive,
                "draining": rep.replica_id in draining,
                "signals": sig,
            }
        out["draining"] = sorted(draining)
        return out
