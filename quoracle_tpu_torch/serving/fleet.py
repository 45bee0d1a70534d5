"""Elastic fleet controller of the PyTorch port (port of
``quoracle_tpu/serving/fleet.py``).

Everything ELASTIC about the serving plane existed as mechanism before
this module — bit-identical session handoff, replica-death
re-placement, SignalSnapshot load signals, SLO burn tracking — but the
topology was frozen at boot: replica count and the prefill/decode split
were build-time constants, so an agent storm either shed load or
stranded idle chips. The :class:`FleetController` turns that static
topology into POLICY, with three actions over a live
:class:`~quoracle_tpu_torch.serving.cluster.ClusterPlane`:

* **scale** — spin replica backends up or down within
  ``--fleet-min/--fleet-max`` bounds, registering/deregistering them
  with the :class:`~quoracle_tpu_torch.serving.router.ClusterRouter`.
  (The JAX controller also grows and shrinks a cross-host front door's
  peer set, ``FabricPlane.add_peer``, ``remove_peer`` and
  ``rejoin_peer``; that surface comes with the fabric, ROADMAP Queue 1
  item 14.)
* **re-tier** — flip a replica's role between prefill and decode when
  the traffic mix shifts (prefill-heavy mornings vs decode-heavy agent
  storms), draining it first so the flip never strands a session.
* **drain** — live-migrate EVERY resident session off a replica
  through the existing handoff path (``TierManager.export_session`` →
  :class:`~quoracle_tpu_torch.serving.handoff.HandoffEnvelope` →
  ``adopt_session``), rewriting the router affinity per migrated
  session. Zero-downtime replica retirement — and model hot-swap
  (stand up a new replica, drain the old one onto it, retire it) —
  fall out of this one primitive.

Determinism contract (the acceptance bar of the tests): POLICY decisions run
on a logical tick with a pluggable clock and consume only the
:class:`FleetSignals` handed to (or gathered at) that tick — no
wall-clock, no global RNG; tie-breaks hash the explicit seed exactly
like the chaos plane's fire decisions. Replaying the same synthetic
signal trace through two controllers yields the IDENTICAL action
ledger, so the tests assert exact action sequences, not "roughly scaled
up at some point". Hysteresis (``hysteresis_ticks`` consecutive
observations before any action) and a post-action ``cooldown_ticks``
window keep the policy from flapping at a threshold boundary.

The drain state machine per replica::

  serving ──mark_draining──▶ draining (router: excluded from NEW
     placements; affinity rows keep serving on their resident pages —
     no spurious cold re-prefills)
  draining ──settle──▶ quiescent (queued+live rows drained)
  quiescent ──migrate each session──▶ empty
     (export → envelope → adopt on the least-loaded peer → affinity
      rewritten → envelope forgotten; a failed migration drops the
      affinity and degrades that one session to re-prefill)
  empty ──retire──▶ removed (scale-down / hot-swap)
  empty ──flip role──▶ serving (re-tier; clear_draining re-admits it)

A replica KILLED during its own drain (chaos point ``fleet.migrate``)
takes the mark-failed path: affinities purge, un-migrated sessions
re-prefill on their next touch — cold, never silently lost, and never
a bit different (the tests assert temp-0 survivor equality under the
``scale_storm`` scenario).

Locking: the fleet lock ("fleet", rank 5) guards the ledger and policy
counters only — it sits above the router (6) and handoff (8) locks the
actions take, and NO device work ever runs under it (drains run
unlocked; the engines' own paged/store locks serialize the page
traffic exactly as in a handoff).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from typing import Callable, Optional, Sequence

from quoracle_tpu_torch.chaos.faults import CHAOS, InjectedFault
from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.telemetry import (
    FLEET_ACTIONS_TOTAL, FLEET_DRAIN_MS, FLEET_DRAINING,
    FLEET_SESSIONS_MIGRATED_TOTAL, FLEET_TICKS_TOTAL,
)
from quoracle_tpu_torch.serving.admission import AdmissionError
from quoracle_tpu_torch.serving.handoff import HandoffError

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Signals: the policy's ONLY input
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplicaSignal:
    """One replica's load as the policy sees it: the same queue-depth
    number the admission controller sheds on (SignalSnapshot), plus the
    topology facts (role, draining, alive) the router holds."""

    replica_id: str
    role: str                      # "prefill" | "decode" | "unified"
    queue_depth: float = 0.0
    draining: bool = False
    alive: bool = True


@dataclasses.dataclass(frozen=True)
class FleetSignals:
    """The complete per-tick policy input. ``slo_burn`` is the
    INTERACTIVE tail-over-target ratio (serving/slo.py ``burn()``):
    1.0 = exactly at target, >1.0 = burning.

    ``forecast`` is the SHADOW-MODE predictive seam: sorted
    ``(class, events_per_s)`` pairs — a traffic-mix prior for the next
    window, computed by the fleet simulator's trace replay from the
    trace ahead of the clock. The policy records it (tick ledger,
    ``stats()["forecast"]``) but ``_decide`` stays forecast-blind until
    the predictive policy lands; nothing scales on a prediction yet."""

    replicas: tuple
    slo_burn: float = 0.0
    forecast: Optional[tuple] = None
    # OBSERVED only: per-class worst error-budget burn rate
    # from the chip-economics plane.  Recorded in the tick ledger beside
    # ``slo_burn``; ``_decide`` does not read it — scaling policy is
    # unchanged until a budget-aware policy is deliberately introduced.
    budget_burn: Optional[dict] = None
    # OBSERVED only: per-depth agent-tree fan-out priors
    # (mean children per node over the tree registry's current window)
    # — the predictive input the elastic-fleet roadmap item wants for
    # spawn-ahead capacity. ``_decide`` does not read it; nothing
    # scales on a tree shape yet.
    tree_fanout: Optional[dict] = None

    def tier(self, roles: tuple, serving_only: bool = True) -> list:
        return [r for r in self.replicas
                if r.role in roles and r.alive
                and (not serving_only or not r.draining)]


@dataclasses.dataclass
class FleetConfig:
    """Policy knobs. The scale bounds apply to the SERVING tier (decode
    replicas in a disaggregated plane, unified otherwise) — the tier
    whose depth is the goodput bottleneck; prefill-tier size moves only
    through re-tier flips, which conserve total replica count."""

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_depth: float = 8.0       # mean serving-tier queue depth
    scale_down_depth: float = 1.0
    burn_threshold: float = 1.0       # slo_burn above this = pressure
    hysteresis_ticks: int = 2         # consecutive ticks before acting
    cooldown_ticks: int = 3           # quiet ticks after any action
    retier_ratio: float = 4.0         # tier-imbalance factor
    seed: int = 0
    settle_timeout_s: float = 10.0    # drain quiescence bound
    settle_poll_s: float = 0.02

    def validate(self) -> "FleetConfig":
        if self.min_replicas < 1:
            raise ValueError("fleet min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("fleet max_replicas < min_replicas")
        return self


@dataclasses.dataclass(frozen=True)
class FleetAction:
    """One committed ledger entry. ``reason`` is a pure function of the
    tick's signals, so two replays of the same trace produce identical
    reason strings — the ledger is comparable wholesale."""

    tick: int
    action: str          # scale_up | scale_down | retier | drain | swap_draft
    target: str
    role: str
    reason: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def as_tuple(self) -> tuple:
        return (self.tick, self.action, self.target, self.role,
                self.reason)


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


class FleetController:
    """Signal-driven elasticity over one ClusterPlane.

    ``plane=None`` is DRY-RUN mode: the policy runs, the ledger fills,
    nothing executes — the determinism tests replay synthetic traces
    through it, and an operator can shadow a production trace before
    arming. ``tick()`` is not reentrant; the Runtime's ticker thread is
    its only production caller.
    """

    def __init__(self, plane=None, config: Optional[FleetConfig] = None,
                 slo=None, clock: Optional[Callable[[], float]] = None):
        self.plane = plane
        self.config = (config or FleetConfig()).validate()
        # explicit SLO tracker for the burn signal; falls back to the
        # replica backends' own trackers when the plane carries QoS
        self._slo = slo
        # wall clock for drain timing/telemetry ONLY — policy decisions
        # never read it (the determinism contract)
        self._clock = clock or time.monotonic
        self._lock = named_lock("fleet")
        self._ledger: list[FleetAction] = []
        self.tick_count = 0
        self._cooldown = 0
        self._up_streak = 0
        self._down_streak = 0
        self._mix_streak = 0           # signed: +prefill-starved,
        self._mix_dir = 0              # -decode-starved
        self._spawned = 0              # dry-run scale_up naming
        self._forecast_ticks = 0       # shadow seam: priors seen
        self._last_forecast: Optional[tuple] = None
        self.sessions_migrated = 0
        self.sessions_failed = 0
        self.drains = 0

    # -- signal gathering -------------------------------------------------

    def _serving_roles(self, signals: Optional[FleetSignals] = None
                       ) -> tuple:
        reps = (signals.replicas if signals is not None
                else tuple(self.plane.replicas))
        return (("decode",) if any(r.role == "prefill" for r in reps)
                else ("unified",))

    def gather(self) -> FleetSignals:
        """Live signals off the plane: per-replica queue depth from the
        admission controller's own SignalSnapshot (scheduler stats when
        QoS is off) and the max interactive burn across SLO trackers —
        the fleet steers on the numbers admission sheds on, one source
        of truth."""
        router = self.plane.router
        out = []
        for rep in router.replicas(None, include_draining=True):
            depth = 0.0
            ctrl = getattr(rep.backend, "qos_controller", None)
            if ctrl is not None:
                try:
                    depth = float(ctrl.signals().queue_depth)
                except Exception:         # noqa: BLE001 — silent peer
                    depth = 0.0
            else:
                try:
                    for st in rep.backend.scheduler_stats().values():
                        depth += (int(st.get("queued", 0))
                                  + int(st.get("live", 0)))
                except Exception:         # noqa: BLE001 — best-effort
                    pass
            out.append(ReplicaSignal(
                replica_id=rep.replica_id, role=rep.role,
                queue_depth=depth,
                draining=router.is_draining(rep.replica_id),
                alive=rep.alive))
        burn = 0.0
        if self._slo is not None:
            burn = self._slo.burn()
        else:
            for rep in self.plane.replicas:
                slo = getattr(rep.backend, "slo", None)
                if slo is not None:
                    burn = max(burn, slo.burn())
        from quoracle_tpu_torch.infra import costobs, treeobs
        budget = (costobs.BUDGET.burn_signals()
                  if costobs.enabled() else None)
        fanout = (treeobs.fanout_signals()
                  if treeobs.enabled() else None)
        return FleetSignals(replicas=tuple(out), slo_burn=burn,
                            budget_burn=budget or None,
                            tree_fanout=fanout or None)

    # -- deterministic policy ---------------------------------------------

    def _pick(self, cands: Sequence[ReplicaSignal], tick: int,
              action: str) -> ReplicaSignal:
        """Least-loaded candidate; ties break by a seeded hash (the
        chaos plane's discipline: explicit seed, no process salt), so
        replays pick identically and different seeds genuinely vary."""
        ranked = sorted(cands, key=lambda r: (r.queue_depth,
                                              r.replica_id))
        tied = [r for r in ranked
                if r.queue_depth == ranked[0].queue_depth]
        if len(tied) == 1:
            return tied[0]
        h = hashlib.sha256(
            f"{self.config.seed}:{tick}:{action}".encode()).digest()
        return tied[int.from_bytes(h[:4], "big") % len(tied)]

    def _decide(self, sig: FleetSignals) -> Optional[FleetAction]:
        """PURE policy: (signals, counters, config) → at most one
        action. Precedence: scale-up (SLO burn is the figure of merit)
        over re-tier (fixes the mix without new chips) over scale-down
        (reclaiming idle chips is never urgent)."""
        cfg = self.config
        tick = self.tick_count
        serving = self._serving_roles(sig)
        dec = sig.tier(serving)
        pre = sig.tier(("prefill",))
        mean_dec = (sum(r.queue_depth for r in dec) / len(dec)
                    if dec else 0.0)
        mean_pre = (sum(r.queue_depth for r in pre) / len(pre)
                    if pre else 0.0)
        burning = sig.slo_burn > cfg.burn_threshold
        # hysteresis streaks advance every evaluated tick
        if mean_dec > cfg.scale_up_depth or burning:
            self._up_streak += 1
        else:
            self._up_streak = 0
        if mean_dec < cfg.scale_down_depth and not burning:
            self._down_streak += 1
        else:
            self._down_streak = 0
        mix = 0
        if pre and mean_pre > cfg.retier_ratio * max(mean_dec, 0.5):
            mix = 1                      # prefill tier starved
        elif pre and mean_dec > cfg.retier_ratio * max(mean_pre, 0.5):
            mix = -1                     # decode tier starved
        if mix != 0 and mix == self._mix_dir:
            self._mix_streak += 1
        else:
            self._mix_dir, self._mix_streak = mix, (1 if mix else 0)
        need = cfg.hysteresis_ticks
        if self._up_streak >= need and len(dec) < cfg.max_replicas:
            return FleetAction(
                tick, "scale_up", self._new_name(serving[0]),
                serving[0],
                f"depth {mean_dec:.2f} > {cfg.scale_up_depth:g} or "
                f"burn {sig.slo_burn:.2f} > {cfg.burn_threshold:g} "
                f"x{self._up_streak} ticks, {len(dec)} < max "
                f"{cfg.max_replicas}")
        if self._mix_streak >= need:
            if self._mix_dir > 0 and len(dec) > cfg.min_replicas:
                victim = self._pick(dec, tick, "retier")
                return FleetAction(
                    tick, "retier", victim.replica_id, "prefill",
                    f"prefill depth {mean_pre:.2f} > "
                    f"{cfg.retier_ratio:g}x decode {mean_dec:.2f} "
                    f"x{self._mix_streak} ticks")
            if self._mix_dir < 0 and len(pre) > 1:
                victim = self._pick(pre, tick, "retier")
                return FleetAction(
                    tick, "retier", victim.replica_id, serving[0],
                    f"decode depth {mean_dec:.2f} > "
                    f"{cfg.retier_ratio:g}x prefill {mean_pre:.2f} "
                    f"x{self._mix_streak} ticks")
        if self._down_streak >= need and len(dec) > cfg.min_replicas:
            victim = self._pick(dec, tick, "scale_down")
            return FleetAction(
                tick, "scale_down", victim.replica_id, victim.role,
                f"depth {mean_dec:.2f} < {cfg.scale_down_depth:g} "
                f"x{self._down_streak} ticks, {len(dec)} > min "
                f"{cfg.min_replicas}")
        return None

    def _new_name(self, role: str) -> str:
        """Dry-run scale-up target name; live execution overwrites it
        with the plane-assigned replica id, which is equally
        deterministic (a monotonic per-plane counter)."""
        return f"{role}-+{self._spawned}"

    # -- the tick ---------------------------------------------------------

    def tick(self, signals: Optional[FleetSignals] = None
             ) -> Optional[FleetAction]:
        """Evaluate one policy tick and execute at most one action.
        ``signals`` injects a synthetic trace (tests, shadow runs);
        None gathers live from the plane."""
        from quoracle_tpu_torch.infra import introspect
        introspect.beat("fleet.tick")
        with self._lock:
            self.tick_count += 1
            if self._cooldown > 0:
                self._cooldown -= 1
                FLEET_TICKS_TOTAL.inc(outcome="cooldown")
                return None
        if signals is None:
            signals = self.gather()
        with self._lock:
            if signals.forecast is not None:
                # shadow seam: record the prior, decide without it
                self._forecast_ticks += 1
                self._last_forecast = signals.forecast
            planned = self._decide(signals)
            if planned is None:
                FLEET_TICKS_TOTAL.inc(outcome="hold")
                return None
            self._cooldown = self.config.cooldown_ticks
            self._up_streak = self._down_streak = 0
            self._mix_dir, self._mix_streak = 0, 0
            if planned.action == "scale_up":
                self._spawned += 1
        executed = planned
        if self.plane is not None:
            executed = self._execute(planned)
        with self._lock:
            self._ledger.append(executed)
        FLEET_TICKS_TOTAL.inc(outcome="action")
        FLEET_ACTIONS_TOTAL.inc(action=executed.action,
                                role=executed.role)
        FLIGHT.record("fleet_action", **executed.as_dict())
        self._broadcast({"event": "fleet_action", **executed.as_dict()})
        return executed

    def _execute(self, a: FleetAction) -> FleetAction:
        if a.action == "scale_up":
            rep = self.plane.add_replica(a.role)
            return dataclasses.replace(a, target=rep.replica_id)
        if a.action == "scale_down":
            self.drain(a.target, retire=True, reason=a.reason)
            return a
        if a.action == "retier":
            self.drain(a.target, new_role=a.role, reason=a.reason)
            return a
        return a

    # -- draft hot-swap: the promotion primitive (training's promoter,
    #    ROADMAP Queue 1 item 11, is its only caller that passes a
    #    chaos_point) --------------------------------------------------

    def swap_draft(self, replica_id: str, tspec: str, engine_factory,
                   *, draft_name: str, reason: str = "promotion",
                   chaos_point: Optional[str] = "train.promote") -> dict:
        """Zero-downtime per-replica draft hot-swap, ledgered as a
        ``swap_draft`` :class:`FleetAction`.

        Reuses the drain machinery's quiesce half — mark the replica
        draining (no new placements), wait for in-flight rows to settle
        — but sessions STAY aboard: the target's paged KV is untouched
        and draft KV is derived state that cold re-prefills into the
        new engine on each row's next round, so there is nothing to
        migrate. The swap itself is a pointer exchange under the
        speculator's lock.

        ``chaos_point`` fires before the swap (``train.promote`` on the
        promotion rollout): a crash there leaves the INCUMBENT serving
        — the exchange never started — and propagates so the promoter
        rolls back the replicas already swapped. The rollback direction
        passes ``chaos_point=None``: restoring an engine object that
        was serving minutes ago has no build/disk step to fail, so it
        carries no injection point of its own.

        Returns ``{"action", "incumbent", "ms"}`` — the ledgered action
        and the swapped-out engine for instant rollback."""
        rep = self._replica(replica_id)
        router = self.plane.router
        router.mark_draining(replica_id)
        FLEET_DRAINING.set(len(router.stats()["draining"]))
        t0 = self._clock()
        try:
            self._settle(rep)
            if chaos_point is not None:
                CHAOS.fire(chaos_point, replica=replica_id, model=tspec)
            incumbent = rep.backend.swap_draft(tspec, engine_factory(),
                                               name=draft_name)
        finally:
            router.clear_draining(replica_id)
            FLEET_DRAINING.set(len(router.stats()["draining"]))
        ms = (self._clock() - t0) * 1000
        with self._lock:
            action = FleetAction(tick=self.tick_count,
                                 action="swap_draft", target=replica_id,
                                 role=rep.role,
                                 reason=f"{reason}:{tspec}->{draft_name}")
            self._ledger.append(action)
        FLEET_ACTIONS_TOTAL.inc(action="swap_draft", role=rep.role)
        FLIGHT.record("fleet_action", **action.as_dict())
        self._broadcast({"event": "fleet_action", **action.as_dict()})
        return {"action": action.as_dict(), "incumbent": incumbent,
                "ms": round(ms, 2)}

    # -- drain: the live-migration primitive ------------------------------

    def _replica(self, replica_id: str):
        rep = next((r for r in self.plane.replicas
                    if r.replica_id == replica_id), None)
        if rep is None:
            raise ValueError(f"unknown replica {replica_id!r}")
        return rep

    def drain(self, replica_id: str, *, retire: bool = False,
              new_role: Optional[str] = None,
              reason: str = "forced") -> dict:
        """Drain one replica: exclude it from new placements, wait for
        its in-flight rows to settle, live-migrate every resident
        session to a peer through the handoff path (affinity rewritten
        per session), then retire it (``retire``) or flip its role
        (``new_role``) or return it to service. Returns the drain
        summary; the one primitive behind scale-down, re-tier, and
        model hot-swap."""
        rep = self._replica(replica_id)
        router = self.plane.router
        router.mark_draining(replica_id)
        FLEET_DRAINING.set(len(router.stats()["draining"]))
        t0 = self._clock()
        died = False
        migrated = failed = 0
        try:
            self._settle(rep)
            migrated, failed, died = self._migrate_all(rep)
        finally:
            if died:
                # killed during its own drain: mark-failed already
                # purged its affinities; un-migrated sessions re-prefill
                # on their next touch — cold, never silently lost
                if retire:
                    self.plane.remove_replica(replica_id)
            elif retire:
                self.plane.remove_replica(replica_id)
            elif new_role is not None:
                self._flip_role(rep, new_role)
                router.clear_draining(replica_id)
            else:
                router.clear_draining(replica_id)
            FLEET_DRAINING.set(len(router.stats()["draining"]))
        ms = (self._clock() - t0) * 1000
        FLEET_DRAIN_MS.observe(ms)
        from quoracle_tpu_torch.infra.telemetry import TRACER
        if TRACER.active():
            TRACER.emit("fleet.drain", ms, replica=replica_id,
                        reason=reason, migrated=migrated,
                        failed=failed, retired=bool(retire))
        with self._lock:
            self.drains += 1
            self.sessions_migrated += migrated
            self.sessions_failed += failed
        summary = {"replica": replica_id, "reason": reason,
                   "migrated": migrated, "failed": failed,
                   "died": died, "retired": retire and not died or died,
                   "new_role": new_role, "ms": round(ms, 2)}
        FLIGHT.record("fleet_drain", **summary)
        self._broadcast({"event": "fleet_drain", **summary})
        return summary

    def _settle(self, rep) -> None:
        """Wait (bounded) for the replica's queued + live rows to reach
        zero: new placements are already excluded, so quiescence is a
        matter of letting in-flight work retire. Mechanism, not policy
        — the wall clock here never reaches a decision."""
        deadline = self._clock() + self.config.settle_timeout_s
        while self._clock() < deadline:
            depth = 0
            try:
                for st in rep.backend.scheduler_stats().values():
                    depth += (int(st.get("queued", 0))
                              + int(st.get("live", 0)))
            except Exception:             # noqa: BLE001 — best-effort
                return
            if depth == 0:
                return
            time.sleep(self.config.settle_poll_s)
        logger.warning("drain settle timed out on %s; migrating with "
                       "rows in flight", rep.replica_id)

    def _migrate_all(self, rep) -> tuple:
        """Move every resident (and hibernated) session off ``rep``.
        Returns (migrated, failed, died)."""
        migrated = failed = 0
        target_role = ("decode" if self.plane.disaggregated
                       else "unified")
        if rep.role == "unified":
            target_role = "unified"
        for spec in self.plane.pool:
            eng = rep.backend.engines.get(spec)
            if eng is None:
                continue
            with eng.sessions.lock:
                keys = list(eng.sessions._sessions)
                tier = eng.sessions.tier
                if tier is not None:
                    keys += [k for k in tier.host.sessions
                             if k not in eng.sessions._sessions]
            for sid in keys:
                try:
                    d = CHAOS.fire("fleet.migrate",
                                   replica=rep.replica_id)
                except InjectedFault as e:
                    # the draining replica died with sessions aboard
                    self.plane._mark_failed(rep, repr(e))
                    remaining = len(keys) - migrated - failed
                    FLEET_SESSIONS_MIGRATED_TOTAL.inc(
                        remaining, model=spec, status="failed")
                    return migrated, failed + remaining, True
                if d is not None and d.kind == "fail":
                    failed += self._note_failed(
                        rep, spec, sid, "chaos-injected migrate fail")
                    continue
                if self._migrate_one(rep, eng, spec, sid, target_role):
                    migrated += 1
                else:
                    failed += 1
        return migrated, failed, False

    def _migrate_one(self, rep, eng, spec: str, sid: str,
                     target_role: str) -> bool:
        router = self.plane.router
        handoff = self.plane.handoff
        t_mig = time.monotonic()
        try:
            target = router.place(target_role,
                                  exclude=(rep.replica_id,))
        except AdmissionError as e:
            self._note_failed(rep, spec, sid, f"no target: {e}")
            return False
        try:
            env = handoff.export(eng, sid, spec,
                                 src_replica=rep.replica_id)
        except HandoffError as e:
            self._note_failed(rep, spec, sid, f"export: {e}")
            return False
        try:
            handoff.adopt(target.backend.engines[spec], env,
                          dst_replica=target.replica_id)
        except HandoffError as e:
            self._note_failed(rep, spec, sid, f"adopt: {e}")
            return False
        finally:
            # the envelope ledger must not leak drained sessions: a
            # migrated row's failover source is its NEW replica now
            handoff.forget(spec, sid)
        router.set_affinity(sid, target.replica_id)
        FLEET_SESSIONS_MIGRATED_TOTAL.inc(model=spec, status="ok")
        from quoracle_tpu_torch.infra.telemetry import TRACER
        if TRACER.active():
            # live migrations join the session's trace:
            # observability only — the policy's no-wall-clock contract
            # covers decisions, not span timestamps
            mig_ms = (time.monotonic() - t_mig) * 1000
            TRACER.emit("fleet.migrate", mig_ms,
                        ts=time.time() - mig_ms / 1000.0, session=sid,
                        model=spec, src=rep.replica_id,
                        dst=target.replica_id)
        return True

    def _note_failed(self, rep, spec: str, sid: str, why: str) -> int:
        """One session's migration degraded: drop its affinity so the
        next touch re-places fresh and re-prefills — cold, correct."""
        self.plane.router.drop_affinity(sid)
        self.plane.handoff.forget(spec, sid)
        FLEET_SESSIONS_MIGRATED_TOTAL.inc(model=spec, status="failed")
        FLIGHT.record("fleet_migrate_failed", replica=rep.replica_id,
                      model=spec, session=sid, why=why[:160])
        return 1

    def _flip_role(self, rep, new_role: str) -> None:
        """Re-tier flip after the drain emptied the replica. A flipped
        prefill→decode replica decodes through the direct engine path
        (no batcher was built for it) — slower than a born-decode
        replica, bit-identical by the engine equality gates; the next
        reboot rebuilds it natively."""
        rep.role = new_role
        for spec in self.plane.pool:
            eng = rep.backend.engines.get(spec)
            if eng is not None:
                eng.role = new_role
        self.plane._recompute_modes()
        self.plane._refresh_replica_gauges()

    # -- bus / reads ------------------------------------------------------

    def _broadcast(self, event: dict) -> None:
        bus = getattr(self.plane, "_bus", None) if self.plane else None
        if bus is None:
            return
        try:
            from quoracle_tpu_torch.infra.bus import TOPIC_FLEET
            bus.broadcast(TOPIC_FLEET, {"ts": time.time(), **event})
        except Exception:                 # noqa: BLE001 — telemetry only
            logger.exception("fleet broadcast failed")

    def ledger(self) -> list[dict]:
        with self._lock:
            return [a.as_dict() for a in self._ledger]

    def ledger_tuples(self) -> list[tuple]:
        with self._lock:
            return [a.as_tuple() for a in self._ledger]

    def stats(self) -> dict:
        """GET /api/fleet payload: policy config, tick/cooldown state,
        migration totals, and the recent action ledger."""
        cfg = self.config
        with self._lock:
            ledger = [a.as_dict() for a in self._ledger[-32:]]
            out = {
                "enabled": True,
                "dry_run": self.plane is None,
                "ticks": self.tick_count,
                "cooldown": self._cooldown,
                "streaks": {"up": self._up_streak,
                            "down": self._down_streak,
                            "mix": self._mix_dir * self._mix_streak},
                "drains": self.drains,
                "sessions_migrated": self.sessions_migrated,
                "sessions_failed": self.sessions_failed,
                "forecast": {
                    "shadow": True,
                    "ticks": self._forecast_ticks,
                    "last": (dict(self._last_forecast)
                             if self._last_forecast is not None
                             else None),
                },
                "config": {
                    "min_replicas": cfg.min_replicas,
                    "max_replicas": cfg.max_replicas,
                    "scale_up_depth": cfg.scale_up_depth,
                    "scale_down_depth": cfg.scale_down_depth,
                    "burn_threshold": cfg.burn_threshold,
                    "hysteresis_ticks": cfg.hysteresis_ticks,
                    "cooldown_ticks": cfg.cooldown_ticks,
                    "retier_ratio": cfg.retier_ratio,
                    "seed": cfg.seed,
                },
                "ledger": ledger,
            }
        if self.plane is not None:
            out["router"] = self.plane.router.stats()
        return out
