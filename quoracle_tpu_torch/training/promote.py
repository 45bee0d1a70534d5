"""Bench-gated live promotion: the flywheel's last mile (port of
``quoracle_tpu/training/promote.py``).

A candidate draft reaches production only through :class:`Promoter`,
and only when the offline evidence (:func:`quoracle_tpu_torch.training.
evaluate.compare`) clears :func:`gate`: acceptance-p50 margin over the
incumbent AND temp-0 greedy equality. Promotion then rolls through the
fleet one replica at a time via ``FleetController.swap_draft`` (the
drain/hot-swap of serving/fleet.py), so in-flight work lands before each
swap and sessions stay aboard (draft KV is derived state). Every
incumbent engine is recorded before its replica swaps; any mid-rollout
failure (including an injected ``train.promote`` crash) rolls the
already-swapped replicas back to their proven incumbents before the
exception propagates. A single process swaps through
``TorchBackend.swap_draft`` (``promote_backend``).

After a successful rollout an :class:`AcceptanceGuard` arms: the live
acceptance EWMA must stay above ``offline_candidate_p50 * floor_frac``
(consecutive-breach trip, not a single-sample panic). A trip auto-rolls
the fleet back and records a ``train_rollback`` flight event; the
incumbent engines are still held, so rollback is an in-memory pointer
swap with no build/disk step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.bus import TOPIC_TRAIN
from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.telemetry import TRAIN_PROMOTIONS_TOTAL


@dataclass(frozen=True)
class PromotionPolicy:
    """What a candidate must prove before (and after) it serves."""

    margin_p50: float = 0.02        # candidate p50 must beat incumbent by this
    min_examples: int = 8           # offline slice too thin -> reject
    floor_frac: float = 0.8         # live floor = candidate_p50 * floor_frac
    min_rounds: int = 20            # guard ignores EWMA before this many rounds
    trip_after: int = 3             # consecutive breaches before rollback
    require_greedy_equal: bool = True


def gate(report: dict, policy: PromotionPolicy, greedy_ok: bool) -> tuple[bool, str]:
    """The promotion decision, pure and auditable: (ok, reason)."""
    if policy.require_greedy_equal and not greedy_ok:
        return False, "greedy_mismatch"
    if report.get("n", report.get("candidate", {}).get("n", 0)) < policy.min_examples:
        return False, "too_few_examples"
    margin = report.get("margin_p50", 0.0)
    if margin < policy.margin_p50:
        return False, f"margin {margin:+.4f} < {policy.margin_p50:+.4f}"
    return True, f"margin {margin:+.4f}"


class AcceptanceGuard:
    """Live regression detector (the drift idiom, specialized): the
    offline-measured candidate p50 sets the floor; ``observe`` trips
    after ``trip_after`` consecutive EWMA samples below it."""

    def __init__(self, floor: float, policy: PromotionPolicy):
        self.floor = floor
        self.policy = policy
        self._breaches = 0
        self.tripped = False

    def observe(self, ewma: Optional[float], rounds: int) -> bool:
        """Feed one live sample; returns True exactly once, on trip."""
        if self.tripped or ewma is None or rounds < self.policy.min_rounds:
            return False
        if ewma < self.floor:
            self._breaches += 1
            if self._breaches >= self.policy.trip_after:
                self.tripped = True
                return True
        else:
            self._breaches = 0
        return False

    def stats(self) -> dict:
        return {"floor": round(self.floor, 4), "breaches": self._breaches,
                "tripped": self.tripped}


@dataclass
class _Rollout:
    """One completed promotion: everything rollback needs."""

    tspec: str
    draft_name: str
    incumbent_name: str
    incumbents: list  # [(replica_id, engine, name)] — mono replica_id None
    guard: AcceptanceGuard
    report: dict
    promoted_ts: float
    rolled_back: bool = False
    rollback_reason: Optional[str] = None


class Promoter:
    """Drives promotions and watches their aftermath. One instance per
    control plane; all mutation under the ``train.promote`` lock (rank
    2 — outermost, so the fleet/engine locks it drives nest cleanly)."""

    def __init__(self, policy: Optional[PromotionPolicy] = None):
        self.policy = policy or PromotionPolicy()
        self._lock = named_lock("train.promote")
        self._rollouts: list[_Rollout] = []
        self._rejected = 0

    # -- rollout ----------------------------------------------------------

    def promote_fleet(self, controller, tspec: str,
                      engine_factory: Callable[[], Any], *,
                      draft_name: str, report: dict,
                      greedy_ok: bool) -> dict:
        """Gate, then roll the candidate through every live replica
        serving ``tspec`` via drain/hot-swap. Atomic at fleet scope: a
        failure mid-rollout restores every already-swapped replica's
        incumbent before re-raising."""
        with self._lock:
            ok, reason = gate(report, self.policy, greedy_ok)
            model = report.get("model", tspec)
            if not ok:
                self._rejected += 1
                TRAIN_PROMOTIONS_TOTAL.inc(model=model, outcome="rejected")
                FLIGHT.record("train_promote", model=model, tspec=tspec,
                              draft=draft_name, outcome="rejected",
                              reason=reason)
                return {"promoted": False, "reason": reason}
            swapped: list = []
            incumbent_name = None
            try:
                for rep in list(controller.plane.replicas):
                    if tspec not in rep.backend.draft_map:
                        continue
                    # the serving name, not engine.cfg.name: rollback
                    # must restore the exact draft_map entry it replaced
                    prior = rep.backend.draft_map[tspec]
                    res = controller.swap_draft(
                        rep.replica_id, tspec, engine_factory,
                        draft_name=draft_name, reason="promotion")
                    if incumbent_name is None:
                        incumbent_name = prior
                    swapped.append((rep.replica_id, res["incumbent"],
                                    prior))
            except Exception:
                for replica_id, engine, prior in swapped:
                    controller.swap_draft(
                        replica_id, tspec, lambda e=engine: e,
                        draft_name=prior,
                        reason="rollback:promote_failed",
                        chaos_point=None)
                TRAIN_PROMOTIONS_TOTAL.inc(model=model, outcome="failed")
                FLIGHT.record("train_rollback", model=model, tspec=tspec,
                              draft=draft_name, outcome="failed",
                              replicas=len(swapped))
                raise
            rollout = self._arm(tspec, draft_name, incumbent_name,
                                swapped, model, report, reason)
        # broadcast AFTER the lock drops: bus handlers run inline on the
        # broadcasting thread and must not nest under train.promote
        self._announce(controller, rollout, len(swapped))
        return {"promoted": True, "reason": reason,
                "replicas": len(swapped),
                "floor": rollout.guard.floor}

    def promote_backend(self, backend, tspec: str,
                        engine_factory: Callable[[], Any], *,
                        draft_name: str, report: dict,
                        greedy_ok: bool) -> dict:
        """Mono-process variant: same gate and guard, the swap is a
        single ``TorchBackend.swap_draft`` with no drain choreography."""
        with self._lock:
            ok, reason = gate(report, self.policy, greedy_ok)
            model = report.get("model", tspec)
            if not ok:
                self._rejected += 1
                TRAIN_PROMOTIONS_TOTAL.inc(model=model, outcome="rejected")
                FLIGHT.record("train_promote", model=model, tspec=tspec,
                              draft=draft_name, outcome="rejected",
                              reason=reason)
                return {"promoted": False, "reason": reason}
            prior = backend.draft_map[tspec]
            old = backend.swap_draft(tspec, engine_factory(), name=draft_name)
            rollout = self._arm(tspec, draft_name, prior,
                                [(None, old, prior)], model, report, reason)
            return {"promoted": True, "reason": reason, "replicas": 1,
                    "floor": rollout.guard.floor}

    def _arm(self, tspec, draft_name, incumbent_name, incumbents, model,
             report, reason) -> _Rollout:
        floor = report["candidate"]["p50"] * self.policy.floor_frac
        rollout = _Rollout(tspec=tspec, draft_name=draft_name,
                           incumbent_name=incumbent_name or "?",
                           incumbents=incumbents,
                           guard=AcceptanceGuard(floor, self.policy),
                           report=report, promoted_ts=time.time())
        self._rollouts.append(rollout)
        TRAIN_PROMOTIONS_TOTAL.inc(model=model, outcome="promoted")
        FLIGHT.record("train_promote", model=model, tspec=tspec,
                      draft=draft_name, incumbent=rollout.incumbent_name,
                      outcome="promoted", reason=reason,
                      floor=round(floor, 4))
        return rollout

    def _announce(self, controller, rollout: _Rollout, n: int) -> None:
        bus = getattr(controller.plane, "_bus", None)
        if bus is not None:
            bus.broadcast(TOPIC_TRAIN, {
                "ts": time.time(), "event": "promote",
                "tspec": rollout.tspec, "draft": rollout.draft_name,
                "incumbent": rollout.incumbent_name, "replicas": n,
                "floor": round(rollout.guard.floor, 4)})

    # -- live regression watch --------------------------------------------

    def check_live(self, controller=None, backend=None) -> list[dict]:
        """Poll live acceptance for every armed rollout; auto-roll back
        any whose guard trips. Call from the control loop (or a test's
        hand crank). Returns the rollback records issued this call."""
        events: list[dict] = []
        with self._lock:
            for rollout in self._rollouts:
                if rollout.rolled_back:
                    continue
                ewma, rounds = self._live_sample(rollout.tspec,
                                                 controller, backend)
                if rollout.guard.observe(ewma, rounds):
                    events.append(self._rollback(rollout, controller,
                                                 backend, ewma))
        for ev in events:                  # broadcast outside the lock
            self._announce_rollback(controller, ev)
        return events

    def observe(self, tspec: str, ewma: Optional[float], rounds: int,
                controller=None, backend=None) -> Optional[dict]:
        """Explicit-sample variant of :meth:`check_live` for callers
        that already hold the speculator stats."""
        ev = None
        with self._lock:
            for rollout in self._rollouts:
                if rollout.rolled_back or rollout.tspec != tspec:
                    continue
                if rollout.guard.observe(ewma, rounds):
                    ev = self._rollback(rollout, controller, backend,
                                        ewma)
                    break
        if ev is not None:                 # broadcast outside the lock
            self._announce_rollback(controller, ev)
        return ev

    def _live_sample(self, tspec, controller, backend):
        ewmas, rounds = [], 0
        stats_srcs = []
        if controller is not None:
            stats_srcs = [rep.backend for rep in controller.plane.replicas
                          if tspec in rep.backend.draft_map]
        elif backend is not None:
            stats_srcs = [backend]
        for be in stats_srcs:
            member = be.spec_stats().get("members", {}).get(tspec, {})
            e = member.get("acceptance_ewma")
            if e is not None:
                ewmas.append(e)
            rounds += member.get("rounds", 0)
        ewma = min(ewmas) if ewmas else None  # worst replica trips first
        return ewma, rounds

    def _rollback(self, rollout: _Rollout, controller, backend,
                  ewma) -> dict:
        model = rollout.report.get("model", rollout.tspec)
        restored = 0
        for replica_id, engine, prior in rollout.incumbents:
            if controller is not None and replica_id is not None:
                controller.swap_draft(
                    replica_id, rollout.tspec, lambda e=engine: e,
                    draft_name=prior,
                    reason="rollback:acceptance_regression",
                    chaos_point=None)
            elif backend is not None:
                backend.swap_draft(rollout.tspec, engine, name=prior)
            restored += 1
        rollout.rolled_back = True
        rollout.rollback_reason = "acceptance_regression"
        TRAIN_PROMOTIONS_TOTAL.inc(model=model, outcome="rolled_back")
        FLIGHT.record("train_rollback", model=model, tspec=rollout.tspec,
                      draft=rollout.draft_name, outcome="regression",
                      ewma=ewma, floor=round(rollout.guard.floor, 4),
                      replicas=restored)
        return {"tspec": rollout.tspec, "draft": rollout.draft_name,
                "restored": rollout.incumbent_name, "replicas": restored,
                "ewma": ewma}

    def _announce_rollback(self, controller, ev: dict) -> None:
        if controller is None:
            return
        bus = getattr(controller.plane, "_bus", None)
        if bus is not None:
            bus.broadcast(TOPIC_TRAIN, {
                "ts": time.time(), "event": "rollback",
                "tspec": ev["tspec"], "draft": ev["draft"],
                "restored": ev["restored"], "ewma": ev["ewma"]})

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "policy": {
                    "margin_p50": self.policy.margin_p50,
                    "floor_frac": self.policy.floor_frac,
                    "trip_after": self.policy.trip_after,
                },
                "rejected": self._rejected,
                "rollouts": [{
                    "tspec": r.tspec, "draft": r.draft_name,
                    "incumbent": r.incumbent_name,
                    "margin_p50": r.report.get("margin_p50"),
                    "guard": r.guard.stats(),
                    "rolled_back": r.rolled_back,
                    "rollback_reason": r.rollback_reason,
                } for r in self._rollouts],
            }
