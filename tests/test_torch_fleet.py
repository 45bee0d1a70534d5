"""The port's elastic fleet controller (serving/fleet.py) against the JAX
package's, on the CPU.

The cases of tests/test_fleet.py that need no cross-host fabric, each run
on both packages over the same fp32 tiny weights (tests/_cluster_parity.py)
and the same requests: drains that live-migrate every resident session
(greedy, constrained, speculative) with temperature-0 texts and cached
tokens equal to a never-drained monolithic backend and no envelope left;
the action ledger of a replayed signal trace, reason strings included,
equal across the packages; hysteresis, cooldown and bounds; the router's
draining state; live scale-up, retirement and re-tier; a replica killed
during its own drain (the ``fleet.migrate`` chaos point); the registries,
``/api/fleet`` and the fleet ring. ``pool_sizing``'s fleet envelope (the
JAX ``parallel/``, ROADMAP Queue 1 item 12) has no port; its case holds
the port controller's serving tier and bounds to the JAX plan's.
"""

import pytest
import torch

from _cluster_parity import (
    JAX, MEMBER, PORT, SIDES, backend, both, build_cluster,
    jax_shared_backends, req, res,
)

torch.set_num_threads(1)

MSGS = [{"role": "user", "content": "hello elastic fleet, please "
                                    "elaborate at length"}]


@pytest.fixture(scope="module")
def planes():
    """A monolithic backend, a 1 prefill + 2 decode cluster and its
    controller a package; the JAX side's replica factory stays on the
    shared weights for the whole module (scale-ups build replicas)."""
    with jax_shared_backends():
        out = {}
        for side in SIDES:
            cl = build_cluster(side, replicas=3, disaggregate=True,
                               continuous=True, continuous_chunk=8)
            fc = side.fl.FleetController(cl, side.fl.FleetConfig(
                min_replicas=1, max_replicas=4, hysteresis_ticks=2,
                cooldown_ticks=2, seed=7))
            out[side.name] = (backend(side, continuous=True,
                                      continuous_chunk=8), cl, fc)
        yield out
        for mono, cl, _ in out.values():
            mono.close()
            cl.close()


def _summary(s: dict) -> dict:
    return {k: v for k, v in s.items() if k != "ms"}


# ---------------------------------------------------------------------------
# Drain-migration equality
# ---------------------------------------------------------------------------

def _drain_round_trip(side, mono, cl, fleet, sid, cj=False,
                      max_tokens=20):
    a1 = mono.query([req(side, MSGS, sid=sid, cj=cj,
                         max_tokens=max_tokens)])[0]
    b1 = cl.query([req(side, MSGS, sid=sid, cj=cj,
                       max_tokens=max_tokens)])[0]
    assert a1.ok and b1.ok, (a1.error, b1.error)
    assert b1.text == a1.text
    src = cl.router.affinity_of(sid)
    assert src is not None and src.role == "decode"
    summary = fleet.drain(src.replica_id, reason="test")
    assert summary["migrated"] >= 1 and summary["failed"] == 0
    assert not summary["died"]
    dst = cl.router.affinity_of(sid)
    assert dst is not None and dst.replica_id != src.replica_id
    assert cl.handoff.stats()["inflight"] == 0
    msgs2 = MSGS + [{"role": "assistant", "content": a1.text},
                    {"role": "user", "content": "continue."}]
    exports_before = cl.handoff.exports
    a2 = mono.query([req(side, msgs2, sid=sid, cj=cj,
                         max_tokens=max_tokens)])[0]
    b2 = cl.query([req(side, msgs2, sid=sid, cj=cj,
                       max_tokens=max_tokens)])[0]
    assert a2.ok and b2.ok, (a2.error, b2.error)
    assert b2.text == a2.text
    assert cl.handoff.exports == exports_before
    assert b2.cached_tokens == a2.cached_tokens > 0
    cl.drop_session(sid)
    mono.drop_session(sid)
    return [res(a1), res(b1), _summary(summary), src.replica_id,
            dst.replica_id, res(a2), res(b2), cl.handoff.stats()]


@pytest.mark.parametrize("cj", [False, True], ids=["greedy", "constrained"])
def test_drain_migration_bit_equal(planes, cj):
    def case(side):
        mono, cl, fc = planes[side.name]
        return _drain_round_trip(side, mono, cl, fc, f"fleet-{int(cj)}",
                                 cj=cj)
    both(case)


def test_drain_migration_speculative_bit_equal():
    def case(side):
        kw = dict(continuous=True, continuous_chunk=8,
                  draft_map={MEMBER: MEMBER}, draft_k=4)
        mono = backend(side, **kw)
        cl = build_cluster(side, replicas=3, disaggregate=True, **kw)
        fc = side.fl.FleetController(cl)
        try:
            obs = _drain_round_trip(side, mono, cl, fc, "fleet-sp",
                                    cj=True, max_tokens=24)
            assert obs[6][6] > 0          # the migrated row drafted
            return obs
        finally:
            mono.close()
            cl.close()
    both(case)


def test_forced_drain_migrates_every_resident_session(planes):
    def case(side):
        _, cl, fleet = planes[side.name]
        sids = [f"fleet-all{i}" for i in range(3)]
        outs = [cl.query([req(side, MSGS, sid=sid, max_tokens=10)])[0]
                for sid in sids]
        assert all(o.ok for o in outs)
        src = cl.router.affinity_of(sids[0])
        eng = src.backend.engines[MEMBER]
        with eng.sessions.lock:
            resident = (len(eng.sessions._sessions)
                        + len(eng.sessions.tier.host.sessions))
        assert resident >= 1
        summary = fleet.drain(src.replica_id, reason="migrate-all")
        assert summary["migrated"] == resident and summary["failed"] == 0
        with eng.sessions.lock:
            assert not eng.sessions._sessions
            assert not eng.sessions.tier.host.sessions
        assert cl.handoff.stats()["inflight"] == 0
        where = []
        for sid in sids:
            rep = cl.router.affinity_of(sid)
            assert rep is None or rep.replica_id != src.replica_id
            where.append(rep.replica_id if rep else None)
            cl.drop_session(sid)
        return [[res(o) for o in outs], src.replica_id, resident,
                _summary(summary), where]
    both(case)


# ---------------------------------------------------------------------------
# Deterministic policy
# ---------------------------------------------------------------------------

def _trace(side):
    F = side.fl
    ticks = []
    for t in range(24):
        if 1 <= t <= 5:
            dec_depth, pre_depth, burn = 12.0, 0.0, 1.8
        elif 8 <= t <= 12:
            dec_depth, pre_depth, burn = 0.5, 9.0, 0.0
        else:
            dec_depth, pre_depth, burn = 0.0, 0.0, 0.0
        ticks.append(F.FleetSignals(replicas=(
            F.ReplicaSignal("prefill-0", "prefill", pre_depth),
            F.ReplicaSignal("decode-1", "decode", dec_depth),
            F.ReplicaSignal("decode-2", "decode", dec_depth),
            F.ReplicaSignal("decode-3", "decode", dec_depth),
        ), slo_burn=burn))
    return ticks


@pytest.mark.parametrize("seed", [7, 8, 11])
def test_synthetic_trace_replay_identical_ledger(seed):
    """Two replays in a package give one ledger, and the packages give
    the same one, reason strings included."""
    def case(side):
        cfg = side.fl.FleetConfig(min_replicas=2, max_replicas=4,
                                  hysteresis_ticks=2, cooldown_ticks=2,
                                  seed=seed)
        a = side.fl.FleetController(None, cfg)
        b = side.fl.FleetController(None, cfg)
        for sig in _trace(side):
            a.tick(sig)
        for sig in _trace(side):
            b.tick(sig)
        assert a.ledger_tuples() == b.ledger_tuples()
        st = a.stats()
        return [a.ledger_tuples(), {k: st[k] for k in (
            "ticks", "cooldown", "streaks", "drains", "dry_run")}]
    obs = both(case)
    actions = [t[1] for t in obs[0]]
    assert {"scale_up", "retier", "scale_down"} <= set(actions)
    assert all(len(t) == 5 and t[4] for t in obs[0])


def test_seed_changes_tie_breaks_not_structure():
    def case(side):
        kw = dict(min_replicas=2, max_replicas=4, hysteresis_ticks=2,
                  cooldown_ticks=2)
        a = side.fl.FleetController(None, side.fl.FleetConfig(seed=7,
                                                               **kw))
        b = side.fl.FleetController(None, side.fl.FleetConfig(seed=8,
                                                               **kw))
        for sig in _trace(side):
            a.tick(sig)
            b.tick(sig)
        assert [t[:2] for t in a.ledger_tuples()] \
            == [t[:2] for t in b.ledger_tuples()]
        return [a.ledger_tuples(), b.ledger_tuples()]
    both(case)


def test_hysteresis_and_cooldown():
    def case(side):
        F = side.fl
        cfg = F.FleetConfig(min_replicas=1, max_replicas=4,
                            hysteresis_ticks=2, cooldown_ticks=3, seed=0)
        fc = F.FleetController(None, cfg)
        burn = F.FleetSignals(replicas=(
            F.ReplicaSignal("decode-1", "unified", 20.0),), slo_burn=2.0)
        out = [fc.tick(burn) for _ in range(7)]
        return [a.as_tuple() if a is not None else None for a in out]
    obs = both(case)
    assert [a is not None for a in obs] == [False, True, False, False,
                                            False, False, True]


def test_scale_bounds_respected():
    def case(side):
        F = side.fl
        fc = F.FleetController(None, F.FleetConfig(
            min_replicas=1, max_replicas=1, hysteresis_ticks=1,
            cooldown_ticks=0, seed=0))
        one = F.FleetSignals(replicas=(
            F.ReplicaSignal("unified-0", "unified", 50.0),), slo_burn=3.0)
        idle = F.FleetSignals(replicas=(
            F.ReplicaSignal("unified-0", "unified", 0.0),), slo_burn=0.0)
        return [fc.tick(one), fc.tick(idle), fc.ledger()]
    assert both(case) == [None, None, []]


# ---------------------------------------------------------------------------
# Router draining semantics
# ---------------------------------------------------------------------------

def test_router_mark_draining_vs_mark_failed():
    def case(side):
        class _Rep:
            def __init__(self, rid, role):
                self.replica_id, self.role = rid, role
                self.alive = True
                self.backend = type("B", (), {"qos_controller": None,
                                              "scheduler_stats":
                                              staticmethod(dict)})()

        router = side.ro.ClusterRouter()
        a, b = _Rep("decode-a", "decode"), _Rep("decode-b", "decode")
        router.register(a)
        router.register(b)
        router.set_affinity("s1", "decode-a")
        router.mark_draining("decode-a")
        obs = [[r.replica_id for r in router.replicas("decode")],
               router.place("decode").replica_id,
               router.affinity_of("s1").replica_id,
               router.place("decode", session_id="s1").replica_id,
               router.is_draining("decode-a")]
        router.clear_draining("decode-a")
        obs.append(len(router.replicas("decode")))
        router.mark_failed("decode-a", "test")
        obs.append(router.affinity_of("s1"))
        obs += [router.revive("decode-a"), a.alive,
                len(router.replicas("decode"))]
        router.set_affinity("s2", "decode-b")
        router.deregister("decode-b")
        obs += [router.affinity_of("s2"),
                [r.replica_id for r in router.replicas("decode")]]
        st = router.stats()
        return obs + [st["placements"], st["affinity_sessions"],
                      st["draining"], st["silent"]]
    obs = both(case)
    assert obs[:5] == [["decode-b"], "decode-b", "decode-a", "decode-a",
                       True]


# ---------------------------------------------------------------------------
# Live scale + re-tier
# ---------------------------------------------------------------------------

def test_live_scale_up_and_retire(planes):
    def case(side):
        mono, cl, fleet = planes[side.name]
        n0 = len(cl.replicas)
        with jax_shared_backends():
            rep = cl.add_replica("decode")
        assert len(cl.replicas) == n0 + 1
        want = mono.query([req(side, MSGS, max_tokens=10)])[0]
        got = cl.query([req(side, MSGS, max_tokens=10)])[0]
        assert got.ok and got.text == want.text
        summary = fleet.drain(rep.replica_id, retire=True,
                              reason="retire-test")
        assert not summary["died"] and len(cl.replicas) == n0
        return [rep.replica_id, rep.role, res(want), res(got),
                _summary(summary),
                sorted(cl.router.stats()["replicas"])]
    both(case)


def test_live_retier_round_trip(planes):
    def case(side):
        mono, cl, fleet = planes[side.name]
        want = mono.query([req(side, MSGS, max_tokens=10)])[0]
        victim = sorted(r.replica_id for r in cl.replicas
                        if r.role == "decode")[0]
        s1 = fleet.drain(victim, new_role="prefill", reason="retier-test")
        roles1 = {r.replica_id: r.role for r in cl.replicas}
        assert roles1[victim] == "prefill"
        got = cl.query([req(side, MSGS, max_tokens=10)])[0]
        assert got.ok and got.text == want.text
        s2 = fleet.drain(victim, new_role="decode", reason="retier-back")
        got2 = cl.query([req(side, MSGS, max_tokens=10)])[0]
        assert got2.ok and got2.text == want.text
        return [victim, roles1, _summary(s1), _summary(s2), res(want),
                res(got), res(got2),
                {r.replica_id: r.role for r in cl.replicas}]
    both(case)


def test_policy_tick_executes_on_live_plane(planes):
    def case(side):
        _, cl, _ = planes[side.name]
        F = side.fl
        n0 = len(cl.replicas)

        def burn():
            return F.FleetSignals(replicas=tuple(
                F.ReplicaSignal(r.replica_id, r.role,
                                30.0 if r.role == "decode" else 0.0)
                for r in cl.replicas), slo_burn=2.0)

        fc = F.FleetController(cl, F.FleetConfig(
            min_replicas=1, max_replicas=n0 + 1, hysteresis_ticks=2,
            cooldown_ticks=0, seed=1))
        with jax_shared_backends():
            first = fc.tick(burn())
            act = fc.tick(burn())
        assert first is None and act.action == "scale_up"
        assert any(r.replica_id == act.target for r in cl.replicas)
        summary = fc.drain(act.target, retire=True, reason="cleanup")
        assert len(cl.replicas) == n0
        return [act.as_tuple(), _summary(summary), fc.ledger_tuples()]
    both(case)


# ---------------------------------------------------------------------------
# Chaos point: replica killed during its own drain
# ---------------------------------------------------------------------------

def test_drain_killed_mid_drain_degrades_structurally(planes):
    def case(side):
        mono, _, _ = planes[side.name]
        FA = side.faults
        cl = build_cluster(side, replicas=3, disaggregate=True,
                           continuous=True, continuous_chunk=8)
        fc = side.fl.FleetController(cl)
        try:
            a1 = mono.query([req(side, MSGS, sid="fleet-kill")])[0]
            b1 = cl.query([req(side, MSGS, sid="fleet-kill")])[0]
            assert b1.text == a1.text
            src = cl.router.affinity_of("fleet-kill")
            plan = FA.FaultPlan(3, [FA.FaultRule("fleet.migrate", "crash",
                                                 max_fires=1)])
            with FA.CHAOS.arming(plan):
                summary = fc.drain(src.replica_id, retire=True,
                                   reason="killed")
            assert summary["died"] and summary["failed"] >= 1
            assert src.replica_id not in cl.router.stats()["replicas"]
            assert cl.router.affinity_of("fleet-kill") is None
            assert cl.handoff.stats()["inflight"] == 0
            mono.drop_session("fleet-kill")
            msgs2 = MSGS + [{"role": "assistant", "content": a1.text},
                            {"role": "user", "content": "continue."}]
            a2 = mono.query([req(side, msgs2, sid="fleet-kill")])[0]
            b2 = cl.query([req(side, msgs2, sid="fleet-kill")])[0]
            assert a2.ok and b2.ok, (a2.error, b2.error)
            assert b2.text == a2.text
            mono.drop_session("fleet-kill")
            return [res(a1), res(b1), src.replica_id, _summary(summary),
                    plan.schedule(), res(a2), res(b2)]
        finally:
            cl.close()
    both(case)


# ---------------------------------------------------------------------------
# Registries, payloads, wiring
# ---------------------------------------------------------------------------

def test_fleet_registry_coherence():
    from quoracle_tpu_torch.chaos.faults import INJECTION_POINTS
    from quoracle_tpu_torch.infra.bus import TOPIC_FLEET
    from quoracle_tpu_torch.infra.flightrec import FLIGHT_EVENTS
    from quoracle_tpu_torch.infra.telemetry import METRICS
    assert TOPIC_FLEET == "fleet:events"
    for kind in ("fleet_action", "fleet_drain", "fleet_migrate_failed",
                 "fabric_peer_rejoin"):
        assert kind in FLIGHT_EVENTS
    assert "fleet.migrate" in INJECTION_POINTS
    text = METRICS.render_prometheus()
    for name in ("quoracle_fleet_actions_total",
                 "quoracle_fleet_ticks_total",
                 "quoracle_fleet_sessions_migrated_total",
                 "quoracle_fleet_drain_ms", "quoracle_fleet_draining"):
        assert name in text


def test_fleet_stats_payload(planes):
    def case(side):
        _, cl, fleet = planes[side.name]
        st = fleet.stats()
        assert st["enabled"] and not st["dry_run"]
        router = st.pop("router")
        st["ledger"] = [tuple(a.values()) for a in st["ledger"]]
        return [st, sorted(router["replicas"]), router["draining"],
                router["affinity_sessions"]]
    obs = both(case)
    assert obs[0]["config"]["max_replicas"] == 4 and obs[0]["drains"] >= 1


def test_fleet_events_ring_and_panel(planes):
    def case(side):
        if side is JAX:
            from quoracle_tpu.infra.bus import EventBus
            from quoracle_tpu.infra.event_history import EventHistory
            from quoracle_tpu.web.views import fleet_panel
        else:
            from quoracle_tpu_torch.infra.bus import EventBus
            from quoracle_tpu_torch.infra.event_history import EventHistory
            from quoracle_tpu_torch.web.views import fleet_panel
        _, cl, fleet = planes[side.name]
        bus = EventBus()
        history = EventHistory(bus)
        cl.attach_bus(bus)
        try:
            out = cl.query([req(side, MSGS, sid="fleet-ring",
                                max_tokens=8)])[0]
            assert out.ok
            src = cl.router.affinity_of("fleet-ring")
            fleet.drain(src.replica_id, reason="ring-test")
            events = [{k: v for k, v in e.items() if k not in ("ts", "ms")}
                      for e in history.replay_fleet()]
        finally:
            cl.drop_session("fleet-ring")
            history.close()
        html = fleet_panel(fleet.stats())
        assert "elastic fleet" in html and "fleet-state" in html
        return [res(out), events]
    both(case)


def test_fleet_controller_matches_the_jax_fleet_envelope():
    """tests/test_fleet.py's pool_sizing case: the JAX plan's fleet
    envelope (parallel/mesh.py, not ported) names the tier the port's
    controller scales and its bounds."""
    from quoracle_tpu.parallel.mesh import pool_sizing
    f = pool_sizing(["llama-3-8b"], n_devices=8, replicas=4,
                    disaggregate=True, host_kv_mb=256, fleet_min=1,
                    fleet_max=4)["fleet"]
    F = PORT.fl
    fc = F.FleetController(None, F.FleetConfig(
        min_replicas=f["min_replicas"], max_replicas=f["max_replicas"]))
    sig = F.FleetSignals(replicas=(
        F.ReplicaSignal("prefill-0", "prefill"),
        F.ReplicaSignal("decode-1", "decode")))
    assert fc._serving_roles(sig) == (f["serving_role"],)
    assert fc.stats()["config"]["max_replicas"] == f["max_replicas"] == 4


def test_runtime_refuses_fleet_without_cluster():
    from quoracle_tpu_torch.runtime import Runtime, RuntimeConfig
    with pytest.raises(ValueError, match="--fleet-max"):
        Runtime(RuntimeConfig(backend="mock", fleet_max=4))
    with pytest.raises(ValueError, match="--fleet-max"):
        Runtime(RuntimeConfig(backend="torch", device="cpu",
                              model_pool=[MEMBER], fleet_max=4))


def test_fleet_config_validation():
    def case(side):
        F = side.fl
        errs = []
        for kw in (dict(min_replicas=0), dict(min_replicas=3,
                                               max_replicas=2)):
            with pytest.raises(ValueError) as ei:
                F.FleetConfig(**kw).validate()
            errs.append(str(ei.value))
        return [errs, F.FleetAction(1, "drain", "r", "decode",
                                    "x").as_dict()]
    both(case)
