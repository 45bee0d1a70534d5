"""The port's chaos plane (chaos/) against the JAX package's, on the CPU.

The cases of tests/test_chaos.py, ``fabric_partition`` (peer links
flapping over the loopback fabric) and the fabric's two
``INJECTION_POINTS`` included. Every scenario runs SEEDED through both
packages over the same
fp32 tiny weights (tests/_cluster_parity.py), each asserting its full
invariant set; the invariant verdicts (name, pass, detail), the fired
fault schedules and the evidence must be equal across the packages. The
port's lock-order sanitizer (infra/locks.py) is on while a scenario runs,
as the JAX one is for the whole suite. Also: ``FaultPlan`` mechanics on
both planes, the flight kinds and instruments, ``/api/chaos`` and its
panel against the JAX payload, the runtime's boot arming and the
``--chaos-plan`` flag.
"""

import json
import re
from types import SimpleNamespace

import pytest
import torch

from _cluster_parity import (
    JAX, PORT, both, jax_shared_backends, own_incidents, port_engine,
    port_lockdep,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# FaultPlan mechanics
# ---------------------------------------------------------------------------

def test_fault_decisions_are_pure_and_seeded():
    def case(side):
        FA = side.faults
        rule = FA.FaultRule("pool.member", "crash", prob=0.5)

        def schedule(seed):
            plan = FA.FaultPlan(seed, [rule])
            return [plan._decide(0, rule, "pool.member", "m1", n)
                    for n in range(64)]

        a, b = schedule(7), schedule(7)
        assert a == b and any(a) and not all(a)
        assert schedule(7) != schedule(8)
        return [a, schedule(8)]
    both(case)


def test_fire_windowing_match_and_ledger():
    def case(side):
        FA = side.faults
        plan = FA.FaultPlan(0, [
            FA.FaultRule("pool.member", "garbage", start=2, every=2,
                         max_fires=2, match={"model": "m1"}),
        ])
        FA.CHAOS.arm(plan)
        try:
            fired = []
            for _ in range(8):
                d = FA.CHAOS.fire("pool.member", model="m1")
                fired.append(d.kind if d else None)
                assert FA.CHAOS.fire("pool.member", model="m2") is None
            assert fired == [None, None, "garbage", None, "garbage",
                             None, None, None]
            return [fired, plan.schedule(), dict(plan.counts),
                    [{k: v for k, v in f.items()} for f in plan.fired]]
        finally:
            FA.CHAOS.disarm()
    obs = both(case)
    assert obs[1] == [("pool.member", "m1", 2, "garbage"),
                      ("pool.member", "m1", 4, "garbage")]


def test_crash_kind_raises_structured_injected_fault():
    def case(side):
        FA = side.faults
        plan = FA.FaultPlan(0, [FA.FaultRule("cluster.serve", "crash")])
        FA.CHAOS.arm(plan)
        try:
            with pytest.raises(FA.InjectedFault) as ei:
                FA.CHAOS.fire("cluster.serve", replica="decode-1")
            return [str(ei.value), ei.value.point, ei.value.key,
                    ei.value.n]
        finally:
            FA.CHAOS.disarm()
    assert both(case)[1:3] == ["cluster.serve", "decode-1"]


def test_disarmed_fire_is_a_noop_and_counts_nothing():
    def case(side):
        FA = side.faults
        assert not FA.CHAOS.armed()
        first = FA.CHAOS.fire("pool.member", model="m1")
        plan = FA.FaultPlan(3, [])
        FA.CHAOS.arm(plan)
        FA.CHAOS.disarm()
        return [first, FA.CHAOS.fire("pool.member", model="m1"),
                plan.counts]
    assert both(case) == [None, None, {}]


def test_plan_json_round_trip_and_unknown_point_rejected(tmp_path):
    spec = {"seed": 42, "faults": [
        {"point": "admission.signals", "kind": "drop", "prob": 0.25},
        {"point": "cluster.decode", "kind": "crash", "start": 5,
         "max_fires": 2},
    ]}
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(spec))

    def case(side):
        FA = side.faults
        plan = FA.FaultPlan.from_json(str(p))
        with pytest.raises(ValueError, match="unknown injection point") \
                as ei:
            FA.FaultPlan.from_dict({"faults": [{"point": "nope",
                                                "kind": "crash"}]})
        return [plan.as_dict(), str(ei.value)]
    both(case)


def test_flight_events_and_instruments_registered():
    from quoracle_tpu.chaos.scenarios import SCENARIOS as JSCEN
    from quoracle_tpu_torch.chaos.faults import INJECTION_POINTS
    from quoracle_tpu_torch.chaos.scenarios import SCENARIOS
    from quoracle_tpu_torch.infra.flightrec import FLIGHT_EVENTS
    from quoracle_tpu_torch.infra.telemetry import METRICS
    for kind in ("chaos_armed", "chaos_fault", "chaos_scenario_start",
                 "chaos_scenario_end", "signal_dump"):
        assert kind in FLIGHT_EVENTS
    text = METRICS.render_prometheus()
    for name in ("quoracle_chaos_armed", "quoracle_chaos_faults_total",
                 "quoracle_chaos_scenarios_total",
                 "quoracle_chaos_invariant_failures_total"):
        assert name in text
    assert set(SCENARIOS) == {"traffic_storm", "kill_mid_handoff",
                              "restart_warm_start", "drift_storm",
                              "hbm_pressure_churn", "fabric_partition",
                              "scale_storm"}
    # the JAX registry whole, in its order
    assert list(SCENARIOS) == list(JSCEN)
    assert "pool.member" in INJECTION_POINTS
    assert "fabric.send" in INJECTION_POINTS
    assert "fabric.prefixd" in INJECTION_POINTS
    assert "fleet.migrate" in INJECTION_POINTS


# ---------------------------------------------------------------------------
# The scenarios, through both packages
# ---------------------------------------------------------------------------

def _run(side, name: str, seed: int):
    if side is JAX:
        with jax_shared_backends(), own_incidents(side):
            report = side.scen.run_scenario(name, seed=seed)
    else:
        with port_lockdep(), own_incidents(side):
            report = side.scen.run_scenario(name, seed=seed, device="cpu",
                                            engine_factory=port_engine)
    detail = {r.name: (r.ok, r.detail) for r in report.invariants}
    assert report.passed, f"{side.name} {name} seed={seed}: {detail}"
    assert not side.faults.CHAOS.armed()
    assert report.schedule, f"{name}: storm fired no faults"
    return report


def _verdicts(report) -> list:
    """(name, pass, detail) a check; a drain summary's wall ms (in the
    fleet checks' details) is dropped."""
    return [(r.name, r.ok, re.sub(r"'ms': [0-9.]+", "'ms'", r.detail))
            for r in report.invariants]


def _scenario(name: str, seed: int, evidence=lambda ev: None) -> list:
    def case(side):
        report = _run(side, name, seed)
        return [report.passed, _verdicts(report), report.schedule,
                evidence(report.evidence)]
    return both(case)


def _tier_view(tier: dict) -> dict:
    out = {k: v for k, v in tier.items() if k not in ("prefixd", "disk")}
    disk = tier.get("disk") or {}
    out["disk"] = {k: v for k, v in disk.items() if k != "dir"}
    return out


def test_scenario_drift_storm():
    obs = _scenario("drift_storm", 7, lambda ev: [
        ev["drifting"], ev["garbage_drift"], ev["crash_failures"]])
    names = [v[0] for v in obs[1]]
    assert names.count("fault_schedule") == 2
    assert obs[3][1]["tripped"] is True


def test_scenario_hbm_pressure_churn():
    obs = _scenario("hbm_pressure_churn", 11, lambda ev: [
        _tier_view(ev["tier"]), ev["storms"], ev["storm_active"],
        ev["poisoned"], ev["scale_corrupt"], ev["crc_rejects"]])
    ev = obs[3]
    assert ev[0]["demoted_sessions"] >= 1
    assert ev[1] >= 1 or ev[2]
    if ev[4]:
        assert ev[5] >= 1


def test_scenario_restart_warm_start():
    obs = _scenario("restart_warm_start", 11, lambda ev: [
        ev["corrupt_fired"],
        {k: v for k, v in ev["disk"].items() if k != "dir"}])
    assert obs[3][0] >= 1 and obs[3][1]["corrupt_skipped"] >= 1


def test_scenario_kill_mid_handoff():
    obs = _scenario("kill_mid_handoff", 5, lambda ev: [
        ev["handoff"], ev["dead_replicas"]])
    assert obs[3][0]["replaced"] >= 1 and obs[3][1]


def test_scenario_fabric_partition():
    """Peer links flap (drops and corrupt frames) over the loopback
    fabric mid-handoff: no silent loss, survivors bit-equal, recovery by
    retry, envelope re-place or cold failover, all structured; the
    schedule and the evidence equal the JAX package's."""
    obs = _scenario("fabric_partition", 5, lambda ev: [
        ev["retried"], ev["replaced"], ev["cold_failovers"],
        ev["dead_peers"], ev["survivors"]])
    assert {t[3] for t in obs[2]} & {"drop", "corrupt"}
    retried, replaced, cold, _, survivors = obs[3]
    assert retried >= 1 or replaced >= 1 or cold >= 1
    assert survivors >= 1


def test_scenario_scale_storm():
    def view(ev):
        return [[{k: v for k, v in d.items() if k != "ms"}
                 for d in ev["drains"]], ev["ledger"],
                ev["dead_replicas"], ev["handoff"]]
    obs = _scenario("scale_storm", 5, view)
    kinds = {t[3] for t in obs[2]}
    assert "crash" in kinds
    drains, ledger, _, handoff = obs[3]
    assert any(d["died"] for d in drains)
    assert handoff["inflight"] == 0
    assert any(a["action"] == "scale_up" for a in ledger)


def test_scenario_traffic_storm():
    obs = _scenario("traffic_storm", 5)
    names = [v[0] for v in obs[1]]
    assert names.count("fault_schedule") == 2
    assert "drop" in {t[3] for t in obs[2]}


# ---------------------------------------------------------------------------
# Surfaces: /api/chaos, telemetry panel, Runtime/CLI arming
# ---------------------------------------------------------------------------

def _chaos_view(payload: dict) -> dict:
    """The payload without its process-wide parts: the counter series
    (keys only), the catalog's texts (keys only) and the last report's
    wall time."""
    out = {k: v for k, v in payload.items()
           if k not in ("counters", "points", "last_scenario")}
    out["points"] = sorted(payload["points"])
    out["counters"] = sorted(payload["counters"])
    last = payload.get("last_scenario")
    out["last_scenario"] = (
        {k: v for k, v in last.items() if k != "wall_s"}
        if last else None)
    return out


def test_api_chaos_payload_and_panel():
    """Served by the port's dashboard, equal to the JAX payload after
    the same scenario; the panel renders the plan and the verdicts."""
    def case(side):
        if side is JAX:
            from quoracle_tpu.web import views
            from quoracle_tpu.web.server import DashboardServer
        else:
            from quoracle_tpu_torch.web import views
            from quoracle_tpu_torch.web.server import DashboardServer
        _run(side, "kill_mid_handoff", 5)
        d = DashboardServer(SimpleNamespace(backend=object()))
        payload = d.chaos_payload()
        assert payload["armed"] is False
        assert {"faults", "scenarios", "invariant_failures"} \
            <= set(payload["counters"])
        assert "invariants" in payload["last_scenario"]
        html = views.chaos_panel(payload)
        assert "chaos plane" in html and "chaos-invariants" in html
        FA = side.faults
        plan = FA.FaultPlan(99, [FA.FaultRule("pool.member", "slow")])
        FA.CHAOS.arm(plan)
        try:
            armed = d.chaos_payload()
            html2 = views.chaos_panel(armed)
            assert "ARMED" in html2 and "99" in html2
        finally:
            FA.CHAOS.disarm()
        assert views.chaos_panel({"armed": False, "last_scenario": None,
                                  "fired": []}) == ""
        return [_chaos_view(payload), _chaos_view(armed), html, html2]
    both(case)


def test_runtime_arms_chaos_plan_at_boot(tmp_path):
    from quoracle_tpu_torch.chaos.faults import CHAOS
    from quoracle_tpu_torch.runtime import Runtime, RuntimeConfig
    p = tmp_path / "plan.json"
    p.write_text(json.dumps({"seed": 1, "faults": [
        {"point": "pool.member", "kind": "slow", "prob": 0.1}]}))
    rt = Runtime(RuntimeConfig(chaos_plan=str(p)))
    try:
        assert CHAOS.armed()
    finally:
        CHAOS.disarm()
        rt.close()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"faults": [{"point": "x",
                                           "kind": "crash"}]}))
    with pytest.raises(ValueError, match="unknown injection point"):
        Runtime(RuntimeConfig(chaos_plan=str(bad)))
    assert not CHAOS.armed()


def test_cli_chaos_plan_flag_parses():
    from quoracle_tpu_torch.cli import build_parser
    ns = build_parser().parse_args(
        ["serve", "--chaos-plan", "/etc/quoracle/gameday.json"])
    assert ns.chaos_plan == "/etc/quoracle/gameday.json"
    assert build_parser().parse_args(["run", "x"]).chaos_plan is None
