"""The port's fleet simulator (sim/) against the JAX package's, on the CPU.

The cases of tests/test_sim.py, and the three sim-calibration cases of
tests/test_costobs.py, each run on both packages: a trace's JSON
is byte for byte the JAX package's for the same spec and seed, replays
give equal ledger digests, the four canonical scenarios give equal gate
verdicts and evidence (the engine-sampled ones over one-replica planes of
the same fp32 tiny weights, tests/_cluster_parity.py, so the sampled
temperature-0 texts are equal too), and the surfaces (``/api/sim`` and its
panel, the runtime's boot replay, the CLI flags, the registries) match.
"""

import dataclasses
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _cluster_parity import JAX, PORT, SIDES, both, build_cluster
from quoracle_tpu.infra import costobs as jcost
from quoracle_tpu.infra import flightrec as jflight
from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu.sim import calibrate as jcal
from quoracle_tpu.sim import gate as jgate
from quoracle_tpu.sim import replay as jreplay
from quoracle_tpu.sim import workload as jwork
from quoracle_tpu_torch.infra import costobs as tcost
from quoracle_tpu_torch.infra import flightrec as tflight
from quoracle_tpu_torch.infra import telemetry as ttel
from quoracle_tpu_torch.sim import calibrate as tcal
from quoracle_tpu_torch.sim import gate as tgate
from quoracle_tpu_torch.sim import replay as treplay
from quoracle_tpu_torch.sim import workload as twork

torch.set_num_threads(1)

SIMS = {"jax": SimpleNamespace(gate=jgate, replay=jreplay, work=jwork,
                               flight=jflight, tel=jtel, cal=jcal,
                               cost=jcost),
        "port": SimpleNamespace(gate=tgate, replay=treplay, work=twork,
                                flight=tflight, tel=ttel, cal=tcal,
                                cost=tcost)}


def S(side):
    return SIMS[side.name]


@pytest.fixture(scope="module")
def plane():
    """Per package, one one-replica cluster over the shared weights for
    the engine-sampled scenarios."""
    out = {side.name: build_cluster(side, replicas=1, disaggregate=False)
           for side in SIDES}
    yield out
    for p in out.values():
        p.close()


# ---------------------------------------------------------------------------
# Workload generation: pure draws, canonical serialization
# ---------------------------------------------------------------------------

def test_draws_are_pure_seeded_and_stream_isolated():
    def case(side):
        W = S(side).work
        vals = [W.draw(1, "s", n) for n in range(256)]
        assert all(0.0 <= v < 1.0 for v in vals)
        assert len(set(vals)) > 250
        assert W.draw(1, "s", 0) != W.draw(2, "s", 0)
        assert W.draw(1, "s", 0) != W.draw(1, "t", 0)
        ints = [W.draw_int(1, "i", n, 3, 9) for n in range(16)]
        assert all(3 <= i <= 9 for i in ints)
        src = open(W.__file__, encoding="utf-8").read()
        assert "import random" not in src and "import time" not in src
        return [vals, ints, W.draw_exp(4, "e", 2, 3.0)]
    both(case)


@pytest.mark.parametrize("name", ["diurnal_mix", "storm", "agent_tree",
                                  "longtail_ladder"])
def test_trace_json_byte_identical_across_packages(name):
    """The acceptance bar: the same spec and seed give the same trace
    JSON, byte for byte, in both packages (the long tail at a tenth of
    its population, which keeps every stream family)."""
    scale = 0.1 if name == "longtail_ladder" else 1.0
    js = [S(side).work.generate(S(side).work.canonical_spec(
        name, seed=3, scale=scale)).to_json() for side in SIDES]
    assert js[1] == js[0]
    back = twork.Trace.from_json(js[0])
    assert back.to_json() == js[0]


def test_trace_same_seed_byte_identical_different_seed_differs():
    def case(side):
        W = S(side).work
        a = W.generate(W.canonical_spec("storm", seed=1))
        b = W.generate(W.canonical_spec("storm", seed=1))
        assert a.to_json() == b.to_json() and a.digest() == b.digest()
        c = W.generate(W.canonical_spec("storm", seed=2))
        assert set(a.stats()["by_stream"]) == set(c.stats()["by_stream"])
        assert c.digest() != a.digest()
        return [a.digest(), c.digest(), a.stats()]
    both(case)


def test_trace_json_round_trip_and_window_mix():
    def case(side):
        W = S(side).work
        tr = W.bench_trace("interactive", 16, seed=5)
        back = W.Trace.from_json(tr.to_json())
        assert back.digest() == tr.digest() and len(back) == 16
        with pytest.raises(ValueError, match="version"):
            W.Trace.from_json(json.dumps({"version": 99, "spec": {},
                                          "events": []}))
        mix = tr.window_mix(0, 8_000)
        assert mix["interactive"] == 1.0 and mix["batch"] == 0.0
        st = tr.stats()
        assert st["events"] == 16 and st["sessions"] == 16
        return [tr.to_json(), mix, st]
    both(case)


def test_canonical_catalog_and_scenarios_agree():
    def case(side):
        G, W = S(side).gate, S(side).work
        assert set(W.CANONICAL) == set(G.SIM_SCENARIOS)
        for name in W.CANONICAL:
            sc = G.SIM_SCENARIOS[name]
            assert sc.name == name and sc.slo
        return {n: (dataclasses.asdict(sc.capacity),
                    sc.goodput_floor_tok_s, sc.slo, sc.engine_sampled,
                    sc.scale)
                for n, sc in G.SIM_SCENARIOS.items()}
    obs = both(case)
    assert set(obs) == set(jwork.CANONICAL)


# ---------------------------------------------------------------------------
# Replay determinism
# ---------------------------------------------------------------------------

def test_replay_compressed_vs_paced_bit_identical():
    def case(side):
        W, R = S(side).work, S(side).replay
        tr = W.bench_trace("interactive", 40, seed=3)
        led_c = R.ReplayDriver(tr).run()
        led_p = R.ReplayDriver(tr, paced=True, pace_scale=1_000_000).run()
        assert led_c.to_json() == led_p.to_json()
        assert led_c.digest() == led_p.digest() and len(led_c) == 40
        s = R.SIM.status()
        assert s["enabled"] and s["last_replay"]["mode"] == "paced"
        return [led_c.to_json(), led_c.digest()]
    both(case)


def test_tier_ladder_cascade_and_conservation():
    def case(side):
        R = S(side).replay
        lad = R.TierLadder(R.CapacityModel(
            resident_sessions=2, host_sessions=2, disk_sessions=2,
            prefixd_sessions=2))
        assert [lad.touch(f"s{i}") for i in range(12)] == ["new"] * 12
        c = lad.census()
        assert c["seen"] == 12 and c["dropped"] == 4
        assert sum(c[t] for t in ("resident", "host", "disk", "prefixd",
                                  "dropped")) == 12
        deep = next(iter(lad.tiers["host"]))
        assert lad.touch(deep) == "host" and lad.restores["host"] == 1
        ghost = next(iter(lad.dropped))
        assert lad.touch(ghost) == "dropped"
        assert lad.cold_reprefills == 1 and lad.census()["seen"] == 12
        return [c, deep, ghost, lad.census(), lad.demotions]
    both(case)


def test_conservation_invariant_helper():
    def case(side):
        ok = side.inv.conservation("x", 5, {"a": 2, "b": 3})
        bad = side.inv.conservation("x", 5, {"a": 2, "b": 2})
        assert ok.ok and "total=5" in ok.detail
        assert not bad.ok and "sum=4" in bad.detail
        return [ok.as_dict(), bad.as_dict()]
    both(case)


# ---------------------------------------------------------------------------
# The canonical scenarios
# ---------------------------------------------------------------------------

def _gate(side, name, seed, **kw):
    report = S(side).gate.run_sim_scenario(name, seed=seed, **kw)
    failed = [f"{r.name}: {r.detail}" for r in report.invariants
              if not r.ok]
    assert report.passed, f"{side.name} {name}: " + "; ".join(failed)
    return report


def _verdicts(report) -> list:
    return [(r.name, r.ok, r.detail) for r in report.invariants]


def test_scenario_storm_sheds_batch_first():
    def case(side):
        report = _gate(side, "storm", 0)
        out = report.evidence["outcomes"]
        assert out["shed"] > 0 and out["ok"] > 0
        return [_verdicts(report), report.evidence]
    both(case)


def test_scenario_diurnal_mix_engine_sampled(plane):
    def case(side):
        samples = []
        real = S(side).replay.ReplayDriver._maybe_sample

        def keep(self, idx, e):
            real(self, idx, e)
            samples[:] = list(self.samples)
        S(side).replay.ReplayDriver._maybe_sample = keep
        try:
            report = _gate(side, "diurnal_mix", 0, plane=plane[side.name])
        finally:
            S(side).replay.ReplayDriver._maybe_sample = real
        assert report.evidence["samples"] > 0
        names = {r.name for r in report.invariants}
        assert {"sim_ledger_deterministic", "sim_no_silent_loss",
                "sim_goodput_floor", "sim_tier_conservation",
                "sim_temp0_spot_equal", "sim_slo_interactive"} <= names
        return [_verdicts(report), report.evidence, samples]
    obs = both(case)
    assert all(ok for _, ok, _ in obs[2])   # the sampled rows served


def test_scenario_agent_tree_engine_sampled(plane):
    def case(side):
        W = S(side).work
        tr = W.generate(W.canonical_spec("agent_tree", seed=0))
        depths = {e.depth for e in tr.events}
        assert max(depths) >= 2
        k_by_depth = {}
        for e in tr.events:
            k_by_depth.setdefault(e.depth, e.consensus_k)
        assert k_by_depth[0] >= k_by_depth[max(depths)]
        report = _gate(side, "agent_tree", 0, plane=plane[side.name])
        assert report.evidence["samples"] > 0
        return [_verdicts(report), report.evidence, k_by_depth]
    both(case)


def test_scenario_longtail_ladder_100k_sessions():
    """A 100k+ virtual-session long-tail trace replays at compressed time
    on the CPU, byte-identical across the two replays and across the
    packages (ledger digest), with every rung of the ladder populated."""
    def case(side):
        report = _gate(side, "longtail_ladder", 1)
        ev = report.evidence
        assert ev["trace"]["sessions"] >= 100_000
        assert ev["census"]["seen"] >= 100_000
        for tier in ("resident", "host", "disk", "prefixd", "dropped"):
            assert ev["census"][tier] > 0, tier
        return [_verdicts(report), ev]
    both(case)


def test_run_sim_scenario_builds_its_own_plane_on_the_device():
    """Without ``plane`` an engine-sampled scenario builds a one-replica
    cluster on ``device`` (through ``engine_factory``) and closes it: the
    verdicts equal the JAX package's, whose scenario builds its own."""
    from _cluster_parity import jax_shared_backends, port_engine
    with jax_shared_backends():
        jrep = _gate(JAX, "agent_tree", 2)
    trep = _gate(PORT, "agent_tree", 2, device="cpu",
                 engine_factory=port_engine)
    assert _verdicts(trep) == _verdicts(jrep)
    assert trep.evidence == jrep.evidence


# ---------------------------------------------------------------------------
# Calibration over the chip-ms ledger (tests/test_costobs.py's sim cases)
# ---------------------------------------------------------------------------

def test_calibration_recovers_profile_and_ttft_gate_passes():
    def case(side):
        cal, R, W = S(side).cal, S(side).replay, S(side).work
        trace = W.generate(W.canonical_spec("diurnal_mix"))
        truth = R.CapacityModel(prefill_tok_s=30_000.0, decode_tok_s=250.0)
        chip, measured = cal.record_profile(trace, truth)
        rep = cal.fit_capacity(chip)
        assert "prefill_tok_s" in rep.fitted_params
        assert rep.fitted.prefill_tok_s == pytest.approx(30_000.0, rel=0.02)
        assert rep.fitted.decode_tok_s == pytest.approx(250.0, rel=0.02)
        gate = cal.ttft_gate(trace, measured, rep.fitted, tol=0.35)
        assert gate["passed"], gate["checks"]
        assert cal.fit_capacity(chip).as_dict() == rep.as_dict()
        assert "sim:profile" not in S(side).cost.ledgers()
        return [rep.as_dict(), gate, measured.digest()]
    both(case)


def test_calibration_fits_restore_rungs():
    def case(side):
        co = S(side).cost
        led = co.ChipLedger("t")
        for _ in range(8):
            led.charge("restore", 0.012, [1], [co.DEFAULT_KEY], 1)
            led.note_restore_source("host", 12_000_000)
        rep = S(side).cal.fit_capacity(led)
        assert "restore_ms:host" in rep.fitted_params
        assert dict(rep.fitted.restore_ms)["host"] == pytest.approx(12.0)
        assert dict(rep.fitted.restore_ms)["disk"] == 40
        return rep.as_dict()
    both(case)


def test_calibrate_from_live_ledgers_picks_busiest():
    def case(side):
        co, cal = S(side).cost, S(side).cal
        co.reset()
        try:
            assert cal.calibrate() is None
            key = ("acme", "interactive", "-", "-")
            co.ledger_for("small").charge("prefill", 0.001, [40], [key], 40)
            co.ledger_for("big").charge("prefill", 0.004, [400], [key], 400)
            return [cal.calibrate().model,
                    cal.calibrate(model="small").model]
        finally:
            co.reset()
    assert both(case) == ["big", "small"]


# ---------------------------------------------------------------------------
# The disk store's scrapes
# ---------------------------------------------------------------------------

def test_disk_store_scrape_never_walks_the_directory(tmp_path, monkeypatch):
    from quoracle_tpu_torch.serving.kvtier import DiskPrefixStore
    s = DiskPrefixStore(str(tmp_path), "sig", model="m")
    kk = torch.ones((2, 64, 2, 8), dtype=torch.float32)
    keys = []
    for i in range(8):
        toks = list(range(i, i + 64))
        key = s.block_key(toks)
        assert s.save(key, toks, kk, kk * 2)
        keys.append((key, toks))
    real = sum(1 for e in os.scandir(s.dir) if e.name.endswith(".npz"))
    assert s.stats()["entries"] == real == 8

    def boom(*a, **k):
        raise AssertionError("scrape walked the directory")

    monkeypatch.setattr(os, "scandir", boom)
    monkeypatch.setattr(os, "listdir", boom)
    for _ in range(200):
        st = s.stats()
    assert st["entries"] == 8 and st["bytes"] > 0
    key, toks = keys[0]
    with open(s._path(key), "wb") as f:
        f.write(b"not an npz")
    assert s.load(key, toks) is None
    assert s.stats()["entries"] == 7


# ---------------------------------------------------------------------------
# Bench mixes, the forecast seam, the capacity hint
# ---------------------------------------------------------------------------

def test_bench_helpers_are_deterministic_and_shaped():
    def case(side):
        W = S(side).work
        tasks = ["alpha beta", "gamma delta epsilon", "zeta"]
        m1, m2 = W.bench_overload_mix(tasks, 6), W.bench_overload_mix(tasks,
                                                                      6)
        assert m1["interactive_texts"] == m2["interactive_texts"]
        assert m1["trace"].digest() == m2["trace"].digest()
        assert m1["interactive_texts"][0] == "[user turn 0] alpha beta"
        f = W.bench_fleet_mix(tasks, 4, 3)
        assert len(f["inter_msgs"]) == 4 and len(f["sess_msgs"]) == 3
        ti, ts = f["traces"]
        assert ti.digest() != ts.digest()
        return [m1["interactive_texts"], m1["batch_text"],
                m1["trace"].to_json(), f["inter_msgs"], f["sess_msgs"]]
    both(case)


def test_fleet_forecast_is_recorded_but_decisions_stay_blind():
    def case(side):
        FC, FS = side.fl.FleetController, side.fl.FleetSignals
        fc = FC(None)
        prior = (("agent", 0.5), ("batch", 0.1), ("interactive", 2.5))
        assert fc.tick(FS(replicas=(), forecast=prior)) is None
        st = fc.stats()["forecast"]
        assert st["shadow"] is True and st["ticks"] == 1
        assert st["last"] == dict(prior)
        blind = FC(None)
        for _ in range(4):
            a = fc.tick(FS(replicas=(), forecast=prior))
            b = blind.tick(FS(replicas=()))
            assert (a is None) == (b is None)
        return [fc.stats()["forecast"], blind.stats()["forecast"]]
    both(case)


def test_router_capacity_hint_sums_alive_decode_slots():
    def case(side):
        r = side.ro.ClusterRouter()
        mk = SimpleNamespace
        r.register(mk(replica_id="d0", role="decode", alive=True,
                      backend=mk(scheduler_stats=lambda: {
                          "m": {"max_slots": 16}})))
        r.register(mk(replica_id="d1", role="decode", alive=True,
                      backend=object()))
        r.register(mk(replica_id="p0", role="prefill", alive=True,
                      backend=object()))
        r.register(mk(replica_id="dx", role="decode", alive=False,
                      backend=object()))
        return r.capacity_hint()
    assert both(case) == {"decode_replicas": 2, "prefill_replicas": 1,
                          "decode_slots": 24}


# ---------------------------------------------------------------------------
# Surfaces: registries, /api/sim and its panel, Runtime and CLI
# ---------------------------------------------------------------------------

def test_registries_instruments_topic_flight_events_lock_rank():
    def case(side):
        tel = S(side).tel
        if side is JAX:
            from quoracle_tpu.analysis.lockdep import HIERARCHY
            from quoracle_tpu.infra.bus import TOPIC_SIM
        else:
            from quoracle_tpu_torch.infra.bus import TOPIC_SIM
            from quoracle_tpu_torch.infra.locks import HIERARCHY
        events = [ev in S(side).flight.FLIGHT_EVENTS
                  for ev in ("sim_replay_start", "sim_replay_end",
                             "sim_forecast", "sim_gate")]
        names = [tel.SIM_EVENTS_TOTAL.name, tel.SIM_REPLAYS_TOTAL.name,
                 tel.SIM_TTFT_MS.name, tel.SIM_GOODPUT.name,
                 tel.SIM_SESSIONS.name, tel.SIM_GATE_FAILURES.name]
        return [TOPIC_SIM, events, names, ("sim.replay", 3, False)
                in HIERARCHY]
    assert both(case)[3] is True


def test_api_sim_payload_and_panel():
    def case(side):
        if side is JAX:
            from quoracle_tpu.web import views
            from quoracle_tpu.web.server import DashboardServer
        else:
            from quoracle_tpu_torch.web import views
            from quoracle_tpu_torch.web.server import DashboardServer
        W, R = S(side).work, S(side).replay
        R.ReplayDriver(W.bench_trace("interactive", 6, seed=9)).run()
        d = DashboardServer(SimpleNamespace(backend=object()))
        payload = d.sim_payload()
        assert payload["enabled"]
        assert payload["last_replay"]["events"] == 6
        assert {"events", "replays", "gate_failures"} \
            <= set(payload["counters"])
        html = views.sim_panel(payload)
        assert "fleet simulator" in html and "sim-replay" in html
        R.SIM.note_report({"name": "storm", "passed": True,
                           "invariants": [{"name": "sim_goodput_floor",
                                           "ok": True, "detail": "d"}]})
        html2 = views.sim_panel(d.sim_payload())
        assert "sim-invariants" in html2 and "sim_goodput_floor" in html2
        assert views.sim_panel({}) == ""
        page = views.telemetry_page({}, sim=payload)
        assert "fleet simulator" in page
        last = {k: v for k, v in payload["last_replay"].items()
                if k not in ("events_per_wall_s", "compression_x",
                             "wall_s")}
        # the panel's compression factor is wall-clock
        return [last, sorted(payload["counters"]),
                re.sub(r"compression ×[0-9.]+", "", html2)]
    both(case)


def test_runtime_boots_shadow_replay_from_trace_file(tmp_path):
    from quoracle_tpu_torch.runtime import Runtime, RuntimeConfig
    p = tmp_path / "trace.json"
    p.write_text(twork.bench_trace("interactive", 12, seed=4).to_json())
    rt = Runtime(RuntimeConfig(sim_trace=str(p)))
    try:
        rt._sim_thread.join(timeout=60)
        assert not rt._sim_thread.is_alive()
        s = treplay.SIM.status()
        assert s["last_replay"]["events"] == 12
        assert s["trace"]["events"] == 12
        want = jreplay.ReplayDriver(jwork.Trace.from_json(
            p.read_text())).run().digest()
        assert s["last_replay"]["ledger"] == want
    finally:
        rt.close()
    assert rt._sim_thread is None


def test_runtime_sim_seed_replays_the_canonical_trace():
    """``sim_seed`` without a trace: the canonical diurnal-mix trace of
    that seed, the JAX package's digest."""
    from quoracle_tpu_torch.runtime import Runtime, RuntimeConfig
    rt = Runtime(RuntimeConfig(sim_seed=3))
    try:
        rt._sim_thread.join(timeout=60)
        assert not rt._sim_thread.is_alive()
        s = treplay.SIM.status()
    finally:
        rt.close()
    want = jwork.generate(jwork.canonical_spec("diurnal_mix", seed=3))
    assert s["trace"]["digest"] == want.digest()
    assert s["last_replay"]["ledger"] \
        == jreplay.ReplayDriver(want).run().digest()


def test_cli_sim_flags_parse():
    def case(side):
        if side is JAX:
            from quoracle_tpu.cli import build_parser
        else:
            from quoracle_tpu_torch.cli import build_parser
        ns = build_parser().parse_args(
            ["serve", "--sim-trace", "/tmp/game_day.json"])
        ns2 = build_parser().parse_args(["run", "x", "--sim-seed", "7"])
        return [ns.sim_trace, ns.sim_seed, ns2.sim_seed, ns2.sim_trace]
    assert both(case) == ["/tmp/game_day.json", None, 7, None]
