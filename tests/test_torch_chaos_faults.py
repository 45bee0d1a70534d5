"""The port's fault plane (chaos/faults.py) and its in-process seams
against the JAX package's, on the CPU.

* One ``FaultPlan`` gives the same fire ledger in both packages, point by
  point and key by key: the directives handed back, the raised
  ``InjectedFault``s, the per-(point, key) counters, the ledger and the
  ``chaos_fault`` flight records, over seeded call sequences on every
  point of the JAX catalog (which the port accepts whole).
* Each seam of the port fires where the JAX package's does, with the
  same effect on what is served: ``pool.member`` (both backends and both
  mocks), ``sched.tick``, ``compile.key``, ``kvtier.disk_load``,
  ``kvtier.scale_corrupt``, ``kvtier.restore``, ``admission.signals``,
  ``handoff.export``, ``router.signals`` and ``cluster.serve``
  (``cluster.decode`` and ``fleet.migrate`` run in
  tests/test_torch_chaos.py's scenarios and tests/test_torch_fleet.py).
  Each case returns its tokens, errors, counters and fault schedule; the
  two lists must be equal.
* Disarmed, or armed with rules that match nothing, the serving path
  gives the same bits as with no plane at all: the JAX package's tokens.

Every case runs over the same fp32 tiny weights (tests/_cluster_parity.py)
and waits on results, never on a wall clock.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _cluster_parity import (
    JAX, MEMBER, PORT, backend, both, build_cluster, req, res,
)
from quoracle_tpu.infra import flightrec as jflight
from quoracle_tpu_torch.infra import flightrec as tflight

torch.set_num_threads(1)

SYS = "system: " + "policy rules apply here. " * 8     # > 1 page of 128
MSGS = [{"role": "user", "content": "hello fault plane, please "
                                    "elaborate at length"}]


def _flight(side):
    return (jflight if side is JAX else tflight).FLIGHT


def _fault_events(side, plan) -> list:
    return [{k: v for k, v in e.items() if k not in ("ts", "plan")}
            for e in _flight(side).snapshot()
            if e.get("kind") == "chaos_fault"
            and e.get("plan") == plan.nonce]


def _armed(side, seed, rules):
    """A plan of ``rules`` (FaultRule kwargs) armed on ``side``'s plane."""
    FA = side.faults
    plan = FA.FaultPlan(seed, [FA.FaultRule(**r) for r in rules])
    return FA.CHAOS.arming(plan)


# ---------------------------------------------------------------------------
# The fire ledger
# ---------------------------------------------------------------------------

def test_port_accepts_the_jax_catalog():
    from quoracle_tpu.chaos.faults import INJECTION_POINTS as JPOINTS
    from quoracle_tpu_torch.chaos.faults import INJECTION_POINTS
    assert sorted(INJECTION_POINTS) == sorted(JPOINTS)
    spec = {"seed": 3, "faults": [{"point": p, "kind": "drop"}
                                  for p in sorted(JPOINTS)]}
    assert (PORT.faults.FaultPlan.from_dict(spec).as_dict()
            == JAX.faults.FaultPlan.from_dict(spec).as_dict())


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_same_plan_fires_the_same_ledger(seed):
    rng = np.random.default_rng(seed)
    points = sorted(PORT.faults.INJECTION_POINTS)
    kinds = ("crash", "drop", "corrupt", "fail", "poison", "garbage",
             "delay")
    rules = []
    for p in points:
        for _ in range(int(rng.integers(1, 3))):
            r = dict(point=p, kind=str(rng.choice(kinds)),
                     prob=float(rng.choice([1.0, 0.5, 0.25])),
                     start=int(rng.integers(0, 4)),
                     every=int(rng.integers(1, 4)),
                     max_fires=int(rng.integers(1, 6)), delay_ms=0.0)
            if rng.random() < 0.3:
                r["match"] = {"model": "m1"}
            rules.append(r)
    ctxs = [{"model": "m1"}, {"model": "m2"}, {"replica": "decode-1"},
            {"tenant": "t"}, {}, {"model": "m1", "replica": "decode-2"}]
    calls = [(points[int(rng.integers(len(points)))],
              ctxs[int(rng.integers(len(ctxs)))]) for _ in range(600)]

    def case(side):
        FA = side.faults
        outcomes = []
        with _armed(side, seed, rules) as plan:
            for point, ctx in calls:
                try:
                    d = FA.CHAOS.fire(point, **ctx)
                except FA.InjectedFault as e:
                    outcomes.append(("raise", e.point, e.key, e.n, str(e)))
                    continue
                outcomes.append(None if d is None else
                                (d.kind, d.key, d.n, d.point))
        return [outcomes, plan.schedule(), sorted(plan.counts.items()),
                plan.fired, _fault_events(side, plan)]
    obs = both(case)
    assert len(obs[1]) > 20 and any(o and o[0] == "raise" for o in obs[0])


# ---------------------------------------------------------------------------
# pool.member
# ---------------------------------------------------------------------------

def test_pool_member_seam_on_the_mock_backends():
    rules = [dict(point="pool.member", kind="crash", every=3,
                  match={"model": "mock:consensus-model-2"}),
             dict(point="pool.member", kind="garbage", start=1,
                  match={"model": "mock:consensus-model-3"})]

    def case(side):
        mb = side.rt.MockBackend()
        rows = [side.rt.QueryRequest(m, MSGS) for m in mb.DEFAULT_POOL]
        with _armed(side, 4, rules) as plan:
            out = [[(r.text, r.error) for r in mb.query(rows)]
                   for _ in range(4)]
        return [out, plan.schedule()]
    obs = both(case)
    assert any("chaos_injected" in (e or "") for rnd in obs[0]
               for _, e in rnd)


def test_pool_member_seam_on_the_serving_backends():
    """A crash fails the member's rows with the structured text; garbage
    marks the served text, as in the JAX backend."""
    rules = [dict(point="pool.member", kind="crash", start=1, max_fires=1),
             dict(point="pool.member", kind="garbage", start=2)]

    def case(side):
        b = backend(side)
        try:
            with _armed(side, 1, rules) as plan:
                out = [res(b.query([req(side, MSGS, max_tokens=8)])[0])
                       for _ in range(3)]
            return [out, plan.schedule()]
        finally:
            b.close()
    obs = both(case)
    assert obs[0][1][2].startswith("chaos_injected")
    assert obs[0][2][1].endswith("[chaos-garbage:2]")


# ---------------------------------------------------------------------------
# sched.tick, kvtier.restore
# ---------------------------------------------------------------------------

def test_sched_tick_demote_churn_and_restore_failures_keep_the_bits():
    """Forced demote churn between the loop's ticks and failed restores:
    sessions hibernate and resume by page-in or re-prefill, the served
    bits equal the fault-free run's, and both packages book the same
    churn."""
    rules = [dict(point="sched.tick", kind="demote", every=2),
             dict(point="kvtier.restore", kind="fail", every=2)]

    def run(side, armed):
        b = backend(side, continuous=True, continuous_chunk=8,
                    host_kv_mb=32)
        try:
            out = []
            for wave in range(2):
                for i in range(2):
                    msgs = [{"role": "user",
                             "content": SYS + f" session {i} wave {wave}"}]
                    out.append(res(b.query([req(side, msgs, sid=f"s{i}",
                                                max_tokens=10)])[0]))
            tier = b.engines[MEMBER].sessions.tier
            return out, {k: tier.stats()[k] for k in (
                "demoted_sessions", "restored_sessions",
                "restore_failures")}
        finally:
            b.close()

    def case(side):
        clean, _ = run(side, False)
        with _armed(side, 2, rules) as plan:
            storm, tier = run(side, True)
        assert [r[1] for r in storm] == [r[1] for r in clean]
        return [clean, storm, tier, plan.schedule()]
    obs = both(case)
    assert obs[2]["demoted_sessions"] >= 1
    assert {t[0] for t in obs[3]} == {"sched.tick", "kvtier.restore"}


# ---------------------------------------------------------------------------
# compile.key
# ---------------------------------------------------------------------------

def test_compile_key_poison_books_a_recompile_storm_only():
    def case(side):
        def run():
            eng = side.engine()
            p = eng.tokenizer.encode(SYS + " compile ledger", add_bos=True)
            toks = [eng.generate([p], temperature=0.0, max_new_tokens=6,
                                 session_ids=[f"c{i}"])[0].token_ids
                    for i in range(3)]
            c = eng.compiles
            return toks, (c.hits, c.misses, c.storm, c.storms_total)
        clean, ledger0 = run()
        with _armed(side, 0, [dict(point="compile.key", kind="poison",
                                   max_fires=6)]) as plan:
            storm, ledger1 = run()
        assert storm == clean
        return [clean, ledger0, ledger1, plan.schedule()]
    obs = both(case)
    assert obs[2][1] > obs[1][1]                  # more misses booked


# ---------------------------------------------------------------------------
# kvtier.disk_load, kvtier.scale_corrupt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point,quantize_kv", [
    ("kvtier.disk_load", False), ("kvtier.scale_corrupt", True)],
    ids=["disk_load", "scale_corrupt"])
def test_disk_corruption_seams_are_caught_by_the_crc(point, quantize_kv,
                                                     tmp_path):
    def case(side):
        d = str(tmp_path / side.name)
        p = None

        def engine():
            e = side.engine(quantize_kv=quantize_kv)
            t = e.attach_tier(host_mb=32, disk_dir=d)
            return e, t

        e1, t1 = engine()
        p = e1.tokenizer.encode(SYS + " persisted prefix", add_bos=True)
        r1 = e1.generate([p], temperature=0.0, max_new_tokens=8,
                         session_ids=["a"])[0]
        t1.flush_spills()
        n_files = sum(len(fs) for _, _, fs in os.walk(d))
        e2, t2 = engine()
        with _armed(side, 0, [dict(point=point, kind="corrupt")]) as plan:
            r2 = e2.generate([p], temperature=0.0, max_new_tokens=8,
                             session_ids=["b"])[0]
        assert r2.token_ids == r1.token_ids
        t2.flush_spills()          # the re-prefilled block's write-back
        disk = {k: v for k, v in t2.stats()["disk"].items() if k != "dir"}
        return [r1.token_ids, r2.token_ids, r2.n_cached_tokens, n_files,
                disk, plan.schedule()]
    obs = both(case)
    assert obs[4]["corrupt_skipped"] >= 1 and obs[5]


# ---------------------------------------------------------------------------
# admission.signals, router.signals
# ---------------------------------------------------------------------------

def test_admission_signals_drop_keeps_the_stale_window():
    def case(side):
        ctrl = side.adm.AdmissionController(model="m1")
        ctrl.register_depth_source("q", lambda: 3)
        out = []
        with _armed(side, 0, [dict(point="admission.signals", kind="drop",
                                   every=2),
                              dict(point="admission.signals",
                                   kind="delay", delay_ms=0.0)]) as plan:
            for step in range(6):
                now = 100.0 + 2.0 * step
                ctrl.refresh_signals(now=now)
                out.append(ctrl._t_refresh)
        return [out, plan.schedule()]
    obs = both(case)
    # a dropped refresh leaves the window where it was
    assert any(a == b for a, b in zip(obs[0], obs[0][1:]))
    assert {t[3] for t in obs[1]} == {"drop", "delay"}


def test_router_signals_drop_ranks_a_replica_worst():
    def case(side):
        def rep(rid, depth):
            ctrl = side.adm.AdmissionController()
            ctrl.register_depth_source("q", lambda: depth)
            return SimpleNamespace(replica_id=rid, role="decode",
                                   alive=True, backend=SimpleNamespace(
                                       qos_controller=ctrl))
        router = side.ro.ClusterRouter()
        for r in (rep("decode-1", 1), rep("decode-2", 5)):
            router.register(r)
        with _armed(side, 0, [dict(point="router.signals", kind="drop",
                                   match={"replica": "decode-1"},
                                   max_fires=2)]) as plan:
            placed = [router.place("decode").replica_id for _ in range(3)]
        return [placed, plan.schedule(), router.stats()["placements"]]
    assert both(case)[0] == ["decode-2", "decode-2", "decode-1"]


# ---------------------------------------------------------------------------
# handoff.export, cluster.serve
# ---------------------------------------------------------------------------

def test_handoff_export_failure_is_structured():
    def case(side):
        eng = side.engine()
        eng.attach_tier(host_mb=32)
        p = eng.tokenizer.encode(SYS + " export me", add_bos=True)
        eng.generate([p], temperature=0.0, max_new_tokens=1,
                     session_ids=["h"])
        ho = side.ho.KVHandoff()
        with _armed(side, 0, [dict(point="handoff.export",
                                   kind="fail")]) as plan:
            with pytest.raises(side.ho.HandoffError) as ei:
                ho.export(eng, "h", MEMBER)
        # nothing moved: the session is still the engine's
        return [str(ei.value), ei.value.reason, ho.stats(),
                eng.session_tokens("h") is not None, plan.schedule()]
    assert both(case)[1] == "export_failed"


def test_cluster_serve_crash_marks_the_replica_failed():
    """A replica dying while it serves a delegated request: the row fails
    with the structured error naming replica and path, the replica leaves
    placement, and the next row is served by the survivor with the
    monolithic backend's bits."""
    def case(side):
        mono = backend(side)
        cl = build_cluster(side, replicas=2, disaggregate=False,
                           continuous=False)
        try:
            want = mono.query([req(side, MSGS, max_tokens=8)])[0]
            with _armed(side, 0, [dict(point="cluster.serve", kind="crash",
                                       max_fires=1)]) as plan:
                first = cl.query([req(side, MSGS, max_tokens=8)])[0]
                second = cl.query([req(side, MSGS, max_tokens=8)])[0]
            assert second.text == want.text
            return [res(want), first.error, res(second), plan.schedule(),
                    {r.replica_id: r.alive for r in cl.replicas},
                    cl.router.stats()["placements"]]
        finally:
            mono.close()
            cl.close()
    obs = both(case)
    assert obs[1].startswith("replica_failed:")
    assert "replica=unified-0" in obs[1] and "phase=unified" in obs[1]


# ---------------------------------------------------------------------------
# Disarmed: the same bits
# ---------------------------------------------------------------------------

def test_disarmed_and_unmatched_plans_serve_the_same_bits():
    """Temperature 0, greedy and constrained, sessioned resume: with the
    plane disarmed, and armed with a rule on every point that matches
    nothing, the port serves the JAX package's tokens and cached
    counts; the unmatched plan counts every seam it passed and fires
    none."""
    rules = [dict(point=p, kind="crash", match={"model": "nobody"})
             for p in sorted(PORT.faults.INJECTION_POINTS)]

    def run(side):
        b = backend(side, continuous=True, continuous_chunk=8,
                    host_kv_mb=32, qos=True)
        try:
            r1 = b.query([req(side, MSGS, sid="d", max_tokens=12),
                          req(side, MSGS, cj=True, max_tokens=24)])
            msgs2 = MSGS + [{"role": "assistant", "content": r1[0].text},
                            {"role": "user", "content": "continue."}]
            r2 = b.query([req(side, msgs2, sid="d", max_tokens=12)])
            return [res(r) for r in r1 + r2]
        finally:
            b.close()

    def case(side):
        assert not side.faults.CHAOS.armed()
        clean = run(side)
        with _armed(side, 9, rules) as plan:
            unmatched = run(side)
        assert unmatched == clean and plan.fired == []
        return [clean, sorted(p for p, _ in plan.counts)]
    obs = both(case)
    assert obs[0][2][3] > 0                       # the resume was cached
    assert {"pool.member", "sched.tick", "compile.key",
            "admission.signals"} <= set(obs[1])
