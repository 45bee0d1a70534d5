"""The port's disaggregated serving plane (serving/cluster.py, router.py)
against the JAX package's, on the CPU.

The 18 cases of tests/test_cluster.py, each run on both packages over
the same fp32 tiny weights (tests/_cluster_parity.py) and the same
requests. Each case returns what it observed; the two lists must be
equal: temperature-0 texts, cached tokens and token counts, the handoff
and placement counters, the structured errors with their replica and
phase, router stats, the ``/api/cluster`` payload and the flight records,
with ids and times dropped. ``pool_sizing`` (the JAX ``parallel/``,
ROADMAP Queue 1 item 12) has no port; its case holds the port's replica
tiers to the JAX plan's counts instead.
"""

import copy
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from _cluster_parity import (
    JAX, MEMBER, PORT, SIDES, both, build_cluster, flight_view, req, res,
)
from quoracle_tpu.infra import flightrec as jflight
from quoracle_tpu_torch.infra import flightrec as tflight

torch.set_num_threads(1)

MSGS = [{"role": "user", "content": "hello disaggregated world, "
                                    "please elaborate at length"}]


def _flight(side):
    return jflight.FLIGHT if side is JAX else tflight.FLIGHT


def flight_after(side, before: list) -> list:
    """The flight records appended since the snapshot ``before``."""
    now = _flight(side).snapshot()
    if not before:
        return now
    last = before[-1]
    for i in range(len(now) - 1, -1, -1):
        if now[i] is last:
            return now[i + 1:]
    return now


@pytest.fixture(scope="module")
def planes():
    """A monolithic backend and a 1 prefill + 1 decode cluster a package,
    shared by the cases below in the same order on both sides."""
    from _cluster_parity import backend
    out = {}
    for side in SIDES:
        out[side.name] = (
            backend(side, continuous=True, continuous_chunk=8),
            build_cluster(side, replicas=2, disaggregate=True,
                          continuous=True, continuous_chunk=8))
    yield out
    for mono, cl in out.values():
        mono.close()
        cl.close()


def _decode_reps(cl):
    return [r for r in cl.replicas if r.role == "decode"]


# ---------------------------------------------------------------------------
# Temperature-0 equality against a monolithic backend
# ---------------------------------------------------------------------------

def test_disagg_greedy_bit_equal(planes):
    def case(side):
        mono, cl = planes[side.name]
        a = mono.query([req(side, MSGS)])[0]
        b = cl.query([req(side, MSGS)])[0]
        assert a.ok and b.ok, (a.error, b.error)
        assert b.text == a.text
        assert cl.handoff.exports >= 1 and cl.handoff.adopts >= 1
        return [res(a), res(b), cl.handoff.stats()]
    both(case)


def test_disagg_constrained_json_bit_equal(planes):
    def case(side):
        mono, cl = planes[side.name]
        a = mono.query([req(side, MSGS, cj=True, max_tokens=32)])[0]
        b = cl.query([req(side, MSGS, cj=True, max_tokens=32)])[0]
        assert a.ok and b.ok, (a.error, b.error)
        assert b.text == a.text
        return [res(a), res(b), cl.handoff.stats()]
    both(case)


def test_disagg_speculative_bit_equal():
    def case(side):
        from _cluster_parity import backend
        kw = dict(continuous=True, continuous_chunk=8,
                  draft_map={MEMBER: MEMBER}, draft_k=4)
        mono = backend(side, **kw)
        cl = build_cluster(side, replicas=2, disaggregate=True, **kw)
        try:
            a = mono.query([req(side, MSGS, sid="sp1", cj=True,
                                max_tokens=24)])[0]
            b = cl.query([req(side, MSGS, sid="sp1", cj=True,
                              max_tokens=24)])[0]
            assert a.ok and b.ok, (a.error, b.error)
            assert b.text == a.text
            assert b.spec_rounds > 0
            return [res(a), res(b), b.spec_accepted_tokens,
                    cl.handoff.stats()]
        finally:
            mono.close()
            cl.close()
    both(case)


def test_session_affinity_round2_bit_equal(planes):
    def case(side):
        mono, cl = planes[side.name]
        a1 = mono.query([req(side, MSGS, sid="conv1")])[0]
        b1 = cl.query([req(side, MSGS, sid="conv1")])[0]
        assert b1.text == a1.text
        exports_before = cl.handoff.exports
        msgs2 = MSGS + [{"role": "assistant", "content": a1.text},
                        {"role": "user", "content": "continue."}]
        a2 = mono.query([req(side, msgs2, sid="conv1")])[0]
        b2 = cl.query([req(side, msgs2, sid="conv1")])[0]
        assert a2.ok and b2.ok, (a2.error, b2.error)
        assert b2.text == a2.text
        assert cl.handoff.exports == exports_before
        assert b2.cached_tokens == a2.cached_tokens > 0
        rep = cl.router.affinity_of("conv1")
        assert rep is not None and rep.role == "decode"
        held = rep.replica_id
        cl.drop_session("conv1")
        mono.drop_session("conv1")
        assert cl.router.affinity_of("conv1") is None
        return [res(a1), res(b1), res(a2), res(b2), held,
                cl.router.stats()["affinity_sessions"]]
    both(case)


# ---------------------------------------------------------------------------
# Degraded modes
# ---------------------------------------------------------------------------

def test_decode_replica_death_replaces_row():
    """The retained envelope re-places a row whose decode replica died;
    a second death with no survivor fails the row with a structured
    error naming the replica. The flight records agree."""
    def case(side):
        from _cluster_parity import backend
        mono = backend(side, continuous=True, continuous_chunk=8)
        cl = build_cluster(side, replicas=3, disaggregate=True,
                           continuous=True, continuous_chunk=8)
        try:
            want = mono.query([req(side, MSGS)])[0]
            decs = _decode_reps(cl)
            assert len(decs) == 2
            first = cl.router.place("decode")
            assert first.role == "decode"
            for cb in first.backend._cbatchers.values():
                cb.close()
            before = _flight(side).snapshot()
            got = cl.query([req(side, MSGS)])[0]
            assert got.ok, got.error
            assert got.text == want.text
            assert cl.handoff.replaced >= 1
            stats = cl.router.stats()
            assert stats["replicas"][first.replica_id]["alive"] is False
            survivor = [r for r in decs
                        if r.replica_id != first.replica_id][0]
            for cb in survivor.backend._cbatchers.values():
                cb.close()
            got2 = cl.query([req(side, MSGS)])[0]
            assert not got2.ok
            assert "replica_failed" in got2.error
            assert survivor.replica_id in got2.error
            events = flight_after(side, before)
            dead = [{k: v for k, v in e.items() if k != "error"}
                    for e in flight_view(events, {"cluster_replica_dead"})]
            return [res(want), res(got), got2.error.split(":")[0],
                    "replica=" + survivor.replica_id in got2.error,
                    "phase=decode" in got2.error, cl.handoff.stats(),
                    {rid: r["alive"] for rid, r in
                     stats["replicas"].items()},
                    flight_view(events, {"kv_handoff_replace"}), dead]
        finally:
            mono.close()
            cl.close()
    both(case)


def _bf16_engine(side):
    """An engine over the shared fp32 weights cast to bf16 (a copy)."""
    from _cluster_parity import KW, _weights
    from _torch_parity import both_configs
    jcfg, tcfg = both_configs("tiny")
    params, model = _weights()
    if side is JAX:
        from quoracle_tpu.models.tokenizer import ByteTokenizer
        return side.gen.GenerateEngine(
            jcfg, jax.tree.map(lambda x: x.astype(jnp.bfloat16), params),
            ByteTokenizer(), **KW)
    from quoracle_tpu_torch.models.tokenizer import ByteTokenizer
    return side.gen.GenerateEngine(
        tcfg, copy.deepcopy(model).to(torch.bfloat16), ByteTokenizer(),
        device="cpu", **KW)


def test_signature_mismatch_rejected_at_handoff():
    def case(side):
        src, dst = side.engine(), _bf16_engine(side)
        src.attach_tier(host_mb=64)
        dst.attach_tier(host_mb=64)
        assert src.kv_signature() != dst.kv_signature()
        prompt = src.tokenizer.encode("signature test prompt",
                                      add_bos=True)
        src.generate([prompt], temperature=0.0, max_new_tokens=1,
                     session_ids=["h1"])
        ho = side.ho.KVHandoff()
        env = ho.export(src, "h1", MEMBER)
        with pytest.raises(side.ho.HandoffError) as ei:
            ho.adopt(dst, env)
        assert ei.value.reason == "signature"
        assert ho.rejects == 1
        assert not dst.sessions.tier.has_session("h1")
        return [src.kv_signature(), dst.kv_signature(), ei.value.reason,
                ho.stats()]
    both(case)


def test_signature_mismatch_degrades_to_cold_prefill(planes, monkeypatch):
    def case(side):
        mono, cl = planes[side.name]
        dec = _decode_reps(cl)[0]
        eng = dec.backend.engines[MEMBER]
        monkeypatch.setattr(eng, "kv_signature",
                            lambda: "skewed-signature", raising=False)
        try:
            want = mono.query([req(side, MSGS)])[0]
            got = cl.query([req(side, MSGS)])[0]
            assert got.ok, got.error
            assert got.text == want.text
            return [res(want), res(got), cl.handoff.stats()]
        finally:
            monkeypatch.undo()
    both(case)


def test_all_decode_replicas_shed_propagates_max_retry_after():
    def case(side):
        from quoracle_tpu.serving.qos import Priority as JP
        from quoracle_tpu_torch.serving.qos import Priority as TP
        prio = (JP if side is JAX else TP).INTERACTIVE
        cl = build_cluster(side, replicas=3, disaggregate=True,
                           continuous=True, continuous_chunk=8, qos=True)
        try:
            decs = _decode_reps(cl)
            for i, rep in enumerate(decs):
                ctrl = rep.backend.qos_controller
                ctrl.config.max_queue_depth = 0
                ctrl.config.base_retry_ms = 1000 * (i + 1)
            with pytest.raises(side.adm.OverloadedError) as ei:
                cl.router.admit(tenant="t1", priority=prio)
            retries = []
            for rep in decs:
                try:
                    rep.backend.qos_controller.admit(tenant="probe",
                                                     priority=prio)
                except side.adm.OverloadedError as e:
                    retries.append(e.retry_after_ms)
            assert len(retries) == 2
            assert ei.value.retry_after_ms == side.adm.escalate_retry_ms(
                max(retries), 1)
            assert cl.router.shed == 1
            got = cl.query([req(side, MSGS, priority=prio)])[0]
            assert not got.ok and "admission_rejected" in got.error
            return [ei.value.retry_after_ms, str(ei.value), retries,
                    cl.router.shed, got.error]
        finally:
            cl.close()
    both(case)


def test_router_retry_after_backs_off_monotonically():
    def case(side):
        def make_rep(rid):
            ctrl = side.adm.AdmissionController()
            ctrl.config.max_queue_depth = 0
            ctrl.register_depth_source("q", lambda: 1)
            return SimpleNamespace(replica_id=rid, role="decode",
                                   alive=True, backend=SimpleNamespace(
                                       qos_controller=ctrl))
        router = side.ro.ClusterRouter()
        reps = [make_rep("decode-1"), make_rep("decode-2")]
        for r in reps:
            router.register(r)
        hints = []
        for _ in range(10):
            with pytest.raises(side.adm.OverloadedError) as ei:
                router.admit(tenant="t1")
            hints.append(ei.value.retry_after_ms)
        assert hints == sorted(hints)
        assert hints[-1] == side.adm.BACKOFF_CAP_MS
        st1 = router.stats()
        for r in reps:
            r.backend.qos_controller.config.max_queue_depth = 64
        router.admit(tenant="t1")
        streak = router.stats()["shed_streak"]
        for r in reps:
            r.backend.qos_controller.config.max_queue_depth = 0
        with pytest.raises(side.adm.OverloadedError) as ei:
            router.admit(tenant="t1")
        return [hints, st1["shed_streak"], st1["last_retry_after_ms"],
                streak, ei.value.retry_after_ms,
                [side.adm.escalate_retry_ms(1000, n) for n in range(1, 8)]]
    both(case)


# ---------------------------------------------------------------------------
# Structured admission signals + staleness guard
# ---------------------------------------------------------------------------

def test_signal_snapshot_is_the_shed_ladders_numbers():
    def case(side):
        ctrl = side.adm.AdmissionController()
        ctrl.register_depth_source("q", lambda: 7)
        snap = ctrl.signals()
        assert snap.admit_wait_p95_ms == ctrl.admit_wait_p95_ms
        d = snap.as_dict()
        return [snap.queue_depth, sorted(d),
                {k: v for k, v in d.items()
                 if k not in ("ts", "refreshed_ts", "hbm_headroom",
                              "admit_wait_p95_ms")}]
    both(case)


def test_signal_snapshot_staleness_guard():
    def case(side):
        ctrl = side.adm.AdmissionController()
        t0 = time.monotonic()
        s0 = ctrl.signals(now=t0)
        s1 = ctrl.signals(now=t0 + 0.5)
        s2 = ctrl.signals(now=t0 + 0.6, max_age_s=0.2)
        return [s0.age_s(t0), s1.refreshed_ts == s0.refreshed_ts,
                s1.age_s(t0 + 0.5) == pytest.approx(0.5),
                s1.stale(0.2, now=t0 + 0.5), s2.refreshed_ts == t0 + 0.6,
                s2.stale(0.2, now=t0 + 0.6)]
    assert both(case) == [0.0, True, True, True, True, False]


# ---------------------------------------------------------------------------
# Role restriction, unified mode, replica tiers
# ---------------------------------------------------------------------------

def test_prefill_role_engine_rejects_decode(planes):
    def case(side):
        _, cl = planes[side.name]
        pre = [r for r in cl.replicas if r.role == "prefill"][0]
        eng = pre.backend.engines[MEMBER]
        assert eng.role == "prefill"
        with pytest.raises(ValueError, match="prefill-tier") as ei:
            eng.generate([[1, 2, 3]], temperature=0.0, max_new_tokens=4)
        return [pre.replica_id, str(ei.value)]
    both(case)


def test_unified_replicas_serve_bit_equal(planes):
    def case(side):
        mono, _ = planes[side.name]
        cl = build_cluster(side, replicas=2, disaggregate=False,
                           continuous=True, continuous_chunk=8)
        try:
            assert not cl.disaggregated
            a = mono.query([req(side, MSGS, sid="u1")])[0]
            b = cl.query([req(side, MSGS, sid="u1")])[0]
            assert b.ok and b.text == a.text
            assert cl.handoff.exports == 0
            held = cl.router.affinity_of("u1")
            mono.drop_session("u1")
            return [res(a), res(b), held.replica_id, held.role,
                    [(r.replica_id, r.role) for r in cl.replicas]]
        finally:
            cl.close()
    both(case)


def test_replica_tiers_follow_the_jax_pool_sizing_plan():
    """tests/test_cluster.py's pool_sizing case: the JAX capacity plan
    (parallel/mesh.py, not ported) and the port's build split a cluster
    into the same tiers."""
    from quoracle_tpu.parallel.mesh import pool_sizing
    for n, disagg in ((2, True), (3, True), (4, True), (3, False)):
        plan = pool_sizing([MEMBER], 8, host_kv_mb=512, replicas=n,
                           disaggregate=disagg)["replica_tiers"]
        cl = build_cluster(PORT, replicas=n, disaggregate=disagg,
                           continuous=False)
        try:
            roles = [r.role for r in cl.replicas]
            for role in ("prefill", "decode", "unified"):
                want = plan[role]["replicas"] if role in plan else 0
                assert roles.count(role) == want, (n, disagg, role)
            assert plan["disaggregate"] is disagg
            if disagg:
                assert plan["prefill"]["resident_sessions"] == 0
                assert all(r.backend.engines[MEMBER].role == r.role
                           for r in cl.replicas)
        finally:
            cl.close()


# ---------------------------------------------------------------------------
# Observability surfaces
# ---------------------------------------------------------------------------

def _payload_view(p: dict) -> dict:
    """The cluster payload without its time-varying numbers: signal
    timestamps and ages, and the process-wide counter series (keys
    only)."""
    out = copy.deepcopy({k: v for k, v in p.items() if k != "counters"})
    for rep in out["router"]["replicas"].values():
        sig = rep.get("signals")
        if sig:
            for k in ("ts", "refreshed_ts", "hbm_headroom"):
                sig.pop(k, None)
    return {**out, "counter_keys": sorted(p.get("counters", {}))}


def test_cluster_stats_and_api_payload(planes):
    def case(side):
        _, cl = planes[side.name]
        stats = cl.cluster_stats()
        assert stats["enabled"] and stats["disaggregated"]
        if side is JAX:
            from quoracle_tpu.web.server import DashboardServer
        else:
            from quoracle_tpu_torch.web.server import DashboardServer
        d = DashboardServer(SimpleNamespace(backend=cl))
        payload = d.cluster_payload()
        assert "handoffs" in payload["counters"]
        d2 = DashboardServer(SimpleNamespace(backend=object()))
        return [_payload_view(payload), d2.cluster_payload()["enabled"]]
    both(case)


def test_cluster_events_ring_and_flight_registration():
    def case(side):
        if side is JAX:
            from quoracle_tpu.infra import bus as B
            from quoracle_tpu.infra.event_history import EventHistory
        else:
            from quoracle_tpu_torch.infra import bus as B
            from quoracle_tpu_torch.infra.event_history import EventHistory
        kinds = ("kv_handoff_export", "kv_handoff_adopt",
                 "kv_handoff_reject", "kv_handoff_replace",
                 "cluster_replica_dead", "router_all_shed")
        flight_events = (jflight if side is JAX else tflight).FLIGHT_EVENTS
        registered = [k in flight_events for k in kinds]
        bus = B.EventBus()
        hist = EventHistory(bus)
        try:
            bus.broadcast(B.TOPIC_CLUSTER, {"event": "replica_failed",
                                            "replica": "decode-1"})
            ring = hist.replay_cluster()
            return [registered, B.TOPIC_CLUSTER, ring[-1]["replica"]]
        finally:
            hist.close()
    assert both(case)[0] == [True] * 6


def test_runtime_builds_cluster_backend():
    """A torch-backend Runtime with replicas > 1 serves through a
    ClusterPlane on the device asked for; the mock backend refuses the
    flags loudly."""
    from quoracle_tpu_torch.runtime import Runtime, RuntimeConfig
    rt = Runtime(RuntimeConfig(backend="torch", device="cpu",
                               model_pool=[MEMBER], replicas=2,
                               disaggregate=True))
    try:
        assert isinstance(rt.backend, PORT.cl.ClusterPlane)
        assert rt.backend.disaggregated
        assert rt.default_pool() == [MEMBER]
        names = [n for n, _ in rt.backend.watchdog_sources()]
        assert any(n.startswith("decode-") for n in names)
        assert {e.device.type for e in rt.backend.engines.values()} \
            == {"cpu"}
    finally:
        rt.close()
        rt.backend.close()
    with pytest.raises(ValueError, match="--replicas"):
        Runtime(RuntimeConfig(backend="mock", replicas=2))
    # the JAX runtime's cluster names the same watchdog sources
    from quoracle_tpu.runtime import Runtime as JRuntime
    from quoracle_tpu.runtime import RuntimeConfig as JConfig
    from _cluster_parity import jax_shared_backends
    with jax_shared_backends():
        jrt_ = JRuntime(JConfig(backend="tpu", model_pool=[MEMBER],
                                replicas=2, disaggregate=True))
    try:
        jnames = [n for n, _ in jrt_.backend.watchdog_sources()]
    finally:
        jrt_.close()
        jrt_.backend.close()
    assert names == jnames


def test_kv_and_qos_stats_aggregate_per_replica(planes):
    def case(side):
        _, cl = planes[side.name]
        kv = cl.kv_stats()
        assert kv["enabled"] and kv["cluster"]
        assert set(kv["replicas"]) == {r.replica_id for r in cl.replicas}
        sched = cl.scheduler_stats()
        assert any(k.startswith("decode-") for k in sched)
        assert not any(k.startswith("prefill-") for k in sched)
        qos = cl.qos_stats()
        return [sorted(kv["replicas"]), kv["handoff"], sorted(sched),
                sorted({k.split("@", 1)[0] for k in cl.engines}),
                qos["enabled"], sorted(qos["replicas"]),
                {rid: sorted(m.get("members", {}))
                 for rid, m in kv["replicas"].items()}]
    both(case)
