"""The port's consensus-quality layer (quoracle_tpu_torch/consensus/
quality.py ``ConsensusQuality``, ``QUALITY`` and the engine's feed) against
the JAX package's, on the CPU.

Both packages run the same scripted decides over their MockBackends and
feed the same synthetic audit records; the scorecards, drift flags, drift
flight records and sink alerts must be equal (ids and times dropped). The
layer is read-only (decides are the same with it on and off), sinks are
exception-safe, the ``quoracle_consensus_*`` instruments reach the
exposition, the engine feeds the process-wide ``QUALITY``, and the audit
record's ``task_id`` falls back to the current trace id.
"""

import json
import types

from quoracle_tpu.consensus import engine as jce
from quoracle_tpu.consensus import quality as jq
from quoracle_tpu.infra import flightrec as jfr
from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu_torch.consensus import engine as tce
from quoracle_tpu_torch.consensus import quality as tq
from quoracle_tpu_torch.infra import flightrec as tfr
from quoracle_tpu_torch.infra import telemetry as ttel
from quoracle_tpu_torch.models import runtime as trt

JAX = types.SimpleNamespace(name="jax", ce=jce, q=jq, fr=jfr, tel=jtel,
                            rt=jrt)
PORT = types.SimpleNamespace(name="port", ce=tce, q=tq, fr=tfr, tel=ttel,
                             rt=trt)
PKGS = (JAX, PORT)
POOL = list(jrt.MockBackend.DEFAULT_POOL)
TIMES = ("ts", "latency_p50_ms", "latency_p95_ms", "latency_ms")


def both(script):
    out = {p.name: script(p) for p in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def j(action, params=None, wait=False, reasoning="r"):
    return json.dumps({"action": action, "params": params or {},
                       "reasoning": reasoning, "wait": wait})


def msgs():
    return {m: [{"role": "user", "content": "decide"}] for m in POOL}


def untimed(d):
    if isinstance(d, dict):
        return {k: untimed(v) for k, v in d.items() if k not in TIMES}
    if isinstance(d, list):
        return [untimed(v) for v in d]
    return d


def _split_decide(p, q, agree_all=False):
    a = j("file_read", {"path": "a"})
    b = j("file_read", {"path": "b"})
    backend = p.rt.MockBackend(scripts={
        POOL[0]: [a], POOL[1]: [a], POOL[2]: [a if agree_all else b]})
    out = p.ce.ConsensusEngine(backend, p.ce.ConsensusConfig(
        model_pool=POOL, max_refinement_rounds=0)).decide(msgs())
    q.observe_decide(out.audit)
    return out


def _scripted_backend(p):
    a = j("file_read", {"path": "a"})
    b = j("file_read", {"path": "b"})
    return p.rt.MockBackend(scripts={
        POOL[0]: [a, a], POOL[1]: [b, a], POOL[2]: ["garbage", a]})


def test_scorecards_accumulate_agreement_and_dissent_equally():
    def script(p):
        q = p.q.ConsensusQuality(flight=p.fr.FlightRecorder(),
                                 min_samples=10_000)
        for _ in range(3):
            _split_decide(p, q)
        _split_decide(p, q, agree_all=True)
        return untimed(q.scorecards())
    cards = both(script)
    assert cards["n_decides"] == 4
    assert cards["members"][POOL[0]]["agreement_rate"] == 1.0
    assert abs(cards["members"][POOL[2]]["dissent_rate"] - 0.75) < 1e-9


def test_scorecard_failure_and_recovery_rates_equal():
    def script(p):
        q = p.q.ConsensusQuality(flight=p.fr.FlightRecorder(),
                                 min_samples=10_000)
        eng = p.ce.ConsensusEngine(_scripted_backend(p), p.ce.ConsensusConfig(
            model_pool=POOL, max_refinement_rounds=2))
        q.observe_decide(eng.decide(msgs()).audit)
        return untimed(q.scorecards())
    card = both(script)["members"][POOL[2]]
    assert card["failures"] == {"parse": 1}
    assert card["corrections"] == 1 and card["recovery_rate"] == 1.0


def _record(n, model="m1", agreed=True, failure=None):
    return {
        "event": "consensus_audit", "ts": float(n), "decide_id": f"t{n}",
        "task_id": "task-drift", "agent_id": "a1", "status": "ok",
        "rounds": 1,
        "members": {model: {"action": "wait", "cluster": 0,
                            "agreed": agreed, "latency_ms": 4.0,
                            "chip_ms": 1.5}},
        "failure_counts": ({model: {failure: 1}} if failure else {}),
        "corrected": [], "recovered": [], "sim_margins": [0.05, -0.02],
        "entropy_bits": 0.0, "margin": 1.0,
    }


def test_drift_trips_flight_and_sink_then_recovers_equally():
    def script(p):
        fr = p.fr.FlightRecorder()
        q = p.q.ConsensusQuality(flight=fr, min_samples=10,
                                 drift_threshold=0.3, recent_alpha=0.4,
                                 baseline_alpha=0.01)
        alerts = []
        q.add_sink(lambda e: alerts.append(e)
                   if e.get("event", "").startswith("model_health")
                   else None)
        n = 0
        steps = []
        for agreed, k in ((True, 30), (False, 10), (True, 40)):
            for _ in range(k):
                n += 1
                q.observe_decide(_record(n, agreed=agreed))
            steps.append(untimed(q.scorecards()))
        drift = [untimed(e) for e in fr.snapshot()
                 if e["kind"] == "model_health_drift"]
        return steps, drift, untimed(alerts)
    steps, drift, alerts = both(script)
    assert steps[0]["drifting"] == [] and steps[1]["drifting"] == ["m1"]
    assert steps[2]["drifting"] == []
    assert len(drift) == 1 and drift[0]["signal"] == "dissent"
    assert [a["event"] for a in alerts] == ["model_health_drift",
                                           "model_health_recovered"]


def test_drift_failure_signal_equal():
    def script(p):
        fr = p.fr.FlightRecorder()
        q = p.q.ConsensusQuality(flight=fr, min_samples=5,
                                 drift_threshold=0.3, recent_alpha=0.5,
                                 baseline_alpha=0.01)
        n = 0
        for _ in range(20):
            n += 1
            q.observe_decide(_record(n))
        for _ in range(8):
            n += 1
            q.observe_decide(_record(n, agreed=False, failure="transport"))
        return sorted({e["signal"] for e in fr.snapshot()
                       if e["kind"] == "model_health_drift"})
    assert "failure" in both(script)


def test_sinks_receive_audit_records_and_are_exception_safe():
    q = tq.ConsensusQuality(flight=tfr.FlightRecorder(), min_samples=10_000)
    seen = []
    q.add_sink(lambda e: 1 / 0)
    q.add_sink(seen.append)
    _split_decide(PORT, q)
    assert len(seen) == 1 and seen[0]["event"] == "consensus_audit"


def test_outcome_equality_quality_on_off():
    outs = {}
    for quality in (True, False):
        eng = tce.ConsensusEngine(_scripted_backend(PORT),
                                  tce.ConsensusConfig(
                                      model_pool=POOL,
                                      max_refinement_rounds=2,
                                      quality=quality))
        outs[quality] = eng.decide(msgs())
    on, off = outs[True], outs[False]
    assert (on.decision, on.status, on.rounds_used) == \
        (off.decision, off.status, off.rounds_used)
    assert [(p.model_spec, p.action, p.params) for p in on.proposals] == \
        [(p.model_spec, p.action, p.params) for p in off.proposals]
    assert on.audit is not None and off.audit is None


def test_engine_feeds_quality_and_instruments_reach_the_exposition():
    before = tq.QUALITY.scorecards()["n_decides"]
    d0 = ttel.DECIDE_MS.counts()[2]
    r0 = ttel.ROUNDS_TOTAL.total()
    out = tce.ConsensusEngine(_scripted_backend(PORT), tce.ConsensusConfig(
        model_pool=POOL, max_refinement_rounds=2)).decide(msgs())
    assert tq.QUALITY.scorecards()["n_decides"] == before + 1
    assert ttel.DECIDE_MS.counts()[2] == d0 + 1
    assert ttel.ROUNDS_TOTAL.total() == r0 + out.rounds_used
    text = ttel.METRICS.render_prometheus()
    for name in ("quoracle_consensus_vote_entropy_bits",
                 "quoracle_consensus_winner_margin",
                 "quoracle_consensus_rounds_to_decision",
                 "quoracle_consensus_member_failures_total",
                 "quoracle_cost_decide_chip_ms"):
        assert f"# TYPE {name}" in text, name
    assert f'quoracle_consensus_member_decides_total{{model="{POOL[0]}"}}' \
        in text


def test_audit_task_id_falls_back_to_the_trace_id():
    def script(p):
        eng = p.ce.ConsensusEngine(p.rt.MockBackend(), p.ce.ConsensusConfig(
            model_pool=POOL, session_key="agent-1"))
        with p.tel.TRACER.span("agent.decide_tick", trace_id="task-42"):
            traced = eng.decide(msgs()).audit["task_id"]
        cfg = p.ce.ConsensusEngine(p.rt.MockBackend(), p.ce.ConsensusConfig(
            model_pool=POOL, task_id="t-cfg")).decide(msgs())
        untraced = eng.decide(msgs()).audit["task_id"]
        return traced, cfg.audit["task_id"], untraced
    assert both(script) == ("task-42", "t-cfg", None)


def test_audit_record_handles_total_failure_equally():
    def script(p):
        backend = p.rt.MockBackend(scripts={m: ["__error__"] for m in POOL})
        out = p.ce.ConsensusEngine(backend, p.ce.ConsensusConfig(
            model_pool=POOL, max_refinement_rounds=0)).decide(msgs())
        rec = {k: v for k, v in out.audit.items()
               if k not in ("ts", "decide_id")}
        return out.status, untimed(rec)
    status, rec = both(script)
    assert status == "all_failed" and rec["decision"] is None
    assert all(rec["failure_counts"][m] == {"transport": 1} for m in POOL)
