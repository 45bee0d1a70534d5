"""The port's fleet-scope observability (quoracle_tpu_torch/infra/
fleetobs.py) against the JAX package's, on the CPU.

The scenarios of tests/test_fleetobs.py that need no fabric run through
both packages: trace contexts as remote parents, the span ring's counted
overflow and knobs, lossless histogram merges and the federation rollup
(equal quantiles, equal exposition), deterministic incident ids with
retention, and the timeline's exact stage attribution. The request-span
helpers build nothing while no sink listens, and the continuous loop's
decode-tick spans follow the sampling period.
"""

import json
import types

import numpy as np
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.infra import fleetobs as jfleet
from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu_torch.infra import fleetobs as tfleet
from quoracle_tpu_torch.infra import telemetry as ttel
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import scheduler as tsch
from quoracle_tpu_torch.models import tokenizer as ttok

torch.set_num_threads(1)

JAX = types.SimpleNamespace(name="jax", fleet=jfleet, tel=jtel)
PORT = types.SimpleNamespace(name="port", fleet=tfleet, tel=ttel)
PKGS = (JAX, PORT)


def both(script):
    out = {p.name: script(p) for p in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def test_trace_context_is_a_valid_parent_and_survives_garbage():
    def script(p):
        ctx = p.fleet.TraceContext(trace_id="tr-x", span_id="s-x")
        span = p.tel.Tracer().start("child", parent=ctx)
        return (p.fleet.TraceContext.from_dict(ctx.to_dict()) == ctx,
                span.trace_id, span.parent_id,
                [p.fleet.TraceContext.from_dict(g) for g in (
                    None, "str", 7, {}, {"trace_id": ""}, {"trace_id": "t"},
                    {"span_id": "s"}, {"trace_id": 3, "span_id": "s"})])
    assert both(script) == (True, "tr-x", "s-x", [None] * 8)


def test_span_ring_overflow_counted_not_silent():
    def script(p):
        ring = p.fleet.SpanRing(capacity=16, ring_label="fleetobs")
        before = p.tel.TRACE_DROPPED_TOTAL.value(ring="fleetobs")
        for i in range(21):
            ring.record({"span_id": f"s{i}", "name": "x", "ts": float(i),
                         "session": "a" if i % 2 else "b"})
        return (ring.stats(),
                p.tel.TRACE_DROPPED_TOTAL.value(ring="fleetobs") - before,
                [s["span_id"] for s in ring.spans(session_id="a")])
    stats, dropped, _ = both(script)
    assert stats == {"n_spans": 16, "capacity": 16, "dropped": 5}
    assert dropped == 5


def test_ring_size_and_tick_sampling_knobs(monkeypatch):
    def script(p):
        monkeypatch.setenv("QUORACLE_TRACE_RING", "64")
        out = [p.fleet.ring_capacity(), p.fleet.SpanRing().capacity]
        monkeypatch.setenv("QUORACLE_TRACE_DECODE_SAMPLE", "4")
        out += [p.fleet.decode_tick_sample(),
                [p.fleet.sample_tick(i) for i in range(8)]]
        monkeypatch.setenv("QUORACLE_TRACE_DECODE_SAMPLE", "garbage")
        monkeypatch.setenv("QUORACLE_TRACE_RING", "3")
        out += [p.fleet.decode_tick_sample(), p.fleet.ring_capacity()]
        return out
    assert both(script) == [64, 64, 4, [True, False, False, False] * 2,
                            16, 16]


def test_histogram_merge_matches_hand_computed_oracle():
    rng = np.random.default_rng(5)
    a = rng.uniform(0.2, 4000.0, 700)
    b = rng.uniform(0.1, 9000.0, 400)

    def script(p):
        h1, h2 = p.tel.Histogram("m1"), p.tel.Histogram("m1")
        oracle = p.tel.Histogram("m1")
        for v in a:
            h1.observe(float(v), model="t")
            oracle.observe(float(v), model="t")
        for v in b:
            h2.observe(float(v), model="t")
            oracle.observe(float(v), model="t")
        h1.merge(h2)
        assert h1.percentiles() == oracle.percentiles()
        assert h1.counts()[0] == oracle.counts()[0]
        return h1.percentiles(), h1.counts()[0]
    both(script)


def _fed_states(p, streams):
    states = {}
    for peer, vals in streams.items():
        reg = p.tel.MetricsRegistry()
        h = reg.histogram("quoracle_test_fed_ms")
        c = reg.counter("quoracle_test_fed_total")
        reg.gauge("quoracle_test_fed_gauge").set(2.5, dev="0")
        for v in vals:
            h.observe(float(v), model="t")
        c.inc(len(vals), model="t")
        states[peer] = reg.export_state()
    return states


def test_federation_rollup_quantiles_equal_merged_oracle():
    rng = np.random.default_rng(9)
    streams = {"peer-a": rng.uniform(0.5, 800.0, 300),
               "peer-b": rng.uniform(0.5, 6000.0, 500),
               "peer-c": rng.uniform(20.0, 90.0, 150)}

    def script(p):
        oracle = p.tel.Histogram("quoracle_test_fed_ms")
        for vals in streams.values():
            for v in vals:
                oracle.observe(float(v), model="t")
        states = _fed_states(p, streams)
        json.dumps(states)
        fed = p.fleet.federate(states)
        assert fed.quantiles("quoracle_test_fed_ms") == oracle.percentiles()
        states["peer-bad"] = {"quoracle_test_fed_ms": {
            "kind": "histogram", "buckets": [1, 2], "series": [[[], {}]]}}
        bad = p.fleet.federate(states).skipped
        return (fed.quantiles("quoracle_test_fed_ms", model="t"),
                fed.snapshot(), fed.render_prometheus(), bad)
    q, snap, text, bad = both(script)
    assert snap["quoracle_test_fed_total"]["total"] == 950
    assert 'quoracle_test_fed_gauge{dev="0",peer="peer-b"} 2.5' in text
    assert any("peer-bad" in s for s in bad)


def test_local_obs_state_carries_the_registry_and_chip_ms():
    st = tfleet.local_obs_state()
    assert set(st) == set(jfleet.local_obs_state())
    assert "quoracle_decide_ms" in st["state"]
    json.dumps(st)


def test_incident_ids_deterministic_equal_and_retention_pruned(tmp_path):
    def script(p):
        m = p.fleet.IncidentManager(directory=str(tmp_path / p.name),
                                    retention=3)
        ids = [m.capture("replica_dead", "decode-0", broadcast=False)
               for _ in range(2)]
        ids.append(m.capture("watchdog", "batcher", broadcast=False))
        listed = m.list()
        assert all(any(f.startswith("local-") for f in b["files"])
                   for b in listed)
        assert m.peer_dump(ids[0], "decode-1") is not None
        bundle = [b for b in m.list() if b["incident_id"] == ids[0]][0]
        for i in range(5):
            m.capture("manual", f"k{i}", broadcast=False)
        return (ids, sorted(b["incident_id"] for b in listed),
                "peer-decode-1.json" in bundle["files"], len(m.list()))
    ids, listed, peer, kept = both(script)
    assert len(set(ids)) == 3 and sorted(ids) == listed
    assert peer and kept == 3


def test_incident_notifier_seam_called_and_failures_swallowed(tmp_path):
    m = tfleet.IncidentManager(directory=str(tmp_path))
    got = []
    m.add_notifier(lambda *a: 1 / 0)
    m.add_notifier(lambda *a: got.append(a))
    iid = m.capture("stall", "x", reason="r")
    assert got == [(iid, "stall", "x", "r")]
    assert m.status()["notifiers"] == 2


TIMELINE = [
    {"span_id": "s1", "name": "door.request", "trace_id": "tr",
     "ts": 100.0, "duration_ms": 100.0, "session": "sess"},
    {"span_id": "s2", "name": "door.prefill_rpc", "trace_id": "tr",
     "ts": 100.001, "duration_ms": 40.0, "session": "sess"},
    {"span_id": "s3", "name": "peer.prefill", "trace_id": "tr",
     "ts": 100.002, "duration_ms": 30.0, "session": "sess"},
    {"span_id": "s4", "name": "kv.export", "trace_id": "tr",
     "ts": 100.025, "duration_ms": 5.0, "session": "sess"},
    {"span_id": "s5", "name": "peer.decode", "trace_id": "tr",
     "ts": 100.045, "duration_ms": 50.0, "session": "sess"},
    {"span_id": "s6", "name": "kv.adopt", "trace_id": "tr",
     "ts": 100.046, "duration_ms": 6.0, "session": "sess"},
    {"span_id": "s7", "name": "sched.queue_wait", "trace_id": "tr",
     "ts": 100.052, "duration_ms": 4.0, "session": "sess"},
    {"span_id": "s7", "name": "sched.queue_wait", "trace_id": "tr",
     "ts": 100.052, "duration_ms": 4.0, "session": "sess"},
    {"span_id": "s8", "name": "door.request", "trace_id": "tr2",
     "ts": 100.0, "duration_ms": 999.0, "session": "other"},
    {"span_id": "s9", "name": "sched.decode", "trace_id": "tr",
     "ts": 100.06, "duration_ms": 3.0, "session": "sess",
     "wall_ns": 3_000_000, "waits_ns": {"dispatch": 2_000_000,
                                        "other": 1_000_000}},
]


def test_timeline_attribution_sums_to_total_exactly():
    tl = both(lambda p: p.fleet.assemble_timeline(TIMELINE,
                                                  session_id="sess"))
    assert tl["contiguous"] and tl["n_spans"] == 8
    assert tl["stages"] == {"queue_wait": 4.0, "prefill": 25.0,
                            "kv_export": 5.0, "wire": 20.0,
                            "kv_adopt": 6.0, "decode": 40.0}
    assert tl["stages_sum_ms"] == tl["total_ms"] == 100.0
    assert tl["waits"]["exact"] is True


def test_request_span_builds_nothing_without_a_sink():
    import contextlib
    # the tracer is process-wide: a runtime or a span ring installed by an
    # earlier test in this process leaves its sinks on it
    saved = list(ttel.TRACER._sinks)
    for fn in saved:
        ttel.TRACER.remove_sink(fn)
    got = []
    try:
        assert not ttel.TRACER.active()
        assert isinstance(tfleet.request_span("door.request", "s1"),
                          contextlib.nullcontext)
        ttel.TRACER.add_sink(got.append)
        with tfleet.request_span("door.request", "s1"):
            tfleet.tag_current_span("s1")
            ctx = tfleet.TraceContext.current()
        with tfleet.bind_remote(ctx):
            ttel.TRACER.emit("peer.serve", 1.0)
    finally:
        ttel.TRACER.remove_sink(got.append)
        for fn in saved:
            ttel.TRACER.add_sink(fn)
    door, peer = sorted(got, key=lambda e: e["name"])
    assert door["trace_id"] == peer["trace_id"] == ctx.trace_id
    assert peer["parent_id"] == door["span_id"]
    assert door["trace_id"].startswith("tr-s1-")


def test_loop_decode_tick_spans_follow_the_sampling_period(monkeypatch):
    """With the period at 2, a row that takes T ticks emits ceil(T/2)
    sched.decode_tick spans (ticks 0, 2, ...), one queue-wait and one
    decode span, all parented on the submitter's span."""
    monkeypatch.setenv("QUORACLE_TRACE_DECODE_SAMPLE", "2")
    _, tcfg = both_configs("tiny")
    _, tp = shared_params("tiny", seed=2)
    eng = tgen.GenerateEngine(tcfg, tp, ttok.get_tokenizer("xla:tiny"),
                              device="cpu", max_seq=256,
                              prompt_buckets=(32, 64, 128))
    got = []
    ttel.TRACER.add_sink(got.append)
    cb = tsch.ContinuousBatcher(eng, chunk=4)
    try:
        with ttel.TRACER.span("caller", trace_id="tr-loop") as root:
            fut = cb.submit(eng.tokenizer.encode("user: tick", add_bos=True),
                            temperature=0.0, max_new_tokens=16)
        g = fut.result(120)
    finally:
        cb.close()
        ttel.TRACER.remove_sink(got.append)
    ticks = [e for e in got if e["name"] == "sched.decode_tick"]
    steps = cb.steps
    assert len(ticks) == (steps + 1) // 2
    assert [e["step"] for e in ticks] == list(range(0, steps, 2))
    row = [e for e in got if e["name"] in ("sched.queue_wait",
                                          "sched.decode")]
    assert [e["name"] for e in row] == ["sched.queue_wait", "sched.decode"]
    assert all(e["parent_id"] == root.span_id and
               e["trace_id"] == "tr-loop" for e in row)
    assert row[1]["tokens"] == len(g.token_ids)
