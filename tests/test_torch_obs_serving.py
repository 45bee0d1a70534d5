"""Observability of the port's serving path as a whole, on the CPU.

Two invariants of the JAX package's planes, held for the port:

* **On changes no output.** The same rows (greedy, grammar-constrained and
  seeded sampled, with a resumed second round) come back bit-identical
  with every plane off (no tracer sink; cost, tree and introspect planes
  disabled), on (a tracer sink, the span ring, the cost, tree and
  introspect planes with the profiler running), and off again: on the
  unified, direct and gather tiers, through the continuous loop, with
  speculation, and across a hibernate and restore of the KV tiers.
* **Off builds nothing.** With no sink, generate calls on every tier and
  the loop's rows build no ``Span`` (counted by a patched constructor).

And parity with the JAX package over the same serving calls: counter
deltas of the ``KV_*``, ``SCHED_*``, ``SPEC_*``, ``QOS_*``, ``PREFIX_*``
and ``QUANT_*`` families, the flight records (kinds and fields, times
dropped), ``padding_stats``, and the span tree of one decide (names,
parents and attributes, ids and times dropped) with the audit record's
``task_id`` equal to the trace id.
"""

import contextlib
import types

import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.consensus import engine as jce
from quoracle_tpu.infra import costobs as jco
from quoracle_tpu.infra import fleetobs as jfleet
from quoracle_tpu.infra import flightrec as jfr
from quoracle_tpu.infra import introspect as jintro
from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu.infra import treeobs as jtree
from quoracle_tpu.models import embeddings as jemb
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import scheduler as jsch
from quoracle_tpu.models import speculative as jspec
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.serving import admission as jadm
from quoracle_tpu.serving import qos as jqos
from quoracle_tpu_torch.consensus import engine as tce
from quoracle_tpu_torch.infra import costobs as tco
from quoracle_tpu_torch.infra import fleetobs as tfleet
from quoracle_tpu_torch.infra import flightrec as tfr
from quoracle_tpu_torch.infra import introspect as tintro
from quoracle_tpu_torch.infra import telemetry as ttel
from quoracle_tpu_torch.infra import treeobs as ttree
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import scheduler as tsch
from quoracle_tpu_torch.models import speculative as tspec
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.serving import admission as tadm
from quoracle_tpu_torch.serving import qos as tqos

torch.set_num_threads(1)

JAX = types.SimpleNamespace(
    name="jax", co=jco, fleet=jfleet, fr=jfr, intro=jintro, tel=jtel,
    tree=jtree, gen=jgen, rt=jrt, sch=jsch, spec=jspec, tok=jtok, adm=jadm,
    qos=jqos, ce=jce)
PORT = types.SimpleNamespace(
    name="port", co=tco, fleet=tfleet, fr=tfr, intro=tintro, tel=ttel,
    tree=ttree, gen=tgen, rt=trt, sch=tsch, spec=tspec, tok=ttok, adm=tadm,
    qos=tqos, ce=tce)
PKGS = (JAX, PORT)
MEMBER = "xla:tiny"
WAIT = 120.0
SYS = "policy rules apply here. " * 6
FAMILIES = ("quoracle_kv_", "quoracle_sched_", "quoracle_spec_",
            "quoracle_qos_", "quoracle_prefix_", "quoracle_quant_")


def engine(pkg, tier="unified", seed=9, **kw):
    jcfg, tcfg = both_configs("tiny")
    jp, tp = shared_params("tiny", seed=seed)
    kw = dict(max_seq=256, prompt_buckets=(32, 64, 128), **kw)
    if pkg is JAX:
        e = jgen.GenerateEngine(jcfg, jp, jtok.get_tokenizer(MEMBER), **kw)
    else:
        e = tgen.GenerateEngine(tcfg, tp, ttok.get_tokenizer(MEMBER),
                                device="cpu", **kw)
    e.unified_min_tokens = 1 << 30
    if tier == "unified":
        e.unified_min_tokens = 0
    elif tier == "direct":
        e.direct_decode_min_tokens = e.direct_prefill_min_tokens = 0
        e.prefix_sharing = False
    elif tier == "gather":
        e._force_gather_decode = True
    return e


def enc(text):
    return ttok.get_tokenizer(MEMBER).encode(text, add_bos=True)


@contextlib.contextmanager
def planes(pkg, on: bool, events=None):
    """Every plane of ``pkg`` on (a sink collecting into ``events``, the
    span ring, cost/tree/introspect with the profiler) or off (no sink,
    the three planes disabled). Restores the previous sinks after."""
    tr = pkg.tel.TRACER
    saved = list(tr._sinks)
    for fn in saved:
        tr.remove_sink(fn)
    for mod in (pkg.co, pkg.tree, pkg.intro):
        (mod.enable if on else mod.disable)()
    sink = events.append if events is not None else (lambda e: None)
    if on:
        tr.add_sink(sink)
        tr.add_sink(pkg.fleet.SPANS.record)
        pkg.intro.PROFILER.start()
    try:
        yield
    finally:
        pkg.intro.PROFILER.close()
        for fn in list(tr._sinks):
            tr.remove_sink(fn)
        for fn in saved:
            tr.add_sink(fn)
        for mod in (pkg.co, pkg.tree, pkg.intro):
            mod.enable()


def _rows_view(gs):
    return [(g.token_ids, g.finish_reason, g.n_cached_tokens, g.json_state)
            for g in gs]


def _engine_rounds(eng):
    """Two sessioned rounds (greedy, constrained, seeded sampled) and a
    sessionless row, through one engine's default dispatch."""
    ps = [enc(SYS + f"task {i}") for i in range(3)]
    g = torch.Generator().manual_seed(1234)
    out = []
    for rnd in range(2):
        res = eng.generate(
            [p + (enc(" next") if rnd else []) for p in ps],
            temperature=[0.0, 0.0, 0.8], top_p=[1.0, 1.0, 0.9],
            max_new_tokens=12, session_ids=["a", "b", "c"],
            constrain_json=[False, True, False], generator=g)
        out.append(_rows_view(res))
    out.append(_rows_view(eng.generate([enc("user: sessionless")],
                                       temperature=0.0, max_new_tokens=8)))
    return out


def _loop_rows(eng, speculate=False):
    eng._generator.manual_seed(77)
    spec = (tspec.BatchedSpeculator(eng, eng, k=4) if speculate else None)
    cb = tsch.ContinuousBatcher(eng, chunk=4, speculator=spec)
    try:
        futs = [cb.submit(enc(SYS + f"row {i}"), temperature=t,
                          max_new_tokens=14, session_id=f"s{i}",
                          constrain_json=(i == 1), task_id="task-l",
                          decide="d1", tree={"tree_id": "task-l",
                                             "node_id": "n1"})
                for i, t in enumerate((0.0, 0.0, 0.7))]
        return _rows_view([f.result(WAIT) for f in futs])
    finally:
        cb.close()


def _tier_rounds(eng):
    eng.attach_tier(host_mb=64)
    p = enc(SYS + "hibernate me")
    r1 = eng.generate([p], temperature=0.0, max_new_tokens=10,
                      session_ids=["h"])
    st = eng.sessions
    with eng._paged_lock, st.lock:
        st._release(st.alloc(st.n_pages - 1))
    assert eng.sessions.tier.has_session("h")
    r2 = eng.generate([p + r1[0].token_ids + enc(" more")],
                      temperature=0.0, max_new_tokens=10, session_ids=["h"])
    assert r2[0].n_cached_tokens > 0
    return _rows_view(r1 + r2)


CASES = {
    "unified": lambda: _engine_rounds(engine(PORT, "unified")),
    "direct": lambda: _engine_rounds(engine(PORT, "direct")),
    "gather": lambda: _engine_rounds(engine(PORT, "gather")),
    "loop": lambda: _loop_rows(engine(PORT, "unified")),
    "speculation": lambda: _loop_rows(engine(PORT, "unified"), True),
    "tiers": lambda: _tier_rounds(engine(PORT, "unified")),
    "tiers_int8": lambda: _tier_rounds(engine(PORT, "unified",
                                              quantize_kv=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_bit_identical_planes_off_on_off(case):
    events = []
    with planes(PORT, False):
        off1 = CASES[case]()
    with planes(PORT, True, events):
        on = CASES[case]()
    with planes(PORT, False):
        off2 = CASES[case]()
    assert on == off1 == off2
    assert events, "the planes recorded nothing while on"


def test_off_builds_no_span(monkeypatch):
    built = []
    init = ttel.Span.__init__

    def counting(self, *a, **kw):
        built.append(a[1] if len(a) > 1 else kw.get("name"))
        init(self, *a, **kw)

    monkeypatch.setattr(ttel.Span, "__init__", counting)
    with planes(PORT, False):
        for tier in ("unified", "direct", "gather"):
            _engine_rounds(engine(PORT, tier))
        _loop_rows(engine(PORT, "unified"))
        _tier_rounds(engine(PORT, "unified"))
    assert built == []
    with planes(PORT, True):
        _engine_rounds(engine(PORT, "unified"))
    assert "generate.first_shape_compile" in built


# ---------------------------------------------------------------------------
# Parity with the JAX package over the same serving calls
# ---------------------------------------------------------------------------


def _family_state(pkg):
    """{(metric, label key): value} of counters, and histogram counts, of
    the serving families."""
    out = {}
    for m in list(pkg.tel.METRICS._metrics.values()):
        if not m.name.startswith(FAMILIES):
            continue
        with m._lock:
            cells = dict(m._cells)
        for key, c in cells.items():
            if isinstance(m, pkg.tel.Counter):
                out[(m.name, key)] = c
            elif isinstance(m, pkg.tel.Histogram):
                out[(m.name + "_count", key)] = c.count
    return out


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


FLIGHT_TIMES = ("ts", "ms", "waited_ms", "error", "path")


def _flights_after(pkg, marker):
    ev = pkg.fr.FLIGHT.snapshot()
    i = max(j for j, e in enumerate(ev)
            if e["kind"] == "marker" and e.get("m") == marker)
    return [{k: v for k, v in e.items() if k not in FLIGHT_TIMES}
            for e in ev[i + 1:] if e["kind"] != "span"]


def _serving_script(pkg):
    """Tiered int8 rounds with a hibernate and restore, a prefix-sharing
    second session, and the QoS loop with a self-draft speculator and a
    row whose deadline passed in the queue."""
    eng = engine(pkg, "unified", quantize_kv=True)
    eng.attach_tier(host_mb=64)
    p = enc(SYS + "hibernate me")
    r1 = eng.generate([p], temperature=0.0, max_new_tokens=10,
                      session_ids=["h"])
    st = eng.sessions
    with eng._paged_lock, st.lock:
        st._release(st.alloc(st.n_pages - 1))
    r2 = eng.generate([p + r1[0].token_ids], temperature=0.0,
                      max_new_tokens=10, session_ids=["h"])
    r3 = eng.generate([p + enc(" other")], temperature=0.0,
                      max_new_tokens=6, session_ids=["h2"])
    eng2 = engine(pkg, "unified")
    spec = pkg.spec.BatchedSpeculator(eng2, eng2, k=4)
    adm = pkg.adm.AdmissionController(pkg.adm.AdmissionConfig())
    cb = pkg.sch.ContinuousBatcher(
        eng2, chunk=4, speculator=spec, admission=adm,
        policy=pkg.qos.WeightedFairPolicy(model=eng2.cfg.name))
    try:
        futs = [cb.submit(enc(SYS + f"row {i}"), temperature=0.0,
                          max_new_tokens=12, priority=i % 3,
                          tenant="acme", deadline_s=(0.0 if i == 2
                                                     else None))
                for i in range(3)]
        rows = []
        for f in futs:
            try:
                rows.append(f.result(WAIT).token_ids)
            except Exception as e:        # noqa: BLE001 — the dead row
                rows.append(type(e).__name__)
    finally:
        cb.close()
    return ([g.token_ids for g in r1 + r2 + r3], rows,
            eng.padding_stats(), eng2.padding_stats())


def test_serving_counters_flight_records_and_padding_equal_jax():
    out = {}
    for pkg in PKGS:
        before = _family_state(pkg)
        pkg.fr.FLIGHT.record("marker", m="serving")
        res = _serving_script(pkg)
        out[pkg.name] = (res, _delta(before, _family_state(pkg)),
                         _flights_after(pkg, "serving"))
    (jres, jdelta, jfl), (tres, tdelta, tfl) = out["jax"], out["port"]
    assert tres == jres
    assert tdelta == jdelta
    assert tfl == jfl
    fams = {name.split("_")[1] for name, _ in tdelta}
    assert {"kv", "sched", "spec", "qos", "prefix", "quant"} <= fams
    kinds = {e["kind"] for e in tfl}
    assert {"kv_demote", "kv_restore", "sched_admit", "sched_retire",
            "qos_shed"} <= kinds


def _backend(pkg, pool):
    engines = {spec: engine(pkg, "unified", seed=11 + i)
               for i, spec in enumerate(pool)}
    for e in engines.values():
        e.prefix_sharing = False
    if pkg is JAX:
        e0 = engines[pool[0]]
        return jrt.TPUBackend(list(pool), engines=engines,
                              embedder=jemb.EmbeddingEncoder(
                                  e0.cfg, e0.params, e0.tokenizer),
                              overlap=False)
    return trt.TorchBackend(list(pool), device="cpu", engines=engines,
                            overlap=False)


SPAN_DROP = ("ts", "span_id", "parent_id", "duration_ms", "prefill_ms",
             "decode_ms")


def span_view(events):
    """Each span as (name, parent's name, attributes without ids and
    times), sorted: member threads may finish in either order."""
    by_id = {e["span_id"]: e for e in events}
    return sorted(
        (e["name"], by_id[e["parent_id"]]["name"]
         if e["parent_id"] in by_id else None,
         tuple(sorted((k, v) for k, v in e.items()
                      if k not in SPAN_DROP)))
        for e in events)


def test_decide_span_tree_and_audit_task_id_equal_jax(monkeypatch):
    pool = ["xla:tiny", "xla:tiny-gemma"]
    for mod in (jce, tce):
        monkeypatch.setattr(mod, "temperature_for_round",
                            lambda *a, **kw: 0.0)
    out = {}
    for pkg in PKGS:
        b = _backend(pkg, pool)
        events = []
        try:
            eng = pkg.ce.ConsensusEngine(b, pkg.ce.ConsensusConfig(
                model_pool=pool, session_key="agent-1", max_tokens=24,
                allowed_actions={"wait", "orient"}))
            with planes(pkg, True, events):
                with pkg.tel.TRACER.span("agent.decide_tick",
                                         trace_id="task-42",
                                         agent_id="agent-1"):
                    outcome = eng.decide(
                        {m: [{"role": "user", "content": "next step?"}]
                         for m in pool})
        finally:
            b.close()
        assert outcome.audit["task_id"] == "task-42"
        mine = [e for e in events if e.get("trace_id") == "task-42"]
        out[pkg.name] = (span_view(mine), outcome.status,
                         outcome.rounds_used,
                         {m: b.engines[m].padding_stats() for m in pool})
    assert out["port"] == out["jax"]
    names = [s[0] for s in out["port"][0]]
    for n in ("agent.decide_tick", "consensus.decide", "consensus.round",
              "backend.member", "generate.prefill", "generate.decode"):
        assert n in names, n
    parents = {(s[0], s[1]) for s in out["port"][0]}
    assert {("consensus.decide", "agent.decide_tick"),
            ("consensus.round", "consensus.decide"),
            ("backend.member", "consensus.round"),
            ("generate.prefill", "backend.member")} <= parents


def test_query_results_carry_chip_ms_and_ledger_keys():
    b = _backend(PORT, [MEMBER])
    try:
        r = b.query([trt.QueryRequest(
            MEMBER, [{"role": "user", "content": "charge me"}],
            temperature=0.0, max_tokens=12, session_id="s-c",
            tenant="acme", priority=0, task_id="t-9", decide="d-3")])[0]
    finally:
        b.close()
    assert r.ok and r.chip_ms > 0
    cells = tco.ledger_for(b.engines[MEMBER].cfg.name).cells()
    assert ("acme", "interactive", "t-9", "d-3", "prefill") in cells
