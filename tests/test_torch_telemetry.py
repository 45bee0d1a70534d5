"""The port's telemetry (quoracle_tpu_torch/infra/telemetry.py) against the
JAX package's, on the CPU.

* The registry: every instrument the JAX module defines exists in the
  port's module under the same attribute, metric name, type, help text and
  buckets (one case per instrument).
* The exposition: the same scripted observations, label sets included,
  render the same Prometheus text and the same federation state
  (``export_state``) in both packages.
* The tracer: the same scripted span program (nested, retroactive, across
  a thread hop, with an error) gives the same span trees, ids and times
  dropped.
* The JAX module's own scenarios: quantiles against a sorted oracle,
  concurrent writers, get-or-create, sink exceptions, the merge.
"""

import random
import threading

import pytest

from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu_torch.infra import telemetry as ttel

PKGS = {"jax": jtel, "port": ttel}


def _instruments(mod):
    return {k: v for k, v in vars(mod).items()
            if isinstance(v, mod._Metric)}


JAX_INSTRUMENTS = sorted(_instruments(jtel))


def test_port_defines_no_instrument_the_jax_module_lacks():
    assert sorted(_instruments(ttel)) == JAX_INSTRUMENTS
    assert len(JAX_INSTRUMENTS) > 130


@pytest.mark.parametrize("attr", JAX_INSTRUMENTS)
def test_instrument_matches_the_jax_module(attr):
    j, t = getattr(jtel, attr), getattr(ttel, attr)
    assert (t.name, t.kind, t.help) == (j.name, j.kind, j.help)
    assert getattr(t, "buckets", None) == getattr(j, "buckets", None)
    # registered in the process-wide registry under its name
    assert ttel.METRICS._metrics[t.name] is t


def _script(mod):
    """Fresh registry of ``mod``: every module instrument re-registered
    under its own definition, then the same observations on each."""
    reg = mod.MetricsRegistry()
    rng = random.Random(11)
    for attr in JAX_INSTRUMENTS:
        m = getattr(mod, attr)
        if isinstance(m, mod.Histogram):
            h = reg.histogram(m.name, m.help, buckets=m.buckets)
            for i in range(5):
                h.observe(rng.choice(m.buckets) * (0.5 + i / 7),
                          model=f"m{i % 2}", stage="decode")
        elif isinstance(m, mod.Counter):
            c = reg.counter(m.name, m.help)
            c.inc(rng.randint(1, 9), model="m0", status='x"y\n')
            c.inc(2.5)
        else:
            reg.gauge(m.name, m.help).set(rng.random(), model="m1")
    return reg


def test_exposition_and_state_equal_after_the_same_observations():
    regs = {k: _script(m) for k, m in PKGS.items()}
    assert regs["port"].render_prometheus() == \
        regs["jax"].render_prometheus()
    assert regs["port"].export_state() == regs["jax"].export_state()
    assert regs["port"].snapshot() == regs["jax"].snapshot()


def test_process_collector_gauges_in_both_registries():
    for mod in PKGS.values():
        text = mod.METRICS.render_prometheus()
        assert "quoracle_process_threads " in text
        assert "quoracle_process_uptime_s " in text
    assert (ttel.open_fd_count() is None) == (jtel.open_fd_count() is None)


def _span_program(mod):
    """A scripted trace: root → child (with an error) → retroactive emit,
    and a thread hop that rebinds the root; returns the finished events."""
    tracer = mod.Tracer()
    got = []
    tracer.add_sink(got.append)
    with tracer.span("root", trace_id="t-1", agent_id="a") as root:
        parent = tracer.current()
        try:
            with tracer.span("child", round=1):
                tracer.emit("retro", 12.5, phase="prefill", model="m")
                raise KeyError("boom")
        except KeyError:
            pass

        def worker():
            with tracer.use(parent):
                with tracer.span("hop", model="m") as sp:
                    sp.attrs.update(n_rows=3)
            assert tracer.current() is None

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        root.attrs.update(status="ok")
    tracer.emit("orphan", 1.0, trace_id="t-2")
    assert tracer.active()
    tracer.remove_sink(got.append)
    assert not tracer.active()
    return got


def span_tree(events):
    """Events with ids replaced by their position and times dropped."""
    idx = {e["span_id"]: i for i, e in enumerate(events)}
    out = []
    for e in events:
        d = {k: v for k, v in e.items()
             if k not in ("ts", "span_id", "duration_ms")}
        d["parent_id"] = idx.get(e["parent_id"], e["parent_id"])
        out.append(d)
    return out


def test_span_trees_equal_for_the_same_program():
    trees = {k: span_tree(_span_program(m)) for k, m in PKGS.items()}
    assert trees["port"] == trees["jax"]
    names = [e["name"] for e in trees["port"]]
    assert names == ["retro", "child", "hop", "root", "orphan"]
    child = trees["port"][1]
    assert child["error"] == "KeyError('boom')"
    assert trees["port"][2]["parent_id"] == 3      # the hop → root


def test_retroactive_emit_keeps_its_duration_and_start():
    for mod in PKGS.values():
        tracer = mod.Tracer()
        got = []
        tracer.add_sink(got.append)
        tracer.emit("x", 7.25, ts=100.0, trace_id="t")
        assert got[0]["duration_ms"] == 7.25 and got[0]["ts"] == 100.0


def _oracle(samples, p):
    s = sorted(samples)
    return s[min(len(s) - 1, int(p * len(s)))]


def test_histogram_percentiles_match_sorted_oracle_and_jax():
    rng = random.Random(7)
    samples = [rng.lognormvariate(3.0, 1.2) for _ in range(5000)]
    ps = {}
    for k, mod in PKGS.items():
        h = mod.Histogram("t_ms")
        for v in samples:
            h.observe(v)
        ps[k] = h.percentiles((0.50, 0.95, 0.99))
        _, s, n = h.counts()
        assert n == len(samples)
    assert ps["port"] == ps["jax"]
    for p, est in ps["port"].items():
        exact = _oracle(samples, p)
        assert exact / 2.2 <= est <= exact * 2.2, (p, est, exact)


@pytest.mark.parametrize("counts,p", [
    ([0, 0, 0, 0], 0.5), ([0, 0, 0, 10], 0.5), ([10, 0, 0, 0], 0.5),
    ([3, 1, 4, 1], 0.95), ([1, 0, 0, 1], 0.5)])
def test_quantile_edge_cases_equal(counts, p):
    bounds = (1.0, 2.0, 4.0)
    assert ttel.quantile(bounds, counts, p) == \
        jtel.quantile(bounds, counts, p)


def test_histogram_concurrent_writers():
    h = ttel.Histogram("t_conc")
    N, T = 5_000, 8

    def work(k):
        for i in range(N):
            h.observe((i % 100) + 0.5, model=f"m{k % 2}")

    threads = [threading.Thread(target=work, args=(k,)) for k in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    agg, _, n = h.counts()
    assert n == N * T == sum(agg)
    assert h.counts(model="m0")[2] == h.counts(model="m1")[2] == N * T // 2


def test_registry_get_or_create_and_type_mismatch():
    reg = ttel.MetricsRegistry()
    c = reg.counter("dup_name")
    assert reg.counter("dup_name") is c
    with pytest.raises(TypeError):
        reg.gauge("dup_name")


def test_sink_exceptions_swallowed():
    tracer = ttel.Tracer()
    tracer.add_sink(lambda e: 1 / 0)
    got = []
    tracer.add_sink(got.append)
    with tracer.span("s", trace_id="t"):
        pass
    assert [e["name"] for e in got] == ["s"]


def test_histogram_merge_equal_and_refuses_mismatched_buckets():
    out = {}
    for k, mod in PKGS.items():
        a = mod.Histogram("m", buckets=(1.0, 2.0, 4.0))
        b = mod.Histogram("m", buckets=(1.0, 2.0, 4.0))
        for v in (0.5, 1.5, 3.0):
            a.observe(v, model="x")
        for v in (3.5, 9.0):
            b.observe(v, model="x")
            b.observe(v)
        a.merge(b)
        out[k] = (a.counts(), a.counts(model="x"),
                  a.percentiles((0.5, 0.99)))
        with pytest.raises(ValueError):
            a.merge(mod.Histogram("m", buckets=(1.0, 3.0)))
    assert out["port"] == out["jax"]
