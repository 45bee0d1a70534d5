"""The port's resource observability (quoracle_tpu_torch/infra/
resources.py, the flight recorder, the engine's compile ledger) against
the JAX package's, on the CPU.

The scenarios of tests/test_resources.py that need no web server or
runtime: scrape-time collectors, process gauges, the headroom arithmetic,
the compile ledger's hits, misses and storm (on a scripted clock, the same
snapshots in both packages), the engine's bucketed re-calls, the loop's
health stats with the padding counts, the flight recorder's ring,
retention and signal dump, and prefix-cache occupancy. The memory
attribution tags draft engines and the batch-1 speculative decoder's
caches as the JAX test tests/test_spec_serving.py::
test_hbm_attribution_tags_draft_engines_and_spec_caches does, and its
device block names parts that, with ``other``, sum to the used bytes.
"""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.infra import resources as jres
from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import scheduler as jsch
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu_torch.infra import flightrec as tfr
from quoracle_tpu_torch.infra import resources as tres
from quoracle_tpu_torch.infra import telemetry as ttel
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import scheduler as tsch
from quoracle_tpu_torch.models import tokenizer as ttok

torch.set_num_threads(1)

JAX = types.SimpleNamespace(name="jax", gen=jgen, sch=jsch, tok=jtok,
                            tel=jtel)
PORT = types.SimpleNamespace(name="port", gen=tgen, sch=tsch, tok=ttok,
                             tel=ttel)
PKGS = (JAX, PORT)
MEMBER = "xla:tiny"


def both(script):
    out = {p.name: script(p) for p in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def engine(pkg, **kw):
    jcfg, tcfg = both_configs("tiny")
    jp, tp = shared_params("tiny", seed=8)
    kw = dict(max_seq=256, prompt_buckets=(32, 64, 128), **kw)
    if pkg is JAX:
        return jgen.GenerateEngine(jcfg, jp, jtok.get_tokenizer(MEMBER), **kw)
    return tgen.GenerateEngine(tcfg, tp, ttok.get_tokenizer(MEMBER),
                               device="cpu", **kw)


def enc(text):
    return ttok.get_tokenizer(MEMBER).encode(text, add_bos=True)


class Clock:
    """A scripted ``time`` for a module: monotonic() and time() read
    ``t``, which the test advances."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


def test_collector_runs_at_scrape_time_and_exceptions_swallowed():
    reg = ttel.MetricsRegistry()
    calls = []

    def good():
        calls.append(1)
        reg.gauge("live_value").set(len(calls))

    reg.register_collector(lambda: 1 / 0)
    reg.register_collector(good)
    assert reg.snapshot()["live_value"]["series"][""] == 1
    assert "live_value 2" in reg.render_prometheus()
    reg.remove_collector(good)
    reg.snapshot()
    assert len(calls) == 2


def test_process_gauges_and_process_stats():
    snap = ttel.METRICS.snapshot()
    for name in ("quoracle_process_uptime_s", "quoracle_process_threads"):
        assert list(snap[name]["series"].values())[0] > 0
    st = tres.process_stats()
    assert set(st) == set(jres.process_stats())
    assert st["pid"] == os.getpid() and st["threads"] >= 1


def test_device_memory_and_headroom_arithmetic_on_the_cpu():
    assert tres.device_memory_stats() == []
    assert tres.device_used_bytes("cpu") is None
    for devs in ([{"bytes_in_use": 4, "bytes_limit": 16},
                  {"bytes_in_use": 12, "bytes_limit": 16}],
                 [{"bytes_in_use": 4, "bytes_limit": 0}]):
        assert tres.headroom_fraction(devs) == jres.headroom_fraction(devs)


def test_compile_registry_hit_miss_and_storm(monkeypatch):
    def script(p):
        clock = Clock()
        monkeypatch.setattr(p.gen, "time", clock)
        reg = p.gen.CompileRegistry("tmodel", window_s=0.2, threshold=3)
        seq = [reg.record((1, 32, 96, 64, False), 1500.0),
               reg.record((1, 32, 96, 64, False), 12.0),
               reg.record((2, 64, 192, 64, False), 1600.0)]
        storm0 = reg.storm
        seq.append(reg.record((4, 128, 256, 128, True), 1700.0))
        snap = reg.snapshot()
        clock.t += 0.25
        reg.refresh()
        shapes = [{k: v for k, v in e.items() if k != "ts"}
                  for e in snap.pop("shapes")]
        return seq, storm0, snap, shapes, reg.storm, reg.storms_total
    seq, storm0, snap, shapes, storm, trips = both(script)
    assert seq == [True, False, True, True] and not storm0
    assert snap["storm"] and snap["hit_rate"] == 0.25
    assert shapes[0]["compile_ms"] == 1700.0
    assert not storm and trips == 1
    assert ttel.COMPILE_STORM.value(model="tmodel") == 0.0


def test_engine_compile_registry_bucketed_recall_is_hit():
    def script(p):
        eng = engine(p)
        out = []
        for text in ("user: hi", "user: yo", "user: " + "x" * 60):
            eng.generate([enc(text)], temperature=0.0, max_new_tokens=8)
            out.append((eng.compiles.misses, eng.compiles.hits))
        snap = eng.compiles.snapshot()
        return out, snap["n_shapes"], sorted(
            e["shape"] for e in snap["shapes"])
    out, n, _ = both(script)
    assert out == [(1, 0), (1, 1), (2, 1)] and n == 2


def test_scheduler_health_stats_with_padding_equal():
    def script(p):
        eng = engine(p)
        eng.unified_min_tokens = 0
        h = p.tel.SCHED_ADMIT_WAIT_MS
        n0 = h.counts(model="tiny")[2]
        cb = p.sch.ContinuousBatcher(eng, chunk=4)
        try:
            for f in [cb.submit(enc(f"user: job {i}"), temperature=0.0,
                                max_new_tokens=6) for i in range(3)]:
                f.result(120)
        finally:
            cb.close()
        s = cb.stats()
        return (s["retired"], s["failed"], s["queued"], s["closed"],
                cb.progress()[0], h.counts(model="tiny")[2] - n0,
                s["padding"])
    out = both(script)
    assert out[:6] == (3, 0, 0, True, False, 3)
    assert out[6]["real_tokens"] > 0 and out[6]["ticks"] >= 1


def test_flight_recorder_ring_bound_retention_and_status(tmp_path):
    fr = tfr.FlightRecorder(capacity=8, directory=str(tmp_path),
                            retention=3)
    for i in range(20):
        fr.record("tick", i=i)
    assert [e["i"] for e in fr.snapshot()] == list(range(12, 20))
    paths = [fr.dump(reason=f"r{i}") for i in range(5)]
    remaining = sorted(f for f in os.listdir(tmp_path)
                       if f.startswith("flightrec-"))
    assert len(remaining) == 3
    assert os.path.basename(paths[-1]) in remaining
    st = fr.status()
    assert st["dumps"] == 5 and st["last_dump"] == paths[-1]
    with open(paths[-1]) as f:
        assert json.load(f)["n_events"] == 8


def test_flight_dir_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("QUORACLE_FLIGHTREC_DIR", str(tmp_path / "fr"))
    fr = tfr.FlightRecorder()
    fr.record("tick")
    path = fr.dump(reason="env")
    assert os.path.dirname(path) == str(tmp_path / "fr")


def test_flightrec_dumps_on_sigterm(tmp_path):
    import signal
    code = (
        "import os, signal\n"
        "from quoracle_tpu_torch.infra.flightrec import FlightRecorder\n"
        f"fr = FlightRecorder(directory={str(tmp_path)!r})\n"
        "fr.install()\n"
        "fr.record('resource_sample', marker='pre-sigterm')\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "raise SystemExit('signal did not terminate the process')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == -signal.SIGTERM, proc.stderr[-500:]
    dumps = [f for f in os.listdir(tmp_path) if "signal-SIGTERM" in f]
    with open(os.path.join(tmp_path, dumps[0])) as f:
        dump = json.load(f)
    kinds = [e["kind"] for e in dump["events"]]
    assert "signal_dump" in kinds and "resource_sample" in kinds


def test_prefix_cache_occupancy_counts():
    st = tgen.SessionStore(max_tokens=tgen.PAGE * 8)
    toks = list(range(tgen.PAGE * 2))
    pages = st.alloc(2)
    st.insert_prefix(toks, pages)
    with st.lock:
        assert st.prefix_cache.occupancy() == {
            "resident_pages": 2, "referenced_pages": 2,
            "evictable_leaf_pages": 0}
    st.release(pages)
    with st.lock:
        assert st.prefix_cache.occupancy() == {
            "resident_pages": 2, "referenced_pages": 0,
            "evictable_leaf_pages": 1}


@pytest.fixture(scope="module")
def spec_backend():
    """A baton-mode backend whose member has a batch-1 speculative
    decoder over a different draft, after one sessioned row through the
    decoder and one nucleus-sampled row (which the decoder does not take)
    through the engine's page pool."""
    b = trt.TorchBackend([MEMBER], device="cpu",
                         draft_map={MEMBER: "xla:tiny-gemma"})
    for sid, top_p in (("hbm1", 1.0), ("hbm2", 0.9)):
        r = b.query([trt.QueryRequest(
            MEMBER, [{"role": "user", "content": "attribute me"}],
            temperature=0.5, top_p=top_p, max_tokens=8,
            session_id=sid)])[0]
        assert r.ok, r.error
    yield b
    b.close()


def test_hbm_attribution_tags_draft_engines_and_spec_caches(spec_backend):
    att = tres.hbm_attribution(spec_backend)
    m = att["members"]
    assert m[MEMBER]["role"] == "member"
    assert m["xla:tiny-gemma"]["role"] == "draft"
    assert m["xla:tiny-gemma"]["draft_for"] == MEMBER
    assert m["xla:tiny-gemma"]["params_bytes"] > 0
    assert m[MEMBER]["spec_cache_bytes"] > 0
    assert m[MEMBER]["spec_cache_sessions"] == 1
    assert att["totals"]["draft_params_bytes"] == \
        m["xla:tiny-gemma"]["params_bytes"]
    assert att["totals"]["spec_cache_bytes"] == m[MEMBER]["spec_cache_bytes"]
    assert att["device"] is None             # no card: no used bytes
    assert att["embedder"]["params_bytes"] == 0   # shares pool[0]'s weights


def test_device_block_parts_and_other_sum_to_used(spec_backend,
                                                  monkeypatch):
    def used(n):
        monkeypatch.setattr(tres, "device_used_bytes", lambda dev: n)
        return tres.hbm_attribution(spec_backend)["device"]

    dev = used(10 ** 12)
    named = dev["parts"]
    assert set(named) == {"params", "draft_params", "kv_pool",
                          "spec_cache"}
    assert all(v > 0 for v in named.values())
    assert sum(named.values()) + dev["other"] == dev["used_bytes"]
    assert dev["consistent"] and dev["other"] >= 0
    # a draft's weights and its pool count once, as do shared storages
    assert named["draft_params"] == spec_backend.engines[
        "xla:tiny-gemma"]._raw_param_bytes
    short = used(sum(named.values()) - 1)
    assert short["other"] == 0 and not short["consistent"]


def test_resource_collector_feeds_gauges_and_flight(spec_backend):
    coll = tres.ResourceCollector(spec_backend, min_sample_gap_s=0.0)
    ttel.METRICS.register_collector(coll)
    try:
        text = ttel.METRICS.render_prometheus()
    finally:
        ttel.METRICS.remove_collector(coll)
    assert 'quoracle_hbm_component_bytes{component="params",' \
           'model="xla:tiny"}' in text
    assert 'component="spec_cache"' in text
    assert "quoracle_hbm_headroom_ratio -1" in text
    sample = [e for e in tfr.FLIGHT.snapshot()
              if e["kind"] == "resource_sample"][-1]
    assert sample["members"][MEMBER]["sessions"] == 1
