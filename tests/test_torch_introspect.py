"""The port's liveness & hotspot plane (quoracle_tpu_torch/infra/
introspect.py, infra/locks.py) against the JAX package's, on the CPU.

The scenarios of tests/test_introspect.py run through both packages with
scripted time (explicit clocks, events, no sleeps): wait clocks book the
exact remainder and trim skew the same way, heartbeats advance and gate
off, the stall detector trips within two intervals of a frozen source and
bundles stacks and lock holders into a deterministic-id incident, the
contended-lock hook times blocking waits only, the profiler folds and
rotates windows, and ``torch_trace_window`` arms ``torch.profiler``. On
the serving path a row held up by a named lock another thread holds books
a ``lock`` wait in both packages, every retired row's waits sum exactly
to its wall, and temperature-0 outputs are the same with the plane on and
off.
"""

import json
import os
import threading
import types

import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.analysis import lockdep as jlockdep
from quoracle_tpu.infra import costobs as jco
from quoracle_tpu.infra import fleetobs as jfleet
from quoracle_tpu.infra import flightrec as jfr
from quoracle_tpu.infra import introspect as jintro
from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import scheduler as jsch
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu_torch.infra import costobs as tco
from quoracle_tpu_torch.infra import fleetobs as tfleet
from quoracle_tpu_torch.infra import flightrec as tfr
from quoracle_tpu_torch.infra import introspect as tintro
from quoracle_tpu_torch.infra import locks as tlocks
from quoracle_tpu_torch.infra import telemetry as ttel
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import scheduler as tsch
from quoracle_tpu_torch.models import tokenizer as ttok

torch.set_num_threads(1)

JAX = types.SimpleNamespace(name="jax", intro=jintro, fr=jfr, fleet=jfleet,
                            co=jco, tel=jtel, gen=jgen, sch=jsch,
                            locks=jlockdep)
PORT = types.SimpleNamespace(name="port", intro=tintro, fr=tfr,
                             fleet=tfleet, co=tco, tel=ttel, gen=tgen,
                             sch=tsch, locks=tlocks)
PKGS = (JAX, PORT)
MEMBER = "xla:tiny"
WAIT = 120.0


@pytest.fixture(autouse=True)
def _clean_plane():
    for p in PKGS:
        p.intro.reset()
        p.intro.enable()
    yield
    for p in PKGS:
        p.intro.reset()
        p.intro.enable()


def both(script):
    out = {p.name: script(p) for p in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def engine(pkg):
    jcfg, tcfg = both_configs("tiny")
    jp, tp = shared_params("tiny", seed=6)
    kw = dict(max_seq=256, prompt_buckets=(32, 64, 128))
    if pkg is JAX:
        return jgen.GenerateEngine(jcfg, jp, jtok.get_tokenizer(MEMBER), **kw)
    return tgen.GenerateEngine(tcfg, tp, ttok.get_tokenizer(MEMBER),
                               device="cpu", **kw)


def enc(text):
    return ttok.get_tokenizer(MEMBER).encode(text, add_bos=True)


def test_wait_clock_books_exact_remainder():
    def script(p):
        c = p.intro.WaitClock(t0_ns=0)
        c.note("queue", 300)
        c.note("dispatch", 500)
        c2 = p.intro.WaitClock(t0_ns=0)
        c2.note("lock", -5)
        c2.note("wire", 0)
        c2.note("kv_restore", 10)
        c2.note("kv_restore", 15)
        return c.close(t_end_ns=1000), c2.close(t_end_ns=100)
    a, b = both(script)
    assert a["waits_ns"]["other"] == 200 and a["skew_ns"] == 0
    assert b["waits_ns"] == {"kv_restore": 25, "other": 75}


def test_wait_clock_skew_trims_largest_buckets_deterministically():
    def script(p):
        c = p.intro.WaitClock(t0_ns=0)
        c.note("queue", 900)
        c.note("dispatch", 500)
        return c.close(t_end_ns=1000)
    a = both(script)
    assert a["skew_ns"] == 400
    assert a["waits_ns"] == {"queue": 500, "dispatch": 500, "other": 0}


def test_record_row_waits_aggregates_and_flags_skew():
    def script(p):
        c = p.intro.WaitClock(t0_ns=0)
        c.note("queue", 2_000_000)
        p.intro.record_row_waits("m", c.close(t_end_ns=5_000_000))
        s = p.intro.WaitClock(t0_ns=0)
        s.note("dispatch", 9_000_000)
        p.intro.record_row_waits("m", s.close(t_end_ns=1_000_000))
        skew = [{k: v for k, v in e.items() if k != "ts"}
                for e in p.fr.FLIGHT.snapshot() if e["kind"] == "wait_skew"]
        return p.intro.wait_totals(), skew[-1]
    tot, skew = both(script)
    assert tot["m"]["rows"] == 2 and skew["skew_ns"] == 8_000_000


def test_heartbeats_advance_and_gate_off():
    def script(p):
        p.intro.beat("x.stage")
        p.intro.beat("x.stage", 5)
        n = p.intro.heartbeat_count("x.stage")
        p.intro.disable()
        p.intro.beat("x.stage")
        hook_off = p.locks.LOCK_WAIT_HOOK is None
        p.intro.enable()
        return (n, p.intro.heartbeat_count("x.stage"), hook_off,
                p.locks.LOCK_WAIT_HOOK is p.intro._lock_wait)
    assert both(script) == (6, 6, True, True)


def test_stall_detector_trips_within_two_intervals(monkeypatch, tmp_path):
    def script(p):
        monkeypatch.setenv("QUORACLE_INCIDENT_DIR", str(tmp_path / p.name))
        det = p.intro.StallDetector(interval_s=1.0)
        prog = {"n": 7, "active": True}
        det.watch("mock.stage", lambda: (prog["active"], prog["n"]))
        trips = [det.check(now=0.0), det.check(now=1.9),
                 det.check(now=2.0), det.check(now=5.0)]
        b = det.last_bundle
        prog["n"] = 8
        trips += [det.check(now=6.0), det.check(now=8.5)]
        prog["active"] = False
        trips.append(det.check(now=99.0))
        stalls = [i for i in p.fleet.INCIDENTS.list()
                  if i["kind"] == "stall" and i["key"] == "mock.stage"]
        ids_ok = all(i["incident_id"] == p.fleet.IncidentManager.
                     _incident_id("stall", i["key"], i["occurrence"])
                     for i in stalls)
        att = [f for f in stalls[0]["files"]
               if f.startswith("introspect-stall-")]
        with open(os.path.join(stalls[0]["path"], att[0])) as f:
            dump = json.load(f)
        me = threading.current_thread().name
        return (trips, det.trips, b["source"], b["stalled_s"],
                any(k.startswith(f"{me}:") for k in b["stacks"]),
                b["sampler_held"], len(stalls), ids_ok,
                sorted(k for k in dump if k not in ("holders",)))
    out = both(script)
    assert out[0] == [[], [], ["mock.stage"], [], [], ["mock.stage"], []]
    assert out[1] == 2 and out[5] == [] and out[6] == 2 and out[7]


def test_lock_holders_name_the_holding_thread():
    lk = tlocks.named_lock("quality")
    seen, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            seen.set()
            release.wait(timeout=WAIT)

    t = threading.Thread(target=holder, name="holder-thread", daemon=True)
    t.start()
    assert seen.wait(timeout=WAIT)
    try:
        mine = [v for k, v in tlocks.holders().items()
                if k.startswith("holder-thread:")]
        assert mine == [[("quality", 1)]]
    finally:
        release.set()
        t.join(timeout=WAIT)
    assert not any(k.startswith("holder-thread:") for k in tlocks.holders())


class _BlockSignal:
    """Stands in for a named lock's raw lock: signals when a thread
    starts a BLOCKING acquire, so the holder releases only after the
    waiter is waiting (no sleep)."""

    def __init__(self, base):
        self.base = base
        self.blocking = threading.Event()

    def acquire(self, blocking=True, timeout=-1):
        if blocking and not self.base.locked():
            return self.base.acquire(blocking, timeout)
        if blocking:
            self.blocking.set()
        return self.base.acquire(blocking, timeout)

    def release(self):
        self.base.release()


def _hold_until_contended(lock, shim):
    """Thread that takes ``lock`` and releases it once another thread
    blocks on it."""
    entered = threading.Event()

    def holder():
        with lock:
            entered.set()
            shim.blocking.wait(timeout=WAIT)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert entered.wait(timeout=WAIT)
    return t


def test_lock_wait_hook_times_contended_acquires_only():
    def script(p):
        lk = p.locks.named_lock("quality")
        shim = lk._base = _BlockSignal(lk._base)
        p.intro.drain_inner_waits()
        with lk:
            pass
        uncontended = p.intro.drain_inner_waits()
        t = _hold_until_contended(lk, shim)
        with lk:
            pass
        t.join(timeout=WAIT)
        _, lock_ns = p.intro.drain_inner_waits()
        return uncontended, lock_ns > 0, p.intro.drain_inner_waits()
    assert both(script) == ((0, 0), True, (0, 0))


def test_scripted_contention_books_lock_wait_in_both_packages():
    """A loop row whose engine step must take the engine's paged lock
    while another thread holds it: the row's wait decomposition carries
    a non-zero ``lock`` wait in both packages, and the same wait states;
    its waits sum exactly to its wall."""
    def script(p):
        eng = engine(p)
        shim = eng._paged_lock._base = _BlockSignal(eng._paged_lock._base)
        spans = []
        p.tel.TRACER.add_sink(spans.append)
        cb = p.sch.ContinuousBatcher(eng, chunk=8)
        try:
            holder = _hold_until_contended(eng._paged_lock, shim)
            got = cb.submit(enc("user: contended row"), temperature=0.0,
                            max_new_tokens=8).result(WAIT)
            holder.join(timeout=WAIT)
        finally:
            cb.close()
            p.tel.TRACER.remove_sink(spans.append)
        dec = [s for s in spans if s["name"] == "sched.decode"]
        assert len(dec) == 1
        waits = dec[0]["waits_ns"]
        assert sum(waits.values()) == dec[0]["wall_ns"]
        assert waits["lock"] > 0
        return got.token_ids, sorted(waits)
    both(script)


def test_profiler_folds_collapsed_stacks_and_rotates():
    p = tintro.WallProfiler()
    p.WINDOW_S = 0.0
    p._t_started = 0.0
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="prof-target", daemon=True)
    t.start()
    try:
        assert p.sample_once() >= 1
        assert p.sample_once() >= 1
    finally:
        stop.set()
        t.join(timeout=WAIT)
    snap = p.snapshot()
    assert snap["samples"] == 2 and snap["windows"]
    assert any(e["kind"] == "profile_window" for e in tfr.FLIGHT.snapshot())
    assert 0.0 <= snap["overhead_frac"] < 1.0


def test_profiler_disabled_samples_nothing():
    tintro.disable()
    p = tintro.WallProfiler()
    assert p.sample_once() == 0
    p.start()
    assert p._thread is None


def test_torch_trace_window_arms_and_writes_under_logdir(tmp_path):
    with tintro.torch_trace_window(str(tmp_path)) as armed:
        torch.ones(4) @ torch.ones(4)
    assert armed is True
    assert any(f.startswith("torch-trace-") for f in os.listdir(tmp_path))
    tintro.disable()
    with tintro.torch_trace_window(str(tmp_path / "off")) as armed:
        assert armed is False
    assert not (tmp_path / "off").exists()


def test_engine_temp0_bit_equal_introspect_on_off():
    eng = engine(PORT)
    p = enc("user: tell me about the liveness plane")
    on_g = eng.generate([p], temperature=0.0, max_new_tokens=24)[0]
    on_c = eng.generate([p], temperature=0.0, max_new_tokens=32,
                        constrain_json=[True])[0]
    assert tintro.heartbeat_count(f"engine.tokens:{eng.cfg.name}") > 0
    tintro.disable()
    off_g = eng.generate([p], temperature=0.0, max_new_tokens=24)[0]
    off_c = eng.generate([p], temperature=0.0, max_new_tokens=32,
                         constrain_json=[True])[0]
    assert (off_g.token_ids, off_c.token_ids) == \
        (on_g.token_ids, on_c.token_ids)


@pytest.fixture
def span_ring():
    """The port's process-wide span ring as a tracer sink for one test,
    taken off after unless it was on before (a later test in the same
    process may assert that the tracer has no sink)."""
    was_on = tfleet._ring_installed
    tfleet.ensure_ring()
    try:
        yield tfleet.SPANS
    finally:
        if not was_on:
            ttel.TRACER.remove_sink(tfleet.SPANS.record)
            tfleet._ring_installed = False


def test_loop_rows_book_exact_waits_and_heartbeats(span_ring):
    tfleet.SPANS.clear()
    eng = engine(PORT)
    cb = tsch.ContinuousBatcher(eng, chunk=8)
    try:
        on = cb.submit(enc("user: hello liveness plane"), temperature=0.0,
                       max_new_tokens=20).result(WAIT)
    finally:
        cb.close()
    name = eng.cfg.name
    beats = tintro.heartbeats()
    assert beats[f"sched.tick:{name}"] > 0
    assert beats[f"sched.retired:{name}"] == 1
    assert beats[f"engine.tokens:{name}"] > 0
    rows = [s for s in tfleet.SPANS.spans() if s["name"] == "sched.decode"]
    assert rows
    for s in rows:
        assert sum(s["waits_ns"].values()) == s["wall_ns"]
        assert set(s["waits_ns"]) <= set(tintro.WAIT_STATES)
    assert tintro.wait_totals()[name]["rows"] == 1
    tl = tfleet.assemble_timeline(tfleet.SPANS.spans())
    assert tl["waits"]["rows"] == 1 and tl["waits"]["exact"] is True
    tintro.disable()
    cb = tsch.ContinuousBatcher(eng, chunk=8)
    try:
        off = cb.submit(enc("user: hello liveness plane"), temperature=0.0,
                        max_new_tokens=20).result(WAIT)
    finally:
        cb.close()
    assert off.token_ids == on.token_ids


def test_budget_trip_opens_deterministic_incident_with_profile(
        monkeypatch, tmp_path):
    monkeypatch.setenv("QUORACLE_INCIDENT_DIR", str(tmp_path))
    tco.reset()
    tco.enable()
    try:
        tr = tco.BudgetTracker()
        for i in range(40):
            tr.record("acme", "interactive", True, 10.0 + i)
        for i in range(10):
            tr.record("acme", "interactive", False, 60.0 + i)
        burns = [i for i in tfleet.INCIDENTS.list() if i["kind"] == "burn"]
        assert {i["key"] for i in burns} == \
            {"acme:interactive:1h", "acme:interactive:6h"}
        for inc in burns:
            assert inc["incident_id"] == tfleet.IncidentManager._incident_id(
                "burn", inc["key"], inc["occurrence"]) == \
                jfleet.IncidentManager._incident_id(
                    "burn", inc["key"], inc["occurrence"])
            att = [f for f in inc["files"] if f.startswith("introspect-burn-")]
            with open(os.path.join(inc["path"], att[0])) as f:
                dump = json.load(f)
            assert dump["incident_id"] == inc["incident_id"]
            assert "profile" in dump and "stacks" in dump
        tintro.disable()
        tr2 = tco.BudgetTracker()
        for i in range(10):
            tr2.record("zorp", "interactive", False, 60.0 + i)
        assert not [i for i in tfleet.INCIDENTS.list()
                    if i["key"].startswith("zorp:")]
    finally:
        tco.reset()
        tco.enable()


def test_profile_payload_shape_equal():
    def script(p):
        p.intro.beat("x.probe")
        out = p.intro.profile_payload()
        json.dumps(out)
        return (sorted(out), out["enabled"], out["heartbeats"],
                sorted(out["profiler"]), sorted(out["stalls"]))
    both(script)
