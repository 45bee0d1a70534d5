"""The port's serving QoS (serving/qos.py, admission.py, slo.py,
infra/telemetry.py, infra/resources.py, and the continuous batcher's use of
them) against the JAX package's, on the CPU.

Each test drives both packages with one scripted sequence and, where time
matters, one scripted clock: ``time`` in both packages' QoS and scheduler
modules is replaced by a clock that moves only when the test says, so
token buckets, aging floors, admit waits and deadlines give the same
numbers on both sides and none of them depends on the host's load.
Decisions, error types and messages, ``retry_after_ms``, ``stats()`` and
``served`` counts must be equal. The instruments are module globals
shared by every batcher of a package, so the tests read deltas. Where a
row must wait behind another, the first ``engine.generate`` is held
(tests/test_torch_scheduler.py ``HeldGenerate``), never a sleep.
"""

import threading
import time
import types

import pytest
import torch

from test_torch_scheduler import (
    JAX, PORT, WAIT, HeldGenerate, _backend, _engine, _wait_for, enc,
)
from quoracle_tpu.infra import resources as jres
from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu.models import scheduler as jsch
from quoracle_tpu.serving import admission as jadm
from quoracle_tpu.serving import qos as jqos
from quoracle_tpu.serving import slo as jslo
from quoracle_tpu_torch.infra import resources as tres
from quoracle_tpu_torch.infra import telemetry as ttel
from quoracle_tpu_torch.models import scheduler as tsch
from quoracle_tpu_torch.serving import admission as tadm
from quoracle_tpu_torch.serving import qos as tqos
from quoracle_tpu_torch.serving import slo as tslo

torch.set_num_threads(1)

for _pkg, _mods in ((JAX, (jqos, jadm, jslo, jtel, jres)),
                    (PORT, (tqos, tadm, tslo, ttel, tres))):
    _pkg.qos, _pkg.adm, _pkg.slo, _pkg.tel, _pkg.res = _mods
PKGS = (JAX, PORT)


class Clock:
    """A monotonic clock that moves only when told to."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    fake = types.SimpleNamespace(
        monotonic=c.monotonic, time=time.time, sleep=time.sleep,
        monotonic_ns=time.monotonic_ns, perf_counter=time.perf_counter)
    for mod in (jqos, jadm, jsch, tqos, tadm, tsch):
        monkeypatch.setattr(mod, "time", fake)
    return c


def both(script):
    """``script(pkg)`` on both packages; equal outputs. Returns the
    port's."""
    out = {pkg.name: script(pkg) for pkg in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def row(clock, priority, age_s=0.0):
    return types.SimpleNamespace(priority=priority,
                                 t_submit=clock.t - age_s)


def outcome(fn):
    """A decision as data: the result, or the reject's type, message,
    retry hint and fields."""
    try:
        return ("ok", int(fn()))
    except Exception as e:              # noqa: BLE001 — compared as data
        d = e.as_dict() if hasattr(e, "as_dict") else {}
        return (type(e).__name__, str(e), d.get("retry_after_ms"),
                d.get("reason"), d.get("tenant"), d.get("priority"))


# ---------------------------------------------------------------------------
# qos.py
# ---------------------------------------------------------------------------


def test_token_bucket_spends_refills_and_reports_retry(clock):
    def script(pkg):
        b = pkg.qos.TokenBucket(rate_per_s=10.0, burst=2.0)
        out = [b.try_acquire(), b.try_acquire(), b.try_acquire()]
        clock.advance(out[-1] + 1e-6)
        out += [b.try_acquire(), b.try_acquire(n=0.5), b.level()]
        clock.advance(1.0)
        out += [b.level(), b.try_acquire(n=3.0)]
        with pytest.raises(ValueError):
            pkg.qos.TokenBucket(rate_per_s=0.0, burst=1.0)
        return out
    out = both(script)
    assert out[:2] == [0.0, 0.0] and 0.0 < out[2] <= 0.1 + 1e-6
    assert out[3] == 0.0 and out[6] == 2.0 and out[7] > 0


def test_drr_shares_and_order_over_1000_admits(clock):
    """With every class backlogged, 1,500 pops: the same order on both
    packages, and shares within a few percent of the 8/4/2/1 weights."""
    n = 1500

    def script(pkg):
        pol = pkg.qos.WeightedFairPolicy(aging_floor_s=1e9)
        for _ in range(n + 8):
            for p in pkg.qos.Priority:
                pol.put(row(clock, p))
        order = [int(pol.pop().priority) for _ in range(n)]
        return (order, {int(k): v for k, v in pol.served.items()},
                pol.qsize(), pol.snapshot())
    order, served, left, _ = both(script)
    assert left == 4 * (n + 8) - n
    total_w = sum(tqos.DEFAULT_WEIGHTS.values())
    for p, w in tqos.DEFAULT_WEIGHTS.items():
        assert abs(served[int(p)] / n - w / total_w) < 0.05, p
    assert served == {p: order.count(p) for p in range(4)}


def test_aging_floor_serves_stale_row_over_higher_class(clock):
    """A BACKGROUND row past the floor preempts fresh INTERACTIVE work,
    then DRR resumes."""
    def script(pkg):
        pol = pkg.qos.WeightedFairPolicy(aging_floor_s=2.0, model="m")
        stale = row(clock, pkg.qos.Priority.BACKGROUND)
        pol.put(stale)
        clock.advance(5.0)
        for _ in range(4):
            pol.put(row(clock, pkg.qos.Priority.INTERACTIVE))
        first = pol.pop()
        snap = pol.snapshot()
        rest = [int(pol.pop().priority) for _ in range(4)]
        return first is stale, snap, rest, pol.aged_served
    stale_first, snap, rest, aged = both(script)
    assert stale_first and aged == 1 and snap["aged_served"] == 1
    assert snap["classes"]["interactive"]["oldest_wait_s"] == 0.0
    assert rest == [0] * 4


def test_policy_drain_fifo_and_priority_for_depth(clock):
    def script(pkg):
        out = []
        for pol in (pkg.qos.FifoPolicy(), pkg.qos.WeightedFairPolicy()):
            rows = [row(clock, p) for p in (3, 0, 2, 1)]
            for r in rows:
                pol.put(r)
            first = pol.pop()
            out.append((rows.index(first), pol.qsize(),
                        [rows.index(r) for r in pol.drain()],
                        pol.qsize(), pol.pop() is None, pol.snapshot()))
        out.append([int(pkg.qos.priority_for_depth(d)) for d in range(-1, 9)])
        out.append([int(pkg.qos.coerce_priority(v)) for v in
                    (None, -3, 0, 2, 9, "x", 1.7)])
        return out
    fifo, wfq, depths, coerced = both(script)
    assert fifo[:2] == (0, 3) and wfq[0] == 1
    assert depths == [1, 1, 2, 2, 3, 3, 3, 3, 3, 3]


# ---------------------------------------------------------------------------
# admission.py
# ---------------------------------------------------------------------------


def test_controller_shed_ladder_bulk_first_then_agent_then_everything(clock):
    script_steps = [(p, d) for d in (9, 10, 19, 20, 39, 40, 55)
                    for p in range(4)]

    def script(pkg):
        ctrl = pkg.adm.AdmissionController(
            pkg.adm.AdmissionConfig(max_queue_depth=10))
        shed0 = pkg.tel.QOS_SHED_TOTAL.total()
        out = [outcome(lambda: ctrl.admit(priority=p, queue_depth=d))
               for p, d in script_steps]
        return (out, ctrl.stats(),
                pkg.tel.QOS_SHED_TOTAL.total() - shed0)
    out, stats, sheds = both(script)
    # below the bound every class is in; at 10 bulk sheds; at 20 AGENT;
    # at 40 everything
    kinds = [o[0] for o in out]
    assert kinds[:4] == ["ok"] * 4
    assert kinds[4:8] == ["ok", "ok", "OverloadedError", "OverloadedError"]
    assert kinds[12:16] == ["ok"] + ["OverloadedError"] * 3
    assert kinds[20:24] == ["OverloadedError"] * 4
    assert all(o[2] > 0 for o in out if o[0] != "ok")
    assert stats["shed"] == sheds == kinds.count("OverloadedError")


def test_controller_rate_limits_tenant_and_clamps_class(clock):
    def script(pkg):
        P = pkg.qos.Priority
        ctrl = pkg.adm.AdmissionController(tenants={
            "bulk": pkg.qos.TenantPolicy(name="bulk", rate_per_s=10.0,
                                         burst=2, max_class=P.BATCH),
            "*": dict(rate_per_s=None, max_class=P.AGENT)})
        out = [outcome(lambda: ctrl.admit(tenant="bulk",
                                          priority=P.INTERACTIVE,
                                          queue_depth=0)),
               outcome(lambda: ctrl.admit(tenant="bulk", priority=P.BATCH,
                                          queue_depth=0)),
               outcome(lambda: ctrl.admit(tenant="bulk", priority=P.BATCH,
                                          queue_depth=0))]
        clock.advance(0.2)
        out.append(outcome(lambda: ctrl.admit(tenant="bulk",
                                              priority=P.AGENT,
                                              queue_depth=0)))
        # an unknown tenant falls to the "*" policy's class floor
        out.append(outcome(lambda: ctrl.admit(tenant="anon",
                                              priority=P.INTERACTIVE,
                                              queue_depth=0)))
        out.append(outcome(lambda: ctrl.admit(
            tenant="anon", deadline_s=clock.t - 0.5, queue_depth=0)))
        return out, ctrl.stats()
    out, stats = both(script)
    assert out[0] == ("ok", 2) and out[1] == ("ok", 2)
    assert out[2][0] == "RateLimitedError" and out[2][2] == 101
    assert out[3] == ("ok", 2) and out[4] == ("ok", 1)
    assert out[5][0] == "DeadlineExceededError" and out[5][2] == 0
    assert stats["shed"] == 2 and stats["admitted"] == 4


def test_controller_sheds_on_low_headroom_bulk_only(clock, monkeypatch):
    """The headroom shed, and the signal snapshot the shed ladder reads,
    with both packages' cost planes off (their budget burn is then {};
    tests/test_torch_costobs.py holds the burn signals equal)."""
    from quoracle_tpu.infra import costobs
    from quoracle_tpu_torch.infra import costobs as tcostobs
    monkeypatch.setattr(costobs._STATE, "enabled", False)
    monkeypatch.setattr(tcostobs._STATE, "enabled", False)

    def script(pkg):
        ctrl = pkg.adm.AdmissionController(
            pkg.adm.AdmissionConfig(min_hbm_headroom=0.05),
            headroom_fn=lambda: 0.01)
        ctrl.refresh_signals(now=clock.t + 10)
        snap = ctrl.signals(now=clock.t + 10).as_dict()
        out = [outcome(lambda: ctrl.admit(priority=p, queue_depth=0))
               for p in range(4)]
        return snap, out, ctrl.hbm_headroom
    snap, out, head = both(script)
    assert head == 0.01 and snap["budget_burn"] == {}
    assert [o[0] for o in out] == ["ok", "ok", "OverloadedError",
                                   "OverloadedError"]
    assert "HBM headroom" in out[2][1]


def test_headroom_signal_is_none_on_the_cpu():
    """No CUDA device: no memory stats and no headroom, so the default
    controller never sheds for memory here (as the JAX CPU backend, which
    reports no limit). The fraction over given stats matches JAX's."""
    assert tres.device_memory_stats() == []
    assert tres.headroom_fraction() is None
    assert tadm.AdmissionController()._default_headroom() is None
    stats = [{"bytes_in_use": 30, "bytes_limit": 100},
             {"bytes_in_use": 5, "bytes_limit": 0},
             {"bytes_in_use": 70, "bytes_limit": 80}]
    assert tres.headroom_fraction(stats) == jres.headroom_fraction(stats)
    assert tres.headroom_fraction([]) is None


def test_escalate_retry_ms_over_a_grid():
    grid = [(b, a, c, s) for b in (0, 1, 250, 1000, 7000)
            for a in (-1, 0, 1, 2, 3, 7, 20, 40) for c in (5000, 60000)
            for s in (0, 1, 17)]
    got = [tadm.escalate_retry_ms(b, a, cap_ms=c, salt=s)
           for b, a, c, s in grid]
    assert got == [jadm.escalate_retry_ms(b, a, cap_ms=c, salt=s)
                   for b, a, c, s in grid]
    # non-decreasing over attempts until the cap, within 1.25x of base
    for b, s in ((250, 0), (1000, 17)):
        seq = [tadm.escalate_retry_ms(b, a, salt=s) for a in range(1, 30)]
        assert seq == sorted(seq) and seq[-1] == tadm.BACKOFF_CAP_MS
        assert b <= seq[0] <= 1.25 * b
    assert tadm.BACKOFF_CAP_MS == jadm.BACKOFF_CAP_MS


# ---------------------------------------------------------------------------
# slo.py
# ---------------------------------------------------------------------------


def test_slo_demotes_bulk_weight_on_interactive_burn_and_recovers():
    def script(pkg):
        P = pkg.qos.Priority
        dem0 = pkg.tel.QOS_DEMOTIONS_TOTAL.total()
        slo = pkg.slo.SLOTracker(targets_ms={P.INTERACTIVE: 100.0})
        out = [slo.weight_multiplier(P.BATCH)]
        for i in range(6):
            slo.observe(P.INTERACTIVE, 500.0)
            out.append((slo.demoted, round(slo.burn(), 9)))
        out.append([slo.weight_multiplier(p) for p in P])
        out.append(pkg.tel.QOS_WEIGHT_MULTIPLIER.value(cls="batch"))
        for _ in range(40):
            slo.observe(P.INTERACTIVE, 10.0)
        slo.observe(P.BATCH, 2000.0)
        out.append([slo.weight_multiplier(p) for p in P])
        return (out, slo.stats(), slo.demotions,
                pkg.tel.QOS_DEMOTIONS_TOTAL.total() - dem0,
                pkg.tel.QOS_WEIGHT_MULTIPLIER.value(cls="batch"))
    out, stats, demotions, delta, mult = both(script)
    assert out[0] == 1.0 and out[3] == (True, out[3][1])
    assert out[7] == [1.0, 1.0, 0.25, 0.25] and out[8] == 0.25
    assert out[9] == [1.0] * 4 and not stats["demoted"]
    assert demotions == delta == 1 and mult == 1.0


def test_slo_demotion_scales_drr_weight_live(clock):
    def script(pkg):
        P = pkg.qos.Priority
        slo = pkg.slo.SLOTracker(targets_ms={P.INTERACTIVE: 100.0})
        pol = pkg.qos.WeightedFairPolicy(aging_floor_s=1e9,
                                         weight_fn=slo.weight_multiplier)
        for _ in range(6):
            slo.observe(P.INTERACTIVE, 500.0)
        for _ in range(200):
            pol.put(row(clock, P.AGENT))
            pol.put(row(clock, P.BATCH))
        return [int(pol.pop().priority) for _ in range(200)]
    order = both(script)
    # undemoted the ratio would be 4:2; demotion (x0.25) pushes it past 6:1
    assert order.count(1) / max(1, order.count(2)) > 6


# ---------------------------------------------------------------------------
# the continuous batcher under QoS
# ---------------------------------------------------------------------------


def test_temp0_equality_qos_on_vs_off():
    """QoS reorders scheduling, never results: one-shot, FIFO-batched and
    weighted-fair-batched greedy decodes give the same tokens, on both
    packages."""
    def script(pkg):
        eng = _engine(pkg)
        p = enc(eng, "user: equality under admission policies")
        want = eng.generate([p], temperature=0.0, max_new_tokens=24)[0]
        out = []
        for policy in (pkg.qos.FifoPolicy(),
                       pkg.qos.WeightedFairPolicy(model="tiny")):
            cb = pkg.sch.ContinuousBatcher(
                eng, chunk=4, policy=policy,
                admission=pkg.adm.AdmissionController(),
                slo=pkg.slo.SLOTracker())
            try:
                got = cb.submit(p, temperature=0.0, max_new_tokens=24,
                                priority=pkg.qos.Priority.INTERACTIVE
                                ).result(WAIT)
            finally:
                cb.close()
            assert got.token_ids == want.token_ids
            out.append((got.token_ids, got.text, cb.slo.stats()["classes"]
                        ["interactive"]["observed"]))
        return out
    both(script)


def _order_script(pkg, clock, weights):
    """max_slots=1: a long BATCH row holds the only slot (its first chunk
    held) while six BATCH rows and then one INTERACTIVE row queue; the
    clock moves 1 s; then the slot frees row by row. Returns the classes
    in the order the policy popped them, the served counts and each
    class's admit-wait delta (count, sum of ms)."""
    eng = _engine(pkg)
    P = pkg.qos.Priority
    pol = pkg.qos.WeightedFairPolicy(weights=weights, aging_floor_s=600.0,
                                     model="tiny")
    popped = []
    pop = pol.pop

    def spy_pop():
        r = pop()
        if r is not None:
            popped.append(int(r.priority))
        return r
    pol.pop = spy_pop
    waits0 = {c: pkg.tel.QOS_ADMIT_WAIT_MS.counts(cls=c)[1:]
              for c in ("interactive", "batch")}
    cb = pkg.sch.ContinuousBatcher(eng, chunk=4, max_slots=1, policy=pol)
    spy = HeldGenerate(eng)
    try:
        long = cb.submit(enc(eng, "user: a long batch job"),
                         temperature=0.0, max_new_tokens=16,
                         priority=P.BATCH)
        assert spy.entered.wait(WAIT)
        futs = [cb.submit(enc(eng, f"user: batch {i}"), temperature=0.0,
                          max_new_tokens=2, priority=P.BATCH)
                for i in range(6)]
        futs.append(cb.submit(enc(eng, "user: a human is waiting"),
                              temperature=0.0, max_new_tokens=2,
                              priority=P.INTERACTIVE))
        assert cb.stats()["queued"] == 7
        clock.advance(1.0)
        spy.release.set()
        texts = [f.result(WAIT).text for f in [long] + futs]
    finally:
        spy.remove()
        cb.close()
    waits = {}
    for c, (s0, n0) in waits0.items():
        _, s1, n1 = pkg.tel.QOS_ADMIT_WAIT_MS.counts(cls=c)
        waits[c] = (n1 - n0, round(s1 - s0, 6))
    return (popped, {int(k): v for k, v in pol.served.items()}, waits,
            texts, cb.stats()["qos"])


@pytest.mark.parametrize("batch_weight", [None, 1.0])
def test_interactive_row_admitted_before_queued_batch_rows(clock,
                                                           batch_weight):
    """The order the weighted-fair queue gives the queued rows once the
    slot frees, on both packages. At BATCH weight 1 the long row's
    admission spent BATCH's whole DRR credit, so the INTERACTIVE row is
    admitted before every queued BATCH row; at the default weight 2 the
    cursor stays parked on BATCH with one credit left, which serves one
    queued BATCH row first (the reference's DRR, credit carried within a
    visit). Admit waits come from the scripted clock: 1 s for every
    queued row."""
    weights = None if batch_weight is None else {2: batch_weight}
    popped, served, waits, _, _ = both(
        lambda pkg: _order_script(pkg, clock, weights))
    if batch_weight is None:
        assert popped == [2, 2, 0, 2, 2, 2, 2, 2]
    else:
        assert popped == [2, 0] + [2] * 6
    assert served == {0: 1, 1: 0, 2: 7, 3: 0}
    assert waits == {"interactive": (1, 1000.0), "batch": (7, 6000.0)}


def test_deadline_expired_row_fails_at_admit_not_decoded(clock):
    """A row whose deadline passed in the queue gets the distinct error
    (retry 0) at admit, with zero decode work: ``retired`` does not move;
    a live row still serves afterwards and the expired row's session is
    gone."""
    def script(pkg):
        eng = _engine(pkg)
        shed0 = pkg.tel.QOS_SHED_TOTAL.value(cls="agent", tenant="default",
                                             reason="deadline")
        cb = pkg.sch.ContinuousBatcher(eng, chunk=4)
        try:
            fut = cb.submit(enc(eng, "user: too late"), temperature=0.0,
                            max_new_tokens=8, deadline_s=clock.t - 0.001)
            with pytest.raises(pkg.adm.DeadlineExceededError) as ei:
                fut.result(WAIT)
            retired = cb.retired
            ok = cb.submit(enc(eng, "user: on time"), temperature=0.0,
                           max_new_tokens=4).result(WAIT)
        finally:
            cb.close()
        return (str(ei.value), ei.value.as_dict(), retired, cb.retired,
                cb.failed, ok.token_ids, len(eng.sessions),
                pkg.tel.QOS_SHED_TOTAL.value(cls="agent", tenant="default",
                                             reason="deadline") - shed0)
    msg, d, retired, retired_after, failed, _, n_sessions, sheds = both(
        script)
    assert msg == "deadline passed after 0ms in queue"
    assert d["retry_after_ms"] == 0 and d["reason"] == "deadline"
    assert (retired, retired_after, failed, n_sessions, sheds) == (
        0, 1, 1, 0, 1)


def test_backend_qos_member_errors(clock):
    """TorchBackend(continuous=True, qos=...) against the JAX backend: a
    row with deadline_ms=0 fails at build (deadline_exceeded, not
    permanent), and a BATCH row past the controller's queue bound is shed
    as admission_rejected with its retry hint, while the member's other
    rows are served. The slot is held by another agent's row (its first
    chunk held) until both queued rows are in."""
    def script(pkg):
        qcfg = pkg.qos.QoSConfig(
            admission=pkg.adm.AdmissionConfig(max_queue_depth=2))
        backend = _backend(pkg, continuous=True, continuous_chunk=4,
                           continuous_slots=1, qos=qcfg)
        R = pkg.rt
        eng = backend.engines["xla:tiny"]
        cb = backend._cbatchers["xla:tiny"]
        msgs = [{"role": "user", "content": "hello"}]
        spy = HeldGenerate(eng)
        res = {}
        try:
            holder = threading.Thread(target=lambda: res.setdefault(
                "a", backend.query([R.QueryRequest(
                    "xla:tiny", msgs, temperature=0.0, max_tokens=6,
                    session_id="agent-a")])))
            holder.start()
            assert spy.entered.wait(WAIT)
            late = threading.Thread(target=lambda: res.setdefault(
                "b", backend.query([
                    R.QueryRequest("xla:tiny", msgs, temperature=0.0,
                                   max_tokens=6, deadline_ms=0),
                    *[R.QueryRequest("xla:tiny", msgs, temperature=0.0,
                                     max_tokens=6, priority=2,
                                     session_id=f"agent-b{i}")
                      for i in range(3)]])))
            late.start()
            _wait_for(lambda: cb.stats()["queued"] == 2 and cb.failed == 1,
                      "two queued rows and one shed")
            spy.release.set()
            for t in (holder, late):
                t.join(WAIT)
                assert not t.is_alive()
            qs = backend.qos_stats()
        finally:
            spy.remove()
            backend.close()
        return ([(r.ok, r.text, r.error, r.permanent_error)
                 for r in res["a"] + res["b"]],
                qs["admission"]["shed"], qs["admission"]["admitted"],
                qs["admission"]["depth_sources"], qs["slo"]["classes"])
    rows, shed, admitted, sources, _ = both(script)
    assert rows[0][0] and rows[2][0] and rows[3][0]
    assert rows[1][2] == ("deadline_exceeded: 0ms budget elapsed before "
                          "dispatch") and rows[1][3] is False
    assert rows[4][2] == ("admission_rejected: shed BATCH for tenant "
                          "'default': queue past bound (2 rows) "
                          "(retry_after_ms=2000)")
    assert (shed, admitted, sources) == (1, 3, ["xla:tiny"])


def test_backend_qos_wiring():
    """One controller and one SLO tracker shared by the members, one
    weighted-fair policy each, registered as the controller's depth
    sources, its weights scaled by the tracker; qos_stats as in JAX."""
    pool = ("xla:tiny", "xla:tiny-gemma")
    b = _backend(PORT, pool, continuous=True, qos=True)
    try:
        cbs = [b._cbatchers[s] for s in pool]
        assert all(cb.admission is b.qos_controller for cb in cbs)
        assert all(cb.slo is b.slo for cb in cbs)
        pols = [cb._policy for cb in cbs]
        assert len({id(p) for p in pols}) == 2
        assert all(isinstance(p, tqos.WeightedFairPolicy) for p in pols)
        assert all(p.weight_fn == b.slo.weight_multiplier for p in pols)
        st = b.qos_stats()
        assert st["enabled"] and st["admission"]["depth_sources"] == list(
            pool)
        assert set(st["queues"]) == set(pool)
        assert st["admission"]["hbm_headroom"] is None
    finally:
        b.close()
    off = _backend(PORT, pool)
    assert off.qos_stats() == {"enabled": False}
    assert off.scheduler_stats() == {} and off.watchdog_sources() == []


def test_close_zeroes_scheduler_gauges():
    """close() resets the queue-depth and slots-busy gauges: a scrape
    after shutdown reads 0, not the last live values. The first row's
    chunk is held while five more rows queue, so the gauges read 1 busy
    and 5 queued when close() starts."""
    def script(pkg):
        eng = _engine(pkg)
        cb = pkg.sch.ContinuousBatcher(eng, chunk=4, max_slots=2)
        spy = HeldGenerate(eng)
        try:
            futs = [cb.submit(enc(eng, "user: row 0"), temperature=0.0,
                              max_new_tokens=16)]
            assert spy.entered.wait(WAIT)
            futs += [cb.submit(enc(eng, f"user: row {i}"), temperature=0.0,
                               max_new_tokens=16) for i in range(1, 6)]
            live = (pkg.tel.SCHED_SLOTS_BUSY.value(model="tiny"),
                    pkg.tel.SCHED_QUEUE_DEPTH.value(model="tiny"))
            closer = threading.Thread(target=cb.close)
            closer.start()
            _wait_for(lambda: cb._stop, "close() to flip the stop flag")
            spy.release.set()
            closer.join(WAIT)
            assert not closer.is_alive()
        finally:
            spy.remove()
        errors = sorted(str(f.exception(WAIT)) for f in futs)
        text = pkg.tel.METRICS.render_prometheus()
        return (live, errors,
                pkg.tel.SCHED_QUEUE_DEPTH.value(model="tiny"),
                pkg.tel.SCHED_SLOTS_BUSY.value(model="tiny"),
                'quoracle_sched_queue_depth{model="tiny"} 0' in text,
                'quoracle_sched_slots_busy{model="tiny"} 0' in text)
    live, errors, depth, busy, r1, r2 = both(script)
    assert live == (1.0, 5.0)
    assert errors == ["ContinuousBatcher closed"] * 6
    assert (depth, busy, r1, r2) == (0.0, 0.0, True, True)


def test_metrics_registry_matches_the_jax_registry():
    """The copied registry: quantiles, counts, snapshots and the text
    exposition equal JAX's on one scripted stream of observations."""
    def script(pkg):
        reg = pkg.tel.MetricsRegistry()
        c = reg.counter("c_total", "a counter")
        g = reg.gauge("g", "a gauge")
        h = reg.histogram("h_ms", "a histogram")
        for i in range(200):
            c.inc(model="a" if i % 3 else "b")
            h.observe(0.3 * i * i, cls="x" if i % 2 else "y")
        g.set(4.5, model="a")
        with pytest.raises(TypeError):
            reg.gauge("c_total")
        return (c.value(model="a"), c.total(), g.value(model="a"),
                h.counts(), h.counts(cls="x"), h.percentiles(),
                reg.snapshot(), reg.render_prometheus(),
                pkg.tel.quantile(h.buckets, h.counts()[0], 0.95),
                pkg.tel.quantile((1.0, 2.0), [0, 0, 0], 0.5))
    both(script)
