"""Serving flywheel of the PyTorch port (quoracle_tpu_torch/training/),
on the CPU: every case of tests/test_training.py on the port's planes,
and the port held against the JAX package where both compute the same
thing.

Copies of the JAX suite, in the order the flywheel turns:

  * capture store — crc-framed append-only segments: round-trip
    equality, byte-budget oldest-first eviction, deterministic
    sampling, O(1) stats, and crash-safe recovery that unlinks a
    corrupt-tail segment while every intact segment survives;
  * read-only serving — temp-0 output is BIT-IDENTICAL with capture on
    vs off (greedy, grammar-constrained, speculative) on the monolithic
    TorchBackend, the 2-replica cluster plane, and a loopback wire peer;
    the env kill switch really kills;
  * chaos ``train.capture`` — drop/crash injections never block or
    corrupt serving, only capture;
  * the full loop — capture real speculative rounds, train a candidate
    from them, replay held-out capture through the REAL verify_chunk
    path, beat a lobotomized incumbent, promote through a live
    2-replica drain/hot-swap, force a live acceptance regression and
    watch the guard auto-roll back; a chaos ``train.promote`` crash
    mid-rollout leaves the incumbent serving; the /api/train payload.

``test_pool_sizing_trainer_section`` has no copy here: ``pool_sizing``
lives in the JAX package's parallel/mesh.py, which ROADMAP Queue 1 item
12 (multi-GPU) ports.

Against the JAX package: ``rows_from_capture``, ``corpus_rows``,
``heldout_split`` and the trainer's sha256 batch order are equal; the
capture segments are the same bytes, and each package reads the other's
store; ``build_format_corpus`` gives the same ids and ``bench_scoring``
the same scores. A resumed port run is bit-equal to an uninterrupted one.
"""

import json
import os

import numpy as np
import pytest
import torch

from quoracle_tpu.training import capture as jcapmod
from quoracle_tpu.training import trainer as jtrainer
from quoracle_tpu_torch.models.config import ModelConfig
from quoracle_tpu_torch.models.generate import GenerateEngine
from quoracle_tpu_torch.models.runtime import QueryRequest, TorchBackend
from quoracle_tpu_torch.models.scheduler import _Row
from quoracle_tpu_torch.models.speculative import BatchedSpeculator
from quoracle_tpu_torch.models.tokenizer import ByteTokenizer
from quoracle_tpu_torch.models.transformer import init_params
from quoracle_tpu_torch.training import capture as capmod
from quoracle_tpu_torch.training import trainer as ttrainer
from quoracle_tpu_torch.training.capture import CAPTURE, CaptureStore
from quoracle_tpu_torch.training.evaluate import compare, greedy_equal
from quoracle_tpu_torch.training.promote import (
    AcceptanceGuard, PromotionPolicy, Promoter, gate,
)
from quoracle_tpu_torch.training.trainer import (
    DraftTrainer, TrainerConfig, heldout_split, rows_from_capture,
    train_from_capture,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.train

MEMBER = "xla:tiny"
MSGS = [{"role": "user", "content": "hello flywheel world, please "
                                    "elaborate at length"}]

TARGET = ModelConfig(
    name="flyw-t", vocab_size=512, dim=96, n_layers=3, n_heads=4,
    n_kv_heads=2, ffn_dim=192, context_window=1024, output_limit=256)
DRAFT = ModelConfig(
    name="flyw-d", vocab_size=512, dim=48, n_layers=2, n_heads=2,
    n_kv_heads=2, ffn_dim=96, context_window=1024, output_limit=256)


@pytest.fixture(autouse=True)
def _clean_plane():
    CAPTURE.reset()
    capmod.enable()
    yield
    CAPTURE.reset()
    capmod.enable()


def _init(cfg, seed):
    return init_params(cfg, torch.Generator().manual_seed(seed),
                       device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return _init(TARGET, 0), _init(DRAFT, 1)


def t_engine(params, **kw):
    return GenerateEngine(TARGET, params[0], ByteTokenizer(),
                          max_seq=kw.pop("max_seq", 512),
                          prompt_buckets=(32, 64, 128), device="cpu", **kw)


def d_engine(cfg_params, cfg=DRAFT, **kw):
    return GenerateEngine(cfg, cfg_params, ByteTokenizer(),
                          max_seq=kw.pop("max_seq", 512),
                          prompt_buckets=(32, 64, 128), device="cpu", **kw)


def enc(text):
    return ByteTokenizer().encode(text, add_bos=True)


def rec(i, n_ctx=6):
    return {"kind": "spec_round", "ctx": list(range(1, n_ctx + 1)),
            "proposal": [i % 509 + 1] * 3, "verified": [i % 509 + 1] * 3,
            "accepted": 3, "correction": None, "i": i}


# ---------------------------------------------------------------------------
# Capture store: framing, budget, sampling, recovery
# ---------------------------------------------------------------------------

def test_capture_round_trip_and_o1_stats(tmp_path):
    store = CaptureStore(str(tmp_path / "cap"), budget_mb=4.0)
    recs = [rec(i) for i in range(25)]
    for r in recs:
        assert store.append("spec", r) == "ok"
    store.flush()
    got = list(store.read_all("spec"))
    # byte-exact round trip (read_all stamps the source it filtered by)
    assert [{k: v for k, v in g.items() if k != "source"}
            for g in got] == recs
    st = store.stats()
    assert st["appended"] == 25 and st["dropped"] == 0
    assert st["disk_records"] == 25 and st["buffered_records"] == 0
    # O(1) stats agree with a real dir walk
    walked = sum(os.path.getsize(os.path.join(store.path, f))
                 for f in os.listdir(store.path))
    assert st["disk_bytes"] == walked
    assert st["segments"] == len(os.listdir(store.path))


def test_capture_budget_evicts_oldest_first(tmp_path):
    store = CaptureStore(str(tmp_path / "cap"), budget_mb=0.01,
                         segment_kb=1)
    for i in range(300):
        store.append("spec", rec(i))
    store.flush()
    st = store.stats()
    assert st["evicted_segments"] > 0
    assert st["disk_bytes"] <= 0.01 * (1 << 20) + 2048  # one segment slack
    survivors = list(store.read_all("spec"))
    assert survivors                       # newest records survive...
    assert survivors[-1]["i"] == 299
    assert survivors[0]["i"] > 0           # ...oldest were evicted


def test_capture_sampling_is_seed_deterministic(tmp_path):
    kept = []
    for run in range(2):
        store = CaptureStore(str(tmp_path / f"cap{run}"),
                             sample_every=3, seed=42)
        marks = [store.append("spec", rec(i)) for i in range(60)]
        kept.append(marks)
        st = store.stats()
        assert st["sampled_out"] > 0 and st["appended"] > 0
    assert kept[0] == kept[1]              # same seed → same subset


def test_capture_crash_safe_recovery_unlinks_corrupt_tail(tmp_path):
    path = str(tmp_path / "cap")
    store = CaptureStore(path, segment_kb=1)
    for i in range(60):
        store.append("spec", rec(i))
    store.flush()
    segs = sorted(os.listdir(path))
    assert len(segs) >= 3
    # torn write: the NEWEST segment loses its tail mid-frame
    victim = os.path.join(path, segs[-1])
    data = open(victim, "rb").read()
    open(victim, "wb").write(data[:len(data) - 7])
    store2 = CaptureStore(path)            # crash-restart
    st = store2.stats()
    assert st["corrupt_segments"] == 1
    assert not os.path.exists(victim)      # skip-and-unlink
    survivors = list(store2.read_all("spec"))
    assert survivors and survivors[0]["i"] == 0
    assert st["disk_records"] == len(survivors)


def test_capture_read_time_corruption_skips_and_unlinks(tmp_path):
    path = str(tmp_path / "cap")
    store = CaptureStore(path, segment_kb=1)
    for i in range(40):
        store.append("spec", rec(i))
    store.flush()
    segs = sorted(os.listdir(path))
    victim = os.path.join(path, segs[0])
    raw = bytearray(open(victim, "rb").read())
    raw[-3] ^= 0xFF                        # flip a byte in the LAST frame
    open(victim, "wb").write(bytes(raw))
    got = list(store.read_all("spec"))
    # records before the corruption still yield; the tainted segment is
    # unlinked so the next read never re-pays the crc miss
    assert got and len(got) < 40
    assert [g["i"] for g in got] == sorted(g["i"] for g in got)
    assert not os.path.exists(victim)
    assert store.stats()["corrupt_segments"] == 1


def test_env_kill_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("QUORACLE_TRAIN_CAPTURE", "0")
    CAPTURE.reset()                        # re-reads the env
    assert not capmod.enabled()
    CAPTURE.install(str(tmp_path / "cap"))
    assert not CAPTURE.active
    CAPTURE.observe_spec_round("m", "d", [rec(0)])
    CAPTURE.store.flush()
    assert list(CAPTURE.store.read_all("spec")) == []


# ---------------------------------------------------------------------------
# Read-only serving: capture on/off bit-equality on all three planes
# ---------------------------------------------------------------------------

def _ask(b, sid, cj=False):
    return b.query([QueryRequest(MEMBER, MSGS, temperature=0.0,
                                 max_tokens=20, constrain_json=cj,
                                 session_id=sid)])[0]


def _on_off_gate(backend, tmp_path):
    """Query with capture OFF, install a store, query again: texts must
    be bit-identical and the store must hold real spec rounds."""
    off_g, off_c = _ask(backend, "off-g"), _ask(backend, "off-c", cj=True)
    assert off_g.ok and off_c.ok, (off_g.error, off_c.error)
    CAPTURE.install(str(tmp_path / "cap"))
    on_g, on_c = _ask(backend, "on-g"), _ask(backend, "on-c", cj=True)
    assert on_g.ok and on_c.ok, (on_g.error, on_c.error)
    assert on_g.text == off_g.text
    assert on_c.text == off_c.text
    assert on_g.spec_rounds > 0            # the speculative path ran
    CAPTURE.store.flush()
    recs = list(CAPTURE.store.read_all("spec"))
    assert recs and all(r["kind"] == "spec_round" for r in recs)
    assert all(isinstance(r["proposal"], list) and r["proposal"]
               for r in recs)


def test_capture_on_off_bit_identical_mono(tmp_path):
    b = TorchBackend([MEMBER], device="cpu", continuous=True,
                     continuous_chunk=8, draft_map={MEMBER: MEMBER},
                     draft_k=4)
    try:
        _on_off_gate(b, tmp_path)
    finally:
        b.close()


def test_capture_on_off_bit_identical_cluster(tmp_path):
    from quoracle_tpu_torch.serving.cluster import ClusterPlane
    cl = ClusterPlane.build([MEMBER], replicas=2, device="cpu",
                            continuous=True, continuous_chunk=8,
                            draft_map={MEMBER: MEMBER}, draft_k=4)
    try:
        _on_off_gate(cl, tmp_path)
    finally:
        cl.close()


def test_capture_on_off_bit_identical_wire_peer(tmp_path):
    from quoracle_tpu_torch.serving.cluster import RemoteReplica
    from quoracle_tpu_torch.serving.fabric.frontdoor import FabricPlane
    from quoracle_tpu_torch.serving.fabric.peer import FabricPeer
    from quoracle_tpu_torch.serving.fabric.transport import (
        LoopbackTransport,
    )
    peer = FabricPeer.build([MEMBER], role="unified",
                            replica_id="flyw-peer", device="cpu",
                            continuous_chunk=8,
                            draft_map={MEMBER: MEMBER}, draft_k=4)
    plane = FabricPlane([RemoteReplica(
        LoopbackTransport(peer.handle, peer.replica_id))])
    try:
        _on_off_gate(plane, tmp_path)
    finally:
        plane.close()
        peer.close()


# ---------------------------------------------------------------------------
# Chaos train.capture: serving never blocks, only capture degrades
# ---------------------------------------------------------------------------

def test_chaos_capture_crash_never_reaches_serving(tmp_path):
    from quoracle_tpu_torch.chaos.faults import CHAOS, FaultPlan, FaultRule
    from quoracle_tpu_torch.infra.flightrec import FLIGHT
    b = TorchBackend([MEMBER], device="cpu", continuous=True,
                     continuous_chunk=8, draft_map={MEMBER: MEMBER},
                     draft_k=4)
    try:
        want = _ask(b, "chaos-w")
        CAPTURE.install(str(tmp_path / "cap"))
        CHAOS.arm(FaultPlan(0, [FaultRule("train.capture", "crash")]))
        try:
            got = _ask(b, "chaos-g")
        finally:
            CHAOS.disarm()
        assert got.ok and got.text == want.text   # invariant: read-only
        st = CAPTURE.stats()
        assert st["degraded"]              # the crash was absorbed
        assert st["store"]["dropped"] > 0
        assert any(e["kind"] == "train_capture_degraded"
                   for e in FLIGHT.snapshot())
    finally:
        b.close()


def test_chaos_capture_drop_loses_records_not_output(tmp_path):
    from quoracle_tpu_torch.chaos.faults import CHAOS, FaultPlan, FaultRule
    b = TorchBackend([MEMBER], device="cpu", continuous=True,
                     continuous_chunk=8, draft_map={MEMBER: MEMBER},
                     draft_k=4)
    try:
        want = _ask(b, "drop-w")
        CAPTURE.install(str(tmp_path / "cap"))
        CHAOS.arm(FaultPlan(0, [FaultRule("train.capture", "drop")]))
        try:
            got = _ask(b, "drop-g")
        finally:
            CHAOS.disarm()
        assert got.ok and got.text == want.text
        CAPTURE.store.flush()
        assert list(CAPTURE.store.read_all("spec")) == []
        assert CAPTURE.store.stats()["dropped"] > 0
        assert not CAPTURE.stats()["degraded"]    # drop is not a crash
    finally:
        b.close()


# ---------------------------------------------------------------------------
# Gate + guard mechanics (pure)
# ---------------------------------------------------------------------------

def _report(margin, n=20):
    inc = 0.10
    return {"model": "m", "n": n,
            "incumbent": {"p50": inc, "p95": inc, "mean": inc, "n": n},
            "candidate": {"p50": inc + margin, "p95": inc + margin,
                          "mean": inc + margin, "n": n},
            "margin_p50": margin}


def test_gate_decisions():
    pol = PromotionPolicy(margin_p50=0.02, min_examples=8)
    assert gate(_report(0.05), pol, True)[0]
    ok, why = gate(_report(0.01), pol, True)
    assert not ok and "margin" in why
    ok, why = gate(_report(0.05, n=3), pol, True)
    assert not ok and why == "too_few_examples"
    ok, why = gate(_report(0.05), pol, False)
    assert not ok and why == "greedy_mismatch"
    assert gate(_report(0.05), PromotionPolicy(
        require_greedy_equal=False), False)[0]


def test_acceptance_guard_trips_on_consecutive_breaches_only():
    pol = PromotionPolicy(min_rounds=5, trip_after=3)
    g = AcceptanceGuard(floor=0.5, policy=pol)
    assert not g.observe(0.1, rounds=2)    # warmup: too few rounds
    assert not g.observe(0.1, rounds=10)   # breach 1
    assert not g.observe(0.9, rounds=11)   # recovery resets the streak
    assert not g.observe(0.1, rounds=12)
    assert not g.observe(0.1, rounds=13)
    assert g.observe(0.1, rounds=14)       # third consecutive: trip
    assert g.tripped
    assert not g.observe(0.1, rounds=15)   # trips exactly once


def test_heldout_split_is_deterministic():
    recs = [rec(i) for i in range(200)]
    a = heldout_split(recs, frac=0.2, seed=3)
    b = heldout_split(recs, frac=0.2, seed=3)
    assert a == b
    assert 10 < len(a[1]) < 80             # roughly the asked fraction
    assert len(a[0]) + len(a[1]) == 200


# ---------------------------------------------------------------------------
# The full flywheel: capture → train → eval → promote → regress → rollback
# ---------------------------------------------------------------------------

def _mk_row(prompt, sid, max_new=48):
    import time
    from concurrent.futures import Future
    return _Row(prompt=list(prompt), temperature=0.0, top_p=1.0,
                max_new=max_new, session_id=sid, constrain=False,
                action_enum=None, future=Future(),
                t_submit=time.monotonic(), owns_session=True)


PROMPTS = [
    "user: tell me a story about consensus machines",
    "user: alpha question goes here",
    "user: beta goes further into the protocol",
    "user: gamma asks about replicated logs",
    "user: delta wants the quorum math",
    "user: epsilon closes the flywheel loop",
]


def _fill_capture(params, path):
    """Serve real speculative rounds (random draft, so corrections and
    partial accepts both land) with the capture tap on."""
    CAPTURE.install(path, budget_mb=8.0)
    eng = t_engine(params)
    dr = d_engine(params[1])
    spec = BatchedSpeculator(eng, dr, k=4, accept_floor=0.0)
    for i, text in enumerate(PROMPTS):
        row = _mk_row(enc(text), f"fill-{i}")
        for _ in range(24):
            fin = spec.run_round([row])
            if fin.get(id(row)) == "stop" or \
                    len(row.emitted) >= row.max_new:
                break
        spec.drop_session(f"fill-{i}")
        eng.drop_session(f"fill-{i}")
    store = CAPTURE.store
    store.flush()
    return eng, store


def test_flywheel_end_to_end(params, tmp_path):
    """The whole loop on one process: captured speculative rounds train
    a candidate that beats a lobotomized (random-weights) incumbent on
    held-out replay through the REAL verify_chunk path, and the
    promotion gate passes it."""
    eng, store = _fill_capture(params, str(tmp_path / "cap"))
    records = list(store.read_all("spec"))
    assert len(records) >= 30
    train_recs, held = heldout_split(records, frac=0.25, seed=0)
    assert train_recs and held

    tcfg = TrainerConfig(steps=60, batch=8, seq=160, lr=1e-3, seed=0,
                         accept_weight=0.25, dp=1)
    cand_params = _init(DRAFT, 2)
    trainer, treport = train_from_capture(DRAFT, cand_params, store,
                                          tcfg=tcfg)
    assert treport["steps_run"] == 60
    assert treport["capture_records"] == len(records)

    incumbent = d_engine(params[1])        # the lobotomized baseline
    candidate = d_engine(trainer.params)
    report = compare(eng, incumbent, candidate, held, max_k=6)
    assert report["candidate"]["n"] == report["incumbent"]["n"] > 0
    assert report["candidate"]["p50"] > report["incumbent"]["p50"]

    g_ok = greedy_equal(eng, candidate, [enc(PROMPTS[0])], k=4,
                        max_new=24)
    assert g_ok                            # spec decode is lossless
    pol = PromotionPolicy(margin_p50=0.01, min_examples=4)
    ok, reason = gate(report, pol, g_ok)
    assert ok, (reason, report)


def test_flywheel_trainer_rows_weight_corrections(params, tmp_path):
    """The distillation projection: every captured round yields a row
    whose correction position (when present) carries full weight and
    whose accepted prefix carries accept_weight."""
    _, store = _fill_capture(params, str(tmp_path / "cap"))
    records = list(store.read_all("spec"))
    rows = rows_from_capture(records, seq=160, pad_id=TARGET.eos_token_id,
                             accept_weight=0.25)
    assert rows
    saw_correction = False
    for tokens, targets, weights in rows:
        assert len(tokens) == len(targets) == len(weights) == 160
        ws = set(float(w) for w in weights)
        assert ws <= {0.0, 0.25, 1.0}
        if 1.0 in ws:
            saw_correction = True
    assert saw_correction                  # a random draft gets corrected


def test_flywheel_promote_drain_rollback_live(tmp_path):
    """Promotion mechanics on a LIVE 2-replica cluster: gate → per-
    replica drain/hot-swap (ledgered, sessions intact) → serving stays
    bit-identical → forced acceptance regression → the guard auto-rolls
    back to the recorded incumbents with a train_rollback flight event.
    Then a chaos ``train.promote`` crash on a fresh promotion leaves
    the incumbent serving."""
    from quoracle_tpu_torch.chaos.faults import (
        CHAOS, FaultPlan, FaultRule, InjectedFault,
    )
    from quoracle_tpu_torch.infra.flightrec import FLIGHT
    from quoracle_tpu_torch.models.config import get_model_config
    from quoracle_tpu_torch.serving.cluster import ClusterPlane
    from quoracle_tpu_torch.serving.fleet import FleetController

    # unified replicas: a disaggregated prefill tier carries no drafts,
    # so promotion would (correctly) skip it — here we want both swapped
    cl = ClusterPlane.build([MEMBER], replicas=2, disaggregate=False,
                            device="cpu", continuous=True,
                            continuous_chunk=8,
                            draft_map={MEMBER: MEMBER}, draft_k=4)
    fc = FleetController(cl)
    try:
        want = _ask(cl, "promo-s")         # a session that must survive
        assert want.ok, want.error

        tiny = get_model_config("tiny")
        cand_params = _init(tiny, 9)

        def factory():
            return GenerateEngine(tiny, cand_params, ByteTokenizer(),
                                  max_seq=256,
                                  prompt_buckets=(32, 64, 128),
                                  device="cpu")

        promoter = Promoter(PromotionPolicy(
            margin_p50=0.01, min_examples=4, min_rounds=0,
            trip_after=2, require_greedy_equal=True))
        res = promoter.promote_fleet(
            fc, MEMBER, factory, draft_name="tiny-cand",
            report=_report(0.05), greedy_ok=True)
        assert res["promoted"] and res["replicas"] == 2
        # ledgered per replica, zero-downtime drain (no migration)
        swaps = [a for a in fc.stats()["ledger"]
                 if a["action"] == "swap_draft"]
        assert len(swaps) == 2
        for rep in cl.replicas:
            spec = rep.backend._speculators[MEMBER]
            assert spec.draft.cfg is tiny   # candidate serving
            assert rep.backend.draft_map[MEMBER] == "tiny-cand"
        # serving continuity: same session, temp-0 output unchanged
        # (greedy equality holds for ANY draft — that's the spec
        # invariant the whole flywheel leans on)
        msgs2 = MSGS + [{"role": "assistant", "content": want.text},
                        {"role": "user", "content": "continue."}]
        after = cl.query([QueryRequest(MEMBER, msgs2, temperature=0.0,
                                       max_tokens=16,
                                       session_id="promo-s")])[0]
        assert after.ok, after.error
        assert after.cached_tokens > 0      # the session never moved

        # forced live regression: EWMA pinned under the floor trips the
        # guard after trip_after consecutive observations
        assert promoter.observe(MEMBER, ewma=0.0, rounds=100,
                                controller=fc) is None
        rb = promoter.observe(MEMBER, ewma=0.0, rounds=101,
                              controller=fc)
        assert rb is not None and rb["replicas"] == 2
        for rep in cl.replicas:
            assert rep.backend.draft_map[MEMBER] == MEMBER  # restored
        assert any(e["kind"] == "train_rollback"
                   and e.get("outcome") == "regression"
                   for e in FLIGHT.snapshot())
        st = promoter.stats()
        assert st["rollouts"][0]["rolled_back"]
        assert st["rollouts"][0]["rollback_reason"] \
            == "acceptance_regression"
        # still serving after rollback
        again = _ask(cl, "promo-post")
        assert again.ok and again.text == want.text

        # chaos: a crash at train.promote fails the rollout with the
        # incumbent untouched (the swap never started)
        CHAOS.arm(FaultPlan(0, [FaultRule("train.promote", "crash")]))
        try:
            with pytest.raises(InjectedFault):
                promoter.promote_fleet(
                    fc, MEMBER, factory, draft_name="tiny-cand2",
                    report=_report(0.05), greedy_ok=True)
        finally:
            CHAOS.disarm()
        for rep in cl.replicas:
            assert rep.backend.draft_map[MEMBER] == MEMBER
        assert any(e["kind"] == "train_rollback"
                   and e.get("outcome") == "failed"
                   for e in FLIGHT.snapshot())
        final = _ask(cl, "promo-final")
        assert final.ok and final.text == want.text
    finally:
        cl.close()


def test_promoter_rejects_without_touching_fleet():
    promoter = Promoter(PromotionPolicy(margin_p50=0.02))

    class _Boom:
        @property
        def plane(self):               # pragma: no cover - must not run
            raise AssertionError("rejected promotion touched the fleet")

    res = promoter.promote_fleet(_Boom(), MEMBER, lambda: None,
                                 draft_name="x", report=_report(0.001),
                                 greedy_ok=True)
    assert not res["promoted"]
    assert promoter.stats()["rejected"] == 1


# ---------------------------------------------------------------------------
# Registry coherence
# ---------------------------------------------------------------------------

def test_registry_rows_exist():
    from quoracle_tpu_torch.chaos.faults import INJECTION_POINTS
    from quoracle_tpu_torch.infra.bus import TOPIC_TRAIN
    from quoracle_tpu_torch.infra.flightrec import FLIGHT_EVENTS
    from quoracle_tpu_torch.infra.locks import HIERARCHY
    from quoracle_tpu_torch.infra.telemetry import (
        TRAIN_CAPTURE_RECORDS_TOTAL, TRAIN_PROMOTIONS_TOTAL,
    )
    names = {name for name, _, _ in HIERARCHY}
    assert {"train.promote", "train.capture"} <= names
    assert {"train.capture", "train.promote"} <= set(INJECTION_POINTS)
    assert {"train_capture_degraded", "train_capture_evict",
            "train_promote", "train_rollback"} <= set(FLIGHT_EVENTS)
    assert TOPIC_TRAIN == "train:events"
    assert TRAIN_CAPTURE_RECORDS_TOTAL.name \
        == "quoracle_train_capture_records_total"
    assert TRAIN_PROMOTIONS_TOTAL.name == "quoracle_train_promotions_total"


def test_api_train_payload(tmp_path):
    """The dashboard surface, without a server: capture census +
    promoter table + counters serialize."""
    from quoracle_tpu_torch.web.server import DashboardServer
    CAPTURE.install(str(tmp_path / "cap"))
    CAPTURE.observe_spec_round("m", "d", [rec(0)])

    class _RT:
        _promoter = Promoter()

    payload = DashboardServer(_RT()).train_payload()
    assert payload["capture"]["installed"]
    assert payload["promoter"]["rejected"] == 0
    assert "promotions" in payload["counters"]
    json.dumps(payload)                    # wire-serializable


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def _spec_records(n=40):
    """spec_round records of every shape the projection meets: accepted
    prefixes, corrections, full accepts, long contexts (left-truncated),
    empty proposals and a consensus record (both skipped)."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 6))
        j = int(rng.integers(0, k + 1))
        ctx = [int(x) for x in rng.integers(1, 500, int(rng.integers(
            1, 200)))]
        props = [int(x) for x in rng.integers(1, 500, k)]
        ver = props[:j] + [int(x) for x in rng.integers(1, 500, k - j)]
        out.append(capmod.spec_example(ctx, props, ver, j,
                                       None if j == k else ver[j], 0.0,
                                       bool(i % 2), ("a", "b") if i % 3
                                       else None))
    out.append(dict(out[0], proposal=[]))
    out.append({"kind": "consensus", "action": "wait"})
    return out


def _rows_equal(a, b):
    assert len(a) == len(b) and a
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_spec_example_matches_jax():
    args = (list(range(700)), [5, 6, 7], [5, 9, 7], 1, 9, 0.7, True,
            ("b", "a"))
    assert capmod.spec_example(*args) == jcapmod.spec_example(*args)


@pytest.mark.parametrize("accept_weight", [0.25, 0.5])
def test_rows_from_capture_match_jax(accept_weight):
    recs = _spec_records()
    kw = dict(seq=96, pad_id=2, accept_weight=accept_weight)
    _rows_equal(rows_from_capture(recs, **kw),
                jtrainer.rows_from_capture(recs, **kw))


def test_corpus_rows_match_jax():
    rng = np.random.default_rng(1)
    rows = [([int(x) for x in rng.integers(1, 300, int(n))], int(p))
            for n, p in zip(rng.integers(5, 80, 30),
                            rng.integers(1, 5, 30))]
    _rows_equal(ttrainer.corpus_rows(rows, seq=64, pad_id=2),
                jtrainer.corpus_rows(rows, seq=64, pad_id=2))


@pytest.mark.parametrize("frac,seed", [(0.2, 0), (0.25, 3), (0.5, 11)])
def test_heldout_split_matches_jax(frac, seed):
    recs = [rec(i) for i in range(300)]
    assert heldout_split(recs, frac, seed) \
        == jtrainer.heldout_split(recs, frac, seed)


def test_trainer_batch_order_matches_jax():
    """Slot b of step s reads row sha256(seed:s:b) in both packages: the
    same batches, step for step."""
    import jax
    import jax.numpy as jnp

    from quoracle_tpu.models.transformer import init_params as jinit
    recs = _spec_records()
    rows = rows_from_capture(recs, seq=96, pad_id=2)
    jcfg = jtrainer.TrainerConfig(batch=4, seq=96, seed=7)
    tcfg = TrainerConfig(batch=4, seq=96, seed=7)
    jt = jtrainer.DraftTrainer(DRAFT, jinit(DRAFT, jax.random.PRNGKey(0),
                                            dtype=jnp.float32), jcfg)
    tt = DraftTrainer(DRAFT, _init(DRAFT, 0), tcfg)
    for step in (0, 1, 5, 17):
        for a, b in zip(tt._batch(rows, step), jt._batch(rows, step)):
            np.testing.assert_array_equal(a, b)


def test_trainer_refuses_data_parallel():
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 12"):
        DraftTrainer(DRAFT, _init(DRAFT, 0), TrainerConfig(dp=2))


def test_resumed_run_is_bit_equal_to_an_uninterrupted_one(tmp_path):
    """Six steps straight, against a run saved every two steps that
    crashes in its fifth, then a new trainer on fresh weights resuming
    from <ckpt_dir>/latest for the last two: the same parameters, bit for
    bit, and the same final loss."""
    rows = rows_from_capture(_spec_records(), seq=64, pad_id=2)
    kw = dict(steps=6, batch=4, seq=64, lr=3e-3, seed=1, warmup=2,
              clip_norm=1.0)
    straight = DraftTrainer(DRAFT, _init(DRAFT, 3), TrainerConfig(**kw))
    rep = straight.run(rows)
    assert rep["steps_run"] == 6 and rep["resumed_from"] is None
    ck = str(tmp_path / "ck")
    first = DraftTrainer(DRAFT, _init(DRAFT, 3),
                         TrainerConfig(ckpt_dir=ck, ckpt_every=2, **kw))
    real_step = first.step

    def crash_in_fifth(*batch):
        if first.state.step == 4:
            raise RuntimeError("killed")
        return real_step(*batch)

    first.step = crash_in_fifth
    with pytest.raises(RuntimeError, match="killed"):
        first.run(rows)
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f) == {"step": 4, "seed": 1,
                                "model": DRAFT.name}
    second = DraftTrainer(DRAFT, _init(DRAFT, 99),
                          TrainerConfig(ckpt_dir=ck, **kw))
    rep2 = second.run(rows)
    assert rep2["resumed_from"] == 4 and rep2["steps_run"] == 2
    assert rep2["step"] == 6 and rep2["final_loss"] == rep["final_loss"]
    for a, b in zip(straight.params.parameters(),
                    second.params.parameters()):
        assert torch.equal(a, b)


def test_trainer_budget_stops_the_loop():
    rows = rows_from_capture(_spec_records(), seq=64, pad_id=2)
    tr = DraftTrainer(DRAFT, _init(DRAFT, 3),
                      TrainerConfig(steps=50, batch=2, seq=64,
                                    budget_s=1e-9))
    rep = tr.run(rows)
    assert rep["stopped"] == "budget" and rep["steps_run"] == 0


def _fill(store, recs):
    for r in recs:
        store.append("spec", r)
    store.flush()


def test_capture_segments_are_the_jax_bytes(tmp_path):
    """The same records appended to a store of each package give the
    same segment files, byte for byte, and each package reads the other's
    store back whole."""
    recs = [dict(rec(i), note="é ✓") for i in range(60)]
    t = CaptureStore(str(tmp_path / "port"), segment_kb=1)
    j = jcapmod.CaptureStore(str(tmp_path / "jax"), segment_kb=1)
    _fill(t, recs)
    _fill(j, recs)
    names = sorted(os.listdir(t.path))
    assert len(names) >= 3 and names == sorted(os.listdir(j.path))
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() \
            == (tmp_path / "jax" / n).read_bytes()
    # the JAX package writes, the port reads; and the other way
    from_jax = CaptureStore(j.path)
    from_port = jcapmod.CaptureStore(t.path)
    want = [dict(r, source="spec") for r in recs]
    assert list(from_jax.read_all("spec")) == want
    assert list(from_port.read_all("spec")) == want
    assert from_jax.stats()["disk_bytes"] == j.stats()["disk_bytes"]


def test_format_corpus_ids_match_jax(tmp_path):
    from quoracle_tpu.models.tokenizer import HFAutoTokenizer as JTok
    from quoracle_tpu.tools import finetune as jft
    from quoracle_tpu_torch.models.make_checkpoint import make_checkpoint
    from quoracle_tpu_torch.models.tokenizer import HFAutoTokenizer as TTok
    from quoracle_tpu_torch.tools import finetune as tft
    d = make_checkpoint(str(tmp_path / "ck"), family="llama", scale="tiny")
    jt, tt = JTok(d), TTok(d)
    got = tft.build_format_corpus(tt, tt.eos_id, 40, 3, 192)
    want = jft.build_format_corpus(jt, jt.eos_id, 40, 3, 192)
    assert got == want and len(got) > 20
    grove = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "groves", "mmlu-pro")
    assert tft.build_mmlu_corpus(tt, tt.eos_id, grove, 2, 512) \
        == jft.build_mmlu_corpus(jt, jt.eos_id, grove, 2, 512)


def test_bench_scoring_matches_jax_over_a_grove_workspace(tmp_path):
    from quoracle_tpu.governance import bench_scoring as jbs
    from quoracle_tpu_torch.governance import bench_scoring as tbs
    grove = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "groves", "mmlu-pro")
    results = []
    for mod, ws in ((jbs, tmp_path / "j"), (tbs, tmp_path / "t")):
        mod.prepare(str(ws), grove, ["answer"])
        qs = mod.load_questions(grove)
        answers = ws / "runs" / "r1" / "answers"
        answers.mkdir(parents=True)
        for i, q in enumerate(qs):
            if i % 4 == 3:
                continue                       # unanswered
            ans = q["answer"] if i % 3 else "Z"
            body = {"answer": ans} if i % 5 else {"answer": 7}
            (answers / f"{q['id']}.json").write_text(json.dumps(body))
        (answers / "broken.json").write_text("{not json")
        results.append(mod.score(
            str(ws), "r1", grove,
            lambda q, got: got is not None and got == q["answer"],
            "subject", "per_subject"))
        assert (ws / "data" / "questions.jsonl").read_text() == "".join(
            json.dumps({k: v for k, v in q.items() if k != "answer"})
            + "\n" for q in qs)
    assert results[1] == results[0] and results[1]["answered"] > 0


def test_quality_sink_captures_the_jax_projection(tmp_path):
    """The consensus audit record reaches the capture store through the
    port's quality sink as the same slim projection the JAX plane keeps;
    other events are ignored."""
    from quoracle_tpu.training.capture import CAPTURE as JCAP
    from quoracle_tpu_torch.consensus import quality
    record = {"event": "consensus_audit", "decide_id": "d-1",
              "task_id": "t", "agent_id": "a", "n_members": 3,
              "margin": 0.5,
              "decision": {"action": "wait", "kind": "action",
                           "confidence": 0.9},
              "members": {"m1": {"agreed": True}, "m2": {"agreed": False},
                          "m3": {"agreed": True}}}
    assert quality._capture_sink in quality.QUALITY._sinks
    got = []
    for plane, sink, sub in ((JCAP, JCAP.observe_consensus, "j"),
                             (CAPTURE, quality._capture_sink, "t")):
        plane.reset()
        plane.install(str(tmp_path / sub))
        try:
            sink({"event": "model_health_drift"})
            sink(record)
            plane.store.flush()
            got.append(list(plane.store.read_all("consensus")))
        finally:
            plane.reset()
    assert got[1] == got[0] and len(got[1]) == 1
    assert got[1][0]["winners"] == ["m1", "m3"]


def test_finetune_train_tracks_jax_and_eval_format_serves(tmp_path):
    """tools/finetune.py's ``train`` on one tiny checkpoint in both
    packages: the same batches (random.Random(seed).choice), the logged
    losses within the log's 4 decimals; then ``eval_format`` serves the
    exported checkpoint through TorchBackend on the CPU."""
    import re

    from quoracle_tpu.models.tokenizer import HFAutoTokenizer as JTok
    from quoracle_tpu.tools import finetune as jft
    from quoracle_tpu_torch.models.loader import export_hf_checkpoint
    from quoracle_tpu_torch.models.make_checkpoint import make_checkpoint
    from quoracle_tpu_torch.tools import finetune as tft
    d = make_checkpoint(str(tmp_path / "base"), family="llama",
                        scale="tiny")
    tok = JTok(d)
    rows = jft.build_format_corpus(tok, tok.eos_id, 40, 0, 192)
    logs = {"jax": [], "port": []}
    jft.train(d, rows, 3, 4, 192, 1e-3, 0, logs["jax"].append)
    cfg, state = tft.train(d, rows, 3, 4, 192, 1e-3, 0,
                           logs["port"].append, device="cpu")
    losses = {k: [float(re.search(r"loss (\S+)", m).group(1)) for m in v]
              for k, v in logs.items()}
    assert len(losses["port"]) == 2                   # steps 0 and 2
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=2e-4)
    assert state.step == 3
    out = export_hf_checkpoint(state.params, cfg, str(tmp_path / "tuned"),
                               d)
    rep = tft.eval_format(out, 2, 0, lambda m: None, device="cpu")
    assert rep["n_eval"] == 2 and rep["greedy"] == 1
    assert 0.0 <= rep["json_compliance"] <= 1.0
