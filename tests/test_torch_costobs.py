"""The port's chip-economics plane (quoracle_tpu_torch/infra/costobs.py)
against the JAX package's, on the CPU.

Each scenario of tests/test_costobs.py that needs no simulator or cluster
runs through both packages: the ledger arithmetic (exact integer sums,
padding on the overhead key, the row-key context), the roofline readings
and their cliff record, the error budgets (same burns, same trip ids), and
the engine's charge site, whose ledgers agree in tokens and split ratios
(the walls themselves are each package's own). The plane is read-only:
temperature-0 outputs are the same with accounting on and off, on the
engine and through the continuous loop, and rows carry chip-ms only with
it on. ``device_peaks`` keeps the JAX CPU row and refuses an unknown card.
"""

import types

import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.infra import costobs as jco
from quoracle_tpu.infra import flightrec as jfr
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.serving import admission as jadm
from quoracle_tpu_torch.infra import costobs as tco
from quoracle_tpu_torch.infra import flightrec as tfr
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.serving import admission as tadm

torch.set_num_threads(1)

JAX = types.SimpleNamespace(name="jax", co=jco, fr=jfr, gen=jgen, rt=jrt,
                            tok=jtok, adm=jadm)
PORT = types.SimpleNamespace(name="port", co=tco, fr=tfr, gen=tgen, rt=trt,
                             tok=ttok, adm=tadm)
PKGS = (JAX, PORT)
MEMBER = "xla:tiny"
K_A = ("tenant-a", "interactive", "t1", "d1")
K_B = ("tenant-b", "agent", "t2", "d2")


@pytest.fixture(autouse=True)
def _clean_plane():
    for p in PKGS:
        p.co.reset()
        p.co.enable()
    yield
    for p in PKGS:
        p.co.reset()
        p.co.enable()


def engine(pkg):
    jcfg, tcfg = both_configs("tiny")
    jp, tp = shared_params("tiny", seed=5)
    kw = dict(max_seq=256, prompt_buckets=(32, 64, 128))
    if pkg is JAX:
        return jgen.GenerateEngine(jcfg, jp, jtok.get_tokenizer(MEMBER), **kw)
    return tgen.GenerateEngine(tcfg, tp, ttok.get_tokenizer(MEMBER),
                               device="cpu", **kw)


def enc(pkg, text):
    return pkg.tok.get_tokenizer(MEMBER).encode(text, add_bos=True)


def stage_cell_sums(led):
    out = {}
    for key, ns in led.cells().items():
        out[key[4]] = out.get(key[4], 0) + ns
    return out


def test_charge_sum_invariant_exact_and_equal():
    out = {}
    for p in PKGS:
        led = p.co.ChipLedger("t")
        led.charge("prefill", 0.0123457, [7, 13, 1], [K_A, K_B, K_A], 64)
        led.charge("decode", 0.0031415, [5, 0, 9], [K_A, K_B, K_A], 32)
        led.charge("verify", 0.0000019, [3], [K_B], 3)
        led.charge("restore", 0.0400001, [1], [p.co.DEFAULT_KEY], 1)
        led.charge("decode", 0.002, [0, 0], [K_A, K_B], 8)
        assert stage_cell_sums(led) == led.stage_ns()
        assert sum(led.stage_ns().values()) == led.busy_ns()
        out[p.name] = (led.cells(), led.stage_ns(), led.stage_tokens(),
                       led.snapshot())
    assert out["port"] == out["jax"]


def test_padding_waste_lands_on_overhead_tenant():
    for p in PKGS:
        led = p.co.ChipLedger("t")
        shares = led.charge("prefill", 0.010, [3, 5], [K_A, K_B], 16)
        assert sum(shares) == 5_000_000
        snap = led.snapshot()
        assert snap["overhead_chip_ms"] == 5.0
        assert snap["by_tenant_chip_ms"]["tenant-a"] == pytest.approx(1.875)


def test_row_key_context_mismatch_degrades_to_default():
    tco.set_row_keys([K_A])
    assert tco._take_row_keys(2) == [tco.DEFAULT_KEY] * 2
    assert tco._take_row_keys(1) == [tco.DEFAULT_KEY]


def test_row_keys_are_thread_local():
    """A charge made on another thread finds no keys, never this one's."""
    import threading
    tco.set_row_keys([K_A])
    seen = []
    t = threading.Thread(target=lambda: seen.append(tco._take_row_keys(1)))
    t.start()
    t.join()
    assert seen == [[tco.DEFAULT_KEY]]
    assert tco._take_row_keys(1) == [K_A]


def test_key_of_reads_rows_and_dicts():
    class Row:
        tenant, priority, task_id, decide = "u", 0, None, "d9"
    for p in PKGS:
        assert p.co.key_of({"tenant": "t", "priority": "agent",
                            "task_id": "x", "decide": "d"}) == \
            ("t", "agent", "x", "d")
        assert p.co.key_of(Row()) == ("u", "-", "-", "d9")


def test_engine_charges_equal_in_tokens_and_split_ratios():
    """Two rows through each package's engine with declared keys: the
    ledgers hold the same cells and stage tokens, the rows' shares split
    each stage wall in the same ratios, and on/off outputs match."""
    out = {}
    for p in PKGS:
        eng = engine(p)
        prompts = [enc(p, "user: chip accounting row one"),
                   enc(p, "user: two")]
        p.co.set_row_keys([K_A, K_B])
        on = eng.generate(prompts, temperature=0.0, max_new_tokens=12)
        assert all(g.chip_ms > 0 for g in on)
        led = p.co.ledger_for(eng.cfg.name)
        assert stage_cell_sums(led) == led.stage_ns()
        stage = led.stage_ns()
        ratios = {k: round(ns / stage[k[4]], 4)
                  for k, ns in led.cells().items()}
        p.co.disable()
        off = eng.generate(prompts, temperature=0.0, max_new_tokens=12)
        assert [g.token_ids for g in off] == [g.token_ids for g in on]
        assert all(g.chip_ms == 0.0 for g in off)
        out[p.name] = ([g.token_ids for g in on], led.stage_tokens(),
                       sorted(led.cells()), ratios, eng.padding_stats())
    assert out["port"][:3] == out["jax"][:3]
    assert out["port"][4] == out["jax"][4]
    for k, r in out["jax"][3].items():
        assert out["port"][3][k] == pytest.approx(r, abs=2e-4), k


def test_verify_rows_carry_their_charge():
    eng = engine(PORT)
    eng.unified_min_tokens = 0
    p = enc(PORT, "user: verify accounting")
    eng.generate([p], temperature=0.0, max_new_tokens=6,
                 session_ids=["s1"])
    ctx = eng.session_tokens("s1")
    got = eng.verify_chunk([ctx + [5, 6, 7]], ["s1"], [3])
    assert got[0]["chip_ms"] > 0
    assert "verify" in tco.ledger_for(eng.cfg.name).stage_ns()


def test_backend_scheduler_temp0_bit_equal_and_attributed():
    """TorchBackend + the continuous loop: on/off bit-equality, chip-ms on
    the QueryResult, and ledger cells keyed by the submitted tenant, class,
    task and decide — as the JAX backend keys them."""
    out = {}
    for p in PKGS:
        eng = engine(p)
        b = (jrt.TPUBackend([MEMBER], engines={MEMBER: eng},
                            continuous=True, continuous_chunk=8)
             if p is JAX else
             trt.TorchBackend([MEMBER], device="cpu",
                              engines={MEMBER: eng}, continuous=True,
                              continuous_chunk=8))
        try:
            def q():
                return b.query([p.rt.QueryRequest(
                    MEMBER, [{"role": "user", "content":
                              "hello economics plane"}],
                    temperature=0.0, max_tokens=20, tenant="acme",
                    priority=0, task_id="task-7", decide="d-42")])[0]
            on = q()
            assert on.ok, on.error
            assert on.chip_ms > 0.0
            led = p.co.ledger_for(eng.cfg.name)
            assert stage_cell_sums(led) == led.stage_ns()
            keyed = sorted(k for k in led.cells() if k[0] == "acme")
            p.co.disable()
            off = q()
            assert off.text == on.text and off.chip_ms == 0.0
        finally:
            b.close()
        out[p.name] = (on.text, keyed, led.stage_tokens())
    assert out["port"] == out["jax"]
    assert all(k[1:4] == ("interactive", "task-7", "d-42")
               for k in out["port"][1])


def test_roofline_readings_equal_and_cliff_recorded():
    out = {}
    for p in PKGS:
        eng = engine(p)
        rf = p.co.roofline_for(eng)
        assert rf is p.co.roofline_for(eng)
        obs = [rf.observe("prefill", 64, 1, 64, 0.004, 64),
               rf.observe("decode", 8, 8, 96, 0.002, 64)]
        assert rf.observe("prefill", 0, 1, 64, 0.004, 64) is None
        before = [e for e in p.fr.FLIGHT.snapshot()
                  if e["kind"] == "mfu_cliff"]
        rf.observe("prefill", 64, 1, 64, 0.040, 64)
        rf.observe("prefill", 64, 1, 64, 0.041, 64)
        after = [e for e in p.fr.FLIGHT.snapshot()
                 if e["kind"] == "mfu_cliff"]
        assert len(after) == len(before) + 1
        cliff = {k: v for k, v in after[-1].items() if k != "ts"}
        out[p.name] = (obs, rf.n_params, rf.weight_bytes, rf.kv_token_bytes,
                       (rf.peak_flops, rf.peak_bw), cliff)
    assert out["port"] == out["jax"]
    assert 0.0 < out["port"][0][0]["mfu"] <= 1.0


def test_device_peaks_cpu_row_h100_row_and_unknown_card(monkeypatch):
    assert tco.device_peaks("cpu") == jco.device_peaks()
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tco.device_peaks("cuda:0") == (989e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError):
        tco.device_peaks("cuda:0")


def _feed(tracker, seq):
    for tenant, cls, ok, t in seq:
        tracker.record(tenant, cls, ok, t)


def test_budget_burn_trips_deterministically_and_equal():
    seq = [("acme", "interactive", True, 10.0 + i) for i in range(40)]
    seq += [("acme", "interactive", False, 60.0 + i) for i in range(10)]
    out = {}
    for p in PKGS:
        a = p.co.BudgetTracker()
        _feed(a, seq)
        trips = [{k: v for k, v in e.items() if k != "ts"}
                 for e in p.fr.FLIGHT.snapshot()
                 if e["kind"] == "budget_burn" and e["tenant"] == "acme"]
        out[p.name] = (a.snapshot(), a.burn_signals(), trips[-2:])
    assert out["port"] == out["jax"]
    ent = out["port"][0]["tenants"]["acme"]["interactive"]
    assert ent["windows"]["1h"]["burn"] == pytest.approx(200.0)
    assert ent["trips"] == {"1h": 1, "6h": 1}


def test_budget_recovery_discards_trip_state():
    for p in PKGS:
        t = p.co.BudgetTracker()
        _feed(t, [("a", "batch", False, 1.0)])
        _feed(t, [("a", "batch", True, 2.0 + i * 0.01) for i in range(400)])
        ent = t.snapshot()["tenants"]["a"]["batch"]
        assert not ent["windows"]["1h"]["tripping"]
        assert ent["trips"]["1h"] == 1


def test_budget_disabled_records_nothing():
    tco.disable()
    tco.BUDGET.record("x", "batch", ok=False, t=5.0)
    assert tco.BUDGET.snapshot()["tenants"] == {}


def test_costs_payload_equal():
    out = {}
    for p in PKGS:
        p.co.ledger_for("m1").charge("prefill", 0.004, [4], [K_A], 8)
        p.co.charge_restore("m1", 2.5, source="disk")
        payload = p.co.costs_payload()
        out[p.name] = (payload, p.co.ledger_for("m1").restore_sources())
    assert out["port"] == out["jax"]
    assert out["port"][0]["total_chip_ms"] == pytest.approx(6.5)


def test_admission_signals_carry_budget_burn_observed_only():
    out = {}
    for p in PKGS:
        p.co.BUDGET.record("acme", "batch", ok=False, t=100.0)
        snap = p.adm.AdmissionController(p.adm.AdmissionConfig()).signals()
        assert "budget_burn" in snap.as_dict()
        out[p.name] = snap.budget_burn
    assert out["port"] == out["jax"]
    assert out["port"]["batch"] > 0
