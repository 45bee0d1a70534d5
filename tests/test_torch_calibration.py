"""The port's paged-tier calibration (quoracle_tpu_torch/tools/
calibrate_paged.py and its harness tools/bench_longctx.py) against the JAX
package's tools, on the CPU.

  * decision parity: both tools' ``main`` over the same scripted
    measurements (their ``build_engine`` and ``measure_paths``
    monkeypatched in each harness module) write the same gates;
  * the harness on a tiny fp32 engine: each path runs on its tier, and
    its reused tokens and temperature-0 tokens equal the JAX engine's
    under the JAX harness (``measure_paths`` with its ``_set_path``);
  * round trip: a file the port's tool writes is what a new port engine
    loads; a file recorded on another kind of device is ignored.
"""

import dataclasses
import json
import sys

import jax
import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.tools import bench_longctx as jbl
from quoracle_tpu.tools import calibrate_paged as jcp
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.tools import bench_longctx as tbl
from quoracle_tpu_torch.tools import calibrate_paged as tcp
from quoracle_tpu_torch.utils.calibration import (
    load_paged_gates, save_paged_gates,
)

torch.set_num_threads(1)

SWEEP = (1024, 4096, 16384)
PATHS = ("unified", "direct_full", "direct_decode", "gather")
GATE_KEYS = ("decode_min_resident", "prefill_min_resident",
             "unified_min_resident", "prefill_max_chunk")


def _p50s(*rows):
    """{resident: {path: p50}} from one (unified, direct_full,
    direct_decode, gather) row per sweep size."""
    return {r: dict(zip(PATHS, row)) for r, row in zip(SWEEP, rows)}


# scripted p50 round ms per size and path (unified, direct_full,
# direct_decode, gather), and the extra flags
CASES = {
    "no_direct_path_wins": (_p50s((50, 90, 80, 70), (60, 95, 85, 75),
                                  (90, 120, 110, 100)), []),
    "direct_full_wins_and_pulls_decode_down": (
        _p50s((50, 90, 80, 70), (60, 70, 85, 75), (90, 80, 95, 100)), []),
    "direct_full_wins_decode_never": (
        _p50s((50, 90, 80, 70), (60, 75, 85, 75), (90, 95, 105, 100)), []),
    "unified_wins_at_the_smallest_size": (
        _p50s((40, 90, 80, 70), (80, 95, 85, 75), (130, 120, 110, 100)),
        []),
    "unified_wins_only_above_a_size": (
        _p50s((80, 90, 80, 70), (70, 95, 85, 75), (90, 120, 110, 100)),
        []),
    "unified_never_wins": (
        _p50s((80, 90, 80, 70), (90, 95, 85, 75), (130, 120, 110, 100)),
        []),
    "prefer_memory_within_the_slack": (
        _p50s((80, 84, 86, 70), (90, 95, 85, 75), (130, 120, 110, 100)),
        ["--prefer-memory"]),
    "prefer_memory_with_a_tighter_slack": (
        _p50s((80, 84, 86, 70), (90, 95, 85, 75), (130, 120, 110, 100)),
        ["--prefer-memory", "--latency-slack", "1.1"]),
}


def _scripted(monkeypatch, module, p50s):
    def build_engine(resident, *a, **kw):
        return object(), object()

    def measure_paths(eng, tok, resident, rounds, new_tokens, paths=PATHS):
        return {p: {"p50_round_ms": float(p50s[resident][p]),
                    "peak_hbm_gb": None, "rounds": rounds} for p in paths}
    monkeypatch.setattr(module, "build_engine", build_engine)
    monkeypatch.setattr(module, "measure_paths", measure_paths)


@pytest.mark.parametrize("case", list(CASES))
def test_gate_decisions_match_the_jax_tool(case, tmp_path, monkeypatch):
    p50s, flags = CASES[case]
    monkeypatch.setenv("QUORACLE_XLA_CACHE", "off")
    # the JAX tool clears every jit cache between sizes; this test builds
    # no engine, and the suite's later tests keep theirs
    monkeypatch.setattr(jax, "clear_caches", lambda: None)
    _scripted(monkeypatch, jbl, p50s)
    _scripted(monkeypatch, tbl, p50s)
    sweep = ["--sweep", *map(str, SWEEP)]
    monkeypatch.setattr(sys, "argv", [
        "calibrate_paged", *sweep, "--out", str(tmp_path / "jax.json"),
        *flags])
    jcp.main()
    tcp.main([*sweep, "--out", str(tmp_path / "port.json"),
              "--device", "cpu", *flags])
    jax_gates = json.loads((tmp_path / "jax.json").read_text())
    port_gates = json.loads((tmp_path / "port.json").read_text())
    assert {k: port_gates[k] for k in GATE_KEYS} == \
        {k: jax_gates[k] for k in GATE_KEYS}
    assert port_gates["device_kind"] == "cpu"


def test_decide_gates_cases():
    """The rules themselves, on the cases above."""
    def gates(case):
        p50s, flags = CASES[case]
        by = {r: {p: {"p50_round_ms": v} for p, v in row.items()}
              for r, row in p50s.items()}
        return tcp.decide_gates(by, "--prefer-memory" in flags)
    assert gates("no_direct_path_wins") == {
        "decode_min_resident": None, "prefill_min_resident": None,
        "unified_min_resident": 0}
    assert gates("direct_full_wins_and_pulls_decode_down") == {
        "decode_min_resident": 4096, "prefill_min_resident": 4096,
        "unified_min_resident": 0}
    assert gates("unified_wins_only_above_a_size")[
        "unified_min_resident"] == 4096
    assert gates("unified_never_wins")["unified_min_resident"] is None
    # the slack holds for every path: unified too (80 / 70 at 1024)
    assert gates("prefer_memory_within_the_slack") == {
        "decode_min_resident": 1024, "prefill_min_resident": 1024,
        "unified_min_resident": 0}


RESIDENT, ROUNDS, NEW = 300, 2, 8


def _tier_spy(eng, calls: list) -> None:
    """Record the tier of each sessioned call of a port engine:
    ``_run_unified``, or ``_run_split`` with its use_direct and
    use_direct_pre (its last two positional arguments)."""
    unified, split = eng._run_unified, eng._run_split

    def run_unified(*a, **kw):
        calls.append("unified")
        return unified(*a, **kw)

    def run_split(*a, **kw):
        use_direct, use_direct_pre = a[-2:]
        calls.append("direct_full" if use_direct_pre else
                     "direct_decode" if use_direct else "gather")
        return split(*a, **kw)
    eng._run_unified, eng._run_split = run_unified, run_split


def _generate_spy(eng, out: list) -> None:
    orig = eng.generate

    def generate(*a, **kw):
        res = orig(*a, **kw)
        out.append([(list(r.token_ids), r.n_cached_tokens) for r in res])
        return res
    eng.generate = generate


def test_harness_paths_match_the_jax_engine():
    jcfg, tcfg = both_configs("tiny")
    params, model = shared_params("tiny", seed=3)
    max_seq = tbl.session_max_seq(RESIDENT, ROUNDS, NEW)
    pool_bytes = 64 << 20
    teng, ttk = tbl.build_engine(RESIDENT, ROUNDS, NEW, "xla:tiny",
                                 session_max_bytes=pool_bytes, params=model,
                                 device="cpu")
    assert teng.max_seq == max_seq and teng.cfg.context_window == max_seq
    jeng = jgen.GenerateEngine(
        dataclasses.replace(jcfg, name="longctx", context_window=max_seq),
        params, jtok.get_tokenizer("xla:tiny"), max_seq=max_seq,
        prompt_buckets=(256, 1024, RESIDENT, max_seq),
        session_max_bytes=pool_bytes)
    assert jeng.sessions.n_pages == teng.sessions.n_pages

    tiers: list = []
    _tier_spy(teng, tiers)
    jcalls: list = []
    _generate_spy(jeng, jcalls)
    port = tbl.measure_paths(teng, ttk, RESIDENT, ROUNDS, NEW)
    jres = jbl.measure_paths(jeng, jeng.tokenizer, RESIDENT, ROUNDS, NEW)
    assert list(port) == list(jres) == list(PATHS)

    n = ROUNDS + 1
    # the build (one call below 1024 tokens) ran under the first path's
    # gates, then each path's rounds on its own tier
    assert tiers == ["unified"] + [p for p in PATHS for _ in range(n)]
    jrounds = jcalls[-len(PATHS) * n:]
    for k, path in enumerate(PATHS):
        got = port[path]
        assert len(got["round_ms"]) == len(got["reused_tokens"]) == n
        assert got["p50_round_ms"] > 0 and got["peak_hbm_gb"] is None
        want = [c[0] for c in jrounds[k * n:(k + 1) * n]]
        assert got["reused_tokens"] == [w[1] for w in want], path
        assert got["token_ids"] == [w[0] for w in want], path
        assert min(got["reused_tokens"]) >= RESIDENT


def test_gates_file_round_trip(tmp_path, monkeypatch):
    p50s, _ = CASES["direct_full_wins_and_pulls_decode_down"]
    _scripted(monkeypatch, tbl, p50s)
    out = tmp_path / "gates.json"
    summary = tcp.main(["--sweep", *map(str, SWEEP), "--out", str(out),
                        "--device", "cpu"])
    assert summary["gate_file"] == str(out)
    monkeypatch.setenv("QUORACLE_PAGED_CALIB", str(out))
    _, model = shared_params("tiny", seed=1)
    eng = tgen.GenerateEngine(both_configs("tiny")[1], model,
                              ttok.get_tokenizer("xla:tiny"), device="cpu")
    assert eng.paged_gates.source == str(out)
    assert (eng.direct_decode_min_tokens, eng.direct_prefill_min_tokens,
            eng.unified_min_tokens) == (4096, 4096, 0)

    # a file recorded on another kind of device is ignored
    other = save_paged_gates(str(tmp_path / "other.json"),
                             decode_min_resident=0, prefill_min_resident=0,
                             unified_min_resident=None,
                             device_kind="NVIDIA H100 80GB HBM3")
    assert load_paged_gates(other, device="cpu").source.startswith("default")
    monkeypatch.setenv("QUORACLE_PAGED_CALIB", other)
    eng2 = tgen.GenerateEngine(both_configs("tiny")[1], model,
                               ttok.get_tokenizer("xla:tiny"), device="cpu")
    assert eng2.paged_gates.source.startswith("default")
    assert eng2.direct_decode_min_tokens >= 1 << 30
    assert eng2.unified_min_tokens >= 1 << 30     # the CPU's AUTO: gather


def test_session_pool_sizing():
    cfg = both_configs("tiny")[1]
    from quoracle_tpu_torch.models.config import get_model_config
    llama = get_model_config("xla:llama-3-8b")
    assert tbl.session_bytes(llama, 16384, 3, 32) == 4 << 30
    assert tbl.session_bytes(llama, 1024, 3, 32) == 2 << 30
    assert tbl.session_bytes(cfg, 300, 2, 8) == 2 << 30
    assert tbl.session_max_seq(16384, 3, 32) == 16384 + 4 * 32 * 5 + 1024
