"""Measured-profile sim calibration (port of
``quoracle_tpu/sim/calibrate.py``).

The fleet simulator replays traces against a
:class:`~quoracle_tpu_torch.sim.replay.CapacityModel` whose service-time
parameters were, until now, hand-sized per scenario. The chip-economics
plane (infra/costobs.py) measures the real plane's service rates as a
side effect of attribution — per-stage chip-seconds and the real tokens
that rode them. This module closes the loop:

* :func:`fit_capacity` — fit ``prefill_tok_s`` / ``decode_tok_s`` /
  per-rung ``restore_ms`` from one recorded :class:`ChipLedger`. The
  fit is the ledger's own semantics inverted: attribution splits each
  measured wall by real tokens, so ``stage tokens / stage chip-seconds``
  IS the effective per-slot service rate — a trace event's simulated
  service time under the fitted model equals the chip-time the ledger
  would have charged it. Stages with too few tokens keep the base
  parameter (a fit from noise is worse than a default), and the report
  says which.
* :func:`calibrate` — the same fit against the process's live ledgers
  (``costobs.ledgers()``), for operator use from a REPL or notebook.
* :func:`record_profile` — the measurement fixture: replay a trace
  under a ground-truth CapacityModel and charge a standalone ChipLedger
  exactly as the real plane would (prefill/decode walls by token rate,
  restore walls by rung). Calibrating from that ledger must recover the
  truth — the tier-1 gate's closed loop.
* :func:`ttft_gate` — the acceptance gate: replay the trace under the
  FITTED model and compare per-class TTFT quantiles of ok events
  against the measured ledger. Calibration is only trusted while the
  calibrated sim reproduces measured TTFT within tolerance
  (tests/test_costobs.py, tier-1).

Everything here is deterministic: pure arithmetic over recorded
integers, no wall clock, no RNG — two fits of one ledger are
bit-identical, like every other sim artifact.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from quoracle_tpu_torch.infra.costobs import ChipLedger
from quoracle_tpu_torch.sim.replay import CapacityModel, ReplayDriver, ReplayLedger
from quoracle_tpu_torch.sim.workload import Trace

# Below this many charged tokens (or restore events) a stage's measured
# rate is noise — the fit keeps the base parameter and reports the
# stage as unfitted.
MIN_STAGE_TOKENS = 32
MIN_RESTORE_EVENTS = 4

# Per-class minimum ok-event count for a TTFT quantile to participate
# in the gate verdict (quantiles over a handful of samples gate nothing).
MIN_GATE_SAMPLES = 20

QUANTILES = (0.5, 0.9)


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """One fit: the base model, the fitted model, and per-parameter
    provenance (measured vs kept-from-base)."""

    model: str
    base: CapacityModel
    fitted: CapacityModel
    fitted_params: tuple                  # names actually measured
    samples: dict                         # stage -> {tokens, chip_ms}

    def as_dict(self) -> dict:
        return {
            "model": self.model,
            "fitted_params": list(self.fitted_params),
            "prefill_tok_s": round(self.fitted.prefill_tok_s, 3),
            "decode_tok_s": round(self.fitted.decode_tok_s, 3),
            "restore_ms": {k: round(float(v), 3)
                           for k, v in self.fitted.restore_ms},
            "samples": self.samples,
        }


def fit_capacity(ledger: ChipLedger,
                 base: Optional[CapacityModel] = None) -> CalibrationReport:
    """Fit CapacityModel service parameters from one ChipLedger."""
    base = base or CapacityModel()
    stage_ns = ledger.stage_ns()
    stage_tokens = ledger.stage_tokens()
    fitted: list = []
    samples: dict = {}

    def rate(stage: str) -> Optional[float]:
        toks, ns = stage_tokens.get(stage, 0), stage_ns.get(stage, 0)
        samples[stage] = {"tokens": toks,
                          "chip_ms": round(ns / 1e6, 3)}
        if toks < MIN_STAGE_TOKENS or ns <= 0:
            return None
        return toks / (ns / 1e9)

    prefill = rate("prefill")
    decode = rate("decode")
    if prefill is not None:
        fitted.append("prefill_tok_s")
    if decode is not None:
        fitted.append("decode_tok_s")

    restore = {k: float(v) for k, v in base.restore_ms}
    for src, (n, ns) in sorted(ledger.restore_sources().items()):
        samples[f"restore:{src}"] = {"events": n,
                                     "chip_ms": round(ns / 1e6, 3)}
        if src in restore and n >= MIN_RESTORE_EVENTS:
            restore[src] = ns / 1e6 / n
            fitted.append(f"restore_ms:{src}")

    model = dataclasses.replace(
        base,
        prefill_tok_s=prefill if prefill is not None
        else base.prefill_tok_s,
        decode_tok_s=decode if decode is not None
        else base.decode_tok_s,
        restore_ms=tuple((k, restore[k]) for k, _ in base.restore_ms))
    return CalibrationReport(model=ledger.model, base=base, fitted=model,
                             fitted_params=tuple(fitted), samples=samples)


def calibrate(model: Optional[str] = None,
              base: Optional[CapacityModel] = None
              ) -> Optional[CalibrationReport]:
    """Fit from the process's live ledgers: the named model's, else the
    busiest. None when nothing has been charged yet."""
    from quoracle_tpu_torch.infra import costobs
    ledgers = costobs.ledgers()
    if model is not None:
        led = ledgers.get(model)
    else:
        led = max(ledgers.values(), key=lambda l: l.busy_ns(),
                  default=None)
    if led is None or led.busy_ns() <= 0:
        return None
    return fit_capacity(led, base=base)


# ---------------------------------------------------------------------------
# Measurement fixture + acceptance gate
# ---------------------------------------------------------------------------


def record_profile(trace: Trace, capacity: CapacityModel,
                   model: str = "sim:profile") -> tuple:
    """Replay ``trace`` under ``capacity`` (the "real fleet") and charge
    a STANDALONE ChipLedger the way the live plane would: each ok
    event's prefill/decode wall at the true token rates, each restore at
    its rung penalty. Returns ``(chip_ledger, replay_ledger)`` — the
    measured profile and the measured TTFT distribution the gate
    compares against. The ledger is deliberately NOT registered in
    ``costobs.ledgers()`` — a recording fixture, not live state."""
    driver = ReplayDriver(trace, capacity=capacity)
    replay = driver.run()
    led = ChipLedger(model)
    restore_ms = dict(capacity.restore_ms)
    by_eid = {e.eid: e for e in trace.events}
    for eid, _t, _cls, outcome, _reason, _ttft, tier_from, _to, \
            tokens, _tree in replay.rows:
        if outcome != "ok":
            continue                      # shed work never ran on chips
        e = by_eid[eid]
        led.charge("prefill", e.prompt_tokens / capacity.prefill_tok_s,
                   [e.prompt_tokens], [("sim", e.cls, "-", "-")],
                   e.prompt_tokens)
        led.charge("decode", tokens / capacity.decode_tok_s,
                   [tokens], [("sim", e.cls, "-", "-")], tokens)
        rung = restore_ms.get(tier_from, 0)
        if rung:
            led.charge("restore", rung / 1e3, [1],
                       [("sim", e.cls, "-", "-")], 1)
            led.note_restore_source(tier_from, int(rung * 1e6))
    return led, replay


def ttft_quantiles(ledger: ReplayLedger,
                   qs: tuple = QUANTILES) -> dict:
    """{cls: {"n": ok events, "p50": ms, "p90": ms, ...}} over the
    ledger's ok rows (nearest-rank on the recorded integer µs — no
    interpolation, so two runs of one ledger agree bit-for-bit)."""
    by_cls: dict = {}
    for row in ledger.rows:
        if row[3] == "ok":
            by_cls.setdefault(row[2], []).append(row[5])
    out: dict = {}
    for cls, us in by_cls.items():
        us.sort()
        ent = {"n": len(us)}
        for q in qs:
            idx = min(len(us) - 1, int(q * len(us)))
            ent[f"p{int(q * 100)}"] = round(us[idx] / 1000.0, 3)
        out[cls] = ent
    return out


def ttft_gate(trace: Trace, measured: ReplayLedger,
              fitted: CapacityModel, tol: float = 0.35) -> dict:
    """Replay ``trace`` under the FITTED model and require every
    well-sampled class's TTFT quantiles to sit within ``tol`` relative
    error of the measured distribution. Returns a structured report —
    ``passed`` plus per-class/per-quantile deltas — the tier-1 test
    asserts on and /api/sim-style panels can render."""
    calibrated = ReplayDriver(trace, capacity=fitted).run()
    m_q, c_q = ttft_quantiles(measured), ttft_quantiles(calibrated)
    checks: list = []
    for cls in sorted(m_q):
        m, c = m_q[cls], c_q.get(cls)
        if m["n"] < MIN_GATE_SAMPLES or c is None:
            continue
        for q in QUANTILES:
            name = f"p{int(q * 100)}"
            mv, cv = m[name], (c or {}).get(name, 0.0)
            rel = abs(cv - mv) / max(mv, 1e-6)
            checks.append({"cls": cls, "q": name,
                           "measured_ms": mv, "calibrated_ms": cv,
                           "rel_err": round(rel, 4),
                           "ok": rel <= tol})
    return {"passed": bool(checks) and all(c["ok"] for c in checks),
            "tol": tol, "checks": checks,
            "measured": m_q, "calibrated": c_q}
