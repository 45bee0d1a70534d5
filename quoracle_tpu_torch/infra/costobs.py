"""Chip-economics plane of the PyTorch port (the port's copy of
``quoracle_tpu/infra/costobs.py``): attribution, roofline, budgets.

The fleet measures *latency* everywhere; this module
measures *what the chips were bought for*. Three read-only instruments
share one file because they share one data source — the engine's
measured per-phase device wall:

* **ChipLedger** — charges every engine step's wall (prefill chunk,
  decode tick window, verify chunk, tier restore) to the rows aboard
  it, split by REAL (unpadded) tokens. Padding waste lands on a
  dedicated ``overhead`` pseudo-tenant instead of silently inflating
  per-row costs. Charges roll up by (tenant, priority class, task,
  decide, stage). Arithmetic is integer NANOSECONDS with the remainder
  charged to overhead, so the invariant

      sum(cells with stage S) == stage wall S
      sum(stage walls)        == engine busy wall

  holds EXACTLY — by construction, not within float tolerance (the
  TTFT-decomposition idiom applied to device time).

* **Roofline** — an analytic FLOPs + bytes model of the ragged
  kernel/matmuls (geometry x real tokens, int8-aware: quantized
  weights/KV halve the streamed bytes but dequant to bf16 before the
  tensor cores, so FLOPs stay bf16) divided by measured step wall gives MFU and
  an HBM-bandwidth-bound flag per (model, stage, padded-token bucket).
  A recompile or padding regression shows up as an MFU cliff — the
  ``mfu_cliff`` flight event trips when a bucket's observation drops
  below half its running best.

* **BudgetTracker** — per-tenant-class SLO error budgets over 1h/6h
  multi-windows (Google-SRE fast/slow burn thresholds). Timestamps are
  CALLER-PASSED monotonic seconds and trip ids are sha256 of the event
  count (the chaos-plane idiom) — no wall clock ever enters a
  decision, so a replayed trace reproduces the same trips bit-for-bit.
  Served at GET /api/budget; offered to AdmissionController /
  FleetController as OBSERVED SIGNALS ONLY (no policy acts on them
  yet).

Everything here is measurement: no RNG, no device work, no effect on
row content — temp-0 outputs are bit-identical with accounting on or
off (``QUORACLE_COST_ACCOUNTING=0`` disables the whole plane), the
tier-1 equality gate for this plane.

Attribution context travels on a thread-local: the scheduler / baton
batcher / speculator set the imminent engine call's row keys with
:func:`set_row_keys` on the same thread that calls into the engine,
and the engine's charge site consumes them. A missing or mis-sized
context degrades to the default key — the charge still lands (the sum
invariant never depends on callers behaving).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from typing import Any, Optional, Sequence

from quoracle_tpu_torch.infra.locks import named_lock

# ---------------------------------------------------------------------------
# Enablement
# ---------------------------------------------------------------------------


def _env_enabled() -> bool:
    return os.environ.get("QUORACLE_COST_ACCOUNTING", "1").strip().lower() \
        not in ("0", "false", "off")


class _State:
    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = _env_enabled()


_STATE = _State()


def enabled() -> bool:
    return _STATE.enabled


def enable() -> None:
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


# ---------------------------------------------------------------------------
# Attribution keys + thread-local context
# ---------------------------------------------------------------------------

STAGES = ("prefill", "decode", "verify", "restore")

# (tenant, class, task, decide) — the rollup axes. "-" = unattributed.
DEFAULT_KEY: tuple = ("-", "-", "-", "-")
# Padding / ragged waste is charged to this pseudo-tenant so per-row
# costs stay honest and the waste is itself a first-class series.
OVERHEAD_KEY: tuple = ("overhead", "-", "-", "-")

_TLS = threading.local()


def key_of(row: Any) -> tuple:
    """Attribution key for one batcher row — accepts the scheduler's
    ``_Row`` (attributes) and the runtime's row dicts alike."""
    if isinstance(row, dict):
        g = row.get
    else:
        def g(k, d=None):
            return getattr(row, k, d)
    return (str(g("tenant") or "-"), str(g("priority") or "-"),
            str(g("task_id") or "-"), str(g("decide") or "-"))


def set_row_keys(keys: Optional[Sequence[tuple]]) -> None:
    """Declare the imminent engine call's per-row attribution keys, in
    row order, on THIS thread. Consumed (and cleared) by the engine's
    charge site; one declaration covers exactly one engine call."""
    _TLS.row_keys = list(keys) if keys is not None else None


def set_rows(rows: Sequence[Any]) -> None:
    """``set_row_keys([key_of(r) for r in rows])`` — the caller-side
    one-liner (scheduler steps, baton batcher, speculator rounds)."""
    set_row_keys([key_of(r) for r in rows])


def _take_row_keys(n: int) -> list:
    keys = getattr(_TLS, "row_keys", None)
    _TLS.row_keys = None
    if keys is None or len(keys) != n:
        return [DEFAULT_KEY] * n
    return keys


# ---------------------------------------------------------------------------
# ChipLedger
# ---------------------------------------------------------------------------


class ChipLedger:
    """Integer-nanosecond chip-time attribution for one model.

    ``charge`` splits one measured wall across rows by weight (real
    tokens) over ``padded_total`` (device token slots), so the padded
    remainder — plus any integer-division remainder — is charged to
    :data:`OVERHEAD_KEY` under the same stage. All-zero weights (a
    verify call's empty decode window) charge the whole wall to
    overhead. Metric increments happen OUTSIDE the lock (lockdep:
    ``costobs`` rank 54 < metrics 60, but the ledger lock is pure
    bookkeeping by design)."""

    def __init__(self, model: str):
        self.model = model
        self._lock = named_lock("costobs")
        self._cells: dict[tuple, int] = {}     # key+(stage,) -> ns
        self._stage_ns: dict[str, int] = {}    # stage -> ns
        self._stage_tokens: dict[str, int] = {}  # stage -> real tokens
        self._restore_src: dict[str, list] = {}  # source -> [events, ns]
        self._busy_ns = 0

    def charge(self, stage: str, wall_s: float, weights: Sequence[int],
               keys: Sequence[tuple],
               padded_total: Optional[int] = None) -> list:
        """Charge ``wall_s`` of device wall to ``keys`` by ``weights``;
        returns each row's share in integer ns (aligned with keys)."""
        wall_ns = int(round(wall_s * 1e9))
        n = len(weights)
        if wall_ns <= 0:
            return [0] * n
        real = sum(int(w) for w in weights)
        total = int(padded_total) if padded_total else real
        if total < real:                      # defensive: never negative
            total = real                      # overhead
        if real <= 0 or total <= 0:
            shares = [0] * n
        else:
            shares = [wall_ns * int(w) // total for w in weights]
        overhead = wall_ns - sum(shares)
        by_label: dict[tuple, float] = {}     # (tenant, cls) -> ms
        with self._lock:
            self._busy_ns += wall_ns
            self._stage_ns[stage] = self._stage_ns.get(stage, 0) + wall_ns
            self._stage_tokens[stage] = \
                self._stage_tokens.get(stage, 0) + max(0, real)
            for k, s in zip(keys, shares):
                if s > 0:
                    cell = tuple(k) + (stage,)
                    self._cells[cell] = self._cells.get(cell, 0) + s
                    lab = (k[0], k[1])
                    by_label[lab] = by_label.get(lab, 0.0) + s / 1e6
            if overhead > 0:
                cell = OVERHEAD_KEY + (stage,)
                self._cells[cell] = self._cells.get(cell, 0) + overhead
        # metrics outside the ledger lock
        from quoracle_tpu_torch.infra.telemetry import COST_CHIP_MS_TOTAL
        for (tenant, cls), ms in by_label.items():
            COST_CHIP_MS_TOTAL.inc(ms, model=self.model, stage=stage,
                                   tenant=tenant, cls=cls)
        if overhead > 0:
            COST_CHIP_MS_TOTAL.inc(overhead / 1e6, model=self.model,
                                   stage=stage, tenant="overhead", cls="-")
        return shares

    # -- reads -----------------------------------------------------------

    def busy_ns(self) -> int:
        with self._lock:
            return self._busy_ns

    def stage_ns(self) -> dict:
        with self._lock:
            return dict(self._stage_ns)

    def stage_tokens(self) -> dict:
        """{stage: total REAL tokens charged} — with :meth:`stage_ns`
        this is the measured service-rate profile sim/calibrate.py fits
        CapacityModel parameters from (for ``restore`` the "token"
        count is the number of restore events)."""
        with self._lock:
            return dict(self._stage_tokens)

    def note_restore_source(self, source: str, wall_ns: int) -> None:
        """Tag one restore charge with its tier rung (host/disk/
        prefixd) so calibration can fit each rung's mean penalty —
        the per-stage sums already include this wall via ``charge``."""
        with self._lock:
            cell = self._restore_src.setdefault(str(source), [0, 0])
            cell[0] += 1
            cell[1] += int(wall_ns)

    def restore_sources(self) -> dict:
        """{source: (events, ns)} — restore rung profile."""
        with self._lock:
            return {s: (n, ns)
                    for s, (n, ns) in self._restore_src.items()}

    def cells(self) -> dict:
        """{(tenant, cls, task, decide, stage): ns} — the raw ledger;
        the tier-1 sum-invariant test and sim/calibrate.py read this."""
        with self._lock:
            return dict(self._cells)

    def snapshot(self) -> dict:
        """Rollups for /api/costs: per-stage / per-tenant / per-class
        chip-ms plus the exact-sum invariant restated as data."""
        with self._lock:
            cells = dict(self._cells)
            stage_ns = dict(self._stage_ns)
            stage_tokens = dict(self._stage_tokens)
            busy = self._busy_ns
        by_tenant: dict[str, float] = {}
        by_class: dict[str, float] = {}
        for (tenant, cls, _task, _dec, _stage), ns in cells.items():
            by_tenant[tenant] = by_tenant.get(tenant, 0.0) + ns / 1e6
            by_class[cls] = by_class.get(cls, 0.0) + ns / 1e6
        return {
            "model": self.model,
            "busy_chip_ms": round(busy / 1e6, 3),
            "by_stage_chip_ms": {s: round(ns / 1e6, 3)
                                 for s, ns in sorted(stage_ns.items())},
            "by_stage_tokens": dict(sorted(stage_tokens.items())),
            "by_tenant_chip_ms": {t: round(ms, 3)
                                  for t, ms in sorted(by_tenant.items())},
            "by_class_chip_ms": {c: round(ms, 3)
                                 for c, ms in sorted(by_class.items())},
            "overhead_chip_ms": round(sum(
                ns for k, ns in cells.items()
                if k[:4] == OVERHEAD_KEY) / 1e6, 3),
            "cells": len(cells),
        }


_REG_LOCK = named_lock("costobs")
_LEDGERS: dict[str, ChipLedger] = {}


def ledger_for(model: str) -> ChipLedger:
    with _REG_LOCK:
        led = _LEDGERS.get(model)
        if led is None:
            led = _LEDGERS[model] = ChipLedger(model)
        return led


def ledgers() -> dict:
    with _REG_LOCK:
        return dict(_LEDGERS)


def reset() -> None:
    """Drop every ledger/roofline/budget cell — test isolation only."""
    with _REG_LOCK:
        _LEDGERS.clear()
    BUDGET._reset()


# ---------------------------------------------------------------------------
# Roofline / MFU
# ---------------------------------------------------------------------------

# Device peak table by device-name substring: (peak matmul FLOP/s at
# the serving dtype, peak memory bytes/s). The H100 row is the card's
# dense bf16 tensor-core peak and its HBM3 rate (the numbers PERF.md
# divides by). The CPU row is the JAX package's deliberately
# conservative stand-in, kept so MFU stays a *relative* regression
# signal on a CPU host and both packages read the same ratios there.
_DEVICE_PEAKS: tuple = (
    ("h100", 989e12, 3.35e12),
    ("cpu", 1e11, 50e9),
)


def device_peaks(device: Any = None) -> tuple:
    """(peak FLOP/s, peak bytes/s) for ``device`` (a torch device or its
    name; None = the process's default: the first CUDA card if there is
    one, else the CPU). A CUDA device whose name no row matches raises:
    an MFU against a guessed peak would be a wrong number, not a
    missing one."""
    import torch
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", 0) if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type != "cuda":
        return _DEVICE_PEAKS[-1][1], _DEVICE_PEAKS[-1][2]
    kind = torch.cuda.get_device_name(dev).lower()
    for sub, fl, bw in _DEVICE_PEAKS:
        if sub in kind:
            return fl, bw
    raise ValueError(f"no peak rates for CUDA device {kind!r} in "
                     f"costobs._DEVICE_PEAKS")


@dataclasses.dataclass
class _MfuBest:
    best: float = 0.0
    low: bool = False                  # currently below the cliff line
    trips: int = 0


class Roofline:
    """Analytic FLOPs+bytes model for one engine's compiled programs.

    FLOPs per processed token: ``2·N`` for the parameter matmuls plus
    ``4·L·dim·ctx`` for attention score+value at context ``ctx``
    (dequantized int8 runs bf16 on the tensor cores, so FLOPs are
    dtype-blind).
    Bytes per step: one weight stream (int8-aware: quantized leaves
    ship 1 byte/param) plus KV traffic at the engine's per-token KV
    cost (int8 KV pages + their f32 scales). Coarse by design — the
    point is a STABLE per-program ratio whose cliffs mark recompiles
    and padding regressions, not a cycle-accurate simulator."""

    def __init__(self, engine: Any):
        cfg = engine.cfg
        self.model = cfg.name
        import torch
        itemsize = torch.empty((), dtype=engine._raw_param_dtype).element_size()
        self.n_params = int(engine._raw_param_bytes) // max(1, itemsize)
        self.weight_bytes = self.n_params * (
            1 if getattr(engine, "quantize_weights", False) else itemsize)
        L = cfg.n_layers
        n_kv = getattr(cfg, "n_kv_heads", None) or cfg.n_heads
        hd = getattr(cfg, "head_dim", None) or (cfg.dim // cfg.n_heads)
        if getattr(engine, "quantize_kv", False):
            # int8 K+V plus one f32 scale per (token, kv-head) each
            self.kv_token_bytes = 2 * L * n_kv * (hd + 4)
        else:
            cache_item = torch.empty((), dtype=getattr(
                engine, "cache_dtype", engine._raw_param_dtype)).element_size()
            self.kv_token_bytes = 2 * L * n_kv * hd * cache_item
        self.attn_flops_per_tok_ctx = 4 * L * cfg.dim   # x ctx at use
        self.peak_flops, self.peak_bw = device_peaks(
            getattr(engine, "device", None))
        self._lock = named_lock("costobs")
        self._best: dict[tuple, _MfuBest] = {}   # (stage, bucket)

    def observe(self, stage: str, real_tokens: int, steps: int,
                ctx: int, wall_s: float, bucket: int) -> Optional[dict]:
        """Score one charged step: ``real_tokens`` processed across
        ``steps`` device launches at context ``ctx``, in ``wall_s``.
        Returns the observation dict (or None when unscorable)."""
        if wall_s <= 0 or real_tokens <= 0:
            return None
        flops = real_tokens * (2 * self.n_params
                               + self.attn_flops_per_tok_ctx * ctx)
        byts = (max(1, steps) * self.weight_bytes
                + real_tokens * (ctx + 1) * self.kv_token_bytes)
        mfu = flops / wall_s / self.peak_flops
        hbm_bound = (byts / self.peak_bw) > (flops / self.peak_flops)
        from quoracle_tpu_torch.infra.telemetry import MFU_HBM_BOUND, MFU_RATIO
        MFU_RATIO.observe(mfu, model=self.model, stage=stage,
                          bucket=str(bucket))
        MFU_HBM_BOUND.set(1.0 if hbm_bound else 0.0,
                          model=self.model, stage=stage)
        cliff = None
        with self._lock:
            st = self._best.setdefault((stage, bucket), _MfuBest())
            if mfu > st.best:
                st.best, st.low = mfu, False
            elif st.best > 0 and mfu < 0.5 * st.best:
                if not st.low:        # record the crossing, not the stay
                    st.trips += 1
                    cliff = {"best": st.best, "n": st.trips}
                st.low = True
            else:
                st.low = False
        if cliff is not None:
            from quoracle_tpu_torch.infra.flightrec import FLIGHT
            from quoracle_tpu_torch.infra.telemetry import MFU_CLIFFS_TOTAL
            FLIGHT.record("mfu_cliff", model=self.model, stage=stage,
                          bucket=bucket, mfu=round(mfu, 4),
                          best=round(cliff["best"], 4), n=cliff["n"])
            MFU_CLIFFS_TOTAL.inc(model=self.model, stage=stage,
                                 bucket=str(bucket))
        return {"mfu": mfu, "hbm_bound": hbm_bound, "flops": flops,
                "bytes": byts}


def roofline_for(engine: Any) -> Roofline:
    rf = getattr(engine, "_costobs_roofline", None)
    if rf is None:
        rf = engine._costobs_roofline = Roofline(engine)
    return rf


# ---------------------------------------------------------------------------
# Engine charge site (called from generate.py's telemetry region)
# ---------------------------------------------------------------------------


def charge_step(engine: Any, *, n: int, prefill_weights: Sequence[int],
                decode_weights: Sequence[int], padded_prefill: int,
                padded_decode: int, cache_len: int, verify: bool,
                prefill_bucket: int, decode_bucket: int) -> list:
    """Charge one generate/verify call's measured phase walls and score
    its programs on the roofline. Returns per-row chip-ms (len ``n``).

    Reads ``engine.last_prefill_s`` / ``engine.last_decode_s`` — the
    walls :meth:`_record_telemetry` also reads — and the thread-local
    row keys the batcher declared. Read-only: never touches RNG,
    device state, or row content."""
    if not _STATE.enabled:
        _TLS.row_keys = None
        return [0.0] * n
    keys = _take_row_keys(n)
    led = ledger_for(engine.cfg.name)
    stage_a = "verify" if verify else "prefill"
    a = led.charge(stage_a, engine.last_prefill_s, prefill_weights, keys,
                   padded_prefill)
    b = led.charge("verify" if verify else "decode", engine.last_decode_s,
                   decode_weights, keys, padded_decode)
    rf = roofline_for(engine)
    rf.observe(stage_a, sum(int(w) for w in prefill_weights), 1,
               cache_len, engine.last_prefill_s, prefill_bucket)
    if not verify:
        steps = max((int(w) for w in decode_weights), default=0)
        rf.observe("decode", sum(int(w) for w in decode_weights), steps,
                   cache_len, engine.last_decode_s, decode_bucket)
    return [(x + y) / 1e6 for x, y in zip(a, b)]


def charge_restore(model: str, wall_ms: float,
                   source: str = "host") -> None:
    """Charge a KV tier restore's wall to the model's ledger (stage
    ``restore``, unattributed key — the restore path predates row
    context). ``source`` is the rung restored from; calibration fits
    the sim's per-rung penalties from it. Called from
    serving/kvtier.py beside KV_RESTORE_MS."""
    if not _STATE.enabled or wall_ms <= 0:
        return
    led = ledger_for(model)
    led.charge("restore", wall_ms / 1e3, [1], [DEFAULT_KEY], 1)
    led.note_restore_source(source, int(round(wall_ms * 1e6)))


# ---------------------------------------------------------------------------
# Error budgets
# ---------------------------------------------------------------------------

# Per-class SLO availability targets: the fraction of scored requests
# that must NOT be errors (sheds, deadline drops). Matches the QoS
# plane's class vocabulary (serving/qos.py).
SLO_TARGETS: dict = {"interactive": 0.999, "agent": 0.995, "batch": 0.99}
_DEFAULT_TARGET = 0.99

# Multi-window burn alerting (SRE workbook): (window name, seconds,
# alert threshold). Fast catches cliff outages, slow catches slow leaks.
WINDOWS: tuple = (("1h", 3600.0, 14.4), ("6h", 21600.0, 6.0))
_BUCKET_S = 60.0                      # sub-window resolution


class BudgetTracker:
    """Per-(tenant, class) error-budget windows from caller-passed
    monotonic timestamps. Deterministic by the chaos-plane rules: no
    wall clock in any decision, trip ids are sha256 of the trip count,
    and identical (tenant, cls, ok, t) sequences reproduce identical
    trips. Flight/metric emission happens outside the lock."""

    def __init__(self) -> None:
        self._lock = named_lock("costobs")
        # (tenant, cls) -> {minute bucket -> [ok, err]}
        self._cells: dict[tuple, dict] = {}
        self._latest: float = 0.0
        self._trips: dict[tuple, int] = {}        # (tenant,cls,win) -> n
        self._tripped: set = set()

    def _reset(self) -> None:
        with self._lock:
            self._cells.clear()
            self._trips.clear()
            self._tripped.clear()
            self._latest = 0.0

    @staticmethod
    def _burn(buckets: dict, latest: float, horizon_s: float,
              target: float) -> tuple:
        """(burn rate, ok, err) over [latest - horizon, latest]."""
        lo = int((latest - horizon_s) // _BUCKET_S)
        ok = err = 0
        for b, (o, e) in buckets.items():
            if b >= lo:
                ok += o
                err += e
        total = ok + err
        if total <= 0:
            return 0.0, ok, err
        allowance = max(1e-9, 1.0 - target)
        return (err / total) / allowance, ok, err

    def record(self, tenant: str, cls: str, ok: bool, t: float) -> None:
        """Score one request outcome at monotonic time ``t``."""
        if not _STATE.enabled:
            return
        tenant, cls = str(tenant or "-"), str(cls or "-")
        key = (tenant, cls)
        target = SLO_TARGETS.get(cls, _DEFAULT_TARGET)
        fired: list[tuple] = []
        burns: dict[str, float] = {}
        with self._lock:
            self._latest = max(self._latest, t)
            buckets = self._cells.setdefault(key, {})
            b = int(t // _BUCKET_S)
            cell = buckets.setdefault(b, [0, 0])
            cell[1 if not ok else 0] += 1
            # prune beyond the longest window (+1 bucket of slack)
            lo = int((self._latest - WINDOWS[-1][1]) // _BUCKET_S) - 1
            for stale in [x for x in buckets if x < lo]:
                del buckets[stale]
            for win, horizon, threshold in WINDOWS:
                burn, _, _ = self._burn(buckets, self._latest, horizon,
                                        target)
                burns[win] = burn
                tkey = key + (win,)
                if burn > threshold:
                    if tkey not in self._tripped:
                        self._tripped.add(tkey)
                        n = self._trips[tkey] = self._trips.get(tkey,
                                                                0) + 1
                        trip_id = hashlib.sha256(
                            f"{tenant}:{cls}:{win}:{n}".encode()
                        ).hexdigest()[:12]
                        fired.append((win, threshold, burn, trip_id))
                else:
                    self._tripped.discard(tkey)
        # gauges + flight outside the budget lock
        from quoracle_tpu_torch.infra.telemetry import (
            BUDGET_BURN_RATE, BUDGET_EVENTS_TOTAL, BUDGET_REMAINING_RATIO,
        )
        BUDGET_EVENTS_TOTAL.inc(cls=cls, outcome="ok" if ok else "error")
        for win, burn in burns.items():
            BUDGET_BURN_RATE.set(round(burn, 4), tenant=tenant, cls=cls,
                                 window=win)
        BUDGET_REMAINING_RATIO.set(
            round(max(0.0, 1.0 - burns.get("6h", 0.0)), 4),
            tenant=tenant, cls=cls)
        if fired:
            from quoracle_tpu_torch.infra.flightrec import FLIGHT
            for win, threshold, burn, trip_id in fired:
                FLIGHT.record("budget_burn", trip_id=trip_id,
                              tenant=tenant, cls=cls, window=win,
                              burn=round(burn, 3), threshold=threshold)
            # burn-triggered capture: every trip opens a
            # deterministic-id incident with profiles + stacks fanned
            # across the fabric — strictly after our lock released
            from quoracle_tpu_torch.infra import introspect
            for win, _threshold, burn, trip_id in fired:
                introspect.on_burn_trip(tenant=tenant, cls=cls,
                                        window=win, trip_id=trip_id,
                                        burn=burn)

    def snapshot(self) -> dict:
        """GET /api/budget payload: per-(tenant, class) window burns,
        remaining budget, and the trip ledger."""
        with self._lock:
            cells = {k: dict(v) for k, v in self._cells.items()}
            latest = self._latest
            trips = dict(self._trips)
        out: dict = {"latest_t": round(latest, 3), "tenants": {}}
        for (tenant, cls), buckets in sorted(cells.items()):
            target = SLO_TARGETS.get(cls, _DEFAULT_TARGET)
            wins = {}
            for win, horizon, threshold in WINDOWS:
                burn, ok, err = self._burn(buckets, latest, horizon,
                                           target)
                wins[win] = {"burn": round(burn, 4), "ok": ok,
                             "err": err, "threshold": threshold,
                             "tripping": burn > threshold}
            ent = out["tenants"].setdefault(tenant, {})
            ent[cls] = {
                "slo": target, "windows": wins,
                "remaining_ratio": round(max(
                    0.0, 1.0 - wins["6h"]["burn"]), 4),
                "trips": {w: trips.get((tenant, cls, w), 0)
                          for w, _, _ in WINDOWS},
            }
        return out

    def burn_signals(self) -> dict:
        """{class: max burn over tenants and windows} — the compact
        OBSERVED signal handed to AdmissionController.signals() and
        FleetSignals (read-only yet; the adaptive-consensus and
        elastic-fleet roadmap items will act on it)."""
        with self._lock:
            cells = {k: dict(v) for k, v in self._cells.items()}
            latest = self._latest
        out: dict = {}
        for (_tenant, cls), buckets in cells.items():
            target = SLO_TARGETS.get(cls, _DEFAULT_TARGET)
            for _win, horizon, _thr in WINDOWS:
                burn, _, _ = self._burn(buckets, latest, horizon, target)
                out[cls] = max(out.get(cls, 0.0), round(burn, 4))
        return out


BUDGET = BudgetTracker()


# ---------------------------------------------------------------------------
# Process rollup (federation + /api/costs)
# ---------------------------------------------------------------------------


def total_chip_ms() -> float:
    """This process's total charged chip-ms across models — exported
    through federation (infra/fleetobs.py) so the front door can compute fleet
    goodput per chip-second from sweep deltas."""
    return sum(led.busy_ns() for led in ledgers().values()) / 1e6


def costs_payload() -> dict:
    """GET /api/costs chip-economics block: per-model ledger rollups
    beside the nominal Decimal billing the endpoint already carries."""
    return {
        "enabled": _STATE.enabled,
        "total_chip_ms": round(total_chip_ms(), 3),
        "models": {name: led.snapshot()
                   for name, led in sorted(ledgers().items())},
    }
