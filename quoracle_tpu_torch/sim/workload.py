"""Deterministic fleet-workload model (port of
``quoracle_tpu/sim/workload.py``).

A trace is byte for byte the JAX package's JSON for the same spec and
seed: the same draws, the same canonical serialization.

A trace is a SORTED list of arrival events generated from a
:class:`WorkloadSpec` by pure seeded draws — the chaos plane's seeding
idiom (ARCHITECTURE §14): every draw is
``sha256(f"{seed}:{stream}:{n}")`` with ``n`` a per-stream counter, so
concurrent stream generation order cannot perturb the schedule and the
same spec reproduces the same bytes on any host. No wall clock, no
``random``, no process-salted ``hash()``.

Four composable stream families:

* **tenants** — Poisson-ish arrivals whose rate follows a diurnal
  intensity curve (inverse-transform exponential inter-arrivals against
  the instantaneous rate);
* **storms** — bounded burst windows multiplying one tenant's rate;
* **agent trees** — recursive spawn fan-outs (the source app's spawn
  recursion): a root request spawns ``branching[d]`` children at depth
  ``d``, each carrying that depth's consensus K;
* **long tail** — O(100k) virtual sessions, most touched once and then
  hibernated, whose reactivation inter-arrivals are drawn from a
  heavy-tailed per-session rate so replay exercises the full
  HBM→host→disk→prefixd tier ladder.

Serialization is canonical (sorted keys, no whitespace, ints only in
event rows), so *byte*-identical traces under the same seed is a
checkable contract, not an accident of dict ordering.

The ``bench_*`` helpers at the bottom build the prompt mixes of the JAX
package's benchmark configs 11/20/22 from simulator traces, kept so a
benchmark of the port can draw the same mixes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Optional, Sequence

# priority classes as they appear in traces (stable strings, mapped to
# serving/qos.Priority only at replay time)
CLASSES = ("interactive", "agent", "batch")

_U64 = float(1 << 64)


def draw(seed: int, stream: str, n: int) -> float:
    """Uniform [0, 1) from sha256(seed:stream:n) — the chaos plane's
    seeding idiom, shared verbatim so one contract covers both planes."""
    digest = hashlib.sha256(f"{seed}:{stream}:{n}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / _U64


def draw_exp(seed: int, stream: str, n: int, mean: float) -> float:
    """Exponential with the given mean (inverse transform)."""
    u = draw(seed, stream, n)
    return -mean * math.log(1.0 - u)


def draw_int(seed: int, stream: str, n: int, lo: int, hi: int) -> int:
    """Integer in [lo, hi] inclusive."""
    if hi <= lo:
        return lo
    return lo + int(draw(seed, stream, n) * (hi - lo + 1))


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant population with a diurnal intensity curve."""

    name: str
    rate_per_s: float                     # mean arrivals/s at intensity 1
    diurnal_amplitude: float = 0.0        # 0 = flat, 1 = full swing
    peak_hour: float = 12.0               # virtual hour of peak intensity
    mix: tuple = (("interactive", 1.0),)  # ((class, weight), ...)
    prompt_tokens: tuple = (32, 96)       # [lo, hi] drawn per event
    max_new_tokens: tuple = (8, 32)


@dataclasses.dataclass(frozen=True)
class StormSpec:
    """A burst window multiplying one tenant's arrival rate."""

    tenant: str
    t_start_ms: int
    duration_ms: int
    multiplier: float = 8.0


@dataclasses.dataclass(frozen=True)
class AgentTreeSpec:
    """Recursive spawn fan-out: roots arrive on a fixed cadence; a node
    at depth d spawns ``branching[d]`` children after a drawn delay,
    each carrying ``consensus_k[d+1]`` (the per-depth consensus K)."""

    n_roots: int
    root_every_ms: int
    branching: tuple = (3, 2)             # children per node per depth
    consensus_k: tuple = (3, 2, 1)        # K at depth 0, 1, 2, ...
    spawn_delay_ms: tuple = (20, 200)     # [lo, hi] child delay
    tenant: str = "agents"
    prompt_tokens: tuple = (48, 128)
    max_new_tokens: tuple = (16, 48)


@dataclasses.dataclass(frozen=True)
class LongTailSpec:
    """O(100k) virtual sessions: each is established once, then
    reactivates ``~Poisson(mean_reactivations × pareto(alpha))`` times —
    a heavy tail where most sessions hibernate forever and a few stay
    hot, which is exactly the population the tier ladder exists for."""

    n_sessions: int
    mean_reactivations: float = 0.3
    heavy_tail_alpha: float = 1.3         # pareto shape for per-session rate
    establish_frac: float = 0.5           # establishes land in this first
                                          # fraction of the horizon
    tenant: str = "longtail"
    prompt_tokens: tuple = (24, 64)
    max_new_tokens: tuple = (4, 16)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    seed: int
    horizon_ms: int
    tenants: tuple = ()
    storms: tuple = ()
    agent_trees: tuple = ()
    longtail: Optional[LongTailSpec] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        def _tup(v):
            return tuple(tuple(x) if isinstance(x, list) else x
                         for x in v)
        lt = d.get("longtail")
        return cls(
            seed=int(d["seed"]), horizon_ms=int(d["horizon_ms"]),
            tenants=tuple(TenantSpec(**{**t,
                                        "mix": _tup(t.get("mix", ())),
                                        "prompt_tokens": tuple(
                                            t.get("prompt_tokens",
                                                  (32, 96))),
                                        "max_new_tokens": tuple(
                                            t.get("max_new_tokens",
                                                  (8, 32)))})
                          for t in d.get("tenants", ())),
            storms=tuple(StormSpec(**s) for s in d.get("storms", ())),
            agent_trees=tuple(
                AgentTreeSpec(**{**a,
                                 "branching": tuple(a.get("branching",
                                                          (3, 2))),
                                 "consensus_k": tuple(
                                     a.get("consensus_k", (3, 2, 1))),
                                 "spawn_delay_ms": tuple(
                                     a.get("spawn_delay_ms", (20, 200))),
                                 "prompt_tokens": tuple(
                                     a.get("prompt_tokens", (48, 128))),
                                 "max_new_tokens": tuple(
                                     a.get("max_new_tokens", (16, 48)))})
                for a in d.get("agent_trees", ())),
            longtail=(None if lt is None else LongTailSpec(
                **{**lt,
                   "prompt_tokens": tuple(lt.get("prompt_tokens",
                                                 (24, 64))),
                   "max_new_tokens": tuple(lt.get("max_new_tokens",
                                                  (4, 16)))})),
        )


# ---------------------------------------------------------------------------
# Events & trace
# ---------------------------------------------------------------------------

# default per-class SLO deadline attached to every event (ms of modeled
# TTFT the class tolerates before the row is deadline-shed)
CLASS_DEADLINE_MS = {"interactive": 1_500, "agent": 6_000, "batch": 0}


@dataclasses.dataclass(frozen=True, slots=True)
class SimEvent:
    """One arrival. ``eid`` is stable across runs (stream-derived, not
    positional), ``depth``/``consensus_k`` carry agent-tree structure,
    and every numeric field is an int so serialization is canonical.
    Slots: a long-tail trace holds O(100k) of these."""

    eid: str
    t_ms: int
    stream: str                           # generator family
    session: str
    tenant: str
    cls: str                              # one of CLASSES
    prompt_tokens: int
    max_new_tokens: int
    deadline_ms: int                      # 0 = none
    depth: int = 0
    consensus_k: int = 1

    def as_row(self) -> list:
        return [self.eid, self.t_ms, self.stream, self.session,
                self.tenant, self.cls, self.prompt_tokens,
                self.max_new_tokens, self.deadline_ms, self.depth,
                self.consensus_k]

    @classmethod
    def from_row(cls, r: Sequence) -> "SimEvent":
        return cls(eid=r[0], t_ms=int(r[1]), stream=r[2], session=r[3],
                   tenant=r[4], cls=r[5], prompt_tokens=int(r[6]),
                   max_new_tokens=int(r[7]), deadline_ms=int(r[8]),
                   depth=int(r[9]), consensus_k=int(r[10]))


class Trace:
    """A generated workload: spec + sorted events, serializable to
    canonical JSON (the reproducible artifact --sim-trace replays)."""

    VERSION = 1

    def __init__(self, spec: WorkloadSpec, events: list):
        self.spec = spec
        self.events = events

    def __len__(self) -> int:
        return len(self.events)

    def to_json(self) -> str:
        return json.dumps(
            {"version": self.VERSION, "spec": self.spec.as_dict(),
             "events": [e.as_row() for e in self.events]},
            sort_keys=True, separators=(",", ":"))

    def digest(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        d = json.loads(text)
        if d.get("version") != cls.VERSION:
            raise ValueError(
                f"unsupported trace version {d.get('version')!r}")
        return cls(WorkloadSpec.from_dict(d["spec"]),
                   [SimEvent.from_row(r) for r in d["events"]])

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path, encoding="utf-8") as f:
            return cls.from_json(f.read())

    def window_mix(self, t0_ms: int, t1_ms: int) -> dict:
        """Per-class offered arrival rate (events/s) in [t0, t1) — the
        traffic-mix prior the forecast seam feeds FleetSignals (shadow
        mode: the policy records it, never acts on it yet)."""
        span_s = max(1e-9, (t1_ms - t0_ms) / 1000.0)
        counts = {c: 0 for c in CLASSES}
        for e in self.events:             # events are sorted by t_ms
            if e.t_ms >= t1_ms:
                break
            if e.t_ms >= t0_ms:
                counts[e.cls] += 1
        return {c: round(n / span_s, 4) for c, n in counts.items()}

    def stats(self) -> dict:
        by_stream: dict = {}
        by_cls = {c: 0 for c in CLASSES}
        sessions = set()
        for e in self.events:
            by_stream[e.stream] = by_stream.get(e.stream, 0) + 1
            by_cls[e.cls] += 1
            sessions.add(e.session)
        return {"events": len(self.events), "sessions": len(sessions),
                "by_stream": by_stream, "by_class": by_cls,
                "horizon_ms": self.spec.horizon_ms,
                "seed": self.spec.seed, "digest": self.digest()}


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


def _intensity(t_ms: int, spec: TenantSpec) -> float:
    """Diurnal curve: 1 + amplitude·cos(2π·(hour − peak)/24), floored at
    a 5% trickle so inter-arrival means stay finite."""
    if spec.diurnal_amplitude <= 0.0:
        return 1.0
    hour = (t_ms / 3_600_000.0) % 24.0
    factor = 1.0 + spec.diurnal_amplitude * math.cos(
        2.0 * math.pi * (hour - spec.peak_hour) / 24.0)
    return max(0.05, factor)


def _storm_multiplier(t_ms: int, tenant: str, storms) -> float:
    m = 1.0
    for s in storms:
        if (s.tenant == tenant and s.t_start_ms <= t_ms
                < s.t_start_ms + s.duration_ms):
            m *= s.multiplier
    return m


def _pick_class(u: float, mix) -> str:
    total = sum(w for _, w in mix)
    acc = 0.0
    for cls, w in mix:
        acc += w / total
        if u < acc:
            return cls
    return mix[-1][0]


def _event(seed: int, stream: str, n: int, t_ms: int, session: str,
           tenant: str, cls: str, ptok: tuple, ntok: tuple,
           depth: int = 0, k: int = 1) -> SimEvent:
    return SimEvent(
        eid=f"{stream}/{n}", t_ms=int(t_ms), stream=stream,
        session=session, tenant=tenant, cls=cls,
        prompt_tokens=draw_int(seed, f"{stream}:ptok", n, *ptok),
        max_new_tokens=draw_int(seed, f"{stream}:ntok", n, *ntok),
        deadline_ms=CLASS_DEADLINE_MS.get(cls, 0), depth=depth,
        consensus_k=k)


def tree_id_of(e) -> str:
    """Agent-tree lineage id for a trace event:
    tree sessions are named ``tree{idx}-r{r}`` at the root and
    ``{parent}.{c}`` down the spawn chain, so the root segment before
    the first dot IS the tree id. Non-tree events (any stream other
    than ``tree:*``) carry no lineage — empty string."""
    if not getattr(e, "stream", "").startswith("tree:"):
        return ""
    return e.session.split(".", 1)[0]


def _gen_tenant(spec: WorkloadSpec, t: TenantSpec, out: list) -> None:
    stream = f"tenant:{t.name}"
    n = 0
    t_ms = 0.0
    while True:
        rate = (t.rate_per_s * _intensity(int(t_ms), t)
                * _storm_multiplier(int(t_ms), t.name, spec.storms))
        t_ms += 1000.0 * draw_exp(spec.seed, stream, n, 1.0 / rate)
        if t_ms >= spec.horizon_ms:
            break
        cls = _pick_class(draw(spec.seed, f"{stream}:cls", n), t.mix)
        out.append(_event(
            spec.seed, stream, n, t_ms,
            session=f"{t.name}-s{n}", tenant=t.name, cls=cls,
            ptok=t.prompt_tokens, ntok=t.max_new_tokens))
        n += 1


def _gen_tree(spec: WorkloadSpec, idx: int, a: AgentTreeSpec,
              out: list) -> None:
    stream = f"tree:{idx}"
    n = 0

    def k_at(depth: int) -> int:
        if not a.consensus_k:
            return 1
        return a.consensus_k[min(depth, len(a.consensus_k) - 1)]

    def spawn(t_ms: float, depth: int, session: str) -> None:
        nonlocal n
        if t_ms >= spec.horizon_ms:
            return
        out.append(_event(
            spec.seed, stream, n, t_ms, session=session,
            tenant=a.tenant, cls="agent", ptok=a.prompt_tokens,
            ntok=a.max_new_tokens, depth=depth, k=k_at(depth)))
        my_n = n
        n += 1
        if depth >= len(a.branching):
            return
        for c in range(a.branching[depth]):
            delay = draw_int(spec.seed, f"{stream}:delay", my_n * 16 + c,
                             *a.spawn_delay_ms)
            spawn(t_ms + delay, depth + 1, f"{session}.{c}")

    for r in range(a.n_roots):
        jitter = draw_int(spec.seed, f"{stream}:root", r, 0,
                          max(1, a.root_every_ms // 4))
        spawn(r * a.root_every_ms + jitter, 0, f"tree{idx}-r{r}")


def _gen_longtail(spec: WorkloadSpec, lt: LongTailSpec,
                  out: list) -> None:
    stream = "longtail"
    n = 0
    est_span = max(1.0, lt.establish_frac * spec.horizon_ms)
    for s in range(lt.n_sessions):
        session = f"lt-{s}"
        # establish: one arrival somewhere in the first establish_frac
        # of the horizon (the session's birth into the tier ladder)
        t_ms = draw(spec.seed, f"{stream}:est", s) * est_span
        out.append(_event(
            spec.seed, stream, n, t_ms, session=session,
            tenant=lt.tenant, cls="batch", ptok=lt.prompt_tokens,
            ntok=lt.max_new_tokens))
        n += 1
        # heavy-tailed per-session reactivation rate: pareto(alpha)
        # multiplier, so most sessions never reactivate and a hot few
        # reactivate repeatedly
        u = draw(spec.seed, f"{stream}:rate", s)
        mult = (1.0 - u) ** (-1.0 / lt.heavy_tail_alpha)
        lam = lt.mean_reactivations * mult
        # deterministic touch count: floor + bernoulli on the fraction
        touches = int(lam) + (
            1 if draw(spec.seed, f"{stream}:frac", s) < (lam - int(lam))
            else 0)
        touches = min(touches, 64)        # a hot session, not a DoS
        remaining = spec.horizon_ms - t_ms
        if touches <= 0 or remaining <= 0:
            continue
        mean_gap = remaining / (touches + 1)
        for j in range(touches):
            t_ms += draw_exp(spec.seed, f"{stream}:gap",
                             s * 64 + j, mean_gap)
            if t_ms >= spec.horizon_ms:
                break
            out.append(_event(
                spec.seed, stream, n, t_ms, session=session,
                tenant=lt.tenant, cls="interactive",
                ptok=lt.prompt_tokens, ntok=lt.max_new_tokens))
            n += 1


def generate(spec: WorkloadSpec) -> Trace:
    """Expand a spec into a sorted, reproducible trace. Stream draws are
    independent, so the merge order below cannot perturb any stream's
    schedule; the final sort key includes the eid to keep simultaneous
    arrivals in a canonical order."""
    events: list = []
    for t in spec.tenants:
        _gen_tenant(spec, t, events)
    for i, a in enumerate(spec.agent_trees):
        _gen_tree(spec, i, a, events)
    if spec.longtail is not None:
        _gen_longtail(spec, spec.longtail, events)
    events.sort(key=lambda e: (e.t_ms, e.eid))
    return Trace(spec, events)


# ---------------------------------------------------------------------------
# Canonical specs (the tier-1 scenario traces + --sim-seed default)
# ---------------------------------------------------------------------------


def canonical_spec(name: str, seed: int = 0,
                   scale: float = 1.0) -> WorkloadSpec:
    """The four named workloads tier-1 replays (sim/gate.py). ``scale``
    shrinks/grows populations for bench smoke vs live runs."""
    if name == "diurnal_mix":
        return WorkloadSpec(
            seed=seed, horizon_ms=int(4 * 3_600_000 * scale),
            tenants=(
                TenantSpec("humans", rate_per_s=0.05,
                           diurnal_amplitude=0.8, peak_hour=2.0,
                           mix=(("interactive", 0.8), ("agent", 0.2))),
                TenantSpec("pipelines", rate_per_s=0.03,
                           diurnal_amplitude=0.4, peak_hour=14.0,
                           mix=(("batch", 0.9), ("agent", 0.1))),
            ))
    if name == "storm":
        horizon = int(1_200_000 * scale)
        return WorkloadSpec(
            seed=seed, horizon_ms=horizon,
            tenants=(
                TenantSpec("humans", rate_per_s=0.2,
                           mix=(("interactive", 1.0),)),
                TenantSpec("bulk", rate_per_s=0.3,
                           mix=(("batch", 1.0),)),
            ),
            storms=(StormSpec("bulk", t_start_ms=horizon // 3,
                              duration_ms=horizon // 3,
                              multiplier=12.0),))
    if name == "agent_tree":
        return WorkloadSpec(
            seed=seed, horizon_ms=600_000,
            agent_trees=(AgentTreeSpec(
                n_roots=max(1, int(24 * scale)), root_every_ms=20_000,
                branching=(3, 2), consensus_k=(3, 2, 1)),))
    if name == "longtail_ladder":
        return WorkloadSpec(
            seed=seed, horizon_ms=24 * 3_600_000,
            tenants=(TenantSpec("humans", rate_per_s=0.002,
                                mix=(("interactive", 1.0),)),),
            longtail=LongTailSpec(
                n_sessions=max(1, int(100_000 * scale))))
    raise ValueError(f"unknown canonical workload {name!r}; "
                     f"have diurnal_mix, storm, agent_tree, "
                     f"longtail_ladder")


CANONICAL = ("diurnal_mix", "storm", "agent_tree", "longtail_ladder")


# ---------------------------------------------------------------------------
# Bench mixes (the prompt mixes of benchmark configs 11/20/22)
# ---------------------------------------------------------------------------


def bench_trace(kind: str, n: int, seed: int = 2026,
                spacing_ms: int = 1_000) -> Trace:
    """A tiny evenly-spaced single-stream trace: the simulator source
    for a benchmark's fixed-count phases (each bench row is one event; the
    event's stream counter indexes its prompt text)."""
    cls = {"interactive": "interactive", "session": "agent",
           "batch": "batch"}[kind]
    spec = WorkloadSpec(seed=seed, horizon_ms=(n + 1) * spacing_ms)
    events = [_event(seed, f"bench:{kind}", i, i * spacing_ms,
                     session=f"bench-{kind}-{i}", tenant="bench",
                     cls=cls, ptok=(32, 96), ntok=(8, 32))
              for i in range(n)]
    return Trace(spec, events)


def bench_overload_mix(tasks: Sequence[str], n_interactive: int,
                       seed: int = 2026) -> dict:
    """Config 11's prompt mix: one long background BATCH prompt + the
    interactive turns, text indexed by the trace's event counters
    (formerly a hand-rolled loop in measure_qos_overload)."""
    tr = bench_trace("interactive", n_interactive, seed=seed)
    return {
        "batch_text": "background agent subtree task: "
                      + max(tasks, key=len),
        "interactive_texts": [
            f"[user turn {i}] {tasks[i % len(tasks)]}"
            for i, _ in enumerate(tr.events)],
        "trace": tr,
    }


def bench_fleet_mix(tasks: Sequence[str], n_interactive: int,
                    n_sessions: int, seed: int = 2026) -> dict:
    """Config 20's mixed traffic: short INTERACTIVE message rows + the
    sessioned AGENT working-state rows (formerly hand-rolled lists in
    measure_fleet), sourced from two tiny traces."""
    ti = bench_trace("interactive", n_interactive, seed=seed)
    ts = bench_trace("session", n_sessions, seed=seed + 1)
    return {
        "inter_msgs": [
            [{"role": "user",
              "content": f"[user {i}] {tasks[i % len(tasks)][:48]}"}]
            for i, _ in enumerate(ti.events)],
        "sess_msgs": [
            [{"role": "user",
              "content": f"[agent {i}] working state: "
                         + " ".join(tasks)[:384]}]
            for i, _ in enumerate(ts.events)],
        "traces": (ti, ts),
    }


def event_prompt_text(e: SimEvent) -> str:
    """The deterministic prompt text an engine-backed sampled replay
    submits for one event — a pure function of the event, so two
    replays of the same trace submit identical requests."""
    return (f"[sim {e.stream} {e.eid}] session {e.session} depth "
            f"{e.depth} k {e.consensus_k}: summarize the current plan "
            f"in one line.")
