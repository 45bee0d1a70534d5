"""ModelBackend, the seam between the consensus layer and model execution,
and its two implementations in the PyTorch port (port of
``quoracle_tpu/models/runtime.py``).

``ModelBackend`` is the contract the port's consensus engine types
against. ``TorchBackend.query`` receives a whole consensus round and
groups its rows per pool member; with ``overlap`` (the default, as in the
JAX backend) each member's share runs on its own host thread. A member's
rows go through its ``_MemberBatcher``, the JAX backend's baton batcher:
rounds that concurrent callers send to the same member merge into ONE
``GenerateEngine.generate``. Rows are built exactly as the JAX
``TPUBackend`` builds them (chat template, session splice, per-row
overflow and deadline errors, output budget), so both packages send the
same token ids to their engines; a row whose deadline lapses while it
waits for the baton is dropped with ``DeadlineExceededError``.
``continuous=True`` serves instead through one ``ContinuousBatcher`` per
member (models/scheduler.py): rows join and leave a shared decode loop
every ``continuous_chunk`` tokens. ``qos`` puts that loop behind the
serving QoS layer, as in the JAX backend: one ``AdmissionController`` and
one ``SLOTracker`` shared by the members, one ``WeightedFairPolicy`` per
member (serving/).
``draft_map`` serves drafted members speculatively (models/
speculative.py), as the JAX backend does: under ``continuous`` each one's
loop gets a ``BatchedSpeculator``; in baton mode a single uncontended text
row goes through the member's batch-1 ``SpeculativeDecoder``.
``embed`` runs the on-device ``EmbeddingEncoder`` (models/embeddings.py).
``host_kv_mb`` / ``disk_kv_dir`` attach tiered KV (serving/kvtier.py) to
every pool member, as in the JAX backend: eviction demotes sessions to
host memory, a touch restores them by page-in, prefix blocks persist to a
disk store a restarted process warms from; ``kv_stats`` and
``prefetch_sessions`` report and warm them.
Observability as in the JAX backend: each member's slice of a round runs
under a ``backend.member`` span, parented on the caller's span (the
consensus round) across the member-thread hop, with the member's phase
walls emitted as retroactive ``generate.prefill``/``generate.decode``
spans; the rows carry their chip-ms keys (``task_id``, ``decide``, tenant
and class) to the engine's charge site, and ``QueryResult.chip_ms`` is
the row's charge. ``attach_bus`` gives the backend an event bus
(infra/bus.py): each query round then broadcasts one ``serving_round``
event on ``TOPIC_SERVING`` with every queried member's phase timings,
free pages and prefix-cache counters, as the JAX backend does.
``MockBackend`` is the scripted test backend, with the JAX mock's
``backend.member`` span. Both backends fire the chaos plane's
``pool.member`` seam at each member's query entry (chaos/faults.py): a
crash fails the member's rows with the structured ``chaos_injected``
text, a garbage directive perturbs its output. Left for later slices:
VLM rows (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import abc
import dataclasses
import logging
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from quoracle_tpu_torch.chaos.faults import CHAOS, InjectedFault
from quoracle_tpu_torch.infra import costobs
from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.resources import effective_headroom_fraction
from quoracle_tpu_torch.infra.telemetry import TRACER
from quoracle_tpu_torch.models import loader
from quoracle_tpu_torch.models.config import OUTPUT_FLOOR, get_model_config
from quoracle_tpu_torch.models.embeddings import (
    EmbeddingEncoder, HashingEmbedder,
)
from quoracle_tpu_torch.models.generate import (
    ContextOverflowError, GenerateEngine, resolve_device,
    splice_session_prompt,
)
from quoracle_tpu_torch.models.scheduler import ContinuousBatcher
from quoracle_tpu_torch.models.speculative import (
    BatchedSpeculator, SpeculativeDecoder,
)
from quoracle_tpu_torch.models.tokenizer import (
    _stringify_content, get_tokenizer,
)
from quoracle_tpu_torch.models.transformer import init_params
from quoracle_tpu_torch.serving.admission import (
    AdmissionController, AdmissionError, DeadlineExceededError,
)
from quoracle_tpu_torch.serving.qos import (
    QoSConfig, WeightedFairPolicy, class_name,
)
from quoracle_tpu_torch.serving.slo import SLOTracker

logger = logging.getLogger(__name__)


def _row_key(r: dict) -> tuple:
    """Chip-ms attribution key of one generate-row dict: integer QoS
    priorities render as class names, the budget plane's vocabulary."""
    return (str(r.get("tenant") or "-"),
            class_name(r.get("priority") if r.get("priority") is not None
                       else 1),
            str(r.get("task_id") or "-"), str(r.get("decide") or "-"))


@dataclasses.dataclass
class QueryRequest:
    """One model's slice of a consensus round. ``deadline_ms`` (relative
    to the ``query`` call) is checked when the row is built and again
    where it waits: by the baton batcher before it serves, by the
    continuous batcher at admission (and by its admission controller).
    ``priority`` orders the baton batcher's per-submission retry and,
    under ``qos``, the weighted-fair queue and the controller's shed
    ladder, which also reads ``tenant``; ``task_id`` and ``decide`` are
    the row's chip-ms attribution keys, ``tree`` its tree context
    (infra/treeobs.py); ``trace`` is a compact trace context
    ({"trace_id", "span_id"}) a caller from another process stamps, kept
    as in the JAX package. None of them changes what the row computes."""
    model_spec: str                    # "xla:llama-3-8b"
    messages: list[dict]               # chat messages (system injected)
    temperature: float = 1.0
    top_p: float = 1.0
    max_tokens: Optional[int] = None   # None = window - input, capped
    session_id: Optional[str] = None   # KV residency key (the agent id)
    constrain_json: bool = False       # grammar-masked JSON sampling
    action_enum: Optional[tuple] = None
    tenant: str = "default"
    priority: Optional[int] = None
    deadline_ms: Optional[float] = None
    trace: Optional[dict] = None
    task_id: Optional[str] = None
    decide: Optional[str] = None
    tree: Optional[dict] = None


@dataclasses.dataclass
class Usage:
    prompt_tokens: int = 0
    completion_tokens: int = 0
    cost: float = 0.0


@dataclasses.dataclass
class QueryResult:
    """One row's answer. ``spec_rounds`` and ``spec_accepted_tokens``
    count the draft/verify rounds the row rode and the draft tokens the
    target accepted (0 without speculation); ``chip_ms`` is the row's
    share of the measured device wall of the steps it rode
    (infra/costobs.py; 0.0 with accounting off and on the batch-1
    speculative decoder, which runs its own steps)."""
    model_spec: str
    text: str = ""
    usage: Usage = dataclasses.field(default_factory=Usage)
    latency_ms: float = 0.0
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    cached_tokens: int = 0     # prompt tokens served from resident KV
    spec_rounds: int = 0
    spec_accepted_tokens: int = 0
    chip_ms: float = 0.0
    error: Optional[str] = None        # None = success
    permanent_error: bool = False

    @property
    def ok(self) -> bool:
        return self.error is None


class ModelBackend(abc.ABC):
    """What the consensus layer depends on. All methods are synchronous and
    thread-safe."""

    @abc.abstractmethod
    def query(self, requests: Sequence[QueryRequest]) -> list[QueryResult]: ...

    @abc.abstractmethod
    def embed(self, texts: Sequence[str]) -> list[np.ndarray]: ...

    @abc.abstractmethod
    def count_tokens(self, model_spec: str, text: str) -> int: ...

    def count_message_tokens(self, model_spec: str, messages: Sequence[dict]) -> int:
        total = 0
        for m in messages:
            content = m.get("content", "")
            if not isinstance(content, str):
                content = _stringify_content(content)
            total += self.count_tokens(model_spec, content) + 4  # role overhead
        return total

    @abc.abstractmethod
    def context_window(self, model_spec: str) -> int: ...

    @abc.abstractmethod
    def output_limit(self, model_spec: str) -> int: ...

    def drop_session(self, session_id: str,
                     model_specs: Optional[Sequence[str]] = None) -> None:
        """Release resident KV state for a conversation (called on agent
        termination / pool switch). ``model_specs`` limits the drop to those
        members' engines. No-op for backends without KV residency."""

    def attach_bus(self, bus) -> None:
        """Optional: give the backend an event bus to broadcast serving
        telemetry on. No-op for backends without serving internals."""

    def watchdog_sources(self) -> list:
        """(name, progress_fn) pairs for a stall watchdog. Empty for
        backends without decode loops to watch."""
        return []

    def scheduler_stats(self) -> dict:
        """Per-member continuous-batcher health snapshots. Empty for
        backends without a scheduler."""
        return {}

    def qos_stats(self) -> dict:
        """Serving-QoS snapshot. ``enabled`` False for backends without
        QoS wiring."""
        return {"enabled": False}

    def spec_stats(self) -> dict:
        """Speculative-serving snapshot. ``enabled`` False for backends
        without draft models."""
        return {"enabled": False}

    def kv_stats(self) -> dict:
        """Tiered-KV snapshot. ``enabled`` False for backends without
        tiering."""
        return {"enabled": False}

    def prefetch_sessions(self, session_id: str) -> int:
        """Warm hibernated KV for a conversation before it runs. Returns
        engines warmed. No-op for backends without tiering."""
        return 0


class _MemberBatcher:
    """Baton batching for one pool member (the JAX backend's
    ``_MemberBatcher``): concurrent consensus rounds (different agents,
    same model) coalesce into ONE ``engine.generate``.

    The serve lock's holder drains EVERYTHING queued while it served, so
    contention itself is the batching signal and an uncontended call
    waits for nothing (no timer window). The holder runs the batch on its
    own thread; every other caller polls the lock and waits on its own
    futures."""

    def __init__(self, engine: GenerateEngine):
        self.engine = engine
        self._serve = named_lock("member.serve")
        self._plock = named_lock("member.pending")
        # pending SUBMISSIONS (one per query() caller), not flattened rows:
        # a merged-batch failure can then retry per submission, keeping one
        # agent's pathological round from poisoning its neighbours'
        self._pending: list[tuple[list[dict], list[Future]]] = []

    def submit(self, rows: list[dict]) -> list[Future]:
        """rows: per-row generate kwargs dicts. Returns Futures resolving
        to (GenResult, prefill_ms, decode_ms): the phase timings snapshot
        at serve time (a later batch overwrites the engine's last_*)."""
        futs = [Future() for _ in rows]
        with self._plock:
            self._pending.append((rows, futs))
        while not all(f.done() for f in futs):
            if self._serve.acquire(blocking=False):
                try:
                    self._drain(mine=futs)
                finally:
                    self._serve.release()
            else:
                # another thread holds the baton and will drain us; the
                # short timeout covers the window where it swept pending
                # just before our enqueue
                wait(futs, timeout=0.005)
        return futs

    def _generate(self, subs: list[tuple[list[dict], list[Future]]]) -> None:
        pairs = [(r, f) for sub_rows, sub_futs in subs
                 for r, f in zip(sub_rows, sub_futs)]
        # a row whose deadline lapsed while it waited for the baton fails
        # here; the batch runs without it rather than decoding dead work
        live: list = []
        now = time.monotonic()
        for r, f in pairs:
            dl = r.get("deadline_s")
            if dl is not None and now >= dl:
                if not f.done():
                    f.set_exception(DeadlineExceededError(
                        "deadline passed before the member batch served "
                        "this row", tenant=r.get("tenant"),
                        priority=r.get("priority")))
            else:
                live.append((r, f))
        if not live:
            return
        rows = [r for r, _ in live]
        # declare the merged batch's chip-ms keys on the serving thread
        # for the engine's charge site
        costobs.set_row_keys([_row_key(r) for r in rows])
        gens = self.engine.generate(
            [r["prompt"] for r in rows],
            temperature=[r["temperature"] for r in rows],
            top_p=[r["top_p"] for r in rows],
            max_new_tokens=[r["budget"] for r in rows],
            session_ids=([r["session_id"] for r in rows]
                         if any(r["session_id"] for r in rows) else None),
            constrain_json=([r["constrain_json"] for r in rows]
                            if any(r["constrain_json"] for r in rows)
                            else None),
            action_enums=([r["action_enum"] for r in rows]
                          if any(r["action_enum"] for r in rows) else None))
        phases = (self.engine.last_prefill_s * 1000,
                  self.engine.last_decode_s * 1000)
        for (_, f), g in zip(live, gens):
            f.set_result((g, *phases))

    def _drain(self, mine: list[Future]) -> None:
        # Serve until OUR futures are done (plus whatever queued alongside
        # them), then stop: the remaining submitters poll the baton
        # themselves, so no thread becomes the member's permanent server.
        while not all(f.done() for f in mine):
            with self._plock:
                subs, self._pending = self._pending[:], []
            if not subs:
                return
            # urgent submissions first; all of a drain's submissions still
            # merge into one generate, so the order only matters for the
            # per-submission retry (a stable sort keeps arrival order
            # within a class). ``or 1`` as in the JAX backend.
            subs.sort(key=lambda s: min(
                (r.get("priority") or 1 for r in s[0]), default=1))
            try:
                self._generate(subs)
            except Exception:
                # merged batch failed: retry per SUBMISSION so only the
                # failing caller's rows error
                for sub in subs:
                    try:
                        self._generate([sub])
                    except Exception as e:
                        for f in sub[1]:
                            if not f.done():
                                f.set_exception(e)
            # no drained future may stay pending: its caller would poll
            # the baton forever
            for _, futs in subs:
                for f in futs:
                    if not f.done():
                        f.set_exception(RuntimeError(
                            "the member batch returned no result for "
                            "this row"))


class TorchBackend(ModelBackend):
    """Serves a pool of catalog models, one ``GenerateEngine`` each, on
    one device. ``device=None`` means the GPU and raises without one; the
    CPU serves only when asked (``device="cpu"``, the tests). A catalog
    entry with a ``checkpoint_path`` (models/loader.py
    ``register_hf_checkpoint``) serves its checkpoint's bf16 weights and
    its own tokenizer; the others serve random bf16 weights drawn from
    ``torch.Generator``s seeded ``seed + i`` on the device. ``engines``
    hands in prebuilt engines instead. ``quantize_weights`` and ``quantize_kv``
    (int8 serving, models/quant.py) apply to every engine the backend
    builds, as in the JAX backend.

    ``overlap`` (default on, as in the JAX backend) serves each member of
    a round from its own host thread; ``overlap=False`` serves them in
    turn. On one device the members' launches still share the default
    stream, so what overlaps is host work: eager launches, per-step syncs,
    grammar builds. Each member has a baton batcher (``_MemberBatcher``)
    that merges concurrent callers' rounds into one generate.

    ``draft_map`` ({member spec: draft spec}) turns on speculative
    serving for those members, with ``draft_k`` draft tokens a round.
    Draft engines are built like members (from seed ``len(pool) + 100 +
    j`` in the map's sorted order) unless the spec already has an engine
    here (a self-draft reuses the member's), and never serve as pool
    members. Under ``continuous`` each drafted member's loop gets a
    ``BatchedSpeculator``; otherwise the member gets a batch-1
    ``SpeculativeDecoder`` over its own dense caches, which serves a
    single text row when its lock is free (greedy, or sampled at top_p
    1), the baton batcher everything else.

    ``continuous`` replaces round-granularity baton batching with
    DECODE-level continuous batching (models/scheduler.py): each member
    runs a chunked decode loop on its own ``batcher-<model>`` thread that
    concurrent agents' rows join and leave at ``continuous_chunk``-token
    boundaries, up to ``continuous_slots`` rows per step. Many rows share
    each device step there, so a row's prefill/decode phase split is
    reported as 0. ``qos`` (True for the defaults, or a
    serving/qos.QoSConfig) puts each member's loop behind a weighted-fair
    DRR queue with an aging floor, one AdmissionController shared by the
    members (it sheds under overload with structured ``retry_after_ms``
    rejects, its memory signal from infra/resources.py) and one
    SLOTracker that demotes bulk-class weight while the INTERACTIVE tail
    is over target. ``close()`` stops the loops.

    The embedder is built as the JAX backend builds it: ``embedder`` if
    given; else an ``EmbeddingEncoder`` over ``embed_model`` (default: the
    pool's first member), sharing that member's weights and tokenizer when
    it has an engine here, else over its checkpoint or random weights
    drawn on the device from a generator seeded ``seed + 101``.

    ``host_kv_mb`` and ``disk_kv_dir`` (with ``disk_kv_gb``) attach a KV
    tier to every pool member, never to a draft (a draft's shadow sessions
    are cheaper to re-draft than to park): eviction demotes to a
    ``host_kv_mb``-bounded host store (256 MiB when only a disk directory
    is given) and prefix blocks persist under ``disk_kv_dir``. With QoS the
    controller's memory signal then counts the demotable pages as
    headroom; ``close()`` drains the disk spills."""

    def __init__(self, pool: Sequence[str], *, seed: int = 0, device=None,
                 embed_model: Optional[str] = None,
                 engines: Optional[dict[str, GenerateEngine]] = None,
                 embedder=None, overlap: bool = True,
                 continuous: bool = False, continuous_chunk: int = 32,
                 continuous_slots: int = 8, qos=None,
                 draft_map: Optional[dict] = None, draft_k: int = 6,
                 host_kv_mb: int = 0, disk_kv_dir: Optional[str] = None,
                 disk_kv_gb: float = 8.0,
                 quantize_weights: bool = False, quantize_kv: bool = False):
        self.device = resolve_device(device)
        self.pool = list(pool)
        self.overlap = overlap
        self.quantize_weights = bool(quantize_weights)
        self.quantize_kv = bool(quantize_kv)
        self.engines: dict[str, GenerateEngine] = dict(engines or {})
        self._bus = None          # attach_bus: serving-telemetry broadcasts

        def weights(cfg, seed_i: int):
            # an entry with a checkpoint serves its own weights, as in the
            # JAX backend; the others draw random ones
            if cfg.checkpoint_path:
                return loader.load_params(cfg.checkpoint_path, cfg,
                                          device=self.device)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed_i)
            return init_params(cfg, gen, device=self.device)

        def build_engine(spec: str, i: int) -> GenerateEngine:
            cfg = get_model_config(spec)
            params = weights(cfg, seed + i)
            return GenerateEngine(
                cfg, params, get_tokenizer(spec), seed=seed + i,
                device=self.device, quantize_weights=self.quantize_weights,
                quantize_kv=self.quantize_kv)

        for i, spec in enumerate(self.pool):
            if spec not in self.engines:
                self.engines[spec] = build_engine(spec, i)
        # Tiered KV on the pool members only
        self.kv_tiered = bool(host_kv_mb or disk_kv_dir)
        if self.kv_tiered:
            for spec in self.pool:
                self.engines[spec].attach_tier(
                    host_mb=host_kv_mb or 256, disk_dir=disk_kv_dir,
                    disk_gb=disk_kv_gb)
        # Speculative serving: draft engines load like members (and take
        # the same int8 flags) but never serve as pool members themselves
        self.draft_map = dict(draft_map or {})
        self._spec_decoders: dict[str, SpeculativeDecoder] = {}
        self._speculators: dict[str, BatchedSpeculator] = {}
        for j, (tspec, dspec) in enumerate(sorted(self.draft_map.items())):
            if tspec not in self.engines:
                raise KeyError(f"draft_map target {tspec!r} is not in the "
                               f"pool")
            if dspec not in self.engines:
                self.engines[dspec] = build_engine(dspec,
                                                   len(self.pool) + 100 + j)
            te, de = self.engines[tspec], self.engines[dspec]
            if continuous:
                self._speculators[tspec] = BatchedSpeculator(te, de,
                                                             k=draft_k)
            else:
                self._spec_decoders[tspec] = SpeculativeDecoder(
                    te.cfg, te.params, de.cfg, de.params, te.tokenizer,
                    k=draft_k, max_seq=te.max_seq)
        # one baton batcher per POOL member
        self._batchers = {spec: _MemberBatcher(self.engines[spec])
                          for spec in self.pool}
        self.continuous = continuous
        self._cbatchers = {}
        # Serving QoS: ONE controller + SLO tracker shared across members
        # (overload and tail burn are system conditions), one
        # weighted-fair queue per member. qos=True → defaults. With KV
        # tiers the pages the tier ladder could demote count as headroom,
        # so bulk work is not shed for memory it can free on demand.
        self.qos_controller = None
        self.slo = None
        qos_policies: dict = {}
        if qos:
            qcfg = qos if isinstance(qos, QoSConfig) else QoSConfig()
            self.slo = SLOTracker(targets_ms=qcfg.slo_targets_ms)
            self.qos_controller = AdmissionController(
                config=qcfg.admission, tenants=qcfg.tenants,
                headroom_fn=(lambda: effective_headroom_fraction(self))
                if self.kv_tiered else None)
            qos_policies = {
                spec: WeightedFairPolicy(
                    weights=qcfg.weights, quantum=qcfg.quantum,
                    aging_floor_s=qcfg.aging_floor_s,
                    weight_fn=self.slo.weight_multiplier, model=spec)
                for spec in self.pool}
        if continuous:
            self._cbatchers = {
                spec: ContinuousBatcher(self.engines[spec],
                                        chunk=continuous_chunk,
                                        max_slots=continuous_slots,
                                        policy=qos_policies.get(spec),
                                        admission=self.qos_controller,
                                        slo=self.slo,
                                        speculator=self._speculators.get(
                                            spec))
                for spec in self.pool}
            if self.qos_controller is not None:
                for spec, pol in qos_policies.items():
                    self.qos_controller.register_depth_source(
                        spec, pol.qsize)
        if embedder is not None:
            self.embedder = embedder
        else:
            espec = embed_model or self.pool[0]
            if espec in self.engines:
                e = self.engines[espec]
                eparams, ecfg, etok = e.params, e.cfg, e.tokenizer
            else:
                ecfg = get_model_config(espec)
                eparams = weights(ecfg, seed + 101)
                etok = get_tokenizer(espec)
            self.embedder = EmbeddingEncoder(ecfg, eparams, etok)

    def close(self) -> None:
        """Stop the continuous batchers' threads (the baton batchers run
        on their callers' threads). Queued rows fail loudly rather than
        stranding waiters — ContinuousBatcher.close() semantics. Tiered
        engines drain their queued disk spills, so a clean shutdown hands
        its successor every persisted prefix."""
        for cb in self._cbatchers.values():
            cb.close()
        for eng in self.engines.values():
            tier = eng.sessions.tier
            if tier is not None:
                try:
                    tier.flush_spills()
                except Exception:         # noqa: BLE001 — best-effort
                    pass

    def watchdog_sources(self) -> list:
        return [(f"decode-loop:{spec}", cb.progress)
                for spec, cb in self._cbatchers.items()]

    def scheduler_stats(self) -> dict:
        return {spec: cb.stats() for spec, cb in self._cbatchers.items()}

    def swap_draft(self, tspec: str, engine, name: Optional[str] = None):
        """Hot-swap the draft engine behind ``tspec``'s continuous-mode
        speculator and return the incumbent engine (for rollback). The
        caller owns both engines: the swapped-out one is not closed, and
        the backend's ``engines`` keeps its entries. Draft KV is derived
        state: rows re-prefill into the new draft's sessions on their next
        round."""
        speculator = self._speculators.get(tspec)
        if speculator is None:
            raise KeyError(f"no continuous speculator for {tspec!r} "
                           f"(draft_map: {sorted(self.draft_map)})")
        old = speculator.swap_draft(engine)
        self.draft_map[tspec] = name or engine.cfg.name
        return old

    def spec_stats(self) -> dict:
        if not self._speculators and not self._spec_decoders:
            return {"enabled": False}
        members = {spec: s.stats() for spec, s in self._speculators.items()}
        for spec, dec in self._spec_decoders.items():
            # batch-1 decoders keep no rolling scorecard: report the wiring
            members.setdefault(spec, {
                "mode": "batch1", "draft": dec.dc.name, "k": dec.k,
            })
        return {"enabled": True, "draft_map": dict(self.draft_map),
                "members": members}

    def kv_stats(self) -> dict:
        if not self.kv_tiered:
            return {"enabled": False}
        members = {}
        for spec in self.pool:
            e = self.engines[spec]
            st = e.sessions
            tier = st.tier
            if tier is None:
                continue
            with st.lock:
                free = len(st._free)
                n_sessions = len(st._sessions)
                occ = st.prefix_cache.occupancy()
            members[spec] = {
                "hbm": {
                    "pages": st.n_pages,
                    "free_pages": free,
                    "used_pages": st.n_pages - 1 - free,
                    "sessions": n_sessions,
                    "prefix_cache": occ,
                },
                "quant": e.quant_stats(),
                **tier.stats(),
            }
        return {"enabled": True, "members": members}

    def prefetch_sessions(self, session_id: str) -> int:
        if not self.kv_tiered:
            return 0
        return sum(1 for spec in self.pool
                   if self.engines[spec].prefetch_session(session_id))

    def qos_stats(self) -> dict:
        if self.qos_controller is None:
            return {"enabled": False}
        return {
            "enabled": True,
            "admission": self.qos_controller.stats(),
            "slo": self.slo.stats() if self.slo is not None else None,
            "queues": {spec: cb.stats().get("qos")
                       for spec, cb in self._cbatchers.items()},
        }

    def query(self, requests: Sequence[QueryRequest]) -> list[QueryResult]:
        """Group rows by pool member; one batched generate per member
        (merged with concurrent callers' rounds by the member's batcher).
        With ``overlap`` and more than one member, each member is served
        from its own thread; on one device their launches serialize on
        the device queue."""
        by_model: dict[str, list[int]] = {}
        for i, r in enumerate(requests):
            by_model.setdefault(r.model_spec, []).append(i)
        results: list[Optional[QueryResult]] = [None] * len(requests)
        groups = list(by_model.items())
        # the caller's span (the consensus round) is thread-local to THIS
        # thread: capture it here and rebind it in each member thread
        parent = TRACER.current()
        if self.overlap and len(groups) > 1:
            with ThreadPoolExecutor(max_workers=len(groups),
                                    thread_name_prefix="pool-member") as ex:
                list(ex.map(lambda g: self._query_member(
                    g[0], g[1], requests, results, parent), groups))
        else:
            for spec, idxs in groups:
                self._query_member(spec, idxs, requests, results, parent)
        self._broadcast_serving(by_model)
        return [r for r in results if r is not None]

    def attach_bus(self, bus) -> None:
        self._bus = bus

    def _broadcast_serving(self, by_model: dict) -> None:
        """One TOPIC_SERVING event per query round: each queried member's
        phase timings and free pages, and its radix prefix cache's
        counters, as the JAX backend broadcasts them. Never raises into
        the serving path."""
        if self._bus is None:
            return
        try:
            from quoracle_tpu_torch.infra.bus import TOPIC_SERVING
            members = {}
            for spec in by_model:
                e = self.engines.get(spec)
                if e is None:
                    continue
                members[spec] = {
                    "prefill_tokens": e.last_prefill_tokens,
                    "prefill_ms": round(e.last_prefill_s * 1000, 1),
                    "decode_ms": round(e.last_decode_s * 1000, 1),
                    "kv_free_pages": e.sessions.free_pages(),
                    "prefix_cache": e.sessions.prefix_cache.stats(),
                }
            self._bus.broadcast(TOPIC_SERVING, {
                "event": "serving_round", "ts": time.time(),
                "members": members})
        except Exception:                 # noqa: BLE001 — telemetry only
            logger.exception("serving telemetry broadcast failed")

    def _query_member(self, spec: str, idxs: list[int],
                      requests: Sequence[QueryRequest],
                      results: list[Optional[QueryResult]],
                      parent=None) -> None:
        """One member's slice of the round in a ``backend.member`` span
        (rebinding ``parent``, the span captured on the query() thread).
        The member's phase walls enter the trace retroactively from the
        QueryResult timings (the fences live in generate.py)."""
        with TRACER.use(parent):
            with TRACER.span("backend.member", model=spec) as msp:
                self._query_member_impl(spec, idxs, requests, results)
                done = [results[i] for i in idxs
                        if results[i] is not None and results[i].ok]
                msp.attrs.update(
                    n_rows=len(idxs),
                    cached_tokens=sum(r.cached_tokens for r in done))
                if done and (done[0].prefill_ms or done[0].decode_ms):
                    # phase timings are per batch (the same for all the
                    # member's rows): one retroactive span per phase
                    TRACER.emit("generate.prefill", done[0].prefill_ms,
                                parent=msp, phase="prefill", model=spec)
                    TRACER.emit("generate.decode", done[0].decode_ms,
                                parent=msp, phase="decode", model=spec)

    def _query_member_impl(self, spec: str, idxs: list[int],
                           requests: Sequence[QueryRequest],
                           results: list[Optional[QueryResult]]) -> None:
        """Writes into disjoint ``results`` positions, so concurrent
        member threads are safe."""
        if spec not in self.engines or spec not in self._batchers:
            for i in idxs:
                results[i] = QueryResult(
                    model_spec=spec, error=f"unknown model {spec!r}",
                    permanent_error=True)
            return
        # Chaos seam: member crash / slow / garbage at the per-member
        # query entry. A crash fails this member's rows with the
        # structured InjectedFault text (the consensus layer counts it
        # like any transport failure); garbage perturbs the member's
        # OUTPUT after serving.
        try:
            chaos = CHAOS.fire("pool.member", model=spec)
        except InjectedFault as e:
            for i in idxs:
                results[i] = QueryResult(model_spec=spec, error=str(e))
            return
        t0 = time.monotonic()
        rows, live_idxs = self._build_rows(spec, idxs, requests, results,
                                           t0)
        if not live_idxs:
            return
        self._dispatch_rows(spec, rows, live_idxs, results, t0)
        if chaos is not None and chaos.kind == "garbage":
            for i in live_idxs:
                r = results[i]
                if r is not None and r.ok:
                    results[i] = dataclasses.replace(
                        r, text=f"{r.text} [chaos-garbage:{chaos.n}]")

    def _build_rows(self, spec: str, idxs: list[int],
                    requests: Sequence[QueryRequest],
                    results: list, t0: float) -> tuple[list[dict],
                                                       list[int]]:
        """Row preparation for one member: chat-template encode, session
        splice, per-row overflow and deadline errors, and the output
        budget min(output_limit, max(floor, window - prompt))."""
        engine = self.engines[spec]
        tok = engine.tokenizer
        max_seq = engine.max_seq
        rows: list[dict] = []
        live_idxs: list[int] = []
        for i in idxs:
            r = requests[i]
            ids = tok.encode_chat(r.messages)
            if r.session_id:
                # share the session's ACTUAL ids (prompt + sampled
                # response) so the retained response KV resumes too
                sess_toks = engine.session_tokens(r.session_id)
                if not sess_toks and spec in self._spec_decoders:
                    # speculative sessions live in the decoder, not the
                    # engine: splice against ITS resident ids
                    sess_toks = self._spec_decoders[spec].session_tokens(
                        r.session_id)
                if sess_toks:
                    spliced = splice_session_prompt(tok, sess_toks, ids)
                    if spliced is not None and len(spliced) < max_seq:
                        ids = spliced
            if len(ids) >= max_seq:
                results[i] = QueryResult(
                    model_spec=spec,
                    error=f"context_overflow: prompt {len(ids)} tokens "
                          f">= window {max_seq}")
                continue
            window = engine.cfg.context_window
            out_lim = engine.cfg.output_limit
            floor = min(OUTPUT_FLOOR, out_lim)
            budget = min(out_lim, max(floor, window - len(ids)))
            # the relative deadline anchors at query() entry (t0): time
            # already spent tokenizing and splicing counts
            deadline_s = (t0 + r.deadline_ms / 1000.0
                          if r.deadline_ms is not None else None)
            if deadline_s is not None and time.monotonic() >= deadline_s:
                results[i] = QueryResult(
                    model_spec=spec,
                    error=f"deadline_exceeded: {r.deadline_ms:.0f}ms "
                          f"budget elapsed before dispatch")
                continue
            rows.append({
                "prompt": ids, "temperature": r.temperature,
                "top_p": r.top_p,
                "budget": min(r.max_tokens, budget) if r.max_tokens
                          else budget,
                "session_id": r.session_id,
                "constrain_json": r.constrain_json,
                "action_enum": r.action_enum,
                "priority": r.priority, "tenant": r.tenant,
                "deadline_s": deadline_s,
                "task_id": r.task_id, "decide": r.decide,
                "tree": r.tree,
            })
            live_idxs.append(i)
        return rows, live_idxs

    def _dispatch_rows(self, spec: str, rows: list[dict],
                       live_idxs: list[int], results: list,
                       t0: float) -> None:
        """Serve prepared rows through the backend's dispatch mode: the
        member's continuous batcher; its batch-1 speculative decoder (one
        text row, greedy or top_p 1, the decoder's lock free); or its
        baton batcher, which may merge them with concurrent callers'
        rounds. Each row's failure becomes its error string, as in the JAX
        backend."""
        if self.continuous:
            self._query_member_continuous(spec, rows, live_idxs, results,
                                          t0)
            return
        engine = self.engines[spec]
        dec = self._spec_decoders.get(spec)
        if (dec is not None and len(rows) == 1
                and (rows[0]["temperature"] <= 0
                     or rows[0]["top_p"] >= 1.0)
                # the decoder sizes its dense caches for prompt + max_new <
                # max_seq: a prompt leaving no token of room goes to the
                # baton path's own overflow handling
                and len(rows[0]["prompt"]) + 1 < engine.max_seq
                # TRY-acquire: under concurrent callers the baton batcher's
                # merge beats serialized speculation, so contention falls
                # through to it
                and dec.lock.acquire(blocking=False)):
            self._serve_speculative(spec, dec, rows[0], live_idxs[0],
                                    results, t0)
            return
        futs = self._batchers[spec].submit(rows)
        self._collect(spec, futs, live_idxs, results, t0)

    def _serve_speculative(self, spec: str, dec: SpeculativeDecoder,
                           r0: dict, i0: int, results: list,
                           t0: float) -> None:
        """One row through the batch-1 decoder (the caller holds its lock,
        released here). The OUTPUT_FLOOR-inflated budget is clamped to the
        window, as the engine clamps its per-row limits."""
        engine = self.engines[spec]
        cfg = engine.cfg
        budget = min(r0["budget"], engine.max_seq - len(r0["prompt"]) - 1)
        try:
            g = dec.generate(
                r0["prompt"], temperature=r0["temperature"],
                top_p=r0["top_p"], max_new_tokens=budget,
                constrain_json=bool(r0["constrain_json"]),
                action_enum=r0["action_enum"],
                session_id=r0["session_id"])
        except ContextOverflowError as e:
            results[i0] = QueryResult(model_spec=spec,
                                      error=f"context_overflow: {e}")
            return
        except Exception as e:    # noqa: BLE001 — row-level error
            results[i0] = QueryResult(model_spec=spec,
                                      error=f"generate failed: {e}")
            return
        finally:
            dec.lock.release()
        cost = (g.n_prompt_tokens * cfg.input_cost_per_mtok
                + g.n_gen_tokens * cfg.output_cost_per_mtok) / 1e6
        results[i0] = QueryResult(
            model_spec=spec, text=g.text,
            usage=Usage(g.n_prompt_tokens, g.n_gen_tokens, cost),
            latency_ms=(time.monotonic() - t0) * 1000,
            # draft and verify interleave: no prefill/decode split, as in
            # continuous mode
            prefill_ms=0.0, decode_ms=0.0,
            cached_tokens=g.n_cached_tokens, spec_rounds=g.rounds,
            spec_accepted_tokens=g.accepted)

    def _query_member_continuous(self, spec: str, rows: list[dict],
                                 live_idxs: list[int],
                                 results: list, t0: float) -> None:
        """Continuous mode: rows join the member's shared decode loop
        (models/scheduler.py) at chunk boundaries. (The JAX backend sends
        image rows, which skip KV sessions, straight to the engine; the
        port serves no VLM rows yet.)"""
        cb = self._cbatchers[spec]
        futs = []
        for r in rows:
            futs.append(cb.submit(
                r["prompt"], temperature=r["temperature"],
                top_p=r["top_p"], max_new_tokens=r["budget"],
                session_id=r["session_id"],
                constrain_json=r["constrain_json"],
                action_enum=r["action_enum"],
                priority=r["priority"], tenant=r["tenant"],
                deadline_s=r["deadline_s"],
                task_id=r.get("task_id"), decide=r.get("decide"),
                tree=r.get("tree")))
        self._collect(spec, futs, live_idxs, results, t0)

    def _collect(self, spec: str, futs: list[Future], live_idxs: list[int],
                 results: list, t0: float) -> None:
        """Each row's result or failure into its QueryResult, with the
        JAX backend's error strings. A baton future carries (GenResult,
        prefill_ms, decode_ms); a continuous one the GenResult alone:
        many rows share each device step there, so the phases are 0."""
        cfg = self.engines[spec].cfg
        for i, f in zip(live_idxs, futs):
            try:
                res = f.result()
                g, prefill_ms, decode_ms = (res if isinstance(res, tuple)
                                            else (res, 0.0, 0.0))
            except ContextOverflowError as e:
                results[i] = QueryResult(model_spec=spec,
                                         error=f"context_overflow: {e}")
                continue
            except DeadlineExceededError as e:
                results[i] = QueryResult(model_spec=spec,
                                         error=f"deadline_exceeded: {e}")
                continue
            except AdmissionError as e:
                results[i] = QueryResult(
                    model_spec=spec,
                    error=f"admission_rejected: {e} "
                          f"(retry_after_ms={e.retry_after_ms})")
                continue
            except Exception as e:    # noqa: BLE001 — row-level error
                results[i] = QueryResult(model_spec=spec,
                                         error=f"generate failed: {e}")
                continue
            latency_ms = (time.monotonic() - t0) * 1000
            cost = (g.n_prompt_tokens * cfg.input_cost_per_mtok
                    + g.n_gen_tokens * cfg.output_cost_per_mtok) / 1e6
            results[i] = QueryResult(
                model_spec=spec, text=g.text,
                usage=Usage(g.n_prompt_tokens, g.n_gen_tokens, cost),
                latency_ms=latency_ms, prefill_ms=prefill_ms,
                decode_ms=decode_ms, cached_tokens=g.n_cached_tokens,
                spec_rounds=g.spec_rounds,
                spec_accepted_tokens=g.spec_accepted_tokens,
                chip_ms=g.chip_ms)

    def embed(self, texts: Sequence[str]) -> list[np.ndarray]:
        return self.embedder.embed(texts)

    def drop_session(self, session_id: str,
                     model_specs: Optional[Sequence[str]] = None) -> None:
        """Release a conversation's resident KV on every engine (or only
        on ``model_specs``), and in the members' batch-1 speculative
        decoders: their sessions hold two dense caches, and a reused id
        must not splice against a dead conversation."""
        keep = None if model_specs is None else set(model_specs)
        for spec, engine in self.engines.items():
            if keep is None or spec in keep:
                engine.drop_session(session_id)
        for spec, dec in self._spec_decoders.items():
            if keep is None or spec in keep:
                dec.drop_session(session_id)

    def count_tokens(self, model_spec: str, text: str) -> int:
        return self.engines[model_spec].tokenizer.count(text)

    def context_window(self, model_spec: str) -> int:
        return get_model_config(model_spec).context_window

    def output_limit(self, model_spec: str) -> int:
        return get_model_config(model_spec).output_limit


# ---------------------------------------------------------------------------
# Mock backend (tests)
# ---------------------------------------------------------------------------

class MockBackend(ModelBackend):
    """Deterministic scripted backend.

    ``respond`` maps a QueryRequest to response text; default echoes a valid
    wait-action JSON so agent loops terminate. Per-model scripts drive
    disagreement/malformed/invalid scenarios (``"__error__"`` scripts a
    backend failure); every call is recorded in ``calls`` for assertion.
    The embedder defaults to ``HashingEmbedder``. Each row runs under a
    ``backend.member`` span, as in the JAX mock, so agent span trees over
    mocks match the serving backend's (decide → round → member). Each row
    fires the chaos plane's ``pool.member`` seam first, as in the JAX
    mock, so member crash and garbage scenarios run on the mock pool.
    """

    DEFAULT_POOL = ["mock:consensus-model-1", "mock:consensus-model-2",
                    "mock:consensus-model-3"]

    def __init__(self, respond: Optional[Callable[[QueryRequest], str]] = None,
                 scripts: Optional[dict[str, list[str]]] = None,
                 embedder=None, context_window_tokens: int = 128_000,
                 output_limit_tokens: int = 4096,
                 latency_ms: float = 0.0):
        self._respond = respond
        self._scripts = {k: list(v) for k, v in (scripts or {}).items()}
        self._embedder = embedder or HashingEmbedder()
        self._window = context_window_tokens
        self._output_limit = output_limit_tokens
        self._latency_ms = latency_ms
        self.calls: list[QueryRequest] = []

    def query(self, requests: Sequence[QueryRequest]) -> list[QueryResult]:
        out = []
        for r in requests:
            self.calls.append(r)
            try:
                chaos = CHAOS.fire("pool.member", model=r.model_spec)
            except InjectedFault as e:
                out.append(QueryResult(model_spec=r.model_spec,
                                       error=str(e)))
                continue
            with TRACER.span("backend.member", model=r.model_spec):
                script = self._scripts.get(r.model_spec)
                if script:
                    text = script.pop(0)
                elif self._respond is not None:
                    text = self._respond(r)
                else:
                    text = ('{"action": "wait", "params": {"duration": 1}, '
                            '"reasoning": "mock default"}')
            if chaos is not None and chaos.kind == "garbage":
                # a VALID but divergent proposal (a registered action,
                # unlike the healthy members' answer): it clusters away
                # from them as dissent, which the drift detector keys on
                text = ('{"action": "orient", "params": '
                        '{"current_understanding": '
                        f'"chaos divergence {chaos.n}", '
                        '"progress_assessment": "diverging"}, '
                        '"wait": 30, '
                        '"reasoning": "chaos-injected divergence"}')
            if text == "__error__":
                out.append(QueryResult(model_spec=r.model_spec,
                                       error="scripted failure"))
                continue
            n_in = self.count_message_tokens(r.model_spec, r.messages)
            out.append(QueryResult(
                model_spec=r.model_spec, text=text,
                usage=Usage(n_in, max(1, len(text) // 4), 0.0),
                latency_ms=self._latency_ms))
        return out

    def embed(self, texts: Sequence[str]) -> list[np.ndarray]:
        return self._embedder.embed(texts)

    def count_tokens(self, model_spec: str, text: str) -> int:
        return max(1, len(text) // 4)

    def context_window(self, model_spec: str) -> int:
        return self._window

    def output_limit(self, model_spec: str) -> int:
        return self._output_limit
