"""Composition root: builds and owns the whole service graph.

The explicit-factory equivalent of the reference's supervision tree
(reference lib/quoracle/application.ex:38-61: Vault → Repo → PubSub →
Registry → EmbeddingCache → Task.Supervisor → Agent.DynSup → EventHistory →
Endpoint, then boot revival at :74). There are no singletons: a Runtime owns
one instance of each service and hands them to agents via AgentDeps — build
two Runtimes and they share nothing (the reference's cardinal DI rule, root
AGENTS.md:5-33).

The PyTorch port's copy of ``quoracle_tpu/runtime.py``. The serving
backend is ``"mock"`` or ``"torch"`` (``TorchBackend`` on ``device``:
None means the GPU, and raises without one). What the port has not got
yet raises at construction and names its ROADMAP Queue 1 item, never
dropped silently: multi-process and tensor-parallel serving (item 12),
the cross-host fabric, its prefix service and the simulator (item 14),
the training capture store (item 11) and the diffusion image backend
(item 10). ``replicas`` and ``disaggregate`` serve through a
``ClusterPlane`` (serving/cluster.py) whose replicas all sit on
``device``; ``fleet_max`` puts a ``FleetController`` over it, ticked by
the runtime's ``fleet-ticker`` thread; ``chaos_plan`` arms a fault plan
on the chaos plane before any traffic.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Optional

from quoracle_tpu_torch.agent.registry import AgentRegistry
from quoracle_tpu_torch.agent.state import AgentDeps
from quoracle_tpu_torch.agent.supervisor import AgentSupervisor
from quoracle_tpu_torch.context.token_manager import TokenManager
from quoracle_tpu_torch.infra.budget import Escrow
from quoracle_tpu_torch.consensus.quality import QUALITY
from quoracle_tpu_torch.infra.bus import (
    TOPIC_CONSENSUS, TOPIC_RESOURCES, TOPIC_TRACE, AgentEvents, EventBus,
)
from quoracle_tpu_torch.infra.costs import CostRecorder
from quoracle_tpu_torch.infra.event_history import EventHistory
from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.telemetry import METRICS, TRACER
from quoracle_tpu_torch.models.runtime import (
    MockBackend, ModelBackend, TorchBackend,
)
from quoracle_tpu_torch.persistence import Database, Persistence, TaskManager
from quoracle_tpu_torch.persistence.store import PersistentSecretStore


logger = logging.getLogger(__name__)


class StallWatchdog:
    """Detects wedged decode loops: each SOURCE is a
    ``(name, fn)`` pair where ``fn() -> (active, progress)`` — ``active``
    says the source has work in flight, ``progress`` is a monotonic
    counter that advances whenever real work completes (the continuous
    batcher's chunk-step count, models/scheduler.py). A source that stays
    active with a frozen counter past ``deadline_s`` trips the watchdog:
    the stall counter/gauge record it, a ``watchdog_stall`` event rides
    ``TOPIC_RESOURCES`` onto the bus (dashboard SSE + /api/history), and
    the flight recorder dumps the last spans/resource samples/scheduler
    transitions to disk — the incident is attributable after the fact
    even if the process is killed moments later.

    A tripped source un-trips itself when progress resumes or the work
    drains (gauge back to 0); each distinct wedge trips once per
    ``rearm_cooldown_s``, not once per poll — and not once per PROCESS:
    after the cooldown a still-frozen (or newly re-frozen) source
    re-trips and re-dumps (a one-shot trip would leave a second stall
    after the first undetected, and a day-long wedge with exactly one
    artifact)."""

    def __init__(self, bus: Optional[EventBus] = None,
                 deadline_s: float = 30.0,
                 poll_s: Optional[float] = None,
                 rearm_cooldown_s: Optional[float] = None):
        self.bus = bus
        self.deadline_s = deadline_s
        self.poll_s = poll_s if poll_s is not None \
            else max(0.5, deadline_s / 4)
        # default: re-arm after 4 deadlines — long enough that one wedge
        # doesn't dump-storm, short enough that an operator watching a
        # multi-hour incident gets fresh evidence
        self.rearm_cooldown_s = (rearm_cooldown_s
                                 if rearm_cooldown_s is not None
                                 else 4 * deadline_s)
        self._sources: dict[str, Callable[[], tuple]] = {}
        self._last: dict[str, tuple] = {}     # name -> (progress, since)
        self._tripped: dict[str, float] = {}  # name -> last trip time
        self.trips = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_source(self, name: str, fn: Callable[[], tuple]) -> None:
        with self._lock:
            self._sources[name] = fn

    def start(self) -> None:
        """Start the poll thread — only once there is something to watch
        (a Runtime over a MockBackend registers no sources and spends no
        thread)."""
        if self._thread is not None or not self._sources:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="stall-watchdog", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check_now()

    def check_now(self) -> list[str]:
        """One scan over every source; returns the names that tripped in
        THIS scan (tests drive this directly instead of sleeping)."""
        now = time.monotonic()
        with self._lock:
            sources = dict(self._sources)
        tripped = []
        for name, fn in sources.items():
            try:
                active, progress = fn()
            except Exception:             # noqa: BLE001 — telemetry only
                continue
            last = self._last.get(name)
            if not active:
                self._last.pop(name, None)
                self._untrip(name)
                continue
            if last is None or last[0] != progress:
                self._last[name] = (progress, now)
                self._untrip(name)
                continue
            if now - last[1] < self.deadline_s:
                continue
            last_trip = self._tripped.get(name)
            # first trip fires immediately; a source STILL frozen past
            # the cooldown re-trips (fresh dump — the wedge is ongoing
            # and the first artifact may be long pruned)
            if last_trip is None \
                    or now - last_trip >= self.rearm_cooldown_s:
                self._tripped[name] = now
                self.trips += 1
                tripped.append(name)
                self._trip(name, now - last[1])
        return tripped

    def _untrip(self, name: str) -> None:
        if name in self._tripped:
            self._tripped.pop(name, None)
            from quoracle_tpu_torch.infra.telemetry import WATCHDOG_STALLED
            WATCHDOG_STALLED.set(0.0, source=name)

    def _trip(self, name: str, stalled_s: float) -> None:
        from quoracle_tpu_torch.infra.telemetry import (
            WATCHDOG_STALLED, WATCHDOG_STALLS,
        )
        WATCHDOG_STALLS.inc(source=name)
        WATCHDOG_STALLED.set(1.0, source=name)
        FLIGHT.record("watchdog_stall", source=name,
                      stalled_s=round(stalled_s, 1),
                      deadline_s=self.deadline_s)
        dump_path = None
        try:
            dump_path = FLIGHT.dump(reason=f"watchdog-{name}")
        except Exception:                 # noqa: BLE001 — keep serving
            logger.exception("flight-recorder dump failed on stall")
        # correlated incident capture: the trip also opens a
        # deterministic incident — on a fabric front door the id fans
        # out so every peer's flight ring joins the bundle
        from quoracle_tpu_torch.infra.fleetobs import INCIDENTS
        INCIDENTS.capture("watchdog", name,
                          reason=f"no progress for {stalled_s:.1f}s")
        logger.error("stall watchdog tripped: %s made no progress for "
                     "%.1fs (flight recorder: %s)", name, stalled_s,
                     dump_path)
        if self.bus is not None:
            try:
                self.bus.broadcast(TOPIC_RESOURCES, {
                    "event": "watchdog_stall", "ts": time.time(),
                    "source": name, "stalled_s": round(stalled_s, 1),
                    "deadline_s": self.deadline_s,
                    "dump_path": dump_path,
                })
            except Exception:             # noqa: BLE001 — telemetry only
                pass

    def status(self) -> dict:
        with self._lock:
            return {
                "deadline_s": self.deadline_s,
                "rearm_cooldown_s": self.rearm_cooldown_s,
                "sources": sorted(self._sources),
                "tripped": sorted(self._tripped),
                "trips": self.trips,
                "running": self._thread is not None,
            }

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# The RuntimeConfig fields whose modules the port has not got, each with
# the ROADMAP Queue 1 item that ports it. A field set to anything but its
# default raises NotImplementedError at construction.
_MULTI_PROCESS = "ROADMAP Queue 1 item 12 (multi-GPU)"
_FABRIC = "ROADMAP Queue 1 item 14 (the cross-host fabric)"
_NOT_PORTED = {
    "tp": _MULTI_PROCESS,
    "coordinator_address": _MULTI_PROCESS,
    "num_processes": _MULTI_PROCESS,
    "process_id": _MULTI_PROCESS,
    "fabric_peers": _FABRIC,
    "fabric_listen": _FABRIC,
    "prefixd": _FABRIC,
    "sim_trace": "ROADMAP Queue 1 item 14 (sim/)",
    "sim_seed": "ROADMAP Queue 1 item 14 (sim/)",
    "capture_dir": "ROADMAP Queue 1 item 11 (training capture)",
    "capture_mb": "ROADMAP Queue 1 item 11 (training capture)",
}


def _check_backend_choice(config: "RuntimeConfig") -> None:
    """The backend the runtime would build: ``"mock"`` or ``"torch"``
    (``"tpu"`` is the JAX package's and raises), and no serving flag on
    the mock, which would ignore it."""
    if config.backend not in ("mock", "torch"):
        raise ValueError(
            f"unknown backend {config.backend!r}: the port serves with "
            f"--backend torch (TorchBackend on the GPU) or --backend mock")
    if config.backend != "torch":
        if (config.checkpoints or config.tp or config.draft_map
                or config.coordinator_address or config.num_processes
                or config.process_id is not None
                or config.replicas > 1 or config.disaggregate
                or config.fabric_peers or config.fabric_listen
                or config.prefixd or config.quantize_weights
                or config.quantize_kv or config.fleet_max):
            # Silent fallback to mock would make the user believe their
            # checkpoint (or quantized member) is serving while scripted
            # responses come back.
            raise ValueError(
                "--checkpoint/--tp/--draft/--coordinator/"
                "--num-processes/--process-id/--replicas/"
                "--disaggregate/--fabric-listen/--fabric-peers/"
                "--prefixd/--quantize-weights/--quantize-kv/"
                "--fleet-max require --backend torch "
                f"(backend is {config.backend!r})")


def _refuse_unported(config: "RuntimeConfig") -> None:
    """Raise for the first left-out field the config sets."""
    defaults = RuntimeConfig()
    for name, item in _NOT_PORTED.items():
        if getattr(config, name) != getattr(defaults, name):
            raise NotImplementedError(
                f"RuntimeConfig.{name}={getattr(config, name)!r} is not "
                f"ported yet: {item}")
    if config.image_backend == "diffusion":
        raise NotImplementedError(
            "image_backend='diffusion' is not ported yet: ROADMAP Queue 1 "
            "item 10 (VLM and diffusion)")


@dataclasses.dataclass
class RuntimeConfig:
    db_path: str = ":memory:"
    encryption_key: Optional[str] = None      # default: env QUORACLE_ENCRYPTION_KEY
    backend: str = "mock"                     # "mock" | "torch"
    # the torch backend's device: None is the GPU (raises without one),
    # "cpu" serves the plain PyTorch paths (tests)
    device: Any = None
    model_pool: Optional[list[str]] = None    # default pool for torch backend
    embed_model: Optional[str] = None
    seed: int = 0
    skills_dir: Optional[str] = None          # global skills directory
    groves_dir: Optional[str] = None          # directory of grove dirs
    # HF checkpoint directories (real weights + the checkpoint's own
    # tokenizer). Each registers into the catalog as xla:<dirname> and — when
    # model_pool is unset — the registered names BECOME the pool, so
    # `--backend torch --checkpoint dir1 --checkpoint dir2` serves real
    # checkpoints with zero extra wiring (reference model_query.ex:222-259
    # serves whatever models credentials point at).
    checkpoints: Optional[list[str]] = None
    # Tensor-parallel size per pool member (multi-GPU: not ported).
    tp: Optional[int] = None
    # generate_images backend: "procedural" (deterministic placeholder
    # PNGs, zero compute); "diffusion" (an on-device UNet) is not ported.
    image_backend: str = "procedural"
    # Speculative serving (models/speculative.py): {target_spec:
    # draft_spec} — eligible member queries draft-K/verify-one-chunk;
    # drafts load like members but never serve directly. Also settable
    # via the DB setting "draft_map". Under ``continuous`` the drafted
    # members speculate INSIDE the shared decode loop (BatchedSpeculator)
    # with ``draft_k`` as the initial adaptive draft length.
    draft_map: Optional[dict] = None
    draft_k: int = 6
    # Multi-process serving (not ported).
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # Decode-level continuous batching (models/scheduler.py) for the torch
    # backend's pool members (round-granularity baton batching otherwise).
    continuous: bool = False
    # Serving QoS: True for defaults, or a serving/qos.QoSConfig (a dict
    # of its fields also works — handy from CLI/JSON config). Turns on
    # weighted-fair admission + overload shedding; implies nothing unless
    # the backend is "torch".
    qos: Any = None
    # Tiered KV (serving/kvtier.py): host-RAM budget per pool member for
    # hibernated sessions/prefix blocks (0 = tiering off unless
    # disk_kv_dir is set), and the directory of the checksummed disk
    # prefix store that warm-starts the next process.
    host_kv_mb: int = 0
    disk_kv_dir: Optional[str] = None
    # Byte budget of the disk prefix store (per member): oldest-LRU
    # entries prune when a write overflows it.
    disk_kv_gb: float = 8.0
    # The disaggregated serving plane (serving/cluster.py: ``replicas``
    # full replicas of the pool on ``device``; ``disaggregate`` tags them
    # prefill/decode and implies 2), the elastic fleet over it
    # (serving/fleet.py: ``fleet_max`` > 0 arms it, ticked every
    # ``fleet_tick_s``), the chaos plane's fault plan (a JSON file, armed
    # at construction) and the cross-host fabric (not ported).
    replicas: int = 1
    disaggregate: bool = False
    fleet_min: int = 1
    fleet_max: int = 0
    fleet_tick_s: float = 5.0
    chaos_plan: Optional[str] = None
    fabric_peers: Optional[list[str]] = None
    fabric_listen: Optional[str] = None
    prefixd: Optional[str] = None
    # Quantized serving (models/quant.py): per-member opt-in int8.
    # ``quantize_weights`` quantizes every engine's projection matrices
    # per-channel at load; ``quantize_kv`` stores int8 KV pages with
    # per-(token, kv-head) scales beside them. Off by default.
    quantize_weights: bool = False
    quantize_kv: bool = False
    # The fleet simulator and the serving flywheel's capture store (not
    # ported).
    sim_trace: Optional[str] = None
    sim_seed: Optional[int] = None
    capture_dir: Optional[str] = None
    capture_mb: float = 256.0


class Runtime:
    """One running quoracle_tpu_torch node. Construct → (await) boot() →
    use .tasks / .deps; close() tears everything down."""

    def __init__(self, config: Optional[RuntimeConfig] = None,
                 backend: Optional[ModelBackend] = None):
        config = config if config is not None else RuntimeConfig()
        if backend is None:
            _check_backend_choice(config)
        _refuse_unported(config)
        # a fault plan is read (and a bad one refused) before anything is
        # built, so a refusal leaves no sink or thread behind
        chaos_plan = None
        if config.chaos_plan:
            from quoracle_tpu_torch.chaos.faults import FaultPlan
            chaos_plan = FaultPlan.from_json(config.chaos_plan)
        self.config = config
        self.db = Database(config.db_path,
                           encryption_key=config.encryption_key)
        self.store = Persistence(self.db)
        self.bus = EventBus()
        self.events = AgentEvents(self.bus)
        self.history = EventHistory(self.bus)
        self.escrow = Escrow()
        self.costs = CostRecorder(escrow=self.escrow, events=self.events,
                                  persist_fn=self.store.persist_cost)
        # Elastic fleet controller: set by _build_backend over the
        # ClusterPlane, ticked by the thread started below
        self._fleet = None
        self._fleet_stop = threading.Event()
        self._fleet_thread: Optional[threading.Thread] = None
        try:
            self.backend = backend or self._build_backend(config)
        except BaseException:
            self.history.close()
            self.db.close()
            raise
        # serving telemetry (prefix-cache counters, phase timings) rides
        # the bus into EventHistory's ring + the dashboard SSE tail
        self.backend.attach_bus(self.bus)
        # finished trace spans (infra/telemetry.py — the process-wide
        # tracer) re-broadcast on THIS runtime's bus: EventHistory rings
        # them for /api/trace mount replay, SSE tails them live. The sink
        # detaches in close(); spans carry trace_id, so a second Runtime's
        # ring filters per task regardless.
        self._trace_sink = (
            lambda event: self.bus.broadcast(TOPIC_TRACE, event))
        TRACER.add_sink(self._trace_sink)
        # fleet observability: the pull-able span ring — any runtime can
        # answer /api/timeline from it
        from quoracle_tpu_torch.infra import fleetobs
        fleetobs.ensure_ring()
        # Consensus quality: audit records + model-health drift alerts
        # (consensus/quality.py QUALITY, process-wide like TRACER)
        # re-broadcast on THIS runtime's bus — EventHistory rings them,
        # the durable writer persists audit records alongside the task's
        # decisions. Detached in close().
        self._quality_sink = (
            lambda event: self.bus.broadcast(TOPIC_CONSENSUS, event))
        QUALITY.add_sink(self._quality_sink)
        # Resource observability: crash hooks + span sink into the
        # process-wide flight recorder, a scrape-time collector that
        # refreshes the device-memory/prefix-cache/compile-storm gauges
        # from THIS runtime's backend, and the stall watchdog over the
        # backend's decode loops. The collector detaches in close() (the
        # recorder's hooks are process-scoped by design and stay).
        FLIGHT.install()
        # Chaos plane: arm the configured fault plan before any traffic,
        # so a game-day canary injects from its first row.
        if chaos_plan is not None:
            from quoracle_tpu_torch.chaos.faults import CHAOS
            CHAOS.arm(chaos_plan)
        from quoracle_tpu_torch.infra.resources import ResourceCollector
        self._resource_collector = ResourceCollector(self.backend)
        METRICS.register_collector(self._resource_collector)
        self.watchdog = StallWatchdog(self.bus)
        for name, fn in self.backend.watchdog_sources():
            self.watchdog.add_source(name, fn)
        self.watchdog.start()
        # Liveness & hotspot plane: heartbeat stall detector + sampled
        # wall-clock profiler over the same backend sources.
        from quoracle_tpu_torch.infra import introspect
        introspect.start(self.backend.watchdog_sources())
        if self._fleet is not None:
            self._fleet_thread = threading.Thread(
                target=self._fleet_loop, name="fleet-ticker",
                daemon=True)
            self._fleet_thread.start()
        self.token_manager = TokenManager(
            self.backend.count_tokens,
            context_limit_fn=self.backend.context_window)
        self.secrets = PersistentSecretStore(self.db)
        self.registry = AgentRegistry()
        from quoracle_tpu_torch.governance.skills import SkillsLoader
        skills_dir = (config.skills_dir
                      or self.store.get_setting("skills_dir"))
        self.skills = SkillsLoader(global_dir=skills_dir)
        from quoracle_tpu_torch.infra.http import urllib_http
        from quoracle_tpu_torch.infra.mcp import MCPManager
        from quoracle_tpu_torch.models.images import ProceduralImageBackend
        images = ProceduralImageBackend()
        from quoracle_tpu_torch.persistence.store import CredentialStore
        self.credentials = CredentialStore(self.db)
        self.mcp = MCPManager(
            self.store.get_setting("mcp_servers") or {},
            credential_resolver=lambda cid: self.credentials.get(
                cid, agent_id="mcp", action="mcp_connect"))
        self.deps = AgentDeps(
            backend=self.backend, registry=self.registry, supervisor=None,
            events=self.events, escrow=self.escrow, costs=self.costs,
            token_manager=self.token_manager, secrets=self.secrets,
            persistence=self.store, skills=self.skills,
            http=urllib_http,
            ssrf_check=bool(self.store.get_setting("ssrf_check", True)),
            mcp=self.mcp, images=images, credentials=self.credentials)
        self.supervisor = AgentSupervisor(self.deps)
        self.tasks = TaskManager(self.deps, self.store)
        self.store.attach_bus(self.bus)

    def _build_backend(self, config: RuntimeConfig) -> ModelBackend:
        # instance method: the draft_map fallback reads the DB settings
        # (self.store is constructed before the backend)
        if config.backend != "torch":
            return MockBackend()
        # (The JAX runtime enables XLA's persistent compilation cache and
        # joins the JAX distributed system here; the port compiles only
        # its kernel library, which ops/kernels.py caches, and serves one
        # process.)
        pool = list(config.model_pool or ())
        if config.checkpoints:
            from quoracle_tpu_torch.models.loader import (
                register_hf_checkpoint,
            )
            registered = [register_hf_checkpoint(path).name
                          for path in config.checkpoints]
            if not pool:
                pool = [f"xla:{name}" for name in registered]
        if not pool:
            from quoracle_tpu_torch.models.config import BENCH_POOL
            pool = list(BENCH_POOL)
        draft_map = (config.draft_map
                     or self.store.get_setting("draft_map"))
        if draft_map and not isinstance(draft_map, dict):
            logger.warning("ignoring non-dict draft_map setting %r",
                           draft_map)
            draft_map = None
        qos = config.qos
        if isinstance(qos, dict):
            from quoracle_tpu_torch.serving.qos import QoSConfig
            qos = QoSConfig(**qos)
        if config.replicas > 1 or config.disaggregate:
            # The multi-replica plane: every replica on config.device (the
            # one-card case of the JAX package's replica_device_groups,
            # where replicas share devices when they outnumber them).
            from quoracle_tpu_torch.serving.cluster import ClusterPlane
            built = ClusterPlane.build(
                pool, replicas=max(config.replicas,
                                   2 if config.disaggregate else 1),
                disaggregate=config.disaggregate, seed=config.seed,
                device=config.device, qos=qos,
                draft_map=draft_map or None, draft_k=config.draft_k,
                continuous=config.continuous or config.disaggregate,
                host_kv_mb=config.host_kv_mb,
                disk_kv_dir=config.disk_kv_dir,
                disk_kv_gb=config.disk_kv_gb,
                embed_model=config.embed_model,
                quantize_weights=config.quantize_weights,
                quantize_kv=config.quantize_kv)
            if config.fleet_max:
                # the controller scales the serving tier within
                # [fleet_min, fleet_max] on a deterministic policy tick,
                # re-tiers roles and drains by live session migration;
                # the fleet-ticker thread is its only production caller
                from quoracle_tpu_torch.serving.fleet import (
                    FleetConfig, FleetController,
                )
                self._fleet = FleetController(
                    built, FleetConfig(min_replicas=config.fleet_min,
                                       max_replicas=config.fleet_max,
                                       seed=config.seed))
            return built
        if config.fleet_max:
            raise ValueError(
                "--fleet-max elasticizes a CLUSTER: it requires "
                "--replicas > 1 or --disaggregate")
        return TorchBackend(
            pool, seed=config.seed, device=config.device,
            draft_k=config.draft_k, embed_model=config.embed_model,
            draft_map=draft_map or None,
            continuous=config.continuous,
            qos=qos, host_kv_mb=config.host_kv_mb,
            disk_kv_dir=config.disk_kv_dir,
            disk_kv_gb=config.disk_kv_gb,
            quantize_weights=config.quantize_weights,
            quantize_kv=config.quantize_kv)

    def _fleet_loop(self) -> None:
        """The fleet ticker: the wall clock paces the ticks, never the
        decisions (the policy consumes only the gathered signals)."""
        while not self._fleet_stop.wait(self.config.fleet_tick_s):
            try:
                self._fleet.tick()
            except Exception:             # noqa: BLE001 — keep ticking
                logger.exception("fleet tick failed")

    async def boot(self) -> dict:
        """Boot-time revival of persisted running tasks (reference
        application.ex:71-74 → AgentRevival)."""
        return await self.tasks.boot_revival()

    async def shutdown(self) -> None:
        """Graceful stop of every live agent, then release resources."""
        await self.supervisor.stop_all()
        await self.mcp.close()
        self.close()

    def close(self) -> None:
        """Detach everything this runtime attached to the process-wide
        planes and close its database. The backend stays open: a caller
        that handed one in may share it with another Runtime."""
        self._fleet_stop.set()
        if self._fleet_thread is not None:
            self._fleet_thread.join(timeout=5)
            self._fleet_thread = None
        self.watchdog.close()
        from quoracle_tpu_torch.infra import introspect
        introspect.shutdown()
        METRICS.remove_collector(self._resource_collector)
        TRACER.remove_sink(self._trace_sink)
        QUALITY.remove_sink(self._quality_sink)
        self.store.detach_bus()
        self.history.close()
        self.db.close()

    # convenience passthroughs -------------------------------------------

    def live_agents(self) -> list[str]:
        return self.supervisor.live_agents()

    def default_pool(self) -> list[str]:
        """The pool used when a task names neither pool nor profile: the
        backend's POOL members — engines can also hold speculative draft
        models, which never serve directly."""
        pool = getattr(self.backend, "pool", None)
        if pool:
            return list(pool)
        return list(MockBackend.DEFAULT_POOL)

    def list_groves(self) -> list:
        from quoracle_tpu_torch.governance.grove import list_groves
        groves_dir = (self.config.groves_dir
                      or self.store.get_setting("groves_dir"))
        return list_groves(groves_dir) if groves_dir else []

    def status(self) -> dict[str, Any]:
        return {
            "backend": type(self.backend).__name__,
            "live_agents": len(self.registry),
            "tasks": {t["id"]: t["status"]
                      for t in self.store.list_tasks()},
        }
