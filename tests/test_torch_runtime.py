"""The port's composition root (``quoracle_tpu_torch/runtime.py``) and
the UI's event rings (``infra/event_history.py``) against the JAX
package's: tests/test_runtime_cli.py's runtime cases (full-stack create,
pause and reboot; isolation; checkpoints and the cluster flags, which
need a real backend) through both packages; the ``StallWatchdog`` under
one scripted clock (trip, untrip, re-arm after the cooldown);
``EventHistory`` after the same bus script; and what the port leaves
out: every such ``RuntimeConfig`` field raises and names its ROADMAP
item, ``backend="tpu"`` raises, ``backend="torch"`` asks for the card
unless ``device="cpu"``, and ``close()`` detaches what it attached.

No test waits on a clock: agents are awaited through the ``Watch`` of
tests/_agent_parity.py, and the watchdog's time is scripted."""

import json

import pytest
import torch

from _agent_parity import (
    BOTH, JAX, PORT, SEQUENCE_ID, db_view, first_difference, idle,
    install_watch, j, new_watch, process_hooks_restored, run, view,
)

POOL = ["mock:consensus-model-1", "mock:consensus-model-2",
        "mock:consensus-model-3"]


@pytest.fixture(autouse=True)
def watched(monkeypatch, tmp_path):
    install_watch(monkeypatch)
    # a watchdog trip dumps the flight ring and opens an incident bundle
    monkeypatch.setenv("QUORACLE_FLIGHTREC_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("QUORACLE_INCIDENT_DIR", str(tmp_path / "incidents"))
    for pkg in BOTH:
        pkg.treeobs.reset()
    with process_hooks_restored():
        yield


def wait_backend(pkg):
    return pkg.runtime.MockBackend(respond=lambda r: j("wait", {}))


def test_runtime_full_stack_create_pause_reboot(tmp_path):
    """Create a task, pause it, leave it "running" in the file (a crash)
    and revive it from a second runtime's boot."""
    def case(pkg):
        db_path = str(tmp_path / f"{pkg.name[-5:]}.db")

        async def phase1():
            rt = pkg.rt.Runtime(pkg.rt.RuntimeConfig(
                db_path=db_path, encryption_key="k"),
                backend=wait_backend(pkg))
            w = new_watch(rt.deps)
            task_id, root = await rt.tasks.create_task(
                "hold", model_pool=list(POOL))
            await w.until(lambda: len(root.ctx.history(POOL[0])) >= 3
                          and idle(root))
            await rt.tasks.pause_task(task_id)
            status = rt.status()
            rt.store.db.execute(
                "UPDATE tasks SET status='running' WHERE id=?", (task_id,))
            rt.close()
            return task_id, status

        async def phase2(task_id):
            rt = pkg.rt.Runtime(pkg.rt.RuntimeConfig(
                db_path=db_path, encryption_key="k"),
                backend=wait_backend(pkg))
            result = await rt.boot()
            out = {"revived": [t == task_id for t in result["revived"]],
                   "failed": result["failed"], "live": len(rt.registry),
                   "agents": rt.live_agents(), "status": rt.status()}
            await rt.shutdown()
            db = pkg.db.Database(db_path)
            out["db"] = db_view(db)
            out["decide_ids"] = all(
                SEQUENCE_ID.fullmatch(r["decide_id"]) for r in db.query(
                    "SELECT decide_id FROM consensus_audit"))
            return out

        task_id, status = run(phase1(), timeout=120)
        return {"paused": status, **run(phase2(task_id), timeout=120)}
    got = [case(pkg) for pkg in BOTH]
    a, b = view(got[0]), view(got[1])
    assert b == a, first_difference(a, b)
    port = got[1]
    assert list(port["paused"]["tasks"].values()) == ["paused"]
    assert port["paused"]["backend"] == "MockBackend"
    assert port["revived"] == [True] and port["live"] == 1
    assert port["db"]["consensus_audit"] and port["decide_ids"]


@pytest.mark.parametrize("key,a,b,equal", [
    ("decide_id", "c1", "c2f", True), ("decide_id", None, None, True),
    ("decide_id", "c1", None, False), ("decide_id", "c1", "x1", False),
    ("registry_id", "1a2b.3", "1a2b.7", True),
    ("registry_id", "1a2b.3", "", False)])
def test_view_holds_sequence_ids_to_their_format(key, a, b, equal):
    """The parity view puts a placeholder for a process-wide sequence id
    of its format only: a missing or malformed one still differs."""
    assert (view({key: a, "k": 1}) == view({key: b, "k": 1})) is equal


def test_runtime_isolation():
    """Two runtimes share nothing (the cardinal DI rule)."""
    def case(pkg):
        rt1 = pkg.rt.Runtime(backend=pkg.runtime.MockBackend())
        rt2 = pkg.rt.Runtime(backend=pkg.runtime.MockBackend())
        try:
            rt1.secrets.put("only-in-1", "value-123")
            return {"distinct": [getattr(rt1, a) is not getattr(rt2, a)
                                 for a in ("registry", "bus", "escrow",
                                           "db", "store", "history",
                                           "watchdog", "mcp", "deps",
                                           "credentials", "supervisor")],
                    "lookup": [rt1.secrets.lookup("only-in-1"),
                               rt2.secrets.lookup("only-in-1")],
                    "pool": rt1.default_pool(), "groves": rt1.list_groves(),
                    "ssrf": rt1.deps.ssrf_check,
                    "seams": [type(getattr(rt1.deps, a)).__name__
                              for a in ("images", "mcp", "credentials",
                                        "persistence", "secrets")]}
        finally:
            rt1.close()
            rt2.close()
    got = [case(pkg) for pkg in BOTH]
    assert view(got[1]) == view(got[0])
    assert all(got[1]["distinct"])
    assert got[1]["lookup"] == ["value-123", None]
    assert got[1]["pool"] == POOL and got[1]["ssrf"] is True


def test_checkpoints_require_a_real_backend():
    """A checkpoint on the default mock backend fails loudly, not
    silently serving scripted responses: the port names --backend
    torch where the JAX package names --backend tpu."""
    for pkg, real in ((JAX, "tpu"), (PORT, "torch")):
        with pytest.raises(ValueError, match=f"require --backend {real}"):
            pkg.rt.Runtime(pkg.rt.RuntimeConfig(checkpoints=["/nonexistent"]))


@pytest.mark.parametrize("kw", [
    {"coordinator_address": "h:1"}, {"num_processes": 2},
    {"process_id": 0}, {"tp": 2}, {"replicas": 2}, {"disaggregate": True},
    {"fabric_peers": ["h:1"]}, {"fabric_listen": "h:1"},
    {"prefixd": "h:1"}, {"quantize_weights": True}, {"quantize_kv": True},
    {"fleet_max": 2}, {"draft_map": {"a": "b"}}])
def test_cluster_and_serving_flags_require_a_real_backend(kw):
    """On the mock these flags would be ignored: both packages refuse
    them, with the same set of fields."""
    for pkg, real in ((JAX, "tpu"), (PORT, "torch")):
        with pytest.raises(ValueError, match=f"require --backend {real}"):
            pkg.rt.Runtime(pkg.rt.RuntimeConfig(**kw))


# Every field the port refused before its module was ported, with the
# ROADMAP item that ports it; None: ported since (the multi-replica plane,
# the chaos plane, the cross-host fabric, the simulator and the training
# capture store), the field is taken.
NOT_PORTED = [
    ("tp", 2, "item 12"), ("coordinator_address", "h:1", "item 12"),
    ("num_processes", 2, "item 12"), ("process_id", 0, "item 12"),
    ("replicas", 2, None),
    ("disaggregate", True, None),
    ("fleet_min", 2, None),
    ("fleet_max", 2, None),
    ("fleet_tick_s", 1.0, None),
    ("fabric_peers", ["h:1"], None),
    ("fabric_listen", "h:1", None),
    ("prefixd", "h:1", None),
    ("chaos_plan", "plan.json", None),
    ("sim_trace", "trace.json", None),
    ("sim_seed", 3, None),
    ("capture_dir", "capture", None),
    ("capture_mb", 64.0, None),
    ("image_backend", "diffusion", None),
]


@pytest.mark.parametrize("field,value,item", NOT_PORTED,
                         ids=[f for f, _, _ in NOT_PORTED])
def test_each_left_out_field_raises_and_names_its_item(field, value, item,
                                                      tmp_path):
    """Set on a torch runtime, each field the port has not got raises at
    construction, before any backend or database is built, and names its
    ROADMAP Queue 1 item. Each field ported since builds what the JAX
    runtime builds, on the CPU here: a ClusterPlane for ``replicas`` and
    ``disaggregate`` (the fleet fields with a plane under them), a
    FleetController ticked by the ``fleet-ticker`` thread for
    ``fleet_max``, an armed plan for ``chaos_plan``, the fabric and
    simulator fields as ``_fabric_or_sim_field`` checks them, and the
    diffusion image backend as ``_diffusion_field`` does."""
    if item is not None:
        cfg = PORT.rt.RuntimeConfig(backend="torch", device="cpu",
                                    model_pool=["xla:tiny"],
                                    **{field: value})
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue 1 {item}"):
            PORT.rt.Runtime(cfg)
        # the same with a backend handed in: nothing is dropped silently
        with pytest.raises(NotImplementedError, match=item):
            PORT.rt.Runtime(PORT.rt.RuntimeConfig(**{field: value}),
                            backend=PORT.runtime.MockBackend())
        return
    if field.startswith(("fabric", "prefixd", "sim")):
        _fabric_or_sim_field(field, tmp_path)
        return
    if field == "image_backend":
        _diffusion_field(value)
        return
    if field.startswith("capture"):
        _capture_field(field, value, tmp_path)
        return
    from quoracle_tpu_torch.chaos.faults import CHAOS
    kw = {field: value}
    if field.startswith("fleet"):
        kw.update(replicas=3, disaggregate=True, fleet_max=3)
        kw[field] = value if field != "fleet_max" else 3
    if field == "chaos_plan":
        plan = tmp_path / "plan.json"
        plan.write_text(json.dumps({"seed": 1, "faults": [
            {"point": "pool.member", "kind": "slow", "prob": 0.0}]}))
        kw[field] = str(plan)
    rt = PORT.rt.Runtime(PORT.rt.RuntimeConfig(
        backend="torch", device="cpu", model_pool=["xla:tiny"], **kw))
    try:
        cluster = getattr(rt.backend, "replicas", None)
        if field == "chaos_plan":
            assert CHAOS.armed() and cluster is None
        else:
            assert type(rt.backend).__name__ == "ClusterPlane"
            assert {str(e.device) for e in rt.backend.engines.values()} \
                == {"cpu"}
            roles = sorted(r.role for r in cluster)
            assert roles == (["unified"] * 2 if kw == {"replicas": 2}
                             else ["decode", "decode", "prefill"]
                             if "fleet_max" in kw
                             else ["decode", "prefill"])
        fleet = rt._fleet
        assert (fleet is not None) == field.startswith("fleet")
        if fleet is not None:
            assert rt._fleet_thread.name == "fleet-ticker"
            assert fleet.config.max_replicas == 3
            assert fleet.config.min_replicas == kw.get("fleet_min", 1)
    finally:
        CHAOS.disarm()
        rt.close()
        rt.backend.close()
    assert rt._fleet_thread is None


def _capture_field(field: str, value, tmp_path) -> None:
    """``capture_dir`` (with ``capture_mb`` its budget) installs each
    package's replay capture store when the runtime is built and
    uninstalls it at close, as the JAX runtime does: the same stats
    either side."""
    from quoracle_tpu.training.capture import CAPTURE as JCAP
    from quoracle_tpu_torch.training.capture import CAPTURE as TCAP
    seen = []
    for pkg, cap in ((JAX, JCAP), (PORT, TCAP)):
        kw = {"capture_dir": str(tmp_path / pkg.name / value)} \
            if field == "capture_dir" else \
            {"capture_dir": str(tmp_path / pkg.name / "cap"), field: value}
        cap.reset()
        rt = pkg.rt.Runtime(pkg.rt.RuntimeConfig(**kw),
                            backend=pkg.runtime.MockBackend())
        try:
            assert cap.active
            st = cap.stats()
            seen.append({**st, "store": {k: v for k, v in st["store"].items()
                                         if k != "path"}})
            assert st["store"]["path"] == kw["capture_dir"]
        finally:
            rt.close()
        assert cap.store is None and not cap.active
        cap.reset()
    assert seen[1] == seen[0]
    assert seen[1]["store"]["budget_mb"] == (value if field == "capture_mb"
                                             else 256.0)


def _diffusion_field(value: str) -> None:
    """``image_backend="diffusion"`` composes each package's
    ``DiffusionImageBackend`` as the agents' image backend (the JAX
    runtime's test, tests/test_diffusion.py), the port's on the runtime's
    device, seeded from the config's seed; without a device the port
    looks for the card, and raises here."""
    from quoracle_tpu.models.diffusion import DiffusionImageBackend as JDIB
    from quoracle_tpu_torch.models.diffusion import (
        DiffusionImageBackend as TDIB,
    )
    jrt = JAX.rt.Runtime(JAX.rt.RuntimeConfig(image_backend=value))
    try:
        assert isinstance(jrt.deps.images, JDIB)
    finally:
        jrt.close()
    rt = PORT.rt.Runtime(PORT.rt.RuntimeConfig(image_backend=value,
                                               device="cpu", seed=3))
    try:
        images = rt.deps.images
        assert isinstance(images, TDIB)
        assert images.device.type == "cpu"
        assert images.cfg == TDIB(seed=3, device="cpu").cfg
        for a, b in zip(images.params.parameters(),
                        TDIB(seed=3, device="cpu").params.parameters()):
            assert torch.equal(a, b)
    finally:
        rt.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.rt.Runtime(PORT.rt.RuntimeConfig(image_backend=value))


def _fabric_or_sim_field(field: str, tmp_path) -> None:
    """A fabric or simulator field on a CPU runtime, over real sockets on
    127.0.0.1 port 0: ``fabric_listen`` serves the backend as a peer
    (tiered, answering its hello), ``fabric_peers`` makes a front door
    over such a peer, ``prefixd`` attaches a client of a running prefix
    service to every engine tier, ``sim_trace`` and ``sim_seed`` replay
    on the ``sim-replay`` thread. Everything closes in ``finally``."""
    from quoracle_tpu_torch.serving.fabric import wire
    from quoracle_tpu_torch.serving.fabric.prefixd import PrefixService
    from quoracle_tpu_torch.serving.fabric.transport import (
        PeerServer, TcpTransport,
    )
    from quoracle_tpu_torch.sim.workload import bench_trace
    cfg = dict(backend="torch", device="cpu", model_pool=["xla:tiny"])
    server = None
    try:
        if field == "fabric_peers":
            def hello(msg_type, payload):
                return wire.MSG_OK, wire.encode_json(
                    {"replica_id": "unified-0", "role": "unified",
                     "pool": ["xla:tiny"]})
            server = PeerServer(hello, host="127.0.0.1", port=0,
                                name=f"test-runtime-{field}")
            cfg = dict(backend="torch",
                       fabric_peers=[f"unified@{server.addr}"])
        elif field == "fabric_listen":
            cfg["fabric_listen"] = "unified@127.0.0.1:0"
        elif field == "prefixd":
            server = PeerServer(PrefixService(str(tmp_path)).handle,
                                host="127.0.0.1", port=0,
                                name=f"test-runtime-{field}")
            cfg["prefixd"] = server.addr
        elif field == "sim_trace":
            trace = tmp_path / "trace.json"
            trace.write_text(bench_trace("interactive", 4, seed=1).to_json())
            cfg = {"sim_trace": str(trace)}
        else:
            cfg = {"sim_seed": 3}
        rt = PORT.rt.Runtime(PORT.rt.RuntimeConfig(**cfg))
        try:
            if field == "fabric_peers":
                assert type(rt.backend).__name__ == "FabricPlane"
                assert rt.default_pool() == ["xla:tiny"]
            elif field == "fabric_listen":
                peer = rt._fabric_peer
                t = TcpTransport(peer._server.host, peer._server.port,
                                 retries=0, io_timeout=30.0)
                try:
                    _, payload = t.request(wire.MSG_HELLO, b"{}")
                finally:
                    t.close()
                hello = wire.decode_json(payload)
                assert (hello["role"], hello["pool"]) == ("unified",
                                                          ["xla:tiny"])
                assert rt.backend.engines["xla:tiny"].sessions.tier
            elif field == "prefixd":
                eng = rt.backend.engines["xla:tiny"]
                client = eng.sessions.tier.prefixd
                assert client.signature == eng.kv_signature()
            else:
                assert rt._sim_thread.name == "sim-replay"
                rt._sim_thread.join(timeout=60)
                assert not rt._sim_thread.is_alive()
        finally:
            rt.close()
            getattr(rt.backend, "close", lambda: None)()
        if field == "fabric_listen":
            assert rt._fabric_peer._server is None
        if field.startswith("sim"):
            assert rt._sim_thread is None
    finally:
        if server is not None:
            server.close()


def test_list_groves_with_a_groves_setting_raises():
    """No groves without a setting; the ``groves_dir`` setting (or the
    config field) lists the manifests there as the JAX runtime does, and
    the one that does not load raises at ``load_grove``."""
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def case(pkg):
        rt = pkg.rt.Runtime(backend=pkg.runtime.MockBackend())
        rt2 = pkg.rt.Runtime(pkg.rt.RuntimeConfig(
            groves_dir=os.path.join(repo, "groves")),
            backend=pkg.runtime.MockBackend())
        try:
            empty = rt.list_groves()
            rt.store.set_setting("groves_dir", os.path.join(repo, "groves"))
            with pytest.raises(pkg.grove.GroveError):
                pkg.grove.load_grove("/somewhere")
            return {"empty": empty, "setting": rt.list_groves(),
                    "config": rt2.list_groves()}
        finally:
            rt.close()
            rt2.close()
    got = [case(pkg) for pkg in BOTH]
    assert view(got[1]) == view(got[0])
    assert got[1]["empty"] == []
    assert [g.name for g in got[1]["setting"]] == ["livebench", "mmlu-pro"]
    assert got[1]["config"] == got[1]["setting"]


def test_backend_names():
    for name in ("tpu", "jax", "cuda"):
        with pytest.raises(ValueError, match="--backend torch"):
            PORT.rt.Runtime(PORT.rt.RuntimeConfig(backend=name))


def test_torch_backend_defaults_to_the_card():
    """``device=None`` asks for the GPU and raises without one, as
    ``TorchBackend(device=None)`` does; the runtime closes what it
    opened before re-raising."""
    import torch
    if torch.cuda.is_available():
        pytest.fail("this check runs where no card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.rt.Runtime(PORT.rt.RuntimeConfig(backend="torch",
                                              model_pool=["xla:tiny"]))


def test_torch_backend_on_the_cpu_with_its_settings(tmp_path):
    """``device="cpu"`` builds TorchBackend with the config's settings:
    the pool, seed, a dict QoS, continuous batching, tiers and int8; a
    draft_map from the database setting."""
    rt = PORT.rt.Runtime(PORT.rt.RuntimeConfig(
        backend="torch", device="cpu", model_pool=["xla:tiny"], seed=3,
        continuous=True, qos={"quantum": 64}, host_kv_mb=16,
        quantize_kv=True, db_path=str(tmp_path / "r.db")))
    try:
        b = rt.backend
        assert type(b).__name__ == "TorchBackend"
        assert b.pool == ["xla:tiny"] and rt.default_pool() == b.pool
        assert str(b.device) == "cpu" and b.continuous and b.kv_tiered
        assert b.qos_controller is not None and b.quantize_kv
        assert [n for n, _ in b.watchdog_sources()] == [
            "decode-loop:xla:tiny"]
        assert rt.watchdog.status()["sources"] == ["decode-loop:xla:tiny"]
        assert b.engines["xla:tiny"]._generator.initial_seed() == 3
        rt.store.set_setting("draft_map", {"xla:tiny": "xla:tiny"})
    finally:
        rt.close()
        rt.backend.close()
    rt2 = PORT.rt.Runtime(PORT.rt.RuntimeConfig(
        backend="torch", device="cpu", model_pool=["xla:tiny"],
        db_path=str(tmp_path / "r.db")))
    try:
        assert set(rt2.backend._spec_decoders) == {"xla:tiny"}
    finally:
        rt2.close()
        rt2.backend.close()


def test_checkpoints_become_the_pool(tmp_path):
    """Each checkpoint registers as xla:<dirname> (the JAX loader reads
    the same name from the same directory) and, with no model_pool, the
    registered names are the pool."""
    from quoracle_tpu.models.loader import register_hf_checkpoint as jreg
    from quoracle_tpu_torch.models.make_checkpoint import make_checkpoint
    d = make_checkpoint(str(tmp_path / "rt-ck-llama"), family="llama",
                        scale="tiny")
    rt = PORT.rt.Runtime(PORT.rt.RuntimeConfig(
        backend="torch", device="cpu", checkpoints=[d]))
    try:
        assert rt.default_pool() == [f"xla:{jreg(d).name}"]
        assert rt.backend.engines[rt.default_pool()[0]].cfg \
            .checkpoint_path == d
    finally:
        rt.close()
        rt.backend.close()


def test_close_detaches_every_sink_and_collector():
    from quoracle_tpu_torch.consensus import quality
    from quoracle_tpu_torch.infra import fleetobs
    fleetobs.ensure_ring()          # the process-wide span ring stays
    tracer, metrics = PORT.telemetry.TRACER, PORT.telemetry.METRICS
    before = (list(tracer._sinks), list(metrics._collectors),
              list(quality.QUALITY._sinks))
    rt = PORT.rt.Runtime(backend=PORT.runtime.MockBackend())
    during = (list(tracer._sinks), list(metrics._collectors),
              list(quality.QUALITY._sinks))
    bus_subs = sum(len(v) for v in rt.bus._subs.values())
    rt.close()
    after = (list(tracer._sinks), list(metrics._collectors),
             list(quality.QUALITY._sinks))
    # FLIGHT.install adds its own sink once a process, and keeps it
    from quoracle_tpu_torch.infra.flightrec import FLIGHT
    assert [s for s in after[0] if s not in before[0]] in (
        [], [FLIGHT.record_span])
    assert after[1:] == before[1:]
    assert all(len(d) == len(b) + 1 for d, b in zip(during[1:], before[1:]))
    assert rt._trace_sink in during[0] and rt._trace_sink not in after[0]
    assert bus_subs > 0 and sum(len(v) for v in rt.bus._subs.values()) == 0
    assert not rt.watchdog.status()["running"]


# ---------------------------------------------------------------------------
# StallWatchdog
# ---------------------------------------------------------------------------

class Clock:
    """A scripted ``time`` for the runtime module."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


def test_stall_watchdog_trips_untrips_and_rearms(monkeypatch):
    def case(pkg):
        clock = Clock()
        monkeypatch.setattr(pkg.rt, "time", clock)
        bus = pkg.bus.EventBus()
        events = []
        bus.subscribe(pkg.bus.TOPIC_RESOURCES,
                      lambda t, e: events.append(
                          {k: v for k, v in e.items() if k != "dump_path"}))
        state = {"active": True, "progress": 0}
        wd = pkg.rt.StallWatchdog(bus, deadline_s=30.0)
        wd.add_source("loop:m", lambda: (state["active"],
                                         state["progress"]))
        wd.add_source("broken", lambda: 1 / 0)      # skipped, never trips
        stalls = pkg.telemetry.WATCHDOG_STALLS
        n0 = stalls.value(source="loop:m")
        seen = []

        def step(dt, **change):
            clock.t += dt
            state.update(change)
            seen.append((wd.check_now(), wd.status()["tripped"],
                         pkg.telemetry.WATCHDOG_STALLED.value(
                             source="loop:m")))
        step(0)                      # first sight
        step(10)                     # frozen, under the deadline
        step(21)                     # 31 s frozen: trips
        step(40)                     # still frozen, inside the cooldown
        step(80)                     # 4 deadlines since the trip: re-arms
        step(1, progress=1)          # progress: untrips
        step(31)                     # frozen again past the deadline
        step(1, active=False)        # drained: untrips
        step(100, active=True)       # active again: first sight
        step(29)                     # under the deadline
        return {"steps": seen, "trips": wd.trips, "events": events,
                "counter": stalls.value(source="loop:m") - n0,
                "status": wd.status(), "poll_s": wd.poll_s,
                "rearm": wd.rearm_cooldown_s}
    got = [case(pkg) for pkg in BOTH]
    assert view(got[1]) == view(got[0])
    port = got[1]
    assert [s[0] for s in port["steps"]] == [
        [], [], ["loop:m"], [], ["loop:m"], [], ["loop:m"], [], [], []]
    assert port["trips"] == port["counter"] == 3 == len(port["events"])
    assert port["steps"][2][2] == 1.0 and port["steps"][5][2] == 0.0
    assert port["status"]["sources"] == ["broken", "loop:m"]
    assert not port["status"]["running"]
    assert (port["poll_s"], port["rearm"]) == (7.5, 120.0)


def test_stall_watchdog_starts_only_with_sources():
    for pkg in BOTH:
        wd = pkg.rt.StallWatchdog(None, deadline_s=30.0)
        wd.start()
        assert not wd.status()["running"]
        wd.close()


# ---------------------------------------------------------------------------
# EventHistory
# ---------------------------------------------------------------------------

def _history_script(pkg):
    """The same broadcasts on each package's bus; every ring replayed."""
    B = pkg.bus
    bus = B.EventBus()
    h = pkg.event_history.EventHistory(bus, max_logs=4, max_messages=3,
                                       max_trace_spans=16)
    dropped = pkg.telemetry.TRACE_DROPPED_TOTAL
    d0 = dropped.value(ring="history")
    bus.broadcast(B.TOPIC_LIFECYCLE, {"event": "agent_spawned",
                                      "agent_id": "a1"})
    bus.broadcast(B.TOPIC_LIFECYCLE, {"event": "task_status_changed",
                                      "task_id": "t1", "status": "running"})
    bus.broadcast(B.TOPIC_LIFECYCLE, {"event": "task_status_changed",
                                      "task_id": "t2", "status": "paused"})
    for i in range(6):
        bus.broadcast(B.topic_agent_logs("a1"), {"event": "log",
                                                 "agent_id": "a1", "i": i})
        bus.broadcast(B.topic_agent_logs("a2"), {"event": "log",
                                                 "agent_id": "a2", "i": i})
        bus.broadcast(B.topic_task_messages("t1"), {
            "event": "task_message", "task_id": "t1",
            "message": {"from": "a1" if i % 2 else "user", "i": i}})
        bus.broadcast(B.topic_task_messages("t2"), {
            "event": "task_message", "task_id": "t2", "message": {}})
        for topic in (B.TOPIC_ACTIONS, B.TOPIC_SERVING, B.TOPIC_RESOURCES,
                      B.TOPIC_CLUSTER, B.TOPIC_FABRIC, B.TOPIC_FLEET,
                      B.TOPIC_TRAIN):
            bus.broadcast(topic, {"event": topic, "i": i})
        bus.broadcast(B.TOPIC_CONSENSUS, {"event": "consensus_audit",
                                          "task_id": f"t{i % 2}", "i": i})
    bus.broadcast(B.topic_agent_state("a1"), {"event": "state",
                                              "agent_id": "a1"})
    bus.broadcast(B.topic_agent_state("a1"), {"event": "anonymous"})
    for i in range(20):
        bus.broadcast(B.TOPIC_TRACE, {"trace_id": f"tr{i % 3}", "i": i})
    out = {"logs": [h.replay_logs(a) for a in ("a1", "a2")],
           "messages": [h.replay_messages(k) for k in ("t1", "a1", "user",
                                                       "t2")],
           "lifecycle": h.replay_lifecycle(),
           "actions": h.replay_actions(),
           "serving": h.replay_serving(),
           "resources": h.replay_resources(),
           "consensus": [h.replay_consensus(), h.replay_consensus("t1")],
           "cluster": h.replay_cluster(), "fabric": h.replay_fabric(),
           "fleet": h.replay_fleet(), "train": h.replay_train(),
           "traces": [h.replay_traces(), h.replay_traces("tr1")],
           "dropped": dropped.value(ring="history") - d0}
    h.close()
    bus.broadcast(B.TOPIC_ACTIONS, {"event": "after close"})
    h.track_agent("a9")
    out["closed"] = (h.replay_actions()[-1], sum(
        len(v) for v in bus._subs.values()))
    return out


def test_event_history_rings_after_the_same_bus_script():
    got = [_history_script(pkg) for pkg in BOTH]
    assert got[1] == got[0]
    port = got[1]
    assert [len(x) for x in port["logs"]] == [4, 0]
    assert port["dropped"] == 4 and len(port["traces"][0]) == 16
    assert port["closed"] == ({"event": "actions:all", "i": 5}, 0)


def test_event_history_ring_size_from_the_environment(monkeypatch):
    for value, want in (("8", 16), ("64", 64), ("junk", 512)):
        monkeypatch.setenv("QUORACLE_TRACE_RING", value)
        got = [pkg.event_history.EventHistory(pkg.bus.EventBus())
               .max_trace_spans for pkg in BOTH]
        assert got == [want, want]
