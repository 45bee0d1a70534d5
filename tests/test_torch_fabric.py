"""The port's cross-host fabric (serving/fabric/ peer, frontdoor, prefixd;
cluster.RemoteReplica; the router's silent-peer scoring) against the JAX
package's, on the CPU.

The cases of tests/test_fabric.py, each run on both packages over the
same fp32 tiny weights (tests/_cluster_parity.py): every byte rides the
real wire codec over ``LoopbackTransport``, as the JAX tests do, and each
case returns what it observed; the two lists must be equal: the
temperature-0 texts, cached tokens and token counts, the handoff and
failover counters, the structured errors naming peer and phase, router
liveness and the ``/api/fabric`` view. Left out: ``host_layout`` and
``pool_sizing(hosts=)`` (the JAX ``parallel/``, ROADMAP Queue 1 item 12).

Real sockets: one runtime case serves a ``Runtime`` with
``fabric_listen="unified@127.0.0.1:0"`` to a front-door ``Runtime`` over
TCP and holds its text to a backend built as the peer runtime builds its
own. The JAX package's copy of that case fails: its peer runtime builds
its backend over an 8-device tensor-parallel submesh
(quoracle_tpu/runtime.py:542-545, with the 8 CPU devices tests/conftest.py
forces) while it compares against a single-device backend; the continuous
chunk (8 against the default 32) does not change the text. The port's
runtime serves one device, as its reference backend does. The case's
port is read back from the server, everything closes in a ``finally``,
and no fabric thread outlives the case.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _cluster_parity import (
    JAX, MEMBER, PORT, SIDES, backend, both, build_peer, remote, req, res,
)
from quoracle_tpu.infra import flightrec as jflight
from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu.serving import router as jrouter
from quoracle_tpu.serving.kvtier import DiskPrefixStore as JDisk
from quoracle_tpu.serving.fabric import frontdoor as jdoor
from quoracle_tpu.serving.fabric import peer as jpeer
from quoracle_tpu.serving.fabric import prefixd as jpd
from quoracle_tpu.serving.fabric import transport as jtr
from quoracle_tpu.serving.fabric import wire as jwire
from quoracle_tpu_torch.infra import flightrec as tflight
from quoracle_tpu_torch.infra import telemetry as ttel
from quoracle_tpu_torch.serving import router as trouter
from quoracle_tpu_torch.serving.fabric import frontdoor as tdoor
from quoracle_tpu_torch.serving.fabric import peer as tpeer
from quoracle_tpu_torch.serving.fabric import prefixd as tpd
from quoracle_tpu_torch.serving.fabric import transport as ttr
from quoracle_tpu_torch.serving.fabric import wire as twire
from quoracle_tpu_torch.serving.kvtier import DiskPrefixStore as TDisk

torch.set_num_threads(1)

FAB = {"jax": SimpleNamespace(peer=jpeer, door=jdoor, pd=jpd, tr=jtr,
                              wire=jwire, router=jrouter, flight=jflight,
                              tel=jtel, disk=JDisk),
       "port": SimpleNamespace(peer=tpeer, door=tdoor, pd=tpd, tr=ttr,
                               wire=twire, router=trouter, flight=tflight,
                               tel=ttel, disk=TDisk)}

MSGS = [{"role": "user", "content": "hello fabric world, please "
                                    "elaborate at length"}]


def F(side):
    return FAB[side.name]


@pytest.fixture(scope="module")
def mono():
    out = {side.name: backend(side, continuous=True, continuous_chunk=8)
           for side in SIDES}
    yield out
    for b in out.values():
        b.close()


@pytest.fixture(scope="module")
def fabric():
    """Per package: one prefill peer and one decode peer joined to a
    front door over the loopback fabric."""
    out = {}
    for side in SIDES:
        peers = [build_peer(side, role="prefill", replica_id="prefill-0",
                            continuous_chunk=8),
                 build_peer(side, role="decode", replica_id="decode-0",
                            continuous_chunk=8)]
        out[side.name] = (F(side).door.FabricPlane(
            [remote(side, p) for p in peers]), peers)
    yield out
    for plane, peers in out.values():
        plane.close()
        for p in peers:
            p.close()


# ---------------------------------------------------------------------------
# Temperature-0 equality over the wire
# ---------------------------------------------------------------------------

def test_fabric_greedy_bit_equal(mono, fabric):
    def case(side):
        plane, peers = fabric[side.name]
        a = mono[side.name].query([req(side, MSGS)])[0]
        b = plane.query([req(side, MSGS)])[0]
        assert a.ok and b.ok, (a.error, b.error)
        assert b.text == a.text
        assert plane.wire_handoffs >= 1
        assert peers[0].handoff.exports >= 1
        assert peers[1].handoff.adopts >= 1
        return [res(a), res(b), plane.wire_handoffs,
                peers[0].handoff.stats(), peers[1].handoff.stats()]
    both(case)


def test_fabric_constrained_json_bit_equal(mono, fabric):
    def case(side):
        plane, _ = fabric[side.name]
        a = mono[side.name].query([req(side, MSGS, cj=True,
                                       max_tokens=32)])[0]
        b = plane.query([req(side, MSGS, cj=True, max_tokens=32)])[0]
        assert a.ok and b.ok, (a.error, b.error)
        assert b.text == a.text
        return [res(a), res(b), plane.wire_handoffs]
    both(case)


def test_fabric_speculative_bit_equal():
    """Decode peers run the continuous + speculative path; the handed-off
    row's grammar state and session resume compose with draft/verify
    rounds."""
    def case(side):
        kw = dict(continuous=True, continuous_chunk=8,
                  draft_map={MEMBER: MEMBER}, draft_k=4)
        mono = backend(side, **kw)
        pre = build_peer(side, role="prefill", replica_id="prefill-0", **kw)
        dec = build_peer(side, role="decode", replica_id="decode-0", **kw)
        plane = F(side).door.FabricPlane([remote(side, pre),
                                          remote(side, dec)])
        try:
            a = mono.query([req(side, MSGS, sid="sp1", cj=True,
                                max_tokens=24)])[0]
            b = plane.query([req(side, MSGS, sid="sp1", cj=True,
                                 max_tokens=24)])[0]
            assert a.ok and b.ok, (a.error, b.error)
            assert b.text == a.text
            assert b.spec_rounds > 0
            return [res(a), res(b), b.spec_accepted_tokens]
        finally:
            mono.close()
            plane.close()
            pre.close()
            dec.close()
    both(case)


def test_session_handed_off_over_wire_then_affinity(mono, fabric):
    """Round 1 prefills on the prefill peer and hands the KV over the
    wire; round 2 routes by affinity to the decode peer holding the
    pages: no second handoff, the monolithic run's cached tokens."""
    def case(side):
        plane, _ = fabric[side.name]
        m = mono[side.name]
        a1 = m.query([req(side, MSGS, sid="conv1")])[0]
        b1 = plane.query([req(side, MSGS, sid="conv1")])[0]
        assert b1.text == a1.text
        handoffs = plane.wire_handoffs
        msgs2 = MSGS + [{"role": "assistant", "content": a1.text},
                        {"role": "user", "content": "continue."}]
        a2 = m.query([req(side, msgs2, sid="conv1")])[0]
        b2 = plane.query([req(side, msgs2, sid="conv1")])[0]
        assert a2.ok and b2.ok, (a2.error, b2.error)
        assert b2.text == a2.text
        assert plane.wire_handoffs == handoffs
        assert b2.cached_tokens == a2.cached_tokens > 0
        peer = plane.router.affinity_of("conv1")
        assert peer is not None and peer.role == "decode"
        held = peer.replica_id
        plane.drop_session("conv1")
        m.drop_session("conv1")
        assert plane.router.affinity_of("conv1") is None
        return [res(a1), res(b1), res(a2), res(b2), held]
    both(case)


# ---------------------------------------------------------------------------
# Fleet prefix service
# ---------------------------------------------------------------------------

def test_replica_warm_starts_purely_from_fleet_prefixd(tmp_path):
    """A donor publishes its prefix blocks to the fleet service; a FRESH
    peer (no disk, an empty host tier) warm-starts from the fleet alone:
    the donor's text, with cached tokens served."""
    def case(side):
        svc = F(side).pd.PrefixService(str(tmp_path / side.name))
        prompt = ("system: shared policy preamble for every agent "
                  "session. " * 6 + "task: restate the rules briefly.")
        msgs = [{"role": "user", "content": prompt}]

        def link():
            return F(side).tr.LoopbackTransport(
                svc.handle, "prefixd", lock_name="fabric.prefixd")

        donor = build_peer(side, replica_id="donor", continuous_chunk=8,
                           host_kv_mb=32)
        donor.attach_prefixd(link())
        want = donor.backend.query([req(side, msgs, sid="d1",
                                        max_tokens=12)])[0]
        donor.backend.drop_session("d1")
        tier = donor.backend.engines[MEMBER].sessions.tier
        tier.flush_spills()
        published = tier.prefixd.published
        assert published >= 1
        donor.close()
        fresh = build_peer(side, replica_id="fresh", continuous_chunk=8,
                           host_kv_mb=32)
        try:
            fresh.attach_prefixd(link())
            got = fresh.backend.query([req(side, msgs, sid="f1",
                                           max_tokens=12)])[0]
            tier2 = fresh.backend.engines[MEMBER].sessions.tier
            assert got.ok and got.text == want.text
            assert got.cached_tokens > 0
            assert tier2.prefixd.hits >= 1
            assert tier2.stats()["prefixd"]["hits"] >= 1
            return [res(want), res(got), published,
                    {k: v for k, v in tier2.prefixd.stats().items()
                     if k != "transport"}]
        finally:
            fresh.close()
    both(case)


def test_prefixd_corrupt_entry_rejected_serverside(tmp_path):
    """The service loads through DiskPrefixStore.load: a corrupted file
    is crc-rejected, unlinked and answered as a MISS; the chaos
    ``unavailable`` directive degrades to a miss too."""
    def case(side):
        root = tmp_path / side.name
        svc = F(side).pd.PrefixService(str(root))
        client = F(side).pd.PrefixdClient(F(side).tr.LoopbackTransport(
            svc.handle, "prefixd", lock_name="fabric.prefixd"), "sig-a")
        tokens = list(range(128))
        key = F(side).disk.block_key(tokens)
        k = np.ones((2, 128, 2, 4), np.float32)
        kk = k if side is JAX else torch.from_numpy(k)
        assert client.publish(key, tokens, kk, kk * 2)
        got = client.fetch(key, tokens)
        assert got is not None and np.array_equal(np.asarray(got[0]), k)
        (entry,) = [f.name for f in (root / "sig-a").iterdir()
                    if f.name.endswith(".npz")]
        p = root / "sig-a" / entry
        raw = bytearray(p.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        p.write_bytes(bytes(raw))
        assert client.fetch(key, tokens) is None
        assert not p.exists()
        FA = side.faults
        with FA.CHAOS.arming(FA.FaultPlan(0, [FA.FaultRule(
                "fabric.prefixd", "unavailable")])):
            assert client.fetch(key, tokens) is None
        assert client.degraded == 1
        return [entry, {k: v for k, v in client.stats().items()
                        if k != "transport"}]
    both(case)


# ---------------------------------------------------------------------------
# Degraded modes over the wire
# ---------------------------------------------------------------------------

def test_decode_peer_death_replaces_row_via_retained_bytes(mono):
    """A decode peer dying mid-row: the front door re-places its retained
    envelope BYTES onto the survivor; a second death with no survivor
    fails the row with a structured error naming the peer."""
    def case(side):
        peers = [build_peer(side, role="prefill", replica_id="prefill-0",
                            continuous_chunk=8),
                 build_peer(side, role="decode", replica_id="decode-1",
                            continuous_chunk=8),
                 build_peer(side, role="decode", replica_id="decode-2",
                            continuous_chunk=8)]
        plane = F(side).door.FabricPlane([remote(side, p) for p in peers])
        by_id = {p.replica_id: p for p in peers}
        try:
            want = mono[side.name].query([req(side, MSGS)])[0]
            first = plane.router.place("decode")
            for cb in by_id[first.replica_id].backend._cbatchers.values():
                cb.close()
            got = plane.query([req(side, MSGS)])[0]
            assert got.ok, got.error
            assert got.text == want.text
            assert plane.replaced >= 1
            assert plane.router.stats()["replicas"][
                first.replica_id]["alive"] is False
            survivor = [p for p in peers if p.role == "decode"
                        and p.replica_id != first.replica_id][0]
            for cb in survivor.backend._cbatchers.values():
                cb.close()
            got2 = plane.query([req(side, MSGS)])[0]
            assert not got2.ok
            assert "replica_failed" in got2.error
            assert survivor.replica_id in got2.error
            return [res(want), res(got), first.replica_id,
                    got2.error.split(":")[0],
                    f"replica={survivor.replica_id}" in got2.error,
                    "phase=decode" in got2.error, plane.replaced,
                    plane.cold_failovers,
                    sorted(p.replica_id for p in plane.peers
                           if not p.alive)]
        finally:
            plane.close()
            for p in peers:
                p.close()
    both(case)


def test_signature_skew_rejected_before_bytes_cold_degrade(
        mono, fabric, monkeypatch):
    """A version-skewed decode peer rejects the envelope from its HEADER
    and the front door serves the request cold on the decode tier: the
    text is unchanged and the peer stays alive."""
    def case(side):
        plane, peers = fabric[side.name]
        eng = peers[1].backend.engines[MEMBER]
        monkeypatch.setattr(eng, "kv_signature",
                            lambda: "skewed-signature", raising=False)
        cold0 = plane.cold_failovers
        want = mono[side.name].query([req(side, MSGS)])[0]
        got = plane.query([req(side, MSGS)])[0]
        assert got.ok, got.error
        assert got.text == want.text
        assert plane.cold_failovers == cold0 + 1
        assert all(p.alive for p in plane.peers)
        return [res(want), res(got), plane.cold_failovers - cold0]
    both(case)


def _fake_peer_handler(side, name, role, shed_ms=None, silent=None):
    """An engine-less peer: hello + signals + admit, enough surface for
    the router-level cases without building backends."""
    W = F(side).wire

    def handler(msg_type, payload):
        if silent is not None and silent["on"] \
                and msg_type != W.MSG_HELLO:
            raise W.TransportError(f"{name} partitioned")
        if msg_type == W.MSG_HELLO:
            return W.MSG_OK, W.encode_json(
                {"replica_id": name, "role": role, "pool": [MEMBER]})
        if msg_type == W.MSG_SIGNALS_POLL:
            return W.MSG_SIGNALS, W.encode_json(
                {"qos": True, "queue_depth": 1, "admit_wait_p95_ms": None,
                 "hbm_headroom": None, "admitted": 0, "shed": 0,
                 "age_s": 0.0})
        if msg_type == W.MSG_ADMIT:
            if shed_ms is not None:
                raise side.adm.OverloadedError(f"{name} saturated",
                                               retry_after_ms=shed_ms)
            return W.MSG_ADMITTED, W.encode_json({"priority": 1})
        return W.MSG_ERROR, W.error_payload("nope")
    return handler


def _fake(side, name, role, **kw):
    retries = kw.pop("retries", 2)
    return side.cl.RemoteReplica(F(side).tr.LoopbackTransport(
        _fake_peer_handler(side, name, role, **kw), name, retries=retries))


def test_silent_signals_worst_rank_then_mark_failed():
    """A peer whose signal polls fail is scored worst-rank (placement
    avoids it, the door never stalls); after the bounded silence streak
    it is marked FAILED and drops out."""
    def case(side):
        limit = F(side).router.SILENT_SIGNALS_LIMIT
        silent = {"on": False}
        a = _fake(side, "decode-a", "decode", silent=silent, retries=0)
        b = _fake(side, "decode-b", "decode")
        plane = F(side).door.FabricPlane([a, b])
        try:
            silent["on"] = True
            placed = []
            for _ in range(limit):
                b.backend.qos_controller._cached = None
                placed.append(plane.router.place("decode").replica_id)
            assert a.alive is False
            st = plane.router.stats()
            assert st["replicas"]["decode-a"]["alive"] is False
            placed.append(plane.router.place("decode").replica_id)
            return [limit, placed, st["replicas"]["decode-a"]["alive"],
                    st["silent"]]
        finally:
            plane.close()
    obs = both(case)
    assert set(obs[1]) == {"decode-b"}


def test_peer_rejoin_after_mark_failed():
    """A peer marked failed that answers its hello again rejoins through
    ``rejoin_peer``; while it stays down the sweep restores nothing; a
    DIFFERENT identity at the same address is refused."""
    def case(side):
        limit = F(side).router.SILENT_SIGNALS_LIMIT
        W = F(side).wire
        silent = {"on": False}
        down = {"on": False}
        base = _fake_peer_handler(side, "decode-a", "decode",
                                  silent=silent)

        def handler(msg_type, payload):
            if down["on"]:
                raise W.TransportError("decode-a fully partitioned")
            return base(msg_type, payload)

        a = side.cl.RemoteReplica(F(side).tr.LoopbackTransport(
            handler, "decode-a", retries=0))
        b = _fake(side, "decode-b", "decode")
        plane = F(side).door.FabricPlane([a, b])
        try:
            return rejoin(side, plane, a, b, silent, down, limit)
        finally:
            plane.close()

    def rejoin(side, plane, a, b, silent, down, limit):
        silent["on"] = True
        for _ in range(limit):
            b.backend.qos_controller._cached = None
            plane.router.place("decode")
        assert a.alive is False
        down["on"] = True
        swept_down = plane.try_rejoin_dead_peers()
        down["on"] = False
        silent["on"] = False
        swept_up = plane.try_rejoin_dead_peers()
        assert a.alive is True
        st = plane.router.stats()
        assert st["silent"].get("decode-a") is None
        rejoined = any(e.get("kind") == "fabric_peer_rejoin"
                       and e.get("peer") == "decode-a"
                       for e in F(side).flight.FLIGHT.snapshot())
        imposter = _fake(side, "decode-c", "decode")
        plane.peers.append(imposter)
        plane.router.register(imposter)
        imposter.alive = False
        plane.router.mark_failed("decode-c", "test")
        imposter.role = "prefill"
        refused = plane.rejoin_peer("decode-c")
        return [swept_down, swept_up, st["replicas"]["decode-a"]["alive"],
                rejoined, refused, imposter.alive]
    assert both(case) == [0, 1, True, True, False, False]


def test_frontdoor_add_and_remove_peer_loopback():
    def case(side):
        a = _fake(side, "decode-a", "decode")
        plane = F(side).door.FabricPlane([a])
        try:
            b = _fake(side, "decode-b", "decode")
            plane.peers.append(b)
            plane.router.register(b)
            n = len(plane.router.replicas("decode"))
            plane.router.set_affinity("s1", "decode-b")
            removed = plane.remove_peer("decode-b")
            left = [r.replica_id for r in plane.router.replicas("decode")]
            assert plane.router.affinity_of("s1") is None
            stats = plane.fabric_stats()
            return [n, removed, left,
                    [p["replica_id"] for p in stats["peers"]],
                    stats["enabled"], stats["disaggregated"],
                    stats["pool"]]
        finally:
            plane.close()
    assert both(case)[:3] == [2, True, ["decode-a"]]


def test_all_decode_peers_shed_propagates_max_retry_after():
    def case(side):
        a = _fake(side, "decode-a", "decode", shed_ms=1000)
        b = _fake(side, "decode-b", "decode", shed_ms=2000)
        plane = F(side).door.FabricPlane([a, b])
        try:
            with pytest.raises(side.adm.OverloadedError) as ei:
                plane.qos_controller.admit(tenant="t1")
            assert ei.value.retry_after_ms \
                == side.adm.escalate_retry_ms(2000, 1) >= 2000
            return [ei.value.retry_after_ms, plane.router.shed]
        finally:
            plane.close()
    assert both(case)[1] == 1


# ---------------------------------------------------------------------------
# Runtime / CLI / registries / surfaces
# ---------------------------------------------------------------------------

def test_runtime_fabric_flags_mock_refusal_and_cli():
    """The mock backend refuses the fabric flags, the front door refuses
    ``fabric_listen`` beside it, and the CLI parses the three flags, as
    in the JAX package (which names --backend tpu where the port names
    --backend torch)."""
    from quoracle_tpu_torch.cli import build_parser
    from quoracle_tpu_torch.runtime import Runtime, RuntimeConfig
    for kw in ({"fabric_listen": "prefill@127.0.0.1:9400"},
               {"fabric_peers": ["127.0.0.1:9400"]},
               {"prefixd": "127.0.0.1:9470"}):
        with pytest.raises(ValueError, match="--fabric|--prefixd"):
            Runtime(RuntimeConfig(backend="mock", **kw))
    with pytest.raises(ValueError, match="front-door"):
        Runtime(RuntimeConfig(backend="torch", device="cpu",
                              model_pool=[MEMBER],
                              fabric_peers=["127.0.0.1:1"],
                              fabric_listen="127.0.0.1:2"))
    ns = build_parser().parse_args(
        ["serve", "--fabric-listen", "decode@0.0.0.0:9400",
         "--fabric-peers", "prefill@h1:9400,decode@h2:9400",
         "--prefixd", "h3:9470"])
    assert ns.fabric_listen == "decode@0.0.0.0:9400"
    assert ns.fabric_peers == "prefill@h1:9400,decode@h2:9400"
    assert ns.prefixd == "h3:9470"
    from quoracle_tpu_torch.cli import _config
    cfg = _config(ns)
    assert cfg.fabric_peers == ["prefill@h1:9400", "decode@h2:9400"]


def _fabric_threads(prefix: str) -> list:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(prefix)]


def test_runtime_peer_and_frontdoor_over_real_tcp():
    """A Runtime serving its backend as a fabric peer over a real socket
    and a front-door Runtime connecting to it: one greedy request, its
    text equal to a backend built as the peer runtime builds its own
    (``TorchBackend([MEMBER], seed=0, continuous=True)``, the default
    chunk); the peer's server threads are gone after close."""
    from quoracle_tpu_torch.models.runtime import TorchBackend
    from quoracle_tpu_torch.runtime import Runtime, RuntimeConfig
    want_backend = TorchBackend([MEMBER], seed=0, device="cpu",
                                continuous=True)
    try:
        want = want_backend.query([req(PORT, MSGS)])[0]
    finally:
        want_backend.close()
    rt = Runtime(RuntimeConfig(backend="torch", device="cpu",
                               model_pool=[MEMBER], continuous=True,
                               fabric_listen="unified@127.0.0.1:0"))
    server_name = rt._fabric_peer._server.name
    try:
        addr = rt._fabric_peer._server.addr
        assert addr.startswith("127.0.0.1:") and not addr.endswith(":0")
        door = Runtime(RuntimeConfig(backend="torch",
                                     fabric_peers=[f"unified@{addr}"]))
        try:
            assert isinstance(door.backend, tdoor.FabricPlane)
            assert door.default_pool() == [MEMBER]
            got = door.backend.query([req(PORT, MSGS)])[0]
            assert got.ok, got.error
            assert got.text == want.text
            assert got.usage.completion_tokens \
                == want.usage.completion_tokens
            payload = door.backend.fabric_stats()
            assert [p["role"] for p in payload["peers"]] == ["unified"]
            assert payload["peers"][0]["transport"]["requests"] >= 2
        finally:
            door.close()
            door.backend.close()
    finally:
        rt.close()
        rt.backend.close()
    deadline = time.monotonic() + 5.0
    while _fabric_threads(server_name):
        assert time.monotonic() < deadline, _fabric_threads(server_name)
        time.sleep(0.02)


def test_fabric_registries_and_surfaces():
    def case(side):
        FA, FL, T = side.faults, F(side).flight, F(side).tel
        if side is JAX:
            from quoracle_tpu.analysis.lockdep import COARSE, RANKS
            from quoracle_tpu.infra.bus import EventBus, TOPIC_FABRIC
            from quoracle_tpu.infra.event_history import EventHistory
        else:
            from quoracle_tpu_torch.infra.bus import EventBus, TOPIC_FABRIC
            from quoracle_tpu_torch.infra.event_history import EventHistory
            from quoracle_tpu_torch.infra.locks import COARSE, RANKS
        for kind in ("fabric_frame_reject", "fabric_peer_dead",
                     "fabric_handoff_wire", "fabric_prefixd_degraded"):
            assert kind in FL.FLIGHT_EVENTS
        text = T.METRICS.render_prometheus()
        names = ("quoracle_fabric_requests_total", "quoracle_fabric_rtt_ms",
                 "quoracle_fabric_retries_total",
                 "quoracle_fabric_frame_rejects_total",
                 "quoracle_fabric_peers", "quoracle_fabric_prefixd_total")
        assert all(n in text for n in names)
        assert RANKS["router"] < RANKS["fabric.plane"] < RANKS["batcher"]
        assert RANKS["fabric.transport"] < RANKS["batcher"]
        assert RANKS["session.store"] < RANKS["fabric.prefixd"] \
            < RANKS["tier.disk"]
        assert "fabric.transport" in COARSE and "fabric.prefixd" in COARSE
        assert "fabric.send" in FA.INJECTION_POINTS
        assert "fabric.prefixd" in FA.INJECTION_POINTS
        bus = EventBus()
        hist = EventHistory(bus)
        try:
            bus.broadcast(TOPIC_FABRIC, {"event": "peer_failed",
                                         "peer": "decode-1"})
            ring = hist.replay_fabric()
            assert ring and ring[-1]["peer"] == "decode-1"
        finally:
            hist.close()
        return [RANKS[n] for n in ("router", "fabric.plane",
                                   "fabric.transport", "fabric.prefixd")]
    both(case)


def test_api_fabric_payload(fabric):
    def case(side):
        if side is JAX:
            from quoracle_tpu.web.server import DashboardServer
        else:
            from quoracle_tpu_torch.web.server import DashboardServer
        plane, _ = fabric[side.name]
        d = DashboardServer(SimpleNamespace(backend=plane))
        payload = d.fabric_payload()
        assert payload["enabled"] and payload["disaggregated"]
        assert "router" in payload and "requests" in payload["counters"]
        off = DashboardServer(SimpleNamespace(
            backend=object())).fabric_payload()
        assert off["enabled"] is False
        return [payload["enabled"], payload["disaggregated"],
                payload["pool"],
                sorted((p["replica_id"], p["role"], p["alive"])
                       for p in payload["peers"]),
                sorted(payload["counters"]), sorted(payload["obs"]),
                sorted(off)]
    both(case)
