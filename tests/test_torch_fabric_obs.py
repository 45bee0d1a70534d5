"""What rides the port's fabric beside serving, against the JAX package's,
on the CPU: the fabric cases that tests/test_torch_fleetobs.py,
test_torch_treeobs.py and test_torch_quant.py left out until the fabric
was ported.

From tests/test_fleetobs.py: one session across two wire peers is one
contiguous timeline; temperature-0 texts with tracing on and off; the
MSG_OBS wire ops (spans, metrics) and the door's federation; a unified
peer's timeline (over the loopback fabric, where the JAX case uses a
socket: the parity tests ride loopback); the incident bundle under a
``fabric.send`` drop. From tests/test_treeobs.py: one agent tree across
two wire peers, the lineage stamp on the wire, the plane on and off. From
tests/test_quant.py: int8 peers over the wire against an int8 backend,
prefixd's int8 blobs. And the door's meta, embed and residency ops. Each
case runs on both packages over the same fp32 tiny weights
(tests/_cluster_parity.py); the observations must be equal, times and
ids dropped.
"""

import math
import os

import numpy as np
import pytest
import torch

from _cluster_parity import (
    JAX, MEMBER, PORT, SIDES, both, build_peer, jax_engine, own_incidents,
    port_engine, remote,
)
from quoracle_tpu.infra import fleetobs as jfleet
from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu.infra import treeobs as jtree
from quoracle_tpu.serving.fabric import prefixd as jpd
from quoracle_tpu.serving.fabric import wire as jwire
from quoracle_tpu.serving.kvtier import DiskPrefixStore as JDisk
from quoracle_tpu_torch.infra import fleetobs as tfleet
from quoracle_tpu_torch.infra import telemetry as ttel
from quoracle_tpu_torch.infra import treeobs as ttree
from quoracle_tpu_torch.serving.fabric import prefixd as tpd
from quoracle_tpu_torch.serving.fabric import wire as twire
from quoracle_tpu_torch.serving.kvtier import DiskPrefixStore as TDisk

torch.set_num_threads(1)

OBS = {"jax": dict(fleet=jfleet, tel=jtel, tree=jtree, pd=jpd,
                   wire=jwire, disk=JDisk),
       "port": dict(fleet=tfleet, tel=ttel, tree=ttree, pd=tpd,
                    wire=twire, disk=TDisk)}

MSGS = [{"role": "user", "content": "hello fleet observability, "
                                    "please elaborate at length"}]


def O(side, name):
    return OBS[side.name][name]


def req(side, sid=None, max_tokens=16, content=None, tree=None, cj=False):
    msgs = MSGS if content is None else [{"role": "user",
                                          "content": content}]
    return side.rt.QueryRequest(MEMBER, msgs, temperature=0.0,
                                max_tokens=max_tokens, session_id=sid,
                                constrain_json=cj, tree=tree)


@pytest.fixture(scope="module")
def fabric():
    """Per package: 1 prefill + 1 decode peer behind a front door over
    the loopback fabric."""
    out = {}
    for side in SIDES:
        peers = [build_peer(side, role="prefill", replica_id="prefill-0",
                            continuous_chunk=8),
                 build_peer(side, role="decode", replica_id="decode-0",
                            continuous_chunk=8)]
        out[side.name] = (side.door.FabricPlane(
            [remote(side, p) for p in peers]), peers)
    yield out
    for plane, peers in out.values():
        plane.close()
        for p in peers:
            p.close()


@pytest.fixture
def tree_plane():
    """Both packages' tree registries reset and on, around a case."""
    for t in (jtree, ttree):
        t.reset()
        t.enable()
    yield
    for t in (jtree, ttree):
        t.reset()
        t.enable()


# ---------------------------------------------------------------------------
# Fleet observability over the wire (tests/test_fleetobs.py)
# ---------------------------------------------------------------------------

def test_session_over_two_wire_peers_is_one_contiguous_timeline(fabric):
    def case(side):
        plane, _ = fabric[side.name]
        fleet = O(side, "fleet")
        fleet.SPANS.clear()
        sid = "obs-sess-1"
        out = plane.query([req(side, sid=sid)])
        assert out[0].ok, out[0].error
        tl = plane.pull_timeline(session_id=sid)
        assert tl["contiguous"], tl["trace_ids"]
        names = {s["name"] for s in tl["spans"]}
        assert {"door.request", "door.prefill_rpc", "door.decode_rpc",
                "peer.prefill", "peer.decode", "kv.export",
                "kv.adopt"} <= names
        tid = tl["trace_ids"][0]
        assert all(s["trace_id"] == tid for s in tl["spans"])
        assert tl["stages_sum_ms"] == tl["total_ms"] > 0
        st = tl["stages"]
        assert st["wire"] > 0 and st["prefill"] > 0 and st["decode"] > 0
        ts = [s["ts"] for s in tl["spans"]]
        assert ts == sorted(ts)
        tail = plane.query([side.rt.QueryRequest(
            MEMBER, MSGS, temperature=0.0, max_tokens=4)])[0]
        assert tail.ok
        return [out[0].text, tail.text, sorted(names), sorted(st),
                len(tl["trace_ids"])]
    both(case)


def test_temp0_bits_identical_tracing_on_vs_off(fabric):
    def case(side):
        plane, _ = fabric[side.name]
        fleet, tel = O(side, "fleet"), O(side, "tel")
        tel.TRACER.remove_sink(fleet.SPANS.record)
        try:
            off = plane.query([req(side, content="trace equality probe")])
        finally:
            tel.TRACER.add_sink(fleet.SPANS.record)
        on = plane.query([req(side, content="trace equality probe")])
        assert off[0].ok and on[0].ok
        assert off[0].text == on[0].text
        return on[0].text
    both(case)


def test_obs_wire_ops_serve_spans_and_metrics(fabric):
    def case(side):
        plane, _ = fabric[side.name]
        fleet = O(side, "fleet")
        fleet.SPANS.clear()
        sid = "obs-sess-2"
        assert plane.query([req(side, sid=sid)])[0].ok
        rep = plane.peers[1]
        spans = rep.pull_spans(session_id=sid)
        assert spans and all(s.get("session") == sid for s in spans)
        out = rep.obs_metrics()
        assert "quoracle_sched_rows_total" in out["state"]
        assert out["tokens_total"] >= 0
        fed = plane.federated_metrics(max_age_s=0.0)
        text = fed.render_prometheus()
        assert 'peer="decode-0"' in text and 'peer="fleet"' in text
        states = {p.replica_id: p.obs_metrics()["state"]
                  for p in plane.peers}
        oracle = fleet.federate(states)
        got = fed.quantiles("quoracle_sched_admit_wait_ms")
        want = oracle.quantiles("quoracle_sched_admit_wait_ms")
        assert got.keys() == want.keys()
        for p, v in got.items():
            assert (v is None and want[p] is None) or \
                math.isclose(v, want[p], rel_tol=1e-6), (p, v, want[p])
        assert plane.federated_metrics(max_age_s=60.0) is \
            plane.federated_metrics(max_age_s=60.0)
        return [sorted({s["name"] for s in spans}), out["replica_id"],
                sorted(got)]
    both(case)


def test_timeline_over_a_unified_peer():
    """tests/test_fleetobs.py's real-TCP timeline case over the loopback
    fabric: a unified peer's serve span joins the door's trace."""
    def case(side):
        peer = build_peer(side, role="unified", replica_id="uni-peer-0",
                          continuous_chunk=8)
        plane = side.door.FabricPlane([remote(side, peer)])
        try:
            O(side, "fleet").SPANS.clear()
            sid = "obs-uni-1"
            out = plane.query([req(side, sid=sid)])[0]
            assert out.ok, out.error
            tl = plane.pull_timeline(session_id=sid)
            assert tl["contiguous"] and tl["n_spans"] >= 2
            names = {s["name"] for s in tl["spans"]}
            assert "door.request" in names and "peer.serve" in names
            assert tl["stages"].get("serve", 0) > 0
            return [out.text, sorted(names), sorted(tl["stages"])]
        finally:
            plane.close()
            peer.close()
    both(case)


def test_incident_bundle_complete_under_fabric_send_drop(monkeypatch,
                                                         tmp_path):
    """decode-0's link drops every attempt: its silent signals mark it
    failed, which opens a correlated incident whose bundle holds the
    door's dump and every reachable peer's."""
    def case(side):
        monkeypatch.setenv("QUORACLE_INCIDENT_DIR",
                           str(tmp_path / side.name))
        peers = [build_peer(side, role=role, replica_id=rid,
                            continuous_chunk=8)
                 for role, rid in (("prefill", "prefill-0"),
                                   ("decode", "decode-0"),
                                   ("decode", "decode-1"))]
        with own_incidents(side):
            return incident_case(side, peers)

    def incident_case(side, peers):
        FA = side.faults
        plane = side.door.FabricPlane([remote(side, p, retries=1,
                                              backoff_ms=1.0)
                                       for p in peers])
        try:
            plan = FA.FaultPlan(3, [FA.FaultRule(
                "fabric.send", "drop", max_fires=1 << 30,
                match={"replica": "decode-0"})])
            with FA.CHAOS.arming(plan):
                outs = [plane.query([req(side, sid=f"inc-sess-{i}")])[0]
                        for i in range(4)]
            assert all(o.ok for o in outs), [o.error for o in outs]
            dead = [p.replica_id for p in plane.peers if not p.alive]
            assert dead == ["decode-0"]
            mine = [b for b in O(side, "fleet").INCIDENTS.list()
                    if b.get("kind") == "replica_dead"
                    and b.get("key") == "decode-0"]
            assert mine
            files = sorted(mine[0]["files"])
            assert any(f.startswith("local-") for f in files)
            peer_files = [f for f in files if f.startswith("peer-")]
            assert peer_files == ["peer-decode-1.json",
                                  "peer-prefill-0.json"]
            import json
            with open(os.path.join(mine[0]["path"],
                                   "peer-decode-1.json")) as f:
                dump = json.load(f)
            assert dump["n_events"] >= 1
            assert any(e.get("kind") == "incident_open"
                       for e in dump["events"])
            return [[o.text for o in outs], dead, peer_files,
                    mine[0]["kind"]]
        finally:
            plane.close()
            for p in peers:
                p.close()
    both(case)


# ---------------------------------------------------------------------------
# Agent trees over the wire (tests/test_treeobs.py)
# ---------------------------------------------------------------------------

def test_tree_across_two_wire_peers_is_one_coherent_view(fabric,
                                                        tree_plane):
    def case(side):
        plane, _ = fabric[side.name]
        tree = O(side, "tree")
        tree.register_spawn("agent-root", tree_id="task-w")
        kid = tree.register_spawn("agent-kid", parent_id="agent-root")
        out = plane.query([req(side, sid="tree-w-1", tree=kid.to_dict())])
        assert out[0].ok, out[0].error
        view = plane.pull_tree("task-w")
        assert view["enabled"] and view["conserved"]
        assert view["n_nodes"] == 2 and view["orphans"] == []
        assert view["roots"] == ["agent-root"]
        rows = {n["node_id"]: n for n in view["nodes"]}
        assert rows["agent-kid"]["wait_ns"] > 0
        assert rows["agent-root"]["subtree"]["wait_ns"] == \
            rows["agent-kid"]["wait_ns"]
        return [out[0].text, view["n_nodes"], view["roots"],
                rows["agent-kid"]["depth"],
                view["critical_path"]["node_ids"]]
    assert both(case)[4] == ["agent-root", "agent-kid"]


def test_handoff_envelope_carries_lineage_over_the_wire(tree_plane):
    def case(side):
        W, tree = O(side, "wire"), O(side, "tree")
        ctx = tree.TreeContext(tree_id="task-e", node_id="n-e",
                               parent_id="p-e", depth=3, ordinal=2)
        d = W.request_to_dict(req(side, sid="env-1", tree=ctx.to_dict()))
        assert d["tree"] == ctx.to_dict()
        back = W.request_from_dict(d)
        assert tree.TreeContext.from_dict(back.tree) == ctx
        d.pop("tree")
        assert W.request_from_dict(d).tree is None
        return W.encode_json(W.request_to_dict(back))
    both(case)


def test_temp0_bits_identical_tree_plane_on_vs_off(fabric, tree_plane):
    def case(side):
        plane, _ = fabric[side.name]
        tree = O(side, "tree")
        tree.register_spawn("eq-root", tree_id="task-eq")
        stamp = tree.REGISTRY.context_of("eq-root").to_dict()
        on_g = plane.query([req(side, content="tree equality probe",
                                tree=stamp)])[0]
        on_c = plane.query([req(side, content="tree equality probe json",
                                tree=stamp, cj=True)])[0]
        tree.disable()
        off_g = plane.query([req(side, content="tree equality probe")])[0]
        off_c = plane.query([req(side, content="tree equality probe json",
                                 cj=True)])[0]
        assert all(o.ok for o in (on_g, on_c, off_g, off_c))
        assert off_g.text == on_g.text and off_c.text == on_c.text
        return [on_g.text, on_c.text]
    both(case)


# ---------------------------------------------------------------------------
# int8 over the wire (tests/test_quant.py)
# ---------------------------------------------------------------------------

def test_quantized_mono_vs_wire_peer_selfconsistency():
    """An int8 backend against int8 prefill and decode peers: the
    int8-and-scales envelope crosses the wire codec, the text stays the
    backend's (greedy and constrained)."""
    def case(side):
        q = dict(quantize_weights=True, quantize_kv=True)
        if side is JAX:
            mono = side.rt.TPUBackend(
                [MEMBER], engines={MEMBER: jax_engine(**q)},
                continuous=True, continuous_chunk=8, **q)
        else:
            mono = side.rt.TorchBackend(
                [MEMBER], device="cpu", engines={MEMBER: port_engine(**q)},
                continuous=True, continuous_chunk=8, **q)
        peers = [build_peer(side, role=role, replica_id=rid,
                            continuous_chunk=8, **q)
                 for role, rid in (("prefill", "prefill-0"),
                                   ("decode", "decode-0"))]
        plane = side.door.FabricPlane([remote(side, p) for p in peers])
        try:
            a = mono.query([req(side)])[0]
            b = plane.query([req(side)])[0]
            assert a.ok and b.ok and b.text == a.text, (a.error, b.error)
            assert plane.wire_handoffs >= 1
            assert peers[1].backend.engines[MEMBER].kv_signature() \
                .endswith("-int8-q8kv")
            aj = mono.query([req(side, cj=True, max_tokens=32)])[0]
            bj = plane.query([req(side, cj=True, max_tokens=32)])[0]
            assert aj.ok and bj.ok and bj.text == aj.text
            return [a.text, aj.text, plane.wire_handoffs]
        finally:
            mono.close()
            plane.close()
            for p in peers:
                p.close()
    both(case)


def test_prefixd_roundtrips_int8_blobs(tmp_path):
    def case(side):
        svc = O(side, "pd").PrefixService(str(tmp_path / side.name))
        client = O(side, "pd").PrefixdClient(side.tr.LoopbackTransport(
            svc.handle, "prefixd", lock_name="fabric.prefixd"),
            "sig-int8-q8kv")
        tokens = list(range(128))
        key = O(side, "disk").block_key(tokens)
        k = np.full((2, 128, 2, 16), 7, np.int8)
        ks = np.full((2, 2, 128), 0.125, np.float32)
        if side is PORT:
            k, ks = torch.from_numpy(k), torch.from_numpy(ks)
        assert client.publish(key, tokens, k, k, ks, ks)
        got = client.fetch(key, tokens)
        assert got is not None and len(got) == 4
        return [str(got[0].dtype).split(".")[-1],
                [np.asarray(x).tobytes() for x in got]]
    assert both(case)[0] == "int8"


# ---------------------------------------------------------------------------
# The door's meta, embed and residency ops
# ---------------------------------------------------------------------------

def test_door_meta_and_residency_over_the_wire(fabric):
    """``count_tokens``, ``context_window`` and ``output_limit`` at the
    door answer what the peer's backend answers; the affinity guard asks
    the peer whether it still holds a session."""
    def case(side):
        plane, peers = fabric[side.name]
        backend = peers[0].backend
        text = "count these tokens over the wire, please"
        got = [plane.count_tokens(MEMBER, text),
               plane.context_window(MEMBER), plane.output_limit(MEMBER)]
        assert got == [backend.count_tokens(MEMBER, text),
                       backend.context_window(MEMBER),
                       backend.output_limit(MEMBER)]
        r = req(side, sid="meta-sess")
        assert plane.query([r])[0].ok
        holder = plane.router.affinity_of("meta-sess")
        resident = holder.session_resident(r)
        plane.drop_session("meta-sess")
        return [got, holder.role, resident, holder.session_resident(r)]
    assert both(case)[1:] == ["decode", True, False]


def test_door_embed_over_the_wire(fabric):
    """The port's door embeds through its first peer's embedder (flash on
    the card for 256-token chunks): the vectors the peer's backend gives,
    bit for bit, after the float32 bytes crossed the wire. (The JAX
    encoder's bf16 cache refuses the shared fp32 weights, so this case
    runs on the port alone.)"""
    plane, peers = fabric["port"]
    texts = ["alpha beta", "gamma", " ".join(["delta"] * 300)]
    got = plane.embed(texts)
    want = peers[0].backend.embed(texts)
    assert [v.dtype for v in got] == [np.float32] * 3
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
