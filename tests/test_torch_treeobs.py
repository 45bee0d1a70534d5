"""The port's session-graph plane (quoracle_tpu_torch/infra/treeobs.py)
against the JAX package's, on the CPU.

The scenarios of tests/test_treeobs.py that need no fabric, fleet or
simulator run through both packages and must give the same results:
context round trips, O(1) depth, exact rollup conservation and the
critical path, inherited budgets and their once-per-node overrun records,
the bounded LRU of completed trees, the kill switch, merges of loopback
and distinct registries, orphan flagging and the fan-out priors. On the
serving path a row submitted with a tree context books its wait
decomposition to its node, a handoff envelope carries the exporting
thread's tree context, and temperature-0 outputs are the same with the
plane on and off.
"""

import os
import re
import types

import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.infra import flightrec as jfr
from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu.infra import treeobs as jtree
from quoracle_tpu.serving import qos as jqos
from quoracle_tpu_torch.infra import flightrec as tfr
from quoracle_tpu_torch.infra import introspect as tintro
from quoracle_tpu_torch.infra import telemetry as ttel
from quoracle_tpu_torch.infra import treeobs as ttree
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import scheduler as tsch
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.serving import handoff as thand
from quoracle_tpu_torch.serving import qos as tqos

torch.set_num_threads(1)

JAX = types.SimpleNamespace(name="jax", tree=jtree, fr=jfr, tel=jtel,
                            qos=jqos)
PORT = types.SimpleNamespace(name="port", tree=ttree, fr=tfr, tel=ttel,
                             qos=tqos)
PKGS = (JAX, PORT)
WAIT = 120.0


@pytest.fixture(autouse=True)
def _clean_plane():
    for p in PKGS:
        p.tree.reset()
        p.tree.enable()
    yield
    for p in PKGS:
        p.tree.reset()
        p.tree.enable()


def both(script):
    out = {p.name: script(p) for p in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def flights(p, kind):
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in p.fr.FLIGHT.snapshot() if e["kind"] == kind]


def test_tree_context_roundtrip_and_survives_garbage():
    def script(p):
        ctx = p.tree.TreeContext(tree_id="t1", node_id="n1",
                                 parent_id="p1", depth=2, ordinal=1)
        assert p.tree.TreeContext.from_dict(ctx.to_dict()) == ctx
        bad = [p.tree.TreeContext.from_dict(g) for g in (
            None, "str", 7, [], {}, {"tree_id": "t"}, {"node_id": "n"},
            {"tree_id": "", "node_id": "n"}, {"tree_id": "t", "node_id": 3},
            {"tree_id": "t", "node_id": "n", "parent_id": 9},
            {"tree_id": "t", "node_id": "n", "depth": "x"})]
        with p.tree.bind(ctx):
            inner = p.tree.current() == ctx
            with p.tree.bind(None):
                kept = p.tree.current() == ctx
        return ctx.to_dict(), bad, inner, kept, p.tree.current()
    out = both(script)
    assert out[1] == [None] * 11 and out[2] and out[3] and out[4] is None


def test_depth_o1_equals_registry_walk_and_qos_class():
    def script(p):
        reg = p.tree.TreeRegistry()
        parent = {"r": None}
        reg.register_spawn("r", tree_id="task-d")
        cur = "r"
        for i in range(6):
            reg.register_spawn(f"c{i}", parent_id=cur)
            parent[f"c{i}"] = cur
            cur = f"c{i}"
        for i in range(3):
            reg.register_spawn(f"s{i}", parent_id="r")
            parent[f"s{i}"] = "r"

        def walk(nid):
            d, q = 0, parent[nid]
            while q is not None:
                d, q = d + 1, parent[q]
            return d
        for nid in parent:
            assert reg.depth_of(nid) == walk(nid)
        return ({n: (reg.depth_of(n),
                     int(p.qos.priority_for_depth(reg.depth_of(n))))
                 for n in parent}, reg.depth_of("ghost"))
    both(script)


def test_rollup_conservation_exact_and_critical_path():
    def script(p):
        t = p.tree
        r = t.register_spawn("root", tree_id="task-c")
        a = t.register_spawn("a", parent_id="root")
        b = t.register_spawn("b", parent_id="root")
        a1 = t.register_spawn("a1", parent_id="a")
        t.charge_decide(r, 1.0, 10, audit={"entropy_bits": 0.5,
                                           "margin": 0.25,
                                           "dissent": True})
        t.charge_decide(a, 2.0, 40)
        t.charge_decide(b, 0.5, 5)
        t.charge_decide(a1.to_dict(), 3.0, 60)
        t.charge_row_waits(a, {"waits_ns": {"queue": 7, "decode": 3}})
        return t.tree_payload("task-c")
    view = both(script)
    assert view["conserved"] and view["n_nodes"] == 4
    assert view["totals"] == {"chip_ns": 6_500_000, "tokens": 115,
                              "wait_ns": 10}
    assert view["critical_path"]["node_ids"] == ["root", "a", "a1"]
    assert view["fanout"] == {"0": 2.0, "1": 0.5, "2": 0.0}


def test_budget_inherited_and_overrun_fires_once_per_node():
    def script(p):
        t = p.tree
        before = len(flights(p, "tree_budget_overrun"))
        t.register_spawn("root", tree_id="task-b", token_budget=100)
        child = t.register_spawn("kid", parent_id="root")
        inherited = t.local_tree_state("task-b")["trees"]["task-b"][
            "kid"]["token_budget"]
        t.charge_decide(child, 1.0, 150)
        n1 = len(flights(p, "tree_budget_overrun")) - before
        t.charge_decide(child, 1.0, 500)
        evs = flights(p, "tree_budget_overrun")
        return inherited, n1, len(evs) - before, sorted(
            tuple(sorted(e.items())) for e in evs[-2:])
    out = both(script)
    assert out[:3] == (100, 2, 2)


def test_completed_trees_age_out_of_bounded_lru():
    def script(p):
        reg = p.tree.TreeRegistry(max_done_trees=2)
        for i in range(5):
            reg.register_spawn(f"t{i}-root", tree_id=f"t{i}")
            reg.complete_node(f"t{i}-root")
        st = reg.stats()
        reg.register_spawn("live-root", tree_id="live")
        for i in range(5, 9):
            reg.register_spawn(f"t{i}-root", tree_id=f"t{i}")
            reg.complete_node(f"t{i}-root")
        # registry_id counts the registries built in this process by each
        # package, so it differs with the tests that ran before: its
        # format is checked on each side and the rest compared
        end = reg.stats()
        ids = [s.pop("registry_id") for s in (st, end)]
        assert all(re.fullmatch(rf"{os.getpid():x}\.[0-9a-f]+", i)
                   for i in ids)
        assert ids[0] == ids[1] == reg.registry_id
        return (st, end, reg.depth_of("t4-root"),
                reg.depth_of("t0-root"), reg.depth_of("live-root"))
    out = both(script)
    assert out[0]["done"] == 2 and out[4] == 0


def test_kill_switch_disables_everything(monkeypatch):
    monkeypatch.setenv("QUORACLE_TREEOBS", "0")

    def script(p):
        t = p.tree
        t.reset()
        out = (t.enabled(), t.register_spawn("n", tree_id="t"),
               t.depth_of("n"))
        t.charge_decide(t.TreeContext("t", "n"), 1.0, 10)
        t.charge_row_waits(t.TreeContext("t", "n"), {"waits_ns": {"q": 1}})
        return out + (t.REGISTRY.stats()["nodes"], t.tree_payload("t"),
                      t.fanout_signals())
    assert both(script) == (False, None, None, 0,
                            {"enabled": False, "tree_id": "t"}, None)
    monkeypatch.setenv("QUORACLE_TREEOBS", "1")
    ttree.reset()
    assert ttree.enabled()


def test_merge_dedups_loopback_registries_sums_distinct_ones():
    def script(p):
        door, peer = p.tree.TreeRegistry(), p.tree.TreeRegistry()
        ctx = door.register_spawn("root", tree_id="task-m")
        door.charge_decide(ctx, 1.0, 10)
        peer.charge_decide(ctx, 2.0, 20)
        ds, ps = door.local_state("task-m"), peer.local_state("task-m")
        same = p.tree.merge_states([ds, ds, ds], "task-m")
        summed = p.tree.merge_states([ds, ps, ds, ps], "task-m")
        view = p.tree.tree_view("task-m", [ds, ps], registry=door)
        return same, summed, view
    same, summed, view = both(script)
    assert same["root"]["tokens"] == 10
    assert summed["root"]["tokens"] == 30 and view["conserved"]


def test_killed_peer_nodes_flagged_orphaned_once_never_unparented():
    def script(p):
        t = p.tree
        door, peer = t.TreeRegistry(), t.TreeRegistry()
        door.register_spawn("root", tree_id="task-k")
        kid = door.register_spawn("kid", parent_id="root")
        peer.charge_decide(kid, 2.0, 50)
        healthy = t.tree_view("task-k", [door.local_state("task-k"),
                                         peer.local_state("task-k")],
                              registry=door)
        before = p.tel.TREE_ORPHANS_TOTAL.value()
        orphaned = t.tree_view("task-k", [peer.local_state("task-k")],
                               registry=peer)
        t.tree_view("task-k", [peer.local_state("task-k")], registry=peer)
        return (healthy, orphaned,
                p.tel.TREE_ORPHANS_TOTAL.value() - before,
                flights(p, "tree_orphan")[-1])
    healthy, orphaned, delta, rec = both(script)
    assert healthy["orphans"] == [] and orphaned["orphans"] == ["kid"]
    assert orphaned["nodes"][0]["parent_id"] == "root" and delta == 1


def test_fanout_priors_equal_and_off_is_none():
    def script(p):
        p.tree.register_spawn("r", tree_id="t-f")
        for i in range(3):
            p.tree.register_spawn(f"c{i}", parent_id="r")
        p.tree.register_spawn("g0", parent_id="c0")
        pri = p.tree.fanout_signals()
        p.tree.disable()
        return pri, p.tree.fanout_signals()
    assert both(script) == ({"0": 3.0, "1": round(1 / 3, 4), "2": 0.0},
                            None)


def _engine():
    _, tcfg = both_configs("tiny")
    _, tp = shared_params("tiny", seed=4)
    return tgen.GenerateEngine(tcfg, tp, ttok.get_tokenizer("xla:tiny"),
                               device="cpu", max_seq=256,
                               prompt_buckets=(32, 64, 128))


def test_loop_rows_book_waits_to_their_node_and_outputs_unchanged():
    """A row submitted with a tree context books its exact wait
    decomposition to its node; with the plane off the same greedy and
    constrained rows come back identical and nothing is booked."""
    eng = _engine()
    p = eng.tokenizer.encode("user: tree equality probe", add_bos=True)
    tintro.enable()
    kid = None
    outs = []
    for on in (True, False):
        if on:
            ttree.register_spawn("eq-root", tree_id="task-eq")
            kid = ttree.register_spawn("eq-kid", parent_id="eq-root")
        else:
            ttree.disable()
        cb = tsch.ContinuousBatcher(eng, chunk=8)
        try:
            got = [cb.submit(p, temperature=0.0, max_new_tokens=20,
                             constrain_json=cj,
                             tree=kid.to_dict() if on else None
                             ).result(WAIT) for cj in (False, True)]
        finally:
            cb.close()
        outs.append([(g.token_ids, g.finish_reason) for g in got])
        if on:
            ttree.enable()
            view = ttree.tree_payload("task-eq")
            rows = {n["node_id"]: n for n in view["nodes"]}
            assert rows["eq-kid"]["wait_ns"] > 0 and view["conserved"]
            ttree.disable()
    assert outs[0] == outs[1]


def test_handoff_envelope_carries_tree_and_trace_context():
    src, dst = _engine(), _engine()
    for e in (src, dst):
        e.attach_tier(host_mb=64)
    p = src.tokenizer.encode("user: handoff lineage " * 4, add_bos=True)
    src.generate([p], temperature=0.0, max_new_tokens=4,
                 session_ids=["h1"])
    ctx = ttree.register_spawn("h-root", tree_id="task-h")
    spans = []
    ttel.TRACER.add_sink(spans.append)
    try:
        with ttree.bind(ctx), ttel.TRACER.span("door", trace_id="tr-h"):
            env = thand.KVHandoff().export(src, "h1", "xla:tiny")
        assert env.tree == ctx.to_dict()
        assert env.trace["trace_id"] == "tr-h"
        thand.KVHandoff().adopt(dst, env)
    finally:
        ttel.TRACER.remove_sink(spans.append)
    names = {s["name"]: s for s in spans}
    assert names["kv.export"]["trace_id"] == "tr-h"
    assert names["kv.adopt"]["trace_id"] == "tr-h"
    assert dst.sessions.get("h1") is not None


def test_tree_instruments_and_flight_kinds_registered():
    for name in ("quoracle_tree_nodes_total", "quoracle_tree_orphans_total",
                 "quoracle_tree_budget_overruns_total", "quoracle_tree_depth",
                 "quoracle_tree_fanout"):
        assert name in ttel.METRICS.snapshot(), name
    assert {"tree_orphan", "tree_budget_overrun"} <= set(tfr.FLIGHT_EVENTS)
    assert set(tfr.FLIGHT_EVENTS) == set(jfr.FLIGHT_EVENTS)
