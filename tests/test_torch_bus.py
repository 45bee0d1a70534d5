"""The port's event bus, escrow, costs and secrets against the JAX
package's: tests/test_infra.py's bus, escrow, cost and secret cases and
tests/test_races.py's bus and escrow cases (:137, :190, :226, :349), each
run through both packages on the same inputs, the observations compared
(exact: these modules are pure-Python copies)."""

import asyncio
import threading
from decimal import Decimal

import pytest

from _agent_parity import (
    BOTH, PORT, WAIT, both, install_watch, j, new_watch, run,
)


# ---------------------------------------------------------------------- bus

def test_bus_broadcast_and_unsubscribe():
    def case(pkg):
        bus = pkg.bus.EventBus()
        seen = []
        sub = bus.subscribe("t", lambda topic, ev: seen.append(ev))
        bus.broadcast("t", {"a": 1})
        sub.unsubscribe()
        bus.broadcast("t", {"a": 2})
        return seen
    assert both(case) == [{"a": 1}]


def test_bus_handler_error_does_not_break_broadcast():
    def case(pkg):
        bus = pkg.bus.EventBus()
        seen = []
        bus.subscribe("t", lambda topic, ev: 1 / 0)
        bus.subscribe("t", lambda topic, ev: seen.append(ev))
        bus.broadcast("t", {"ok": True})
        return seen
    assert both(case) == [{"ok": True}]


def test_agent_events_every_broadcast_and_topic():
    """All 13 AgentEvents functions under a fixed clock: the same topics
    and payloads in both packages, and the topic names themselves."""
    def case(pkg):
        bus = pkg.bus.EventBus()
        ev = pkg.bus.AgentEvents(bus, clock=lambda: 123.0)
        seen = []
        bus.subscribe("*", lambda t, e: seen.append((t, e)))
        ev.agent_spawned("a1", None, "task1", profile="p")
        ev.agent_terminated("a1", "normal")
        ev.agent_dismissed("a1", by="root")
        ev.task_status_changed("task1", "running")
        ev.state_updated("a1", {"k": 1})
        ev.todo_updated("a1", [{"task": "x"}])
        ev.log("a1", "info", "hello", extra=2)
        ev.decision_log("a1", {"action": "wait"})
        ev.raw_response_log("a1", "m", "txt")
        ev.cost_recorded("a1", {"amount": "1"})
        ev.budget_updated("a1", {"limit": "2"})
        ev.action_started("a1", "x1", "wait", {})
        ev.action_completed("a1", "x1", "wait", "ok")
        ev.task_message("task1", {"from": "a1"})
        topics = [getattr(pkg.bus, n) for n in sorted(dir(pkg.bus))
                  if n.startswith("TOPIC_")]
        return {"seen": seen, "topics": topics,
                "fns": [pkg.bus.topic_agent_state("a"),
                        pkg.bus.topic_agent_logs("a"),
                        pkg.bus.topic_agent_metrics("a"),
                        pkg.bus.topic_task_messages("t")]}
    got = both(case)
    assert len(got["seen"]) == 14
    assert got["seen"][0] == ("agents:lifecycle", {
        "event": "agent_spawned", "ts": 123.0, "agent_id": "a1",
        "parent_id": None, "task_id": "task1", "profile": "p"})


def test_bus_subscriber_death_does_not_break_delivery():
    def case(pkg):
        bus = pkg.bus.EventBus()
        got = []

        def dying(topic, event):
            raise RuntimeError("subscriber crashed")
        bus.subscribe("agents:lifecycle", dying)
        bus.subscribe("agents:lifecycle", lambda t, e: got.append(e))
        bus.subscribe("*", dying)
        events = pkg.bus.AgentEvents(bus, clock=lambda: 0.0)
        for i in range(5):
            events.agent_spawned(f"a{i}", None, "t1")
        return [e["agent_id"] for e in got]
    assert both(case) == [f"a{i}" for i in range(5)]


def test_bus_lock_is_the_ports_named_lock():
    """The port's bus takes its lock from the port's infra/locks.py (its
    own copy of the hierarchy), never from the JAX analysis package."""
    from quoracle_tpu_torch.infra.locks import TrackedLock
    lock = PORT.bus.EventBus()._lock
    assert isinstance(lock, TrackedLock) and lock.name == "bus"


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_subscribe_queue_wakes_a_waiting_getter_from_another_thread(pkg):
    """A broadcast from a foreign thread (the serving threads) reaches an
    asyncio subscriber already waiting on its queue: the push is
    marshalled with call_soon_threadsafe."""
    async def main():
        bus = pkg.bus.EventBus()
        _, q = bus.subscribe_queue("serving:metrics")
        getter = asyncio.ensure_future(q.get())
        await asyncio.sleep(0)                 # the getter now waits
        th = threading.Thread(target=bus.broadcast, args=(
            "serving:metrics", {"event": "serving_round"}))
        th.start()
        topic, ev = await asyncio.wait_for(getter, WAIT)
        th.join()
        return topic, ev
    assert run(main()) == ("serving:metrics", {"event": "serving_round"})


# ------------------------------------------------------------------- escrow

def test_escrow_lock_spend_release():
    def case(pkg):
        esc = pkg.budget.Escrow()
        esc.register("root", mode="root", limit="10.00")
        child = esc.lock_for_child("root", "c1", "4.00")
        out = {"child": child.snapshot(),
               "root_locked": esc.get("root").snapshot()}
        esc.record_spend("c1", "1.50")
        out["released"] = esc.release_child("c1")
        out["root"] = esc.get("root").snapshot()
        return out
    got = both(case)
    assert got["released"] == Decimal("2.50")
    assert got["root"] == {"mode": "root", "limit": "10.00",
                           "spent": "1.50", "committed": "0.00",
                           "available": "8.50"}


def test_escrow_refusals_clamps_and_adjusts():
    def case(pkg):
        out = {}
        esc = pkg.budget.Escrow()
        esc.register("root", mode="root", limit="1.00")
        with pytest.raises(pkg.budget.BudgetError) as e:
            esc.lock_for_child("root", "c1", "2.00")
        out["insufficient"] = str(e.value)
        with pytest.raises(pkg.budget.BudgetError) as e:
            esc.register("x", mode="root")
        out["no_limit"] = str(e.value)
        esc = pkg.budget.Escrow()
        esc.register("root", mode="root", limit="10.00")
        esc.lock_for_child("root", "c1", "2.00")
        esc.record_spend("c1", "3.00")
        out["over"] = esc.get("c1").over_budget
        out["clamped"] = esc.release_child("c1")
        out["root_after_overspend"] = esc.get("root").snapshot()
        esc.lock_for_child("root", "c2", "2.00")
        esc.adjust_child("root", "c2", "5.00")
        out["adjusted"] = [esc.get("c2").snapshot(),
                           esc.get("root").snapshot()]
        esc.record_spend("c2", "4.00")
        with pytest.raises(pkg.budget.BudgetError) as e:
            esc.adjust_child("root", "c2", "3.00")
        out["below_floor"] = str(e.value)
        with pytest.raises(pkg.budget.BudgetError) as e:
            esc.adjust_child("other", "c2", "3.00")
        out["not_child"] = str(e.value)
        esc2 = pkg.budget.Escrow()
        esc2.register("root", mode="na")
        out["unbudgeted"] = [esc2.lock_for_child("root", "c", "4.00")
                             .snapshot(), esc2.get("root").available]
        return out
    got = both(case)
    assert got["over"] and got["clamped"] == Decimal("0")
    assert got["root_after_overspend"]["spent"] == "2.00"
    assert got["unbudgeted"][1] is None


def test_escrow_out_of_order_release_preserves_budget():
    def case(pkg):
        esc = pkg.budget.Escrow()
        esc.register("P", mode="root", limit=Decimal("10"))
        esc.lock_for_child("P", "C", Decimal("10"))
        esc.lock_for_child("C", "G", Decimal("4"))
        esc.record_spend("G", Decimal("1"))
        esc.release_child("C")
        return [esc.release_child("G"), esc.get("P").snapshot()]
    got = both(case)
    assert got[0] == Decimal("3")
    assert got[1]["committed"] == "0"


def _escrow_hammer(pkg):
    """tests/test_races.py:137 on ``pkg``: 8 threads x 25 cycles of lock,
    adjust up, spend, adjust down and release on one parent ledger."""
    esc = pkg.budget.Escrow()
    limit = Decimal("100")
    esc.register("parent", mode="root", limit=limit)
    errors, spent = [], [Decimal(0)]
    lock = threading.Lock()

    def worker(t):
        try:
            for i in range(25):
                cid = f"c{t}-{i}"
                try:
                    esc.lock_for_child("parent", cid, Decimal("1.0"))
                except pkg.budget.BudgetError:
                    continue
                try:
                    esc.adjust_child("parent", cid, Decimal("1.5"))
                except pkg.budget.BudgetError:
                    pass
                esc.record_spend(cid, Decimal("0.03"))
                try:
                    esc.adjust_child("parent", cid, Decimal("0.5"))
                except pkg.budget.BudgetError:
                    errors.append(f"shrink refused for {cid}")
                esc.release_child(cid)
                with lock:
                    spent[0] += Decimal("0.03")
        except Exception as e:      # noqa: BLE001 — collected
            errors.append(repr(e))
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=WAIT)
    p = esc.get("parent")
    return {"errors": errors, "committed": p.committed,
            "spent_matches": p.spent == spent[0],
            "available_matches": p.available == limit - spent[0],
            "orphan": esc.child_allocation("c0-0")}


def test_escrow_concurrent_spawn_adjust_dismiss_conservation():
    got = both(_escrow_hammer)
    assert got == {"errors": [], "committed": Decimal(0),
                   "spent_matches": True, "available_matches": True,
                   "orphan": None}


def test_escrow_overdraw_impossible_under_contention():
    def case(pkg):
        esc = pkg.budget.Escrow()
        esc.register("parent", mode="root", limit=Decimal("5"))
        granted, over = [], []
        barrier = threading.Barrier(10)

        def worker(t):
            barrier.wait()
            try:
                esc.lock_for_child("parent", f"k{t}", Decimal("1.0"))
                granted.append(t)
                if esc.get("parent").committed > Decimal("5"):
                    over.append(t)
            except pkg.budget.BudgetError:
                pass
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(10)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
        return {"granted": len(granted), "over": over,
                "available": esc.get("parent").available}
    assert both(case) == {"granted": 5, "over": [],
                          "available": Decimal(0)}


# -------------------------------------------------------------------- costs

def test_cost_recorder_accumulator_aggregator():
    def case(pkg):
        bus = pkg.bus.EventBus()
        events = pkg.bus.AgentEvents(bus, clock=lambda: 1.0)
        seen = []
        bus.subscribe("agents:a1:metrics", lambda t, e: seen.append(e))
        esc = pkg.budget.Escrow()
        esc.register("a1", mode="root", limit="1.00")
        persisted = []
        rec = pkg.costs.CostRecorder(escrow=esc, events=events,
                                     persist_fn=persisted.append,
                                     clock=lambda: 5.0)
        rec.record(pkg.costs.CostEntry(
            agent_id="a1", task_id="t", amount=Decimal("0.25"),
            cost_type="model", model_spec="xla:tiny", input_tokens=3,
            output_tokens=4, measured_chip_ms=1.5))
        rec.record(pkg.costs.CostEntry(      # not budget-registered
            agent_id="ghost", task_id="t", amount=Decimal("0.5"),
            cost_type="manual"))
        acc = pkg.costs.CostAccumulator()
        acc.add("0.001", tokens=10)
        acc.add(Decimal("0.002"), tokens=20)
        entry = acc.flush_to(rec, "a1", "t1", model_spec="emb")
        again = acc.flush_to(rec, "a1", "t1")
        agg = pkg.costs.CostAggregator(rec)
        return {"seen": seen, "spent": esc.get("a1").spent,
                "entries": rec.entries_for("a1"), "entry": entry,
                "again": again, "persisted": len(persisted),
                "tree": agg.tree_total(["a1", "ghost"]),
                "by_model": agg.by_model("a1"),
                "token_cost": pkg.costs.token_cost(
                    types_cfg(), 1000, 2000)}
    got = both(case)
    assert got["spent"] == Decimal("0.253")
    assert got["entry"].amount == Decimal("0.003") and got["again"] is None
    assert got["seen"][0]["event"] == "cost_recorded"


def types_cfg():
    class Cfg:
        input_cost_per_mtok = 0.05
        output_cost_per_mtok = 0.15
    return Cfg


# ----------------------------------------------------------------- security

def test_resolve_and_scrub_secrets():
    def case(pkg):
        secrets = {"api_key": "sk-abcdef123456"}
        params = {"headers": {"auth": "Bearer {{SECRET:api_key}}"},
                  "items": ["{{SECRET:missing}}", "plain"],
                  "tup": ("{{SECRET:api_key}}", 3)}
        resolved, used = pkg.security.resolve_secrets(params, secrets.get)
        scrubbed = pkg.security.scrub_output(
            {"out": "saw abcdefgh-12345-xyz and abcdefgh-12345 and ab",
             "nested": ["abcdefgh-12345"]},
            {"long": "abcdefgh-12345", "longer": "abcdefgh-12345-xyz",
             "tiny": "ab"})
        return {"resolved": resolved, "used": sorted(used),
                "scrubbed": scrubbed,
                "none": pkg.security.scrub_output({"a": "b"}, {})}
    got = both(case)
    assert got["resolved"]["headers"]["auth"] == "Bearer sk-abcdef123456"
    assert got["resolved"]["items"][0] == "{{SECRET:missing}}"
    assert got["scrubbed"]["out"] == ("saw [REDACTED:longer] and "
                                      "[REDACTED:long] and ab")


def test_secret_store_generate_search_audit():
    def case(pkg):
        store = pkg.security.SecretStore()
        store.put("db_pass", "hunter2-hunter2", "the db", created_by="a1")
        s = store.generate("tok", length=24, charset="hex",
                           description="a token")
        lens = {name: len(store.generate(f"g-{name}", length=16,
                                         charset=name).value)
                for name in sorted(store.CHARSETS)}
        hexok = all(c in "0123456789abcdef" for c in s.value)
        store.lookup("db_pass", agent_id="a1", action="execute_shell")
        store.lookup("db_pass")                 # no agent: no audit row
        search = [{k: v for k, v in r.items() if k != "created_at"}
                  for r in store.search("DB")]
        out = {"len": len(s.value), "hex": hexok, "lens": lens,
               "search": search, "all": len(store.search()),
               "audit": [(a.secret_name, a.agent_id, a.action)
                         for a in store.audit_log()],
               "deleted": [store.delete("tok"), store.delete("tok")],
               "values": sorted(store.values())}
        return out
    got = both(case)
    assert got["len"] == 24 and got["hex"]
    assert got["search"] == [{"name": "db_pass", "description": "the db",
                              "created_by": "a1"}]
    assert got["audit"] == [("db_pass", "a1", "execute_shell")]


def test_normalize_copy():
    """The port's utils/normalize.py is now the whole JAX module."""
    def case(pkg):
        n = pkg.normalize
        return {"json": n.to_json({"s": {3, 1, "a"}, "t": (1, 2),
                                   "b": b"\xff", "e": ValueError("x"),
                                   "f": 1.5}),
                "norm": n.normalize_json({"k": (1, {2})}),
                "parts": n.stringify_content([
                    {"type": "text", "text": "hi"},
                    {"type": "image_base64", "data": "QUJD"}, "raw"]),
                "trunc": [n.truncate_response("x" * 100, 60),
                          n.truncate_response("short", 60)]}
    got = both(case)
    assert "truncated 40 of 100" in got["trunc"][0]


# ------------------------------------------------------------- the agents

@pytest.fixture
def watched(monkeypatch):
    install_watch(monkeypatch)


def test_bus_subscriber_death_does_not_kill_agents(watched):
    """tests/test_races.py:349 on both packages' agent stacks: a raising
    wildcard handler leaves a live agent deciding and executing."""
    def case(pkg):
        async def main():
            def respond(r):
                joined = "\n".join(str(m.get("content", ""))
                                   for m in r.messages)
                if "bus-death-task" in joined and "done-mark" not in joined:
                    return j("todo", {"items": [{"task": "done-mark"}]})
                return j("wait", {})
            backend = pkg.runtime.MockBackend(respond=respond)
            deps = pkg.state.AgentDeps.for_tests(backend)
            sup = pkg.supervisor.AgentSupervisor(deps)

            def dying(topic, event):
                raise RuntimeError("UI died")
            deps.events.bus.subscribe("*", dying)
            w = new_watch(deps)
            root = await sup.start_agent(pkg.state.AgentConfig(
                agent_id="agent-root", task_id="task-1",
                model_pool=list(backend.DEFAULT_POOL)))
            root.post({"type": "user_message", "content": "bus-death-task",
                       "from": "user"})
            await w.until(lambda: root.ctx.todos)
            alive = bool(deps.registry.agents_for_task("task-1"))
            await sup.terminate_agent("agent-root")
            return {"todos": root.ctx.todos, "alive": alive,
                    "after": len(deps.registry)}
        return run(main())
    assert both(case) == {"todos": [{"task": "done-mark"}], "alive": True,
                          "after": 0}
