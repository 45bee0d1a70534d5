"""The port's agent layer against the JAX package's: tests/
test_agent_runtime.py's 22 scenarios (the actor loop, waits, shells,
spawn and dismiss trees, budgets, consensus retries and stalls, batches,
secrets, the registry, the spawn/dismiss race, spawn retries), each run
on both packages with their own ``MockBackend``. Per scenario the two
runs must agree on histories, decisions, the registry, escrow, every
agent's bus events, span names and the tree registry, ids and times
dropped.

No test waits on a clock: ``Watch`` wakes on each handled mailbox
message and each broadcast. Shell commands that must go asynchronous
block on a flag file the test writes after the hand-off, and commands
that must stay synchronous get a sync threshold they cannot miss."""

import asyncio
import os
import re

import pytest

from quoracle_tpu_torch.serving.qos import Priority
from _agent_parity import (
    BOTH, PORT, WAIT_FOREVER, both, decisions, Env, idle, install_watch,
    j, results, run,
)

POOL = ["mock:consensus-model-1", "mock:consensus-model-2",
        "mock:consensus-model-3"]
SYNC_S = 60.0          # a sync threshold no quick command can miss


@pytest.fixture(autouse=True)
def watched(monkeypatch):
    install_watch(monkeypatch)
    for pkg in BOTH:
        pkg.treeobs.reset()
    yield
    for pkg in BOTH:
        pkg.treeobs.reset()


def scripted(pkg, *entries):
    """Same script for every pool member: unanimous round-1 consensus."""
    return pkg.runtime.MockBackend(scripts={m: list(entries) for m in POOL},
                                   respond=lambda r: WAIT_FOREVER)


def text_of(core):
    return [e.as_text() for e in core.ctx.history(POOL[0])]


def workdir(tmp_path, pkg):
    """A working directory per package: commands and paths stay relative,
    so both packages' histories hold the same text."""
    d = tmp_path / pkg.name
    d.mkdir(exist_ok=True)
    return d


def flag_cmd(flag: str, before: str = "", after: str = "") -> str:
    """A command that cannot finish before ``flag`` (relative to the
    agent's working directory) exists."""
    return (f"{before}while [ ! -e {flag} ]; do sleep 0.01; done; "
            f"{after}").strip()


# ---------------------------------------------------------------------------

def test_todo_then_wait_cycle():
    def case(pkg):
        async def main():
            env = Env(pkg, scripted(pkg, j("todo", {"items": [
                {"task": "greet", "done": False}]}), j("wait", {})))
            core = await env.start()
            core.post({"type": "user_message", "content": "make a todo list",
                       "from": "user"})
            await env.w.until(lambda: len(decisions(core)) >= 2
                              and idle(core))
            out = env.summary(core)
            await env.sup.terminate_agent("agent-root")
            out["after"] = len(env.deps.registry)
            env.close()
            return out
        return main()
    got = both(case)
    root = got["agent-root"]
    assert root["todos"] == [{"task": "greet", "done": False}]
    assert [d[2]["action"] for d in root["histories"][POOL[0]]
            if d[0] == "decision"] == ["todo", "wait"]
    assert got["after"] == 0
    assert got["spans"]["agent.decide_tick"] == 2


def test_message_wakes_indefinitely_waiting_agent():
    def case(pkg):
        async def main():
            env = Env(pkg, scripted(
                pkg, j("wait", {}), j("todo", {"items": [{"task": "r"}]}),
                j("wait", {})))
            core = await env.start()
            core.post({"type": "user_message", "content": "hold on",
                       "from": "user"})
            await env.w.until(lambda: len(decisions(core)) == 1
                              and idle(core))
            idle_todos = list(core.ctx.todos)        # still idle
            core.post({"type": "user_message", "content": "now act",
                       "from": "user"})
            await env.w.until(lambda: core.ctx.todos and idle(core))
            out = env.summary(core)
            out["idle_todos"] = idle_todos
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert got["idle_todos"] == []
    assert any("now act" in str(h)
               for h in got["agent-root"]["histories"][POOL[0]])


def test_timed_wait_fires_timeout():
    def case(pkg):
        async def main():
            env = Env(pkg, scripted(
                pkg, j("wait", {"duration": 1}),
                j("todo", {"items": [{"task": "after-timeout"}]}),
                j("wait", {})))
            core = await env.start()
            core.post({"type": "user_message", "content": "go",
                       "from": "user"})
            await env.w.until(lambda: core.ctx.todos and idle(core))
            out = env.summary(core)
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert any("wait period elapsed" in str(h)
               for h in got["agent-root"]["histories"][POOL[0]])


# ---------------------------------------------------------------------------
# Shell smart mode
# ---------------------------------------------------------------------------

def test_shell_sync_fast_command():
    def case(pkg):
        async def main():
            env = Env(pkg, scripted(
                pkg, j("execute_shell", {"command": "echo fast-path"}),
                j("wait", {})), shell_sync_threshold_s=SYNC_S)
            core = await env.start()
            core.post({"type": "user_message", "content": "run it",
                       "from": "user"})
            await env.w.until(lambda: len(decisions(core)) >= 2
                              and idle(core))
            out = env.summary(core)
            out["first"] = results(core)[0].as_text()
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert "fast-path" in got["first"] and '"sync": true' in got["first"]
    assert "NO_EXECUTE" in got["first"]


def test_shell_async_slow_command_completion_notification(tmp_path):
    def case(pkg):
        wd = workdir(tmp_path, pkg)
        flag = wd / "go"

        async def main():
            env = Env(pkg, scripted(
                pkg, j("execute_shell", {"command": flag_cmd(
                    "go", after="echo slow-done")}),
                j("wait", {}), j("wait", {})),
                shell_sync_threshold_s=0.05)
            core = await env.start(working_dir=str(wd))
            core.post({"type": "user_message", "content": "run it",
                       "from": "user"})
            # the hand-off's result and the decide after it first: the
            # completion then arrives at an idle agent in both packages
            await env.w.until(lambda: core.shell_routers
                              and len(results(core)) == 2 and idle(core))
            cmd_id = next(iter(core.shell_routers))
            flag.touch()
            await env.w.until(lambda: not core.shell_routers
                              and len(decisions(core)) >= 3
                              and idle(core))
            out = env.summary(core)
            out["cmd_ok"] = bool(re.match(r"cmd-[0-9a-f]+", cmd_id))
            out["completion"] = [t for t in text_of(core)
                                 if "finished with status" in t]
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert got["cmd_ok"] and len(got["completion"]) == 1
    assert re.search(r"cmd-[0-9a-f]{10}", got["completion"][0])
    assert "slow-done" in got["completion"][0]


def test_shell_check_id_poll_and_terminate():
    def case(pkg):
        async def main():
            env = Env(pkg, scripted(
                pkg, j("execute_shell", {"command": "sleep 30"}),
                j("wait", {})), shell_sync_threshold_s=0.05)
            core = await env.start()
            core.post({"type": "user_message", "content": "run",
                       "from": "user"})
            await env.w.until(lambda: core.shell_routers)
            cmd_id = next(iter(core.shell_routers))
            owner = core.shell_routers[cmd_id]
            poll = owner.poll_command()
            term = await owner.terminate_command()
            out = {"poll": poll, "term": term,
                   "gone": cmd_id not in core.shell_routers,
                   "exit": owner.cmd.proc.returncode}
            await env.w.until(lambda: idle(core))
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert got["poll"]["command_status"] == "running"
    assert got["term"]["command_status"] == "terminated" and got["gone"]
    assert got["exit"] is not None


def test_shell_early_output_not_lost_on_async_handoff(tmp_path):
    def case(pkg):
        wd = workdir(tmp_path, pkg)
        flag = wd / "go"

        async def main():
            env = Env(pkg, scripted(
                pkg, j("execute_shell", {"command": flag_cmd(
                    "go", before="echo early-marker; ",
                    after="echo late-marker")}),
                j("wait", {}), j("wait", {})),
                shell_sync_threshold_s=0.05)
            core = await env.start(working_dir=str(wd))
            core.post({"type": "user_message", "content": "run",
                       "from": "user"})
            await env.w.until(lambda: core.shell_routers
                              and len(results(core)) == 2 and idle(core))
            flag.touch()
            await env.w.until(lambda: any("finished with status" in t
                                          for t in text_of(core))
                              and idle(core))
            out = env.summary(core)
            out["completion"] = next(t for t in text_of(core)
                                     if "finished with status" in t)
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert "early-marker" in got["completion"]
    assert "late-marker" in got["completion"]


def test_shell_daemonizing_command_still_completes(tmp_path):
    """The shell exits while a backgrounded descendant holds its stdout
    open: completion keys off process exit, not pipe EOF."""
    def case(pkg):
        wd = workdir(tmp_path, pkg)
        flag = wd / "go"

        async def main():
            env = Env(pkg, scripted(
                pkg, j("execute_shell", {"command": flag_cmd(
                    "go", before="sleep 3 & echo daemon-started; ")}),
                j("wait", {}), j("wait", {})),
                shell_sync_threshold_s=0.05)
            core = await env.start(working_dir=str(wd))
            core.post({"type": "user_message", "content": "run",
                       "from": "user"})
            await env.w.until(lambda: core.shell_routers
                              and len(results(core)) == 2 and idle(core))
            flag.touch()
            await env.w.until(lambda: any(
                "finished with status completed" in t
                for t in text_of(core)) and idle(core))
            out = {"completion": next(t for t in text_of(core)
                                      if "finished with status" in t),
                   "routers": len(core.shell_routers)}
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert "daemon-started" in got["completion"] and got["routers"] == 0


def test_batch_with_two_slow_shells_gets_independent_owners(tmp_path):
    def case(pkg):
        wd = workdir(tmp_path, pkg)
        flags = [wd / n for n in ("one", "two")]

        async def main():
            env = Env(pkg, scripted(
                pkg, j("batch_async", {"actions": [
                    {"action": "execute_shell", "params": {
                        "command": flag_cmd(f.name, after=f"echo done-{n}")}}
                    for f, n in zip(flags, ("one", "two"))]}),
                j("wait", {}), j("wait", {}), j("wait", {})),
                shell_sync_threshold_s=0.05)
            core = await env.start(working_dir=str(wd))
            core.post({"type": "user_message", "content": "run",
                       "from": "user"})
            await env.w.until(lambda: len(core.shell_routers) == 2
                              and len(results(core)) == 2 and idle(core))
            ids = list(core.shell_routers)
            polls = {core.shell_routers[i].poll_command()["command_id"]
                     for i in ids}
            def finished():
                return " ".join(text_of(core)).count("finished with status")
            for k, f in enumerate(flags):                  # in turn
                f.touch()
                await env.w.until(lambda: finished() == k + 1
                                  and idle(core))
            await env.w.until(lambda: not core.shell_routers)
            out = {"distinct": len(set(ids)), "polled": polls == set(ids),
                   "texts": " ".join(text_of(core))}
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert got["distinct"] == 2 and got["polled"]
    assert "done-one" in got["texts"] and "done-two" in got["texts"]


# ---------------------------------------------------------------------------
# Spawn / message / dismiss across a real tree
# ---------------------------------------------------------------------------

def spawn_params(**over):
    p = dict(task_description="greet your parent",
             success_criteria="parent greeted",
             immediate_context="you were just created",
             approach_guidance="send one message then wait",
             profile="default")
    p.update(over)
    return p


def tree_respond(r):
    joined = "\n".join(str(m.get("content", "")) for m in r.messages)
    if "[TASK]" in joined:                       # the child
        if '"delivered_to"' in joined:
            return WAIT_FOREVER
        return j("send_message",
                 {"target": "parent", "content": "hello from child"})
    if '"dismissed"' in joined:                  # done: idle
        return WAIT_FOREVER
    if "hello from child" in joined:
        m = re.search(r'from="(agent-[0-9a-f]+)"', joined)
        return j("dismiss_child", {"child_id": m.group(1)})
    if '"agent_id"' in joined:
        return WAIT_FOREVER
    return j("spawn_child", spawn_params())


def test_spawn_child_message_dismiss_flow():
    def case(pkg):
        async def main():
            env = Env(pkg, pkg.runtime.MockBackend(respond=tree_respond))
            seen = {"spawned": [], "dismissed": [], "linked": []}

            def on_lifecycle(t, e):
                if e["event"] == "agent_spawned" and e.get("parent_id"):
                    seen["spawned"].append(e["agent_id"])
                    seen["linked"].append(env.deps.registry.lookup(
                        e["agent_id"]).parent_id == e["parent_id"])
                if e["event"] == "agent_dismissed":
                    seen["dismissed"].append(e["agent_id"])
            env.deps.events.bus.subscribe("agents:lifecycle", on_lifecycle)
            core = await env.start()
            core.post({"type": "user_message",
                       "content": "delegate the greeting", "from": "user"})
            await env.w.until(lambda: seen["dismissed"]
                              and not core.children and idle(core))
            out = env.summary(core, concurrent=True)
            out["seen"] = seen
            out["heard"] = any("hello from child" in t
                               for t in text_of(core))
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert got["seen"]["dismissed"] == got["seen"]["spawned"] \
        and got["seen"]["linked"] == [True]
    assert got["registry"] == [["agent-root", "None", "task-1", False]]
    assert got["heard"]
    assert got["agent-root"]["histories"][POOL[0]] == [
        "dismiss_child", "spawn_child", "wait"]
    # the tree registry saw the child under the root
    assert [r[:3] for r in got["tree"]] == [["agent-*", "agent-root", 1],
                                            ["agent-root", "None", 0]]


def test_spawn_oversized_field_is_presummarized():
    def case(pkg):
        async def main():
            blob = "conversation history line. " * 1600
            child_msgs: list = []

            def respond(r):
                joined = "\n".join(str(m.get("content", ""))
                                   for m in r.messages)
                if "Condense the following context" in joined:
                    return "SUMMARY-MARK: child must fix the parser."
                if "spawn-the-child" in joined \
                        and "child_spawned" not in joined \
                        and '"agent_id"' not in joined:
                    return j("spawn_child", spawn_params(
                        task_description="fix it", immediate_context=blob,
                        approach_guidance="carefully"))
                if "[IMMEDIATE CONTEXT]" in joined:
                    child_msgs.append(joined)
                return j("wait", {})
            env = Env(pkg, pkg.runtime.MockBackend(respond=respond))
            core = await env.start()
            core.post({"type": "user_message", "content": "spawn-the-child",
                       "from": "user"})
            await env.w.until(lambda: child_msgs)
            out = {"mark": "SUMMARY-MARK" in child_msgs[0],
                   "blob": blob in child_msgs[0],
                   "kept": "[APPROACH GUIDANCE]\ncarefully" in child_msgs[0]}
            await env.sup.terminate_tree("agent-root", by="test")
            env.close()
            return out
        return main()
    assert both(case) == {"mark": True, "blob": False, "kept": True}


def test_spawn_requires_budget_when_parent_budgeted():
    def case(pkg):
        async def main():
            env = Env(pkg, scripted(pkg, j("spawn_child", spawn_params()),
                                    j("wait", {})))
            core = await env.start(budget_mode="root", budget_limit="10.0")
            core.post({"type": "user_message", "content": "go",
                       "from": "user"})
            await env.w.until(lambda: len(decisions(core)) >= 2
                              and idle(core))
            out = env.summary(core)
            out["first"] = results(core)[0].as_text()
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert "budget is required" in got["first"]
    assert got["agent-root"]["children"] == []


def test_spawn_with_budget_escrows_and_dismiss_releases():
    def case(pkg):
        def respond(r):
            joined = "\n".join(str(m.get("content", "")) for m in r.messages)
            if "[TASK]" in joined:
                if '"delivered_to"' in joined:
                    return WAIT_FOREVER
                return j("send_message",
                         {"target": "parent", "content": "child done"})
            if '"dismissed"' in joined:
                return WAIT_FOREVER
            if "child done" in joined:
                m = re.search(r'from="(agent-[0-9a-f]+)"', joined)
                return j("dismiss_child", {"child_id": m.group(1)})
            if '"agent_id"' in joined:
                return WAIT_FOREVER
            return j("spawn_child", spawn_params(budget=4))

        async def main():
            env = Env(pkg, pkg.runtime.MockBackend(respond=respond))
            snaps = {}

            def on_lifecycle(topic, e):
                if e["event"] == "agent_spawned" \
                        and e.get("parent_id") == "agent-root":
                    snaps["root"] = env.deps.escrow.get(
                        "agent-root").snapshot()
                    snaps["child"] = env.deps.escrow.get(
                        e["agent_id"]).snapshot()
                if e["event"] == "agent_dismissed":
                    snaps["dismissed"] = e["agent_id"]
            env.deps.events.bus.subscribe("agents:lifecycle", on_lifecycle)
            core = await env.start(budget_mode="root", budget_limit="10.0")
            core.post({"type": "user_message", "content": "go",
                       "from": "user"})
            await env.w.until(lambda: "dismissed" in snaps
                              and not core.children and idle(core))
            out = env.summary(core, concurrent=True)
            out["snaps"] = snaps
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert got["snaps"]["root"]["committed"] == "4"
    assert got["snaps"]["child"]["limit"] == "4"
    assert got["agent-root"]["escrow"]["committed"] == "0"
    assert len(got["registry"]) == 1


def test_terminate_tree_is_bottom_up_and_idempotent():
    def case(pkg):
        async def main():
            env = Env(pkg, pkg.runtime.MockBackend(
                respond=lambda r: WAIT_FOREVER))
            await env.start()
            await env.start(agent_id="agent-mid", parent_id="agent-root")
            await env.start(agent_id="agent-leaf", parent_id="agent-mid")
            before = len(env.deps.registry)
            order = []
            env.deps.events.bus.subscribe("agents:lifecycle", lambda t, e: (
                order.append((e["event"], e["agent_id"]))
                if e["event"] in ("agent_terminated", "agent_dismissed")
                else None))
            n = await env.sup.terminate_tree("agent-mid", by="agent-root")
            again = await env.sup.terminate_tree("agent-mid")
            out = {"before": before, "n": n, "again": again,
                   "order": list(order),
                   "left": [r.agent_id for r in env.deps.registry.all()],
                   "tree": env.tree()}
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert got["before"] == 3 and got["n"] == 2 and got["again"] == 0
    assert got["left"] == ["agent-root"]
    assert [a for e, a in got["order"] if e == "agent_terminated"] == \
        ["agent-leaf", "agent-mid"]


# ---------------------------------------------------------------------------
# Consensus failure → correction feedback → retry
# ---------------------------------------------------------------------------

def test_consensus_retry_with_correction_feedback():
    def case(pkg):
        async def main():
            backend = pkg.runtime.MockBackend(scripts={
                m: ["this is not json at all",
                    j("todo", {"items": [{"task": "fixed"}]}), WAIT_FOREVER]
                for m in POOL}, respond=lambda r: WAIT_FOREVER)
            env = Env(pkg, backend)
            core = await env.start()
            core.post({"type": "user_message", "content": "go",
                       "from": "user"})
            await env.w.until(lambda: core.ctx.todos and idle(core))
            out = env.summary(core)
            out["retry_calls"] = sum(
                any("previous response was invalid"
                    in str(m.get("content", "")) for m in c.messages)
                for c in backend.calls)
            out["feedback"] = dict(core.ctx.correction_feedback)
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert got["agent-root"]["todos"] == [{"task": "fixed"}]
    assert got["retry_calls"] > 0 and got["feedback"] == {}


def test_consensus_stall_notifies_parent():
    def case(pkg):
        async def main():
            env = Env(pkg, pkg.runtime.MockBackend(
                respond=lambda r: "never valid json"))
            root = await env.start()
            child = await env.start(agent_id="agent-child",
                                    parent_id="agent-root",
                                    max_consensus_retries=2)
            child.post({"type": "user_message", "content": "go",
                        "from": "user"})

            def stalled():
                return any("consensus stalled" in str(m.get("content", ""))
                           for m in root.queued_messages) or any(
                    "consensus stalled" in e.as_text()
                    for e in root.ctx.history(POOL[0]))
            await env.w.until(stalled)
            out = {"child_failures": child.consensus_failures,
                   "child_events": env.rec.by_agent()["agent-child"][:8]}
            await env.sup.terminate_agent("agent-child")
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert got["child_failures"] == 0      # reset after notifying


# ---------------------------------------------------------------------------
# Batch actions, secrets, registry
# ---------------------------------------------------------------------------

def test_batch_sync_executes_in_order(tmp_path):
    def case(pkg):
        wd = workdir(tmp_path, pkg)
        path = "out.txt"

        async def main():
            env = Env(pkg, scripted(pkg, j("batch_sync", {"actions": [
                {"action": "todo", "params": {"items": [{"task": "a"}]}},
                {"action": "file_write", "params": {
                    "path": path, "content": "hello"}},
                {"action": "file_read", "params": {"path": path}}]}),
                j("wait", {})))
            core = await env.start(working_dir=str(wd))
            core.post({"type": "user_message", "content": "batch",
                       "from": "user"})
            await env.w.until(lambda: len(decisions(core)) >= 2
                              and idle(core))
            r = results(core)[0].content["result"]
            out = {"status": r["status"],
                   "actions": [x["action"] for x in r["results"]],
                   "read": r["results"][2]["content"]}
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    assert both(case) == {"status": "ok", "actions": [
        "todo", "file_write", "file_read"], "read": "hello"}


def test_batch_async_rejects_wait_at_validation():
    def case(pkg):
        async def main():
            backend = scripted(pkg, j("batch_async", {"actions": [
                {"action": "wait", "params": {}}]}), j("wait", {}))
            env = Env(pkg, backend)
            core = await env.start()
            core.post({"type": "user_message", "content": "batch",
                       "from": "user"})
            await env.w.until(lambda: results(core) and idle(core))
            out = env.summary(core)
            out["retry"] = sum(any("failed validation"
                                   in str(m.get("content", ""))
                                   for m in c.messages)
                               for c in backend.calls)
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert got["retry"] > 0
    assert [h[2]["action"] for h in got["agent-root"]["histories"][POOL[0]]
            if h[0] == "decision"] == ["wait"]


def test_secret_resolution_and_scrubbing():
    def case(pkg):
        async def main():
            env = Env(pkg, scripted(
                pkg, j("generate_secret", {"name": "api_key", "length": 24}),
                j("execute_shell",
                  {"command": "echo token={{SECRET:api_key}}"}),
                j("wait", {})), shell_sync_threshold_s=SYNC_S)
            core = await env.start()
            core.post({"type": "user_message", "content": "go",
                       "from": "user"})
            await env.w.until(lambda: len(decisions(core)) >= 3
                              and idle(core))
            value = env.deps.secrets.lookup("api_key")
            shell = results(core)[1].as_text()
            out = {"len": len(value), "leaked": value in shell,
                   "redacted": "[REDACTED:api_key]" in shell,
                   "audit": sorted({(a.secret_name, a.action) for a in
                                    env.deps.secrets.audit_log()})}
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    assert both(case) == {"len": 24, "leaked": False, "redacted": True,
                          "audit": [("api_key", "execute_shell")]}


def test_registry_queries():
    def case(pkg):
        reg = pkg.registry.AgentRegistry()
        reg.register("a", object(), None, "t1")
        reg.register("b", object(), "a", "t1")
        reg.register("c", object(), "a", "t1")
        reg.register("d", object(), None, "t2")
        with pytest.raises(pkg.registry.AlreadyRegisteredError):
            reg.register("a", object(), None, "t1")
        out = {"children": sorted(r.agent_id for r in reg.children_of("a")),
               "parent": reg.parent_of("b").agent_id,
               "no_parent": reg.parent_of("a"),
               "siblings": [r.agent_id for r in reg.siblings_of("b")],
               "task": sorted(r.agent_id for r in reg.agents_for_task("t1")),
               "dismiss": [reg.mark_dismissing("b"),
                           reg.mark_dismissing("b"), reg.dismissing("b"),
                           reg.mark_dismissing("zz")]}
        reg.unregister("d")
        out["len"] = len(reg)
        return out
    got = [case(pkg) for pkg in BOTH]
    assert got[0] == got[1]
    assert got[1]["children"] == ["b", "c"] and got[1]["len"] == 3


def test_spawn_dismiss_race_leaves_no_orphan():
    """A parent's async spawn is in flight when its tree is torn down:
    whichever side wins, the registry ends empty. The child's start is
    held until the dismissal has flagged the parent."""
    def case(pkg):
        async def main():
            release = asyncio.Event()

            class SlowSupervisor(pkg.supervisor.AgentSupervisor):
                async def start_agent(self, cfg, *a, **kw):
                    if cfg.agent_id != "agent-root":
                        await release.wait()
                    return await super().start_agent(cfg, *a, **kw)
            env = Env(pkg, scripted(pkg, j("spawn_child", spawn_params()),
                                    j("wait", {})),
                      supervisor_cls=SlowSupervisor)
            root = await env.start()
            root.post({"type": "user_message", "content": "go",
                       "from": "user"})
            await env.w.until(lambda: any(d.get("action") == "spawn_child"
                                          for d in decisions(root)))
            teardown = asyncio.ensure_future(env.sup.terminate_tree(
                "agent-root", by="test", reason="race"))
            await env.w.until(lambda: env.deps.registry.dismissing(
                "agent-root") or teardown.done())
            release.set()
            await teardown
            await env.w.until(lambda: not env.deps.registry.all())
            out = {"left": len(env.deps.registry)}
            env.close()
            return out
        return main()
    assert both(case) == {"left": 0}


def test_spawn_failure_retries_then_notifies_parent(monkeypatch):
    for pkg in BOTH:
        monkeypatch.setattr(pkg.executors, "SPAWN_RETRY_DELAY_S", 0.01)

    def respond(r):
        joined = "\n".join(str(m.get("content", "")) for m in r.messages)
        if '"saw-spawn-failure"' in joined:       # done: idle
            return WAIT_FOREVER
        if "FAILED: RuntimeError: child boom" in joined:
            return j("todo", {"items": [{"task": "saw-spawn-failure"}]})
        if '"agent_id"' in joined:
            return WAIT_FOREVER
        return j("spawn_child", spawn_params())

    def case(pkg):
        async def main():
            env = Env(pkg, pkg.runtime.MockBackend(respond=respond))
            root = await env.start()
            calls = []
            orig = env.sup.start_agent

            async def failing(cfg, *a, **k):
                calls.append(cfg.agent_id)
                raise RuntimeError("child boom")
            env.sup.start_agent = failing
            root.post({"type": "user_message", "content": "please spawn",
                       "from": "user"})
            await env.w.until(lambda: root.ctx.todos and idle(root))
            out = env.summary(root)
            out["calls"] = len(calls)
            out["registered"] = [env.deps.registry.lookup(c) is not None
                                 for c in calls]
            env.sup.start_agent = orig
            await env.sup.terminate_tree(root.agent_id, by="test",
                                         reason="done")
            env.close()
            return out
        return main()
    got = both(case)
    assert got["calls"] == PORT.executors.SPAWN_MAX_RETRIES
    assert got["registered"] == [False] * got["calls"]
    assert got["agent-root"]["todos"] == [{"task": "saw-spawn-failure"}]


# ---------------------------------------------------------------------------
# The port's own rules
# ---------------------------------------------------------------------------

def test_grove_path_stops_the_port_agent():
    """An agent whose grove cannot load fails closed at construction in
    both packages: the error reaches the spawner and nothing registers."""
    def case(pkg):
        async def main():
            env = Env(pkg, pkg.runtime.MockBackend())
            with pytest.raises(pkg.grove.GroveError) as err:
                await env.start(grove_path="/nonexistent/grove")
            out = (str(err.value), len(env.deps.registry))
            env.close()
            return out
        return run(main())
    got = [case(pkg) for pkg in BOTH]
    assert got[1] == got[0] and got[1][1] == 0
    assert "cannot read /nonexistent/grove/GROVE.md" in got[1][0]
    assert not os.path.exists("/nonexistent/grove")


def test_child_decides_at_its_depths_qos_class():
    """Each agent's consensus rows carry the QoS class its tree depth
    derives (serving/qos.priority_for_depth), in both packages."""
    def case(pkg):
        async def main():
            env = Env(pkg, pkg.runtime.MockBackend(respond=tree_respond))
            core = await env.start()
            core.post({"type": "user_message",
                       "content": "delegate the greeting", "from": "user"})
            await env.w.until(lambda: any(
                "hello from child" in t for t in text_of(core))
                and not core.children and idle(core))
            out = sorted({("child" if "[TASK]" in str(c.messages)
                           else "root", c.priority, c.tenant, c.task_id)
                          for c in env.backend.calls})
            await env.sup.terminate_agent("agent-root")
            env.close()
            return out
        return main()
    got = both(case)
    assert got == [("child", Priority.BATCH, "default", "task-1"),
                   ("root", Priority.AGENT, "default", "task-1")]
