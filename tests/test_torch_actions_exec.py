"""Every executor of the port's ``actions/executors.py`` through the
port's ``ActionRouter``, against the JAX package's: a scripted root agent
(each package's ``MockBackend``) decides a sequence of actions, and per
case both runs must agree on each action's result or error, the
agent's bus events, the cost entries, the escrow and what the action
left behind (files, secrets, skills, children). Covers the seventeen
executors the port registers, sync and async shells (polled, terminated,
unknown ids) and both batch modes (ordered stop, partial failure)."""

import asyncio
import os
import re
import time

import pytest

from _agent_parity import (
    BOTH, PORT, WAIT_FOREVER, Env, first_difference, idle, install_watch, j,
    results, run, scrub, view,
)

POOL = ["mock:consensus-model-1", "mock:consensus-model-2",
        "mock:consensus-model-3"]
SYNC_S = 60.0          # a sync threshold no quick command can miss

SKILL_MD = """---
name: grep-logs
description: Find errors in logs
---

Run grep -n ERROR over the log files.
"""


@pytest.fixture(autouse=True)
def watched(monkeypatch):
    install_watch(monkeypatch)
    for pkg in BOTH:
        pkg.treeobs.reset()


def stepper(pkg, steps):
    """Every member answers the root's k-th call with ``steps[k]`` (a
    callable step gets the joined prompt, e.g. to read a child's id),
    then waits; a child (its task in the prompt) always waits."""
    seen: dict = {}

    def respond(r):
        if "[TASK]" in "\n".join(str(m.get("content", ""))
                                 for m in r.messages):
            return WAIT_FOREVER
        k = seen.get(r.model_spec, 0)
        seen[r.model_spec] = k + 1
        if k >= len(steps):
            return WAIT_FOREVER
        step = steps[k]
        if callable(step):
            return step("\n".join(str(m.get("content", ""))
                                  for m in r.messages))
        return step
    return pkg.runtime.MockBackend(respond=respond)


def child_id_of(joined: str) -> str:
    return re.findall(r'"agent_id": "(agent-[0-9a-f]{12})"', joined)[-1]


def spawn(**over):
    p = dict(task_description="t", success_criteria="s",
             immediate_context="c", approach_guidance="g", profile="default")
    p.update(over)
    return p


CASES = {
    "wait": [j("wait", {"reason": "nothing to do"})],
    "orient": [j("orient", {"current_understanding": "u",
                            "progress_assessment": "p", "risks": "r"})],
    "todo": [j("todo", {"items": [{"task": "a"}, {"task": "b",
                                                  "done": True}]})],
    "send_message": [j("send_message", {"target": "children",
                                        "content": "hi kids"}),
                     j("send_message", {"target": "announcement",
                                        "content": "all hands"}),
                     j("send_message", {"target": "parent",
                                        "content": "up"}),
                     j("send_message", {"target": "agent-nobody",
                                        "content": "?"})],
    "files": [j("file_write", {"path": "notes/a.txt", "content": "l1\nl2\n"}),
              j("file_write", {"path": "notes/a.txt", "content": "l3\n",
                               "append": True}),
              j("file_read", {"path": "notes/a.txt", "offset": 1,
                              "limit": 1}),
              j("file_read", {"path": "notes/missing.txt"})],
    "shell_sync": [j("execute_shell", {"command": "echo out; exit 3"}),
                   j("execute_shell", {"command": "pwd",
                                       "working_dir": "/nonexistent-dir"}),
                   j("execute_shell", {"check_id": "cmd-0000000000"})],
    # the spawn's decision waits; the next phase starts (a user message)
    # once the child runs, so the root decides with the child known
    "spawn_dismiss": [j("spawn_child", spawn(budget=2), wait=True), None,
                      lambda t: j("adjust_budget", {"child_id": child_id_of(t),
                                                    "amount": 3}),
                      lambda t: j("adjust_budget", {"child_id": child_id_of(t),
                                                    "amount": 100}),
                      lambda t: j("dismiss_child", {"child_id": child_id_of(t)}),
                      j("dismiss_child", {"child_id": "agent-000000000000"}),
                      j("adjust_budget", {"child_id": "agent-000000000000",
                                          "amount": 1})],
    "costs": [j("record_cost", {"amount": 0.25, "description": "api"}),
              j("record_cost", {"amount": 1.5, "description": "float"})],
    "secrets": [j("generate_secret", {"name": "tok", "length": 12,
                                      "charset": "hex"}),
                j("generate_secret", {"name": "pw", "value": "p4ssw0rd-long",
                                      "description": "the pw"}),
                j("search_secrets", {"query": "pw"}),
                j("execute_shell", {"command": "echo {{SECRET:pw}} "
                                               "{{SECRET:nope}}"})],
    "skills": [j("learn_skills", {"skills": ["grep-logs"]}),
               j("learn_skills", {"skills": ["missing-skill"]}),
               j("create_skill", {"name": "new-skill", "description": "d",
                                  "content": "body"}),
               j("create_skill", {"name": "bad name!", "description": "d",
                                  "content": "x"})],
    "batch_sync": [j("batch_sync", {"actions": [
        {"action": "todo", "params": {"items": [{"task": "x"}]}},
        {"action": "file_read", "params": {"path": "missing.txt"}},
        {"action": "orient", "params": {"current_understanding": "u",
                                        "progress_assessment": "p"}}]})],
    "batch_async": [j("batch_async", {"actions": [
        {"action": "file_write", "params": {"path": "b.txt",
                                            "content": "B"}},
        {"action": "file_read", "params": {"path": "nope.txt"}},
        {"action": "execute_shell", "params": {"command": "echo batched"}}]})],
}


def status_of(content) -> str:
    """An action result's status; untrusted results are fenced text."""
    if isinstance(content, dict):
        return content["result"]["status"]
    return re.findall(r'"status": "(\w+)"', content)[-1]


def pkg_dir(tmp_path, pkg):
    """The package's working directory: same length for both packages,
    so absolute paths in results count the same tokens; ``view`` of a
    result then replaces it with ``<wd>``."""
    d = tmp_path / ("a" if pkg is BOTH[0] else "b") / "wd"
    d.mkdir(parents=True, exist_ok=True)
    return d


def wd_view(x, wd):
    """``view(x)`` with the working directory's path as ``<wd>``."""
    x = view(x)
    if isinstance(x, dict):
        return {k: wd_view(v, wd) for k, v in x.items()}
    if isinstance(x, list):
        return [wd_view(v, wd) for v in x]
    return x.replace(str(wd), "<wd>") if isinstance(x, str) else x


def run_case(pkg, name, tmp_path):
    wd = pkg_dir(tmp_path, pkg)
    (wd / "skills" / "grep-logs").mkdir(parents=True, exist_ok=True)
    (wd / "skills" / "grep-logs" / "SKILL.md").write_text(SKILL_MD)
    # None splits the script into phases: each later one starts with a
    # user message once the whole tree is idle
    phases, cur = [], []
    for step in CASES[name] + [None]:
        if step is None:
            phases.append(cur)
            cur = []
        else:
            cur.append(step)
    steps = [x for x in CASES[name] if x is not None]

    async def main():
        env = Env(pkg, stepper(pkg, steps), shell_sync_threshold_s=SYNC_S,
                  skills=pkg.skills.SkillsLoader(
                      global_dir=str(wd / "skills")))
        over = dict(working_dir=str(wd))
        if name == "spawn_dismiss":
            over.update(budget_mode="root", budget_limit="10")
        core = await env.start(**over)
        done = 0
        for k, phase in enumerate(phases):
            done += len(phase)
            core.post({"type": "user_message", "from": "user",
                       "content": f"case {name}" if k == 0 else "continue"})
            await env.w.until(lambda: len(results(core)) >= done and all(
                idle(r.core) for r in env.deps.registry.all()))
        out = {"results": [wd_view(e.content, wd) for e in results(core)],
               "events": [(scrub(e["agent_id"]), e["event"], e["action"])
                          for t, e in env.rec.events if t == "actions:all"],
               "root_events": env.rec.by_agent()["agent-root"],
               # a model entry's tokens count the prompt, which holds
               # the history's timestamps (search_secrets' created_at):
               # their digits vary, so model entries drop token counts
               "costs": [view(c) if c.cost_type != "model" else
                         view({**vars(c), "input_tokens": None,
                               "output_tokens": None})
                         for c in env.deps.costs.entries_for("agent-root")],
               "escrow": env.deps.escrow.get("agent-root").snapshot(),
               "todos": core.ctx.todos,
               "active_skills": list(core.active_skills),
               "secrets": sorted(s["name"] for s in
                                 env.deps.secrets.search()),
               "files": sorted(str(p.relative_to(wd)) for p in
                               wd.rglob("*") if p.is_file()),
               "children": len(core.children),
               "registry": len(env.deps.registry),
               "spans": env.span_names()}
        await env.sup.terminate_tree("agent-root", by="test")
        env.close()
        return out
    return run(main())


@pytest.mark.parametrize("name", sorted(CASES))
def test_executor_through_the_router(name, tmp_path):
    got = [run_case(pkg, name, tmp_path) for pkg in BOTH]
    assert view(got[1]) == view(got[0]), first_difference(view(got[0]),
                                                          view(got[1]))
    port = got[1]
    n = len([x for x in CASES[name] if x is not None])
    statuses = [status_of(r) for r in port["results"][:n]]
    if name == "send_message":
        assert statuses == ["ok", "ok", "error", "error"]
    elif name == "files":
        assert statuses == ["ok", "ok", "ok", "error"]
        assert port["results"][2]["result"]["content"] == "l2\n"
    elif name == "shell_sync":
        assert statuses == ["ok", "error", "error"]
        assert '"exit_code": 3' in port["results"][0]
    elif name == "spawn_dismiss":
        assert statuses == ["ok", "ok", "error", "ok", "error", "error"]
        assert port["escrow"]["committed"] == "0"
        assert port["children"] == 0 and port["registry"] == 1
    elif name == "costs":
        assert [c["amount"] for c in port["costs"]
                if c["cost_type"] == "manual"] == ["0.25", "1.5"]
    elif name == "secrets":
        assert statuses == ["ok", "ok", "ok", "ok"]
        assert port["secrets"] == ["pw", "tok"]
        assert "p4ssw0rd-long" not in str(port["results"][3])
    elif name == "skills":
        assert statuses == ["ok", "error", "ok", "error"]
        assert port["active_skills"] == ["grep-logs"]
        assert "skills/new-skill/SKILL.md" in port["files"]
    elif name == "batch_sync":
        assert port["results"][0]["result"]["status"] == "partial"
        assert len(port["results"][0]["result"]["results"]) == 2
    elif name == "batch_async":
        assert port["results"][0]["result"]["status"] == "partial"
        assert "b.txt" in port["files"]
    else:
        assert statuses == ["ok"]


def _async_shell(pkg, tmp_path, terminate: bool):
    """An async command (it waits on a flag file), polled by check_id,
    then terminated by check_id or released and completed."""
    wd = pkg_dir(tmp_path, pkg)
    # silent until released: a poll's output cannot depend on how far the
    # shell got before it
    cmd = "while [ ! -e go ]; do sleep 0.01; done; echo started; echo ended"

    def cid(t):
        return re.findall(r"cmd-[0-9a-f]{10}", t)[-1]
    steps = [j("execute_shell", {"command": cmd}),
             lambda t: j("execute_shell", {"check_id": cid(t)})]
    if terminate:
        steps.append(lambda t: j("execute_shell", {"check_id": cid(t),
                                                   "terminate": True}))

    async def main():
        env = Env(pkg, stepper(pkg, steps), shell_sync_threshold_s=0.05)
        core = await env.start(working_dir=str(wd))
        core.post({"type": "user_message", "content": "shell",
                   "from": "user"})
        await env.w.until(lambda: len(results(core)) >= len(steps)
                          and idle(core))
        if not terminate:
            (wd / "go").touch()
            await env.w.until(lambda: not core.shell_routers
                              and any("finished with status" in e.as_text()
                                      for e in core.ctx.history(POOL[0]))
                              and idle(core))
        out = {"results": [wd_view(e.content, wd) for e in results(core)],
               "routers": len(core.shell_routers),
               "completion": [view(e.content) for e in
                              core.ctx.history(POOL[0])
                              if "finished with status" in e.as_text()],
               "events": env.rec.names("actions:all")}
        await env.sup.terminate_agent("agent-root")
        env.close()
        return out
    return run(main())


@pytest.mark.parametrize("terminate", [False, True],
                         ids=["completes", "terminated"])
def test_async_shell_poll_and_finish(terminate, tmp_path):
    got = [_async_shell(pkg, tmp_path, terminate) for pkg in BOTH]
    assert view(got[1]) == view(got[0]), first_difference(view(got[0]),
                                                          view(got[1]))
    port = got[1]
    assert port["routers"] == 0
    first = str(port["results"][0])
    assert '"async": true' in first
    assert "command_status" in str(port["results"][1])
    if terminate:
        assert "terminated" in str(port["results"][2])
        assert port["completion"] == []
    else:
        assert "started" in str(port["completion"]) \
            and "ended" in str(port["completion"])


def group_alive(pgid: int) -> list:
    """Live (not zombie) processes of process group ``pgid``."""
    live = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()
        if int(fields[2]) == pgid and fields[0] != "Z":
            live.append(int(d))
    return live


def test_terminating_an_agent_kills_its_shells_process_group(tmp_path):
    """tests/test_races.py's terminate-mid-shell case on the port: the
    command's loop runs in a subshell of the shell, so only a kill of
    the whole process group reaps it; terminate_agent must. (The shell
    forks and the kernel delivers SIGKILL asynchronously: each check
    allows a bounded moment, which a surviving process would outlast.)"""
    cmd = "(while true; do sleep 0.05; done) & wait"

    async def main():
        env = Env(PORT, stepper(PORT, [j("execute_shell", {"command": cmd})]),
                  shell_sync_threshold_s=0.05)
        core = await env.start(working_dir=str(tmp_path))
        core.post({"type": "user_message", "content": "go", "from": "user"})
        await env.w.until(lambda: core.shell_routers)
        proc = next(iter(core.shell_routers.values())).cmd.proc
        for _ in range(500):               # the shell forks its subshell
            if len(group_alive(proc.pid)) >= 2:
                break
            await asyncio.sleep(0.01)
        alive_before = group_alive(proc.pid)
        await env.sup.terminate_agent("agent-root")
        env.close()
        return proc, alive_before
    proc, before = run(main())
    assert proc.pid in before and len(before) >= 2   # shell + subshell
    assert proc.returncode is not None
    for _ in range(500):
        if not group_alive(proc.pid):
            break
        time.sleep(0.01)
    assert group_alive(proc.pid) == []
