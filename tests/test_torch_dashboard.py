"""The port's dashboard server (``quoracle_tpu_torch/web/``) against the
JAX package's, each over a real socket on port 0, on the CPU.

tests/test_dashboard.py's eleven cases and tests/test_dashboard_dom.py's
three run through both packages over each one's ``Runtime`` and
``MockBackend`` and must agree, ids and times dropped: the JSON payloads
of the API, the SSE events, the bearer-token gating, the settings,
credential and profile surfaces, the trace and Prometheus endpoints, and
the DOM trees of the server-rendered /logs, /mailbox and /telemetry
views. The routes whose planes the port has not got (/api/sim,
/api/train) answer 501 with a body naming their ROADMAP item; the SPA's
script fetches none of them. /api/chaos, /api/cluster and /api/fleet are
served from real planes (a disaggregated cluster of each package over
the same tiny weights, its fleet controller, a chaos scenario's report)
and agree with the JAX payloads.

No test waits on a clock: agents are awaited through
tests/_agent_parity.py's ``Watch`` (every handled mailbox message and
every broadcast of the runtime's bus wakes it), and the SSE reader
starts once the server's subscription is on the bus. Every server is
stopped and every runtime shut down in a ``finally``, and the process-
wide hooks a runtime installs are restored after each test."""

import asyncio
import contextlib
import inspect
import json
import re
import threading
import urllib.error
import urllib.request

import pytest

from _agent_parity import (
    BOTH, JAX, PORT, first_difference, idle, install_watch, j, new_watch,
    process_hooks_restored, run, scrub, view,
)
from test_dashboard_dom import dom
from test_torch_grove import write_grove

POOL = ["mock:consensus-model-1", "mock:consensus-model-2",
        "mock:consensus-model-3"]
# per-process and per-run numbers the comparison drops beside ids/times
VOLATILE = {"updated_at", "completed_at", "uptime_s", "rss_mb",
            "peak_rss_mb", "user_cpu_s", "system_cpu_s", "threads",
            "last_used_at", "secret_id", "telemetry"}


@pytest.fixture(autouse=True)
def watched(monkeypatch):
    install_watch(monkeypatch)
    monkeypatch.delenv("QUORACLE_DASHBOARD_TOKEN", raising=False)
    for pkg in BOTH:
        pkg.treeobs.reset()
    with process_hooks_restored():
        yield


def pv(x):
    """``view`` with the volatile keys dropped too."""
    if isinstance(x, dict):
        return view({k: pv(v) for k, v in x.items() if k not in VOLATILE})
    if isinstance(x, (list, tuple)):
        return [pv(v) for v in x]
    return view(x)


def both(case):
    """``case(pkg)`` (a coroutine) on each package's loop; the two
    observations must agree. Returns the port's."""
    got = [run(case(pkg), timeout=180) for pkg in BOTH]
    a, b = pv(got[0]), pv(got[1])
    assert b == a, first_difference(a, b)
    return got[1]


async def http(url, method="GET", body=None, token=None):
    """(status, JSON body or text) of one request."""
    def call():
        headers = {"content-type": "application/json"}
        if token is not None:
            headers["authorization"] = f"Bearer {token}"
        req = urllib.request.Request(
            url, method=method, headers=headers,
            data=json.dumps(body).encode() if body is not None else None)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                status, ctype, raw = (r.status, r.headers["content-type"],
                                      r.read().decode())
        except urllib.error.HTTPError as e:
            status, ctype, raw = (e.code, e.headers["content-type"],
                                  e.read().decode())
        if ctype.startswith("application/json"):
            return status, json.loads(raw)
        return status, raw
    return await asyncio.get_running_loop().run_in_executor(None, call)


@contextlib.asynccontextmanager
async def served(pkg, config=None, respond=None, token=None):
    """A runtime of ``pkg`` over its mock and a dashboard on port 0;
    both are stopped in a ``finally``."""
    rt = pkg.rt.Runtime(config or pkg.rt.RuntimeConfig(),
                        backend=pkg.runtime.MockBackend(respond=respond))
    server = None
    try:
        server = await pkg.web.DashboardServer(rt, port=0,
                                               auth_token=token).start()
        yield rt, server, new_watch(rt.deps)
    finally:
        if server is not None:
            await server.stop()
        await rt.shutdown()


def wait_only(r):
    return j("wait", {})


def without_catalog(got):
    """A settings payload with its model catalog checked and taken out:
    the catalog is process-wide, and tests register models in one
    package only."""
    status, body = got
    assert {"tiny", "llama-3-8b"} <= set(body.pop("models"))
    return status, body


def roots_idle(rt):
    regs = rt.registry.all()
    return bool(regs) and all(idle(r.core) for r in regs)


# ---------------------------------------------------------------------------
# tests/test_dashboard.py
# ---------------------------------------------------------------------------

def test_dashboard_full_api_flow():
    def respond(r):
        joined = "\n".join(str(m.get("content", "")) for m in r.messages)
        if "poke-from-ui" in joined and "ui-poked" not in joined:
            return j("todo", {"items": [{"task": "ui-poked"}]})
        return j("wait", {})

    async def case(pkg):
        async with served(pkg, respond=respond) as (rt, server, w):
            base, out = server.url, {}
            out["health"] = await http(base + "/healthz")
            status, page = await http(base + "/")
            out["page"] = (status, "quoracle-tpu" in page,
                           "EventSource" in page)
            status, made = await http(base + "/api/tasks", "POST", {
                "description": "dashboard driven task",
                "model_pool": list(POOL)})
            out["created"] = status
            task_id, root_id = made["task_id"], made["root_agent"]
            root = rt.registry.lookup(root_id).core
            await w.until(lambda: roots_idle(rt))
            out["tasks"] = await http(base + "/api/tasks")
            out["agents"] = await http(base + f"/api/agents?task_id="
                                       f"{task_id}")
            out["sent"] = await http(base + "/api/messages", "POST", {
                "agent_id": root_id, "content": "poke-from-ui"})
            await w.until(lambda: root.ctx.todos == [{"task": "ui-poked"}]
                          and idle(root))
            status, logs = await http(base + f"/api/logs?agent_id={root_id}")
            out["logs"] = (status, [(r["level"], r["message"])
                                    for r in logs])
            out["paused"] = await http(base + f"/api/tasks/{task_id}/pause",
                                       "POST")
            out["tasks_paused"] = await http(base + "/api/tasks")
            out["resumed"] = await http(
                base + f"/api/tasks/{task_id}/resume", "POST")
            out["agents_resumed"] = await http(
                base + f"/api/agents?task_id={task_id}")
            await rt.tasks.pause_task(task_id)
            return out
    port = both(case)
    assert port["health"] == (200, {"status": "ok"})
    assert port["page"] == (200, True, True) and port["created"] == 201
    assert port["tasks"][1][0]["status"] == "running"
    assert port["sent"] == (200, {"delivered": True})
    assert port["logs"][1] and port["paused"][1]["stopped"] >= 1
    assert port["tasks_paused"][1][0]["status"] == "paused"
    assert port["tasks_paused"][1][0]["live_agents"] == 0
    assert port["resumed"][1]["restored"] == 1


def test_dashboard_create_task_without_pool_uses_backend_default():
    async def case(pkg):
        async with served(pkg, respond=wait_only) as (rt, server, w):
            status, made = await http(server.url + "/api/tasks", "POST",
                                      {"description": "ui minimal task"})
            root = rt.registry.lookup(made["root_agent"]).core
            await w.until(lambda: idle(root))
            await rt.tasks.pause_task(made["task_id"])
            return status, root.config.model_pool
    assert both(case) == (201, POOL)


def test_dashboard_sse_stream_delivers_events():
    async def case(pkg):
        async with served(pkg, respond=wait_only) as (rt, server, w):
            attached = threading.Event()
            subscribe = rt.bus.subscribe

            def spy(topic, fn):
                sub = subscribe(topic, fn)
                attached.set()
                return sub
            rt.bus.subscribe = spy
            lines: list = []

            def read_sse():
                with urllib.request.urlopen(server.url + "/events",
                                            timeout=30) as resp:
                    while True:
                        line = resp.readline()
                        if line.startswith(b"data: "):
                            lines.append(json.loads(line[6:]))
                            if lines[-1].get("event") == "agent_spawned":
                                return
            loop = asyncio.get_running_loop()
            reader = loop.run_in_executor(None, read_sse)
            assert await loop.run_in_executor(None, attached.wait, 30)
            task_id, root = await rt.tasks.create_task(
                "sse probe", model_pool=list(POOL))
            await asyncio.wait_for(reader, 30)
            await w.until(lambda: idle(root))
            await rt.tasks.pause_task(task_id)
            return [(scrub(e["topic"]), e["event"]) for e in lines]
    port = both(case)
    assert port[-1][1] == "agent_spawned"


def test_dashboard_auth_token_gates_mutations():
    async def case(pkg):
        async with served(pkg, token="s3cret") as (rt, server, w):
            base, out = server.url, {}
            out["health"] = (await http(base + "/healthz"))[0]
            out["gated"] = [(path, (await http(base + path))[0]) for path in (
                "/api/status", "/logs", "/mailbox", "/telemetry",
                "/settings", "/metrics", "/api/trace", "/api/metrics",
                "/events", "/api/chaos")]
            out["post_no_token"] = (await http(
                base + "/api/messages", "POST",
                {"agent_id": "x", "content": "hi"}))[0]
            out["post_token"] = await http(
                base + "/api/messages", "POST",
                {"agent_id": "x", "content": "hi"}, token="s3cret")
            out["query_token"] = (await http(
                base + "/api/status?token=s3cret"))[0]
        for host in ("0.0.0.0", ""):
            with pytest.raises(ValueError):
                pkg.web.DashboardServer(object(), host=host, port=0)
        return out
    port = both(case)
    assert port["health"] == 200 and port["post_no_token"] == 401
    assert all(code == 401 for _, code in port["gated"])
    assert port["post_token"] == (404, {"delivered": False})
    assert port["query_token"] == 200


def test_settings_surface_round_trips():
    async def case(pkg):
        config = pkg.rt.RuntimeConfig(encryption_key="k" * 16)
        async with served(pkg, config=config) as (rt, server, w):
            base, out = server.url, {}
            out["empty"] = without_catalog(
                await http(base + "/api/settings"))
            out["merged"] = await http(base + "/api/settings", "POST", {
                "embedding_model": "xla:tiny", "ssrf_check": False})
            out["bad_keys"] = await http(base + "/api/settings", "POST",
                                         {"": 1})
            out["profile"] = await http(base + "/api/profiles", "POST", {
                "name": "researcher", "model_pool": list(POOL),
                "capability_groups": ["file_read"]})
            out["profile_merge"] = await http(
                base + "/api/profiles", "POST",
                {"name": "researcher", "max_depth": 3})
            status, made = await http(base + "/api/tasks", "POST", {
                "description": "profile task", "profile": "researcher"})
            out["profile_task"] = status
            root = rt.registry.lookup(made["root_agent"]).core
            await w.until(lambda: idle(root))
            await http(base + f"/api/tasks/{made['task_id']}/pause", "POST")
            out["secret"] = await http(base + "/api/secrets", "POST", {
                "name": "api-key", "value": "hunter2-hunter2",
                "description": "service key"})
            out["generated"] = await http(base + "/api/secrets", "POST",
                                          {"name": "generated-one"})
            out["full"] = without_catalog(
                await http(base + "/api/settings"))
            out["leaks"] = "hunter2" in json.dumps(out["full"])
            out["lookup"] = rt.secrets.lookup("api-key")
            row = rt.db.query_one("SELECT * FROM secrets WHERE name=?",
                                  ("api-key",))
            out["at_rest"] = b"hunter2" in bytes(row["value"])
            out["deletes"] = [await http(base + path, "DELETE") for path in (
                "/api/secrets/api-key", "/api/profiles/researcher",
                "/api/profiles/ghost", "/api/nothing/x")]
            out["after"] = (rt.secrets.lookup("api-key"),
                            rt.store.get_profile("researcher"))
            return out
    port = both(case)
    assert port["empty"][1]["profiles"] == {}
    assert port["merged"][1]["embedding_model"] == "xla:tiny"
    assert port["bad_keys"][0] == 400 and port["profile_task"] == 201
    assert port["profile_merge"][1]["model_pool"] == POOL
    assert "value" not in port["secret"][1] and not port["leaks"]
    assert port["lookup"] == "hunter2-hunter2" and not port["at_rest"]
    assert [d[0] for d in port["deletes"]] == [200, 200, 404, 404]
    assert port["after"] == (None, None)


def test_settings_mutations_require_token_when_configured():
    async def case(pkg):
        async with served(pkg, token="sesame") as (rt, server, w):
            return [(method, path, (await http(server.url + path, method,
                                               body))[0])
                    for method, path, body in (
                        ("GET", "/api/settings", None),
                        ("POST", "/api/settings", {"k": 1}),
                        ("POST", "/api/secrets", {"name": "x"}),
                        ("POST", "/api/profiles", {"name": "p"}),
                        ("POST", "/api/credentials", {"id": "c"}),
                        ("DELETE", "/api/secrets/x", None))]
    assert all(code == 401 for *_, code in both(case))


def test_dashboard_metrics_endpoint():
    async def case(pkg):
        async with served(pkg, respond=wait_only) as (rt, server, w):
            _, made = await http(server.url + "/api/tasks", "POST", {
                "description": "metrics probe", "model_pool": list(POOL)})
            await w.until(lambda: roots_idle(rt))
            status, m = await http(server.url + "/api/metrics")
            vm = m.pop("vm")
            assert vm["rss_mb"] > 0 and vm["threads"] >= 2
            assert vm["rss_mb"] <= vm["peak_rss_mb"] + 2.0
            assert m["telemetry"]["quoracle_decide_ms"]["count"] >= 1
            await rt.tasks.pause_task(made["task_id"])
            return status, m
    status, m = both(case)
    assert status == 200 and m["rows"]["tasks"] == 1
    assert m["agents"]["live"] >= 1
    assert m["backend"]["type"] == "MockBackend"


def test_dashboard_groves_endpoint_and_grove_task_create(tmp_path):
    grove_dir, _ = write_grove(tmp_path, confinement_mode="warn")

    async def case(pkg):
        config = pkg.rt.RuntimeConfig(groves_dir=str(tmp_path))
        async with served(pkg, config=config,
                          respond=wait_only) as (rt, server, w):
            base, out = server.url, {}
            out["groves"] = await http(base + "/api/groves")
            g = out["groves"][1][0]
            out["made"] = await http(base + "/api/tasks", "POST", {
                "description": "from the browser", "grove": g["dir"],
                "model_pool": list(POOL)})
            await w.until(lambda: roots_idle(rt))
            root = rt.registry.all()[0].core
            out["node"] = root.config.grove_node
            out["agents"] = await http(base + "/api/agents")
            out["bad_grove"] = (await http(base + "/api/tasks", "POST", {
                "description": "x", "grove": str(tmp_path / "none"),
                "model_pool": list(POOL)}))[0]
            await rt.tasks.pause_task(out["made"][1]["task_id"])
            return out
    port = both(case)
    g = port["groves"][1][0]
    assert g["dir"] == grove_dir and g["root_node"] == "coordinator"
    assert g["bootstrap"]["role"] == "Benchmark Coordinator"
    assert port["made"][0] == 201 and port["node"] == "coordinator"
    row = port["agents"][1][0]
    assert {"todos", "budget", "cost", "grove_node"} <= set(row)
    assert port["bad_grove"] == 500


def test_dashboard_credentials_api_metadata_only():
    async def case(pkg):
        async with served(pkg) as (rt, server, w):
            base, out = server.url, {}
            out["made"] = await http(base + "/api/credentials", "POST", {
                "id": "gh", "model_spec": "api:github",
                "data": {"type": "bearer", "token": "sekret-tok"}})
            out["bad"] = await http(base + "/api/credentials", "POST",
                                    {"id": "x"})
            out["listed"] = await http(base + "/api/credentials")
            out["leaks"] = "sekret-tok" in json.dumps(
                [out["made"], out["listed"]])
            out["resolved"] = rt.credentials.get("gh")["token"]
            out["deleted"] = await http(base + "/api/credentials/gh",
                                        "DELETE")
            out["gone"] = rt.credentials.get("gh")
            return out
    port = both(case)
    assert port["made"][0] == 201 and port["bad"][0] == 400
    assert port["listed"][1][0]["id"] == "gh" and not port["leaks"]
    assert port["resolved"] == "sekret-tok" and port["gone"] is None
    assert port["deleted"] == (200, {"deleted": True})


def test_history_endpoint_serves_ring_buffer_mount_replay():
    def respond(r):
        joined = "\n".join(str(m.get("content", "")) for m in r.messages)
        if "history-probe" in joined:
            return j("wait", {})
        return j("send_message", {"target": "announcement",
                                  "content": "history-probe"})

    async def case(pkg):
        async with served(pkg, respond=respond) as (rt, server, w):
            base = server.url
            _, made = await http(base + "/api/tasks", "POST", {
                "description": "history replay task",
                "model_pool": list(POOL)})
            root_id, task_id = made["root_agent"], made["task_id"]
            root = rt.registry.lookup(root_id).core
            await w.until(lambda: idle(root) and rt.history.replay_messages(
                root_id) and any(e.get("action") == "wait"
                                 for e in rt.history.replay_actions()))
            out = {"all": await http(base + "/api/history"),
                   "agent": await http(base + f"/api/history?agent_id="
                                       f"{root_id}"),
                   "task": await http(base + f"/api/history?task_id="
                                      f"{task_id}")}
            await rt.tasks.pause_task(task_id)
            return {k: (s, {ring: [(e.get("event"), e.get("action"),
                                    e.get("message", ""))
                                   for e in events]
                            for ring, events in h.items()})
                    for k, (s, h) in out.items()}
    port = both(case)
    assert ("agent_spawned", None, "") in port["all"][1]["lifecycle"]
    assert port["agent"][1]["actions"] and "logs" in port["agent"][1]
    assert any("history-probe" in str(m[2])
               for m in port["task"][1]["messages"])
    assert any("history-probe" in str(m[2])
               for m in port["agent"][1]["messages"])


def test_trace_and_prometheus_endpoints():
    async def case(pkg):
        async with served(pkg) as (rt, server, w):
            base = server.url
            eng = pkg.cengine.ConsensusEngine(rt.backend,
                                              pkg.cengine.ConsensusConfig(
                                                  model_pool=list(POOL),
                                                  session_key="agent-t"))

            def decide():
                with pkg.telemetry.TRACER.span(
                        "agent.decide_tick", trace_id="task-tr1",
                        parent=None, agent_id="agent-t"):
                    return eng.decide({m: [{"role": "user", "content": "go"}]
                                       for m in POOL})
            out = await asyncio.get_running_loop().run_in_executor(
                None, decide)
            status, tr = await http(base + "/api/trace?task_id=task-tr1")
            spans = tr["spans"]
            ids = {s["span_id"]: s["name"] for s in spans}
            decide_sp = next(s for s in spans
                             if s["name"] == "consensus.decide")
            assert decide_sp["duration_ms"] >= out.latency_ms - 1.0
            tree = sorted((s["name"], ids.get(s["parent_id"])) for s in spans)
            none = await http(base + "/api/trace?task_id=no-such-task")
            status_m, text = await http(base + "/metrics")
            types = {line.split()[2] for line in text.splitlines()
                     if line.startswith("# TYPE quoracle_")}
            counts = {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
                      for line in text.strip().splitlines()
                      if not line.startswith("#")}
            return {"status": (status, tr["task_id"], tr["n_spans"]),
                    "tree": tree, "none": none, "metrics": status_m,
                    "types": sorted(types & {
                        "quoracle_round_ms", "quoracle_decide_ms",
                        "quoracle_prefill_ms",
                        "quoracle_consensus_rounds_total"}),
                    "counted": [counts[k] >= 1 for k in (
                        "quoracle_decide_ms_count",
                        "quoracle_round_ms_count",
                        "quoracle_consensus_rounds_total")]}
    port = both(case)
    assert port["status"][:2] == (200, "task-tr1")
    assert port["status"][2] >= 2 + len(POOL)
    assert ("consensus.round", "consensus.decide") in port["tree"]
    assert port["none"] == (200, {"task_id": "no-such-task", "n_spans": 0,
                                  "spans": []})
    assert port["metrics"] == 200 and len(port["types"]) == 4
    assert all(port["counted"])


# ---------------------------------------------------------------------------
# tests/test_dashboard_dom.py
# ---------------------------------------------------------------------------

_CLOCK = re.compile(r"\b\d\d:\d\d:\d\d\b")
_NUMBER = re.compile(r"\d+\.\d+")


def dom_view(node):
    """A parsed page as nested (tag, attributes, text, children), ids
    scrubbed; clock times and decimals (latencies) masked."""
    def clean(s):
        return _NUMBER.sub("#", _CLOCK.sub("hh:mm:ss", scrub(s)))
    return (node.tag,
            sorted((k, clean(v or "")) for k, v in node.attrs.items()),
            clean(node.text.strip()), [dom_view(c) for c in node.children])


def test_grove_task_shows_todos_and_costs_in_dom(tmp_path):
    grove_dir, _ = write_grove(tmp_path, confinement_mode="warn")

    def respond(r):
        joined = "\n".join(str(m.get("content", "")) for m in r.messages)
        if "ui-grove-run" in joined and "dom-todo-alpha" not in joined:
            return j("todo", {"items": [
                {"task": "dom-todo-alpha", "done": False},
                {"task": "dom-todo-beta", "done": True}]})
        if "dom-todo-alpha" in joined and "ui-manual-cost" not in joined:
            return j("record_cost", {"amount": 0.25,
                                     "description": "ui-manual-cost"})
        return j("wait", {})

    async def case(pkg):
        config = pkg.rt.RuntimeConfig(groves_dir=str(tmp_path))
        async with served(pkg, config=config,
                          respond=respond) as (rt, server, w):
            base = server.url
            _, made = await http(base + "/api/tasks", "POST", {
                "description": "ui-grove-run", "grove": grove_dir,
                "model_pool": list(POOL)})
            task_id = made["task_id"]
            await w.until(lambda: roots_idle(rt) and any(
                e.action_type == "record_cost"
                for a in rt.registry.all()
                for e in a.core.ctx.history(POOL[0])
                if e.kind == "result"))
            rt.secrets.put("dom-secret", "never-shown-value")
            pages = {}
            for path in (f"/mailbox?task_id={task_id}",
                         f"/logs?task_id={task_id}",
                         f"/logs?task_id={task_id}&level=decision",
                         "/settings", "/telemetry"):
                status, html = await http(base + path)
                pages[scrub(path)] = (status, dom(html))
            await rt.tasks.pause_task(task_id)
            return pages
    got = [run(case(pkg), timeout=180) for pkg in BOTH]
    for path in got[0]:
        jax_page, port_page = got[0][path][1], got[1][path][1]
        assert got[1][path][0] == got[0][path][0] == 200
        for page in (jax_page, port_page):      # the catalog: see above
            models = page.find("ul", id="models")
            if models is not None:
                assert models.find_all("li")
                models.children = []
        if path == "/telemetry":
            # the port lists its unported planes; the numbers and the
            # latency panel are process-wide: the skeletons of the
            # metric tables are compared
            ported = port_page.find("ul", id="not-ported")
            assert ported is not None and {
                li.attrs["data-plane"] for li in ported.find_all("li")} == {
                "sim", "train"}
            jt, pt = ([t.attrs for t in p.find_all("table", cls="metrics")]
                      for p in (jax_page, port_page))
            assert pt == jt
            continue
        a, b = dom_view(jax_page), dom_view(port_page)
        assert b == a, (path, first_difference(a, b))
    port = got[1]
    mailbox = port["/mailbox?task_id=task-*"][1]
    card = mailbox.find_all(cls="agent-card")[0]
    texts = [t.all_text().strip() for t in card.find_all("li", cls="todo")]
    assert {"dom-todo-alpha", "dom-todo-beta"} <= set(texts)
    assert float(card.find(cls="agent-cost").all_text().split("=")[1]) > 0
    rows = port["/logs?task_id=task-*&level=decision"][1].find_all(
        cls="log-row")
    assert rows and all("lvl-decision" in r.classes for r in rows)
    settings = port["/settings"][1]
    assert any("dom-secret" in s.all_text()
               for s in settings.find_all(cls="secret"))
    assert "never-shown-value" not in settings.all_text()


def test_mailbox_dom_shows_task_messages():
    def respond(r):
        joined = "\n".join(str(m.get("content", "")) for m in r.messages)
        if ("hello-from-the-mailbox" in joined
                and "mailbox-reply-mark" not in joined):
            return j("send_message", {"target": "announcement",
                                      "content": "mailbox-reply-mark"})
        return j("wait", {})

    async def case(pkg):
        async with served(pkg, respond=respond) as (rt, server, w):
            base = server.url
            _, made = await http(base + "/api/tasks", "POST", {
                "description": "mailbox dom", "model_pool": list(POOL)})
            root = rt.registry.lookup(made["root_agent"]).core
            await w.until(lambda: idle(root))
            await http(base + "/api/messages", "POST", {
                "agent_id": made["root_agent"],
                "content": "hello-from-the-mailbox"})
            await w.until(lambda: idle(root) and rt.db.query(
                "SELECT 1 FROM messages WHERE content LIKE "
                "'%mailbox-reply-mark%'"))
            status, html = await http(base + "/mailbox")
            await rt.tasks.pause_task(made["task_id"])
            return status, dom_view(dom(html)), made["root_agent"]
    port = both(case)
    assert port[0] == 200
    text = json.dumps(port[1])
    assert "mailbox-reply-mark" in text


def test_spa_js_dom_and_api_contract():
    """The page's ids and API paths (tests/test_dashboard_dom.py's
    contract) hold for the port's page and server, which serve the
    same page; the routes the port leaves out are not among the SPA's
    fetches."""
    assert PORT.page.DASHBOARD_HTML == JAX.page.DASHBOARD_HTML
    markup, _, script = PORT.page.DASHBOARD_HTML.partition("<script>")
    looked_up = set(re.findall(r'\$\("([a-zA-Z0-9_-]+)"\)', script))
    declared = set(re.findall(r'id="([a-zA-Z0-9_-]+)"', markup))
    dynamic = set(re.findall(r'id="([a-zA-Z0-9_-]+)"', script)) | \
        set(re.findall(r"\.id\s*=\s*\"([a-zA-Z0-9_-]+)\"", script))
    assert looked_up and not looked_up - declared - dynamic
    handler_src = inspect.getsource(PORT.web)
    fetched = set(re.findall(r'api\("(/[a-z/]+)"', script)) | set(
        re.findall(r'"(/api/[a-z]+)', script))
    assert fetched
    for path in fetched:
        assert path in handler_src, path
    assert not fetched & set(PORT.web.NOT_PORTED)


# ---------------------------------------------------------------------------
# What the port leaves out
# ---------------------------------------------------------------------------

# The routes the port answered 501 for before their planes were ported,
# with the ROADMAP item that ports each; None: ported since (the chaos
# plane), the route answers 200 with its payload.
UNPORTED_ROUTES = [("/api/chaos", None), ("/api/sim", "item 14 (sim/)"),
                   ("/api/train", "item 11 (training capture)")]


@pytest.mark.parametrize("route,item", UNPORTED_ROUTES, ids=[
    "/api/chaos-item 9, third bullet (chaos/)",
    "/api/sim-item 9, third bullet (sim/)",
    "/api/train-item 11 (training capture)"])
def test_unported_routes_answer_501_with_their_item(route, item):
    async def main():
        async with served(PORT) as (rt, server, w):
            got = await http(server.url + route)
            rest = await http(server.url + "/api/status")
            return got, rest
    (status, body), rest = run(main())
    if item is None:
        from quoracle_tpu_torch.chaos.faults import INJECTION_POINTS
        assert status == 200 and body["armed"] is False
        assert set(body["points"]) == set(INJECTION_POINTS)
    else:
        assert status == 501
        assert body == {"error": "not ported", "route": route,
                        "roadmap": f"ROADMAP Queue 1 {item}"}
    assert rest[0] == 200 and rest[1]["backend"] == "MockBackend"


# ---------------------------------------------------------------------------
# The multi-replica and chaos planes' routes
# ---------------------------------------------------------------------------

def _plane_view(route: str, body: dict) -> dict:
    """A payload without what differs by process or clock: the counter
    series (keys only), signal timestamps, drain walls, the injection
    catalog's texts (keys only) and a scenario's wall time."""
    body = json.loads(json.dumps(body))
    counters = sorted(body.pop("counters", {}))
    if route in ("/api/cluster", "/api/fleet"):
        for rep in body["router"]["replicas"].values():
            for k in ("ts", "refreshed_ts", "hbm_headroom"):
                (rep.get("signals") or {}).pop(k, None)
    if route == "/api/chaos":
        body["points"] = sorted(body["points"])
        if body.get("last_scenario"):
            body["last_scenario"].pop("wall_s", None)
    return {"counters": counters, **body}


def test_cluster_fleet_and_chaos_routes_serve_the_jax_payloads():
    """A runtime over a 1 prefill + 2 decode cluster with a fleet
    controller, after a drain and a chaos scenario: /api/cluster,
    /api/fleet and /api/chaos over HTTP equal the JAX server's, and
    /telemetry renders the chaos and fleet panels."""
    import _cluster_parity as cp

    async def case(side):
        cl = cp.build_cluster(side, replicas=3, disaggregate=True,
                              continuous=True, continuous_chunk=8)
        rt = side_pkg(side).rt.Runtime(side_pkg(side).rt.RuntimeConfig(),
                                       backend=cl)
        rt._fleet = side.fl.FleetController(cl)
        server = None
        try:
            msgs = [{"role": "user", "content": "dashboard cluster row"}]
            out = cl.query([cp.req(side, msgs, sid="dash", max_tokens=8)])
            assert out[0].ok, out[0].error
            src = cl.router.affinity_of("dash")
            rt._fleet.drain(src.replica_id, reason="dashboard")
            if side is cp.JAX:
                with cp.jax_shared_backends():
                    side.scen.run_scenario("kill_mid_handoff", seed=5)
            else:
                with cp.port_lockdep():
                    side.scen.run_scenario(
                        "kill_mid_handoff", seed=5, device="cpu",
                        engine_factory=cp.port_engine)
            server = await side_pkg(side).web.DashboardServer(
                rt, port=0).start()
            got = {}
            for route in ("/api/cluster", "/api/fleet", "/api/chaos"):
                status, body = await http(server.url + route)
                assert status == 200, (route, body)
                got[route] = _plane_view(route, body)
            status, page = await http(server.url + "/telemetry")
            assert status == 200
            got["panels"] = [mark in page for mark in (
                "chaos-invariants", "fleet-state")]
            return got
        finally:
            if server is not None:
                await server.stop()
            await rt.shutdown()
            cl.close()

    def side_pkg(side):
        return JAX if side is cp.JAX else PORT

    got = [run(case(side), timeout=600) for side in cp.SIDES]
    assert got[1] == got[0]
    assert got[1]["panels"] == [True, True]
    assert got[1]["/api/cluster"]["enabled"] is True
    assert got[1]["/api/fleet"]["drains"] == 1

