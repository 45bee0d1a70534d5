"""Shared helpers of the agent-layer parity tests (tests/test_torch_bus.py,
test_torch_context.py, test_torch_actions_exec.py, test_torch_agent.py,
test_torch_agent_e2e.py, test_torch_world_actions.py,
test_torch_persistence.py, test_torch_runtime.py, test_torch_grove.py,
test_torch_dashboard.py, test_torch_cli.py): each package's
agent-layer modules and the layers above them (world actions,
persistence, the runtime) under one namespace, an event-driven wait, and
a view that drops ids and times.

Waiting never polls a clock: ``Watch`` wakes whenever an agent of either
package finishes handling a mailbox message (every state change of an
agent goes through ``AgentCore._dispatch``) or the bus broadcasts, and
the timeout only bounds a hung run; it never decides a result.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import importlib
import json
import re
import types
from decimal import Decimal

MODULES = {
    "core": "agent.core", "state": "agent.state",
    "registry": "agent.registry", "supervisor": "agent.supervisor",
    "executors": "actions.executors",
    "schema": "actions.schema", "bus": "infra.bus", "budget": "infra.budget",
    "costs": "infra.costs", "security": "infra.security",
    "telemetry": "infra.telemetry", "treeobs": "infra.treeobs",
    "history": "context.history", "tm": "context.token_manager",
    "lessons": "context.lessons", "reflector": "context.reflector",
    "condensation": "context.condensation",
    "context_manager": "context.context_manager",
    "message_builder": "context.message_builder",
    "history_transfer": "context.history_transfer",
    "skills": "governance.skills", "grove": "governance.grove",
    "fields": "governance.fields",
    "capabilities": "governance.capabilities", "runtime": "models.runtime",
    "normalize": "utils.normalize", "cengine": "consensus.engine",
    "world": "actions.world", "http": "infra.http", "mcp": "infra.mcp",
    "html_md": "utils.html_md", "images": "models.images",
    "db": "persistence.db", "store": "persistence.store",
    "tasks": "persistence.tasks", "event_history": "infra.event_history",
    "rt": "runtime", "web": "web.server", "page": "web.page",
    "cli": "cli",
}


def package(root: str) -> types.SimpleNamespace:
    """``root`` ("quoracle_tpu" or "quoracle_tpu_torch")'s agent-layer
    modules by short name."""
    ns = types.SimpleNamespace(name=root)
    for short, path in MODULES.items():
        setattr(ns, short, importlib.import_module(f"{root}.{path}"))
    return ns


JAX = package("quoracle_tpu")
PORT = package("quoracle_tpu_torch")
BOTH = (JAX, PORT)
WAIT = 120.0          # bounds a hung run only


def j(action, params=None, wait=False, reasoning="test") -> str:
    return json.dumps({"action": action, "params": params or {},
                       "reasoning": reasoning, "wait": wait})


WAIT_FOREVER = j("wait", {}, wait=False)

# ids and times: random per run, so the comparison drops them
_ID_RES = [(re.compile(r"agent-[0-9a-f]{12}"), "agent-*"),
           (re.compile(r"task-[0-9a-f]{12}"), "task-*"),
           (re.compile(r"action-[0-9a-f]{12}"), "action-*"),
           (re.compile(r"cmd-[0-9a-f]{10}"), "cmd-*"),
           (re.compile(r'(NO_EXECUTE id=\\*")[0-9a-f]{8}'), r"\1*"),
           (re.compile(r"SECRET_VALUE_[A-Za-z0-9]+"), "SECRET_VALUE_*")]
TIME_KEYS = {"ts", "spawned_at", "registered_at", "created_at",
             "started_at", "latency_ms", "duration_ms", "id"}
# process-wide sequence ids: each package numbers its own from 1 in the
# process, so they match only when both have counted the same number
# before. ``view`` puts a placeholder for a value of the id's format and
# keeps any other (None, a malformed id), which still has to agree
SEQUENCE_ID = re.compile(r"c[0-9a-f]+")         # consensus/quality.py
REGISTRY_ID = re.compile(r"[0-9a-f]+\.[0-9a-f]+")  # infra/treeobs.py
SEQUENCE_KEYS = {"decide_id": (SEQUENCE_ID, "c*"),
                 "registry_id": (REGISTRY_ID, "<pid>.*")}


def scrub(text: str) -> str:
    for rx, rep in _ID_RES:
        text = rx.sub(rep, text)
    return text


def view(x):
    """``x`` with ids replaced by placeholders and time keys dropped;
    dataclasses become dicts, Decimals strings, tuples lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {scrub(str(k)): sequence_view(k, v) for k, v in sorted(
            x.items(), key=lambda kv: str(kv[0])) if k not in TIME_KEYS}
    if isinstance(x, (list, tuple)):
        return [view(v) for v in x]
    if isinstance(x, str):
        return scrub(x)
    if isinstance(x, Decimal):
        return str(x)
    if isinstance(x, float):
        return round(x, 9)
    return x


def sequence_view(key, value):
    """``view(value)``, but a sequence id of its key's format becomes
    that key's placeholder."""
    rx, placeholder = SEQUENCE_KEYS.get(key, (None, None))
    if rx is not None and isinstance(value, str) and rx.fullmatch(value):
        return placeholder
    return view(value)


def history_view(core, model) -> list:
    return [(e.kind, e.action_type, view(e.content))
            for e in core.ctx.history(model)]


class Watch:
    """Wakes on every handled mailbox message of any agent of either
    package, and on every bus broadcast the test routes to ``poke``.
    Install with :func:`watch` (a fixture in each test module)."""

    current: "Watch | None" = None

    def __init__(self):
        self.event = asyncio.Event()

    def poke(self, *_a) -> None:
        self.event.set()

    async def until(self, cond, timeout: float = WAIT) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while not cond():
            self.event.clear()
            if cond():
                return
            left = deadline - loop.time()
            if left <= 0:
                raise AssertionError("condition not met before the run "
                                     "was declared hung")
            try:
                await asyncio.wait_for(self.event.wait(), left)
            except asyncio.TimeoutError:
                pass


def install_watch(monkeypatch) -> None:
    """Wrap both packages' ``AgentCore._dispatch`` so each handled
    message pokes the running test's ``Watch`` (created per event loop by
    :func:`new_watch`)."""
    for pkg in BOTH:
        orig = pkg.core.AgentCore._dispatch

        async def dispatch(self, msg, _orig=orig):
            # a consensus cycle runs inside the dispatch of its trigger:
            # the count says a handler (and its executor call) is open
            self.watch_busy = getattr(self, "watch_busy", 0) + 1
            try:
                await _orig(self, msg)
            finally:
                self.watch_busy -= 1
                if Watch.current is not None:
                    Watch.current.poke()
        monkeypatch.setattr(pkg.core.AgentCore, "_dispatch", dispatch)


def new_watch(deps=None) -> Watch:
    """A Watch for the running loop; with ``deps`` it also wakes on
    every broadcast of that tree's bus (marshalled onto the loop)."""
    w = Watch()
    Watch.current = w
    if deps is not None:
        loop = asyncio.get_running_loop()
        deps.events.bus.subscribe(
            "*", lambda t, e: loop.call_soon_threadsafe(w.poke))
    return w


def run(coro, timeout: float = 300):
    try:
        return asyncio.run(asyncio.wait_for(coro, timeout))
    finally:
        Watch.current = None


def both(case):
    """``case(pkg)`` on each package (a coroutine it returns runs on a
    fresh event loop); the two observations must agree, ids and times
    dropped. Returns the port's."""
    got = []
    for pkg in BOTH:
        out = case(pkg)
        got.append(run(out) if asyncio.iscoroutine(out) else out)
    jax_view, port_view = view(got[0]), view(got[1])
    assert port_view == jax_view, first_difference(jax_view, port_view)
    return got[1]


def first_difference(a, b, path="") -> str:
    """Where two views first differ, for the assertion's message."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            if a.get(k) != b.get(k):
                return first_difference(a.get(k), b.get(k), f"{path}/{k}")
    elif isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_difference(x, y, f"{path}[{i}]")
    if isinstance(a, str) and isinstance(b, str):
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        a, b = a[max(0, i - 150):i + 150], b[max(0, i - 150):i + 150]
    return f"{path}: JAX {str(a)[:300]!r} != port {str(b)[:300]!r}"


class Recorder:
    """Every broadcast of a bus, in order, as (topic, event)."""

    def __init__(self, bus):
        self.events: list = []
        bus.subscribe("*", lambda t, e: self.events.append((t, e)))

    def names(self, topic_prefix: str = "") -> list:
        return [(scrub(t), e["event"]) for t, e in self.events
                if t.startswith(topic_prefix)]

    def by_agent(self) -> dict:
        """Each agent's own event names in order (agents interleave on
        the loop, so only each one's sequence is fixed)."""
        out: dict = {}
        for t, e in self.events:
            aid = e.get("agent_id") or e.get("task_id") or "-"
            out.setdefault(aid, []).append(e["event"])
        return out


def root_config(pkg, **over):
    defaults = dict(agent_id="agent-root", task_id="task-1",
                    model_pool=list(pkg.runtime.MockBackend.DEFAULT_POOL))
    defaults.update(over)
    return pkg.state.AgentConfig(**defaults)


def decisions(core, model=None):
    model = model or core.config.model_pool[0]
    return [e.content for e in core.ctx.history(model)
            if e.kind == "decision"]


def results(core, model=None):
    model = model or core.config.model_pool[0]
    return [e for e in core.ctx.history(model) if e.kind == "result"]


def idle(core) -> bool:
    """No message queued or being handled (a consensus cycle runs inside
    its trigger's handler), no action in flight, no cycle scheduled and
    no spawn running in the background."""
    return (not core.pending_actions and not core.consensus_scheduled
            and not getattr(core, "watch_busy", 0)
            and core.mailbox.empty() and not core._background)


class Env:
    """One agent tree of ``pkg`` over ``backend``, built inside the
    running loop: deps (``deps_over`` replaces fields), supervisor, a
    recorder of every broadcast, a tracer sink and a Watch."""

    def __init__(self, pkg, backend, supervisor_cls=None, **deps_over):
        self.pkg = pkg
        self.backend = backend
        self.deps = pkg.state.AgentDeps.for_tests(backend, **deps_over)
        self.sup = (supervisor_cls or pkg.supervisor.AgentSupervisor)(
            self.deps)
        self.rec = Recorder(self.deps.events.bus)
        self.spans: list = []
        pkg.telemetry.TRACER.add_sink(self.spans.append)
        self.w = new_watch(self.deps)

    async def start(self, **over):
        return await self.sup.start_agent(root_config(self.pkg, **over))

    def close(self) -> None:
        self.pkg.telemetry.TRACER.remove_sink(self.spans.append)

    def span_names(self) -> dict:
        out: dict = {}
        for s in self.spans:
            out[s["name"]] = out.get(s["name"], 0) + 1
        return dict(sorted(out.items()))

    def tree(self, task_id: str = "task-1") -> list:
        state = self.pkg.treeobs.tree_payload(task_id)
        return sorted((scrub(n["node_id"]), scrub(str(n["parent_id"])),
                       n["depth"], n["completed"])
                      for n in state.get("nodes", []))

    def summary(self, *cores, concurrent: bool = False) -> dict:
        """What the parity tests compare: each core's histories, the
        registry, escrow snapshots, every agent's bus events, span names
        and the tree registry (ids and times dropped by ``view``).

        ``concurrent``: agents of the tree decided at the same time, so
        how their messages batch into cycles (and with it the number of
        ticks) depends on the threads' timing; the comparison then keeps
        what does not: each agent's set of event kinds and of executed
        actions, the span names, the final registry, escrow and tree."""
        events = self.rec.by_agent()
        out = {"registry": sorted((scrub(r.agent_id),
                                   scrub(str(r.parent_id)), r.task_id,
                                   r.dismissing)
                                  for r in self.deps.registry.all()),
               "events": ({a: sorted(set(v)) for a, v in events.items()}
                          if concurrent else events),
               "spans": (sorted(self.span_names()) if concurrent
                         else self.span_names()),
               "tree": self.tree()}
        for core in cores:
            out[scrub(core.agent_id)] = {
                "histories": {m: (sorted({str(e.content.get("action"))
                                          for e in core.ctx.history(m)
                                          if e.kind == "decision"})
                                  if concurrent else history_view(core, m))
                              for m in core.config.model_pool},
                "todos": core.ctx.todos,
                "children": [scrub(c["agent_id"]) for c in core.children],
            }
            try:
                out[scrub(core.agent_id)]["escrow"] = \
                    self.deps.escrow.get(core.agent_id).snapshot()
            except KeyError:
                pass
        return view(out)


# The persistence layer's tables (persistence/db.py), for comparing two
# packages' databases row by row.
TABLES = ("tasks", "agents", "logs", "messages", "actions", "agent_costs",
          "secrets", "secret_usage", "credentials", "profiles",
          "model_settings", "consensus_audit")
JSON_COLUMNS = {"task_fields", "agent_fields", "config", "ace_state",
                "data", "params", "content", "targets", "record"}
ROW_TIMES = TIME_KEYS | {"updated_at", "completed_at"}


def row_view(row) -> dict:
    out = {}
    for k in row.keys():
        if k in ROW_TIMES:
            continue
        v = row[k]
        if isinstance(v, (bytes, memoryview)):
            v = "<blob>"
        elif k in JSON_COLUMNS or (k == "value" and isinstance(v, str)):
            v = json.loads(v)
        out[k] = v
    return view(out)


def db_view(db) -> dict:
    """Every table's rows, ids and times dropped, as a sorted multiset
    (agents' broadcasts reach the durable writer from several threads)."""
    return {t: sorted((row_view(r) for r in db.query(f"SELECT * FROM {t}")),
                      key=lambda d: json.dumps(d, sort_keys=True))
            for t in TABLES}


@contextlib.contextmanager
def process_hooks_restored():
    """Both packages' process-wide hooks as they were before the block.
    A ``Runtime`` installs them, as a node's composition root should:
    ``FLIGHT.install()`` (a tracer sink, the excepthook and the
    SIGTERM/SIGQUIT chains), ``fleetobs.ensure_ring()`` (the span ring's
    sink) and ``introspect.start`` (stall-detector watches). Tests that
    build runtimes restore them, so that a later test in the same worker
    finds the tracer with no sink."""
    import signal
    import sys
    saved = []
    for pkg in BOTH:
        flight = importlib.import_module(f"{pkg.name}.infra.flightrec")
        fleet = importlib.import_module(f"{pkg.name}.infra.fleetobs")
        intro = importlib.import_module(f"{pkg.name}.infra.introspect")
        saved.append((pkg, flight, fleet, intro,
                      list(pkg.telemetry.TRACER._sinks),
                      flight.FLIGHT._installed, fleet._ring_installed,
                      set(intro.STALLS._watches)))
    hook = sys.excepthook
    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGTERM, signal.SIGQUIT)}
    try:
        yield
    finally:
        for pkg, flight, fleet, intro, sinks, installed, ring, watches \
                in saved:
            for fn in list(pkg.telemetry.TRACER._sinks):
                if fn not in sinks:
                    pkg.telemetry.TRACER.remove_sink(fn)
            flight.FLIGHT._installed = installed
            fleet._ring_installed = ring
            for name in set(intro.STALLS._watches) - watches:
                intro.STALLS.unwatch(name)
        sys.excepthook = hook
        for s, h in handlers.items():
            signal.signal(s, h)
