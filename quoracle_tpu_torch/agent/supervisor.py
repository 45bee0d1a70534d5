"""AgentSupervisor: owns agent run-tasks; recursive tree termination.

Parity with the reference's Agent.DynSup (DynamicSupervisor wrapper,
reference lib/quoracle/agent/dyn_sup.ex — start_agent / terminate_agent /
restore_agent) and TreeTerminator (reference
lib/quoracle/agent/tree_terminator.ex, agent AGENTS.md:168-175: BFS collect
with the ``dismissing`` flag set first so the subtree cannot grow mid-
dismissal, then bottom-up termination, then row cleanup + dual broadcasts).

The PyTorch port's copy of ``quoracle_tpu/agent/supervisor.py``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from quoracle_tpu_torch.agent.core import AgentCore
from quoracle_tpu_torch.agent.state import AgentConfig, AgentDeps
from quoracle_tpu_torch.infra.budget import BudgetError

logger = logging.getLogger(__name__)


class AgentSupervisor:
    def __init__(self, deps: AgentDeps):
        self.deps = deps
        deps.supervisor = self
        self._tasks: dict[str, asyncio.Task] = {}

    # -- lifecycle ---------------------------------------------------------

    async def start_agent(self, config: AgentConfig) -> AgentCore:
        """Create, register (atomically, with parent link — agent
        AGENTS.md:62-65), and start an agent's run task."""
        core = AgentCore(config, self.deps)
        self.deps.registry.register(config.agent_id, core, config.parent_id,
                                    config.task_id)
        try:
            task = asyncio.ensure_future(core.run())
        except Exception:
            self.deps.registry.unregister(config.agent_id)
            raise
        self._tasks[config.agent_id] = task
        task.add_done_callback(
            lambda t, aid=config.agent_id: self._on_agent_done(aid, t))
        return core

    def restore_agent(self, config: AgentConfig) -> "asyncio.Future[AgentCore]":
        """Restore from persisted state: config carries restored_context
        (prefers persisted model_histories + ACE, reference dyn_sup.ex
        restore_agent). Same start path — restoration is just a spawn with
        history."""
        return asyncio.ensure_future(self.start_agent(config))

    def _on_agent_done(self, agent_id: str, task: asyncio.Task) -> None:
        self.deps.registry.unregister(agent_id)
        self._tasks.pop(agent_id, None)
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            logger.error("agent %s crashed: %s", agent_id, exc)
            self.deps.events.log(agent_id, "error", f"agent crashed: {exc}")

    async def terminate_agent(self, agent_id: str, reason: str = "normal",
                              timeout: Optional[float] = None) -> bool:
        """Graceful stop; waits for the actor to drain (the reference's
        GenServer.stop(pid, :normal, :infinity) rule — root AGENTS.md:24-26 —
        hence timeout=None by default)."""
        reg = self.deps.registry.lookup(agent_id)
        task = self._tasks.get(agent_id)
        if reg is None or task is None:
            return False
        reg.core.post({"type": "stop_requested", "reason": reason})
        try:
            await asyncio.wait_for(asyncio.shield(task), timeout)
        except asyncio.TimeoutError:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        except Exception:
            pass  # crash already logged by _on_agent_done
        # Free the agent's resident KV sessions — dead agents must not pin
        # HBM until LRU pressure happens to evict them.
        drop = getattr(self.deps.backend, "drop_session", None)
        if drop is not None:
            drop(agent_id)
        # MCP teardown (reference: per-agent Client GenServers die with
        # their agent): connections only this agent used close now.
        mcp = getattr(self.deps, "mcp", None)
        if mcp is not None:
            try:
                await mcp.release_agent(agent_id)
            except Exception:
                logger.exception("MCP release for %s failed", agent_id)
        return True

    # -- tree termination (reference tree_terminator.ex) -------------------

    async def terminate_tree(self, root_id: str, by: Optional[str] = None,
                             reason: str = "dismissed") -> int:
        registry, deps = self.deps.registry, self.deps
        if not registry.mark_dismissing(root_id):
            return 0  # already being dismissed (idempotent)
        # BFS collect, flagging every node BEFORE any termination so
        # concurrent spawn_child calls see the flag and refuse.
        order = [root_id]
        i = 0
        while i < len(order):
            for child in registry.children_of(order[i]):
                registry.mark_dismissing(child.agent_id)
                order.append(child.agent_id)
            i += 1
        terminated = 0
        for agent_id in reversed(order):   # leaves first
            if await self.terminate_agent(agent_id, reason=reason):
                terminated += 1
            try:
                deps.escrow.release_child(agent_id)
            except (BudgetError, KeyError):
                pass  # root of the tree / unbudgeted agents
            if deps.persistence is not None:
                deps.persistence.delete_agent(agent_id)
            deps.events.agent_dismissed(agent_id, by=by)
        return terminated

    async def stop_all(self, task_id: Optional[str] = None,
                       reason: str = "pause") -> int:
        """Stop agents (of one task, or all) deepest-first without deleting
        state — the pause path (reference task_restorer.ex:31-80
        reverse-order :stop_requested)."""
        regs = (self.deps.registry.agents_for_task(task_id)
                if task_id else self.deps.registry.all())
        def depth(reg) -> int:
            d, cur = 0, reg
            while cur is not None and cur.parent_id is not None:
                cur = self.deps.registry.lookup(cur.parent_id)
                d += 1
            return d
        stopped = 0
        for reg in sorted(regs, key=depth, reverse=True):
            if await self.terminate_agent(reg.agent_id, reason=reason):
                stopped += 1
        return stopped

    def live_agents(self) -> list[str]:
        return list(self._tasks)
