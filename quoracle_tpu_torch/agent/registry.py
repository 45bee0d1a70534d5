"""Agent registry: discovery by id / parent / task.

Parity with the reference's Registry usage (reference
lib/quoracle/agent/registry_queries.ex and the atomic-registration pattern of
agent AGENTS.md:62-65 — a single register call carries the composite value
{pid, parent_pid, registered_at} so there is never a window where an agent is
registered without its parent link). Here the "pid" is the AgentCore object
itself; liveness is the core's run task, owned by the supervisor.

A ``dismissing`` flag on the registration closes the spawn/dismiss race the
reference closes in core.ex:213-220: spawn_child checks the parent's flag
before starting a child, so a subtree being torn down cannot grow.

The PyTorch port's copy of ``quoracle_tpu/agent/registry.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional


class AlreadyRegisteredError(RuntimeError):
    pass


@dataclasses.dataclass
class Registration:
    agent_id: str
    core: Any                       # AgentCore (Any avoids import cycle)
    parent_id: Optional[str]
    task_id: str
    registered_at: float = dataclasses.field(default_factory=time.time)
    dismissing: bool = False


class AgentRegistry:
    """Unique-key registry. Thread-safe: the event loop mutates it, but
    executor threads (backend calls, UI reads) may query concurrently."""

    def __init__(self) -> None:
        self._by_id: dict[str, Registration] = {}
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------------

    def register(self, agent_id: str, core: Any, parent_id: Optional[str],
                 task_id: str) -> Registration:
        reg = Registration(agent_id, core, parent_id, task_id)
        with self._lock:
            if agent_id in self._by_id:
                raise AlreadyRegisteredError(agent_id)
            self._by_id[agent_id] = reg
        return reg

    def unregister(self, agent_id: str) -> None:
        with self._lock:
            self._by_id.pop(agent_id, None)

    def mark_dismissing(self, agent_id: str) -> bool:
        """Set the dismissing flag; returns False if it was already set
        (idempotent dismissal, reference core.ex:213-220)."""
        with self._lock:
            reg = self._by_id.get(agent_id)
            if reg is None or reg.dismissing:
                return False
            reg.dismissing = True
            return True

    def dismissing(self, agent_id: str) -> bool:
        with self._lock:
            reg = self._by_id.get(agent_id)
            return bool(reg and reg.dismissing)

    # -- queries (reference registry_queries.ex) ---------------------------

    def lookup(self, agent_id: str) -> Optional[Registration]:
        with self._lock:
            return self._by_id.get(agent_id)

    def children_of(self, parent_id: str) -> list[Registration]:
        with self._lock:
            return [r for r in self._by_id.values()
                    if r.parent_id == parent_id]

    def parent_of(self, agent_id: str) -> Optional[Registration]:
        with self._lock:
            reg = self._by_id.get(agent_id)
            if reg is None or reg.parent_id is None:
                return None
            return self._by_id.get(reg.parent_id)

    def siblings_of(self, agent_id: str) -> list[Registration]:
        with self._lock:
            reg = self._by_id.get(agent_id)
            if reg is None or reg.parent_id is None:
                return []
            return [r for r in self._by_id.values()
                    if r.parent_id == reg.parent_id and r.agent_id != agent_id]

    def agents_for_task(self, task_id: str) -> list[Registration]:
        with self._lock:
            return [r for r in self._by_id.values() if r.task_id == task_id]

    def all(self) -> list[Registration]:
        with self._lock:
            return list(self._by_id.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_id)
