"""Agent runtime: asyncio actor core, registry, supervisor.

The reference's GenServer/DynamicSupervisor/Registry trio
(reference lib/quoracle/agent/) rebuilt on asyncio per SURVEY.md §7:
one actor object + mailbox queue per agent, a supervisor owning the run
tasks, and a plain registry object with composite values. Everything is
injected explicitly (reference root AGENTS.md:5-33 — no global state), so
tests run fully parallel with per-test registries/buses/backends.

The PyTorch port's copy of ``quoracle_tpu/agent/``: agents whose decides
run on the port's ``TorchBackend``.
"""

from quoracle_tpu_torch.agent.registry import AgentRegistry, Registration
from quoracle_tpu_torch.agent.state import AgentConfig, AgentDeps, new_agent_id
from quoracle_tpu_torch.agent.core import AgentCore
from quoracle_tpu_torch.agent.supervisor import AgentSupervisor

__all__ = [
    "AgentRegistry", "Registration", "AgentConfig", "AgentDeps",
    "new_agent_id", "AgentCore", "AgentSupervisor",
]
