"""Agent configuration + injected dependencies.

The reference splits this across Core.State (~60 fields,
reference lib/quoracle/agent/core/state.ex:68-170) and ConfigManager
(reference lib/quoracle/agent/config_manager.ex). Here the static part is
AgentConfig (what you pass to spawn), the injected services are AgentDeps
(the reference's registry/dynsup/pubsub/sandbox_owner opts — root
AGENTS.md:5-33), and the mutable runtime state lives on AgentCore itself
plus the context slice in context.history.AgentContext.

The PyTorch port's copy of ``quoracle_tpu/agent/state.py``.
"""

from __future__ import annotations

import dataclasses
import uuid
from decimal import Decimal
from typing import Any, Callable, Optional

from quoracle_tpu_torch.context.token_manager import TokenManager
from quoracle_tpu_torch.infra.budget import Escrow
from quoracle_tpu_torch.infra.bus import AgentEvents
from quoracle_tpu_torch.infra.costs import CostRecorder
from quoracle_tpu_torch.infra.security import SecretStore
from quoracle_tpu_torch.models.runtime import ModelBackend


def new_agent_id() -> str:
    return f"agent-{uuid.uuid4().hex[:12]}"


def new_action_id() -> str:
    return f"action-{uuid.uuid4().hex[:12]}"


@dataclasses.dataclass
class AgentConfig:
    """Static per-agent configuration, resolved at spawn time."""
    agent_id: str
    task_id: str
    model_pool: list[str]
    parent_id: Optional[str] = None

    # profile / governance (reference profiles + capability gating)
    profile: Optional[str] = None
    profile_description: Optional[str] = None
    capability_groups: Optional[list[str]] = None   # None = ungoverned
    forbidden_actions: tuple[str, ...] = ()         # grove hard rules
    max_refinement_rounds: int = 4
    force_reflection: bool = False

    # prompt fields (reference fields/prompt_field_manager.ex): the composed
    # identity block plus the raw pieces that flow down the tree
    field_system_prompt: Optional[str] = None
    own_constraints: Optional[str] = None           # this agent's constraints
    accumulated_constraints: tuple[str, ...] = ()   # every ancestor's
    profile_names: tuple[str, ...] = ()             # spawn enum injection
    # grove (reference groves/): directory, this agent's topology node, and
    # the governance docs resolved for it at spawn time
    grove_path: Optional[str] = None
    grove_node: Optional[str] = None
    governance_docs: Optional[str] = None
    # skills active at spawn/restore (names; content loads via SkillsLoader)
    active_skills: tuple[str, ...] = ()

    # budget (reference core/state.ex:286-290 modes root/allocated/na)
    budget_mode: str = "na"
    budget_limit: Optional[Decimal] = None

    # serving QoS: the tenant every model row this agent
    # submits is attributed to (inherited down the tree; the dashboard
    # maps bearer token → tenant at task creation), plus an optional
    # explicit class override — None derives the class from tree depth
    # (serving/qos.priority_for_depth: root agents outrank grandchildren).
    tenant: str = "default"
    qos_priority: Optional[int] = None

    # session-graph observability: OBSERVED-ONLY inherited
    # limits.  When set they ride the TreeContext into infra/treeobs —
    # children spawned with None inherit the parent's values; a subtree
    # exceeding token_budget fires the tree_budget_overrun flight event.
    # Nothing in the decide path enforces these; they are signals.
    deadline_ms: Optional[int] = None
    token_budget: Optional[int] = None

    # actions
    working_dir: str = "/tmp"
    max_consensus_retries: int = 3                  # agent AGENTS.md:204-214

    # restore path: pre-built context (model histories + ACE) from persistence
    restored_context: Optional[Any] = None


@dataclasses.dataclass
class AgentDeps:
    """Every service an agent touches, passed explicitly (the cardinal DI
    rule). One instance is shared by a whole tree; tests build a fresh set
    per test for isolation."""
    backend: ModelBackend
    registry: Any                    # AgentRegistry
    supervisor: Any                  # AgentSupervisor
    events: AgentEvents
    escrow: Escrow
    costs: CostRecorder
    token_manager: TokenManager
    secrets: SecretStore = dataclasses.field(default_factory=SecretStore)
    persistence: Any = None          # persistence layer
    # (The JAX AgentDeps also carries a grove override; groves are not
    # ported yet: ROADMAP Queue 1 item 9, second bullet.)
    skills: Any = None               # global SkillsLoader (optional)
    # world-facing seams (actions/world.py)
    http: Any = None                 # HttpFn transport; None = zero-egress
    ssrf_check: bool = True          # reference web.ex optional SSRF check
    mcp: Any = None                  # MCPManager
    credentials: Any = None          # CredentialStore (call_api/MCP auth)
    images: Any = None               # ImageBackend
    # test seams (reference injectable consensus_fn / delay_fn)
    consensus_fn: Optional[Callable] = None
    shell_sync_threshold_s: float = 0.1   # reference actions/shell.ex:13

    @classmethod
    def for_tests(cls, backend: ModelBackend, **overrides: Any) -> "AgentDeps":
        from quoracle_tpu_torch.agent.registry import AgentRegistry
        from quoracle_tpu_torch.infra.bus import EventBus
        registry = overrides.pop("registry", AgentRegistry())
        events = overrides.pop("events", AgentEvents(EventBus()))
        escrow = overrides.pop("escrow", Escrow())
        costs = overrides.pop("costs", CostRecorder(escrow=escrow))
        tm = overrides.pop("token_manager", TokenManager(
            backend.count_tokens, context_limit_fn=backend.context_window))
        deps = cls(backend=backend, registry=registry, supervisor=None,
                   events=events, escrow=escrow, costs=costs,
                   token_manager=tm, **overrides)
        return deps
