"""Task lifecycle: create / pause / restore / boot revival.

Parity with the reference's Tasks.TaskManager (create → insert row + spawn
root agent, reference tasks/task_manager.ex:39-92), TaskRestorer (pause =
status "pausing" → leaves-first stop → "paused"; restore rebuilds the agent
tree from rows, reference tasks/task_restorer.ex:31-80) and
Boot.AgentRevival (restore running tasks at boot, finalize stale "pausing" →
"paused", reference boot/agent_revival.ex:27-84,124-141).

The PyTorch port's copy of ``quoracle_tpu/persistence/tasks.py``.
Groves are not ported yet (ROADMAP Queue 1 item 9, second bullet): a
``grove`` raises ``NotImplementedError`` before any row is written.
"""

from __future__ import annotations

import logging
from decimal import Decimal
from typing import Any, Optional

from quoracle_tpu_torch.agent.registry import AlreadyRegisteredError
from quoracle_tpu_torch.agent.state import AgentConfig, AgentDeps, new_agent_id
from quoracle_tpu_torch.persistence.store import Persistence, new_task_id

logger = logging.getLogger(__name__)


class TaskManager:
    """Entry point for task-level operations. Holds the same deps object the
    agents run with; the supervisor inside deps owns the actual actors."""

    def __init__(self, deps: AgentDeps, persistence: Persistence):
        self.deps = deps
        self.store = persistence
        deps.persistence = persistence

    # ------------------------------------------------------------------

    def resolve_profile(self, profile: Optional[str]) -> dict:
        """Profile → model_pool / capability_groups / refinement config
        (reference profiles/resolver.ex — task creation REQUIRES a resolvable
        profile when one is named)."""
        if profile is None:
            return {}
        data = self.store.get_profile(profile)
        if data is None:
            raise ValueError(f"unknown profile {profile!r}")
        return data

    async def create_task(
        self, description: Optional[str] = None, *,
        model_pool: Optional[list[str]] = None,
        profile: Optional[str] = None,
        budget: Optional[str] = None,
        system_prompt: Optional[str] = None,
        working_dir: str = "/tmp",
        grove: Optional[str] = None,
        task_fields: Optional[dict] = None,
        tenant: str = "default",
    ) -> tuple[str, Any]:
        """Create the task row, spawn the root agent, deliver the initial
        message (reference task_manager.ex:39-92). With ``grove`` (a grove
        directory), the manifest's bootstrap pre-fills the missing fields
        and the root agent becomes the topology root node (reference
        BootstrapResolver + grove selector in the new-task modal); the
        port raises on one. Returns (task_id, root core)."""
        prof = self.resolve_profile(profile)
        pool = model_pool or prof.get("model_pool")
        if not pool:
            raise ValueError("a model_pool is required (directly or via "
                             "profile)")

        root_node = None
        governance_docs = None
        forbidden: tuple[str, ...] = ()
        active_skills: tuple[str, ...] = ()
        if grove is not None:
            # Groves (governance/grove.py) are not ported yet (ROADMAP
            # Queue 1 item 9, second bullet): the JAX manager pre-fills the
            # missing fields from the manifest's bootstrap here.
            raise NotImplementedError(
                f"groves are not ported yet (grove={grove!r})")
        if not description:
            raise ValueError("a task description is required (directly or "
                             "via the grove bootstrap)")

        task_id = new_task_id()
        self.store.create_task_row(task_id, task_fields or
                                   {"description": description},
                                   {"profile": profile,
                                    "model_pool": pool,
                                    "budget": budget,
                                    "grove": grove})
        config = AgentConfig(
            agent_id=new_agent_id(),
            task_id=task_id,
            model_pool=list(pool),
            profile=profile,
            profile_description=prof.get("description"),
            capability_groups=prof.get("capability_groups"),
            forbidden_actions=forbidden,
            max_refinement_rounds=prof.get("max_refinement_rounds", 4),
            force_reflection=prof.get("force_reflection", False),
            field_system_prompt=system_prompt,
            profile_names=tuple(self.store.list_profiles()),
            grove_path=grove,
            grove_node=root_node,
            governance_docs=governance_docs,
            active_skills=active_skills,
            budget_mode="root" if budget is not None else "na",
            budget_limit=Decimal(budget) if budget is not None else None,
            working_dir=working_dir,
            # QoS: the whole agent tree bills its model rows to
            # the creating tenant (dashboard: bearer token → tenant)
            tenant=tenant,
        )
        root = await self.deps.supervisor.start_agent(config)
        root.post({"type": "user_message", "content": description,
                   "from": "user"})
        self.deps.events.task_status_changed(task_id, "running")
        return task_id, root

    # ------------------------------------------------------------------

    async def pause_task(self, task_id: str) -> int:
        """Graceful pause: leaves-first stop_requested; each agent persists
        its ACE state in terminate (reference task_restorer.ex:31-80)."""
        self.store.set_task_status(task_id, "pausing")
        self.deps.events.task_status_changed(task_id, "pausing")
        stopped = await self.deps.supervisor.stop_all(task_id, reason="pause")
        # Late-registration sweep: a spawn that raced the pause may have
        # registered after stop_all collected (reference task_restorer late
        # sweep); stop again until quiescent.
        while self.deps.registry.agents_for_task(task_id):
            stopped += await self.deps.supervisor.stop_all(task_id,
                                                           reason="pause")
        self.store.set_task_status(task_id, "paused")
        self.deps.events.task_status_changed(task_id, "paused")
        return stopped

    async def restore_task(self, task_id: str) -> int:
        """Rebuild the agent tree from persisted rows, parents before
        children; agents resume idle with their histories and wake on the
        next message (KV caches re-prefill from history — SURVEY.md §5)."""
        task = self.store.get_task(task_id)
        if task is None:
            raise ValueError(f"unknown task {task_id!r}")
        rows = self.store.agents_for_task(task_id)
        by_id = {r["agent_id"]: r for r in rows}

        def depth(row: dict) -> int:
            d, cur = 0, row
            while cur and cur["parent_id"]:
                cur = by_id.get(cur["parent_id"])
                d += 1
            return d

        restored = 0
        for row in sorted(rows, key=depth):
            config = row["config"]
            config.restored_context = row["context"]
            try:
                await self.deps.supervisor.start_agent(config)
            except AlreadyRegisteredError:
                # ConflictResolver parity: already live (double restore) —
                # leave the live one alone.
                continue
            # Escrow books rebuild parent-first: children re-lock against
            # their parent, roots re-register, and historical spend returns
            # from the agent_costs ledger. This runs before the agent's own
            # run-task gets a loop slot, so its lazy register never races.
            escrow = self.deps.escrow
            if config.budget_limit is not None and config.parent_id:
                try:
                    escrow.lock_for_child(config.parent_id, config.agent_id,
                                          config.budget_limit)
                except Exception:
                    logger.warning("escrow re-lock failed for %s",
                                   config.agent_id)
            else:
                try:
                    escrow.get(config.agent_id)
                except KeyError:
                    escrow.register(config.agent_id, config.budget_mode,
                                    config.budget_limit)
            spent = self.store.agent_spent(config.agent_id)
            if spent:
                try:
                    escrow.record_spend(config.agent_id, spent)
                except KeyError:
                    pass
            self.store.db.execute(
                "UPDATE agents SET status='running' WHERE agent_id=?",
                (config.agent_id,))
            restored += 1
        self.store.set_task_status(task_id, "running")
        self.deps.events.task_status_changed(task_id, "running")
        return restored

    # ------------------------------------------------------------------

    async def boot_revival(self) -> dict:
        """Boot-time revival (reference agent_revival.ex:27-84): finalize
        stale 'pausing' tasks to 'paused', then restore every 'running' task
        sequentially and failure-isolated."""
        for task in self.store.list_tasks("pausing"):
            self.store.set_task_status(task["id"], "paused")
        revived, failed = [], []
        for task in self.store.list_tasks("running"):
            try:
                await self.restore_task(task["id"])
                revived.append(task["id"])
            except Exception:
                logger.exception("revival of task %s failed", task["id"])
                failed.append(task["id"])
        return {"revived": revived, "failed": failed}
