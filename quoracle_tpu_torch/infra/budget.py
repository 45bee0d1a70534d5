"""Budget escrow: hierarchical spend limits over the agent tree.

Parity with the reference's Budget.Escrow / Tracker / Enforcer
(reference lib/quoracle/budget/escrow.ex:40-121): a parent locks part of its
budget when spawning a child, releases the unspent remainder (clamped >= 0)
on dismiss, and can atomically adjust a child's allocation. Three budget
modes — root (self-imposed cap), allocated (given by parent), na (unlimited)
(reference lib/quoracle/agent/core/state.ex:286-290). All arithmetic is
Decimal, never float (money).

The PyTorch port's copy of ``quoracle_tpu/infra/budget.py``.
"""

from __future__ import annotations

import dataclasses
import threading
from decimal import Decimal
from typing import Optional

ZERO = Decimal("0")


class BudgetError(ValueError):
    pass


@dataclasses.dataclass
class BudgetState:
    """One agent's budget view. mode: "root" | "allocated" | "na"."""
    mode: str = "na"
    limit: Optional[Decimal] = None      # None iff mode == "na"
    spent: Decimal = ZERO                # own recorded costs
    committed: Decimal = ZERO            # escrow locked for live children

    @property
    def available(self) -> Optional[Decimal]:
        if self.limit is None:
            return None
        return self.limit - self.spent - self.committed

    @property
    def over_budget(self) -> bool:
        avail = self.available
        return avail is not None and avail < ZERO

    def snapshot(self) -> dict:
        return {
            "mode": self.mode,
            "limit": str(self.limit) if self.limit is not None else None,
            "spent": str(self.spent),
            "committed": str(self.committed),
            "available": str(self.available) if self.available is not None else None,
        }


def _dec(x) -> Decimal:
    if isinstance(x, Decimal):
        return x
    if isinstance(x, float):
        # Floats come from JSON; route through str to avoid binary artifacts.
        return Decimal(str(x))
    return Decimal(x)


class Escrow:
    """Tree-wide escrow ledger. One instance per task tree, injected
    explicitly. Thread-safe: spawn/dismiss/adjust race from concurrent agent
    tasks (the reference serializes through the parent GenServer; here the
    ledger is the serialization point)."""

    def __init__(self) -> None:
        self._states: dict[str, BudgetState] = {}
        self._child_alloc: dict[str, Decimal] = {}   # child_id -> allocation
        self._parent: dict[str, str] = {}            # child_id -> parent_id
        self._lock = threading.Lock()

    def register(self, agent_id: str, mode: str = "na",
                 limit=None) -> BudgetState:
        with self._lock:
            st = BudgetState(mode=mode,
                             limit=_dec(limit) if limit is not None else None)
            if mode != "na" and st.limit is None:
                raise BudgetError(f"mode {mode!r} requires a limit")
            self._states[agent_id] = st
            return st

    def get(self, agent_id: str) -> BudgetState:
        with self._lock:
            return self._states[agent_id]

    # -- escrow lifecycle (reference escrow.ex:40-121) ---------------------
    def lock_for_child(self, parent_id: str, child_id: str, amount) -> BudgetState:
        """Lock `amount` of the parent's budget for a child spawn. Children
        MUST get a budget when the parent is budgeted (reference
        actions/spawn.ex:152-155)."""
        amount = _dec(amount)
        if amount < ZERO:
            raise BudgetError("negative child budget")
        with self._lock:
            parent = self._states[parent_id]
            if parent.limit is not None:
                if parent.available < amount:
                    raise BudgetError(
                        f"insufficient budget: available {parent.available}, "
                        f"requested {amount}")
                parent.committed += amount
            self._child_alloc[child_id] = amount
            self._parent[child_id] = parent_id
            child = BudgetState(mode="allocated", limit=amount)
            self._states[child_id] = child
            return child

    def release_child(self, child_id: str) -> Decimal:
        """Dismiss: release the child's unspent allocation back to the parent
        (clamped >= 0 — an over-spent child never *adds* budget back;
        reference escrow.ex release semantics). Returns the released amount."""
        with self._lock:
            alloc = self._child_alloc.pop(child_id, None)
            parent_id = self._parent.pop(child_id, None)
            child = self._states.pop(child_id, None)
            if alloc is None or parent_id is None:
                return ZERO
            # Out-of-order dismissal: re-parent this child's live children to
            # the grandparent so their later release still credits a live
            # ledger (their allocations move with them).
            kid_alloc = ZERO
            for k, p in list(self._parent.items()):
                if p == child_id:
                    self._parent[k] = parent_id
                    kid_alloc += self._child_alloc.get(k, ZERO)
            own_spent = child.spent if child else alloc
            unspent = max(ZERO, alloc - own_spent - kid_alloc)
            parent = self._states.get(parent_id)
            if parent is not None and parent.limit is not None:
                parent.committed -= alloc - kid_alloc
                parent.spent += min(alloc, own_spent)
            return unspent

    def adjust_child(self, parent_id: str, child_id: str, new_amount) -> BudgetState:
        """Atomically re-allocate a child's budget (reference
        Core.BudgetHandler.adjust_child_budget/4). Raising the allocation
        draws from the parent's available budget; lowering returns the
        difference, but never below what the child has already spent."""
        new_amount = _dec(new_amount)
        with self._lock:
            if self._parent.get(child_id) != parent_id:
                raise BudgetError(f"{child_id} is not a budgeted child of {parent_id}")
            parent = self._states[parent_id]
            child = self._states[child_id]
            old = self._child_alloc[child_id]
            floor = child.spent + child.committed
            if new_amount < floor:
                raise BudgetError(
                    f"cannot set child budget {new_amount} below its "
                    f"spent+committed {floor}")
            delta = new_amount - old
            if parent.limit is not None:
                if delta > ZERO and parent.available < delta:
                    raise BudgetError(
                        f"insufficient budget for increase: available "
                        f"{parent.available}, needed {delta}")
                parent.committed += delta
            self._child_alloc[child_id] = new_amount
            child.limit = new_amount
            return child

    # -- spend -------------------------------------------------------------
    def record_spend(self, agent_id: str, amount) -> BudgetState:
        """Record a cost against an agent. Never blocks the spend (the
        reference flags over-budget rather than failing the action — the
        agent sees the flag next consensus cycle, core.ex:442-443)."""
        amount = _dec(amount)
        with self._lock:
            st = self._states[agent_id]
            st.spent += amount
            return st

    def child_allocation(self, child_id: str) -> Optional[Decimal]:
        with self._lock:
            return self._child_alloc.get(child_id)
