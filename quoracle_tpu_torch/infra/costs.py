"""Cost recording + aggregation pipeline.

Parity with the reference's Costs.Recorder / Accumulator / Aggregator
(reference lib/quoracle/costs/recorder.ex:28-40, consensus/result.ex:33-47,
costs/aggregator.ex): every model/embedding call records a cost row, the
escrow's over-budget flag updates, and the UI gets a broadcast. On-TPU
serving has no API bill, but agents still budget — the catalog carries
nominal accounting rates (models/config.py input/output_cost_per_mtok).

The PyTorch port's copy of ``quoracle_tpu/infra/costs.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from decimal import Decimal
from typing import Callable, Optional

from quoracle_tpu_torch.infra.budget import Escrow
from quoracle_tpu_torch.infra.bus import AgentEvents

ZERO = Decimal("0")


@dataclasses.dataclass
class CostEntry:
    agent_id: str
    task_id: str
    amount: Decimal
    cost_type: str                    # "model" | "embedding" | "image" | "manual"
    model_spec: Optional[str] = None
    input_tokens: int = 0
    output_tokens: int = 0
    # Measured device wall attributed to this entry's decide by the
    # chip-economics ledger (infra/costobs.py).  0.0 when the
    # accounting plane is off or the call never touched a jitted step.
    # Kept beside the nominal Decimal so billing and reality sit in the
    # same row in /api/costs.
    measured_chip_ms: float = 0.0
    description: str = ""
    ts: float = 0.0
    id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)


def token_cost(cfg, input_tokens: int, output_tokens: int) -> Decimal:
    """Nominal accounting cost from catalog rates (USD per 1M tokens)."""
    return (Decimal(str(cfg.input_cost_per_mtok)) * input_tokens
            + Decimal(str(cfg.output_cost_per_mtok)) * output_tokens) / 1_000_000


class CostRecorder:
    """Durable-ish cost log + escrow update + bus broadcast. `persist_fn` is
    the injectable write-through to the DB layer (reference recorder pattern:
    record to agent_costs then broadcast)."""

    def __init__(self, escrow: Optional[Escrow] = None,
                 events: Optional[AgentEvents] = None,
                 persist_fn: Optional[Callable[[CostEntry], None]] = None,
                 clock: Callable[[], float] = time.time):
        self.escrow = escrow
        self.events = events
        self.persist_fn = persist_fn
        self._clock = clock
        self._entries: list[CostEntry] = []
        self._lock = threading.Lock()

    def record(self, entry: CostEntry) -> CostEntry:
        entry.ts = entry.ts or self._clock()
        with self._lock:
            self._entries.append(entry)
        if self.escrow is not None:
            try:
                self.escrow.record_spend(entry.agent_id, entry.amount)
            except KeyError:
                pass  # agent not budget-registered (e.g. during teardown)
        if self.persist_fn is not None:
            self.persist_fn(entry)
        if self.events is not None:
            self.events.cost_recorded(entry.agent_id, {
                "amount": str(entry.amount), "type": entry.cost_type,
                "model": entry.model_spec,
                "input_tokens": entry.input_tokens,
                "output_tokens": entry.output_tokens,
                "measured_chip_ms": entry.measured_chip_ms,
            })
        return entry

    def entries_for(self, agent_id: str) -> list[CostEntry]:
        with self._lock:
            return [e for e in self._entries if e.agent_id == agent_id]

    def total_for(self, agent_id: str) -> Decimal:
        return sum((e.amount for e in self.entries_for(agent_id)), ZERO)


class CostAccumulator:
    """Batches embedding costs incurred *inside* consensus merging so they
    are recorded once per round, not once per cosine call (reference threads
    an accumulator through Result.merge, result.ex:33-47)."""

    def __init__(self) -> None:
        self.amount: Decimal = ZERO
        self.calls: int = 0
        self.tokens: int = 0

    def add(self, amount, tokens: int = 0) -> None:
        self.amount += amount if isinstance(amount, Decimal) else Decimal(str(amount))
        self.calls += 1
        self.tokens += tokens

    def flush_to(self, recorder: CostRecorder, agent_id: str, task_id: str,
                 model_spec: Optional[str] = None) -> Optional[CostEntry]:
        if self.calls == 0:
            return None
        entry = recorder.record(CostEntry(
            agent_id=agent_id, task_id=task_id, amount=self.amount,
            cost_type="embedding", model_spec=model_spec,
            input_tokens=self.tokens,
            description=f"{self.calls} embedding calls during consensus merge"))
        self.amount, self.calls, self.tokens = ZERO, 0, 0
        return entry


class CostAggregator:
    """Tree-level roll-ups for UI badges (reference costs/aggregator.ex)."""

    def __init__(self, recorder: CostRecorder):
        self.recorder = recorder

    def agent_total(self, agent_id: str) -> Decimal:
        return self.recorder.total_for(agent_id)

    def tree_total(self, agent_ids: list[str]) -> Decimal:
        return sum((self.recorder.total_for(a) for a in agent_ids), ZERO)

    def by_model(self, agent_id: str) -> dict[str, Decimal]:
        out: dict[str, Decimal] = {}
        for e in self.recorder.entries_for(agent_id):
            key = e.model_spec or e.cost_type
            out[key] = out.get(key, ZERO) + e.amount
        return out
