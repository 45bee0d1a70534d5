"""Persistence: SQLite-backed durable state + task lifecycle.

Re-design of the reference's Ecto/PostgreSQL layer (reference
lib/quoracle/repo.ex + priv/repo/migrations/ — tables tasks, agents, logs,
messages, actions, credentials, secrets, secret_usage, profiles,
model_settings, agent_costs; SURVEY.md §2.10/§5 checkpoint-resume) on
SQLite: same tables, JSONB columns become JSON text, AES-256-GCM at-rest
encryption for secret values (the reference's Cloak vault), and the same
continuous-persistence discipline — conversation after every decision, ACE
state on terminate, boot revival of running tasks.

The PyTorch port's copy of ``quoracle_tpu/persistence/``: the same
schema, so a database file written by either package is read by the
other.
"""

from quoracle_tpu_torch.persistence.db import Database
from quoracle_tpu_torch.persistence.store import Persistence
from quoracle_tpu_torch.persistence.tasks import TaskManager

__all__ = ["Database", "Persistence", "TaskManager"]
