"""Persistence facade: the hooks the agent runtime calls + durable stores.

Implements the write-through discipline of the reference (SURVEY.md §5
checkpoint/resume): agent row on init (reference Core.Persistence,
core.ex:479-484), conversation after every decision (reference
action_executor.ex:102-105), ACE state on terminate (core.ex:464-467), rows
deleted on dismissal (reference TreeTerminator deletes agents/logs/messages/
costs). The bus writer makes logs/messages/actions durable the way the
reference's Ecto inserts do, without the agents knowing about the DB.

The PyTorch port's copy of ``quoracle_tpu/persistence/store.py``.
"""

from __future__ import annotations

import json
import logging
import time
import uuid
from decimal import Decimal
from typing import Any, Optional

from quoracle_tpu_torch.context.history import AgentContext, HistoryEntry, Lesson
from quoracle_tpu_torch.infra.bus import EventBus, Subscription
from quoracle_tpu_torch.infra.security import SecretStore
from quoracle_tpu_torch.persistence.db import Database

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Serialization (reference agents.conversation_history / ace_state JSONB)
# ---------------------------------------------------------------------------


def serialize_context(ctx: AgentContext, children: list[dict]) -> str:
    return json.dumps({
        "model_histories": {
            m: [{"kind": e.kind, "content": e.content, "ts": e.ts,
                 "action_type": e.action_type} for e in entries]
            for m, entries in ctx.model_histories.items()
        },
        "context_lessons": {
            # Embeddings are NOT persisted (like KV caches, SURVEY.md §5) —
            # they re-embed lazily on the next dedup pass after resume.
            m: [{"type": l.type, "content": l.content,
                 "confidence": l.confidence} for l in lessons]
            for m, lessons in ctx.context_lessons.items()
        },
        "model_states": ctx.model_states,
        "todos": ctx.todos,
        "children": children,
        "context_summary": ctx.context_summary,
    })


def deserialize_context(raw: str) -> AgentContext:
    d = json.loads(raw or "{}")
    ctx = AgentContext()
    ctx.model_histories = {
        m: [HistoryEntry(kind=e["kind"], content=e["content"],
                         ts=e.get("ts", 0.0),
                         action_type=e.get("action_type"))
            for e in entries]
        for m, entries in d.get("model_histories", {}).items()
    }
    ctx.context_lessons = {
        m: [Lesson(type=l["type"], content=l["content"],
                   confidence=l.get("confidence", 1)) for l in lessons]
        for m, lessons in d.get("context_lessons", {}).items()
    }
    ctx.model_states = d.get("model_states", {})
    ctx.todos = d.get("todos", [])
    ctx.children = d.get("children", [])
    ctx.context_summary = d.get("context_summary")
    return ctx


def serialize_config(config: Any) -> str:
    import dataclasses
    d = dataclasses.asdict(config)
    d.pop("restored_context", None)
    if d.get("budget_limit") is not None:
        d["budget_limit"] = str(d["budget_limit"])
    return json.dumps(d)


def deserialize_config(raw: str) -> Any:
    from quoracle_tpu_torch.agent.state import AgentConfig
    d = json.loads(raw)
    if d.get("budget_limit") is not None:
        d["budget_limit"] = Decimal(d["budget_limit"])
    for k in ("forbidden_actions", "profile_names",
              "accumulated_constraints", "active_skills"):
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    return AgentConfig(**d)


# ---------------------------------------------------------------------------
# Durable secret store
# ---------------------------------------------------------------------------


class PersistentSecretStore(SecretStore):
    """SecretStore backed by the secrets/secret_usage tables; values
    AES-encrypted at rest via the DB vault (reference TableCredentials +
    Cloak Encrypted.Binary; audit trail reference audit/secret_usage.ex)."""

    def __init__(self, db: Database):
        super().__init__()
        self.db = db
        for row in db.query("SELECT * FROM secrets"):
            if row["encrypted"] and not db.vault.active:
                # Degraded boot without the key (reference
                # application.ex:25-36): the rest of the system keeps
                # working; this secret is just unavailable.
                logger.warning("secret %r is encrypted but no encryption "
                               "key is loaded; skipping", row["name"])
                continue
            value = db.vault.decrypt(row["value"], bool(row["encrypted"]))
            super().put(row["name"], value, row["description"] or "",
                        row["created_by"])

    def put(self, name, value, description="", created_by=None):
        secret = super().put(name, value, description, created_by)
        blob, enc = self.db.vault.encrypt(value)
        self.db.execute(
            "INSERT OR REPLACE INTO secrets "
            "(name, value, encrypted, description, created_by, created_at) "
            "VALUES (?,?,?,?,?,?)",
            (name, blob, int(enc), description, created_by, secret.created_at))
        return secret

    def delete(self, name):
        # the DB row can exist without an in-memory entry (degraded boot
        # skipped encrypted secrets); report what was actually destroyed
        row = self.db.query_one("SELECT name FROM secrets WHERE name=?",
                                (name,))
        existed = super().delete(name) or row is not None
        self.db.execute("DELETE FROM secrets WHERE name=?", (name,))
        return existed

    def lookup(self, name, *, agent_id="", action=""):
        value = super().lookup(name, agent_id=agent_id, action=action)
        if value is not None and agent_id:
            self.db.execute(
                "INSERT INTO secret_usage (secret_name, agent_id, action, ts)"
                " VALUES (?,?,?,?)", (name, agent_id, action, time.time()))
        return value


# ---------------------------------------------------------------------------
# Credential store
# ---------------------------------------------------------------------------


class CredentialStore:
    """Encrypted provider-credential records over the ``credentials`` table
    (reference CredentialManager/TableCredentials: per-model encrypted
    api_key + endpoint metadata, Cloak-encrypted at rest,
    models/credential_manager.ex + table_credentials.ex). On-device
    serving needs no API keys, so here credentials gate the OUTBOUND
    integrations — ``call_api`` auth and MCP server headers — with the
    same at-rest encryption and usage-audit treatment secrets get.

    A record's ``data`` is the auth payload (e.g. ``{"type": "bearer",
    "token": ...}`` or ``{"type": "header", "name": ..., "value": ...}``
    plus optional endpoint metadata); ``model_spec`` keeps the reference's
    per-model association for provider-style records."""

    def __init__(self, db: Database):
        self.db = db

    def put(self, cred_id: str, data: dict,
            model_spec: Optional[str] = None) -> None:
        if not cred_id or not isinstance(cred_id, str):
            raise ValueError("credential id must be a non-empty string")
        blob, enc = self.db.vault.encrypt(json.dumps(data))
        self.db.execute(
            "INSERT OR REPLACE INTO credentials "
            "(id, model_spec, data, encrypted) VALUES (?,?,?,?)",
            (cred_id, model_spec, blob, int(enc)))

    def get(self, cred_id: str, *, agent_id: str = "",
            action: str = "") -> Optional[dict]:
        row = self.db.query_one("SELECT * FROM credentials WHERE id=?",
                                (cred_id,))
        if row is None:
            return None
        if row["encrypted"] and not self.db.vault.active:
            logger.warning("credential %r is encrypted but no encryption "
                           "key is loaded", cred_id)
            return None
        data = json.loads(
            self.db.vault.decrypt(row["data"], bool(row["encrypted"])))
        if agent_id:   # audit trail, same table/shape as secret access
            self.db.execute(
                "INSERT INTO secret_usage (secret_name, agent_id, action, "
                "ts) VALUES (?,?,?,?)",
                (f"credential:{cred_id}", agent_id, action, time.time()))
        return data

    def for_model(self, model_spec: str) -> Optional[dict]:
        rows = self.db.query(
            "SELECT id FROM credentials WHERE model_spec=? ORDER BY id",
            (model_spec,))
        if not rows:
            return None
        if len(rows) > 1:
            # no UNIQUE constraint on model_spec — deterministic pick
            # (lowest id) instead of whichever row the engine returns first
            logger.warning(
                "%d credentials registered for model_spec=%r; using %r",
                len(rows), model_spec, rows[0]["id"])
        return self.get(rows[0]["id"])

    def delete(self, cred_id: str) -> bool:
        row = self.db.query_one("SELECT id FROM credentials WHERE id=?",
                                (cred_id,))
        self.db.execute("DELETE FROM credentials WHERE id=?", (cred_id,))
        return row is not None

    def list(self) -> list[dict]:
        """Metadata only — never the decrypted payloads."""
        return [{"id": r["id"], "model_spec": r["model_spec"],
                 "encrypted": bool(r["encrypted"])}
                for r in self.db.query(
                    "SELECT id, model_spec, encrypted FROM credentials "
                    "ORDER BY id")]


# ---------------------------------------------------------------------------
# Persistence facade
# ---------------------------------------------------------------------------


class Persistence:
    def __init__(self, db: Database):
        self.db = db
        self._bus_sub: Optional[Subscription] = None

    # -- agent hooks (called by AgentCore / AgentSupervisor) ---------------

    def persist_agent(self, core: Any) -> None:
        now = time.time()
        self.db.execute(
            "INSERT OR REPLACE INTO agents "
            "(agent_id, task_id, parent_id, status, config, ace_state, "
            " created_at, updated_at) VALUES (?,?,?,?,?,?,"
            " COALESCE((SELECT created_at FROM agents WHERE agent_id=?),?),?)",
            (core.agent_id, core.config.task_id, core.config.parent_id,
             "running", serialize_config(core.config),
             serialize_context(core.ctx, core.children),
             core.agent_id, now, now))

    def persist_conversation(self, core: Any) -> None:
        """After every decision/result (reference action_executor.ex:102-105
        persists conversation continuously)."""
        self.db.execute(
            "UPDATE agents SET ace_state=?, updated_at=? WHERE agent_id=?",
            (serialize_context(core.ctx, core.children), time.time(),
             core.agent_id))

    def persist_ace_state(self, core: Any) -> None:
        self.db.execute(
            "UPDATE agents SET ace_state=?, status=?, updated_at=? "
            "WHERE agent_id=?",
            (serialize_context(core.ctx, core.children), "stopped",
             time.time(), core.agent_id))

    def delete_agent(self, agent_id: str) -> None:
        """Dismissal cleanup (reference TreeTerminator deletes the agent's
        rows across agents/logs/messages/costs)."""
        self.db.execute("DELETE FROM agents WHERE agent_id=?", (agent_id,))
        self.db.execute("DELETE FROM logs WHERE agent_id=?", (agent_id,))
        self.db.execute("DELETE FROM agent_costs WHERE agent_id=?",
                        (agent_id,))
        self.db.execute("DELETE FROM actions WHERE agent_id=?", (agent_id,))
        self.db.execute("DELETE FROM consensus_audit WHERE agent_id=?",
                        (agent_id,))

    # -- costs (CostRecorder persist_fn) -----------------------------------

    def persist_cost(self, entry: Any) -> None:
        self.db.execute(
            "INSERT OR REPLACE INTO agent_costs "
            "(id, agent_id, task_id, amount, cost_type, model_spec, "
            " input_tokens, output_tokens, description, ts) "
            "VALUES (?,?,?,?,?,?,?,?,?,?)",
            (entry.id, entry.agent_id, entry.task_id, str(entry.amount),
             entry.cost_type, entry.model_spec, entry.input_tokens,
             entry.output_tokens, entry.description, entry.ts))

    def costs_for_task(self, task_id: str) -> Decimal:
        # Sum in Decimal: amounts are stored as text precisely so money math
        # never passes through floats (reference uses decimal(12,10)).
        rows = self.db.query(
            "SELECT amount FROM agent_costs WHERE task_id=?", (task_id,))
        return sum((Decimal(r["amount"]) for r in rows), Decimal("0"))

    def total_costs(self) -> Decimal:
        """Every recorded cost across all tasks (telemetry roll-up)."""
        rows = self.db.query("SELECT amount FROM agent_costs")
        return sum((Decimal(r["amount"]) for r in rows), Decimal("0"))

    def agent_spent(self, agent_id: str) -> Decimal:
        rows = self.db.query(
            "SELECT amount FROM agent_costs WHERE agent_id=?", (agent_id,))
        return sum((Decimal(r["amount"]) for r in rows), Decimal("0"))

    # -- consensus audit ---------------------------------------------------

    def audit_for_task(self, task_id: str, limit: int = 200) -> list[dict]:
        """Durable consensus-audit records for one task, oldest first
        (the /api/consensus read model beyond the in-memory ring)."""
        rows = self.db.query(
            "SELECT record FROM consensus_audit WHERE task_id=? "
            "ORDER BY id DESC LIMIT ?", (task_id, limit))
        out = []
        for r in reversed(rows):
            try:
                out.append(json.loads(r["record"]))
            except (TypeError, json.JSONDecodeError):
                continue
        return out

    # -- tasks -------------------------------------------------------------

    def create_task_row(self, task_id: str, task_fields: dict,
                        agent_fields: dict) -> None:
        now = time.time()
        self.db.execute(
            "INSERT INTO tasks (id, status, task_fields, agent_fields, "
            "created_at, updated_at) VALUES (?,?,?,?,?,?)",
            (task_id, "running", json.dumps(task_fields),
             json.dumps(agent_fields), now, now))

    def set_task_status(self, task_id: str, status: str) -> None:
        self.db.execute("UPDATE tasks SET status=?, updated_at=? WHERE id=?",
                        (status, time.time(), task_id))

    def get_task(self, task_id: str) -> Optional[dict]:
        row = self.db.query_one("SELECT * FROM tasks WHERE id=?", (task_id,))
        if row is None:
            return None
        return {"id": row["id"], "status": row["status"],
                "task_fields": json.loads(row["task_fields"]),
                "agent_fields": json.loads(row["agent_fields"]),
                "created_at": row["created_at"],
                "updated_at": row["updated_at"]}

    def list_tasks(self, status: Optional[str] = None) -> list[dict]:
        rows = (self.db.query("SELECT id FROM tasks WHERE status=?", (status,))
                if status else self.db.query("SELECT id FROM tasks"))
        return [t for t in (self.get_task(r["id"]) for r in rows) if t]

    def agents_for_task(self, task_id: str) -> list[dict]:
        rows = self.db.query(
            "SELECT * FROM agents WHERE task_id=? ORDER BY created_at",
            (task_id,))
        return [{"agent_id": r["agent_id"], "parent_id": r["parent_id"],
                 "status": r["status"],
                 "config": deserialize_config(r["config"]),
                 "context": deserialize_context(r["ace_state"])}
                for r in rows]

    # -- profiles / settings (reference TableProfiles, ConfigModelSettings) -

    def save_profile(self, name: str, data: dict) -> None:
        self.db.execute(
            "INSERT OR REPLACE INTO profiles (name, data) VALUES (?,?)",
            (name, json.dumps(data)))

    def get_profile(self, name: str) -> Optional[dict]:
        row = self.db.query_one("SELECT data FROM profiles WHERE name=?",
                                (name,))
        return json.loads(row["data"]) if row else None

    def list_profiles(self) -> list[str]:
        return [r["name"] for r in
                self.db.query("SELECT name FROM profiles ORDER BY name")]

    def delete_profile(self, name: str) -> bool:
        existed = self.get_profile(name) is not None
        self.db.execute("DELETE FROM profiles WHERE name=?", (name,))
        return existed

    def set_setting(self, key: str, value: Any) -> None:
        self.db.execute(
            "INSERT OR REPLACE INTO model_settings (key, value) VALUES (?,?)",
            (key, json.dumps(value)))

    def get_setting(self, key: str, default: Any = None) -> Any:
        row = self.db.query_one(
            "SELECT value FROM model_settings WHERE key=?", (key,))
        return json.loads(row["value"]) if row else default

    def all_settings(self) -> dict:
        return {r["key"]: json.loads(r["value"]) for r in
                self.db.query("SELECT key, value FROM model_settings "
                              "ORDER BY key")}

    # -- durable event log (bus → logs/messages/actions rows) --------------

    def attach_bus(self, bus: EventBus) -> Subscription:
        """Tail every broadcast into the durable tables — the reference's
        Ecto inserts for logs/messages/actions, decoupled from agents."""
        self._bus_sub = bus.subscribe("*", self._on_event)
        return self._bus_sub

    def _on_event(self, topic: str, event: dict) -> None:
        kind = event.get("event")
        ts = event.get("ts", time.time())
        if kind in ("log", "decision", "raw_response"):
            data = {k: v for k, v in event.items()
                    if k not in ("event", "ts", "agent_id", "message",
                                 "level")}
            self.db.execute(
                "INSERT INTO logs (agent_id, level, message, data, ts) "
                "VALUES (?,?,?,?,?)",
                (event.get("agent_id"), event.get("level", kind),
                 event.get("message", kind),
                 json.dumps(data, default=str), ts))
        elif kind == "task_message":
            m = event.get("message", {})
            self.db.execute(
                "INSERT INTO messages (task_id, sender, content, "
                "message_type, targets, ts) VALUES (?,?,?,?,?,?)",
                (event.get("task_id"), m.get("from"),
                 json.dumps(m.get("content"), default=str),
                 m.get("message_type"),
                 json.dumps(m.get("targets", []), default=str), ts))
        elif kind == "action_started":
            self.db.execute(
                "INSERT OR REPLACE INTO actions (action_id, agent_id, "
                "action, params, status, started_at) VALUES (?,?,?,?,?,?)",
                (event.get("action_id"), event.get("agent_id"),
                 event.get("action"),
                 json.dumps(event.get("params", {}), default=str),
                 "running", ts))
        elif kind == "action_completed":
            self.db.execute(
                "UPDATE actions SET status=?, completed_at=? "
                "WHERE action_id=?",
                (event.get("status", "ok"), ts, event.get("action_id")))
        elif kind == "consensus_audit":
            # Per-decide audit record (consensus/quality.py):
            # durable alongside the decision logs, keyed by task for
            # /api/consensus?task_id=… deep history (the EventHistory
            # ring covers the live tail).
            self.db.execute(
                "INSERT INTO consensus_audit "
                "(task_id, agent_id, decide_id, ts, record) "
                "VALUES (?,?,?,?,?)",
                (event.get("task_id"), event.get("agent_id"),
                 event.get("decide_id"), ts,
                 json.dumps(event, default=str)))

    def detach_bus(self) -> None:
        if self._bus_sub is not None:
            self._bus_sub.unsubscribe()
            self._bus_sub = None


def new_task_id() -> str:
    return f"task-{uuid.uuid4().hex[:12]}"
