"""SQLite database: schema + thread-safe access + at-rest encryption.

Schema mirrors the reference's migration set (reference
priv/repo/migrations/: agents 20251001000001, actions 20250122000002,
secret_usage 20251025014144, model_settings 20251205064131, profiles
20260105050308) with Postgres types mapped to SQLite: JSONB → JSON text,
decimal(12,10) → text (Decimal round-trips through str), binary_id → hex.

Encryption: secret/credential values encrypt with AES-256-GCM, key from
``QUORACLE_ENCRYPTION_KEY`` (the reference's Cloak vault +
CLOAK_ENCRYPTION_KEY, reference lib/quoracle/vault.ex, application.ex:25-36).
Without the env var the store runs degraded (plaintext + warning), exactly
like the reference boots without its key.

The PyTorch port's copy of ``quoracle_tpu/persistence/db.py``: the
schema is the JAX package's, column for column, so either package reads
a file the other wrote, and a value either ``Vault`` encrypted with the
same key decrypts in the other. ``cryptography`` is imported only when a
key is given, and without it the vault runs degraded with the JAX
warning.
"""

from __future__ import annotations

import base64
import hashlib
import logging
import os
import sqlite3
import threading
from typing import Any, Iterable, Optional

logger = logging.getLogger(__name__)

SCHEMA = """
CREATE TABLE IF NOT EXISTS tasks (
    id TEXT PRIMARY KEY,
    status TEXT NOT NULL DEFAULT 'running',   -- running | pausing | paused | completed
    task_fields TEXT NOT NULL DEFAULT '{}',
    agent_fields TEXT NOT NULL DEFAULT '{}',
    created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS agents (
    agent_id TEXT PRIMARY KEY,
    task_id TEXT NOT NULL,
    parent_id TEXT,
    status TEXT NOT NULL DEFAULT 'running',
    config TEXT NOT NULL DEFAULT '{}',
    ace_state TEXT NOT NULL DEFAULT '{}',     -- model_histories + lessons + states
    created_at REAL, updated_at REAL
);
CREATE INDEX IF NOT EXISTS idx_agents_task ON agents(task_id);
CREATE TABLE IF NOT EXISTS logs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    agent_id TEXT, level TEXT, message TEXT, data TEXT, ts REAL
);
CREATE INDEX IF NOT EXISTS idx_logs_agent ON logs(agent_id);
CREATE TABLE IF NOT EXISTS messages (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    task_id TEXT, sender TEXT, content TEXT, message_type TEXT,
    targets TEXT, ts REAL
);
CREATE INDEX IF NOT EXISTS idx_messages_task ON messages(task_id);
CREATE TABLE IF NOT EXISTS actions (
    action_id TEXT PRIMARY KEY,
    agent_id TEXT, action TEXT, params TEXT,
    status TEXT, result TEXT,
    started_at REAL, completed_at REAL
);
CREATE INDEX IF NOT EXISTS idx_actions_agent ON actions(agent_id);
CREATE TABLE IF NOT EXISTS agent_costs (
    id TEXT PRIMARY KEY,
    agent_id TEXT, task_id TEXT,
    amount TEXT, cost_type TEXT, model_spec TEXT,
    input_tokens INTEGER, output_tokens INTEGER,
    description TEXT, ts REAL
);
CREATE INDEX IF NOT EXISTS idx_costs_agent ON agent_costs(agent_id);
CREATE TABLE IF NOT EXISTS secrets (
    name TEXT PRIMARY KEY,
    value BLOB NOT NULL,               -- AES-256-GCM (nonce || ciphertext)
    encrypted INTEGER NOT NULL DEFAULT 0,
    description TEXT, created_by TEXT, created_at REAL
);
CREATE TABLE IF NOT EXISTS secret_usage (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    secret_name TEXT, agent_id TEXT, action TEXT, ts REAL
);
CREATE TABLE IF NOT EXISTS credentials (
    id TEXT PRIMARY KEY,
    model_spec TEXT, data BLOB, encrypted INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS profiles (
    name TEXT PRIMARY KEY,
    data TEXT NOT NULL DEFAULT '{}'    -- model_pool, capability_groups,
                                       -- max_refinement_rounds, force_reflection
);
CREATE TABLE IF NOT EXISTS model_settings (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL DEFAULT 'null' -- JSON
);
CREATE TABLE IF NOT EXISTS consensus_audit (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    task_id TEXT, agent_id TEXT, decide_id TEXT,
    ts REAL,
    record TEXT NOT NULL DEFAULT '{}'  -- the full audit record (JSON):
                                       -- member->cluster map, winner,
                                       -- entropy, margin, failures by kind
);
CREATE INDEX IF NOT EXISTS idx_consensus_audit_task
    ON consensus_audit(task_id);
"""


class Vault:
    """AES-256-GCM envelope for at-rest values (reference Cloak vault)."""

    def __init__(self, key: Optional[str] = None):
        raw = key if key is not None else os.environ.get(
            "QUORACLE_ENCRYPTION_KEY")
        self._aes = None
        if raw:
            try:
                from cryptography.hazmat.primitives.ciphers.aead import AESGCM
                self._aes = AESGCM(self._derive(raw))
            except ImportError:
                logger.warning("cryptography unavailable; secrets stored "
                               "in plaintext (degraded mode)")
        else:
            logger.warning("QUORACLE_ENCRYPTION_KEY not set; secrets stored "
                           "in plaintext (degraded mode)")

    @staticmethod
    def _derive(raw: str) -> bytes:
        try:
            decoded = base64.b64decode(raw, validate=True)
            if len(decoded) == 32:
                return decoded
        except Exception:
            pass
        return hashlib.sha256(raw.encode()).digest()

    @property
    def active(self) -> bool:
        return self._aes is not None

    def encrypt(self, plaintext: str) -> tuple[bytes, bool]:
        """Returns (blob, encrypted?)."""
        if self._aes is None:
            return plaintext.encode(), False
        nonce = os.urandom(12)
        return nonce + self._aes.encrypt(nonce, plaintext.encode(), None), True

    def decrypt(self, blob: bytes, encrypted: bool) -> str:
        if not encrypted:
            return bytes(blob).decode()
        if self._aes is None:
            raise RuntimeError("encrypted value but no encryption key loaded")
        blob = bytes(blob)
        return self._aes.decrypt(blob[:12], blob[12:], None).decode()


class Database:
    """One SQLite connection, serialized by a lock. Writes come from the
    event loop and executor threads; SQLite itself is fast enough at this
    event rate that a single serialized connection beats connection-pool
    complexity. WAL mode keeps readers unblocked."""

    def __init__(self, path: str = ":memory:",
                 encryption_key: Optional[str] = None):
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.Lock()
        self.vault = Vault(encryption_key)
        with self._lock:
            if path != ":memory:":
                self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA foreign_keys=ON")
            self._conn.executescript(SCHEMA)
            self._conn.commit()

    def execute(self, sql: str, params: Iterable[Any] = ()) -> None:
        with self._lock:
            self._conn.execute(sql, tuple(params))
            self._conn.commit()

    def executemany(self, sql: str, rows: list[tuple]) -> None:
        with self._lock:
            self._conn.executemany(sql, rows)
            self._conn.commit()

    def query(self, sql: str, params: Iterable[Any] = ()) -> list[sqlite3.Row]:
        with self._lock:
            return self._conn.execute(sql, tuple(params)).fetchall()

    def query_one(self, sql: str,
                  params: Iterable[Any] = ()) -> Optional[sqlite3.Row]:
        rows = self.query(sql, params)
        return rows[0] if rows else None

    def close(self) -> None:
        with self._lock:
            self._conn.close()
