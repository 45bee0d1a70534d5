"""Secret templates + output scrubbing.

Parity with the reference's Security.SecretResolver and
Security.OutputScrubber (reference lib/quoracle/security/secret_resolver.ex:13-37,
output_scrubber.ex:9-38): agents reference secrets as ``{{SECRET:name}}`` in
action params; values are substituted just before execution and scrubbed out
of action results before any model sees them.

The PyTorch port's copy of ``quoracle_tpu/infra/security.py``.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import secrets as _pysecrets
import threading
import time
from typing import Any, Callable, Mapping, Optional

logger = logging.getLogger(__name__)

SECRET_RE = re.compile(r"\{\{SECRET:([A-Za-z0-9_\-\.]+)\}\}")
MIN_SCRUB_LEN = 8  # reference output_scrubber.ex:9-38 — short values stay


def resolve_secrets(params: Any, lookup: Callable[[str], Optional[str]],
                    _used: Optional[set] = None) -> tuple[Any, set[str]]:
    """Recursively substitute ``{{SECRET:name}}`` templates in params.

    Missing secrets are left literal with a warning (reference
    secret_resolver.ex:13-37 — an agent typo must not crash the action; the
    literal template in the output makes the mistake visible). Returns
    (resolved_params, set of secret names used) so callers can audit usage.
    """
    used: set[str] = set() if _used is None else _used

    def sub(text: str) -> str:
        def repl(m: re.Match) -> str:
            name = m.group(1)
            value = lookup(name)
            if value is None:
                logger.warning("secret %r not found; leaving template literal", name)
                return m.group(0)
            used.add(name)
            return value
        return SECRET_RE.sub(repl, text)

    def walk(node: Any) -> Any:
        if isinstance(node, str):
            return sub(node)
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node

    return walk(params), used


def scrub_output(result: Any, secrets: Mapping[str, str]) -> Any:
    """Replace secret *values* with ``[REDACTED:name]`` recursively in an
    action result, longest value first so overlapping secrets can't leave a
    recoverable suffix (reference output_scrubber.ex:9-38). Values shorter
    than 8 chars are skipped — scrubbing "a" would shred unrelated text.
    Applied at the router boundary before results enter model history
    (reference actions/router.ex:324-331)."""
    pairs = sorted(
        ((name, val) for name, val in secrets.items()
         if isinstance(val, str) and len(val) >= MIN_SCRUB_LEN),
        key=lambda nv: len(nv[1]), reverse=True)
    if not pairs:
        return result

    def scrub_text(text: str) -> str:
        for name, val in pairs:
            if val in text:
                text = text.replace(val, f"[REDACTED:{name}]")
        return text

    def walk(node: Any) -> Any:
        if isinstance(node, str):
            return scrub_text(node)
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node

    return walk(result)


# ---------------------------------------------------------------------------
# Secret store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Secret:
    name: str
    value: str
    description: str = ""
    created_by: Optional[str] = None
    created_at: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class SecretAccess:
    """Audit-trail row (reference audit/secret_usage.ex, secret_usage table
    migrations/20251025014144)."""
    secret_name: str
    agent_id: str
    action: str
    ts: float = dataclasses.field(default_factory=time.time)


class SecretStore:
    """Named secrets + usage audit. The reference encrypts values at rest
    with Cloak AES-256-GCM (reference lib/quoracle/vault.ex) — here the
    at-rest encryption belongs to the persistence layer; this in-memory store
    holds plaintext for the resolver and never hands values to models
    (scrub_output at the router boundary)."""

    def __init__(self) -> None:
        self._secrets: dict[str, Secret] = {}
        self._audit: list[SecretAccess] = []
        self._lock = threading.Lock()

    def put(self, name: str, value: str, description: str = "",
            created_by: Optional[str] = None) -> Secret:
        s = Secret(name, value, description, created_by)
        with self._lock:
            self._secrets[name] = s
        return s

    CHARSETS = {
        "alphanumeric": "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                        "abcdefghijklmnopqrstuvwxyz0123456789",
        "hex": "0123456789abcdef",
        "base64": "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                  "abcdefghijklmnopqrstuvwxyz0123456789+/",
        "ascii": "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "abcdefghijklmnopqrstuvwxyz0123456789"
                 "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~",
    }

    def generate(self, name: str, *, length: int = 32,
                 charset: str = "alphanumeric", description: str = "",
                 created_by: Optional[str] = None) -> Secret:
        """Generate a random secret (reference actions/generate_secret.ex —
        length + charset params per the action schema)."""
        alphabet = self.CHARSETS[charset]
        value = "".join(_pysecrets.choice(alphabet) for _ in range(length))
        return self.put(name, value, description, created_by)

    def lookup(self, name: str, *, agent_id: str = "",
               action: str = "") -> Optional[str]:
        with self._lock:
            s = self._secrets.get(name)
            if s is not None and agent_id:
                self._audit.append(SecretAccess(name, agent_id, action))
            return s.value if s else None

    def search(self, query: str = "") -> list[dict]:
        """Name/description search; values are never returned (reference
        actions/search_secrets.ex returns metadata only)."""
        q = query.lower()
        with self._lock:
            return [{"name": s.name, "description": s.description,
                     "created_by": s.created_by, "created_at": s.created_at}
                    for s in self._secrets.values()
                    if q in s.name.lower() or q in s.description.lower()]

    def delete(self, name: str) -> bool:
        with self._lock:
            return self._secrets.pop(name, None) is not None

    def values(self) -> dict[str, str]:
        """name -> value snapshot for scrub_output."""
        with self._lock:
            return {n: s.value for n, s in self._secrets.items()}

    def audit_log(self) -> list[SecretAccess]:
        with self._lock:
            return list(self._audit)
