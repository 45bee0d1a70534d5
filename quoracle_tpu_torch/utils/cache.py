"""SHA-256-keyed LRU cache with TTL (port of ``quoracle_tpu/utils/cache.py``).

SHA-256 text keys, 1h TTL, 1000-entry cap (reference
lib/quoracle/models/embeddings.ex:23-25, 65-95), as a plain object handed
explicitly to its users. The port's own copy, with a plain
``threading.Lock`` where the JAX package takes a lock-order-checked one.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional


def text_key(text: str, namespace: str = "") -> str:
    return hashlib.sha256((namespace + "\x00" + text).encode("utf-8")).hexdigest()


class TTLCache:
    """Thread-safe LRU with per-entry TTL. clock is injectable for tests."""

    def __init__(self, max_entries: int = 1000, ttl_s: float = 3600.0,
                 clock: Callable[[], float] = time.monotonic):
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self._clock = clock
        self._data: OrderedDict[str, tuple[float, Any]] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            item = self._data.get(key)
            if item is None:
                self.misses += 1
                return None
            ts, value = item
            if self._clock() - ts > self.ttl_s:
                del self._data[key]
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = (self._clock(), value)
            self._data.move_to_end(key)
            while len(self._data) > self.max_entries:
                self._data.popitem(last=False)

    def __len__(self) -> int:
        return len(self._data)
