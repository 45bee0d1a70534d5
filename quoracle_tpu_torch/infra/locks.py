"""Named locks of the PyTorch port: the part of the JAX package's lock
sanitizer that the liveness plane (infra/introspect.py) reads.

:func:`named_lock` returns a :class:`TrackedLock`: a plain
``threading.Lock`` (or ``RLock``) with a name. Two observations ride it:

* **Contended waits.** With :data:`LOCK_WAIT_HOOK` set (introspect sets
  it while its plane is on), a blocking acquire first tries without
  blocking; only when that fails are the two clock reads paid, and the
  hook gets ``(name, waited_ns)``. The uncontended path is one extra
  try-acquire; with no hook it is the raw acquire.
* **Holders.** The lock keeps the name of the thread that holds it, so
  :func:`holders` can list who holds what while a stage is wedged (the
  stall detector's incident bundle).

No rank checking: the port declares no lock hierarchy.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Optional

# Contended-acquire wait hook: ``fn(lock_name, waited_ns)``. It runs
# while the caller may hold other locks, so it must take none.
LOCK_WAIT_HOOK: Optional[Any] = None

_ALL: "weakref.WeakSet[TrackedLock]" = weakref.WeakSet()
_ALL_LOCK = threading.Lock()


class TrackedLock:
    """A named Lock/RLock that times contended acquires and records its
    holder's thread."""

    __slots__ = ("_base", "name", "_holder", "_depth", "__weakref__")

    def __init__(self, name: str, base: Any):
        self._base = base
        self.name = name
        self._holder: Optional[tuple] = None    # (thread name, ident)
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        hook = LOCK_WAIT_HOOK
        if hook is None or not blocking:
            got = self._base.acquire(blocking, timeout)
        elif self._base.acquire(False):
            got = True
        else:
            t0 = time.monotonic_ns()
            got = self._base.acquire(True, timeout)
            try:
                hook(self.name, time.monotonic_ns() - t0)
            except Exception:             # noqa: BLE001 — telemetry only
                pass
        if got:
            if self._depth == 0:
                t = threading.current_thread()
                self._holder = (t.name, t.ident)
            self._depth += 1
        return got

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            self._holder = None
        self._base.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.name!r}>"


def named_lock(name: str, *, rlock: bool = False) -> TrackedLock:
    """A lock named ``name``; ``rlock=True`` makes it re-entrant."""
    base = threading.RLock() if rlock else threading.Lock()
    lock = TrackedLock(name, base)
    with _ALL_LOCK:
        _ALL.add(lock)
    return lock


def holders() -> dict:
    """Every thread's held named locks: ``thread-name:ident`` →
    ``[(lock name, depth), ...]``. Best effort without stopping the
    world; threads holding nothing are omitted."""
    with _ALL_LOCK:
        locks = list(_ALL)
    out: dict = {}
    for lk in locks:
        h, depth = lk._holder, lk._depth
        if h is None or depth <= 0:
            continue
        out.setdefault(f"{h[0]}:{h[1]}", []).append((lk.name, depth))
    return {k: sorted(v) for k, v in sorted(out.items())}
