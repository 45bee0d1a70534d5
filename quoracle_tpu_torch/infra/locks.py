"""Named, ranked locks of the PyTorch port: the port's copy of the JAX
package's lock sanitizer (``quoracle_tpu/analysis/lockdep.py``), with the
same declared hierarchy and one lock of the port's own (``engine.run``).

:func:`named_lock` returns a :class:`TrackedLock`: a plain
``threading.Lock`` (or ``RLock``) with a name and the rank its name has in
:data:`HIERARCHY`. An unknown name raises at construction, so the table
stays the one authority. Three observations ride the lock:

* **Contended waits.** With :data:`LOCK_WAIT_HOOK` set (introspect sets
  it while its plane is on), a blocking acquire first tries without
  blocking; only when that fails are the two clock reads paid, and the
  hook gets ``(name, waited_ns)``. The uncontended path is one extra
  try-acquire; with no hook it is the raw acquire.
* **Holders.** The lock keeps the name of the thread that holds it, so
  :func:`holders` can list who holds what while a stage is wedged (the
  stall detector's incident bundle).
* **Lock order**, while the sanitizer is on (``QUORACLE_LOCKDEP=1`` at
  import, or :func:`enable`): a thread that blocking-acquires a lock
  whose rank is not strictly greater than every lock it already holds
  commits a LOCK-ORDER INVERSION, the precondition of an ABBA deadlock.
  :data:`LOCKDEP` records it (and the flight recorder's
  ``lockdep_inversion`` and ``quoracle_lockdep_inversions_total`` book
  its first sighting); the chaos plane's ``lockdep_clean`` invariant
  drains the ledger. As in the JAX sanitizer, try-acquires and
  re-entrant re-acquisitions are exempt, and the check never raises.
  Off, it costs one attribute read an acquire.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import weakref
from typing import Any, Optional

# The declared hierarchy, the JAX package's: (name, rank, coarse).
# Outermost (lowest rank) first; a thread holding rank r may
# blocking-acquire only ranks > r. ``coarse`` marks locks that serialize
# device work by design (metadata; ranks still apply).
HIERARCHY: tuple = (
    ("train.promote",   2, False),  # promotion orchestrator ledger
    ("sim.replay",      3, False),  # fleet simulator status board
    # -- cluster plane: the router sits in FRONT of every replica's
    #    batcher, so its locks release before any replica-internal lock
    ("cluster.plane",   4, False),  # ClusterPlane replica table / seq
    ("fleet",           5, False),  # FleetController ledger + policy
                                    # state: pure bookkeeping, drains run
                                    # outside it
    ("router",          6, False),  # ClusterRouter affinity + liveness
    ("fabric.plane",    7, False),  # cross-host front door's peer table
    ("handoff",         8, False),  # KVHandoff in-flight envelope ledger
    ("fabric.transport", 9, True),  # one wire request per transport
    # -- admission / scheduling plane -----------------------------------
    ("batcher",        10, False),  # ContinuousBatcher queue/close lock
    ("qos.admission",  12, False),  # AdmissionController tenant table
    ("qos.signals",    14, False),  # AdmissionController cached signals
    ("qos.queue",      16, False),  # Fifo/WeightedFair policy queues
    ("qos.slo",        18, False),  # SLOTracker EWMA tail state
    ("qos.bucket",     19, False),  # per-tenant TokenBucket
    # -- pool-member serialization --------------------------------------
    ("member.serve",   20, True),   # baton batcher: device work under it
    ("member.pending", 21, False),  # baton pending-submission queue
    ("spec.decoder",   22, True),   # batch-1 speculative decoder
    ("spec.adaptive",  23, False),  # BatchedSpeculator adaptive-K state
    # -- session plane --------------------------------------------------
    ("engine.paged",   25, True),   # GenerateEngine pool entry
    ("engine.run",     26, True),   # the port's GenerateEngine device run
                                    # and its torch.Generator (the JAX
                                    # engine only splits a key, under
                                    # engine.rng, 43)
    ("session.store",  30, False),  # SessionStore pages/refs/radix tree
    # -- tier plane -----------------------------------------------------
    ("fabric.prefixd", 32, True),   # fleet prefix-service client
    ("tier.disk",      35, False),  # DiskPrefixStore size accounting
    # -- cache plane ----------------------------------------------------
    ("cache.grammar",  40, False),  # grammar-table cache
    ("cache.compile",  41, False),  # CompileRegistry ledger
    ("cache.lru",      42, False),  # utils/cache.TTLCache
    ("engine.rng",     43, False),  # engine RNG split
    ("native.build",   45, True),   # native toolchain builds
    ("train.capture",  46, True),   # replay capture store
    ("treeobs",        47, False),  # session-graph registry
    # -- chaos plane: fire() runs under store/tier locks (30/35) and
    #    records to flight/metrics (58/60) ------------------------------
    ("chaos.plan",     48, False),  # ChaosPlane armed plan + fire ledger
    # -- observability plane (leaves) -----------------------------------
    ("introspect",     49, False),  # liveness & hotspot plane
    ("quality",        50, False),  # consensus scorecards/drift
    ("quality.sinks",  51, False),  # quality sink list
    ("history",        52, False),  # EventHistory rings (outer of bus)
    ("bus",            53, False),  # EventBus subscriber table
    ("costobs",        54, False),  # chip-economics ledger
    ("tracer.sinks",   55, False),  # Tracer sink list
    ("fleetobs.spans", 56, False),  # fleetobs span ring
    ("fleetobs.incidents", 57, False),  # incident ledger
    ("flight",         58, False),  # flight-recorder ring
    ("metrics.registry", 59, False),  # MetricsRegistry name table
    ("metrics",        60, False),  # per-metric cells (innermost)
)

RANKS: dict = {name: rank for name, rank, _ in HIERARCHY}
COARSE: frozenset = frozenset(n for n, _, c in HIERARCHY if c)

# Contended-acquire wait hook: ``fn(lock_name, waited_ns)``. It runs
# while the caller may hold other locks, so it must take none.
LOCK_WAIT_HOOK: Optional[Any] = None

_ALL: "weakref.WeakSet[TrackedLock]" = weakref.WeakSet()
_ALL_LOCK = threading.Lock()


class _State:
    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = os.environ.get(
            "QUORACLE_LOCKDEP", "").strip().lower() not in (
                "", "0", "false", "off")


_STATE = _State()


def enabled() -> bool:
    return _STATE.enabled


def enable() -> None:
    """Turn the order check on for every lock in the process."""
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


def _caller() -> str:
    """First stack frame outside this module: the acquisition site."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    return "?" if f is None else f"{f.f_code.co_filename}:{f.f_lineno}"


class LockDep:
    """Per-thread held-lock stacks and the inversion ledger."""

    def __init__(self) -> None:
        self._tls = threading.local()
        self._lock = threading.Lock()          # guards the ledger only
        self._inversions: list[dict] = []
        self._seen: set = set()                # (held name, acquired)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_acquire(self, lock: "TrackedLock", blocking: bool) -> None:
        """Rank-check a blocking acquire BEFORE the primitive blocks, so
        an inversion is reported even when the interleaving that would
        deadlock does not happen this run."""
        stack = self._stack()
        if any(frame[0] is lock for frame in stack):
            return                              # re-entrant: exempt
        if blocking and not getattr(self._tls, "reporting", False):
            bad = [(f[1], f[2]) for f in stack if f[2] >= lock.rank]
            if bad:
                self._report(lock, bad, list(stack))

    def note_acquired(self, lock: "TrackedLock") -> None:
        stack = self._stack()
        for frame in stack:
            if frame[0] is lock:
                frame[3] += 1                   # re-entrant depth
                return
        stack.append([lock, lock.name, lock.rank, 1])

    def note_release(self, lock: "TrackedLock") -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is lock:
                stack[i][3] -= 1
                if stack[i][3] <= 0:
                    del stack[i]
                return

    def _report(self, lock: "TrackedLock", bad: list, held: list) -> None:
        key = (bad[-1][0], lock.name)
        with self._lock:
            first = key not in self._seen
            self._seen.add(key)
            event = {
                "ts": time.time(),
                "thread": threading.current_thread().name,
                "acquiring": lock.name,
                "rank": lock.rank,
                "held": [(f[1], f[2]) for f in held],
                "violates": bad,
                "site": _caller(),
            }
            self._inversions.append(event)
        if not first:
            return
        # flight + metrics outside the ledger lock, recursion guarded:
        # they take their own ranked locks
        self._tls.reporting = True
        try:
            from quoracle_tpu_torch.infra.flightrec import FLIGHT
            from quoracle_tpu_torch.infra.telemetry import LOCKDEP_INVERSIONS
            FLIGHT.record("lockdep_inversion", **{
                k: v for k, v in event.items() if k != "ts"})
            LOCKDEP_INVERSIONS.inc(acquiring=lock.name, held=bad[-1][0])
        except Exception:               # noqa: BLE001 — the sanitizer
            pass                        # never takes serving down
        finally:
            self._tls.reporting = False

    def inversions(self) -> list[dict]:
        with self._lock:
            return list(self._inversions)

    def drain(self) -> list[dict]:
        """Return and clear the inversion ledger."""
        with self._lock:
            out, self._inversions = self._inversions, []
            self._seen.clear()
            return out

    def held(self) -> list[tuple]:
        """This thread's held stack as (name, rank, depth) tuples."""
        return [(f[1], f[2], f[3]) for f in self._stack()]


LOCKDEP = LockDep()


class TrackedLock:
    """A named, ranked Lock/RLock that times contended acquires, records
    its holder's thread and, with the sanitizer on, checks lock order."""

    __slots__ = ("_base", "name", "rank", "_holder", "_depth",
                 "__weakref__")

    def __init__(self, name: str, base: Any, rank: int = 0):
        self._base = base
        self.name = name
        self.rank = rank
        self._holder: Optional[tuple] = None    # (thread name, ident)
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        checked = _STATE.enabled
        if checked:
            LOCKDEP.note_acquire(self, blocking)
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
            if checked:
                LOCKDEP.note_acquired(self)
        return got

    def release(self) -> None:
        if _STATE.enabled:
            LOCKDEP.note_release(self)
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
        return f"<TrackedLock {self.name!r} rank={self.rank}>"


def named_lock(name: str, *, rlock: bool = False) -> TrackedLock:
    """A lock named ``name``, which must appear in :data:`HIERARCHY`;
    ``rlock=True`` makes it re-entrant."""
    try:
        rank = RANKS[name]
    except KeyError:
        raise ValueError(
            f"lock name {name!r} is not in the declared hierarchy "
            f"(infra/locks.HIERARCHY); add it with a rank before use"
        ) from None
    base = threading.RLock() if rlock else threading.Lock()
    lock = TrackedLock(name, base, rank)
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
