"""Session-graph observability of the PyTorch port (the port's copy of
``quoracle_tpu/infra/treeobs.py``): the agent-tree plane.

The product's real workload is recursive agent trees, but every plane
built so far — traces, chip ledgers, wait states,
QoS — sees flat sessions with at most a depth-derived
priority class. This module is the per-session → per-tree bookkeeping
refactor, shipped FIRST as a strictly read-only observability plane so
the later scheduler work (gang placement, spawn-ahead prefetch,
subtree shedding) actuates signals that are already measured,
federated, and invariant-checked. Four pieces:

* **Lineage propagation** — a compact :class:`TreeContext` (tree_id =
  root task id, this node's id, parent node id, depth, spawn ordinal)
  is stamped at agent spawn and rides ``QueryRequest`` → batcher rows
  → the HandoffEnvelope wire header and fabric RPCs exactly like
  the ``TraceContext``: a plain dict under a ``tree`` key that
  un-upgraded peers ignore by construction. It survives hibernation,
  handoff, drain/migration, and peer death because it travels WITH the
  row/envelope, never in process state.

* **TreeRegistry** — O(1)-per-node lineage records (spawn registers,
  parent lookup is a dict hit) replacing the agent-registry depth walk
  as the source of truth for depth (``depth_of``), plus per-node
  integer rollup counters for what the existing planes already
  measure: costobs chip-ns and tokens per decide, wait-state
  ns, consensus entropy/margin/dissent, spawn fan-out per depth.
  Completed trees age out of a bounded LRU.

* **Subtree rollups + critical path** — :func:`tree_view` merges the
  per-peer node aggregates (each peer charges ONLY its local registry;
  the front door federates via the MSG_OBS ``tree`` op) and computes
  recursive subtree totals with an EXACT conservation contract:

      sum over children + self == subtree total == tree total

  for chip-ns, tokens, and wait-ns — integer arithmetic, asserted,
  never approximate. Each node's attributed cost (chip_ns + wait_ns)
  feeds the critical path: the dependent spawn chain that bounds the
  tree's completion, so ``/api/tree?tree_id=…`` answers "which subtree
  is the bottleneck".

* **Observed-only propagation signals** — inherited deadlines / token
  budgets recorded per node, ``tree_budget_overrun`` flight event when
  a subtree overspends its inherited budget, orphan flagging when a
  node's parent record is missing from the assembled view (a crashed
  peer's registry died with it — the node is FLAGGED, never silently
  unparented), and per-window fan-out priors exported read-only into
  ``FleetSignals``.

Everything here is measurement: no RNG, no device work, no effect on
row content — temp-0 outputs are bit-identical with the plane on or
off (``QUORACLE_TREEOBS=0`` disables it entirely), the equality gate
shared with costobs/introspect. Metric/flight emission happens strictly
OUTSIDE the plane's lock (the costobs discipline).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Optional, Sequence

from quoracle_tpu_torch.infra.locks import named_lock

# ---------------------------------------------------------------------------
# Enablement
# ---------------------------------------------------------------------------


def _env_enabled() -> bool:
    return os.environ.get("QUORACLE_TREEOBS", "1").strip().lower() \
        not in ("0", "false", "off")


class _State:
    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = _env_enabled()


_STATE = _State()


def enabled() -> bool:
    return _STATE.enabled


def enable() -> None:
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


# ---------------------------------------------------------------------------
# TreeContext — the lineage stamp that crosses process boundaries
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TreeContext:
    """The five lineage fields that ride every request row and wire
    header. ``tree_id`` is the ROOT task id (stable across the whole
    tree); ``node_id`` is this agent's id; depth/ordinal are fixed at
    spawn so a charge site on a remote peer can reconstruct the node's
    position without the spawn-side registry."""

    tree_id: str
    node_id: str
    parent_id: Optional[str] = None
    depth: int = 0
    ordinal: int = 0

    def to_dict(self) -> dict:
        return {"tree_id": self.tree_id, "node_id": self.node_id,
                "parent_id": self.parent_id, "depth": self.depth,
                "ordinal": self.ordinal}

    @classmethod
    def from_dict(cls, d: Any) -> Optional["TreeContext"]:
        """None on anything malformed — a foreign or un-upgraded peer's
        payload must never make lineage plumbing raise."""
        if not isinstance(d, dict):
            return None
        tid, nid = d.get("tree_id"), d.get("node_id")
        if not (isinstance(tid, str) and tid
                and isinstance(nid, str) and nid):
            return None
        pid = d.get("parent_id")
        if pid is not None and not isinstance(pid, str):
            return None
        try:
            depth = int(d.get("depth", 0))
            ordinal = int(d.get("ordinal", 0))
        except (TypeError, ValueError):
            return None
        return cls(tree_id=tid, node_id=nid, parent_id=pid,
                   depth=max(0, depth), ordinal=max(0, ordinal))


_TLS = threading.local()


def current() -> Optional[TreeContext]:
    """The calling thread's bound tree context (the stamp handoff
    export and outbound RPCs pick up), or None outside any binding."""
    return getattr(_TLS, "ctx", None)


@contextmanager
def bind(ctx: Optional[TreeContext]):
    """Bind ``ctx`` on this thread for the block. ``None`` leaves the
    current binding untouched (the ``fleetobs.bind_remote`` contract:
    a payload without a tree stamp must not erase the local one)."""
    if ctx is None:
        yield
        return
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = ctx
    try:
        yield
    finally:
        _TLS.ctx = prev


# ---------------------------------------------------------------------------
# Node records
# ---------------------------------------------------------------------------

_COUNTER_FIELDS = ("chip_ns", "tokens", "wait_ns", "decides", "dissents",
                   "quality_n")


class _Node:
    """One agent-tree node's record + integer rollup counters. Lives
    under the registry lock; serialized by :meth:`as_dict`."""

    __slots__ = ("node_id", "parent_id", "tree_id", "depth", "ordinal",
                 "implicit", "completed", "deadline_ms", "token_budget",
                 "chip_ns", "tokens", "wait_ns", "waits", "decides",
                 "entropy_sum", "margin_sum", "dissents", "quality_n",
                 "children", "subtree_tokens", "overrun_fired")

    def __init__(self, node_id: str, parent_id: Optional[str],
                 tree_id: str, depth: int, ordinal: int,
                 implicit: bool = False,
                 deadline_ms: Optional[int] = None,
                 token_budget: Optional[int] = None):
        self.node_id = node_id
        self.parent_id = parent_id
        self.tree_id = tree_id
        self.depth = depth
        self.ordinal = ordinal
        self.implicit = implicit          # charge-side record (no spawn)
        self.completed = False
        self.deadline_ms = deadline_ms    # inherited when the spawn
        self.token_budget = token_budget  # carried none (observed only)
        self.chip_ns = 0
        self.tokens = 0
        self.wait_ns = 0
        self.waits: dict = {}             # wait state -> int ns
        self.decides = 0
        self.entropy_sum = 0.0
        self.margin_sum = 0.0
        self.dissents = 0
        self.quality_n = 0
        self.children: list = []          # node ids, spawn order
        # Incrementally-maintained subtree token spend (ancestor walk at
        # charge time) — LOCAL to this registry, used only for the
        # budget-overrun tripwire. The federated view recomputes subtree
        # totals from node self-values (the conservation contract).
        self.subtree_tokens = 0
        self.overrun_fired = False

    def ctx(self) -> TreeContext:
        return TreeContext(tree_id=self.tree_id, node_id=self.node_id,
                           parent_id=self.parent_id, depth=self.depth,
                           ordinal=self.ordinal)

    def as_dict(self) -> dict:
        return {
            "node_id": self.node_id, "parent_id": self.parent_id,
            "tree_id": self.tree_id, "depth": self.depth,
            "ordinal": self.ordinal, "implicit": self.implicit,
            "completed": self.completed,
            "deadline_ms": self.deadline_ms,
            "token_budget": self.token_budget,
            "chip_ns": self.chip_ns, "tokens": self.tokens,
            "wait_ns": self.wait_ns, "waits": dict(self.waits),
            "decides": self.decides,
            "entropy_sum": self.entropy_sum,
            "margin_sum": self.margin_sum,
            "dissents": self.dissents, "quality_n": self.quality_n,
        }


# ---------------------------------------------------------------------------
# TreeRegistry
# ---------------------------------------------------------------------------

_REGISTRY_SEQ = itertools.count()


class TreeRegistry:
    """All live + recently-completed trees this process knows about.

    O(1) per operation: spawn registration is a dict insert with a
    parent dict hit (depth = parent.depth + 1 — no registry walk);
    ``depth_of`` is a single lookup, which is what lets the QoS
    depth→class mapping drop its per-decide-tick agent-registry walk.
    Completed trees move into a bounded LRU (oldest evicted) so a
    long-lived server's memory stays flat.

    ``registry_id`` is process-unique: the front door's federated merge
    dedups payloads by it, so loopback peers sharing one process (and
    therefore one registry) are counted exactly once, while real remote
    peers (distinct registries) are summed.
    """

    def __init__(self, max_done_trees: int = 128):
        self._lock = named_lock("treeobs")
        self.registry_id = f"{os.getpid():x}.{next(_REGISTRY_SEQ):x}"
        self.max_done_trees = max_done_trees
        # tree_id -> {node_id: _Node}; OrderedDict gives LRU order for
        # completed trees (move_to_end on completion).
        self._trees: "OrderedDict[str, dict]" = OrderedDict()
        self._done: set = set()           # tree ids fully completed
        self._by_node: dict = {}          # node_id -> _Node (O(1) depth)
        self._orphan_fired: set = set()   # (tree_id, node_id)

    # -- spawn / completion ----------------------------------------------

    def register_spawn(self, node_id: str, parent_id: Optional[str] = None,
                       tree_id: Optional[str] = None,
                       deadline_ms: Optional[int] = None,
                       token_budget: Optional[int] = None,
                       ) -> Optional[TreeContext]:
        """Register one spawned agent; returns its portable context.
        Depth and tree id derive from the parent's record (O(1)); a
        root (no parent) starts a new tree under ``tree_id`` (usually
        the task id) or its own node id. Idempotent — re-registering a
        known node returns the existing context. None when the plane is
        disabled."""
        if not _STATE.enabled:
            return None
        evicted, metrics = None, []
        with self._lock:
            node = self._by_node.get(node_id)
            if node is not None:
                return node.ctx()
            parent = self._by_node.get(parent_id) if parent_id else None
            if parent is not None:
                tid = parent.tree_id
                depth = parent.depth + 1
                ordinal = len(parent.children)
                parent.children.append(node_id)
                if deadline_ms is None:
                    deadline_ms = parent.deadline_ms
                if token_budget is None:
                    token_budget = parent.token_budget
            else:
                tid = tree_id or node_id
                depth, ordinal = 0, 0
            node = _Node(node_id, parent_id, tid, depth, ordinal,
                         deadline_ms=deadline_ms,
                         token_budget=token_budget)
            nodes = self._trees.get(tid)
            if nodes is None:
                nodes = self._trees[tid] = {}
            nodes[node_id] = node
            self._by_node[node_id] = node
            self._done.discard(tid)
            evicted = self._evict_locked()
            metrics.append(("spawn", depth))
        self._emit(metrics, evicted)
        return node.ctx()

    def complete_node(self, node_id: str) -> None:
        """Mark one node done; a tree whose every node is done moves to
        the completed-LRU (bounded; oldest evicted)."""
        if not _STATE.enabled:
            return
        evicted, metrics = None, []
        with self._lock:
            node = self._by_node.get(node_id)
            if node is None or node.completed:
                return
            node.completed = True
            metrics.append(("complete", node.depth))
            nodes = self._trees.get(node.tree_id)
            if nodes is not None and all(n.completed
                                         for n in nodes.values()):
                self._done.add(node.tree_id)
                self._trees.move_to_end(node.tree_id)
                evicted = self._evict_locked()
        self._emit(metrics, evicted)

    def _evict_locked(self) -> Optional[str]:
        """Drop the least-recently-completed tree past the LRU bound.
        Live trees are never evicted."""
        if len(self._done) <= self.max_done_trees:
            return None
        for tid in self._trees:
            if tid in self._done:
                for nid in self._trees[tid]:
                    self._by_node.pop(nid, None)
                del self._trees[tid]
                self._done.discard(tid)
                return tid
        return None

    def _emit(self, metrics: Sequence[tuple], evicted: Optional[str],
              overruns: Sequence[tuple] = ()) -> None:
        """All metric/flight emission, strictly outside the lock."""
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        from quoracle_tpu_torch.infra.telemetry import (
            TREE_BUDGET_OVERRUNS_TOTAL, TREE_DEPTH, TREE_NODES_TOTAL,
        )
        for kind, depth in metrics:
            if kind == "spawn":
                TREE_NODES_TOTAL.inc(event="spawned")
                TREE_DEPTH.observe(float(depth))
            elif kind == "complete":
                TREE_NODES_TOTAL.inc(event="completed")
        for tree_id, node_id, spent, budget in overruns:
            TREE_BUDGET_OVERRUNS_TOTAL.inc()
            FLIGHT.record("tree_budget_overrun", tree=tree_id,
                          node=node_id, spent_tokens=spent,
                          budget_tokens=budget)

    # -- lineage lookups --------------------------------------------------

    def depth_of(self, node_id: str) -> Optional[int]:
        """O(1) spawn depth for a live/retained node — the QoS
        depth→class read path; None when unknown
        (caller falls back to the agent-registry walk)."""
        if not _STATE.enabled:
            return None
        with self._lock:
            node = self._by_node.get(node_id)
            return None if node is None else node.depth

    def context_of(self, node_id: str) -> Optional[TreeContext]:
        with self._lock:
            node = self._by_node.get(node_id)
            return None if node is None else node.ctx()

    # -- charge sites -----------------------------------------------------

    def _ensure_locked(self, ctx: TreeContext) -> _Node:
        """Charge-side record: on a peer that never saw the spawn the
        context itself carries enough to place the node (implicit=True
        so census metrics count only real spawns)."""
        node = self._by_node.get(ctx.node_id)
        if node is None:
            node = _Node(ctx.node_id, ctx.parent_id, ctx.tree_id,
                         ctx.depth, ctx.ordinal, implicit=True)
            self._trees.setdefault(ctx.tree_id, {})[ctx.node_id] = node
            self._by_node[ctx.node_id] = node
            self._done.discard(ctx.tree_id)
            parent = self._by_node.get(ctx.parent_id) \
                if ctx.parent_id else None
            if parent is not None and ctx.node_id not in parent.children:
                parent.children.append(ctx.node_id)
        return node

    def charge_decide(self, tree: Any, chip_ms: float, tokens: int,
                      audit: Optional[dict] = None) -> None:
        """Book one consensus decide's measured chip time + committed
        tokens (and the quality audit's entropy/margin/dissent) to the
        node ``tree`` names. Exactly one node per decide — the
        conservation contract's unit of attribution. Also walks the
        LOCAL ancestor chain maintaining subtree token spend for the
        budget-overrun tripwire."""
        if not _STATE.enabled:
            return
        ctx = tree if isinstance(tree, TreeContext) \
            else TreeContext.from_dict(tree)
        if ctx is None:
            return
        chip_ns = max(0, int(round(float(chip_ms) * 1e6)))
        tokens = max(0, int(tokens))
        overruns: list = []
        with self._lock:
            node = self._ensure_locked(ctx)
            node.chip_ns += chip_ns
            node.tokens += tokens
            node.decides += 1
            if isinstance(audit, dict):
                ent, mar = audit.get("entropy_bits"), audit.get("margin")
                if isinstance(ent, (int, float)) \
                        and isinstance(mar, (int, float)):
                    node.entropy_sum += float(ent)
                    node.margin_sum += float(mar)
                    node.quality_n += 1
                if audit.get("dissent"):
                    node.dissents += 1
            cur, seen = node, set()
            while cur is not None and cur.node_id not in seen:
                seen.add(cur.node_id)
                cur.subtree_tokens += tokens
                if cur.token_budget is not None \
                        and cur.subtree_tokens > cur.token_budget \
                        and not cur.overrun_fired:
                    cur.overrun_fired = True
                    overruns.append((cur.tree_id, cur.node_id,
                                     cur.subtree_tokens,
                                     cur.token_budget))
                cur = self._by_node.get(cur.parent_id) \
                    if cur.parent_id else None
        if overruns:
            self._emit((), None, overruns)

    def charge_row_waits(self, tree: Any, closed: Any) -> None:
        """Book one retired batcher row's wait decomposition
        (``WaitClock.close()`` output — named waits sum EXACTLY to the
        row's wall) to the node the row's tree stamp names."""
        if not _STATE.enabled or not isinstance(closed, dict):
            return
        ctx = tree if isinstance(tree, TreeContext) \
            else TreeContext.from_dict(tree)
        if ctx is None:
            return
        waits = closed.get("waits_ns")
        if not isinstance(waits, dict):
            return
        with self._lock:
            node = self._ensure_locked(ctx)
            for state, ns in waits.items():
                ns = int(ns)
                node.waits[state] = node.waits.get(state, 0) + ns
                node.wait_ns += ns

    # -- export / federation ----------------------------------------------

    def local_state(self, tree_id: Optional[str] = None) -> dict:
        """This process's node records for one tree (or all retained
        trees), serializable for the MSG_OBS ``tree`` op. Tagged with
        ``registry_id`` so the merge counts each registry once."""
        with self._lock:
            tids = [tree_id] if tree_id is not None \
                else list(self._trees)
            trees = {}
            for tid in tids:
                nodes = self._trees.get(tid)
                if nodes:
                    trees[tid] = {nid: n.as_dict()
                                  for nid, n in nodes.items()}
        return {"enabled": _STATE.enabled,
                "registry_id": self.registry_id, "trees": trees}

    def note_orphans(self, tree_id: str, node_ids: Sequence[str]) -> int:
        """Record orphan flags discovered at assembly; fires the flight
        event once per (tree, node) across repeated assemblies."""
        fresh: list = []
        with self._lock:
            for nid in node_ids:
                key = (tree_id, nid)
                if key not in self._orphan_fired:
                    self._orphan_fired.add(key)
                    fresh.append(nid)
        if fresh:
            from quoracle_tpu_torch.infra.flightrec import FLIGHT
            from quoracle_tpu_torch.infra.telemetry import TREE_ORPHANS_TOTAL
            for nid in fresh:
                TREE_ORPHANS_TOTAL.inc()
                FLIGHT.record("tree_orphan", tree=tree_id, node=nid)
        return len(fresh)

    # -- fan-out priors ---------------------------------------------------

    def fanout_priors(self) -> Optional[dict]:
        """Mean children per node at each depth over the registry's
        current window (live + retained-LRU trees) — the read-only
        predictive input FleetSignals carries for the elastic-fleet
        roadmap item. None when nothing is registered."""
        if not _STATE.enabled:
            return None
        with self._lock:
            per_depth: dict = {}
            for nodes in self._trees.values():
                for n in nodes.values():
                    if n.implicit:
                        continue
                    cnt = per_depth.setdefault(n.depth, [0, 0])
                    cnt[0] += len(n.children)
                    cnt[1] += 1
        if not per_depth:
            return None
        out = {str(d): round(c / max(1, n), 4)
               for d, (c, n) in sorted(per_depth.items())}
        from quoracle_tpu_torch.infra.telemetry import TREE_FANOUT
        for d, v in out.items():
            TREE_FANOUT.set(v, depth=d)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"trees": len(self._trees), "done": len(self._done),
                    "nodes": len(self._by_node),
                    "registry_id": self.registry_id}


REGISTRY = TreeRegistry()


# ---------------------------------------------------------------------------
# Federated merge + subtree rollups + critical path
# ---------------------------------------------------------------------------


def merge_states(states: Sequence[Any], tree_id: str) -> dict:
    """Merge per-peer ``local_state`` payloads into one node table for
    ``tree_id``. Payloads are deduped by ``registry_id`` (loopback
    peers share a process registry — count it once); across DISTINCT
    registries per-node counters are summed (a node's work may split
    across peers after a handoff) and structure fields prefer the
    explicit spawn-side record."""
    merged: dict = {}
    seen_regs: set = set()
    for st in states:
        if not isinstance(st, dict):
            continue
        rid = st.get("registry_id")
        if rid is not None and rid in seen_regs:
            continue
        if rid is not None:
            seen_regs.add(rid)
        nodes = (st.get("trees") or {}).get(tree_id) or {}
        for nid, nd in nodes.items():
            if not isinstance(nd, dict):
                continue
            cur = merged.get(nid)
            if cur is None:
                merged[nid] = dict(nd)
                merged[nid]["waits"] = dict(nd.get("waits") or {})
                continue
            for f in _COUNTER_FIELDS:
                cur[f] = int(cur.get(f) or 0) + int(nd.get(f) or 0)
            for s, ns in (nd.get("waits") or {}).items():
                cur["waits"][s] = cur["waits"].get(s, 0) + int(ns)
            cur["entropy_sum"] = float(cur.get("entropy_sum") or 0.0) \
                + float(nd.get("entropy_sum") or 0.0)
            cur["margin_sum"] = float(cur.get("margin_sum") or 0.0) \
                + float(nd.get("margin_sum") or 0.0)
            cur["completed"] = bool(cur.get("completed")) \
                or bool(nd.get("completed"))
            if cur.get("implicit") and not nd.get("implicit"):
                # spawn-side record wins the structure fields
                for f in ("parent_id", "depth", "ordinal", "implicit",
                          "deadline_ms", "token_budget"):
                    cur[f] = nd.get(f)
    return merged


def tree_view(tree_id: str, states: Optional[Sequence[Any]] = None,
              registry: Optional[TreeRegistry] = None) -> dict:
    """One coherent view of ``tree_id`` assembled from per-peer states
    (default: just the local registry): per-node rows, recursive
    subtree rollups with the exact conservation contract asserted,
    orphan flags, fan-out per depth, and the critical path."""
    reg = registry if registry is not None else REGISTRY
    if states is None:
        states = [reg.local_state(tree_id)]
    nodes = merge_states(states, tree_id)
    children: dict = {nid: [] for nid in nodes}
    roots: list = []
    orphans: list = []
    for nid in sorted(nodes):
        nd = nodes[nid]
        pid = nd.get("parent_id")
        if pid is None:
            roots.append(nid)
        elif pid in nodes:
            children[pid].append(nid)
        else:
            # Parent record missing from the assembled view — its peer
            # died before federation. Flag, root the fragment, NEVER
            # silently unparent.
            nd["orphaned"] = True
            orphans.append(nid)
            roots.append(nid)
    for nid, kids in children.items():
        kids.sort(key=lambda c: (nodes[c].get("ordinal", 0), c))
    if orphans:
        reg.note_orphans(tree_id, orphans)

    # Bottom-up subtree rollups + critical path, iterative (no Python
    # recursion limit on deep chains). Cycle guard: a node reached
    # twice contributes once (visited set), so the conservation sum
    # stays exact even against garbage wire parent links.
    subtree: dict = {}
    cp_cost: dict = {}
    cp_next: dict = {}
    visited: set = set()
    for root in roots:
        stack = [(root, False)]
        while stack:
            nid, expanded = stack.pop()
            if expanded:
                nd = nodes[nid]
                tot = {"chip_ns": int(nd.get("chip_ns") or 0),
                       "tokens": int(nd.get("tokens") or 0),
                       "wait_ns": int(nd.get("wait_ns") or 0)}
                self_cost = tot["chip_ns"] + tot["wait_ns"]
                best_child, best_cost = None, -1
                for c in children.get(nid, ()):
                    sub = subtree.get(c)
                    if sub is None:        # cycle-trimmed child
                        continue
                    for k in tot:
                        tot[k] += sub[k]
                    cc = cp_cost.get(c, 0)
                    if cc > best_cost or (cc == best_cost
                                          and (best_child is None
                                               or c < best_child)):
                        best_child, best_cost = c, cc
                subtree[nid] = tot
                cp_cost[nid] = self_cost + max(0, best_cost)
                cp_next[nid] = best_child
                continue
            if nid in visited:
                continue
            visited.add(nid)
            stack.append((nid, True))
            for c in children.get(nid, ()):
                if c not in visited:
                    stack.append((c, False))

    totals = {"chip_ns": 0, "tokens": 0, "wait_ns": 0}
    for nid in visited:
        nd = nodes[nid]
        for k in totals:
            totals[k] += int(nd.get(k) or 0)
    rolled = {k: sum(subtree[r][k] for r in roots if r in subtree)
              for k in totals}
    # THE conservation contract: recursive rollup == flat sum, exact
    # integers — by construction (each node counted exactly once), so
    # a mismatch is a bookkeeping bug worth crashing a test over.
    conserved = rolled == totals
    assert conserved, (
        f"tree {tree_id!r} rollup conservation broken: "
        f"recursive={rolled} flat={totals}")

    crit_root = None
    for r in roots:
        if r in cp_cost and (crit_root is None
                             or cp_cost[r] > cp_cost[crit_root]
                             or (cp_cost[r] == cp_cost[crit_root]
                                 and r < crit_root)):
            crit_root = r
    path: list = []
    cur = crit_root
    while cur is not None and cur not in path:
        path.append(cur)
        cur = cp_next.get(cur)

    fanout: dict = {}
    for nid in visited:
        d = int(nodes[nid].get("depth") or 0)
        cnt = fanout.setdefault(d, [0, 0])
        cnt[0] += len(children.get(nid, ()))
        cnt[1] += 1

    rows = []
    for nid in sorted(visited,
                      key=lambda n: (nodes[n].get("depth", 0),
                                     nodes[n].get("ordinal", 0), n)):
        nd = nodes[nid]
        qn = max(1, int(nd.get("quality_n") or 0))
        rows.append({
            "node_id": nid, "parent_id": nd.get("parent_id"),
            "depth": nd.get("depth", 0),
            "ordinal": nd.get("ordinal", 0),
            "completed": bool(nd.get("completed")),
            "orphaned": bool(nd.get("orphaned")),
            "implicit": bool(nd.get("implicit")),
            "deadline_ms": nd.get("deadline_ms"),
            "token_budget": nd.get("token_budget"),
            "decides": int(nd.get("decides") or 0),
            "chip_ns": int(nd.get("chip_ns") or 0),
            "tokens": int(nd.get("tokens") or 0),
            "wait_ns": int(nd.get("wait_ns") or 0),
            "waits": dict(nd.get("waits") or {}),
            "entropy_mean": round(
                float(nd.get("entropy_sum") or 0.0) / qn, 6),
            "margin_mean": round(
                float(nd.get("margin_sum") or 0.0) / qn, 6),
            "dissents": int(nd.get("dissents") or 0),
            "subtree": subtree.get(nid, {"chip_ns": 0, "tokens": 0,
                                         "wait_ns": 0}),
            "on_critical_path": nid in path,
        })
    return {
        "tree_id": tree_id,
        "nodes": rows,
        "n_nodes": len(rows),
        "roots": roots,
        "orphans": orphans,
        "max_depth": max((int(nodes[n].get("depth") or 0)
                          for n in visited), default=0),
        "fanout": {str(d): round(c / max(1, n), 4)
                   for d, (c, n) in sorted(fanout.items())},
        "totals": totals,
        "conserved": conserved,
        "critical_path": {"node_ids": path,
                          "cost_ns": cp_cost.get(crit_root, 0)},
    }


# ---------------------------------------------------------------------------
# Module-level convenience (the default registry)
# ---------------------------------------------------------------------------


def register_spawn(node_id: str, parent_id: Optional[str] = None,
                   tree_id: Optional[str] = None,
                   deadline_ms: Optional[int] = None,
                   token_budget: Optional[int] = None,
                   ) -> Optional[TreeContext]:
    return REGISTRY.register_spawn(node_id, parent_id, tree_id,
                                   deadline_ms, token_budget)


def complete_node(node_id: str) -> None:
    REGISTRY.complete_node(node_id)


def depth_of(node_id: str) -> Optional[int]:
    return REGISTRY.depth_of(node_id)


def charge_decide(tree: Any, chip_ms: float, tokens: int,
                  audit: Optional[dict] = None) -> None:
    REGISTRY.charge_decide(tree, chip_ms, tokens, audit)


def charge_row_waits(tree: Any, closed: Any) -> None:
    REGISTRY.charge_row_waits(tree, closed)


def local_tree_state(tree_id: Optional[str] = None) -> dict:
    return REGISTRY.local_state(tree_id)


def fanout_signals() -> Optional[dict]:
    return REGISTRY.fanout_priors()


def tree_payload(tree_id: str,
                 states: Optional[Sequence[Any]] = None) -> dict:
    """``GET /api/tree`` body (local-registry fallback when the backend
    exposes no federating ``pull_tree``)."""
    if not _STATE.enabled:
        return {"enabled": False, "tree_id": tree_id}
    out = tree_view(tree_id, states)
    out["enabled"] = True
    return out


def reset() -> None:
    """Test isolation: fresh registry, enablement re-read from env."""
    global REGISTRY
    _STATE.enabled = _env_enabled()
    _TLS.ctx = None
    REGISTRY = TreeRegistry()
