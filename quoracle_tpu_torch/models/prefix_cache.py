"""Radix prefix cache of the PyTorch port (port of
``quoracle_tpu/models/prefix_cache.py``): ref-counted, copy-on-write KV
page sharing across the sessions of one ``SessionStore``.

Every consensus round fans the same built prompt out to K rows, and every
child agent inherits most of its parent's system/task preamble, so the
same page-aligned token blocks would be prefilled over and over. This
module maps token prefixes to the pages that already hold their KV:

  * a RADIX TREE over PAGE-ALIGNED token blocks: each node is exactly one
    page of the device pool, its edge labeled with that page's ``page``
    token ids; a root-to-node path spells a cached token prefix whose KV
    is resident in the path's pages;
  * the tree holds its OWN REFERENCE on every node's page (the store's
    refcount dict), so cached prefixes survive the death of the session
    that prefilled them;
  * LRU EVICTION strips unreferenced leaves (pages whose ONLY remaining
    reference is the tree's) when the pool runs dry: shared live pages
    are never evicted, and eviction is leaf-first so an evicted node can
    never orphan cached descendants;
  * COPY-ON-WRITE is enforced at the write site
    (``GenerateEngine._run_paged``): a session about to rewrite a shared
    page beyond its identical-prefix region swaps in a fresh page and
    leaves the shared copy untouched; the engine reports those swaps here
    (``note_cow``).

Invariants (held against the JAX package by
tests/test_torch_prefix_cache.py):
  I1  a page is freed only when its refcount reaches zero — never while a
      session, an in-flight batch, or the tree still references it;
  I2  tree page content is immutable: writers either rewrite a shared page
      byte-identically (the gather scatter inside the identical-prefix
      region) or COW-swap it;
  I3  sessions hold contiguous root-path references, so iterative
      unreferenced-LEAF eviction reaches exactly the reclaimable nodes.

Locking: every method assumes the owning SessionStore's RLock is held
(the store re-enters it freely); the store's public wrappers
(``match_prefix``, ``insert_prefix``, ``alloc``) take it.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Optional, Sequence


class _Node:
    """One cached page: edge label ``block`` (page-length token tuple,
    relative to the parent path), pool page id, LRU stamp."""

    __slots__ = ("block", "page", "children", "parent", "last_used")

    def __init__(self, block: tuple, page: int, parent: "Optional[_Node]"):
        self.block = block
        self.page = page
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.last_used = time.monotonic()


class RadixPrefixCache:
    """Radix tree over page-aligned KV blocks of one SessionStore's pool."""

    def __init__(self, store):
        self.store = store
        self.page = store.page
        self._root = _Node((), 0, None)      # sentinel; page 0 is scratch
        self._pages: dict[int, _Node] = {}   # page id -> its node
        # monotonic counters, read through stats()
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.cow_copies = 0

    # -- lookup ------------------------------------------------------------

    def _walk(self, tokens: Sequence[int], max_reuse: int) -> list[_Node]:
        """The node path for the longest cached page-aligned prefix of
        ``tokens``, bounded by ``max_reuse`` (callers pass len-1 so >= 1
        suffix token always re-runs to produce last-position logits)."""
        page = self.page
        node = self._root
        path: list[_Node] = []
        for j in range(min(len(tokens), max_reuse) // page):
            child = node.children.get(tuple(tokens[j * page:(j + 1) * page]))
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def match(self, tokens: Sequence[int],
              max_reuse: int) -> tuple[list[int], int]:
        """Longest cached page-aligned prefix: (pages, n_tokens). Bumps the
        path's LRU stamps and the hit/miss counters — call once per real
        lookup (the wave planner probes via match_len instead)."""
        path = self._walk(tokens, max_reuse)
        now = time.monotonic()
        for node in path:
            node.last_used = now
        matched = len(path) * self.page
        if path:
            self.hits += 1
            self.hit_tokens += matched
        else:
            self.misses += 1
            self.miss_tokens += len(tokens)
        return [n.page for n in path], matched

    def match_len(self, tokens: Sequence[int], max_reuse: int) -> int:
        """Counter-free probe (intra-batch wave planning)."""
        return len(self._walk(tokens, max_reuse)) * self.page

    # -- insert ------------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Record a prefilled prefix: every FULL page of ``tokens`` whose
        block is not yet cached gets a node holding ``pages[j]`` and a tree
        reference on it. Blocks already cached keep their existing node
        (dedupe — the caller's duplicate page stays the session's own).
        Returns the number of new nodes."""
        page = self.page
        node = self._root
        added = 0
        for j in range(min(len(tokens) // page, len(pages))):
            pg = pages[j]
            block = tuple(tokens[j * page:(j + 1) * page])
            child = node.children.get(block)
            if child is None:
                if pg in self._pages or pg == 0:
                    break      # page already cached under another path
                child = _Node(block, pg, node)
                node.children[block] = child
                self._pages[pg] = child
                # the tree's own reference: absent refcount key == 1
                self.store._refs[pg] = self.store._refs.get(pg, 1) + 1
                added += 1
            child.last_used = time.monotonic()
            node = child
        self.inserted_pages += added
        return added

    # -- eviction ----------------------------------------------------------

    def _evictable_leaf(self) -> Optional[_Node]:
        """LRU leaf whose page's ONLY remaining reference is the tree's.
        Refcount semantics (store._refs, absent key == 1): the count is the
        number of current holders — the allocating session's base ref, one
        per adopter acquire, one for the tree."""
        best: Optional[_Node] = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node.children:
                continue
            if self.store._refs.get(node.page, 1) != 1:
                continue       # a session/adopter still reads it
            if best is None or node.last_used < best.last_used:
                best = node
        return best

    def _remove(self, node: _Node) -> None:
        del node.parent.children[node.block]
        self._pages.pop(node.page, None)

    def _node_tokens(self, node: _Node) -> list:
        """The full token prefix a node's page caches (the root path's
        blocks, concatenated): the KV tier's content-addressed key."""
        blocks = []
        while node is not self._root:
            blocks.append(node.block)
            node = node.parent
        out: list = []
        for b in reversed(blocks):
            out.extend(b)
        return out

    def evict(self, n: int) -> int:
        """Free up to ``n`` pages by stripping unreferenced LRU leaves.
        Returns pages actually freed to the store's free list. With a KV
        tier attached (serving/kvtier.py), a stripped leaf's block is
        captured host-side first, so a later lookup can page it back in."""
        freed = 0
        while freed < n:
            leaf = self._evictable_leaf()
            if leaf is None:
                break
            if self.store.tier is not None:
                self.store.tier.capture_leaf(self._node_tokens(leaf),
                                             leaf.page)
            self._remove(leaf)
            self.store._release([leaf.page])   # last ref -> free list
            freed += 1
            self.evicted_pages += 1
        return freed

    def clear(self) -> int:
        """Drop every node, releasing the tree's references (pages still
        held by sessions survive with refcount decremented)."""
        dropped = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.store._release([node.page])
            dropped += 1
        self._root.children.clear()
        self._pages.clear()
        return dropped

    # -- alloc accounting --------------------------------------------------

    def holds(self, page: int) -> bool:
        return page in self._pages

    def evictable_after(self, released: Counter) -> int:
        """How many tree pages would FREE if ``released`` (page -> count of
        references victim sessions would give up) were applied and the tree
        then stripped leaves bottom-up: a node frees iff its whole subtree
        frees and no reference beyond the tree's survives."""
        def strippable(node: _Node) -> tuple[bool, int]:
            count = 0
            all_ok = True
            for child in node.children.values():
                ok, c = strippable(child)
                count += c
                all_ok = all_ok and ok
            if node is self._root:
                return True, count
            remaining = self.store._refs.get(node.page, 1) \
                - released.get(node.page, 0)
            ok = all_ok and remaining <= 1     # only the tree's ref left
            return ok, count + (1 if ok else 0)

        return strippable(self._root)[1]

    # -- telemetry ---------------------------------------------------------

    def note_cow(self, n: int = 1) -> None:
        """The engine swapped ``n`` shared pages for fresh copies before a
        divergent write."""
        self.cow_copies += n

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "miss_tokens": self.miss_tokens,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "cow_copies": self.cow_copies,
            "cached_pages": len(self._pages),
        }

    def occupancy(self) -> dict:
        """Live occupancy, the point-in-time complement to stats(): resident
        pages (every tree node), REFERENCED pages (refcount > 1: a session
        or in-flight adopter reads them beyond the tree's own reference),
        and evictable LEAF pages (refcount exactly 1 and no children)."""
        referenced = evictable = 0
        for pg, node in self._pages.items():
            if self.store._refs.get(pg, 1) > 1:
                referenced += 1
            elif not node.children:
                evictable += 1
        return {
            "resident_pages": len(self._pages),
            "referenced_pages": referenced,
            "evictable_leaf_pages": evictable,
        }

    def __len__(self) -> int:
        return len(self._pages)
