"""Consensus merge rules: how param values from agreeing models combine.

Parity with the reference's ConsensusRules
(reference lib/quoracle/actions/consensus_rules.ex:18-120). Two jobs:

  1. COMPATIBILITY — do two values count as "the same proposal"? (drives
     clustering in aggregator.py). Only exact/semantic rules split clusters;
     mode/union/structural/percentile/wait/batch values are mergeable by
     design and never block clustering (they resolve at merge time).
  2. MERGE — given a winning cluster's values, produce the executed value.

Embedding lookups go through an Embedder (cosine >= threshold) and are
counted in an accumulator the caller threads through, mirroring the
reference's embedding-cost accumulator
(reference consensus/result.ex:311-365).

The PyTorch port's own copy of
``quoracle_tpu/consensus/rules.py``, line for line but for its
imports, so the parity tests can compare the two packages' outputs
field by field.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Optional, Protocol, Sequence

import numpy as np

from quoracle_tpu_torch.consensus.json_utils import stable_dumps


class Embedder(Protocol):
    def embed(self, texts: Sequence[str]) -> list[np.ndarray]: ...


@dataclasses.dataclass
class EmbedAccumulator:
    """Counts embedding work done during a consensus round for cost recording
    (reference Costs.Accumulator batching through consensus merging).

    ``margins`` additionally records ``cosine - threshold`` for every
    semantic-compatibility check that actually embedded (the quality
    layer's view: mass near 0 means clusters formed on a knife edge).
    Strictly an observation of embeds that happen anyway — recording a
    margin never ADDS an embedder call, so decide outcomes and embed
    counts are identical with or without a consumer reading them."""
    texts: int = 0
    chars: int = 0
    margins: list = dataclasses.field(default_factory=list)

    def add(self, batch: Sequence[str]) -> None:
        self.texts += len(batch)
        self.chars += sum(len(t) for t in batch)


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def semantically_equal(a: str, b: str, threshold: float, embedder: Embedder,
                       acc: Optional[EmbedAccumulator] = None) -> bool:
    if a == b:
        return True
    if acc is not None:
        acc.add([a, b])
    va, vb = embedder.embed([a, b])
    cos = _cos(va, vb)
    if acc is not None:
        acc.margins.append(cos - threshold)
    return cos >= threshold


def values_compatible(rule: tuple, a: Any, b: Any, embedder: Embedder,
                      acc: Optional[EmbedAccumulator] = None) -> bool:
    """Clustering predicate. Mergeable rules are always compatible."""
    kind = rule[0]
    if a is None and b is None:
        return True
    if kind == "exact":
        return stable_dumps(a) == stable_dumps(b)
    if kind == "semantic":
        if a is None or b is None:
            return False
        return semantically_equal(str(a), str(b), rule[1], embedder, acc)
    # mode / union / structural / percentile / wait / batch_sequence
    return True


# ---------------------------------------------------------------------------
# Merging
# ---------------------------------------------------------------------------

def merge_values(rule: tuple, values: list[Any], embedder: Embedder,
                 acc: Optional[EmbedAccumulator] = None) -> Any:
    """Merge a winning cluster's values for one param. ``values`` excludes
    Nones (absent params)."""
    if not values:
        return None
    kind = rule[0]
    if kind == "exact":
        return values[0]
    if kind == "semantic":
        return _most_central(values, embedder, acc)
    if kind == "mode":
        return _mode(values)
    if kind == "union":
        return _union(values)
    if kind == "structural":
        return _structural(values)
    if kind == "percentile":
        return _percentile(values, rule[1])
    if kind == "wait":
        return merge_wait(values)
    if kind == "batch_sequence":
        # Handled by result.merge_cluster_params (needs schemas per position).
        return values[0]
    raise ValueError(f"unknown rule {rule!r}")


def _most_central(values: list[Any], embedder: Embedder,
                  acc: Optional[EmbedAccumulator]) -> Any:
    """Representative selection for semantic params: the value closest (mean
    cosine) to all others. Deterministic: ties break to earliest model."""
    texts = [str(v) for v in values]
    if len(set(texts)) == 1:
        return values[0]
    if acc is not None:
        acc.add(texts)
    vecs = embedder.embed(texts)
    sims = np.zeros(len(texts))
    for i in range(len(texts)):
        sims[i] = sum(_cos(vecs[i], vecs[j])
                      for j in range(len(texts)) if j != i)
    return values[int(np.argmax(sims))]


def _mode(values: list[Any]) -> Any:
    counts = Counter(stable_dumps(v) for v in values)
    best_key, _ = max(counts.items(),
                      key=lambda kv: (kv[1], -_first_index(values, kv[0])))
    for v in values:
        if stable_dumps(v) == best_key:
            return v
    return values[0]


def _first_index(values: list[Any], key: str) -> int:
    for i, v in enumerate(values):
        if stable_dumps(v) == key:
            return i
    return len(values)


def _union(values: list[Any]) -> list:
    seen: dict[str, Any] = {}
    for v in values:
        items = v if isinstance(v, list) else [v]
        for item in items:
            seen.setdefault(stable_dumps(item), item)
    return [seen[k] for k in sorted(seen)]


def _structural(values: list[Any]) -> Any:
    """Deep structural merge: dicts union keys recursively; conflicting
    scalars/lists resolve by mode (reference deep-sorted-map rule)."""
    if all(isinstance(v, dict) for v in values):
        keys = sorted({k for v in values for k in v})
        return {k: _structural([v[k] for v in values if k in v]) for k in keys}
    return _mode(values)


def _percentile(values: list[Any], p: float) -> Any:
    nums = [v for v in values if isinstance(v, (int, float))
            and not isinstance(v, bool)]
    if not nums:
        return values[0]
    result = float(np.percentile(nums, p, method="nearest"))
    if all(isinstance(v, int) for v in nums):
        return int(result)
    return result


def merge_wait(values: list[Any]) -> Any:
    """Wait-parameter voting (reference result.ex wait merge +
    consensus_handler.ex:264-292 semantics): False/0 = continue immediately,
    True = wait indefinitely, int>0 = timed wait. Majority category wins;
    numeric category resolves to the median duration."""
    present = [v for v in values if v is not None]
    if not present:
        return None

    def category(v):
        if v is True:
            return "indefinite"
        if v is False or v == 0:
            return "continue"
        return "timed"

    cats = Counter(category(v) for v in present)
    winner = max(cats.items(), key=lambda kv: kv[1])[0]
    if winner == "indefinite":
        return True
    if winner == "continue":
        return False
    nums = [v for v in present if category(v) == "timed"]
    return int(np.percentile(nums, 50, method="nearest"))
