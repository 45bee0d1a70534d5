"""Winner selection, param merging, confidence, tiebreak.

Parity with the reference's Consensus.Result (+Scoring)
(reference lib/quoracle/consensus/result.ex:30-42,261-365,290-308):
majority cluster -> consensus; none after the final round -> plurality with
deterministic tiebreak -> forced_decision. Params merge within the winning
cluster per the schema's per-param rules; confidence combines cluster
proportion, a majority bonus, and a per-round penalty, clamped to [0.1, 1.0].

The PyTorch port's own copy of
``quoracle_tpu/consensus/result.py``, line for line but for its
imports, so the parity tests can compare the two packages' outputs
field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from quoracle_tpu_torch.actions.schema import get_schema
from quoracle_tpu_torch.consensus.aggregator import Cluster
from quoracle_tpu_torch.consensus.json_utils import stable_dumps
from quoracle_tpu_torch.consensus.rules import (
    EmbedAccumulator, Embedder, merge_values, merge_wait,
)

MAJORITY_BONUS = 0.2
ROUND_PENALTY = 0.05
CONFIDENCE_MIN = 0.1
CONFIDENCE_MAX = 1.0


@dataclasses.dataclass
class Decision:
    kind: str                  # "consensus" | "forced_decision"
    action: str
    params: dict
    wait: Any
    confidence: float
    cluster_size: int
    total_responses: int
    rounds_used: int
    reasoning: str = ""


def merge_cluster_params(cluster: Cluster, embedder: Embedder,
                         acc: Optional[EmbedAccumulator] = None) -> dict:
    """Per-param consensus-rule merge across the cluster's proposals
    (reference result.ex:311-365)."""
    schema = get_schema(cluster.action)
    if cluster.action in ("batch_sync", "batch_async"):
        return {"actions": _merge_batch(cluster, embedder, acc)}
    merged: dict = {}
    for param in schema.params:
        values = [p.params.get(param) for p in cluster.proposals
                  if p.params.get(param) is not None]
        if not values:
            continue
        merged[param] = merge_values(schema.rule_for(param), values,
                                     embedder, acc)
    return merged


def _merge_batch(cluster: Cluster, embedder: Embedder,
                 acc: Optional[EmbedAccumulator]) -> list[dict]:
    """Per-position merge of batch sub-actions (reference
    consensus_rules.ex batch_sequence_merge). Fingerprint compatibility
    guarantees every member has the same action sequence."""
    def ordered(p):
        subs = p.params.get("actions", [])
        if cluster.action == "batch_async":
            return sorted(subs, key=stable_dumps)
        return subs

    member_subs = [ordered(p) for p in cluster.proposals]
    n_positions = min(len(s) for s in member_subs)
    out = []
    for pos in range(n_positions):
        sub_action = member_subs[0][pos].get("action")
        sub_schema = get_schema(sub_action)
        merged_params: dict = {}
        for param in sub_schema.params:
            values = [s[pos].get("params", {}).get(param) for s in member_subs
                      if s[pos].get("params", {}).get(param) is not None]
            if values:
                merged_params[param] = merge_values(
                    sub_schema.rule_for(param), values, embedder, acc)
        out.append({"action": sub_action, "params": merged_params})
    return out


def confidence_score(cluster_size: int, total: int, round_num: int,
                     is_majority: bool) -> float:
    """proportion + majority bonus - round penalty, clamped (reference
    result.ex:261-286)."""
    proportion = cluster_size / total if total else 0.0
    score = proportion + (MAJORITY_BONUS if is_majority else 0.0) \
        - ROUND_PENALTY * max(0, round_num - 1)
    return max(CONFIDENCE_MIN, min(CONFIDENCE_MAX, round(score, 4)))


def _wait_score(cluster: Cluster) -> int:
    """Tiebreak preference: clusters that keep working beat clusters that
    block (reference Scoring wait-score tiebreak). Lower = preferred."""
    w = merge_wait([p.wait for p in cluster.proposals])
    if w is True:
        return 2
    if w is None or w is False or w == 0:
        return 0
    return 1


def select_winner_cluster(clusters: list[Cluster],
                          majority: Optional[Cluster],
                          ) -> tuple[Cluster, str]:
    """Which cluster wins, and how: majority -> "consensus"; else
    plurality with the deterministic tiebreak -> "forced_decision".
    Pure selection (no merging, no embedder) — factored out of
    :func:`pick_winner` so the quality layer (consensus/quality.py) can
    attribute the winning cluster for the audit record without
    re-implementing the tiebreak."""
    if majority is not None:
        return majority, "consensus"
    max_size = max(c.size for c in clusters)
    tied = [c for c in clusters if c.size == max_size]
    winner = min(tied, key=lambda c: (get_schema(c.action).priority,
                                      _wait_score(c),
                                      clusters.index(c)))
    return winner, "forced_decision"


def pick_winner(clusters: list[Cluster], total: int, round_num: int,
                majority: Optional[Cluster], embedder: Embedder,
                acc: Optional[EmbedAccumulator] = None) -> Decision:
    """majority -> consensus; else plurality + tiebreak -> forced_decision
    (reference result.ex:30-42,290-308). Tiebreak among equal-size clusters:
    action priority (schema), then wait score, then first-proposed."""
    winner, kind = select_winner_cluster(clusters, majority)

    params = merge_cluster_params(winner, embedder, acc)
    wait = merge_wait([p.wait for p in winner.proposals])
    reasoning = next((p.reasoning for p in winner.proposals if p.reasoning), "")
    return Decision(
        kind=kind,
        action=winner.action,
        params=params,
        wait=wait,
        confidence=confidence_score(winner.size, total, round_num,
                                    majority is not None),
        cluster_size=winner.size,
        total_responses=total,
        rounds_used=round_num,
        reasoning=reasoning,
    )
