"""Clustering of action proposals + majority detection + refinement prompts.

Parity with the reference's Aggregator
(reference lib/quoracle/consensus/aggregator.ex): proposals cluster by
{action, schema-aware param compatibility}; batch actions cluster by their
action-type SEQUENCE (ordered for batch_sync, sorted for batch_async —
aggregator.ex:72-91); majority requires UNANIMITY in round 1 and >threshold
afterwards (aggregator.ex:48-62); no majority -> refinement prompt asking
each model to act as a skeptical reviewer and restate its choice
self-containedly (aggregator.ex:130-188).

Design difference from the reference: clustering compares semantic params
with the on-device embedder directly (cosine >= per-param threshold) instead
of key-term normalization — exact where the reference approximated, because
embeddings here are a local XLA call, not a priced HTTP round trip.

The PyTorch port's own copy of
``quoracle_tpu/consensus/aggregator.py``, line for line but for its
imports, so the parity tests can compare the two packages' outputs
field by field.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

from quoracle_tpu_torch.actions.schema import get_schema
from quoracle_tpu_torch.consensus.json_utils import stable_dumps
from quoracle_tpu_torch.consensus.parser import ActionProposal
from quoracle_tpu_torch.consensus.rules import (
    EmbedAccumulator, Embedder, values_compatible,
)


@dataclasses.dataclass
class Cluster:
    proposals: list[ActionProposal]

    @property
    def action(self) -> str:
        return self.proposals[0].action

    @property
    def size(self) -> int:
        return len(self.proposals)


def _batch_fingerprint(proposal: ActionProposal) -> str:
    subs = proposal.params.get("actions", [])
    seq = [s.get("action", "?") for s in subs if isinstance(s, dict)]
    if proposal.action == "batch_async":
        seq = sorted(seq)  # parallel => order-insensitive (aggregator.ex:72-91)
    return json.dumps(seq)


def proposals_compatible(a: ActionProposal, b: ActionProposal,
                         embedder: Embedder,
                         acc: Optional[EmbedAccumulator] = None) -> bool:
    if a.action != b.action:
        return False
    schema = get_schema(a.action)
    if a.action in ("batch_sync", "batch_async"):
        if _batch_fingerprint(a) != _batch_fingerprint(b):
            return False
        # Matching sequences: per-position sub-params must be compatible too.
        a_subs = a.params.get("actions", [])
        b_subs = b.params.get("actions", [])
        if a.action == "batch_async":
            a_subs = sorted(a_subs, key=stable_dumps)
            b_subs = sorted(b_subs, key=stable_dumps)
        for sa, sb in zip(a_subs, b_subs):
            if sa.get("action") != sb.get("action"):
                return False
            sub_schema = get_schema(sa["action"])
            pa, pb = sa.get("params", {}), sb.get("params", {})
            for param in sub_schema.params:
                if not values_compatible(sub_schema.rule_for(param),
                                         pa.get(param), pb.get(param),
                                         embedder, acc):
                    return False
        return True

    for param in schema.params:
        if not values_compatible(schema.rule_for(param),
                                 a.params.get(param), b.params.get(param),
                                 embedder, acc):
            return False
    return True


def cluster_proposals(proposals: Sequence[ActionProposal], embedder: Embedder,
                      acc: Optional[EmbedAccumulator] = None) -> list[Cluster]:
    """Greedy clustering against each cluster's first member (deterministic
    in model order)."""
    clusters: list[Cluster] = []
    for p in proposals:
        for c in clusters:
            if proposals_compatible(c.proposals[0], p, embedder, acc):
                c.proposals.append(p)
                break
        else:
            clusters.append(Cluster(proposals=[p]))
    return clusters


def find_majority_cluster(clusters: list[Cluster], total: int, round_num: int,
                          threshold: float = 0.5) -> Optional[Cluster]:
    """Round 1 demands unanimity; later rounds > threshold of valid responses
    (reference aggregator.ex:48-62)."""
    if not clusters or total == 0:
        return None
    best = max(clusters, key=lambda c: c.size)
    if round_num <= 1:
        return best if best.size == total else None
    return best if best.size / total > threshold else None


# ---------------------------------------------------------------------------
# Refinement prompt
# ---------------------------------------------------------------------------

def build_refinement_prompt(clusters: list[Cluster], own: ActionProposal,
                            round_num: int, max_rounds: int) -> str:
    """The message appended to each model's history when no majority formed.

    Reference semantics (aggregator.ex:130-188): show the model the other
    proposals grouped by cluster, instruct it to review skeptically, and
    require a SELF-CONTAINED restatement (its next response must not lean on
    its own prior message, because histories are per-model)."""
    lines = [
        f"No consensus was reached (refinement round {round_num - 1} of "
        f"{max_rounds}). The model pool proposed {len(clusters)} distinct "
        "actions:",
        "",
    ]
    for i, c in enumerate(clusters, 1):
        rep = c.proposals[0]
        reasons = "; ".join(p.reasoning for p in c.proposals if p.reasoning)[:500]
        mine = " (includes YOUR proposal)" if own in c.proposals else ""
        lines.append(
            f"{i}. [{c.size} model(s)]{mine} {rep.action} "
            f"params={stable_dumps(rep.params)[:400]}")
        if reasons:
            lines.append(f"   reasoning: {reasons}")
    lines += [
        "",
        "Act as a skeptical reviewer of ALL proposals above, including your "
        "own. Weigh which action best serves the task right now; changing "
        "your choice to align with a better proposal is encouraged when "
        "justified, but do not abandon a correct choice merely to conform.",
        "Respond with a single self-contained JSON object "
        '{"action", "params", "reasoning", "wait"} — restate every parameter '
        "in full; do not reference your previous response.",
    ]
    return "\n".join(lines)
