"""Consensus-quality math and the per-decide audit record.

The PyTorch port's own copy of the pure part of
``quoracle_tpu/consensus/quality.py``: decide ids, vote entropy, winner
margin and ``build_audit_record``, line for line but for comments, so
``ConsensusOutcome.audit`` is the same record in both packages. Not
ported yet: ``ConsensusQuality`` (per-member scorecards and drift
detection), the process-wide ``QUALITY`` that the JAX engine feeds after
every decide, and the audit-capture sink; they only observe outcomes and
come with the port's telemetry.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import Any, Iterable, Optional, Sequence

# Failure attribution (ModelFailure.kind): the four causes the engine can
# distinguish. ``transport`` = the backend returned an error row (the
# member never answered); ``parse`` = the response was not a JSON action;
# ``schema`` = it parsed but failed parameter validation; ``deadline`` =
# the row expired at QoS admission.
FAILURE_KINDS = ("transport", "parse", "schema", "deadline")

_decide_ids = itertools.count(1)


def next_decide_id() -> str:
    """Allocate a decide id (``c<n:x>``). The engine draws it before the
    query rounds, so the rows and the audit record share one id."""
    return f"c{next(_decide_ids):x}"


def vote_entropy(cluster_sizes: Sequence[int]) -> float:
    """Shannon entropy (bits) of the cluster-share distribution.

    0.0 = unanimous (one cluster), log2(k) = a k-way even split — the
    contestedness of a decide in one number, independent of which
    cluster won."""
    total = sum(cluster_sizes)
    if total <= 0:
        return 0.0
    h = 0.0
    for s in cluster_sizes:
        if s > 0:
            p = s / total
            h -= p * math.log2(p)
    return h


def winner_margin(cluster_sizes: Sequence[int]) -> float:
    """Winner share − runner-up share (runner-up 0 with a single
    cluster): 1.0 = unanimous, 0.0 = a tie the tiebreak had to break."""
    total = sum(cluster_sizes)
    if total <= 0:
        return 0.0
    ordered = sorted(cluster_sizes, reverse=True)
    runner_up = ordered[1] if len(ordered) > 1 else 0
    return (ordered[0] - runner_up) / total


def build_audit_record(*, task_id: Optional[str], agent_id: Optional[str],
                       pool: Sequence[str], outcome: Any,
                       clusters: Sequence[Any], winner_index: Optional[int],
                       sim_margins: Sequence[float],
                       failure_counts: dict[str, dict[str, int]],
                       corrected: Iterable[str],
                       decide_id: Optional[str] = None) -> dict:
    """The structured per-decide record. Pure: reads the outcome the
    engine already computed; every field is JSON-serializable."""
    sizes = [c.size for c in clusters]
    members: dict[str, dict] = {m: {} for m in pool}
    for idx, c in enumerate(clusters):
        for p in c.proposals:
            members.setdefault(p.model_spec, {}).update(
                action=p.action, cluster=idx,
                agreed=(winner_index is not None and idx == winner_index))
    for f in outcome.failures:          # final-round failures
        members.setdefault(f.model_spec, {}).setdefault("agreed", False)
        members[f.model_spec]["failure"] = {
            "kind": f.kind, "error": str(f.error)[:200]}
    for m, ms in outcome.member_latency_ms.items():
        members.setdefault(m, {})["latency_ms"] = round(ms, 2)
    for m, ms in getattr(outcome, "member_chip_ms", {}).items():
        members.setdefault(m, {})["chip_ms"] = round(ms, 3)

    corrected = sorted(set(corrected))
    proposed = {p.model_spec for p in outcome.proposals}
    decision = outcome.decision
    return {
        "event": "consensus_audit",
        "ts": time.time(),
        "decide_id": decide_id or next_decide_id(),
        "task_id": task_id,
        "agent_id": agent_id,
        "status": outcome.status,
        "rounds": outcome.rounds_used,
        "n_members": len(pool),
        "n_proposals": len(outcome.proposals),
        "decision": ({
            "action": decision.action, "kind": decision.kind,
            "confidence": decision.confidence,
            "cluster_size": decision.cluster_size,
            "total_responses": decision.total_responses,
        } if decision is not None else None),
        "entropy_bits": round(vote_entropy(sizes), 4) if sizes else None,
        "margin": round(winner_margin(sizes), 4) if sizes else None,
        "clusters": [{"action": c.action, "size": c.size,
                      "members": [p.model_spec for p in c.proposals]}
                     for c in clusters],
        "winner_cluster": winner_index,
        "members": members,
        "failure_counts": {m: dict(kinds)
                           for m, kinds in failure_counts.items()},
        "corrected": corrected,
        "recovered": sorted(set(corrected) & proposed),
        "sim_margins": [round(m, 4) for m in list(sim_margins)[:64]],
        "sim_margin_min": (round(min(sim_margins), 4)
                           if sim_margins else None),
        "n_sim_checks": len(sim_margins),
        "deadline_misses": outcome.deadline_misses,
        # speculative serving: how many of this decide's completion
        # tokens came from accepted draft proposals (0 in the port, which
        # has no speculation yet)
        "spec_rounds": getattr(outcome, "spec_rounds", 0),
        "spec_accepted_tokens": getattr(outcome, "spec_accepted_tokens",
                                        0),
        "latency_ms": round(outcome.latency_ms, 2),
        # what this decide cost in measured device time (0 in the port,
        # which has no chip ledger yet) and decoded tokens
        "chip_ms": round(getattr(outcome, "chip_ms", 0.0), 3),
        "tokens_per_decide": getattr(outcome, "completion_tokens", 0),
    }
