"""Consensus orchestrator: query pool -> parse -> validate -> cluster ->
majority / refinement loop.

The PyTorch port's own copy of ``quoracle_tpu/consensus/engine.py``:
``ConsensusConfig``, ``ModelFailure``, ``ConsensusOutcome`` and
``ConsensusEngine`` with the same control flow, constants, strings and
field names, so a decide over the port's ``TorchBackend`` can be compared
field by field with the JAX engine's. It types against the port's
``ModelBackend`` (models/runtime.py).

Left out, because they only observe a decide: the JAX engine's tracer
spans, its decide and round latency histograms and round counter, the
chip-economics and session-graph charges, and the quality layer's
scorecard feed (``QUALITY.observe_decide``). The audit record is built as
in JAX (consensus/quality.py); its ``task_id`` falls back to None where
the JAX engine reads the current trace id.

Pure-logic layer: no persistence, no event bus. Dependencies (backend,
embedder) arrive explicitly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from quoracle_tpu_torch.actions.validator import (
    validate_params, validate_wait_param,
)
from quoracle_tpu_torch.consensus.aggregator import (
    build_refinement_prompt, cluster_proposals, find_majority_cluster,
)
from quoracle_tpu_torch.consensus.parser import (
    ActionProposal, ParseFailure, parse_response,
)
from quoracle_tpu_torch.consensus.quality import (
    build_audit_record, next_decide_id,
)
from quoracle_tpu_torch.consensus.result import (
    Decision, pick_winner, select_winner_cluster,
)
from quoracle_tpu_torch.consensus.rules import EmbedAccumulator
from quoracle_tpu_torch.consensus.temperature import temperature_for_round
from quoracle_tpu_torch.models.runtime import ModelBackend, QueryRequest

DEFAULT_THRESHOLD = 0.5          # reference consensus/manager.ex:11-21
DEFAULT_MAX_REFINEMENT_ROUNDS = 4
REASONING_WINDOW_ROUNDS = 2      # sliding window of refinement history kept


def _note_failures(failures: list["ModelFailure"],
                   failure_kinds: dict[str, dict[str, int]],
                   corrected: set[str]) -> None:
    """Fold one round's failures into the decide-wide quality scratch
    (per-member kind counts + who got correction feedback)."""
    for f in failures:
        kinds = failure_kinds.setdefault(f.model_spec, {})
        kinds[f.kind] = kinds.get(f.kind, 0) + 1
        if f.correction is not None:
            corrected.add(f.model_spec)


@dataclasses.dataclass
class ConsensusConfig:
    model_pool: list[str]
    max_refinement_rounds: int = DEFAULT_MAX_REFINEMENT_ROUNDS
    threshold: float = DEFAULT_THRESHOLD
    force_reflection: bool = False   # single-model pools still refine once
    allowed_actions: Optional[set[str]] = None
    profile_optional_spawn: bool = False
    max_tokens: Optional[int] = None
    # KV-residency key (the agent id): refinement rounds and later cycles
    # reuse the resident prompt prefix on the serving backend.
    session_key: Optional[str] = None
    # Grammar-masked decoding: proposals are valid JSON by construction on
    # backends that support it; mock backends ignore the flag and the
    # parser's markdown-unwrap recovery still applies.
    constrained_json: bool = True
    # Serving QoS: class/tenant attribution for every row this engine
    # submits, plus an optional per-round latency budget (the port's
    # backend carries them and does not read them yet).
    priority: Optional[int] = None
    tenant: str = "default"
    deadline_ms: Optional[float] = None
    # Task attribution for the per-decide audit record, and the switch
    # for the audit record (consensus/quality.py). Read-only: temp-0
    # decisions are identical with it on or off.
    task_id: Optional[str] = None
    quality: bool = True
    # The owning agent's tree context, stamped onto every QueryRequest.
    # Observed only; never read by decision logic.
    tree: Optional[dict] = None


@dataclasses.dataclass
class ModelFailure:
    model_spec: str
    error: str
    correction: Optional[str] = None  # feeds per-model correction feedback
    raw_text: str = ""                # the failing response, for history
    # Failure attribution by cause: transport = backend error row,
    # parse = not a JSON action, schema = failed param validation,
    # deadline = expired at QoS admission.
    kind: str = "transport"


@dataclasses.dataclass
class ConsensusOutcome:
    status: str                      # "ok" | "all_invalid" | "all_failed"
    decision: Optional[Decision] = None
    proposals: list[ActionProposal] = dataclasses.field(default_factory=list)
    failures: list[ModelFailure] = dataclasses.field(default_factory=list)
    rounds_used: int = 1
    latency_ms: float = 0.0
    prefill_ms: float = 0.0          # summed per-member device phase times
    decode_ms: float = 0.0
    prompt_tokens: int = 0
    completion_tokens: int = 0
    # Prompt tokens served from resident KV instead of re-prefilled,
    # summed over all rounds and members.
    cached_tokens: int = 0
    # Rows that missed their QoS deadline across all rounds (a member
    # miss, never a pool failure by itself).
    deadline_misses: int = 0
    # Speculative serving: draft/verify rounds and accepted draft tokens
    # summed over all rounds and members.
    spec_rounds: int = 0
    spec_accepted_tokens: int = 0
    # Measured device wall this decide consumed, per member and total,
    # and the decide id drawn before the first round.
    chip_ms: float = 0.0
    member_chip_ms: dict[str, float] = dataclasses.field(
        default_factory=dict)
    decide_id: Optional[str] = None
    cost: float = 0.0
    embed_texts: int = 0
    # Summed per-member proposal latency across all rounds (ms).
    member_latency_ms: dict[str, float] = dataclasses.field(
        default_factory=dict)
    # The per-decide audit record: member -> cluster mapping, winner,
    # entropy, margin, failures by kind. None when
    # ConsensusConfig.quality is off.
    audit: Optional[dict] = None
    bug_reports: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    condense_requests: dict[str, int] = dataclasses.field(default_factory=dict)
    # Refinement transcript per model, for history merging by the agent layer:
    # list of (refinement_prompt, model_response_text) pairs, capped to the
    # sliding window (reference consensus/manager.ex:82-93).
    refinement_history: dict[str, list[tuple[str, str]]] = \
        dataclasses.field(default_factory=dict)


class ConsensusEngine:
    """One instance per agent; stateless between decide() calls."""

    def __init__(self, backend: ModelBackend, config: ConsensusConfig,
                 log: Optional[Callable[[str, dict], None]] = None):
        self.backend = backend
        self.config = config
        self._log = log or (lambda event, data: None)

    # ------------------------------------------------------------------

    def decide(self, messages_per_model: dict[str, list[dict]]) -> ConsensusOutcome:
        """Run the full consensus process over per-model message histories.

        ``messages_per_model`` maps model_spec -> chat messages (system prompt
        included) — each pool member fills its own context window (reference
        per-model histories, README.md:642-650).
        """
        return self._decide(messages_per_model)

    def _decide(self, messages_per_model: dict[str, list[dict]]) -> ConsensusOutcome:
        t0 = time.monotonic()
        cfg = self.config
        outcome = ConsensusOutcome(status="ok")
        if cfg.quality:
            outcome.decide_id = next_decide_id()
        pool = list(cfg.model_pool)
        # Working copy: refinement appends to these, not the caller's lists.
        histories = {m: list(msgs) for m, msgs in messages_per_model.items()}
        acc = EmbedAccumulator()
        # Quality scratch: failure attribution + correction tracking
        # across ALL rounds (outcome.failures only keeps the last
        # round's), and the final clustering for the audit record. Pure
        # observation — nothing here feeds back into control flow.
        failure_kinds: dict[str, dict[str, int]] = {}
        corrected: set[str] = set()
        audit_clusters: list = []
        winner_index: Optional[int] = None

        max_rounds = 1 + max(0, cfg.max_refinement_rounds)
        single_model = len(pool) == 1 and not cfg.force_reflection

        proposals: list[ActionProposal] = []
        round_num = 0
        while round_num < max_rounds:
            round_num += 1
            proposals, failures = self._query_round_impl(
                histories, pool, round_num, outcome)
            _note_failures(failures, failure_kinds, corrected)
            if not proposals:
                outcome.failures = failures
                outcome.status = ("all_failed" if all(
                    f.correction is None for f in failures) else "all_invalid")
                outcome.rounds_used = round_num
                outcome.latency_ms = (time.monotonic() - t0) * 1000
                self._attach_audit(outcome, pool, [], None, acc,
                                   failure_kinds, corrected)
                return outcome

            if single_model:
                break

            clusters = cluster_proposals(proposals, self.backend, acc)
            majority = find_majority_cluster(clusters, len(proposals),
                                             round_num, cfg.threshold)
            self._log("consensus_round", {
                "round": round_num, "clusters": len(clusters),
                "responses": len(proposals), "majority": majority is not None,
                "prefill_ms": round(outcome.prefill_ms, 1),
                "decode_ms": round(outcome.decode_ms, 1),
                "cached_tokens": outcome.cached_tokens})
            # force_reflection: a round-1 majority is not accepted as-is; the
            # pool reviews once before committing (reference consensus.ex
            # single-model/force_reflection refinement, :304-329).
            reflect_first = (cfg.force_reflection and round_num == 1
                             and max_rounds > 1)
            if (majority is not None and not reflect_first) \
                    or round_num >= max_rounds:
                audit_clusters = clusters
                winner_index = clusters.index(
                    select_winner_cluster(clusters, majority)[0])
                outcome.decision = pick_winner(clusters, len(proposals),
                                               round_num, majority,
                                               self.backend, acc)
                break

            # No accepted majority: append refinement prompt + own response
            # per model; failed models get their correction feedback so the
            # next round doesn't replay the identical prompt.
            for p in proposals:
                own_prompt = build_refinement_prompt(
                    clusters, p, round_num + 1, cfg.max_refinement_rounds)
                h = histories.setdefault(p.model_spec, [])
                h.append({"role": "assistant", "content": p.raw_text})
                h.append({"role": "user", "content": own_prompt})
                rh = outcome.refinement_history.setdefault(p.model_spec, [])
                rh.append((own_prompt, p.raw_text))
                del rh[:-REASONING_WINDOW_ROUNDS]
            for f in failures:
                if f.correction is None:
                    continue
                h = histories.setdefault(f.model_spec, [])
                if f.raw_text:
                    h.append({"role": "assistant", "content": f.raw_text})
                h.append({"role": "user", "content": f.correction})

        if outcome.decision is None:
            # Single-model fast path (reference consensus.ex:267-275 analog):
            # the lone valid proposal IS the decision, full confidence.
            clusters = cluster_proposals(proposals, self.backend, acc)
            majority = find_majority_cluster(clusters, len(proposals), 1,
                                             cfg.threshold)
            audit_clusters = clusters
            winner_index = clusters.index(
                select_winner_cluster(clusters, majority)[0])
            outcome.decision = pick_winner(clusters, len(proposals),
                                           round_num, majority,
                                           self.backend, acc)

        outcome.rounds_used = round_num
        outcome.embed_texts = acc.texts
        outcome.latency_ms = (time.monotonic() - t0) * 1000
        self._attach_audit(outcome, pool, audit_clusters, winner_index, acc,
                           failure_kinds, corrected)
        return outcome

    def _attach_audit(self, outcome: ConsensusOutcome, pool: list[str],
                      clusters: list, winner_index: Optional[int],
                      acc: EmbedAccumulator,
                      failure_kinds: dict[str, dict[str, int]],
                      corrected: set[str]) -> None:
        """Build the per-decide audit record once the outcome is final.
        Gated by ``ConsensusConfig.quality``; reads only what the decide
        already computed."""
        cfg = self.config
        if not cfg.quality:
            return
        outcome.audit = build_audit_record(
            task_id=cfg.task_id, agent_id=cfg.session_key, pool=pool,
            outcome=outcome, clusters=clusters, winner_index=winner_index,
            sim_margins=acc.margins, failure_counts=failure_kinds,
            corrected=corrected, decide_id=outcome.decide_id)

    # ------------------------------------------------------------------

    def _query_round_impl(self, histories: dict[str, list[dict]],
                          pool: list[str], round_num: int,
                          outcome: ConsensusOutcome,
                          ) -> tuple[list[ActionProposal], list[ModelFailure]]:
        """One round = query + parse + validate."""
        cfg = self.config
        requests = [
            QueryRequest(
                model_spec=m,
                # Snapshot: refinement mutates histories after the request is
                # built; a live reference would retro-edit recorded calls.
                messages=list(histories.get(m, [])),
                temperature=temperature_for_round(
                    m, round_num, cfg.max_refinement_rounds),
                max_tokens=cfg.max_tokens,
                session_id=cfg.session_key,
                constrain_json=cfg.constrained_json,
                # Schema-aware grammar: a constrained row cannot name an
                # action outside the capability-gated set — the validator
                # keeps the params check.
                action_enum=(tuple(sorted(cfg.allowed_actions))
                             if cfg.constrained_json and cfg.allowed_actions
                             else None),
                priority=cfg.priority,
                tenant=cfg.tenant,
                deadline_ms=cfg.deadline_ms,
                task_id=cfg.task_id,
                decide=outcome.decide_id,
                tree=cfg.tree,
            )
            for m in pool
        ]
        results = self.backend.query(requests)

        proposals: list[ActionProposal] = []
        failures: list[ModelFailure] = []
        for res in results:
            outcome.prompt_tokens += res.usage.prompt_tokens
            outcome.completion_tokens += res.usage.completion_tokens
            outcome.cost += res.usage.cost
            outcome.prefill_ms += getattr(res, "prefill_ms", 0.0)
            outcome.decode_ms += getattr(res, "decode_ms", 0.0)
            outcome.cached_tokens += getattr(res, "cached_tokens", 0)
            outcome.spec_rounds += getattr(res, "spec_rounds", 0)
            outcome.spec_accepted_tokens += getattr(
                res, "spec_accepted_tokens", 0)
            chip = getattr(res, "chip_ms", 0.0)
            if chip:
                outcome.chip_ms += chip
                outcome.member_chip_ms[res.model_spec] = \
                    outcome.member_chip_ms.get(res.model_spec, 0.0) + chip
            outcome.member_latency_ms[res.model_spec] = \
                outcome.member_latency_ms.get(res.model_spec, 0.0) \
                + getattr(res, "latency_ms", 0.0)
            if not res.ok:
                # A deadline-expired row ("deadline_exceeded:" error) is a
                # MEMBER miss: no correction feedback (the model never
                # answered), and the other members' proposals carry the
                # round. Only when EVERY member misses does the round
                # degrade to all_failed.
                deadline = res.error.startswith("deadline_exceeded")
                if deadline:
                    outcome.deadline_misses += 1
                failures.append(ModelFailure(
                    res.model_spec, res.error,
                    kind="deadline" if deadline else "transport"))
                continue
            parsed = parse_response(res.model_spec, res.text)
            if isinstance(parsed, ParseFailure):
                failures.append(ModelFailure(
                    res.model_spec, parsed.error,
                    correction=f"Your previous response was invalid: "
                               f"{parsed.error}. Respond with a single JSON "
                               f'object {{"action", "params", "reasoning", '
                               f'"wait"}}.',
                    raw_text=res.text,
                    kind="parse"))
                continue
            errors = validate_params(
                parsed.action, parsed.params,
                allowed_actions=cfg.allowed_actions,
                profile_optional=cfg.profile_optional_spawn)
            wait_error = validate_wait_param(parsed.action, parsed.wait)
            if wait_error:
                errors.append(wait_error)
            if errors:
                failures.append(ModelFailure(
                    res.model_spec,
                    f"invalid {parsed.action} params: " + "; ".join(errors),
                    correction="Your previous response failed validation: "
                               + "; ".join(errors)
                               + ". Correct the parameters and respond again.",
                    raw_text=res.text,
                    kind="schema"))
                continue
            if parsed.condense:
                outcome.condense_requests[parsed.model_spec] = parsed.condense
            if parsed.bug_report:
                outcome.bug_reports.append((parsed.model_spec, parsed.bug_report))
            proposals.append(parsed)

        outcome.proposals = proposals
        outcome.failures = failures
        return proposals, failures
