"""Offline acceptance evaluation: the promotion evidence (port of
``quoracle_tpu/training/evaluate.py``).

A candidate draft is judged the way production will judge it — a
held-out slice of captured contexts is replayed through the REAL
:meth:`GenerateEngine.verify_chunk` path (the ragged kernel on the
unified tier, under ``no_grad``): the draft proposes greedily from its own
paged sessions, the target verifies the chunk exactly as
``BatchedSpeculator.run_round`` would, and the accepted-prefix length is
the score. No proxy metric (loss, perplexity) stands in for the quantity
the fleet actually monetizes.

Replay is UNCONSTRAINED greedy: the captured round's grammar state is
not part of the record (it is derived serving state), and candidate vs
incumbent are compared on identical terms against the same live target
engine, so the comparison — the only thing the gate consumes — is
exact. Greedy-equality sanity runs the full speculative loop
(:class:`BatchedSpeculator` on a local row shim) against vanilla
engine decode: a candidate that diverges at temp 0 is broken at the
algorithm level and never promotes, whatever its acceptance.
"""

from __future__ import annotations

import statistics
from typing import Optional, Sequence

from quoracle_tpu_torch.infra.telemetry import TRAIN_EVAL_ACCEPTANCE


def _pct(xs: Sequence[float], q: float) -> float:
    ys = sorted(xs)
    if not ys:
        return 0.0
    idx = min(len(ys) - 1, int(round(q * (len(ys) - 1))))
    return ys[idx]


def replay_acceptance(target_engine, draft_engine, examples, *,
                      max_k: int = 8, batch: int = 8,
                      session_prefix: str = "flywheel-eval") -> dict:
    """Replay captured contexts: the draft proposes up to the round's
    original chunk length (capped at ``max_k``), the target verifies in
    one chunk, acceptance = accepted prefix / proposed. Sessions are
    created per example and dropped after — the engines' stores end
    exactly as they started."""
    eos = draft_engine.cfg.eos_token_id
    rates: list[float] = []
    todo = [rec for rec in examples
            if rec.get("kind") == "spec_round" and rec.get("ctx")
            and rec.get("proposal")]
    for lo in range(0, len(todo), batch):
        chunk = todo[lo:lo + batch]
        ctxs = [list(r["ctx"]) for r in chunk]
        k_req = [max(1, min(max_k, len(r["proposal"]))) for r in chunk]
        sids = [f"{session_prefix}-{lo + i}" for i in range(len(chunk))]
        n = len(chunk)
        try:
            drafts = draft_engine.generate(
                ctxs, temperature=0.0, top_p=1.0, max_new_tokens=k_req,
                session_ids=sids, constrain_json=[False] * n,
                action_enums=[None] * n, initial_json_state=[None] * n)
            proposals = []
            for g, kq in zip(drafts, k_req):
                p = list(g.token_ids)
                if g.finish_reason == "stop" and len(p) < kq:
                    p.append(eos)
                proposals.append(p or [eos])
            vres = target_engine.verify_chunk(
                [c + p[:-1] for c, p in zip(ctxs, proposals)], sids,
                [len(p) for p in proposals],
                temperature=[0.0] * n, constrain_json=[False] * n,
                action_enums=[None] * n, initial_json_state=[None] * n,
                need_probs=False)
            for props, v in zip(proposals, vres):
                ids = v["ids"]
                j = 0
                for t, d in enumerate(props):
                    if d != int(ids[t]):
                        break
                    j += 1
                rates.append(j / max(1, len(props)))
        finally:
            for sid in sids:
                draft_engine.drop_session(sid)
                target_engine.drop_session(sid)
    return {
        "n": len(rates),
        "p50": round(_pct(rates, 0.50), 4),
        "p95": round(_pct(rates, 0.95), 4),
        "mean": round(statistics.fmean(rates), 4) if rates else 0.0,
    }


def compare(target_engine, incumbent_engine, candidate_engine,
            examples, *, max_k: int = 8, batch: int = 8) -> dict:
    """Candidate vs incumbent on the SAME held-out slice against the
    SAME target engine. The per-role acceptance gauges land so a
    dashboard sees the evidence the gate saw."""
    model = target_engine.cfg.name
    report = {"model": model}
    for role, engine in (("incumbent", incumbent_engine),
                         ("candidate", candidate_engine)):
        stats = replay_acceptance(target_engine, engine, examples,
                                  max_k=max_k, batch=batch,
                                  session_prefix=f"flywheel-{role}")
        report[role] = stats
        for stat in ("p50", "p95", "mean"):
            TRAIN_EVAL_ACCEPTANCE.set(stats[stat], model=model,
                                      role=role, stat=stat)
    report["margin_p50"] = round(
        report["candidate"]["p50"] - report["incumbent"]["p50"], 4)
    return report


# ---------------------------------------------------------------------------
# Greedy-equality sanity: the full speculative loop vs vanilla decode
# ---------------------------------------------------------------------------


class _EvalRow:
    """The scheduler-row shape ``BatchedSpeculator.run_round`` drives."""

    __slots__ = ("prompt", "emitted", "temperature", "top_p", "max_new",
                 "session_id", "constrain", "action_enum", "json_state",
                 "spec_rounds", "spec_drafted", "spec_accepted",
                 "chip_ms", "n_cached_first")

    def __init__(self, prompt: list, max_new: int, session_id: str):
        self.prompt = list(prompt)
        self.emitted: list = []
        self.temperature = 0.0
        self.top_p = 1.0
        self.max_new = max_new
        self.session_id = session_id
        self.constrain = False
        self.action_enum = None
        self.json_state: Optional[int] = None
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.chip_ms = 0.0
        self.n_cached_first: Optional[int] = None


def greedy_equal(target_engine, draft_engine, prompts, *, k: int = 4,
                 max_new: int = 32,
                 session_prefix: str = "flywheel-sanity") -> bool:
    """True iff speculative temp-0 decode with this draft is
    bit-identical to vanilla engine decode on every prompt — the
    correctness gate a candidate must pass regardless of acceptance."""
    from quoracle_tpu_torch.models.speculative import BatchedSpeculator
    spec = BatchedSpeculator(target_engine, draft_engine, k=k,
                             accept_floor=0.0)
    ok = True
    for i, prompt in enumerate(prompts):
        want = target_engine.generate([list(prompt)], temperature=0.0,
                                      max_new_tokens=max_new)[0]
        sid = f"{session_prefix}-{i}"
        row = _EvalRow(prompt, max_new, sid)
        try:
            while len(row.emitted) < max_new:
                finishes = spec.run_round([row])
                if finishes[id(row)] == "stop":
                    break
        finally:
            spec.drop_session(sid)
            target_engine.drop_session(sid)
        if row.emitted != list(want.token_ids):
            ok = False
    return ok
