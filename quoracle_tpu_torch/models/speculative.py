"""Speculative decoding (port of ``quoracle_tpu/models/speculative.py``): a
draft model proposes K tokens, the target model verifies them in ONE chunk
forward.

Algorithm (leapfrog variant, no bonus token — keeps draft and target
caches in lockstep):

  invariant   ctx = prompt + emitted; BOTH caches hold KV for ctx[:-1];
              ``pending`` = ctx[-1], not yet forwarded by either model.
  propose     the draft runs K steps from ``pending``: d_1..d_K with
              per-step draft probs q_i (its cache advances K steps,
              through d_{K-1}).
  verify      the target runs ONE chunk [pending, d_1..d_{K-1}] -> p_1..p_K
              (p_i is the target distribution d_i was proposed against;
              its cache advances the same K steps).
  accept      greedy rows: d_i accepted while d_i == argmax(p_i).
              sampled rows: d_i accepted with prob min(1, p_i[d_i] /
              q_i[d_i]); on rejection the correction is drawn from the
              residual max(0, p_i - q_i) renormalized, which keeps the
              target's output distribution.
  commit      j accepted -> emit d_1..d_j (+ the correction when j < K);
              roll BOTH caches back to len(ctx') - 1 by shrinking ``lens``
              (KV past lens is masked and later overwritten in place);
              pending' = d_K on full accept, else the correction.

Greedy (temperature 0) output equals vanilla decode: every accepted d_i
equals argmax(p_i) and every correction IS argmax(p_i).
Grammar-constrained speculation proposes under the same token-DFA mask
the engine decodes with, and the verify pass masks p_i with the state in
effect at that position.

Two integrations, as in the JAX package:

* :class:`SpeculativeDecoder` — batch 1 over its own dense caches (the
  baton-mode backend's path for a single uncontended text row). Prefill
  and session extension go through ``prefill``/``prefill_chunk`` (the
  flash kernel for chunks of at least 256 tokens on the card); the draft
  runs an eager loop of K steps and the verify chunk is one forward.
* :class:`BatchedSpeculator` — rounds over the continuous batcher's live
  rows on the two engines' paged session stores: one batched
  ``draft.generate`` and one ``target.verify_chunk`` (the ragged kernel
  on the unified tier) per round, adaptive K with vanilla fallback.

The draft and the target must share one tokenizer and vocab, and both
must use full attention. The speculator declares the rows' chip-ms keys
before each engine call (``costobs``), adds each call's charge to the
rows, and records re-probes and disengages in the flight recorder. Left
out of this copy: the training-flywheel capture of rounds (``CAPTURE``,
``spec_example``; Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from quoracle_tpu_torch.infra import costobs
from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.telemetry import (
    SPEC_ACCEPTANCE, SPEC_ACCEPTED, SPEC_DRAFTED, SPEC_ENGAGED,
    SPEC_FALLBACK_TOTAL, SPEC_K, SPEC_ROUNDS, SPEC_TOKENS_PER_ROUND,
)
from quoracle_tpu_torch.models.config import ModelConfig
from quoracle_tpu_torch.models.generate import (
    grammar_mask, prefill, prefill_chunk,
)
from quoracle_tpu_torch.models.sampling import sample_tokens
from quoracle_tpu_torch.models.transformer import (
    KVCache, Transformer, forward_hidden, init_cache, project_logits,
)


def _row_keys(rows) -> list:
    """Chip-ms attribution keys for batcher rows: integer QoS priorities
    render as class names, the budget plane's vocabulary."""
    from quoracle_tpu_torch.serving.qos import class_name
    return [(str(getattr(r, "tenant", None) or "-"),
             class_name(getattr(r, "priority", 1)),
             str(getattr(r, "task_id", None) or "-"),
             str(getattr(r, "decide", None) or "-")) for r in rows]


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass
class SpecResult:
    token_ids: list
    text: str
    n_prompt_tokens: int
    n_gen_tokens: int
    latency_s: float
    finish_reason: str
    rounds: int                  # speculative rounds executed
    drafted: int                 # draft tokens proposed in total
    accepted: int                # draft tokens accepted in total
    n_cached_tokens: int = 0     # session-resident prefix reused

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(1, self.drafted)

    @property
    def tokens_per_round(self) -> float:
        return self.n_gen_tokens / max(1, self.rounds)


class SpeculativeDecoder:
    """Draft/verify decoder over two models sharing one tokenizer, batch
    1, with dense caches of its own. ``target_params``/``draft_params``
    are the port's Transformers (on one device, the decoder's); ``k`` is
    the draft length per round. ``seed`` seeds the ``torch.Generator``
    the draft samples from and the host generator of sampled acceptance.
    Not thread-safe: callers that share a decoder serialize through
    ``lock`` (the baton-mode backend try-acquires it and falls back to
    its batcher on contention)."""

    def __init__(self, target_cfg: ModelConfig, target_params: Transformer,
                 draft_cfg: ModelConfig, draft_params: Transformer,
                 tokenizer, *, k: int = 6, max_seq: int = 2048,
                 seed: int = 0, cache_dtype: Optional[torch.dtype] = None):
        if target_cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError("draft and target must share one "
                             "tokenizer/vocab")
        if (target_cfg.sliding_window is not None
                or draft_cfg.sliding_window is not None):
            raise ValueError("speculative decoding requires full attention "
                             "(no sliding window)")
        self.tc, self.tp = target_cfg, target_params
        self.dc, self.dp = draft_cfg, draft_params
        self.tokenizer = tokenizer
        self.k = int(k)
        self.max_seq = max_seq
        self.device = target_params.final_norm.device
        # each model's cache takes its params' dtype, as the engine's does
        self.t_cache_dtype = (cache_dtype if cache_dtype is not None
                              else target_params.dtype)
        self.d_cache_dtype = (cache_dtype if cache_dtype is not None
                              else draft_params.dtype)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self.lock = named_lock("spec.decoder")
        self._sessions: dict = {}
        self._grammar_cache: dict = {}

    # ------------------------------------------------------------------

    def _model(self, which: str):
        if which == "t":
            return self.tp, self.tc, self.t_cache_dtype
        return self.dp, self.dc, self.d_cache_dtype

    def _prefill(self, which: str, tokens, lens, cache_len: int) -> KVCache:
        params, cfg, dt = self._model(which)
        cache = init_cache(cfg, 1, cache_len, self.device, dtype=dt)
        return prefill(params, cfg, tokens, lens, cache)[1]

    def _extend(self, which: str, cache: KVCache, tokens,
                chunk_lens) -> KVCache:
        """Session resume: forward a right-padded suffix chunk on top of
        the resident prefix (``prefill_chunk`` at prefix = cache.lens)."""
        params, cfg, _ = self._model(which)
        return prefill_chunk(params, cfg, tokens, cache.lens, chunk_lens,
                             cache)[1]

    @torch.no_grad()
    def _draft_steps(self, cache: KVCache, pending, generator, temperature,
                     top_p, json_table, jstate0, greedy: bool):
        """K autoregressive draft steps from ``pending``. Returns (d_tokens
        [K], q_probs [K, V] or None for greedy, cache): step i forwards the
        previous token, samples d_i from the draft distribution —
        grammar-masked under ``json_table`` (the proposal distribution IS
        the masked one, so acceptance stays exact). The cache advances K
        positions, through d_{K-1}, matching the verify chunk."""
        params, cfg = self.dp, self.dc
        eos = self.tc.eos_token_id
        tok, jstate = pending, jstate0
        toks, qs = [], []
        for _ in range(self.k):
            pos = cache.lens[:, None]
            hidden, cache = forward_hidden(
                params, cfg, tok[:, None], pos, cache,
                write_offset=cache.lens, kv_lens=cache.lens + 1)
            cache.lens = cache.lens + 1
            logits = project_logits(params, cfg, hidden)[:, 0, :].float()
            if json_table is not None:
                logits = grammar_mask(logits, jstate, json_table, eos)
            nxt = sample_tokens(logits, generator, temperature, top_p)
            if not greedy:
                q = torch.softmax(
                    logits / torch.clamp(temperature, min=1e-6)[:, None],
                    dim=-1)
                # greedy rows draft greedily: a one-hot q keeps the
                # acceptance rule exact (accept iff d_i == argmax p_i)
                hot = torch.nn.functional.one_hot(
                    nxt.long(), logits.shape[-1]).to(q.dtype)
                qs.append(torch.where((temperature <= 0)[:, None], hot,
                                      q)[0])
            if json_table is not None:
                jstate = torch.where(
                    jstate >= 0,
                    json_table[torch.clamp(jstate, min=0).long(),
                               nxt.long()].to(torch.int32), jstate)
            toks.append(nxt)
            tok = nxt
        return (torch.cat(toks), None if greedy else torch.stack(qs),
                cache)

    @torch.no_grad()
    def _verify(self, cache: KVCache, chunk, temperature, json_table,
                jstate0, greedy: bool):
        """One target pass over [pending, d_1..d_{K-1}] -> (probs [K, V]
        or None for greedy, argmax ids [K], cache advanced K positions).
        Under a grammar the per-position states walk from ``jstate0`` over
        the draft tokens (chunk[1:]), so the mask at p_i equals the one
        vanilla decode applies at that position."""
        params, cfg = self.tp, self.tc
        K = self.k
        lens0 = cache.lens
        positions = (lens0[:, None]
                     + torch.arange(K, dtype=torch.int32,
                                    device=chunk.device)[None, :])
        hidden, cache = forward_hidden(
            params, cfg, chunk[None, :], positions, cache,
            write_offset=lens0, kv_lens=lens0 + K)
        cache.lens = lens0 + K
        logits = project_logits(params, cfg, hidden)[0].float()   # [K, V]
        if json_table is not None:
            s = jstate0[0]
            states = [s]
            for t in range(1, K):
                nxt = json_table[torch.clamp(s, min=0).long(),
                                 chunk[t].long()].to(torch.int32)
                s = torch.where(s >= 0, nxt, s)
                states.append(s)
            logits = grammar_mask(logits, torch.stack(states), json_table,
                                  cfg.eos_token_id)
        argmax_ids = torch.argmax(logits, dim=-1)
        if greedy:
            return None, argmax_ids, cache
        temp = temperature.expand(K)
        probs = torch.softmax(
            logits / torch.clamp(temp, min=1e-6)[:, None], dim=-1)
        hot = torch.nn.functional.one_hot(argmax_ids,
                                          logits.shape[-1]).to(probs.dtype)
        return (torch.where((temp <= 0)[:, None], hot, probs), argmax_ids,
                cache)

    def _grammar(self, action_enum) -> tuple:
        """(numpy table, start state, device table) per enum, cached. One
        DFA serves both models (they share the tokenizer). The key is
        normalized (sorted, deduped) and the cache keeps the newest
        four: a device table is states x vocab int16."""
        key = tuple(sorted(set(action_enum))) if action_enum else None
        if key not in self._grammar_cache:
            from quoracle_tpu_torch.models.constrained import JsonTokenTable
            tt = JsonTokenTable.for_tokenizer(
                self.tokenizer, self.tc.vocab_size, self.tc.eos_token_id,
                extra_stop_ids=tuple(self.tc.stop_token_ids),
                action_enum=list(action_enum) if action_enum else None)
            for old in list(self._grammar_cache)[:max(
                    0, len(self._grammar_cache) - 3)]:
                del self._grammar_cache[old]     # keep newest 3 + this
            self._grammar_cache[key] = (
                tt.table, tt.start_state,
                torch.as_tensor(tt.table, device=self.device))
        return self._grammar_cache[key]

    # ------------------------------------------------------------------

    def drop_session(self, session_id: str) -> None:
        with self.lock:
            self._sessions.pop(session_id, None)

    def session_tokens(self, session_id: str) -> Optional[list]:
        """The session's resident conversation ids, or None — the view
        ``GenerateEngine.session_tokens`` gives, so callers splice the
        next round's prompt the same way against either store. On a
        "length" finish the last emitted token was sampled but never
        forwarded (no KV), and the engine's store-back keeps only ids with
        KV, so the view drops ctx's trailing pending token then (a "stop"
        finish already popped its unforwarded terminal)."""
        with self.lock:
            s = self._sessions.get(session_id)
            if s is None:
                return None
            ctx = s["ctx"]
            return list(ctx[:-1] if s.get("finish") == "length" else ctx)

    def generate(self, prompt, *, max_new_tokens: int = 128,
                 temperature: float = 0.0, top_p: float = 1.0,
                 constrain_json: bool = False, action_enum=None,
                 session_id: Optional[str] = None,
                 generator: Optional[torch.Generator] = None) -> SpecResult:
        t0 = time.monotonic()
        K = self.k
        dev = self.device
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens >= self.max_seq:
            raise ValueError(f"prompt {len(prompt)} + max_new "
                             f"{max_new_tokens} >= max_seq {self.max_seq}")
        if temperature > 0 and top_p < 1.0:
            # the acceptance test needs q to be the ACTUAL proposal
            # distribution, and the nucleus mask is not applied to q
            raise ValueError("speculative decoding supports top_p only in "
                             "greedy mode")
        gen = generator if generator is not None else self._generator
        seed = int(torch.randint(0, 0x7fffffff, (1,), generator=gen,
                                 device=gen.device))
        rng_np = np.random.default_rng(seed)
        greedy = temperature <= 0
        temp = torch.tensor([float(temperature)], dtype=torch.float32,
                            device=dev)
        topp = torch.tensor([float(top_p)], dtype=torch.float32, device=dev)
        if constrain_json:
            tbl_np, jstate, tbl_dev = self._grammar(action_enum)
        else:
            tbl_np, jstate, tbl_dev = None, -1, None

        def put(a):
            return torch.as_tensor(a, device=dev)

        # --- cache resolution: session resume or fresh prefill ----------
        # Session resume: the caches hold ctx[:-1] of the PRIOR call's
        # prompt + response; a new prompt that cleanly extends ctx forwards
        # only the suffix.
        n_cached = 0
        sess = self._sessions.get(session_id) if session_id else None
        need = len(prompt) + max_new_tokens + K + 1
        if sess is not None:
            ctx = sess["ctx"]
            lcp = 0
            for a, b in zip(ctx, prompt):
                if a != b:
                    break
                lcp += 1
            suffix = prompt[len(ctx) - 1:-1]
            # chunk writes clamp their start into the buffer: an
            # overrunning chunk would shift left over valid prefix KV, so
            # the decode chunks (need, with K + 1) and the 64-padded extend
            # chunk must both fit
            fits = (need <= sess["cache_len"]
                    and (len(ctx) - 1 + _round_up(max(1, len(suffix)), 64)
                         <= sess["cache_len"]))
            if lcp == len(ctx) and len(prompt) >= len(ctx) and fits:
                tcache, dcache = sess["t"], sess["d"]
                n_cached = len(ctx)
                # forward ctx[-1] .. prompt[-2] so caches hold prompt[:-1]
                if suffix:
                    sf = np.zeros((1, _round_up(len(suffix), 64)), np.int32)
                    sf[0, :len(suffix)] = suffix
                    cl = put(np.asarray([len(suffix)], np.int32))
                    tcache = self._extend("t", tcache, put(sf), cl)
                    dcache = self._extend("d", dcache, put(sf), cl)
            else:
                sess = None                      # diverged or outgrown
                self._sessions.pop(session_id, None)
        if sess is None:
            # session caches carry decode slack (K + 1) plus the extend pad
            # overhang (63) above max_seq
            cache_len = (_round_up(self.max_seq + K + 64, 128)
                         if session_id else _round_up(need, 128))
            toks = np.zeros((1, _round_up(len(prompt), 64)), np.int32)
            toks[0, :len(prompt)] = prompt
            lens = put(np.asarray([len(prompt)], np.int32))
            # both caches prefill the whole prompt, then roll lens back one
            # so pending = prompt[-1] is un-forwarded; its column is
            # overwritten by the first chunk
            tcache = self._prefill("t", put(toks), lens, cache_len)
            dcache = self._prefill("d", put(toks), lens, cache_len)
            tcache.lens = lens - 1
            dcache.lens = lens - 1
        else:
            cache_len = sess["cache_len"]
        pending = put(np.asarray([prompt[-1]], np.int32))

        stops = {self.tc.eos_token_id, *self.tc.stop_token_ids}
        emitted: list[int] = []
        rounds = drafted = accepted_total = 0
        finish = "length"

        def host_advance(s: int, tok: int) -> int:
            if not constrain_json or s < 0:
                return s
            return int(tbl_np[s, tok])

        while len(emitted) < max_new_tokens:
            rounds += 1
            jstate0 = put(np.asarray([jstate], np.int32))
            d_toks, q_probs, dcache = self._draft_steps(
                dcache, pending, gen, temp, topp, tbl_dev, jstate0, greedy)
            chunk = torch.cat([pending, d_toks[:-1]])
            p_probs, p_am, tcache = self._verify(
                tcache, chunk, temp, tbl_dev, jstate0, greedy)
            d = d_toks.cpu().numpy()
            if greedy:
                # greedy needs only the [K] argmax ids: accepted drafts
                # equal them and corrections ARE them
                pam = p_am.cpu().numpy()
                q = p = None
            else:
                q = q_probs.cpu().numpy()
                p = p_probs.cpu().numpy()
                pam = None
            drafted += K

            j = 0
            correction: Optional[int] = None
            while j < K:
                di = int(d[j])
                if greedy:
                    ok = di == int(pam[j])
                else:
                    ok = rng_np.random() < min(
                        1.0, float(p[j, di]) / max(float(q[j, di]), 1e-20))
                if not ok:
                    if greedy:
                        correction = int(pam[j])
                    else:
                        residual = np.maximum(p[j] - q[j], 0.0)
                        tot = residual.sum()
                        correction = (int(np.argmax(p[j])) if tot <= 0
                                      else int(rng_np.choice(
                                          residual.shape[0],
                                          p=residual / tot)))
                    break
                j += 1
            accepted_total += j

            new_tokens = [int(x) for x in d[:j]]
            if correction is not None:
                new_tokens.append(correction)
            # commit: truncate at stop/max_new, roll caches to ctx'[:-1].
            # The budget cut applies FIRST: a stop token just past max_new
            # is cut away and reports "length", as vanilla decode's
            # row_limit would
            cut = len(new_tokens)
            stop_at = None
            for idx, t in enumerate(new_tokens):
                if t in stops:
                    stop_at = idx
                    cut = idx + 1
                    break
            room = max_new_tokens - len(emitted)
            cut = min(cut, room)
            if stop_at is not None and stop_at < cut:
                finish = "stop"
            new_tokens = new_tokens[:cut]
            emitted.extend(new_tokens)
            for t in new_tokens:
                jstate = host_advance(jstate, t)
            if finish == "stop" or len(emitted) >= max_new_tokens:
                break
            # lens' = len(ctx') - 1; ctx' grew by len(new_tokens)
            new_lens = put(np.asarray(
                [len(prompt) + len(emitted) - 1], np.int32))
            tcache.lens = new_lens
            dcache.lens = new_lens
            pending = put(np.asarray([emitted[-1]], np.int32))

        # engine parity: the terminal stop token is popped from the output
        if emitted and emitted[-1] in stops:
            emitted.pop()
            finish = "stop"
        if session_id and emitted:
            # store at the invariant: caches hold ctx'[:-1]
            ctx_out = prompt + emitted
            norm = put(np.asarray([len(ctx_out) - 1], np.int32))
            tcache.lens = norm
            dcache.lens = norm
            # LRU: pop-then-reinsert moves a re-stored session to the end
            self._sessions.pop(session_id, None)
            for old in list(self._sessions)[:max(
                    0, len(self._sessions) - 7)]:
                self._sessions.pop(old)          # bound: newest 7 + this
            self._sessions[session_id] = {
                "t": tcache, "d": dcache, "ctx": ctx_out,
                "cache_len": cache_len, "finish": finish,
            }
        return SpecResult(
            token_ids=emitted,
            text=self.tokenizer.decode(emitted),
            n_prompt_tokens=len(prompt),
            n_gen_tokens=len(emitted),
            latency_s=time.monotonic() - t0,
            finish_reason=finish,
            rounds=rounds,
            drafted=drafted,
            accepted=accepted_total,
            n_cached_tokens=n_cached,
        )


# ---------------------------------------------------------------------------
# Batched speculation for the continuous serving path
# ---------------------------------------------------------------------------


class BatchedSpeculator:
    """Draft/verify decoding over the ContinuousBatcher's live rows.

    Where :class:`SpeculativeDecoder` owns a private batch-1 dense cache,
    this works on the two engines' PAGED SESSION stores — the KV the plain
    continuous path uses — so rows can mix speculative and vanilla ticks
    freely and nothing is resident twice:

      propose   ``draft.generate`` over every eligible row's context in
                ONE batched call (greedy, grammar-masked; the draft's own
                sessions track ctx, so each round forwards one suffix
                token + K draft steps);
      verify    ``target.verify_chunk``: ONE teacher-forced chunk forward
                per round across all rows against the target's paged
                session KV, returning per-position grammar-masked argmax
                (greedy rows) and masked softmax probs (sampled rows);
      commit    host-side accept/rollback per row. Rollback is free: both
                engines resume sessions by longest common prefix, so a
                rejected draft's stale KV is overwritten by the next
                round's suffix prefill.

    Greedy rows accept d_i iff d_i == argmax(p_i), so temperature-0
    output equals vanilla decode. Sampled rows (top_p == 1 only) draft
    greedily (q = one-hot): accept d_i with prob p_i[d_i], else draw the
    correction from p_i with d_i's mass removed, renormalized.

    ADAPTIVE K (per member): an EWMA of per-round acceptance shrinks K
    toward ``k_min`` below ``shrink_below``, grows it toward ``k_max``
    above ``grow_above``, and DISENGAGES to vanilla decode below
    ``accept_floor`` (after 3 rounds of evidence); ``reprobe_after``
    vanilla ticks later the member re-probes at ``k_min``. The state
    exports as the ``quoracle_spec_*`` instruments.

    ``run_round`` is not thread-safe (the batcher's single worker thread
    owns it); ``stats()`` and the eligibility reads are lock-guarded.
    """

    def __init__(self, target_engine, draft_engine, *, k: int = 6,
                 k_min: int = 2, k_max: int = 8,
                 accept_floor: float = 0.35, shrink_below: float = 0.6,
                 grow_above: float = 0.85, ewma_alpha: float = 0.15,
                 reprobe_after: int = 24, seed: int = 0):
        if target_engine.cfg.vocab_size != draft_engine.cfg.vocab_size:
            raise ValueError("draft and target must share one "
                             "tokenizer/vocab")
        if (target_engine.cfg.sliding_window is not None
                or draft_engine.cfg.sliding_window is not None):
            raise ValueError("speculative serving requires full attention "
                             "(no sliding window)")
        self.target = target_engine
        self.draft = draft_engine
        self.model = target_engine.cfg.name
        self.k_init = max(1, int(k))
        self.k_min = max(1, min(int(k_min), self.k_init))
        self.k_max = max(self.k_init, int(k_max))
        self.accept_floor = float(accept_floor)
        self.shrink_below = float(shrink_below)
        self.grow_above = float(grow_above)
        self.ewma_alpha = float(ewma_alpha)
        self.reprobe_after = int(reprobe_after)
        self._rng_np = np.random.default_rng(seed)
        self._lock = named_lock("spec.adaptive")
        self._k = self.k_init
        self._engaged = True
        self._ewma: Optional[float] = None
        self._vanilla_ticks = 0            # ticks since disengage
        self._rounds_since_probe = 0       # evidence behind the EWMA
        self._stops = {target_engine.cfg.eos_token_id,
                       *target_engine.cfg.stop_token_ids}
        # cumulative counters (stats() snapshot)
        self.rounds = 0
        self.drafted = 0
        self.accepted = 0
        self.emitted = 0
        self.disengages = 0
        self.reprobes = 0
        self.fallbacks: dict = {}
        self._tables: dict = {}            # enum key -> (np table, start)
        SPEC_K.set(self._k, model=self.model)
        SPEC_ENGAGED.set(1.0, model=self.model)

    # -- eligibility ----------------------------------------------------

    @property
    def k(self) -> int:
        return self._k

    @property
    def engaged(self) -> bool:
        return self._engaged

    def ineligible_reason(self, ctx_len: int, temperature: float,
                          top_p: float) -> Optional[str]:
        """None when a row of this shape may speculate this tick, else
        the fallback reason (the batcher counts it via note_fallback)."""
        if not self._engaged:
            return "disengaged"
        if temperature > 0 and top_p < 1.0:
            # the acceptance test needs the ACTUAL proposal and target
            # distributions; the nucleus mask is applied to neither
            return "sampling"
        if (ctx_len + self._k + 1 >= self.target.max_seq
                or ctx_len + self._k + 1 >= self.draft.max_seq):
            # the verify prompt (ctx + K - 1) and the draft's decode slack
            # must both fit: rows this close to the window decode vanilla
            # and retire at the edge
            return "window"
        return None

    def note_fallback(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + n
        SPEC_FALLBACK_TOTAL.inc(n, model=self.model, reason=reason)

    def tick_vanilla(self) -> None:
        """Count one disengaged tick; re-probe after ``reprobe_after``."""
        with self._lock:
            if self._engaged:
                return
            self._vanilla_ticks += 1
            if self._vanilla_ticks < self.reprobe_after:
                return
            self._engaged = True
            self._k = self.k_min
            self._ewma = None              # fresh measurement window
            self._rounds_since_probe = 0
            self.reprobes += 1
        SPEC_ENGAGED.set(1.0, model=self.model)
        SPEC_K.set(self._k, model=self.model)
        FLIGHT.record("spec_reprobe", model=self.model, k=self.k_min)

    def drop_session(self, session_id: str) -> None:
        """Release the DRAFT engine's session for a retired row (the
        target session is dropped by the batcher as usual)."""
        self.draft.drop_session(session_id)

    def swap_draft(self, new_engine):
        """Hot-swap the draft engine and return the incumbent. Safe
        mid-serving: draft KV is derived state, so each row's next round
        cold-prefills its context into the new draft. The adaptive state
        resets to a fresh window (k_init, no EWMA)."""
        if new_engine.cfg.vocab_size != self.target.cfg.vocab_size:
            raise ValueError("draft and target must share one "
                             "tokenizer/vocab")
        if new_engine.cfg.sliding_window is not None:
            raise ValueError("speculative serving requires full attention")
        with self._lock:
            old = self.draft
            self.draft = new_engine
            self._k = self.k_init
            self._engaged = True
            self._ewma = None
            self._vanilla_ticks = 0
            self._rounds_since_probe = 0
            self._tables = {}
        SPEC_K.set(self._k, model=self.model)
        SPEC_ENGAGED.set(1.0, model=self.model)
        return old

    # -- the round ------------------------------------------------------

    def _host_table(self, action_enum) -> tuple:
        """(numpy transition table, start state) for host-side grammar
        walks, read from the TARGET engine's own table cache so the walk
        can never drift from what the device applied."""
        key = tuple(sorted(set(action_enum))) if action_enum else None
        hit = self._tables.get(key)
        if hit is None:
            self.target._json_table_device((key,))     # ensure built
            tt = self.target._json_cache[("one", key)]
            for old in list(self._tables)[:max(0, len(self._tables) - 7)]:
                del self._tables[old]                   # keep newest 7 + 1
            hit = self._tables[key] = (tt.table, tt.start_state)
        return hit

    def run_round(self, rows) -> dict:
        """One draft/verify round over ``rows`` (the batcher's _Rows).
        Mutates each row's emitted tokens, grammar state and spec counters
        in place and returns {id(row): "stop" | None}; "stop" rows hit a
        stop token and must retire. Raises on an engine failure (the
        batcher then decodes the rows vanilla for the tick)."""
        K = self._k
        eos = self.draft.cfg.eos_token_id
        ctxs = [list(r.prompt) + list(r.emitted) for r in rows]
        k_req = [max(1, min(K, r.max_new - len(r.emitted))) for r in rows]
        # chip-ms keys: the active set shrinks between rounds, so they
        # are declared per engine call (one declaration, one call)
        costobs.set_row_keys(_row_keys(rows))
        drafts = self.draft.generate(
            ctxs, temperature=0.0, top_p=1.0, max_new_tokens=k_req,
            session_ids=[r.session_id for r in rows],
            constrain_json=[bool(r.constrain) for r in rows],
            action_enums=[r.action_enum for r in rows],
            initial_json_state=[r.json_state for r in rows])
        proposals = []
        for r, g, kq in zip(rows, drafts, k_req):
            r.chip_ms = getattr(r, "chip_ms", 0.0) + g.chip_ms
            p = list(g.token_ids)
            if g.finish_reason == "stop" and len(p) < kq:
                # the engine pops the terminal stop id; re-propose A stop
                # (eos): if the target wants another stop id, the verify
                # correction supplies it
                p.append(eos)
            proposals.append(p or [eos])
        need_probs = any(r.temperature > 0 for r in rows)
        costobs.set_row_keys(_row_keys(rows))
        vres = self.target.verify_chunk(
            [c + p[:-1] for c, p in zip(ctxs, proposals)],
            [r.session_id for r in rows],
            [len(p) for p in proposals],
            temperature=[r.temperature for r in rows],
            constrain_json=[bool(r.constrain) for r in rows],
            action_enums=[r.action_enum for r in rows],
            initial_json_state=[r.json_state for r in rows],
            need_probs=need_probs)

        finishes: dict = {}
        drafted = accepted = committed_total = 0
        for r, props, v in zip(rows, proposals, vres):
            ids, probs = v["ids"], v["probs"]
            r.chip_ms = getattr(r, "chip_ms", 0.0) + v.get("chip_ms", 0.0)
            if r.n_cached_first is None:
                r.n_cached_first = v["n_cached"]
            j = 0
            correction: Optional[int] = None
            greedy = r.temperature <= 0
            for t, d in enumerate(props):
                if greedy:
                    ok = d == ids[t]
                else:
                    # one-hot proposal: accept with prob p_t[d]
                    ok = self._rng_np.random() < float(probs[t, d])
                if not ok:
                    if greedy:
                        correction = int(ids[t])
                    else:
                        resid = np.asarray(probs[t], np.float64).copy()
                        resid[d] = 0.0
                        z = resid.sum()
                        correction = (int(ids[t]) if z <= 0 else
                                      int(self._rng_np.choice(
                                          resid.shape[0], p=resid / z)))
                    break
                j += 1
            drafted += len(props)
            accepted += j
            new_tokens = props[:j]
            if correction is not None:
                new_tokens = new_tokens + [correction]
            # stop/budget cut: the budget cut applies FIRST, so a stop
            # landing past max_new reports "length" as vanilla would
            cut = len(new_tokens)
            stop_at = None
            for idx, t in enumerate(new_tokens):
                if t in self._stops:
                    stop_at = idx
                    cut = idx + 1
                    break
            room = r.max_new - len(r.emitted)
            cut = min(cut, room)
            finish = None
            if stop_at is not None and stop_at < cut:
                finish = "stop"
            out_tokens = new_tokens[:cut]
            if finish == "stop":
                out_tokens = out_tokens[:-1]   # engine parity: stop popped
            r.emitted.extend(out_tokens)
            committed_total += len(out_tokens)
            r.spec_rounds += 1
            r.spec_drafted += len(props)
            r.spec_accepted += j
            if r.constrain and out_tokens:
                table, start = self._host_table(r.action_enum)
                s = r.json_state if (r.json_state is not None
                                     and r.json_state >= 0) else start
                for t in out_tokens:
                    if s >= 0:
                        s = int(table[s, t])
                r.json_state = s
            finishes[id(r)] = finish
            # (the JAX speculator copies each row's round to the training
            # flywheel's capture plane here: Queue 1 item 11)

        with self._lock:
            self.rounds += 1
            self.drafted += drafted
            self.accepted += accepted
            self.emitted += committed_total
            rate = accepted / max(1, drafted)
            self._ewma = (rate if self._ewma is None else
                          self.ewma_alpha * rate
                          + (1 - self.ewma_alpha) * self._ewma)
            self._rounds_since_probe += 1
            changed = self._adapt_locked()
        SPEC_ROUNDS.inc(model=self.model)
        SPEC_DRAFTED.inc(drafted, model=self.model)
        SPEC_ACCEPTED.inc(accepted, model=self.model)
        SPEC_ACCEPTANCE.observe(rate, model=self.model)
        SPEC_TOKENS_PER_ROUND.observe(committed_total / max(1, len(rows)),
                                      model=self.model)
        if changed:
            SPEC_K.set(self._k, model=self.model)
            SPEC_ENGAGED.set(1.0 if self._engaged else 0.0,
                             model=self.model)
        return finishes

    def _adapt_locked(self) -> bool:
        """Adaptive-K state machine (the caller holds the lock). Returns
        True when K or engagement changed."""
        ewma = self._ewma
        if ewma is None:
            return False
        if ewma < self.accept_floor and self._rounds_since_probe >= 3:
            # acceptance collapse: every round pays draft + verify for ~1
            # token. Disengage; the batcher's vanilla ticks count toward
            # the re-probe
            self._engaged = False
            self._vanilla_ticks = 0
            self._ewma = None
            self.disengages += 1
            k_was, self._k = self._k, self.k_init
            FLIGHT.record("spec_disengage", model=self.model,
                          ewma=round(ewma, 3), k=k_was)
            return True
        if ewma < self.shrink_below and self._k > self.k_min:
            self._k -= 1
            return True
        if ewma > self.grow_above and self._k < self.k_max:
            self._k += 1
            return True
        return False

    # -- observability --------------------------------------------------

    def stats(self) -> dict:
        """Point-in-time snapshot: engagement, K, the EWMA, the counters
        and the fallbacks by reason."""
        with self._lock:
            return {
                "mode": "continuous",
                "draft": self.draft.cfg.name,
                "engaged": self._engaged,
                "k": self._k,
                "k_init": self.k_init,
                "acceptance_ewma": (round(self._ewma, 4)
                                    if self._ewma is not None else None),
                "rounds": self.rounds,
                "drafted_tokens": self.drafted,
                "accepted_tokens": self.accepted,
                "emitted_tokens": self.emitted,
                "acceptance_rate": (round(self.accepted
                                          / max(1, self.drafted), 4)
                                    if self.drafted else None),
                "tokens_per_round": (round(self.emitted
                                           / max(1, self.rounds), 2)
                                     if self.rounds else None),
                "disengages": self.disengages,
                "reprobes": self.reprobes,
                "fallbacks": dict(self.fallbacks),
            }
