"""The serving backend of the PyTorch port (port of the baton path of
``quoracle_tpu/models/runtime.py``).

``TorchBackend.query`` receives a whole consensus round, groups its rows
per pool member and serves each member's rows with ONE
``GenerateEngine.generate`` call on the member's device. Rows are built
exactly as the JAX ``TPUBackend`` builds them (chat template, session
splice, per-row overflow error, output budget), so both packages send the
same token ids to their engines. Left for later slices: the continuous
batcher and QoS, the cross-caller baton batcher thread, speculative
decoding, KV tiers, VLM rows and the embedder.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import torch

from quoracle_tpu_torch.models.config import OUTPUT_FLOOR, get_model_config
from quoracle_tpu_torch.models.generate import (
    ContextOverflowError, GenerateEngine, resolve_device,
    splice_session_prompt,
)
from quoracle_tpu_torch.models.tokenizer import get_tokenizer
from quoracle_tpu_torch.models.transformer import init_params


@dataclasses.dataclass
class QueryRequest:
    """One model's slice of a consensus round. Fields after
    ``action_enum`` are kept so the dataclass matches the JAX package's;
    this slice does not read them."""
    model_spec: str                    # "xla:llama-3-8b"
    messages: list[dict]               # chat messages (system injected)
    temperature: float = 1.0
    top_p: float = 1.0
    max_tokens: Optional[int] = None   # None = window - input, capped
    session_id: Optional[str] = None   # KV residency key (the agent id)
    constrain_json: bool = False       # grammar-masked JSON sampling
    action_enum: Optional[tuple] = None
    tenant: str = "default"
    priority: Optional[int] = None
    deadline_ms: Optional[float] = None
    trace: Optional[dict] = None
    task_id: Optional[str] = None
    decide: Optional[str] = None
    tree: Optional[dict] = None


@dataclasses.dataclass
class Usage:
    prompt_tokens: int = 0
    completion_tokens: int = 0
    cost: float = 0.0


@dataclasses.dataclass
class QueryResult:
    """One row's answer. ``spec_*`` and ``chip_ms`` stay 0 in this slice
    (no speculation, no chip-economics ledger)."""
    model_spec: str
    text: str = ""
    usage: Usage = dataclasses.field(default_factory=Usage)
    latency_ms: float = 0.0
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    cached_tokens: int = 0     # prompt tokens served from resident KV
    spec_rounds: int = 0
    spec_accepted_tokens: int = 0
    chip_ms: float = 0.0
    error: Optional[str] = None        # None = success
    permanent_error: bool = False

    @property
    def ok(self) -> bool:
        return self.error is None


class TorchBackend:
    """Serves a pool of catalog models, one ``GenerateEngine`` each, on
    one device. ``device=None`` means the GPU and raises without one; the
    CPU serves only when asked (``device="cpu"``, the tests). Weights are
    random bf16, drawn from ``torch.Generator``s seeded ``seed + i`` on
    the device (checkpoint loading is a later slice); ``engines`` hands in
    prebuilt engines instead. ``quantize_weights`` and ``quantize_kv``
    (int8 serving, models/quant.py) apply to every engine the backend
    builds, as in the JAX backend."""

    def __init__(self, pool: Sequence[str], *, seed: int = 0, device=None,
                 engines: Optional[dict[str, GenerateEngine]] = None,
                 quantize_weights: bool = False, quantize_kv: bool = False):
        self.device = resolve_device(device)
        self.pool = list(pool)
        self.quantize_weights = bool(quantize_weights)
        self.quantize_kv = bool(quantize_kv)
        self.engines: dict[str, GenerateEngine] = dict(engines or {})
        for i, spec in enumerate(self.pool):
            if spec in self.engines:
                continue
            cfg = get_model_config(spec)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed + i)
            params = init_params(cfg, gen, device=self.device)
            self.engines[spec] = GenerateEngine(
                cfg, params, get_tokenizer(spec), seed=seed + i,
                device=self.device, quantize_weights=self.quantize_weights,
                quantize_kv=self.quantize_kv)

    def query(self, requests: Sequence[QueryRequest]) -> list[QueryResult]:
        """Group rows by pool member; one batched generate per member,
        members served in turn (one device)."""
        by_model: dict[str, list[int]] = {}
        for i, r in enumerate(requests):
            by_model.setdefault(r.model_spec, []).append(i)
        results: list[Optional[QueryResult]] = [None] * len(requests)
        for spec, idxs in by_model.items():
            self._query_member(spec, idxs, requests, results)
        return [r for r in results if r is not None]

    def _query_member(self, spec: str, idxs: list[int],
                      requests: Sequence[QueryRequest],
                      results: list[Optional[QueryResult]]) -> None:
        if spec not in self.engines:
            for i in idxs:
                results[i] = QueryResult(
                    model_spec=spec, error=f"unknown model {spec!r}",
                    permanent_error=True)
            return
        t0 = time.monotonic()
        rows, live_idxs = self._build_rows(spec, idxs, requests, results)
        if live_idxs:
            self._dispatch_rows(spec, rows, live_idxs, results, t0)

    def _build_rows(self, spec: str, idxs: list[int],
                    requests: Sequence[QueryRequest],
                    results: list) -> tuple[list[dict], list[int]]:
        """Row preparation for one member: chat-template encode, session
        splice, per-row overflow errors, and the output budget
        min(output_limit, max(floor, window - prompt))."""
        engine = self.engines[spec]
        tok = engine.tokenizer
        max_seq = engine.max_seq
        rows: list[dict] = []
        live_idxs: list[int] = []
        for i in idxs:
            r = requests[i]
            ids = tok.encode_chat(r.messages)
            if r.session_id:
                # share the session's ACTUAL ids (prompt + sampled
                # response) so the retained response KV resumes too
                sess_toks = engine.session_tokens(r.session_id)
                if sess_toks:
                    spliced = splice_session_prompt(tok, sess_toks, ids)
                    if spliced is not None and len(spliced) < max_seq:
                        ids = spliced
            if len(ids) >= max_seq:
                results[i] = QueryResult(
                    model_spec=spec,
                    error=f"context_overflow: prompt {len(ids)} tokens "
                          f">= window {max_seq}")
                continue
            window = engine.cfg.context_window
            out_lim = engine.cfg.output_limit
            floor = min(OUTPUT_FLOOR, out_lim)
            budget = min(out_lim, max(floor, window - len(ids)))
            rows.append({
                "prompt": ids, "temperature": r.temperature,
                "top_p": r.top_p,
                "budget": min(r.max_tokens, budget) if r.max_tokens
                          else budget,
                "session_id": r.session_id,
                "constrain_json": r.constrain_json,
                "action_enum": r.action_enum,
            })
            live_idxs.append(i)
        return rows, live_idxs

    def _dispatch_rows(self, spec: str, rows: list[dict],
                       live_idxs: list[int], results: list,
                       t0: float) -> None:
        """One direct engine.generate for the member's rows; a failure
        becomes each row's error, as in the JAX backend."""
        engine = self.engines[spec]
        cfg = engine.cfg
        try:
            gens = engine.generate(
                [r["prompt"] for r in rows],
                temperature=[r["temperature"] for r in rows],
                top_p=[r["top_p"] for r in rows],
                max_new_tokens=[r["budget"] for r in rows],
                session_ids=([r["session_id"] for r in rows]
                             if any(r["session_id"] for r in rows)
                             else None),
                constrain_json=([r["constrain_json"] for r in rows]
                                if any(r["constrain_json"] for r in rows)
                                else None),
                action_enums=([r["action_enum"] for r in rows]
                              if any(r["action_enum"] for r in rows)
                              else None))
        except ContextOverflowError as e:
            for i in live_idxs:
                results[i] = QueryResult(model_spec=spec,
                                         error=f"context_overflow: {e}")
            return
        except Exception as e:    # noqa: BLE001 — row-level error
            for i in live_idxs:
                results[i] = QueryResult(model_spec=spec,
                                         error=f"generate failed: {e}")
            return
        prefill_ms = engine.last_prefill_s * 1000
        decode_ms = engine.last_decode_s * 1000
        latency_ms = (time.monotonic() - t0) * 1000
        for i, g in zip(live_idxs, gens):
            cost = (g.n_prompt_tokens * cfg.input_cost_per_mtok
                    + g.n_gen_tokens * cfg.output_cost_per_mtok) / 1e6
            results[i] = QueryResult(
                model_spec=spec, text=g.text,
                usage=Usage(g.n_prompt_tokens, g.n_gen_tokens, cost),
                latency_ms=latency_ms, prefill_ms=prefill_ms,
                decode_ms=decode_ms, cached_tokens=g.n_cached_tokens)

    def drop_session(self, session_id: str,
                     model_specs: Optional[Sequence[str]] = None) -> None:
        """Release a conversation's resident KV on every engine (or only
        on ``model_specs``)."""
        keep = None if model_specs is None else set(model_specs)
        for spec, engine in self.engines.items():
            if keep is None or spec in keep:
                engine.drop_session(session_id)

    def count_tokens(self, model_spec: str, text: str) -> int:
        return self.engines[model_spec].tokenizer.count(text)

    def context_window(self, model_spec: str) -> int:
        return get_model_config(model_spec).context_window

    def output_limit(self, model_spec: str) -> int:
        return get_model_config(model_spec).output_limit
