"""ModelBackend, the seam between the consensus layer and model execution,
and its two implementations in the PyTorch port (port of
``quoracle_tpu/models/runtime.py``).

``ModelBackend`` is the contract the port's consensus engine types
against. ``TorchBackend.query`` receives a whole consensus round, groups
its rows per pool member and serves each member's rows with ONE
``GenerateEngine.generate`` call on the member's device; ``embed`` runs
the on-device ``EmbeddingEncoder`` (models/embeddings.py). Rows are built
exactly as the JAX ``TPUBackend`` builds them (chat template, session
splice, per-row overflow error, output budget), so both packages send the
same token ids to their engines. ``MockBackend`` is the scripted test
backend. Left for later slices: the continuous batcher and QoS, the
cross-caller baton batcher thread, speculative decoding, KV tiers and VLM
rows.
"""

from __future__ import annotations

import abc
import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from quoracle_tpu_torch.models.config import OUTPUT_FLOOR, get_model_config
from quoracle_tpu_torch.models.embeddings import (
    EmbeddingEncoder, HashingEmbedder,
)
from quoracle_tpu_torch.models.generate import (
    ContextOverflowError, GenerateEngine, resolve_device,
    splice_session_prompt,
)
from quoracle_tpu_torch.models.tokenizer import (
    _stringify_content, get_tokenizer,
)
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


class ModelBackend(abc.ABC):
    """What the consensus layer depends on. All methods are synchronous and
    thread-safe."""

    @abc.abstractmethod
    def query(self, requests: Sequence[QueryRequest]) -> list[QueryResult]: ...

    @abc.abstractmethod
    def embed(self, texts: Sequence[str]) -> list[np.ndarray]: ...

    @abc.abstractmethod
    def count_tokens(self, model_spec: str, text: str) -> int: ...

    def count_message_tokens(self, model_spec: str, messages: Sequence[dict]) -> int:
        total = 0
        for m in messages:
            content = m.get("content", "")
            if not isinstance(content, str):
                content = _stringify_content(content)
            total += self.count_tokens(model_spec, content) + 4  # role overhead
        return total

    @abc.abstractmethod
    def context_window(self, model_spec: str) -> int: ...

    @abc.abstractmethod
    def output_limit(self, model_spec: str) -> int: ...

    def drop_session(self, session_id: str,
                     model_specs: Optional[Sequence[str]] = None) -> None:
        """Release resident KV state for a conversation (called on agent
        termination / pool switch). ``model_specs`` limits the drop to those
        members' engines. No-op for backends without KV residency."""

    def attach_bus(self, bus) -> None:
        """Optional: give the backend an event bus to broadcast serving
        telemetry on. No-op for backends without serving internals."""

    def watchdog_sources(self) -> list:
        """(name, progress_fn) pairs for a stall watchdog. Empty for
        backends without decode loops to watch."""
        return []

    def scheduler_stats(self) -> dict:
        """Per-member continuous-batcher health snapshots. Empty for
        backends without a scheduler."""
        return {}

    def qos_stats(self) -> dict:
        """Serving-QoS snapshot. ``enabled`` False for backends without
        QoS wiring."""
        return {"enabled": False}

    def spec_stats(self) -> dict:
        """Speculative-serving snapshot. ``enabled`` False for backends
        without draft models."""
        return {"enabled": False}

    def kv_stats(self) -> dict:
        """Tiered-KV snapshot. ``enabled`` False for backends without
        tiering."""
        return {"enabled": False}

    def prefetch_sessions(self, session_id: str) -> int:
        """Warm hibernated KV for a conversation before it runs. Returns
        engines warmed. No-op for backends without tiering."""
        return 0


class TorchBackend(ModelBackend):
    """Serves a pool of catalog models, one ``GenerateEngine`` each, on
    one device. ``device=None`` means the GPU and raises without one; the
    CPU serves only when asked (``device="cpu"``, the tests). Weights are
    random bf16, drawn from ``torch.Generator``s seeded ``seed + i`` on
    the device (checkpoint loading is a later slice); ``engines`` hands in
    prebuilt engines instead. ``quantize_weights`` and ``quantize_kv``
    (int8 serving, models/quant.py) apply to every engine the backend
    builds, as in the JAX backend.

    The embedder is built as the JAX backend builds it: ``embedder`` if
    given; else an ``EmbeddingEncoder`` over ``embed_model`` (default: the
    pool's first member), sharing that member's weights and tokenizer when
    it has an engine here, else over random weights drawn on the device
    from a generator seeded ``seed + 101``."""

    def __init__(self, pool: Sequence[str], *, seed: int = 0, device=None,
                 embed_model: Optional[str] = None,
                 engines: Optional[dict[str, GenerateEngine]] = None,
                 embedder=None,
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
        if embedder is not None:
            self.embedder = embedder
        else:
            espec = embed_model or self.pool[0]
            if espec in self.engines:
                e = self.engines[espec]
                eparams, ecfg, etok = e.params, e.cfg, e.tokenizer
            else:
                ecfg = get_model_config(espec)
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed + 101)
                eparams = init_params(ecfg, gen, device=self.device)
                etok = get_tokenizer(espec)
            self.embedder = EmbeddingEncoder(ecfg, eparams, etok)

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

    def embed(self, texts: Sequence[str]) -> list[np.ndarray]:
        return self.embedder.embed(texts)

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


# ---------------------------------------------------------------------------
# Mock backend (tests)
# ---------------------------------------------------------------------------

class MockBackend(ModelBackend):
    """Deterministic scripted backend.

    ``respond`` maps a QueryRequest to response text; default echoes a valid
    wait-action JSON so agent loops terminate. Per-model scripts drive
    disagreement/malformed/invalid scenarios (``"__error__"`` scripts a
    backend failure); every call is recorded in ``calls`` for assertion.
    The embedder defaults to ``HashingEmbedder``.

    The JAX package's MockBackend also fires a fault-injection point per
    member and opens a tracer span per member; the port has neither the
    chaos plane nor the tracer yet, so this copy leaves both out.
    """

    DEFAULT_POOL = ["mock:consensus-model-1", "mock:consensus-model-2",
                    "mock:consensus-model-3"]

    def __init__(self, respond: Optional[Callable[[QueryRequest], str]] = None,
                 scripts: Optional[dict[str, list[str]]] = None,
                 embedder=None, context_window_tokens: int = 128_000,
                 output_limit_tokens: int = 4096,
                 latency_ms: float = 0.0):
        self._respond = respond
        self._scripts = {k: list(v) for k, v in (scripts or {}).items()}
        self._embedder = embedder or HashingEmbedder()
        self._window = context_window_tokens
        self._output_limit = output_limit_tokens
        self._latency_ms = latency_ms
        self.calls: list[QueryRequest] = []

    def query(self, requests: Sequence[QueryRequest]) -> list[QueryResult]:
        out = []
        for r in requests:
            self.calls.append(r)
            script = self._scripts.get(r.model_spec)
            if script:
                text = script.pop(0)
            elif self._respond is not None:
                text = self._respond(r)
            else:
                text = ('{"action": "wait", "params": {"duration": 1}, '
                        '"reasoning": "mock default"}')
            if text == "__error__":
                out.append(QueryResult(model_spec=r.model_spec,
                                       error="scripted failure"))
                continue
            n_in = self.count_message_tokens(r.model_spec, r.messages)
            out.append(QueryResult(
                model_spec=r.model_spec, text=text,
                usage=Usage(n_in, max(1, len(text) // 4), 0.0),
                latency_ms=self._latency_ms))
        return out

    def embed(self, texts: Sequence[str]) -> list[np.ndarray]:
        return self._embedder.embed(texts)

    def count_tokens(self, model_spec: str, text: str) -> int:
        return max(1, len(text) // 4)

    def context_window(self, model_spec: str) -> int:
        return self._window

    def output_limit(self, model_spec: str) -> int:
        return self._output_limit
