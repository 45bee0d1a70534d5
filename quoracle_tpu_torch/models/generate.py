"""Batched prefill + decode: the generate engine of the PyTorch port (port
of ``quoracle_tpu/models/generate.py``, the subset a consensus round runs).

A consensus round is ONE batched call per pool member with per-row
sampling params. The functional core (prefill, grammar mask, the decode
loops) is plain PyTorch on tensors; the stateful engine handles shape
bucketing, the paged session store and detokenization.

Sessionless rows take the dense path: dense prefill (``forward_hidden`` ->
flash kernel for chunks of at least 256 tokens on the GPU) and the dense
``decode``. Sessioned rows take one of the JAX engine's three paged tiers,
chosen in ``_run_paged`` by the same gates (utils/calibration.py) and the
same page discipline:

  * unified: one token-major chunk forward that writes KV straight into
    the rows' pages and attends through the ragged kernel, then
    ``decode_ragged`` through the same kernel at tq = 1 (``_run_unified``);
  * direct: the suffix chunk attends to the resident pages in place
    through the paged prefill kernel (``step_paged_prefill_direct``), the
    decode reads the pages through the paged decode kernel with a dense
    tail (``decode_paged``), and the tail is copied into the pages after;
  * gather: the resident prefix is copied into a dense working cache, the
    dense prefill and decode run over it, and prompt and response KV are
    copied back to the pages (``step_paged_prefill``,
    ``step_paged_decode``). It is also the tier a batch drops to when the
    page pool cannot give the other two their pages.

The JAX ``while_loop``'s all-done early exit becomes one host check per
decode step, and the JAX jits with donated buffers become plain methods
that write the pool in place. Bucket arithmetic (prompt/batch/max_new
buckets, RAGGED_TQ, RAGGED_TOKEN_BUCKETS, pow2 table width) is kept
verbatim: it fixes cache lengths and page bookkeeping, so both packages
lay out the same pages.

Int8 serving (``quantize_weights``, ``quantize_kv``; models/quant.py): the
engine quantizes its weights per channel at build, and an int8 KV pool
keeps fp32 scale pools ``[L, n_pages, KV, page]`` beside the pages. An
int8 pool serves through the unified tier on every device (the int8
ragged kernel on the card); the gather tier stays its fallback,
dequantizing into the working cache and requantizing on the way back; the
direct tier, which has no scale stream, is off.

Prefix sharing (``prefix_sharing``, on by default as in the JAX engine):
pages are refcounted, and the radix prefix cache (models/prefix_cache.py)
maps page-aligned token prefixes of stored sessions to their pages. A new
session adopts the longest cached prefix of its prompt and prefills only
the rest; a batch of new sessions sharing a prompt runs in two waves, so
the shared prompt prefills once; a write that would change a shared page
copies it first. Windowed models never share.

Speculative verify (``verify_chunk``, the target side of
models/speculative.py's ``BatchedSpeculator``): one teacher-forced chunk
forward per round resumes each row's session and returns the target's
grammar-masked argmax (and, for sampled rows, its softmax) at the last K
positions of every row. It runs on the unified tier (the ragged kernel;
int8 pools: the int8 ragged kernel) or on the gather tier (working cache,
dense forward, pages written back), never on the direct tier, and runs
no decode loop. Its store-back keeps unverified draft tokens at the
session's tail, so it never feeds the radix prefix cache.

Tiered KV (``attach_tier``; serving/kvtier.py): the store's eviction
demotes a victim session to host memory, the session lookup restores a
hibernated session by page-in (a failed restore re-prefills), a tiered
prefix lookup pages host or disk blocks back into the radix tree, and
``prefetch_session`` warms a hibernated session ahead of its row.
``kv_signature`` names the pool's geometry and dtype exactly as the JAX
engine does, so both packages share disk stores and handoffs.

Observability (infra/): every generate and verify call observes its
phase walls and per-token rates, ledgers its shape key in the engine's
``CompileRegistry``, counts real against padded chunk tokens
(``padding_stats``), charges its phase walls to the rows aboard it
(``costobs.charge_step``: ``GenResult.chip_ms``, the verify rows'
``chip_ms``, the MFU roofline) and beats the ``engine.tokens``
heartbeat. All of it reads host-side counts the engine already holds and
the walls ``_fence`` already measured: no RNG, no device read, no extra
sync.

VLM rows (``generate(images=)`` on a model with a vision tower): image
rows run sessionless through ``prefill_vlm`` (the tower, the splice of
its projected patches over the placeholder tokens, the dense prefill:
flash from 256-token chunks on the GPU) and the dense decode. Vision
models never share prefixes (no wave split, no radix adoption or
insert), and speculation never serves an image row. Left for a later
slice: meshes.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from quoracle_tpu_torch.chaos.faults import CHAOS
from quoracle_tpu_torch.infra import costobs, introspect
from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.telemetry import (
    DECODE_MS, DECODE_STEP_MS, JIT_COMPILES, KV_ALLOC_DRIFT_TOTAL,
    PREFILL_MS, PREFILL_TOKENS_PER_S, PREFIX_LOOKUP_MS, TRACER,
)
from quoracle_tpu_torch.models.config import ModelConfig
from quoracle_tpu_torch.models.prefix_cache import RadixPrefixCache
from quoracle_tpu_torch.models.quant import (
    kv_quant, kv_token_bytes, params_nbytes, quantize_params,
)
from quoracle_tpu_torch.models.sampling import sample_tokens
from quoracle_tpu_torch.models.transformer import (
    KVCache, Transformer, _embed_lookup, forward_hidden,
    forward_hidden_paged, forward_hidden_paged_prefill,
    forward_hidden_ragged, init_cache, project_logits,
)
from quoracle_tpu_torch.models.vision import (
    splice_image_embeds, vision_encode,
)
from quoracle_tpu_torch.ops import kernels
from quoracle_tpu_torch.serving.kvtier import TierManager, dtype_name
from quoracle_tpu_torch.utils.calibration import (
    load_paged_gates, resolve_unified_gate,
)

# Finite mask value: a whole-row -inf would NaN the sampling softmax; the
# grammar layer guarantees >= 1 allowed token, this is defense in depth.
NEG_INF_LOGITS = -1e30
REJECT_STATE = -1          # models/constrained.py REJECT


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one, raise: the port never falls
    back to the CPU on its own (tests pass ``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: quoracle_tpu_torch serves on "
                "the GPU by default; pass device='cpu' to run the plain "
                "PyTorch paths on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _fence(device: torch.device) -> None:
    """Phase fence: wait for the device so host clocks time device work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def prefill_chunk(params: Transformer, cfg: ModelConfig,
                  tokens: torch.Tensor, prefix_lens: torch.Tensor,
                  chunk_lens: torch.Tensor, cache: KVCache,
                  kv_off: Optional[torch.Tensor] = None,
                  input_embeds: Optional[torch.Tensor] = None,
                  ) -> tuple[torch.Tensor, KVCache]:
    """Fill the cache from a right-padded token chunk starting at per-row
    buffer index ``prefix_lens``. Returns (last-token logits [B, V], cache
    with lens = prefix + chunk). The head projects only each row's last
    hidden state. ``input_embeds`` [B, T, D] replaces the chunk's
    embedding lookup, prepared by the caller (never re-scaled)."""
    B, T = tokens.shape
    positions = (prefix_lens[:, None]
                 + torch.arange(T, dtype=torch.int32,
                                device=tokens.device)[None, :])
    if kv_off is not None:
        positions = positions + kv_off.to(torch.int32)[:, None]
    total = (prefix_lens + chunk_lens).to(torch.int32)
    hidden, cache = forward_hidden(
        params, cfg, tokens, positions, cache,
        write_offset=prefix_lens.to(torch.int32), kv_lens=total,
        kv_pos_offset=kv_off, input_embeds=input_embeds)
    rows = torch.arange(B, device=tokens.device)
    last_h = hidden[rows, (chunk_lens - 1).long()]             # [B, D]
    cache.lens = total
    return project_logits(params, cfg, last_h), cache


def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            prompt_lens: torch.Tensor, cache: KVCache,
            input_embeds: Optional[torch.Tensor] = None,
            ) -> tuple[torch.Tensor, KVCache]:
    """Fresh prefill = prefill_chunk from position 0."""
    zeros = torch.zeros_like(prompt_lens, dtype=torch.int32)
    return prefill_chunk(params, cfg, tokens, zeros, prompt_lens, cache,
                         input_embeds=input_embeds)


@torch.no_grad()
def prefill_vlm(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
                prompt_lens: torch.Tensor, cache: KVCache,
                pixels: torch.Tensor) -> tuple[torch.Tensor, KVCache]:
    """VLM prefill: the tower encodes ``pixels`` [B, S, S, 3], the
    projected patches replace the image-placeholder tokens' embeddings,
    and the dense prefill runs over the spliced embeddings. Text
    embeddings are scaled (``scale_embeddings``) BEFORE the splice; the
    patches enter at the projector's own scale."""
    img = vision_encode(params.vision, cfg.vision, pixels)
    embeds = splice_image_embeds(_embed_lookup(params, cfg, tokens), tokens,
                                 img, cfg.image_token_id)
    return prefill(params, cfg, tokens, prompt_lens, cache,
                   input_embeds=embeds)


def grammar_mask(logits: torch.Tensor, jstate: torch.Tensor,
                 json_table: torch.Tensor, eos_id: int) -> torch.Tensor:
    """THE grammar mask. logits [B, V], jstate [B]; jstate < 0 is an
    unconstrained row; a dead-end state (no token allowed) permits eos so
    the row stops instead of sampling an all-masked distribution."""
    allowed = json_table[torch.clamp(jstate, min=0).long()] >= 0   # [B, V]
    none_ok = ~torch.any(allowed, dim=-1, keepdim=True)
    eos_hot = (torch.arange(logits.shape[-1],
                            device=logits.device) == eos_id)[None, :]
    allowed = allowed | (none_ok & eos_hot) | (jstate < 0)[:, None]
    return torch.where(allowed, logits,
                       torch.full_like(logits, NEG_INF_LOGITS))


def _sampling_fns(json_table: Optional[torch.Tensor], eos_id: int,
                  stop_ids: tuple, device):
    """The stop/grammar closures shared by decode() and decode_ragged()."""
    stops = torch.as_tensor((eos_id,) + tuple(stop_ids), dtype=torch.int32,
                            device=device)
    constrained = json_table is not None

    def is_stop(tok):
        return torch.any(tok[:, None] == stops[None, :], dim=1)

    def mask_logits(logits, jstate):
        if not constrained:
            return logits
        return grammar_mask(logits, jstate, json_table, eos_id)

    def advance(jstate, tok, done):
        if not constrained:
            return jstate
        nxt = json_table[torch.clamp(jstate, min=0).long(),
                         tok.long()].to(torch.int32)
        return torch.where((jstate >= 0) & ~done, nxt, jstate)

    return is_stop, mask_logits, advance, constrained


def _first_token(fns, first_logits, generator, temperature, top_p, active,
                 row_limit, json_state, max_new: int, pad_id: int):
    """Decode bootstrap: sample token 0 from the prefill logits and build
    the initial (tok0, n0, done0, jstate0, out0) state."""
    is_stop, mask_logits, advance, constrained = fns
    B = first_logits.shape[0]
    dev = first_logits.device
    jstate0 = (json_state if constrained
               else torch.zeros((B,), dtype=torch.int32, device=dev))
    tok0 = sample_tokens(mask_logits(first_logits, jstate0), generator,
                         temperature, top_p)
    n0 = active.to(torch.int32)
    done0 = ~active | is_stop(tok0) | (n0 >= row_limit)
    # advance on tok0 for every active row (eos self-loops in accept states)
    jstate0 = advance(jstate0, tok0, ~active)
    out0 = torch.full((B, max_new), pad_id, dtype=torch.int32, device=dev)
    out0[:, 0] = tok0
    return tok0, n0, done0, jstate0, out0


@torch.no_grad()
def decode(
    params: Transformer,
    cfg: ModelConfig,
    cache: KVCache,
    first_logits: torch.Tensor,   # [B, V] logits at the last prompt token
    generator: torch.Generator,
    temperature: torch.Tensor,    # [B]
    top_p: torch.Tensor,          # [B]
    max_new: int,
    eos_id: int,
    active: torch.Tensor,         # [B] bool — False for padding rows
    row_limit: torch.Tensor,      # [B] int32 per-row budget (<= max_new)
    pad_id: int = 0,
    stop_ids: tuple = (),
    json_table: Optional[torch.Tensor] = None,   # [S, V] transitions
    json_state: Optional[torch.Tensor] = None,   # [B]; -1 = unconstrained
    kv_off: Optional[torch.Tensor] = None,       # [B] abs pos of index 0
):
    """Autoregressive decode over the dense cache. Returns (tokens
    [B, max_new], n_emitted [B] (a terminal EOS included), cache, jstate).
    A row stops at a stop id or at its ``row_limit``; padding rows start
    done, and the loop ends when every row is done (one host check per
    step) or at ``max_new``."""
    fns = _sampling_fns(json_table, eos_id, stop_ids, first_logits.device)
    is_stop, mask_logits, advance, _ = fns
    cur, n_emitted, done, jstate, out = _first_token(
        fns, first_logits, generator, temperature, top_p, active,
        row_limit, json_state, max_new, pad_id)
    for i in range(1, max_new):
        if bool(torch.all(done)):
            break
        positions = cache.lens[:, None]
        if kv_off is not None:
            positions = positions + kv_off.to(torch.int32)[:, None]
        hidden, cache = forward_hidden(
            params, cfg, cur[:, None], positions, cache,
            write_offset=cache.lens, kv_lens=cache.lens + 1,
            kv_pos_offset=kv_off)
        logits = project_logits(params, cfg, hidden[:, 0])
        nxt = sample_tokens(mask_logits(logits, jstate), generator,
                            temperature, top_p)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        out[:, i] = nxt
        live = (~done).to(torch.int32)
        n_emitted = n_emitted + live
        cache.lens = cache.lens + live
        jstate = advance(jstate, nxt, done)
        done = done | is_stop(nxt) | (n_emitted >= row_limit)
        cur = nxt
    return out, n_emitted, cache, jstate


@torch.no_grad()
def decode_paged(
    params: Transformer,
    cfg: ModelConfig,
    k_pool: torch.Tensor,         # [L, n_pages, page, KV, hd], read-only
    v_pool: torch.Tensor,
    tables: torch.Tensor,         # [B, maxp] int32
    pool_lens: torch.Tensor,      # [B] int32 valid pool tokens (the prompt)
    kv_off: torch.Tensor,         # [B] int32 abs position of pool index 0
    first_logits: torch.Tensor,   # [B, V]
    generator: torch.Generator,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    max_new: int,
    eos_id: int,
    active: torch.Tensor,
    row_limit: torch.Tensor,
    pad_id: int = 0,
    stop_ids: tuple = (),
    json_table: Optional[torch.Tensor] = None,
    json_state: Optional[torch.Tensor] = None,
    tail_dtype: Optional[torch.dtype] = None,
):
    """Autoregressive decode against the paged pool (the direct tier):
    the sampling and grammar semantics of ``decode``, but attention reads
    the rows' pages in place (``forward_hidden_paged``) and the new
    tokens' KV lands in a [L, B, max_new, KV, hd] TAIL buffer instead of
    a gathered working cache. Returns (tokens [B, max_new], n_emitted [B],
    lens [B], tail_k, tail_v, jstate), lens = pool_lens + valid tail
    entries per row; the caller copies tail[:, :lens - pool_lens] into the
    rows' pages."""
    B = first_logits.shape[0]
    L, _, _, KV, HD = k_pool.shape
    fns = _sampling_fns(json_table, eos_id, stop_ids, first_logits.device)
    is_stop, mask_logits, advance, _ = fns
    cur, n_emitted, done, jstate, out = _first_token(
        fns, first_logits, generator, temperature, top_p, active,
        row_limit, json_state, max_new, pad_id)
    dt = k_pool.dtype if tail_dtype is None else tail_dtype
    tail_k = torch.zeros((L, B, max_new, KV, HD), dtype=dt,
                         device=k_pool.device)
    tail_v = torch.zeros_like(tail_k)
    lens = pool_lens.to(torch.int32)
    off = kv_off.to(torch.int32)
    for i in range(1, max_new):
        if bool(torch.all(done)):
            break
        positions = (lens + off)[:, None]
        hidden, tail_k, tail_v = forward_hidden_paged(
            params, cfg, cur[:, None], positions, k_pool, v_pool, tables,
            pool_lens, kv_off, tail_k, tail_v, step=i - 1)
        logits = project_logits(params, cfg, hidden[:, 0])
        nxt = sample_tokens(mask_logits(logits, jstate), generator,
                            temperature, top_p)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        out[:, i] = nxt
        live = (~done).to(torch.int32)
        n_emitted = n_emitted + live
        lens = lens + live
        jstate = advance(jstate, nxt, done)
        done = done | is_stop(nxt) | (n_emitted >= row_limit)
        cur = nxt
    return out, n_emitted, lens, tail_k, tail_v, jstate


@torch.no_grad()
def decode_ragged(
    params: Transformer,
    cfg: ModelConfig,
    k_pool: torch.Tensor,         # [L, n_pages, page, KV, hd], in place
    v_pool: torch.Tensor,
    tables: torch.Tensor,         # [R, maxp] int32 dst page table per row
    pool_lens: torch.Tensor,      # [R] int32 valid pool tokens
    kv_off: torch.Tensor,         # [R] int32 abs position of pool index 0
    first_logits: torch.Tensor,   # [R, V]
    generator: torch.Generator,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    max_new: int,
    eos_id: int,
    active: torch.Tensor,
    row_limit: torch.Tensor,
    pad_id: int = 0,
    stop_ids: tuple = (),
    json_table: Optional[torch.Tensor] = None,
    json_state: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,   # [L, n_pages, KV, page] fp32
    v_scale: Optional[torch.Tensor] = None,   # (int8 pools), in place
):
    """Autoregressive decode through the unified ragged kernel: each
    step's KV goes straight into the row's pages before attention, and the
    kernel reads prompt, chunk and generated tokens off the pages, one
    tq = 1 block per row. Returns (tokens [R, max_new], n_emitted [R],
    lens [R], k_pool, v_pool, jstate); lens counts the row's valid pool
    tokens (prompt + chunk + emitted-and-forwarded). With ``k_scale``/
    ``v_scale`` (int8 pools) each step's token quantizes on its write and
    the return grows to (…, k_pool, v_pool, k_scale, v_scale, jstate)."""
    quant = k_scale is not None
    _, n_pages, page, _, _ = k_pool.shape
    n_tok = n_pages * page
    maxp = tables.shape[1]
    fns = _sampling_fns(json_table, eos_id, stop_ids, first_logits.device)
    is_stop, mask_logits, advance, _ = fns
    cur, n_emitted, done, jstate, out = _first_token(
        fns, first_logits, generator, temperature, top_p, active,
        row_limit, json_state, max_new, pad_id)
    lens = pool_lens.to(torch.int32)
    tables_l = tables.long()
    for i in range(1, max_new):
        if bool(torch.all(done)):
            break
        live = (~done).to(torch.int32)
        # this step's token writes at buffer slot lens; done rows (and any
        # row at its page-table edge) drop via the out-of-range sentinel
        pg = torch.gather(tables_l, 1, torch.clamp(
            lens // page, max=maxp - 1).long()[:, None])[:, 0]
        flat = torch.where(done | (lens // page >= maxp),
                           torch.full_like(lens, n_tok),
                           (pg * page + lens % page).to(torch.int32))
        meta = torch.stack([
            lens + live,              # kv_len incl. the token just written
            lens - (1 - live),        # qpos0 (done rows: inert block)
            live,                     # nq
        ], dim=1)
        positions = lens + kv_off.to(torch.int32)
        hidden = forward_hidden_ragged(
            params, cfg, cur[None], positions[None], k_pool, v_pool, tables,
            meta, flat, tq=1, k_scale=k_scale, v_scale=v_scale)[0]
        logits = project_logits(params, cfg, hidden[0])      # [R, V]
        nxt = sample_tokens(mask_logits(logits, jstate), generator,
                            temperature, top_p)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        out[:, i] = nxt
        n_emitted = n_emitted + live
        lens = lens + live
        jstate = advance(jstate, nxt, done)
        done = done | is_stop(nxt) | (n_emitted >= row_limit)
        cur = nxt
    if quant:
        return out, n_emitted, lens, k_pool, v_pool, k_scale, v_scale, jstate
    return out, n_emitted, lens, k_pool, v_pool, jstate


def _round_up(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


# Unified flat-layout constants: rows' query segments are padded to
# RAGGED_TQ-token blocks and the flat token budget rounds to
# RAGGED_TOKEN_BUCKETS (kept from the JAX engine so both packages lay out
# identical ticks).
RAGGED_TQ = 8
RAGGED_TOKEN_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                        8192, 16384, 32768)
MAX_NEW_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


class ContextOverflowError(ValueError):
    """Prompt does not fit the model's context window."""


@dataclasses.dataclass
class GenResult:
    token_ids: list[int]
    text: str
    n_prompt_tokens: int
    n_gen_tokens: int
    latency_s: float
    finish_reason: str  # "stop" | "length"
    n_cached_tokens: int = 0   # prompt prefix served from a resident session
    json_state: int = -1       # final grammar state (-1 = unconstrained)
    # speculative serving (models/speculative.py through the continuous
    # batcher): draft/verify rounds this result rode, draft tokens
    # proposed and accepted; 0 on the plain paths
    spec_rounds: int = 0
    spec_drafted_tokens: int = 0
    spec_accepted_tokens: int = 0
    # this row's share of the measured device wall of the steps it rode,
    # split by real tokens (infra/costobs.py); 0.0 with accounting off
    chip_ms: float = 0.0


PAGE = 128   # tokens per KV page


@dataclasses.dataclass
class _Session:
    """Resident KV state for one conversation (agent x model): the full
    conversation's token ids (host ints) and the pool pages holding their
    K/V; ``pages[j]`` holds buffer positions [j·PAGE, (j+1)·PAGE), which
    map to absolute positions offset by ``start_pos`` (nonzero after
    sliding-window trimming drops leading pages)."""
    tokens: list[int]
    pages: list[int]
    start_pos: int = 0
    last_used: float = 0.0
    # adopted-prefix marker (cross-session prefix sharing): the pages
    # belong to the radix cache and other sessions; _run_paged
    # refcount-acquires them before using them as this row's dst prefix
    shared_prefix: bool = False

    @property
    def resident_len(self) -> int:
        return len(self.tokens) - self.start_pos


class SessionStore:
    """Paged session cache: sessions are PAGE LISTS into one device pool
    (``k``/``v`` [L, n_pages, page, KV, hd], set by the engine; int8 pools
    add ``k_scale``/``v_scale`` [L, n_pages, KV, page]). Page 0 is
    scratch. Pages are refcounted: a page shared by several sessions, an
    in-flight adopter and the radix prefix cache (models/prefix_cache.py)
    frees only when its last holder releases it. When the free list runs
    dry, unreferenced cache leaves evict first, then LRU sessions. With a
    KV tier attached (``tier``, serving/kvtier.py) eviction demotes a
    victim to host memory instead of destroying it, and prefix lookups
    page tiered blocks back in. Thread-safe; the engine additionally
    serializes sessioned steps."""

    def __init__(self, max_tokens: int = 262_144, page: int = PAGE):
        self.page = page
        self.n_pages = max(3, -(-max_tokens // page) + 1)   # +1 scratch
        self.max_tokens = (self.n_pages - 1) * page
        self.lock = named_lock("session.store", rlock=True)
        self.model = ""          # metric label; the engine sets cfg.name
        self._sessions: dict[str, _Session] = {}
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        # page refcounts; an absent key means 1 (every allocated page
        # starts singly owned)
        self._refs: dict[int, int] = {}
        # page-aligned token blocks -> pool pages, holding its own
        # reference on each: cached prefixes outlive their session. The
        # engine feeds it at store-back and consults it for new sessions.
        self.prefix_cache = RadixPrefixCache(self)
        self.k: Optional[torch.Tensor] = None
        self.v: Optional[torch.Tensor] = None
        self.k_scale: Optional[torch.Tensor] = None
        self.v_scale: Optional[torch.Tensor] = None
        # the KV tier (serving/kvtier.TierManager, set by
        # GenerateEngine.attach_tier): demote on eviction, restore by
        # page-in
        self.tier = None

    def get(self, key: str) -> Optional[_Session]:
        with self.lock:
            s = self._sessions.get(key)
            if s is not None:
                s.last_used = time.monotonic()
            return s

    def alloc(self, n: int, protect: tuple = (),
              evict: bool = True) -> Optional[list[int]]:
        """Take n pages from the free list, evicting as needed: radix-cache
        leaves first (a cached but unreferenced prefix is recomputable),
        then LRU sessions (never the ``protect`` keys — the batch's own
        sessions). Returns None — WITHOUT evicting anything — when the
        request cannot be satisfied even by evicting every unprotected
        session, counted exactly per page refcount (``_attainable``).
        ``evict=False`` takes only from the free list (temporary pages
        must never destroy other agents' resident sessions or thrash the
        prefix cache)."""
        with self.lock:
            if not evict:
                if n > len(self._free):
                    return None
                return [self._free.pop() for _ in range(n)]
            victims = [k for k in self._sessions if k not in protect]
            if n > self._attainable(victims):
                return None
            while len(self._free) < n:
                if self.prefix_cache.evict(n - len(self._free)):
                    continue
                if not victims:
                    break        # _attainable guarantees this can't happen
                lru = min(victims, key=lambda k: self._sessions[k].last_used)
                victims.remove(lru)
                sess = self._sessions.pop(lru)
                if self.tier is not None:
                    # eviction is demotion: the victim's pages are copied
                    # host-side, then only its own references drop, so
                    # shared pages other holders read stay resident
                    self.tier.demote_session(lru, sess)
                self._release(sess.pages)
            if len(self._free) < n:
                # accounting drift: _attainable promised pages the ladder
                # could not deliver — counted and flight-recorded, so a
                # refcount bug shows as telemetry, not as re-prefills
                KV_ALLOC_DRIFT_TOTAL.inc(model=self.model)
                FLIGHT.record("kv_alloc_drift", model=self.model,
                              requested=n, free=len(self._free),
                              sessions=len(self._sessions))
                return None
            return [self._free.pop() for _ in range(n)]

    def _attainable(self, victims: list) -> int:
        """Exact count of pages reachable by evicting ``victims`` and then
        stripping freeable prefix-cache leaves: free list + cache pages
        whose every non-tree reference a victim would release + victim
        pages (outside the cache) all of whose references victims hold."""
        released: Counter = Counter()
        for k in victims:
            for p in self._sessions[k].pages:
                if p:
                    released[p] += 1
        n_tree = self.prefix_cache.evictable_after(released)
        extra = sum(1 for p, c in released.items()
                    if not self.prefix_cache.holds(p)
                    and c >= self._refs.get(p, 1))
        return len(self._free) + n_tree + extra

    def _release(self, pages: list[int]) -> None:
        for p in pages:
            if p == 0:
                continue
            c = self._refs.get(p, 1) - 1
            if c <= 0:
                self._refs.pop(p, None)
                self._free.append(p)
            else:
                self._refs[p] = c

    def release(self, pages: list[int]) -> None:
        with self.lock:
            self._release(pages)

    def acquire(self, pages: list[int]) -> None:
        """Add a reference to already-allocated pages (an adopter holds
        the cached prefix pages alive past their other holders' release)."""
        with self.lock:
            for p in pages:
                if p != 0:
                    self._refs[p] = self._refs.get(p, 1) + 1

    def match_prefix(self, tokens: Sequence[int],
                     max_reuse: int) -> Optional[_Session]:
        """The longest PAGE-ALIGNED radix-cached prefix of ``tokens`` (at
        most ``max_reuse`` tokens), as a marker session (prefix tokens and
        page ids, ``shared_prefix=True``), or None under one page.
        Alignment is a correctness requirement: the adopter's own suffix
        must never write into a page it shares."""
        with self.lock:
            if self.tier is not None:
                # blocks stripped to the host tier, or persisted to disk
                # by an earlier process, page back in and rejoin the tree
                # before the match
                self.tier.extend_prefix(tokens, max_reuse)
            pages, matched = self.prefix_cache.match(tokens, max_reuse)
            if matched < self.page:
                return None
            return _Session(tokens=list(tokens[:matched]), pages=pages,
                            start_pos=0, shared_prefix=True)

    def insert_prefix(self, tokens: Sequence[int],
                      pages: Sequence[int]) -> int:
        """Feed a freshly stored session's full pages into the radix cache
        (the engine calls this at store-back for full-attention sessions
        with start_pos == 0). With a disk-backed tier, or a fleet prefix
        service attached to it, each full block also writes through to the
        checksummed prefix store and the fleet (content-addressed: a block
        already there costs one stat), so a restarted process, or another
        replica, warms from it. Returns the number of new nodes."""
        with self.lock:
            added = self.prefix_cache.insert(tokens, pages)
            if (self.tier is not None
                    and (self.tier.disk is not None
                         or self.tier.prefixd is not None)):
                for j in range(len(tokens) // self.page):
                    if j < len(pages) and pages[j]:
                        self.tier.persist_block(
                            [int(t) for t in tokens[:(j + 1) * self.page]],
                            pages[j])
            return added

    def put(self, key: str, sess: _Session) -> None:
        """Replace a session, releasing any of the old session's pages the
        new one no longer references."""
        sess.last_used = time.monotonic()
        with self.lock:
            old = self._sessions.get(key)
            if old is not None and old is not sess:
                self._release([p for p in old.pages if p not in sess.pages])
            self._sessions[key] = sess
            if self.tier is not None:
                self.tier.discard_session(key)   # the host copy is stale

    def put_raw(self, key: str, sess: _Session) -> None:
        """Replace WITHOUT page bookkeeping — the caller owns the page
        lifecycle (the engine's paged step releases explicitly)."""
        sess.last_used = time.monotonic()
        with self.lock:
            self._sessions[key] = sess
            if self.tier is not None:
                self.tier.discard_session(key)   # the host copy is stale

    def register_restored(self, key: str, tokens: list, pages: list[int],
                          start_pos: int) -> _Session:
        """Build and register a session the tier just paged back in (the
        tier never builds a ``_Session`` itself). The caller holds the
        lock and owns the pages."""
        sess = _Session(tokens=tokens, pages=pages, start_pos=start_pos)
        self.put_raw(key, sess)
        return sess

    def drop(self, key: str) -> None:
        with self.lock:
            s = self._sessions.pop(key, None)
            if s is not None:
                self._release(s.pages)
            if self.tier is not None:
                # a dropped conversation must not come back from the host
                # tier under a reused id
                self.tier.discard_session(key)

    def free_pages(self) -> int:
        with self.lock:
            return len(self._free)

    def __len__(self) -> int:
        with self.lock:
            return len(self._sessions)


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def splice_session_prompt(tokenizer, sess_tokens: Sequence[int],
                          plain_ids: Sequence[int]) -> Optional[list[int]]:
    """Token-level session splice: rebuild a prompt so it shares the longest
    possible TOKEN prefix with ``sess_tokens`` (the session's actual ids —
    original prompt + the ids the model itself sampled). Re-encoding the
    previous response's text rarely reproduces the sampled ids, so the
    comparison runs on decoded TEXT, keeping the session's own ids for the
    shared region; only the genuinely new suffix re-encodes.

    Returns the spliced ids, or None when the plain encoding already matches
    the session at least as far."""
    plain_reuse = _lcp(sess_tokens, plain_ids)
    canonical = tokenizer.decode_raw(plain_ids)
    if not canonical:
        return None
    if canonical.startswith(tokenizer.decode_raw(sess_tokens)):
        k = len(sess_tokens)       # clean extension: the refinement shape
    else:
        # Largest k with decode(sess[:k]) a prefix of the new text. The
        # predicate is not monotone across mid-UTF-8 cuts (trailing U+FFFD),
        # so bisect, then scan past the settle point while the mismatch is
        # confined to the trailing replacement chars, under a probe budget.
        def _pred(j: int) -> bool:
            return canonical.startswith(tokenizer.decode_raw(sess_tokens[:j]))

        lo, hi = 0, len(sess_tokens)
        misses = 64
        while True:
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if _pred(mid):
                    lo = mid
                else:
                    hi = mid - 1
            escaped = False
            j = lo + 1
            while j <= len(sess_tokens) and misses > 0:
                s = tokenizer.decode_raw(sess_tokens[:j])
                if canonical.startswith(s):
                    lo, hi, escaped = j, len(sess_tokens), True
                    break
                misses -= 1
                if not canonical.startswith(s.rstrip("�")):
                    break       # diverges before the partial-char tail
                j += 1
            if not escaped:
                break
        k = lo
    # >= 1 suffix token must run through prefill to produce last-position
    # logits; and the splice must beat the plain prefix to be worth it
    while k > plain_reuse:
        suffix = tokenizer.encode(
            canonical[len(tokenizer.decode_raw(sess_tokens[:k])):])
        if suffix:
            return list(sess_tokens[:k]) + suffix
        k -= 1
    return None


class CompileRegistry:
    """Per-engine ledger of every dispatched shape key, under the JAX
    engine's names: each key remembers its first call's wall time and
    how many later calls HIT it, and a sliding miss window trips the
    RECOMPILE-STORM gauge when more than ``threshold`` new keys appear
    inside ``window_s`` seconds. In the port nothing is compiled per
    shape: a miss marks a first-shape call (the JAX engine's XLA
    compile), so the ledger and the exposition stay the JAX package's on
    the same call sequence."""

    def __init__(self, model: str, window_s: float = 120.0,
                 threshold: int = 4):
        self.model = model
        self.window_s = window_s
        self.threshold = threshold
        self._lock = named_lock("cache.compile")
        self._shapes: dict[tuple, dict] = {}
        self._miss_times: list[float] = []
        self.hits = 0
        self.misses = 0
        self.storm = False
        self.storms_total = 0

    def record(self, shape: tuple, wall_ms: float) -> bool:
        """Record one dispatch; returns True on a MISS (first sight of
        this shape key)."""
        from quoracle_tpu_torch.infra.telemetry import (
            COMPILE_HITS, COMPILE_MISSES,
        )
        # Chaos seam: "poison" salts the ledger key so every dispatch
        # books as a fresh miss, a ledger-level recompile storm (the
        # gauge and alerting path end to end) with no effect on served
        # bits.
        d = CHAOS.fire("compile.key", model=self.model)
        if d is not None and d.kind == "poison":
            shape = tuple(shape) + ("chaos-poison", d.n)
        now = time.monotonic()
        with self._lock:
            entry = self._shapes.get(shape)
            if entry is None:
                self._shapes[shape] = {
                    "shape": shape, "compile_ms": round(wall_ms, 1),
                    "ts": time.time(), "hits": 0,
                }
                self.misses += 1
                self._miss_times.append(now)
                miss = True
            else:
                entry["hits"] += 1
                self.hits += 1
                miss = False
            self._refresh_locked(now)
        (COMPILE_MISSES if miss else COMPILE_HITS).inc(model=self.model)
        return miss

    def _refresh_locked(self, now: float) -> None:
        from quoracle_tpu_torch.infra.telemetry import (
            COMPILE_MISSES_IN_WINDOW, COMPILE_STORM,
        )
        self._miss_times = [t for t in self._miss_times
                            if now - t <= self.window_s]
        n = len(self._miss_times)
        storm = n >= self.threshold
        COMPILE_MISSES_IN_WINDOW.set(n, model=self.model)
        COMPILE_STORM.set(1.0 if storm else 0.0, model=self.model)
        if storm and not self.storm:
            self.storms_total += 1
            FLIGHT.record("compile_storm", model=self.model,
                          misses_in_window=n, window_s=self.window_s)
        self.storm = storm

    def refresh(self) -> None:
        """Re-evaluate the storm window against the clock (a collector
        hook: a storm clears at the next scrape with no new dispatch)."""
        with self._lock:
            self._refresh_locked(time.monotonic())

    def snapshot(self, max_shapes: int = 32) -> dict:
        """Totals, hit rate, storm state and the costliest shape keys."""
        with self._lock:
            shapes = sorted(self._shapes.values(),
                            key=lambda e: -e["compile_ms"])[:max_shapes]
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else None,
                "n_shapes": len(self._shapes),
                "storm": self.storm,
                "storms_total": self.storms_total,
                "misses_in_window": len(self._miss_times),
                "window_s": self.window_s,
                "threshold": self.threshold,
                "shapes": [{**e, "shape": "x".join(map(str, e["shape"]))}
                           for e in shapes],
            }


def _pick(seq, idxs: list):
    """Rows ``idxs`` of a per-row generate argument; a scalar or None
    applies to every row and passes through."""
    if seq is None or isinstance(seq, (int, float)):
        return seq
    return [seq[i] for i in idxs]


def _merge(n: int, *parts: tuple) -> list:
    """Sub-batches' results, each part (row indices, results), back in
    the order of the call's ``n`` rows."""
    merged: list = [None] * n
    for idxs, res in parts:
        for j, i in enumerate(idxs):
            merged[i] = res[j]
    return merged


class GenerateEngine:
    """Stateful serving wrapper around the functional core for ONE model:
    params on one device, shape bucketing, the paged session store, and a
    list-in/list-out ``generate``. ``device=None`` means the GPU (and
    raises without one). Sessioned calls serialize on the engine; the RNG
    draw is locked. ``quantize_weights`` serves int8 weights (a quantized
    copy; the caller's module is left as it was), ``quantize_kv`` an int8
    page pool with its scale pools."""

    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)

    def __init__(self, cfg: ModelConfig, params: Transformer, tokenizer,
                 max_seq: Optional[int] = None, seed: int = 0,
                 prompt_buckets: Sequence[int] = (128, 256, 512, 1024, 2048,
                                                  4096, 8192),
                 session_max_bytes: int = 2 << 30, device=None,
                 quantize_weights: bool = False, quantize_kv: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.quantize_weights = bool(quantize_weights)
        self.quantize_kv = bool(quantize_kv)
        self.params = params.to(self.device)
        # the roofline's weight stream and the int8 savings read the
        # weights as given, before quantization
        self._raw_param_dtype = self.params.dtype
        self._raw_param_bytes = params_nbytes(self.params)
        if self.quantize_weights:
            self.params = quantize_params(self.params, cfg)
        self.tokenizer = tokenizer
        self.max_seq = max_seq or cfg.context_window
        self.prompt_buckets = tuple(b for b in prompt_buckets
                                    if b <= self.max_seq)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        # the engine's generator is drawn from inside the device run (the
        # sampling steps), so one lock holds the whole run, not a key
        # split as in the JAX engine: "engine.run", ranked just inside the
        # paged lock (it takes the store, tier and cache locks under it)
        self._rng_lock = named_lock("engine.run")
        # KV dtype follows the params (bf16 serving, fp32 parity tests);
        # an int8 pool keeps scales beside its pages, and the dense working
        # caches stay at the params dtype
        self.cache_dtype = self.params.dtype
        self.pool_dtype = torch.int8 if self.quantize_kv else self.cache_dtype
        # Session budget in BYTES, converted to tokens (K+V per token, the
        # scales included), capped at 32 full context windows
        token_bytes = self.kv_token_pool_bytes()
        self.sessions = SessionStore(
            max_tokens=max(PAGE, min(session_max_bytes // token_bytes,
                                     32 * self.max_seq)))
        self.sessions.model = cfg.name    # metric label
        # sessioned calls (lookup, allocation, pool writes, store-back)
        # are one atomic unit per engine
        self._paged_lock = named_lock("engine.paged")
        # Cross-session prefix sharing through the radix prefix cache
        # (SessionStore.match_prefix / insert_prefix): on by default for
        # full-attention models, as in the JAX engine; the flag gates both
        # the lookups and the store-back inserts
        self.prefix_sharing = True
        self._grammar_lock = named_lock("cache.grammar")
        self._json_cache: dict = {}
        self.last_prefill_tokens = 0   # suffix tokens actually computed
        self.last_prefill_s = 0.0
        self.last_decode_s = 0.0
        # first-shape ledger and padding-waste counts (real chunk tokens
        # against the device slots the chosen path processed)
        # Replica-tier role (serving/cluster.py): None is unrestricted
        # (the monolithic default). "prefill" caps every generate at ONE
        # new token: a prefill-tier engine builds KV and emits the first
        # token, and a longer decode on it is a routing bug the guard
        # turns into a loud error. "decode" is metadata only (decode
        # engines still prefill continuation suffixes).
        self.role: Optional[str] = None
        self.compiles = CompileRegistry(cfg.name)
        self.pad_real_tokens = 0
        self.pad_padded_tokens = 0
        self.pad_ticks = 0
        # per-call hand-off from _run_unified to _record_telemetry /
        # _note_padding; thread-local, so a sessionless call running
        # beside a sessioned chunk cannot take its shape key
        self._pending = threading.local()
        # Paged-tier gates (max prompt tokens of the batch): MEASURED data
        # from a calibration file (utils/calibration.py, env
        # QUORACLE_PAGED_CALIB), as in the JAX engine. No file: the direct
        # tier is off and the unified tier is AUTO, on for a CUDA engine
        # and off for a CPU engine (which then serves through gather).
        gates = load_paged_gates(device=self.device)
        self.paged_gates = gates
        self.direct_decode_min_tokens = gates.decode_min_resident
        self.direct_prefill_min_tokens = gates.prefill_min_resident
        self.direct_prefill_max_chunk = gates.prefill_max_chunk
        self.unified_min_tokens = resolve_unified_gate(gates, self.device)
        if self.quantize_kv:
            # int8 pools serve through the unified tier on every device
            # (the int8 ragged kernel on the card, its twin on the CPU),
            # whatever the gates say; gather stays the fallback
            self.unified_min_tokens = 0
            from quoracle_tpu_torch.infra.telemetry import (
                QUANT_KV_BYTES_PER_TOKEN,
            )
            QUANT_KV_BYTES_PER_TOKEN.set(float(token_bytes),
                                         model=cfg.name)
        if self.quantize_weights:
            from quoracle_tpu_torch.infra.telemetry import (
                QUANT_BYTES_SAVED_TOTAL,
            )
            QUANT_BYTES_SAVED_TOTAL.inc(
                max(0, self._raw_param_bytes
                    - params_nbytes(self.params)),
                model=cfg.name, tier="weights")
        # equality/fallback seams of the JAX engine: pin the gather tier
        # (decode, and with it unified) or the gather prefill
        self._force_gather_decode = False
        self._force_gather_prefill = False

    def kv_token_pool_bytes(self) -> int:
        """Pool bytes per resident KV token (int8 payload and scales when
        quantized, plain cache bytes otherwise): the session budget's and
        the tier headroom's byte rate."""
        return kv_token_bytes(
            self.cfg.n_layers, self.cfg.n_kv_heads, self.cfg.head_dim,
            torch.empty((), dtype=self.pool_dtype).element_size(),
            self.quantize_kv)

    def quant_stats(self) -> dict:
        """The engine's quantization posture: mode flags, the per-token
        KV byte rate against the bf16 rate, and their ratio."""
        bf16_rate = (2 * self.cfg.n_layers * self.cfg.n_kv_heads
                     * self.cfg.head_dim
                     * torch.empty((), dtype=self.cache_dtype)
                     .element_size())
        rate = self.kv_token_pool_bytes()
        return {
            "quantize_weights": self.quantize_weights,
            "quantize_kv": self.quantize_kv,
            "kv_bytes_per_token": rate,
            "kv_bytes_per_token_bf16": bf16_rate,
            "kv_compression": round(bf16_rate / rate, 3) if rate else None,
            "resident_kv_tokens": self.sessions.max_tokens,
        }

    def kv_signature(self) -> str:
        """The engine's exact KV geometry and dtype as a string, the JAX
        engine's own: the disk prefix store's directory and the handoff's
        compatibility check (serving/handoff.py). Two engines exchange KV
        bytes only when their signatures match exactly; an int8 pool adds
        ``-q8kv``."""
        cfg = self.cfg
        return (f"{cfg.name.replace('/', '_')}-L{cfg.n_layers}"
                f"x{cfg.n_kv_heads}x{cfg.head_dim}-p{self.sessions.page}"
                f"-{dtype_name(self.pool_dtype)}"
                + ("-q8kv" if self.quantize_kv else ""))

    def attach_tier(self, host_mb: int = 256,
                    disk_dir: Optional[str] = None,
                    disk_gb: float = 8.0) -> TierManager:
        """Turn tiered KV on (serving/kvtier.py): eviction demotes to a
        ``host_mb``-bounded host page store, a touch restores by page-in,
        and with ``disk_dir`` prefix-cache blocks persist to a checksummed
        store (``disk_gb``-bounded, LRU-pruned) that warms the next
        process. Host copies of a CUDA pool go through pinned buffers.
        Returns the TierManager (also ``sessions.tier``)."""
        tier = TierManager(self.sessions, model=self.cfg.name,
                           host_mb=host_mb, disk_dir=disk_dir,
                           signature=self.kv_signature(),
                           disk_gb=disk_gb)
        self.sessions.tier = tier
        return tier

    def prefetch_session(self, session_id: str) -> bool:
        """Warm a hibernated session before its row needs it: restore it
        by page-in if the host tier holds it. TRY-acquires the paged lock,
        so a busy engine skips the warm-up rather than block the caller
        (the sessioned generate restores at its lookup anyway). The
        page-in runs on the pool device's current stream, the one the
        engine's kernels read from."""
        tier = self.sessions.tier
        if tier is None or not tier.has_session(session_id):
            return False
        if self.sessions.get(session_id) is not None:
            return False                  # already resident
        if not self._paged_lock.acquire(blocking=False):
            return False
        try:
            self._ensure_pool()
            return tier.restore_session(session_id) is not None
        finally:
            self._paged_lock.release()

    @staticmethod
    def kernel_launches() -> dict[str, int]:
        """Launch counts of the CUDA kernels (process-wide): a GPU run
        shows here that its main path went through them."""
        return kernels.launch_counts()

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        temperature: Sequence[float] | float = 1.0,
        top_p: Sequence[float] | float = 1.0,
        max_new_tokens: Sequence[int] | int = 256,
        generator: Optional[torch.Generator] = None,
        session_ids: Optional[Sequence[Optional[str]]] = None,
        constrain_json: Optional[Sequence[bool]] = None,
        action_enums: Optional[Sequence[Optional[Sequence[str]]]] = None,
        initial_json_state: Optional[Sequence[Optional[int]]] = None,
        images: Optional[Sequence] = None,
        image_sessions: bool = False,
    ) -> list[GenResult]:
        """``session_ids`` (aligned with prompts; None entries opt out)
        enables KV residency: each row reuses the longest token prefix it
        shares with its session and prefills only the suffix; the prompt
        and response KV stay resident for the next round.
        ``action_enums`` (read where constrain_json is True) constrains
        the top-level ``"action"`` value to the given names.
        ``initial_json_state`` resumes a constrained row mid-grammar: a
        state >= 0 (relative to the row's grammar block, as
        ``GenResult.json_state`` returns it) is where the row's sampling
        starts; None or -1 starts at the grammar's start state. The
        continuous batcher (models/scheduler.py) threads it between its
        chunks.

        ``images`` (aligned; None entries are text rows) runs the VLM
        prefill on a vision model: each entry is a preprocessed [H, W, 3]
        float array whose projected patches replace the row's
        image-placeholder tokens. Image rows skip KV sessions (identical
        placeholder ids under different images must not prefix-match);
        sessioned text rows in the same call keep theirs, the batch split
        into an image call and a text call. ``image_sessions=True`` with
        any session refuses: the JAX engine then sends the rows down its
        paged tiers, which never run the tower, so the image is dropped
        (ROADMAP Queue 3)."""
        has_images = images is not None and any(i is not None
                                                for i in images)
        if self.role == "prefill":
            budgets = (max_new_tokens if not isinstance(
                max_new_tokens, int) else [max_new_tokens])
            if any(int(b) > 1 for b in budgets):
                raise ValueError(
                    f"engine {self.cfg.name} is a prefill-tier replica "
                    f"(role='prefill'): it builds KV and emits at most "
                    f"one token per row; route decode to a decode-tier "
                    f"replica (serving/cluster.py)")
        if has_images and self.cfg.vision is None:
            raise ValueError(f"model {self.cfg.name} has no vision tower")
        if has_images and image_sessions:
            if session_ids is not None and any(session_ids):
                raise ValueError(
                    "image_sessions=True with sessioned rows: the paged "
                    "tiers run no vision tower, so the image would be "
                    "dropped and the row conditioned on placeholder "
                    "embeddings; send image rows sessionless")
        elif has_images:
            txt_idx = [i for i, im in enumerate(images) if im is None]
            if txt_idx and session_ids is not None and any(
                    session_ids[i] for i in txt_idx):
                return self._generate_split(
                    txt_idx, prompts, temperature, top_p, max_new_tokens,
                    generator, session_ids, constrain_json, action_enums,
                    initial_json_state, images)
            session_ids = None       # image-only (or sessionless) batch
        if session_ids is not None and any(session_ids):
            with self._paged_lock:
                later = self._prefix_wave_split(prompts, session_ids)
                if later:
                    return self._generate_waves(
                        later, prompts, temperature, top_p, max_new_tokens,
                        generator, session_ids, constrain_json,
                        action_enums, initial_json_state)
                return self._generate_impl(
                    prompts, temperature, top_p, max_new_tokens, generator,
                    session_ids, constrain_json, action_enums,
                    initial_json_state)
        return self._generate_impl(prompts, temperature, top_p,
                                   max_new_tokens, generator, None,
                                   constrain_json, action_enums,
                                   initial_json_state,
                                   images=images if has_images else None)

    def _generate_split(self, txt_idx, prompts, temperature, top_p,
                        max_new_tokens, generator, session_ids,
                        constrain_json, action_enums, initial_json_state,
                        images) -> list[GenResult]:
        """A batch mixing image rows with sessioned text rows: the image
        rows run sessionless through the VLM prefill, then the text rows
        keep their sessions in a call of their own, as in the JAX
        engine."""
        img_idx = [i for i, im in enumerate(images) if im is not None]
        res_img = self.generate(
            _pick(prompts, img_idx), _pick(temperature, img_idx),
            _pick(top_p, img_idx), _pick(max_new_tokens, img_idx),
            generator, None, _pick(constrain_json, img_idx),
            _pick(action_enums, img_idx), _pick(initial_json_state, img_idx),
            images=_pick(images, img_idx))
        res_txt = self.generate(
            _pick(prompts, txt_idx), _pick(temperature, txt_idx),
            _pick(top_p, txt_idx), _pick(max_new_tokens, txt_idx),
            generator, _pick(session_ids, txt_idx),
            _pick(constrain_json, txt_idx), _pick(action_enums, txt_idx),
            _pick(initial_json_state, txt_idx))
        return _merge(len(prompts), (img_idx, res_img), (txt_idx, res_txt))

    def _prefix_wave_split(self, prompts, session_ids) -> list[int]:
        """Intra-batch prefix dedup (the consensus fan-out shape: K new
        sessions arrive in ONE batch sharing the built prompt): rows that
        would prefill a page-aligned prefix another row of the SAME batch
        is about to prefill — and that the radix cache does not cover yet
        — are deferred to a second wave, which then adopts the first
        wave's freshly cached pages. Returns the deferred row indices
        ([] = single wave). Windowed and vision models never share."""
        if (not self.prefix_sharing or self.cfg.sliding_window is not None
                or self.cfg.vision is not None):
            return []
        st = self.sessions
        page = st.page
        first: list[int] = []
        later: list[int] = []
        sid_counts = Counter(s for s in session_ids if s)
        with st.lock:
            seen: set = set()
            for i, sid in enumerate(session_ids):
                if not sid or sid in seen:
                    continue        # sessionless / duplicate-sid rows
                seen.add(sid)
                if sid_counts[sid] > 1:
                    # deferring the first occurrence would hand the
                    # session to the duplicate
                    continue
                if st._sessions.get(sid) is not None:
                    continue        # resident: resumes off its own pages
                cap = len(prompts[i]) - 1
                best = 0
                for j in first:
                    l = min(_lcp(prompts[j], prompts[i]), cap)
                    best = max(best, (l // page) * page)
                # defer only when waiting gains >= 1 full page over what
                # the cache would already serve this row today
                if (best >= page
                        and st.prefix_cache.match_len(prompts[i], cap)
                        < best):
                    later.append(i)
                else:
                    first.append(i)
        return later

    def _generate_waves(self, later, prompts, temperature, top_p,
                        max_new_tokens, generator, session_ids,
                        constrain_json, action_enums,
                        initial_json_state) -> list[GenResult]:
        """Two-wave sessioned generate (the caller holds _paged_lock): wave
        1 prefills the batch's unique prefixes and stores them (radix
        inserts included), wave 2 runs the deferred rows, which adopt
        those pages and prefill only their suffixes. The JAX engine splits
        its rng key between the waves; here both waves draw from the one
        generator in turn, which temperature-0 rows never read. The phase
        fields (last_prefill_tokens, _s, last_decode_s) add up over both
        waves."""
        n = len(prompts)
        later_set = set(later)
        first_idx = [i for i in range(n) if i not in later_set]

        def run(idxs):
            return self._generate_impl(
                _pick(prompts, idxs), _pick(temperature, idxs),
                _pick(top_p, idxs), _pick(max_new_tokens, idxs), generator,
                _pick(session_ids, idxs), _pick(constrain_json, idxs),
                _pick(action_enums, idxs), _pick(initial_json_state, idxs))

        res1 = run(first_idx)
        w1 = (self.last_prefill_tokens, self.last_prefill_s,
              self.last_decode_s)
        res2 = run(later)
        self.last_prefill_tokens += w1[0]
        self.last_prefill_s += w1[1]
        self.last_decode_s += w1[2]
        return _merge(n, (first_idx, res1), (later, res2))

    def drop_session(self, session_id: str) -> None:
        """Release a session's pages and discard its host-tier copy,
        with its image-digest-keyed variants (``"<sid>|img:<sha>"``, the
        JAX package's VLM session keys), in the host tier too; serialized
        with sessioned generate calls so an in-flight batch never loses
        pages it references."""
        with self._paged_lock:
            self.sessions.drop(session_id)
            prefix = session_id + "|img:"
            for key in [k for k in self.sessions._sessions
                        if k.startswith(prefix)]:
                self.sessions.drop(key)
            tier = self.sessions.tier
            if tier is not None:
                # a variant may live only in the host tier (hibernated)
                for key in [k for k in tier.host.sessions
                            if k.startswith(prefix)]:
                    tier.discard_session(key)

    def session_tokens(self, session_id: str) -> Optional[list[int]]:
        """The session's conversation ids (prompt + retained response), or
        None — what the backend splices the next round's prompt against.
        A hibernated session answers from the host tier; the generate then
        restores its pages."""
        s = self.sessions.get(session_id)
        if s is not None:
            return list(s.tokens)
        tier = self.sessions.tier
        if tier is not None:
            return tier.peek_tokens(session_id)
        return None

    def verify_chunk(self, prompts, session_ids, verify_k, *,
                     temperature=0.0, constrain_json=None,
                     action_enums=None, initial_json_state=None,
                     need_probs: bool = False) -> list[dict]:
        """Speculative VERIFY against the paged session KV: row i's prompt
        is ctx_i + proposals_i[:-1] and ``verify_k[i]`` = len(proposals_i).
        ONE teacher-forced chunk forward resumes each row's session (the
        LCP reuse of generate, capped so the whole K_i window runs) and
        returns, per row, ``ids`` (the grammar-masked argmax at the K_i
        positions that predict proposals_i), ``probs`` ([K_i, V] masked
        softmax, one-hot for temperature-0 rows) when ``need_probs``, and
        ``n_cached``. The chunk KV is stored back to the session's pages;
        rejected draft KV past the committed prefix is overwritten by the
        next round's suffix prefill (the LCP resume is the rollback).
        ``initial_json_state`` is each row's grammar state after ctx_i,
        relative to its grammar block. Every row must be sessioned."""
        if session_ids is None or not all(session_ids):
            raise ValueError("verify_chunk requires a session per row")
        if len(verify_k) != len(prompts):
            raise ValueError("verify_k must align with prompts")
        if not all(1 <= int(k) <= len(p) for k, p in zip(verify_k, prompts)):
            raise ValueError("each verify_k must lie in [1, len(prompt)]")
        with self._paged_lock:
            return self._generate_impl(
                prompts, temperature, 1.0, 1, None, session_ids,
                constrain_json, action_enums, initial_json_state,
                verify=([int(k) for k in verify_k], bool(need_probs)))

    def _generate_impl(self, prompts, temperature, top_p, max_new_tokens,
                       generator, session_ids, constrain_json,
                       action_enums, initial_json_state,
                       verify=None, images=None) -> list:
        t0 = time.monotonic()
        n = len(prompts)
        if n == 0:
            return []
        vk = verify[0] if verify is not None else None
        dev = self.device
        cfg = self.cfg
        temps = ([temperature] * n if isinstance(temperature, (int, float))
                 else list(temperature))
        tops = [top_p] * n if isinstance(top_p, (int, float)) else list(top_p)
        if isinstance(max_new_tokens, int):
            row_budgets = [max_new_tokens] * n
        else:
            row_budgets = [int(m) for m in max_new_tokens]
            if len(row_budgets) != n:
                raise ValueError("max_new_tokens must align with prompts")
        max_prompt = max(len(p) for p in prompts)
        if max_prompt >= self.max_seq:
            raise ContextOverflowError(
                f"prompt of {max_prompt} tokens >= max_seq {self.max_seq} "
                f"for model {cfg.name}")

        # Session prefix lookup: reuse_abs counts ABSOLUTE tokens reused;
        # the row's buffer prefix is reuse_abs - start_pos. A session id
        # appearing twice in one batch would collide on its pages — later
        # duplicates run sessionless.
        sess_rows: list[Optional[_Session]] = [None] * n
        reuse_abs = [0] * n
        kv_off_host = [0] * n
        store_sids: list[Optional[str]] = [None] * n
        paged = False
        if session_ids is not None:
            seen: set[str] = set()
            for i, sid in enumerate(session_ids):
                if not sid or sid in seen:
                    continue
                seen.add(sid)
                store_sids[i] = sid
                paged = True
                s = self.sessions.get(sid)
                if (s is None and self.sessions.tier is not None
                        and self.sessions.tier.has_session(sid)):
                    # hibernated: restore by page-in instead of re-prefill
                    # (the caller holds _paged_lock, so no paged step
                    # races the copy); any failure re-prefills
                    try:
                        self._ensure_pool()
                        s = self.sessions.tier.restore_session(sid)
                    except Exception:     # noqa: BLE001 — fall back
                        logging.getLogger(__name__).exception(
                            "kv restore failed for %s; re-prefilling", sid)
                        s = None
                if s is None:
                    # a NEW session whose prompt starts with a radix-cached
                    # page-aligned prefix adopts those pages: _run_paged
                    # acquires them and uses them as the row's dst prefix,
                    # so only the suffix prefills (windowed models never
                    # share, nor do vision models: identical placeholder
                    # ids can front different images)
                    if (self.prefix_sharing
                            and cfg.sliding_window is None
                            and cfg.vision is None):
                        # verify: the last K_i positions are the window
                        # and must run through the chunk forward
                        cap = (len(prompts[i]) - 1 if vk is None
                               else len(prompts[i]) - vk[i])
                        t_pl = time.monotonic()
                        if self.sessions.tier is not None:
                            # a tiered lookup may page blocks into the
                            # pool, which must exist first
                            self._ensure_pool()
                        d = (self.sessions.match_prefix(prompts[i], cap)
                             if cap > 0 else None)
                        PREFIX_LOOKUP_MS.observe(
                            (time.monotonic() - t_pl) * 1000,
                            model=cfg.name)
                        if d is not None:
                            sess_rows[i] = d
                            reuse_abs[i] = len(d.tokens)
                    continue
                # >= 1 suffix token must run to produce last-position logits
                # (verify: the whole K_i window must run)
                p = min(_lcp(s.tokens, prompts[i]),
                        len(prompts[i]) - 1 if vk is None
                        else len(prompts[i]) - vk[i])
                if cfg.sliding_window is not None and p < len(s.tokens):
                    # windowed models resume only on clean extension
                    continue
                if p > s.start_pos:
                    sess_rows[i] = s
                    reuse_abs[i] = p
                    kv_off_host[i] = s.start_pos

        prefixes = [r - o for r, o in zip(reuse_abs, kv_off_host)]
        suffixes = [list(p[r:]) for p, r in zip(prompts, reuse_abs)]
        max_chunk = max(len(s) for s in suffixes)
        # verify chunks are K-token windows (plus the odd full re-prefill):
        # small buckets keep them from padding to the prompt floor
        T = _round_up(max_chunk,
                      tuple(sorted({8, 16, 32, 64, *self.prompt_buckets}))
                      if vk is not None else self.prompt_buckets)
        B = _round_up(n, self.BATCH_BUCKETS)
        # the decode bound is bucketed too; per-row limits stop each row at
        # its own budget
        max_new = _round_up(min(max(row_budgets), self.max_seq - 1),
                            MAX_NEW_BUCKETS)
        cache_len = _round_up(max(prefixes) + T,
                              self.prompt_buckets) + max_new
        page = self.sessions.page
        maxp = -(-cache_len // page)      # pages per row (paged path)
        if paged:
            # the paged extent: the shape key and roofline context
            cache_len = maxp * page

        tokens = np.full((B, T), self.tokenizer.pad_id, np.int32)
        pre_arr = np.zeros((B,), np.int32)
        off_arr = np.zeros((B,), np.int32)
        chunk_arr = np.ones((B,), np.int32)  # padded rows: 1 (harmless)
        limits = np.ones((B,), np.int32)
        for i, s in enumerate(suffixes):
            tokens[i, :len(s)] = s
            pre_arr[i] = prefixes[i]
            off_arr[i] = kv_off_host[i]
            chunk_arr[i] = max(1, len(s))
            total = max(1, len(prompts[i]))
            limits[i] = max(1, min(row_budgets[i], self.max_seq - total))
        temp_arr = np.zeros((B,), np.float32)
        temp_arr[:n] = temps
        top_arr = np.ones((B,), np.float32)
        top_arr[:n] = tops
        active = np.zeros((B,), bool)
        active[:n] = True
        if generator is None:
            generator = self._generator

        # JSON grammar: flagged rows start in their grammar's start state,
        # or resume a mid-stream state, -1 rows sample unconstrained;
        # distinct grammars (action enums) stack into one table with offset
        # state ids
        json_table = None
        jstate_np = None
        grammar_bases = None
        if constrain_json is not None and any(constrain_json):
            enums = [None] * n
            if action_enums is not None:
                enums = [tuple(sorted(set(e))) if e else None
                         for e in action_enums]
            distinct = sorted({e for e, f in zip(enums, constrain_json) if f},
                              key=lambda e: (e is not None, e or ()))
            json_table, offsets, bases = self._json_table_device(
                tuple(distinct))
            grammar_bases = [bases.get(e, 0) for e in enums]
            jstate_np = np.full((B,), -1, np.int32)
            for i, flag in enumerate(constrain_json):
                if flag:
                    # states travel RELATIVE to their grammar's block
                    # base, so they survive different table stackings
                    # across calls
                    init_js = (initial_json_state[i]
                               if initial_json_state is not None else None)
                    if init_js is not None and init_js >= 0:
                        jstate_np[i] = grammar_bases[i] + init_js
                    else:
                        jstate_np[i] = offsets[enums[i]]

        samp_np = (temp_arr, top_arr, active, limits)
        vrun = None
        if verify is not None:
            # every verify row is sessioned (checked by verify_chunk)
            if not paged:
                raise ValueError("verify requires the paged session path")
            k_arr = np.ones((B,), np.int32)
            k_arr[:n] = vk
            vrun = (k_arr, _round_up(max(vk), (4, 8, 16)), verify[1])
        with self._rng_lock:
            if paged:
                out, n_emitted, jstate_f, t_prefill, now, vout = \
                    self._run_paged(
                        prompts, suffixes, sess_rows, reuse_abs,
                        kv_off_host, store_sids, B, maxp, tokens, pre_arr,
                        off_arr, chunk_arr, samp_np, jstate_np, json_table,
                        generator, max_new, vrun)
            else:
                out, n_emitted, jstate_f, t_prefill, now = self._run_dense(
                    tokens, chunk_arr, cache_len, samp_np, jstate_np,
                    json_table, generator, max_new, images)
        self.last_prefill_tokens = sum(len(s) for s in suffixes)
        self.last_prefill_s = t_prefill - t0
        self.last_decode_s = now - t_prefill
        latency = now - t0
        # padding waste: chunk-token slots the device processed this call
        # against its real tokens (the unified tier's flat token budget
        # replaces the [B, T] rectangle)
        padded_toks = getattr(self._pending, "padded_tokens", None)
        self._pending.padded_tokens = None
        self._note_padding(sum(max(1, len(s)) for s in suffixes),
                           B * T if padded_toks is None else padded_toks)
        # chip-ms: each phase's measured wall split across the rows by
        # real tokens, padding on the overhead key; reads the row keys
        # the batcher declared on this thread, host counts only
        chip_ms_rows = costobs.charge_step(
            self, n=n,
            prefill_weights=([max(1, len(s)) for s in suffixes[:n]]
                             if vrun is None else [int(k) for k in vk]),
            decode_weights=[int(n_emitted[i]) for i in range(n)],
            padded_prefill=(B * T if padded_toks is None
                            else padded_toks),
            padded_decode=(B * vrun[1] if vrun is not None
                           else B * max_new),
            cache_len=cache_len, verify=vrun is not None,
            prefill_bucket=vrun[1] if vrun is not None else T,
            decode_bucket=max_new)
        # liveness: tokens the device produced this call
        introspect.beat(f"engine.tokens:{cfg.name}",
                        sum(int(n_emitted[i]) for i in range(n)))
        self._record_telemetry(n, B, T, cache_len,
                               vrun[1] if vrun is not None else max_new,
                               "verify" if vrun is not None else paged,
                               n_emitted, latency)

        if verify is not None:
            vids, vprobs = vout
            # window position t predicts proposals[t]; the first K_i
            # entries are the row's verdicts (kmax padding is garbage)
            return [{
                "ids": [int(x) for x in vids[i, :vk[i]]],
                "probs": (np.asarray(vprobs[i, :vk[i]], np.float32)
                          if vprobs is not None else None),
                "n_cached": reuse_abs[i],
                "chip_ms": chip_ms_rows[i],
            } for i in range(n)]

        stop_set = {cfg.eos_token_id, *cfg.stop_token_ids}
        results = []
        for i in range(n):
            # extract by emitted COUNT, never by sentinel scan: pad_id may
            # be a real vocab token
            k = min(int(n_emitted[i]), row_budgets[i])
            ids = [int(t) for t in out[i, :k]]
            finish = "length"
            if ids and ids[-1] in stop_set:
                ids.pop()
                finish = "stop"
            results.append(GenResult(
                token_ids=ids,
                text=self.tokenizer.decode(ids),
                n_prompt_tokens=len(prompts[i]),
                n_gen_tokens=len(ids),
                latency_s=latency,
                finish_reason=finish,
                n_cached_tokens=reuse_abs[i],
                json_state=(int(jstate_f[i]) - grammar_bases[i]
                            if constrain_json is not None
                            and constrain_json[i] else -1),
                chip_ms=chip_ms_rows[i],
            ))
        return results

    def _record_telemetry(self, n: int, B: int, T: int, cache_len: int,
                          max_new: int, paged, n_emitted,
                          latency: float) -> None:
        """Per-call observations: device phase walls, per-wave prefill
        token throughput, per-emitted-token decode time, and the call's
        shape key in the first-shape ledger (a first sight emits the
        ``generate.first_shape_compile`` span). Pure observation of host
        counts: no RNG, no device work."""
        name = self.cfg.name
        PREFILL_MS.observe(self.last_prefill_s * 1000, model=name)
        DECODE_MS.observe(self.last_decode_s * 1000, model=name)
        if self.last_prefill_s > 0 and self.last_prefill_tokens:
            PREFILL_TOKENS_PER_S.observe(
                self.last_prefill_tokens / self.last_prefill_s, model=name)
        steps = max((int(n_emitted[i]) for i in range(n)), default=0)
        if steps > 0 and self.last_decode_s > 0:
            DECODE_STEP_MS.observe(self.last_decode_s * 1000 / steps,
                                   model=name)
        # the unified tier keys its calls on (flat token budget, table
        # width, decode bound), as the JAX engine keys its programs
        shape = getattr(self._pending, "shape_key", None)
        self._pending.shape_key = None
        if shape is None:
            shape = (B, T, cache_len, max_new, paged)
        first = self.compiles.record(shape, latency * 1000)
        if first:
            JIT_COMPILES.inc(model=name)
            if self.quantize_kv:
                from quoracle_tpu_torch.infra.telemetry import (
                    QUANT_DEQUANT_COMPILES_TOTAL,
                )
                QUANT_DEQUANT_COMPILES_TOTAL.inc(model=name)
        if first and TRACER.active():
            # only while a sink listens: with none, no span is built
            TRACER.emit(
                "generate.first_shape_compile", latency * 1000,
                model=name, phase="compile",
                shape=f"B{B}xT{T}xC{cache_len}xN{max_new}"
                      + ("p" if paged else ""))

    def _note_padding(self, real: int, padded: int) -> None:
        """Account one call's chunk-token padding waste: ``real`` tokens
        the caller submitted against ``padded`` device slots the chosen
        path processed ([B·T] for the bucketed paths, the flat token
        budget for the unified tier)."""
        from quoracle_tpu_torch.infra.telemetry import (
            SCHED_PAD_WASTE_RATIO, SCHED_PADDED_TOKENS_TOTAL,
            SCHED_REAL_TOKENS_TOTAL,
        )
        name = self.cfg.name
        self.pad_real_tokens += int(real)
        self.pad_padded_tokens += int(padded)
        self.pad_ticks += 1
        SCHED_REAL_TOKENS_TOTAL.inc(int(real), model=name)
        SCHED_PADDED_TOKENS_TOTAL.inc(int(padded), model=name)
        SCHED_PAD_WASTE_RATIO.set(
            (padded - real) / padded if padded else 0.0, model=name)

    def padding_stats(self) -> dict:
        """Cumulative padding-waste view: what raggedness reclaims."""
        padded = self.pad_padded_tokens
        return {
            "ticks": self.pad_ticks,
            "real_tokens": self.pad_real_tokens,
            "padded_tokens": padded,
            "waste_ratio": (round(1 - self.pad_real_tokens / padded, 4)
                            if padded else None),
        }

    def _run_dense(self, tokens, chunk_arr, cache_len, samp_np, jstate_np,
                   json_table, generator, max_new, images=None):
        """Sessionless rows: dense prefill (flash for long chunks on the
        GPU) into a fresh [L, B, cache_len] cache, then the dense decode.
        With ``images`` the prefill is the VLM's (``prefill_vlm``): every
        row of the padded batch runs through the tower, text rows on zero
        pixels (they hold no placeholder, so nothing is spliced)."""
        dev = self.device
        cfg = self.cfg
        B = tokens.shape[0]
        cache = init_cache(cfg, B, cache_len, dev, dtype=self.cache_dtype)
        tok_t = torch.as_tensor(tokens, device=dev)
        lens_t = torch.as_tensor(chunk_arr, device=dev)
        if images is not None:
            vc = cfg.vision
            pixels = np.zeros((B, vc.image_size, vc.image_size, 3),
                              np.float32)
            for i, img in enumerate(images):
                if img is not None:
                    pixels[i] = np.asarray(img, np.float32)
            last_logits, cache = prefill_vlm(
                self.params, cfg, tok_t, lens_t, cache,
                torch.as_tensor(pixels, device=dev))
        else:
            last_logits, cache = prefill(self.params, cfg, tok_t, lens_t,
                                         cache)
        _fence(dev)
        t_prefill = time.monotonic()
        temp, top, active, limits = (torch.as_tensor(a, device=dev)
                                     for a in samp_np)
        out, n_emitted, _, jstate_f = decode(
            self.params, cfg, cache, last_logits, generator, temp, top,
            max_new, cfg.eos_token_id, active=active, row_limit=limits,
            pad_id=self.tokenizer.pad_id, stop_ids=cfg.stop_token_ids,
            json_table=json_table,
            json_state=(None if jstate_np is None
                        else torch.as_tensor(jstate_np, device=dev)))
        out, n_emitted, jstate_f = (x.cpu().numpy()
                                    for x in (out, n_emitted, jstate_f))
        now = time.monotonic()
        return out, n_emitted, jstate_f, t_prefill, now

    def _ensure_pool(self) -> None:
        """Allocate the device page pool on the first sessioned call; an
        int8 pool gets its fp32 scale pools of ones, [L, n_pages, KV,
        page]."""
        st = self.sessions
        if st.k is not None:
            return
        L, KV = self.cfg.n_layers, self.cfg.n_kv_heads
        shape = (L, st.n_pages, st.page, KV, self.cfg.head_dim)
        st.k = torch.zeros(shape, dtype=self.pool_dtype, device=self.device)
        st.v = torch.zeros(shape, dtype=self.pool_dtype, device=self.device)
        if self.quantize_kv:
            sshape = (L, st.n_pages, KV, st.page)
            st.k_scale = torch.ones(sshape, dtype=torch.float32,
                                    device=self.device)
            st.v_scale = torch.ones_like(st.k_scale)

    def _run_paged(self, prompts, suffixes, sess_rows, reuse_abs,
                   kv_off_host, store_sids, B, maxp, tokens, pre_arr,
                   off_arr, chunk_arr, samp_np, jstate_np, json_table,
                   generator, max_new, verify=None):
        """The sessioned call: allocate each stored row's dst pages (its
        own resident pages first, LRU eviction for the rest), pick the
        tier as the JAX engine does, run it, then store every session's
        page list back (ints only — no KV bytes move through the host).
        The caller holds ``_paged_lock``.

        Prefix sharing: an adopted radix prefix is acquired before any
        allocation and becomes the row's dst prefix (the stored session
        takes over that reference). A shared page the row would rewrite
        past its identical prefix is swapped for a fresh one
        (copy-on-write); swapping the partly reused boundary page leaves a
        dst hole only the gather scatter fills (``partial_swap``).

        Tier choice (the JAX ``_run_paged``): unified and direct decode
        each need their gate and no ``_force_gather_decode``, and the
        direct tier an unquantized pool; both read every row's prompt from
        pages, so rows without a stored session borrow TEMP pages from the
        free list, and when there are none both are off. Unified and the
        direct prefill also need every resumed row to write through its
        own pages (a declined store rules them out) and no
        ``partial_swap``. The direct prefill has its own gate and chunk
        cap. What remains is gather.

        ``verify`` (k_arr, kmax, need_probs) runs a speculative verify
        chunk instead of a decode: on the unified tier, or else on the
        gather tier (never direct: it is a chunk forward, not a decode
        loop). Returns (out, n_emitted, jstate_f, t_prefill, now, vout);
        vout is (ids [rows, kmax], probs or None) under verify, else
        None."""
        n = len(prompts)
        st = self.sessions
        page = st.page
        self._ensure_pool()
        limits = samp_np[3]
        src = np.zeros((B, maxp), np.int32)
        dst = np.zeros((B, maxp), np.int32)
        dst_lists: list[Optional[list[int]]] = [None] * n
        temp_lists: list[Optional[list[int]]] = [None] * n
        spills: list[list[int]] = [[] for _ in range(n)]
        protect = tuple(s for s in store_sids if s)
        max_prompt = max(len(p) for p in prompts)
        use_direct = (not self._force_gather_decode
                      and verify is None
                      and not self.quantize_kv
                      and max_prompt >= self.direct_decode_min_tokens)
        unified_ok = (not self._force_gather_decode
                      and max_prompt >= self.unified_min_tokens)
        adopted_release: list[list[int]] = [[] for _ in range(n)]
        partial_swap = False
        with st.lock:   # one allocation transaction for the batch
            # acquire every adopted prefix FIRST: an alloc below may evict
            # its other holders, and the pages must outlive this call's
            # steps
            for i in range(n):
                s = sess_rows[i]
                if s is not None and s.shared_prefix:
                    st.acquire(s.pages)
                    adopted_release[i] = list(s.pages)
            for i in range(n):
                s = sess_rows[i]
                if s is not None:
                    # pages past this call's table width hold KV past the
                    # reusable prefix: never read (prefix <= maxp·page)
                    k = min(len(s.pages), maxp)
                    src[i, :k] = s.pages[:k]
                if store_sids[i] is None:
                    continue
                # dst reuses the STORED session's pages even when the
                # prefix-reuse decision declined them: their content is
                # dead either way, and put_raw must not leak them
                stored = st._sessions.get(store_sids[i])
                old = list(stored.pages) if stored is not None else []
                if stored is None and s is not None and s.shared_prefix:
                    # the adopted prefix becomes the dst prefix (rewritten
                    # with the gathered, byte-identical values) and the
                    # stored session owns the reference acquired above
                    old = list(s.pages)
                    adopted_release[i] = []
                # resident pages past the table width can't be rewritten
                # this call: release them after the batch
                spills[i], old = old[maxp:], old[:maxp]
                # SHARED pages are writable only inside the row's
                # identical-prefix region; a gather scatter writes every
                # dst slot. Shared pages past ``need`` leave dst (our
                # reference released), shared ones before it are swapped
                # for fresh pages (copy-on-write)
                pre_buf = reuse_abs[i] - kv_off_host[i]
                safe_full = pre_buf // page
                need_tokens = min(pre_buf + len(suffixes[i])
                                  + int(limits[i]), maxp * page)
                need = -(-need_tokens // page)
                tail_shared = [pg for j, pg in enumerate(old)
                               if j >= need and st._refs.get(pg, 1) > 1]
                if tail_shared:
                    old = [pg for j, pg in enumerate(old)
                           if not (j >= need and st._refs.get(pg, 1) > 1)]
                shared_beyond = [j for j, pg in enumerate(old)
                                 if safe_full <= j < need
                                 and st._refs.get(pg, 1) > 1]
                # the direct prefill and the unified tick write only chunk
                # positions >= pre_buf: a swapped, partly reused boundary
                # page needs the gather scatter
                if any(j == safe_full and pre_buf % page
                       for j in shared_beyond):
                    partial_swap = True
                if shared_beyond:
                    st.prefix_cache.note_cow(len(shared_beyond))
                n_extra = max(0, need - len(old)) + len(shared_beyond)
                if n_extra:
                    extra = st.alloc(n_extra, protect=protect)
                    if extra is None:
                        # pool exhausted even after eviction: serve the
                        # row without storing (old session stays valid);
                        # an adoption reverts to read-only use
                        store_sids[i] = None
                        spills[i] = []
                        if s is not None and s.shared_prefix:
                            adopted_release[i] = list(s.pages)
                        continue
                    for j in shared_beyond:
                        st._release([old[j]])   # our ref; others keep
                        old[j] = extra.pop()
                    old = old + extra
                st._release(tail_shared)        # our refs; others keep
                dst_lists[i] = old
                dst[i, :len(old)] = old
            if use_direct or unified_ok:
                for i in range(n):
                    if dst_lists[i] is not None:
                        continue
                    need_tokens = min(len(suffixes[i]) + int(limits[i])
                                      + int(pre_arr[i]), maxp * page)
                    # free-list only: pages that die at call end must not
                    # evict other agents' resident sessions
                    tmp = st.alloc(-(-need_tokens // page), protect=protect,
                                   evict=False)
                    if tmp is None:
                        use_direct = unified_ok = False
                        break
                    temp_lists[i] = tmp
                    dst[i, :len(tmp)] = tmp
                if not (use_direct or unified_ok):
                    for i, tmp in enumerate(temp_lists):
                        if tmp:
                            st._release(tmp)
                        temp_lists[i] = None

        # every resumed row must read its prefix from the SAME pages the
        # unified kernel / direct prefill write (nothing relocates it),
        # and no swapped boundary page may leave a hole in dst
        own_pages = not partial_swap and all(
            sess_rows[i] is None or dst_lists[i] is not None
            for i in range(n))
        T = tokens.shape[1]
        use_direct_pre = (use_direct and own_pages
                          and not self._force_gather_prefill
                          and max_prompt >= self.direct_prefill_min_tokens
                          and T <= self.direct_prefill_max_chunk)
        use_unified = unified_ok and own_pages

        if use_unified:
            out, n_emitted, final_lens, jstate_f, t_prefill, now, vout = \
                self._run_unified(n, suffixes, dst, pre_arr, off_arr,
                                  chunk_arr, samp_np, jstate_np, json_table,
                                  generator, max_new, maxp, verify=verify)
        else:
            out, n_emitted, final_lens, jstate_f, t_prefill, now, vout = \
                self._run_split(n, suffixes, src, dst, tokens, pre_arr,
                                off_arr, chunk_arr, samp_np, jstate_np,
                                json_table, generator, max_new, maxp,
                                use_direct, use_direct_pre, verify=verify)

        for i in range(n):
            sid, pages = store_sids[i], dst_lists[i]
            if sid is None or pages is None:
                continue
            valid = int(final_lens[i])            # buffer tokens with KV
            used = max(1, -(-valid // page))
            st.release(spills[i])
            st.release(pages[used:])
            pages = pages[:used]
            start = kv_off_host[i]
            abs_valid = start + valid
            plen = len(prompts[i])
            toks = list(prompts[i]) + [
                int(t) for t in out[i, :abs_valid - plen]]
            W = self.cfg.sliding_window
            if W is not None and valid - W >= page:
                # bound the resident footprint to the attention window
                drop = (valid - W) // page
                st.release(pages[:drop])
                pages = pages[drop:]
                start += drop * page
            st.put_raw(sid, _Session(tokens=toks, pages=pages,
                                     start_pos=start))
            # every FULL page of a conversation stored from position 0
            # becomes adoptable (windowed sessions and vision models never
            # share); a verify store-back carries unverified draft tokens
            # at its tail: resumable (the LCP is token-keyed), but not
            # shared
            if (self.prefix_sharing and start == 0 and W is None
                    and self.cfg.vision is None and verify is None):
                st.insert_prefix(toks, pages)
        # temp pages (sessionless rows on the page-reading tiers) die with
        # the call; adoptions no stored session took over release now
        for pages in temp_lists + adopted_release:
            if pages:
                st.release(pages)
        return out, n_emitted, jstate_f, t_prefill, now, vout

    def _run_split(self, n, suffixes, src, dst, tokens, pre_arr, off_arr,
                   chunk_arr, samp_np, jstate_np, json_table, generator,
                   max_new, maxp, use_direct, use_direct_pre, verify=None):
        """The direct and gather tiers. Prefill: the direct paged prefill
        (chunk against pages, chunk KV to dst pages) or the gather prefill
        (working cache). Decode: the direct decode (pages + tail, after
        the working cache, if any, is copied to dst pages; the tail is
        copied after) or the gather decode (working cache, then prompt
        and response KV copied to dst pages). Under ``verify`` the gather
        tier runs the verify chunk instead (``step_paged_verify``), and
        the chunk's KV is copied to the dst pages."""
        st = self.sessions
        dev = self.device
        page = st.page

        def put(a):
            return torch.as_tensor(a, device=dev)

        temp, top, active, limits = (put(a) for a in samp_np)
        jstate0 = None if jstate_np is None else put(jstate_np)
        off_dev = put(off_arr)
        if verify is not None:
            k_arr, kmax, need_probs = verify
            vids, vprobs, cache = self.step_paged_verify(
                put(src), put(tokens), put(pre_arr), put(chunk_arr),
                off_dev, put(k_arr), temp, json_table, jstate0, n, kmax,
                need_probs)
            _fence(dev)
            t_prefill = time.monotonic()
            self.step_scatter_prompt(cache.k, cache.v, put(dst))
            vout = (vids.cpu().numpy(),
                    None if vprobs is None else vprobs.cpu().numpy())
            _fence(dev)
            B = tokens.shape[0]
            return (np.zeros((B, 0), np.int32), np.zeros((B,), np.int32),
                    pre_arr + chunk_arr, np.full((B,), -1, np.int32),
                    t_prefill, time.monotonic(), vout)
        if use_direct_pre:
            n_tok = st.n_pages * page
            T = tokens.shape[1]
            flat = np.full((tokens.shape[0], T), n_tok, np.int32)  # = drop
            for i in range(n):
                n_chunk = min(len(suffixes[i]) or 1,
                              maxp * page - int(pre_arr[i]))
                pos = int(pre_arr[i]) + np.arange(max(0, n_chunk))
                flat[i, :len(pos)] = dst[i, pos // page] * page + pos % page
            last_logits = self.step_paged_prefill_direct(
                put(src), put(tokens), put(pre_arr), put(chunk_arr),
                off_dev, put(flat))
            cache = None
            pool_lens = pre_arr + chunk_arr
        else:
            last_logits, cache = self.step_paged_prefill(
                put(src), put(tokens), put(pre_arr), put(chunk_arr),
                off_dev)
        _fence(dev)
        t_prefill = time.monotonic()

        if use_direct:
            if cache is not None:
                pool_lens = cache.lens.cpu().numpy()
                self.step_scatter_prompt(cache.k, cache.v, put(dst))
                cache = None                    # the working cache frees
            out, n_emitted, final_lens, tail_k, tail_v, jstate_f = \
                self.step_paged_decode_direct(
                    put(dst), put(pool_lens), off_dev, last_logits,
                    generator, temp, top, active, limits, json_table,
                    jstate0, max_new)
            out, n_emitted, final_lens, jstate_f = (
                x.cpu().numpy() for x in (out, n_emitted, final_lens,
                                          jstate_f))
            flat = np.full((dst.shape[0], max_new), st.n_pages * page,
                           np.int32)            # out of range = drop
            for i in range(n):
                n_tail = int(final_lens[i]) - int(pool_lens[i])
                if n_tail <= 0:
                    continue
                pos = int(pool_lens[i]) + np.arange(n_tail)
                pos = pos[pos < maxp * page]
                flat[i, :len(pos)] = dst[i, pos // page] * page + pos % page
            self.step_scatter_tail(tail_k, tail_v, put(flat))
        else:
            out, n_emitted, final_lens, jstate_f = self.step_paged_decode(
                cache, put(dst), off_dev, last_logits, generator, temp, top,
                active, limits, json_table, jstate0, max_new)
            out, n_emitted, final_lens, jstate_f = (
                x.cpu().numpy() for x in (out, n_emitted, final_lens,
                                          jstate_f))
        # the page copies belong to this call's decode phase
        _fence(dev)
        now = time.monotonic()
        return out, n_emitted, final_lens, jstate_f, t_prefill, now, None

    # -- the paged steps: plain methods over the pool, written in place
    # where the JAX jits donate it --

    def _gather_work(self, src: torch.Tensor) -> tuple:
        """Resident pages -> dense working cache [L, B, maxp·page, KV, hd]
        (k, v): one device gather by the page table; int8 pools dequantize
        per (token, kv-head) in fp32 and cast to the working dtype."""
        st = self.sessions
        L, _, page, KV, HD = st.k.shape
        B, maxp = src.shape
        idx = src.long()
        work = []
        for pool, spool in ((st.k, st.k_scale), (st.v, st.v_scale)):
            w = pool[:, idx].reshape(L, B, maxp * page, KV, HD)
            if self.quantize_kv:
                s = spool[:, idx].transpose(3, 4).reshape(
                    L, B, maxp * page, KV)
                w = (w.float() * s[..., None]).to(self.cache_dtype)
            work.append(w)
        return tuple(work)

    @torch.no_grad()
    def step_paged_prefill(self, src, tokens, prefix_lens, chunk_lens,
                           kv_off):
        """Gather tier prefill: the rows' resident pages gathered into a
        dense working cache [L, B, maxp·page, KV, hd] (one device gather;
        the host only sends the page table), then the suffix chunk through
        the dense ``prefill_chunk``. Returns (last-token logits [B, V],
        cache)."""
        k, v = self._gather_work(src)
        cache = KVCache(k=k, v=v, lens=torch.zeros(
            (src.shape[0],), dtype=torch.int32, device=src.device))
        return prefill_chunk(self.params, self.cfg, tokens, prefix_lens,
                             chunk_lens, cache, kv_off=kv_off)

    @torch.no_grad()
    def step_paged_decode(self, cache, dst, kv_off, last_logits, generator,
                          temperature, top_p, active, row_limit, json_table,
                          json_state, max_new: int):
        """Gather tier decode: the dense ``decode`` over the working cache,
        then prompt and response KV copied back to the dst pages. Returns
        (tokens, n_emitted, lens, jstate)."""
        cfg = self.cfg
        out, n_emitted, cache, jstate = decode(
            self.params, cfg, cache, last_logits, generator, temperature,
            top_p, max_new, cfg.eos_token_id, active=active,
            row_limit=row_limit, pad_id=self.tokenizer.pad_id,
            stop_ids=cfg.stop_token_ids, json_table=json_table,
            json_state=json_state, kv_off=kv_off)
        self.step_scatter_prompt(cache.k, cache.v, dst)
        return out, n_emitted, cache.lens, jstate

    @torch.no_grad()
    def step_paged_verify(self, src, tokens, prefix_lens, chunk_lens, kv_off,
                          k_arr, temperature, json_table, json_state,
                          n: int, kmax: int, need_probs: bool):
        """Gather tier verify: the rows' resident pages gathered into a
        working cache, the teacher-forced chunk [pending, d_1..d_{K-1}]
        through the dense forward, and the verdicts of each row's last
        ``k_arr`` chunk positions (``_verdicts``, the first ``n`` rows).
        Returns (ids [n, kmax], probs or None, cache); the caller copies
        the working cache back to the rows' pages."""
        k, v = self._gather_work(src)
        B, T = tokens.shape
        cache = KVCache(k=k, v=v, lens=torch.zeros(
            (B,), dtype=torch.int32, device=src.device))
        positions = (prefix_lens[:, None]
                     + torch.arange(T, dtype=torch.int32,
                                    device=tokens.device)[None, :]
                     + kv_off.to(torch.int32)[:, None])
        total = (prefix_lens + chunk_lens).to(torch.int32)
        hidden, cache = forward_hidden(
            self.params, self.cfg, tokens, positions, cache,
            write_offset=prefix_lens.to(torch.int32), kv_lens=total,
            kv_pos_offset=kv_off)
        cache.lens = total
        # the verify window: each row's last k_arr chunk positions
        widx = torch.clamp(
            (chunk_lens - k_arr)[:, None]
            + torch.arange(kmax, device=tokens.device)[None, :],
            0, T - 1).long()[:n]
        rows = torch.arange(n, device=tokens.device)[:, None]
        ids, probs = self._verdicts(
            hidden[rows, widx], tokens[rows, widx], json_table,
            None if json_state is None else json_state[:n],
            temperature[:n], need_probs)
        return ids, probs, cache

    def _verdicts(self, wh, wtok, json_table, json_state, temperature,
                  need_probs: bool):
        """Verify-window verdicts, one recipe for both tiers: logits at
        the window's hidden states ``wh`` [R, kmax, D]; under a grammar,
        each position's state walked from ``json_state`` (the state after
        ctx) over the window's draft tokens ``wtok[:, 1:]`` — the mask at
        position t is the one vanilla decode applies there — then the
        argmax, and the temperature softmax (one-hot for temperature-0
        rows) when ``need_probs``. Returns (ids [R, kmax], probs or
        None)."""
        cfg = self.cfg
        logits = project_logits(self.params, cfg, wh)       # [R, kmax, V]
        R, kmax, V = logits.shape
        if json_table is not None:
            s = json_state.to(torch.int32)
            states = [s]
            for t in range(1, kmax):
                nxt = json_table[torch.clamp(s, min=0).long(),
                                 wtok[:, t].long()].to(torch.int32)
                s = torch.where(s >= 0, nxt, s)
                states.append(s)
            logits = grammar_mask(
                logits.reshape(R * kmax, V),
                torch.stack(states, dim=1).reshape(-1), json_table,
                cfg.eos_token_id).reshape(R, kmax, V)
        ids = torch.argmax(logits, dim=-1)
        probs = None
        if need_probs:
            temp = temperature.to(torch.float32)
            probs = torch.softmax(
                logits / torch.clamp(temp, min=1e-6)[:, None, None], dim=-1)
            hot = torch.nn.functional.one_hot(ids, V).to(probs.dtype)
            probs = torch.where((temp <= 0)[:, None, None], hot, probs)
        return ids, probs

    @torch.no_grad()
    def step_paged_prefill_direct(self, src_tables, tokens, prefix_lens,
                                  chunk_lens, kv_off, flat_dst):
        """Direct tier prefill: the suffix chunk attends to the resident
        prefix straight off its pages (the paged prefill kernel on the
        card) and its KV is copied into the dst pages in place; no working
        cache. Returns the last-token logits [B, V]."""
        st = self.sessions
        B, T = tokens.shape
        positions = ((prefix_lens + kv_off).to(torch.int32)[:, None]
                     + torch.arange(T, dtype=torch.int32,
                                    device=tokens.device)[None, :])
        hidden, st.k, st.v = forward_hidden_paged_prefill(
            self.params, self.cfg, tokens, positions, st.k, st.v,
            src_tables, prefix_lens, chunk_lens, flat_dst)
        rows = torch.arange(B, device=tokens.device)
        last_h = hidden[rows, (chunk_lens - 1).long()]
        return project_logits(self.params, self.cfg, last_h)

    def step_scatter_prompt(self, k_work: torch.Tensor,
                            v_work: torch.Tensor, dst: torch.Tensor) -> None:
        """Working cache -> dst pages, in place: before the direct decode
        (which then reads pages only), or after the gather decode. Page ids
        out of range drop (the JAX ``mode="drop"``); rows without pages
        point at scratch page 0. Int8 pools requantize each (token,
        kv-head) with the shared rule (models/quant.kv_quant) and write
        the scales beside the pages, one layer at a time (the fp32
        temporaries of a whole working cache would be L times larger)."""
        st = self.sessions
        L, n_pages, page, KV, HD = st.k.shape
        B, maxp = dst.shape
        flat = dst.reshape(-1)
        keep = torch.nonzero((flat >= 0) & (flat < n_pages))[:, 0]
        pid = flat[keep].long()
        for pool, spool, work in ((st.k, st.k_scale, k_work),
                                  (st.v, st.v_scale, v_work)):
            pages = work.reshape(L, B * maxp, page, KV, HD) \
                .index_select(1, keep)
            if not self.quantize_kv:
                pool.index_copy_(1, pid, pages.to(pool.dtype))
                continue
            for li in range(L):
                q8, s = kv_quant(pages[li])     # [n, page, KV, hd]
                pool[li].index_copy_(0, pid, q8)
                spool[li].index_copy_(0, pid, s.transpose(1, 2))

    @torch.no_grad()
    def step_paged_decode_direct(self, tables, pool_lens, kv_off,
                                 last_logits, generator, temperature, top_p,
                                 active, row_limit, json_table, json_state,
                                 max_new: int):
        """Direct tier decode: ``decode_paged`` reads the pool (the paged
        decode kernel on the card) and keeps new KV in the tail."""
        cfg = self.cfg
        st = self.sessions
        return decode_paged(
            self.params, cfg, st.k, st.v, tables, pool_lens, kv_off,
            last_logits, generator, temperature, top_p, max_new,
            cfg.eos_token_id, active=active, row_limit=row_limit,
            pad_id=self.tokenizer.pad_id, stop_ids=cfg.stop_token_ids,
            json_table=json_table, json_state=json_state,
            tail_dtype=self.cache_dtype)

    def step_scatter_tail(self, tail_k, tail_v, flat_idx) -> None:
        """Tail slot t of row b -> pool token slot flat_idx[b, t], in
        place; slots out of range drop."""
        st = self.sessions
        L, n_pages, page, KV, HD = st.k.shape
        n_tok = n_pages * page
        flat = flat_idx.reshape(-1)
        keep = torch.nonzero((flat >= 0) & (flat < n_tok))[:, 0]
        slot = flat[keep].long()
        for pool, tail in ((st.k, tail_k), (st.v, tail_v)):
            pool.view(L, n_tok, KV, HD).index_copy_(
                1, slot, tail.reshape(L, -1, KV, HD).index_select(1, keep)
                .to(pool.dtype))

    def _run_unified(self, n, suffixes, dst, pre_arr, off_arr, chunk_arr,
                     samp_np, jstate_np, json_table, generator, max_new,
                     maxp, verify=None):
        """One unified ragged tick: lay every row's suffix out token-major
        (segments padded to RAGGED_TQ blocks so a block never spans rows),
        run ONE mixed chunk forward through the ragged kernel — KV written
        straight to each row's dst pages — then the ragged decode loop, or
        under ``verify`` (k_arr, kmax, need_probs) the verdicts at the flat
        indices of each row's last K positions (``_verdicts``) and no
        decode. Row-indexed results are sized [NB]; the first ``n`` slots
        are the batch rows in order. Returns (out, n_emitted, final_lens,
        jstate_f, t_prefill, now, vout)."""
        st = self.sessions
        cfg = self.cfg
        dev = self.device
        page = st.page
        page_cap = maxp * page
        n_tok = st.n_pages * page
        TQ = RAGGED_TQ
        segs, nb_rows = [], []
        for i in range(n):
            s = max(1, min(int(chunk_arr[i]), page_cap - int(pre_arr[i])))
            segs.append(s)
            nb_rows.append(-(-s // TQ))
        raw = sum(b * TQ for b in nb_rows)
        TB = _round_up(raw, RAGGED_TOKEN_BUCKETS)
        if TB == raw and raw > RAGGED_TOKEN_BUCKETS[-1]:
            TB = -(-raw // 4096) * 4096     # beyond the ladder: 4k steps
        NB = TB // TQ                       # blocks; also the row slots
        maxp_p2 = 1 << max(0, maxp - 1).bit_length()   # pow2 table width
        flat_tok = np.full((TB,), self.tokenizer.pad_id, np.int32)
        flat_pos = np.zeros((TB,), np.int32)
        flat_dst = np.full((TB,), n_tok, np.int32)     # out of range = drop
        btab = np.zeros((NB, maxp_p2), np.int32)
        bmeta = np.zeros((NB, 3), np.int32)            # kv_len, qpos0, nq
        last_idx = np.zeros((NB,), np.int64)
        r_tables = np.zeros((NB, maxp_p2), np.int32)
        r_pool_lens = np.zeros((NB,), np.int32)
        r_off = np.zeros((NB,), np.int32)
        temp_arr, top_arr, active, limits_np = samp_np
        r_temp = np.zeros((NB,), np.float32)
        r_top = np.ones((NB,), np.float32)
        r_active = np.zeros((NB,), bool)
        r_limits = np.ones((NB,), np.int32)
        r_temp[:n] = temp_arr[:n]
        r_top[:n] = top_arr[:n]
        r_active[:n] = active[:n]
        r_limits[:n] = limits_np[:n]
        r_jstate = None
        if json_table is not None:
            r_jstate = np.full((NB,), -1, np.int32)
            r_jstate[:n] = jstate_np[:n]
        if verify is not None:
            k_arr, kmax, need_probs = verify
            widx = np.zeros((n, kmax), np.int64)
        cur = 0
        for i in range(n):
            s, nb = segs[i], nb_rows[i]
            pre = int(pre_arr[i])
            toks = suffixes[i][:s]
            flat_tok[cur:cur + len(toks)] = toks
            pos = pre + np.arange(s, dtype=np.int32)
            flat_pos[cur:cur + s] = int(off_arr[i]) + pos
            flat_dst[cur:cur + s] = dst[i, pos // page] * page + pos % page
            kv_len = pre + s
            for b in range(nb):
                blk = cur // TQ + b
                btab[blk, :maxp] = dst[i]
                bmeta[blk, 0] = kv_len
                bmeta[blk, 1] = pre + b * TQ
                bmeta[blk, 2] = min(TQ, s - b * TQ)
            last_idx[i] = cur + s - 1
            r_tables[i, :maxp] = dst[i]
            r_pool_lens[i] = kv_len
            r_off[i] = int(off_arr[i])
            if verify is not None:
                widx[i] = cur + np.clip(
                    s - int(k_arr[i]) + np.arange(kmax), 0, s - 1)
            cur += nb * TQ
        self._pending.padded_tokens = TB
        self._pending.shape_key = (
            ("ragged_verify", TB, maxp_p2, verify[1]) if verify is not None
            else ("ragged", TB, maxp_p2, max_new))

        def put(a):
            return torch.as_tensor(a, device=dev)

        scales = dict(k_scale=st.k_scale, v_scale=st.v_scale)
        hidden = forward_hidden_ragged(
            self.params, cfg, put(flat_tok)[None], put(flat_pos)[None],
            st.k, st.v, put(btab), put(bmeta), put(flat_dst), tq=TQ,
            **scales)[0]
        if verify is not None:
            w = put(widx)
            ids, probs = self._verdicts(
                hidden[0][w], put(flat_tok)[w], json_table,
                None if r_jstate is None else put(r_jstate[:n]),
                put(r_temp[:n]), need_probs)
            _fence(dev)
            t_prefill = time.monotonic()
            vout = (ids.cpu().numpy(),
                    None if probs is None else probs.cpu().numpy())
            return (np.zeros((NB, 0), np.int32), np.zeros((NB,), np.int32),
                    r_pool_lens, np.full((NB,), -1, np.int32), t_prefill,
                    time.monotonic(), vout)
        last_logits = project_logits(self.params, cfg,
                                     hidden[0][put(last_idx)])   # [NB, V]
        _fence(dev)
        t_prefill = time.monotonic()
        res = decode_ragged(
            self.params, cfg, st.k, st.v, put(r_tables), put(r_pool_lens),
            put(r_off), last_logits, generator, put(r_temp), put(r_top),
            max_new, cfg.eos_token_id, active=put(r_active),
            row_limit=put(r_limits),
            pad_id=self.tokenizer.pad_id, stop_ids=cfg.stop_token_ids,
            json_table=json_table,
            json_state=None if r_jstate is None else put(r_jstate),
            **scales)
        # the pools (and scale pools) were written in place
        out, n_emitted, final_lens, jstate_f = res[:3] + res[-1:]
        out, n_emitted, final_lens, jstate_f = (
            x.cpu().numpy() for x in (out, n_emitted, final_lens, jstate_f))
        now = time.monotonic()
        return out, n_emitted, final_lens, jstate_f, t_prefill, now, None

    def _json_table_device(self, enum_set: tuple):
        """Grammar tables for this tokenizer, built once per distinct
        grammar (one vocab walk) and cached on the engine's device as
        int16. ``enum_set`` is the tuple of DISTINCT action enums in the
        batch (None = plain JSON); returns (table, {enum: start state},
        {enum: state-block base}). Mixed batches stack their grammars into
        one table with offset state ids."""
        with self._grammar_lock:
            return self._json_table_device_impl(enum_set)

    def _json_table_device_impl(self, enum_set: tuple):
        from quoracle_tpu_torch.models.constrained import JsonTokenTable
        cache = self._json_cache

        def _evict(kind: str, keep: int) -> None:
            # bounded: a device table is padded_states x vocab int16
            keys = [k for k in cache if k[0] == kind]
            for k in keys[:max(0, len(keys) - keep)]:
                del cache[k]

        def build(enum):
            key = ("one", enum)
            if key not in cache:
                cache[key] = JsonTokenTable.for_tokenizer(
                    self.tokenizer, self.cfg.vocab_size,
                    self.cfg.eos_token_id,
                    extra_stop_ids=tuple(self.cfg.stop_token_ids),
                    action_enum=enum)
            return cache[key]

        if len(enum_set) == 1:
            tt = build(enum_set[0])
            dkey = ("dev", enum_set[0])
            if dkey not in cache:
                _evict("dev", keep=3)
                _evict("one", keep=7)
                cache[dkey] = torch.as_tensor(tt.table, device=self.device)
            return cache[dkey], {enum_set[0]: tt.start_state}, \
                {enum_set[0]: 0}
        skey = ("stack", enum_set)
        if skey not in cache:
            _evict("stack", keep=1)
            _evict("one", keep=7)
            tables, offsets, bases, off = [], {}, {}, 0
            for enum in enum_set:
                tt = build(enum)
                shifted = tt.table.astype(np.int32)
                shifted = np.where(shifted >= 0, shifted + off, REJECT_STATE)
                tables.append(shifted.astype(np.int16))
                offsets[enum] = off + tt.start_state
                bases[enum] = off
                off += tt.table.shape[0]
            if off >= 32767:
                raise ValueError("stacked grammar state space exceeds int16")
            cache[skey] = (torch.as_tensor(np.concatenate(tables),
                                           device=self.device),
                           offsets, bases)
        return cache[skey]
