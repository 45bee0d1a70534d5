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
direct tier, which has no scale stream, is off. Left for later slices:
the radix prefix cache and its prefix sharing, KV tiers, speculation, VLM
rows and meshes.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from quoracle_tpu_torch.models.config import ModelConfig
from quoracle_tpu_torch.models.quant import (
    kv_quant, kv_token_bytes, quantize_params,
)
from quoracle_tpu_torch.models.sampling import sample_tokens
from quoracle_tpu_torch.models.transformer import (
    KVCache, Transformer, forward_hidden, forward_hidden_paged,
    forward_hidden_paged_prefill, forward_hidden_ragged, init_cache,
    project_logits,
)
from quoracle_tpu_torch.ops import kernels
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
                  ) -> tuple[torch.Tensor, KVCache]:
    """Fill the cache from a right-padded token chunk starting at per-row
    buffer index ``prefix_lens``. Returns (last-token logits [B, V], cache
    with lens = prefix + chunk). The head projects only each row's last
    hidden state."""
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
        kv_pos_offset=kv_off)
    rows = torch.arange(B, device=tokens.device)
    last_h = hidden[rows, (chunk_lens - 1).long()]             # [B, D]
    cache.lens = total
    return project_logits(params, cfg, last_h), cache


def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            prompt_lens: torch.Tensor, cache: KVCache
            ) -> tuple[torch.Tensor, KVCache]:
    """Fresh prefill = prefill_chunk from position 0."""
    zeros = torch.zeros_like(prompt_lens, dtype=torch.int32)
    return prefill_chunk(params, cfg, tokens, zeros, prompt_lens, cache)


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

    @property
    def resident_len(self) -> int:
        return len(self.tokens) - self.start_pos


class SessionStore:
    """Paged session cache: sessions are PAGE LISTS into one device pool
    (``k``/``v`` [L, n_pages, page, KV, hd], set by the engine; int8 pools
    add ``k_scale``/``v_scale`` [L, n_pages, KV, page]). Page 0 is
    scratch. LRU sessions evict when the free list runs dry. Thread-safe;
    the engine additionally serializes sessioned steps. (No radix prefix
    cache, refcounts or KV tiers yet: every page has one owner.)"""

    def __init__(self, max_tokens: int = 262_144, page: int = PAGE):
        self.page = page
        self.n_pages = max(3, -(-max_tokens // page) + 1)   # +1 scratch
        self.max_tokens = (self.n_pages - 1) * page
        self.lock = threading.RLock()
        self._sessions: dict[str, _Session] = {}
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self.k: Optional[torch.Tensor] = None
        self.v: Optional[torch.Tensor] = None
        self.k_scale: Optional[torch.Tensor] = None
        self.v_scale: Optional[torch.Tensor] = None

    def get(self, key: str) -> Optional[_Session]:
        with self.lock:
            s = self._sessions.get(key)
            if s is not None:
                s.last_used = time.monotonic()
            return s

    def alloc(self, n: int, protect: tuple = (),
              evict: bool = True) -> Optional[list[int]]:
        """Take n pages from the free list, evicting LRU sessions (never
        the ``protect`` keys — the batch's own sessions) as needed.
        Returns None — WITHOUT evicting anything — when the request cannot
        be satisfied even by evicting every unprotected session.
        ``evict=False`` takes only from the free list (temporary pages
        must never destroy other agents' resident sessions)."""
        with self.lock:
            if not evict:
                if n > len(self._free):
                    return None
                return [self._free.pop() for _ in range(n)]
            victims = [k for k in self._sessions if k not in protect]
            attainable = len(self._free) + sum(
                1 for k in victims for p in self._sessions[k].pages if p)
            if n > attainable:
                return None
            while len(self._free) < n:
                lru = min(victims, key=lambda k: self._sessions[k].last_used)
                victims.remove(lru)
                self._release(self._sessions.pop(lru).pages)
            return [self._free.pop() for _ in range(n)]

    def _release(self, pages: list[int]) -> None:
        self._free.extend(p for p in pages if p != 0)

    def release(self, pages: list[int]) -> None:
        with self.lock:
            self._release(pages)

    def put(self, key: str, sess: _Session) -> None:
        """Replace a session, releasing any of the old session's pages the
        new one no longer references."""
        sess.last_used = time.monotonic()
        with self.lock:
            old = self._sessions.get(key)
            if old is not None and old is not sess:
                self._release([p for p in old.pages if p not in sess.pages])
            self._sessions[key] = sess

    def put_raw(self, key: str, sess: _Session) -> None:
        """Replace WITHOUT page bookkeeping — the caller owns the page
        lifecycle (the engine's paged step releases explicitly)."""
        sess.last_used = time.monotonic()
        with self.lock:
            self._sessions[key] = sess

    def drop(self, key: str) -> None:
        with self.lock:
            s = self._sessions.pop(key, None)
            if s is not None:
                self._release(s.pages)

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
        if self.quantize_weights:
            self.params = quantize_params(self.params, cfg)
        self.tokenizer = tokenizer
        self.max_seq = max_seq or cfg.context_window
        self.prompt_buckets = tuple(b for b in prompt_buckets
                                    if b <= self.max_seq)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._rng_lock = threading.Lock()
        # KV dtype follows the params (bf16 serving, fp32 parity tests);
        # an int8 pool keeps scales beside its pages, and the dense working
        # caches stay at the params dtype
        self.cache_dtype = self.params.dtype
        self.pool_dtype = torch.int8 if self.quantize_kv else self.cache_dtype
        # Session budget in BYTES, converted to tokens (K+V per token, the
        # scales included), capped at 32 full context windows
        token_bytes = kv_token_bytes(
            cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
            torch.empty((), dtype=self.pool_dtype).element_size(),
            self.quantize_kv)
        self.sessions = SessionStore(
            max_tokens=max(PAGE, min(session_max_bytes // token_bytes,
                                     32 * self.max_seq)))
        # sessioned calls (lookup, allocation, pool writes, store-back)
        # are one atomic unit per engine
        self._paged_lock = threading.Lock()
        self._grammar_lock = threading.Lock()
        self._json_cache: dict = {}
        self.last_prefill_tokens = 0   # suffix tokens actually computed
        self.last_prefill_s = 0.0
        self.last_decode_s = 0.0
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
        # equality/fallback seams of the JAX engine: pin the gather tier
        # (decode, and with it unified) or the gather prefill
        self._force_gather_decode = False
        self._force_gather_prefill = False

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
    ) -> list[GenResult]:
        """``session_ids`` (aligned with prompts; None entries opt out)
        enables KV residency: each row reuses the longest token prefix it
        shares with its session and prefills only the suffix; the prompt
        and response KV stay resident for the next round.
        ``action_enums`` (read where constrain_json is True) constrains
        the top-level ``"action"`` value to the given names."""
        if session_ids is not None and any(session_ids):
            with self._paged_lock:
                return self._generate_impl(
                    prompts, temperature, top_p, max_new_tokens, generator,
                    session_ids, constrain_json, action_enums)
        return self._generate_impl(prompts, temperature, top_p,
                                   max_new_tokens, generator, None,
                                   constrain_json, action_enums)

    def drop_session(self, session_id: str) -> None:
        """Release a session's pages, serialized with sessioned generate
        calls so an in-flight batch never loses pages it references."""
        with self._paged_lock:
            self.sessions.drop(session_id)

    def session_tokens(self, session_id: str) -> Optional[list[int]]:
        """The session's resident conversation ids (prompt + retained
        response), or None — what the backend splices the next round's
        prompt against."""
        s = self.sessions.get(session_id)
        return list(s.tokens) if s is not None else None

    def _generate_impl(self, prompts, temperature, top_p, max_new_tokens,
                       generator, session_ids, constrain_json,
                       action_enums) -> list[GenResult]:
        t0 = time.monotonic()
        n = len(prompts)
        if n == 0:
            return []
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
                if s is None:
                    continue
                # >= 1 suffix token must run to produce last-position logits
                p = min(_lcp(s.tokens, prompts[i]), len(prompts[i]) - 1)
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
        T = _round_up(max_chunk, self.prompt_buckets)
        B = _round_up(n, self.BATCH_BUCKETS)
        # the decode bound is bucketed too; per-row limits stop each row at
        # its own budget
        max_new = _round_up(min(max(row_budgets), self.max_seq - 1),
                            MAX_NEW_BUCKETS)
        cache_len = _round_up(max(prefixes) + T,
                              self.prompt_buckets) + max_new
        page = self.sessions.page
        maxp = -(-cache_len // page)      # pages per row (paged path)

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
        # -1 rows sample unconstrained; distinct grammars (action enums)
        # stack into one table with offset state ids
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
                    jstate_np[i] = offsets[enums[i]]

        samp_np = (temp_arr, top_arr, active, limits)
        with self._rng_lock:
            if paged:
                out, n_emitted, jstate_f, t_prefill, now = self._run_paged(
                    prompts, suffixes, sess_rows, reuse_abs, kv_off_host,
                    store_sids, B, maxp, tokens, pre_arr, off_arr,
                    chunk_arr, samp_np, jstate_np, json_table, generator,
                    max_new)
            else:
                out, n_emitted, jstate_f, t_prefill, now = self._run_dense(
                    tokens, chunk_arr, cache_len, samp_np, jstate_np,
                    json_table, generator, max_new)
        self.last_prefill_tokens = sum(len(s) for s in suffixes)
        self.last_prefill_s = t_prefill - t0
        self.last_decode_s = now - t_prefill
        latency = now - t0

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
            ))
        return results

    def _run_dense(self, tokens, chunk_arr, cache_len, samp_np, jstate_np,
                   json_table, generator, max_new):
        """Sessionless rows: dense prefill (flash for long chunks on the
        GPU) into a fresh [L, B, cache_len] cache, then the dense decode."""
        dev = self.device
        cfg = self.cfg
        B = tokens.shape[0]
        cache = init_cache(cfg, B, cache_len, dev, dtype=self.cache_dtype)
        last_logits, cache = prefill(
            self.params, cfg, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(chunk_arr, device=dev), cache)
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
                   generator, max_new):
        """The sessioned call: allocate each stored row's dst pages (its
        own resident pages first, LRU eviction for the rest), pick the
        tier as the JAX engine does, run it, then store every session's
        page list back (ints only — no KV bytes move through the host).
        The caller holds ``_paged_lock``.

        Tier choice (the JAX ``_run_paged`` without prefix sharing):
        unified and direct decode each need their gate and no
        ``_force_gather_decode``, and the direct tier an unquantized pool; both read every row's prompt from pages,
        so rows without a stored session borrow TEMP pages from the free
        list, and when there are none both are off. Unified and the direct
        prefill also need every resumed row to write through its own
        pages: a declined store (pool exhausted) rules them out. The
        direct prefill has its own gate and chunk cap. What remains is
        gather."""
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
                      and not self.quantize_kv
                      and max_prompt >= self.direct_decode_min_tokens)
        unified_ok = (not self._force_gather_decode
                      and max_prompt >= self.unified_min_tokens)
        with st.lock:   # one allocation transaction for the batch
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
                # resident pages past the table width can't be rewritten
                # this call: release them after the batch
                spills[i], old = old[maxp:], old[:maxp]
                pre_buf = reuse_abs[i] - kv_off_host[i]
                need_tokens = min(pre_buf + len(suffixes[i])
                                  + int(limits[i]), maxp * page)
                n_extra = max(0, -(-need_tokens // page) - len(old))
                if n_extra:
                    extra = st.alloc(n_extra, protect=protect)
                    if extra is None:
                        # pool exhausted even after eviction: serve the
                        # row without storing (old session stays valid)
                        store_sids[i] = None
                        spills[i] = []
                        continue
                    old = old + extra
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
        # unified kernel / direct prefill write (nothing relocates it)
        own_pages = all(sess_rows[i] is None or dst_lists[i] is not None
                        for i in range(n))
        T = tokens.shape[1]
        use_direct_pre = (use_direct and own_pages
                          and not self._force_gather_prefill
                          and max_prompt >= self.direct_prefill_min_tokens
                          and T <= self.direct_prefill_max_chunk)
        use_unified = unified_ok and own_pages

        if use_unified:
            out, n_emitted, final_lens, jstate_f, t_prefill, now = \
                self._run_unified(n, suffixes, dst, pre_arr, off_arr,
                                  chunk_arr, samp_np, jstate_np, json_table,
                                  generator, max_new, maxp)
        else:
            out, n_emitted, final_lens, jstate_f, t_prefill, now = \
                self._run_split(n, suffixes, src, dst, tokens, pre_arr,
                                off_arr, chunk_arr, samp_np, jstate_np,
                                json_table, generator, max_new, maxp,
                                use_direct, use_direct_pre)

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
        # temp pages (sessionless rows on the page-reading tiers) die with
        # the call
        for tmp in temp_lists:
            if tmp:
                st.release(tmp)
        return out, n_emitted, jstate_f, t_prefill, now

    def _run_split(self, n, suffixes, src, dst, tokens, pre_arr, off_arr,
                   chunk_arr, samp_np, jstate_np, json_table, generator,
                   max_new, maxp, use_direct, use_direct_pre):
        """The direct and gather tiers. Prefill: the direct paged prefill
        (chunk against pages, chunk KV to dst pages) or the gather prefill
        (working cache). Decode: the direct decode (pages + tail, after
        the working cache, if any, is copied to dst pages; the tail is
        copied after) or the gather decode (working cache, then prompt
        and response KV copied to dst pages)."""
        st = self.sessions
        dev = self.device
        page = st.page

        def put(a):
            return torch.as_tensor(a, device=dev)

        temp, top, active, limits = (put(a) for a in samp_np)
        jstate0 = None if jstate_np is None else put(jstate_np)
        off_dev = put(off_arr)
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
        return out, n_emitted, final_lens, jstate_f, t_prefill, now

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
                     maxp):
        """One unified ragged tick: lay every row's suffix out token-major
        (segments padded to RAGGED_TQ blocks so a block never spans rows),
        run ONE mixed chunk forward through the ragged kernel — KV written
        straight to each row's dst pages — then the ragged decode loop.
        Row-indexed results are sized [NB]; the first ``n`` slots are the
        batch rows in order."""
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
            cur += nb * TQ

        def put(a):
            return torch.as_tensor(a, device=dev)

        scales = dict(k_scale=st.k_scale, v_scale=st.v_scale)
        hidden = forward_hidden_ragged(
            self.params, cfg, put(flat_tok)[None], put(flat_pos)[None],
            st.k, st.v, put(btab), put(bmeta), put(flat_dst), tq=TQ,
            **scales)[0]
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
        return out, n_emitted, final_lens, jstate_f, t_prefill, now

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
