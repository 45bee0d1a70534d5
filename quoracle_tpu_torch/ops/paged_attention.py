"""Paged attention over the session page pool (port of
``quoracle_tpu/ops/paged_attention.py``). The sessioned engine's three
tiers meet here:

  * unified (``ragged_attend``): a token-major flat batch of mixed prefill
    and decode rows in one launch, KV already written to the pages,
    normalized in-kernel;
  * direct (``paged_decode_attend``, ``paged_prefill_merge``): the split
    kernels ``paged_attend`` (one decode query per row against its pages)
    and ``paged_prefill_attend`` (a whole suffix chunk against the row's
    resident prefix) produce online-softmax PARTIALS that plain PyTorch
    merges with a dense piece (the decode tail, the chunk itself);
  * gather: no kernel here; the engine copies the pages into a dense
    working cache and runs the dense attention (ops/attention.py,
    ops/flash_attention.py).

Partial convention: (acc [.., hd] fp32 UNNORMALIZED, m rowmax, l denom);
an empty set gives (0, NEG_INF, 0). NEG_INF is finite, so merging an
empty partial is exact (exp(NEG_INF - NEG_INF) = 1 scales l = 0).

Unified flat layout: every row's query tokens lie contiguously in one
[NB·tq, H, hd] tensor, each row's segment padded to whole ``tq``-token
blocks so a block never spans two rows. Per block:

  block_tables[i]  the owning row's page table, [maxp] page ids
  block_meta[i]    (kv_len, qpos0, nq): the row's valid KV tokens in its
                   pages INCLUDING this chunk (the layer writes chunk KV to
                   the pages before attending), the buffer position of the
                   block's first query, and its valid queries (0 = inert)

Int8 pools (``GenerateEngine(quantize_kv=True)``) carry fp32 scale pools
``[n_pages, KV, page]``, one scale per (token, kv-head); ``ragged_attend``
takes them as ``k_scale``/``v_scale`` and dequantizes as it reads.

Each kernel wrapper launches its hand-written CUDA kernel
(``csrc/ragged_fwd.cu``, ``csrc/ragged_q8_fwd.cu`` for int8 pools,
``csrc/paged_fwd.cu``, ``csrc/paged_prefill_fwd.cu``) for CUDA tensors
and runs its plain twin (``*_ref``) for CPU tensors. The tp shard
wrappers of the JAX module are later work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from quoracle_tpu_torch.models.quant import gather_scales
from quoracle_tpu_torch.ops import kernels
from quoracle_tpu_torch.ops.attention import NEG_INF

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SCORE_ROWS = 32         # tq * (H / KV) rows per CUDA block (fp32
                            # prefill on common.cuh's scalar core, the
                            # decode kernels on split_kv.cuh)
TC_SCORE_ROWS = 64          # rows per block of the bf16 prefill kernels
                            # (tc_attention.cuh: 4 warps x 16 mma rows)
KEY_TILE = 64               # keys per shared-memory tile (page % 64 == 0)
INT32_MIN = -(1 << 31)
SHARE_BLOCKS_PER_SM = 4     # split-K target: about one wave of decode blocks


def prefill_block(n_heads: int, n_kv: int, dtype) -> tuple[int, int]:
    """(tq, rows) of the prefill kernels' CUDA block: at most ``rows``
    score rows, ``tq`` chunk queries times the G = n_heads / n_kv heads of
    one KV head. bf16 runs on the tensor cores, 64 rows a block
    (``TC_SCORE_ROWS``, so tq = 64 // G, the rule ``flash_fwd`` also
    applies); fp32 keeps the scalar core's 32 (``MAX_SCORE_ROWS``). G past
    the rows still gives tq = 1, which the kernel argument check refuses."""
    rows = TC_SCORE_ROWS if dtype == torch.bfloat16 else MAX_SCORE_ROWS
    return max(1, rows // (n_heads // n_kv)), rows


def split_count(n_blocks: int, n_kv: int, maxp: int, page: int,
                n_sms: int) -> int:
    """Share count S of the split-K decode kernels (``csrc/split_kv.cuh``:
    ``paged_fwd``, ``ragged_fwd``, ``ragged_q8_fwd``), from the grid
    alone: enough shares that the (n_blocks, n_kv, S) grid puts
    ``SHARE_BLOCKS_PER_SM`` blocks on each of the card's ``n_sms`` SMs, at
    most one share per 64-key tile of a full page table (``ceil(maxp *
    page / KEY_TILE)``), at least 1. The rows' lengths live on the card
    and are never read here: a host sync per layer would cost more than
    the kernel."""
    want = -(-SHARE_BLOCKS_PER_SM * n_sms // max(1, n_blocks * n_kv))
    return max(1, min(max_splits(maxp, page), want))


def max_splits(maxp: int, page: int) -> int:
    """The most shares a split-K launch takes: one per 64-key tile of a
    full page table."""
    return max(1, -(-maxp * page // KEY_TILE))


_SMS: dict = {}


def _n_sms(device: torch.device) -> int:
    """SM count of a CUDA device (read once per device)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _splits_and_workspace(name: str, splits: Optional[int], n_blocks: int,
                          n_kv: int, maxp: int, page: int, n_out: int,
                          hd: int, device) -> tuple:
    """(S, workspace, its pointer) of a split-K launch: ``splits`` if
    given (1 .. ``max_splits``), else ``split_count``; an fp32 workspace
    of n_out * S * (hd + 2) floats when S > 1 (every share writes its
    slot, so ``torch.empty``), else None and a null pointer. The caller
    holds the workspace through the launch."""
    cap = max_splits(maxp, page)
    if splits is None:
        splits = split_count(n_blocks, n_kv, maxp, page, _n_sms(device))
    elif not 1 <= int(splits) <= cap:
        raise ValueError(f"{name}: splits={splits} outside 1..{cap} (one "
                         f"share per {KEY_TILE}-key tile at most)")
    splits = int(splits)
    if splits == 1:
        return 1, None, None
    ws = torch.empty(n_out * splits * (hd + 2), dtype=torch.float32,
                     device=device)
    return splits, ws, ws.data_ptr()


# ---------------------------------------------------------------------------
# Partials: dense pieces and the merge (plain PyTorch)
# ---------------------------------------------------------------------------

def _partials_from_scores(scores: torch.Tensor, mask: torch.Tensor,
                          v: torch.Tensor) -> tuple:
    """scores [B, KV, G, S], mask broadcastable to it, v [B, KV, S, hd] ->
    (acc [B, KV, G, hd], m [B, KV, G], l [B, KV, G]) fp32 partials."""
    mask = mask.expand(scores.shape)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bksd->bkgd", p, v)
    return acc, m, l


def _partials_from_scores_t(scores: torch.Tensor, mask: torch.Tensor,
                            v: torch.Tensor) -> tuple:
    """Multi-query variant: scores [B, KV, G, T, S], mask broadcastable to
    it, v [B, S, KV, hd] -> query-major (acc [B, T, H, hd], m [B, T, H],
    l [B, T, H]) fp32. Same convention as ``_partials_from_scores``."""
    mask = mask.expand(scores.shape)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgts,bskd->bkgtd", p, v.float())
    B, KV, G, T, hd = acc.shape
    acc = acc.permute(0, 3, 1, 2, 4).reshape(B, T, KV * G, hd)
    return (acc, m.permute(0, 3, 1, 2).reshape(B, T, KV * G),
            l.permute(0, 3, 1, 2).reshape(B, T, KV * G))


def merge_partials(p1: tuple, p2: tuple) -> torch.Tensor:
    """Combine two online-softmax partials -> normalized output (fp32)."""
    a1, m1, l1 = p1
    a2, m2, l2 = p2
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    l = l1 * c1 + l2 * c2
    acc = a1 * c1[..., None] + a2 * c2[..., None]
    return acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]


def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, H, hd] -> [B, KV, G, hd] (GQA grouping, no repetition)."""
    b, h, hd = q.shape
    return q.reshape(b, n_kv, h // n_kv, hd)


def _tail_mask(t_max: int, tail_len, tail_pos0: torch.Tensor,
               q_pos: torch.Tensor, sliding_window: Optional[int]
               ) -> torch.Tensor:
    """[B, 1, 1, Tmax] visibility of the tail entries: idx < tail_len,
    pos <= q_pos and the window (pos = tail_pos0 + idx)."""
    B = q_pos.shape[0]
    idx = torch.arange(t_max, dtype=torch.int32,
                       device=q_pos.device)[None, :]        # [1, T]
    tl = torch.as_tensor(tail_len, dtype=torch.int32,
                         device=q_pos.device).expand(B)[:, None]
    kv_pos = tail_pos0.to(torch.int32)[:, None] + idx
    qp = q_pos.to(torch.int32)[:, None]
    mask = (idx < tl) & (kv_pos <= qp)
    if sliding_window is not None:
        mask = mask & (qp - kv_pos < sliding_window)
    return mask[:, None, None, :]


def _tail_partials(q: torch.Tensor, tail_k: torch.Tensor,
                   tail_v: torch.Tensor, mask: torch.Tensor) -> tuple:
    B, H, hd = q.shape
    KV = tail_k.shape[2]
    qg = _grouped(q.float() * hd ** -0.5, KV)             # [B, KV, G, hd]
    k = tail_k.float().permute(0, 2, 1, 3)                # [B, KV, T, hd]
    v = tail_v.float().permute(0, 2, 1, 3)
    scores = torch.einsum("bkgd,bktd->bkgt", qg, k)
    acc, m, l = _partials_from_scores(scores, mask, v)
    return acc.reshape(B, H, hd), m.reshape(B, H), l.reshape(B, H)


def tail_attend_partials(
    q: torch.Tensor,          # [B, H, hd]
    tail_k: torch.Tensor,     # [B, Tmax, KV, hd]
    tail_v: torch.Tensor,     # [B, Tmax, KV, hd]
    tail_len,                 # int or [B] int32: valid tail entries
    tail_pos0: torch.Tensor,  # [B] int32 absolute position of tail index 0
    q_pos: torch.Tensor,      # [B] int32
    sliding_window: Optional[int] = None,
) -> tuple:
    """Dense partials of the decode queries against the tail buffer."""
    return _tail_partials(q, tail_k, tail_v, _tail_mask(
        tail_k.shape[1], tail_len, tail_pos0, q_pos, sliding_window))


def chunk_attend_partials(
    q: torch.Tensor,           # [B, T, H, hd] prefill chunk queries
    k: torch.Tensor,           # [B, T, KV, hd] the chunk's own KV
    v: torch.Tensor,
    chunk_lens: torch.Tensor,  # [B] int32 valid chunk tokens per row
    sliding_window: Optional[int] = None,
) -> tuple:
    """Dense causal partials of the chunk against ITSELF. Both sides share
    the row's absolute offset, so causality is s <= t and the window
    t - s < W. fp32, O(T²) scores: the engine caps the direct prefill's
    chunk (``direct_prefill_max_chunk``)."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    qg = (q.float() * hd ** -0.5).reshape(B, T, KV, H // KV, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float())  # [B,KV,G,T,S]
    t_idx = torch.arange(T, dtype=torch.int32, device=q.device)
    causal = t_idx[:, None] >= t_idx[None, :]                   # [T, S]
    valid = t_idx[None, :] < chunk_lens.to(torch.int32)[:, None]   # [B, S]
    mask = causal[None, :, :] & valid[:, None, :]
    if sliding_window is not None:
        mask = mask & (t_idx[:, None] - t_idx[None, :]
                       < sliding_window)[None, :, :]
    return _partials_from_scores_t(scores, mask[:, None, None], v)


# ---------------------------------------------------------------------------
# Direct decode piece: paged_attend (K5) and its twin
# ---------------------------------------------------------------------------

def paged_attend_ref(
    q: torch.Tensor,         # [B, H, hd]
    k_pages: torch.Tensor,   # [n_pages, page, KV, hd]
    v_pages: torch.Tensor,
    tables: torch.Tensor,    # [B, maxp] int32
    kv_lens: torch.Tensor,   # [B] int32 valid POOL tokens per row
    kv_off: torch.Tensor,    # [B] int32 absolute position of pool index 0
    q_pos: torch.Tensor,     # [B] int32
    sliding_window: Optional[int] = None,
) -> tuple:
    """Gather twin of the paged decode kernel: partials (acc [B, H, hd],
    m [B, H], l [B, H]) fp32 of q against the row's pool pages, masked by
    idx < kv_len, pos <= q_pos and the window (pos = kv_off + idx)."""
    B, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    maxp = tables.shape[1]
    t = tables.long()
    k = k_pages[t].reshape(B, maxp * page, KV, hd).float().permute(0, 2, 1, 3)
    v = v_pages[t].reshape(B, maxp * page, KV, hd).float().permute(0, 2, 1, 3)
    qg = _grouped(q.float() * hd ** -0.5, KV)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k)
    idx = torch.arange(maxp * page, dtype=torch.int32,
                       device=q.device)[None, :]
    kv_pos = idx + kv_off.to(torch.int32)[:, None]
    qp = q_pos.to(torch.int32)[:, None]
    mask = (idx < kv_lens.to(torch.int32)[:, None]) & (kv_pos <= qp)
    if sliding_window is not None:
        mask = mask & (qp - kv_pos < sliding_window)
    acc, m, l = _partials_from_scores(scores, mask[:, None, None, :], v)
    return acc.reshape(B, H, hd), m.reshape(B, H), l.reshape(B, H)


def _check_kernel_args(name, q, k_pages, v_pages, score_rows: int, ints,
                       scales=None, max_rows: int = MAX_SCORE_ROWS):
    """The CUDA kernels' contract, shared by every wrapper: float32 or
    bfloat16 q and pages of q's dtype (int8 pages with ``scales``, the
    (k_scale, v_scale) pools: contiguous float32 [n_pages, KV, page]), hd
    128 or 256, at most ``max_rows`` score rows per block, page %
    KEY_TILE == 0, contiguous q and pools, the int tensors (already int32
    and contiguous) on q's device. Each wrapper checks its own index
    shapes before calling this."""
    n_heads, hd = q.shape[-2], q.shape[-1]
    n_pages, page, n_kv, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd or n_heads % n_kv:
        raise ValueError(f"{name}: q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"disagree")
    page_dtype = q.dtype if scales is None else torch.int8
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype:
        raise ValueError(f"{name}: CUDA kernel takes float32 or bfloat16 "
                         f"q and {'int8' if scales else 'same-dtype'} "
                         f"pages, got {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype}")
    for s in scales or ():
        if s.dtype != torch.float32 or not s.is_contiguous() \
                or tuple(s.shape) != (n_pages, n_kv, page):
            raise ValueError(f"{name}: scale pools must be contiguous "
                             f"float32 [{n_pages}, {n_kv}, {page}], got "
                             f"{s.dtype} {tuple(s.shape)}")
    if hd not in (128, 256):
        raise ValueError(f"{name}: CUDA kernel is built for head_dim 128 "
                         f"and 256, got {hd}")
    if score_rows > max_rows:
        raise ValueError(f"{name}: {score_rows} score rows per block exceed "
                         f"the kernel's {max_rows}")
    if page % KEY_TILE:
        raise ValueError(f"{name}: page size {page} is not a multiple of "
                         f"the kernel's {KEY_TILE}-key tile")
    for label, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for x in ints:
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name}: index tensors must be contiguous "
                             f"int32, got {x.dtype}")
    for x in (k_pages, v_pages, *(scales or ()), *ints):
        if x.device != q.device:
            raise ValueError(f"{name}: all tensors must share q's device")


def _int32(*xs):
    return tuple(x.to(torch.int32).contiguous() for x in xs)


def paged_decode_meta(kv_lens: torch.Tensor, kv_off: torch.Tensor,
                      q_pos: torch.Tensor,
                      sliding_window: Optional[int] = None) -> torch.Tensor:
    """The paged decode kernel's per-row meta, [B, 4] int32 rows of
    (kv_len, kv_off, q_pos, qlo); built once per decode step and shared by
    its layers. Keys at pos <= qlo are outside the window (INT32_MIN = no
    window), as in the TPU kernel."""
    ints = _int32(kv_lens, kv_off, q_pos)
    kv_lens, kv_off, q_pos = ints
    B = q_pos.shape[0]
    if any(tuple(x.shape) != (B,) for x in ints):
        raise ValueError(f"paged_attend: kv_lens, kv_off and q_pos must "
                         f"all be [B], got {[tuple(x.shape) for x in ints]}")
    qlo = (torch.full_like(q_pos, INT32_MIN) if sliding_window is None else
           (q_pos.long() - int(sliding_window)).clamp(min=INT32_MIN)
           .to(torch.int32))
    return torch.stack([kv_lens, kv_off, q_pos, qlo], dim=1)


def paged_attend(
    q: torch.Tensor,         # [B, H, hd]
    k_pages: torch.Tensor,   # [n_pages, page, KV, hd]
    v_pages: torch.Tensor,
    tables: torch.Tensor,    # [B, maxp] int32
    kv_lens: torch.Tensor,   # [B] int32
    kv_off: torch.Tensor,    # [B] int32
    q_pos: torch.Tensor,     # [B] int32
    sliding_window: Optional[int] = None,
    meta: Optional[torch.Tensor] = None,
    splits: Optional[int] = None,
) -> tuple:
    """Paged decode partials: the CUDA kernel (``csrc/paged_fwd.cu``) for
    CUDA tensors (it launches or raises), the plain twin for CPU tensors.
    Grid (B, KV, S): a block serves the H/KV query heads of one KV head
    over one of S shares of the row's visible keys, and a second launch
    merges the shares (``split_count`` picks S; ``splits`` forces it, for
    tests). ``meta`` is ``paged_decode_meta`` of the same index
    arguments, when the caller already built it for this step."""
    if q.device.type == "cpu":
        return paged_attend_ref(q, k_pages, v_pages, tables, kv_lens,
                                kv_off, q_pos, sliding_window)
    if not q.is_cuda:
        raise ValueError(f"paged_attend: no kernel for device {q.device}")
    (tables,) = _int32(tables)
    if meta is None:
        meta = paged_decode_meta(kv_lens, kv_off, q_pos, sliding_window)
    B, H, hd = q.shape
    _, page, n_kv, _ = k_pages.shape
    if tuple(meta.shape) != (B, 4) or tables.dim() != 2 \
            or tables.shape[0] != B:
        raise ValueError(f"paged_attend: {B} queries, tables "
                         f"{tuple(tables.shape)}, meta {tuple(meta.shape)}")
    _check_kernel_args("paged_attend", q, k_pages, v_pages, H // n_kv,
                       (tables, meta))
    acc = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B == 0:
        return acc, m, l
    maxp = tables.shape[1]
    splits, ws, ws_ptr = _splits_and_workspace(
        "paged_attend", splits, B, n_kv, maxp, page, B * H, hd, q.device)
    kernels.PAGED.launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), meta.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), ws_ptr, B, H, n_kv, hd, page, maxp, splits,
        hd ** -0.5, _DTYPE_CODES[q.dtype], kernels.stream_handle(q.device))
    return acc, m, l


# ---------------------------------------------------------------------------
# Direct prefill piece: paged_prefill_attend (K4) and its twin
# ---------------------------------------------------------------------------

def paged_prefill_attend_ref(
    q: torch.Tensor,         # [B, T, H, hd] chunk queries
    k_pages: torch.Tensor,   # [n_pages, page, KV, hd]
    v_pages: torch.Tensor,
    tables: torch.Tensor,    # [B, maxp] int32
    kv_lens: torch.Tensor,   # [B] int32 resident PREFIX tokens per row
    sliding_window: Optional[int] = None,
) -> tuple:
    """Gather twin of the paged prefill kernel: partials (acc [B, T, H,
    hd], m [B, T, H], l [B, T, H]) fp32 of the whole chunk against the
    resident prefix. Every pool token precedes every chunk token, so
    causality is s < kv_len; the window uses the shared offset:
    q_abs - s_abs = kv_len + t - s."""
    B, T, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    maxp = tables.shape[1]
    t = tables.long()
    k = k_pages[t].reshape(B, maxp * page, KV, hd)
    v = v_pages[t].reshape(B, maxp * page, KV, hd)
    qg = (q.float() * hd ** -0.5).reshape(B, T, KV, H // KV, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float())
    s_idx = torch.arange(maxp * page, dtype=torch.int32, device=q.device)
    t_idx = torch.arange(T, dtype=torch.int32, device=q.device)
    kl = kv_lens.to(torch.int32)[:, None, None]            # [B, 1, 1]
    mask = (s_idx[None, None, :] < kl).expand(B, T, maxp * page)
    if sliding_window is not None:
        dist = (kl + t_idx[None, :, None]) - s_idx[None, None, :]
        mask = mask & (dist < sliding_window)
    return _partials_from_scores_t(scores, mask[:, None, None], v)


def paged_prefill_attend(
    q: torch.Tensor,         # [B, T, H, hd]
    k_pages: torch.Tensor,   # [n_pages, page, KV, hd]
    v_pages: torch.Tensor,
    tables: torch.Tensor,    # [B, maxp] int32
    kv_lens: torch.Tensor,   # [B] int32 resident prefix tokens
    sliding_window: Optional[int] = None,
) -> tuple:
    """Paged prefill partials: the CUDA kernel
    (``csrc/paged_prefill_fwd.cu``) for CUDA tensors (it launches or
    raises), the plain twin for CPU tensors. Grid (B, ceil(T/tq), KV)
    with tq * H/KV score rows per block (``prefill_block``: 64 on the
    tensor cores for bf16, 32 for fp32); every one of the chunk's T query
    rows is computed."""
    if q.device.type == "cpu":
        return paged_prefill_attend_ref(q, k_pages, v_pages, tables,
                                        kv_lens, sliding_window)
    if not q.is_cuda:
        raise ValueError(f"paged_prefill_attend: no kernel for device "
                         f"{q.device}")
    tables, kv_lens = _int32(tables, kv_lens)
    B, T, H, hd = q.shape
    _, page, n_kv, _ = k_pages.shape
    if tables.dim() != 2 or tables.shape[0] != B \
            or tuple(kv_lens.shape) != (B,):
        raise ValueError(f"paged_prefill_attend: tables "
                         f"{tuple(tables.shape)} and kv_lens "
                         f"{tuple(kv_lens.shape)} must have B = {B} rows")
    tq, rows = prefill_block(H, n_kv, q.dtype)
    _check_kernel_args("paged_prefill_attend", q, k_pages, v_pages,
                       tq * (H // n_kv), (tables, kv_lens), max_rows=rows)
    acc = torch.empty((B, T, H, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    if B == 0 or T == 0:
        return acc, m, l
    kernels.PAGED_PREFILL.launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), kv_lens.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, T, tq, H, n_kv, hd, page, tables.shape[1],
        -1 if sliding_window is None else int(sliding_window), hd ** -0.5,
        _DTYPE_CODES[q.dtype], kernels.stream_handle(q.device))
    return acc, m, l


# ---------------------------------------------------------------------------
# Direct-tier dispatchers: kernel partials merged with the dense piece
# ---------------------------------------------------------------------------

def paged_prefill_merge(
    q: torch.Tensor,            # [B, T, H, hd]
    chunk_k: torch.Tensor,      # [B, T, KV, hd]
    chunk_v: torch.Tensor,
    k_pages: torch.Tensor,      # [n_pages, page, KV, hd]
    v_pages: torch.Tensor,
    tables: torch.Tensor,       # [B, maxp]
    prefix_lens: torch.Tensor,  # [B] resident pool tokens
    chunk_lens: torch.Tensor,   # [B] valid chunk tokens
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Full direct-prefill attention = pool-prefix piece (kernel on the
    card, twin on the CPU) merged with the intra-chunk causal piece ->
    [B, T, H, hd] in q's dtype."""
    pooled = paged_prefill_attend(q, k_pages, v_pages, tables, prefix_lens,
                                  sliding_window)
    chunk = chunk_attend_partials(q, chunk_k, chunk_v, chunk_lens,
                                  sliding_window)
    return merge_partials(pooled, chunk).to(q.dtype)


def paged_decode_attend(
    q: torch.Tensor,          # [B, 1, H, hd] decode step
    k_pages: torch.Tensor,    # [n_pages, page, KV, hd]
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    pool_lens: torch.Tensor,  # [B] valid pool tokens (fixed through decode)
    kv_off: torch.Tensor,     # [B] absolute position of pool index 0
    tail_k: torch.Tensor,     # [B, Tmax, KV, hd]
    tail_v: torch.Tensor,
    tail_len,                 # int or [B]: valid tail entries (incl. current)
    q_pos: torch.Tensor,      # [B] absolute query position
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Full direct-decode attention = paged pool piece (kernel on the
    card, twin on the CPU) merged with the dense tail piece ->
    [B, 1, H, hd] in q's dtype."""
    step = DecodeStep.build(tables, pool_lens, kv_off, tail_len, q_pos,
                            tail_k.shape[1], sliding_window)
    return step.attend(q, k_pages, v_pages, tail_k, tail_v)


@dataclasses.dataclass(frozen=True)
class DecodeStep:
    """What every layer of one direct decode step shares, built once per
    step: the rows' page tables and lengths, the kernel's meta (on the
    card only) and the tail entries' visibility mask."""
    tables: torch.Tensor             # [B, maxp] int32
    pool_lens: torch.Tensor          # [B]
    kv_off: torch.Tensor             # [B]
    q_pos: torch.Tensor              # [B]
    sliding_window: Optional[int]
    meta: Optional[torch.Tensor]     # [B, 4] paged_decode_meta, card only
    tail_mask: torch.Tensor          # [B, 1, 1, Tmax] bool

    @classmethod
    def build(cls, tables, pool_lens, kv_off, tail_len, q_pos, t_max: int,
              sliding_window: Optional[int] = None) -> "DecodeStep":
        (tables,) = _int32(tables)
        tail_pos0 = kv_off.to(torch.int32) + pool_lens.to(torch.int32)
        meta = (paged_decode_meta(pool_lens, kv_off, q_pos, sliding_window)
                if q_pos.is_cuda else None)
        return cls(tables, pool_lens, kv_off, q_pos, sliding_window, meta,
                   _tail_mask(t_max, tail_len, tail_pos0, q_pos,
                              sliding_window))

    def attend(self, q, k_pages, v_pages, tail_k, tail_v) -> torch.Tensor:
        """``paged_decode_attend`` of one layer: q [B, 1, H, hd], that
        layer's pages and tail -> [B, 1, H, hd] in q's dtype."""
        q1 = q[:, 0].contiguous()
        pooled = paged_attend(q1, k_pages, v_pages, self.tables,
                              self.pool_lens, self.kv_off, self.q_pos,
                              self.sliding_window, meta=self.meta)
        tail = _tail_partials(q1, tail_k, tail_v, self.tail_mask)
        return merge_partials(pooled, tail)[:, None].to(q.dtype)


# ---------------------------------------------------------------------------
# Unified tier: ragged_attend (K2; K3 over int8 pools) and its twin
# ---------------------------------------------------------------------------


def ragged_attend_ref(
    q: torch.Tensor,             # [NB·tq, H, hd]
    k_pages: torch.Tensor,       # [n_pages, page, KV, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [NB, maxp] int32
    block_meta: torch.Tensor,    # [NB, 3] int32: kv_len, qpos0, nq
    tq: int,
    sliding_window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # [n_pages, KV, page] fp32
    v_scale: Optional[torch.Tensor] = None,   # (int8 pools)
) -> torch.Tensor:
    """Gather twin of the ragged kernels: same contract, normalized output
    [NB·tq, H, hd] float32. With ``k_scale``/``v_scale`` the pools are
    int8 and the gathered pages dequantize per (token, kv-head) before the
    scores (``k.float() * scale``: the values the int8 kernel loads)."""
    nb, maxp = block_tables.shape
    _, n_heads, hd = q.shape
    _, page, n_kv, _ = k_pages.shape
    g = n_heads // n_kv
    tables = block_tables.long()
    qb = (q.float() * hd ** -0.5).reshape(nb, tq, n_kv, g, hd)
    k = k_pages[tables].reshape(nb, maxp * page, n_kv, hd).float()
    v = v_pages[tables].reshape(nb, maxp * page, n_kv, hd).float()
    if k_scale is not None:
        k = k * gather_scales(k_scale, block_tables)[..., None]
        v = v * gather_scales(v_scale, block_tables)[..., None]
    scores = torch.einsum("btkgd,bskd->bkgts", qb, k)
    meta = block_meta.to(torch.int32)
    kv_len = meta[:, 0][:, None, None]
    qpos0 = meta[:, 1][:, None, None]
    nq = meta[:, 2][:, None, None]
    t_idx = torch.arange(tq, dtype=torch.int32, device=q.device)[None, :, None]
    s_idx = torch.arange(maxp * page, dtype=torch.int32,
                         device=q.device)[None, None, :]
    qpos = qpos0 + t_idx                               # [NB, tq, 1]
    mask = (s_idx < kv_len) & (s_idx <= qpos) & (t_idx < nq)
    if sliding_window is not None:
        mask = mask & (qpos - s_idx < sliding_window)
    mask = mask[:, None, None]                         # [NB,1,1,tq,S]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1)                                  # [NB,KV,G,tq]
    acc = torch.einsum("bkgts,bskd->bkgtd", p, v)
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(nb * tq, n_heads, hd)


def ragged_attend(
    q: torch.Tensor,             # [NB·tq, H, hd]
    k_pages: torch.Tensor,       # [n_pages, page, KV, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [NB, maxp] int32
    block_meta: torch.Tensor,    # [NB, 3] int32
    tq: int,
    sliding_window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # [n_pages, KV, page] fp32
    v_scale: Optional[torch.Tensor] = None,   # (int8 pools)
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Unified ragged attention: the CUDA kernel for CUDA tensors (it
    launches or raises), the plain twin for CPU tensors whatever
    ``splits`` is. Float pages run ``csrc/ragged_fwd.cu``; with
    ``k_scale``/``v_scale`` the pages are int8 and ``csrc/ragged_q8_fwd.cu``
    runs. Both run on grid (NB, KV, S): device work follows the tick's
    real blocks, never batch x max, and S shares of each block's keys are
    merged by a second launch (``split_count`` picks S; ``splits`` forces
    it, for tests)."""
    if q.device.type == "cpu":
        return ragged_attend_ref(q, k_pages, v_pages, block_tables,
                                 block_meta, tq, sliding_window,
                                 k_scale=k_scale, v_scale=v_scale)
    if not q.is_cuda:
        raise ValueError(f"ragged_attend: no kernel for device {q.device}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("ragged_attend: pass both k_scale and v_scale")
    block_tables, block_meta = _int32(block_tables, block_meta)
    tp, n_heads, hd = q.shape
    n_pages, page, n_kv, _ = k_pages.shape
    nb, maxp = block_tables.shape
    if tp != nb * tq or tuple(block_meta.shape) != (nb, 3):
        raise ValueError(f"ragged_attend: {tp} query tokens for {nb} blocks "
                         f"of tq={tq}, meta {tuple(block_meta.shape)}")
    scales = None if k_scale is None else (k_scale, v_scale)
    _check_kernel_args("ragged_attend", q, k_pages, v_pages,
                       tq * (n_heads // n_kv),
                       (block_tables, block_meta), scales)
    out = torch.empty((tp, n_heads, hd), dtype=torch.float32,
                      device=q.device)
    if nb == 0:
        return out
    window = -1 if sliding_window is None else int(sliding_window)
    splits, ws, ws_ptr = _splits_and_workspace(
        "ragged_attend", splits, nb, n_kv, maxp, page, tp * n_heads, hd,
        q.device)
    kernel, scale_ptrs = ((kernels.RAGGED, []) if scales is None else
                          (kernels.RAGGED_Q8,
                           [k_scale.data_ptr(), v_scale.data_ptr()]))
    kernel.launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scale_ptrs,
        block_tables.data_ptr(), block_meta.data_ptr(), out.data_ptr(),
        ws_ptr, nb, tq, n_heads, n_kv, hd, page, maxp, window, splits,
        hd ** -0.5, _DTYPE_CODES[q.dtype], kernels.stream_handle(q.device))
    return out


def ragged_attend_auto(q, k_pages, v_pages, block_tables, block_meta,
                       tq: int, sliding_window: Optional[int] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The serving path's dispatcher: kernel for CUDA tensors, plain twin
    for CPU tensors (the CPU serving path of the tests); scale pools mark
    int8 pages."""
    if q.is_cuda:
        return ragged_attend(q, k_pages, v_pages, block_tables, block_meta,
                             tq=tq, sliding_window=sliding_window,
                             k_scale=k_scale, v_scale=v_scale)
    return ragged_attend_ref(q, k_pages, v_pages, block_tables, block_meta,
                             tq=tq, sliding_window=sliding_window,
                             k_scale=k_scale, v_scale=v_scale)
