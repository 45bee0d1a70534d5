"""Unified ragged paged attention (port of the unified section of
``quoracle_tpu/ops/paged_attention.py``).

Token-major flattened batch: every row's query tokens lie contiguously in
one [NB·tq, H, hd] tensor, each row's segment padded to whole ``tq``-token
blocks so a block never spans two rows. Per block:

  block_tables[i]  the owning row's page table, [maxp] page ids
  block_meta[i]    (kv_len, qpos0, nq): the row's valid KV tokens in its
                   pages INCLUDING this chunk (the layer writes chunk KV to
                   the pages before attending), the buffer position of the
                   block's first query, and its valid queries (0 = inert)

``ragged_attend`` launches the hand-written CUDA kernel
(``csrc/ragged_fwd.cu``) for CUDA tensors and runs the plain twin
``ragged_attend_ref`` for CPU tensors. The int8 pool variant and the tp
shard wrapper of the JAX module are later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from quoracle_tpu_torch.ops import kernels
from quoracle_tpu_torch.ops.attention import NEG_INF

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SCORE_ROWS = 32         # tq * (H / KV) rows per CUDA block
KEY_TILE = 64               # keys per shared-memory tile (page % 64 == 0)


def ragged_attend_ref(
    q: torch.Tensor,             # [NB·tq, H, hd]
    k_pages: torch.Tensor,       # [n_pages, page, KV, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [NB, maxp] int32
    block_meta: torch.Tensor,    # [NB, 3] int32: kv_len, qpos0, nq
    tq: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Gather twin of the ragged kernel: same contract, normalized output
    [NB·tq, H, hd] float32."""
    nb, maxp = block_tables.shape
    _, n_heads, hd = q.shape
    _, page, n_kv, _ = k_pages.shape
    g = n_heads // n_kv
    tables = block_tables.long()
    qb = (q.float() * hd ** -0.5).reshape(nb, tq, n_kv, g, hd)
    k = k_pages[tables].reshape(nb, maxp * page, n_kv, hd).float()
    v = v_pages[tables].reshape(nb, maxp * page, n_kv, hd).float()
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


def _check_ragged_args(q, k_pages, v_pages, block_tables, block_meta, tq):
    tp, n_heads, hd = q.shape
    n_pages, page, n_kv, hd_k = k_pages.shape
    nb = block_tables.shape[0]
    if v_pages.shape != k_pages.shape or hd_k != hd or n_heads % n_kv:
        raise ValueError(f"ragged_attend: q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"disagree")
    if tp != nb * tq or tuple(block_meta.shape) != (nb, 3):
        raise ValueError(f"ragged_attend: {tp} query tokens for {nb} blocks "
                         f"of tq={tq}, meta {tuple(block_meta.shape)}")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"ragged_attend: CUDA kernel takes float32 or "
                         f"bfloat16 q/pages of one dtype, got {q.dtype}/"
                         f"{k_pages.dtype}/{v_pages.dtype}")
    if hd not in (128, 256):
        raise ValueError(f"ragged_attend: CUDA kernel is built for head_dim "
                         f"128 and 256, got {hd}")
    if tq * (n_heads // n_kv) > MAX_SCORE_ROWS:
        raise ValueError(f"ragged_attend: tq * (H / KV) = "
                         f"{tq * (n_heads // n_kv)} exceeds the kernel's "
                         f"{MAX_SCORE_ROWS} score rows per block")
    if page % KEY_TILE:
        raise ValueError(f"ragged_attend: page size {page} is not a "
                         f"multiple of the kernel's {KEY_TILE}-key tile")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not x.is_contiguous():
            raise ValueError(f"ragged_attend: {name} must be contiguous")
    for x in (k_pages, v_pages, block_tables, block_meta):
        if x.device != q.device:
            raise ValueError("ragged_attend: all tensors must share q's "
                             "device")


def ragged_attend(
    q: torch.Tensor,             # [NB·tq, H, hd]
    k_pages: torch.Tensor,       # [n_pages, page, KV, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [NB, maxp] int32
    block_meta: torch.Tensor,    # [NB, 3] int32
    tq: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Unified ragged attention: the CUDA kernel for CUDA tensors (it
    launches or raises), the plain twin for CPU tensors. Grid (NB, KV):
    device work follows the tick's real blocks, never batch x max."""
    if q.device.type == "cpu":
        return ragged_attend_ref(q, k_pages, v_pages, block_tables,
                                 block_meta, tq, sliding_window)
    if not q.is_cuda:
        raise ValueError(f"ragged_attend: no kernel for device {q.device}")
    block_tables = block_tables.to(torch.int32).contiguous()
    block_meta = block_meta.to(torch.int32).contiguous()
    _check_ragged_args(q, k_pages, v_pages, block_tables, block_meta, tq)
    tp, n_heads, hd = q.shape
    n_pages, page, n_kv, _ = k_pages.shape
    nb, maxp = block_tables.shape
    out = torch.empty((tp, n_heads, hd), dtype=torch.float32,
                      device=q.device)
    if nb == 0:
        return out
    kernels.RAGGED.launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), block_meta.data_ptr(), out.data_ptr(),
        nb, tq, n_heads, n_kv, hd, page, maxp,
        -1 if sliding_window is None else int(sliding_window),
        hd ** -0.5, _DTYPE_CODES[q.dtype], kernels.stream_handle(q.device))
    return out


def ragged_attend_auto(q, k_pages, v_pages, block_tables, block_meta,
                       tq: int, sliding_window: Optional[int] = None
                       ) -> torch.Tensor:
    """The serving path's dispatcher: kernel for CUDA tensors, plain twin
    for CPU tensors (the CPU serving path of the tests)."""
    if q.is_cuda:
        return ragged_attend(q, k_pages, v_pages, block_tables, block_meta,
                             tq=tq, sliding_window=sliding_window)
    return ragged_attend_ref(q, k_pages, v_pages, block_tables, block_meta,
                             tq=tq, sliding_window=sliding_window)
