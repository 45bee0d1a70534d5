"""Dense attention for cache-backed decoding and short prefill chunks
(port of ``quoracle_tpu/ops/attention.py``).

Plain PyTorch, on the main path exactly where the JAX package runs plain
XLA ``attend``: decode steps and dense prefill chunks shorter than the
flash threshold (ops/flash_attention.attend_auto). Callers pass padded
buffers plus integer lengths, never ragged structures.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[B, S, n_kv, hd] -> [B, S, n_kv * q_per_kv, hd] by head repetition."""
    if q_per_kv == 1:
        return x
    b, s, n_kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, n_kv, q_per_kv, hd).reshape(
        b, s, n_kv * q_per_kv, hd)


def attention_mask(q_positions: torch.Tensor, kv_len: torch.Tensor, s: int,
                   sliding_window: Optional[int] = None,
                   kv_pos_offset: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """[B, T, S] bool visibility: kv index < kv_len, kv absolute position
    (offset + index) <= query position, and inside the sliding window."""
    kv_idx = torch.arange(s, dtype=torch.int32,
                          device=q_positions.device)[None, None, :]
    kv_pos = kv_idx if kv_pos_offset is None else (
        kv_idx + kv_pos_offset.to(torch.int32)[:, None, None])
    qp = q_positions.to(torch.int32)[:, :, None]
    mask = (kv_idx < kv_len.to(torch.int32)[:, None, None]) & (kv_pos <= qp)
    if sliding_window is not None:
        mask = mask & (qp - kv_pos < sliding_window)
    return mask


def attend(
    q: torch.Tensor,            # [B, T, n_heads, hd]
    k: torch.Tensor,            # [B, S, n_kv, hd]
    v: torch.Tensor,            # [B, S, n_kv, hd]
    q_positions: torch.Tensor,  # [B, T] int32 absolute query positions
    kv_len: torch.Tensor,       # [B] int32 valid kv entries (<= S)
    sliding_window: Optional[int] = None,
    kv_pos_offset: Optional[torch.Tensor] = None,   # [B] abs pos of idx 0
) -> torch.Tensor:
    """Causal attention of a query chunk against a (partially filled) kv
    buffer; one code path for prefill (T = chunk) and decode (T = 1).
    A fully masked row gets the softmax of equal scores (the mean of V),
    exactly as the JAX ``attend``. Returns [B, T, n_heads, hd]."""
    b, t, n_heads, hd = q.shape
    s = k.shape[1]
    q_per_kv = n_heads // k.shape[2]
    k = repeat_kv(k, q_per_kv)
    v = repeat_kv(v, q_per_kv)
    scores = torch.einsum("bthd,bshd->bhts", q.float() * hd ** -0.5,
                          k.float())
    mask = attention_mask(q_positions, kv_len, s, sliding_window,
                          kv_pos_offset)
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return out.to(q.dtype)
