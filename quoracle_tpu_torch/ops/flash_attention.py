"""Flash attention for long dense prefill chunks (port of
``quoracle_tpu/ops/flash_attention.py``).

``flash_attend`` launches the hand-written CUDA kernel
(``csrc/flash_fwd.cu``: bf16 on the tensor cores through
``csrc/tc_attention.cuh``, fp32 on the scalar core of ``common.cuh``;
the dtype chooses) for CUDA tensors and runs its plain PyTorch twin
``flash_attend_ref`` for CPU tensors; there is no other route. Semantics
match the Pallas ``_flash_kernel``: validity by ``kv_len``, causality by
absolute position, optional sliding window, GQA by head-index mapping,
and a query row with nothing visible outputs exact zeros (where the dense
``attend`` would average V).
"""

from __future__ import annotations

from typing import Optional

import torch

from quoracle_tpu_torch.ops import kernels
from quoracle_tpu_torch.ops.attention import NEG_INF, attend, attention_mask

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attend_ref(
    q: torch.Tensor,            # [B, T, n_heads, hd]
    k: torch.Tensor,            # [B, S, n_kv, hd]
    v: torch.Tensor,            # [B, S, n_kv, hd]
    q_positions: torch.Tensor,  # [B, T] int32
    kv_len: torch.Tensor,       # [B] int32
    sliding_window: Optional[int] = None,
    kv_pos_offset: Optional[torch.Tensor] = None,   # [B] int32
) -> torch.Tensor:
    """Plain PyTorch twin of the flash kernel: the masked softmax written
    the way the kernel normalizes it (probabilities re-masked to zero, rows
    with a zero denominator output 0). fp32 math, output in q's dtype."""
    b, t, n_heads, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    g = n_heads // n_kv
    qf = (q.float() * hd ** -0.5).reshape(b, t, n_kv, g, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    mask = attention_mask(q_positions, kv_len, s, sliding_window,
                          kv_pos_offset)[:, None, None]     # [B,1,1,T,S]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgts,bskd->bkgtd", p, v.float())
    out = torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)),
                      torch.zeros_like(acc))
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, n_heads, hd).to(q.dtype)


def _check_flash_args(q, k, v, q_positions, kv_len, kv_pos_offset):
    b, t, n_heads, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attend: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if n_heads % k.shape[2]:
        raise ValueError(f"flash_attend: {n_heads} query heads over "
                         f"{k.shape[2]} kv heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attend: CUDA kernel takes float32 or "
                         f"bfloat16 q/k/v of one dtype, got {q.dtype}/"
                         f"{k.dtype}/{v.dtype}")
    if hd not in (128, 256):
        raise ValueError(f"flash_attend: CUDA kernel is built for head_dim "
                         f"128 and 256, got {hd}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attend: {name} must be contiguous")
    if tuple(q_positions.shape) != (b, t) or tuple(kv_len.shape) != (b,) \
            or tuple(kv_pos_offset.shape) != (b,):
        raise ValueError("flash_attend: q_positions [B,T], kv_len [B] and "
                         "kv_pos_offset [B] expected")
    for x in (k, v, q_positions, kv_len, kv_pos_offset):
        if x.device != q.device:
            raise ValueError("flash_attend: all tensors must share q's "
                             "device")


def flash_attend(
    q: torch.Tensor,            # [B, T, n_heads, hd]
    k: torch.Tensor,            # [B, S, n_kv, hd]
    v: torch.Tensor,            # [B, S, n_kv, hd]
    q_positions: torch.Tensor,  # [B, T] int32
    kv_len: torch.Tensor,       # [B] int32
    sliding_window: Optional[int] = None,
    kv_pos_offset: Optional[torch.Tensor] = None,   # [B] int32
) -> torch.Tensor:
    """Flash attention: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain twin for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attend_ref(q, k, v, q_positions, kv_len,
                                sliding_window, kv_pos_offset)
    if not q.is_cuda:
        raise ValueError(f"flash_attend: no kernel for device {q.device}")
    b, t, n_heads, hd = q.shape
    if kv_pos_offset is None:
        kv_pos_offset = torch.zeros((b,), dtype=torch.int32, device=q.device)
    q_positions = q_positions.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    kv_pos_offset = kv_pos_offset.to(torch.int32).contiguous()
    _check_flash_args(q, k, v, q_positions, kv_len, kv_pos_offset)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    kernels.FLASH.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        kv_len.data_ptr(), kv_pos_offset.data_ptr(), out.data_ptr(),
        b, t, k.shape[1], n_heads, k.shape[2], hd,
        -1 if sliding_window is None else int(sliding_window),
        hd ** -0.5, _DTYPE_CODES[q.dtype], kernels.stream_handle(q.device))
    return out


def attend_auto(q, k, v, q_positions, kv_len,
                sliding_window: Optional[int] = None,
                kv_pos_offset: Optional[torch.Tensor] = None,
                min_flash_len: int = 256) -> torch.Tensor:
    """Pick the attention path as the JAX package does: the flash kernel
    on the accelerator for prefill chunks of at least ``min_flash_len``
    tokens, dense ``attend`` otherwise (decode steps, short chunks, CPU)."""
    if q.is_cuda and q.shape[1] >= min_flash_len:
        return flash_attend(q, k, v, q_positions, kv_len,
                            sliding_window=sliding_window,
                            kv_pos_offset=kv_pos_offset)
    return attend(q, k, v, q_positions, kv_len,
                  sliding_window=sliding_window,
                  kv_pos_offset=kv_pos_offset)
