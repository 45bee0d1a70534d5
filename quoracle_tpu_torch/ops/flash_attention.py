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

Gradients (the training step runs the flash kernel at seq >= 256 on the
card): a CUDA call whose inputs require grad goes through ``_FlashFn``, a
``torch.autograd.Function`` whose backward launches the hand-written
``csrc/flash_bwd.cu`` (dq, dk, dv given dout; ``flash_attend_bwd_ref`` is
its plain twin). The JAX package's Pallas kernel has no backward at all.
Under ``no_grad`` (serving) the wrapper launches ``flash_fwd`` exactly as
before; on the CPU autograd runs through ``flash_attend_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from quoracle_tpu_torch.ops import kernels
from quoracle_tpu_torch.ops.attention import NEG_INF, attend, attention_mask

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _masked_exp(q, k, q_positions, kv_len, sliding_window, kv_pos_offset):
    """The twins' shared softmax pieces: q scaled by hd^-0.5 in fp32
    [B, T, KV, G, hd], exp(scores - rowmax) re-masked to exact zeros
    [B, KV, G, T, S], and its row sums l [B, KV, G, T, 1]."""
    b, t, n_heads, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    qf = (q.float() * hd ** -0.5).reshape(b, t, n_kv, n_heads // n_kv, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    mask = attention_mask(q_positions, kv_len, s, sliding_window,
                          kv_pos_offset)[:, None, None]     # [B,1,1,T,S]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    return qf, p, p.sum(dim=-1, keepdim=True)


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
    _, p, l = _masked_exp(q, k, q_positions, kv_len, sliding_window,
                          kv_pos_offset)
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


def flash_attend_bwd_ref(
    q: torch.Tensor,            # [B, T, n_heads, hd]
    k: torch.Tensor,            # [B, S, n_kv, hd]
    v: torch.Tensor,            # [B, S, n_kv, hd]
    q_positions: torch.Tensor,  # [B, T] int32
    kv_len: torch.Tensor,       # [B] int32
    dout: torch.Tensor,         # [B, T, n_heads, hd]
    sliding_window: Optional[int] = None,
    kv_pos_offset: Optional[torch.Tensor] = None,   # [B] int32
    out: Optional[torch.Tensor] = None,             # [B, T, n_heads, hd]
    abs_terms: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the backward kernel: (dq, dk, dv) of
    ``flash_attend_ref`` given ``dout``, written out the way the kernel
    computes them (P = exp(S - lse) over the visible keys, delta =
    rowsum(dout * out), dS = P (dP - delta)). ``out`` is the forward
    output the kernel is handed (in q's dtype); None: recomputed here in
    fp32. fp32 math, gradients in the inputs' dtypes. A row that sees
    nothing has P = 0: it adds nothing. ``abs_terms``: the same sums over
    the terms' magnitudes (|dS||k|, |dS||q|, P|dout|) in fp32, the scale
    of an error from summing in another order."""
    b, t, n_heads, hd = q.shape
    n_kv = k.shape[2]
    g = n_heads // n_kv
    qf, p, l = _masked_exp(q, k, q_positions, kv_len, sliding_window,
                           kv_pos_offset)
    p = torch.where(l > 0, p / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(p))                    # [B,KV,G,T,S]
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(b, t, n_kv, g, hd)
    if out is None:
        o = torch.einsum("bkgts,bskd->btkgd", p, vf)
    else:
        o = out.float().reshape(b, t, n_kv, g, hd)
    delta = (dof * o).sum(-1).permute(0, 2, 3, 1)[..., None]   # [B,KV,G,T,1]
    dp = torch.einsum("btkgd,bskd->bkgts", dof, vf)
    ds = p * (dp - delta)
    if abs_terms:
        ds, kf, qf, dof = ds.abs(), kf.abs(), qf.abs(), dof.abs()
    dq = torch.einsum("bkgts,bskd->btkgd", ds, kf) * hd ** -0.5
    dk = torch.einsum("bkgts,btkgd->bskd", ds, qf)
    dv = torch.einsum("bkgts,btkgd->bskd", p, dof)
    if abs_terms:
        return dq.reshape(b, t, n_heads, hd), dk, dv
    return (dq.reshape(b, t, n_heads, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _kernel_args(q, k, v, q_positions, kv_len, kv_pos_offset):
    """int32, contiguous positions/lengths/offsets (zeros for a missing
    offset), checked against q/k/v for the kernels."""
    if not q.is_cuda:
        raise ValueError(f"flash_attend: no kernel for device {q.device}")
    if kv_pos_offset is None:
        kv_pos_offset = torch.zeros((q.shape[0],), dtype=torch.int32,
                                    device=q.device)
    q_positions = q_positions.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    kv_pos_offset = kv_pos_offset.to(torch.int32).contiguous()
    _check_flash_args(q, k, v, q_positions, kv_len, kv_pos_offset)
    return q_positions, kv_len, kv_pos_offset


def _window_arg(sliding_window: Optional[int]) -> int:
    return -1 if sliding_window is None else int(sliding_window)


def _flash_fwd(q, k, v, q_positions, kv_len, sliding_window, kv_pos_offset):
    b, t, n_heads, hd = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    kernels.FLASH.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        kv_len.data_ptr(), kv_pos_offset.data_ptr(), out.data_ptr(),
        b, t, k.shape[1], n_heads, k.shape[2], hd,
        _window_arg(sliding_window), hd ** -0.5, _DTYPE_CODES[q.dtype],
        kernels.stream_handle(q.device))
    return out


def flash_bwd(q, k, v, out, dout, q_positions, kv_len,
              sliding_window: Optional[int] = None,
              kv_pos_offset: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the backward kernel for CUDA tensors (it launches
    or raises); ``out`` is flash_fwd's output for the same inputs."""
    q_positions, kv_len, kv_pos_offset = _kernel_args(
        q, k, v, q_positions, kv_len, kv_pos_offset)
    dout = dout.to(q.dtype).contiguous()
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or not out.is_contiguous():
        raise ValueError("flash_bwd: out and dout must be contiguous and "
                         "shaped and typed as q")
    b, t, n_heads, hd = q.shape
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = torch.empty((b, n_heads, t), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    kernels.FLASH_BWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), q_positions.data_ptr(), kv_len.data_ptr(),
        kv_pos_offset.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        b, t, k.shape[1], n_heads, k.shape[2], hd,
        _window_arg(sliding_window), hd ** -0.5, _DTYPE_CODES[q.dtype],
        kernels.stream_handle(q.device))
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """flash_fwd forward, flash_bwd backward (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_len, kv_pos_offset,
                sliding_window):
        out = _flash_fwd(q, k, v, q_positions, kv_len, sliding_window,
                         kv_pos_offset)
        ctx.save_for_backward(q, k, v, out, q_positions, kv_len,
                              kv_pos_offset)
        ctx.sliding_window = sliding_window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, q_positions, kv_len, kv_pos_offset = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, dout, q_positions, kv_len,
                               ctx.sliding_window, kv_pos_offset)
        return dq, dk, dv, None, None, None, None


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
    raises; differentiable through the backward kernel when grad is on and
    q, k or v requires it), the plain twin for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attend_ref(q, k, v, q_positions, kv_len,
                                sliding_window, kv_pos_offset)
    q_positions, kv_len, kv_pos_offset = _kernel_args(
        q, k, v, q_positions, kv_len, kv_pos_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashFn.apply(q, k, v, q_positions, kv_len, kv_pos_offset,
                              sliding_window)
    return _flash_fwd(q, k, v, q_positions, kv_len, sliding_window,
                      kv_pos_offset)


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
