"""Gradients of the port's flash attention (quoracle_tpu_torch/ops/
flash_attention.py) on the CPU, against the JAX package.

``flash_attend`` on a CPU tensor runs its plain twin, and autograd runs
through it; on the card the same call goes through ``_FlashFn`` and the
backward kernel (csrc/flash_bwd.cu), which chip_smoke.py holds against
``flash_attend_bwd_ref``. Here:

* the gradients (dq, dk, dv given dout) against ``jax.grad`` of the JAX
  ``attend`` with rows that see nothing set to 0 (the flash kernels'
  semantics: the dense ``attend`` averages V there): GQA, a sliding
  window, ``kv_pos_offset``, a padded ``kv_len`` and empty rows, within
  1e-5 (fp32 sums over a few keys in another order);
* ``flash_attend_bwd_ref`` (the backward kernel's written-out twin)
  against autograd through ``flash_attend_ref``, within 1e-5;
* the reference's gap: ``jax.grad`` through the Pallas ``flash_attend``
  (interpret mode) raises ``NotImplementedError``: the JAX package's
  training step cannot run at seq >= 256 on a TPU, where ``attend_auto``
  picks the Pallas kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quoracle_tpu.ops.attention import attend as jattend
from quoracle_tpu.ops.flash_attention import flash_attend as jflash
from quoracle_tpu_torch.ops.attention import attention_mask
from quoracle_tpu_torch.ops.flash_attention import (
    attend_auto, flash_attend, flash_attend_bwd_ref, flash_attend_ref,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, T, S, H, KV, hd, window, first query position, kv_len, offset)
CASES = {
    "gqa": (2, 8, 8, 4, 2, 16, None, [0, 0], [8, 8], [0, 0]),
    "mha-window": (2, 9, 9, 2, 2, 8, 3, [0, 0], [9, 9], [0, 0]),
    "offset-padded": (2, 7, 10, 4, 1, 16, None, [5, 3], [10, 6], [2, 0]),
    # row 0's first three queries sit before every key: empty rows
    "empty-rows": (2, 6, 8, 4, 2, 8, 4, [0, 2], [8, 5], [3, 0]),
}


def _inputs(case, seed=0):
    B, T, S, H, KV, hd, window, q0, kv_len, off = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    dout = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    pos = (np.asarray(q0)[:, None] + np.arange(T)[None]).astype(np.int32)
    return (q, k, v, dout, pos, np.asarray(kv_len, np.int32),
            np.asarray(off, np.int32), window)


def _jax_grads(q, k, v, dout, pos, kv_len, off, window):
    """jax.grad of the JAX ``attend`` with empty rows zeroed (the jnp.where
    also stops their gradient, as the kernel's P = 0 does)."""
    S = k.shape[1]
    kv_pos = jnp.arange(S)[None, None, :] + off[:, None, None]
    vis = (jnp.arange(S)[None, None, :] < kv_len[:, None, None]) \
        & (kv_pos <= pos[:, :, None])
    if window is not None:
        vis = vis & (pos[:, :, None] - kv_pos < window)
    any_vis = vis.any(-1)[:, :, None, None]

    def f(q, k, v):
        out = jattend(q, k, v, jnp.asarray(pos), jnp.asarray(kv_len),
                      sliding_window=window,
                      kv_pos_offset=jnp.asarray(off))
        return jnp.sum(jnp.where(any_vis, out, 0.0) * dout)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_grads_match_jax_grad_of_attend(case):
    q, k, v, dout, pos, kv_len, off, window = _inputs(case)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attend(tq, tk, tv, torch.from_numpy(pos),
                       torch.from_numpy(kv_len), window,
                       torch.from_numpy(off))
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    want = _jax_grads(q, k, v, dout, pos, kv_len, off, window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **TOL)
    if case == "empty-rows":
        mask = attention_mask(torch.from_numpy(pos),
                              torch.from_numpy(kv_len), k.shape[1], window,
                              torch.from_numpy(off))
        empty = ~mask.any(-1)                            # [B, T]
        assert empty.any()
        assert torch.all(out.detach()[empty] == 0)
        assert torch.all(got[0][empty] == 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_twin_matches_autograd_through_the_forward_twin(case):
    q, k, v, dout, pos, kv_len, off, window = _inputs(case, seed=1)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    args = (torch.from_numpy(pos), torch.from_numpy(kv_len))
    out = flash_attend_ref(tq, tk, tv, *args, window, torch.from_numpy(off))
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    got = flash_attend_bwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), *args,
                               torch.from_numpy(dout), window,
                               torch.from_numpy(off))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, **TOL)


def test_bwd_twin_takes_the_forward_output():
    """Handed the forward's own output (what the kernel gets), the twin
    gives what it gives when it recomputes that output."""
    q, k, v, dout, pos, kv_len, off, window = _inputs("empty-rows", seed=2)
    t = [torch.from_numpy(x) for x in (q, k, v, pos, kv_len, dout, off)]
    out = flash_attend_ref(t[0], t[1], t[2], t[3], t[4], window, t[6])
    a = flash_attend_bwd_ref(*t[:6], window, t[6])
    b = flash_attend_bwd_ref(*t[:6], window, t[6], out=out)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_twin_abs_terms_bound_the_gradients(case):
    """``abs_terms`` sums the same products' magnitudes: fp32, each
    element at least the gradient's own magnitude, and exactly the
    gradient where every term is non-negative (dv's P |dout|)."""
    q, k, v, dout, pos, kv_len, off, window = _inputs(case, seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v, pos, kv_len, dout, off)]
    grads = flash_attend_bwd_ref(*t[:6], window, t[6])
    mags = flash_attend_bwd_ref(*t[:6], window, t[6], abs_terms=True)
    for g, m in zip(grads, mags):
        assert m.dtype == torch.float32 and m.shape == g.shape
        assert torch.all(m + 1e-6 >= g.abs())
    dv_abs = flash_attend_bwd_ref(*t[:5], t[5].abs(), window, t[6])[2]
    torch.testing.assert_close(mags[2], dv_abs, rtol=1e-6, atol=1e-6)


def test_bwd_twin_keeps_bf16_inputs_dtype():
    q, k, v, dout, pos, kv_len, off, window = _inputs("gqa")
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, dout)]
    dq, dk, dv = flash_attend_bwd_ref(bf[0], bf[1], bf[2],
                                      torch.from_numpy(pos),
                                      torch.from_numpy(kv_len), bf[3])
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert dq.shape == bf[0].shape and dk.shape == bf[1].shape


def test_no_grad_forward_is_the_plain_path():
    """Under no_grad (serving) the output carries no graph; with grad on
    and the inputs requiring it, attend_auto's CPU path is differentiable
    (the dense attend below the flash length, as the JAX package picks)."""
    q, k, v, dout, pos, kv_len, off, window = _inputs("gqa")
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        out = flash_attend(tq, tk, tv, torch.from_numpy(pos),
                           torch.from_numpy(kv_len))
    assert out.grad_fn is None
    out = attend_auto(tq, tk, tv, torch.from_numpy(pos),
                      torch.from_numpy(kv_len))
    assert out.grad_fn is not None


def test_jax_cannot_differentiate_its_pallas_flash_kernel():
    """The reference's gap: the Pallas kernel has no VJP, so jax.grad
    through it raises, and the JAX training step fails on a TPU wherever
    attend_auto picks it (chunks of 256 tokens or more). The port's
    kernel has a backward (csrc/flash_bwd.cu)."""
    rng = np.random.default_rng(0)
    T = 256
    q = jnp.asarray(rng.standard_normal((1, T, 2, 128)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((1, T, 1, 128)), jnp.float32)
    pos = jnp.arange(T, dtype=jnp.int32)[None]
    kv_len = jnp.full((1,), T, jnp.int32)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda q: jflash(q, k, k, pos, kv_len,
                                  interpret=True).sum())(q)
