"""The bf16 tensor-core prefill kernels' numerics and block geometry, on
the CPU (the kernels themselves run only on the card, in chip_smoke.py).

``csrc/tc_attention.cuh`` computes S = QK^T from bf16 q/k with fp32 sums,
keeps the online softmax in fp32 and sums l from the fp32 p, but rounds P
to bf16 once, as the A operand of the P·V mma. ``_tile_loop`` below
emulates that arithmetic in plain PyTorch, tile by tile (64 keys at hd
128, the order of the kernel's rescaling), on bf16 inputs. Held against
the port's fp32 twins (and, for flash, the JAX kernel in interpret mode),
it must stay within ``chip_smoke.within_bar`` -- the bar the card's
kernels are held to -- and must break the bar without the P term on at
least one element: the term is needed, not a loosening at will.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quoracle_tpu.ops import flash_attention as jflash
from quoracle_tpu_torch.ops import flash_attention as tflash
from quoracle_tpu_torch.ops import paged_attention as tpaged
from quoracle_tpu_torch.ops.attention import NEG_INF, attention_mask

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BF16 = torch.bfloat16


def _tile_loop(q, k, v, mask, tile=64):
    """The tensor-core kernels' arithmetic: q [B,T,H,hd], k/v [B,S,KV,hd]
    bf16, mask [B,T,S] -> fp32 partials (acc [B,T,H,hd] unnormalized,
    m [B,T,H], l [B,T,H]); scores fp32 scaled after the dot, masked
    scores NEG_INF and p re-masked to 0, l from the fp32 p, P rounded to
    bf16 for P·V."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, T, KV, G, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * hd ** -0.5
    mk = mask[:, None, None]                         # [B,1,1,T,S]
    m = torch.full((B, KV, G, T), NEG_INF)
    l = torch.zeros((B, KV, G, T))
    acc = torch.zeros((B, KV, G, T, hd))
    for key0 in range(0, S, tile):
        sl = slice(key0, key0 + tile)
        vis = mk[..., sl].expand(B, KV, G, T, -1)
        sc = torch.where(vis, scores[..., sl], torch.full_like(
            scores[..., sl], NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(sc - m_new[..., None]),
                        torch.zeros_like(sc))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgts,bskd->bkgtd", p.to(BF16).float(), v[:, sl].float())
        m = m_new
    return (acc.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd),
            m.permute(0, 3, 1, 2).reshape(B, T, H),
            l.permute(0, 3, 1, 2).reshape(B, T, H))


def _old_bar(kernel, got, ref):
    """The bar before the tensor-core kernels: atol + rtol·|ref| only."""
    atol, rtol = chip_smoke.TOL[(kernel, "bfloat16")]
    return (got.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(BF16)


FLASH_CASES = {
    # GQA 4:2, ragged kv_len, T and S no multiple of the 64-key tile
    "gqa": dict(b=2, t=100, s=160, h=4, kvh=2, hd=32, kv_len=[160, 123],
                start=(60, 23), offset=None, window=None),
    # MHA, hd 64, sliding window and a nonzero kv position offset
    "window_offset": dict(b=2, t=64, s=96, h=4, kvh=4, hd=64,
                          kv_len=[96, 80], start=(40, 30), offset=[7, 3],
                          window=24),
    # fully masked rows: row 1 sees no kv, row 0's first queries sit
    # before the buffer's first position; G = 4
    "masked_rows": dict(b=2, t=48, s=64, h=8, kvh=2, hd=32, kv_len=[64, 0],
                        start=(-5, 0), offset=[0, 0], window=None),
    # hd 128 at llama-3-8b's G = 4, several tiles, a window across them
    "hd128": dict(b=1, t=200, s=264, h=8, kvh=2, hd=128, kv_len=[264],
                  start=(64,), offset=None, window=150),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_bf16_tile_loop_within_the_bar(name):
    c = FLASH_CASES[name]
    rng = np.random.default_rng(21)
    b, t, s = c["b"], c["t"], c["s"]
    q = _bf16(rng, b, t, c["h"], c["hd"])
    k = _bf16(rng, b, s, c["kvh"], c["hd"])
    v = _bf16(rng, b, s, c["kvh"], c["hd"])
    qp = torch.from_numpy(np.stack([np.arange(t) + c["start"][i]
                                    for i in range(b)]).astype(np.int32))
    kl = torch.tensor(c["kv_len"], dtype=torch.int32)
    off = None if c["offset"] is None else torch.tensor(c["offset"],
                                                        dtype=torch.int32)
    w = c["window"]
    acc, _, l = _tile_loop(q, k, v, attention_mask(qp, kl, s, w, off))
    got = torch.where(l[..., None] > 0, acc / torch.where(
        l > 0, l, torch.ones_like(l))[..., None], torch.zeros_like(acc)
    ).to(BF16)
    ref = tflash.flash_attend_ref(q, k, v, qp, kl, w, off)
    ref_abs = tflash.flash_attend_ref(q, k, v.abs(), qp, kl, w, off)
    assert bool(chip_smoke.within_bar("flash_fwd", "bfloat16", got, ref,
                                      ref_abs).all())
    assert not bool(_old_bar("flash_fwd", got, ref).all())
    # the JAX kernel (interpret mode, fp32 on the same bf16 values),
    # rounded to bf16 like the kernel's output, under the same bar
    j = jflash.flash_attend(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
        jnp.asarray(qp.numpy()), jnp.asarray(kl.numpy()), sliding_window=w,
        kv_pos_offset=None if off is None else jnp.asarray(off.numpy()),
        interpret=True, tq=64, tk=64)
    jref = torch.from_numpy(np.array(j)).to(BF16)
    assert bool(chip_smoke.within_bar("flash_fwd", "bfloat16", got, jref,
                                      ref_abs).all())
    # rows with nothing visible stay exact zeros
    dead = l == 0
    assert bool(torch.all(got[dead] == 0))
    if name == "masked_rows":
        assert bool(dead[1].all()) and bool(dead[0, :5].all())


@pytest.mark.parametrize("window", [None, 300])
def test_paged_prefill_bf16_tile_loop_within_the_bar(window):
    """A chunk of 37 queries against prefixes of 808 (the main path's
    resumed rows), 0 (an empty row) and 130 keys on scattered pages."""
    rng = np.random.default_rng(22)
    B, T, H, KV, hd, page, n_pages, maxp = 3, 37, 8, 2, 64, 64, 40, 13
    q = _bf16(rng, B, T, H, hd)
    kp = _bf16(rng, n_pages, page, KV, hd)
    vp = _bf16(rng, n_pages, page, KV, hd)
    tables = torch.from_numpy(rng.permutation(np.arange(1, n_pages))[
        :B * maxp].reshape(B, maxp).astype(np.int32) % n_pages)
    lens = torch.tensor([808, 0, 130], dtype=torch.int32)
    ref = tpaged.paged_prefill_attend_ref(q, kp, vp, tables, lens, window)
    acc_abs = tpaged.paged_prefill_attend_ref(q, kp, vp.abs(), tables, lens,
                                              window)[0]
    # the kernel's view: each row's pages gathered, the twin's mask
    t = tables.long()
    k = kp[t].reshape(B, maxp * page, KV, hd)
    v = vp[t].reshape(B, maxp * page, KV, hd)
    s_idx = torch.arange(maxp * page)
    mask = (s_idx[None, None] < lens[:, None, None]).expand(B, T, -1)
    if window is not None:
        dist = lens[:, None, None] + torch.arange(T)[None, :, None] \
            - s_idx[None, None]
        mask = mask & (dist < window)
    got = _tile_loop(q, k, v, mask)
    for name, g, r in zip(("acc", "m", "l"), got, ref):
        kern = f"paged_prefill_fwd.{name}"
        assert bool(chip_smoke.within_bar(
            kern, "bfloat16", g, r, acc_abs if name == "acc" else None
        ).all()), name
    assert not bool(_old_bar("paged_prefill_fwd.acc", got[0], ref[0]).all())
    acc, m, l = got
    assert bool(torch.all(acc[1] == 0)) and bool(torch.all(m[1] == NEG_INF))
    assert bool(torch.all(l[1] == 0))


def test_bar_needs_ref_abs_for_the_tensor_core_kernels():
    x = torch.zeros(3)
    with pytest.raises(ValueError):
        chip_smoke.within_bar("flash_fwd", "bfloat16", x, x)
    # fp32 keeps its bars, with no P term
    assert bool(chip_smoke.within_bar("flash_fwd", "float32", x, x).all())
    assert ("flash_fwd", "float32") not in chip_smoke.P_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
def test_prefill_block_geometry(G, dtype):
    tq, rows = tpaged.prefill_block(8 * G, 8, dtype)
    assert rows == (64 if dtype == torch.bfloat16 else 32)
    assert tq == rows // G and tq * G <= rows
    # G = 7 leaves rows no query fills (the kernel masks them)
    assert rows - tq * G == rows % G
    if dtype == torch.bfloat16:
        assert rows == tpaged.TC_SCORE_ROWS
    else:
        assert rows == tpaged.MAX_SCORE_ROWS
