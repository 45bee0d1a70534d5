"""Attention parity of the PyTorch port (quoracle_tpu_torch/ops) against the
JAX package, on the CPU.

The same numpy inputs (numpy.random.default_rng) go through both sides in
fp32. The JAX side runs as its own tests run it: the Pallas kernels in
interpret mode (tests/test_longcontext.py, tests/test_ragged_attention.py)
plus the gather reference. The port side runs its plain PyTorch twins,
which is what its kernel wrappers route CPU tensors to.

Tolerance: 1e-5 absolute and relative. Both sides compute in fp32; they
differ only in the order of the sums (the Pallas kernels accumulate the
online softmax block by block, the twins in one pass), which moves
results of order 1 by a few ulps (~1e-6). Fully masked rows must be
exact zeros on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quoracle_tpu.ops import attention as jattn
from quoracle_tpu.ops import flash_attention as jflash
from quoracle_tpu.ops import paged_attention as jpaged
from quoracle_tpu_torch.ops import attention as tattn
from quoracle_tpu_torch.ops import flash_attention as tflash
from quoracle_tpu_torch.ops import kernels
from quoracle_tpu_torch.ops import paged_attention as tpaged

# tier-1 runs several xdist workers on a few cores: torch's own thread
# pool would oversubscribe them and spin between the small ops here
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dense_case(seed, b, t, s, h, kvh, hd, kv_len, q_pos, offset=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    kv_len = np.asarray(kv_len, np.int32)
    q_pos = np.asarray(q_pos, np.int32)
    off = None if offset is None else np.asarray(offset, np.int32)
    return q, k, v, q_pos, kv_len, off


def _arange_pos(b, t, start=(0, 0)):
    return np.stack([np.arange(t) + start[i] for i in range(b)])


DENSE_CASES = {
    # GQA 4:2, ragged kv_len, unaligned T and S (JAX pads to its tiles)
    "gqa": dict(b=2, t=100, s=160, h=4, kvh=2, hd=32,
                kv_len=[160, 123], q_pos=_arange_pos(2, 100, (60, 23))),
    # MHA, hd 64, sliding window and a nonzero kv position offset
    "window_offset": dict(b=2, t=64, s=96, h=4, kvh=4, hd=64,
                          kv_len=[96, 80], q_pos=_arange_pos(2, 64, (40, 30)),
                          offset=[7, 3], window=24),
    # fully masked rows: row 1 has no valid kv at all, row 0's first
    # queries sit before the buffer's first absolute position
    "masked_rows": dict(b=2, t=48, s=64, h=8, kvh=2, hd=32,
                        kv_len=[64, 0], q_pos=_arange_pos(2, 48, (-5, 0)),
                        offset=[0, 0]),
}


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_attend_matches_jax(name):
    c = dict(DENSE_CASES[name])
    window = c.pop("window", None)
    q, k, v, qp, kl, off = _dense_case(1, **c)
    ref = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(qp), jnp.asarray(kl),
                       sliding_window=window,
                       kv_pos_offset=None if off is None
                       else jnp.asarray(off))
    got = tattn.attend(_t(q), _t(k), _t(v), _t(qp), _t(kl),
                       sliding_window=window,
                       kv_pos_offset=None if off is None else _t(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_flash_twin_matches_jax_kernel(name):
    c = dict(DENSE_CASES[name])
    window = c.pop("window", None)
    q, k, v, qp, kl, off = _dense_case(2, **c)
    ref = jflash.flash_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
        jnp.asarray(kl), sliding_window=window,
        kv_pos_offset=None if off is None else jnp.asarray(off),
        interpret=True, tq=64, tk=64)
    got = tflash.flash_attend_ref(
        _t(q), _t(k), _t(v), _t(qp), _t(kl), sliding_window=window,
        kv_pos_offset=None if off is None else _t(off))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    if name == "masked_rows":
        # nothing visible -> exact zeros on both sides (never NaN, never
        # the mean of V that the dense attend gives)
        assert np.all(got.numpy()[1] == 0.0) and np.all(ref[1] == 0.0)
        assert np.all(got.numpy()[0, :5] == 0.0) and np.all(ref[0, :5] == 0)


def _flat_case(seed, rows, tq, H, KV, hd, page, n_pages, window):
    """A token-major flat tick from (prefix, q_len) rows (q_len 0 = an
    inert padding block), each row on its own scattered page ids."""
    rng = np.random.default_rng(seed)
    maxp = max(-(-(pre + q) // page) for pre, q in rows if q > 0)
    nb = sum(-(-q // tq) if q else 1 for _, q in rows)
    q = rng.standard_normal((nb * tq, H, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, KV, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    btab = np.zeros((nb, maxp), np.int32)
    bmeta = np.zeros((nb, 3), np.int32)
    blk = 0
    for r, (pre, qlen) in enumerate(rows):
        pages = [perm[(r * maxp + j) % len(perm)] for j in range(maxp)]
        for b in range(-(-qlen // tq) if qlen else 1):
            btab[blk] = pages
            bmeta[blk] = (pre + qlen, pre + b * tq,
                          max(0, min(tq, qlen - b * tq)))
            blk += 1
    return q, kp, vp, btab, bmeta


RAGGED_CASES = {
    # chunk blocks of different lengths, an inert block, decode-like rows
    "chunks_tq8": dict(rows=[(40, 1), (17, 11), (0, 19), (5, 0), (63, 1)],
                       tq=8, H=8, KV=2, hd=32, page=16, n_pages=40,
                       window=None),
    "decode_tq1": dict(rows=[(40, 1), (0, 1), (5, 0), (127, 1), (16, 1)],
                       tq=1, H=8, KV=2, hd=32, page=16, n_pages=40,
                       window=None),
    # window edges: smaller than a page, at a page boundary, one past it
    "window_3": dict(rows=[(0, 9), (32, 1), (3, 1), (37, 5)], tq=8, H=4,
                     KV=2, hd=32, page=16, n_pages=24, window=3),
    "window_page": dict(rows=[(0, 9), (32, 1), (16, 1), (37, 5)], tq=8,
                        H=4, KV=2, hd=32, page=16, n_pages=24, window=16),
    "window_page1_tq1": dict(rows=[(17, 1), (32, 1), (0, 0), (50, 1)],
                             tq=1, H=4, KV=4, hd=32, page=16, n_pages=24,
                             window=17),
}


@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_ragged_twin_matches_jax(name):
    c = RAGGED_CASES[name]
    q, kp, vp, btab, bmeta = _flat_case(
        3, c["rows"], c["tq"], c["H"], c["KV"], c["hd"], c["page"],
        c["n_pages"], c["window"])
    args = [jnp.asarray(a) for a in (q, kp, vp, btab, bmeta)]
    jref = np.asarray(jpaged.ragged_attend_ref(
        *args, tq=c["tq"], sliding_window=c["window"]))
    jkrn = np.asarray(jpaged.ragged_attend(
        *args, tq=c["tq"], sliding_window=c["window"], interpret=True))
    got = tpaged.ragged_attend_ref(
        *[_t(a) for a in (q, kp, vp, btab, bmeta)], tq=c["tq"],
        sliding_window=c["window"]).numpy()
    np.testing.assert_allclose(got, jref, **TOL)
    np.testing.assert_allclose(got, jkrn, **TOL)
    # inert blocks and query slots past nq are exact zeros
    for i, (_, _, nq) in enumerate(bmeta):
        tail = got[i * c["tq"] + nq:(i + 1) * c["tq"]]
        assert np.all(tail == 0.0)


def test_cpu_tensors_take_plain_paths_and_never_count_launches():
    kernels.reset_launch_counts()
    c = dict(DENSE_CASES["window_offset"])
    window = c.pop("window")
    q, k, v, qp, kl, off = [None if a is None else _t(a)
                            for a in _dense_case(4, **c)]
    got = tflash.flash_attend(q, k, v, qp, kl, sliding_window=window,
                              kv_pos_offset=off)
    ref = tflash.flash_attend_ref(q, k, v, qp, kl, sliding_window=window,
                                  kv_pos_offset=off)
    assert torch.equal(got, ref)
    # attend_auto keeps the dense path on the CPU even for long chunks,
    # as the JAX dispatcher does off the accelerator
    dense = tattn.attend(q, k, v, qp, kl, sliding_window=window,
                         kv_pos_offset=off)
    auto = tflash.attend_auto(q, k, v, qp, kl, sliding_window=window,
                              kv_pos_offset=off, min_flash_len=1)
    assert torch.equal(auto, dense)
    c = RAGGED_CASES["chunks_tq8"]
    fq = [_t(a) for a in _flat_case(5, c["rows"], c["tq"], c["H"], c["KV"],
                                    c["hd"], c["page"], c["n_pages"], None)]
    ref = tpaged.ragged_attend_ref(*fq, tq=c["tq"])
    assert torch.equal(tpaged.ragged_attend(*fq, tq=c["tq"]), ref)
    assert torch.equal(tpaged.ragged_attend_auto(*fq, tq=c["tq"]), ref)
    # the direct tier's split kernels and their dispatchers
    rng = np.random.default_rng(6)
    B, T, H, KV, hd, page, n_pages = 2, 5, 4, 2, 32, 16, 8
    pools = [_t(rng.standard_normal((n_pages, page, KV, hd))
                .astype(np.float32)) for _ in range(2)]
    tables = _t(np.array([[1, 2], [3, 4]], np.int32))
    lens = _t(np.array([20, 0], np.int32))
    off = _t(np.array([0, 3], np.int32))
    qd = _t(rng.standard_normal((B, H, hd)).astype(np.float32))
    qpos = _t(np.array([22, 4], np.int32))
    for got, ref in zip(
            tpaged.paged_attend(qd, *pools, tables, lens, off, qpos, 8),
            tpaged.paged_attend_ref(qd, *pools, tables, lens, off, qpos, 8)):
        assert torch.equal(got, ref)
    qc = _t(rng.standard_normal((B, T, H, hd)).astype(np.float32))
    for got, ref in zip(
            tpaged.paged_prefill_attend(qc, *pools, tables, lens, 8),
            tpaged.paged_prefill_attend_ref(qc, *pools, tables, lens, 8)):
        assert torch.equal(got, ref)
    ck, cv = (_t(rng.standard_normal((B, T, KV, hd)).astype(np.float32))
              for _ in range(2))
    chunk_lens = _t(np.array([5, 3], np.int32))
    merged = tpaged.paged_prefill_merge(qc, ck, cv, *pools, tables, lens,
                                        chunk_lens, 8)
    assert torch.equal(merged, tpaged.merge_partials(
        tpaged.paged_prefill_attend_ref(qc, *pools, tables, lens, 8),
        tpaged.chunk_attend_partials(qc, ck, cv, chunk_lens, 8)))
    tk, tv = (_t(rng.standard_normal((B, 3, KV, hd)).astype(np.float32))
              for _ in range(2))
    dec = tpaged.paged_decode_attend(qd[:, None], *pools, tables, lens, off,
                                     tk, tv, 3, qpos, 8)
    assert torch.equal(dec[:, 0], tpaged.merge_partials(
        tpaged.paged_attend_ref(qd, *pools, tables, lens, off, qpos, 8),
        tpaged.tail_attend_partials(qd, tk, tv, 3, off + lens, qpos, 8)))
    # the backward on the CPU is autograd through the twin
    qg = q.clone().requires_grad_()
    tflash.flash_attend(qg, k, v, qp, kl, sliding_window=window,
                        kv_pos_offset=off).sum().backward()
    assert qg.grad is not None
    assert kernels.launch_counts() == {"flash_fwd": 0, "flash_bwd": 0,
                                       "ragged_fwd": 0,
                                       "ragged_q8_fwd": 0, "paged_fwd": 0,
                                       "paged_prefill_fwd": 0}
