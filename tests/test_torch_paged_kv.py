"""The direct and gather paged tiers of the PyTorch port against the JAX
package, on the CPU in fp32.

Attention pieces: the port's twins of the two split kernels
(``paged_attend_ref``, ``paged_prefill_attend_ref``) against the JAX
Pallas kernels run in interpret mode (hd 32 and 64 are padded to 128 by
the JAX wrappers) and the JAX gather references; the dense pieces, the
merge and the two dispatchers against their JAX counterparts. Tolerance
1e-5 absolute and relative: both sides compute in fp32 and differ only in
the order of the sums (the Pallas kernels rescale page by page, the twins
take one pass). Empty rows must give the partial (0, NEG_INF, 0) exactly.

Forwards: ``forward_hidden_paged`` and ``forward_hidden_paged_prefill``
against JAX at 1e-4 (two fp32 layers over activations of order 1-10):
hidden states, tail buffers and every pool slot, the slots no valid chunk
token names bit for bit.

Engines: token ids identical at temperature 0 over a fresh and a resumed
round for each tier and each pool-exhaustion case, then equal session
contents and free-page counts; the port raises nowhere the JAX engine
falls back to gather.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.models import transformer as jtr
from quoracle_tpu.ops import paged_attention as jpa
from quoracle_tpu.utils import calibration as jcal
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.models import transformer as ttr
from quoracle_tpu_torch.ops import paged_attention as tpa
from quoracle_tpu_torch.utils import calibration as tcal

# tier-1 runs several xdist workers on a few cores: torch's own thread
# pool would oversubscribe them and spin between the small ops here
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
OFF = 1 << 30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, ref, tol=TOL):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)


def _pools(rng, n_pages, page, KV, hd):
    return (rng.standard_normal((n_pages, page, KV, hd)).astype(np.float32),
            rng.standard_normal((n_pages, page, KV, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# The split kernels' twins
# ---------------------------------------------------------------------------

DECODE_CASES = {
    # GQA 8:2, offsets, a row reading a full table
    "gqa": dict(H=8, KV=2, hd=32, kv_lens=[40, 17, 64], kv_off=[0, 16, 0],
                window=None),
    # window edges across pages; q_pos ahead of the pool (a tail exists)
    "window": dict(H=8, KV=2, hd=32, kv_lens=[40, 17, 64],
                   kv_off=[0, 16, 0], window=24),
    # an empty row (kv_len 0) and MHA
    "empty_row": dict(H=4, KV=4, hd=32, kv_lens=[0, 33, 5], kv_off=[0, 0, 9],
                      window=None),
    # hd 64: the JAX wrapper pads q and pools to 128 lanes
    "hd64": dict(H=4, KV=2, hd=64, kv_lens=[12, 0, 50], kv_off=[3, 0, 0],
                 window=16),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_paged_attend_twin_matches_jax(name):
    c = DECODE_CASES[name]
    rng = np.random.default_rng(11)
    B, page, n_pages, maxp = 3, 16, 16, 4
    q = rng.standard_normal((B, c["H"], c["hd"])).astype(np.float32)
    kp, vp = _pools(rng, n_pages, page, c["KV"], c["hd"])
    tables = rng.permutation(np.arange(1, n_pages))[:B * maxp].reshape(
        B, maxp).astype(np.int32)
    kv_lens = np.asarray(c["kv_lens"], np.int32)
    kv_off = np.asarray(c["kv_off"], np.int32)
    q_pos = (kv_off + kv_lens + np.array([3, 0, 1])).astype(np.int32)
    args = (q, kp, vp, tables, kv_lens, kv_off, q_pos)
    w = c["window"]
    got = tpa.paged_attend_ref(*[_t(a) for a in args], w)
    jref = jpa.paged_attend_ref(*[jnp.asarray(a) for a in args], w)
    jkrn = jpa.paged_attend(*[jnp.asarray(a) for a in args], w,
                            interpret=True)
    _close(got, jref)
    _close(got, jkrn)
    # the wrapper routes CPU tensors to the twin
    _close(tpa.paged_attend(*[_t(a) for a in args], w), [g for g in got],
           dict(rtol=0, atol=0))
    for i in np.nonzero(kv_lens == 0)[0]:
        acc, m, l = (x[i].numpy() for x in got)
        assert np.all(acc == 0) and np.all(m == -1e30) and np.all(l == 0)
        assert np.all(np.asarray(jkrn[1])[i] == -1e30)


PREFILL_CASES = {
    # ragged prefixes incl. zero, T not a multiple of the JAX block (8)
    "gqa": dict(T=21, H=8, KV=2, hd=32, prefix=[40, 0, 61], window=None),
    "window": dict(T=24, H=8, KV=2, hd=32, prefix=[40, 0, 61], window=24),
    # hd 64 (padded to 128 by the JAX wrapper), MHA, a small window
    "hd64": dict(T=10, H=4, KV=4, hd=64, prefix=[3, 17, 0], window=5),
}


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_paged_prefill_attend_twin_matches_jax(name):
    c = PREFILL_CASES[name]
    rng = np.random.default_rng(12)
    B, page, n_pages, maxp = 3, 16, 12, 4
    q = rng.standard_normal((B, c["T"], c["H"], c["hd"])).astype(np.float32)
    kp, vp = _pools(rng, n_pages, page, c["KV"], c["hd"])
    tables = rng.integers(0, n_pages, (B, maxp)).astype(np.int32)
    prefix = np.asarray(c["prefix"], np.int32)
    args = (q, kp, vp, tables, prefix)
    w = c["window"]
    got = tpa.paged_prefill_attend_ref(*[_t(a) for a in args], w)
    jref = jpa.paged_prefill_attend_ref(*[jnp.asarray(a) for a in args], w)
    jkrn = jpa.paged_prefill_attend(*[jnp.asarray(a) for a in args], w,
                                    interpret=True, t_blk=8)
    _close(got, jref)
    _close(got, jkrn)
    for i in np.nonzero(prefix == 0)[0]:
        acc, m, l = (x[i].numpy() for x in got)
        assert np.all(acc == 0) and np.all(m == -1e30) and np.all(l == 0)


# ---------------------------------------------------------------------------
# Dense pieces, merge, dispatchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 5])
def test_dense_pieces_merge_and_dispatchers_match_jax(window):
    rng = np.random.default_rng(13)
    B, T, H, KV, hd, page, n_pages, maxp, tmax = 3, 12, 8, 2, 32, 16, 16, 4, 6
    kp, vp = _pools(rng, n_pages, page, KV, hd)
    tables = rng.permutation(np.arange(1, n_pages))[:B * maxp].reshape(
        B, maxp).astype(np.int32)
    # decode: pool piece + tail piece, per-row and scalar tail lengths
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    tk = rng.standard_normal((B, tmax, KV, hd)).astype(np.float32)
    tv = rng.standard_normal((B, tmax, KV, hd)).astype(np.float32)
    pool_lens = np.array([30, 0, 7], np.int32)
    kv_off = np.array([0, 5, 2], np.int32)
    tail_len = np.array([3, 1, 6], np.int32)
    q_pos = (kv_off + pool_lens + tail_len - 1).astype(np.int32)
    tail_pos0 = (kv_off + pool_lens).astype(np.int32)
    for tl in (tail_len, 4):
        ja = [jnp.asarray(a) for a in (q[:, 0], tk, tv)]
        got = tpa.tail_attend_partials(
            _t(q[:, 0]), _t(tk), _t(tv),
            _t(tl) if isinstance(tl, np.ndarray) else tl, _t(tail_pos0),
            _t(q_pos), window)
        ref = jpa.tail_attend_partials(
            *ja, jnp.asarray(tl), jnp.asarray(tail_pos0),
            jnp.asarray(q_pos), window)
        _close(got, ref)
    dec = (q, kp, vp, tables, pool_lens, kv_off, tk, tv)
    got = tpa.paged_decode_attend(*[_t(a) for a in dec], _t(tail_len),
                                  _t(q_pos), window)
    ref = jpa.paged_decode_attend(*[jnp.asarray(a) for a in dec],
                                  jnp.asarray(tail_len), jnp.asarray(q_pos),
                                  window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # prefill: pool-prefix piece + intra-chunk piece
    qc = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    ck = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    cv = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    chunk_lens = np.array([T, 5, 1], np.int32)
    got = tpa.chunk_attend_partials(_t(qc), _t(ck), _t(cv), _t(chunk_lens),
                                    window)
    ref = jpa.chunk_attend_partials(jnp.asarray(qc), jnp.asarray(ck),
                                    jnp.asarray(cv), jnp.asarray(chunk_lens),
                                    window)
    _close(got, ref)
    pre = (qc, ck, cv, kp, vp, tables, pool_lens, chunk_lens)
    got = tpa.paged_prefill_merge(*[_t(a) for a in pre], window)
    ref = jpa.paged_prefill_merge(*[jnp.asarray(a) for a in pre], window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # merge with an empty partial is exact: it returns the other side
    a = rng.standard_normal((B, H, hd)).astype(np.float32)
    m = rng.standard_normal((B, H)).astype(np.float32)
    l = (1.0 + rng.random((B, H))).astype(np.float32)
    empty = (np.zeros_like(a), np.full_like(m, -1e30), np.zeros_like(l))
    for p1, p2 in (((a, m, l), empty), (empty, (a, m, l)),
                   ((a, m, l), (a[::-1].copy(), m * 2, l + 1))):
        got = tpa.merge_partials(tuple(_t(x) for x in p1),
                                 tuple(_t(x) for x in p2))
        ref = jpa.merge_partials(tuple(jnp.asarray(x) for x in p1),
                                 tuple(jnp.asarray(x) for x in p2))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    got = tpa.merge_partials(tuple(_t(x) for x in (a, m, l)),
                             tuple(_t(x) for x in empty))
    assert torch.equal(got, _t(a) / _t(l)[..., None])


@pytest.mark.parametrize("window", [None, 5])
def test_decode_step_is_built_once_and_serves_every_layer(window):
    """The direct decode builds its index tensors once per step
    (``DecodeStep``) and every layer attends through them: bit for bit
    what ``paged_decode_attend`` gives each layer alone. The kernel's meta
    rows are the JAX wrapper's (kv_len, kv_off, q_pos, qlo), qlo = q_pos -
    window or INT32_MIN."""
    rng = np.random.default_rng(14)
    L, B, H, KV, hd, page, n_pages, maxp, tmax = 2, 3, 8, 2, 32, 16, 16, 4, 5
    tables = _t(rng.permutation(np.arange(1, n_pages))[:B * maxp]
                .reshape(B, maxp).astype(np.int32))
    pool_lens = _t(np.array([30, 0, 7], np.int32))
    kv_off = _t(np.array([0, 5, 2], np.int32))
    q_pos = pool_lens + kv_off + 2
    step = tpa.DecodeStep.build(tables, pool_lens, kv_off, 3, q_pos, tmax,
                                window)
    assert step.meta is None                  # CPU rows take the twin
    for _ in range(L):
        kp, vp = (_t(x) for x in _pools(rng, n_pages, page, KV, hd))
        q = _t(rng.standard_normal((B, 1, H, hd)).astype(np.float32))
        tk, tv = (_t(rng.standard_normal((B, tmax, KV, hd))
                     .astype(np.float32)) for _ in range(2))
        assert torch.equal(
            step.attend(q, kp, vp, tk, tv),
            tpa.paged_decode_attend(q, kp, vp, tables, pool_lens, kv_off,
                                    tk, tv, 3, q_pos, window))
    meta = tpa.paged_decode_meta(pool_lens, kv_off, q_pos, window)
    qlo = (q_pos - window if window is not None
           else torch.full_like(q_pos, np.iinfo(np.int32).min))
    assert meta.dtype == torch.int32
    assert torch.equal(meta, torch.stack([pool_lens, kv_off, q_pos, qlo], 1))


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------

def _pool_setup(jcfg, rng, n_pages, page):
    shape = (jcfg.n_layers, n_pages, page, jcfg.n_kv_heads, jcfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("name", ["tiny", "tiny-window", "tiny-gemma"])
def test_forward_hidden_paged_matches_jax(name):
    """Two decode steps of the direct tier over resident pages: hidden
    states and both tail buffers after each, one row done after the first
    step (its q_pos frozen)."""
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=21)
    rng = np.random.default_rng(21)
    page, n_pages, maxp, B, tmax = 8, 16, 4, 3, 4
    kpool, vpool = _pool_setup(jcfg, rng, n_pages, page)
    tables = rng.permutation(np.arange(1, n_pages))[:B * maxp].reshape(
        B, maxp).astype(np.int32)
    pool_lens = np.array([20, 9, 31], np.int32)
    kv_off = np.array([0, 4, 0], np.int32)
    L, KV, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    jtk = jnp.zeros((L, B, tmax, KV, hd), jnp.float32)
    jtv = jnp.zeros_like(jtk)
    ttk = torch.zeros((L, B, tmax, KV, hd))
    ttv = torch.zeros_like(ttk)
    lens = pool_lens.copy()
    for step in range(2):
        toks = rng.integers(3, jcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = (lens + kv_off)[:, None].astype(np.int32)
        jh, jtk, jtv = jtr.forward_hidden_paged(
            params, jcfg, jnp.asarray(toks), jnp.asarray(pos),
            jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(tables),
            jnp.asarray(pool_lens), jnp.asarray(kv_off), jtk, jtv,
            jnp.asarray(step, jnp.int32))
        th, ttk2, ttv2 = ttr.forward_hidden_paged(
            model, tcfg, _t(toks), _t(pos), _t(kpool), _t(vpool),
            _t(tables), _t(pool_lens), _t(kv_off), ttk, ttv, step)
        assert ttk2 is ttk and ttv2 is ttv          # written in place
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FWD_TOL)
        np.testing.assert_allclose(ttk.numpy(), np.asarray(jtk), **FWD_TOL)
        np.testing.assert_allclose(ttv.numpy(), np.asarray(jtv), **FWD_TOL)
        lens = lens + np.array([1, 0, 1], np.int32)  # row 1 is done


@pytest.mark.parametrize("name", ["tiny", "tiny-window", "tiny-qwen"])
def test_forward_hidden_paged_prefill_matches_jax(name):
    """A suffix chunk of the direct tier over resident prefixes (one row
    fresh, one past a page edge), its KV copied to dst pages; padding and
    overflow positions carry the out-of-range slot and must drop."""
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=22)
    rng = np.random.default_rng(22)
    page, n_pages, maxp, B, T = 8, 24, 4, 3, 10
    n_tok = n_pages * page
    kpool, vpool = _pool_setup(jcfg, rng, n_pages, page)
    perm = rng.permutation(np.arange(1, n_pages))
    src = perm[:B * maxp].reshape(B, maxp).astype(np.int32)
    dst = src.copy()
    dst[:, 2:] = perm[B * maxp:B * maxp + 2 * B].reshape(B, 2)
    prefix = np.array([13, 0, 23], np.int32)
    chunk = np.array([10, 6, 9], np.int32)    # row 2 overflows the table
    kv_off = np.array([0, 0, 5], np.int32)
    toks = rng.integers(3, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = ((prefix + kv_off)[:, None] + np.arange(T)[None]).astype(np.int32)
    flat = np.full((B, T), n_tok, np.int32)
    for i in range(B):
        n = min(int(chunk[i]), maxp * page - int(prefix[i]))
        p = prefix[i] + np.arange(n)
        flat[i, :n] = dst[i, p // page] * page + p % page
    jh, jk, jv = jtr.forward_hidden_paged_prefill(
        params, jcfg, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(src),
        jnp.asarray(prefix), jnp.asarray(chunk), jnp.asarray(flat))
    tk, tv = _t(kpool).clone(), _t(vpool).clone()
    th, tk2, tv2 = ttr.forward_hidden_paged_prefill(
        model, tcfg, _t(toks), _t(pos), tk, tv, _t(src), _t(prefix),
        _t(chunk), _t(flat))
    assert tk2 is tk and tv2 is tv
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FWD_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **FWD_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **FWD_TOL)
    written = np.zeros((n_tok,), bool)
    written[flat[flat < n_tok]] = True
    untouched = ~written.reshape(n_pages, page)
    assert np.array_equal(tk.numpy()[:, untouched], kpool[:, untouched])
    assert np.array_equal(tv.numpy()[:, untouched], vpool[:, untouched])


# ---------------------------------------------------------------------------
# Engines: every tier and both pool-exhaustion cases
# ---------------------------------------------------------------------------

KW = dict(max_seq=256, prompt_buckets=(32, 64, 128))
# fp32 tiny: 2 layers x 2 kv heads x 16 dims x 4 bytes x (K, V) per token;
# 256 tokens = 2 usable pages of 128
SMALL_POOL = 256 * 2 * 2 * 2 * 16 * 4


def _engine_pair(session_max_bytes=2 << 30, **attrs):
    jcfg, tcfg = both_configs("tiny")
    params, model = shared_params("tiny", seed=7)
    je = jgen.GenerateEngine(jcfg, params, jtok.get_tokenizer("xla:tiny"),
                             session_max_bytes=session_max_bytes, **KW)
    je.prefix_sharing = False           # the port has no radix cache yet
    te = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer("xla:tiny"),
                             session_max_bytes=session_max_bytes,
                             device="cpu", **KW)
    for eng in (je, te):
        for k, v in attrs.items():
            setattr(eng, k, v)
    assert te.sessions.n_pages == je.sessions.n_pages
    return je, te


def _spy(te, monkeypatch):
    """Count the port's paged steps, to show which tier ran."""
    calls = {}
    for name in ("step_paged_prefill", "step_paged_decode",
                 "step_paged_prefill_direct", "step_paged_decode_direct",
                 "step_scatter_prompt", "step_scatter_tail", "_run_unified"):
        orig = getattr(te, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **kw)
        monkeypatch.setattr(te, name, wrapped)
    return calls


def _enc(tok, text):
    return tok.encode_chat([{"role": "user", "content": text}])


def _both(je, te, prompts, sids, max_new=16):
    kw = dict(temperature=0.0, max_new_tokens=max_new, session_ids=sids)
    jres, tres = je.generate(prompts, **kw), te.generate(prompts, **kw)
    assert [r.token_ids for r in tres] == [r.token_ids for r in jres]
    assert [r.finish_reason for r in tres] == [r.finish_reason
                                               for r in jres]
    assert [r.n_cached_tokens for r in tres] == [r.n_cached_tokens
                                                 for r in jres]
    for sid in {s for s in sids if s}:
        assert te.session_tokens(sid) == je.session_tokens(sid)
    assert te.sessions.free_pages() == je.sessions.free_pages()
    return tres


def _resume(tok, prompts, res, text="refine it"):
    extra = tok.encode(f"\n<|user|>\n{text}\n<|assistant|>\n")
    return [p + r.token_ids + extra for p, r in zip(prompts, res)]


TIERS = {
    # gates 0: direct prefill and direct decode (unified stays off)
    "direct": (dict(direct_decode_min_tokens=0, direct_prefill_min_tokens=0),
               {"step_paged_prefill_direct", "step_paged_decode_direct",
                "step_scatter_tail"},
               {"step_paged_prefill", "step_paged_decode"}),
    # padded chunks of 64 exceed the cap: each round gathers its prefill
    # and copies the working cache to pages for the direct decode
    "direct_chunk_cap": (dict(direct_decode_min_tokens=0,
                              direct_prefill_min_tokens=0,
                              direct_prefill_max_chunk=32),
                         {"step_paged_prefill", "step_scatter_prompt",
                          "step_paged_decode_direct"},
                         {"step_paged_prefill_direct",
                          "step_paged_decode"}),
    # the gather-prefill seam: prefill through the working cache, copied
    # to pages, then the direct decode
    "forced_gather_prefill": (dict(direct_decode_min_tokens=0,
                                   direct_prefill_min_tokens=0,
                                   _force_gather_prefill=True),
                              {"step_paged_prefill", "step_scatter_prompt",
                               "step_paged_decode_direct"},
                              {"step_paged_prefill_direct",
                               "step_paged_decode"}),
    # the test seam pins gather even with every other tier enabled
    "forced_gather": (dict(_force_gather_decode=True, unified_min_tokens=0,
                           direct_decode_min_tokens=0),
                      {"step_paged_prefill", "step_paged_decode"},
                      {"step_paged_prefill_direct",
                       "step_paged_decode_direct"}),
}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_engine_tier_rounds_identical(tier, monkeypatch):
    attrs, present, absent = TIERS[tier]
    je, te = _engine_pair(**attrs)
    calls = _spy(te, monkeypatch)
    tok = te.tokenizer
    p1 = [_enc(tok, "pick a plan"), _enc(tok, "y " * 30),
          _enc(tok, "orient first")]
    sids = ["t-a", "t-b", None]
    r1 = _both(je, te, p1, sids)
    r2 = _both(je, te, _resume(tok, p1, r1), sids)
    assert all(r.n_cached_tokens > 0 for r in r2[:2])
    assert present <= set(calls), calls
    assert not (absent | {"_run_unified"}) & set(calls), calls
    for sid in sids[:2]:
        je.drop_session(sid)
        te.drop_session(sid)
    assert te.sessions.free_pages() == je.sessions.free_pages()


def test_engine_resumed_row_store_declined_serves_through_gather(
        monkeypatch):
    """Two usable pages, both held by resident sessions: the resumed row
    needs one page more and none can be evicted (both sessions are in the
    batch), so its store is declined. Unified and direct are enabled but
    need pages for it; the JAX engine answers through gather, and so must
    the port (it used to raise)."""
    je, te = _engine_pair(session_max_bytes=SMALL_POOL, unified_min_tokens=0,
                          direct_decode_min_tokens=0)
    calls = _spy(te, monkeypatch)
    tok = te.tokenizer
    pa, pc = _enc(tok, "x " * 40), _enc(tok, "a short one")
    r1 = _both(je, te, [pa, pc], ["a", "c"])
    assert te.sessions.free_pages() == 0
    assert calls == {"_run_unified": 1}
    pa2, pc2 = _resume(tok, [pa, pc], r1, "and now a longer refinement")
    assert len(pa2) + 16 > te.sessions.page      # row a needs a 2nd page
    stored_a = te.session_tokens("a")
    r2 = _both(je, te, [pa2, pc2], ["a", "c"])
    assert r2[0].n_cached_tokens > 0 and r2[0].n_gen_tokens > 0
    assert te.session_tokens("a") == stored_a    # declined: kept as it was
    assert calls["step_paged_prefill"] == calls["step_paged_decode"] == 1


def test_engine_sessionless_row_without_free_page_serves_through_gather(
        monkeypatch):
    """Resident sessions fill the pool (the steady state of a long agent
    run); a sessioned batch with a sessionless row finds no free page for
    its temporary pages. Temporary pages never evict, so the batch drops
    to gather in both engines."""
    je, te = _engine_pair(session_max_bytes=SMALL_POOL, unified_min_tokens=0,
                          direct_decode_min_tokens=0,
                          direct_prefill_min_tokens=0)
    calls = _spy(te, monkeypatch)
    tok = te.tokenizer
    pa, pc = _enc(tok, "pick a plan"), _enc(tok, "orient first")
    r1 = _both(je, te, [pa, pc], ["a", "c"])
    assert te.sessions.free_pages() == 0
    pc2 = _resume(tok, [pc], r1[1:])[0]
    r2 = _both(je, te, [pc2, _enc(tok, "a sessionless neighbor")],
               ["c", None])
    assert r2[0].n_cached_tokens > 0 and r2[1].n_gen_tokens > 0
    assert calls["step_paged_prefill"] == 1
    assert te.session_tokens("a") == je.session_tokens("a") is not None


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

GATE_FILES = {
    "explicit": dict(decode_min_resident=4096, prefill_min_resident=0,
                     prefill_max_chunk=512, unified_min_resident=64,
                     device_kind="cpu"),
    "unified_null": dict(decode_min_resident=None, prefill_min_resident=7,
                         unified_min_resident=None, device_kind="cpu"),
    "unified_absent": dict(decode_min_resident=0, prefill_min_resident=None,
                           device_kind=""),
    "other_device": dict(decode_min_resident=0, prefill_min_resident=0,
                         unified_min_resident=0,
                         device_kind="TPU imaginary v9"),
}


@pytest.mark.parametrize("case", sorted(GATE_FILES))
def test_gate_resolution_matches_jax_loader(case, tmp_path, monkeypatch):
    path = str(tmp_path / "gates.json")
    tcal.save_paged_gates(path, note="unit test", **GATE_FILES[case])
    got = tcal.load_paged_gates(path, device="cpu")
    want = jcal.load_paged_gates(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tcal.resolve_unified_gate(got, "cpu") == \
        jcal.resolve_unified_gate(want)
    # AUTO is on for a CUDA engine (the card takes the TPU's role)
    cuda_gate = tcal.resolve_unified_gate(got, "cuda")
    assert cuda_gate == (0 if got.unified_min_resident is None
                         else got.unified_min_resident)
    # an engine reads the same file through the environment
    monkeypatch.setenv("QUORACLE_PAGED_CALIB", path)
    _, tcfg = both_configs("tiny")
    _, model = shared_params("tiny")
    eng = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer("xla:tiny"),
                              device="cpu", **KW)
    assert eng.direct_decode_min_tokens == want.decode_min_resident
    assert eng.direct_prefill_min_tokens == want.prefill_min_resident
    assert eng.direct_prefill_max_chunk == want.prefill_max_chunk
    assert eng.unified_min_tokens == jcal.resolve_unified_gate(want)


def test_gates_default_without_a_file(tmp_path, monkeypatch):
    monkeypatch.setenv("QUORACLE_PAGED_CALIB", str(tmp_path / "absent.json"))
    g = tcal.load_paged_gates(device="cpu")
    assert (g.decode_min_resident, g.prefill_min_resident,
            g.unified_min_resident) == (OFF, OFF, None)
    assert "default" in g.source
    assert tcal.resolve_unified_gate(g, "cpu") == OFF
    assert tcal.resolve_unified_gate(g, "cuda") == 0
