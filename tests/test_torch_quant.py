"""Int8 serving of the PyTorch port (models/quant.py, the int8 branch of
``forward_hidden_ragged``, ``ragged_attend(k_scale=, v_scale=)`` and the
quantized engine) against the JAX package, on the CPU.

Tolerances:
  * the quantization rule (``kv_quant``, ``kv_dequant``, ``gather_scales``,
    ``quantize_params``): exact, int8 and fp32 bit for bit — both sides do
    the same fp32 operations (amax, one divide, round half to even, clip);
  * the ragged twin with scales: 1e-5 against JAX ``ragged_attend_ref``
    (fp32 sums in another order) and 2e-5 against the interpret-mode
    Pallas kernel, JAX's own bar (tests/test_quant.py), which scales score
    and probability columns instead of dequantizing the pages first;
  * forwards: 1e-4 (two fp32 layers over activations of order 1-10). The
    int8 pages and scale pools the ragged forward writes must equal JAX's;
    an int8 element may differ only at a rounding tie (one step apart,
    ``x / scale`` within fp32 noise of n + 1/2), and such elements are
    counted and bounded;
  * engines: token ids identical at temperature 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import quant as jq
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.models import transformer as jtr
from quoracle_tpu.ops import paged_attention as jpa
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import quant as tq
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.models import transformer as ttr
from quoracle_tpu_torch.models.convert import params_from_jax
from quoracle_tpu_torch.ops import kernels
from quoracle_tpu_torch.ops import paged_attention as tpa

# tier-1 runs several xdist workers on a few cores: torch's own thread
# pool would oversubscribe them and spin between the small ops here
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
WEIGHTS = ("tiny", "tiny-gemma", "tiny-qwen")   # untied, tied head, biases


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _eq(got: torch.Tensor, ref) -> bool:
    ref = np.asarray(ref)
    return got.numpy().dtype == ref.dtype and np.array_equal(got.numpy(),
                                                            ref)


# ---------------------------------------------------------------------------
# The quantization rule
# ---------------------------------------------------------------------------

def _kv_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((12, 3, 32))).astype(np.float32)
    if name == "zeros":
        x[::3] = 0.0                        # whole (token, head) vectors
        x[1, 2] = 0.0
    elif name == "max_127":
        # every vector's max on +127 or -127, entries on exact steps
        steps = rng.integers(-127, 128, x.shape).astype(np.float32)
        steps[..., 0] = np.where(rng.random(x.shape[:-1]) < 0.5, 127, -127)
        x = steps * np.float32(0.037)
    elif name == "bf16_activations":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


@pytest.mark.parametrize("name", ["random", "zeros", "max_127",
                                  "bf16_activations"])
def test_kv_quant_and_dequant_match_jax_bit_for_bit(name):
    x = _kv_case(name)
    jqv, jsv = jq.kv_quant(jnp.asarray(x))
    q, s = tq.kv_quant(_t(x))
    assert _eq(q, jqv) and _eq(s, jsv)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    nz = np.abs(x).max(axis=-1) > 0
    assert np.all(np.abs(q.numpy()).max(axis=-1)[nz] == 127)
    assert np.all(s.numpy()[~nz] == 1.0) and np.all(q.numpy()[~nz] == 0)
    deq = tq.kv_dequant(q, s)
    assert _eq(deq, jq.kv_dequant(jqv, jsv))
    # requantizing an unchanged page reproduces its bytes
    q2, s2 = tq.kv_quant(deq)
    assert torch.equal(q2, q)
    assert _eq(s2, jq.kv_quant(jq.kv_dequant(jqv, jsv))[1])


def test_gather_scales_and_token_bytes_match_jax():
    rng = np.random.default_rng(2)
    scales = rng.random((9, 2, 16)).astype(np.float32)
    tables = rng.integers(0, 9, (3, 4)).astype(np.int32)
    got = tq.gather_scales(_t(scales), _t(tables))
    assert _eq(got, jq.gather_scales(jnp.asarray(scales),
                                     jnp.asarray(tables)))
    for args in ((32, 8, 128, 1, True), (32, 8, 128, 2, False),
                 (2, 2, 16, 1, True), (2, 2, 16, 4, False)):
        assert tq.kv_token_bytes(*args) == jq.kv_token_bytes(*args)
    # llama-3-8b: 67,584 int8 bytes per token against bf16's 131,072
    assert tq.kv_token_bytes(32, 8, 128, 1, True) == 67_584
    assert tq.kv_token_bytes(32, 8, 128, 2, False) == 131_072


# ---------------------------------------------------------------------------
# Weight quantization and the weights bridge
# ---------------------------------------------------------------------------

def _quantized_pair(name: str, seed: int = 3):
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=seed)
    return (jcfg, tcfg, params, model, jq.quantize_params(params, jcfg),
            tq.quantize_params(model, tcfg))


@pytest.mark.parametrize("name", WEIGHTS)
def test_quantize_params_matches_jax_bit_for_bit(name):
    """Payloads and scales equal JAX's after the [in, out] -> [out, in]
    transpose; norms and biases are shared with the float model, which
    is left as it was."""
    jcfg, tcfg, _, model, jqp, tqp = _quantized_pair(name)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jqp = jax.device_get(jqp)
    assert _eq(tqp.embed.q8, jqp["embed"]["q8"])
    assert _eq(tqp.embed.scale_r, jqp["embed"]["scale_r"])
    for li, layer in enumerate(tqp.layers):
        for key in tq.LAYER_WEIGHT_KEYS:
            leaf, lin = jqp["layers"][key], getattr(layer, key)
            assert tq.is_quantized(lin)
            assert _eq(lin.q8, np.asarray(leaf["q8"][li]).T)
            assert _eq(lin.scale, leaf["scale"][li])
        src = model.layers[li]
        assert layer.attn_norm is src.attn_norm
        assert layer.wq.bias is src.wq.bias
    if tcfg.tie_embeddings:
        assert tqp.lm_head is None and "lm_head" not in jqp
    else:
        assert _eq(tqp.lm_head.q8, np.asarray(jqp["lm_head"]["q8"]).T)
        assert _eq(tqp.lm_head.scale, jqp["lm_head"]["scale"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # dequantization: q8 · scale in fp32, then the cast
    wd = tq.dequant_weight(tqp.layers[0].w_up, torch.float32)
    jwd = jq.dequant_weight(jax.tree.map(
        lambda a: a[0], jqp["layers"]["w_up"]), jnp.float32)
    assert _eq(wd, np.asarray(jwd).T)
    assert tq.params_nbytes(tqp) < 0.4 * tq.params_nbytes(model)


@pytest.mark.parametrize("name", WEIGHTS)
def test_params_from_jax_fills_quantized_modules(name):
    """The JAX quantized tree through the weights bridge equals the
    port's quantization of the converted float tree."""
    _, tcfg, _, _, jqp, tqp = _quantized_pair(name)
    conv = params_from_jax(jax.device_get(jqp), tcfg)
    got, want = conv.state_dict(), tqp.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


# ---------------------------------------------------------------------------
# The int8 ragged twin
# ---------------------------------------------------------------------------

RAGGED_Q8_CASES = {
    # chunk blocks of different lengths, an inert block, a one-token row
    "chunks_tq8": dict(rows=[(40, 1), (17, 11), (0, 19), (5, 0), (63, 1)],
                       tq=8, H=8, KV=2, hd=32, window=None),
    # decode blocks (one query each), an inert slot, a window
    "decode_tq1_window": dict(rows=[(40, 1), (0, 1), (5, 0), (60, 1)],
                              tq=1, H=8, KV=2, hd=32, window=17),
    # hd 64 (the JAX wrapper pads to 128), MHA, a window below a page
    "hd64_window": dict(rows=[(0, 9), (32, 1), (3, 5)], tq=8, H=4, KV=4,
                        hd=64, window=3),
}


def _q8_tick(c, seed=4, page=16, n_pages=40):
    rng = np.random.default_rng(seed)
    rows, tq_ = c["rows"], c["tq"]
    maxp = max(-(-(pre + q) // page) for pre, q in rows if q > 0)
    nb = sum(-(-q // tq_) if q else 1 for _, q in rows)
    q = rng.standard_normal((nb * tq_, c["H"], c["hd"])).astype(np.float32)
    kv = [rng.standard_normal((n_pages, page, c["KV"], c["hd"]))
          .astype(np.float32) for _ in range(2)]
    kv[0][3, :, 0] = 0.0                        # zero vectors: scale 1.0
    pools = []
    for x in kv:
        qv, s = jq.kv_quant(jnp.asarray(x))
        pools += [np.asarray(qv), np.asarray(s).transpose(0, 2, 1).copy()]
    perm = rng.permutation(np.arange(1, n_pages))
    btab = np.zeros((nb, maxp), np.int32)
    bmeta = np.zeros((nb, 3), np.int32)
    blk = 0
    for r, (pre, qlen) in enumerate(rows):
        pages = [perm[(r * maxp + j) % len(perm)] for j in range(maxp)]
        for b in range(-(-qlen // tq_) if qlen else 1):
            btab[blk] = pages
            bmeta[blk] = (pre + qlen, pre + b * tq_,
                          max(0, min(tq_, qlen - b * tq_)))
            blk += 1
    kq, ks, vq, vs = pools
    return q, kq, vq, btab, bmeta, ks, vs


@pytest.mark.parametrize("name", sorted(RAGGED_Q8_CASES))
def test_ragged_twin_with_scales_matches_jax(name):
    c = RAGGED_Q8_CASES[name]
    q, kq, vq, btab, bmeta, ks, vs = _q8_tick(c)
    kw = dict(tq=c["tq"], sliding_window=c["window"])
    ja = [jnp.asarray(a) for a in (q, kq, vq, btab, bmeta)]
    jref = np.asarray(jpa.ragged_attend_ref(
        *ja, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), **kw))
    jkrn = np.asarray(jpa.ragged_attend(
        *ja, interpret=True, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), **kw))
    ta = [_t(a) for a in (q, kq, vq, btab, bmeta)]
    got = tpa.ragged_attend_ref(*ta, k_scale=_t(ks), v_scale=_t(vs), **kw)
    np.testing.assert_allclose(got.numpy(), jref, **TOL)
    np.testing.assert_allclose(got.numpy(), jkrn, **KERNEL_TOL)
    # the twin is the float twin over the dequantized pages, exactly
    deq = [(x.float() * _t(s).transpose(1, 2)[..., None])
           for x, s in ((ta[1], ks), (ta[2], vs))]
    assert torch.equal(got, tpa.ragged_attend_ref(ta[0], *deq, *ta[3:], **kw))
    # CPU tensors take the twin through both entry points, no launch
    kernels.reset_launch_counts()
    for fn in (tpa.ragged_attend, tpa.ragged_attend_auto):
        assert torch.equal(fn(*ta, k_scale=_t(ks), v_scale=_t(vs), **kw),
                           got)
    assert kernels.launch_counts()["ragged_q8_fwd"] == 0
    for i, (_, _, nq) in enumerate(bmeta):       # inert slots are zeros
        assert np.all(got.numpy()[i * c["tq"] + nq:(i + 1) * c["tq"]] == 0)


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------

def _ragged_tick(rng, jcfg, page, n_pages, rows, tq_, maxp=4):
    n_tok = n_pages * page
    perm = rng.permutation(np.arange(1, n_pages))
    nb = sum(-(-q // tq_) for _, q in rows) + 1      # + one inert block
    Tp = nb * tq_
    tok = np.zeros((Tp,), np.int32)
    pos = np.zeros((Tp,), np.int32)
    dst = np.full((Tp,), n_tok, np.int32)            # sentinel = drop
    btab = np.zeros((nb, maxp), np.int32)
    bmeta = np.zeros((nb, 3), np.int32)
    cur = 0
    for r, (pre, q) in enumerate(rows):
        pages = perm[r * maxp:(r + 1) * maxp]
        p = pre + np.arange(q)
        tok[cur:cur + q] = rng.integers(3, jcfg.vocab_size, q)
        pos[cur:cur + q] = p
        dst[cur:cur + q] = pages[p // page] * page + p % page
        for b in range(-(-q // tq_)):
            btab[cur // tq_ + b] = pages
            bmeta[cur // tq_ + b] = (pre + q, pre + b * tq_,
                                     min(tq_, q - b * tq_))
        cur += -(-q // tq_) * tq_
    return tok, pos, dst, btab, bmeta


def _int8_pools(rng, jcfg, n_pages, page):
    """Resident int8 pools and scale pools (quantized from random KV)."""
    shape = (jcfg.n_layers, n_pages, page, jcfg.n_kv_heads, jcfg.head_dim)
    out = []
    for _ in range(2):
        q, s = jq.kv_quant(jnp.asarray(
            rng.standard_normal(shape).astype(np.float32)))
        out += [np.asarray(q), np.asarray(s).transpose(0, 1, 3, 2).copy()]
    return out                                       # kq, ks, vq, vs


@pytest.mark.parametrize("name", ["tiny", "tiny-window", "tiny-qwen"])
def test_forward_hidden_ragged_int8_matches_jax(name, monkeypatch):
    """One mixed unified tick over int8 pools that already hold resident
    KV, with quantized weights: hidden states to 1e-4; the pages and
    scale pools written equal JAX's (a differing int8 element must be a
    rounding tie, and ties are rare); slots no valid token names stay bit
    for bit."""
    jcfg, tcfg, _, _, jqp, tqp = _quantized_pair(name, seed=5)
    rng = np.random.default_rng(5)
    tq_, page, n_pages = 8, 8, 24
    n_tok = n_pages * page
    tok, pos, dst, btab, bmeta = _ragged_tick(
        rng, jcfg, page, n_pages, [(5, 3), (0, 10), (20, 1), (9, 12)], tq_)
    kq, ks, vq, vs = _int8_pools(rng, jcfg, n_pages, page)
    jh, jk, jv, jks, jvs = jtr.forward_hidden_ragged(
        jqp, jcfg, jnp.asarray(tok)[None], jnp.asarray(pos)[None],
        jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(btab),
        jnp.asarray(bmeta), jnp.asarray(dst), tq=tq_,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    # record what each layer quantizes, to judge any differing element
    seen = []
    orig = ttr.kv_quant

    def rec(x):
        seen.append(x.clone())
        return orig(x)
    monkeypatch.setattr(ttr, "kv_quant", rec)
    pools = [_t(a) for a in (kq, vq, ks, vs)]
    out = ttr.forward_hidden_ragged(
        tqp, tcfg, _t(tok)[None], _t(pos)[None], pools[0], pools[1],
        _t(btab), _t(bmeta), _t(dst), tq=tq_, k_scale=pools[2],
        v_scale=pools[3])
    assert all(a is b for a, b in zip(out[1:], pools))   # in place
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jh), **FWD_TOL)
    np.testing.assert_allclose(pools[2].numpy(), np.asarray(jks), **TOL)
    np.testing.assert_allclose(pools[3].numpy(), np.asarray(jvs), **TOL)
    # int8 payloads: equal, or one step apart at a rounding tie
    kept = dst < n_tok
    ties = 0
    for li in range(jcfg.n_layers):
        for which, (got, want) in enumerate(((pools[0], jk), (pools[1], jv))):
            g = got[li].reshape(n_tok, -1, jcfg.head_dim)[dst[kept]]
            w = _t(np.asarray(want[li])).reshape(n_tok, -1,
                                                 jcfg.head_dim)[dst[kept]]
            diff = (g.int() - w.int()).abs()
            assert int(diff.max()) <= 1
            if int(diff.max()) == 1:
                x = seen[2 * li + which]            # [n_kept, KV, hd]
                _, s = orig(x)
                frac = (x / s[..., None]).abs().frac()[diff == 1]
                assert torch.all((frac - 0.5).abs() < 1e-3), frac
                ties += int((diff == 1).sum())
    assert ties <= 2, ties
    written = np.zeros((n_tok,), bool)
    written[dst[kept]] = True
    untouched = ~written.reshape(n_pages, page)
    for got, ref in ((pools[0], kq), (pools[1], vq)):
        assert np.array_equal(got.numpy()[:, untouched], ref[:, untouched])
    for got, ref in ((pools[2], ks), (pools[3], vs)):
        assert np.array_equal(got.numpy().transpose(0, 1, 3, 2)[:, untouched],
                              ref.transpose(0, 1, 3, 2)[:, untouched])


@pytest.mark.parametrize("name", WEIGHTS)
def test_quantized_weight_forwards_match_jax(name):
    """Quantized weights through the dense forward and the head (a tied
    head dequantizes the int8 embedding), then both paged forwards of the
    direct tier over float pools."""
    jcfg, tcfg, _, _, jqp, tqp = _quantized_pair(name, seed=6)
    rng = np.random.default_rng(6)
    B, S, T = 2, 48, 20
    toks = rng.integers(3, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    lens = np.zeros((B,), np.int32)
    kv_lens = np.array([T, 13], np.int32)
    jh, jc = jtr.forward_hidden(
        jqp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
        jtr.init_cache(jcfg, B, S, dtype=jnp.float32), jnp.asarray(lens),
        jnp.asarray(kv_lens))
    th, tc = ttr.forward_hidden(
        tqp, tcfg, _t(toks), _t(pos),
        ttr.init_cache(tcfg, B, S, "cpu", dtype=torch.float32), _t(lens),
        _t(kv_lens))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FWD_TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **FWD_TOL)
    np.testing.assert_allclose(
        ttr.project_logits(tqp, tcfg, th).numpy(),
        np.asarray(jtr.project_logits(jqp, jcfg, jh)), **FWD_TOL)
    # the direct tier's forwards over float pools
    page, n_pages, maxp = 8, 16, 4
    shape = (jcfg.n_layers, n_pages, page, jcfg.n_kv_heads, jcfg.head_dim)
    kpool, vpool = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(2))
    tables = rng.permutation(np.arange(1, n_pages))[:B * maxp].reshape(
        B, maxp).astype(np.int32)
    pool_lens, kv_off = np.array([20, 9], np.int32), np.array([0, 4],
                                                               np.int32)
    step = np.array([[5], [7]], np.int32)
    dpos = (pool_lens + kv_off)[:, None].astype(np.int32)
    tail = (jcfg.n_layers, B, 2, jcfg.n_kv_heads, jcfg.head_dim)
    jd = jtr.forward_hidden_paged(
        jqp, jcfg, jnp.asarray(step), jnp.asarray(dpos), jnp.asarray(kpool),
        jnp.asarray(vpool), jnp.asarray(tables), jnp.asarray(pool_lens),
        jnp.asarray(kv_off), jnp.zeros(tail, jnp.float32),
        jnp.zeros(tail, jnp.float32), jnp.asarray(0, jnp.int32))
    td = ttr.forward_hidden_paged(
        tqp, tcfg, _t(step), _t(dpos), _t(kpool), _t(vpool), _t(tables),
        _t(pool_lens), _t(kv_off), torch.zeros(tail), torch.zeros(tail), 0)
    for g, r in zip(td, jd):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD_TOL)
    n_tok = n_pages * page
    chunk = np.array([6, 3], np.int32)
    flat = np.full((B, 6), n_tok, np.int32)
    for i in range(B):
        p = pool_lens[i] + np.arange(chunk[i])
        flat[i, :chunk[i]] = tables[i, p // page] * page + p % page
    cpos = ((pool_lens + kv_off)[:, None] + np.arange(6)[None]).astype(
        np.int32)
    ctok = toks[:, :6]
    jp = jtr.forward_hidden_paged_prefill(
        jqp, jcfg, jnp.asarray(ctok), jnp.asarray(cpos), jnp.asarray(kpool),
        jnp.asarray(vpool), jnp.asarray(tables), jnp.asarray(pool_lens),
        jnp.asarray(chunk), jnp.asarray(flat))
    tp = ttr.forward_hidden_paged_prefill(
        tqp, tcfg, _t(ctok), _t(cpos), _t(kpool), _t(vpool), _t(tables),
        _t(pool_lens), _t(chunk), _t(flat))
    for g, r in zip(tp, jp):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD_TOL)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

KW = dict(max_seq=256, prompt_buckets=(32, 64, 128))
# int8 tiny: 2 layers x 2 kv heads x (2 x 16 int8 + 8 scale bytes) per
# token; 256 tokens = 2 usable pages of 128
SMALL_POOL = 256 * 2 * 2 * (2 * 16 + 8)
INT8 = dict(quantize_weights=True, quantize_kv=True)


def _engine_pair(session_max_bytes=2 << 30, **attrs):
    jcfg, tcfg = both_configs("tiny")
    params, model = shared_params("tiny", seed=7)
    je = jgen.GenerateEngine(jcfg, params, jtok.get_tokenizer("xla:tiny"),
                             session_max_bytes=session_max_bytes, **INT8,
                             **KW)
    je.prefix_sharing = False           # the port has no radix cache yet
    te = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer("xla:tiny"),
                             session_max_bytes=session_max_bytes,
                             device="cpu", **INT8, **KW)
    for eng in (je, te):
        for k, v in attrs.items():
            setattr(eng, k, v)
    assert te.sessions.n_pages == je.sessions.n_pages
    assert te.sessions.max_tokens == je.sessions.max_tokens
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


def _both(je, te, prompts, sids, max_new=16, **kw):
    kw = dict(temperature=0.0, max_new_tokens=max_new, session_ids=sids,
              **kw)
    jres, tres = je.generate(prompts, **kw), te.generate(prompts, **kw)
    assert [r.token_ids for r in tres] == [r.token_ids for r in jres]
    assert [r.finish_reason for r in tres] == [r.finish_reason
                                               for r in jres]
    assert [r.n_cached_tokens for r in tres] == [r.n_cached_tokens
                                                 for r in jres]
    assert [r.json_state for r in tres] == [r.json_state for r in jres]
    for sid in {s for s in sids if s}:
        assert te.session_tokens(sid) == je.session_tokens(sid)
    assert te.sessions.free_pages() == je.sessions.free_pages()
    return tres


def _resume(tok, prompts, res, text="refine it"):
    extra = tok.encode(f"\n<|user|>\n{text}\n<|assistant|>\n")
    return [p + r.token_ids + extra for p, r in zip(prompts, res)]


def _pools_equal(je, te, max_ties=8):
    """The int8 pages and scale pools of both engines: scales to fp32
    sum-order noise; payloads equal but for a few elements one step
    apart, where activations that differ in their last bits between the
    two packages straddled a rounding tie (the forward test above checks
    that such elements are ties)."""
    st, js = te.sessions, je.sessions
    assert st.k.dtype == torch.int8 and st.k_scale.dtype == torch.float32
    ties = 0
    for got, want in ((st.k, js.k), (st.v, js.v)):
        diff = np.abs(got.numpy().astype(np.int32)
                      - np.asarray(want).astype(np.int32))
        assert diff.max() <= 1
        ties += int((diff == 1).sum())
    assert ties <= max_ties, ties
    np.testing.assert_allclose(st.k_scale.numpy(), np.asarray(js.k_scale),
                               **TOL)
    np.testing.assert_allclose(st.v_scale.numpy(), np.asarray(js.v_scale),
                               **TOL)


TIERS = {
    # the int8 default: every sessioned call on the unified tier
    "unified": (dict(), {"_run_unified"},
                {"step_paged_prefill", "step_paged_decode"}),
    # the JAX engine's seam: dequantize on the gather, requantize on the
    # scatter
    "forced_gather": (dict(_force_gather_decode=True),
                      {"step_paged_prefill", "step_paged_decode",
                       "step_scatter_prompt"}, {"_run_unified"}),
}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_int8_engine_rounds_identical(tier, monkeypatch):
    """Sessioned round 1, a JSON-constrained sessioned row beside a
    sessionless one, and the resumed round: identical ids, grammar
    states, cached counts, session contents and int8 pools."""
    attrs, present, absent = TIERS[tier]
    je, te = _engine_pair(**attrs)
    assert te.unified_min_tokens == je.unified_min_tokens == 0
    assert te.pool_dtype == torch.int8
    calls = _spy(te, monkeypatch)
    tok = te.tokenizer
    p1 = [_enc(tok, "pick a plan"), _enc(tok, "y " * 30),
          _enc(tok, "orient first")]
    sids = ["q-a", "q-b", None]
    r1 = _both(je, te, p1, sids, constrain_json=[True, False, True])
    assert r1[0].text.lstrip().startswith("{")
    _pools_equal(je, te)
    r2 = _both(je, te, _resume(tok, p1, r1), sids)
    assert all(r.n_cached_tokens > 0 for r in r2[:2])
    _pools_equal(je, te)
    assert present <= set(calls), calls
    assert not (absent | {"step_paged_prefill_direct",
                          "step_paged_decode_direct"}) & set(calls), calls
    for sid in sids[:2]:
        je.drop_session(sid)
        te.drop_session(sid)
    assert te.sessions.free_pages() == je.sessions.free_pages()


def test_int8_engine_pool_exhausted_serves_through_gather(monkeypatch):
    """Two usable int8 pages held by resident sessions; the resumed row
    needs a third and nothing can be evicted, so both engines serve the
    batch through the gather tier, dequantizing and requantizing, and
    keep the declined session as it was."""
    je, te = _engine_pair(session_max_bytes=SMALL_POOL)
    assert te.sessions.max_tokens == je.sessions.max_tokens == 256
    calls = _spy(te, monkeypatch)
    tok = te.tokenizer
    pa, pc = _enc(tok, "x " * 40), _enc(tok, "a short one")
    r1 = _both(je, te, [pa, pc], ["a", "c"])
    assert te.sessions.free_pages() == 0
    assert calls == {"_run_unified": 1}
    pa2, pc2 = _resume(tok, [pa, pc], r1, "and now a longer refinement")
    stored_a = te.session_tokens("a")
    r2 = _both(je, te, [pa2, pc2], ["a", "c"])
    assert r2[0].n_cached_tokens > 0 and r2[0].n_gen_tokens > 0
    assert te.session_tokens("a") == stored_a
    assert calls["step_paged_prefill"] == calls["step_paged_decode"] == 1
    _pools_equal(je, te)


def test_int8_engine_ignores_direct_gates(monkeypatch):
    """Direct gates at 0 turn the direct tier on for a float pool; an
    int8 pool has no scale stream there, so the engine stays on the
    unified tier (the JAX engine's rule)."""
    _, tcfg = both_configs("tiny")
    _, model = shared_params("tiny", seed=7)
    te = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer("xla:tiny"),
                             device="cpu", **INT8, **KW)
    te.direct_decode_min_tokens = te.direct_prefill_min_tokens = 0
    calls = _spy(te, monkeypatch)
    tok = te.tokenizer
    res = te.generate([_enc(tok, "pick a plan"), _enc(tok, "a second")],
                      temperature=0.0, max_new_tokens=8,
                      session_ids=["d-a", None])
    assert all(r.n_gen_tokens > 0 for r in res)
    assert calls == {"_run_unified": 1}, calls
    # a float pool with the same gates takes the direct tier
    tf = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer("xla:tiny"),
                             device="cpu", **KW)
    tf.direct_decode_min_tokens = tf.direct_prefill_min_tokens = 0
    calls = _spy(tf, monkeypatch)
    tf.generate([_enc(tok, "pick a plan")], temperature=0.0,
                max_new_tokens=8, session_ids=["d-a"])
    assert "step_paged_decode_direct" in calls, calls


def test_int8_session_budget_holds_more_tokens():
    """The byte budget buys tokens at the int8 rate (scales included):
    the same count as the JAX engine, ~1.9x the float pool's at hd 16
    where scales weigh more than at hd 128."""
    budget = 300 * 1024
    jcfg, tcfg = both_configs("tiny")
    params, model = shared_params("tiny")
    got = {}
    for quant in (False, True):
        te = tgen.GenerateEngine(
            tcfg, model, ttok.get_tokenizer("xla:tiny"), device="cpu",
            session_max_bytes=budget, quantize_kv=quant, **KW)
        je = jgen.GenerateEngine(
            jcfg, params, jtok.get_tokenizer("xla:tiny"),
            session_max_bytes=budget, quantize_kv=quant, **KW)
        assert te.sessions.max_tokens == je.sessions.max_tokens
        got[quant] = te.sessions.max_tokens
    # fp32 tiny: 256 bytes per token; int8: 64 + 16 scale bytes
    assert got[True] > 2 * got[False]


def test_torch_backend_serves_int8_on_the_cpu():
    """TorchBackend(device="cpu", quantize_weights=True, quantize_kv=True)
    answers a sessioned constrained round and resumes it; its engine holds
    int8 weights and pools and launched no kernel."""
    kernels.reset_launch_counts()
    b = trt.TorchBackend(["xla:tiny"], device="cpu", **INT8)
    eng = b.engines["xla:tiny"]
    assert eng.quantize_weights and eng.quantize_kv
    assert tq.is_quantized(eng.params.layers[0].wq)
    msgs = [{"role": "system", "content": "you are an agent"},
            {"role": "user", "content": "pick the next action"}]

    def round_(hist):
        return b.query([trt.QueryRequest(
            "xla:tiny", h, temperature=0.0, max_tokens=12,
            session_id=f"cpu-{i}", constrain_json=True)
            for i, h in enumerate(hist)])
    hist = [list(msgs), list(msgs)]
    r1 = round_(hist)
    assert all(r.ok and r.usage.completion_tokens > 0 for r in r1)
    hist = [h + [{"role": "assistant", "content": r.text},
                 {"role": "user", "content": "refine"}]
            for h, r in zip(hist, r1)]
    r2 = round_(hist)
    assert all(r.ok and r.cached_tokens > 0 for r in r2)
    assert eng.sessions.k.dtype == torch.int8
    assert sum(kernels.launch_counts().values()) == 0


def test_quantized_weights_are_buffers_and_floats_pass_through():
    """Quantized weights are buffers (not trainable parameters) that move
    with the module, and ``dequant_weight`` passes float weights
    through."""
    _, tcfg = both_configs("tiny")
    _, model = shared_params("tiny")
    qm = tq.quantize_params(model, tcfg)
    names = {n for n, _ in qm.named_buffers()}
    assert "layers.0.wq.q8" in names and "embed.scale_r" in names
    assert not any(p.dtype == torch.int8 for p in qm.parameters())
    lin = model.layers[0].wq
    assert tq.dequant_weight(lin) is lin.weight
