"""Forward-pass parity of the PyTorch port (quoracle_tpu_torch/models/
transformer.py) against the JAX package, on the CPU in fp32.

Configs: the catalog's ``tiny`` (GQA 4/2) and ``tiny-gemma`` (MHA, tied
head, plus-one norms, scaled embeddings), and two variants registered by
tests/_torch_parity.py: ``tiny-window`` (sliding window 16) and
``tiny-qwen`` (QKV biases). Weights reach the port through
``params_from_jax``.

Tolerance 1e-4 on logits, hidden states and KV: two layers of fp32
matrix products whose sums run in another order on each side, over
activations of order 1-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.models import transformer as jtr
from quoracle_tpu_torch.models import transformer as ttr
from quoracle_tpu_torch.models.convert import params_from_jax

# tier-1 runs several xdist workers on a few cores: torch's own thread
# pool would oversubscribe them and spin between the small ops here
torch.set_num_threads(1)

CONFIGS = ["tiny", "tiny-gemma", "tiny-window", "tiny-qwen"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize("name", ["tiny", "tiny-gemma", "tiny-qwen"])
def test_params_from_jax_round_trip(name):
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=1)
    tree = jax.device_get(params)
    L = tree["layers"]
    assert torch.equal(model.embed.weight, _t(tree["embed"]))
    assert torch.equal(model.final_norm, _t(tree["final_norm"]))
    for li, layer in enumerate(model.layers):
        for leaf in ("attn_norm", "mlp_norm"):
            assert torch.equal(getattr(layer, leaf), _t(L[leaf][li]))
        for leaf in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            # nn.Linear holds [out, in]; the JAX leaf is [in, out]
            assert torch.equal(getattr(layer, leaf).weight,
                               _t(L[leaf][li].T))
        for leaf, lin in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
            if jcfg.attn_bias:
                assert torch.equal(getattr(layer, lin).bias, _t(L[leaf][li]))
            else:
                assert getattr(layer, lin).bias is None
    if jcfg.tie_embeddings:
        assert model.lm_head is None and "lm_head" not in tree
    else:
        assert torch.equal(model.lm_head.weight, _t(tree["lm_head"].T))
    bf = params_from_jax(tree, tcfg, dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf.layers[0].wq.weight,
                       _t(L["wq"][0].T).to(torch.bfloat16))


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_hidden_and_logits_match(name):
    """A prefill chunk, then a continuation chunk on top of it with a
    nonzero kv position offset: logits at every position and the dense
    cache after each chunk."""
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=2)
    rng = np.random.default_rng(2)
    B, S = 2, 64
    jcache = jtr.init_cache(jcfg, B, S, dtype=jnp.float32)
    tcache = ttr.init_cache(tcfg, B, S, "cpu", dtype=torch.float32)
    lens = np.zeros((B,), np.int32)
    off = np.array([0, 3], np.int32)
    for T, valid in ((24, [24, 17]), (8, [8, 5])):
        toks = rng.integers(3, jcfg.vocab_size, (B, T)).astype(np.int32)
        pos = (lens[:, None] + np.arange(T)[None] + off[:, None]
               ).astype(np.int32)
        kv_lens = (lens + np.asarray(valid)).astype(np.int32)
        jh, jcache = jtr.forward_hidden(
            params, jcfg, jnp.asarray(toks), jnp.asarray(pos), jcache,
            jnp.asarray(lens), jnp.asarray(kv_lens),
            kv_pos_offset=jnp.asarray(off))
        th, tcache = ttr.forward_hidden(
            model, tcfg, _t(toks), _t(pos), tcache, _t(lens), _t(kv_lens),
            kv_pos_offset=_t(off))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        jl = jtr.project_logits(params, jcfg, jh)
        tl = ttr.project_logits(model, tcfg, th)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                                   **TOL)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                                   **TOL)
        lens = kv_lens


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_hidden_ragged_matches_and_drops_oob_slots(name):
    """One mixed unified tick (resumed chunks, a fresh chunk, a decode
    row, padding) over pools that already hold resident KV. Padding
    tokens carry the out-of-range slot n_pages * page: the JAX scatter
    drops them, the port must mask them out, and every other pool slot
    must come out equal."""
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=3)
    rng = np.random.default_rng(3)
    tq, page, n_pages = 8, 8, 24
    n_tok = n_pages * page
    KV, hd = jcfg.n_kv_heads, jcfg.head_dim
    pool_shape = (jcfg.n_layers, n_pages, page, KV, hd)
    kpool = rng.standard_normal(pool_shape).astype(np.float32)
    vpool = rng.standard_normal(pool_shape).astype(np.float32)
    rows = [(5, 3), (0, 10), (20, 1), (9, 12)]     # (prefix, q_len)
    maxp = 4
    perm = rng.permutation(np.arange(1, n_pages))
    nb = sum(-(-q // tq) for _, q in rows) + 1      # + one inert block
    Tp = nb * tq
    tok = np.zeros((Tp,), np.int32)
    pos = np.zeros((Tp,), np.int32)
    dst = np.full((Tp,), n_tok, np.int32)           # sentinel = drop
    btab = np.zeros((nb, maxp), np.int32)
    bmeta = np.zeros((nb, 3), np.int32)
    cur = 0
    for r, (pre, q) in enumerate(rows):
        pages = perm[r * maxp:(r + 1) * maxp]
        p = pre + np.arange(q)
        tok[cur:cur + q] = rng.integers(3, jcfg.vocab_size, q)
        pos[cur:cur + q] = p
        dst[cur:cur + q] = pages[p // page] * page + p % page
        for b in range(-(-q // tq)):
            btab[cur // tq + b] = pages
            bmeta[cur // tq + b] = (pre + q, pre + b * tq,
                                    min(tq, q - b * tq))
        cur += -(-q // tq) * tq
    jh, jk, jv = jtr.forward_hidden_ragged(
        params, jcfg, jnp.asarray(tok)[None], jnp.asarray(pos)[None],
        jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(btab),
        jnp.asarray(bmeta), jnp.asarray(dst), tq=tq)
    tk, tv = _t(kpool).clone(), _t(vpool).clone()
    th, tk2, tv2 = ttr.forward_hidden_ragged(
        model, tcfg, _t(tok)[None], _t(pos)[None], tk, tv, _t(btab),
        _t(bmeta), _t(dst), tq=tq)
    assert tk2 is tk and tv2 is tv           # written in place
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    # slots no valid token names are untouched, bit for bit
    written = np.zeros((n_tok,), bool)
    written[dst[dst < n_tok]] = True
    untouched = ~written.reshape(n_pages, page)
    assert np.array_equal(tk.numpy()[:, untouched], kpool[:, untouched])


@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
def test_project_logits_casts_a_bf16_head_once(name):
    """A bf16 model projects through an fp32 copy of its head made on the
    first call and kept (the JAX package casts on every call, which at
    llama-3-8b moves 2.1 GB per decode step); the product is the fp32 one."""
    _, tcfg = both_configs(name)
    params, _ = shared_params(name, seed=5)
    model = params_from_jax(jax.device_get(params), tcfg,
                            dtype=torch.bfloat16)
    h = torch.randn(3, tcfg.dim, generator=torch.Generator().manual_seed(5))
    first = ttr.project_logits(model, tcfg, h)
    head = model.head_f32()
    assert head.dtype == torch.float32 and head is model.head_f32()
    w = (model.embed.weight if tcfg.tie_embeddings
         else model.lm_head.weight).detach()
    assert torch.equal(head, w.float())
    assert torch.equal(first, ttr.project_logits(model, tcfg, h))
    np.testing.assert_allclose(first.numpy(),
                               (h @ w.float().T).numpy(), **TOL)


@pytest.mark.parametrize("how", ["copy_", "load_state_dict"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
def test_project_logits_follows_an_in_place_head_update(name, how):
    """Writing new weights into a bf16 model's head (untied head, or the
    tied embedding) after a projection makes the next projection use them:
    the kept fp32 copy is rebuilt, never stale."""
    _, tcfg = both_configs(name)
    params, _ = shared_params(name, seed=6)
    model = params_from_jax(jax.device_get(params), tcfg,
                            dtype=torch.bfloat16)
    h = torch.randn(3, tcfg.dim, generator=torch.Generator().manual_seed(6))
    before = ttr.project_logits(model, tcfg, h)
    wname = "embed.weight" if tcfg.tie_embeddings else "lm_head.weight"
    w = model.get_parameter(wname)
    new = torch.randn(w.shape, generator=torch.Generator().manual_seed(7)
                      ).to(torch.bfloat16)
    with torch.no_grad():
        if how == "copy_":
            w.copy_(new)
        else:
            model.load_state_dict({wname: new}, strict=False)
    after = ttr.project_logits(model, tcfg, h)
    assert torch.equal(model.head_f32(), new.float())
    assert not torch.allclose(after, before)
    np.testing.assert_allclose(after.numpy(), (h @ new.float().T).numpy(),
                               **TOL)


@pytest.mark.parametrize("scaling", [None, ("linear", 2.0),
                                     ("llama3", 8.0, 1.0, 4.0, 8192)])
def test_rope_matches_jax(scaling):
    """Half-split rotation with HF-style frequency scaling, at positions
    past the llama3 original window. The inverse frequencies come out
    bit-identical on both sides; the rest differs by ulps."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4, 128)).astype(np.float32)
    pos = np.array([[0, 1, 100, 5000, 8191],
                    [3, 77, 2048, 16000, 131000]], np.int32)
    ref = jtr.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0, scaling)
    got = ttr.rope(_t(x), _t(pos), 500000.0, scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
