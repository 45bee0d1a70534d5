"""The port's embedder layer against the JAX package's, on the CPU.

``text_key`` and ``TTLCache`` (utils/cache.py) behave identically under
one injected clock; ``HashingEmbedder`` and ``cosine_similarity`` are
bit-exact. The port's ``EmbeddingEncoder`` over the converted fp32
weights of ``tiny`` and ``tiny-gemma`` (tests/_torch_parity.py) returns
the JAX encoder's unit vectors within 1e-5 abs: the same padded shapes
(batch buckets, pow2 T, padded rows of length 1) go through both models,
and the mean pooling and the chunk averaging run in fp32 on both sides,
so only the sum order of the fp32 model differs. The JAX encoder's
working cache is always bf16, which fp32 weights cannot write into; the
port's takes the weights' dtype, and these tests give the JAX encoder the
same fp32 cache through its module's ``init_cache`` (``fp32_cache``).
``TorchBackend.embed`` is that encoder over the backend's first member.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.models import embeddings as jemb
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.models import transformer as jtr
from quoracle_tpu.utils import cache as jcache
from quoracle_tpu_torch.models import embeddings as temb
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.utils import cache as tcache

torch.set_num_threads(1)

ATOL = 1e-5
SHORT = "wait for the child agents to report back"
FIVE = ["a", "plan the next step", "x " * 30, "ünïcödé text",
        "send_message to parent: done"]
# several 256-token chunks on the tiny byte-level vocabulary
LONG = " ".join(f"rule {i}: keep step {i} short and cite file_{i}.py"
                for i in range(40))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_text_key_matches_jax():
    for text in ("", "hello", "ünïcödé", "a\x00b", LONG):
        for ns in ("", "tiny", "llama-3-8b"):
            assert tcache.text_key(text, namespace=ns) == \
                jcache.text_key(text, namespace=ns)


def test_ttl_cache_matches_jax_under_one_clock():
    """The same operations, at the same clock readings, on both caches:
    LRU eviction at the cap, expiry past the TTL, hit and miss counts."""
    clocks = FakeClock(), FakeClock()
    caches = (jcache.TTLCache(max_entries=3, ttl_s=10.0, clock=clocks[0]),
              tcache.TTLCache(max_entries=3, ttl_s=10.0, clock=clocks[1]))
    ops = [("put", "a", 1, 0.0), ("put", "b", 2, 1.0), ("get", "a", None, 2.0),
           ("put", "c", 3, 3.0), ("put", "d", 4, 4.0), ("get", "b", None, 5.0),
           ("get", "a", None, 5.0), ("get", "c", None, 13.5),
           ("get", "d", None, 14.5), ("put", "e", 5, 20.0),
           ("get", "e", None, 30.0), ("get", "e", None, 30.5),
           ("get", "zz", None, 31.0)]
    for op, key, value, t in ops:
        seen = []
        for clock, cache in zip(clocks, caches):
            clock.t = t
            if op == "put":
                cache.put(key, value)
            else:
                seen.append(cache.get(key))
            seen.append((len(cache), cache.hits, cache.misses))
        assert seen[:len(seen) // 2] == seen[len(seen) // 2:], (op, key, t)
    assert caches[1].hits == 3 and caches[1].misses == 5
    # the port's defaults are the JAX package's
    d = tcache.TTLCache()
    assert (d.max_entries, d.ttl_s) == (1000, 3600.0)


@pytest.mark.parametrize("dim", [16, 64, 384])
def test_hashing_embedder_bit_exact(dim):
    texts = ["", "wait", SHORT, LONG, "ünïcödé", "x" * 500]
    got = temb.HashingEmbedder(dim).embed(texts)
    ref = jemb.HashingEmbedder(dim).embed(texts)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    for a, b in ((got[1], got[2]), (got[2], got[3]), (got[0], got[1])):
        assert temb.cosine_similarity(a, b) == jemb.cosine_similarity(a, b)


@pytest.fixture
def fp32_cache(monkeypatch):
    """The JAX encoder's working cache in the fp32 weights' dtype."""
    monkeypatch.setattr(jemb, "init_cache", functools.partial(
        jtr.init_cache, dtype=jnp.float32))


def test_jax_encoder_cannot_write_fp32_kv_into_its_bf16_cache():
    """Why the port's cache follows the weights' dtype: the JAX encoder
    over fp32 weights fails at the first K/V write."""
    je, te = _encoders("tiny")
    with pytest.raises(TypeError, match="same dtypes"):
        je.embed([SHORT])
    assert te.embed([SHORT])[0].shape == (te.dim,)


def _encoders(name):
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=3)
    spec = f"xla:{name}"
    je = jemb.EmbeddingEncoder(jcfg, params, jtok.get_tokenizer(spec))
    te = temb.EmbeddingEncoder(tcfg, model, ttok.get_tokenizer(spec))
    return je, te


@pytest.fixture(scope="module", params=["tiny", "tiny-gemma"])
def encoders(request):
    return _encoders(request.param)


def _same(jvecs, tvecs):
    assert len(jvecs) == len(tvecs)
    for j, t in zip(jvecs, tvecs):
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype == np.float32
        assert abs(float(np.linalg.norm(t)) - 1.0) < 1e-5
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("texts", [[SHORT], FIVE, [LONG, SHORT], [""]],
                         ids=["one_short", "five_padded_to_16", "chunked",
                              "empty"])
def test_encoder_matches_jax(encoders, texts, fp32_cache):
    je, te = encoders
    if texts == [LONG, SHORT]:
        n = len(te.tokenizer.encode(LONG))
        assert n > 2 * te.chunk_tokens, n           # three chunks or more
    _same(je.embed(texts), te.embed(texts))


def test_encoder_shapes_match_jax(encoders):
    """Both encoders pad a batch to the same shape before the model."""
    je, te = encoders
    seen = []
    orig = te._encode

    def spy(tokens, lens):
        seen.append((tuple(tokens.shape), lens.tolist()))
        return orig(tokens, lens)

    te._encode = spy
    try:
        te._encode_token_batch([[5, 6, 7], [8], [9] * 20, [1, 2], [3]])
    finally:
        te._encode = orig
    assert seen == [((16, 32), [3, 1, 20, 2, 1] + [1] * 11)]


def test_encoder_cache_hits_match_jax(encoders, fp32_cache):
    je, te = encoders
    je.cache, te.cache = jcache.TTLCache(), tcache.TTLCache()
    for enc in (je, te):
        enc.embed([SHORT, "first"])
        enc.embed([SHORT, "second", "first"])
    assert (te.cache.hits, te.cache.misses, len(te.cache)) == \
        (je.cache.hits, je.cache.misses, len(je.cache)) == (2, 3, 3)
    # a hit returns the stored vector itself
    assert te.embed([SHORT])[0] is te.cache.get(
        tcache.text_key(SHORT, namespace=te.cfg.name))


def test_backend_embed_shares_the_first_members_weights(fp32_cache):
    """TorchBackend.embed: an encoder over pool[0]'s engine params (no
    second copy), or over ``embed_model``'s own random weights, or the
    injected ``embedder``."""
    _, tcfg = both_configs("tiny")
    _, model = shared_params("tiny", seed=3)
    eng = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer("xla:tiny"),
                              device="cpu")
    b = trt.TorchBackend(["xla:tiny"], device="cpu",
                         engines={"xla:tiny": eng})
    assert isinstance(b, trt.ModelBackend)
    assert b.embedder.params is eng.params
    je, _ = _encoders("tiny")
    _same(je.embed([SHORT, LONG]), b.embed([SHORT, LONG]))
    other = trt.TorchBackend(["xla:tiny"], device="cpu",
                             engines={"xla:tiny": eng},
                             embed_model="xla:tiny-gemma")
    assert other.embedder.cfg.name == "tiny-gemma"
    assert other.embedder.params is not eng.params
    fake = temb.HashingEmbedder()
    injected = trt.TorchBackend(["xla:tiny"], device="cpu",
                                engines={"xla:tiny": eng}, embedder=fake)
    assert injected.embedder is fake
