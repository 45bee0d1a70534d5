"""The port's batch-1 speculative decoder (models/speculative.py
``SpeculativeDecoder``) and the baton-mode backend's ``draft_map`` path
against the JAX package's, on the CPU.

Both packages get the same fp32 weights and the same byte tokenizer (the
JAX file's models: a 3-layer target and a 2-layer draft of one vocab).
Greedy output must equal vanilla ``GenerateEngine`` decode in each package
and the JAX decoder's tokens, finish reasons and counters: every accepted
draft equals the target's argmax and every correction IS the argmax, so a
divergence is a cache or rollback fault, not sampling noise. Sampled
rows draw from a ``torch.Generator`` in the port and from ``jax.random``
in the JAX package, so they are held to mechanics only. The backend tests
serve the catalog's ``tiny`` with a ``tiny-gemma`` draft (both vocab 512)
over shared weights (tests/_torch_parity.py).
"""

import random
import threading
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.models import config as jconfig
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import speculative as jspec
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.models.transformer import init_params as jax_init_params
from quoracle_tpu_torch.models import config as tconfig
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import speculative as tspec
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

JAX = types.SimpleNamespace(name="jax", gen=jgen, spec=jspec, rt=jrt,
                            cfg=jconfig, tok=jtok)
PORT = types.SimpleNamespace(name="port", gen=tgen, spec=tspec, rt=trt,
                             cfg=tconfig, tok=ttok)
PKGS = (JAX, PORT)
T_KW = dict(name="spec-target", vocab_size=512, dim=96, n_layers=3,
            n_heads=4, n_kv_heads=2, ffn_dim=192, context_window=1024,
            output_limit=256)
D_KW = dict(name="spec-draft", vocab_size=512, dim=48, n_layers=2,
            n_heads=2, n_kv_heads=2, ffn_dim=96, context_window=1024,
            output_limit=256)


@pytest.fixture(scope="module")
def models():
    """{"t"|"d": (jax params, port Transformer)} from PRNGKeys 0 and 1."""
    out = {}
    for which, kw, seed in (("t", T_KW, 0), ("d", D_KW, 1)):
        jp = jax_init_params(jconfig.ModelConfig(**kw),
                             jax.random.PRNGKey(seed), dtype=jnp.float32)
        out[which] = (jp, params_from_jax(jax.device_get(jp),
                                          tconfig.ModelConfig(**kw)))
    return out


def _p(pkg, models, which):
    return models[which][0 if pkg is JAX else 1]


@pytest.fixture(scope="module")
def target_engines(models):
    out = {}
    for pkg in PKGS:
        kw = {} if pkg is JAX else {"device": "cpu"}
        out[pkg.name] = pkg.gen.GenerateEngine(
            pkg.cfg.ModelConfig(**T_KW), _p(pkg, models, "t"),
            pkg.tok.ByteTokenizer(), max_seq=512, prompt_buckets=(32, 64),
            **kw)
    return out


def make_spec(pkg, models, k=4, draft="d"):
    dkw = D_KW if draft == "d" else T_KW
    cache = jnp.float32 if pkg is JAX else torch.float32
    return pkg.spec.SpeculativeDecoder(
        pkg.cfg.ModelConfig(**T_KW), _p(pkg, models, "t"),
        pkg.cfg.ModelConfig(**dkw), _p(pkg, models, draft),
        pkg.tok.ByteTokenizer(), k=k, max_seq=512, cache_dtype=cache)


def enc(text):
    return ttok.ByteTokenizer().encode(text, add_bos=True)


def view(r):
    return (r.token_ids, r.finish_reason, r.n_gen_tokens, r.rounds,
            r.drafted, r.accepted, r.n_cached_tokens, r.text)


def both(script):
    """``script(pkg)`` on both packages; equal outputs. Returns the
    port's."""
    out = {pkg.name: script(pkg) for pkg in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def test_greedy_equals_vanilla_decode(models, target_engines):
    def script(pkg):
        spec = make_spec(pkg, models, k=4)
        out = []
        for text in ("speculative decoding test", "a",
                     "the quick brown fox"):
            prompt = enc(text)
            want = target_engines[pkg.name].generate(
                [prompt], temperature=0.0, max_new_tokens=48)[0]
            got = spec.generate(prompt, temperature=0.0, max_new_tokens=48)
            assert got.token_ids == want.token_ids, (
                f"spec diverged for {text!r}: accepted={got.accepted}/"
                f"{got.drafted} rounds={got.rounds}")
            assert got.finish_reason == want.finish_reason
            assert got.n_gen_tokens == want.n_gen_tokens
            out.append(view(got))
        return out
    both(script)


def test_greedy_equality_across_k(models, target_engines):
    prompt = enc("k sweep equality")

    def script(pkg):
        want = target_engines[pkg.name].generate(
            [prompt], temperature=0.0, max_new_tokens=40)[0].token_ids
        out = []
        for k in (1, 2, 3, 6, 8):
            got = make_spec(pkg, models, k=k).generate(
                prompt, temperature=0.0, max_new_tokens=40)
            assert got.token_ids == want, f"k={k} diverged"
            out.append(view(got))
        return out
    both(script)


def test_self_draft_accepts_everything(models):
    """Draft == target: greedy proposals always match the verify argmax,
    acceptance is total and rounds collapse to ceil(max_new / K)."""
    def script(pkg):
        spec = make_spec(pkg, models, k=8, draft="t")
        res = spec.generate(enc("self draft acceptance"), temperature=0.0,
                            max_new_tokens=32)
        assert res.n_gen_tokens == 32
        assert res.accepted == res.drafted
        assert res.rounds == 4                       # ceil(32 / 8)
        assert res.tokens_per_round == 8.0
        assert res.acceptance_rate == 1.0
        return view(res)
    both(script)


def test_sampled_mode_mechanics(models):
    """Temperature > 0: valid tokens, max_new respected, acceptance
    counters consistent; top_p < 1 is refused (the acceptance test needs
    the actual proposal distribution). The port draws from the generator
    it is handed."""
    spec = make_spec(PORT, models, k=4)
    prompt = enc("sampled speculative")
    res = spec.generate(prompt, temperature=0.8, max_new_tokens=24,
                        generator=torch.Generator().manual_seed(7))
    assert 0 < res.n_gen_tokens <= 24
    assert all(0 <= t < T_KW["vocab_size"] for t in res.token_ids)
    assert res.drafted >= res.accepted >= 0
    assert res.rounds >= res.n_gen_tokens / (spec.k + 1) - 1e-9
    again = spec.generate(prompt, temperature=0.8, max_new_tokens=24,
                          generator=torch.Generator().manual_seed(7))
    assert again.token_ids == res.token_ids          # one seed, one stream
    with pytest.raises(ValueError):
        spec.generate(prompt, temperature=0.8, top_p=0.9)
    with pytest.raises(AssertionError):
        make_spec(JAX, models, k=4).generate(prompt, temperature=0.8,
                                             top_p=0.9)


def test_stop_token_truncates(models, target_engines):
    """Whatever the greedy continuation does with stop tokens, the
    decoder agrees with vanilla exactly (and the JAX decoder)."""
    prompt = enc("stop handling")

    def script(pkg):
        want = target_engines[pkg.name].generate(
            [prompt], temperature=0.0, max_new_tokens=64)[0]
        got = make_spec(pkg, models, k=4).generate(
            prompt, temperature=0.0, max_new_tokens=64)
        assert got.token_ids == want.token_ids
        assert got.finish_reason == want.finish_reason
        return view(got)
    both(script)


@pytest.mark.parametrize("enum,k,n", [(("wait", "todo", "send_message"),
                                       4, 48), (None, 3, 32)],
                         ids=["enum", "plain"])
def test_constrained_greedy_equals_vanilla_constrained(models,
                                                       target_engines,
                                                       enum, k, n):
    """Grammar-masked speculation matches the engine's constrained greedy
    decode token for token: the draft proposes under the same token-DFA
    mask and the verify pass re-applies it per position."""
    texts = (("emit an action", "respond with json") if enum
             else ("plain json please",))

    def script(pkg):
        spec = make_spec(pkg, models, k=k)
        out = []
        for text in texts:
            prompt = enc(text)
            want = target_engines[pkg.name].generate(
                [prompt], temperature=0.0, max_new_tokens=n,
                constrain_json=[True], action_enums=[enum])[0]
            got = spec.generate(prompt, temperature=0.0, max_new_tokens=n,
                                constrain_json=True, action_enum=enum)
            assert got.token_ids == want.token_ids, text
            assert got.finish_reason == want.finish_reason
            assert got.text.lstrip().startswith("{")
            out.append(view(got))
        return out
    both(script)


def test_session_resume_splices_and_matches_fresh(models, target_engines):
    """A refinement-shaped second round (prior prompt + response + new
    text) resumes the decoder's session, forwarding only the glue, and
    equals a fresh speculative run and vanilla decode; a divergent prompt
    drops the session and runs fresh."""
    def script(pkg):
        eng = target_engines[pkg.name]
        spec = make_spec(pkg, models, k=4)
        p1 = enc("round one prompt")
        r1 = spec.generate(p1, temperature=0.0, max_new_tokens=24,
                           session_id="s")
        assert r1.n_cached_tokens == 0
        p2 = p1 + r1.token_ids + enc(" refine the answer")[1:]
        r2 = spec.generate(p2, temperature=0.0, max_new_tokens=24,
                           session_id="s")
        assert r2.n_cached_tokens == len(p1) + len(r1.token_ids)
        fresh = make_spec(pkg, models, k=4).generate(
            p2, temperature=0.0, max_new_tokens=24)
        assert r2.token_ids == fresh.token_ids, "session resume diverged"
        assert r2.token_ids == eng.generate(
            [p2], temperature=0.0, max_new_tokens=24)[0].token_ids
        assert spec.session_tokens("s") == (
            p2 + r2.token_ids
            if r2.finish_reason == "stop" else (p2 + r2.token_ids)[:-1])
        p3 = enc("completely different task")
        r3 = spec.generate(p3, temperature=0.0, max_new_tokens=12,
                           session_id="s")
        assert r3.n_cached_tokens == 0
        assert r3.token_ids == eng.generate(
            [p3], temperature=0.0, max_new_tokens=12)[0].token_ids
        spec.drop_session("s")
        assert "s" not in spec._sessions
        assert spec.session_tokens("s") is None
        return [view(r) for r in (r1, r2, r3)]
    both(script)


def test_session_resume_constrained(models, target_engines):
    """Sessions compose with the grammar: each round's JSON starts at the
    grammar's start state while the KV prefix splices."""
    enum = ("wait", "todo")

    def script(pkg):
        spec = make_spec(pkg, models, k=4)
        p1 = enc("emit action one")
        r1 = spec.generate(p1, temperature=0.0, max_new_tokens=32,
                           constrain_json=True, action_enum=enum,
                           session_id="cs")
        p2 = p1 + r1.token_ids + enc(" now refine")[1:]
        r2 = spec.generate(p2, temperature=0.0, max_new_tokens=32,
                           constrain_json=True, action_enum=enum,
                           session_id="cs")
        assert r2.n_cached_tokens == len(p1) + len(r1.token_ids)
        want = target_engines[pkg.name].generate(
            [p2], temperature=0.0, max_new_tokens=32,
            constrain_json=[True], action_enums=[enum])[0]
        assert r2.token_ids == want.token_ids
        assert r2.text.lstrip().startswith("{")
        return [view(r) for r in (r1, r2)]
    both(script)


def test_property_greedy_equality_random_shapes(models, target_engines):
    """Seeded edge shapes: prompt lengths down to 1, K from 1 up, max_new
    down to 1, random token ids. Greedy speculation matches vanilla decode
    on every one, in both packages."""
    rng = random.Random(20260730)
    cases = []
    for _ in range(12):
        k = rng.choice([1, 2, 3, 5, 8])
        n_prompt = rng.choice([1, 2, 3, 7, 19, 40])
        max_new = rng.choice([1, 2, 5, 17, 32])
        cases.append((k, [rng.randrange(4, T_KW["vocab_size"])
                          for _ in range(n_prompt)], max_new))

    def script(pkg):
        decs, out = {}, []
        for case, (k, prompt, max_new) in enumerate(cases):
            want = target_engines[pkg.name].generate(
                [prompt], temperature=0.0, max_new_tokens=max_new)[0]
            dec = decs.setdefault(k, make_spec(pkg, models, k=k))
            got = dec.generate(prompt, temperature=0.0,
                               max_new_tokens=max_new)
            where = f"case {case}: k={k} n={len(prompt)} max_new={max_new}"
            assert got.token_ids == want.token_ids, where
            assert got.finish_reason == want.finish_reason, where
            out.append(view(got))
        return out
    both(script)


def test_vocab_mismatch_rejected(models):
    bad_kw = dict(name="bad-draft", vocab_size=256, dim=48, n_layers=2,
                  n_heads=2, n_kv_heads=2, ffn_dim=96)
    jp = jax_init_params(jconfig.ModelConfig(**bad_kw),
                         jax.random.PRNGKey(2))
    with pytest.raises(AssertionError):
        jspec.SpeculativeDecoder(jconfig.ModelConfig(**T_KW), models["t"][0],
                                 jconfig.ModelConfig(**bad_kw), jp,
                                 jtok.ByteTokenizer())
    with pytest.raises(ValueError):
        tspec.SpeculativeDecoder(
            tconfig.ModelConfig(**T_KW), models["t"][1],
            tconfig.ModelConfig(**bad_kw),
            params_from_jax(jax.device_get(jp),
                            tconfig.ModelConfig(**bad_kw)),
            ttok.ByteTokenizer())


# ---------------------------------------------------------------------------
# the baton-mode backend
# ---------------------------------------------------------------------------


def _engines(pkg, names):
    out = {}
    for name in names:
        jcfg, tcfg = both_configs(name)
        jp, tp = shared_params(name, seed=3)
        spec = f"xla:{name}"
        if pkg is JAX:
            out[spec] = jgen.GenerateEngine(jcfg, jp,
                                            jtok.get_tokenizer(spec))
        else:
            out[spec] = tgen.GenerateEngine(tcfg, tp,
                                            ttok.get_tokenizer(spec),
                                            device="cpu")
    return out


def _backend(pkg, engines, **kw):
    if pkg is JAX:
        from quoracle_tpu.models import embeddings as jemb
        e0 = engines["xla:tiny"]
        return jrt.TPUBackend(["xla:tiny"], engines=engines,
                              embedder=jemb.EmbeddingEncoder(
                                  e0.cfg, e0.params, e0.tokenizer), **kw)
    return trt.TorchBackend(["xla:tiny"], device="cpu", engines=engines,
                            **kw)


def test_backend_draft_map_serves_speculatively():
    """TorchBackend(draft_map=...) in baton mode routes a single greedy
    text row through the batch-1 decoder: results equal a vanilla
    backend's (constrained JSON and sessions included) and TPUBackend's;
    the decoder's sessions grow across refinement rounds and the backend
    splices the next round against them; the draft is not a servable pool
    member; a prompt with no room left falls through to the baton path's
    context_overflow."""
    msgs1 = [{"role": "system", "content": "Respond with JSON."},
             {"role": "user", "content": "report status"}]

    def script(pkg):
        R = pkg.rt
        vanilla = _backend(pkg, _engines(pkg, ("tiny",)))
        spec = _backend(pkg, _engines(pkg, ("tiny", "tiny-gemma")),
                        draft_map={"xla:tiny": "xla:tiny-gemma"},
                        draft_k=4)
        assert "xla:tiny" in spec._spec_decoders
        assert "xla:tiny-gemma" in spec.engines
        assert "xla:tiny-gemma" not in spec.pool

        def ask(backend, msgs, session=None):
            return backend.query([R.QueryRequest(
                "xla:tiny", msgs, temperature=0.0, max_tokens=32,
                constrain_json=True, session_id=session)])[0]
        bad = spec.query([R.QueryRequest("xla:tiny-gemma", msgs1,
                                         max_tokens=8)])[0]
        assert not bad.ok and bad.permanent_error
        over = spec.query([R.QueryRequest(
            "xla:tiny", [{"role": "user", "content": "x " * 300}],
            max_tokens=8)])[0]
        assert not over.ok and "context_overflow" in (over.error or "")
        want, got = ask(vanilla, msgs1), ask(spec, msgs1)
        assert got.ok and want.ok
        assert got.text == want.text, "speculative backend diverged"
        assert got.usage.completion_tokens == want.usage.completion_tokens
        assert got.spec_rounds > 0 and want.spec_rounds == 0
        r1 = ask(spec, msgs1, session="ag1")
        dec = spec._spec_decoders["xla:tiny"]
        resident = len(dec._sessions["ag1"]["ctx"])
        msgs2 = msgs1 + [{"role": "assistant", "content": r1.text},
                         {"role": "user", "content": "refine it"}]
        r2 = ask(spec, msgs2, session="ag1")
        assert r2.ok and r2.cached_tokens > 0
        assert len(dec._sessions["ag1"]["ctx"]) > resident
        v1 = ask(vanilla, msgs1, session="vg1")
        v2 = ask(vanilla, msgs2, session="vg1")
        assert (v1.text, v2.text) == (r1.text, r2.text)
        # the backend's drop reaches the decoder's sessions too
        spec.drop_session("ag1", model_specs=["xla:tiny-gemma"])
        assert "ag1" in dec._sessions
        spec.drop_session("ag1")
        assert dec.session_tokens("ag1") is None
        stats = spec.spec_stats()
        vanilla.close()
        spec.close()
        return ([(r.text, r.cached_tokens, r.spec_rounds,
                  r.spec_accepted_tokens, r.prefill_ms, r.decode_ms)
                 for r in (got, r1, r2)], over.error, bad.error, stats)
    both(script)


def test_backend_contention_falls_back_to_batching():
    """Concurrent agents on a draft_map member: the decoder lock is
    TRY-acquired, so contended rounds take the baton path instead of
    serializing; every caller gets a complete result either way, and an
    uncontended re-ask reproduces the speculative path's answer."""
    spec = _backend(PORT, _engines(PORT, ("tiny",)),
                    draft_map={"xla:tiny": "xla:tiny"}, draft_k=3)
    vanilla = _backend(PORT, _engines(PORT, ("tiny",)))
    dec = spec._spec_decoders["xla:tiny"]

    def ask(backend, i):
        return backend.query([trt.QueryRequest(
            "xla:tiny", [{"role": "user", "content": f"concurrent task {i}"}],
            temperature=0.0, max_tokens=16)])[0]
    r0 = ask(spec, 0)
    assert r0.ok and r0.spec_rounds > 0
    assert r0.text == ask(vanilla, 0).text
    # hold the decoder's lock: every caller must take the baton path
    dec.lock.acquire()
    results: list = [None] * 4
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, ask(spec, i))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        dec.lock.release()
    assert all(r is not None and r.ok and r.text for r in results), results
    assert all(r.spec_rounds == 0 for r in results)
    assert all(r.usage.completion_tokens > 0 for r in results)
    assert ask(spec, 0).text == r0.text
    spec.close()
    vanilla.close()
