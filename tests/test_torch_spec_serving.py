"""The port's speculative serving in the continuous path
(``GenerateEngine.verify_chunk``, models/speculative.py
``BatchedSpeculator``, the ``ContinuousBatcher``'s speculative tick and
``TorchBackend(draft_map=..., continuous=True)``) against the JAX
package's, on the CPU.

Both packages get the same fp32 weights (the JAX package's
``init_params`` converted by ``params_from_jax``) and the same byte
tokenizer, and run the same script. The bar is the JAX file's
(tests/test_spec_serving.py), held on both sides: temperature-0 tokens
equal with speculation on and off, and equal across the packages; the
verify verdicts equal the JAX package's ids exactly and its probs within
1e-5 (fp32 sums in another order); the adaptive-K trajectory, counters
and ``stats()`` equal under one row sequence. Sampled rows draw from
another generator in each package, so they are held to mechanics only.
Every wait takes a timeout, so a hung batcher fails its test rather than
the suite.
"""

import threading
import time
import types
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quoracle_tpu.models import config as jconfig
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import scheduler as jsch
from quoracle_tpu.models import speculative as jspec
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.models.transformer import init_params as jax_init_params
from quoracle_tpu_torch.models import config as tconfig
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import scheduler as tsch
from quoracle_tpu_torch.models import speculative as tspec
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

WAIT = 300.0           # seconds any future may take here
PROB_TOL = 1e-5        # verify probs across the packages: fp32 sum order
JAX = types.SimpleNamespace(name="jax", gen=jgen, sch=jsch, spec=jspec,
                            rt=jrt, tok=jtok)
PORT = types.SimpleNamespace(name="port", gen=tgen, sch=tsch, spec=tspec,
                             rt=trt, tok=ttok)
PKGS = (JAX, PORT)
# the JAX file's models: a 3-layer target and a 2-layer draft of one vocab
T_KW = dict(name="cspec-t", vocab_size=512, dim=96, n_layers=3, n_heads=4,
            n_kv_heads=2, ffn_dim=192, context_window=1024,
            output_limit=256)
D_KW = dict(name="cspec-d", vocab_size=512, dim=48, n_layers=2, n_heads=2,
            n_kv_heads=2, ffn_dim=96, context_window=1024, output_limit=256)


@pytest.fixture(scope="module")
def params():
    """{"t"|"d": (jax params, port Transformer)} from PRNGKeys 0 and 1."""
    out = {}
    for which, kw, seed in (("t", T_KW, 0), ("d", D_KW, 1)):
        jp = jax_init_params(jconfig.ModelConfig(**kw),
                             jax.random.PRNGKey(seed), dtype=jnp.float32)
        out[which] = (jp, params_from_jax(jax.device_get(jp),
                                          tconfig.ModelConfig(**kw)))
    return out


def engine(pkg, params, which="t", tier="default", **kw):
    """A cspec engine of ``pkg``: max_seq 512, prompt buckets (32, 64,
    128). ``tier`` "unified" opens the unified ragged tier, "gather" pins
    the gather tier, "int8" serves int8 pages (which take the unified
    tier); "default" is the CPU default (gather) of both packages."""
    kw = dict(max_seq=kw.pop("max_seq", 512), prompt_buckets=(32, 64, 128),
              quantize_kv=tier == "int8", **kw)
    jp, tp = params[which]
    cfgkw = T_KW if which == "t" else D_KW
    if pkg is JAX:
        e = jgen.GenerateEngine(jconfig.ModelConfig(**cfgkw), jp,
                                jtok.ByteTokenizer(), **kw)
    else:
        e = tgen.GenerateEngine(tconfig.ModelConfig(**cfgkw), tp,
                                ttok.ByteTokenizer(), device="cpu", **kw)
    if tier == "unified":
        e.unified_min_tokens = 0
    elif tier == "gather":
        e._force_gather_decode = True
    return e


def enc(text):
    return ttok.ByteTokenizer().encode(text, add_bos=True)


def both(script):
    """``script(pkg)`` on both packages; the outputs must be equal.
    Returns the port's."""
    out = {pkg.name: script(pkg) for pkg in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def _mk_row(pkg, prompt, sid, max_new=64):
    return pkg.sch._Row(prompt=list(prompt), temperature=0.0, top_p=1.0,
                        max_new=max_new, session_id=sid, constrain=False,
                        action_enum=None, future=Future(),
                        t_submit=time.monotonic(), owns_session=True)


# ---------------------------------------------------------------------------
# verify_chunk: the engine-level primitive
# ---------------------------------------------------------------------------


def _copy_pools(src, dst):
    """The JAX engine's page pools into the port engine's (same pages,
    same layout). Int8 pools of the two packages differ in a few elements
    after the same writes: the activations differ in their last bits and a
    rounding tie of kv_quant lands one step apart. Verifying both from one
    pool content holds verify_chunk itself to the fp32 bar."""
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(src.sessions, name) is not None:
            getattr(dst.sessions, name).copy_(torch.from_numpy(
                np.array(getattr(src.sessions, name))))


@pytest.mark.parametrize("tier", ["unified", "gather", "int8"])
def test_verify_chunk_verdicts_match_vanilla_argmax_and_jax(params, tier):
    """Teacher-forced verify verdicts ARE the greedy continuation: the
    target's own greedy tokens as proposals are accepted at every position
    (ids == proposals), for an unconstrained row and a JSON row in one
    batch. A second call with a sampled row asks for probs. On every tier
    the ids equal the JAX package's exactly, the probs within 1e-5, the
    cached counts are equal, and the session holds the verify prompt."""
    engs, out = {}, {}
    for pkg in PKGS:
        eng = engs[pkg.name] = engine(pkg, params, tier=tier)
        p1 = enc("user: verify primitive")
        want = eng.generate([p1], temperature=0.0, max_new_tokens=12,
                            session_ids=["vc1"])[0]
        ctx = p1 + want.token_ids
        props = eng.generate([ctx], temperature=0.0, max_new_tokens=6,
                             session_ids=["vc1"])[0].token_ids[:6]
        p2 = enc("user: a json row")
        jprops = eng.generate([p2], temperature=0.0, max_new_tokens=8,
                              session_ids=["vc2"],
                              constrain_json=[True])[0].token_ids
        if pkg is PORT and tier == "int8":
            _copy_pools(engs["jax"], eng)
        prompts = [ctx + props[:-1], p2 + jprops[:-1]]
        greedy = eng.verify_chunk(prompts, ["vc1", "vc2"],
                                  [len(props), len(jprops)],
                                  temperature=0.0,
                                  constrain_json=[False, True])
        sampled = eng.verify_chunk(prompts, ["vc1", "vc2"],
                                   [len(props), len(jprops)],
                                   temperature=[0.0, 0.8],
                                   constrain_json=[False, True],
                                   need_probs=True)
        assert [r["ids"] for r in greedy] == [props, jprops]
        assert greedy[0]["probs"] is None
        # the sessions hold the verify prompts (unverified drafts at the
        # tail): the next round's LCP resume is the rollback
        assert [list(eng.sessions._sessions[s].tokens)
                for s in ("vc1", "vc2")] == prompts
        out[pkg.name] = (props, jprops, greedy, sampled)
    jo, po = out["jax"], out["port"]
    assert po[0] == jo[0] and po[1] == jo[1]
    for jr, pr in zip(jo[2] + jo[3], po[2] + po[3]):
        assert pr["ids"] == jr["ids"]
        assert pr["n_cached"] == jr["n_cached"]
        if jr["probs"] is None:
            assert pr["probs"] is None
        else:
            assert pr["probs"].shape == jr["probs"].shape
            np.testing.assert_allclose(pr["probs"], jr["probs"],
                                       atol=PROB_TOL, rtol=0)
    # the greedy row of the sampled call is one-hot at its argmax
    hot = po[3][0]["probs"]
    assert np.array_equal(np.argmax(hot, -1), po[3][0]["ids"])
    assert np.array_equal(hot.sum(-1), np.ones(len(hot), np.float32))


def test_verify_chunk_requires_sessions(params):
    eng = engine(JAX, params)
    with pytest.raises(AssertionError):
        eng.verify_chunk([enc("x")], [None], [1])
    eng = engine(PORT, params)
    with pytest.raises(ValueError):
        eng.verify_chunk([enc("x")], [None], [1])
    with pytest.raises(ValueError):
        eng.verify_chunk([enc("xy")], ["s"], [len(enc("xy")) + 1])


def test_verify_store_back_never_feeds_the_prefix_cache(params):
    """A verify store-back carries unverified draft tokens at its tail:
    the session resumes from it, but the radix prefix cache takes no page
    from it, where a plain generate of the same prompt fills one, in both
    packages."""
    def script(pkg):
        eng = engine(pkg, params, tier="unified")
        prompt = enc("user: " + "y" * 94)              # under one page
        first = eng.generate([prompt], temperature=0.0, max_new_tokens=4,
                             session_ids=["vf"])[0].token_ids
        ctx = prompt + first + enc("more context " * 3)[1:]   # over one
        cache = eng.sessions.prefix_cache
        n0 = cache.stats()["inserted_pages"]
        res = eng.verify_chunk([ctx], ["vf"], [4])[0]
        n1 = cache.stats()["inserted_pages"]
        eng.generate([ctx], temperature=0.0, max_new_tokens=4,
                     session_ids=["vg"])
        n2 = cache.stats()["inserted_pages"]
        assert len(ctx) > eng.sessions.page
        return (n1 - n0, n2 - n1, res["n_cached"],
                list(eng.sessions._sessions["vf"].tokens) == ctx)
    assert both(script)[:2] == (0, 1)


# ---------------------------------------------------------------------------
# continuous-path equality (engine level)
# ---------------------------------------------------------------------------


def _loop_rows(pkg, eng, spec, chunk, rows, **submit):
    cb = pkg.sch.ContinuousBatcher(eng, chunk=chunk, speculator=spec)
    try:
        futs = [cb.submit(p, temperature=0.0, max_new_tokens=n, **kw)
                for p, n, kw in rows]
        return [f.result(WAIT) for f in futs]
    finally:
        cb.close()


def view(g):
    return (g.token_ids, g.finish_reason, g.n_cached_tokens, g.json_state,
            g.spec_rounds, g.spec_drafted_tokens, g.spec_accepted_tokens)


@pytest.mark.parametrize("tier", ["default", "unified"])
def test_continuous_spec_greedy_equals_one_shot(params, tier):
    """Self-draft through the batcher (draft engine = target engine): the
    commit and rollback against the paged session KV reproduce one-shot
    greedy tokens, and every draft is accepted. The JAX package runs its
    CPU default (gather) tier; the port runs that and the unified tier,
    and both equal the JAX rows field by field."""
    p = enc("user: tell me a story about consensus machines")

    def script(pkg):
        ptier = tier if pkg is PORT else "default"
        want = engine(pkg, params, tier=ptier).generate(
            [p], temperature=0.0, max_new_tokens=40)[0]
        eng = engine(pkg, params, tier=ptier)
        spec = pkg.spec.BatchedSpeculator(eng, eng, k=4)
        got, = _loop_rows(pkg, eng, spec, 8, [(p, 40, {})])
        assert got.token_ids == want.token_ids
        assert got.finish_reason == want.finish_reason
        assert got.spec_rounds > 0
        assert got.spec_accepted_tokens == got.spec_drafted_tokens
        assert len(eng.sessions) == 0          # owned sessions dropped
        return view(got), spec.stats()
    both(script)


def test_continuous_spec_trained_draft_shape_equality(params):
    """A draft of other weights: whatever it proposes, greedy output equals
    vanilla, corrections carrying the stream; the draft's shadow sessions
    are dropped with the rows."""
    texts = ("user: alpha question", "user: beta goes further")

    def script(pkg):
        ref = engine(pkg, params)
        eng, dr = engine(pkg, params), engine(pkg, params, "d")
        spec = pkg.spec.BatchedSpeculator(eng, dr, k=4, accept_floor=0.0)
        cb = pkg.sch.ContinuousBatcher(eng, chunk=8, speculator=spec)
        views = []
        try:
            for text in texts:
                p = enc(text)
                want = ref.generate([p], temperature=0.0,
                                    max_new_tokens=32)[0]
                got = cb.submit(p, temperature=0.0,
                                max_new_tokens=32).result(WAIT)
                assert got.token_ids == want.token_ids, text
                views.append(view(got))
        finally:
            cb.close()
        st = spec.stats()
        assert st["rounds"] > 0 and st["drafted_tokens"] > 0
        assert len(dr.sessions) == 0           # draft shadow sessions
        return views, st
    both(script)


def test_batched_constrained_drafting_matches_single_row(params):
    """Three constrained rows with DIFFERENT action enums speculating in
    ONE shared batch each equal the vanilla engine and their own
    single-row speculative run: the stacked-grammar walk of the batched
    verify never drifts from the single-row mask."""
    enums = [("wait", "todo"), ("send_message",), None]
    prompts = [enc("user: act one"), enc("user: act two"),
               enc("user: act three json")]

    def script(pkg):
        ref = engine(pkg, params)
        wants = [ref.generate([p], temperature=0.0, max_new_tokens=40,
                              constrain_json=[True], action_enums=[e])[0]
                 for p, e in zip(prompts, enums)]

        def spec_loop():
            eng, dr = engine(pkg, params), engine(pkg, params, "d")
            return eng, pkg.spec.BatchedSpeculator(eng, dr, k=3,
                                                   accept_floor=0.0)
        eng, spec = spec_loop()
        batched = _loop_rows(pkg, eng, spec, 8, [
            (p, 40, dict(constrain_json=True, action_enum=e))
            for p, e in zip(prompts, enums)])
        eng, spec = spec_loop()
        single = [_loop_rows(pkg, eng, spec, 8, [
            (p, 40, dict(constrain_json=True, action_enum=e))])[0]
            for p, e in zip(prompts, enums)]
        for i, (b, s, w) in enumerate(zip(batched, single, wants)):
            assert b.token_ids == w.token_ids, f"row {i} batched != vanilla"
            assert s.token_ids == w.token_ids, f"row {i} single != vanilla"
            assert b.text.lstrip().startswith("{")
        return [view(g) for g in batched], [view(g) for g in single]
    both(script)


def test_mixed_batch_eligible_and_ineligible_rows(params):
    """One tick holds both kinds: a greedy row (eligible, speculates) and
    a nucleus-sampled row (ineligible, vanilla). Both finish, the greedy
    row equal to vanilla (and to the JAX row), the sampled one with no
    spec rounds, and the fallback is attributed."""
    pg = enc("user: greedy eligible row")
    ps = enc("user: sampled ineligible row")

    def script(pkg):
        want = engine(pkg, params).generate([pg], temperature=0.0,
                                            max_new_tokens=24)[0]
        eng, dr = engine(pkg, params), engine(pkg, params, "d")
        spec = pkg.spec.BatchedSpeculator(eng, dr, k=3, accept_floor=0.0)
        cb = pkg.sch.ContinuousBatcher(eng, chunk=8, speculator=spec)
        try:
            fg = cb.submit(pg, temperature=0.0, max_new_tokens=24)
            fs = cb.submit(ps, temperature=0.9, top_p=0.5,
                           max_new_tokens=16)
            gg, gs = fg.result(WAIT), fs.result(WAIT)
        finally:
            cb.close()
        assert gg.token_ids == want.token_ids
        assert gg.spec_rounds > 0
        assert gs.n_gen_tokens >= 1 and gs.spec_rounds == 0
        assert spec.stats()["fallbacks"].get("sampling", 0) > 0
        return view(gg)
    both(script)


def test_sampled_top_p1_rows_speculate_validly(params):
    """temperature > 0 at top_p 1 is ELIGIBLE (greedy one-hot drafting and
    rejection sampling): valid ids within the budget, spec rounds > 0.
    The port's draws come from its own generators: mechanics only."""
    for pkg in PKGS:
        eng, dr = engine(pkg, params), engine(pkg, params, "d")
        spec = pkg.spec.BatchedSpeculator(eng, dr, k=3, accept_floor=0.0)
        g = _sampled_row(pkg, eng, spec)
        assert 1 <= g.n_gen_tokens <= 20, pkg.name
        assert all(0 <= t < T_KW["vocab_size"] for t in g.token_ids)
        assert g.spec_rounds > 0


def _sampled_row(pkg, eng, spec):
    cb = pkg.sch.ContinuousBatcher(eng, chunk=8, speculator=spec)
    try:
        return cb.submit(enc("user: sampled but eligible"), temperature=0.8,
                         top_p=1.0, max_new_tokens=20).result(WAIT)
    finally:
        cb.close()


# ---------------------------------------------------------------------------
# adaptive K: collapse -> shrink -> vanilla fallback -> re-probe
# ---------------------------------------------------------------------------


def test_acceptance_collapse_shrinks_then_disengages_then_reprobes(
        params):
    """The adaptive-K round trip, driven synchronously with one row: a
    hopeless draft (other random weights) sags the EWMA, K shrinks toward
    k_min, after >= 3 rounds of evidence the member disengages, and
    ``reprobe_after`` vanilla ticks later it re-probes at k_min. The
    tokens committed through it all equal vanilla greedy decode. K, the
    emitted count and the counters after every round, and stats() at
    each stage, equal the JAX package's."""
    p = enc("user: a long enough prompt to decode through collapse")

    def script(pkg):
        want = engine(pkg, params).generate([p], temperature=0.0,
                                            max_new_tokens=64)[0]
        eng, dr = engine(pkg, params), engine(pkg, params, "d")
        spec = pkg.spec.BatchedSpeculator(eng, dr, k=4, k_min=2,
                                          accept_floor=0.35,
                                          reprobe_after=2)
        row = _mk_row(pkg, p, "adapt1")
        trajectory, rounds = [], 0
        while spec.engaged and rounds < 20:
            fin = spec.run_round([row])
            rounds += 1
            trajectory.append((spec.k, spec.engaged, len(row.emitted),
                               row.spec_rounds, row.spec_drafted,
                               row.spec_accepted, fin.get(id(row))))
            if fin.get(id(row)) == "stop" or len(row.emitted) >= row.max_new:
                break
        st = spec.stats()
        assert not spec.engaged, f"never disengaged: {st}"
        assert rounds >= 3
        assert st["disengages"] == 1
        assert st["k"] == spec.k_init           # reset for the next engage
        assert spec.ineligible_reason(len(p), 0.0, 1.0) == "disengaged"
        spec.tick_vanilla()
        assert not spec.engaged
        spec.tick_vanilla()
        assert spec.engaged and spec.k == spec.k_min
        st2 = spec.stats()
        assert st2["reprobes"] == 1
        assert row.emitted == want.token_ids[:len(row.emitted)]
        assert len(row.emitted) > 0
        return trajectory, st, st2, list(row.emitted)
    traj, *_ = both(script)
    ks = [k for k, *_ in traj]
    assert min(ks[:-1]) < 4 or len(ks) <= 3     # K shrank on the way down


def test_self_draft_grows_k_to_max(params):
    """Sustained full acceptance grows K toward k_max; the K after every
    round equals the JAX package's."""
    def script(pkg):
        eng = engine(pkg, params)
        spec = pkg.spec.BatchedSpeculator(eng, eng, k=3, k_max=6,
                                          grow_above=0.85)
        row = _mk_row(pkg, enc("user: growth prompt"), "grow1", max_new=48)
        ks = []
        for _ in range(8):
            fin = spec.run_round([row])
            ks.append((spec.k, len(row.emitted)))
            if fin.get(id(row)) == "stop" or len(row.emitted) >= row.max_new:
                break
        assert spec.k > 3
        eng.drop_session("grow1")
        return ks, spec.stats()
    both(script)


# ---------------------------------------------------------------------------
# pool level: continuous + QoS, speculation on vs off
# ---------------------------------------------------------------------------


def _tiny_engines(pkg, names=("tiny",)):
    """Engines of the catalog's tiny models over shared fp32 weights
    (tests/_torch_parity.py), the packages' CPU default tiers."""
    from _torch_parity import both_configs, shared_params
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


def _backend(pkg, engines, pool=("xla:tiny",), **kw):
    if pkg is JAX:
        from quoracle_tpu.models import embeddings as jemb
        e0 = engines[pool[0]]
        return jrt.TPUBackend(list(pool), engines=engines,
                              embedder=jemb.EmbeddingEncoder(
                                  e0.cfg, e0.params, e0.tokenizer), **kw)
    return trt.TorchBackend(list(pool), device="cpu", engines=engines, **kw)


def test_pool_continuous_qos_spec_on_off_bit_identical():
    """TorchBackend with continuous batching + QoS serves a draft_map'd
    member (a self-draft), and the temperature-0 texts, a session-resident
    refinement round included, are identical with speculation on and off
    and to TPUBackend's; the speculative run reports spec rounds and
    accepted tokens, and spec_stats() equals the JAX backend's."""
    msgs = [{"role": "user", "content": "hello speculative world"}]

    def script(pkg):
        R = pkg.rt
        off = _backend(pkg, _tiny_engines(pkg), continuous=True,
                       continuous_chunk=8, qos=True)
        on = _backend(pkg, _tiny_engines(pkg), continuous=True,
                      continuous_chunk=8, qos=True,
                      draft_map={"xla:tiny": "xla:tiny"}, draft_k=4)
        try:
            assert "xla:tiny" in on._speculators

            def ask(b, m, sid):
                return b.query([R.QueryRequest(
                    "xla:tiny", m, temperature=0.0, max_tokens=20,
                    constrain_json=True, session_id=sid)])[0]
            w1, g1 = ask(off, msgs, "a1"), ask(on, msgs, "a1")
            assert w1.ok and g1.ok, (w1.error, g1.error)
            assert g1.text == w1.text
            assert g1.spec_rounds > 0 and g1.spec_accepted_tokens > 0
            assert w1.spec_rounds == 0
            msgs2 = msgs + [{"role": "assistant", "content": w1.text},
                            {"role": "user", "content": "refine."}]
            w2, g2 = ask(off, msgs2, "a1"), ask(on, msgs2, "a1")
            assert w2.ok and g2.ok
            assert g2.text == w2.text
            assert g2.cached_tokens > 0      # session residency survived
            stats = on.spec_stats()
            assert stats["enabled"]
            m = stats["members"]["xla:tiny"]
            assert m["rounds"] > 0 and m["acceptance_rate"] is not None
            st = on.scheduler_stats()["xla:tiny"]["speculative"]
            assert st == m
        finally:
            off.close()
            on.close()
        return ([(r.text, r.cached_tokens, r.spec_rounds,
                  r.spec_accepted_tokens) for r in (w1, g1, w2, g2)],
                stats)
    both(script)
    assert not any(t.name.startswith("batcher-") and t.is_alive()
                   for t in threading.enumerate())


def test_draft_map_wiring():
    """draft_map + continuous builds one BatchedSpeculator per drafted
    member and hands it to that member's loop; without continuous it
    builds a batch-1 SpeculativeDecoder instead. A draft spec not among
    the engines is built as a draft, never as a pool member (queries to
    it fail permanently); a target outside the pool raises KeyError;
    swap_draft needs a continuous speculator. As in the JAX backend."""
    def script(pkg):
        engines = _tiny_engines(pkg, ("tiny", "tiny-gemma"))
        b = _backend(pkg, engines, continuous=True,
                     draft_map={"xla:tiny": "xla:tiny"})
        try:
            assert "xla:tiny" in b._speculators
            assert not b._spec_decoders
            assert b._cbatchers["xla:tiny"].speculator \
                is b._speculators["xla:tiny"]
            spec = b._speculators["xla:tiny"]
            assert spec.target is spec.draft is b.engines["xla:tiny"]
            old = b.swap_draft("xla:tiny", engines["xla:tiny-gemma"])
            assert old is engines["xla:tiny"]
            assert spec.draft is engines["xla:tiny-gemma"]
            stats = b.spec_stats()
        finally:
            b.close()
        baton = _backend(pkg, engines,
                         draft_map={"xla:tiny": "xla:tiny-gemma"})
        dec = baton._spec_decoders["xla:tiny"]
        assert not baton._speculators
        assert dec.k == 6 and dec.tc.name == "tiny" \
            and dec.dc.name == "tiny-gemma"
        assert "xla:tiny-gemma" not in baton.pool
        bad = baton.query([pkg.rt.QueryRequest(
            "xla:tiny-gemma", [{"role": "user", "content": "x"}],
            max_tokens=8)])[0]
        with pytest.raises(KeyError):
            baton.swap_draft("xla:tiny", engines["xla:tiny"])
        with pytest.raises(KeyError):
            _backend(pkg, engines, draft_map={"xla:nope": "xla:tiny"})
        baton.close()
        return (stats, baton.spec_stats(), bad.ok, bad.permanent_error,
                bad.error)
    assert both(script)[2:4] == (False, True)


def test_draft_engines_are_built_from_the_seed_after_the_pool():
    """A draft spec without an engine is built like a member from seed
    len(pool) + 100 + j and takes the backend's int8 flags."""
    b = trt.TorchBackend(["xla:tiny"], device="cpu", seed=5,
                         quantize_kv=True,
                         draft_map={"xla:tiny": "xla:tiny-gemma"})
    try:
        d = b.engines["xla:tiny-gemma"]
        assert d.quantize_kv
        from quoracle_tpu_torch.models.transformer import init_params
        gen = torch.Generator().manual_seed(5 + 1 + 100)
        want = init_params(tconfig.get_model_config("tiny-gemma"), gen,
                           device="cpu")
        assert torch.equal(d.params.embed.weight, want.embed.weight)
    finally:
        b.close()


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def test_consensus_outcome_carries_spec_attribution():
    """ConsensusOutcome sums spec_accepted_tokens and spec_rounds from the
    round's QueryResults and the audit record exposes them, in both
    consensus layers over their MockBackends."""
    from quoracle_tpu.consensus import engine as jce
    from quoracle_tpu_torch.consensus import engine as tce

    def script(pkg, CE):
        class SpecMock(pkg.rt.MockBackend):
            def query(self, requests):
                out = super().query(requests)
                return [pkg.rt.QueryResult(
                    model_spec=r.model_spec, text=r.text, usage=r.usage,
                    latency_ms=r.latency_ms, spec_rounds=3,
                    spec_accepted_tokens=14) for r in out]
        pool = list(pkg.rt.MockBackend.DEFAULT_POOL)
        eng = CE.ConsensusEngine(SpecMock(), CE.ConsensusConfig(
            model_pool=pool, session_key="spec-t", task_id="task-spec"))
        outcome = eng.decide({m: [{"role": "user", "content": "go"}]
                              for m in pool})
        assert outcome.status == "ok"
        assert outcome.spec_rounds == 3 * len(pool)
        assert outcome.spec_accepted_tokens == 14 * len(pool)
        assert outcome.audit["spec_accepted_tokens"] \
            == outcome.spec_accepted_tokens
        assert outcome.audit["spec_rounds"] == outcome.spec_rounds
        return outcome.spec_rounds, outcome.spec_accepted_tokens
    assert script(PORT, tce) == script(JAX, jce)


def test_spec_metrics_exported(params):
    """The quoracle_spec_* instruments move with a served round: rounds,
    drafted and accepted counters, the K and engaged gauges, the
    acceptance histogram, and the Prometheus exposition carries the
    series; names and help texts equal the JAX package's."""
    from quoracle_tpu.infra import telemetry as jtel
    from quoracle_tpu_torch.infra import telemetry as ttel
    names = ("SPEC_ROUNDS", "SPEC_DRAFTED", "SPEC_ACCEPTED",
             "SPEC_ACCEPTANCE", "SPEC_TOKENS_PER_ROUND", "SPEC_K",
             "SPEC_ENGAGED", "SPEC_FALLBACK_TOTAL")
    for n in names:
        j, t = getattr(jtel, n), getattr(ttel, n)
        assert (t.name, t.help, t.kind) == (j.name, j.help, j.kind), n
        assert getattr(t, "buckets", None) == getattr(j, "buckets", None)
    eng = engine(PORT, params)
    spec = tspec.BatchedSpeculator(eng, eng, k=3)
    model = T_KW["name"]
    r0 = ttel.SPEC_ROUNDS.value(model=model)
    d0 = ttel.SPEC_DRAFTED.value(model=model)
    a0 = ttel.SPEC_ACCEPTED.value(model=model)
    row = _mk_row(PORT, enc("user: metrics"), "met1", max_new=16)
    spec.run_round([row])
    assert ttel.SPEC_ROUNDS.value(model=model) == r0 + 1
    assert ttel.SPEC_DRAFTED.value(model=model) == d0 + 3
    assert ttel.SPEC_ACCEPTED.value(model=model) == a0 + 3
    assert ttel.SPEC_ENGAGED.value(model=model) == 1.0
    assert ttel.SPEC_K.value(model=model) == spec.k
    spec.note_fallback("window", 2)
    assert ttel.SPEC_FALLBACK_TOTAL.value(model=model, reason="window") >= 2
    text = ttel.METRICS.render_prometheus()
    assert "quoracle_spec_rounds_total" in text
    assert "quoracle_spec_acceptance" in text
    eng.drop_session("met1")
