"""The radix prefix cache and prefix sharing of the PyTorch port against
the JAX package's, on the CPU.

Every test runs the same inputs through both packages and compares what
they return and what their stores hold:

  * the store and its tree (page 4, readable numbers): the cases of
    tests/test_prefix_cache.py, and a seeded replay of ~200 operations
    (alloc with and without eviction, put_raw, drop, acquire, release,
    match_prefix, insert_prefix, evict) with ``stats()``, ``occupancy()``,
    the free list, the refcounts and the sessions equal after every step;
  * the engines at their default (sharing on): a fan-out of three new
    sessions with one system prompt, then the resumed round, on the
    unified, direct and gather tiers, for tiny and tiny-gemma; tokens,
    cached counts, the wave split, the prefill tokens, the tier each call
    took and the cache's counters equal at temperature 0;
  * the JAX sharing cases (adoption after the donor's death, eviction
    under pressure, copy-on-write), int8 pools under sharing, and the
    gather tier's rewrite of shared pages, bit for bit (fp32 and bf16,
    float and int8 pages).

The fp32 weights come from tests/_torch_parity.py; logits agree to ~1e-5
(tests/test_torch_transformer.py), far inside the gaps argmax decides on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_configs, shared_params
from test_torch_paged_kv import _resume
from test_torch_quant import _pools_equal
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import tokenizer as ttok

torch.set_num_threads(1)

PACKAGES = (jgen, tgen)


def _state(st) -> tuple:
    """Everything a store's bookkeeping holds, in comparable form."""
    return (st.prefix_cache.stats(), st.prefix_cache.occupancy(),
            list(st._free), dict(st._refs),
            {k: (list(s.tokens), list(s.pages), s.start_pos)
             for k, s in st._sessions.items()})


def _marker(d):
    return None if d is None else (list(d.tokens), list(d.pages),
                                   d.shared_prefix)


# ---------------------------------------------------------------------------
# The store and its tree: tests/test_prefix_cache.py's cases on both sides
# ---------------------------------------------------------------------------

def _case_match_is_page_aligned_and_capped(mod):
    store = mod.SessionStore(max_tokens=6 * 4, page=4)
    toks = list(range(12))
    pages = store.alloc(3)
    store.insert_prefix(toks, pages)
    pc = store.prefix_cache
    obs = [pc.match_len(toks, 12), pc.match_len(toks, 11),
           pc.match_len(toks, 3), pc.match_len(toks[:8] + [99] * 4, 12)]
    assert obs == [12, 8, 0, 8]
    got, n = pc.match(toks, 11)
    assert n == 8 and got == pages[:2]
    return obs + [got, n, pc.stats(), _state(store)]


def _case_insert_dedupes_onto_existing_nodes(mod):
    store = mod.SessionStore(max_tokens=6 * 4, page=4)
    toks = list(range(8))
    pa = store.alloc(2)
    store.insert_prefix(toks, pa)
    pb = store.alloc(2)
    added = store.insert_prefix(toks, pb)
    assert added == 0
    assert store.prefix_cache.match(toks, 8)[0] == pa
    return [pa, pb, added, _state(store)]


def _case_eviction_prefers_unreferenced_leaves(mod):
    store = mod.SessionStore(max_tokens=6 * 4, page=4)   # 6 usable pages
    toks_a = list(range(8))
    pa = store.alloc(2)
    store.put("a", mod._Session(tokens=toks_a, pages=pa))
    store.insert_prefix(toks_a, pa)
    store.drop("a")                       # pages now cache-only (ref 1)
    toks_b = [90 + i for i in range(8)]
    pb = store.alloc(2)
    store.put("b", mod._Session(tokens=toks_b, pages=pb))
    store.insert_prefix(toks_b, pb)
    obs = [store.free_pages(), _state(store)]
    got = store.alloc(4, protect=("b",))
    assert got is not None and set(pb).isdisjoint(got)
    assert store.prefix_cache.match_len(toks_b, 8) == 8
    assert store.prefix_cache.match_len(toks_a, 8) == 0
    assert store.prefix_cache.stats()["evicted_pages"] == 2
    obs += [got, _state(store)]
    # nothing left: the refusal evicts nothing
    assert store.alloc(1, protect=("b",)) is None
    return obs + [_state(store)]


def _case_tree_eviction_is_lru(mod):
    store = mod.SessionStore(max_tokens=3 * 4, page=4)    # 3 usable pages
    toks_x, toks_y = [1, 2, 3, 4], [5, 6, 7, 8]
    px = store.alloc(1)
    store.insert_prefix(toks_x, px)
    store.release(px)
    py = store.alloc(1)
    store.insert_prefix(toks_y, py)
    store.release(py)
    store.prefix_cache.match(toks_x, 4)    # bump X: now Y is LRU
    got = store.alloc(2)
    assert store.prefix_cache.match_len(toks_x, 4) == 4
    assert store.prefix_cache.match_len(toks_y, 4) == 0
    return [px, py, got, _state(store)]


STORE_CASES = {
    "match_is_page_aligned_and_capped":
        _case_match_is_page_aligned_and_capped,
    "insert_dedupes_onto_existing_nodes":
        _case_insert_dedupes_onto_existing_nodes,
    "eviction_prefers_unreferenced_leaves":
        _case_eviction_prefers_unreferenced_leaves,
    "tree_eviction_is_lru": _case_tree_eviction_is_lru,
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_case_matches_jax(case):
    jobs, tobs = (STORE_CASES[case](mod) for mod in PACKAGES)
    assert tobs == jobs


def _replay_ops(rng, st, held: list, n_made: list):
    """Draw one operation from the store's state (both stores hold the
    same state, so either one draws). Returns a function of (module,
    store) that applies it and returns what it returned."""
    keys = sorted(st._sessions)
    bases = [[int(t) for t in np.random.default_rng(b).integers(0, 40, 16)]
             for b in range(3)]

    def toks(n):
        # mostly one of three shared prefixes, so blocks repeat
        base = bases[int(rng.integers(3))]
        k = n if rng.random() < 0.7 else int(rng.integers(0, n + 1))
        return base[:k] + [int(t) for t in rng.integers(0, 40, n - k)]

    kind = rng.choice(["alloc", "alloc", "alloc", "drop", "drop",
                       "acquire", "release", "release", "match", "match",
                       "insert", "insert", "evict"])
    if kind == "alloc":
        n = int(rng.integers(1, 5))
        evict = bool(rng.random() < 0.7)
        protect = tuple(k for k in keys if rng.random() < 0.3)
        as_session = bool(rng.random() < 0.6)
        t = toks(int(rng.integers((n - 1) * 4 + 1, n * 4 + 1)))
        key = f"s{n_made[0]}"
        n_made[0] += 1

        def op(mod, store):
            pages = store.alloc(n, protect=protect, evict=evict)
            if pages is not None:
                if as_session:
                    store.put_raw(key, mod._Session(tokens=t, pages=pages))
                elif mod is PACKAGES[-1]:
                    held.append(list(pages))
            return ("alloc", pages)
        return op
    if kind == "drop" and keys:
        key = keys[int(rng.integers(len(keys)))]
        return lambda mod, store: ("drop", store.drop(key))
    if kind == "acquire" and keys:
        pages = list(st._sessions[keys[int(rng.integers(len(keys)))]].pages)

        def op(mod, store):
            store.acquire(pages)
            if mod is PACKAGES[-1]:
                held.append(pages)
            return ("acquire", pages)
        return op
    if kind == "release" and held:
        pages = held.pop(int(rng.integers(len(held))))
        return lambda mod, store: ("release", store.release(pages))
    if kind == "insert" and keys:
        s = st._sessions[keys[int(rng.integers(len(keys)))]]
        t, pages = list(s.tokens), list(s.pages)
        return lambda mod, store: ("insert", store.insert_prefix(t, pages))
    if kind == "evict":
        n = int(rng.integers(1, 4))
        return lambda mod, store: ("evict", store.prefix_cache.evict(n))
    # a lookup (also where the drawn operation has nothing to act on)
    t = toks(int(rng.integers(1, 17)))
    cap = max(0, len(t) - int(rng.integers(0, 2)))
    adopt = bool(rng.random() < 0.5)

    def op(mod, store):
        d = store.match_prefix(t, cap)
        if d is not None and adopt:
            store.acquire(d.pages)
            if mod is PACKAGES[-1]:
                held.append(list(d.pages))
        return ("match", _marker(d))
    return op


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_and_tree_replay_matches_jax(seed):
    """~200 seeded operations on both packages' stores: what each call
    returns and the whole bookkeeping agree after every step; once every
    holder lets go, every page is free again (I1)."""
    rng = np.random.default_rng(seed)
    stores = [mod.SessionStore(max_tokens=12 * 4, page=4)
              for mod in PACKAGES]
    held: list = []
    n_made = [0]
    kinds = set()
    for step in range(200):
        op = _replay_ops(rng, stores[-1], held, n_made)
        out = [op(mod, st) for mod, st in zip(PACKAGES, stores)]
        assert out[1] == out[0], step
        assert _state(stores[1]) == _state(stores[0]), step
        kinds.add(out[0][0])
    assert kinds == {"alloc", "drop", "acquire", "release", "match",
                     "insert", "evict"}
    stats = stores[1].prefix_cache.stats()
    assert min(stats["hits"], stats["evicted_pages"],
               stats["inserted_pages"]) > 0, stats
    for st in stores:
        for pages in held:
            st.release(pages)
        for key in list(st._sessions):
            st.drop(key)
        st.prefix_cache.clear()
        assert sorted(st._free) == list(range(1, st.n_pages))
        assert st._refs == {}


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

KW = dict(max_seq=256, prompt_buckets=(32, 64, 128))
SYSTEM = ("You are one agent of a consensus pool. Policy: " + " ".join(
    f"rule {i} keeps step {i} short." for i in range(6)))


def _pair(name="tiny", tier="unified", bf16=False, **kw):
    """One engine per package over the same fp32 weights (or their bf16
    cast), at the sharing default, pinned to one tier the same way on
    both sides."""
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=7)
    if bf16:
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
        model = model.to(torch.bfloat16)
    spec = f"xla:{name}"
    je = jgen.GenerateEngine(jcfg, params, jtok.get_tokenizer(spec),
                             **KW, **kw)
    te = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer(spec),
                             device="cpu", **KW, **kw)
    for eng in (je, te):
        assert eng.prefix_sharing
        eng.unified_min_tokens = eng.direct_decode_min_tokens = \
            eng.direct_prefill_min_tokens = 1 << 30
        if tier == "unified":
            eng.unified_min_tokens = 0
        elif tier == "direct":
            eng.direct_decode_min_tokens = 0
            eng.direct_prefill_min_tokens = 0
        else:
            eng.unified_min_tokens = 0
            eng._force_gather_decode = True
    assert te.sessions.n_pages == je.sessions.n_pages
    return je, te


JAX_STEPS = {"_run_unified": "unified",
             "_step_paged_prefill": "gather_prefill",
             "_step_paged_prefill_direct": "direct_prefill",
             "_step_paged_decode": "gather_decode",
             "_step_paged_decode_direct": "direct_decode"}
PORT_STEPS = {"_run_unified": "unified",
              "step_paged_prefill": "gather_prefill",
              "step_paged_prefill_direct": "direct_prefill",
              "step_paged_decode": "gather_decode",
              "step_paged_decode_direct": "direct_decode"}


def _spy(eng, names: dict, monkeypatch) -> list:
    """Record, in order, the tier steps and wave splits an engine runs."""
    calls: list = []
    for attr, label in {**names, "_prefix_wave_split": "split"}.items():
        orig = getattr(eng, attr)

        def wrapped(*a, _orig=orig, _label=label, **kw):
            out = _orig(*a, **kw)
            calls.append((_label, out) if _label == "split" else _label)
            return out
        monkeypatch.setattr(eng, attr, wrapped)
    return calls


def _chat(tok, user, system=SYSTEM):
    return tok.encode_chat([{"role": "system", "content": system},
                            {"role": "user", "content": user}])


def _round(je, te, prompts, sids, max_new=16, **kw):
    """One generate on both engines: equal results and bookkeeping."""
    kw = dict(temperature=0.0, max_new_tokens=max_new, session_ids=sids,
              **kw)
    jres, tres = je.generate(prompts, **kw), te.generate(prompts, **kw)
    assert [r.token_ids for r in tres] == [r.token_ids for r in jres]
    assert [r.n_cached_tokens for r in tres] == [r.n_cached_tokens
                                                 for r in jres]
    assert [r.finish_reason for r in tres] == [r.finish_reason
                                               for r in jres]
    assert te.last_prefill_tokens == je.last_prefill_tokens
    assert _state(te.sessions) == _state(je.sessions)
    return tres


TIER_STEPS = {"unified": ["unified"],
              "direct": ["direct_prefill", "direct_decode"],
              "gather": ["gather_prefill", "gather_decode"]}


@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
@pytest.mark.parametrize("tier", ["unified", "direct", "gather"])
def test_engine_fanout_and_resume_match_jax_at_the_default(
        name, tier, monkeypatch):
    """The consensus fan-out: three new sessions sharing the system
    prompt in one batch run in two waves (row 0, then rows 1-2 adopting
    the pages row 0 stored), then the resumed round off each session's
    own pages. Both packages split, adopt, store and count alike."""
    je, te = _pair(name, tier)
    jcalls = _spy(je, JAX_STEPS, monkeypatch)
    tcalls = _spy(te, PORT_STEPS, monkeypatch)
    tok = te.tokenizer
    sids = ["fan-a", "fan-b", "fan-c"]
    p1 = [_chat(tok, f"agent {k} does its own thing") for k in range(3)]
    assert min(len(p) for p in p1) > 2 * 128 - 100
    r1 = _round(je, te, p1, sids)
    assert [r.n_cached_tokens for r in r1] == [0, 128, 128]
    assert te.last_prefill_tokens == sum(len(p) for p in p1) - 2 * 128
    assert tcalls[0] == ("split", [1, 2])
    assert tcalls[1:] == 2 * TIER_STEPS[tier]
    p2 = _resume(tok, p1, r1)
    r2 = _round(je, te, p2, sids)
    assert all(r.n_cached_tokens > 128 for r in r2)
    assert tcalls == jcalls
    assert te.sessions.prefix_cache.stats()["hits"] == 2
    for sid in sids:
        je.drop_session(sid)
        te.drop_session(sid)
    assert _state(te.sessions) == _state(je.sessions)
    # the tree keeps the prefixes alive past their sessions
    assert te.sessions.prefix_cache.stats()["cached_pages"] > 0


# The JAX sharing cases (tests/test_prefix_cache.py), each on both
# packages with the same weights and ByteTokenizer prompts

SHARED_SYS = "system: " + "policy rules apply here. " * 7   # > 1 page


def _enc(text):
    return ttok.ByteTokenizer().encode(text, add_bos=True)


def _byte_pair(tier="gather", **kw):
    """The JAX test's engines (xla:tiny, ByteTokenizer, fp32) on both
    sides, with a sharing-off twin of each for the expected tokens."""
    jcfg, tcfg = both_configs("tiny")
    params, model = shared_params("tiny", seed=7)
    pairs = []
    for sharing in (True, False):
        je = jgen.GenerateEngine(jcfg, params, jtok.ByteTokenizer(), **KW,
                                 **(kw if sharing else {}))
        te = tgen.GenerateEngine(tcfg, model, ttok.ByteTokenizer(),
                                 device="cpu", **KW,
                                 **(kw if sharing else {}))
        for eng in (je, te):
            eng.prefix_sharing = sharing
            eng.unified_min_tokens = 0 if tier == "unified" else 1 << 30
        pairs.append((je, te))
    return pairs


def _gen(eng, prompt, sid, max_new=8):
    return eng.generate([prompt], temperature=0.0, max_new_tokens=max_new,
                        session_ids=[sid])[0]


def test_adoption_survives_donor_death():
    (je, te), (jp, tp) = _byte_pair()
    pa, pb = (_enc(SHARED_SYS + f"user: task {t}") for t in ("alpha", "beta"))
    for eng in (je, te):
        _gen(eng, pa, "a")
        eng.drop_session("a")              # donor dead, prefix cached
    assert _state(te.sessions) == _state(je.sessions)
    jb, tb = _gen(je, pb, "b"), _gen(te, pb, "b")
    assert tb.n_cached_tokens == jb.n_cached_tokens >= 128
    assert tb.token_ids == jb.token_ids == _gen(tp, pb, "w").token_ids
    assert _state(te.sessions) == _state(je.sessions)


def test_greedy_tokens_equal_with_the_cache_on_and_off():
    """Fresh sessions that hit the cache give the tokens of engines with
    sharing off, in both packages."""
    (je, te), (jp, tp) = _byte_pair()
    for sid, task in [("a", "alpha"), ("b", "beta"), ("c", "gamma")]:
        p = _enc(SHARED_SYS + "user: task " + task)
        got = [_gen(eng, p, sid) for eng in (je, te, jp, tp)]
        assert len({tuple(r.token_ids) for r in got}) == 1, sid
        assert got[1].n_cached_tokens == got[0].n_cached_tokens
    assert _state(te.sessions) == _state(je.sessions)
    stats = te.sessions.prefix_cache.stats()
    assert stats["hits"] == 2 and stats["hit_tokens"] >= 256
    assert tp.sessions.prefix_cache.stats()["hits"] == 0


def test_eviction_under_pressure_then_lookup_reprefills():
    """6 usable pages (768 tokens of fp32 tiny KV): fillers evict the
    cached prefix, and the next same-prefix session prefills it again."""
    (je, te), (jp, tp) = _byte_pair(session_max_bytes=768 * 512)
    assert te.sessions.n_pages == je.sessions.n_pages == 7
    pa = _enc(SHARED_SYS + "user: task alpha")
    pb = _enc(SHARED_SYS + "user: task beta")
    for eng in (je, te):
        _gen(eng, pa, "a")
        eng.drop_session("a")
        for k in range(4):
            _gen(eng, _enc(f"user: filler conversation {k} " + "z" * 160),
                 f"f{k}")
    assert _state(te.sessions) == _state(je.sessions)
    assert te.sessions.prefix_cache.stats()["evicted_pages"] >= 1
    jb, tb = _gen(je, pb, "b"), _gen(te, pb, "b")
    assert tb.n_cached_tokens == jb.n_cached_tokens
    assert tb.token_ids == jb.token_ids == _gen(tp, pb, "w").token_ids
    assert _state(te.sessions) == _state(je.sessions)


@pytest.mark.parametrize("tier", ["unified", "gather"])
def test_copy_on_write_preserves_the_sibling(tier, monkeypatch):
    """Session "a" diverges at token 100, inside page 0, which the tree
    and the adopter "b" share: the row swaps in a fresh page (cow_copies
    counts it), and since the swapped page is the partly reused boundary
    the batch runs on gather whatever the tier. The sibling's pages are
    bit-identical before and after, and its next round matches a
    sharing-off engine's."""
    (je, te), (jp, tp) = _byte_pair(tier)
    jcalls = _spy(je, JAX_STEPS, monkeypatch)
    tcalls = _spy(te, PORT_STEPS, monkeypatch)
    pa = _enc(SHARED_SYS + "user: task alpha")
    pb = _enc(SHARED_SYS + "user: task beta")
    ja, ta = _gen(je, pa, "a"), _gen(te, pa, "a")
    jb, tb = _gen(je, pb, "b"), _gen(te, pb, "b")
    assert tb.n_cached_tokens == jb.n_cached_tokens >= 128
    assert tb.token_ids == jb.token_ids
    assert te.sessions.prefix_cache.cow_copies == 0
    b_pages = list(te.sessions.get("b").pages)
    before = [x[:, b_pages].clone() for x in (te.sessions.k, te.sessions.v)]
    jbefore = [np.asarray(x[:, b_pages]) for x in (je.sessions.k,
                                                    je.sessions.v)]
    del jcalls[:], tcalls[:]
    pa_div = pa[:100] + _enc("user: rewritten after condensation")[1:]
    ja2, ta2 = _gen(je, pa_div, "a"), _gen(te, pa_div, "a")
    assert ta2.token_ids == ja2.token_ids == _gen(tp, pa_div,
                                                  "wa").token_ids
    assert te.sessions.prefix_cache.cow_copies \
        == je.sessions.prefix_cache.cow_copies >= 1
    assert tcalls == jcalls
    assert "unified" not in tcalls and "gather_prefill" in tcalls
    assert _state(te.sessions) == _state(je.sessions)
    for got, want in zip((te.sessions.k, te.sessions.v), before):
        assert torch.equal(got[:, b_pages], want)
    for got, want in zip((je.sessions.k, je.sessions.v), jbefore):
        assert np.array_equal(np.asarray(got[:, b_pages]), want)
    # the sibling continues on the shared prefix, uncorrupted
    pb2 = pb + tb.token_ids + _enc(" more")[1:]
    jb2, tb2 = _gen(je, pb2, "b"), _gen(te, pb2, "b")
    wb = _gen(tp, pb, "wb")
    wb2 = _gen(tp, pb + wb.token_ids + _enc(" more")[1:], "wb")
    assert tb2.token_ids == jb2.token_ids == wb2.token_ids


@pytest.mark.parametrize("tier", ["unified", "gather"])
def test_int8_pools_under_sharing_match_jax(tier, monkeypatch):
    """quantize_kv engines (int8 weights and pages; the unified tier is
    their default on every device, gather their fallback): the fan-out
    and the resumed round give the JAX engine's tokens, cached counts and
    tiers, adopted pages share their scales, and the pools stay within
    the int8 tolerance (tests/test_torch_quant.py ``_pools_equal``)."""
    je, te = _pair("tiny", tier, quantize_weights=True, quantize_kv=True)
    jcalls = _spy(je, JAX_STEPS, monkeypatch)
    tcalls = _spy(te, PORT_STEPS, monkeypatch)
    tok = te.tokenizer
    sids = ["q-a", "q-b", "q-c"]
    p1 = [_chat(tok, f"agent {k} does its own thing") for k in range(3)]
    r1 = _round(je, te, p1, sids)
    assert [r.n_cached_tokens for r in r1] == [0, 128, 128]
    shared = te.sessions.get("q-b").pages[0]
    assert shared == te.sessions.get("q-a").pages[0]
    r2 = _round(je, te, _resume(tok, p1, r1), sids)
    assert all(r.n_cached_tokens > 128 for r in r2)
    assert tcalls == jcalls
    assert [c for c in tcalls if isinstance(c, str)] == 3 * TIER_STEPS[tier]
    _pools_equal(je, te)


def _pages_of(eng, page: int) -> list:
    """One pool page (K, V and, for int8 pools, both scale pools) of
    either package, as numpy arrays."""
    st = eng.sessions
    pools = [st.k, st.v] + ([st.k_scale, st.v_scale]
                            if st.k_scale is not None else [])
    return [x[:, page].float().numpy() if torch.is_tensor(x)
            else np.asarray(x[:, page], np.float32) for x in pools]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("quant", [False, True],
                         ids=["float_pages", "int8_pages"])
def test_gather_rewrites_shared_pages_bit_identically(bf16, quant):
    """The gather tier copies every dst slot back to the pool, the adopted
    prefix included; in the fan-out's second wave two rows list the same
    pages (duplicate indices in one scatter), and the resumed round
    rewrites them once more. Each row writes back the values it gathered
    from those pages, so the tree's shared page must come back
    bit-identical (prefix_cache.py I2). The port's does in every case, the
    JAX engine's too, but for int8 pages under an fp32 working cache:
    there each rewrite moves some of the page's fp32 scales by one ulp
    while the int8 payload stays (a finding about the reference,
    ROADMAP.md Queue 3). In fp32 both packages give the same tokens."""
    je, te = _pair("tiny", "gather", bf16=bf16, quantize_weights=quant,
                   quantize_kv=quant)
    tok = te.tokenizer
    p1 = [_chat(tok, f"agent {k} does its own thing") for k in range(3)]
    sids = ["g-a", "g-b", "g-c"]

    def run(prompts, ids):
        if not bf16:
            return _round(je, te, prompts, ids)
        # bf16: the packages round differently, so only the pages count
        return [eng.generate(prompts, temperature=0.0, max_new_tokens=16,
                             session_ids=ids) for eng in (je, te)][1]

    r0 = run(p1[:1], sids[:1])
    shared = te.sessions.get("g-a").pages[0]
    assert shared == je.sessions.get("g-a").pages[0]
    snaps = [[_pages_of(eng, shared) for eng in (je, te)]]
    r12 = run(p1[1:], sids[1:])
    assert [r.n_cached_tokens for r in r12] == [128, 128]
    assert te.sessions.get("g-b").pages[0] == shared
    snaps.append([_pages_of(eng, shared) for eng in (je, te)])
    run(_resume(tok, p1, r0 + r12), sids)
    snaps.append([_pages_of(eng, shared) for eng in (je, te)])
    moved = 0
    for (jb, tb), (ja, ta) in zip(snaps, snaps[1:]):
        for got, want in zip(ta, tb):
            assert np.array_equal(got, want)
        int8_fp32 = quant and not bf16
        for k, (got, want) in enumerate(zip(ja, jb)):
            if int8_fp32 and k >= 2:                  # the scale pools
                assert np.all(np.abs(got - want) <= np.spacing(want))
                moved += int((got != want).sum())
            else:
                assert np.array_equal(got, want)
    assert (moved > 0) == (quant and not bf16)
