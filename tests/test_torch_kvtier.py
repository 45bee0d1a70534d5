"""The port's tiered KV (serving/kvtier.py and its hooks in the session
store, the prefix cache, the engine, the continuous batcher, the headroom
signal and the backend) against the JAX package's, on the CPU.

Every case of tests/test_kvtier.py that does not need the web layer runs
here on both packages, over the same fp32 tiny weights
(tests/_torch_parity.py), the same ByteTokenizer prompts and the same
tier pinned on both engines. Each case returns what it observed after
every step: temperature-0 tokens, cached counts, the tier's counters and
host bytes, the free list, the refcounts, the sessions and the prefix
cache's counters; the two lists must be equal. Inside each package a
restored page must be bit-identical to the copy demoted from it.

Across the packages: the same ``kv_signature`` strings for fp32, bf16 and
int8 pools, and disk entries that either package writes and the other
loads, byte-identical files when the content is the same.
"""

import copy
import functools
import glob
import os
import threading
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.infra import resources as jres
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import scheduler as jsch
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.serving import kvtier as jkv
from quoracle_tpu_torch.infra import resources as tres
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import scheduler as tsch
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.serving import kvtier as tkv

torch.set_num_threads(1)

KW = dict(max_seq=512, prompt_buckets=(32, 64, 128, 256))
SYS = "system: " + "policy rules apply here. " * 8    # > 1 page of 128
ENUM = ("wait", "send_message", "todo")
WAIT = 120.0
JAX = types.SimpleNamespace(name="jax", gen=jgen, sch=jsch, rt=jrt,
                            kv=jkv, res=jres, tok=jtok)
PORT = types.SimpleNamespace(name="port", gen=tgen, sch=tsch, rt=trt,
                             kv=tkv, res=tres, tok=ttok)
SIDES = (JAX, PORT)


@functools.cache
def _weights():
    return shared_params("tiny", seed=7)


def make_engine(side, tier="gather", **kw):
    """The JAX test's engine (xla:tiny, ByteTokenizer, fp32) on ``side``,
    pinned to the unified or the gather tier."""
    jcfg, tcfg = both_configs("tiny")
    params, model = _weights()
    if side is JAX:
        eng = jgen.GenerateEngine(jcfg, params, jtok.ByteTokenizer(), **KW,
                                  **kw)
    else:
        eng = tgen.GenerateEngine(tcfg, model, ttok.ByteTokenizer(),
                                  device="cpu", **KW, **kw)
    eng.unified_min_tokens = 0 if tier == "unified" else 1 << 30
    return eng


def enc(text):
    return ttok.ByteTokenizer().encode(text, add_bos=True)


def gen(eng, prompt, sid, n=16, **kw):
    return eng.generate([prompt], temperature=0.0, max_new_tokens=n,
                        session_ids=[sid], **kw)[0]


def hibernate_all(engine):
    """Run the eviction ladder over every resident session: demand all
    usable pages (no protected keys), then release them."""
    st = engine.sessions
    with engine._paged_lock:
        with st.lock:
            got = st.alloc(st.n_pages - 1)
            assert got is not None
            st._release(got)


def host(x) -> np.ndarray:
    """A tier tensor of either package as numpy (bf16 widened exactly)."""
    if torch.is_tensor(x):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def dtname(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def pool_pages(eng, pages) -> list:
    """The pool's K and V (and int8 scale pools) at ``pages``."""
    st = eng.sessions
    pools = [st.k, st.v] + ([st.k_scale, st.v_scale]
                            if st.k_scale is not None else [])
    idx = list(pages)
    return [host(x[:, idx]) for x in pools]


def entry_arrays(e) -> list:
    return [host(x) for x in (e.k, e.v, e.k_scale, e.v_scale)
            if x is not None]


def tier_state(t) -> dict:
    s = dict(t.stats())
    s.pop("prefixd", None)
    if s["disk"] is not None:
        s["disk"] = {k: v for k, v in s["disk"].items() if k != "dir"}
    s["host_sessions"] = list(t.host.sessions)
    s["host_prefixes"] = list(t.host.prefixes)
    return s


def state(eng) -> tuple:
    """Everything the store, its tree and its tier hold, comparable."""
    st = eng.sessions
    with st.lock:
        return (list(st._free), dict(st._refs),
                {k: (list(s.tokens), list(s.pages), s.start_pos)
                 for k, s in st._sessions.items()},
                st.prefix_cache.stats(), st.prefix_cache.occupancy(),
                tier_state(st.tier) if st.tier is not None else None)


def row(r) -> tuple:
    return (list(r.token_ids), r.n_cached_tokens, r.finish_reason)


def both(case, *args) -> list:
    """Run ``case`` on each package; the observations must be equal."""
    jobs, tobs = (case(side, *args) for side in SIDES)
    assert tobs == jobs
    return tobs


# ---------------------------------------------------------------------------
# Hibernate -> restore
# ---------------------------------------------------------------------------

def _case_hibernate_restore(side, tier, constrained):
    kw = (dict(constrain_json=[True], action_enums=[ENUM]) if constrained
          else {})
    n = 48 if constrained else 24
    p1 = enc(SYS + (" respond with an action json." if constrained
                    else " task: count to five."))
    ctl = make_engine(side, tier)
    a1 = gen(ctl, p1, "s", n, **kw)
    p2 = p1 + a1.token_ids + enc(" continue")[1:]
    a2 = gen(ctl, p2, "s", n, **kw)
    eng = make_engine(side, tier)
    t = eng.attach_tier(host_mb=64)
    b1 = gen(eng, p1, "s", n, **kw)
    assert b1.token_ids == a1.token_ids
    obs = [row(a1), row(b1), state(eng)]
    resident = pool_pages(eng, [p for p in eng.sessions.get("s").pages
                                if p])
    hibernate_all(eng)
    assert eng.sessions.get("s") is None and t.has_session("s")
    assert t.demoted_sessions == 1
    # the demoted copy holds the resident pages' bytes
    for got, want in zip(entry_arrays(t.host.sessions["s"]), resident):
        assert np.array_equal(got, want)
    # the splice sees the conversation while it is hibernated
    obs += [state(eng), eng.session_tokens("s")]
    b2 = gen(eng, p2, "s", n, **kw)
    assert b2.token_ids == a2.token_ids
    assert t.restored_sessions == 1 and t.restore_failures == 0
    # page-in, not re-prefill: the never-evicted control's cached count
    assert b2.n_cached_tokens == a2.n_cached_tokens > 0
    return obs + [row(a2), row(b2), state(eng)]


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["greedy", "constrained"])
@pytest.mark.parametrize("tier", ["gather", "unified"])
def test_hibernate_restore_matches_jax(tier, constrained):
    both(_case_hibernate_restore, tier, constrained)


def _case_prefetch_restores_bit_identical(side, tier):
    eng = make_engine(side, tier)
    t = eng.attach_tier(host_mb=64)
    gen(eng, enc(SYS + " warm me"), "s", 8)
    demoted_from = pool_pages(eng, [p for p in eng.sessions.get("s").pages
                                    if p])
    hibernate_all(eng)
    entry = entry_arrays(t.host.sessions["s"])
    assert eng.sessions.get("s") is None
    assert eng.prefetch_session("s") is True
    restored = pool_pages(eng, eng.sessions.get("s").pages)
    for a, b, c in zip(demoted_from, entry, restored):
        assert np.array_equal(a, b) and np.array_equal(b, c)
    obs = [state(eng)]
    # already resident: not restored twice
    assert eng.prefetch_session("s") is False
    return obs + [state(eng)]


@pytest.mark.parametrize("tier", ["gather", "unified"])
def test_prefetch_restores_bit_identical_pages(tier):
    both(_case_prefetch_restores_bit_identical, tier)


def _case_prefetch_skips_busy_engine(side):
    eng = make_engine(side)
    eng.attach_tier(host_mb=64)
    gen(eng, enc(SYS + " busy case"), "s", 8)
    hibernate_all(eng)
    with eng._paged_lock:          # an in-flight paged call
        assert eng.prefetch_session("s") is False
    obs = [state(eng)]
    assert eng.prefetch_session("s") is True
    return obs + [state(eng)]


def test_prefetch_skips_busy_engine():
    both(_case_prefetch_skips_busy_engine)


def _boom(*a, **kw):
    raise ValueError("page-in refused")


def _case_restore_failure_reprefills(side, how):
    """A failed restore re-prefills: the tier is never a correctness
    dependency. ``unattainable``: no pages to be had (the JAX test);
    ``scatter``: the page-in itself raises."""
    p1 = enc(SYS + " task A")
    a1 = gen(make_engine(side), p1, "s")
    eng = make_engine(side)
    t = eng.attach_tier(host_mb=64)
    b1 = gen(eng, p1, "s")
    hibernate_all(eng)
    st = eng.sessions
    obs = [row(a1), row(b1), state(eng)]
    if how == "unattainable":
        with st.lock:
            hog = st.alloc(len(st._free))
            assert hog
        with eng._paged_lock:
            assert t.restore_session("s") is None
        assert t.restore_failures == 1
        obs.append(state(eng))
        with st.lock:
            st._release(hog)
    else:
        t._scatter_device = _boom
    b2 = gen(eng, p1, "s")
    assert b2.token_ids == a1.token_ids == b1.token_ids
    return obs + [row(b2), state(eng)]


@pytest.mark.parametrize("how", ["unattainable", "scatter"])
def test_restore_failure_reprefills(how):
    obs = both(_case_restore_failure_reprefills, how)
    if how == "scatter":
        final = obs[-1][-1]
        # the session and the prefix block both failed to page in
        assert final["restore_failures"] == 2
        assert final["restored_sessions"] == 0


def _case_shared_refcounts(side):
    """Demoting a session whose prefix pages the tree and an adopter still
    hold leaves those pages resident; the restored session gets fresh
    pages, and its divergence copies on write as an always-resident one."""
    tok = ttok.ByteTokenizer()
    eng = make_engine(side)
    t = eng.attach_tier(host_mb=64)
    st = eng.sessions
    p_donor = enc(SYS + " donor task")
    d1 = gen(eng, p_donor, "donor")
    donor_pages = list(st.get("donor").pages)
    p_adopt = enc(SYS + " adopter goes elsewhere")
    a1 = gen(eng, p_adopt, "adopter")
    assert a1.n_cached_tokens >= st.page
    shared = [p for p in st.get("adopter").pages if p in donor_pages]
    assert shared
    obs = [row(d1), row(a1), shared, state(eng)]
    with st.lock:
        refs_before = {p: st._refs.get(p, 1) for p in shared}
    with eng._paged_lock:
        with st.lock:
            sess = st._sessions.pop("donor")
            assert t.demote_session("donor", sess)
            st._release(sess.pages)
    with st.lock:
        for p in shared:
            assert st._refs.get(p, 1) == refs_before[p] - 1
            assert p not in st._free
    obs.append(state(eng))
    oracle = make_engine(side)
    o1 = gen(oracle, p_adopt, "x")
    a2 = gen(eng, p_adopt, "adopter2")
    assert a2.token_ids == o1.token_ids
    p_div = p_donor[:st.page // 2] + tok.encode("DIVERGENT " * 8)
    d2 = gen(eng, p_div, "donor")
    assert t.restored_sessions == 1
    a3 = gen(eng, p_adopt, "adopter3")
    assert a3.token_ids == gen(oracle, p_adopt, "y").token_ids
    assert d2.token_ids == gen(oracle, p_div, "z").token_ids
    return obs + [row(a2), row(d2), row(a3), state(eng)]


def test_shared_refcounts_survive_demote_restore():
    both(_case_shared_refcounts)


def _case_dropped_session_stays_dropped(side):
    eng = make_engine(side)
    t = eng.attach_tier(host_mb=64)
    gen(eng, enc(SYS + " ephemeral"), "s", 8)
    hibernate_all(eng)
    assert t.has_session("s")
    eng.drop_session("s")
    assert not t.has_session("s")
    assert eng.session_tokens("s") is None
    return [state(eng)]


def test_dropped_session_does_not_come_back():
    both(_case_dropped_session_stays_dropped)


# ---------------------------------------------------------------------------
# The disk prefix store
# ---------------------------------------------------------------------------

def _npz_files(d) -> list:
    return sorted(glob.glob(os.path.join(d, "*", "*.npz")))


def _case_disk_warm_start(side, root, tier):
    d = str(root / side.name)
    p1 = enc(SYS + " task one")
    e1 = make_engine(side, tier)
    t1 = e1.attach_tier(host_mb=64, disk_dir=d)
    r1 = gen(e1, p1, "a")
    t1.flush_spills()
    files = _npz_files(d)
    assert files
    rc = gen(make_engine(side, tier), p1, "x")
    # a restart: a new engine and store over the same directory
    e2 = make_engine(side, tier)
    t2 = e2.attach_tier(host_mb=64, disk_dir=d)
    r2 = gen(e2, p1, "b")
    assert r2.token_ids == rc.token_ids == r1.token_ids
    t2.flush_spills()
    assert t2.restored_prefix_pages > 0
    assert r2.n_cached_tokens >= e2.sessions.page
    return [[os.path.relpath(f, d) for f in files], row(r1), row(r2),
            state(e1), state(e2)]


@pytest.mark.parametrize("tier", ["gather", "unified"])
def test_disk_warm_start(tier, tmp_path):
    both(_case_disk_warm_start, tmp_path, tier)


def _case_disk_corrupt_entries(side, root, how):
    """A corrupt (zeroed bytes), torn (truncated) or token-mismatched
    entry is skipped and unlinked, never served: a warm-starting engine
    re-prefills and gives the oracle's tokens."""
    d = str(root / side.name)
    p1 = enc(SYS + " task one")
    e1 = make_engine(side)
    t1 = e1.attach_tier(host_mb=64, disk_dir=d)
    r1 = gen(e1, p1, "a")
    t1.flush_spills()
    files = _npz_files(d)
    victim = files[0]
    key = os.path.basename(victim)[:-len(".npz")]
    store = t1.disk
    blk = next([int(t) for t in p1[:end]]
               for end in range(128, len(p1) + 1, 128)
               if store.block_key([int(t) for t in p1[:end]]) == key)
    assert store.load(key, blk) is not None
    if how == "token_mismatch":
        assert store.load(key, [t + 1 for t in blk]) is None
    else:
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            if how == "torn":
                f.truncate(size // 2)
            else:
                f.seek(size // 2)
                f.write(b"\xde\xad\xbe\xef" * 8)
        # concurrent readers all see the skip, never bytes or an error
        barrier = threading.Barrier(4)
        outcomes, errors = [], []

        def reader():
            barrier.wait()
            try:
                outcomes.append(store.load(key, blk))
            except Exception as exc:      # noqa: BLE001 — the assertion
                errors.append(exc)

        threads = [threading.Thread(target=reader) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
        assert not errors and all(o is None for o in outcomes)
    assert store.corrupt >= 1
    assert not os.path.exists(victim)
    oracle = gen(make_engine(side), p1, "x")
    e2 = make_engine(side)
    t2 = e2.attach_tier(host_mb=64, disk_dir=d)
    r2 = gen(e2, p1, "b")
    assert r2.token_ids == oracle.token_ids == r1.token_ids
    t2.flush_spills()          # the clean re-persist is asynchronous
    return [store.corrupt >= 1, row(r2), state(e2)]


@pytest.mark.parametrize("how", ["corrupt", "torn", "token_mismatch"])
def test_disk_corrupt_entries_are_skipped_and_unlinked(how, tmp_path):
    both(_case_disk_corrupt_entries, tmp_path, how)


def _kv(side, arr, bf16=False):
    """numpy -> the package's tier array: numpy for JAX (bf16 through
    ml_dtypes), a CPU tensor for the port; both round fp32 to bf16 to
    nearest even."""
    if side is JAX:
        return np.asarray(jnp.asarray(arr).astype(jnp.bfloat16)) if bf16 \
            else arr
    t = torch.from_numpy(arr)
    return t.to(torch.bfloat16) if bf16 else t


def _case_disk_round_trip(side, root, kind):
    """One block saved and loaded back: float32, bfloat16 (npz has no
    bf16: raw bytes + dtype name) or int8 with its scales."""
    s = side.kv.DiskPrefixStore(str(root / side.name), "sig", model="m")
    toks = list(range(128))
    rng = np.random.default_rng(3)
    scales = ()
    if kind == "int8":
        k = rng.integers(-127, 128, (2, 128, 2, 16)).astype(np.int8)
        v = rng.integers(-127, 128, (2, 128, 2, 16)).astype(np.int8)
        scales = tuple(rng.random((2, 2, 128)).astype(np.float32)
                       for _ in range(2))
    else:
        k = np.arange(2 * 128 * 2 * 16, dtype=np.float32).reshape(
            2, 128, 2, 16) / 7
        v = k * 2
    args = [_kv(side, a, bf16=kind == "bfloat16") for a in (k, v)]
    args += [_kv(side, a) for a in scales]
    key = s.block_key(toks)
    assert s.save(key, toks, *args)
    loaded = s.load(key, toks)
    assert loaded is not None and len(loaded) == len(args)
    for got, want in zip(loaded, args):
        assert dtname(got) == dtname(want)
        assert np.array_equal(host(got), host(want))
    with open(s._path(key), "rb") as f:
        return [key, s.stats()["entries"], s.stats()["bytes"],
                dtname(loaded[0]), f.read()]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_disk_round_trip_writes_the_jax_file(kind, tmp_path):
    """Same content, same file: the port writes the JAX store's bytes."""
    both(_case_disk_round_trip, tmp_path, kind)


def _case_disk_budget_prune(side, root):
    """The store is byte-bounded: an overflowing save prunes the
    oldest-mtime entries, and load touches an entry's mtime (LRU)."""
    kk = _kv(side, np.ones((2, 16, 2, 8), np.float32))

    def toks(i):
        return [i * 1000 + j for j in range(16)]

    s = side.kv.DiskPrefixStore(str(root / side.name), "sig", model="m")
    keys = []
    for i in range(6):
        key = s.block_key(toks(i))
        keys.append(key)
        assert s.save(key, toks(i), kk, kk)
        os.utime(s._path(key), (1_000_000 + i, 1_000_000 + i))
    per = os.path.getsize(s._path(keys[0]))
    s.budget_bytes = 3 * per + per // 2
    assert s.load(keys[0], toks(0)) is not None
    assert os.stat(s._path(keys[0])).st_mtime > 1_000_000 + 5
    key6 = s.block_key(toks(6))
    assert s.save(key6, toks(6), kk, kk)
    st = s.stats()
    assert st["entries"] == sum(
        1 for f in os.listdir(s.dir) if f.endswith(".npz"))
    st.pop("dir")
    return [per, st, [s.has(k) for k in keys + [key6]]]


def test_disk_budget_prunes_oldest_and_touches_on_load(tmp_path):
    obs = both(_case_disk_budget_prune, tmp_path)
    assert obs[1]["pruned"] >= 1 and obs[2][0] and obs[2][-1]
    assert not obs[2][1]


def test_disk_entries_load_across_packages(tmp_path):
    """A store written by the JAX package loads in the port's and the
    reverse, for fp32, bf16 and int8 blocks: same bytes, same crc."""
    rng = np.random.default_rng(5)
    toks = [int(t) for t in rng.integers(0, 259, 128)]
    f32 = rng.standard_normal((2, 128, 2, 16)).astype(np.float32)
    blocks = {
        "float32": (f32, 2 * f32),
        "bfloat16": (f32, 3 * f32),
        "int8": tuple(rng.integers(-127, 128, (2, 128, 2, 16))
                      .astype(np.int8) for _ in range(2))
        + tuple(rng.random((2, 2, 128)).astype(np.float32)
                for _ in range(2)),
    }
    for kind, arrays in blocks.items():
        for src, dst in ((JAX, PORT), (PORT, JAX)):
            root = str(tmp_path / f"{kind}-{src.name}")
            w = src.kv.DiskPrefixStore(root, "sig", model="m")
            args = [_kv(src, a, bf16=kind == "bfloat16" and i < 2)
                    for i, a in enumerate(arrays)]
            key = w.block_key(toks)
            assert key == dst.kv.DiskPrefixStore.block_key(toks)
            assert w.save(key, toks, *args)
            with np.load(w._path(key)) as z:
                crc = int(z["crc"])
            r = dst.kv.DiskPrefixStore(root, "sig", model="m")
            assert r.stats()["entries"] == 1
            got = r.load(key, toks)
            assert got is not None, (kind, src.name)
            assert dtname(got[0]) == dtname(got[1]) == kind
            for g, want in zip(got, args):
                assert dtname(g) == dtname(want)
                assert np.array_equal(host(g), host(want))
            assert dst.kv.DiskPrefixStore._crc(
                np.asarray(toks, np.int64), *got) == crc


def _case_restored_prefix_pages_evictable(side, root):
    """A block paged in from disk ends with the tree as its only holder,
    so the ladder can strip it again."""
    d = str(root / side.name)
    p1 = enc(SYS + " task one")
    e1 = make_engine(side)
    t1 = e1.attach_tier(host_mb=64, disk_dir=d)
    gen(e1, p1, "a")
    t1.flush_spills()
    e2 = make_engine(side)
    t2 = e2.attach_tier(host_mb=64, disk_dir=d)
    gen(e2, p1, "b")
    t2.flush_spills()
    assert t2.restored_prefix_pages > 0
    e2.drop_session("b")
    st = e2.sessions
    with st.lock:
        cached = list(st.prefix_cache._pages)
        assert cached
        assert all(st._refs.get(pg, 1) == 1 for pg in cached)
        obs = [state(e2)]
        freed = st.prefix_cache.evict(len(cached))
    assert freed == len(cached)
    return obs + [freed, state(e2)]


def test_restored_prefix_pages_are_evictable(tmp_path):
    both(_case_restored_prefix_pages_evictable, tmp_path)


# ---------------------------------------------------------------------------
# Store-level cases (page 4)
# ---------------------------------------------------------------------------

def _zeros(side, shape):
    return jnp.zeros(shape, jnp.float32) if side is JAX else torch.zeros(
        shape)


def _case_extend_prefix_after_alloc_evicts_path(side):
    """alloc inside extend_prefix can strip the deepest node of the path
    just matched; the restored block must never be inserted under the
    shorter path (that would label block j's KV with block j-1's tokens)."""
    page = 4
    store = side.gen.SessionStore(max_tokens=4 * page, page=page)
    L, KV, HD = 2, 2, 4
    store.k = _zeros(side, (L, store.n_pages, page, KV, HD))
    store.v = _zeros(side, (L, store.n_pages, page, KV, HD))
    tier = side.kv.TierManager(store, model="m", host_mb=1)
    store.tier = tier
    tokens = list(range(2 * page))

    def blk(depth):
        return _kv(side, np.full((L, page, KV, HD), float(depth),
                                 np.float32))

    tier.host.put_prefix(tier._block_key(tokens[:page]),
                         side.kv._HostBlock(tokens[:page], blk(1), blk(1)))
    tier.host.put_prefix(tier._block_key(tokens),
                         side.kv._HostBlock(tokens, blk(2), blk(2)))
    with store.lock:
        seed = store.alloc(1)
        if side is JAX:
            store.k = store.k.at[:, seed[0]].set(1.0)
        else:
            store.k[:, seed[0]] = 1.0
        assert store.prefix_cache.insert(tokens[:page], seed) == 1
        store._release(seed)
        hog = store.alloc(len(store._free))
        assert hog
        restored = tier.extend_prefix(tokens, len(tokens) + 1)
        depth_of = {}
        stack = [(store.prefix_cache._root, 0)]
        while stack:
            node, depth = stack.pop()
            for ch in node.children.values():
                depth_of[ch.page] = depth + 1
                stack.append((ch, depth + 1))
        for pg, depth in depth_of.items():
            assert np.all(host(store.k[:, pg]) == float(depth))
        assert (len(store._free) + len(store.prefix_cache._pages)
                + len(hog)) == store.n_pages - 1
        obs = [restored, sorted(depth_of.items()), list(store._free),
               dict(store._refs), tier_state(tier)]
        store._release(hog)
    return obs


def test_extend_prefix_survives_alloc_evicting_matched_path():
    both(_case_extend_prefix_after_alloc_evicts_path)


def _case_host_budget_spills_prefixes(side, root):
    store = side.gen.SessionStore(max_tokens=8 * 4, page=4)
    tier = side.kv.TierManager(store, model="m", host_mb=1,
                               disk_dir=str(root / side.name))
    store.tier = tier
    base = np.zeros((2, 4, 2, 4), np.float32)
    tier.host.budget_bytes = 3 * (2 * base.nbytes)
    keys = []
    for i in range(5):
        toks = [100 * i + j for j in range(4)]
        key = tier._block_key(toks)
        keys.append(key)
        tier.host.put_prefix(
            key, side.kv._HostBlock(toks, _kv(side, base + i),
                                    _kv(side, base + i)),
            spill_fn=tier._spill_prefix_entry)
    assert tier.host.bytes <= tier.host.budget_bytes
    tier.flush_spills()
    assert all(tier.disk.has(k) for k in keys[:2])
    assert all(k in tier.host.prefixes for k in keys[2:])
    return [tier_state(tier)]


def test_host_budget_evicts_lru_and_spills_prefixes(tmp_path):
    obs = both(_case_host_budget_spills_prefixes, tmp_path)
    assert obs[0]["host"]["evicted_prefixes"] == 2


def _case_host_budget_drops_sessions(side):
    store = side.gen.SessionStore(max_tokens=8 * 4, page=4)
    tier = side.kv.TierManager(store, model="m", host_mb=1)
    store.tier = tier
    arr = np.zeros((2, 1, 4, 2, 4), np.float32)
    tier.host.budget_bytes = 2 * (2 * arr.nbytes)
    for i in range(4):
        tier.host.put_session(f"s{i}", side.kv._HostSession(
            [i], 0, _kv(side, arr.copy()), _kv(side, arr.copy())))
    return [tier_state(tier)]


def test_host_budget_drops_lru_sessions():
    obs = both(_case_host_budget_drops_sessions)
    assert obs[0]["host"]["evicted_sessions"] == 2
    assert obs[0]["host_sessions"] == ["s2", "s3"]


def test_full_width_host_budget_keeps_what_it_demotes():
    """At llama-3-8b width a bf16 page is 16 MiB, so the 256 MiB default
    holds 16 pages: a 24-page session is dropped the moment it is put,
    and a budget sized to it keeps it (the chip phase sizes host_kv_mb
    so). Counted with meta tensors: no memory is allocated."""
    page_bytes = 2 * 32 * 8 * 128 * 2 * 128
    assert page_bytes == 16 << 20
    for mb, kept in ((256, False), (24 * 16 + 16, True)):
        store = tgen.SessionStore(max_tokens=8 * 4, page=4)
        tier = tkv.TierManager(store, model="m", host_mb=mb)
        k = torch.empty((32, 24, 128, 8, 128), dtype=torch.bfloat16,
                        device="meta")
        tier.host.put_session("s", tkv._HostSession([1], 0, k, k))
        assert tier.has_session("s") is kept
        assert tier.host.evicted_sessions == (0 if kept else 1)


# ---------------------------------------------------------------------------
# Prefetch through the batcher and the backend; headroom; stats
# ---------------------------------------------------------------------------

def _case_batcher_submit_prefetches(side):
    eng = make_engine(side, "unified")
    t = eng.attach_tier(host_mb=64)
    ctl = make_engine(side, "unified")
    p1 = enc(SYS + " via scheduler")
    o1 = gen(ctl, p1, "s", 8)
    gen(eng, p1, "s", 8)
    hibernate_all(eng)
    p2 = p1 + o1.token_ids + enc(" go on")[1:]
    o2 = gen(ctl, p2, "s", 8)
    cb = side.sch.ContinuousBatcher(eng, chunk=8, max_slots=2)
    try:
        got = cb.submit(p2, temperature=0.0, max_new_tokens=8,
                        session_id="s").result(timeout=WAIT)
    finally:
        cb.close()
    assert got.token_ids == o2.token_ids
    assert t.restored_sessions == 1
    return [row(o2), row(got), tier_state(t)]


def test_continuous_batcher_submit_prefetches():
    both(_case_batcher_submit_prefetches)


def _backend(side, **kw):
    eng = make_engine(side)
    if side is JAX:
        b = jrt.TPUBackend(pool=["xla:tiny"], engines={"xla:tiny": eng},
                           **kw)
    else:
        b = trt.TorchBackend(["xla:tiny"], engines={"xla:tiny": eng},
                             device="cpu", **kw)
    return b, eng


def _case_backend_prefetch(side):
    backend, eng = _backend(side, host_kv_mb=64)
    assert backend.kv_tiered
    gen(eng, enc(SYS + " backend warm"), "agent-1", 8)
    hibernate_all(eng)
    assert backend.prefetch_sessions("agent-1") == 1
    assert eng.sessions.get("agent-1") is not None
    assert backend.prefetch_sessions("agent-1") == 0
    obs = [state(eng)]
    backend.close()
    return obs


def test_backend_prefetch_sessions():
    both(_case_backend_prefetch)


def _case_kv_stats(side):
    backend, eng = _backend(side, host_kv_mb=64)
    p = enc(SYS + " stats")
    gen(eng, p, "s", 8)
    hibernate_all(eng)
    gen(eng, p, "s", 8)
    stats = backend.kv_stats()
    assert stats["enabled"]
    m = stats["members"]["xla:tiny"]
    assert m["demoted_sessions"] >= 1 and m["restored_sessions"] >= 1
    assert m["hbm"]["pages"] == eng.sessions.n_pages
    m.pop("prefixd", None)
    untiered, _ = _backend(side)
    return [stats, untiered.kv_stats(), untiered.prefetch_sessions("s")]


def test_kv_stats():
    obs = both(_case_kv_stats)
    assert obs[1] == {"enabled": False} and obs[2] == 0


FAKE_DEVICE = [{"device": 0, "bytes_in_use": 90, "bytes_limit": 100,
                "peak_bytes_in_use": 0, "platform": "cpu", "kind": "fake",
                "source": "test"}]


def _case_effective_headroom(side, monkeypatch):
    backend, eng = _backend(side, host_kv_mb=64)
    gen(eng, enc(SYS + " hold pages"), "s", 8)
    reclaim = side.res.reclaimable_kv_bytes(backend)
    assert reclaim > 0
    monkeypatch.setattr(side.res, "device_memory_stats", lambda: FAKE_DEVICE)
    frac = side.res.effective_headroom_fraction(backend)
    assert frac is not None and frac > 0.1
    # under QoS the admission controller reads that signal
    qb, qeng = _backend(side, host_kv_mb=64, qos=True)
    gen(qeng, enc(SYS + " hold pages"), "s", 8)
    assert qb.qos_controller._headroom_fn() == pytest.approx(frac)
    saved, eng.sessions.tier = eng.sessions.tier, None
    try:
        untiered, _ = _backend(side)
        untiered.engines = {"xla:tiny": eng}
        raw = [side.res.reclaimable_kv_bytes(untiered),
               side.res.effective_headroom_fraction(untiered)]
    finally:
        eng.sessions.tier = saved
    assert raw[0] == 0 and abs(raw[1] - 0.1) < 1e-9
    return [reclaim, frac, raw]


def test_effective_headroom_counts_demotable_pages(monkeypatch):
    both(_case_effective_headroom, monkeypatch)


def _case_demotable_bytes(side):
    """Only pages the ladder could free count: a page an in-flight
    adopter pins does not, and the host budget bounds the total."""
    eng = make_engine(side)
    t = eng.attach_tier(host_mb=64)
    st = eng.sessions
    obs = [t.demotable_bytes(1)]
    gen(eng, enc(SYS + " hold pages"), "s", 8)
    with st.lock:
        base = st._attainable(list(st._sessions)) - len(st._free)
    assert 0 < base <= st.n_pages - 1 - st.free_pages()
    obs.append(t.demotable_bytes(1))
    pinned = [p for p in st.get("s").pages if p][0]
    st.acquire([pinned])
    try:
        obs.append(t.demotable_bytes(1))
    finally:
        st.release([pinned])
    obs.append(t.demotable_bytes(1))
    t.host.budget_bytes = t.host.bytes
    obs.append(t.demotable_bytes(1))
    page_bytes = eng.kv_token_pool_bytes() * st.page
    return obs + [base, page_bytes]


def test_demotable_bytes_excludes_unreclaimable_pages():
    obs = both(_case_demotable_bytes)
    zero, base, pinned, again, capped, b, _ = obs
    assert zero == 0 and base == again == b and pinned == b - 1
    assert capped == 0


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_kv_signature_matches_jax(kind):
    jcfg, tcfg = both_configs("tiny")
    params, model = _weights()
    kw = {}
    if kind == "bfloat16":
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
        model = copy.deepcopy(model).to(torch.bfloat16)
    elif kind == "int8":
        kw = dict(quantize_weights=True, quantize_kv=True)
    je = jgen.GenerateEngine(jcfg, params, jtok.ByteTokenizer(), **KW, **kw)
    te = tgen.GenerateEngine(tcfg, model, ttok.ByteTokenizer(),
                             device="cpu", **KW, **kw)
    assert te.kv_signature() == je.kv_signature()
    assert te.kv_signature().endswith(
        {"float32": "-float32", "bfloat16": "-bfloat16",
         "int8": "-int8-q8kv"}[kind])
    assert te.kv_token_pool_bytes() == je.kv_token_pool_bytes()
    assert te.quant_stats() == je.quant_stats()
    # the signature names the disk directory
    assert te.attach_tier(host_mb=1).signature == je.kv_signature()
