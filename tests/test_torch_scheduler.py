"""The port's continuous batcher (models/scheduler.py ``ContinuousBatcher``,
``GenerateEngine.generate(initial_json_state=...)`` and
``TorchBackend(continuous=True)``) against the JAX package's, on the CPU.

Every test runs one script on both packages over the same fp32 weights
(tests/_torch_parity.py), both engines on the unified ragged tier
(``unified_min_tokens = 0``) with prefix sharing at its default. At
temperature 0 the rows must come back identical: tokens, finish reason,
cached tokens and final grammar state, and so must the engines' session
counts and prefix-cache counters after the script; each package's chunked
stream must also equal its own one-shot ``generate``. Where a test needs a
row to arrive while another decodes, the first ``engine.generate`` call is
held until the row is queued (never by sleeping). Every wait takes a
timeout, so a hung batcher fails its test rather than the suite.
"""

import threading
import time
import types
from concurrent.futures import wait

import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import scheduler as jsch
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import scheduler as tsch
from quoracle_tpu_torch.models import tokenizer as ttok

torch.set_num_threads(1)

WAIT = 120.0         # seconds any future, event or join may take here
KW = dict(max_seq=256, prompt_buckets=(32, 64, 128))
JAX = types.SimpleNamespace(name="jax", gen=jgen, sch=jsch, rt=jrt)
PORT = types.SimpleNamespace(name="port", gen=tgen, sch=tsch, rt=trt)


def _engine(pkg, name="tiny", **kw):
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=3)
    spec = f"xla:{name}"
    kw = {**KW, **kw}
    if pkg is JAX:
        e = jgen.GenerateEngine(jcfg, params, jtok.get_tokenizer(spec), **kw)
    else:
        e = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer(spec),
                                device="cpu", **kw)
    e.unified_min_tokens = 0       # the unified ragged tier on both
    return e


@pytest.fixture(scope="module", params=["tiny", "tiny-gemma"])
def engines(request):
    """One engine a package per model, shared by the tests below: both
    packages run the same scripts in the same order, so their session
    stores and prefix caches stay comparable."""
    return {pkg.name: _engine(pkg, request.param) for pkg in (JAX, PORT)}


def enc(eng, text):
    return eng.tokenizer.encode(text, add_bos=True)


def view(r):
    return (r.token_ids, r.finish_reason, r.n_cached_tokens, r.json_state,
            r.n_prompt_tokens, r.n_gen_tokens, r.text)


def store_view(eng):
    return len(eng.sessions), eng.sessions.prefix_cache.stats()


def both(engines, script):
    """Run ``script(pkg, engine)`` on both packages; equal outputs, and
    equal session counts and prefix-cache counter deltas over the script.
    Returns the port's output."""
    out = {}
    for pkg in (JAX, PORT):
        eng = engines[pkg.name]
        _, stats0 = store_view(eng)
        res = script(pkg, eng)
        n, stats = store_view(eng)
        out[pkg.name] = (res, n, {k: v - stats0[k] for k, v in stats.items()})
    assert out["port"] == out["jax"]
    return out["port"][0]


class HeldGenerate:
    """Wraps an engine's ``generate``: records each call's batch size and
    holds the FIRST call until ``release`` is set."""

    def __init__(self, eng):
        self.eng = eng
        self.sizes: list[int] = []
        self.entered = threading.Event()
        self.release = threading.Event()
        orig = eng.generate

        def generate(prompts, **kw):
            self.sizes.append(len(prompts))
            if len(self.sizes) == 1:
                self.entered.set()
                if not self.release.wait(WAIT):
                    raise AssertionError("held generate never released")
            return orig(prompts, **kw)
        eng.generate = generate

    def remove(self):
        del self.eng.generate


def _wait_for(pred, what):
    t_end = time.monotonic() + WAIT
    while not pred():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _one_shot_and_chunked(pkg, eng, prompts, chunk, **kw):
    """One-shot generate of each row, then the same rows through a batcher
    at ``chunk``; both must agree. Returns the chunked results."""
    n = kw.pop("max_new_tokens")
    cons = kw.pop("constrain_json", [False] * len(prompts))
    enums = kw.pop("action_enums", [None] * len(prompts))
    want = [eng.generate([p], temperature=0.0, max_new_tokens=n,
                         constrain_json=[c], action_enums=[e])[0]
            for p, c, e in zip(prompts, cons, enums)]
    cb = pkg.sch.ContinuousBatcher(eng, chunk=chunk)
    try:
        futs = [cb.submit(p, temperature=0.0, max_new_tokens=n,
                          constrain_json=c, action_enum=e)
                for p, c, e in zip(prompts, cons, enums)]
        got = [f.result(WAIT) for f in futs]
    finally:
        cb.close()
    assert [g.token_ids for g in got] == [w.token_ids for w in want]
    assert [g.text for g in got] == [w.text for w in want]
    return [view(g) for g in got]


@pytest.mark.parametrize("chunk", [4, 7])
def test_chunked_continuation_matches_one_shot_greedy(engines, chunk):
    """One row split into chunks (session resume + 1-token re-prefill per
    chunk) gives the one-shot greedy tokens; the owned session is
    dropped."""
    def script(pkg, eng):
        p = enc(eng, "user: tell me a long story now")
        return _one_shot_and_chunked(pkg, eng, [p], chunk,
                                     max_new_tokens=24)
    both(engines, script)
    assert len(engines["port"].sessions) == 0


def test_constrained_rows_resume_grammar_across_chunks(engines):
    """A grammar-constrained row split over chunks: the relative
    json_state handoff reproduces the one-shot constrained tokens."""
    def script(pkg, eng):
        p = enc(eng, "user: respond with json")
        return _one_shot_and_chunked(pkg, eng, [p], 5, max_new_tokens=48,
                                     constrain_json=[True])
    (row,) = both(engines, script)
    assert row[6].lstrip().startswith("{")


def test_mixed_action_enums_across_chunks(engines):
    """Rows with DIFFERENT action enums share chunk calls (stacked
    grammar tables) and a third, unconstrained row leaves early: relative
    states survive the restacking as rows join and leave."""
    def script(pkg, eng):
        ps = [enc(eng, "user: act one"), enc(eng, "user: act two"),
              enc(eng, "user: plain")]
        return _one_shot_and_chunked(
            pkg, eng, ps, 6, max_new_tokens=40,
            constrain_json=[True, True, False],
            action_enums=[("alpha", "beta"), ("gamma",), None])
    both(engines, script)


def test_row_admitted_mid_stream(engines):
    """Row B is queued while A's first chunk is held: A's first chunk
    runs alone, B joins at the next chunk boundary (batch sizes [1, 2,
    ...]) and both still give their solo greedy tokens."""
    def script(pkg, eng):
        pa = enc(eng, "user: the first agent's question is long and "
                      "involved")
        pb = enc(eng, "user: second agent arrives later")
        want_a = eng.generate([pa], temperature=0.0, max_new_tokens=32)[0]
        want_b = eng.generate([pb], temperature=0.0, max_new_tokens=8)[0]
        cb = pkg.sch.ContinuousBatcher(eng, chunk=4)
        spy = HeldGenerate(eng)
        try:
            fa = cb.submit(pa, temperature=0.0, max_new_tokens=32)
            assert spy.entered.wait(WAIT)
            fb = cb.submit(pb, temperature=0.0, max_new_tokens=8)
            assert cb.stats()["queued"] == 1 and cb.stats()["live"] == 1
            spy.release.set()
            got_a, got_b = fa.result(WAIT), fb.result(WAIT)
        finally:
            spy.remove()
            cb.close()
        assert got_a.token_ids == want_a.token_ids
        assert got_b.token_ids == want_b.token_ids
        return view(got_a), view(got_b), spy.sizes, cb.stats()["steps"]
    _, _, sizes, steps = both(engines, script)
    assert sizes[:2] == [1, 2] and steps == len(sizes)


def test_row_at_context_edge_retires_without_poisoning_batch():
    """A row whose remaining window is an exact chunk multiple retires at
    the window edge instead of submitting a max_seq-length continuation
    that would overflow the whole shared batch."""
    engines = {pkg.name: _engine(pkg, max_seq=128) for pkg in (JAX, PORT)}

    def script(pkg, eng):
        edge = eng.tokenizer.encode("x" * 90, add_bos=True)
        other = enc(eng, "user: a small neighbor")
        cb = pkg.sch.ContinuousBatcher(eng, chunk=8)
        try:
            fe = cb.submit(edge, temperature=0.0, max_new_tokens=200)
            fo = cb.submit(other, temperature=0.0, max_new_tokens=8)
            ge, go = fe.result(WAIT), fo.result(WAIT)
        finally:
            cb.close()
        assert len(edge) + len(ge.token_ids) <= 128
        assert go.n_gen_tokens >= 1
        return view(ge), view(go)
    both(engines, script)


def test_over_window_submit_fails_only_its_future(engines):
    """A prompt >= max_seq fails ITS OWN future with the engine's
    ContextOverflowError at submit, while a concurrent row completes."""
    def script(pkg, eng):
        cb = pkg.sch.ContinuousBatcher(eng, chunk=8)
        try:
            ok_row = cb.submit(enc(eng, "user: hello"), temperature=0.0,
                               max_new_tokens=8)
            bad = cb.submit(eng.tokenizer.encode("y" * 400, add_bos=True),
                            temperature=0.0, max_new_tokens=8)
            with pytest.raises(pkg.gen.ContextOverflowError) as ei:
                bad.result(WAIT)
            good = ok_row.result(WAIT)
        finally:
            cb.close()
        return str(ei.value), view(good), cb.failed, cb.retired
    both(engines, script)


def test_close_mid_chunk_leaves_no_stranded_future(engines):
    """close() while the worker is inside a chunk (one row live, two
    queued): the worker finishes the chunk and fails its live row itself,
    close() fails the queued ones ("closed"), every future ends done, and
    a later submit raises."""
    def script(pkg, eng):
        cb = pkg.sch.ContinuousBatcher(eng, chunk=4)
        spy = HeldGenerate(eng)
        try:
            futs = [cb.submit(enc(eng, "user: task 0"), temperature=0.0,
                              max_new_tokens=64)]
            assert spy.entered.wait(WAIT)
            futs += [cb.submit(enc(eng, f"user: task {i}"),
                               temperature=0.0, max_new_tokens=64)
                     for i in (1, 2)]
            closer = threading.Thread(target=cb.close)
            closer.start()
            _wait_for(lambda: cb._stop, "close() to flip the stop flag")
            spy.release.set()
            closer.join(WAIT)
            assert not closer.is_alive()
        finally:
            spy.remove()
        done, not_done = wait(futs, timeout=WAIT)
        assert not not_done
        errors = [str(f.exception()) for f in futs]
        with pytest.raises(RuntimeError, match="closed"):
            cb.submit(enc(eng, "user: late"), temperature=0.0,
                      max_new_tokens=4)
        assert not cb._thread.is_alive()
        return errors, cb.failed, cb.retired, spy.sizes
    errors, failed, retired, sizes = both(engines, script)
    assert errors == ["ContinuousBatcher closed"] * 3
    assert (failed, retired, sizes) == (3, 0, [1])
    assert len(engines["port"].sessions) == 0


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_submit_racing_close_never_strands_futures(pkg):
    """Submits racing close() never strand a future: every accepted one
    ends done (a result or the documented close failure), every later
    submit raises, and every owned session is dropped. The race's
    interleaving differs run to run, so each package is held to the
    invariants rather than to the other's outcome."""
    eng = _engine(pkg)
    cb = pkg.sch.ContinuousBatcher(eng, chunk=4)
    accepted: list = []
    acc_lock = threading.Lock()
    closed = threading.Event()

    def spam(k):
        i = 0
        while not closed.is_set() and i < 200:
            try:
                f = cb.submit(enc(eng, f"user: race {k}-{i}"),
                              temperature=0.0, max_new_tokens=2)
            except RuntimeError:
                return                    # closed: the documented rejection
            with acc_lock:
                accepted.append(f)
            i += 1

    threads = [threading.Thread(target=spam, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    _wait_for(lambda: cb.steps >= 2, "two chunks amid the submits")
    cb.close()
    closed.set()
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive()
    assert accepted, "race produced no submissions"
    done, not_done = wait(accepted, timeout=WAIT)
    assert not not_done, f"{len(not_done)} futures stranded"
    for f in accepted:
        exc = f.exception()
        if exc is not None:
            assert "closed" in str(exc).lower()
    assert len(eng.sessions) == 0
    assert not any(t.name.startswith("batcher-") and t.is_alive()
                   for t in threading.enumerate())


def test_generate_initial_json_state_across_waves(engines):
    """``generate(initial_json_state=...)`` directly, through the
    two-wave split: two new sessions share a one-page system prefix, so
    the second row is deferred to a second wave that adopts the first
    wave's pages. Each row resumes mid-grammar from the state its first
    part ended in, and its two parts give the one-shot constrained
    tokens."""
    def script(pkg, eng):
        system = "system: " + " ".join(f"rule{i}." for i in range(22))
        ps = [enc(eng, system + " user: first"),
              enc(eng, system + " user: second")]
        enums = [("alpha", "beta"), None]
        kw = dict(temperature=0.0, constrain_json=[True, True],
                  action_enums=enums)
        want = eng.generate(ps, max_new_tokens=20, **kw)
        head = eng.generate(ps, max_new_tokens=8, **kw)
        waves = []
        split = eng._prefix_wave_split

        def spy(*a):
            out = split(*a)
            waves.append(list(out))
            return out
        eng._prefix_wave_split = spy
        try:
            tail = eng.generate(
                [p + h.token_ids for p, h in zip(ps, head)],
                max_new_tokens=12, session_ids=["w-a", "w-b"],
                initial_json_state=[h.json_state for h in head], **kw)
        finally:
            del eng._prefix_wave_split
        for w, h, t in zip(want, head, tail):
            assert h.token_ids + t.token_ids == w.token_ids
            assert t.json_state == w.json_state
        for sid in ("w-a", "w-b"):
            eng.drop_session(sid)
        return [view(r) for r in head + tail], waves
    rows, waves = both(engines, script)
    assert waves == [[1]]
    assert rows[3][2] > 0                 # the deferred row adopted pages


def test_worker_forwards_run_without_autograd_on_the_batcher_thread():
    """The decode thread did not make the engine: grad mode is per thread
    in PyTorch, so every forward it reaches must run under the engine's
    own no_grad (weights are Parameters that require grad)."""
    eng = _engine(PORT)
    seen = []
    hook = eng.params.layers[0].wq.register_forward_hook(
        lambda mod, args, out: seen.append(
            (threading.current_thread().name, torch.is_grad_enabled(),
             out.requires_grad)))
    cb = tsch.ContinuousBatcher(eng, chunk=4)
    try:
        got = cb.submit(enc(eng, "user: hello"), temperature=0.0,
                        max_new_tokens=10, constrain_json=True).result(WAIT)
    finally:
        cb.close()
        hook.remove()
    assert got.n_gen_tokens > 0 and seen
    assert {n for n, _, _ in seen} == {"batcher-tiny"}
    assert not any(g or r for _, g, r in seen)


def _backend(pkg, pool=("xla:tiny",), **kw):
    engines = {spec: _engine(pkg, spec.split(":")[1]) for spec in pool}
    if pkg is JAX:
        from quoracle_tpu.models import embeddings as jemb
        e0 = engines[pool[0]]
        return jrt.TPUBackend(list(pool), engines=engines,
                              embedder=jemb.EmbeddingEncoder(
                                  e0.cfg, e0.params, e0.tokenizer), **kw)
    return trt.TorchBackend(list(pool), device="cpu", engines=engines, **kw)


def test_backend_continuous_mode_end_to_end():
    """TorchBackend(continuous=True) against TPUBackend(continuous=True):
    consensus-shaped sessioned requests (two members, two agents each)
    flow through each member's decode loop; the refinement round resumes
    the sessions. Texts, cached tokens, phase fields and errors equal;
    sessions retained, owned ones gone; the loops' threads end at
    close()."""
    pool = ("xla:tiny", "xla:tiny-gemma")

    def script(pkg):
        backend = _backend(pkg, pool, continuous=True, continuous_chunk=4)
        R = pkg.rt
        msgs = [{"role": "user", "content": "hello continuous world"}]
        try:
            assert set(backend._cbatchers) == set(pool)
            r1 = backend.query([
                R.QueryRequest(spec, msgs, temperature=0.0, max_tokens=12,
                               session_id=f"agent-{a}",
                               constrain_json=bool(a))
                for spec in pool for a in (1, 2)])
            msgs2 = msgs + [{"role": "assistant", "content": r1[0].text},
                            {"role": "user", "content": "refine."}]
            r2 = backend.query([R.QueryRequest(
                spec, msgs2, temperature=0.0, max_tokens=12,
                session_id="agent-1") for spec in pool])
            stats = {s: (st["retired"], st["failed"], st["live"],
                         st["queued"], st["chunk"], st["max_slots"])
                     for s, st in backend.scheduler_stats().items()}
            sources = [n for n, _ in backend.watchdog_sources()]
            stores = [store_view(backend.engines[s]) for s in pool]
        finally:
            backend.close()
        return ([(r.ok, r.text, r.cached_tokens, r.prefill_ms, r.decode_ms,
                  r.error) for r in r1 + r2], stats, sources, stores)
    jax_out, port_out = script(JAX), script(PORT)
    assert port_out == jax_out
    rows, stats, sources, stores = port_out
    assert all(ok for ok, *_ in rows)
    assert all(c > 0 for _, _, c, *_ in rows[4:])
    assert sources == [f"decode-loop:{s}" for s in pool]
    assert [n for n, _ in stores] == [2, 2]
    assert not any(t.name.startswith("batcher-") and t.is_alive()
                   for t in threading.enumerate())
