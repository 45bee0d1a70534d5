"""The port's default dispatch (models/runtime.py ``_MemberBatcher`` and
``TorchBackend(overlap=True)``) against the JAX backend's, on the CPU.

Both backends serve the same fp32 weights (tests/_torch_parity.py) on
the unified ragged tier (``unified_min_tokens = 0``), prefix sharing at
its default. A merge of concurrent callers' rounds depends on timing, so
every test that needs one forces it: the first ``engine.generate`` is
held until the other callers' submissions are queued in the member's
batcher (never by sleeping alone). Every wait takes a timeout, so a hung
batcher fails its test rather than the suite.
"""

import re
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from _torch_parity import both_configs, shared_params
from test_torch_consensus import outcome_view
from quoracle_tpu.consensus import engine as jce
from quoracle_tpu.models import embeddings as jemb
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu_torch.consensus import engine as tce
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.ops import kernels
from quoracle_tpu_torch.serving.admission import (
    AdmissionError, DeadlineExceededError,
)
from quoracle_tpu_torch.serving.qos import (
    Priority, class_name, coerce_priority,
)

torch.set_num_threads(1)

POOL = ["xla:tiny", "xla:tiny-gemma"]
MODEL = POOL[0]
WAIT = 60.0          # seconds any future or event may take here
SYSTEM = ("You are one member of a consensus pool. Answer with one JSON "
          "action object. " + " ".join(f"Rule {i}: keep step {i} short."
                                       for i in range(16)))


def _jax_backend(pool=POOL, **kw):
    engines = {}
    for spec in pool:
        jcfg, _ = both_configs(spec.split(":")[1])
        params, _ = shared_params(spec.split(":")[1], seed=5)
        e = jgen.GenerateEngine(jcfg, params, jtok.get_tokenizer(spec))
        e.unified_min_tokens = 0
        engines[spec] = e
    e0 = engines[pool[0]]
    return jrt.TPUBackend(pool, engines=engines,
                          embedder=jemb.EmbeddingEncoder(
                              e0.cfg, e0.params, e0.tokenizer), **kw)


def _torch_backend(pool=POOL, **kw):
    engines = {}
    for spec in pool:
        _, tcfg = both_configs(spec.split(":")[1])
        _, model = shared_params(spec.split(":")[1], seed=5)
        e = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer(spec),
                                device="cpu")
        e.unified_min_tokens = 0       # on the CPU the default is gather
        engines[spec] = e
    return trt.TorchBackend(pool, device="cpu", engines=engines, **kw)


def _messages(agent, step=0):
    """Agent 9's system prompt differs from every other agent's."""
    system = SYSTEM if agent != 9 else "Answer with one JSON object."
    msgs = [{"role": "system", "content": system},
            {"role": "user", "content": f"agent {agent}: pick an action"}]
    if step:
        msgs += [{"role": "assistant", "content": '{"action": "wait"}'},
                 {"role": "user", "content": "refine your proposal"}]
    return msgs


def _wait_for(pred, what: str) -> None:
    t_end = time.monotonic() + WAIT
    while not pred():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


class GenerateSpy:
    """Wraps a member engine's ``generate``: records each call's batch
    (decoded prompts), holds the FIRST call until ``release()`` says so,
    and raises for a batch holding ``poison`` in a prompt."""

    def __init__(self, backend, spec=MODEL, poison=None):
        self.engine = backend.engines[spec]
        self.batcher = backend._batchers[spec]
        self.calls: list[list[str]] = []
        self.entered = threading.Event()
        self.release_now = threading.Event()
        self.poison = poison
        orig = self.engine.generate
        tok = self.engine.tokenizer

        def generate(prompts, **kw):
            texts = [tok.decode(p) for p in prompts]
            self.calls.append(texts)
            if len(self.calls) == 1:
                self.entered.set()
                if not self.release_now.wait(WAIT):
                    raise AssertionError("the held generate was never "
                                         "released")
            if poison is not None and any(poison in t for t in texts):
                raise RuntimeError("poisoned batch")
            return orig(prompts, **kw)
        self.engine.generate = generate

    def pending(self) -> int:
        with self.batcher._plock:
            return len(self.batcher._pending)

    def hold_until_pending(self, n: int) -> None:
        _wait_for(lambda: self.pending() >= n, f"{n} queued submissions")

    @property
    def sizes(self) -> list[int]:
        return [len(c) for c in self.calls]


def _round(backend, agent, step=0, **kw):
    return backend.query([backend_module(backend).QueryRequest(
        MODEL, _messages(agent, step), temperature=0.0, max_tokens=8,
        session_id=f"agent-{agent}", **kw)])


def backend_module(backend):
    return jrt if isinstance(backend, jrt.TPUBackend) else trt


def _forced_merge(backend, agents, step=0, **kw):
    """Agent 0's round holds the baton (its generate held) until the other
    agents' rounds are queued; they then drain as one merged batch.
    Returns (results per agent, batch sizes, spy)."""
    spy = GenerateSpy(backend)
    with ThreadPoolExecutor(max_workers=len(agents)) as ex:
        futs = [ex.submit(_round, backend, agents[0], step, **kw)]
        assert spy.entered.wait(WAIT)
        for k, a in enumerate(agents[1:]):
            futs.append(ex.submit(_round, backend, a, step, **kw))
            spy.hold_until_pending(k + 1)
        spy.release_now.set()
        res = [f.result(timeout=WAIT) for f in futs]
    del spy.engine.generate
    return res, spy.sizes, spy


def test_member_batcher_coalesces_concurrent_rounds():
    """The port's version of tests/test_sharding.py's batcher test:
    rounds 1 and 2 queue while round 0 serves and drain as ONE merged
    batch; each agent's session is stored despite the merge."""
    backend = _torch_backend([MODEL])
    res, sizes, _ = _forced_merge(backend, [0, 1, 2])
    for r in res:
        assert r[0].ok, r[0].error
    assert sizes == [1, 2] and sum(sizes) == 3
    eng = backend.engines[MODEL]
    assert all(eng.sessions.get(f"agent-{a}") is not None for a in range(3))
    assert len(backend._batchers) == 1 and backend.overlap


def _merged_rounds(backend):
    """Two forced merges of three agents, agent 9 holding the baton: the
    rounds that build their sessions, then the resumed rounds. Returns
    per step the results, the batch sizes and the rows each sessioned
    generate deferred to a second wave."""
    eng = backend.engines[MODEL]
    waves: list = []
    split = eng._prefix_wave_split

    def spy(*a, **kw):
        out = split(*a, **kw)
        waves.append(list(out))
        return out
    eng._prefix_wave_split = spy
    out = []
    for step in (0, 1):
        waves.clear()
        res, sizes, _ = _forced_merge(backend, [9, 1, 2], step)
        out.append(([(r[0].ok, r[0].text, r[0].cached_tokens) for r in res],
                    sizes, list(waves)))
    del eng._prefix_wave_split
    return out


def test_merged_batches_match_the_jax_backend():
    """The same forced merges on both packages at temperature 0: texts,
    cached tokens, batch sizes and wave splits equal. Agents 1 and 2
    share a system prompt that no session holds yet, so their merged new
    sessions take the engine's two-wave split inside ONE generate call
    (the batch sizes are the calls', not the waves')."""
    jax_out = _merged_rounds(_jax_backend([MODEL]))
    port_out = _merged_rounds(_torch_backend([MODEL]))
    assert port_out == jax_out
    (first, sizes1, waves1), (second, sizes2, waves2) = port_out
    assert sizes1 == sizes2 == [1, 2]
    assert waves1 == [[], [1]] and waves2 == [[], []]
    assert all(ok for ok, _, _ in first + second)
    assert all(c > 0 for _, _, c in second)


def _pool_round(backend):
    reqs = [backend_module(backend).QueryRequest(
        spec, _messages(i), temperature=0.0, max_tokens=8,
        session_id="agent-pool", constrain_json=True)
        for i, spec in enumerate(POOL)]
    return [(r.model_spec, r.ok, r.text, r.cached_tokens)
            for r in backend.query(reqs)]


def test_overlap_matches_serial_and_the_jax_backend():
    """overlap=True (members on their own threads) and overlap=False give
    the same results on the port, and both equal the JAX backend's, over
    a round that builds each member's session and one that resumes it."""
    runs = {}
    for name, backend in (
            ("jax", _jax_backend()),
            ("port_overlap", _torch_backend()),
            ("port_serial", _torch_backend(overlap=False))):
        runs[name] = [_pool_round(backend), _pool_round(backend)]
    assert runs["port_overlap"] == runs["port_serial"] == runs["jax"]
    assert all(ok for rnd in runs["jax"] for _, ok, _, _ in rnd)


def test_overlap_runs_members_on_their_own_threads():
    backend = _torch_backend()
    names = {}
    for spec in POOL:
        eng = backend.engines[spec]

        def generate(*a, _orig=eng.generate, _spec=spec, **kw):
            names[_spec] = threading.current_thread().name
            return _orig(*a, **kw)
        eng.generate = generate
    assert all(ok for _, ok, _, _ in _pool_round(backend))
    assert all(n.startswith("pool-member") for n in names.values())
    assert len(set(names.values())) == len(POOL)
    backend.overlap = False
    _pool_round(backend)
    assert set(names.values()) == {threading.current_thread().name}


def _deadline_script(backend, when: str):
    """One member, two callers. ``build``: a query with a row of
    deadline_ms=0 and a neighbour row without a deadline. ``serve``: an
    agent holds the baton while a second query (a row with a 1.5 s
    deadline and a neighbour) queues; the held generate goes on only once
    that deadline has lapsed (1.5 s: long enough that the row always
    outlives its build). Returns the rows' (ok, error,
    permanent_error), the neighbour's text and the generate batch
    sizes."""
    R = backend_module(backend)
    spy = GenerateSpy(backend)

    def rows():
        return backend.query([
            R.QueryRequest(MODEL, _messages(7), temperature=0.0,
                           max_tokens=8, session_id="agent-late",
                           deadline_ms=0 if when == "build" else 1500),
            R.QueryRequest(MODEL, _messages(8), temperature=0.0,
                           max_tokens=8, session_id="agent-next")])

    if when == "build":
        spy.release_now.set()
        res = rows()
    else:
        with ThreadPoolExecutor(max_workers=2) as ex:
            holder = ex.submit(_round, backend, 0)
            assert spy.entered.wait(WAIT)
            late = ex.submit(rows)
            spy.hold_until_pending(1)
            with spy.batcher._plock:
                (dl,) = [r["deadline_s"] for sub, _ in spy.batcher._pending
                         for r in sub if r["deadline_s"] is not None]
            _wait_for(lambda: time.monotonic() > dl + 0.01,
                      "the row's deadline")
            spy.release_now.set()
            assert holder.result(timeout=WAIT)[0].ok
            res = late.result(timeout=WAIT)
    del spy.engine.generate
    return ([(r.ok, r.error, r.permanent_error) for r in res],
            res[1].text, spy.sizes)


@pytest.mark.parametrize("when", ["build", "serve"])
def test_deadlines_match_the_jax_backend(when):
    """A lapsed deadline fails its row as ``deadline_exceeded:`` (not a
    permanent error) and the neighbour row is served without it, at build
    time (never reaching generate) and at serve time (dropped from the
    merged batch): the same strings, texts and generate calls as the JAX
    backend."""
    jax_out = _deadline_script(_jax_backend([MODEL]), when)
    port_out = _deadline_script(_torch_backend([MODEL]), when)
    assert port_out == jax_out
    (late, nxt), _, sizes = port_out
    assert late[0] is False and late[1].startswith("deadline_exceeded:")
    assert late[2] is False
    assert nxt == (True, None, False)
    assert sizes == ([1] if when == "build" else [1, 1])


def _retry_script(backend, prio):
    """Agent 0 holds the baton while three callers queue in order: agent
    1 (its prompt poisoned), agent 2 and agent 3, with the priorities
    ``prio``. Their merged batch fails, and each submission is retried
    alone in priority order. Returns each caller's (ok, error) and the
    agents of each generate call."""
    spy = GenerateSpy(backend, poison="POISON")
    R = backend_module(backend)

    def one(agent):
        msgs = _messages(agent)
        if agent == 1:
            msgs[-1] = {"role": "user", "content": "POISON pick"}
        return backend.query([R.QueryRequest(
            MODEL, msgs, temperature=0.0, max_tokens=8,
            session_id=f"agent-{agent}", priority=prio.get(agent))])

    with ThreadPoolExecutor(max_workers=4) as ex:
        futs = [ex.submit(one, 0)]
        assert spy.entered.wait(WAIT)
        for k, a in enumerate((1, 2, 3)):
            futs.append(ex.submit(one, a))
            spy.hold_until_pending(k + 1)
        spy.release_now.set()
        res = [f.result(timeout=WAIT)[0] for f in futs]
    del spy.engine.generate
    agents = [sorted(1 if "POISON" in t else
                     int(re.search(r"agent (\d):", t).group(1))
                     for t in call) for call in spy.calls]
    return [(r.ok, r.error) for r in res], agents


@pytest.mark.parametrize("prio,order", [
    # BACKGROUND, AGENT, BATCH: retried AGENT, BATCH, BACKGROUND
    ({1: 3, 2: 1, 3: 2}, [2, 3, 1]),
    # INTERACTIVE (0) ranks as AGENT (1), as in the JAX batcher's
    # ``priority or 1``: agents 2 and 3 keep their arrival order
    ({1: 3, 2: 1, 3: 0}, [2, 3, 1])])
def test_failed_merge_retries_each_submission_in_priority_order(prio, order):
    jax_out = _retry_script(_jax_backend([MODEL]), prio)
    port_out = _retry_script(_torch_backend([MODEL]), prio)
    assert port_out == jax_out
    res, agents = port_out
    assert [ok for ok, _ in res] == [True, False, True, True]
    assert res[1][1] == "generate failed: poisoned batch"
    # the held call, the merged batch, then one retry a submission
    assert agents == [[0], [1, 2, 3]] + [[a] for a in order]


def test_batcher_never_strands_a_caller():
    """A batch whose generate returns no result for a row fails that row
    instead of leaving its caller polling."""
    backend = _torch_backend([MODEL])
    eng = backend.engines[MODEL]
    eng.generate = lambda prompts, **kw: []
    res = backend.query([trt.QueryRequest(MODEL, _messages(0),
                                          max_tokens=4)])
    assert not res[0].ok and res[0].error.startswith("generate failed:")


def test_admission_errors_map_to_row_errors():
    backend = _torch_backend([MODEL])
    eng = backend.engines[MODEL]

    def reject(prompts, **kw):
        raise AdmissionError("shed", retry_after_ms=250, tenant="t",
                             priority=Priority.BATCH)
    eng.generate = reject
    (r,) = backend.query([trt.QueryRequest(MODEL, _messages(0),
                                           max_tokens=4)])
    assert r.error == "admission_rejected: shed (retry_after_ms=250)"
    e = DeadlineExceededError("late", tenant="t", priority=0)
    assert e.retry_after_ms == 0 and isinstance(e, AdmissionError)
    assert e.as_dict() == {"error": "late", "reason": "deadline",
                           "retry_after_ms": 0, "tenant": "t",
                           "priority": "interactive"}


@pytest.mark.parametrize("value,want", [
    (None, Priority.AGENT), (0, Priority.INTERACTIVE), (2, Priority.BATCH),
    (-5, Priority.INTERACTIVE), (99, Priority.BACKGROUND),
    ("x", Priority.AGENT), (Priority.BACKGROUND, Priority.BACKGROUND)])
def test_priority_coercion_matches_the_jax_module(value, want):
    from quoracle_tpu.serving import qos as jqos
    assert coerce_priority(value) == want
    assert int(jqos.coerce_priority(value)) == int(want)
    assert class_name(value) == jqos.class_name(value)


def test_decide_with_a_lapsed_deadline_matches_the_jax_engine(monkeypatch):
    """A greedy decide with deadline_ms=0: every row fails at build time
    as a member miss, and both packages report the same outcome."""
    for mod in (jce, tce):
        monkeypatch.setattr(mod, "temperature_for_round",
                            lambda *a, **kw: 0.0)
    outs = []
    for ce, backend in ((jce, _jax_backend()), (tce, _torch_backend())):
        outs.append(ce.ConsensusEngine(backend, ce.ConsensusConfig(
            model_pool=list(POOL), max_refinement_rounds=1,
            session_key="agent-deadline", allowed_actions={"wait"},
            max_tokens=8, deadline_ms=0)).decide(
                {m: _messages(0) for m in POOL}))
    jout, tout = outs
    assert outcome_view(tout) == outcome_view(jout)
    assert tout.deadline_misses == len(POOL)
    assert {f.kind for f in tout.failures} == {"deadline"}
    assert (tout.status, tout.decision) == (jout.status, jout.decision)


def test_launch_counter_is_exact_across_threads(monkeypatch):
    """Eight threads launch one kernel 10,000 times each against a stub
    library: not one count is lost."""
    class Stub:
        def __getattr__(self, name):
            return lambda *a: 0
    monkeypatch.setattr(kernels, "load_library", lambda: Stub())
    k = kernels.Kernel("flash_fwd", "src", "tpu", [])
    barrier = threading.Barrier(8)

    def hammer():
        barrier.wait(WAIT)
        for _ in range(10_000):
            k.launch()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)       # switch threads as often as it can
    try:
        with ThreadPoolExecutor(max_workers=8) as ex:
            for f in [ex.submit(hammer) for _ in range(8)]:
                f.result(timeout=WAIT)
    finally:
        sys.setswitchinterval(interval)
    assert k.launches == 80_000
