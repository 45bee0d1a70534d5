"""An agent's decide loop over the port's ``TorchBackend(device="cpu")``
against the JAX agent's over ``TPUBackend``: tests/test_e2e_tpu_agent.py's
four cases (:36, :86, :133, :193) on ``xla:tiny`` + ``xla:tiny-gemma``
with the same fp32 weights (tests/_torch_parity.py); case 3 (pause and
restore) runs through each package's ``Runtime``. Also
``answer_engine`` over each real backend.

Both packages' engines run on the unified ragged tier without prefix
sharing, and the decides are greedy (both consensus engines'
``temperature_for_round`` pointed at 0.0; a decide never samples at 0 by
itself). The compact system prompt and the output budget (32 tokens; 64
for tiny alone, which closes its greedy JSON only past 32) are the JAX
file's seams (the full prompt overflows tiny's 512-token window).
Both runs must give identical decisions, histories, raw answers, cached
tokens, cost entries (the ``Decimal`` amounts from each backend's usage)
and ``serving_round`` events (ms dropped). One more test holds the
executor thread, which runs every decide tick, to no autograd."""

import dataclasses
import functools
import threading

import jax.numpy as jnp
import pytest
import torch

from _agent_parity import (
    BOTH, JAX, PORT, Env, first_difference, history_view, idle,
    install_watch, new_watch, process_hooks_restored, run, view,
)
from _torch_parity import both_configs, shared_params
from quoracle_tpu.models import embeddings as jemb
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.models import transformer as jtr
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import tokenizer as ttok

torch.set_num_threads(1)

POOL = ["xla:tiny", "xla:tiny-gemma"]
PROMPT = ("You are an agent. Respond ONLY with a JSON object "
          '{"action": "wait", "params": {}}.')
MAX_TOKENS = 32


@pytest.fixture
def greedy(monkeypatch):
    install_watch(monkeypatch)
    for pkg in BOTH:
        monkeypatch.setattr(pkg.cengine, "temperature_for_round",
                            lambda *a, **kw: 0.0)
        pkg.treeobs.reset()
    monkeypatch.setattr(jemb, "init_cache", functools.partial(
        jtr.init_cache, dtype=jnp.float32))


def engines(pkg, pool, window=None):
    out = {}
    for spec in pool:
        name = spec.split(":")[1]
        jcfg, tcfg = both_configs(name)
        jparams, model = shared_params(name, seed=7)
        kw = {}
        if window:
            jcfg = dataclasses.replace(jcfg, context_window=window)
            tcfg = dataclasses.replace(tcfg, context_window=window)
            kw["max_seq"] = window
        if pkg is JAX:
            e = jgen.GenerateEngine(jcfg, jparams, jtok.get_tokenizer(spec),
                                    **kw)
        else:
            e = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer(spec),
                                    device="cpu", **kw)
        e.unified_min_tokens = 0
        e.prefix_sharing = False
        out[spec] = e
    return out


def backend(pkg, pool=POOL, window=None, **kw):
    """Each package's real backend over the shared weights. ``window``
    widens the members' context window (engines, and the backend's
    answer to ``context_window``) over the same weights."""
    engs = engines(pkg, pool, window)
    if pkg is JAX:
        e0 = engs[pool[0]]
        b = pkg.runtime.TPUBackend(
            list(pool), engines=engs, embedder=jemb.EmbeddingEncoder(
                e0.cfg, e0.params, e0.tokenizer), **kw)
    else:
        b = pkg.runtime.TorchBackend(list(pool), device="cpu", engines=engs,
                                     **kw)
    if window:
        b.context_window = lambda spec: window
    return b


def wait_only(pkg):
    base = pkg.capabilities.filter_actions(list(pkg.schema.ACTIONS), [], ())
    return tuple(a for a in base if a != "wait")


async def decided_agent(pkg, b, agent_id, task_id, pool,
                        max_tokens=MAX_TOKENS):
    """Start an agent allowed only ``wait`` over ``b`` with the compact
    prompt and a ``max_tokens`` budget, post one task message and wait for
    the decision's result. Returns the env, the core and, per round,
    each member's cached tokens."""
    cached = []
    orig = b.query

    def query(requests):
        res = orig(requests)
        cached.append({r.model_spec: r.cached_tokens for r in res})
        return res
    b.query = query
    env = Env(pkg, b)
    b.attach_bus(env.deps.events.bus)
    core = await env.start(agent_id=agent_id, task_id=task_id,
                           model_pool=list(pool), capability_groups=[],
                           forbidden_actions=wait_only(pkg),
                           max_refinement_rounds=2)
    core._system_prompt = PROMPT
    core.engine.config.max_tokens = max_tokens
    core.post({"type": "user_message", "from": "user",
               "content": "decide your next action"})

    def decided():
        h = core.ctx.history(pool[0])
        return any(e.kind == "decision" for e in h) \
            and any(e.kind == "result" for e in h) and idle(core)
    await env.w.until(decided, timeout=300)
    return env, core, cached


def observe(env, core, cached, pool) -> dict:
    serving = [{m: {k: v for k, v in st.items()
                    if k not in ("prefill_ms", "decode_ms")}
                for m, st in e["members"].items()}
               for t, e in env.rec.events if t == "serving:metrics"]
    return {"histories": {m: [(e.kind, view(e.content))
                              for e in core.ctx.history(m)] for m in pool},
            "raw": [(e["model"], e["text"]) for t, e in env.rec.events
                    if e["event"] == "raw_response"],
            "cached": cached, "serving": serving,
            "serving_keys": sorted({k for t, e in env.rec.events
                                    if t == "serving:metrics" for k in e}),
            "costs": [(str(c.amount), c.cost_type, c.input_tokens,
                       c.output_tokens, c.description)
                      for c in env.deps.costs.entries_for(core.agent_id)],
            "spent": str(env.deps.escrow.get(core.agent_id).spent),
            "actions": env.rec.names("actions:all"),
            "spans": env.span_names()}


def test_agent_decides_and_executes_on_both_backends(greedy):
    """Case 1 (:36): agent → consensus → backend → grammar-masked
    generate → parser → validator → decision → executed result, with KV
    sessions keyed by the agent, dropped when it terminates."""
    def case(pkg):
        async def main():
            b = backend(pkg)
            env, core, cached = await decided_agent(
                pkg, b, "agent-e2e", "task-e2e", POOL)
            out = observe(env, core, cached, POOL)
            out["sessions"] = [len(e.sessions) > 0
                               for e in b.engines.values()]
            await env.sup.terminate_agent("agent-e2e")
            out["dropped"] = [e.sessions.get("agent-e2e") is None
                              for e in b.engines.values()]
            env.close()
            return out
        return main()
    got = [run(case(pkg), timeout=900) for pkg in BOTH]
    assert got[1] == got[0]
    port = got[1]
    decision = next(c for k, c in port["histories"][POOL[0]]
                    if k == "decision")
    assert decision["action"] == "wait"
    result = next(c for k, c in port["histories"][POOL[0]] if k == "result")
    assert result["result"]["status"] == "ok"
    assert all(port["sessions"]) and all(port["dropped"])
    # one serving_round a query round, each with every queried member
    assert len(port["serving"]) == len(port["cached"]) >= 1
    assert port["serving_keys"] == ["event", "members", "ts"]
    assert all(set(r) == set(POOL) for r in port["serving"])
    assert set(port["serving"][0][POOL[0]]) == {
        "prefill_tokens", "kv_free_pages", "prefix_cache"}
    # money: the decide's cost entry from the backend's usage
    assert port["costs"] and all(a != "0" for a, *_ in port["costs"])
    assert port["spans"]["agent.decide_tick"] >= 1


def test_agent_decides_over_speculative_backend(greedy):
    """Case 2 (:86): speculation on (a self-draft at K 3): the round is
    served by the member's batch-1 speculative decoder, which holds the
    agent's session until the agent terminates."""
    pool = ["xla:tiny"]

    def case(pkg):
        async def main():
            b = backend(pkg, pool, draft_map={"xla:tiny": "xla:tiny"},
                        draft_k=3)
            # tiny alone closes its greedy JSON only past 32 tokens
            env, core, cached = await decided_agent(
                pkg, b, "agent-e2e-spec", "task-spec", pool, max_tokens=64)
            out = observe(env, core, cached, pool)
            dec = b._spec_decoders["xla:tiny"]
            out["decoder_sessions"] = sorted(dec._sessions)
            await env.sup.terminate_agent("agent-e2e-spec")
            out["after"] = sorted(dec._sessions)
            env.close()
            return out
        return main()
    got = [run(case(pkg), timeout=900) for pkg in BOTH]
    assert got[1] == got[0]
    port = got[1]
    assert next(c for k, c in port["histories"]["xla:tiny"]
                if k == "decision")["action"] == "wait"
    assert any("agent-e2e-spec" in s for s in port["decoder_sessions"])
    assert not any("agent-e2e-spec" in s for s in port["after"])


def test_consensus_refinement_splices_session_on_both_backends(greedy):
    """Case 4 (:193): cycle 2's messages embed cycle 1's raw answer; the
    splice resumes the resident prompt and response KV, so cycle 2
    prefills only the new suffix."""
    def case(pkg):
        b = backend(pkg, ["xla:tiny"])
        engine = pkg.cengine.ConsensusEngine(b, pkg.cengine.ConsensusConfig(
            model_pool=["xla:tiny"], max_refinement_rounds=0,
            session_key="splice-e2e", constrained_json=True,
            allowed_actions={"wait"}, max_tokens=48))
        msgs = [{"role": "system",
                 "content": "Decide your next action as JSON."},
                {"role": "user", "content": "report status then continue"}]
        out1 = engine.decide({"xla:tiny": list(msgs)})
        raw = (out1.proposals[0].raw_text if out1.proposals
               else out1.failures[0].raw_text)
        eng = b.engines["xla:tiny"]
        resident = len(eng.session_tokens("splice-e2e"))
        out2 = engine.decide({"xla:tiny": msgs + [
            {"role": "assistant", "content": raw},
            {"role": "user", "content": "refine your proposal"}]})
        return {"raw": raw, "resident": resident,
                "prefill": eng.last_prefill_tokens,
                "cached": [out1.cached_tokens, out2.cached_tokens],
                "status": [out1.status, out2.status]}
    got = [case(pkg) for pkg in BOTH]
    assert got[1] == got[0]
    assert got[1]["raw"]
    assert 0 < got[1]["prefill"] < got[1]["resident"] // 2


def test_decide_tick_on_the_executor_thread_builds_no_autograd(greedy):
    """Grad mode is per thread: the tick runs on the event loop's
    executor thread (and, with overlap off, so do the members'
    forwards), which never entered no_grad itself. Every forward it
    reaches must run without autograd: no output requires grad."""
    async def main():
        b = backend(PORT, overlap=False)
        seen = []
        hooks = [e.params.layers[0].wq.register_forward_hook(
            lambda mod, args, out: seen.append(
                (threading.current_thread().name, torch.is_grad_enabled(),
                 out.requires_grad)))
            for e in b.engines.values()]
        try:
            env, core, _ = await decided_agent(PORT, b, "agent-grad",
                                               "task-grad", POOL)
            await env.sup.terminate_agent("agent-grad")
            env.close()
        finally:
            for h in hooks:
                h.remove()
        return seen
    seen = run(main(), timeout=900)
    assert seen
    threads = {n for n, _, _ in seen}
    assert threading.current_thread().name not in threads
    assert not any(g or r for _, g, r in seen)


def _wait_only_core(pkg, core):
    """The JAX file's seams on a task's agent: only ``wait`` allowed, the
    compact prompt, the output budget, two refinement rounds."""
    core.config.capability_groups = []
    core.config.forbidden_actions = wait_only(pkg)
    core.engine = core._build_engine()
    core.config.max_refinement_rounds = 2
    core._system_prompt = PROMPT
    core.engine.config.max_tokens = MAX_TOKENS


def test_pause_restore_on_both_backends_through_the_runtime(greedy,
                                                            tmp_path):
    """Case 3 (:133), through each package's ``Runtime`` over its real
    backend (``TorchBackend(device="cpu")`` and ``TPUBackend`` on the
    same weights): an agent decides and executes, its task pauses (KV
    sessions dropped), a second runtime over the same database file and
    backend restores it with the history intact, and it decides again
    after a message, re-prefilling from the history. Decisions,
    histories and each round's cached tokens equal. The members' window
    is widened from 512 to 1,024 tokens over the same weights: the
    restored tick's prompt (469 tokens with the compact system prompt)
    leaves 43 tokens of tiny's window, in which no greedy answer closes
    its JSON, and the tick then condenses and fails on both packages
    alike."""
    def case(pkg):
        async def main():
            b = backend(pkg, window=1024)
            cached, prompt = [], []
            orig = b.query

            def query(requests):
                res = orig(requests)
                cached.append({r.model_spec: r.cached_tokens for r in res})
                prompt.append({r.model_spec: r.usage.prompt_tokens
                               for r in res})
                return res
            b.query = query
            path = str(tmp_path / f"{pkg.name[-5:]}.db")
            cfg = pkg.rt.RuntimeConfig(db_path=path, encryption_key="k" * 16)
            rt = pkg.rt.Runtime(cfg, backend=b)
            w = new_watch(rt.deps)
            task_id, root = await rt.tasks.create_task(
                "decide actions on the real backend", model_pool=list(POOL))
            _wait_only_core(pkg, root)

            def decided(core):
                h = core.ctx.history(POOL[0])
                return any(e.kind == "decision" for e in h) \
                    and any(e.kind == "result" for e in h) and idle(core)
            await w.until(lambda: decided(root), timeout=300)
            out = {"before": {m: history_view(root, m) for m in POOL},
                   "status": rt.status()}
            await rt.tasks.pause_task(task_id)
            out["rounds_before_pause"] = len(cached)
            out["dropped"] = [e.sessions.get(root.agent_id) is None
                              for e in b.engines.values()]
            out["paused"] = rt.status()
            rt.close()

            rt2 = pkg.rt.Runtime(cfg, backend=b)
            w2 = new_watch(rt2.deps)
            out["restored_n"] = await rt2.tasks.restore_task(task_id)
            restored = rt2.registry.agents_for_task(task_id)[0].core
            out["restored"] = {m: history_view(restored, m) for m in POOL}
            _wait_only_core(pkg, restored)
            n0 = len([e for e in restored.ctx.history(POOL[0])
                      if e.kind == "decision"])
            restored.post({"type": "user_message", "from": "user",
                           "content": "continue deciding"})
            await w2.until(lambda: len(
                [e for e in restored.ctx.history(POOL[0])
                 if e.kind == "decision"]) > n0 and idle(restored),
                timeout=300)
            out["after"] = {m: history_view(restored, m) for m in POOL}
            await rt2.tasks.pause_task(task_id)
            out["cached"], out["prompt"] = cached, prompt
            out["costs"] = str(rt2.store.costs_for_task(task_id))
            out["final"] = rt2.status()
            rt2.close()
            return out
        return main()
    with process_hooks_restored():
        got = [run(case(pkg), timeout=900) for pkg in BOTH]
    for g in got:        # the backend's name is each package's own
        for key in ("status", "paused", "final"):
            assert g[key].pop("backend") in ("TPUBackend", "TorchBackend")
    a, b = view(got[0]), view(got[1])
    assert b == a, first_difference(a, b)
    port = got[1]
    assert port["restored"] == port["before"]
    assert all(port["dropped"]) and port["restored_n"] == 1
    decisions = [c for k, _, c in port["after"][POOL[0]] if k == "decision"]
    assert len(decisions) >= 2 and all(d["action"] == "wait"
                                       for d in decisions)
    assert list(port["paused"]["tasks"].values()) == ["paused"]
    # the restored agent re-prefilled: the pause dropped its sessions, so
    # its first round served less than the whole prompt from resident KV
    first = port["rounds_before_pause"]
    assert first >= 1 and len(port["cached"]) > first
    assert all(port["cached"][first][m] < port["prompt"][first][m]
               for m in port["prompt"][first])


def test_answer_engine_on_both_backends(greedy, monkeypatch):
    """``answer_engine`` over each package's real backend: its
    sessionless query (the dense path; flash on the card) gives the same
    text at temperature 0 (the executor samples at 0.3; the test pins
    its request to greedy and 24 tokens, as the decides' temperature is
    pinned)."""
    import types

    for pkg in BOTH:
        real = pkg.runtime.QueryRequest

        def greedy_request(*a, _real=real, **kw):
            return dataclasses.replace(_real(*a, **kw), temperature=0.0,
                                       max_tokens=24)
        monkeypatch.setattr(pkg.runtime, "QueryRequest", greedy_request)

    def case(pkg):
        async def main():
            b = backend(pkg, ["xla:tiny"])
            env = Env(pkg, b)
            core = types.SimpleNamespace(
                deps=env.deps, agent_id="agent-ae",
                config=pkg.state.AgentConfig(agent_id="agent-ae",
                                             task_id="task-ae",
                                             model_pool=["xla:tiny"]))
            res = await pkg.world.answer_engine_action(
                core, None, {"query": "what is two plus two?",
                             "focus": "arithmetic"})
            env.close()
            return res, [(c.amount > 0, c.cost_type, c.input_tokens,
                          c.output_tokens, c.description)
                         for c in env.deps.costs.entries_for("agent-ae")]
        return main()
    got = [run(case(pkg), timeout=600) for pkg in BOTH]
    assert view(got[1]) == view(got[0])
    res, costs = got[1]
    assert res["status"] == "ok" and res["answer"]
    assert res["model"] == "xla:tiny" and res["sources"] == []
    (paid, kind, _, out_tokens, what), = costs
    assert paid and kind == "model" and what == "answer_engine"
    assert 0 < out_tokens <= 24
