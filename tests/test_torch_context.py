"""The port's context layer against the JAX package's: tests/
test_context.py's 20 cases (histories, token counts, condensation with a
scripted reflect function, per-model messages, lessons, the reflector)
and tests/test_history_transfer.py's (pool switches), each run through
both packages on the same inputs, the observations compared exactly
(pure-Python copies). The JAX file's pause-and-restore case needs the
persistence layer, which the port does not have yet; its stand-in here
restarts the agent from its context (``AgentConfig.restored_context``)."""

import numpy as np
import pytest

from _agent_parity import (
    WAIT_FOREVER, both, idle, install_watch, j, new_watch, run, view,
)

POOL = ["mock:consensus-model-1", "mock:consensus-model-2",
        "mock:consensus-model-3"]
NEW_POOL = ["mock:new-model-a", "mock:new-model-b"]


def chars_counter(spec, text):
    return len(text)


def make_tm(pkg, limit=100, count=chars_counter):
    return pkg.tm.TokenManager(count, context_limit_fn=lambda s: limit)


def fake_reflect(pkg):
    def fn(model_spec, entries):
        return pkg.reflector.Reflection(
            lessons=[pkg.history.Lesson(type="factual", content="fact-1")],
            state=["halfway done"],
            summary_text=f"condensed {len(entries)} entries")
    return fn


class FakeEmbedder:
    """Deterministic across processes: the text's bytes seed the vector."""
    def embed(self, texts):
        out = []
        for t in texts:
            rng = np.random.default_rng(sum(t.encode()) * 7919 + len(t))
            v = rng.normal(size=16)
            out.append(v / np.linalg.norm(v))
        return out


def entry(pkg, kind, content, **kw):
    return pkg.history.HistoryEntry(kind, content, ts=0.0, **kw)


def hist(ctx, model):
    return [(e.kind, e.action_type, e.content) for e in ctx.history(model)]


def lessons(ctx, model):
    return [(l.type, l.content, l.confidence)
            for l in ctx.context_lessons.get(model, [])]


# ----------------------------------------------------------- token manager

def test_history_tokens_and_should_condense():
    def case(pkg):
        tm = make_tm(pkg, limit=10)
        h = [entry(pkg, "user", "abcde"), entry(pkg, "user", "fghij")]
        return [tm.history_tokens("m", h), tm.should_condense("m", h),
                tm.should_condense("m", h[:1]), tm.usage_fraction("m", h),
                tm.messages_tokens("m", [{"role": "user", "content": "ab"},
                                         {"role": "user", "content": [
                                             {"type": "text",
                                              "text": "xyz"}]}])]
    assert both(case)[:3] == [10, True, False]


def test_split_for_condensation_80pct_keeps_tail():
    def case(pkg):
        tm = make_tm(pkg, limit=1000)
        h = [entry(pkg, "user", "x" * 10) for _ in range(10)]
        removed, kept = tm.split_for_condensation("m", h)
        return [len(removed), len(kept), kept == h[8:]]
    assert both(case) == [8, 2, True]


def test_split_never_removes_below_two():
    def case(pkg):
        tm = make_tm(pkg)
        h = [entry(pkg, "user", "a"), entry(pkg, "user", "b")]
        removed, kept = tm.split_for_condensation("m", h)
        return [removed, len(kept)]
    assert both(case) == [[], 2]


def test_dynamic_max_tokens_floor():
    def case(pkg):
        tm = make_tm(pkg, limit=8192)
        small = make_tm(pkg, limit=512)
        return [tm.dynamic_max_tokens("m", 1000, 4096),
                tm.dynamic_max_tokens("m", 8000, 4096),
                small.dynamic_max_tokens("m", 300, 128),
                pkg.tm.TokenManager(chars_counter).context_limit("m")]
    assert both(case) == [4096, None, 128, 128_000]


# -------------------------------------------------------- context manager

def test_build_conversation_merges_roles_and_formats_kinds():
    def case(pkg):
        h = [entry(pkg, "user", "hello"), entry(pkg, "user", "again"),
             entry(pkg, "decision", {"action": "todo", "params": {}}),
             entry(pkg, "result", {"status": "ok"}, action_type="todo"),
             entry(pkg, "result", {"image_base64": "QUJD", "n": 1},
                   action_type="fetch_web"),
             entry(pkg, "summary", "old stuff")]
        return pkg.context_manager.build_conversation_messages(
            h, context_summary="SUM", additional_context="MORE")
    msgs = both(case)
    assert [m["role"] for m in msgs] == ["user", "assistant", "user"]
    assert "hello\n\nagain" in msgs[0]["content"]
    assert "[DECISION]" in msgs[1]["content"]
    assert isinstance(msgs[2]["content"], list)      # the image part


def test_build_conversation_trailing_assistant_gets_continue():
    def case(pkg):
        return [pkg.context_manager.build_conversation_messages(
            [entry(pkg, "decision", {"action": "wait"})]),
            pkg.context_manager.build_conversation_messages([])]
    got = both(case)
    assert got[0][-1] == {"role": "user", "content": "(continue)"}


# --------------------------------------------------------- message builder

def test_injection_order():
    def case(pkg):
        ctx = pkg.history.AgentContext()
        ctx.append("m", entry(pkg, "user", "first message"))
        ctx.append("m", entry(pkg, "user", "second message"))
        ctx.context_lessons["m"] = [pkg.history.Lesson(
            type="factual", content="ACE-LESSON")]
        ctx.model_states["m"] = ["ACE-STATE"]
        ctx.todos = [{"task": "t1"}]
        ctx.children = [{"agent_id": "c1"}]
        ctx.budget_snapshot = {"available": "5"}
        ctx.correction_feedback["m"] = "FIX-THIS"
        return pkg.message_builder.build_messages_for_model(
            ctx, "m", system_prompt="SYSTEM", refinement_prompt="REFINE",
            token_manager=make_tm(pkg, limit=10000))
    msgs = both(case)
    assert msgs[0] == {"role": "system", "content": "SYSTEM"}
    assert msgs[1]["content"].startswith("[ACCUMULATED CONTEXT")
    last = msgs[-1]["content"]
    assert last.startswith("[CORRECTION")
    assert last.index("REFINE") < last.index("[CURRENT TODO LIST]") \
        < last.index("[ACTIVE CHILD AGENTS]") < last.index("[BUDGET]")
    assert "[CONTEXT:" in last and last.rstrip().endswith("]")


def test_no_optional_sections_minimal_messages():
    def case(pkg):
        ctx = pkg.history.AgentContext()
        ctx.append("m", entry(pkg, "user", "hi"))
        return pkg.message_builder.build_messages_for_model(ctx, "m")
    assert both(case) == [{"role": "user", "content": "hi"}]


# ----------------------------------------------------------- condensation

def test_inline_condense_clamps_and_summarizes():
    def case(pkg):
        ctx = pkg.history.AgentContext()
        for i in range(5):
            ctx.append("m", entry(pkg, "user", f"msg{i}"))
        res = pkg.condensation.inline_condense(ctx, "m", n=10,
                                               reflect_fn=fake_reflect(pkg))
        h = ctx.history("m")
        h[0].ts = 0.0
        return {"res": res, "hist": hist(ctx, "m"),
                "states": ctx.model_states, "lessons": lessons(ctx, "m")}
    got = both(case)
    assert got["res"].removed_entries == 3
    assert got["hist"][0] == ("summary", None, "condensed 3 entries")


def test_inline_condense_too_short_noop():
    def case(pkg):
        ctx = pkg.history.AgentContext()
        ctx.append("m", entry(pkg, "user", "a"))
        return [pkg.condensation.inline_condense(
            ctx, "m", n=1, reflect_fn=fake_reflect(pkg)).condensed,
            pkg.condensation.inline_condense(
            ctx, "m", n=0, reflect_fn=fake_reflect(pkg)).condensed]
    assert both(case) == [False, False]


def test_condense_for_tokens_shrinks_with_embedder_dedupe():
    def case(pkg):
        ctx = pkg.history.AgentContext()
        for _ in range(10):
            ctx.append("m", entry(pkg, "user", "x" * 10))
        ctx.context_lessons["m"] = [pkg.history.Lesson(
            type="factual", content="fact-1")]
        tm = make_tm(pkg, limit=50)
        before = tm.history_tokens("m", ctx.history("m"))
        res = pkg.condensation.condense_for_tokens(
            ctx, "m", tm, fake_reflect(pkg), embedder=FakeEmbedder())
        return {"res": res, "before": before,
                "after": tm.history_tokens("m", ctx.history("m")),
                "lessons": lessons(ctx, "m")}
    got = both(case)
    assert got["after"] < got["before"]
    assert got["lessons"] == [("factual", "fact-1", 2)]   # merged


def test_ensure_fits_condenses_until_budget():
    def case(pkg):
        ctx = pkg.history.AgentContext()
        for _ in range(20):
            ctx.append("m", entry(pkg, "user", "y" * 50))
        tm = make_tm(pkg, limit=600)
        budget = pkg.condensation.ensure_fits(ctx, "m", tm, fake_reflect(pkg),
                                              output_limit=128)
        return [budget, [e.kind for e in ctx.history("m")]]
    got = both(case)
    assert got[0] == 128 and "summary" in got[1]


def test_ensure_fits_stops_without_progress():
    def case(pkg):
        calls = []

        def reflect_fn(spec, entries):
            calls.append(len(entries))
            return pkg.reflector.Reflection(
                lessons=[], state=[], summary_text="x" * sum(
                    len(e.as_text()) for e in entries))
        ctx = pkg.history.AgentContext()
        ctx.model_histories["m"] = [entry(pkg, "user", "a" * 400),
                                    entry(pkg, "user", "b" * 4000),
                                    entry(pkg, "user", "c" * 4000)]
        tm = make_tm(pkg, limit=2000)
        return [pkg.condensation.ensure_fits(ctx, "m", tm, reflect_fn,
                                             output_limit=512), calls]
    got = both(case)
    assert got[0] is None and len(got[1]) <= 2


def test_make_reflect_fn_degrades_settings_lookup_and_records_costs():
    """The production reflect seam: the summarization model is read
    lazily (a failing lookup degrades to the reflecting model) and every
    paid query reaches cost_fn."""
    def case(pkg):
        good = ('{"lessons": [{"type": "behavioral", "content": "b"}], '
                '"state": [{"summary": "s"}]}')
        backend = pkg.runtime.MockBackend(respond=lambda r: good)
        costs = []

        def boom():
            raise RuntimeError("settings down")
        fn = pkg.condensation.make_reflect_fn(
            backend, summarization_model_fn=boom,
            cost_fn=lambda m, u: costs.append((m, u.prompt_tokens)))
        r = fn("mock:m", [entry(pkg, "user", "x")])
        return [r, costs, [c.model_spec for c in backend.calls]]
    got = both(case)
    assert got[0].state == ["s"] and len(got[1]) == 1


# ---------------------------------------------------------------- lessons

def test_lessons_dedup_merges_confidence():
    def case(pkg):
        L, acc, emb = pkg.history.Lesson, pkg.lessons.accumulate_lessons, \
            FakeEmbedder()
        existing = acc([], [L(type="factual", content="A")], emb)
        merged = acc(existing, [L(type="factual", content="A")], emb)
        merged2 = acc(merged, [L(type="factual", content="B")], emb)
        return [[(l.content, l.confidence) for l in x]
                for x in (existing, merged, merged2)] + [
            acc(merged2, [], emb) == merged2]
    got = both(case)
    assert got[1] == [("A", 2)] and len(got[2]) == 2


def test_lessons_prune_keeps_high_confidence():
    def case(pkg):
        existing = [pkg.history.Lesson(type="factual", content=f"L{i}",
                                       confidence=i,
                                       embedding=np.eye(16)[i % 16])
                    for i in range(5)]
        out = pkg.lessons.accumulate_lessons(
            existing, [pkg.history.Lesson(type="factual", content="NEW")],
            FakeEmbedder(), max_lessons=3)
        return [(l.content, l.confidence) for l in out]
    assert len(both(case)) == 3


def test_lesson_prune_ties_keep_newest():
    def case(pkg):
        class OrthoEmbedder:
            def __init__(self):
                self.seen = {}

            def embed(self, texts):
                out = []
                for t in texts:
                    i = self.seen.setdefault(t, len(self.seen))
                    v = np.zeros(512, dtype=np.float32)
                    v[i] = 1.0
                    out.append(v)
                return out
        emb = OrthoEmbedder()
        L = pkg.history.Lesson
        existing = pkg.lessons.accumulate_lessons(
            [], [L(type="factual", content=f"old fact {i}")
                 for i in range(100)], emb)
        out = pkg.lessons.accumulate_lessons(
            existing, [L(type="factual", content="brand new fact")], emb)
        return [l.content for l in out]
    got = both(case)
    assert len(got) == 100 and "brand new fact" in got


# --------------------------------------------------------------- reflector

def test_reflector_parse_valid_and_invalid():
    def case(pkg):
        p = pkg.reflector._parse
        raw = ('```json\n{"lessons": [{"type": "factual", "content": "f"},'
               ' {"type": "bogus", "content": "x"}], "state": '
               '[{"summary": "s"}, "plain"]}\n```')
        return [p(raw), p("not json at all"), p('{"lessons": "wrong"}'),
                p('{"lessons": [], "state": []}')]
    got = both(case)
    assert got[0].lessons[0].content == "f" and got[0].state == ["s", "plain"]
    assert got[1] is None and got[2] is None


def test_reflector_retries_then_gives_up():
    def case(pkg):
        backend = pkg.runtime.MockBackend(scripts={"mock:m": [
            "garbage", "more garbage", "still garbage"]})
        r = pkg.reflector.reflect(backend, "mock:m",
                                  [entry(pkg, "user", "x")])
        return [r, [[m["content"][:40] for m in c.messages]
                    for c in backend.calls]]
    got = both(case)
    assert got[0].lessons == [] and "unavailable" in got[0].summary_text
    assert len(got[1]) == 3


def test_reflector_presummarizes_oversized_history():
    def case(pkg):
        good = ('{"lessons": [{"type": "factual", "content": "l"}], '
                '"state": [{"summary": "fine"}]}')
        seen = {"condense": [], "reflect_prompts": []}

        def respond(r):
            joined = "\n".join(str(m.get("content", "")) for m in r.messages)
            if "Condense this conversation excerpt" in joined:
                seen["condense"].append(r.model_spec)
                return "CONDENSED-PIECE"
            seen["reflect_prompts"].append(joined)
            return good
        backend = pkg.runtime.MockBackend(respond=respond,
                                          context_window_tokens=4096)
        blob = "log line with details. " * 3000
        r = pkg.reflector.reflect(backend, "mock:m",
                                  [entry(pkg, "user", blob)],
                                  summarization_model="mock:summarizer")
        short = pkg.reflector.reflect(backend, "mock:m",
                                      [entry(pkg, "user", "short")],
                                      summarization_model="mock:summarizer")
        return {"r": r, "short": short, "condense": seen["condense"],
                "blob_in": blob in seen["reflect_prompts"][0],
                "prompts": seen["reflect_prompts"]}
    got = both(case)
    assert got["r"].state == ["fine"] and len(got["condense"]) >= 2
    assert set(got["condense"]) == {"mock:summarizer"}
    assert not got["blob_in"]


def test_reflector_presummarize_failure_degrades_to_truncation():
    def case(pkg):
        good = '{"lessons": [], "state": [{"summary": "ok"}]}'
        prompts = []

        def respond(r):
            joined = "\n".join(str(m.get("content", "")) for m in r.messages)
            if "Condense this conversation excerpt" in joined:
                return "__error__"
            prompts.append(joined)
            return good
        backend = pkg.runtime.MockBackend(respond=respond,
                                          context_window_tokens=4096)
        r = pkg.reflector.reflect(backend, "mock:m",
                                  [entry(pkg, "user", "x" * 200_000)])
        return [r, prompts]
    got = both(case)
    assert got[0].state == ["ok"]
    assert "truncated for reflection" in got[1][0]


# --------------------------------------------------------- pool switching

def reflect_stub(pkg):
    def fn(model_spec, entries):
        return pkg.reflector.Reflection(
            summary_text=f"[summary of {len(entries)} entries]",
            lessons=[], state=[])
    return fn


def char_tm(pkg, limits):
    return pkg.tm.TokenManager(lambda spec, text: max(1, len(text) // 4),
                               context_limit_fn=lambda spec: limits[spec])


def test_largest_fitting_history_is_chosen():
    def case(pkg):
        ctx = pkg.history.AgentContext()
        ctx.model_histories["old-a"] = [
            entry(pkg, "user", "x" * 400) for _ in range(5)]
        ctx.model_histories["old-b"] = [entry(pkg, "user", "short")]
        ctx.context_lessons["old-a"] = [pkg.history.Lesson(
            type="factual", content="A fact")]
        ctx.model_states["old-a"] = ["state summary"]
        ctx.correction_feedback = {"old-a": "x", "new-1": "y"}
        tm = char_tm(pkg, {"old-a": 100_000, "old-b": 100_000,
                           "new-1": 100_000})
        report = pkg.history_transfer.transfer_histories(
            ctx, ["old-a", "old-b"], ["new-1"], tm, reflect_stub(pkg),
            output_limit_fn=lambda spec: 4096)
        return {"report": report, "keys": sorted(ctx.model_histories),
                "n": len(ctx.model_histories["new-1"]),
                "lessons": lessons(ctx, "new-1"),
                "states": ctx.model_states, "fb": ctx.correction_feedback}
    got = both(case)
    assert got["report"].source_for == {"new-1": "old-a"}
    assert got["keys"] == ["new-1"] and got["n"] == 5


def test_nonfitting_history_condenses_until_fits():
    def case(pkg):
        ctx = pkg.history.AgentContext()
        ctx.model_histories["old-a"] = [
            entry(pkg, "user", "y" * 400) for _ in range(30)]
        tm = char_tm(pkg, {"old-a": 100_000, "new-1": 2000})
        report = pkg.history_transfer.transfer_histories(
            ctx, ["old-a"], ["new-1"], tm, reflect_stub(pkg),
            output_limit_fn=lambda spec: 500)
        tokens = tm.history_tokens("new-1", ctx.model_histories["new-1"])
        return {"report": report,
                "fits": tm.dynamic_max_tokens("new-1", tokens, 500),
                "head": ctx.model_histories["new-1"][0].kind}
    got = both(case)
    assert got["report"].condensed == {"new-1": True}
    assert got["fits"] is not None and got["head"] == "summary"


def test_kept_model_retains_its_own_history():
    def case(pkg):
        ctx = pkg.history.AgentContext()
        ctx.model_histories["shared"] = [entry(pkg, "user", "mine")]
        ctx.model_histories["old-b"] = [entry(pkg, "user", "w" * 4000)]
        tm = char_tm(pkg, {"shared": 100_000, "old-b": 100_000,
                           "new-1": 100_000})
        pkg.history_transfer.transfer_histories(
            ctx, ["shared", "old-b"], ["shared", "new-1"], tm,
            reflect_stub(pkg), output_limit_fn=lambda spec: 4096)
        return {m: hist(ctx, m) for m in sorted(ctx.model_histories)}
    got = both(case)
    assert got["shared"] == [("user", None, "mine")]
    assert sorted(got) == ["new-1", "shared"]


@pytest.fixture
def watched(monkeypatch):
    install_watch(monkeypatch)


def _switching_agent(pkg, restart: bool):
    class DropRecordingBackend(pkg.runtime.MockBackend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.dropped_sessions = []

        def drop_session(self, session_id, model_specs=None):
            self.dropped_sessions.append((session_id, model_specs))

    async def main():
        backend = DropRecordingBackend(
            scripts={m: [j("todo", {"items": [{"task": "t", "done": False}]})]
                     for m in POOL + NEW_POOL},
            respond=lambda r: WAIT_FOREVER)
        deps = pkg.state.AgentDeps.for_tests(backend)
        sup = pkg.supervisor.AgentSupervisor(deps)
        w = new_watch(deps)
        core = await sup.start_agent(pkg.state.AgentConfig(
            agent_id="agent-switch", task_id="task-1",
            model_pool=list(POOL)))
        core.post({"type": "user_message", "content": "do something",
                   "from": "user"})
        await w.until(lambda: any(e.kind == "decision"
                                  for e in core.ctx.history(POOL[0]))
                      and idle(core))
        core.post({"type": "switch_model_pool", "model_pool": list(NEW_POOL)})
        await w.until(lambda: core.config.model_pool == NEW_POOL
                      and idle(core))
        out = {"keys": sorted(core.ctx.model_histories),
               "hist": {m: [e.kind for e in core.ctx.history(m)]
                        for m in NEW_POOL},
               "dropped": [(s, sorted(m)) for s, m in
                           backend.dropped_sessions],
               "engine_pool": core.engine.config.model_pool}
        if restart:
            ctx = core.ctx
            await sup.terminate_agent("agent-switch")
            core = await sup.start_agent(pkg.state.AgentConfig(
                agent_id="agent-switch", task_id="task-1",
                model_pool=list(NEW_POOL), restored_context=ctx))
        n_before = len(backend.calls)
        core.post({"type": "user_message", "content": "again", "from": "u"})
        await w.until(lambda: len(backend.calls) > n_before and idle(core))
        out["after"] = sorted({c.model_spec
                               for c in backend.calls[n_before:]})
        out["decisions"] = {m: [view(e.content) for e in core.ctx.history(m)
                                if e.kind == "decision"] for m in NEW_POOL}
        await sup.terminate_agent("agent-switch")
        return out
    return run(main())


def test_switch_model_pool_preserves_context_and_drops_sessions(watched):
    got = both(lambda pkg: _switching_agent(pkg, restart=False))
    assert got["keys"] == sorted(NEW_POOL)
    assert all("user" in k and "decision" in k for k in got["hist"].values())
    assert got["dropped"] == [("agent-switch", sorted(POOL + NEW_POOL))]
    assert got["after"] == sorted(NEW_POOL)


def test_switch_survives_stop_and_restart_from_context(watched):
    """The pool switch survives stopping the agent and starting it again
    from its context (the restore path, without the persistence layer):
    the restarted agent decides over the new pool with the transferred
    history."""
    got = both(lambda pkg: _switching_agent(pkg, restart=True))
    assert got["after"] == sorted(NEW_POOL)
    # the transferred todo and wait, then the new pool's own todo and wait
    assert all([x["action"] for x in d] == ["todo", "wait", "todo", "wait"]
               for d in got["decisions"].values()), got["decisions"]
