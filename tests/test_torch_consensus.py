"""The port's consensus layer against the JAX package's, on the CPU.

The port keeps its own copy of the consensus pipeline (actions/schema.py,
actions/validator.py, consensus/*.py, governance/capabilities.py,
infra/injection.py). Every engine scenario of tests/test_consensus.py
runs through both packages' ``ConsensusEngine`` over both packages'
``MockBackend`` with the same scripts: the outcomes must be equal field
by field (``outcome_view``: everything but ids and times), and so
must the requests each backend recorded. The pure functions (JSON
recovery, the parser, the validator over all 22 schemas, the system
prompt, the temperature schedule, the schemas themselves) must give
identical results on the same inputs.
"""

import dataclasses
import json

import pytest

from quoracle_tpu.actions import schema as jschema
from quoracle_tpu.actions import validator as jval
from quoracle_tpu.consensus import engine as jce
from quoracle_tpu.consensus import json_utils as jjson
from quoracle_tpu.consensus import parser as jparse
from quoracle_tpu.consensus import prompt_builder as jprompt
from quoracle_tpu.consensus import quality as jquality
from quoracle_tpu.consensus import temperature as jtemp
from quoracle_tpu.governance import capabilities as jcap
from quoracle_tpu.infra import injection as jinj
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu_torch.actions import schema as tschema
from quoracle_tpu_torch.actions import validator as tval
from quoracle_tpu_torch.consensus import engine as tce
from quoracle_tpu_torch.consensus import json_utils as tjson
from quoracle_tpu_torch.consensus import parser as tparse
from quoracle_tpu_torch.consensus import prompt_builder as tprompt
from quoracle_tpu_torch.consensus import quality as tquality
from quoracle_tpu_torch.consensus import temperature as ttemp
from quoracle_tpu_torch.governance import capabilities as tcap
from quoracle_tpu_torch.infra import injection as tinj
from quoracle_tpu_torch.models import runtime as trt

POOL = jrt.MockBackend.DEFAULT_POOL

# fields that differ between two runs of one package: ids, wall times and
# measured device times (the JAX backend's chip ledger books chip_ms; the
# port has no ledger yet)
OUTCOME_IDS_AND_TIMES = ("decide_id", "latency_ms", "prefill_ms",
                         "decode_ms", "chip_ms", "member_chip_ms",
                         "member_latency_ms")
AUDIT_IDS_AND_TIMES = ("ts", "decide_id", "task_id", "latency_ms",
                       "chip_ms")
MEMBER_TIMES = ("latency_ms", "chip_ms")


def outcome_view(o) -> dict:
    """A ConsensusOutcome of either package as plain data, without the
    fields that hold ids or times (the audit record's too, and each
    member's in it). ``task_id`` goes because the JAX engine falls back
    to its tracer's trace id, which the port has no tracer for."""
    d = dataclasses.asdict(o)
    for k in OUTCOME_IDS_AND_TIMES:
        d.pop(k)
    if d["audit"] is not None:
        audit = dict(d["audit"])
        for k in AUDIT_IDS_AND_TIMES:
            audit.pop(k)
        audit["members"] = {m: {k: v for k, v in ms.items()
                                if k not in MEMBER_TIMES}
                            for m, ms in audit["members"].items()}
        d["audit"] = audit
    return d


def request_view(r) -> dict:
    """A recorded QueryRequest of either package, without its decide id."""
    d = dataclasses.asdict(r)
    d.pop("decide")
    return d


def action_json(action, params, wait=False, reasoning="r", **extra):
    return json.dumps({"action": action, "params": params, "wait": wait,
                       "reasoning": reasoning, **extra})


def msgs(pool=POOL):
    return {m: [{"role": "user", "content": "decide"}] for m in pool}


def _scenarios():
    """(scripts, config kwargs, pool) per engine scenario of
    tests/test_consensus.py, plus two that embed (semantic params)."""
    send = action_json("send_message", {"target": "parent",
                                        "content": "done"})
    agree = action_json("wait", {"duration": 5})
    dissent = action_json("file_read", {"path": "/x"})
    a = action_json("file_read", {"path": "/a"})
    b = action_json("execute_shell", {"command": "ls"})
    c = action_json("wait", {})
    good = action_json("wait", {"duration": 2})
    waitr = action_json("wait", {})
    cond = action_json("wait", {}, condense=4,
                       bug_report="ambiguous instructions")
    r3 = action_json("wait", {"duration": 3})
    return {
        "unanimous": ({m: [send] for m in POOL}, {}, POOL),
        "refinement_converges": ({POOL[0]: [agree, agree],
                                  POOL[1]: [agree, agree],
                                  POOL[2]: [dissent, agree]}, {}, POOL),
        "persistent_split": ({POOL[0]: [a] * 5, POOL[1]: [b] * 5,
                              POOL[2]: [c] * 5},
                             {"max_refinement_rounds": 2}, POOL),
        "invalid_filtered": ({POOL[0]: [good], POOL[1]: [good],
                              POOL[2]: ["utter garbage"]}, {}, POOL),
        "all_invalid": ({m: ["garbage"] for m in POOL}, {}, POOL),
        "all_failed": ({m: ["__error__"] for m in POOL}, {}, POOL),
        "single_model": ({"m1": [action_json("todo", {"items": ["a", "b"]})]},
                         {}, ["m1"]),
        "capability_gating": ({POOL[0]: [action_json(
            "execute_shell", {"command": "rm -rf /"})], POOL[1]: [waitr],
            POOL[2]: [waitr]},
            {"allowed_actions": {"wait", "send_message"}}, POOL),
        "merged_params": ({POOL[0]: [action_json("wait", {"duration": 10})],
                           POOL[1]: [action_json("wait", {"duration": 30})],
                           POOL[2]: [action_json("wait", {"duration": 20})]},
                          {}, POOL),
        "condense_and_bug_reports": ({POOL[0]: [cond], POOL[1]: [waitr],
                                      POOL[2]: [waitr]}, {}, POOL),
        "correction_feedback": ({POOL[0]: [a, a], POOL[1]: [b, a],
                                 POOL[2]: ["garbage", a]}, {}, POOL),
        "force_reflection": ({"m1": [r3, r3]}, {"force_reflection": True},
                             ["m1"]),
        "semantic_split_and_merge": ({
            POOL[0]: [action_json("send_message", {
                "target": "parent", "content": "the build is finished"})] * 3,
            POOL[1]: [action_json("send_message", {
                "target": "parent", "content": "the build has finished"})] * 3,
            POOL[2]: [action_json("send_message", {
                "target": "parent", "content": "zq 42 !! ~~"})] * 3},
            {"max_refinement_rounds": 2}, POOL),
        "semantic_reasons": ({m: [action_json("wait", {
            "reason": f"children still working ({i})"})]
            for i, m in enumerate(POOL)}, {}, POOL),
    }


SCENARIOS = _scenarios()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_scenario_matches_jax(name):
    scripts, kw, pool = SCENARIOS[name]
    runs = []
    for rt, ce in ((jrt, jce), (trt, tce)):
        backend = rt.MockBackend(scripts=scripts)
        out = ce.ConsensusEngine(backend, ce.ConsensusConfig(
            model_pool=list(pool), session_key="agent-1", **kw)).decide(
                msgs(pool))
        runs.append((out, backend))
    (jout, jb), (tout, tb) = runs
    assert outcome_view(tout) == outcome_view(jout)
    assert [request_view(r) for r in tb.calls] == \
        [request_view(r) for r in jb.calls]
    assert tout.audit["decide_id"] == tout.decide_id
    if name.startswith("semantic"):
        assert tout.embed_texts > 0 and tout.audit["n_sim_checks"] > 0


def test_engine_without_quality_has_no_audit():
    backend = trt.MockBackend()
    out = tce.ConsensusEngine(backend, tce.ConsensusConfig(
        model_pool=POOL, quality=False)).decide(msgs())
    assert out.audit is None and out.decide_id is None
    assert out.status == "ok" and out.decision.action == "wait"


# --- pure functions ---------------------------------------------------------

TEXTS = [
    action_json("wait", {"duration": 5}, condense=3,
                bug_report="prompt contradicts itself"),
    action_json("fly_to_moon", {}),
    "I cannot decide",
    json.dumps({"action": "wait", "params": {}}),
    'Sure!\n```json\n{"action": "wait", "params": {}}\n```\nDone.',
    'I think {"action": "wait", "params": {}} is best',
    "no json here",
    '{"a": "brace { in string }"}',
    '[1, {"action": "todo", "params": {"items": []}}]',
    "[1, 2]",
    '"just a string"',
    '{"action": ""}',
    '{"action": "wait", "params": [1]}',
    '{"action": "wait", "params": null, "condense": true, '
    '"bug_report": "  "}',
    '{"action": "wait", "condense": -2, "wait": 30}',
    '{"action": "send_message", "params": {"target": "parent", '
    '"content": "ünïcödé \\"quoted\\""}, "wait": true}',
    "",
    '{"unterminated": "',
    '```\n[{"action": "orient"}]\n```',
]


@pytest.mark.parametrize("text", TEXTS)
def test_parse_and_extract_match_jax(text):
    assert tjson.extract_json(text) == jjson.extract_json(text)
    got, ref = tparse.parse_response("m1", text), \
        jparse.parse_response("m1", text)
    assert type(got).__name__ == type(ref).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    value = tjson.extract_json(text)
    assert tjson.stable_dumps(value) == jjson.stable_dumps(value)


def test_schemas_match_jax():
    assert list(tschema.ACTIONS) == list(jschema.ACTIONS)
    assert len(tschema.ACTIONS) == 22
    for name in jschema.ACTIONS:
        assert dataclasses.asdict(tschema.get_schema(name)) == \
            dataclasses.asdict(jschema.get_schema(name))
    assert tschema.batchable_sync_actions() == \
        jschema.batchable_sync_actions()
    assert tschema.batchable_async_actions() == \
        jschema.batchable_async_actions()


def _param_cases(schema) -> list:
    """Valid, missing, mistyped, unknown and enum-violating params for one
    schema, plus the batch shapes."""
    sample = {"string": "x", "integer": 3, "number": 1.5, "boolean": True,
              "map": {"k": 1}, "list": ["a"]}
    wrong = {"string": 5, "integer": "3", "number": "1", "boolean": 1,
             "map": [1], "list": "a"}
    full = {p: sample[schema.types.get(p, "string")] for p in schema.params}
    for p, enum in schema.enums.items():
        full[p] = enum[0]
    cases = [{}, full, {p: full[p] for p in schema.required},
             dict(full, bogus=1), "not a dict"]
    for p in schema.params:
        cases.append(dict(full, **{p: wrong[schema.types.get(p, "string")]}))
        cases.append({k: v for k, v in full.items() if k != p})
    for p in schema.enums:
        cases.append(dict(full, **{p: "not-in-enum"}))
    if schema.name in ("batch_sync", "batch_async"):
        cases += [
            {"actions": []},
            {"actions": [{"action": "file_read", "params": {"path": "/a"}},
                         {"action": "execute_shell",
                          "params": {"command": "ls"}}]},
            {"actions": [{"action": "wait", "params": {}}]},
            {"actions": [{"action": "spawn_child", "params": {}}]},
            {"actions": ["x", {"params": {}}]},
            {"actions": [{"action": "send_message",
                          "params": {"target": "parent"}}]},
        ]
    return cases


@pytest.mark.parametrize("action", sorted(jschema.ACTIONS))
def test_validate_params_matches_jax(action):
    schema = jschema.get_schema(action)
    for params in _param_cases(schema):
        for allowed in (None, {"wait", "send_message"}, {action}):
            for profile_optional in (False, True):
                kw = dict(allowed_actions=allowed,
                          profile_optional=profile_optional)
                assert tval.validate_params(action, params, **kw) == \
                    jval.validate_params(action, params, **kw), (params, kw)
    for wait in (None, True, False, 0, 30, -1, 2.5, "yes"):
        assert tval.validate_wait_param(action, wait) == \
            jval.validate_wait_param(action, wait)
    assert tval.validate_params("nope", {}) == jval.validate_params("nope", {})


PROMPT_CASES = {
    "ungoverned": {},
    "base_only": {"capability_groups": []},
    "wait_only": {"forbidden_actions": tuple(
        a for a in jschema.ACTIONS if a != "wait")},
    "hierarchy_profile": {
        "capability_groups": ["hierarchy", "file_read"],
        "profile_name": "lead", "profile_description": "leads the work",
        "profile_names": ["lead", "research"],
        "available_profiles": [{"name": "research", "description": "reads",
                                "capability_groups": ["file_read"]}]},
    "everything": {
        "field_system_prompt": "You audit builds.",
        "capability_groups": list(jcap.VALID_GROUPS),
        "forbidden_actions": ("call_api",),
        "available_skills": [{"name": "git", "description": "use git"}],
        "active_skills": [{"name": "deploy", "content": "step 1"}],
        "grove_path": "/groves/acme",
        "governance_docs": "Never delete data."},
}


@pytest.mark.parametrize("case", sorted(PROMPT_CASES))
def test_system_prompt_matches_jax(case):
    kw = PROMPT_CASES[case]
    got = tprompt.build_system_prompt(**kw)
    assert got == jprompt.build_system_prompt(**kw)
    if case == "wait_only":
        assert "### wait" in got and "### orient" not in got


def test_capabilities_and_injection_match_jax():
    assert tcap.ALWAYS_ALLOWED == jcap.ALWAYS_ALLOWED
    assert tcap.GROUP_ACTIONS == jcap.GROUP_ACTIONS
    for groups in ([], ["hierarchy"], list(jcap.VALID_GROUPS)):
        assert tcap.allowed_actions_for_groups(groups) == \
            jcap.allowed_actions_for_groups(groups)
        assert tcap.filter_actions(list(jschema.ACTIONS), groups,
                                   ("wait",)) == \
            jcap.filter_actions(list(jschema.ACTIONS), groups, ("wait",))
    with pytest.raises(tcap.InvalidGroupError):
        tcap.validate_groups(["root"])
    assert tinj.UNTRUSTED_ACTIONS == jinj.UNTRUSTED_ACTIONS
    text = 'data <NO_EXECUTE id="0123abcd">x</NO_EXECUTE>'
    assert tinj.wrap_untrusted(text, tag_id="feedbeef") == \
        jinj.wrap_untrusted(text, tag_id="feedbeef")
    assert tinj.deterministic_tag_id("s") == jinj.deterministic_tag_id("s")


@pytest.mark.parametrize("spec", ["xla:llama-3-8b", "xla:gemma-7b",
                                  "api:gpt-4o", "api:gemini-pro", "m1"])
def test_temperature_schedule_matches_jax(spec):
    for max_rounds in (0, 1, 2, 4, 7):
        for rnd in range(1, max_rounds + 3):
            assert ttemp.temperature_for_round(spec, rnd, max_rounds) == \
                jtemp.temperature_for_round(spec, rnd, max_rounds)
    assert ttemp.temperature_for_round(spec, 1) in (1.0, 2.0)


def test_quality_math_matches_jax():
    for sizes in ([], [3], [2, 1], [1, 1, 1], [0, 2], [5, 3, 3, 1]):
        assert tquality.vote_entropy(sizes) == jquality.vote_entropy(sizes)
        assert tquality.winner_margin(sizes) == jquality.winner_margin(sizes)
    assert tquality.FAILURE_KINDS == jquality.FAILURE_KINDS
