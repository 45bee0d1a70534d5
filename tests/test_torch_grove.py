"""The port's groves (``quoracle_tpu_torch/governance/grove.py``) and the
two subsets it reads and validates with (``governance/frontmatter.py``,
``governance/jsonschema_lite.py``) against the JAX package's grove,
PyYAML and ``jsonschema``, on the CPU.

tests/test_governance_grove.py's fourteen cases, tests/test_mmlu_grove.py's
four and tests/test_livebench_grove.py's five run through both packages
(each over its own ``MockBackend``) and must agree, ids and times
dropped: manifests, hard rules, confinement (strict, warn, the symlink
escape, relative patterns, the tree root as working dir), schema
verdicts and their messages, spawn topology, governance docs, bootstrap,
skills, and live trees inside a grove. The shipped groves'
``scripts/score_run.py`` imports the JAX package's scoring module, so the
test runs it over each package's workspace; the port never imports it.

The frontmatter reader is held to ``yaml.safe_load`` over every
GROVE.md and SKILL.md in the repository, the fixtures here and
hypothesis-generated documents inside the subset, and must raise on
constructs outside it; its writer to ``yaml.safe_dump``. The schema
subset's verdicts and messages are held to ``jsonschema.validate``.

No test waits on a clock: trees are awaited through tests/_agent_parity.py's
``Watch``, which wakes on every handled mailbox message and broadcast."""

import glob
import importlib.util
import json
import math
import os
import re
import shutil
import string

import jsonschema
import pytest
import yaml
from hypothesis import HealthCheck, given, settings, strategies as st

from _agent_parity import (
    BOTH, PORT, both, idle, install_watch, j, new_watch,
    process_hooks_restored, run,
)
from quoracle_tpu_torch.governance import frontmatter, jsonschema_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL = ["mock:consensus-model-1", "mock:consensus-model-2",
        "mock:consensus-model-3"]


@pytest.fixture(autouse=True)
def watched(monkeypatch):
    install_watch(monkeypatch)
    for pkg in BOTH:
        pkg.treeobs.reset()
    with process_hooks_restored():
        yield


GROVE_MD = """---
name: bench-grove
description: test grove
version: "1.0"
topology:
  root: coordinator
  edges:
    - parent: coordinator
      child: worker
      auto_inject:
        skills: [worker-skill]
        constraints: "Answer only from provided data."
governance:
  hard_rules:
    - type: shell_pattern_block
      pattern: "curl|wget"
      message: "no network"
      scope: [worker]
    - type: action_block
      actions: [fetch_web, call_api]
      message: "no external sources"
      scope: [worker]
  injections:
    - source: governance/integrity.md
      inject_into: [coordinator, worker]
      priority: high
schemas:
  - name: report
    definition: schemas/report.schema.json
    validate_on: file_write
    path_pattern: "{ws}/runs/*/report.json"
workspace: "{ws}"
confinement_mode: {mode}
confinement:
  worker:
    paths:
      - {ws}/runs/**
    read_only_paths:
      - {ws}/data/**
bootstrap:
  skills: [coord-skill]
  role: "Benchmark Coordinator"
  cognitive_style: systematic
  task_description_file: bootstrap/task.md
---
"""
WORKER_SKILL = ("---\nname: worker-skill\ndescription: how to answer\n---\n\n"
                "Always answer with a single letter.")
COORD_SKILL = ("---\nname: coord-skill\ndescription: how to coordinate\n"
               "---\n\nSpawn one worker per question.")
REL_GROVE_MD = """---
name: rel-grove
workspace: "{ws}"
confinement_mode: strict
confinement:
  solo:
    paths: ["runs/**"]
---
"""
MULTI_GROVE_MD = """---
name: multi-grove
topology:
  root: boss
  edges:
    - parent: boss
      child: worker
    - parent: boss
      child: reviewer
---
"""


def write_grove(tmp_path, *, confinement_mode="strict"):
    """tests/test_governance_grove.py's ``write_grove``."""
    g = tmp_path / "bench-grove"
    g.mkdir(parents=True)
    ws = tmp_path / "workspace"
    ws.mkdir()
    (g / "GROVE.md").write_text(GROVE_MD.format(ws=ws,
                                                mode=confinement_mode))
    (g / "governance").mkdir()
    (g / "governance" / "integrity.md").write_text(
        "Never fabricate results.")
    (g / "schemas").mkdir()
    (g / "schemas" / "report.schema.json").write_text(json.dumps({
        "type": "object", "required": ["score"],
        "properties": {"score": {"type": "number"}}}))
    (g / "bootstrap").mkdir()
    (g / "bootstrap" / "task.md").write_text("Run the benchmark end to end.")
    for name, text in (("worker-skill", WORKER_SKILL),
                       ("coord-skill", COORD_SKILL)):
        (g / "skills" / name).mkdir(parents=True)
        (g / "skills" / name / "SKILL.md").write_text(text)
    return str(g), str(ws)


def enforcer(pkg, path):
    return pkg.grove.GroveEnforcer(pkg.grove.load_grove(path))


# ---------------------------------------------------------------------------
# Manifest + enforcement units (tests/test_governance_grove.py)
# ---------------------------------------------------------------------------

def test_load_grove_manifest(tmp_path):
    path, ws = write_grove(tmp_path)

    def case(pkg):
        with pytest.raises(pkg.grove.GroveError):
            pkg.grove.load_grove(str(tmp_path / "nope"))
        return {"manifest": pkg.grove.load_grove(path),
                "listed": pkg.grove.list_groves(str(tmp_path))}
    port = both(case)
    m = port["manifest"]
    assert (m.name, m.root_node, m.confinement_mode) == (
        "bench-grove", "coordinator", "strict")
    assert m.edges[0].auto_inject["skills"] == ["worker-skill"]
    assert len(m.hard_rules) == 2
    assert [g.name for g in port["listed"]] == ["bench-grove"]


def test_hard_rules_scoped_by_node(tmp_path):
    path, ws = write_grove(tmp_path)

    def case(pkg):
        enf = enforcer(pkg, path)
        return {"shell": [enf.check_shell_command(c, n) for c, n in (
                    ("curl http://x", "worker"), ("wget x", "worker"),
                    ("curl http://x", "coordinator"), ("echo hi", "worker"),
                    ("curl x", None))],
                "blocked": [sorted(enf.blocked_actions(n))
                            for n in ("worker", "coordinator", None)]}
    port = both(case)
    assert port["shell"][0] and "no network" in port["shell"][1]
    assert port["shell"][2:] == [None, None, None]
    assert port["blocked"] == [["call_api", "fetch_web"], [], []]


def test_confinement_strict_and_warn(tmp_path):
    path, ws = write_grove(tmp_path)
    (tmp_path / "warn").mkdir()
    warn_path, warn_ws = write_grove(tmp_path / "warn",
                                     confinement_mode="warn")

    def case(pkg):
        enf = enforcer(pkg, path)
        checks = [(f"{ws}/runs/r1/report.json", True, "worker"),
                  (f"{ws}/data/q.json", True, "worker"),
                  (f"{ws}/data/q.json", False, "worker"),
                  ("/etc/passwd", False, "worker"),
                  ("/etc/passwd", True, "coordinator")]
        return {"strict": [enf.check_file_path(p, write=w, node=n)
                           for p, w, n in checks],
                "warn": enforcer(pkg, warn_path).check_file_path(
                    "/etc/passwd", write=True, node="worker")}
    port = both(case)
    s = port["strict"]
    assert s[0] is None and s[1] and s[2] is None and s[3] and s[4] is None
    assert port["warn"] is None


def test_confinement_blocks_symlink_escape(tmp_path):
    path, ws = write_grove(tmp_path)
    runs = os.path.join(ws, "runs")
    os.makedirs(runs, exist_ok=True)
    os.symlink("/etc", os.path.join(runs, "sneaky"))
    port = both(lambda pkg: enforcer(pkg, path).check_file_path(
        os.path.join(runs, "sneaky", "passwd"), write=True, node="worker"))
    assert port and "outside the allowed paths" in port


def test_schema_validation_on_file_write(tmp_path):
    path, ws = write_grove(tmp_path)
    target = f"{ws}/runs/r1/report.json"
    payloads = [(target, '{"score": 0.93}'), (target, '{"wrong": 1}'),
                (target, '{"score": "high"}'), (target, "not json"),
                (target, "[1, 2]"), (f"{ws}/runs/r1/notes.txt", "not json")]

    def case(pkg):
        enf = enforcer(pkg, path)
        return [enf.validate_file_schema(p, c) for p, c in payloads]
    port = both(case)
    assert port[0] is None and "score" in port[1]
    assert port[2] == "schema report: 'high' is not of type 'number'"
    assert "not JSON" in port[3] and port[5] is None


def test_topology_resolution_and_governance_docs(tmp_path):
    path, ws = write_grove(tmp_path)

    def case(pkg):
        enf = enforcer(pkg, path)
        with pytest.raises(pkg.grove.GroveError) as leaf:
            enf.resolve_spawn("worker", {})
        return {"spawn": enf.resolve_spawn("coordinator", {}),
                "outside": enf.resolve_spawn(None, {}),
                "leaf": str(leaf.value),
                "docs": [enf.governance_docs_for(n)
                         for n in ("worker", "coordinator", None)],
                "boot": enf.bootstrap_fields(),
                "workspace": enf.workspace_dir(),
                "skills": enf.skills_loader().listing()}
    port = both(case)
    assert port["spawn"].node == "worker"
    assert port["spawn"].skills == ("worker-skill",)
    assert port["spawn"].constraints == "Answer only from provided data."
    assert port["outside"].node is None
    assert "Never fabricate" in port["docs"][0]
    assert port["boot"]["task_description"] == \
        "Run the benchmark end to end."
    assert port["boot"]["role"] == "Benchmark Coordinator"


def test_confinement_allows_tree_root_as_working_dir(tmp_path):
    path, ws = write_grove(tmp_path)
    os.makedirs(f"{ws}/runs", exist_ok=True)
    port = both(lambda pkg: [enforcer(pkg, path).check_working_dir(d,
                                                                   "worker")
                             for d in (f"{ws}/runs", ws)])
    assert port[0] is None and port[1]


def test_relative_confinement_patterns_resolve_against_workspace(tmp_path):
    g = tmp_path / "rel-grove"
    g.mkdir()
    ws = tmp_path / "rel-ws"
    ws.mkdir()
    (g / "GROVE.md").write_text(REL_GROVE_MD.format(ws=ws))
    port = both(lambda pkg: [enforcer(pkg, str(g)).check_file_path(
        p, write=True, node="solo")
        for p in (f"{ws}/runs/x.txt", os.path.abspath("runs/x.txt"))])
    assert port[0] is None and port[1]


def test_multi_edge_spawn_requires_disambiguation(tmp_path):
    g = tmp_path / "multi-grove"
    g.mkdir()
    (g / "GROVE.md").write_text(MULTI_GROVE_MD)

    def case(pkg):
        enf = enforcer(pkg, str(g))
        with pytest.raises(pkg.grove.GroveError) as ambiguous:
            enf.resolve_spawn("boss", {})
        return [str(ambiguous.value),
                enf.resolve_spawn("boss", {"profile": "reviewer"}).node,
                enf.resolve_spawn("boss", {"skills": ["worker"]}).node]
    assert both(case)[1:] == ["reviewer", "worker"]


def test_skills_loader_shadowing_and_create(tmp_path):
    def case(pkg):
        root = tmp_path / pkg.name
        global_dir, grove_dir = root / "global-skills", root / "grove-skills"
        global_dir.mkdir(parents=True)
        grove_dir.mkdir()
        (global_dir / "common.md").write_text(
            "---\nname: common\ndescription: global version\n---\n\nG")
        (grove_dir / "common.md").write_text(
            "---\nname: common\ndescription: grove version\n---\n\nL")
        S = pkg.skills
        loader = S.SkillsLoader(global_dir=str(global_dir),
                                grove_dir=str(grove_dir))
        s = loader.create("new-skill", "fresh: a skill # of ours",
                          "Do the thing.")
        with pytest.raises(S.SkillError):
            loader.create("bad name!", "x", "y")
        with open(s.path) as f:
            written = f.read()
        return {"shadow": loader.load("common").description,
                "written": written,
                "reloaded": S.SkillsLoader(global_dir=str(global_dir))
                .load("new-skill").content,
                "search": [x.name for x in loader.search("fresh")],
                "render": S.parse_skill_md(S.render_skill_md(
                    "a", "b: 'c'\n", "c")).as_dict()}
    port = both(case)
    assert port["shadow"] == "grove version"
    assert port["reloaded"] == "Do the thing."
    assert port["search"] == ["new-skill"]
    assert port["render"]["name"] == "a"


def test_field_composition_and_constraint_accumulation():
    def case(pkg):
        F = pkg.fields
        fields = F.AgentFields(role="Researcher", cognitive_style="skeptical",
                               constraints="Cite sources.",
                               global_context="Project X.")
        return [F.compose_field_prompt(fields, ("Never spend money.",)),
                F.accumulate_constraints(("a",), "b"),
                F.accumulate_constraints((), None),
                F.compose_field_prompt(F.AgentFields(cognitive_style="zen"))]
    port = both(case)
    assert "Challenge assumptions" in port[0] and "zen" in port[3]
    assert port[1] == ("a", "b") and port[2] == ()


def test_glob_interior_doublestar_matches_zero_dirs():
    cases = [("/a/b", "/a/**/b"), ("/a/x/b", "/a/**/b"),
             ("/a/x/y/z/b", "/a/**/b"), ("/a/xb", "/a/**/b"),
             ("/ab", "/a/**/b"), ("/a", "/a/**"), ("/a/b/c", "/a/*"),
             ("/w/r/x", "r/**")]
    port = both(lambda pkg: [pkg.grove._glob_match(p, pat, "/w")
                             for p, pat in cases])
    assert port == [True, True, True, False, False, True, False, True]


# ---------------------------------------------------------------------------
# Live trees inside a grove
# ---------------------------------------------------------------------------

def new_tree(pkg, respond):
    """Deps, supervisor, task manager and watch over ``pkg``'s mock."""
    backend = pkg.runtime.MockBackend(respond=respond)
    deps = pkg.state.AgentDeps.for_tests(backend)
    pkg.supervisor.AgentSupervisor(deps)
    tm = pkg.tasks.TaskManager(
        deps, pkg.store.Persistence(pkg.db.Database(":memory:")))
    return backend, deps, tm, new_watch(deps)


def texts(core):
    return [e.as_text() for e in core.ctx.history(POOL[0])]


def test_grove_tree_end_to_end(tmp_path):
    """Root spawns a worker along the edge; the worker's curl is refused
    by the hard rule and it reports back."""
    def respond(r):
        joined = "\n".join(str(m.get("content", "")) for m in r.messages)
        if "[TASK]" in joined:                    # the worker child
            if "blocked-attempt-done" in joined:
                return j("wait", {})
            if '"error"' in joined and "curl" in joined:
                return j("send_message", {"target": "parent",
                                          "content": "blocked-attempt-done"})
            # matches the hard rule; harmless if a fault let it run
            return j("execute_shell", {"command": "echo curl"})
        if '"agent_id"' in joined:
            return j("wait", {})
        return j("spawn_child", {
            "task_description": "answer q1", "success_criteria": "done",
            "immediate_context": "ctx", "approach_guidance": "answer",
            "profile": "default"})

    def case(pkg):
        root_dir = tmp_path / pkg.name
        root_dir.mkdir()
        path, ws = write_grove(root_dir)

        async def main():
            _, deps, tm, w = new_tree(pkg, respond)
            task_id, root = await tm.create_task(grove=path,
                                                 model_pool=list(POOL))
            await w.until(lambda: any("blocked-attempt-done" in t
                                      for t in texts(root)))
            child = deps.registry.lookup(root.children[0]["agent_id"]).core
            await w.until(lambda: idle(root) and idle(child)
                          and any("blocked-attempt-done" in t
                                  for t in texts(child)))
            await tm.pause_task(task_id)
            cfg = lambda c: {k: getattr(c.config, k) for k in (
                "grove_node", "field_system_prompt", "governance_docs",
                "forbidden_actions", "working_dir")}
            return {"root": cfg(root), "child": cfg(child),
                    "skills": [root.active_skills, child.active_skills],
                    "child_texts": texts(child),
                    "root_actions": sorted({str(e.content.get("action"))
                                            for e in root.ctx.history(POOL[0])
                                            if e.kind == "decision"})}
        out = run(main())
        return json.loads(json.dumps(out).replace(str(root_dir), "<tmp>"))
    port = both(case)
    assert port["root"]["grove_node"] == "coordinator"
    assert "Benchmark Coordinator" in port["root"]["field_system_prompt"]
    assert "Never fabricate" in port["root"]["governance_docs"]
    assert port["child"]["grove_node"] == "worker"
    assert "fetch_web" in port["child"]["forbidden_actions"]
    assert "Answer only from provided data." in \
        port["child"]["field_system_prompt"]
    assert port["skills"][0] == ["coord-skill"]
    assert "worker-skill" in port["skills"][1]
    assert any("no network" in t for t in port["child_texts"])


def test_grove_system_prompt_carries_skills(tmp_path):
    path, ws = write_grove(tmp_path)

    def case(pkg):
        async def main():
            backend, deps, tm, w = new_tree(pkg, lambda r: j("wait", {}))
            task_id, root = await tm.create_task(grove=path,
                                                 model_pool=list(POOL))
            await w.until(lambda: backend.calls and idle(root))
            await tm.pause_task(task_id)
            return backend.calls[0].messages[0]["content"]
        return run(main())
    sys_prompt = both(case)
    assert "Spawn one worker per question." in sys_prompt
    assert "worker-skill" in sys_prompt
    assert "Never fabricate results." in sys_prompt


# ---------------------------------------------------------------------------
# The shipped groves (tests/test_mmlu_grove.py, tests/test_livebench_grove.py)
# ---------------------------------------------------------------------------

SHIPPED = {
    "mmlu-pro": dict(
        root="mmlu-coordinator", child="mmlu-answerer",
        role_marker="You answer exactly one multiple-choice question",
        ask="ANSWER-THIS", verb="Answer question", spawned="Answer question q",
        total=24,
        answers={"q001": "C", "q002": "A", "q003": "F"}),
    "livebench": dict(
        root="lb-coordinator", child="lb-solver",
        role_marker="You solve exactly one benchmark task",
        ask="SOLVE-THIS", verb="Solve task", spawned="Solve task lb",
        total=30,
        answers={"lb001": "408", "lb006": "10", "lb026": "vast salty deep"}),
}


def grove_src(name):
    return os.path.join(REPO, "groves", name)


def score_module(name):
    """The shipped grove's scoring script, loaded by the test: it imports
    the JAX package's scoring module (ROADMAP Queue 1 item 11)."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_score", os.path.join(grove_src(name), "scripts",
                                      "score_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def grove_in_tmp(tmp_path, name):
    """Copy the shipped grove and point its workspace at a tmp dir."""
    dst = tmp_path / name
    shutil.copytree(grove_src(name), dst)
    ws = tmp_path / "workspace"
    (ws / "runs").mkdir(parents=True)
    manifest = (dst / "GROVE.md").read_text()
    patched = manifest.replace(
        f'workspace: "~/.quoracle_tpu/benchmarks/{name}"',
        f'workspace: "{ws}"')
    assert patched != manifest, "workspace line not found in GROVE.md"
    (dst / "GROVE.md").write_text(patched)
    return str(dst), str(ws)


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_manifest_loads(name):
    spec = SHIPPED[name]
    port = both(lambda pkg: pkg.grove.load_grove(grove_src(name)))
    assert port.root_node == spec["root"]
    assert [e.child for e in port.edges] == [spec["child"]]
    assert {r.type for r in port.hard_rules} == {"shell_pattern_block",
                                                 "action_block"}
    assert {s.name for s in port.schemas} == {"benchmark-report", "answer"}


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_questions_dataset_is_wellformed(name):
    """Each package's manifest names the same grove directory, whose
    smoke dataset the scoring script reads."""
    port = both(lambda pkg: pkg.grove.load_grove(grove_src(name)).path)
    with open(os.path.join(port, "data", "questions.jsonl")) as f:
        qs = [json.loads(line) for line in f]
    assert len(qs) >= SHIPPED[name]["total"]
    assert len({q["id"] for q in qs}) == len(qs)
    ids = {q["id"] for q in score_module(name).load_questions()}
    assert set(SHIPPED[name]["answers"]) <= ids


def test_livebench_graders_cover_every_category():
    score = score_module("livebench")
    qs = {q["id"]: q for q in score.load_questions()}
    assert {q["category"] for q in qs.values()} == {
        "math", "coding", "reasoning", "language", "data_analysis",
        "instruction_following"}
    assert score.grade(qs["lb012"], " Lee. ")
    assert not score.grade(qs["lb005"], "211")
    assert score.grade(qs["lb026"], "vast salty deep")
    assert not score.grade(qs["lb001"], None)


def shipped_respond(spec, ws):
    """tests/test_mmlu_grove.py's (and the livebench file's) scripted
    coordinator and answerers."""
    answers = spec["answers"]

    def respond(r):
        sys_prompt = r.messages[0]["content"] if r.messages else ""
        joined = "\n".join(str(m.get("content", ""))
                           for m in r.messages[1:])
        if spec["role_marker"] in sys_prompt:
            m = re.search(rf"{spec['ask']} (\w+) OUTPUT-PATH: (\S+)", joined)
            qid, out_path = m.group(1), m.group(2)
            if f"answered {qid}" in joined:
                return j("wait", {})
            if '"file_write"' in joined:
                return j("send_message", {"target": "parent",
                                          "content": f"answered {qid}"})
            return j("file_write", {"path": out_path, "content": json.dumps(
                {"question_id": qid, "answer": answers[qid]})})
        done = [q for q in answers if f"answered {q}" in joined]
        if len(done) == len(answers):
            if "r1/report.json" in joined:        # report write decided
                return j("wait", {})
            return j("file_write", {
                "path": f"{ws}/runs/r1/report.json",
                "content": json.dumps({"run_id": "r1",
                                       "total": spec["total"],
                                       "answered": len(done),
                                       "answers_dir": "runs/r1/answers"})})
        if spec["spawned"] in joined:            # already spawned
            return j("wait", {})
        return j("batch_async", {"actions": [
            {"action": "spawn_child", "params": {
                "task_description": f"{spec['verb']} {qid}",
                "success_criteria": "answer file written",
                "immediate_context": f"{spec['ask']} {qid} OUTPUT-PATH: "
                                     f"{ws}/runs/r1/answers/{qid}.json",
                "approach_guidance": "answer from knowledge"}}
            for qid in answers]})
    return respond


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_grove_benchmark_end_to_end(tmp_path, name):
    spec = SHIPPED[name]

    def case(pkg):
        grove_dir, ws = grove_in_tmp(tmp_path / pkg.name, name)
        report = os.path.join(ws, "runs", "r1", "report.json")

        async def main():
            _, deps, tm, w = new_tree(pkg, shipped_respond(spec, ws))
            task_id, root = await tm.create_task(grove=grove_dir,
                                                 model_pool=list(POOL))
            await w.until(lambda: os.path.isfile(report) and idle(root))
            children = [deps.registry.lookup(c["agent_id"]).core
                        for c in root.children]
            await tm.pause_task(task_id)
            return {"root": [root.config.grove_node, root.active_skills,
                             root.config.governance_docs],
                    "children": sorted(
                        (c.config.grove_node, c.active_skills,
                         c.config.forbidden_actions) for c in children)}
        out = run(main())
        answers = os.path.join(ws, "runs", "r1", "answers")
        out["files"] = {f: json.load(open(os.path.join(answers, f)))
                        for f in sorted(os.listdir(answers))}
        out["report"] = json.load(open(report))
        out["score"] = score_module(name).score(ws, "r1")
        return json.loads(json.dumps(out).replace(ws, "<ws>"))
    port = both(case)
    assert port["root"][:2] == [spec["root"], [spec["root"]]]
    assert len(port["children"]) == 3
    assert all(c[0] == spec["child"] and spec["child"] in c[1]
               and "fetch_web" in c[2] for c in port["children"])
    assert port["report"]["answered"] == 3
    assert port["score"]["correct"] == 2
    assert port["score"]["accuracy"] == 2 / spec["total"]


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_prepare_strips_answer_keys(tmp_path, name):
    """The scoring script's --prepare copies the data a grove's
    workspace reads; a port agent confined to the workspace reads it."""
    score = score_module(name)
    ws = str(tmp_path / "ws")
    score.prepare(ws)
    with open(os.path.join(ws, "data", "questions.jsonl")) as f:
        for line in f:
            q = json.loads(line)
            assert "answer" not in q and "checks" not in q
    for pkg in BOTH:
        grove_dir, _ = grove_in_tmp(tmp_path / pkg.name, name)
        text = open(os.path.join(grove_dir, "GROVE.md")).read()
        open(os.path.join(grove_dir, "GROVE.md"), "w").write(
            re.sub(r'workspace: ".*"', f'workspace: "{ws}"', text))
    got = [enforcer(pkg, str(tmp_path / pkg.name / name)).check_file_path(
        os.path.join(ws, "data", "questions.jsonl"), write=False,
        node=SHIPPED[name]["child"]) for pkg in BOTH]
    assert got == [None, None]


# ---------------------------------------------------------------------------
# The frontmatter reader and writer against PyYAML
# ---------------------------------------------------------------------------

FRONTMATTER = re.compile(r"\A---\s*\n(.*?)\n---\s*\n?(.*)\Z", re.DOTALL)
# the directories .gitignore lists hold build outputs, such as unpacked
# copies of the tree, not manifests of the repository
with open(os.path.join(REPO, ".gitignore")) as _f:
    IGNORED_DIRS = {line.strip().strip("/") for line in _f
                    if line.strip().endswith("/")}
REPO_MANIFESTS = sorted(
    rel for pattern in ("**/GROVE.md", "**/SKILL.md")
    for rel in (os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, pattern), recursive=True))
    if rel.split(os.sep)[0] not in IGNORED_DIRS)
FIXTURES = [GROVE_MD.format(ws="/tmp/ws", mode="strict"),
            GROVE_MD.format(ws="/tmp/ws", mode="warn"),
            REL_GROVE_MD.format(ws="/tmp/ws"), MULTI_GROVE_MD, WORKER_SKILL,
            COORD_SKILL]


def test_repo_manifests_are_found():
    assert {"groves/mmlu-pro/GROVE.md", "groves/livebench/GROVE.md",
            "groves/mmlu-pro/skills/mmlu-answerer/SKILL.md"} <= \
        set(REPO_MANIFESTS)


@pytest.mark.parametrize("rel", REPO_MANIFESTS)
def test_frontmatter_reads_every_repo_manifest_as_pyyaml(rel):
    with open(os.path.join(REPO, rel)) as f:
        head = FRONTMATTER.match(f.read()).group(1)
    assert frontmatter.load(head) == yaml.safe_load(head)


@pytest.mark.parametrize("i", range(len(FIXTURES)))
def test_frontmatter_reads_the_fixtures_as_pyyaml(i):
    head = FRONTMATTER.match(FIXTURES[i]).group(1)
    assert frontmatter.load(head) == yaml.safe_load(head)


SUBSET = [
    "a: |\n  x\n   y\n\n  z\nb: 1\n",
    "a: >\n  x\n  y\n\n  z\n   w\n  v\nb: 1\n",
    "a: |-\n  x\n\n", "a: |+\n  x\n\n\nb: 2\n", "a: >\n  x\n   y\n  z\n",
    "a: >-\n  folded\n  text\nb: |-\n   lit\n", "a: |\n\n  x\n",
    "- a\n- b: 1\n  c: [x, 'y', \"z\"]\n- - n\n  - m\n-\n  k: v\n",
    "a:\n- 1\n- 2\nb: [x, 'y', [a, b,], ]\n",
    "a: 'it''s\n  folded\n\n  here'\nb: \"x\\ty\\\n  z \\u00e9\"\n",
    "# c\na: b # c\n# d\nc: d e\n  f\n",
    "a: yes\nb: Off\nc: 0x1F\nd: 017\ne: 1_000\nf: 1:30\ng: .inf\n"
    "h: -.Inf\ni: 1.5e+3\nj: 1e3\nk: ~\nl: null\nm: 0b101\n"
    "n: 190:20:30.15\no: +12\np: 0.\nq: .5\n",
    "a: b:c\nd: -x\ne: :y\nf: ?z\ng: a,b]\n",
    "key with spaces  : v\n'quoted': 1\n\"dq\": 2\n3: int key\ntrue: b\n",
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n", "", "# only\n", "a:\n",
    "a: []\nc: ''\n", "a: [\n  x,\n  y\n]\n", "a: x\n\n  y\n",
    "a: \"\\x41\\u0042\\U00000043\\N\\_\\e\\ \"\n", "a: '\\x'\n",
]


@pytest.mark.parametrize("text", SUBSET)
def test_frontmatter_reads_the_subset_as_pyyaml(text):
    assert frontmatter.load(text) == yaml.safe_load(text)


OUTSIDE = [
    ("a: !tag x\n", "a tag"), ("a: &x 1\nb: *x\n", "an anchor"),
    ("a: *x\n", "an alias"), ("? a\n: b\n", "complex key"),
    ("<<: {a: 1}\n", "merge"), ("a: 2001-12-14\n", "timestamp"),
    ("a:\tb\n", "tab"), ("%YAML 1.1\na: b\n", "directive"),
    ("---\na: b\n", "document marker"), ("a: b\n...\n", "document marker"),
    ("a: [a: b]\n", "flow sequence"), ("a: 'x'#c\n", "comment"),
    ("a: =\n", "value"), ("a: \x07\n", "character"),
    ("a: b\u2028c\n", "line separator"), ("a: @x\n", "reserved"),
    ("a: {b: 1}\n", "flow mapping"), ("a: [x, {b: 1}]\n", "flow mapping"),
    ("a: {}\n", "flow mapping"), ("a: >2\n   x\n", "indentation indicator"),
    ("a: |-1\n  x\n", "indentation indicator"),
    ("a: \"\\/\"\n", "unknown escape"),
    # malformed YAML: PyYAML raises too
    ("a: b\n  c: d\n", "mapping value"), ("a: 1\n b: 2\n", "mapping value"),
    ("- a\nb: c\n", "expected '- '"), ("a: \"open\n", "end of text"),
    ("a: |\n    x\n  y\n", "bad indentation"), ("a: b: c\n", "mapping"),
    ("a: - b\n", "block sequence"), ("a: \"\\q\"\n", "unknown escape"),
    ("a: [x, , y]\n", "flow"), ("a: |0\n  x\n", "indentation indicator"),
]


@pytest.mark.parametrize("text,construct", OUTSIDE,
                         ids=[f"outside{i}" for i in range(len(OUTSIDE))])
def test_frontmatter_raises_outside_the_subset(text, construct):
    with pytest.raises(frontmatter.FrontmatterError, match=construct):
        frontmatter.load(text)


def test_frontmatter_load_errors_become_grove_and_skill_errors(tmp_path):
    g = tmp_path / "g"
    g.mkdir()
    (g / "GROVE.md").write_text("---\nname: g\nx: &a 1\n---\n")
    for pkg in BOTH:
        if pkg is PORT:
            with pytest.raises(pkg.grove.GroveError, match="an anchor"):
                pkg.grove.load_grove(str(g))
        with pytest.raises(pkg.skills.SkillError, match="bad frontmatter"):
            pkg.skills.parse_skill_md("---\nname: [\n---\nbody")


_ALPHA = (string.ascii_letters + string.digits
          + " -_.:#'\"!&*?,[]{}|>%@`~=<\\/\n" + "\xe9\xfc\x85\u2028\xa0")
_TEXT = st.text(alphabet=_ALPHA, max_size=120)
_KEY = st.text(alphabet=string.ascii_letters + string.digits + "_- .",
               min_size=1, max_size=20)
_SCALAR = st.one_of(_TEXT, st.integers(-10**6, 10**6), st.booleans(),
                    st.none(), st.floats(allow_nan=False))
_DATA = st.recursive(_SCALAR, lambda c: st.one_of(
    st.lists(c, max_size=4), st.dictionaries(_KEY, c, min_size=1,
                                             max_size=4)),
    max_leaves=12)


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


# the mixed style: a collection of scalars in flow style, any other in
# block style; a mapping of scalars would be a flow mapping, outside the
# subset, so every generated mapping holds a list
_MIXED = st.recursive(
    st.lists(_SCALAR, max_size=4),
    lambda c: st.one_of(
        st.lists(c, min_size=1, max_size=3),
        st.builds(lambda seq, d: {"seq/": seq, **d}, c,
                  st.dictionaries(_KEY, st.one_of(_SCALAR, c),
                                  max_size=3))),
    max_leaves=8)


@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(st.one_of(
    st.tuples(st.dictionaries(_KEY, _DATA, min_size=1, max_size=5),
              st.just(False)),
    st.tuples(st.builds(lambda seq, d: {"seq/": seq, **d}, _MIXED,
                        st.dictionaries(_KEY, st.one_of(_SCALAR, _MIXED),
                                        max_size=4)),
              st.just(None))),
    st.sampled_from([20, 80]), st.sampled_from([2, 4]))
def test_frontmatter_reads_generated_documents_as_pyyaml(case, width,
                                                         indent):
    """Documents PyYAML writes from generated data (the block style, and
    the mixed one, whose collections of scalars are flow sequences; every
    scalar style it picks, folded at two widths)."""
    d, flow = case
    text = yaml.safe_dump(d, default_flow_style=flow, width=width,
                          indent=indent, sort_keys=False)
    assert _same(frontmatter.load(text), yaml.safe_load(text)), text


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.dictionaries(st.sampled_from(["name", "description"]), _TEXT,
                       min_size=1))
def test_frontmatter_writes_flat_mappings_as_pyyaml(d):
    text = frontmatter.dump_mapping(d)
    assert text == yaml.safe_dump(d, sort_keys=False)
    assert frontmatter.load(text) == d


# ---------------------------------------------------------------------------
# The schema subset against jsonschema
# ---------------------------------------------------------------------------

def _verdict(validate, error_cls, instance, schema):
    try:
        validate(instance, schema)
    except error_cls as e:
        return e.message
    return None


SCHEMAS = sorted(glob.glob(os.path.join(REPO, "groves", "*", "schemas",
                                        "*.json")))
PAYLOADS = [{}, {"question_id": "q1", "answer": "C"},
            {"question_id": "q1", "answer": ""},
            {"question_id": "q1", "answer": "CC"},
            {"question_id": 3, "answer": 4}, {"run_id": "r1"},
            {"run_id": "r1", "total": 24, "answered": 3},
            {"run_id": "r1", "total": 2.5, "answered": True},
            {"run_id": 1, "total": "x", "answered": None,
             "answers_dir": 5}, [], "text", None, 1.0]


@pytest.mark.parametrize("schema_path", SCHEMAS,
                         ids=[os.path.relpath(p, REPO) for p in SCHEMAS])
def test_schema_subset_matches_jsonschema_on_the_groves_schemas(
        schema_path):
    with open(schema_path) as f:
        schema = json.load(f)
    got = [_verdict(jsonschema_lite.validate, jsonschema_lite.ValidationError,
                    p, schema) for p in PAYLOADS]
    want = [_verdict(jsonschema.validate, jsonschema.ValidationError,
                     p, schema) for p in PAYLOADS]
    assert got == want
    assert any(v is None for v in got) and any(got)


_TYPES = st.sampled_from(["string", "integer", "number", "object", "array",
                          "boolean", "null"])
_LEAF = st.fixed_dictionaries({}, optional={
    "type": st.one_of(_TYPES, st.lists(_TYPES, min_size=1, max_size=2,
                                       unique=True)),
    "pattern": st.sampled_from(["^[A-J]$", "x", "^a+b?$"]),
    "minLength": st.integers(0, 3)})
_NAMES = ["a", "b", "c"]
_SCHEMA = st.recursive(_LEAF, lambda c: st.fixed_dictionaries({}, optional={
    "type": st.just("object"),
    "required": st.lists(st.sampled_from(_NAMES), unique=True, max_size=3),
    "properties": st.dictionaries(st.sampled_from(_NAMES), c, max_size=3)}),
    max_leaves=6)
_INSTANCE = st.recursive(
    st.one_of(st.none(), st.booleans(), st.integers(-3, 3),
              st.floats(-3, 3, allow_nan=False),
              st.sampled_from(["", "A", "x", "aab", "hello", "K"])),
    lambda c: st.one_of(st.lists(c, max_size=2), st.dictionaries(
        st.sampled_from(_NAMES + ["z"]), c, max_size=4)), max_leaves=8)


@settings(max_examples=400, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(_SCHEMA, _INSTANCE)
def test_schema_subset_matches_jsonschema_on_generated_pairs(schema,
                                                             instance):
    assert _verdict(jsonschema_lite.validate,
                    jsonschema_lite.ValidationError, instance, schema) == \
        _verdict(jsonschema.validate, jsonschema.ValidationError, instance,
                 schema)


@pytest.mark.parametrize("schema", [
    {"items": {"type": "string"}}, {"enum": [1]}, {"$ref": "#/x"},
    {"additionalProperties": False}, {"maxLength": 2}, {"type": "text"},
    {"properties": {"a": {"oneOf": []}}}, {"minLength": -1},
    {"description": "an annotation is a keyword too"}])
def test_schema_subset_raises_on_what_it_does_not_check(schema):
    with pytest.raises(jsonschema_lite.SchemaError):
        jsonschema_lite.validate({}, schema)
