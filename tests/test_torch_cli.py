"""The port's CLI (``quoracle_tpu_torch/cli.py``) and prompt dumps
(``quoracle_tpu_torch/tools/show_prompts.py``) against the JAX
package's, on the CPU.

tests/test_runtime_cli.py's ``test_cli_run_and_status`` runs through both
packages (the printed status must agree, ids dropped), as do ``resume``
(boot revival of a task left running), ``serve`` (its refusal of a
non-loopback bind without a token, and a live server answering over
HTTP until cancelled) and ``show-prompts``. ``--backend torch`` asks for
the card unless ``--device cpu`` is given (it then decides over a tiny
pool on the CPU), and every flag whose module the port has not got
reaches the ``NotImplementedError`` that names its ROADMAP item.
tests/test_golden_prompts.py's three cases hold the port's scenarios
byte for byte to tests/golden/, which the port only reads."""

import asyncio
import json
import os
import sqlite3
import threading
import types
import urllib.request

import pytest

from _agent_parity import (
    BOTH, JAX, PORT, both, install_watch, process_hooks_restored, scrub,
)
from quoracle_tpu_torch.tools.show_prompts import SCENARIOS

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def watched(monkeypatch):
    install_watch(monkeypatch)
    monkeypatch.delenv("QUORACLE_DASHBOARD_TOKEN", raising=False)
    for pkg in BOTH:
        pkg.treeobs.reset()
    with process_hooks_restored():
        yield


def test_cli_run_and_status(tmp_path, capsys):
    def case(pkg):
        db_path = str(tmp_path / f"{pkg.name}.db")
        rc = pkg.cli.main(["run", "do nothing much", "--db", db_path,
                           "--watch-seconds", "1.5"])
        out = capsys.readouterr().out
        rc2 = pkg.cli.main(["status", "--db", db_path])
        status = json.loads(capsys.readouterr().out)
        return {"rc": [rc, rc2], "started": "task task-" in out,
                "spawned": "spawned" in out, "status": status}
    port = both(case)
    assert port["rc"] == [0, 0] and port["started"] and port["spawned"]
    assert list(port["status"]["tasks"].values()) == ["paused"]


def test_cli_resume_revives_a_task_left_running(tmp_path, capsys):
    def case(pkg):
        db_path = str(tmp_path / f"{pkg.name}.db")
        pkg.cli.main(["run", "revive me", "--db", db_path,
                      "--watch-seconds", "0.5"])
        with sqlite3.connect(db_path) as db:      # a crash: left running
            db.execute("UPDATE tasks SET status='running'")
        capsys.readouterr()
        rc = pkg.cli.main(["resume", "--db", db_path,
                           "--watch-seconds", "0.5"])
        lines = capsys.readouterr().out.splitlines()
        pkg.cli.main(["status", "--db", db_path])
        return {"rc": rc, "boot": json.loads(lines[0]),
                "status": json.loads(capsys.readouterr().out)}
    port = both(case)
    assert port["rc"] == 0 and len(port["boot"]["revived"]) == 1
    assert port["boot"]["failed"] == []
    assert list(port["status"]["tasks"].values()) == ["paused"]


def test_cli_serve_refuses_a_public_bind_without_a_token(tmp_path, capsys):
    def case(pkg):
        rc = pkg.cli.main(["serve", "--host", "0.0.0.0", "--db",
                           str(tmp_path / f"{pkg.name}.db")])
        return rc, scrub(capsys.readouterr().out)
    rc, out = both(case)
    assert rc == 2 and "refusing to bind" in out


def test_cli_serve_answers_until_cancelled(tmp_path, monkeypatch):
    """``serve`` on port 0 boots the runtime and starts the dashboard;
    the test reads /healthz and /api/status over HTTP once the server
    has started, then cancels the command, which stops the server and
    shuts the runtime down."""
    def case(pkg):
        started = []
        start = pkg.web.DashboardServer.start

        async def spy(self):
            server = await start(self)
            started.append(server)
            return server
        monkeypatch.setattr(pkg.web.DashboardServer, "start", spy)
        args = pkg.cli.build_parser().parse_args(
            ["serve", "--port", "0", "--db",
             str(tmp_path / f"{pkg.name}.db")])
        assert (args.host, args.port, args.token) == ("127.0.0.1", 0, None)

        async def main():
            serving = asyncio.ensure_future(pkg.cli.cmd_serve(args))
            while not started and not serving.done():
                await asyncio.sleep(0)
            server = started[0]

            def get(path):
                with urllib.request.urlopen(server.url + path,
                                            timeout=30) as r:
                    return json.loads(r.read())
            loop = asyncio.get_running_loop()
            out = [await loop.run_in_executor(None, get, p)
                   for p in ("/healthz", "/api/status")]
            serving.cancel()
            rc = await serving
            return {"rc": rc, "answers": out,
                    "stopped": server._httpd is None}
        return asyncio.run(asyncio.wait_for(main(), 60))
    port = both(case)
    assert port["rc"] == 0 and port["stopped"]
    assert port["answers"][0] == {"status": "ok"}
    assert port["answers"][1]["backend"] == "MockBackend"


# Every flag the port refused before its module was ported, with the
# ROADMAP item that ports it; None: ported since, the flag is taken and
# reaches the RuntimeConfig field the JAX CLI sets (TAKEN).
UNPORTED_FLAGS = [
    (["--tp", "2"], "item 12"), (["--coordinator", "h:1"], "item 12"),
    (["--num-processes", "2"], "item 12"), (["--process-id", "0"], "item 12"),
    (["--replicas", "2"], None),
    (["--disaggregate"], None),
    (["--fleet-min", "2"], None),
    (["--fleet-max", "2"], None),
    (["--fleet-tick-s", "1"], None),
    (["--fabric-listen", "h:1"], "item 14"),
    (["--fabric-peers", "h:1"], "item 14"),
    (["--prefixd", "h:1"], "item 14"),
    (["--chaos-plan", "plan.json"], None),
    (["--sim-trace", "trace.json"], "item 14"),
    (["--sim-seed", "3"], "item 14"),
    (["--capture-dir", "capture"], "item 11"),
    (["--capture-mb", "64"], "item 11"),
    (["--image-backend", "diffusion"], "item 10"),
]
TAKEN = {"--replicas": ("replicas", 2), "--disaggregate": ("disaggregate",
                                                           True),
         "--fleet-min": ("fleet_min", 2), "--fleet-max": ("fleet_max", 2),
         "--fleet-tick-s": ("fleet_tick_s", 1.0),
         "--chaos-plan": ("chaos_plan", "plan.json")}


@pytest.mark.parametrize("flags,item", UNPORTED_FLAGS,
                         ids=[f[0][0] for f in UNPORTED_FLAGS])
@pytest.mark.parametrize("cmd", ["run", "resume", "serve"])
def test_each_unported_flag_names_its_item(cmd, flags, item):
    desc = ["x"] if cmd == "run" else []
    pool = [] if cmd == "resume" else ["--pool", "xla:tiny"]
    argv = [cmd, *desc, "--backend", "torch", "--device", "cpu", *pool,
            *flags]
    if item is None:
        from quoracle_tpu_torch.runtime import _refuse_unported
        field, value = TAKEN[flags[0]]
        ns = JAX.cli.build_parser().parse_args([cmd, *desc, *flags])
        assert getattr(ns, field) == value
        cfg = PORT.cli._config(PORT.cli.build_parser().parse_args(argv))
        assert getattr(cfg, field) == value
        _refuse_unported(cfg)        # no NotImplementedError left for it
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 {item}"):
        PORT.cli.main(argv)


def test_cluster_flags_serve_a_disaggregated_fleet_on_the_cpu(tmp_path,
                                                             monkeypatch):
    """``run --replicas 3 --disaggregate --fleet-max 3 --chaos-plan`` over
    a tiny pool on the CPU: the runtime the CLI builds serves through a
    ClusterPlane with its FleetController and the plan armed."""
    from quoracle_tpu_torch.chaos.faults import CHAOS
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"seed": 1, "faults": [
        {"point": "cluster.serve", "kind": "slow", "prob": 0.0}]}))
    built = []

    class Runtime(PORT.cli.Runtime):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append((self, CHAOS.armed()))

    async def no_watch(_seconds):
        return None
    monkeypatch.setattr(PORT.cli, "Runtime", Runtime)
    monkeypatch.setattr(PORT.cli, "asyncio", types.SimpleNamespace(
        run=asyncio.run, sleep=no_watch))
    try:
        rc = PORT.cli.main([
            "run", "Decide the next step.", "--backend", "torch",
            "--device", "cpu", "--pool", "xla:tiny", "--db",
            str(tmp_path / "c.db"), "--replicas", "3", "--disaggregate",
            "--fleet-max", "3", "--chaos-plan", str(plan)])
    finally:
        CHAOS.disarm()
        for rt, _ in built:
            rt.backend.close()
    assert rc == 0
    (rt, armed), = built
    assert armed and type(rt.backend).__name__ == "ClusterPlane"
    assert sorted(r.role for r in rt.backend.replicas) \
        == ["decode", "decode", "prefill"]
    assert rt._fleet is not None and rt._fleet.config.max_replicas == 3


def test_backend_torch_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.fail("this check runs where no card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.cli.main(["run", "x", "--backend", "torch", "--pool",
                       "xla:tiny", "--watch-seconds", "0"])
    with pytest.raises(SystemExit):                # the JAX backend's name
        PORT.cli.main(["run", "x", "--backend", "tpu"])


def test_backend_torch_on_the_cpu_over_a_tiny_pool(tmp_path, capsys,
                                                  monkeypatch):
    """``--backend torch --device cpu`` serves a tiny pool with the plain
    PyTorch paths: the task is created and its root runs a decide on the
    CPU engines; the watch ends when that decide's span closes (the
    CLI's ``asyncio.sleep`` waits on it), and the status reads paused."""
    db_path = str(tmp_path / "cpu.db")
    decided = threading.Event()

    def on_span(span):
        if span["name"] == "consensus.decide":
            decided.set()
    PORT.telemetry.TRACER.add_sink(on_span)
    built = []

    class Runtime(PORT.cli.Runtime):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    async def until_decided(_seconds):
        await asyncio.get_running_loop().run_in_executor(
            None, decided.wait, 300)
    monkeypatch.setattr(PORT.cli, "Runtime", Runtime)
    monkeypatch.setattr(PORT.cli, "asyncio", types.SimpleNamespace(
        run=asyncio.run, sleep=until_decided))
    try:
        rc = PORT.cli.main(["run", "Decide the next step.", "--backend",
                            "torch", "--device", "cpu", "--pool",
                            "xla:tiny", "--db", db_path])
    finally:
        PORT.telemetry.TRACER.remove_sink(on_span)
        for rt in built:
            rt.backend.close()
    out = capsys.readouterr().out
    assert rc == 0 and decided.is_set()
    assert "task task-" in out and "spawned" in out
    assert [str(rt.backend.device) for rt in built] == ["cpu"]
    assert type(built[0].backend).__name__ == "TorchBackend"
    PORT.cli.main(["status", "--db", db_path])
    status = json.loads(capsys.readouterr().out)
    assert list(status["tasks"].values()) == ["paused"]


# ---------------------------------------------------------------------------
# show-prompts (tests/test_golden_prompts.py on the port)
# ---------------------------------------------------------------------------

def test_every_scenario_has_a_golden():
    have = {fn[:-4] for fn in os.listdir(GOLDEN_DIR) if fn.endswith(".txt")}
    assert have == set(SCENARIOS)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_golden(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.txt")) as f:
        want = f.read()
    assert SCENARIOS[name]() == want


def test_scenarios_cover_the_reference_set():
    need = {
        "generalist_initial", "generalist_with_history", "with_fields_full",
        "with_cognitive_style", "refinement_round", "with_secrets",
        "consensus_immediate", "consensus_exact_match_params",
        "consensus_semantic_params", "consensus_different_actions",
        "consensus_max_rounds", "consensus_cluster_merge",
    }
    assert need <= set(SCENARIOS)


def test_cli_show_prompts_prints_and_writes_as_the_jax_cli(tmp_path,
                                                           capsys):
    def case(pkg):
        out_dir = tmp_path / pkg.name
        rcs = [pkg.cli.main(["show-prompts", "consensus_immediate"])]
        shown = capsys.readouterr().out
        rcs.append(pkg.cli.main(["show-prompts"]))
        usage = capsys.readouterr().out
        rcs.append(pkg.cli.main(["show-prompts", "--write-golden",
                                 str(out_dir)]))
        capsys.readouterr()
        written = {f: (out_dir / f).read_text()
                   for f in sorted(os.listdir(out_dir))}
        return rcs, shown, usage.split("\n", 1)[1], written
    (rcs, shown, usage, written), (jrcs, jshown, jusage, jwritten) = [
        case(pkg) for pkg in (PORT, JAX)]
    assert (rcs, shown, usage, written) == (jrcs, jshown, jusage, jwritten)
    assert rcs == [0, 1, 0]
    for name, text in written.items():
        with open(os.path.join(GOLDEN_DIR, name)) as f:
            assert text == f.read()
