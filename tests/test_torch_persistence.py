"""The port's persistence layer (``persistence/db.py``, ``store.py``,
``tasks.py``) against the JAX package's: the 10 scenarios of
tests/test_persistence.py and tests/test_history_transfer.py's
pause-and-restore case, each run through both packages on each one's
``MockBackend``; the rows of every table, the restored trees (histories,
configs, registry, escrow) and the settings must agree, ids and times
dropped. Then the files themselves: a task the JAX package created and
paused is restored by the port, and the reverse, with equal histories and
configs; a value either ``Vault`` encrypted decrypts in the other.

No test waits on a clock: agents are awaited through the ``Watch`` of
tests/_agent_parity.py (woken by every handled mailbox message and every
broadcast), so the copy of ``test_create_task_persists_agent_and_events``
no longer polls."""

import json
import logging
import re
import sys

import pytest

from _agent_parity import (
    BOTH, JAX, PORT, both, db_view, first_difference, history_view, idle,
    install_watch, j, new_watch, row_view, run, view,
)

POOL = ["mock:consensus-model-1", "mock:consensus-model-2",
        "mock:consensus-model-3"]
NEW_POOL = ["mock:new-model-a", "mock:new-model-b"]


@pytest.fixture(autouse=True)
def watched(monkeypatch):
    install_watch(monkeypatch)
    for pkg in BOTH:
        pkg.treeobs.reset()


def scripted(pkg, *entries):
    return pkg.runtime.MockBackend(
        scripts={m: list(entries) for m in POOL},
        respond=lambda r: j("wait", {}))


def make_stack(pkg, backend, db=None, key="test-key-123"):
    """tests/test_persistence.py's stack: one database, the durable
    secret store, costs written through, a supervisor, a task manager and
    the bus writer; a Watch on the tree's bus."""
    db = db or pkg.db.Database(":memory:", encryption_key=key)
    store = pkg.store.Persistence(db)
    deps = pkg.state.AgentDeps.for_tests(
        backend, secrets=pkg.store.PersistentSecretStore(db))
    deps.costs = pkg.costs.CostRecorder(escrow=deps.escrow,
                                        events=deps.events,
                                        persist_fn=store.persist_cost)
    sup = pkg.supervisor.AgentSupervisor(deps)
    tm = pkg.tasks.TaskManager(deps, store)
    store.attach_bus(deps.events.bus)
    return db, store, deps, sup, tm, new_watch(deps)


def fresh_stack(pkg, backend, db, store):
    """A fresh runtime stack over the same database (the reboot)."""
    deps = pkg.state.AgentDeps.for_tests(
        backend, secrets=pkg.store.PersistentSecretStore(db))
    pkg.supervisor.AgentSupervisor(deps)
    return deps, pkg.tasks.TaskManager(deps, store), new_watch(deps)


def n_kind(core, kind, model=POOL[0]) -> int:
    return sum(1 for e in core.ctx.history(model) if e.kind == kind)


def all_idle(deps) -> bool:
    return all(idle(r.core) for r in deps.registry.all())


def tree_view(deps, task_id) -> list:
    return sorted(
        ({"agent_id": r.agent_id, "parent_id": r.parent_id,
          "config": {k: v for k, v in view(r.core.config).items()
                     if k != "restored_context"},
          "children": [c["agent_id"] for c in r.core.children],
          "histories": {m: history_view(r.core, m)
                        for m in r.core.config.model_pool},
          "todos": r.core.ctx.todos}
         for r in deps.registry.agents_for_task(task_id)),
        key=lambda d: (d["parent_id"] is not None, d["agent_id"]))


# ---------------------------------------------------------------------------
# Vault / serialization / secrets
# ---------------------------------------------------------------------------

def test_vault_roundtrip_and_degraded_mode():
    def case(pkg):
        v = pkg.db.Vault("some-key")
        blob, enc = v.encrypt("hunter2secret")
        degraded = pkg.db.Vault("")
        blob2, enc2 = degraded.encrypt("plain")
        with pytest.raises(RuntimeError) as err:
            degraded.decrypt(blob, True)
        return (v.active, enc, blob != b"hunter2secret",
                v.decrypt(blob, enc), degraded.active, enc2, blob2,
                degraded.decrypt(blob2, enc2), str(err.value))
    got = both(case)
    assert got[:4] == (True, True, True, "hunter2secret")
    assert got[4:8] == (False, False, b"plain", "plain")


def test_vaults_decrypt_each_others_values():
    """Same key derivation (a 32-byte base64 key as is, anything else
    hashed) and the same envelope: nonce || ciphertext."""
    for key in ("some-key", "A" * 43 + "="):
        jv, tv = JAX.db.Vault(key), PORT.db.Vault(key)
        for src, dst in ((jv, tv), (tv, jv)):
            blob, enc = src.encrypt("cross-package secret")
            assert enc and dst.decrypt(blob, enc) == "cross-package secret"
        assert jv._derive(key) == tv._derive(key)


def test_vault_without_cryptography_degrades_with_the_jax_warning(
        monkeypatch, caplog):
    """The card's machine may lack ``cryptography``: with a key but no
    library, both vaults fall back to plaintext with the same warning."""
    monkeypatch.setitem(sys.modules,
                        "cryptography.hazmat.primitives.ciphers.aead", None)

    def case(pkg):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            v = pkg.db.Vault("some-key")
        return v.active, v.encrypt("x"), [r.getMessage()
                                          for r in caplog.records]
    active, (blob, enc), warnings = both(case)
    assert not active and not enc and blob == b"x"
    assert warnings == ["cryptography unavailable; secrets stored in "
                        "plaintext (degraded mode)"]


def test_config_and_context_serialization_roundtrip():
    from decimal import Decimal

    def build(pkg):
        cfg = pkg.state.AgentConfig(
            agent_id="a1", task_id="t1", model_pool=list(POOL),
            parent_id="a0", profile="default",
            capability_groups=["communication"],
            forbidden_actions=("execute_shell",), budget_mode="allocated",
            budget_limit=Decimal("3.50"), active_skills=("s1",))
        ctx = pkg.history.AgentContext()
        ctx.append_all(pkg.history.HistoryEntry(kind=pkg.history.USER,
                                                content="hello"), POOL)
        ctx.context_lessons[POOL[0]] = [
            pkg.history.Lesson("factual", "the sky is blue", 2)]
        ctx.model_states[POOL[0]] = ["mid-task"]
        ctx.todos = [{"task": "x"}]
        ctx.context_summary = "so far"
        return cfg, ctx

    def case(pkg):
        cfg, ctx = build(pkg)
        scfg = pkg.store.serialize_config(cfg)
        sctx = pkg.store.serialize_context(ctx, [{"agent_id": "c1"}])
        cfg2 = pkg.store.deserialize_config(scfg)
        ctx2 = pkg.store.deserialize_context(sctx)
        return scfg, json.loads(sctx), cfg2 == cfg, vars(ctx2)
    scfg, sctx, same, ctx2 = both(case)
    assert same and ctx2["todos"] == [{"task": "x"}]
    assert ctx2["children"] == [{"agent_id": "c1"}]
    # each package reads the other's serialization into its own classes
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        cfg, ctx = build(src)
        cfg2 = dst.store.deserialize_config(src.store.serialize_config(cfg))
        assert type(cfg2) is dst.state.AgentConfig
        assert view(cfg2) == view(cfg)
        ctx2 = dst.store.deserialize_context(
            src.store.serialize_context(ctx, []))
        assert type(ctx2) is dst.history.AgentContext
        assert view(vars(ctx2)) == view(vars(ctx))


def test_persistent_secret_store_encrypts_at_rest():
    def case(pkg):
        db = pkg.db.Database(":memory:", encryption_key="k1")
        store = pkg.store.PersistentSecretStore(db)
        store.put("api_key", "super-secret-value", "test secret")
        row = db.query_one("SELECT * FROM secrets WHERE name='api_key'")
        at_rest = (row["encrypted"],
                   b"super-secret-value" in bytes(row["value"]))
        got = store.lookup("api_key", agent_id="a1", action="call_api")
        usage = [row_view(r) for r in db.query("SELECT * FROM secret_usage")]
        store2 = pkg.store.PersistentSecretStore(db)
        return (at_rest, got, usage, store2.lookup("api_key"),
                store2.delete("api_key"), store2.lookup("api_key"),
                db_view(db))
    at_rest, got, usage, again, deleted, after, _ = both(case)
    assert at_rest == (1, False) and got == again == "super-secret-value"
    assert usage and usage[0]["agent_id"] == "a1"
    assert deleted and after is None


# ---------------------------------------------------------------------------
# Task lifecycle end to end
# ---------------------------------------------------------------------------

def test_create_task_persists_agent_and_events():
    def case(pkg):
        async def main():
            backend = scripted(
                pkg, j("todo", {"items": [{"task": "step-1"}]}),
                j("wait", {}))
            db, store, deps, sup, tm, w = make_stack(pkg, backend)
            task_id, root = await tm.create_task(
                "plan the work", model_pool=list(POOL))
            await w.until(lambda: root.ctx.todos
                          and n_kind(root, "decision") >= 2 and idle(root))
            rows = store.agents_for_task(task_id)
            mid = {"rows": [(r["agent_id"], r["context"].todos)
                            for r in rows],
                   "acts": sorted(a["action"] for a in db.query(
                       "SELECT * FROM actions WHERE agent_id=?",
                       (root.agent_id,))),
                   "costs": len(db.query("SELECT * FROM agent_costs")),
                   "db": db_view(db)}
            await tm.pause_task(task_id)
            mid["after_pause"] = db_view(db)
            return mid
        return main()
    got = both(case)
    assert got["rows"][0][1] == [{"task": "step-1"}]
    assert set(got["acts"]) >= {"todo", "wait"}
    assert got["costs"] and got["db"]["logs"]
    assert all(a["status"] == "ok" for a in got["db"]["actions"])
    assert {r["status"] for r in got["after_pause"]["tasks"]} == {"paused"}


def test_pause_then_restore_rebuilds_tree_with_history():
    """The tree paused, restored into a fresh stack over the same
    database, equal to itself at the pause, and woken by a message (the
    todo after the ping runs once, so the agent idles)."""
    def respond(r):
        joined = "\n".join(str(m.get("content", "")) for m in r.messages)
        if "[TASK]" in joined:
            return j("wait", {})
        if "resume-ping" in joined:
            # once: the JAX script repeats the todo while the ping is in
            # the history, so its agent never idles
            if '"resumed"' in joined:
                return j("wait", {})
            return j("todo", {"items": [{"task": "resumed"}]})
        if '"agent_id"' in joined:
            return j("wait", {})
        return j("spawn_child", {
            "task_description": "hold position",
            "success_criteria": "n/a", "immediate_context": "n/a",
            "approach_guidance": "wait", "profile": "default"})

    def case(pkg):
        async def main():
            backend = pkg.runtime.MockBackend(respond=respond)
            db, store, deps, sup, tm, w = make_stack(pkg, backend)
            task_id, root = await tm.create_task("delegate then idle",
                                                 model_pool=list(POOL))
            await w.until(lambda: root.children and len(deps.registry) == 2
                          and all_idle(deps))
            paused_tree = tree_view(deps, task_id)
            out = {"stopped": await tm.pause_task(task_id),
                   "live": len(deps.registry),
                   "status": store.get_task(task_id)["status"],
                   "rows": sorted((r["agent_id"], r["status"]) for r in
                                  store.agents_for_task(task_id))}
            deps2, tm2, w2 = fresh_stack(pkg, backend, db, store)
            out["restored"] = await tm2.restore_task(task_id)
            out["tree"] = tree_view(deps2, task_id)
            assert view(out["tree"]) == view(paused_tree)
            core2 = deps2.registry.lookup(root.agent_id).core
            core2.post({"type": "user_message", "content": "resume-ping",
                        "from": "user"})
            await w2.until(lambda: core2.ctx.todos == [{"task": "resumed"}]
                           and all_idle(deps2))
            out["resumed"] = tree_view(deps2, task_id)
            await tm2.pause_task(task_id)
            out["db"] = db_view(db)
            return out
        return main()
    got = both(case)
    assert got["stopped"] == 2 and got["live"] == 0
    assert got["status"] == "paused" and got["restored"] == 2
    assert {s for _, s in got["rows"]} == {"stopped"}
    root, child = got["tree"]
    assert child["parent_id"] == root["agent_id"]
    assert root["children"] == [child["agent_id"]]
    assert any("delegate then idle" in str(h)
               for h in root["histories"][POOL[0]])


def test_boot_revival_restores_running_finalizes_pausing():
    def case(pkg):
        async def main():
            backend = pkg.runtime.MockBackend(respond=lambda r: j("wait",
                                                                  {}))
            db, store, deps, sup, tm, w = make_stack(pkg, backend)
            t1, root1 = await tm.create_task("crash victim",
                                             model_pool=list(POOL))
            await w.until(lambda: idle(root1)
                          and len(root1.ctx.history(POOL[0])) >= 3)
            await sup.stop_all(t1)        # a crash: no status change
            store.db.execute("UPDATE tasks SET status='running' WHERE "
                             "id=?", (t1,))
            t2, root2 = await tm.create_task("stale pauser",
                                             model_pool=list(POOL))
            await w.until(lambda: idle(root2)
                          and len(root2.ctx.history(POOL[0])) >= 3)
            await sup.stop_all(t2)
            store.set_task_status(t2, "pausing")
            deps2, tm2, _ = fresh_stack(pkg, backend, db, store)
            result = await tm2.boot_revival()
            out = {"revived": [t == t1 for t in result["revived"]],
                   "failed": result["failed"],
                   "t2": store.get_task(t2)["status"],
                   "t1_live": len(deps2.registry.agents_for_task(t1)),
                   "t2_live": len(deps2.registry.agents_for_task(t2)),
                   "tree": tree_view(deps2, t1)}
            await tm2.pause_task(t1)
            out["db"] = db_view(db)
            return out
        return main()
    got = both(case)
    assert got["revived"] == [True] and got["failed"] == []
    assert got["t2"] == "paused" and got["t1_live"] == 1
    assert got["t2_live"] == 0


def test_restore_rebuilds_escrow_with_historical_spend():
    from decimal import Decimal

    def case(pkg):
        async def main():
            backend = pkg.runtime.MockBackend(respond=lambda r: j("wait",
                                                                  {}))
            db, store, deps, sup, tm, w = make_stack(pkg, backend)
            task_id, root = await tm.create_task(
                "budgeted", model_pool=list(POOL), budget="10")
            deps.costs.record(pkg.costs.CostEntry(
                agent_id=root.agent_id, task_id=task_id,
                amount=Decimal("1.25"), cost_type="manual",
                description="x"))
            await w.until(lambda: idle(root) and n_kind(root, "result"))
            spent = deps.escrow.get(root.agent_id).snapshot()
            await tm.pause_task(task_id)
            deps2, tm2, _ = fresh_stack(pkg, backend, db, store)
            await tm2.restore_task(task_id)
            st = deps2.escrow.get(root.agent_id)
            out = (spent, st.snapshot(), str(store.costs_for_task(task_id)),
                   str(store.agent_spent(root.agent_id)))
            await tm2.pause_task(task_id)
            return out
        return main()
    before, after, task_cost, agent_spent = both(case)
    assert after["mode"] == "root" and after["limit"] == "10"
    assert after["spent"] == agent_spent
    assert task_cost == agent_spent and float(agent_spent) >= 1.25


def test_dismissal_deletes_rows():
    def case(pkg):
        async def main():
            seen = {}
            db_box = []

            def respond(r):
                joined = "\n".join(str(m.get("content", ""))
                                   for m in r.messages)
                if "[TASK]" in joined:                   # the child
                    if '"delivered_to"' in joined:
                        return j("wait", {})
                    return j("send_message",
                             {"target": "parent", "content": "child ready"})
                if '"dismissed"' in joined:
                    return j("wait", {})
                if "child ready" in joined:
                    seen["rows_before_dismiss"] = len(
                        db_box[0].query("SELECT * FROM agents"))
                    m = re.search(r'from="(agent-[0-9a-f]+)"', joined)
                    return j("dismiss_child", {"child_id": m.group(1)})
                if '"agent_id"' in joined:               # spawn acked
                    return j("wait", {})
                return j("spawn_child", {
                    "task_description": "ephemeral",
                    "success_criteria": "n/a", "immediate_context": "n/a",
                    "approach_guidance": "wait", "profile": "default"})
            backend = pkg.runtime.MockBackend(respond=respond)
            db, store, deps, sup, tm, w = make_stack(pkg, backend)
            db_box.append(db)
            dismissed = []
            deps.events.bus.subscribe(
                pkg.bus.TOPIC_LIFECYCLE,
                lambda t, e: dismissed.append(e["agent_id"])
                if e["event"] == "agent_dismissed" else None)
            task_id, root = await tm.create_task("spawn and dismiss",
                                                 model_pool=list(POOL))
            await w.until(lambda: dismissed and len(deps.registry) == 1
                          and all_idle(deps))
            rows = store.agents_for_task(task_id)
            out = {"before": seen["rows_before_dismiss"],
                   "rows": [r["agent_id"] == root.agent_id for r in rows],
                   "child_rows": {t: len(db.query(
                       f"SELECT * FROM {t} WHERE agent_id=?",
                       (dismissed[0],)))
                       for t in ("agents", "logs", "agent_costs",
                                 "actions", "consensus_audit")}}
            await tm.pause_task(task_id)
            out["db"] = db_view(db)
            return out
        return main()
    got = both(case)
    assert got["before"] == 2 and got["rows"] == [True]
    assert not any(got["child_rows"].values())


def test_profiles_and_settings():
    def case(pkg):
        store = pkg.store.Persistence(pkg.db.Database(":memory:"))
        store.save_profile("researcher", {
            "model_pool": list(POOL),
            "capability_groups": ["communication"],
            "max_refinement_rounds": 2})
        store.save_profile("alpha", {"model_pool": list(POOL)})
        store.set_setting("embedding_model", "xla:tiny")
        store.set_setting("draft_map", {"a": "b"})
        return (store.get_profile("researcher"), store.list_profiles(),
                store.get_setting("embedding_model"),
                store.get_setting("missing", "dflt"), store.all_settings(),
                store.delete_profile("alpha"), store.delete_profile("alpha"),
                store.list_profiles(), db_view(store.db))
    got = both(case)
    assert got[0]["max_refinement_rounds"] == 2
    assert got[1] == ["alpha", "researcher"] and got[7] == ["researcher"]
    assert got[2] == "xla:tiny" and got[3] == "dflt"
    assert got[5] and not got[6]


def test_create_task_with_profile_resolution():
    def case(pkg):
        async def main():
            backend = pkg.runtime.MockBackend(respond=lambda r: j("wait",
                                                                  {}))
            db, store, deps, sup, tm, w = make_stack(pkg, backend)
            store.save_profile("minimal", {
                "model_pool": list(POOL), "capability_groups": [],
                "max_refinement_rounds": 1})
            task_id, root = await tm.create_task("profiled task",
                                                 profile="minimal")
            out = {"config": view(root.config)}
            for kw in ({"profile": "nope"}, {}):
                try:
                    await tm.create_task("bad", **kw)
                except ValueError as e:
                    out.setdefault("errors", []).append(str(e))
            await w.until(lambda: idle(root) and n_kind(root, "result"))
            await tm.pause_task(task_id)
            out["db"] = db_view(db)
            return out
        return main()
    got = both(case)
    cfg = got["config"]
    assert cfg["capability_groups"] == [] and cfg["profile"] == "minimal"
    assert cfg["max_refinement_rounds"] == 1
    assert cfg["profile_names"] == ["minimal"]
    assert len(got["errors"]) == 2


def test_port_task_manager_refuses_a_grove():
    async def main():
        backend = PORT.runtime.MockBackend()
        db, store, deps, sup, tm, w = make_stack(PORT, backend)
        with pytest.raises(NotImplementedError, match="groves"):
            await tm.create_task("x", model_pool=list(POOL),
                                 grove="/nonexistent")
        return store.list_tasks()
    assert run(main()) == []


# ---------------------------------------------------------------------------
# tests/test_history_transfer.py::test_switch_survives_pause_and_restore
# ---------------------------------------------------------------------------

def test_switch_survives_pause_and_restore():
    """A pool switch persists: the task paused after it restores with the
    new pool and the transferred histories, and decides over it."""
    def case(pkg):
        async def main():
            backend = pkg.runtime.MockBackend(
                scripts={m: [j("todo", {"items": [{"task": "x",
                                                   "done": False}]})]
                         for m in POOL + NEW_POOL},
                respond=lambda r: j("wait", {}))
            db, store, deps, sup, tm, w = make_stack(
                pkg, backend, key="k" * 16)
            task_id, root = await tm.create_task(
                "switch test", model_pool=list(POOL))
            root.post({"type": "user_message", "content": "go",
                       "from": "user"})
            await w.until(lambda: n_kind(root, "decision") and idle(root))
            root.post({"type": "switch_model_pool",
                       "model_pool": list(NEW_POOL)})
            await w.until(lambda: root.config.model_pool == NEW_POOL
                          and idle(root))
            await tm.pause_task(task_id)
            deps2, tm2, w2 = fresh_stack(pkg, backend, db, store)
            n = await tm2.restore_task(task_id)
            restored = deps2.registry.agents_for_task(task_id)[0].core
            out = {"n": n, "pool": restored.config.model_pool,
                   "kinds": {m: [e.kind for e in restored.ctx.history(m)]
                             for m in NEW_POOL}}
            n_calls = len(backend.calls)
            restored.post({"type": "user_message", "content": "again",
                           "from": "user"})
            await w2.until(lambda: len(backend.calls) > n_calls
                           and idle(restored))
            out["after"] = sorted({c.model_spec
                                   for c in backend.calls[n_calls:]})
            out["tree"] = tree_view(deps2, task_id)
            await tm2.pause_task(task_id)
            return out
        return main()
    got = both(case)
    assert got["n"] >= 1 and got["pool"] == NEW_POOL
    assert all("decision" in k for k in got["kinds"].values())
    assert got["after"] == sorted(NEW_POOL)


# ---------------------------------------------------------------------------
# Files across the packages
# ---------------------------------------------------------------------------

def _spawning_respond(r):
    joined = "\n".join(str(m.get("content", "")) for m in r.messages)
    if "[TASK]" in joined or '"agent_id"' in joined:
        return j("wait", {})
    return j("spawn_child", {
        "task_description": "hold position", "success_criteria": "n/a",
        "immediate_context": "n/a", "approach_guidance": "wait",
        "profile": "worker", "budget": 2})


def escrow_view(deps, task_id) -> dict:
    """Each agent's escrow by its role, amounts as numbers (a restored
    lock is Decimal("2") where the spawn's was Decimal("2.0"))."""
    from decimal import Decimal
    return {("child" if r.parent_id else "root"): {
        k: (v if k == "mode" or v is None else float(Decimal(v)))
        for k, v in deps.escrow.get(r.agent_id).snapshot().items()}
        for r in deps.registry.agents_for_task(task_id)}


async def _create_and_pause(pkg, path):
    """A budgeted task with a child, a secret and a credential in the
    file at ``path``, paused. Returns (task id, the tree at the pause)."""
    backend = pkg.runtime.MockBackend(respond=_spawning_respond)
    db, store, deps, sup, tm, w = make_stack(
        pkg, backend, db=pkg.db.Database(path, encryption_key="file-key"))
    deps.secrets.put("api_key", f"value-from-{pkg.name}", "d", "agent-x")
    pkg.store.CredentialStore(db).put(
        "svc", {"type": "bearer", "token": f"tok-{pkg.name}"})
    store.save_profile("worker", {"model_pool": list(POOL)})
    task_id, root = await tm.create_task("delegate then idle",
                                         model_pool=list(POOL), budget="10")
    await w.until(lambda: root.children and len(deps.registry) == 2
                  and all_idle(deps))
    tree = tree_view(deps, task_id)
    escrow = escrow_view(deps, task_id)
    await tm.pause_task(task_id)
    db.close()
    return task_id, tree, escrow


async def _restore(pkg, path, task_id):
    db = pkg.db.Database(path, encryption_key="file-key")
    store = pkg.store.Persistence(db)
    backend = pkg.runtime.MockBackend(respond=_spawning_respond)
    deps, tm, w = fresh_stack(pkg, backend, db, store)
    n = await tm.restore_task(task_id)
    tree = tree_view(deps, task_id)
    escrow = escrow_view(deps, task_id)
    secrets = (deps.secrets.lookup("api_key"),
               pkg.store.CredentialStore(db).get("svc"),
               store.get_profile("worker"))
    await tm.pause_task(task_id)
    db.close()
    return n, tree, escrow, secrets


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_a_file_written_by_one_package_is_restored_by_the_other(
        tmp_path, writer, reader):
    path = str(tmp_path / "q.db")
    task_id, tree, escrow = run(_create_and_pause(writer, path))
    n, tree2, escrow2, (secret, cred, profile) = run(
        _restore(reader, path, task_id))
    assert n == 2
    assert view(tree2) == view(tree), first_difference(view(tree),
                                                       view(tree2))
    assert view(escrow2) == view(escrow)
    assert secret == f"value-from-{writer.name}"
    assert cred == {"type": "bearer", "token": f"tok-{writer.name}"}
    assert profile == {"model_pool": POOL}
    # and back: the reader's own pause is read by the writer
    n3, tree3, _, _ = run(_restore(writer, path, task_id))
    assert n3 == 2 and view(tree3) == view(tree)
