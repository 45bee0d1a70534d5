"""The world-facing actions of the port (``actions/world.py``: fetch_web,
call_api, call_mcp, answer_engine, generate_images, over ``infra/http.py``,
``infra/mcp.py``, ``utils/html_md.py``, ``models/images.py`` and the
``CredentialStore``) against the JAX package's: the 18 cases of
tests/test_world_actions.py, each run through both packages with the same
``FakeHttp`` scripts, the same stdio MCP server scripts (real
subprocesses of ``sys.executable``) and each package's ``MockBackend``;
the observations (results, the requests that went out, tool lists,
errors, rows) must agree, ids and times dropped.

No test waits on a clock: agents are awaited through the ``Watch`` of
tests/_agent_parity.py, and a closed MCP server through its process's
``wait()``."""

import json
import os
import sys

import pytest

from _agent_parity import BOTH, JAX, PORT, Env, both, install_watch, j

POOL = ["mock:consensus-model-1", "mock:consensus-model-2",
        "mock:consensus-model-3"]


@pytest.fixture(autouse=True)
def watched(monkeypatch):
    install_watch(monkeypatch)
    for pkg in BOTH:
        pkg.treeobs.reset()


def scripted(pkg, *entries):
    return pkg.runtime.MockBackend(
        scripts={m: list(entries) for m in POOL},
        respond=lambda r: j("wait", {}))


def results_of(core):
    return [e for e in core.ctx.history(POOL[0]) if e.kind == "result"]


def fenced_result(entry) -> dict:
    """The action result inside a NO_EXECUTE-fenced history entry."""
    return json.loads(entry.content.split("\n", 2)[2]
                      .rsplit("</NO_EXECUTE>", 1)[0])["result"]


async def run_actions(pkg, backend, n_results=1, working_dir=None,
                      **deps_over):
    """Start one agent over ``backend`` with ``deps_over`` in its deps,
    post one message and wait for ``n_results`` action results. Returns
    (core, the results' texts)."""
    deps_over.setdefault("ssrf_check", False)
    env = Env(pkg, backend, **deps_over)
    over = {"working_dir": working_dir} if working_dir else {}
    core = await env.sup.start_agent(pkg.state.AgentConfig(
        agent_id="agent-w", task_id="t1", model_pool=list(POOL), **over))
    core.post({"type": "user_message", "content": "go", "from": "user"})
    await env.w.until(lambda: len(results_of(core)) >= n_results)
    texts = [e.as_text() for e in results_of(core)][:n_results]
    await env.sup.terminate_agent("agent-w")
    env.close()
    return core, texts


# ---------------------------------------------------------------------------
# html -> markdown, SSRF
# ---------------------------------------------------------------------------

def test_html_to_markdown():
    html = """<html><head><title>x</title><script>evil()</script></head>
    <body><h1>Title</h1><p>Hello <b>world</b>, see
    <a href="https://x.example/doc">the doc</a>.</p>
    <ul><li>alpha</li><li>beta</li></ul>
    <pre><code>x = 1</code></pre>
    <blockquote>quoted <i>it</i></blockquote>
    <ol><li>one</li></ol><img src="a.png" alt="pic">
    <table><tr><th>h</th><td>d &amp; e</td></tr></table></body></html>"""
    md = both(lambda pkg: pkg.html_md.html_to_markdown(html))
    assert "# Title" in md
    assert "**world**" in md
    assert "[the doc](https://x.example/doc)" in md
    assert "- alpha" in md and "- beta" in md
    assert "x = 1" in md
    assert "evil" not in md


def test_ssrf_check_blocks_private():
    def case(pkg):
        out = []
        for url in ("http://127.0.0.1/admin", "ftp://example.com/x",
                    "http:///nohost", "http://10.1.2.3/x",
                    "http://169.254.169.254/latest"):
            try:
                pkg.http.check_ssrf(url)
                out.append("passed")
            except pkg.http.SSRFError as e:
                out.append(str(e))
        return out
    got = both(case)
    assert "passed" not in got


# ---------------------------------------------------------------------------
# fetch_web / call_api through a live agent
# ---------------------------------------------------------------------------

def test_fetch_web_converts_html_and_fences_output():
    def case(pkg):
        async def main():
            http = pkg.http.FakeHttp({"https://site.example": (
                200, "text/html",
                "<h1>Doc</h1><p>body text <script>ignore()</script></p>")})
            backend = scripted(
                pkg, j("fetch_web", {"url": "https://site.example/page"}),
                j("wait", {}))
            _, texts = await run_actions(pkg, backend, http=http)
            return texts, http.requests
        return main()
    (text,), requests = both(case)
    assert "# Doc" in text and "body text" in text
    assert "ignore()" not in text
    assert "NO_EXECUTE" in text            # untrusted output is fenced
    assert requests[0]["url"] == "https://site.example/page"


def test_fetch_web_image_returns_base64():
    def case(pkg):
        async def main():
            http = pkg.http.FakeHttp({"https://img.example": (
                200, "image/png", b"\x89PNG fakebytes")})
            backend = scripted(
                pkg, j("fetch_web", {"url": "https://img.example/x.png"}),
                j("wait", {}))
            return (await run_actions(pkg, backend, http=http))[1]
        return main()
    (text,) = both(case)
    assert "image_base64" in text and "image/png" in text


def test_call_api_jsonrpc_and_graphql():
    def case(pkg):
        def rpc(url, method, headers, body):
            req = json.loads(body)
            assert req["jsonrpc"] == "2.0"
            return (200, "application/json",
                    json.dumps({"jsonrpc": "2.0", "id": req["id"],
                                "result": {"sum": 42}}))

        def gql(url, method, headers, body):
            assert "query" in json.loads(body)
            return (200, "application/json",
                    json.dumps({"data": {"user": {"name": "ada"}}}))

        async def main():
            http = pkg.http.FakeHttp({"https://rpc.example": rpc,
                                      "https://gql.example": gql})
            backend = scripted(
                pkg,
                j("call_api", {"url": "https://rpc.example",
                               "method": "POST", "protocol": "jsonrpc",
                               "body": {"method": "add",
                                        "params": [40, 2]}}),
                j("call_api", {"url": "https://gql.example",
                               "method": "POST", "protocol": "graphql",
                               "body": {"query": "{user{name}}"},
                               "auth": {"type": "bearer",
                                        "token": "tkn"}}),
                j("wait", {}))
            _, texts = await run_actions(pkg, backend, n_results=2,
                                         http=http)
            return texts, http.requests
        return main()
    texts, requests = both(case)
    assert any('"sum": 42' in t for t in texts)
    assert any('"name": "ada"' in t for t in texts)
    assert any(r["headers"].get("Authorization") == "Bearer tkn"
               for r in requests)


def test_call_api_http_error_status():
    def case(pkg):
        async def main():
            http = pkg.http.FakeHttp({"https://api.example": (
                500, "text/plain", "boom")})
            backend = scripted(
                pkg, j("call_api", {"url": "https://api.example",
                                    "method": "GET"}), j("wait", {}))
            return (await run_actions(pkg, backend, http=http))[1]
        return main()
    (text,) = both(case)
    assert '"status": "error"' in text and "HTTP 500" in text


# ---------------------------------------------------------------------------
# call_mcp against real stdio MCP server subprocesses
# ---------------------------------------------------------------------------

MCP_SERVER = r'''
import json, sys
tools = [{"name": "adder", "description": "adds a and b",
          "inputSchema": {"type": "object"}}]
for line in sys.stdin:
    msg = json.loads(line)
    mid = msg.get("id")
    method = msg.get("method")
    if mid is None:
        continue  # notification
    if method == "initialize":
        result = {"protocolVersion": msg["params"]["protocolVersion"],
                  "capabilities": {"tools": {}},
                  "serverInfo": {"name": "testsrv", "version": "0"}}
    elif method == "tools/list":
        result = {"tools": tools}
    elif method == "tools/call":
        args = msg["params"]["arguments"]
        result = {"content": [{"type": "text",
                               "text": str(args["a"] + args["b"])}]}
    else:
        result = {}
    sys.stdout.write(json.dumps({"jsonrpc": "2.0", "id": mid,
                                 "result": result}) + "\n")
    sys.stdout.flush()
'''

MCP_DYING_SERVER = r'''
import json, os, sys
marker = sys.argv[1]          # dies on the first-ever call, then recovers
for line in sys.stdin:
    msg = json.loads(line)
    mid = msg.get("id")
    method = msg.get("method")
    if mid is None:
        continue
    if method == "initialize":
        result = {"protocolVersion": msg["params"]["protocolVersion"],
                  "capabilities": {"tools": {}},
                  "serverInfo": {"name": "dying", "version": "0"}}
    elif method == "tools/list":
        result = {"tools": [{"name": "boom", "inputSchema": {}}]}
    elif method == "tools/call":
        if not os.path.exists(marker):
            open(marker, "w").close()
            sys.stderr.write("FATAL: tool exploded spectacularly\n")
            sys.stderr.flush()
            sys.exit(3)              # die MID-CALL, stderr explains why
        result = {"content": [{"type": "text", "text": "recovered"}]}
    else:
        result = {}
    sys.stdout.write(json.dumps({"jsonrpc": "2.0", "id": mid,
                                 "result": result}) + "\n")
    sys.stdout.flush()
'''


def server_dir(tmp_path, pkg):
    """Each package's own directory, of the same length (paths can
    reach results)."""
    d = tmp_path / ("p0" if pkg is JAX else "p1")
    d.mkdir(exist_ok=True)
    return d


def stdio_manager(pkg, script_path, *args, name="calc"):
    return pkg.mcp.MCPManager({name: {
        "transport": "stdio",
        "command": [sys.executable, str(script_path), *args]}})


def test_call_mcp_stdio_end_to_end(tmp_path):
    def case(pkg):
        async def main():
            server_py = server_dir(tmp_path, pkg) / "mcp_server.py"
            server_py.write_text(MCP_SERVER)
            mcp = stdio_manager(pkg, server_py)
            tools = await mcp.list_tools("calc")
            backend = scripted(
                pkg, j("call_mcp", {"server": "calc", "tool": "adder",
                                    "arguments": {"a": 19, "b": 23}}),
                j("wait", {}))
            _, (text,) = await run_actions(pkg, backend, mcp=mcp)
            # unknown server surfaces as an action error
            backend2 = scripted(
                pkg, j("call_mcp", {"server": "nope", "tool": "x"}),
                j("wait", {}))
            _, (text2,) = await run_actions(pkg, backend2, mcp=mcp)
            await mcp.close()
            return tools, text, text2
        return main()
    tools, text, text2 = both(case)
    assert tools[0]["name"] == "adder"
    assert '"content": "42"' in text and "NO_EXECUTE" in text
    assert "unknown MCP server" in text2


def test_mcp_server_death_mid_call_surfaces_stderr_and_reconnects(tmp_path):
    """A stdio server dying mid-call fails THAT call with its stderr tail
    and exit code; the next call reconnects to a fresh process."""
    def case(pkg):
        async def main():
            d = server_dir(tmp_path, pkg)
            server_py = d / "dying_server.py"
            server_py.write_text(MCP_DYING_SERVER)
            mcp = stdio_manager(pkg, server_py, str(d / "died"),
                                name="dying")
            tools = await mcp.list_tools("dying", agent_id="agent-x")
            try:
                await mcp.call_tool("dying", "boom", {},
                                    agent_id="agent-x")
                err = None
            except pkg.mcp.MCPError as e:
                err = str(e)
            ctx = mcp.error_context("dying")
            result = await mcp.call_tool("dying", "boom", {},
                                         agent_id="agent-x")
            await mcp.close()
            return tools, err, ctx, result
        return main()
    tools, err, ctx, result = both(case)
    assert tools[0]["name"] == "boom"
    assert "exploded spectacularly" in err and "exit code 3" in err
    assert "exploded" in ctx
    assert result["content"][0]["text"] == "recovered"


def test_mcp_tool_list_cached_per_connection(tmp_path):
    """tools/list hits the wire once per connection: the second list is
    the cached object."""
    script = (MCP_SERVER.replace(
        '"tools": tools}',
        '"tools": tools, "_hits": globals().setdefault("h", 0)}')
        .replace('elif method == "tools/list":',
                 'elif method == "tools/list":\n'
                 '        globals()["h"] = globals().get("h", 0) + 1'))

    def case(pkg):
        async def main():
            server_py = server_dir(tmp_path, pkg) / "counting_server.py"
            server_py.write_text(script)
            mcp = stdio_manager(pkg, server_py)
            t1 = await mcp.list_tools("calc")
            t2 = await mcp.list_tools("calc")
            await mcp.close()
            return t1 is t2, t1
        return main()
    same, tools = both(case)
    assert same and tools[0]["name"] == "adder"


def test_mcp_connections_close_on_agent_release(tmp_path):
    """Releasing the only agent using a connection closes it; a
    connection shared with a live agent survives."""
    def case(pkg):
        async def main():
            server_py = server_dir(tmp_path, pkg) / "mcp_server.py"
            server_py.write_text(MCP_SERVER)
            mcp = stdio_manager(pkg, server_py)
            await mcp.list_tools("calc", agent_id="a1")
            await mcp.list_tools("calc", agent_id="a2")
            conn = mcp._connections[mcp.configs["calc"].dedup_key()]
            await mcp.release_agent("a1")
            after_a1 = conn.alive
            await mcp.release_agent("a2")
            await conn.proc.wait()            # the kill lands
            out = (after_a1, conn.alive, dict(mcp._connections))
            await mcp.close()
            return out
        return main()
    after_a1, alive, conns = both(case)
    assert after_a1 and not alive and conns == {}


def test_supervisor_releases_the_agents_mcp_connections(tmp_path):
    """The supervisor's teardown releases a terminated agent's MCP
    connections: its call_mcp opened one, and terminating the agent
    closes it."""
    def case(pkg):
        async def main():
            server_py = server_dir(tmp_path, pkg) / "mcp_server.py"
            server_py.write_text(MCP_SERVER)
            mcp = stdio_manager(pkg, server_py)
            backend = scripted(
                pkg, j("call_mcp", {"server": "calc", "tool": "adder",
                                    "arguments": {"a": 1, "b": 2}}),
                j("wait", {}))
            _, (text,) = await run_actions(pkg, backend, mcp=mcp)
            out = (text, dict(mcp._connections), dict(mcp._users))
            await mcp.close()
            return out
        return main()
    text, conns, users = both(case)
    assert '"content": "3"' in text and conns == {} and users == {}


# ---------------------------------------------------------------------------
# answer_engine / generate_images / zero egress
# ---------------------------------------------------------------------------

def answer_respond(answer, query, seen=None):
    def respond(r):
        joined = "\n".join(str(m.get("content", "")) for m in r.messages)
        if "Answer the question" in joined:     # the grounding query
            if seen is not None:
                seen.append(joined)
            return answer
        if '"answer"' in joined:                # result seen: idle
            return j("wait", {})
        return j("answer_engine", {"query": query})
    return respond


def test_answer_engine_uses_designated_model():
    def case(pkg):
        async def main():
            backend = pkg.runtime.MockBackend(
                respond=answer_respond("The answer is 4.", "what is 2+2?"))
            _, (text,) = await run_actions(pkg, backend)
            grounding = [r for r in backend.calls if r.session_id is None]
            return text, [(r.model_spec, r.temperature, r.messages)
                          for r in grounding]
        return main()
    text, grounding = both(case)
    assert "The answer is 4." in text and "NO_EXECUTE" in text
    assert grounding[0][0] == POOL[0] and grounding[0][1] == 0.3


def search_store(pkg, url="https://search.example/?q={query}"):
    store = pkg.store.Persistence(pkg.db.Database(":memory:"))
    store.set_setting("answer_engine_search_url", url)
    return store


def test_answer_engine_multi_source_grounding():
    """Search page → top-k result links → per-source fetch and extract →
    numbered citations in the grounding prompt, per-source metadata in
    the result."""
    search_html = (
        '<div class="r"><a href="https://a.example/page">Alpha '
        'doc</a></div>'
        '<a href="/internal">nav</a>'
        '<a href="https://b.example/post">Beta <b>post</b></a>'
        '<a href="https://a.example/page">Alpha doc</a>'
        '<a href="https://c.example/x">Gamma</a>')

    def case(pkg):
        async def main():
            http = pkg.http.FakeHttp({
                "https://search.example/?q=why%20is%20the%20sky%20blue":
                    (200, "text/html", search_html),
                "https://a.example/page":
                    (200, "text/html",
                     "<p>Rayleigh scattering explains it.</p>"),
                "https://b.example/post":
                    (200, "text/html", "<p>Blue light scatters more.</p>"),
            })
            seen = []
            backend = pkg.runtime.MockBackend(respond=answer_respond(
                "Rayleigh scattering [1][2].", "why is the sky blue",
                seen))
            core, (text,) = await run_actions(
                pkg, backend, http=http, persistence=search_store(pkg))
            return (text, fenced_result(results_of(core)[0]), seen,
                    sorted(r["url"] for r in http.requests))
        return main()
    text, result, seen, urls = both(case)
    assert "Rayleigh scattering [1][2]." in text
    srcs = {s["url"]: s for s in result["sources"]}
    assert srcs["https://a.example/page"]["title"] == "Alpha doc"
    assert srcs["https://b.example/post"]["title"] == "Beta post"
    assert srcs["https://c.example/x"]["fetched"] is False
    assert [s["index"] for s in result["sources"]] == [1, 2, 3]
    assert "[1] Alpha doc (https://a.example/page)" in seen[0]
    assert "[2] Beta post (https://b.example/post)" in seen[0]


def test_answer_engine_ssrf_guards_content_derived_links():
    """With the SSRF guard on, a link-local metadata URL among the
    search results is never fetched; the public source still grounds."""
    search_html = (
        '<a href="http://169.254.169.254/latest/meta-data/">evil</a>'
        '<a href="http://8.8.8.8/page">Fine page</a>')

    def case(pkg):
        async def main():
            http = pkg.http.FakeHttp({
                "https://search.example/?q=q": (200, "text/html",
                                                search_html),
                "http://169.254.169.254": (200, "text/plain",
                                           "SECRET-CREDS"),
                "http://8.8.8.8/page": (200, "text/html", "<p>useful</p>"),
            })
            seen = []
            backend = pkg.runtime.MockBackend(
                respond=answer_respond("grounded answer", "q", seen))
            core, _ = await run_actions(
                pkg, backend, http=http, persistence=search_store(pkg),
                ssrf_check=True)
            return (fenced_result(results_of(core)[0]), seen,
                    [r["url"] for r in http.requests])
        return main()
    result, seen, urls = both(case)
    srcs = {s["url"]: s for s in result["sources"]}
    assert srcs["http://169.254.169.254/latest/meta-data/"][
        "fetched"] is False
    assert srcs["http://8.8.8.8/page"]["fetched"] is True
    assert not any("169.254" in u for u in urls)
    assert "SECRET-CREDS" not in seen[0]


def test_generate_images_procedural(tmp_path):
    def case(pkg):
        async def main():
            d = server_dir(tmp_path, pkg)
            backend = scripted(
                pkg, j("generate_images", {"prompt": "a red square",
                                           "count": 2, "size": "32x32"}),
                j("wait", {}))
            core, _ = await run_actions(
                pkg, backend, working_dir=str(d),
                images=pkg.images.ProceduralImageBackend())
            result = results_of(core)[0].content["result"]
            files = []
            for img in result["images"]:
                with open(img["path"], "rb") as f:
                    files.append(f.read())
                img["path"] = os.path.dirname(img["path"]) == str(d)
            return result, files
        return main()
    result, files = both(case)
    assert result["status"] == "ok" and len(result["images"]) == 2
    assert all(img["path"] for img in result["images"])
    assert all(f[:8] == b"\x89PNG\r\n\x1a\n" for f in files)
    assert files[0] != files[1]


def test_zero_egress_mode_fails_cleanly():
    def case(pkg):
        async def main():
            backend = scripted(
                pkg, j("fetch_web", {"url": "https://x.example"}),
                j("wait", {}))
            return (await run_actions(pkg, backend, http=None))[1]
        return main()
    (text,) = both(case)
    assert "zero-egress" in text


# ---------------------------------------------------------------------------
# The credential store: call_api and MCP auth through the encrypted,
# audited credentials table
# ---------------------------------------------------------------------------

def cred_store(pkg):
    db = pkg.db.Database(":memory:", encryption_key="unit-test-key")
    return pkg.store.CredentialStore(db), db


def test_credential_store_roundtrip_encrypted_and_audited():
    def case(pkg):
        store, db = cred_store(pkg)
        store.put("gh", {"type": "bearer", "token": "tok-123"},
                  model_spec="api:github")
        row = db.query_one("SELECT * FROM credentials WHERE id='gh'")
        at_rest = (row["encrypted"], b"tok-123" in bytes(row["data"]))
        data = store.get("gh", agent_id="agent-z", action="call_api")
        audit = [(r["secret_name"], r["agent_id"], r["action"])
                 for r in db.query("SELECT * FROM secret_usage")]
        out = (at_rest, data, audit, store.list(),
               store.for_model("api:github"), store.delete("gh"),
               store.get("gh"), store.delete("gh"))
        db.close()
        return out
    at_rest, data, audit, meta, for_model, gone, after, again = \
        both(case)
    assert at_rest == (1, False)
    assert data["token"] == "tok-123" and for_model == data
    assert audit == [("credential:gh", "agent-z", "call_api")]
    assert meta == [{"id": "gh", "model_spec": "api:github",
                     "encrypted": True}]
    assert gone and after is None and not again


def test_call_api_credential_auth_resolves_from_store():
    """auth {type: credential, id} pulls the encrypted record: the token
    never passes through the model's context."""
    def case(pkg):
        async def main():
            store, _ = cred_store(pkg)
            store.put("svc", {"type": "header", "name": "X-Api-Key",
                              "value": "sk-55"})
            http = pkg.http.FakeHttp({"https://api.example": (
                200, "application/json", '{"ok": true}')})
            backend = scripted(
                pkg, j("call_api", {"url": "https://api.example/v1",
                                    "method": "GET",
                                    "auth": {"type": "credential",
                                             "id": "svc"}}),
                j("wait", {}))
            _, (text,) = await run_actions(pkg, backend, http=http,
                                           credentials=store)
            backend2 = scripted(
                pkg, j("call_api", {"url": "https://api.example/v1",
                                    "method": "GET",
                                    "auth": {"type": "credential",
                                             "id": "nope"}}),
                j("wait", {}))
            _, (text2,) = await run_actions(pkg, backend2, http=http,
                                            credentials=store)
            return text, text2, http.requests
        return main()
    text, text2, requests = both(case)
    assert '"ok": true' in text
    assert requests[0]["headers"]["X-Api-Key"] == "sk-55"
    assert "unknown credential" in text2


def test_mcp_http_server_uses_stored_credential():
    """An MCP server config naming a credential connects with the
    resolved auth header."""
    def case(pkg):
        async def main():
            store, _ = cred_store(pkg)
            store.put("mcp-auth", {"type": "bearer", "token": "mcp-tok"})

            def rpc(url, method, headers, body):
                msg = json.loads(body)
                result = ({"protocolVersion": "x", "capabilities": {}}
                          if msg["method"] == "initialize"
                          else {"tools": [{"name": "t"}]})
                return pkg.http.HttpResponse(
                    200, {"content-type": "application/json"},
                    json.dumps({"jsonrpc": "2.0", "id": msg["id"],
                                "result": result}).encode(), url)
            http = pkg.http.FakeHttp({"https://mcp.example": rpc})
            mcp = pkg.mcp.MCPManager(
                {"svc": {"transport": "http", "url": "https://mcp.example",
                         "credential": "mcp-auth"}},
                http_fn=http,
                credential_resolver=lambda cid: store.get(
                    cid, agent_id="mcp", action="mcp_connect"))
            tools = await mcp.list_tools("svc")
            await mcp.close()
            return tools, http.requests
        return main()
    tools, requests = both(case)
    assert tools == [{"name": "t"}]
    assert all(r["headers"].get("Authorization") == "Bearer mcp-tok"
               for r in requests)


def test_port_world_modules_are_the_ports():
    """The world actions the port's router runs are the port's own."""
    from quoracle_tpu_torch.actions.executors import EXECUTORS
    for name in ("fetch_web", "call_api", "call_mcp", "answer_engine",
                 "generate_images"):
        assert EXECUTORS[name].__module__ == "quoracle_tpu_torch.actions.world"
    assert PORT.state.AgentDeps.__dataclass_fields__["ssrf_check"].default
