"""MCP (Model Context Protocol) client: stdio + HTTP transports.

Parity with the reference's MCP subsystem (reference lib/quoracle/mcp/ —
per-agent Client GenServer over an AnubisWrapper, stdio and HTTP transports,
tool-list caching, connection dedup by command/url, 120s default timeout,
auth headers with secret templates resolved before connect,
mcp/client.ex:1-15,46-60). Here one MCPManager per Runtime owns deduped
connections; agents call through it via the call_mcp action.

Protocol: JSON-RPC 2.0; stdio transport is newline-delimited JSON over the
server process's stdin/stdout; HTTP transport POSTs JSON-RPC to the server
URL. Handshake: ``initialize`` → ``notifications/initialized`` → tool calls.

The PyTorch port's copy of ``quoracle_tpu/infra/mcp.py``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
from typing import Any, Optional

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 120.0          # reference mcp/client.ex default
PROTOCOL_VERSION = "2025-03-26"


class MCPError(RuntimeError):
    pass


@dataclasses.dataclass
class MCPServerConfig:
    name: str
    transport: str = "stdio"                 # "stdio" | "http"
    command: Optional[list[str]] = None      # stdio
    url: Optional[str] = None                # http
    headers: dict[str, str] = dataclasses.field(default_factory=dict)
    timeout_s: float = DEFAULT_TIMEOUT_S
    credential: Optional[str] = None         # CredentialStore id → auth
                                             # headers resolved at connect
                                             # (reference: secret templates
                                             # resolved before connect)

    def dedup_key(self) -> str:
        """Connections dedup by what they connect TO, not by name
        (reference connection_manager.ex dedup by command/url)."""
        if self.transport == "stdio":
            return "stdio:" + json.dumps(self.command or [])
        return f"http:{self.url}"

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "MCPServerConfig":
        return cls(name=name, transport=d.get("transport", "stdio"),
                   command=d.get("command"), url=d.get("url"),
                   headers=d.get("headers") or {},
                   timeout_s=float(d.get("timeout_s", DEFAULT_TIMEOUT_S)),
                   credential=d.get("credential"))


def auth_headers_from_credential(data: dict) -> dict[str, str]:
    """Credential payload → HTTP auth headers (the ONE shared mapping,
    infra/http.build_auth_headers — call_api and MCP must treat a stored
    credential identically)."""
    from quoracle_tpu_torch.infra.http import build_auth_headers
    try:
        return build_auth_headers(data)
    except ValueError as e:
        raise MCPError(str(e))


STDERR_TAIL_LINES = 40             # bounded per-connection error context


class _StdioConnection:
    def __init__(self, config: MCPServerConfig):
        import collections
        self.config = config
        self.proc: Optional[Any] = None
        self._id = 0
        self._lock = asyncio.Lock()
        self.tools: Optional[list[dict]] = None
        # Error context (reference mcp/error_context.ex: logger output
        # captured per client): the server's stderr tail, drained by a
        # background task so a dying server's last words survive into the
        # agent-visible error instead of vanishing.
        self.stderr_tail: "collections.deque[str]" = collections.deque(
            maxlen=STDERR_TAIL_LINES)
        self._stderr_task: Optional[asyncio.Task] = None

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.returncode is None

    def error_context(self) -> str:
        return "\n".join(self.stderr_tail)

    async def _drain_stderr(self) -> None:
        assert self.proc is not None and self.proc.stderr is not None
        while True:
            line = await self.proc.stderr.readline()
            if not line:
                return
            self.stderr_tail.append(
                line.decode("utf-8", errors="replace").rstrip("\n"))

    def _death_note(self) -> str:
        ctx = self.error_context()
        rc = self.proc.returncode if self.proc else None
        note = f" (exit code {rc})" if rc is not None else ""
        return note + (f"; stderr tail:\n{ctx}" if ctx else "")

    async def start(self) -> None:
        if not self.config.command:
            raise MCPError(f"server {self.config.name}: no command")
        self.proc = await asyncio.create_subprocess_exec(
            *self.config.command,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
            start_new_session=True)
        self._stderr_task = asyncio.get_running_loop().create_task(
            self._drain_stderr())
        await self._request("initialize", {
            "protocolVersion": PROTOCOL_VERSION,
            "capabilities": {},
            "clientInfo": {"name": "quoracle-tpu", "version": "0.1"},
        })
        await self._notify("notifications/initialized", {})

    async def _send(self, payload: dict) -> None:
        assert self.proc is not None and self.proc.stdin is not None
        self.proc.stdin.write((json.dumps(payload) + "\n").encode())
        await self.proc.stdin.drain()

    async def _notify(self, method: str, params: dict) -> None:
        await self._send({"jsonrpc": "2.0", "method": method,
                          "params": params})

    async def _request(self, method: str, params: dict,
                       timeout_s: Optional[float] = None) -> Any:
        async with self._lock:                # one in-flight request per conn
            self._id += 1
            rid = self._id
            await self._send({"jsonrpc": "2.0", "id": rid, "method": method,
                              "params": params})
            assert self.proc is not None and self.proc.stdout is not None
            # One deadline for the WHOLE request — a server emitting noise
            # lines must not keep extending a per-read timeout.
            loop = asyncio.get_running_loop()
            deadline = loop.time() + (timeout_s or self.config.timeout_s)
            while True:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    raise asyncio.TimeoutError(
                        f"{method} timed out on {self.config.name}")
                line = await asyncio.wait_for(self.proc.stdout.readline(),
                                              remaining)
                if not line:
                    # give the stderr drain a beat to collect last words
                    await asyncio.sleep(0.05)
                    raise MCPError(f"server {self.config.name} closed the "
                                   f"stdio stream{self._death_note()}")
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue                 # server log noise on stdout
                if msg.get("id") != rid:
                    continue                 # notification / stale response
                if "error" in msg:
                    err = msg["error"]
                    raise MCPError(f"{method} failed: "
                                   f"{err.get('message')} ({err.get('code')})")
                return msg.get("result")

    async def close(self) -> None:
        if self._stderr_task is not None:
            self._stderr_task.cancel()
            self._stderr_task = None
        if self.proc is not None and self.proc.returncode is None:
            from quoracle_tpu_torch.actions.router import (
                close_subprocess_transport, kill_process_group,
            )
            kill_process_group(self.proc)
            for _ in range(100):
                if self.proc.returncode is not None:
                    break
                await asyncio.sleep(0.01)
            close_subprocess_transport(self.proc)


class _HttpConnection:
    alive = True                             # stateless transport

    def __init__(self, config: MCPServerConfig, http_fn):
        self.config = config
        self._http = http_fn
        self._id = 0
        self.tools: Optional[list[dict]] = None

    def error_context(self) -> str:
        return ""

    async def start(self) -> None:
        await self._request("initialize", {
            "protocolVersion": PROTOCOL_VERSION, "capabilities": {},
            "clientInfo": {"name": "quoracle-tpu", "version": "0.1"}})

    async def _request(self, method: str, params: dict,
                       timeout_s: Optional[float] = None) -> Any:
        self._id += 1
        payload = json.dumps({"jsonrpc": "2.0", "id": self._id,
                              "method": method, "params": params}).encode()
        headers = {"content-type": "application/json",
                   "accept": "application/json", **self.config.headers}
        loop = asyncio.get_running_loop()
        resp = await loop.run_in_executor(
            None, lambda: self._http(
                self.config.url, "POST", headers, payload,
                timeout_s or self.config.timeout_s))
        if resp.status >= 400:
            raise MCPError(f"HTTP {resp.status} from {self.config.name}")
        msg = json.loads(resp.body or b"{}")
        if "error" in msg:
            err = msg["error"]
            raise MCPError(f"{method} failed: {err.get('message')} "
                           f"({err.get('code')})")
        return msg.get("result")

    async def close(self) -> None:
        pass


class MCPManager:
    """Owns connections, dedups by target, caches tool lists (reference
    connection_manager.ex + client.ex tool-list caching)."""

    def __init__(self, configs: Optional[dict[str, dict]] = None,
                 http_fn=None, credential_resolver=None):
        from quoracle_tpu_torch.infra.http import urllib_http
        self.configs: dict[str, MCPServerConfig] = {
            name: MCPServerConfig.from_dict(name, d)
            for name, d in (configs or {}).items()}
        self._http = http_fn or urllib_http
        # id -> credential payload dict (persistence.store.CredentialStore
        # .get); resolved at CONNECT time so rotated credentials take
        # effect on reconnect without a restart
        self._resolve_credential = credential_resolver
        self._bg_tasks: set = set()
        self._connections: dict[str, Any] = {}
        self._lock = asyncio.Lock()              # guards the dicts only
        self._key_locks: dict[str, asyncio.Lock] = {}
        self._users: dict[str, set[str]] = {}    # dedup key -> agent ids

    def add_server(self, name: str, config: dict) -> None:
        self.configs[name] = MCPServerConfig.from_dict(name, config)

    async def _connection(self, server: str, agent_id: Optional[str] = None):
        config = self.configs.get(server)
        if config is None:
            raise MCPError(
                f"unknown MCP server {server!r}; configured: "
                f"{', '.join(sorted(self.configs)) or '(none)'}")
        key = config.dedup_key()
        async with self._lock:
            conn = self._connections.get(key)
            if conn is not None and not conn.alive:
                # the server process died since the last call: retire the
                # dead connection (tool cache included) and reconnect —
                # one crashed tool call must not poison the target forever
                logger.warning("MCP server %s died%s; reconnecting",
                               config.name,
                               conn._death_note()
                               if hasattr(conn, "_death_note") else "")
                self._connections.pop(key, None)
                dead, conn = conn, None
                # keep a strong reference: the loop holds only a weak one,
                # and a GC'd close task would leak the defunct child
                t = asyncio.get_running_loop().create_task(dead.close())
                self._bg_tasks.add(t)
                t.add_done_callback(self._bg_tasks.discard)
            if conn is not None:
                if agent_id:
                    self._users.setdefault(key, set()).add(agent_id)
                return conn
            key_lock = self._key_locks.setdefault(key, asyncio.Lock())
        # Connect under a per-target lock so one slow/hung server's 120s
        # handshake can't stall calls to healthy servers.
        async with key_lock:
            async with self._lock:
                conn = self._connections.get(key)
                if conn is not None:
                    # EVERY return path registers the caller, or a
                    # release_agent for the connection's creator could
                    # close it under this agent
                    if agent_id:
                        self._users.setdefault(key, set()).add(agent_id)
                    return conn
            if config.credential:
                if self._resolve_credential is None:
                    raise MCPError(
                        f"server {config.name} names credential "
                        f"{config.credential!r} but no credential store "
                        f"is wired")
                data = self._resolve_credential(config.credential)
                if data is None:
                    raise MCPError(
                        f"server {config.name}: credential "
                        f"{config.credential!r} not found")
                config = dataclasses.replace(
                    config, headers={**config.headers,
                                     **auth_headers_from_credential(data)})
            conn = (_StdioConnection(config)
                    if config.transport == "stdio"
                    else _HttpConnection(config, self._http))
            try:
                await conn.start()
            except BaseException:
                # Handshake failure must not orphan the spawned server
                # process; retries would accumulate zombies otherwise.
                try:
                    await conn.close()
                except Exception:
                    logger.exception("MCP close after failed start")
                raise
            async with self._lock:
                self._connections[key] = conn
                if agent_id:
                    self._users.setdefault(key, set()).add(agent_id)
            return conn

    async def list_tools(self, server: str,
                         agent_id: Optional[str] = None) -> list[dict]:
        conn = await self._connection(server, agent_id)
        if conn.tools is None:   # cached per connection (mcp/client.ex:1-15)
            result = await conn._request("tools/list", {})
            conn.tools = (result or {}).get("tools", [])
        return conn.tools

    async def call_tool(self, server: str, tool: str, arguments: dict,
                        timeout_s: Optional[float] = None,
                        agent_id: Optional[str] = None) -> Any:
        conn = await self._connection(server, agent_id)
        return await conn._request(
            "tools/call", {"name": tool, "arguments": arguments},
            timeout_s=timeout_s)

    def error_context(self, server: str) -> str:
        """The server's captured stderr tail (empty for http / unknown) —
        surfaced into agent-visible errors (reference error_context.ex)."""
        config = self.configs.get(server)
        if config is None:
            return ""
        conn = self._connections.get(config.dedup_key())
        return conn.error_context() if conn is not None else ""

    async def release_agent(self, agent_id: str) -> None:
        """Teardown on agent dismiss: drop the agent from every
        connection's user set and close connections no live agent uses
        (reference: per-agent Client GenServers die with their agent; the
        deduped equivalent is refcounting). Connections acquired without
        an agent id (runtime-level callers, tests) are never auto-closed."""
        to_close = []
        async with self._lock:
            for key, users in list(self._users.items()):
                users.discard(agent_id)
                if not users:
                    del self._users[key]
                    conn = self._connections.pop(key, None)
                    if conn is not None:
                        to_close.append(conn)
        for conn in to_close:
            try:
                await conn.close()
            except Exception:
                logger.exception("MCP close on agent release failed")

    async def close(self) -> None:
        for conn in self._connections.values():
            try:
                await conn.close()
            except Exception:
                logger.exception("MCP connection close failed")
        self._connections.clear()
        self._users.clear()
