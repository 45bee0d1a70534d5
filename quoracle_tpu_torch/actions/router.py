"""Per-action ephemeral router + long-running shell command ownership.

Parity with the reference's Actions.Router (reference
lib/quoracle/actions/router.ex:3-8,42-85): one router per dispatched action,
living only until the action completes. The reference needs a GenServer here
for process isolation and deadlock avoidance (a slow shell command must not
block the agent, and Router.execute must not be called from inside Core —
agent AGENTS.md:237-247); on asyncio the same isolation is one Task per
action, and results return to the Core by posting to its mailbox, never by
calling into it.

Long-running shell commands outlive their action (reference
router.ex:319-351 async mode): each gets its own ShellOwner that holds the
OS process, pumps output into a buffer from the moment of launch, and posts
a completion info message to the Core when the process exits. Later
execute_shell decisions with ``check_id`` resolve to the owner through
``core.shell_routers`` (reference action_executor.ex:121-144 routes check_id
to the same Router). One owner per command — a batch action can hold several
concurrent commands without them clobbering each other.

Secret resolution happens just before execution and output scrubbing just
after (reference router/security.ex; router.ex:324-331), so plaintext secret
values exist only inside the router's execution window. Untrusted-output
actions get NO_EXECUTE wrapping at the Core when the result enters history.

The PyTorch port's copy of ``quoracle_tpu/actions/router.py`` (its
``ACTION_MS``, ``ACTIONS_TOTAL`` and ``TRACER`` are the port's
``infra/telemetry.py``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Any, Optional

from quoracle_tpu_torch.actions.executors import ActionError, get_executor
from quoracle_tpu_torch.infra.security import resolve_secrets, scrub_output
from quoracle_tpu_torch.infra.telemetry import ACTION_MS, ACTIONS_TOTAL, TRACER

logger = logging.getLogger(__name__)

# Output cap for shell/file results entering model context (the reference
# truncates via Utils.ResponseTruncator).
MAX_RESULT_CHARS = 100_000


def truncate_output(text: str, limit: int = MAX_RESULT_CHARS) -> str:
    if len(text) <= limit:
        return text
    half = limit // 2
    omitted = len(text) - 2 * half
    return (text[:half] + f"\n…[{omitted} chars truncated]…\n" + text[-half:])


class ActionRouter:
    """Executes exactly one action, then posts the result to the Core's
    mailbox and dies."""

    def __init__(self, core: Any, action_id: str, action: str, params: dict):
        self.core = core
        self.action_id = action_id
        self.action = action
        self.params = params
        self.task: Optional[asyncio.Task] = None

    def dispatch(self) -> None:
        self.task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        core, deps = self.core, self.core.deps
        deps.events.action_started(core.agent_id, self.action_id, self.action,
                                   self.params)
        # Unbound span (telemetry.py): routers interleave on the event
        # loop, so a thread-local current-span binding would leak across
        # tasks — the span links by explicit trace_id (the task) instead.
        span = TRACER.start("action.execute",
                            trace_id=core.config.task_id, parent=None,
                            agent_id=core.agent_id, action=self.action,
                            phase="action")
        t0 = time.monotonic()
        try:
            params, _used = resolve_secrets(
                self.params,
                lambda name: deps.secrets.lookup(
                    name, agent_id=core.agent_id, action=self.action))
            fn = get_executor(self.action)
            result = await fn(core, self, params)
            if "status" not in result:
                result["status"] = "ok"
        except ActionError as e:
            result = {"status": "error", "error": str(e)}
        except asyncio.CancelledError:
            # Core is terminating (reference router.ex:433-446 — routers die
            # with their Core); no result to deliver.
            raise
        except Exception as e:
            logger.exception("action %s (%s) crashed", self.action,
                             self.action_id)
            result = {"status": "error",
                      "error": f"{type(e).__name__}: {e}"}
        result = scrub_output(result, deps.secrets.values())
        span.finish(status=result["status"])
        ACTION_MS.observe((time.monotonic() - t0) * 1000,
                          action=self.action)
        ACTIONS_TOTAL.inc(action=self.action, status=result["status"])
        deps.events.action_completed(core.agent_id, self.action_id,
                                     self.action, result["status"])
        core.post({"type": "action_result", "action_id": self.action_id,
                   "action": self.action, "result": result})

    async def shutdown(self) -> None:
        """Core teardown (reference core.ex:452-462 stops all active Routers
        with :infinity timeout). Live shell commands have their own owners in
        core.shell_routers and are shut down there."""
        if self.task is not None and not self.task.done():
            self.task.cancel()
            try:
                await self.task
            except (asyncio.CancelledError, Exception):
                pass


# ---------------------------------------------------------------------------
# Long-running shell command ownership
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShellCommand:
    """State of one OS command (reference router/shell_command_manager.ex)."""
    command_id: str
    command: str
    proc: Any                         # asyncio.subprocess.Process
    started_at: float
    output: bytearray = dataclasses.field(default_factory=bytearray)
    status: str = "running"           # running | completed | terminated | timeout
    exit_code: Optional[int] = None

    def output_text(self) -> str:
        return self.output.decode("utf-8", errors="replace")


def kill_process_group(proc: Any) -> None:
    """Best-effort synchronous SIGKILL of a command's whole process group
    (commands run with start_new_session=True)."""
    import os
    import signal
    if proc.returncode is not None:
        return
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.kill()
        except ProcessLookupError:
            pass


def close_subprocess_transport(proc: Any) -> None:
    """Release a subprocess transport eagerly. asyncio only closes it via GC
    after both exit and pipe-EOF callbacks run; a loop shutting down right
    after a command finishes would warn about the leak."""
    tr = getattr(proc, "_transport", None)
    if tr is not None:
        tr.close()


async def pump_stream(stream: asyncio.StreamReader, buf: bytearray) -> None:
    """Drain a process stream into a buffer until EOF. Started at launch so
    no output is ever lost to the sync/async handoff."""
    while True:
        chunk = await stream.read(65536)
        if not chunk:
            return
        buf.extend(chunk)


class ShellOwner:
    """Owns one async-mode command: watches it to completion, serves
    check_id polls/terminations, and kills the OS process on teardown."""

    def __init__(self, core: Any, cmd: ShellCommand, pump: asyncio.Task):
        self.core = core
        self.cmd = cmd
        self._pump = pump
        self._watcher: Optional[asyncio.Task] = None

    def adopt(self, timeout: Optional[float]) -> None:
        self.core.shell_routers[self.cmd.command_id] = self
        self._watcher = asyncio.ensure_future(self._watch(timeout))

    async def _watch(self, timeout: Optional[float]) -> None:
        cmd = self.cmd
        try:
            # Wait for process exit by polling returncode (set on SIGCHLD):
            # proc.wait() is gated on pipe EOF, which a daemonized
            # descendant can hold open forever, and the pump has the same
            # failure mode — neither is a reliable exit signal.
            while cmd.proc.returncode is None:
                r = None
                if timeout is not None:
                    r = cmd.started_at + timeout - time.monotonic()
                    if r <= 0:
                        raise asyncio.TimeoutError
                await asyncio.sleep(0.02 if r is None else min(0.02, r))
            cmd.exit_code = cmd.proc.returncode
            # Grace period for the pump to drain what's left in the pipe;
            # for a normal command exit already closed it (instant EOF).
            await self._drain_pump()
            if cmd.status == "running":
                cmd.status = "completed"
        except asyncio.TimeoutError:
            cmd.status = "timeout"
            await self._kill()
            await self._drain_pump()
            cmd.exit_code = cmd.proc.returncode
        except asyncio.CancelledError:
            # Core teardown: kill the OS process before dying (reference
            # router.ex:182-217 terminate kills the port first).
            await self._kill()
            self._pump.cancel()
            raise
        finally:
            self.core.shell_routers.pop(cmd.command_id, None)
            self._close_transport()
        # Completion notification as an info message into the agent loop
        # (reference router.ex:401-407 mark_completed → notify Core). Like
        # every sync result, it is scrubbed before models can see it — the
        # resolved command string and its output may carry secret values.
        self.core.post(scrub_output({
            "type": "shell_completed", "command_id": cmd.command_id,
            "exit_code": cmd.exit_code, "status": cmd.status,
            "output": truncate_output(cmd.output_text()),
            "command": cmd.command,
        }, self.core.deps.secrets.values()))

    async def _drain_pump(self) -> None:
        """After a kill, collect what the pump can still read; give up fast
        if a descendant keeps the pipe open."""
        if self._pump.done():
            return
        try:
            await asyncio.wait_for(asyncio.shield(self._pump), 1.0)
        except (asyncio.TimeoutError, Exception):
            self._pump.cancel()

    async def _kill(self) -> None:
        """Kill the command's whole process group (the shell here does not
        exec its command, so the real work is a grandchild; killing only the
        shell leaves it running and holding the stdout pipe open). Then poll
        returncode rather than awaiting proc.wait(): asyncio gates the exit
        waiter on pipe EOF, which an orphaned descendant can hold open."""
        proc = self.cmd.proc
        if proc.returncode is not None:
            return
        kill_process_group(proc)
        for _ in range(500):                      # ≤5s for SIGCHLD to land
            if proc.returncode is not None:
                return
            await asyncio.sleep(0.01)

    def _close_transport(self) -> None:
        close_subprocess_transport(self.cmd.proc)

    async def terminate_command(self) -> dict:
        """check_id + terminate=true path: kill the running process. The
        watcher is cancelled so no duplicate completion notification posts —
        the caller gets the final state right here."""
        cmd = self.cmd
        cmd.status = "terminated"
        if self._watcher is not None and not self._watcher.done():
            self._watcher.cancel()
            try:
                await self._watcher
            except (asyncio.CancelledError, Exception):
                pass
        await self._kill()
        self.core.shell_routers.pop(cmd.command_id, None)
        self._close_transport()
        return {"status": "ok", "command_id": cmd.command_id,
                "command_status": "terminated",
                "output": truncate_output(cmd.output_text())}

    def poll_command(self) -> dict:
        """check_id polling path: status + output so far."""
        cmd = self.cmd
        return {"status": "ok", "command_id": cmd.command_id,
                "command_status": cmd.status, "exit_code": cmd.exit_code,
                "output": truncate_output(cmd.output_text())}

    async def shutdown(self) -> None:
        if self._watcher is not None and not self._watcher.done():
            self._watcher.cancel()
            try:
                await self._watcher
            except (asyncio.CancelledError, Exception):
                pass
        await self._kill()
        if not self._pump.done():
            self._pump.cancel()
        self._close_transport()
