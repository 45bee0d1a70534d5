"""Decode-level continuous batching across agents (port of
``quoracle_tpu/models/scheduler.py``).

The baton batcher (models/runtime.py) coalesces concurrent agents' rounds
at ROUND granularity: rows that arrive while a member is mid-generate wait
for the whole call. Here rows join and leave a shared decode loop at CHUNK
granularity instead — the classic continuous-batching scheme:

  * each engine gets ONE worker thread running a chunked loop: every
    iteration batches all live rows into a single ``engine.generate``
    call bounded at ``chunk`` tokens;
  * a row's cross-chunk state is exactly its KV SESSION plus the grammar
    state: the continuation prompt (prior prompt + tokens emitted so far)
    token-extends the session, so each chunk re-prefills ONE token (the
    last sampled, never-forwarded one) and decodes ``chunk`` more;
    ``GenResult.json_state`` → ``initial_json_state`` resumes constrained
    rows mid-JSON (states travel relative to their grammar block);
  * between chunks, finished rows retire (futures resolve) and queued
    rows are admitted into free slots — a new agent's row starts decoding
    after the CURRENT CHUNK, not after every other agent's full round;
  * a row's FIRST chunk goes through the engine's radix prefix cache
    (models/prefix_cache.py): same-chunk admissions sharing an uncached
    prefix are wave-split so the batch prefills it once. A
    scheduler-owned session is dropped when its row retires, but the
    prefix pages it prefilled stay adoptable in the cache until eviction
    reclaims them.

On the card every chunk is a sessioned call, so it runs the unified
ragged tier by default: the chunk's one-token re-prefills and then its
decode ticks go through the ragged kernel.

With a ``speculator`` (models/speculative.py ``BatchedSpeculator``) a
tick splits: eligible rows ride batched draft/verify rounds until each has
committed about a chunk, while ineligible rows (nucleus-sampled rows, rows
at the window's edge, every row while the member is disengaged) decode
vanilla in the same tick. A speculator failure decodes the rows it left
vanilla for the tick and counts as an "error" fallback. Temperature-0
tokens are the same with and without speculation (fp32; bf16 sums may
differ between a verify chunk and a decode tick). Sampled rows draw fresh RNG
per chunk — the stream differs from a one-shot call (same distribution);
temperature-0 rows give the one-shot tokens (fp32; bf16 sums may differ
between a chunk tick and a decode tick of the same token).

Admission ORDER is a policy: the batcher queues through a
``serving/qos.AdmissionPolicy`` — FIFO by default, weighted-fair DRR with
an aging floor under QoS — and an optional
``serving/admission.AdmissionController`` sheds at submit (structured
reject with ``retry_after_ms``) while deadline-expired rows are failed at
admit instead of decoded. QoS reorders *scheduling* only: what a row
computes once admitted is untouched.

The worker thread did not make the engine: the current CUDA device is per
thread in PyTorch, so the loop pins the device of the engine's weights
before its first chunk; every forward it reaches runs under the engine's
own ``torch.no_grad`` decorators. A row resuming a hibernated session
warms it at submit (``engine.prefetch_session``, tiered KV), overlapping
the page-in with its queue wait. Left out of this copy, each marked where
it stood: the tracer spans, wait clocks, tree, fleet and cost attribution
and the flight-recorder records (Queue 1 item 8), and the fault-injection
tick (item 9).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import torch

from quoracle_tpu_torch.infra.telemetry import (
    QOS_ADMIT_WAIT_MS, QOS_SHED_TOTAL, SCHED_ADMIT_WAIT_MS,
    SCHED_QUEUE_DEPTH, SCHED_ROWS_TOTAL, SCHED_SLOTS_BUSY,
)
from quoracle_tpu_torch.models.generate import (
    ContextOverflowError, GenResult,
)
from quoracle_tpu_torch.serving.admission import (
    AdmissionError, DeadlineExceededError,
)
from quoracle_tpu_torch.serving.qos import (
    AdmissionPolicy, FifoPolicy, class_name, coerce_priority,
)


@dataclasses.dataclass
class _Row:
    """One agent row riding the shared decode loop."""

    prompt: list
    temperature: float
    top_p: float
    max_new: int
    session_id: str
    constrain: bool
    action_enum: Optional[Sequence[str]]
    future: Future
    emitted: list = dataclasses.field(default_factory=list)
    json_state: Optional[int] = None
    n_cached_first: Optional[int] = None
    owns_session: bool = False          # scheduler-created → drop at end
    t_submit: float = 0.0
    # QoS: class + tenant attribution and the absolute (monotonic)
    # deadline after which the row is failed, not decoded.
    priority: int = 1                   # Priority.AGENT
    tenant: str = "default"
    deadline_s: Optional[float] = None
    # speculative serving: draft/verify rounds this row rode and draft
    # tokens proposed and accepted, surfaced on the retiring GenResult
    spec_rounds: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0


class ContinuousBatcher:
    """Per-engine chunked decode loop with admission between chunks.

    ``submit()`` returns a Future[GenResult]; rows from any number of
    callers (agents) batch into the same device steps. Sessionless
    submissions get a scheduler-owned session (dropped on completion) —
    the session IS the row's cross-chunk KV state.
    """

    def __init__(self, engine, chunk: int = 32, max_slots: int = 8,
                 policy: Optional[AdmissionPolicy] = None,
                 admission=None, slo=None, speculator=None):
        """``policy`` orders admission (default: FIFO;
        serving/qos.WeightedFairPolicy for DRR + aging). ``admission``
        is an optional serving/admission.AdmissionController consulted
        on every submit — sheds fail the row's future with a structured
        AdmissionError instead of growing the queue. ``slo`` is an
        optional serving/slo.SLOTracker fed per-class retire latency.
        ``speculator`` (models/speculative.BatchedSpeculator) turns
        eligible rows' decode ticks into batched draft/verify rounds;
        ineligible rows decode vanilla in the same tick."""
        self.engine = engine
        self.chunk = chunk
        self.max_slots = max_slots
        self._policy = policy if policy is not None else FifoPolicy()
        self.admission = admission
        self.slo = slo
        self.speculator = speculator
        self._live: list[_Row] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        # health telemetry: monotonic progress/outcome counters. ``steps``
        # is the stall watchdog's progress signal — frozen steps with live
        # rows means the decode loop is wedged.
        self.steps = 0
        self.retired = 0
        self.failed = 0
        self._model = engine.cfg.name
        self._thread = threading.Thread(
            target=self._loop, name=f"batcher-{engine.cfg.name}",
            daemon=True)
        self._thread.start()

    def submit(self, prompt: Sequence[int], *, temperature: float = 1.0,
               top_p: float = 1.0, max_new_tokens: int = 256,
               session_id: Optional[str] = None,
               constrain_json: bool = False,
               action_enum: Optional[Sequence[str]] = None,
               priority=None, tenant: str = "default",
               deadline_s: Optional[float] = None,
               initial_json_state: Optional[int] = None) -> Future:
        """``initial_json_state`` resumes a constrained row MID-GRAMMAR:
        the prompt's tail already contains generated JSON and decoding
        must continue from that grammar state, not from the block start —
        exactly the state the chunked loop threads between its own chunks
        via GenResult.json_state. (The JAX batcher also takes task, decide
        and tree attribution keys here, for planes of Queue 1 item 8.)"""
        row = _Row(prompt=list(prompt), temperature=temperature,
                   top_p=top_p, max_new=max(1, max_new_tokens),
                   session_id=session_id or self._own_session_id(),
                   constrain=constrain_json, action_enum=action_enum,
                   future=Future(), t_submit=time.monotonic(),
                   priority=int(coerce_priority(priority)),
                   tenant=tenant, deadline_s=deadline_s,
                   json_state=initial_json_state)
        row.owns_session = session_id is None
        # Per-row admission check: an over-window prompt must fail ONLY
        # its own future — inside a shared chunk the engine's
        # ContextOverflowError would poison every live row's in-flight
        # work (the engine applies the same bound at generate()).
        if len(row.prompt) >= self.engine.max_seq:
            row.future.set_exception(ContextOverflowError(
                f"prompt of {len(row.prompt)} tokens >= max_seq "
                f"{self.engine.max_seq} for model {self.engine.cfg.name}"))
            return row.future
        # QoS admission: shed BEFORE the row can queue — a structured
        # reject on the row's OWN future, never silent queue growth. The
        # controller may clamp the class to the tenant's floor.
        if self.admission is not None:
            try:
                row.priority = int(self.admission.admit(
                    tenant=row.tenant, priority=row.priority,
                    deadline_s=row.deadline_s,
                    queue_depth=self._policy.qsize()))
            except AdmissionError as e:
                row.future.set_exception(e)
                self.failed += 1
                SCHED_ROWS_TOTAL.inc(model=self._model, status="failed")
                # (the JAX batcher books the shed against the tenant's
                # error budget here: Queue 1 item 8)
                return row.future
        # Reject-after-closed UNDER THE LOCK: close() flips _stop under
        # this same lock, so a row can only enter the queue strictly
        # BEFORE the flip — and close()'s drain (which runs after) is then
        # guaranteed to see it.
        with self._lock:
            if self._stop:
                raise RuntimeError("ContinuousBatcher is closed")
            self._policy.put(row)
            depth = self._policy.qsize()
        SCHED_QUEUE_DEPTH.set(depth, model=self._model)
        self._wake.set()
        # Tiered-KV prefetch: a row resuming a HIBERNATED session warms it
        # now, overlapping the page-in with its queue wait. Best-effort and
        # non-blocking (it try-acquires the engine lock): a busy engine
        # skips it and the sessioned generate restores at its lookup.
        if session_id is not None:
            prefetch = getattr(self.engine, "prefetch_session", None)
            if prefetch is not None:
                try:
                    prefetch(session_id)
                except Exception:   # noqa: BLE001 — warm-up only
                    pass
        return row.future

    def close(self) -> None:
        with self._lock:
            self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            # mid-chunk device call still running; give it one longer
            # grace period — touching _live while the worker owns it
            # would race its set_result calls (InvalidStateError)
            self._thread.join(timeout=50)
        # never strand a waiter: still-queued rows fail loudly instead of
        # leaving callers blocked on futures forever. LIVE rows are failed
        # by the worker's own exit cleanup (it owns _live); only a worker
        # confirmed dead can't do that, so take over just in that case.
        err = RuntimeError("ContinuousBatcher closed")
        leftovers = []
        if not self._thread.is_alive():
            leftovers = list(self._live)
            self._live = []
        leftovers.extend(self._policy.drain())
        for row in leftovers:
            if not row.future.done():
                row.future.set_exception(err)
                self.failed += 1
                SCHED_ROWS_TOTAL.inc(model=self._model, status="failed")
            self._drop_row_sessions(row)
        # Zero the live gauges: the queue is drained and no slot can ever
        # be busy again — the last-set values would show phantom
        # depth/occupancy after shutdown.
        SCHED_QUEUE_DEPTH.set(0, model=self._model)
        SCHED_SLOTS_BUSY.set(0, model=self._model)

    def _own_session_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"__cb{self._seq}"

    # -- health telemetry ----------------------------------------------

    def stats(self) -> dict:
        """Point-in-time health snapshot (racy reads of worker-owned
        state — a snapshot, not an invariant). ``padding`` stays None
        until the engine counts real against padded chunk tokens (the JAX
        engine's ``padding_stats``, Queue 1 item 8); ``speculative`` is
        the speculator's ``stats()``, None without one."""
        return {
            "queued": self._policy.qsize(),
            "live": len(self._live),
            "max_slots": self.max_slots,
            "chunk": self.chunk,
            "steps": self.steps,
            "retired": self.retired,
            "failed": self.failed,
            "closed": self._stop,
            "qos": self._policy.snapshot(),
            "padding": None,
            "speculative": (self.speculator.stats()
                            if self.speculator is not None else None),
        }

    def progress(self) -> tuple[bool, int]:
        """Stall-watchdog source: (work pending?, monotonic progress
        counter). Active with a frozen counter past the deadline = the
        decode loop is wedged."""
        active = (not self._stop
                  and (bool(self._live) or self._policy.qsize() > 0))
        return active, self.steps

    # ------------------------------------------------------------------

    def _admit(self) -> None:
        while len(self._live) < self.max_slots:
            row = self._policy.pop()
            if row is None:
                break
            now = time.monotonic()
            # Deadline-aware drop: a row whose deadline passed while
            # queued is failed AT ADMIT — decoding tokens nobody will wait
            # for would steal the slot from a live request.
            if row.deadline_s is not None and now >= row.deadline_s:
                if not row.future.done():
                    row.future.set_exception(DeadlineExceededError(
                        f"deadline passed after "
                        f"{(now - row.t_submit) * 1000:.0f}ms in queue",
                        tenant=row.tenant, priority=row.priority))
                self._drop_row_sessions(row)
                self.failed += 1
                SCHED_ROWS_TOTAL.inc(model=self._model, status="failed")
                QOS_SHED_TOTAL.inc(cls=class_name(row.priority),
                                   tenant=row.tenant, reason="deadline")
                # (the JAX batcher records the drop in its flight recorder
                # and the tenant's error budget here: Queue 1 item 8)
                continue
            wait_ms = (now - row.t_submit) * 1000
            SCHED_ADMIT_WAIT_MS.observe(wait_ms, model=self._model)
            QOS_ADMIT_WAIT_MS.observe(wait_ms,
                                      cls=class_name(row.priority))
            # (the JAX batcher stamps the admit time and emits the row's
            # queue-wait span here: Queue 1 item 8)
            self._live.append(row)
        SCHED_QUEUE_DEPTH.set(self._policy.qsize(), model=self._model)
        SCHED_SLOTS_BUSY.set(len(self._live), model=self._model)

    def _pin_device(self) -> None:
        """Launch where the engine's weights live: the current CUDA device
        is per thread, and this thread did not make the engine."""
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.params.final_norm.device)

    def _loop(self) -> None:
        self._pin_device()
        while not self._stop:
            self._admit()
            if not self._live:
                self._wake.wait(timeout=0.2)
                self._wake.clear()
                continue
            # (the JAX batcher samples a decode-tick span here: Queue 1
            # item 8)
            try:
                self._live = self._step(self._live)
            except Exception:             # noqa: BLE001 — isolate, don't
                self._live = self._isolate_failure(self._live)  # nuke all
            self.steps += 1               # watchdog progress signal
            # (the JAX batcher beats its liveness heartbeat here, item 8,
            # and fires its fault-injection tick, item 9)
        # worker exit (close()): the worker owns _live, so it fails any
        # remaining rows itself — close() only takes over when this
        # thread is confirmed dead
        err = RuntimeError("ContinuousBatcher closed")
        for row in self._live:
            if not row.future.done():
                row.future.set_exception(err)
                self.failed += 1
                SCHED_ROWS_TOTAL.inc(model=self._model, status="failed")
            self._drop_row_sessions(row)
        self._live = []
        # gauge reset on the worker-exit path too: whichever of
        # close()/worker runs last, the scrape reads zero
        SCHED_SLOTS_BUSY.set(0, model=self._model)

    def _isolate_failure(self, rows: list) -> list:
        """A shared chunk raised. One poisoned row must not discard every
        other agent's partial work: rerun each row as its own single-row
        chunk — rows that fail alone get THEIR error, the rest survive
        with their emitted state intact. Engine-wide failures (device
        dead) fail every row with its own raise."""
        survivors: list = []
        for row in rows:
            if row.future.done():
                # _plain_step resolved this row (and dropped its session)
                # before the exception hit a later row — nothing to rerun
                continue
            try:
                survivors.extend(self._plain_step([row]))
            except Exception as e:        # noqa: BLE001 — per-row capture
                if not row.future.done():
                    row.future.set_exception(e)
                self._drop_row_sessions(row)
                self.failed += 1
                SCHED_ROWS_TOTAL.inc(model=self._model, status="failed")
        return survivors

    def _drop_row_sessions(self, row) -> None:
        """Owned-session cleanup for a terminal row: the engine session
        and, under speculative serving, the draft engine's shadow session
        the speculator keyed by the same id."""
        if row.owns_session:
            self.engine.drop_session(row.session_id)
            if self.speculator is not None:
                self.speculator.drop_session(row.session_id)

    def _finish_row(self, row, finish_reason: str,
                    json_state: int = -1) -> None:
        """Resolve a finished row's future from its accumulated state and
        account the retirement."""
        if not row.future.done():           # close() may have failed it
            row.future.set_result(GenResult(
                token_ids=list(row.emitted),
                text=self.engine.tokenizer.decode(row.emitted),
                n_prompt_tokens=len(row.prompt),
                n_gen_tokens=len(row.emitted),
                latency_s=time.monotonic() - row.t_submit,
                finish_reason=finish_reason,
                n_cached_tokens=row.n_cached_first or 0,
                json_state=json_state,
                spec_rounds=row.spec_rounds,
                spec_drafted_tokens=row.spec_drafted,
                spec_accepted_tokens=row.spec_accepted,
            ))
        self._drop_row_sessions(row)
        self.retired += 1
        SCHED_ROWS_TOTAL.inc(model=self._model, status="retired")
        # (the JAX batcher books the retire against the tenant's error
        # budget, closes the row's wait ledger, emits its decode span and
        # records the retire in its flight recorder here: Queue 1 item 8)
        if self.slo is not None:
            # per-class tail tracking (serving/slo.py): feeds the
            # INTERACTIVE-burn → BATCH-demotion control loop
            self.slo.observe(
                row.priority,
                (time.monotonic() - row.t_submit) * 1000)

    def _step(self, rows: list) -> list:
        """One decode tick. Under speculative serving the tick splits:
        eligible rows ride batched draft/verify rounds (``_spec_step``)
        while ineligible rows decode vanilla in the same tick. Both kinds
        retire through _finish_row."""
        spec = self.speculator
        spec_rows: list = []
        spec_ids: set = set()
        finishes: dict = {}
        if spec is not None:
            spec.tick_vanilla()         # re-probe countdown while off
            for r in rows:
                reason = spec.ineligible_reason(
                    len(r.prompt) + len(r.emitted), r.temperature,
                    r.top_p)
                if reason is None:
                    spec_rows.append(r)
                    spec_ids.add(id(r))
                else:
                    spec.note_fallback(reason)
            if spec_rows:
                # (the JAX batcher books the round's wall into the rows'
                # wait clocks here: Queue 1 item 8)
                finishes, leftover = self._spec_step(spec_rows)
                if leftover:            # speculator failed mid-tick:
                    lids = set(map(id, leftover))   # decode those vanilla
                    spec_rows = [r for r in spec_rows
                                 if id(r) not in lids]
                    spec_ids -= lids
        plain = [r for r in rows if id(r) not in spec_ids]
        still = self._plain_step(plain) if plain else []
        for row in spec_rows:
            fin = finishes.get(id(row))
            finished = (fin == "stop"
                        or len(row.emitted) >= row.max_new
                        or (len(row.prompt) + len(row.emitted)
                            >= self.engine.max_seq - 1))
            if finished:
                self._finish_row(
                    row, "stop" if fin == "stop" else "length",
                    json_state=(row.json_state
                                if row.json_state is not None else -1))
            else:
                still.append(row)
        return still

    def _spec_step(self, rows: list) -> tuple[dict, list]:
        """Speculative sub-tick: repeated draft/verify rounds until every
        row has committed ~chunk tokens, finished, or become ineligible.
        Returns ({id(row): "stop" | None}, leftover): ``leftover`` rows hit
        a speculator error and decode vanilla this tick; what they
        committed before it (rows and sessions change in place) is
        consistent, so the fallback is seamless."""
        spec = self.speculator
        finishes: dict = {}
        active = list(rows)
        baseline = {id(r): len(r.emitted) for r in rows}
        try:
            while active:
                for rid, fin in spec.run_round(active).items():
                    if fin is not None:
                        finishes[rid] = fin
                active = [
                    r for r in active
                    if finishes.get(id(r)) is None
                    and len(r.emitted) < r.max_new
                    and len(r.emitted) - baseline[id(r)] < self.chunk
                    and spec.ineligible_reason(
                        len(r.prompt) + len(r.emitted), r.temperature,
                        r.top_p) is None]
        except Exception:    # noqa: BLE001 — isolate, don't kill rows
            spec.note_fallback("error", len(active))
            # (the JAX batcher records the error in its flight recorder
            # here: Queue 1 item 8)
            leftover = [r for r in active if finishes.get(id(r)) is None]
            return finishes, leftover
        return finishes, []

    def _plain_step(self, rows: list) -> list:
        prompts = [r.prompt + r.emitted for r in rows]
        budgets = [min(self.chunk, r.max_new - len(r.emitted))
                   for r in rows]
        results = self.engine.generate(
            prompts,
            temperature=[r.temperature for r in rows],
            top_p=[r.top_p for r in rows],
            max_new_tokens=budgets,
            session_ids=[r.session_id for r in rows],
            constrain_json=[r.constrain for r in rows],
            action_enums=[r.action_enum for r in rows],
            initial_json_state=[r.json_state for r in rows],
        )
        still = []
        for row, res, budget in zip(rows, results, budgets):
            if row.n_cached_first is None:
                row.n_cached_first = res.n_cached_tokens
            row.emitted.extend(res.token_ids)
            row.json_state = (res.json_state
                              if res.json_state >= 0 else row.json_state)
            finished = (res.finish_reason == "stop"
                        or len(res.token_ids) < budget
                        or len(row.emitted) >= row.max_new
                        # context exhausted: the next continuation prompt
                        # (prompt+emitted) would reach the window and the
                        # whole shared batch would ContextOverflow — retire
                        # at the window edge instead (the engine clamps
                        # row_limit the same way, so when remaining space
                        # is an exact chunk multiple only this check fires)
                        or (len(row.prompt) + len(row.emitted)
                            >= self.engine.max_seq - 1))
            if finished:
                self._finish_row(row, res.finish_reason, res.json_state)
            else:
                still.append(row)
        return still
