"""KV handoff between engines of the PyTorch port (port of
``quoracle_tpu/serving/handoff.py``).

A disaggregated deployment prefills a prompt on one engine and decodes it
on another. The bytes that cross are the session's KV pages, moved by the
tier's hibernate and restore split across two engines:

  1. export: ``TierManager.export_session`` hibernates the session out of
     the source engine's pool (the eviction ladder's demote: one
     device-to-host copy, a refcounted release; the radix tree and any
     adopters keep their resident copies) and hands the host copy here;
  2. envelope: the copy travels as a :class:`HandoffEnvelope` stamped
     with the source engine's KV signature (geometry, page size, pool
     dtype, ``GenerateEngine.kv_signature``) and the grammar state after
     the last prefilled token;
  3. adopt: ``TierManager.adopt_session`` places the copy in the
     destination engine's host tier, and the ordinary restore (prefetch,
     or the engine's session lookup) pages it in.

Signatures must match exactly, or the handoff is rejected
(:class:`HandoffError`, ``reason == "signature"``) before any bytes reach
the destination: a mismatched pair re-prefills, never reads foreign KV.

The ledger keeps every in-flight envelope until its row retires, so a
decode engine lost mid-row can be replaced by adopting the same envelope
elsewhere. The ledger lock is bookkeeping only; device work happens under
the engines' own paged and store locks, taken after it or not at all.

Observability as in the JAX broker: the ``CLUSTER_HANDOFF*``
instruments, the ``kv_handoff_export``/``_adopt``/``_reject`` flight
records, the retroactive ``kv.export`` and ``kv.adopt`` spans (only while
a tracer sink listens) and the int8 byte-savings counter. The envelope
carries the exporting thread's trace and tree contexts (``trace``,
``tree``), so the adopting side's spans and waits land in the same trace
and tree node. ``export`` is the chaos plane's ``handoff.export`` seam
(chaos/faults.py); serving/cluster.py drives handoffs across replicas.
Left out of this copy: the wire envelope of the cross-host fabric
(ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

from quoracle_tpu_torch.chaos.faults import CHAOS
from quoracle_tpu_torch.infra import fleetobs, treeobs
from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.telemetry import (
    CLUSTER_HANDOFF_MS, CLUSTER_HANDOFFS_TOTAL, QUANT_BYTES_SAVED_TOTAL,
    TRACER,
)


class HandoffError(RuntimeError):
    """A KV handoff could not be performed: a signature mismatch, an
    engine without a tier, or a failed export. The caller re-prefills on
    the destination."""

    def __init__(self, message: str, reason: str = "rejected"):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass
class HandoffEnvelope:
    """One session's KV in transit between engines. ``entry`` is the
    tier's host copy (``_HostSession``: tokens, start_pos, CPU K/V and,
    for int8 pools, their scales); ``signature`` binds it to the engine
    geometry that produced it; ``json_state`` is the grammar state after
    the last prefilled token (None: unconstrained)."""

    session_id: str
    model_spec: str
    signature: str
    entry: Any
    json_state: Optional[int] = None
    src_replica: str = ""
    ts: float = 0.0
    # {"trace_id", "span_id"} of the exporting thread's span, so the
    # adopting side's restore and decode spans land in the same trace
    trace: Optional[dict] = None
    # the owning agent's tree context (treeobs.TreeContext.to_dict), so
    # the continuation books its waits to the same tree node
    tree: Optional[dict] = None

    @property
    def n_tokens(self) -> int:
        return len(self.entry.tokens)


class KVHandoff:
    """The handoff broker: export and adopt between engines, and the
    ledger of in-flight envelopes."""

    def __init__(self):
        self._lock = named_lock("handoff")
        self._inflight: dict[str, HandoffEnvelope] = {}
        self.exports = 0
        self.adopts = 0
        self.rejects = 0
        self.replaced = 0

    def export(self, engine, session_id: str, model_spec: str,
               src_replica: str = "",
               json_state: Optional[int] = None) -> HandoffEnvelope:
        """Hibernate ``session_id`` out of ``engine`` into an envelope.
        Raises :class:`HandoffError` when the engine has no tier or holds
        no such session."""
        # Chaos seam: a "fail" directive aborts the export before any
        # pages move; the caller degrades to a cold re-prefill on the
        # decode side and still serves the request.
        d = CHAOS.fire("handoff.export", model=model_spec)
        if d is not None and d.kind == "fail":
            CLUSTER_HANDOFFS_TOTAL.inc(model=model_spec,
                                       status="export_failed")
            raise HandoffError(
                f"chaos-injected export failure for session "
                f"{session_id!r}", reason="export_failed")
        tier = engine.sessions.tier
        if tier is None:
            raise HandoffError(
                f"engine {engine.cfg.name} has no KV tier attached",
                reason="no_tier")
        t0 = time.monotonic()
        with engine._paged_lock:
            entry = tier.export_session(session_id)
        if entry is None:
            CLUSTER_HANDOFFS_TOTAL.inc(model=model_spec,
                                       status="export_failed")
            raise HandoffError(
                f"session {session_id!r} not exportable from "
                f"{engine.cfg.name}", reason="export_failed")
        ctx = fleetobs.TraceContext.current()
        tctx = treeobs.current() if treeobs.enabled() else None
        env = HandoffEnvelope(
            session_id=session_id, model_spec=model_spec,
            signature=engine.kv_signature(), entry=entry,
            json_state=json_state, src_replica=src_replica,
            ts=time.monotonic(),
            trace=ctx.to_dict() if ctx is not None else None,
            tree=tctx.to_dict() if tctx is not None else None)
        if getattr(entry, "k_scale", None) is not None:
            # an int8 envelope ships about half its bf16 twin's bytes
            payload = int(entry.k.nbytes) + int(entry.v.nbytes)
            QUANT_BYTES_SAVED_TOTAL.inc(
                max(0, 2 * payload - entry.nbytes),
                model=model_spec, tier="handoff")
        with self._lock:
            self._inflight[self._key(model_spec, session_id)] = env
            self.exports += 1
        export_ms = (time.monotonic() - t0) * 1000
        FLIGHT.record("kv_handoff_export", model=model_spec,
                      session=session_id, replica=src_replica,
                      tokens=env.n_tokens, ms=round(export_ms, 2))
        if TRACER.active():
            TRACER.emit("kv.export", export_ms,
                        ts=time.time() - export_ms / 1000.0,
                        session=session_id, model=model_spec,
                        replica=src_replica, tokens=env.n_tokens)
        return env

    def adopt(self, engine, env: HandoffEnvelope,
              dst_replica: str = "") -> None:
        """Place the envelope in ``engine``'s host tier and page it in (a
        best-effort prefetch: a busy or full engine restores at the
        session lookup instead). Raises :class:`HandoffError` on a KV
        signature mismatch BEFORE any bytes reach the destination tier."""
        sig = engine.kv_signature()
        if sig != env.signature:
            with self._lock:
                self.rejects += 1
            CLUSTER_HANDOFFS_TOTAL.inc(model=env.model_spec,
                                       status="signature_mismatch")
            FLIGHT.record("kv_handoff_reject", model=env.model_spec,
                          session=env.session_id,
                          src_signature=env.signature, dst_signature=sig,
                          replica=dst_replica)
            raise HandoffError(
                f"KV signature mismatch: the source produced "
                f"{env.signature!r}, the destination expects {sig!r}",
                reason="signature")
        tier = engine.sessions.tier
        if tier is None:
            raise HandoffError(
                f"destination engine {engine.cfg.name} has no KV tier",
                reason="no_tier")
        t0 = time.monotonic()
        tier.adopt_session(env.session_id, env.entry)
        engine.prefetch_session(env.session_id)
        ms = (time.monotonic() - t0) * 1000
        with self._lock:
            self.adopts += 1
        CLUSTER_HANDOFFS_TOTAL.inc(model=env.model_spec, status="ok")
        CLUSTER_HANDOFF_MS.observe(
            ms + max(0.0, (t0 - env.ts) * 1000), model=env.model_spec)
        FLIGHT.record("kv_handoff_adopt", model=env.model_spec,
                      session=env.session_id, replica=dst_replica,
                      tokens=env.n_tokens, ms=round(ms, 2))
        if TRACER.active():
            # parent onto the exporting side's context when this thread
            # carries none (the envelope's trace travelled with the pages)
            TRACER.emit("kv.adopt", ms,
                        parent=(TRACER.current()
                                or fleetobs.TraceContext.from_dict(
                                    env.trace)),
                        ts=time.time() - ms / 1000.0,
                        session=env.session_id, model=env.model_spec,
                        replica=dst_replica, tokens=env.n_tokens)

    # -- ledger ------------------------------------------------------------

    @staticmethod
    def _key(model_spec: str, session_id: str) -> str:
        return f"{model_spec}\x00{session_id}"

    def inflight(self, model_spec: str,
                 session_id: str) -> Optional[HandoffEnvelope]:
        """The retained envelope of a still-running row: the source for a
        replacement when its decode engine is lost mid-row."""
        with self._lock:
            return self._inflight.get(self._key(model_spec, session_id))

    def note_replaced(self, model_spec: str) -> None:
        with self._lock:
            self.replaced += 1
        CLUSTER_HANDOFFS_TOTAL.inc(model=model_spec, status="replaced")

    def forget(self, model_spec: str, session_id: str) -> None:
        """The row retired (or failed for good): drop its envelope."""
        with self._lock:
            self._inflight.pop(self._key(model_spec, session_id), None)

    def stats(self) -> dict:
        with self._lock:
            return {
                "exports": self.exports,
                "adopts": self.adopts,
                "rejects": self.rejects,
                "replaced": self.replaced,
                "inflight": len(self._inflight),
            }
