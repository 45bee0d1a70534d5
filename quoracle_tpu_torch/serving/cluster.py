"""Disaggregated multi-replica serving plane of the PyTorch port (port of
``quoracle_tpu/serving/cluster.py``).

A :class:`ClusterPlane` is a ``ModelBackend`` over N REPLICAS, each a
full per-member engine set (a ``TorchBackend``), role-tagged into tiers:

  * **prefill** replicas: chunked ragged prefill only (engines carry
    ``role='prefill'``, which caps a generate at one emitted token, the
    first-token semantics of disaggregated serving); no continuous
    batcher, no draft models.
  * **decode** replicas: continuous batching plus speculation, the
    single-backend decode path.
  * **unified** replicas: the non-disaggregated data-parallel mode
    (``replicas=N`` without ``disaggregate``): whole requests, routed by
    affinity and load.

A disaggregated request ("hibernate on the prefill replica, restore on
the decode replica", the tier's machinery split across engines by
serving/handoff.py):

  1. the ROUTER (serving/router.py) places the row: session affinity
     first, then the least-loaded eligible replica by the admission
     controller's own sampled signals;
  2. the prefill replica's engine prefills the prompt and emits ONE
     token (``max_new_tokens=1``), storing the prompt KV in its pages;
  3. the handoff broker hibernates that session into an envelope
     (signature-checked) and the decode replica adopts it by page-in;
  4. the decode replica decodes the continuation (prompt + first token)
     through its continuous batcher, resuming the restored session, and
     the plane assembles one result from both phases. At temperature 0
     the tokens are those of one backend serving the whole request.

Degraded modes: a decode replica dying mid-row is re-placed through its
retained handoff envelope onto a surviving decode replica (or failed
with a structured error naming the replica); a KV-signature mismatch at
handoff degrades to a cold re-prefill on the decode side; when every
decode replica sheds, the front door sheds with the MAX retry-after.

Every replica lives in this process. ``build`` puts them all on one
``device`` (the GPU unless the caller asks for the CPU): the one-card
case of the JAX package's ``replica_device_groups``, where replicas share
devices when there are fewer devices than replicas. ``engine_factory``
hands each replica prebuilt engines (one a member, over shared
read-only weights) instead of drawing weights per replica. Network
replicas (the JAX ``RemoteReplica`` and its backend facade) come with
the cross-host fabric, ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np

from quoracle_tpu_torch.chaos.faults import CHAOS
from quoracle_tpu_torch.infra import fleetobs
from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.telemetry import (
    CLUSTER_REPLICAS, CLUSTER_REQUESTS_TOTAL, TRACER,
)
from quoracle_tpu_torch.models.runtime import (
    ModelBackend, QueryRequest, QueryResult, TorchBackend, Usage,
)
from quoracle_tpu_torch.models.generate import resolve_device
from quoracle_tpu_torch.serving.admission import AdmissionError
from quoracle_tpu_torch.serving.handoff import HandoffError, KVHandoff
from quoracle_tpu_torch.serving.router import ClusterRouter

logger = logging.getLogger(__name__)


class ReplicaFailedError(RuntimeError):
    """A row's serving replica died and no surviving replica could take
    it over. Structured: the web/consensus layers surface replica id +
    phase instead of a bare traceback — a lost replica must read as an
    incident, never as a silently dropped row."""

    def __init__(self, message: str, replica_id: str = "",
                 phase: str = "decode"):
        super().__init__(message)
        self.replica_id = replica_id
        self.phase = phase


@dataclasses.dataclass
class Replica:
    """One role-tagged engine tier member."""

    replica_id: str
    role: str                    # "prefill" | "decode" | "unified"
    backend: TorchBackend
    alive: bool = True

    def close(self) -> None:
        self.backend.close()


def _replica_backend(a: dict, role: str, embedder, *,
                     tag_role: bool) -> TorchBackend:
    """One replica's ``TorchBackend`` from ``ClusterPlane.build``'s args.
    A prefill replica runs no decode loop and no drafts: one ragged
    prefill call per placement is its whole job. Quantization is uniform
    across the cluster: a mixed-precision pair would reject every handoff
    at the signature gate (``kv_signature``)."""
    prefill = role == "prefill"
    draft_map = None if prefill else a["draft_map"]
    engines = None
    if a["engine_factory"] is not None:
        specs = list(a["pool"]) + sorted(set((draft_map or {}).values()))
        engines = {}
        for spec in specs:
            if spec not in engines:
                engines[spec] = a["engine_factory"](
                    spec, quantize_weights=a["quantize_weights"],
                    quantize_kv=a["quantize_kv"])
    backend = TorchBackend(
        a["pool"], seed=a["seed"], device=a["device"], engines=engines,
        embed_model=a.get("embed_model"), embedder=embedder,
        continuous=a["continuous"] and not prefill,
        continuous_chunk=a["continuous_chunk"],
        continuous_slots=a["continuous_slots"],
        draft_map=draft_map, draft_k=a["draft_k"], qos=a["qos"],
        host_kv_mb=a["host_kv_mb"], disk_kv_dir=a["disk_kv_dir"],
        disk_kv_gb=a["disk_kv_gb"],
        quantize_weights=a["quantize_weights"],
        quantize_kv=a["quantize_kv"])
    if tag_role:
        for spec in a["pool"]:
            backend.engines[spec].role = role
    return backend


# (The JAX package's RemoteReplica and _RemoteBackendFacade, a replica
# that is a network peer behind the cross-host fabric, would stand here:
# ROADMAP Queue 1 item 14.)


class ClusterPlane(ModelBackend):
    """N replicas + a router + a handoff broker behind the ModelBackend
    seam — the consensus/agent layers cannot tell it from a single
    TorchBackend, which is the point."""

    def __init__(self, replicas: Sequence[Replica],
                 router: Optional[ClusterRouter] = None,
                 handoff: Optional[KVHandoff] = None):
        if not replicas:
            raise ValueError("a cluster needs at least one replica")
        self.replicas: list[Replica] = list(replicas)
        self.router = router or ClusterRouter()
        self.handoff = handoff or KVHandoff()
        for rep in self.replicas:
            self.router.register(rep)
        self.disaggregated = any(r.role == "prefill"
                                 for r in self.replicas)
        if self.disaggregated and not any(r.role == "decode"
                                          for r in self.replicas):
            raise ValueError("disaggregated cluster has prefill "
                             "replicas but no decode replica")
        self.pool = list(self.replicas[0].backend.pool)
        self._bus = None
        self._lock = named_lock("cluster.plane")
        self._seq = 0
        # Elastic fleet: ``build`` saves its backend kwargs
        # here so ``add_replica`` can construct new replicas in either
        # role; a directly-constructed plane can set it explicitly (the
        # fleet tests inject tiny-engine factories).
        self._replica_args: Optional[dict] = None
        self._embedder = None
        # monotonic replica-id counter: ids must never be reused after
        # a retirement — a stale affinity or flight event naming a
        # retired id must stay unambiguous forever
        self._rep_seq = len(self.replicas)
        # fleet observability: any serving plane can answer
        # a timeline pull, so the span ring captures from build time
        fleetobs.ensure_ring()
        self._refresh_replica_gauges()

    # -- construction ----------------------------------------------------

    @classmethod
    def build(cls, pool: Sequence[str], *, replicas: int = 2,
              disaggregate: bool = True, seed: int = 0, device=None,
              engine_factory: Optional[Callable[..., Any]] = None,
              qos=None, draft_map: Optional[dict] = None,
              draft_k: int = 6, continuous: bool = True,
              continuous_chunk: int = 32, continuous_slots: int = 8,
              host_kv_mb: int = 0, disk_kv_dir: Optional[str] = None,
              disk_kv_gb: float = 8.0, embed_model: Optional[str] = None,
              quantize_weights: bool = False,
              quantize_kv: bool = False) -> "ClusterPlane":
        """Build N replicas over one model pool on one ``device`` (None:
        the GPU, which raises without one; ``"cpu"`` only when asked).
        With ``disaggregate``, the first ``max(1, replicas // 2)``
        replicas become the prefill tier and the rest the decode tier
        (decode-heavy: agent workloads are decode-bound); otherwise every
        replica is unified. The embedder is built once and shared
        (embedding is stateless). Handoff needs KV tiers on both sides,
        so a disaggregated build defaults ``host_kv_mb`` to 256 when
        unset; a shared ``disk_kv_dir`` makes the signature dir the
        cross-replica prefix medium. ``engine_factory(spec,
        quantize_weights=, quantize_kv=)`` returns a new
        ``GenerateEngine`` for ``spec`` (each replica gets its own
        engines, so its own session stores, over whatever weights the
        factory shares); without it each replica draws its weights
        from ``seed`` like a ``TorchBackend``."""
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if disaggregate and replicas < 2:
            raise ValueError("--disaggregate needs --replicas >= 2 "
                             "(one prefill + one decode tier minimum)")
        if disaggregate and not host_kv_mb:
            host_kv_mb = 256            # the handoff transport medium
        n_prefill = max(1, replicas // 2) if disaggregate else 0
        # the fleet controller's scale-up factory reads the same args:
        # same pool, QoS, device and quantization regime
        args = dict(
            pool=list(pool), seed=seed, device=resolve_device(device),
            engine_factory=engine_factory, embed_model=embed_model,
            qos=qos, draft_map=draft_map,
            draft_k=draft_k, continuous=continuous,
            continuous_chunk=continuous_chunk,
            continuous_slots=continuous_slots, host_kv_mb=host_kv_mb,
            disk_kv_dir=disk_kv_dir, disk_kv_gb=disk_kv_gb,
            quantize_weights=quantize_weights, quantize_kv=quantize_kv)
        reps: list[Replica] = []
        embedder = None
        for i in range(replicas):
            role = ("prefill" if i < n_prefill else "decode") \
                if disaggregate else "unified"
            backend = _replica_backend(args, role, embedder,
                                       tag_role=disaggregate)
            if embedder is None:
                embedder = backend.embedder
            reps.append(Replica(replica_id=f"{role}-{i}", role=role,
                                backend=backend))
        plane = cls(reps)
        plane._replica_args = args
        plane._embedder = embedder
        return plane

    def close(self) -> None:
        for rep in self.replicas:
            try:
                rep.close()
            except Exception:             # noqa: BLE001 — best-effort
                logger.exception("replica %s close failed",
                                 rep.replica_id)

    def _refresh_replica_gauges(self) -> None:
        counts: dict[tuple, int] = {}
        for rep in self.replicas:
            key = (rep.role, "alive" if rep.alive else "dead")
            counts[key] = counts.get(key, 0) + 1
        for role in ("prefill", "decode", "unified"):
            for liveness in ("alive", "dead"):
                CLUSTER_REPLICAS.set(counts.get((role, liveness), 0),
                                     role=role, liveness=liveness)

    def _own_session_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"__cluster{self._seq}"

    def _broadcast(self, event: dict) -> None:
        if self._bus is None:
            return
        try:
            from quoracle_tpu_torch.infra.bus import TOPIC_CLUSTER
            self._bus.broadcast(TOPIC_CLUSTER,
                                {"ts": time.time(), **event})
        except Exception:                 # noqa: BLE001 — telemetry only
            logger.exception("cluster broadcast failed")

    def _mark_failed(self, rep: Replica, error: str) -> None:
        self.router.mark_failed(rep.replica_id, error)
        self._refresh_replica_gauges()
        self._broadcast({"event": "replica_failed",
                         "replica": rep.replica_id, "role": rep.role,
                         "error": error[:200]})
        # incident capture rides router.mark_failed, the single
        # chokepoint of every replica death

    def pull_timeline(self, session_id: Optional[str] = None,
                      trace_id: Optional[str] = None) -> dict:
        """One session's ordered lifecycle across every replica:
        in-process replicas share the process-wide span ring, so the
        pull is local."""
        return fleetobs.assemble_timeline(
            fleetobs.SPANS.spans(), session_id=session_id,
            trace_id=trace_id)

    def pull_tree(self, tree_id: str) -> dict:
        """One coherent agent-tree view: in-process replicas share the
        process-wide tree registry, so the pull is local."""
        from quoracle_tpu_torch.infra import treeobs
        return treeobs.tree_payload(tree_id)

    # -- elastic topology  --------------------

    def _recompute_modes(self) -> None:
        self.disaggregated = any(r.role == "prefill"
                                 for r in self.replicas)

    def add_replica(self, role: str = "decode") -> Replica:
        """Spin up one replica in ``role`` and register it with the
        router — the fleet controller's scale-up primitive. Requires
        the factory args ``build`` saved (or a test-injected
        ``_replica_args``)."""
        if self._replica_args is None:
            raise RuntimeError(
                "this plane has no replica factory — build it via "
                "ClusterPlane.build (or set _replica_args) before "
                "scaling")
        a = dict(self._replica_args)
        a["host_kv_mb"] = a["host_kv_mb"] or 256
        backend = _replica_backend(a, role, self._embedder,
                                   tag_role=role in ("prefill", "decode"))
        if self._embedder is None:
            self._embedder = backend.embedder
        with self._lock:
            rid = f"{role}-{self._rep_seq}"
            self._rep_seq += 1
        rep = Replica(replica_id=rid, role=role, backend=backend)
        self.replicas.append(rep)
        self.router.register(rep)
        self._recompute_modes()
        self._refresh_replica_gauges()
        self._broadcast({"event": "replica_added", "replica": rid,
                         "role": role})
        return rep

    def remove_replica(self, replica_id: str) -> bool:
        """Retire a replica: deregister from the router and close its
        backend. The fleet controller drains it FIRST (live-migrating
        every resident session); calling this on an undrained replica
        loses its sessions to re-prefill — correct, just cold."""
        rep = next((r for r in self.replicas
                    if r.replica_id == replica_id), None)
        if rep is None:
            return False
        self.replicas.remove(rep)
        self.router.deregister(replica_id)
        self._recompute_modes()
        self._refresh_replica_gauges()
        try:
            rep.close()
        except Exception:                 # noqa: BLE001 — best-effort
            logger.exception("retired replica %s close failed",
                             replica_id)
        self._broadcast({"event": "replica_removed",
                         "replica": replica_id, "role": rep.role})
        return True

    # -- ModelBackend -----------------------------------------------------

    def query(self, requests: Sequence[QueryRequest]) -> list[QueryResult]:
        results: list[Optional[QueryResult]] = [None] * len(requests)
        parent = TRACER.current()
        if len(requests) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    max_workers=len(requests),
                    thread_name_prefix="cluster-row") as ex:
                list(ex.map(
                    lambda i: self._serve_one(i, requests[i], results,
                                              parent),
                    range(len(requests))))
        else:
            for i, r in enumerate(requests):
                self._serve_one(i, r, results, parent)
        return [r for r in results if r is not None]

    def _serve_one(self, i: int, r: QueryRequest, results: list,
                   parent=None) -> None:
        with TRACER.use(parent):
            try:
                with fleetobs.request_span("cluster.request",
                                           r.session_id,
                                           model=r.model_spec):
                    results[i] = self._route(r)
            except AdmissionError as e:
                results[i] = QueryResult(
                    model_spec=r.model_spec,
                    error=f"admission_rejected: {e} "
                          f"(retry_after_ms={e.retry_after_ms})")
            except ReplicaFailedError as e:
                results[i] = QueryResult(
                    model_spec=r.model_spec,
                    error=f"replica_failed: {e} "
                          f"(replica={e.replica_id}, phase={e.phase})")
            except Exception as e:        # noqa: BLE001 — row-level error
                results[i] = QueryResult(
                    model_spec=r.model_spec,
                    error=f"cluster query failed: {e}")

    def _has_image(self, r: QueryRequest) -> bool:
        return any(isinstance(m.get("content"), (list, tuple))
                   and any(isinstance(p, dict) and p.get("type") in
                           ("image", "image_base64", "image_url")
                           for p in m["content"])
                   for m in r.messages)

    def _route(self, r: QueryRequest) -> QueryResult:
        """One request through the cluster: whole-request delegation for
        unified replicas / affinity hits / image rows, the split
        prefill→handoff→decode flow otherwise."""
        if r.model_spec not in self.pool:
            return QueryResult(model_spec=r.model_spec,
                               error=f"unknown model {r.model_spec!r}",
                               permanent_error=True)
        if not self.disaggregated:
            rep = self.router.place("unified", session_id=r.session_id)
            return self._delegate(rep, r, path="unified")
        affinity = self.router.affinity_of(r.session_id)
        if affinity is not None and self._session_resident(affinity, r):
            # decode rows stick to the replica holding their pages: the
            # suffix prefill of a resumed conversation runs on the
            # decode replica itself — a continuation, not tier work
            return self._delegate(affinity, r, path="affinity")
        if self._has_image(r):
            # VLM rows skip KV sessions by design (runtime.py) — there
            # is no KV to hand off; the decode tier serves them whole
            rep = self.router.place("decode", session_id=r.session_id)
            return self._delegate(rep, r, path="image")
        return self._disagg(r)

    def _session_resident(self, rep: Replica, r: QueryRequest) -> bool:
        """Any engine on the replica still holds (or hibernates) the
        session — affinity entries can outlive sessions dropped by LRU
        churn, and routing to a page-less replica would silently
        re-prefill where fresh placement could do better."""
        if not r.session_id:
            return False
        eng = rep.backend.engines.get(r.model_spec)
        return (eng is not None
                and eng.session_tokens(r.session_id) is not None)

    def _delegate(self, rep: Replica, r: QueryRequest,
                  path: str) -> QueryResult:
        CLUSTER_REQUESTS_TOTAL.inc(replica=rep.replica_id, path=path)
        try:
            # Chaos seam: a "crash" here is a replica dying
            # while serving a delegated request — recovered through the
            # SAME mark-failed path a real device/transport death takes.
            CHAOS.fire("cluster.serve", replica=rep.replica_id)
            out = rep.backend.query([r])
        except Exception as e:            # noqa: BLE001 — replica-fatal
            self._mark_failed(rep, repr(e))
            raise ReplicaFailedError(
                f"replica {rep.replica_id} failed serving a "
                f"{path} request: {e}", replica_id=rep.replica_id,
                phase=path)
        if out and r.session_id and out[0].ok:
            self.router.set_affinity(r.session_id, rep.replica_id)
        return out[0] if out else QueryResult(
            model_spec=r.model_spec, error="replica returned no result")

    # -- the disaggregated flow ------------------------------------------

    def _disagg(self, r: QueryRequest) -> QueryResult:
        spec = r.model_spec
        t0 = time.monotonic()
        pre = self.router.place("prefill")
        # Row preparation on the PREFILL backend: identical tokenize/
        # splice/budget semantics to the monolithic path (runtime.py
        # _build_rows — one construction, zero drift). Fresh rows have
        # no resident session anywhere, so the splice is inert.
        tmp: list = [None]
        rows, live = pre.backend._build_rows(spec, [0], [r], tmp, t0)
        if not live:
            return tmp[0]                 # overflow / pre-dispatch deadline
        row = rows[0]
        hid = r.session_id or self._own_session_id()
        owns = r.session_id is None
        fleetobs.tag_current_span(hid)
        pe = pre.backend.engines[spec]
        CLUSTER_REQUESTS_TOTAL.inc(replica=pre.replica_id, path="disagg")
        t_pre = time.monotonic()
        try:
            g1 = pe.generate(
                [row["prompt"]], temperature=row["temperature"],
                top_p=row["top_p"], max_new_tokens=1,
                session_ids=[hid],
                constrain_json=[row["constrain_json"]],
                action_enums=[row["action_enum"]])[0]
        except Exception as e:            # noqa: BLE001 — replica-fatal
            self._mark_failed(pre, repr(e))
            # cold fallback: the whole request on a decode replica —
            # slower (no prefill tier), never wrong
            rep = self.router.place("decode")
            return self._delegate(rep, r, path="failover")
        js = g1.json_state if row["constrain_json"] else None
        try:
            env = self.handoff.export(pe, hid, spec,
                                      src_replica=pre.replica_id,
                                      json_state=js)
        except HandoffError as e:
            # no envelope → nothing to adopt; decode replica re-prefills
            # the whole prompt (cold). Correctness never depends on the
            # handoff succeeding.
            logger.warning("handoff export failed (%s); cold re-prefill",
                           e)
            rep = self.router.place("decode", session_id=r.session_id)
            return self._delegate(rep, r, path="failover")
        if TRACER.active():
            pre_ms = (time.monotonic() - t_pre) * 1000
            TRACER.emit("cluster.prefill", pre_ms,
                        ts=time.time() - pre_ms / 1000.0, session=hid,
                        model=spec, replica=pre.replica_id)
        try:
            return self._decode_phase(r, row, g1, env, hid, owns, t0)
        finally:
            self.handoff.forget(spec, hid)

    def _decode_phase(self, r: QueryRequest, row: dict, g1, env,
                      hid: str, owns: bool, t0: float,
                      exclude: tuple = ()) -> QueryResult:
        spec = r.model_spec
        dec = self.router.place("decode", exclude=exclude)
        t_dec = time.monotonic()
        try:
            self.handoff.adopt(dec.backend.engines[spec], env,
                               dst_replica=dec.replica_id)
        except HandoffError:
            # signature mismatch: version-skewed pair. The decode side
            # re-prefills cold — reject the BYTES, not the request.
            rep = self.router.place("decode", session_id=r.session_id,
                                    exclude=exclude)
            return self._delegate(rep, r, path="failover")
        budget = row["budget"]
        done = g1.finish_reason == "stop" or budget <= 1
        try:
            if done:
                g_ids, g2 = list(g1.token_ids), None
            else:
                g2 = self._decode_on(dec, spec, row, g1, hid)
                g_ids = list(g1.token_ids) + list(g2.token_ids)
        except AdmissionError:
            # the chosen replica shed: another decode replica may have
            # headroom — the front door only sheds when EVERY eligible
            # replica does (the last re-raise propagates the reject)
            remaining = [rep2 for rep2 in self.router.replicas("decode")
                         if rep2.replica_id
                         not in exclude + (dec.replica_id,)]
            if not remaining:
                raise
            return self._decode_phase(
                r, row, g1, env, hid, owns, t0,
                exclude=exclude + (dec.replica_id,))
        except Exception as e:            # noqa: BLE001 — replica death
            self._mark_failed(dec, repr(e))
            survivors = self.router.alive_count("decode")
            if survivors and self.handoff.inflight(spec, hid) is not None:
                # re-place through the retained envelope: the surviving
                # replica adopts the SAME prefill KV and decode reruns
                # from the handoff point — at temperature 0 the rerun is
                # bit-identical, so mid-stream death is invisible in the
                # output
                self.handoff.note_replaced(spec)
                from quoracle_tpu_torch.infra.flightrec import FLIGHT
                FLIGHT.record("kv_handoff_replace", model=spec,
                              session=hid, failed=dec.replica_id)
                self._broadcast({"event": "row_replaced", "model": spec,
                                 "failed_replica": dec.replica_id})
                return self._decode_phase(
                    r, row, g1, env, hid, owns, t0,
                    exclude=exclude + (dec.replica_id,))
            from quoracle_tpu_torch.infra.telemetry import (
                CLUSTER_HANDOFFS_TOTAL,
            )
            CLUSTER_HANDOFFS_TOTAL.inc(model=spec,
                                       status="replace_failed")
            raise ReplicaFailedError(
                f"decode replica {dec.replica_id} died mid-stream and "
                f"no surviving decode replica could adopt the row: {e}",
                replica_id=dec.replica_id, phase="decode")
        if TRACER.active():
            dec_ms = (time.monotonic() - t_dec) * 1000
            TRACER.emit("cluster.decode", dec_ms,
                        ts=time.time() - dec_ms / 1000.0, session=hid,
                        model=spec, replica=dec.replica_id)
        de = dec.backend.engines[spec]
        if owns:
            de.drop_session(hid)
        elif r.session_id:
            self.router.set_affinity(r.session_id, dec.replica_id)
        CLUSTER_REQUESTS_TOTAL.inc(replica=dec.replica_id, path="disagg")
        cfg = de.cfg
        n_prompt = g1.n_prompt_tokens
        latency_ms = (time.monotonic() - t0) * 1000
        cost = (n_prompt * cfg.input_cost_per_mtok
                + len(g_ids) * cfg.output_cost_per_mtok) / 1e6
        return QueryResult(
            model_spec=spec,
            # one decode over the concatenated ids — BPE merges across
            # the phase boundary must render exactly as a monolithic run
            text=de.tokenizer.decode(g_ids),
            usage=Usage(n_prompt, len(g_ids), cost),
            latency_ms=latency_ms,
            # split-phase serving: the per-call prefill/decode split is
            # not meaningful (same convention as continuous mode)
            prefill_ms=0.0, decode_ms=0.0,
            cached_tokens=g1.n_cached_tokens,
            spec_rounds=getattr(g2, "spec_rounds", 0),
            spec_accepted_tokens=getattr(g2, "spec_accepted_tokens", 0))

    def _decode_on(self, dec: Replica, spec: str, row: dict, g1,
                   hid: str):
        """The continuation (prompt + first token) on the decode
        replica: through its continuous batcher when it runs one (the
        production path — speculation included), a direct engine call
        otherwise."""
        # Chaos seam: decode-replica death AFTER the handoff
        # landed — the retained envelope must re-place the row onto a
        # survivor with bit-identical output (kv_handoff_replace), or
        # fail it with a structured error naming replica + phase.
        CHAOS.fire("cluster.decode", replica=dec.replica_id)
        continuation = list(row["prompt"]) + list(g1.token_ids)
        remaining = row["budget"] - len(g1.token_ids)
        js = g1.json_state if row["constrain_json"] else None
        cb = dec.backend._cbatchers.get(spec)
        if cb is not None:
            fut = cb.submit(
                continuation, temperature=row["temperature"],
                top_p=row["top_p"], max_new_tokens=remaining,
                session_id=hid, constrain_json=row["constrain_json"],
                action_enum=row["action_enum"],
                priority=row["priority"], tenant=row["tenant"],
                deadline_s=row["deadline_s"],
                initial_json_state=js,
                task_id=row.get("task_id"), decide=row.get("decide"),
                tree=row.get("tree"))
            return fut.result()
        de = dec.backend.engines[spec]
        return de.generate(
            [continuation], temperature=row["temperature"],
            top_p=row["top_p"], max_new_tokens=remaining,
            session_ids=[hid], constrain_json=[row["constrain_json"]],
            action_enums=[row["action_enum"]],
            initial_json_state=[js])[0]

    # -- pool-wide backend surface ---------------------------------------

    @property
    def engines(self) -> dict:
        """Replica-qualified engine map ("<replica>@<spec>") — keeps the
        resource attribution, dashboards, and HBM accounting
        (infra/resources.py) working over the whole cluster without a
        special case ("@" because model specs may themselves contain
        "/")."""
        out = {}
        for rep in self.replicas:
            for spec, e in rep.backend.engines.items():
                out[f"{rep.replica_id}@{spec}"] = e
        return out

    @property
    def draft_map(self) -> dict:
        """Replica-qualified draft wiring, same key scheme as
        ``engines`` — the HBM attribution's draft-role tagging."""
        out = {}
        for rep in self.replicas:
            for t, d in rep.backend.draft_map.items():
                out[f"{rep.replica_id}@{t}"] = f"{rep.replica_id}@{d}"
        return out

    def swap_draft(self, tspec: str, engine_factory, *,
                   name: Optional[str] = None) -> list:
        """Plane-level draft hot-swap: every live replica
        whose backend drafts ``tspec`` receives its OWN engine from
        ``engine_factory`` (separate session stores — a shared engine
        would alias paged KV across replicas). Returns
        ``[(replica_id, incumbent_engine)]`` for instant rollback.
        The fleet controller's ``swap_draft`` is the production path —
        per-replica quiesce plus the deterministic action ledger; this
        primitive is what it drives (the promoter that calls it is
        training's, ROADMAP Queue 1 item 11)."""
        out = []
        for rep in self.replicas:
            if not rep.alive or tspec not in rep.backend.draft_map:
                continue
            out.append((rep.replica_id,
                        rep.backend.swap_draft(tspec, engine_factory(),
                                               name=name)))
        return out

    @property
    def qos_controller(self):
        """The web edge's shed gate (server._qos_shed): the ROUTER is
        the cluster's admission surface — it sheds only when every
        eligible replica sheds, with the max retry-after."""
        if any(getattr(rep.backend, "qos_controller", None) is not None
               for rep in self.replicas):
            return self.router
        return None

    def attach_bus(self, bus) -> None:
        self._bus = bus
        for rep in self.replicas:
            rep.backend.attach_bus(bus)

    def watchdog_sources(self) -> list:
        out = []
        for rep in self.replicas:
            out.extend((f"{rep.replica_id}:{name}", fn)
                       for name, fn in rep.backend.watchdog_sources())
        return out

    def scheduler_stats(self) -> dict:
        return {f"{rep.replica_id}/{spec}": st
                for rep in self.replicas
                for spec, st in rep.backend.scheduler_stats().items()}

    def qos_stats(self) -> dict:
        per = {rep.replica_id: rep.backend.qos_stats()
               for rep in self.replicas}
        enabled = any(p.get("enabled") for p in per.values())
        return {"enabled": enabled, "cluster": True, "replicas": per,
                "router": self.router.stats() if enabled else None}

    def spec_stats(self) -> dict:
        per = {rep.replica_id: rep.backend.spec_stats()
               for rep in self.replicas}
        return {"enabled": any(p.get("enabled") for p in per.values()),
                "cluster": True, "replicas": per}

    def kv_stats(self) -> dict:
        per = {rep.replica_id: rep.backend.kv_stats()
               for rep in self.replicas}
        return {"enabled": any(p.get("enabled") for p in per.values()),
                "cluster": True, "replicas": per,
                "handoff": self.handoff.stats()}

    def cluster_stats(self) -> dict:
        """GET /api/cluster payload: topology + router + handoff +
        per-replica health in one read."""
        self._refresh_replica_gauges()
        return {
            "enabled": True,
            "disaggregated": self.disaggregated,
            "pool": list(self.pool),
            "replicas": [{
                "replica_id": rep.replica_id,
                "role": rep.role,
                "alive": rep.alive,
                "scheduler": rep.backend.scheduler_stats(),
            } for rep in self.replicas],
            "router": self.router.stats(),
            "handoff": self.handoff.stats(),
        }

    def prefetch_sessions(self, session_id: str) -> int:
        rep = self.router.affinity_of(session_id)
        if rep is not None:
            return rep.backend.prefetch_sessions(session_id)
        return 0

    def drop_session(self, session_id: str,
                     model_specs: Optional[Sequence[str]] = None) -> None:
        for rep in self.replicas:
            rep.backend.drop_session(session_id, model_specs)
        if model_specs is None:
            self.router.drop_affinity(session_id)

    def embed(self, texts: Sequence[str]) -> list[np.ndarray]:
        return self.replicas[0].backend.embed(texts)

    def count_tokens(self, model_spec: str, text: str) -> int:
        return self.replicas[0].backend.count_tokens(model_spec, text)

    def context_window(self, model_spec: str) -> int:
        return self.replicas[0].backend.context_window(model_spec)

    def output_limit(self, model_spec: str) -> int:
        return self.replicas[0].backend.output_limit(model_spec)
