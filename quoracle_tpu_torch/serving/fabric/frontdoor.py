"""The standalone router front door of the PyTorch port (port of
``quoracle_tpu/serving/fabric/frontdoor.py``).

The ClusterRouter places traffic over in-process replicas by reading
each admission controller's own :class:`SignalSnapshot`. This module runs
the SAME router in its own process over REMOTE peers:

* :class:`RemoteSignalsProxy` — the wire twin of a local
  ``qos_controller``: ``signals()`` polls the peer (MSG_SIGNALS_POLL),
  rebuilds the snapshot with the reported AGE re-anchored to the local
  clock (monotonic timestamps do not cross processes — ages do), and
  caches it under the router's own staleness guard so placement does
  not pay a round trip per candidate per request. ``admit()`` crosses
  the wire too, so the front door's aggregate shed (only when EVERY
  eligible peer sheds, MAX retry-after propagated) runs unchanged.
* :class:`FabricPlane` — a ModelBackend over
  :class:`~quoracle_tpu_torch.serving.cluster.RemoteReplica` peers: the
  ClusterPlane request flow (affinity → role → least-loaded; split
  prefill→handoff→decode when disaggregated) with the handoff envelope
  retained as WIRE BYTES at the front door. A decode peer dying
  mid-row re-places those bytes onto a survivor (the in-process death
  path, over the wire) or fails with the structured error naming
  peer + phase. A peer whose signals go silent is scored worst-rank by
  the router and marked failed after a bounded silence streak
  (serving/router.py).

Degraded modes mirror the in-process plane exactly: signature-mismatch
or corrupt-frame rejects at adopt degrade to a cold re-prefill on the
decode tier; an unreachable prefill tier degrades to cold decode-tier
serving; all-peers-shed propagates the 429 with the escalating
retry-after. Temperature-0 outputs never move
(tests/test_torch_fabric.py holds them to the JAX front door's).

``connect(..., io_timeout=)`` bounds every wire call; ``close()`` closes
the peers' transports (the peers themselves belong to their processes).
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

import numpy as np

from quoracle_tpu_torch.infra import fleetobs, introspect
from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.telemetry import (
    CLUSTER_REQUESTS_TOTAL, COST_GOODPUT_PER_CHIP, FABRIC_PEERS,
    FLEETOBS_GOODPUT, FLEETOBS_PEERS, FLEETOBS_SCRAPE_MS,
    FLEETOBS_SLO_BURN, FLEETOBS_STALENESS_S, TRACER,
)
from quoracle_tpu_torch.models.runtime import (
    ModelBackend, QueryRequest, QueryResult,
)
from quoracle_tpu_torch.serving.admission import AdmissionError, SignalSnapshot
from quoracle_tpu_torch.serving.cluster import ReplicaFailedError
from quoracle_tpu_torch.serving.fabric import wire
from quoracle_tpu_torch.serving.fabric.wire import (
    MSG_ADMIT, MSG_SIGNALS_POLL, TransportError, WireError,
)
from quoracle_tpu_torch.serving.router import ClusterRouter

logger = logging.getLogger(__name__)

# reasons that mean "this peer is gone", not "this request was refused"
_PEER_FATAL_REASONS = frozenset({"transport", "remote"})


class RemoteSignalsProxy:
    """``qos_controller``-shaped facade over one peer's admission
    controller. Snapshot polls are cached ``min_poll_s`` so placement
    scoring N candidates costs at most one poll per peer per window;
    ``max_age_s`` (the router's staleness guard) forces a refresh
    through the cache exactly like it forces one through the local
    controller's window."""

    def __init__(self, transport, min_poll_s: float = 0.25):
        self.transport = transport
        self.min_poll_s = float(min_poll_s)
        self._cached: Optional[SignalSnapshot] = None
        self._cached_at = 0.0

    def signals(self, max_age_s: Optional[float] = None) -> SignalSnapshot:
        now = time.monotonic()
        cached = self._cached
        if cached is not None:
            age = now - self._cached_at
            if age < self.min_poll_s and (max_age_s is None
                                          or cached.age_s(now) <= max_age_s):
                return cached
        _, payload = self.transport.request(
            MSG_SIGNALS_POLL, wire.encode_json({"max_age_s": max_age_s}))
        d = wire.decode_json(payload)
        now = time.monotonic()
        snap = SignalSnapshot(
            ts=now,
            refreshed_ts=now - float(d.get("age_s", 0.0)),
            queue_depth=int(d.get("queue_depth", 0)),
            admit_wait_p95_ms=d.get("admit_wait_p95_ms"),
            hbm_headroom=d.get("hbm_headroom"),
            admitted=int(d.get("admitted", 0)),
            shed=int(d.get("shed", 0)))
        self._cached, self._cached_at = snap, now
        return snap

    def admit(self, tenant: str = "default", priority=None,
              deadline_s: Optional[float] = None):
        """Remote admission: sheds reconstruct as the peer's structured
        AdmissionError (wire.raise_remote_error); an UNREACHABLE peer
        counts as an overload shed — it cannot admit anything, and the
        silence path is already marching it toward mark-failed."""
        from quoracle_tpu_torch.serving.admission import OverloadedError
        from quoracle_tpu_torch.serving.qos import coerce_priority
        left = None
        if deadline_s is not None:
            left = max(0.0, (deadline_s - time.monotonic()) * 1000)
        ctx = fleetobs.TraceContext.current()
        try:
            _, payload = self.transport.request(
                MSG_ADMIT, wire.encode_json({
                    "tenant": tenant,
                    "priority": (int(priority) if priority is not None
                                 else None),
                    "deadline_ms_left": left,
                    "trace": ctx.to_dict() if ctx else None}))
        except TransportError as e:
            raise OverloadedError(
                f"peer unreachable at admission: {e}",
                retry_after_ms=1000, tenant=tenant) from None
        return coerce_priority(wire.decode_json(payload).get("priority"))


class FabricPlane(ModelBackend):
    """N remote peers + the router + a retained-envelope-bytes ledger
    behind the ModelBackend seam — the standalone front door process
    (``--fabric-peers``). The consensus/agent/web layers cannot tell it
    from a single TorchBackend, which is the point."""

    def __init__(self, peers: Sequence, router: Optional[ClusterRouter] = None):
        if not peers:
            raise ValueError("a fabric plane needs at least one peer")
        self.peers = list(peers)
        self.router = router or ClusterRouter()
        for p in self.peers:
            self.router.register(p)
        self.disaggregated = any(p.role == "prefill" for p in self.peers)
        if self.disaggregated and not any(p.role == "decode"
                                          for p in self.peers):
            raise ValueError("fabric has prefill peers but no decode "
                             "peer")
        self.pool = list(self.peers[0].pool)
        self._lock = named_lock("fabric.plane")
        self._seq = 0
        self._bus = None
        self._meta_cache: dict = {}       # (op, spec) -> value
        self.wire_handoffs = 0
        self.replaced = 0
        self.cold_failovers = 0
        # fleet observability: span ring for timeline pulls,
        # federation sweep cache, and the incident broadcast hook that
        # makes every peer's flight ring land in one bundle
        fleetobs.ensure_ring()
        self._fed: Optional[fleetobs.FederatedMetrics] = None
        self._fed_at = 0.0
        self._fed_tokens: Optional[float] = None
        self._fed_chip_ms: Optional[float] = None
        self._incident_notifier = self._broadcast_incident
        fleetobs.INCIDENTS.add_notifier(self._incident_notifier)
        self._refresh_peer_gauges()

    @classmethod
    def connect(cls, peer_addrs: Sequence[str], *,
                connect_timeout: float = 2.0, io_timeout: float = 60.0,
                retries: int = 2) -> "FabricPlane":
        """Front door over TCP: one transport per ``[role@]host:port``
        peer (role is confirmed — or discovered — via the hello)."""
        from quoracle_tpu_torch.serving.cluster import RemoteReplica
        from quoracle_tpu_torch.serving.fabric.transport import (
            TcpTransport, parse_addr,
        )
        peers = []
        for spec in peer_addrs:
            role, host, port = parse_addr(spec)
            t = TcpTransport(host, port, connect_timeout=connect_timeout,
                             io_timeout=io_timeout, retries=retries)
            peers.append(RemoteReplica(t, role=role))
        return cls(peers)

    def close(self) -> None:
        fleetobs.INCIDENTS.remove_notifier(self._incident_notifier)
        for p in self.peers:
            try:
                p.close()
            except Exception:             # noqa: BLE001 — best-effort
                logger.exception("peer %s close failed", p.replica_id)

    # -- elastic peer set --------------------------------------

    def add_peer(self, addr: str, *, connect_timeout: float = 2.0,
                 io_timeout: float = 60.0, retries: int = 2):
        """Register one more ``[role@]host:port`` peer at a running
        front door — the fleet's scale-up registration surface: the
        operator spins the peer process, the door attaches it without a
        restart."""
        from quoracle_tpu_torch.serving.cluster import RemoteReplica
        from quoracle_tpu_torch.serving.fabric.transport import (
            TcpTransport, parse_addr,
        )
        role, host, port = parse_addr(addr)
        t = TcpTransport(host, port, connect_timeout=connect_timeout,
                         io_timeout=io_timeout, retries=retries)
        peer = RemoteReplica(t, role=role)
        self.peers.append(peer)
        self.router.register(peer)
        self.disaggregated = any(p.role == "prefill"
                                 for p in self.peers)
        self._refresh_peer_gauges()
        self._broadcast({"event": "peer_added",
                         "peer": peer.replica_id, "role": peer.role})
        return peer

    def remove_peer(self, replica_id: str) -> bool:
        """Deregister a peer (scale-down retirement at the door; the
        operator drains/retires the peer process itself)."""
        peer = next((p for p in self.peers
                     if p.replica_id == replica_id), None)
        if peer is None:
            return False
        self.peers.remove(peer)
        self.router.deregister(replica_id)
        self._refresh_peer_gauges()
        try:
            peer.close()
        except Exception:                 # noqa: BLE001 — best-effort
            logger.exception("removed peer %s close failed", replica_id)
        self._broadcast({"event": "peer_removed", "peer": replica_id,
                         "role": peer.role})
        return True

    def rejoin_peer(self, replica_id: str) -> bool:
        """Restore a peer previously marked failed: re-issue the hello on
        its transport; a matching answer (same replica_id and role — a
        DIFFERENT process at the same address must not inherit the old
        identity's role) restores it to the placement set with a clean
        silent-poll streak, so a restarted peer needs no restart of the
        door. Its old affinities stayed purged by mark_failed — the
        sessions died with the process; new traffic lands normally."""
        peer = next((p for p in self.peers
                     if p.replica_id == replica_id), None)
        if peer is None or peer.alive:
            return False
        try:
            _, payload = peer.transport.request(
                wire.MSG_HELLO, wire.encode_json({}))
            hello = wire.decode_json(payload)
        except WireError:
            return False                  # still down; try again later
        if (hello.get("replica_id") != peer.replica_id
                or hello.get("role") != peer.role):
            logger.warning(
                "peer at %s answered hello as %s/%s, expected %s/%s — "
                "not rejoining a different identity", replica_id,
                hello.get("replica_id"), hello.get("role"),
                peer.replica_id, peer.role)
            return False
        peer.alive = True
        self.router.revive(replica_id)
        self._refresh_peer_gauges()
        FLIGHT.record("fabric_peer_rejoin", peer=replica_id,
                      role=peer.role)
        self._broadcast({"event": "peer_rejoined", "peer": replica_id,
                         "role": peer.role})
        return True

    def try_rejoin_dead_peers(self) -> int:
        """One re-join sweep over every dead peer — called by the
        stats path and the fleet ticker, so a restarted peer is
        restored within a poll interval instead of never."""
        return sum(1 for p in list(self.peers)
                   if not p.alive and self.rejoin_peer(p.replica_id))

    # -- bookkeeping ------------------------------------------------------

    def _refresh_peer_gauges(self) -> None:
        counts: dict = {}
        for p in self.peers:
            key = (p.role, "alive" if p.alive else "dead")
            counts[key] = counts.get(key, 0) + 1
        for role in ("prefill", "decode", "unified"):
            for liveness in ("alive", "dead"):
                FABRIC_PEERS.set(counts.get((role, liveness), 0),
                                 role=role, liveness=liveness)

    def _own_session_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"__fabric{self._seq}"

    def _broadcast(self, event: dict) -> None:
        if self._bus is None:
            return
        try:
            from quoracle_tpu_torch.infra.bus import TOPIC_FABRIC
            self._bus.broadcast(TOPIC_FABRIC,
                                {"ts": time.time(), **event})
        except Exception:                 # noqa: BLE001 — telemetry only
            logger.exception("fabric broadcast failed")

    def _mark_failed(self, peer, error: str, phase: str) -> None:
        self.router.mark_failed(peer.replica_id, error)
        peer.alive = False
        self._refresh_peer_gauges()
        FLIGHT.record("fabric_peer_dead", peer=peer.replica_id,
                      role=peer.role, phase=phase, error=error[:200])
        self._broadcast({"event": "peer_failed",
                         "peer": peer.replica_id, "role": peer.role,
                         "phase": phase, "error": error[:200]})
        # incident capture rides router.mark_failed: the
        # door's registered notifier then broadcasts the deterministic
        # incident id to every surviving peer, so their flight-ring
        # dumps land in the same retention-pruned bundle

    def _broadcast_incident(self, incident_id: str, kind: str,
                            key: str, reason: str) -> None:
        """INCIDENTS notifier: fan the incident id out over the fabric
        so every reachable peer's flight-ring dump joins the bundle.
        Best-effort per peer — a dead peer is often the incident."""
        for p in list(self.peers):
            if not p.alive or not hasattr(p, "obs_incident"):
                continue
            try:
                p.obs_incident(incident_id, reason=reason)
            except WireError:
                pass

    # -- fleet observability -----------------------------------

    def pull_timeline(self, session_id: Optional[str] = None,
                      trace_id: Optional[str] = None) -> dict:
        """GET /api/timeline: the session's spans pulled from EVERY
        reachable peer over the new wire op, merged with the door's own
        ring, deduped and ordered into one lifecycle with per-stage
        TTFT attribution (fleetobs.assemble_timeline)."""
        spans = fleetobs.SPANS.spans()
        for p in list(self.peers):
            if not p.alive or not hasattr(p, "pull_spans"):
                continue
            try:
                spans.extend(p.pull_spans(session_id=session_id,
                                          trace_id=trace_id))
            except WireError:
                continue                  # a silent peer's slice is lost
        return fleetobs.assemble_timeline(spans, session_id=session_id,
                                          trace_id=trace_id)

    def pull_tree(self, tree_id: str) -> dict:
        """GET /api/tree?tree_id=…: ONE coherent agent-tree view
        assembled across scattered peers — the door's own
        registry slice plus every reachable peer's, pulled over the
        MSG_OBS ``tree`` op and merged by treeobs.tree_view (payloads
        dedup by registry id, so loopback peers sharing this process's
        registry are counted exactly once; subtree rollup conservation
        is asserted exact on the merged result). A dead peer's slice is
        absent — its nodes surface as ORPHANS, never silently
        unparented."""
        from quoracle_tpu_torch.infra import treeobs
        if not treeobs.enabled():
            return {"enabled": False, "tree_id": tree_id}
        states = [treeobs.local_tree_state(tree_id)]
        for p in list(self.peers):
            if not p.alive or not hasattr(p, "pull_tree"):
                continue
            try:
                states.append(p.pull_tree(tree_id))
            except WireError:
                continue
        return treeobs.tree_payload(tree_id, states)

    def pull_profile(self) -> dict:
        """GET /api/profile?scope=fleet: the door's own liveness/
        hotspot payload plus every reachable peer's, pulled over the
        MSG_OBS ``profile`` op. Best-effort per peer — a
        hung peer is often exactly what the profile is for, so a
        silent one is reported absent, never waited on past the
        transport timeout."""
        from quoracle_tpu_torch.infra import introspect
        out = introspect.profile_payload()
        out["peers"] = {}
        for p in list(self.peers):
            if not p.alive or not hasattr(p, "obs_profile"):
                continue
            try:
                out["peers"][p.replica_id] = p.obs_profile()
            except WireError:
                continue
        return out

    def federated_metrics(self,
                          max_age_s: float = 2.0) -> fleetobs.FederatedMetrics:
        """The fleet-wide metrics rollup: every peer's lossless registry
        state scraped over the wire and merged (summed-count histogram
        cells — quantiles equal the per-peer oracle), cached
        ``max_age_s`` so scrape storms cost one sweep. Sets the
        fleet SLO-burn / goodput / staleness gauges as a side effect."""
        now = time.monotonic()
        with self._lock:
            fed, at = self._fed, self._fed_at
        if fed is not None and now - at < max_age_s:
            FLEETOBS_STALENESS_S.set(round(now - at, 3))
            return fed
        t0 = time.monotonic()
        # the door itself is a peer of the rollup: its router/fabric
        # series ride under peer="door" so the exposition declares each
        # metric name exactly once, all series peer-labeled
        door = fleetobs.local_obs_state()
        states: dict = {"door": door["state"]}
        ok = failed = 0
        slo_burn = 0.0
        tokens = 0.0
        chip_ms = float(door.get("chip_ms_total") or 0.0)
        for p in list(self.peers):
            if not p.alive or not hasattr(p, "obs_metrics"):
                failed += 1
                continue
            try:
                out = p.obs_metrics()
            except WireError:
                failed += 1
                continue
            ok += 1
            states[p.replica_id] = out.get("state") or {}
            slo_burn = max(slo_burn, float(out.get("slo_burn") or 0.0))
            tokens += float(out.get("tokens_total") or 0.0)
            chip_ms += float(out.get("chip_ms_total") or 0.0)
        fed = fleetobs.federate(states)
        now = time.monotonic()
        with self._lock:
            last_at, last_tokens = self._fed_at, self._fed_tokens
            last_chip = self._fed_chip_ms
            self._fed, self._fed_at = fed, now
            self._fed_tokens = tokens
            self._fed_chip_ms = chip_ms
        FLEETOBS_SCRAPE_MS.observe((now - t0) * 1000)
        FLEETOBS_PEERS.set(ok, status="ok")
        FLEETOBS_PEERS.set(failed, status="failed")
        FLEETOBS_STALENESS_S.set(0.0)
        FLEETOBS_SLO_BURN.set(round(slo_burn, 4))
        if last_tokens is not None and now > last_at:
            FLEETOBS_GOODPUT.set(
                round(max(0.0, tokens - last_tokens)
                      / (now - last_at), 2))
        if last_chip is not None:
            # goodput-per-chip-second: window token delta over
            # window chip-second delta across the fleet — efficiency, not
            # throughput.  Only meaningful when chips actually ran this
            # window; a zero chip delta leaves the gauge at its last
            # value rather than exporting an infinity.
            d_chip_s = max(0.0, chip_ms - last_chip) / 1000.0
            if d_chip_s > 0:
                COST_GOODPUT_PER_CHIP.set(
                    round(max(0.0, tokens - (last_tokens or 0.0))
                          / d_chip_s, 2))
        return fed

    # -- ModelBackend -----------------------------------------------------

    def query(self, requests: Sequence[QueryRequest]) -> list[QueryResult]:
        results: list[Optional[QueryResult]] = [None] * len(requests)
        parent = TRACER.current()
        if len(requests) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    max_workers=len(requests),
                    thread_name_prefix="fabric-row") as ex:
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
                with fleetobs.request_span("door.request", r.session_id,
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
                    error=f"fabric query failed: {e}")

    def _route(self, r: QueryRequest) -> QueryResult:
        if r.model_spec not in self.pool:
            return QueryResult(model_spec=r.model_spec,
                               error=f"unknown model {r.model_spec!r}",
                               permanent_error=True)
        if not self.disaggregated:
            rep = self.router.place("unified", session_id=r.session_id)
            return self._delegate(rep, r, path="unified")
        affinity = self.router.affinity_of(r.session_id)
        if affinity is not None and affinity.session_resident(r):
            # decode rows stick to the peer holding their pages — the
            # suffix prefill of a resumed conversation is a
            # continuation on the decode peer, not tier work
            return self._delegate(affinity, r, path="affinity")
        return self._disagg(r)

    def _delegate(self, peer, r: QueryRequest, path: str) -> QueryResult:
        CLUSTER_REQUESTS_TOTAL.inc(replica=peer.replica_id, path=path)
        try:
            out = peer.serve(r)
        except AdmissionError:
            raise                          # a shed is not a death
        except WireError as e:
            self._mark_failed(peer, str(e), phase=path)
            raise ReplicaFailedError(
                f"peer {peer.replica_id} failed serving a {path} "
                f"request: {e}", replica_id=peer.replica_id, phase=path)
        if r.session_id and out.ok:
            self.router.set_affinity(r.session_id, peer.replica_id)
        return out

    # -- the disaggregated wire flow --------------------------------------

    def _disagg(self, r: QueryRequest) -> QueryResult:
        spec = r.model_spec
        t0 = time.monotonic()
        # door-scope wait decomposition: what THE DOOR
        # waited on — each RPC leg is a "wire" wait from here (the
        # peer's own rows decompose their inner walls), routing and
        # placement land in the exact remainder
        clock = introspect.WaitClock() if introspect.enabled() else None
        pre = self.router.place("prefill")
        hid = r.session_id or self._own_session_id()
        owns = r.session_id is None
        fleetobs.tag_current_span(hid)
        CLUSTER_REQUESTS_TOTAL.inc(replica=pre.replica_id, path="disagg")
        try:
            meta, env_bytes = pre.prefill(r, hid)
        except AdmissionError:
            raise
        except WireError as e:
            if e.reason in ("export_failed", "no_tier"):
                # the peer served the prefill but could not hand it
                # off: cold re-prefill on the decode tier — correctness
                # never depends on the handoff succeeding
                logger.warning("wire handoff export failed (%s); cold "
                               "re-prefill", e)
            else:
                self._mark_failed(pre, str(e), phase="prefill")
            with self._lock:
                self.cold_failovers += 1
            rep = self.router.place("decode", session_id=r.session_id)
            return self._delegate(rep, r, path="failover")
        if "result" in meta:
            # overflow / pre-dispatch deadline: structured, nothing
            # prefilled
            return wire.result_from_dict(meta["result"])
        with self._lock:
            self.wire_handoffs += 1
        leg_ms = (time.monotonic() - t0) * 1000
        if clock is not None:
            clock.note("wire", int(leg_ms * 1e6))
        FLIGHT.record("fabric_handoff_wire", model=spec, session=hid,
                      src=pre.replica_id, bytes=len(env_bytes),
                      ms=round(leg_ms, 2))
        if TRACER.active():
            # the whole prefill RPC leg: peer-side prefill rides inside
            # it, so (door.prefill_rpc − peer.prefill) is the wire +
            # serialization cost the timeline attributes to "wire"
            TRACER.emit("door.prefill_rpc", leg_ms,
                        ts=time.time() - leg_ms / 1000.0, session=hid,
                        model=spec, replica=pre.replica_id,
                        bytes=len(env_bytes))
        return self._decode_phase(r, meta, env_bytes, hid, owns, t0,
                                  clock=clock)

    def _decode_phase(self, r: QueryRequest, meta: dict,
                      env_bytes: bytes, hid: str, owns: bool, t0: float,
                      exclude: tuple = (), clock=None) -> QueryResult:
        spec = r.model_spec
        dec = self.router.place("decode", exclude=exclude)
        t_leg = time.monotonic()
        try:
            d = dec.adopt_decode(meta, env_bytes, owns=owns)
        except AdmissionError:
            # the chosen peer shed: the front door only sheds when
            # EVERY eligible decode peer does (the final re-raise
            # propagates the reject with the escalated retry hint)
            remaining = [p for p in self.router.replicas("decode")
                         if p.replica_id not in exclude
                         + (dec.replica_id,)]
            if not remaining:
                raise
            return self._decode_phase(r, meta, env_bytes, hid, owns, t0,
                                      exclude=exclude
                                      + (dec.replica_id,), clock=clock)
        except WireError as e:
            if e.reason == "signature":
                # version-skewed pair: the BYTES are rejected before
                # the peer parsed a single page — the request is not
                with self._lock:
                    self.cold_failovers += 1
                rep = self.router.place("decode",
                                        session_id=r.session_id,
                                        exclude=exclude)
                return self._delegate(rep, r, path="failover")
            self._mark_failed(dec, str(e), phase="decode")
            survivors = self.router.alive_count("decode")
            if survivors:
                # re-place through the retained envelope BYTES: the
                # surviving peer adopts the SAME prefill KV and decode
                # reruns from the handoff point — bit-identical at
                # temperature 0, so mid-stream peer death is invisible
                # in the output
                with self._lock:
                    self.replaced += 1
                FLIGHT.record("kv_handoff_replace", model=spec,
                              session=hid, failed=dec.replica_id)
                self._broadcast({"event": "row_replaced", "model": spec,
                                 "failed_peer": dec.replica_id})
                return self._decode_phase(
                    r, meta, env_bytes, hid, owns, t0,
                    exclude=exclude + (dec.replica_id,), clock=clock)
            raise ReplicaFailedError(
                f"decode peer {dec.replica_id} died mid-stream and no "
                f"surviving decode peer could adopt the row: {e}",
                replica_id=dec.replica_id, phase="decode")
        CLUSTER_REQUESTS_TOTAL.inc(replica=dec.replica_id, path="disagg")
        if clock is not None or TRACER.active():
            dec_ms = (time.monotonic() - t_leg) * 1000
            if clock is not None:
                # the decode RPC leg is "wire" at door scope; the
                # peer's own rows decompose the time inside it
                clock.note("wire", int(dec_ms * 1e6))
            if TRACER.active():
                TRACER.emit("door.decode_rpc", dec_ms,
                            ts=time.time() - dec_ms / 1000.0, session=hid,
                            model=spec, replica=dec.replica_id)
        if not owns and r.session_id:
            self.router.set_affinity(r.session_id, dec.replica_id)
        res = wire.result_from_dict(d)
        res.latency_ms = (time.monotonic() - t0) * 1000
        if clock is not None:
            # only the innermost successful call closes the ledger —
            # the re-place paths above return the recursive result
            introspect.record_row_waits(f"door:{spec}", clock.close())
        return res

    # -- pool-wide backend surface ---------------------------------------

    @property
    def qos_controller(self):
        """The web edge's shed gate: the ROUTER is the fabric's
        admission surface (sheds only when every eligible peer sheds,
        MAX retry-after) — peers answer admission over the wire."""
        return self.router

    def attach_bus(self, bus) -> None:
        self._bus = bus

    def _meta(self, op: str, model_spec: str, cacheable: bool = True):
        key = (op, model_spec)
        if cacheable and key in self._meta_cache:
            return self._meta_cache[key]
        v = self.peers[0].meta(op, model_spec=model_spec)
        if cacheable:
            self._meta_cache[key] = v
        return v

    def embed(self, texts: Sequence[str]) -> list[np.ndarray]:
        arr = self.peers[0].embed(texts)
        return [np.asarray(row) for row in arr]

    def count_tokens(self, model_spec: str, text: str) -> int:
        return int(self.peers[0].meta("count_tokens",
                                      model_spec=model_spec, text=text))

    def context_window(self, model_spec: str) -> int:
        return int(self._meta("context_window", model_spec))

    def output_limit(self, model_spec: str) -> int:
        return int(self._meta("output_limit", model_spec))

    def drop_session(self, session_id: str,
                     model_specs: Optional[Sequence[str]] = None) -> None:
        for p in self.peers:
            if p.alive:
                try:
                    p.drop_session(session_id)
                except WireError:
                    pass                  # a dead peer holds nothing
        if model_specs is None:
            self.router.drop_affinity(session_id)

    def scheduler_stats(self) -> dict:
        out = {}
        for p in self.peers:
            if not p.alive:
                continue
            try:
                st = p.stats().get("scheduler", {})
            except WireError:
                continue
            for spec, s in st.items():
                out[f"{p.replica_id}/{spec}"] = s
        return out

    def fabric_stats(self) -> dict:
        """GET /api/fabric payload: peer topology + router + wire
        counters in one read. Doubles as the re-join sweep:
        a dead peer that answers its hello again is restored here, so
        an operator watching the panel sees the restart land without
        bouncing the door."""
        self.try_rejoin_dead_peers()
        self._refresh_peer_gauges()
        with self._lock:
            counters = {"wire_handoffs": self.wire_handoffs,
                        "replaced": self.replaced,
                        "cold_failovers": self.cold_failovers}
        return {
            "enabled": True,
            "disaggregated": self.disaggregated,
            "pool": list(self.pool),
            "peers": [{
                "replica_id": p.replica_id,
                "role": p.role,
                "alive": p.alive,
                "transport": p.transport.stats(),
            } for p in self.peers],
            "router": self.router.stats(),
            "obs": {
                "span_ring": fleetobs.SPANS.stats(),
                "incidents": fleetobs.INCIDENTS.status(),
                "federation_age_s": round(
                    max(0.0, time.monotonic() - self._fed_at), 3)
                if self._fed is not None else None,
            },
            **counters,
        }

    def watchdog_sources(self) -> list:
        return []                          # peers watchdog themselves


def _main(argv=None) -> int:
    """``python -m quoracle_tpu_torch.serving.fabric.frontdoor --peers
    role@host:port,... [--probe]`` — connect to the fleet and print the
    topology + per-peer signal snapshots as JSON. The full serving
    front door is a Runtime with ``--fabric-peers`` (cli.py); this
    entry point is the operator's reachability probe (DEPLOY.md §13)."""
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="quoracle_tpu_torch.serving.fabric.frontdoor")
    ap.add_argument("--peers", required=True,
                    help="comma-separated [role@]host:port peer list")
    args = ap.parse_args(argv)
    plane = FabricPlane.connect(args.peers.split(","))
    try:
        print(json.dumps(plane.fabric_stats(), indent=2, default=str))
    finally:
        plane.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
