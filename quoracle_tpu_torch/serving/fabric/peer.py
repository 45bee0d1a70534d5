"""FabricPeer: one replica process served over the wire (port of
``quoracle_tpu/serving/fabric/peer.py``).

A peer owns one role-tagged ``TorchBackend``, the engine set a
ClusterPlane replica owns in process, and exposes it as a dispatch
surface the transports carry (a
:class:`~quoracle_tpu_torch.serving.fabric.transport.PeerServer` over
TCP, a LoopbackTransport in one process). Per row:

  idle --serve--> whole-request query (unified / affinity / failover)
  idle --prefill-> build rows, 1-token generate, hibernate into a
                   HandoffEnvelope, envelope BYTES to the front door (the
                   peer forgets it: the door's retained bytes are the
                   failover source now)
  idle --decode--> signature gate (header only, before page bytes),
                   adopt by page-in, continuation through the continuous
                   batcher (speculation, QoS, grammar resume), text back

``prefill`` runs the ``_build_rows`` and 1-token generate the in-process
ClusterPlane runs, ``decode`` its adopt and batcher continuation, and the
envelope crosses byte-exact, so at temperature 0 a request served by two
peers over the wire gives the tokens the ClusterPlane gives.

Admission stays per peer: a shed inside ``decode`` or ``serve`` travels
back as a structured admission error, and the front door re-places or
propagates the 429 with the MAX retry-after.

``python -m quoracle_tpu_torch.serving.fabric.peer --pool SPEC,...
--listen [role@]host:port`` runs one peer process, on the GPU unless
``--device cpu``; ``--weights-seed N`` draws its members' weights from a
``torch.Generator`` seeded N on the device
(``models.transformer.init_params``), so two processes given the same
seed serve the same weights; with it ``--layers N`` cuts the member to
its first N layers and ``--dtype float32`` serves it in fp32.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np

from quoracle_tpu_torch.infra import fleetobs
from quoracle_tpu_torch.infra.telemetry import TRACER
from quoracle_tpu_torch.serving.fabric import wire
from quoracle_tpu_torch.serving.fabric.wire import (
    MSG_ADMIT, MSG_ADMITTED, MSG_DECODE, MSG_DECODED, MSG_DROP_SESSION,
    MSG_EMBED, MSG_EMBEDDED, MSG_ERROR, MSG_HELLO, MSG_META, MSG_OBS,
    MSG_OBS_RESULT, MSG_OK, MSG_PREFILL, MSG_PREFILLED, MSG_RESULT,
    MSG_SERVE, MSG_SIGNALS, MSG_SIGNALS_POLL, MSG_STATS, WireError,
)

logger = logging.getLogger(__name__)


class FabricPeer:
    """One replica's wire surface. ``handle`` is the carrier-agnostic
    dispatch; ``listen`` binds it to a TCP PeerServer."""

    def __init__(self, backend, replica_id: str = "peer-0",
                 role: str = "unified"):
        from quoracle_tpu_torch.serving.handoff import KVHandoff
        self.backend = backend
        self.replica_id = replica_id
        self.role = role
        self.handoff = KVHandoff()
        self._server = None
        # every peer keeps a span ring, so the front door can pull its
        # slice of a session's timeline
        fleetobs.ensure_ring()

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, pool: Sequence[str], *, role: str = "unified",
              replica_id: Optional[str] = None, seed: int = 0,
              device=None,
              engine_factory: Optional[Callable[..., Any]] = None,
              qos=None, draft_map: Optional[dict] = None,
              draft_k: int = 6, continuous: bool = True,
              continuous_chunk: int = 32, continuous_slots: int = 8,
              host_kv_mb: int = 0, disk_kv_dir: Optional[str] = None,
              disk_kv_gb: float = 8.0,
              embed_model: Optional[str] = None,
              quantize_weights: bool = False,
              quantize_kv: bool = False) -> "FabricPeer":
        """One role-tagged replica backend on ``device`` (None: the GPU,
        which raises without one), built as ``ClusterPlane.build`` builds
        a replica: a prefill peer runs no batcher and no drafts, and every
        peer gets a KV tier, the handoff's medium. ``engine_factory(spec,
        quantize_weights=, quantize_kv=)`` hands it prebuilt engines (over
        shared weights) instead of weights drawn from ``seed``."""
        from quoracle_tpu_torch.models.generate import resolve_device
        from quoracle_tpu_torch.serving.cluster import _replica_backend
        if not host_kv_mb:
            host_kv_mb = 256              # the handoff transport medium
        args = dict(
            pool=list(pool), seed=seed, device=resolve_device(device),
            engine_factory=engine_factory, embed_model=embed_model,
            qos=qos, draft_map=draft_map, draft_k=draft_k,
            continuous=continuous, continuous_chunk=continuous_chunk,
            continuous_slots=continuous_slots, host_kv_mb=host_kv_mb,
            disk_kv_dir=disk_kv_dir, disk_kv_gb=disk_kv_gb,
            quantize_weights=quantize_weights, quantize_kv=quantize_kv)
        backend = _replica_backend(args, role, None,
                                   tag_role=role in ("prefill", "decode"))
        return cls(backend, replica_id=replica_id or f"{role}-0",
                   role=role)

    def attach_prefixd(self, transport) -> None:
        """Wire the fleet prefix service into every pool engine's tier:
        one shared transport, one read-through client per engine
        signature (the signature is the store directory's key)."""
        from quoracle_tpu_torch.serving.fabric.prefixd import PrefixdClient
        for spec in self.backend.pool:
            eng = self.backend.engines[spec]
            tier = eng.sessions.tier
            if tier is None:
                tier = eng.attach_tier(host_mb=256)
            tier.attach_prefixd(
                PrefixdClient(transport, eng.kv_signature()))

    def listen(self, host: str = "127.0.0.1", port: int = 0,
               name: Optional[str] = None):
        from quoracle_tpu_torch.serving.fabric.transport import PeerServer
        self._server = PeerServer(
            self.handle, host=host, port=port,
            name=name or f"fabric-{self.replica_id}")
        return self._server

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None
        self.backend.close()

    # -- dispatch ---------------------------------------------------------

    def handle(self, msg_type: int, payload: bytes) -> tuple[int, bytes]:
        if msg_type == MSG_HELLO:
            return MSG_OK, wire.encode_json(self._hello())
        if msg_type == MSG_SERVE:
            return self._h_serve(payload)
        if msg_type == MSG_PREFILL:
            return self._h_prefill(payload)
        if msg_type == MSG_DECODE:
            return self._h_decode(payload)
        if msg_type == MSG_SIGNALS_POLL:
            return self._h_signals(payload)
        if msg_type == MSG_ADMIT:
            return self._h_admit(payload)
        if msg_type == MSG_STATS:
            return MSG_OK, wire.encode_json(self.stats())
        if msg_type == MSG_DROP_SESSION:
            sid = wire.decode_json(payload).get("session_id")
            if sid:
                self.backend.drop_session(sid)
            return MSG_OK, wire.encode_json({})
        if msg_type == MSG_EMBED:
            return self._h_embed(payload)
        if msg_type == MSG_META:
            return self._h_meta(payload)
        if msg_type == MSG_OBS:
            return self._h_obs(payload)
        return MSG_ERROR, wire.error_payload(
            f"peer {self.replica_id!r} does not serve op {msg_type}",
            reason="decode")

    def _h_obs(self, payload: bytes) -> tuple[int, bytes]:
        """Fleet observability ops: ``spans`` (this peer's span-ring slice
        for a session or trace), ``metrics`` (the lossless registry state
        of the federation scrape), ``incident`` (dump the flight ring into
        the named incident bundle), ``profile`` (the introspect plane)
        and ``tree`` (this peer's slice of one agent tree)."""
        d = wire.decode_json(payload)
        op = d.get("op")
        if op == "spans":
            spans = fleetobs.SPANS.spans(
                session_id=d.get("session_id"),
                trace_id=d.get("trace_id"))
            return MSG_OBS_RESULT, wire.encode_json(
                {"replica_id": self.replica_id, "spans": spans,
                 "ring": fleetobs.SPANS.stats()})
        if op == "metrics":
            out = fleetobs.local_obs_state()
            out["replica_id"] = self.replica_id
            slo = getattr(self.backend, "slo", None)
            if slo is not None:
                from quoracle_tpu_torch.serving.qos import Priority
                try:
                    out["slo_burn"] = slo.burn(Priority.INTERACTIVE)
                except Exception:         # noqa: BLE001 — best-effort
                    pass
            return MSG_OBS_RESULT, wire.encode_json(out)
        if op == "incident":
            path = fleetobs.INCIDENTS.peer_dump(
                str(d.get("incident_id") or "unknown"),
                self.replica_id)
            return MSG_OBS_RESULT, wire.encode_json(
                {"replica_id": self.replica_id, "dumped": bool(path),
                 "path": path})
        if op == "profile":
            from quoracle_tpu_torch.infra import introspect
            out = introspect.profile_payload()
            out["replica_id"] = self.replica_id
            return MSG_OBS_RESULT, wire.encode_json(out)
        if op == "tree":
            # payloads are registry-tagged, so loopback peers sharing one
            # process registry are counted once in the door's merge
            from quoracle_tpu_torch.infra import treeobs
            out = treeobs.local_tree_state(d.get("tree_id"))
            out["replica_id"] = self.replica_id
            return MSG_OBS_RESULT, wire.encode_json(out)
        raise WireError(f"unknown obs op {op!r}", reason="decode")

    def _hello(self) -> dict:
        return {
            "replica_id": self.replica_id,
            "role": self.role,
            "pool": list(self.backend.pool),
            "qos": getattr(self.backend, "qos_controller", None)
            is not None,
            "signatures": {spec: self.backend.engines[spec].kv_signature()
                           for spec in self.backend.pool},
            "wire_version": wire.WIRE_VERSION,
        }

    # -- whole-request serving -------------------------------------------

    def _h_serve(self, payload: bytes) -> tuple[int, bytes]:
        from quoracle_tpu_torch.infra import treeobs
        from quoracle_tpu_torch.models.runtime import QueryResult
        d = wire.decode_json(payload)
        r = wire.request_from_dict(d)
        # rebind the caller's trace: this peer's spans (admit, queue
        # wait, decode) land in the front door's trace
        ctx = fleetobs.TraceContext.from_dict(d.get("trace"))
        tctx = treeobs.TreeContext.from_dict(d.get("tree"))
        with fleetobs.bind_remote(ctx), treeobs.bind(tctx):
            with fleetobs.request_span("peer.serve", r.session_id,
                                       model=r.model_spec,
                                       replica=self.replica_id):
                out = self.backend.query([r])
        res = out[0] if out else QueryResult(
            model_spec=r.model_spec, error="peer returned no result")
        return MSG_RESULT, wire.encode_json(wire.result_to_dict(res))

    # -- the prefill phase ------------------------------------------------

    def _h_prefill(self, payload: bytes) -> tuple[int, bytes]:
        """Rows built by the backend's own ``_build_rows``, one emitted
        token, the session hibernated into envelope bytes. An export
        failure answers a structured reject (the front door degrades
        cold); an engine exception propagates through the dispatch shell
        as a peer-fatal error."""
        from quoracle_tpu_torch.infra import treeobs
        from quoracle_tpu_torch.serving.handoff import HandoffError
        d = wire.decode_json(payload)
        r = wire.request_from_dict(d["request"])
        hid = d["handoff_id"]
        spec = r.model_spec
        b = self.backend
        if spec not in b.engines:
            return MSG_ERROR, wire.error_payload(
                f"unknown model {spec!r} on peer {self.replica_id!r}",
                reason="decode")
        ctx = fleetobs.TraceContext.from_dict(
            (d["request"] or {}).get("trace"))
        tctx = treeobs.TreeContext.from_dict(
            (d["request"] or {}).get("tree"))
        with fleetobs.bind_remote(ctx), treeobs.bind(tctx), \
                fleetobs.request_span("peer.prefill", hid, model=spec,
                                      replica=self.replica_id):
            t0 = time.monotonic()
            tmp: list = [None]
            rows, live = b._build_rows(spec, [0], [r], tmp, t0)
            if not live:
                # overflow / pre-dispatch deadline: the structured result
                # rides back as is, nothing to hand off
                return MSG_PREFILLED, wire.pack_blob(
                    {"result": wire.result_to_dict(tmp[0])})
            row = rows[0]
            pe = b.engines[spec]
            g1 = pe.generate(
                [row["prompt"]], temperature=row["temperature"],
                top_p=row["top_p"], max_new_tokens=1, session_ids=[hid],
                constrain_json=[row["constrain_json"]],
                action_enums=[row["action_enum"]])[0]
            js = g1.json_state if row["constrain_json"] else None
            try:
                env = self.handoff.export(pe, hid, spec,
                                          src_replica=self.replica_id,
                                          json_state=js)
            except HandoffError as e:
                return MSG_ERROR, wire.error_payload(
                    str(e), reason=e.reason, error_type="handoff")
        # the front door's retained BYTES are the failover source now
        self.handoff.forget(spec, hid)
        env_bytes = wire.encode_envelope(env)
        deadline_ms_left = None
        if row["deadline_s"] is not None:
            deadline_ms_left = max(
                0.0, (row["deadline_s"] - time.monotonic()) * 1000)
        meta = {
            "handoff_id": hid,
            "model_spec": spec,
            "prompt": [int(t) for t in row["prompt"]],
            "row": {
                "temperature": row["temperature"],
                "top_p": row["top_p"],
                "budget": row["budget"],
                "constrain_json": row["constrain_json"],
                "action_enum": (list(row["action_enum"])
                                if row["action_enum"] else None),
                "priority": row["priority"],
                "tenant": row["tenant"],
                "deadline_ms_left": deadline_ms_left,
                # the decode peer books the continuation's waits to the
                # same tree node
                "tree": row.get("tree"),
            },
            "g1": {
                "token_ids": [int(t) for t in g1.token_ids],
                "json_state": g1.json_state,
                "finish_reason": g1.finish_reason,
                "n_prompt_tokens": g1.n_prompt_tokens,
                "n_cached_tokens": g1.n_cached_tokens,
            },
        }
        return MSG_PREFILLED, wire.pack_blob(meta, env_bytes)

    # -- the decode phase -------------------------------------------------

    def _h_decode(self, payload: bytes) -> tuple[int, bytes]:
        """Signature gate on the HEADER, adopt by page-in, then the
        continuation through the serving path (ClusterPlane's decode
        phase, peer-side). An AdmissionError propagates structurally and
        the front door tries the next decode peer."""
        from quoracle_tpu_torch.infra import treeobs
        header, body = wire.unpack_blob(payload)
        spec = header["model_spec"]
        hid = header["handoff_id"]
        b = self.backend
        de = b.engines[spec]
        # the KV signature is checked before any page byte is parsed: a
        # skewed pair answers a structured reject and the front door
        # serves the request cold
        env = wire.decode_envelope(bytes(body),
                                   expect_signature=de.kv_signature())
        # the exporter's monotonic stamp does not cross processes:
        # re-anchor, so the handoff histogram measures the adopt leg
        env.ts = time.monotonic()
        ctx = (fleetobs.TraceContext.from_dict(header.get("trace"))
               or fleetobs.TraceContext.from_dict(env.trace))
        tctx = (treeobs.TreeContext.from_dict(
                    (header.get("row") or {}).get("tree"))
                or treeobs.TreeContext.from_dict(header.get("tree"))
                or treeobs.TreeContext.from_dict(
                    getattr(env, "tree", None)))
        with fleetobs.bind_remote(ctx), treeobs.bind(tctx), \
                fleetobs.request_span("peer.decode", hid, model=spec,
                                      replica=self.replica_id):
            self.handoff.adopt(de, env, dst_replica=self.replica_id)
            row, g1 = header["row"], header["g1"]
            budget = row["budget"]
            g1_ids = [int(t) for t in g1["token_ids"]]
            done = g1["finish_reason"] == "stop" or budget <= 1
            g2 = None
            try:
                if done:
                    g_ids = list(g1_ids)
                else:
                    g2 = self._continue(de, spec, header, row, g1, hid)
                    g_ids = g1_ids + [int(t) for t in g2.token_ids]
            except BaseException:
                # a failed continuation must not strand the adopted pages
                # here: the front door re-places from its retained bytes
                de.drop_session(hid)
                raise
        if header.get("owns"):
            de.drop_session(hid)
        cfg = de.cfg
        n_prompt = int(g1["n_prompt_tokens"])
        cost = (n_prompt * cfg.input_cost_per_mtok
                + len(g_ids) * cfg.output_cost_per_mtok) / 1e6
        return MSG_DECODED, wire.encode_json({
            "model_spec": spec,
            # one decode over the concatenated ids: BPE merges across the
            # phase boundary render as a monolithic run
            "text": de.tokenizer.decode(g_ids),
            "usage": {"prompt_tokens": n_prompt,
                      "completion_tokens": len(g_ids), "cost": cost},
            "prefill_ms": 0.0, "decode_ms": 0.0,
            "cached_tokens": int(g1["n_cached_tokens"]),
            "spec_rounds": getattr(g2, "spec_rounds", 0),
            "spec_accepted_tokens": getattr(g2, "spec_accepted_tokens",
                                            0),
        })

    def _continue(self, de, spec: str, header: dict, row: dict, g1: dict,
                  hid: str):
        """The continuation (prompt + first token) through this peer's
        continuous batcher when it runs one (speculation included), a
        direct engine call otherwise."""
        continuation = [int(t) for t in header["prompt"]] \
            + [int(t) for t in g1["token_ids"]]
        remaining = row["budget"] - len(g1["token_ids"])
        js = g1["json_state"] if row["constrain_json"] else None
        deadline_s = None
        if row.get("deadline_ms_left") is not None:
            deadline_s = time.monotonic() \
                + row["deadline_ms_left"] / 1000.0
        ae = tuple(row["action_enum"]) if row.get("action_enum") else None
        cb = self.backend._cbatchers.get(spec)
        if cb is not None:
            fut = cb.submit(
                continuation, temperature=row["temperature"],
                top_p=row["top_p"], max_new_tokens=remaining,
                session_id=hid, constrain_json=row["constrain_json"],
                action_enum=ae, priority=row["priority"],
                tenant=row["tenant"], deadline_s=deadline_s,
                initial_json_state=js, tree=row.get("tree"))
            return fut.result()
        return de.generate(
            [continuation], temperature=row["temperature"],
            top_p=row["top_p"], max_new_tokens=remaining,
            session_ids=[hid], constrain_json=[row["constrain_json"]],
            action_enums=[ae], initial_json_state=[js])[0]

    # -- signals / admission ---------------------------------------------

    def _h_signals(self, payload: bytes) -> tuple[int, bytes]:
        d = wire.decode_json(payload)
        ctrl = getattr(self.backend, "qos_controller", None)
        if ctrl is None:
            depth = 0
            try:
                for st in self.backend.scheduler_stats().values():
                    depth += int(st.get("queued", 0)) \
                        + int(st.get("live", 0))
            except Exception:             # noqa: BLE001 — best-effort
                pass
            return MSG_SIGNALS, wire.encode_json(
                {"qos": False, "queue_depth": depth, "age_s": 0.0})
        snap = ctrl.signals(max_age_s=d.get("max_age_s"))
        out = snap.as_dict()
        # monotonic timestamps do not cross processes: the AGE does
        out["age_s"] = snap.age_s()
        out["qos"] = True
        return MSG_SIGNALS, wire.encode_json(out)

    def _h_admit(self, payload: bytes) -> tuple[int, bytes]:
        from quoracle_tpu_torch.serving.qos import coerce_priority
        d = wire.decode_json(payload)
        ctrl = getattr(self.backend, "qos_controller", None)
        deadline_s = None
        if d.get("deadline_ms_left") is not None:
            deadline_s = time.monotonic() + d["deadline_ms_left"] / 1000.0
        if ctrl is None:
            cls = coerce_priority(d.get("priority"))
            return MSG_ADMITTED, wire.encode_json(
                {"priority": int(cls), "qos": False})
        t0 = time.monotonic()
        cls = ctrl.admit(tenant=d.get("tenant", "default"),
                         priority=d.get("priority"),
                         deadline_s=deadline_s)
        if TRACER.active():
            ctx = fleetobs.TraceContext.from_dict(d.get("trace"))
            TRACER.emit("peer.admit",
                        (time.monotonic() - t0) * 1000, parent=ctx,
                        replica=self.replica_id,
                        tenant=d.get("tenant", "default"))
        return MSG_ADMITTED, wire.encode_json(
            {"priority": int(cls), "qos": True})

    # -- embed / meta -----------------------------------------------------

    def _h_embed(self, payload: bytes) -> tuple[int, bytes]:
        texts = wire.decode_json(payload)["texts"]
        vecs = self.backend.embed(texts)
        arr = np.ascontiguousarray(np.stack(vecs)) if vecs \
            else np.zeros((0, 0), np.float32)
        return MSG_EMBEDDED, wire.pack_blob(
            {"dtype": str(arr.dtype), "shape": list(arr.shape)},
            arr.view(np.uint8).reshape(-1).tobytes())

    def _h_meta(self, payload: bytes) -> tuple[int, bytes]:
        d = wire.decode_json(payload)
        op, spec = d.get("op"), d.get("model_spec")
        if op == "count_tokens":
            v = self.backend.count_tokens(spec, d.get("text", ""))
        elif op == "context_window":
            v = self.backend.context_window(spec)
        elif op == "output_limit":
            v = self.backend.output_limit(spec)
        elif op == "session_resident":
            eng = self.backend.engines.get(spec)
            v = bool(eng is not None and d.get("session_id")
                     and eng.session_tokens(d["session_id"]) is not None)
        else:
            raise WireError(f"unknown meta op {op!r}", reason="decode")
        return MSG_OK, wire.encode_json({"value": v})

    # -- reads ------------------------------------------------------------

    def stats(self) -> dict:
        """The stats op: scheduler, handoff ledger, QoS flag and, in the
        port, the kernel wrappers' launch counts of this process (the
        front door reads a child-process peer's launches here)."""
        from quoracle_tpu_torch.ops import kernels
        return {
            "replica_id": self.replica_id,
            "role": self.role,
            "scheduler": self.backend.scheduler_stats(),
            "handoff": self.handoff.stats(),
            "qos": (self.backend.qos_stats().get("enabled", False)
                    if hasattr(self.backend, "qos_stats") else False),
            "launches": kernels.launch_counts(),
        }


def _cut_factory(spec: str, *, layers: int, dtype: str, weights_seed: int,
                 device, session_mb: int = 0):
    """The engine factory of ``_main``'s ``--layers``/``--dtype``/
    ``--weights-seed``: ``spec``'s config cut to ``layers`` layers, its
    weights drawn on ``device`` from a generator seeded ``weights_seed``
    and cast to ``dtype``, prefix sharing off, each engine's session pool
    ``session_mb`` MiB (0: the engine default). Another process calling
    this with the same arguments draws the same weights."""
    import dataclasses

    import torch

    from quoracle_tpu_torch.models import config as C
    from quoracle_tpu_torch.models.generate import (
        GenerateEngine, resolve_device,
    )
    from quoracle_tpu_torch.models.tokenizer import get_tokenizer
    from quoracle_tpu_torch.models.transformer import init_params
    dev = resolve_device(device)
    base = C.get_model_config(spec)
    cfg = base
    if layers and layers != base.n_layers:
        cfg = C.register_model(dataclasses.replace(
            base, name=f"{base.name}-{layers}layer", n_layers=layers))
    gen = torch.Generator(device=dev)
    gen.manual_seed(weights_seed)
    params = init_params(cfg, gen, device=dev,
                         dtype=getattr(torch, dtype))
    tok = get_tokenizer(spec)

    def factory(s, quantize_weights=False, quantize_kv=False):
        if s != spec:
            raise KeyError(f"this peer serves {spec!r}, not {s!r}")
        kw = {"session_max_bytes": session_mb << 20} if session_mb else {}
        eng = GenerateEngine(cfg, params, tok, seed=0, device=dev,
                             quantize_weights=quantize_weights,
                             quantize_kv=quantize_kv, **kw)
        eng.prefix_sharing = False
        return eng
    return factory


def _main(argv=None) -> int:
    """``python -m quoracle_tpu_torch.serving.fabric.peer --pool ...
    --listen [role@]host:port``: one replica process. The Runtime's
    ``fabric_listen`` embeds the same server beside a full node; this
    entry point is the bare peer. It prints ``fabric peer <id> (<role>)
    serving <pool> at <host:port>`` once it listens, and serves until
    SIGINT or SIGTERM."""
    import argparse
    import signal
    import threading

    from quoracle_tpu_torch.serving.fabric.transport import (
        TcpTransport, parse_addr,
    )

    ap = argparse.ArgumentParser(
        prog="quoracle_tpu_torch.serving.fabric.peer")
    ap.add_argument("--pool", required=True,
                    help="comma-separated model specs")
    ap.add_argument("--listen", required=True,
                    help="[role@]host:port (role: prefill | decode | "
                         "unified; default unified; port 0: a free "
                         "port, printed)")
    ap.add_argument("--replica-id", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' serves "
                         "the plain PyTorch paths)")
    ap.add_argument("--qos", action="store_true")
    ap.add_argument("--continuous-chunk", type=int, default=32)
    ap.add_argument("--host-kv-mb", type=int, default=0)
    ap.add_argument("--disk-kv-dir", default=None)
    ap.add_argument("--prefixd", default=None,
                    help="host:port of the fleet prefix service")
    ap.add_argument("--weights-seed", type=int, default=None,
                    help="draw the (single) pool member's weights from "
                         "this generator seed on the device, cut by "
                         "--layers and cast to --dtype")
    ap.add_argument("--layers", type=int, default=0,
                    help="with --weights-seed: serve the first N layers")
    ap.add_argument("--dtype", default="bfloat16",
                    help="with --weights-seed: the weights' dtype")
    args = ap.parse_args(argv)
    role, host, port = parse_addr(args.listen)
    pool = args.pool.split(",")
    factory = None
    if args.weights_seed is not None:
        if len(pool) != 1:
            raise SystemExit("--weights-seed serves a one-member pool")
        factory = _cut_factory(pool[0], layers=args.layers,
                               dtype=args.dtype,
                               weights_seed=args.weights_seed,
                               device=args.device)
    peer = FabricPeer.build(
        pool, role=role or "unified", replica_id=args.replica_id,
        seed=args.seed, device=args.device, engine_factory=factory,
        qos=args.qos or None, continuous_chunk=args.continuous_chunk,
        host_kv_mb=args.host_kv_mb, disk_kv_dir=args.disk_kv_dir)
    if args.prefixd:
        _, phost, pport = parse_addr(args.prefixd)
        peer.attach_prefixd(TcpTransport(
            phost, pport, peer_name="prefixd",
            lock_name="fabric.prefixd"))
    server = peer.listen(host, port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(f"fabric peer {peer.replica_id} ({peer.role}) serving "
          f"{peer.backend.pool} at {server.addr}", flush=True)
    try:
        while not stop.wait(3600):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        peer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
