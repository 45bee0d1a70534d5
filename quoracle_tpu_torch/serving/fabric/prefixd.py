"""Fleet prefix service (port of ``quoracle_tpu/serving/fabric/prefixd.py``):
the content-addressed ``DiskPrefixStore`` as a network service.

The disk tier (serving/kvtier.py) makes a RESTARTED process warm; this
module makes the FLEET warm. One prefixd process owns the store directory,
and every replica's ``TierManager`` carries a read-through
:class:`PrefixdClient`: a radix miss falls through host, local disk, then
the fleet, so a freshly booted replica warm-starts from prefixes any peer
computed.

Protocol (three framed ops, serving/fabric/wire.py):

* ``prefix_get``: JSON ``{signature, key, tokens}`` answers
  ``prefix_hit`` (blob: dtype and shape header, K bytes, V bytes, int8
  entries' fp32 scales) or ``prefix_miss``. The server loads through
  ``DiskPrefixStore.load``, so the crc32 check, the token-prefix check
  and the reject-and-unlink of a corrupt entry are the local store's: a
  bad file is unlinked on the server and the client sees a miss.
* ``prefix_put``: blob ``{signature, key, tokens, dtype, shapes}`` and
  the sections, answered ``ok {stored}``; content-addressed dedup at the
  server.
* ``prefix_stats``: per-signature store stats.

The signature directory layout is the store's own
(``<root>/<model-geometry-dtype>/``), so engines of another geometry or
cache dtype never exchange bytes. The client is an optimization, never a
correctness dependency: any transport failure (and the chaos
``fabric.prefixd`` ``unavailable`` directive) degrades to a local miss,
and the caller prefills.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from quoracle_tpu_torch.serving.fabric import wire
from quoracle_tpu_torch.serving.fabric.wire import (
    MSG_ERROR, MSG_OK, MSG_PREFIX_GET, MSG_PREFIX_HIT, MSG_PREFIX_MISS,
    MSG_PREFIX_PUT, MSG_PREFIX_STATS, TransportError, WireError,
)

logger = logging.getLogger(__name__)


def _as_tensor(a) -> Optional[torch.Tensor]:
    """A host block's array as a CPU tensor (the tier hands tensors; a
    caller may hand numpy, which has no bf16)."""
    if a is None or isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class PrefixService:
    """The server side: one directory root, one DiskPrefixStore per
    signature subdirectory (created lazily, byte-budgeted like the local
    tier's). The handler is carrier-agnostic: a PeerServer serves it over
    TCP, a LoopbackTransport in one process."""

    def __init__(self, root: str, budget_gb: float = 32.0):
        self.root = root
        self.budget_gb = float(budget_gb)
        self._stores: dict = {}
        self._lock = threading.Lock()     # store table only, leaf-local

    def _store(self, signature: str):
        from quoracle_tpu_torch.serving.kvtier import DiskPrefixStore
        if not signature or "/" in signature or ".." in signature:
            raise WireError(f"bad store signature {signature!r}",
                            reason="decode")
        with self._lock:
            st = self._stores.get(signature)
            if st is None:
                st = self._stores[signature] = DiskPrefixStore(
                    self.root, signature,
                    model=signature.split("-")[0],
                    budget_bytes=int(self.budget_gb * (1 << 30)))
            return st

    def handle(self, msg_type: int, payload: bytes) -> tuple[int, bytes]:
        if msg_type == MSG_PREFIX_GET:
            req = wire.decode_json(payload)
            loaded = self._store(req["signature"]).load(
                req["key"], req["tokens"])
            if loaded is None:
                return MSG_PREFIX_MISS, wire.encode_json({})
            header, chunks = wire.kv_sections(*loaded)
            return MSG_PREFIX_HIT, wire.pack_blob(header, *chunks)
        if msg_type == MSG_PREFIX_PUT:
            header, body = wire.unpack_blob(payload)
            k, v, ks, vs, _ = wire.read_kv(header, body)
            stored = self._store(header["signature"]).save(
                header["key"], header["tokens"], k, v, ks, vs)
            return MSG_OK, wire.encode_json({"stored": bool(stored)})
        if msg_type == MSG_PREFIX_STATS:
            with self._lock:
                stores = dict(self._stores)
            return MSG_OK, wire.encode_json(
                {sig: st.stats() for sig, st in stores.items()})
        return MSG_ERROR, wire.error_payload(
            f"prefixd does not serve op {msg_type}", reason="decode")


class PrefixdClient:
    """Per-replica read-through client for one engine signature, wired
    into ``TierManager.extend_prefix`` (fetch, on the restore path under
    the store lock, by the design argument of the local disk read) and
    the spill writer (publish, never under serving locks).

    Every failure degrades: ``fetch`` answers None (the caller prefills),
    ``publish`` drops the block (any prefill recomputes it). The
    ``degraded`` counter and the ``fabric_prefixd_degraded`` flight event
    are the operator's prefixd-unavailable signal."""

    def __init__(self, transport, signature: str):
        self.transport = transport
        self.signature = signature
        self.hits = 0
        self.misses = 0
        self.published = 0
        self.degraded = 0

    def _chaos(self) -> Optional[str]:
        from quoracle_tpu_torch.chaos.faults import CHAOS
        d = CHAOS.fire("fabric.prefixd", replica=self.signature)
        return d.kind if d is not None else None

    def _note_degraded(self, op: str, why: str) -> None:
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        from quoracle_tpu_torch.infra.telemetry import FABRIC_PREFIXD_TOTAL
        self.degraded += 1
        FABRIC_PREFIXD_TOTAL.inc(op=op, status="error")
        FLIGHT.record("fabric_prefixd_degraded", op=op,
                      signature=self.signature, why=why[:160])

    def fetch(self, key: str, tokens: Sequence[int]):
        """One block from the fleet as CPU tensors ``(k, v)`` (int8:
        ``(k, v, k_scale, v_scale)``), or None: a miss, an unavailable
        service and an undecodable hit all degrade as a local miss."""
        from quoracle_tpu_torch.infra.telemetry import FABRIC_PREFIXD_TOTAL
        if self._chaos() == "unavailable":
            self._note_degraded("get", "chaos-injected unavailability")
            return None
        try:
            rtype, payload = self.transport.request(
                MSG_PREFIX_GET,
                wire.encode_json({"signature": self.signature,
                                  "key": key,
                                  "tokens": [int(t) for t in tokens]}))
        except (TransportError, WireError) as e:
            self._note_degraded("get", str(e))
            return None
        if rtype != MSG_PREFIX_HIT:
            self.misses += 1
            FABRIC_PREFIXD_TOTAL.inc(op="get", status="miss")
            return None
        try:
            header, body = wire.unpack_blob(payload)
            k, v, ks, vs, _ = wire.read_kv(header, body)
        except WireError as e:
            self._note_degraded("get", f"undecodable hit: {e}")
            return None
        self.hits += 1
        FABRIC_PREFIXD_TOTAL.inc(op="get", status="hit")
        return (k, v) if ks is None else (k, v, ks, vs)

    def publish(self, key: str, tokens: Sequence[int], k, v,
                k_scale=None, v_scale=None) -> bool:
        """Push one block to the fleet (the spill writer's thread only:
        this does wire I/O and must never run under serving locks)."""
        from quoracle_tpu_torch.infra.telemetry import FABRIC_PREFIXD_TOTAL
        if self._chaos() == "unavailable":
            self._note_degraded("put", "chaos-injected unavailability")
            return False
        kv, chunks = wire.kv_sections(_as_tensor(k), _as_tensor(v),
                                      _as_tensor(k_scale),
                                      _as_tensor(v_scale))
        header = {"signature": self.signature, "key": key,
                  "tokens": [int(t) for t in tokens], **kv}
        blob = wire.pack_blob(header, *chunks)
        try:
            _, payload = self.transport.request(MSG_PREFIX_PUT, blob)
        except (TransportError, WireError) as e:
            self._note_degraded("put", str(e))
            return False
        stored = bool(wire.decode_json(payload).get("stored"))
        self.published += int(stored)
        FABRIC_PREFIXD_TOTAL.inc(op="put",
                                 status="stored" if stored else "dup")
        return stored

    def stats(self) -> dict:
        return {
            "signature": self.signature,
            "hits": self.hits, "misses": self.misses,
            "published": self.published, "degraded": self.degraded,
            "transport": self.transport.stats(),
        }


def _main(argv=None) -> int:
    """``python -m quoracle_tpu_torch.serving.fabric.prefixd --root DIR
    --listen HOST:PORT``: the standalone fleet prefix service. Serves
    until SIGINT or SIGTERM."""
    import argparse
    import signal

    from quoracle_tpu_torch.serving.fabric.transport import PeerServer

    ap = argparse.ArgumentParser(
        prog="quoracle_tpu_torch.serving.fabric.prefixd")
    ap.add_argument("--root", required=True,
                    help="store directory (one signature subdir per "
                         "engine geometry)")
    ap.add_argument("--listen", default="127.0.0.1:9470",
                    help="host:port to serve on (port 0: a free port, "
                         "printed)")
    ap.add_argument("--budget-gb", type=float, default=32.0,
                    help="byte budget per signature store (oldest-LRU "
                         "pruned)")
    args = ap.parse_args(argv)
    host, _, port = args.listen.rpartition(":")
    service = PrefixService(args.root, budget_gb=args.budget_gb)
    server = PeerServer(service.handle, host=host or "127.0.0.1",
                        port=int(port), name="prefixd")
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(f"prefixd serving {args.root} at {server.addr}", flush=True)
    try:
        while not stop.wait(3600):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
