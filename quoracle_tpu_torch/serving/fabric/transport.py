"""Fabric transports (port of ``quoracle_tpu/serving/fabric/transport.py``):
how frames move.

One abstraction, :meth:`Transport.request(msg_type, payload)`, and its
far sides:

* :class:`LoopbackTransport`: the request frame is ENCODED, (chaos-)
  mutated and DECODED through the full wire codec before the peer handler
  sees it, so every byte-level path (crc reject, truncation, version
  skew, retry on corruption) runs in one process without a socket. Two
  "replica processes" in one test process are two FabricPeers joined by
  loopback transports.
* :class:`TcpTransport` + :class:`PeerServer`: a threaded TCP peer with
  explicit connect, read and write deadlines, one request in flight per
  connection (serialized under the transport's ranked lock), and a
  reconnect per retry.

Every transport failure surfaces as a structured
:class:`~quoracle_tpu_torch.serving.fabric.wire.TransportError` after
bounded retry with backoff: a transient fault (one dropped or corrupted
frame, a refused connect while a peer restarts) is absorbed by the retry
loop; a persistent one degrades as an in-process replica death does. No
socket operation runs without a deadline.

Chaos seam: ``fabric.send`` fires per ATTEMPT with the peer name as the
stream key: ``drop`` fails the attempt, ``delay`` stretches it,
``corrupt`` flips a byte of the encoded request frame so the RECEIVER's
crc boundary rejects it.

``PeerServer`` names its threads ``<name>-accept`` and ``<name>-conn``
after the ``name`` it is given, and ``close()`` shuts its live
connections and joins their threads with a deadline, so a closed server
leaves no thread behind.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Callable, Optional

from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.serving.fabric import wire
from quoracle_tpu_torch.serving.fabric.wire import (
    MSG_ERROR, TransportError, WireError,
)

logger = logging.getLogger(__name__)

# error reasons worth one more attempt: a re-sent frame can survive a
# transient corruption or drop; version skew and oversize cannot change
# between attempts
RETRYABLE_REASONS = frozenset({"crc", "truncated", "magic", "transport"})


def _flip_byte(frame: bytes) -> bytes:
    """The chaos ``corrupt`` directive: one payload byte inverted (past
    the header, so the receiver sees a valid header and a crc
    mismatch)."""
    if len(frame) <= wire.HEADER_BYTES:
        return frame
    i = wire.HEADER_BYTES + (len(frame) - wire.HEADER_BYTES) // 2
    return frame[:i] + bytes([frame[i] ^ 0xFF]) + frame[i + 1:]


class Transport:
    """Base: the retry, backoff, chaos and metrics shell around one
    ``_roundtrip(frame, timeout) -> (msg_type, payload)``."""

    def __init__(self, peer_name: str = "peer", *, retries: int = 2,
                 backoff_ms: float = 25.0,
                 lock_name: str = "fabric.transport"):
        self.peer_name = peer_name
        self.retries = max(0, int(retries))
        self.backoff_ms = float(backoff_ms)
        self._lock = named_lock(lock_name)
        self.requests = 0
        self.errors = 0
        self.retried = 0

    def _roundtrip(self, frame: bytes,
                   timeout: Optional[float]) -> tuple[int, bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def request(self, msg_type: int, payload: bytes,
                timeout: Optional[float] = None) -> tuple[int, bytes]:
        """One request/response exchange. Raises the reconstructed
        structured error on MSG_ERROR responses (wire errors, remote
        admission sheds), :class:`TransportError` when the peer stays
        unreachable through every retry."""
        from quoracle_tpu_torch.chaos.faults import CHAOS
        from quoracle_tpu_torch.infra import introspect
        from quoracle_tpu_torch.infra.telemetry import (
            FABRIC_REQUESTS_TOTAL, FABRIC_RETRIES_TOTAL, FABRIC_RTT_MS,
        )
        op = wire.op_name(msg_type)
        t0 = time.monotonic()
        last: Optional[WireError] = None
        for attempt in range(self.retries + 1):
            if attempt:
                self.retried += 1
                FABRIC_RETRIES_TOTAL.inc(op=op)
                # bounded backoff; on the prefixd restore path the caller
                # holds the store lock by the same design as the local
                # disk read (the sessioned caller waits on this restore)
                time.sleep(min(1.0, self.backoff_ms
                               * (1 << (attempt - 1)) / 1000.0))
            d = CHAOS.fire("fabric.send", replica=self.peer_name)
            frame = wire.encode_frame(msg_type, payload)
            if d is not None:
                if d.kind == "drop":
                    last = TransportError(
                        f"chaos-injected link drop to {self.peer_name!r}")
                    continue
                if d.kind == "corrupt":
                    frame = _flip_byte(frame)
            try:
                rtype, rpayload = self._roundtrip(frame, timeout)
            except TransportError as e:
                last = e
                continue
            if rtype == MSG_ERROR:
                try:
                    wire.raise_remote_error(rpayload)
                except WireError as e:
                    if e.reason not in RETRYABLE_REASONS:
                        self.errors += 1
                        FABRIC_REQUESTS_TOTAL.inc(op=op, status="error")
                        raise
                    last = e
                    continue
            self.requests += 1
            FABRIC_REQUESTS_TOTAL.inc(op=op, status="ok")
            FABRIC_RTT_MS.observe((time.monotonic() - t0) * 1000, op=op)
            # liveness heartbeat: completed wire frames (a frozen counter
            # under serving traffic means the link, not the device, is
            # the wedge)
            introspect.beat("wire.frames")
            return rtype, rpayload
        self.errors += 1
        FABRIC_REQUESTS_TOTAL.inc(op=op, status="unreachable")
        raise TransportError(
            f"peer {self.peer_name!r} unreachable after "
            f"{self.retries + 1} attempt(s): {last}",
            detail={"attempts": self.retries + 1, "op": op,
                    "last_reason": getattr(last, "reason", None)})

    def stats(self) -> dict:
        return {"peer": self.peer_name, "requests": self.requests,
                "errors": self.errors, "retried": self.retried}


class LoopbackTransport(Transport):
    """A peer handler invoked through the FULL wire codec, no socket. The
    handler is the ``fn(msg_type, payload) -> (rtype, rpayload)`` a
    :class:`PeerServer` dispatches to, so loopback and TCP run the same
    peer code on either side of the same bytes."""

    def __init__(self, handler: Callable[[int, bytes], tuple],
                 peer_name: str = "loopback", **kw):
        super().__init__(peer_name, **kw)
        self._handler = handler

    def _roundtrip(self, frame: bytes,
                   timeout: Optional[float]) -> tuple[int, bytes]:
        # server side: decode (the crc/truncation boundary), dispatch,
        # encode, as PeerServer._serve_conn does
        try:
            msg_type, payload = wire.decode_frame(frame)
        except WireError as e:
            _note_frame_reject(self.peer_name, e.reason)
            resp = wire.encode_frame(
                MSG_ERROR, wire.error_payload(str(e), reason=e.reason))
            return wire.decode_frame(resp)
        try:
            rtype, rpayload = self._handler(msg_type, payload)
        except Exception as e:            # noqa: BLE001 — peer boundary
            rtype, rpayload = MSG_ERROR, _exception_payload(e)
        return wire.decode_frame(wire.encode_frame(rtype, rpayload))


def _recv_exact(sock: socket.socket, n: int, who: str) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise WireError(f"{who} closed mid-frame ({len(buf)}/{n} "
                            f"bytes)", reason="truncated")
        buf.extend(chunk)
    return bytes(buf)


class TcpTransport(Transport):
    """One TCP connection to one peer, one request in flight at a time
    (the transport lock is COARSE by declaration: serializing wire I/O is
    its purpose). Reconnects per retry; every socket operation carries a
    deadline."""

    def __init__(self, host: str, port: int, peer_name: Optional[str] = None,
                 *, connect_timeout: float = 2.0, io_timeout: float = 30.0,
                 **kw):
        super().__init__(peer_name or f"{host}:{port}", **kw)
        self.host = host
        self.port = int(port)
        self.connect_timeout = float(connect_timeout)
        self.io_timeout = float(io_timeout)
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        try:
            s = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout)
        except OSError as e:
            raise TransportError(
                f"connect to {self.peer_name!r} failed: {e}") from None
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _roundtrip(self, frame: bytes,
                   timeout: Optional[float]) -> tuple[int, bytes]:
        from quoracle_tpu_torch.infra.telemetry import FABRIC_BYTES_TOTAL
        with self._lock:
            try:
                if self._sock is None:
                    self._sock = self._connect()
                s = self._sock
                s.settimeout(timeout if timeout is not None
                             else self.io_timeout)
                s.sendall(frame)
                rtype, rpayload = wire.read_frame(
                    lambda n: _recv_exact(s, n, f"peer {self.peer_name!r}"))
            except (OSError, WireError) as e:
                self._drop_conn()
                if isinstance(e, WireError) \
                        and e.reason not in RETRYABLE_REASONS:
                    raise
                if isinstance(e, TransportError):
                    raise
                raise TransportError(
                    f"I/O with peer {self.peer_name!r} failed: "
                    f"{e}") from None
            FABRIC_BYTES_TOTAL.inc(len(frame), direction="sent")
            FABRIC_BYTES_TOTAL.inc(wire.HEADER_BYTES + len(rpayload),
                                   direction="received")
            return rtype, rpayload

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._drop_conn()


def _exception_payload(e: Exception) -> bytes:
    """Structured MSG_ERROR payload for a handler exception. Admission
    rejects keep their class and retry hint."""
    from quoracle_tpu_torch.serving.admission import AdmissionError
    if isinstance(e, AdmissionError):
        return wire.error_payload(
            str(e), reason=e.reason, error_type="admission",
            retry_after_ms=e.retry_after_ms, tenant=e.tenant)
    if isinstance(e, WireError):
        return wire.error_payload(str(e), reason=e.reason)
    return wire.error_payload(repr(e), reason="remote",
                              error_type=type(e).__name__)


def _note_frame_reject(peer: str, reason: str) -> None:
    from quoracle_tpu_torch.infra.flightrec import FLIGHT
    from quoracle_tpu_torch.infra.telemetry import (
        FABRIC_FRAME_REJECTS_TOTAL,
    )
    FABRIC_FRAME_REJECTS_TOTAL.inc(reason=reason)
    FLIGHT.record("fabric_frame_reject", peer=peer, reason=reason)


class PeerServer:
    """Threaded TCP acceptor for one peer: each connection gets a reader
    thread that loops read-frame, dispatch, write-frame. Frame-level
    rejects answer MSG_ERROR with the structured reason (the client's
    retry loop decides what is transient); handler exceptions answer
    their structured payloads. ``handler`` is the one a LoopbackTransport
    takes. ``port=0`` binds a free port; :attr:`addr` reads it back."""

    def __init__(self, handler: Callable[[int, bytes], tuple],
                 host: str = "127.0.0.1", port: int = 0,
                 io_timeout: float = 60.0, name: str = "fabric-peer"):
        self._handler = handler
        self.io_timeout = float(io_timeout)
        self.name = name
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, port))
            self._sock.listen(16)
        except OSError:
            self._sock.close()
            raise
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: dict = {}            # thread -> socket, live ones
        self._conns_lock = threading.Lock()   # leaf: the table only
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"{name}-accept")
        self._accept_thread.start()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name=f"{self.name}-conn")
            with self._conns_lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns[t] = conn
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(self.io_timeout)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                try:
                    msg_type, payload = wire.read_frame(
                        lambda n: _recv_exact(conn, n, "client"))
                except WireError as e:
                    if e.reason == "truncated":
                        return            # clean close / torn stream
                    _note_frame_reject(self.name, e.reason)
                    conn.sendall(wire.encode_frame(
                        MSG_ERROR,
                        wire.error_payload(str(e), reason=e.reason)))
                    continue
                try:
                    rtype, rpayload = self._handler(msg_type, payload)
                except Exception as e:    # noqa: BLE001 — peer boundary
                    rtype, rpayload = MSG_ERROR, _exception_payload(e)
                conn.sendall(wire.encode_frame(rtype, rpayload))
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conns_lock:
                self._conns.pop(threading.current_thread(), None)

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting, shut every live connection down and join the
        threads (each join bounded by ``timeout``). A connection thread
        in the middle of a request finishes its handler first."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=timeout)
        with self._conns_lock:
            live = list(self._conns.items())
        for _, conn in live:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        deadline = time.monotonic() + timeout
        for t, _ in live:
            t.join(timeout=max(0.0, deadline - time.monotonic()))


def parse_addr(spec: str) -> tuple[Optional[str], str, int]:
    """Parse ``[role@]host:port`` (the --fabric-listen/--fabric-peers
    syntax). Returns (role | None, host, port)."""
    role = None
    rest = spec
    if "@" in spec:
        role, rest = spec.split("@", 1)
        role = role.strip() or None
    host, sep, port = rest.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"fabric address {spec!r} is not [role@]host:port")
    return role, host, int(port)
