"""Wire codec of the cluster fabric (port of
``quoracle_tpu/serving/fabric/wire.py``).

Every byte that crosses a replica boundary rides ONE frame format:

  ============  =======  ====================================
  field         size     meaning
  ============  =======  ====================================
  magic         2        ``b"QW"``: reject foreign streams
  version       1        :data:`WIRE_VERSION`; a mismatch is a
                         structured reject, never a guess
  msg_type      1        :data:`MSG_*` opcode
  length        4 (BE)   payload byte count, bounded by
                         :data:`MAX_FRAME_BYTES` before any
                         allocation
  crc32         4 (BE)   crc32 of the payload: a flipped byte
                         is a structured ``crc`` reject
  payload       length   opcode-specific
  ============  =======  ====================================

Truncated, bit-flipped, version-skewed or oversized frames raise
:class:`WireError` with a machine-readable ``reason``; never a hang,
never a partial message adopted.

The HandoffEnvelope blob is the one KV-bearing payload. Its layout,
``u32 header_len | header JSON | K bytes | V bytes`` (int8 entries: then
the fp32 K and V scale bytes), lets the KV signature be checked on the
HEADER before a single page byte is parsed (:func:`decode_envelope` with
``expect_signature``): a version-skewed replica pair degrades to a cold
re-prefill, never adopts foreign KV.

The bytes are the JAX package's, header keys, their order and the dtype
names included, so either package decodes the other's frames. The JAX
codec resolves ``bfloat16`` through ``ml_dtypes``; here K and V are the
tier's CPU torch tensors (serving/kvtier.py), and every dtype, bf16
included, travels as raw bytes with its name (``kvtier.dtype_name``) and
shape, as the disk format does.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Optional

import numpy as np
import torch

WIRE_MAGIC = b"QW"
WIRE_VERSION = 1
# Hard bound on one frame: a length prefix past it is rejected before
# allocation (an attacker-sized prefix must not exhaust the peer).
MAX_FRAME_BYTES = 256 * (1 << 20)

_HEADER = struct.Struct("!2sBBII")
HEADER_BYTES = _HEADER.size

# -- opcodes -----------------------------------------------------------------
MSG_ERROR = 0            # JSON {"error", "reason", ...extras}
MSG_HELLO = 1            # JSON {} -> {"replica_id", "role", "pool", ...}
MSG_OK = 2               # JSON ack
MSG_SERVE = 10           # JSON QueryRequest -> MSG_RESULT
MSG_RESULT = 11          # JSON QueryResult
MSG_PREFILL = 12         # JSON QueryRequest + handoff id -> MSG_PREFILLED
MSG_PREFILLED = 13       # blob: {meta JSON} + envelope bytes
MSG_DECODE = 14          # blob: {row meta JSON} + envelope bytes
MSG_DECODED = 15         # JSON result
MSG_SIGNALS_POLL = 16    # JSON {"max_age_s"} -> MSG_SIGNALS
MSG_SIGNALS = 17         # JSON SignalSnapshot + {"age_s", "qos"}
MSG_ADMIT = 18           # JSON {"tenant", "priority", "deadline_s"}
MSG_ADMITTED = 19        # JSON {"priority"}
MSG_STATS = 20           # JSON {} -> JSON stats
MSG_DROP_SESSION = 22    # JSON {"session_id"} -> MSG_OK
MSG_EMBED = 24           # JSON {"texts"} -> MSG_EMBEDDED blob
MSG_EMBEDDED = 25        # blob: {dtype, shape} + bytes
MSG_META = 26            # JSON {"op", ...} -> MSG_OK (tokens/window/...)
MSG_PREFIX_GET = 30      # JSON {signature, key, tokens} -> HIT | MISS
MSG_PREFIX_HIT = 31      # blob: {dtype, shape} + K bytes + V bytes
MSG_PREFIX_MISS = 32     # JSON {}
MSG_PREFIX_PUT = 33      # blob: {signature, key, tokens, dtype, shape}+K+V
MSG_PREFIX_STATS = 34    # JSON {} -> JSON per-signature store stats
MSG_OBS = 40             # JSON {"op": metrics|spans|incident, ...}
MSG_OBS_RESULT = 41      # JSON op-specific (fleet observability)

# metric label per opcode (quoracle_fabric_requests_total / _rtt_ms)
OP_NAMES: dict = {
    MSG_ERROR: "error", MSG_HELLO: "hello", MSG_OK: "ok",
    MSG_SERVE: "serve", MSG_RESULT: "serve",
    MSG_PREFILL: "prefill", MSG_PREFILLED: "prefill",
    MSG_DECODE: "decode", MSG_DECODED: "decode",
    MSG_SIGNALS_POLL: "signals", MSG_SIGNALS: "signals",
    MSG_ADMIT: "admit", MSG_ADMITTED: "admit",
    MSG_STATS: "stats", MSG_DROP_SESSION: "drop_session",
    MSG_EMBED: "embed", MSG_EMBEDDED: "embed", MSG_META: "meta",
    MSG_PREFIX_GET: "prefix_get", MSG_PREFIX_HIT: "prefix_get",
    MSG_PREFIX_MISS: "prefix_get", MSG_PREFIX_PUT: "prefix_put",
    MSG_PREFIX_STATS: "prefix_stats",
    MSG_OBS: "obs", MSG_OBS_RESULT: "obs",
}


def op_name(msg_type: int) -> str:
    return OP_NAMES.get(msg_type, f"op{msg_type}")


class WireError(RuntimeError):
    """A frame or payload the codec refuses. ``reason`` is the
    machine-readable taxonomy every caller branches on:

    * ``magic`` / ``version`` / ``oversize`` / ``truncated`` / ``crc``:
      frame-level rejects;
    * ``decode``: a valid frame whose payload does not parse;
    * ``signature``: a HandoffEnvelope whose KV signature does not match
      the adopting engine (rejected before page bytes);
    * ``remote``: the peer answered MSG_ERROR (its reason rides in
      ``detail``);
    * ``transport``: see :class:`TransportError`.
    """

    def __init__(self, message: str, reason: str = "decode",
                 detail: Optional[dict] = None):
        super().__init__(message)
        self.reason = reason
        self.detail = detail or {}


class TransportError(WireError):
    """The peer could not be reached (a connect, read or write deadline,
    or a refused connection) after the transport's bounded retries.
    Callers degrade as for an in-process replica death: cold re-prefill,
    worst-rank placement, mark-failed."""

    def __init__(self, message: str, detail: Optional[dict] = None):
        super().__init__(message, reason="transport", detail=detail)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------


def encode_frame(msg_type: int, payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME_BYTES:
        raise WireError(
            f"payload {len(payload)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte frame bound", reason="oversize")
    return _HEADER.pack(WIRE_MAGIC, WIRE_VERSION, msg_type & 0xFF,
                        len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF) + payload


def decode_header(header: bytes) -> tuple[int, int, int]:
    """Validate one 12-byte header; returns (msg_type, length, crc).
    Magic, then version, then the length bound: each a distinct
    structured reject before any payload is read."""
    if len(header) < HEADER_BYTES:
        raise WireError(
            f"frame header truncated: {len(header)} < {HEADER_BYTES} "
            f"bytes", reason="truncated")
    magic, version, msg_type, length, crc = _HEADER.unpack(
        header[:HEADER_BYTES])
    if magic != WIRE_MAGIC:
        raise WireError(f"bad frame magic {magic!r}", reason="magic")
    if version != WIRE_VERSION:
        raise WireError(
            f"wire version {version} != {WIRE_VERSION} — version-skewed "
            f"peer", reason="version")
    if length > MAX_FRAME_BYTES:
        raise WireError(
            f"length prefix {length} exceeds the {MAX_FRAME_BYTES}-byte "
            f"frame bound", reason="oversize")
    return msg_type, length, crc


def decode_frame(data: bytes) -> tuple[int, bytes]:
    """Decode one whole frame from a buffer (the loopback path; sockets
    use :func:`read_frame`). Trailing bytes are a reject."""
    msg_type, length, crc = decode_header(data)
    payload = data[HEADER_BYTES:]
    if len(payload) != length:
        raise WireError(
            f"frame payload truncated/overlong: {len(payload)} != "
            f"declared {length}", reason="truncated")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise WireError("frame crc mismatch — corrupt payload",
                        reason="crc")
    return msg_type, bytes(payload)


def read_frame(read_exact) -> tuple[int, bytes]:
    """Read one frame through ``read_exact(n) -> bytes``, which raises
    :class:`WireError` ``truncated`` on a short read."""
    msg_type, length, crc = decode_header(read_exact(HEADER_BYTES))
    payload = read_exact(length)
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise WireError("frame crc mismatch — corrupt payload",
                        reason="crc")
    return msg_type, payload


# ---------------------------------------------------------------------------
# JSON control payloads
# ---------------------------------------------------------------------------


def encode_json(obj: Any) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


def decode_json(payload: bytes) -> Any:
    try:
        return json.loads(payload.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise WireError(f"payload is not valid JSON: {e}",
                        reason="decode") from None


def error_payload(message: str, reason: str = "remote",
                  **extras: Any) -> bytes:
    return encode_json({"error": message, "reason": reason, **extras})


def raise_remote_error(payload: bytes) -> None:
    """Turn a MSG_ERROR payload back into the structured exception the
    peer raised. Admission rejects come back as the AdmissionError
    subclasses, so the front door's aggregate shed treats a remote shed
    as a local one."""
    info = decode_json(payload)
    reason = info.get("reason", "remote")
    msg = info.get("error", "remote peer error")
    if info.get("error_type") == "admission":
        from quoracle_tpu_torch.serving.admission import (
            AdmissionError, DeadlineExceededError, OverloadedError,
            RateLimitedError,
        )
        cls = {"overload": OverloadedError,
               "rate_limit": RateLimitedError,
               "deadline": DeadlineExceededError}.get(reason,
                                                      AdmissionError)
        if cls is DeadlineExceededError:
            raise cls(msg)
        raise cls(msg, retry_after_ms=int(info.get("retry_after_ms",
                                                   1000)))
    raise WireError(msg, reason=reason, detail=info)


# ---------------------------------------------------------------------------
# Blobs: JSON header + raw byte sections
# ---------------------------------------------------------------------------


def pack_blob(header: dict, *chunks: bytes) -> bytes:
    h = encode_json(header)
    return struct.pack("!I", len(h)) + h + b"".join(chunks)


def unpack_blob(payload: bytes) -> tuple[dict, memoryview]:
    """Parse the header without touching the byte sections: the
    signature gate reads only this; the body stays an unparsed view."""
    if len(payload) < 4:
        raise WireError("blob truncated before header length",
                        reason="truncated")
    (hlen,) = struct.unpack("!I", payload[:4])
    if len(payload) < 4 + hlen:
        raise WireError(
            f"blob header truncated: {len(payload) - 4} < {hlen}",
            reason="truncated")
    header = decode_json(bytes(payload[4:4 + hlen]))
    if not isinstance(header, dict):
        raise WireError("blob header is not an object", reason="decode")
    return header, memoryview(payload)[4 + hlen:]


def dtype_of(name: str) -> torch.dtype:
    """A dtype name on the wire (``float32``, ``bfloat16``, ``int8``...)
    as a torch dtype; an unknown name is a ``decode`` reject."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise WireError(f"unknown dtype {name!r} on the wire",
                        reason="decode")
    return dt


def tensor_bytes(t: torch.Tensor) -> bytes:
    """A tensor's raw bytes, C order (bf16 included)."""
    return t.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy().tobytes()


def tensor_from(view, dtype: torch.dtype, shape) -> torch.Tensor:
    """The first ``prod(shape)`` elements of ``view`` as a new CPU tensor
    of ``dtype``; a short view is a ``truncated`` reject."""
    shape = tuple(int(s) for s in shape)
    want = int(np.prod(shape, dtype=np.int64)) \
        * torch.empty((), dtype=dtype).element_size()
    if len(view) < want:
        raise WireError(
            f"KV section truncated: {len(view)} < {want} bytes",
            reason="truncated")
    raw = np.frombuffer(view[:want], dtype=np.uint8).copy()
    return torch.from_numpy(raw).view(dtype).reshape(shape)


def kv_sections(k: torch.Tensor, v: torch.Tensor,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None) -> tuple:
    """The header fields and byte sections of one K/V entry:
    ``({"dtype", "k_shape", "v_shape"[, "quant", "scale_shape"]},
    [K, V(, K scales, V scales)])``; int8 entries append their fp32
    scales and stamp the quant format in the header."""
    from quoracle_tpu_torch.serving.kvtier import dtype_name
    header = {"dtype": dtype_name(k.dtype), "k_shape": list(k.shape),
              "v_shape": list(v.shape)}
    chunks = [tensor_bytes(k), tensor_bytes(v)]
    if k_scale is not None:
        ks, vs = k_scale.float(), v_scale.float()
        header["quant"] = "q8kv"
        header["scale_shape"] = list(ks.shape)
        chunks += [tensor_bytes(ks), tensor_bytes(vs)]
    return header, chunks


def read_kv(header: dict, body) -> tuple:
    """``(k, v, k_scale, v_scale, nbytes)`` from a blob body laid out by
    :func:`kv_sections` (scales None for float entries); ``nbytes`` is
    the bytes the sections took."""
    dt = dtype_of(header["dtype"])
    k = tensor_from(body, dt, header["k_shape"])
    off = k.nbytes
    v = tensor_from(body[off:], dt, header["v_shape"])
    off += v.nbytes
    ks = vs = None
    if header.get("quant") == "q8kv":
        sshape = tuple(int(s) for s in header.get("scale_shape") or ())
        if not sshape:
            raise WireError("quantized envelope missing scale_shape",
                            reason="decode")
        ks = tensor_from(body[off:], torch.float32, sshape)
        off += ks.nbytes
        vs = tensor_from(body[off:], torch.float32, sshape)
        off += vs.nbytes
    return k, v, ks, vs, off


# ---------------------------------------------------------------------------
# The HandoffEnvelope blob
# ---------------------------------------------------------------------------


def encode_envelope(env) -> bytes:
    """Serialize a serving/handoff.HandoffEnvelope (``entry`` is the
    tier's host-side ``_HostSession``): K and V as raw bytes with dtype
    name and shapes, int8 entries' fp32 scales as two more sections. The
    trace and tree contexts ride the header; a peer that does not know
    them skips unknown header keys."""
    e = env.entry
    header = {
        "session_id": env.session_id,
        "model_spec": env.model_spec,
        "signature": env.signature,
        "json_state": env.json_state,
        "src_replica": env.src_replica,
        "start_pos": int(e.start_pos),
        "tokens": [int(t) for t in e.tokens],
    }
    kv, chunks = kv_sections(e.k, e.v, getattr(e, "k_scale", None),
                             getattr(e, "v_scale", None))
    header.update({k: kv[k] for k in ("dtype", "k_shape", "v_shape")})
    if getattr(env, "trace", None):
        header["trace"] = dict(env.trace)
    if getattr(env, "tree", None):
        header["tree"] = dict(env.tree)
    if "quant" in kv:
        header["quant"] = kv["quant"]
        header["scale_shape"] = kv["scale_shape"]
    return pack_blob(header, *chunks)


def peek_envelope(payload: bytes) -> dict:
    """The envelope HEADER alone (signature, session, token count), with
    no KV byte parsed. The adopt gate reads this first."""
    header, _ = unpack_blob(payload)
    for field in ("session_id", "model_spec", "signature", "tokens",
                  "dtype", "k_shape", "v_shape"):
        if field not in header:
            raise WireError(f"envelope header missing {field!r}",
                            reason="decode")
    return header


def decode_envelope(payload: bytes, expect_signature: Optional[str] = None):
    """Rebuild the HandoffEnvelope. With ``expect_signature`` the KV
    signature in the HEADER is checked first, and a mismatch raises
    ``WireError(reason="signature")`` before any page byte is parsed.
    Optional byte sections a newer peer declares in ``"ext": [[name,
    nbytes], ...]`` are skipped; only an undeclared length mismatch
    rejects."""
    header = peek_envelope(payload)
    if expect_signature is not None \
            and header["signature"] != expect_signature:
        raise WireError(
            f"KV signature mismatch: envelope carries "
            f"{header['signature']!r}, engine expects "
            f"{expect_signature!r} — version-skewed replica pair",
            reason="signature")
    _, body = unpack_blob(payload)
    k, v, ks, vs, off = read_kv(header, body)
    for ext in header.get("ext") or ():
        try:
            _, nbytes = ext[0], int(ext[1])
        except (TypeError, ValueError, IndexError):
            raise WireError("malformed ext-section declaration",
                            reason="decode") from None
        if nbytes < 0 or len(body) - off < nbytes:
            raise WireError(
                f"ext section truncated: {len(body) - off} < {nbytes}",
                reason="truncated")
        off += nbytes
    if len(body) != off:
        raise WireError(
            f"envelope body {len(body)} bytes != declared {off}",
            reason="truncated")
    from quoracle_tpu_torch.serving.handoff import HandoffEnvelope
    from quoracle_tpu_torch.serving.kvtier import _HostSession
    entry = _HostSession(list(header["tokens"]), int(header["start_pos"]),
                         k, v, ks, vs)
    return HandoffEnvelope(
        session_id=header["session_id"],
        model_spec=header["model_spec"],
        signature=header["signature"],
        entry=entry,
        json_state=header.get("json_state"),
        src_replica=header.get("src_replica", ""),
        trace=header.get("trace") if isinstance(header.get("trace"),
                                                dict) else None,
        tree=header.get("tree") if isinstance(header.get("tree"),
                                              dict) else None)


# ---------------------------------------------------------------------------
# QueryRequest / QueryResult JSON codecs
# ---------------------------------------------------------------------------


def request_to_dict(r) -> dict:
    """A QueryRequest as a wire dict, the JAX package's keys. Deadlines
    ship as REMAINING ms: monotonic times do not cross processes. The
    port's chip-ms attribution keys (``task_id``, ``decide``) stay in
    the calling process."""
    return {
        "model_spec": r.model_spec,
        "messages": r.messages,
        "temperature": r.temperature,
        "top_p": r.top_p,
        "max_tokens": r.max_tokens,
        "session_id": r.session_id,
        "constrain_json": r.constrain_json,
        "action_enum": list(r.action_enum) if r.action_enum else None,
        "tenant": r.tenant,
        "priority": r.priority,
        "deadline_ms": r.deadline_ms,
        "trace": r.trace,
        "tree": r.tree,
    }


def request_from_dict(d: dict):
    from quoracle_tpu_torch.models.runtime import QueryRequest
    ae = d.get("action_enum")
    return QueryRequest(
        model_spec=d["model_spec"], messages=d["messages"],
        temperature=d.get("temperature", 1.0),
        top_p=d.get("top_p", 1.0), max_tokens=d.get("max_tokens"),
        session_id=d.get("session_id"),
        constrain_json=bool(d.get("constrain_json")),
        action_enum=tuple(ae) if ae else None,
        tenant=d.get("tenant", "default"), priority=d.get("priority"),
        deadline_ms=d.get("deadline_ms"),
        trace=d.get("trace") if isinstance(d.get("trace"), dict)
        else None,
        tree=d.get("tree") if isinstance(d.get("tree"), dict)
        else None)


def result_to_dict(res) -> dict:
    """A QueryResult as a wire dict, the JAX package's keys (the port's
    ``chip_ms`` is booked where the row ran)."""
    return {
        "model_spec": res.model_spec,
        "text": res.text,
        "usage": {"prompt_tokens": res.usage.prompt_tokens,
                  "completion_tokens": res.usage.completion_tokens,
                  "cost": res.usage.cost},
        "latency_ms": res.latency_ms,
        "prefill_ms": res.prefill_ms,
        "decode_ms": res.decode_ms,
        "cached_tokens": res.cached_tokens,
        "spec_rounds": res.spec_rounds,
        "spec_accepted_tokens": res.spec_accepted_tokens,
        "error": res.error,
        "permanent_error": res.permanent_error,
    }


def result_from_dict(d: dict):
    from quoracle_tpu_torch.models.runtime import QueryResult, Usage
    u = d.get("usage") or {}
    return QueryResult(
        model_spec=d["model_spec"], text=d.get("text", ""),
        usage=Usage(u.get("prompt_tokens", 0),
                    u.get("completion_tokens", 0), u.get("cost", 0.0)),
        latency_ms=d.get("latency_ms", 0.0),
        prefill_ms=d.get("prefill_ms", 0.0),
        decode_ms=d.get("decode_ms", 0.0),
        cached_tokens=d.get("cached_tokens", 0),
        spec_rounds=d.get("spec_rounds", 0),
        spec_accepted_tokens=d.get("spec_accepted_tokens", 0),
        error=d.get("error"),
        permanent_error=bool(d.get("permanent_error")))
