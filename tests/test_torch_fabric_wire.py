"""The port's fabric wire codec and transports (serving/fabric/wire.py,
transport.py) against the JAX package's, on the CPU.

Every case of tests/test_fabric_wire.py, run on both packages: hostile
frames (truncated, bit-flipped, version-skewed, oversized, bad magic)
reject with the same structured reasons, the envelope codec gates on the
signature before any KV byte, and the loopback and TCP transports retry,
time out and reconnect alike. Beyond those cases, the bytes themselves:
a frame, a HandoffEnvelope (fp32, bf16 and int8 with its scales), a
prefix-service blob and a request or result encode to the SAME bytes in
both packages, and each package decodes the other's.

Real sockets bind 127.0.0.1 on port 0 (read back from the server), every
server and transport closes in a ``finally``, and every server's threads
carry the test's name.
"""

import socket
import struct
import time
import zlib
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

from quoracle_tpu.chaos import faults as jfaults
from quoracle_tpu.infra import telemetry as jtel
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.serving import admission as jadm
from quoracle_tpu.serving import handoff as jho
from quoracle_tpu.serving import kvtier as jkv
from quoracle_tpu.serving.fabric import prefixd as jpd
from quoracle_tpu.serving.fabric import transport as jtr
from quoracle_tpu.serving.fabric import wire as jwire
from quoracle_tpu_torch.chaos import faults as tfaults
from quoracle_tpu_torch.infra import telemetry as ttel
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.serving import admission as tadm
from quoracle_tpu_torch.serving import handoff as tho
from quoracle_tpu_torch.serving import kvtier as tkv
from quoracle_tpu_torch.serving.fabric import prefixd as tpd
from quoracle_tpu_torch.serving.fabric import transport as ttr
from quoracle_tpu_torch.serving.fabric import wire as twire

JAX = SimpleNamespace(name="jax", wire=jwire, tr=jtr, faults=jfaults,
                      tel=jtel, rt=jrt, adm=jadm, ho=jho, kv=jkv, pd=jpd)
PORT = SimpleNamespace(name="port", wire=twire, tr=ttr, faults=tfaults,
                       tel=ttel, rt=trt, adm=tadm, ho=tho, kv=tkv, pd=tpd)
SIDES = (JAX, PORT)


def both(case, *args) -> list:
    """Run ``case`` on each package; the observations must be equal."""
    jobs, tobs = (case(side, *args) for side in SIDES)
    assert tobs == jobs
    return tobs


def reason_of(fn) -> str:
    with pytest.raises(Exception) as ei:
        fn()
    return getattr(ei.value, "reason", type(ei.value).__name__)


# ---------------------------------------------------------------------------
# Frame round trips + hostile inputs
# ---------------------------------------------------------------------------

def test_frame_round_trip_property():
    def case(side):
        W = side.wire
        rng = np.random.default_rng(7)
        frames = []
        for msg_type in list(W.OP_NAMES) + [200, 255]:
            for n in (0, 1, 2, 11, 12, 13, 255, 4096, 70_001):
                payload = rng.integers(0, 256, n, np.uint8).tobytes()
                frame = W.encode_frame(msg_type, payload)
                t, p = W.decode_frame(frame)
                assert t == msg_type and p == payload
                frames.append(zlib.crc32(frame))
        return frames
    both(case)


def test_truncated_frames_reject_structurally():
    def case(side):
        W = side.wire
        frame = W.encode_frame(W.MSG_SERVE, b"x" * 64)
        out = [reason_of(lambda c=cut: W.decode_frame(frame[:c]))
               for cut in (0, 1, W.HEADER_BYTES - 1, W.HEADER_BYTES,
                           W.HEADER_BYTES + 5, len(frame) - 1)]
        out.append(reason_of(lambda: W.decode_frame(frame + b"!")))
        assert set(out) == {"truncated"}
        return out
    both(case)


def test_flipped_byte_anywhere_is_a_crc_reject():
    def case(side):
        W = side.wire
        frame = W.encode_frame(W.MSG_RESULT, b"the quick brown fabric frame")
        out = []
        for i in range(W.HEADER_BYTES, len(frame)):
            bad = frame[:i] + bytes([frame[i] ^ 0x01]) + frame[i + 1:]
            out.append(reason_of(lambda b=bad: W.decode_frame(b)))
        assert set(out) == {"crc"}
        return out
    both(case)


def test_wrong_version_and_magic_reject():
    def case(side):
        W = side.wire
        frame = W.encode_frame(W.MSG_OK, b"{}")
        skew = frame[:2] + bytes([W.WIRE_VERSION + 1]) + frame[3:]
        out = [reason_of(lambda: W.decode_frame(skew)),
               reason_of(lambda: W.decode_frame(b"XX" + frame[2:]))]
        assert out == ["version", "magic"]
        return out
    both(case)


def test_oversized_length_prefix_rejects_before_allocation():
    def case(side):
        W = side.wire
        hdr = struct.pack("!2sBBII", W.WIRE_MAGIC, W.WIRE_VERSION,
                          W.MSG_SERVE, W.MAX_FRAME_BYTES + 1,
                          zlib.crc32(b""))
        out = [reason_of(lambda: W.decode_header(hdr)),
               reason_of(lambda: W.encode_frame(
                   W.MSG_SERVE, b"\x00" * (W.MAX_FRAME_BYTES + 1)))]
        calls = []

        def read_exact(n):
            calls.append(n)
            return hdr[:n]
        out.append(reason_of(lambda: W.read_frame(read_exact)))
        assert calls == [W.HEADER_BYTES]   # payload never requested
        assert out == ["oversize"] * 3
        return [out, W.MAX_FRAME_BYTES, W.HEADER_BYTES]
    both(case)


def test_bad_json_payload_is_a_decode_reject():
    def case(side):
        return reason_of(lambda: side.wire.decode_json(b"\xff{not json"))
    assert both(case) == "decode"


# ---------------------------------------------------------------------------
# Envelopes: the same bytes in both packages
# ---------------------------------------------------------------------------

def _kv_arrays(dtype: str, seed: int = 3) -> dict:
    """Seeded K/V (and int8 scales) as numpy arrays of ``dtype``: float32,
    bfloat16 (ml_dtypes, the JAX tier's host dtype) or int8."""
    rng = np.random.default_rng(seed)
    shape = (2, 3, 8, 2, 4)
    if dtype == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        sshape = (2, 3, 2, 8)
        return {"k": k, "v": v,
                "ks": rng.random(sshape).astype(np.float32),
                "vs": rng.random(sshape).astype(np.float32)}
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return {"k": rng.standard_normal(shape).astype(np_dt),
            "v": rng.standard_normal(shape).astype(np_dt),
            "ks": None, "vs": None}


def _as_side(side, a):
    """A numpy array as ``side``'s host KV: numpy for JAX, a CPU tensor of
    the same bytes for the port (bf16 through its raw bytes)."""
    if a is None or side is JAX:
        return a
    name = "bfloat16" if a.dtype == ml_dtypes.bfloat16 else str(a.dtype)
    raw = torch.from_numpy(np.ascontiguousarray(a).view(np.uint8).copy())
    return raw.view(getattr(torch, name)).reshape(a.shape)


def _raw(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _envelope(side, dtype="float32", trace=None, tree=None):
    a = _kv_arrays(dtype)
    entry = side.kv._HostSession(
        [1, 2, 3, 4], 0, _as_side(side, a["k"]), _as_side(side, a["v"]),
        _as_side(side, a["ks"]), _as_side(side, a["vs"]))
    return side.ho.HandoffEnvelope(
        session_id="s1", model_spec="xla:tiny", signature="tiny-sig-p128",
        entry=entry, json_state=7, src_replica="prefill-0", trace=trace,
        tree=tree)


def _entry_view(env) -> list:
    e = env.entry
    return [env.session_id, env.model_spec, env.signature, env.json_state,
            env.src_replica, env.trace, env.tree, list(e.tokens),
            int(e.start_pos), str(e.k.dtype).removeprefix("torch."),
            list(e.k.shape)] + [_raw(x) for x in (e.k, e.v, e.k_scale,
                                                  e.v_scale)
                                if x is not None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_envelope_bytes_equal_and_cross_decode(dtype):
    """One envelope, the same bytes from both encoders (header, dtype
    name, KV and scale sections); each package decodes the other's to
    the same entry, bit for bit."""
    ctx = dict(trace={"trace_id": "tr-9", "span_id": "s42"},
               tree={"tree_id": "t1", "node": "n2"})
    jbytes = jwire.encode_envelope(_envelope(JAX, dtype, **ctx))
    tbytes = twire.encode_envelope(_envelope(PORT, dtype, **ctx))
    assert tbytes == jbytes
    header, _ = twire.unpack_blob(tbytes)
    assert header["dtype"] == dtype
    assert ("quant" in header) == (dtype == "int8")
    want = _entry_view(_envelope(JAX, dtype, **ctx))
    from_jax = twire.decode_envelope(jbytes, expect_signature="tiny-sig-p128")
    from_port = jwire.decode_envelope(tbytes,
                                      expect_signature="tiny-sig-p128")
    assert isinstance(from_jax.entry.k, torch.Tensor)
    assert _entry_view(from_jax) == want
    assert _entry_view(from_port) == want
    # the decoded port entry is a tier host entry (its byte count set)
    assert from_jax.entry.nbytes == sum(
        len(_raw(x)) for x in (from_jax.entry.k, from_jax.entry.v,
                               from_jax.entry.k_scale,
                               from_jax.entry.v_scale) if x is not None)


def test_envelope_round_trip_bit_exact():
    def case(side):
        out = []
        for dtype in ("float32", "bfloat16"):
            env = _envelope(side, dtype)
            got = side.wire.decode_envelope(
                side.wire.encode_envelope(env),
                expect_signature=env.signature)
            assert got.entry.k.dtype == env.entry.k.dtype
            assert _entry_view(got) == _entry_view(env)
            out.append(_entry_view(got))
        return out
    both(case)


def test_envelope_unknown_header_keys_and_ext_sections_skipped():
    def case(side):
        W = side.wire
        env = _envelope(side)
        env.trace = {"trace_id": "tr-9", "span_id": "s42"}
        header, body = W.unpack_blob(W.encode_envelope(env))
        assert header["trace"] == env.trace
        future = dict(header)
        future["ext"] = [["qos_hints", 7], ["embedding", 16]]
        future["totally_unknown_key"] = {"nested": [1, 2, 3]}
        out = W.decode_envelope(
            W.pack_blob(future, bytes(body), b"\x01" * 7, b"\x02" * 16),
            expect_signature=env.signature)
        assert _entry_view(out) == _entry_view(env)
        torn = W.pack_blob(future, bytes(body), b"\x01" * 7, b"\x02" * 3)
        bad = dict(header)
        bad["ext"] = [["oops"]]
        reasons = [
            reason_of(lambda: W.decode_envelope(torn)),
            reason_of(lambda: W.decode_envelope(W.pack_blob(bad,
                                                            bytes(body)))),
            reason_of(lambda: W.decode_envelope(W.pack_blob(
                dict(header), bytes(body), b"\x03" * 5)))]
        assert reasons == ["truncated", "decode", "truncated"]
        return [reasons, _entry_view(out)]
    both(case)


def test_mixed_version_loopback_pair_interops():
    def case(side):
        W = side.wire
        got = {}

        def old_peer(msg_type, payload):
            d = W.decode_json(payload)
            got["keys"] = sorted(d)
            r = W.request_from_dict({k: v for k, v in d.items()
                                     if k != "trace"})
            assert r.trace is None
            return W.MSG_OK, W.encode_json({"ok": True})

        t = side.tr.LoopbackTransport(old_peer, "old-peer", retries=0)
        new_req = {"model_spec": "xla:tiny",
                   "messages": [{"role": "user", "content": "hi"}],
                   "trace": {"trace_id": "tr-1", "span_id": "s1"},
                   "future_field": [1, 2, 3]}
        rtype, _ = t.request(W.MSG_SERVE, W.encode_json(new_req))
        assert rtype == W.MSG_OK and "trace" in got["keys"]
        r = W.request_from_dict({"model_spec": "xla:tiny", "messages": []})
        r2 = W.request_from_dict({"model_spec": "xla:tiny",
                                  "messages": [], "trace": "garbage"})
        assert r.trace is None and r2.trace is None
        return got["keys"]
    both(case)


def test_envelope_signature_checked_before_kv_bytes():
    def case(side):
        W = side.wire
        env = _envelope(side)
        blob = W.encode_envelope(env)
        header, _ = W.unpack_blob(blob)
        torn = blob[:4 + len(W.encode_json(header)) + 3]
        out = [reason_of(lambda: W.decode_envelope(
                   torn, expect_signature="other-geometry")),
               reason_of(lambda: W.decode_envelope(
                   torn, expect_signature=env.signature))]
        assert out == ["signature", "truncated"]
        assert W.peek_envelope(blob)["signature"] == env.signature
        return out
    both(case)


def test_prefixd_blobs_equal_across_packages(tmp_path):
    """A block published by each package's PrefixdClient is the same PUT
    blob, and a HIT served by each package's PrefixService from the
    other's store decodes to the same block."""
    sent = {}

    def capture(side):
        def handler(msg_type, payload):
            sent[side.name] = payload
            return side.wire.MSG_OK, side.wire.encode_json({"stored": True})
        return side.tr.LoopbackTransport(handler, "prefixd",
                                         lock_name="fabric.prefixd")

    a = _kv_arrays("int8", seed=5)
    tokens = list(range(16))
    for side in SIDES:
        client = side.pd.PrefixdClient(capture(side), "sig-a")
        assert client.publish("key1", tokens, *(_as_side(side, a[n])
                                                for n in ("k", "v", "ks",
                                                          "vs")))
    assert sent["port"] == sent["jax"]
    # a store written by the JAX service, served by the port's, and back
    jsvc = jpd.PrefixService(str(tmp_path))
    jsvc.handle(jwire.MSG_PREFIX_PUT, sent["jax"])
    tsvc = tpd.PrefixService(str(tmp_path))
    get = jwire.encode_json({"signature": "sig-a", "key": "key1",
                             "tokens": tokens})
    jt, jp = jsvc.handle(jwire.MSG_PREFIX_GET, get)
    tt, tp = tsvc.handle(twire.MSG_PREFIX_GET, get)
    assert (tt, tp) == (jt, jp) and tt == twire.MSG_PREFIX_HIT
    got = tpd.PrefixdClient(ttr.LoopbackTransport(
        tsvc.handle, "prefixd", lock_name="fabric.prefixd"),
        "sig-a").fetch("key1", tokens)
    assert [_raw(x) for x in got] == [_raw(a[n])
                                      for n in ("k", "v", "ks", "vs")]


def test_request_result_bytes_equal_across_packages():
    def enc(side):
        W = side.wire
        r = side.rt.QueryRequest(
            "xla:tiny", [{"role": "user", "content": "hi"}],
            temperature=0.0, max_tokens=9, session_id="s",
            constrain_json=True, action_enum=("a", "b"), tenant="t1",
            priority=2, deadline_ms=1500.0,
            trace={"trace_id": "t", "span_id": "p"})
        res = side.rt.QueryResult("xla:tiny", text="out",
                                  usage=side.rt.Usage(3, 4, 0.5),
                                  cached_tokens=2, spec_rounds=1,
                                  spec_accepted_tokens=3,
                                  error="replica_failed: x")
        return [W.encode_frame(W.MSG_SERVE, W.encode_json(
                    W.request_to_dict(r))),
                W.encode_frame(W.MSG_RESULT, W.encode_json(
                    W.result_to_dict(res)))]
    jframes, tframes = enc(JAX), enc(PORT)
    assert tframes == jframes
    # each package decodes the other's frames to equal requests/results
    for dec, frames, other in ((PORT, jframes, JAX), (JAX, tframes, PORT)):
        _, p = dec.wire.decode_frame(frames[0])
        r = dec.wire.request_from_dict(dec.wire.decode_json(p))
        _, p = dec.wire.decode_frame(frames[1])
        res = dec.wire.result_from_dict(dec.wire.decode_json(p))
        assert (r.model_spec, r.max_tokens, r.action_enum, r.priority,
                r.deadline_ms, r.trace) == ("xla:tiny", 9, ("a", "b"), 2,
                                            1500.0, {"trace_id": "t",
                                                     "span_id": "p"})
        assert (res.text, res.usage.completion_tokens, res.cached_tokens,
                res.error, res.ok) == ("out", 4, 2, "replica_failed: x",
                                       False)


def test_request_result_codec_round_trip():
    def case(side):
        W = side.wire
        r = side.rt.QueryRequest(
            "xla:tiny", [{"role": "user", "content": "hi"}],
            temperature=0.0, max_tokens=9, session_id="s",
            constrain_json=True, action_enum=("a", "b"), tenant="t1",
            priority=2, deadline_ms=1500.0)
        r2 = W.request_from_dict(W.decode_json(W.encode_json(
            W.request_to_dict(r))))
        assert r2 == r
        res = side.rt.QueryResult("xla:tiny", text="out",
                                  usage=side.rt.Usage(3, 4, 0.5),
                                  cached_tokens=2, spec_rounds=1,
                                  spec_accepted_tokens=3)
        d = W.result_from_dict(W.decode_json(W.encode_json(
            W.result_to_dict(res))))
        assert d.text == "out" and d.usage.completion_tokens == 4
        assert d.ok and d.cached_tokens == 2
        return W.request_to_dict(r2)
    both(case)


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

def _echo_handler(side):
    def handler(msg_type, payload):
        if msg_type == side.wire.MSG_META:
            raise side.wire.WireError("no such op", reason="decode")
        if msg_type == side.wire.MSG_ADMIT:
            raise side.adm.OverloadedError("synthetic shed",
                                           retry_after_ms=2345)
        return side.wire.MSG_OK, payload
    return handler


def test_loopback_round_trip_and_remote_errors():
    def case(side):
        W = side.wire
        t = side.tr.LoopbackTransport(_echo_handler(side), "echo")
        rtype, payload = t.request(W.MSG_HELLO, b'{"a":1}')
        assert rtype == W.MSG_OK and payload == b'{"a":1}'
        meta = reason_of(lambda: t.request(W.MSG_META, b"{}"))
        with pytest.raises(side.adm.OverloadedError) as ei:
            t.request(W.MSG_ADMIT, b"{}")
        assert ei.value.retry_after_ms == 2345
        return [meta, ei.value.reason, t.stats()]
    assert both(case)[0] == "decode"


def test_chaos_corrupt_frame_is_absorbed_by_retry():
    def case(side):
        W, FA = side.wire, side.faults
        t = side.tr.LoopbackTransport(_echo_handler(side), "flappy",
                                      retries=2, backoff_ms=1.0)
        plan = FA.FaultPlan(11, [FA.FaultRule("fabric.send", "corrupt",
                                              max_fires=1)])
        with FA.CHAOS.arming(plan):
            rtype, payload = t.request(W.MSG_HELLO, b'{"x":2}')
        assert rtype == W.MSG_OK and payload == b'{"x":2}'
        assert t.retried == 1
        assert "quoracle_fabric_frame_rejects_total" \
            in side.tel.METRICS.render_prometheus()
        return plan.schedule()
    assert both(case) == [("fabric.send", "flappy", 0, "corrupt")]


def test_chaos_persistent_drop_exhausts_retries_structurally():
    def case(side):
        FA = side.faults
        t = side.tr.LoopbackTransport(_echo_handler(side), "dead",
                                      retries=2, backoff_ms=1.0)
        plan = FA.FaultPlan(0, [FA.FaultRule("fabric.send", "drop")])
        with FA.CHAOS.arming(plan):
            with pytest.raises(side.wire.TransportError) as ei:
                t.request(side.wire.MSG_HELLO, b"{}")
        return [ei.value.detail["attempts"], ei.value.reason,
                plan.schedule()]
    assert both(case)[:2] == [3, "transport"]


def test_tcp_transport_round_trip_and_deadlines(request):
    """Real sockets on 127.0.0.1: request/response, a slow handler past
    the read deadline, and the reconnect after it; the server's threads
    are gone once it closes."""
    def case(side):
        W = side.wire
        gate = __import__("threading").Event()

        def handler(msg_type, payload):
            if msg_type == W.MSG_STATS:
                gate.wait(2.0)            # past the 0.1 s deadline below
            return W.MSG_OK, payload

        name = f"{request.node.name}-{side.name}"
        server = side.tr.PeerServer(handler, host="127.0.0.1", port=0,
                                    name=name)
        t = side.tr.TcpTransport(server.host, server.port, retries=0,
                                 io_timeout=5.0)
        try:
            rtype, payload = t.request(W.MSG_HELLO, b'{"hi":1}')
            assert rtype == W.MSG_OK and payload == b'{"hi":1}'
            slow = reason_of(lambda: t.request(W.MSG_STATS, b"{}",
                                               timeout=0.1))
            gate.set()
            rtype, _ = t.request(W.MSG_HELLO, b"{}")
            assert rtype == W.MSG_OK
        finally:
            gate.set()
            t.close()
            server.close()
        return [slow, t.stats()["requests"]]
    assert both(case) == ["transport", 2]
    import threading
    deadline = time.monotonic() + 5.0
    while any(th.name.startswith(request.node.name)
              for th in threading.enumerate()):
        assert time.monotonic() < deadline, "server threads outlived it"
        time.sleep(0.02)


def test_tcp_connect_refused_retries_then_structured():
    """A bound port with no listener refuses the connect (holding the
    bind keeps the port from being reused meanwhile): bounded retries,
    then a structured TransportError."""
    def case(side):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.bind(("127.0.0.1", 0))
            host, port = s.getsockname()[:2]
            t = side.tr.TcpTransport(host, port, retries=1,
                                     backoff_ms=1.0, connect_timeout=0.3)
            t0 = time.monotonic()
            with pytest.raises(side.wire.TransportError) as ei:
                t.request(side.wire.MSG_HELLO, b"{}")
            assert time.monotonic() - t0 < 5.0
            t.close()
        finally:
            s.close()
        return [ei.value.detail["attempts"], ei.value.detail["op"]]
    assert both(case) == [2, "hello"]


def test_tcp_server_rejects_corrupt_frame_and_keeps_serving(request):
    def case(side):
        W = side.wire
        server = side.tr.PeerServer(
            _echo_handler(side), host="127.0.0.1", port=0,
            name=f"{request.node.name}-{side.name}")
        s = None
        try:
            s = socket.create_connection((server.host, server.port),
                                         timeout=5)
            s.settimeout(5)
            frame = bytearray(W.encode_frame(W.MSG_HELLO, b'{"k":1}'))
            frame[-1] ^= 0xFF
            s.sendall(bytes(frame))

            def read_exact(n):
                buf = b""
                while len(buf) < n:
                    chunk = s.recv(n - len(buf))
                    assert chunk, "server closed unexpectedly"
                    buf += chunk
                return buf

            rtype, payload = W.read_frame(read_exact)
            assert rtype == W.MSG_ERROR
            first = W.decode_json(payload)["reason"]
            s.sendall(W.encode_frame(W.MSG_HELLO, b'{"k":2}'))
            rtype, payload = W.read_frame(read_exact)
            assert rtype == W.MSG_OK and payload == b'{"k":2}'
        finally:
            if s is not None:
                s.close()
            server.close()
        return first
    assert both(case) == "crc"


def test_parse_addr():
    def case(side):
        parse = side.tr.parse_addr
        assert reason_of(lambda: parse("nonsense")) == "ValueError"
        return [parse("prefill@10.0.0.2:7001"), parse("localhost:7002")]
    assert both(case) == [("prefill", "10.0.0.2", 7001),
                          (None, "localhost", 7002)]
