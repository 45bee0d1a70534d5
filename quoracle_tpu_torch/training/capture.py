"""Replay capture store: the serving flywheel's intake (port of
``quoracle_tpu/training/capture.py``).

Training examples are captured at two existing seams:

* **speculation** — every :class:`BatchedSpeculator` round already
  computes, per row, the draft chunk, the per-position accept/reject
  verdict, and the target model's grammar-masked argmax at every
  position (the correction stream). That tuple IS a distillation
  example: "given this context, the target says these tokens".
* **consensus** — every decide's audit record carries the winning
  action and its provenance; the capture plane subscribes as a quality
  sink (consensus/quality.py) and keeps a slim projection.

Design rules, in order:

1. **Strictly read-only on the serving path.** The taps copy row state
   after the round's commits; nothing downstream of a capture call can
   change an output bit. ``QUORACLE_TRAIN_CAPTURE=0`` kills the whole
   plane, and the tests hold temp-0 output bit-identical with capture on
   and off.
2. **Never block, never raise.** Every failure — disk full, injected
   fault, serialization surprise — is absorbed: the record drops, a
   counter ticks, and a trip-once ``train_capture_degraded`` flight
   event lands. Chaos point ``train.capture`` fires per batch.
3. **Crash-safe by construction.** Records are crc-framed and appended
   to an in-memory buffer that seals into an immutable segment file
   (write tmp, ``os.replace`` publish, failure unlinks the tmp). A crash
   loses at most the unsealed buffer (bounded by ``segment_kb``); it can
   never corrupt a sealed segment. A sealed segment that fails its crc
   at read is skipped AND unlinked.
4. **Bounded.** ``budget_mb`` caps on-disk bytes; the oldest sealed
   segment is evicted first (``train_capture_evict``). Sampling is the
   sha256-of-counter idiom — deterministic, no RNG on the serving path.
5. **O(1) stats.** Byte/record totals are maintained incrementally;
   the only directory walk is the one recovery scan at open.

The segment bytes are the JAX package's byte for byte (MAGIC, then
little-endian (length, crc32) frames of canonical JSON), so each package
reads the other's store.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import zlib
from typing import Any, Iterator, Optional

from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.telemetry import (
    TRAIN_CAPTURE_BYTES, TRAIN_CAPTURE_EVICTIONS_TOTAL,
    TRAIN_CAPTURE_RECORDS_TOTAL,
)

# ---------------------------------------------------------------------------
# Enablement (the costobs / introspect idiom)
# ---------------------------------------------------------------------------


def _env_enabled() -> bool:
    return os.environ.get("QUORACLE_TRAIN_CAPTURE", "1").strip().lower() \
        not in ("0", "false", "off")


class _State:
    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = _env_enabled()


_STATE = _State()


def enabled() -> bool:
    return _STATE.enabled


def enable() -> None:
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


# ---------------------------------------------------------------------------
# On-disk format
# ---------------------------------------------------------------------------

# Segment: MAGIC, then frames back to back. Frame: little-endian
# (payload_len, crc32(payload)) header + utf-8 canonical-JSON payload.
MAGIC = b"QCAP1\n"
_FRAME = struct.Struct("<II")
# how many trailing context tokens a speculation example keeps — enough
# to re-prefill a verify replay, bounded so one chatty session cannot
# eat the budget
CTX_TAIL = 512


def _frame(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) \
        + payload


def _encode(record: dict) -> bytes:
    return _frame(json.dumps(record, sort_keys=True,
                             separators=(",", ":")).encode("utf-8"))


class CaptureStore:
    """Bounded, crash-safe, append-only store of training examples.

    Thread-safe: appends land from the scheduler thread (speculation
    tap) and the consensus engine's thread (quality sink); reads come
    from the trainer. All shared state lives under the coarse
    ``train.capture`` lock — the sealed-segment write under it is the
    lock's declared purpose.
    """

    def __init__(self, path: str, *, budget_mb: float = 256.0,
                 segment_kb: int = 256, sample_every: int = 1,
                 seed: int = 0):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self.budget_bytes = max(1, int(budget_mb * (1 << 20)))
        self.segment_bytes = max(1024, int(segment_kb) << 10)
        self.sample_every = max(1, int(sample_every))
        self.seed = int(seed)
        self._lock = named_lock("train.capture")
        self._buf: list[bytes] = []
        self._buf_bytes = 0
        self._buf_records = 0
        # sealed-segment ledger: (fname, bytes, records) oldest first.
        # Totals are maintained incrementally — stats() is O(1).
        self._segments: list[tuple[str, int, int]] = []
        self._disk_bytes = 0
        self._disk_records = 0
        self._seq = 0
        self._sample_counts: dict[str, int] = {}
        self._appended = 0
        self._sampled_out = 0
        self._dropped = 0
        self._evicted_segments = 0
        self._corrupt_segments = 0
        self._recover()

    # -- recovery (the one directory walk, at open) ----------------------

    def _recover(self) -> None:
        try:
            names = sorted(n for n in os.listdir(self.path)
                           if n.startswith("cap-") and n.endswith(".qcr"))
        except OSError:
            names = []
        for name in names:
            full = os.path.join(self.path, name)
            counted = self._scan_segment(full)
            if counted is None:
                # corrupt (torn tail record, rot): skip AND unlink — the
                # DiskPrefixStore boundary; surviving segments stand
                self._unlink(full)
                self._corrupt_segments += 1
                continue
            nbytes, nrec = counted
            self._segments.append((name, nbytes, nrec))
            self._disk_bytes += nbytes
            self._disk_records += nrec
        if self._segments:
            self._seq = int(self._segments[-1][0][4:-4]) + 1
        TRAIN_CAPTURE_BYTES.set(float(self._disk_bytes))

    @staticmethod
    def _scan_segment(full: str) -> Optional[tuple[int, int]]:
        """(bytes, records) when every frame validates, else None."""
        try:
            with open(full, "rb") as f:
                data = f.read()
        except OSError:
            return None
        if not data.startswith(MAGIC):
            return None
        off, nrec = len(MAGIC), 0
        while off < len(data):
            if off + _FRAME.size > len(data):
                return None
            ln, crc = _FRAME.unpack_from(data, off)
            off += _FRAME.size
            payload = data[off:off + ln]
            if len(payload) != ln \
                    or zlib.crc32(payload) & 0xFFFFFFFF != crc:
                return None
            off += ln
            nrec += 1
        return len(data), nrec

    def _unlink(self, full: str) -> None:
        try:
            os.unlink(full)
        except OSError:
            pass

    # -- append path -----------------------------------------------------

    def _sampled_in(self, source: str) -> bool:
        """Deterministic sha256-of-counter sampling (the chaos-plane
        idiom) — replayable, no RNG on the serving path."""
        with self._lock:
            n = self._sample_counts.get(source, 0)
            self._sample_counts[source] = n + 1
        if self.sample_every <= 1:
            return True
        digest = hashlib.sha256(
            f"{self.seed}:{source}:{n}".encode()).digest()
        return int.from_bytes(digest[:8], "big") % self.sample_every == 0

    def append(self, source: str, record: dict, *,
               corrupt: bool = False) -> str:
        """Append one record; returns its disposition. ``corrupt`` is
        the chaos plane's hook: the frame is written with a flipped
        payload byte so the read boundary must reject it."""
        if not self._sampled_in(source):
            self._sampled_out += 1
            return "sampled_out"
        framed = _encode(dict(record, source=source))
        if corrupt and len(framed) > _FRAME.size:
            body = bytearray(framed)
            body[-1] ^= 0xFF
            framed = bytes(body)
        sealed = evicted = None
        with self._lock:
            self._buf.append(framed)
            self._buf_bytes += len(framed)
            self._buf_records += 1
            self._appended += 1
            if self._buf_bytes >= self.segment_bytes:
                sealed = self._seal_locked()
                evicted = self._evict_locked()
        self._emit(sealed, evicted)
        return "ok"

    def flush(self) -> None:
        """Seal the in-memory buffer (trainer handoff / shutdown)."""
        with self._lock:
            sealed = self._seal_locked()
            evicted = self._evict_locked()
        self._emit(sealed, evicted)

    def _seal_locked(self) -> Optional[tuple[str, int, int]]:
        if not self._buf:
            return None
        name = f"cap-{self._seq:08d}.qcr"
        full = os.path.join(self.path, name)
        tmp = full + ".tmp"
        body = MAGIC + b"".join(self._buf)
        try:
            with open(tmp, "wb") as f:
                f.write(body)
            os.replace(tmp, full)          # atomic publish
        except OSError:
            self._unlink(tmp)
            raise
        self._seq += 1
        entry = (name, len(body), self._buf_records)
        self._segments.append(entry)
        self._disk_bytes += len(body)
        self._disk_records += self._buf_records
        self._buf = []
        self._buf_bytes = 0
        self._buf_records = 0
        return entry

    def _evict_locked(self) -> Optional[tuple[int, int]]:
        """Oldest-first eviction to the byte budget; (bytes, records)
        given up, or None."""
        freed_b = freed_r = 0
        while self._disk_bytes > self.budget_bytes \
                and len(self._segments) > 1:
            name, nbytes, nrec = self._segments.pop(0)
            self._unlink(os.path.join(self.path, name))
            self._disk_bytes -= nbytes
            self._disk_records -= nrec
            freed_b += nbytes
            freed_r += nrec
            self._evicted_segments += 1
        return (freed_b, freed_r) if freed_b else None

    def _emit(self, sealed, evicted) -> None:
        """Metrics/flight outside the lock (repo discipline)."""
        if sealed is not None or evicted is not None:
            TRAIN_CAPTURE_BYTES.set(float(self._disk_bytes))
        if evicted is not None:
            TRAIN_CAPTURE_EVICTIONS_TOTAL.inc()
            FLIGHT.record("train_capture_evict",
                          bytes=evicted[0], records=evicted[1])

    # -- read path (trainer side — not scraped) --------------------------

    def read_all(self, source: Optional[str] = None) -> Iterator[dict]:
        """Yield every stored record oldest-first, sealed segments then
        the unsealed buffer. A frame that fails its crc mid-segment
        skips the REST of that segment and unlinks it — surviving
        records before the corruption are still yielded."""
        with self._lock:
            names = [n for n, _, _ in self._segments]
            buffered = list(self._buf)
        for name in names:
            full = os.path.join(self.path, name)
            try:
                with open(full, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            ok, records = self._decode_segment(data)
            if not ok:
                self._drop_segment(name)
            for rec in records:
                if source is None or rec.get("source") == source:
                    yield rec
        for framed in buffered:
            payload = framed[_FRAME.size:]
            ln, crc = _FRAME.unpack_from(framed, 0)
            if len(payload) != ln \
                    or zlib.crc32(payload) & 0xFFFFFFFF != crc:
                continue
            rec = json.loads(payload.decode("utf-8"))
            if source is None or rec.get("source") == source:
                yield rec

    @staticmethod
    def _decode_segment(data: bytes) -> tuple[bool, list[dict]]:
        records: list[dict] = []
        if not data.startswith(MAGIC):
            return False, records
        off = len(MAGIC)
        while off < len(data):
            if off + _FRAME.size > len(data):
                return False, records
            ln, crc = _FRAME.unpack_from(data, off)
            off += _FRAME.size
            payload = data[off:off + ln]
            if len(payload) != ln \
                    or zlib.crc32(payload) & 0xFFFFFFFF != crc:
                return False, records
            off += ln
            try:
                records.append(json.loads(payload.decode("utf-8")))
            except (ValueError, UnicodeDecodeError):
                return False, records
        return True, records

    def _drop_segment(self, name: str) -> None:
        """Corrupt segment seen at read: unlink + ledger adjust."""
        with self._lock:
            for i, (n, nbytes, nrec) in enumerate(self._segments):
                if n == name:
                    self._segments.pop(i)
                    self._disk_bytes -= nbytes
                    self._disk_records -= nrec
                    self._corrupt_segments += 1
                    break
            else:
                return
        self._unlink(os.path.join(self.path, name))
        TRAIN_CAPTURE_BYTES.set(float(self._disk_bytes))
        FLIGHT.record("kv_disk_corrupt", path=name, plane="train.capture")

    # -- observability ---------------------------------------------------

    def stats(self) -> dict:
        """O(1) — every total is maintained incrementally."""
        with self._lock:
            return {
                "path": self.path,
                "budget_mb": round(self.budget_bytes / (1 << 20), 2),
                "sample_every": self.sample_every,
                "disk_bytes": self._disk_bytes,
                "disk_records": self._disk_records,
                "segments": len(self._segments),
                "buffered_records": self._buf_records,
                "buffered_bytes": self._buf_bytes,
                "appended": self._appended,
                "sampled_out": self._sampled_out,
                "dropped": self._dropped,
                "evicted_segments": self._evicted_segments,
                "corrupt_segments": self._corrupt_segments,
                "full": self._disk_bytes >= self.budget_bytes,
            }


# ---------------------------------------------------------------------------
# The plane: a process-wide singleton the serving taps talk to
# ---------------------------------------------------------------------------


class _Plane:
    """Holds the installed store (if any) and absorbs every failure.
    ``active`` is the serving taps' one-attribute-read fast path."""

    def __init__(self) -> None:
        self.store: Optional[CaptureStore] = None
        self._degraded = False          # trip-once flight guard
        self._install_lock = threading.Lock()

    @property
    def active(self) -> bool:
        return _STATE.enabled and self.store is not None

    def install(self, path: str, **kwargs: Any) -> CaptureStore:
        with self._install_lock:
            store = CaptureStore(path, **kwargs)
            self.store = store
            self._degraded = False
            return store

    def uninstall(self) -> None:
        with self._install_lock:
            store = self.store
            self.store = None
        if store is not None:
            try:
                store.flush()
            except Exception:             # noqa: BLE001 — shutdown only
                pass

    def reset(self) -> None:
        """Test hook: drop the store and restore env enablement."""
        with self._install_lock:
            self.store = None
            self._degraded = False
        _STATE.enabled = _env_enabled()

    # -- the two taps ----------------------------------------------------

    def observe_spec_round(self, model: str, draft: str,
                           examples: list) -> None:
        """Speculation tap: one call per round, AFTER the commits, with
        copies — see models/speculative.py. Never raises."""
        self._append_batch("spec", model, examples)

    def observe_consensus(self, record: dict) -> None:
        """Quality-sink tap (consensus/quality.py): keep the winning
        proposal + prompt context as a slim projection."""
        if not self.active:
            return
        if record.get("event") != "consensus_audit":
            return
        decision = record.get("decision") or None
        if not decision:
            return
        slim = {
            "kind": "consensus",
            "decide_id": record.get("decide_id"),
            "task_id": record.get("task_id"),
            "agent_id": record.get("agent_id"),
            "action": decision.get("action"),
            "action_kind": decision.get("kind"),
            "confidence": decision.get("confidence"),
            "n_members": record.get("n_members"),
            "margin": record.get("margin"),
            "winners": [m for m, st in (record.get("members")
                                        or {}).items()
                        if st.get("agreed")],
        }
        self._append_batch("consensus", "-", [slim])

    def _append_batch(self, source: str, model: str,
                      records: list) -> None:
        store = self.store
        if not _STATE.enabled or store is None or not records:
            return
        ok = dropped = sampled_out = 0
        try:
            # chaos seam: one decision per batch. drop → the batch is
            # lost; corrupt → frames land with a flipped byte so the
            # read boundary must reject them; crash → absorbed below
            # exactly like a real disk failure.
            from quoracle_tpu_torch.chaos.faults import CHAOS
            fault = CHAOS.fire("train.capture", model=model)
            corrupt = False
            if fault is not None:
                if fault.kind == "drop":
                    dropped = len(records)
                    records = []
                elif fault.kind == "corrupt":
                    corrupt = True
            for rec in records:
                disp = store.append(source, rec, corrupt=corrupt)
                if disp == "ok":
                    ok += 1
                else:
                    sampled_out += 1
        except Exception:                 # noqa: BLE001 — rule 2: the
            # serving path absorbs everything (disk full, injected
            # crash, serialization surprise); the record drops
            dropped += max(0, len(records) - ok - sampled_out)
            with store._lock:
                store._dropped += dropped
            if not self._degraded:
                self._degraded = True
                FLIGHT.record("train_capture_degraded",
                              source=source, model=model)
        else:
            if dropped:
                with store._lock:
                    store._dropped += dropped
        if ok:
            TRAIN_CAPTURE_RECORDS_TOTAL.inc(ok, source=source,
                                            status="ok")
        if sampled_out:
            TRAIN_CAPTURE_RECORDS_TOTAL.inc(sampled_out, source=source,
                                            status="sampled_out")
        if dropped:
            TRAIN_CAPTURE_RECORDS_TOTAL.inc(dropped, source=source,
                                            status="dropped")

    def stats(self) -> dict:
        store = self.store
        payload: dict = {
            "enabled": _STATE.enabled,
            "installed": store is not None,
            "degraded": self._degraded,
        }
        if store is not None:
            payload["store"] = store.stats()
        return payload


CAPTURE = _Plane()


def spec_example(ctx: list, proposal: list, verified: list,
                 accepted: int, correction: Optional[int],
                 temperature: float, constrain: bool,
                 action_enum) -> dict:
    """One speculation training example (the schema ARCHITECTURE.md
    documents for the JAX package; the same keys). ``verified`` is the target's grammar-masked argmax at
    every proposal position (the distillation targets); ``accepted`` is
    the prefix length the round committed; ``correction`` is the
    target's token at the first reject (None on full accept)."""
    dropped = max(0, len(ctx) - CTX_TAIL)
    return {
        "kind": "spec_round",
        "ctx": [int(t) for t in ctx[-CTX_TAIL:]],
        "ctx_dropped": dropped,
        "proposal": [int(t) for t in proposal],
        "verified": [int(t) for t in verified],
        "accepted": int(accepted),
        "correction": None if correction is None else int(correction),
        "temperature": float(temperature),
        "constrain": bool(constrain),
        "action_enum": (sorted(action_enum)
                        if action_enum else None),
    }
