"""Tiered KV of the PyTorch port (port of ``quoracle_tpu/serving/kvtier.py``):
host offload, session hibernation, and a prefix store that outlives the
process.

Agent sessions spend most of their wall clock waiting (on actions, on
children, on timers), so at any instant most resident pages belong to
nobody who is decoding. Three tiers, managed by :class:`TierManager` (one
per engine and ``SessionStore``):

  HBM   the device page pool (models/generate.py ``SessionStore``), still
        the only tier attention reads.
  HOST  :class:`HostPageStore`: CPU tensor copies of demoted sessions and
        stripped prefix-cache leaves, LRU-bounded by ``host_bytes``.
        ``alloc``'s eviction ladder DEMOTES a victim here (one
        device-to-host copy) before it releases the pages, and a demoted
        session touched again RESTORES by page-in (a host-to-device copy
        and ``index_copy_`` along the pool's page axis) instead of
        re-prefilling. Shared pages keep their refcounts: demote copies
        the content and drops only the victim's own references, so
        adopters and the radix tree keep reading the resident originals.
  DISK  :class:`DiskPrefixStore`: checksummed page-aligned prefix blocks
        under ``disk_dir``. Prefix-cache inserts persist their blocks
        (deduplicated by content hash), so a restarted process warms from
        its predecessor's prefixes: a radix-tree miss falls through to
        host, then disk, pages in and re-inserts the block. Corrupt
        entries (crc mismatch, torn writes, a token mismatch) are skipped
        and unlinked.

The restored session is bit-identical to one that never left the pool: the
copies move a page's bytes exactly, the session re-enters the store with
the same tokens and ``start_pos``, and the resume path cannot tell where
its pages were. Temperature-0 outputs match with tiers on or off.

Host entries are torch CPU tensors in the pool's own dtype (bf16 included:
numpy has no bf16). The disk format is the JAX package's, byte for byte:
an ``.npz`` of ``tokens`` (int64), ``k`` and ``v`` as raw ``uint8`` bytes
with their ``dtype`` name and ``shape``, ``crc`` (crc32 over tokens, k, v
and, for int8 entries, the fp32 ``k_scale``/``v_scale`` saved beside them
with their ``scale_shape``), under ``<root>/<kv signature>/<key>.npz``
where the key is the sha256 of the int64 token prefix; so either package
loads what the other wrote.

Copies run on the pool device's current stream (the engines launch every
kernel there). A CUDA pool's pages go to the host through pinned buffers
allocated by each demote, and the stream is synchronized before the host
bytes are read (the crc, the spill writer); a page-in from a pinned entry
is enqueued without a host wait, on the stream the kernels read from. On
an H100 (the tiers phase of chip_smoke.py, PERF.md) a 24-page llama-3-8b
session (384 MiB) paged in from pinned memory 6-8x faster than from
pageable memory, while a demote, which allocates its pinned buffers, took
0.4-2.4x a pageable copy of the same pages (five runs); so pinning is the
default on CUDA (``pin_memory`` False: pageable, blocking copies, which
the phase times beside them). CPU pools copy plainly.

Locking: demote runs inside ``SessionStore.alloc`` (the store's RLock
held, and the engine's ``_paged_lock`` held by every sessioned caller);
restore runs from the engine's session lookup (same locks) or from
``prefetch_session``, which try-acquires the engine lock. ``restore_session``
re-enters the store lock through ``alloc``, so it must stay an RLock.
Disk writes never happen under those locks: demote and persist copy
pages host-side and queue the npz write to a daemon spill writer;
``flush_spills`` drains it.

Observability as in the JAX tier: the ``KV_*`` counters and the restore
latency histogram, the int8 byte-savings counter of each tier move, the
``kv_demote``/``kv_restore``/``kv_disk_spill``/``kv_disk_corrupt``
flight records, the retroactive ``kv.restore`` span (only while a tracer
sink listens), the restore's chip-ms charge (``costobs.charge_restore``)
and its wait on the dispatching thread (``introspect.note_restore``).
The chaos plane's seams (chaos/faults.py) sit where the JAX tier has
them: ``kvtier.disk_load`` and ``kvtier.scale_corrupt`` flip bytes of a
disk entry before its load, so the crc32 boundary must reject it, and
``kvtier.restore`` fails a page-in into the re-prefill degrade.

The fleet prefix service (serving/fabric/prefixd.py) is the ladder's last
rung: with a ``PrefixdClient`` attached (``attach_prefixd``), a block the
host and disk tiers miss is fetched from the fleet, and the spill writer
publishes every persisted block to it beside the disk write.
"""

from __future__ import annotations

import hashlib
import logging
import os
import queue
import threading
import time
import zlib
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from quoracle_tpu_torch.chaos.faults import CHAOS
from quoracle_tpu_torch.infra import costobs, introspect
from quoracle_tpu_torch.infra.flightrec import FLIGHT
from quoracle_tpu_torch.infra.locks import named_lock
from quoracle_tpu_torch.infra.telemetry import (
    KV_DEMOTES_TOTAL, KV_DISK_LOADS_TOTAL, KV_DISK_SPILLS_TOTAL,
    KV_HOST_EVICTIONS_TOTAL, KV_RESTORE_MS, KV_RESTORES_TOTAL,
    QUANT_BYTES_SAVED_TOTAL, TRACER,
)
from quoracle_tpu_torch.models.quant import entry_nbytes

logger = logging.getLogger(__name__)


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype by the name numpy and JAX give it (``float32``,
    ``bfloat16``, ``int8``): the disk format's ``dtype`` field and the
    KV signature's suffix."""
    return str(dtype).removeprefix("torch.")


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a flat uint8 numpy array (bf16 included)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


class _HostSession:
    __slots__ = ("tokens", "start_pos", "k", "v", "k_scale", "v_scale",
                 "nbytes")

    def __init__(self, tokens, start_pos, k, v, k_scale=None,
                 v_scale=None):
        self.tokens = tokens
        self.start_pos = start_pos
        self.k = k                      # CPU [L, n_pages, page, KV, hd]
        self.v = v
        # int8 entries: fp32 [L, n_pages, KV, page]; the scales travel
        # with their pages through every tier move
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.nbytes = entry_nbytes(k, v, k_scale, v_scale)


class _HostBlock:
    __slots__ = ("tokens", "k", "v", "k_scale", "v_scale", "nbytes")

    def __init__(self, tokens, k, v, k_scale=None, v_scale=None):
        self.tokens = tokens            # the full page-aligned prefix
        self.k = k                      # CPU [L, page, KV, hd]
        self.v = v
        self.k_scale = k_scale          # CPU [L, KV, page] (int8 entries)
        self.v_scale = v_scale
        self.nbytes = entry_nbytes(k, v, k_scale, v_scale)


class HostPageStore:
    """LRU-bounded host-memory page store: hibernated sessions and
    stripped prefix blocks. Session entries DROP under budget pressure
    (one agent's private state, which a re-prefill recovers); prefix
    blocks SPILL to disk first when a DiskPrefixStore is attached."""

    def __init__(self, budget_bytes: int, model: str = ""):
        self.budget_bytes = int(budget_bytes)
        self.model = model
        self.sessions: OrderedDict[str, _HostSession] = OrderedDict()
        self.prefixes: OrderedDict[str, _HostBlock] = OrderedDict()
        self.bytes = 0
        self.evicted_sessions = 0
        self.evicted_prefixes = 0

    def put_session(self, key: str, entry: _HostSession,
                    spill_fn=None) -> None:
        old = self.sessions.pop(key, None)
        if old is not None:
            self.bytes -= old.nbytes
        self.sessions[key] = entry
        self.bytes += entry.nbytes
        self.shrink(spill_fn)

    def put_prefix(self, key: str, entry: _HostBlock,
                   spill_fn=None) -> None:
        if key in self.prefixes:
            return
        self.prefixes[key] = entry
        self.bytes += entry.nbytes
        self.shrink(spill_fn)

    def pop_session(self, key: str) -> Optional[_HostSession]:
        e = self.sessions.pop(key, None)
        if e is not None:
            self.bytes -= e.nbytes
        return e

    def get_prefix(self, key: str) -> Optional[_HostBlock]:
        e = self.prefixes.get(key)
        if e is not None:
            self.prefixes.move_to_end(key)
        return e

    def shrink(self, spill_fn=None) -> None:
        """Evict LRU entries until under budget: prefix blocks first
        (spillable through ``spill_fn``), then sessions, oldest first
        within each kind."""
        while self.bytes > self.budget_bytes and self.prefixes:
            key, e = self.prefixes.popitem(last=False)
            self.bytes -= e.nbytes
            self.evicted_prefixes += 1
            KV_HOST_EVICTIONS_TOTAL.inc(model=self.model, kind="prefix")
            if spill_fn is not None:
                spill_fn(key, e)
        while self.bytes > self.budget_bytes and self.sessions:
            _, e = self.sessions.popitem(last=False)
            self.bytes -= e.nbytes
            self.evicted_sessions += 1
            KV_HOST_EVICTIONS_TOTAL.inc(model=self.model, kind="session")

    def headroom(self) -> int:
        return max(0, self.budget_bytes - self.bytes)

    def stats(self) -> dict:
        return {
            "budget_bytes": self.budget_bytes,
            "bytes": self.bytes,
            "sessions": len(self.sessions),
            "prefix_blocks": len(self.prefixes),
            "evicted_sessions": self.evicted_sessions,
            "evicted_prefixes": self.evicted_prefixes,
        }


class DiskPrefixStore:
    """Checksummed on-disk store of page-aligned prefix blocks, one file
    per block keyed by the content hash of the token prefix ending at the
    block, under ``<root>/<kv signature>/`` so engines of another
    geometry or dtype never load each other's bytes. Files are written
    atomically (a tmp file, then a rename: a torn write is an unreadable
    tmp file, never a half entry).

    ``load`` checks the crc32 of the payload and the requested token
    prefix against the stored ones; a mismatch counts as corrupt, unlinks
    the file and returns None, and the caller prefills instead. The
    store is an optimization, never a correctness dependency.

    ``budget_bytes`` (0 = unbounded) caps the directory: a save that
    overflows it unlinks oldest-mtime entries, and ``load`` touches an
    entry's mtime, so pruning approximates LRU. The directory's size is
    tracked incrementally (one scan at start, healed at most every
    ``_SCAN_TTL_S`` on the save path), so ``stats()`` never lists it."""

    _SCAN_TTL_S = 30.0

    def __init__(self, root: str, signature: str, model: str = "",
                 budget_bytes: int = 0):
        self.dir = os.path.join(root, signature)
        self.model = model
        self.budget_bytes = int(budget_bytes)
        os.makedirs(self.dir, exist_ok=True)
        self.writes = 0
        self.loads = 0
        self.corrupt = 0
        self.pruned = 0
        self._lock = named_lock("tier.disk")
        self._scan_entries = 0
        self._scan_bytes = 0
        self._scan_ts = 0.0
        with self._lock:
            self._rescan_locked()

    def _rescan_locked(self) -> None:
        entries = nbytes = 0
        try:
            for f in os.listdir(self.dir):
                if not f.endswith(".npz"):
                    continue
                entries += 1
                try:
                    nbytes += os.path.getsize(os.path.join(self.dir, f))
                except OSError:
                    pass
        except OSError:
            pass
        self._scan_entries, self._scan_bytes = entries, nbytes
        self._scan_ts = time.monotonic()

    def _prune_locked(self) -> None:
        """Unlink oldest-mtime entries until the store fits its budget."""
        files = []
        try:
            for f in os.listdir(self.dir):
                if not f.endswith(".npz"):
                    continue
                p = os.path.join(self.dir, f)
                try:
                    stt = os.stat(p)
                except OSError:
                    continue
                files.append((stt.st_mtime, stt.st_size, p))
        except OSError:
            return
        files.sort()
        self._scan_entries = len(files)
        self._scan_bytes = sum(sz for _, sz, _ in files)
        self._scan_ts = time.monotonic()
        for _, sz, p in files:
            if self._scan_bytes <= self.budget_bytes:
                break
            try:
                os.unlink(p)
            except OSError:
                continue
            self._scan_bytes -= sz
            self._scan_entries -= 1
            self.pruned += 1

    @staticmethod
    def block_key(tokens: Sequence[int]) -> str:
        h = hashlib.sha256(
            np.asarray(tokens, np.int64).tobytes()).hexdigest()
        return h[:40]

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.npz")

    def has(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    @staticmethod
    def _crc(tokens: np.ndarray, k: torch.Tensor, v: torch.Tensor,
             k_scale: Optional[torch.Tensor] = None,
             v_scale: Optional[torch.Tensor] = None) -> int:
        """crc32 over the token ids, the K and V bytes and, for int8
        entries, the scale blocks: a flipped scale byte is rejected like
        a flipped payload byte."""
        c = zlib.crc32(tokens.tobytes())
        c = zlib.crc32(_raw_bytes(k), c)
        c = zlib.crc32(_raw_bytes(v), c)
        if k_scale is not None:
            c = zlib.crc32(_raw_bytes(k_scale.float()), c)
            c = zlib.crc32(_raw_bytes(v_scale.float()), c)
        return c & 0xFFFFFFFF

    def save(self, key: str, tokens: Sequence[int], k: torch.Tensor,
             v: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
             v_scale: Optional[torch.Tensor] = None) -> bool:
        """Write one block. The serialization and the tmp-file write run
        outside ``_lock``; only the atomic publish (a rename) and the size
        accounting and budget prune run under it. Two writers racing one
        content-addressed key write identical bytes under distinct tmp
        names, and the exists check under the lock counts one."""
        path = self._path(key)
        if os.path.exists(path):
            return False                 # content-addressed: already there
        toks = np.asarray(tokens, np.int64)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                # raw bytes + dtype name + shape: npz has no bf16
                extra = {}
                if k_scale is not None:
                    extra = {
                        "k_scale": k_scale.float().contiguous().numpy(),
                        "v_scale": v_scale.float().contiguous().numpy(),
                        "scale_shape": np.asarray(tuple(k_scale.shape)),
                    }
                np.savez(
                    f, tokens=toks, k=_raw_bytes(k), v=_raw_bytes(v),
                    dtype=dtype_name(k.dtype),
                    shape=np.asarray(tuple(k.shape)),
                    crc=np.uint32(self._crc(toks, k, v, k_scale,
                                            v_scale)),
                    **extra)
            with self._lock:
                if os.path.exists(path):
                    # a concurrent writer published the same content
                    os.unlink(tmp)
                    return False
                os.replace(tmp, path)
                self._scan_entries += 1
                try:
                    self._scan_bytes += os.path.getsize(path)
                except OSError:
                    pass                  # drift heals at the next rescan
                if (time.monotonic() - self._scan_ts
                        > self._SCAN_TTL_S):
                    self._rescan_locked()
                if (self.budget_bytes
                        and self._scan_bytes > self.budget_bytes):
                    self._prune_locked()
            self.writes += 1
            return True
        except OSError:
            logger.exception("disk prefix write failed: %s", path)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    def load(self, key: str, tokens: Sequence[int]) -> Optional[tuple]:
        """The block's ``(k, v)`` (int8 entries: ``(k, v, k_scale,
        v_scale)``) as CPU tensors, or None when it is missing or corrupt."""
        path = self._path(key)
        if not os.path.exists(path):
            return None
        # Chaos seams: a "corrupt" directive flips a byte of the FILE
        # before the normal load path runs, so the crc32 boundary below
        # is what catches it (skip, unlink, never served).
        # "kvtier.scale_corrupt" flips one in the entry's tail, where npz
        # appends an int8 entry's per-page scale arrays: the crc covers
        # scales like payload, so the same boundary must reject it.
        d = CHAOS.fire("kvtier.disk_load", model=self.model)
        if d is not None and d.kind == "corrupt":
            self._chaos_corrupt(path)
        d = CHAOS.fire("kvtier.scale_corrupt", model=self.model)
        if d is not None and d.kind == "corrupt":
            self._chaos_corrupt(path, where=0.95)
        try:
            with np.load(path) as z:
                toks, crc = z["tokens"], int(z["crc"])
                dt = getattr(torch, str(z["dtype"]))
                if not isinstance(dt, torch.dtype):
                    raise ValueError(f"unknown dtype {z['dtype']}")
                shape = tuple(int(s) for s in z["shape"])
                k = torch.from_numpy(z["k"].copy()).view(dt).reshape(shape)
                v = torch.from_numpy(z["v"].copy()).view(dt).reshape(shape)
                ks = vs = None
                if "k_scale" in z.files:
                    sshape = tuple(int(s) for s in z["scale_shape"])
                    ks = torch.from_numpy(np.array(
                        z["k_scale"], np.float32).reshape(sshape))
                    vs = torch.from_numpy(np.array(
                        z["v_scale"], np.float32).reshape(sshape))
            if (self._crc(toks, k, v, ks, vs) != crc
                    or toks.tolist() != [int(t) for t in tokens]):
                raise ValueError("checksum/token mismatch")
            self.loads += 1
            try:
                os.utime(path)            # LRU touch for budget pruning
            except OSError:
                pass
            KV_DISK_LOADS_TOTAL.inc(model=self.model, status="ok")
            return (k, v) if ks is None else (k, v, ks, vs)
        except Exception:                 # noqa: BLE001 — corrupt entry
            self.corrupt += 1
            logger.warning("corrupt disk prefix entry skipped: %s", path)
            KV_DISK_LOADS_TOTAL.inc(model=self.model, status="corrupt")
            FLIGHT.record("kv_disk_corrupt", path=path, model=self.model)
            try:
                sz = os.path.getsize(path)
                os.unlink(path)
            except OSError:
                sz = -1
            if sz >= 0:
                with self._lock:
                    self._scan_entries = max(0, self._scan_entries - 1)
                    self._scan_bytes = max(0, self._scan_bytes - sz)
            return None

    @staticmethod
    def _chaos_corrupt(path: str, where: float = 0.5) -> None:
        """Flip a byte in place at fraction ``where`` of the file (chaos
        "corrupt" directives: 0.5 lands mid-payload; the scale seam's
        0.95 lands in an int8 entry's appended scale arrays).
        Best-effort: a vanished file is already the degraded case."""
        try:
            with open(path, "r+b") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size < 1:
                    return
                pos = min(size - 1, int(size * where))
                f.seek(pos)
                b = f.read(1)
                f.seek(pos)
                f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        except OSError:
            pass

    def stats(self) -> dict:
        with self._lock:
            return {"dir": self.dir, "entries": self._scan_entries,
                    "bytes": self._scan_bytes,
                    "budget_bytes": self.budget_bytes,
                    "writes": self.writes, "loads": self.loads,
                    "corrupt_skipped": self.corrupt,
                    "pruned": self.pruned}


class TierManager:
    """The tier ladder of one engine's SessionStore, attached through
    ``GenerateEngine.attach_tier`` (which sets ``store.tier``). Every
    method that touches the device pool assumes the engine's
    ``_paged_lock`` discipline of the module docstring."""

    def __init__(self, store, model: str = "", host_mb: int = 256,
                 disk_dir: Optional[str] = None,
                 signature: Optional[str] = None, disk_gb: float = 8.0):
        self.store = store
        self.model = model
        self.signature = signature or (model.replace("/", "_")
                                       or "default")
        # host copies of a CUDA pool through pinned buffers (the tiers
        # phase of chip_smoke.py turns it off to time pageable copies)
        self.pin_memory = True
        self.host = HostPageStore(int(host_mb) * (1 << 20), model=model)
        self.disk: Optional[DiskPrefixStore] = None
        if disk_dir:
            self.disk = DiskPrefixStore(
                disk_dir, self.signature, model=model,
                budget_bytes=int(disk_gb * (1 << 30)))
        # the fleet prefix service's read-through client (attach_prefixd):
        # the restore ladder's last rung (host, disk, then the fleet) and
        # the spill writer's second publish target
        self.prefixd = None
        self.demoted_sessions = 0
        self.demoted_prefix_pages = 0
        self.restored_sessions = 0
        self.restored_prefix_pages = 0
        self.restore_failures = 0
        self.spill_drops = 0
        # Disk spills are asynchronous: the eviction ladder runs inside
        # SessionStore.alloc under the store lock, where an npz write
        # would stall every allocation. A full queue drops the spill (the
        # block is recomputable by prefill).
        self._spill_q: Optional[queue.Queue] = None
        if self.disk is not None:
            self._ensure_spill_writer()

    def _ensure_spill_writer(self) -> None:
        if self._spill_q is None:
            self._spill_q = queue.Queue(maxsize=512)
            threading.Thread(
                target=self._spill_loop, daemon=True,
                name=f"kvtier-spill-{self.model or 'default'}").start()

    def attach_prefixd(self, client) -> None:
        """Wire the fleet prefix service's client: reads join
        ``extend_prefix``'s restore ladder, writes ride the spill writer
        (wire I/O never happens under the serving locks)."""
        self.prefixd = client
        self._ensure_spill_writer()

    # -- device <-> host ------------------------------------------------

    def _gather_host(self, pages: list[int]) -> tuple:
        """The pages' KV as CPU tensors ``(k, v, k_scale, v_scale)``,
        scales None for float pools. Runs under the store lock: the copy
        must finish before alloc's ladder releases the pages."""
        st = self.store
        dev = st.k.device
        idx = torch.tensor(pages, dtype=torch.long, device=dev)
        pools = [st.k, st.v]
        if st.k_scale is not None:
            pools += [st.k_scale, st.v_scale]
        picked = [p.index_select(1, idx) for p in pools]
        if self.pin_memory and dev.type == "cuda":
            out = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                   for x in picked]
            for o, x in zip(out, picked):
                o.copy_(x, non_blocking=True)
            # the host bytes are read (crc, spill writer) only after this
            torch.cuda.current_stream(dev).synchronize()
        else:
            out = [x.cpu() for x in picked]
        if len(out) == 2:
            out += [None, None]
        return tuple(out)

    def _scatter_device(self, pages: list[int], k: torch.Tensor,
                        v: torch.Tensor, k_scale=None,
                        v_scale=None) -> None:
        """Page-in: the host copies into the pool's pages along the page
        axis (int8 pools: the scale blocks beside the payload). No pad to
        a power of two and no write to scratch page 0: nothing compiles
        per shape here."""
        st = self.store
        if st.k_scale is not None and k_scale is None:
            # an entry without scales never lands in an int8 pool; the
            # caller degrades to re-prefill
            raise ValueError("quantized pool restore without scale blocks")
        dev = st.k.device
        idx = torch.tensor(pages, dtype=torch.long, device=dev)
        moves = [(st.k, k), (st.v, v)]
        if st.k_scale is not None:
            moves += [(st.k_scale, k_scale), (st.v_scale, v_scale)]
        for pool, host in moves:
            pool.index_copy_(1, idx, host.to(
                device=dev, dtype=pool.dtype,
                non_blocking=host.device.type == "cpu" and host.is_pinned()))

    # -- session hibernation --------------------------------------------

    def demote_session(self, key: str, sess) -> bool:
        """Copy a victim session's KV host-side before its pages release
        (called from SessionStore.alloc's ladder with both locks held).
        The caller releases the pages: only the victim's references drop."""
        st = self.store
        pages = [p for p in sess.pages if p]
        if not pages or st.k is None:
            return False
        t0 = time.monotonic()
        try:
            k, v, ks, vs = self._gather_host(pages)
        except Exception:                 # noqa: BLE001 — best-effort
            logger.exception("kv demote failed for %s", key)
            return False
        entry = _HostSession(list(sess.tokens), sess.start_pos, k, v,
                             ks, vs)
        self.host.put_session(key, entry,
                              spill_fn=self._spill_prefix_entry)
        self.demoted_sessions += 1
        KV_DEMOTES_TOTAL.inc(model=self.model, kind="session")
        self._note_bytes_saved("demote", entry)
        FLIGHT.record("kv_demote", model=self.model, what="session",
                      session=key, pages=len(pages),
                      ms=round((time.monotonic() - t0) * 1000, 2))
        return True

    def export_session(self, key: str) -> Optional[_HostSession]:
        """The handoff's export (serving/handoff.py): hibernate the session
        out of this engine exactly as the eviction ladder demotes it, and
        hand the host copy to the caller instead of parking it here. A
        session already hibernated is handed over as it is. None when the
        session is nowhere (the destination re-prefills). Assumes the
        engine's paged lock is held."""
        st = self.store
        with st.lock:
            sess = st._sessions.get(key)
            if sess is None:
                return self.host.pop_session(key)
            if not self.demote_session(key, sess):
                return None
            del st._sessions[key]
            st._release(sess.pages)
            return self.host.pop_session(key)

    def adopt_session(self, key: str, entry: _HostSession) -> None:
        """The handoff's adopt: a handed-over host copy enters this tier's
        host store, from which the normal restore (prefetch, or the
        engine's session lookup) pages it in. Replaces any stale copy
        under the key; the live store is untouched."""
        with self.store.lock:
            self.host.put_session(key, entry,
                                  spill_fn=self._spill_prefix_entry)

    def has_session(self, key: str) -> bool:
        return key in self.host.sessions

    def peek_tokens(self, key: str) -> Optional[list]:
        e = self.host.sessions.get(key)
        return list(e.tokens) if e is not None else None

    def discard_session(self, key: str) -> None:
        """The live store replaced or dropped this session: the host copy
        is stale and must never restore over fresher state."""
        self.host.pop_session(key)

    def restore_session(self, key: str):
        """Page a hibernated session back into the pool and re-register it.
        Returns the live session, or None (no pages to be had, the entry
        gone, or a failed page-in: the caller re-prefills, which is always
        correct). Assumes the engine's paged lock is held. A restore is
        counted, timed, charged to the model's ledger, booked as a
        kv_restore wait on this thread, flight-recorded and, while a
        tracer sink listens, emitted as a ``kv.restore`` span."""
        # Chaos seam: a "fail" directive takes the degrade-to-re-prefill
        # path; the entry stays in the host tier (a later touch may
        # still restore it), only THIS restore reports failure.
        d = CHAOS.fire("kvtier.restore", model=self.model)
        if d is not None and d.kind == "fail":
            self.restore_failures += 1
            return None
        st = self.store
        with st.lock:
            e = self.host.sessions.get(key)
            if e is None:
                return None
            n = e.k.shape[1]
            pages = st.alloc(n, protect=(key,))
            if pages is None:
                self.restore_failures += 1
                return None
            e = self.host.pop_session(key)
            if e is None:                 # raced a discard
                st._release(pages)
                return None
            t0 = time.monotonic()
            try:
                self._scatter_device(pages, e.k, e.v, e.k_scale,
                                     e.v_scale)
            except Exception:             # noqa: BLE001 — degrade
                # never leave a half-written session: the pages go back
                # and the row re-prefills
                logger.exception("kv restore failed for %s", key)
                st._release(pages)
                self.restore_failures += 1
                return None
            sess = st.register_restored(key, list(e.tokens), pages,
                                        e.start_pos)
            self.restored_sessions += 1
            ms = (time.monotonic() - t0) * 1000
        KV_RESTORES_TOTAL.inc(model=self.model, kind="session",
                              source="host")
        KV_RESTORE_MS.observe(ms, model=self.model, kind="session")
        costobs.charge_restore(self.model, ms, source="host")
        # the restore wall waits on the DISPATCHING thread: the batcher
        # books it against the step's rows; bytes feed the heartbeat
        introspect.note_restore(ms, nbytes=int(e.k.nbytes)
                                + int(e.v.nbytes))
        FLIGHT.record("kv_restore", model=self.model, what="session",
                      session=key, pages=len(pages), ms=round(ms, 2))
        if TRACER.active():
            # retroactive: the caller holds the store lock's caller's
            # locks, so never a bound span
            TRACER.emit("kv.restore", ms, ts=time.time() - ms / 1000.0,
                        session=key, model=self.model,
                        pages=len(pages))
        return sess

    # -- prefix-block tiering -------------------------------------------

    def _block_key(self, tokens: Sequence[int]) -> str:
        return DiskPrefixStore.block_key(tokens)

    def _spill_loop(self) -> None:
        while True:
            key, entry = self._spill_q.get()
            try:
                self._write_block(key, entry)
            except Exception:             # noqa: BLE001 — best-effort
                logger.exception("kv disk spill failed")
            finally:
                self._spill_q.task_done()

    def _note_bytes_saved(self, tier: str, entry) -> None:
        """Int8 byte economy: each tier move of an int8 entry counts the
        bf16-equivalent bytes it avoided holding or shipping
        (2·payload − (payload + scales)). No-op for float entries."""
        if entry.k.dtype != torch.int8:
            return
        payload = int(entry.k.nbytes) + int(entry.v.nbytes)
        QUANT_BYTES_SAVED_TOTAL.inc(max(0, 2 * payload - entry.nbytes),
                                    model=self.model, tier=tier)

    def _write_block(self, key: str, entry: _HostBlock) -> None:
        """The spill writer's side: the atomic, content-addressed disk
        write and, with a fleet prefix service attached, the publish to
        it, never under the store or paged locks."""
        if self.disk is not None \
                and self.disk.save(key, entry.tokens, entry.k, entry.v,
                                   entry.k_scale, entry.v_scale):
            KV_DISK_SPILLS_TOTAL.inc(model=self.model)
            FLIGHT.record("kv_disk_spill", model=self.model,
                          tokens=len(entry.tokens))
            self._note_bytes_saved("disk_spill", entry)
        if self.prefixd is not None:
            self.prefixd.publish(key, entry.tokens, entry.k, entry.v,
                                 entry.k_scale, entry.v_scale)

    def _enqueue_spill(self, key: str, entry: _HostBlock) -> None:
        if self._spill_q is None:
            return
        try:
            self._spill_q.put_nowait((key, entry))
        except queue.Full:
            self.spill_drops += 1

    def flush_spills(self) -> None:
        """Block until every queued disk write has landed (tests and an
        orderly shutdown; serving never waits on it)."""
        if self._spill_q is not None:
            self._spill_q.join()

    def _spill_prefix_entry(self, key: str, entry: _HostBlock) -> None:
        """Host-budget eviction of a prefix block: queue a disk spill when
        a disk store is attached, else the block is gone. Runs under the
        store lock, so it never touches the filesystem."""
        self._enqueue_spill(key, entry)

    def capture_leaf(self, tokens: Sequence[int], page: int) -> None:
        """A radix-cache leaf is about to be stripped
        (``RadixPrefixCache.evict``): keep its block in the host tier.
        Called under the store lock."""
        st = self.store
        if st.k is None:
            return
        key = self._block_key(tokens)
        if key in self.host.prefixes:
            return
        if self.disk is not None and self.disk.has(key):
            return        # already durable; skip the copy
        try:
            k, v, ks, vs = self._gather_host([page])
        except Exception:                 # noqa: BLE001 — best-effort
            logger.exception("prefix leaf capture failed")
            return
        self.host.put_prefix(
            key, _HostBlock(list(tokens), k[:, 0], v[:, 0],
                            None if ks is None else ks[:, 0],
                            None if vs is None else vs[:, 0]),
            spill_fn=self._spill_prefix_entry)
        self.demoted_prefix_pages += 1
        KV_DEMOTES_TOTAL.inc(model=self.model, kind="prefix")
        FLIGHT.record("kv_demote", model=self.model, what="prefix",
                      tokens=len(tokens))

    def persist_block(self, tokens: Sequence[int], page: int) -> None:
        """Insert-time persistence: a block newly cached in the radix tree
        writes through to disk (content-addressed: a block already there
        costs one stat), so a restarted process warms from the prefixes
        that were hot. Only the device-to-host copy happens here, under
        the store lock; the npz write (and the fleet publish) rides the
        spill queue."""
        if self.disk is None and self.prefixd is None:
            return
        key = self._block_key(tokens)
        if self.disk is not None and self.disk.has(key):
            return
        st = self.store
        if st.k is None:
            return
        try:
            k, v, ks, vs = self._gather_host([page])
        except Exception:                 # noqa: BLE001 — best-effort
            return
        self._enqueue_spill(
            key, _HostBlock([int(t) for t in tokens], k[:, 0], v[:, 0],
                            None if ks is None else ks[:, 0],
                            None if vs is None else vs[:, 0]))

    def extend_prefix(self, tokens: Sequence[int], cap: int) -> int:
        """Page tiered prefix blocks back into the radix tree: while the
        tree's page-aligned match of ``tokens`` can be extended by a block
        the host or disk tier holds, alloc a page, copy the block in and
        insert it. Returns the blocks restored. Called from
        SessionStore.match_prefix under the store lock."""
        st = self.store
        if st.k is None:
            return 0
        page = st.page
        restored = 0
        attempted: set = set()
        shrinks = 0
        while True:
            j = st.prefix_cache.match_len(tokens, cap) // page
            end = (j + 1) * page
            if end > min(len(tokens), cap):
                break
            prefix = [int(t) for t in tokens[:end]]
            key = self._block_key(prefix)
            if key in attempted:
                break                     # do not thrash a tiny pool
            attempted.add(key)
            blk = self.host.get_prefix(key)
            source = "host"
            if blk is None and self.disk is not None:
                loaded = self.disk.load(key, prefix)
                if loaded is not None:
                    blk = _HostBlock(prefix, *loaded)
                    source = "disk"
            if blk is None and self.prefixd is not None:
                # the fleet rung: the same restore-path design as the disk
                # read above (sessioned callers already wait on this
                # restore under the paged lock), and any failure degrades
                # to a miss
                fetched = self.prefixd.fetch(key, prefix)
                if fetched is not None:
                    blk = _HostBlock(prefix, *fetched)
                    source = "prefixd"
            if blk is None:
                break
            pages = st.alloc(1)
            if pages is None:
                break
            path = st.prefix_cache._walk(tokens, cap)
            if len(path) != j:
                # alloc's ladder strips radix leaves first and match_len
                # bumps no LRU stamp, so it can take the deepest node of
                # the path just matched; inserting at depth j would then
                # label this block's KV with block j-1's tokens. Release
                # and match again, a bounded number of times
                st._release(pages)
                attempted.discard(key)
                shrinks += 1
                if shrinks > 8:
                    break
                continue
            t0 = time.monotonic()
            try:
                self._scatter_device(
                    pages, blk.k[:, None], blk.v[:, None],
                    None if blk.k_scale is None else blk.k_scale[:, None],
                    None if blk.v_scale is None else blk.v_scale[:, None])
            except ValueError:
                # a block without scales against an int8 pool
                st._release(pages)
                self.restore_failures += 1
                break
            added = st.prefix_cache.insert(
                prefix, [nd.page for nd in path] + pages)
            if not added:
                st._release(pages)        # raced an insert; keep theirs
                continue
            # drop alloc's reference: the tree's must be the only one, or
            # the page stays pinned at refcount 2 and never evicts
            st._release(pages)
            restored += 1
            self.restored_prefix_pages += 1
            ms = (time.monotonic() - t0) * 1000
            KV_RESTORES_TOTAL.inc(model=self.model, kind="prefix",
                                  source=source)
            KV_RESTORE_MS.observe(ms, model=self.model, kind="prefix")
            costobs.charge_restore(self.model, ms, source=source)
            introspect.note_restore(ms, nbytes=int(blk.k.nbytes)
                                    + int(blk.v.nbytes))
        if restored:
            FLIGHT.record("kv_restore", model=self.model, what="prefix",
                          blocks=restored)
        return restored

    # -- reads -------------------------------------------------------------

    def demotable_bytes(self, page_bytes: int) -> int:
        """HBM bytes that could move to the host tier now without losing
        state: alloc's exact attainability count over every resident
        session (victim-exclusive pages plus the cache leaves that would
        strip), less the free list, bounded by the host budget's headroom.
        Pages an in-flight adopter holds are not counted."""
        st = self.store
        with st.lock:
            reclaimable = (st._attainable(list(st._sessions))
                           - len(st._free))
        return min(max(0, reclaimable) * page_bytes,
                   self.host.headroom())

    def stats(self) -> dict:
        return {
            "model": self.model,
            "host": self.host.stats(),
            "disk": self.disk.stats() if self.disk is not None else None,
            "demoted_sessions": self.demoted_sessions,
            "demoted_prefix_pages": self.demoted_prefix_pages,
            "restored_sessions": self.restored_sessions,
            "restored_prefix_pages": self.restored_prefix_pages,
            "restore_failures": self.restore_failures,
            "spill_queue": (self._spill_q.qsize()
                            if self._spill_q is not None else 0),
            "spill_drops": self.spill_drops,
            "prefixd": (self.prefixd.stats()
                        if self.prefixd is not None else None),
        }
