"""Live resource accounting of the PyTorch port (port of
``quoracle_tpu/infra/resources.py``): device-memory sampling, per-engine
memory attribution, and the scrape-time collector that feeds the gauges
in infra/telemetry.py.

The admission controller (serving/admission.py) sheds bulk work while
the card's free memory falls under its threshold; this module gives it
that number: the raw fraction, or under tiered KV
(serving/kvtier.py) ``effective_headroom_fraction``, which adds the pool
pages the tiers could demote without losing state.

``hbm_attribution`` names what holds the card's memory: per engine its
weights and KV page pool (session, prefix-cache and free pages), the
batch-1 speculative decoders' dense caches, the embedder's own weights
when it has them, each from the port's own byte counts; its ``device``
block sets those parts against the bytes the card reports in use
(``torch.cuda.mem_get_info``: everything resident, the CUDA context and
the caching allocator's reserve included) and books the remainder into
``other``, so the parts sum to the used bytes exactly.

Sampling reads allocator counters and host-side bookkeeping only, so it
never touches RNG or device state.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import torch

logger = logging.getLogger(__name__)

_PROC_T0 = time.monotonic()


def device_memory_stats() -> list[dict]:
    """One dict per visible CUDA device: bytes in use / limit / peak.

    ``bytes_in_use`` is ``torch.cuda.memory_allocated``: the bytes of live
    tensors, without the blocks the caching allocator keeps reserved for
    reuse. That matches the in-use count XLA reports (its allocator's
    free blocks are not in use either), so both packages shed at the same
    occupancy. ``bytes_limit`` is the card's total memory. With no CUDA
    device (the CPU) the list is empty."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append({
            "device": i,
            "platform": "gpu",
            "kind": props.name,
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "bytes_limit": int(props.total_memory),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
            "source": "memory_allocated",
        })
    return out


def headroom_fraction(devices: Optional[list[dict]] = None) -> Optional[float]:
    """min over limit-reporting devices of (limit - used) / limit, or
    None when no device reports a limit (CPU)."""
    devices = devices if devices is not None else device_memory_stats()
    fracs = [(d["bytes_limit"] - d["bytes_in_use"]) / d["bytes_limit"]
             for d in devices if d.get("bytes_limit")]
    return min(fracs) if fracs else None


def _kv_page_bytes(engine) -> int:
    """Pool bytes of one page at the engine's own per-token rate (int8
    payload and scales when quantized), so the headroom math counts what a
    demote actually moves."""
    return engine.kv_token_pool_bytes() * engine.sessions.page


def reclaimable_kv_bytes(backend) -> int:
    """Device bytes the tier ladder could free now without losing state:
    the demotable pool pages of tier-attached engines, each bounded by its
    tier's remaining host budget. Zero without tiers: evicting untiered
    pages destroys state, which is not headroom."""
    total = 0
    for e in (getattr(backend, "engines", None) or {}).values():
        tier = getattr(getattr(e, "sessions", None), "tier", None)
        if tier is None:
            continue
        try:
            total += tier.demotable_bytes(_kv_page_bytes(e))
        except Exception:                 # noqa: BLE001 — a signal only
            pass
    return total


def effective_headroom_fraction(backend) -> Optional[float]:
    """The admission controller's memory signal under tiers: the raw
    device headroom plus the demotable-page margin, capped at 1. Without a
    limit-reporting device (the CPU) it stays None, as the raw one."""
    devices = device_memory_stats()
    frac = headroom_fraction(devices)
    if frac is None:
        return None
    reclaim = reclaimable_kv_bytes(backend)
    if reclaim:
        limit = min(d["bytes_limit"] for d in devices
                    if d.get("bytes_limit"))
        frac = min(1.0, frac + reclaim / limit)
    return frac


def process_stats() -> dict:
    """Self-observation block: uptime, threads, open fds, current RSS."""
    import os

    from quoracle_tpu_torch.infra.telemetry import open_fd_count

    rss_mb = None
    try:
        with open("/proc/self/statm") as f:
            rss_mb = round(int(f.read().split()[1])
                           * os.sysconf("SC_PAGE_SIZE") / (1024 * 1024), 1)
    except (OSError, IndexError, ValueError):
        pass
    return {
        "pid": os.getpid(),
        "uptime_s": round(time.monotonic() - _PROC_T0, 1),
        "threads": threading.active_count(),
        "open_fds": open_fd_count(),
        "rss_mb": rss_mb,
    }


def _tensor_bytes(seen: set, *tensors) -> int:
    """Bytes of the tensors' storages not counted before (``seen`` holds
    storage pointers): shared weights, a self-draft's engine and an
    embedder over a member's weights count once."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        try:
            st = t.untyped_storage()
            key = (t.device.type, st.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            total += int(st.nbytes())
        except Exception:                 # noqa: BLE001 — partial is fine
            continue
    return total


def _module_bytes(seen: set, module) -> int:
    return _tensor_bytes(seen, *module.parameters(), *module.buffers())


def device_used_bytes(device=None) -> Optional[int]:
    """Bytes in use on the card as CUDA reports them (total - free
    from ``torch.cuda.mem_get_info``), or None for a CPU device."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", 0) if torch.cuda.is_available() else None)
    if dev is None or dev.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    return int(total - free)


def hbm_attribution(backend) -> dict:
    """Per-engine memory attribution: weights bytes, KV page-pool bytes
    (split into session-held, prefix-cache-held and free pages), tier
    rows, and the roles of the engines (pool member, draft, aux).
    Backends without engines (MockBackend) attribute nothing.

    ``device`` (None off the card) sets the named parts — each storage
    counted once — against the card's used bytes: ``parts`` plus
    ``other`` equal ``used_bytes`` exactly, and no part is negative
    (``other`` would go negative only if the parts counted a storage
    twice, which the dedup prevents; it is clamped at 0 and
    ``consistent`` is then False)."""
    members = {}
    engines = getattr(backend, "engines", None) or {}
    pool = set(getattr(backend, "pool", None) or ())
    draft_map = dict(getattr(backend, "draft_map", None) or {})
    draft_for = {d: t for t, d in draft_map.items()}
    seen: set = set()
    parts: dict = {}
    dev = None

    def add_part(name: str, nbytes: int) -> None:
        if nbytes > 0:
            parts[name] = parts.get(name, 0) + int(nbytes)

    # batch-1 speculative decoders hold DENSE session caches (target and
    # draft per resident session) outside any engine's page pool; they
    # are attributed to their TARGET member
    spec_cache = {}
    for tspec, dec in (getattr(backend, "_spec_decoders", None)
                       or {}).items():
        try:
            with dec.lock:
                sess = list(dec._sessions.values())
            n_b = sum(int(s[w].k.nbytes) + int(s[w].v.nbytes)
                      for s in sess for w in ("t", "d"))
            dev_b = _tensor_bytes(seen, *(c for s in sess
                                          for w in ("t", "d")
                                          for c in (s[w].k, s[w].v)))
            add_part("spec_cache", dev_b)
            spec_cache[tspec] = {"bytes": n_b, "sessions": len(sess)}
        except Exception:             # noqa: BLE001 — partial is fine
            logger.exception("spec cache attribution failed for %s", tspec)
    for spec, e in engines.items():
        try:
            if dev is None:
                dev = getattr(e, "device", None)
            params_b = sum(int(t.numel() * t.element_size())
                           for t in (*e.params.parameters(),
                                     *e.params.buffers()))
            st = e.sessions
            page_b = _kv_page_bytes(e)
            pool_b = 0
            if st.k is not None:
                pool_b = int(st.k.nbytes) + int(st.v.nbytes)
                if st.k_scale is not None:
                    pool_b += (int(st.k_scale.nbytes)
                               + int(st.v_scale.nbytes))
            with st.lock:
                free = len(st._free)
                n_sessions = len(st._sessions)
                occ = st.prefix_cache.occupancy()
            # page 0 is scratch; used = allocated (non-free, non-scratch)
            used_pages = st.n_pages - 1 - free
            # role: pool member, speculative draft (its weights exist to
            # accelerate ``draft_for``), or aux (e.g. an embed model)
            role = ("member"
                    if not pool or spec in pool
                    or spec.rsplit("@", 1)[-1] in pool
                    else "draft" if spec in draft_for else "aux")
            add_part("draft_params" if role == "draft" else "params",
                     _module_bytes(seen, e.params))
            add_part("kv_pool", _tensor_bytes(seen, st.k, st.v,
                                              st.k_scale, st.v_scale))
            members[spec] = {
                "role": role,
                **({"draft_for": draft_for[spec]}
                   if spec in draft_for else {}),
                "params_bytes": params_b,
                "kv_pool_bytes": pool_b,
                "kv_pool_pages": st.n_pages,
                "kv_page_bytes": page_b,
                "kv_used_pages": used_pages,
                "kv_used_bytes": used_pages * page_b,
                "kv_free_pages": free,
                "prefix_cache_pages": occ["resident_pages"],
                "prefix_cache_bytes": occ["resident_pages"] * page_b,
                "prefix_cache": occ,
                "sessions": n_sessions,
            }
            # tiered KV: host/disk tier rows beside the device rows
            tier = getattr(st, "tier", None)
            if tier is not None:
                ts = tier.stats()
                members[spec]["kv_host_bytes"] = ts["host"]["bytes"]
                members[spec]["kv_host_budget_bytes"] = \
                    ts["host"]["budget_bytes"]
                members[spec]["kv_host_sessions"] = ts["host"]["sessions"]
                members[spec]["kv_host_prefix_blocks"] = \
                    ts["host"]["prefix_blocks"]
                if ts["disk"] is not None:
                    members[spec]["kv_disk_bytes"] = ts["disk"]["bytes"]
                    members[spec]["kv_disk_entries"] = \
                        ts["disk"]["entries"]
                members[spec]["kv_demotable_bytes"] = \
                    tier.demotable_bytes(page_b)
            if spec in spec_cache:
                members[spec]["spec_cache_bytes"] = \
                    spec_cache[spec]["bytes"]
                members[spec]["spec_cache_sessions"] = \
                    spec_cache[spec]["sessions"]
        except Exception:                 # noqa: BLE001 — partial is fine
            logger.exception("hbm attribution failed for %s", spec)
    emb = getattr(backend, "embedder", None)
    emb_params = getattr(emb, "params", None)
    embed = None
    if isinstance(emb_params, torch.nn.Module):
        own = _module_bytes(seen, emb_params)
        add_part("embedder_params", own)
        cache = getattr(emb, "cache", None)
        embed = {"params_bytes": own,
                 "cache_entries": len(cache) if cache is not None else 0,
                 "cache_host_bytes": (len(cache) * 4 * emb.cfg.dim
                                      if cache is not None else 0)}
    totals = {
        "params_bytes": sum(m["params_bytes"] for m in members.values()),
        "kv_pool_bytes": sum(m["kv_pool_bytes"] for m in members.values()),
        "prefix_cache_bytes": sum(m["prefix_cache_bytes"]
                                  for m in members.values()),
        "draft_params_bytes": sum(
            m["params_bytes"] for m in members.values()
            if m.get("role") == "draft"),
        "spec_cache_bytes": sum(m.get("spec_cache_bytes", 0)
                                for m in members.values()),
        "kv_host_bytes": sum(m.get("kv_host_bytes", 0)
                             for m in members.values()),
        "kv_disk_bytes": sum(m.get("kv_disk_bytes", 0)
                             for m in members.values()),
        "kv_demotable_bytes": sum(m.get("kv_demotable_bytes", 0)
                                  for m in members.values()),
    }
    device = None
    used = device_used_bytes(dev) if dev is not None else None
    if used is not None:
        named = sum(parts.values())
        device = {"used_bytes": used, "parts": dict(sorted(parts.items())),
                  "other": max(0, used - named),
                  "consistent": named <= used}
    return {"members": members, "totals": totals, "embedder": embed,
            "device": device}


class ResourceCollector:
    """The scrape-time sampler a process registers on METRICS
    (``METRICS.register_collector``) for a backend: refreshes the device
    memory, attribution, prefix-cache, tier and compile-storm gauges from
    live state, and drops a rate-limited ``resource_sample`` event into
    the flight recorder so a later dump shows the memory trajectory."""

    def __init__(self, backend, min_sample_gap_s: float = 1.0):
        self.backend = backend
        self.min_sample_gap_s = min_sample_gap_s
        self._last_sample = 0.0

    def __call__(self) -> None:
        from quoracle_tpu_torch.infra.flightrec import FLIGHT
        from quoracle_tpu_torch.infra.telemetry import (
            HBM_COMPONENT_BYTES, HBM_HEADROOM_RATIO, HBM_LIMIT_BYTES,
            HBM_USED_BYTES, KV_TIER_BYTES, KV_TIER_ENTRIES,
            PREFIX_CACHE_PAGES,
        )

        devices = device_memory_stats()
        for d in devices:
            HBM_USED_BYTES.set(d["bytes_in_use"], device=d["device"])
            if d["bytes_limit"]:
                HBM_LIMIT_BYTES.set(d["bytes_limit"], device=d["device"])
        frac = headroom_fraction(devices)
        HBM_HEADROOM_RATIO.set(frac if frac is not None else -1.0)

        attribution = hbm_attribution(self.backend)
        for spec, m in attribution["members"].items():
            HBM_COMPONENT_BYTES.set(m["params_bytes"], model=spec,
                                    component="params")
            HBM_COMPONENT_BYTES.set(m["kv_pool_bytes"], model=spec,
                                    component="kv_pool")
            HBM_COMPONENT_BYTES.set(m["prefix_cache_bytes"], model=spec,
                                    component="prefix_cache")
            if "spec_cache_bytes" in m:
                HBM_COMPONENT_BYTES.set(m["spec_cache_bytes"], model=spec,
                                        component="spec_cache")
            occ = m["prefix_cache"]
            PREFIX_CACHE_PAGES.set(occ["resident_pages"], model=spec,
                                   kind="resident")
            PREFIX_CACHE_PAGES.set(occ["referenced_pages"], model=spec,
                                   kind="referenced")
            PREFIX_CACHE_PAGES.set(occ["evictable_leaf_pages"],
                                   model=spec, kind="evictable")
            if "kv_host_bytes" in m:
                KV_TIER_BYTES.set(m["kv_used_bytes"], model=spec,
                                  tier="hbm")
                KV_TIER_BYTES.set(m["kv_host_bytes"], model=spec,
                                  tier="host")
                KV_TIER_BYTES.set(m.get("kv_disk_bytes", 0), model=spec,
                                  tier="disk")
                KV_TIER_ENTRIES.set(m["sessions"], model=spec,
                                    tier="hbm", kind="session")
                KV_TIER_ENTRIES.set(m["kv_host_sessions"], model=spec,
                                    tier="host", kind="session")
                KV_TIER_ENTRIES.set(m["kv_host_prefix_blocks"],
                                    model=spec, tier="host",
                                    kind="prefix")
                KV_TIER_ENTRIES.set(m.get("kv_disk_entries", 0),
                                    model=spec, tier="disk",
                                    kind="prefix")
        # storm gauges decay with time, not traffic: refresh so a storm
        # that ended reads 0 at the next scrape
        for e in (getattr(self.backend, "engines", None) or {}).values():
            compiles = getattr(e, "compiles", None)
            if compiles is not None:
                compiles.refresh()

        now = time.monotonic()
        if now - self._last_sample >= self.min_sample_gap_s:
            self._last_sample = now
            FLIGHT.record(
                "resource_sample",
                headroom_frac=frac,
                bytes_in_use=sum(d["bytes_in_use"] for d in devices),
                devices=len(devices),
                members={spec: {"kv_free_pages": m["kv_free_pages"],
                                "prefix_cache_pages":
                                    m["prefix_cache_pages"],
                                "sessions": m["sessions"]}
                         for spec, m in attribution["members"].items()})
