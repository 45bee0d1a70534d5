"""Device-memory headroom of the PyTorch port (port of
``quoracle_tpu/infra/resources.py``, the headroom signals only).

The admission controller (serving/admission.py) sheds bulk work while
the card's free memory falls under its threshold; this module gives it
that number: the raw fraction, or under tiered KV
(serving/kvtier.py) ``effective_headroom_fraction``, which adds the pool
pages the tiers could demote without losing state. Sampling reads
allocator counters and host-side bookkeeping only, so it never touches
RNG or device state.

Left for later slices: the per-engine HBM attribution and the scrape-time
collector (Queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional

import torch


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
