"""Device-memory headroom of the PyTorch port (port of
``quoracle_tpu/infra/resources.py``, the headroom signal only).

The admission controller (serving/admission.py) sheds bulk work while
the card's free memory falls under its threshold; this module gives it
that number. Sampling reads allocator counters only, so it never touches
RNG or device state.

Left for later slices: the per-engine HBM attribution and the scrape-time
collector (Queue 1 item 8), and ``effective_headroom_fraction``, which
adds the pages KV tiers could reclaim (Queue 1 item 7); without tiers the
JAX backend hands the controller the raw fraction, as here.
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
