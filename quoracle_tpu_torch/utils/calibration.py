"""Measured gates for the paged-attention tiers (port of
``quoracle_tpu/utils/calibration.py``).

The sessioned engine serves through three tiers: the unified ragged
kernel, the direct paged kernels (a suffix chunk and decode steps read
the resident pages in place), and the gather programs (resident pages
copied into a dense working cache). Where each wins is a property of the
deployment (launch cost, host speed, lengths), not of the code, so the
thresholds are DATA, read from a calibration file:

  * ``load_paged_gates()`` reads the file (env override
    ``QUORACLE_PAGED_CALIB``; default ``default_calib_path()``);
  * absent a file the direct paths stay off, and the unified gate is AUTO
    (on for a CUDA engine, off for a CPU engine, where the gather programs
    serve and tests opt in explicitly).

File format (JSON), the JAX package's: {"decode_min_resident": int|null,
"prefill_min_resident": int|null, "prefill_max_chunk": int,
"unified_min_resident": int|null (absent = AUTO), "measured_on": str,
"device_kind": str} — null disables that path. A file whose recorded
``device_kind`` differs from the engine device's (``device_kind()``) is
ignored.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
from typing import Optional

import torch

_OFF = 1 << 30


@dataclasses.dataclass(frozen=True)
class PagedGates:
    """Max-prompt-token thresholds enabling the direct paged paths;
    ``_OFF`` (2**30) disables. ``prefill_max_chunk`` bounds the dense
    O(T²) intra-chunk piece of the direct prefill. ``unified_min_resident``
    gates the unified ragged kernel: ``None`` is AUTO (see
    ``resolve_unified_gate``)."""

    decode_min_resident: int = _OFF
    prefill_min_resident: int = _OFF
    prefill_max_chunk: int = 1024
    unified_min_resident: Optional[int] = None
    source: str = "default (no calibration file)"


def default_calib_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "quoracle_tpu_torch", "paged_gates.json")


def device_kind(device) -> str:
    """The device name a calibration file records: the CUDA device's
    name, or ``"cpu"`` (the JAX CPU backend's ``device_kind``)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def load_paged_gates(path: Optional[str] = None,
                     device="cpu") -> PagedGates:
    """The gates for an engine on ``device``: the calibration file at
    ``path`` (else ``$QUORACLE_PAGED_CALIB``, else the default path), or
    the defaults when it is missing, unreadable, or measured on another
    kind of device."""
    p = (path or os.environ.get("QUORACLE_PAGED_CALIB")
         or default_calib_path())
    try:
        with open(p) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError):
        return PagedGates()

    recorded = raw.get("device_kind") or ""
    current = device_kind(device)
    if recorded and recorded != current:
        logging.getLogger(__name__).warning(
            "ignoring paged-gate calibration %s: measured on %r, running "
            "on %r", p, recorded, current)
        return PagedGates(
            source=f"default (calibration {p} is for {recorded!r}, "
                   f"not {current!r})")

    def gate(key: str) -> int:
        v = raw.get(key)
        return _OFF if v is None else int(v)

    # unified gate: ABSENT key = AUTO; explicit JSON null = measured off
    _absent = object()
    u = raw.get("unified_min_resident", _absent)
    unified = None if u is _absent else (_OFF if u is None else int(u))
    return PagedGates(
        decode_min_resident=gate("decode_min_resident"),
        prefill_min_resident=gate("prefill_min_resident"),
        prefill_max_chunk=int(raw.get("prefill_max_chunk", 1024)),
        unified_min_resident=unified,
        source=p,
    )


def resolve_unified_gate(gates: PagedGates, device) -> int:
    """The unified kernel's effective threshold: an explicit value wins;
    AUTO is on (0) for a CUDA engine and off for a CPU engine."""
    if gates.unified_min_resident is not None:
        return int(gates.unified_min_resident)
    return 0 if torch.device(device).type == "cuda" else _OFF


_UNSET = object()


def save_paged_gates(path: Optional[str], *, decode_min_resident,
                     prefill_min_resident, prefill_max_chunk: int = 1024,
                     unified_min_resident=_UNSET,
                     device_kind: str = "", note: str = "") -> str:
    """Write a calibration file. ``unified_min_resident`` omitted = the
    key is left out (AUTO on load); explicit None = off (JSON null)."""
    p = path or default_calib_path()
    os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
    payload = {
        "decode_min_resident": decode_min_resident,
        "prefill_min_resident": prefill_min_resident,
        "prefill_max_chunk": prefill_max_chunk,
        "device_kind": device_kind,
        "note": note,
        "measured_on": datetime.datetime.now(
            datetime.timezone.utc).isoformat(),
    }
    if unified_min_resident is not _UNSET:
        payload["unified_min_resident"] = unified_min_resident
    with open(p, "w") as f:
        json.dump(payload, f, indent=1)
    return p
