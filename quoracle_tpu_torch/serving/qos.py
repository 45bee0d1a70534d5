"""Priority classes (port of ``quoracle_tpu/serving/qos.py``, first part).

The baton batcher (models/runtime.py) serves a drain's submissions in
priority order when a failed merged batch is retried per submission; the
consensus layer stamps each row with its class. This copy holds the
classes and their coercion only: the weighted-fair queue, the token
buckets and the QoS configuration come with the continuous batcher.
"""

from __future__ import annotations

import enum
from typing import Any


class Priority(enum.IntEnum):
    """QoS classes, most urgent first (lower value = served sooner).

    INTERACTIVE — a human is waiting (dashboard submissions, root task
    messages). AGENT — root/near-root agents' consensus turns (the
    latency-critical tool-calling tier). BATCH — deep subtree fan-out
    work. BACKGROUND — condensation, reflection, prefetch: work nobody
    is waiting on.
    """

    INTERACTIVE = 0
    AGENT = 1
    BATCH = 2
    BACKGROUND = 3


def class_name(priority: Any) -> str:
    """Metric-label form of a priority ('interactive', …); tolerates raw
    ints and unknown values (clamped into the enum range)."""
    try:
        return Priority(int(priority)).name.lower()
    except (ValueError, TypeError):
        return Priority.BATCH.name.lower()


def coerce_priority(priority: Any,
                    default: Priority = Priority.AGENT) -> Priority:
    """None/ints/enum members → a Priority, clamped into range (an
    out-of-range int from a remote caller must not crash admission)."""
    if priority is None:
        return default
    try:
        v = int(priority)
    except (TypeError, ValueError):
        return default
    return Priority(min(max(v, Priority.INTERACTIVE), Priority.BACKGROUND))
