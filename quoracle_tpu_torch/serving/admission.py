"""Structured serving rejects (port of ``quoracle_tpu/serving/admission.py``,
first part).

A row the serving layer refuses fails with an :class:`AdmissionError`
carrying a machine-readable reason and a retry hint; the backend maps it
to the row's error string. This copy holds the base class and
:class:`DeadlineExceededError`, which the baton batcher raises for a row
whose deadline lapsed while it waited; the admission controller and its
rate-limit and overload rejects come with the continuous batcher.
"""

from __future__ import annotations

from typing import Optional

from quoracle_tpu_torch.serving.qos import Priority, class_name


class AdmissionError(RuntimeError):
    """Structured reject: machine-readable reason + retry hint. The
    serving layer maps it to a failed row whose error string carries the
    same fields."""

    reason = "rejected"

    def __init__(self, message: str, retry_after_ms: int = 1000,
                 tenant: Optional[str] = None,
                 priority: Optional[Priority] = None):
        super().__init__(message)
        self.retry_after_ms = max(0, int(retry_after_ms))
        self.tenant = tenant
        self.priority = priority

    def as_dict(self) -> dict:
        return {
            "error": str(self),
            "reason": self.reason,
            "retry_after_ms": self.retry_after_ms,
            "tenant": self.tenant,
            "priority": (class_name(self.priority)
                         if self.priority is not None else None),
        }


class DeadlineExceededError(AdmissionError):
    """The row's deadline passed before it could be served. Retrying the
    SAME request is pointless — retry_after_ms is 0 by convention. The
    consensus engine treats this as a member miss, not a pool failure."""

    reason = "deadline"

    def __init__(self, message: str, tenant: Optional[str] = None,
                 priority: Optional[Priority] = None):
        super().__init__(message, retry_after_ms=0, tenant=tenant,
                         priority=priority)
