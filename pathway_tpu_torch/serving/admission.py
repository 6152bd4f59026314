"""Admission refusals — counterpart of ``pathway_tpu/serving/admission.py``
(own copy of its two exception types). The ``AdmissionController`` with its
token bucket and metrics belongs to the replica's REST gate, which is not
ported yet."""

from __future__ import annotations


class ShedError(Exception):
    """Request refused admission — explicit load shedding."""

    def __init__(self, status: int, reason: str, retry_after_s: float):
        super().__init__(f"shed ({reason}): retry after {retry_after_s:.3f}s")
        self.status = status
        self.reason = reason
        self.retry_after_s = max(0.0, float(retry_after_s))


class DeadlineExceeded(Exception):
    """The request's deadline passed before its work could run."""
