"""Deadline-aware admission control: the decision whether a request may
enter the serving queue at all — counterpart of
``pathway_tpu/serving/admission.py``, copied as is (stdlib only).

Checks run in shed-priority order — draining beats everything (the
endpoint is going away), then the queue bound (the overload signal),
then the per-endpoint concurrency cap, then the token-bucket rate
limit. Every refusal carries an HTTP status and a ``Retry-After`` hint
so clients back off instead of hammering a saturated endpoint.
"""

from __future__ import annotations

import threading
import time
import weakref

from pathway_tpu_torch.serving import metrics as _metrics
from pathway_tpu_torch.serving.config import QoSConfig


class ShedError(Exception):
    """Request refused admission — explicit load shedding."""

    def __init__(self, status: int, reason: str, retry_after_s: float):
        super().__init__(f"shed ({reason}): retry after {retry_after_s:.3f}s")
        self.status = status
        self.reason = reason
        self.retry_after_s = max(0.0, float(retry_after_s))


class DeadlineExceeded(Exception):
    """The request's deadline passed before its work could run."""


class TokenBucket:
    """Monotonic-clock token bucket; not thread-safe by itself (the
    admission controller serializes access)."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self._last = time.monotonic()

    def try_acquire(self, now: float | None = None) -> float:
        """0.0 = token taken; otherwise seconds until one accrues."""
        if now is None:
            now = time.monotonic()
        self.tokens = min(
            self.burst, self.tokens + (now - self._last) * self.rate
        )
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


# seconds a shared-path shed keeps the endpoint "under pressure" for
# the tenant fair-share clamp.  The instantaneous signal alone
# oscillates under sustained overload (the shared bucket saw-tooths
# around one accrued token), and every pressure-False instant would let
# the hot tenant through the tenant gate to steal the fresh token —
# stickiness keeps the clamp engaged while the endpoint actually sheds,
# and relaxes within a second of the overload ending.
PRESSURE_STICKY_S = 1.0


class AdmissionController:
    """Per-endpoint admission state: queue depth, in-flight count, rate
    limiter, drain flag. ``admit`` raises ``ShedError``; callers pair it
    with ``on_flushed`` (requests left the queue) and ``complete`` (the
    response went out)."""

    def __init__(self, config: QoSConfig, route: str = "/", ledger=None):
        self.config = config
        self.route = route
        # Tenant Weave: an optional serving.tenancy.TenantLedger makes
        # admission tenant-aware — per-tenant fair-share buckets shed
        # the over-share tenant (429 tenant_rate) BEFORE it can drain
        # the shared queue/bucket.  None (the default) keeps this
        # controller byte-identical to the tenant-blind path.  A
        # SurgeGate drives its ledger itself (it also needs the WFQ
        # ordering tag and queue-full eviction); replicas pass one here.
        self.ledger = ledger
        self._lock = threading.Lock()
        self.queued = 0
        self.inflight = 0
        self.draining = False
        self._bucket = (
            TokenBucket(config.rate_limit_rps, config.burst())
            if config.rate_limit_rps
            else None
        )
        self._idle = threading.Event()
        self._idle.set()
        self._pressure_at: float | None = None  # last shared-path shed
        self._m_shed = _metrics.shed_counter()
        self._m_admitted = _metrics.admitted_counter().labels(route)
        # the process-wide registry holds these callbacks forever: keep
        # the controller weakly referenced so a torn-down endpoint's
        # admission state can be collected (the gauge then reads 0)
        ref = weakref.ref(self)

        def _queued_now() -> int:
            ctl = ref()
            return ctl.queued if ctl is not None else 0

        def _inflight_now() -> int:
            ctl = ref()
            return ctl.inflight if ctl is not None else 0

        _metrics.queue_depth_gauge().labels(route).set_function(_queued_now)
        _metrics.inflight_gauge().labels(route).set_function(_inflight_now)

    def _shed(
        self,
        status: int,
        reason: str,
        retry_after_s: float,
        now: float | None = None,
    ):
        self._pressure_at = time.monotonic() if now is None else now
        self._m_shed.labels(self.route, reason).inc()
        raise ShedError(status, reason, retry_after_s)

    def under_pressure(self, now: float | None = None) -> bool:
        """Contention signal for the tenant fair-share clamp: the
        endpoint shed on the shared path within the last
        ``PRESSURE_STICKY_S`` seconds, the shared token bucket is
        (about to be) empty, or the queue is half full.  While False
        the per-tenant buckets stay dormant — fair admission is
        work-conserving, a lone hot tenant on an idle endpoint keeps
        its full throughput."""
        if now is None:
            now = time.monotonic()
        if (
            self._pressure_at is not None
            and now - self._pressure_at < PRESSURE_STICKY_S
        ):
            return True
        if self.queued >= max(1, self.config.max_queue // 2):
            return True
        b = self._bucket
        if b is None:
            return False
        # read-only refill projection (consume nothing)
        return min(b.burst, b.tokens + (now - b._last) * b.rate) < 1.0

    def headroom_besides_queue(self, now: float | None = None) -> bool:
        """True when the queue bound is the ONLY thing that would shed
        an arrival right now.  The gate's queue-full tenant eviction
        gates on this: destroying a queued (already-admitted) request
        in exchange for an arrival the bucket or concurrency cap would
        shed anyway loses BOTH requests."""
        if self.draining:
            return False
        cfg = self.config
        if (
            cfg.max_inflight is not None
            and self.inflight >= cfg.max_inflight
        ):
            return False
        b = self._bucket
        if b is None:
            return True
        if now is None:
            now = time.monotonic()
        # read-only projection; the admit that follows consumes the
        # real token (a lost race costs one extra eviction, bounded)
        return min(b.burst, b.tokens + (now - b._last) * b.rate) >= 1.0

    def admit(
        self,
        now: float | None = None,
        tenant: str | None = None,
        tenant_class: str | None = None,
    ) -> None:
        cfg = self.config
        if now is None:
            now = time.monotonic()
        tag = None
        if self.ledger is not None:
            # per-tenant fair share first: a shed here is charged to
            # the hot tenant and never consumes a shared bucket token
            # (the ledger itself counts it on the route-level shed
            # family, so gate- and replica-path sheds report alike)
            tag = self.ledger.admit(
                tenant,
                tenant_class,
                now,
                pressure=self.under_pressure(now),
            )
        try:
            with self._lock:
                if self.draining:
                    self._shed(503, "draining", cfg.drain_grace_s, now)
                if self.queued >= cfg.max_queue:
                    # the queue clears one micro-batch per flush window —
                    # hint a backoff of one full wait window
                    self._shed(
                        429,
                        "queue_full",
                        max(cfg.max_wait_ms / 1000.0, 0.05),
                        now,
                    )
                if (
                    cfg.max_inflight is not None
                    and self.inflight >= cfg.max_inflight
                ):
                    self._shed(
                        429,
                        "concurrency",
                        max(cfg.max_wait_ms / 1000.0, 0.05),
                        now,
                    )
                if self._bucket is not None:
                    wait = self._bucket.try_acquire(now)
                    if wait > 0.0:
                        self._shed(429, "rate_limit", wait, now)
                self.queued += 1
                self.inflight += 1
                self._idle.clear()
        except ShedError:
            if self.ledger is not None:
                # shed on the SHARED path: the request never entered
                # the queue, so the tenant's fair-share charge comes
                # back (see TenantLedger.refund)
                self.ledger.refund(tenant, tenant_class, tag)
            raise
        if self.ledger is not None:
            self.ledger.commit(tenant)
        self._m_admitted.inc()

    def on_flushed(self, n: int) -> None:
        with self._lock:
            self.queued = max(0, self.queued - n)

    def complete(self) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight - 1)
            if self.inflight == 0:
                self._idle.set()

    def start_drain(self) -> None:
        with self._lock:
            self.draining = True
            if self.inflight == 0:
                self._idle.set()

    def wait_idle(self, timeout: float | None) -> bool:
        """Block until no request is in flight (drain helper)."""
        return self._idle.wait(timeout)
