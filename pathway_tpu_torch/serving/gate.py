"""SurgeGate — the serving QoS layer between REST ingress and the
engine tick (counterpart of ``pathway_tpu/serving/gate.py``).

One gate per rest_connector endpoint. The REST handler builds a
``PendingRequest`` and calls ``submit``: admission control (bounded
queue, per-endpoint concurrency cap, token-bucket rate limit) may shed
it with an explicit 429/503 + Retry-After; otherwise it joins the
micro-batcher's EDF queue and, at flush, the whole release is inserted
atomically into the endpoint's ``InputSession`` so a single engine tick
(and a single embed/KNN batch on the card) carries it. ``drain`` stops
admission, flushes in-flight batches, waits for every admitted request
to finish, and then the webserver can shut down cleanly.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any

from pathway_tpu_torch.serving import deadline as _deadline
from pathway_tpu_torch.serving import metrics as _metrics
from pathway_tpu_torch.serving.admission import (
    AdmissionController,
    DeadlineExceeded,
    ShedError,
)
from pathway_tpu_torch.serving.batcher import MicroBatcher
from pathway_tpu_torch.serving.config import QoSConfig

# all live gates of this process (drain_all / debug); weak so cleared
# graphs release their gates without an explicit unregister
_GATES: "weakref.WeakSet[SurgeGate]" = weakref.WeakSet()
_GATES_LOCK = threading.Lock()

INTERACTIVE_PRIORITY = 0  # InputSession.priority value for gated queries

# PendingRequest lifecycle. The handler's teardown (client may have
# disconnected while the request sat in the batcher queue) and the
# batcher's flush race on the same request from two threads; the state
# transition decides, atomically, whether the request reaches the
# engine (DISPATCHED) or is forgotten (ABANDONED) — never both.
_PENDING = 0
_DISPATCHED = 1
_ABANDONED = 2


class PendingRequest:
    """One admitted-or-not REST request crossing the gate."""

    __slots__ = (
        "key",
        "vals",
        "deadline",
        "enqueued_at",
        "loop",
        "dispatched",
        "tenant",
        "tenant_class",
        "order",
        "_state",
        "_state_lock",
    )

    def __init__(
        self,
        key: int,
        vals: tuple,
        deadline: float,
        loop: Any = None,
        dispatched: Any = None,
        tenant: str | None = None,
        tenant_class: str | None = None,
    ):
        self.key = key
        self.vals = vals
        self.deadline = float(deadline)
        self.enqueued_at = time.monotonic()
        # Tenant Weave: identity from the x-pathway-tenant header and
        # the batcher's order key — plain EDF (the deadline) unless the
        # route's ledger stamps a weighted-fair (vfinish, deadline) tag
        self.tenant = tenant
        self.tenant_class = tenant_class
        self.order: Any = self.deadline
        # asyncio plumbing: `dispatched` resolves (with the batch size)
        # when the micro-batcher releases the request into the engine,
        # or errors with DeadlineExceeded/ShedError when it is dropped
        self.loop = loop
        self.dispatched = dispatched
        self._state = _PENDING
        self._state_lock = threading.Lock()

    @property
    def was_dispatched(self) -> bool:
        return self._state == _DISPATCHED

    def try_mark_dispatched(self) -> bool:
        """Batcher side: claim the request for dispatch. False means
        the handler abandoned it — skip it entirely."""
        with self._state_lock:
            if self._state == _ABANDONED:
                return False
            self._state = _DISPATCHED
            return True

    def abandon(self) -> bool:
        """Handler side: True iff the request never reached (and now
        never will reach) the engine, so the handler owes no
        dispatch-window slot; False = it was dispatched."""
        with self._state_lock:
            if self._state == _DISPATCHED:
                return False
            self._state = _ABANDONED
            return True

    def resolve_dispatched(self, batch_size: int) -> None:
        if self.loop is None or self.dispatched is None:
            return
        fut = self.dispatched

        def _set() -> None:
            if not fut.done():
                fut.set_result(batch_size)

        try:
            self.loop.call_soon_threadsafe(_set)
        except RuntimeError:
            pass  # loop already closed (server shutting down)

    def reject(self, exc: BaseException) -> None:
        if self.loop is None or self.dispatched is None:
            return
        fut = self.dispatched

        def _set() -> None:
            if not fut.done():
                fut.set_exception(exc)

        try:
            self.loop.call_soon_threadsafe(_set)
        except RuntimeError:
            pass


class SurgeGate:
    def __init__(
        self,
        config: QoSConfig,
        session: Any,
        route: str = "/",
        webserver: Any = None,
    ):
        self.config = config
        self.session = session
        self.route = route
        self.webserver = webserver
        self.admission = AdmissionController(config, route)
        self._m_wait = _metrics.queue_wait_histogram().labels(route)
        self._m_batch_rows = _metrics.batch_rows_histogram().labels(route)
        self._m_occupancy = _metrics.occupancy_histogram()
        self._m_expired = _metrics.expired_counter().labels("gate")
        self._closed = False
        # Tenant Weave (PATHWAY_TENANT_QOS=1): per-tenant fair-share
        # buckets + weighted-fair EDF ordering + queue-full eviction
        # that charges the hot tenant.  None = tenant-blind plane,
        # byte-identical to the pre-tenancy gate.
        from pathway_tpu_torch.serving import tenancy as _tenancy

        self.ledger = _tenancy.ledger_for(config, route)
        # dispatch window: requests released into the engine but whose
        # response has not gone out yet; the batcher holds further
        # releases while the window is full so overload accumulates in
        # the bounded admission queue, not the InputSession
        self._disp_lock = threading.Lock()
        self._dispatched_pending = 0
        self.batcher = _make_batcher(self)
        if getattr(session, "priority", None) is not None and (
            config.priority == "interactive"
        ):
            session.priority = INTERACTIVE_PRIORITY
            # the scheduler's hot-check: queries waiting in the batcher
            # are about to land in this session, so bulk sessions should
            # already be deferring (session.has_data() alone only sees
            # rows AFTER a flush). Closes over the admission controller,
            # not the gate — sessions outlive runs (G.last_runtime) and
            # must not pin the gate (and its batcher thread) with them.
            admission = self.admission
            session.backlog = lambda: admission.queued
        with _GATES_LOCK:
            _GATES.add(self)

    # --- ingress ----------------------------------------------------------

    def submit(self, req: PendingRequest) -> None:
        """Admit + enqueue. Raises ShedError (shed with a status and a
        Retry-After) or DeadlineExceeded (budget already spent)."""
        now = time.monotonic()
        if req.deadline <= now:
            self._m_expired.inc()
            raise DeadlineExceeded()
        if self.ledger is not None:
            # per-tenant fair share (shed charged to the hot tenant)
            # + the weighted-fair EDF tag the batcher orders on
            tag = self.ledger.admit(
                req.tenant,
                req.tenant_class,
                now,
                pressure=self.admission.under_pressure(now),
            )
            req.order = (tag, req.deadline)
            if (
                self.admission.queued >= self.config.max_queue
                # only when the queue is the SOLE binding constraint:
                # evicting a queued request for an arrival the bucket
                # or concurrency cap would shed anyway loses both
                and self.admission.headroom_besides_queue(now)
            ):
                # full queue: evict the MOST over-share tenant's queued
                # request instead of shedding this arrival — the shed
                # lands on the noisy neighbor, never the queue tail.
                # (If the arrival itself is the hottest, pick_victim
                # returns None and the normal queue_full shed applies.)
                victim = self.batcher.steal(
                    lambda queued: self.ledger.pick_victim(queued, tag)
                )
                if victim is not None:
                    self.ledger.count_evicted(victim.tenant)
                    self._reject(
                        victim,
                        ShedError(
                            429,
                            "tenant_evict",
                            max(self.config.max_wait_ms / 1000.0, 0.05),
                        ),
                    )
        try:
            self.admission.admit(now)
        except ShedError:
            if self.ledger is not None:
                # shed on the SHARED path: the request never entered
                # the queue, so the tenant's fair-share charge comes
                # back — retrying into a full queue must not drain the
                # tenant's own budget (see TenantLedger.refund)
                self.ledger.refund(req.tenant, req.tenant_class, tag)
            raise
        if self.ledger is not None:
            self.ledger.commit(req.tenant)
        req.enqueued_at = now
        _deadline.register(req.key, req.deadline)
        try:
            self.batcher.put(req)
        except RuntimeError:
            # the request never entered the queue: undo BOTH admission
            # counters (admit bumped queued and inflight)
            _deadline.unregister(req.key)
            self.admission.on_flushed(1)
            self.admission.complete()
            raise ShedError(503, "shutdown", 1.0) from None

    def complete(
        self, key: int | None = None, was_dispatched: bool = False
    ) -> None:
        """The response for an admitted request went out (any status)."""
        if key is not None:
            _deadline.unregister(key)
        self.admission.complete()
        if was_dispatched:
            with self._disp_lock:
                self._dispatched_pending = max(
                    0, self._dispatched_pending - 1
                )
            self.batcher.notify()

    def _dispatch_capacity(self) -> int:
        with self._disp_lock:
            return self.config.dispatch_window() - self._dispatched_pending

    # --- batcher callbacks (batcher thread) -------------------------------

    def _dispatch(self, reqs: list) -> None:
        now = time.monotonic()
        # window slots are claimed for the WHOLE batch before any
        # request is marked dispatched: a handler releases its slot
        # only after try_mark_dispatched flipped the state, so the
        # release can never run ahead of this increment and be clamped
        # away (which would leak the slot and wedge the gate); if the
        # insert below raises, the handlers still observe
        # was_dispatched and release their slots in complete()
        with self._disp_lock:
            self._dispatched_pending += len(reqs)
        # claim each request atomically: a handler whose client went
        # away while the request sat in the queue marked it abandoned —
        # it must not burn an engine batch slot, and its window slots
        # are returned right here (nobody else will)
        live = [r for r in reqs if r.try_mark_dispatched()]
        n = len(live)
        if n < len(reqs):
            with self._disp_lock:
                self._dispatched_pending = max(
                    0, self._dispatched_pending - (len(reqs) - n)
                )
        if n:
            self.session.insert_batch([(r.key, 1, r.vals) for r in live])
            self._m_batch_rows.observe(n)
            bucket = self.config.bucket_for(n)
            self._m_occupancy.labels("gate", str(bucket)).observe(
                min(1.0, n / bucket)
            )
            ledger = self.ledger
            for r in live:
                wait = max(0.0, now - r.enqueued_at)
                self._m_wait.observe(wait)
                if ledger is not None:
                    ledger.observe_wait(r.tenant, wait)
                    ledger.note_dispatched(r.order)
                r.resolve_dispatched(n)
        # counted LAST: if anything above raised, the batcher's
        # catch-all _rejects every request and _reject does its own
        # on_flushed — counting here too would double-decrement queued
        self.admission.on_flushed(len(reqs))

    def _reject(self, req: Any, exc: BaseException) -> None:
        self.admission.on_flushed(1)
        if isinstance(exc, DeadlineExceeded):
            self._m_expired.inc()
        req.reject(exc)

    # --- lifecycle --------------------------------------------------------

    def drain(self, grace_s: float | None = None) -> bool:
        """Stop admitting (503 + Retry-After), flush everything queued,
        then wait for every admitted request's response. Returns True if
        the gate went fully idle within the grace period."""
        if grace_s is None:
            grace_s = self.config.drain_grace_s
        self.admission.start_drain()
        self.batcher.drain()
        return self.admission.wait_idle(grace_s)

    def close(self) -> None:
        """Hard stop: queued-but-undispatched requests fail with 503."""
        if self._closed:
            return
        self._closed = True
        self.admission.start_drain()
        self.batcher.close(reject_queued=ShedError(503, "shutdown", 1.0))

    @property
    def queue_depth(self) -> int:
        return self.admission.queued

    @property
    def inflight(self) -> int:
        return self.admission.inflight


def _make_batcher(gate: SurgeGate) -> MicroBatcher:
    """Wire the batcher callbacks through a weakref so the daemon flush
    thread never keeps the gate alive: a graph torn down without an
    explicit stop lets the gate (and its metric callbacks) be
    collected, at which point the finalizer closes the thread instead
    of leaking one per endpoint."""
    ref = weakref.ref(gate)
    config = gate.config

    def dispatch(reqs: list) -> None:
        g = ref()
        if g is None:
            raise RuntimeError("gate collected")
        g._dispatch(reqs)

    def reject(req: Any, exc: BaseException) -> None:
        g = ref()
        if g is None:
            req.reject(exc)
        else:
            g._reject(req, exc)

    def capacity() -> int:
        g = ref()
        return config.max_batch_size if g is None else g._dispatch_capacity()

    batcher = MicroBatcher(
        config,
        dispatch=dispatch,
        reject=reject,
        capacity=capacity,
        name=f"surge-gate{gate.route.replace('/', '-')}",
        # weighted-fair EDF only when a tenant ledger stamped the order
        # tag; None keeps the batcher's plain-EDF default path
        order=(None if gate.ledger is None else (lambda r: r.order)),
    )
    weakref.finalize(gate, batcher.close)
    return batcher


def gates() -> list[SurgeGate]:
    with _GATES_LOCK:
        return list(_GATES)


def drain_all(
    grace_s: float | None = None, stop_webservers: bool = True
) -> bool:
    """Drain every live gate (stop admitting, flush, wait for in-flight
    responses) and then stop their webservers. Returns True when every
    gate went idle within its grace period."""
    all_idle = True
    current = gates()
    for gate in current:
        all_idle = gate.drain(grace_s) and all_idle
    for gate in current:
        gate.close()
    if stop_webservers:
        seen: set[int] = set()
        for gate in current:
            ws = gate.webserver
            if ws is None or id(ws) in seen:
                continue
            seen.add(id(ws))
            try:
                ws.stop()
            except Exception:
                pass
    return all_idle
