"""Dynamic micro-batcher: coalesces admitted requests and releases them
to the engine in earliest-deadline-first order — counterpart of
``pathway_tpu/serving/batcher.py``, copied as is (stdlib only).

A flush happens when ``max_batch_size`` requests have coalesced, when
the OLDEST queued request has waited ``max_wait_ms`` (bounded added
latency even at low load), or immediately in drain mode. Expired
requests are rejected at flush — they never reach the engine, so a dead
deadline cannot burn a batch slot. The dispatch callback runs on the
batcher thread and hands the whole release on at once: the Surge Gate
inserts it into the endpoint's ``InputSession`` (one engine tick), the
decode scheduler stages it for its next step boundary.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Callable

from pathway_tpu_torch.serving.admission import DeadlineExceeded
from pathway_tpu_torch.serving.config import QoSConfig


class MicroBatcher:
    """``put`` is thread-safe (called from the REST handlers); flushing
    runs on one dedicated daemon thread."""

    def __init__(
        self,
        config: QoSConfig,
        dispatch: Callable[[list], None],
        reject: Callable[[Any, BaseException], None],
        capacity: Callable[[], int] | None = None,
        name: str = "surge-gate",
        order: Callable[[Any], Any] | None = None,
    ):
        self.config = config
        self._dispatch = dispatch
        self._reject = reject
        # heap ordering key; default = plain EDF (request deadline).
        # Tenant Weave passes a weighted-fair key (vfinish, deadline) so
        # a hot tenant's backlog drains behind the tail's fresh requests
        self._order = order if order is not None else (lambda r: r.deadline)
        # dispatch-window backpressure: how many more requests may be
        # released right now (gate: dispatch_window - dispatched_pending).
        # None = unbounded. Bounded capacity is what makes the ADMISSION
        # queue the place where overload accumulates (and sheds) instead
        # of the engine's unbounded InputSession.
        self._capacity = capacity
        self._cond = threading.Condition()
        # EDF: (deadline, seq) heap key; seq breaks ties FIFO
        self._heap: list[tuple[float, int, Any]] = []
        self._seq = 0
        self._oldest_at: float | None = None  # enqueue time of oldest item
        self._closing = False
        self._draining = False
        self.flushes = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=name
        )
        self._thread.start()

    def __len__(self) -> int:
        with self._cond:
            return len(self._heap)

    def put(self, req: Any) -> None:
        """Enqueue an admitted request (req must expose ``.deadline``)."""
        now = time.monotonic()
        with self._cond:
            if self._closing:
                raise RuntimeError("micro-batcher is closed")
            self._seq += 1
            heapq.heappush(self._heap, (self._order(req), self._seq, req))
            if self._oldest_at is None:
                self._oldest_at = now
            self._cond.notify()

    def drain(self) -> None:
        """Flush everything queued as fast as possible; new ``put``s are
        still accepted until ``close`` (admission already sheds them)."""
        with self._cond:
            self._draining = True
            self._cond.notify()

    def notify(self) -> None:
        """Wake the flush loop (dispatch capacity may have freed up)."""
        with self._cond:
            self._cond.notify()

    def close(self, reject_queued: BaseException | None = None) -> None:
        """Stop the flush thread. ``reject_queued`` (e.g. a ShedError)
        fails whatever is still queued instead of dispatching it."""
        with self._cond:
            self._closing = True
            leftovers = []
            if reject_queued is not None:
                leftovers = [r for _, _, r in self._heap]
                self._heap = []
                self._oldest_at = None
            self._cond.notify()
        for req in leftovers:
            self._reject(req, reject_queued)
        # close may run from a GC finalizer on an arbitrary thread —
        # including this batcher's own (joining yourself raises)
        if (
            self._thread.is_alive()
            and self._thread is not threading.current_thread()
        ):
            self._thread.join(timeout=5)

    # --- flush loop -------------------------------------------------------

    def _room(self) -> int:
        """Dispatch capacity right now (drain/close ignore the window —
        the engine still processes whatever is left)."""
        if self._capacity is None or self._draining or self._closing:
            return self.config.max_batch_size
        return self._capacity()

    def _wait_for_flush_condition(self) -> bool:
        """Hold the lock; return False when closing with nothing left."""
        cfg = self.config
        while True:
            if self._heap:
                ripe = (
                    len(self._heap) >= cfg.max_batch_size
                    or self._draining
                    or self._closing
                )
                if not ripe:
                    budget = (
                        self._oldest_at + cfg.max_wait_ms / 1000.0
                    ) - time.monotonic()
                    if budget > 0:
                        self._cond.wait(budget)
                        continue
                if self._room() >= 1:
                    return True
                # dispatch window full: wait for a complete() notify.
                # The bounded wait doubles as an expiry sweep — requests
                # whose deadline passes while stuck here must be dropped
                # even if the engine never frees capacity.
                self._cond.wait(0.05)
                self._drop_expired_locked()
            elif self._closing:
                return False
            else:
                self._cond.wait()

    def steal(self, selector: Callable[[list], Any]) -> Any:
        """Remove and return ONE queued request chosen by ``selector``
        (called under the lock with the queued requests; returns a
        request or None).  Tenant Weave's queue-full eviction: the gate
        rejects the stolen request itself, charging the shed to the
        over-share tenant instead of the arriving tail request."""
        with self._cond:
            if not self._heap:
                return None
            victim = selector([r for _k, _s, r in self._heap])
            if victim is None:
                return None
            self._heap = [e for e in self._heap if e[2] is not victim]
            heapq.heapify(self._heap)
            if not self._heap:
                self._oldest_at = None
            return victim

    def _drop_expired_locked(self) -> None:
        now = time.monotonic()
        # expiry always reads the request's DEADLINE — the heap key may
        # be a weighted-fair tag, not the deadline itself
        if not any(r.deadline < now for _d, _s, r in self._heap):
            return
        keep, dead = [], []
        for d, s, r in self._heap:
            (dead if r.deadline < now else keep).append((d, s, r))
        self._heap = keep
        heapq.heapify(self._heap)
        if not self._heap:
            self._oldest_at = None
        for _d, _s, req in dead:
            self._reject(req, DeadlineExceeded())

    def _run(self) -> None:
        while True:
            with self._cond:
                if not self._wait_for_flush_condition():
                    return
                batch = [
                    heapq.heappop(self._heap)[2]
                    for _ in range(
                        min(
                            len(self._heap),
                            self.config.max_batch_size,
                            max(1, self._room()),
                        )
                    )
                ]
                # remaining items started a fresh wait window: their
                # original enqueue times are older, but re-arming from
                # now keeps the invariant "no flush later than
                # oldest + max_wait" approximately while staying O(1)
                self._oldest_at = time.monotonic() if self._heap else None
            now = time.monotonic()
            # complement partition: a pathological deadline (NaN) must
            # land in exactly one bucket, never silently vanish
            live = [r for r in batch if r.deadline >= now]
            dead = [r for r in batch if not (r.deadline >= now)]
            for req in dead:
                self._reject(req, DeadlineExceeded())
            if live:
                try:
                    self._dispatch(live)
                except Exception as exc:  # dispatch must not kill the loop
                    for req in live:
                        self._reject(req, exc)
            self.flushes += 1
