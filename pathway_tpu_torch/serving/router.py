"""Replica Shield failover router — counterpart of
``pathway_tpu/serving/router.py``, all of its routing. It stands on the
port's own HTTP stack (the card's machine has no aiohttp): the server is
``io/http/_web.py`` with its catch-all route, the client
``io/http/_web_client.py`` (keep-alive, a total timeout per attempt,
cancellation for the losing hedge). The Fleet Lens federation routes
(``/fleet/metrics``, ``/fleet/events``, ``/fleet/trace``) federate the
replicas through ``observability/fleet.py``, and ``/debug/events`` serves
this process's journal, as in the reference.

Deadline-aware, occupancy-weighted balancing over the read replicas, IN
FRONT of each replica's Surge Gate.

The router is a thin asyncio HTTP proxy holding no index state: it
forwards each read to the best-qualified replica and turns replica
failure into a retry instead of a client-visible error.

Routing policy (per request):

* **Qualify** — a replica is eligible when it is not ejected, reports
  ``ready`` (caught up with the writer since its current subscription —
  a restarted replica is only re-admitted once it clears this
  freshness bound) and, when the request carries
  ``x-pathway-max-staleness-ms``, its last reported staleness fits the
  bound.  The replica re-checks the bound locally at serve time, so a
  stale-between-polls replica answers 503 and the router moves on.
* **Degrade before shed** — when no replica is fresh but some are alive
  and the request did NOT bound staleness, the router serves from a
  stale replica (the stale-responder contract: explicit
  ``x-pathway-stale`` headers, never silent).  Explicit 503 +
  ``Retry-After`` goes out only when NO replica qualifies at all.
* **Pick** — occupancy-weighted: fewest in-flight (router-side counter
  + the replica's reported admission occupancy), EWMA latency as the
  tie-break.
* **Retry** — a transport failure (dead replica: connection refused /
  reset mid-response) ejects the replica, fires failure listeners
  (the HostMesh ``add_failure_listener`` contract), and retries the
  SAME request on a different replica within the ORIGINAL deadline —
  never the ejected one, at most ``PATHWAY_SERVING_RETRIES`` (default
  1) extra attempts.  Every attempt is a ``router.attempt`` child span,
  so the retry hop is visible in the stitched trace.
* **Hedge** — with ``PATHWAY_SERVING_HEDGE_MS`` set, a primary attempt
  that has not answered within the hedge budget gets a duplicate on a
  second replica; the first response wins and the loser is cancelled
  (duplicate-suppressed — reads are idempotent, exactly one response
  reaches the client).

Health: a background poller GETs every replica's ``/replica/health``
each ``PATHWAY_ROUTER_HEALTH_MS`` (heartbeat analog); consecutive
misses eject.  Ejected replicas keep being polled and re-admit only
once they report ``ready`` again.

Deadlines: ``x-pathway-deadline-ms`` propagates with the REMAINING
budget per attempt, so a retried request never outlives its original
deadline, and the trace context rides ``traceparent`` end to end.

Shard Harbor (scatter-gather): with a shard map (``shards=[[urls...],
...]`` or ``PATHWAY_SERVING_SHARD_MAP`` — ``|``-separated shards of
``,``-separated member URLs), each replica owns ONE jk-hash key range
of the corpus, and a read fans out to one qualified member per shard
(the same occupancy-weighted pick WITHIN the shard), merging the
per-shard top-k into the global top-k (:func:`merge_topk` — per-shard
key sets are disjoint, so the union of per-shard top-k always contains
the global top-k).  Per-shard attempts are ``router.attempt`` child
spans carrying a ``shard`` attribute.  Partial-shard outage follows
the established degrade ladder PER SHARD: fresh member first, stale
member for unbounded reads; when a shard has NOBODY to answer, the
whole read sheds with an explicit 503 + ``Retry-After`` NAMING the
missing shards (``x-pathway-missing-shards``) — a partial corpus is
never silently served as if it were complete.  A torn shard map
(empty shard, member listed in two shards) is rejected at construction
(:func:`validate_shard_map`), not discovered as wrong answers.
"""

from __future__ import annotations

import asyncio
import os
import random
import threading
import time
from typing import Any, Callable

_FWD_HEADERS = (
    # request headers forwarded to the replica verbatim
    "x-pathway-max-staleness-ms",
    "content-type",
    # Tenant Weave identity: replicas run their own tenant ledgers, so
    # the shed lands on the hot tenant at every member a request is
    # steered to
    "x-pathway-tenant",
    "x-pathway-tenant-class",
)
_BACK_HEADERS = (
    # response headers surfaced back to the client
    "x-pathway-replica",
    "x-pathway-applied-tick",
    "x-pathway-staleness-seconds",
    "x-pathway-stale",
    "retry-after",
    "content-type",
)


def replicas_from_env() -> list[str]:
    """PATHWAY_SERVING_REPLICAS: comma-separated replica base URLs
    (e.g. ``http://127.0.0.1:9101,http://127.0.0.1:9102``)."""
    raw = os.environ.get("PATHWAY_SERVING_REPLICAS", "")
    return [u.strip().rstrip("/") for u in raw.split(",") if u.strip()]


def shard_map_from_env() -> list[list[str]] | None:
    """PATHWAY_SERVING_SHARD_MAP: ``|``-separated shards (position =
    shard id) of ``,``-separated member URLs, e.g.
    ``http://h:9101,http://h:9102|http://h:9103,http://h:9104`` for a
    2-shard × 2-member plane.  None when unset."""
    raw = os.environ.get("PATHWAY_SERVING_SHARD_MAP", "")
    if not raw.strip():
        return None
    shards = [
        [u.strip().rstrip("/") for u in part.split(",") if u.strip()]
        for part in raw.split("|")
    ]
    validate_shard_map(shards)
    return shards


def validate_shard_map(shards: list[list[str]]) -> None:
    """Reject a torn shard assignment map at BOOT: every shard needs at
    least one member, and no member may appear in two shards (it would
    be fed two different key ranges and answer both wrongly)."""
    if not shards:
        raise ValueError("shard map is empty")
    seen: dict[str, int] = {}
    for s, members in enumerate(shards):
        if not members:
            raise ValueError(
                f"torn shard map: shard {s} has no members — every key "
                "range needs at least one owner"
            )
        for url in members:
            if url in seen:
                raise ValueError(
                    f"torn shard map: {url} is listed in shard "
                    f"{seen[url]} AND shard {s} — a member owns exactly "
                    "one key range"
                )
            seen[url] = s


def merge_topk(
    per_shard_matches: list[list], k: int
) -> list[list]:
    """Merge per-shard top-k ``[key, score]`` lists into the global
    top-k: shards own disjoint key ranges, so the union of per-shard
    top-k (each ≥ k deep or exhausted) always contains the global
    top-k.  Ordering is (score desc, key asc) — the deterministic
    tie-break that makes the merge bit-equal to an unsharded index
    using the same rule, regardless of how the corpus was split."""
    merged = [m for shard in per_shard_matches for m in shard]
    merged.sort(key=lambda m: (-float(m[1]), m[0]))
    return [list(m) for m in merged[: max(int(k), 0)]]


def hedge_ms_env() -> float:
    raw = os.environ.get("PATHWAY_SERVING_HEDGE_MS", "") or "0"
    try:
        return max(float(raw), 0.0)
    except ValueError:
        raise ValueError(
            f"PATHWAY_SERVING_HEDGE_MS={raw!r} is not a number"
        ) from None


class _Transport(Exception):
    """Replica transport failure (dead/unreachable) — retryable."""


class ReplicaEndpoint:
    """Router-side view of one replica: URL + health + occupancy."""

    def __init__(self, name: str, url: str, shard: int = 0):
        self.name = name
        self.url = url.rstrip("/")
        self.shard = shard  # the jk-hash key range this member owns
        # the shard count of the map this member is routed under: sent with
        # every attempt, so a member that already splits the corpus another
        # way (a reshard between its adoption and the router's swap)
        # refuses the read instead of answering from its part of the corpus
        self.map_shards = 1
        self.inflight = 0  # router-side in-flight (attempts)
        self.reported_inflight = 0  # replica's admission occupancy
        self.ewma_ms = 0.0
        self.applied_tick = -1
        self.staleness_s: float | None = None
        self.ready = False
        self.alive = False  # last health poll answered
        self.ejected = False
        self.eject_reason = ""
        self.misses = 0

    def score(self) -> tuple:
        return (
            self.inflight + self.reported_inflight,
            self.ewma_ms,
            random.random(),
        )

    def qualifies(self, max_staleness_ms: float | None) -> bool:
        if self.ejected or not self.ready:
            return False
        if max_staleness_ms is None:
            return True
        s = self.staleness_s
        return s is not None and s * 1000.0 <= max_staleness_ms

    def serves_stale(self) -> bool:
        """Degraded tier: alive (answers health) but not fresh."""
        return self.alive and not self.ejected


class _WfqDispatch:
    """Tenant-fair dispatch window: at most ``width`` requests route
    concurrently, and when the window is full, waiters release in
    TenantLedger WFQ virtual-finish order — a cold tenant's first
    request jumps ahead of a hot tenant's backlog instead of FIFO-ing
    behind it.  Runs entirely on the router's event loop (no locks);
    exists only when the ledger is armed, so the ``PATHWAY_TENANT_QOS``
    unset path stays byte-identical."""

    def __init__(self, ledger, width: int):
        self.ledger = ledger
        self.width = max(int(width), 1)
        self._inflight = 0
        self._waiters: list[tuple[float, int, Any]] = []  # (tag, seq, fut)
        self._seq = 0

    @property
    def queued(self) -> int:
        return len(self._waiters)

    async def acquire(self, tenant: str | None, tenant_class: str | None):
        """Charge the tenant's WFQ clock and wait for a dispatch slot.
        Returns (tag, waited) — ``waited`` is True when the request
        actually queued behind the window."""
        import heapq

        # charge_only: the dispatch window orders, it never sheds —
        # admission-control sheds stay the replicas' ladder's job
        tag = self.ledger.admit(
            tenant or "", tenant_class, pressure=False, charge_only=True
        )
        if self._inflight < self.width and not self._waiters:
            self._inflight += 1
            self.ledger.note_dispatched((tag,))
            return tag, False
        fut = asyncio.get_running_loop().create_future()
        self._seq += 1
        heapq.heappush(self._waiters, (tag, self._seq, fut))
        await fut
        return tag, True

    def release(self) -> None:
        import heapq

        self._inflight -= 1
        while self._waiters and self._inflight < self.width:
            tag, _seq, fut = heapq.heappop(self._waiters)
            if fut.cancelled():
                continue
            self._inflight += 1
            self.ledger.note_dispatched((tag,))
            fut.set_result(tag)


class FailoverRouter:
    def __init__(
        self,
        replicas: list[str] | None = None,
        *,
        shards: list[list[str]] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        retries: int | None = None,
        hedge_ms: float | None = None,
        health_interval_ms: float | None = None,
        liveness_misses: int = 3,
        default_deadline_ms: float = 30_000.0,
        max_deadline_ms: float = 120_000.0,
        cache: Any = None,
    ):
        if shards is None and replicas is None:
            shards = shard_map_from_env()
        if shards is not None:
            validate_shard_map(shards)
            self.n_shards = len(shards)
            self.endpoints = [
                ReplicaEndpoint(f"s{s}.replica{i}", u, shard=s)
                for s, members in enumerate(shards)
                for i, u in enumerate(members)
            ]
            for ep in self.endpoints:
                ep.map_shards = self.n_shards
        else:
            urls = replicas if replicas is not None else replicas_from_env()
            if not urls:
                raise ValueError(
                    "FailoverRouter needs at least one replica URL (pass "
                    "replicas=[...] / shards=[[...]], or set "
                    "PATHWAY_SERVING_REPLICAS / PATHWAY_SERVING_SHARD_MAP)"
                )
            self.n_shards = 1
            self.endpoints = [
                ReplicaEndpoint(f"replica{i}", u) for i, u in enumerate(urls)
            ]
        self.host = host
        self.port = port
        if retries is None:
            retries = int(os.environ.get("PATHWAY_SERVING_RETRIES", "1") or 1)
        self.retries = max(int(retries), 0)
        self.hedge_s = (
            hedge_ms_env() if hedge_ms is None else max(float(hedge_ms), 0.0)
        ) / 1000.0
        if health_interval_ms is None:
            health_interval_ms = float(
                os.environ.get("PATHWAY_ROUTER_HEALTH_MS", "250") or 250
            )
        self.health_interval_s = max(health_interval_ms, 20.0) / 1000.0
        self.liveness_misses = max(int(liveness_misses), 1)
        self.default_deadline_ms = float(default_deadline_ms)
        self.max_deadline_ms = float(max_deadline_ms)
        # Tenant Weave result cache (serving/result_cache.py): answer
        # repeat reads without a replica hop, invalidated precisely by
        # the writer's delta stream.  None (PATHWAY_ROUTER_CACHE unset)
        # keeps the request path byte-identical to the cache-less plane.
        if cache is None:
            from pathway_tpu_torch.serving.result_cache import cache_from_env

            cache = cache_from_env()
        self.cache = cache
        self._lock = threading.Lock()
        self._failure_listeners: list[Callable[[str, str], None]] = []
        self._past_failures: list[tuple[str, str]] = []
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_ready = threading.Event()
        self._bound = threading.Event()
        self._stop_async: Any = None
        self._thread: threading.Thread | None = None
        self._started = False
        self._stopped = False
        from pathway_tpu_torch.observability import REGISTRY

        self._m_requests = REGISTRY.counter(
            "pathway_router_requests_total",
            "routed read requests, by chosen replica and outcome "
            "(ok / shed / stale_shed / error / no_replica)",
            labelnames=("replica", "outcome"),
        )
        self._m_retries = REGISTRY.counter(
            "pathway_router_retries_total",
            "same-deadline retries after a replica failed mid-request",
        )
        self._m_hedges = REGISTRY.counter(
            "pathway_router_hedges_total",
            "hedged duplicates fired after PATHWAY_SERVING_HEDGE_MS, by "
            "which attempt won",
            labelnames=("winner",),
        )
        self._m_ejections = REGISTRY.counter(
            "pathway_router_ejections_total",
            "replica ejections, by replica and reason",
            labelnames=("replica", "reason"),
        )
        self._m_inflight = REGISTRY.gauge(
            "pathway_router_replica_inflight",
            "router-side in-flight attempts per replica",
            labelnames=("replica",),
        )
        self._gauge_names: set[str] = set()
        for ep in self.endpoints:
            self._gauge_names.add(ep.name)
            self._m_inflight.labels(ep.name).set_function(
                lambda ep=ep: ep.inflight
            )
        # Tenant-aware dispatch: with the tenant ledger armed
        # (PATHWAY_TENANT_QOS=1) the router's dispatch window releases
        # waiting requests in WFQ virtual-finish order instead of FIFO.
        # A None ledger keeps the request path byte-identical.
        from pathway_tpu_torch.serving.tenancy import ledger_for

        self.tenant_ledger = ledger_for(None, route="router")
        self._dispatch: _WfqDispatch | None = None
        if self.tenant_ledger is not None:
            width = int(
                os.environ.get("PATHWAY_ROUTER_DISPATCH_WINDOW", "8") or 8
            )
            self._dispatch = _WfqDispatch(self.tenant_ledger, width)
            self._m_dispatch_waits = REGISTRY.counter(
                "pathway_router_dispatch_waits_total",
                "requests that queued behind the tenant-fair dispatch "
                "window before routing",
            )
            REGISTRY.gauge(
                "pathway_router_dispatch_queued",
                "requests currently queued in the tenant-fair dispatch "
                "window",
            ).set_function(lambda d=self._dispatch: d.queued)

    # --- failure listeners (HostMesh contract) ----------------------------

    def add_failure_listener(self, fn: Callable[[str, str], None]) -> None:
        """``fn(replica_name, reason)`` fires at ejection; late
        registrants replay past ejections (mesh parity)."""
        with self._lock:
            self._failure_listeners.append(fn)
            past = list(self._past_failures)
        for name, reason in past:
            try:
                fn(name, reason)
            except Exception:
                pass

    def _eject(self, ep: ReplicaEndpoint, reason: str) -> None:
        with self._lock:
            if ep.ejected:
                return
            ep.ejected = True
            ep.ready = False
            ep.eject_reason = reason
            listeners = list(self._failure_listeners)
            self._past_failures.append((ep.name, reason))
        self._m_ejections.labels(ep.name, reason.split(":")[0]).inc()
        import logging

        from pathway_tpu_torch.observability.journal import record as journal_record

        journal_record(
            "router-eject",
            reason,
            persist=True,
            replica=ep.name,
            shard=ep.shard,
        )
        logging.getLogger("pathway_tpu_torch").warning(
            "router: ejected %s (%s)", ep.name, reason
        )
        for fn in listeners:
            try:
                fn(ep.name, reason)
            except Exception:
                pass

    def _readmit(self, ep: ReplicaEndpoint) -> None:
        with self._lock:
            if not ep.ejected:
                return
            ep.ejected = False
            ep.eject_reason = ""
        import logging

        from pathway_tpu_torch.observability.journal import record as journal_record

        journal_record(
            "router-readmit",
            f"fresh at tick {ep.applied_tick}",
            tick=ep.applied_tick,
            replica=ep.name,
            shard=ep.shard,
        )
        logging.getLogger("pathway_tpu_torch").info(
            "router: re-admitted %s (fresh at tick %d)",
            ep.name,
            ep.applied_tick,
        )

    # --- lifecycle --------------------------------------------------------

    def start(self) -> "FailoverRouter":
        if self._started:
            return self
        self._started = True
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="pw-router"
        )
        self._thread.start()
        self._bound.wait(30.0)
        return self

    def stop(self, timeout: float = 5.0) -> None:
        if not self._started or self._stopped:
            return
        self._stopped = True
        if self.cache is not None:
            self.cache.close()
        self._loop_ready.wait(timeout)
        stop_async = self._stop_async
        if stop_async is not None:
            try:
                stop_async()
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout)

    def _run(self) -> None:
        from pathway_tpu_torch.io.http import _web
        from pathway_tpu_torch.io.http._web_client import ClientSession

        app = _web.Application(shutdown_timeout=1.0)
        app.add_route("*", _web.CATCH_ALL, self._handle)
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        stop_ev = asyncio.Event()
        self._stop_async = lambda: loop.call_soon_threadsafe(stop_ev.set)
        self._loop_ready.set()

        poller: list[asyncio.Task] = []

        def bound(port: int) -> None:
            self.port = port
            self._bound.set()
            poller.append(asyncio.ensure_future(self._health_loop()))

        async def main():
            self._session = ClientSession()
            try:
                if not self._stopped:
                    await app.serve(self.host, self.port, stop_ev, bound)
            finally:
                for task in poller:
                    task.cancel()
                await self._session.close()

        try:
            loop.run_until_complete(main())
        finally:
            self._bound.set()
            loop.close()

    # --- health -----------------------------------------------------------

    async def _health_loop(self) -> None:
        while True:
            for ep in list(self.endpoints):
                await self._poll_one(ep)
            await asyncio.sleep(self.health_interval_s)

    async def _poll_one(self, ep: ReplicaEndpoint) -> None:
        """One health probe of one endpoint (the poll loop's body; the
        shard-map swap primes NEW endpoints through it too)."""
        try:
            resp = await self._session.get(
                ep.url + "/replica/health", timeout=1.0
            )
            h = resp.json()
            ep.alive = True
            ep.misses = 0
            ep.applied_tick = int(h.get("applied_tick", -1))
            s = h.get("staleness_seconds")
            ep.staleness_s = None if s is None else float(s)
            ep.reported_inflight = int(h.get("inflight", 0))
            ep.ready = bool(h.get("ready", False))
            # Shard Harbor: a member whose REPORTED ownership
            # disagrees with its slot in the map would serve the
            # wrong key range with healthy-looking 200s —
            # merged top-k silently drops its slot's range (and
            # duplicates another's).  The health payload names
            # what the member actually owns; trust it over the
            # map and refuse to route there.
            mismatch = None
            try:
                rep_shard = int(h.get("shard", -1))
                rep_n = int(h.get("n_shards", 0))
            except (TypeError, ValueError):
                rep_shard, rep_n = -1, 0
            if self.n_shards > 1:
                if rep_n > 0 and rep_n != self.n_shards:
                    mismatch = (
                        f"shard-mismatch: member splits the "
                        f"corpus {rep_n} way(s), the map has "
                        f"{self.n_shards}"
                    )
                elif rep_shard >= 0 and rep_shard != ep.shard:
                    mismatch = (
                        f"shard-mismatch: member owns shard "
                        f"{rep_shard}, the map lists it under "
                        f"shard {ep.shard}"
                    )
            elif rep_n > 1:
                # the inverse misconfig: a shard-owning member
                # behind a PLAIN replicas-list router would
                # answer every routed read from 1/S of the
                # corpus with healthy-looking 200s
                mismatch = (
                    f"shard-mismatch: member owns 1/{rep_n} of "
                    "the corpus but this router is unsharded "
                    "(use PATHWAY_SERVING_SHARD_MAP)"
                )
            if mismatch is not None:
                ep.ready = False
                if not ep.ejected:
                    self._eject(ep, mismatch)
            elif ep.ejected and ep.ready:
                # the freshness bound for re-admission: the
                # replica reports caught-up again (and, on a
                # sharded plane, its ownership matches its slot)
                self._readmit(ep)
        except asyncio.CancelledError:
            raise
        except Exception:
            ep.misses += 1
            ep.alive = False
            ep.ready = False
            if ep.misses >= self.liveness_misses and not ep.ejected:
                self._eject(
                    ep,
                    f"liveness: {ep.misses} consecutive health "
                    "probes failed",
                )

    # --- live shard-map swap (Shard Flux) ---------------------------------

    def swap_shard_map(
        self, shards: list[list[str]], timeout: float = 30.0
    ) -> None:
        """Atomically swap the routing topology to a NEW shard map at
        the reshard commit barrier.  The new map is validated like the
        boot map; members already routed to (same URL) keep their live
        health state; brand-new members get one immediate health probe
        before the swap so the plane does not eat a
        health-interval-long 503 window.  In-flight requests finish
        against the map they started on; every request after the swap
        sees only the new one — there is no in-between state."""
        validate_shard_map(shards)
        if not self._started:
            # boot-time configuration: no loop to defer to
            self._install_map(shards, [])
            return
        self._loop_ready.wait(timeout)
        loop = self._loop
        if loop is None:
            raise RuntimeError("router loop never started")
        fut = asyncio.run_coroutine_threadsafe(
            self._swap_async(shards), loop
        )
        fut.result(timeout)

    def _install_map(
        self, shards: list[list[str]], primed: list[ReplicaEndpoint]
    ) -> None:
        by_url = {ep.url: ep for ep in self.endpoints}
        primed_by_url = {ep.url: ep for ep in primed}
        new_eps: list[ReplicaEndpoint] = []
        for s, members in enumerate(shards):
            for i, u in enumerate(members):
                url = u.rstrip("/")
                ep = primed_by_url.get(url) or by_url.get(url)
                if ep is not None:
                    ep.name = f"s{s}.replica{i}"
                    ep.shard = s
                else:
                    ep = ReplicaEndpoint(f"s{s}.replica{i}", url, shard=s)
                ep.map_shards = len(shards)
                new_eps.append(ep)
        with self._lock:
            self.endpoints = new_eps
            self.n_shards = len(shards)
        for ep in new_eps:
            # (re)bind: set_function REPLACES, so a reused label never
            # double-reports and reshard churn never accumulates
            # closures pinning dead ReplicaEndpoint objects
            self._gauge_names.add(ep.name)
            self._m_inflight.labels(ep.name).set_function(
                lambda ep=ep: ep.inflight
            )
        live = {ep.name for ep in new_eps}
        for name in self._gauge_names - live:
            # cardinality bound: a retired replica's series is REMOVED,
            # not zeroed forever — reshard churn must not grow the
            # exposition without bound (one series per name that ever
            # existed)
            self._m_inflight.remove(name)
        self._gauge_names &= live
        from pathway_tpu_torch.observability.journal import record as journal_record

        journal_record(
            "shard-swap",
            f"{len(shards)} shard(s) x "
            f"{'/'.join(str(len(m)) for m in shards)} member(s)",
            persist=True,
            n_shards=len(shards),
            members=[len(m) for m in shards],
        )

    async def _swap_async(self, shards: list[list[str]]) -> None:
        known = {ep.url for ep in self.endpoints}
        primed: list[ReplicaEndpoint] = []
        for s, members in enumerate(shards):
            for i, u in enumerate(members):
                url = u.rstrip("/")
                if url in known:
                    continue
                ep = ReplicaEndpoint(f"s{s}.replica{i}", url, shard=s)
                await self._poll_one(ep)
                primed.append(ep)
        self._install_map(shards, primed)
        import logging

        logging.getLogger("pathway_tpu_torch").info(
            "router: swapped shard map to %d shard(s) x %s member(s)",
            len(shards),
            "/".join(str(len(m)) for m in shards),
        )

    # --- request path -----------------------------------------------------

    def _deadline_budget_s(self, request) -> float:
        import math

        raw = request.headers.get("x-pathway-deadline-ms")
        budget_ms = None
        if raw is not None:
            try:
                budget_ms = float(raw)
            except ValueError:
                budget_ms = None
            if budget_ms is not None and not math.isfinite(budget_ms):
                budget_ms = None
        if budget_ms is None:
            budget_ms = self.default_deadline_ms
        return min(budget_ms, self.max_deadline_ms) / 1000.0

    @staticmethod
    def _max_staleness_ms(request) -> float | None:
        import math

        raw = request.headers.get("x-pathway-max-staleness-ms")
        if raw is None:
            return None
        try:
            v = float(raw)
        except ValueError:
            return None
        return v if math.isfinite(v) else None

    def _candidates(
        self,
        max_staleness_ms: float | None,
        tried: set,
        shard: int | None = None,
    ) -> list[ReplicaEndpoint]:
        pool = (
            self.endpoints
            if shard is None
            else [ep for ep in self.endpoints if ep.shard == shard]
        )
        fresh = [
            ep
            for ep in pool
            if ep.name not in tried and ep.qualifies(max_staleness_ms)
        ]
        if fresh:
            return sorted(fresh, key=ReplicaEndpoint.score)
        if max_staleness_ms is None:
            # degrade-before-shed: an unbounded read prefers a stale
            # answer (explicit x-pathway-stale headers) over a 503
            stale = [
                ep
                for ep in pool
                if ep.name not in tried and ep.serves_stale()
            ]
            return sorted(stale, key=ReplicaEndpoint.score)
        return []

    async def _attempt(
        self, ep: ReplicaEndpoint, request, body: bytes, deadline: float
    ) -> tuple[int, bytes, dict]:
        """One forwarded attempt; raises _Transport on a dead replica."""
        from pathway_tpu_torch.io.http._web_client import ClientError
        from pathway_tpu_torch.observability import tracing

        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise asyncio.TimeoutError()
        headers = {
            k: request.headers[k] for k in _FWD_HEADERS if k in request.headers
        }
        headers["x-pathway-deadline-ms"] = f"{remaining * 1000.0:.1f}"
        headers["x-pathway-shards"] = str(ep.map_shards)
        span = tracing.get_tracer().span(
            "router.attempt", replica=ep.name, shard=str(ep.shard)
        )
        ep.inflight += 1
        t0 = time.perf_counter()
        try:
            with span:
                if span.context is not None:
                    headers["traceparent"] = span.context.traceparent()
                try:
                    resp = await self._session.post(
                        ep.url + request.path,
                        data=body,
                        headers=headers,
                        timeout=remaining,
                    )
                    out_headers = {
                        k: v
                        for k, v in resp.headers.items()
                        if k.lower() in _BACK_HEADERS
                    }
                    span.set_attribute("status", resp.status)
                    return resp.status, resp.body, out_headers
                except asyncio.TimeoutError:
                    span.set_attribute("status", "deadline")
                    raise
                except ClientError as e:
                    span.set_attribute("status", f"transport:{type(e).__name__}")
                    raise _Transport(f"{type(e).__name__}: {e}") from e
        finally:
            ep.inflight -= 1
            dt_ms = (time.perf_counter() - t0) * 1000.0
            ep.ewma_ms = 0.8 * ep.ewma_ms + 0.2 * dt_ms

    # --- Fleet Lens federation --------------------------------------------

    async def _fleet_get(self, request):
        """One observability plane for the whole mesh: the router is the
        process that already knows every member's base URL, so it
        federates their `/metrics`, `/debug/events` and `/debug/trace`
        into member-labeled fleet views.  The blocking urllib fetches
        run on the default executor — the proxy loop keeps serving."""
        from pathway_tpu_torch.io.http import _web

        route = request.path
        members = [(ep.name, ep.url) for ep in self.endpoints]
        loop = asyncio.get_running_loop()
        if route == "/debug/events":
            from pathway_tpu_torch.observability.journal import journal

            j = journal()
            return _web.json_response(
                {"member": j.member, "events": j.events()}
            )
        if route == "/fleet/metrics":
            from pathway_tpu_torch.observability import REGISTRY
            from pathway_tpu_torch.observability.fleet import federate_metrics

            local = ("router", REGISTRY.render())
            text, errors = await loop.run_in_executor(
                None, lambda: federate_metrics(members, local=local)
            )
            headers = (
                {"x-pathway-fleet-errors": str(len(errors))}
                if errors
                else {}
            )
            return _web.Response(
                text.encode(),
                headers=headers,
                content_type="text/plain; charset=utf-8",
            )
        if route == "/fleet/events":
            from pathway_tpu_torch.observability.fleet import federate_events
            from pathway_tpu_torch.observability.journal import journal

            local = journal().events()
            merged = await loop.run_in_executor(
                None, lambda: federate_events(members, local=local)
            )
            return _web.json_response(merged)
        # /fleet/trace
        from pathway_tpu_torch.observability.fleet import stitch_traces
        from pathway_tpu_torch.observability.tracing import get_tracer

        trace_id = request.query.get("trace_id") or None
        local = ("router", get_tracer().chrome_trace())
        data = await loop.run_in_executor(
            None,
            lambda: stitch_traces(members, trace_id=trace_id, local=local),
        )
        return _web.json_response(data)

    async def _handle(self, request):
        from pathway_tpu_torch.io.http import _web
        from pathway_tpu_torch.observability import tracing

        if request.method == "GET" and request.path in (
            "/fleet/metrics",
            "/fleet/events",
            "/fleet/trace",
            "/debug/events",
        ):
            return await self._fleet_get(request)
        body = await request.read()
        deadline = time.monotonic() + self._deadline_budget_s(request)
        max_st = self._max_staleness_ms(request)
        tenant = request.headers.get("x-pathway-tenant")
        span = tracing.get_tracer().span(
            "router.request",
            parent=tracing.parse_traceparent(
                request.headers.get("traceparent")
            ),
            root=True,
            ingress=True,
            route=request.path,
        )
        with span:
            hit = (
                self.cache.lookup(tenant, body, max_st, path=request.path)
                if self.cache is not None and request.method == "POST"
                else None
            )
            if hit is not None:
                # answered with ZERO replica hops; the hit headers
                # carry the degrade contract (applied tick + the
                # invalidation stream's staleness) plus x-pathway-cache
                status, payload, headers = hit
                span.set_attribute("status", status)
                span.set_attribute("outcome", "cache_hit")
                self._m_requests.labels("cache", "cache_hit").inc()
                if span.context is not None:
                    headers["traceparent"] = span.context.traceparent()
                return _web.Response(payload, status=status, headers=headers)
            from pathway_tpu_torch.generate.serving import is_generate_route

            if self._dispatch is not None:
                from pathway_tpu_torch.serving.tenancy import TENANT_CLASS_HEADER

                _tag, waited = await self._dispatch.acquire(
                    tenant, request.headers.get(TENANT_CLASS_HEADER)
                )
                if waited:
                    self._m_dispatch_waits.inc()
            try:
                if self.n_shards > 1 and not is_generate_route(request.path):
                    status, payload, headers, outcome, replica = (
                        await self._route_scatter(
                            request, body, deadline, max_st
                        )
                    )
                else:
                    # /generate rides the same occupancy/staleness/
                    # tenant single-member ladder even on a sharded
                    # plane: generation is stateful on the member
                    # holding the KV pages — scatter-gather is a
                    # retrieval concept
                    status, payload, headers, outcome, replica = (
                        await self._route(request, body, deadline, max_st)
                    )
            finally:
                if self._dispatch is not None:
                    self._dispatch.release()
            span.set_attribute("status", status)
            span.set_attribute("outcome", outcome)
            if self.cache is not None and request.method == "POST":
                self.cache.store(
                    tenant,
                    body,
                    max_st,
                    status,
                    payload,
                    headers,
                    path=request.path,
                )
        self._m_requests.labels(replica, outcome).inc()
        if span.context is not None:
            headers["traceparent"] = span.context.traceparent()
        # content type rides the passthrough headers
        return _web.Response(payload, status=status, headers=headers)

    async def _route(
        self, request, body: bytes, deadline: float, max_st: float | None
    ) -> tuple[int, bytes, dict, str, str]:
        tried: set[str] = set()
        last_shed: tuple[int, bytes, dict] | None = None
        failure_retries = 0
        while True:
            cands = self._candidates(max_st, tried)
            if not cands:
                break
            ep = cands[0]
            tried.add(ep.name)
            try:
                status, payload, headers = await self._attempt_hedged(
                    ep, cands[1:], tried, request, body, deadline
                )
            except asyncio.TimeoutError:
                # the ORIGINAL deadline is spent: no retry can help
                return (
                    504,
                    _json_err("deadline exceeded at router"),
                    {"content-type": "application/json"},
                    "deadline",
                    ep.name,
                )
            except _Transport as e:
                # dead replica: eject, fire listeners, retry a sibling
                # within the same deadline (never this one — `tried`).
                # Only FAILURES consume the bounded retry budget.
                self._eject(ep, f"transport: {e}")
                if failure_retries >= self.retries:
                    break
                failure_retries += 1
                self._m_retries.inc()
                continue
            if status in (429, 503):
                # shed (admission or staleness-bound): steer to a
                # sibling — bounded by the `tried` set, NOT by the
                # failure-retry budget, so an idle qualified replica is
                # always reached before a shed passes through
                last_shed = (status, payload, headers)
                continue
            outcome = "ok" if status == 200 else f"status_{status}"
            return status, payload, headers, outcome, ep.name
        if last_shed is not None:
            status, payload, headers = last_shed
            headers.setdefault("Retry-After", "1.0")
            return status, payload, headers, "shed", "none"
        # no replica qualifies at all: explicit 503 + Retry-After
        return (
            503,
            _json_err(
                "no replica qualifies"
                + (
                    f" within x-pathway-max-staleness-ms={max_st:g}"
                    if max_st is not None
                    else " (all ejected or unreachable)"
                )
            ),
            {
                "Retry-After": "1.0",
                "content-type": "application/json",
            },
            "no_replica",
            "none",
        )

    # --- scatter-gather (Shard Harbor) ------------------------------------

    @staticmethod
    def _request_k(body: bytes) -> int:
        import json as _json

        try:
            v = _json.loads(body or b"{}")
            return max(int(v.get("k", 3)), 0)
        except (ValueError, TypeError, AttributeError):
            return 3

    async def _shard_fetch(
        self,
        shard: int,
        request,
        body: bytes,
        deadline: float,
        max_st: float | None,
    ):
        """One shard's leg of the scatter: same qualify/degrade/retry
        ladder as the single-shard route, restricted to the shard's
        members.  Returns (status, payload, headers, replica) on an
        answer, None when the shard is unavailable (every member tried,
        ejected, or over the staleness bound)."""
        tried: set[str] = set()
        failure_retries = 0
        while True:
            cands = self._candidates(max_st, tried, shard=shard)
            if not cands:
                return None
            ep = cands[0]
            tried.add(ep.name)
            try:
                status, payload, headers = await self._attempt_hedged(
                    ep, cands[1:], tried, request, body, deadline
                )
            except asyncio.TimeoutError:
                raise  # the ORIGINAL deadline is spent: the gather
                # surfaces one 504 for the whole read
            except _Transport as e:
                self._eject(ep, f"transport: {e}")
                if failure_retries >= self.retries:
                    return None
                failure_retries += 1
                self._m_retries.inc()
                continue
            if status in (429, 503) or status >= 500:
                # shed or member error: steer to a shard sibling —
                # bounded by the tried set
                continue
            # 200 AND non-shed client errors (400/404/...) return: a
            # permanently-bad request must surface as its real status,
            # not burn every member and masquerade as a health outage
            return status, payload, headers, ep.name

    async def _route_scatter(
        self, request, body: bytes, deadline: float, max_st: float | None
    ) -> tuple[int, bytes, dict, str, str]:
        """Fan the read out to one qualified member per shard and merge
        per-shard top-k into global top-k.  Missing shards are NAMED
        (503 + Retry-After + x-pathway-missing-shards) — a partial
        corpus never masquerades as the whole one."""
        import json as _json

        k = self._request_k(body)
        # return_exceptions: every per-shard task runs to completion —
        # a bare gather would propagate the first TimeoutError and
        # leave the other shards' fetches running as orphans, retrying
        # members against a spent deadline after the 504 already went
        # out
        results = await asyncio.gather(
            *(
                self._shard_fetch(s, request, body, deadline, max_st)
                for s in range(self.n_shards)
            ),
            return_exceptions=True,
        )
        for r in results:
            if isinstance(r, BaseException) and not isinstance(
                r, asyncio.TimeoutError
            ):
                raise r
        if any(isinstance(r, asyncio.TimeoutError) for r in results):
            return (
                504,
                _json_err("deadline exceeded at router"),
                {"content-type": "application/json"},
                "deadline",
                "scatter",
            )
        missing = [s for s, r in enumerate(results) if r is None]
        if missing:
            names = ",".join(str(s) for s in missing)
            return (
                503,
                _json_err(
                    f"shard(s) {names} unavailable"
                    + (
                        f" within x-pathway-max-staleness-ms={max_st:g}"
                        if max_st is not None
                        else " (all members ejected or unreachable)"
                    )
                ),
                {
                    "Retry-After": "1.0",
                    "x-pathway-missing-shards": names,
                    "content-type": "application/json",
                },
                "shard_unavailable",
                "scatter",
            )
        per_shard = []
        applied_ticks: list[int] = []
        staleness: list[float] = []
        any_stale = False
        replicas = []
        for status, payload, headers, replica in results:
            if status != 200:
                # a client error (400/404/...) from any shard: the
                # request itself is bad — surface it unmerged
                return (
                    status,
                    payload,
                    headers,
                    f"status_{status}",
                    replica,
                )
            replicas.append(replica)
            try:
                matches = _json.loads(payload).get("matches", [])
            except ValueError:
                matches = None
            if matches is None:
                return (
                    502,
                    _json_err(
                        f"replica {replica} returned a non-KNN payload "
                        "on a sharded plane (scatter-gather needs the "
                        "matches contract)"
                    ),
                    {"content-type": "application/json"},
                    "bad_shard_payload",
                    replica,
                )
            per_shard.append(matches)
            tick = headers.get("x-pathway-applied-tick")
            if tick is not None:
                try:
                    applied_ticks.append(int(tick))
                except ValueError:
                    pass
            st = headers.get("x-pathway-staleness-seconds")
            if st is not None:
                try:
                    staleness.append(float(st))
                except ValueError:
                    pass
            if headers.get("x-pathway-stale"):
                any_stale = True
        merged = merge_topk(per_shard, k)
        out_headers = {
            "content-type": "application/json",
            "x-pathway-shards": str(self.n_shards),
            "x-pathway-replica": ",".join(replicas),
        }
        if applied_ticks:
            # the plane is only as fresh as its LEAST caught-up shard
            out_headers["x-pathway-applied-tick"] = str(min(applied_ticks))
        if staleness:
            out_headers["x-pathway-staleness-seconds"] = (
                f"{max(staleness):.3f}"
            )
        if any_stale:
            out_headers["x-pathway-stale"] = "true"
        return (
            200,
            _json.dumps({"matches": merged}).encode(),
            out_headers,
            "ok",
            "scatter",
        )

    async def _attempt_hedged(
        self,
        primary: ReplicaEndpoint,
        alternates: list[ReplicaEndpoint],
        tried: set,
        request,
        body: bytes,
        deadline: float,
    ) -> tuple[int, bytes, dict]:
        """Primary attempt, plus a duplicate-suppressed hedge on a
        second replica when the primary is slower than the hedge
        budget.  Exactly one result is returned; the loser's task is
        cancelled."""
        if self.hedge_s <= 0 or not alternates:
            return await self._attempt(primary, request, body, deadline)
        task_a = asyncio.ensure_future(
            self._attempt(primary, request, body, deadline)
        )
        done, _pending = await asyncio.wait(
            {task_a}, timeout=self.hedge_s
        )
        if done:
            return task_a.result()  # fast path: no hedge fired
        hedge_ep = alternates[0]
        tried.add(hedge_ep.name)
        task_b = asyncio.ensure_future(
            self._attempt(hedge_ep, request, body, deadline)
        )
        pending = {task_a, task_b}
        try:
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                for t in done:
                    exc = t.exception()
                    if exc is None:
                        self._m_hedges.labels(
                            "primary" if t is task_a else "hedge"
                        ).inc()
                        return t.result()
                    # a transport-failed leg must STILL eject + fire
                    # failure listeners even when the other leg goes on
                    # to win — a dead primary masked by its hedge would
                    # otherwise keep its routing spot (inflight 0 beats
                    # every live sibling's score) until health polls
                    # catch up
                    if isinstance(exc, _Transport):
                        leg = primary if t is task_a else hedge_ep
                        self._eject(leg, f"transport: {exc}")
                # let the surviving leg decide; both failed → re-raise
                # the primary's error for normal retry handling
            task_a.result()  # raises
            raise _Transport("hedged attempts both failed")
        finally:
            for t in (task_a, task_b):
                if not t.done():
                    t.cancel()


def _json_err(msg: str) -> bytes:
    import json as _json

    return _json.dumps({"error": msg}).encode()
