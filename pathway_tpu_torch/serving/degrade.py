"""Phoenix serving degradation — stale reads while the engine recovers
(counterpart of ``pathway_tpu/serving/degrade.py``, copied as is).

While the process group is recovering (a peer died and the supervisor is
restarting the group, or this process is replaying persisted state after
a restart), the engine tick loop is not answering queries.  Instead of
letting admitted KNN/RAG reads 500 or time out, Surge-Gated endpoints
answer from the LAST HYDRATED INDEX SNAPSHOT: the ``ExternalIndexExec``
registers itself here as a stale-capable reader and bumps its freshness
clock every tick, persistence restore hydrates it up front (mmap), and
the REST handler (io/http/_server.py) detects recovery mode and serves
through the registered responder with explicit staleness headers:

* ``x-pathway-stale: true`` and ``x-pathway-staleness-seconds: <s>`` on
  every degraded response;
* the ``x-pathway-max-staleness-ms`` REQUEST header bounds acceptable
  staleness — a stale snapshot older than the bound sheds with 503 +
  Retry-After instead of silently serving garbage.

Observability: ``pathway_serving_staleness_seconds`` (gauge, scrape-time
freshness of the newest registered index), ``pathway_serving_stale_
served_total`` and ``pathway_serving_degraded_shed_total`` counters.

Everything is process-global and thread-safe: recovery is entered from
mesh failure-listener threads and persistence attach, read from the
REST server's thread.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable

_lock = threading.Lock()
_reasons: dict[str, float] = {}  # active recovery reasons -> entered_at
_responders: dict[str, Callable[[dict], Any]] = {}  # route -> responder
_index_readers: list = []  # weakrefs to stale-capable index execs
_fresh_at: float | None = None  # monotonic instant of last engine tick
# serializes stale searches against engine-side index mutation (replay
# ticks rebuild the corpus while the handler reads it)
index_guard = threading.RLock()

_M: dict | None = None


def _metrics() -> dict:
    global _M
    if _M is None:
        from pathway_tpu_torch.observability import REGISTRY

        gauge = REGISTRY.gauge(
            "pathway_serving_staleness_seconds",
            "age of the snapshot serving reads: seconds since the last "
            "engine tick refreshed the index (0 while live)",
        )
        gauge.set_function(lambda: staleness_seconds() or 0.0)
        _M = {
            "staleness": gauge,
            "stale_served": REGISTRY.counter(
                "pathway_serving_stale_served_total",
                "requests answered from the last hydrated index snapshot "
                "while the engine was recovering, by route",
                labelnames=("route",),
            ),
            "degraded_shed": REGISTRY.counter(
                "pathway_serving_degraded_shed_total",
                "requests shed during recovery, by route and reason "
                "(max_staleness = snapshot older than the request's "
                "x-pathway-max-staleness-ms; no_responder = endpoint "
                "has no stale read path)",
                labelnames=("route", "reason"),
            ),
        }
    return _M


# --- recovery state -------------------------------------------------------


def enter_recovery(reason: str) -> None:
    """Mark the engine as recovering; idempotent per reason. Reasons
    stack: replay inside a peer-failure window clears independently."""
    _metrics()
    with _lock:
        _reasons.setdefault(reason, time.monotonic())


def exit_recovery(reason: str | None = None) -> None:
    """Clear one recovery reason (or all, when None)."""
    with _lock:
        if reason is None:
            _reasons.clear()
        else:
            _reasons.pop(reason, None)


def recovering() -> str | None:
    """The oldest active recovery reason, or None when the engine is
    live."""
    with _lock:
        if not _reasons:
            return None
        return min(_reasons, key=_reasons.__getitem__)


# --- freshness ------------------------------------------------------------


def mark_fresh() -> None:
    """Called by index execs on every engine tick that could have
    refreshed them: the staleness clock restarts."""
    global _fresh_at
    _fresh_at = time.monotonic()


def staleness_seconds() -> float | None:
    """Seconds since the engine last refreshed the serving indexes, or
    None when no index ever registered. Live engines report ~0."""
    if _fresh_at is None:
        return None
    return max(0.0, time.monotonic() - _fresh_at)


# --- stale read paths -----------------------------------------------------


def register_index_reader(exec_obj: Any) -> None:
    """Register a stale-capable index exec (weakly): generic responders
    can answer ``search`` against the last hydrated corpus."""
    with _lock:
        _index_readers[:] = [r for r in _index_readers if r() is not None]
        _index_readers.append(weakref.ref(exec_obj))
    mark_fresh()


def stale_knn_search(
    triples: list[tuple[Any, int, Any]],
) -> list[tuple[tuple[int, float], ...]]:
    """Answer KNN queries against the most recently registered index's
    current (possibly stale) corpus. Raises RuntimeError when no index
    is registered."""
    with _lock:
        readers = [r() for r in _index_readers]
    for reader in reversed(readers):
        if reader is not None:
            with index_guard:
                return reader.index.search(triples)
    raise RuntimeError("no stale-capable index registered")


def register_stale_responder(
    route: str, fn: Callable[[dict], Any]
) -> None:
    """Register the degraded-mode answer function for a REST route:
    ``fn(request_values) -> json-able payload``, executed on a worker
    thread while the engine recovers. Typically closes over
    :func:`stale_knn_search` plus the app's response formatting."""
    _metrics()
    with _lock:
        _responders[route] = fn


def stale_responder(route: str) -> Callable[[dict], Any] | None:
    with _lock:
        return _responders.get(route)


def count_stale_served(route: str) -> None:
    _metrics()["stale_served"].labels(route).inc()


def count_degraded_shed(route: str, reason: str) -> None:
    _metrics()["degraded_shed"].labels(route, reason).inc()


def reset() -> None:
    """Test hook: clear recovery state, responders and readers."""
    global _fresh_at
    with _lock:
        _reasons.clear()
        _responders.clear()
        _index_readers.clear()
    _fresh_at = None
