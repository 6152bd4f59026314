"""Tenant Weave hot-tenant result cache — counterpart of
``pathway_tpu/serving/result_cache.py``, all of it: fingerprints, keys,
the eviction rule and its bound index are the reference's, so the same
sequence of stores and deltas evicts the same entries in both packages.
The cache re-scores on the host in numpy, as the reference does; the
device top-k it guards is the replicas' ``block_topk``.

Answer repeat reads on the router without touching a replica,
invalidated PRECISELY by the replication delta stream.

`serve_chaos` models a zipf tenant population: a handful of hot tenants
repeat the same handful of queries, and every repeat pays a full
router→replica hop even when nothing the query reads has changed.  The
replication delta stream already names exactly which corpus keys changed each
tick (the writer publishes CONSOLIDATED per-tick deltas), which is
precisely the signal a correct result cache needs — so the cache
subscribes a :class:`~pathway_tpu_torch.parallel.replicate.DeltaStreamClient`
(shard ``-1`` = the full corpus, so one subscription covers a sharded
plane too) and evicts per key instead of guessing with TTLs.

**Keying.**  ``(tenant, route path, query fingerprint, k, staleness
bound)`` — the fingerprint is the canonical JSON of the request body,
so two tenants never share an entry (isolation is part of the QoS
story), the same body POSTed to a different route never hits another
route's answer, and a bounded read never answers from an entry stored
under a different bound.

**Precise invalidation.**  A cached entry holds the KNN contract's
result set (``matches: [[key, score], ...]``), the set of keys it
contains, its worst kept score, and the (normalized) query vector.  One
tick's consolidated deltas evict exactly the entries whose result sets
could contain the changed keys:

* a **deleted** key evicts the entries whose result set contains it
  (removing a non-member only removes competition below the k-th match
  — survivors are untouched);
* an **upserted** key evicts the entries that contain it (the doc's
  vector changed, so its score did), the entries whose result set is
  not full (any new doc joins an under-filled top-k), and the entries
  whose query scores the new vector at or above their worst kept match
  (it would enter the top-k).  Everything else provably keeps the exact
  answer a fresh replica would give, so it survives.

On a sharded plane the same rule applies per key — an entry's shard
coverage is exactly the shard set of its result keys for deletions,
and an upsert in ANY shard is score-tested (a new doc from an uncovered
shard can still beat the worst kept match in the merged top-k).

Invalidation is SUBLINEAR in the cache size: containment evictions
come from the per-key reverse index, and the would-enter test selects
its candidates from a sorted worst-kept-score bound index (by
Cauchy-Schwarz, a doc of norm ``|d|`` can only enter an entry whose
``(worst - slack)/|q| <= |d|``) — a changed key tests a bound instead
of re-scoring every cached entry.  The bound is sharp for the ``dot``
metric (doc norms vary); under ``cosine`` both sides are normalized so
it degenerates to ~1 and the index selects nearly everything — the
eviction SET is identical to the full scan either way (property-tested
in tests/test_result_cache.py).

**Freshness contract (the degrade headers hold through the
cache).**  A hit carries ``x-pathway-cache: hit`` plus
``x-pathway-applied-tick`` (the invalidation stream's applied tick —
the entry is guaranteed equal to a fresh answer as of that tick) and
``x-pathway-staleness-seconds`` (the stream's staleness clock).  When
the stream lags past ``PATHWAY_ROUTER_CACHE_MAX_LAG_MS`` (or past the
request's own ``x-pathway-max-staleness-ms``) the cache is BYPASSED —
a lagging invalidation feed must degrade to replica hops, never to
silently stale hits.  Writer death → standby takeover bumps the writer
incarnation, and the cache flushes wholesale on the bump (the new
writer's history may not extend the old one's); a ring resync does the
same.  Entries are only stored when the stream has NOT advanced past
the answering replica's applied tick — otherwise a delta the cache
already processed (but the replica had not applied when answering)
could never evict the entry.

Without a delta stream attached, the cache degrades to TIME-based
staleness only (``PATHWAY_ROUTER_CACHE_TTL_MS``) — the Graph Doctor's
``tenant-fairness`` rule flags this configuration, because a TTL can
serve an answer up to a full TTL staler than the corpus.

Escape hatch is total: with ``PATHWAY_ROUTER_CACHE`` unset (or 0) no
cache object is built and the router request path is byte-identical to
the pre-cache plane.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any

import numpy as np

CACHE_HEADER = "x-pathway-cache"

_ENABLED_ENV = "PATHWAY_ROUTER_CACHE"
_SIZE_ENV = "PATHWAY_ROUTER_CACHE_SIZE"
_MAX_LAG_ENV = "PATHWAY_ROUTER_CACHE_MAX_LAG_MS"
_TTL_ENV = "PATHWAY_ROUTER_CACHE_TTL_MS"
_WRITER_ENV = "PATHWAY_ROUTER_CACHE_WRITER"
_DIM_ENV = "PATHWAY_REPLICA_DIM"

# The cache subscribes as a reserved negative OBSERVER id: full-corpus
# subscriptions to a SHARDED writer are fenced for non-negative replica
# ids (a full-corpus member behind the router would duplicate keys in
# every merge), but an observer never sits behind the router — negative
# ids pass the torn-map guard and receive every shard's deltas.  Its
# wire leg is tagged ``repl:observe`` so Fault Forge can delay/drop the
# invalidation feed without touching the replica fan-out.

# score slack for the would-enter-the-top-k test: the replica scores on
# device (f32 XLA), the cache re-scores in numpy — evict anything within
# one part in 10^6 of the worst kept match instead of betting an exact
# answer on last-ulp agreement.  Ties ALWAYS evict: the device top-k
# breaks them by corpus slot order, which the cache cannot know.
_SCORE_EPS = 1e-6


def cache_enabled_via_env() -> bool:
    """``PATHWAY_ROUTER_CACHE=1`` arms the hot-tenant result cache on
    the failover router.  Off (the default) keeps the router request
    path byte-identical to the cache-less plane."""
    return os.environ.get(_ENABLED_ENV, "0").lower() in ("1", "true", "yes")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "") or str(default)
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None


def fingerprint(body: bytes) -> tuple[str, dict] | None:
    """Canonical request identity: the sorted-key JSON of the body.
    None = not a JSON object → not cacheable (the KNN read contract is
    a JSON body; anything else is passed through uncached)."""
    try:
        values = json.loads(body or b"{}")
    except ValueError:
        return None
    if not isinstance(values, dict):
        return None
    canon = json.dumps(values, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(canon.encode(), digest_size=16).hexdigest(), values


def _k_of(values: dict) -> int | None:
    """The request's top-k, or None when it is not a usable number —
    such a read is not cacheable, but it must still reach the replica
    (whose structured error beats a router-side crash)."""
    try:
        k = int(values.get("k", 3))
    except (TypeError, ValueError):
        return None
    return k if k > 0 else None


class _Entry:
    __slots__ = (
        "payload",
        "headers",
        "qvec",
        "keys",
        "worst_score",
        "full",
        "scoreable",
        "stored_at",
        "tick",
        "bound",
        "seq",
    )

    def __init__(
        self,
        payload: bytes,
        headers: dict,
        qvec: np.ndarray | None,
        keys: frozenset,
        worst_score: float,
        full: bool,
        tick: int,
    ):
        self.payload = payload
        self.headers = headers
        self.qvec = qvec
        self.keys = keys
        self.worst_score = worst_score
        self.full = full
        # a query the cache cannot re-score (no vector derivable, or a
        # metric it does not know) stays correct by evicting on ANY
        # upsert instead of the score test
        self.scoreable = qvec is not None
        self.stored_at = time.monotonic()
        self.tick = tick
        # worst-kept-score bound for the sublinear upsert test: by
        # Cauchy-Schwarz dot(q, d) <= |q|·|d|, so an upserted doc of
        # norm |d| can only enter this entry's top-k when
        # |d| >= (worst - slack) / |q|.  Entries sit in a sorted bound
        # index; one bisect per tick finds the prefix that needs real
        # scoring instead of re-scoring every cached entry.
        if self.full and self.scoreable:
            slack = _SCORE_EPS * max(1.0, abs(worst_score))
            qn = float(np.linalg.norm(qvec))
            need = worst_score - slack
            if qn > 0.0:
                self.bound = need / qn
            else:
                # a zero query scores every doc 0: evictable iff the
                # bound is already <= 0, never otherwise
                self.bound = -np.inf if need <= 0.0 else np.inf
        else:
            self.bound = -np.inf  # evicts on ANY upsert (no score test)
        self.seq = 0  # bound-index tie-break, assigned at store


class ResultCache:
    """Bounded LRU of KNN read results with delta-exact invalidation.

    ``dim`` is the corpus embedding dimension (needed to re-derive the
    query vector of ``query``-text reads via the deterministic
    :func:`~pathway_tpu_torch.serving.replica.text_vector`); ``metric`` must
    match the serving index (``cosine``/``dot`` are score-tested,
    anything else falls back to evict-on-any-upsert)."""

    def __init__(
        self,
        capacity: int | None = None,
        *,
        dim: int | None = None,
        metric: str = "cosine",
        max_lag_ms: float | None = None,
        ttl_ms: float | None = None,
    ):
        if capacity is None:
            capacity = int(os.environ.get(_SIZE_ENV, "1024") or 1024)
        self.capacity = max(int(capacity), 1)
        if dim is None:
            dim = int(os.environ.get(_DIM_ENV, "32") or 32)
        self.dim = int(dim)
        self.metric = metric
        self.max_lag_s = (
            _env_float(_MAX_LAG_ENV, 5000.0)
            if max_lag_ms is None
            else float(max_lag_ms)
        ) / 1000.0
        self.ttl_s = (
            _env_float(_TTL_ENV, 2000.0) if ttl_ms is None else float(ttl_ms)
        ) / 1000.0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # reverse index: corpus key -> cache keys of entries whose
        # result set contains it (the deletion/containment eviction)
        self._by_key: dict[int, set] = {}
        # sublinear upsert invalidation: entries sorted by their
        # worst-kept-score bound (see _Entry.bound) — one bisect per
        # tick selects the prefix an upserted doc could possibly enter;
        # everything past it provably survives WITHOUT re-scoring.
        # (bound, seq, ck) tuples: seq breaks ties so mixed-type cache
        # keys never get compared.
        self._bound_index: list[tuple[float, int, tuple]] = []
        self._entry_seq = 0
        self._client: Any = None
        self._seen_incarnation = -1
        # newest tick ever handed to ingest(), maintained under _lock.
        # The store() ordering guard compares against THIS (not just the
        # client's applied_tick, which bumps only after ingest returns):
        # an answer older than a tick whose eviction pass already ran
        # could never be evicted by it, so it must not be cached.
        self._seen_tick = -1
        from pathway_tpu_torch.observability import REGISTRY

        self._m_lookups = REGISTRY.counter(
            "pathway_router_cache_lookups_total",
            "router result-cache lookups by outcome (hit = answered "
            "with zero replica hops; miss; bypass_lag = invalidation "
            "stream lagging past the bound; bypass_uncacheable = "
            "non-JSON body)",
            labelnames=("outcome",),
        )
        self._m_evictions = REGISTRY.counter(
            "pathway_router_cache_evictions_total",
            "cache entry evictions by reason (delta_contains = a "
            "changed key was in the result set; delta_enters = an "
            "upserted doc would enter the top-k; delta_notfull = "
            "upsert against an under-filled result set; lru; ttl)",
            labelnames=("reason",),
        )
        self._m_flushes = REGISTRY.counter(
            "pathway_router_cache_flushes_total",
            "whole-cache flushes (incarnation = writer takeover bumped "
            "the incarnation; resync = subscription fell off the ring)",
            labelnames=("reason",),
        )
        self._m_size = REGISTRY.gauge(
            "pathway_router_cache_entries",
            "live router result-cache entries",
        )
        # the registry holds gauge callbacks forever: weak ref so a
        # torn-down router's cache can be collected (reads 0 after)
        import weakref

        ref = weakref.ref(self)
        self._m_size.set_function(
            lambda: len(c._entries) if (c := ref()) is not None else 0
        )

    # --- delta-stream subscription ----------------------------------------

    def attach_stream(
        self,
        writer_host: str,
        writer_port: int,
        *,
        endpoints: list[tuple[str, int]] | None = None,
    ) -> None:
        """Subscribe to the writer's consolidated per-tick deltas (the
        invalidation feed).  Shard ``-1`` receives the FULL corpus
        stream, so one subscription serves sharded planes too."""
        from pathway_tpu_torch.parallel.replicate import (
            OBSERVER_ID,
            DeltaStreamClient,
        )

        if self._client is not None:
            raise RuntimeError("result cache already has a delta stream")
        self._client = DeltaStreamClient(
            writer_host,
            writer_port,
            OBSERVER_ID,
            0,
            on_deltas=self.ingest,
            on_resync=self._on_resync,
            endpoints=endpoints,
        )
        self._client.start()

    def _on_resync(self) -> int:
        # the subscription fell off the writer's retained-delta ring:
        # ticks were missed for good, so nothing cached is trustworthy
        self.flush("resync")
        c = self._client
        return max(c.newest_known, 0) if c is not None else 0

    def close(self) -> None:
        c = self._client
        self._client = None
        if c is not None:
            c.close()

    def stream_staleness_s(self) -> float | None:
        """Seconds the invalidation feed may be behind the writer; None
        when no stream is attached (TTL mode) or while disconnected."""
        c = self._client
        return c.staleness_seconds() if c is not None else None

    @property
    def applied_tick(self) -> int:
        c = self._client
        return c.applied_tick if c is not None else -1

    # --- invalidation ------------------------------------------------------

    def _prep_vec(self, vec: Any) -> np.ndarray | None:
        v = np.asarray(vec, dtype=np.float32).reshape(-1)
        if self.metric == "cosine":
            n = float(np.linalg.norm(v))
            return v / n if n > 0 else v
        if self.metric == "dot":
            return v
        return None  # unknown metric: entries fall back to evict-on-upsert

    def ingest(self, tick: int, batches: list) -> None:
        """Apply one tick's consolidated corpus deltas (the
        DeltaStreamClient ``on_deltas`` callback; tests call it
        directly).  Evicts exactly the entries whose result sets could
        contain the tick's changed keys."""
        c = self._client
        if c is not None:
            inc = c.writer_incarnation
            if inc > self._seen_incarnation:
                if self._seen_incarnation >= 0:
                    # writer takeover: the new incarnation's history may
                    # not extend the old one's — nothing cached is
                    # trustworthy
                    self.flush("incarnation")
                self._seen_incarnation = inc
        removed: list[int] = []
        upserted: list[tuple[int, Any]] = []
        for b in batches:
            for key, diff, vals in b.iter_rows():
                if diff > 0:
                    upserted.append((int(key), vals[0] if vals else None))
                else:
                    removed.append(int(key))
        changed = {k for k, _v in upserted}
        changed.update(removed)
        dvecs = [
            self._prep_vec(v) if v is not None else None
            for _k, v in upserted
        ]
        # the covering prefix of the bound index: the largest upserted
        # doc norm decides which entries an upsert could possibly enter
        # (a None dvec — vectorless upsert or unknown metric — defeats
        # the bound, so every entry becomes a candidate, matching the
        # pre-index scan)
        blind = any(d is None for d in dvecs)
        max_norm = max(
            (float(np.linalg.norm(d)) for d in dvecs if d is not None),
            default=None,
        )
        with self._lock:
            # recorded BEFORE any eviction work so a store() racing
            # this tick sees it and refuses answers this pass could
            # never evict
            if tick > self._seen_tick:
                self._seen_tick = tick
            if not changed:
                return
            # candidates, each a SUBLINEAR selection: containment from
            # the per-key reverse index; upsert entrants from the bound
            # index prefix (a changed key tests a bound instead of
            # re-scoring every cached entry)
            cand: dict[tuple, None] = {}
            for key in changed:
                for ck in self._by_key.get(key, ()):
                    cand[ck] = None
            if upserted:
                if blind:
                    cand.update((ck, None) for ck in self._entries)
                elif max_norm is not None:
                    import bisect

                    hi = bisect.bisect_right(
                        self._bound_index, (max_norm, 1 << 62, ())
                    )
                    cand.update(
                        (ck, None)
                        for _b, _s, ck in self._bound_index[:hi]
                    )
            # snapshot only the candidates' eviction-relevant fields:
            # scoring runs OUTSIDE the lock so router lookups and
            # stores never stall behind a churny invalidation tick
            snapshot = [
                (ck, e.keys, e.worst_score, e.full, e.scoreable, e.qvec)
                for ck in cand
                if (e := self._entries.get(ck)) is not None
            ]
        evict: dict[tuple, str] = {}
        for ck, keys, worst, full, scoreable, qvec in snapshot:
            if keys & changed:
                evict[ck] = "delta_contains"
                continue
            for dvec in dvecs:
                if not full:
                    evict[ck] = "delta_notfull"
                    break
                if not scoreable or dvec is None:
                    evict[ck] = "delta_enters"
                    break
                s = float(np.dot(qvec, dvec))
                slack = _SCORE_EPS * max(1.0, abs(worst))
                if s >= worst - slack:
                    evict[ck] = "delta_enters"
                    break
        if not evict:
            return
        with self._lock:
            for ck, reason in evict.items():
                e = self._entries.get(ck)
                # an entry replaced mid-pass by a store carrying an
                # answer PAST this tick already reflects the delta.
                # Equal-tick answers still drop: same-tick merge frames
                # (lockstep second publishers, reconnect boundary
                # replays) mean tick t can grow after an answer at t.
                if e is None or e.tick > tick:
                    continue
                self._drop_locked(ck)
                self._m_evictions.labels(reason).inc()

    def _drop_locked(self, ck: tuple) -> None:
        e = self._entries.pop(ck, None)
        if e is None:
            return
        for key in e.keys:
            s = self._by_key.get(key)
            if s is not None:
                s.discard(ck)
                if not s:
                    del self._by_key[key]
        import bisect

        i = bisect.bisect_left(self._bound_index, (e.bound, e.seq, ck))
        if (
            i < len(self._bound_index)
            and self._bound_index[i][1] == e.seq
        ):
            self._bound_index.pop(i)

    def flush(self, reason: str) -> None:
        with self._lock:
            self._entries.clear()
            self._by_key.clear()
            self._bound_index.clear()
        self._m_flushes.labels(reason).inc()

    # --- request path -------------------------------------------------------

    @staticmethod
    def _cache_key(
        tenant: str | None,
        path: str,
        fp: str,
        k: int,
        max_staleness_ms: float | None,
    ) -> tuple:
        return (tenant or "", path or "", fp, int(k), max_staleness_ms)

    def _bypass(self, max_staleness_ms: float | None) -> str | None:
        """Non-None = reason the cache must not answer right now."""
        if self._client is None:
            return None  # TTL mode: per-entry expiry decides
        lag = self.stream_staleness_s()
        if lag is None:
            return "bypass_lag"  # disconnected: no invalidation feed
        if lag > self.max_lag_s:
            return "bypass_lag"
        if max_staleness_ms is not None and lag * 1000.0 > max_staleness_ms:
            return "bypass_lag"
        return None

    def lookup(
        self,
        tenant: str | None,
        body: bytes,
        max_staleness_ms: float | None,
        path: str = "",
    ) -> tuple[int, bytes, dict] | None:
        """A cached answer for this read, or None (forward to a
        replica).  Hits carry the freshness headers the degrade
        contract requires."""
        reason = self._bypass(max_staleness_ms)
        if reason is not None:
            self._m_lookups.labels(reason).inc()
            return None
        fped = fingerprint(body)
        if fped is None:
            self._m_lookups.labels("bypass_uncacheable").inc()
            return None
        fp, values = fped
        k = _k_of(values)
        if k is None:
            self._m_lookups.labels("bypass_uncacheable").inc()
            return None
        ck = self._cache_key(tenant, path, fp, k, max_staleness_ms)
        now = time.monotonic()
        with self._lock:
            e = self._entries.get(ck)
            if e is not None and self._client is None:
                # TTL mode: the request's own staleness bound tightens
                # the expiry — a bounded read must never get an answer
                # older than it asked for just because the TTL allows it
                ttl = self.ttl_s
                if max_staleness_ms is not None:
                    ttl = min(ttl, max_staleness_ms / 1000.0)
                if now - e.stored_at > ttl:
                    self._drop_locked(ck)
                    self._m_evictions.labels("ttl").inc()
                    e = None
            if e is None:
                self._m_lookups.labels("miss").inc()
                return None
            self._entries.move_to_end(ck)
            payload, base_headers, tick = e.payload, e.headers, e.tick
            age = now - e.stored_at
            # freshness captured under the SAME lock that proved the
            # entry live: the entry is provably equal to a fresh answer
            # as of the stream position it survived, so these are the
            # response's freshness claims (a tick landing after this
            # point is the same as the read arriving a moment earlier)
            streamed = self._client is not None
            applied = self.applied_tick if streamed else None
            lag = self.stream_staleness_s() if streamed else None
        self._m_lookups.labels("hit").inc()
        headers = dict(base_headers)
        headers[CACHE_HEADER] = "hit"
        if applied is not None:
            headers["x-pathway-applied-tick"] = str(applied)
            headers["x-pathway-staleness-seconds"] = f"{(lag or 0.0):.3f}"
        else:
            headers.setdefault("x-pathway-applied-tick", str(tick))
            headers["x-pathway-staleness-seconds"] = f"{age:.3f}"
        return 200, payload, headers

    def store(
        self,
        tenant: str | None,
        body: bytes,
        max_staleness_ms: float | None,
        status: int,
        payload: bytes,
        headers: dict,
        path: str = "",
    ) -> bool:
        """Consider one routed response for caching.  Only fresh 200s
        carrying the KNN ``matches`` contract are kept."""
        if status != 200:
            return False
        hl = {k.lower(): v for k, v in headers.items()}
        if hl.get("x-pathway-stale"):
            return False  # degraded answers are never cached
        fped = fingerprint(body)
        if fped is None:
            return False
        fp, values = fped
        try:
            doc = json.loads(payload)
        except ValueError:
            return False
        if not isinstance(doc, dict):
            return False  # 200s outside the KNN contract pass through
        matches = doc.get("matches")
        if not isinstance(matches, list):
            return False
        tick_raw = hl.get("x-pathway-applied-tick")
        try:
            tick = int(tick_raw) if tick_raw is not None else -1
        except ValueError:
            tick = -1
        k = _k_of(values)
        if k is None:
            return False
        try:
            keys = frozenset(int(m[0]) for m in matches)
            worst = min(float(m[1]) for m in matches) if matches else 0.0
        except (TypeError, ValueError, IndexError):
            return False
        qvec: np.ndarray | None = None
        if values.get("vec") is not None:
            try:
                qvec = self._prep_vec(values["vec"])
            except (TypeError, ValueError):
                qvec = None
        elif values.get("query") is not None:
            from pathway_tpu_torch.serving.replica import text_vector

            qvec = self._prep_vec(text_vector(str(values["query"]), self.dim))
        entry = _Entry(
            payload,
            {
                k: v
                for k, v in headers.items()
                if k.lower()
                in ("content-type", "x-pathway-replica", "x-pathway-shards")
            },
            qvec,
            keys,
            worst,
            len(matches) >= k,
            tick,
        )
        ck = self._cache_key(tenant, path, fp, k, max_staleness_ms)
        with self._lock:
            if self._client is not None:
                # ordering guard, under the SAME lock ingest() updates
                # _seen_tick through: if the invalidation stream has
                # started (or finished) a tick PAST the answering
                # replica's applied tick, a delta this cache already
                # processed may postdate the answer — its eviction pass
                # could never cover this entry.  Skip the store.
                if tick < 0 or max(self._seen_tick, self.applied_tick) > tick:
                    return False
            self._drop_locked(ck)  # replace: unindex the old result set
            self._entry_seq += 1
            entry.seq = self._entry_seq
            import bisect

            bisect.insort(
                self._bound_index, (entry.bound, entry.seq, ck)
            )
            self._entries[ck] = entry
            self._entries.move_to_end(ck)
            for key in keys:
                self._by_key.setdefault(key, set()).add(ck)
            while len(self._entries) > self.capacity:
                oldest = next(iter(self._entries))
                self._drop_locked(oldest)
                self._m_evictions.labels("lru").inc()
        return True

    # --- introspection ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def entry_keys(self) -> list[tuple]:
        with self._lock:
            return list(self._entries)


def cache_from_env() -> ResultCache | None:
    """The router's result cache when ``PATHWAY_ROUTER_CACHE=1``, with
    the invalidation stream attached when
    ``PATHWAY_ROUTER_CACHE_WRITER=host:port`` names the writer's delta
    endpoint — else None: the total escape hatch (no cache object, no
    cache branch on the request path)."""
    if not cache_enabled_via_env():
        return None
    cache = ResultCache()
    writer = os.environ.get(_WRITER_ENV, "").strip()
    if writer:
        host, _, port = writer.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"{_WRITER_ENV}={writer!r} is not host:port"
            )
        cache.attach_stream(host, int(port))
    return cache
