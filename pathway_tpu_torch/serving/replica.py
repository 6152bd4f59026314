"""Replica Shield read replicas — counterpart of
``pathway_tpu/serving/replica.py``.

What differs from the reference: the HTTP front is the port's own
standard-library server (``io/http/_web.py``; the card's machine has no
aiohttp); the role's index lives on ``device`` (``PATHWAY_REPLICA_DEVICE``,
default ``cuda``, which raises without a card — there is no CPU fallback),
so every read is a ``block_topk`` launch there; ``/debug/signals`` and
``/debug/trace`` answer 501 naming [observability] (the SLO sampler and the
fleet trace plane are not ported), and ``main()`` skips ``arm_sampler``
saying so; ``GET /replica/kernels`` reports the process's kernel launches
(``block_topk`` per ``(B, k)``, ``paged_attention``) and peak device
memory. Hydration reads stores of either package
(``persistence/_pickle.py``).

The horizontal read plane.

A replica is a NEW process role beside the lockstep mesh group: it runs
no engine graph and joins no barriers.  It holds a full copy of the
serving index, built in two steps and kept fresh by a third:

1. **Hydrate** from the newest committed snapshot generation in the
   writer's persistence store (``hydrate_index_state`` walks the
   retained-generation list newest-first and loads the
   ``ExternalIndexNode`` state blob — the same artifact the mmap
   recovery path restores), giving the corpus as of the snapshot's
   tick.
2. **Subscribe** to the writer's delta stream
   (parallel/replicate.py) from that tick: the ring tail replays, then
   live consolidated per-tick deltas apply.  A subscription that fell
   off the writer's bounded ring answers ``resync`` and the replica
   re-hydrates from the (by now newer) generation instead.
3. **Serve** reads over HTTP with explicit freshness: every response
   carries ``x-pathway-replica`` / ``x-pathway-applied-tick`` /
   ``x-pathway-staleness-seconds``, stale answers add
   ``x-pathway-stale: true``, and a request's
   ``x-pathway-max-staleness-ms`` bound sheds with 503 + Retry-After
   instead of silently serving older data — the same header contract
   the degraded single-process path established
   (serving/degrade.py), now per replica.

Freshness for ROUTING: ``ready`` is True only once the replica has
caught up with the writer's newest published tick since its current
subscription — a restarted replica is only re-admitted by the failover
router (serving/router.py) after it clears this bound.

Observability: ``pathway_replica_staleness_seconds`` (gauge, labeled by
replica), ``pathway_replica_applied_tick``, request/shed counters.
Monotone ``applied_tick`` is exported on every response and in
``GET /replica/health``.

``python -m pathway_tpu_torch.serving.replica`` runs the env-configured KNN
replica (TpuDenseKnnIndex + the deterministic ``text_vector``
pseudo-embedder) — the role the chaos bench and the multi-process tests
spawn under the Phoenix Mesh supervisor.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch._unported import OBSERVABILITY, unported
from pathway_tpu_torch.observability.journal import record as _journal_record
from pathway_tpu_torch.observability.tracing import get_tracer

_STALE_AFTER_MS_ENV = "PATHWAY_REPLICA_STALE_AFTER_MS"


def text_vector(text: str, dim: int) -> np.ndarray:
    """Deterministic pseudo-embedding: the same text always maps to the
    same unit vector, on the writer and on every replica — so the
    replicated serving plane (and its tests/bench) needs no shared
    encoder weights.  Not a semantic embedder; similar ONLY for equal
    text prefixes by construction (chunks are seeded per token)."""
    acc = np.zeros(dim, dtype=np.float64)
    for i, tok in enumerate(str(text).split() or [""]):
        seed = hashlib.blake2b(
            f"{i}:{tok}".encode(), digest_size=8
        ).digest()
        rng = np.random.default_rng(int.from_bytes(seed, "little"))
        acc += rng.standard_normal(dim)
    norm = float(np.linalg.norm(acc))
    if norm > 0:
        acc /= norm
    return acc.astype(np.float32)


def staleness_bound_exceeded(
    staleness: float | None, stale: bool, max_raw: str | None
) -> bool:
    """The ``x-pathway-max-staleness-ms`` shed predicate — ONE rule for
    every route that answers from this replica's corpus (/query reads
    AND /generate, whose output is conditioned on it).  Unknown
    staleness counts as over any finite bound; a caught-up replica is
    FRESH (staleness ~0 between heartbeats), so bound 0 sheds only
    when genuinely stale.  Unparseable/non-finite bounds are ignored
    (no bound)."""
    import math

    if max_raw is None:
        return False
    try:
        bound_ms = float(max_raw)
    except ValueError:
        return False
    if not math.isfinite(bound_ms):
        return False
    over = staleness is None or staleness * 1000.0 > bound_ms
    return over or (bound_ms <= 0.0 and stale)


def hydrate_index_state(
    store: Any, node_class: str = "ExternalIndexNode"
) -> tuple[Any, int, int] | None:
    """Load the newest committed index snapshot from a writer's
    persistence store: ``(index_state, tick, gen)`` or None when no
    generation holds an index yet.

    Candidates are walked newest-first — the current ``state`` then the
    ``retained_states`` list (legacy ``prev_state``) — so a torn
    latest generation degrades to the previous committed one instead of
    failing the hydrate, mirroring the group-min restore."""
    from pathway_tpu_torch.persistence import _pickle
    from pathway_tpu_torch.persistence._runtime_glue import _META_KEY, state_key

    raw = store.get(_META_KEY)
    if raw is None:
        return None
    meta = json.loads(raw.decode())
    candidates = [meta.get("state")]
    candidates += [
        r.get("state") for r in reversed(meta.get("retained_states", []))
    ]
    if meta.get("prev_state"):
        candidates.append(meta["prev_state"])
    seen: set[int] = set()
    for snap in candidates:
        if not snap or int(snap.get("gen", -1)) in seen:
            continue
        gen = int(snap["gen"])
        seen.add(gen)
        for ident, cls in snap.get("nodes", {}).items():
            if cls != node_class:
                continue
            blob = store.get(state_key(gen, ident))
            if blob is None:
                continue  # torn generation: fall back to an older one
            state = _pickle.loads(blob)
            if not isinstance(state, dict) or "index_state" not in state:
                continue
            return (
                state["index_state"],
                int(snap.get("time", 0)),
                gen,
            )
    return None


_M: dict | None = None


def _metrics() -> dict:
    global _M
    if _M is None:
        from pathway_tpu_torch.observability import REGISTRY

        _M = {
            "staleness": REGISTRY.gauge(
                "pathway_replica_staleness_seconds",
                "seconds since this replica last confirmed it was caught "
                "up with the writer's newest published tick, by replica",
                labelnames=("replica",),
            ),
            "applied": REGISTRY.gauge(
                "pathway_replica_applied_tick",
                "newest writer tick this replica has applied (monotone)",
                labelnames=("replica",),
            ),
            "requests": REGISTRY.counter(
                "pathway_replica_requests_total",
                "read requests served by this replica, by status class",
                labelnames=("replica", "status"),
            ),
            "resyncs": REGISTRY.counter(
                "pathway_replica_resyncs_total",
                "full re-hydrates (subscription fell off the writer's "
                "retained-delta ring)",
                labelnames=("replica",),
            ),
        }
    return _M


def default_knn_responder(server: "ReplicaServer", values: dict) -> dict:
    """Answer a KNN read against the replica's corpus: ``vec`` (raw
    query vector) or ``query`` (text through :func:`text_vector`), plus
    ``k``.  Matches return as ``[key, score]`` pairs, best first."""
    k = int(values.get("k", 3))
    if values.get("vec") is not None:
        vec = np.asarray(values["vec"], dtype=np.float32)
    else:
        vec = text_vector(str(values.get("query", "")), server.dim)
    results = server.search([(vec, k, None)])[0]
    return {"matches": [[int(key), float(score)] for key, score in results]}


class ReplicaServer:
    """One read replica: hydrated index + delta subscription + HTTP.

    ``index_factory`` builds the (empty) index object; ``store_root``
    (optional) hydrates it from the writer's persistence store;
    ``writer_port`` subscribes to the delta stream.  ``responder(server,
    values) -> payload`` answers one read (default: KNN over ``vec`` /
    ``query``+``k``).  ``qos`` (a serving.QoSConfig) bounds concurrent
    reads with the Surge-Gate admission controller — the router load-
    balances IN FRONT of this gate, so a saturated replica sheds 429
    and the router steers elsewhere.  ``device`` is where generation
    (``attach_generate``) runs; the index is where ``index_factory`` puts
    it."""

    def __init__(
        self,
        *,
        replica_id: int,
        index_factory: Callable[[], Any],
        store_root: str | None = None,
        writer_host: str = "127.0.0.1",
        writer_port: int | None = None,
        writer_endpoints: list[tuple[str, int]] | None = None,
        http_host: str = "127.0.0.1",
        http_port: int = 0,
        route: str = "/query",
        responder: Callable[["ReplicaServer", dict], Any] | None = None,
        qos: Any = None,
        dim: int = 32,
        stale_after_ms: float | None = None,
        shard: int = -1,
        n_shards: int = 1,
        device: str = "cuda",
    ):
        self.device = resolve_device(device)
        self.replica_id = int(replica_id)
        self.index_factory = index_factory
        self.store_root = store_root
        self.writer_host = writer_host
        self.writer_port = writer_port
        self.writer_endpoints = writer_endpoints
        self.http_host = http_host
        self.http_port = http_port
        self.route = route
        self.responder = responder or default_knn_responder
        self.dim = dim
        # Shard Harbor: this member owns one key range (jk-hash shard)
        # of the corpus; the writer fans it only that shard's deltas and
        # hydration drops foreign keys, so resident memory is ~1/S.  A
        # torn assignment (shard outside [0, n_shards)) is rejected at
        # BOOT, not discovered as silently-wrong answers.
        self.n_shards = max(int(n_shards), 1)
        self.shard = int(shard)
        if self.n_shards > 1 and not (0 <= self.shard < self.n_shards):
            raise ValueError(
                f"replica {replica_id}: shard {self.shard} is outside "
                f"the {self.n_shards}-shard assignment map (torn shard "
                "configuration rejected at boot)"
            )
        if self.n_shards == 1:
            self.shard = -1  # unsharded plane: full corpus
        if stale_after_ms is None:
            stale_after_ms = float(
                os.environ.get(_STALE_AFTER_MS_ENV, "3000") or 3000
            )
        self.stale_after_s = max(stale_after_ms, 0.0) / 1000.0
        self._has_stream = bool(
            writer_port is not None or writer_endpoints
        )
        self.index = index_factory()
        self.hydrated_tick = -1
        self.hydrated_gen = -1
        self.hydrate_seconds = 0.0  # the last hydrate's wall seconds
        self._index_lock = threading.RLock()
        self._client: Any = None
        self._closed = False
        self.incarnation = int(
            os.environ.get("PATHWAY_MESH_INCARNATION", "0") or 0
        )
        m = _metrics()
        label = str(self.replica_id)
        self._m_requests = m["requests"]
        self._m_resyncs = m["resyncs"].labels(label)
        m["staleness"].labels(label).set_function(
            lambda: self.staleness_seconds() or 0.0
        )
        m["applied"].labels(label).set_function(
            lambda: float(self.applied_tick)
        )
        from pathway_tpu_torch.serving.admission import AdmissionController
        from pathway_tpu_torch.serving.tenancy import ledger_for

        # Tenant Weave: PATHWAY_TENANT_QOS=1 makes this replica's
        # admission tenant-aware (per-tenant fair-share buckets inside
        # the gate's capacity envelope) — the router forwards the
        # x-pathway-tenant header, so the shed lands on the hot tenant
        # at every member it is steered to
        self.tenant_ledger = (
            ledger_for(qos, route=f"replica{self.replica_id}")
            if qos is not None
            else None
        )
        self.admission = (
            AdmissionController(
                qos,
                route=f"replica{self.replica_id}",
                ledger=self.tenant_ledger,
            )
            if qos is not None
            else None
        )
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # Token Loom: extra POST routes mounted before start() —
        # generate.serving.attach_generate registers the /generate
        # handler (an async fn(http, request) -> StreamResponse) and
        # the decode scheduler here
        self.extra_post_routes: dict[str, Any] = {}
        self.generate_scheduler: Any = None
        self._http = _ReplicaHttp(self)

    # --- state ------------------------------------------------------------

    @property
    def applied_tick(self) -> int:
        c = self._client
        if c is not None:
            return max(c.applied_tick, self.hydrated_tick)
        return self.hydrated_tick

    @property
    def ready(self) -> bool:
        """Freshness bound for router admission: hydrated AND caught up
        with the writer's newest published tick since the current
        subscription.  With no delta stream configured (snapshot-only
        replica) readiness is just successful hydration."""
        c = self._client
        if c is None:
            return self.hydrated_tick >= 0 or not self._has_stream
        return bool(c.caught_up)

    def staleness_seconds(self) -> float | None:
        c = self._client
        if c is None:
            return None
        return c.staleness_seconds()

    def is_stale(self) -> bool:
        """A response right now would be stale: never caught up, the
        catch-up confirmation has aged past the bound (writer dead or
        partitioned), or the stream is behind."""
        c = self._client
        if c is None:
            return self._has_stream
        s = c.staleness_seconds()
        if s is None:
            return True
        return s > self.stale_after_s

    # --- lifecycle --------------------------------------------------------

    def start(self) -> "ReplicaServer":
        self.hydrate()
        if self.writer_port is not None or self.writer_endpoints:
            from pathway_tpu_torch.parallel.replicate import DeltaStreamClient

            eps = self.writer_endpoints or [
                (self.writer_host, int(self.writer_port))
            ]
            self._client = DeltaStreamClient(
                eps[0][0],
                eps[0][1],
                self.replica_id,
                from_tick=self.hydrated_tick,
                on_deltas=self._apply_deltas,
                # store-less replicas have no hydrate path: accept-the-
                # gap semantics (client converges on the writer's ring)
                # instead of waiting for a snapshot that can never come
                on_resync=self._resync if self.store_root else None,
                on_applied=self._on_applied,
                shard=self.shard,
                expect_shards=self.n_shards if self.n_shards > 1 else 0,
                endpoints=eps,
            )
            self._client.start()
        self._http.start()
        self.http_port = self._http.port
        # Tick Scope: a serving surface is now live — the
        # tickscope-coverage doctor rule INFOs if the flight recorder is
        # disabled while this replica serves. The memory provider hands
        # the replica's index residency to the same ledger the engine
        # execs report into (owner "replica:<id>").
        from pathway_tpu_torch.observability import tickscope as _ts

        import weakref as _weakref

        _r = _weakref.ref(self)

        def _replica_memory():
            rep = _r()
            if rep is None or rep._closed:
                return {}
            _docs, nbytes = rep.corpus_stats()
            return {"index": max(int(nbytes), 0)}

        _ts.register_memory_provider(
            f"replica:{self.replica_id}", _replica_memory
        )
        _ts.mark_serving(True)
        return self

    def stop(self) -> None:
        self._closed = True
        if self._client is not None:
            self._client.close()
        if self.generate_scheduler is not None:
            self.generate_scheduler.stop()
        self._http.stop()
        from pathway_tpu_torch.observability import tickscope as _ts

        _ts.unregister_memory_provider(f"replica:{self.replica_id}")

    # --- hydrate + deltas -------------------------------------------------

    def _open_store(self):
        from pathway_tpu_torch.persistence.backends import FilesystemStore

        return FilesystemStore(self.store_root)

    def hydrate(self) -> int:
        """(Re-)hydrate the index from the newest committed generation;
        returns the hydrated tick (-1 when no store/snapshot exists —
        the replica then builds purely from the delta stream).  A
        sharded member drops every key outside its shard right after
        the load, so resident memory is ~1/S of the writer's corpus."""
        if self.store_root is None:
            return self.hydrated_tick
        t0 = time.perf_counter()
        with get_tracer().span(
            "replica.hydrate", root=True, replica=self.replica_id
        ) as span:
            got = hydrate_index_state(self._open_store())
            if got is None:
                return self.hydrated_tick
            index_state, tick, gen = got
            fresh = self.index_factory()
            kind, payload = index_state
            if kind == "dict":
                fresh.load_state(payload)
            else:
                fresh = payload
            if self.shard >= 0:
                self._filter_to_shard(fresh)
            with self._index_lock:
                self.index = fresh
                self.hydrated_tick = tick
                self.hydrated_gen = gen
            self.hydrate_seconds = time.perf_counter() - t0
            span.set_attribute("tick", tick)
            span.set_attribute("generation", gen)
        _journal_record(
            "replica-hydrated",
            f"replica {self.replica_id} hydrated generation {gen}",
            tick=tick,
            incarnation=self.incarnation,
            replica_id=self.replica_id,
            generation=gen,
        )
        return tick

    def _filter_to_shard(self, index: Any) -> None:
        """Drop hydrated keys this member does not own (the writer's
        snapshot holds the FULL corpus; the delta stream is already
        shard-filtered).  Prefers the index's compacting
        ``filter_keys`` (releases the backing buffers — the ~1/S
        memory claim); falls back to per-key ``remove``."""
        from pathway_tpu_torch.parallel.replicate import corpus_shard_of

        keys_fn = getattr(index, "keys", None)
        if not callable(keys_fn):
            logging.getLogger("pathway_tpu_torch").warning(
                "replica %d: index %s exposes no keys(); serving the "
                "FULL hydrated corpus on a sharded plane",
                self.replica_id,
                type(index).__name__,
            )
            return
        keys = list(keys_fn())
        if not keys:
            return
        dest = corpus_shard_of(keys, self.n_shards)
        owned = {
            k for k, s in zip(keys, dest) if int(s) == self.shard
        }
        filt = getattr(index, "filter_keys", None)
        if callable(filt):
            filt(lambda k: k in owned)
            return
        for k in keys:
            if k not in owned:
                index.remove(k)

    def _resync(self) -> int:
        """Delta-stream callback: the subscription tick fell off the
        writer's bounded ring — beyond it, full re-hydrate (tentpole
        contract (c))."""
        self._m_resyncs.inc()
        _journal_record(
            "replica-resync",
            f"replica {self.replica_id} fell off the delta ring",
            tick=self.applied_tick,
            incarnation=self.incarnation,
            replica_id=self.replica_id,
        )
        return self.hydrate()

    # --- live resharding (Shard Flux) -------------------------------------

    def adopt_shard_map(self, shard: int, n_shards: int) -> None:
        """Adopt a NEW shard assignment without a process restart — the
        member-side half of a live reshard.  The old subscription closes
        (a resharded writer fences it at suback anyway — the transition
        guard), the resident corpus re-partitions under the new
        ownership (store-backed members re-hydrate so a MERGE gains its
        newly-owned foreign keys; store-less members can only narrow),
        and a fresh subscription opens with the new expectations.  The
        HTTP plane keeps serving throughout — the router's health poll
        sees ``ready`` flip false and back as the member catches up."""
        n_shards = max(int(n_shards), 1)
        shard = int(shard) if n_shards > 1 else -1
        if n_shards > 1 and not (0 <= shard < n_shards):
            raise ValueError(
                f"replica {self.replica_id}: shard {shard} is outside "
                f"the {n_shards}-shard assignment map"
            )
        old = self._client
        if old is not None:
            old.close()
            self._client = None
        from_tick = self.hydrated_tick
        if old is not None:
            from_tick = max(from_tick, old.applied_tick)
        prev_shard, prev_n = self.shard, self.n_shards
        self.shard, self.n_shards = shard, n_shards
        if self.store_root:
            # full re-partition: the snapshot holds the whole corpus,
            # hydrate() filters it to the NEW ownership (mmap — no wire)
            from_tick = self.hydrate()
        elif shard >= 0 and (
            prev_shard < 0
            or prev_n != n_shards
            or shard != prev_shard
        ):
            # store-less member: can only NARROW what it already holds
            # — a changed shard INDEX at the same count re-filters too
            # (serving the old range under the new label would hand
            # the router healthy-looking wrong answers); a merge that
            # needs foreign keys requires a store (or a restart
            # against the resharded writer's full replay)
            with self._index_lock:
                self._filter_to_shard(self.index)
        if self._has_stream:
            from pathway_tpu_torch.parallel.replicate import DeltaStreamClient

            eps = self.writer_endpoints or [
                (self.writer_host, int(self.writer_port))
            ]
            self._client = DeltaStreamClient(
                eps[0][0],
                eps[0][1],
                self.replica_id,
                from_tick=from_tick,
                on_deltas=self._apply_deltas,
                on_resync=self._resync if self.store_root else None,
                on_applied=self._on_applied,
                shard=self.shard,
                expect_shards=self.n_shards if self.n_shards > 1 else 0,
                endpoints=eps,
            )
            self._client.start()
        logging.getLogger("pathway_tpu_torch").info(
            "replica %d: adopted shard map %s/%d (was %s/%d)",
            self.replica_id,
            shard,
            n_shards,
            prev_shard,
            prev_n,
        )
        # the reshard window's member-side edge in /fleet/events
        _journal_record(
            "shard-map-adopt",
            f"replica {self.replica_id} now owns shard {shard}/{n_shards} "
            f"(was {prev_shard}/{prev_n})",
            tick=from_tick,
            incarnation=self.incarnation,
            persist=True,
            replica_id=self.replica_id,
            shard=shard,
            n_shards=n_shards,
            prev_shard=prev_shard,
            prev_n_shards=prev_n,
        )

    def _apply_deltas(self, tick: int, batches: list) -> None:
        with self._index_lock:
            for b in batches:
                for k, d, vals in b.iter_rows():
                    if d > 0:
                        self.index.upsert(k, vals[0], vals[1])
                    else:
                        self.index.remove(k)

    def _on_applied(self, tick: int, n_applied: int) -> None:
        from pathway_tpu_torch.testing import faults

        plan = faults.active()
        if plan is not None:
            plan.on_replica_tick(self.replica_id, n_applied)

    def search(self, triples: list) -> list:
        with self._index_lock:
            return self.index.search(triples)

    # --- serving ----------------------------------------------------------

    def corpus_stats(self) -> tuple[int, int]:
        """(resident docs, resident corpus bytes) — the per-member
        memory evidence the shard×replica sweep records (~1/S per
        member on a sharded plane)."""
        with self._index_lock:
            idx = self.index
            try:
                # O(1) — health is polled every PATHWAY_ROUTER_HEALTH_MS
                # under the same lock the query path takes, so never
                # materialize the key set here
                docs = len(idx)
            except TypeError:
                keys_fn = getattr(idx, "keys", None)
                docs = len(keys_fn()) if callable(keys_fn) else -1
            bytes_fn = getattr(idx, "resident_bytes", None)
            nbytes = int(bytes_fn()) if callable(bytes_fn) else -1
        return docs, nbytes

    def health(self) -> dict:
        c = self._client
        s = self.staleness_seconds()
        docs, nbytes = self.corpus_stats()
        gen = (
            self.generate_scheduler.stats()
            if self.generate_scheduler is not None
            else None
        )
        return {
            "generate": gen,
            "replica": self.replica_id,
            "incarnation": self.incarnation,
            "applied_tick": self.applied_tick,
            "newest_tick": c.newest_known if c is not None else -1,
            "staleness_seconds": s,
            "connected": bool(c.connected) if c is not None else False,
            "ready": self.ready,
            "stale": self.is_stale(),
            "inflight": self._inflight
            if self.admission is None
            else self.admission.inflight,
            "resyncs": c.resyncs if c is not None else 0,
            "hydrated_gen": self.hydrated_gen,
            "shard": self.shard,
            "n_shards": self.n_shards,
            "writer_incarnation": (
                c.writer_incarnation if c is not None else -1
            ),
            "fenced_writers": c.fenced_count if c is not None else 0,
            "config_error": c.config_error if c is not None else None,
            "corpus_docs": docs,
            "corpus_bytes": nbytes,
        }

    def _count(self, status: int) -> None:
        self._m_requests.labels(str(self.replica_id), str(status)).inc()


def kernel_launches() -> dict:
    """This process's hand-written kernel launches: ``block_topk`` per
    ``(B, k)`` and ``paged_attention`` in all (the wrappers' counters),
    and its peak device memory (None before CUDA is initialised)."""
    import torch

    from pathway_tpu_torch.ops import block_topk as _bt
    from pathway_tpu_torch.ops import paged_attention as _pa

    return {
        "block_topk": _bt.block_topk.launches,
        "block_topk_by_shape": {
            f"B={b},k={k}": n for (b, k), n in sorted(_bt.block_topk.shapes.items())
        },
        "paged_attention": _pa.paged_attention.launches,
        "peak_allocated_bytes": (
            torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else None
        ),
    }


def _not_ported(route: str):
    """A 501 naming the ROADMAP item of a route the port lacks."""
    from pathway_tpu_torch.io.http import _web

    return _web.json_response(
        {"error": str(unported(route, OBSERVABILITY))}, status=501
    )


class _ReplicaHttp:
    """The replica's HTTP front (own loop thread, the port's
    standard-library server): POST <route> answers reads, GET
    /replica/health reports freshness for the router's poller."""

    def __init__(self, server: ReplicaServer):
        self.server = server
        self.port = server.http_port
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_ready = threading.Event()
        self._stop_async: Any = None
        self._thread: threading.Thread | None = None
        self._started = False
        self._stopped = False
        self._bound = threading.Event()

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._thread = threading.Thread(
            target=self._run,
            daemon=True,
            name=f"pw-replica-http-{self.server.replica_id}",
        )
        self._thread.start()
        self._bound.wait(30.0)

    def _run(self) -> None:
        from pathway_tpu_torch.io.http import _web

        srv = self.server
        app = _web.Application(shutdown_timeout=1.0)

        async def handle_read(request):
            return await self._handle_read(request)

        async def handle_health(request):
            return _web.json_response(srv.health())

        async def handle_kernels(request):
            return _web.json_response(kernel_launches())

        # Fleet Lens: the GET surfaces that make this replica a fleet
        # member
        async def handle_metrics(request):
            from pathway_tpu_torch.observability import REGISTRY

            return _web.Response(
                REGISTRY.render().encode(),
                content_type="text/plain; charset=utf-8",
            )

        async def handle_events(request):
            from pathway_tpu_torch.observability.journal import journal

            j = journal()
            return _web.json_response(
                {"member": j.member, "events": j.events()}
            )

        async def handle_signals(request):
            return _not_ported("/debug/signals (observability/signals.py)")

        async def handle_trace(request):
            return _not_ported("/debug/trace (observability/fleet.py)")

        app.add_route("POST", srv.route, handle_read)
        app.add_get("/replica/health", handle_health)
        app.add_get("/replica/kernels", handle_kernels)
        app.add_get("/metrics", handle_metrics)
        app.add_get("/debug/events", handle_events)
        app.add_get("/debug/signals", handle_signals)
        app.add_get("/debug/trace", handle_trace)
        for path, fn in srv.extra_post_routes.items():

            async def handle_extra(request, _fn=fn):
                try:
                    resp = await _fn(self, request)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    if request._streamed:
                        raise  # the stream's head is out: cut the body
                    # a handler bug must surface as a COUNTED
                    # structured 500, never a bare server 500
                    # invisible to srv._count
                    resp = _web.json_response(
                        {"error": f"{type(exc).__name__}: {exc}"},
                        status=500,
                    )
                # a streamed generation commits HTTP 200 at prepare;
                # its REAL outcome (e.g. a 504 mid-stream drop) rides
                # the override so request accounting stays honest
                srv._count(
                    getattr(resp, "_pathway_status_override", None)
                    or resp.status
                )
                return resp

            app.add_route("POST", path, handle_extra)
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        stop_ev = asyncio.Event()
        self._stop_async = lambda: loop.call_soon_threadsafe(stop_ev.set)
        self._loop_ready.set()

        def bound(port: int) -> None:
            self.port = port
            self._bound.set()

        try:
            if not self._stopped:
                loop.run_until_complete(
                    app.serve(srv.http_host, self.port, stop_ev, bound)
                )
        finally:
            self._bound.set()
            loop.close()

    async def _handle_read(self, request):
        from pathway_tpu_torch.io.http import _web
        from pathway_tpu_torch.observability import tracing

        srv = self.server
        span = tracing.get_tracer().span(
            "replica.request",
            parent=tracing.parse_traceparent(
                request.headers.get("traceparent")
            ),
            root=True,
            replica=srv.replica_id,
            route=srv.route,
        )
        with span:
            status, payload, headers = await self._serve(request)
            span.set_attribute("status", status)
        srv._count(status)
        if span.context is not None:
            headers["traceparent"] = span.context.traceparent()
        return _web.json_response(payload, status=status, headers=headers)

    async def _serve(self, request) -> tuple[int, Any, dict]:
        from pathway_tpu_torch.serving.admission import ShedError

        srv = self.server
        staleness = srv.staleness_seconds()
        stale = srv.is_stale()
        headers = {
            "x-pathway-replica": str(srv.replica_id),
            "x-pathway-applied-tick": str(srv.applied_tick),
            "x-pathway-staleness-seconds": (
                f"{staleness:.3f}" if staleness is not None else "unknown"
            ),
        }
        if stale:
            headers["x-pathway-stale"] = "true"
        # the request's freshness bound: shed explicitly rather than
        # silently serve data older than the client can accept
        if staleness_bound_exceeded(
            staleness,
            stale,
            request.headers.get("x-pathway-max-staleness-ms"),
        ):
            return (
                503,
                {
                    "error": "replica staler than "
                    "x-pathway-max-staleness-ms",
                    "replica": srv.replica_id,
                },
                {"Retry-After": "1.0", **headers},
            )
        tenant = request.headers.get("x-pathway-tenant")
        tenant_class = request.headers.get("x-pathway-tenant-class")
        if srv.admission is not None:
            try:
                srv.admission.admit(
                    tenant=tenant, tenant_class=tenant_class
                )
            except ShedError as e:
                return (
                    e.status,
                    {"error": f"request shed: {e.reason}"},
                    {"Retry-After": f"{e.retry_after_s:.3f}", **headers},
                )
        else:
            with srv._inflight_lock:
                srv._inflight += 1
        try:
            try:
                values = await request.json()
            except ValueError:
                values = {}
            loop = asyncio.get_running_loop()
            payload = await loop.run_in_executor(
                None, srv.responder, srv, values
            )
            if srv.tenant_ledger is not None:
                srv.tenant_ledger.observe_staleness(tenant, staleness)
            return 200, payload, headers
        except Exception as exc:
            return (
                500,
                {"error": f"{type(exc).__name__}: {exc}"},
                headers,
            )
        finally:
            if srv.admission is not None:
                srv.admission.on_flushed(1)
                srv.admission.complete()
            else:
                with srv._inflight_lock:
                    srv._inflight -= 1

    def stop(self, timeout: float = 5.0) -> None:
        if not self._started or self._stopped:
            return
        self._stopped = True
        self._loop_ready.wait(timeout)
        stop_async = self._stop_async
        if stop_async is not None:
            try:
                stop_async()
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout)


def main() -> int:
    """Env-configured KNN replica — the subprocess role the multi-process
    failover tests and ``chip_smoke.py`` spawn:

    PATHWAY_REPLICA_ID        this replica's id (default 0)
    PATHWAY_REPLICA_STORE     writer's persistence root (hydration)
    PATHWAY_REPL_PORT         writer's delta-stream port
    PATHWAY_REPL_WRITER_HOST  writer host (default 127.0.0.1)
    PATHWAY_REPL_STANDBY      optional standby endpoint "host:port"
                              appended to the dial list (takeover)
    PATHWAY_REPLICA_HTTP_PORT HTTP port (default 0 = ephemeral)
    PATHWAY_REPLICA_DIM       vector dimensionality (default 32)
    PATHWAY_REPLICA_ROUTE     read route (default /query)
    PATHWAY_REPLICA_DEVICE    torch device of the index (default cuda)
    PATHWAY_SERVING_SHARDS    total corpus shards (default 1)
    PATHWAY_REPLICA_SHARD     the shard this member owns (required
                              when PATHWAY_SERVING_SHARDS > 1)

    Prints ``replica hydrate_s=<seconds>`` and ``REPLICA-READY
    <http_port>`` once serving, then runs until SIGTERM.  Exit code 0
    on clean termination; Fault-Forge kills exit with FAULT_EXIT (23)
    like every injected death.
    """
    import signal

    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex

    # the index and generation live on the card unless cpu is named; a
    # hidden card raises, it never falls back
    device = resolve_device(os.environ.get("PATHWAY_REPLICA_DEVICE", "") or "cuda")
    # the replica's Surge-Gate admission (its serving-capacity
    # envelope): PATHWAY_SERVING_ENABLED=1 + the standard
    # PATHWAY_SERVING_* knobs (RPS/BURST/MAX_INFLIGHT...) bound each
    # replica exactly like a gated writer endpoint — the router
    # balances IN FRONT of these gates
    from pathway_tpu_torch.serving import QoSConfig, serving_enabled_via_env

    qos = QoSConfig.from_env() if serving_enabled_via_env() else None
    dim = int(os.environ.get("PATHWAY_REPLICA_DIM", "32") or 32)
    writer_port_raw = os.environ.get("PATHWAY_REPL_PORT", "")
    writer_host = os.environ.get("PATHWAY_REPL_WRITER_HOST", "127.0.0.1")
    endpoints: list[tuple[str, int]] | None = None
    standby_raw = os.environ.get("PATHWAY_REPL_STANDBY", "")
    if writer_port_raw and standby_raw:
        host, _, port = standby_raw.rpartition(":")
        endpoints = [
            (writer_host, int(writer_port_raw)),
            (host or writer_host, int(port)),
        ]
    from pathway_tpu_torch.parallel.replicate import shards_env

    n_shards = shards_env()
    shard_raw = os.environ.get("PATHWAY_REPLICA_SHARD", "")
    server = ReplicaServer(
        replica_id=int(os.environ.get("PATHWAY_REPLICA_ID", "0") or 0),
        index_factory=lambda: TpuDenseKnnIndex(dimensions=dim, device=device),
        store_root=os.environ.get("PATHWAY_REPLICA_STORE") or None,
        writer_host=writer_host,
        writer_port=int(writer_port_raw) if writer_port_raw else None,
        writer_endpoints=endpoints,
        http_port=int(
            os.environ.get("PATHWAY_REPLICA_HTTP_PORT", "0") or 0
        ),
        route=os.environ.get("PATHWAY_REPLICA_ROUTE", "/query"),
        qos=qos,
        dim=dim,
        shard=int(shard_raw) if shard_raw else -1,
        n_shards=n_shards,
        device=str(device),
    )
    # Token Loom: PATHWAY_GENERATE=1 mounts the /generate route (the
    # ask->retrieve->generate stage) on this replica, configured by the
    # PATHWAY_GENERATE_* knobs (pool size, snapshot cadence, store)
    from pathway_tpu_torch.generate.scheduler import generate_enabled_via_env

    if generate_enabled_via_env():
        from pathway_tpu_torch.generate.serving import attach_generate

        attach_generate(server)
    # Fleet Lens: the reference arms its SLO sampler here; the port has
    # none yet, so the role says so and serves without it.  The
    # postmortem bundle on unhandled exceptions is ported.
    from pathway_tpu_torch.observability.journal import install_crash_hooks

    logging.getLogger("pathway_tpu_torch").warning(
        "replica %d: %s", server.replica_id, unported("arm_sampler", OBSERVABILITY)
    )
    install_crash_hooks()
    server.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())
    signal.signal(signal.SIGINT, lambda *_a: stop.set())
    print(f"replica hydrate_s={server.hydrate_seconds:.6f}", flush=True)
    print(f"REPLICA-READY {server.http_port}", flush=True)
    while not stop.is_set():
        stop.wait(0.2)
    server.stop()
    print("REPLICA-CLEAN-EXIT", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
