"""Replica Shield wire tier — counterpart of
``pathway_tpu/parallel/replicate.py``, all of it: the protocol (``PWRP2``
handshake, frame MACs, the columnar codec of ``wire.py``) is the
reference's, so a writer of either package serves replicas of the other
under the same ``PATHWAY_DCN_SECRET``, and a wrong secret is refused both
ways. The stream moves host-side numpy batches only; the device work is in
the indexes each side applies them to.

One writer streaming consolidated per-tick index deltas to N read replicas
over the PWHX7-family framed protocol.

The replicated read plane (ROADMAP "Replicated serving plane") splits the
serving topology into three roles: ONE writer (the engine process that
owns the index and the persistence store), N READ REPLICAS
(serving/replica.py — hydrate from the newest committed snapshot
generation, then apply this stream), and a failover ROUTER
(serving/router.py).  This module is the writer↔replica wire:

* ``DeltaStreamServer`` runs inside the writer.  The engine's
  ``ExternalIndexExec`` publishes its per-tick consolidated corpus
  deltas (``publish``); the server appends them to a bounded
  retained-delta ring and fans them out to every subscribed replica
  over per-subscriber bounded outboxes drained by sender threads — the
  same overlap/fail-stop shape as the host mesh's per-peer outboxes
  (parallel/host_exchange.py).  Frames reuse the typed columnar codec
  (parallel/wire.py): a delta frame IS a mesh data frame
  ``("data", 0, "repl:<node>", tick, [DiffBatch], tp)``, so key/diff
  packing and the embedding-column stacking apply unchanged.

* ``DeltaStreamClient`` runs inside each replica.  It dials the writer
  (jittered backoff, HMAC challenge-response under the same
  PATHWAY_DCN_SECRET job key as the mesh), subscribes from its
  snapshot's tick, replays the ring tail, then applies live frames.
  When the requested tick has already fallen off the ring the server
  answers ``resync`` and the replica re-hydrates from the (by now
  newer) snapshot generation instead — the bounded-ring contract of
  the tentpole: replay when cheap, full re-hydrate when not.

Shard Harbor (sharded corpus ownership): with
``PATHWAY_SERVING_SHARDS`` = S > 1 the writer splits every
consolidated per-tick delta batch by the DCN jk-hash partition
(engine/sharded.py ``shard_of`` — the same low-16-bit key routing the
device mesh and ``_DcnRouter`` use) and fans EACH SHARD'S stream only
to that shard's owners: a replica subscribing with ``shard=s`` (hello
field) receives only keys whose hash routes to s, so it hydrates and
holds ~1/S of the corpus.  Every subscriber still receives every
tick's (possibly empty) marker, so freshness tracking is
shard-independent.  A subscription whose expected shard count
disagrees with the writer's is refused at suback time (the torn
shard-assignment-map guard; the boot-time twin lives in
serving/router.py ``validate_shard_map``).

Standby takeover + incarnation fencing: the suback carries the
writer's ``PATHWAY_MESH_INCARNATION``.  A client remembers the highest
incarnation it has ever seen and REJECTS any writer presenting a lower
one (``fenced_count``) — after a standby takeover (parallel/standby.py
bumps the incarnation and resumes publishing on the writer endpoint), a
zombie primary that comes back can never feed replicas stale frames.
Clients accept a list of endpoints (primary first, standby next) and
rotate to the next endpoint on dial failure or fencing.

Freshness: every frame carries the writer's newest published tick, and
idle ticks still emit (empty) tick markers, so a replica always knows
whether it is caught up; heartbeats keep that knowledge fresh on idle
streams and double as the liveness signal for a dead/partitioned
writer.  The replica-side staleness clock
(``pathway_replica_staleness_seconds``) restarts whenever the replica
confirms ``applied_tick == newest_tick``.

Fault Forge: the sender loop runs every data frame through the same
``on_wire_send(channel)`` hook as the mesh, so
``drop/dup/delay=ch:repl...`` directives target the delta stream with
the familiar deterministic counters.

Authentication matches the mesh's threat model: delta frames carry
pickled control frames and codec batches, so every connection performs
the nonce challenge-response under the per-job shared secret and every
frame MAC covers (src, dst, seq, body).  A replica cannot be framed
dead by a forged frame, and unauthenticated bytes never reach
``pickle.loads``.
"""

from __future__ import annotations

import hmac
import os
import pickle
import queue
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable

from pathway_tpu_torch.observability.journal import record as _journal_record
from pathway_tpu_torch.observability.tracing import get_tracer
from pathway_tpu_torch.parallel import wire
from pathway_tpu_torch.parallel.host_exchange import (
    _MAC_LEN,
    _NONCE_LEN,
    _REJECT,
    _frame_mac,
    _job_key,
)

_REPL_MAGIC = b"PWRP2"  # replication protocol (sits beside the mesh's
# PWHX7: a replica is NOT a mesh rank — it never joins barriers — so the
# subscription stream gets its own handshake magic and version lane).
# v2 widens the hello with the subscriber's shard + expected shard count
# (Shard Harbor) and the suback with the writer's shard count +
# incarnation fencing token — a v1 peer's hello is a different length,
# so version skew fails the handshake instead of mis-parsing.
_OK_TAG = b"PWRO"
_HELLO_STRUCT = "<iqii"  # replica_id, from_tick, shard, expected shards

REPL_CHANNEL = "repl:idx"  # delta frames' wire channel (Fault Forge
# directives match it by prefix: drop/dup/delay=ch:repl)
STANDBY_CHANNEL = "repl:standby"  # the writer→standby leg: a standby
# subscriber's frames are re-tagged so Fault Forge directives can
# target JUST this leg (drop/dup/delay=ch:repl:standby) without
# touching the replica fan-out
STANDBY_ID = -2  # reserved replica_id for standby-writer subscriptions
OBSERVER_CHANNEL = "repl:observe"  # non-replica full-corpus observers
# (the router result cache's invalidation feed) — a distinct channel so
# Fault Forge can delay/drop the invalidation stream without touching
# the replica fan-out or the standby leg
OBSERVER_ID = -3  # reserved replica_id for observer subscriptions:
# negative ids may subscribe to the FULL corpus of a sharded writer
# (they never sit behind the router, so the torn-map guard passes)


def shards_env() -> int:
    """Serving-plane shard count, PATHWAY_SERVING_SHARDS (default 1 =
    every replica owns the full corpus — the pre-Shard-Harbor
    topology)."""
    raw = os.environ.get("PATHWAY_SERVING_SHARDS", "1") or "1"
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"PATHWAY_SERVING_SHARDS={raw!r} is not an int"
        ) from None
    if n < 1:
        raise ValueError(f"PATHWAY_SERVING_SHARDS={raw!r} must be >= 1")
    return n


def corpus_shard_of(keys, n_shards: int):
    """Shard assignment for corpus row keys — the DCN router's jk-hash
    partition (engine/sharded.py ``shard_of``: low 16 bits of the key
    mod the shard count), reused so the serving plane, the device mesh
    and the host mesh all agree on ownership."""
    import numpy as np

    from pathway_tpu_torch.engine.sharded import shard_of

    return shard_of(np.asarray(keys, dtype=np.uint64), n_shards)


def ring_ticks_env() -> int:
    """Bounded retained-delta ring depth (ticks), PATHWAY_REPL_RING
    (default 1024).  A replica whose subscription tick fell off the ring
    full-re-hydrates from the newest snapshot generation instead."""
    raw = os.environ.get("PATHWAY_REPL_RING", "1024") or "1024"
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"PATHWAY_REPL_RING={raw!r} is not an int"
        ) from None
    return max(n, 1)


class ReplicationError(RuntimeError):
    pass


def _shutdown_close(conn: socket.socket) -> None:
    """shutdown() BEFORE close(): a plain close() while another thread
    is blocked in recv() on the same socket keeps the file description
    alive (the in-flight syscall holds it), so no FIN ever reaches the
    peer and both sides hang; shutdown() tears the connection down at
    the description level, waking every blocked reader."""
    try:
        conn.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        conn.close()
    except OSError:
        pass


def _read_exact(conn: socket.socket, count: int) -> bytes | None:
    buf = b""
    while len(buf) < count:
        try:
            chunk = conn.recv(count - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


class _Subscriber:
    """One connected replica: bounded outbox + sender thread owning the
    connection's MAC sequence (frames leave in enqueue order)."""

    __slots__ = (
        "conn",
        "replica_id",
        "outbox",
        "backlog",
        "thread",
        "dead",
        "from_tick",
        "shard",
    )

    def __init__(self, conn: socket.socket, replica_id: int, depth: int):
        self.conn = conn
        self.replica_id = replica_id
        self.outbox: queue.Queue = queue.Queue(maxsize=depth)
        # ring-replay frames (suback first), sent by the sender thread
        # BEFORE it starts draining the outbox: the backlog can exceed
        # the outbox bound (up to ring_ticks entries), so it must never
        # go through put_nowait — a deep rejoin used to crash the
        # handshake thread with queue.Full and livelock the replica
        self.backlog: list[tuple] = []
        self.thread: threading.Thread | None = None
        self.dead = False
        self.from_tick = -1
        self.shard = -1  # -1 = full corpus (unsharded replica / standby)


class DeltaStreamServer:
    """Writer-side delta publisher: bounded retained ring + fan-out.

    ``publish(tick, batches)`` is called from the engine thread once per
    tick (idle ticks publish an empty marker so replicas track
    freshness); subscribers receive every published tick newer than
    their subscription point.  A subscriber that cannot keep up (full
    outbox) is dropped — it reconnects and replays the ring, or
    re-hydrates if it fell past the ring floor.  Never blocks the
    engine tick."""

    def __init__(
        self,
        port: int,
        host: str = "127.0.0.1",
        ring_ticks: int | None = None,
        outbox_depth: int = 256,
        n_shards: int | None = None,
        incarnation: int | None = None,
    ):
        self.host = host
        self.port = port
        self._key = _job_key()
        self.ring_ticks = (
            ring_ticks_env() if ring_ticks is None else max(int(ring_ticks), 1)
        )
        self.n_shards = (
            shards_env() if n_shards is None else max(int(n_shards), 1)
        )
        self.incarnation = (
            int(os.environ.get("PATHWAY_MESH_INCARNATION", "0") or 0)
            if incarnation is None
            else int(incarnation)
        )
        self._outbox_depth = max(int(outbox_depth), 8)
        self._lock = threading.Lock()
        # (tick, per_shard) newest-last — per_shard is one list of
        # DiffBatch per shard (length n_shards; the unsharded plane is
        # the 1-shard special case), split ONCE at publish so fan-out
        # and ring replay pay no per-subscriber partitioning.  floor =
        # newest tick whose deltas are UNAVAILABLE (evicted from the
        # ring, or covered only by the snapshot generation a restarted
        # writer restored from — set_floor) — a subscription from below
        # the floor must full-re-hydrate.  A fresh writer's floor stays
        # -1: no ticks existed before its first publish, so the ring IS
        # complete history and a from_tick=-1 subscriber replays it
        # instead of resyncing.
        self._ring: deque[tuple[int, list[list]]] = deque()
        self._floor = -1
        self._newest = -1
        self._ticks_published = 0  # deterministic counter the Fault
        # Forge kill=writer directive fires on (distinct ticks, so a
        # second index node merging into the same lockstep tick does
        # not advance it)
        self._subs: list[_Subscriber] = []
        self._closed = False
        from pathway_tpu_torch.testing import faults

        self._fault_plan = faults.active()
        hb_ms = float(
            os.environ.get("PATHWAY_REPL_HEARTBEAT_MS", "1000") or 1000
        )
        self.heartbeat_s = max(hb_ms, 50.0) / 1000.0
        from pathway_tpu_torch.observability import REGISTRY

        self._m_published = REGISTRY.counter(
            "pathway_repl_ticks_published_total",
            "delta-stream ticks published by the writer (empty markers "
            "included)",
        )
        self._m_delta_rows = REGISTRY.counter(
            "pathway_repl_delta_rows_total",
            "consolidated corpus delta rows streamed to replicas",
        )
        self._m_resyncs = REGISTRY.counter(
            "pathway_repl_resyncs_total",
            "subscriptions answered with a resync (requested tick fell "
            "off the bounded retained-delta ring)",
        )
        self._m_subs = REGISTRY.gauge(
            "pathway_repl_subscribers",
            "replicas currently subscribed to the delta stream",
        )
        self._m_subs.set_function(lambda: len(self._subs))
        self._m_dropped = REGISTRY.counter(
            "pathway_repl_subscribers_dropped_total",
            "replica subscriptions dropped (EOF, send failure, or a "
            "full outbox — the replica reconnects and replays)",
        )

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self.port = self._listener.getsockname()[1]  # resolve port 0
        self._listener.listen(16)
        threading.Thread(
            target=self._accept_loop, daemon=True, name="pw-repl-accept"
        ).start()
        threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="pw-repl-hb"
        ).start()

    # --- writer-side API --------------------------------------------------

    def _split_shards(
        self, batches: list, n_shards: int | None = None
    ) -> list[list]:
        """Partition one tick's batches by corpus-key shard ownership
        (jk-hash, engine/sharded.py shard_of).  1-shard planes skip the
        hash entirely."""
        n = self.n_shards if n_shards is None else n_shards
        if n == 1:
            return [list(batches)]
        per: list[list] = [[] for _ in range(n)]
        for b in batches:
            if not len(b):
                continue
            dest = corpus_shard_of(b.keys, n)
            for s in range(n):
                m = dest == s
                if m.any():
                    per[s].append(b.mask(m))
        return per

    def reshard(self, n_new: int) -> dict:
        """Shard Flux: republish under a new shard map, live.

        Phase 1 (freeze) happens under the publisher lock: the retained
        ring's per-tick splits are re-partitioned by the NEW jk-hash
        map (so a new member's ring replay serves exactly its new key
        range), the shard count flips, and the incarnation bumps —
        one atomic commit from the stream's point of view.  Phase 2:
        every live subscriber is dropped; on redial the suback carries
        the new ``n_shards`` + incarnation, so the established torn-map
        guard becomes the TRANSITION guard — members still holding the
        old map fence themselves (``config_error``, serving stale,
        never mis-partitioned) until they adopt the new assignment
        (restart with the new env, or
        ``ReplicaServer.adopt_shard_map``), while negative-id
        subscribers (standby/observers, full-corpus) reconnect
        unaffected.  Returns {old, new, incarnation}."""
        with self._lock:
            n_new = max(int(n_new), 1)
            old = self.n_shards
            if n_new == old:
                return {
                    "old": old,
                    "new": n_new,
                    "incarnation": self.incarnation,
                }
            self._ring = deque(
                (
                    tick,
                    self._split_shards(
                        [b for part in per_shard for b in part], n_new
                    ),
                )
                for tick, per_shard in self._ring
            )
            self.n_shards = n_new
            self.incarnation += 1
            subs = list(self._subs)
        for sub in subs:
            self._drop(
                sub,
                f"shard map resharded {old} -> {n_new} (redial under "
                "the new map)",
            )
        import logging

        logging.getLogger("pathway_tpu_torch").info(
            "delta stream: resharded %d -> %d shard(s) under "
            "incarnation %d",
            old,
            n_new,
            self.incarnation,
        )
        _journal_record(
            "writer-reshard",
            f"shard map {old} -> {n_new}",
            tick=self._newest,
            incarnation=self.incarnation,
            persist=True,
            old_shards=old,
            new_shards=n_new,
            subscribers_dropped=len(subs),
        )
        return {"old": old, "new": n_new, "incarnation": self.incarnation}

    @staticmethod
    def _shard_batches(per_shard: list[list], shard: int) -> list:
        """The batches a subscriber owning ``shard`` receives (-1 = the
        full corpus: standby writers and unsharded replicas)."""
        if shard < 0:
            return [b for part in per_shard for b in part]
        if shard >= len(per_shard):
            return []  # mismatched map: suback fencing rejects the
            # subscription; deliver markers only meanwhile
        return list(per_shard[shard])

    def publish(self, tick: int, batches: list) -> None:
        """Append one tick's consolidated deltas (possibly empty) to the
        ring and fan out per shard.  Engine-thread hot path:
        O(subscribers) queue puts, no I/O (sender threads own the
        sockets)."""
        with get_tracer().span("repl.publish", tick=tick):
            self._publish(tick, batches)

    def _publish(self, tick: int, batches: list) -> None:
        per_shard = self._split_shards(batches)
        fresh_tick = False
        with self._lock:
            if self._closed:
                return
            if tick <= self._newest:
                # a second index node publishing the same lockstep tick:
                # merge into the existing ring entry so replay stays
                # one-entry-per-tick
                for i in range(len(self._ring) - 1, -1, -1):
                    if self._ring[i][0] == tick:
                        for s, part in enumerate(per_shard):
                            self._ring[i][1][s].extend(part)
                        break
            else:
                fresh_tick = True
                self._ring.append((tick, per_shard))
                self._newest = tick
                self._ticks_published += 1
                while len(self._ring) > self.ring_ticks:
                    evicted, _b = self._ring.popleft()
                    self._floor = max(self._floor, evicted)
            subs = list(self._subs)
            n_published = self._ticks_published
        self._m_published.inc()
        rows = sum(len(b) for b in batches)
        if rows:
            self._m_delta_rows.inc(rows)
        for sub in subs:
            self._offer(
                sub,
                (
                    "data",
                    0,
                    REPL_CHANNEL,
                    tick,
                    self._shard_batches(per_shard, sub.shard),
                    None,
                ),
            )
        if fresh_tick and self._fault_plan is not None:
            # kill=writer: fires AFTER the tick fanned out, so the
            # replicas' last applied tick is deterministic too
            self._fault_plan.on_writer_tick(n_published)

    def newest_tick(self) -> int:
        return self._newest

    def set_floor(self, tick: int) -> None:
        """A restarted writer restored operator state at ``tick``: every
        delta at or before it exists only inside that snapshot
        generation, so subscriptions from below must full-re-hydrate.
        Called by the persistence glue before replay re-publishes the
        log tail (monotone — the floor never moves back)."""
        with self._lock:
            self._floor = max(self._floor, int(tick))

    def _offer(self, sub: _Subscriber, frame: tuple) -> None:
        """Non-blocking enqueue: a replica that cannot drain its outbox
        is dropped (it will reconnect and ring-replay) — the writer's
        tick cadence is never hostage to a slow replica."""
        if sub.dead:
            return
        try:
            sub.outbox.put_nowait(frame)
        except queue.Full:
            self._drop(sub, "outbox full (replica too slow)")

    def _drop(self, sub: _Subscriber, reason: str) -> None:
        with self._lock:
            if sub.dead:
                return
            sub.dead = True
            if sub in self._subs:
                self._subs.remove(sub)
        self._m_dropped.inc()
        if not self._closed:
            import logging

            logging.getLogger("pathway_tpu_torch").warning(
                "delta stream: dropped replica %d subscription (%s)",
                sub.replica_id,
                reason,
            )
            _journal_record(
                "sub-dropped",
                reason,
                tick=self._newest,
                incarnation=self.incarnation,
                replica_id=sub.replica_id,
                shard=sub.shard,
            )
        try:
            sub.outbox.put_nowait(None)  # sender exit sentinel
        except queue.Full:
            pass
        _shutdown_close(sub.conn)

    # --- wiring -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._handshake, args=(conn,), daemon=True
            ).start()

    def _handshake(self, conn: socket.socket) -> None:
        """Nonce challenge-response (mesh-grade), then the replica's
        subscription frame, then register + backlog replay."""
        try:
            nonce = os.urandom(_NONCE_LEN)
            conn.settimeout(30.0)
            conn.sendall(nonce)
            hello = _read_exact(
                conn,
                len(_REPL_MAGIC) + struct.calcsize(_HELLO_STRUCT) + _MAC_LEN,
            )
            if hello is None or hello[: len(_REPL_MAGIC)] != _REPL_MAGIC:
                conn.close()
                return
            claimed, mac = hello[:-_MAC_LEN], hello[-_MAC_LEN:]
            if not hmac.compare_digest(
                mac, hmac.new(self._key, claimed + nonce, "sha256").digest()
            ):
                try:
                    conn.sendall(_REJECT)
                except OSError:
                    pass
                conn.close()
                return
            replica_id, from_tick, shard, _want_shards = struct.unpack(
                _HELLO_STRUCT, claimed[len(_REPL_MAGIC) :]
            )
            conn.sendall(
                hmac.new(
                    self._key, _OK_TAG + nonce + claimed, "sha256"
                ).digest()
            )
            conn.settimeout(None)
        except OSError:
            try:
                conn.close()
            except OSError:
                pass
            return
        sub = _Subscriber(conn, replica_id, self._outbox_depth)
        sub.from_tick = from_tick
        sub.shard = int(shard)
        with self._lock:
            if self._closed:
                conn.close()
                return
            resync = from_tick < self._floor
            # the boundary tick (== from_tick) replays too: a second
            # index node publishing the same lockstep tick merges into
            # the existing ring entry, and per-tick consolidated deltas
            # are idempotent state ops (last-op-per-key), so re-applying
            # the boundary is safe and never loses the merged tail.
            # A resync subscription gets the FULL ring: a replica that
            # re-hydrates redials anyway (bounded waste), and one that
            # CANNOT hydrate (no store — e.g. behind a takeover writer
            # that republished its corpus as its first tick) accepts
            # the gap and converges on everything the ring still holds
            backlog = (
                list(self._ring)
                if resync
                else [e for e in self._ring if e[0] >= from_tick]
            )
            # registered (and backlog captured) under the lock: a publish
            # racing this subscription lands in the outbox, which the
            # sender drains only AFTER the backlog, so the replica sees
            # ticks in order
            self._subs.append(sub)
            # suback carries the writer's shard count (the client
            # fences a torn shard-assignment map) and incarnation (the
            # zombie-primary fencing token)
            sub.backlog.append(
                (
                    "suback",
                    self._newest,
                    self._floor,
                    bool(resync),
                    self.n_shards,
                    self.incarnation,
                )
            )
            if resync:
                self._m_resyncs.inc()
            for tick, per_shard in backlog:
                sub.backlog.append(
                    (
                        "data",
                        0,
                        REPL_CHANNEL,
                        tick,
                        self._shard_batches(per_shard, sub.shard),
                        None,
                    )
                )
        sub.thread = threading.Thread(
            target=self._sender_loop,
            args=(sub,),
            daemon=True,
            name=f"pw-repl-send-{replica_id}",
        )
        sub.thread.start()
        # reader side only watches for EOF (the replica never sends data
        # frames after the subscription) so a vanished replica is
        # unsubscribed promptly instead of on the next full outbox
        threading.Thread(
            target=self._watch_eof, args=(sub,), daemon=True
        ).start()

    def _watch_eof(self, sub: _Subscriber) -> None:
        _read_exact(sub.conn, 1)  # returns on EOF/error
        self._drop(sub, "replica closed the subscription")

    def _sender_loop(self, sub: _Subscriber) -> None:
        from pathway_tpu_torch.testing import faults

        plan = faults.active()
        seq = 0
        # the writer→standby leg carries its own channel tag so Fault
        # Forge can target takeover determinism without touching the
        # replica fan-out (drop/dup/delay=ch:repl:standby)
        standby = sub.replica_id < 0
        backlog = sub.backlog
        sub.backlog = []
        while True:
            if backlog:
                frame = backlog.pop(0)
            else:
                frame = sub.outbox.get()
            if frame is None or sub.dead:
                return
            try:
                repeats = 1
                if frame[0] == "data" and standby:
                    frame = (
                        frame[0],
                        frame[1],
                        STANDBY_CHANNEL
                        if sub.replica_id == STANDBY_ID
                        else OBSERVER_CHANNEL,
                        *frame[3:],
                    )
                if plan is not None and frame[0] == "data":
                    action = plan.on_wire_send(str(frame[2]))
                    if action is not None:
                        if action[0] == "drop":
                            continue
                        if action[0] == "dup":
                            repeats = 2
                        elif action[0] == "delay":
                            time.sleep(action[1])
                body, _stats = wire.encode_frame(frame, "codec", None)
                for _ in range(repeats):
                    mac = _frame_mac(self._key, 0, sub.replica_id, seq, body)
                    seq += 1
                    sub.conn.sendall(
                        struct.pack("<I", len(body)) + mac + body
                    )
            except Exception as e:  # OSError or encode bug: fail-stop
                self._drop(sub, f"send failed: {e}")
                return

    def _heartbeat_loop(self) -> None:
        while not self._closed:
            time.sleep(self.heartbeat_s)
            if self._closed:
                return
            with self._lock:
                subs = list(self._subs)
                newest = self._newest
            for sub in subs:
                self._offer(sub, ("hb", newest))

    def close(self) -> None:
        with self._lock:
            self._closed = True
            subs = list(self._subs)
            self._subs.clear()
        try:
            self._listener.close()
        except OSError:
            pass
        for sub in subs:
            sub.dead = True
            try:
                sub.outbox.put_nowait(None)
            except queue.Full:
                pass
            _shutdown_close(sub.conn)


# --- process-global writer publisher ---------------------------------------
# Armed by PATHWAY_REPL_PORT on the writer process: ExternalIndexExec
# publishes its per-tick corpus deltas here (engine/index_node.py), and
# replicas subscribe at <host>:<port>.  None everywhere else — the hook
# costs one cached is-None check per tick.

_publisher: DeltaStreamServer | None = None
_publisher_resolved = False
_publisher_lock = threading.Lock()


def publisher() -> DeltaStreamServer | None:
    """The writer's process-global delta-stream server (lazily bound
    from PATHWAY_REPL_PORT; PATHWAY_REPL_HOST overrides the bind host),
    or None when this process is not a replication writer."""
    global _publisher, _publisher_resolved
    if _publisher_resolved:
        return _publisher
    with _publisher_lock:
        if not _publisher_resolved:
            raw = os.environ.get("PATHWAY_REPL_PORT", "")
            if raw:
                try:
                    port = int(raw)
                except ValueError:
                    raise ReplicationError(
                        f"PATHWAY_REPL_PORT={raw!r} is not an int"
                    ) from None
                _publisher = DeltaStreamServer(
                    port,
                    host=os.environ.get(
                        "PATHWAY_REPL_HOST", "127.0.0.1"
                    ),
                )
            _publisher_resolved = True
    return _publisher


def reset_publisher() -> None:
    """Test hook: close and forget the process-global publisher."""
    global _publisher, _publisher_resolved
    with _publisher_lock:
        if _publisher is not None:
            _publisher.close()
        _publisher = None
        _publisher_resolved = False


class DeltaStreamClient:
    """Replica-side subscriber: dial, subscribe from a tick, replay the
    ring tail, apply live frames; reconnect (from the last applied tick)
    on writer death; full-re-hydrate on resync.

    Callbacks (all invoked on the client's reader thread):

    * ``on_deltas(tick, batches)`` — apply one tick's consolidated
      deltas (batches may be empty: a freshness marker).
    * ``on_resync() -> int`` — the requested tick fell off the writer's
      ring: re-hydrate from the newest snapshot generation and return
      the new subscription tick.
    * ``on_applied(tick, n_applied)`` — after each applied tick (the
      Fault Forge's replica-kill hook rides here).
    """

    def __init__(
        self,
        host: str,
        port: int,
        replica_id: int,
        from_tick: int,
        on_deltas: Callable[[int, list], None],
        on_resync: Callable[[], int] | None = None,
        on_applied: Callable[[int, int], None] | None = None,
        connect_timeout: float = 60.0,
        *,
        shard: int = -1,
        expect_shards: int = 0,
        endpoints: list[tuple[str, int]] | None = None,
    ):
        self.host = host
        self.port = port
        # endpoints: (host, port) list tried in order — the primary
        # writer first, the standby's takeover endpoint next.  The
        # single-endpoint form (host/port args) is the common same-port
        # takeover deployment.
        self.endpoints = (
            [(host, int(port))] if not endpoints else list(endpoints)
        )
        self._ep_idx = 0
        self.replica_id = int(replica_id)
        self.from_tick = int(from_tick)
        # shard ownership (Shard Harbor): subscribe to one shard's
        # stream (-1 = the full corpus); expect_shards (when > 0) fences
        # a writer whose shard count disagrees — a torn assignment map
        # must never half-apply
        self.shard = int(shard)
        self.expect_shards = int(expect_shards)
        self.on_deltas = on_deltas
        self.on_resync = on_resync
        self.on_applied = on_applied
        self.connect_timeout = connect_timeout
        self._key = _job_key()
        self._closed = False
        self._conn: socket.socket | None = None
        self.applied_tick = int(from_tick)
        self.applied_count = 0  # ticks applied since process start (the
        # deterministic counter kill=replica:N,tick:T fires on)
        self.newest_known = -1
        self.resyncs = 0
        self.connected = False
        # incarnation fencing: the highest writer incarnation ever seen
        # on this stream — any writer presenting a LOWER one is a
        # zombie primary (the standby already took over) and its
        # subscription is rejected before a single frame applies
        self.writer_incarnation = -1
        self.fenced_count = 0
        self.config_error: str | None = None  # sticky shard-map
        # mismatch diagnosis (kept across redials for health reporting)
        # caught_up: applied_tick has reached the stream head at least
        # once since the current subscription — the freshness bound a
        # replica must clear before the router re-admits it
        self.caught_up = False
        self._fresh_at: float | None = None
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    # --- freshness --------------------------------------------------------

    def staleness_seconds(self) -> float | None:
        """Seconds since this replica last confirmed it was caught up
        with the writer's newest published tick (None until the first
        catch-up).  A connected, caught-up replica reads 0.0 — the
        clock only runs while the replica is behind the stream head or
        cut off from the writer.  Mirrors serving/degrade.py's
        staleness clock."""
        with self._lock:
            if (
                self.connected
                and self.caught_up
                and self.newest_known <= self.applied_tick
            ):
                return 0.0
            if self._fresh_at is None:
                return None
            return max(0.0, time.monotonic() - self._fresh_at)

    def _note_progress(self) -> None:
        became_fresh = False
        with self._lock:
            if self.newest_known <= self.applied_tick:
                became_fresh = not self.caught_up
                self.caught_up = True
                self._fresh_at = time.monotonic()
        if became_fresh:
            # the takeover/reshard window's END edge in /fleet/events:
            # this subscription reached the stream head
            _journal_record(
                "caught-up",
                f"replica {self.replica_id} reached the stream head",
                tick=self.applied_tick,
                incarnation=max(self.writer_incarnation, 0),
                replica_id=self.replica_id,
            )

    # --- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run,
            daemon=True,
            name=f"pw-repl-client-{self.replica_id}",
        )
        self._thread.start()

    def close(self) -> None:
        self._closed = True
        conn = self._conn
        if conn is not None:
            _shutdown_close(conn)

    def _dial(self) -> socket.socket | None:
        import random as _random

        deadline = time.monotonic() + self.connect_timeout
        attempt = 0
        while not self._closed and time.monotonic() < deadline:
            s: socket.socket | None = None
            ep = self.endpoints[self._ep_idx % len(self.endpoints)]
            try:
                s = socket.create_connection(ep, timeout=5.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(10.0)
                nonce = _read_exact(s, _NONCE_LEN)
                if nonce is None:
                    raise OSError("writer closed during handshake")
                hello = _REPL_MAGIC + struct.pack(
                    _HELLO_STRUCT,
                    self.replica_id,
                    self.from_tick,
                    self.shard,
                    self.expect_shards,
                )
                s.sendall(
                    hello
                    + hmac.new(self._key, hello + nonce, "sha256").digest()
                )
                ok = _read_exact(s, _MAC_LEN)
                if ok is None:
                    raise OSError("writer closed during handshake")
                if ok == _REJECT:
                    s.close()
                    raise ReplicationError(
                        f"replica {self.replica_id}: writer rejected the "
                        "subscription — authentication failed (is "
                        "PATHWAY_DCN_SECRET identical on the writer and "
                        "every replica?)"
                    )
                expected = hmac.new(
                    self._key, _OK_TAG + nonce + hello, "sha256"
                ).digest()
                if not hmac.compare_digest(ok, expected):
                    raise OSError("unexpected handshake response")
                s.settimeout(None)
                return s
            except OSError:
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                # rotate to the next endpoint (standby takeover address)
                # before backing off — a dead primary must not eat the
                # whole connect budget when the standby is already up
                self._ep_idx += 1
                attempt += 1
                backoff = min(2.0, 0.05 * (2 ** min(attempt, 6)))
                time.sleep(backoff * (0.5 + _random.random()))
        return None

    def _probe_incarnation(self, ep: tuple[str, int]) -> int | None:
        """Handshake + read the suback + close: what incarnation does
        this endpoint's writer publish under?  None when unreachable or
        not speaking PWRP2."""
        s: socket.socket | None = None
        try:
            s = socket.create_connection(ep, timeout=2.0)
            s.settimeout(5.0)
            nonce = _read_exact(s, _NONCE_LEN)
            if nonce is None:
                return None
            hello = _REPL_MAGIC + struct.pack(
                _HELLO_STRUCT,
                self.replica_id,
                self.applied_tick,
                self.shard,
                self.expect_shards,
            )
            s.sendall(
                hello + hmac.new(self._key, hello + nonce, "sha256").digest()
            )
            ok = _read_exact(s, _MAC_LEN)
            if ok is None or ok == _REJECT:
                return None
            if not hmac.compare_digest(
                ok,
                hmac.new(self._key, _OK_TAG + nonce + hello, "sha256").digest(),
            ):
                return None
            head = _read_exact(s, 4 + _MAC_LEN)
            if head is None:
                return None
            (length,) = struct.unpack("<I", head[:4])
            body = _read_exact(s, length)
            if body is None:
                return None
            if not hmac.compare_digest(
                head[4:],
                _frame_mac(self._key, 0, self.replica_id, 0, body),
            ):
                return None
            frame = wire.decode_frame(body)
            if frame[0] != "suback":
                return None
            return int(frame[5])
        except Exception:
            return None
        finally:
            if s is not None:
                _shutdown_close(s)

    def _probe_endpoints(self) -> None:
        """Multi-endpoint fencing bootstrap: learn EVERY endpoint's
        incarnation before subscribing and start with the highest — a
        restarted replica (empty in-memory high-water) must not
        re-adopt a zombie primary just because the zombie's endpoint
        dials first."""
        best_idx, best_inc = None, -1
        for i, ep in enumerate(self.endpoints):
            inc = self._probe_incarnation(ep)
            if inc is not None and inc > best_inc:
                best_idx, best_inc = i, inc
        if best_idx is not None:
            with self._lock:
                self.writer_incarnation = max(
                    self.writer_incarnation, best_inc
                )
            self._ep_idx = best_idx

    def _run(self) -> None:
        while not self._closed:
            if len(self.endpoints) > 1 and self.writer_incarnation < 0:
                # fencing bootstrap ONLY: once a high-water is known,
                # suback-time fencing rejects zombies by itself — a
                # probe per routine redial would cost every endpoint a
                # wasted authenticated subscription (suback + ring
                # backlog) each time
                self._probe_endpoints()
            conn = self._dial()
            if conn is None:
                if self._closed:
                    return
                # writer unreachable within the budget: keep trying —
                # the replica serves (increasingly stale) reads
                # meanwhile, and the router's staleness bound decides
                # admission
                continue
            self._conn = conn
            with self._lock:
                self.connected = True
                self.caught_up = False
            try:
                self._read_stream(conn)
            finally:
                with self._lock:
                    self.connected = False
                try:
                    conn.close()
                except OSError:
                    pass
                self._conn = None
                # reconnect from whatever we applied last
                self.from_tick = self.applied_tick
                if not self._closed:
                    # the takeover window's START edge in /fleet/events:
                    # replicas see the writer's death as stream EOF
                    # within milliseconds of the kill
                    _journal_record(
                        "stream-disconnect",
                        f"replica {self.replica_id} lost the delta stream",
                        tick=self.applied_tick,
                        incarnation=max(self.writer_incarnation, 0),
                        replica_id=self.replica_id,
                    )

    def _read_stream(self, conn: socket.socket) -> None:
        recv_seq = 0
        while not self._closed:
            head = _read_exact(conn, 4 + _MAC_LEN)
            if head is None:
                return
            (length,) = struct.unpack("<I", head[:4])
            body = _read_exact(conn, length)
            if body is None:
                return
            if not hmac.compare_digest(
                head[4:],
                _frame_mac(self._key, 0, self.replica_id, recv_seq, body),
            ):
                return  # forged/replayed frame: drop the link, redial
            recv_seq += 1
            try:
                frame = wire.decode_frame(body)
            except Exception:
                return  # corrupt frame: fail-stop this link, redial
            kind = frame[0]
            if kind == "hb":
                with self._lock:
                    self.newest_known = max(self.newest_known, frame[1])
                self._note_progress()
            elif kind == "suback":
                _k, newest, _floor, resync, srv_shards, srv_inc = frame
                if srv_inc < self.writer_incarnation:
                    # zombie primary: a standby with a HIGHER incarnation
                    # already took over this stream — reject the whole
                    # subscription (no frame from this writer may apply)
                    # and rotate to the next endpoint
                    self.fenced_count += 1
                    import logging

                    logging.getLogger("pathway_tpu_torch").warning(
                        "replica %d: fenced zombie writer (incarnation "
                        "%d < %d) at %s",
                        self.replica_id,
                        srv_inc,
                        self.writer_incarnation,
                        self.endpoints[self._ep_idx % len(self.endpoints)],
                    )
                    # persist=True: this record is how a SIGKILLed zombie
                    # is reconstructed from its peers' journals
                    _journal_record(
                        "zombie-fenced",
                        f"writer incarnation {srv_inc} < "
                        f"{self.writer_incarnation}",
                        tick=self.applied_tick,
                        incarnation=self.writer_incarnation,
                        persist=True,
                        replica_id=self.replica_id,
                        zombie_incarnation=srv_inc,
                    )
                    self._ep_idx += 1
                    time.sleep(0.2)  # a persistent zombie must not
                    # hot-loop dial->fence->dial
                    return
                with self._lock:
                    prev_inc = self.writer_incarnation
                    self.writer_incarnation = max(
                        self.writer_incarnation, srv_inc
                    )
                if srv_inc > max(prev_inc, 0):
                    _journal_record(
                        "incarnation-seen",
                        f"writer incarnation {prev_inc} -> {srv_inc}",
                        tick=self.applied_tick,
                        incarnation=srv_inc,
                        replica_id=self.replica_id,
                        previous=prev_inc,
                    )
                torn = (
                    self.expect_shards and srv_shards != self.expect_shards
                ) or (
                    # an UNSHARDED replica (no expectation at all)
                    # against a sharded writer is torn too: it would
                    # receive the FULL corpus while the router treats
                    # it as one shard's owner — merged top-k would
                    # carry duplicates and the 1/S memory win silently
                    # vanishes.  Full-corpus subscriptions to a sharded
                    # writer are reserved for negative ids (standby /
                    # observers), which never sit behind the router.
                    not self.expect_shards
                    and self.shard < 0
                    and self.replica_id >= 0
                    and srv_shards > 1
                ) or (
                    # a shard index the writer does not split to would
                    # receive an empty stream yet report caught-up
                    self.shard >= 0
                    and srv_shards > 0
                    and self.shard >= srv_shards
                )
                if torn:
                    # torn shard assignment: this replica's map and the
                    # writer's split disagree — applying would
                    # mis-partition the corpus silently
                    self.config_error = (
                        f"writer splits the corpus into {srv_shards} "
                        f"shard(s) but this replica expected "
                        f"{self.expect_shards or 1} (torn shard "
                        "assignment map — fix PATHWAY_SERVING_SHARDS/"
                        "PATHWAY_REPLICA_SHARD and restart)"
                    )
                    import logging

                    logging.getLogger("pathway_tpu_torch").error(
                        "replica %d: %s", self.replica_id, self.config_error
                    )
                    _journal_record(
                        "config-error",
                        self.config_error,
                        tick=self.applied_tick,
                        incarnation=max(self.writer_incarnation, 0),
                        replica_id=self.replica_id,
                        writer_shards=srv_shards,
                        expected_shards=self.expect_shards,
                    )
                    time.sleep(0.5)
                    return
                self.config_error = None
                with self._lock:
                    self.newest_known = max(self.newest_known, newest)
                if resync:
                    self.resyncs += 1
                    if self.on_resync is None:
                        # no hydrate path (store-less replica — e.g.
                        # behind a takeover writer that republished its
                        # corpus as its first tick): accept the gap
                        # and converge on the FULL ring the server
                        # replays for resync subscriptions —
                        # consolidated per-tick deltas are idempotent,
                        # and frames older than applied_tick skip below
                        self.from_tick = self.applied_tick
                        continue
                    new_tick = int(self.on_resync())
                    if new_tick > self.from_tick:
                        # re-hydrated to a newer generation: the index
                        # was replaced under us, so advance past it
                        self.from_tick = new_tick
                        self.applied_tick = max(
                            self.applied_tick, new_tick
                        )
                        if new_tick >= _floor:
                            return  # redial: normal ring-tail replay
                            # from the fresh generation
                    # the store has no generation reaching the ring
                    # floor yet (writer restarted without a fresh
                    # snapshot, or the newest generation is torn):
                    # NEVER silently accept a gap a snapshot will
                    # cover — wait for the writer to commit one
                    # instead of hot-looping dial->resync->dial
                    time.sleep(0.5)
                    return
                self._note_progress()
            elif kind == "data":
                _k, _src, _channel, tick, batches, _tp = frame
                if tick < self.applied_tick:
                    continue  # writer-restart overlap: already applied
                # tick == applied_tick is NOT skipped: a second index
                # node publishing the same lockstep tick, and the
                # boundary tick of a reconnect replay, both arrive as
                # equal-tick frames — consolidated per-tick deltas are
                # idempotent state ops, so re-applying is safe and
                # skipping would lose the merged tail
                try:
                    with get_tracer().span(
                        "repl.apply",
                        tick=tick,
                        replica_id=self.replica_id,
                        batches=len(batches),
                    ):
                        self.on_deltas(tick, batches)
                except Exception:
                    # an apply failure must not kill the reader thread
                    # (the replica would zombie: alive, serving ever-
                    # staler reads, never reconnecting).  Fail-stop the
                    # link like a corrupt frame: redial replays from
                    # applied_tick, re-attempting this tick.
                    import logging

                    logging.getLogger("pathway_tpu_torch").exception(
                        "replica %d: applying delta tick %d failed; "
                        "dropping the subscription to retry",
                        self.replica_id,
                        tick,
                    )
                    time.sleep(0.5)  # a deterministic failure must
                    # not hot-loop dial->apply->fail
                    return
                self.applied_tick = tick
                self.applied_count += 1
                with self._lock:
                    self.newest_known = max(self.newest_known, tick)
                self._note_progress()
                if self.on_applied is not None:
                    self.on_applied(tick, self.applied_count)


def consolidate_rows(rows: list[tuple[int, int, tuple]]) -> list:
    """Collapse one tick's raw corpus updates to per-key FINAL ops (the
    "consolidated per-tick deltas" of the tentpole): the last op per key
    wins, upsert-after-remove collapses to the upsert, and emission
    order is the order keys were last touched — so a replica applying
    the result converges to the same corpus as applying the raw stream.

    Returns ``pickle``-free row tuples ready for DiffBatch.from_rows.
    """
    final: dict[int, tuple[int, int, tuple]] = {}
    for row in rows:
        k = row[0]
        final.pop(k, None)  # re-insert to keep last-touch order
        final[k] = row
    return list(final.values())
