"""Own copy of ``pathway_tpu/persistence/_runtime_glue.py``: the same store
layout (``metadata.json``, ``inputs/``, ``offsets/``, ``states/gen-*``,
``segments/``), so a store written by either package restores in the other.
Every blob is pickled through ``_pickle.py``, which names the classes both
packages share by the JAX package's module paths and maps them back on load.

In a process group (the runtime holds a host mesh) the reference's
multi-process branches run as well: operator snapshots only at group-safe
points (the head of a lockstep tick), a commit every tick, the superseded
generations retained until the ``gen-commit`` barrier confirms the group
minimum (``group_commit.json``), and the replay restoring one agreed
generation and replaying the log tail in lockstep. A restarted
replication writer floors its delta publisher at the restored state's time,
as the reference does; ``state_key``/``segment_key`` name the blobs an
out-of-process reader (a read replica's hydration) loads.

Persistence engine glue: input event logs + offsets + resume, a re-design
of upstream Pathway's persistence split
(src/persistence/input_snapshot.rs — Insert/Delete/AdvanceTime
event log per input; src/persistence/state.rs:35 MetadataAccessor — last
finalized time; src/connectors/mod.rs:222 rewind_from_disk_snapshot, then
reader.seek to stored offsets).

In the microbatch engine the tick loop advances one totally-ordered logical
clock, so the reference's multi-worker finalized-time consensus
(state.rs:291) collapses to: a tick is finalized the moment it completes.
A "commit" atomically records (input log chunks, per-source offsets,
metadata) so replay and seek can never disagree — the reference gets the
same property from snapshotting both under one frontier.

Resume = restore operator-state snapshots (reference:
src/persistence/operator_snapshot.rs:21-31 chunked state dumps +
src/engine/dataflow/persist.rs MaybePersist wrappers), then replay only the
log TAIL — events newer than the snapshot — then restore source offsets.
Each successful full-graph snapshot truncates the input log (compaction:
operator_snapshot.rs:342's background merge collapses to "delete covered
chunks" in the single-process setting), so both restart time and log size
stay bounded by the churn since the last snapshot, not by history.
At-least-once, like the reference's OSS mode (README.md:110).

Operator snapshots are INCREMENTAL for arrangement-backed execs (the
differential-dataflow move: arranged collections ARE the checkpoint).
Such an exec exposes (residual, {name: Arrangement}) via
``arranged_state()``; every snapshot writes only segment files whose
content-addressed id has never been stored (``segments/<node>/<part>/
<epoch>-<segid>.seg``, persistence/segments.py) plus a tiny
manifest+residual blob per generation, and GC retires segment files no
retained generation references — so steady-state checkpoint bytes are
proportional to churn since the last snapshot, not to state size.
Recovery rebuilds the arrangements over mmap-backed buffers
(``BackendStore.get_buffer``) instead of unpickling monoliths or
replaying the input log.  ``PATHWAY_PERSIST_MONOLITH=1`` forces the old
whole-state pickling (differential testing / escape hatch).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

from pathway_tpu_torch.engine.batch import END_OF_TIME, DiffBatch
from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import Runtime, StaticSource
from pathway_tpu_torch.persistence import _pickle
from pathway_tpu_torch.persistence.backends import BackendStore, store_for_backend
from pathway_tpu_torch.persistence.segments import (
    load_arrangement,
    manifest_of,
    segment_to_bytes,
)

_META_KEY = "metadata.json"
_GROUP_COMMIT_KEY = "group_commit.json"  # durable audit record of the
# last gen-commit barrier agreement (phase 2 of the generation commit)
_log = logging.getLogger("pathway_tpu_torch")

_M: dict | None = None


def _metrics() -> dict:
    """Persistence metrics, created once per process (label-free handles
    cached here, off the snapshot path — PR-6 convention)."""
    global _M
    if _M is None:
        from pathway_tpu_torch.observability import REGISTRY

        _M = {
            "snap_bytes": REGISTRY.histogram(
                "pathway_persistence_snapshot_bytes",
                "bytes written per operator-state snapshot (incremental "
                "snapshots write only new segments + manifests)",
            ),
            "snap_seconds": REGISTRY.histogram(
                "pathway_persistence_snapshot_seconds",
                "wall seconds per operator-state snapshot",
            ),
            "segs_written": REGISTRY.counter(
                "pathway_persistence_segments_written_total",
                "arrangement segment files written to the persistence "
                "store",
            ),
            "segs_retired": REGISTRY.counter(
                "pathway_persistence_segments_retired_total",
                "dead arrangement segment files deleted by snapshot GC",
            ),
            "recovery_seconds": REGISTRY.gauge(
                "pathway_persistence_recovery_seconds",
                "wall seconds of the last recovery (operator-state "
                "restore + log-tail replay)",
            ),
        }
    return _M


def resume_point(store: Any) -> dict:
    """Where a takeover writer resumes from this store (Shard Harbor
    standby handoff): ``state_time`` = the newest committed operator
    -state generation's time (what :meth:`PersistenceDriver.replay`
    restores and floors the delta ring at), ``group_commit_time`` = the
    last durable phase-2 gen-commit barrier agreement (Phoenix Mesh
    audit record), ``last_time`` = the durable input-log frontier the
    connector-log replay walks to.  All -1 when absent — a fresh store
    means the takeover rebuilds from the log alone."""
    out = {"state_time": -1, "group_commit_time": -1, "last_time": -1}
    raw = store.get(_META_KEY)
    if raw is not None:
        meta = json.loads(raw.decode())
        out["last_time"] = int(meta.get("last_time", -1))
        if meta.get("state"):
            out["state_time"] = int(meta["state"].get("time", -1))
    marker = store.get(_GROUP_COMMIT_KEY)
    if marker is not None:
        out["group_commit_time"] = int(
            json.loads(marker.decode()).get("time", -1)
        )
    return out


def state_key(gen: int, ident) -> str:
    """Store key of one node's per-generation state blob — the layout
    contract shared with every out-of-process reader of a writer's
    store (replica hydration)."""
    return PersistenceDriver._state_key(gen, ident)


def segment_key(ident, name: str, epoch: str, seg_id: int) -> str:
    """Store key of one content-addressed arrangement segment file —
    same cross-module contract as :func:`state_key`."""
    return PersistenceDriver._segment_key(ident, name, epoch, seg_id)


def effective_persistent_id(node: InputNode, ordinal: int) -> str:
    """Stable id for an input across restarts (reference:
    src/engine/dataflow/persist.rs:37 effective_persistent_id): explicit
    `persistent_id` on the source wins; otherwise position in the graph."""
    pid = getattr(node.source, "persistent_id", None)
    if pid:
        return str(pid)
    return f"input-{ordinal}"


class _EmptyStatic(StaticSource):
    def events(self):
        return iter(())


class PersistenceDriver:
    """Wraps a Runtime: records every injected input batch, commits offsets
    on an interval, replays the log on startup."""

    def __init__(self, runtime: Runtime, config: Any):
        self.runtime = runtime
        self.store: BackendStore = store_for_backend(config.backend)
        # Fault Forge: slow-store injection wraps every put/get; the
        # torn-snapshot hook fires in commit() right before metadata
        from pathway_tpu_torch.testing import faults

        self._fault_plan = faults.active()
        if self._fault_plan is not None:
            self.store = self._fault_plan.wrap_store(self.store)
        self.snapshot_interval_ms = max(
            int(getattr(config, "snapshot_interval_ms", 0) or 0), 0
        )
        mode = getattr(config, "snapshot_access", None)
        if mode not in (None, "record", "replay", "full"):
            raise ValueError(
                f"invalid snapshot_access {mode!r}: expected 'record', "
                "'replay' or 'full' (reference: PATHWAY_SNAPSHOT_ACCESS)"
            )
        # SELECTIVE_PERSISTING: only explicitly-named operators persist;
        # inputs are neither logged nor offset-tracked
        pmode = getattr(config, "persistence_mode", None)
        pmode = getattr(pmode, "value", pmode)  # enum member or raw string
        self.selective = pmode == "selective_persisting"
        self.record = mode in (None, "record", "full") and not self.selective
        self.replay_allowed = mode in (None, "replay", "full")
        # explicit snapshot_access = record/replay DEBUGGING (reference:
        # PATHWAY_REPLAY_STORAGE + `pathway spawn --record`): the input log
        # is the artifact, so it is never compacted away by operator
        # snapshots and replay reproduces the run in full
        self.debug_mode = mode in ("record", "replay", "full")
        self.inputs: dict[str, InputNode] = {}
        ordinal = 0
        for node in runtime.order:
            if isinstance(node, InputNode):
                if getattr(node.source, "transient", False):
                    # debug/markdown fixtures are not persistable connectors
                    # (reference: only sources with persistent ids log and
                    # seek); they re-read fresh on every run and rely on
                    # operator snapshots (e.g. deduplicate state) to merge
                    ordinal += 1
                    continue
                self.inputs[effective_persistent_id(node, ordinal)] = node
                ordinal += 1
        self._node_to_pid = {n.id: pid for pid, n in self.inputs.items()}
        self._pending: dict[str, list[tuple[int, list]]] = {
            pid: [] for pid in self.inputs
        }
        self._chunk_counts: dict[str, int] = {}
        self._live_chunks: dict[str, list[int]] = {}
        # per-input offsets snapshot taken when that input's rows were
        # last appended to the log (see on_tick) — the only offsets
        # commit() is allowed to persist; _offsets_persisted remembers
        # the object identity last written so unchanged offsets skip
        # the store round trip on idle per-tick commits
        self._offsets_at_log: dict[str, Any] = {}
        self._offsets_persisted: dict[str, Any] = {}
        self._last_commit_wall = 0.0
        self._committed_time = 0
        self._last_real_time = 0
        self._orig_tick = runtime.tick
        # operator snapshots: on by default; every snapshot_every-th commit
        # dumps all exec states and truncates the covered log. Disabled in
        # record/replay debugging where the log must survive verbatim.
        self.snapshot_operators = (
            bool(getattr(config, "snapshot_operators", True))
            and not self.debug_mode
        )
        self.snapshot_every = max(
            int(getattr(config, "snapshot_every", 8) or 8), 1
        )
        self._commits_since_snapshot = 0
        # multi-process: GC deferred past the gen-commit barrier (phase
        # 2 of the two-phase generation commit) — files are only retired
        # once the whole group has confirmed a generation every rank can
        # restore
        self._pending_gc: tuple[dict, dict] | None = None
        self._group_commit_time: int | None = None
        # mixed dependency: a node fed by BOTH a transient source and a
        # logged one is excluded from snapshots (its transient rows re-feed)
        # yet needs the logged rows to rebuild — truncating the log would
        # lose them, so operator snapshots are disabled for such graphs
        # (log-only persistence, the pre-compaction behavior)
        if self.snapshot_operators and not self.selective:
            tainted: set[int] = set()
            logged: set[int] = set()
            logged_input_ids = {n.id for n in self.inputs.values()}
            for node in runtime.order:
                if isinstance(node, InputNode):
                    if getattr(node.source, "transient", False):
                        tainted.add(node.id)
                    elif node.id in logged_input_ids:
                        logged.add(node.id)
                    continue
                if any(inp.id in tainted for inp in node.inputs):
                    tainted.add(node.id)
                if any(inp.id in logged for inp in node.inputs):
                    logged.add(node.id)
            if tainted & logged:
                _log.info(
                    "operator snapshots disabled: graph mixes transient "
                    "fixtures with persisted connectors; falling back to "
                    "input-log persistence"
                )
                self.snapshot_operators = False
        self.replayed_events = 0  # observability: bounded-replay assertions
        self.restored_from_snapshot = False
        # recovery anatomy (set by replay): operator restore, log-tail
        # replay (ticks, rows) and offset seek; (seconds, bytes) per
        # operator snapshot taken here
        self.restore_seconds = self.replay_seconds = self.seek_seconds = 0.0
        self.recovery_seconds = 0.0
        self.replayed_ticks = self.replayed_rows = 0
        self.snapshots: list[tuple[float, int]] = []
        # multi-process: lockstep tick counter driving group-safe snapshot
        # points (identical on every process — ticks are barrier-agreed)
        self._ticks_seen = 0
        # incremental segment snapshots: segment keys this run may skip
        # rewriting. Primed from the keys the DURABLE metadata references
        # — NOT from a store listing: a crash between segment writes and
        # the metadata commit leaves orphan files whose ids a restored
        # arrangement (whose seg-id counter rolled back with the durable
        # manifest) will mint again with different content; those must be
        # overwritten, not skipped.
        self.monolith = os.environ.get(
            "PATHWAY_PERSIST_MONOLITH", ""
        ) not in ("", "0")
        self._segments_present: set[str] = set()
        _boot_meta = self._load_meta()
        _boot_gens = [_boot_meta.get("state"), _boot_meta.get("prev_state")]
        _boot_gens += [
            r.get("state") for r in _boot_meta.get("retained_states", [])
        ]
        for gen_desc in _boot_gens:
            if gen_desc:
                self._segments_present.update(
                    gen_desc.get("segment_keys", ())
                )
        self._m = _metrics()
        # execs that keep a persistence ledger (a side arrangement of
        # per-group state blobs, e.g. GroupByExec) only pay for it when
        # snapshots will actually happen — enable before any tick runs
        if not self.monolith and (self.snapshot_operators or self.selective):
            for _ident, _cls, ex, _refeed in self._node_ordinals():
                hook = getattr(ex, "enable_state_ledger", None)
                if hook is not None:
                    hook()
        # set when the latest snapshot attempt aborted on an unpicklable
        # exec ("<class>#<ordinal>"); also mirrored into metadata
        self.degraded_snapshot: str | None = None

    # --- commit path ----------------------------------------------------------

    def _load_meta(self) -> dict:
        raw = self.store.get(_META_KEY)
        if raw is None:
            return {"last_time": 0, "chunks": {}}
        return json.loads(raw.decode())

    def _node_ordinals(self) -> list[tuple[Any, str, Any, bool]]:
        """(ordinal, class name, exec, inputs_refeed) for every
        snapshot-eligible node, ordinal = topo position — the stable
        cross-restart identity (same role as effective_persistent_id for
        inputs).  ``inputs_refeed`` marks nodes whose input rows arrive
        again on every run (transient fixtures / selective mode): only
        those may re-emit restored accumulator state, because their
        downstream consumers are NOT restored and must rebuild.

        Nodes fed (transitively) by a transient source re-process that
        source's rows on every run, so restoring their state would double
        -count; they are excluded — EXCEPT standalone accumulators
        (deduplicate), which the reference persists under their own
        persistent id precisely because their inputs re-feed
        (non-retractable stateful_reduce, operators/stateful_reduce.rs).

        SELECTIVE_PERSISTING keeps ONLY operators with an explicit
        `persistent_name`, keyed by that name (graph position is free to
        change between runs)."""
        if self.selective:
            out = []
            for node in self.runtime.order:
                name = getattr(node, "persistent_name", None)
                if name:
                    out.append(
                        (
                            f"name:{name}",
                            type(node).__name__,
                            self.runtime.execs[node.id],
                            True,  # selective mode never logs inputs
                        )
                    )
            return out
        tainted: set[int] = set()
        for node in self.runtime.order:
            if isinstance(node, InputNode) and getattr(
                node.source, "transient", False
            ):
                tainted.add(node.id)
            elif any(inp.id in tainted for inp in node.inputs):
                tainted.add(node.id)
        out = []
        for i, node in enumerate(self.runtime.order):
            ex = self.runtime.execs[node.id]
            if node.id in tainted and not getattr(
                ex, "persist_standalone", False
            ):
                continue
            out.append((i, type(node).__name__, ex, node.id in tainted))
        return out

    def on_tick(self, t: int, injected: dict[int, list[DiffBatch]] | None = None):
        hm = getattr(self.runtime, "host_mesh", None)
        if (
            hm is not None
            and self.record
            and self.snapshot_operators
            and t < END_OF_TIME
        ):
            # group-safe snapshot point: we are at the HEAD of a lockstep
            # tick, so the barrier that scheduled it has confirmed every
            # peer completed (and, with per-tick commits below, durably
            # logged) the previous tick. State captured here can never run
            # ahead of any peer's durable input log — the reference's
            # "all workers flushed up to T" consensus
            # (src/persistence/state.rs:291) realized on the tick barrier.
            if (
                self._ticks_seen > 0
                and self._ticks_seen % self.snapshot_every == 0
            ):
                self.commit(snapshot=True)
                self._group_commit(hm)
            self._ticks_seen += 1
        self._orig_tick(t, injected)
        if not self.record:
            # selective mode snapshots named operators on shutdown AND on
            # the regular commit interval — a killed process must not lose
            # the one thing this mode promises to persist
            if self.selective:
                if t >= END_OF_TIME:
                    self.commit(final=True)
                    return
                now = time.monotonic()
                if (
                    now - self._last_commit_wall
                ) * 1000.0 >= self.snapshot_interval_ms:
                    self._last_commit_wall = now
                    self._last_real_time = max(self._last_real_time, t)
                    meta = self._load_meta()
                    snap = self._snapshot_operators(meta)
                    if snap:
                        meta["state"] = snap
                        meta["last_time"] = max(
                            meta.get("last_time", 0), t
                        )
                        self.store.put(_META_KEY, json.dumps(meta).encode())
                        self._gc(meta, snap)
            return
        if injected:
            for nid, batches in injected.items():
                pid = self._node_to_pid.get(nid)
                if pid is None:
                    continue
                rows = [r for b in batches for r in b.iter_rows()]
                if rows:
                    self._pending[pid].append((t, rows))
        # capture offsets AT LOG TIME: commit() persists this pairing,
        # never the session's live last_offsets. The live value already
        # covers rows drained for the NEXT tick (the lockstep loop
        # drains before calling tick), so a commit running at the head
        # of a tick — the group-safe snapshot point — would otherwise
        # persist offsets ahead of the durable log and a mid-tick death
        # would LOSE those rows on resume.
        for pid, node in self.inputs.items():
            session = getattr(node.source, "session", None)
            if session is not None and getattr(
                session, "last_offsets", None
            ) is not None:
                self._offsets_at_log[pid] = session.last_offsets
        if t >= END_OF_TIME:
            self.commit(final=True)
            if hm is not None:
                self._group_commit(hm)
            return
        self._last_real_time = max(self._last_real_time, t)
        now = time.monotonic()
        if hm is not None:
            # multi-process: the input log must be durable before the next
            # barrier round lets any peer snapshot state derived from this
            # tick's exchanged rows — commit every tick
            self._last_commit_wall = now
            self.commit()
        elif (now - self._last_commit_wall) * 1000.0 >= self.snapshot_interval_ms:
            self._last_commit_wall = now
            self.commit()

    def commit(self, final: bool = False, snapshot: bool = False) -> None:
        """Atomically advance the durable frontier: flush pending log chunks,
        snapshot source offsets (and, periodically, every operator's state),
        then write metadata last (metadata names exactly the chunks +
        offsets + state generation forming the consistent cut). A crash
        mid-commit leaves the previous metadata — and so the previous
        consistent cut — untouched."""
        meta = self._load_meta()
        if not self._live_chunks:
            self._live_chunks = {
                pid: list(v) for pid, v in meta.get("live_chunks", {}).items()
            }
        wrote = False
        for pid, pending in self._pending.items():
            if not pending:
                continue
            idx = self._chunk_counts.get(pid, meta["chunks"].get(pid, 0))
            self.store.put(
                f"inputs/{pid}/chunk-{idx:08d}.pkl", _pickle.dumps(pending)
            )
            self._chunk_counts[pid] = idx + 1
            self._live_chunks.setdefault(pid, []).append(idx)
            self._pending[pid] = []
            wrote = True
        offsets_changed = False
        # selective mode: inputs are neither logged nor offset-tracked —
        # writing __static_done__ here would suppress sources on restart
        # with no log to reproduce them
        #
        # Offsets are STAGED under sequence-numbered keys and only become
        # current when the metadata naming them commits below — a crash
        # between the offsets write and the metadata write must leave the
        # previous consistent cut intact. (The old in-place
        # ``offsets/{pid}.pkl`` overwrite could run ahead of the named
        # log chunks and silently LOSE the torn commit's rows on resume;
        # Fault Forge's torn-snapshot smoke pinned this down.)
        offsets_named = dict(meta.get("offsets", {}))
        oseq = int(meta.get("offsets_seq", 0))
        retired_offsets: list[str] = []
        for pid, node in () if self.selective else self.inputs.items():
            state = None
            src = node.source
            session = getattr(src, "session", None)
            if session is not None:
                # only offsets captured when their covered rows were
                # appended to the log (on_tick) — the session's LIVE
                # last_offsets can already cover the next tick's drained
                # -but-unlogged rows when this commit runs at the head
                # of a tick (group-safe snapshot point)
                state = self._offsets_at_log.get(pid)
                # last_offsets is REASSIGNED per drain, so identity
                # detects change: idle ticks (a group commits every tick)
                # skip the rewrite entirely
                if state is self._offsets_persisted.get(pid):
                    state = None
            elif isinstance(src, StaticSource):
                state = {"__static_done__": True} if final else None
            if state is not None:
                oseq += 1
                key = f"offsets/{pid}-{oseq:08d}.pkl"
                self.store.put(key, _pickle.dumps(state))
                # the exact key this one supersedes (or the legacy
                # in-place key on first post-upgrade commit) retires
                # after the metadata naming the replacement is durable
                retired_offsets.append(
                    offsets_named.get(pid, f"offsets/{pid}.pkl")
                )
                offsets_named[pid] = key
                self._offsets_persisted[pid] = state
                offsets_changed = True
        snap = None
        self._commits_since_snapshot += 1
        dcn = getattr(self.runtime, "host_mesh", None) is not None
        if self.snapshot_operators and (
            final  # clean shutdown always snapshots: restarts restore
            # accumulator state (deduplicate) even for short runs
            or snapshot  # explicit group-safe snapshot point (on_tick)
            or (
                not dcn  # multi-process snapshots ONLY at group-safe points
                and wrote
                and self._commits_since_snapshot >= self.snapshot_every
            )
        ):
            snap = self._snapshot_operators(meta)
        if wrote or offsets_changed or final or snap:
            meta["chunks"].update(self._chunk_counts)
            meta["live_chunks"] = self._live_chunks
            meta["last_time"] = max(meta.get("last_time", 0), self._last_real_time)
            if offsets_changed:
                meta["offsets"] = offsets_named
                meta["offsets_seq"] = oseq
            if snap:
                if dcn:
                    # multi-process: RETAIN every superseded generation
                    # (state + the chunks between snapshots) until the
                    # gen-commit barrier confirms the whole group holds
                    # something newer — GC then trims the list back to
                    # one. Snapshot points are lockstep-aligned, so the
                    # steady-state list length is one (the old prev_state
                    # behavior); a degraded rank (unpicklable state)
                    # grows it, and every healthy rank keeps enough
                    # history for the group-min restore (reference:
                    # consistent frontier across workers,
                    # src/persistence/state.rs:291)
                    if meta.get("state"):
                        retained = list(meta.get("retained_states", ()))
                        retained.append(
                            {
                                "state": meta["state"],
                                "chunks": {
                                    pid: list(v)
                                    for pid, v in self._live_chunks.items()
                                },
                            }
                        )
                        meta["retained_states"] = retained
                        # legacy mirrors (older readers + replay fallback)
                        meta["prev_state"] = meta["state"]
                        meta["prev_chunks"] = retained[-1]["chunks"]
                meta["state"] = snap
                meta["live_chunks"] = self._live_chunks = {
                    pid: [] for pid in self._live_chunks
                }
            if final:
                meta["finished"] = True
            if self._fault_plan is not None:
                # torn-snapshot injection point: segments + state blobs
                # are durable, the metadata naming them is not
                self._fault_plan.before_meta_commit(snap is not None)
            self.store.put(_META_KEY, json.dumps(meta).encode())
            self._committed_time = meta["last_time"]
            if offsets_changed:
                # superseded offsets snapshots retire only AFTER the
                # metadata naming their replacements is durable;
                # targeted removes, not a per-commit prefix listing
                for key in retired_offsets:
                    self.store.remove(key)
            if snap:
                self._commits_since_snapshot = 0
                if dcn and self.record:
                    # phase 2 (the gen-commit barrier in on_tick) decides
                    # whether this generation's GC may run. Selective
                    # mode never joins that barrier (its interval
                    # snapshots are wall-clock-driven, not lockstep-
                    # aligned), so it keeps the immediate GC below.
                    self._pending_gc = (meta, snap)
                else:
                    self._gc(meta, snap)

    def _group_commit(self, hm) -> None:
        """Two-phase generation commit (Phoenix Mesh). Phase 1 is the
        local durable snapshot commit (commit(snapshot=True) — atomic on
        metadata). Phase 2 is this barrier: every rank exchanges the
        time of its newest durable generation; the group minimum —
        the newest state the WHOLE group can restore — gates the
        deferred GC (only once it has caught up to a rank's own
        generation does that rank retire superseded files, so no rank
        ever deletes what a lagging/degraded peer's group-min restore
        still needs) and is recorded under ``group_commit.json`` as the
        durable audit record of the agreement (restore re-derives the
        agreement with a live barrier over what is actually restorable;
        the retained-generation list guarantees that minimum exists on
        every rank even when a rank dies between the two phases)."""
        pending, self._pending_gc = self._pending_gc, None
        meta = pending[0] if pending is not None else self._load_meta()
        local = (
            int(meta["state"].get("time", 0)) if meta.get("state") else -1
        )
        vals = hm.barrier(("gen-commit", local))
        group = min(v[1] for v in vals.values())
        if group >= 0 and group != self._group_commit_time:
            self._group_commit_time = group
            self.store.put(
                _GROUP_COMMIT_KEY, json.dumps({"time": group}).encode()
            )
        if pending is not None:
            _meta, snap = pending
            if int(snap.get("time", -1)) <= group:
                self._gc(_meta, snap)

    @staticmethod
    def _state_key(gen: int, ident) -> str:
        if str(ident).isdigit():
            return f"states/gen-{gen:06d}/{int(ident):05d}.pkl"
        import urllib.parse

        return (
            f"states/gen-{gen:06d}/"
            f"{urllib.parse.quote(str(ident), safe='')}.pkl"
        )

    @staticmethod
    def _segment_key(ident, name: str, epoch: str, seg_id: int) -> str:
        import urllib.parse

        q = urllib.parse.quote(str(ident), safe="")
        return f"segments/{q}/{name}/{epoch}-{int(seg_id):012d}.seg"

    def _snapshot_operators(self, meta: dict) -> dict | None:
        """Dump every eligible exec's state under a fresh generation.
        Arrangement-backed execs snapshot INCREMENTALLY: their sealed
        segments are content-addressed by (node, part, epoch, seg id), so
        only ids never stored before are written — plus a small
        manifest+residual blob per generation.  Everything else pickles
        monolithically as before.  Returns the state descriptor, or None
        if ANY node failed to serialize — a partial snapshot must not
        truncate the log (correctness over compaction)."""
        t0 = time.monotonic()
        gen = int(meta.get("state", {}).get("gen", 0)) + 1
        nodes: dict[str, str] = {}
        written: list[str] = []  # this generation's state blobs
        new_segments: list[str] = []  # segment files first written now
        segment_keys: set[str] = set()  # every segment this gen references
        bytes_written = 0
        for ident, cls, ex, _refeed in self._node_ordinals():
            try:
                arranged = None if self.monolith else ex.arranged_state()
                seg_blobs: list[tuple[str, bytes]] = []
                if arranged is not None:
                    residual, arrs = arranged
                    manifests: dict[str, dict] = {}
                    for name, arr in arrs.items():
                        man = manifest_of(arr)
                        manifests[name] = man
                        by_id = {s.seg_id: s for s in arr.segments}
                        for sd in man["segments"]:
                            skey = self._segment_key(
                                ident, name, man["epoch"], sd["id"]
                            )
                            segment_keys.add(skey)
                            if skey not in self._segments_present:
                                seg_blobs.append(
                                    (skey, segment_to_bytes(by_id[sd["id"]]))
                                )
                    blob = _pickle.dumps(
                        {
                            "__pw_arranged__": 1,
                            "residual": residual,
                            "manifests": manifests,
                        }
                    )
                else:
                    state = ex.state_dict()
                    if state is None:
                        continue
                    blob = _pickle.dumps(state)
            except Exception:
                _log.warning(
                    "operator snapshot skipped: node %s (%s) has "
                    "unpicklable state; log compaction disabled",
                    cls,
                    ident,
                )
                # clean up this aborted generation's files so they don't
                # orphan until a later successful snapshot, and record the
                # degraded mode durably so operators can see why the input
                # log keeps growing (ADVICE r2: all-or-nothing snapshot)
                for key in written + new_segments:
                    self.store.remove(key)
                self._segments_present.difference_update(new_segments)
                self.degraded_snapshot = f"{cls}#{ident}"
                meta["snapshot_degraded"] = self.degraded_snapshot
                return None
            for skey, data in seg_blobs:
                self.store.put(skey, data)
                self._segments_present.add(skey)
                new_segments.append(skey)
                bytes_written += len(data)
            key = self._state_key(gen, ident)
            self.store.put(key, blob)
            written.append(key)
            bytes_written += len(blob)
            nodes[str(ident)] = cls
        self.degraded_snapshot = None
        meta.pop("snapshot_degraded", None)
        self._m["segs_written"].inc(len(new_segments))
        self._m["snap_bytes"].observe(float(bytes_written))
        self._m["snap_seconds"].observe(time.monotonic() - t0)
        self.snapshots.append((time.monotonic() - t0, bytes_written))
        # snapshot covers everything up to and including the last processed
        # tick; all flushed chunks hold rows with time <= this
        return {
            "gen": gen,
            "time": self._last_real_time,
            "nodes": nodes,
            "segment_keys": sorted(segment_keys),
        }

    def _gc(self, meta: dict, snap: dict) -> None:
        """After the metadata naming the new generation is durable, delete
        the input chunks the snapshot covers, older state generations, and
        segment files no retained generation references (compaction
        retires dead segments).  Multi-process keeps one extra generation
        (state + the inter-snapshot chunks) so a restart can restore the
        group-min time."""
        keep_segments = set(snap.get("segment_keys", ()))
        if getattr(self.runtime, "host_mesh", None) is not None:
            # the group confirmed this generation (gen-commit barrier):
            # trim the retained list back to ONE superseded generation
            # (the lockstep skew bound), then retire files nothing kept
            # references. Metadata is trimmed FIRST — a crash here
            # orphans files (harmless: _segments_present is primed from
            # metadata, so re-minted ids overwrite them) instead of
            # naming deleted ones.
            retained = list(meta.get("retained_states", ()))
            kept = retained[-1:]
            meta["retained_states"] = kept
            if kept:
                meta["prev_state"] = kept[-1]["state"]
                meta["prev_chunks"] = kept[-1]["chunks"]
            self.store.put(_META_KEY, json.dumps(meta).encode())
            keep_inputs = {
                f"inputs/{pid}/chunk-{i:08d}.pkl"
                for entry in kept
                for pid, ids in entry.get("chunks", {}).items()
                for i in ids
            }
            for key in self.store.list_keys("inputs/"):
                if key not in keep_inputs:
                    self.store.remove(key)
            keep = {f"states/gen-{snap['gen']:06d}/"}
            for entry in kept:
                prev = entry.get("state") or {}
                keep.add(f"states/gen-{int(prev['gen']):06d}/")
                keep_segments.update(prev.get("segment_keys", ()))
            for key in self.store.list_keys("states/"):
                if not any(key.startswith(p) for p in keep):
                    self.store.remove(key)
            self._gc_segments(keep_segments)
            return
        for key in self.store.list_keys("inputs/"):
            self.store.remove(key)
        prefix = f"states/gen-{snap['gen']:06d}/"
        for key in self.store.list_keys("states/"):
            if not key.startswith(prefix):
                self.store.remove(key)
        self._gc_segments(keep_segments)

    def _gc_segments(self, keep: set) -> None:
        retired = 0
        for key in self.store.list_keys("segments/"):
            if key not in keep:
                self.store.remove(key)
                self._segments_present.discard(key)
                retired += 1
        if retired:
            self._m["segs_retired"].inc(retired)

    # --- resume path ----------------------------------------------------------

    def replay(self) -> None:
        t0 = time.monotonic()
        try:
            self._replay_inner()
        finally:
            self.recovery_seconds = time.monotonic() - t0
            self._m["recovery_seconds"].set(self.recovery_seconds)

    def _replay_inner(self) -> None:
        """Restore operator snapshots, then feed only the log TAIL (events
        newer than the snapshot) through the graph at original logical
        times, then restore connector offsets."""
        meta = self._load_meta()
        self._chunk_counts = dict(meta.get("chunks", {}))
        self._live_chunks = {
            pid: list(v) for pid, v in meta.get("live_chunks", {}).items()
        }
        if not self.replay_allowed:
            return
        # multi-process: replay ticks must run in lockstep like live ticks
        # (DCN exchanges pair by (channel, tick) group-wide), and the
        # whole group must restore at ONE agreed time — a process whose
        # snapshot is newer than a peer's would otherwise skip replaying
        # logged rows the peer's state still needs. Snapshot generations
        # are lockstep-aligned with skew <= 1, and commit() retains the
        # previous generation, so the group-min time is always locally
        # restorable (the reference's cross-worker flushed-frontier
        # consensus, src/persistence/state.rs:291).
        hm = getattr(self.runtime, "host_mesh", None)
        state_time = -1  # -1 = no snapshot: replay everything incl. t=0
        t0 = time.monotonic()
        if hm is None:
            snap = meta.get("state")
            if snap:
                state_time = self._restore_operators(snap)
        else:
            latest = meta.get("state")
            # candidates newest-first: latest, then every retained
            # superseded generation (legacy metadata: prev_state). The
            # gen-commit barrier's retained list guarantees the group
            # minimum is locally restorable on every rank.
            older = [
                r.get("state")
                for r in reversed(meta.get("retained_states", []))
                if r.get("state")
            ]
            if not older and meta.get("prev_state"):
                older = [meta["prev_state"]]
            latest_time = int(latest.get("time", 0)) if latest else -1
            vals = hm.barrier(("replay-gen", latest_time))
            group_time = min(v[1] for v in vals.values())
            chosen = None
            if group_time >= 0:
                for cand in [latest] + older:
                    if cand and int(cand.get("time", 0)) <= group_time:
                        chosen = cand
                        break
            # the phase-2 audit record: what the group had confirmed
            # restorable before the crash — surfaced so an operator can
            # compare it with what this recovery actually picked
            marker_raw = self.store.get(_GROUP_COMMIT_KEY)
            if marker_raw is not None:
                import logging

                logging.getLogger("pathway_tpu_torch").info(
                    "group recovery: restoring generation at time %s "
                    "(live group agreement %s; last durable gen-commit "
                    "agreement %s)",
                    chosen.get("time") if chosen else None,
                    group_time,
                    json.loads(marker_raw.decode()).get("time"),
                )
            if chosen is not None:
                state_time = self._restore_operators(chosen)
        self.restore_seconds = time.monotonic() - t0
        # Replica Shield: a restarted WRITER restored the index at
        # state_time — ticks at or before it are not in the (fresh)
        # delta ring, only in the snapshot generation; tell the
        # publisher before replay re-publishes the log tail, so replica
        # subscriptions from older ticks resync instead of silently
        # missing the gap
        if state_time >= 0:
            from pathway_tpu_torch.parallel import replicate

            pub = replicate.publisher()
            if pub is not None:
                pub.set_floor(state_time)
        # receiver-side floor: drop exchanged partitions already covered
        # by this process's restored state
        if hm is not None and state_time >= 0:
            for ex in self.runtime.execs.values():
                if hasattr(ex, "replay_floor"):
                    ex.replay_floor = state_time
        # sender-side floor must be the GROUP minimum: rows this process
        # logged may route to a peer restored at an older time (e.g. a
        # structural-mismatch fallback on one process)
        if hm is not None:
            vals = hm.barrier(("replay-floor", state_time))
            group_floor = min(v[1] for v in vals.values())
        else:
            group_floor = state_time
        need_emit = any(
            getattr(ex, "_restore_emit", None)
            for ex in self.runtime.execs.values()
        )
        if hm is not None:
            vals = hm.barrier(("replay-emit", need_emit))
            need_emit = any(v[1] for v in vals.values())
        if need_emit:
            # flush restored-accumulator re-emissions at the run's
            # INITIAL time, before any log-tail replay at later times —
            # otherwise the emission timestamp would be whatever data
            # tick happens to run first
            self._orig_tick(0, None)
        t0 = time.monotonic()
        events: list[tuple[int, int, DiffBatch]] = []  # (time, node_id, batch)
        for pid, node in self.inputs.items():
            chunk_ids = self._live_chunks.get(pid)
            if chunk_ids is None:  # pre-compaction metadata: contiguous
                chunk_ids = list(range(meta.get("chunks", {}).get(pid, 0)))
            if hm is not None:
                # retained-generation chunks too: they cover the spans
                # between the retained generations, needed when the
                # group restores an older one
                retained_chunks = [
                    i
                    for r in meta.get("retained_states", [])
                    for i in r.get("chunks", {}).get(pid, [])
                ]
                if not retained_chunks:
                    retained_chunks = list(
                        meta.get("prev_chunks", {}).get(pid, [])
                    )
                chunk_ids = list(
                    dict.fromkeys(retained_chunks + list(chunk_ids))
                )
            for i in chunk_ids:
                raw = self.store.get(f"inputs/{pid}/chunk-{i:08d}.pkl")
                if raw is None:
                    continue
                for t, rows in _pickle.loads(raw):
                    if t <= group_floor:
                        continue  # covered by every process's state
                    events.append(
                        (t, node.id, DiffBatch.from_rows(rows, node.column_names))
                    )
        self.replayed_events = len(events)
        self.replayed_rows = sum(len(e[2]) for e in events)
        events.sort(key=lambda e: e[0])
        i, n = 0, len(events)
        ticks = 0
        if hm is None:
            while i < n:
                t = events[i][0]
                injected: dict[int, list[DiffBatch]] = {}
                while i < n and events[i][0] == t:
                    injected.setdefault(events[i][1], []).append(events[i][2])
                    i += 1
                self._orig_tick(t, injected)
                ticks += 1
        else:
            while True:
                local_next = events[i][0] if i < n else END_OF_TIME
                vals = hm.barrier(("replay", local_next))
                t = min(v[1] for v in vals.values())
                if t >= END_OF_TIME:
                    break
                injected = {}
                while i < n and events[i][0] == t:
                    injected.setdefault(events[i][1], []).append(events[i][2])
                    i += 1
                self._orig_tick(t, injected)
                ticks += 1
        self.replayed_ticks = ticks
        self.replay_seconds = time.monotonic() - t0
        t0 = time.monotonic()
        # restore offsets so live sources continue past what was replayed
        # (the metadata names the committed snapshot; legacy stores fall
        # back to the old in-place key)
        for pid, node in () if self.selective else self.inputs.items():
            okey = meta.get("offsets", {}).get(pid, f"offsets/{pid}.pkl")
            raw = self.store.get(okey)
            if raw is None:
                continue
            state = _pickle.loads(raw)
            src = node.source
            if isinstance(state, dict) and state.get("__static_done__"):
                if isinstance(src, StaticSource):
                    node.source = _EmptyStatic(node.column_names)
            elif hasattr(src, "seek"):
                src.seek(state)
        self.seek_seconds = time.monotonic() - t0

    def _restore_operators(self, snap: dict) -> int:
        """Load every node's snapshotted state; on any structural mismatch
        (different graph shape/classes than when snapshotted) fall back to
        full-log replay by reporting state_time -1. In selective mode a
        missing/renamed identity just means that operator starts fresh —
        there is no log to fall back to.

        Everything that can fail (blob fetch, unpickle, segment fetch and
        arrangement rebuild) happens BEFORE any exec mutates, so a torn
        snapshot falls back to log replay over pristine fresh state.
        Arrangement-backed states rebuild over ``get_buffer`` views — on
        the filesystem store that is an mmap, so restore cost is
        O(manifest), with column bytes faulting in lazily."""
        gen = int(snap["gen"])
        current = {
            str(ident): (cls, ex, refeed)
            for ident, cls, ex, refeed in self._node_ordinals()
        }
        loaded: list[tuple[Any, bool, dict, dict | None]] = []
        for ident, cls in snap.get("nodes", {}).items():
            if ident not in current or current[ident][0] != cls:
                if self.selective:
                    continue
                return -1
            raw = self.store.get(self._state_key(gen, ident))
            if raw is None:
                if self.selective:
                    continue
                return -1
            state = _pickle.loads(raw)
            _cls, ex, refeed = current[ident]
            if isinstance(state, dict) and state.get("__pw_arranged__"):
                try:
                    arrs = {}
                    for name, man in state["manifests"].items():
                        arrs[name] = load_arrangement(
                            man,
                            lambda sid, name=name, epoch=man[
                                "epoch"
                            ], ident=ident: self.store.get_buffer(
                                self._segment_key(ident, name, epoch, sid)
                            ),
                        )
                except Exception:
                    _log.warning(
                        "segment snapshot for node %s (%s) unreadable; "
                        "falling back to log replay",
                        cls,
                        ident,
                        exc_info=True,
                    )
                    if self.selective:
                        continue
                    return -1
                check = getattr(ex, "check_arranged_state", None)
                if check is not None and not check(
                    state["residual"], arrs
                ):
                    # structural mismatch the class-name check cannot
                    # see (e.g. PATHWAY_ENGINE_SHARDS changed between
                    # runs): surfaced BEFORE any exec mutates, so the
                    # fallback replays the log over pristine state
                    _log.warning(
                        "snapshot for node %s (%s) does not match the "
                        "current execution layout; falling back to log "
                        "replay",
                        cls,
                        ident,
                    )
                    if self.selective:
                        continue
                    return -1
                loaded.append((ex, refeed, state["residual"], arrs))
            else:
                loaded.append((ex, refeed, state, None))
        for ex, refeed, state, arrs in loaded:
            if arrs is None:
                ex.load_state(state)
            else:
                ex.load_arranged_state(state, arrs)
            if not refeed:
                # this node's logged inputs do NOT re-feed and its
                # downstream consumers were restored too — re-emitting
                # its contents would double-count. Wrappers delegate
                # load_state, so the pending emission may sit on their
                # INNER exec.
                for target in (ex, getattr(ex, "inner", None)):
                    if target is not None and getattr(
                        target, "_restore_emit", None
                    ):
                        target._restore_emit = None
        if loaded:
            self.restored_from_snapshot = True
        return int(snap.get("time", 0))


def attach_persistence(runtime: Runtime, config: Any) -> PersistenceDriver:
    persister = PersistenceDriver(runtime, config)
    # graceful degradation (Phoenix Mesh): while recovery replay runs,
    # Surge-Gated endpoints answer from the last hydrated index snapshot
    # instead of queueing behind the replay — operator restore happens
    # up front (mmap), so the stale corpus is available immediately
    from pathway_tpu_torch.serving import degrade

    _REPLAY_REASON = "restoring persisted state (recovery replay)"
    degrade.enter_recovery(_REPLAY_REASON)
    try:
        persister.replay()
    finally:
        degrade.exit_recovery(_REPLAY_REASON)
    runtime.tick = persister.on_tick  # type: ignore[method-assign]
    runtime.persistence_driver = persister  # type: ignore[attr-defined]
    return persister
