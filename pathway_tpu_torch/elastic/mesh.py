"""Own copy of ``pathway_tpu/elastic/mesh.py`` over the port's persistence
stores, whose bytes are the reference's: a group store written by either
package is resharded by the other and restores in both.

Mesh-plane resharding: N per-rank stores → M per-rank stores.

A supervised DCN group persists one store per rank (the job script
keys it by PATHWAY_PROCESS_ID), each holding that rank's disjoint
jk-range of every arranged exec's state.  ``reshard_stores`` is the
transfer phase of a group resize: it loads the newest group-committed
generation from every old rank's store, re-partitions every
arrangement's rows by the NEW rank count (engine/sharded.py
``shard_of`` at process level, and the inner device-shard level when
the snapshot is device-sharded too), and writes a fresh generation
into every new rank's store — so the respawned M-rank group restores
with ``replayed_events == 0``.  Only rows whose rank changes are
"moved"; with ``via_wire=True`` the moved ranges additionally ship
through a real :class:`~pathway_tpu_torch.elastic.ferry.FerryReceiver`
per destination (per-segment MACs, content-addressed resume, the
Fault Forge ``kill=ferry:N`` clock), which is also the bytes-ferried
evidence the bench records.  Same-filesystem deployments may set
``via_wire=False`` for a pure O(mmap+put) transform.

Non-arranged (monolithic) snapshots cannot be re-partitioned: kept
ranks carry theirs forward verbatim, grown ranks start those execs
fresh, and the Graph Doctor's ``elastic-resharding`` rule warns ahead
of time about stateful execs this pins to log-replay resizes.

Residual caveats: per-exec residuals hold config/watermark scalars
(identical across ranks — new ranks take rank 0's); a DCN return-home
wrapper's origin tracker maps row keys to OLD rank ids and is reset —
origins rebuild as rows flow.
"""

from __future__ import annotations

import copy
import json
import pickle
from typing import Any

from pathway_tpu_torch.elastic.handover import HandoverError
from pathway_tpu_torch.engine.dcn import DCN_EXTRA_KEY, DCN_INNER_KEY
from pathway_tpu_torch.elastic.planner import plan_reshard
from pathway_tpu_torch.engine.arrangement import Arrangement
from pathway_tpu_torch.engine.sharded import shard_of
from pathway_tpu_torch.persistence._runtime_glue import (
    _META_KEY,
    segment_key,
    state_key,
)
from pathway_tpu_torch.persistence.backends import FilesystemStore
from pathway_tpu_torch.persistence.segments import (
    load_arrangement,
    manifest_of,
    segment_to_bytes,
)


def _seg_copy(seg):
    """Shallow segment copy (arrays shared, identity reset) — the
    whole-segment fast path: a segment whose entire slot range lands on
    one new owner ships without any row decode or re-partition."""
    from pathway_tpu_torch.engine.arrangement import _Segment

    return _Segment(
        seg.jks,
        seg.keys,
        seg.diffs,
        seg.ages,
        list(seg.cols),
        seg.mix_sorted,
        seg.clean,
        -1,
    )


def _seg_slice(seg, idx):
    """Row subset of a sealed segment for a straddler split.  ``idx``
    is increasing, so jk sort order survives; ORIGINAL ages ride along
    so every (jk, key) history keeps its relative order in the
    destination arrangement."""
    import numpy as np

    from pathway_tpu_torch.engine.arrangement import _Segment, mix_keys

    jks = seg.jks[idx]
    keys = seg.keys[idx]
    diffs = seg.diffs[idx]
    mix_sorted = np.sort(mix_keys(jks, keys))
    # a subset of a clean segment is clean (insert-only survives
    # subsetting and duplicates cannot appear); otherwise recompute
    clean = bool(seg.clean) or (
        bool((diffs > 0).all())
        and not bool((mix_sorted[1:] == mix_sorted[:-1]).any())
    )
    return _Segment(
        jks,
        keys,
        diffs,
        seg.ages[idx],
        [np.asarray(c)[idx] for c in seg.cols],
        mix_sorted,
        clean,
        -1,
    )


def _arr_from_pieces(n_cols: int, pieces: list) -> Arrangement:
    """Destination arrangement assembled from shipped segment pieces
    (whole segments and straddler slices, source order).  Ages continue
    from the largest shipped age; cross-source age overlap is harmless
    because old ranks hold disjoint jk ranges."""
    arr = Arrangement(n_cols)
    if not pieces:
        return arr
    next_age = 0
    neg = 0
    for seg in pieces:
        seg.seg_id = arr._alloc_seg_id()
        next_age = max(next_age, int(seg.ages.max()) + 1)
        neg += int((seg.diffs < 0).sum())
    arr.segments = list(pieces)
    arr._next_age = next_age
    arr._entries = int(sum(len(s) for s in pieces))
    arr._neg_entries = neg
    return arr


def _choose_generation(meta: dict, group_time: int) -> dict | None:
    """The newest generation at or below the group-agreed time (the
    same newest-first walk group recovery performs)."""
    candidates = [meta.get("state")]
    candidates += [
        r.get("state")
        for r in reversed(meta.get("retained_states", []))
        if r.get("state")
    ]
    if meta.get("prev_state"):
        candidates.append(meta["prev_state"])
    for cand in candidates:
        if cand and int(cand.get("time", 0)) <= group_time:
            return cand
    return None


def _unwrap(residual: dict, arrs: dict) -> tuple[bool, Any, bool, list, list]:
    """Peel the DCN-wrapper and device-shard nesting off one rank's
    arranged blob → (dcn_wrapped, dcn_extra, dev_sharded,
    [per-dev residual], [per-dev {bare name: Arrangement}])."""
    dcn = isinstance(residual, dict) and DCN_INNER_KEY in residual
    extra = residual.get(DCN_EXTRA_KEY, {}) if dcn else None
    inner = residual[DCN_INNER_KEY] if dcn else residual
    if isinstance(inner, dict) and "__shard_residuals__" in inner:
        dev_res = list(inner["__shard_residuals__"])
        per: list[dict] = [{} for _ in dev_res]
        for key, arr in arrs.items():
            shard, _, name = key.partition(".")
            per[int(shard[1:])][name] = arr
        return dcn, extra, True, dev_res, per
    return dcn, extra, False, [inner], [dict(arrs)]


def _wrap(
    dcn: bool,
    extra: Any,
    dev_sharded: bool,
    dev_res: list,
    per_dev: list[dict],
) -> tuple[dict, dict]:
    """Inverse of :func:`_unwrap` for one NEW rank's blob."""
    if dev_sharded:
        inner_res: Any = {"__shard_residuals__": dev_res}
        arrs = {
            f"s{d}.{name}": arr
            for d, named in enumerate(per_dev)
            for name, arr in named.items()
        }
    else:
        inner_res = dev_res[0]
        arrs = dict(per_dev[0])
    if dcn:
        # origin trackers map row keys to OLD rank ids: reset, rebuild
        new_extra = dict(extra or {})
        if "origin" in new_extra:
            new_extra["origin"] = {}
        return (
            {DCN_INNER_KEY: inner_res, DCN_EXTRA_KEY: new_extra},
            arrs,
        )
    return inner_res, arrs


def reshard_stores(
    old_roots: list[str],
    new_roots: list[str],
    *,
    via_wire: bool = True,
    transfer_id: str | None = None,
) -> dict:
    """Re-partition N per-rank stores into M — the mesh transfer phase.

    Raises :class:`HandoverError` (leaving every store untouched up to
    the metadata commit, i.e. rollback-able) when a retired rank still
    holds log events no snapshot covers, or when a store has no
    restorable generation at the group-agreed time."""
    import time as _time

    from pathway_tpu_torch.elastic.ferry import FerryReceiver, ferry_files

    _t0 = _time.monotonic()
    n_old, n_new = len(old_roots), len(new_roots)
    if n_old < 1 or n_new < 1:
        raise HandoverError("resharding needs >= 1 store on both sides")
    plan = plan_reshard(n_old, n_new)
    stores = [FilesystemStore(r) for r in old_roots]
    metas = []
    for i, st in enumerate(stores):
        raw = st.get(_META_KEY)
        if raw is None:
            raise HandoverError(
                f"old rank {i} ({old_roots[i]}) has no persistence "
                "metadata — nothing to reshard"
            )
        metas.append(json.loads(raw.decode()))
    group_time = min(
        int((m.get("state") or {}).get("time", -1)) for m in metas
    )
    if group_time < 0:
        raise HandoverError(
            "no group-committed operator-state generation exists yet — "
            "resharding moves state, not logs"
        )
    # fixpoint: every rank's CHOSEN generation must sit at ONE agreed
    # time (the retained-generation walk may land a rank below the
    # first minimum when the exact group_time generation was not
    # retained) — stamping a time the state does not actually cover
    # would skip replaying the gap's log events silently
    for _ in range(len(metas) + 2):
        snaps = [_choose_generation(m, group_time) for m in metas]
        if any(s is None for s in snaps):
            raise HandoverError(
                f"some rank cannot restore the group time {group_time}"
            )
        chosen_min = min(int(s["time"]) for s in snaps)
        if chosen_min == group_time:
            break
        group_time = chosen_min
    else:
        raise HandoverError(
            "no generation time is restorable on every rank"
        )
    # shrink guard: a retired rank's uncovered log tail has no new home
    for r in range(n_new, n_old):
        m = metas[r]
        tail = any(v for v in m.get("live_chunks", {}).values())
        if tail or int(m.get("last_time", 0)) > int(snaps[r]["time"]):
            raise HandoverError(
                f"rank {r} retires but holds log events newer than its "
                f"snapshot (time {m.get('last_time')} > "
                f"{snaps[r]['time']}) — snapshot before resizing down"
            )

    # --- load + re-partition every node -----------------------------------
    idents: list[str] = []
    for s in snaps:
        for ident in s.get("nodes", {}):
            if ident not in idents:
                idents.append(ident)
    new_gen = max(int(s["gen"]) for s in snaps) + 1
    # per new rank: {ident: (cls, blob, [(segment key, bytes, moved)])}
    out_nodes: list[dict[str, tuple[str, bytes, list]]] = [
        {} for _ in range(n_new)
    ]
    total_rows = 0
    moved_rows = 0
    bytes_total = 0
    bytes_moved = 0
    # segment-level split accounting: intact = sealed segments whose
    # whole slot range moves to ONE new owner (shipped without a row
    # decode), split = straddlers sliced row-wise, kept = segments that
    # stay home untouched
    segments_shipped_intact = 0
    segments_split = 0
    segments_kept = 0
    # per new rank: the cross-rank chunks as sealed segment blobs —
    # the bytes that genuinely travel (and the FerryReceiver payload)
    moved_blobs: list[list[tuple[str, bytes]]] = [
        [] for _ in range(len(new_roots))
    ]
    monolithic: list[str] = []
    for ident in idents:
        cls = next(
            s["nodes"][ident] for s in snaps if ident in s.get("nodes", {})
        )
        ranks: list[tuple[int, dict]] = []
        mono_blobs: dict[int, bytes] = {}
        for r, (st, s) in enumerate(zip(stores, snaps)):
            if ident not in s.get("nodes", {}):
                continue
            if s["nodes"][ident] != cls:
                raise HandoverError(
                    f"node {ident} class differs across ranks "
                    f"({cls} vs {s['nodes'][ident]})"
                )
            raw = st.get(state_key(int(s["gen"]), ident))
            if raw is None:
                raise HandoverError(
                    f"rank {r}: state blob for node {ident} missing"
                )
            state = pickle.loads(raw)
            if not (
                isinstance(state, dict) and state.get("__pw_arranged__")
            ):
                mono_blobs[r] = raw
                continue
            arrs = {}
            for name, man in state["manifests"].items():
                arrs[name] = load_arrangement(
                    man,
                    lambda sid, name=name, epoch=man["epoch"], ident=ident,
                    st=st: st.get_buffer(
                        segment_key(
                            ident, name, epoch, sid
                        )
                    ),
                )
            ranks.append((r, (state["residual"], arrs)))
        if mono_blobs:
            # monolithic snapshot: carried forward verbatim on kept
            # ranks, fresh on grown ranks (the doctor's
            # elastic-resharding rule warns when such an exec is
            # stateful — it pins key-range moves to log replay)
            monolithic.append(f"{cls}#{ident}")
            for r, raw in mono_blobs.items():
                if r < n_new:
                    out_nodes[r][ident] = (cls, raw, [])
            continue
        if not ranks:
            continue
        dcn, extra, dev_sharded, dev_res0, _ = _unwrap(*ranks[0][1])
        k_dev = len(dev_res0)
        names: list[str] = []
        name_cols: dict[str, int] = {}  # arity survives emptiness: a
        # fully-retracted arrangement must rebuild at its true n_cols
        # gather (old rank, dev shard, name) -> Arrangement; the inner
        # device shard ``shard_of(jk, k_dev)`` is invariant under a
        # process-count change (k_dev is fixed by the job), so segments
        # never cross dev shards and each (r, d) splits independently
        per_rank_arrs: dict[tuple[int, int, str], Arrangement] = {}
        for r, (residual, arrs) in ranks:
            _d, _e, _ds, _res, per_dev = _unwrap(residual, arrs)
            for d, named in enumerate(per_dev):
                for name, arr in named.items():
                    if name not in names:
                        names.append(name)
                    name_cols[name] = arr.n_cols
                    per_rank_arrs[(r, d, name)] = arr
        import numpy as np

        # --- segment-level split ------------------------------------
        # Ownership is decided per SEALED SEGMENT, not per consolidated
        # row: a segment whose every jk hashes to one new owner ships
        # intact (zero-copy views straight off the source mmap — no
        # consolidation pass, no re-append), and only straddlers are
        # sliced row-wise.  Host work is O(moved bytes + straddler
        # bytes) instead of O(total store bytes).  Original ages ride
        # along in both cases so (jk, key) histories keep their
        # relative order and the restored fold stays bit-equal.
        new_pieces: list[list[dict[str, list]]] = [
            [dict() for _ in range(k_dev)] for _ in range(n_new)
        ]
        moved_chunks: list[list[tuple[str, Any]]] = [
            [] for _ in range(n_new)
        ]  # per dst rank: (name, piece) arriving from a DIFFERENT rank
        for (r, d, name), arr in per_rank_arrs.items():
            for seg in arr.segments:
                if not len(seg):
                    continue
                total_rows += len(seg)
                jks = np.asarray(seg.jks, dtype=np.uint64)
                dest = shard_of(jks, n_new)
                owners = np.unique(dest)
                if len(owners) == 1:
                    p = int(owners[0])
                    piece = _seg_copy(seg)
                    if p != r:
                        moved_rows += len(seg)
                        segments_shipped_intact += 1
                        moved_chunks[p].append((name, piece))
                    else:
                        segments_kept += 1
                    new_pieces[p][d].setdefault(name, []).append(piece)
                    continue
                segments_split += 1
                for p in owners.tolist():
                    p = int(p)
                    idx = np.nonzero(dest == p)[0]
                    piece = _seg_slice(seg, idx)
                    if p != r:
                        moved_rows += len(idx)
                        moved_chunks[p].append((name, piece))
                    new_pieces[p][d].setdefault(name, []).append(piece)
        # every name must exist on every dev shard (load_arranged
        # indexes by name), even when empty for this rank — at its
        # SOURCE arity, never a guessed one
        new_per_rank: list[list[dict[str, Arrangement]]] = [
            [
                {
                    name: _arr_from_pieces(
                        name_cols[name], new_pieces[p][d].get(name, [])
                    )
                    for name in names
                }
                for d in range(k_dev)
            ]
            for p in range(n_new)
        ]
        for p in range(n_new):
            # the ferried artifact: each cross-rank piece's segment
            # blob — exactly the moved key ranges' bytes (intact
            # segments re-encode their shared views verbatim)
            for j, (name, piece) in enumerate(moved_chunks[p]):
                blob = segment_to_bytes(piece)
                moved_blobs[p].append(
                    (f"{ident}/{name}/part{j:04d}.seg", blob)
                )
            res_list = [copy.deepcopy(dev_res0[0]) for _ in range(k_dev)]
            residual, arrs = _wrap(
                dcn, extra, dev_sharded, res_list, new_per_rank[p]
            )
            manifests = {}
            seg_files: list[tuple[str, bytes]] = []
            for name, arr in arrs.items():
                man = manifest_of(arr)
                manifests[name] = man
                by_id = {s.seg_id: s for s in arr.segments}
                for sd in man["segments"]:
                    key = segment_key(
                        ident, name, man["epoch"], sd["id"]
                    )
                    blob = segment_to_bytes(by_id[sd["id"]])
                    seg_files.append((key, blob))
            blob = pickle.dumps(
                {
                    "__pw_arranged__": 1,
                    "residual": residual,
                    "manifests": manifests,
                }
            )
            out_nodes[p][ident] = (cls, blob, seg_files)
    # accounting: total = every final segment byte; ferried = only the
    # moved key ranges' chunk segments (what actually crosses ranks)
    for p in range(n_new):
        for _ident, (_cls, _blob, segs) in out_nodes[p].items():
            for _key, data in segs:
                bytes_total += len(data)
        for _name, data in moved_blobs[p]:
            bytes_moved += len(data)

    # --- transfer + write phase -------------------------------------------
    # Two stages across ALL roots, so a failure ANYWHERE in the ferry/
    # data stage leaves every old metadata committed (full rollback —
    # the new-generation files are inert orphans until metadata names
    # them).  Only the final metadata stage — one tiny local JSON put
    # per root — commits the new topology; its window is a few renames,
    # and the driving handover (supervisor resize / TwoPhaseHandover)
    # still brackets the whole thing.
    tid = transfer_id or f"reshard-{n_old}to{n_new}-g{new_gen}"
    # Fleet Lens: reshard phase transitions land in the incident journal
    # (persisted — peers reconstruct a SIGKILLed rank's reshard from
    # these), and /fleet/events derives the reshard window from
    # reshard-transfer -> reshard-commit
    from pathway_tpu_torch.observability.journal import record as journal_record

    journal_record(
        "reshard-transfer",
        f"{n_old} -> {n_new} ranks (generation {new_gen})",
        persist=True,
        n_old=n_old,
        n_new=n_new,
        generation=new_gen,
        group_time=group_time,
        moved_rows=moved_rows,
        bytes_ferried=bytes_moved,
        segments_shipped_intact=segments_shipped_intact,
        segments_split=segments_split,
    )
    ferry_stats: list[dict] = []
    dsts = [FilesystemStore(root) for root in new_roots]
    for p, dst in enumerate(dsts):
        moved_files = moved_blobs[p]
        if via_wire and moved_files:
            recv = FerryReceiver(dst._path("reshard/inbox"))
            try:
                ferry_stats.append(
                    ferry_files(
                        recv.host,
                        recv.port,
                        moved_files,
                        transfer_id=f"{tid}-p{p}",
                    )
                )
            finally:
                recv.close()
        for ident, (cls, blob, segs) in out_nodes[p].items():
            for key, data in segs:
                dst.put(key, data)
            dst.put(state_key(new_gen, ident), blob)
    for p, dst in enumerate(dsts):
        root = new_roots[p]
        nodes_map: dict[str, str] = {}
        segment_keys: list[str] = []
        for ident, (cls, blob, segs) in out_nodes[p].items():
            for key, _data in segs:
                segment_keys.append(key)
            nodes_map[ident] = cls
        raw = dst.get(_META_KEY)
        meta = (
            json.loads(raw.decode())
            if raw is not None
            else {"last_time": 0, "chunks": {}}
        )
        meta["state"] = {
            "gen": new_gen,
            "time": group_time,
            "nodes": nodes_map,
            "segment_keys": sorted(segment_keys),
        }
        meta["last_time"] = max(int(meta.get("last_time", 0)), group_time)
        # superseded generations were partitioned for the OLD topology
        # and must never be restored under the new one — but their
        # inter-snapshot chunk lists may cover log events newer than
        # the agreed group time (a rank whose own snapshot was newer):
        # fold them into live_chunks so the replay can still walk them
        live = {
            pid: list(ids)
            for pid, ids in meta.get("live_chunks", {}).items()
        }
        retained_chunk_maps = [
            r.get("chunks", {}) for r in meta.get("retained_states", [])
        ]
        if meta.get("prev_chunks"):
            retained_chunk_maps.append(meta["prev_chunks"])
        for cmap in retained_chunk_maps:
            for pid, ids in cmap.items():
                merged = list(dict.fromkeys(list(ids) + live.get(pid, [])))
                live[pid] = merged
        meta["live_chunks"] = live
        meta.pop("retained_states", None)
        meta.pop("prev_state", None)
        meta.pop("prev_chunks", None)
        dst.put(_META_KEY, json.dumps(meta).encode())
        # the ferried inbox was the wire transfer itself (and its
        # evidence); the authoritative files are the store keys the
        # metadata now names — drop the staging copy
        import shutil as _shutil

        _shutil.rmtree(dst._path("reshard/inbox"), ignore_errors=True)
    transfer_seconds = _time.monotonic() - _t0
    journal_record(
        "reshard-commit",
        f"{n_old} -> {n_new} ranks committed (generation {new_gen})",
        persist=True,
        n_old=n_old,
        n_new=n_new,
        generation=new_gen,
        bytes_ferried=bytes_moved,
        transfer_seconds=round(transfer_seconds, 6),
    )
    return {
        "plan": {
            "n_old": n_old,
            "n_new": n_new,
            "moved_slot_fraction": round(plan.moved_fraction, 4),
        },
        "generation": new_gen,
        "group_time": group_time,
        "nodes_resharded": len(idents) - len(monolithic),
        "monolithic_carried": monolithic,
        "total_rows": total_rows,
        "moved_rows": moved_rows,
        "segments_shipped_intact": segments_shipped_intact,
        "segments_split": segments_split,
        "segments_kept": segments_kept,
        "bytes_total_segments": bytes_total,
        "bytes_ferried": bytes_moved,
        "transfer_seconds": round(transfer_seconds, 6),
        "ferry": ferry_stats,
    }
