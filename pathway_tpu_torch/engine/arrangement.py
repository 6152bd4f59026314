"""Columnar arrangements — own copy of ``pathway_tpu/engine/arrangement.py``
(numpy only, the same knobs and defaults), so the port's ``KvLedger`` keeps
its state in the same arrangement ledgers and writes the same segments.

Columnar arrangements — indexed operator state for delta joins.

The microbatch analog of differential dataflow's *arranged* collections
(reference: external/differential-dataflow arrangements; join_tables
arrange+join_core, src/engine/dataflow.rs:2740,2834): operator state is a
log-structured set of **sorted columnar segments** — join-key, row-key and
diff-weight ndarrays plus the value columns — instead of Python
dict-of-dicts.  Appending a tick's delta is O(sort of the delta); probing
gathers the full history of a set of join keys with one ``searchsorted``
per segment; entries collapse to current state (net weight, latest values)
with a single vectorized pass.

Lifecycle:

* ``append`` stages a delta batch (no work beyond bookkeeping).
* ``_seal`` sorts staged batches into segments.  Adjacent segments of
  similar size merge geometrically (entry-preserving scatter-merge of two
  sorted runs), so the segment count stays logarithmic and every entry is
  re-merged O(log n) times total — the lazy-merge schedule of an LSM tree
  / differential's merge batcher.
* ``compact`` rewrites the whole history into one consolidated segment
  (net weights, zero-weight groups dropped).  It runs when the fraction of
  retraction entries since the last compaction crosses
  ``PATHWAY_ARRANGE_COMPACT_RATIO`` (default 0.3) — retraction-heavy
  streams stay bounded, append-only streams never pay for it.

Each segment carries a sorted fingerprint of its (jk, rowkey) pairs and a
``clean`` flag (insert-only, no duplicate pairs).  Probes whose gathered
entries are provably clean skip consolidation — the append-only steady
state pays one stable argsort per probe instead of a 3-key lexsort plus
group reduction.

Consolidation semantics mirror the rowwise dict state exactly
(``nodes.py _SideState.apply``): net weight per (join key, row key) with
zero-weight entries dropped (negative weights are kept — a retraction may
precede its insert), values from the **last positive-weight** entry
(first entry when none ever was positive), and emission order by first
appearance.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

_MIX = np.uint64(0x9E3779B97F4A7C15)


def mix_keys(jks: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """64-bit fingerprint of (jk, rowkey) pairs.  The fingerprint IS the
    pair's identity wherever it is used for grouping (consolidate_mixed)
    or cross-state cancelation — the same 64-bit hash-identity contract
    the engine already accepts for row keys and consolidate()'s value
    hashes.  Where it gates a fast path (cleanliness, overlap checks) a
    collision merely demotes to the slow path."""
    return (np.asarray(jks, dtype=np.uint64) * _MIX) ^ np.asarray(
        keys, dtype=np.uint64
    )


def _col_bytes(col: np.ndarray) -> int:
    """Resident bytes of one value column.  Object-dtype columns hold
    pointers; walk the elements so pickled blobs / nested arrays report
    their payload size (bytes -> len, ndarray -> nbytes, everything else
    sys.getsizeof)."""
    if col.dtype != object:
        return int(col.nbytes)
    import sys

    total = int(col.nbytes)  # the pointer array itself
    for v in col:
        if isinstance(v, (bytes, bytearray)):
            total += len(v)
        elif isinstance(v, np.ndarray):
            total += int(v.nbytes)
        elif v is not None:
            try:
                total += sys.getsizeof(v)
            except TypeError:
                pass
    return total


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# dtype-preserving column concat (state must never silently promote int64
# to float64) and vectorized range expansion
from pathway_tpu_torch.engine.batch import (  # noqa: E402,F401
    concat_columns,
    expand_ranges,
)


def sorted_member(values: np.ndarray, sorted_ref: np.ndarray) -> np.ndarray:
    """Membership mask of ``values`` in an already-sorted reference array
    — one searchsorted instead of np.isin's per-call re-sorts."""
    n = len(sorted_ref)
    if not n or not len(values):
        return np.zeros(len(values), dtype=bool)
    idx = np.searchsorted(sorted_ref, values)
    idx[idx == n] = n - 1
    return sorted_ref[idx] == values


def _merge_indices(
    a: np.ndarray, b: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Positions of two sorted runs' elements in their stable merge
    (b after equal a) — two searchsorteds instead of an argsort."""
    idx_a = np.arange(len(a), dtype=np.int64) + np.searchsorted(
        b, a, "left"
    )
    idx_b = np.arange(len(b), dtype=np.int64) + np.searchsorted(
        a, b, "right"
    )
    return idx_a, idx_b


def _scatter_merge(
    idx_a: np.ndarray, idx_b: np.ndarray, xa: np.ndarray, xb: np.ndarray
) -> np.ndarray:
    """Place two runs at precomputed merge positions, widening to object
    only when dtypes differ (values are never silently promoted)."""
    if xa.dtype == xb.dtype:
        out = np.empty(len(xa) + len(xb), dtype=xa.dtype)
    else:
        out = np.empty(len(xa) + len(xb), dtype=object)
        xa = xa.astype(object)
        xb = xb.astype(object)
    out[idx_a] = xa
    out[idx_b] = xb
    return out


def merge_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Stable merge of two sorted same-dtype arrays."""
    idx_a, idx_b = _merge_indices(a, b)
    return _scatter_merge(idx_a, idx_b, a, b)


class Rows:
    """A consolidated view of arrangement state: one entry per
    (join key, row key), sorted by (jk, age).  ``count`` is the net diff
    weight (never 0); ``age`` orders emission like dict insertion order;
    ``cols`` are the gathered value columns."""

    def __init__(self, jk, key, count, age, cols):
        self.jk = jk
        self.key = key
        self.count = count
        self.age = age
        self.cols = cols

    def __len__(self) -> int:
        return len(self.jk)

    @staticmethod
    def empty(n_cols: int) -> "Rows":
        return Rows(
            np.empty(0, np.uint64),
            np.empty(0, np.uint64),
            np.empty(0, np.int64),
            np.empty(0, np.int64),
            [np.empty(0, object) for _ in range(n_cols)],
        )

    def take(self, idx: np.ndarray) -> "Rows":
        return Rows(
            self.jk[idx],
            self.key[idx],
            self.count[idx],
            self.age[idx],
            [c[idx] for c in self.cols],
        )


def merge_rows_sorted(a: Rows, b: Rows) -> Rows:
    """Merge two Rows with disjoint (jk, key) sets into one (jk, age)-
    sorted Rows — valid only when every b age exceeds every a age (the
    delta-overlay fast path)."""
    if not len(a):
        return b
    if not len(b):
        return a
    idx_a, idx_b = _merge_indices(a.jk, b.jk)
    return Rows(
        _scatter_merge(idx_a, idx_b, a.jk, b.jk),
        _scatter_merge(idx_a, idx_b, a.key, b.key),
        _scatter_merge(idx_a, idx_b, a.count, b.count),
        _scatter_merge(idx_a, idx_b, a.age, b.age),
        [
            _scatter_merge(idx_a, idx_b, ca, cb)
            for ca, cb in zip(a.cols, b.cols)
        ],
    )


def consolidate_entries(
    jks: np.ndarray,
    keys: np.ndarray,
    diffs: np.ndarray,
    ages: np.ndarray,
    cols: Sequence[np.ndarray],
) -> Rows:
    """Collapse raw entries into current state per (jk, key) — the
    vectorized twin of replaying ``_SideState.apply`` row by row: net
    weight (zero-net groups dropped), values from the last positive-weight
    entry (first entry when none), age of first appearance.  Only valid
    over a key's FULL history (or a full-history prefix already collapsed
    to one entry + later entries): collapsing a middle slice could lose
    the last-positive value."""
    m = len(jks)
    if m == 0:
        return Rows.empty(len(cols))
    order = np.lexsort((ages, keys, jks))
    jk_s = jks[order]
    key_s = keys[order]
    d_s = diffs[order]
    age_s = ages[order]
    boundary = np.empty(m, dtype=bool)
    boundary[0] = True
    boundary[1:] = (jk_s[1:] != jk_s[:-1]) | (key_s[1:] != key_s[:-1])
    starts = np.nonzero(boundary)[0]
    net = np.add.reduceat(d_s, starts)
    # dict parity for re-created entries: when a group's running count
    # hits zero mid-history the dict DELETES the entry, and a later
    # entry re-creates it with fresh value memory and a fresh insertion
    # position — so value selection and the emission age are restricted
    # to the window after the group's last zero-crossing
    grp_id = np.cumsum(boundary) - 1
    cs = np.cumsum(d_s)
    offs = np.zeros(len(starts), dtype=np.int64)
    offs[1:] = cs[starts[1:] - 1]
    prefix = cs - offs[grp_id]
    idx = np.arange(m, dtype=np.int64)
    zpos = np.where(prefix == 0, idx, np.int64(-1))
    last_zero = np.maximum.reduceat(zpos, starts)
    wstart = np.where(last_zero >= 0, last_zero + 1, starts)
    # net==0 groups put wstart past their end; `keep` drops them anyway
    pos = np.where(
        (d_s > 0) & (idx >= wstart[grp_id]), idx, np.int64(-1)
    )
    last_pos = np.maximum.reduceat(pos, starts)
    sel = np.where(last_pos >= 0, last_pos, wstart)
    keep = net != 0
    kstarts = wstart[keep]
    src = order[sel[keep]]
    res = Rows(
        jk_s[kstarts],
        key_s[kstarts],
        net[keep],
        age_s[kstarts],
        [c[src] for c in cols],
    )
    if len(res) > 1:
        res = res.take(np.lexsort((res.age, res.jk)))
    return res


def consolidate_mixed(
    jks: np.ndarray,
    keys: np.ndarray,
    diffs: np.ndarray,
    ages: np.ndarray,
    cols: Sequence[np.ndarray],
    mix: np.ndarray,
) -> Rows:
    """consolidate_entries specialized for entry sets whose positions are
    age-ordered *within* each (jk, key) group (probe gathers and delta
    overlays are — segments and batches concatenate in age order): groups
    come from one sort of the 64-bit pair fingerprint and the
    last-positive/first selections become O(n) scatter reductions instead
    of a 3-key lexsort.  Inherits the engine-wide 64-bit hash-identity
    contract (row keys and consolidate()'s value hashes accept the same
    collision odds)."""
    m = len(jks)
    if m == 0:
        return Rows.empty(len(cols))
    _uniq, inverse = np.unique(mix, return_inverse=True)
    g = len(_uniq)
    net = np.zeros(g, dtype=np.int64)
    np.add.at(net, inverse, diffs)
    pos_mask = diffs > 0
    # zero-crossing resets (dict deletes + re-creates the entry) need the
    # per-group running count, which the sort-free path cannot see.  A
    # crossing requires >= 3 entries of mixed sign in one surviving
    # group — delegate exactly those inputs to the sorted path.
    if (~pos_mask).any():
        sizes = np.bincount(inverse, minlength=g)
        has_neg = np.zeros(g, dtype=bool)
        has_neg[inverse[~pos_mask]] = True
        has_pos = np.zeros(g, dtype=bool)
        has_pos[inverse[pos_mask]] = True
        if bool(
            ((sizes >= 3) & has_neg & has_pos & (net != 0)).any()
        ):
            return consolidate_entries(jks, keys, diffs, ages, cols)
    positions = np.arange(m, dtype=np.int64)
    first = np.full(g, m, dtype=np.int64)
    np.minimum.at(first, inverse, positions)
    last_pos = np.full(g, -1, dtype=np.int64)
    if pos_mask.any():
        np.maximum.at(last_pos, inverse[pos_mask], positions[pos_mask])
    sel = np.where(last_pos >= 0, last_pos, first)
    keep = net != 0
    fk = first[keep]
    sk = sel[keep]
    res = Rows(
        jks[fk], keys[fk], net[keep], ages[fk], [c[sk] for c in cols]
    )
    if len(res) > 1:
        res = res.take(np.lexsort((res.age, res.jk)))
    return res


class _Segment:
    """Immutable run sorted by jk (stable — equal-jk entries keep
    insertion order) with per-entry global ages, a sorted (jk, key)
    fingerprint for overlap/duplicate checks, and a ``clean`` flag
    (insert-only weights, no duplicate (jk, key) pairs).

    ``seg_id`` is a per-arrangement monotone identity assigned at creation
    (sealing, merging and compaction all mint fresh ids): a given id names
    one immutable byte-content forever, which is what lets the persistence
    layer content-address segment files and write only ids it has never
    seen (persistence/segments.py)."""

    __slots__ = (
        "jks", "keys", "diffs", "ages", "cols", "mix_sorted", "clean",
        "seg_id",
    )

    def __init__(
        self, jks, keys, diffs, ages, cols, mix_sorted, clean, seg_id=-1
    ):
        self.jks = jks
        self.keys = keys
        self.diffs = diffs
        self.ages = ages
        self.cols = cols
        self.mix_sorted = mix_sorted
        self.clean = clean
        self.seg_id = seg_id

    def __len__(self) -> int:
        return len(self.jks)

    def __getstate__(self):  # __slots__ classes need explicit pickling
        return {s: getattr(self, s) for s in self.__slots__}

    def __setstate__(self, state):
        self.seg_id = -1  # pre-seg_id pickles
        for k, v in state.items():
            setattr(self, k, v)


class Arrangement:
    """Log-structured columnar multiset of (jk, rowkey, weight, values)."""

    def __init__(
        self,
        n_cols: int,
        *,
        max_segments: int | None = None,
        compact_ratio: float | None = None,
    ):
        self.n_cols = n_cols
        self.segments: list[_Segment] = []
        self._staged: list[tuple] = []
        self._next_age = 0
        self._entries = 0  # raw entries across segments + staged
        self._neg_entries = 0  # retraction entries since last compaction
        self.compactions = 0
        self.merges = 0
        # persistence identity: epoch distinguishes this arrangement's
        # segment-id space from any earlier incarnation whose files may
        # still sit in a store (a fresh run after a structural-mismatch
        # restart would otherwise mint seg_id 0 again and collide with
        # the stale file of the same name); ids are monotone within one
        # epoch, including across save/restore
        self.epoch = os.urandom(6).hex()
        self._next_seg_id = 0
        self.max_segments = (
            max_segments
            if max_segments is not None
            else _env_int("PATHWAY_ARRANGE_MAX_SEGMENTS", 16)
        )
        self.compact_ratio = (
            compact_ratio
            if compact_ratio is not None
            else _env_float("PATHWAY_ARRANGE_COMPACT_RATIO", 0.3)
        )

    def __len__(self) -> int:
        return self._entries

    def resident_bytes(self) -> int:
        """Host-resident byte footprint of the log: sealed segments plus
        staged-but-uncommitted deltas. Numeric columns report ndarray
        nbytes; object columns report payload bytes per element (a
        pickled-blob column's 8-byte pointers would otherwise hide the
        actual residency the memory ledger exists to expose). Feeds
        Tick Scope's ``pathway_tickscope_resident_bytes`` families."""
        total = 0
        for seg in self.segments:
            total += (
                seg.jks.nbytes + seg.keys.nbytes + seg.diffs.nbytes
                + seg.ages.nbytes
            )
            if seg.mix_sorted is not None:
                total += seg.mix_sorted.nbytes
            for c in seg.cols:
                total += _col_bytes(c)
        for staged in self._staged:
            jks, keys, diffs, cols = staged[0], staged[1], staged[2], staged[3]
            total += jks.nbytes + keys.nbytes + diffs.nbytes
            for c in cols:
                total += _col_bytes(np.asarray(c))
        return total

    def __setstate__(self, state: dict) -> None:
        # monolith snapshots written before arrangements carried a
        # persistence identity unpickle without epoch/seg-id state; mint a
        # fresh epoch (stale same-name files cannot exist for it) and
        # re-id any legacy segments so manifest_of works after restore
        self.__dict__.update(state)
        if "epoch" not in state:
            self.epoch = os.urandom(6).hex()
        if "_next_seg_id" not in state:
            self._next_seg_id = 0
        for seg in self.segments:
            if getattr(seg, "seg_id", -1) < 0:
                seg.seg_id = self._alloc_seg_id()
            elif seg.seg_id >= self._next_seg_id:
                self._next_seg_id = seg.seg_id + 1

    def stage(
        self,
        jks: np.ndarray,
        keys: np.ndarray,
        diffs: np.ndarray,
        cols: Sequence[np.ndarray],
        *,
        jk_order: np.ndarray | None = None,
        mix_sorted: np.ndarray | None = None,
        clean: bool | None = None,
    ) -> tuple | None:
        """Build (but do not apply) a staged delta entry — everything
        that can allocate/raise happens here, so a caller updating TWO
        arrangements can stage both and then ``commit`` both without a
        failure window between the state mutations.
        ``jk_order``/``mix_sorted``/``clean`` let the caller donate work
        it already did this tick (the join exec sorts and fingerprints
        the delta anyway)."""
        if not len(jks):
            return None
        return (
            np.ascontiguousarray(jks, dtype=np.uint64),
            np.ascontiguousarray(keys, dtype=np.uint64),
            np.ascontiguousarray(diffs, dtype=np.int64),
            list(cols),
            jk_order,
            mix_sorted,
            clean,
            int((np.asarray(diffs) < 0).sum()),
        )

    def commit(self, staged: tuple | None) -> None:
        """Apply a ``stage``d entry: pure list/int bookkeeping."""
        if staged is None:
            return
        self._staged.append(staged[:7])
        self._entries += len(staged[0])
        self._neg_entries += staged[7]

    def append(
        self,
        jks: np.ndarray,
        keys: np.ndarray,
        diffs: np.ndarray,
        cols: Sequence[np.ndarray],
        *,
        jk_order: np.ndarray | None = None,
        mix_sorted: np.ndarray | None = None,
        clean: bool | None = None,
    ) -> None:
        """Stage + commit a delta batch in one step."""
        self.commit(
            self.stage(
                jks, keys, diffs, cols,
                jk_order=jk_order, mix_sorted=mix_sorted, clean=clean,
            )
        )

    def next_age(self) -> int:
        """First age any not-yet-appended entry would get — lets callers
        overlay a pending delta on probed state with consistent ordering."""
        return self._next_age + sum(len(s[0]) for s in self._staged)

    def _alloc_seg_id(self) -> int:
        sid = self._next_seg_id
        self._next_seg_id += 1
        return sid

    def seal(self) -> None:
        """Fold staged deltas into immutable segments now (probes do this
        lazily) — the persistence layer calls it so a snapshot manifest
        names only sealed, serializable segments."""
        self._seal()

    @classmethod
    def restore(
        cls,
        n_cols: int,
        segments: list[_Segment],
        *,
        epoch: str,
        next_age: int,
        next_seg_id: int,
        neg_entries: int = 0,
        max_segments: int | None = None,
        compact_ratio: float | None = None,
    ) -> "Arrangement":
        """Rebuild an arrangement from previously sealed segments (the
        mmap recovery path, persistence/segments.py). The epoch and the
        seg-id counter continue from the snapshot so future segment files
        never reuse a persisted name."""
        arr = cls(
            n_cols, max_segments=max_segments, compact_ratio=compact_ratio
        )
        arr.segments = list(segments)
        arr.epoch = epoch
        arr._next_age = int(next_age)
        arr._next_seg_id = int(next_seg_id)
        arr._entries = int(sum(len(s) for s in segments))
        arr._neg_entries = int(neg_entries)
        return arr

    def _seal(self) -> None:
        if self._staged:
            # pop as we go: if sealing batch k raises (allocation failure
            # mid-merge), batches 0..k-1 are committed to segments and
            # k.. remain staged — a retry (or the exception-fallback's
            # materialization) never seals the same entries twice
            while self._staged:
                jks, keys, diffs, cols, order, mix_sorted, clean = (
                    self._staged.pop(0)
                )
                n = len(jks)
                # ages reflect original (insertion) order
                ages = np.arange(
                    self._next_age, self._next_age + n, dtype=np.int64
                )
                self._next_age += n
                if order is None:
                    order = np.argsort(jks, kind="stable")
                if mix_sorted is None:
                    mix_sorted = np.sort(mix_keys(jks, keys))
                if clean is None:
                    clean = bool((diffs > 0).all()) and not bool(
                        (mix_sorted[1:] == mix_sorted[:-1]).any()
                    )
                self.segments.append(
                    _Segment(
                        jks[order],
                        keys[order],
                        diffs[order],
                        ages[order],
                        [np.asarray(c)[order] for c in cols],
                        mix_sorted,
                        clean,
                        self._alloc_seg_id(),
                    )
                )
                # geometric merge schedule: fold the newest segment into
                # its neighbor while they are within 4x in size — segment
                # count stays ~log4 of the arrangement (fewer probe
                # searchsorteds) and each entry is re-merged O(log n)
                # times over the arrangement's life
                while (
                    len(self.segments) >= 2
                    and len(self.segments[-2]) <= 4 * len(self.segments[-1])
                ):
                    self._merge_last_two()
            while len(self.segments) > self.max_segments:
                self._merge_last_two()
        if (
            self.segments
            and self._neg_entries
            and self._neg_entries >= self.compact_ratio * self._entries
        ):
            self.compact()

    def _merge_last_two(self) -> None:
        """Entry-preserving merge of the two newest (age-adjacent)
        segments: two sorted runs combine with searchsorted + scatter.
        No consolidation happens here: collapsing a partial history slice
        could lose last-positive values (see consolidate_entries)."""
        a, b = self.segments[-2], self.segments[-1]
        idx_a, idx_b = _merge_indices(a.jks, b.jks)
        mix_sorted = merge_sorted(a.mix_sorted, b.mix_sorted)
        clean = (
            a.clean
            and b.clean
            and not bool((mix_sorted[1:] == mix_sorted[:-1]).any())
        )
        merged = _Segment(
            _scatter_merge(idx_a, idx_b, a.jks, b.jks),
            _scatter_merge(idx_a, idx_b, a.keys, b.keys),
            _scatter_merge(idx_a, idx_b, a.diffs, b.diffs),
            _scatter_merge(idx_a, idx_b, a.ages, b.ages),
            [
                _scatter_merge(idx_a, idx_b, ca, cb)
                for ca, cb in zip(a.cols, b.cols)
            ],
            mix_sorted,
            clean,
            self._alloc_seg_id(),
        )
        self.segments[-2:] = [merged]
        self.merges += 1

    def compact(self) -> None:
        """Rewrite the full history as one consolidated segment."""
        rows = self._consolidate_all()
        m = len(rows)
        # rows are sorted by (jk, age); re-aging 0..m-1 preserves relative
        # emission order and keeps future ages strictly larger
        mix_sorted = np.sort(mix_keys(rows.jk, rows.key))
        seg = _Segment(
            rows.jk,
            rows.key,
            rows.count,
            np.arange(m, dtype=np.int64),
            rows.cols,
            mix_sorted,
            bool((rows.count > 0).all()),
            self._alloc_seg_id(),
        )
        self.segments = [seg] if m else []
        self._next_age = m
        self._entries = m
        self._neg_entries = 0
        self.compactions += 1

    def _consolidate_all(self) -> Rows:
        segs = self.segments
        if not segs:
            return Rows.empty(self.n_cols)
        return consolidate_entries(
            np.concatenate([s.jks for s in segs]),
            np.concatenate([s.keys for s in segs]),
            np.concatenate([s.diffs for s in segs]),
            np.concatenate([s.ages for s in segs]),
            [
                concat_columns([s.cols[i] for s in segs])
                for i in range(self.n_cols)
            ],
        )

    def probe(self, qjks: np.ndarray) -> Rows:
        """Current state for a set of join keys (sorted unique uint64):
        gathers every entry whose jk is in ``qjks`` across all segments
        (one searchsorted pair per segment) and consolidates — the
        delta-join's index lookup.  Gathers that are provably clean (one
        clean segment, or no duplicate pairs and insert-only weights
        across the gathered set) skip consolidation."""
        self._seal()
        if not len(qjks) or not self.segments:
            return Rows.empty(self.n_cols)
        hits: list[tuple[_Segment, np.ndarray]] = []
        for seg in self.segments:
            lo = np.searchsorted(seg.jks, qjks, "left")
            hi = np.searchsorted(seg.jks, qjks, "right")
            counts = hi - lo
            if counts.any():
                hits.append((seg, expand_ranges(lo, counts)))
        if not hits:
            return Rows.empty(self.n_cols)
        if len(hits) == 1:
            seg, si = hits[0]
            rows = Rows(
                seg.jks[si],
                seg.keys[si],
                seg.diffs[si],
                seg.ages[si],
                [c[si] for c in seg.cols],
            )
            if seg.clean:
                return rows  # ranges of a clean segment: already state
            return consolidate_entries(
                rows.jk, rows.key, rows.count, rows.age, rows.cols
            )
        jks_g = np.concatenate([s.jks[si] for s, si in hits])
        keys_g = np.concatenate([s.keys[si] for s, si in hits])
        diffs_g = np.concatenate([s.diffs[si] for s, si in hits])
        ages_g = np.concatenate([s.ages[si] for s, si in hits])
        cols_g = [
            concat_columns([s.cols[i][si] for s, si in hits])
            for i in range(self.n_cols)
        ]
        mix_g = mix_keys(jks_g, keys_g)
        if (
            len(np.unique(mix_g)) == len(mix_g)
            and bool((diffs_g > 0).all())
        ):
            # no duplicate (jk, key) pairs and insert-only: entries ARE
            # the state; one stable argsort restores (jk, age) order
            # (segment gathers concatenate in age order)
            order = np.argsort(jks_g, kind="stable")
            return Rows(
                jks_g[order],
                keys_g[order],
                diffs_g[order],
                ages_g[order],
                [c[order] for c in cols_g],
            )
        return consolidate_mixed(
            jks_g, keys_g, diffs_g, ages_g, cols_g, mix_g
        )

    def overlaps(self, mixes: np.ndarray) -> bool:
        """Whether any of the given (jk, key) fingerprints matches a
        stored entry — lets the join skip probing a side entirely when a
        delta can only create brand-new rows (no collision means no
        existing entry's state can change)."""
        self._seal()
        for seg in self.segments:
            if sorted_member(mixes, seg.mix_sorted).any():
                return True
        return False

    def entries(self) -> Rows:
        """Full consolidated state (rowwise-fallback materialization and
        introspection)."""
        self._seal()
        return self._consolidate_all()

    def segment_sizes(self) -> list[int]:
        return [len(s) for s in self.segments] + [
            len(s[0]) for s in self._staged
        ]
