"""Own copy of ``pathway_tpu/elastic/planner.py`` (numpy over the port's
``Arrangement`` and ``shard_of``). The Graph Doctor reads its static
predicates (``exec_class_for``, ``reshard_capable``,
``monolithic_state_nodes``); the resizes that consume the plan are the
segment ferry (``ferry.py``) and ``reshard_stores`` (``mesh.py``).

ReshardPlanner — the hash-ring delta of an N→M topology change.

Ownership is the jk-hash partition every tier already routes by
(engine/sharded.py ``shard_of``: ``(jk & SHARD_MASK) % n_shards``), so
the unit of movement is a *slot* — one residue of the 65536-value
low-16-bit key space.  An N→M change moves exactly the slots whose
``% N`` and ``% M`` owners differ; everything else stays put.  The plan
is the minimal set of (src, dst, slots) key-range moves, and
:func:`split_arrangement` / :func:`repartition_arrangements` realize it
on arrangement state: consolidated rows re-split by their jk's new
owner, moved ranges encoded as fresh sealed segments (the segment codec)
ready for the ferry, unmoved ranges never re-encoded for the wire.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

from pathway_tpu_torch.engine.arrangement import Arrangement
from pathway_tpu_torch.engine.sharded import SHARD_MASK, shard_of

SLOT_SPACE = SHARD_MASK + 1  # 65536 hash slots — the routing residue space


def slot_owners(n_shards: int) -> np.ndarray:
    """owner shard of every slot under an ``n_shards`` topology."""
    return (
        np.arange(SLOT_SPACE, dtype=np.uint64) % np.uint64(n_shards)
    ).astype(np.int32)


@dataclass(frozen=True)
class KeyRangeMove:
    """One key range changing hands: the slots moving src → dst."""

    src: int
    dst: int
    n_slots: int


@dataclass(frozen=True)
class ReshardPlan:
    """The minimal moves of an N→M change (slots whose owner differs)."""

    n_old: int
    n_new: int
    moves: tuple[KeyRangeMove, ...]

    @property
    def moved_slots(self) -> int:
        return sum(m.n_slots for m in self.moves)

    @property
    def moved_fraction(self) -> float:
        return self.moved_slots / SLOT_SPACE


def plan_reshard(n_old: int, n_new: int) -> ReshardPlan:
    """Compute the hash-ring delta: for every (src, dst) pair with
    src != dst, how many slots move.  ``moved_fraction`` is the share
    of the key space (and so, for uniform keys, of state bytes) the
    ferry must carry — never the full corpus unless n_old == 1."""
    if n_old < 1 or n_new < 1:
        raise ValueError(
            f"shard counts must be >= 1 (got {n_old} -> {n_new})"
        )
    old = slot_owners(n_old)
    new = slot_owners(n_new)
    moving = old != new
    moves: dict[tuple[int, int], int] = {}
    for s, d in zip(old[moving].tolist(), new[moving].tolist()):
        moves[(s, d)] = moves.get((s, d), 0) + 1
    return ReshardPlan(
        n_old,
        n_new,
        tuple(
            KeyRangeMove(s, d, n)
            for (s, d), n in sorted(moves.items())
        ),
    )


def moved_fraction(n_old: int, n_new: int) -> float:
    return plan_reshard(n_old, n_new).moved_fraction


# --- arrangement-level re-partition -----------------------------------------


def _rows_to_arrangement(rows, idx: np.ndarray, n_cols: int) -> Arrangement:
    """Fresh sealed arrangement holding ``rows.take(idx)``, appended in
    age order so the new arrangement's emission order preserves the
    source's insertion order (GroupBy restore, dedup acceptance and
    last-write-wins state all read it)."""
    out = Arrangement(n_cols)
    if len(idx):
        sub = rows.take(idx[np.argsort(rows.age[idx], kind="stable")])
        out.append(sub.jk, sub.key, sub.count, sub.cols)
        out.seal()
    return out


def split_arrangement(
    arr: Arrangement, n_new: int
) -> list[Arrangement]:
    """Split one arrangement's consolidated state into one arrangement
    per new shard, rows routed by ``shard_of(jk, n_new)``."""
    rows = arr.entries()
    if not len(rows):
        return [Arrangement(arr.n_cols) for _ in range(n_new)]
    dest = shard_of(np.asarray(rows.jk, dtype=np.uint64), n_new)
    return [
        _rows_to_arrangement(
            rows, np.nonzero(dest == s)[0], arr.n_cols
        )
        for s in range(n_new)
    ]


def repartition_arrangements(
    per_shard: list[dict[str, Arrangement]], n_new: int
) -> tuple[list[dict[str, Arrangement]], dict]:
    """Re-partition N shards' named arrangements into M shards' — the
    core state move.  Rows of the same arrangement NAME merge across
    the old shards, then split by their jk's new owner; relative age
    order within each (old shard, name) is preserved and old shards are
    concatenated in shard order (disjoint jk ranges per old shard make
    the cross-shard interleave irrelevant to consolidated state).

    Returns (new per-shard dicts, stats) where stats counts total vs
    MOVED rows — moved = rows whose old owner index differs from their
    new one, the "bytes ferried ≈ moved key ranges only" evidence."""
    n_old = len(per_shard)
    names: list[str] = []
    for d in per_shard:
        for name in d:
            if name not in names:
                names.append(name)
    out: list[dict[str, Arrangement]] = [{} for _ in range(n_new)]
    total_rows = 0
    moved_rows = 0
    for name in names:
        parts = []  # (old_shard, Rows)
        n_cols = None
        for old_s, d in enumerate(per_shard):
            arr = d.get(name)
            if arr is None:
                continue
            n_cols = arr.n_cols
            rows = arr.entries()
            if len(rows):
                parts.append((old_s, rows))
        if n_cols is None:
            continue
        per_dst_chunks: list[list] = [[] for _ in range(n_new)]
        for old_s, rows in parts:
            total_rows += len(rows)
            dest = shard_of(np.asarray(rows.jk, dtype=np.uint64), n_new)
            # a row is "moved" when its new owner differs from the old
            # shard that held it — exactly the slot plan's owner change
            moved_rows += int(np.count_nonzero(dest != old_s))
            for dst in range(n_new):
                idx = np.nonzero(dest == dst)[0]
                if not len(idx):
                    continue
                sub = rows.take(
                    idx[np.argsort(rows.age[idx], kind="stable")]
                )
                per_dst_chunks[dst].append(sub)
        for dst in range(n_new):
            arr = Arrangement(n_cols)
            for sub in per_dst_chunks[dst]:
                arr.append(sub.jk, sub.key, sub.count, sub.cols)
            arr.seal()
            out[dst][name] = arr
    return out, {
        "total_rows": total_rows,
        "moved_rows": moved_rows,
        "moved_row_fraction": (
            moved_rows / total_rows if total_rows else 0.0
        ),
    }


def repartition_shard_states(
    residuals: list[dict],
    per_shard_arrs: list[dict[str, Arrangement]],
    n_new: int,
) -> tuple[list[dict], list[dict[str, Arrangement]], dict]:
    """The ``_ShardedExec`` restore transform: an N-shard snapshot's
    (per-shard residuals, per-shard arrangements) re-partitioned for an
    M-shard layout.  Keyed state lives in the arrangements (every
    arranged exec rebuilds its dicts FROM them on load); residuals
    carry only per-exec config/watermark scalars identical across
    shards, so each new shard receives a deep copy of shard 0's."""
    new_arrs, stats = repartition_arrangements(per_shard_arrs, n_new)
    base = residuals[0] if residuals else {}
    new_residuals = [copy.deepcopy(base) for _ in range(n_new)]
    return new_residuals, new_arrs, stats


# --- reshard capability (Graph Doctor support) ------------------------------


def exec_class_for(node) -> type | None:
    """The exec class a node builds, resolved by the ``FooNode`` →
    ``FooExec`` naming convention inside the node's own module (every
    engine node follows it); None when the convention does not
    resolve."""
    import sys

    mod = sys.modules.get(type(node).__module__)
    name = type(node).__name__
    if mod is None or not name.endswith("Node"):
        return None
    cls = getattr(mod, name[:-4] + "Exec", None)
    return cls if isinstance(cls, type) else None


def reshard_capable(node) -> bool | None:
    """Whether this node's exec snapshots as arrangements (and so can
    ride a segment handoff instead of pinning the group to log-replay
    resizes).  None = unknown (no exec class resolved)."""
    from pathway_tpu_torch.engine.nodes import NodeExec

    cls = exec_class_for(node)
    if cls is None:
        return None
    fn = getattr(cls, "arranged_state", None)
    return fn is not None and fn is not NodeExec.arranged_state


def monolithic_state_nodes(nodes) -> list[tuple]:
    """[(node, exec class name)] for every stateful node whose exec
    provably lacks ``arranged_state`` — the operators that pin a Shard
    Flux resize to log-replay (ROADMAP 5c). The elastic plane's
    metadata hook for static verification: the Plane Doctor's
    snapshot-coverage rule (analysis/plane.py) names these before
    anyone attempts a resize against them."""
    out = []
    for node in nodes:
        if not getattr(node, "is_stateful", False):
            continue
        if reshard_capable(node) is not False:
            continue
        cls = exec_class_for(node)
        out.append((node, cls.__name__ if cls else type(node).__name__))
    return out
