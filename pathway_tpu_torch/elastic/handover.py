"""Own copy of ``pathway_tpu/elastic/handover.py``: the map files are the
reference's JSON, so either package reads the other's.

Two-phase handover — freeze, move, commit the new ownership map.

The resharding contract every plane shares:

1. **Freeze** — the migrating topology stops mutating at a tick
   boundary (the mesh plane stops the supervised group at a lockstep
   commit point; the serving plane's writer holds its shard split; the
   generation plane snapshots at a decode-step boundary).  The durable
   committed ownership map stays the OLD one.
2. **Transfer** — the planner's moved key ranges ship via the
   SegmentFerry (or O(mmap) store re-partition when src and dst share
   a filesystem).  A death anywhere in this phase leaves the old map
   committed: restart simply serves the old topology (rollback = do
   nothing), and a retried transfer resumes content-addressed.
3. **Commit** — the new map is published atomically under a BUMPED
   incarnation.  Every consumer that fences by incarnation today
   (PWRP2 subacks, supervisor restarts, Fault Forge directives) fences
   zombies of the old topology for free: a writer/rank still speaking
   the pre-reshard map presents a lower incarnation and is rejected.
4. **Unfreeze** — the new topology resumes from the moved state with
   zero replay.

``OwnershipMap`` is the durable artifact; ``TwoPhaseHandover`` drives
the phases over a directory (the persistence-store root of the plane
being resharded).
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass

_COMMITTED = "ownership.json"
_TRANSITION = "ownership.next.json"


@dataclass(frozen=True)
class OwnershipMap:
    """The committed shard topology of one plane: who owns the jk-hash
    key space, under which fencing incarnation."""

    n_shards: int
    incarnation: int
    status: str = "committed"  # committed | transition

    def to_json(self) -> str:
        return json.dumps(asdict(self), separators=(",", ":"))


def _map_path(root: str, name: str) -> str:
    return os.path.join(root, "reshard", name)


def load_ownership(root: str) -> OwnershipMap | None:
    """The last COMMITTED ownership map under ``root`` (transition
    markers are invisible here by design — a torn handover must leave
    readers on the old map)."""
    path = _map_path(root, _COMMITTED)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    return OwnershipMap(
        int(doc["n_shards"]), int(doc["incarnation"]), "committed"
    )


class HandoverError(RuntimeError):
    pass


class TwoPhaseHandover:
    """Drives one reshard of one plane rooted at ``root``.

    ``begin(n_new)`` writes the transition marker (phase 1 is the
    caller's freeze — this records intent durably so an operator can
    see a reshard was in flight); ``commit()`` atomically replaces the
    committed map with the new topology under a bumped incarnation;
    ``rollback()`` removes the marker and leaves the old map untouched.
    A crash at ANY point before ``commit``'s atomic rename leaves the
    old committed map in force."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "reshard"), exist_ok=True)

    @property
    def committed(self) -> OwnershipMap | None:
        return load_ownership(self.root)

    @property
    def in_transition(self) -> bool:
        return os.path.exists(_map_path(self.root, _TRANSITION))

    def ensure_committed(self, n_shards: int) -> OwnershipMap:
        """Bootstrap: commit the CURRENT topology if no map exists yet
        (a plane that has never resharded is implicitly committed at
        its boot shard count, incarnation 0)."""
        cur = self.committed
        if cur is not None:
            return cur
        m = OwnershipMap(int(n_shards), 0)
        self._write(_COMMITTED, m)
        return m

    def begin(self, n_new: int) -> OwnershipMap:
        cur = self.committed
        if cur is None:
            raise HandoverError(
                "no committed ownership map — call ensure_committed() "
                "with the current topology first"
            )
        if self.in_transition:
            raise HandoverError(
                "a handover is already in transition — commit or roll "
                "it back first"
            )
        nxt = OwnershipMap(int(n_new), cur.incarnation + 1, "transition")
        self._write(_TRANSITION, nxt)
        return nxt

    def commit(self) -> OwnershipMap:
        path = _map_path(self.root, _TRANSITION)
        if not os.path.exists(path):
            raise HandoverError("no handover in transition to commit")
        with open(path) as f:
            doc = json.load(f)
        m = OwnershipMap(int(doc["n_shards"]), int(doc["incarnation"]))
        # the commit point: one atomic rename — before it the old map
        # rules, after it the new one does, never anything in between
        os.replace(path, _map_path(self.root, _COMMITTED))
        return m

    def rollback(self) -> None:
        try:
            os.unlink(_map_path(self.root, _TRANSITION))
        except FileNotFoundError:
            pass

    def _write(self, name: str, m: OwnershipMap) -> None:
        path = _map_path(self.root, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(m.to_json())
        os.replace(tmp, path)
