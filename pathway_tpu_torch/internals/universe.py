"""The port's own copy of ``pathway_tpu/internals/universe.py``. Universes: identity of key sets
(reference: python/pathway/internals/universe.py + universe_solver.py).

Tracked structurally: operations that keep keys share the Universe object;
subset/superset promises are recorded but enforcement is best-effort (the
reference solves these with a constraint solver; here they gate the same API
surface)."""

from __future__ import annotations

import itertools

_counter = itertools.count()


class Universe:
    __slots__ = ("id", "parent", "_disjoint")

    def __init__(self, parent: "Universe | None" = None):
        self.id = next(_counter)
        self.parent = parent
        self._disjoint: set[int] = set()  # ids promised disjoint from this

    def promise_disjoint(self, other: "Universe") -> None:
        self._disjoint.add(other.id)
        other._disjoint.add(self.id)

    def is_disjoint_from(self, other: "Universe") -> bool:
        # a subset of a promised-disjoint universe is still disjoint:
        # check every ancestor pair
        a: Universe | None = self
        while a is not None:
            b: Universe | None = other
            while b is not None:
                if b.id in a._disjoint:
                    return True
                b = b.parent
            a = a.parent
        return False

    def subset(self) -> "Universe":
        return Universe(parent=self)

    def is_subset_of(self, other: "Universe") -> bool:
        u: Universe | None = self
        while u is not None:
            if u is other:
                return True
            u = u.parent
        return False

    def __repr__(self) -> str:
        return f"U{self.id}"
