"""The port's own copy of ``pathway_tpu/universes.py``, whole.

pw.universes — universe relationship promises (reference:
python/pathway/universes.py). Metadata-only assertions letting the user
vouch for key-set relationships the engine cannot deduce; the microbatch
engine verifies alignment at run time, so these are advisory exactly as
in the reference's in-place semantics."""

from __future__ import annotations

from typing import Any


def promise_are_pairwise_disjoint(self: Any, *others: Any) -> None:
    """Assert the universes of all given tables are pairwise disjoint."""
    for other in others:
        self.promise_universes_are_disjoint(other)


def promise_are_equal(*tables: Any) -> None:
    """Assert all given tables share one universe (reference:
    universes.promise_are_equal)."""
    if not tables:
        return
    first = tables[0]
    for other in tables[1:]:
        other.promise_universe_is_equal_to(first)


def promise_is_subset_of(self: Any, *others: Any) -> None:
    """Assert self's universe is a subset of each other's."""
    for other in others:
        self.promise_universe_is_subset_of(other)
