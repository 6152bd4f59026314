"""Paged KV cache accounting — counterpart of
``pathway_tpu/generate/kv_cache.py``.

The decode kernel reads KV through a block pool + page tables
(``ops/paged_attention.py``); :class:`PagePool` is the host-side free-list
over the physical pages of those pools. Page 0 is reserved as the null page
(padded batch slots write there), so a pool of ``n_pages`` serves
``n_pages - 1`` allocatable pages.

``KvLedger`` (the generation state mirrored into arrangement ledgers and
snapshotted incrementally) is not ported yet: it needs the engine's
arrangement and the segment codec.
"""

from __future__ import annotations

import threading
from typing import Iterable

NULL_PAGE = 0


class PagePool:
    """Free-list accounting for the physical pages of the KV pools."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(
                f"page pool needs >= 2 pages (1 null + 1 usable), got "
                f"{n_pages}"
            )
        self.n_pages = int(n_pages)
        # a set: O(1) double-free membership check — a list scan made
        # bulk frees quadratic in the pool size on the decode thread
        self._free: set[int] = set(range(NULL_PAGE + 1, self.n_pages))
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - self.free_pages

    def occupancy(self) -> float:
        return self.in_use / self.capacity

    def try_alloc(self, n: int) -> list[int] | None:
        """n physical page ids, or None when the pool cannot cover them
        (never a partial grant — the caller either joins the batch with
        a full table or stays queued)."""
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                return None
            got = [self._free.pop() for _ in range(n)]
        return got

    def free(self, pages: Iterable[int]) -> None:
        with self._lock:
            for p in pages:
                p = int(p)
                if p == NULL_PAGE:
                    raise ValueError("cannot free the null page")
                if not (0 < p < self.n_pages):
                    raise ValueError(f"page {p} outside the pool")
                if p in self._free:
                    raise ValueError(f"double free of page {p}")
                self._free.add(p)
