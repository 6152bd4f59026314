"""Paged KV cache as framework state — counterpart of
``pathway_tpu/generate/kv_cache.py``.

The decode kernel reads KV through a block pool + page tables
(``ops/paged_attention.py``); this module owns the other half of the paged
cache story: allocation accounting and durability.

* :class:`PagePool` — host-side free-list over the physical pages of the
  device pools. Page 0 is reserved as the null page (padded batch slots
  write there), so a pool of ``n_pages`` serves ``n_pages - 1`` allocatable
  pages.

* :class:`KvLedger` — the generation state mirrored into arrangement
  ledgers: every touched page is a retract+insert of one row, so the
  content-addressed segment snapshot writes only churned state and a
  kill/restart rebuilds the pools byte-identically from the newest
  manifest. Two arrangements, because their value columns want different
  encodings:

  - ``pages``: one row per (sequence, logical page) holding the page's K
    and V arrays ``[L, H, P, Dp]`` float32 (uniform ndarrays -> the segment
    codec stacks them as raw buffers, mmap-recoverable) plus an int64
    identity column;
  - ``seqs``: one row per in-flight sequence holding its resumable metadata
    dict (Python scalars and lists only -> pickled per segment).

  ``snapshot(dir)`` is atomic (segment files first, manifest rename last)
  and incremental (a segment id already on disk is never rewritten;
  superseded segment files are removed only after the manifest commit).
  ``restore(dir)`` mmap-loads the manifest's segments. The row keys, the
  segment file names (``segs/{name}-{epoch}-{seg_id}.seg``) and
  ``manifest.json`` are the reference's, so a snapshot written by either
  package restores in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Iterable

import numpy as np

from pathway_tpu_torch.engine.arrangement import Arrangement
from pathway_tpu_torch.persistence.segments import (
    load_arrangement,
    manifest_of,
    segment_to_bytes,
)

NULL_PAGE = 0

_MANIFEST = "manifest.json"
_SEG_DIR = "segs"


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


def _row_key(*parts: Any) -> int:
    h = hashlib.blake2b(
        ":".join(str(p) for p in parts).encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "little")


def seq_jk(seq_id: int) -> int:
    """A sequence's ledger join key — the jk every row the sequence
    owns (pages + metadata) groups under, and therefore the ownership
    hash the elastic resharder routes the sequence by
    (elastic/kv.py ``seq_owner``): one agreed fact, like every other
    plane's jk."""
    return _row_key("s", seq_id)


class KvLedger:
    """Arrangement mirror of the in-flight generation state."""

    def __init__(self):
        # pages: cols = [k_page, v_page, ident(int64[2]: seq, page_idx)]
        self.pages = Arrangement(3)
        # seqs: cols = [meta dict]
        self.seqs = Arrangement(1)
        self._shadow_pages: dict[tuple[int, int], tuple] = {}
        self._shadow_seqs: dict[int, dict] = {}
        self._lock = threading.Lock()
        # segment files already present in the snapshot dir, keyed
        # (arrangement name, epoch, seg_id) — primed from the restored
        # manifest so a continued run never rewrites a persisted file
        self._written: set[tuple[str, str, int]] = set()

    # --- mirror writes ----------------------------------------------------

    def _append(
        self, arr: Arrangement, jk: int, key: int, diff: int, cols: list
    ) -> None:
        def obj_col(c: Any) -> np.ndarray:
            # np.array([ndarray], object) would EXPLODE the payload
            # into an object array of scalars — build-and-assign keeps
            # the array a single element
            col = np.empty(1, object)
            col[0] = c
            return col

        arr.append(
            np.array([jk], np.uint64),
            np.array([key], np.uint64),
            np.array([diff], np.int64),
            [obj_col(c) for c in cols],
        )

    def put_page(
        self,
        seq_id: int,
        page_idx: int,
        k_page: np.ndarray,
        v_page: np.ndarray,
    ) -> None:
        """Mirror one (sequence, logical page) worth of KV state:
        retract the previous version, insert the new one."""
        jk = np.uint64(_row_key("s", seq_id))
        key = np.uint64(_row_key("p", seq_id, page_idx))
        ident = np.array([seq_id, page_idx], np.int64)
        with self._lock:
            old = self._shadow_pages.get((seq_id, page_idx))
            if old is not None:
                self._append(self.pages, jk, key, -1, list(old))
            cols = (k_page, v_page, ident)
            self._append(self.pages, jk, key, +1, list(cols))
            self._shadow_pages[(seq_id, page_idx)] = cols

    def put_seq(self, seq_id: int, meta: dict) -> None:
        jk = np.uint64(_row_key("s", seq_id))
        key = np.uint64(_row_key("m", seq_id))
        with self._lock:
            old = self._shadow_seqs.get(seq_id)
            if old is not None:
                self._append(self.seqs, jk, key, -1, [old])
            self._append(self.seqs, jk, key, +1, [meta])
            self._shadow_seqs[seq_id] = meta

    def drop_seq(self, seq_id: int) -> None:
        """Retract everything a finished/dropped sequence owns — its
        pages leave the ledger the moment the pool reclaims them."""
        jk = np.uint64(_row_key("s", seq_id))
        with self._lock:
            meta = self._shadow_seqs.pop(seq_id, None)
            if meta is not None:
                self._append(
                    self.seqs, jk, np.uint64(_row_key("m", seq_id)), -1,
                    [meta],
                )
            doomed = [k for k in self._shadow_pages if k[0] == seq_id]
            for k in doomed:
                cols = self._shadow_pages.pop(k)
                self._append(
                    self.pages,
                    jk,
                    np.uint64(_row_key("p", k[0], k[1])),
                    -1,
                    list(cols),
                )

    def resident_bytes(self) -> dict[str, int]:
        """Memory-ledger parts for Tick Scope: the two arrangements
        (whose object columns hold the SAME ndarrays the shadow dict
        points at — the +1 entry shares storage with ``_shadow_pages``,
        only retract/insert churn adds copies) and the host mirror
        counted by payload bytes."""
        with self._lock:
            mirror = 0
            for k_page, v_page, ident in self._shadow_pages.values():
                mirror += (
                    int(k_page.nbytes) + int(v_page.nbytes)
                    + int(ident.nbytes)
                )
        return {
            "pages_arrangement": self.pages.resident_bytes(),
            "seqs_arrangement": self.seqs.resident_bytes(),
            "host_mirror": mirror,
        }

    def live_seqs(self) -> dict[int, dict]:
        with self._lock:
            return dict(self._shadow_seqs)

    def live_pages(self) -> dict[tuple[int, int], tuple]:
        with self._lock:
            return dict(self._shadow_pages)

    # --- snapshot / restore ----------------------------------------------

    @staticmethod
    def _seg_path(root: str, name: str, epoch: str, seg_id: int) -> str:
        return os.path.join(root, _SEG_DIR, f"{name}-{epoch}-{seg_id}.seg")

    def snapshot(self, root: str) -> dict:
        """Write an incremental snapshot under ``root``; returns
        ``{"bytes_written": ..., "segments_written": ...}``.  Crash-safe
        at every point: segment files land first (content-addressed by
        (epoch, seg_id) — ids already on disk are skipped), the
        manifest commits by atomic rename, and files the new manifest
        no longer references are unlinked only after the rename."""
        os.makedirs(os.path.join(root, _SEG_DIR), exist_ok=True)
        with self._lock:
            manifests = {
                "pages": manifest_of(self.pages),
                "seqs": manifest_of(self.seqs),
            }
            arrs = {"pages": self.pages, "seqs": self.seqs}
            written_bytes = 0
            written_segs = 0
            referenced: set[str] = set()
            for name, arr in arrs.items():
                for seg in arr.segments:
                    path = self._seg_path(root, name, arr.epoch, seg.seg_id)
                    referenced.add(os.path.basename(path))
                    tag = (name, arr.epoch, seg.seg_id)
                    if tag in self._written and os.path.exists(path):
                        continue
                    blob = segment_to_bytes(seg)
                    tmp = path + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(blob)
                    os.replace(tmp, path)
                    self._written.add(tag)
                    written_bytes += len(blob)
                    written_segs += 1
            doc = json.dumps({"v": 1, "arrangements": manifests})
            tmp = os.path.join(root, _MANIFEST + ".tmp")
            with open(tmp, "w") as f:
                f.write(doc)
            os.replace(tmp, os.path.join(root, _MANIFEST))
            # GC: only after the manifest no longer names them
            seg_dir = os.path.join(root, _SEG_DIR)
            for fname in os.listdir(seg_dir):
                if fname.endswith(".seg") and fname not in referenced:
                    try:
                        os.unlink(os.path.join(seg_dir, fname))
                    except OSError:
                        pass
            self._written = {
                (n, a.epoch, s.seg_id)
                for n, a in arrs.items()
                for s in a.segments
            }
        return {
            "bytes_written": written_bytes,
            "segments_written": written_segs,
        }

    @classmethod
    def restore(cls, root: str) -> "KvLedger | None":
        """Rebuild the ledger (arrangements + shadow state) from the
        newest committed snapshot; None when no manifest exists."""
        mpath = os.path.join(root, _MANIFEST)
        if not os.path.exists(mpath):
            return None
        with open(mpath) as f:
            doc = json.load(f)
        led = cls()

        def fetch(name: str, epoch: str):
            def _fetch(seg_id: int):
                path = cls._seg_path(root, name, epoch, seg_id)
                if not os.path.exists(path):
                    return None
                import mmap

                with open(path, "rb") as f:
                    return mmap.mmap(
                        f.fileno(), 0, access=mmap.ACCESS_READ
                    )

            return _fetch

        for name in ("pages", "seqs"):
            man = doc["arrangements"][name]
            arr = load_arrangement(man, fetch(name, man["epoch"]))
            setattr(led, name, arr)
            led._written.update(
                (name, man["epoch"], int(d["id"]))
                for d in man["segments"]
            )
        rows = led.pages.entries()
        for i in range(len(rows)):
            if rows.count[i] <= 0:
                continue
            k_page = rows.cols[0][i]
            v_page = rows.cols[1][i]
            seq_id, page_idx = (int(x) for x in rows.cols[2][i])
            led._shadow_pages[(seq_id, page_idx)] = (
                np.array(k_page),
                np.array(v_page),
                np.array([seq_id, page_idx], np.int64),
            )
        rows = led.seqs.entries()
        for i in range(len(rows)):
            if rows.count[i] <= 0:
                continue
            meta = rows.cols[0][i]
            led._shadow_seqs[int(meta["seq_id"])] = dict(meta)
        return led
