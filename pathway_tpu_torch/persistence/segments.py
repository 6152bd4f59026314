"""Own copy of ``pathway_tpu/persistence/segments.py``: the same ``PWSEG01``
format and manifest keys, so a segment file written by either package loads
in the other.

Segment codec — the arrangement's stable on-disk form.

The differential-dataflow design the paper rides says *arranged
collections ARE the checkpoint* (reference: operator snapshots are
chunked dumps of arrangement batches, src/persistence/
operator_snapshot.rs:21-31): an arrangement's immutable sorted segments
(engine/arrangement.py) need only be retained, not re-encoded, for the
operator to be durable.  This module gives each sealed ``_Segment`` a
self-contained byte form and each ``Arrangement`` a tiny JSON manifest:

* ``segment_to_bytes`` — header JSON + 64-byte-aligned raw ndarray
  buffers.  Numeric/string/datetime columns serialize as their exact
  dtype bytes (no pickle); object columns of uniform ndarrays
  (embeddings) as one stacked raw block; anything else falls back to a
  per-column pickle.  The core index arrays (jk, rowkey, diff, age,
  fingerprint) are always raw u64/i64.
* ``segment_from_buffer`` — reconstructs the segment with zero-copy
  ``np.frombuffer`` views over the given buffer.  Hand it an mmap-backed
  memoryview (``BackendStore.get_buffer``) and recovery is O(page cache):
  column bytes fault in lazily as probes touch them.
* ``manifest_of`` / ``load_arrangement`` — the arrangement-level
  save/load pair.  A manifest names segment ids, not bytes; segment ids
  are immutable content addresses (arrangement.py ``_Segment.seg_id``),
  so the persistence glue writes only ids it has never stored — the
  incremental-checkpoint contract (bytes ∝ churn, not state size).
"""

from __future__ import annotations

import json
import pickle
from typing import Callable

import numpy as np

from pathway_tpu_torch.engine.arrangement import Arrangement, _Segment
from pathway_tpu_torch.engine.batch import _obj_column, uniform_element_spec

MAGIC = b"PWSEG01\n"
_ALIGN = 64

_CORE = (  # (attr, dtype) — fixed-layout index arrays of every segment
    ("jks", "<u8"),
    ("keys", "<u8"),
    ("diffs", "<i8"),
    ("ages", "<i8"),
    ("mix_sorted", "<u8"),
)


def _aligned(n: int) -> int:
    return n + (-n % _ALIGN)


def _encode_col(col: np.ndarray) -> tuple[dict, bytes]:
    col = np.asarray(col)
    if col.ndim == 1 and col.dtype != object and not col.dtype.hasobject:
        return (
            {"kind": "raw", "dtype": col.dtype.str},
            np.ascontiguousarray(col).tobytes(),
        )
    spec = uniform_element_spec(col) if col.dtype == object else None
    if spec is not None:
        dtype, shape = spec
        stacked = np.stack(list(col)) if len(col) else np.empty((0, *shape))
        return (
            {
                "kind": "stacked",
                "dtype": np.dtype(dtype).str,
                "shape": list(shape),
            },
            np.ascontiguousarray(stacked, dtype=dtype).tobytes(),
        )
    return (
        {"kind": "pickle"},
        pickle.dumps(col, protocol=pickle.HIGHEST_PROTOCOL),
    )


def segment_to_bytes(seg: _Segment) -> bytes:
    """Serialize one sealed segment; raw for everything numeric."""
    n = len(seg)
    sections: list[bytes] = []
    cursor = 0

    def add(data: bytes) -> tuple[int, int]:
        nonlocal cursor
        off = cursor
        sections.append(data)
        pad = -len(data) % _ALIGN
        if pad:
            sections.append(b"\x00" * pad)
        cursor = off + len(data) + pad
        return off, len(data)

    header: dict = {
        "v": 1,
        "id": int(seg.seg_id),
        "n": int(n),
        "clean": bool(seg.clean),
    }
    core = {}
    for attr, dtype in _CORE:
        arr = np.ascontiguousarray(getattr(seg, attr), dtype=dtype)
        off, nbytes = add(arr.tobytes())
        core[attr] = {"off": off, "nbytes": nbytes}
    header["core"] = core
    cols = []
    for col in seg.cols:
        desc, data = _encode_col(col)
        desc["off"], desc["nbytes"] = add(data)
        cols.append(desc)
    header["cols"] = cols
    hjson = json.dumps(header, separators=(",", ":")).encode()
    head = MAGIC + len(hjson).to_bytes(4, "little") + hjson
    head += b"\x00" * (-len(head) % _ALIGN)
    return head + b"".join(sections)


def _view(buf, base: int, sec: dict, dtype: str, n: int) -> np.ndarray:
    dt = np.dtype(dtype)
    return np.frombuffer(
        buf, dtype=dt, count=sec["nbytes"] // dt.itemsize, offset=base + sec["off"]
    )


def segment_from_buffer(buf) -> _Segment:
    """Reconstruct a segment as zero-copy views over ``buf`` (bytes or an
    mmap-backed memoryview; the arrays keep the buffer alive)."""
    mv = memoryview(buf)
    if bytes(mv[: len(MAGIC)]) != MAGIC:
        raise ValueError("not a PWSEG01 segment blob")
    hlen = int.from_bytes(bytes(mv[len(MAGIC) : len(MAGIC) + 4]), "little")
    hstart = len(MAGIC) + 4
    header = json.loads(bytes(mv[hstart : hstart + hlen]).decode())
    base = _aligned(hstart + hlen)
    n = int(header["n"])
    core = {
        attr: _view(mv, base, header["core"][attr], dtype, n)
        for attr, dtype in _CORE
    }
    cols: list[np.ndarray] = []
    for desc in header["cols"]:
        kind = desc["kind"]
        if kind == "raw":
            cols.append(_view(mv, base, desc, desc["dtype"], n))
        elif kind == "stacked":
            shape = tuple(desc["shape"])
            flat = _view(mv, base, desc, desc["dtype"], n)
            cols.append(_obj_column(list(flat.reshape((n, *shape)))))
        elif kind == "pickle":
            raw = bytes(mv[base + desc["off"] : base + desc["off"] + desc["nbytes"]])
            cols.append(pickle.loads(raw))
        else:  # a future format must fail loud, not half-load
            raise ValueError(f"unknown column kind {kind!r}")
    return _Segment(
        core["jks"],
        core["keys"],
        core["diffs"],
        core["ages"],
        cols,
        core["mix_sorted"],
        bool(header["clean"]),
        int(header["id"]),
    )


def manifest_of(arr: Arrangement) -> dict:
    """Seal staged deltas and describe the arrangement as a small JSON
    document naming segment ids — the only per-snapshot metadata the
    incremental checkpoint needs."""
    arr.seal()
    return {
        "v": 1,
        "epoch": arr.epoch,
        "n_cols": int(arr.n_cols),
        "next_age": int(arr._next_age),
        "next_seg_id": int(arr._next_seg_id),
        "neg_entries": int(arr._neg_entries),
        "segments": [
            {"id": int(s.seg_id), "n": len(s)} for s in arr.segments
        ],
    }


def load_arrangement(
    manifest: dict,
    fetch: Callable[[int], "memoryview | bytes | None"],
    *,
    max_segments: int | None = None,
    compact_ratio: float | None = None,
) -> Arrangement:
    """Rebuild an arrangement from a manifest; ``fetch(seg_id)`` returns
    the segment's buffer (mmap-backed when the store supports it) or
    None, which raises — a missing segment means the snapshot is torn and
    the caller must fall back to log replay."""
    segments: list[_Segment] = []
    for desc in manifest["segments"]:
        buf = fetch(int(desc["id"]))
        if buf is None:
            raise KeyError(f"segment {desc['id']} missing from store")
        seg = segment_from_buffer(buf)
        if seg.seg_id != int(desc["id"]) or len(seg) != int(desc["n"]):
            raise ValueError(
                f"segment {desc['id']} does not match its manifest entry "
                f"(got id={seg.seg_id} n={len(seg)})"
            )
        segments.append(seg)
    return Arrangement.restore(
        int(manifest["n_cols"]),
        segments,
        epoch=str(manifest["epoch"]),
        next_age=int(manifest["next_age"]),
        next_seg_id=int(manifest["next_seg_id"]),
        neg_entries=int(manifest.get("neg_entries", 0)),
        max_segments=max_segments,
        compact_ratio=compact_ratio,
    )
