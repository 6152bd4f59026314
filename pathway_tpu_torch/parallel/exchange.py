"""Ragged all-to-all row exchange over the mesh — the engine's Exchange pact;
own copy of ``pathway_tpu/parallel/exchange.py`` on torch devices.

The reference routes every record to ``key.shard() % n_workers``. Here each
source shard holds a contiguous slice of the rows on its own device
(``per = next_pow2(ceil(n / n_shards))`` rows, the reference's placement),
sorts them by destination with a stable sort, cuts them into destination
buckets with a ``bincount``, and every bucket moves to its destination
shard's device (a plain slice when both shards share a card). A
destination's block holds its rows by source shard, then in source order,
as the reference's ``lax.all_to_all`` leaves them.

Rows are typed columns; they travel as exact int32 bit patterns
(``pack_columns``/``unpack_columns``), so f64/i64/u64 survive bit for bit.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

_WORDS = {  # np dtype kind/itemsize -> number of int32 words
    ("f", 8): 2,
    ("i", 8): 2,
    ("u", 8): 2,
    ("f", 4): 1,
    ("i", 4): 1,
    ("u", 4): 1,
    ("b", 1): 1,
}


def packable(arr: np.ndarray) -> bool:
    return arr.ndim == 1 and (arr.dtype.kind, arr.dtype.itemsize) in _WORDS


def pack_columns(
    arrays: Sequence[np.ndarray],
) -> tuple[np.ndarray, list[np.dtype]]:
    """Bit-cast typed columns into one [N, W] int32 word matrix (exact)."""
    n = len(arrays[0])
    spec = [a.dtype for a in arrays]
    words = []
    for a in arrays:
        w = _WORDS[(a.dtype.kind, a.dtype.itemsize)]
        if a.dtype.kind == "b":
            col = a.astype(np.int32).reshape(n, 1)
        else:
            col = np.ascontiguousarray(a).view(np.int32).reshape(n, w)
        words.append(col)
    return np.concatenate(words, axis=1) if words else np.zeros((n, 0), np.int32), spec


def unpack_columns(matrix: np.ndarray, spec: Sequence[np.dtype]) -> list[np.ndarray]:
    """Inverse of pack_columns."""
    out = []
    ofs = 0
    for dt in spec:
        w = _WORDS[(dt.kind, dt.itemsize)]
        chunk = np.ascontiguousarray(matrix[:, ofs : ofs + w])
        if dt.kind == "b":
            out.append(chunk.reshape(-1).astype(bool))
        else:
            out.append(chunk.view(dt).reshape(-1))
        ofs += w
    return out


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def ragged_all_to_all(
    words: np.ndarray,  # [N, W] int32 packed rows
    dest: np.ndarray,  # [N] int32 destination shard in [0, n_shards)
    mesh: Any,
    axis: str = "data",
    capacity: int | None = None,
) -> list[np.ndarray]:
    """Exchange rows to their destination shards. Returns, per destination
    shard, the [n_s, W] int32 word matrix of rows it received (order: by
    source shard, then source order). ``capacity`` bounds the rows one
    source shard may send to one destination, as the reference's
    collective buffer does; one that would drop rows raises."""
    n_shards = mesh.shape[axis]
    devices = mesh.shard_devices(axis)
    n, width = words.shape
    per = _next_pow2(max(1, -(-n // n_shards)))
    dest = np.asarray(dest, dtype=np.int32)
    src = np.minimum(np.arange(n) // per, n_shards - 1)
    cnt = np.zeros((n_shards, n_shards), np.int64)
    valid = dest >= 0
    np.add.at(cnt, (src[valid], dest[valid]), 1)
    need = int(cnt.max()) if n else 0
    if capacity is not None and capacity < need:
        raise ValueError(
            f"capacity={capacity} would drop rows: a source shard sends "
            f"{need} rows to one destination"
        )
    # buckets[s][r]: source shard s's rows for destination r, on s's device
    buckets: list[list[torch.Tensor]] = []
    host_words = torch.from_numpy(np.ascontiguousarray(words, dtype=np.int32))
    host_dest = torch.from_numpy(dest)
    for s in range(n_shards):
        lo, hi = min(n, s * per), min(n, (s + 1) * per)
        w_s = host_words[lo:hi].to(devices[s])
        d_s = host_dest[lo:hi].to(devices[s])
        # padding rows (-1) sort after every real destination
        d_s = torch.where(d_s >= 0, d_s, n_shards)
        order = torch.argsort(d_s, stable=True)
        counts = torch.bincount(d_s, minlength=n_shards + 1)[:n_shards].tolist()
        sent = w_s[order][: sum(counts)]
        buckets.append(list(torch.split(sent, counts)))
    result = []
    for r in range(n_shards):
        got = [buckets[s][r].to(devices[r]) for s in range(n_shards)]
        block = torch.cat(got) if got else torch.zeros((0, width), dtype=torch.int32)
        result.append(np.ascontiguousarray(block.cpu().numpy()).reshape(-1, width))
    return result


def exchange_rows(
    arrays: Sequence[np.ndarray],
    dest: np.ndarray,
    mesh: Any,
    axis: str = "data",
) -> list[list[np.ndarray]]:
    """High-level Exchange: route typed columns to destination shards.
    Returns per-shard lists of typed column arrays (exact bit patterns)."""
    words, spec = pack_columns(list(arrays))
    blocks = ragged_all_to_all(words, dest.astype(np.int32), mesh, axis)
    return [unpack_columns(b, spec) for b in blocks]
