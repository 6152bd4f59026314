"""Column helpers the arrangement and the segment codec share — own copies of
``_obj_column``, ``uniform_element_spec`` and ``concat_columns`` from
``pathway_tpu/engine/batch.py`` and of ``expand_ranges`` from
``pathway_tpu/internals/api.py``.

Not ported: ``DiffBatch``, ``TableState`` and the rest of the engine's batch
layer (the engine is not part of the port yet).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np


def _obj_column(values: Sequence[Any]) -> np.ndarray:
    """Object-dtype column via one C-level slice assignment. Falls back to
    the loop when numpy would broadcast the elements instead of storing
    them (equal-length tuples/ndarrays become a 2-D RHS and raise)."""
    out = np.empty(len(values), dtype=object)
    try:
        out[:] = values if isinstance(values, (list, tuple)) else list(values)
    except ValueError:
        for i, v in enumerate(values):
            out[i] = v
    return out


def uniform_element_spec(
    col: np.ndarray,
) -> tuple[np.dtype, tuple[int, ...]] | None:
    """If every element of an object column is an ndarray of one dtype and
    shape, return ``(dtype, shape)`` so the codec can store them as a single
    stacked raw block instead of a pickle. ``None`` means the column is not
    uniform (mixed types, ragged arrays, or empty)."""
    n = len(col)
    if n == 0:
        return None
    first = col[0]
    if not isinstance(first, np.ndarray) or first.dtype == object:
        return None
    dtype, shape = first.dtype, first.shape
    for i in range(1, n):
        el = col[i]
        if (
            not isinstance(el, np.ndarray)
            or el.dtype != dtype
            or el.shape != shape
        ):
            return None
    return dtype, shape


def concat_columns(parts: Sequence[np.ndarray]) -> np.ndarray:
    """Dtype-preserving column concat: same-dtype parts concatenate
    directly; mixed dtypes go through object arrays so values are never
    silently promoted."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return np.empty(0, dtype=object)
    if len(parts) == 1:
        return parts[0]
    d0 = parts[0].dtype
    if all(p.dtype == d0 for p in parts[1:]):
        return np.concatenate(parts)
    return np.concatenate([p.astype(object) for p in parts])


def expand_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate [starts[i], starts[i]+counts[i]) ranges into one index
    array (the arrangement gather's vectorized range expansion)."""
    total = int(counts.sum())
    if not total:
        return np.empty(0, dtype=np.int64)
    nz = counts > 0
    reps = counts[nz]
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(reps) - reps, reps
    )
    return np.repeat(starts[nz].astype(np.int64), reps) + offs
