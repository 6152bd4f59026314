"""Columnar diff batches — the unit of dataflow in the microbatch engine; the
port's own copy of ``pathway_tpu/engine/batch.py``. ``consolidate`` groups
through the port's native hasher where it builds, else in pure Python by
the same rule.

A re-design of the reference's rowwise `Collection<S, (Key, Value)>`
streams (reference: src/engine/dataflow.rs:174-186 `Values`, :526 `Table`):
instead of boxed row tuples flowing through timely channels, each logical tick
moves a struct-of-arrays batch (uint64 key column + typed value columns +
int64 diff weights). Numeric columns are dense numpy arrays; strings/json
are object arrays.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Mapping, Sequence

import numpy as np

END_OF_TIME = 1 << 62


def _obj_column(values: Sequence[Any]) -> np.ndarray:
    """Object-dtype column via one C-level slice assignment (a per-row
    Python loop here was a hot spot of the engine ingest path). Falls back
    to the loop when numpy would broadcast the elements instead of storing
    them (equal-length tuples/ndarrays become a 2-D RHS and raise)."""
    out = np.empty(len(values), dtype=object)
    try:
        out[:] = values if isinstance(values, (list, tuple)) else list(values)
    except ValueError:
        for i, v in enumerate(values):
            out[i] = v
    return out


def make_column(values: Sequence[Any], np_dtype: Any = None) -> np.ndarray:
    """Build a column array; object dtype is element-safe for tuples/arrays."""
    if isinstance(values, np.ndarray) and np_dtype is None:
        return values
    if np_dtype is None or np.dtype(np_dtype) == np.dtype(object):
        return _obj_column(values)
    try:
        return np.asarray(values, dtype=np_dtype)
    except (ValueError, TypeError, OverflowError):
        return _obj_column(values)


def expand_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate [starts[i], starts[i]+counts[i]) ranges into one index
    array (the vectorized range-expansion trick shared by the equijoin
    probe fallback and the arrangement gather; the reference keeps it in
    ``internals/api.py``)."""
    total = int(counts.sum())
    if not total:
        return np.empty(0, dtype=np.int64)
    nz = counts > 0
    reps = counts[nz]
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(reps) - reps, reps
    )
    return np.repeat(starts[nz].astype(np.int64), reps) + offs


class DiffBatch:
    """keys: uint64[n]; diffs: int64[n] (+1 insert / -1 retract);
    columns: name -> array[n]."""

    __slots__ = ("keys", "diffs", "columns")

    def __init__(
        self,
        keys: np.ndarray,
        diffs: np.ndarray,
        columns: Mapping[str, np.ndarray],
    ):
        self.keys = np.asarray(keys, dtype=np.uint64)
        self.diffs = np.asarray(diffs, dtype=np.int64)
        self.columns = dict(columns)

    # --- constructors ---------------------------------------------------------

    @staticmethod
    def empty(column_names: Iterable[str]) -> "DiffBatch":
        return DiffBatch(
            np.empty(0, dtype=np.uint64),
            np.empty(0, dtype=np.int64),
            {name: np.empty(0, dtype=object) for name in column_names},
        )

    @staticmethod
    def from_rows(
        rows: Sequence[tuple[int, int, tuple]],
        column_names: Sequence[str],
    ) -> "DiffBatch":
        """rows: (key, diff, values-tuple)"""
        n = len(rows)
        if n == 0:
            return DiffBatch.empty(column_names)
        # transpose once at C speed instead of a per-row/per-column loop
        keys_t, diffs_t, vals_t = zip(*rows)
        keys = np.fromiter(keys_t, dtype=np.uint64, count=n)
        diffs = np.fromiter(diffs_t, dtype=np.int64, count=n)
        if column_names:
            cols = [_obj_column(col) for col in zip(*vals_t)]
        else:
            cols = []
        return DiffBatch(keys, diffs, dict(zip(column_names, cols)))

    # --- basics ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def column_names(self) -> list[str]:
        return list(self.columns.keys())

    def row_values(self, i: int) -> tuple:
        return tuple(col[i] for col in self.columns.values())

    def iter_rows(self) -> Iterator[tuple[int, int, tuple]]:
        # one C-level transpose instead of per-row generator expressions;
        # numeric columns yield Python scalars (tolist), matching what the
        # batch hashers serialize
        n = len(self.keys)
        cols = [c.tolist() for c in self.columns.values()]
        vals: Iterable[tuple] = zip(*cols) if cols else ((),) * n
        return zip(self.keys.tolist(), self.diffs.tolist(), vals)

    def mask(self, m: np.ndarray) -> "DiffBatch":
        return DiffBatch(
            self.keys[m],
            self.diffs[m],
            {name: col[m] for name, col in self.columns.items()},
        )

    def take(self, idx: np.ndarray) -> "DiffBatch":
        return DiffBatch(
            self.keys[idx],
            self.diffs[idx],
            {name: col[idx] for name, col in self.columns.items()},
        )

    def with_columns(self, columns: Mapping[str, np.ndarray]) -> "DiffBatch":
        return DiffBatch(self.keys, self.diffs, columns)

    def rename(self, mapping: Mapping[str, str]) -> "DiffBatch":
        return DiffBatch(
            self.keys,
            self.diffs,
            {mapping.get(name, name): col for name, col in self.columns.items()},
        )

    def select_columns(self, names: Sequence[str]) -> "DiffBatch":
        return DiffBatch(self.keys, self.diffs, {n: self.columns[n] for n in names})

    @staticmethod
    def concat(batches: Sequence["DiffBatch"]) -> "DiffBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return DiffBatch.empty([])
        if len(batches) == 1:
            return batches[0]
        names = batches[0].column_names
        return DiffBatch(
            np.concatenate([b.keys for b in batches]),
            np.concatenate([b.diffs for b in batches]),
            {
                n: concat_columns([b.columns[n] for b in batches])
                for n in names
            },
        )

    def consolidate(self) -> "DiffBatch":
        """Merge rows with equal (key, values), summing diffs; drop zeros.
        (reference analog: differential `consolidate`)."""
        if len(self) <= 1:
            if len(self) == 1 and self.diffs[0] == 0:
                return self.mask(np.zeros(1, dtype=bool))
            return self
        from pathway_tpu_torch.internals.native import get_native

        nat = get_native()
        cols = list(self.columns.values())
        if nat is not None:
            # native path: group by (key, 64-bit value hash) — the value
            # hash stands in for full value equality within one batch.
            # Numeric columns go through tolist() so the C serializer sees
            # exact PyLong/PyFloat (np scalars would bounce back to python)
            hash_cols = tuple(
                c.tolist() if c.dtype != object else c for c in cols
            )
            vhashes = nat.hash_columns(hash_cols, len(self))
            idx_b, diff_b = nat.consolidate(
                np.ascontiguousarray(self.keys).tobytes(),
                vhashes,
                np.ascontiguousarray(self.diffs).tobytes(),
            )
            idx = np.frombuffer(idx_b, dtype=np.int64)
            out = self.take(idx)
            out.diffs = np.frombuffer(diff_b, dtype=np.int64).copy()
            return out
        # pure-python path: the native kernel's grouping rule — (key,
        # serialized value bytes) — so results do not depend on whether
        # the library built
        from pathway_tpu_torch.internals.api import _value_bytes

        acc: dict[tuple[int, bytes], list] = {}
        order: list[tuple[int, bytes]] = []
        for i in range(len(self.keys)):
            gk = (int(self.keys[i]), _value_bytes(tuple(c[i] for c in cols)))
            entry = acc.get(gk)
            if entry is None:
                acc[gk] = [int(self.diffs[i]), i]
                order.append(gk)
            else:
                entry[0] += int(self.diffs[i])
        keep = [acc[gk][1] for gk in order if acc[gk][0] != 0]
        diffs_new = [acc[gk][0] for gk in order if acc[gk][0] != 0]
        idx = np.asarray(keep, dtype=np.int64)
        out = self.take(idx)
        out.diffs = np.asarray(diffs_new, dtype=np.int64)
        return out


def uniform_element_spec(
    col: np.ndarray,
) -> tuple[np.dtype, tuple[int, ...]] | None:
    """Column introspection for the wire codec: if every element of an
    object column is an ndarray of one dtype and shape (embedding rows,
    tuple-packed vectors), return ``(dtype, shape)`` so the codec can
    ship them as a single stacked raw block instead of a pickle.
    ``None`` means the column is not uniform (mixed types, ragged
    arrays, or empty — an empty column has no element to describe)."""
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
    silently promoted (an int64 batch concatenated with a float64 one
    used to floatify the ints mid-tick; arrangement state outlives the
    tick and shares this helper)."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return np.empty(0, dtype=object)
    if len(parts) == 1:
        return parts[0]
    d0 = parts[0].dtype
    if all(p.dtype == d0 for p in parts[1:]):
        return np.concatenate(parts)
    return np.concatenate([p.astype(object) for p in parts])


def _values_eq(a: tuple, b: tuple) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not (
                isinstance(x, np.ndarray)
                and isinstance(y, np.ndarray)
                and x.shape == y.shape
                and bool(np.all(x == y))
            ):
                return False
        else:
            try:
                if not (x == y or (x is None and y is None)):
                    return False
            except (ValueError, TypeError):
                if x is not y:
                    return False
    return True


class TableState:
    """Materialized current state of a stream: key -> row values tuple.

    The engine analog of a differential arrangement
    (reference: external/differential-dataflow arrangements) reduced to the
    totally-ordered microbatch setting: state is only ever the *current*
    consolidated frontier."""

    __slots__ = ("column_names", "rows")

    def __init__(self, column_names: Sequence[str]):
        self.column_names = list(column_names)
        self.rows: dict[int, tuple] = {}

    def apply(self, batch: DiffBatch) -> None:
        for k, d, vals in batch.iter_rows():
            if d > 0:
                self.rows[k] = vals
            elif d < 0:
                self.rows.pop(k, None)

    def snapshot_batch(self) -> DiffBatch:
        rows = [(k, 1, v) for k, v in self.rows.items()]
        return DiffBatch.from_rows(rows, self.column_names)

    def get(self, key: int) -> tuple | None:
        return self.rows.get(key)

    def __len__(self) -> int:
        return len(self.rows)


class MultisetState:
    """key -> (values, count) — supports multiplicity >1 (after non-injective
    reindex) and clean retraction."""

    __slots__ = ("column_names", "rows")

    def __init__(self, column_names: Sequence[str]):
        self.column_names = list(column_names)
        self.rows: dict[int, list] = {}  # key -> [values, count]

    def apply_row(self, k: int, d: int, vals: tuple) -> None:
        entry = self.rows.get(k)
        if entry is None:
            if d != 0:
                self.rows[k] = [vals, d]
        else:
            entry[1] += d
            entry[0] = vals if d > 0 else entry[0]
            if entry[1] == 0:
                del self.rows[k]

    def apply(self, batch: DiffBatch) -> None:
        for k, d, vals in batch.iter_rows():
            self.apply_row(k, d, vals)

    def get(self, key: int) -> tuple | None:
        e = self.rows.get(key)
        return e[0] if e else None

    def __len__(self) -> int:
        return len(self.rows)
