"""The port's own copy of ``pathway_tpu/engine/reducers.py``. Reducer accumulators for incremental groupby/reduce.

Parity with the reference reducer set (upstream Pathway: src/engine/reduce.rs:22-38
and src/engine/dataflow.rs:3113-3400): Count, IntSum/FloatSum/ArraySum, Unique,
Min/ArgMin, Max/ArgMax, SortedTuple, Tuple, Any, Earliest, Latest, Avg,
Ndarray, Stateful. Semigroup reducers (count/sum/avg) keep O(1) state and
retract by subtraction; order-dependent ones keep a multiset and restate on
change — the engine recomputes only touched groups per tick, the microbatch
analog of differential's `reduce_abelian`."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals.api import ERROR


@dataclass
class ReducerSpec:
    """Build-time description: which accumulator over which input columns."""

    kind: str
    arg_cols: tuple[str, ...] = ()
    skip_nones: bool = False
    # reference groupby(_skip_errors=True) default: ERROR args are simply
    # skipped; with False they poison the aggregate while present
    skip_errors: bool = True
    fn: Callable | None = None  # stateful combine fn
    extra: dict = field(default_factory=dict)

    def make(self) -> "Accumulator":
        return _FACTORY[self.kind](self)


class Accumulator:
    # net count of ERROR-bearing rows in this aggregate (+diff/-diff), so a
    # retracted/corrected poison row un-poisons the group
    poisoned_count = 0

    def __init__(self, spec: ReducerSpec):
        self.spec = spec

    def update(self, args: tuple, diff: int, key: int, time: int) -> None:
        raise NotImplementedError

    def value(self) -> Any:
        raise NotImplementedError


class CountAcc(Accumulator):
    def __init__(self, spec):
        super().__init__(spec)
        self.c = 0

    def update(self, args, diff, key, time):
        if self.spec.arg_cols and self.spec.skip_nones and args[0] is None:
            return
        self.c += diff

    def value(self):
        return self.c


class SumAcc(Accumulator):
    def __init__(self, spec):
        super().__init__(spec)
        self.s: Any = 0
        self.n = 0

    def update(self, args, diff, key, time):
        v = args[0]
        if v is None:
            if self.spec.skip_nones:
                return
            v = 0
        if isinstance(v, np.ndarray):
            # keep a multiset and np.sum at read time: numpy's pairwise
            # summation is the reference result (sequential += drifts,
            # e.g. 1.1+4.1+7.1 != np.sum([...])); counts cancel on
            # retraction so memory stays O(distinct arrays)
            if not isinstance(self.s, dict):
                # any scalar sum accumulated before the first array rides
                # along and re-adds at read time
                self.scalar_carry = self.s
                self.s = {}
            k = _hashable(v)
            c = self.s.get(k, 0) + diff
            if c == 0:
                self.s.pop(k, None)
            else:
                self.s[k] = c
        elif isinstance(self.s, dict):
            self.scalar_carry = getattr(self, "scalar_carry", 0) + v * diff
        else:
            self.s = self.s + v * diff
        self.n += diff

    def value(self):
        if isinstance(self.s, dict):
            arrs = []
            for k, c in self.s.items():
                arrs.extend([_unhashable(k)] * max(c, 0))
            carry = getattr(self, "scalar_carry", 0)
            if not arrs:
                return carry
            total = np.sum(np.stack(arrs), axis=0)
            if isinstance(carry, (int, float)) and carry == 0:
                return total
            return total + carry
        return self.s


class AvgAcc(Accumulator):
    def __init__(self, spec):
        super().__init__(spec)
        self.s = 0.0
        self.c = 0

    def update(self, args, diff, key, time):
        v = args[0]
        if v is None:
            if self.spec.skip_nones:
                return
        self.s += float(v) * diff
        self.c += diff

    def value(self):
        if self.c == 0:
            return ERROR
        return self.s / self.c


class _MultisetAcc(Accumulator):
    """Keeps a multiset of argument tuples with counts."""

    def __init__(self, spec):
        super().__init__(spec)
        self.items: dict[Any, int] = {}

    def _k(self, args: tuple, key: int, time: int) -> Any:
        return args

    def update(self, args, diff, key, time):
        if self.spec.skip_nones and args[0] is None:
            return
        k = self._k(args, key, time)
        c = self.items.get(k, 0) + diff
        if c == 0:
            self.items.pop(k, None)
        else:
            self.items[k] = c

    def update_bulk(self, argcols: list[list], diffs: list[int]) -> None:
        """Apply one group's slice of a batch in a single tight loop (the
        columnar groupby path, engine/nodes.py). ERROR args feed
        poisoned_count exactly like the per-row path; returns nothing —
        state mutates in place."""
        items = self.items
        skip = self.spec.skip_nones
        skip_err = self.spec.skip_errors
        for k in zip(*argcols, diffs):
            d = k[-1]
            args = k[:-1]
            if skip and args[0] is None:
                continue
            if any(a is ERROR for a in args):
                if not skip_err:
                    self.poisoned_count += d
                continue
            c = items.get(args, 0) + d
            if c == 0:
                items.pop(args, None)
            else:
                items[args] = c


def _sort_key(v: Any) -> Any:
    # heterogeneous-safe sort key
    return (str(type(v).__name__), v) if not isinstance(v, (int, float, bool)) else (
        "num",
        v,
    )


class MinAcc(_MultisetAcc):
    def value(self):
        if not self.items:
            return ERROR
        return min((k[0] for k in self.items), key=_sort_key)


class MaxAcc(_MultisetAcc):
    def value(self):
        if not self.items:
            return ERROR
        return max((k[0] for k in self.items), key=_sort_key)


class ArgMinAcc(_MultisetAcc):
    # args = (value, arg); ties on the value break on the SMALLEST arg by
    # its stable sort key — never hash(), which is PYTHONHASHSEED-salted
    # and would make results differ between process runs
    def value(self):
        if not self.items:
            return ERROR
        best_val = min((k[0] for k in self.items), key=_sort_key)
        bk = _sort_key(best_val)
        return min(
            (k[1] for k in self.items if _sort_key(k[0]) == bk),
            key=_sort_key,
        )


class ArgMaxAcc(_MultisetAcc):
    def value(self):
        if not self.items:
            return ERROR
        best_val = max((k[0] for k in self.items), key=_sort_key)
        bk = _sort_key(best_val)
        return min(
            (k[1] for k in self.items if _sort_key(k[0]) == bk),
            key=_sort_key,
        )


class UniqueAcc(_MultisetAcc):
    def value(self):
        vals = {k[0] for k in self.items}
        if len(vals) != 1:
            # recorded by the groupby exec -> poisons the cell AND fails a
            # terminate_on_error run (reference: unique() panics on
            # non-unique groups)
            raise ValueError(
                "More than one distinct value passed to the unique reducer"
            )
        return next(iter(vals))


class AnyAcc(Accumulator):
    """'Some' value — the one belonging to the smallest row key, so every
    any() column of a group comes from the SAME row (reference relies on
    this: joining a reduce of any(pet), any(owner), any(age) back against
    the source matches exactly one row)."""

    def __init__(self, spec):
        super().__init__(spec)
        self.rows: dict[Any, list] = {}  # row key -> [value, count]

    def update(self, args, diff, key, time):
        if self.spec.skip_nones and args[0] is None:
            return
        e = self.rows.get(key)
        if e is None:
            if diff != 0:
                self.rows[key] = [args[0], diff]
        else:
            e[1] += diff
            if diff > 0:
                e[0] = args[0]
            if e[1] == 0:
                del self.rows[key]

    def value(self):
        if not self.rows:
            return ERROR
        k = min(self.rows, key=_sort_key)
        return self.rows[k][0]


class _KeyedMultisetAcc(Accumulator):
    """Multiset of (order_key, value) for ordered collection reducers."""

    def __init__(self, spec):
        super().__init__(spec)
        self.items: dict[Any, int] = {}

    def update(self, args, diff, key, time):
        v = args[0]
        if self.spec.skip_nones and v is None:
            return
        # the order key may itself be an ndarray (sort_by over an array
        # column) — store its hashable, orderable form
        k = (_hashable(key), _hashable(v))
        c = self.items.get(k, 0) + diff
        if c == 0:
            self.items.pop(k, None)
        else:
            self.items[k] = c

    def _expanded(self):
        out = []
        for (key, v), c in self.items.items():
            out.extend([(key, _unhashable(v))] * max(c, 0))
        return out


def _hashable(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        # order key FIRST after the tag so sorted() orders arrays by their
        # contents; equality/hashing additionally uses the raw BYTES so
        # NaN-holding arrays still cancel on retraction (nan != nan would
        # otherwise split the multiset keys)
        import math

        flat = np.ravel(v).tolist()
        if v.dtype.kind == "f":
            order = tuple(
                (1, 0.0) if math.isnan(x) else (0, float(x)) for x in flat
            )
        else:
            order = tuple(flat)
        return (
            "__ndarray__",
            order,
            str(v.dtype),
            v.shape,
            v.tobytes(),
        )
    if isinstance(v, list):
        return ("__tuple__", tuple(_hashable(x) for x in v))
    if isinstance(v, tuple):
        # sort tokens are (sort_value, key) tuples that may carry arrays
        return tuple(_hashable(x) for x in v)
    return v


def _unhashable(v: Any) -> Any:
    if isinstance(v, tuple) and len(v) == 5 and v[0] == "__ndarray__":
        return (
            np.frombuffer(v[4], dtype=np.dtype(v[2])).reshape(v[3]).copy()
        )
    if isinstance(v, tuple) and len(v) == 4 and v[0] == "__ndarray__":
        # older snapshot encoding (pre-bytes)
        return np.array(v[1], dtype=np.dtype(v[2])).reshape(v[3])
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "__tuple__":
        return tuple(_unhashable(x) for x in v[1])
    if isinstance(v, tuple):
        # plain tuples are encoded element-wise without a tag; decode any
        # nested ndarray/list markers the same way
        return tuple(_unhashable(x) for x in v)
    return v


class TupleAcc(_KeyedMultisetAcc):
    def value(self):
        items = sorted(self._expanded(), key=lambda kv: kv[0])
        return tuple(v for _, v in items)


class SortedTupleAcc(_KeyedMultisetAcc):
    def value(self):
        items = [v for _, v in self._expanded()]
        return tuple(sorted(items, key=_sort_key))


class NdarrayAcc(_KeyedMultisetAcc):
    def value(self):
        items = sorted(self._expanded(), key=lambda kv: kv[0])
        return np.array([v for _, v in items])


class EarliestAcc(Accumulator):
    def __init__(self, spec):
        super().__init__(spec)
        self.items: dict[Any, int] = {}

    def update(self, args, diff, key, time):
        k = (time, key, _hashable(args[0]))
        c = self.items.get(k, 0) + diff
        if c == 0:
            self.items.pop(k, None)
        else:
            self.items[k] = c

    def value(self):
        if not self.items:
            return ERROR
        t, k, v = min(self.items, key=lambda x: (x[0], x[1]))
        return _unhashable(v)


class LatestAcc(EarliestAcc):
    def value(self):
        if not self.items:
            return ERROR
        t, k, v = max(self.items, key=lambda x: (x[0], x[1]))
        return _unhashable(v)


class StatefulAcc(Accumulator):
    """Custom non-retractable accumulator
    (reference: stateful_reduce, src/engine/dataflow/operators/stateful_reduce.rs)."""

    def __init__(self, spec):
        super().__init__(spec)
        self.state: Any = None
        self.many = spec.extra.get("many", False)

    def update(self, args, diff, key, time):
        if diff < 0:
            raise RuntimeError(
                "stateful reducers do not support retractions "
                "(append-only input required)"
            )
        assert self.spec.fn is not None
        if self.many:
            self.state = self.spec.fn(self.state, [(args, diff)])
        else:
            self.state = self.spec.fn(self.state, *args)

    def value(self):
        return self.state


class CustomAccAcc(Accumulator):
    """BaseCustomAccumulator-driven reducer (reference: udf_reducer,
    internals/custom_reducers.py). Accumulators implementing ``retract``
    apply retractions incrementally; those that don't trigger a full
    recomputation of the group from the retained row multiset (the
    reference's non-retractable fallback)."""

    def __init__(self, spec):
        super().__init__(spec)
        self.cls = spec.extra["cls"]
        self.acc: Any = None
        from pathway_tpu_torch.internals.custom_reducers import (
            BaseCustomAccumulator,
        )

        self._has_retract = (
            getattr(self.cls, "retract", None) is not None
            and self.cls.retract is not BaseCustomAccumulator.retract
        )
        self.n = 0  # net row count (emptiness signal, O(1))
        # retained row multiset — ONLY for the non-retract rebuild path
        self.rows: dict[tuple, int] = {}
        self._dirty = False

    def _apply_rows(self, args, diff):
        k = tuple(_hashable(a) for a in args)
        c = self.rows.get(k, 0) + diff
        if c == 0:
            self.rows.pop(k, None)
        else:
            self.rows[k] = c

    def update(self, args, diff, key, time):
        self.n += diff
        if not self._has_retract:
            self._apply_rows(args, diff)
        if diff > 0 and not self._dirty:
            other = self.cls.from_row(list(args))
            for _ in range(diff):
                if self.acc is None:
                    self.acc = self.cls.from_row(list(args))
                else:
                    self.acc.update(other)
        elif diff < 0 and self._has_retract:
            other = self.cls.from_row(list(args))
            for _ in range(-diff):
                if self.acc is None:
                    raise RuntimeError("retraction before insertion")
                self.acc.retract(other)
        elif diff < 0:
            # no retract: rebuild lazily in value(), at most once per tick
            self._dirty = True

    def _rebuild(self):
        self.acc = None
        for k, c in self.rows.items():
            row = [_unhashable(x) for x in k]
            other = self.cls.from_row(row)
            for _ in range(c):
                if self.acc is None:
                    self.acc = self.cls.from_row(row)
                else:
                    self.acc.update(other)
        self._dirty = False

    def value(self):
        if self._dirty:
            self._rebuild()
        if self.acc is None or self.n <= 0:
            return None
        return self.acc.compute_result()


_FACTORY: dict[str, Callable[[ReducerSpec], Accumulator]] = {
    "custom_acc": CustomAccAcc,
    "count": CountAcc,
    "sum": SumAcc,
    "avg": AvgAcc,
    "min": MinAcc,
    "max": MaxAcc,
    "argmin": ArgMinAcc,
    "argmax": ArgMaxAcc,
    "unique": UniqueAcc,
    "any": AnyAcc,
    "tuple": TupleAcc,
    "sorted_tuple": SortedTupleAcc,
    "ndarray": NdarrayAcc,
    "earliest": EarliestAcc,
    "latest": LatestAcc,
    "stateful": StatefulAcc,
}
