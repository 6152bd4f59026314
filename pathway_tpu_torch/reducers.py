"""The port's own copy of ``pathway_tpu/reducers.py``. pw.reducers — aggregation functions for reduce()
(reference: python/pathway/reducers.py; engine: src/engine/reduce.rs:22-38).
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ReducerExpression
from pathway_tpu_torch.internals.reducer_descriptors import ReducerDescriptor


def _first(ds):
    return ds[0] if ds else dt.ANY


def _float(_ds):
    return dt.FLOAT


def _int(_ds):
    return dt.INT


def _tuple(_ds):
    return dt.ANY_TUPLE


def _array(_ds):
    return dt.ANY_ARRAY


def count(*args: Any) -> ReducerExpression:
    """Number of rows in the group."""
    return ReducerExpression(
        ReducerDescriptor("count", "count", n_args=len(args), ret=_int), *args
    )


def sum(expression: Any) -> ReducerExpression:
    """Sum of values (int, float or numpy array — reference ArraySum)."""
    return ReducerExpression(
        ReducerDescriptor("sum", "sum", ret=_first), expression
    )


def avg(expression: Any) -> ReducerExpression:
    return ReducerExpression(
        ReducerDescriptor("avg", "avg", ret=_float), expression
    )


def min(expression: Any) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(
        ReducerDescriptor("min", "min", ret=_first), expression
    )


def max(expression: Any) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(
        ReducerDescriptor("max", "max", ret=_first), expression
    )


def argmin(expression: Any, id_expression: Any = None) -> ReducerExpression:
    from pathway_tpu_torch.internals.thisclass import this

    args = (expression, id_expression if id_expression is not None else this.id)
    return ReducerExpression(
        ReducerDescriptor(
            "argmin", "argmin", n_args=2, ret=lambda ds: dt.POINTER
        ),
        *args,
    )


def argmax(expression: Any, id_expression: Any = None) -> ReducerExpression:
    from pathway_tpu_torch.internals.thisclass import this

    args = (expression, id_expression if id_expression is not None else this.id)
    return ReducerExpression(
        ReducerDescriptor(
            "argmax", "argmax", n_args=2, ret=lambda ds: dt.POINTER
        ),
        *args,
    )


def unique(expression: Any) -> ReducerExpression:
    """The single distinct value of the group (Error if not unique)."""
    return ReducerExpression(
        ReducerDescriptor("unique", "unique", ret=_first), expression
    )


def any(expression: Any) -> ReducerExpression:  # noqa: A001
    """An arbitrary (but deterministic) value from the group."""
    return ReducerExpression(
        ReducerDescriptor("any", "any", ret=_first), expression
    )


def sorted_tuple(expression: Any, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression(
        ReducerDescriptor(
            "sorted_tuple", "sorted_tuple", skip_nones=skip_nones, ret=_tuple
        ),
        expression,
    )


def tuple(expression: Any, *, skip_nones: bool = False) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(
        ReducerDescriptor("tuple", "tuple", skip_nones=skip_nones, ret=_tuple),
        expression,
    )


def ndarray(expression: Any, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression(
        ReducerDescriptor("ndarray", "ndarray", skip_nones=skip_nones, ret=_array),
        expression,
    )


def earliest(expression: Any) -> ReducerExpression:
    return ReducerExpression(
        ReducerDescriptor("earliest", "earliest", ret=_first), expression
    )


def latest(expression: Any) -> ReducerExpression:
    return ReducerExpression(
        ReducerDescriptor("latest", "latest", ret=_first), expression
    )


def stateful_single(combine_fn: Callable) -> Callable[..., ReducerExpression]:
    """Custom non-retractable reducer: fn(state, *values) -> new state
    (reference: stateful_single, internals/custom_reducers.py)."""

    def make(*args: Any) -> ReducerExpression:
        return ReducerExpression(
            ReducerDescriptor(
                "stateful_single",
                "stateful",
                n_args=len(args),
                fn=combine_fn,
                ret=lambda ds: dt.ANY,
            ),
            *args,
        )

    return make


def stateful_many(combine_fn: Callable) -> Callable[..., ReducerExpression]:
    """fn(state, rows: list[(values_tuple, count)]) -> new state."""

    def make(*args: Any) -> ReducerExpression:
        return ReducerExpression(
            ReducerDescriptor(
                "stateful_many",
                "stateful",
                n_args=len(args),
                fn=combine_fn,
                extra={"many": True},
                ret=lambda ds: dt.ANY,
            ),
            *args,
        )

    return make


def udf_reducer(reducer_cls: Any) -> Callable[..., ReducerExpression]:
    """Reducer from a BaseCustomAccumulator subclass
    (reference: udf_reducer, internals/custom_reducers.py)."""

    def make(*args: Any) -> ReducerExpression:
        return ReducerExpression(
            ReducerDescriptor(
                "udf_reducer",
                "custom_acc",
                n_args=len(args),
                extra={"cls": reducer_cls},
                ret=lambda ds: dt.ANY,
            ),
            *args,
        )

    return make


# aliases kept for reference-parity
int_sum = sum
float_sum = sum
npsum = sum
