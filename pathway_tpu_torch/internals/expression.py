"""The port's own copy of ``pathway_tpu/internals/expression.py``. Column expression AST.

Capability parity with the reference expression system
(upstream Pathway: python/pathway/internals/expression.py, 1,179 LoC; evaluated by
src/engine/expression.rs). Expressions are lazy trees over table columns; the
engine evaluates them columnar-batch-at-a-time (vectorized numpy paths in
engine/expression_eval.py) rather than row-at-a-time like the
reference interpreter.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Iterable, Mapping

from pathway_tpu_torch.internals import dtype as dt


class ColumnExpression:
    """Base class of all column expressions."""

    _dtype_hint: dt.DType | None = None

    # --- arithmetic ----------------------------------------------------------

    def __add__(self, other):
        return ColumnBinaryOpExpression("+", self, other)

    def __radd__(self, other):
        return ColumnBinaryOpExpression("+", other, self)

    def __sub__(self, other):
        return ColumnBinaryOpExpression("-", self, other)

    def __rsub__(self, other):
        return ColumnBinaryOpExpression("-", other, self)

    def __mul__(self, other):
        return ColumnBinaryOpExpression("*", self, other)

    def __rmul__(self, other):
        return ColumnBinaryOpExpression("*", other, self)

    def __truediv__(self, other):
        return ColumnBinaryOpExpression("/", self, other)

    def __rtruediv__(self, other):
        return ColumnBinaryOpExpression("/", other, self)

    def __floordiv__(self, other):
        return ColumnBinaryOpExpression("//", self, other)

    def __rfloordiv__(self, other):
        return ColumnBinaryOpExpression("//", other, self)

    def __mod__(self, other):
        return ColumnBinaryOpExpression("%", self, other)

    def __rmod__(self, other):
        return ColumnBinaryOpExpression("%", other, self)

    def __pow__(self, other):
        return ColumnBinaryOpExpression("**", self, other)

    def __rpow__(self, other):
        return ColumnBinaryOpExpression("**", other, self)

    def __matmul__(self, other):
        return ColumnBinaryOpExpression("@", self, other)

    def __rmatmul__(self, other):
        return ColumnBinaryOpExpression("@", other, self)

    def __neg__(self):
        return ColumnUnaryOpExpression("-", self)

    def __abs__(self):
        return ColumnUnaryOpExpression("abs", self)

    # --- comparison ----------------------------------------------------------

    def __eq__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression("==", self, other)

    def __ne__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression("!=", self, other)

    def __lt__(self, other):
        return ColumnBinaryOpExpression("<", self, other)

    def __le__(self, other):
        return ColumnBinaryOpExpression("<=", self, other)

    def __gt__(self, other):
        return ColumnBinaryOpExpression(">", self, other)

    def __ge__(self, other):
        return ColumnBinaryOpExpression(">=", self, other)

    # --- boolean -------------------------------------------------------------

    def __and__(self, other):
        return ColumnBinaryOpExpression("&", self, other)

    def __rand__(self, other):
        return ColumnBinaryOpExpression("&", other, self)

    def __or__(self, other):
        return ColumnBinaryOpExpression("|", self, other)

    def __ror__(self, other):
        return ColumnBinaryOpExpression("|", other, self)

    def __xor__(self, other):
        return ColumnBinaryOpExpression("^", self, other)

    def __rxor__(self, other):
        return ColumnBinaryOpExpression("^", other, self)

    def __lshift__(self, other):
        return ColumnBinaryOpExpression("<<", self, other)

    def __rlshift__(self, other):
        return ColumnBinaryOpExpression("<<", other, self)

    def __rshift__(self, other):
        return ColumnBinaryOpExpression(">>", self, other)

    def __rrshift__(self, other):
        return ColumnBinaryOpExpression(">>", other, self)

    def __invert__(self):
        return ColumnUnaryOpExpression("~", self)

    def __hash__(self) -> int:
        return id(self)

    def __bool__(self):
        raise RuntimeError(
            "Cannot use a ColumnExpression in a boolean context; "
            "use & | ~ instead of and/or/not."
        )

    def __iter__(self):
        # without this, star-unpacking an expression falls into the legacy
        # iteration protocol over __getitem__ and loops forever building
        # GetExpressions
        raise TypeError(
            f"{type(self).__name__} is not iterable"
        )

    def __repr__(self) -> str:
        from pathway_tpu_torch.internals.expression_printer import (
            get_expression_info,
        )

        try:
            return get_expression_info(self)
        except Exception:
            return object.__repr__(self)

    # --- accessors -----------------------------------------------------------

    def __getitem__(self, item) -> "ColumnExpression":
        return GetExpression(self, item, check_if_exists=False)

    def get(self, item, default: Any = None) -> "ColumnExpression":
        return GetExpression(self, item, default=default, check_if_exists=True)

    @property
    def dt(self):
        # its values are pandas Timestamps: CPU-only where pandas is missing
        from pathway_tpu_torch.internals.expressions.date_time import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self):
        from pathway_tpu_torch.internals.expressions.string import StringNamespace

        return StringNamespace(self)

    @property
    def num(self):
        from pathway_tpu_torch.internals.expressions.numerical import NumericalNamespace

        return NumericalNamespace(self)

    @property
    def bin(self):
        from pathway_tpu_torch.internals.expressions.string import BytesNamespace

        return BytesNamespace(self)

    # --- type ops ------------------------------------------------------------

    def is_none(self) -> "ColumnExpression":
        return IsNoneExpression(self)

    def is_not_none(self) -> "ColumnExpression":
        return IsNotNoneExpression(self)

    def as_int(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(dt.INT, self, unwrap=unwrap)

    def as_float(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(dt.FLOAT, self, unwrap=unwrap)

    def as_str(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(dt.STR, self, unwrap=unwrap)

    def as_bool(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(dt.BOOL, self, unwrap=unwrap)

    def to_string(self) -> "ColumnExpression":
        return ToStringExpression(self)

    # --- traversal -----------------------------------------------------------

    @property
    def _children(self) -> tuple["ColumnExpression", ...]:
        return ()

    def _dependencies(self) -> list["ColumnReference"]:
        out: list[ColumnReference] = []
        seen: set[tuple[int, str]] = set()
        for child in self._children:
            for ref in child._dependencies():
                key = (id(ref.table), ref.name)
                if key not in seen:
                    seen.add(key)
                    out.append(ref)
        return out

    def _substitute(
        self, mapping: Callable[["ColumnReference"], "ColumnExpression | None"]
    ) -> "ColumnExpression":
        return self._rebuild(
            tuple(c._substitute(mapping) for c in self._children)
        )

    def _rebuild(self, children: tuple["ColumnExpression", ...]) -> "ColumnExpression":
        if not children:
            return self
        raise NotImplementedError(type(self))


def wrap_expr(value: Any) -> ColumnExpression:
    if isinstance(value, ColumnExpression):
        return value
    return ColumnConstExpression(value)


class ColumnConstExpression(ColumnExpression):
    def __init__(self, value: Any):
        self._value = value

    def __repr__(self):
        return repr(self._value)


class ColumnReference(ColumnExpression):
    """Reference to a column of a table: ``table.colname`` / ``table['colname']``.

    ``name == 'id'`` refers to the key column."""

    def __init__(self, table: Any, name: str):
        self._table = table
        self._name = name

    @property
    def table(self):
        return self._table

    @property
    def name(self) -> str:
        return self._name

    @property
    def _column_name(self) -> str:
        return self._name

    def _dependencies(self):
        return [self]

    def _substitute(self, mapping):
        result = mapping(self)
        return result if result is not None else self


    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"column {self._name!r} is not callable; "
            "did you mean to use pw.apply?"
        )


_BINARY_OPS: dict[str, Callable[[Any, Any], Any]] = {
    "+": operator.add,
    "-": operator.sub,
    "*": operator.mul,
    "/": operator.truediv,
    "//": operator.floordiv,
    "%": operator.mod,
    "**": operator.pow,
    "@": operator.matmul,
    "==": operator.eq,
    "!=": operator.ne,
    "<": operator.lt,
    "<=": operator.le,
    ">": operator.gt,
    ">=": operator.ge,
    "&": operator.and_,
    "|": operator.or_,
    "^": operator.xor,
}


class ColumnBinaryOpExpression(ColumnExpression):
    def __init__(self, op: str, left: Any, right: Any):
        self._op = op
        self._left = wrap_expr(left)
        self._right = wrap_expr(right)

    @property
    def _children(self):
        return (self._left, self._right)

    def _rebuild(self, children):
        return ColumnBinaryOpExpression(self._op, children[0], children[1])



class ColumnUnaryOpExpression(ColumnExpression):
    def __init__(self, op: str, expr: Any):
        self._op = op
        self._expr = wrap_expr(expr)

    @property
    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return ColumnUnaryOpExpression(self._op, children[0])



class ReducerExpression(ColumnExpression):
    """A reducer applied inside groupby().reduce() / windowby().reduce()."""

    def __init__(self, reducer: Any, *args: Any, **kwargs: Any):
        self._reducer = reducer  # engine-level Reducer descriptor
        self._args = tuple(wrap_expr(a) for a in args)
        self._kwargs = {k: wrap_expr(v) for k, v in kwargs.items()}

    @property
    def _children(self):
        return self._args + tuple(self._kwargs.values())

    def _rebuild(self, children):
        n = len(self._args)
        args = children[:n]
        kwargs = dict(zip(self._kwargs.keys(), children[n:]))
        return ReducerExpression(self._reducer, *args, **kwargs)



class ApplyExpression(ColumnExpression):
    """Escape hatch: run a python function per row (batched host callback on the
    engine side — reference: AnyExpression::Apply, src/engine/expression.rs)."""

    def __init__(
        self,
        fn: Callable,
        return_type: Any,
        propagate_none: bool,
        deterministic: bool | None,
        args: tuple,
        kwargs: Mapping[str, Any],
        *,
        max_batch_size: int | None = None,
    ):
        self._fn = fn
        self._return_type = dt.wrap(return_type)
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        self._args = tuple(wrap_expr(a) for a in args)
        self._kwargs = {k: wrap_expr(v) for k, v in kwargs.items()}
        self._max_batch_size = max_batch_size
        # UDF provenance for diagnostics; pw.udf overrides with the raw
        # (unwrapped) function's name
        self._udf_name = getattr(fn, "__name__", None)

    @property
    def _children(self):
        return self._args + tuple(self._kwargs.values())

    def _rebuild(self, children):
        n = len(self._args)
        out = type(self)(
            self._fn,
            self._return_type,
            self._propagate_none,
            self._deterministic,
            children[:n],
            dict(zip(self._kwargs.keys(), children[n:])),
            max_batch_size=self._max_batch_size,
        )
        out._udf_name = self._udf_name
        return out



class BatchApplyExpression(ApplyExpression):
    """Columnar UDF: fn receives whole argument LISTS for the batch and
    returns a list of results — the path device-backed UDFs (embedders,
    rerankers) use so one device forward serves the whole tick."""


class AsyncApplyExpression(ApplyExpression):
    """Async UDF application (reference: async_apply_table,
    src/engine/dataflow.rs:1899)."""


class FullyAsyncApplyExpression(AsyncApplyExpression):
    pass


class CastExpression(ColumnExpression):
    def __init__(self, target: Any, expr: Any):
        self._target = dt.wrap(target)
        self._expr = wrap_expr(expr)

    @property
    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return CastExpression(self._target, children[0])



class ConvertExpression(ColumnExpression):
    """as_int/as_float/as_str/as_bool — Json/Any extraction."""

    def __init__(self, target: dt.DType, expr: Any, unwrap: bool = False):
        self._target = target
        self._expr = wrap_expr(expr)
        self._unwrap = unwrap

    @property
    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return ConvertExpression(self._target, children[0], self._unwrap)


class DeclareTypeExpression(ColumnExpression):
    def __init__(self, target: Any, expr: Any):
        self._target = dt.wrap(target)
        self._expr = wrap_expr(expr)

    @property
    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return DeclareTypeExpression(self._target, children[0])


class IfElseExpression(ColumnExpression):
    def __init__(self, if_: Any, then: Any, else_: Any):
        self._if = wrap_expr(if_)
        self._then = wrap_expr(then)
        self._else = wrap_expr(else_)

    @property
    def _children(self):
        return (self._if, self._then, self._else)

    def _rebuild(self, children):
        return IfElseExpression(*children)



class CoalesceExpression(ColumnExpression):
    def __init__(self, *args: Any):
        self._args = tuple(wrap_expr(a) for a in args)

    @property
    def _children(self):
        return self._args

    def _rebuild(self, children):
        return CoalesceExpression(*children)


class RequireExpression(ColumnExpression):
    """Evaluates to None if any of the requirements is None."""

    def __init__(self, val: Any, *args: Any):
        self._val = wrap_expr(val)
        self._args = tuple(wrap_expr(a) for a in args)

    @property
    def _children(self):
        return (self._val,) + self._args

    def _rebuild(self, children):
        return RequireExpression(children[0], *children[1:])


class FillErrorExpression(ColumnExpression):
    def __init__(self, expr: Any, replacement: Any):
        self._expr = wrap_expr(expr)
        self._replacement = wrap_expr(replacement)

    @property
    def _children(self):
        return (self._expr, self._replacement)

    def _rebuild(self, children):
        return FillErrorExpression(children[0], children[1])


class IsNoneExpression(ColumnExpression):
    def __init__(self, expr: Any):
        self._expr = wrap_expr(expr)

    @property
    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return IsNoneExpression(children[0])


class IsNotNoneExpression(ColumnExpression):
    def __init__(self, expr: Any):
        self._expr = wrap_expr(expr)

    @property
    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return IsNotNoneExpression(children[0])


class UnwrapExpression(ColumnExpression):
    def __init__(self, expr: Any):
        self._expr = wrap_expr(expr)

    @property
    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return UnwrapExpression(children[0])


class PointerExpression(ColumnExpression):
    """table.pointer_from(*args, optional=..., instance=...) — key derivation
    (reference: Key::for_values + ShardPolicy, src/engine/value.rs:60,94)."""

    def __init__(
        self,
        table: Any,
        *args: Any,
        optional: bool = False,
        instance: Any | None = None,
    ):
        self._table = table
        self._args = tuple(wrap_expr(a) for a in args)
        self._optional = optional
        self._instance = wrap_expr(instance) if instance is not None else None

    @property
    def _children(self):
        extra = (self._instance,) if self._instance is not None else ()
        return self._args + extra

    def _rebuild(self, children):
        if self._instance is not None:
            return PointerExpression(
                self._table,
                *children[:-1],
                optional=self._optional,
                instance=children[-1],
            )
        return PointerExpression(self._table, *children, optional=self._optional)


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args: Any):
        self._args = tuple(wrap_expr(a) for a in args)

    @property
    def _children(self):
        return self._args

    def _rebuild(self, children):
        return MakeTupleExpression(*children)


class SequenceGetExpression(ColumnExpression):
    pass


class GetExpression(ColumnExpression):
    """expr[i] / expr.get(i, default) over tuples, Json, strings, arrays."""

    def __init__(
        self, expr: Any, index: Any, default: Any = None, check_if_exists: bool = True
    ):
        self._expr = wrap_expr(expr)
        self._index = wrap_expr(index)
        self._default = wrap_expr(default)
        self._check_if_exists = check_if_exists

    @property
    def _children(self):
        return (self._expr, self._index, self._default)

    def _rebuild(self, children):
        return GetExpression(
            children[0], children[1], children[2], self._check_if_exists
        )


class ToStringExpression(ColumnExpression):
    def __init__(self, expr: Any):
        self._expr = wrap_expr(expr)

    @property
    def _children(self):
        return (self._expr,)

    def _rebuild(self, children):
        return ToStringExpression(children[0])


# ---------------------------------------------------------------------------
# purity / determinism facts (consumed by pathway_tpu/analysis)


def iter_subexpressions(e: ColumnExpression) -> "Iterable[ColumnExpression]":
    """Depth-first walk over an expression tree (self included)."""
    yield e
    for c in e._children:
        yield from iter_subexpressions(c)


def iter_apply_expressions(
    e: ColumnExpression,
) -> "Iterable[ApplyExpression]":
    """Every UDF application (pw.apply / @pw.udf / async variants) inside
    an expression tree."""
    for sub in iter_subexpressions(e):
        if isinstance(sub, ApplyExpression):
            yield sub


def expression_is_deterministic(e: ColumnExpression) -> bool:
    """True when re-evaluating the expression over the same rows provably
    yields the same values: every UDF inside is tagged deterministic.
    Built-in operators and method namespaces are always deterministic."""
    return all(a._deterministic for a in iter_apply_expressions(e))


def expression_is_pure(e: ColumnExpression) -> bool:
    """True when the expression contains no escape-hatch UDF at all —
    the engine fully understands its semantics."""
    for _ in iter_apply_expressions(e):
        return False
    return True


class MethodCallExpression(ColumnExpression):
    """A named method over columns (powers the .dt/.str/.num namespaces).

    ``scalar_fn`` operates on single values; ``vector_fn``, when given, operates
    on whole numpy arrays (the vectorized path)."""

    def __init__(
        self,
        name: str,
        scalar_fn: Callable,
        return_type: Any,
        *args: Any,
        vector_fn: Callable | None = None,
        propagate_none: bool = True,
    ):
        self._name = name
        self._scalar_fn = scalar_fn
        self._vector_fn = vector_fn
        self._return_type = dt.wrap(return_type)
        self._args = tuple(wrap_expr(a) for a in args)
        self._propagate_none = propagate_none

    @property
    def _children(self):
        return self._args

    def _rebuild(self, children):
        return MethodCallExpression(
            self._name,
            self._scalar_fn,
            self._return_type,
            *children,
            vector_fn=self._vector_fn,
            propagate_none=self._propagate_none,
        )

