"""The port's own copy of ``pathway_tpu/internals/common.py``. Free-standing expression constructors
(reference: python/pathway/internals/common.py:96-230)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals import expression as expr


def apply(fn: Callable, *args: Any, **kwargs: Any) -> expr.ColumnExpression:
    """Apply a python function per row. Result type from fn annotations if
    available."""
    import inspect
    import typing

    try:
        sig = inspect.signature(fn)
    except (ValueError, TypeError):
        sig = None  # builtins without introspectable signatures
    if sig is not None:
        try:
            sig.bind(*args, **kwargs)
        except TypeError as exc:
            raise AssertionError(
                f"pw.apply arguments do not match {fn!r}: {exc}"
            ) from None

    ret = Any
    try:
        hints = typing.get_type_hints(fn)
        ret = hints.get("return", Any)
    except Exception:
        pass
    return expr.ApplyExpression(fn, ret, False, True, args, kwargs)


def apply_with_type(
    fn: Callable, ret_type: Any, *args: Any, **kwargs: Any
) -> expr.ColumnExpression:
    return expr.ApplyExpression(fn, ret_type, False, True, args, kwargs)


def apply_async(fn: Callable, *args: Any, **kwargs: Any) -> expr.ColumnExpression:
    import typing

    ret = Any
    try:
        hints = typing.get_type_hints(fn)
        ret = hints.get("return", Any)
    except Exception:
        pass
    return expr.AsyncApplyExpression(fn, ret, False, True, args, kwargs)


def declare_type(target_type: Any, col: Any) -> expr.ColumnExpression:
    return expr.DeclareTypeExpression(target_type, col)


def cast(target_type: Any, col: Any) -> expr.ColumnExpression:
    return expr.CastExpression(target_type, col)


def coalesce(*args: Any) -> expr.ColumnExpression:
    return expr.CoalesceExpression(*args)


def require(val: Any, *deps: Any) -> expr.ColumnExpression:
    return expr.RequireExpression(val, *deps)


def if_else(if_clause: Any, then_clause: Any, else_clause: Any) -> expr.ColumnExpression:
    return expr.IfElseExpression(if_clause, then_clause, else_clause)


def make_tuple(*args: Any) -> expr.ColumnExpression:
    return expr.MakeTupleExpression(*args)


def unwrap(col: Any) -> expr.ColumnExpression:
    return expr.UnwrapExpression(col)


def fill_error(col: Any, replacement: Any) -> expr.ColumnExpression:
    return expr.FillErrorExpression(col, replacement)


def assert_table_has_schema(table, schema, **kwargs) -> None:
    from pathway_tpu_torch.internals.schema import assert_table_has_schema as _impl

    _impl(table, schema, **kwargs)
