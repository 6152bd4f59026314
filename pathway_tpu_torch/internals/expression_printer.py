"""The port's own copy of ``pathway_tpu/internals/expression_printer.py``. Expression pretty-printer
(reference: python/pathway/internals/expression_printer.py): renders
expressions the way error messages and docs show them — tables are numbered
<table1>, <table2>, ... in first-reference order within one printed
expression."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod


class ExpressionFormatter:
    def __init__(self) -> None:
        self._tables: list[Any] = []

    def table_name(self, table: Any) -> str:
        for i, t in enumerate(self._tables):
            if t is table:
                return f"<table{i + 1}>"
        self._tables.append(table)
        return f"<table{len(self._tables)}>"

    # -----------------------------------------------------------------

    def print_expression(self, e: Any) -> str:
        em = expr_mod
        if isinstance(e, em.ColumnReference):
            return f"{self.table_name(e.table)}.{e.name}"
        if isinstance(e, em.ColumnConstExpression):
            return repr(e._value)
        if isinstance(e, em.ColumnBinaryOpExpression):
            return (
                f"({self.print_expression(e._left)} {e._op} "
                f"{self.print_expression(e._right)})"
            )
        if isinstance(e, em.ColumnUnaryOpExpression):
            return f"({e._op}{self.print_expression(e._expr)})"
        if isinstance(e, em.ReducerExpression):
            parts = [self.print_expression(a) for a in e._args]
            parts += [
                f"{k}={self.print_expression(v)}"
                for k, v in e._kwargs.items()
            ]
            name = getattr(e._reducer, "name", str(e._reducer))
            if name in ("argmin", "argmax") and len(parts) > 1:
                # the id argument is an implementation detail of the
                # two-arg accumulator; the reference prints the value only
                parts = parts[:1]
            return f"pathway.reducers.{name}({', '.join(parts)})"
        if isinstance(e, em.ApplyExpression):
            fn_name = getattr(e._fn, "__name__", repr(e._fn))
            parts = [fn_name]
            parts += [self.print_expression(a) for a in e._args]
            parts += [
                f"{k}={self.print_expression(v)}"
                for k, v in e._kwargs.items()
            ]
            kind = (
                "apply_async"
                if isinstance(e, em.AsyncApplyExpression)
                else "apply"
            )
            return f"pathway.{kind}({', '.join(parts)})"
        if isinstance(e, em.CastExpression):
            return (
                f"pathway.cast({e._target.name.upper()}, "
                f"{self.print_expression(e._expr)})"
            )
        if isinstance(e, em.ConvertExpression):
            return (
                f"pathway.as_{e._target.name.lower()}"
                f"({self.print_expression(e._expr)})"
            )
        if isinstance(e, em.DeclareTypeExpression):
            return (
                f"pathway.declare_type({e._target.name.upper()}, "
                f"{self.print_expression(e._expr)})"
            )
        if isinstance(e, em.CoalesceExpression):
            inner = ", ".join(self.print_expression(a) for a in e._args)
            return f"pathway.coalesce({inner})"
        if isinstance(e, em.RequireExpression):
            inner = ", ".join(
                [self.print_expression(e._val)]
                + [self.print_expression(a) for a in e._args]
            )
            return f"pathway.require({inner})"
        if isinstance(e, em.IfElseExpression):
            return (
                f"pathway.if_else({self.print_expression(e._if)}, "
                f"{self.print_expression(e._then)}, "
                f"{self.print_expression(e._else)})"
            )
        if isinstance(e, em.IsNoneExpression):
            return f"({self.print_expression(e._expr)} is None)"
        if isinstance(e, em.IsNotNoneExpression):
            return f"({self.print_expression(e._expr)} is not None)"
        if isinstance(e, em.PointerExpression):
            inner = ", ".join(self.print_expression(a) for a in e._args)
            if e._instance is not None:
                inner += f", instance={self.print_expression(e._instance)}"
            if e._optional:
                inner += ", optional=True"
            return f"{self.table_name(e._table)}.pointer_from({inner})"
        if isinstance(e, em.MethodCallExpression):
            args = [self.print_expression(a) for a in e._args]
            rest = ", ".join(args[1:])
            return f"({args[0]}).{e._name}({rest})"
        if isinstance(e, em.MakeTupleExpression):
            inner = ", ".join(self.print_expression(a) for a in e._args)
            return f"pathway.make_tuple({inner})"
        if isinstance(e, em.GetExpression):
            idx = self.print_expression(e._index)
            if e._check_if_exists:
                return (
                    f"({self.print_expression(e._expr)}).get({idx}, "
                    f"{self.print_expression(e._default)})"
                )
            return f"({self.print_expression(e._expr)})[{idx}]"
        if isinstance(e, em.ToStringExpression):
            return f"({self.print_expression(e._expr)}).to_string()"
        if isinstance(e, em.UnwrapExpression):
            return f"pathway.unwrap({self.print_expression(e._expr)})"
        if isinstance(e, em.FillErrorExpression):
            return (
                f"pathway.fill_error({self.print_expression(e._expr)}, "
                f"{self.print_expression(e._replacement)})"
            )
        return object.__repr__(e)

    def print_table_infos(self) -> str:
        return ", ".join(
            f"<table{i + 1}>={t!r}" for i, t in enumerate(self._tables)
        )


def get_expression_info(e: Any) -> str:
    return ExpressionFormatter().print_expression(e)
