"""The port's own copy of ``pathway_tpu/internals/joins.py``. Joins: JoinResult and friends
(reference: python/pathway/internals/joins.py:135; engine join_tables,
src/engine/dataflow.rs:2740)."""

from __future__ import annotations

from enum import Enum
from typing import Any, Sequence

from pathway_tpu_torch.engine import nodes
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    CoalesceExpression,
    ColumnBinaryOpExpression,
    ColumnExpression,
    ColumnReference,
    wrap_expr,
)
from pathway_tpu_torch.internals.thisclass import (
    ThisPlaceholder,
    ThisSlice,
    left as left_ph,
    right as right_ph,
    this as this_ph,
)
from pathway_tpu_torch.internals.universe import Universe


class JoinMode(Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


class JoinResult:
    """Lazy join: holds both sides + conditions; `select` / `reduce`
    materialize."""

    def __init__(
        self,
        left,
        right,
        on: Sequence[Any],
        mode: JoinMode,
        id_expr: Any = None,
    ):
        if left is right:
            raise ValueError(
                "Cannot join table with itself. Use <table>.copy() as one "
                "of the arguments of the join."
            )
        self._left = left
        self._right = right
        self._mode = mode if isinstance(mode, JoinMode) else JoinMode(mode)
        self._join_mode = self._mode  # reference-public spelling
        self._id_expr = id_expr
        if id_expr is not None and not (
            isinstance(id_expr, ColumnReference)
            and id_expr.name == "id"
            and id_expr.table in (left, right, left_ph, right_ph)
        ):
            # AssertionError to match the reference's contract, raised
            # explicitly so python -O cannot strip it
            raise AssertionError(
                "join id= must be the id column of one side "
                "(left.id or right.id)"
            )
        if id_expr is not None:
            id_is_left = id_expr.table in (left, left_ph)
            # the id side must be preserved by the join mode, or padded
            # rows have no id (reference: KeyError at build)
            if (
                self._mode == JoinMode.OUTER
                or (self._mode == JoinMode.LEFT and not id_is_left)
                or (self._mode == JoinMode.RIGHT and id_is_left)
            ):
                raise KeyError(
                    "join id= side is not preserved by this join mode: "
                    "padded rows would have no id"
                )
        self._left_on: list[ColumnExpression] = []
        self._right_on: list[ColumnExpression] = []
        for cond in on:
            l_e, r_e = self._split_condition(cond)
            self._left_on.append(l_e)
            self._right_on.append(r_e)
        if not isinstance(left, JoinResult) and not isinstance(
            right, JoinResult
        ):
            _validate_join_condition_types(
                left, right, self._left_on, self._right_on
            )

    # --- condition handling ---------------------------------------------------

    def _side_of(self, e: ColumnExpression) -> str | None:
        side = None
        for ref in e._dependencies():
            tbl = ref.table
            if tbl is self._left or tbl is left_ph:
                s = "l"
            elif tbl is self._right or tbl is right_ph:
                s = "r"
            elif isinstance(tbl, ThisPlaceholder):
                s = None
            elif (id(tbl), ref.name) in getattr(
                self._left, "_join_aliases", {}
            ):
                s = "l"  # a table folded into the left side by a chained join
            elif (id(tbl), ref.name) in getattr(
                self._right, "_join_aliases", {}
            ):
                s = "r"
            else:
                # resolve tables same-universe: assume left
                s = "l" if tbl._universe is self._left._universe else "r"
            if s is not None:
                if side is None:
                    side = s
                elif side != s:
                    raise ValueError(
                        "join condition side mixes left and right columns"
                    )
        return side

    def _split_condition(self, cond: Any):
        if not (
            isinstance(cond, ColumnBinaryOpExpression) and cond._op == "=="
        ):
            raise ValueError(
                f"join condition must be <left-expr> == <right-expr>, got {cond!r}"
            )
        a, b = cond._left, cond._right
        sa, sb = self._side_of(a), self._side_of(b)
        if sa == "r" or sb == "l":
            # reference rejects swapped conditions outright: the left
            # operand must come from the left table
            raise ValueError(
                "join condition sides are swapped: write "
                "<left-col> == <right-col>"
            )
        from pathway_tpu_torch.internals.table import desugar

        l_e = desugar(a, {left_ph: self._left, this_ph: self._left})
        r_e = desugar(b, {right_ph: self._right, this_ph: self._right})

        def apply_aliases(e, table):
            aliases = getattr(table, "_join_aliases", None)
            if not aliases:
                return e

            def sub(ref):
                al = aliases.get((id(ref.table), ref.name))
                if al is not None:
                    return table[al]
                return None

            return wrap_expr(e)._substitute(sub)

        return apply_aliases(l_e, self._left), apply_aliases(r_e, self._right)

    # --- materialization ------------------------------------------------------

    def _build(self):
        from pathway_tpu_torch.internals.table import Table

        lnames = [f"_on{i}" for i in range(len(self._left_on))]
        left_cols = {n: self._left[n] for n in self._left.column_names()}
        left_prep = self._left._build_rowwise(
            {**left_cols, **dict(zip(lnames, self._left_on))}
        )
        right_cols = {n: self._right[n] for n in self._right.column_names()}
        right_prep = self._right._build_rowwise(
            {**right_cols, **dict(zip(lnames, self._right_on))}
        )
        id_from = None
        if self._id_expr is not None:
            ref = self._id_expr
            if isinstance(ref, ColumnReference):
                if ref.table is self._left or ref.table is left_ph:
                    id_from = "left"
                elif ref.table is self._right or ref.table is right_ph:
                    id_from = "right"
        node = nodes.JoinNode(
            left_prep._node,
            right_prep._node,
            lnames,
            lnames,
            self._mode.value,
            id_from=id_from,
        )
        return node, left_prep, right_prep

    def select(self, *args: Any, **kwargs: Any):
        joined, sub = self._joined_with_sub()

        exprs: dict[str, ColumnExpression] = {}

        def add_side(table, prefix):
            for n in table.column_names():
                if n.startswith("_on") or n.startswith("_pw_"):
                    continue
                exprs[n] = ColumnReference(joined, prefix + n)

        def add_slice(sl: ThisSlice):
            if sl._parent is right_ph:
                sides = [self._right]
            elif sl._parent is left_ph:
                sides = [self._left]
            else:  # pw.this: both sides, right winning collisions like
                sides = [self._left, self._right]  # bare pw.this expansion
            for side in sides:
                for out_name, ref in sl.resolve(side).items():
                    exprs[out_name] = ref

        for arg in args:
            if isinstance(arg, ThisSlice):
                add_slice(arg)
            elif isinstance(arg, ThisPlaceholder):
                add_side(self._left, "l.")
                add_side(self._right, "r.")
            elif isinstance(arg, ColumnReference):
                exprs[arg.name] = arg
            else:
                raise TypeError(arg)
        for name, e in kwargs.items():
            if isinstance(e, ThisSlice):  # `**pw.left.without(...)` etc.
                add_slice(e)
                continue
            if isinstance(e, ThisPlaceholder):  # `**pw.left` expansion
                if e is left_ph or e is this_ph:
                    add_side(self._left, "l.")
                if e is right_ph or e is this_ph:
                    add_side(self._right, "r.")
                continue
            exprs[name] = wrap_expr(e)

        resolved = {n: wrap_expr(e)._substitute(sub) for n, e in exprs.items()}
        return joined.select(**resolved)

    @property
    def _universe(self) -> Universe:
        joined, _sub = self._joined_with_sub()
        return joined._universe

    def _result_universe(self) -> Universe:
        """Universe of the joined table: fresh by default; with id= the
        keys come from one side, so the result lives in (a subset of) that
        side's universe — LEFT join keyed by left.id covers every left
        row and keeps the full universe."""
        ref = self._id_expr
        if isinstance(ref, ColumnReference):
            if ref.table is self._left or ref.table is left_ph:
                side, side_is_left = self._left, True
            else:
                side, side_is_left = self._right, False
            side_u = getattr(side, "_universe", None)
            if side_u is not None:
                keeps_all = (
                    self._mode == JoinMode.LEFT and side_is_left
                ) or (self._mode == JoinMode.RIGHT and not side_is_left)
                return side_u if keeps_all else side_u.subset()
        return Universe()

    def promise_universe_is_subset_of(self, other) -> "JoinResult":
        return self

    def promise_universes_are_equal(self, other) -> "JoinResult":
        return self

    def promise_universe_is_equal_to(self, other) -> "JoinResult":
        return self

    def _maybe_opt(self, d: dt.DType, side: str) -> dt.DType:
        m = self._mode
        if side == "l" and m in (JoinMode.RIGHT, JoinMode.OUTER):
            return dt.Optional_(d)
        if side == "r" and m in (JoinMode.LEFT, JoinMode.OUTER):
            return dt.Optional_(d)
        return d

    def _joined_with_sub(self):
        """Materialize the join with all columns of both sides, plus a
        substitution function mapping left/right/this references onto it."""
        if hasattr(self, "_joined_cache"):
            joined = self._joined_cache
            return joined, self._make_sub(joined)
        from pathway_tpu_torch.internals.table import Table

        node, left_prep, right_prep = self._build()
        joined = Table._from_node(
            node,
            {
                **{
                    "l." + n: self._maybe_opt(
                        left_prep._schema[n].dtype, side="l"
                    )
                    for n in left_prep.column_names()
                },
                **{
                    "r." + n: self._maybe_opt(
                        right_prep._schema[n].dtype, side="r"
                    )
                    for n in right_prep.column_names()
                },
                "_left_id": dt.Optional_(dt.POINTER),
                "_right_id": dt.Optional_(dt.POINTER),
                # nodes may append synthetic result columns past the ids
                # (e.g. the asof join's _pw_self_t) — typed ANY
                **{
                    n: dt.ANY
                    for n in node.column_names
                    if not n.startswith(("l.", "r."))
                    and n not in ("_left_id", "_right_id")
                },
            },
            self._result_universe(),
        )
        self._joined_cache = joined
        return joined, self._make_sub(joined)

    def _equated_names(self) -> set[str]:
        """Column names equated by the join condition (l.x == r.x): safe to
        reference through pw.this even though both sides carry them."""
        out = set()
        for l_e, r_e in zip(self._left_on, self._right_on):
            if (
                isinstance(l_e, ColumnReference)
                and isinstance(r_e, ColumnReference)
                and l_e.name == r_e.name
            ):
                out.add(l_e.name)
        return out

    def _make_sub(self, joined):
        left_aliases = getattr(self._left, "_join_aliases", {})
        right_aliases = getattr(self._right, "_join_aliases", {})

        def sub(ref: ColumnReference) -> ColumnReference | None:
            tbl = ref.table
            if tbl is joined:
                return None
            if tbl is self._left or tbl is left_ph:
                if ref.name == "id":
                    return ColumnReference(joined, "_left_id")
                return ColumnReference(joined, "l." + ref.name)
            if tbl is self._right or tbl is right_ph:
                if ref.name == "id":
                    return ColumnReference(joined, "_right_id")
                return ColumnReference(joined, "r." + ref.name)
            al = left_aliases.get((id(tbl), ref.name))
            if al is not None:
                return ColumnReference(joined, "l." + al)
            ar = right_aliases.get((id(tbl), ref.name))
            if ar is not None:
                return ColumnReference(joined, "r." + ar)
            from pathway_tpu_torch.internals.table import _DeferredThisIxTable

            if isinstance(tbl, _DeferredThisIxTable):
                # pw.this.ix(...) built against the join: resolve the
                # hidden pointer expression through this substitution, and
                # translate the looked-up column name to its prefixed form
                # on the materialized join table
                new = _DeferredThisIxTable(
                    wrap_expr(tbl._expr)._substitute(sub),
                    tbl._optional,
                    tbl._context,
                    tbl._allow_misses,
                )
                if getattr(tbl, "_source", None) is not None:
                    new._source = tbl._source
                name = ref.name
                in_l = name in self._left.column_names()
                in_r = name in self._right.column_names()
                if in_l and in_r and name not in self._equated_names():
                    raise KeyError(
                        f"column {name!r} is ambiguous in join; "
                        "use pw.left/pw.right"
                    )
                if in_l:
                    name = "l." + name
                elif in_r:
                    name = "r." + name
                return ColumnReference(new, name)
            if isinstance(tbl, ThisPlaceholder):
                if ref.name == "id":
                    return ColumnReference(joined, "id")
                in_l = ref.name in self._left.column_names()
                in_r = ref.name in self._right.column_names()
                if in_l and in_r:
                    if ref.name in self._equated_names():
                        # the join condition equates both copies; outer
                        # joins leave one side None on unmatched rows, so
                        # pw.this unifies them via coalesce (reference:
                        # join condition columns unify)
                        from pathway_tpu_torch.internals.expression import (
                            CoalesceExpression,
                        )

                        return CoalesceExpression(
                            ColumnReference(joined, "l." + ref.name),
                            ColumnReference(joined, "r." + ref.name),
                        )
                    raise KeyError(
                        f"column {ref.name!r} is ambiguous in join; "
                        "use pw.left/pw.right"
                    )
                if in_l:
                    return ColumnReference(joined, "l." + ref.name)
                if in_r:
                    return ColumnReference(joined, "r." + ref.name)
                raise ValueError(f"unknown column {ref.name!r} in join")
            return None

        return sub

    def _resolve_in_joined(self, e):
        joined, sub = self._joined_with_sub()
        return wrap_expr(e)._substitute(sub)

    def reduce(self, *args, **kwargs):
        joined, _sub = self._joined_with_sub()
        r_args = []
        for a in args:
            resolved = self._resolve_in_joined(a)
            if isinstance(resolved, ColumnReference):
                # keep the user-facing (unprefixed) output name
                orig = a.name if isinstance(a, ColumnReference) else resolved.name
                kwargs.setdefault(orig, resolved)
            else:
                r_args.append(resolved)
        r_kwargs = {n: self._resolve_in_joined(e) for n, e in kwargs.items()}
        return joined.groupby().reduce(*r_args, **r_kwargs)

    def groupby(self, *args, id=None, **kwargs):
        from pathway_tpu_torch.internals.groupbys import GroupedJoinResult

        joined, _sub = self._joined_with_sub()
        grouping = [self._resolve_in_joined(a) for a in args]
        gt = GroupedJoinResult(
            joined,
            grouping,
            set_id=id is not None,
        )
        gt._join_result = self
        return gt

    def filter(self, expression):
        import copy

        joined, _sub = self._joined_with_sub()
        filtered = joined.filter(self._resolve_in_joined(expression))
        out = copy.copy(self)
        out._joined_cache = filtered
        return out

    # --- chained joins --------------------------------------------------------

    def _flatten(self):
        """Fold this join into one table carrying every column of both
        sides, with an alias map so references to the ORIGINAL tables
        still resolve in further joins/selects (reference: chained joins,
        internals/joins.py JoinResult.join chaining)."""
        joined, _sub = self._joined_with_sub()
        # a column equi-joined under the same name on both sides is ONE
        # column of the result (values match): keep the left copy and
        # alias the right side to it (reference: chained select(*pw.this)
        # yields each on-column once)
        equi_names = {
            l_e.name
            for l_e, r_e in zip(self._left_on, self._right_on)
            if isinstance(l_e, ColumnReference)
            and isinstance(r_e, ColumnReference)
            and l_e.name == r_e.name
        }
        exprs: dict[str, Any] = {}
        aliases: dict[tuple[int, str], str] = {}
        for tbl, prefix, idcol in (
            (self._left, "l.", "_left_id"),
            (self._right, "r.", "_right_id"),
        ):
            sub_aliases = getattr(tbl, "_join_aliases", {})
            # each side's row id stays addressable after flattening
            # (chained conditions like t1.id == t2.id)
            id_hidden = f"_pw_id_{prefix[0]}"
            exprs[id_hidden] = ColumnReference(joined, idcol)
            aliases[(id(tbl), "id")] = id_hidden
            for key, v in sub_aliases.items():
                if key[1] == "id" or v.startswith("_pw_"):
                    # nested hidden columns (pure copies, nested ids) are
                    # carried through under fresh hidden names
                    carried = f"_pw_{prefix[0]}{v}" if not v.startswith("_pw_") else f"_pw_{prefix[0]}_{v[4:]}"
                    if v in tbl.column_names():
                        exprs[carried] = ColumnReference(joined, prefix + v)
                        aliases[key] = carried
            for n in tbl.column_names():
                if n.startswith("_on") or n.startswith("_pw_"):
                    continue
                if n in equi_names:
                    # an equi-joined column shows ONCE, coalesced when the
                    # right side can carry unmatched rows; the PURE copies
                    # live under hidden names so t1.col / t2.col refs (and
                    # further chained conditions on them) read one side
                    hidden = f"_pw_{prefix[0]}_{n}"
                    exprs[hidden] = ColumnReference(joined, prefix + n)
                    aliases[(id(tbl), n)] = hidden
                    for key, v in sub_aliases.items():
                        if v == n:
                            aliases[key] = hidden
                    if prefix == "l.":
                        if self._mode in (JoinMode.RIGHT, JoinMode.OUTER):
                            exprs[n] = CoalesceExpression(
                                ColumnReference(joined, "l." + n),
                                ColumnReference(joined, "r." + n),
                            )
                        else:
                            exprs[n] = ColumnReference(joined, "l." + n)
                    continue
                out_name = n
                while out_name in exprs:
                    out_name = "_" + out_name
                exprs[out_name] = ColumnReference(joined, prefix + n)
                aliases[(id(tbl), n)] = out_name
                for key, v in sub_aliases.items():
                    if v == n:
                        aliases[key] = out_name
        flat = joined.select(**exprs)
        flat._join_aliases = aliases
        return flat

    def join(self, other, *on, id=None, how=JoinMode.INNER):
        return JoinResult(self._flatten(), other, on, how, id_expr=id)

    def join_inner(self, other, *on, id=None):
        return self.join(other, *on, id=id, how=JoinMode.INNER)

    def join_left(self, other, *on, id=None):
        return self.join(other, *on, id=id, how=JoinMode.LEFT)

    def join_right(self, other, *on, id=None):
        return self.join(other, *on, id=id, how=JoinMode.RIGHT)

    def join_outer(self, other, *on, id=None):
        return self.join(other, *on, id=id, how=JoinMode.OUTER)


class OuterJoinResult(JoinResult):
    pass


def _validate_join_condition_types(left, right, left_on, right_on) -> None:
    """Equi-join conditions must relate compatible dtypes (own copy of
    ``validate_join_condition_types`` from the reference's
    ``stdlib/temporal/utils.py``; the temporal stdlib is not ported)."""
    for l_e, r_e in zip(left_on, right_on):
        ld = left._build_rowwise({"_pw_probe": l_e})._schema["_pw_probe"].dtype
        rd = (
            right._build_rowwise({"_pw_probe": r_e})
            ._schema["_pw_probe"]
            .dtype
        )
        if ld != dt.ANY and rd != dt.ANY and dt.lub(ld, rd) == dt.ANY:
            raise TypeError(
                f"Cannot join on columns of incompatible types {ld} "
                f"and {rd}."
            )
