"""The port's own copy of ``pathway_tpu/internals/sql.py``, whole (its own
tokenizer and parser; no sqlglot).

pw.sql — SQL façade over Table ops.

Counterpart of the reference's SQL API
(reference: python/pathway/internals/sql.py:613 — sqlglot-parsed subset:
select / join / group by / having / union / intersect, tested by
python/pathway/tests/test_sql.py). sqlglot is not in this image, so this
module ships its own tokenizer + recursive-descent parser covering the
same surface:

  SELECT [DISTINCT] expr [AS alias], ...
  FROM t [AS a] [[LEFT|RIGHT|FULL|INNER] JOIN t2 [AS b] ON cond]*
  [WHERE cond] [GROUP BY cols] [HAVING cond]
  [UNION [ALL] select | INTERSECT select | EXCEPT select]

Expressions: OR/AND/NOT, comparisons (= <> != < <= > >=), IS [NOT] NULL,
IN (literals), BETWEEN, arithmetic (+ - * / %), unary minus, literals,
parentheses, qualified columns (a.x), and the aggregates
SUM/COUNT/MIN/MAX/AVG (COUNT(*) included).
"""

from __future__ import annotations

import re
from typing import Any

from pathway_tpu_torch import reducers
from pathway_tpu_torch.internals.table import Table

_AGGS = {
    "sum": reducers.sum,
    "count": lambda *a: reducers.count(),
    "min": reducers.min,
    "max": reducers.max,
    "avg": reducers.avg,
}

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><>|!=|<=|>=|==|=|<|>|\+|-|\*|/|%|\(|\)|,|\.|;)
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "distinct", "from", "join", "inner", "left", "right", "full",
    "outer", "on", "where", "group", "by", "having", "union", "all",
    "intersect", "except", "as", "and", "or", "not", "is", "null", "in",
    "between", "true", "false", "case", "when", "then", "else", "end",
}


def _tokenize(q: str) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    i = 0
    while i < len(q):
        m = _TOKEN_RE.match(q, i)
        if not m:
            raise ValueError(f"SQL tokenize error at: {q[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind == "ws":
            continue
        if kind == "name" and text.lower() in _KEYWORDS:
            out.append(("kw", text.lower()))
        else:
            out.append((kind, text))  # type: ignore[arg-type]
    out.append(("eof", ""))
    return out


class _Scope:
    """Name resolution for one FROM clause: alias -> Table plus a flat
    name -> expression map (unique unqualified columns only)."""

    def __init__(self):
        self.tables: dict[str, Table] = {}
        self.flat: dict[str, Any] = {}
        self.ambiguous: set[str] = set()

    def add(self, alias: str, table: Table) -> None:
        self.tables[alias] = table
        for c in table.column_names():
            if c in self.flat or c in self.ambiguous:
                self.ambiguous.add(c)
                self.flat.pop(c, None)
            else:
                self.flat[c] = table[c]

    def col(self, name: str, qualifier: str | None = None):
        if qualifier is not None:
            if qualifier not in self.tables:
                raise ValueError(f"unknown table alias {qualifier!r}")
            return self.tables[qualifier][name]
        if name in self.ambiguous:
            raise ValueError(f"ambiguous column {name!r}: qualify it")
        if name not in self.flat:
            raise ValueError(f"unknown column {name!r}")
        return self.flat[name]

    def all_columns(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for alias, table in self.tables.items():
            for c in table.column_names():
                key = c if c not in self.ambiguous else f"{alias}_{c}"
                out[key] = table[c]
        return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]], tables: dict[str, Table]):
        self.toks = tokens
        self.i = 0
        self.env_tables = tables

    # --- token helpers --------------------------------------------------------

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, text: str | None = None) -> bool:
        k, v = self.peek()
        if k == kind and (text is None or v == text):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, text: str | None = None) -> str:
        k, v = self.next()
        if k != kind or (text is not None and v != text):
            raise ValueError(f"SQL parse error: expected {text or kind}, got {v!r}")
        return v

    # --- grammar --------------------------------------------------------------

    def parse(self) -> Table:
        left = self.parse_select()
        while True:
            k, v = self.peek()
            if (k, v) == ("kw", "union"):
                self.next()
                all_ = self.accept("kw", "all")
                right = self.parse_select()
                left = left.concat_reindex(right)
                if not all_:
                    left = _distinct(left)
            elif (k, v) == ("kw", "intersect"):
                self.next()
                right = self.parse_select()
                left = _intersect(left, right)
            elif (k, v) == ("kw", "except"):
                self.next()
                right = self.parse_select()
                left = _except(left, right)
            else:
                break
        self.accept("op", ";")
        if self.peek()[0] != "eof":
            raise ValueError(f"SQL parse error: trailing {self.peek()[1]!r}")
        return left

    def parse_select(self) -> Table:
        self.expect("kw", "select")
        distinct = self.accept("kw", "distinct")
        select_items = self.parse_select_list()
        self.expect("kw", "from")
        scope = self.parse_from()
        where = None
        if self.accept("kw", "where"):
            where = self.parse_expr(scope, agg_ok=False)
        group_cols = None
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_cols = [self.parse_column_ref(scope)]
            while self.accept("op", ","):
                group_cols.append(self.parse_column_ref(scope))
        having_maker = None
        if self.accept("kw", "having"):
            having_maker = self.parse_expr_deferred()

        # --- build -------------------------------------------------------------
        base = scope.result_table
        if where is not None:
            base = base.filter(where)
            scope.rebind(base)
        if group_cols is not None:
            gb_exprs = [scope.col(n, q) for q, n in group_cols]
            grouped = base.groupby(*gb_exprs)
            exprs: dict[str, Any] = {}
            for alias, make in select_items:
                if alias == "*":
                    raise NotImplementedError("SELECT * with GROUP BY")
                exprs[alias] = make(scope)
            if having_maker is not None:
                exprs["_having"] = having_maker(scope)
            result = grouped.reduce(**exprs)
            if having_maker is not None:
                result = result.filter(result._having).select(
                    *[result[c] for c in result.column_names() if c != "_having"]
                )
        else:
            if having_maker is not None:
                raise ValueError("HAVING requires GROUP BY")
            exprs = {}
            for alias, make in select_items:
                if alias == "*":
                    exprs.update(scope.all_columns())
                else:
                    exprs[alias] = make(scope)
            result = base.select(**exprs)
        if distinct:
            result = _distinct(result)
        return result

    def parse_select_list(self):
        items: list[tuple[str, Any]] = []
        auto = 0

        def one():
            nonlocal auto
            if self.accept("op", "*"):
                return [("*", None)]
            expr_start = self.i
            e = self.parse_expr_deferred()
            alias = None
            if self.accept("kw", "as"):
                alias = self.expect("name")
            elif self.peek()[0] == "name":
                alias = self.next()[1]
            if alias is None:
                span_toks = self.toks[expr_start : self.i]
                if len(span_toks) == 1 and span_toks[0][0] == "name":
                    alias = span_toks[0][1]
                elif (
                    len(span_toks) == 3
                    and span_toks[0][0] == "name"
                    and span_toks[1] == ("op", ".")
                    and span_toks[2][0] == "name"
                ):
                    # qualified column keeps its bare column name
                    alias = span_toks[2][1]
                else:
                    span = "".join(v for _k, v in span_toks)
                    auto += 1
                    alias = re.sub(r"\W+", "_", span).strip("_") or f"col{auto}"
            return [(alias, e)]

        items.extend(one())
        while self.accept("op", ","):
            items.extend(one())
        return items

    def parse_expr_deferred(self):
        """Parse an expression syntactically now, bind to a scope later."""
        start = self.i
        self._skip_expr()
        end = self.i
        toks = self.toks[start:end]

        def make(scope):
            sub = _Parser(toks + [("eof", "")], self.env_tables)
            return sub.parse_expr(scope, agg_ok=True)

        return make

    def _skip_expr(self, depth_stop: bool = True):
        """Advance past one expression (balanced parens, stop at top-level
        comma / clause keyword / eof)."""
        depth = 0
        stop_kw = {
            "from", "where", "group", "having", "union", "intersect",
            "except", "on", "join", "inner", "left", "right", "full", "as",
            "by", "all",
        }
        while True:
            k, v = self.peek()
            if k == "eof":
                return
            if k == "op" and v == "(":
                depth += 1
            elif k == "op" and v == ")":
                if depth == 0:
                    return
                depth -= 1
            elif depth == 0:
                if k == "op" and v in (",", ";"):
                    return
                if k == "kw" and v in stop_kw:
                    return
                if k == "name":
                    pk, pv = self.toks[self.i - 1]
                    # bare alias right after a completed expression
                    if pk in ("name", "num", "str") or pv in (")", "end"):
                        return
            self.i += 1

    def parse_from(self) -> "_FromScope":
        scope = _FromScope()
        alias, table = self.parse_table_ref()
        scope.add_base(alias, table)
        while True:
            k, v = self.peek()
            how = None
            if (k, v) == ("kw", "join"):
                self.next()
                how = "inner"
            elif (k, v) in (("kw", "inner"), ("kw", "left"), ("kw", "right"), ("kw", "full")):
                self.next()
                how = {"full": "outer"}.get(v, v)
                self.accept("kw", "outer")
                self.expect("kw", "join")
            else:
                break
            alias2, table2 = self.parse_table_ref()
            self.expect("kw", "on")
            scope.add_join(alias2, table2, how, self)
        return scope

    def parse_table_ref(self) -> tuple[str, Table]:
        name = self.expect("name")
        if name not in self.env_tables:
            raise ValueError(f"unknown table {name!r} in SQL query")
        alias = name
        if self.accept("kw", "as"):
            alias = self.expect("name")
        elif self.peek()[0] == "name":
            alias = self.next()[1]
        return alias, self.env_tables[name]

    def parse_column_ref(self, scope) -> tuple[str | None, str]:
        name = self.expect("name")
        if self.accept("op", "."):
            col = self.expect("name")
            return name, col
        return None, name

    # --- expression grammar (binds to scope immediately) ----------------------

    def parse_expr(self, scope, agg_ok: bool):
        return self.parse_or(scope, agg_ok)

    def parse_or(self, scope, agg_ok):
        left = self.parse_and(scope, agg_ok)
        while self.accept("kw", "or"):
            left = left | self.parse_and(scope, agg_ok)
        return left

    def parse_and(self, scope, agg_ok):
        left = self.parse_not(scope, agg_ok)
        while self.accept("kw", "and"):
            left = left & self.parse_not(scope, agg_ok)
        return left

    def parse_not(self, scope, agg_ok):
        if self.accept("kw", "not"):
            return ~self.parse_not(scope, agg_ok)
        return self.parse_cmp(scope, agg_ok)

    def parse_cmp(self, scope, agg_ok):
        left = self.parse_add(scope, agg_ok)
        k, v = self.peek()
        if (k, v) == ("kw", "is"):
            self.next()
            neg = self.accept("kw", "not")
            self.expect("kw", "null")
            cond = left.is_none()
            return ~cond if neg else cond
        if (k, v) == ("kw", "not"):
            # NOT IN / NOT BETWEEN
            self.next()
            k2, v2 = self.peek()
            if (k2, v2) == ("kw", "in"):
                self.next()
                return ~self._in_rest(left, scope, agg_ok)
            if (k2, v2) == ("kw", "between"):
                self.next()
                return ~self._between_rest(left, scope, agg_ok)
            raise ValueError("expected IN or BETWEEN after NOT")
        if (k, v) == ("kw", "in"):
            self.next()
            return self._in_rest(left, scope, agg_ok)
        if (k, v) == ("kw", "between"):
            self.next()
            return self._between_rest(left, scope, agg_ok)
        if k == "op" and v in ("=", "==", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            right = self.parse_add(scope, agg_ok)
            if v in ("=", "=="):
                return left == right
            if v in ("<>", "!="):
                return left != right
            if v == "<":
                return left < right
            if v == "<=":
                return left <= right
            if v == ">":
                return left > right
            return left >= right
        return left

    def _in_rest(self, left, scope, agg_ok):
        self.expect("op", "(")
        vals = [self._literal_or_expr(scope, agg_ok)]
        while self.accept("op", ","):
            vals.append(self._literal_or_expr(scope, agg_ok))
        self.expect("op", ")")
        cond = left == vals[0]
        for v in vals[1:]:
            cond = cond | (left == v)
        return cond

    def _between_rest(self, left, scope, agg_ok):
        lo = self.parse_add(scope, agg_ok)
        self.expect("kw", "and")
        hi = self.parse_add(scope, agg_ok)
        return (left >= lo) & (left <= hi)

    def _literal_or_expr(self, scope, agg_ok):
        return self.parse_add(scope, agg_ok)

    def parse_add(self, scope, agg_ok):
        left = self.parse_mul(scope, agg_ok)
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                right = self.parse_mul(scope, agg_ok)
                left = left + right if v == "+" else left - right
            else:
                return left

    def parse_mul(self, scope, agg_ok):
        left = self.parse_unary(scope, agg_ok)
        while True:
            k, v = self.peek()
            if k == "op" and v in ("*", "/", "%"):
                self.next()
                right = self.parse_unary(scope, agg_ok)
                if v == "*":
                    left = left * right
                elif v == "/":
                    left = left / right
                else:
                    left = left % right
            else:
                return left

    def parse_unary(self, scope, agg_ok):
        if self.accept("op", "-"):
            return -self.parse_unary(scope, agg_ok)
        return self.parse_atom(scope, agg_ok)

    def parse_atom(self, scope, agg_ok):
        k, v = self.peek()
        if k == "num":
            self.next()
            return float(v) if ("." in v) else int(v)
        if k == "str":
            self.next()
            return v[1:-1].replace("''", "'")
        if (k, v) == ("kw", "true"):
            self.next()
            return True
        if (k, v) == ("kw", "false"):
            self.next()
            return False
        if (k, v) == ("kw", "null"):
            self.next()
            return None
        if k == "op" and v == "(":
            self.next()
            e = self.parse_expr(scope, agg_ok)
            self.expect("op", ")")
            return e
        if (k, v) == ("kw", "case"):
            return self.parse_case(scope, agg_ok)
        if k == "name":
            name = self.next()[1]
            if self.accept("op", "("):
                fn = name.lower()
                if fn not in _AGGS:
                    raise ValueError(f"unknown SQL function {name!r}")
                if not agg_ok:
                    raise ValueError(f"aggregate {name!r} not allowed here")
                if self.accept("op", "*"):
                    self.expect("op", ")")
                    return _AGGS["count"]()
                arg = self.parse_expr(scope, agg_ok=False)
                self.expect("op", ")")
                return _AGGS[fn](arg)
            if self.accept("op", "."):
                col = self.expect("name")
                return scope.col(col, name)
            return scope.col(name)
        raise ValueError(f"SQL parse error at {v!r}")

    def parse_case(self, scope, agg_ok):
        from pathway_tpu_torch.internals.common import if_else

        self.expect("kw", "case")
        branches = []
        while self.accept("kw", "when"):
            cond = self.parse_expr(scope, agg_ok)
            self.expect("kw", "then")
            val = self.parse_expr(scope, agg_ok)
            branches.append((cond, val))
        default = None
        if self.accept("kw", "else"):
            default = self.parse_expr(scope, agg_ok)
        self.expect("kw", "end")
        out = default
        for cond, val in reversed(branches):
            out = if_else(cond, val, out)
        return out


class _FromScope(_Scope):
    """Scope that materializes joins into one flat result table."""

    def __init__(self):
        super().__init__()
        self.result_table: Table | None = None
        self._col_map: dict[tuple[str, str], str] = {}  # (alias, col) -> flat

    def add_base(self, alias: str, table: Table) -> None:
        self.add(alias, table)
        self.result_table = table
        for c in table.column_names():
            self._col_map[(alias, c)] = c

    def add_join(self, alias: str, table: Table, how: str, parser: _Parser):
        # ON-condition scope: existing aliases resolve through this scope's
        # rename map (collision-renamed columns bind to the right table);
        # the new alias resolves against the joining table directly
        outer = self

        class _OnScope:
            def col(self, name, qualifier=None):
                if qualifier == alias:
                    return table[name]
                if qualifier is not None:
                    return outer.col(name, qualifier)
                in_new = name in table.column_names()
                in_old = name in outer.flat or name in outer.ambiguous
                if in_new and in_old:
                    raise ValueError(f"ambiguous column {name!r}: qualify it")
                if in_new:
                    return table[name]
                return outer.col(name)

        cond = parser.parse_expr(_OnScope(), agg_ok=False)
        conds = [
            _orient_join_condition(c, self.result_table, table)
            for c in _conjuncts(cond)
        ]
        jr = self.result_table.join(table, *conds, how=how)
        # flatten: existing columns keep their flat names; new table's
        # columns get their names, prefixed on collision
        exprs: dict[str, Any] = {}
        for (a, c), flat in self._col_map.items():
            exprs[flat] = self.result_table[flat]
        new_map = dict(self._col_map)
        for c in table.column_names():
            flat = c
            if flat in exprs:
                flat = f"{alias}_{c}"
            exprs[flat] = table[c]
            new_map[(alias, c)] = flat
        flatt = jr.select(**exprs)
        # rebuild resolution over the flat table
        from collections import Counter

        self.result_table = flatt
        self._col_map = new_map
        self.tables = {a: flatt for a in list(self.tables) + [alias]}
        cnt = Counter(c for (_a, c) in new_map)
        self.ambiguous = {c for c, n in cnt.items() if n > 1}
        self.flat = {
            c: flatt[f]
            for (_a, c), f in new_map.items()
            if c not in self.ambiguous
        }

    def rebind(self, new_table: Table) -> None:
        """After filter(): rebind column references to the filtered table."""
        self.result_table = new_table
        self.tables = {a: new_table for a in self.tables}
        self.flat = {
            n: new_table[n]
            for n in self.flat
            if n in new_table.column_names()
        }

    def col(self, name: str, qualifier: str | None = None):
        if qualifier is not None and (qualifier, name) in self._col_map:
            return self.result_table[self._col_map[(qualifier, name)]]
        return super().col(name, qualifier)


def _orient_join_condition(cond, left_table, right_table):
    """SQL places no order on equality operands (ON b.k = a.k is valid);
    Table.join requires <left> == <right>, so flip swapped conjuncts."""
    from pathway_tpu_torch.internals.expression import (
        ColumnBinaryOpExpression,
        ColumnReference,
    )

    if not (
        isinstance(cond, ColumnBinaryOpExpression) and cond._op == "=="
    ):
        return cond

    def side(e):
        for ref in e._dependencies():
            if isinstance(ref, ColumnReference):
                if ref.table is left_table:
                    return "l"
                if ref.table is right_table:
                    return "r"
        return None

    if side(cond._left) == "r" and side(cond._right) == "l":
        return ColumnBinaryOpExpression("==", cond._right, cond._left)
    return cond


def _conjuncts(e):
    """Split a parsed ON condition on top-level AND so composite-key joins
    reach Table.join as separate equality conditions."""
    from pathway_tpu_torch.internals.expression import ColumnBinaryOpExpression

    if isinstance(e, ColumnBinaryOpExpression) and e._op == "&":
        return _conjuncts(e._left) + _conjuncts(e._right)
    return [e]


def _distinct(t: Table) -> Table:
    cols = t.column_names()
    return t.groupby(*[t[c] for c in cols]).reduce(*[t[c] for c in cols])


def _intersect(a: Table, b: Table) -> Table:
    cols = a.column_names()
    da, db = _distinct(a), _distinct(b)
    jr = da.join(
        db, *[da[c] == db[c] for c in cols], how="inner"
    )
    return jr.select(**{c: da[c] for c in cols})


def _except(a: Table, b: Table) -> Table:
    cols = a.column_names()
    da, db = _distinct(a), _distinct(b)
    jr = da.join(db, *[da[c] == db[c] for c in cols], how="left")
    marked = jr.select(
        **{c: da[c] for c in cols}, _hit=db.id.is_not_none()
    )
    kept = marked.filter(~marked._hit)
    return kept.select(*[kept[c] for c in cols])


def sql(query: str, **tables: Table) -> Table:
    """Execute a SQL query over the given tables
    (reference: pw.sql, internals/sql.py:613)."""
    return _Parser(_tokenize(query), tables).parse()
