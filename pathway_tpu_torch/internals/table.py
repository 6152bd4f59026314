"""The port's own copy of ``pathway_tpu/internals/table.py``. pw.Table — the declarative table API.

Capability parity with the reference Table (upstream Pathway: python/pathway/
internals/table.py:52: select:382, filter:490, groupby:942, reduce:1025,
ix:1164, concat:1334, update_cells:1439, with_universe_of:2037, flatten:2089,
sort:2157). Methods *declare* engine nodes (pathway_tpu/engine/nodes.py); the
runtime executes them as columnar microbatches.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Sequence

from pathway_tpu_torch.engine import nodes
from pathway_tpu_torch.engine.expression_eval import InternalColRef
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    PointerExpression,
    wrap_expr,
)
from pathway_tpu_torch.internals.thisclass import ThisPlaceholder, ThisSlice, this
from pathway_tpu_torch.internals.universe import Universe


class _ColumnNamespace:
    """Attribute/item access that always resolves to columns."""

    def __init__(self, owner: Any):
        object.__setattr__(self, "_owner", owner)

    def __getattr__(self, name: str):
        if name.startswith("__") or name.startswith("_ipython"):
            # dunder/introspection probes (deepcopy, pickle, IPython) must
            # fall through — a ThisPlaceholder owner would otherwise mint a
            # ColumnReference for ANY name
            raise AttributeError(name)
        try:
            return self._owner[name]
        except KeyError:
            # __getattr__ must raise AttributeError so hasattr/getattr
            # defaults work
            raise AttributeError(name) from None

    def __getitem__(self, name: str):
        return self._owner[name]


class TableLike:
    _universe: Universe


class Joinable(TableLike):
    pass


# ---------------------------------------------------------------------------
# Expression desugaring / resolution helpers


def desugar(e: Any, mapping: Mapping[ThisPlaceholder, "Table"]) -> ColumnExpression:
    """Substitute pw.this / pw.left / pw.right placeholders with tables."""
    e = wrap_expr(e)

    def sub(ref: ColumnReference) -> ColumnExpression | None:
        tbl = ref.table
        if isinstance(tbl, ThisSlice):
            target = mapping.get(tbl._parent) or mapping.get(this)
            if target is None:
                raise ValueError(f"cannot resolve {tbl!r} in this context")
            # sliced-away names fail loudly (reference: slice access error)
            return tbl.resolve_ref(target, ref.name)
        if isinstance(tbl, ThisPlaceholder):
            target = mapping.get(tbl)
            if target is None:
                raise ValueError(f"cannot resolve {tbl!r} in this context")
            if ref.name == "id":
                return ColumnReference(target, "id")
            return target[ref.name]
        if isinstance(tbl, _DeferredIxTable):
            if tbl._contains_reducer():
                # pointer computed by a reducer: materialization belongs
                # to GroupedTable.reduce (post-aggregation ix lookup)
                return None
            caller = mapping.get(this)
            if caller is None:
                raise ValueError(
                    "ix_ref() without table-bound arguments can only be "
                    "used inside a table operation (select/filter/...)"
                )
            return tbl._materialize(caller)[ref.name]
        if isinstance(tbl, ThisPlaceholder.__mro__[0]):
            return None
        return None

    return e._substitute(sub)


class _DeferredIxTable:
    """`table.ix_ref(...)` whose indexer universe isn't known yet — the
    args reference no concrete table (constants or pw.this). Column
    accesses return references that desugar() materializes against the
    CALLING operation's table (reference: ix expressions resolve in the
    select's context), enabling e.g. the singleton-broadcast pattern
    ``t.select(v=t.reduce(v=1).ix_ref().v)``."""

    def __init__(
        self,
        source: "Table",
        args: tuple,
        optional: bool,
        instance,
        raw_expr: bool = False,
    ):
        self._source = source
        self._args = args
        self._optional = optional
        self._instance = instance
        self._raw_expr = raw_expr  # args[0] IS the pointer expression
        self._cache: dict[int, "Table"] = {}

    def _materialize(self, caller: "Table") -> "Table":
        key = id(caller)
        if key not in self._cache:
            self._keepalive = getattr(self, "_keepalive", [])
            self._keepalive.append(caller)  # pin: id() reuse after GC
                                            # would alias a dead table
            if self._raw_expr:
                ptr = caller._desugar(self._args[0])
            else:
                ptr = caller.pointer_from(
                    *[caller._desugar(a) for a in self._args],
                    instance=(
                        caller._desugar(self._instance)
                        if self._instance is not None
                        else None
                    ),
                )
            self._cache[key] = self._source.ix(
                ptr, optional=self._optional, context=caller
            )
        return self._cache[key]

    def __getitem__(self, name) -> Any:
        if isinstance(name, (list, tuple)):
            # column slice: a tuple of refs so select(*ix(...)[["a","b"]])
            # unpacks (reference: ix(...)[[...]] usage)
            return tuple(ColumnReference(self, n) for n in name)
        return ColumnReference(self, name)

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("_"):
            raise AttributeError(name)
        return ColumnReference(self, name)

    def _pointer_exprs(self):
        return [wrap_expr(a) for a in self._args]

    def _contains_reducer(self) -> bool:
        return any(_expr_contains_reducer(e) for e in self._pointer_exprs())


def _expr_contains_reducer(e) -> bool:
    from pathway_tpu_torch.internals.expression import ReducerExpression

    if isinstance(e, ReducerExpression):
        return True
    return any(_expr_contains_reducer(c) for c in e._children)


class _DeferredThisIxTable(_DeferredIxTable):
    """``pw.this.ix(expr)`` — both the indexed table AND the pointer
    expression resolve against the CALLING operation's table (reference:
    this.ix inside groupby-reduce, e.g.
    ``reduce(owner=pw.this.ix(pw.reducers.argmax(pw.this.age)).owner)``)."""

    def __init__(self, expr, optional: bool, context, allow_misses: bool):
        self._expr = expr
        self._optional = optional
        self._context = context
        self._allow_misses = allow_misses
        self._cache = {}

    def _materialize(self, caller: "Table") -> "Table":
        key = id(caller)
        if key not in self._cache:
            self._keepalive = getattr(self, "_keepalive", [])
            self._keepalive.append(caller)
            # resolve pw.this against the caller FIRST — otherwise
            # Table.ix sees an unresolved placeholder and re-defers
            self._cache[key] = caller.ix(
                caller._desugar(self._expr),
                optional=self._optional,
                context=self._context,
                allow_misses=self._allow_misses,
            )
        return self._cache[key]

    def _pointer_exprs(self):
        from pathway_tpu_torch.internals.expression import wrap_expr

        return [wrap_expr(self._expr)]


def _require_related_universes(primary: "Table", other: "Table") -> None:
    """Row-aligned multi-table expressions need provably related key sets:
    the same universe or a promised subset relation either way (reference:
    the universe solver rejects cross-universe column mixing)."""
    pu, ou = primary._universe, other._universe
    if pu is ou or ou.is_subset_of(pu) or pu.is_subset_of(ou):
        return
    raise ValueError(
        "expression mixes columns of tables over unrelated universes; "
        "use with_universe_of / pw.universes.promise_is_subset_of to "
        "assert how their key sets relate"
    )


def _collect_tables(exprs: Iterable[ColumnExpression]) -> list["Table"]:
    tables: list[Table] = []
    for e in exprs:
        for ref in e._dependencies():
            tbl = ref.table
            if isinstance(tbl, Table) and all(t is not tbl for t in tables):
                tables.append(tbl)
    return tables


def resolve_to_internal(
    exprs: Mapping[str, ColumnExpression], input_tables: Sequence["Table"]
) -> dict[str, ColumnExpression]:
    """Rewrite ColumnReferences into (input_index, name) InternalColRefs."""

    def sub(ref: ColumnReference) -> ColumnExpression | None:
        tbl = ref.table
        for i, t in enumerate(input_tables):
            if tbl is t:
                return InternalColRef(i, ref.name)
        raise ValueError(
            "reducers can only be used inside groupby(...).reduce(...)"
            if isinstance(tbl, _DeferredIxTable) and tbl._contains_reducer()
            else f"expression references table {tbl!r} which is not an input "
            "of this operation (universes may differ)"
        )

    return {name: e._substitute(sub) for name, e in exprs.items()}


# ---------------------------------------------------------------------------
# dtype inference (lightweight type interpreter —
# reference: internals/type_interpreter.py)


_CMP_OP_NAMES = {
    "==": "eq", "!=": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"
}


def _dtype_hint(d: dt.DType) -> str:
    """typing-style rendering used in comparison error messages
    (reference type_interpreter wording: tuple[int, str], int | None)."""
    if isinstance(d, dt.OptionalDType):
        return f"{_dtype_hint(d.wrapped)} | None"
    if isinstance(d, dt.TupleDType) and d.args is not None:
        return "tuple[" + ", ".join(_dtype_hint(a) for a in d.args) + "]"
    hint = d.typehint
    return getattr(hint, "__name__", str(hint))


def _elements_comparable(op: str, a: dt.DType, b: dt.DType) -> bool:
    """Recursive element compatibility for tuple/list comparisons
    (reference: _eval_binary_op_on_tuples broadcast semantics). Ordering
    ops reject optional elements at any depth; eq/ne tolerate NONE
    against anything."""
    ordering = op in ("<", "<=", ">", ">=")
    if ordering and (a.is_optional() or b.is_optional()):
        return False
    sa, sb = a.strip_optional(), b.strip_optional()
    if sa == dt.ANY or sb == dt.ANY:
        return True
    if not ordering and (sa == dt.NONE or sb == dt.NONE):
        return True
    if ordering and (sa == dt.NONE or sb == dt.NONE):
        return False
    la = isinstance(sa, dt.TupleDType) and sa.args is not None
    lb = isinstance(sb, dt.TupleDType) and sb.args is not None
    if la or lb or isinstance(sa, dt.ListDType) or isinstance(sb, dt.ListDType):
        return _tuple_like_comparable(op, sa, sb)
    if sa == sb:
        return True
    if sa in (dt.INT, dt.FLOAT) and sb in (dt.INT, dt.FLOAT):
        return True
    return False


def _tuple_like_comparable(op: str, sl: dt.DType, sr: dt.DType) -> bool:
    """Pairwise (with list broadcast) compatibility of two tuple-like
    dtypes."""
    l_args = sl.args if isinstance(sl, dt.TupleDType) else None
    r_args = sr.args if isinstance(sr, dt.TupleDType) else None
    if l_args is not None and r_args is not None:
        if len(l_args) != len(r_args):
            return op in ("==", "!=")
        return all(
            _elements_comparable(op, a, b) for a, b in zip(l_args, r_args)
        )
    l_elt = sl.wrapped if isinstance(sl, dt.ListDType) else None
    r_elt = sr.wrapped if isinstance(sr, dt.ListDType) else None
    if l_elt is not None and r_args is not None:
        return all(_elements_comparable(op, l_elt, b) for b in r_args)
    if r_elt is not None and l_args is not None:
        return all(_elements_comparable(op, a, r_elt) for a in l_args)
    if l_elt is not None and r_elt is not None:
        return _elements_comparable(op, l_elt, r_elt)
    return True  # untyped tuple-likes: no static information to gate on


def _check_tuple_comparable(op: str, l: dt.DType, r: dt.DType) -> None:
    """Reject comparisons of tuples/lists with incompatible element types,
    and orderings over tuples with optional elements (reference:
    test_operators.py tuple comparison type errors)."""

    def tuple_like(d: dt.DType) -> bool:
        s = d.strip_optional()
        return (
            isinstance(s, dt.TupleDType) and s.args is not None
        ) or isinstance(s, dt.ListDType)

    if not (tuple_like(l) and tuple_like(r)):
        return
    if not _tuple_like_comparable(op, l.strip_optional(), r.strip_optional()):
        raise TypeError(
            f"Pathway does not support using binary operator "
            f"{_CMP_OP_NAMES[op]} on columns of types "
            f"{_dtype_hint(l)}, {_dtype_hint(r)}."
        )


def infer_dtype(e: ColumnExpression, env) -> dt.DType:
    if isinstance(e, ColumnReference):
        if e.name == "id":
            return dt.POINTER
        return env(e)
    if isinstance(e, InternalColRef):
        return dt.ANY
    if isinstance(e, expr_mod.ColumnConstExpression):
        return dt.dtype_of_value(e._value)
    if isinstance(e, expr_mod.ColumnBinaryOpExpression):
        l = infer_dtype(e._left, env)
        r = infer_dtype(e._right, env)
        op = e._op
        if op in ("==", "!=", "<", "<=", ">", ">="):
            _check_tuple_comparable(op, l, r)
            return dt.BOOL
        if op in ("<<", ">>"):
            # shifts are defined on (int, int) only (reference
            # operator_mapping: Lshift/Rshift over INT)
            if (
                l.strip_optional() not in (dt.INT, dt.ANY)
                or r.strip_optional() not in (dt.INT, dt.ANY)
            ):
                name = "lshift" if op == "<<" else "rshift"
                raise TypeError(
                    f"Pathway does not support using binary operator "
                    f"{name} on columns of types {_dtype_hint(l)}, "
                    f"{_dtype_hint(r)}."
                )
            return dt.INT
        if op == "/":
            return dt.FLOAT
        if op in ("&", "|", "^") and l == dt.BOOL and r == dt.BOOL:
            return dt.BOOL
        if op == "+" and (l == dt.STR or r == dt.STR):
            return dt.STR
        out = dt.lub(l, r)
        return out
    if isinstance(e, expr_mod.ColumnUnaryOpExpression):
        return infer_dtype(e._expr, env)
    if isinstance(e, expr_mod.IfElseExpression):
        return dt.lub(infer_dtype(e._then, env), infer_dtype(e._else, env))
    if isinstance(e, expr_mod.CoalesceExpression):
        out = infer_dtype(e._args[-1], env)
        for a in e._args[:-1]:
            out = dt.lub(infer_dtype(a, env).strip_optional(), out)
        return out
    if isinstance(e, expr_mod.RequireExpression):
        return dt.Optional_(infer_dtype(e._val, env))
    if isinstance(e, expr_mod.FillErrorExpression):
        return dt.lub(
            infer_dtype(e._expr, env), infer_dtype(e._replacement, env)
        )
    if isinstance(e, (expr_mod.IsNoneExpression, expr_mod.IsNotNoneExpression)):
        return dt.BOOL
    if isinstance(e, expr_mod.UnwrapExpression):
        return infer_dtype(e._expr, env).strip_optional()
    if isinstance(e, (expr_mod.CastExpression, expr_mod.DeclareTypeExpression)):
        return e._target
    if isinstance(e, expr_mod.ConvertExpression):
        return e._target
    if isinstance(e, expr_mod.ToStringExpression):
        return dt.STR
    if isinstance(e, expr_mod.MakeTupleExpression):
        return dt.TupleDType(tuple(infer_dtype(a, env) for a in e._args))
    if isinstance(e, expr_mod.GetExpression):
        from pathway_tpu_torch.internals.json import Json as _Json

        outer = infer_dtype(e._expr, env)
        inner = outer.strip_optional()
        if inner == dt.JSON:
            if outer.is_optional():
                # .get()/[] on Json|None is a build-time error
                # (reference type_interpreter: test_json_get_none)
                raise TypeError(f"Cannot get from {_Json | None}.")
            if e._check_if_exists:
                ddt = infer_dtype(e._default, env)
                if ddt not in (
                    dt.JSON,
                    dt.Optional_(dt.JSON),
                    dt.NONE,
                    dt.ANY,
                    dt.ANY_TUPLE,
                ):
                    raise TypeError(
                        f"Default must be of type {_Json | None}, "
                        f"found {ddt.typehint}."
                    )
            return dt.Optional_(dt.JSON) if e._check_if_exists else dt.JSON
        # tuple / list sequence access (reference type_interpreter
        # SequenceGet rules, tests/test_common.py sequence_get_*)
        idx_e = e._index
        static_idx = (
            idx_e._value
            if isinstance(idx_e, expr_mod.ColumnConstExpression)
            and isinstance(idx_e._value, int)
            else None
        )
        default_dt = infer_dtype(e._default, env)
        if isinstance(inner, dt.TupleDType) and inner.args is not None:
            args = inner.args
            if static_idx is not None:
                in_range = -len(args) <= static_idx < len(args)
                if in_range:
                    elem = args[static_idx]
                    if e._check_if_exists:
                        return dt.lub(elem, default_dt)
                    return elem
                if not e._check_if_exists:
                    raise IndexError(
                        f"Index {static_idx} out of range for a tuple of "
                        f"type {inner.typehint}."
                    )
                import warnings as _warnings

                _warnings.warn(
                    f"Index {static_idx} out of range for a tuple of type "
                    f"{inner.typehint}. The default value will be used. "
                    "Consider using just the default value without .get().",
                    stacklevel=2,
                )
                return default_dt
            # dynamic index
            elem = args[0]
            for a in args[1:]:
                elem = dt.lub(elem, a)
            if e._check_if_exists:
                return dt.lub(dt.Optional_(elem), default_dt)
            return dt.ANY
        if isinstance(inner, dt.ListDType):
            elem = inner.wrapped
            if e._check_if_exists:
                return dt.lub(dt.Optional_(elem), default_dt)
            return elem
        return dt.ANY
    if isinstance(e, PointerExpression):
        return dt.Optional_(dt.POINTER) if e._optional else dt.POINTER
    if isinstance(e, expr_mod.MethodCallExpression):
        return e._return_type
    if isinstance(e, expr_mod.ApplyExpression):
        return e._return_type
    if isinstance(e, expr_mod.ReducerExpression):
        from pathway_tpu_torch.internals.reducer_descriptors import reducer_return_dtype

        return reducer_return_dtype(e, env)
    return dt.ANY


# ---------------------------------------------------------------------------


class Table(Joinable):
    """A (possibly live) table: universe of keys + typed columns."""

    def __init__(
        self,
        node: nodes.Node,
        schema: schema_mod.SchemaMetaclass,
        universe: Universe,
    ):
        assert list(schema.column_names()) == list(node.column_names), (
            schema.column_names(),
            node.column_names,
        )
        self._node = node
        self._schema = schema
        self._universe = universe
        # static-analysis metadata: the universe this node's rows live on
        # (pathway_tpu/analysis re-checks universe relations over the
        # declared graph and surfaces them as diagnostics)
        node._universe = universe
        # ... and the declared column dtypes, so the Plane Doctor can
        # spot object columns headed for the wire/segment pickle
        # fallback (analysis/plane.py pickle-hot-path) without running
        # the encoders
        node._column_dtypes = {
            name: schema[name].dtype for name in schema.column_names()
        }

    # --- metadata -------------------------------------------------------------

    @property
    def schema(self) -> schema_mod.SchemaMetaclass:
        return self._schema

    @property
    def id(self) -> ColumnReference:
        return ColumnReference(self, "id")

    def column_names(self) -> list[str]:
        return list(self._schema.column_names())

    def keys(self):
        return self.column_names()

    @property
    def C(self) -> "_ColumnNamespace":
        """Column-only access namespace: ``t.C.select`` is the COLUMN named
        'select' even though the table has a method of that name
        (reference: Table.C / test_colnamespace.py)."""
        return _ColumnNamespace(self)

    def typehints(self) -> dict[str, Any]:
        return self._schema.typehints()

    def __repr__(self) -> str:
        cols = ", ".join(self.column_names())
        return f"<pw.Table#{self._node.id}({cols})>"

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__"):
            raise AttributeError(name)
        if name.startswith("_") and name not in self.__dict__.get(
            "_schema", schema_mod.Schema
        ).__columns__:
            raise AttributeError(name)
        if name not in self._schema.__columns__:
            raise AttributeError(
                f"Table has no column {name!r}; columns: {self.column_names()}"
            )
        return ColumnReference(self, name)

    def __getitem__(self, arg):
        if isinstance(arg, str):
            if arg == "id":
                return self.id
            if arg not in self._schema.__columns__:
                raise KeyError(arg)
            return ColumnReference(self, arg)
        if isinstance(arg, ColumnReference):
            return ColumnReference(self, arg.name)
        if isinstance(arg, (list, tuple)):
            refs = [self[c] for c in arg]
            return self.select(*refs)
        raise TypeError(arg)

    def __iter__(self):
        # *table expands to its column references (reference: Table.__iter__)
        return iter([self[n] for n in self.column_names()])

    # --- internal constructors ------------------------------------------------

    @staticmethod
    def _from_node(
        node: nodes.Node,
        dtypes: Mapping[str, dt.DType],
        universe: Universe,
    ) -> "Table":
        cols = {
            name: schema_mod.ColumnSchema(name=name, dtype=d)
            for name, d in dtypes.items()
        }
        schema = schema_mod.schema_from_columns(cols)
        return Table(node, schema, universe)

    def _dtype_env(self):
        def env(ref: ColumnReference) -> dt.DType:
            tbl = ref.table
            if isinstance(tbl, Table):
                if ref.name == "id":
                    return dt.POINTER
                cs = tbl._schema.__columns__.get(ref.name)
                return cs.dtype if cs else dt.ANY
            return dt.ANY

        return env

    def _desugar(self, e: Any) -> ColumnExpression:
        return desugar(e, {this: self})

    def _build_rowwise(
        self,
        exprs: dict[str, ColumnExpression],
        universe: Universe | None = None,
        deterministic: bool = True,
    ) -> "Table":
        exprs = {n: self._desugar(e) for n, e in exprs.items()}
        tables = _collect_tables(exprs.values())
        if self in tables:
            tables.remove(self)
        for t in tables:
            _require_related_universes(self, t)
        input_tables = [self] + tables
        for t in tables:
            if t._universe is not self._universe and not (
                self._universe.is_subset_of(t._universe)
            ):
                # allow: reference requires same universe; we allow subset reads
                pass
        env = self._dtype_env()
        dtypes = {name: infer_dtype(e, env) for name, e in exprs.items()}
        internal = resolve_to_internal(exprs, input_tables)
        node = nodes.RowwiseNode(
            [t._node for t in input_tables], internal, deterministic=deterministic
        )
        return Table._from_node(node, dtypes, universe or self._universe)

    # --- core ops -------------------------------------------------------------

    def select(self, *args: Any, **kwargs: Any) -> "Table":
        exprs: dict[str, ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, ThisSlice):
                for n, ref in arg.resolve(self).items():
                    exprs[n] = ref
            elif isinstance(arg, ThisPlaceholder):
                for n in self.column_names():
                    exprs[n] = self[n]
            elif isinstance(arg, ColumnReference):
                if isinstance(arg.table, ThisPlaceholder):
                    exprs[arg.name] = self[arg.name]
                else:
                    exprs[arg.name] = arg
            elif isinstance(arg, Table):
                for n in arg.column_names():
                    exprs[n] = arg[n]
            else:
                raise TypeError(f"positional select argument {arg!r}")
        for name, e in kwargs.items():
            if isinstance(e, ThisPlaceholder):  # `**pw.this` expansion
                for n in self.column_names():
                    exprs[n] = self[n]
                continue
            if isinstance(e, ThisSlice):  # `**pw.this.without(...)` etc.
                for n, ref in e.resolve(self).items():
                    exprs[n] = ref
                continue
            from pathway_tpu_torch.internals.table_slice import TableSlice

            if isinstance(e, TableSlice):
                for n in e.keys():
                    exprs[n] = e[n]
                continue
            exprs[name] = wrap_expr(e)
        return self._build_rowwise(exprs)

    def with_columns(self, *args: Any, **kwargs: Any) -> "Table":
        kwargs = {
            # `**pw.this` is the identity here: all columns already kept
            n: e
            for n, e in kwargs.items()
            if not isinstance(e, ThisPlaceholder)
        }
        exprs: dict[str, Any] = {n: self[n] for n in self.column_names()}
        for arg in args:
            if isinstance(arg, ColumnReference):
                exprs[arg.name] = arg
            elif isinstance(arg, ThisSlice):
                exprs.update(arg.resolve(self))
            elif isinstance(arg, Table):
                for n in arg.column_names():
                    exprs[n] = arg[n]
        exprs.update(kwargs)
        return self.select(**exprs)

    def without(self, *columns: Any) -> "Table":
        drop = {c if isinstance(c, str) else c.name for c in columns}
        keep = [c for c in self.column_names() if c not in drop]
        return self.select(*[self[c] for c in keep])

    def rename(self, names_mapping: Mapping | None = None, **kwargs) -> "Table":
        if names_mapping is not None:
            return self.rename_by_dict(names_mapping)
        return self.rename_columns(**kwargs)

    def rename_columns(self, **kwargs: Any) -> "Table":
        # new_name=old_ref; reference column order: untouched columns stay
        # in place, renamed ones append in kwargs order
        renamed_src = {
            (old if isinstance(old, str) else old.name): new
            for new, old in kwargs.items()
        }
        exprs = {
            n: self[n]
            for n in self.column_names()
            if n not in renamed_src
        }
        for new, old in kwargs.items():
            exprs[new] = self[old if isinstance(old, str) else old.name]
        return self.select(**exprs)

    def rename_by_dict(self, names_mapping: Mapping) -> "Table":
        mapping = {
            (k if isinstance(k, str) else k.name): (
                v if isinstance(v, str) else v.name
            )
            for k, v in names_mapping.items()
        }
        exprs = {
            mapping.get(n, n): self[n] for n in self.column_names()
        }
        return self.select(**exprs)

    @staticmethod
    def from_columns(*args: Any, **kwargs: Any) -> "Table":
        """Build a table from same-universe columns (reference:
        Table.from_columns, internals/table.py)."""
        cols: dict[str, Any] = {}
        for arg in args:
            cols[arg.name] = arg
        cols.update(kwargs)
        if not cols:
            raise ValueError("Table.from_columns() requires columns")
        first = next(iter(cols.values())).table
        return first.select(**cols)

    def remove_errors(self) -> "Table":
        """Drop rows containing an ERROR value in any column (reference:
        Table.remove_errors, internals/table.py; engine filter_out_errors).
        """
        from pathway_tpu_torch.internals.common import apply_with_type

        cols = [self[n] for n in self.column_names()]
        probe = apply_with_type(lambda *_v: True, bool, *cols)
        import pathway_tpu_torch as pw

        return self.filter(pw.fill_error(probe, False))

    def filter(self, filter_expression: Any) -> "Table":
        e = self._desugar(filter_expression)
        tables = _collect_tables([e])
        if any(t is not self for t in tables):
            # precompute the predicate as a column on self's universe
            with_pred = self._build_rowwise(
                {**{n: self[n] for n in self.column_names()}, "_pred": e}
            )
            filtered = with_pred.filter(with_pred._pred)
            return filtered.without("_pred")
        internal = resolve_to_internal({"p": e}, [self])["p"]
        node = nodes.FilterNode(self._node, internal)
        out = Table(
            node, self._schema, self._universe.subset()
        )
        return out

    def copy(self) -> "Table":
        return self.select(*[self[n] for n in self.column_names()])

    # --- time-column operators (reference: Table._buffer/_forget/_freeze,
    # internals/table.py:666-737; engine: time_column.rs) ---------------------

    def _buffer(self, threshold_column: Any, time_column: Any) -> "Table":
        """Postpone rows until `time_column`'s watermark passes their
        `threshold_column`."""
        from pathway_tpu_torch.engine.nodes import BufferNode
        from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
            _temporal_table,
        )

        return _temporal_table(
            self,
            BufferNode,
            self._desugar(threshold_column),
            self._desugar(time_column),
        )

    def _forget(
        self,
        threshold_column: Any,
        time_column: Any,
        mark_forgetting_records: bool = False,
    ) -> "Table":
        """Retract rows once `time_column`'s watermark passes their
        `threshold_column` — bounds state for cutoff behaviors."""
        from pathway_tpu_torch.engine.nodes import ForgetNode
        from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
            _temporal_table,
        )

        return _temporal_table(
            self,
            ForgetNode,
            self._desugar(threshold_column),
            self._desugar(time_column),
            mark_forgetting_records=mark_forgetting_records,
        )

    def _freeze(self, threshold_column: Any, time_column: Any) -> "Table":
        """Drop rows arriving after `time_column`'s watermark passed their
        `threshold_column` (late data)."""
        from pathway_tpu_torch.engine.nodes import FreezeNode
        from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
            _temporal_table,
        )

        return _temporal_table(
            self,
            FreezeNode,
            self._desugar(threshold_column),
            self._desugar(time_column),
        )

    def _remove_retractions(self) -> "Table":
        """Pass inserts through and DROP deletions (reference:
        Table._remove_retractions — downstream sees an append-only view)."""
        node = nodes.RemoveRetractionsNode(self._node)
        return Table._from_node(
            node,
            {n: self._schema[n].dtype for n in self.column_names()},
            Universe(),
        )

    # --- ids ------------------------------------------------------------------

    def pointer_from(
        self, *args: Any, optional: bool = False, instance: Any = None
    ) -> ColumnExpression:
        return PointerExpression(
            self, *args, optional=optional, instance=instance
        )

    def with_id(self, new_index: ColumnReference) -> "Table":
        # the new-id expression may live on a related table (e.g. a
        # restricted pointer table): route through a row-aligned select
        prep = self._build_rowwise(
            {
                **{n: self[n] for n in self.column_names()},
                "_pw_new_id": new_index,
            }
        )
        internal = resolve_to_internal(
            {"k": prep._pw_new_id}, [prep]
        )["k"]
        node = nodes.ReindexNode(prep._node, internal)
        out = Table(node, prep._schema, Universe())
        return out.without("_pw_new_id")

    def with_id_from(self, *args: Any, instance: Any = None) -> "Table":
        e = self._desugar(
            PointerExpression(self, *args, instance=instance)
        )
        internal = resolve_to_internal({"k": e}, [self])["k"]
        node = nodes.ReindexNode(self._node, internal)
        return Table(node, self._schema, Universe())

    # --- groupby / reduce -----------------------------------------------------

    def groupby(
        self,
        *args: Any,
        id: ColumnReference | None = None,
        sort_by: Any = None,
        _skip_errors: bool = True,
        instance: Any = None,
        **kwargs,
    ):
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        grouping = []
        for a in args:
            a = self._desugar(a)
            grouping.append(a)
        if id is not None:
            grouping = [self._desugar(id)]
        return GroupedTable(
            self, grouping, instance=self._desugar(instance) if instance is not None else None,
            set_id=id is not None, sort_by=sort_by, skip_errors=_skip_errors
        )

    def reduce(self, *args: Any, **kwargs: Any) -> "Table":
        return self.groupby().reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value: Any = None,
        instance: Any = None,
        acceptor: Any = None,
        name: str | None = None,
        persistent_id: str | None = None,
    ) -> "Table":
        cols = {n: self[n] for n in self.column_names()}
        extra: dict[str, Any] = {}
        value_col = None
        inst_cols: list[str] = []
        if value is not None:
            extra["_value"] = self._desugar(value)
            value_col = "_value"
        if instance is not None:
            extra["_instance"] = self._desugar(instance)
            inst_cols = ["_instance"]
        prep = self._build_rowwise({**cols, **extra})
        node = nodes.DeduplicateNode(
            prep._node,
            inst_cols,
            acceptor,
            value_col,
        )
        # explicit name = persistent identity for SELECTIVE_PERSISTING
        node.persistent_name = name or persistent_id
        out = Table._from_node(
            node,
            {n: prep._schema[n].dtype for n in prep.column_names()},
            Universe(),
        )
        keep = [c for c in out.column_names() if not c.startswith("_")]
        result = out.select(*[out[c] for c in keep])
        return result

    # --- joins ----------------------------------------------------------------

    def join(
        self,
        other: "Table",
        *on: Any,
        id: Any = None,
        how: Any = None,
        left_instance: Any = None,
        right_instance: Any = None,
        **kwargs,
    ):
        from pathway_tpu_torch.internals.joins import JoinMode, JoinResult

        if isinstance(other, JoinResult):
            # joining against an unfinished join chains it: fold the inner
            # join into one table first (reference: join chaining)
            other = other._flatten()

        mode = how if how is not None else JoinMode.INNER
        if (left_instance is None) != (right_instance is None):
            raise ValueError(
                "join: left_instance and right_instance must be given "
                "together"
            )
        if left_instance is not None:
            # instance co-location joins as an additional equality
            # (reference: join instance= args, sharded by instance)
            on = (*on, left_instance == right_instance)
        return JoinResult(self, other, on, mode, id)

    def join_inner(self, other: "Table", *on: Any, **kwargs):
        from pathway_tpu_torch.internals.joins import JoinMode

        return self.join(other, *on, how=JoinMode.INNER, **kwargs)

    def join_left(self, other: "Table", *on: Any, **kwargs):
        from pathway_tpu_torch.internals.joins import JoinMode

        return self.join(other, *on, how=JoinMode.LEFT, **kwargs)

    def join_right(self, other: "Table", *on: Any, **kwargs):
        from pathway_tpu_torch.internals.joins import JoinMode

        return self.join(other, *on, how=JoinMode.RIGHT, **kwargs)

    def join_outer(self, other: "Table", *on: Any, **kwargs):
        from pathway_tpu_torch.internals.joins import JoinMode

        return self.join(other, *on, how=JoinMode.OUTER, **kwargs)

    # --- set ops --------------------------------------------------------------

    @staticmethod
    def empty(**kwargs: Any) -> "Table":
        """An empty table whose schema is given by kwargs of column types
        (reference: Table.empty, internals/table.py:355)."""
        from pathway_tpu_torch.engine.nodes import InputNode
        from pathway_tpu_torch.engine.runtime import StaticSource

        class _Empty(StaticSource):
            transient = True

            def events(self):
                return iter(())

        names = list(kwargs.keys())
        node = InputNode(_Empty(names), names)
        return Table._from_node(
            node, {n: dt.wrap(t) for n, t in kwargs.items()}, Universe()
        )

    def concat(self, *others: "Table") -> "Table":
        tables = [self] + list(others)
        # key sets must be provably disjoint or ids could collide
        # (reference: concat requires promise_are_pairwise_disjoint;
        # concat_reindex rehashes and is always safe)
        for i, a in enumerate(tables):
            for b in tables[i + 1 :]:
                if not a._universe.is_disjoint_from(b._universe):
                    raise ValueError(
                        "Table.concat: universes are not provably disjoint; "
                        "call pw.universes.promise_are_pairwise_disjoint "
                        "first, or use concat_reindex"
                    )
        names = self.column_names()
        aligned = [t.select(*[t[n] for n in names]) for t in tables]
        node = nodes.ConcatNode([t._node for t in aligned])
        dtypes = {}
        for n in names:
            out = self._schema[n].dtype
            for t in others:
                out = dt.lub(out, t._schema[n].dtype)
            dtypes[n] = out
        return Table._from_node(node, dtypes, Universe())

    def concat_reindex(self, *others: "Table") -> "Table":
        tables = [self] + list(others)
        reindexed = [
            t.with_id_from(t.id, i) for i, t in enumerate(tables)
        ]
        # the side tag mixed into every rehashed id guarantees disjointness
        for i, a in enumerate(reindexed):
            for b in reindexed[i + 1 :]:
                a._universe.promise_disjoint(b._universe)
        return reindexed[0].concat(*reindexed[1:])

    def update_rows(self, other: "Table") -> "Table":
        names = self.column_names()
        if set(other.column_names()) != set(names):
            raise ValueError(
                "update_rows: column sets must match "
                f"({sorted(names)} vs {sorted(other.column_names())})"
            )
        other_aligned = other.select(*[other[n] for n in names])
        node = nodes.UpdateRowsNode(self._node, other_aligned._node)
        dtypes = {
            n: dt.lub(self._schema[n].dtype, other._schema[n].dtype)
            for n in names
        }
        if self._universe.is_subset_of(other._universe):
            # other covers every key of self: nothing of self survives the
            # override (reference warns and short-circuits)
            import warnings

            warnings.warn(
                "Universe of self is a subset of universe of other in "
                "update_rows. Returning other.",
                stacklevel=2,
            )
            return other_aligned
        # an update from a promised subset cannot add keys: the result
        # keeps self's universe (reference: update_rows universe solver)
        universe = (
            self._universe
            if other._universe.is_subset_of(self._universe)
            else Universe()
        )
        return Table._from_node(node, dtypes, universe)

    def update_cells(self, other: "Table") -> "Table":
        # columns of `other` override; other's universe ⊆ self's
        extra = set(other.column_names()) - set(self.column_names())
        if extra:
            raise ValueError(
                f"update_cells: columns {sorted(extra)} are not present "
                "in the updated table"
            )
        if other._universe is self._universe:
            import warnings

            warnings.warn(
                "Key sets of self and other in update_cells are the same. "
                "Using with_columns instead of update_cells.",
                stacklevel=2,
            )
            return self.with_columns(
                **{n: other[n] for n in other.column_names()}
            )
        names = self.column_names()
        override = [n for n in other.column_names() if n in names]
        exprs: dict[str, Any] = {n: self[n] for n in names}
        for n in override:
            exprs[n] = _CellUpdate(self[n], other[n])
        return self._build_rowwise(exprs)

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def __add__(self, other: "Table") -> "Table":
        """Column union of two tables over the same rows: C.columns =
        self.columns + other.columns, C.id = self.id (reference:
        Table.__add__, internals/table.py:424). Column names must be
        disjoint. Universe agreement is the caller's contract — this build
        does not prove universe equality (no universe solver here), so
        mixing tables over different row sets yields missing cells rather
        than a build-time error."""
        exprs: dict[str, Any] = {n: self[n] for n in self.column_names()}
        for n in other.column_names():
            if n in exprs and other is not self:
                raise ValueError(
                    f"Table.__add__: column {n!r} exists on both sides; "
                    "columns must be disjoint"
                )
            exprs[n] = other[n]
        return self._build_rowwise(exprs)

    def intersect(self, *tables: "Table") -> "Table":
        node = nodes.UniverseSetOpNode(
            self._node, [t._node for t in tables], "intersect"
        )
        return Table(node, self._schema, self._universe.subset())

    def difference(self, other: "Table") -> "Table":
        node = nodes.UniverseSetOpNode(self._node, [other._node], "difference")
        return Table(node, self._schema, self._universe.subset())

    def restrict(self, other: TableLike) -> "Table":
        if hasattr(other, "_flatten") and not hasattr(other, "_node"):
            other = other._flatten()  # JoinResult used as a key-set source
        node = nodes.UniverseSetOpNode(
            self._node, [other._node], "restrict"  # type: ignore[attr-defined]
        )
        return Table(node, self._schema, other._universe)

    def having(self, *indexers: ColumnReference) -> "Table":
        out = self
        for ix in indexers:
            tbl = ix.table
            keyed = tbl.with_id(ix)
            node = nodes.UniverseSetOpNode(out._node, [keyed._node], "restrict")
            # having() IS the sanctioned drop-missing-keys filter (the
            # result universe stays a subset of self) — the Graph Doctor's
            # universe-safety rule must not treat it as an unchecked
            # restrict over unrelated key sets
            node._intentional_restrict = True
            out = Table(node, out._schema, out._universe.subset())
        return out

    def with_universe_of(self, other: TableLike) -> "Table":
        node = nodes.UniverseSetOpNode(
            self._node, [other._node], "restrict"  # type: ignore[attr-defined]
        )
        return Table(node, self._schema, other._universe)

    # --- ix -------------------------------------------------------------------

    def ix(
        self,
        expression: ColumnExpression,
        *,
        optional: bool = False,
        context=None,
        allow_misses: bool = False,
    ) -> "Table":
        e = expression
        if _expr_contains_reducer(wrap_expr(e)):
            # pointer computed by a reducer: defer — GroupedTable.reduce
            # aggregates the pointer first, then indexes THIS table
            # (reference: in-reduce ix(argmax, context=pw.this))
            d = _DeferredThisIxTable(e, optional, context, allow_misses)
            d._source = self
            return d
        tables = _collect_tables([wrap_expr(e)])
        if tables:
            indexer = tables[0]
        elif context is not None:
            indexer = context
        elif isinstance(e, PointerExpression) and isinstance(e._table, Table):
            indexer = e._table
        else:
            wrapped = wrap_expr(e)
            has_this = any(
                isinstance(getattr(r, "table", None), ThisPlaceholder)
                for r in wrapped._dependencies()
            )
            if not has_this:
                raise ValueError(
                    "ix requires a column expression with a table"
                )
            # pw.this-scoped pointer: defer to the CALLING operation's
            # table, like ix_ref (reference: ix resolves in the select's
            # context — t.select(x=other.ix(pw.this.ptr).col))
            return _DeferredIxTable(
                self,
                (wrapped,),
                optional or allow_misses,
                None,
                raw_expr=True,
            )
        prep = indexer._build_rowwise({"_ptr": e})
        node = nodes.IxNode(
            prep._node, "_ptr", self._node, optional or allow_misses
        )
        dtypes = {n: self._schema[n].dtype for n in self.column_names()}
        if optional:
            dtypes = {n: dt.Optional_(d) for n, d in dtypes.items()}
        return Table._from_node(node, dtypes, indexer._universe)

    def ix_ref(
        self,
        *args: Any,
        optional: bool = False,
        context=None,
        instance: Any = None,
    ):
        if context is None:
            arg_tables = _collect_tables(
                [wrap_expr(a) for a in args]
            ) if args else []
            if arg_tables:
                context = arg_tables[0]
        if context is None:
            # constants / pw.this args: the indexer universe is the CALLER's
            # — defer until the expression is used in a table operation
            return _DeferredIxTable(self, args, optional, instance)
        ptr = context.pointer_from(*args, instance=instance)
        return self.ix(ptr, optional=optional, context=context)

    # --- restructuring --------------------------------------------------------

    def flatten(
        self, *args: ColumnReference, origin_id: str | None = None, **kwargs
    ) -> "Table":
        assert len(args) == 1, "flatten takes exactly one column"
        to_flatten = args[0]
        name = to_flatten.name
        if origin_id is not None and origin_id in self.column_names():
            raise ValueError(
                f"flatten: origin_id {origin_id!r} collides with an "
                "existing column"
            )
        prep = self.select(*[self[n] for n in self.column_names()])
        node = nodes.FlattenNode(prep._node, name, origin_id=origin_id)
        inner = prep._schema[name].dtype
        if isinstance(inner, (dt.ListDType,)):
            item_dt = inner.wrapped
        elif isinstance(inner, dt.TupleDType) and inner.args:
            item_dt = inner.args[0]
        elif inner == dt.STR:
            item_dt = dt.STR
        else:
            item_dt = dt.ANY
        dtypes = {
            n: (item_dt if n == name else prep._schema[n].dtype)
            for n in prep.column_names()
        }
        if origin_id is not None:
            # parent-row pointer column (reference: Table.flatten origin_id)
            dtypes[origin_id] = dt.POINTER
        return Table._from_node(node, dtypes, Universe())

    def sort(
        self,
        key: ColumnExpression,
        instance: ColumnExpression | None = None,
    ) -> "Table":
        exprs: dict[str, Any] = {"_key": key}
        if instance is not None:
            exprs["_instance"] = instance
        prep = self._build_rowwise(exprs)
        node = nodes.SortNode(
            prep._node, "_key", "_instance" if instance is not None else None
        )
        return Table._from_node(
            node,
            {
                "prev": dt.Optional_(dt.POINTER),
                "next": dt.Optional_(dt.POINTER),
            },
            self._universe,
        )

    def _gradual_broadcast(
        self,
        threshold_table: "Table",
        lower_column: ColumnExpression,
        value_column: ColumnExpression,
        upper_column: ColumnExpression,
    ) -> "Table":
        """self + apx_value, where apx_value rolls from `lower` to `upper`
        gradually as `value` sweeps the [lower, upper] interval (reference:
        Table._gradual_broadcast, python/pathway/internals/table.py:631;
        operator: src/engine/dataflow/operators/gradual_broadcast.rs)."""
        thr_prep = threshold_table._build_rowwise(
            {
                "_lower": lower_column,
                "_value": value_column,
                "_upper": upper_column,
            }
        )
        node = nodes.GradualBroadcastNode(self._node, thr_prep._node)
        apx = Table._from_node(
            node,
            {"apx_value": thr_prep._schema["_value"].dtype},
            self._universe,
        )
        return self.with_columns(apx)

    def diff(
        self,
        timestamp: ColumnExpression,
        *values: ColumnReference,
        instance: ColumnExpression | None = None,
    ) -> "Table":
        from pathway_tpu_torch.stdlib.ordered import diff as _diff

        return _diff(self, timestamp, *values, instance=instance)

    # --- typing ---------------------------------------------------------------

    def cast_to_types(self, **kwargs: Any) -> "Table":
        exprs = {n: self[n] for n in self.column_names()}
        for name, target in kwargs.items():
            exprs[name] = expr_mod.CastExpression(target, self[name])
        return self.select(**exprs)

    def update_types(self, **kwargs: Any) -> "Table":
        exprs = {n: self[n] for n in self.column_names()}
        for name, target in kwargs.items():
            exprs[name] = expr_mod.DeclareTypeExpression(target, self[name])
        return self.select(**exprs)

    # --- promises (metadata-only, parity surface) -----------------------------

    def promise_universes_are_disjoint(self, other: "Table") -> "Table":
        self._universe.promise_disjoint(other._universe)
        return self

    def promise_universes_are_equal(self, other: "Table") -> "Table":
        return self

    def promise_universe_is_subset_of(self, other: "Table") -> "Table":
        self._universe = other._universe.subset()
        self._node._universe = self._universe
        return self

    def promise_universe_is_equal_to(self, other: "Table") -> "Table":
        self._universe = other._universe
        self._node._universe = self._universe
        return self

    def _set_universe(self, universe: Universe) -> "Table":
        self._universe = universe
        self._node._universe = universe
        return self

    # --- temporal ops (stdlib.temporal, reference: Table methods added by
    # python/pathway/stdlib/temporal/) --------------------------------------

    def windowby(
        self, time_expr, *, window, behavior=None, instance=None, shard=None
    ):
        from pathway_tpu_torch.stdlib.temporal._window import windowby as _impl

        return _impl(
            self, time_expr, window=window, behavior=behavior,
            instance=instance, shard=shard,
        )

    def interval_join(
        self, other, self_time, other_time, interval, *on, behavior=None,
        how=None,
    ):
        from pathway_tpu_torch.internals.joins import JoinMode
        from pathway_tpu_torch.stdlib.temporal._interval_join import (
            interval_join as _impl,
        )

        return _impl(
            self, other, self_time, other_time, interval, *on,
            behavior=behavior, how=how if how is not None else JoinMode.INNER,
        )

    def interval_join_inner(self, other, self_time, other_time, interval, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._interval_join import (
            interval_join_inner as _impl,
        )

        return _impl(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_left(self, other, self_time, other_time, interval, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._interval_join import (
            interval_join_left as _impl,
        )

        return _impl(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_right(self, other, self_time, other_time, interval, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._interval_join import (
            interval_join_right as _impl,
        )

        return _impl(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_outer(self, other, self_time, other_time, interval, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._interval_join import (
            interval_join_outer as _impl,
        )

        return _impl(self, other, self_time, other_time, interval, *on, **kw)

    def window_join(self, other, self_time, other_time, window, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._window_join import (
            window_join as _impl,
        )

        return _impl(self, other, self_time, other_time, window, *on, **kw)

    def window_join_inner(self, other, self_time, other_time, window, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._window_join import (
            window_join_inner as _impl,
        )

        return _impl(self, other, self_time, other_time, window, *on, **kw)

    def window_join_left(self, other, self_time, other_time, window, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._window_join import (
            window_join_left as _impl,
        )

        return _impl(self, other, self_time, other_time, window, *on, **kw)

    def window_join_right(self, other, self_time, other_time, window, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._window_join import (
            window_join_right as _impl,
        )

        return _impl(self, other, self_time, other_time, window, *on, **kw)

    def window_join_outer(self, other, self_time, other_time, window, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._window_join import (
            window_join_outer as _impl,
        )

        return _impl(self, other, self_time, other_time, window, *on, **kw)

    def asof_join(self, other, self_time, other_time, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._asof_join import asof_join as _impl

        return _impl(self, other, self_time, other_time, *on, **kw)

    def asof_join_left(self, other, self_time, other_time, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._asof_join import (
            asof_join_left as _impl,
        )

        return _impl(self, other, self_time, other_time, *on, **kw)

    def asof_join_right(self, other, self_time, other_time, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._asof_join import (
            asof_join_right as _impl,
        )

        return _impl(self, other, self_time, other_time, *on, **kw)

    def asof_join_outer(self, other, self_time, other_time, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._asof_join import (
            asof_join_outer as _impl,
        )

        return _impl(self, other, self_time, other_time, *on, **kw)

    def asof_now_join(self, other, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._asof_now_join import (
            asof_now_join as _impl,
        )

        return _impl(self, other, *on, **kw)

    def asof_now_join_inner(self, other, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._asof_now_join import (
            asof_now_join_inner as _impl,
        )

        return _impl(self, other, *on, **kw)

    def asof_now_join_left(self, other, *on, **kw):
        from pathway_tpu_torch.stdlib.temporal._asof_now_join import (
            asof_now_join_left as _impl,
        )

        return _impl(self, other, *on, **kw)

    # --- output helpers -------------------------------------------------------

    def _subscribe_node(self, on_batch, on_end=None) -> nodes.OutputNode:
        return nodes.OutputNode(self._node, on_batch, on_end)

    # --- interactive sugar ----------------------------------------------------

    @property
    def slice(self):
        from pathway_tpu_torch.internals.table_slice import TableSlice

        return TableSlice(
            {n: self[n] for n in self.column_names()}, self
        )


def _CellUpdate(left_ref, right_ref):
    """update_cells: use right value when the right table has the row."""
    from pathway_tpu_torch.internals.expression import CoalesceExpression

    # right table's universe is a subset; missing rows read as None
    return CoalesceExpression(right_ref, left_ref)


# free functions mirroring reference module-level joins/groupby


def join(left: Table, right: Table, *on, id=None, how=None, **kwargs):
    return left.join(right, *on, id=id, how=how, **kwargs)


def join_inner(left: Table, right: Table, *on, **kwargs):
    return left.join_inner(right, *on, **kwargs)


def join_left(left: Table, right: Table, *on, **kwargs):
    return left.join_left(right, *on, **kwargs)


def join_right(left: Table, right: Table, *on, **kwargs):
    return left.join_right(right, *on, **kwargs)


def join_outer(left: Table, right: Table, *on, **kwargs):
    return left.join_outer(right, *on, **kwargs)


def groupby(table: Table, *args, **kwargs):
    return table.groupby(*args, **kwargs)
