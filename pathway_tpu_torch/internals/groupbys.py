"""The port's own copy of ``pathway_tpu/internals/groupbys.py``. GroupedTable: groupby(...).reduce(...)
(reference: python/pathway/internals/groupbys.py; engine group_by_table,
src/engine/dataflow.rs:3404)."""

from __future__ import annotations

from typing import Any, Sequence

from pathway_tpu_torch.engine import nodes
from pathway_tpu_torch.engine.expression_eval import InternalColRef
from pathway_tpu_torch.engine.reducers import ReducerSpec
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    ReducerExpression,
)
from pathway_tpu_torch.internals.reducer_descriptors import ReducerDescriptor
from pathway_tpu_torch.internals.thisclass import ThisPlaceholder, ThisSlice, this
from pathway_tpu_torch.internals.universe import Universe


def _exprs_structurally_equal(a, b) -> bool:
    """Structural expression equality: same class tree, same column refs,
    same non-expression payload (constants, cast targets, functions)."""
    if isinstance(a, ColumnReference) or isinstance(b, ColumnReference):
        return (
            isinstance(a, ColumnReference)
            and isinstance(b, ColumnReference)
            and a.table is b.table
            and a.name == b.name
        )
    if type(a) is not type(b):
        return False
    ca, cb = a._children, b._children
    if len(ca) != len(cb):
        return False

    def payload(x) -> dict:
        out = {}
        for k, v in x.__dict__.items():
            if isinstance(v, ColumnExpression):
                continue
            if isinstance(v, (tuple, list)) and any(
                isinstance(i, ColumnExpression) for i in v
            ):
                continue
            if isinstance(v, dict) and any(
                isinstance(i, ColumnExpression) for i in v.values()
            ):
                continue
            out[k] = v
        return out

    pa, pb = payload(a), payload(b)
    if set(pa) != set(pb):
        return False
    for k in pa:
        va, vb = pa[k], pb[k]
        if isinstance(va, ReducerDescriptor) and isinstance(
            vb, ReducerDescriptor
        ):
            # each reducers.* call builds a fresh descriptor whose `ret`
            # lambda differs by identity; compare the semantic fields
            if not (
                va.name == vb.name
                and va.kind == vb.kind
                and va.n_args == vb.n_args
                and va.skip_nones == vb.skip_nones
                and va.fn is vb.fn
                and va.extra == vb.extra
            ):
                return False
        elif callable(va) or callable(vb):
            if va is not vb:
                return False
        elif va is not vb and va != vb:
            return False
    return all(_exprs_structurally_equal(x, y) for x, y in zip(ca, cb))


class GroupedTable:
    def __init__(
        self,
        table,
        grouping: Sequence[ColumnExpression],
        instance: ColumnExpression | None = None,
        set_id: bool = False,
        sort_by: Any = None,
        skip_errors: bool = True,
    ):
        self._table = table
        self._grouping = list(grouping)
        # the instance is part of the group identity: reference ids come
        # from ref_scalar_with_instance(*grouping, instance) — the hash
        # covers the instance value, the shard bits come from it too. It
        # also makes the instance selectable in reduce() like any
        # grouping column.
        if instance is not None:
            self._grouping = self._grouping + [instance]
        self._instance = instance
        self._set_id = set_id
        self._sort_by = sort_by
        self._skip_errors = skip_errors

    def __getattr__(self, name: str) -> Any:
        # source columns are addressable on the grouped table itself, for
        # reduce expressions like values.ix(grouped.ptr).v (reference:
        # GroupedJoinable column access, internals/groupbys.py)
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._table[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name: str) -> Any:
        return self._table[name]

    def reduce(self, *args: Any, **kwargs: Any) -> Any:
        from pathway_tpu_torch.internals.table import Table, infer_dtype

        for e in kwargs.values():
            if isinstance(e, ThisPlaceholder):
                raise TypeError(
                    "`**pw.this` expansion is not supported in reduce(); "
                    "name the reduced columns explicitly"
                )

        table = self._table
        out_exprs: dict[str, ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, ThisPlaceholder):
                # reduce(*pw.this): every source column (legal only when
                # each is a grouping column, checked below like any ref)
                for n in table.column_names():
                    out_exprs[n] = table[n]
                continue
            if isinstance(arg, ThisSlice):
                for n, ref in arg.resolve(table).items():
                    out_exprs[n] = ref
            elif isinstance(arg, ColumnReference):
                name = arg.name
                ref = (
                    table[name]
                    if isinstance(arg.table, ThisPlaceholder)
                    else arg
                )
                out_exprs[name] = ref
            elif isinstance(arg, ReducerExpression):
                # positional reducer: named after its (single) column arg
                # (reference: reduce(pw.reducers.any(t.pet)) -> column 'pet')
                ref_args = [
                    a for a in arg._args if isinstance(a, ColumnReference)
                ]
                if len(ref_args) != 1:
                    raise TypeError(
                        "positional reducer in reduce() must take exactly "
                        "one column argument (name it with kwarg= instead)"
                    )
                out_exprs[ref_args[0].name] = arg
            else:
                raise TypeError(f"positional reduce argument {arg!r}")
        for name, e in kwargs.items():
            out_exprs[name] = table._desugar(e)

        # --- post-aggregation ix lookups (pw.this.ix(argmax(...)).col) --------
        from pathway_tpu_torch.internals.table import _DeferredIxTable

        deferred_tables: dict[int, Any] = {}

        def find_deferred(e):
            if isinstance(e, ColumnReference) and isinstance(
                e.table, _DeferredIxTable
            ):
                if e.table._contains_reducer():
                    deferred_tables.setdefault(id(e.table), e.table)
                return
            for c in e._children:
                find_deferred(c)

        for e in out_exprs.values():
            find_deferred(e)
        ix_slots: dict[int, tuple[str, Any, Any]] = {}

        def _same_lookup(d1, d2) -> bool:
            return (
                getattr(d1, "_source", None) is getattr(d2, "_source", None)
                and getattr(d1, "_optional", False)
                == getattr(d2, "_optional", False)
                and getattr(d1, "_allow_misses", False)
                == getattr(d2, "_allow_misses", False)
            )

        for k, (key, dtbl) in enumerate(deferred_tables.items()):
            inners = [table._desugar(p) for p in dtbl._pointer_exprs()]
            if getattr(dtbl, "_raw_expr", True):
                # the single expr IS the pointer (this.ix / table.ix paths)
                ptr_expr = inners[0]
            else:
                # ix_ref(a, b, instance=...): the pointer is derived from
                # the aggregated KEY VALUES, exactly like _materialize
                from pathway_tpu_torch.internals.expression import (
                    PointerExpression,
                )

                inst = dtbl._instance
                ptr_expr = PointerExpression(
                    dtbl._source,
                    *inners,
                    optional=dtbl._optional,
                    instance=table._desugar(inst) if inst is not None else None,
                )
            # structurally identical lookups share one slot (one reducer,
            # one IxNode) — the common multi-column argmax-row pattern
            shared = None
            for other in ix_slots.values():
                if _same_lookup(dtbl, other[2]) and _exprs_structurally_equal(
                    ptr_expr, other[1]
                ):
                    shared = other
                    break
            ix_slots[key] = shared or (f"_ixptr{k}", ptr_expr, dtbl)

        # --- collect reducer subexpressions & grouping references -------------
        reducer_slots: list[ReducerExpression] = []

        def collect(e: ColumnExpression):
            if isinstance(e, ReducerExpression):
                reducer_slots.append(e)
                return
            for c in e._children:
                collect(c)

        for e in out_exprs.values():
            collect(e)
        _seen_slots: set[str] = set()
        for _slot, inner, _d in ix_slots.values():
            if _slot not in _seen_slots:
                _seen_slots.add(_slot)
                collect(inner)

        grouping_names = [f"_g{i}" for i in range(len(self._grouping))]

        def grouping_index(ref: ColumnReference) -> int | None:
            for i, g in enumerate(self._grouping):
                if (
                    isinstance(g, ColumnReference)
                    and g.table is ref.table
                    and g.name == ref.name
                ):
                    return i
            # same-universe sibling tables (t vs t.select(*pw.this)) may
            # name the grouping column through either table (reference:
            # universe-solver equivalence) — but only when both refs trace
            # back to the SAME source column (a renamed sibling column,
            # b.pet = a.owner, must not silently read the grouping key)
            def origin(r: ColumnReference):
                from pathway_tpu_torch.engine.expression_eval import InternalColRef

                node = getattr(r.table, "_node", None)
                name = r.name
                for _ in range(32):
                    exprs = getattr(node, "exprs", None)
                    if exprs is None:
                        break
                    inner = exprs.get(name)
                    if isinstance(inner, InternalColRef):
                        node = node.inputs[inner._input_index]
                        name = inner._name
                        continue
                    if isinstance(inner, ColumnReference):
                        node = getattr(inner.table, "_node", None)
                        name = inner.name
                        continue
                    break
                return (getattr(node, "id", None), name)

            for i, g in enumerate(self._grouping):
                if (
                    isinstance(g, ColumnReference)
                    and g.name == ref.name
                    and getattr(ref.table, "_universe", None)
                    is getattr(g.table, "_universe", object())
                    and origin(ref) == origin(g)
                ):
                    return i
            return None

        # --- build prep table: grouping cols + reducer args -------------------
        prep_exprs: dict[str, ColumnExpression] = {}
        for i, g in enumerate(self._grouping):
            prep_exprs[grouping_names[i]] = g
        if self._instance is not None:
            prep_exprs["_inst"] = self._instance
        if self._sort_by is not None:
            prep_exprs["_sortby"] = table._desugar(self._sort_by)
        reducer_specs: dict[str, ReducerSpec] = {}
        slot_names: dict[int, str] = {}
        for si, red in enumerate(reducer_slots):
            name = f"_agg{si}"
            slot_names[id(red)] = name
            desc: ReducerDescriptor = red._reducer
            arg_cols = []
            for ai, arg in enumerate(red._args):
                cname = f"_a{si}_{ai}"
                prep_exprs[cname] = table._desugar(arg)
                arg_cols.append(cname)
            reducer_specs[name] = ReducerSpec(
                kind=desc.kind,
                arg_cols=tuple(arg_cols),
                skip_nones=desc.skip_nones,
                skip_errors=self._skip_errors,
                fn=desc.fn,
                extra=desc.extra,
            )
        prep = table._build_rowwise(prep_exprs)

        gb_node = nodes.GroupByNode(
            prep._node,
            grouping_names,
            reducer_specs,
            instance_col="_inst" if self._instance is not None else None,
            set_id=self._set_id,
            sort_by="_sortby" if self._sort_by is not None else None,
        )
        # windowby-built groupbys aggregate windows, not raw groups — the
        # Graph Doctor's unbounded-state rule treats them differently
        gb_node._windowed = getattr(self, "_pw_windowed", False)
        env = table._dtype_env()
        gb_dtypes: dict[str, dt.DType] = {}
        for i, g in enumerate(self._grouping):
            gb_dtypes[grouping_names[i]] = infer_dtype(g, env)
        for name, red in zip(reducer_specs.keys(), reducer_slots):
            from pathway_tpu_torch.internals.reducer_descriptors import (
                reducer_return_dtype,
            )

            gb_dtypes[name] = reducer_return_dtype(red, env)
        agg_table = Table._from_node(gb_node, gb_dtypes, Universe())
        # ids of a groupby derive from the grouping values: their type is
        # the parametrized pointer (reference: Pointer[grouping dtypes])
        _id_dtype = dt.Pointer(
            *[gb_dtypes[n] for n in grouping_names]
        )
        agg_table._schema.__id_dtype__ = _id_dtype

        # --- final select over aggregated table -------------------------------
        _expr_matches = _exprs_structurally_equal

        def grouping_expr_index(e) -> int | None:
            for i, g in enumerate(self._grouping):
                if not isinstance(g, ColumnReference) and _expr_matches(e, g):
                    return i
            return None

        def rewrite(e: ColumnExpression) -> ColumnExpression:
            if isinstance(e, ReducerExpression):
                return InternalColRef(0, slot_names[id(e)])
            if not isinstance(e, ColumnReference):
                gie = grouping_expr_index(e)
                if gie is not None:
                    return InternalColRef(0, grouping_names[gie])
            if isinstance(e, ColumnReference):
                gi = grouping_index(e)
                if gi is not None:
                    return InternalColRef(0, grouping_names[gi])
                if e.name == "id" and e.table is table:
                    raise ValueError(
                        "cannot use source ids in reduce output"
                    )
                raise ValueError(
                    f"column {e.name!r} used in reduce() is not a grouping "
                    "column; wrap it in a reducer"
                )
            return e._rebuild(tuple(rewrite(c) for c in e._children))

        def env2(ref: ColumnReference) -> dt.DType:
            gi = grouping_index(ref)
            if gi is not None:
                return gb_dtypes[grouping_names[gi]]
            return dt.ANY

        def has_deferred(e) -> bool:
            if isinstance(e, ColumnReference):
                return id(e.table) in ix_slots
            return any(has_deferred(c) for c in e._children)

        if not ix_slots:
            final_exprs = {n: rewrite(e) for n, e in out_exprs.items()}
            final_dtypes = {
                n: infer_dtype(e, env2) for n, e in out_exprs.items()
            }
            node = nodes.RowwiseNode([agg_table._node], final_exprs)
            out_tbl = Table._from_node(
                node, final_dtypes, agg_table._universe
            )
            out_tbl._schema.__id_dtype__ = _id_dtype
            return out_tbl

        # stage 1: the plain aggregated columns, every reducer slot +
        # grouping column (stage 2 may reference them), and the ix pointer
        # slots
        stage1_exprs: dict[str, ColumnExpression] = {}
        stage1_dtypes: dict[str, dt.DType] = {}
        for n, e in out_exprs.items():
            if not has_deferred(e):
                stage1_exprs[n] = rewrite(e)
                stage1_dtypes[n] = infer_dtype(e, env2)
        for slot in slot_names.values():
            stage1_exprs.setdefault(slot, InternalColRef(0, slot))
            stage1_dtypes.setdefault(slot, gb_dtypes[slot])
        for i, gname in enumerate(grouping_names):
            stage1_exprs.setdefault(gname, InternalColRef(0, gname))
            stage1_dtypes.setdefault(gname, gb_dtypes[gname])
        for slot, inner, _d in ix_slots.values():
            stage1_exprs[slot] = rewrite(inner)
            stage1_dtypes[slot] = dt.POINTER
        node1 = nodes.RowwiseNode([agg_table._node], stage1_exprs)
        stage1 = Table._from_node(node1, stage1_dtypes, Universe())

        # stage 2: ix the source table at the aggregated pointers and
        # substitute the deferred references (reference: in-reduce
        # ix(argmax) lookups, tests/test_common.py test_groupby_ix)
        ixed: dict[int, Table] = {}
        ixed_by_slot: dict[str, Table] = {}
        for key, (slot, _inner, dtbl) in ix_slots.items():
            if slot not in ixed_by_slot:
                src = getattr(dtbl, "_source", None) or table
                ixed_by_slot[slot] = src.ix(
                    stage1[slot],
                    optional=getattr(dtbl, "_optional", False),
                    allow_misses=getattr(dtbl, "_allow_misses", False),
                )
            ixed[key] = ixed_by_slot[slot]

        def rewrite2(e):
            if isinstance(e, ColumnReference):
                if id(e.table) in ixed:
                    return ixed[id(e.table)][e.name]
                gi = grouping_index(e)
                if gi is not None:
                    return stage1[grouping_names[gi]]
                if e.table is stage1:
                    return e
                raise ValueError(
                    f"column {e.name!r} used in reduce() is not a "
                    "grouping column; wrap it in a reducer"
                )
            gie = grouping_expr_index(e)
            if gie is not None:
                return stage1[grouping_names[gie]]
            if isinstance(e, ReducerExpression):
                return stage1[slot_names[id(e)]]
            return e._rebuild(tuple(rewrite2(c) for c in e._children))

        stage2_exprs = {}
        for n, e in out_exprs.items():
            if has_deferred(e):
                stage2_exprs[n] = rewrite2(e)
            else:
                stage2_exprs[n] = stage1[n]
        return stage1.select(**stage2_exprs)


class GroupedJoinResult(GroupedTable):
    """groupby on a join result: references to pw.left/pw.right resolve onto
    the materialized join (reference: JoinResult.groupby,
    internals/joins.py:748)."""

    _join_result = None

    def reduce(self, *args: Any, **kwargs: Any):
        jr = self._join_result
        if jr is not None:
            new_kwargs: dict[str, Any] = {}
            for a in args:
                if not isinstance(a, ColumnReference):
                    raise TypeError(
                        f"positional reduce argument {a!r} must be a column"
                    )
                resolved = jr._resolve_in_joined(a)
                new_kwargs[a.name] = resolved
            for n, e in kwargs.items():
                new_kwargs[n] = jr._resolve_in_joined(e)
            return super().reduce(**new_kwargs)
        return super().reduce(*args, **kwargs)
