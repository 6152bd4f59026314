"""The port's own copy of ``pathway_tpu/stdlib/temporal/_asof_now_join.py``. asof_now joins: query-stream joins against the current state of the other
side, never revised by later updates (reference:
python/pathway/stdlib/temporal/_asof_now_join.py; the same as-of-now contract
as the external index query path, src/engine/dataflow.rs:2694)."""

from __future__ import annotations

from pathway_tpu_torch.engine.temporal_nodes import AsofNowJoinNode
from pathway_tpu_torch.internals.joins import JoinMode, JoinResult


class AsofNowJoinResult(JoinResult):
    def _uses_left_id(self) -> bool:
        from pathway_tpu_torch.internals.expression import ColumnReference
        from pathway_tpu_torch.internals.thisclass import left as left_ph

        e = self._id_expr
        return (
            isinstance(e, ColumnReference)
            and e.name == "id"
            and (e.table is self._left or e.table is left_ph)
        )

    def _result_universe(self):
        # id=pw.left.id keys each result row by its query row: LEFT mode
        # covers every query (same universe), INNER a subset (reference:
        # asof_now_join id= contract)
        if self._uses_left_id():
            if self._mode == JoinMode.LEFT:
                return self._left._universe
            return self._left._universe.subset()
        from pathway_tpu_torch.internals.universe import Universe

        return Universe()

    def _build(self):
        lnames = [f"_on{i}" for i in range(len(self._left_on))]
        left_cols = {n: self._left[n] for n in self._left.column_names()}
        left_prep = self._left._build_rowwise(
            {**left_cols, **dict(zip(lnames, self._left_on))}
        )
        right_cols = {n: self._right[n] for n in self._right.column_names()}
        right_prep = self._right._build_rowwise(
            {**right_cols, **dict(zip(lnames, self._right_on))}
        )
        node = AsofNowJoinNode(
            left_prep._node,
            right_prep._node,
            lnames,
            lnames,
            self._mode.value,
            id_from="left" if self._uses_left_id() else None,
        )
        return node, left_prep, right_prep


def asof_now_join(
    self, other, *on, how: JoinMode = JoinMode.INNER, id=None
) -> AsofNowJoinResult:
    """Join each (append-only) row of `self` against the state of `other` at
    the moment the row arrives; results are not updated when `other` changes."""
    if how not in (JoinMode.INNER, JoinMode.LEFT):
        raise ValueError("asof_now_join supports only INNER and LEFT modes")
    return AsofNowJoinResult(self, other, on, how, id)


def asof_now_join_inner(self, other, *on, id=None):
    return asof_now_join(self, other, *on, how=JoinMode.INNER, id=id)


def asof_now_join_left(self, other, *on, id=None):
    return asof_now_join(self, other, *on, how=JoinMode.LEFT, id=id)
