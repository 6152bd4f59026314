"""The port's own copy of ``pathway_tpu/stdlib/indexing/data_index.py``. DataIndex + InnerIndex — the retrieval layer
(reference: stdlib/indexing/data_index.py:278, InnerIndex:206).

InnerIndex answers queries with `_pw_index_reply` (a tuple of (id, score)
pairs, best first); DataIndex augments replies with the data table's columns
(collapsed to one tuple-valued row per query)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable

from pathway_tpu_torch.engine.index_node import ExternalIndexNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    wrap_expr,
)
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this
from pathway_tpu_torch.stdlib.indexing.colnames import (
    _INDEX_REPLY,
    _MATCHED_ID,
    _SCORE,
)
import pathway_tpu_torch.reducers as reducers


class InnerIndex(ABC):
    """A retrieval structure fed from ``data_column`` (+ optional metadata)
    answering queries with matched ids + scores."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ):
        self.data_column = data_column
        self.metadata_column = metadata_column

    @abstractmethod
    def query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: Any = 3,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table: ...

    @abstractmethod
    def query_as_of_now(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: Any = 3,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table: ...


class EngineInnerIndex(InnerIndex):
    """InnerIndex backed by a host index object driven by the engine's
    ExternalIndexNode (device work happens inside the index's search)."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
        *,
        index_factory: Callable[[], Any],
        embedder: Any = None,
    ):
        super().__init__(data_column, metadata_column)
        self.index_factory = index_factory
        self.embedder = embedder

    def _apply_embedder(self, col: ColumnExpression) -> ColumnExpression:
        if self.embedder is None:
            return col
        return self.embedder(col)

    def _query(self, query_column, number_of_matches, metadata_filter, as_of_now):
        data_table: Table = self.data_column.table
        data_exprs: dict[str, ColumnExpression] = {
            "_data": self._apply_embedder(self.data_column)
        }
        if self.metadata_column is not None:
            data_exprs["_meta"] = self.metadata_column
        data_prep = data_table._build_rowwise(data_exprs)

        query_table: Table = query_column.table
        q_exprs: dict[str, ColumnExpression] = {
            "_q": self._apply_embedder(query_column),
            "_k": wrap_expr(number_of_matches),
        }
        if metadata_filter is not None:
            q_exprs["_filter"] = metadata_filter
        query_prep = query_table._build_rowwise(q_exprs)

        node = ExternalIndexNode(
            data_prep._node,
            query_prep._node,
            self.index_factory,
            as_of_now=as_of_now,
        )
        return Table._from_node(
            node, {_INDEX_REPLY: dt.ANY_TUPLE}, query_table._universe
        )

    def query(
        self,
        query_column,
        *,
        number_of_matches: Any = 3,
        metadata_filter=None,
    ) -> Table:
        return self._query(
            query_column, number_of_matches, metadata_filter, as_of_now=False
        )

    def query_as_of_now(
        self,
        query_column,
        *,
        number_of_matches: Any = 3,
        metadata_filter=None,
    ) -> Table:
        return self._query(
            query_column, number_of_matches, metadata_filter, as_of_now=True
        )


@dataclass
class DataIndex:
    """Augments InnerIndex replies with the data table's columns
    (reference: stdlib/indexing/data_index.py:278)."""

    data_table: Table
    inner_index: InnerIndex

    def _repack(self, reply_table: Table, query_table: Table, collapse_rows: bool):
        base = reply_table.select(
            _qid=this.id, _reply=reply_table[_INDEX_REPLY]
        )
        flat = base.flatten(base._reply)  # one row per (query, match)
        flat2 = flat.select(
            _qid=this._qid,
            _ptr=this._reply.get(0),
            _score=this._reply.get(1),
        )
        data_rows = self.data_table.ix(flat2._ptr, optional=True)
        # reply columns carry the reference's public names so users can
        # select pw.right._pw_index_reply_score etc. (reference:
        # data_index.py _INDEX_REPLY schema)
        combined_exprs: dict[str, Any] = {
            "_qid": flat2._qid,
            _SCORE: flat2._score,
            _MATCHED_ID: flat2._ptr,
        }
        for c in self.data_table.column_names():
            combined_exprs[c] = data_rows[c]
        combined = flat2.select(**combined_exprs)
        if not collapse_rows:
            return query_table.join_left(
                combined, query_table.id == combined._qid
            )
        agg: dict[str, Any] = {"_qid": this._qid}
        for c in self.data_table.column_names():
            agg[c] = reducers.tuple(combined[c])
        agg[_SCORE] = reducers.tuple(combined[_SCORE])
        agg[_MATCHED_ID] = reducers.tuple(combined[_MATCHED_ID])
        collapsed = combined.groupby(
            combined._qid, sort_by=-combined[_SCORE]
        ).reduce(**agg)
        # every query gets a row: matchless queries collapse to EMPTY
        # tuples, not None (reference: test_no_match_is_empty_list)
        defaults = query_table.select(
            _qid=query_table.id,
            **{c: () for c in self.data_table.column_names()},
            **{_SCORE: (), _MATCHED_ID: ()},
        )
        full = defaults.update_rows(
            collapsed.with_id(collapsed._qid)
        )
        return query_table.join_left(
            full, query_table.id == full._qid, id=query_table.id
        )

    def query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: Any = 3,
        collapse_rows: bool = True,
        metadata_filter: ColumnExpression | None = None,
    ):
        reply = self.inner_index.query(
            query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
        )
        return self._repack(reply, query_column.table, collapse_rows)

    def query_as_of_now(
        self,
        query_column: ColumnReference,
        number_of_matches: Any = 3,
        collapse_rows: bool = True,
        metadata_filter: ColumnExpression | None = None,
    ):
        reply = self.inner_index.query_as_of_now(
            query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
        )
        return self._repack(reply, query_column.table, collapse_rows)
