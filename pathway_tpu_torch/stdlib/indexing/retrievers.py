"""The port's own copy of ``pathway_tpu/stdlib/indexing/retrievers.py``. Retriever factory ABCs (reference: stdlib/indexing/retrievers.py:7-17)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex


class AbstractRetrieverFactory(ABC):
    @abstractmethod
    def build_index(
        self,
        data_column: ColumnReference,
        data_table: Table,
        metadata_column: ColumnExpression | None = None,
    ) -> DataIndex: ...


class InnerIndexFactory(AbstractRetrieverFactory):
    @abstractmethod
    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex: ...

    def build_index(
        self,
        data_column: ColumnReference,
        data_table: Table,
        metadata_column: ColumnExpression | None = None,
    ) -> DataIndex:
        inner = self.build_inner_index(data_column, metadata_column)
        return DataIndex(data_table, inner)
