"""BM25 full-text inner index — counterpart of
``pathway_tpu/stdlib/indexing/bm25.py`` (reference: stdlib/indexing/bm25.py:41,
``TantivyBM25`` over the tantivy crate; here a host-side inverted index,
``Bm25Index``, with no device part)."""

from __future__ import annotations

from dataclasses import dataclass

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.stdlib.indexing._index_impls import Bm25Index
from pathway_tpu_torch.stdlib.indexing.data_index import EngineInnerIndex
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndexFactory


class TantivyBM25(EngineInnerIndex):
    """Reference-parity name; host-side BM25 scoring. ``ram_budget`` and
    ``in_memory_index`` are accepted for API compatibility."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
        *,
        ram_budget: int = 50_000_000,
        in_memory_index: bool = True,
        k1: float = 1.2,
        b: float = 0.75,
    ):
        super().__init__(
            data_column,
            metadata_column,
            index_factory=lambda: Bm25Index(k1=k1, b=b),
        )


@dataclass(kw_only=True)
class TantivyBM25Factory(InnerIndexFactory):
    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def build_inner_index(self, data_column, metadata_column=None):
        return TantivyBM25(
            data_column,
            metadata_column,
            ram_budget=self.ram_budget,
            in_memory_index=self.in_memory_index,
        )
