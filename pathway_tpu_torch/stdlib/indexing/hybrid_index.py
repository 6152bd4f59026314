"""HybridIndex — reciprocal-rank fusion over several inner indexes;
counterpart of ``pathway_tpu/stdlib/indexing/hybrid_index.py`` (reference:
stdlib/indexing/hybrid_index.py:14).

A document's fused score is the sum over the inner replies of
``1 / (k + rank + 1)``. Ties are common (a document at rank r in one reply
only, another at rank r in another only); they keep the order in which the
replies first met them, inner index by inner index, as Python's stable
``sorted`` over the filled dict gives it in the reference."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

from pathway_tpu_torch.internals.common import apply_with_type
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.colnames import _INDEX_REPLY
from pathway_tpu_torch.stdlib.indexing.data_index import InnerIndex
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndexFactory


def rrf(replies: Sequence[Any], k: float) -> tuple:
    """Fuse ranked replies (each a sequence of ``(id, score)`` or ``None``)
    into one ranked tuple of ``(id, fused score)``."""
    scores: dict = {}
    for reply in replies:
        if reply is None:
            continue
        for rank, pair in enumerate(reply):
            ptr = pair[0]
            scores[ptr] = scores.get(ptr, 0.0) + 1.0 / (k + rank + 1)
    ranked = sorted(scores.items(), key=lambda kv: -kv[1])
    return tuple((ptr, s) for ptr, s in ranked)


class HybridIndex(InnerIndex):
    def __init__(self, inner_indexes: Sequence[InnerIndex], k: float = 60.0):
        assert inner_indexes, "HybridIndex needs at least one inner index"
        first = inner_indexes[0]
        super().__init__(first.data_column, first.metadata_column)
        self.inner_indexes = list(inner_indexes)
        self.k = k

    def _fuse(self, reply_tables: list[Table]) -> Table:
        k = self.k
        base = reply_tables[0]
        args = [t[_INDEX_REPLY] for t in reply_tables]
        return base.select(
            **{_INDEX_REPLY: apply_with_type(lambda *replies: rrf(replies, k), tuple, *args)}
        )

    def query(self, query_column, *, number_of_matches=3, metadata_filter=None):
        replies = [
            ix.query(
                query_column,
                number_of_matches=number_of_matches,
                metadata_filter=metadata_filter,
            )
            for ix in self.inner_indexes
        ]
        return self._fuse(replies)

    def query_as_of_now(self, query_column, *, number_of_matches=3, metadata_filter=None):
        replies = [
            ix.query_as_of_now(
                query_column,
                number_of_matches=number_of_matches,
                metadata_filter=metadata_filter,
            )
            for ix in self.inner_indexes
        ]
        return self._fuse(replies)


@dataclass
class HybridIndexFactory(InnerIndexFactory):
    retriever_factories: list[Any]
    k: float = 60.0

    def build_inner_index(self, data_column, metadata_column=None):
        inner = [f.build_inner_index(data_column, metadata_column) for f in self.retriever_factories]
        return HybridIndex(inner, k=self.k)
