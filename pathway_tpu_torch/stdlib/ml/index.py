"""KNNIndex — counterpart of ``pathway_tpu/stdlib/ml/index.py`` (reference:
stdlib/ml/index.py:9, there a pure-dataflow LSH ANN; in both packages
exact dense KNN, on ``device`` here). ``distance_type`` picks the metric;
distances come in the reference's units (squared euclidean / cosine
distance). The LSH knobs are accepted for API compatibility."""

from __future__ import annotations

from pathway_tpu_torch.internals.common import apply_with_type
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import right
from pathway_tpu_torch.stdlib.indexing.colnames import _SCORE
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import TpuKnn


class KNNIndex:
    def __init__(
        self,
        data_embedding: ColumnReference,
        data: Table,
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        metadata: ColumnExpression | None = None,
        device: str = "cuda",
    ):
        self.distance_type = distance_type
        metric = "cosine" if distance_type == "cosine" else "l2sq"
        self.inner = TpuKnn(
            data_embedding,
            metadata,
            dimensions=n_dimensions,
            metric=metric,
            device=device,
        )
        self.index = DataIndex(data, self.inner)
        self.data = data

    def _with_dist(self, result: Table) -> Table:
        dt_kind = self.distance_type

        def to_dists(scores) -> tuple:
            if scores is None:
                return ()
            out = []
            for s in scores:
                if dt_kind == "cosine":
                    # scores are negative distances (cos - 1): distance = -score
                    out.append(-float(s))
                else:
                    # the reference's KNNIndex reports squared euclidean
                    # distances (stdlib/ml/index.py get_nearest_items)
                    out.append(max(0.0, -float(s)))
            return tuple(out)

        return result.with_columns(dist=apply_with_type(to_dists, tuple, result[_SCORE]))

    def _query(
        self,
        query_embedding: ColumnReference,
        k: int,
        collapse_rows: bool,
        with_distances: bool,
        metadata_filter: ColumnExpression | None,
        as_of_now: bool,
    ):
        method = self.index.query_as_of_now if as_of_now else self.index.query
        jr = method(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
        )
        sel = jr.select(
            *[right[c] for c in self.data.column_names()],
            **{_SCORE: right[_SCORE]},
        )
        if with_distances:
            sel = self._with_dist(sel)
        return sel.without(_SCORE)

    def get_nearest_items(
        self,
        query_embedding: ColumnReference,
        k: int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ):
        return self._query(query_embedding, k, collapse_rows, with_distances, metadata_filter, as_of_now=False)

    def get_nearest_items_asof_now(
        self,
        query_embedding: ColumnReference,
        k: int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ):
        return self._query(query_embedding, k, collapse_rows, with_distances, metadata_filter, as_of_now=True)
