"""Default vector document indexes — counterpart of
``pathway_tpu/stdlib/indexing/vector_document_index.py`` (reference:
stdlib/indexing/vector_document_index.py:12-157). Each helper takes
``device=`` (default ``"cuda"``) and passes it to its inner index."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    IvfKnn,
    LshKnn,
    USearchKnn,
    USearchMetricKind,
)


def default_vector_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    embedder: Any = None,
    dimensions: int | None = None,
    metadata_column: ColumnExpression | None = None,
    device: str = "cuda",
) -> DataIndex:
    return default_usearch_knn_document_index(
        data_column,
        data_table,
        embedder=embedder,
        dimensions=dimensions,
        metadata_column=metadata_column,
        device=device,
    )


def default_usearch_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    embedder: Any = None,
    dimensions: int | None = None,
    metadata_column: ColumnExpression | None = None,
    device: str = "cuda",
) -> DataIndex:
    inner = USearchKnn(
        data_column,
        metadata_column,
        dimensions=dimensions,
        reserved_space=1024,
        metric=USearchMetricKind.COS,
        embedder=embedder,
        device=device,
    )
    return DataIndex(data_table, inner)


def default_brute_force_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    embedder: Any = None,
    dimensions: int | None = None,
    metadata_column: ColumnExpression | None = None,
    device: str = "cuda",
) -> DataIndex:
    inner = BruteForceKnn(
        data_column,
        metadata_column,
        dimensions=dimensions,
        reserved_space=1024,
        embedder=embedder,
        device=device,
    )
    return DataIndex(data_table, inner)


def default_lsh_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    embedder: Any = None,
    dimensions: int,
    metadata_column: ColumnExpression | None = None,
    device: str = "cuda",
) -> DataIndex:
    inner = LshKnn(
        data_column,
        metadata_column,
        dimensions=dimensions,
        embedder=embedder,
        device=device,
    )
    return DataIndex(data_table, inner)


def default_ivf_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    embedder: Any = None,
    dimensions: int | None = None,
    metadata_column: ColumnExpression | None = None,
    n_clusters: int | None = None,
    n_probe: int | None = None,
    device: str = "cuda",
) -> DataIndex:
    """IVF document index — sub-linear queries for corpora past the
    brute-force tier (``ops/ivf.py`` design note)."""
    inner = IvfKnn(
        data_column,
        metadata_column,
        dimensions=dimensions,
        n_clusters=n_clusters,
        n_probe=n_probe,
        embedder=embedder,
        device=device,
    )
    return DataIndex(data_table, inner)
