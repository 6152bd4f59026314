"""KNN inner indexes — counterpart of
``pathway_tpu/stdlib/indexing/nearest_neighbors.py`` (reference:
stdlib/indexing/nearest_neighbors.py: USearchKnn:65, BruteForceKnn:170,
LshKnn:262 + factories:407).

Every dense index is the same machine: a device-resident corpus searched
by exact top-k (``TpuDenseKnnIndex``; on CUDA the hand-written block top-k
kernel). ``USearchKnn`` / ``BruteForceKnn`` keep the reference's parameter
surfaces and lower to it. ``LshKnn`` keeps candidate-bucketing semantics
with its projections on the device (``LshKnnIndex``); ``IvfKnn`` is the
two-level IVF tier (``IvfKnnIndex``). Every index and factory takes
``device=`` (default ``"cuda"``). ``TpuKnn(mesh=)`` shards the corpus's
rows over the mesh's devices (``parallel/mesh.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.stdlib.indexing._index_impls import (
    IvfKnnIndex,
    LshKnnIndex,
    TpuDenseKnnIndex,
)
from pathway_tpu_torch.stdlib.indexing.data_index import EngineInnerIndex
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndexFactory


class USearchMetricKind(Enum):
    COS = "cosine"
    IP = "dot"
    L2SQ = "l2sq"


class BruteForceKnnMetricKind(Enum):
    COS = "cosine"
    IP = "dot"
    L2SQ = "l2sq"


class DistanceTypes(Enum):
    EUCLIDEAN = "euclidean"
    COSINE = "cosine"


def _metric_name(metric: Any, default: str = "cosine") -> str:
    if metric is None:
        return default
    if isinstance(metric, (USearchMetricKind, BruteForceKnnMetricKind)):
        return metric.value
    return str(metric)


class TpuKnn(EngineInnerIndex):
    """Exact dense KNN over a corpus on ``device`` (default ``"cuda"``: the
    hand-written block top-k kernel answers the queries). ``mesh=`` shards
    the corpus's rows over the mesh ``axis``; its devices replace
    ``device``."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
        *,
        dimensions: int | None = None,
        reserved_space: int = 1024,
        metric: Any = None,
        embedder: Any = None,
        mesh: Any = None,
        axis: str = "data",
        device: str = "cuda",
    ):
        metric_s = _metric_name(metric)
        super().__init__(
            data_column,
            metadata_column,
            index_factory=lambda: TpuDenseKnnIndex(
                dimensions=dimensions,
                metric=metric_s,
                reserved_space=reserved_space,
                mesh=mesh,
                axis=axis,
                device=device,
            ),
            embedder=embedder,
        )
        self.dimensions = dimensions
        self.reserved_space = reserved_space
        self.metric = metric_s
        self.device = device


class BruteForceKnn(TpuKnn):
    """Reference-parity class (stdlib/indexing/nearest_neighbors.py:170);
    the same execution as ``TpuKnn``."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
        *,
        dimensions: int | None = None,
        reserved_space: int = 1024,
        auxiliary_space: int = 512,
        metric: Any = None,
        embedder: Any = None,
        **kwargs: Any,
    ):
        super().__init__(
            data_column,
            metadata_column,
            dimensions=dimensions,
            reserved_space=reserved_space,
            metric=metric,
            embedder=embedder,
            **kwargs,
        )


class USearchKnn(TpuKnn):
    """Reference-parity class (stdlib/indexing/nearest_neighbors.py:65).
    USearch's HNSW knobs are accepted for API compatibility; retrieval is
    exact (recall 1.0 ≥ any HNSW setting)."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
        *,
        dimensions: int | None = None,
        reserved_space: int = 1024,
        metric: Any = None,
        connectivity: int = 0,
        expansion_add: int = 0,
        expansion_search: int = 0,
        embedder: Any = None,
        **kwargs: Any,
    ):
        super().__init__(
            data_column,
            metadata_column,
            dimensions=dimensions,
            reserved_space=reserved_space,
            metric=metric,
            embedder=embedder,
            **kwargs,
        )


class LshKnn(EngineInnerIndex):
    """LSH-bucketed approximate KNN (reference:
    stdlib/indexing/nearest_neighbors.py:262); the projections run on
    ``device``."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
        *,
        dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        embedder: Any = None,
        device: str = "cuda",
    ):
        metric = "cosine" if str(distance_type) == "cosine" else "l2sq"
        super().__init__(
            data_column,
            metadata_column,
            index_factory=lambda: LshKnnIndex(
                dimensions=dimensions,
                n_or=n_or,
                n_and=n_and,
                bucket_length=bucket_length,
                metric=metric,
                device=device,
            ),
            embedder=embedder,
        )
        self.device = device


# --- factories (reference: nearest_neighbors.py:407+) -----------------------


@dataclass(kw_only=True)
class TpuKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    reserved_space: int = 1024
    metric: Any = None
    embedder: Any = None
    mesh: Any = None
    device: str = "cuda"

    def build_inner_index(self, data_column, metadata_column=None):
        return TpuKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            mesh=self.mesh,
            device=self.device,
        )


def _probe_dimensions(embedder) -> int:
    """Dimensionality of an embedder (the reference's factories defer
    dimensions to the embedder). API embedders expose
    ``get_embedding_dimension()``; plain functions and UDF wrappers are
    called on a sample input, awaiting coroutines."""
    getter = getattr(embedder, "get_embedding_dimension", None)
    if callable(getter):
        return int(getter())
    fn = getattr(embedder, "__wrapped__", embedder)
    out = fn(".")
    if hasattr(out, "__await__"):
        import asyncio

        out = asyncio.run(out)
    return len(out)


def _check_factory_args(dimensions, embedder) -> None:
    # reference rule: embedder-backed indexes can probe their own output
    # dimension; without one, dimensions must be given explicitly
    if dimensions is None and embedder is None:
        raise ValueError(
            "Either `dimensions` or `embedder` must be provided to index "
            "factory."
        )


@dataclass(kw_only=True)
class BruteForceKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    reserved_space: int = 1024
    auxiliary_space: int = 512
    metric: Any = None
    embedder: Any = None
    device: str = "cuda"

    def __post_init__(self):
        _check_factory_args(self.dimensions, self.embedder)

    def build_inner_index(self, data_column, metadata_column=None):
        return BruteForceKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            device=self.device,
        )


@dataclass(kw_only=True)
class UsearchKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    reserved_space: int = 1024
    metric: Any = None
    connectivity: int = 0
    expansion_add: int = 0
    expansion_search: int = 0
    embedder: Any = None
    device: str = "cuda"

    def __post_init__(self):
        _check_factory_args(self.dimensions, self.embedder)

    def build_inner_index(self, data_column, metadata_column=None):
        return USearchKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            device=self.device,
        )


@dataclass(kw_only=True)
class LshKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    n_or: int = 20
    n_and: int = 10
    bucket_length: float = 10.0
    distance_type: str = "euclidean"
    embedder: Any = None
    device: str = "cuda"

    def __post_init__(self):
        _check_factory_args(self.dimensions, self.embedder)

    def build_inner_index(self, data_column, metadata_column=None):
        if self.dimensions is None:
            # LSH needs the projections' width up front; probe the embedder
            # (the dense indexes infer it at the first row instead)
            self.dimensions = _probe_dimensions(self.embedder)
        return LshKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions,
            n_or=self.n_or,
            n_and=self.n_and,
            bucket_length=self.bucket_length,
            distance_type=self.distance_type,
            embedder=self.embedder,
            device=self.device,
        )


class IvfKnn(EngineInnerIndex):
    """Two-level IVF index: coarse quantization by matmul, exact fine
    scoring — the sub-linear tier (design note: ``ops/ivf.py``; reference
    counterpart: usearch HNSW, src/external_integration/
    usearch_integration.rs:20). Training and assignment run on ``device``."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
        *,
        dimensions: int | None = None,
        metric: Any = None,
        n_clusters: int | None = None,
        n_probe: int | None = None,
        min_train: int = 4096,
        embedder: Any = None,
        device: str = "cuda",
    ):
        metric_s = _metric_name(metric)
        super().__init__(
            data_column,
            metadata_column,
            index_factory=lambda: IvfKnnIndex(
                dimensions=dimensions,
                metric=metric_s,
                n_clusters=n_clusters,
                n_probe=n_probe,
                min_train=min_train,
                device=device,
            ),
            embedder=embedder,
        )
        self.dimensions = dimensions
        self.metric = metric_s
        self.device = device


@dataclass(kw_only=True)
class IvfKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    metric: Any = None
    n_clusters: int | None = None
    n_probe: int | None = None
    min_train: int = 4096
    embedder: Any = None
    device: str = "cuda"

    def __post_init__(self):
        _check_factory_args(self.dimensions, self.embedder)

    def build_inner_index(self, data_column, metadata_column=None):
        return IvfKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions,
            metric=self.metric,
            n_clusters=self.n_clusters,
            n_probe=self.n_probe,
            min_train=self.min_train,
            embedder=self.embedder,
            device=self.device,
        )
