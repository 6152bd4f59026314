"""KNN inner indexes — counterpart of
``pathway_tpu/stdlib/indexing/nearest_neighbors.py`` (reference:
stdlib/indexing/nearest_neighbors.py: USearchKnn:65, BruteForceKnn:170,
LshKnn:262 + factories:407).

Every dense index is the same machine: a device-resident corpus searched
by exact top-k (``TpuDenseKnnIndex``; on CUDA the hand-written block top-k
kernel). ``USearchKnn`` / ``BruteForceKnn`` keep the reference's parameter
surfaces and lower to it; they take ``device=`` (default ``"cuda"``).
``LshKnn`` and ``IvfKnn`` (and their factories) are not ported and raise
``NotImplementedError`` (ROADMAP [index-kinds]), as does ``mesh=``
([mesh])."""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch._unported import INDEX_KINDS, MESH, unported
from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex
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
    hand-written block top-k kernel answers the queries). The reference's
    ``mesh=`` (a corpus sharded over devices) is not ported and raises."""

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
        if mesh is not None:
            raise unported("TpuKnn(mesh=...) (a sharded corpus)", MESH)
        metric_s = _metric_name(metric)
        super().__init__(
            data_column,
            metadata_column,
            index_factory=lambda: TpuDenseKnnIndex(
                dimensions=dimensions,
                metric=metric_s,
                reserved_space=reserved_space,
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


class _Unported:
    """An index kind of the reference that the port does not carry yet:
    constructing it raises, naming its ROADMAP tag."""

    def __init__(self, *args: Any, **kwargs: Any):
        raise unported(type(self).__name__, INDEX_KINDS)


class LshKnn(_Unported):
    """LSH-bucketed approximate KNN (reference: nearest_neighbors.py:262)."""


class LshKnnFactory(_Unported):
    pass


class IvfKnn(_Unported):
    """Two-level IVF index (reference counterpart: usearch HNSW)."""


class IvfKnnFactory(_Unported):
    pass
