"""pw.indexing — counterpart of ``pathway_tpu/stdlib/indexing``: ``DataIndex``
over the dense KNN indexes (``TpuKnn``, ``BruteForceKnn``, ``USearchKnn``),
``LshKnn``, ``IvfKnn``, ``TantivyBM25`` and ``HybridIndex``, their factories,
and the default document-index helpers.
"""

from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    IvfKnn,
    IvfKnnFactory,
    LshKnn,
    LshKnnFactory,
    TpuKnn,
    TpuKnnFactory,
    USearchKnn,
    USearchMetricKind,
    UsearchKnnFactory,
)
from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25, TantivyBM25Factory
from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridIndex, HybridIndexFactory
from pathway_tpu_torch.stdlib.indexing.retrievers import AbstractRetrieverFactory
from pathway_tpu_torch.stdlib.indexing.vector_document_index import (
    default_brute_force_knn_document_index,
    default_lsh_knn_document_index,
    default_usearch_knn_document_index,
    default_vector_document_index,
)
from pathway_tpu_torch.stdlib.indexing.full_text_document_index import (
    default_full_text_document_index,
)

__all__ = [
    "BruteForceKnnMetricKind",
    "USearchMetricKind",
    "DataIndex",
    "InnerIndex",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "IvfKnn",
    "IvfKnnFactory",
    "LshKnn",
    "LshKnnFactory",
    "TpuKnn",
    "TpuKnnFactory",
    "USearchKnn",
    "UsearchKnnFactory",
    "TantivyBM25",
    "TantivyBM25Factory",
    "HybridIndex",
    "HybridIndexFactory",
    "AbstractRetrieverFactory",
    "default_vector_document_index",
    "default_brute_force_knn_document_index",
    "default_lsh_knn_document_index",
    "default_usearch_knn_document_index",
    "default_full_text_document_index",
]
