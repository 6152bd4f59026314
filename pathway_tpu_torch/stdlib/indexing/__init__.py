"""pw.indexing — counterpart of ``pathway_tpu/stdlib/indexing``:
``DataIndex`` over the dense KNN indexes (``TpuKnn``, ``BruteForceKnn``,
``USearchKnn`` and their factories). ``LshKnn`` and ``IvfKnn`` raise
``NotImplementedError`` (ROADMAP [index-kinds]); ``TantivyBM25``,
``HybridIndex`` and the document-index helpers likewise.
"""

from pathway_tpu_torch._unported import BM25_HYBRID, unported
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
from pathway_tpu_torch.stdlib.indexing.retrievers import AbstractRetrieverFactory


def _bm25_or_hybrid(name: str):
    def make(*args, **kwargs):
        raise unported(name, BM25_HYBRID)

    make.__name__ = make.__qualname__ = name
    return make


TantivyBM25 = _bm25_or_hybrid("TantivyBM25")
TantivyBM25Factory = _bm25_or_hybrid("TantivyBM25Factory")
HybridIndex = _bm25_or_hybrid("HybridIndex")
HybridIndexFactory = _bm25_or_hybrid("HybridIndexFactory")
default_vector_document_index = _bm25_or_hybrid("default_vector_document_index")
default_brute_force_knn_document_index = _bm25_or_hybrid(
    "default_brute_force_knn_document_index"
)
default_lsh_knn_document_index = _bm25_or_hybrid("default_lsh_knn_document_index")
default_usearch_knn_document_index = _bm25_or_hybrid(
    "default_usearch_knn_document_index"
)
default_full_text_document_index = _bm25_or_hybrid("default_full_text_document_index")

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
