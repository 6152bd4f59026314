"""KNN classifiers: the port's own copy of
``pathway_tpu/stdlib/ml/classifiers/__init__.py`` (reference:
stdlib/ml/classifiers/_knn_lsh.py — an LSH-bucketed KNN vote; in both
packages the candidate search is exact dense top-k through ``KNNIndex``).

The trainers take ``device=`` among their keyword arguments (default
``"cuda"``) and pass it to ``KNNIndex``; ``knn_lsh_classify`` retrains on
the same device. ``type="cosine"`` searches with the hand-written
``block_topk`` kernel; ``"euclidean"`` (the default) takes the torch
matmul path, as it takes the XLA path in the JAX package. Nothing is left
out."""

from __future__ import annotations

from enum import Enum
from typing import Any

from pathway_tpu_torch.internals.common import apply_with_type
from pathway_tpu_torch.internals.table import Table


class DistanceTypes(Enum):
    EUCLIDEAN = "euclidean"
    COSINE = "cosine"


def knn_lsh_classifier_train(
    data: Table,
    L: int = 20,
    type: str = "euclidean",
    **kwargs: Any,
):
    """Train a KNN 'classifier' — returns a function that labels query
    points by majority vote over the k nearest training rows.

    ``data`` needs columns ``data`` (vector) and ``label``; ``device`` in
    ``kwargs`` places the index (default ``"cuda"``)."""
    from pathway_tpu_torch.stdlib.ml.index import KNNIndex

    dim = kwargs.get("d") or kwargs.get("dimensions")
    index = KNNIndex(
        data.data,
        data,
        n_dimensions=dim,
        distance_type=str(type),
        device=kwargs.get("device", "cuda"),
    )

    def label_query(queries: Table, k: int = 3) -> Table:
        matches = index.get_nearest_items(queries.data, k=k)

        def majority(labels) -> Any:
            if not labels:
                return None
            counts: dict = {}
            for l in labels:
                counts[l] = counts.get(l, 0) + 1
            return max(counts.items(), key=lambda kv: (kv[1], str(kv[0])))[0]

        return matches.select(
            predicted_label=apply_with_type(majority, Any, matches.label)
        )

    label_query._train_args = (data, L, type, dict(kwargs))
    return label_query


def knn_lsh_train(*args, **kwargs):
    return knn_lsh_classifier_train(*args, **kwargs)


def knn_lsh_generic_classifier_train(*args, **kwargs):
    return knn_lsh_classifier_train(*args, **kwargs)


def knn_lsh_euclidean_classifier_train(data, d, M, L, A, **kwargs):
    """Euclidean-LSH-parameterized trainer (reference: _knn_lsh.py:293).
    The TPU build's candidate search is exact dense top-k, so the LSH
    parameters select the distance metric; d doubles as the dimension
    hint."""
    return knn_lsh_classifier_train(data, L=L, type="euclidean", d=d, **kwargs)


def knn_lsh_classify(knn_model, data_labels, queries, k):
    """Classify queries by majority vote over the k nearest training rows
    (reference: _knn_lsh.py:306). ``data_labels`` must share the training
    table's universe (one label per training row); its labels override any
    label column the model was trained with."""
    cache = getattr(knn_model, "_classify_cache", None)
    if cache is None:
        cache = knn_model._classify_cache = {}
    entry = cache.get(id(data_labels))
    if entry is None or entry[0] is not data_labels:
        data, L, type_, kwargs = knn_model._train_args
        labels = data_labels.restrict(data)
        enriched = data.with_columns(label=labels.label)
        relabeled = knn_lsh_classifier_train(
            enriched, L=L, type=type_, **kwargs
        )
        # hold data_labels so id() can't alias a collected table, and so
        # repeated classify calls reuse one index build
        cache[id(data_labels)] = (data_labels, relabeled)
        entry = cache[id(data_labels)]
    return entry[1](queries, k=k)


from pathway_tpu_torch.stdlib.ml.classifiers._lsh import (  # noqa: E402
    generate_cosine_lsh_bucketer,
    generate_euclidean_lsh_bucketer,
    lsh,
)
from pathway_tpu_torch.stdlib.ml.classifiers._clustering_via_lsh import (  # noqa: E402
    clustering_via_lsh,
)

__all__ = [
    "DistanceTypes",
    "clustering_via_lsh",
    "generate_cosine_lsh_bucketer",
    "generate_euclidean_lsh_bucketer",
    "knn_lsh_classifier_train",
    "knn_lsh_classify",
    "knn_lsh_euclidean_classifier_train",
    "knn_lsh_generic_classifier_train",
    "knn_lsh_train",
    "lsh",
]
