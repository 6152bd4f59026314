"""(Pre)clustering via LSH: the port's own copy of
``pathway_tpu/stdlib/ml/classifiers/_clustering_via_lsh.py`` (reference:
stdlib/ml/classifiers/_clustering_via_lsh.py:1-79): bucket rows with an
LSH bucketer, average each (bucket, band) into a weighted representative,
KMeans the representatives, then label each row by majority vote over its
buckets' cluster labels. scikit-learn is imported when the KMeans step
runs; the card's machine has none, so this runs where it is installed.
Nothing is left out."""

from __future__ import annotations

import numpy as np

from pathway_tpu_torch.internals.common import apply_with_type
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this
from pathway_tpu_torch.stdlib.ml.classifiers._lsh import lsh
from pathway_tpu_torch.stdlib.utils.col import (
    apply_all_rows,
    groupby_reduce_majority,
)

import pathway_tpu_torch.reducers as reducers


def clustering_via_lsh(data: Table, bucketer, k: int) -> Table:
    """Label each row of ``data`` (column ``data``: np.ndarray) with a
    cluster id in [0, k). Requires scikit-learn at call time."""
    flat = lsh(data, bucketer, origin_id="data_id", include_data=True)

    representatives = (
        flat.groupby(flat.bucketing, flat.band)
        .reduce(
            flat.bucketing,
            flat.band,
            sum=reducers.sum(flat.data),
            count=reducers.count(),
        )
        .select(
            this.bucketing,
            this.band,
            data=apply_with_type(
                lambda s, c: np.asarray(s) / c, np.ndarray, this.sum, this.count
            ),
            weight=this.count,
        )
    )

    def clustering(vecs, weights):
        from sklearn.cluster import KMeans

        km = KMeans(n_clusters=k, init="k-means++", random_state=0, n_init=10)
        km.fit(np.stack(vecs), sample_weight=np.asarray(weights, float))
        return [int(label) for label in km.labels_]

    labels = apply_all_rows(
        representatives.data,
        representatives.weight,
        fun=clustering,
        result_col_name="label",
    )
    representatives = representatives.with_columns(labels)

    votes = flat.join(
        representatives,
        flat.bucketing == representatives.bucketing,
        flat.band == representatives.band,
    ).select(flat.data_id, representatives.label)

    result = groupby_reduce_majority(votes.data_id, votes.label)
    relabeled = result.select(label=result.majority, _nid=result.data_id)
    return relabeled.with_id(relabeled._nid).without("_nid")
