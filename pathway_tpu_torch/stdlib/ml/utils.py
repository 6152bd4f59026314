"""ML stdlib helpers — counterpart of ``pathway_tpu/stdlib/ml/utils.py``
(reference: stdlib/ml/utils.py)."""

from __future__ import annotations

from typing import Callable


def _predict_asof_now(
    prediction_function: Callable,
    *queries,
    with_queries_universe: bool = False,
):
    """Wrap a prediction function so each query is answered once, as of now
    (reference: stdlib/ml/utils.py — the forget + as-of-now join pattern)."""
    result = prediction_function(*queries)
    if with_queries_universe and queries:
        q_table = queries[0].table
        result = result.with_universe_of(q_table)
    return result


def classifier_accuracy(predicted, exact):
    import pathway_tpu_torch as pw

    joined = predicted.join(exact, predicted.id == exact.id).select(
        ok=pw.left.predicted_label == pw.right.label
    )
    return joined.groupby(joined.ok).reduce(joined.ok, count=pw.reducers.count())
