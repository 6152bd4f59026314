"""The port's own copy of ``pathway_tpu/stdlib/utils/filtering.py``, whole.

Filtering helpers (reference: stdlib/utils/filtering.py)."""

from __future__ import annotations


def argmax_rows(table, *on, what=None):
    import pathway_tpu_torch as pw

    grouped = table.groupby(*on)
    best = grouped.reduce(argmax_id=pw.reducers.argmax(what))
    return table.having(best.argmax_id)


def argmin_rows(table, *on, what=None):
    import pathway_tpu_torch as pw

    grouped = table.groupby(*on)
    best = grouped.reduce(argmin_id=pw.reducers.argmin(what))
    return table.having(best.argmin_id)
