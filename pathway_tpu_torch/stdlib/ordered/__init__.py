"""The port's own copy of ``pathway_tpu/stdlib/ordered/__init__.py``. pw.ordered — order-aware helpers (reference: stdlib/ordered/diff.py)."""

from __future__ import annotations

from typing import Any

import pathway_tpu_torch.internals.dtype as dt
from pathway_tpu_torch.internals.expression import ColumnReference


def diff(
    table,
    timestamp: Any,
    *values: ColumnReference,
    instance: Any = None,
) -> Any:
    """Compute per-row difference vs the previous row in timestamp order
    (reference: stdlib/ordered/diff.py, built on sort prev/next pointers)."""
    import pathway_tpu_torch as pw

    sorted_ptrs = table.sort(key=timestamp, instance=instance)
    with_prev = table.with_columns(_prev=sorted_ptrs.prev)
    # one indexer shared by every value column (an ix per column would
    # duplicate the full table state per diffed column)
    prev_rows = table.ix(with_prev._prev, optional=True)
    out_cols = {}
    for v in values:
        name = f"diff_{v.name}"
        # first row per instance has no predecessor: None, not an error
        out_cols[name] = pw.require(
            v - prev_rows[v.name], prev_rows[v.name]
        )
    return table.select(**out_cols)


__all__ = ["diff"]
