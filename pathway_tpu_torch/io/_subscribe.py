"""The port's own copy of ``pathway_tpu/io/_subscribe.py``. pw.io.subscribe (reference: python/pathway/io/_subscribe.py)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import OutputNode
from pathway_tpu_torch.internals import parse_graph
from pathway_tpu_torch.internals.api import Pointer
from pathway_tpu_torch.internals.table import Table


# callback type aliases (reference: io/_subscribe.py)
OnChangeCallback = Callable[..., None]
OnFinishCallback = Callable[[], None]


def subscribe(
    table: Table,
    on_change: Callable[..., Any],
    on_end: Callable[[], Any] | None = None,
    on_time_end: Callable[[int], Any] | None = None,
    *,
    skip_persisted_batch: bool = True,
    name: str | None = None,
    sort_by: Any = None,
) -> None:
    """Call ``on_change(key, row, time, is_addition)`` for every change."""
    col_names = table.column_names()

    def on_batch(t: int, batch: DiffBatch) -> None:
        from pathway_tpu_torch.internals.api import Error

        for k, d, vals in batch.iter_rows():
            if any(isinstance(v, Error) for v in vals):
                # reference: output connectors skip rows carrying Error
                # values (the error is already in the log)
                continue
            row = dict(zip(col_names, vals))
            on_change(key=Pointer(k), row=row, time=t, is_addition=d > 0)
        if on_time_end is not None:
            on_time_end(t)

    def end() -> None:
        if on_end is not None:
            on_end()

    node = OutputNode(table._node, on_batch, end)
    parse_graph.G.add_output(node)
