"""Own copy of ``pathway_tpu/io/_utils.py``. Shared connector plumbing:
output-node registration + row conversion (upstream analog: src/connectors/data_format.rs Formatter machinery —
formatters turn diff rows into sink payloads)."""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import OutputNode
from pathway_tpu_torch.internals import parse_graph
from pathway_tpu_torch.internals.json import Json


def jsonable(v: Any) -> Any:
    if isinstance(v, Json):
        return v.value
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    if isinstance(v, tuple):
        return [jsonable(x) for x in v]
    return v


def row_dicts(batch: DiffBatch, column_names: Sequence[str], t: int):
    """Yield (key, diff, {col: jsonable}) per row."""
    for k, d, vals in batch.iter_rows():
        yield k, d, {n: jsonable(v) for n, v in zip(column_names, vals)}


def add_writer(
    table,
    on_batch: Callable[[int, DiffBatch], None],
    on_end: Callable[[], None] | None = None,
) -> None:
    node = OutputNode(table._node, on_batch, on_end)
    parse_graph.G.add_output(node)


def require(module_name: str, connector: str, hint: str | None = None):
    """Lazy client-library import with a actionable error
    (the image gates which service SDKs exist; connectors degrade to a
    clear message, not a crash at import time)."""
    import importlib

    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        msg = (
            f"pw.io.{connector} requires the {module_name!r} package, which "
            f"is not installed in this environment."
        )
        if hint:
            msg += " " + hint
        raise ImportError(msg) from e
