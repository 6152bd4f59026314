"""pw.io.null — own copy of ``pathway_tpu/io/null.py``: a sink that discards
rows while still forcing computation (upstream Pathway: NullWriter,
src/connectors/data_storage.rs:1514)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io._utils import add_writer


def write(table, *args: Any, **kwargs: Any) -> None:
    add_writer(table, lambda t, batch: None)
