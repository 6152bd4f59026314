"""Own copy of ``pathway_tpu/io/pyfilesystem.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.pyfilesystem — read from any fsspec/PyFilesystem-style source
(upstream Pathway: python/pathway/io/pyfilesystem — reads binary objects from a
PyFilesystem FS object). Accepts either an fsspec filesystem or a
PyFilesystem2 FS (duck-typed: needs listdir/open or find/open)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import StaticSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


class _PyFsSource(StaticSource):
    def __init__(self, source, path):
        super().__init__(["data", "path"])
        self.fs = source
        self.path = path

    def _list(self) -> list[str]:
        if hasattr(self.fs, "find"):  # fsspec
            return sorted(self.fs.find(self.path))
        if hasattr(self.fs, "walk"):  # pyfilesystem2
            return sorted(
                p.path if hasattr(p, "path") else str(p)
                for p in self.fs.walk.files(self.path or "/")
            )
        raise TypeError("unsupported filesystem object")

    def _read(self, p: str) -> bytes:
        if hasattr(self.fs, "open"):
            mode = "rb"
            with self.fs.open(p, mode) as f:
                return f.read()
        raise TypeError("unsupported filesystem object")

    def events(self):
        rows = []
        for p in self._list():
            data = self._read(p)
            rows.append((int(ref_scalar(p)), 1, (data, p)))
        if rows:
            yield 0, DiffBatch.from_rows(rows, self.column_names)


def read(
    source: Any,
    path: str = "",
    *,
    mode: str = "static",
    with_metadata: bool = False,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    src = _PyFsSource(source, path)
    node = InputNode(src, src.column_names)
    return Table._from_node(
        node, {"data": dt.BYTES, "path": dt.STR}, Universe()
    )
