"""pw.io.jsonlines — own copy of ``pathway_tpu/io/jsonlines.py`` (upstream
Pathway: python/pathway/io/jsonlines)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import fs as _fs


def read(
    path: str,
    *,
    schema: Any = None,
    mode: str = "streaming",
    json_field_paths: dict | None = None,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
):
    return _fs.read(
        path,
        format="json",
        schema=schema,
        mode=mode,
        json_field_paths=json_field_paths,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        **kwargs,
    )


def write(table, filename: str, *, name: str | None = None, **kwargs) -> None:
    _fs.write(table, filename, format="json", **kwargs)
