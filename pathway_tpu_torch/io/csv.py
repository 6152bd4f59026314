"""pw.io.csv — own copy of ``pathway_tpu/io/csv.py`` (upstream Pathway:
python/pathway/io/csv)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import fs as _fs


class CsvParserSettings:
    def __init__(
        self,
        delimiter: str = ",",
        quote: str = '"',
        escape: str | None = None,
        enable_double_quote_escapes: bool = True,
        enable_quoting: bool = True,
        comment_character: str | None = None,
    ):
        self.delimiter = delimiter
        self.quote = quote
        self.escape = escape
        self.enable_double_quote_escapes = enable_double_quote_escapes
        self.enable_quoting = enable_quoting
        self.comment_character = comment_character


def read(
    path: str,
    *,
    schema: Any = None,
    csv_settings: CsvParserSettings | None = None,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
):
    return _fs.read(
        path,
        format="csv",
        schema=schema,
        csv_settings=csv_settings,
        mode=mode,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        **kwargs,
    )


def write(table, filename: str, *, name: str | None = None, **kwargs) -> None:
    _fs.write(table, filename, format="csv", **kwargs)
