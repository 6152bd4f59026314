"""The port's own copy of ``pathway_tpu/xpacks/llm/utils.py``
(``combine_metadata``)."""

from __future__ import annotations

import pathway_tpu_torch as pw
from pathway_tpu_torch.xpacks.llm._utils import _is_text_with_meta, _to_dict


def combine_metadata(
    table,
    from_column="text",
    to_column="metadata",
    clean_from_column: bool = True,
):
    """Move the metadata half of (text, metadata) tuples in `from_column`
    into `to_column` (merging with any existing dict there, creating the
    column if absent); optionally strip `from_column` down to the text."""

    @pw.udf
    def move_metadata(text_with_meta, metadata) -> dict:
        if _is_text_with_meta(text_with_meta):
            return {**_to_dict(metadata), **_to_dict(text_with_meta[1])}
        return metadata

    @pw.udf
    def clean_metadata(text_with_meta) -> str:
        if _is_text_with_meta(text_with_meta):
            return text_with_meta[0]
        if isinstance(text_with_meta, str):
            return text_with_meta
        raise ValueError(
            "Expected string or tuple with string and dict, got "
            f"{text_with_meta}"
        )

    from_column_ref = (
        table[from_column] if isinstance(from_column, str) else from_column
    )
    if isinstance(to_column, str):
        if to_column not in table.column_names():
            table += table.select(**{to_column: dict()})
        to_column_ref = table[to_column]
    else:
        to_column_ref = to_column

    table = table.with_columns(
        **{
            to_column_ref.name: move_metadata(from_column_ref, to_column_ref),
            from_column_ref.name: (
                clean_metadata(from_column_ref)
                if clean_from_column
                else from_column_ref
            ),
        }
    )

    return table
