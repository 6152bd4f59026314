"""The port's own copy of ``pathway_tpu/stdlib/utils/col.py``, whole; pandas
is imported only inside ``multiapply_all_rows``; ``unpack_col_dict``'s date
and duration columns go through ``.dt``, which raises naming [temporal].

Column manipulation helpers (reference: stdlib/utils/col.py)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.table import Table


def unpack_col(column, *unpacked_columns: str, schema: Any = None) -> Table:
    """Unpack a tuple column into named columns."""
    table = None
    for ref in column._dependencies():
        table = ref.table
        break
    assert table is not None
    if schema is not None:
        names = list(schema.column_names())
    else:
        names = [
            c if isinstance(c, str) else c.name for c in unpacked_columns
        ]
    exprs = {name: column[i] for i, name in enumerate(names)}
    return table.select(**exprs)


def multiapply_all_rows(
    *cols: Any,
    fun: Any,
    result_col_names: Any,
) -> Table:
    """Apply ``fun`` to whole columns at once: it receives one list per
    input column (aligned by row) and returns one list per output column
    (reference: stdlib/utils/col.py:194). The result table shares the
    input universe."""
    from pathway_tpu_torch.internals import dtype as dt
    from pathway_tpu_torch.internals.schema import schema_from_types
    from pathway_tpu_torch.stdlib.utils.pandas_transformer import (
        pandas_transformer,
    )

    table = cols[0].table
    in_names = [f"_c{i}" for i in range(len(cols))]
    sel = table.select(**dict(zip(in_names, cols)))
    out_names = [
        c if isinstance(c, str) else c.name for c in result_col_names
    ]
    out_schema = schema_from_types(**{n: dt.ANY for n in out_names})

    @pandas_transformer(output_schema=out_schema, output_universe=0)
    def inner(df):
        import pandas as pd

        results = fun(*[df[n].tolist() for n in in_names])
        return pd.DataFrame(
            dict(zip(out_names, results)), index=df.index
        )

    return inner(sel)


def apply_all_rows(
    *cols: Any, fun: Any, result_col_name: Any
) -> Table:
    """Single-output variant of multiapply_all_rows (reference:
    stdlib/utils/col.py:241)."""
    return multiapply_all_rows(
        *cols,
        fun=lambda *lists: (fun(*lists),),
        result_col_names=[result_col_name],
    )


def groupby_reduce_majority(column, value_column):
    """Per group, the MOST FREQUENT value (a real majority vote — count
    per (group, value), then argmax; reference: col.py
    groupby_reduce_majority)."""
    import pathway_tpu_torch as pw

    table = column.table
    name = column.name
    if name == "majority":
        raise ValueError(
            "groupby_reduce_majority: the grouping column cannot be named "
            "'majority' (it collides with the result column)"
        )
    sel = table.select(_g=column, _v=value_column)
    counted = sel.groupby(sel._g, sel._v).reduce(
        sel._g, sel._v, _c=pw.reducers.count()
    )
    return counted.groupby(counted._g).reduce(
        **{name: counted._g},
        majority=pw.reducers.argmax(counted._c, counted._v),
    )


def flatten_column(column, origin_id: str | None = "origin_id"):
    table = None
    for ref in column._dependencies():
        table = ref.table
        break
    assert table is not None
    flat = table.flatten(column)
    return flat


def unpack_col_dict(column, schema) -> Table:
    """Unpack a Json-object column into typed columns per ``schema``
    (reference: stdlib/utils/col.py:97-188). Non-optional target dtypes
    unwrap (a JSON null raises at runtime); optional ones map null→None.
    Datetimes round-trip via nanosecond ISO strings, durations via
    nanosecond ints (the Json serialization format)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import dtype as dt

    table = None
    for ref in column._dependencies():
        table = ref.table
        break
    assert table is not None

    dtypes = {
        name: schema.__columns__[name].dtype for name in schema.column_names()
    }

    def convert(name, col):
        target = dtypes[name]
        inner = target.strip_optional()
        is_opt = target.is_optional()

        def optional(col, op):
            if is_opt:
                return pw.if_else(col == pw.Json.NULL, None, op(col))
            return op(col)

        if inner == dt.JSON:
            result = col
        elif inner == dt.BOOL:
            result = col.as_bool()
        elif inner == dt.FLOAT:
            result = col.as_float()
        elif inner == dt.INT:
            result = col.as_int()
        elif inner == dt.STR:
            result = col.as_str()
        elif inner == dt.DATE_TIME_NAIVE:
            result = optional(
                col,
                lambda c: pw.unwrap(c.as_str()).dt.strptime(
                    "%Y-%m-%dT%H:%M:%S.%f"
                ),
            )
        elif inner == dt.DATE_TIME_UTC:
            result = optional(
                col,
                lambda c: pw.unwrap(c.as_str()).dt.strptime(
                    "%Y-%m-%dT%H:%M:%S.%f%z"
                ),
            )
        elif inner == dt.DURATION:
            result = optional(
                col, lambda c: pw.unwrap(c.as_int()).dt.to_duration("ns")
            )
        else:
            raise TypeError(
                f"Unsupported conversion from pw.Json to {target.typehint}"
            )
        return result if is_opt else pw.unwrap(result)

    kw = {
        name: convert(name, column.get(name)) for name in schema.column_names()
    }
    return table.select(**kw).update_types(
        **{n: dtypes[n].typehint for n in dtypes}
    )
