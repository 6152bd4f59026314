"""pw.debug — static fixtures and capture-based output: the port's own copy
of ``pathway_tpu/debug/__init__.py`` (reference: python/pathway/debug/
__init__.py:207-709) — ``table_from_markdown`` (with ``__time__``/
``__diff__``), ``table_from_rows``, ``table_from_pandas``,
``table_from_parquet``, ``StreamGenerator``, ``table_to_dicts``,
``table_to_pandas``, ``table_to_parquet``,
``compute_and_print[_update_stream]``, ``assert_table_equality[_wo_index]``
``trace``/``trace_tree`` over the port's tracer, copied as they are, and
``diagnose`` (the Graph Doctor over a table's upstream cone). Capture with
``persistence_config`` restores and records through the persistence glue, as
in the reference. The module imports no pandas: the pandas and parquet
functions and ``StreamGenerator``'s pandas and markdown methods import it
(and pyarrow, through pandas) when called."""

from __future__ import annotations

import re
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import InputNode, OutputNode
from pathway_tpu_torch.engine.runtime import Runtime, StaticSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import Pointer, ref_scalar, sequential_key
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe

# debug fixtures with IDENTICAL key sets share one Universe object, so
# row-aligned cross-fixture expressions (select(num=t_num.num)) build,
# while differing key sets stay unrelated and raise (reference: the test
# utils' universe deduction over trusted fixture ids)
_FIXTURE_UNIVERSES: dict[frozenset, Universe] = {}


def _fixture_universe(keys: "Iterable[int]") -> Universe:
    key = frozenset(keys)
    u = _FIXTURE_UNIVERSES.get(key)
    if u is None:
        u = Universe()
        _FIXTURE_UNIVERSES[key] = u
    return u


def _fixture_universe_from_events(events: dict) -> Universe:
    """Universe keyed by the fixture's NET key set: retracted rows do not
    count, so only fixtures ending with identical keys unify."""
    net: dict[int, int] = {}
    for _t, rows in sorted(events.items()):
        for k, d, _v in rows:
            net[k] = net.get(k, 0) + d
    return _fixture_universe(k for k, c in net.items() if c > 0)


class _RowsSource(StaticSource):
    # debug fixtures are not persistable connectors: re-read fresh on every
    # run instead of being offset-suppressed/logged (reference: persistence
    # applies to sources with persistent ids only)
    transient = True

    def __init__(self, column_names, events):
        super().__init__(column_names)
        # columnarize at declare time — ingestion-to-columnar conversion is
        # I/O-layer work and must not be re-paid on every run of the graph
        self._events = [
            (t, DiffBatch.from_rows(rows, column_names)) for t, rows in events
        ]

    def events(self):
        yield from self._events


def _parse_value(s: str) -> Any:
    s = s.strip()
    if s == "":
        return None  # empty markdown cell = None (reference semantics)
    if s in ("None", "null"):
        return None
    if s == "True" or s == "true":
        return True
    if s == "False" or s == "false":
        return False
    if (s.startswith('"') and s.endswith('"')) or (
        s.startswith("'") and s.endswith("'")
    ):
        return s[1:-1]
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if s.startswith("(") or s.startswith("["):
        import ast

        try:
            v = ast.literal_eval(s)
            if isinstance(v, list):
                return tuple(v)
            return v
        except (ValueError, SyntaxError):
            pass
    return s


def _dtype_for(values: list[Any]) -> dt.DType:
    non_null = [v for v in values if v is not None]
    if not non_null:
        return dt.ANY
    types = {type(v) for v in non_null}
    if types <= {bool}:
        out: dt.DType = dt.BOOL
    elif types <= {int, bool}:
        out = dt.INT
    elif types <= {int, float, bool}:
        out = dt.FLOAT
    elif types <= {str}:
        out = dt.STR
    elif types <= {tuple}:
        out = dt.ANY_TUPLE
    else:
        out = dt.ANY
    if len(non_null) != len(values):
        out = dt.Optional_(out)
    return out


def _split_markdown(table_def: str, require_pipes: bool = False):
    """Shared markdown tokenizer: (header, data_rows, raw_ids|None) —
    separator-row filtering, escaped-pipe splitting, edge-cell stripping
    and leading-id-column detection used by table_from_markdown and
    StreamGenerator.table_from_markdown. ``require_pipes`` rejects
    whitespace-split fallback (split_on_whitespace=False semantics)."""
    lines = [l for l in table_def.strip().splitlines() if l.strip()]
    if not lines:
        raise ValueError("table_from_markdown: empty table definition")
    # separator rows (|---|:--|) need a dash: a dashless all-empty row
    # like "   |   " is DATA — a row of Nones (reference semantics)
    lines = [
        l
        for l in lines
        if not (re.fullmatch(r"[\s|:+-]+", l) and "-" in l)
    ]
    if "|" in lines[0]:
        split = [
            [c.strip() for c in re.split(r"(?<!\\)\|", l)] for l in lines
        ]
        # "| a | b |" style: every row starts/ends with an empty cell
        if all(r and r[0] == "" for r in split):
            split = [r[1:] for r in split]
        if all(r and r[-1] == "" for r in split):
            split = [r[:-1] for r in split]
        header = split[0]
        data = split[1:]
        has_id_col = header[0] in ("", "id")
    else:
        if require_pipes:
            # single-column table: each line IS one cell (the reference's
            # split_on_whitespace=False semantics — a one-column table has
            # nothing to delimit, so full lines are the values)
            header = [lines[0].strip()]
            data = [[l] for l in lines[1:]]
            return header, data, None
        header = lines[0].split()
        if len(header) == 1:
            # single unnamed column: whole line is the value (strings with
            # spaces need no pipes)
            data = [[l.strip()] for l in lines[1:]]
        else:
            data = [l.split() for l in lines[1:]]
        has_id_col = header[0] == "id"
    ids = None
    if (
        not has_id_col
        and data
        and all(len(r) == len(header) + 1 for r in data)
    ):
        # header without a leading pipe but data rows carrying one extra
        # leading cell: that cell is the row id (reference T() accepts
        # "col | on" headers over "1 | a | 11" rows)
        has_id_col = True
    if has_id_col:
        # leading unnamed column = explicit row ids (reference style)
        if header and header[0] in ("", "id"):
            header = header[1:]
        ids = [r[0] for r in data]
        data = [r[1:] for r in data]
    return header, data, ids


def table_from_markdown(
    table_def: str,
    id_from: Sequence[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: Any = None,
    split_on_whitespace: bool | None = None,
    _stream: bool = False,
) -> Table:
    """Parse a markdown / whitespace table. Special columns: ``__time__``
    (logical time), ``__diff__`` (+1/-1). ``split_on_whitespace=False``
    requires pipe delimiters (cells may contain spaces); the default
    auto-detects."""
    header, data, ids = _split_markdown(
        table_def, require_pipes=split_on_whitespace is False
    )
    col_names = [h for h in header if h not in ("__time__", "__diff__")]
    time_idx = header.index("__time__") if "__time__" in header else None
    diff_idx = header.index("__diff__") if "__diff__" in header else None
    if id_from is None and schema is not None:
        id_from = schema.primary_key_columns()

    events: dict[int, list] = {}
    counter = 0
    value_cols_idx = [
        i for i, h in enumerate(header) if h not in ("__time__", "__diff__")
    ]
    col_values: dict[str, list] = {n: [] for n in col_names}
    for ri, row in enumerate(data):
        parsed = [_parse_value(c) for c in row]
        t = int(parsed[time_idx]) if time_idx is not None else 0
        d = int(parsed[diff_idx]) if diff_idx is not None else 1
        vals = tuple(parsed[i] for i in value_cols_idx)
        if ids is not None:
            if unsafe_trusted_ids:
                key = int(_parse_value(ids[ri]))
            else:
                # hash the PARSED label ("1" -> int 1) so explicit markdown
                # ids match pointer_from(<value>) — the reference's id
                # derivation
                key = int(ref_scalar(_parse_value(ids[ri])))
        elif id_from:
            key = int(
                ref_scalar(*[vals[col_names.index(c)] for c in id_from])
            )
        elif unsafe_trusted_ids:
            # trusted ids: the raw row number IS the key (reference:
            # unsafe_make_pointer, ids_from_pandas:117-118)
            key = counter
        else:
            # reference derivation: unkeyed debug rows key by row number
            # through the SAME pointer hash as pointer_from(i)
            # (ids_from_pandas, reference internals/api.py:116-120)
            key = int(ref_scalar(counter))
        counter += 1
        for n, v in zip(col_names, vals):
            col_values[n].append(v)
        events.setdefault(t, []).append((key, d, vals))

    if schema is not None:
        dtypes = {n: schema.dtypes()[n] for n in col_names}
    else:
        dtypes = {n: _dtype_for(col_values[n]) for n in col_names}
    source = _RowsSource(col_names, sorted(events.items()))
    node = InputNode(source, col_names)
    return Table._from_node(
        node, dtypes, _fixture_universe_from_events(events)
    )


# reference test harness name
def T(table_def: str, **kwargs) -> Table:
    return table_from_markdown(table_def, **kwargs)


def table_from_rows(
    schema: Any,
    rows: Iterable[tuple],
    unsafe_trusted_ids: bool = False,
    is_stream: bool = False,
) -> Table:
    col_names = list(schema.column_names())
    coercers = _schema_coercers(schema, col_names)
    events: dict[int, list] = {}
    for i, row in enumerate(rows):
        if is_stream:
            *vals, t, d = row
        else:
            vals, t, d = list(row), 0, 1
        vals = [c(v) for c, v in zip(coercers, vals)]
        pk = schema.primary_key_columns()
        if pk:
            key = int(ref_scalar(*[vals[col_names.index(c)] for c in pk]))
        else:
            key = int(ref_scalar(i))
        events.setdefault(int(t), []).append((key, int(d), tuple(vals)))
    source = _RowsSource(col_names, sorted(events.items()))
    node = InputNode(source, col_names)
    return Table._from_node(
        node, dict(schema.dtypes()), _fixture_universe_from_events(events)
    )


def table_from_pandas(
    df: Any,
    id_from: Sequence[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: Any = None,
) -> Table:
    col_names = [c for c in df.columns if c not in ("__time__", "__diff__")]
    if id_from is None and schema is not None:
        # schema primary keys drive row identity, as in table_from_rows
        pk = schema.primary_key_columns()
        if pk:
            id_from = list(pk)
    coercers = (
        _schema_coercers(schema, col_names) if schema is not None else None
    )
    events: dict[int, list] = {}
    for i, (idx, row) in enumerate(df.iterrows()):
        t = int(row["__time__"]) if "__time__" in df.columns else 0
        d = int(row["__diff__"]) if "__diff__" in df.columns else 1
        vals = tuple(_np_unbox(row[c]) for c in col_names)
        if coercers is not None:
            vals = tuple(c(v) for c, v in zip(coercers, vals))
        if id_from:
            key = int(ref_scalar(*[vals[col_names.index(c)] for c in id_from]))
        else:
            # reference: keys come from the dataframe INDEX via ref_scalar
            key = int(ref_scalar(_np_unbox(idx)))
        events.setdefault(t, []).append((key, d, vals))
    if schema is not None:
        dtypes = {n: schema.dtypes()[n] for n in col_names}
    else:
        dtypes = {
            n: _dtype_for([e[2][i] for evs in events.values() for e in evs])
            for i, n in enumerate(col_names)
        }
    source = _RowsSource(col_names, sorted(events.items()))
    node = InputNode(source, col_names)
    return Table._from_node(node, dtypes, Universe())


def _np_unbox(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    # a pandas Timestamp, recognised without importing pandas
    if type(v).__name__ == "Timestamp" and v.tzinfo is not None:
        # aware values are stored normalized to UTC (reference: DateTimeUtc
        # is chrono Utc; offsets survive only in formatting)
        return v.tz_convert("UTC")
    return v


def _schema_coercers(schema: Any, col_names: Sequence[str]) -> list:
    """Per-column input coercion to the declared dtype: raw dicts/lists
    (and any datetimes inside them) become normalized Json, ints promote
    to float — the engine-boundary conversions the reference performs in
    value extraction (python_api.rs extract_value)."""
    from pathway_tpu_torch.internals import dtype as dt
    from pathway_tpu_torch.internals.json import Json, normalize_json

    def _denan(v, sd):
        # pandas upcasts int columns with missing values to float-NaN;
        # undo that per the declared dtype
        if isinstance(v, float) and v != v and sd != dt.FLOAT:
            return None
        return v

    def for_dtype(d):
        sd = d.strip_optional()
        if sd == dt.JSON:
            return lambda v: v if v is None else normalize_json(v)
        if sd == dt.FLOAT:
            opt = d.is_optional()

            def to_float(v):
                if opt and isinstance(v, float) and v != v:
                    return None  # NaN marks a missing optional value
                if isinstance(v, int) and not isinstance(v, bool):
                    return float(v)
                return v

            return to_float
        if sd == dt.INT:
            def to_int(v):
                v = _denan(v, sd)
                if (
                    isinstance(v, float)
                    and v == v
                    and float(v).is_integer()
                ):
                    return int(v)
                return v

            return to_int
        return lambda v: _denan(v, sd)

    dtypes = schema.dtypes()
    return [for_dtype(dtypes[n]) for n in col_names]


# ---------------------------------------------------------------------------
# capture / output


class _Capture:
    """Captured output of one table. Batches are stored as-is; the row/
    update views are built lazily on first access — the bulk-join path
    emits hundreds of thousands of rows, and eagerly zipping them into
    per-row tuples doubled the join bench's wall time when the consumer
    (table_to_dicts) only ever wanted columns."""

    def __init__(self, table: Table):
        self.table = table
        self._batches: list[tuple[int, DiffBatch]] = []
        self._rows: dict[int, tuple] | None = None
        self._updates: list[tuple[int, int, int, tuple]] | None = None

    def on_batch(self, t: int, batch: DiffBatch) -> None:
        self._batches.append((t, batch))
        self._rows = None
        self._updates = None

    @property
    def rows(self) -> dict[int, tuple]:
        if self._rows is None:
            rows: dict[int, tuple] = {}
            for t, batch in self._batches:
                if len(batch) > 512 and bool((batch.diffs > 0).all()):
                    keys = batch.keys.tolist()
                    cols = [c.tolist() for c in batch.columns.values()]
                    vals = list(zip(*cols)) if cols else [()] * len(keys)
                    rows.update(zip(keys, vals))
                    continue
                for k, d, vals in batch.iter_rows():
                    if d > 0:
                        rows[k] = vals
                    else:
                        rows.pop(k, None)
            self._rows = rows
        return self._rows

    @property
    def updates(self) -> list[tuple[int, int, int, tuple]]:
        if self._updates is None:
            import itertools

            updates: list[tuple[int, int, int, tuple]] = []
            for t, batch in self._batches:
                if len(batch) > 512:
                    keys = batch.keys.tolist()
                    cols = [c.tolist() for c in batch.columns.values()]
                    vals = list(zip(*cols)) if cols else [()] * len(keys)
                    updates.extend(
                        zip(
                            itertools.repeat(t),
                            keys,
                            batch.diffs.tolist(),
                            vals,
                        )
                    )
                    continue
                for k, d, vals in batch.iter_rows():
                    updates.append((t, k, d, vals))
            self._updates = updates
        return self._updates

    def column_dicts(self) -> tuple[list[int], dict[str, dict[int, Any]]]:
        """Current rows as per-column dicts, built columnar — no per-row
        tuples. Key order matches the `rows` dict (insertion order)."""
        keys_live: dict[int, None] = {}
        cols: dict[str, dict[int, Any]] = {}
        for t, batch in self._batches:
            names = list(batch.columns)
            for nm in names:
                if nm not in cols:
                    cols[nm] = {}
            if len(batch) > 512 and bool((batch.diffs > 0).all()):
                keys = batch.keys.tolist()
                keys_live.update(dict.fromkeys(keys))
                for nm, c in batch.columns.items():
                    cols[nm].update(zip(keys, c.tolist()))
                continue
            for i, (k, d, vals) in enumerate(batch.iter_rows()):
                if d > 0:
                    keys_live[k] = None
                    for nm, v in zip(names, vals):
                        cols[nm][k] = v
                else:
                    keys_live.pop(k, None)
                    for nm in names:
                        cols[nm].pop(k, None)
        return list(keys_live.keys()), cols


def _run_capture(
    tables: Sequence[Table], persistence_config: Any = None
) -> list[_Capture]:
    captures = []
    outputs = []
    for tbl in tables:
        cap = _Capture(tbl)
        captures.append(cap)
        outputs.append(OutputNode(tbl._node, cap.on_batch))
    rt = Runtime(outputs)
    if persistence_config is not None:
        from pathway_tpu_torch.persistence._runtime_glue import attach_persistence

        attach_persistence(rt, persistence_config)
    from pathway_tpu_torch.internals import parse_graph

    parse_graph.G.last_runtime = rt
    rt.run()
    return captures


def table_to_dicts(table: Table, persistence_config: Any = None):
    cap = _run_capture([table], persistence_config=persistence_config)[0]
    col_names = table.column_names()
    keys, cols = cap.column_dicts()
    columns = {n: cols.get(n, {}) for n in col_names}
    return keys, columns


def table_from_parquet(
    path: Any,
    id_from: Sequence[str] | None = None,
    unsafe_trusted_ids: bool = False,
    **kwargs: Any,
) -> Table:
    """Parquet file -> table via pandas (reference: debug/__init__.py:458)."""
    import pandas as pd

    return table_from_pandas(
        pd.read_parquet(path),
        id_from=id_from,
        unsafe_trusted_ids=unsafe_trusted_ids,
    )


def table_to_parquet(table: Table, filename: Any) -> None:
    """Run the graph, write the table to a Parquet file (reference:
    debug/__init__.py:475)."""
    df = table_to_pandas(table, include_id=False)
    df.to_parquet(filename)


class StreamGenerator:
    """Explicitly-timestamped test streams (reference: debug/__init__.py:
    490). The reference routes events through persistence replay; the
    microbatch engine's sources take timestamped events directly, so
    persistence_config() returns None and the tables stream on pw.run."""

    def _table_from_dict(self, batches: dict, schema: Any) -> Table:
        """batches: {time: {worker: [(diff, key, [values...]), ...]}} —
        worker ids collapse onto the single logical worker."""
        col_names = list(schema.column_names())
        return self._from_batches(batches, col_names, dict(schema.dtypes()))

    @staticmethod
    def _from_batches(batches: dict, col_names: list, dtypes: dict) -> Table:
        # reference semantics (debug/__init__.py:536-541): if ANY
        # timestamp is odd, ALL are doubled, preserving relative order
        if any(int(t) % 2 == 1 for t in batches):
            import warnings

            warnings.warn(
                "timestamps are required to be even; all timestamps will "
                "be doubled"
            )
            batches = {2 * int(t): v for t, v in batches.items()}
        events: dict[int, list] = {}
        for t, by_worker in batches.items():
            for _worker, changes in by_worker.items():
                for diff, key, values in changes:
                    events.setdefault(int(t), []).append(
                        (int(key), int(diff), tuple(values))
                    )
        source = _RowsSource(col_names, sorted(events.items()))
        node = InputNode(source, col_names)
        return Table._from_node(node, dtypes, Universe())

    def table_from_list_of_batches_by_workers(
        self, batches: list[dict[int, list[dict]]], schema: Any, **kw: Any
    ) -> Table:
        counter = iter(range(10**9))
        as_dict: dict[int, dict[int, list]] = {}
        for i, batch in enumerate(batches):
            t = 2 * (i + 1)
            as_dict[t] = {
                w: [
                    (
                        1,
                        int(ref_scalar(next(counter))),
                        [row[n] for n in schema.column_names()],
                    )
                    for row in rows
                ]
                for w, rows in batch.items()
            }
        return self._table_from_dict(as_dict, schema)

    def table_from_list_of_batches(
        self, batches: list[list[dict]], schema: Any, **kw: Any
    ) -> Table:
        return self.table_from_list_of_batches_by_workers(
            [{0: batch} for batch in batches], schema
        )

    def table_from_pandas(
        self,
        df: Any,
        id_from: list[str] | None = None,
        unsafe_trusted_ids: bool = False,
        schema: Any = None,
        **kw: Any,
    ) -> Table:
        """`_time` / `_worker` / `_diff` columns control batching, exactly
        as in the reference. A non-default DataFrame index provides the
        row ids (hash of the index value), letting retractions target
        earlier insertions."""
        import pandas as pd

        df = df.copy()
        for col, default in (("_time", 2), ("_worker", 0), ("_diff", 1)):
            if col not in df:
                df[col] = [default] * len(df)
        value_cols = [
            c for c in df.columns if c not in ("_time", "_worker", "_diff")
        ]
        explicit_ids = not isinstance(df.index, pd.RangeIndex)
        if id_from is None and schema is not None and not explicit_ids:
            # schema primary keys fill in only when the index carries no
            # explicit ids (explicit ids win, like table_from_markdown)
            id_from = schema.primary_key_columns()
        if schema is None:
            dtypes = {
                n: _dtype_for([_np_unbox(v) for v in df[n]])
                for n in value_cols
            }
        else:
            dtypes = {n: schema.dtypes()[n] for n in value_cols}
        batches: dict[int, dict[int, list]] = {}
        for i in range(len(df)):
            row = df.iloc[i]
            vals = [_np_unbox(row[c]) for c in value_cols]
            if id_from:
                key = int(
                    ref_scalar(*[vals[value_cols.index(c)] for c in id_from])
                )
            elif explicit_ids:
                key = int(ref_scalar(_np_unbox(df.index[i])))
            else:
                key = int(ref_scalar(i))
            t = int(row["_time"])
            batches.setdefault(t, {}).setdefault(int(row["_worker"]), []).append(
                (int(row["_diff"]), key, vals)
            )
        return self._from_batches(batches, value_cols, dtypes)

    def table_from_markdown(
        self,
        table: str,
        id_from: list[str] | None = None,
        unsafe_trusted_ids: bool = False,
        schema: Any = None,
        **kw: Any,
    ) -> Table:
        # parse into a DataFrame and route through table_from_pandas so
        # _time/_worker/_diff handling, odd-timestamp doubling and
        # explicit-id semantics match the reference's single code path
        import pandas as pd

        header, data, raw_ids = _split_markdown(table)
        ids = (
            [_parse_value(x) for x in raw_ids] if raw_ids is not None else None
        )
        parsed = [[_parse_value(c) for c in row] for row in data]
        df = pd.DataFrame(parsed, columns=header, dtype=object)
        if ids is not None:
            df.index = ids
        return self.table_from_pandas(
            df, id_from, unsafe_trusted_ids, schema
        )

    def persistence_config(self):
        """The microbatch engine feeds StreamGenerator tables directly —
        no persistence replay needed; safe to pass to pw.run."""
        return None


def table_to_pandas(table: Table, include_id: bool = True):
    import pandas as pd

    cap = _run_capture([table])[0]
    col_names = table.column_names()
    data = {n: [] for n in col_names}
    index = []
    for k, vals in cap.rows.items():
        index.append(Pointer(k))
        for n, v in zip(col_names, vals):
            data[n].append(v)
    if include_id:
        return pd.DataFrame(data, index=index)
    return pd.DataFrame(data)


def _fmt_value(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, str):
        return v
    if isinstance(v, np.generic):
        v = v.item()
    return repr(v) if not isinstance(v, (int, float, bool, Pointer)) else str(v)


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    squash_updates: bool = True,
    terminate_on_error: bool = True,
) -> None:
    cap = _run_capture([table])[0]
    col_names = table.column_names()
    # reference display order: rows sorted by VALUES then key (debug/
    # __init__.py _compute_and_print_single); unsortable values keep
    # capture order
    rows = list(cap.rows.items())
    try:
        rows.sort(key=lambda kv: tuple(
            (v is not None, v) for v in kv[1]
        ) + (kv[0],))
    except (ValueError, TypeError):
        rows.sort(key=lambda kv: kv[0])
    if n_rows is not None:
        rows = rows[:n_rows]
    header = ([""] if include_id else []) + col_names
    out_rows = []
    for k, vals in rows:
        key_s = str(Pointer(k))
        if short_pointers:
            key_s = key_s[:12] + "..."
        out_rows.append(
            ([key_s] if include_id else []) + [_fmt_value(v) for v in vals]
        )
    widths = [
        max(len(header[i]), *(len(r[i]) for r in out_rows)) if out_rows else len(header[i])
        for i in range(len(header))
    ]
    print(
        " | ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip()
    )
    for r in out_rows:
        print(" | ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())


def compute_and_print_update_stream(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    **kwargs,
) -> None:
    cap = _run_capture([table])[0]
    col_names = table.column_names()
    header = ([""] if include_id else []) + col_names + ["__time__", "__diff__"]
    updates = list(cap.updates)
    # reference stream display order: (time, diff) first, then values,
    # then key; unsortable values keep CAPTURE order (sorted() leaves the
    # original untouched when a comparison raises)
    try:
        updates = sorted(
            updates,
            key=lambda u: (u[0], u[2])
            + tuple((v is not None, v) for v in u[3])
            + (u[1],),
        )
    except (ValueError, TypeError):
        pass
    if n_rows is not None:
        updates = updates[:n_rows]
    out_rows = []
    for t, k, d, vals in updates:
        key_s = str(Pointer(k))
        if short_pointers:
            key_s = key_s[:12] + "..."
        out_rows.append(
            ([key_s] if include_id else [])
            + [_fmt_value(v) for v in vals]
            + [str(t), str(d)]
        )
    widths = [
        max(len(header[i]), *(len(r[i]) for r in out_rows))
        if out_rows
        else len(header[i])
        for i in range(len(header))
    ]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for r in out_rows:
        print(" | ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())


# ---------------------------------------------------------------------------
# equality assertions (harness used by our test-suite, modeled on the
# reference tests/utils.py assert_table_equality)


def _canon(vals: tuple) -> tuple:
    out = []
    for v in vals:
        if isinstance(v, np.ndarray):
            out.append(("__ndarray__", v.tobytes(), str(v.dtype), v.shape))
        elif isinstance(v, float) and float(v).is_integer():
            out.append(v)
        elif isinstance(v, np.generic):
            out.append(v.item())
        else:
            out.append(v)
    return tuple(out)


def assert_table_equality(t1: Table, t2: Table, **kwargs) -> None:
    caps = _run_capture([t1, t2])
    rows1 = {Pointer(k): _canon(v) for k, v in caps[0].rows.items()}
    rows2 = {Pointer(k): _canon(v) for k, v in caps[1].rows.items()}
    c1, c2 = t1.column_names(), t2.column_names()
    assert c1 == c2, f"column mismatch: {c1} vs {c2}"
    assert rows1 == rows2, (
        f"tables differ:\n  left:  {_show(rows1)}\n  right: {_show(rows2)}"
    )


def assert_table_equality_wo_index(t1: Table, t2: Table, **kwargs) -> None:
    caps = _run_capture([t1, t2])
    rows1 = sorted(
        (_canon(v) for v in caps[0].rows.values()), key=repr
    )
    rows2 = sorted(
        (_canon(v) for v in caps[1].rows.values()), key=repr
    )
    c1, c2 = t1.column_names(), t2.column_names()
    assert c1 == c2, f"column mismatch: {c1} vs {c2}"
    assert rows1 == rows2, (
        f"tables differ (wo index):\n  left:  {rows1}\n  right: {rows2}"
    )


assert_table_equality_wo_types = assert_table_equality
assert_table_equality_wo_index_types = assert_table_equality_wo_index


def _show(rows: Mapping) -> str:
    items = sorted(rows.items(), key=lambda kv: str(kv[0]))
    return "{" + ", ".join(f"{k}: {v}" for k, v in items[:20]) + (
        ", ..." if len(items) > 20 else ""
    ) + "}"


def _compute_tables(*tables: Table):
    """Run the graph and return the captured contents of `tables`
    (reference: debug._compute_tables with terminate_on_error=True —
    an error recorded during execution raises instead of poisoning)."""
    from pathway_tpu_torch.internals.errors import clear_errors, peek_errors

    clear_errors()
    captures = _run_capture(list(tables))
    errors = peek_errors()
    if errors:
        first = errors[0]
        raise ValueError(
            f"error during computation: {first.get('message', first)!r}"
        )
    return captures


def trace(seconds: float | None = None, path: Any = None) -> dict:
    """Notebook entry point for the Trace Weaver
    (pathway_tpu_torch/observability/tracing.py): return the recorded span ring
    as a Chrome trace-event document — the same body the monitoring
    server serves at ``/debug/trace``. Pass ``path`` to also write it to
    a file you can drag into Perfetto (ui.perfetto.dev)."""
    import json as _json

    from pathway_tpu_torch.observability.tracing import get_tracer

    doc = get_tracer().chrome_trace(seconds=seconds)
    if path is not None:
        with open(path, "w") as f:
            _json.dump(doc, f)
    return doc


def trace_tree(
    trace_id: str | None = None, seconds: float | None = None
) -> str:
    """Human-readable parent/child breakdown of one trace (default: the
    most recently finished root span's trace). Prints and returns it."""
    from pathway_tpu_torch.observability.tracing import get_tracer

    tracer = get_tracer()
    if trace_id is None:
        recs = tracer.spans(seconds)
        span_ids = {r.span_id for r in recs}
        # local roots: no parent, OR a parent that lives outside this
        # ring (a request that joined a caller's trace via traceparent)
        roots = [
            r
            for r in recs
            if r.parent_id is None or r.parent_id not in span_ids
        ]
        if not roots:
            out = "(no root spans recorded)"
            print(out)
            return out
        trace_id = roots[-1].trace_id
    out = tracer.format_tree(trace_id, seconds)
    print(out)
    return out


def diagnose(*tables: Table, min_severity: str = "info"):
    """Notebook entry point for the Graph Doctor (pathway_tpu_torch.analysis):
    print and return the static-analysis report for the pipeline feeding
    the given table(s) — or the whole declared graph when called with no
    arguments. Nothing executes; the pass walks the declared nodes only."""
    from pathway_tpu_torch.analysis import run_doctor
    from pathway_tpu_torch.analysis.diagnostics import Severity
    from pathway_tpu_torch.engine.runtime import collect_nodes

    if tables:
        seeds = [t._node for t in tables]
        # scope to the upstream cone: a table under diagnosis counts as
        # consumed, and unrelated parts of the graph stay out of view
        report = run_doctor(outputs=seeds, all_nodes=collect_nodes(seeds))
    else:
        report = run_doctor()
    print(report.format(min_severity=Severity.parse(min_severity)))
    return report
