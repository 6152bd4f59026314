"""Own copy of ``pathway_tpu/io/fs.py``: the same formats, row keys,
offsets and output files.

Filesystem connector (upstream Pathway: python/pathway/io/fs + the Rust
posix-like scanner, src/connectors/scanner/filesystem.rs:146). Static mode
reads once; streaming mode polls the path for new/changed files and feeds
diffs. ``with_metadata`` is accepted and, as in the reference, adds no
column."""

from __future__ import annotations

import csv as _csv
import glob
import json as _json
import os
import threading
import time
from typing import Any, Iterable, Sequence

from pathway_tpu_torch.engine.batch import DiffBatch, make_column
from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import StaticSource, StreamingSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import parse_graph
from pathway_tpu_torch.internals.api import ref_scalar, sequential_key
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


def _list_files(path: str, with_metadata_glob: str | None = None) -> list[str]:
    path = os.fspath(path)
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                out.append(os.path.join(root, f))
        return out
    if any(ch in path for ch in "*?["):
        return sorted(glob.glob(path))
    if os.path.exists(path):
        return [path]
    return []


def _parse_file(
    fpath: str,
    format: str,
    schema,
    csv_settings=None,
    with_metadata: bool = False,
) -> Iterable[tuple]:
    """Yield (pk_values, values_tuple) rows."""
    if format in ("plaintext", "plaintext_by_file"):
        if format == "plaintext_by_file":
            with open(fpath, "r", errors="replace") as f:
                yield (fpath,), (f.read(),)
        else:
            with open(fpath, "r", errors="replace") as f:
                for i, line in enumerate(f):
                    line = line.rstrip("\n")
                    yield (fpath, i), (line,)
        return
    if format == "binary":
        with open(fpath, "rb") as f:
            yield (fpath,), (f.read(),)
        return
    col_names = list(schema.column_names()) if schema else None
    if format == "csv":
        delim = ","
        if csv_settings is not None:
            delim = getattr(csv_settings, "delimiter", ",")
        coercers = _make_coercers(schema, col_names, _coerce_one)
        with open(fpath, newline="") as f:
            reader = _csv.DictReader(f, delimiter=delim)
            for i, row in enumerate(reader):
                if coercers is not None:
                    vals = tuple(fn(row.get(n)) for n, fn in coercers)
                else:
                    vals = tuple(row.values())
                yield (fpath, i), vals
        return
    if format in ("json", "jsonlines"):
        coercers = _make_coercers(schema, col_names, _coerce_json_one)
        with open(fpath, "r") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                obj = _json.loads(line)
                if coercers is not None:
                    vals = tuple(fn(obj.get(n)) for n, fn in coercers)
                else:
                    names = col_names or list(obj.keys())
                    vals = tuple(obj.get(n) for n in names)
                yield (fpath, i), vals
        return
    raise ValueError(f"unknown format {format!r}")


def _make_coercers(schema, col_names, make_one):
    """Per-column coercion closures resolved ONCE per file — dtype lookup
    and comparison per row was the parse hot spot."""
    if schema is None or col_names is None:
        return None
    dtypes = schema.dtypes()
    return [
        (n, make_one(dtypes.get(n, dt.ANY).strip_optional())) for n in col_names
    ]


def _coerce_one(d):
    """Column coercer for text (csv) input values."""
    if d == dt.INT:
        return lambda v: None if v is None else _safe(int, v)
    if d == dt.FLOAT:
        return lambda v: None if v is None else _safe(float, v)
    if d == dt.BOOL:
        return lambda v: (
            None
            if v is None
            else (v if isinstance(v, bool) else v.lower() in ("true", "1"))
        )
    if d == dt.STR:
        return lambda v: None if v is None else str(v)
    if d == dt.JSON:
        return lambda v: (
            None
            if v is None
            else _safe(lambda x: Json(_json.loads(x) if isinstance(x, str) else x), v)
        )
    return lambda v: v


def _safe(fn, v):
    try:
        return fn(v)
    except (ValueError, TypeError):
        return None


def _coerce_json_one(d):
    """Column coercer for already-typed (json) input values. Non-JSON
    dtypes wrap stray list/dict values into Json (matching the historical
    fs behavior the s3 scanner shares). Datetime/duration columns parse
    the Json serde format back (nanosecond ISO strings / ns ints)."""
    from pathway_tpu_torch.internals.datetime_types import DateTimeNaive, DateTimeUtc

    if d == dt.JSON:
        return lambda v: v if isinstance(v, Json) else Json(v)
    if d == dt.DATE_TIME_NAIVE:
        return lambda v: (
            DateTimeNaive(v) if isinstance(v, str) else v
        )
    if d == dt.DATE_TIME_UTC:
        return lambda v: DateTimeUtc(v) if isinstance(v, str) else v
    if d == dt.DURATION:
        # Duration is built (and pandas imported) only for such a column
        from pathway_tpu_torch.internals.datetime_types import Duration

        return lambda v: (
            Duration(nanoseconds=v)
            if isinstance(v, int) and not isinstance(v, bool)
            else v
        )
    if d == dt.FLOAT:

        def as_float(v):
            if isinstance(v, int):
                return float(v)
            if isinstance(v, (list, dict)):
                return Json(v)
            return v

        return as_float

    def generic(v):
        if isinstance(v, (list, dict)):
            return Json(v)
        return v

    return generic


def _coerce(v: Any, schema, name: str) -> Any:
    """Single-value text coercion (same rules as the per-column closures —
    kept for callers that coerce ad hoc, e.g. the s3 scanner)."""
    if schema is None:
        return v
    return _coerce_one(schema.dtypes().get(name, dt.ANY).strip_optional())(v)


def _coerce_json(v: Any, schema, name: str) -> Any:
    if schema is None:
        return v
    return _coerce_json_one(
        schema.dtypes().get(name, dt.ANY).strip_optional()
    )(v)


class _FsStaticSource(StaticSource):
    def __init__(self, path, format, schema, column_names, csv_settings, pk_cols):
        super().__init__(column_names)
        self.path = path
        self.format = format
        self.schema = schema
        self.csv_settings = csv_settings
        self.pk_cols = pk_cols

    def events(self):
        import numpy as np

        from pathway_tpu_torch.internals.api import ref_scalars_columns

        all_vals: list[tuple] = []
        all_pks: list[tuple] = []
        for fpath in _list_files(self.path):
            for pk, vals in _parse_file(
                fpath, self.format, self.schema, self.csv_settings
            ):
                all_vals.append(vals)
                all_pks.append(pk)
        if not all_vals:
            return
        n = len(all_vals)
        # batch key derivation through the native hasher — one call for the
        # whole snapshot instead of a per-row ref_scalar
        if self.pk_cols:
            pk_idx = [self.column_names.index(c) for c in self.pk_cols]
            key_cols = [[v[i] for v in all_vals] for i in pk_idx]
        else:
            width = len(all_pks[0])
            key_cols = [[p[i] for p in all_pks] for i in range(width)]
        keys = ref_scalars_columns(key_cols, n)
        cols = {
            name: make_column([v[i] for v in all_vals])
            for i, name in enumerate(self.column_names)
        }
        yield 0, DiffBatch(keys, np.ones(n, dtype=np.int64), cols)


class _FsStreamingSource(StreamingSource):
    def __init__(
        self,
        path,
        format,
        schema,
        column_names,
        csv_settings,
        pk_cols,
        refresh_s: float = 0.2,
        with_deletions: bool = True,
    ):
        super().__init__(column_names)
        self.path = path
        self.format = format
        self.schema = schema
        self.csv_settings = csv_settings
        self.pk_cols = pk_cols
        self.refresh_s = refresh_s
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._seen: dict[str, tuple[float, int]] = {}  # path -> (mtime, size)
        self._emitted: dict[str, list] = {}  # path -> [(key, vals)]
        self.persistent_id: str | None = None

    # --- persistence hooks (reference: Reader::seek + OffsetValue,
    # src/connectors/data_storage.rs:402, src/connectors/offset.rs) -----------

    def offset_state(self) -> dict:
        return {"seen": dict(self._seen), "emitted": dict(self._emitted)}

    def seek(self, state: dict) -> None:
        self._seen = dict(state.get("seen", {}))
        self._emitted = dict(state.get("emitted", {}))

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def _scan_once(self):
        for fpath in _list_files(self.path):
            try:
                st = os.stat(fpath)
            except OSError:
                continue
            sig = (st.st_mtime, st.st_size)
            if self._seen.get(fpath) == sig:
                continue
            # build the whole file's diff (retraction of the previous
            # version + new rows), then enqueue it atomically together with
            # the offset snapshot that covers it — a persistence commit can
            # then never record this file as seen without its rows being in
            # the drained (and thus logged) stream
            rows: list[tuple[int, int, tuple]] = [
                (key, -1, vals) for key, vals in self._emitted.get(fpath, [])
            ]
            emitted = []
            try:
                for pk, vals in _parse_file(
                    fpath, self.format, self.schema, self.csv_settings
                ):
                    if self.pk_cols:
                        key = int(
                            ref_scalar(
                                *[
                                    vals[self.column_names.index(c)]
                                    for c in self.pk_cols
                                ]
                            )
                        )
                    else:
                        key = int(ref_scalar(*pk))
                    rows.append((key, 1, vals))
                    emitted.append((key, vals))
            except OSError:
                continue
            self._seen[fpath] = sig
            self._emitted[fpath] = emitted
            self.session.insert_batch(rows, self.offset_state())

    def _loop(self):
        while not self._stop.is_set():
            self._scan_once()
            self._stop.wait(self.refresh_s)


def read(
    path: str,
    *,
    format: str = "csv",
    schema: Any = None,
    mode: str = "streaming",
    csv_settings: Any = None,
    json_field_paths: Any = None,
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    if format in ("plaintext", "plaintext_by_file"):
        column_names = ["data"]
        dtypes = {"data": dt.STR}
        schema_ = None
    elif format == "binary":
        column_names = ["data"]
        dtypes = {"data": dt.BYTES}
        schema_ = None
    else:
        assert schema is not None, f"schema required for format {format!r}"
        column_names = list(schema.column_names())
        dtypes = dict(schema.dtypes())
        schema_ = schema
    pk_cols = schema_.primary_key_columns() if schema_ else None
    if mode in ("static",):
        source: Any = _FsStaticSource(
            path, format, schema_, column_names, csv_settings, pk_cols
        )
    else:
        source = _FsStreamingSource(
            path, format, schema_, column_names, csv_settings, pk_cols
        )
    source.persistent_id = persistent_id or name
    node = InputNode(source, column_names)
    return Table._from_node(node, dtypes, Universe())


class _FileWriter:
    def __init__(self, filename: str, format: str, column_names: Sequence[str]):
        self.filename = filename
        self.format = format
        self.column_names = list(column_names)
        self._file = open(filename, "w", newline="")
        if format == "csv":
            self._writer = _csv.writer(self._file)
            self._writer.writerow(list(column_names) + ["time", "diff"])

    def on_batch(self, t: int, batch: DiffBatch) -> None:
        for k, d, vals in batch.iter_rows():
            if self.format == "csv":
                self._writer.writerow(list(vals) + [t, d])
            else:
                obj = dict(zip(self.column_names, [_jsonable(v) for v in vals]))
                obj["time"] = t
                obj["diff"] = d
                # Json.dumps: datetimes as nanosecond ISO strings, durations
                # as nanosecond ints (reference JsonLinesFormatter serde)
                self._file.write(Json.dumps(obj) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def _jsonable(v: Any) -> Any:
    from pathway_tpu_torch.io._utils import jsonable

    return jsonable(v)


def write(table: Table, filename: str, *, format: str = "json", **kwargs) -> None:
    from pathway_tpu_torch.engine.nodes import OutputNode

    writer = _FileWriter(filename, format, table.column_names())
    node = OutputNode(table._node, writer.on_batch, writer.close)
    parse_graph.G.add_output(node)
