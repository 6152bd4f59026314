"""Own copy of ``pathway_tpu/io/sqlite.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.sqlite — SQLite reader/writer.

Counterpart of upstream Pathway's native SqliteReader
(upstream Pathway: src/connectors/data_storage.rs:1534 — snapshots the table and
streams changes by polling SQLite's `PRAGMA data_version` and diffing
against the previously observed state). The writer applies diff batches
transactionally (insert on +1, delete on -1).
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import StaticSource, StreamingSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import parse_graph
from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._utils import add_writer, jsonable


def _coerce(v: Any, d) -> Any:
    """sqlite-specific coercion: BOOL arrives as 0/1, BYTES may arrive as
    TEXT (the fs connector's _coerce handles string-typed inputs instead)."""
    if v is None:
        return None
    sd = d.strip_optional()
    try:
        if sd == dt.INT:
            return int(v)
        if sd == dt.FLOAT:
            return float(v)
        if sd == dt.BOOL:
            return bool(v)
        if sd == dt.STR:
            return str(v)
        if sd == dt.BYTES:
            return v if isinstance(v, bytes) else str(v).encode()
        if sd == dt.JSON:
            import json as _json

            return Json(_json.loads(v) if isinstance(v, str) else v)
    except (ValueError, TypeError):
        return None
    return v


def _snapshot(
    conn: sqlite3.Connection, table_name: str, column_names, schema
) -> dict[int, tuple]:
    cols = ", ".join(f'"{c}"' for c in column_names)
    cur = conn.execute(f'SELECT {cols} FROM "{table_name}"')  # noqa: S608
    dtypes = schema.dtypes() if schema else {}
    pk_cols = schema.primary_key_columns() if schema else None
    rows: dict[int, tuple] = {}
    for i, raw in enumerate(cur.fetchall()):
        vals = tuple(
            _coerce(v, dtypes.get(c, dt.ANY))
            for c, v in zip(column_names, raw)
        )
        if pk_cols:
            key = int(
                ref_scalar(*[vals[column_names.index(c)] for c in pk_cols])
            )
        else:
            key = int(ref_scalar(*vals))
        rows[key] = vals
    return rows


class _SqliteStaticSource(StaticSource):
    def __init__(self, path, table_name, column_names, schema):
        super().__init__(column_names)
        self.path = path
        self.table_name = table_name
        self.schema = schema

    def events(self):
        conn = sqlite3.connect(self.path)
        try:
            rows = _snapshot(conn, self.table_name, self.column_names, self.schema)
        finally:
            conn.close()
        if rows:
            yield 0, DiffBatch.from_rows(
                [(k, 1, v) for k, v in rows.items()], self.column_names
            )


class _SqliteStreamingSource(StreamingSource):
    """Poll data_version; on change, diff the table snapshot and emit
    insert/delete rows (the reference reader does the same state diffing)."""

    def __init__(self, path, table_name, column_names, schema, refresh_s=0.2):
        super().__init__(column_names)
        self.path = path
        self.table_name = table_name
        self.schema = schema
        self.refresh_s = refresh_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._state: dict[int, tuple] = {}
        self._data_version: int | None = None

    def offset_state(self) -> dict:
        return {"state": dict(self._state)}

    def seek(self, state: dict) -> None:
        self._state = dict(state.get("state", {}))

    def _poll(self, conn):
        ver = conn.execute("PRAGMA data_version").fetchone()[0]
        count = conn.execute(
            f'SELECT COUNT(*) FROM "{self.table_name}"'  # noqa: S608
        ).fetchone()[0]
        sig = (ver, count)
        if sig == self._data_version:
            return
        self._data_version = sig
        new = _snapshot(conn, self.table_name, self.column_names, self.schema)
        rows = []
        for k, vals in self._state.items():
            if k not in new:
                rows.append((k, -1, vals))
            elif new[k] != vals:
                rows.append((k, -1, vals))
        for k, vals in new.items():
            old = self._state.get(k)
            if old is None or old != vals:
                rows.append((k, 1, vals))
        self._state = new
        if rows:
            self.session.insert_batch(rows, self.offset_state())

    def _loop(self):
        conn = sqlite3.connect(self.path)
        try:
            while not self._stop.is_set():
                try:
                    self._poll(conn)
                except sqlite3.Error:
                    pass
                self._stop.wait(self.refresh_s)
        finally:
            conn.close()

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


def read(
    path: str,
    table_name: str,
    schema: Any,
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    column_names = list(schema.column_names())
    if mode == "static":
        source: Any = _SqliteStaticSource(path, table_name, column_names, schema)
    else:
        source = _SqliteStreamingSource(path, table_name, column_names, schema)
    source.persistent_id = persistent_id or name
    node = InputNode(source, column_names)
    return Table._from_node(node, dict(schema.dtypes()), Universe())


def write(table: Table, path: str, table_name: str, **kwargs: Any) -> None:
    """Apply the output diff stream to a SQLite table transactionally."""
    column_names = table.column_names()
    state = {"conn": None}

    def _conn() -> sqlite3.Connection:
        if state["conn"] is None:
            conn = sqlite3.connect(path, check_same_thread=False)
            cols = ", ".join(f'"{c}"' for c in column_names)
            conn.execute(
                f'CREATE TABLE IF NOT EXISTS "{table_name}" '
                f"({cols}, __key__ INTEGER PRIMARY KEY)"
            )
            state["conn"] = conn
        return state["conn"]

    def on_batch(t: int, batch: DiffBatch) -> None:
        conn = _conn()
        placeholders = ", ".join("?" for _ in column_names) + ", ?"
        with conn:
            for k, d, vals in batch.iter_rows():
                # sqlite ints are signed 64-bit
                skey = k - (1 << 64) if k >= 1 << 63 else k
                if d > 0:
                    conn.execute(
                        f'INSERT OR REPLACE INTO "{table_name}" VALUES '  # noqa: S608
                        f"({placeholders})",
                        tuple(jsonable_sql(v) for v in vals) + (skey,),
                    )
                else:
                    conn.execute(
                        f'DELETE FROM "{table_name}" WHERE __key__ = ?',  # noqa: S608
                        (skey,),
                    )

    def on_end() -> None:
        if state["conn"] is not None:
            state["conn"].close()

    add_writer(table, on_batch, on_end)


def jsonable_sql(v: Any) -> Any:
    v = jsonable(v)
    if isinstance(v, (dict, list)):
        import json as _json

        return _json.dumps(v)
    return v
