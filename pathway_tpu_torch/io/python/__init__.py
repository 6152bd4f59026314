"""The port's own copy of ``pathway_tpu/io/python/__init__.py``. pw.io.python — custom Python sources
(reference: python/pathway/io/python/__init__.py:47 ConnectorSubject +
Rust PythonReader, src/connectors/data_storage.rs:840).

One difference from the JAX package, whose ``commit()`` does nothing and
whose every ``next()`` reaches the engine at once: here, as in upstream
Pathway, the rows a subject pushes (``next``, ``_remove``) wait in its
session and reach the engine together at ``commit()``, in one tick. Rows
left uncommitted go in ``autocommit_duration_ms`` after the first of them
(never, for ``None``), and when ``run()`` returns. What the engine computes
from them is the same; only the ticks they are grouped into differ."""

from __future__ import annotations

import json as _json
import threading
import time as _time
from typing import Any, Sequence

from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import InputSession, StreamingSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ref_scalar, sequential_key
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


class _CommitSession(InputSession):
    """The session of a ``pw.io.python`` table: staged rows become pending
    (visible to the tick loop's drain) only at a commit."""

    def __init__(self, column_names: Sequence[str], autocommit_ms: int | None):
        super().__init__(column_names)
        self._staged: list[tuple[int, int, tuple]] = []
        self._staged_at = 0.0
        self._autocommit_s = None if autocommit_ms is None else autocommit_ms / 1000.0

    def stage(self, key: int, diff: int, values: tuple) -> None:
        with self._lock:
            if not self._staged:
                self._staged_at = _time.monotonic()
            self._staged.append((key, diff, values))

    def commit(self) -> None:
        with self._lock:
            self._rows.extend(self._staged)
            self._staged = []
        self._notify()

    def close(self) -> None:
        self.commit()
        super().close()

    def drain(self, max_rows: int | None = None) -> list[tuple[int, int, tuple]]:
        # the tick loop wakes at least every autocommit_ms of the runtime,
        # so an expired autocommit is taken within one such interval
        with self._lock:
            if (
                self._staged
                and self._autocommit_s is not None
                and _time.monotonic() - self._staged_at >= self._autocommit_s
            ):
                self._rows.extend(self._staged)
                self._staged = []
        return super().drain(max_rows)


class ConnectorSubject:
    """Subclass and implement run(); call self.next(**values) /
    next_json / next_str / next_bytes, and self.commit() to hand the rows
    pushed since the last commit to the engine as one batch."""

    _session = None
    _column_names: Sequence[str] = ()
    _schema = None
    _counter = 0
    _deletions_enabled = True

    def run(self) -> None:
        raise NotImplementedError

    def on_stop(self) -> None:
        pass

    @property
    def _with_metadata(self) -> bool:
        return False

    # --- feeding -------------------------------------------------------------

    def _plan(self) -> tuple:
        """What the schema asks of every row, read from it once per schema:
        (json columns with their optionality, float columns, primary key
        columns or None)."""
        cached = self.__dict__.get("_coerce_plan")
        if cached is None or cached[0] is not self._schema:
            json_cols, float_cols = [], []
            for name, d in self._schema.dtypes().items():
                sd = d.strip_optional()
                if sd == dt.JSON:
                    json_cols.append((name, d.is_optional()))
                elif sd == dt.FLOAT:
                    float_cols.append(name)
            cached = self._coerce_plan = (
                self._schema, (tuple(json_cols), tuple(float_cols), self._schema.primary_key_columns())
            )
        return cached[1]

    def _key_for(self, values: dict) -> int:
        pk = self._plan()[2] if self._schema else None
        if pk:
            return int(ref_scalar(*[values.get(c) for c in pk]))
        self._counter += 1
        return int(ref_scalar(id(self), self._counter))

    def _vals(self, values: dict) -> tuple:
        return tuple(values.get(c) for c in self._column_names)

    def next(self, **values: Any) -> None:
        assert self._session is not None
        coerced = self._coerce_values(values)
        self._session.stage(self._key_for(coerced), 1, self._vals(coerced))

    def _coerce_values(self, values: dict) -> dict:
        if self._schema is None:
            return values
        json_cols, float_cols, _pk = self._plan()
        out = dict(values)
        for name, optional in json_cols:
            if name in out and not (out[name] is None and optional):
                from pathway_tpu_torch.internals.json import normalize_json

                out[name] = normalize_json(out[name])
        for name in float_cols:
            if isinstance(out.get(name), int):
                out[name] = float(out[name])
        return out

    def next_json(self, values: dict | str) -> None:
        if isinstance(values, str):
            values = _json.loads(values)
        self.next(**values)

    def next_str(self, message: str) -> None:
        self.next(data=message)

    def next_bytes(self, message: bytes) -> None:
        self.next(data=message)

    def _remove(self, key, values: dict) -> None:
        assert self._session is not None
        coerced = self._coerce_values(values)
        self._session.stage(int(key), -1, self._vals(coerced))

    def commit(self) -> None:
        assert self._session is not None
        self._session.commit()

    def close(self) -> None:
        assert self._session is not None
        self._session.close()


class _PythonSource(StreamingSource):
    def __init__(self, subject: ConnectorSubject, column_names, schema, autocommit_ms):
        super().__init__(column_names)
        self.session = _CommitSession(column_names, autocommit_ms)
        self.subject = subject
        subject._session = self.session
        subject._column_names = column_names
        subject._schema = schema
        self._thread: threading.Thread | None = None

    def start(self):
        def runner():
            try:
                self.subject.run()
            finally:
                self.session.close()

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()

    def stop(self):
        self.subject.on_stop()


def read(
    subject: ConnectorSubject,
    *,
    schema: Any = None,
    format: str = "json",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    if schema is None:
        from pathway_tpu_torch.internals.schema import schema_from_types

        schema = schema_from_types(data=bytes)
    column_names = list(schema.column_names())
    source = _PythonSource(subject, column_names, schema, autocommit_duration_ms)
    node = InputNode(source, column_names)
    from pathway_tpu_torch.internals import parse_graph

    parse_graph.G.streaming_sources.append(source)
    return Table._from_node(node, dict(schema.dtypes()), Universe())
