"""Own copy of ``pathway_tpu/io/debezium.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.debezium — CDC change-stream ingestion.

Counterpart of upstream Pathway's DebeziumMessageParser
(upstream Pathway: src/connectors/data_format.rs:1017 — parses Debezium
envelopes {before, after, op} with op in c/r/u/d, plus the MongoDB
dialect where `after` arrives as an embedded JSON string and deletes
carry only `before`/`filter`). Transport is pluggable: Kafka when a
client library exists (matching the reference's rdkafka transport),
or a directory of message files / a ConnectorSubject for testing.
"""

from __future__ import annotations

import json as _json
import os
import threading
from typing import Any

from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import StreamingSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import parse_graph
from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


def parse_debezium_message(
    payload: Any, column_names, schema, db_type: str = "postgres"
):
    """Parse one Debezium envelope -> list of (diff, values_tuple).
    (upstream Pathway: DebeziumMessageParser::parse, data_format.rs:1017)"""
    if isinstance(payload, (bytes, str)):
        payload = _json.loads(payload)
    if payload is None:
        return []
    if "payload" in payload and isinstance(payload["payload"], dict):
        payload = payload["payload"]
    op = payload.get("op")
    dtypes = schema.dtypes() if schema else {}

    def vals_of(obj):
        if obj is None:
            return None
        if isinstance(obj, str) and db_type == "mongodb":
            obj = _json.loads(obj)
        out = []
        for c in column_names:
            v = obj.get(c)
            d = dtypes.get(c, dt.ANY).strip_optional()
            if d == dt.JSON and not isinstance(v, Json):
                v = Json(v)
            elif d == dt.FLOAT and isinstance(v, int):
                v = float(v)
            out.append(v)
        return tuple(out)

    before = vals_of(payload.get("before"))
    after = vals_of(payload.get("after"))
    events = []
    if op in ("c", "r"):  # create / snapshot read
        if after is not None:
            events.append((1, after))
    elif op == "u":
        if before is not None:
            events.append((-1, before))
        if after is not None:
            events.append((1, after))
    elif op == "d":
        if before is not None:
            events.append((-1, before))
        elif db_type == "mongodb" and payload.get("filter"):
            flt = payload["filter"]
            if isinstance(flt, str):
                flt = _json.loads(flt)
            events.append((-1, vals_of(flt)))
    return events


class _DirMessageSource(StreamingSource):
    """Reads Debezium JSON messages from files in a directory (one JSON per
    line) — the file-transport used by tests and replays."""

    def __init__(self, path, column_names, schema, pk_cols, db_type, refresh_s=0.2):
        super().__init__(column_names)
        self.path = path
        self.schema = schema
        self.pk_cols = pk_cols
        self.db_type = db_type
        self.refresh_s = refresh_s
        self._stop = threading.Event()
        self._thread = None
        self._offsets: dict[str, int] = {}  # path -> lines consumed
        self._sigs: dict[str, tuple] = {}  # path -> (mtime, size) gate

    def offset_state(self) -> dict:
        return {"offsets": dict(self._offsets)}

    def seek(self, state: dict) -> None:
        self._offsets = dict(state.get("offsets", {}))

    def _key_for(self, vals):
        if self.pk_cols:
            return int(
                ref_scalar(
                    *[vals[self.column_names.index(c)] for c in self.pk_cols]
                )
            )
        return int(ref_scalar(*vals))

    def _scan(self):
        if not os.path.isdir(self.path):
            return
        for fname in sorted(os.listdir(self.path)):
            fpath = os.path.join(self.path, fname)
            try:
                st = os.stat(fpath)
            except OSError:
                continue
            if not os.path.isfile(fpath):
                continue
            sig = (st.st_mtime, st.st_size)
            if self._sigs.get(fpath) == sig:
                continue  # unchanged since last poll — skip the re-read
            self._sigs[fpath] = sig
            start = self._offsets.get(fpath, 0)
            try:
                with open(fpath) as f:
                    lines = f.readlines()
            except OSError:
                continue
            if len(lines) <= start:
                continue
            rows = []
            for line in lines[start:]:
                line = line.strip()
                if not line:
                    continue
                for diff, vals in parse_debezium_message(
                    line, self.column_names, self.schema, self.db_type
                ):
                    rows.append((self._key_for(vals), diff, vals))
            self._offsets[fpath] = len(lines)
            if rows:
                self.session.insert_batch(rows, self.offset_state())

    def _loop(self):
        while not self._stop.is_set():
            self._scan()
            self._stop.wait(self.refresh_s)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


class _KafkaMessageSource(StreamingSource):  # pragma: no cover - needs broker
    def __init__(self, settings, topic, column_names, schema, pk_cols, db_type):
        super().__init__(column_names)
        from pathway_tpu_torch.io._utils import require

        self._ck = require("confluent_kafka", "debezium")
        self.settings = settings
        self.topic = topic
        self.schema = schema
        self.pk_cols = pk_cols
        self.db_type = db_type
        self._stop = threading.Event()
        self._thread = None

    def _loop(self):
        consumer = self._ck.Consumer(self.settings)
        consumer.subscribe([self.topic])
        while not self._stop.is_set():
            msg = consumer.poll(0.2)
            if msg is None or msg.error():
                continue
            rows = []
            for diff, vals in parse_debezium_message(
                msg.value(), self.column_names, self.schema, self.db_type
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
                    key = int(ref_scalar(*vals))
                rows.append((key, diff, vals))
            if rows:
                self.session.insert_batch(rows)
        consumer.close()

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()


def read(
    rdkafka_settings: dict | None = None,
    topic_name: str | None = None,
    *,
    schema: Any,
    db_type: str = "postgres",
    input_dir: str | None = None,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    column_names = list(schema.column_names())
    pk_cols = schema.primary_key_columns()
    if input_dir is not None:
        source: Any = _DirMessageSource(
            input_dir, column_names, schema, pk_cols, db_type
        )
    else:
        source = _KafkaMessageSource(
            rdkafka_settings, topic_name, column_names, schema, pk_cols, db_type
        )
    source.persistent_id = persistent_id or name
    node = InputNode(source, column_names)
    return Table._from_node(node, dict(schema.dtypes()), Universe())
