"""Own copy of ``pathway_tpu/io/kafka.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.kafka — Kafka source/sink.

Counterpart of upstream Pathway's KafkaReader/KafkaWriter
(upstream Pathway: src/connectors/data_storage.rs:697,1368 over rdkafka; Python
façade python/pathway/io/kafka, 676 LoC). Uses `confluent_kafka` when
present (imported inside the call — the connector raises a clear error
without it, and the parsing/formatting layer is shared with the fs
connector so message semantics match: raw / json / dsv formats, optional
key from primary-key columns).
"""

from __future__ import annotations

import json as _json
import threading
from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import StreamingSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ref_scalar, sequential_key
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._utils import add_writer, jsonable, require


def _parse_message(raw: bytes, format: str, column_names, schema, counter):
    if format in ("raw", "plaintext"):
        data = raw if format == "raw" else raw.decode("utf-8", errors="replace")
        return [(int(sequential_key(next(counter))), (data,))]
    if format == "json":
        obj = _json.loads(raw)
        dtypes = schema.dtypes() if schema else {}
        vals = []
        for c in column_names:
            v = obj.get(c)
            d = dtypes.get(c, dt.ANY).strip_optional()
            if d == dt.JSON and not isinstance(v, Json):
                v = Json(v)
            elif d == dt.FLOAT and isinstance(v, int):
                v = float(v)
            vals.append(v)
        vals = tuple(vals)
        pk = schema.primary_key_columns() if schema else None
        if pk:
            key = int(ref_scalar(*[vals[column_names.index(c)] for c in pk]))
        else:
            key = int(sequential_key(next(counter)))
        return [(key, vals)]
    raise ValueError(f"unsupported kafka format {format!r}")


class _KafkaSource(StreamingSource):
    def __init__(self, settings, topic, format, column_names, schema):
        super().__init__(column_names)
        self._ck = require(
            "confluent_kafka",
            "kafka",
            hint="Use pw.io.fs / pw.io.python connectors locally.",
        )
        self.settings = settings
        self.topic = topic
        self.format = format
        self.schema = schema
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._offsets: dict[int, int] = {}  # partition -> next offset

    def offset_state(self) -> dict:
        return {"offsets": dict(self._offsets)}

    def seek(self, state: dict) -> None:
        self._offsets = dict(state.get("offsets", {}))

    def _loop(self):
        import itertools

        counter = itertools.count()
        consumer = self._ck.Consumer(self.settings)

        def on_assign(cons, partitions):
            # seek must wait for assignment (rdkafka raises otherwise)
            if self._offsets:
                for p in partitions:
                    if p.partition in self._offsets:
                        p.offset = self._offsets[p.partition]
                cons.assign(partitions)

        consumer.subscribe([self.topic], on_assign=on_assign)
        while not self._stop.is_set():
            msg = consumer.poll(0.2)
            if msg is None or msg.error():
                continue
            rows = [
                (key, 1, vals)
                for key, vals in _parse_message(
                    msg.value(), self.format, self.column_names, self.schema,
                    counter,
                )
            ]
            self._offsets[msg.partition()] = msg.offset() + 1
            self.session.insert_batch(rows, self.offset_state())
        consumer.close()

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()


def read(
    rdkafka_settings: dict,
    topic: str | None = None,
    *,
    schema: Any = None,
    format: str = "raw",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    persistent_id: str | None = None,
    topic_names: list[str] | None = None,
    **kwargs: Any,
) -> Table:
    if topic is None and topic_names:
        topic = topic_names[0]
    if format in ("raw", "plaintext"):
        column_names = ["data"]
        dtypes = {"data": dt.BYTES if format == "raw" else dt.STR}
    else:
        assert schema is not None, "schema required for json format"
        column_names = list(schema.column_names())
        dtypes = dict(schema.dtypes())
    source = _KafkaSource(rdkafka_settings, topic, format, column_names, schema)
    source.persistent_id = persistent_id or name
    node = InputNode(source, column_names)
    return Table._from_node(node, dtypes, Universe())


def write(
    table: Table,
    rdkafka_settings: dict,
    topic_name: str,
    *,
    format: str = "json",
    **kwargs: Any,
) -> None:
    ck = require("confluent_kafka", "kafka")
    producer = ck.Producer(rdkafka_settings)
    column_names = table.column_names()

    def on_batch(t: int, batch: DiffBatch) -> None:
        for k, d, vals in batch.iter_rows():
            payload = {
                n: jsonable(v) for n, v in zip(column_names, vals)
            }
            payload["time"] = t
            payload["diff"] = d
            producer.produce(
                topic_name,
                key=f"{k:016x}".encode(),
                value=_json.dumps(payload).encode(),
            )
        producer.flush()

    add_writer(table, on_batch)
