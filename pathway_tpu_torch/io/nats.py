"""Own copy of ``pathway_tpu/io/nats.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.nats — NATS source/sink (upstream Pathway: NatsReader/NatsWriter,
src/connectors/data_storage.rs:1775,1845). Requires `nats-py` at call
time."""

from __future__ import annotations

import json as _json
import threading
from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import InputNode
from pathway_tpu_torch.engine.runtime import StreamingSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._utils import add_writer, jsonable, require
from pathway_tpu_torch.io.kafka import _parse_message


class _NatsSource(StreamingSource):
    def __init__(self, uri, topic, format, column_names, schema):
        super().__init__(column_names)
        require("nats", "nats")
        self.uri = uri
        self.topic = topic
        self.format = format
        self.schema = schema
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _loop(self):
        import asyncio
        import itertools

        import nats

        counter = itertools.count()

        async def run():
            nc = await nats.connect(self.uri)
            sub = await nc.subscribe(self.topic)
            while not self._stop.is_set():
                try:
                    msg = await sub.next_msg(timeout=0.2)
                except Exception:
                    continue
                rows = [
                    (key, 1, vals)
                    for key, vals in _parse_message(
                        msg.data, self.format, self.column_names, self.schema,
                        counter,
                    )
                ]
                self.session.insert_batch(rows)
            await nc.close()

        asyncio.run(run())

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()


def read(
    uri: str,
    topic: str,
    *,
    schema: Any = None,
    format: str = "raw",
    name: str | None = None,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    if format in ("raw", "plaintext"):
        column_names = ["data"]
        dtypes = {"data": dt.BYTES if format == "raw" else dt.STR}
    else:
        assert schema is not None
        column_names = list(schema.column_names())
        dtypes = dict(schema.dtypes())
    source = _NatsSource(uri, topic, format, column_names, schema)
    source.persistent_id = persistent_id or name
    node = InputNode(source, column_names)
    return Table._from_node(node, dtypes, Universe())


def write(
    table: Table, uri: str, topic: str, *, format: str = "json", **kwargs: Any
) -> None:
    require("nats", "nats")
    import asyncio

    import nats

    column_names = table.column_names()
    state: dict[str, Any] = {"loop": None, "nc": None}

    def _ensure():
        if state["loop"] is None:
            loop = asyncio.new_event_loop()
            t = threading.Thread(target=loop.run_forever, daemon=True)
            t.start()
            state["loop"] = loop
            fut = asyncio.run_coroutine_threadsafe(nats.connect(uri), loop)
            state["nc"] = fut.result(timeout=10)
        return state["loop"], state["nc"]

    def on_batch(t: int, batch: DiffBatch) -> None:
        loop, nc = _ensure()
        for k, d, vals in batch.iter_rows():
            payload = {n: jsonable(v) for n, v in zip(column_names, vals)}
            payload["time"] = t
            payload["diff"] = d
            asyncio.run_coroutine_threadsafe(
                nc.publish(topic, _json.dumps(payload).encode()), loop
            ).result(timeout=10)

    add_writer(table, on_batch)
