"""Own copy of ``pathway_tpu/io/mongodb.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.mongodb — MongoDB sink (upstream Pathway: MongoWriter,
src/connectors/data_storage.rs:1732 + BsonFormatter data_format.rs:2068).
Requires `pymongo` at call time."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.io._utils import add_writer, require, row_dicts


def write(
    table,
    connection_string: str,
    database: str,
    collection: str,
    *,
    max_batch_size: int | None = None,
    **kwargs: Any,
) -> None:
    pymongo = require("pymongo", "mongodb")
    client = pymongo.MongoClient(connection_string)
    coll = client[database][collection]
    column_names = table.column_names()

    def on_batch(t: int, batch: DiffBatch) -> None:
        # append-only event stream: every change (including retractions) is
        # its own document with time/diff and a server-generated _id
        # (upstream Pathway: BsonFormatter emits the diff stream the same way)
        ops = []
        for k, d, doc in row_dicts(batch, column_names, t):
            doc["key"] = f"{k:016x}"
            doc["time"] = t
            doc["diff"] = d
            ops.append(pymongo.InsertOne(doc))
            if max_batch_size and len(ops) >= max_batch_size:
                coll.bulk_write(ops)
                ops = []
        if ops:
            coll.bulk_write(ops)

    add_writer(table, on_batch, client.close)
